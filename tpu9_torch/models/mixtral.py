"""Mixtral-family configs (counterpart of ``tpu9/models/mixtral.py``):
llama-shaped attention and an 8-expert top-2 sparse FFN, the architecture
constants of the public Mixtral-8x7B card."""

from __future__ import annotations

from .transformer import DecoderConfig


def mixtral_config(**kw) -> DecoderConfig:
    base = dict(act="silu", norm_offset=0.0, rope_theta=1e6,
                norm_eps=1e-5, tie_embeddings=False,
                n_experts=8, moe_top_k=2)
    base.update(kw)
    return DecoderConfig(**base)


MIXTRAL_PRESETS: dict[str, DecoderConfig] = {
    # test-scale: 4 experts, for the unit tests and the CPU dry-runs
    "mixtral-tiny": mixtral_config(vocab_size=512, dim=128, n_layers=2,
                                   n_heads=4, n_kv_heads=2, head_dim=32,
                                   hidden_dim=256, max_seq_len=512,
                                   n_experts=4),
    # Mixtral-8x7B: 47B parameters in all, about 13B active a token
    "mixtral-8x7b": mixtral_config(vocab_size=32000, dim=4096, n_layers=32,
                                   n_heads=32, n_kv_heads=8, head_dim=128,
                                   hidden_dim=14336, max_seq_len=32768),
}
