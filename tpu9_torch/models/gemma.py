"""Gemma family configs (counterpart of ``tpu9/models/gemma.py``). Gemma
differs from Llama by the ``DecoderConfig`` switches: GELU MLP, (1+w)
RMSNorm, sqrt(dim) embedding scale, tied embeddings, head_dim 256."""

from __future__ import annotations

from .transformer import DecoderConfig


def gemma_config(**kw) -> DecoderConfig:
    base = dict(act="gelu", norm_offset=1.0, embed_scale=True,
                tie_embeddings=True, rope_theta=10000.0, norm_eps=1e-6)
    base.update(kw)
    return DecoderConfig(**base)


GEMMA_PRESETS: dict[str, DecoderConfig] = {
    "gemma-tiny": gemma_config(vocab_size=512, dim=128, n_layers=2, n_heads=4,
                               n_kv_heads=4, head_dim=32, hidden_dim=512,
                               max_seq_len=512),
    "gemma-2b": gemma_config(vocab_size=256128, dim=2048, n_layers=18,
                             n_heads=8, n_kv_heads=1, head_dim=256,
                             hidden_dim=16384, max_seq_len=8192),
    "gemma-7b": gemma_config(vocab_size=256128, dim=3072, n_layers=28,
                             n_heads=16, n_kv_heads=16, head_dim=256,
                             hidden_dim=24576, max_seq_len=8192),
}
