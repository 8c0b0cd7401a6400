"""Llama-3 family configs (counterpart of ``tpu9/models/llama.py``):
architecture constants from the public Llama 3 model cards."""

from __future__ import annotations

from .transformer import DecoderConfig


def llama_config(**kw) -> DecoderConfig:
    base = dict(act="silu", norm_offset=0.0, rope_theta=500000.0,
                norm_eps=1e-5, tie_embeddings=False)
    base.update(kw)
    return DecoderConfig(**base)


LLAMA_PRESETS: dict[str, DecoderConfig] = {
    # test-scale model used by unit tests and the CPU dry-runs
    "llama-tiny": llama_config(vocab_size=512, dim=128, n_layers=2, n_heads=4,
                               n_kv_heads=2, head_dim=32, hidden_dim=256,
                               max_seq_len=512),
    "llama-1b": llama_config(vocab_size=128256, dim=2048, n_layers=16,
                             n_heads=32, n_kv_heads=8, head_dim=64,
                             hidden_dim=8192, max_seq_len=8192),
    "llama3-8b": llama_config(vocab_size=128256, dim=4096, n_layers=32,
                              n_heads=32, n_kv_heads=8, head_dim=128,
                              hidden_dim=14336, max_seq_len=8192),
    "llama3-70b": llama_config(vocab_size=128256, dim=8192, n_layers=80,
                               n_heads=64, n_kv_heads=8, head_dim=128,
                               hidden_dim=28672, max_seq_len=8192),
}
