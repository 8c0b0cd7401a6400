"""Engine construction from model presets (counterpart of
``tpu9/serving/presets.py``): the same preset names and the same rule for
when the engine is paged, with random weights drawn on the device from a
seed.

This slice serves bf16 weights and a bf16 KV pool: int8 weights (the
``-int8`` suffix, ``quantize=``) and the int8 pool (``kv_quant=``) raise
``NotImplementedError`` until their ROADMAP items land.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models.llama import LLAMA_PRESETS
from ..models.transformer import init_decoder
from ..utils.platform import default_device
from .engine import EngineConfig, InferenceEngine


def resolve_preset(name: str, quantize: Optional[str] = None):
    """The ``DecoderConfig`` of a preset name."""
    if name.endswith("-int8") or quantize:
        raise NotImplementedError(
            "int8 weight-only serving: ROADMAP queue A7")
    if name not in LLAMA_PRESETS:
        raise KeyError(f"unknown model preset {name!r}; have "
                       f"{sorted(LLAMA_PRESETS)}")
    return LLAMA_PRESETS[name]


def build_params(name: str, seed: int = 0, device=None,
                 quantize: Optional[str] = None):
    """Random params for a preset, drawn on ``device`` from a generator
    seeded with ``seed``. Returns ``(params, cfg)``."""
    cfg = resolve_preset(name, quantize)
    device = default_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return init_decoder(cfg, gen, device), cfg


def load_engine(name: str, *, device=None, max_batch: int = 8,
                max_seq_len: int = 2048,
                prefill_buckets: tuple = (128, 512, 2048),
                decode_steps: tuple = (1, 8, 32),
                paged: Optional[bool] = None,
                kv_block_size: int = 256,
                kv_pool_blocks: int = 0,
                prefix_cache_blocks: Optional[int] = None,
                quantize: Optional[str] = None,
                kv_quant: Optional[str] = None,
                engine_cfg: Optional[EngineConfig] = None,
                seed: int = 0) -> InferenceEngine:
    """Build the serving engine for a preset on ``device`` (the current
    CUDA device when None; without one this raises).

    ``paged=None`` pages the KV cache whenever block | chunk | max_seq_len
    holds, as the JAX ``load_engine`` does: the chunk is the smallest
    prefill bucket and the block is ``min(kv_block_size, chunk)``.
    ``prefix_cache_blocks=0`` disables the prefix cache (None = one
    sequence's worth of blocks)."""
    if kv_quant:
        raise NotImplementedError("int8 KV pool: ROADMAP queue A7 and "
                                  "kernel B2")
    device = default_device(device)
    chunk = min(prefill_buckets)
    block = min(kv_block_size, chunk)
    if paged is None:
        paged = (max_seq_len % block == 0 and chunk % block == 0
                 and max_seq_len % chunk == 0)
    if not paged:
        raise NotImplementedError(
            "dense-cache engine (paged=False or unaligned block/chunk): "
            "ROADMAP queue A11")
    ecfg = engine_cfg or EngineConfig(
        max_batch=max_batch, max_seq_len=max_seq_len,
        prefill_buckets=prefill_buckets, decode_steps=decode_steps,
        kv_block_size=block, kv_pool_blocks=kv_pool_blocks,
        prefill_chunk=chunk,
        prefix_cache_blocks=prefix_cache_blocks
        if prefix_cache_blocks is not None else max_seq_len // block)
    params, cfg = build_params(name, seed=seed, device=device,
                               quantize=quantize)
    return InferenceEngine(params, cfg, ecfg, device=device)
