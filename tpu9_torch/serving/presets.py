"""Engine construction from model presets (counterpart of
``tpu9/serving/presets.py``): the same llama and gemma preset names (the
mixtral names wait for the MoE decoder), the same rule for when the engine
is paged and the same quantization knobs, with random weights drawn on the
device from a seed.

``<preset>-int8`` or ``quantize="int8"`` serves int8 weight-only
projections, on the paged or the dense engine; ``kv_quant="int8"`` stores
the paged pool as int8 with per-vector scales, auto-sized to the bytes a
bf16 pool would take. The two knobs are independent; together they are
quantized serving end to end.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models.gemma import GEMMA_PRESETS
from ..models.llama import LLAMA_PRESETS
from ..models.transformer import init_decoder
from ..ops.quant import init_quantized_decoder, validate_quant_mode
from ..utils.platform import default_device
from .engine import EngineConfig, InferenceEngine


PRESETS = {**LLAMA_PRESETS, **GEMMA_PRESETS}
# the reference's mixtral preset names (``tpu9/models/mixtral.py``): the
# MoE decoder they need is not ported yet
MIXTRAL_NAMES = ("mixtral-tiny", "mixtral-8x7b")


def resolve_preset(name: str, quantize: Optional[str] = None):
    """Return ``(DecoderConfig, quantized)`` for a llama or gemma preset
    name: a ``-int8`` suffix or ``quantize="int8"`` selects int8 weights.
    A mixtral name raises ``NotImplementedError``, any other ``KeyError``."""
    quantize = validate_quant_mode(quantize)
    quantized = name.endswith("-int8") or quantize == "int8"
    base = name[:-len("-int8")] if name.endswith("-int8") else name
    if base in MIXTRAL_NAMES:
        raise NotImplementedError(
            f"model preset {base!r} needs the MoE decoder: ROADMAP queue A10")
    if base not in PRESETS:
        raise KeyError(f"unknown model preset {base!r}; have "
                       f"{sorted(PRESETS)}")
    return PRESETS[base], quantized


def build_params(name: str, seed: int = 0, device=None,
                 quantize: Optional[str] = None):
    """Random params for a preset, drawn on ``device`` from a generator
    seeded with ``seed``; int8 presets are drawn at int8, so no bf16 copy
    of the model ever exists. Returns ``(params, cfg)``."""
    cfg, quantized = resolve_preset(name, quantize)
    device = default_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    init = init_quantized_decoder if quantized else init_decoder
    return init(cfg, gen, device), cfg


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
    Otherwise (or with ``paged=False``) the engine keeps a dense [B, S]
    cache and prefills whole bucketed prompts.
    ``prefix_cache_blocks=0`` disables the prefix cache (None = one
    sequence's worth of blocks when paged, 0 when dense). ``quantize`` and
    ``kv_quant`` are the int8 knobs of the module docstring; int8 weights
    serve on either engine, the int8 pool only on the paged one."""
    resolve_preset(name, quantize)           # a bad name or mode fails first
    kv_quant = validate_quant_mode(kv_quant, "kv_quant")
    if engine_cfg is not None and kv_quant \
            and engine_cfg.kv_quant != kv_quant:
        # an explicit engine_cfg replaces every knob: a kv_quant it does
        # not carry would be dropped silently
        raise ValueError(
            "kv_quant conflicts with the explicit engine_cfg — set "
            "EngineConfig(kv_quant=...) there instead")
    device = default_device(device)
    chunk = min(prefill_buckets)
    block = min(kv_block_size, chunk)
    if paged is None:
        paged = (max_seq_len % block == 0 and chunk % block == 0
                 and max_seq_len % chunk == 0)
    if kv_quant and not paged:
        raise ValueError(
            "kv_quant='int8' needs the paged engine, but the alignment "
            f"invariants rejected paging (block {block}, chunk {chunk}, "
            f"max_seq_len {max_seq_len})")
    ecfg = engine_cfg or EngineConfig(
        max_batch=max_batch, max_seq_len=max_seq_len,
        prefill_buckets=prefill_buckets, decode_steps=decode_steps,
        kv_block_size=block if paged else 0, kv_pool_blocks=kv_pool_blocks,
        prefill_chunk=chunk if paged else 0,
        # an explicit 0 disables the prefix cache; None is the default
        prefix_cache_blocks=prefix_cache_blocks
        if prefix_cache_blocks is not None
        else (max_seq_len // block if paged else 0),
        kv_quant=kv_quant)
    params, cfg = build_params(name, seed=seed, device=device,
                               quantize=quantize)
    return InferenceEngine(params, cfg, ecfg, device=device)
