"""HBM feasibility arithmetic for LLM deployments (counterpart of
``tpu9/serving/feasibility.py``).

Before a deployment takes real cards, its weights, KV cache and runtime
overhead must provably fit each card's device memory: the deployment is
accepted or refused with arithmetic, not with an out-of-memory error in a
running container. The slice is a :class:`~tpu9_torch.types.GpuSpec` (or
any object with ``name``, ``chips`` and ``hbm_gb_per_chip``).

Accounting per card, tensor-parallel over ``tp`` cards and weight-sharded
over ``fsdp`` more:

- weights: the exact bytes of the preset's abstract (``device="meta"``)
  param tree at its stored dtypes, divided by tp × fsdp;
- KV cache: ``2 (k, v) × layers × max_batch × max_seq × kv_heads ×
  head_dim × 2 B``, divided by the even head shard ``gcd(tp, kv_heads)``;
- overhead: a fragmentation and workspace reserve (10 % by default) and
  the paged engine's batch-1 prefill scratch.
"""

from __future__ import annotations

import math
from dataclasses import dataclass


class InfeasibleDeployment(ValueError):
    """Raised at deploy time when the model and its KV cannot fit the
    slice."""


@dataclass(frozen=True)
class HbmBudget:
    gpu: str
    chips: int
    tp: int
    # weight-only sharding on top of tp: weights divide by tp×fsdp, KV
    # and scratch by the tp head shard only
    fsdp: int
    hbm_per_chip_gb: float
    weight_gb_per_chip: float
    kv_gb_per_chip: float
    scratch_gb_per_chip: float
    overhead_frac: float
    # sequences the same kv_gb holds relative to bf16 (an int8 pool:
    # ~1.94x at head_dim 128); the budget's KV bytes do not shrink under
    # kv_quant (equal-bytes auto sizing)
    kv_capacity_factor: float = 1.0

    @property
    def required_gb_per_chip(self) -> float:
        raw = (self.weight_gb_per_chip + self.kv_gb_per_chip
               + self.scratch_gb_per_chip)
        return raw * (1.0 + self.overhead_frac)

    @property
    def fits(self) -> bool:
        return self.required_gb_per_chip <= self.hbm_per_chip_gb

    def as_dict(self) -> dict:
        return {
            "gpu": self.gpu, "chips": self.chips, "tp": self.tp,
            "fsdp": self.fsdp,
            "hbm_per_chip_gb": round(self.hbm_per_chip_gb, 2),
            "weight_gb_per_chip": round(self.weight_gb_per_chip, 3),
            "kv_gb_per_chip": round(self.kv_gb_per_chip, 3),
            "scratch_gb_per_chip": round(self.scratch_gb_per_chip, 3),
            "overhead_frac": self.overhead_frac,
            "kv_capacity_factor": round(self.kv_capacity_factor, 3),
            "required_gb_per_chip": round(self.required_gb_per_chip, 3),
            "fits": self.fits,
        }


def weight_bytes(cfg, quantized: bool) -> int:
    """Exact bytes of the served param tree, priced on its abstract shapes:
    the init functions ``build_params`` draws with, run on the meta
    device (``presets.abstract_params_for``), summed by
    ``ops.quant.quantized_bytes``."""
    from ..ops.quant import quantized_bytes
    from .presets import abstract_params_for
    return quantized_bytes(abstract_params_for(cfg, quantized))


def kv_cache_bytes(cfg, max_batch: int, max_seq: int,
                   kv_quant: bool = False) -> int:
    """Dense-equivalent KV bytes: ``max_batch`` sequences of ``max_seq``
    tokens, priced by the helper the engine's pool sizing divides by
    (``paged_kv.kv_block_bytes``)."""
    from .paged_kv import kv_block_bytes
    return max_batch * kv_block_bytes(cfg, max_seq, kv_quant)


def _slice_spec(gpu):
    from ..types import parse_gpu_spec
    spec = parse_gpu_spec(gpu) if isinstance(gpu, str) else gpu
    if spec is None:
        raise ValueError("feasibility needs a GPU slice spec")
    return spec


def hbm_budget(preset: str, gpu, *, max_batch: int = 8,
               max_seq_len: int = 2048, tp: int = 0, fsdp: int = 1,
               overhead_frac: float = 0.10,
               quantize: "str | None" = None,
               kv_quant: bool = False) -> HbmBudget:
    """The per-card HBM budget of serving ``preset`` on the slice ``gpu``
    with tensor parallelism ``tp`` (0: every card of the slice) and
    weight-only ``fsdp`` sharding on top: weights divide by tp×fsdp, KV by
    the tp head shard only. ``quantize="int8"`` prices a plain preset name
    as int8 weights, as ``load_engine(quantize=)`` serves it."""
    from .presets import resolve_preset
    cfg, quantized = resolve_preset(preset, quantize)
    spec = _slice_spec(gpu)
    tp = tp or spec.chips

    w = weight_bytes(cfg, quantized) / (tp * max(fsdp, 1))
    # KV is head-sharded; the even shard is gcd(tp, kv_heads)
    kv_shard = math.gcd(tp, cfg.n_kv_heads)
    # kv_quant does not shrink the budget: the engine's auto pool sizing
    # spends the bytes of the bf16 pool on about twice the blocks
    kv = kv_cache_bytes(cfg, max_batch, max_seq_len) / kv_shard
    # the paged engine's batch-1 prefill scratch, in the model dtype, on
    # each card's head shard
    scratch = kv_cache_bytes(cfg, 1, max_seq_len) / kv_shard

    return HbmBudget(
        gpu=spec.name, chips=spec.chips, tp=tp, fsdp=max(fsdp, 1),
        hbm_per_chip_gb=float(spec.hbm_gb_per_chip),
        weight_gb_per_chip=w / 1e9,
        kv_gb_per_chip=kv / 1e9,
        scratch_gb_per_chip=scratch / 1e9,
        overhead_frac=overhead_frac,
        kv_capacity_factor=(
            kv_cache_bytes(cfg, max_batch, max_seq_len)
            / kv_cache_bytes(cfg, max_batch, max_seq_len, kv_quant=True)
            if kv_quant else 1.0))


def validate_llm_deployment(preset: str, gpu, *, max_batch: int = 8,
                            max_seq_len: int = 2048, tp: int = 0,
                            quantize: "str | None" = None,
                            kv_quant: bool = False) -> HbmBudget:
    """Deploy-time gate: raises :class:`InfeasibleDeployment` with the
    arithmetic when the configuration cannot fit, else returns the
    budget."""
    budget = hbm_budget(preset, gpu, max_batch=max_batch,
                        max_seq_len=max_seq_len, tp=tp,
                        quantize=quantize, kv_quant=kv_quant)
    if not budget.fits:
        d = budget.as_dict()
        raise InfeasibleDeployment(
            f"{preset} on {d['gpu']} (tp={d['tp']}) needs "
            f"{d['required_gb_per_chip']} GB/chip "
            f"(weights {d['weight_gb_per_chip']} + KV {d['kv_gb_per_chip']}"
            f" + scratch {d['scratch_gb_per_chip']} + "
            f"{int(budget.overhead_frac * 100)}% overhead) but the chip "
            f"has {d['hbm_per_chip_gb']} GB. Remedies: int8 weights "
            f"(-50% weight bytes), smaller max_batch/max_seq_len (KV "
            f"scales linearly), or a larger slice.")
    return budget
