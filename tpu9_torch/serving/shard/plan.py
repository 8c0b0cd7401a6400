"""Topology planner (counterpart of ``tpu9/serving/shard/plan.py``): pick
a tp or tp×fsdp submesh shape per preset.

Planning is host arithmetic over ``feasibility.py``'s HBM pricing (the
exact bytes of the preset's abstract param tree, the KV pool, the prefill
scratch and headroom per card), so a deployment either provably fits its
submesh or is refused with numbers, never an out-of-memory error at bind
time. The slice it plans against is a :class:`~tpu9_torch.types.GpuSpec`
(or any object with ``name``, ``chips`` and ``hbm_gb_per_chip``).

Rules, as the reference's:

- candidate card counts are powers of two up to the slice size;
- ``tp`` takes as many cards as divide ``n_kv_heads`` exactly: the paged
  KV pool shards on the head axis, and a non-dividing tp would replicate
  KV; the other cards go to ``fsdp``, which shards weights only;
- the smallest card count that fits wins: serving pays per card, and a
  model that fits N cards spread over 2N halves tokens per second per
  card.

Explicit overrides (``load_engine(topology=...)``, ``TPU9_TOPOLOGY``)
bypass the planner; ``parse_topology`` is the shared syntax.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Any, Optional


@dataclass(frozen=True)
class Topology:
    """A serving submesh shape: ``tp`` cards tensor-parallel (innermost;
    shards weights and the paged-KV head axis) × ``fsdp`` cards
    weight-sharded on top. ``1x1`` is the single-card engine."""

    tp: int = 1
    fsdp: int = 1

    def __post_init__(self) -> None:
        if self.tp < 1 or self.fsdp < 1:
            raise ValueError(f"topology axes must be >= 1, got {self}")

    @property
    def n_chips(self) -> int:
        return self.tp * self.fsdp

    @property
    def is_single(self) -> bool:
        return self.n_chips == 1

    def as_dict(self) -> dict:
        return {"tp": self.tp, "fsdp": self.fsdp, "n_chips": self.n_chips}

    def __str__(self) -> str:
        return f"{self.tp}x{self.fsdp}"


def parse_topology(value: "str | Topology | None") -> Optional[Topology]:
    """Parse a topology override: ``"2"`` (tp only), ``"2x4"`` (tp×fsdp)
    or ``"tp=2,fsdp=4"``. ``None`` or ``""`` is None (the caller picks the
    default); a :class:`Topology` passes through."""
    if value is None:
        return None
    if isinstance(value, Topology):
        return value
    s = str(value).strip().lower()
    if not s:
        return None
    if "=" in s:
        axes = {"tp": 1, "fsdp": 1}
        for part in s.split(","):
            k, _, v = part.partition("=")
            k = k.strip()
            if k not in axes:
                raise ValueError(f"unknown topology axis {k!r} in {value!r}"
                                 " (tp/fsdp)")
            axes[k] = int(v)
        return Topology(**axes)
    if "x" in s:
        tp_s, _, fsdp_s = s.partition("x")
        return Topology(tp=int(tp_s), fsdp=int(fsdp_s))
    return Topology(tp=int(s))


def topology_from_env(env: str = "TPU9_TOPOLOGY") -> Optional[Topology]:
    """The runner-facing override: ``TPU9_TOPOLOGY=2x1`` and so on.
    ``auto`` is not resolved here: it needs a slice spec, which only the
    deploy-time caller has."""
    raw = os.environ.get(env, "")
    if not raw or raw.strip().lower() == "auto":
        return None
    return parse_topology(raw)


@dataclass(frozen=True)
class TopologyPlan:
    """A planner decision and the HBM arithmetic behind it: ``budget`` is
    the winning submesh's :class:`HbmBudget`, ``rejected`` each smaller
    candidate and why it lost."""

    preset: str
    topology: Topology
    budget: Any                      # serving.feasibility.HbmBudget
    rejected: tuple = ()             # ((Topology, required_gb, have_gb), ..)

    def as_dict(self) -> dict:
        return {"preset": self.preset, **self.topology.as_dict(),
                "budget": self.budget.as_dict(),
                "rejected": [
                    {**t.as_dict(), "required_gb_per_chip": req,
                     "hbm_gb_per_chip": have}
                    for t, req, have in self.rejected]}


def candidate_topologies(n_kv_heads: int, max_chips: int) -> list[Topology]:
    """Power-of-two card counts, smallest first; per count, tp takes the
    largest factor that divides ``n_kv_heads`` (exact KV head sharding),
    fsdp the rest."""
    out: list[Topology] = []
    n = 1
    while n <= max_chips:
        tp = math.gcd(n, n_kv_heads)
        out.append(Topology(tp=tp, fsdp=n // tp))
        n *= 2
    return out


def _slice_spec(tpu):
    from ...types import parse_gpu_spec
    spec = parse_gpu_spec(tpu) if isinstance(tpu, str) else tpu
    if spec is None:
        raise ValueError("plan_topology needs a GPU slice spec")
    return spec


def plan_topology(preset: str, tpu: "str | Any", *, max_batch: int = 8,
                  max_seq_len: int = 2048, quantize: "str | None" = None,
                  kv_quant: bool = False,
                  overhead_frac: float = 0.10) -> TopologyPlan:
    """Smallest power-of-two submesh of the slice ``tpu`` (a GpuSpec or its
    name, e.g. ``"h100-8"``) that provably serves ``preset``. Raises
    :class:`InfeasibleDeployment` with the arithmetic of the largest
    candidate when even the whole slice cannot hold it."""
    from ..feasibility import InfeasibleDeployment, hbm_budget
    from ..presets import resolve_preset
    cfg, _ = resolve_preset(preset, quantize)
    spec = _slice_spec(tpu)

    rejected: list = []
    budget = None
    for topo in candidate_topologies(cfg.n_kv_heads, spec.chips):
        budget = hbm_budget(preset, spec, max_batch=max_batch,
                            max_seq_len=max_seq_len, tp=topo.tp,
                            fsdp=topo.fsdp, overhead_frac=overhead_frac,
                            quantize=quantize, kv_quant=kv_quant)
        if budget.fits:
            return TopologyPlan(preset=preset, topology=topo, budget=budget,
                                rejected=tuple(rejected))
        rejected.append((topo, round(budget.required_gb_per_chip, 3),
                         budget.hbm_per_chip_gb))
    d = budget.as_dict()
    raise InfeasibleDeployment(
        f"{preset} does not fit {spec.name} at any submesh up to "
        f"{spec.chips} chips: largest candidate tp={d['tp']} "
        f"fsdp={d['fsdp']} still needs {d['required_gb_per_chip']} GB/chip "
        f"(weights {d['weight_gb_per_chip']} + KV {d['kv_gb_per_chip']} + "
        f"scratch {d['scratch_gb_per_chip']}) against "
        f"{d['hbm_per_chip_gb']} GB. Remedies: int8 weights, int8 KV, "
        f"smaller max_batch/max_seq_len, or a larger slice.")


def resolve_topology(topology: "str | Topology | None" = None,
                     preset: str = "", tpu: "str | Any | None" = None,
                     **plan_kw) -> Topology:
    """The override chain of the serving stack: explicit argument, then
    the ``TPU9_TOPOLOGY`` variable, then the planner (when a slice is
    named), then one card. The string ``"auto"`` forces the planner and
    then needs ``tpu``: the reference's keyword, here a GPU slice."""
    want_auto = isinstance(topology, str) \
        and topology.strip().lower() == "auto"
    if not want_auto:
        explicit = parse_topology(topology)
        if explicit is not None:
            return explicit
        env = topology_from_env()
        if env is not None:
            return env
        want_auto = (os.environ.get("TPU9_TOPOLOGY", "")
                     .strip().lower() == "auto")
    if want_auto or (topology is None and tpu is not None and preset):
        if not (tpu and preset):
            raise ValueError(
                "topology='auto' needs a preset and a slice spec to plan "
                "against (set topology explicitly, e.g. '2x1')")
        return plan_topology(preset, tpu, **plan_kw).topology
    return Topology(1, 1)
