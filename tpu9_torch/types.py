"""Accelerator slice specs of the port (counterpart of ``TpuSpec`` and
``parse_tpu_spec`` in ``tpu9/types.py``).

A deployment that names a slice (``load_engine(tpu="h100-8")``) is planned
against it: the topology planner (``serving/shard/plan.py``) prices the
preset on each power-of-two submesh of the slice with the HBM arithmetic
of ``serving/feasibility.py``. A slice here is 1, 2, 4 or 8 H100 SXM cards
of one host (80 GB of device memory each, NVLink all to all), the
counterpart of one TPU host's chips.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class GpuSpec:
    """A schedulable GPU slice shape: ``chips`` cards over ``hosts`` hosts,
    ``hbm_gb_per_chip`` of device memory each. The field names are
    ``TpuSpec``'s, so the planner prices either."""

    name: str                 # canonical request string, e.g. "h100-8"
    generation: str           # h100
    chips: int                # cards in the slice
    hosts: int                # hosts in the gang (1 == one host)
    hbm_gb_per_chip: int
    bf16_tflops_per_chip: float

    @property
    def chips_per_host(self) -> int:
        return self.chips // self.hosts


def _h100(chips: int) -> GpuSpec:
    # H100 SXM: 80 GB HBM3, 989 TFLOP/s dense bf16 at 700 W
    return GpuSpec(f"h100-{chips}", "h100", chips, 1, hbm_gb_per_chip=80,
                   bf16_tflops_per_chip=989.0)


GPU_REGISTRY: dict[str, GpuSpec] = {
    s.name: s for s in (_h100(1), _h100(2), _h100(4), _h100(8))}


class InvalidGpuSpec(ValueError):
    pass


def parse_gpu_spec(spec: Optional[str]) -> Optional[GpuSpec]:
    """Parse a user-facing slice string (``"h100-8"``) into a GpuSpec;
    empty or None is no slice (None)."""
    if not spec:
        return None
    key = spec.strip().lower()
    try:
        return GPU_REGISTRY[key]
    except KeyError:
        raise InvalidGpuSpec(
            f"unknown gpu spec {spec!r}; known: {', '.join(sorted(GPU_REGISTRY))}"
        ) from None
