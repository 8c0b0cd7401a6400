"""Device meshes of the port (counterpart of ``tpu9/parallel/mesh.py``).

Axis convention (order matters: outer axes map to slower links):

- ``dp``   data parallel
- ``fsdp`` fully-sharded data parallel (params and grads sharded)
- ``sp``   sequence parallel (ring attention)
- ``tp``   tensor parallel (innermost)

One process drives the whole grid (single-controller): a :class:`Mesh` is
a grid of ``torch.device`` s with axis names, repeats allowed, so several
ranks may share one card. Nothing here starts a process group; the
collectives of the layers above are copies between the grid's devices
(``parallel/sharding.py``). ``mesh_for_spec`` lays tp within a host's
cards, as the reference lays it within a host's chips.
"""

from __future__ import annotations

import threading
from typing import Optional, Sequence

import numpy as np
import torch

from ..types import GpuSpec

MeshAxes = ("dp", "fsdp", "sp", "tp")

_ACTIVE = threading.local()


class Mesh:
    """A named grid of devices: ``devices`` an object array of
    ``torch.device`` shaped by the axes' sizes, ``shape`` the sizes by
    name. ``with mesh:`` makes it the current mesh of the thread
    (:func:`current_mesh`), as a ``jax.sharding.Mesh`` context does."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d grid for axes {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def sub_devices(self, axes: Sequence[str]) -> list:
        """The devices of the subgrid spanned by ``axes`` in that order
        (row-major: the last axis fastest), every other axis at
        coordinate 0. An axis the mesh lacks has size 1."""
        index = tuple(slice(None) if name in axes else 0
                      for name in self.axis_names)
        sub = self.devices[index]
        kept = [name for name in self.axis_names if name in axes]
        order = [kept.index(a) for a in axes if a in kept]
        return list(np.transpose(sub, order).reshape(-1)) if order else [sub]

    def __enter__(self) -> "Mesh":
        stack = getattr(_ACTIVE, "stack", None)
        if stack is None:
            stack = _ACTIVE.stack = []
        stack.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _ACTIVE.stack.pop()

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


def current_mesh() -> Optional[Mesh]:
    """The innermost mesh entered with ``with mesh:`` on this thread."""
    stack = getattr(_ACTIVE, "stack", None)
    return stack[-1] if stack else None


def _devices(devices: Optional[Sequence]) -> list:
    """``devices`` as ``torch.device`` s; None means every CUDA device,
    and raises when there is none (nothing falls back to the CPU)."""
    if devices is not None:
        return [torch.device(d) for d in devices]
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass devices=['cpu'] * n to "
                           "build a mesh on the CPU (the port does not fall "
                           "back by itself)")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_named_mesh(axes: dict, devices: Optional[Sequence] = None) -> Mesh:
    """A mesh with arbitrary named axes, e.g. ``{"ep": 8}`` or ``{"pp": 4,
    "dp": 2}``: the dict's order is the grid's (outer first)."""
    devs = _devices(devices)
    need = 1
    for n in axes.values():
        need *= n
    if need > len(devs):
        raise ValueError(f"mesh needs {need} devices, have {len(devs)}")
    grid = np.empty(need, dtype=object)
    grid[:] = devs[:need]
    return Mesh(grid.reshape(*axes.values()), tuple(axes))


def make_mesh(dp: int = 1, fsdp: int = 1, sp: int = 1, tp: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    return make_named_mesh(dict(zip(MeshAxes, (dp, fsdp, sp, tp))), devices)


def mesh_for_spec(spec: GpuSpec, tp: Optional[int] = None, sp: int = 1,
                  dp: int = 1, devices: Optional[Sequence] = None) -> Mesh:
    """The default mesh of a slice: tp defaults to the cards of a host (tp
    stays on one host), fsdp takes the rest."""
    chips = spec.chips
    tp = tp if tp is not None else min(spec.chips_per_host, chips)
    if chips % (dp * sp * tp):
        raise ValueError(f"{chips} cards do not divide into dp={dp} x "
                         f"sp={sp} x tp={tp}")
    fsdp = chips // (dp * sp * tp)
    return make_mesh(dp=dp, fsdp=fsdp, sp=sp, tp=tp, devices=devices)
