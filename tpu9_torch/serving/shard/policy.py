"""Sharding policy objects: how the serving engine places its device state
over a tp × fsdp grid of ranks (counterpart of
``tpu9/serving/shard/policy.py``).

The engine is topology-oblivious: every placement it makes goes through
one of these hooks. :class:`SingleDevicePolicy` makes each hook the
identity (or the single-device call the engine made before), so a ``1x1``
engine is the unsharded engine: the same capture keys, the same kernel
launches, the same streams. :class:`MeshPolicy` is where multi-GPU
serving lives:

- weights sliced into rank shards by ``parallel.sharding`` (the Megatron
  column/row layout × FSDP, int8- and MoE-aware);
- the paged KV pool one head shard per rank, ``[L, N, BS, KH/tp, D]``,
  with int8 scale planes ``[L, N, BS, KH/tp]``; the dense cache and the
  prefill scratch ``[L, B, S, KH/tp, D]``; block ids stay global, so the
  host-side allocator, prefix cache, reservations and tiering are
  unchanged, and the block table is replicated to each rank's device;
- kvwire export and down-paging gather the heads into canonical
  full-head planes, and import and up-paging place them back by head.

One process drives every rank, as the reference's single controller
drives its mesh: a rank is a shard of the state plus the device it lives
on, and several ranks may share one device (``devices=["cuda:0",
"cuda:0"]``). The reduction between ranks is ``parallel.sharding
.reduce_partials``: a copy to rank 0's device and a sum, the same code
whether the ranks share a card or not.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import torch

from ...models.transformer import init_kv_cache
from ...parallel.sharding import (Ranked, RankParams, map_leaves,
                                  map_placed, named_leaves, placed_leaves,
                                  rank_layout, shard_decoder, shard_part,
                                  to_device)
from ...utils.platform import default_device
from .plan import Topology, parse_topology

Params = dict[str, Any]


class SingleDevicePolicy:
    """The identity policy: the single-card engine, verbatim."""

    topology = Topology(1, 1)

    def __init__(self, device=None):
        self.device = default_device(device)

    def describe(self) -> dict:
        return self.topology.as_dict()

    @property
    def one_device(self) -> bool:
        """Every rank on one device: a decode window over all of them is
        one CUDA graph."""
        return True

    def distinct_devices(self) -> list:
        return [self.device]

    # -- placement -----------------------------------------------------------

    def place_params(self, params: Params, cfg=None) -> Params:
        return params

    def abstract(self, params: Params, cfg=None) -> Params:
        return params

    def materialize(self, params: Params) -> Params:
        """Zero-filled storage for an abstract (meta) tree: compile-ahead's
        captures run a forward over it, and garbage weights could write
        NaN into the pool's trash block."""
        return map_leaves(
            lambda t: torch.zeros(t.shape, dtype=t.dtype,
                                  device=self.device), params)

    def bind_leaves(self, params: Params, cfg=None,
                    part: Optional[str] = None) -> dict:
        """``{path: tensor}`` of what ``bind_params`` copies into the
        engine's storage, keyed as that storage's ``named_leaves``: the
        whole tree, or with ``part`` (``"embed"``, ``"layers/3"``) that one
        part of it, given alone."""
        return dict(named_leaves(params, part or ""))

    def part_paths(self, part: str) -> list:
        """The storage paths under which ``part`` lives."""
        return [part]

    def check_placed(self, params: Params) -> None:
        """Refuse a tree with a leaf off the policy's device, naming it."""
        for path, t in named_leaves(params):
            _check_device(path, t, self.device)

    def placed_tensors(self, params: Params):
        """``(tensor, device)`` of every leaf of a placed tree."""
        return ((t, self.device) for _, t in named_leaves(params))

    def rank_specs(self, cfg) -> list:
        """``(device, config)`` of each rank: the config a rank's KV state
        is shaped by."""
        return [(self.device, cfg)]

    def join(self, parts: list):
        """The ranks' trees as the engine holds them: one tree here."""
        return parts[0]

    def init_kv_cache(self, cfg, batch: int, max_len: int = 0,
                      dtype=None):
        """Contiguous k/v ``[L, B, S, KH, D]``, one per rank."""
        return self.join([init_kv_cache(rc, batch, max_len, dtype, dev)
                          for dev, rc in self.rank_specs(cfg)])

    # -- KV heads across ranks (kvwire, host tier) ---------------------------

    def gather_heads(self, name: str, parts: list) -> torch.Tensor:
        """The ranks' slices of one pool plane joined on the head axis, on
        rank 0's device: the canonical full-head plane."""
        return parts[0]

    def split_heads(self, name: str, plane: torch.Tensor) -> list:
        """A canonical full-head plane cut into each rank's heads."""
        return [plane]

    # -- observability -------------------------------------------------------

    def hbm_used_gb_per_chip(self) -> float:
        """Live device memory of the busiest device, GB (0.0 on the CPU)."""
        used = [torch.cuda.memory_allocated(d) / 1e9
                for d in self.distinct_devices() if d.type == "cuda"]
        return round(max(used), 3) if used else 0.0

    def hbm_limit_gb_per_chip(self) -> float:
        """The smallest device's capacity, GB (0.0 on the CPU)."""
        cap = [torch.cuda.get_device_properties(d).total_memory / 1e9
               for d in self.distinct_devices() if d.type == "cuda"]
        return round(min(cap), 3) if cap else 0.0


class MeshPolicy(SingleDevicePolicy):
    """Rank-sharded placement for a tp(×fsdp) serving grid. ``devices``
    lists the grid's devices, tp innermost (fsdp piece j of rank r on
    ``devices[j * tp + r]``); repeats are allowed."""

    def __init__(self, topology: Topology, devices: Sequence):
        if topology.n_chips > len(devices):
            raise ValueError(f"topology {topology} needs {topology.n_chips} "
                             f"devices, have {len(devices)}")
        self.topology = topology
        self.devices = [_device(d) for d in devices[:topology.n_chips]]
        self.rank_devices = self.devices[:topology.tp]
        self.device = self.devices[0]

    @property
    def one_device(self) -> bool:
        return len(self.distinct_devices()) == 1

    def distinct_devices(self) -> list:
        out: list = []
        for d in self.devices:
            if d not in out:
                out.append(d)
        return out

    def layout(self, cfg):
        return rank_layout(cfg, self.topology.tp, self.topology.fsdp)

    # -- placement -----------------------------------------------------------

    def place_params(self, params, cfg=None):
        """Slice a full tree into rank shards on the ranks' devices; a
        tree already placed passes through."""
        if isinstance(params, RankParams):
            return params
        return shard_decoder(params, cfg, self.topology.tp,
                             self.topology.fsdp, self.devices)

    def abstract(self, params, cfg=None):
        """The meta rank shards of a full (real or meta) tree: the shapes
        an engine is built and precompiled on before its weights exist."""
        if isinstance(params, RankParams):
            return params

        def meta(t, device):
            return torch.empty(t.shape, dtype=t.dtype, device="meta")

        return shard_decoder(params, cfg, self.topology.tp,
                             self.topology.fsdp, self.devices, place=meta)

    def materialize(self, params: RankParams) -> RankParams:
        return map_placed(
            lambda t, dev: torch.zeros(t.shape, dtype=t.dtype, device=dev),
            params)

    def bind_leaves(self, params, cfg=None, part=None) -> dict:
        """A full tree (or one part of it) as the views of it (no copy)
        each rank shard takes: ``bind_params`` copies each into the
        engine's shard storage, paths named by rank (``0/layers/0/wq``).
        Rank shards pass through."""
        tp, fsdp = self.topology.tp, self.topology.fsdp
        if part is None:
            if not isinstance(params, RankParams):
                params = shard_decoder(params, cfg, tp, fsdp, self.devices,
                                       place=_view)
            return dict(named_leaves(params))
        pieces = shard_part(part, params, self.layout(cfg), self.devices,
                            place=_view)
        return {path: t for r, piece in enumerate(pieces)
                for path, t in named_leaves(piece, f"{r}/{part}")}

    def part_paths(self, part: str) -> list:
        return [f"{r}/{part}" for r in range(self.topology.tp)]

    def check_placed(self, params) -> None:
        if not isinstance(params, RankParams):
            raise ValueError("a mesh engine's params must be rank shards "
                             "(MeshPolicy.place_params)")
        if len(params) != self.topology.tp:
            raise ValueError(f"params hold {len(params)} rank shards, the "
                             f"topology {self.topology} has tp="
                             f"{self.topology.tp}")
        for path, t, dev in placed_leaves(params):
            _check_device(path, t, dev)

    def placed_tensors(self, params: RankParams):
        return ((t, dev) for _, t, dev in placed_leaves(params))

    def rank_specs(self, cfg) -> list:
        rc = self.layout(cfg).rank_config(cfg)
        return [(d, rc) for d in self.rank_devices]

    def join(self, parts: list):
        return Ranked(parts)

    # -- KV heads across ranks ------------------------------------------------

    def gather_heads(self, name: str, parts: list) -> torch.Tensor:
        return torch.cat([to_device(p, self.device) for p in parts],
                         dim=_head_axis(name, parts[0].dim()))

    def split_heads(self, name: str, plane: torch.Tensor) -> list:
        axis = _head_axis(name, plane.dim())
        kh = plane.shape[axis] // self.topology.tp
        return [plane.narrow(axis, r * kh, kh)
                for r in range(self.topology.tp)]


def _view(t: torch.Tensor, device) -> torch.Tensor:
    """A slice left where it is: ``bind_params`` copies it into place."""
    return t


def _device(d) -> torch.device:
    """``d`` as a ``torch.device``, a CUDA device without an index as the
    current one: two ranks named ``"cuda"`` share one card."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def _head_axis(name: str, ndim: int) -> int:
    """The head axis of a pool plane: payloads ``[..., KH, D]``, scale
    planes ``[..., KH]``."""
    return ndim - 1 if name.endswith("_scale") else ndim - 2


def _check_device(path: str, t: torch.Tensor, device: torch.device) -> None:
    if t.device.type != device.type or (
            device.index is not None and t.device.index != device.index):
        raise ValueError(f"param {path} is on {t.device}, the engine on "
                         f"{device}: move the tree there first")


def make_policy(topology: "Topology | str | None",
                devices: Optional[Sequence] = None) -> SingleDevicePolicy:
    """The policy of a topology: ``None`` or ``1x1`` is the identity policy
    on ``devices[0]`` (the current CUDA device when None); a larger one a
    :class:`MeshPolicy` over ``devices``, by default ``cuda:0..n-1`` of
    the cards this process sees. Raises when the topology needs more
    devices than there are."""
    topo = parse_topology(topology) or Topology(1, 1)
    if topo.is_single:
        return SingleDevicePolicy(devices[0] if devices else None)
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    return MeshPolicy(topo, devices)
