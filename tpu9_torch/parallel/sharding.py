"""Sharding of the port's param trees (counterpart of
``tpu9/parallel/sharding.py``).

The layout table is the reference's Megatron layout: column-parallel
up-projections and row-parallel down-projections, so each block needs one
reduction, with FSDP on the other dimension:

  embed   [V, D]   P(fsdp, None)        (vocab rows sharded by fsdp)
  lm_head [D, V]   P(fsdp, tp)          (column-parallel logits)
  wq/wk/wv[D, HDh] P(fsdp, tp)          (column-parallel heads)
  wo      [HDh, D] P(tp, fsdp)          (row-parallel, then a reduction)
  w_gate  [D, F]   P(fsdp, tp)
  w_up    [D, F]   P(fsdp, tp)
  w_down  [F, D]   P(tp, fsdp)
  norms   [D]      replicated

An int8 entry ``{q, scale}`` shards ``q`` like the dense weight and
``scale`` along the output axis; a MoE layer's expert stacks shard their
leading expert axis over tp and its router is replicated
(``models/moe.py:moe_param_specs``).

There is no GSPMD to insert collectives, so where the reference's specs
are the whole backend, here they are sliced into explicit shards that one
process drives (single-controller; a mesh's devices may repeat).
:func:`shard_params` ``(params, mesh, specs)`` is the reference's entry:
a decoder tree with ``decoder_param_specs`` becomes a :class:`RankParams`,
one tree per tp rank, and ``models/transformer.py`` runs each layer rank
by rank and sums the partials with :func:`reduce_partials` (a copy to rank
0's device and an add: the all-reduce); any other tree (adapters, a MoE
layer, optimizer state) has each leaf split into :class:`Pieces` over the
mesh devices of the axes its spec names, or one copy on the mesh's first
device where it names none. Autograd runs through the copies, so a leaf
read by several ranks gets the sum of their gradients.

A rank is a shard of the state plus the device it lives on: several ranks
may share one device. The serving policies slice by the config
(:func:`shard_decoder` with a config, part by part, :func:`shard_part`,
so a load can slice each part as it is drawn). Divisibility is decided per
block (attention, FFN, output head), not per leaf: a block whose heads,
hidden columns or experts do not divide by tp is replicated whole and
computed once, on rank 0, which gives the numbers the reference's
``fit_spec`` fallback gives. When tp exceeds the kv heads but divides them
out (tp % kv_heads == 0), the attention is laid out by head: each rank
takes its share of q heads and a copy of the one kv head they read.
:func:`shard_params` knows no config, so it slices the attention as the
reference's ``fit_spec`` does, evenly, and the decoder regroups a rank's
kv heads from those slices where the config's layout needs it
(:meth:`RankLayout.resolve`). fsdp splits a leaf into :class:`Pieces` on
the other dimension (``fit_spec``: a dimension fsdp does not divide stays
whole), each on its own device, gathered onto the rank's device before
use.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from .mesh import current_mesh

Params = dict[str, Any]


class P(tuple):
    """A partition spec: one mesh axis name (or None) per dimension, as
    ``jax.sharding.PartitionSpec`` spells it."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def _quant_aware(spec: P, leaf) -> Any:
    """An int8 entry ``{q: [in, out], scale: [1, out]}``: ``q`` shards like
    the dense weight, ``scale`` along the output axis."""
    if isinstance(leaf, dict) and "q" in leaf:
        out_axis = spec[1] if len(spec) > 1 else None
        return {"q": spec, "scale": P(None, out_axis)}
    return spec


def _layer_specs(layer: Params, tp: str, fsdp: Optional[str],
                 moe_axis: Optional[str] = None) -> dict:
    base = {
        "attn_norm": P(),
        "mlp_norm": P(),
        "wq": P(fsdp, tp),
        "wk": P(fsdp, tp),
        "wv": P(fsdp, tp),
        "wo": P(tp, fsdp),
        "w_gate": P(fsdp, tp),
        "w_up": P(fsdp, tp),
        "w_down": P(tp, fsdp),
    }
    out = {name: _quant_aware(spec, layer.get(name))
           for name, spec in base.items() if name in layer}
    if "moe" in layer:
        from ..models.moe import moe_param_specs
        out["moe"] = moe_param_specs(layer["moe"], axis=moe_axis or tp)
    return out


def decoder_param_specs(params: Params, tp: str = "tp",
                        fsdp: Optional[str] = "fsdp",
                        moe_axis: Optional[str] = None) -> Params:
    """The spec tree of a decoder param tree (dense, int8 or MoE; expert
    stacks shard over ``moe_axis``, tp by default)."""
    return _join_parts((name, _part_specs(name, part, tp, fsdp, moe_axis))
                       for name, part in tree_parts(params))


def _part_specs(name: str, part, tp: str = "tp",
                fsdp: Optional[str] = "fsdp",
                moe_axis: Optional[str] = None) -> Any:
    """The spec tree of one part of a decoder tree (:func:`tree_parts`)."""
    if name.startswith("layers/"):
        return _layer_specs(part, tp, fsdp, moe_axis=moe_axis)
    if name == "embed":
        return P(fsdp, None)
    if name == "lm_head":
        return _quant_aware(P(fsdp, tp), part)
    return P()


def tree_parts(params: Params):
    """``(name, part)`` of each top-level part of a decoder tree, in the
    tree's order: ``"embed"``, ``"final_norm"``, each ``"layers/<i>"`` and
    ``"lm_head"``. A load draws, slices and binds one part at a time."""
    for key, value in params.items():
        if key == "layers":
            for i, layer in enumerate(value):
                yield f"layers/{i}", layer
        else:
            yield key, value


def _join_parts(items) -> Params:
    """The tree of ``(name, part)`` pairs named as :func:`tree_parts`
    names them."""
    tree: Params = {}
    for name, part in items:
        if name.startswith("layers/"):
            tree.setdefault("layers", []).append(part)
        else:
            tree[name] = part
    return tree


def fit_spec(shape, spec: P, axes: dict) -> P:
    """Drop the spec axes whose size (``axes[name]``) does not divide the
    dimension: that dimension is replicated instead. A tuple entry shards
    over the product of its axes."""
    ndim = len(shape)
    dims = []
    for i, axis in enumerate(spec):
        if axis is None or i >= ndim:
            dims.append(None)
            continue
        if isinstance(axis, str):
            size = axes.get(axis, 1)
        elif isinstance(axis, (tuple, list)):
            size = 1
            for a in axis:
                size *= axes.get(a, 1)
        else:
            size = 1
        dims.append(axis if shape[i] % size == 0 else None)
    while len(dims) < ndim:
        dims.append(None)
    return P(*dims)


# -- rank containers --------------------------------------------------------


class TreeList(list):
    """A list that a tree map rebuilds as its own type (``like``)."""

    def like(self, items) -> "TreeList":
        out = type(self)(items)
        out.__dict__.update(self.__dict__)
        return out


class Ranked(TreeList):
    """One tree per tp rank (a KV cache, a pool, a scratch). A string key
    reads that entry of every rank: ``kv["k"]`` is the ranks' ``k``
    tensors, as a :class:`Ranked`."""

    def __getitem__(self, key):
        if isinstance(key, str):
            return Ranked(t[key] for t in self)
        return super().__getitem__(key)


class Pieces(TreeList):
    """A leaf split over a mesh axis (fsdp for rank shards): its pieces, in
    order along ``dim``, piece j on ``devices[j]`` (a piece may itself be
    :class:`Pieces`, split over a further axis). :func:`gather_leaf` joins
    them on one device."""

    dim: int = 0
    devices: Optional[list] = None


class RankParams(Ranked):
    """The param tree of a tp × fsdp policy: entry r is tp rank r's tree
    (the full tree's paths, each leaf a slice, a replica or
    :class:`Pieces`). ``layout`` says which blocks are split;
    ``devices`` are the ranks' devices and ``grid`` every device of the
    tp × fsdp grid (fsdp piece j of rank r on ``grid[j * tp + r]``);
    ``global_nbytes`` and ``global_numel`` are the full tree's.
    ``slices[r]`` maps each leaf path of rank r's tree (as
    :func:`named_leaves` names it) that is sliced over tp to its slice:
    ranks whose entries at a path name the same slice (or none) hold
    replicas of one logical value (:func:`replica_groups`)."""

    layout: "RankLayout"
    devices: list
    grid: list
    global_nbytes: int = 0
    global_numel: int = 0
    slices: Optional[list] = None


def named_leaves(tree, path: str = ""):
    """Every ``(path, tensor)`` in a tree of dicts and lists (a param
    tree, rank shards, a cache), paths as the ``.tpu9w`` index keys them;
    a rank shard's paths begin with its rank, an fsdp piece's end with its
    index."""
    if isinstance(tree, torch.Tensor):
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from named_leaves(v, f"{path}/{k}".lstrip("/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from named_leaves(v, f"{path}/{i}".lstrip("/"))


def map_leaves(fn, tree):
    """``fn`` of every tensor in a tree of dicts and lists, in the tree's
    shape (lists for tuples, as the bridge builds them; rank shards and
    fsdp pieces keep their own types)."""
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, TreeList):
        return tree.like(map_leaves(fn, v) for v in tree)
    if isinstance(tree, (list, tuple)):
        return [map_leaves(fn, v) for v in tree]
    return fn(tree)


def ranks(tree) -> list:
    """The rank trees of ``tree``: a :class:`Ranked`'s entries, else the
    tree itself as the one rank."""
    return list(tree) if isinstance(tree, Ranked) else [tree]


def per_rank(fn: Callable, *trees):
    """``fn`` applied rank by rank: over the zipped entries of
    :class:`Ranked` trees (giving a :class:`Ranked`), or once over plain
    trees (giving its result)."""
    if not isinstance(trees[0], Ranked):
        return fn(*trees)
    return Ranked(fn(*parts) for parts in zip(*(ranks(t) for t in trees)))


def to_device(x, device):
    """``x`` on ``device`` (queued, not waited for); a tensor already
    there, or a non-tensor, is returned as it is."""
    if isinstance(x, torch.Tensor) and x.device != torch.device(device):
        return x.to(device, non_blocking=True)
    return x


def reduce_partials(parts: list, device) -> torch.Tensor:
    """The sum of the ranks' partial sums of one row-parallel product, on
    ``device``: each partial is copied there, the sum is taken in f32 and
    rounded once to the partials' dtype (the f32 sum of bf16 values rounded
    once; at f32 an ordinary sum). At bf16 the unsharded GEMM rounds
    its f32 sum once; here each partial was rounded by its own GEMM
    first, so the result can differ from it by about one bf16 ulp of the
    partials. On one device the copies are no-ops and this is the
    reduction itself."""
    if len(parts) == 1:
        return to_device(parts[0], device)
    # a bf16 sum accumulates in f32 and rounds once: two kernels, the
    # stack and the sum
    return torch.stack([to_device(p, device) for p in parts]).sum(dim=0)


def gather_leaf(leaf, device):
    """A rank's leaf whole on ``device``: :class:`Pieces` are joined along
    their dimension (nested pieces first), an int8 entry gathers both
    planes, a tensor is returned as it is."""
    if isinstance(leaf, Pieces):
        return torch.cat([to_device(gather_leaf(p, device), device)
                          for p in leaf], dim=leaf.dim)
    if isinstance(leaf, dict):
        return {k: gather_leaf(v, device) for k, v in leaf.items()}
    return leaf


def leaf_device(leaf) -> torch.device:
    """Where a leaf lives: a tensor's device, the first piece's of
    :class:`Pieces`, an int8 entry's payload's."""
    if isinstance(leaf, Pieces):
        return leaf_device(leaf[0])
    if isinstance(leaf, dict):
        return leaf_device(leaf["q"])
    return leaf.device


def same_device(a, b) -> bool:
    """``a`` and ``b`` name one device: the same type, and the same index
    where both name one (a CPU tensor reports no index)."""
    a, b = torch.device(a), torch.device(b)
    return a.type == b.type and (a.index is None or b.index is None
                                 or a.index == b.index)


def placed(tree, device):
    """``(path, tensor, device it belongs on)`` of every leaf of a tree:
    rank shards' leaves on their ranks' (and pieces') devices
    (:func:`placed_leaves`), :class:`Pieces` on theirs, any other leaf on
    ``device``."""
    if isinstance(tree, RankParams):
        yield from placed_leaves(tree)
    elif isinstance(tree, Pieces):
        for j, p in enumerate(tree):
            want = tree.devices[j] if tree.devices else None
            for path, t, dev in placed(p, want or device):
                yield f"{j}/{path}".rstrip("/"), t, dev
    elif isinstance(tree, dict):
        for k, v in tree.items():
            for path, t, dev in placed(v, device):
                yield f"{k}/{path}".rstrip("/"), t, dev
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            for path, t, dev in placed(v, device):
                yield f"{i}/{path}".rstrip("/"), t, dev
    elif isinstance(tree, torch.Tensor):
        yield "", tree, device


def _span(parts: list, lo: int, hi: int, dim: int, device):
    """``[lo, hi)`` along ``dim`` of the concatenation of ``parts`` (equal
    widths), copied onto ``device`` from the parts that hold it."""
    if isinstance(parts[0], dict):
        # an int8 entry: a column slice cuts the scale too; a row slice
        # leaves it whole
        return {"q": _span([p["q"] for p in parts], lo, hi, dim, device),
                "scale": (_span([p["scale"] for p in parts], lo, hi, dim,
                                device) if dim == 1
                          else to_device(parts[0]["scale"], device))}
    w = parts[0].shape[dim]
    out = [to_device(parts[s].narrow(dim, max(lo, s * w) - s * w,
                                     min(hi, (s + 1) * w) - max(lo, s * w)),
                     device)
           for s in range(lo // w, (hi - 1) // w + 1)]
    return out[0] if len(out) == 1 else torch.cat(out, dim)


def regroup_attention(layers: list, lay: "RankLayout", devs: list) -> list:
    """The ranks' gathered layers (``layers[r]`` on ``devs[r]``) with the
    attention each needs under ``lay`` where the weights lie in even
    slices (``lay.held == "even"``): for ``"kv_copies"`` each rank's kv
    head from the slices that hold it, for ``"replicated"`` the whole
    projections on rank 0. Otherwise ``layers`` as they are."""
    if lay.held != "even":
        return layers
    out = [dict(layer) for layer in layers]
    names = ("wk", "wv") if lay.attn == "kv_copies" else ("wq", "wk", "wv",
                                                           "wo")
    for name in names:
        dim = 0 if name == "wo" else 1
        parts = [layer[name] for layer in layers]
        size = ((parts[0]["q"] if isinstance(parts[0], dict) else parts[0])
                .shape[dim] * len(parts))
        for r in range(len(layers) if lay.attn_split else 1):
            lo, hi = lay.tp_range(name, r, size) or (0, size)
            out[r][name] = _span(parts, lo, hi, dim, devs[r])
    return out


# -- the layout of one config over tp ranks ----------------------------------


@dataclass(frozen=True)
class RankLayout:
    """Which blocks of a config split over ``tp`` ranks, and how.

    ``attn``: ``"heads"`` (each rank takes ``n_heads/tp`` q heads and
    ``n_kv_heads/tp`` kv heads), ``"kv_copies"`` (tp a multiple of the kv
    heads: each rank takes ``n_heads/tp`` q heads and a copy of the one kv
    head they read) or ``"replicated"``; a layout read off shapes alone
    (:func:`shape_layout`, no head counts) says ``"even"`` (each
    projection's head dimension in tp equal slices). ``ffn``: the hidden
    columns (or, for a MoE layer, the experts) split over tp. ``head``:
    the untied output head split over the vocabulary. ``held`` is
    ``"even"`` where the weights lie in even slices but the config's
    layout is another: the decoder regroups them (:func:`regroup_attention`)."""

    tp: int
    fsdp: int
    attn: str
    ffn: bool
    head: bool
    q_heads: int
    kv_heads: int
    head_dim: int
    group: int
    held: str = ""

    @property
    def attn_split(self) -> bool:
        return self.attn != "replicated"

    def resolve(self, cfg) -> "RankLayout":
        """The layout the decoder runs ``cfg`` under over these weights: a
        config's own layout as it is; for a shape layout, the config's,
        marked ``held="even"`` where its attention slices differ from the
        even ones (``"heads"`` slices are the even ones), or replicated
        attention where the weights are whole."""
        if self.head_dim:
            return self
        want = rank_layout(cfg, self.tp, self.fsdp)
        if (want.ffn, want.head) != (self.ffn, self.head):
            raise ValueError(f"weights sliced as {self} do not fit {cfg}")
        if self.attn == "replicated":
            return dataclasses.replace(want, attn="replicated",
                                       q_heads=cfg.n_heads,
                                       kv_heads=cfg.n_kv_heads)
        if want.attn == "heads":
            return want
        return dataclasses.replace(want, held="even")

    def rank_config(self, cfg):
        """The config rank r's attention runs under: its own head counts,
        and for a split dense FFN its own hidden width. A MoE config keeps
        its expert count (routing is over every expert). One rank runs
        under ``cfg`` itself."""
        if self.tp == 1:
            return cfg
        kw = {}
        if self.attn_split:
            kw.update(n_heads=self.q_heads, n_kv_heads=self.kv_heads)
        if self.ffn and not cfg.n_experts:
            kw["hidden_dim"] = cfg.hidden_dim // self.tp
        return dataclasses.replace(cfg, **kw) if kw else cfg

    def kv_head_range(self, r: int) -> tuple[int, int]:
        """The global kv heads ``[lo, hi)`` rank r holds."""
        if self.attn == "heads":
            return r * self.kv_heads, (r + 1) * self.kv_heads
        if self.attn == "kv_copies":
            h = (r * self.q_heads) // self.group
            return h, h + 1
        return 0, self.kv_heads

    def tp_range(self, name: str, r: int, size: int):
        """The slice ``[lo, hi)`` of leaf ``name``'s tp dimension (of
        ``size``) rank r holds, or None when that block is replicated."""
        attn = name in ("wq", "wo", "wk", "wv")
        if attn and self.attn not in ("even", "replicated"):
            if name in ("wk", "wv"):
                lo, hi = self.kv_head_range(r)
                return lo * self.head_dim, hi * self.head_dim
            w = self.q_heads * self.head_dim
            return r * w, (r + 1) * w
        split = {"w_gate": self.ffn, "w_up": self.ffn, "w_down": self.ffn,
                 "lm_head": self.head}.get(name, self.attn == "even" and attn)
        if not split:
            return None
        w = size // self.tp
        return r * w, (r + 1) * w


def shape_layout(params: Params, tp: int, fsdp: int = 1) -> RankLayout:
    """The :class:`RankLayout` of a decoder tree over ``tp`` ranks read off
    its shapes, as the reference's ``fit_spec`` slices (no config, so no
    head counts: :meth:`RankLayout.resolve` adds them)."""
    def shape(w):
        return (w["q"] if isinstance(w, dict) else w).shape

    layer = params["layers"][0]
    attn = ("even" if shape(layer["wq"])[1] % tp == 0
            and shape(layer["wk"])[1] % tp == 0 else "replicated")
    # the FFN's split axis: a MoE stack's experts, a dense FFN's columns
    width = (shape(layer["moe"]["w_gate"])[0] if "moe" in layer
             else shape(layer["w_gate"])[1])
    head = "lm_head" in params and shape(params["lm_head"])[1] % tp == 0
    return RankLayout(tp=tp, fsdp=fsdp, attn=attn, ffn=width % tp == 0,
                      head=head, q_heads=0, kv_heads=0, head_dim=0, group=0)


def rank_layout(cfg, tp: int, fsdp: int = 1) -> RankLayout:
    """The :class:`RankLayout` of ``cfg`` over ``tp`` ranks."""
    qh, kh = cfg.n_heads, cfg.n_kv_heads
    if kh % tp == 0:
        attn, q_r, kv_r = "heads", qh // tp, kh // tp
    elif tp % kh == 0 and qh % tp == 0:
        attn, q_r, kv_r = "kv_copies", qh // tp, 1
    else:
        attn, q_r, kv_r = "replicated", qh, kh
    width = cfg.n_experts or cfg.hidden_dim
    return RankLayout(
        tp=tp, fsdp=fsdp, attn=attn, ffn=width % tp == 0,
        head=not cfg.tie_embeddings and cfg.vocab_size % tp == 0,
        q_heads=q_r, kv_heads=kv_r, head_dim=cfg.head_dim,
        group=qh // kh)


# -- slicing a full tree into rank shards -------------------------------------


def place_on(t: torch.Tensor, device) -> torch.Tensor:
    """A slice as a rank shard's own storage on ``device``; a meta tensor
    stays meta (an abstract shard)."""
    if t.is_meta:
        return t
    return t.to(device).contiguous()


def _walk(tree, specs, name: str, fn, path: str = ""):
    """Map ``fn(leaf, spec, owner name, path)`` over a param tree and its
    spec tree; an int8 entry's planes take the owner's name."""
    if isinstance(tree, dict):
        keep = name if "q" in tree else None
        return {k: _walk(v, specs[k], keep or k, fn, f"{path}/{k}")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_walk(v, s, name, fn, f"{path}/{i}")
                for i, (v, s) in enumerate(zip(tree, specs))]
    return fn(tree, specs, name, path)


def shard_part(name: str, part, lay: RankLayout, devices: Sequence,
               place: Callable = place_on,
               slices: Optional[list] = None) -> list:
    """One part of a full decoder tree (:func:`tree_parts`) sliced into its
    tp rank pieces by ``lay`` (a :class:`RankLayout`): rank r's leaves go
    to ``devices[r]`` and fsdp piece j of its leaves to
    ``devices[j * tp + r]`` (tp innermost, as the reference's mesh orders
    its axes). ``place(slice, device)`` makes each piece (by default its
    own contiguous storage there; an identity ``place`` gives views). A
    leaf that several ranks hold whole on one device is placed once and
    shared. ``slices``, one dict a rank, gets each tp-sliced leaf's path
    and slice (:attr:`RankParams.slices`)."""
    tp, fsdp = lay.tp, lay.fsdp
    specs = _part_specs(name, part)
    axes = {"tp": tp, "fsdp": fsdp}
    devices = list(devices)
    memo: dict = {}

    def put(src, t, key, device):
        k = (id(src), key, str(device))
        if k not in memo:
            memo[k] = place(t, device)
        return memo[k]

    def rank_piece(r: int):
        def leaf(src, spec, leaf_name, path):
            spec = fit_spec(src.shape, spec, axes)
            t, key = src, ()
            if "tp" in spec:
                d = spec.index("tp")
                rng = lay.tp_range(leaf_name, r, src.shape[d])
                if rng is not None:
                    t, key = src.narrow(d, rng[0], rng[1] - rng[0]), (d, rng)
            path = f"{name}{path}"
            if "fsdp" in spec and fsdp > 1:
                d = spec.index("fsdp")
                n = t.shape[d] // fsdp
                pieces = Pieces(put(src, t.narrow(d, j * n, n), key + (j,),
                                    devices[j * tp + r])
                                for j in range(fsdp))
                pieces.dim = d
                pieces.devices = [devices[j * tp + r] for j in range(fsdp)]
                if slices is not None and key:
                    slices[r].update((f"{path}/{j}", key) for j in range(fsdp))
                return pieces
            if slices is not None and key:
                slices[r][path] = key
            return put(src, t, key, devices[r])

        return _walk(part, specs, "" if name.startswith("layers/") else name,
                     leaf)

    return [rank_piece(r) for r in range(tp)]


def shard_decoder(params: Params, cfg, tp: int, fsdp: int,
                  devices: Sequence, place: Callable = place_on
                  ) -> RankParams:
    """Slice a full decoder tree into tp rank trees, part by part
    (:func:`shard_part`, which says where each piece goes), by ``cfg``'s
    layout (:func:`rank_layout`), or with ``cfg=None`` by the even slices
    its shapes allow (:func:`shape_layout`)."""
    devices = list(devices)
    lay = (rank_layout(cfg, tp, fsdp) if cfg is not None
           else shape_layout(params, tp, fsdp))
    slices = [{} for _ in range(tp)]
    parts = [(name, shard_part(name, part, lay, devices, place, slices))
             for name, part in tree_parts(params)]
    out = RankParams(_join_parts((name, pieces[r]) for name, pieces in parts)
                     for r in range(tp))
    out.layout = lay
    out.grid = devices
    out.devices = devices[:tp]
    out.slices = slices
    leaves = [t for _, t in named_leaves(params)]
    out.global_nbytes = sum(t.numel() * t.element_size() for t in leaves)
    out.global_numel = sum(t.numel() for t in leaves)
    return out


def replica_groups(params: RankParams) -> list:
    """The logical leaves of rank shards, each as the list of its distinct
    tensors: ranks that hold one path unsliced, or sliced alike, hold
    replicas of one value (one shared tensor where they share a device).
    Groups follow rank 0's leaf order, then any leaf only later ranks
    hold."""
    groups: dict = {}
    for r, tree in enumerate(params):
        keys = params.slices[r] if params.slices else {}
        for path, t in named_leaves(tree):
            group = groups.setdefault((path, keys.get(path)), [])
            if all(t is not u for u in group):
                group.append(t)
    return list(groups.values())


# -- the reference's entry: any tree on a mesh ---------------------------------


def fsdp_specs(params: Params, axis: str = "fsdp",
               min_size: int = 2 ** 14) -> Params:
    """The generic FSDP rule for any tree: the largest dimension (the first
    of equal ones) of every tensor of ``min_size`` elements or more sharded
    over ``axis``; smaller tensors and scalars replicated. For adapter and
    optimizer trees, where no tp layout applies."""

    def rule(x):
        if not isinstance(x, torch.Tensor) or x.numel() < min_size \
                or x.ndim == 0:
            return P()
        dims = [None] * x.ndim
        dims[max(range(x.ndim), key=lambda i: x.shape[i])] = axis
        return P(*dims)

    return map_tree(rule, params)


def replicate_specs(tree: Params) -> Params:
    return map_tree(lambda _: P(), tree)


def map_tree(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching entries of
    ``rest`` (a spec tree's :class:`P` and a sharded leaf's
    :class:`Pieces` are leaves), rebuilding dicts, lists, tuples and named
    tuples as they are."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, (P, Pieces)):
        out = [map_tree(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        if hasattr(tree, "_fields"):
            return type(tree)(*out)
        return tuple(out) if isinstance(tree, tuple) else out
    return fn(tree, *rest)


def _is_decoder(params, specs) -> bool:
    return (isinstance(params, dict) and "embed" in params
            and "layers" in params and specs == decoder_param_specs(params))


def shard_params(params: Params, mesh, specs: Params) -> Params:
    """Place a tree on ``mesh`` by a spec tree, the reference's
    ``shard_params``. A dimension the axis does not divide is replicated
    (:func:`fit_spec`). A decoder tree with ``decoder_param_specs`` becomes
    rank shards over the mesh's tp and fsdp axes (:func:`shard_decoder`,
    sliced evenly: the decoder fits them to its config); any other tree
    has each leaf split into :class:`Pieces` over the mesh devices of the
    axes its spec names (nested for two), or one copy on the mesh's first
    device where it names none."""
    if _is_decoder(params, specs):
        tp, fsdp = mesh.shape.get("tp", 1), mesh.shape.get("fsdp", 1)
        return shard_decoder(params, None, tp, fsdp,
                             mesh.sub_devices(("fsdp", "tp")))

    def leaf(x, spec):
        if not isinstance(x, torch.Tensor):
            return x
        return _split(x, list(fit_spec(x.shape, spec, mesh.shape)), mesh, {})

    return map_tree(leaf, params, specs)


def _split(x: torch.Tensor, spec: list, mesh, coords: dict):
    """``x`` split on the first dimension ``spec`` names an axis for (a
    tuple entry: the product of its axes, row-major), each piece split on
    the next such dimension, placed on the device at ``coords`` (the
    mesh's first device for a leaf no axis splits)."""
    d = next((i for i, a in enumerate(spec) if a is not None), None)
    if d is None:
        return place_on(x, _device_at(mesh, coords))
    names = spec[d] if isinstance(spec[d], (tuple, list)) else (spec[d],)
    sizes = [mesh.shape[a] for a in names]
    n = int(np.prod(sizes))
    w = x.shape[d] // n
    rest = spec[:d] + [None] + spec[d + 1:]
    nested = any(a is not None for a in rest)
    pieces = Pieces()
    pieces.dim, pieces.devices = d, []
    for j in range(n):
        at = dict(coords)
        at.update(zip(names, (int(i) for i in np.unravel_index(j, sizes))))
        pieces.append(_split(x.narrow(d, j * w, w), rest, mesh, at))
        pieces.devices.append(None if nested else _device_at(mesh, at))
    return pieces


def _device_at(mesh, coords: dict):
    return mesh.devices[tuple(coords.get(a, 0) for a in mesh.axis_names)]


def constrain(x, spec: P):
    """An activation layout hint: the identity (one process holds every
    activation), outside a mesh context and in it; but in one, a spec
    naming an axis the mesh lacks raises, as the reference's does."""
    mesh = current_mesh()
    if mesh is None:
        return x
    for axis in spec:
        for a in (axis if isinstance(axis, (tuple, list)) else (axis,)):
            if a is not None and a not in mesh.axis_names:
                raise ValueError(f"spec {spec} names axis {a!r}; the mesh "
                                 f"has {mesh.axis_names}")
    return x


def map_placed(fn: Callable, params: RankParams) -> RankParams:
    """``fn(leaf, device)`` over every leaf of a :class:`RankParams` with
    the device that leaf belongs on (a rank's device, or for fsdp piece j
    the piece's). A leaf object that appears under several ranks on one
    device is mapped once and stays shared."""
    tp = len(params)
    memo: dict = {}

    def one(t, device):
        k = (id(t), str(device))
        if k not in memo:
            memo[k] = fn(t, device)
        return memo[k]

    def walk(tree, r):
        if isinstance(tree, Pieces):
            return tree.like(one(p, params.grid[j * tp + r])
                             for j, p in enumerate(tree))
        if isinstance(tree, dict):
            return {k: walk(v, r) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [walk(v, r) for v in tree]
        return one(tree, params.devices[r])

    return params.like(walk(t, r) for r, t in enumerate(params))


def placed_leaves(params: RankParams):
    """``(path, tensor, device)`` of every leaf of a :class:`RankParams`,
    paths prefixed by the rank (``0/layers/0/wq``) and an fsdp piece's
    suffixed by its index."""
    tp = len(params)

    def walk(tree, path, r):
        if isinstance(tree, Pieces):
            for j, p in enumerate(tree):
                yield f"{path}/{j}", p, params.grid[j * tp + r]
        elif isinstance(tree, dict):
            for k, v in tree.items():
                yield from walk(v, f"{path}/{k}", r)
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                yield from walk(v, f"{path}/{i}", r)
        else:
            yield path, tree, params.devices[r]

    for r, t in enumerate(params):
        yield from walk(t, str(r), r)
