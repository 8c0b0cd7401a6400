"""LoRA adapters over the decoder param tree (counterpart of
``tpu9/models/lora.py``; baseline config #5, a gemma-7b LoRA fine-tune).

Adapters live in a tree of their own, shaped like ``{"layers": [{"wq":
{"a": ..., "b": ...}, ...}]}``, f32 tensors only, so the tree is what the
optimizer sees and the base params stay frozen. ``merge`` folds the
deltas into the base weights, in f32 and cast back to each weight's
dtype, as the reference does; under grad the cast passes the gradient
through unchanged, so the train step's gradients reach the adapters
through it (``tpu9_torch.train.build_lora_train_step``).

Over a sharded base (rank shards from ``parallel.shard_params``, or
:class:`~tpu9_torch.parallel.sharding.Pieces` of an fsdp split) each
placed piece of a weight is merged on its own device with its own block of
the delta: rows ``[r0, r1)`` and columns ``[c0, c1)`` of ``W`` take
``a[r0:r1] @ b[:, c0:c1]``. So rank r's ``wq``/``wk``/``wv`` take their
columns of ``W + scale * a @ b``, its ``wo`` its rows, and the merged
tree keeps the base's layout. Sharded adapters (``fsdp_specs``) are
gathered onto each piece's device first.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from ..parallel.sharding import Pieces, RankParams, gather_leaf, to_device

Params = dict[str, Any]

DEFAULT_TARGETS = ("wq", "wk", "wv", "wo")


def init_lora(generator: torch.Generator, params: Params, rank: int = 8,
              targets=DEFAULT_TARGETS) -> Params:
    """For each target weight ``w`` [in, out] of each layer: ``a`` [in,
    rank] ~ N(0, 1) / rank and ``b`` [rank, out] zero, f32, on ``w``'s
    device, ``a`` drawn from ``generator`` (which must live on that
    device). The draws differ from ``jax.random``'s; tests convert a JAX
    adapter tree with ``params_from_jax`` instead."""
    adapters: Params = {"layers": []}
    for layer in params["layers"]:
        entry = {}
        for name in targets:
            if name not in layer:
                continue
            w = layer[name]
            entry[name] = {
                "a": torch.randn((w.shape[0], rank), generator=generator,
                                 dtype=torch.float32, device=w.device) / rank,
                "b": torch.zeros((rank, w.shape[1]), dtype=torch.float32,
                                 device=w.device),
            }
        adapters["layers"].append(entry)
    return adapters


def lora_scale(rank: int, alpha: float = 16.0) -> float:
    return alpha / rank


def merge(params: Params, adapters: Params,
          scale: Optional[float] = None) -> Params:
    """A new param tree with the LoRA deltas ``(a @ b) * scale`` folded
    into the base weights: the f32 sum cast to the weight's dtype.
    ``scale=None`` takes alpha/rank from each adapter's own rank. Leaves
    that no adapter touches are the base tree's own tensors. A sharded
    base is merged piece by piece (see the module docstring)."""
    if isinstance(params, RankParams):
        return params.like(
            _merge_tree(shard, adapters, scale,
                        params.slices[r] if params.slices else {})
            for r, shard in enumerate(params))
    return _merge_tree(params, adapters, scale, {})


def _merge_tree(params: Params, adapters: Params, scale, slices: dict):
    """One tree (a plain tree or one rank's) merged; ``slices`` maps a
    tp-sliced leaf's path to its ``(dim, (lo, hi))``."""
    gathered: dict = {}
    merged_layers = []
    for i, (layer, ad_layer) in enumerate(zip(params["layers"],
                                              adapters["layers"])):
        new_layer = dict(layer)
        for name, ad in ad_layer.items():
            a, b = ad["a"], ad["b"]
            s = scale if scale is not None else lora_scale(_length(a, 1))
            rows, cols = (0, _length(a, 0)), (0, _length(b, 1))
            path = f"layers/{i}/{name}"
            key = slices.get(path) or slices.get(f"{path}/0")
            if key:
                d, rng = key
                rows, cols = (rng, cols) if d == 0 else (rows, rng)
            new_layer[name] = _merged(layer[name], a, b, s, rows, cols,
                                      gathered)
        merged_layers.append(new_layer)
    out = dict(params)
    out["layers"] = merged_layers
    return out


def _merged(w, a, b, s: float, rows: tuple, cols: tuple, gathered: dict):
    """``w`` (a tensor, or :class:`Pieces` covering ``rows`` x ``cols`` of
    the whole weight) plus its block of ``(a @ b) * s``, on each piece's
    device; ``gathered`` keeps each adapter gathered once a device."""
    if isinstance(w, Pieces):
        out, lo = [], (rows if w.dim == 0 else cols)[0]
        for piece in w:
            span = (lo, lo + _length(piece, w.dim))
            lo = span[1]
            out.append(_merged(piece, a, b, s, span, cols, gathered)
                       if w.dim == 0
                       else _merged(piece, a, b, s, rows, span, gathered))
        return w.like(out)
    whole = []
    for leaf in (a, b):
        key = (id(leaf), str(w.device))
        if key not in gathered:
            gathered[key] = to_device(gather_leaf(leaf, w.device), w.device)
        whole.append(gathered[key])
    delta = (whole[0][rows[0]:rows[1]] @ whole[1][:, cols[0]:cols[1]]) * s
    return (w.float() + delta).to(w.dtype)


def _length(leaf, dim: int) -> int:
    """A leaf's whole length along ``dim``, over its pieces."""
    if isinstance(leaf, Pieces):
        if leaf.dim == dim:
            return sum(_length(p, dim) for p in leaf)
        return _length(leaf[0], dim)
    return leaf.shape[dim]


def trainable_count(adapters: Params) -> int:
    """The adapters' parameter count (a sharded leaf's pieces summed)."""
    if isinstance(adapters, dict):
        return sum(trainable_count(v) for v in adapters.values())
    if isinstance(adapters, (list, tuple)):
        return sum(trainable_count(v) for v in adapters)
    return adapters.numel()
