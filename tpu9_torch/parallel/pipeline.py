"""Pipeline parallelism of the port (counterpart of
``tpu9/parallel/pipeline.py``): a GPipe microbatch schedule over a ``pp``
mesh axis.

Layers are stacked (a leading layer dimension, :func:`stack_layers`) and
split over the ``pp`` stages, so stage s owns a contiguous block of
layers on the axis's device s. The batch is cut into M microbatches and
the schedule runs ``M + S - 1`` steps over S stages: at step t stage s runs
microbatch t - s through its layers and its output is copied to stage s +
1's device (the reference's ``ppermute``). A stage with no microbatch at a
step (the bubble, ``(S-1)/(M+S-1)`` of the steps) computes nothing here:
the reference computes and masks it, which changes no number. One process
drives the stages in turn; autograd runs back through the copies, the
backward pipeline.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from .sharding import P, Pieces, map_tree, to_device

Params = Any


def stack_layers(layers: list) -> Params:
    """``[{w: [..]}, ...]`` to ``{w: [L, ..]}``, the pp-shardable layout."""
    return map_tree(lambda *xs: torch.stack(xs), layers[0], *layers[1:])


def stage_specs(stacked: Params, axis: str = "pp") -> Params:
    """The stacked layer dimension split over the pipeline axis."""
    return map_tree(lambda x: P(axis, *([None] * (x.ndim - 1))), stacked)


def _stage(leaf, s: int, n_stages: int, device):
    """Stage s's block of a stacked leaf on ``device``: piece s of
    :class:`Pieces` split on the layer dimension, or a slice of a whole
    tensor."""
    if isinstance(leaf, Pieces):
        if len(leaf) != n_stages or leaf.dim != 0:
            raise ValueError(f"{len(leaf)} pieces on dim {leaf.dim}; the "
                             f"pipeline needs {n_stages} on dim 0")
        return to_device(leaf[s], device)
    per = leaf.shape[0] // n_stages
    return to_device(leaf[s * per:(s + 1) * per], device)


def pipeline_forward(block_fn: Callable[[Params, torch.Tensor], torch.Tensor],
                     stacked_params: Params, x: torch.Tensor, mesh,
                     axis: str = "pp",
                     n_microbatches: int = 0) -> torch.Tensor:
    """Run ``block_fn(layer, act)`` over every layer with the layer
    dimension pipelined over ``axis``.

    ``stacked_params``: a tree with a leading layer dimension L
    (:func:`stack_layers`), L divisible by the axis size; whole, or split
    by ``shard_params(..., stage_specs(...))``. ``x``: ``[B, ...]``, cut
    into ``n_microbatches`` (default: the number of stages) along B;
    ``block_fn`` sees ``[B/M, ...]``, so anything it computes from its
    batch (a MoE layer's capacity) follows the microbatch, as in the
    reference. Returns ``[B, ...]`` on the mesh's first device,
    differentiable end to end."""
    devices = mesh.sub_devices((axis,))
    s = len(devices)
    m = n_microbatches or s
    b = x.shape[0]
    if b % m:
        raise ValueError(f"batch {b} not divisible into {m} microbatches")
    stages = [map_tree(lambda leaf, i=i: _stage(leaf, i, s, devices[i]),
                       stacked_params) for i in range(s)]
    n_layers = len(next(iter(_leaves(stages[0]))))

    def run_stage(i: int, act: torch.Tensor) -> torch.Tensor:
        for layer in range(n_layers):
            act = block_fn(map_tree(lambda t: t[layer], stages[i]), act)
        return act

    micro = x.chunk(m, dim=0)
    held = [None] * s                    # the activation each stage holds
    outs = [None] * m
    for t in range(m + s - 1):
        # the last stage first, so each stage reads what its predecessor
        # produced at the previous step
        for i in reversed(range(s)):
            mb = t - i
            if not 0 <= mb < m:
                continue                 # the bubble
            act = to_device(micro[mb], devices[0]) if i == 0 else held[i]
            y = run_stage(i, act)
            if i == s - 1:
                outs[mb] = to_device(y, devices[0])
            else:
                held[i + 1] = to_device(y, devices[i + 1])
    return torch.cat(outs, dim=0)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree
