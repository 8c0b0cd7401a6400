"""The optimizers of the train step, written out with optax's arithmetic
and defaults (counterparts of the two transforms the reference's callers
use, ``optax.adam`` and ``optax.adamw``), and the tree helpers they need.

Functional, as optax is: ``opt.init(params)`` returns the state and
``opt.update(grads, state, params)`` returns ``(updates, state)``, which
:func:`apply_updates` adds to the params; nothing is updated in place.
The moments keep each parameter's dtype, as optax's do by default, and
every product runs in that dtype. ``adamw``'s weight decay defaults to
optax's 1e-4 (``torch.optim.AdamW``'s is 0.01).

A tree is dicts, lists and tuples of tensors; a dict's leaves are taken
in sorted key order, as JAX flattens a dict. A sharded tree
(``parallel.shard_params``) holds rank shards and pieces: a map keeps
their types and attributes, maps a tensor that several places share once
(so a shared replica stays one tensor), and the norm counts each logical
parameter once (:func:`logical_leaves`), as ``optax.global_norm`` over the
logical tree does. Replicas of one value on distinct devices get the sum
of their gradients (:func:`sum_replicas`), so they take the same steps.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from ..parallel.sharding import (RankParams, TreeList, reduce_partials,
                                 replica_groups, to_device)

Params = Any


def tree_leaves(tree: Params) -> list:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree: Params, *rest: Params) -> Params:
    """``fn`` over the leaves of ``tree`` and the matching leaves of each
    tree of ``rest`` (same structure). Rank shards and pieces keep their
    types and attributes; leaves that are the same tensors as at an
    earlier position map to the same result."""
    return _map(fn, {}, tree, *rest)


def _map(fn: Callable, memo: dict, t, *r):
    # module level, not a nested closure: a recursive closure is a
    # reference cycle, which would hold ``memo``'s results (gradients, the
    # optimizer's intermediates) until the cyclic collector runs
    if isinstance(t, dict):
        return {k: _map(fn, memo, v, *(x[k] for x in r)) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        out = [_map(fn, memo, v, *(x[i] for x in r)) for i, v in enumerate(t)]
        if isinstance(t, TreeList):
            return t.like(out)
        return tuple(out) if isinstance(t, tuple) else out
    key = (id(t), *map(id, r))
    if key not in memo:
        memo[key] = fn(t, *r)
    return memo[key]


def logical_leaves(tree: Params) -> list:
    """Each logical parameter of ``tree`` once, in the tree's order: a
    tensor shared by several places once, and of rank shards' replicas of
    one value (on distinct devices, :func:`replica_groups`) the first."""
    seen: set = set()
    return [leaf for leaf in _logical(tree)
            if id(leaf) not in seen and not seen.add(id(leaf))]


def _logical(t):
    if isinstance(t, RankParams):
        yield from (group[0] for group in replica_groups(t))
    elif isinstance(t, dict):
        for k in sorted(t):
            yield from _logical(t[k])
    elif isinstance(t, (list, tuple)):
        for v in t:
            yield from _logical(v)
    else:
        yield t


def sum_replicas(grads: Params) -> Params:
    """``grads`` of rank shards with each group of replicas on distinct
    devices given the sum of the group's gradients, each on its own
    device: the all-reduce a replicated parameter's gradient takes, so
    every replica takes the same step. Other trees are returned as they
    are."""
    if not isinstance(grads, RankParams):
        return grads
    summed: dict = {}
    for group in replica_groups(grads):
        if len(group) > 1:
            total = reduce_partials(group, group[0].device)
            summed.update((id(g), to_device(total, g.device)) for g in group)
    if not summed:
        return grads
    return tree_map(lambda g: summed.get(id(g), g), grads)


class GradientTransformation(NamedTuple):
    init: Callable
    update: Callable


class AdamState(NamedTuple):
    count: torch.Tensor       # int32 scalar on the params' device
    mu: Params
    nu: Params


def _scale_by_adam(b1: float, b2: float, eps: float,
                   eps_root: float) -> GradientTransformation:
    """``optax.scale_by_adam``: the moments' moving averages, the bias
    corrections ``1 - b**count`` in f32, then ``mu_hat / (sqrt(nu_hat +
    eps_root) + eps)``."""

    def init(params):
        device = tree_leaves(params)[0].device
        return AdamState(count=torch.zeros((), dtype=torch.int32,
                                           device=device),
                         mu=tree_map(torch.zeros_like, params),
                         nu=tree_map(torch.zeros_like, params))

    def update(grads, state: AdamState, params=None):
        del params
        mu = tree_map(lambda g, m: (1 - b1) * g + b1 * m, grads, state.mu)
        nu = tree_map(lambda g, v: (1 - b2) * (g * g) + b2 * v, grads,
                      state.nu)
        count = state.count + 1
        c1 = 1 - torch.pow(b1, count)           # f32, as optax takes them
        c2 = 1 - torch.pow(b2, count)
        updates = tree_map(
            lambda m, v: (m / c1.to(m.dtype))
            / (torch.sqrt(v / c2.to(v.dtype) + eps_root) + eps), mu, nu)
        return updates, AdamState(count=count, mu=mu, nu=nu)

    return GradientTransformation(init, update)


def adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8, eps_root: float = 0.0) -> GradientTransformation:
    """``optax.adam``: the Adam direction times ``-learning_rate``."""
    inner = _scale_by_adam(b1, b2, eps, eps_root)

    def update(grads, state, params=None):
        updates, state = inner.update(grads, state, params)
        return tree_map(lambda u: u * -learning_rate, updates), state

    return GradientTransformation(inner.init, update)


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, eps_root: float = 0.0,
          weight_decay: float = 1e-4) -> GradientTransformation:
    """``optax.adamw``: the Adam direction plus ``weight_decay`` times the
    params (decoupled, on the params before the step), times
    ``-learning_rate``."""
    inner = _scale_by_adam(b1, b2, eps, eps_root)

    def update(grads, state, params):
        if params is None:
            raise ValueError("adamw needs the params to decay")
        updates, state = inner.update(grads, state, params)
        updates = tree_map(lambda u, p: (u + weight_decay * p)
                           * -learning_rate, updates, params)
        return updates, state

    return GradientTransformation(inner.init, update)


def apply_updates(params: Params, updates: Params) -> Params:
    """``optax.apply_updates``: ``p + u`` in each param's dtype."""
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def global_norm(tree: Params) -> torch.Tensor:
    """``optax.global_norm``: the square root of the sum, leaf by leaf in
    the tree's order, of each leaf's sum of squares (in its dtype), over
    the logical leaves (:func:`logical_leaves`): a piece's sum on its own
    device, added on the first leaf's."""
    leaves = logical_leaves(tree)
    device = leaves[0].device
    total = sum(to_device(torch.sum(x * x), device) for x in leaves)
    return torch.sqrt(total)
