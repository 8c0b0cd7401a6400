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
in sorted key order, as JAX flattens a dict.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

Params = Any


def tree_leaves(tree: Params) -> list:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree: Params, *rest: Params) -> Params:
    """``fn`` over the leaves of ``tree`` and the matching leaves of each
    tree of ``rest`` (same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        return tuple(out) if isinstance(tree, tuple) else out
    return fn(tree, *rest)


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
    the tree's order, of each leaf's sum of squares (in its dtype)."""
    total = sum(torch.sum(x * x) for x in tree_leaves(tree))
    return torch.sqrt(total)
