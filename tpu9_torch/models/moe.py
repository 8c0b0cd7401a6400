"""Sparse mixture-of-experts FFN (counterpart of ``tpu9/models/moe.py``).

GShard/Switch routing with a static expert capacity: each token picks its
top-k experts in f32, each (token, slot) pair takes the next free position
in its expert's buffer in token-major, slot-minor order (earlier tokens win
capacity), and pairs at or past the capacity are dropped: they add zero,
so the caller's residual stream carries the token through unchanged.

The reference moves tokens with one-hot dispatch and combine einsums. Here
the tokens are scattered into ``[E, C, dim]`` by (expert, position) and the
expert outputs gathered back: each buffer row is a copy of one token, and
each output the sum of its k weighted rows, which is what the einsums
compute. Every shape follows from the static token count, and nothing here
reads a value back to the host, so a decode window that calls this is
captured as a CUDA graph like any other.

Expert sharding: ``moe_param_specs`` puts the expert stacks' leading
axis on a mesh axis (tp on a serving policy) with the router replicated,
and ``moe_ffn(..., rank=(r, n))`` runs rank r's ``E/n`` experts of the
stack it is given. Routing, the capacity and every (token, slot)
position are computed over all experts from the call's total token
count, on every rank alike; a rank dispatches and combines only the pairs
routed to its experts, so the ranks' outputs sum to the unsharded
output. A layer placed on an ``ep`` mesh by ``parallel.shard_params``
(its stacks :class:`~tpu9_torch.parallel.sharding.Pieces` over the
axis's devices) runs every rank's share on its piece's device and sums
the f32 shares on x's device before the one rounding, so it computes
what the unsharded layer computes, with a gradient through the copies.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
import torch.nn.functional as F

from ..ops.quant import maybe_einsum
from ..parallel.sharding import Pieces, to_device

Params = Any


@dataclass(frozen=True)
class MoeConfig:
    dim: int = 512
    hidden_dim: int = 1024
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    act: str = "silu"
    dtype: torch.dtype = torch.bfloat16


def init_moe_layer(cfg: MoeConfig, generator: torch.Generator,
                   device) -> Params:
    """Router f32 ``[dim, E]``; ``w_gate``/``w_up`` ``[E, dim, hidden]`` and
    ``w_down`` ``[E, hidden, dim]`` at ``cfg.dtype``, drawn from
    ``generator`` on ``device``. The router is rounded to ``cfg.dtype`` and
    back, as the reference's init rounds it. On ``"meta"``, with
    ``generator=None``, nothing is drawn."""
    e, d, h = cfg.n_experts, cfg.dim, cfg.hidden_dim

    def dense(shape, fan):
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device)
        return w.mul_((2.0 / sum(fan)) ** 0.5).to(cfg.dtype)

    return {"router": dense((d, e), (d, e)).float(),
            "w_gate": dense((e, d, h), (d, h)),
            "w_up": dense((e, d, h), (d, h)),
            "w_down": dense((e, h, d), (h, d))}


def moe_param_specs(params: Params, axis: str = "ep") -> Params:
    """Partition specs: the router replicated, the expert stacks sharded on
    their leading expert axis over ``axis``; an int8 stack
    (``{q: [E, in, out], scale: [E, 1, out]}``) shards both planes
    there."""
    from ..ops.quant import is_quantized_entry
    from ..parallel.sharding import P

    def stack(leaf):
        spec = P(axis, None, None)
        if is_quantized_entry(leaf):
            return {"q": spec, "scale": spec}
        return spec

    return {
        "router": P(),
        "w_gate": stack(params["w_gate"]),
        "w_up": stack(params["w_up"]),
        "w_down": stack(params["w_down"]),
    }


def _capacity(n_tokens: int, cfg: MoeConfig) -> int:
    """Slots per expert for a call of ``n_tokens`` tokens: static, at least
    8 and a multiple of 8."""
    cap = int(cfg.top_k * n_tokens * cfg.capacity_factor / cfg.n_experts)
    return max(8, -(-cap // 8) * 8)


def _router_logits(xf: torch.Tensor, router: torch.Tensor) -> torch.Tensor:
    """``xf @ router`` to f32 whatever the process's f32 matmul precision
    (TF32 on the card, bf16 on some CPUs at "medium"): the product is taken
    in f64, which no such setting reaches, and rounded to f32, so no
    global setting flips an expert at a near tie."""
    return (xf.double() @ router.double()).float()


def _top_k(probs: torch.Tensor, k: int):
    """The k largest entries of each row and their indices, ties to the
    lower index as ``jax.lax.top_k`` gives them (``torch.topk`` does not):
    a stable descending sort, which a CUDA graph captures."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def moe_ffn(params: Params, x: torch.Tensor, cfg: MoeConfig,
            rank: tuple[int, int] = (0, 1)):
    """x ``[B, T, dim]`` → (``[B, T, dim]`` in x's dtype, aux). ``aux``
    carries ``balance_loss`` (Switch §2.2: ``E · Σ_e f_e · p_e`` over the
    top-1 choices), ``dropped_frac`` (the share of (token, slot) pairs
    past capacity) and ``expert_load`` (``f_e``). The capacity comes from
    ``B·T``, so a token's output depends on the call's shape and on the
    tokens before it, as in the reference.

    ``rank=(r, n)``: ``params`` holds experts ``[r·E/n, (r+1)·E/n)`` of
    the ``cfg.n_experts``, and the output is their share of the FFN (the
    n ranks' outputs sum to the whole); aux is every rank's alike. Expert
    stacks held as :class:`Pieces` (an ``ep`` mesh) run as those ranks,
    each on its piece's device."""
    b, t, d = x.shape
    if isinstance(_plane(params["w_gate"]), Pieces):
        out, aux = _ep_shares(params, x, cfg)
    else:
        out, aux = _share(params, x, cfg, rank)
    return out.to(cfg.dtype).reshape(b, t, d).to(x.dtype), aux


def _plane(leaf):
    return leaf["q"] if isinstance(leaf, dict) else leaf


def _piece(leaf, r: int):
    if isinstance(leaf, dict):
        return {k: _piece(v, r) for k, v in leaf.items()}
    return leaf[r]


def _ep_shares(params: Params, x: torch.Tensor, cfg: MoeConfig):
    """The f32 sum, on x's device, of each ``ep`` rank's share computed on
    its piece's device, and rank 0's aux. Each token's slots add in f32
    with exact zeros from the ranks that do not hold them, so the sum is
    the unsharded combine's."""
    stacks = _plane(params["w_gate"])
    n = len(stacks)
    shares, aux = [], None
    for r, dev in enumerate(stacks.devices):
        local = {"router": to_device(params["router"], dev),
                 **{k: _piece(params[k], r)
                    for k in ("w_gate", "w_up", "w_down")}}
        share, rank_aux = _share(local, to_device(x, dev), cfg, (r, n))
        shares.append(to_device(share, x.device))
        aux = aux or rank_aux
    return torch.stack(shares).sum(dim=0), aux


def _share(params: Params, x: torch.Tensor, cfg: MoeConfig,
           rank: tuple[int, int]):
    """Rank ``rank``'s share of the FFN as f32 ``[B*T, dim]`` (before the
    one rounding to ``cfg.dtype``), and aux."""
    b, t, d = x.shape
    n = b * t
    e, k = cfg.n_experts, cfg.top_k
    r, n_ranks = rank
    e_loc = e // n_ranks
    c = _capacity(n, cfg)
    xf = x.reshape(n, d)

    # -- routing, in f32 -----------------------------------------------------
    probs = torch.softmax(_router_logits(xf, params["router"]), dim=-1)
    gate_vals, gate_idx = _top_k(probs, k)                        # [N, k]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

    # position of each (token, slot) in its expert's buffer: the running
    # count of earlier claims on that expert, token-major, slot-minor
    flat = F.one_hot(gate_idx.reshape(n * k), e)                  # [N*k, E]
    pos = (flat.cumsum(0) - flat).gather(1, gate_idx.reshape(n * k, 1))
    pos = pos.reshape(n, k)
    in_cap = pos < c
    keep, local = in_cap, gate_idx
    if n_ranks > 1:
        # this rank's experts only; the other pairs are other ranks' work
        keep = in_cap & (gate_idx // e_loc == r)
        local = gate_idx - r * e_loc
    # row of each pair in the flattened [E*C] buffers; dropped pairs go to
    # one extra row past the end, which is cut off and reads back as zero
    dest = torch.where(keep, local * c + pos,
                       torch.full_like(pos, e_loc * c)).reshape(n * k)

    # -- dispatch, expert compute, combine ------------------------------------
    xk = xf.to(cfg.dtype).repeat_interleave(k, dim=0)             # [N*k, d]
    xe = xf.new_zeros((e_loc * c + 1, d), dtype=cfg.dtype).index_put(
        (dest,), xk)[:e_loc * c].reshape(e_loc, c, d)
    h = maybe_einsum("ecd,edh->ech", xe, params["w_gate"])
    h = F.silu(h) if cfg.act == "silu" else F.gelu(h, approximate="tanh")
    h = h * maybe_einsum("ecd,edh->ech", xe, params["w_up"])
    ye = maybe_einsum("ech,ehd->ecd", h, params["w_down"])        # [E, C, d]
    rows = torch.cat([ye.reshape(e_loc * c, d), ye.new_zeros((1, d))])[dest]
    # the gates are rounded to cfg.dtype before the combine, as the
    # reference casts its combine tensor; the k products then sum in f32
    # and round once
    gates = (gate_vals * keep).to(cfg.dtype).float()
    out = (gates.reshape(n, k, 1) * rows.reshape(n, k, d).float()).sum(1)

    # -- aux: load balance and router stats ------------------------------------
    # means as XLA takes them, the sum times the reciprocal of the count
    frac_tokens = F.one_hot(gate_idx[:, 0], e).float().sum(0) * (1.0 / n)
    balance_loss = e * (frac_tokens * probs.sum(0) * (1.0 / n)).sum()
    aux = {"balance_loss": balance_loss,
           "dropped_frac": 1.0 - in_cap.float().sum() * (1.0 / (n * k)),
           "expert_load": frac_tokens}
    return out, aux
