"""The plain reference of the LoRA fine-tune: the decoder's loss over
merged weights ``W + scale * a @ b`` (targets only, all in float32, no
rounding of the merge), its gradient with respect to the adapters by
autograd, and AdamW as Loshchilov and Hutter define it with decoupled
weight decay (optax's arithmetic: bias-corrected moments, ``eps`` outside
the root, the decay added to the direction before the learning rate).
Each layer is checkpointed so that 4,096 tokens fit in float32. It
imports nothing of the program."""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from .decoder import causal_attention, rms_norm, rotary
from .shared import Weight, as_f32, f32_products, leaves


def _layer(m, layer: dict, x: torch.Tensor, ad: dict, scale: float,
           weight: Weight) -> torch.Tensor:
    def proj(name: str, h: torch.Tensor) -> torch.Tensor:
        w = weight(layer[name])
        if name in ad:
            w = w + scale * (ad[name]["a"] @ ad[name]["b"])
        return h @ w

    b, t, _ = x.shape
    h = rms_norm(x, layer["attn_norm"], m.norm_eps)
    q = proj("wq", h).view(b, t, m.n_heads, m.head_dim)
    k = proj("wk", h).view(b, t, m.n_kv_heads, m.head_dim)
    v = proj("wv", h).view(b, t, m.n_kv_heads, m.head_dim)
    attn = torch.stack([causal_attention(rotary(q[i], m.rope_theta),
                                         rotary(k[i], m.rope_theta), v[i])
                        for i in range(b)])
    x = x + proj("wo", attn)
    h = rms_norm(x, layer["mlp_norm"], m.norm_eps)
    gated = torch.nn.functional.silu(h @ weight(layer["w_gate"])) \
        * (h @ weight(layer["w_up"]))
    return x + gated @ weight(layer["w_down"])


def loss(m, w: dict, adapters: dict, tokens: torch.Tensor, scale: float,
         weight: Weight = as_f32) -> torch.Tensor:
    """Mean next-token cross entropy of ``tokens`` [B, T] in float32."""
    x = w["embed"][tokens.long()].float()
    for layer, ad in zip(w["layers"], adapters["layers"]):
        leaves = [ad[n][p] for n in sorted(ad) for p in ("a", "b")]

        def run(x, *leaves, layer=layer, names=sorted(ad)):
            tree = {n: {"a": leaves[2 * i], "b": leaves[2 * i + 1]}
                    for i, n in enumerate(names)}
            return _layer(m, layer, x, tree, scale, weight)

        x = checkpoint(run, x, *leaves, use_reentrant=False)
    x = rms_norm(x, w["final_norm"], m.norm_eps)
    logits = x[:, :-1] @ weight(w["lm_head"])
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, tokens[:, 1:].long()[..., None]).mean()


def steps(m, w: dict, adapters: dict, batches: list, scale: float,
          lr: float, weight_decay: float, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight: Weight = as_f32) -> dict:
    """AdamW steps from ``adapters`` over ``batches``: each step's loss,
    each leaf's first gradient norm, and each leaf's change after the
    last step, by path."""
    params = {k: v.detach().float().clone() for k, v in
              leaves(adapters).items()}
    start = {k: v.clone() for k, v in params.items()}
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    losses, first_grad, grad_seen = [], {}, {k: 0.0 for k in params}
    with f32_products():
        for n, tokens in enumerate(batches, start=1):
            live = {k: v.clone().requires_grad_(True)
                    for k, v in params.items()}
            tree = {"layers": [{} for _ in w["layers"]]}
            for key, t in live.items():
                _, i, name, part = key.split("/")
                tree["layers"][int(i)].setdefault(name, {})[part] = t
            with torch.enable_grad():
                value = loss(m, w, tree, tokens, scale, weight)
                grads = torch.autograd.grad(value, list(live.values()))
            losses.append(float(value.detach()))
            with torch.no_grad():
                for (key, p), g in zip(params.items(), grads):
                    if n == 1:
                        first_grad[key] = float(g.norm())
                    grad_seen[key] = max(grad_seen[key], float(g.norm()))
                    mu[key] = b1 * mu[key] + (1 - b1) * g
                    nu[key] = b2 * nu[key] + (1 - b2) * g * g
                    mhat = mu[key] / (1 - b1 ** n)
                    vhat = nu[key] / (1 - b2 ** n)
                    update = mhat / (vhat.sqrt() + eps) + weight_decay * p
                    params[key] = p - lr * update
    delta = {k: float((params[k] - start[k]).norm()) for k in params}
    return {"losses": losses, "first_grad": first_grad, "delta": delta,
            "grad_seen": grad_seen}
