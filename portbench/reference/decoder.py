"""The plain reference of the served models: a Mistral/Mixtral decoder's
no-cache forward in float32, written from the published architecture
(RMSNorm, rotary embeddings on split halves, grouped-query causal
attention, SiLU-gated FFN or top-k softmax-routed experts, untied head)
with plain torch operations, one layer at a time. It imports nothing of
the program: it reads only the weights the benchmark drew.

Its departures from the published model: none in the mathematics; the
experts compute every token routed to them (no capacity), as published
Mixtral does."""

from __future__ import annotations

import math
from typing import Optional

import torch

from .shared import Weight, as_f32, f32_products


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w.float()


def rotary(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [T, H, D] rotated at positions 0..T-1: pairs (i, i + D/2) turned
    by position / theta^(2i/D)."""
    t, _, d = x.shape
    half = d // 2
    inv = 1.0 / theta ** (torch.arange(half, dtype=torch.float64,
                                       device=x.device) * 2 / d)
    ang = torch.arange(t, dtype=torch.float64, device=x.device)[:, None] * inv
    cos = ang.cos().float()[:, None, :]
    sin = ang.sin().float()[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q, k, v, rows: int = 512) -> torch.Tensor:
    """q [T, QH, D], k/v [T, KH, D] → [T, QH*D]: softmax(q k^T / sqrt(D))
    v over each query's prefix, q head h reading kv head h // (QH/KH), in
    blocks of ``rows`` queries."""
    t, qh, d = q.shape
    group = qh // k.shape[1]
    k = k.repeat_interleave(group, dim=1).transpose(0, 1)     # [QH, T, D]
    v = v.repeat_interleave(group, dim=1).transpose(0, 1)
    blocks = []
    for r0 in range(0, t, rows):
        r1 = min(t, r0 + rows)
        qb = q[r0:r1].transpose(0, 1)                         # [QH, R, D]
        s = qb @ k[:, :r1].transpose(1, 2) / math.sqrt(d)     # [QH, R, r1]
        pos = torch.arange(r0, r1, device=q.device)[:, None]
        s = s.masked_fill(torch.arange(r1, device=q.device)[None] > pos,
                          float("-inf"))
        blocks.append((torch.softmax(s, dim=-1) @ v[:, :r1]).transpose(0, 1))
    out = torch.cat(blocks)
    return out.reshape(t, qh * d)


def experts_ffn(moe: dict, h: torch.Tensor, top_k: int,
                weight: Weight) -> torch.Tensor:
    """Each token's top-k experts by its softmax router probabilities,
    renormalised over the k, each expert's SiLU-gated FFN on the tokens
    routed to it, weighted and summed."""
    probs = torch.softmax(h @ moe["router"].float(), dim=-1)
    gates, idx = probs.topk(top_k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True)
    out = torch.zeros_like(h)
    for e in range(moe["router"].shape[1]):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        x = h[tok]
        y = (torch.nn.functional.silu(x @ weight(moe["w_gate"][e]))
             * (x @ weight(moe["w_up"][e]))) @ weight(moe["w_down"][e])
        out.index_add_(0, tok, y * gates[tok, slot][:, None])
    return out


def forward_logits(m, w: dict, tokens: list, weight: Weight = as_f32,
                   positions: Optional[slice] = None) -> torch.Tensor:
    """f32 logits [T, V] of ``tokens`` (or of the rows ``positions``
    selects) under the model ``m`` (``arch.decoder.Model``) with weights
    ``w``; ``weight`` maps each stored matrix to the f32 matrix used
    (``shared.fp8_weight`` for the control)."""
    dev = w["embed"].device
    ids = torch.as_tensor(tokens, dtype=torch.long, device=dev)
    x = w["embed"][ids].float()
    t = x.shape[0]
    with f32_products():
        for layer in w["layers"]:
            h = rms_norm(x, layer["attn_norm"], m.norm_eps)
            q = (h @ weight(layer["wq"])).view(t, m.n_heads, m.head_dim)
            k = (h @ weight(layer["wk"])).view(t, m.n_kv_heads, m.head_dim)
            v = (h @ weight(layer["wv"])).view(t, m.n_kv_heads, m.head_dim)
            attn = causal_attention(rotary(q, m.rope_theta),
                                    rotary(k, m.rope_theta), v)
            x = x + attn @ weight(layer["wo"])
            h = rms_norm(x, layer["mlp_norm"], m.norm_eps)
            if "moe" in layer:
                x = x + experts_ffn(layer["moe"], h, m.top_k, weight)
            else:
                x = x + (torch.nn.functional.silu(h @ weight(layer["w_gate"]))
                         * (h @ weight(layer["w_up"]))) \
                    @ weight(layer["w_down"])
        x = rms_norm(x, w["final_norm"], m.norm_eps)
        if positions is not None:
            x = x[positions]
        return x @ weight(w["lm_head"])
