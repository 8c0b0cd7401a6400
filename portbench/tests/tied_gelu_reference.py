"""The plain reference of the test-only architecture ``tied_gelu_arch``:
the decoder of ``reference/decoder.py`` with a GELU-gated FFN (the tanh
approximation) and the output head tied to the embedding, in float32 with
plain torch operations, one layer at a time. It imports nothing of the
program."""

from __future__ import annotations

from typing import Optional

import torch

from portbench.reference.decoder import causal_attention, rms_norm, rotary
from portbench.reference.shared import Weight, as_f32, f32_products


def forward_logits(m, w: dict, tokens: list, weight: Weight = as_f32,
                   positions: Optional[slice] = None) -> torch.Tensor:
    """f32 logits [T, V] of ``tokens`` (or of the rows ``positions``
    selects); the head is the embedding's transpose."""
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
            gate = torch.nn.functional.gelu(h @ weight(layer["w_gate"]),
                                            approximate="tanh")
            x = x + (gate * (h @ weight(layer["w_up"]))) \
                @ weight(layer["w_down"])
        x = rms_norm(x, w["final_norm"], m.norm_eps)
        if positions is not None:
            x = x[positions]
        return x @ weight(w["embed"].t())
