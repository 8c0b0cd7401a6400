"""Small bidirectional text classifier (counterpart of
``tpu9/models/classifier.py``): the distilbert-class sentiment endpoint
(``examples/01_cpu_classifier.py``). A post-norm encoder, a masked mean
pool and a linear head without bias, all in f32 by default.

Params are a plain dict with the JAX package's paths and layouts; a JAX
tree converts with :func:`tpu9_torch.bridge.params_from_jax`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
import torch.nn.functional as F

from ..ops.attention import encoder_attention
from ..ops.norms import layer_norm
from ..utils.platform import default_device
from .transformer import _dense_init

Params = dict[str, Any]


@dataclass(frozen=True)
class TextClassifierConfig:
    vocab_size: int = 30522
    dim: int = 768
    n_layers: int = 6
    n_heads: int = 12
    hidden_dim: int = 3072
    max_len: int = 512
    n_classes: int = 2
    norm_eps: float = 1e-12
    dtype: torch.dtype = torch.float32


TEXTCLS_TINY = TextClassifierConfig(vocab_size=1024, dim=64, n_layers=2,
                                    n_heads=4, hidden_dim=128, max_len=128)


def init_classifier(cfg: TextClassifierConfig, generator: torch.Generator,
                    device=None) -> Params:
    """Random params drawn from ``generator`` (which must live on the
    device) on ``default_device(device)``, with the reference's paths,
    shapes and dtypes (the norms in f32). The draws differ from
    ``jax.random``; tests convert JAX params instead. On
    ``"meta"``, with ``generator=None``, nothing is drawn: the tree of
    shapes and dtypes."""
    device = default_device(device)
    dt = cfg.dtype

    def table(rows: int) -> torch.Tensor:
        return torch.randn((rows, cfg.dim), generator=generator,
                           dtype=torch.float32, device=device
                           ).mul_(0.02).to(dt)

    def ones() -> torch.Tensor:
        return torch.ones((cfg.dim,), dtype=torch.float32, device=device)

    def zeros() -> torch.Tensor:
        return torch.zeros((cfg.dim,), dtype=torch.float32, device=device)

    params: Params = {
        "embed": table(cfg.vocab_size),
        "pos_embed": table(cfg.max_len),
        "head": _dense_init(generator, cfg.dim, cfg.n_classes, dt, device),
        "layers": [],
    }
    for _ in range(cfg.n_layers):
        params["layers"].append({
            "wqkv": _dense_init(generator, cfg.dim, 3 * cfg.dim, dt, device),
            "wo": _dense_init(generator, cfg.dim, cfg.dim, dt, device),
            "w1": _dense_init(generator, cfg.dim, cfg.hidden_dim, dt, device),
            "w2": _dense_init(generator, cfg.hidden_dim, cfg.dim, dt, device),
            "ln1_scale": ones(), "ln1_bias": zeros(),
            "ln2_scale": ones(), "ln2_bias": zeros(),
        })
    return params


def clamp_ids(tokens: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """The rows a JAX gather reads for ``tokens``: a negative id counts
    from the end, then every id is clamped into the table. Torch indexing
    would raise on the CPU and trip a device assert on the card instead."""
    tokens = torch.where(tokens < 0, tokens + vocab_size, tokens)
    return tokens.clamp(0, vocab_size - 1)


def classifier_forward(params: Params, tokens: torch.Tensor,
                       mask: torch.Tensor, cfg: TextClassifierConfig
                       ) -> torch.Tensor:
    """tokens [B, T] int, mask [B, T] {0, 1} → logits [B, n_classes] f32,
    on the params' device. Masked positions are never attended; a row with
    no position unmasked attends to all uniformly and pools to zero."""
    device = params["embed"].device
    tokens = torch.as_tensor(tokens).to(device=device, dtype=torch.long)
    mask = torch.as_tensor(mask).to(device=device)
    b, t = tokens.shape
    head_dim = cfg.dim // cfg.n_heads
    x = (params["embed"][clamp_ids(tokens, params["embed"].shape[0])]
         + params["pos_embed"][None, :t])

    for layer in params["layers"]:
        qkv = (x @ layer["wqkv"]).reshape(b, t, 3, cfg.n_heads, head_dim)
        attn = encoder_attention(*qkv.unbind(2), key_mask=mask)
        x = layer_norm(x + attn.reshape(b, t, cfg.dim) @ layer["wo"],
                       layer["ln1_scale"], layer["ln1_bias"], cfg.norm_eps)
        h = F.gelu(x @ layer["w1"], approximate="tanh") @ layer["w2"]
        x = layer_norm(x + h, layer["ln2_scale"], layer["ln2_bias"],
                       cfg.norm_eps)

    denom = mask.sum(dim=1, keepdim=True).clamp_min(1)
    pooled = (x * mask[..., None]).sum(dim=1) / denom
    return (pooled @ params["head"]).float()
