"""Normalization ops (counterpart of ``tpu9/ops/norms.py`` and of the
encoders' private layer norms, ``tpu9/models/clip_vit.py`` ``_layer_norm``
and ``tpu9/models/classifier.py`` ``_ln``). Both run in f32 whatever the
input dtype and cast back."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5,
             offset: float = 0.0) -> torch.Tensor:
    """``offset=1.0`` gives Gemma-style (1 + w) scaling."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * (offset + weight.float())).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm over the last axis in f32: the mean, the population
    variance (``jnp.var``'s), ``rsqrt(var + eps)``, times the f32 scale,
    plus the f32 bias, cast back to ``x.dtype``."""
    out = F.layer_norm(x.float(), (x.shape[-1],), scale.float(), bias.float(),
                       eps)
    return out.to(x.dtype)
