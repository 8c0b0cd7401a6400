"""Normalization ops (counterpart of ``tpu9/ops/norms.py``). RMSNorm runs in
f32 whatever the input dtype and casts back."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5,
             offset: float = 0.0) -> torch.Tensor:
    """``offset=1.0`` gives Gemma-style (1 + w) scaling."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * (offset + weight.float())).to(x.dtype)
