"""Rotary position embeddings (counterpart of ``tpu9/ops/rotary.py``): a
table computed once per model in f32 and gathered by position."""

from __future__ import annotations

import torch


def rope_table(max_len: int, head_dim: int, theta: float = 10000.0,
               device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (sin, cos), each [max_len, head_dim//2], f32."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                         device=device), exps)
    angles = (torch.arange(max_len, dtype=torch.float32, device=device)[:, None]
              * freqs[None, :])
    return torch.sin(angles), torch.cos(angles)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, sin: torch.Tensor,
               cos: torch.Tensor) -> torch.Tensor:
    """Rotate ``x`` [..., T, H, D] by per-token ``positions`` [..., T], with
    the split-halves convention (x = [x1, x2]; rotate pairs (x1_i, x2_i))."""
    idx = positions.long()
    s = sin[idx].float()[..., None, :]       # [..., T, 1, D/2]
    c = cos[idx].float()[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)
