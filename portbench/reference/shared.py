"""What every plain reference shares, whatever the architecture: the maps
from a stored weight to the float32 matrix used (as stored, or rounded to
float8 for the control), float32 products with TF32 off, and the leaf
paths of an adapter tree. It imports nothing of the program."""

from __future__ import annotations

from typing import Callable

import torch

Weight = Callable[[torch.Tensor], torch.Tensor]


def as_f32(w: torch.Tensor) -> torch.Tensor:
    return w.float()


def fp8_weight(w: torch.Tensor) -> torch.Tensor:
    """``w`` rounded to float8 e4m3 with one scale per output column (the
    last axis), back in float32: the control's weights."""
    wf = w.float()
    scale = wf.abs().amax(dim=-2, keepdim=True).clamp_min(1e-12) / 448.0
    return (wf / scale).to(torch.float8_e4m3fn).float() * scale


class f32_products:
    """Float32 products at float32: TF32 off for the reference's matmuls,
    the settings restored on exit."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32,
                      torch.get_float32_matmul_precision())
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        return self

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32, precision) = self.saved
        torch.set_float32_matmul_precision(precision)


def leaves(tree: dict) -> dict:
    """``{"layers/<i>/<name>/<a|b>": tensor}`` of an adapter tree."""
    return {f"layers/{i}/{n}/{p}": ad[n][p]
            for i, ad in enumerate(tree["layers"]) for n in sorted(ad)
            for p in ("a", "b")}
