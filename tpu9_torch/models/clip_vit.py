"""CLIP vision transformer (counterpart of ``tpu9/models/clip_vit.py``):
the ViT-L/14 image embedder of the task-queue fan-out deployment
(``examples/03_clip_fanout.py``).

Encoder only: the patch embedding as a reshaped matmul, a pre-norm
transformer, the final layer norm of the class token and its projection to
the shared embedding space, L2-normalised. Params are a plain dict with the
JAX package's paths and layouts (every projection stored [in, out]); a JAX
tree converts with :func:`tpu9_torch.bridge.params_from_jax`. The products
and residual adds run in ``cfg.dtype``; attention, as in the reference, is a
plain f32 product with f32 probabilities, not a kernel.
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
class ClipVisionConfig:
    image_size: int = 224
    patch_size: int = 14
    dim: int = 1024
    n_layers: int = 24
    n_heads: int = 16
    hidden_dim: int = 4096
    embed_dim: int = 768           # output projection dim
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads


CLIP_VIT_L14 = ClipVisionConfig()
CLIP_VIT_TINY = ClipVisionConfig(image_size=28, patch_size=14, dim=64,
                                 n_layers=2, n_heads=4, hidden_dim=128,
                                 embed_dim=32)


def init_clip_vision(cfg: ClipVisionConfig, generator: torch.Generator,
                     device=None) -> Params:
    """Random params drawn from ``generator`` (which must live on the
    device) on ``default_device(device)``: the reference's paths, shapes
    and dtypes, the norms in f32 and the class token zero. The draws differ
    from ``jax.random``; tests convert JAX params instead. On
    ``"meta"``, with ``generator=None``, nothing is drawn: the tree of
    shapes and dtypes."""
    device = default_device(device)
    dt = cfg.dtype
    patch_dim = 3 * cfg.patch_size * cfg.patch_size

    def norm():
        return {"scale": torch.ones((cfg.dim,), dtype=torch.float32,
                                    device=device),
                "bias": torch.zeros((cfg.dim,), dtype=torch.float32,
                                    device=device)}

    params: Params = {
        "patch_proj": _dense_init(generator, patch_dim, cfg.dim, dt, device),
        "cls_token": torch.zeros((1, 1, cfg.dim), dtype=dt, device=device),
        "pos_embed": torch.randn(
            (cfg.n_patches + 1, cfg.dim), generator=generator,
            dtype=torch.float32, device=device).mul_(0.02).to(dt),
        "ln_pre": norm(),
        "ln_post": norm(),
        "proj": _dense_init(generator, cfg.dim, cfg.embed_dim, dt, device),
        "layers": [],
    }
    for _ in range(cfg.n_layers):
        params["layers"].append({
            "ln1": norm(), "ln2": norm(),
            "wqkv": _dense_init(generator, cfg.dim, 3 * cfg.dim, dt, device),
            "wo": _dense_init(generator, cfg.dim, cfg.dim, dt, device),
            "w1": _dense_init(generator, cfg.dim, cfg.hidden_dim, dt, device),
            "w2": _dense_init(generator, cfg.hidden_dim, cfg.dim, dt, device),
        })
    return params


def patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, H, W, 3] -> [B, n_patches, patch*patch*3] (row-major patches,
    each patch's values in (row, column, channel) order)."""
    b, h, w, c = images.shape
    gh, gw = h // patch, w // patch
    x = images.reshape(b, gh, patch, gw, patch, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, gh * gw, patch * patch * c)


def clip_vision_forward(params: Params, images: torch.Tensor,
                        cfg: ClipVisionConfig) -> torch.Tensor:
    """images [B, H, W, 3] (f32 0..1) → L2-normalised embeddings
    [B, embed_dim] f32, on the params' device."""
    device = params["patch_proj"].device
    images = torch.as_tensor(images).to(device=device, dtype=torch.float32)
    b = images.shape[0]
    x = patchify(images, cfg.patch_size).to(cfg.dtype)
    x = x @ params["patch_proj"]
    cls = params["cls_token"].expand(b, 1, cfg.dim)
    x = torch.cat([cls, x], dim=1) + params["pos_embed"][None]
    x = _ln(x, params["ln_pre"], cfg.norm_eps)

    for layer in params["layers"]:
        h = _ln(x, layer["ln1"], cfg.norm_eps)
        qkv = (h @ layer["wqkv"]).reshape(b, -1, 3, cfg.n_heads, cfg.head_dim)
        attn = encoder_attention(*qkv.unbind(2)).reshape(b, -1, cfg.dim)
        x = x + attn @ layer["wo"]
        h = _ln(x, layer["ln2"], cfg.norm_eps)
        x = x + F.gelu(h @ layer["w1"], approximate="tanh") @ layer["w2"]

    cls_out = _ln(x[:, 0], params["ln_post"], cfg.norm_eps)
    # the projection rounds to cfg.dtype before the f32 norm, as the
    # reference's does
    emb = (cls_out @ params["proj"]).float()
    return emb / emb.norm(dim=-1, keepdim=True).clamp_min(1e-6)


def _ln(x: torch.Tensor, p: Params, eps: float) -> torch.Tensor:
    return layer_norm(x, p["scale"], p["bias"], eps)

