"""LoRA adapters over the decoder param tree (counterpart of
``tpu9/models/lora.py``; baseline config #5, a gemma-7b LoRA fine-tune).

Adapters live in a tree of their own, shaped like ``{"layers": [{"wq":
{"a": ..., "b": ...}, ...}]}``, f32 tensors only, so the tree is what the
optimizer sees and the base params stay frozen. ``merge`` folds the
deltas into the base weights, in f32 and cast back to each weight's
dtype, as the reference does; under grad the cast passes the gradient
through unchanged, so the train step's gradients reach the adapters
through it (``tpu9_torch.train.build_lora_train_step``).
"""

from __future__ import annotations

from typing import Any, Optional

import torch

Params = dict[str, Any]

DEFAULT_TARGETS = ("wq", "wk", "wv", "wo")


def init_lora(generator: torch.Generator, params: Params, rank: int = 8,
              targets=DEFAULT_TARGETS) -> Params:
    """For each target weight ``w`` [in, out] of each layer: ``a`` [in,
    rank] ~ N(0, 1) / rank and ``b`` [rank, out] zero, f32, on ``w``'s
    device, ``a`` drawn from ``generator`` (which must live on that
    device). The draws differ from ``jax.random``'s; tests convert a JAX
    adapter tree with ``params_from_jax`` instead."""
    adapters: Params = {"layers": []}
    for layer in params["layers"]:
        entry = {}
        for name in targets:
            if name not in layer:
                continue
            w = layer[name]
            entry[name] = {
                "a": torch.randn((w.shape[0], rank), generator=generator,
                                 dtype=torch.float32, device=w.device) / rank,
                "b": torch.zeros((rank, w.shape[1]), dtype=torch.float32,
                                 device=w.device),
            }
        adapters["layers"].append(entry)
    return adapters


def lora_scale(rank: int, alpha: float = 16.0) -> float:
    return alpha / rank


def merge(params: Params, adapters: Params,
          scale: Optional[float] = None) -> Params:
    """A new param tree with the LoRA deltas ``(a @ b) * scale`` folded
    into the base weights: the f32 sum cast to the weight's dtype.
    ``scale=None`` takes alpha/rank from each adapter's own rank. Leaves
    that no adapter touches are the base tree's own tensors."""
    merged_layers = []
    for layer, ad_layer in zip(params["layers"], adapters["layers"]):
        new_layer = dict(layer)
        for name, ad in ad_layer.items():
            s = scale if scale is not None else lora_scale(ad["a"].shape[1])
            delta = (ad["a"] @ ad["b"]) * s
            new_layer[name] = (layer[name].float() + delta).to(
                layer[name].dtype)
        merged_layers.append(new_layer)
    out = dict(params)
    out["layers"] = merged_layers
    return out


def trainable_count(adapters: Params) -> int:
    if isinstance(adapters, dict):
        return sum(trainable_count(v) for v in adapters.values())
    if isinstance(adapters, (list, tuple)):
        return sum(trainable_count(v) for v in adapters)
    return adapters.numel()
