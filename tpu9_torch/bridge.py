"""Parity bridge: a param tree in the JAX package's layout (numpy arrays, or
anything ``np.asarray`` accepts) to the port's torch tree with the same
paths. The port imports no JAX, so bf16 is recognised by its dtype name and
moved as raw 16-bit words. An int8 ``{q, scale}`` entry is a dict like any
other: its int8 values and f32 scales move bit for bit."""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def _leaf(arr, device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        words = np.ascontiguousarray(arr).view(np.uint16)
        return torch.from_numpy(words.copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(arr).copy()).to(device)


def params_from_jax(tree: Any, device) -> Any:
    """Convert dicts, lists and array leaves; the paths stay the same."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v, device) for v in tree]
    return _leaf(tree, device)
