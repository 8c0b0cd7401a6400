"""Device selection and environment gates for the port.

Counterpart of ``tpu9/utils/platform.py`` (``device_kind``/``on_tpu``). Entry
points run on the GPU unless the caller names another device: a missing GPU
with no explicit device is an error, never a quiet fall back to the CPU.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def default_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the current CUDA
    device, and raises when there is none."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the "
                           "CPU (the port does not fall back by itself)")
    return torch.device("cuda", torch.cuda.current_device())


def on_cuda(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def device_kind() -> str:
    """The card's name as ``torch.cuda.get_device_name`` gives it, or
    ``"none"`` without a CUDA device."""
    return torch.cuda.get_device_name(0) if torch.cuda.is_available() else "none"


def host_to_device(dst: torch.Tensor, src: np.ndarray) -> None:
    """Write host values into ``dst`` in place without waiting for the
    device: on CUDA the values go through a pinned staging copy and the
    transfer is queued on the current stream behind the work already
    there (the pinned allocator keeps the staging memory until the copy
    has run); on the CPU it is a plain copy."""
    src = torch.from_numpy(np.ascontiguousarray(src))
    if dst.is_cuda:
        dst.copy_(src.pin_memory(), non_blocking=True)
    else:
        dst.copy_(src)


def env_kv_tier_on() -> bool:
    """``TPU9_KV_TIER=0`` master-gates KV tiering off: the engine's host
    tier (the runner's directory extras and the router's prefix directory
    read the same variable). Unset or anything else leaves it armed; it
    still only activates where a host pool is sized. Copy of
    ``tpu9/config.py:env_kv_tier_on``."""
    return os.environ.get("TPU9_KV_TIER", "") != "0"


def env_kv_host_pool_mb(default: int = 0) -> int:
    """``TPU9_KV_HOST_POOL_MB``: host-DRAM KV tier capacity in MB (0 = no
    host tier). Overrides ``EngineConfig.kv_host_pool_mb`` at engine
    construction. Copy of ``tpu9/config.py:env_kv_host_pool_mb``."""
    raw = os.environ.get("TPU9_KV_HOST_POOL_MB", "").strip()
    if not raw:
        return default
    try:
        return max(0, int(raw))
    except ValueError:
        return default
