"""Attention (counterpart of ``tpu9/ops/attention.py``): the plain paths
as PyTorch (logits, mask and softmax in f32, as the JAX code does), the
dispatch to the hand-written CUDA kernels, and the wrapper of the flash
kernel ``tpu9_torch/csrc/flash_attention.cu``.

``attention`` and ``decode_attention`` dispatch under exactly the JAX
conditions (``uses_flash``, ``uses_ragged``): block-aligned shapes go to the
flash kernel and long aligned caches to the ragged decode kernel, everything
else to the plain path, as the JAX package does. Each kernel wrapper
launches its kernel on a CUDA tensor (or raises for operands it cannot
take) and computes its plain twin on a CPU tensor.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

NEG_INF = -1e30
FLASH_HEAD_DIMS = (64, 128, 256)
FLASH_TILE = 64               # T and S are multiples of this: the kernel's 128-row
                              # tiles zero-fill a 64-row tail


def _expand_gqa(k: torch.Tensor, q_heads: int) -> torch.Tensor:
    """[B, S, KH, D] -> [B, S, QH, D] by repeating kv heads."""
    kv_heads = k.shape[2]
    if kv_heads == q_heads:
        return k
    return k.repeat_interleave(q_heads // kv_heads, dim=2)


def _softmax_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """q [B,T,QH,D], k/v [B,S,KH,D], mask broadcastable to [B,H,T,S]."""
    q_heads = q.shape[2]
    k = _expand_gqa(k, q_heads)
    v = _expand_gqa(v, q_heads)
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bthd,bshd->bhts", q.float() * scale, k.float())
    logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhts,bshd->bthd", probs, v.float())
    return out.to(q.dtype)


def xla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, kv_offset: int = 0) -> torch.Tensor:
    """Plain attention. q: [B, T, QH, D], k/v: [B, S, KH, D]. ``kv_offset``
    places the q tokens at that offset within the kv sequence. The flash
    kernel's twin (at ``kv_offset=0``)."""
    t, s = q.shape[1], k.shape[1]
    if causal:
        q_pos = torch.arange(t, device=q.device)[:, None] + kv_offset
        k_pos = torch.arange(s, device=q.device)[None, :]
        mask = (k_pos <= q_pos)[None, None]
    else:
        mask = torch.ones((1, 1, t, s), dtype=torch.bool, device=q.device)
    return _softmax_attend(q, k, v, mask)


def uses_flash(t: int, s: int, head_dim: int, kv_offset: int) -> bool:
    """The JAX ``attention`` condition for its flash kernel
    (``tpu9/ops/attention.py:179-180``), device aside."""
    return (kv_offset == 0 and t % 128 == 0 and s % 128 == 0
            and head_dim in (64, 128, 256))


def uses_ragged(s_max: int, head_dim: int) -> bool:
    """The JAX ``decode_attention`` condition for its ragged decode kernel
    (``tpu9/ops/attention.py:199-200``), device aside."""
    return s_max >= 512 and s_max % 256 == 0 and head_dim in (64, 128, 256)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, kv_offset: int = 0) -> torch.Tensor:
    """Dispatch as the JAX ``attention``: block-aligned shapes go to the
    flash kernel (its twin on a CPU tensor), everything else to the plain
    path."""
    if uses_flash(q.shape[1], k.shape[1], q.shape[-1], kv_offset):
        return flash_attention(q, k, v, causal=causal)
    return xla_attention(q, k, v, causal=causal, kv_offset=kv_offset)


def flash_kernel_supports(q: torch.Tensor, k: torch.Tensor) -> str:
    """Empty when the flash kernel takes these shapes and types, else why
    not."""
    _, t, q_heads, head_dim = q.shape
    s, kv_heads = k.shape[1], k.shape[2]
    if q.dtype != torch.bfloat16 or k.dtype != torch.bfloat16:
        return f"bf16 q and k/v, got {q.dtype} and {k.dtype}"
    if head_dim not in FLASH_HEAD_DIMS:
        return f"head_dim in {FLASH_HEAD_DIMS}, got {head_dim}"
    if kv_heads == 0 or q_heads % kv_heads:
        return f"kv heads dividing the q heads, got {q_heads}/{kv_heads}"
    if t == 0 or s == 0 or t % FLASH_TILE or s % FLASH_TILE:
        return (f"sequence lengths that are non-zero multiples of "
                f"{FLASH_TILE}, got T={t} S={s}")
    return ""


def _launch_flash(q, k, v, causal: bool) -> torch.Tensor:
    why = flash_kernel_supports(q, k)
    if why:
        raise ValueError(f"flash_attention kernel needs {why}")
    batch, t, q_heads, head_dim = q.shape
    if k.shape != v.shape or v.dtype != k.dtype or k.shape[0] != batch \
            or k.shape[3] != head_dim:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    from .paged_attention import check_launch_layout
    check_launch_layout((q, k, v))
    out = torch.empty_like(q)
    rc = _flash_fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     batch, t, k.shape[1], q_heads, k.shape[2], head_dim,
                     int(causal), head_dim ** -0.5,
                     torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed: cudaError {rc}")
    return out


@functools.cache
def _flash_fn():
    from ._build import load
    fn = load("flash_attention").tpu9_flash_attention_bf16
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Blocked online-softmax attention. q [B,T,QH,D]; k/v [B,S,KH,D] with
    KH | QH; ``causal`` masks k_pos > q_pos (no offset). Returns
    [B,T,QH,D] in q's dtype.

    A CUDA ``q`` launches the kernel (``flash_attention.launches`` counts
    each launch) or raises if the kernel cannot take the operands; a CPU
    ``q`` computes the plain twin ``xla_attention``."""
    if q.device.type == "cpu":
        return xla_attention(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention path for device {q.device}")
    out = _launch_flash(q, k, v, causal)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def xla_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor,
                         cache_len: torch.Tensor) -> torch.Tensor:
    """Decode graph: q [B,1,QH,D] over the full cache [B,S,KH,D] with
    positions >= cache_len [B] masked. The ragged decode kernel's twin."""
    s_max = k_cache.shape[1]
    mask = (torch.arange(s_max, device=q.device)[None, :]
            < cache_len[:, None])                           # [B, S]
    return _softmax_attend(q, k_cache, v_cache, mask[:, None, None, :])


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     cache_len: torch.Tensor) -> torch.Tensor:
    """One-token decode against a contiguous cache [B,S,KH,D], cache_len
    [B] counting the current token: the ragged decode kernel (its twin on
    a CPU tensor) for long aligned caches, the plain graph otherwise, as
    the JAX ``decode_attention`` dispatches."""
    if uses_ragged(k_cache.shape[1], q.shape[-1]):
        from .paged_attention import ragged_decode_attention
        return ragged_decode_attention(q, k_cache, v_cache, cache_len)
    return xla_decode_attention(q, k_cache, v_cache, cache_len)


def chunk_prefill_attention(q: torch.Tensor, k_cache: torch.Tensor,
                            v_cache: torch.Tensor,
                            positions: torch.Tensor) -> torch.Tensor:
    """Attention for one prefill chunk against the whole written prefix.

    q [B, C, QH, D] are the chunk's queries at absolute ``positions``
    [B, C]; k/v_cache [B, S, KH, D] already hold the prefix and this chunk.
    A key at position p is visible to the query at t iff p <= t, which
    covers the prefix, causality within the chunk, and hides whatever lies
    past the written region."""
    s_max = k_cache.shape[1]
    key_pos = torch.arange(s_max, device=q.device)[None, None, :]   # [1,1,S]
    mask = key_pos <= positions[:, :, None]                          # [B,C,S]
    return _softmax_attend(q, k_cache, v_cache, mask[:, None, :, :])


def paged_attention_dispatch(q: torch.Tensor, k_pool: torch.Tensor,
                             v_pool: torch.Tensor, block_table: torch.Tensor,
                             cache_len: torch.Tensor,
                             k_scale: Optional[torch.Tensor] = None,
                             v_scale: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """Block-table paged decode: the CUDA kernel for a CUDA tensor (it
    raises for a shape it cannot take), the plain twin for a CPU tensor.
    ``k_scale``/``v_scale`` [N, BS, KH] mark an int8 pool, which goes to
    the int8 kernel: it dequantizes in registers after each load, so device
    memory moves only the int8 payload and the per-vector scales."""
    from .paged_attention import (paged_decode_attention,
                                  paged_decode_attention_quant)
    if k_scale is not None:
        return paged_decode_attention_quant(q, k_pool, v_pool, k_scale,
                                            v_scale, block_table, cache_len)
    return paged_decode_attention(q, k_pool, v_pool, block_table, cache_len)
