"""Attention (counterpart of ``tpu9/ops/attention.py``): the plain paths
as PyTorch (logits, mask and softmax in f32, as the JAX code does) and the
paged-decode dispatch to the CUDA kernels (bf16 or int8 pool).

The blocked flash-attention TPU kernel of the JAX package is not ported yet
(ROADMAP queue B3): ``attention`` raises on a CUDA tensor for the shapes the
JAX package would send to it, and takes the plain path elsewhere, as the JAX
``attention`` does off the TPU.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


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
    places the q tokens at that offset within the kv sequence."""
    t, s = q.shape[1], k.shape[1]
    if causal:
        q_pos = torch.arange(t, device=q.device)[:, None] + kv_offset
        k_pos = torch.arange(s, device=q.device)[None, :]
        mask = (k_pos <= q_pos)[None, None]
    else:
        mask = torch.ones((1, 1, t, s), dtype=torch.bool, device=q.device)
    return _softmax_attend(q, k, v, mask)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, kv_offset: int = 0) -> torch.Tensor:
    """Dispatch as the JAX ``attention``: block-aligned shapes go to the
    flash kernel on the accelerator, everything else to the plain path. The
    flash kernel has no Hopper port yet, so those shapes raise on CUDA."""
    t, s = q.shape[1], k.shape[1]
    if (q.device.type == "cuda" and kv_offset == 0 and t % 128 == 0
            and s % 128 == 0 and q.shape[-1] in (64, 128, 256)):
        raise NotImplementedError(
            "flash_attention has no CUDA kernel yet (ROADMAP queue B3)")
    return xla_attention(q, k, v, causal=causal, kv_offset=kv_offset)


def xla_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor,
                         cache_len: torch.Tensor) -> torch.Tensor:
    """Decode graph: q [B,1,QH,D] over the full cache [B,S,KH,D] with
    positions >= cache_len [B] masked."""
    s_max = k_cache.shape[1]
    mask = (torch.arange(s_max, device=q.device)[None, :]
            < cache_len[:, None])                           # [B, S]
    return _softmax_attend(q, k_cache, v_cache, mask[:, None, None, :])


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
