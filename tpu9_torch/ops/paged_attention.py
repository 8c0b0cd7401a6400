"""Block-table paged decode attention (counterpart of
``tpu9/ops/paged_attention.py``).

``paged_decode_attention`` is the wrapper of the hand-written CUDA kernel
``tpu9_torch/csrc/paged_decode_attention.cu``, the port of the TPU kernel of
the same name. On a CUDA tensor it launches the kernel or raises; on a CPU
tensor it computes the kernel's plain twin, ``xla_paged_decode_attention``
(gather the table rows densely, then a masked softmax), which is also the
kernel's oracle in the tests and in ``chip_smoke.py``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

KERNEL = "paged_decode_attention"
HEAD_DIMS = (64, 128)
GROUPS = (1, 2, 4, 8)
MAX_BLOCK_S = 1024


def gather_paged(pool: torch.Tensor, block_table: torch.Tensor) -> torch.Tensor:
    """Densify a paged cache: pool [N,BS,KH,D] + table [B,MB] →
    [B, MB*BS, KH, D]. Every table entry is read, garbage included."""
    b, mb = block_table.shape
    _, bs, kh, d = pool.shape
    return pool[block_table.reshape(-1).long()].reshape(b, mb * bs, kh, d)


def xla_paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                               v_pool: torch.Tensor, block_table: torch.Tensor,
                               cache_len: torch.Tensor) -> torch.Tensor:
    """The kernel's plain twin: densify, then the masked-softmax decode
    graph. q [B,1,QH,D] → [B,1,QH,D] in q's dtype."""
    from .attention import xla_decode_attention
    return xla_decode_attention(q, gather_paged(k_pool, block_table),
                                gather_paged(v_pool, block_table), cache_len)


def kernel_supports(q: torch.Tensor, k_pool: torch.Tensor) -> str:
    """Empty when the CUDA kernel takes these shapes and types, else why
    not."""
    _, t, q_heads, head_dim = q.shape
    _, block_s, kv_heads, _ = k_pool.shape
    if t != 1:
        return f"one query token per sequence, got {t}"
    if q.dtype != torch.bfloat16 or k_pool.dtype != torch.bfloat16:
        return f"bf16 q and pool, got {q.dtype} and {k_pool.dtype}"
    if head_dim not in HEAD_DIMS:
        return f"head_dim in {HEAD_DIMS}, got {head_dim}"
    if q_heads % kv_heads or q_heads // kv_heads not in GROUPS:
        return f"GQA group in {GROUPS}, got {q_heads}/{kv_heads}"
    if block_s % 16 or block_s > MAX_BLOCK_S:
        return f"block size a multiple of 16 up to {MAX_BLOCK_S}, got {block_s}"
    return ""


def _launch(q, k_pool, v_pool, block_table, cache_len) -> torch.Tensor:
    why = kernel_supports(q, k_pool)
    if why:
        raise ValueError(f"paged_decode_attention kernel needs {why}")
    batch, _, q_heads, head_dim = q.shape
    _, block_s, kv_heads, _ = k_pool.shape
    if not (k_pool.shape == v_pool.shape and v_pool.dtype == k_pool.dtype):
        raise ValueError("k_pool and v_pool differ in shape or dtype")
    if block_table.shape[0] != batch or cache_len.shape != (batch,):
        raise ValueError(f"table {tuple(block_table.shape)} / cache_len "
                         f"{tuple(cache_len.shape)} do not match batch {batch}")
    tensors = (q, k_pool, v_pool, block_table, cache_len)
    if any(t.device != q.device for t in tensors):
        raise ValueError("all operands must be on one CUDA device")
    if block_table.dtype != torch.int32 or cache_len.dtype != torch.int32:
        raise ValueError("block_table and cache_len must be int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("operands must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k_pool, v_pool)):
        raise ValueError("q and pools must be 16-byte aligned")
    fn = _kernel_fn()
    out = torch.empty_like(q)
    rc = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            block_table.data_ptr(), cache_len.data_ptr(), out.data_ptr(),
            batch, q_heads, kv_heads, head_dim, block_s, block_table.shape[1],
            head_dim ** -0.5, torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_decode_attention launch failed: "
                           f"cudaError {rc}")
    paged_decode_attention.launches += 1
    return out


@functools.cache
def _kernel_fn():
    from ._build import load
    fn = load(KERNEL).tpu9_paged_decode_attention_bf16
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_table: torch.Tensor,
                           cache_len: torch.Tensor) -> torch.Tensor:
    """Block-table paged decode attention.

    q [B,1,QH,D]; k/v_pool [N_BLOCKS, BS, KH, D], shared by every sequence;
    block_table [B, MAX_BLOCKS] int32 maps each sequence's logical block to
    a physical pool block (entries past the valid prefix are never read);
    cache_len [B] valid tokens incl. the current one. Returns [B,1,QH,D].

    A CUDA ``q`` launches the kernel (``paged_decode_attention.launches``
    counts each launch) or raises if the kernel cannot take the operands;
    a CPU ``q`` computes the plain twin."""
    if q.device.type == "cpu":
        return xla_paged_decode_attention(q, k_pool, v_pool, block_table,
                                          cache_len)
    if q.device.type != "cuda":
        raise ValueError(f"no paged decode path for device {q.device}")
    return _launch(q, k_pool, v_pool, block_table, cache_len)


paged_decode_attention.launches = 0
