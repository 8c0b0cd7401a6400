"""Decode attention over a paged pool or a contiguous cache (counterpart
of ``tpu9/ops/paged_attention.py``).

``paged_decode_attention`` (bf16 pool), ``paged_decode_attention_quant``
(int8 pool with f32 per-vector scales) and ``ragged_decode_attention``
(contiguous bf16 cache) wrap the three instances of the hand-written CUDA
kernels ``tpu9_torch/csrc/paged_decode_attention.cu``, the port of the TPU
kernels of the same names. Each call launches two kernels: a split-KV pass
over a grid of (kv head, sequence, split), whose plan ``split_plan`` takes
from the shapes alone, and a combine pass that merges each split's partial
softmax state (``merge_partials`` is its plain twin). On a CUDA tensor each
wrapper launches them or raises; on a CPU tensor it computes the plain
twin: ``xla_paged_decode_attention`` (gather the table rows densely,
dequantize an int8 pool, then a masked softmax) for the pool,
``xla_decode_attention`` for the contiguous cache. The twins are also the
kernels' oracles in the tests and in ``chip_smoke.py``.

Each wrapper counts its launches in ``.launches``. Inside a CUDA-graph
capture a wrapper enqueues into the graph and launches nothing, and a
replay runs no Python: so a capture takes back what its wrappers counted
(:func:`captured_launches`) and each replay adds it (:func:`add_launches`).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from .quant import dequantize_kv

KERNEL = "paged_decode_attention"
HEAD_DIMS = (64, 128, 256)
GROUPS = (1, 2, 4, 8)
MAX_BLOCK_S = 1024
RAGGED_BLOCK_S = 256          # the JAX ragged kernel's default block_s
# cached positions a split CTA takes at least: the best of 128, 256 and
# 512 timed on the card (PERF.md §6)
SPLIT_TOKENS = 128


def gather_paged(pool: torch.Tensor, block_table: torch.Tensor,
                 scale: Optional[torch.Tensor] = None,
                 dtype=None) -> torch.Tensor:
    """Densify a paged cache: pool [N,BS,KH,D] + table [B,MB] →
    [B, MB*BS, KH, D]. Every table entry is read, garbage included.
    ``scale`` [N,BS,KH] marks an int8 pool: the scale planes are gathered
    by the same table and the result is dequantized to ``dtype`` (bf16 by
    default)."""
    b, mb = block_table.shape
    _, bs, kh, d = pool.shape
    flat = block_table.reshape(-1).long()
    dense = pool[flat].reshape(b, mb * bs, kh, d)
    if scale is not None:
        sc = scale[flat].reshape(b, mb * bs, kh)
        dense = dequantize_kv(dense, sc, dtype or torch.bfloat16)
    return dense


def xla_paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                               v_pool: torch.Tensor, block_table: torch.Tensor,
                               cache_len: torch.Tensor,
                               k_scale: Optional[torch.Tensor] = None,
                               v_scale: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """The kernels' plain twin: densify (dequantizing an int8 pool to q's
    dtype right after the gather), then the masked-softmax decode graph.
    q [B,1,QH,D] → [B,1,QH,D] in q's dtype."""
    from .attention import xla_decode_attention
    k = gather_paged(k_pool, block_table, k_scale, q.dtype)
    v = gather_paged(v_pool, block_table, v_scale, q.dtype)
    return xla_decode_attention(q, k, v, cache_len)


def split_plan(max_blocks: int, block_s: int) -> tuple[int, int]:
    """``(n_splits, blocks_per_split)`` of the split-KV grid (kv_heads,
    batch, n_splits): split s takes table columns [s * bps, (s + 1) * bps)
    of every sequence, ``SPLIT_TOKENS`` positions or one block if that is
    more, and the splits cover all ``max_blocks`` columns. It reads the
    shapes, never the lengths, so a launch needs no host read of
    ``cache_len`` and can be captured in a CUDA graph."""
    bps = min(max_blocks, max(1, -(-SPLIT_TOKENS // block_s)))
    return -(-max_blocks // bps), bps


def merge_partials(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor,
                   cache_len: torch.Tensor, block_s: int,
                   blocks_per_split: int) -> torch.Tensor:
    """Plain twin of the combine kernel: m, l [B, QH, NS] and acc
    [B, QH, NS, D] are each split's running max, sum and unnormalised
    output in f32; only the ceil(ceil(len/BS)/bps) splits of a sequence
    that hold positions are merged: m* = max m_i, out = sum e^(m_i - m*)
    acc_i / max(sum e^(m_i - m*) l_i, 1e-30). Returns [B, 1, QH, D] f32;
    length 0 gives zeros."""
    from .attention import NEG_INF
    n_splits = m.shape[-1]
    blocks = -(-cache_len.long().clamp(min=0) // block_s)
    used = -(-blocks // blocks_per_split)                          # [B]
    dead = (torch.arange(n_splits, device=m.device)
            >= used[:, None])[:, None, :]                          # [B, 1, NS]
    m = m.masked_fill(dead, NEG_INF)
    w = torch.exp(m - m.amax(-1, keepdim=True)).masked_fill(dead, 0.0)
    num = (w[..., None] * acc.masked_fill(dead[..., None], 0.0)).sum(2)
    den = (w * l.masked_fill(dead, 0.0)).sum(2).clamp(min=1e-30)
    return (num / den[..., None])[:, None]


def _instance_supports(q_heads: int, kv_heads: int, head_dim: int,
                       block_s: int) -> str:
    """The checks every instance shares: head_dim, GQA group, block size."""
    if head_dim not in HEAD_DIMS:
        return f"head_dim in {HEAD_DIMS}, got {head_dim}"
    if kv_heads == 0 or q_heads % kv_heads or q_heads // kv_heads not in GROUPS:
        return f"GQA group in {GROUPS}, got {q_heads}/{kv_heads}"
    if block_s <= 0 or block_s % 16 or block_s > MAX_BLOCK_S:
        return f"block size a multiple of 16 up to {MAX_BLOCK_S}, got {block_s}"
    return ""


def kernel_supports(q: torch.Tensor, k_pool: torch.Tensor,
                    k_scale: Optional[torch.Tensor] = None) -> str:
    """Empty when the block-table kernel takes these shapes and types, else
    why not. ``k_scale`` marks the int8 instance."""
    _, t, q_heads, head_dim = q.shape
    _, block_s, kv_heads, _ = k_pool.shape
    if t != 1:
        return f"one query token per sequence, got {t}"
    pool_dtype, pool = ((torch.bfloat16, "bf16") if k_scale is None
                        else (torch.int8, "int8"))
    if q.dtype != torch.bfloat16 or k_pool.dtype != pool_dtype:
        return f"bf16 q and {pool} pool, got {q.dtype} and {k_pool.dtype}"
    if k_scale is not None and (k_scale.dtype != torch.float32
                                or k_scale.shape != k_pool.shape[:-1]):
        return (f"f32 scales of shape {tuple(k_pool.shape[:-1])}, got "
                f"{k_scale.dtype} {tuple(k_scale.shape)}")
    return _instance_supports(q_heads, kv_heads, head_dim, block_s)


def ragged_kernel_supports(q: torch.Tensor, k_cache: torch.Tensor,
                           block_s: int = RAGGED_BLOCK_S) -> str:
    """Empty when the contiguous-cache kernel takes these shapes and types
    with blocks of ``block_s`` positions, else why not."""
    _, t, q_heads, head_dim = q.shape
    _, s_max, kv_heads, _ = k_cache.shape
    if t != 1:
        return f"one query token per sequence, got {t}"
    if q.dtype != torch.bfloat16 or k_cache.dtype != torch.bfloat16:
        return f"bf16 q and cache, got {q.dtype} and {k_cache.dtype}"
    why = _instance_supports(q_heads, kv_heads, head_dim, block_s)
    if why:
        return why
    if s_max == 0 or s_max % block_s:
        return (f"a cache length that is a multiple of the block size "
                f"{block_s}, got {s_max}")
    return ""


def check_launch_layout(tensors) -> None:
    """One device, contiguous, and the first three (q, k, v) 16-byte
    aligned for the kernels' vector loads."""
    if any(t.device != tensors[0].device for t in tensors):
        raise ValueError("all operands must be on one CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("operands must be contiguous")
    if any(t.data_ptr() % 16 for t in tensors[:3]):
        raise ValueError("q, k and v must be 16-byte aligned")


def _plan_and_scratch(q, max_blocks: int, block_s: int):
    """The split plan for these shapes, and one new f32 buffer for the
    partials that the split pass writes and the combine pass reads: each
    split's unnormalised output [B, QH, NS, D], then its running max and
    sum [B, QH, NS, 2]. Returns the plan, the buffer (held by the caller
    until both kernels are enqueued) and the two parts' addresses."""
    batch, _, q_heads, head_dim = q.shape
    n_splits, bps = split_plan(max_blocks, block_s)
    rows = batch * q_heads * n_splits
    scratch = torch.empty(rows * (head_dim + 2), dtype=torch.float32,
                          device=q.device)
    base = scratch.data_ptr()
    return n_splits, bps, scratch, (base, base + 4 * rows * head_dim)


def _launch(q, k_pool, v_pool, block_table, cache_len, k_scale=None,
            v_scale=None) -> torch.Tensor:
    """Validate the operands, then launch the bf16 instance, or the int8
    one when ``k_scale``/``v_scale`` are given."""
    name = "paged_decode_attention" + ("" if k_scale is None else "_quant")
    why = kernel_supports(q, k_pool, k_scale)
    if why:
        raise ValueError(f"{name} kernel needs {why}")
    batch, _, q_heads, head_dim = q.shape
    _, block_s, kv_heads, _ = k_pool.shape
    max_blocks = block_table.shape[1]
    if not (k_pool.shape == v_pool.shape and v_pool.dtype == k_pool.dtype):
        raise ValueError("k_pool and v_pool differ in shape or dtype")
    scales = () if k_scale is None else (k_scale, v_scale)
    if scales and not (v_scale is not None and v_scale.shape == k_scale.shape
                       and v_scale.dtype == k_scale.dtype):
        raise ValueError("k_scale and v_scale differ in shape or dtype")
    if block_table.shape[0] != batch or cache_len.shape != (batch,):
        raise ValueError(f"table {tuple(block_table.shape)} / cache_len "
                         f"{tuple(cache_len.shape)} do not match batch {batch}")
    if block_table.dtype != torch.int32 or cache_len.dtype != torch.int32:
        raise ValueError("block_table and cache_len must be int32")
    check_launch_layout((q, k_pool, v_pool, *scales, block_table, cache_len))
    n_splits, bps, scratch, parts = _plan_and_scratch(q, max_blocks, block_s)
    out = torch.empty_like(q)
    shape = (batch, q_heads, kv_heads, head_dim, block_s, max_blocks,
             n_splits, bps, head_dim ** -0.5,
             torch.cuda.current_stream(q.device).cuda_stream)
    ptrs = [t.data_ptr() for t in (q, k_pool, v_pool, *scales, block_table,
                                   cache_len, out)] + list(parts)
    rc = _kernel_fn("bf16" if k_scale is None else "int8")(*ptrs, *shape)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    return out


def _launch_ragged(q, k_cache, v_cache, cache_len, block_s: int
                   ) -> torch.Tensor:
    """Validate the operands, then launch the contiguous-cache instance."""
    why = ragged_kernel_supports(q, k_cache, block_s)
    if why:
        raise ValueError(f"ragged_decode_attention kernel needs {why}")
    batch, _, q_heads, head_dim = q.shape
    _, s_max, kv_heads, _ = k_cache.shape
    if not (k_cache.shape == v_cache.shape and v_cache.dtype == k_cache.dtype
            and k_cache.shape[0] == batch and k_cache.shape[3] == head_dim):
        raise ValueError(f"caches {tuple(k_cache.shape)} / "
                         f"{tuple(v_cache.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if cache_len.shape != (batch,) or cache_len.dtype != torch.int32:
        raise ValueError(f"cache_len must be int32 of shape ({batch},), got "
                         f"{cache_len.dtype} {tuple(cache_len.shape)}")
    check_launch_layout((q, k_cache, v_cache, cache_len))
    n_splits, bps, scratch, parts = _plan_and_scratch(q, s_max // block_s,
                                                      block_s)
    out = torch.empty_like(q)
    rc = _kernel_fn("ragged")(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        cache_len.data_ptr(), out.data_ptr(), *parts,
        batch, q_heads, kv_heads, head_dim, block_s, s_max, n_splits, bps,
        head_dim ** -0.5, torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ragged_decode_attention launch failed: "
                           f"cudaError {rc}")
    return out


# each instance's C entry and its number of pointer operands (the last two
# the partials); all take eight ints, the scale and the stream after them
_ENTRIES = {"bf16": ("tpu9_paged_decode_attention_bf16", 8),
            "int8": ("tpu9_paged_decode_attention_int8", 10),
            "ragged": ("tpu9_ragged_decode_attention_bf16", 7)}


@functools.cache
def _kernel_fn(instance: str):
    """The entry point of one instance of the library (``_ENTRIES``)."""
    from ._build import load
    symbol, n_ptrs = _ENTRIES[instance]
    fn = getattr(load(KERNEL), symbol)
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 8 + [
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

    A CUDA ``q`` launches the split and combine kernels
    (``paged_decode_attention.launches`` counts each call) or raises if the
    kernels cannot take the operands; a CPU ``q`` computes the plain
    twin."""
    if q.device.type == "cpu":
        return xla_paged_decode_attention(q, k_pool, v_pool, block_table,
                                          cache_len)
    if q.device.type != "cuda":
        raise ValueError(f"no paged decode path for device {q.device}")
    out = _launch(q, k_pool, v_pool, block_table, cache_len)
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


def paged_decode_attention_quant(q: torch.Tensor, k_pool: torch.Tensor,
                                 v_pool: torch.Tensor, k_scale: torch.Tensor,
                                 v_scale: torch.Tensor,
                                 block_table: torch.Tensor,
                                 cache_len: torch.Tensor) -> torch.Tensor:
    """:func:`paged_decode_attention` over an int8 pool: k/v_pool
    [N_BLOCKS, BS, KH, D] int8, k/v_scale [N_BLOCKS, BS, KH] f32 (one
    absmax scale per (token, head) vector, ``ops.quant.quantize_kv``). The
    kernel dequantizes in registers, in f32.

    A CUDA ``q`` launches the int8 split kernel and the combine kernel
    (``paged_decode_attention_quant.launches`` counts each call) or raises;
    a CPU ``q`` computes the plain twin."""
    if q.device.type == "cpu":
        return xla_paged_decode_attention(q, k_pool, v_pool, block_table,
                                          cache_len, k_scale, v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"no paged decode path for device {q.device}")
    out = _launch(q, k_pool, v_pool, block_table, cache_len, k_scale,
                  v_scale)
    paged_decode_attention_quant.launches += 1
    return out


paged_decode_attention_quant.launches = 0


def ragged_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                            v_cache: torch.Tensor, cache_len: torch.Tensor,
                            block_s: int = RAGGED_BLOCK_S) -> torch.Tensor:
    """Decode attention over a contiguous cache that reads only each
    sequence's valid prefix.

    q [B,1,QH,D]; k/v_cache [B,S,KH,D] with S a multiple of ``block_s``;
    cache_len [B] int32 counts valid positions incl. the current one (the
    engine passes at least 1). Returns [B,1,QH,D] in q's dtype. Only
    ceil(len/block_s) blocks of each sequence are read, so positions >= len
    may hold anything.

    A CUDA ``q`` launches the split and combine kernels
    (``ragged_decode_attention.launches`` counts each call) or raises if
    the kernels cannot take the operands;
    a CPU ``q`` computes the plain twin ``xla_decode_attention``. The two
    agree for len >= 1; at len 0 the kernel gives zeros where the twin's
    softmax over all-masked logits gives the mean of v."""
    if q.device.type == "cpu":
        from .attention import xla_decode_attention
        return xla_decode_attention(q, k_cache, v_cache, cache_len)
    if q.device.type != "cuda":
        raise ValueError(f"no ragged decode path for device {q.device}")
    out = _launch_ragged(q, k_cache, v_cache, cache_len, block_s)
    ragged_decode_attention.launches += 1
    return out


ragged_decode_attention.launches = 0


# the wrappers whose kernels a captured decode window replays
COUNTED = (paged_decode_attention, paged_decode_attention_quant,
           ragged_decode_attention)


def launch_counts() -> dict[str, int]:
    return {w.__name__: w.launches for w in COUNTED}


def add_launches(counts: dict[str, int]) -> None:
    """Add ``counts`` (by wrapper name) to the wrappers' ``.launches``."""
    for w in COUNTED:
        w.launches += counts.get(w.__name__, 0)


def captured_launches(capture) -> dict[str, int]:
    """Run ``capture`` (a CUDA-graph capture of wrapper calls) and return
    the launches its wrappers counted, by name; the counts are then set
    back, because a capture launches nothing. A replay of the graph adds
    the returned counts."""
    before = launch_counts()
    try:
        capture()
    finally:
        after = launch_counts()
        add_launches({n: before[n] - after[n] for n in after})
    return {n: after[n] - before[n] for n in after if after[n] != before[n]}
