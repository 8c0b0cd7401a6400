"""Attention (counterpart of ``tpu9/ops/attention.py``): the plain paths
as PyTorch (logits, mask and softmax in f32, as the JAX code does), the
dispatch to the hand-written CUDA kernels, and the wrapper of the flash
kernel ``tpu9_torch/csrc/flash_attention.cu``.

``attention`` and ``decode_attention`` dispatch under exactly the JAX
conditions (``uses_flash``, ``uses_ragged``): block-aligned shapes go to the
flash kernel and long aligned caches to the ragged decode kernel, everything
else to the plain path, as the JAX package does. Each kernel wrapper
launches its kernel on a CUDA tensor (or raises for operands it cannot
take) and computes its plain twin on a CPU tensor. ``paged_verify_attention``
(a speculative verify window over the paged pool) runs on the card as one
call of the block-table decode kernels over every (slot, window position)
row. Under grad, ``attention`` gives the flash shapes
:class:`FlashAttention` (the train step's path): the kernel forward, which
also saves each row's log-sum-exp, and the hand-written backward kernel
``tpu9_torch/csrc/flash_attention_backward.cu``, whose twin
``xla_attention_backward`` is the gradient of ``xla_attention``.
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
                    mask: Optional[torch.Tensor], with_lse: bool = False):
    """q [B,T,QH,D], k/v [B,S,KH,D], mask broadcastable to [B,H,T,S]
    (``None``: every key). With ``with_lse``, also each row's log-sum-exp
    of its scaled, masked f32 scores, [B, QH, T]."""
    q_heads = q.shape[2]
    k = _expand_gqa(k, q_heads)
    v = _expand_gqa(v, q_heads)
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bthd,bshd->bhts", q.float() * scale, k.float())
    if mask is not None:
        logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhts,bshd->bthd", probs, v.float()).to(q.dtype)
    if with_lse:
        return out, torch.logsumexp(logits, dim=-1)
    return out


def _causal_hidden(t: int, s: int, device, kv_offset: int = 0) -> torch.Tensor:
    """[T, S]: true where key position > query position + ``kv_offset``."""
    q_pos = torch.arange(t, device=device)[:, None] + kv_offset
    return torch.arange(s, device=device)[None, :] > q_pos


def xla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, kv_offset: int = 0) -> torch.Tensor:
    """Plain attention. q: [B, T, QH, D], k/v: [B, S, KH, D]. ``kv_offset``
    places the q tokens at that offset within the kv sequence. The flash
    kernel's twin (at ``kv_offset=0``)."""
    mask = None
    if causal:
        mask = ~_causal_hidden(q.shape[1], k.shape[1], q.device,
                               kv_offset)[None, None]
    return _softmax_attend(q, k, v, mask)


def xla_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True):
    """``xla_attention`` (no offset) and each row's natural-log log-sum-exp
    of its scaled, masked f32 scores, lse [B, QH, T] f32: the twin of the
    flash kernel when it saves its statistics for the backward."""
    mask = None
    if causal:
        mask = ~_causal_hidden(q.shape[1], k.shape[1], q.device)[None, None]
    return _softmax_attend(q, k, v, mask, with_lse=True)


def encoder_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      key_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The encoders' bidirectional attention (``tpu9/models/clip_vit.py``
    and ``classifier.py``, plain f32 products there too, no kernel): q
    scaled in f32, f32 scores, softmax and product with v, cast back.
    ``key_mask`` [B, S]: keys where it is > 0 are attended, the others
    scored -1e30, so a row with no key attends to all of them uniformly,
    as the reference's additive -1e30 bias gives (that bias absorbs any
    f32 score)."""
    mask = None if key_mask is None else (key_mask > 0)[:, None, None, :]
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
    path. Under grad, with an input that requires it, the flash shapes go
    through :class:`FlashAttention`, which gives the kernel a backward;
    the plain path is differentiated by autograd itself."""
    if uses_flash(q.shape[1], k.shape[1], q.shape[-1], kv_offset):
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            return FlashAttention.apply(q, k, v, causal)
        return flash_attention(q, k, v, causal=causal)
    return xla_attention(q, k, v, causal=causal, kv_offset=kv_offset)


def xla_attention_backward(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, out: torch.Tensor,
                           lse: torch.Tensor, d_out: torch.Tensor,
                           causal: bool):
    """(dq, dk, dv) of ``xla_attention(q, k, v, causal)`` for the output
    cotangent ``d_out``, from the forward's ``out`` and ``lse`` [B, QH, T]:
    the backward kernel's plain twin, with its algebra. The scaled scores
    x are recomputed from q and k in f32 (masked to -1e30 when causal), the
    probabilities as P = exp(x - lse), delta = rowsum(d_out * out) in f32
    and dS = P (dP - delta) with dP = d_out V^T; then dv = P^T d_out,
    dk = scale dS^T Q and dq = scale dS K in f32, a kv head's dk and dv
    summed over its group of q heads (GQA) before each gradient's one cast
    to its input's dtype. The JAX package's flash kernel has no backward:
    this is the gradient XLA takes of the twin, written as the kernel
    computes it."""
    b, t, q_heads, d = q.shape
    s, kv_heads = k.shape[1], k.shape[2]
    g = q_heads // kv_heads
    scale = d ** -0.5

    def rows(x):
        """[B, T, QH, D] -> [B, KH, G*T, D] f32: a kv head's group of q
        heads' rows, in q head order."""
        return x.float().reshape(b, t, kv_heads, g, d) \
            .permute(0, 2, 3, 1, 4).reshape(b, kv_heads, g * t, d)

    qf, do = rows(q), rows(d_out)
    kf = k.float().transpose(1, 2)                      # [B, KH, S, D]
    vf = v.float().transpose(1, 2)
    x = (qf * scale) @ kf.transpose(-1, -2)             # [B, KH, G*T, S]
    if causal:
        x.masked_fill_(_causal_hidden(t, s, q.device).repeat(g, 1), NEG_INF)
    probs = torch.exp(x - lse.float().reshape(b, kv_heads, g * t, 1))
    del x
    delta = (do * rows(out)).sum(-1, keepdim=True)
    dv = probs.transpose(-1, -2) @ do                   # [B, KH, S, D]
    d_scores = probs * (do @ vf.transpose(-1, -2) - delta)
    del probs
    dq = (d_scores @ kf) * scale                        # [B, KH, G*T, D]
    dk = (d_scores.transpose(-1, -2) @ qf) * scale      # [B, KH, S, D]
    dq = dq.reshape(b, kv_heads, g, t, d).permute(0, 3, 1, 2, 4) \
        .reshape(b, t, q_heads, d)
    return (dq.to(q.dtype), dk.transpose(1, 2).to(k.dtype),
            dv.transpose(1, 2).to(v.dtype))


class FlashAttention(torch.autograd.Function):
    """:func:`flash_attention` with a gradient. Forward: the kernel on a
    CUDA tensor (each call, a checkpoint's recompute included, counts one
    launch), the twin on a CPU tensor, each saving its output and row
    log-sum-exp beside q, k and v. Backward:
    :func:`flash_attention_backward`, the backward kernel on a CUDA tensor
    (one launch a call) and its twin on a CPU tensor."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        out, lse = flash_attention(q, k, v, causal=causal, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, out, lse, d_out,
                                              ctx.causal)
        return dq, dk, dv, None


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


def _check_kv(q, k, v) -> None:
    """The flash kernels' operand checks shared by both directions."""
    why = flash_kernel_supports(q, k)
    if why:
        raise ValueError(f"flash_attention kernel needs {why}")
    batch, _, _, head_dim = q.shape
    if k.shape != v.shape or v.dtype != k.dtype or k.shape[0] != batch \
            or k.shape[3] != head_dim:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")


def flash_split_keys(batch: int, seq_q: int, q_heads: int, head_dim: int,
                     causal: bool, sms: int) -> bool:
    """Whether the forward kernel takes 64-row units whose two consumers
    split the key tiles (D = 256 only) on a card of ``sms`` SMs: where its
    128-row units would leave SMs idle and the split units fill at most one
    wave, or where one round of long causal rows (8 q tiles or more) would
    wait for its heaviest unit, far above the mean."""
    q_tiles = -(-seq_q // 128)
    units = q_tiles * q_heads * batch
    return head_dim == 256 and (2 * units <= sms or (
        causal and q_tiles >= 8 and units < sms))


@functools.cache
def _sm_count(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch_flash(q, k, v, causal: bool,
                  lse: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The forward kernel; it also writes each row's log-sum-exp into
    ``lse`` [B, QH, T] f32 when one is given."""
    _check_kv(q, k, v)
    batch, t, q_heads, head_dim = q.shape
    from .paged_attention import check_launch_layout
    check_launch_layout((q, k, v) if lse is None else (q, k, v, lse))
    out = torch.empty_like(q)
    split = flash_split_keys(batch, t, q_heads, head_dim, causal,
                             _sm_count(q.device.index))
    rc = _flash_fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     None if lse is None else lse.data_ptr(),
                     batch, t, k.shape[1], q_heads, k.shape[2], head_dim,
                     int(causal), int(split), head_dim ** -0.5,
                     q.device.index,
                     torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed: cudaError {rc}")
    return out


# the forward's C entry and its arguments: q, k, v, out, lse; batch,
# seq_q, seq_k, q_heads, kv_heads, head_dim, causal, split; scale; device;
# stream
FLASH_ENTRY = "tpu9_flash_attention_bf16"
FLASH_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


@functools.cache
def _flash_fn():
    from ._build import load
    fn = getattr(load("flash_attention"), FLASH_ENTRY)
    fn.argtypes = FLASH_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, with_lse: bool = False):
    """Blocked online-softmax attention. q [B,T,QH,D]; k/v [B,S,KH,D] with
    KH | QH; ``causal`` masks k_pos > q_pos (no offset). Returns
    [B,T,QH,D] in q's dtype, and with ``with_lse`` also each row's
    log-sum-exp [B, QH, T] in f32 (what the backward reads).

    A CUDA ``q`` launches the kernel (``flash_attention.launches`` counts
    each launch) or raises if the kernel cannot take the operands; a CPU
    ``q`` computes the plain twin ``xla_attention`` (``xla_attention_lse``
    with ``with_lse``)."""
    if q.device.type == "cpu":
        if with_lse:
            return xla_attention_lse(q, k, v, causal=causal)
        return xla_attention(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention path for device {q.device}")
    lse = None
    if with_lse:
        lse = torch.empty((q.shape[0], q.shape[2], q.shape[1]),
                          dtype=torch.float32, device=q.device)
    out = _launch_flash(q, k, v, causal, lse)
    flash_attention.launches += 1
    return (out, lse) if with_lse else out


flash_attention.launches = 0


def _launch_flash_backward(q, k, v, out, lse, d_out, causal: bool):
    _check_kv(q, k, v)
    batch, t, q_heads, head_dim = q.shape
    for name, x in (("out", out), ("d_out", d_out)):
        if x.shape != q.shape or x.dtype != q.dtype:
            raise ValueError(f"{name} {tuple(x.shape)} {x.dtype} does not "
                             f"match q {tuple(q.shape)} {q.dtype}")
    if lse.shape != (batch, q_heads, t) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be [B, QH, T] = {(batch, q_heads, t)} "
                         f"f32, got {tuple(lse.shape)} {lse.dtype}")
    d_out = d_out.contiguous()
    from .paged_attention import check_launch_layout
    check_launch_layout((q, k, v, out, d_out, lse))
    if any(x.data_ptr() % 16 for x in (out, d_out, lse)):
        raise ValueError("out, d_out and lse must be 16-byte aligned")
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    delta = torch.empty_like(lse)
    rc = _flash_backward_fn()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        d_out.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), batch, t, k.shape[1], q_heads,
        k.shape[2], head_dim, int(causal), head_dim ** -0.5, q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_backward launch failed: "
                           f"cudaError {rc}")
    return dq, dk, dv


# the backward's C entry and its arguments: q, k, v, out, d_out, lse,
# delta, dq, dk, dv; batch, seq_q, seq_k, q_heads, kv_heads, head_dim,
# causal; scale; device; stream
FLASH_BACKWARD_ENTRY = "tpu9_flash_attention_backward_bf16"
FLASH_BACKWARD_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


@functools.cache
def _flash_backward_fn():
    from ._build import load
    fn = getattr(load("flash_attention_backward"), FLASH_BACKWARD_ENTRY)
    fn.argtypes = FLASH_BACKWARD_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, out: torch.Tensor,
                             lse: torch.Tensor, d_out: torch.Tensor,
                             causal: bool = True):
    """(dq, dk, dv) of ``flash_attention(q, k, v, causal)`` for the output
    cotangent ``d_out``, from the forward's ``out`` and ``lse`` [B, QH, T]
    (``flash_attention(..., with_lse=True)``), each in its input's dtype.

    A CUDA ``q`` launches the backward kernel
    (``flash_attention_backward.launches`` counts each launch: its delta,
    dk/dv and dq passes are one) or raises if the kernel cannot take the
    operands; a CPU ``q`` computes the plain twin
    ``xla_attention_backward``."""
    if q.device.type == "cpu":
        return xla_attention_backward(q, k, v, out, lse, d_out, causal)
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention backward for device {q.device}")
    grads = _launch_flash_backward(q, k, v, out, lse, d_out, causal)
    flash_attention_backward.launches += 1
    return grads


flash_attention_backward.launches = 0


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


def xla_paged_verify_attention(q: torch.Tensor, k_pool: torch.Tensor,
                               v_pool: torch.Tensor,
                               block_table: torch.Tensor,
                               positions: torch.Tensor,
                               k_scale: Optional[torch.Tensor] = None,
                               v_scale: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """The reference's form of the verify attention, and the card route's
    twin: densify each slot's table row (dequantizing an int8 pool to q's
    dtype right after the gather), then the chunk attention with the
    absolute-position mask. Every table entry is read, garbage included;
    the mask hides it."""
    from .paged_attention import gather_paged
    k = gather_paged(k_pool, block_table, k_scale, q.dtype)
    v = gather_paged(v_pool, block_table, v_scale, q.dtype)
    return chunk_prefill_attention(q, k, v, positions)


def verify_as_decode(q: torch.Tensor, k_pool: torch.Tensor,
                     v_pool: torch.Tensor, block_table: torch.Tensor,
                     positions: torch.Tensor,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The verify attention as ``B*T`` one-token decodes through the
    block-table decode kernels: query (b, t) becomes row ``b*T + t`` with
    slot b's table row and ``cache_len = positions[b, t] + 1``. A key at
    position p is visible to it iff ``p < t + 1``, the decode kernels'
    length rule and the reference's mask, and the kernels read only the
    ``ceil((t + 1) / BS)`` blocks a row needs, so table padding and
    garbage past the prefix are never read. On a CUDA ``q`` the wrappers
    launch B1 (bf16 pool) or B2 (int8 pool) or raise for operands the
    kernels cannot take; on a CPU ``q`` they compute their plain twins,
    which is how the tests model this route."""
    from .paged_attention import (paged_decode_attention,
                                  paged_decode_attention_quant)
    b, t, q_heads, head_dim = q.shape
    rows = q.reshape(b * t, 1, q_heads, head_dim)
    table = block_table.repeat_interleave(t, dim=0)
    cache_len = (positions + 1).reshape(-1).to(torch.int32)
    if k_scale is not None:
        out = paged_decode_attention_quant(rows, k_pool, v_pool, k_scale,
                                           v_scale, table, cache_len)
    else:
        out = paged_decode_attention(rows, k_pool, v_pool, table, cache_len)
    return out.reshape(b, t, q_heads, head_dim)


def paged_verify_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_table: torch.Tensor,
                           positions: torch.Tensor,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Multi-token attention against the paged pool for one speculative
    verify pass: q [B, T, QH, D] are the window's queries at absolute
    ``positions`` [B, T]; k/v_pool [N, BS, KH, D] already hold the window's
    keys (the caller scattered them); ``k_scale``/``v_scale`` [N, BS, KH]
    mark an int8 pool.

    A CUDA ``q`` runs :func:`verify_as_decode` (the decode kernels over
    ``B*T`` rows; they raise for operands they cannot take, and nothing
    falls back to the gather); a CPU ``q`` computes the plain twin
    :func:`xla_paged_verify_attention`."""
    if q.device.type == "cpu":
        return xla_paged_verify_attention(q, k_pool, v_pool, block_table,
                                          positions, k_scale, v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"no paged verify path for device {q.device}")
    return verify_as_decode(q, k_pool, v_pool, block_table, positions,
                            k_scale, v_scale)


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
