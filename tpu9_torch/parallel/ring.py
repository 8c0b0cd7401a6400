"""Ring attention of the port (counterpart of ``tpu9/parallel/ring.py``):
exact long-context attention with the sequence split over a mesh axis.

Rank i holds the ``[B, T/n, H, D]`` block i of q, k and v on the axis's
device i. At each of n steps every rank folds the k/v block it holds into
its online-softmax statistics (f32), then the blocks move one rank on (a
copy to the next rank's device: the reference's ``ppermute``). Causality
comes from global block offsets; a block wholly in a rank's future adds
exactly nothing (its rows' scale factors are 1 and 0), so it is not
computed. One process drives the ranks in turn, so a rank's memory is one
block's scores, O((T/n)^2), beside its O(T/n) blocks and statistics.
Plain torch ops, as the reference's XLA ops: autograd gives the gradient
through the copies.
"""

from __future__ import annotations

import torch

from .sharding import Pieces, to_device

NEG_INF = -1e30


def _local_block(q, k, v, q_off: int, k_off: int, causal: bool,
                 scale: float):
    """f32 blockwise attention statistics. q ``[B,Tq,H,D]``, k/v
    ``[B,Tk,H,D]``: (numerator ``[B,Tq,H,D]``, max ``[B,Tq,H]``, denominator
    ``[B,Tq,H]``)."""
    s = torch.einsum("bthd,bshd->bhts", q * scale, k)
    if causal:
        tq, tk = q.shape[1], k.shape[1]
        q_pos = q_off + torch.arange(tq, device=q.device)[:, None]
        k_pos = k_off + torch.arange(tk, device=q.device)[None, :]
        s = torch.where(k_pos <= q_pos, s, NEG_INF)
    m = s.amax(dim=-1)                                   # [B,H,Tq]
    p = torch.exp(s - m[..., None])
    # a row masked in every position contributes zero, not exp(0) == 1
    p = torch.where(m[..., None] > NEG_INF / 2, p, 0.0)
    l = p.sum(dim=-1)                                    # [B,H,Tq]
    o = torch.einsum("bhts,bshd->bthd", p, v)            # [B,Tq,H,D]
    return o, m.transpose(1, 2), l.transpose(1, 2)


def _blocks(x, n: int, devices: list) -> list:
    """``x``'s n sequence blocks on the axis's devices: :class:`Pieces`
    split on T as they are, a whole tensor split here."""
    if isinstance(x, Pieces):
        if len(x) != n or x.dim != 1:
            raise ValueError(f"{len(x)} pieces on dim {x.dim}; the ring "
                             f"needs {n} on dim 1")
        return list(x)
    if x.shape[1] % n:
        raise ValueError(f"T={x.shape[1]} does not split into {n} blocks")
    return [to_device(b, d) for b, d in zip(x.chunk(n, dim=1), devices)]


def ring_attention(q, k, v, mesh, axis: str = "sp", causal: bool = True):
    """q, k, v ``[B, T, H, D]``, split on T over the devices of ``axis``
    (whole tensors, split here, or :class:`Pieces` on dim 1, say from
    ``shard_params`` with ``P(None, axis)``). kv heads must equal q heads
    (expand GQA first). Returns ``[B, T, H, D]`` in q's dtype, laid out as
    q was: :class:`Pieces` on the axis's devices, or one tensor on q's
    device."""
    devices = mesh.sub_devices((axis,))
    n = len(devices)
    qs, ks, vs = (_blocks(x, n, devices) for x in (q, k, v))
    tq = qs[0].shape[1]
    scale = qs[0].shape[-1] ** -0.5
    b, _, h, d = qs[0].shape
    acc = [torch.zeros((b, tq, h, d), dtype=torch.float32, device=dev)
           for dev in devices]
    m_run = [torch.full((b, tq, h), NEG_INF, dtype=torch.float32,
                        device=dev) for dev in devices]
    l_run = [torch.zeros((b, tq, h), dtype=torch.float32, device=dev)
             for dev in devices]
    k_cur, v_cur = ks, vs
    for r in range(n):
        for i in range(n):
            owner = (i - r) % n          # the block rank i holds at step r
            if causal and owner > i:
                continue                 # wholly in rank i's future
            o, m_blk, l_blk = _local_block(
                qs[i].float(), k_cur[i].float(), v_cur[i].float(),
                q_off=i * tq, k_off=owner * tq, causal=causal, scale=scale)
            m_new = torch.maximum(m_run[i], m_blk)
            a_run = torch.exp(m_run[i] - m_new)
            a_blk = torch.exp(m_blk - m_new)
            acc[i] = acc[i] * a_run[..., None] + o * a_blk[..., None]
            l_run[i] = l_run[i] * a_run + l_blk * a_blk
            m_run[i] = m_new
        if r < n - 1:
            # each block moves one rank on: i -> i + 1
            k_cur = [to_device(k_cur[(i - 1) % n], devices[i])
                     for i in range(n)]
            v_cur = [to_device(v_cur[(i - 1) % n], devices[i])
                     for i in range(n)]
    outs = [(a / l.clamp_min(1e-30)[..., None]).to(qs[0].dtype)
            for a, l in zip(acc, l_run)]
    if isinstance(q, Pieces):
        return q.like(outs)
    return torch.cat([to_device(o, q.device) for o in outs], dim=1)
