"""The numerics of the Hopper flash kernel (``tpu9_torch/csrc/flash_attention.cu``)
on the CPU, where the kernel cannot run.

``kernel_model`` repeats the kernel's arithmetic in PyTorch: 128-row q
tiles over 128-key k/v tiles (64-key at D = 256), zero-filled past T and S
as TMA fills them;
scores in f32, scaled by ``D^-0.5 * log2(e)`` for ``exp2``; keys past S and,
when causal, keys past the row masked to -1e30 (the kernel masks only the
tiles that cross the diagonal or S, where the mask can be true); a causal q
tile stops at its diagonal tile; f32 running max, sum and accumulator;
each probability rounded to bf16 for the PV product; the row sum floored at
1e-30 and the output rounded to bf16.

On the same inputs made from a seed (bf16 values; B=2, GQA 4, T = S = 256
and 320, which is a multiple of 64 and not of 128; D 64, 128 and 256; causal
and not), the JAX Pallas ``flash_attention`` in interpret mode is the
reference: the port's twin ``xla_attention`` matches it in f32 at
``atol=2e-5``, and the model stays within ``chip_smoke.flash_limit`` of the
twin, the tolerance ``chip_smoke.py`` holds the kernel to on the card. So
that tolerance holds for this design by construction.

The backward kernel (``tpu9_torch/csrc/flash_attention_backward.cu``)
likewise: ``backward_kernel_model`` repeats its arithmetic from the model
forward's output and row log-sum-exp (``kernel_model(..., with_lse=True)``,
the kernel's ``(m + log2 l) ln 2``): delta = rowsum(d_out * out) from the
bf16 out in f32; P = exp2(x * scale log2(e) - lse log2(e)) in f32 with the
mask; dS = P (dP - delta); P and dS rounded to bf16 before the products
dV = P^T dO, dK = dS^T Q (summed over 64-row q tiles, a kv head's group of
q heads one after another, as a dk/dv CTA walks them) and dQ = dS K
(summed over the dq kernel's key tiles: 64 keys, 32 at D = 256), each in
f32, scaled and rounded to bf16 once. At the same shapes it stays within
``chip_smoke.grad_limit`` of ``jax.grad`` of the JAX ``xla_attention`` and
of autograd through the port's twin on bf16 leaves (the two references the
card's check has: the first exact, the second what the card compares
with), and within ``chip_smoke.backward_limit`` of the backward's twin
``xla_attention_backward`` on the same out and lse. The twin of the
forward's statistics, ``xla_attention_lse``, matches a log-sum-exp of the
JAX ``xla_attention`` scores taken with jax at ``atol=1e-5``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tpu9.ops import attention as jattn
from tpu9_torch.ops import attention as tattn

torch.set_num_threads(2)

TILE = 128                    # q rows of a tile


def key_tile(d: int) -> int:
    """Keys of a k/v tile: 64 at D = 256 (the q tile and two stages of
    128-key k and v tiles would not fit in shared memory), else 128."""
    return 64 if d == 256 else 128
ATOL = 2e-5
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453


def kernel_model(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 causal: bool, with_lse: bool = False):
    """The kernel's arithmetic. q [B,T,QH,D], k/v [B,S,KH,D] holding bf16
    values (any float dtype); returns [B,T,QH,D] in bf16, and with
    ``with_lse`` also each row's log-sum-exp [B, QH, T] f32 as the kernel
    writes it, (m + log2 l) ln 2 of the base-2 max and sum."""
    batch, t, q_heads, d = q.shape
    s, kv_heads = k.shape[1], k.shape[2]
    group = q_heads // kv_heads
    bn = key_tile(d)
    scale_log2 = torch.tensor(d ** -0.5, dtype=torch.float32) * torch.tensor(
        LOG2E, dtype=torch.float32)

    def tiles(x, n, rows):
        """[B, L, H, D] -> [B, H, n tiles, rows, D] in f32, zero-filled."""
        pad = n * rows - x.shape[1]
        x = torch.nn.functional.pad(x.float(), (0, 0, 0, 0, 0, pad))
        return x.reshape(batch, n, rows, x.shape[2], d).permute(0, 3, 1, 2, 4)

    n_q, n_k = -(-t // TILE), -(-s // bn)
    qs = tiles(q, n_q, TILE)
    ks = tiles(k, n_k, bn).repeat_interleave(group, dim=1)
    vs = tiles(v, n_k, bn).repeat_interleave(group, dim=1)
    out = torch.empty((batch, q_heads, n_q, TILE, d), dtype=torch.float32)
    lse = torch.empty((batch, q_heads, n_q, TILE), dtype=torch.float32)
    for qt in range(n_q):
        rows = qt * TILE + torch.arange(TILE)
        m = torch.full((batch, q_heads, TILE), -1e30)
        l = torch.zeros((batch, q_heads, TILE))
        o = torch.zeros((batch, q_heads, TILE, d))
        # a causal q tile stops at the last key tile its rows reach
        for j in range(min(n_k, (qt + 1) * TILE // bn) if causal else n_k):
            x = qs[:, :, qt] @ ks[:, :, j].transpose(-1, -2) * scale_log2
            cols = j * bn + torch.arange(bn)
            masked = (cols >= s)[None, :].expand(TILE, bn)
            if causal:
                masked = masked | (cols[None, :] > rows[:, None])
            x = x.masked_fill(masked, -1e30)
            m_new = torch.maximum(m, x.amax(-1))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(x - m_new[..., None])
            l = l * alpha + p.sum(-1)
            o = o * alpha[..., None] + p.bfloat16().float() @ vs[:, :, j]
            m = m_new
        l = torch.clamp(l, min=1e-30)
        out[:, :, qt] = o / l[..., None]
        lse[:, :, qt] = (m + torch.log2(l)) * LN2
    out = out.reshape(batch, q_heads, n_q * TILE, d)[:, :, :t]
    out = out.permute(0, 2, 1, 3).to(torch.bfloat16)
    if with_lse:
        return out, lse.reshape(batch, q_heads, n_q * TILE)[:, :, :t]
    return out


def backward_kernel_model(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          out: torch.Tensor, lse: torch.Tensor,
                          d_out: torch.Tensor, causal: bool):
    """The backward kernel's arithmetic: (dq, dk, dv) in bf16 from bf16
    values of q, k, v, d_out and the forward's out, and its f32 lse."""
    batch, t, q_heads, d = q.shape
    s, kv_heads = k.shape[1], k.shape[2]
    group = q_heads // kv_heads
    scale = torch.tensor(d ** -0.5, dtype=torch.float32)
    scale_log2 = scale * torch.tensor(LOG2E, dtype=torch.float32)
    heads = lambda x: x.float().permute(0, 2, 1, 3)            # [B, H, L, D]
    qh, doh = heads(q), heads(d_out)
    kh, vh = heads(k), heads(v)
    lse2 = lse.float() * torch.tensor(LOG2E, dtype=torch.float32)
    delta = (doh * heads(out)).sum(-1)                          # [B, QH, T]

    def probs(x, row_lse2, rows, cols):
        """P of scores x [..., rows, cols] (raw q.k) with the rows' lse in
        base 2, masked."""
        p = torch.exp2(x * scale_log2 - row_lse2[..., None])
        if causal:
            p = p.masked_fill(cols[None, :] > rows[:, None], 0.0)
        return p

    # dk and dv: a kv head's CTA walks its group's q heads, each over its
    # 64-row q tiles, accumulating in f32
    dk = torch.zeros((batch, kv_heads, s, d))
    dv = torch.zeros((batch, kv_heads, s, d))
    keys = torch.arange(s)
    for g in range(group):
        h = torch.arange(kv_heads) * group + g
        for q0 in range(0, t, 64):
            rows = q0 + torch.arange(64)
            qt, dot = qh[:, h][:, :, rows], doh[:, h][:, :, rows]
            p = probs(qt @ kh.transpose(-1, -2), lse2[:, h][:, :, rows], rows,
                      keys)                                 # [B, KH, 64, S]
            ds = p * (dot @ vh.transpose(-1, -2)
                      - delta[:, h][:, :, rows, None])
            dv += p.bfloat16().float().transpose(-1, -2) @ dot
            dk += ds.bfloat16().float().transpose(-1, -2) @ qt
    # dq: a q tile's CTA walks the key tiles
    bn = 32 if d == 256 else 64
    ke, ve = (x.repeat_interleave(group, dim=1) for x in (kh, vh))
    rows = torch.arange(t)
    dq = torch.zeros((batch, q_heads, t, d))
    for k0 in range(0, s, bn):
        cols = k0 + torch.arange(bn)
        p = probs(qh @ ke[:, :, cols].transpose(-1, -2), lse2, rows, cols)
        ds = p * (doh @ ve[:, :, cols].transpose(-1, -2) - delta[..., None])
        dq += ds.bfloat16().float() @ ke[:, :, cols]
    back = lambda x: x.permute(0, 2, 1, 3).to(torch.bfloat16)
    return back(dq * scale), back(dk * scale), back(dv)


def _bf16_values(rng, shape) -> np.ndarray:
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return x.bfloat16().float().numpy()


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("t", [256, 320])
def test_kernel_model_within_chip_tolerance_of_twin_and_jax(t, d, causal):
    rng = np.random.default_rng(1000 + t + d + int(causal))
    q = _bf16_values(rng, (2, t, 8, d))
    k = _bf16_values(rng, (2, t, 2, d))
    v = _bf16_values(rng, (2, t, 2, d))
    block = math.gcd(t, TILE)               # the JAX kernel's blocks divide T
    want = np.array(jattn.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        block_q=block, block_k=block, interpret=True))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    np.testing.assert_allclose(tattn.xla_attention(tq, tk, tv, causal).numpy(),
                               want, atol=ATOL, rtol=0)

    got = kernel_model(tq, tk, tv, causal).float()
    bf = [x.bfloat16() for x in (tq, tk, tv)]
    twin = tattn.xla_attention(*bf, causal=causal).float()
    for ref in (twin, torch.from_numpy(want)):
        limit = chip_smoke.flash_limit(ref, tv, 8, causal)
        err = (got - ref).abs()
        assert bool((err <= limit).all()), float((err - limit).max())
    # the model is not the twin: the bf16 probabilities move some outputs
    assert float((got - twin).abs().max()) > 0



def _jax_lse(q, k, causal: bool) -> np.ndarray:
    """Each row's log-sum-exp of the JAX ``xla_attention`` scores (its
    expansion, f32 scaling and mask), taken with jax: [B, QH, T]."""
    k = jattn._expand_gqa(jnp.asarray(k), q.shape[2])
    logits = jnp.einsum("bthd,bshd->bhts",
                        jnp.asarray(q) * q.shape[-1] ** -0.5, k)
    if causal:
        t, s = q.shape[1], k.shape[1]
        mask = jnp.arange(s)[None, :] <= jnp.arange(t)[:, None]
        logits = jnp.where(mask[None, None], logits, jattn.NEG_INF)
    return np.asarray(jax.nn.logsumexp(logits, axis=-1))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("s", [128, 256])
def test_lse_twin_matches_jax_logsumexp_of_the_scores(s, d, causal):
    rng = np.random.default_rng(2000 + s + d + int(causal))
    q = rng.standard_normal((2, 128, 8, d), np.float32)
    k, v = (rng.standard_normal((2, s, 2, d), np.float32) for _ in range(2))
    out, lse = tattn.xla_attention_lse(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=causal)
    assert lse.shape == (2, 8, 128) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), _jax_lse(q, k, causal),
                               atol=1e-5, rtol=0)
    assert torch.equal(out, tattn.xla_attention(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=causal))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("t", [256, 320])
def test_backward_model_within_chip_tolerance_of_jax_grad(t, d, causal):
    group = 4
    rng = np.random.default_rng(3000 + t + d + int(causal))
    q = _bf16_values(rng, (2, t, 8, d))
    k = _bf16_values(rng, (2, t, 2, d))
    v = _bf16_values(rng, (2, t, 2, d))
    d_out = _bf16_values(rng, (2, t, 8, d))

    def jloss(q, k, v):
        return jnp.sum(jattn.xla_attention(q, k, v, causal=causal) * d_out)

    exact = [torch.from_numpy(np.array(g))
             for g in jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)]
    bf = [torch.from_numpy(x).bfloat16() for x in (q, k, v, d_out)]
    leaves = [x.clone().requires_grad_(True) for x in bf[:3]]
    through_twin = torch.autograd.grad(
        tattn.xla_attention(*leaves, causal=causal), leaves, bf[3])

    out, lse = kernel_model(*bf[:3], causal, with_lse=True)
    got = backward_kernel_model(*bf[:3], out, lse, bf[3], causal)
    for ref in (exact, through_twin):
        for name, g, w in zip(("dq", "dk", "dv"), got, ref):
            w = w.float()
            limit = chip_smoke.grad_limit(w, 1 if name == "dq" else group)
            err = (g.float() - w).abs()
            assert bool((err <= limit).all()), (name,
                                                float((err - limit).max()))
    twin = tattn.xla_attention_backward(*bf[:3], out, lse, bf[3], causal)
    terms = chip_smoke.backward_terms(*bf[:3], out, lse, bf[3], causal)
    for name, g, w, term in zip(("dq", "dk", "dv"), got, twin, terms):
        w = w.float()
        err = (g.float() - w).abs()
        limit = chip_smoke.backward_limit(w, term)
        assert bool((err <= limit).all()), (name, float((err - limit).max()))
    # the model is not the twin: the bf16 P and dS move some entries
    assert any(float((g.float() - w.float()).abs().max()) > 0
               for g, w in zip(got, twin))
