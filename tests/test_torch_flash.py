"""The numerics of the Hopper flash kernel (``tpu9_torch/csrc/flash_attention.cu``)
on the CPU, where the kernel cannot run.

``kernel_model`` repeats the kernel's arithmetic in PyTorch: 128-row q
units over 128-key k/v tiles (64-key at D = 256), zero-filled past T and S
as TMA fills them; at D = 256, where 128-row units would leave the card's
SMs idle (``split_keys``), 64-row units whose two consumers walk the even
and the odd key tiles apart and merge their row max, sum and output at the end (each
partial scaled by 2^(m_c - m)); scores in f32, scaled by ``D^-0.5 *
log2(e)`` for ``exp2``; keys past S and, when causal, keys past the row
masked to -1e30 (the kernel masks only the tiles that cross the diagonal
or S, where the mask can be true); each consumer's 64 rows stop at the
last tile they reach (a tile wholly above them is skipped, which changes
no bit: its probabilities would be 0 and its factor 1); f32 running max,
sum and accumulator; each probability rounded to bf16 for the PV product;
the row sum floored at 1e-30 and the output rounded to bf16.

On the same inputs made from a seed (bf16 values; B=2, GQA 4, T = S = 256
and 320, which is a multiple of 64 and not of 128; D 64, 128 and 256; causal
and not; and at D = 256 both of its paths at gemma-2b's 8/1 heads, T = S =
128 and 320), the JAX Pallas ``flash_attention`` in interpret mode is the
reference: the port's twin ``xla_attention`` matches it in f32 at
``atol=2e-5``, and the model stays within ``chip_smoke.flash_limit`` of the
twin, the tolerance ``chip_smoke.py`` holds the kernel to on the card, and
its row log-sum-exp within ``chip_smoke.lse_limit`` of the twin's
(``xla_attention_lse``). So those tolerances hold for this design by
construction.

The backward kernel (``tpu9_torch/csrc/flash_attention_backward.cu``)
likewise: ``backward_kernel_model`` repeats its arithmetic from the model
forward's output and row log-sum-exp (``kernel_model(..., with_lse=True)``,
the kernel's ``(m + log2 l) ln 2``): delta = rowsum(d_out * out) from the
bf16 out in f32; P = exp2(x * scale log2(e) - lse log2(e)) in f32 with the
mask; dS = P (dP - delta); P and dS rounded to bf16 before the products
dV = P^T dO, dK = dS^T Q (summed over 64-row q tiles, a kv head's group of
q heads one after another, as a CTA walks them) and dQ = dS K (summed
over the dq kernel's key tiles in order: 64 keys, 32 at D = 256), each in
f32, scaled and rounded to bf16 once. At the same shapes it stays within
``chip_smoke.grad_limit`` of ``jax.grad`` of the JAX ``xla_attention`` and
of autograd through the port's twin on bf16 leaves (the two references the
card's check has: the first exact, the second what the card compares
with), and within ``chip_smoke.backward_limit`` of the backward's twin
``xla_attention_backward`` on the same out and lse. The twin of the
forward's statistics, ``xla_attention_lse``, matches a log-sum-exp of the
JAX ``xla_attention`` scores taken with jax at ``atol=1e-5``. Summed over
the key tiles in any other order (ascending, descending, drawn from a
seed), dq stays within both limits, and two orders differ by f32 rounding
alone: within 1e-5 of the twin's largest entry. So the tolerances do not
rest on the kernel's order of the sum.
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

TILE = 128                    # q rows of a unit
SMS = 132                     # the H100's SMs: the wrapper's choice of units reads them


def key_tile(d: int) -> int:
    """Keys of a k/v tile: 64 at D = 256 (the q tile and two stages of
    128-key k and v tiles would not fit in shared memory), else 128."""
    return 64 if d == 256 else 128


def split_keys(batch: int, t: int, q_heads: int, d: int,
               causal: bool) -> bool:
    """The wrapper's choice of the split-key units on an H100."""
    return tattn.flash_split_keys(batch, t, q_heads, d, causal, SMS)


ATOL = 2e-5
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453


def kernel_model(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 causal: bool, with_lse: bool = False, split=None):
    """The kernel's arithmetic. q [B,T,QH,D], k/v [B,S,KH,D] holding bf16
    values (any float dtype); returns [B,T,QH,D] in bf16, and with
    ``with_lse`` also each row's log-sum-exp [B, QH, T] f32 as the kernel
    writes it, (m + log2 l) ln 2 of the base-2 max and sum. ``split``
    (default: the wrapper's choice, ``split_keys``) takes the 64-row units
    whose two consumers walk the even and the odd key tiles apart and merge
    their max, sum and output at the end; D = 256 only.

    Each consumer's 64 rows walk the key tiles in order from the first,
    causal up to the last tile their rows reach (at 64 keys a tile,
    consumer 0 of a 128-row unit stops a tile before consumer 1: a tile
    wholly above the diagonal is skipped; at 128 keys it is not there to
    skip)."""
    batch, t, q_heads, d = q.shape
    s, kv_heads = k.shape[1], k.shape[2]
    group = q_heads // kv_heads
    bn = key_tile(d)
    if split is None:
        split = split_keys(batch, t, q_heads, d, causal)
    assert not split or d == 256
    scale_log2 = torch.tensor(d ** -0.5, dtype=torch.float32) * torch.tensor(
        LOG2E, dtype=torch.float32)
    heads = lambda x: x.float().permute(0, 2, 1, 3)            # [B, H, L, D]
    qh = heads(q)
    n_k = -(-s // bn)
    # zero-filled past S as TMA fills the last tile
    kh, vh = (torch.nn.functional.pad(heads(x), (0, 0, 0, n_k * bn - s))
              .repeat_interleave(group, dim=1) for x in (k, v))

    def walk(qb, tiles):
        """Online softmax of q rows [64 qb, 64 qb + 64) over ``tiles``:
        the row max m (base 2, scaled), sum l and unnormalised output o."""
        rows = 64 * qb + torch.arange(64)
        m = torch.full((batch, q_heads, 64), -1e30)
        l = torch.zeros((batch, q_heads, 64))
        o = torch.zeros((batch, q_heads, 64, d))
        for j in tiles:
            cols = j * bn + torch.arange(bn)
            x = qh[:, :, rows] @ kh[:, :, cols].transpose(-1, -2) * scale_log2
            masked = (cols >= s)[None, :].expand(64, bn)
            if causal:
                masked = masked | (cols[None, :] > rows[:, None])
            x = x.masked_fill(masked, -1e30)
            m_new = torch.maximum(m, x.amax(-1))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(x - m_new[..., None])
            l = l * alpha + p.sum(-1)
            o = o * alpha[..., None] + p.bfloat16().float() @ vh[:, :, cols]
            m = m_new
        return m, l, o

    out = torch.empty((batch, q_heads, t, d), dtype=torch.float32)
    lse = torch.empty((batch, q_heads, t), dtype=torch.float32)
    for qb in range(t // 64):
        # the tiles these rows walk: up to the last their rows reach
        n = min(n_k, -(-64 * (qb + 1) // bn)) if causal else n_k
        if split:
            m, l, o = walk(qb, range(0, n, 2))
            if n > 1:
                m1, l1, o1 = walk(qb, range(1, n, 2))
                mx = torch.maximum(m, m1)
                a0, a1 = torch.exp2(m - mx), torch.exp2(m1 - mx)
                l = l * a0 + l1 * a1
                o = o * a0[..., None] + o1 * a1[..., None]
                m = mx
        else:
            m, l, o = walk(qb, range(n))
        l = torch.clamp(l, min=1e-30)
        out[:, :, 64 * qb:64 * qb + 64] = o / l[..., None]
        lse[:, :, 64 * qb:64 * qb + 64] = (m + torch.log2(l)) * LN2
    out = out.permute(0, 2, 1, 3).to(torch.bfloat16)
    return (out, lse) if with_lse else out


def backward_kernel_model(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          out: torch.Tensor, lse: torch.Tensor,
                          d_out: torch.Tensor, causal: bool,
                          key_order=None, dq_sum: bool = False):
    """The backward kernel's arithmetic: (dq, dk, dv) in bf16 from bf16
    values of q, k, v, d_out and the forward's out, and its f32 lse.
    ``key_order`` lists the dq kernel's key tiles (``dq_key_tile(d)``
    keys each) in the order dq sums them (default ascending, the
    kernel's); with ``dq_sum`` dq is returned as its f32 sum before the
    scale and the rounding."""
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
    bn = dq_key_tile(d)
    ke, ve = (x.repeat_interleave(group, dim=1) for x in (kh, vh))
    rows = torch.arange(t)
    dq = torch.zeros((batch, q_heads, t, d))
    for kt in (range(s // bn) if key_order is None else key_order):
        cols = kt * bn + torch.arange(bn)
        p = probs(qh @ ke[:, :, cols].transpose(-1, -2), lse2, rows, cols)
        ds = p * (doh @ ve[:, :, cols].transpose(-1, -2) - delta[..., None])
        dq += ds.bfloat16().float() @ ke[:, :, cols]
    back = lambda x: x.permute(0, 2, 1, 3).to(torch.bfloat16)
    if dq_sum:
        return dq.permute(0, 2, 1, 3), back(dk * scale), back(dv)
    return back(dq * scale), back(dk * scale), back(dv)


def dq_key_tile(d: int) -> int:
    """Keys of a dq kernel ring stage: 32 at D = 256 (the 128-row q and
    d_out tiles and two stages of 64-key k and v would pass 227 KB), else
    64."""
    return 32 if d == 256 else 64


def key_orders(n_tiles: int, seed: int) -> dict:
    """Orders of dq's f32 sum over ``n_tiles`` key tiles: the kernel's
    (``None``, ascending), descending, the odd tiles before the even, and
    one drawn from a seed."""
    return {"kernel": None,
            "descending": list(range(n_tiles))[::-1],
            "odd_first": list(range(1, n_tiles, 2)) + list(range(0, n_tiles, 2)),
            "shuffled": [int(i) for i in
                         np.random.default_rng(seed).permutation(n_tiles)]}


def _bf16_values(rng, shape) -> np.ndarray:
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return x.bfloat16().float().numpy()


def _check_forward_model(heads, t: int, d: int, causal: bool, seed: int,
                         split=None) -> None:
    """The model (``split``: its path at D = 256, default the kernel's
    choice) within ``flash_limit`` of the twin and of the JAX kernel in
    interpret mode, and its lse within ``lse_limit`` of the twin's."""
    q_heads, kv_heads = heads
    rng = np.random.default_rng(seed)
    q = _bf16_values(rng, (2, t, q_heads, d))
    k = _bf16_values(rng, (2, t, kv_heads, d))
    v = _bf16_values(rng, (2, t, kv_heads, d))
    block = math.gcd(t, TILE)               # the JAX kernel's blocks divide T
    want = np.array(jattn.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        block_q=block, block_k=block, interpret=True))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    np.testing.assert_allclose(tattn.xla_attention(tq, tk, tv, causal).numpy(),
                               want, atol=ATOL, rtol=0)

    got, lse = kernel_model(tq, tk, tv, causal, with_lse=True, split=split)
    got = got.float()
    bf = [x.bfloat16() for x in (tq, tk, tv)]
    twin, twin_lse = tattn.xla_attention_lse(*bf, causal=causal)
    twin = twin.float()
    for ref in (twin, torch.from_numpy(want)):
        limit = chip_smoke.flash_limit(ref, tv, q_heads, causal)
        err = (got - ref).abs()
        assert bool((err <= limit).all()), float((err - limit).max())
    err = (lse - twin_lse).abs()
    limit = chip_smoke.lse_limit(twin_lse, t)
    assert bool((err <= limit).all()), float((err - limit).max())
    # the model is not the twin: the bf16 probabilities move some outputs
    assert float((got - twin).abs().max()) > 0


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("t", [256, 320])
def test_kernel_model_within_chip_tolerance_of_twin_and_jax(t, d, causal):
    _check_forward_model((8, 2), t, d, causal, 1000 + t + d + int(causal))


@pytest.mark.parametrize("split", [True, False])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t", [128, 320])
def test_d256_paths_within_chip_tolerance_of_twin_and_jax(t, causal, split):
    """Both of the D = 256 paths at gemma-2b's heads (8/1): 128-row units
    over 64-key tiles, consumer 0 skipping the tile above its rows, and
    64-row units whose consumers split the keys (one tile at a time for
    the first 64 rows, where consumer 1 has none)."""
    _check_forward_model((8, 1), t, 256, causal, 5000 + t + int(causal),
                         split)


def test_split_keys_follows_the_unit_count():
    """The wrapper's choice (``flash_split_keys``, which it passes to the
    kernel) at the served D = 256 shapes on an H100: the prefill
    buckets up to 512 (causal or not) and gemma-2b's causal 2048 split the
    keys; gemma-7b's 2048 bucket, its train shape and its tp=4 rank's
    (128 units of 4 q tiles: two waves of split units) take 128-row
    units."""
    assert all(split_keys(1, t, h, 256, causal) for t in (128, 512)
               for h in (16, 8) for causal in (True, False))
    assert split_keys(1, 2048, 8, 256, True)
    assert not split_keys(1, 2048, 8, 256, False)
    assert not split_keys(1, 2048, 16, 256, True)
    assert not split_keys(8, 512, 16, 256, True)
    assert not split_keys(8, 512, 4, 256, True)
    assert not split_keys(1, 128, 8, 128, True)


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


def _check_backward_model(t: int, d: int, causal: bool, order: str) -> None:
    """The backward model, its dq partials added in ``order``, within
    ``grad_limit`` of ``jax.grad`` of the JAX ``xla_attention`` and of
    autograd through the twin, and within ``backward_limit`` of the twin."""
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
    got = backward_kernel_model(*bf[:3], out, lse, bf[3], causal,
                                key_orders(t // dq_key_tile(d), t + d)[order])
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


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("t", [256, 320])
def test_backward_model_within_chip_tolerance_of_jax_grad(t, d, causal):
    _check_backward_model(t, d, causal, "kernel")


@pytest.mark.parametrize("order", ["descending", "odd_first", "shuffled"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_backward_model_any_key_tile_order_within_chip_tolerance(d, causal,
                                                                 order):
    """dq summed over the key tiles in another order than the kernel's
    (T = 320: five key tiles, ten at D = 256) stays within both limits."""
    _check_backward_model(320, d, causal, order)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_backward_model_key_tile_orders_agree_within_f32(d, causal):
    """Orders of dq's sum over the key tiles differ in f32 rounding alone:
    within 1e-5 of the twin's largest |dq|; dk and dv do not depend on
    it."""
    rng = np.random.default_rng(4000 + d + int(causal))
    q = _bf16_values(rng, (2, 320, 8, d))
    k = _bf16_values(rng, (2, 320, 2, d))
    v = _bf16_values(rng, (2, 320, 2, d))
    d_out = _bf16_values(rng, (2, 320, 8, d))
    bf = [torch.from_numpy(x).bfloat16() for x in (q, k, v, d_out)]
    out, lse = kernel_model(*bf[:3], causal, with_lse=True)
    orders = key_orders(320 // dq_key_tile(d), d)
    sums = {name: backward_kernel_model(*bf[:3], out, lse, bf[3], causal,
                                        order, dq_sum=True)
            for name, order in orders.items()}
    twin = tattn.xla_attention_backward(*bf[:3], out, lse, bf[3], causal)
    top = float(twin[0].float().abs().max()) / d ** -0.5   # before the scale
    base = sums["kernel"]
    for name in ("descending", "odd_first", "shuffled"):
        assert float((sums[name][0] - base[0]).abs().max()) <= 1e-5 * top
        assert torch.equal(sums[name][1], base[1])
        assert torch.equal(sums[name][2], base[2])
