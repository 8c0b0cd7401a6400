"""The split-KV design of the port's decode kernels, on the CPU.

- ``split_plan``: its splits cover every position of a sequence's table
  once, it is a function of the shapes alone, and it gives every SM at
  least one CTA at the engine's shapes, llama's eight kv heads and
  gemma-2b's one (where a split cuts a block); the launchers' partials
  buffer has the plan's size.
- ``merge_partials``, the combine kernel's plain twin: each split's
  ``(m, l, acc)`` computed in f32 from the densified pool, cut at the
  plan's boundaries, then merged, against ``xla_paged_decode_attention``
  and the JAX ``paged_decode_attention`` / ``paged_decode_attention_quant``
  in interpret mode (f32, ``atol=2e-5``, the JAX suite's tolerance for
  those kernels: every side sums in f32, in different orders), for a bf16
  pool and an int8 pool with scales; and with 64-position splits inside
  128-position blocks against those twins and kernels and the JAX
  ``ragged_decode_attention``.
"""

import inspect
import itertools
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu9.ops import paged_attention as jpaged
from tpu9.ops import quant as jquant
from tpu9_torch.ops import paged_attention as tpaged

torch.set_num_threads(2)

ATOL = 2e-5
H100_SMS = 132
BS, MB, KH, QH, D = 16, 24, 2, 8, 64
# lengths 1, BS-1, BS, BS+1, a full table, and 200 positions, which hold
# fewer splits than the full table beside them at every plan below
LENS = [1, BS - 1, BS, BS + 1, MB * BS, 200]


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


# (batch, kv heads): llama's B=8 and B=1, gemma-7b's, gemma-2b's, a
# verify window's B*T rows
PLAN_HEADS = ((8, 8), (1, 8), (8, 16), (8, 1), (1, 1), (72, 8))


@pytest.mark.parametrize("max_blocks,block_s", [
    (17, 128),              # the paged engine
    (16, 128),
    (8, 256),               # the contiguous cache
    (1, 128),
    (129, 16),
    (24, 16),
    (7, 1024),
    (128, 16),
    (33, 64),
])
def test_split_plan_covers_every_block_once(max_blocks, block_s):
    """Every position of the table, and so every block, in exactly one
    split, no split empty, whole 64-position tiles, the int8 pool's no
    longer than ``INT8_SPLIT_MAX``, and a grid the card takes, at every
    (batch, kv heads) of ``PLAN_HEADS``, bf16 and int8."""
    positions = max_blocks * block_s
    for (batch, kv_heads), int8 in itertools.product(PLAN_HEADS,
                                                     (False, True)):
        n_splits, tokens = tpaged.split_plan(batch, kv_heads, max_blocks,
                                             block_s, int8)
        spans = [range(s * tokens, min((s + 1) * tokens, positions))
                 for s in range(n_splits)]
        assert all(spans), "a split owns no position"
        assert [p for span in spans for p in span] == list(range(positions))
        assert tokens % 64 == 0 and tokens in tpaged.SPLIT_CHOICES
        assert not int8 or tokens <= tpaged.INT8_SPLIT_MAX
        assert n_splits <= 65535


def test_split_plan_fills_the_card_at_the_engine_shapes():
    """At least one CTA per SM at B=8. llama's eight kv heads take 256
    positions a split from the bf16 pool (two 128-position blocks; MB=17,
    BS=128) and the contiguous cache (one 256-position block; MB=8,
    BS=256), and 128 from the int8 pool. gemma-2b's one kv head cuts each
    128-position block into two 64-position splits, in either pool."""
    for max_blocks, block_s, int8, tokens in ((17, 128, False, 256),
                                              (17, 128, True, 128),
                                              (8, 256, False, 256)):
        n_splits, got = tpaged.split_plan(8, 8, max_blocks, block_s, int8)
        assert got == tokens and n_splits == -(-max_blocks * block_s
                                                // tokens)
        assert 8 * 8 * n_splits >= H100_SMS
    for int8 in (False, True):
        n_splits, tokens = tpaged.split_plan(8, 1, 17, 128, int8)
        assert (n_splits, tokens) == (34, 64)
        assert 8 * 1 * n_splits >= H100_SMS


def _record_launches(monkeypatch):
    """Replace the kernels' C entries by a recorder of their arguments."""
    calls = []

    def entry(instance):
        def record(*args):
            calls.append((instance, args))
            return 0
        return record
    monkeypatch.setattr(tpaged, "_kernel_fn", entry)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: types.SimpleNamespace(cuda_stream=0))
    return calls


def test_split_plan_reads_no_lengths(monkeypatch):
    """The plan takes no length, and the launcher hands the kernel the same
    grid for any ``cache_len``: it reads none of them on the host."""
    assert "cache_len" not in inspect.signature(tpaged.split_plan).parameters
    calls = _record_launches(monkeypatch)
    q = torch.zeros((8, 1, 32, 128), dtype=torch.bfloat16)
    pool = torch.zeros((20, 128, 8, 128), dtype=torch.bfloat16)
    qpool = torch.zeros((20, 128, 8, 128), dtype=torch.int8)
    scale = torch.zeros((20, 128, 8), dtype=torch.float32)
    cache = torch.zeros((8, 2048, 8, 128), dtype=torch.bfloat16)
    table = torch.zeros((8, 17), dtype=torch.int32)
    for lens in ([1] * 8, [2048] * 8, [0, 5, 128, 129, 2000, 7, 300, 1]):
        clen = torch.tensor(lens, dtype=torch.int32)
        tpaged._launch(q, pool, pool, table, clen)
        tpaged._launch(q, qpool, qpool, table, clen, scale, scale)
        tpaged._launch_ragged(q, cache, cache, clen, 256)
    for instance, (symbol, n_ptrs) in tpaged._ENTRIES.items():
        ints = {args[n_ptrs:n_ptrs + 8] for name, args in calls
                if name == instance}
        assert len(ints) == 1, (instance, ints)
        (shape,) = ints
        # batch, q_heads, kv_heads, head_dim, block_s, columns, the plan
        max_blocks = 2048 // 256 if instance == "ragged" else 17
        assert shape[-2:] == tpaged.split_plan(shape[0], shape[2],
                                               max_blocks, shape[4],
                                               instance == "int8")
        assert all(len(args) == n_ptrs + 10 for name, args in calls
                   if name == instance)


@pytest.mark.parametrize("batch,q_heads,head_dim,max_blocks,block_s", [
    (8, 32, 128, 17, 128),      # the paged engine
    (8, 32, 128, 8, 256),       # the contiguous cache
    (1, 8, 64, 24, 16),
])
def test_partials_buffer_holds_the_plan(monkeypatch, batch, q_heads,
                                        head_dim, max_blocks, block_s):
    """The launchers allocate one f32 buffer of B*QH*NS*(D+2) for the
    partials: the accumulators first, the (max, sum) pairs right after,
    and hand the kernels those two addresses last among the pointers."""
    q = torch.zeros((batch, 1, q_heads, head_dim), dtype=torch.bfloat16)
    kv_heads = q_heads // 4
    n_splits, tokens = tpaged.split_plan(batch, kv_heads, max_blocks,
                                         block_s)
    got_ns, got_tokens, scratch, (acc, ml) = tpaged._plan_and_scratch(
        q, kv_heads, max_blocks, block_s)
    rows = batch * q_heads * n_splits
    assert (got_ns, got_tokens) == (n_splits, tokens)
    assert scratch.dtype == torch.float32
    assert scratch.shape == (rows * (head_dim + 2),)
    assert acc == scratch.data_ptr() and ml == acc + 4 * rows * head_dim
    calls = _record_launches(monkeypatch)
    pool = torch.zeros((3, block_s, kv_heads, head_dim),
                       dtype=torch.bfloat16)
    table = torch.zeros((batch, max_blocks), dtype=torch.int32)
    tpaged._launch(q, pool, pool, table, torch.ones((batch,),
                                                    dtype=torch.int32))
    (_, args), = calls
    acc_ptr, ml_ptr = args[tpaged._ENTRIES["bf16"][1] - 2:
                           tpaged._ENTRIES["bf16"][1]]
    assert ml_ptr - acc_ptr == 4 * rows * head_dim


# -- the combine pass's twin ---------------------------------------------------

def _case(kind: str, block_s: int = BS, max_blocks: int = MB,
          heads=(QH, KH), lens=LENS, seed: int = 40):
    """A case on ``lens``: a pool ("bf16", "int8") with each sequence on
    its own distinct blocks and every table entry past a prefix naming a
    block of large finite garbage, or a contiguous cache ("ragged") whose
    positions past each length hold garbage. The bf16 values are stored
    in f32 for the JAX interpreter; the int8 pool is quantized by the JAX
    ``quantize_kv``."""
    quant = kind == "int8"
    rng = np.random.default_rng(seed + quant)
    q_heads, kv_heads = heads
    q = rng.standard_normal((len(lens), 1, q_heads, D)).astype(np.float32)
    lens_arr = np.array(lens, np.int32)

    def bf16(a):
        return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
    if kind == "ragged":
        shape = (len(lens), max_blocks * block_s, kv_heads, D)
        k, v = (bf16(rng.standard_normal(shape)) for _ in range(2))
        for b, n in enumerate(lens):
            k[b, n:], v[b, n:] = 1e3, -1e3
        return dict(q=q, k=k, v=v, lens=lens_arr)
    need = [_ceil(n, block_s) for n in lens]
    n_real, n_garbage = sum(need), 3
    table = np.empty((len(lens), max_blocks), np.int32)
    perm = rng.permutation(n_real)
    used = 0
    for i, nb in enumerate(need):
        table[i, :nb] = perm[used:used + nb]
        table[i, nb:] = rng.integers(n_real, n_real + n_garbage,
                                     max_blocks - nb)
        used += nb
    shape = (n_real + n_garbage, block_s, kv_heads, D)
    k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    if not quant:
        k, v = bf16(k), bf16(v)
        k[n_real:], v[n_real:] = 1e3, -1e3
        return dict(q=q, k=k, v=v, table=table, lens=lens_arr)
    (kq, ks), (vq, vs) = ((np.array(x) for x in jquant.quantize_kv(
        jnp.asarray(a))) for a in (k, v))
    kq[n_real:], vq[n_real:] = 127, 127
    ks[n_real:], vs[n_real:] = 1e3, 1e3
    return dict(q=q, k=kq, v=vq, ks=ks, vs=vs, table=table, lens=lens_arr)


def _split_partials(case, n_splits: int, tokens: int):
    """Each split's running max, sum and unnormalised output, in f32, from
    the densified (dequantized) cache cut at the plan's boundaries of
    ``tokens`` positions; the splits that hold no position are NaN, which
    the merge must not read. A case without a table is a contiguous
    cache."""
    t = {n: torch.from_numpy(a) for n, a in case.items()}
    if "table" in t:
        k = tpaged.gather_paged(t["k"], t["table"], t.get("ks"),
                                torch.float32)
        v = tpaged.gather_paged(t["v"], t["table"], t.get("vs"),
                                torch.float32)
    else:
        k, v = t["k"], t["v"]
    lens = case["lens"].tolist()
    q_heads, kv_heads, d = t["q"].shape[2], k.shape[2], k.shape[3]
    group = q_heads // kv_heads
    k = k.repeat_interleave(group, dim=2)                  # [B, S, QH, D]
    v = v.repeat_interleave(group, dim=2)
    q = t["q"][:, 0] * d ** -0.5                           # [B, QH, D]
    b = q.shape[0]
    m = torch.full((b, q_heads, n_splits), float("nan"))
    l, acc = torch.full_like(m, float("nan")), torch.full(
        (b, q_heads, n_splits, d), float("nan"))
    span = tokens
    for i, n in enumerate(lens):
        for s in range(n_splits):
            lo, hi = s * span, min((s + 1) * span, n)
            if lo >= hi:
                continue
            logits = torch.einsum("hd,thd->ht", q[i], k[i, lo:hi])
            m[i, :, s] = logits.amax(-1)
            p = torch.exp(logits - m[i, :, s, None])
            l[i, :, s] = p.sum(-1)
            acc[i, :, s] = torch.einsum("ht,thd->hd", p, v[i, lo:hi])
    return m, l, acc


@pytest.fixture(scope="module", params=[False, True], ids=["bf16", "int8"])
def pool_case(request):
    """A case and its two references: the port's twin and the JAX kernel
    in interpret mode."""
    case = _case("int8" if request.param else "bf16")
    t = {n: torch.from_numpy(a) for n, a in case.items()}
    twin = tpaged.xla_paged_decode_attention(
        t["q"], t["k"], t["v"], t["table"], t["lens"], t.get("ks"),
        t.get("vs"))
    j = {n: jnp.asarray(a) for n, a in case.items()}
    if request.param:
        jax_out = jpaged.paged_decode_attention_quant(
            j["q"], j["k"], j["v"], j["ks"], j["vs"], j["table"], j["lens"],
            interpret=True)
    else:
        jax_out = jpaged.paged_decode_attention(
            j["q"], j["k"], j["v"], j["table"], j["lens"], interpret=True)
    return case, twin, np.asarray(jax_out)


@pytest.mark.parametrize("split_tokens", [16, 32, 128])
def test_merged_partials_match_the_twin_and_jax(pool_case, monkeypatch,
                                                split_tokens):
    """One, two and eight blocks a split (24, 12 and 3 splits), the plan
    given that one choice."""
    case, twin, jax_out = pool_case
    monkeypatch.setattr(tpaged, "SPLIT_CHOICES", (split_tokens,))
    n_splits, tokens = tpaged.split_plan(len(LENS), KH, MB, BS)
    assert tokens == split_tokens
    used = [_ceil(n, tokens) for n in LENS]
    assert used[-1] < used[-2] == n_splits      # fewer than its neighbour
    m, l, acc = _split_partials(case, n_splits, tokens)
    got = tpaged.merge_partials(m, l, acc, torch.from_numpy(case["lens"]),
                                tokens)
    assert got.shape == twin.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), twin.numpy(), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), jax_out, atol=ATOL, rtol=0)


def test_one_split_is_the_normalised_accumulator(pool_case):
    """A plan of one split gives acc / l, as the one-CTA kernel did, and a
    length of 0 merges nothing and gives zeros."""
    case, twin, _ = pool_case
    m, l, acc = _split_partials(case, 1, MB * BS)
    lens = torch.from_numpy(case["lens"])
    got = tpaged.merge_partials(m, l, acc, lens, MB * BS)
    np.testing.assert_allclose(got[:, 0].numpy(),
                               (acc / l[..., None])[:, :, 0].numpy(),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), twin.numpy(), atol=ATOL, rtol=0)
    zero = tpaged.merge_partials(m, l, acc, torch.zeros_like(lens), MB * BS)
    assert torch.equal(zero, torch.zeros_like(zero))


# -- splits inside a block -----------------------------------------------------

BLOCK_BS, BLOCK_MB, BLOCK_HEADS = 128, 5, (8, 1)       # gemma-2b's group
BLOCK_LENS = [1, 63, 64, 65, 127, 129, 300, 640]


@pytest.mark.parametrize("kind", ["bf16", "int8", "ragged"])
def test_merged_partials_inside_a_block_match_the_twins_and_jax(kind):
    """gemma-2b's one kv head at B=8: the plan's 64-position splits cut
    every 128-position block in two (a split ends inside a block at
    lengths 63, 65, 127 and 129); merged, they match the twin and the JAX
    kernel in interpret mode."""
    c = _case(kind, BLOCK_BS, BLOCK_MB, BLOCK_HEADS, BLOCK_LENS, seed=60)
    n_splits, tokens = tpaged.split_plan(len(BLOCK_LENS), BLOCK_HEADS[1],
                                         BLOCK_MB, BLOCK_BS)
    assert (n_splits, tokens) == (10, 64)
    t = {n: torch.from_numpy(a) for n, a in c.items()}
    j = {n: jnp.asarray(a) for n, a in c.items()}
    if kind == "ragged":
        from tpu9_torch.ops.attention import xla_decode_attention
        twin = xla_decode_attention(t["q"], t["k"], t["v"], t["lens"])
        jax_out = jpaged.ragged_decode_attention(
            j["q"], j["k"], j["v"], j["lens"], block_s=BLOCK_BS,
            interpret=True)
    else:
        twin = tpaged.xla_paged_decode_attention(
            t["q"], t["k"], t["v"], t["table"], t["lens"], t.get("ks"),
            t.get("vs"))
        if kind == "int8":
            jax_out = jpaged.paged_decode_attention_quant(
                j["q"], j["k"], j["v"], j["ks"], j["vs"], j["table"],
                j["lens"], interpret=True)
        else:
            jax_out = jpaged.paged_decode_attention(
                j["q"], j["k"], j["v"], j["table"], j["lens"],
                interpret=True)
    m, l, acc = _split_partials(c, n_splits, tokens)
    got = tpaged.merge_partials(m, l, acc, t["lens"], tokens)
    np.testing.assert_allclose(got.numpy(), twin.numpy(), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_out), atol=ATOL,
                               rtol=0)
