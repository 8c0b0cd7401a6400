"""The port's ops (``tpu9_torch.ops``) against their ``tpu9.ops``
counterparts on the same numpy inputs, on the CPU.

The paged-decode dispatch takes the kernel's plain twin on a CPU tensor;
it is held against the JAX Pallas kernel run in interpret mode, as the JAX
package's own tests run it. Tolerance: f32 ``atol=2e-5``, as the JAX
package's kernel tests use (both sides sum in f32, in different orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu9.ops import attention as jattn
from tpu9.ops import norms as jnorms
from tpu9.ops import paged_attention as jpaged
from tpu9.ops import rotary as jrot
from tpu9.ops import sampling as jsamp
from tpu9_torch.ops import attention as tattn
from tpu9_torch.ops import norms as tnorms
from tpu9_torch.ops import paged_attention as tpaged
from tpu9_torch.ops import rotary as trot
from tpu9_torch.ops import sampling as tsamp

torch.set_num_threads(2)

ATOL = 2e-5


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(got: torch.Tensor, want, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                               rtol=0)


@pytest.mark.parametrize("offset", [0.0, 1.0])
def test_rms_norm_matches(offset):
    rng = np.random.default_rng(0)
    x = _rand(rng, (2, 5, 64), 3.0)
    w = _rand(rng, (64,))
    want = jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5, offset)
    got = tnorms.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5,
                          offset)
    _close(got, want)


@pytest.mark.parametrize("head_dim,theta", [(32, 500000.0), (64, 10000.0)])
def test_rope_table_and_apply_match(head_dim, theta):
    sin_j, cos_j = jrot.rope_table(96, head_dim, theta)
    sin_t, cos_t = trot.rope_table(96, head_dim, theta)
    # angles up to 95 rad: one f32 ulp of the angle moves sin by ~1e-5
    _close(sin_t, sin_j, atol=2e-5)
    _close(cos_t, cos_j, atol=2e-5)
    rng = np.random.default_rng(1)
    x = _rand(rng, (2, 7, 3, head_dim))
    pos = rng.integers(0, 96, (2, 7)).astype(np.int32)
    want = jrot.apply_rope(jnp.asarray(x), jnp.asarray(pos), sin_j, cos_j)
    got = trot.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                          sin_t, cos_t)
    _close(got, want, atol=1e-4)


def test_greedy_sampling_is_exact():
    rng = np.random.default_rng(2)
    logits = _rand(rng, (6, 300))
    logits[3, [10, 20]] = 50.0          # a tie: both take the first index
    want = np.asarray(jsamp.sample_logits(jnp.asarray(logits), None))
    got = tsamp.sample_logits(torch.from_numpy(logits))
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got[3]) == 10


@pytest.mark.parametrize("top_k,top_p", [(5, 1.0), (0, 0.5), (8, 0.9)])
def test_top_k_top_p_support_and_generator(top_k, top_p):
    """The draws cannot match ``jax.random``; the support can. Every draw
    lies in the filtered set, and one generator seed repeats its draws."""
    rng = np.random.default_rng(3)
    logits = torch.from_numpy(_rand(rng, (4, 64), 2.0))
    lf = logits.clone()
    if top_k:
        kth = torch.sort(lf, dim=-1).values[:, -top_k, None]
        lf = lf.masked_fill(lf < kth, float("-inf"))
    if top_p < 1.0:
        srt = torch.sort(lf, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(srt, -1), -1)
        cut = torch.gather(srt, -1, (cum < top_p).sum(-1, keepdim=True))
        lf = lf.masked_fill(lf < cut, float("-inf"))
    allowed = torch.isfinite(lf)
    draws = []
    for seed in (7, 7, 8):
        gen = torch.Generator().manual_seed(seed)
        draws.append(torch.stack([
            tsamp.sample_logits(logits, gen, temperature=0.8, top_k=top_k,
                                top_p=top_p) for _ in range(20)]))
    assert torch.equal(draws[0], draws[1])
    for d in draws:
        assert bool(allowed.gather(1, d.T).all())


@pytest.mark.parametrize("causal,kv_offset", [(True, 0), (True, 5),
                                              (False, 0)])
def test_xla_attention_matches(causal, kv_offset):
    rng = np.random.default_rng(4)
    q = _rand(rng, (2, 6, 4, 32))
    k = _rand(rng, (2, 11, 2, 32))
    v = _rand(rng, (2, 11, 2, 32))
    want = jattn.xla_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal, kv_offset)
    got = tattn.xla_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal, kv_offset)
    _close(got, want)


def test_chunk_prefill_attention_matches():
    rng = np.random.default_rng(5)
    b, c, s = 2, 8, 40
    q = _rand(rng, (b, c, 4, 32))
    k = _rand(rng, (b, s, 2, 32))
    v = _rand(rng, (b, s, 2, 32))
    # per-row chunk offsets; keys past each query are garbage the mask hides
    pos = (np.array([[0], [17]]) + np.arange(c)[None, :]).astype(np.int32)
    want = jattn.chunk_prefill_attention(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), jnp.asarray(pos))
    got = tattn.chunk_prefill_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(pos))
    _close(got, want)


def _paged_case(head_dim: int, block_s: int, seed: int):
    """GQA group 4, lengths 1, BS, BS+1 and the table's whole width; table
    entries past each prefix name blocks of large finite garbage."""
    rng = np.random.default_rng(seed)
    kv_heads, mb = 2, 4
    q_heads = 4 * kv_heads
    lens = np.array([1, block_s, block_s + 1, mb * block_s], np.int32)
    b = len(lens)
    need = [-(-int(n) // block_s) for n in lens]
    n_real = sum(need)
    n_garbage = 3
    n_blocks = n_real + n_garbage
    table = np.empty((b, mb), np.int32)
    perm = rng.permutation(n_real)
    used = 0
    for i, nb in enumerate(need):
        table[i, :nb] = perm[used:used + nb]
        table[i, nb:] = rng.integers(n_real, n_blocks, mb - nb)
        used += nb
    k = _rand(rng, (n_blocks, block_s, kv_heads, head_dim))
    v = _rand(rng, (n_blocks, block_s, kv_heads, head_dim))
    k[n_real:] = 1e3
    v[n_real:] = -1e3
    q = _rand(rng, (b, 1, q_heads, head_dim))
    return q, k, v, table, lens


@pytest.mark.parametrize("head_dim", [32, 64])
@pytest.mark.parametrize("block_s", [8, 16])
def test_paged_dispatch_matches_jax_kernel_interpret(head_dim, block_s):
    q, k, v, table, lens = _paged_case(head_dim, block_s, head_dim + block_s)
    want = jpaged.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(table),
        jnp.asarray(lens), interpret=True)
    before = tpaged.paged_decode_attention.launches
    got = tattn.paged_attention_dispatch(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(table), torch.from_numpy(lens))
    # a CPU tensor takes the plain twin: no kernel launch is counted
    assert tpaged.paged_decode_attention.launches == before
    assert got.shape == q.shape and got.dtype == torch.float32
    _close(got, want)


def test_paged_twin_matches_jax_twin():
    q, k, v, table, lens = _paged_case(32, 8, 9)
    want = jpaged.xla_paged_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(table),
        jnp.asarray(lens))
    got = tpaged.xla_paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(table), torch.from_numpy(lens))
    _close(got, want)
    dense = tpaged.gather_paged(torch.from_numpy(k), torch.from_numpy(table))
    want_dense = jpaged.gather_paged(jnp.asarray(k), jnp.asarray(table))
    np.testing.assert_array_equal(dense.numpy(), np.asarray(want_dense))


@pytest.mark.parametrize("what,change", [
    ("bf16", dict(dtype=torch.float32)),
    ("head_dim", dict(head_dim=32)),
    ("GQA group", dict(q_heads=48)),
    ("block size", dict(block_s=24)),
])
def test_kernel_wrapper_refuses_shapes_it_cannot_take(what, change):
    """The checks run before anything touches CUDA, so they are testable
    here: an operand the kernel has no instance for raises, never falls
    back to the twin."""
    shape = dict(dtype=torch.bfloat16, head_dim=128, q_heads=32, block_s=16)
    shape.update(change)
    d, dt = shape["head_dim"], shape["dtype"]
    q = torch.zeros((2, 1, shape["q_heads"], d), dtype=dt)
    pool = torch.zeros((3, shape["block_s"], 8, d), dtype=dt)
    table = torch.zeros((2, 2), dtype=torch.int32)
    lens = torch.ones((2,), dtype=torch.int32)
    with pytest.raises(ValueError, match=what):
        tpaged._launch(q, pool, pool, table, lens)
