"""The port's int8 path (``tpu9_torch.ops.quant``, the int8 paged-decode
wrapper and the int8 branches of the decoder) against ``tpu9.ops.quant``
and ``tpu9.ops.paged_attention`` on the same numpy inputs, on the CPU.

Tolerances: the quantizers and dequantizers are bit-exact (both round half
to even and divide in f32). ``quantized_matmul`` sums bf16 products in f32
in another order: rtol 1e-5 (a few f32 ulps of a 64-term sum). The paged
attention twin against the Pallas kernel in interpret mode: f32 atol 2e-5,
the JAX suite's own tolerance for that kernel. The int8 decoder: logits
atol 1e-4, as ``test_torch_model.py`` holds the bf16-pool decoder.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu9.models import init_decoder as jax_init_decoder
from tpu9.models.llama import LLAMA_PRESETS as JAX_PRESETS
from tpu9.models.transformer import decoder_forward as jax_forward
from tpu9.ops import paged_attention as jpaged
from tpu9.ops import quant as jquant
from tpu9_torch.bridge import params_from_jax
from tpu9_torch.models.llama import LLAMA_PRESETS
from tpu9_torch.models.transformer import decoder_forward, init_kv_cache
from tpu9_torch.ops import attention as tattn
from tpu9_torch.ops import paged_attention as tpaged
from tpu9_torch.ops import quant as tquant
from tpu9_torch.serving.engine import EngineConfig
from tpu9_torch.serving.graphs import GraphFactory

torch.set_num_threads(2)

ATOL = 2e-5


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _tied(rng, shape) -> np.ndarray:
    """Values whose quantized ratio lands exactly on .5 for many entries:
    each vector's absmax is 127 * 2^-3, so scale = 2^-3 exactly and
    (k + .5) * 2^-3 quantizes to an exact tie."""
    x = (rng.integers(-126, 126, shape) + 0.5) * 0.125
    x[..., 0] = 127 * 0.125                        # the absmax, exact
    return x.astype(np.float32)


def _zeros_in(rng, shape) -> np.ndarray:
    x = _rand(rng, shape)
    x[0] = 0.0                                     # whole zero vectors
    return x


CASES = {"normal": _rand, "ties": _tied, "zeros": _zeros_in}


@pytest.mark.parametrize("case", sorted(CASES))
def test_quantize_kv_is_bit_exact(case):
    x = CASES[case](np.random.default_rng(0), (3, 5, 2, 32))
    jq, js = jquant.quantize_kv(jnp.asarray(x))
    tq, ts = tquant.quantize_kv(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tquant.dequantize_kv(tq, ts, torch.float32).numpy(),
        np.asarray(jquant.dequantize_kv(jq, js, jnp.float32)))
    if case == "ties":
        # ties really occur, and both sides round them to even
        ratio = x / np.asarray(js)[..., None]
        assert (np.abs(ratio - np.floor(ratio)) == 0.5).sum() > 50


@pytest.mark.parametrize("case", sorted(CASES))
def test_quantize_weight_is_bit_exact(case):
    # [in, out]: scales run along the output axis, so tie vectors are
    # columns: build [out, in] and transpose
    w = np.ascontiguousarray(
        CASES[case](np.random.default_rng(1), (24, 40)).T)
    want = jquant.quantize_weight(jnp.asarray(w))
    got = tquant.quantize_weight(torch.from_numpy(w))
    assert got["q"].dtype == torch.int8 and tuple(got["scale"].shape) == (1, 24)
    for name in ("q", "scale"):
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]))
    np.testing.assert_array_equal(
        tquant.dequantize_weight(got, torch.float32).numpy(),
        np.asarray(jquant.dequantize_weight(want, jnp.float32)))


@pytest.mark.parametrize("x_shape", [(5, 64), (2, 3, 64)])
def test_quantized_matmul_matches_jax(x_shape):
    rng = np.random.default_rng(2)
    x = _rand(rng, x_shape, 3.0)
    entry = jquant.quantize_weight(jnp.asarray(_rand(rng, (64, 48))))
    tentry = params_from_jax(jax.tree_util.tree_map(np.asarray, entry), "cpu")
    want = np.asarray(jquant.quantized_matmul(jnp.asarray(x), entry))
    got = tquant.quantized_matmul(torch.from_numpy(x), tentry)
    assert got.dtype == torch.float32 and got.shape == x_shape[:-1] + (48,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    # maybe_matmul routes a quantized entry there and a plain weight to @
    np.testing.assert_array_equal(
        tquant.maybe_matmul(torch.from_numpy(x), tentry).numpy(), got.numpy())
    w = torch.from_numpy(_rand(rng, (64, 8)))
    assert torch.equal(tquant.maybe_matmul(torch.from_numpy(x), w),
                       torch.from_numpy(x) @ w)


@pytest.mark.parametrize("mode", [None, "", "int8", "fp8", "INT8"])
def test_validate_quant_mode_matches(mode):
    try:
        want = jquant.validate_quant_mode(mode, "kv_quant")
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            tquant.validate_quant_mode(mode, "kv_quant")
        assert str(got.value) == str(exc)
    else:
        assert tquant.validate_quant_mode(mode, "kv_quant") == want


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/{i}"))
        return out
    return {prefix: tree}


def _dtype_name(x) -> str:
    return str(x.dtype).removeprefix("torch.")


def test_init_quantized_decoder_tree_matches_jax():
    jcfg = JAX_PRESETS["llama-tiny"]
    tcfg = LLAMA_PRESETS["llama-tiny"]
    want = _flat(jax.eval_shape(lambda r: jquant.init_quantized_decoder(
        r, jcfg), jax.random.PRNGKey(0)))
    gen = torch.Generator().manual_seed(0)
    got = _flat(tquant.init_quantized_decoder(tcfg, gen, "cpu"))
    assert set(got) == set(want)
    for path, leaf in got.items():
        assert tuple(leaf.shape) == tuple(want[path].shape), path
        assert _dtype_name(leaf) == _dtype_name(want[path]), path
    layer = tquant.init_quantized_decoder(
        tcfg, torch.Generator().manual_seed(1), "cpu")["layers"][0]
    for name, (i, o) in {"wq": (tcfg.dim, tcfg.n_heads * tcfg.head_dim),
                         "w_down": (tcfg.hidden_dim, tcfg.dim)}.items():
        std = (2.0 / (i + o)) ** 0.5
        sc = layer[name]["scale"]
        assert float(sc.min()) >= 0.8 * std / 73 * (1 - 1e-6)
        assert float(sc.max()) <= 1.2 * std / 73 * (1 + 1e-6)
        q = layer[name]["q"]
        assert int(q.min()) >= -127 and int(q.max()) <= 127


def test_bridge_moves_an_int8_tree_bit_exact():
    jtree = jquant.init_quantized_decoder(jax.random.PRNGKey(3),
                                          JAX_PRESETS["llama-tiny"])
    ttree = params_from_jax(jax.tree_util.tree_map(np.asarray, jtree), "cpu")
    want, got = _flat(jtree), _flat(ttree)
    assert set(got) == set(want)
    for path, leaf in got.items():
        assert _dtype_name(leaf) == _dtype_name(want[path]), path
        w = np.asarray(want[path])
        if w.dtype.name == "bfloat16":
            np.testing.assert_array_equal(leaf.view(torch.uint16).numpy(),
                                          w.view(np.uint16))
        else:
            np.testing.assert_array_equal(leaf.numpy(), w)
    assert tquant.quantized_bytes(ttree) == jquant.quantized_bytes(jtree)


def test_quantize_decoder_matches_jax_and_is_idempotent():
    jcfg = dataclasses.replace(JAX_PRESETS["llama-tiny"], dtype=jnp.float32)
    jparams = jax_init_decoder(jax.random.PRNGKey(4), jcfg)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              "cpu")
    want = _flat(jquant.quantize_decoder(jparams))
    once = tquant.quantize_decoder(tparams)
    got = _flat(once)
    assert set(got) == set(want)
    for path, leaf in got.items():
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(want[path]))
    twice = _flat(tquant.quantize_decoder(once))
    assert all(twice[p] is got[p] for p in got)    # passed through untouched
    assert tquant.quantized_bytes(once) == jquant.quantized_bytes(
        jquant.quantize_decoder(jparams))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stacked_quantizer_matches_jax(dtype):
    """Per-expert int8 of an [E, in, out] stack: values and [E, 1, out]
    scales bit for bit, an all-zero channel included, and the
    dequantized stack bit for bit."""
    w = np.random.default_rng(21).standard_normal((4, 48, 40)) * 0.05
    w[1, :, 3] = 0.0
    jw = jnp.asarray(w, jnp.float32).astype(getattr(jnp, dtype))
    want = jquant.quantize_weight_stacked(jw)
    got = tquant.quantize_weight_stacked(params_from_jax(np.asarray(jw),
                                                         "cpu"))
    assert got["q"].dtype == torch.int8 and got["scale"].shape == (4, 1, 40)
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(got["scale"].numpy(),
                                  np.asarray(want["scale"]))
    np.testing.assert_array_equal(
        tquant.dequantize_weight(got, torch.float32).numpy(),
        np.asarray(jquant.dequantize_weight(want, jnp.float32)))


# ---------------------------------------------------------------------------
# paged attention over an int8 pool
# ---------------------------------------------------------------------------

def _quant_case(head_dim: int, block_s: int, seed: int):
    """GQA group 4, lengths 1, BS, BS+1 and the table's whole width; table
    entries past each prefix name blocks of large finite garbage (payload
    127, scale 1e3)."""
    rng = np.random.default_rng(seed)
    kv_heads, mb = 2, 4
    lens = np.array([1, block_s, block_s + 1, mb * block_s], np.int32)
    need = [-(-int(n) // block_s) for n in lens]
    n_real, n_garbage = sum(need), 3
    table = np.empty((len(lens), mb), np.int32)
    perm = rng.permutation(n_real)
    used = 0
    for i, nb in enumerate(need):
        table[i, :nb] = perm[used:used + nb]
        table[i, nb:] = rng.integers(n_real, n_real + n_garbage, mb - nb)
        used += nb
    shape = (n_real + n_garbage, block_s, kv_heads, head_dim)
    kq, ks = (np.array(a) for a in jquant.quantize_kv(
        jnp.asarray(_rand(rng, shape))))
    vq, vs = (np.array(a) for a in jquant.quantize_kv(
        jnp.asarray(_rand(rng, shape))))
    for a in (kq, vq):
        a[n_real:] = 127
    for a in (ks, vs):
        a[n_real:] = 1e3
    q = _rand(rng, (len(lens), 1, 4 * kv_heads, head_dim))
    return q, kq, vq, ks, vs, table, lens


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def test_gather_paged_dequantizes_like_jax():
    q, kq, _, ks, _, table, _ = _quant_case(32, 8, 0)
    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.bfloat16, jnp.bfloat16)):
        got = tpaged.gather_paged(*_torch(kq, table), torch.from_numpy(ks),
                                  dtype)
        want = jpaged.gather_paged(jnp.asarray(kq), jnp.asarray(table),
                                   jnp.asarray(ks), jdtype)
        assert got.dtype == dtype
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("head_dim", [32, 64])
def test_quant_twin_matches_jax_twin(head_dim):
    q, kq, vq, ks, vs, table, lens = _quant_case(head_dim, 8, head_dim)
    want = jpaged.xla_paged_decode_attention(
        *(jnp.asarray(a) for a in (q, kq, vq, table, lens, ks, vs)))
    got = tpaged.xla_paged_decode_attention(
        *_torch(q, kq, vq, table, lens, ks, vs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("head_dim", [32, 64])
@pytest.mark.parametrize("block_s", [8, 16])
def test_quant_dispatch_matches_jax_kernel_interpret(head_dim, block_s):
    q, kq, vq, ks, vs, table, lens = _quant_case(head_dim, block_s,
                                                 head_dim + block_s)
    want = jpaged.paged_decode_attention_quant(
        *(jnp.asarray(a) for a in (q, kq, vq, ks, vs, table, lens)),
        interpret=True)
    before = (tpaged.paged_decode_attention.launches,
              tpaged.paged_decode_attention_quant.launches)
    tq, tkq, tvq, tks, tvs, ttable, tlens = _torch(q, kq, vq, ks, vs, table,
                                                   lens)
    got = tattn.paged_attention_dispatch(tq, tkq, tvq, ttable, tlens, tks,
                                         tvs)
    # a CPU tensor takes the plain twin: no kernel launch is counted
    assert (tpaged.paged_decode_attention.launches,
            tpaged.paged_decode_attention_quant.launches) == before
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    # the CPU wrapper is the twin, exactly
    twin = tpaged.xla_paged_decode_attention(tq, tkq, tvq, ttable, tlens,
                                             tks, tvs)
    assert torch.equal(tpaged.paged_decode_attention_quant(
        tq, tkq, tvq, tks, tvs, ttable, tlens), twin)


@pytest.mark.parametrize("what,change", [
    ("int8 pool", dict(pool_dtype=torch.bfloat16)),
    ("bf16 q", dict(q_dtype=torch.float32)),
    ("f32 scales", dict(scale_shape=(3, 16, 8, 1))),
    ("f32 scales", dict(scale_dtype=torch.bfloat16)),
    ("head_dim", dict(head_dim=32)),
    ("k_scale and v_scale", dict(v_scale_shape=(3, 16, 4))),
])
def test_quant_kernel_wrapper_refuses_what_it_cannot_take(what, change):
    """The checks run before anything touches CUDA, so they are testable
    here: operands the int8 kernel has no instance for raise, never fall
    back to the twin."""
    o = dict(pool_dtype=torch.int8, q_dtype=torch.bfloat16, head_dim=128,
             scale_shape=(3, 16, 8), scale_dtype=torch.float32,
             v_scale_shape=(3, 16, 8))
    o.update(change)
    d = o["head_dim"]
    q = torch.zeros((2, 1, 32, d), dtype=o["q_dtype"])
    pool = torch.zeros((3, 16, 8, d), dtype=o["pool_dtype"])
    ks = torch.zeros(o["scale_shape"], dtype=o["scale_dtype"])
    vs = torch.zeros(o["v_scale_shape"], dtype=o["scale_dtype"])
    table = torch.zeros((2, 2), dtype=torch.int32)
    lens = torch.ones((2,), dtype=torch.int32)
    with pytest.raises(ValueError, match=what):
        tpaged._launch(q, pool, pool, table, lens, ks, vs)


# ---------------------------------------------------------------------------
# the int8 decoder: int8 weights, chunked prefill, int8 splice, int8 decode
# ---------------------------------------------------------------------------

S, C, BS = 64, 16, 8


@pytest.fixture(scope="module")
def tiny_int8():
    jcfg = dataclasses.replace(JAX_PRESETS["llama-tiny"], dtype=jnp.float32)
    tcfg = dataclasses.replace(LLAMA_PRESETS["llama-tiny"],
                               dtype=torch.float32)
    jparams = jquant.quantize_decoder(
        jax_init_decoder(jax.random.PRNGKey(0), jcfg))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              "cpu")
    return jcfg, jparams, tcfg, tparams


def test_int8_no_cache_logits_match(tiny_int8):
    jcfg, jparams, tcfg, tparams = tiny_int8
    toks = np.random.default_rng(5).integers(0, jcfg.vocab_size, (2, 11))
    want = jax_forward(jparams, jnp.asarray(toks, jnp.int32), jcfg)
    got = decoder_forward(tparams, torch.from_numpy(toks), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)


def test_int8_prefill_splice_and_paged_decode_match(tiny_int8):
    """Chunked prefill into the scratch, the port's int8 splice against the
    JAX quantizer applied block by block, then decode steps that quantize
    each new token into the pool and attend through the int8 dispatch."""
    jcfg, jparams, tcfg, tparams = tiny_int8
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, jcfg.vocab_size, n).tolist() for n in (29, 16)]
    mb, n_blocks = S // BS + 1, 2 * (S // BS) + 1
    shape = (jcfg.n_layers, n_blocks, BS, jcfg.n_kv_heads, jcfg.head_dim)
    jpool = {"k": np.zeros(shape, np.int8), "v": np.zeros(shape, np.int8),
             "k_scale": np.zeros(shape[:-1], np.float32),
             "v_scale": np.zeros(shape[:-1], np.float32)}
    tpool = {k: torch.from_numpy(v.copy()) for k, v in jpool.items()}
    perm = rng.permutation(np.arange(1, n_blocks))
    table = np.zeros((2, mb), np.int32)
    table[0, :S // BS] = perm[:S // BS]
    table[1, :S // BS] = perm[S // BS:]
    graphs = GraphFactory(tcfg, EngineConfig(max_batch=2, max_seq_len=S,
                                             kv_block_size=BS,
                                             prefill_chunk=C),
                          C, torch.device("cpu"))
    last = []
    for b, prompt in enumerate(prompts):
        tscr = init_kv_cache(tcfg, 1, S)
        for off in range(0, len(prompt), C):
            valid = min(C, len(prompt) - off)
            row = np.zeros((1, C), np.int32)
            row[0, :valid] = prompt[off:off + valid]
            pos = (off + np.arange(C, dtype=np.int32))[None, :]
            logits, tscr = decoder_forward(
                tparams, torch.from_numpy(row), tcfg,
                positions=torch.from_numpy(pos), kv_cache=tscr,
                cache_len=off + C)
            phys = table[b, off // BS:(off + C) // BS]
            graphs.traced_splice(tpool, tscr["k"], tscr["v"],
                                 torch.tensor([off], dtype=torch.int32),
                                 torch.from_numpy(phys))
            for j, blk in enumerate(phys):
                sl = slice(off + j * BS, off + (j + 1) * BS)
                for name in ("k", "v"):
                    qv, sc = jquant.quantize_kv(
                        jnp.asarray(tscr[name][:, 0, sl].numpy()))
                    jpool[name][:, blk] = np.asarray(qv)
                    jpool[f"{name}_scale"][:, blk] = np.asarray(sc)
        last.append(int(logits[0, valid - 1].argmax()))
    for name, arr in jpool.items():
        np.testing.assert_array_equal(tpool[name].numpy(), arr)
    jcache = {k: jnp.asarray(v) for k, v in jpool.items()}
    jcache["table"] = jnp.asarray(table)
    tpool["table"] = torch.from_numpy(table)
    clen = np.array([len(p) for p in prompts], np.int32)
    tok = np.array(last, np.int32)[:, None]
    for _ in range(4):
        jl, jcache = jax_forward(
            jparams, jnp.asarray(tok), jcfg,
            positions=jnp.asarray(clen[:, None]), kv_cache=jcache,
            cache_len=jnp.asarray(clen + 1), decode=True)
        tl, tpool = decoder_forward(
            tparams, torch.from_numpy(tok), tcfg,
            positions=torch.from_numpy(clen[:, None]), kv_cache=tpool,
            cache_len=torch.from_numpy(clen + 1), decode=True)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=0)
        want_tok = np.asarray(jl)[:, -1].argmax(-1)
        np.testing.assert_array_equal(tl[:, -1].argmax(-1).numpy(), want_tok)
        tok = want_tok.astype(np.int32)[:, None]
        clen = clen + 1
    # the decode writes quantized the same values into the same slots
    for name in ("k", "v", "k_scale", "v_scale"):
        assert tpool[name].dtype == (torch.int8 if len(name) == 1
                                     else torch.float32)
        np.testing.assert_allclose(tpool[name].float().numpy(),
                                   np.asarray(jcache[name], np.float32),
                                   atol=1 if len(name) == 1 else 1e-6,
                                   rtol=0 if len(name) == 1 else 1e-4)
