"""The port's dense-cache path against the JAX package, on the CPU.

- The flash kernel's twin and ``attention`` against the JAX Pallas
  ``flash_attention`` in interpret mode, and ``decode_attention`` against
  the JAX ``ragged_decode_attention`` in interpret mode (f32, ``atol=2e-5``
  as the JAX package's kernel tests use: both sides sum in f32 in different
  orders).
- The two dispatch predicates against the JAX ``attention`` and
  ``decode_attention`` conditions, and what each kernel's wrapper takes.
- The dense prefill and decode branches of ``decoder_forward`` (f32 logits
  within ``atol=1e-4``, greedy tokens identical), and the dense engine's
  greedy streams against the JAX dense engine's, with full-precision
  weights, and with the model in bf16 or a JAX int8 weight tree.

The model is llama-tiny at f32 with head_dim 64 and a 2048-position rope
table, so that its prefills reach the flash route and its decode steps the
ragged route (llama-tiny's own head_dim of 32 takes neither); on a CPU
tensor each route computes its kernel's plain twin.
"""

import asyncio
import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu9.utils
from tpu9.models import decoder_forward as jax_forward
from tpu9.models import init_decoder as jax_init_decoder
from tpu9.models.llama import LLAMA_PRESETS as JAX_PRESETS
from tpu9.models.transformer import init_kv_cache as jax_init_kv_cache
from tpu9.ops import attention as jattn
from tpu9.ops import paged_attention as jpaged
from tpu9.ops.quant import quantize_decoder as jax_quantize_decoder
from tpu9.serving.engine import EngineConfig as JaxEngineConfig
from tpu9.serving.engine import InferenceEngine as JaxEngine
from tpu9.serving.presets import load_engine as jax_load_engine
from tpu9_torch.bridge import params_from_jax
from tpu9_torch.models.llama import LLAMA_PRESETS
from tpu9_torch.models.transformer import decoder_forward, init_kv_cache
from tpu9_torch.ops import attention as tattn
from tpu9_torch.ops import paged_attention as tpaged
from tpu9_torch.serving.engine import EngineConfig, InferenceEngine
from tpu9_torch.serving.presets import load_engine

torch.set_num_threads(2)

ATOL = 2e-5
TINY64 = dict(head_dim=64, max_seq_len=2048)
PAGED_ONLY = {"kv_blocks_used", "kv_blocks_free", "kv_blocks_reserved",
              "kv_block_size", "kv_quant", "prefix_cache"}


@pytest.fixture(scope="module", autouse=True)
def _pinned_numerics():
    """The process-wide numerics settings of both libraries, pinned for
    this module's comparisons and restored after: f32 matmuls at full
    precision on both sides (JAX's default precision lets a backend pick
    a faster, less precise dot algorithm) and torch's intra-op thread
    count, which sets the split of its reductions. Under the xdist run this
    module once saw prefill logits 2.0e-4 apart (79 of 16,384) where they
    sit 2.0e-6 apart, as the first file of its worker; that run was not
    reproduced and its cause is unknown, so fixing the settings it could
    have read is a guess that may change nothing."""
    threads = torch.get_num_threads()
    precision = torch.get_float32_matmul_precision()
    torch.set_num_threads(2)
    torch.set_float32_matmul_precision("highest")
    with jax.default_matmul_precision("highest"):
        yield
    torch.set_num_threads(threads)
    torch.set_float32_matmul_precision(precision)


def _rand(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(got: torch.Tensor, want, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                               rtol=0)


# -- kernels' twins and dispatch ----------------------------------------------

@pytest.mark.parametrize("causal", [True, False])
def test_flash_twin_and_attention_match_jax_flash_interpret(causal):
    rng = np.random.default_rng(20)
    q = _rand(rng, (2, 256, 4, 64))
    k = _rand(rng, (2, 256, 2, 64))
    v = _rand(rng, (2, 256, 2, 64))
    want = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=causal,
                                 interpret=True)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    before = tattn.flash_attention.launches
    _close(tattn.flash_attention(tq, tk, tv, causal=causal), want)
    _close(tattn.attention(tq, tk, tv, causal=causal), want)
    # a CPU tensor takes the plain twin: no kernel launch is counted
    assert tattn.flash_attention.launches == before


@pytest.mark.parametrize("garbage", [False, True])
def test_decode_attention_matches_jax_ragged_interpret(garbage):
    """Lengths 10, 256 and 511 over a 512-position cache; with ``garbage``
    every position at or past a length holds large finite values."""
    rng = np.random.default_rng(21)
    lens = np.array([10, 256, 511], np.int32)
    q = _rand(rng, (3, 1, 8, 64))
    kc = _rand(rng, (3, 512, 2, 64))
    vc = _rand(rng, (3, 512, 2, 64))
    if garbage:
        for b, n in enumerate(lens):
            kc[b, n:] = 1e3
            vc[b, n:] = -1e3
    want = jpaged.ragged_decode_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(lens),
        block_s=128, interpret=True)
    args = [torch.from_numpy(x) for x in (q, kc, vc, lens)]
    before = tpaged.ragged_decode_attention.launches
    _close(tattn.decode_attention(*args), want)
    _close(tpaged.ragged_decode_attention(*args, block_s=128), want)
    assert tpaged.ragged_decode_attention.launches == before


def test_dispatch_predicates_match_the_jax_conditions(monkeypatch):
    """Both packages' dispatchers, with every route replaced by a recorder
    and the JAX side told it runs on a TPU, take the same route for every
    shape of a grid; the port's route is its predicate's answer."""
    routes = []
    monkeypatch.setattr(tpu9.utils, "on_tpu", lambda: True)
    for mod, name, route in (
            (jattn, "flash_attention", "kernel"),
            (jattn, "xla_attention", "plain"),
            (jpaged, "ragged_decode_attention", "kernel"),
            (jattn, "xla_decode_attention", "plain"),
            (tattn, "flash_attention", "kernel"),
            (tattn, "xla_attention", "plain"),
            (tpaged, "ragged_decode_attention", "kernel"),
            (tattn, "xla_decode_attention", "plain")):
        monkeypatch.setattr(mod, name,
                            lambda *a, _r=route, **k: routes.append(_r))

    def both(jfn, tfn, *shapes):
        routes.clear()
        jfn(*[np.zeros(s, np.float32) for s in shapes])
        tfn(*[torch.zeros(s) for s in shapes])
        assert len(routes) == 2 and routes[0] == routes[1], (shapes, routes)
        return routes[0] == "kernel"

    n_kernel = 0
    for t in (64, 128, 200, 256):
        for s in (128, 192, 384):
            for d in (32, 64, 128, 256):
                for off in (0, 5):
                    kernel = both(
                        lambda q, k, v: jattn.attention(q, k, v, True, off),
                        lambda q, k, v: tattn.attention(q, k, v, True, off),
                        (1, t, 2, d), (1, s, 1, d), (1, s, 1, d))
                    assert kernel == tattn.uses_flash(t, s, d, off)
                    n_kernel += kernel
    for s in (256, 384, 512, 640, 768, 1024, 2048):
        for d in (32, 64, 128, 256):
            kernel = both(jattn.decode_attention, tattn.decode_attention,
                          (2, 1, 2, d), (2, s, 1, d), (2, s, 1, d), (2,))
            assert kernel == tattn.uses_ragged(s, d)
            n_kernel += kernel
    assert n_kernel > 0


def _flash_operands(b=1, t=128, s=128, qh=8, kh=2, d=128,
                    dtype=torch.bfloat16):
    return (torch.zeros((b, t, qh, d), dtype=dtype),
            torch.zeros((b, s, kh, d), dtype=dtype))


@pytest.mark.parametrize("change,why", [
    (dict(), ""),
    (dict(t=2048, s=2048, qh=32, kh=8, d=64), ""),
    (dict(dtype=torch.float32), "bf16"),
    (dict(qh=16, kh=16, d=256), ""),           # gemma-7b's prefill
    (dict(d=96), "head_dim"),
    (dict(t=100), "multiples of 64"),
    (dict(kh=3), "kv heads"),
])
def test_flash_kernel_supports(change, why):
    """The checks run before anything touches CUDA: an operand the kernel
    has no instance for raises, never falls back to the twin."""
    q, k = _flash_operands(**change)
    got = tattn.flash_kernel_supports(q, k)
    if not why:
        assert got == ""
        return
    assert why in got
    with pytest.raises(ValueError, match=why):
        tattn._launch_flash(q, k, k, True)


def _ragged_operands(b=8, t=1, s=2048, qh=32, kh=8, d=128,
                     dtype=torch.bfloat16):
    return (torch.zeros((b, t, qh, d), dtype=dtype),
            torch.zeros((b, s, kh, d), dtype=dtype),
            torch.ones((b,), dtype=torch.int32))


@pytest.mark.parametrize("change,block_s,why", [
    (dict(), 256, ""),
    (dict(d=64, s=512), 256, ""),
    (dict(t=2), 256, "one query token"),
    (dict(dtype=torch.float32), 256, "bf16"),
    (dict(qh=8, kh=1, d=256), 256, ""),        # gemma-2b's decode
    (dict(qh=32, kh=2), 256, "GQA group"),
    (dict(s=640), 256, "multiple of the block size"),
    (dict(), 24, "block size a multiple of 16"),
])
def test_ragged_kernel_supports(change, block_s, why):
    q, cache, lens = _ragged_operands(**change)
    got = tpaged.ragged_kernel_supports(q, cache, block_s)
    if not why:
        assert got == ""
        return
    assert why in got
    with pytest.raises(ValueError, match=why):
        tpaged._launch_ragged(q, cache, cache, lens, block_s)


# -- decoder -----------------------------------------------------------------

def _tiny64(quantize=False, bf16=False):
    jcfg = dataclasses.replace(JAX_PRESETS["llama-tiny"], **TINY64,
                               dtype=jnp.bfloat16 if bf16 else jnp.float32)
    tcfg = dataclasses.replace(LLAMA_PRESETS["llama-tiny"], **TINY64,
                               dtype=torch.bfloat16 if bf16 else torch.float32)
    jparams = jax_init_decoder(jax.random.PRNGKey(0), jcfg)
    if quantize:
        jparams = jax_quantize_decoder(jparams)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              "cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module")
def tiny():
    return _tiny64()


@pytest.fixture
def routes(monkeypatch):
    """Counts the calls that reach each kernel wrapper (on the CPU they
    compute the twin and count no launch)."""
    seen = {"flash": 0, "ragged": 0}
    for mod, name, key in ((tattn, "flash_attention", "flash"),
                           (tpaged, "ragged_decode_attention", "ragged")):
        real = getattr(mod, name)

        def spy(*a, _real=real, _key=key, **k):
            seen[_key] += 1
            return _real(*a, **k)
        monkeypatch.setattr(mod, name, spy)
    return seen


@pytest.mark.parametrize("t", [16, 128])
def test_dense_prefill_and_decode_match_jax(tiny, routes, t):
    """Prefill two rows of ``t`` tokens into a ``t``-position cache (the
    plain path at 16, the flash route at 128), move the prefixes into a
    512-position cache (the ragged route) and decode 4 steps at per-row
    positions."""
    jcfg, jparams, tcfg, tparams = tiny
    rng = np.random.default_rng(22)
    toks = rng.integers(0, jcfg.vocab_size, (2, t)).astype(np.int32)
    jl, jcache = jax_forward(jparams, jnp.asarray(toks), jcfg,
                             kv_cache=jax_init_kv_cache(jcfg, 2, t))
    tl, tcache = decoder_forward(tparams, torch.from_numpy(toks), tcfg,
                                 kv_cache=init_kv_cache(tcfg, 2, t))
    _close(tl, jl, atol=1e-4)
    np.testing.assert_array_equal(tl.argmax(-1).numpy(),
                                  np.asarray(jl).argmax(-1))
    _close(tcache["k"], jcache["k"], atol=1e-4)
    assert routes["flash"] == (2 if t == 128 else 0)   # one call per layer

    s = 512
    big = {n: np.zeros((jcfg.n_layers, 2, s, jcfg.n_kv_heads, jcfg.head_dim),
                       np.float32) for n in ("k", "v")}
    for n in ("k", "v"):
        big[n][:, :, :t] = np.asarray(jcache[n])
    jbig = {n: jnp.asarray(a) for n, a in big.items()}
    tbig = {n: torch.from_numpy(a.copy()) for n, a in big.items()}
    clen = np.array([t - 5, t], np.int32)          # row 0 decodes over padding
    tok = np.asarray(jl)[np.arange(2), clen - 1].argmax(-1).astype(np.int32)
    for _ in range(4):
        jl, jbig = jax_forward(
            jparams, jnp.asarray(tok[:, None]), jcfg,
            positions=jnp.asarray(clen[:, None]), kv_cache=jbig,
            cache_len=jnp.asarray(clen + 1), decode=True)
        tl, tbig = decoder_forward(
            tparams, torch.from_numpy(tok[:, None]), tcfg,
            positions=torch.from_numpy(clen[:, None]), kv_cache=tbig,
            cache_len=torch.from_numpy(clen + 1), decode=True)
        _close(tl, jl, atol=1e-4)
        want = np.asarray(jl)[:, -1].argmax(-1)
        np.testing.assert_array_equal(tl[:, -1].argmax(-1).numpy(), want)
        tok = want.astype(np.int32)
        clen = clen + 1
    _close(tbig["k"], jbig["k"], atol=1e-4)
    assert routes["ragged"] == 4 * jcfg.n_layers


# -- engine ------------------------------------------------------------------

@pytest.fixture
def engines(tiny):
    """The JAX and the port's dense engines, each built by
    ``EngineConfig()`` defaults (as the runner's ``(params, cfg)`` handler
    form builds one), on the same weights. Fresh for each test: an engine's
    request queue belongs to the event loop that first waits on it."""
    jcfg, jparams, tcfg, tparams = tiny
    return (JaxEngine(jparams, jcfg, JaxEngineConfig()),
            InferenceEngine(tparams, tcfg, EngineConfig(), device="cpu"))


def _prompts():
    rng = np.random.default_rng(23)
    return [rng.integers(1, 500, n).tolist() for n in (45, 7, 130, 23)]


async def _serve(engine, prompts, max_new):
    """Every prompt at once, then the first one again."""
    await engine.start()
    try:
        outs = await asyncio.gather(*[
            engine.generate(p, max_new_tokens=max_new, request_id=f"r{i}")
            for i, p in enumerate(prompts)])
        again = await engine.generate(prompts[0], max_new_tokens=max_new)
    finally:
        await engine.stop()
    return list(outs), again


def test_dense_greedy_streams_identical_to_jax_engine(engines, routes):
    jeng, teng = engines
    assert not teng.paged and not jeng.paged
    assert teng.kv_cache["k"].shape == tuple(jeng.kv_cache["k"].shape)
    prompts = _prompts()
    want = asyncio.run(_serve(jeng, prompts, 8))
    got = asyncio.run(_serve(teng, prompts, 8))
    assert got == want
    assert all(len(o) == 8 for o in got[0])
    # buckets 128 and 512: every prefill layer took the flash route, every
    # decode layer the ragged one (S = 2048)
    steps = teng.stats()["decode_steps"]
    assert routes["flash"] == teng.cfg.n_layers * (len(prompts) + 1)
    assert routes["ragged"] == teng.cfg.n_layers * steps > 0
    assert teng.stats()["active_streams"] == 0
    assert int(teng.cache_len.abs().sum()) == 0


def test_dense_concurrent_equals_sequential(engines):
    _, teng = engines
    prompts = [[1, 2, 3], [9, 8, 7, 6], [42]]

    async def go():
        await teng.start()
        try:
            seq = [await teng.generate(p, max_new_tokens=6) for p in prompts]
            conc = await asyncio.gather(
                *[teng.generate(p, max_new_tokens=6) for p in prompts])
        finally:
            await teng.stop()
        return seq, list(conc)

    seq, conc = asyncio.run(go())
    assert conc == seq and all(len(o) == 6 for o in seq)


def test_dense_streaming_matches_jax(engines):
    jeng, teng = engines

    async def stream(engine):
        await engine.start()
        try:
            req = await engine.generate([4, 4, 4], max_new_tokens=5,
                                        stream=True)
            toks = []
            while (tok := await req.queue.get()) is not None:
                toks.append(tok)
            return toks, list(req.generated)
        finally:
            await engine.stop()

    toks, generated = asyncio.run(stream(teng))
    assert len(toks) == 5 and toks == generated
    assert toks == asyncio.run(stream(jeng))[0]


@pytest.mark.parametrize("buckets,seq,limit", [
    ((128, 512, 2048), 2048, 2047),    # the cache bounds the prompt
    ((16, 64), 128, 64),               # the largest bucket does
])
def test_dense_prompt_limit_matches_jax(tiny, buckets, seq, limit):
    jcfg, jparams, tcfg, tparams = tiny
    kw = dict(max_batch=2, max_seq_len=seq, prefill_buckets=buckets)
    for engine in (JaxEngine(jparams, jcfg, JaxEngineConfig(**kw)),
                   InferenceEngine(tparams, tcfg, EngineConfig(**kw),
                                   device="cpu")):
        with pytest.raises(ValueError,
                           match=f"prompt length {limit + 1} exceeds "
                                 f"engine limit {limit}"):
            asyncio.run(engine.generate([1] * (limit + 1), max_new_tokens=2))


def test_dense_deadline_expiry_before_prefill(tiny):
    _, _, tcfg, tparams = tiny
    engine = InferenceEngine(tparams, tcfg,
                             EngineConfig(max_batch=2, max_seq_len=512),
                             device="cpu")

    async def go():
        with pytest.raises(TimeoutError, match="deadline_exceeded"):
            await engine.generate([1, 2, 3], max_new_tokens=4, budget_s=0.0)
        req = await engine.generate([5, 3, 9], max_new_tokens=8,
                                    stream=True, budget_s=60.0)
        req.deadline_mono = time.monotonic() - 1.0
        await engine.start()
        try:
            await asyncio.wait_for(req.done.wait(), 30)
            assert await asyncio.wait_for(req.queue.get(), 5) is None
        finally:
            await engine.stop()
        return req

    req = asyncio.run(go())
    assert req.error.startswith("deadline_exceeded")
    assert "before prefill" in req.error and req.generated == []
    assert engine.stats()["deadline_expired"] == 1


def test_dense_stats_drop_the_paged_keys(tiny):
    jcfg, jparams, tcfg, tparams = tiny
    kw = dict(max_batch=2, max_seq_len=512, prefill_buckets=(16,))
    paged = dict(kv_block_size=16, prefix_cache_blocks=8)
    t_dense = InferenceEngine(tparams, tcfg, EngineConfig(**kw), device="cpu")
    t_paged = InferenceEngine(tparams, tcfg, EngineConfig(**kw, **paged),
                              device="cpu")
    j_dense = JaxEngine(jparams, jcfg, JaxEngineConfig(**kw))
    j_paged = JaxEngine(jparams, jcfg, JaxEngineConfig(**kw, **paged))
    assert set(t_paged.stats()) - set(t_dense.stats()) == PAGED_ONLY
    assert PAGED_ONLY <= set(j_paged.stats()) - set(j_dense.stats())
    assert not PAGED_ONLY & set(j_dense.stats())
    assert t_dense.pool is None and t_dense.prefix_cache is None


def _first_fork_within(jparams, jcfg, prompt, want, got, margin=0.35):
    """Streams equal, or, from their first difference on, the port's token
    within ``margin`` of a full-context JAX forward's argmax (how the JAX
    suite judges an int8 fork, ``tests/test_quant_serving.py``)."""
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(want, got)):
        if a != b:
            logits = jax_forward(jparams, jnp.asarray([prompt + got[:i]],
                                                      jnp.int32), jcfg)[0, -1]
            assert float(jnp.max(logits) - logits[b]) < margin, (i, a, b)
            return


@pytest.mark.parametrize("weights", ["bf16", "int8"])
def test_dense_bf16_and_int8_weights_match_jax_engine(weights):
    """bf16: the model in bf16 end to end; int8: a JAX int8 weight tree
    at f32. The two frameworks round at other places, so a fork is judged
    as the JAX suite judges one."""
    jcfg, jparams, tcfg, tparams = _tiny64(quantize=weights == "int8",
                                           bf16=weights == "bf16")
    wq = tparams["layers"][0]["wq"]
    assert (wq["q"].dtype == torch.int8 if weights == "int8"
            else wq.dtype == torch.bfloat16)
    kw = dict(max_batch=4, max_seq_len=512, prefill_buckets=(16, 256),
              decode_steps=(1, 4))
    jeng = JaxEngine(jparams, jcfg, JaxEngineConfig(**kw))
    teng = InferenceEngine(tparams, tcfg, EngineConfig(**kw), device="cpu")
    prompts = _prompts()
    want = asyncio.run(_serve(jeng, prompts, 8))
    got = asyncio.run(_serve(teng, prompts, 8))
    for prompt, w, g in zip(prompts + [prompts[0]], want[0] + [want[1]],
                            got[0] + [got[1]]):
        _first_fork_within(jparams, jcfg, prompt, w, g)


def test_load_engine_dense_matches_jax_and_serves(tiny):
    """``load_engine(paged=False)`` gives the JAX function's dense
    configuration, and an engine of that configuration on the JAX weights
    gives the JAX engine's streams."""
    jcfg, jparams, tcfg, tparams = tiny
    kw = dict(max_batch=2, max_seq_len=512, prefill_buckets=(16, 128),
              decode_steps=(1, 4), paged=False)
    got = load_engine("llama-tiny", device="cpu", **kw)
    want = jax_load_engine("llama-tiny", **kw)
    assert not got.paged and not want.paged
    for name in ("max_batch", "max_seq_len", "prefill_buckets",
                 "decode_steps", "kv_block_size", "kv_pool_blocks",
                 "prefill_chunk", "prefix_cache_blocks", "kv_quant"):
        assert getattr(got.ecfg, name) == getattr(want.ecfg, name), name
    prompts = _prompts()[:2]
    teng = InferenceEngine(tparams, tcfg, got.ecfg, device="cpu")
    jeng = JaxEngine(jparams, jcfg, want.ecfg)
    assert asyncio.run(_serve(teng, prompts, 6)) == \
        asyncio.run(_serve(jeng, prompts, 6))
    out = asyncio.run(_serve(got, prompts, 3))[0]
    assert [len(o) for o in out] == [3, 3]
