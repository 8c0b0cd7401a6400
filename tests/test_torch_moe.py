"""The port's sparse-MoE decoder (``tpu9_torch/models/moe.py``, the
stacked int8 of ``tpu9_torch/ops/quant.py``, the mixtral presets) against
the JAX package, on the CPU. Inputs are made with numpy from a seed and
handed to both packages; a JAX tree crosses with ``params_from_jax``.

- ``moe_ffn`` at f32 and bf16, at the preset's capacity factor and at 0.1
  (drops), and on rows of exactly tied router logits: output, balance loss,
  dropped fraction and expert load. f32 outputs within ``atol=2e-6`` (the
  expert products sum in other orders; the routing and the drops are
  equal), bf16 within two bf16 steps (``2**-6``: the packages' bf16 silu
  rounds at other places). The router and ``w_down`` gradients of
  ``mean(y²) + 0.01·balance`` against ``jax.grad`` at f32, ``rtol=1e-4``.
- ``quantized_einsum`` and ``maybe_einsum`` within f32 rounding (the
  stacked quantizer is held bit for bit in ``tests/test_torch_quant.py``), ``quantize_decoder`` over a MoE
  tree leaf for leaf, and the meta trees of both inits for mixtral-8x7b
  against ``jax.eval_shape``.
- ``decoder_forward`` on mixtral-tiny at f32: the no-cache forward, its
  balance aux, dense prefill and decode (logits within ``atol=1e-4``,
  greedy tokens equal).
- Greedy streams of the port's engines against the JAX engines' on one
  tree at f32: paged bf16 pool, paged int8 pool on an int8 tree, dense,
  paged with speculation, and a paged engine whose capacity factor drops
  pairs in every full chunk; an engine on the abstract tree precompiles
  the dense config's keys and, bound, serves the same streams.
- ``.tpu9w`` shards of an int8 MoE tree byte for byte across the packages.
"""

import asyncio
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu9.models import decoder_forward as jax_forward
from tpu9.models import init_decoder as jax_init_decoder
from tpu9.models import init_kv_cache as jax_init_kv_cache
from tpu9.models import moe as jmoe
from tpu9.models.mixtral import MIXTRAL_PRESETS as JAX_MIXTRAL
from tpu9.ops import quant as jquant
from tpu9.serving import weights as jw
from tpu9.serving.engine import EngineConfig as JaxEngineConfig
from tpu9.serving.engine import InferenceEngine as JaxEngine
from tpu9_torch.bridge import params_from_jax
from tpu9_torch.models import moe as tmoe
from tpu9_torch.models.mixtral import MIXTRAL_PRESETS
from tpu9_torch.models.transformer import (decoder_forward, init_decoder,
                                           init_kv_cache)
from tpu9_torch.ops import quant as tquant
from tpu9_torch.serving import weights as tw
from tpu9_torch.serving.engine import (EngineConfig, InferenceEngine,
                                       abstract_params)
from tpu9_torch.serving.graphs import key_name
from tpu9_torch.serving.presets import abstract_params_for

torch.set_num_threads(2)

DIM, HIDDEN = 64, 96


@pytest.fixture
def jax_table_copies(monkeypatch):
    """The JAX paged engine's block table handed over as a copy at each
    push: ``jnp.asarray`` may wrap the pool's host table, which each push
    rewrites in place, so a window dispatched before an admission could
    read the admitted slot's new row (``tests/test_torch_spec.py`` says
    how). The port copies its table."""
    from tpu9.serving.shard.policy import SingleDevicePolicy
    monkeypatch.setattr(
        SingleDevicePolicy, "device_table",
        lambda policy, table: jnp.asarray(np.array(table, copy=True)))


def _np(t) -> np.ndarray:
    return t.detach().float().numpy()


def _jnp(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _cfgs(dtype: str, capacity_factor: float, n_experts: int = 8):
    kw = dict(dim=DIM, hidden_dim=HIDDEN, n_experts=n_experts, top_k=2,
              capacity_factor=capacity_factor)
    return (jmoe.MoeConfig(**kw, dtype=getattr(jnp, dtype)),
            tmoe.MoeConfig(**kw, dtype=getattr(torch, dtype)))


def _layer(jcfg, seed: int = 0):
    jp = jmoe.init_moe_layer(jax.random.PRNGKey(seed), jcfg)
    return jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")


def _x(shape, dtype: str, seed: int = 1, zero_rows: int = 0):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    x.reshape(-1, shape[-1])[:zero_rows] = 0.0
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    return jx, params_from_jax(np.asarray(jx), "cpu")


def _check_ffn(jcfg, tcfg, jp, tp, jx, tx, dtype: str):
    jo, ja = jmoe.moe_ffn(jp, jx, jcfg, ep_sharded=False)
    to, ta = tmoe.moe_ffn(tp, tx, tcfg)
    assert to.dtype == tx.dtype and to.shape == tx.shape
    tol = 2e-6 if dtype == "float32" else 2.0 ** -6
    np.testing.assert_allclose(_np(to), _jnp(jo), rtol=tol, atol=tol)
    # routing is f32 from the same inputs: drops and loads are equal
    assert float(ta["dropped_frac"]) == pytest.approx(
        float(ja["dropped_frac"]), abs=1e-7)
    np.testing.assert_array_equal(_np(ta["expert_load"]),
                                  _jnp(ja["expert_load"]))
    assert float(ta["balance_loss"]) == pytest.approx(
        float(ja["balance_loss"]), rel=1e-6)
    return ja, ta


@pytest.mark.parametrize("capacity_factor", [1.25, 0.1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_ffn_matches_jax(dtype, capacity_factor):
    jcfg, tcfg = _cfgs(dtype, capacity_factor)
    jp, tp = _layer(jcfg)
    jx, tx = _x((3, 40, DIM), dtype)
    ja, _ = _check_ffn(jcfg, tcfg, jp, tp, jx, tx, dtype)
    if capacity_factor < 1:
        # 240 pairs over 8 experts of 8 slots: drops, reported as such
        assert float(ja["dropped_frac"]) > 0.5


@pytest.mark.parametrize("width", [4, 8, 64])
def test_top_k_gives_ties_to_the_lower_index_as_jax(width):
    rng = np.random.default_rng(width)
    probs = rng.random((6, width)).astype(np.float32)
    probs[0] = 1.0 / width                     # a zero hidden state's row
    probs[1, ::2] = probs[1].max()             # ties at the top
    probs[2, 1:4] = 0.5                        # ties below the top
    jv, ji = jax.lax.top_k(jnp.asarray(probs), 2)
    tv, ti = tmoe._top_k(torch.from_numpy(probs), 2)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert ti[0].tolist() == [0, 1]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tied_zero_rows_route_as_jax(dtype):
    """Zero hidden states tie every router logit: their pairs go to experts
    0 and 1, fill those buffers first and push later tokens past the
    capacity there, as in the reference."""
    jcfg, tcfg = _cfgs(dtype, 1.25)
    jp, tp = _layer(jcfg, seed=2)
    jx, tx = _x((2, 24, DIM), dtype, seed=3, zero_rows=20)
    ja, ta = _check_ffn(jcfg, tcfg, jp, tp, jx, tx, dtype)
    # 20 of 48 tokens' top-1 is expert 0, and capacity 16 drops pairs
    assert float(ta["expert_load"][0]) >= 20 / 48
    assert float(ja["dropped_frac"]) > 0


def test_gradients_match_jax_grad():
    jcfg, tcfg = _cfgs("float32", 0.5, n_experts=4)
    jp, tp = _layer(jcfg, seed=4)
    jx, tx = _x((2, 32, DIM), "float32", seed=5)

    def jloss(p):
        y, aux = jmoe.moe_ffn(p, jx, jcfg, ep_sharded=False)
        return jnp.mean(y ** 2) + 0.01 * aux["balance_loss"]

    jgrad = jax.grad(jloss)(jp)
    tp = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    y, aux = tmoe.moe_ffn(tp, tx, tcfg)
    (torch.mean(y ** 2) + 0.01 * aux["balance_loss"]).backward()
    assert float(aux["dropped_frac"]) > 0
    for name in ("router", "w_down", "w_gate", "w_up"):
        want = np.asarray(jgrad[name])
        assert np.abs(want).sum() > 0, name
        np.testing.assert_allclose(tp[name].grad.numpy(), want, rtol=1e-4,
                                   atol=1e-7, err_msg=name)


def test_capacity_is_the_references():
    for n in (1, 8, 9, 72, 128, 2047, 2048):
        for e, k, cf in ((8, 2, 1.25), (4, 2, 0.1), (64, 1, 2.0)):
            jc = jmoe.MoeConfig(n_experts=e, top_k=k, capacity_factor=cf)
            tc = tmoe.MoeConfig(n_experts=e, top_k=k, capacity_factor=cf)
            assert tmoe._capacity(n, tc) == jmoe._capacity(n, jc)
    mix = tmoe.MoeConfig(n_experts=8, top_k=2, capacity_factor=1.25)
    # the call shapes of the serving paths (PERF.md §7)
    assert [tmoe._capacity(n, mix) for n in (8, 128, 72, 2048)] == [
        8, 40, 24, 640]


# -- stacked int8 ------------------------------------------------------------

def _stack(seed: int, shape=(4, DIM, HIDDEN)):
    w = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    w[1, :, 3] = 0.0                              # an all-zero channel
    return w * 0.05


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantized_einsum_matches_jax(dtype):
    entry = jquant.quantize_weight_stacked(jnp.asarray(_stack(7)))
    tentry = params_from_jax(jax.tree_util.tree_map(np.asarray, entry), "cpu")
    jx, tx = _x((4, 8, DIM), dtype, seed=8)
    want = jquant.maybe_einsum("ecd,edh->ech", jx, entry)
    got = tquant.maybe_einsum("ecd,edh->ech", tx, tentry)
    assert got.dtype == tx.dtype
    # the same f32 sums of the same bf16 operands, in other orders; a bf16
    # result may round one step apart
    tol = 1e-5 if dtype == "float32" else 2.0 ** -7
    np.testing.assert_allclose(_np(got), _jnp(want), rtol=tol, atol=1e-6)
    # the plain branch is a plain einsum
    w = _stack(9)
    np.testing.assert_allclose(
        tquant.maybe_einsum("ecd,edh->ech", tx.float(),
                            torch.from_numpy(w)).numpy(),
        np.asarray(jquant.maybe_einsum("ecd,edh->ech",
                                       jx.astype(jnp.float32),
                                       jnp.asarray(w))),
        rtol=1e-5, atol=1e-6)


def _flat(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/{i}"))
    else:
        out[prefix] = tree
    return out


def _tiny(dtype: str = "float32", **kw):
    jcfg = dataclasses.replace(JAX_MIXTRAL["mixtral-tiny"],
                               dtype=getattr(jnp, dtype), **kw)
    tcfg = dataclasses.replace(MIXTRAL_PRESETS["mixtral-tiny"],
                               dtype=getattr(torch, dtype), **kw)
    return jcfg, tcfg


def test_quantize_decoder_covers_moe_experts():
    jcfg, _ = _tiny("bfloat16")
    jparams = jax_init_decoder(jax.random.PRNGKey(10), jcfg)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              "cpu")
    want = jquant.quantize_decoder(jparams)
    once = tquant.quantize_decoder(tparams)
    got, wflat = _flat(once), _flat(want)
    assert set(got) == set(wflat)
    for path, leaf in got.items():
        assert str(leaf.dtype).split(".")[-1] == str(wflat[path].dtype), path
        np.testing.assert_array_equal(_np(leaf), _jnp(wflat[path]))
    moe = once["layers"][0]["moe"]
    assert moe["router"].dtype == torch.float32
    assert moe["router"] is tparams["layers"][0]["moe"]["router"]
    for name in ("w_gate", "w_up", "w_down"):
        assert moe[name]["q"].dtype == torch.int8
        assert moe[name]["scale"].shape[:2] == (jcfg.n_experts, 1)
    twice = _flat(tquant.quantize_decoder(once))
    assert all(twice[p] is got[p] for p in got)
    assert tquant.quantized_bytes(once) == jquant.quantized_bytes(want)
    # experts dominate: the int8 tree is well under 60% of the bf16 one
    assert tquant.quantized_bytes(once) < 0.6 * tquant.quantized_bytes(
        tparams)


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
def test_meta_trees_match_jax_eval_shape(quantized):
    jcfg = JAX_MIXTRAL["mixtral-8x7b"]
    tcfg = MIXTRAL_PRESETS["mixtral-8x7b"]
    jinit = jquant.init_quantized_decoder if quantized else jax_init_decoder
    tinit = tquant.init_quantized_decoder if quantized else init_decoder
    want = _flat(jax.eval_shape(lambda r: jinit(r, jcfg),
                                jax.random.PRNGKey(0)))
    got = _flat(tinit(tcfg, None, "meta"))
    assert set(got) == set(want)
    for path, leaf in got.items():
        assert leaf.device.type == "meta"
        assert tuple(leaf.shape) == tuple(want[path].shape), path
        assert str(leaf.dtype).split(".")[-1] == str(want[path].dtype), path
    assert "/layers/31/moe/w_down/scale" in got if quantized else \
        "/layers/31/moe/w_down" in got
    assert tquant.quantized_bytes(tinit(tcfg, None, "meta")) == \
        jquant.quantized_bytes(jax.eval_shape(lambda r: jinit(r, jcfg),
                                              jax.random.PRNGKey(0)))


def test_small_quantized_init_draws_a_moe_tree():
    _, tcfg = _tiny("bfloat16")
    gen = torch.Generator().manual_seed(0)
    tree = tquant.init_quantized_decoder(tcfg, gen, "cpu")
    moe = tree["layers"][1]["moe"]
    assert "w_gate" not in tree["layers"][1]
    assert moe["router"].dtype == torch.float32
    assert moe["w_up"]["q"].shape == (4, 128, 256)
    assert moe["w_up"]["q"].dtype == torch.int8
    assert float(moe["w_up"]["scale"].min()) > 0


# -- the decoder ----------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    """mixtral-tiny at f32: the JAX tree and its port twin."""
    jcfg, tcfg = _tiny()
    jparams = jax_init_decoder(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              "cpu")
    return jparams, jcfg, tparams, tcfg


def test_mixtral_decoder_paths(tiny):
    jparams, jcfg, tparams, tcfg = tiny
    assert "moe" in tparams["layers"][0]
    toks = np.random.default_rng(12).integers(0, jcfg.vocab_size, (2, 16))
    jt, tt = jnp.asarray(toks, jnp.int32), torch.from_numpy(toks)
    want = np.asarray(jax_forward(jparams, jt, jcfg))
    got = decoder_forward(tparams, tt, tcfg).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
    _, jaux = jax_forward(jparams, jt, jcfg, return_moe_aux=True)
    logits, taux = decoder_forward(tparams, tt, tcfg, return_moe_aux=True)
    np.testing.assert_allclose(logits.numpy(), got, atol=0)
    assert float(taux) == pytest.approx(float(jaux), rel=1e-6)
    assert float(taux) >= 1.0 - 1e-4

    # dense prefill of 8 tokens, then one decode step
    jcache = jax_init_kv_cache(jcfg, 2, 64)
    tcache = init_kv_cache(tcfg, 2, 64)
    jl, jcache = jax_forward(jparams, jt[:, :8], jcfg, kv_cache=jcache)
    tl, tcache = decoder_forward(tparams, tt[:, :8], tcfg, kv_cache=tcache)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    tok = np.array(jl[:, -1:].argmax(-1))
    np.testing.assert_array_equal(tl[:, -1:].argmax(-1).numpy(), tok)
    jl2, _ = jax_forward(jparams, jnp.asarray(tok, jnp.int32), jcfg,
                         positions=jnp.full((2, 1), 8, jnp.int32),
                         kv_cache=jcache,
                         cache_len=jnp.full((2,), 9, jnp.int32), decode=True)
    tl2, _ = decoder_forward(tparams, torch.from_numpy(tok), tcfg,
                             positions=torch.full((2, 1), 8),
                             kv_cache=tcache,
                             cache_len=torch.full((2,), 9), decode=True)
    assert tl2.shape == (2, 1, tcfg.vocab_size)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), atol=1e-4)
    # a dense model's aux is zero, and its forward is unchanged by asking
    dense = dataclasses.replace(tcfg, n_experts=0)
    dparams = init_decoder(dense, torch.Generator().manual_seed(0), "cpu")
    out, aux = decoder_forward(dparams, tt, dense, return_moe_aux=True)
    assert float(aux) == 0.0
    assert torch.equal(out, decoder_forward(dparams, tt, dense))


# -- the engines ---------------------------------------------------------------

PAGED = dict(max_batch=4, max_seq_len=128, prefill_buckets=(32, 64),
             decode_steps=(1, 4), kv_block_size=16, prefill_chunk=32,
             prefix_cache_blocks=16, admit_group_chunks=2)
DENSE = dict(max_batch=4, max_seq_len=256, prefill_buckets=(32, 128),
             decode_steps=(1, 4))


def _prompts():
    rng = np.random.default_rng(13)
    shared = rng.integers(1, 500, 40).tolist()
    return [shared + rng.integers(1, 500, 5).tolist(),
            shared + rng.integers(1, 500, 30).tolist(),
            rng.integers(1, 500, 23).tolist(),
            rng.integers(1, 500, 70).tolist()]


async def _serve(engine, prompts, max_new):
    await engine.start()
    try:
        outs = await asyncio.gather(*[
            engine.generate(p, max_new_tokens=max_new, request_id=f"r{i}")
            for i, p in enumerate(prompts)])
        again = await engine.generate(prompts[0], max_new_tokens=max_new)
    finally:
        await engine.stop()
    return outs, again


def _pair(jparams, jcfg, tparams, tcfg, knobs):
    return (JaxEngine(jparams, jcfg, JaxEngineConfig(**knobs)),
            InferenceEngine(tparams, tcfg, EngineConfig(**knobs),
                            device="cpu"))


def _same_streams(jeng, teng, prompts, max_new=8):
    want = asyncio.run(_serve(jeng, prompts, max_new))
    got = asyncio.run(_serve(teng, prompts, max_new))
    assert got == want
    assert all(len(o) == max_new for o in got[0])
    return jeng.stats(), teng.stats()


ENGINES = {"paged": PAGED, "paged-int8-pool": dict(PAGED, kv_quant="int8"),
           "dense": DENSE}


@pytest.mark.usefixtures("jax_table_copies")
@pytest.mark.parametrize("mode", list(ENGINES))
def test_greedy_streams_equal_the_jax_engines(tiny, mode):
    jparams, jcfg, tparams, tcfg = tiny
    jeng, teng = _pair(jparams, jcfg, tparams, tcfg, ENGINES[mode])
    js, ts = _same_streams(jeng, teng, _prompts())
    assert teng.paged == (mode != "dense")
    if teng.paged:
        assert ts["prefix_cache"]["hits"] == js["prefix_cache"]["hits"] >= 1
        assert ts["kv_blocks_used"] == js["kv_blocks_used"]
    assert ts["decode_steps"] == js["decode_steps"]


@pytest.mark.usefixtures("jax_table_copies")
def test_int8_tree_and_int8_pool_stream_as_jax(tiny):
    jparams, jcfg, _, tcfg = tiny
    jq = jquant.quantize_decoder(jparams)
    tq = params_from_jax(jax.tree_util.tree_map(np.asarray, jq), "cpu")
    assert tq["layers"][0]["moe"]["w_up"]["q"].dtype == torch.int8
    knobs = dict(PAGED, kv_quant="int8")
    jeng, teng = _pair(jq, jcfg, tq, tcfg, knobs)
    _, ts = _same_streams(jeng, teng, _prompts())
    assert ts["kv_quant"] == "int8" and teng.kv_cache["k"].dtype == torch.int8


@pytest.mark.usefixtures("jax_table_copies")
def test_spec_streams_equal_the_jax_engine(tiny):
    """Verify windows feed B*T tokens to the MoE layers in one call, so
    spec-on streams are each package's own contract: both engines admit
    every request before their first window and must agree token for
    token, counters included."""
    jparams, jcfg, tparams, tcfg = tiny
    knobs = dict(max_batch=2, max_seq_len=512, prefill_buckets=(32, 64),
                 decode_steps=(1, 4, 8), kv_block_size=32, prefill_chunk=32,
                 spec_len=8)
    jeng, teng = _pair(jparams, jcfg, tparams, tcfg, knobs)
    prompts = [[7, 8, 9, 7, 8, 9, 7, 8], list(range(2, 40))]

    def generate(engine):
        async def go():
            tasks = [asyncio.create_task(engine.generate(
                list(p), max_new_tokens=120)) for p in prompts]
            await asyncio.sleep(0)
            await engine.start()
            try:
                return await asyncio.gather(*tasks)
            finally:
                await engine.stop()
        return asyncio.run(go())

    want, got = generate(jeng), generate(teng)
    assert got == want
    js, ts = jeng.stats(), teng.stats()
    for key in ("spec_windows", "spec_proposed", "spec_accepted",
                "decode_steps", "tokens_generated"):
        assert ts[key] == js[key], key
    assert ts["spec_windows"] > 0 and ts["spec_accepted"] > 0


@pytest.mark.usefixtures("jax_table_copies")
def test_drops_in_every_chunk_stream_as_jax():
    """Capacity factor 0.25 at 32-token chunks: 8 slots for each of 4
    experts against 64 pairs, so every full chunk drops pairs, and the
    engines must drop the same ones."""
    jcfg, tcfg = _tiny(moe_capacity_factor=0.25)
    c = PAGED["prefill_chunk"]
    mcfg = tmoe.MoeConfig(n_experts=tcfg.n_experts, top_k=tcfg.moe_top_k,
                          capacity_factor=tcfg.moe_capacity_factor)
    assert tmoe._capacity(c, mcfg) * tcfg.n_experts < tcfg.moe_top_k * c
    jparams = jax_init_decoder(jax.random.PRNGKey(14), jcfg)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              "cpu")
    jeng, teng = _pair(jparams, jcfg, tparams, tcfg, PAGED)
    _same_streams(jeng, teng, _prompts())


@pytest.mark.usefixtures("jax_table_copies")
@pytest.mark.parametrize("mode", list(ENGINES))
def test_compile_ahead_reaches_the_dense_keys_and_streams_as_jax(tiny, mode):
    """An engine on the abstract mixtral tree precompiles the keys a dense
    config's engine reaches, the JAX factory's; its forwards over the
    zero-filled weights (every router row a tie) leave the KV state
    finite; bound, it serves the JAX engine's streams."""
    jparams, jcfg, tparams, tcfg = tiny
    knobs = ENGINES[mode]
    ahead = InferenceEngine(abstract_params(tparams), tcfg,
                            EngineConfig(**knobs), device="cpu")
    timings = ahead.precompile()
    reach = ahead.graphs.reachable_keys(ahead._buckets, ahead._spec_lens)
    assert set(timings) == {f"compile_{key_name(k)}_s" for k in reach}
    dcfg = dataclasses.replace(tcfg, n_experts=0)
    dense = InferenceEngine(abstract_params_for(dcfg), dcfg,
                            EngineConfig(**knobs), device="cpu")
    assert reach == dense.graphs.reachable_keys(dense._buckets,
                                                dense._spec_lens)
    trees = [ahead.kv_cache] + ([ahead._scratch] if ahead.paged else [])
    assert all(bool(torch.isfinite(t).all()) for tree in trees
               for t in tree.values() if t.is_floating_point())
    ahead.bind_params(tparams)
    jeng = JaxEngine(jparams, jcfg, JaxEngineConfig(**knobs))
    assert reach == jeng.graphs.reachable_keys(jeng._buckets,
                                               jeng._spec_lens)
    built = ahead.graphs.compiles
    _same_streams(jeng, ahead, _prompts())
    assert ahead.graphs.compiles == built
    assert ahead.stats()["graph_compiles_post_warmup"] == 0


# -- the weight format ------------------------------------------------------------

def _read_dir(path: str) -> dict:
    out = {}
    for name in sorted(os.listdir(path)):
        with open(os.path.join(path, name), "rb") as f:
            out[name] = f.read()
    return out


@pytest.mark.parametrize("when", ["at-save", "before-save"])
def test_int8_moe_shards_are_byte_identical(tmp_path, when):
    """v2 shards of an int8 MoE tree, quantized by ``save_params`` or
    before it, byte for byte the same from both packages; each reads the
    other's directory back bit for bit."""
    jcfg, _ = _tiny("bfloat16")
    jtree = jax.tree_util.tree_map(
        np.asarray, jax_init_decoder(jax.random.PRNGKey(15), jcfg))
    quantize = "int8" if when == "at-save" else None
    if quantize is None:
        jtree = jax.tree_util.tree_map(np.asarray,
                                       jquant.quantize_decoder(jtree))
    jdir, tdir = str(tmp_path / "jax.tpu9w"), str(tmp_path / "torch.tpu9w")
    jindex = jw.save_params(jtree, jdir, quantize=quantize)
    tindex = tw.save_params(params_from_jax(jtree, "cpu"), tdir,
                            quantize=quantize)
    assert jindex == tindex and tindex["version"] == 2
    assert _read_dir(jdir) == _read_dir(tdir)
    roles = {e["key"]: e.get("role") for e in tindex["leaves"]}
    assert roles["layers/1/moe/w_down/q"] == "q"
    assert roles["layers/1/moe/w_down/scale"] == "scale"
    assert roles["layers/1/moe/router"] is None
    for src in (jdir, tdir):
        a, b = _flat(tw.load_params(src)), _flat(jw.load_params(src))
        assert set(a) == set(b)
        for path in a:
            np.testing.assert_array_equal(_bits(a[path]), _bits(b[path]),
                                          err_msg=path)


def _bits(leaf) -> np.ndarray:
    """A leaf of either package as numpy, bf16 as its 16-bit words."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.uint16).numpy()
        return leaf.numpy()
    arr = np.asarray(leaf)
    return arr.view(np.uint16) if arr.dtype.name == "bfloat16" else arr
