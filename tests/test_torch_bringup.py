"""Compile-ahead bring-up of the port (``tpu9_torch.serving``) against the
JAX package's, on llama-tiny at f32, the port's params converted from the
JAX ones by ``params_from_jax``.

An engine built on an abstract tree (``abstract_params``: meta tensors)
holds zero-filled weight storage, ``precompile`` builds every computation
the serve loop can reach (the key set of ``reachable_keys``, the JAX
factory's GRA005 invariant) and seals, ``bind_params`` copies the real
weights into that storage without moving a tensor, and ``warmup`` then
builds nothing; it streams the greedy tokens of an engine built the classic
way and of the JAX compile-ahead engine, dense, paged and with the int8
pool. ``load_engine(compile_ahead=True)`` reports the reference's
``bringup`` keys and precompile timing names and records the reference's
``restore.load`` / ``restore.compile_ahead`` / ``restore.bind`` spans under
a ``runner.bringup`` root, in a tracer the caller hands in; it precompiles
on the calling thread while the weights are drawn on ``tpu9-weight-load``,
and an error on either side is raised after the join. ``params_spec`` and
``abstract_state`` give the shapes real params and a built engine have,
and ``ckpt.load_params`` records the reference's ``restore.load`` span."""

import asyncio
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu9.models import decoder_forward as jax_forward
from tpu9.models import init_decoder as jax_init_decoder
from tpu9.models.llama import LLAMA_PRESETS as JAX_PRESETS
from tpu9.observability import coldstart as jax_cs
from tpu9.observability.trace import Tracer
from tpu9.observability.trace import tracer as jax_tracer
from tpu9.serving.engine import EngineConfig as JaxEngineConfig
from tpu9.serving.engine import InferenceEngine as JaxEngine
from tpu9.serving.engine import abstract_params as jax_abstract_params
from tpu9.serving.presets import load_engine as jax_load_engine
from tpu9.serving.presets import params_spec as jax_params_spec
from tpu9_torch.bridge import params_from_jax
from tpu9_torch.models.llama import LLAMA_PRESETS
from tpu9_torch.serving import presets as tpresets
from tpu9_torch.serving.engine import (EngineConfig, InferenceEngine,
                                       abstract_params)
from tpu9_torch.serving.graphs import abstract_state, key_name
from tpu9_torch.serving.presets import (build_params, load_engine,
                                        params_spec)

torch.set_num_threads(2)


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


BASE = dict(max_batch=2, max_seq_len=128, prefill_buckets=(16, 64),
            decode_steps=(1, 4), temperature=0.0)
PAGED = dict(BASE, kv_block_size=8, prefill_chunk=16, admit_group_chunks=2,
             prefix_cache_blocks=8)
LAYOUTS = {"dense": BASE, "paged": PAGED,
           "int8": dict(PAGED, kv_quant="int8"),
           "spec": dict(PAGED, spec_len=4)}
# the same knobs through either package's load_engine
LOAD = dict(max_batch=2, max_seq_len=128, prefill_buckets=(16, 64),
            decode_steps=(1, 4))


@pytest.fixture(scope="module")
def tiny():
    jcfg = dataclasses.replace(JAX_PRESETS["llama-tiny"], dtype=jnp.float32)
    tcfg = dataclasses.replace(LLAMA_PRESETS["llama-tiny"],
                               dtype=torch.float32)
    jparams = jax_init_decoder(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              "cpu")
    return jcfg, jparams, tcfg, tparams


def _leaves(tree, path: str = ""):
    """``(path, leaf)`` of a tree of dicts and lists, torch or JAX."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}".lstrip("/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}".lstrip("/"))
    else:
        yield path, tree


def _signature(tree) -> dict:
    """path → (shape, dtype name), the same for a torch and a JAX tree."""
    return {p: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
            for p, t in _leaves(tree)}


def _ahead(tcfg, tparams, ecfg: dict):
    """A port engine on the abstract tree, precompiled; returns it and the
    precompile's timings (the weights are not bound yet)."""
    engine = InferenceEngine(abstract_params(tparams), tcfg,
                             EngineConfig(**ecfg), device="cpu")
    return engine, engine.precompile()


def _prompts():
    rng = np.random.default_rng(5)
    shared = rng.integers(1, 500, 20).tolist()
    return [shared + rng.integers(1, 500, 4).tolist(),
            rng.integers(1, 500, 9).tolist(),
            shared + rng.integers(1, 500, 13).tolist()]


async def _serve(engine, prompts, max_new=6):
    await engine.start()
    try:
        return await asyncio.gather(*[
            engine.generate(p, max_new_tokens=max_new) for p in prompts])
    finally:
        await engine.stop()


def _judge(jparams, jcfg, prompts, want, got) -> None:
    """Streams equal, or (int8 pool) forked at a near-tie: the port's token
    within 0.35 of the argmax of a full-context JAX forward, as
    ``tests/test_quant_serving.py`` judges a fork."""
    for prompt, w, g in zip(prompts, want, got):
        assert len(g) == len(w)
        for i, (a, b) in enumerate(zip(w, g)):
            if a != b:
                logits = jax_forward(
                    jparams, jnp.asarray([prompt + g[:i]], jnp.int32),
                    jcfg)[0, -1]
                assert float(jnp.max(logits) - logits[b]) < 0.35, (i, a, b)
                break


@pytest.mark.usefixtures("jax_table_copies")
@pytest.mark.parametrize("layout", ["dense", "paged", "int8"])
def test_abstract_then_bound_streams_equal_classic_and_jax(tiny, layout):
    """Mirror of ``tests/test_serving.py::test_compile_ahead_abstract_
    precompile_then_bind`` on both layouts and the int8 pool."""
    jcfg, jparams, tcfg, tparams = tiny
    ecfg = LAYOUTS[layout]
    ahead, timings = _ahead(tcfg, tparams, ecfg)
    ptrs = [t.data_ptr() for _, t in _leaves(ahead.params)]
    ahead.bind_params(tparams)
    assert [t.data_ptr() for _, t in _leaves(ahead.params)] == ptrs
    built = ahead.graphs.compiles
    ahead.warmup()
    assert ahead.graphs.compiles == built
    classic = InferenceEngine(tparams, tcfg, EngineConfig(**ecfg),
                              device="cpu")
    classic.warmup()

    jahead = JaxEngine(jax_abstract_params(jparams), jcfg,
                       JaxEngineConfig(**ecfg))
    jtimings = jahead.precompile()
    jahead.bind_params(jparams)
    jahead.warmup()
    assert set(timings) == set(jtimings)

    prompts = _prompts()
    got = asyncio.run(_serve(ahead, prompts))
    assert got == asyncio.run(_serve(classic, prompts))
    want = asyncio.run(_serve(jahead, prompts))
    if layout == "int8":
        _judge(jparams, jcfg, prompts, want, got)
    else:
        assert got == want
    assert ahead.stats()["graph_compiles_post_warmup"] == 0


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_precompiled_keys_equal_reachable_keys_and_the_jax_factory(tiny,
                                                                   layout):
    """The GRA005 analogue: the precompiled key set, the enumeration's key
    set and ``reachable_keys`` are one set, the JAX factory's."""
    jcfg, jparams, tcfg, tparams = tiny
    ecfg = LAYOUTS[layout]
    engine, timings = _ahead(tcfg, tparams, ecfg)
    g = engine.graphs
    reach = g.reachable_keys(engine._buckets, engine._spec_lens)
    assert set(g.compiled) == reach
    jobs = g.lowering_jobs(engine.params, engine.kv_cache,
                           engine._pool_dict() if engine.paged else {},
                           engine._scratch if engine.paged else {},
                           engine.pool.mb if engine.paged else 0,
                           engine._buckets, engine._spec_lens)
    assert {key for key, _, _ in jobs} == reach
    assert set(timings) == {f"compile_{key_name(k)}_s" for k in reach}
    jeng = JaxEngine(jparams, jcfg, JaxEngineConfig(**ecfg))
    assert reach == jeng.graphs.reachable_keys(jeng._buckets,
                                               jeng._spec_lens)
    # sealed: a key the serve loop never reaches is a post-warmup build
    assert g.post_seal_compiles == 0
    g.decode_k(2)
    assert g.post_seal_compiles == 1


@pytest.mark.parametrize("layout", ["paged", "spec"])
def test_warmup_after_precompile_builds_nothing(tiny, layout):
    _, _, tcfg, tparams = tiny
    engine, _ = _ahead(tcfg, tparams, LAYOUTS[layout])
    engine.bind_params(tparams)
    built = engine.graphs.compiles
    timings = engine.warmup()
    assert timings and engine.graphs.compiles == built
    assert engine.stats()["graph_compiles_post_warmup"] == 0


@pytest.mark.parametrize("layout", ["dense", "paged", "int8"])
def test_precompile_over_zero_weights_leaves_the_kv_state_finite(tiny,
                                                                 layout):
    """Zeros, not garbage: a forward over the zero-filled storage writes
    no NaN or inf into the pool, its scales, the cache or the scratch."""
    _, _, tcfg, tparams = tiny
    engine, _ = _ahead(tcfg, tparams, LAYOUTS[layout])
    assert all(not t.is_meta and not t.any() for _, t in
               _leaves(engine.params))
    trees = [engine.kv_cache] + ([engine._scratch] if engine.paged else [])
    floats = [t for tree in trees for t in tree.values()
              if t.is_floating_point()]
    assert floats and all(bool(torch.isfinite(t).all()) for t in floats)


@pytest.mark.parametrize("case", ["shape", "dtype", "missing", "extra"])
def test_bind_rejects_a_mismatched_leaf_and_names_it(tiny, case):
    _, _, tcfg, tparams = tiny
    engine = InferenceEngine(abstract_params(tparams), tcfg,
                             EngineConfig(**BASE), device="cpu")
    bad = {**tparams, "layers": [dict(layer) for layer in tparams["layers"]]}
    layer = bad["layers"][1]
    path = "layers/1/wq"
    if case == "shape":
        layer["wq"] = layer["wq"][:, :-1]
    elif case == "dtype":
        layer["wq"] = layer["wq"].to(torch.bfloat16)
    elif case == "missing":
        del layer["wq"]
    else:
        layer["extra"] = layer["wq"]
        path = "layers/1/extra"
    with pytest.raises(ValueError, match=path):
        engine.bind_params(bad)
    # nothing was written before the refusal
    assert not any(t.any() for _, t in _leaves(engine.params))


def test_a_partly_abstract_tree_is_refused_naming_the_leaf(tiny):
    _, _, tcfg, tparams = tiny
    mixed = dict(tparams, embed=abstract_params(tparams["embed"]))
    with pytest.raises(ValueError, match="param embed is on meta"):
        InferenceEngine(mixed, tcfg, EngineConfig(**BASE), device="cpu")


def _spans_under(export: list, root_name: str) -> tuple[dict, dict]:
    root = [sp for sp in export if sp["name"] == root_name][0]
    return root, {sp["name"]: sp for sp in export
                  if sp["parentSpanId"] == root["spanId"]}


async def _one(engine, prompt):
    await engine.start()
    try:
        return await engine.generate(prompt, max_new_tokens=4)
    finally:
        await engine.stop()


def test_load_engine_compile_ahead_equals_the_jax_bringup():
    """Mirror of ``tests/test_serving.py::test_load_engine_compile_ahead_
    overlaps_weight_build``: the same ``bringup`` keys and precompile
    timing names, the same three spans under a ``runner.bringup`` root
    with the same attribute keys, the reference's fold of the spans
    agreeing with ``bringup``, and the tokens of the classic engine."""
    tr = Tracer()
    with tr.span(jax_cs.SPAN_BRINGUP) as root:
        eng = load_engine("llama-tiny", device="cpu", compile_ahead=True,
                          tracer=tr, **LOAD)
    with jax_tracer.span(jax_cs.SPAN_BRINGUP) as jroot:
        jeng = jax_load_engine("llama-tiny", compile_ahead=True, **LOAD)
    assert set(eng.bringup) == set(jeng.bringup) == {
        "load_s", "compile_ahead_s", "bind_s", "compile_overlap_s"}
    assert eng.bringup["compile_overlap_s"] <= eng.bringup["compile_ahead_s"]
    assert set(eng.compile_ahead_timings) == set(jeng.compile_ahead_timings)
    assert eng.stats()["coldstart_load_s"] == eng.bringup["load_s"]

    spans = tr.export(trace_id=root.trace_id)
    jspans = jax_tracer.export(trace_id=jroot.trace_id)
    _, kids = _spans_under(spans, jax_cs.SPAN_BRINGUP)
    _, jkids = _spans_under(jspans, jax_cs.SPAN_BRINGUP)
    names = {jax_cs.SPAN_LOAD, jax_cs.SPAN_COMPILE_AHEAD, jax_cs.SPAN_BIND}
    assert names <= set(kids) and names <= set(jkids)
    for name in names:
        assert set(kids[name]["attributes"]) == \
            set(jkids[name]["attributes"]), name
    assert kids[jax_cs.SPAN_LOAD]["attributes"]["source"] == "build"
    assert kids[jax_cs.SPAN_COMPILE_AHEAD]["attributes"]["graphs"] == len(
        eng.compile_ahead_timings)
    assert not kids[jax_cs.SPAN_COMPILE_AHEAD]["attributes"]["failed"]
    traced = jax_cs.decompose_spans(spans)
    assert jax_cs.agreement(traced["compile_ahead_s"],
                            eng.bringup["compile_ahead_s"]) < 0.10

    built = eng.graphs.compiles
    eng.warmup()
    assert eng.graphs.compiles == built
    classic = load_engine("llama-tiny", device="cpu", **LOAD)
    classic.warmup()
    assert asyncio.run(_one(eng, [1, 2, 3])) == \
        asyncio.run(_one(classic, [1, 2, 3]))


def test_load_engine_compile_ahead_on_the_dense_and_int8_engines():
    for knobs in ({"paged": False}, {"kv_quant": "int8"}):
        eng = load_engine("llama-tiny", device="cpu", compile_ahead=True,
                          **LOAD, **knobs)
        reach = eng.graphs.reachable_keys(eng._buckets, eng._spec_lens)
        assert set(eng.compile_ahead_timings) == {
            f"compile_{key_name(k)}_s" for k in reach}
        ref, _ = build_params("llama-tiny", device="cpu")
        have = dict(_leaves(eng.params))
        assert all(torch.equal(have[p], t) for p, t in _leaves(ref))


def test_a_compile_ahead_error_is_raised_after_the_join(monkeypatch):
    """A deliberate difference from the reference, which logs a failed
    precompile and compiles lazily: the error surfaces once the load has
    been joined, after the load and compile windows are recorded
    (``failed`` true), before any bind. The other: the precompile runs on
    the calling thread, the draws on ``tpu9-weight-load``."""
    threads = {}
    real_build = tpresets.build_params

    def boom(self):
        threads["precompile"] = threading.current_thread().name
        raise RuntimeError("capture failed")

    def build(*args, **kwargs):
        threads["load"] = threading.current_thread().name
        return real_build(*args, **kwargs)

    monkeypatch.setattr(InferenceEngine, "precompile", boom)
    monkeypatch.setattr(tpresets, "build_params", build)
    tr = Tracer()
    with tr.span(jax_cs.SPAN_BRINGUP):
        with pytest.raises(RuntimeError, match="capture failed"):
            load_engine("llama-tiny", device="cpu", compile_ahead=True,
                        tracer=tr, **LOAD)
    assert threads == {"precompile": threading.current_thread().name,
                       "load": "tpu9-weight-load"}
    names = {sp["name"]: sp for sp in tr.export()}
    assert names[jax_cs.SPAN_COMPILE_AHEAD]["attributes"]["failed"] is True
    assert jax_cs.SPAN_LOAD in names and jax_cs.SPAN_BIND not in names


def test_a_load_error_is_raised_after_the_precompile(monkeypatch):
    def broken(*args, **kwargs):
        raise OSError("weights unreadable")

    monkeypatch.setattr(tpresets, "build_params", broken)
    with pytest.raises(OSError, match="weights unreadable"):
        load_engine("llama-tiny", device="cpu", compile_ahead=True, **LOAD)


@pytest.mark.parametrize("name", ["llama-tiny", "llama-tiny-int8",
                                  "gemma-tiny", "gemma-tiny-int8",
                                  "mixtral-tiny", "mixtral-tiny-int8"])
def test_params_spec_matches_build_params_and_the_jax_spec(name):
    spec, cfg = params_spec(name)
    assert all(t.is_meta for _, t in _leaves(spec))
    real, rcfg = build_params(name, device="cpu")
    assert cfg == rcfg
    assert _signature(spec) == _signature(real)
    jspec, _ = jax_params_spec(name)
    assert _signature(spec) == _signature(jspec)
    assert _signature(abstract_params(real)) == _signature(real)
    assert tpresets.abstract_params_for(cfg, name.endswith("-int8")) \
        .keys() == spec.keys()


@pytest.mark.parametrize("layout", ["dense", "paged", "int8"])
def test_abstract_state_shapes_equal_a_built_engine(tiny, layout):
    _, _, tcfg, tparams = tiny
    ecfg = EngineConfig(**LAYOUTS[layout])
    st = abstract_state(tcfg, ecfg, kv_quant=layout == "int8")
    engine = InferenceEngine(tparams, tcfg, ecfg, device="cpu")
    assert all(t.is_meta for tree in (st["kv_cache"], st["scratch"])
               for _, t in _leaves(tree))
    assert _signature(st["kv_cache"]) == _signature(engine.kv_cache)
    if engine.paged:
        assert _signature(st["pool"]) == _signature(engine._pool_dict())
        assert _signature(st["scratch"]) == _signature(engine._scratch)
        assert st["mb"] == engine.pool.mb
    else:
        assert st["pool"] == {} and st["scratch"] == {} and st["mb"] == 0


def test_ckpt_load_params_records_the_reference_restore_load_span(
        tiny, tmp_path, monkeypatch):
    """The same ``.tpu9w`` directory loaded by both packages' ``ckpt``: the
    port's ``restore.load`` span, in the tracer it is handed, has the
    reference's name, parent and attributes."""
    from tpu9.runner import ckpt as jax_ckpt
    from tpu9_torch.runner import ckpt

    monkeypatch.setenv("TPU9_WORKDIR", str(tmp_path))
    _, _, _, tparams = tiny
    ckpt.save_params(tparams)
    tr = Tracer()
    with tr.span(jax_cs.SPAN_BRINGUP) as root:
        got = ckpt.load_params(device="cpu", tracer=tr)
    with jax_tracer.span(jax_cs.SPAN_BRINGUP) as jroot:
        jax_ckpt.load_params()
    _, kids = _spans_under(tr.export(trace_id=root.trace_id),
                           jax_cs.SPAN_BRINGUP)
    _, jkids = _spans_under(jax_tracer.export(trace_id=jroot.trace_id),
                            jax_cs.SPAN_BRINGUP)
    assert set(kids) == set(jkids) == {jax_cs.SPAN_LOAD}
    assert kids[jax_cs.SPAN_LOAD]["attributes"] == \
        jkids[jax_cs.SPAN_LOAD]["attributes"]
    assert all(torch.equal(a, b) for (_, a), (_, b) in
               zip(_leaves(got), _leaves(tparams)))
    # without a tracer nothing is recorded
    before = len(tr.finished)
    ckpt.load_params(device="cpu")
    assert len(tr.finished) == before
