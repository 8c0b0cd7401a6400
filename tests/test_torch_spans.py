"""The port engine's spans and bring-up bookkeeping against the JAX
engine's, on llama-tiny at f32 (the port's params converted by
``params_from_jax``).

Mirror of ``tests/test_flight.py::test_engine_spans_under_remote_context``:
with a tracer handed in (a fresh ``tpu9.observability.trace.Tracer``), a
request carrying a remote trace context records ``engine.request``
(backdated to its enqueue, parented to the remote span) and, under it,
``engine.queue_wait``, ``engine.prefill`` and ``engine.decode_window``
spans, with the JAX engine's names, parent links and attribute keys; the
decode windows' tokens sum to n - 1; an untraced request records nothing;
``blackbox()["spans"]`` is the tracer's tail. ``note_group_bound`` gives
the JAX engine's ``scaleout_*`` stats, and the port's copies of the
cold-start span names and of ``interval_overlap_s`` equal the
reference's."""

import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu9.models import init_decoder as jax_init_decoder
from tpu9.models.llama import LLAMA_PRESETS as JAX_PRESETS
from tpu9.observability import coldstart as jax_cs
from tpu9.observability.trace import Tracer
from tpu9.observability.trace import tracer as jax_tracer
from tpu9.serving.engine import EngineConfig as JaxEngineConfig
from tpu9.serving.engine import InferenceEngine as JaxEngine
from tpu9_torch.bridge import params_from_jax
from tpu9_torch.models.llama import LLAMA_PRESETS
from tpu9_torch.observability import coldstart as cs
from tpu9_torch.serving.engine import EngineConfig, InferenceEngine

torch.set_num_threads(2)

PAGED = dict(max_batch=2, max_seq_len=128, prefill_buckets=(16, 64),
             decode_steps=(1, 4), kv_block_size=16, prefill_chunk=16,
             prefix_cache_blocks=8, admit_group_chunks=2)
DENSE = dict(max_batch=2, max_seq_len=128, prefill_buckets=(16, 64),
             decode_steps=(1, 4))
MODES = {"paged": PAGED, "dense": DENSE}
CHILDREN = ("engine.queue_wait", "engine.prefill", "engine.decode_window")


@pytest.fixture(scope="module")
def tiny():
    jcfg = dataclasses.replace(JAX_PRESETS["llama-tiny"], dtype=jnp.float32)
    tcfg = dataclasses.replace(LLAMA_PRESETS["llama-tiny"],
                               dtype=torch.float32)
    jparams = jax_init_decoder(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              "cpu")
    return jcfg, jparams, tcfg, tparams


def _traced(engine, trace_id: str, parent: str, count):
    """One traced request (8 prompt tokens, 6 new), then an untraced one;
    returns the traced tokens and the span count the untraced one added
    (``count()`` reads the tracer's ring)."""
    async def go():
        await engine.start()
        try:
            out = await engine.generate(list(range(8)), max_new_tokens=6,
                                        trace=(trace_id, parent))
            before = count()
            await engine.generate(list(range(8)), max_new_tokens=2)
            return out, count() - before
        finally:
            await engine.stop()
    return asyncio.run(go())


def _by_name(spans: list) -> dict:
    out: dict = {}
    for sp in spans:
        out.setdefault(sp["name"], []).append(sp)
    return out


@pytest.mark.parametrize("mode", sorted(MODES))
def test_engine_spans_equal_the_jax_engine(tiny, mode):
    jcfg, jparams, tcfg, tparams = tiny
    tr = Tracer()
    teng = InferenceEngine(tparams, tcfg, EngineConfig(**MODES[mode]),
                           device="cpu", tracer=tr)
    jeng = JaxEngine(jparams, jcfg, JaxEngineConfig(**MODES[mode]))
    parent = "cd" * 8
    out, added = _traced(teng, "ab" * 16, parent, lambda: len(tr.finished))
    jout, _ = _traced(jeng, "ef" * 16, parent,
                      lambda: len(jax_tracer.finished))
    assert out == jout and len(out) == 6
    assert added == 0, "an untraced request recorded spans"
    got = _by_name(tr.export(trace_id="ab" * 16))
    want = _by_name(jax_tracer.export(trace_id="ef" * 16))
    assert set(got) == set(want) == {"engine.request", *CHILDREN}
    for name in got:
        keys = {frozenset(sp["attributes"]) for sp in got[name]}
        assert keys == {frozenset(sp["attributes"]) for sp in want[name]}, \
            name
    req = got["engine.request"][0]
    assert len(got["engine.request"]) == 1
    assert req["parentSpanId"] == parent
    assert req["attributes"]["prompt_tokens"] == 8
    assert req["attributes"]["tokens_generated"] == 6
    assert req["attributes"]["tp"] == req["attributes"]["n_chips"] == 1
    assert req["status"] == "ok"
    for child in CHILDREN:
        for sp in got[child]:
            assert sp["parentSpanId"] == req["spanId"]
            # gapless: children sit inside the request span's interval
            assert sp["startTimeUnixNano"] >= req["startTimeUnixNano"]
            assert sp["endTimeUnixNano"] <= req["endTimeUnixNano"] + 10**6
    windows = got["engine.decode_window"]
    assert sum(sp["attributes"]["tokens"] for sp in windows) == 5
    assert all(sp["attributes"]["k"] >= 1 for sp in windows)


def test_blackbox_ships_the_tracer_tail(tiny):
    _, _, tcfg, tparams = tiny
    tr = Tracer()
    engine = InferenceEngine(tparams, tcfg, EngineConfig(**PAGED),
                             device="cpu", tracer=tr)
    assert engine.blackbox("probe")["spans"] == []
    _traced(engine, "12" * 16, "34" * 8, lambda: len(tr.finished))
    spans = engine.blackbox("probe")["spans"]
    assert spans and spans == tr.export(limit=128)
    bare = InferenceEngine(tparams, tcfg, EngineConfig(**PAGED),
                           device="cpu")
    _traced(bare, "56" * 16, "78" * 8, lambda: 0)
    assert bare.blackbox("probe")["spans"] == []


def test_a_traced_request_without_a_tracer_records_nothing(tiny):
    """The trace context still rides the request (the runner's drain reads
    it), but an engine built without a tracer opens no span."""
    _, _, tcfg, tparams = tiny
    engine = InferenceEngine(tparams, tcfg, EngineConfig(**DENSE),
                             device="cpu")

    async def go():
        await engine.start()
        try:
            req = await engine.generate([3, 4, 5], max_new_tokens=3,
                                        stream=True, trace=("a" * 32, "b"))
            while await req.queue.get() is not None:
                pass
            return req
        finally:
            await engine.stop()

    req = asyncio.run(go())
    assert req.trace == ("a" * 32, "b") and req.span is None
    assert req.span_id == ""


SCALEOUT = [("embed", 3), ("layers.0", 3), ("embed", 3), ("layers.1", 4),
            ("", 4)]


@pytest.mark.parametrize("n_calls", range(len(SCALEOUT) + 1))
def test_scaleout_stats_equal_the_jax_engine(tiny, n_calls):
    jcfg, jparams, tcfg, tparams = tiny
    teng = InferenceEngine(tparams, tcfg, EngineConfig(**DENSE),
                           device="cpu")
    jeng = JaxEngine(jparams, jcfg, JaxEngineConfig(**DENSE))
    for group, total in SCALEOUT[:n_calls]:
        teng.note_group_bound(group, total)
        jeng.note_group_bound(group, total)
    got = {k: v for k, v in teng.stats().items()
           if k.startswith("scaleout_")}
    want = {k: v for k, v in jeng.stats().items()
            if k.startswith("scaleout_")}
    assert got == want and len(got) == 4


def test_coldstart_span_names_equal_the_reference():
    names = {n: getattr(cs, n) for n in dir(cs) if n.startswith("SPAN_")}
    want = {n: getattr(jax_cs, n) for n in dir(jax_cs)
            if n.startswith("SPAN_")}
    assert names == want and len(names) == 8


@pytest.mark.parametrize("a,b", [
    ((0.0, 2.0), (1.0, 3.0)), ((1.0, 3.0), (0.0, 2.0)),
    ((0.0, 1.0), (2.0, 3.0)), ((0.0, 4.0), (1.0, 2.0)),
    ((0.0, 1.0), None), (None, (0.0, 1.0)), ((None, None), (0.0, 1.0)),
    ((5.0, 5.0), (5.0, 5.0)), ((0.25, 1.75), (1.5, 9.0))])
def test_interval_overlap_copy_equals_the_reference(a, b):
    assert cs.interval_overlap_s(a, b) == jax_cs.interval_overlap_s(a, b)
