"""The port's engine behind the unchanged runner (``tpu9/runner/llm.py``),
against the JAX engine on llama-tiny at f32 (the port's params converted
from the JAX ones by ``params_from_jax``), paged and dense.

``stats()`` carries exactly the JAX engine's key set, the ``kvwire_``
family included and, with a host tier, the ``kvtier_`` family, with the
fields of ``[surface.engine_stats]`` in ``tpu9/analysis/contracts.toml``,
and with speculation on the same spec counters; verify windows' flight
records carry the reference's ``spec_*`` fields; a
cancelled stream frees its slot and blocks; flight records, the profiling
hook, the black box and the tiering hooks of the pressure heartbeat answer
as the reference's do. The own copies of the flight recorder and of the
latency summaries behave as the reference modules. Three LocalStack e2es
serve the torch engine (on the CPU) behind the real runner: one with the
default environment, KV tiering armed and speculative decoding on:
buffered and SSE greed equal to the JAX engine's, the pressure heartbeat in the router table, a client
disconnect that frees the slot, ``/flight`` and ``/profile``; the other
with a shared ``TPU9_KV_CACHE_DIR``, where a JAX replica publishes a
prefix after prefill and the torch replica serves a request that carries
``adopt_kv`` from it; the third with checkpointing on, where the handler
saves its params through ``tpu9_torch.runner.ckpt`` on the first boot and
the container restored after scale to zero loads them without calling its
init and streams the same tokens; the fourth builds its engine the way the
runner builds a preset's, ``load_engine(compile_ahead=True)`` with the
runner's tracer, and its heartbeat carries the compile-ahead bring-up."""

import asyncio
import dataclasses
import glob
import json
import os
import tomllib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu9.models import init_decoder as jax_init_decoder
from tpu9.models.llama import LLAMA_PRESETS as JAX_PRESETS
from tpu9.observability.health import build_postmortem
from tpu9.observability.metrics import _Summary as JaxSummary
from tpu9.serving.engine import EngineConfig as JaxEngineConfig
from tpu9.serving.engine import InferenceEngine as JaxEngine
from tpu9.serving.flight import FlightRecorder as JaxFlightRecorder
from tpu9_torch.bridge import params_from_jax
from tpu9_torch.models.llama import LLAMA_PRESETS
from tpu9_torch.observability.metrics import _Summary
from tpu9_torch.serving.engine import EngineConfig, InferenceEngine
from tpu9_torch.serving.flight import FlightRecorder

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


ROOT = Path(__file__).resolve().parent.parent
PAGED = dict(max_batch=2, max_seq_len=128, prefill_buckets=(16, 64),
             decode_steps=(1, 4), kv_block_size=16, prefill_chunk=16,
             prefix_cache_blocks=8, admit_group_chunks=2)
DENSE = dict(max_batch=2, max_seq_len=128, prefill_buckets=(16, 64),
             decode_steps=(1, 4))
MODES = {"paged": PAGED, "dense": DENSE,
         "paged-tiered": dict(PAGED, kv_host_pool_mb=64)}


@pytest.fixture(scope="module")
def tiny():
    jcfg = dataclasses.replace(JAX_PRESETS["llama-tiny"], dtype=jnp.float32)
    tcfg = dataclasses.replace(LLAMA_PRESETS["llama-tiny"],
                               dtype=torch.float32)
    jparams = jax_init_decoder(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              "cpu")
    return jcfg, jparams, tcfg, tparams


def _pair(tiny, ecfg: dict):
    jcfg, jparams, tcfg, tparams = tiny
    return (JaxEngine(jparams, jcfg, JaxEngineConfig(**ecfg)),
            InferenceEngine(tparams, tcfg, EngineConfig(**ecfg),
                            device="cpu"))


def _prompts():
    rng = np.random.default_rng(3)
    shared = rng.integers(1, 500, 36).tolist()
    return [shared + rng.integers(1, 500, 6).tolist(),
            rng.integers(1, 500, 9).tolist(),
            shared + rng.integers(1, 500, 20).tolist()]


async def _serve(engine, prompts, max_new=6, sequential=False):
    await engine.start()
    try:
        if sequential:
            return [await engine.generate(p, max_new_tokens=max_new)
                    for p in prompts]
        return await asyncio.gather(*[
            engine.generate(p, max_new_tokens=max_new) for p in prompts])
    finally:
        await engine.stop()


def _contract_fields() -> list[str]:
    with open(ROOT / "tpu9" / "analysis" / "contracts.toml", "rb") as f:
        return tomllib.load(f)["surface"]["engine_stats"]["fields"]


@pytest.mark.usefixtures("jax_table_copies")
@pytest.mark.parametrize("mode", list(MODES))
def test_stats_keys_equal_the_jax_engine(tiny, mode, monkeypatch):
    monkeypatch.delenv("TPU9_KV_TIER", raising=False)
    monkeypatch.delenv("TPU9_KV_HOST_POOL_MB", raising=False)
    jeng, teng = _pair(tiny, MODES[mode])
    for e in (jeng, teng):
        e.warmup()
        e.bringup = {"warmup_s": 1.5, "restored": 0}
    jout = asyncio.run(_serve(jeng, _prompts()))
    tout = asyncio.run(_serve(teng, _prompts()))
    assert tout == jout
    for e in (jeng, teng):
        # a kvwire export and a ship sample add their latency keys
        e.export_prefix_kv(_prompts()[0])
        e.note_kvwire_ship(0.01)
    js, ts = jeng.stats(), teng.stats()
    assert set(ts) == set(js)
    assert any(k.startswith("kvtier_") for k in ts) == mode.endswith("tiered")
    for key in [k for k in js if k.startswith(("kvwire_", "kvtier_"))
                and not k.endswith("_s")]:
        assert ts[key] == js[key], key
    emitted = [f for f in _contract_fields() if f in js]
    assert len(emitted) > 30 and set(emitted) <= set(ts)
    for nested in ("latency", "flight", "profile") + (
            ("prefix_cache",) if mode == "paged" else ()):
        assert set(ts[nested]) == set(js[nested]), nested
    assert ts["latency"]["ttft_count"] == len(_prompts())
    for key in ("tokens_generated", "admit_dispatches", "graph_compiles",
                "graph_compiles_post_warmup", "topo_tp", "topo_fsdp",
                "topo_n_chips", "spec_proposed", "spec_accepted",
                "spec_acceptance_rate", "spec_enabled", "device_kind",
                "hbm_used_gb_per_chip", "hbm_limit_gb_per_chip",
                "hbm_predicted_gb_per_chip",
                "decode_bytes_per_token_per_chip",
                "decode_flops_per_token_per_chip", "coldstart_warmup_s",
                "scaleout_ready_frac", "engine_dead"):
        assert ts[key] == js[key], key
    assert ts["windows_processed"] > 0
    assert ts["last_dispatch_age_s"] >= 0.0
    assert ts["flight"]["records"] == len(teng.flight_records())


SPEC_PROMPTS = [[7, 8, 9] * 5, [4, 5, 6, 7] * 4]


@pytest.mark.parametrize("mode", ["paged", "dense"])
def test_spec_stats_keys_equal_the_jax_engine(tiny, mode):
    """A spec-on engine's ``stats()`` carries the JAX spec-on engine's key
    set, and its spec counters equal the reference's on the same
    streams."""
    jeng, teng = _pair(tiny, dict(MODES[mode], spec_len=8))
    for e in (jeng, teng):
        e.warmup()
    jout = asyncio.run(_serve(jeng, SPEC_PROMPTS, 24, sequential=True))
    tout = asyncio.run(_serve(teng, SPEC_PROMPTS, 24, sequential=True))
    assert tout == jout
    js, ts = jeng.stats(), teng.stats()
    assert set(ts) == set(js)
    for nested in ("latency", "flight", "profile"):
        assert set(ts[nested]) == set(js[nested]), nested
    assert ts["spec_enabled"] is True
    assert ts["spec_windows"] > 0
    for key in ("spec_windows", "spec_proposed", "spec_accepted",
                "spec_acceptance_rate", "spec_enabled", "decode_steps",
                "graph_compiles", "graph_compiles_post_warmup"):
        assert ts[key] == js[key], key


@pytest.mark.parametrize("mode", ["paged", "dense"])
def test_verify_flight_records_carry_the_spec_fields(tiny, mode):
    """A verify window's flight record has the reference's keys, the four
    ``spec_*`` fields among them, and the same values."""
    jeng, teng = _pair(tiny, dict(MODES[mode], spec_len=8))
    for e in (jeng, teng):
        asyncio.run(_serve(e, SPEC_PROMPTS, 24, sequential=True))
    jrec = [r for r in jeng.flight_records() if r["kind"] == "verify"]
    trec = [r for r in teng.flight_records() if r["kind"] == "verify"]
    assert trec and len(trec) == len(jrec)
    assert all(set(t) == set(j) for t, j in zip(trec, jrec))
    spec_keys = ("spec_proposed", "spec_accepted", "spec_rollback",
                 "spec_len", "k", "pick", "tokens")
    for t, j in zip(trec, jrec):
        assert {k: t[k] for k in spec_keys} == {k: j[k] for k in spec_keys}
        assert t["spec_rollback"] == t["spec_proposed"] - t["spec_accepted"]
        assert t["spec_len"] == 8 and t["k"] == 9 and t["pick"] == "spec"
    # past each admission's first token, every token came from a decode
    # window or a verify window
    delivered = sum(n for r in teng.flight_records()
                    if r["kind"] in ("decode", "verify")
                    for n in r["tokens"].values())
    assert delivered == teng.stats()["tokens_generated"]


def test_cancel_request_frees_a_streaming_slot_and_its_blocks(tiny):
    """A cancelled request in the wait room is dropped at once; a cancelled
    live stream retires its slot at the next window's host processing,
    well before its budget, and its blocks and reservation return."""
    _, _, tcfg, tparams = tiny
    ecfg = EngineConfig(**dict(PAGED, kv_pool_blocks=9))
    teng = InferenceEngine(tparams, tcfg, ecfg, device="cpu")
    teng.warmup()

    async def run():
        await teng.start()
        try:
            live = await teng.generate([1, 2, 3], max_new_tokens=100,
                                       stream=True)
            assert await live.queue.get() is not None   # it is producing
            # the second request's worst case does not fit the pool beside
            # the first's: it waits for room
            waiting = await teng.generate([4, 5, 6], max_new_tokens=100,
                                          stream=True)
            for _ in range(1000):
                if waiting in teng._wait_room:
                    break
                await asyncio.sleep(0)
            assert waiting in teng._wait_room
            assert teng.active_stream_requests() == [live]
            teng.cancel_request(waiting)
            assert waiting.done.is_set() and waiting not in teng._wait_room
            teng.cancel_request(live)
            assert teng.active_stream_requests() == []
            await asyncio.wait_for(live.done.wait(), 30)
            stats = teng.stats()
            after = await asyncio.wait_for(
                teng.generate([7, 8, 9], max_new_tokens=4), 30)
            return live, waiting, stats, after
        finally:
            await teng.stop()

    live, waiting, stats, after = asyncio.run(run())
    assert len(live.generated) < 100 and not live.error
    assert waiting.generated == [] and not waiting.error
    assert stats["active_streams"] == 0 and stats["queued"] == 0
    assert stats["kv_blocks_reserved"] == 0
    held = stats["prefix_cache"]["held_blocks"]
    assert stats["kv_blocks_used"] == held + 1            # + the trash block
    assert len(after) == 4


@pytest.mark.parametrize("mode", list(MODES))
def test_flight_records_carry_the_reference_keys(tiny, mode):
    jeng, teng = _pair(tiny, MODES[mode])
    for e in (jeng, teng):
        e.warmup()
        asyncio.run(_serve(e, _prompts()))
    jrec, trec = jeng.flight_records(), teng.flight_records()
    for kind in ("admit", "decode"):
        jk = [set(r) for r in jrec if r["kind"] == kind]
        tk = [set(r) for r in trec if r["kind"] == kind]
        assert tk and jk and tk[0] == jk[0] and all(k == tk[0] for k in tk)
    def admits(recs):
        return [(r["slot"], r["prompt_tokens"], r["cached_tokens"],
                 r["chunks"]) for r in recs if r["kind"] == "admit"]

    assert admits(trec) == admits(jrec)
    # the first tokens come from the admissions, the rest from windows
    delivered = sum(n for r in trec if r["kind"] == "decode"
                    for n in r["tokens"].values())
    assert delivered == teng.stats()["tokens_generated"] > 0
    seqs = [r["seq"] for r in trec]
    assert seqs == sorted(seqs)
    assert teng.flight_records(limit=2) == trec[-2:]
    assert teng.flight_records(since_seq=seqs[-3]) == trec[-2:]
    assert teng.flight_records(since_seq=seqs[-1]) == []


def test_arm_profile_writes_a_trace(tiny, tmp_path):
    _, teng = _pair(tiny, PAGED)
    teng.warmup()
    with pytest.raises(ValueError):
        teng.arm_profile(windows=0)

    async def run():
        armed = teng.arm_profile(windows=2, out_dir=str(tmp_path))
        again = teng.arm_profile(windows=5)
        await teng.start()
        try:
            out = await teng.generate(_prompts()[1], max_new_tokens=12)
        finally:
            await teng.stop()
        return armed, again, out

    armed, again, out = asyncio.run(run())
    assert armed == {"path": str(tmp_path), "windows": 2}
    assert again["already_armed"] and again["path"] == str(tmp_path)
    assert len(out) == 12
    traces = glob.glob(str(tmp_path / "*.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        assert json.load(f)["traceEvents"]
    prof = teng.stats()["profile"]
    assert prof == {"armed": 0, "active": False, "path": str(tmp_path),
                    "error": ""}
    events = [r["event"] for r in teng.flight_records()
              if r["kind"] == "profile"]
    assert events == ["armed", "stopped"]


def test_blackbox_after_a_forced_loop_failure(tiny):
    jeng, teng = _pair(tiny, PAGED)
    teng.warmup()

    def broken(k):
        raise RuntimeError("injected window fault")

    teng._launch_window = broken

    async def run():
        await teng.start()
        with pytest.raises(RuntimeError, match="engine failure"):
            await asyncio.wait_for(
                teng.generate(_prompts()[0], max_new_tokens=8), 30)
        with pytest.raises(RuntimeError, match="engine is dead"):
            await teng.generate([1, 2], max_new_tokens=2)
        await teng.stop()

    asyncio.run(run())
    pm = teng.last_postmortem
    assert pm["reason"] == "engine_crash"
    assert "injected window fault" in pm["exception"]
    want = jeng.blackbox("probe")
    assert set(pm) == set(want)
    for part in ("scheduler", "kv_pool", "hbm"):
        assert set(pm[part]) == set(want[part]), part
    assert pm["scheduler"]["active_slots"] == [0]
    assert [r["kind"] for r in pm["flight"]] == ["admit"]
    assert pm["spans"] == []
    assert pm["stats"]["engine_dead"] is True
    record = build_postmortem(container_id="c0", **pm)
    assert record["reason"] == "engine_crash"
    json.dumps(record)


def test_kvtier_digest_and_deltas_match_the_jax_engine(tiny):
    """The same scripted traffic (inserts past a 4-block prefix budget,
    so entries are evicted, and a repeat that refreshes one) leaves the
    same digest and the same eviction journal in both engines."""
    ecfg = dict(PAGED, prefix_cache_blocks=4, max_batch=1)
    jeng, teng = _pair(tiny, ecfg)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(1, 500, n).tolist() for n in (40, 35, 50, 20)]
    script = prompts[:2] + [prompts[0]] + prompts[2:]
    for e in (jeng, teng):
        e.warmup()
        asyncio.run(_serve(e, script, max_new=2, sequential=True))
    assert teng.kvtier_digest() == jeng.kvtier_digest() != ""
    assert teng.kvtier_digest(top_k=1) == jeng.kvtier_digest(top_k=1)
    deltas, cursor = teng.kvtier_deltas(0)
    assert (deltas, cursor) == jeng.kvtier_deltas(0)
    assert deltas and all(kind == "evict" for kind, _ in deltas)
    assert teng.kvtier_deltas(cursor) == jeng.kvtier_deltas(cursor) == \
        ([], cursor)
    assert teng.kvtier_deltas(1) == jeng.kvtier_deltas(1)
    assert teng.drain_kv_spills() == jeng.drain_kv_spills() == []
    assert teng.drain_kvtier_decisions() == \
        jeng.drain_kvtier_decisions() == []
    jd, td = _pair(tiny, DENSE)
    assert td.kvtier_digest() == jd.kvtier_digest() == ""
    assert td.kvtier_deltas(0) == jd.kvtier_deltas(0) == ([], 0)


@pytest.mark.parametrize("cap", [3, 256])
def test_flight_recorder_copy_matches_the_reference(cap, monkeypatch):
    monkeypatch.setattr("time.time", lambda: 1234.5)
    ours, ref = FlightRecorder(cap), JaxFlightRecorder(cap)
    for i in range(7):
        kind = "admit" if i % 3 == 0 else "decode"
        assert ours.record(kind, k=i, slots={0: f"r{i}"}) == \
            ref.record(kind, k=i, slots={0: f"r{i}"})
    for limit, since in ((256, 0), (2, 0), (256, 5), (1, 6), (4, 7)):
        assert ours.snapshot(limit, since) == ref.snapshot(limit, since)
    assert ours.summary() == ref.summary()


@pytest.mark.parametrize("n", [1, 50, 3000])
def test_latency_summary_copy_matches_the_reference(n):
    values = np.random.default_rng(n).exponential(0.01, n).tolist()
    ours, ref = _Summary(), JaxSummary()
    for v in values:
        ours.observe(v)
        ref.observe(v)
    assert ours.snapshot() == ref.snapshot()


# -- the torch engine behind the real runner (LocalStack) ----------------------

E2E = dict(max_batch=2, max_seq_len=2048, prefill_buckets=(16, 64),
           decode_steps=(1, 4), kv_block_size=16, prefill_chunk=16,
           prefix_cache_blocks=16, admit_group_chunks=2)

TORCH_LLM_APP = f"""
import dataclasses


def load_engine():
    # the JAX reference's llama-tiny weights at f32, converted for the port;
    # the runner serves the torch engine it gets back as it is
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch
    from tpu9.models import init_decoder
    from tpu9.models.llama import LLAMA_PRESETS as JAX_PRESETS
    from tpu9_torch.bridge import params_from_jax
    from tpu9_torch.models.llama import LLAMA_PRESETS
    from tpu9_torch.serving.engine import EngineConfig, InferenceEngine

    torch.set_num_threads(1)
    jcfg = dataclasses.replace(JAX_PRESETS["llama-tiny"], dtype=jnp.float32,
                               max_seq_len=2048)
    tcfg = dataclasses.replace(LLAMA_PRESETS["llama-tiny"],
                               dtype=torch.float32, max_seq_len=2048)
    params = init_decoder(jax.random.PRNGKey(0), jcfg)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                             "cpu")
    return InferenceEngine(params, tcfg, EngineConfig(**{E2E!r}),
                           device="cpu")
"""
# the same torch engine with speculative decoding on
TORCH_SPEC_APP = TORCH_LLM_APP.replace("EngineConfig(**",
                                       "EngineConfig(spec_len=8, **")


async def _jax_greedy(prompts_and_budgets):
    jcfg = dataclasses.replace(JAX_PRESETS["llama-tiny"], dtype=jnp.float32,
                               max_seq_len=2048)
    jeng = JaxEngine(jax_init_decoder(jax.random.PRNGKey(0), jcfg), jcfg,
                     JaxEngineConfig(**E2E))
    await jeng.start()
    try:
        return [await jeng.generate(p, max_new_tokens=n)
                for p, n in prompts_and_budgets]
    finally:
        await jeng.stop()


async def _sse_tokens(stack, name, body, stop_after=None):
    """POST an SSE generate through the gateway; returns the token events
    and the final event. ``stop_after`` closes the connection after that
    many token events (a client that goes away mid-stream)."""
    import aiohttp
    toks, final = [], None
    async with aiohttp.ClientSession() as sess:
        async with sess.post(
                stack.base_url + f"/endpoint/{name}",
                json=dict(body, stream=True),
                headers={"Accept": "text/event-stream",
                         "Authorization":
                         f"Bearer {stack.gateway.default_token}"},
                timeout=aiohttp.ClientTimeout(total=120)) as resp:
            assert resp.status == 200, await resp.text()
            buf = b""
            async for chunk in resp.content.iter_any():
                buf += chunk
                while b"\n\n" in buf:
                    frame, buf = buf.split(b"\n\n", 1)
                    if not frame.startswith(b"data: "):
                        continue
                    ev = json.loads(frame[6:])
                    if "token" in ev:
                        toks.append(ev["token"])
                    else:
                        final = ev
                if stop_after is not None and len(toks) >= stop_after:
                    resp.close()
                    return toks, None
    return toks, final


async def _pressure(router, cid, pred, timeout_s=40.0):
    seen = None
    for _ in range(int(timeout_s / 0.25)):
        seen = await router.pressure(cid)
        if seen is not None and pred(seen):
            return seen
        await asyncio.sleep(0.25)
    raise AssertionError(f"pressure never satisfied the check: {seen}")


@pytest.mark.e2e
async def test_torch_engine_serves_behind_the_runner():
    from tpu9.abstractions.llm import LlmRouter
    from tpu9.testing.localstack import LocalStack

    assert "TPU9_KV_TIER" not in os.environ       # tiering stays armed
    short, long_ = [5, 3, 9], list(range(11, 40))          # 29: a full block
    want_short, want_long = await _jax_greedy([(short, 8), (long_, 24)])
    async with LocalStack() as stack:
        dep = await stack.deploy_endpoint(
            "llm-torch", {"app.py": TORCH_SPEC_APP}, "app:load_engine",
            config_extra={"timeout_s": 240.0, "extra": {"runner": "llm"},
                          "keep_warm_seconds": 120.0,
                          "runtime": {"cpu_millicores": 1000,
                                      "memory_mb": 3072},
                          "autoscaler": {"max_containers": 1}})
        status, out = await stack.api(
            "POST", "/endpoint/llm-torch",
            json_body={"tokens": short, "max_new_tokens": 8}, timeout=240)
        assert status == 200, out
        assert out["tokens"] == want_short
        toks, final = await _sse_tokens(stack, "llm-torch",
                                        {"tokens": long_,
                                         "max_new_tokens": 24})
        assert toks == final["tokens"] == want_long

        states = await stack.running_containers(dep["stub_id"])
        assert len(states) == 1
        cid = states[0].container_id
        router = LlmRouter(stack.store)
        # the heartbeat reached the router table, tiering hooks and all:
        # the prefix cache holds the long prompt's block, so the digest
        # rides the beat
        seen = await _pressure(router, cid, lambda p: "kvtier_keys" in p)
        for key in ("token_pressure", "graph_compiles_post_warmup",
                    "hbm_limit_gb_per_chip", "windows_processed",
                    "tokens_per_sec", "health", "kv_blocks_free",
                    "ttft_p50_s", "flight_records"):
            assert key in seen, key
        assert int(float(seen["graph_compiles_post_warmup"])) == 0
        assert seen["health"] == "ok"
        assert seen["device_kind"] == "cpu"

        # a client that goes away mid-stream frees the slot well before
        # its budget of 2000 tokens
        budget = 2000
        got, _ = await _sse_tokens(stack, "llm-torch",
                                   {"tokens": [2, 4, 6, 8, 10, 12, 14],
                                    "max_new_tokens": budget},
                                   stop_after=2)
        assert len(got) >= 2
        before = 8 + 24
        seen = await _pressure(
            router, cid, lambda p: int(float(p["active_streams"])) == 0
            and int(float(p["tokens_generated"])) > before)
        assert int(float(seen["tokens_generated"])) < before + budget // 2

        status, fl = await stack.api(
            "GET", f"/api/v1/flight?stub_id={dep['stub_id']}&limit=64")
        assert status == 200, fl
        kinds = {r["kind"] for r in fl["flight"]}
        assert {"admit", "decode"} <= kinds
        seqs = [r["seq"] for r in fl["flight"]]
        assert seqs == sorted(seqs)

        status, prof = await stack.api(
            "POST", "/api/v1/profile",
            json_body={"stub_id": dep["stub_id"], "windows": 2})
        assert status == 200, prof
        assert prof["windows"] == 2 and prof["path"]


JAX_LLM_APP = f"""
import dataclasses


def load_engine():
    # the reference engine over the same llama-tiny weights at f32
    import jax
    import jax.numpy as jnp
    from tpu9.models import init_decoder
    from tpu9.models.llama import LLAMA_PRESETS
    from tpu9.serving.engine import EngineConfig, InferenceEngine

    cfg = dataclasses.replace(LLAMA_PRESETS["llama-tiny"], dtype=jnp.float32,
                              max_seq_len=2048)
    return InferenceEngine(init_decoder(jax.random.PRNGKey(0), cfg), cfg,
                           EngineConfig(**{E2E!r}))
"""


@pytest.mark.e2e
async def test_torch_replica_adopts_a_prefix_the_jax_replica_published(
        tmp_path):
    """A JAX replica serves a prompt with ``export_after_prefill`` and
    publishes its prefix KV to the shared cache directory; the torch
    replica then serves the same prompt with ``adopt_kv`` naming that
    payload: HTTP 200, a counted import hit on its heartbeat, and the JAX
    replica's tokens."""
    from tpu9.abstractions.llm import LlmRouter
    from tpu9.testing.localstack import LocalStack

    prompt = [(i * 7) % 400 + 3 for i in range(40)]    # 2 full blocks
    common = {"timeout_s": 240.0, "extra": {"runner": "llm"},
              "keep_warm_seconds": 120.0,
              "runtime": {"cpu_millicores": 1000, "memory_mb": 3072},
              "autoscaler": {"max_containers": 1},
              "env": {"TPU9_KV_CACHE_DIR": str(tmp_path / "kv")}}
    async with LocalStack() as stack:
        await stack.deploy_endpoint("llm-jax", {"app.py": JAX_LLM_APP},
                                    "app:load_engine", config_extra=common)
        tdep = await stack.deploy_endpoint(
            "llm-torch-adopt", {"app.py": TORCH_LLM_APP}, "app:load_engine",
            config_extra=common)
        # both replicas come up together; the torch one serves a warm-up
        (status, pub), (wstatus, warm) = await asyncio.gather(
            stack.api("POST", "/endpoint/llm-jax",
                      json_body={"tokens": prompt, "max_new_tokens": 8,
                                 "export_after_prefill": True},
                      timeout=240),
            stack.api("POST", "/endpoint/llm-torch-adopt",
                      json_body={"tokens": [5, 3, 9], "max_new_tokens": 2},
                      timeout=240))
        assert status == 200 and wstatus == 200, (pub, warm)
        assert pub["kv_key"] and pub["n_tokens"] == 32, pub
        status, out = await stack.api(
            "POST", "/endpoint/llm-torch-adopt",
            json_body={"tokens": prompt, "max_new_tokens": 8,
                       "adopt_kv": {"key": pub["kv_key"],
                                    "n_tokens": pub["n_tokens"]}},
            timeout=120)
        assert status == 200, out
        assert out["tokens"] == pub["tokens"]

        states = await stack.running_containers(tdep["stub_id"])
        assert len(states) == 1
        seen = await _pressure(
            LlmRouter(stack.store), states[0].container_id,
            lambda p: int(float(p.get("kvwire_import_hits", 0))) >= 1)
        assert int(float(seen["kvwire_import_fallbacks"])) == 0
        assert int(float(seen["kvwire_blocks_imported"])) == 2
        assert int(float(seen["prefix_hits"])) >= 1


# a torch handler that restores its params through tpu9_torch.runner.ckpt:
# the first boot draws them (the reference's llama-tiny weights at f32,
# converted) and saves them as .tpu9w shards; a restored boot loads them.
# Each boot appends a line to CKPT_LOG, and init one more
TORCH_CKPT_APP = f"""
import dataclasses
import os


def load_engine():
    import torch
    from tpu9_torch.models.llama import LLAMA_PRESETS
    from tpu9_torch.runner import ckpt
    from tpu9_torch.serving.engine import EngineConfig, InferenceEngine

    log = open(os.environ["CKPT_LOG"], "a")

    def init():
        import jax
        import jax.numpy as jnp
        import numpy as np
        from tpu9.models import init_decoder
        from tpu9.models.llama import LLAMA_PRESETS as JAX_PRESETS
        from tpu9_torch.bridge import params_from_jax

        log.write("init\\n")
        jcfg = dataclasses.replace(JAX_PRESETS["llama-tiny"],
                                   dtype=jnp.float32, max_seq_len=2048)
        params = init_decoder(jax.random.PRNGKey(0), jcfg)
        return params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                               "cpu")

    torch.set_num_threads(1)
    log.write("boot restored=" + os.environ.get("TPU9_RESTORED", "0") + "\\n")
    params = ckpt.maybe_restore(init, device="cpu")
    log.close()
    tcfg = dataclasses.replace(LLAMA_PRESETS["llama-tiny"],
                               dtype=torch.float32, max_seq_len=2048)
    return InferenceEngine(params, tcfg, EngineConfig(**{E2E!r}),
                           device="cpu")
"""


# a torch handler that brings its engine up as the runner brings up a
# preset's: built on the preset's abstract tree, precompiled on a thread
# beside the weight draws, bound in place, spans in the runner's tracer
AHEAD = dict(max_batch=2, max_seq_len=512, prefill_buckets=(16, 64),
             decode_steps=(1, 4), kv_block_size=16)
TORCH_AHEAD_APP = f"""
def load_engine():
    import torch
    from tpu9.observability.trace import tracer
    from tpu9_torch.serving.presets import load_engine

    torch.set_num_threads(1)
    return load_engine("llama-tiny", device="cpu", compile_ahead=True,
                       tracer=tracer, **{AHEAD!r})
"""


@pytest.mark.e2e
async def test_torch_replica_brings_up_compile_ahead():
    """A torch replica built by ``load_engine(compile_ahead=True,
    tracer=<the runner's tracer>)`` serves the tokens of an engine built
    the classic way over the same seed, and its pressure heartbeat carries
    the compile-ahead decomposition (``coldstart_compile_ahead_s``,
    ``coldstart_bind_s``, ``coldstart_compile_overlap_s``), which
    ``/api/v1/coldstart`` folds into the replica's record."""
    from tpu9.abstractions.llm import LlmRouter
    from tpu9.testing.localstack import LocalStack
    from tpu9_torch.serving.presets import load_engine

    prompt = list(range(11, 40))
    classic = load_engine("llama-tiny", device="cpu", **AHEAD)
    await classic.start()
    try:
        want = await classic.generate(prompt, max_new_tokens=8)
    finally:
        await classic.stop()
    async with LocalStack() as stack:
        dep = await stack.deploy_endpoint(
            "llm-torch-ahead", {"app.py": TORCH_AHEAD_APP},
            "app:load_engine",
            config_extra={"timeout_s": 240.0, "extra": {"runner": "llm"},
                          "keep_warm_seconds": 120.0,
                          "runtime": {"cpu_millicores": 1000,
                                      "memory_mb": 3072},
                          "autoscaler": {"max_containers": 1}})
        status, out = await stack.api(
            "POST", "/endpoint/llm-torch-ahead",
            json_body={"tokens": prompt, "max_new_tokens": 8}, timeout=240)
        assert status == 200, out
        assert out["tokens"] == want
        states = await stack.running_containers(dep["stub_id"])
        assert len(states) == 1
        cid = states[0].container_id
        seen = await _pressure(LlmRouter(stack.store), cid,
                               lambda p: "coldstart_compile_ahead_s" in p)
        ahead = float(seen["coldstart_compile_ahead_s"])
        assert ahead > 0
        assert 0 <= float(seen["coldstart_compile_overlap_s"]) <= ahead
        assert float(seen["coldstart_bind_s"]) >= 0
        assert float(seen["coldstart_load_s"]) > 0
        assert int(float(seen["graph_compiles_post_warmup"])) == 0
        status, cold = await stack.api(
            "GET", f"/api/v1/coldstart?container_id={cid}")
        assert status == 200, cold
        runner = cold["replicas"][cid]["runner"]
        assert {"compile_ahead_s", "bind_s", "compile_overlap_s",
                "load_s", "warmup_s", "ready_s"} <= set(runner)


@pytest.mark.e2e
async def test_torch_replica_cold_starts_from_its_saved_shards(tmp_path):
    """The first container of a checkpointed ``runner="llm"`` deployment
    inits its torch params and saves them; after scale to zero the next
    container is restored (``TPU9_RESTORED=1``), loads the shards without
    calling init, and streams the same greedy tokens, which are the JAX
    engine's."""
    from tpu9.testing.localstack import LocalStack

    log = tmp_path / "boots.log"
    prompt = list(range(11, 40))
    (want,) = await _jax_greedy([(prompt, 16)])
    async with LocalStack() as stack:
        dep = await stack.deploy_endpoint(
            "llm-torch-ckpt", {"app.py": TORCH_CKPT_APP}, "app:load_engine",
            config_extra={"timeout_s": 240.0, "extra": {"runner": "llm"},
                          "keep_warm_seconds": 120.0,
                          "checkpoint": {"enabled": True},
                          "runtime": {"cpu_millicores": 1000,
                                      "memory_mb": 3072},
                          "autoscaler": {"max_containers": 1},
                          "env": {"CKPT_LOG": str(log)}})
        body = {"tokens": prompt, "max_new_tokens": 16}
        first, _ = await _sse_tokens(stack, "llm-torch-ckpt", body)
        assert first == want
        row = None
        for _ in range(300):
            row = await stack.backend.latest_checkpoint(dep["stub_id"])
            if row:
                break
            await asyncio.sleep(0.1)
        assert row, "checkpoint never became available"

        await stack.scale_to_zero(dep)
        second, _ = await _sse_tokens(stack, "llm-torch-ckpt", body)
        assert second == first
    assert log.read_text().splitlines() == ["boot restored=0", "init",
                                            "boot restored=1"]
