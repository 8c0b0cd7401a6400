"""The traffic that PERF.md's deferred cells call for is data: sessions
over shared system prompts, on/off bursts, repetitive text served with
speculative decoding, and the dense engine are each a mix file's keys.
Each runs here through the serving cell on the CPU at a tiny size, and
comes out correct."""

import argparse
import time

import pytest

from portbench import serve
from portbench.tests.test_portbench_faults import tiny_serving_conf

BASE = {"kind": "serve", "lead_in_s": 0.3, "drain_s": 30,
        "prompt": {"dist": "uniform", "min": 8, "max": 24},
        "output": {"dist": "uniform", "min": 4, "max": 10},
        "check_tokens": 16, "trace_s": 0.5}

MIXES = {
    "sessions": {**BASE, "loop": "closed", "clients": 3,
                 "pool_per_client": 8,
                 "shared_prefix": {"count": 2, "tokens": 40},
                 "turns": {"count": {"dist": "uniform", "min": 2, "max": 3},
                           "max_context": 120}},
    "burst": {**BASE, "loop": "open", "rate_per_s": 8.0,
              "burst": {"on_s": 0.5, "off_s": 0.5}},
    "open_sessions": {**BASE, "loop": "open", "rate_per_s": 3.0,
                      "think_s": 0.05,
                      "turns": {"count": {"dist": "uniform", "min": 2,
                                          "max": 2},
                                "max_context": 120}},
    "spec": {**BASE, "loop": "closed", "clients": 2, "pool_per_client": 16,
             "text": {"repeat": {"dist": "uniform", "min": 3, "max": 6}},
             "engine": {"spec_len": 2}},
    "dense": {**BASE, "loop": "closed", "clients": 2, "pool_per_client": 16,
              "engine": {"paged": False}},
}


def serve_mix(mix):
    args = argparse.Namespace(seed=2 ** 31 + 123, seconds=2.0, trace=0)
    return serve.run({"name": "tiny.mix", "chips": 1},
                     tiny_serving_conf("mistral-7b"), mix, args,
                     time.monotonic(), device="cpu")


@pytest.mark.parametrize("name", sorted(MIXES))
def test_mix_serves_correctly(name):
    run = serve_mix(MIXES[name])
    assert run.checks["correct"], run.checks["numbers"]
    assert run.attempted > 0 and run.failed == 0


def test_sessions_send_later_turns_through_the_prefix_cache():
    run = serve_mix(MIXES["sessions"])
    pool = 3 * 8
    later = [r for r in run.window["all"] if r.index >= pool]
    assert later and all(r.sent for r in later)
    # a later turn's prompt is its session's last prompt and served tokens
    by_prompt = {tuple(r.prompt + r.tokens): r for r in run.window["all"]}
    assert all(any(tuple(r.prompt[:n]) in by_prompt
                   for n in range(len(r.prompt))) for r in later)
    assert sum(cached for *_, cached in run.rec.admissions) > 0


@pytest.mark.parametrize("name,paged", [("spec", True), ("dense", False)])
def test_mix_engine_knobs_reach_the_engine(name, paged):
    run = serve_mix(MIXES[name])
    stats = run.rec.stats["close"]
    assert stats["spec_enabled"] == (name == "spec")
    assert ("kv_blocks_used" in stats) == paged
    if name == "spec":
        assert stats["spec_windows"] > 0
    # the configuration itself is left as it was
    assert "spec_len" not in tiny_serving_conf("mistral-7b")["engine"]
