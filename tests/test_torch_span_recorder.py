"""The span recorder (``tpu9_torch/observability/spans.py``) and its users:
the serve loop's phases and units, the train steps' spans, and the
benchmark's readers of them.

The attribution is host arithmetic, so it is driven here by a fake device
clock: ``FakeClock.event()`` stamps each event with the next device time a
test scripts (or, for a whole engine, with the host time of its record: a
device that runs each dispatch at once), and ``spans._now`` is a scripted
host clock where a test needs exact numbers. On the CPU an engine's units
record nothing: its host phases still tile the loop's wall time."""

import asyncio
import glob
import json
import time
from types import SimpleNamespace

import pytest
import torch

from portbench import run as prun
from tpu9_torch.models.llama import LLAMA_PRESETS
from tpu9_torch.observability import spans
from tpu9_torch.serving.presets import load_engine
from tpu9_torch.train import build_lora_train_step, build_train_step, optim
from tpu9_torch.train.trainer import init_train_state

torch.set_num_threads(2)

SERVE_PHASES = {"serve.admit", "serve.first_token", "serve.window_wait",
                "serve.fanout", "serve.dispatch", "serve.yield", "serve.park"}
TRAIN_PHASES = {"train.forward", "train.backward", "train.update"}


class FakeEvent:
    def __init__(self, t: int, clock):
        self.t, self.clock = t, clock

    def query(self) -> bool:
        return self.t <= self.clock.now

    def synchronize(self) -> None:
        self.clock.now = max(self.clock.now, self.t)

    def elapsed_time(self, other) -> float:
        return (other.t - self.t) / 1e6          # ms, as torch.cuda.Event


class FakeClock:
    """Events stamped with scripted device times (``times``), or with the
    host clock at their record (``times=None``)."""

    def __init__(self, times=None):
        self.times = list(times) if times is not None else None
        self.now = float("inf") if times is None else 0

    def event(self):
        t = self.times.pop(0) if self.times is not None else spans._now()
        return FakeEvent(t, self)


@pytest.fixture
def host(monkeypatch):
    """A scripted host clock: ``host.t`` is what the next read returns."""
    clock = SimpleNamespace(t=0)
    monkeypatch.setattr(spans, "_now", lambda: clock.t)
    return clock


# -- the attribution on a fake device clock ----------------------------------

@pytest.mark.parametrize("t0,t1,want", [
    (100, 200, {"b": 50e-9, "c": 50e-9}),          # split across two phases
    (300, 400, {spans.UNATTRIBUTED: 100e-9}),       # no phase covers it
    (0, 60, {"a": 30e-9, "b": 30e-9}),
    (140, 260, {"b": 10e-9, "c": 50e-9, spans.UNATTRIBUTED: 60e-9}),
], ids=["two-phases", "uncovered", "from-the-first", "partly-covered"])
def test_split_gap(t0, t1, want):
    ring = [(0, 30, "a"), (30, 150, "b"), (150, 200, "c")]
    got = spans.split_gap(ring, t0, t1)
    assert got.keys() == want.keys()
    for name, s in want.items():
        assert got[name] == pytest.approx(s)


def test_gaps_split_over_the_phases_that_left_the_card_waiting(host):
    clock = FakeClock([10, 100, 200, 300])
    rec = spans.SpanRecorder("test", clock=clock)
    rec.enter("a")
    host.t = 10
    u = rec.unit_start("u")
    host.t = 20
    rec.unit_end(u)
    host.t = 30
    rec.switch("b")
    host.t = 150
    rec.switch("c")
    host.t = 200
    u = rec.unit_start("u")         # the card idled 100..200 on the host
    host.t = 210
    rec.unit_end(u, row=(4, "steady"))
    clock.now = 300
    rec.resolve()
    assert rec.device_s == {"u": pytest.approx(190e-9)}
    assert rec.gap_s == {"b": pytest.approx(50e-9), "c": pytest.approx(50e-9)}
    (row,) = rec.rows
    assert (row.k, row.pick) == (4, "steady")
    assert row.span_s == pytest.approx(100e-9)
    assert row.gaps == rec.gap_s and row.units == rec.device_s
    # host seconds of the closed segments: "c" is still open
    assert row.host == {"a": pytest.approx(30e-9), "b": pytest.approx(120e-9)}


def test_a_gap_outside_every_phase_is_unattributed(host):
    clock = FakeClock([0, 100, 200, 250])
    rec = spans.SpanRecorder("test", clock=clock)
    rec.enter("a")
    rec.unit_end(rec.unit_start("u"))
    host.t = 120
    rec.exit()                      # the loop left every phase
    host.t = 200
    rec.unit_end(rec.unit_start("u"))
    clock.now = 250
    rec.resolve()
    assert rec.gap_s == {"a": pytest.approx(20e-9),
                         spans.UNATTRIBUTED: pytest.approx(80e-9)}


def test_a_gap_older_than_the_ring_is_unattributed(host):
    n = spans.RING + 6              # segments of 100 ns, six forgotten
    clock = FakeClock([0, 10, 100 * n, 100 * n + 10])
    rec = spans.SpanRecorder("test", clock=clock)
    rec.enter("a")
    rec.unit_end(rec.unit_start("u"))
    for i in range(n):
        host.t += 100
        rec.switch("b" if i % 2 else "a")
    rec.unit_end(rec.unit_start("u"))
    clock.now = 100 * n + 10
    rec.resolve()
    assert sum(rec.gap_s.values()) == pytest.approx((100 * n - 10) * 1e-9)
    # the ring's 64 segments cover the gap's last 6400 ns
    assert rec.gap_s[spans.UNATTRIBUTED] == pytest.approx(590e-9)


def test_resolution_never_waits_and_keeps_stream_order(host):
    clock = FakeClock([0, 50, 60, 90, 95, 120])
    rec = spans.SpanRecorder("test", clock=clock)
    for kind in ("window", "admit", "window"):
        rec.unit_end(rec.unit_start(kind), row=(1, kind))
    clock.now = 70                  # the device has passed the first unit
    rec.resolve()
    assert [r.pick for r in rec.rows] == ["window"]
    clock.now = 120
    rec.resolve()
    assert [r.pick for r in rec.rows] == ["window", "admit", "window"]
    assert rec.device_s == {"window": pytest.approx(75e-9),
                            "admit": pytest.approx(30e-9)}
    # every gap is floored at 0: units back to back leave none
    clock2 = FakeClock([0, 50, 40, 80])
    rec2 = spans.SpanRecorder("test", clock=clock2)
    rec2.unit_end(rec2.unit_start("u"))
    rec2.unit_end(rec2.unit_start("u"))
    clock2.now = 80
    rec2.resolve()
    assert rec2.gap_s == {}


def test_phases_nest_and_tile_the_wall_time(host):
    rec = spans.SpanRecorder("test")
    host.t = 5
    rec.enter("outer")
    host.t = 15
    assert rec.enter("inner") == 15
    host.t = 40
    rec.switch("other")
    host.t = 45
    rec.switch("other")             # a boundary inside one phase
    host.t = 70
    rec.exit()
    host.t = 100
    rec.close_phases()
    assert rec.totals()["host_s"] == {"outer": pytest.approx(40e-9),
                                      "inner": pytest.approx(25e-9),
                                      "other": pytest.approx(30e-9)}
    assert rec.clock is None and rec.unit_start("window") is None
    assert rec.unit_end(None) is None and not rec.rows
    assert spans.last("test") is rec


def test_phases_open_profiler_ranges_only_while_profiling():
    rec = spans.SpanRecorder("test")
    rec.enter("serve.quiet")
    assert rec._stack[-1][1] is None
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with rec.phase("serve.traced"):
            torch.zeros(4).add_(1)
        rec.switch("serve.switched")
        torch.zeros(4).add_(1)
    rec.close_phases()
    names = {e.name for e in prof.events()}
    assert {"serve.traced", "serve.switched"} <= names
    assert "serve.quiet" not in names


# -- the serve loop ----------------------------------------------------------

def _serve(engine, n=4, max_new=9):
    """Serve ``n`` requests; returns their tokens and the serve loop's wall
    seconds, from its first line to its end (``stop`` cancels it)."""
    inner, wall = engine._serve_loop_inner, []

    async def timed_loop():
        t0 = time.monotonic_ns()
        try:
            await inner()
        finally:
            wall.append((time.monotonic_ns() - t0) / 1e9)

    engine._serve_loop_inner = timed_loop

    async def go():
        await engine.start()
        try:
            outs = await asyncio.gather(*[
                engine.generate(list(range(1, 12 + 5 * i)),
                                max_new_tokens=max_new) for i in range(n)])
            await asyncio.sleep(0.02)       # the loop parks
        finally:
            await engine.stop()
        return outs
    return asyncio.run(go()), wall[0]


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_serve_phases_tile_the_loop_wall_time(paged):
    eng = load_engine("llama-tiny", device="cpu", max_seq_len=512,
                      max_batch=2, paged=paged)
    eng.warmup()
    outs, wall = _serve(eng)
    assert [len(o) for o in outs] == [9] * 4
    tot = eng.span_totals()
    assert set(tot["host_s"]) <= SERVE_PHASES
    assert {"serve.admit", "serve.dispatch", "serve.fanout",
            "serve.window_wait", "serve.park"} <= set(tot["host_s"])
    assert sum(tot["host_s"].values()) == pytest.approx(wall, rel=0.02)
    # the CPU has no events: no device figures, one row a window
    assert tot["device_s"] == {} and tot["gap_s"] == {}
    assert tot["rows"] == eng.stats()["windows_processed"]
    assert all(r.span_s is None and r.units == {} for r in eng.spans.rows)
    assert spans.last("serve") is eng.spans


def test_engine_units_partition_the_device_timeline_on_a_fake_clock():
    """A device that runs each dispatch as it is recorded: the windows'
    and admissions' spans and the gaps between them sum to the timeline
    from the first unit's start to the last one's end, and every gap lies
    inside some phase of the loop."""
    eng = load_engine("llama-tiny", device="cpu", max_seq_len=512,
                      max_batch=2)
    eng.warmup()
    eng.spans.clock = FakeClock()
    starts, ends = [], []
    event = eng.spans.clock.event

    def stamped():
        ev = event()
        (ends if len(starts) > len(ends) else starts).append(ev.t)
        return ev

    eng.spans.clock.event = stamped
    _serve(eng)
    eng.spans.resolve()
    tot = eng.span_totals()
    assert set(tot["device_s"]) == {"window", "admit"}
    assert set(tot["gap_s"]) <= SERVE_PHASES
    timeline = (ends[-1] - starts[0]) / 1e9
    assert sum(tot["device_s"].values()) + sum(tot["gap_s"].values()) == \
        pytest.approx(timeline, rel=1e-6)
    rows = list(eng.spans.rows)
    assert len(rows) == eng.stats()["windows_processed"]
    assert sum(r.k for r in rows) == eng.stats()["decode_steps"]
    assert sum(sum(r.units.values()) + sum(r.gaps.values())
               for r in rows) == pytest.approx(timeline, rel=1e-6)


def test_arm_profile_trace_shows_the_serve_phases(tmp_path):
    eng = load_engine("llama-tiny", device="cpu", max_seq_len=512,
                      max_batch=2)
    eng.warmup()
    eng.arm_profile(windows=3, out_dir=str(tmp_path))
    _serve(eng, n=2)
    (trace,) = glob.glob(str(tmp_path / "*.json"))
    with open(trace) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"serve.dispatch", "serve.window_wait",
            "serve.fanout"} <= names


# -- the train steps ---------------------------------------------------------

def _train_cfg():
    import dataclasses
    return dataclasses.replace(LLAMA_PRESETS["llama-tiny"],
                               dtype=torch.float32)


@pytest.mark.parametrize("kind", ["lora", "full"])
def test_train_step_writes_one_row_a_step(kind):
    from tpu9_torch.models import lora as lora_lib
    from tpu9_torch.models.transformer import init_decoder
    cfg = _train_cfg()
    gen = torch.Generator().manual_seed(0)
    params = init_decoder(cfg, gen, device="cpu")
    opt = optim.adam(1e-2)
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen)
    if kind == "lora":
        step = build_lora_train_step(cfg, opt, device="cpu")
        adapters = lora_lib.init_lora(gen, params, rank=2,
                                      targets=("wq", "wv"))
        state = opt.init(adapters)
        for _ in range(3):
            adapters, state, out = step(adapters, state, params, tokens)
    else:
        step = build_train_step(cfg, opt, device="cpu")
        st = init_train_state(params, opt)
        for _ in range(3):
            st, out = step(st, tokens)
    assert spans.last("train") is step.spans
    rows = list(step.spans.rows)
    assert len(rows) == 3
    for row in rows:
        assert set(row.host) == TRAIN_PHASES
        assert all(s > 0 for s in row.host.values())
        assert (row.k, row.pick, row.span_s, row.units) == (1, kind, None, {})


# -- the benchmark's readers -------------------------------------------------

def _row(t, k, span, gaps, units):
    return spans.Row(int(t * 1e9), k, "steady", span, gaps, units, {})


SERVE_ROWS = [
    # before the open: not read
    _row(0.5, 8, 0.16, {"serve.admit": 5.0}, {"window": 0.16}),
    _row(1.5, 8, 0.16, {"serve.admit": 0.05, "serve.fanout": 0.01},
         {"window": 0.16, "admit": 0.2}),
    _row(2.5, 32, 0.64, {"serve.yield": 0.02, "serve.dispatch": 0.03,
                         "serve.first_token": 0.01}, {"window": 0.64}),
    _row(3.0, 1, None, {}, {}),                 # a row without a device
]
SERVE_WANT = {
    "decode_step_device_ms.batch": (0.16 + 0.64) / 40 * 1e3,
    "admission_stall_pct.batch": 100 * (0.05 + 0.01 + 0.2) / 2.0,
    "idle_window_host_pct.batch": 100 * (0.01 + 0.03) / 2.0,
    "idle_event_loop_pct.batch": 100 * 0.02 / 2.0,
}
TRAIN_WANT = {"lora_forward_ms.lora": 200.0, "lora_backward_ms.lora": 260.0,
              "lora_update_ms.lora": 30.0}


def _serve_run():
    return SimpleNamespace(kind="serve", rec=SimpleNamespace(
        stats_at={"open": 1.0, "close": 3.0}))


def _train_run():
    return SimpleNamespace(kind="train", window={"open": 1.0, "end": 9.0})


def _install(monkeypatch, kind, rows):
    rec = spans.SpanRecorder(kind)
    rec.rows.extend(rows)
    monkeypatch.setitem(spans._LAST, kind, rec)


@pytest.mark.parametrize("name", sorted(SERVE_WANT) + sorted(TRAIN_WANT))
def test_span_reader_reads_its_number(name, monkeypatch):
    _install(monkeypatch, "serve", SERVE_ROWS)
    train_rows = [_row(0.5, 1, 1.0, {}, {"train.forward": 9.0})] + [
        _row(2.0 + i, 1, 0.5, {}, {"train.forward": f, "train.backward": b,
                                   "train.update": u})
        for i, (f, b, u) in enumerate([(0.19, 0.25, 0.03), (0.2, 0.26, 0.03),
                                       (0.21, 0.3, 0.04)])]
    _install(monkeypatch, "train", train_rows)
    read = prun.reader("layer_metrics", name)
    if name in SERVE_WANT:
        assert read(_serve_run()) == pytest.approx(SERVE_WANT[name])
        assert read(_train_run()) is None
    else:
        assert read(_train_run()) == pytest.approx(TRAIN_WANT[name])
        assert read(_serve_run()) is None


@pytest.mark.parametrize("name", sorted(SERVE_WANT) + sorted(TRAIN_WANT))
def test_span_reader_reads_nothing_without_device_rows(name, monkeypatch):
    cpu_rows = [_row(2.0, 1, None, {}, {}), _row(2.5, 1, None, {}, {})]
    for kind in ("serve", "train"):
        _install(monkeypatch, kind, cpu_rows)
    read = prun.reader("layer_metrics", name)
    assert read(_serve_run()) is None and read(_train_run()) is None
    for kind in ("serve", "train"):
        monkeypatch.delitem(spans._LAST, kind)
    assert read(_serve_run()) is None and read(_train_run()) is None


def test_serve_reader_needs_both_snapshots():
    run = _serve_run()
    del run.rec.stats_at["close"]
    read = prun.reader("layer_metrics", "admission_stall_pct.batch")
    assert read(run) is None
