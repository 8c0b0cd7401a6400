#!/usr/bin/env python3
"""The span recorder's host cost per serve-loop window, timed alone.

    python3 scripts/span_cost.py [--windows N] [--reps R]

Replays, with no model work on the card, the calls that one steady decode
turn of the serve loop (``InferenceEngine._serve_turn``) makes on its
recorder (``tpu9_torch/observability/spans.py``): eight phase boundaries,
a window unit (two timing events, the end one the event the loop waits
on), the wait on the older window and the resolution of its unit, which
finds the card idle before it and splits that gap over the phases. The
same turn without the recorder records and waits on one plain event. The
difference over N windows, in turns (plain, recorded, recorded, plain) R
times, is the recorder's cost a window; it is timed with no profiler
running and under ``torch.profiler`` (CPU and CUDA, as ``arm_profile``
records), where each phase also opens a ``record_function`` range.

The pieces are timed alone too: a phase boundary, a unit's event
(created and recorded), its query and an elapsed time between two.

It then checks, under a CUDA-only profiler (the benchmark's traced
slice), whether a phase's range shows among the device's events, and
prints the card's name and power limit. Without a CUDA device it runs on
the CPU (no events: the phases alone).
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from tpu9_torch.observability.spans import SpanRecorder  # noqa: E402


def recorded_turns(sp: SpanRecorder, n: int) -> None:
    pending = []
    for _ in range(n):
        sp.switch("serve.dispatch")
        sp.switch("serve.admit")
        sp.switch("serve.dispatch")
        unit = sp.unit_start("window")
        pending.append(sp.unit_end(unit, row=(32, "steady")))
        if len(pending) > 1:
            ready = pending.pop(0)
            sp.enter("serve.window_wait")
            if ready is not None:
                ready.synchronize()
            sp.switch("serve.fanout")
            sp.resolve()
            sp.switch("serve.fanout")
            sp.exit()
        sp.switch("serve.yield")


def plain_turns(n: int, cuda: bool) -> None:
    pending = []
    for _ in range(n):
        if cuda:
            ev = torch.cuda.Event()
            ev.record()
            pending.append(ev)
            if len(pending) > 1:
                pending.pop(0).synchronize()


def timed(fn) -> float:
    t0 = time.perf_counter()
    fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return time.perf_counter() - t0


def cost_us(n: int, reps: int, device: str) -> tuple:
    """(recorder µs a window, plain turn µs a window), medians."""
    cuda = device == "cuda"
    plain, rec = [], []
    for _ in range(reps):
        for order in ("plain", "rec", "rec", "plain"):
            if order == "plain":
                plain.append(timed(lambda: plain_turns(n, cuda)) / n)
            else:
                sp = SpanRecorder("cost", device)
                sp.enter("serve.dispatch")
                rec.append(timed(lambda: recorded_turns(sp, n)) / n)
                sp.close_phases()
    p, r = statistics.median(plain), statistics.median(rec)
    return (r - p) * 1e6, p * 1e6


def piece_us(device: str, n: int) -> dict:
    """Host us of each piece of the recorder, each a median of 5 runs of
    ``n`` calls."""
    sp = SpanRecorder("pieces", device)
    sp.enter("a")

    def per_call(fn) -> float:
        runs = []
        for _ in range(5):
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            runs.append((time.perf_counter() - t0) / n * 1e6)
        return statistics.median(runs)

    out = {"boundary": per_call(lambda: sp.switch("a"))}
    if sp.clock is not None:
        a, b = sp.clock.event(), sp.clock.event()
        torch.cuda.synchronize()
        out["event"] = per_call(sp.clock.event)
        torch.cuda.synchronize()
        out["query"] = per_call(b.query)
        out["elapsed"] = per_call(lambda: a.elapsed_time(b))
        out["current_stream"] = per_call(
            lambda: torch.cuda.current_stream(sp.clock.device))
    sp.close_phases()
    return {k: round(v, 3) for k, v in out.items()}


def ranges_on_device(device: str) -> list:
    """Names of the device events a CUDA-only profiler records over one
    phase around two kernels with a host pause between them."""
    from torch.profiler import ProfilerActivity, profile
    sp = SpanRecorder("probe", device)
    x = torch.ones(1 << 20, device=device)
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    sp.enter("serve.probe")
    x.add_(1)
    time.sleep(0.01)
    x.add_(1)
    sp.exit()
    torch.cuda.synchronize()
    prof.stop()
    return sorted({ev.name() for ev in prof.profiler.kineto_results.events()
                   if str(ev.device_type()).endswith("CUDA")})


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--windows", type=int, default=20000)
    p.add_argument("--reps", type=int, default=3)
    args = p.parse_args(argv)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    if device == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
        torch.ones(1, device=device).add_(1)
    else:
        card = "no CUDA device: phases alone"
    print(f"span_cost: {card}; torch {torch.__version__}")
    added, plain = cost_us(args.windows, args.reps, device)
    print(f"span_cost: profiler off: recorder {added:.2f} us a window "
          f"(the plain turn {plain:.2f} us)")
    print(f"span_cost: pieces, us a call: "
          f"{piece_us(device, args.windows // 10)}")
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device == "cuda" else [])
    n_prof = max(1, args.windows // 10)
    with profile(activities=acts):
        added_on, plain_on = cost_us(n_prof, 1, device)
    print(f"span_cost: profiler on (CPU and CUDA, {n_prof} windows): "
          f"recorder {added_on:.2f} us a window (the plain turn "
          f"{plain_on:.2f} us)")
    if device == "cuda":
        names = ranges_on_device(device)
        print(f"span_cost: device events under a CUDA-only profiler over "
              f"one phase: {names}; the phase among them: "
              f"{any(n.startswith('serve.') for n in names)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
