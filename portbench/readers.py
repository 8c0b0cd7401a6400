"""Arithmetic the metric readers share: the counted requests, stats
differences over the window, and the traced slice's work."""

from __future__ import annotations


def ttft_s(run) -> list:
    """Each counted request's seconds from when it was due to its first
    token; one that never had one counts the wait to the run's end."""
    end = run.window["end"]
    return [(r.times[0] if r.times else end) - r.due_s
            for r in run.window["counted"]]


def tpot_s(run) -> list:
    return [(r.times[-1] - r.times[0]) / (len(r.times) - 1)
            for r in run.window["counted"] if r.done and len(r.times) > 1]


def tokens_in_window(run) -> int:
    lo, hi = run.window["open"], run.window["close"]
    return sum(1 for r in run.window["all"] for t in r.times if lo <= t < hi)


def latency_sum(stats: dict, phase: str) -> tuple:
    lat = stats.get("latency", {})
    n = lat.get(f"{phase}_count", 0)
    return n, n * lat.get(f"{phase}_mean_s", 0.0)


def window_delta(run, phase: str) -> tuple:
    """(count, seconds) of a ``stats()["latency"]`` phase over the window."""
    s0, s1 = run.rec.stats.get("open"), run.rec.stats.get("close")
    if not s0 or not s1:
        return 0, 0.0
    n0, t0 = latency_sum(s0, phase)
    n1, t1 = latency_sum(s1, phase)
    return n1 - n0, t1 - t0


def decode_step_ms(run):
    s0, s1 = run.rec.stats.get("open"), run.rec.stats.get("close")
    if not s0 or not s1:
        return None
    steps = s1["decode_steps"] - s0["decode_steps"]
    _, secs = window_delta(run, "decode_window")
    return secs / steps * 1e3 if steps > 0 else None


def traced_work(run) -> tuple:
    """(decode windows, admissions) that began inside the traced slice."""
    t0, t1 = run.rec.traced["t0"], run.rec.traced["t1"]
    if t0 is None or t1 is None:
        return [], []
    wins = [w for w in run.rec.windows if t0 <= w[0] < t1]
    adms = [a for a in run.rec.admissions if t0 <= a[0] < t1]
    return wins, adms


def served_flops(run) -> int:
    """Model FLOPs of the traced slice, counted by the configuration's
    architecture module: each decode window's live lanes' steps and each
    admission's uncached prompt tokens with its first token's head row."""
    arch, m = run.arch, run.model
    wins, adms = traced_work(run)
    return (sum(arch.window_flops(m, k, lens) for _, k, lens in wins)
            + sum(arch.admission_flops(m, n, cached)
                  for _, _, n, cached in adms))


def idle_pct(run):
    sl = run.slice
    if sl is None or sl.window_s <= 0 or sl.busy_s <= 0:
        return None
    return 100.0 * (1.0 - sl.busy_s / sl.window_s)
