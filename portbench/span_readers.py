"""Arithmetic the span readers share: the rows that the program's own span
recorder (``tpu9_torch/observability/spans.py``) resolved inside a run's
window. The serve loop leaves one row a decode or verify window, a train
step one row a step; each row holds the device spans of its units and the
device's idle gaps by the host phase they are put down to, since the row
before. A row without a device span (the CPU) is not read, and a program
without the recorder gives no rows: its readers read nothing."""

from __future__ import annotations

import statistics


def rows_in(kind: str, lo: float, hi: float) -> list:
    """The rows of the newest ``kind`` recorder (``"serve"``, ``"train"``)
    resolved between the monotonic seconds ``lo`` and ``hi``."""
    try:
        from tpu9_torch.observability import spans
    except ImportError:
        return []
    rec = spans.last(kind)
    if rec is None:
        return []
    lo_ns, hi_ns = int(lo * 1e9), int(hi * 1e9)
    return [r for r in list(rec.rows)
            if lo_ns <= r.t_mono <= hi_ns and r.span_s is not None]


def serve_rows(run) -> tuple:
    """(rows, seconds) between the run's two stats snapshots."""
    at = run.rec.stats_at if run.kind == "serve" else {}
    if "open" not in at or "close" not in at:
        return [], 0.0
    return (rows_in("serve", at["open"], at["close"]),
            at["close"] - at["open"])


def serve_share(run, gaps: tuple, units: tuple = ()):
    """100 x (the gaps put down to the phases ``gaps`` + the spans of the
    units ``units``) over the seconds between the snapshots."""
    rows, secs = serve_rows(run)
    if not rows or secs <= 0:
        return None
    total = sum(r.gaps.get(p, 0.0) for r in rows for p in gaps) \
        + sum(r.units.get(u, 0.0) for r in rows for u in units)
    return 100.0 * total / secs


def decode_step_device_ms(run):
    """The windows' device spans over their steps, in ms."""
    rows, _ = serve_rows(run)
    steps = sum(r.k for r in rows)
    return sum(r.span_s for r in rows) / steps * 1e3 if steps else None


def train_median_ms(run, unit: str):
    """The median device span of ``unit`` over the train steps resolved
    between the window's open and its end, in ms."""
    if run.kind != "train":
        return None
    spans = [r.units[unit] for r in rows_in("train", run.window["open"],
                                            run.window["end"])
             if unit in r.units]
    return statistics.median(spans) * 1e3 if spans else None
