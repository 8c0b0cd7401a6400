"""Cold-start span names and the interval helper: the port's own copy of
the part of ``tpu9/observability/coldstart.py`` that its bring-up reads.
The names are a wire contract: the gateway's ``/api/v1/coldstart`` and
``decompose_spans`` fold a torch replica's bring-up trace by them."""

from __future__ import annotations

from typing import Optional

SPAN_REQUEST = "restore.request"          # whole checkpoint restore
SPAN_FETCH = "restore.fetch"              # per-group chunk stream window
SPAN_DEVICE_PUT = "restore.device_put"    # per-group consume window
SPAN_LOAD = "restore.load"                # runner-side param load
SPAN_COMPILE_AHEAD = "restore.compile_ahead"   # captures beside the load
SPAN_BIND = "restore.bind"                # param binding into the engine
SPAN_WARMUP = "restore.warmup"            # pre-readiness graph warmup
SPAN_BRINGUP = "runner.bringup"           # runner-side bring-up root


def interval_overlap_s(a: Optional[tuple], b: Optional[tuple]) -> float:
    """Overlap of two (start, end) intervals in seconds (0 when either is
    missing or they are disjoint)."""
    if not a or not b or a[0] is None or b[0] is None:
        return 0.0
    lo = max(a[0], b[0])
    hi = min(a[1], b[1])
    return max(hi - lo, 0.0)
