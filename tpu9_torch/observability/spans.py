"""Spans of the port's own loops: host phases on the host's clock, device
units on the device's clock, and the device's idle gaps put down to the
host phase that left the card waiting.

A ``SpanRecorder`` belongs to one loop (an engine's serve loop, a built
train step) and keeps three things:

- **Host phases.** ``enter(name)``/``exit()`` (or ``phase(name)``) nest;
  ``switch(name)`` leaves the innermost phase for another at one clock read
  (or, given the phase it is in, splits it at that boundary). Each boundary
  reads ``time.monotonic_ns`` once, adds the closed segment to its phase's
  self time and appends ``(start, end, name)`` to a ring of recent segments,
  so the segments of a loop that is always in some phase tile its wall time.
  While ``torch.profiler`` (or the autograd profiler) runs, each phase also
  opens a ``record_function`` range of its name, so a trace shows the
  phases against the kernels; with no profiler running none is made.
- **Device units.** ``unit_start(kind)``/``unit_end(unit)`` bracket one
  dispatch with two timing events on the current stream of the recorder's
  device; the start's host enqueue time is kept. Without a CUDA device there
  are no events: a unit records nothing.
- **Resolution.** ``resolve()`` runs where the loop already waits on the
  device and never waits itself: for each unit the device has passed, in
  stream order, its span is ``elapsed(start, end)`` and the gap before it
  ``elapsed(previous end, start)``, floored at 0. A gap is the card waiting
  for the host, so on the host's clock it lies at about ``[enqueue - gap,
  enqueue]``: it is split over the phases there (the ring's and the one
  still open), and what no phase covers goes to ``unattributed``. A unit
  that closes a row (an engine's decode or verify window, a train step's
  update) appends one ``Row``: the gaps, unit spans and host seconds by
  name since the last row.

The attribution (``split_gap``, rows) is host arithmetic over timestamps: a
test drives it with a fake device clock (``clock=``: an object whose
``event()`` returns a recorded event with ``query()`` and
``elapsed_time(other)`` in ms, as ``torch.cuda.Event``).

The latest recorder of each kind stays reachable after its owner is gone
(``last("serve")``, ``last("train")``): a benchmark frees the engine or the
step before it reads the spans."""

from __future__ import annotations

import time
from collections import deque
from contextlib import contextmanager
from itertools import chain
from typing import NamedTuple, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

UNATTRIBUTED = "unattributed"

# recent phase segments that a gap is split over; resolved rows kept
RING = 64
ROWS = 65536

_now = time.monotonic_ns
_LAST: dict = {}


def last(kind: str) -> Optional["SpanRecorder"]:
    """The newest recorder built with ``kind`` in this process, or None."""
    return _LAST.get(kind)


class Row(NamedTuple):
    """One row a closing unit appends once the device has passed it."""
    t_mono: int          # time.monotonic_ns() at resolution
    k: int               # device steps of the closing unit (a window's k)
    pick: str            # why this unit (a window's pick reason)
    span_s: Optional[float]  # the closing unit's device span; None: no device
    gaps: dict           # gap seconds by phase since the last row
    units: dict          # unit spans (seconds) by kind since the last row
    host: dict           # host seconds by phase (closed segments) since
    #                      the last row


def split_gap(ring, t0: int, t1: int, current=None) -> dict:
    """Seconds of the host interval ``[t0, t1]`` (ns) that each phase of
    ``ring`` covers (``(start, end, name)`` segments in the order they
    closed; ``current``, ``(start, name)``, the phase still open), and the
    rest under ``UNATTRIBUTED``."""
    out: dict = {}
    covered = 0
    segments = reversed(ring)
    if current is not None:
        segments = chain([(current[0], max(t1, current[0]), current[1])],
                         segments)
    for s, e, name in segments:
        if e <= t0:
            break                   # every older segment ended earlier
        lo, hi = max(s, t0), min(e, t1)
        if hi > lo:
            out[name] = out.get(name, 0.0) + (hi - lo) / 1e9
            covered += hi - lo
    if t1 - t0 > covered:
        out[UNATTRIBUTED] = (t1 - t0 - covered) / 1e9
    return out


def _add(into: dict, parts: dict) -> None:
    for name, s in parts.items():
        into[name] = into.get(name, 0.0) + s


class CudaClock:
    """Timing events on the current stream of one CUDA device."""

    def __init__(self, device):
        self.device = torch.device(device)

    def event(self):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self.device))
        return ev


class _Unit:
    __slots__ = ("kind", "start", "t_enq", "end", "row", "host")


class SpanRecorder:
    """Host phases, device units and their rows for one loop (module
    docstring). ``device``: the loop's device (a multi-rank engine's rank
    0); units record events only on a CUDA device, or on ``clock``."""

    def __init__(self, kind: str, device=None, *, clock=None):
        if clock is None and device is not None \
                and torch.device(device).type == "cuda":
            clock = CudaClock(device)
        self.kind = kind
        self.clock = clock
        # one (wall, monotonic) pair: puts these spans on another clock
        self.anchor = (time.time_ns(), time.monotonic_ns())
        self.host_ns: dict = {}     # phase -> self time, ns
        self.device_s: dict = {}    # unit kind -> device seconds
        self.gap_s: dict = {}       # phase (or unattributed) -> gap seconds
        self.rows: deque = deque(maxlen=ROWS)
        self._ring: deque = deque(maxlen=RING)
        self._stack: list = []      # [name, record_function or None]
        self._t = 0                 # start of the open segment
        self._pending: deque = deque()
        self._last_end = None
        self._row_gaps: dict = {}
        self._row_units: dict = {}
        self._row_host: dict = {}   # host_ns when the last row closed
        _LAST[kind] = self

    # -- host phases ---------------------------------------------------------

    def _close(self, t: int) -> None:
        name = self._stack[-1][0]
        self.host_ns[name] = self.host_ns.get(name, 0) + (t - self._t)
        self._ring.append((self._t, t, name))
        self._t = t

    @staticmethod
    def _range(name: str):
        if not _autograd_profiler._is_profiler_enabled:
            return None
        rng = torch.profiler.record_function(name)
        rng.__enter__()
        return rng

    def enter(self, name: str) -> int:
        """Open phase ``name`` inside the current one; returns the
        boundary's ``monotonic_ns``."""
        t = _now()
        if self._stack:
            self._close(t)
        self._t = t
        self._stack.append([name, self._range(name)])
        return t

    def exit(self) -> int:
        """Close the innermost phase; the one around it resumes."""
        t = _now()
        if self._stack:
            self._close(t)
            _, rng = self._stack.pop()
            if rng is not None:
                rng.__exit__(None, None, None)
        return t

    def switch(self, name: str) -> int:
        """Leave the innermost phase for ``name`` at one clock read (in
        ``name`` already: split it here). Outside any phase it only reads
        the clock."""
        t = _now()
        if self._stack:
            self._close(t)
            top = self._stack[-1]
            if top[0] != name:
                if top[1] is not None:
                    top[1].__exit__(None, None, None)
                top[0], top[1] = name, self._range(name)
        return t

    @contextmanager
    def phase(self, name: str):
        self.enter(name)
        try:
            yield
        finally:
            self.exit()

    def close_phases(self) -> None:
        """Close every open phase (the loop ends)."""
        while self._stack:
            self.exit()

    # -- device units --------------------------------------------------------

    def unit_start(self, kind: str) -> Optional[_Unit]:
        """Record a unit's start event before its first dispatch; None
        without a device clock."""
        if self.clock is None:
            return None
        u = _Unit()
        u.kind = kind
        u.start = self.clock.event()
        u.t_enq = _now()
        return u

    def unit_end(self, u: Optional[_Unit], row: Optional[tuple] = None):
        """Record ``u``'s end event after its last dispatch and return it
        (None without a device clock). ``row``, ``(k, pick)``, makes the
        unit close a row, with the host seconds by phase up to here;
        without a device the row is appended at once."""
        host = self._host_since_row() if row is not None else None
        if u is None:
            if row is not None:
                self._append_row(row, None, host)
            return None
        u.end = self.clock.event()
        u.row, u.host = row, host
        self._pending.append(u)
        return u.end

    @contextmanager
    def span(self, name: str, row: Optional[tuple] = None):
        """A host phase and a device unit of one name around a block."""
        self.enter(name)
        u = self.unit_start(name)
        try:
            yield
        finally:
            self.exit()
            self.unit_end(u, row)

    # -- resolution ----------------------------------------------------------

    def resolve(self) -> None:
        """Account, in order, every unit whose end the device has passed;
        stops at the first it has not. Never waits on the device."""
        pending = self._pending
        while pending and pending[0].end.query():
            u = pending.popleft()
            span = u.start.elapsed_time(u.end) / 1e3
            if self._last_end is not None:
                gap = self._last_end.elapsed_time(u.start) / 1e3
                if gap > 0:
                    parts = split_gap(self._ring, u.t_enq - int(gap * 1e9),
                                      u.t_enq, self._open())
                    _add(self.gap_s, parts)
                    _add(self._row_gaps, parts)
            self._last_end = u.end
            self.device_s[u.kind] = self.device_s.get(u.kind, 0.0) + span
            self._row_units[u.kind] = self._row_units.get(u.kind, 0.0) + span
            if u.row is not None:
                self._append_row(u.row, span, u.host)

    def _open(self) -> Optional[tuple]:
        return (self._t, self._stack[-1][0]) if self._stack else None

    def _host_since_row(self) -> dict:
        now, before = self.host_ns, self._row_host
        out = {name: (ns - before.get(name, 0)) / 1e9
               for name, ns in now.items() if ns != before.get(name, 0)}
        self._row_host = dict(now)
        return out

    def _append_row(self, row: tuple, span: Optional[float],
                    host: dict) -> None:
        k, pick = row
        self.rows.append(Row(_now(), k, pick, span, self._row_gaps,
                             self._row_units, host))
        self._row_gaps, self._row_units = {}, {}

    # -- reading -------------------------------------------------------------

    def totals(self) -> dict:
        """Seconds since the recorder was built: host self time by phase,
        device time by unit kind, device gaps by the phase they are put
        down to; the resolved row count and the clock anchor."""
        host = dict(self.host_ns)
        return {"host_s": {name: ns / 1e9 for name, ns in host.items()},
                "device_s": dict(self.device_s), "gap_s": dict(self.gap_s),
                "rows": len(self.rows), "anchor_ns": self.anchor}
