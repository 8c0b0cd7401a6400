"""Engine flight recorder: a bounded ring of per-window serve-loop records
(the port's own copy of ``tpu9/serving/flight.py``).

Every host-processed decode window and every admission appends ONE plain
dict, built only from state the serve loop already holds on the host
(monotonic clocks, numpy masks, allocator counters): no device sync beyond
the window boundary's, and no per-token records.

Record schema (kind == "decode"):

    seq               monotonically increasing record id (per engine)
    ts                wall anchor at host processing (merge/display only)
    kind, k           window kind and device steps
    pick              why this K was picked ("admission" = shrunk for an
                      imminent admission, "interleave" = dispatched inside
                      a long admission, else "budget"/"max")
    batch             active slots at dispatch
    slots             {slot: request_id} snapshot at dispatch
    tokens            {slot: tokens delivered} (host fan-out outcome)
    wait_s            dispatch → host processing (device compute plus the
                      one-window overlap the loop deliberately holds)
    host_s            host fan-out time for this window's processing
    kv_used/kv_free/kv_reserved                     allocator at dispatch
    kv_alloc          blocks allocated since the previous record
    prefix_evictions  prefix-cache evictions since the previous record
    prefix_pinned     currently pinned prefix-cache entries

Admission records (kind == "admit"): request_id, slot, prompt_tokens,
cached_tokens (prefix-cache reuse), chunks, interleaved (decode windows
dispatched during the admission), dur_s.

Profile records (kind == "profile"): armed/stopped markers with the dump
path, so the flight timeline shows which windows a ``torch.profiler``
trace covers.
"""

from __future__ import annotations

import collections
import itertools
import time


class FlightRecorder:
    """Bounded ring of plain-dict records; query by tail or by seq."""

    def __init__(self, cap: int = 256):
        self.cap = cap
        self._ring: collections.deque[dict] = collections.deque(maxlen=cap)
        self._seq = itertools.count(1)
        self.recorded = 0           # lifetime count (dropped = recorded - len)

    def record(self, kind: str, **fields) -> dict:
        rec = {"seq": next(self._seq), "ts": round(time.time(), 6),
               "kind": kind, **fields}
        self._ring.append(rec)
        self.recorded += 1
        return rec

    def snapshot(self, limit: int = 256, since_seq: int = 0) -> list[dict]:
        """Newest-last tail of the ring: up to ``limit`` records with
        ``seq > since_seq`` (pass the last seen seq to poll incrementally
        without re-reading the whole ring)."""
        out = []
        for rec in reversed(self._ring):
            if rec["seq"] <= since_seq:
                break
            out.append(rec)
            if len(out) >= max(limit, 1):
                break
        out.reverse()
        return out

    def summary(self) -> dict:
        last = self._ring[-1] if self._ring else None
        return {"records": len(self._ring), "cap": self.cap,
                "recorded": self.recorded,
                "dropped": self.recorded - len(self._ring),
                "last_seq": last["seq"] if last else 0}

