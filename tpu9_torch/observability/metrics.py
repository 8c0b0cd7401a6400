"""Streaming latency summaries for one engine: the port's own copy of the
part of ``tpu9/observability/metrics.py`` that the engine's ``stats()``
reads (``_Summary`` and the ``summaries`` of ``Metrics.to_dict``)."""

from __future__ import annotations

import bisect
import threading


class _Summary:
    """Bounded reservoir giving p50/p95/max (enough for phase reports)."""

    def __init__(self, cap: int = 2048):
        self.cap = cap
        self.values: list[float] = []
        self.count = 0
        self.total = 0.0

    def observe(self, v: float) -> None:
        self.count += 1
        self.total += v
        if len(self.values) >= self.cap:
            # reservoir: replace a pseudo-random slot (deterministic walk)
            self.values[self.count % self.cap] = v
            self.values.sort()
        else:
            bisect.insort(self.values, v)

    def quantile(self, q: float) -> float:
        if not self.values:
            return 0.0
        idx = min(int(q * len(self.values)), len(self.values) - 1)
        return self.values[idx]

    def snapshot(self) -> dict:
        return {"count": self.count,
                "mean": self.total / self.count if self.count else 0.0,
                "p50": self.quantile(0.50), "p95": self.quantile(0.95),
                "max": self.values[-1] if self.values else 0.0}


class Metrics:
    """Named summaries, observed from the serve loop and read by
    ``stats()`` (which the runner may call from another thread)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.summaries: dict[str, _Summary] = {}

    def observe(self, name: str, value: float) -> None:
        with self._lock:
            if name not in self.summaries:
                self.summaries[name] = _Summary()
            self.summaries[name].observe(value)

    def to_dict(self) -> dict:
        with self._lock:
            return {"summaries": {k: s.snapshot()
                                  for k, s in self.summaries.items()}}
