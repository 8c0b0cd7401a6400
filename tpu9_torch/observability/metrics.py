"""Streaming latency summaries for one engine: the port's own copy of the
part of ``tpu9/observability/metrics.py`` that the engine's ``stats()``
reads (``_Summary`` and the ``summaries`` of ``Metrics.to_dict``)."""

from __future__ import annotations

import random
import threading


class _Summary:
    """Count, mean and max of every value, and p50/p95 from a uniform
    sample of at most ``cap`` of them (Algorithm R, from a generator of
    fixed seed, so one stream of values gives one sample). Below ``cap``
    the sample is every value and the quantiles are exact; the sort is paid
    in ``snapshot``."""

    def __init__(self, cap: int = 2048):
        self.cap = cap
        self.values: list[float] = []
        self.count = 0
        self.total = 0.0
        self.max = 0.0
        self._rng = random.Random(0)

    def observe(self, v: float) -> None:
        self.count += 1
        self.total += v
        self.max = v if self.count == 1 else max(self.max, v)
        if len(self.values) < self.cap:
            self.values.append(v)
            return
        # the count-th value replaces a kept one with probability cap/count
        j = self._rng.randrange(self.count)
        if j < self.cap:
            self.values[j] = v

    def snapshot(self) -> dict:
        vals = sorted(self.values)

        def quantile(q: float) -> float:
            return vals[min(int(q * len(vals)), len(vals) - 1)] \
                if vals else 0.0

        return {"count": self.count,
                "mean": self.total / self.count if self.count else 0.0,
                "p50": quantile(0.50), "p95": quantile(0.95),
                "max": self.max}


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
