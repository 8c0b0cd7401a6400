"""The traced slice of a ``--trace 1`` run: ``torch.profiler`` (CUPTI) over
a stretch of whole decode windows or train steps, read in memory. It
gives the device's busy seconds (the union of its events' intervals), the
device time of each kernel name, and the idle gaps named by the host
phase that was running at each gap's middle."""

from __future__ import annotations

import bisect
import time
from contextlib import contextmanager
from dataclasses import dataclass, field

STOP_WAIT_S = 1.0


@dataclass
class Slice:
    busy_s: float = 0.0
    window_s: float = 0.0
    kernels: dict = field(default_factory=dict)     # name -> (seconds, calls)
    gaps: dict = field(default_factory=dict)        # host op -> seconds

    def kernel_s(self, *substrings: str) -> tuple:
        """(seconds, calls) of the kernels whose name holds any of
        ``substrings``."""
        secs, calls = 0.0, 0
        for name, (s, n) in self.kernels.items():
            if any(sub in name for sub in substrings):
                secs += s
                calls += n
        return secs, calls

    def breakdown(self) -> dict:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][0])[:10]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[name, s] for name, (s, _) in ops],
                "idle_gaps": [[name, s] for name, s in gaps]}


class Profiler:
    """``torch.profiler`` over the device's activity alone, started and
    stopped around whole units of work; ``stop`` waits for the device
    first, so the slice holds every kernel of the units it saw begin. The
    host's side comes from ``phase`` spans the benchmark records around
    its calls into the program (``time.time_ns``, the clock the profiler's
    events are stamped with), so tracing adds no cost to the host's own
    operations. The events are read once the run's window has closed
    (``read``)."""

    def __init__(self):
        self.prof = None
        self.t0 = 0.0
        self.window_s = 0.0
        self.phases: list = []
        self.on = False

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        # a CPU-only build (the tests) traces the host, and reads no busy
        # time
        self.prof = profile(activities=[
            ProfilerActivity.CUDA if torch.cuda.is_available()
            else ProfilerActivity.CPU])
        self.prof.start()
        self.on = True
        self.t0 = time.perf_counter()

    def warm(self) -> None:
        """One start and stop before the window: the profiler's first
        start initialises CUPTI, which takes seconds."""
        import torch
        self.start()
        torch.zeros((1,), device="cuda" if torch.cuda.is_available()
                    else "cpu").add_(1)
        # nothing of it is read: no wait for its last events
        self.on = False
        self.prof.stop()
        self.prof = None

    def stop(self) -> None:
        import torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self.t0
        self.on = False
        if torch.cuda.is_available():
            # the profiler drops the device events it stamps too near its
            # stop: with no wait, or 2 ms, a slice lost the last kernels of
            # its last window (3 and 58 B1 calls) in 2 of 14 runs on the
            # H100. The wait lies outside ``window_s``, after the last
            # unit traced.
            time.sleep(STOP_WAIT_S)
        self.prof.stop()

    @contextmanager
    def phase(self, name: str):
        """A host span, kept while the slice is being traced."""
        if not self.on:
            yield
            return
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.phases.append((t0, time.time_ns(), name))

    def read(self) -> Slice:
        return read_events(self.prof.profiler.kineto_results.events(),
                           self.window_s, self.phases)


def _is_device(ev) -> bool:
    return str(ev.device_type()).endswith("CUDA")


def read_events(events, window_s: float, host: list) -> Slice:
    """Busy seconds, kernel seconds by name and idle gaps by host phase
    from the profiler's raw device events (nanosecond start and end) and
    the host spans ``(start_ns, end_ns, name)``."""
    dev = [(ev.start_ns(), ev.start_ns() + ev.duration_ns(), ev.name())
           for ev in events if _is_device(ev)]
    out = Slice(window_s=window_s)
    for start, end, name in dev:
        s, n = out.kernels.get(name, (0.0, 0))
        out.kernels[name] = (s + (end - start) / 1e9, n + 1)
    out.busy_s = union_ns(dev) / 1e9
    host = sorted(host)
    starts = [s for s, _, _ in host]
    for a, b in idle_ns(dev):
        mid = (a + b) // 2
        label, width = "(between the benchmark's calls)", None
        # the innermost host span that covers the gap's middle
        hi = bisect.bisect_right(starts, mid)
        for s, e, name in reversed(host[max(0, hi - 256):hi]):
            if e >= mid and (width is None or e - s < width):
                label, width = name, e - s
        out.gaps[label] = out.gaps.get(label, 0.0) + (b - a) / 1e9
    return out


def idle_ns(spans) -> list:
    """The gaps between the merged ``(start, end, ...)`` intervals."""
    gaps, reach = [], None
    for start, end, *_ in sorted(spans):
        if reach is not None and start > reach:
            gaps.append((reach, start))
        reach = end if reach is None else max(reach, end)
    return gaps


def union_ns(spans) -> int:
    """Length of the union of ``(start, end, ...)`` intervals."""
    total, reach = 0, None
    for start, end, *_ in sorted(spans):
        if reach is None or start >= reach:
            total += end - start
            reach = end
        elif end > reach:
            total += end - reach
            reach = end
    return total
