"""prefill_ms_per_ktok (no cell lists it yet; kept for an open-loop or
sessions cell): engine admission (the paged chunked prefill).
``stats()["latency"]["prefill"]`` seconds summed over the window (up to
the traced slice's end in a traced run), over the thousands of uncached
prompt tokens admitted in that time. Moves the cell's first-token
tail."""

from portbench import readers


def read(run):
    _, secs = readers.window_delta(run, "prefill")
    lo, hi = run.rec.stats_at.get("open"), run.rec.stats_at.get("close")
    if lo is None or hi is None:
        return None
    tokens = sum(n - cached for _, end, n, cached in run.rec.admissions
                 if lo <= end < hi)
    return secs / (tokens / 1e3) * 1e3 if tokens else None
