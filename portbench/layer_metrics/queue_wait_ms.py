"""queue_wait_ms (no cell lists it yet; kept for an open-loop cell such
as ``.chat``): engine admission (``serving/engine.py``, ``schedule.py``).
The mean wait of a request in the engine's queue, from
``stats()["latency"]["queue_wait"]`` count x mean differenced over the
window (up to the traced slice's end in a traced run). Moves the cell's
first-token tail."""

from portbench import readers


def read(run):
    n, secs = readers.window_delta(run, "queue_wait")
    return secs / n * 1e3 if n > 0 else None
