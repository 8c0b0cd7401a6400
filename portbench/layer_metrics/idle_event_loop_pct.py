"""idle_event_loop_pct (``.batch``): the serve loop giving way to the
event loop (``serving/engine.py``, the awaits of ``serve.yield``, while the
clients' coroutines and ``generate`` run). 100 x the device's idle gaps
put down to ``serve.yield`` over the seconds between the two stats
snapshots. Moves output_tokens_per_s."""

from portbench import span_readers


def read(run):
    return span_readers.serve_share(run, ("serve.yield",))
