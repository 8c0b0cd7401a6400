"""idle_window_host_pct (``.batch``): the serve loop's host work around
each window (``serving/engine.py``). 100 x the device's idle gaps put down
to ``serve.fanout`` (token delivery, retirement, the window's hooks),
``serve.dispatch`` (scheduling, block growth, the launch) and
``serve.window_wait`` over the seconds between the two stats snapshots.
Moves output_tokens_per_s."""

from portbench import span_readers


def read(run):
    return span_readers.serve_share(
        run, ("serve.fanout", "serve.dispatch", "serve.window_wait"))
