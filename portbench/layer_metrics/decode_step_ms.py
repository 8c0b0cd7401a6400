"""decode_step_ms (``.batch``, and any serving cell's): the decode
windows (``serving/graphs.py``). ``stats()["latency"]["decode_window"]``
seconds over ``stats()["decode_steps"]``, differenced over the window (up
to the traced slice's end in a traced run). Moves output_tokens_per_s."""

from portbench import readers


def read(run):
    if run.kind != "serve":
        return None
    return readers.decode_step_ms(run)
