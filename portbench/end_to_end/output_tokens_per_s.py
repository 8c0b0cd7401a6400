"""output_tokens_per_s: every output token the clients received inside the
window, over the window's seconds."""

from portbench import readers


def read(run):
    if run.kind != "serve":
        return None
    return readers.tokens_in_window(run) / run.seconds
