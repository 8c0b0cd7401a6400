"""setup_s: seconds from the start of the process to the end of the
warm-up: imports, the weights drawn on the card, the engine or train step
built, every kernel built and every shape of the cell warmed."""


def read(run):
    return run.setup_s
