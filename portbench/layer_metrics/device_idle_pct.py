"""device_idle_pct (``.batch``, ``.lora``, and any cell's): the device.
100 x (1 - the union of the device's events over the traced slice / the
slice's seconds). Moves the cell's rate."""

from portbench import readers


def read(run):
    return readers.idle_pct(run)
