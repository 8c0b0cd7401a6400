"""decode_step_device_ms (``.batch``): the decode windows
(``serving/graphs.py``) on the device's clock. The program's ``window``
units (two timing events around each replay and its copy to the host),
their device spans summed over the rows resolved between the two stats
snapshots, over those windows' steps: ``decode_step_ms`` without the
admissions between windows and the one-window overlap. Moves
output_tokens_per_s."""

from portbench import span_readers


def read(run):
    return span_readers.decode_step_device_ms(run)
