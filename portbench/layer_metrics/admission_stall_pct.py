"""admission_stall_pct (``.batch``): engine admission
(``serving/engine.py`` ``_admit_paged``). 100 x (the device spans of the
program's ``admit`` units: gathers, chunk groups, chunks and splices, the
first token's sample and copy; + the device's idle gaps put down to the
``serve.admit`` and ``serve.first_token`` phases) over the seconds between
the two stats snapshots: the share of the card's time not spent decoding
because of admission. Moves output_tokens_per_s."""

from portbench import span_readers


def read(run):
    return span_readers.serve_share(
        run, ("serve.admit", "serve.first_token"), ("admit",))
