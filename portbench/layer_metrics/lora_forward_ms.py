"""lora_forward_ms (``.lora``): the model step (``train/trainer.py``).
The median device span of the program's ``train.forward`` unit (the merge
of ``models/lora.py``, the forward under remat and the loss; from its
first op to its last on the stream, the card's waits on the host inside it
included) over the steps resolved between the window's open and its end,
in ms. Moves train_tokens_per_s."""

from portbench import span_readers


def read(run):
    return span_readers.train_median_ms(run, "train.forward")
