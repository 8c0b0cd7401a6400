"""train_tokens_per_s: the tokens of every train step run in the window
(batch x sequence length each), over the seconds from the window's open
to the moment the device finished the last of them."""


def read(run):
    if run.kind != "train" or not run.steps:
        return None
    w = run.window
    tokens = run.steps * run.mix["batch"] * run.mix["seq_len"]
    return tokens / (w["end"] - w["open"])
