"""mfu (``.batch``, ``.lora``): the whole step's model FLOPs over the
traced slice's seconds at 989 TFLOP/s bf16. Serving: each decode window's
live lanes' steps and each admission's prompt tokens through the active
weights, their attention and the head rows; moves output_tokens_per_s.
Training: ``lora_step_flops`` of the traced steps (forward, the
activations' and the adapted weights' gradients; not the recompute);
moves train_tokens_per_s. Both counts come from the configuration's
architecture module."""

from portbench import readers, yardstick


def read(run):
    sl = run.slice
    if sl is None or sl.window_s <= 0:
        return None
    if run.kind == "train":
        if not run.traced_steps:
            return None
        flops = run.traced_steps * run.arch.lora_step_flops(
            run.model, run.mix["batch"], run.mix["seq_len"])
    else:
        flops = readers.served_flops(run)
    if not flops:
        return None
    return 100.0 * flops / (sl.window_s * yardstick.BF16_FLOP_PER_S)
