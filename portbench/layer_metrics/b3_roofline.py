"""b3_roofline (``.lora``, and any training cell's): kernel B3
(``ops/attention.py``: the flash forward ``flash_kernel``, run twice a
layer under remat, and its backward ``delta_kernel``, ``dkdv_kernel``,
``dq_kernel``, once). The least time of the traced steps' calls (each the
larger of its products at 989 TFLOP/s and its bytes at 3.35 TB/s,
``yardstick.flash_bound_s``) over the profiler's device time of those
kernels. The forward's launches must number 2 x layers x traced steps, or
nothing is read. Moves train_tokens_per_s."""

from portbench import yardstick


def read(run):
    sl = run.slice
    if run.kind != "train" or sl is None or not run.traced_steps:
        return None
    shape, b, t = run.shape, run.mix["batch"], run.mix["seq_len"]
    fwd_s, fwd_n = sl.kernel_s("flash_kernel")
    bwd_s, _ = sl.kernel_s("delta_kernel", "dkdv_kernel", "dq_kernel")
    if fwd_n != 2 * shape.n_layers * run.traced_steps or fwd_s <= 0:
        return None
    bound = run.traced_steps * shape.n_layers * (
        2 * yardstick.flash_bound_s(shape, b, t, backward=False)
        + yardstick.flash_bound_s(shape, b, t, backward=True))
    return 100.0 * bound / (fwd_s + bwd_s)
