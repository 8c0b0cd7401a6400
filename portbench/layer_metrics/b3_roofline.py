"""b3_roofline (``.lora``, and any training cell's): kernel B3
(``ops/attention.py``: the flash forward ``flash_kernel``, run twice a
layer under remat, and its backward ``delta_kernel``, ``dkdv_kernel``,
``dq_kernel``, once). The least time of the traced steps' calls (each the
larger of its products at 989 TFLOP/s and its bytes at 3.35 TB/s; the
architecture module's ``train_attention_bound_s``) over the profiler's
device time of those kernels. The forward's launches must number what the
module's ``train_attention_calls`` gives for the traced steps (2 x layers
a step), or nothing is read. Moves train_tokens_per_s."""


def read(run):
    sl = run.slice
    if run.kind != "train" or sl is None or not run.traced_steps:
        return None
    arch, m, steps = run.arch, run.model, run.traced_steps
    fwd_s, fwd_n = sl.kernel_s("flash_kernel")
    bwd_s, _ = sl.kernel_s("delta_kernel", "dkdv_kernel", "dq_kernel")
    if fwd_n != arch.train_attention_calls(m, steps) or fwd_s <= 0:
        return None
    bound = arch.train_attention_bound_s(m, run.mix["batch"],
                                         run.mix["seq_len"], steps)
    return 100.0 * bound / (fwd_s + bwd_s)
