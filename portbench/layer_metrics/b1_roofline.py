"""b1_roofline (``.batch``, and any serving cell's): kernel B1
(``ops/paged_attention.py``, the split-KV paged decode:
``split_decode_kernel`` and ``combine_kernel``). The least time of the
traced windows' calls, their bytes at 3.35 TB/s (each attended k and v
vector read once, each query read and each output written once), over the
profiler's device time of those kernels. The calls and their least bytes
a step come from the configuration's architecture module (for the decoder,
one call a layer a step over every position). The count of split kernels
must equal the calls of the windows launched inside the slice, whose
kernels all run inside it (``serve._trace_edge``, ``trace.STOP_WAIT_S``),
or nothing is read. Moves output_tokens_per_s."""

from portbench import readers, yardstick


def read(run):
    sl = run.slice
    if run.kind != "serve" or sl is None:
        return None
    wins, _ = readers.traced_work(run)
    arch, m = run.arch, run.model
    calls = arch.decode_attention_calls(m, sum(k for _, k, _ in wins))
    secs, n_split = sl.kernel_s("split_decode_kernel")
    comb, _ = sl.kernel_s("combine_kernel")
    if not calls or n_split != calls or secs <= 0:
        return None
    nbytes = sum(arch.decode_attention_bytes(m, [n + j + 1 for n in lens])
                 for _, k, lens in wins for j in range(k))
    return 100.0 * nbytes / yardstick.HBM_BYTES_PER_S / (secs + comb)
