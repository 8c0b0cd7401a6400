#!/usr/bin/env python3
"""Time the port's decode kernels (B1 ``paged_decode_attention``, B2
``paged_decode_attention_quant``, B4 ``ragged_decode_attention``) of the
``tpu9_torch`` package in ROOT, at ``chip_smoke.py`` phase 3's shapes and
with its timing method, so that two checkouts' kernels are timed the same
way, in turns, in one run on one card: llama3-8b's heads at D=128 and
gemma-7b's and gemma-2b's at D=256 (``chip_smoke.GEMMA_HEADS``).

    python3 scripts/decode_kernel_times.py [ROOT] [--candidates | --flash |
                                                   --backward]

ROOT (default: this checkout) holds the ``tpu9_torch`` whose kernels are
built and timed; the cases, checks and timing are this checkout's
``chip_smoke.py``. Prints the card, then one line per kernel and shape,
each checked against its twin first: the time as a host-bound step sees it
and on the device alone, and the wrapper's host time per call.

``--candidates`` (a split-KV ``tpu9_torch`` only) instead checks and times
on the device, at B=8, B=32 and B=1, each kernel under every split size of
``CANDIDATES``, with the package's ``SPLIT_TOKENS`` set to it for the run.

``--candidates`` takes llama3-8b's heads only.

``--flash`` instead checks and times ROOT's flash kernel (B3
``flash_attention``) at every shape of ``chip_smoke.FLASH_SHAPES`` (llama
and gemma), beside SDPA on the same inputs
(``chip_smoke.phase_flash_kernel``). Either way, a tree whose kernels take
no head_dim 256 (before gemma's instances) is timed at the shapes it
takes.

``--backward`` instead checks ROOT's flash backward kernel
(``flash_attention_backward``) at every shape of ``chip_smoke.GRAD_SHAPES``
(``chip_smoke.check_backward``: against its twin and through the Function
against autograd of the f32 twin), times it on the device alone beside
SDPA's backward alone on the same inputs, and gives the device time of each
of its three kernels (delta, dk/dv, dq) from ``torch.profiler``.
"""

from __future__ import annotations

import importlib.util
import re
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]
KERNELS = ("paged_decode_attention", "paged_decode_attention_quant",
           "ragged_decode_attention")
# positions a split: 1, 2 and 4 blocks of 128, and one split a sequence
CANDIDATES = (128, 256, 512, 1 << 20)


def times(cs, shapes) -> None:
    from tpu9_torch.ops import paged_attention as pa
    # model: (head_dim, (q heads, kv heads))
    models = {"llama3-8b": (128, cs.LLAMA_HEADS),
              **{m: (256, h) for m, h in cs.GEMMA_HEADS.items()}}
    for name in KERNELS:
        for model, (head_dim, heads) in models.items():
            if head_dim not in pa.HEAD_DIMS:      # an older tree's kernels
                continue
            for label, (batch, lens) in shapes.items():
                what = (f"{model} {label} QH={heads[0]} KH={heads[1]} "
                        f"D={head_dim}")
                c = cs.decode_kernel_case(name, batch, head_dim, lens, heads)
                cs.check_twin(name, what, c["kernel"](), c["want"])
                print(f"decode kernel {name} [{what}]: "
                      f"{cs.time_ms(c['kernel']):.4f} ms, device alone "
                      f"{cs.time_ms(c['kernel'], hold=True):.4f} ms, wrapper "
                      f"host {cs.host_us(c['kernel']):.1f} us a call")


def candidates(cs, shapes, card: str) -> None:
    from tpu9_torch.ops import paged_attention as pa
    kept = pa.SPLIT_TOKENS
    try:
        for name in KERNELS:
            # table columns and block size: phase 3's
            mb, block_s = ((8, 256) if name == "ragged_decode_attention"
                           else (17, 128))
            for label, (batch, lens) in shapes.items():
                c = cs.decode_kernel_case(name, batch, 128, lens)
                out = []
                for tokens in CANDIDATES:
                    pa.SPLIT_TOKENS = tokens
                    plan = pa.split_plan(mb, block_s)
                    cs.check_twin(name, f"{label} split plan {plan}",
                                  c["kernel"](), c["want"])
                    out.append(f"{plan[0]} splits x {plan[1]} blocks "
                               f"{cs.time_ms(c['kernel'], hold=True):.4f} ms")
                print(f"split candidates {name} [llama3-8b {label} QH=32 "
                      f"KH=8 D=128, device alone]: {'; '.join(out)} ({card})")
    finally:
        pa.SPLIT_TOKENS = kept


def backward(cs, card: str) -> None:
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile
    from tpu9_torch.ops import attention as at
    for batch, t, heads, head_dim, model in cs.GRAD_SHAPES.values():
        label = (f"{model} B={batch} T=S={t} QH={heads[0]} KH={heads[1]} "
                 f"D={head_dim} causal")
        gen = torch.Generator(device="cuda")
        gen.manual_seed(batch + t + head_dim)
        q, k, v = (torch.randn((batch, t, h, head_dim), generator=gen,
                               device="cuda").to(torch.bfloat16)
                   for h in (heads[0], heads[1], heads[1]))
        d_out = torch.randn(q.shape, generator=gen, device="cuda"
                            ).to(torch.bfloat16)
        cs.check_backward(label, q, k, v, d_out, True)
        out, lse = at.flash_attention(q, k, v, causal=True, with_lse=True)

        def kernel():
            return at.flash_attention_backward(q, k, v, out, lse, d_out, True)

        qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True)
                      for x in (q, k, v))
        sdpa_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                  enable_gqa=True)
        dot = d_out.transpose(1, 2).contiguous()
        kernel_ms = cs.time_ms(kernel, hold=True)
        sdpa_ms = cs.time_ms(lambda: torch.autograd.grad(
            sdpa_out, (qt, kt, vt), dot, retain_graph=True), hold=True)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                kernel()
            torch.cuda.synchronize()
        parts = []
        for evt in prof.key_averages():
            total = getattr(evt, "device_time_total", 0) or getattr(
                evt, "cuda_time_total", 0)
            if total and evt.count:
                found = re.search(r"\w+_kernel", evt.key)
                name = found.group(0) if found else evt.key[:40]
                parts.append(f"{name} {total / evt.count / 1e3:.4f} ms")
        print(f"backward kernel [{label}]: {kernel_ms:.4f} ms device alone, "
              f"sdpa backward {sdpa_ms:.4f} ms; {', '.join(parts)} ({card})")


def main() -> int:
    if not torch.cuda.is_available():
        print("decode_kernel_times: needs a CUDA device", file=sys.stderr)
        return 1
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    root = Path(args[0]).resolve() if args else HERE
    sys.path.insert(0, str(root))           # ROOT's tpu9_torch comes first
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import tpu9_torch
    from tpu9_torch.ops import _build
    card = cs.phase_card()
    print(f"kernels of {Path(tpu9_torch.__file__).parent} ({card})")
    if "--backward" in sys.argv[1:]:
        _build.build_all(["flash_attention", "flash_attention_backward"])
        backward(cs, card)
        return 0
    if "--flash" in sys.argv[1:]:
        from tpu9_torch.ops import attention as at
        _build.build_all(["flash_attention"])
        for shape in cs.FLASH_SHAPES:
            if shape[1] in at.FLASH_HEAD_DIMS:    # an older tree's instances
                cs.phase_flash_kernel(*shape)
        return 0
    _build.build_all(["paged_decode_attention"])
    shapes = {"B=8": (8, cs.PAGED_LENS), "B=1 len 2048": (1, [2048])}
    if "--candidates" in sys.argv[1:]:
        shapes["B=32"] = (32, cs.PAGED_LENS * 4)
        candidates(cs, shapes, card)
    else:
        times(cs, shapes)
    return 0


if __name__ == "__main__":
    sys.exit(main())
