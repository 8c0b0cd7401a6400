#!/usr/bin/env python3
"""Time the port's decode kernels (B1 ``paged_decode_attention``, B2
``paged_decode_attention_quant``, B4 ``ragged_decode_attention``) of the
``tpu9_torch`` package in ROOT, at ``chip_smoke.py`` phase 3's shapes and
with its timing method, so that two checkouts' kernels are timed the same
way, in turns, in one run on one card: llama3-8b's heads at D=128 and
gemma-7b's and gemma-2b's at D=256 (``chip_smoke.GEMMA_HEADS``).

    python3 scripts/decode_kernel_times.py [ROOT] [--candidates | --flash]

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
"""

from __future__ import annotations

import importlib.util
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
