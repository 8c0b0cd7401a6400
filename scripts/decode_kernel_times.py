#!/usr/bin/env python3
"""Time the port's decode kernels (B1 ``paged_decode_attention``, B2
``paged_decode_attention_quant``, B4 ``ragged_decode_attention``) of the
``tpu9_torch`` package in ROOT, at ``chip_smoke.py`` phase 3's shapes and
with its timing method, so that two checkouts' kernels are timed the same
way, in turns, in one run on one card: llama3-8b's heads at D=128 and
gemma-7b's and gemma-2b's at D=256 (``chip_smoke.GEMMA_HEADS``).

    python3 scripts/decode_kernel_times.py [ROOT] [--candidates | --flash |
                                                   --backward | --split-alone |
                                                   --steps | --lora-step]

ROOT (default: this checkout) holds the ``tpu9_torch`` whose kernels are
built and timed; the cases, checks and timing are this checkout's
``chip_smoke.py``. Prints the card, then one line per kernel and shape,
each checked against its twin first: the time as a host-bound step sees it
and on the device alone, and the wrapper's host time per call.

``--candidates`` (this checkout's ``tpu9_torch``, whose plan counts a split
in positions) instead checks and times on the device, at B=8, B=32 and
B=1 and at every model's heads, each kernel under every split size of
``CANDIDATES`` (the package's ``split_plan`` replaced by one that gives it
for the run), and names the size the plan picks.

``--split-alone`` instead gives ROOT's split pass and combine kernel their
own device time (``torch.profiler``, L2 flushed before each call) for B1
and B2 at B=8 (the engine's lengths, and every length 2048) and at B=1
(one 2048-token sequence), beside the bytes bound: the split pass's share
of the bound at full load and at ragged lengths.

``--steps`` instead builds the llama3-8b bf16 and gemma-2b-int8 engines
from ROOT's package and profiles one replay of each one's captured 8-step
decode window (``chip_smoke.phase_profile``), then gives the decode
kernels' device ms per step from the per-kernel table.

A/B of two trees, in turns on one card (PERF.md §6):

    git archive <parent> tpu9_torch | tar -x -C .chipwork/parent
    for root in .chipwork/parent . . .chipwork/parent; do
        python3 scripts/decode_kernel_times.py $root; done

``--flash`` instead checks and times ROOT's flash kernel (B3
``flash_attention``) at every shape of ``chip_smoke.FLASH_SHAPES`` (llama
and gemma), beside SDPA on the same inputs
(``chip_smoke.phase_flash_kernel``), then its forward with the row
log-sum-exp alone at every shape of ``chip_smoke.GRAD_SHAPES`` (the train
steps' forward), beside SDPA's forward alone
(``chip_smoke.phase_flash_forward``). Either way, a tree whose kernels take
no head_dim 256 (before gemma's instances) is timed at the shapes it
takes.

``--backward`` instead checks ROOT's flash backward kernel
(``flash_attention_backward``) at every shape of ``chip_smoke.GRAD_SHAPES``
(``chip_smoke.check_backward``: against its twin and through the Function
against autograd of the f32 twin), times it on the device alone beside
SDPA's backward alone on the same inputs, and gives the device time of each
of its kernels from ``torch.profiler`` (``delta_kernel``, ``dkdv_kernel``,
``dq_kernel``) and their sum. The names come from each kernel's symbol, so
a tree with other kernels is split by its own.

``--lora-step`` instead runs ``chip_smoke.phase_train_lora`` (phase 12:
the gemma-7b LoRA step at (8, 512), its checks, its step time and one
profiled step) with ROOT's package, so that parent / change / change /
parent in one call gives the step's move with the backward kernel.
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
# positions a split: a tile, half a 256-position block, a block
CANDIDATES = (64, 128, 256)


def models(cs) -> dict:
    """model: (head_dim, (q heads, kv heads))"""
    return {"llama3-8b": (128, cs.LLAMA_HEADS),
            **{m: (256, h) for m, h in cs.GEMMA_HEADS.items()}}


def times(cs, shapes) -> None:
    from tpu9_torch.ops import paged_attention as pa
    for name in KERNELS:
        for model, (head_dim, heads) in models(cs).items():
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
    kept = pa.split_plan
    try:
        for name in KERNELS:
            # table columns and block size: phase 3's
            mb, block_s = ((8, 256) if name == "ragged_decode_attention"
                           else (17, 128))
            for model, (head_dim, heads) in models(cs).items():
                for label, (batch, lens) in shapes.items():
                    c = cs.decode_kernel_case(name, batch, head_dim, lens,
                                              heads)
                    out = []
                    for tokens in CANDIDATES:
                        pa.split_plan = (lambda *shape, t=tokens:
                                         (-(-mb * block_s // t), t))
                        cs.check_twin(name, f"{label} splits of {tokens}",
                                      c["kernel"](), c["want"])
                        out.append(f"{tokens} positions "
                                   f"{cs.time_ms(c['kernel'], hold=True):.4f}"
                                   f" ms")
                    pick = kept(batch, heads[1], mb, block_s,
                                name.endswith("_quant"))[1]
                    print(f"split candidates {name} [{model} {label} "
                          f"QH={heads[0]} KH={heads[1]} D={head_dim}, device "
                          f"alone]: {'; '.join(out)}; the plan picks {pick} "
                          f"({card})")
    finally:
        pa.split_plan = kept


def device_ms(prof) -> dict[str, float]:
    """Device ms per call of each kernel a ``torch.profiler`` run saw,
    by its ``*_kernel`` name."""
    out = {}
    for evt in prof.key_averages():
        total = getattr(evt, "device_time_total", 0) or getattr(
            evt, "cuda_time_total", 0)
        if total and evt.count:
            found = re.search(r"\w+_kernel", evt.key)
            out[found.group(0) if found else evt.key[:40]] = (
                total / evt.count / 1e3)
    return out


def split_alone(cs, card: str) -> None:
    from torch.profiler import ProfilerActivity, profile
    flush = torch.empty(cs.L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    lensets = {"B=8 engine lengths": cs.PAGED_LENS,
               "B=8 every length 2048": [2048] * 8, "B=1 len 2048": [2048]}
    for name in KERNELS[:2]:
        for model, (head_dim, heads) in models(cs).items():
            for label, lens in lensets.items():
                c = cs.decode_kernel_case(name, len(lens), head_dim, lens,
                                          heads)
                c["kernel"]()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(10):
                        flush.zero_()
                        c["kernel"]()
                    torch.cuda.synchronize()
                ms = device_ms(prof)
                split = ms.get("split_decode_kernel", float("nan"))
                bound = c["bound"][0]
                print(f"split alone {name} [{model} {label}]: split "
                      f"pass {split:.4f} ms ({bound / split:.1%} of the "
                      f"bound {bound:.5f}), combine "
                      f"{ms.get('combine_kernel', float('nan')):.4f} ms "
                      f"({card})")


def steps(cs, card: str) -> None:
    import gc
    from tpu9_torch.serving.presets import load_engine
    for kind in ("bf16", "gemma-int8"):
        preset, knobs, _ = cs.ENGINES[kind]
        engine = load_engine(preset, device="cuda", max_batch=8,
                             max_seq_len=2048, compile_ahead=True, **knobs)
        cs.phase_profile(engine, card, kind)
        # the table sums the profiled window's 8 steps
        table = (cs.ROOT / "build" / "profile"
                 / f"profile_{kind}_decode_step_B8.txt").read_text()
        for line in table.splitlines():
            found = re.search(r"(split_decode_kernel|combine_kernel).*?"
                              r"([\d.]+)(ms|us)\s+\S+%\s+\S+\s+\S+\s+(\d+)$",
                              " ".join(line.split()))
            if found:
                total = float(found.group(2)) * (1 if found.group(3) == "ms"
                                                 else 1e-3)
                print(f"step {kind}: {found.group(1)} {total / 8:.3f} ms a "
                      f"decode step ({found.group(4)} calls in 8 steps) "
                      f"({card})")
        del engine
        gc.collect()
        torch.cuda.empty_cache()


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
        split = device_ms(prof)
        parts = [f"{name} {ms:.4f} ms" for name, ms in split.items()]
        print(f"backward kernel [{label}]: {kernel_ms:.4f} ms device alone, "
              f"sdpa backward {sdpa_ms:.4f} ms; {', '.join(parts)}; sum of "
              f"the split {sum(split.values()):.4f} ms ({card})")


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
    if "--lora-step" in sys.argv[1:]:
        _build.build_all(["flash_attention", "flash_attention_backward"])
        cs.phase_train_lora(card)
        return 0
    if "--flash" in sys.argv[1:]:
        from tpu9_torch.ops import attention as at
        _build.build_all(["flash_attention"])
        for shape in cs.FLASH_SHAPES:
            if shape[1] in at.FLASH_HEAD_DIMS:    # an older tree's instances
                cs.phase_flash_kernel(*shape)
        for path in cs.GRAD_SHAPES:
            label, q, k, v, _ = cs.grad_inputs(path)
            cs.phase_flash_forward(f"{label}, forward with lse alone", q, k,
                                   v)
        return 0
    if "--steps" in sys.argv[1:]:
        _build.build_all(["paged_decode_attention", "flash_attention"])
        steps(cs, card)
        return 0
    _build.build_all(["paged_decode_attention"])
    if "--split-alone" in sys.argv[1:]:
        split_alone(cs, card)
        return 0
    shapes = {"B=8": (8, cs.PAGED_LENS), "B=1 len 2048": (1, [2048])}
    if "--candidates" in sys.argv[1:]:
        shapes["B=32"] = (32, cs.PAGED_LENS * 4)
        candidates(cs, shapes, card)
    else:
        times(cs, shapes)
    return 0


if __name__ == "__main__":
    sys.exit(main())
