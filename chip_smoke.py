#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``tpu9_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Phases, each of which must pass or the script exits non-zero:

1. card: the GPU's name and power limit (``nvidia-smi``), torch and CUDA
   versions;
2. build: compiles every CUDA kernel of the main paths from
   ``tpu9_torch/csrc`` with ``nvcc`` (one process per source, all started
   together; one source holds the three decode kernels: bf16 pool, int8
   pool and contiguous cache, each a split-KV pass (GQA group 1, 2, 4, 8
   at D 64, 128, 256) and a combine pass (D 64, 128, 256); one the flash
   kernel's six instances, D 64, 128 and 256, causal or not; one its
   backward's, a dk/dv kernel and a dq kernel at the same six), prints
   each instance's registers and spills from ``ptxas -v`` and any
   ``ptxas`` note on serialised ``wgmma`` products, and fails if an
   instance a served model runs spills: (G=4, D=128) of the decode kernels
   and D=128 flash (llama3-8b), (G=1, D=256) of the bf16-pool and
   contiguous decode kernels and D=256 flash (gemma-7b), (G=8, D=256) of
   the int8-pool kernel (gemma-2b), or a causal instance of the backward's
   two kernels;
3. kernels: each kernel against its plain PyTorch twin at the shapes the
   main paths give it, at llama3-8b's heads (QH 32, KH 8, D 128) and at
   gemma-7b's (QH 16, KH 16, D 256) and gemma-2b's (QH 8, KH 1, D 256):
   the paged kernels with table entries past every prefix pointing at
   poisoned pool blocks (NaN for bf16; payload 127 with NaN scales for
   int8), the ragged kernel with NaN at every cache position past each
   length, the decode kernels at B=8 and at B=1 with one 2048-token
   sequence, the flash kernel over causal prefills of 128, 512 and 2048
   tokens, one non-causal shape, and B=2 sequences of 320 tokens (not a
   multiple of its 128-row tiles), causal and not, read from buffers
   whose sequence after the last is NaN; and the paged verify route
   (``paged_verify_attention`` on a CUDA tensor: a window's B*T queries as
   one-token rows through B1 or B2) at B=8, T=9 with the window ending at
   the decode lengths, bf16 and int8 pool, at the three models' heads,
   against the reference's gather + chunk attention; times the kernel,
   the twin and one library call with CUDA events, as a host-bound step
   sees them and on the device alone, and the kernel wrapper's host time
   per call, beside the bound;
4. engine, bf16: ``load_engine("llama3-8b", device="cuda",
   compile_ahead=True)`` at full width (random weights from a seed), the
   runner's bring-up: the engine is built on the preset's abstract param
   tree and precompiles (capturing each decode window size as a CUDA
   graph over zero-filled weights: the three must be captured) while the
   weights are drawn on a thread, then binds them in place; the four
   ``bringup`` keys with the overlap inside the compile window, one
   precompile timing for each key ``reachable_keys`` names, a KV state
   with no NaN or inf after the captures, params bit-equal to
   ``build_params``' draws from the same seed, and a ``warmup()`` that
   builds nothing; then six
   concurrent ``generate`` requests (two share a 512-token prefix), a
   repeated greedy prompt, and a check of the generated tokens against a
   plain no-cache forward; then no post-warmup graph build, the
   ``stats()`` fields of ``[surface.engine_stats]`` with live device
   memory, a non-empty flight recorder, a streaming request cancelled
   mid-decode that frees its slot, and ``arm_profile(windows=2)`` writing
   a trace; and an engine over the same weights that samples at
   temperature 0.8, whose replayed windows must draw anew;
5. engine, int8: the same with ``load_engine("llama3-8b-int8",
   kv_quant="int8")``: int8 weights and an int8 paged pool auto-sized to
   the bf16 pool's bytes;
6. engine, dense: the same with ``load_engine("llama3-8b", paged=False)``:
   a contiguous [L, B, S] cache, bucketed prefill through the flash kernel
   and decode through the ragged kernel (no prefix cache);
7. to 9. the same three engines for gemma (head_dim 256, tied embeddings,
   scaled embeddings): ``load_engine("gemma-7b")`` (paged bf16 pool),
   ``load_engine("gemma-2b-int8", kv_quant="int8")`` (int8 weights and
   pool, GQA group 8) and ``load_engine("gemma-7b", paged=False)``;
10. mixtral, the sparse-MoE decoder (8 experts, top-2, llama's attention
    shape): ``load_engine("mixtral-8x7b-int8", kv_quant="int8")`` at full
    depth (int8 weights, experts int8 per expert, the int8 pool and B2);
11. mixtral-8x7b in bf16 at 16 of its 32 layers, full width (the 32
    layers take 93.4 GB), built from the preset's config through the
    engine's constructor: the bf16 pool and B1.
    Both come up serially (a compile-ahead bring-up would hold two copies
    of their 47 GB of weights), so the bring-up's own checks are skipped;
    their greedy tokens are checked against a reference that makes the
    paged engine's MoE calls (the prompt in 128-token chunks at batch 1,
    then one-token decode steps): the experts' capacity follows each
    call's token count. The router's logits must not follow the process's
    f32 matmul precision. Their decode window and chunk group are
    profiled on every run, and no spec, KV-motion or restore phase
    follows them;
12. train, LoRA: gemma-7b at full width and depth (random weights from a
    seed), rank-16 adapters on wq, wk, wv and wo, ``examples/05``'s
    tokens (8, 512) and ``adamw``, remat on, through
    ``build_lora_train_step``: the first step's adapter gradients through
    the flash kernel against the twin path, then five steps on one
    repeated batch (the first step's loss against a no-grad forward over
    the merged params, every ``b`` off zero after it, the loss falling),
    step ms, training tokens/s, MFU against the bf16 peak with its FLOP
    count, peak memory and one profiled step;
13. train, full: llama-1b at full width and depth, every parameter, adam,
    tokens (4, 1024), through ``build_train_step``: five steps, the loss
    falling, the same figures;
14. train, LoRA on a mesh: ``examples/05``'s step on its mesh,
    ``make_mesh(dp=1, fsdp=2, sp=1, tp=4, devices=["cuda"] * 8)``, eight
    ranks on the one card: gemma-7b at full width and depth with the same
    draws as phase 12, the base by ``decoder_param_specs`` (tp rank shards
    of 4 heads, each weight's fsdp pieces gathered inside each layer's
    checkpoint) and the adapters by ``fsdp_specs(min_size=1)``: the first
    step's adapter gradients against phase 12's, each step's loss against
    phase 12's, the loss falling, the flash kernel launched ``n_layers x 4
    ranks x 2 x steps`` times and no other kernel; step ms, MFU, peak
    memory, one profiled step (busy, idle), and one pass's fsdp gathers
    and tp reductions timed alone;
15. train, full on a mesh: llama-1b as phase 13 on ``dp=2, fsdp=2,
    tp=2`` (one card), ``init_train_state(params, opt, mesh, specs)``:
    each loss and grad norm against phase 13's, the launches counted;
16. ring: ring attention on ``sp=8`` ranks, B=1, T=8192, H=4, D=128, f32,
    causal and full, against the dense f32 attention: the gap, both
    peak-memory deltas and both times;
17. pipeline: ``pipeline_forward`` over 4 stages, the reference test's
    MLP block at dim 2048 and 8 layers, M=4 and M=8: the output and the
    gradients against the sequential program's;
18. moe-train: ``moe_ffn`` at mixtral-8x7b's FFN widths (bf16) on
    ``ep=4`` ranks against ``ep=1``, 8 adam steps, the losses step by
    step.
    Phases 16-18 are plain torch ops (the reference's are XLA ops): no
    kernel launches there. Every rank of phases 14-18 is on the one card;
    nothing here runs on two cards.
19. vision: CLIP ViT-L/14 (``examples/03``'s image embedder) at full
    width and depth, random weights from a seed: the f32 forward against
    the port's f32 forward on the CPU (2 images), the bf16 forward against
    the f32 one (cosine), unit norms, row 0 of a B=64 call against the
    image alone; the forward captured as a CUDA graph at B=1, 8 and 64
    (the counterpart of the example's ``jax.jit``), each replay equal to
    the eager call bit for bit; ms and images/s eager and captured, the
    share of the roofline (``vision_flops``), the peak memory, the f32
    attention's device time and one profiled B=64 forward;
20. classifier: the text classifier (``examples/01``'s sentiment model)
    at its full config (f32, distilbert widths): B=4, T=128 logits of
    mixed lengths against the port's CPU forward, garbage past the mask, a
    fully masked row (zero logits), negative and out-of-range ids (the
    clamped rows, no device assert); sequences/s at B=1 and 32, eager and
    captured, and the peak memory.
    In phases 19 and 20 none of the four kernels launches (their attention
    is the reference's plain f32 product), and the f32 matmul precision
    must be "highest" (TF32 would part from the reference).
    Each phase prints its seconds.

Phase 3 also holds the flash kernel's gradient (``FlashAttention``: the
kernel forward, which saves each row's log-sum-exp, and the backward
kernel) at the four train phases' shapes (gemma-7b's heads at B=8,
T=S=512, and a tp=4 rank's 4 of them; llama-1b's at B=4, T=S=1024, and a
tp=2 rank's 16/4), at D=128 (llama3-8b's heads, B=2, T=S=512, causal and
not), at the tails T=S=320 (D 64, 128 and 256, over buffers whose
sequence after the last is NaN) and at S > T: the forward against the
twin, its lse against ``xla_attention_lse``, the backward kernel's dq, dk
and dv against its twin ``xla_attention_backward`` on the same out and lse
(``backward_limit``) and the Function's against autograd through the f32
twin on the same bf16 inputs (``grad_limit``); at the train shapes the
forward kernel, the backward kernel alone (beside its torch-ops twin and
SDPA's backward alone), the pair and SDPA's forward and backward timed.
In each train phase the flash kernel launches ``n_layers x 2 x steps``
times (each layer's forward and its recompute in the backward) and the
backward kernel ``n_layers x steps``, both times the tp ranks in phases
14-15, and no other kernel launches.

After phases 4 and 5, KV motion (``phase_kv_motion``), on an engine over
the same weights with a 1024 MB host tier armed through ``engine_cfg``: a
prompt with a 512-token prefix served on the device, exported to kvwire
bytes (header geometry and payload size checked), dropped and adopted,
served again, exported again, down-paged to host DRAM and served again
(an up-page), and a stream in flight exported, adopted and resumed: the
same greedy tokens, byte-identical re-exports, one host hit and one
up-page, no pool tensor moved and no graph built after warmup; then
export, adopt, down-page and up-page of the prefix timed beside a plain
pinned copy of the same bytes.

After phases 4, 5 and 6, speculative decoding (``phase_spec``): over the
phase's weights, an engine of its configuration with ``spec_len=8`` and
one without (both warmed; the spec engine's verify window must be a
captured CUDA graph) serve the phase's six prompts (the dense phase: two)
and two prompts of a repeated short segment, 64 new tokens each: verify
windows with drafts must run, no graph may be built after warmup, and each
spec-on stream must equal the spec-off stream up to its first fork, which
must be a tie; it prints the acceptance rate and decode tokens/s on
against off.

After phases 4 and 5, after the spec phase, weights and restore
(``phase_restore``): the phase's params saved as ``.tpu9w`` shards by
``tpu9_torch.runner.ckpt.save_params`` under ``build/`` (v1 for bf16, v2
with int8 pairs; the free disk space is checked first), restored onto the
card by the port's ``stream_shards`` and ``default_device_put`` (a ring of
pinned staging buffers and a copy stream) from a chunk stream of the shard
files, first from the page cache and then after each shard's pages are dropped
(with ``O_DIRECT`` reads where the filesystem takes them; labelled
"cold" only where the bytes then come from a local disk, "host" where
they come from a shared filesystem's host, whose cache is unseen, else
"page cache"), and loaded the runner's way (``ckpt.load_params``
to host tensors, then to the card): every restored leaf ``torch.equal`` to
the live one. It prints seconds and GB/s of each step beside a plain
pinned copy of the same bytes. Then two cold starts, each one wall from its
start to the first token over a restore after the pages are dropped, in
turns (bf16 serial first, int8 compile-ahead first): serial (restore,
engine, warmup, serve) and compile-ahead (an engine on ``params_spec``
precompiles beside the restore on a thread, then ``bind_params``, which
must keep every param's ``data_ptr``, a ``warmup`` that builds nothing,
serve), each serving the reference prompt alone, 16 greedy tokens equal
to those of an engine over the live weights, with no graph built after
warmup and its decode kernel's launches counted, and each printed with its
decomposition (restore, ``fetch_s`` and
``put_s`` with and without the captures beside them, ``compile_ahead_s``,
``compile_overlap_s``, ``bind_s``) and its peak memory; the directory is
deleted after.

After phases 4 and 5, tensor-parallel serving (``phase_tp``): the phase's
preset served by ``load_engine(..., topology="2x1", devices=["cuda",
"cuda"], compile_ahead=True)``, two tp ranks on the one card (each rank
its own weight shards, its own head shard of the pool, its own launches
of the decode kernel at per-rank heads, QH 16, KH 4 for llama3-8b), over
the same weights (seed 0), drawn part by part and bound into the rank
shards as they are drawn: the rank shards' shapes (``wq`` and ``lm_head``
half their columns, ``wo`` half its rows, the pool half its kv heads), a
shard equal to its slice of the phase's weights, every window captured
and no graph built after warmup, the phase's six prompts, 64 new tokens
each, whose greedy tokens are held against the tp=1 engine's over all 64
(``cover_streams``: equal up to a fork, which must be a tie by
``judge_resume``, then resumed from the fork on the tp=1 tokens and held
again, until the stream's end), the decode kernel's launches
``n_layers x 2 ranks x decode steps`` and no other kernel's, ``stats()``
reporting the topology (2, 1, 2), and the peak memory; then one replay of
each engine's 8-step decode window from the same lane state, profiled
(wall, device busy, top kernels), and the reductions of one decode step
(``2 x n_layers`` of them, captured in one graph) timed alone, each
labelled "two ranks on one card". Phase 3 checks and times both decode
kernels at the per-rank heads too. Nothing here ran on two cards.

After the bf16 engine's phases (``phase_bench_reset``):
``bench_reset_slots(1024, 64)`` gives every slot distinct blocks covering
1089 positions (host and device table rows, the window's table written in
place), then the captured 8-step window replays from length 1024 on every
lane and launches B1 ``n_layers x 8`` times, each lane's keys written
through its new row.

After the engines, two phases of the port's tooling (``PORT_PHASES``):

- zygote (``phase_zygote``): ``python -m tpu9_torch.runner.zygote``
  forks a child (``ZYGOTE_CHILD``) over the reference's
  socket protocol, and a fresh interpreter runs the same module: llama3-8b
  paged bf16 at full width and depth with phase 4's weights, four greedy
  requests of 128, 256, 512 and 1024 tokens, 32 new tokens each. The two
  give the same tokens and B1 ``n_layers x decode steps`` launches (counted
  in the child between its serve's zeroing and its end), no other
  kernel's; the child exits 0 and is reaped (``{"exit": 0}``); the zygote
  reports CUDA uninitialised after its warm-up, is never in
  ``nvidia-smi --query-compute-apps`` and holds no ``/dev/nvidia`` file,
  and the child finds CUDA uninitialised at its start. The cold starts,
  spawn to first token, are printed side by side;
- graphcheck (``phase_graphcheck``): the graph check's fake-tensor matrix
  and Pass B without a finding, timed; the ``llama3-8b@1x1`` and
  ``llama3-8b@2x1+wint8+kvint8`` cells over real CUDA tensors (2 layers,
  full width) without a finding, B1 and B2 launched the counts their jobs
  imply; and two seeded faults (an int8 weight into ``torch.matmul``, a
  pool rebuilt out of place) found as GRA004 and GRA003.

The kernel launch counts are zeroed just before each engine phase's
requests (and the KV-motion and spec phases') and read just after: each
decode kernel of the phase's path must have launched ``n_layers x decode
steps`` times (a replayed window adds the launches its capture counted),
plus, in a paged spec phase, ``n_layers x verify windows`` (one call a
layer for a window's B*T rows), the flash kernel (dense path) ``n_layers x
prefills``, and every other kernel never.

With ``--profile``, one replay of each engine's captured 8-step decode
window and one fused admission group of each paged engine (one bucket-2048
prefill of the dense engine) are profiled with ``torch.profiler`` (wall and
device-busy time, top kernels; full tables under ``build/profile/``), and
after each spec phase one replay of its captured verify window beside its
8-step decode window, from the same lane state.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. It needs a CUDA device and the rest of
the repository beside it; without either it exits non-zero and prints no
result.
"""

from __future__ import annotations

import asyncio
import dataclasses
import gc
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
BF16_FLOP_PER_S = 989e12           # H100 SXM dense bf16 tensor-core peak
L2_FLUSH_BYTES = 256 << 20         # larger than the 50 MB L2
SPIN_CYCLES = 2_000_000            # about 1 ms of the device's clock
HOST_SPIN_CYCLES = 50_000_000      # about 25 ms: outlasts HOST_CALLS calls
HOST_CALLS = 100


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# -- phase 1: card ------------------------------------------------------------

def phase_card() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} "
          f"devices {torch.cuda.device_count()}")
    return card


# -- phase 2: build -----------------------------------------------------------

PTXAS_SPLIT = re.compile(r"split_decode_kernelI(13__nv_bfloat16|a)"
                         r"(?:NS_)?\d+(Table|Contiguous)E?Li(\d+)ELi(\d+)E")
PTXAS_FLASH = re.compile(r"flash_kernelILi(\d+)ELb([01])E")
PTXAS_BACKWARD = re.compile(r"(dkdv_kernel|dq_kernel)ILi(\d+)ELb([01])E")
# the decode instances the served models run, which must not spill:
# llama3-8b (G = 4, D = 128), gemma-7b (G = 1, D = 256; bf16 pool and
# contiguous cache) and gemma-2b-int8 (G = 8, D = 256, int8 pool)
NO_SPILL = {("bf16", "Table", 4, 128), ("int8", "Table", 4, 128),
            ("bf16", "Contiguous", 4, 128), ("bf16", "Table", 1, 256),
            ("bf16", "Contiguous", 1, 256), ("int8", "Table", 8, 256)}
# the flash instances of llama3-8b's and gemma-7b's prefill (causal or not)
FLASH_NO_SPILL = {(128, True), (128, False), (256, True), (256, False)}
# the backward's instances the train steps run (causal; D 256 for gemma-7b,
# 64 for llama-1b) and D 128's, both of its kernels
BACKWARD_NO_SPILL = {(kernel, d, True)
                     for kernel in ("dkdv_kernel", "dq_kernel")
                     for d in (64, 128, 256)}


def ptxas_report(log: str) -> dict[str, dict]:
    """Registers and spill bytes of each kernel in an ``nvcc -Xptxas -v``
    log, by mangled name."""
    report, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)", line)
        if m:
            name = m.group(1)
            report.setdefault(name, {})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            report[name]["spills"] = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            report[name]["registers"] = int(m.group(1))
    return report


def phase_build(kernels: list[str]) -> None:
    from tpu9_torch.ops import _build
    t0 = time.perf_counter()
    logs = _build.build_all(kernels)
    print(f"build: {time.perf_counter() - t0:.2f} s for {kernels} "
          f"({len(logs)} compiled)")
    seen, flash_seen, backward_seen = set(), set(), set()
    for source, log in logs.items():
        for line in log.splitlines():
            # warnings, and ptxas's notes on serialised wgmma products
            if "warning" in line.lower() or "wgmma" in line:
                print(f"  nvcc {source}: {line.strip()}")
        for name, info in sorted(ptxas_report(log).items()):
            m = PTXAS_SPLIT.search(name)
            f = PTXAS_FLASH.search(name)
            g = PTXAS_BACKWARD.search(name)
            label = name
            if m:
                key = ("bf16" if m.group(1) != "a" else "int8", m.group(2),
                       int(m.group(3)), int(m.group(4)))
                label = "split_decode_kernel<{}, {}, G={}, D={}>".format(*key)
                if key in NO_SPILL:
                    seen.add(key)
                    check(info.get("spills") == (0, 0), f"ptxas: {label} "
                          f"spills {info.get('spills')}")
            elif "combine_kernel" in name:
                label = "combine_kernel<D={}>".format(
                    re.search(r"combine_kernelILi(\d+)E", name).group(1))
            elif f:
                key = (int(f.group(1)), f.group(2) == "1")
                label = "flash_kernel<D={}, {}>".format(
                    key[0], "causal" if key[1] else "non-causal")
                if key in FLASH_NO_SPILL:
                    flash_seen.add(key)
                    check(info.get("spills") == (0, 0), f"ptxas: {label} "
                          f"spills {info.get('spills')}")
            elif g:
                key = (g.group(1), int(g.group(2)), g.group(3) == "1")
                label = "{}<D={}, {}>".format(
                    key[0], key[1], "causal" if key[2] else "non-causal")
                if key in BACKWARD_NO_SPILL:
                    backward_seen.add(key)
                    check(info.get("spills") == (0, 0), f"ptxas: {label} "
                          f"spills {info.get('spills')}")
            print(f"  ptxas {source}: {label}: {info.get('registers')} "
                  f"registers, spill stores/loads {info.get('spills')}")
    if "paged_decode_attention" in logs:
        check(seen == NO_SPILL, f"ptxas reported no served decode instance "
              f"of {sorted(NO_SPILL - seen)}")
    if "flash_attention" in logs:
        check(flash_seen == FLASH_NO_SPILL, f"ptxas reported no served flash "
              f"instance of {sorted(FLASH_NO_SPILL - flash_seen)}")
    if "flash_attention_backward" in logs:
        missing = sorted(BACKWARD_NO_SPILL - backward_seen)
        check(not missing, f"ptxas reported no backward instance of "
              f"{missing}")


# -- phase 3: kernels against their twins -------------------------------------

def time_ms(fn, iters: int = 60, hold: bool = False) -> float:
    """Median time of one call, CUDA events around each call, with the L2
    cache flushed before every call (a decode step finds each layer's pool
    cold). The host enqueues the call while the device runs the flush, so
    where the host takes longer than the flush its enqueue time counts
    too, as in a host-bound decode step. With ``hold``, a spin kernel keeps
    the device busy while the host enqueues, so the events time the
    device's work alone."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=DEVICE)
    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        if hold:
            torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def host_us(fn, rounds: int = 5) -> float:
    """Host time of one call of ``fn`` in microseconds (a wrapper's checks,
    allocations and launches): the median over ``rounds`` of the host
    clock over HOST_CALLS calls, enqueued while a spin kernel holds the
    device, so that no call waits for it."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        torch.cuda._sleep(HOST_SPIN_CYCLES)
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            fn()
        times.append((time.perf_counter() - t0) / HOST_CALLS * 1e6)
        torch.cuda.synchronize()
    return float(np.median(times))


def measure(kernel, twin, library) -> dict:
    """The times of a kernel row: the kernel, its twin and the library call
    with ``time_ms`` as a host-bound step sees them, the kernel and the
    library call on the device alone, and the kernel wrapper's host time
    per call."""
    return {"ms": time_ms(kernel), "device_ms": time_ms(kernel, hold=True),
            "host_us": host_us(kernel), "plain_ms": time_ms(twin),
            "library_ms": time_ms(library),
            "library_device_ms": time_ms(library, hold=True)}


def print_times(name: str, label: str, t: dict, bound: tuple[float, str],
                library: str) -> None:
    print(f"kernel {name} [{label}]: {t['ms']:.4f} ms (device alone "
          f"{t['device_ms']:.4f} ms, wrapper host {t['host_us']:.1f} us a "
          f"call), bound {bound[0]:.5f} ms ({bound[1]}, "
          f"{bound[0] / t['device_ms']:.1%} of the device time), plain twin "
          f"{t['plain_ms']:.4f} ms, {library} {t['library_ms']:.4f} ms "
          f"(device alone {t['library_device_ms']:.4f} ms)")


def paged_case(batch: int, q_heads: int, kv_heads: int, head_dim: int,
               block_s: int, max_blocks: int, lens: list[int], seed: int,
               quant: bool = False):
    """Decode operands on the card: each sequence gets ceil(len/BS) distinct
    pool blocks, and every table entry past its prefix names a poisoned
    pool block: NaN-filled for bf16. An int8 payload cannot be NaN, so an
    int8 pool (``quant``) poisons those blocks through NaN scales (and
    payload 127): any read past a prefix still shows as a non-finite
    output."""
    rng = np.random.default_rng(seed)
    need = [-(-n // block_s) for n in lens]
    n_poison = 4
    n_blocks = sum(need) + n_poison
    perm = rng.permutation(sum(need))
    poison = np.arange(sum(need), n_blocks)
    table = np.empty((batch, max_blocks), dtype=np.int32)
    used = 0
    for b, nb in enumerate(need):
        table[b, :nb] = perm[used:used + nb]
        table[b, nb:] = rng.choice(poison, size=max_blocks - nb)
        used += nb
    dev = DEVICE
    q = torch.from_numpy(rng.standard_normal((batch, 1, q_heads, head_dim),
                                             dtype=np.float32)).to(dev, torch.bfloat16)
    shape = (n_blocks, block_s, kv_heads, head_dim)
    k = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev, torch.bfloat16)
    v = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev, torch.bfloat16)
    case = dict(q=q, table=torch.from_numpy(table).to(dev),
                lens=torch.tensor(lens, dtype=torch.int32, device=dev),
                poison=torch.from_numpy(poison).to(dev))
    if quant:
        from tpu9_torch.ops.quant import quantize_kv
        (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
        k[poison] = 127
        v[poison] = 127
        ks[poison] = float("nan")
        vs[poison] = float("nan")
        case.update(ks=ks, vs=vs)
    else:
        k[poison] = float("nan")
        v[poison] = float("nan")
    return dict(case, k=k, v=v)


def roofline_ms(n_bytes: int, flops: int) -> tuple[float, str]:
    """The least time for moving ``n_bytes`` and doing ``flops`` bf16
    operations on the card, and which of the two sets it."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def paged_bound(case, lens: list[int]) -> tuple[float, str]:
    """Least time for the work this case's data needs: each valid k/v row
    (and, for an int8 pool, its f32 scale) read once, q read and the
    output written once, the valid table entries and lengths read once; 4
    flops per (query head, dim, position)."""
    q = case["q"]
    _, _, q_heads, head_dim = q.shape
    _, block_s, kv_heads, _ = case["k"].shape
    positions = sum(lens)
    per_vec = head_dim * case["k"].element_size() + (4 if "ks" in case else 0)
    n_bytes = (positions * kv_heads * per_vec * 2
               + 2 * q.numel() * 2
               + sum(-(-n // block_s) for n in lens) * 4 + len(lens) * 4)
    return roofline_ms(n_bytes, 4 * positions * q_heads * head_dim)


def sdpa_over_dense(case, k_dense, v_dense):
    """``F.scaled_dot_product_attention`` over the already densified cache:
    the yardstick ``library_ms``. The port never calls it."""
    import torch.nn.functional as F
    q = case["q"].transpose(1, 2)                      # [B, QH, 1, D]
    k = k_dense.transpose(1, 2).contiguous()           # [B, KH, S, D]
    v = v_dense.transpose(1, 2).contiguous()
    s = k.shape[2]
    mask = (torch.arange(s, device=DEVICE)[None, :]
            < case["lens"][:, None].long())[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  enable_gqa=True)


DECODE_SRC = "tpu9_torch/csrc/paged_decode_attention.cu"
KERNELS = {
    # name: (TPU kernel it replaces, CUDA source)
    "paged_decode_attention": ("tpu9/ops/paged_attention.py:176", DECODE_SRC),
    "paged_decode_attention_quant": ("tpu9/ops/paged_attention.py:276",
                                     DECODE_SRC),
    "flash_attention": ("tpu9/ops/attention.py:119",
                        "tpu9_torch/csrc/flash_attention.cu"),
    # the gradient of the same TPU kernel, which has none (ROADMAP C11)
    "flash_attention_backward": (
        "tpu9/ops/attention.py:119",
        "tpu9_torch/csrc/flash_attention_backward.cu"),
    "ragged_decode_attention": ("tpu9/ops/paged_attention.py:93",
                                DECODE_SRC),
}


def wrapper(name: str):
    """The port's wrapper of a kernel of ``KERNELS``; it counts launches."""
    from tpu9_torch.ops import attention, paged_attention
    return getattr(attention if name.startswith("flash_attention") else
                   paged_attention, name)


def kernel_row(name: str, label: str, max_err: float, times: dict,
               bound: tuple[float, str]) -> dict:
    return {"name": name, "route": "cuda", "source": KERNELS[name][1],
            "replaces": KERNELS[name][0], "shape": label,
            "max_abs_err": max_err, **times, "bound_ms": bound[0],
            "bound_by": bound[1]}


PAGED_LENS = [1, 127, 128, 129, 1000, 2048, 513, 1777]
# (q heads, kv heads) of the served models; llama3-8b and llama-1b share
# theirs, and both gemma models have head_dim 256
LLAMA_HEADS = (32, 8)
GEMMA_HEADS = {"gemma-7b": (16, 16), "gemma-2b": (8, 1)}


def check_twin(name: str, label: str, got: torch.Tensor,
               want: torch.Tensor) -> float:
    """The decode kernels' check: finite, and within one bf16 ulp of the
    twin's f32 result rounded to bf16. Both round an f32 result to bf16;
    results that differ only in f32 summation order (split-KV merges the
    same sums in another order) round at most one bf16 ulp apart (2^-7
    relative), and outputs near zero keep an absolute slack of 1e-4."""
    check(bool(torch.isfinite(got).all()), f"{name} {label}: kernel output "
          f"not finite (read a block or position past a length?)")
    err = (got.float() - want).abs()
    max_err = float(err.max())
    check(bool((err <= 2.0 ** -7 * want.abs() + 1e-4).all()),
          f"{name} {label}: kernel disagrees with its twin (max abs err "
          f"{max_err})")
    return max_err


def paged_kernel_case(name: str, batch: int, head_dim: int, lens: list[int],
                      seed: int, heads: tuple[int, int] = LLAMA_HEADS,
                      block_s: int = 128, max_blocks: int = 17) -> dict:
    """The kernel call, its twin and the twin's result, the densified cache
    for the library call, and the bound, for one paged case with ``heads``
    = (q heads, kv heads) over a table of ``max_blocks`` blocks of
    ``block_s`` positions."""
    from tpu9_torch.ops import paged_attention as pa
    quant = name.endswith("_quant")
    launcher = wrapper(name)
    case = paged_case(batch=batch, q_heads=heads[0], kv_heads=heads[1],
                      head_dim=head_dim, block_s=block_s,
                      max_blocks=max_blocks, lens=lens, seed=seed,
                      quant=quant)
    q, k, v, table, clen = (case[n] for n in ("q", "k", "v", "table", "lens"))
    scales = (case["ks"], case["vs"]) if quant else ()
    # the twin densifies every table entry, so it runs on a copy whose
    # poisoned blocks are zeroed (they are masked either way). For the int8
    # pool it runs on q.float(): it then dequantizes to f32 as the kernel
    # does (with a bf16 q it would round the dequantized cache to bf16),
    # and its f32 result is rounded to bf16 once, as the kernel's is
    clean = {n: case[n].clone() for n in ("k", "v", "ks", "vs") if n in case}
    for t in clean.values():
        t[case["poison"]] = 0
    if quant:
        def twin():
            return pa.xla_paged_decode_attention(
                q.float(), clean["k"], clean["v"], table, clen, clean["ks"],
                clean["vs"])
        dense = [pa.gather_paged(clean[n], table, clean[s])
                 for n, s in (("k", "ks"), ("v", "vs"))]
    else:
        def twin():
            return pa.xla_paged_decode_attention(q, clean["k"], clean["v"],
                                                 table, clen)
        dense = [pa.gather_paged(clean[n], table) for n in ("k", "v")]
    return dict(kernel=lambda: launcher(q, k, v, *scales, table, clen),
                twin=twin, want=twin().to(torch.bfloat16).float(),
                library=sdpa_over_dense(case, *dense),
                bound=paged_bound(case, lens), quant=quant)


def ragged_kernel_case(head_dim: int, lens: list[int], seed: int,
                       heads: tuple[int, int] = LLAMA_HEADS) -> dict:
    """The ragged kernel over a contiguous [B, 2048] cache, B = len(lens);
    every cache position at or past a length is NaN, so a read past one
    shows as a non-finite output. The twin masks by length but multiplies
    every position, so it runs on a copy whose NaNs are zeroed. Every
    length is >= 1, as the engine's are: at length 0 the kernel gives zeros
    and the twin the mean of v, so the two are not compared there."""
    from tpu9_torch.ops import attention as at
    from tpu9_torch.ops import paged_attention as pa
    rng = np.random.default_rng(seed)
    b, s, (q_heads, kv_heads) = len(lens), 2048, heads

    def bf16(shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                ).to(DEVICE, torch.bfloat16)

    q = bf16((b, 1, q_heads, head_dim))
    k = bf16((b, s, kv_heads, head_dim))
    v = bf16((b, s, kv_heads, head_dim))
    for i, n in enumerate(lens):
        k[i, n:] = float("nan")
        v[i, n:] = float("nan")
    clen = torch.tensor(lens, dtype=torch.int32, device=DEVICE)
    k_clean, v_clean = k.nan_to_num(0.0), v.nan_to_num(0.0)

    def twin():
        return at.xla_decode_attention(q, k_clean, v_clean, clen)
    # each valid k/v row once, q and out once, the lengths once
    pos = sum(lens)
    bound = roofline_ms(2 * pos * kv_heads * head_dim * 2 + 2 * q.numel() * 2
                        + 4 * b, 4 * pos * q_heads * head_dim)
    return dict(kernel=lambda: pa.ragged_decode_attention(q, k, v, clen),
                twin=twin, want=twin().float(),
                library=sdpa_over_dense({"q": q, "lens": clen}, k_clean,
                                        v_clean),
                bound=bound, quant=False)


def decode_kernel_case(name: str, batch: int, head_dim: int,
                       lens: list[int],
                       heads: tuple[int, int] = LLAMA_HEADS,
                       table: tuple[int, int] = (128, 17)) -> dict:
    seed = head_dim + batch + sum(heads) - 48          # llama's: D + B - 8
    if name == "ragged_decode_attention":
        return ragged_kernel_case(head_dim, lens, seed=100 + seed,
                                  heads=heads)
    return paged_kernel_case(name, batch, head_dim, lens, seed=seed,
                             heads=heads, block_s=table[0],
                             max_blocks=table[1])


def phase_decode_kernel(name: str, label: str, head_dim: int,
                        batch: int = 8, lens: list[int] = PAGED_LENS,
                        heads: tuple[int, int] = LLAMA_HEADS,
                        table: tuple[int, int] = (128, 17)) -> dict:
    """One decode kernel at one shape: launched once, checked finite over
    the poisoned blocks (NaN positions) and against its twin, then timed
    beside the twin, one library call and its bound. ``table`` is a paged
    case's (block size, table width)."""
    c = decode_kernel_case(name, batch, head_dim, lens, heads, table)
    launcher = wrapper(name)
    before = launcher.launches
    got = c["kernel"]()
    torch.cuda.synchronize()
    check(launcher.launches == before + 1, f"{name} did not launch its kernel")
    max_err = check_twin(name, label, got, c["want"])
    print(f"kernel {name} [{label}]: max_abs_err {max_err:.3e} (tolerance "
          f"|err| <= 2^-7*|twin| + 1e-4: one bf16 ulp of rounding an f32 "
          f"result whose summation order differs)")
    times = measure(c["kernel"], c["twin"], c["library"])
    what = ("the dense dequantized cache" if c["quant"] else "the dense cache"
            if name != "ragged_decode_attention" else "the cache")
    print_times(name, label, times, c["bound"], f"sdpa over {what}")
    return kernel_row(name, label, max_err, times, c["bound"])


# a verify window of spec_len 8: T = 9 queries a slot, the window's last
# position one short of each decode row's length (at least T long)
VERIFY_T = 9
VERIFY_LENS = [max(n, VERIFY_T) for n in PAGED_LENS]


def verify_route_case(quant: bool, head_dim: int, heads: tuple[int, int],
                      seed: int) -> dict:
    """``paged_verify_attention`` on the card at a verify window's shapes:
    B=8 slots of T=9 queries at positions [len - 9, len), the pool's
    blocks past each prefix poisoned as in ``paged_case``. The route is
    B*T one-token rows through B1 (bf16 pool) or B2 (int8 pool); its twin
    is the reference's gather + chunk attention over a copy whose poisoned
    blocks are zeroed (for the int8 pool at f32 q, rounded to bf16 once, as
    the kernel rounds). ``library_ms``: SDPA over the densified cache with
    the position mask as ``attn_mask``. Bound: each slot's prefix rows
    (and scales) read once, q read and the output written once, the
    valid table entries and the positions read once; 4 flops per (q head,
    dim, attended pair)."""
    import torch.nn.functional as F
    from tpu9_torch.ops import attention as at
    from tpu9_torch.ops import paged_attention as pa
    case = paged_case(batch=8, q_heads=heads[0], kv_heads=heads[1],
                      head_dim=head_dim, block_s=128,
                      max_blocks=2048 // 128 + 1, lens=VERIFY_LENS,
                      seed=seed, quant=quant)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed)
    q = torch.randn((8, VERIFY_T, heads[0], head_dim), generator=gen,
                    device=DEVICE).to(torch.bfloat16)
    k, v, table = case["k"], case["v"], case["table"]
    positions = (torch.tensor(VERIFY_LENS, dtype=torch.int32,
                              device=DEVICE)[:, None] - VERIFY_T
                 + torch.arange(VERIFY_T, dtype=torch.int32, device=DEVICE))
    scales = (case["ks"], case["vs"]) if quant else ()
    clean = {n: case[n].clone() for n in ("k", "v", "ks", "vs") if n in case}
    for t in clean.values():
        t[case["poison"]] = 0
    cscales = (clean["ks"], clean["vs"]) if quant else ()
    qt = q.float() if quant else q

    def twin():
        return at.xla_paged_verify_attention(qt, clean["k"], clean["v"],
                                             table, positions, *cscales)
    dense = [pa.gather_paged(clean[n], table, clean[s] if quant else None)
             for n, s in (("k", "ks"), ("v", "vs"))]
    kd, vd = (x.transpose(1, 2).contiguous() for x in dense)
    qd = q.transpose(1, 2)
    s_max = kd.shape[2]
    mask = (torch.arange(s_max, device=DEVICE)[None, None, :]
            <= positions[:, :, None].long())[:, None]          # [B,1,T,S]
    pos = sum(VERIFY_LENS)
    per_vec = head_dim * k.element_size() + (4 if quant else 0)
    attended = int((positions.long() + 1).sum())
    bound = roofline_ms(
        pos * heads[1] * per_vec * 2 + 2 * q.numel() * 2
        + sum(-(-n // 128) for n in VERIFY_LENS) * 4 + positions.numel() * 4,
        4 * attended * heads[0] * head_dim)
    return dict(
        kernel=lambda: at.paged_verify_attention(q, k, v, table, positions,
                                                 *scales),
        twin=twin, want=twin().to(torch.bfloat16).float(),
        library=lambda: F.scaled_dot_product_attention(
            qd, kd, vd, attn_mask=mask, enable_gqa=True),
        bound=bound)


def phase_verify_route(quant: bool, label: str, head_dim: int = 128,
                       heads: tuple[int, int] = LLAMA_HEADS) -> dict:
    """The verify route at one shape: one call must launch its decode
    kernel once (one call for all B*T rows), be finite over the poisoned
    blocks and within one bf16 ulp of its twin; then timed beside the twin,
    SDPA and its bound."""
    name = "paged_decode_attention" + ("_quant" if quant else "")
    c = verify_route_case(quant, head_dim, heads,
                          seed=head_dim + sum(heads) + int(quant))
    launcher = wrapper(name)
    before = launcher.launches
    got = c["kernel"]()
    torch.cuda.synchronize()
    check(launcher.launches == before + 1,
          f"paged_verify_attention did not launch {name} once")
    max_err = check_twin(name, label, got, c["want"])
    print(f"kernel {name} [{label}]: max_abs_err {max_err:.3e} (tolerance "
          f"|err| <= 2^-7*|twin| + 1e-4)")
    times = measure(c["kernel"], c["twin"], c["library"])
    print_times(name, label, times, c["bound"],
                "sdpa over the dense cache with the position mask")
    return kernel_row(name, label, max_err, times, c["bound"])


def print_split_plans() -> None:
    from tpu9_torch.ops import paged_attention as pa
    for what, batch, max_blocks, block_s in (
            ("paged", 8, 17, 128), ("paged", 1, 17, 128),
            ("contiguous", 8, 8, 256), ("contiguous", 1, 8, 256)):
        n_splits, bps = pa.split_plan(max_blocks, block_s)
        grids = ", ".join(f"KH={kh}: {kh * batch * n_splits}"
                          for kh in (8, 16, 1))
        print(f"split plan ({what} B={batch} MB={max_blocks} "
              f"BS={block_s}, SPLIT_TOKENS {pa.SPLIT_TOKENS}): {n_splits} "
              f"splits of {bps} blocks, grid CTAs {grids}")


def flash_limit(want: torch.Tensor, v: torch.Tensor, q_heads: int,
                causal: bool) -> torch.Tensor:
    """The flash kernel's tolerance against its twin's result ``want``
    [B, T, QH, D] (f32 softmax and sums, rounded to bf16 once), for T = S.
    The kernel rounds each probability to bf16 for the PV product (a
    relative error of at most 2^-9 each, on weights that sum to 1): up to
    2^-9 * max|v| over the keys a row attends, on top of one bf16 ulp of
    the rounded result (2^-7 relative) and 1e-4 near zero."""
    group = q_heads // v.shape[2]
    vmax = v.float().abs().amax(-1).repeat_interleave(group, dim=2)  # [B,S,QH]
    vmax = vmax.cummax(dim=1).values if causal \
        else vmax.amax(dim=1, keepdim=True)
    return 2.0 ** -7 * want.abs() + 2.0 ** -9 * vmax[..., None] + 1e-4


def check_flash(label: str, got: torch.Tensor, want: torch.Tensor,
                v: torch.Tensor, causal: bool) -> float:
    """Finite, and within ``flash_limit`` of the twin's result."""
    limit = flash_limit(want, v, got.shape[2], causal)
    err = (got.float() - want).abs()
    max_err = float(err.max())
    print(f"kernel flash_attention [{label}]: max_abs_err {max_err:.3e} "
          f"(tolerance |err| <= 2^-7*|twin| + 2^-9*max|v attended| + 1e-4)")
    check(bool(torch.isfinite(got).all()) and bool((err <= limit).all()),
          f"flash_attention {label}: kernel disagrees with its twin (max abs "
          f"err {max_err})")
    return max_err


# (T = S, head_dim, causal, heads): llama3-8b's prefill buckets, the
# llama-1b head_dim at the longest and one non-causal shape; then the same
# buckets and a non-causal shape at the heads of gemma-7b and gemma-2b
FLASH_SHAPES = ((128, 128, True, LLAMA_HEADS), (512, 128, True, LLAMA_HEADS),
                (2048, 128, True, LLAMA_HEADS), (2048, 64, True, LLAMA_HEADS),
                (512, 128, False, LLAMA_HEADS)) + tuple(
    (t, 256, causal, heads) for heads in GEMMA_HEADS.values()
    for t, causal in ((128, True), (512, True), (2048, True), (512, False)))


def phase_flash_kernel(t: int, head_dim: int, causal: bool,
                       heads: tuple[int, int] = LLAMA_HEADS) -> dict:
    """The flash kernel at one prefill shape (B=1, ``heads`` = (q heads, kv
    heads)) with T = S = ``t``, against ``xla_attention``."""
    import torch.nn.functional as F
    from tpu9_torch.ops import attention as at
    q_heads, kv_heads = heads
    label = (f"prefill B=1 T=S={t} QH={q_heads} KH={kv_heads} D={head_dim} "
             f"{'causal' if causal else 'non-causal'}")
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(t + head_dim + int(causal) + sum(heads) - 40)
    q, k, v = (torch.randn((1, t, h, head_dim), generator=gen, device=DEVICE
                           ).to(torch.bfloat16)
               for h in (q_heads, kv_heads, kv_heads))

    def kernel():
        return at.flash_attention(q, k, v, causal=causal)

    def twin():
        return at.xla_attention(q, k, v, causal=causal)

    before = at.flash_attention.launches
    got = kernel()
    torch.cuda.synchronize()
    check(at.flash_attention.launches == before + 1,
          "flash_attention did not launch its kernel")
    max_err = check_flash(label, got, twin().float(), v, causal)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    times = measure(kernel, twin, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, enable_gqa=True))
    # q, k, v read once and out written once; 4 flops per (q head, dim) of
    # each attended (query, key) pair: T(T+1)/2 of them when causal
    pairs = t * (t + 1) // 2 if causal else t * t
    bound = roofline_ms(2 * (2 * q.numel() + k.numel() + v.numel()),
                        4 * q_heads * head_dim * pairs)
    print_times("flash_attention", label, times, bound,
                "sdpa (is_causal, enable_gqa)")
    return kernel_row("flash_attention", label, max_err, times, bound)


def phase_flash_tails(causal: bool, batch: int = 2, t: int = 320,
                      head_dim: int = 128,
                      heads: tuple[int, int] = LLAMA_HEADS) -> float:
    """The flash kernel at T = S = 320 (a multiple of 64, not of the
    kernel's 128-row tiles) over ``batch`` sequences. q, k and v are the
    leading ``batch`` sequences of buffers that hold one more, all NaN: a
    tile that read past the last sequence would put NaN in the output (a
    masked key still multiplies its v row by 0), and one that read
    sequence 1's rows for sequence 0's tail would disagree with the
    twin."""
    from tpu9_torch.ops import attention as at
    q_heads, kv_heads = heads
    label = (f"tails B={batch} T=S={t} QH={q_heads} KH={kv_heads} "
             f"D={head_dim} {'causal' if causal else 'non-causal'}, NaN "
             f"sequence after")
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(7 + int(causal) + head_dim + sum(heads) - 168)
    bufs = [torch.randn((batch + 1, t, h, head_dim), generator=gen,
                        device=DEVICE).to(torch.bfloat16)
            for h in (q_heads, kv_heads, kv_heads)]
    for buf in bufs:
        buf[batch] = float("nan")
    q, k, v = (buf[:batch] for buf in bufs)
    before = at.flash_attention.launches
    got = at.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    check(at.flash_attention.launches == before + 1,
          "flash_attention did not launch its kernel")
    return check_flash(label, got, at.xla_attention(q, k, v, causal=causal
                                                    ).float(), v, causal)


def phase_kernels() -> list[dict]:
    """Phase 3. Returns the rows of the kernels line: each kernel at the
    shapes of the engine phase whose launches it reports (``path``):
    llama3-8b at B=8 and B=1, and gemma at B=8 (gemma-7b's heads; the
    int8-pool kernel at gemma-2b's, the model that serves it). The
    llama-1b head_dim, the other prefill buckets, the other gemma shapes
    and the tails are checked and printed beside them."""
    rows = []
    print_split_plans()
    llama_paths = {"paged_decode_attention": "bf16",
                   "paged_decode_attention_quant": "int8",
                   "flash_attention": "dense",
                   "ragged_decode_attention": "dense"}
    # mixtral-8x7b has llama3-8b's heads: its phases run the same instances
    mixtral_paths = {"paged_decode_attention": "mixtral-bf16",
                     "paged_decode_attention_quant": "mixtral-int8"}
    gemma_rows = {"paged_decode_attention": ("gemma-7b", "gemma-bf16"),
                  "paged_decode_attention_quant": ("gemma-2b", "gemma-int8"),
                  "ragged_decode_attention": ("gemma-7b", "gemma-dense")}

    def keep(row: dict, path: str) -> None:
        rows.append(dict(row, path=path))

    def decode(name: str, what: str, bs: str) -> None:
        """``what`` names the path and the cache length, ``bs`` the block
        size (and table width)."""
        for batch, lens, n in ((8, PAGED_LENS, "B=8"),
                               (1, [2048], "B=1 len 2048")):
            row = phase_decode_kernel(
                name, f"llama3-8b {what.format(n)} QH=32 KH=8 D=128 {bs}",
                128, batch=batch, lens=lens)
            keep(row, llama_paths[name])
            if batch == 8 and name in TP_KERNELS:
                # the tp phase's per-rank shape: half of llama's heads
                keep(phase_decode_kernel(
                    name, f"llama3-8b tp=2 rank {what.format(n)} "
                    f"QH={TP_HEADS[0]} KH={TP_HEADS[1]} D=128 {bs}", 128,
                    batch=batch, lens=lens, heads=TP_HEADS),
                    f"tp-{llama_paths[name]}")
            if batch == 8 and name in mixtral_paths:
                keep(dict(row, shape="mixtral-8x7b (as llama3-8b) "
                          + row["shape"].removeprefix("llama3-8b ")),
                     mixtral_paths[name])
            if batch == 8 and name == "paged_decode_attention":
                # the zygote phase's forked child serves phase 4's engine
                keep(dict(row, shape="zygote child " + row["shape"]),
                     "zygote")
        phase_decode_kernel(name, f"llama-1b {what.format('B=8')} QH=32 KH=8 "
                            f"D=64 {bs}", 64)
        for model, heads in GEMMA_HEADS.items():
            for batch, lens, n in ((8, PAGED_LENS, "B=8"),
                                   (1, [2048], "B=1 len 2048")):
                row = phase_decode_kernel(
                    name, f"{model} {what.format(n)} QH={heads[0]} "
                    f"KH={heads[1]} D=256 {bs}", 256, batch=batch, lens=lens,
                    heads=heads)
                if batch == 8 and gemma_rows[name][0] == model:
                    keep(row, gemma_rows[name][1])

    for name in ("paged_decode_attention", "paged_decode_attention_quant"):
        decode(name, "decode {}", "BS=128 MB=17")
    for shape in FLASH_SHAPES:
        row = phase_flash_kernel(*shape)
        if shape == (2048, 128, True, LLAMA_HEADS):
            keep(row, "dense")
        elif shape == (2048, 256, True, GEMMA_HEADS["gemma-7b"]):
            keep(row, "gemma-dense")
    for head_dim, heads in ((128, LLAMA_HEADS), *(
            (256, h) for h in GEMMA_HEADS.values())):
        for causal in (True, False):
            phase_flash_tails(causal, head_dim=head_dim, heads=heads)
    decode("ragged_decode_attention", "dense decode {} S=2048", "BS=256")
    # B3 under a gradient, at the train phases' shapes
    for path in GRAD_SHAPES:
        for row in phase_flash_grad(path):
            keep(row, path)
    for case in BACKWARD_CHECKS:
        phase_flash_backward_check(*case)
    # the paged verify route: B*T rows through B1 / B2, the spec phases'
    # paths at llama's heads, gemma's heads checked and printed
    for quant, path in ((False, "spec-bf16"), (True, "spec-int8")):
        pool = "int8 pool" if quant else "bf16 pool"
        keep(phase_verify_route(
            quant, f"llama3-8b verify B=8 T={VERIFY_T} {pool} QH=32 KH=8 "
            f"D=128 BS=128 MB=17"), path)
        for model, heads in GEMMA_HEADS.items():
            phase_verify_route(
                quant, f"{model} verify B=8 T={VERIFY_T} {pool} "
                f"QH={heads[0]} KH={heads[1]} D=256 BS=128 MB=17", 256,
                heads)
    # the graph check's real-tensor cells, each rank's heads: their jobs
    # run with every lane inactive, so every lane at length 1
    from tpu9_torch.analysis.graphcheck.matrix import find_cells
    for cell in find_cells(list(GRAPHCHECK_REAL)):
        tp = int(cell.topology.split("x")[0])
        heads = (LLAMA_HEADS[0] // tp, LLAMA_HEADS[1] // tp)
        table = (cell.kv_block_size,
                 cell.max_seq_len // cell.kv_block_size + 1)
        keep(phase_decode_kernel(
            GRAPHCHECK_REAL[cell.name], f"graphcheck {cell.name} decode "
            f"B={cell.max_batch} len 1 QH={heads[0]} KH={heads[1]} D=128 "
            f"BS={table[0]} MB={table[1]}", 128, batch=cell.max_batch,
            lens=[1] * cell.max_batch, heads=heads, table=table),
            "graphcheck")
    return rows


# -- phase 3, B3 under a gradient: the train steps' attention --------------------

# the train phases' attention shapes: (batch, T = S, (q heads, kv heads),
# head_dim, model), causal. gemma-7b's LoRA step takes examples/05's
# tokens (8, 512); llama-1b's full step takes (4, 1024); the sharded steps
# run each tp rank's heads (gemma-7b at tp=4, llama-1b at tp=2)
GRAD_SHAPES = {"lora": (8, 512, (16, 16), 256, "gemma-7b"),
               "full": (4, 1024, (32, 8), 64, "llama-1b"),
               "lora-fsdp": (8, 512, (4, 4), 256, "gemma-7b tp=4 rank"),
               "full-fsdp": (4, 1024, (16, 4), 64, "llama-1b tp=2 rank")}


def grad_limit(want: torch.Tensor, group: int) -> torch.Tensor:
    """The tolerance of a bf16 gradient of the Function's backward against
    autograd through the f32 twin, ``want``. Both take the same f32
    products in other orders (about 1e-6 of the largest entry apart) and
    round once to bf16: one bf16 ulp, 2^-7 of |want|. Through the twin,
    dk and dv of a kv head come from its ``group`` q heads' terms, each
    rounded to bf16 before they are summed (the backward of the GQA
    expansion runs after the cast): up to half an ulp of each term, taken
    here as ``group`` x 2^-8 of the tensor's largest entry."""
    top = want.abs().max()
    return 2.0 ** -7 * want.abs() + group * 2.0 ** -8 * top + 1e-5 * top


def lse_limit(want: torch.Tensor, seq_k: int) -> torch.Tensor:
    """The forward kernel's row log-sum-exp against the twin's ``want``
    [B, QH, T]: f32 scores of the same bf16 operands summed in another
    order and exp2's approximation (2^-22 relative) move it by about 1e-6;
    the kernel's row sum adds up to S exponentials in f32 (S * 2^-24
    relative at most), and 1e-5 of 1 + |lse| covers the rest."""
    return seq_k * 2.0 ** -24 + 1e-5 * (1 + want.abs())


def backward_terms(q, k, v, out, lse, d_out, causal: bool):
    """The products over absolute values that bound the backward kernel's
    rounding: |P|^T |dO| for dv, scale |dS|^T |Q| for dk and scale |dS| |K|
    for dq, P and dS from the twin's algebra (``xla_attention_backward``)
    in f32, in the layouts of dq, dk and dv."""
    b, t, q_heads, d = q.shape
    s, kv_heads = k.shape[1], k.shape[2]
    g = q_heads // kv_heads
    scale = d ** -0.5

    def rows(x):
        return x.float().reshape(b, t, kv_heads, g, d).permute(
            0, 2, 3, 1, 4).reshape(b, kv_heads, g * t, d)

    qf, do = rows(q), rows(d_out)
    kf, vf = (x.float().transpose(1, 2) for x in (k, v))
    x = (qf * scale) @ kf.transpose(-1, -2)
    if causal:
        hidden = (torch.arange(s, device=q.device)[None, :]
                  > torch.arange(t, device=q.device)[:, None])
        x.masked_fill_(hidden.repeat(g, 1), -1e30)
    p = torch.exp(x - lse.reshape(b, kv_heads, g * t, 1))
    del x
    ds = (p * (do @ vf.transpose(-1, -2)
               - (do * rows(out)).sum(-1, keepdim=True))).abs()
    dv = p.transpose(-1, -2) @ do.abs()
    del p
    dk = scale * (ds.transpose(-1, -2) @ qf.abs())
    dq = (scale * (ds @ kf.abs())).reshape(b, kv_heads, g, t, d).permute(
        0, 3, 1, 2, 4).reshape(b, t, q_heads, d)
    return dq, dk.transpose(1, 2), dv.transpose(1, 2)


def backward_limit(want: torch.Tensor, term: torch.Tensor) -> torch.Tensor:
    """The backward kernel's tolerance against its twin on the same q, k,
    v, out, lse and d_out. Both take P = exp(x - lse) and delta =
    rowsum(d_out * out) in f32; the kernel rounds P and dS to bf16 (a
    relative error of at most 2^-8 each) before the products dV = P^T dO,
    dK = scale dS^T Q and dQ = scale dS K, so a gradient moves by at most
    2^-8 of the same product over absolute values (``term``). Both round
    the f32 result to bf16 once: one bf16 ulp apart (2^-7 of |twin|). The
    f32 sums run in other orders: 1e-5 of the tensor's largest entry."""
    return 2.0 ** -7 * want.abs() + 2.0 ** -8 * term + 1e-5 * want.abs().max()


def check_backward(label: str, q, k, v, d_out, causal: bool) -> float:
    """B3 and its backward kernel on one case. The forward kernel's output
    against the twin's (``flash_limit``, at T = S) and its row log-sum-exp
    against ``xla_attention_lse`` (``lse_limit``); the backward kernel's
    dq, dk and dv (one launch) against its twin ``xla_attention_backward``
    on the same out and lse (``backward_limit``); and the Function's
    gradients on the card (the kernel forward and backward) against
    autograd through the f32 twin on the same bf16 inputs (``grad_limit``).
    Returns the largest error."""
    from tpu9_torch.ops import attention as at
    t, s = q.shape[1], k.shape[1]
    group = q.shape[2] // k.shape[2]
    counts = (at.flash_attention, at.flash_attention_backward)
    before = [w.launches for w in counts]
    out, lse = at.flash_attention(q, k, v, causal=causal, with_lse=True)
    got = at.flash_attention_backward(q, k, v, out, lse, d_out, causal)
    torch.cuda.synchronize()
    check([w.launches for w in counts] == [n + 1 for n in before],
          f"{label}: the forward or backward kernel did not launch")
    want_out, want_lse = at.xla_attention_lse(q, k, v, causal=causal)
    max_err = 0.0
    if t == s:
        max_err = check_flash(label, out, want_out.float(), v, causal)
    err = (lse - want_lse).abs()
    print(f"kernel flash_attention [{label}]: lse max_abs_err "
          f"{float(err.max()):.3e} (tolerance |err| <= S*2^-24 + "
          f"1e-5*(1 + |lse|))")
    check(bool(torch.isfinite(lse).all())
          and bool((err <= lse_limit(want_lse, s)).all()),
          f"{label}: the forward's lse disagrees with the twin's (max abs "
          f"err {float(err.max())})")
    twin = at.xla_attention_backward(q, k, v, out, lse, d_out, causal)
    terms = backward_terms(q, k, v, out, lse, d_out, causal)
    for name, g, w, term in zip(("dq", "dk", "dv"), got, twin, terms):
        w = w.float()
        err = (g.float() - w).abs()
        print(f"kernel flash_attention_backward [{label}]: {name} against "
              f"its twin max_abs_err {float(err.max()):.3e} (tolerance |err| "
              f"<= 2^-7*|twin| + 2^-8*(the product over absolute values) + "
              f"1e-5*max|twin|: P and dS rounded to bf16 before their "
              f"products)")
        check(bool(torch.isfinite(g).all())
              and bool((err <= backward_limit(w, term)).all()),
              f"flash_attention_backward {label}: {name} disagrees with its "
              f"twin (max abs err {float(err.max())})")
        max_err = max(max_err, float(err.max()))
    del got, twin, terms
    leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
    got = torch.autograd.grad(at.FlashAttention.apply(*leaves, causal),
                              leaves, d_out)
    want = torch.autograd.grad(at.xla_attention(*leaves, causal=causal),
                               leaves, d_out)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        w = w.float()
        err = (g.float() - w).abs()
        rel = float(torch.linalg.vector_norm(g.float() - w)
                    / torch.linalg.vector_norm(w))
        print(f"kernel flash_attention_backward [{label}]: {name} against "
              f"autograd through the f32 twin max_abs_err "
              f"{float(err.max()):.3e}, norm-wise {rel:.3e} (tolerance "
              f"|err| <= 2^-7*|twin| + {group if name != 'dq' else 1}*2^-8*"
              f"max|twin| + 1e-5*max|twin|: one bf16 rounding each side, "
              f"the twin's per-q-head terms rounded before the GQA sum)")
        check(bool(torch.isfinite(g).all())
              and bool((err <= grad_limit(w, 1 if name == "dq" else group)
                        ).all()),
              f"flash_attention {label}: {name} disagrees with autograd "
              f"through the twin (max abs err {float(err.max())})")
        max_err = max(max_err, float(err.max()))
    return max_err


def phase_flash_grad(path: str) -> list[dict]:
    """B3 with its gradient at a train phase's shape: ``check_backward``;
    then the forward kernel, the backward kernel, the Function's forward
    and backward and their twins timed. Returns two rows of the kernels
    line: the Function's pair (``flash_attention``: ``ms`` the kernel
    forward and backward, ``plain_ms`` the twin under autograd,
    ``library_ms`` SDPA's forward and backward) and the backward kernel
    alone (``flash_attention_backward``: ``plain_ms`` its twin, the
    torch-ops backward, ``library_ms`` SDPA's backward alone)."""
    import torch.nn.functional as F
    from tpu9_torch.ops import attention as at
    batch, t, (q_heads, kv_heads), head_dim, model = GRAD_SHAPES[path]
    label = (f"{model} train B={batch} T=S={t} QH={q_heads} KH={kv_heads} "
             f"D={head_dim} causal, forward + gradient")
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(batch + t + head_dim)
    q, k, v = (torch.randn((batch, t, h, head_dim), generator=gen,
                           device=DEVICE).to(torch.bfloat16)
               for h in (q_heads, kv_heads, kv_heads))
    d_out = torch.randn(q.shape, generator=gen, device=DEVICE
                        ).to(torch.bfloat16)
    max_err = check_backward(label, q, k, v, d_out, True)
    leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
    qt, kt, vt = (x.detach().transpose(1, 2).contiguous().requires_grad_(True)
                  for x in (q, k, v))
    dot = d_out.transpose(1, 2).contiguous()

    def function():
        out = at.FlashAttention.apply(*leaves, True)
        return torch.autograd.grad(out, leaves, d_out)

    def twin():
        out = at.xla_attention(*leaves, causal=True)
        return torch.autograd.grad(out, leaves, d_out)

    def sdpa():
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                             enable_gqa=True)
        return torch.autograd.grad(out, (qt, kt, vt), dot)

    times = measure(function, twin, sdpa)
    times["forward_ms"] = time_ms(lambda: at.flash_attention(q, k, v))
    out, lse = at.flash_attention(q, k, v, causal=True, with_lse=True)
    args = (q, k, v, out, lse, d_out, True)
    sdpa_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)
    bwd = measure(lambda: at.flash_attention_backward(*args),
                  lambda: at.xla_attention_backward(*args),
                  lambda: torch.autograd.grad(sdpa_out, (qt, kt, vt), dot,
                                              retain_graph=True))
    # the pair: q, k, v and d_out read once, out, dq, dk and dv written
    # once; 4 flops per (q head, dim) of each attended pair forward (QK^T,
    # PV) and 8 backward (dP, dV, dQ, dK), at the bf16 peak
    pairs = batch * t * (t + 1) // 2
    bound = roofline_ms(2 * (4 * q.numel() + 2 * k.numel() + 2 * v.numel()),
                        12 * q_heads * head_dim * pairs)
    # the backward alone: q, k, v, out, d_out and lse read once, dq, dk and
    # dv written once; its 8 flops per (q head, dim, pair)
    bwd_bound = roofline_ms(2 * (4 * q.numel() + 2 * k.numel()
                                 + 2 * v.numel()) + 4 * lse.numel(),
                            8 * q_heads * head_dim * pairs)
    print_times("flash_attention", label, times, bound,
                "sdpa forward + backward (is_causal, enable_gqa)")
    bwd_label = label.replace("forward + gradient", "backward alone")
    print_times("flash_attention_backward", bwd_label, bwd, bwd_bound,
                "sdpa backward alone (is_causal, enable_gqa)")
    print(f"kernel flash_attention [{label}]: forward kernel "
          f"{times['forward_ms']:.4f} ms, backward kernel "
          f"{bwd['device_ms']:.4f} ms (its torch-ops twin "
          f"{bwd['plain_ms']:.4f} ms, sdpa's backward "
          f"{bwd['library_device_ms']:.4f} ms), Function forward + backward "
          f"{times['ms']:.4f} ms, sdpa forward + backward "
          f"{times['library_ms']:.4f} ms")
    return [kernel_row("flash_attention", label, max_err, times, bound),
            kernel_row("flash_attention_backward", bwd_label, max_err, bwd,
                       bwd_bound)]


# B3's backward beside the train shapes: D=128 at llama3-8b's heads, the
# tails (T = S = 320, not a multiple of 128), and S > T, causal (keys past T
# see no query) and not. (batch, T, S, (q heads, kv heads), head_dim,
# causal)
BACKWARD_CHECKS = ((2, 512, 512, LLAMA_HEADS, 128, True),
                   (2, 512, 512, LLAMA_HEADS, 128, False),
                   (2, 320, 320, LLAMA_HEADS, 128, True),
                   (2, 320, 320, LLAMA_HEADS, 128, False),
                   (2, 320, 320, GEMMA_HEADS["gemma-7b"], 256, True),
                   (2, 320, 320, GEMMA_HEADS["gemma-2b"], 256, False),
                   (2, 320, 320, LLAMA_HEADS, 64, True),
                   (2, 256, 384, (8, 2), 128, False),
                   (2, 256, 320, (8, 2), 64, True))


def phase_flash_backward_check(batch: int, t: int, s: int,
                               heads: tuple[int, int], head_dim: int,
                               causal: bool) -> float:
    """``check_backward`` at one shape. q, k, v and d_out are the leading
    ``batch`` sequences of buffers that hold one more, all NaN: a tile that
    read past the last sequence would put NaN in a gradient, and one that
    read the next sequence's rows for a tail would disagree."""
    q_heads, kv_heads = heads
    label = (f"backward B={batch} T={t} S={s} QH={q_heads} KH={kv_heads} "
             f"D={head_dim} {'causal' if causal else 'non-causal'}, NaN "
             f"sequence after")
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(t + s + head_dim + sum(heads) + int(causal))
    bufs = [torch.randn((batch + 1, n, h, head_dim), generator=gen,
                        device=DEVICE).to(torch.bfloat16)
            for n, h in ((t, q_heads), (s, kv_heads), (s, kv_heads),
                         (t, q_heads))]
    for buf in bufs:
        buf[batch] = float("nan")
    return check_backward(label, *(buf[:batch] for buf in bufs), causal)


# -- phases 4 to 9: the engines at full width ---------------------------------

MAX_NEW = 64
ENGINES = {
    # label: (preset, extra load_engine knobs, the kernels of its path);
    # knobs paged=False make the dense engine, kv_quant="int8" the int8
    # pool, and a "-int8" preset int8 weights
    "bf16": ("llama3-8b", {}, ("paged_decode_attention",)),
    "int8": ("llama3-8b-int8", {"kv_quant": "int8"},
             ("paged_decode_attention_quant",)),
    "dense": ("llama3-8b", {"paged": False},
              ("flash_attention", "ragged_decode_attention")),
    "gemma-bf16": ("gemma-7b", {}, ("paged_decode_attention",)),
    "gemma-int8": ("gemma-2b-int8", {"kv_quant": "int8"},
                   ("paged_decode_attention_quant",)),
    "gemma-dense": ("gemma-7b", {"paged": False},
                    ("flash_attention", "ragged_decode_attention")),
    # mixtral: the MoE FFN beside llama's attention shape (32/8 heads,
    # head_dim 128), so B1 and B2 run their llama instances
    "mixtral-int8": ("mixtral-8x7b-int8", {"kv_quant": "int8"},
                     ("paged_decode_attention_quant",)),
    "mixtral-bf16": ("mixtral-8x7b", {}, ("paged_decode_attention",)),
}
# engines brought up serially: a compile-ahead bring-up holds the
# zero-filled storage and the drawn weights until the bind, two copies of
# mixtral's 47 GB against the card's 80 GB
SERIAL = {"mixtral-int8", "mixtral-bf16"}
# depth cut, at full width: mixtral-8x7b's 32 bf16 layers take 93.4 GB
CUT_LAYERS = {"mixtral-bf16": 16}
# the prompts of make_prompts whose greedy tokens a MoE engine's reference
# check reads beside the reference prompt: 600 tokens (five chunks, the
# last padded) and 777, both admitted without a prefix hit
MOE_CHECKED = (0, 4)
# each engine phase's prompts and greedy tokens, which the tp phase of its
# weights holds its own against
SERVED: dict = {}


def make_prompts(vocab: int, seed: int) -> list[list[int]]:
    """Six prompts of 128-1536 tokens. The first two share a 512-token
    prefix; the first is short enough (4 full blocks + 88 tokens) that the
    prefix cache keys exactly that prefix, so the second admission reuses
    it."""
    rng = np.random.default_rng(seed)

    def toks(n):
        return rng.integers(0, vocab, size=n).tolist()

    shared = toks(512)
    return [shared + toks(88), shared + toks(700), toks(128), toks(1536),
            toks(777), toks(1000)]


async def _serve(engine, prompts: list[list[int]], max_new: int):
    """Submit every prompt at once, stream each; returns the token lists,
    submit time, first-token times and end time."""
    t_submit = time.perf_counter()
    reqs = [await engine.generate(p, max_new_tokens=max_new, stream=True)
            for p in prompts]

    async def consume(req):
        toks, t_first = [], None
        while True:
            tok = await req.queue.get()
            if tok is None:
                break
            if t_first is None:
                t_first = time.perf_counter()
            toks.append(tok)
        check(not req.error, f"request {req.request_id} failed: {req.error}")
        return toks, t_first

    outs = await asyncio.gather(*[consume(r) for r in reqs])
    t_end = time.perf_counter()
    return [o[0] for o in outs], t_submit, [o[1] for o in outs], t_end


def reference_logits(engine, prompt: list[int], generated: list[int],
                     n_check: int) -> torch.Tensor:
    """f32 logits [n_check, V]: row i the reference's logits after prompt +
    generated[:i]. A plain no-cache forward of prompt + generated, except
    for a MoE model: there the expert capacity follows each call's token
    count, so the reference makes the paged engine's MoE calls (see
    :func:`moe_reference_logits`)."""
    from tpu9_torch.models.transformer import decoder_forward
    if engine.cfg.n_experts:
        return moe_reference_logits(engine, prompt, generated, n_check)
    seq = prompt + generated[:n_check]
    tokens = torch.tensor([seq], dtype=torch.int64, device=engine.device)
    with torch.no_grad():
        logits = decoder_forward(engine.params, tokens, engine.cfg)[0].float()
    return logits[len(prompt) - 1:len(prompt) - 1 + n_check]


def moe_reference_logits(engine, prompt: list[int], generated: list[int],
                         n_check: int) -> torch.Tensor:
    """The capacity-faithful reference of a paged MoE engine: the prompt
    prefilled at batch 1 in chunks of the engine's chunk length into a
    dense cache (the last chunk padded with token 0, as the engine pads
    it: each MoE call sees the engine's 128 tokens and capacity), then one
    token a decode step (1 token, capacity 8: nothing dropped, as in the
    engine's B=8 steps). The cache's odd length keeps the decode steps on
    the plain attention, so no kernel under test runs here."""
    from tpu9_torch.models.transformer import decoder_forward, init_kv_cache
    cfg, c, dev = engine.cfg, engine.ecfg.prefill_chunk, engine.device
    n = len(prompt)
    n_chunks = -(-n // c)
    cache = init_kv_cache(cfg, 1, (n_chunks * c + n_check) | 1, device=dev)
    toks = torch.zeros((1, n_chunks * c), dtype=torch.int64, device=dev)
    toks[0, :n] = torch.tensor(prompt, dtype=torch.int64)
    rows = []
    with torch.no_grad():
        for i in range(n_chunks):
            pos = torch.arange(i * c, (i + 1) * c, device=dev)[None]
            logits, cache = decoder_forward(
                engine.params, toks[:, i * c:(i + 1) * c], cfg,
                positions=pos, kv_cache=cache, cache_len=(i + 1) * c)
        rows.append(logits[0, n - 1 - (n_chunks - 1) * c])
        for j in range(n_check - 1):
            logits, cache = decoder_forward(
                engine.params,
                torch.tensor([[generated[j]]], dtype=torch.int64, device=dev),
                cfg, positions=torch.tensor([[n + j]], device=dev),
                kv_cache=cache,
                cache_len=torch.tensor([n + j + 1], device=dev), decode=True)
            rows.append(logits[0, 0])
    return torch.stack(rows).float()


def reference_check(engine, prompt: list[int], generated: list[int],
                    n_check: int = 8) -> tuple[float, int]:
    """Hold the engine's greedy tokens (chunked prefill + paged decode
    through the kernel) against the reference of :func:`reference_logits`,
    over the same weights. Both paths round in bf16 at different places,
    and an int8 pool adds the noise of its quantized KV, which the
    reference's dense bf16 KV does not have: so a token passes when it is
    the reference argmax or its reference logit is within 1% of the
    reference logit range of the maximum. Tokens are judged up to and
    including the first one that is not the reference argmax (a fork), as
    ``tests/test_quant_serving.py`` judges forks. Returns the worst
    relative gap and the index of the fork (-1 for none)."""
    logits = reference_logits(engine, prompt, generated, n_check)
    worst = 0.0
    for i in range(n_check):
        row = logits[i]
        gap = float(row.max() - row[generated[i]])
        rel = gap / float(row.max() - row.min())
        worst = max(worst, rel)
        check(rel <= 0.01, f"token {i}: engine chose {generated[i]}, reference "
              f"argmax {int(row.argmax())} (gap {gap:.4f}, {rel:.2%} of range)")
        if generated[i] != int(row.argmax()):
            return worst, i
    return worst, -1


# stats() keys a dense engine does not have (it has no pool)
PAGED_ONLY_STATS = {"kv_blocks_used", "kv_blocks_free", "kv_blocks_reserved",
                    "kv_block_size", "kv_quant", "prefix_cache"}


def stats_contract() -> list[str]:
    """The fields of ``[surface.engine_stats]`` in the reference's wire
    contracts (read as a file: nothing of the JAX package is imported)."""
    import tomllib
    with open(ROOT / "tpu9" / "analysis" / "contracts.toml", "rb") as f:
        return tomllib.load(f)["surface"]["engine_stats"]["fields"]


def check_captured(engine, kind: str) -> None:
    """Every decode window size is a captured CUDA graph; prints warmup's
    capture seconds and the graphs' pool."""
    from tpu9_torch.serving.graphs import CapturedWindow
    g = engine.graphs
    ks = engine.ecfg.decode_steps
    windows = {k: g.compiled.get(("decode", k)) for k in ks}
    check(all(isinstance(w, CapturedWindow) for w in windows.values()),
          f"{kind} engine: decode windows not captured: {windows}")
    check(len(windows) == 3, f"{kind} engine: {len(windows)} window sizes")
    per_k = {k: w.launches for k, w in windows.items()}
    print(f"engine {kind}: captured windows k={list(ks)} in "
          f"{', '.join(f'{g.capture_s[k]:.3f}' for k in ks)} s; graph pool "
          f"{g.pool_bytes / 1e9:.3f} GB reserved; launches counted per "
          f"replay {per_k}")


def check_surface(engine, kind: str, stats: dict) -> None:
    """The runner's view after serving: no post-warmup graph build, the
    contract's stats fields, live device memory, a flight recorder."""
    check(stats["graph_compiles_post_warmup"] == 0,
          f"{kind} engine built {stats['graph_compiles_post_warmup']} "
          f"graphs after warmup")
    missing = [f for f in stats_contract() if f not in stats
               and (engine.paged or f not in PAGED_ONLY_STATS)]
    check(not missing, f"{kind} engine stats lack {missing}")
    check(stats["hbm_used_gb_per_chip"] > 0, f"{kind} engine reports no "
          f"device memory in use")
    check(len(engine.flight_records()) > 0, f"{kind} engine recorded no "
          f"flight")
    print(f"engine {kind}: graph_compiles {stats['graph_compiles']} (post "
          f"warmup {stats['graph_compiles_post_warmup']}); hbm used "
          f"{stats['hbm_used_gb_per_chip']} GB, peak "
          f"{stats['hbm_peak_gb_per_chip']} GB, predicted "
          f"{stats['hbm_predicted_gb_per_chip']} GB, limit "
          f"{stats['hbm_limit_gb_per_chip']} GB; {stats['windows_processed']}"
          f" windows, flight {stats['flight']}; latency {stats['latency']}")


async def cancel_mid_decode(engine, kind: str, prompt: list[int]) -> int:
    """A streaming request cancelled after its second token retires its
    slot well before its budget, and its blocks and reservation return.
    Returns the tokens it got."""
    budget = 512
    req = await engine.generate(prompt, max_new_tokens=budget, stream=True)
    for _ in range(2):
        check(await req.queue.get() is not None, "stream ended early")
    engine.cancel_request(req)
    await asyncio.wait_for(req.done.wait(), 120)
    stats = engine.stats()
    check(len(req.generated) < budget and not req.error,
          f"{kind} engine: cancelled stream got {len(req.generated)} tokens"
          f" ({req.error})")
    check(stats["active_streams"] == 0, f"{kind} engine: slot still live")
    if engine.paged:
        check(stats["kv_blocks_reserved"] == 0,
              f"{kind} engine: {stats['kv_blocks_reserved']} blocks still "
              f"reserved")
    return len(req.generated)


async def profile_hook(engine, kind: str, prompt: list[int]) -> str:
    """``arm_profile(windows=2)`` traces the next two windows of a request
    into ``build/profile/``; returns what the trace holds."""
    out_dir = ROOT / "build" / "profile" / f"hook_{kind}"
    out_dir.mkdir(parents=True, exist_ok=True)
    for old in out_dir.glob("*.json"):
        old.unlink()
    armed = engine.arm_profile(windows=2, out_dir=str(out_dir))
    check(armed["windows"] == 2, f"arm_profile answered {armed}")
    await engine.generate(prompt, max_new_tokens=24)
    # the serve loop stops the trace once it has processed the windows
    for _ in range(1000):
        if not engine.stats()["profile"]["active"]:
            break
        await asyncio.sleep(0.01)
    traces = list(out_dir.glob("*.json"))
    prof = engine.stats()["profile"]
    check(len(traces) == 1 and not prof["error"] and not prof["active"],
          f"{kind} engine: arm_profile wrote {traces}, state {prof}")
    events = json.loads(traces[0].read_text())["traceEvents"]
    kernels = sum(1 for ev in events if ev.get("cat") == "kernel")
    return f"{len(events)} events, {kernels} kernels"


def phase_sampled(engine, card: str) -> None:
    """An engine over the same weights that samples (temperature 0.8, top-k
    50): its captured windows replay draws from the engine's generator, so
    the same window over the same inputs must draw anew on every replay,
    and one prompt served twice must give two different streams."""
    import dataclasses
    from tpu9_torch.serving.engine import InferenceEngine
    ecfg = dataclasses.replace(engine.ecfg, temperature=0.8, top_k=50)
    t0 = time.perf_counter()
    e = InferenceEngine(engine.params, engine.cfg, ecfg, device=DEVICE)
    e.warmup()
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    check_captured(e, "sampled")
    window = e.graphs.decode_k(8)
    draws = []
    for _ in range(3):
        e.last_token.fill_(7)
        e.cache_len.fill_(3)
        window()
        draws.append(e._toks[:8].clone().cpu())
    check(not torch.equal(draws[0], draws[1])
          and not torch.equal(draws[1], draws[2]),
          "a replayed sampled window repeated its draws")
    prompt = list(range(100, 400))

    async def serve():
        await e.start()
        try:
            return [await e.generate(prompt, max_new_tokens=40)
                    for _ in range(2)]
        finally:
            await e.stop()

    a, b = asyncio.run(serve())
    check(len(a) == len(b) == 40 and a != b, "the sampled engine gave the "
          "same stream twice")
    stats = e.stats()
    check(stats["graph_compiles_post_warmup"] == 0, "the sampled engine "
          "built a graph after warmup")
    print(f"engine sampled: temperature 0.8 top_k 50 over the bf16 weights: "
          f"warmup {t_warm:.2f} s; three replays of one window drew "
          f"three different token sets; one prompt twice gave two streams "
          f"({sum(x != y for x, y in zip(a, b))} of 40 tokens differ) "
          f"({card})")
    del e


BRINGUP_KEYS = {"load_s", "compile_ahead_s", "bind_s", "compile_overlap_s"}


def pool_finite(engine) -> bool:
    """No NaN or inf in the engine's floating KV state (pool and its scales,
    or the dense cache, and the paged scratch)."""
    trees = [engine.kv_cache] + ([engine._scratch] if engine.paged else [])
    return all(bool(torch.isfinite(t).all()) for tree in trees
               for t in tree.values() if t.is_floating_point())


def check_bringup(engine, kind: str, preset: str) -> None:
    """The compile-ahead bring-up of ``load_engine(compile_ahead=True)``:
    the reference's four ``bringup`` keys with the overlap inside the
    compile window, one precompile timing for each key the serve loop can
    reach, no NaN or inf written into the KV state by the captures over
    zero-filled weights, and params bit-equal to ``build_params``' draws
    from the same seed."""
    from tpu9_torch.serving import weights as wfmt
    from tpu9_torch.serving.graphs import key_name
    from tpu9_torch.serving.presets import build_params
    b = engine.bringup
    check(set(b) == BRINGUP_KEYS, f"{kind} engine: bringup keys {sorted(b)}")
    check(b["compile_overlap_s"] <= b["compile_ahead_s"], f"{kind} engine: "
          f"overlap {b['compile_overlap_s']} s past the compile window "
          f"{b['compile_ahead_s']} s")
    want = {f"compile_{key_name(k)}_s" for k in engine.graphs.reachable_keys(
        engine._buckets, engine._spec_lens)}
    got = set(engine.compile_ahead_timings)
    check(got == want, f"{kind} engine: precompiled {sorted(got)}, the serve "
          f"loop reaches {sorted(want)}")
    check(pool_finite(engine), f"{kind} engine: the captures over zero "
          f"weights wrote NaN or inf into the KV state")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ref, _ = build_params(preset, seed=0, device=DEVICE)
    have = dict(wfmt.flatten_tree(engine.params)[1])
    for path, t in wfmt.flatten_tree(ref)[1]:
        check(have[path].dtype == t.dtype and torch.equal(have[path], t),
              f"{kind} engine: bound param {path} differs from build_params'")
    del ref, have
    torch.cuda.empty_cache()
    print(f"engine {kind}: compile-ahead bring-up {b}; "
          f"{len(engine.compile_ahead_timings)} computations precompiled in "
          f"{sum(engine.compile_ahead_timings.values()):.3f} s, the key set "
          f"of reachable_keys; params bit-equal to build_params(seed=0); "
          f"KV state finite after the captures; peak memory of the bring-up "
          f"{peak_gb:.2f} GB")


def build_cut(kind: str, preset: str, n_layers: int, knobs: dict):
    """``preset``'s config cut to ``n_layers`` layers at full width, its
    weights drawn on the card from seed 0, served through the engine's
    constructor with the engine config ``load_engine`` gives ``knobs``."""
    import dataclasses
    from tpu9_torch.models.transformer import init_decoder
    from tpu9_torch.ops.quant import init_quantized_decoder, quantized_bytes
    from tpu9_torch.serving.engine import InferenceEngine
    from tpu9_torch.serving.presets import (abstract_params_for,
                                            engine_config, resolve_preset)
    full, quantized = resolve_preset(preset)
    cfg = dataclasses.replace(full, n_layers=n_layers)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(0)
    init = init_quantized_decoder if quantized else init_decoder
    params = init(cfg, gen, torch.device(DEVICE))
    full_gb = quantized_bytes(abstract_params_for(full, quantized)) / 1e9
    total_gb = torch.cuda.get_device_properties(0).total_memory / 1e9
    print(f"engine {kind}: depth cut to {n_layers} of {full.n_layers} layers "
          f"at full width: the {full.n_layers}-layer {preset} weights take "
          f"{full_gb:.2f} GB against the card's {total_gb:.2f} GB")
    return InferenceEngine(params, cfg, engine_config(
        max_batch=8, max_seq_len=2048, **knobs), device=DEVICE)


def check_router_precision(engine, kind: str) -> None:
    """The MoE router's product does not follow the process's f32 matmul
    precision: its logits are the same bits under "highest", "high" and
    "medium" (TF32 and bf16 products), and within f32 rounding of a plain
    f32 product; a plain product under "high" is printed beside them."""
    from tpu9_torch.models.moe import _router_logits
    router = engine.params["layers"][0]["moe"]["router"]
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(5)
    x = torch.randn((128, engine.cfg.dim), generator=gen, device=DEVICE
                    ).to(engine.cfg.dtype)
    was = torch.get_float32_matmul_precision()
    got, plain = {}, {}
    try:
        for prec in ("highest", "high", "medium"):
            torch.set_float32_matmul_precision(prec)
            got[prec] = _router_logits(x, router)
            plain[prec] = x.float() @ router
    finally:
        torch.set_float32_matmul_precision(was)
    check(all(torch.equal(got["highest"], t) for t in got.values()),
          f"{kind} engine: the router logits follow the f32 matmul precision")
    err = float((got["highest"] - plain["highest"]).abs().max())
    tf32 = float((plain["high"] - plain["highest"]).abs().max())
    scale = float(plain["highest"].abs().max())
    check(err <= 1e-5 * scale, f"{kind} engine: router logits {err} from a "
          f"plain f32 product")
    print(f"engine {kind}: router logits identical under f32 matmul "
          f"precision highest, high and medium; {err:.3e} from a plain f32 "
          f"product (max |logit| {scale:.3f}); a plain product under high "
          f"(TF32) moves {tf32:.3e}")


def phase_engine(card: str, kind: str):
    """Serve the six prompts, the repeat and the reference prompt through
    the ``kind`` engine of ``ENGINES``, then check the runner's surface;
    returns (its kernels' launches, the engine). An engine of ``SERIAL``
    comes up without compile-ahead, so the bring-up's own checks (the
    ``bringup`` keys, params bit-equal to a second draw) are skipped; a
    MoE engine's router precision and two more prompts' greedy tokens are
    checked besides."""
    from tpu9_torch.ops.quant import quantized_bytes
    from tpu9_torch.serving.paged_kv import kv_block_bytes
    from tpu9_torch.serving.presets import load_engine

    preset, knobs, path_kernels = ENGINES[kind]
    serial = kind in SERIAL
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if kind in CUT_LAYERS:
        engine = build_cut(kind, preset, CUT_LAYERS[kind], knobs)
    else:
        engine = load_engine(preset, device=DEVICE, max_batch=8,
                             max_seq_len=2048, seed=0,
                             compile_ahead=not serial, **knobs)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    if serial:
        total_gb = torch.cuda.get_device_properties(0).total_memory / 1e9
        w_gb = quantized_bytes(engine.params) / 1e9
        print(f"engine {kind}: brought up serially: compile-ahead holds two "
              f"copies of the weights until the bind, 2 x {w_gb:.2f} GB "
              f"against the card's {total_gb:.2f} GB; the bring-up checks "
              f"are skipped")
    else:
        check_bringup(engine, kind, preset)
    built = engine.graphs.compiles
    t0 = time.perf_counter()
    engine.warmup()
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    check(serial or engine.graphs.compiles == built, f"{kind} engine: warmup "
          f"after precompile built {engine.graphs.compiles - built} "
          f"computations")
    cfg, ecfg = engine.cfg, engine.ecfg
    check(engine.paged == knobs.get("paged", True), f"the {kind} engine has "
          f"paged={engine.paged}")
    if preset.endswith("-int8"):
        check(engine.params["layers"][0]["wq"]["q"].dtype == torch.int8,
              "the int8 preset did not build int8 weights")
        if cfg.n_experts:
            check(engine.params["layers"][0]["moe"]["w_down"]["q"].dtype
                  == torch.int8, "the int8 preset did not build int8 experts")
    if cfg.n_experts:
        check_router_precision(engine, kind)
    if knobs.get("kv_quant") == "int8":
        check(engine.kv_cache["k"].dtype == torch.int8, "the pool is not int8")
        # equal-bytes auto sizing: the bf16 pool's blocks x bf16 block bytes
        # // int8 block bytes, + the trash block
        dense = ecfg.max_batch * ecfg.max_seq_len // ecfg.kv_block_size
        want = (dense * kv_block_bytes(cfg, ecfg.kv_block_size, False)
                // kv_block_bytes(cfg, ecfg.kv_block_size, True) + 1)
        check(engine.pool.n_blocks == want, f"int8 pool has "
              f"{engine.pool.n_blocks} blocks, equal-bytes sizing gives {want}")
    kv_gb = sum(t.numel() * t.element_size() for n, t in
                engine.kv_cache.items() if n != "table") / 1e9
    kv = (f"block {ecfg.kv_block_size} chunk {ecfg.prefill_chunk} pool "
          f"{engine.pool.n_blocks} blocks" if engine.paged else
          f"dense cache {list(engine.kv_cache['k'].shape)} buckets "
          f"{engine._buckets}")
    moe = (f" experts {cfg.n_experts} top-{cfg.moe_top_k} capacity factor "
           f"{cfg.moe_capacity_factor}" if cfg.n_experts else "")
    print(f"engine {kind}: {preset} {cfg.dtype} dim {cfg.dim} layers "
          f"{cfg.n_layers}{moe} heads {cfg.n_heads}/{cfg.n_kv_heads} vocab "
          f"{cfg.vocab_size}; weights {quantized_bytes(engine.params) / 1e9:.2f}"
          f" GB; {kv} ({engine.kv_cache['k'].dtype}, {kv_gb:.2f} GB); load "
          f"{t_load:.2f} s, warmup {t_warm:.2f} s")
    check_captured(engine, kind)
    prompts = make_prompts(cfg.vocab_size, seed=1)
    repeat = prompts[5]
    # prompt + 8 generated = 135 tokens: the no-cache reference takes the
    # plain attention path, none of the kernels under test
    ref_prompt = prompts[2][:127]

    async def main_path():
        await engine.start()
        try:
            steps0 = engine.stats()["decode_steps"]
            for name in KERNELS:
                wrapper(name).launches = 0
            outs, t_submit, t_firsts, t_end = await _serve(engine, prompts,
                                                           MAX_NEW)
            rep_a = await engine.generate(repeat, max_new_tokens=32)
            rep_b = await engine.generate(repeat, max_new_tokens=32)
            ref_out = await engine.generate(ref_prompt, max_new_tokens=8)
            launches = {name: wrapper(name).launches for name in KERNELS}
            steps = engine.stats()["decode_steps"] - steps0
            stats = engine.stats()
            cancelled = await cancel_mid_decode(engine, kind, prompts[4])
            traced = await profile_hook(engine, kind, prompts[2])
        finally:
            await engine.stop()
        return outs, t_submit, t_firsts, t_end, rep_a, rep_b, ref_out, \
            launches, steps, stats, cancelled, traced

    (outs, t_submit, t_firsts, t_end, rep_a, rep_b, ref_out, launches, steps,
     stats, cancelled, traced) = asyncio.run(main_path())
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # the window graphs' pool is reserved but free between replays, so
    # the peak of reserved memory is where it shows
    reserved_gb = torch.cuda.max_memory_reserved() / 1e9

    SERVED[kind] = (prompts, outs)
    for p, out in zip(prompts, outs):
        check(len(out) == MAX_NEW, f"a request returned {len(out)} tokens, "
              f"expected {MAX_NEW}")
        check(all(0 <= t < cfg.vocab_size for t in out), "token id out of range")
    check(rep_a == rep_b, f"repeated greedy prompt differs: {rep_a} vs {rep_b}")
    if engine.paged:
        check(stats["prefix_cache"]["hits"] >= 1, "prefix reuse never ran")
        check(stats["kv_quant"] == knobs.get("kv_quant", ""),
              f"stats report kv_quant {stats['kv_quant']!r}")
    else:
        check("prefix_cache" not in stats, "the dense engine reports a "
              "prefix cache")
    # every prefill of the dense path (all buckets are multiples of 128)
    # runs the flash kernel once per layer; every decode step runs the
    # path's decode kernel once per layer; no other kernel runs
    n_prefills = len(prompts) + 3
    want = {name: 0 for name in KERNELS}
    for name in path_kernels:
        want[name] = cfg.n_layers * (n_prefills if name == "flash_attention"
                                     else steps)
    check(steps > 0, "no decode step ran")
    check(launches == want, f"{kind} engine launches {launches}, expected "
          f"{want} ({cfg.n_layers} layers, {steps} decode steps, "
          f"{n_prefills} prefills)")
    worst, fork = reference_check(engine, ref_prompt, ref_out)
    if cfg.n_experts:
        # longer prompts: several chunks, the last one padded
        for i in MOE_CHECKED:
            w, f = reference_check(engine, prompts[i], outs[i])
            print(f"engine {kind}: the {len(prompts[i])}-token prompt's "
                  f"greedy tokens against the chunked reference: worst gap "
                  f"{w:.3%} of logit range, "
                  f"{'no fork in 8 tokens' if f < 0 else f'fork at {f}'}")
            worst = max(worst, w)

    ttft = sorted(t - t_submit for t in t_firsts)
    n_tokens = sum(len(o) for o in outs)
    decode_tokens = n_tokens - len(outs)
    decode_tps = decode_tokens / (t_end - min(t_firsts))
    print(f"engine {kind}: {len(prompts)} requests, prompt lengths "
          f"{[len(p) for p in prompts]}, {MAX_NEW} new tokens each")
    print(f"engine {kind}: ttft p50 {np.median(ttft):.4f} s, max "
          f"{ttft[-1]:.4f} s; decode {decode_tps:.1f} tokens/s "
          f"({decode_tokens} tokens after the first of each request, from the "
          f"first first-token to the end); all {n_tokens} tokens in "
          f"{t_end - t_submit:.3f} s ({card})")
    cache = (f"prefix cache {stats['prefix_cache']}" if engine.paged
             else "no prefix cache")
    print(f"engine {kind}: peak memory {peak_gb:.2f} GB (reserved "
          f"{reserved_gb:.2f} GB); {cache}; repeat "
          f"identical; reference worst gap {worst:.3%} of logit range, "
          f"{'no fork in 8 tokens' if fork < 0 else f'first fork at token {fork}'}")
    print(f"engine {kind}: launches {launches} ({cfg.n_layers} layers, {steps} "
          f"decode steps, {n_prefills} prefills) ({card})")
    check_surface(engine, kind, stats)
    print(f"engine {kind}: a stream cancelled after 2 tokens stopped at "
          f"{cancelled} of 512 and freed its slot; arm_profile(windows=2) "
          f"wrote a trace of {traced}")
    return {name: launches[name] for name in path_kernels}, engine


# -- after phases 4 and 5: tensor-parallel serving, two ranks on one card ------

TP_TOPOLOGY = "2x1"
TP_RANKS = 2
# a tp=2 rank's heads of llama3-8b (QH 32, KH 8)
TP_HEADS = (LLAMA_HEADS[0] // TP_RANKS, LLAMA_HEADS[1] // TP_RANKS)
# the decode kernels the tp phases run
TP_KERNELS = {"paged_decode_attention", "paged_decode_attention_quant"}
TP_LABEL = "two ranks on one card"


def _entry(w):
    """A dense weight, or an int8 entry's values."""
    return w["q"] if isinstance(w, dict) else w


def check_tp_shards(tp, engine, kind: str) -> str:
    """The rank shards of a tp=2 engine: ``wq`` and ``w_gate`` (column
    parallel) and ``lm_head`` half their columns, ``wo`` and ``w_down``
    (row parallel) half their rows, each rank's pool half the kv heads,
    the table one object on the one card; rank 1's ``wq`` equal to the
    second half of the tp=1 engine's (the same seed's weights)."""
    from tpu9_torch.parallel.sharding import RankParams, ranks
    cfg = tp.cfg
    check(isinstance(tp.params, RankParams) and len(tp.params) == TP_RANKS,
          f"tp {kind}: params are not {TP_RANKS} rank shards")
    q_cols = cfg.n_heads * cfg.head_dim
    full = {"wq": (cfg.dim, q_cols), "wo": (q_cols, cfg.dim),
            "w_gate": (cfg.dim, cfg.hidden_dim),
            "w_down": (cfg.hidden_dim, cfg.dim)}
    for r, shard in enumerate(tp.params):
        layer = shard["layers"][0]
        for name, (rows, cols) in full.items():
            want = ((rows, cols // TP_RANKS) if name in ("wq", "w_gate")
                    else (rows // TP_RANKS, cols))
            got = tuple(_entry(layer[name]).shape)
            check(got == want, f"tp {kind}: rank {r} {name} {got}, want "
                  f"{want}")
        head = tuple(_entry(shard["lm_head"]).shape)
        check(head == (cfg.dim, cfg.vocab_size // TP_RANKS),
              f"tp {kind}: rank {r} lm_head {head}")
    half = q_cols // TP_RANKS
    check(torch.equal(_entry(tp.params[1]["layers"][0]["wq"]),
                      _entry(engine.params["layers"][0]["wq"])[:, half:]),
          f"tp {kind}: rank 1's wq is not the second half of the weights")
    kh = cfg.n_kv_heads // TP_RANKS
    pools = ranks(tp.kv_cache)
    for r, kv in enumerate(pools):
        for name in ("k", "v"):
            check(kv[name].shape[-2] == kh and kv[name].is_contiguous(),
                  f"tp {kind}: rank {r} pool {name} "
                  f"{list(kv[name].shape)}, want {kh} kv heads, contiguous")
        if tp.kv_quant:
            check(kv["k_scale"].shape[-1] == kh, f"tp {kind}: rank {r} "
                  f"scale plane {list(kv['k_scale'].shape)}")
    check(pools[0]["table"] is pools[1]["table"], f"tp {kind}: the ranks on "
          f"one card hold two tables")
    return (f"rank wq {list(_entry(tp.params[0]['layers'][0]['wq']).shape)}, "
            f"wo {list(_entry(tp.params[0]['layers'][0]['wo']).shape)}, "
            f"lm_head {list(_entry(tp.params[0]['lm_head']).shape)}, pool "
            f"{list(pools[0]['k'].shape)} {pools[0]['k'].dtype} a rank")


def reduction_ms(cfg, batch: int) -> float:
    """Device ms of one decode step's reductions alone: ``2 x n_layers``
    sums of two bf16 partials ``[B, 1, dim]`` (``reduce_partials``, one
    after ``wo`` and one after ``w_down`` a layer), captured in one CUDA
    graph and replayed with the device held."""
    from tpu9_torch.parallel.sharding import reduce_partials
    dev = torch.device(DEVICE, torch.cuda.current_device())
    parts = [torch.randn((batch, 1, cfg.dim), device=dev).to(cfg.dtype)
             for _ in range(TP_RANKS)]
    want = (parts[0].float() + parts[1].float()).to(cfg.dtype)
    check(torch.equal(reduce_partials(parts, dev), want), "reduce_partials "
          "is not the f32 sum of the partials rounded once")
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(2 * cfg.n_layers):
            reduce_partials(parts, dev)
    return time_ms(graph.replay, hold=True)


async def cover_streams(tp, engine, prompts: list, wants: list,
                        gots: list) -> list[list[int]]:
    """Hold each tp=2 stream against its tp=1 stream over every token: up
    to its first fork as :func:`judge_resume` judges it (a tie, or the
    phase fails), then the tp=2 engine (running) is resumed on prompt +
    the tp=1 tokens through the fork and its continuation judged the same
    way, fork after fork, until the stream's end; the streams that forked
    resume together. Returns each stream's forks (token indices)."""
    forks: list = [[] for _ in prompts]
    start = [0] * len(prompts)
    gots = list(gots)
    pending = range(len(prompts))
    while pending:
        resume = []
        for i in pending:
            prompt, want = prompts[i], wants[i]
            if judge_resume(engine, prompt + want[:start[i]],
                            want[start[i]:], gots[i]) == "identical":
                continue
            fork = start[i] + next(j for j, (a, b) in enumerate(
                zip(want[start[i]:], gots[i])) if a != b)
            forks[i].append(fork)
            start[i] = fork + 1
            if start[i] < len(want):
                resume.append(i)
        outs = await asyncio.gather(*[
            tp.generate(prompts[i] + wants[i][:start[i]],
                        max_new_tokens=len(wants[i]) - start[i])
            for i in resume])
        for i, out in zip(resume, outs):
            gots[i] = out
        pending = resume
    return forks


def phase_tp(engine, card: str, kind: str) -> dict:
    """Tensor-parallel serving of the ``kind`` engine phase's preset at
    tp=2, both ranks on the one card, against that phase's tp=1 engine
    (``engine``) and its greedy tokens (``SERVED``); the checks are in the
    module docstring. The tp=1 engine is done serving: its window state
    is overwritten by the profile. Returns the kernels' launches."""
    from tpu9_torch.parallel.sharding import ranks
    from tpu9_torch.serving.presets import load_engine
    preset, knobs, path_kernels = ENGINES[kind]
    label = f"tp-{kind}"
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tp = load_engine(preset, topology=TP_TOPOLOGY,
                     devices=[DEVICE] * TP_RANKS, max_batch=8,
                     max_seq_len=2048, seed=0, compile_ahead=True, **knobs)
    built = tp.graphs.compiles
    tp.warmup()
    torch.cuda.synchronize()
    t_up = time.perf_counter() - t0
    check(tp.graphs.compiles == built, f"{label}: warmup after precompile "
          f"built {tp.graphs.compiles - built} computations")
    check(tp.policy.one_device, f"{label}: the ranks are not on one card")
    shards = check_tp_shards(tp, engine, kind)
    check_captured(tp, label)
    cfg = tp.cfg
    prompts, want_outs = SERVED[kind]

    async def serve():
        await tp.start()
        try:
            steps0 = tp.stats()["decode_steps"]
            for name in KERNELS:
                wrapper(name).launches = 0
            outs = (await _serve(tp, prompts, MAX_NEW))[0]
            launches = {name: wrapper(name).launches for name in KERNELS}
            steps = tp.stats()["decode_steps"] - steps0
            forks = await cover_streams(tp, engine, prompts, want_outs, outs)
            return outs, launches, steps, forks
        finally:
            await tp.stop()

    outs, launches, steps, forks = asyncio.run(serve())
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    stats = tp.stats()
    check((stats["topo_tp"], stats["topo_fsdp"], stats["topo_n_chips"])
          == (2, 1, 2), f"{label}: stats topology {stats['topo_tp']}, "
          f"{stats['topo_fsdp']}, {stats['topo_n_chips']}")
    check(stats["graph_compiles_post_warmup"] == 0, f"{label}: "
          f"{stats['graph_compiles_post_warmup']} graphs built after warmup")
    want = {name: 0 for name in KERNELS}
    for name in path_kernels:
        want[name] = cfg.n_layers * TP_RANKS * steps
    check(steps > 0 and launches == want, f"{label}: launches {launches}, "
          f"expected {want} ({cfg.n_layers} layers x {TP_RANKS} ranks x "
          f"{steps} decode steps)")
    compared = [len(out) for out in outs]
    check(compared == [MAX_NEW] * len(prompts), f"{label}: streams of "
          f"{compared} tokens, want {MAX_NEW} each")
    print(f"{label}: {preset} topology {TP_TOPOLOGY} ({TP_LABEL}), "
          f"compile-ahead bring-up and warmup {t_up:.2f} s; {shards}; "
          f"stats topology (2, 1, 2), hbm used "
          f"{stats['hbm_used_gb_per_chip']} GB, predicted "
          f"{stats['hbm_predicted_gb_per_chip']} GB per chip")
    print(f"{label}: {len(prompts)} requests, {MAX_NEW} new tokens each: "
          f"{sum(not f for f in forks)} streams identical to tp=1; tokens "
          f"held against tp=1 a stream {compared}, resumed from each fork: "
          f"forks (token indices, each a tie) {forks}; launches {launches} "
          f"({cfg.n_layers} layers x {TP_RANKS} ranks x {steps} decode "
          f"steps); peak memory {peak_gb:.2f} GB with the tp=1 engine "
          f"alive ({card})")
    out_dir = ROOT / "build" / "profile"
    out_dir.mkdir(parents=True, exist_ok=True)
    b = tp.ecfg.max_batch
    for e, tag in ((engine, "tp=1"), (tp, f"tp=2, {TP_LABEL}")):
        lens = _profile_lanes(e)
        print(f"{label}: decode step, {tag} (B={b}, lengths {lens}):")
        _profile(e.graphs.decode_k(8),
                 f"{kind}_{'tp2' if e is tp else 'tp1'}_decode_step_B{b}", 8,
                 out_dir)
    red = reduction_ms(cfg, b)
    print(f"{label}: the {2 * cfg.n_layers} reductions of one decode step "
          f"(B={b}, [B, 1, {cfg.dim}] {cfg.dtype} partials) take {red:.4f} "
          f"ms of device time alone ({TP_LABEL}) ({card})")
    del tp
    return {name: launches[name] for name in path_kernels}


# -- after phases 4 and 5: the KV cache leaves the card ------------------------

KV_PREFIX = 512                   # tokens of the prefix that moves
KV_HOST_MB = 1024                 # the host tier's budget
KV_NEW = 32                       # tokens of each served prompt
DRAIN_NEW = 128                   # budget of the drained stream
DRAIN_AT = 20                     # tokens read before the drain export
KV_REPS = 5                       # timed repetitions of each motion


def _host_ms(fn, setup=None, reps: int = KV_REPS) -> float:
    """Median host-clock milliseconds of ``fn`` between two device
    synchronizations (``setup`` runs untimed before each call)."""
    times = []
    for _ in range(reps):
        if setup is not None:
            setup()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def judge_resume(engine, prompt: list[int], want: list[int],
                 got: list[int]) -> str:
    """A resumed greedy stream against the uninterrupted one. The resume
    prefills the delivered tokens in a chunk where the uninterrupted
    stream decoded them one by one, so in bf16 the two may round apart:
    they pass when identical, or when at their first fork both tokens are
    within 1% of the logit range of the maximum of a plain no-cache
    forward over the common prefix (a tie, as ``reference_check`` judges
    forks). Tokens past a fork are not compared."""
    from tpu9_torch.models.transformer import decoder_forward
    check(len(got) == len(want), f"resume gave {len(got)} tokens, the "
          f"uninterrupted stream {len(want)}")
    fork = next((i for i, (a, b) in enumerate(zip(want, got)) if a != b), -1)
    if fork < 0:
        return "identical"
    seq = prompt + want[:fork]
    tokens = torch.tensor([seq], dtype=torch.int64, device=engine.device)
    with torch.no_grad():
        row = decoder_forward(engine.params, tokens, engine.cfg)[0, -1].float()
    span = float(row.max() - row.min())
    gaps = [float(row.max() - row[t]) / span for t in (want[fork], got[fork])]
    check(max(gaps) <= 0.01, f"resume forks at token {fork}: "
          f"{got[fork]} against {want[fork]}, gaps {gaps} of the logit range")
    return (f"first fork at token {fork} of {len(want)}, a tie (gaps "
            f"{gaps[0]:.3%} and {gaps[1]:.3%} of the logit range)")


def phase_kv_motion(engine, card: str, kind: str) -> None:
    """The KV cache leaves the card and comes back, on an engine over the
    phase's weights with a host tier armed through ``engine_cfg``:

    1. a prompt with a 512-token prefix is served twice (the second run
       reuses the cached prefix on the device);
    2. ``export_prefix_kv``: the header's geometry and the payload's size;
    3. the entry is dropped and the payload adopted (``adopt_kv``);
    4. the prompt again: the device-prefix run's tokens, one adopted entry,
       one import hit, a prefix hit;
    5. a second export gives the same bytes;
    6. the entry down-pages to host DRAM at an idle boundary, then the
       prompt again: the same tokens, one host hit, one up-page, and the
       same bytes on export;
    7. a stream in flight is exported (``export_request_kv``), adopted,
       and continued from prompt + delivered tokens, against the
       uninterrupted stream (``judge_resume``).

    The path's decode kernel launches ``n_layers x decode steps`` times
    (counts zeroed just before, read just after), the others never; no
    pool tensor changes address and no graph is built after warmup. Then
    export, adopt, down-page and up-page of the prefix are timed beside a
    plain pinned copy of the same bytes in the same direction."""
    import dataclasses
    from tpu9_torch.serving import kvwire
    from tpu9_torch.serving.engine import InferenceEngine
    from tpu9_torch.serving.kvpool import host_planes
    from tpu9_torch.serving.paged_kv import PrefixCache, kv_block_bytes

    path_kernel = ENGINES[kind][2][0]
    cfg = engine.cfg
    ecfg = dataclasses.replace(engine.ecfg, kv_host_pool_mb=KV_HOST_MB)
    t0 = time.perf_counter()
    e = InferenceEngine(engine.params, cfg, ecfg, device=DEVICE)
    e.warmup()
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    check(e.pool.tiered, f"kv {kind}: no host tier with kv_host_pool_mb "
          f"{KV_HOST_MB}")
    bs = ecfg.kv_block_size
    n_blocks = KV_PREFIX // bs
    plane_bytes = n_blocks * kv_block_bytes(cfg, bs, e.kv_quant)
    ptrs = {name: t.data_ptr() for name, t in e.kv_cache.items()}
    rng = np.random.default_rng(11)
    prefix = rng.integers(0, cfg.vocab_size, KV_PREFIX).tolist()
    prompt = prefix + rng.integers(0, cfg.vocab_size, 88).tolist()
    drain_prompt = rng.integers(0, cfg.vocab_size, 500).tolist()
    key = PrefixCache._key(prefix)

    def header_of(payload: bytes) -> dict:
        header, off = kvwire.decode_header(payload)
        check(len(payload) == off + plane_bytes and sum(
            r["nbytes"] for r in header["planes"]) == plane_bytes,
            f"kv {kind}: payload of {len(payload)} bytes, header ends at "
            f"{off}, planes should hold {plane_bytes}")
        return header

    async def main_path():
        await e.start()
        try:
            steps0 = e.stats()["decode_steps"]
            for name in KERNELS:
                wrapper(name).launches = 0
            first = await e.generate(prompt, max_new_tokens=KV_NEW)
            on_device = await e.generate(prompt, max_new_tokens=KV_NEW)
            payload = e.export_prefix_kv(prompt)
            check(payload is not None, f"kv {kind}: nothing to export")
            header = header_of(payload)
            e.prefix_cache.drop(key)
            check(e.adopt_kv(payload), f"kv {kind}: adopt_kv declined")
            adopted = await e.generate(prompt, max_new_tokens=KV_NEW)
            after_adopt = e.stats()
            again = e.export_prefix_kv(prompt)
            entry = e.prefix_cache.acquire_for_export(prompt)
            e.prefix_cache.release_pin(entry)
            check(e.pool.downpage(e._pool_dict(), entry),
                  f"kv {kind}: the down-page was refused")
            check(entry.tier == "host", f"kv {kind}: entry still on device")
            uppaged = await e.generate(prompt, max_new_tokens=KV_NEW)
            after_uppage = e.stats()
            third = e.export_prefix_kv(prompt)
            ref = await e.generate(drain_prompt, max_new_tokens=DRAIN_NEW)
            req = await e.generate(drain_prompt, max_new_tokens=DRAIN_NEW,
                                   request_id="kv-drain", stream=True)
            for _ in range(DRAIN_AT):
                check(await req.queue.get() is not None, "stream ended early")
            drained = e.export_request_kv("kv-drain")
            delivered = list(req.generated)
            e.cancel_request(req)
            await asyncio.wait_for(req.done.wait(), 120)
            check(drained is not None, f"kv {kind}: nothing to drain")
            check(e.adopt_kv(drained), f"kv {kind}: drained adopt declined")
            rest = await e.generate(drain_prompt + delivered,
                                    max_new_tokens=DRAIN_NEW - len(delivered))
            launches = {name: wrapper(name).launches for name in KERNELS}
            steps = e.stats()["decode_steps"] - steps0
        finally:
            await e.stop()
        return (first, on_device, payload, header, adopted, after_adopt,
                again, uppaged, after_uppage, third, ref, drained, delivered,
                rest, launches, steps)

    (first, on_device, payload, header, adopted, after_adopt, again, uppaged,
     after_uppage, third, ref, drained, delivered, rest, launches,
     steps) = asyncio.run(main_path())
    torch.cuda.synchronize()
    want = {name: 0 for name in KERNELS}
    want[path_kernel] = cfg.n_layers * steps
    check(steps > 0 and launches == want, f"kv {kind}: launches {launches}, "
          f"expected {want} ({cfg.n_layers} layers, {steps} decode steps)")
    geo = kvwire.geometry(cfg, ecfg, e.kv_quant)
    check({k: header[k] for k in geo} == geo and header["n_blocks"] ==
          n_blocks and header["n_tokens"] == KV_PREFIX,
          f"kv {kind}: header {header} against geometry {geo}")
    check(adopted == on_device, f"kv {kind}: the adopted prefix served "
          f"{adopted}, the device prefix {on_device}")
    check(after_adopt["prefix_cache"]["adopted"] == 1
          and after_adopt["kvwire_import_hits"] == 1
          and after_adopt["prefix_cache"]["hits"] == 2,
          f"kv {kind}: after the adopt {after_adopt['prefix_cache']}, "
          f"{after_adopt['kvwire_import_hits']} import hits")
    check(again == payload and third == payload, f"kv {kind}: a re-export "
          f"differs from the first export")
    check(uppaged == on_device, f"kv {kind}: the up-paged prefix served "
          f"{uppaged}, the device prefix {on_device}")
    check(after_uppage["kvtier_hits_host"] == 1
          and after_uppage["kvtier_uppages"] == 1
          and after_uppage["kvtier_downpages"] == 0,
          f"kv {kind}: after the up-page hits_host "
          f"{after_uppage['kvtier_hits_host']}, uppages "
          f"{after_uppage['kvtier_uppages']}")
    dh, _ = kvwire.decode_header(drained)
    check(dh["n_tokens"] == (len(drain_prompt) + len(delivered)) // bs * bs,
          f"kv {kind}: drained {dh['n_tokens']} tokens of "
          f"{len(drain_prompt)} + {len(delivered)}")
    resume = judge_resume(e, drain_prompt, ref, delivered + rest)
    stats = e.stats()
    check(stats["graph_compiles_post_warmup"] == 0, f"kv {kind}: "
          f"{stats['graph_compiles_post_warmup']} graphs built after warmup")
    moved = {name: t.data_ptr() for name, t in e.kv_cache.items()}
    check(moved == ptrs, f"kv {kind}: pool tensors moved: {ptrs} -> {moved}")
    print(f"kv {kind}: engine with a {KV_HOST_MB} MB host tier over the "
          f"{cfg.dtype} weights, warmup {t_warm:.2f} s; prefix "
          f"{KV_PREFIX} tokens = {n_blocks} blocks of {bs} = {plane_bytes} "
          f"plane bytes, payload {len(payload)} bytes; first run "
          f"{'equals' if first == on_device else 'differs from'} the "
          f"device-prefix run; adopted, re-exported and up-paged prefixes "
          f"served the device-prefix run's {KV_NEW} tokens; re-exports "
          f"byte-identical; drained stream at {len(delivered)} tokens "
          f"({dh['n_tokens']} tokens shipped), resume {resume}")
    print(f"kv {kind}: launches {launches} ({cfg.n_layers} layers, {steps} "
          f"decode steps); pool addresses unchanged; graph_compiles_post_"
          f"warmup 0; host tier {e.pool.tier_stats()} ({card})")

    # -- timing: the prefix's motion beside a plain pinned copy -------------
    def adopt_again():
        e.prefix_cache.drop(key)

    export_ms = _host_ms(lambda: e.export_prefix_kv(prompt))
    adopt_ms = _host_ms(lambda: check(e.adopt_kv(payload), "adopt declined"),
                        setup=adopt_again)
    pin = DEVICE == "cuda"

    def pinned_bytes() -> np.ndarray:
        stats = torch.cuda.host_memory_stats() if pin else {}
        return np.array([stats.get(f"{k}_bytes.current", 0)
                         for k in ("allocated", "active")])

    down, down_host, up, pinned = [], [], [], []
    for _ in range(KV_REPS):
        entry = e.prefix_cache._entries[key]
        torch.cuda.synchronize()
        before = pinned_bytes()
        t0 = time.perf_counter()
        check(e.pool.downpage(e._pool_dict(), entry), "down-page refused")
        t1 = time.perf_counter()
        host_planes(e.pool.host_tier.peek(key))
        t2 = time.perf_counter()
        down_host.append((t1 - t0) * 1e3)
        down.append((t2 - t0) * 1e3)
        # what the host tier's budget counts, and what the pinned
        # allocator handed out for it (it rounds blocks up)
        pinned.append((e.pool.host_tier.used_bytes,
                       *(int(b) for b in pinned_bytes() - before)))
        hit = e.prefix_cache.lookup(prompt)
        planes = e.pool.uppage_planes(hit)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e.pool.complete_uppage(e._pool_dict(), hit, planes)
        torch.cuda.synchronize()
        up.append((time.perf_counter() - t0) * 1e3)
        e.prefix_cache.release_pin(hit)
    dev = torch.empty(plane_bytes, dtype=torch.uint8, device=DEVICE)
    host = torch.empty(plane_bytes, dtype=torch.uint8, pin_memory=pin)
    d2h_ms = _host_ms(lambda: host.copy_(dev, non_blocking=True))
    h2d_ms = _host_ms(lambda: dev.copy_(host, non_blocking=True))

    def rate(ms: float) -> str:
        return f"{ms:.3f} ms, {plane_bytes / ms / 1e6:.2f} GB/s"

    for op, ms, yard, way in (
            ("export", export_ms, d2h_ms, "device to host"),
            ("adopt", adopt_ms, h2d_ms, "host to device"),
            ("down-page", float(np.median(down)), d2h_ms, "device to host"),
            ("up-page", float(np.median(up)), h2d_ms, "host to device")):
        print(f"kv {kind}: {op} of {KV_PREFIX} tokens ({plane_bytes} bytes): "
              f"{rate(ms)}; pinned copy_ of the same bytes {way} "
              f"{rate(yard)} ({card})")
    print(f"kv {kind}: down-page returns to the serve loop in "
          f"{float(np.median(down_host)):.3f} ms (its copy lands later); "
          f"each down-page: (plane bytes the host tier's "
          f"{e.pool.host_tier.capacity_bytes}-byte budget counts, growth of "
          f"the pinned allocator's allocated and active bytes) {pinned} "
          f"({card})")
    del e, dev, host


# -- after phases 4 to 6: speculative decoding -------------------------------

SPEC_LEN = 8


def spec_prompts(vocab: int, kind: str) -> list[list[int]]:
    """The engine phase's six prompts (the dense phase: two of them) and two
    made of a short segment repeated, which prompt lookup drafts from at
    once."""
    rng = np.random.default_rng(3)
    cyclers = [(rng.integers(0, vocab, 7).tolist() * 40)[:270],
               (rng.integers(0, vocab, 13).tolist() * 20)[:200]]
    prompts = make_prompts(vocab, seed=1)
    return (prompts[2:4] if kind == "dense" else prompts) + cyclers


def _launch_want(kind: str, cfg, steps: int, windows: int,
                 prefills: int) -> dict:
    """Each kernel's launches on the spec engine's path: a paged engine's
    decode kernel once a layer per decode step and once a layer per verify
    window (all B*T rows in one call); the dense engine's ragged kernel
    once a layer per decode step and its flash kernel once a layer per
    prefill (its verify windows take the plain chunk attention)."""
    want = {name: 0 for name in KERNELS}
    for name in ENGINES[kind][2]:
        want[name] = cfg.n_layers * (
            prefills if name == "flash_attention" else
            steps if name == "ragged_decode_attention" else steps + windows)
    return want


def phase_spec(engine, card: str, kind: str):
    """Speculative decoding on the ``kind`` engine's weights: an engine of
    the phase's configuration with ``spec_len=8`` (the default gate) and
    one without, both warmed (the spec engine's verify window must be
    captured), serve the same prompts concurrently, 64 new tokens each.
    Checks: no graph built after warmup; verify windows ran with real
    drafts; the path's kernels launched as ``_launch_want`` says (counts
    zeroed just before the spec engine's requests, read just after); each
    spec-on stream equals the spec-off stream up to its first fork, and a
    fork is a tie (``judge_resume``). Prints the acceptance rate and decode
    tokens/s on against off. Returns the kernels' launches and the spec
    engine."""
    import dataclasses
    from tpu9_torch.serving.engine import InferenceEngine
    from tpu9_torch.serving.graphs import CapturedWindow
    cfg = engine.cfg
    engines = {}
    for label, s_len in (("off", 0), ("on", SPEC_LEN)):
        t0 = time.perf_counter()
        e = InferenceEngine(engine.params, cfg, dataclasses.replace(
            engine.ecfg, spec_len=s_len), device=DEVICE)
        e.warmup()
        torch.cuda.synchronize()
        engines[label] = (e, time.perf_counter() - t0)
    on, off = engines["on"][0], engines["off"][0]
    verify = on.graphs.compiled.get(("verify", SPEC_LEN))
    check(isinstance(verify, CapturedWindow), f"spec {kind}: the verify "
          f"window was not captured: {verify}")
    prompts = spec_prompts(cfg.vocab_size, kind)

    def serve(e, count: bool):
        async def go():
            await e.start()
            try:
                if count:
                    for name in KERNELS:
                        wrapper(name).launches = 0
                out = await _serve(e, prompts, MAX_NEW)
                return out, {name: wrapper(name).launches for name in KERNELS}
            finally:
                await e.stop()
        return asyncio.run(go())

    (want_outs, *off_t), _ = serve(off, False)
    (outs, t_submit, t_firsts, t_end), launches = serve(on, True)
    torch.cuda.synchronize()
    stats, off_stats = on.stats(), off.stats()
    for st, label in ((stats, "on"), (off_stats, "off")):
        check(st["graph_compiles_post_warmup"] == 0, f"spec {kind}: the spec-"
              f"{label} engine built {st['graph_compiles_post_warmup']} graphs "
              f"after warmup")
    check(stats["spec_enabled"] and stats["spec_windows"] > 0
          and stats["spec_proposed"] > 0, f"spec {kind}: no verify window "
          f"with drafts ran: {stats['spec_windows']} windows, "
          f"{stats['spec_proposed']} drafts")
    steps, windows = stats["decode_steps"], stats["spec_windows"]
    want = _launch_want(kind, cfg, steps, windows, len(prompts))
    check(launches == want, f"spec {kind}: launches {launches}, expected "
          f"{want} ({cfg.n_layers} layers, {steps} decode steps, {windows} "
          f"verify windows, {len(prompts)} prefills)")
    judged = [judge_resume(on, p, w, g)
              for p, w, g in zip(prompts, want_outs, outs)]
    forks = sum(j != "identical" for j in judged)

    def decode_tps(outs, t_firsts, t_end):
        return (sum(len(o) for o in outs) - len(outs)) / (t_end - min(t_firsts))

    tps_on = decode_tps(outs, t_firsts, t_end)
    tps_off = decode_tps(want_outs, off_t[1], off_t[2])
    print(f"spec {kind}: spec_len {SPEC_LEN}, gate {on.ecfg.spec_min_accept}; "
          f"warmup on {engines['on'][1]:.2f} s (verify capture "
          f"{on.graphs.capture_s.get(('verify', SPEC_LEN), float('nan')):.3f}"
          f" s), off "
          f"{engines['off'][1]:.2f} s; {len(prompts)} requests, prompt "
          f"lengths {[len(p) for p in prompts]}, {MAX_NEW} new tokens each")
    print(f"spec {kind}: {windows} verify windows, {steps} classic decode "
          f"steps (spec off: {off_stats['decode_steps']}); drafts proposed "
          f"{stats['spec_proposed']}, accepted {stats['spec_accepted']}, "
          f"acceptance rate {stats['spec_acceptance_rate']:.4f}; decode "
          f"{tps_on:.1f} tokens/s spec on against {tps_off:.1f} spec off "
          f"({tps_on / tps_off:.3f}x) ({card})")
    print(f"spec {kind}: launches {launches} ({cfg.n_layers} layers, "
          f"{steps} decode steps, {windows} verify windows, {len(prompts)} "
          f"prefills); streams against spec off: "
          f"{len(prompts) - forks} identical, {forks} forked at a tie: "
          f"{[j for j in judged if j != 'identical']}")
    del engines, off
    return {name: launches[name] for name in ENGINES[kind][2]}, on


# -- after phases 4 and 5: weights leave the card and come back ---------------

RESTORE_CHUNK = 4 << 20            # the worker's snapshot chunk size
RESTORE_NEW = 16                   # greedy tokens served from restored weights
COPY_BYTES = 1 << 30               # the plain pinned copy's buffer


async def _shard_chunks(path: str, index: dict, direct: bool = False):
    """The chunk stream the worker feeds from its cache, read from the
    shard files instead: each file in order, in chunks of the worker's
    size, so a chunk never straddles a file. It yields to the loop after
    each chunk, as a fetch from the cache does, so the consumer of the
    shard before runs meanwhile. ``direct`` reads with ``O_DIRECT`` into
    one page-aligned buffer (the stream copies each chunk out before it
    asks for the next), so the bytes come from the disk whatever the page
    cache holds."""
    for entry in index["leaves"]:
        name = os.path.join(path, entry["file"])
        if direct:
            for off, data in direct_chunks(name, RESTORE_CHUNK):
                yield f"{entry['file']}@{off}", data
                await asyncio.sleep(0)
            continue
        with open(name, "rb", buffering=0) as f:
            off = 0
            while data := f.read(RESTORE_CHUNK):
                yield f"{entry['file']}@{off}", data
                off += len(data)
                await asyncio.sleep(0)


DIRECT_ALIGN = 4096
FS_NAMES = {0xEF53: "ext4", 0x58465342: "xfs", 0x9123683E: "btrfs",
            0x01021994: "tmpfs", 0x858458F6: "ramfs", 0x794C7630: "overlay",
            0x65735546: "fuse", 0x6969: "nfs", 0x01021997: "9p",
            0x2FC12FC1: "zfs"}
MEMORY_FS = ("tmpfs", "ramfs")
LOCAL_FS = ("ext4", "xfs", "btrfs", "zfs")


def direct_chunks(name: str, chunk: int):
    """``(offset, memoryview)`` chunks of a file read with ``O_DIRECT``,
    all through one page-aligned buffer of ``chunk`` bytes (a multiple of
    ``DIRECT_ALIGN``); a short read ends the file."""
    import mmap
    buf = mmap.mmap(-1, chunk)
    fd = os.open(name, os.O_RDONLY | os.O_DIRECT)
    try:
        off = 0
        while n := os.preadv(fd, [buf], off):
            yield off, memoryview(buf)[:n]
            off += n
            if n % DIRECT_ALIGN:
                break
    finally:
        os.close(fd)


def direct_reads_work(name: str) -> bool:
    """Whether this file's filesystem takes ``O_DIRECT`` reads."""
    try:
        next(direct_chunks(name, DIRECT_ALIGN), None)
        return True
    except OSError:
        return False


def fs_type(path: str) -> str:
    """The filesystem under ``path``, from ``statfs``'s magic number."""
    import ctypes
    libc = ctypes.CDLL(None, use_errno=True)
    buf = ctypes.create_string_buffer(256)
    if libc.statfs(os.fsencode(path), buf) != 0:
        return "unknown"
    magic = int.from_bytes(buf.raw[:8], sys.byteorder) & 0xFFFFFFFF
    return FS_NAMES.get(magic, hex(magic))


def page_cache_share(names: list[str]) -> float:
    """The share of these files' pages that sit in the page cache
    (``mincore`` over a read-only map of each, which faults nothing in)."""
    import ctypes
    import mmap
    libc = ctypes.CDLL(None, use_errno=True)
    libc.mmap.restype = ctypes.c_void_p
    libc.mmap.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int,
                          ctypes.c_int, ctypes.c_int, ctypes.c_long]
    libc.munmap.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    libc.mincore.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                             ctypes.c_char_p]
    page = mmap.PAGESIZE
    resident = pages = 0
    for name in names:
        size = os.path.getsize(name)
        if not size:
            continue
        n = (size + page - 1) // page
        fd = os.open(name, os.O_RDONLY)
        try:
            addr = libc.mmap(None, size, mmap.PROT_READ, mmap.MAP_SHARED,
                             fd, 0)
            check(addr not in (None, ctypes.c_void_p(-1).value),
                  f"mmap of {name} failed: errno {ctypes.get_errno()}")
            vec = ctypes.create_string_buffer(n)
            rc = libc.mincore(addr, size, vec)
            libc.munmap(addr, size)
            check(rc == 0, f"mincore of {name} failed: errno "
                  f"{ctypes.get_errno()}")
        finally:
            os.close(fd)
        resident += sum(b & 1 for b in vec.raw)
        pages += n
    return resident / pages if pages else 0.0


def _drop_pages(path: str, index: dict) -> dict:
    """Write each shard back and drop its pages from the page cache (needs
    no root), then say where the next restore's bytes come from; that
    restore reads with ``O_DIRECT`` where the filesystem takes it. The
    label is "cold" on a local block filesystem (``LOCAL_FS``) read with
    ``O_DIRECT`` or with no page left cached: the disk. It is "host" on
    another filesystem read the same way: what serves it (a 9p or FUSE
    host) may hold the bytes in a cache this machine cannot see. Else it
    is "page cache". Returns ``{"label", "direct", "source", "resident",
    "fs"}``."""
    names = [os.path.join(path, e["file"]) for e in index["leaves"]]
    for name in names:
        fd = os.open(name, os.O_RDONLY)
        try:
            os.fsync(fd)
            os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
        finally:
            os.close(fd)
    fs = fs_type(path)
    resident = page_cache_share(names)
    direct = fs not in MEMORY_FS and direct_reads_work(names[0])
    uncached = direct or (fs not in MEMORY_FS and resident < 0.01)
    label = ("page cache" if not uncached else
             "cold" if fs in LOCAL_FS else "host")
    source = f"O_DIRECT on {fs}" if direct else f"buffered reads on {fs}"
    return {"label": label, "direct": direct, "source": source,
            "resident": resident, "fs": fs}


def _stream_restore(path: str, index: dict, direct: bool = False):
    """The port's ``stream_shards`` over the shard files (``O_DIRECT``
    reads with ``direct``), each shard put on the card by
    ``default_device_put``, which waits for its own copies (on its copy
    stream: no device-wide synchronise, so captures on another thread run
    on beside it); returns the tree and the stream's metrics."""
    from tpu9_torch.serving import weights as wfmt
    from tpu9_torch.worker.weightstream import default_device_put, stream_shards
    leaves, st = asyncio.run(stream_shards(
        index["leaves"], _shard_chunks(path, index, direct),
        default_device_put))
    return wfmt.assemble(index, leaves), st


def _check_equal(kind: str, label: str, live, got) -> None:
    """Every leaf of ``got`` on the card and ``torch.equal`` to the live
    param at the same path."""
    from tpu9_torch.serving import weights as wfmt
    want, have = wfmt.flatten_tree(live)[1], wfmt.flatten_tree(got)[1]
    check([k for k, _ in want] == [k for k, _ in have], f"restore {kind} "
          f"{label}: the restored tree's paths differ from the live one's")
    for (key, w), (_, h) in zip(want, have):
        check(h.device == w.device, f"restore {kind} {label}: {key} is on "
              f"{h.device}, not {w.device}")
        check(h.dtype == w.dtype and torch.equal(h, w), f"restore {kind} "
              f"{label}: {key} differs from the live param")


def _pinned_copy_s(total: int) -> float:
    """Seconds of plain pinned ``copy_`` host to device of ``total`` bytes,
    through one pinned buffer of ``COPY_BYTES`` copied again and again."""
    host = torch.empty(COPY_BYTES, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(COPY_BYTES, dtype=torch.uint8, device=DEVICE)
    dev.copy_(host, non_blocking=True)              # warm the path
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for off in range(0, total, COPY_BYTES):
        n = min(COPY_BYTES, total - off)
        dev[:n].copy_(host[:n], non_blocking=True)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _serve_alone(engine, prompt: list[int], count: bool):
    """Serve ``prompt`` alone, ``RESTORE_NEW`` greedy tokens, streamed;
    returns the tokens, the seconds to the first token, the decode steps,
    (with ``count``) the kernels' launches, zeroed just before, and the
    ``perf_counter`` reading at the first token."""
    async def go():
        await engine.start()
        try:
            steps0 = engine.stats()["decode_steps"]
            if count:
                for name in KERNELS:
                    wrapper(name).launches = 0
            t0 = time.perf_counter()
            req = await engine.generate(prompt, max_new_tokens=RESTORE_NEW,
                                        stream=True)
            toks, t_at = [], None
            while (tok := await req.queue.get()) is not None:
                t_at = t_at or time.perf_counter()
                toks.append(tok)
            check(not req.error, f"request failed: {req.error}")
            launches = {name: wrapper(name).launches for name in KERNELS}
            return (toks, t_at - t0, engine.stats()["decode_steps"] - steps0,
                    launches, t_at)
        finally:
            await engine.stop()
    return asyncio.run(go())


def phase_restore(engine, card: str, kind: str) -> dict:
    """The cold-start chain on the ``kind`` engine's weights: save them as
    ``.tpu9w`` shards with the port's ``ckpt.save_params`` (under a
    ``TPU9_WORKDIR`` in ``build/``), restore them through the port's
    ``stream_shards`` and ``default_device_put`` from the page cache and
    then after dropping the shards' pages (labelled by where the bytes
    came from, ``_drop_pages``), load them the runner's way (``ckpt.load_params``
    to host tensors, then to the card), hold every restored leaf
    ``torch.equal`` to the live one, and time two cold starts over the
    shards, each as one wall to the first token after dropping their
    pages, in turns: serial (``_cold_serial``: restore, then an engine
    over the restored tree, warmup, serve) and compile-ahead
    (``_cold_ahead``: the restore beside an engine's precompile, then
    bind, warmup, serve). Each must serve the reference prompt's 16 greedy
    tokens as an engine over the live weights does, build nothing after
    warmup and launch the path's decode kernel ``n_layers x decode
    steps`` times. Prints each step's seconds and GB/s beside a plain
    pinned copy of the same bytes, and each cold start's decomposition.
    Returns the kernels' launches of the compile-ahead cold start."""
    import shutil
    from tpu9_torch.ops.quant import quantized_bytes
    from tpu9_torch.runner import ckpt
    from tpu9_torch.serving import weights as wfmt
    from tpu9_torch.serving.engine import InferenceEngine
    from tpu9_torch.worker.weightstream import default_consumer

    cfg = engine.cfg
    live = engine.params
    total = quantized_bytes(live)
    workdir = ROOT / "build" / f"restore-{kind}"
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    free = shutil.disk_usage(workdir).free
    need = total + (256 << 20)
    print(f"restore {kind}: {total / 1e9:.3f} GB of weights to save; "
          f"{free / 1e9:.1f} GB free under {workdir.parent}")
    check(free >= need, f"restore {kind}: the save needs {need / 1e9:.2f} GB "
          f"free under {workdir.parent}, there are {free / 1e9:.2f} GB")
    env_before = os.environ.get("TPU9_WORKDIR")
    os.environ["TPU9_WORKDIR"] = str(workdir)
    try:
        # 1. save
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = ckpt.save_params(live)
        t_save = time.perf_counter() - t0
        index = wfmt.read_index(path)
        want_v = 2 if kind == "int8" else 1
        check(index["version"] == want_v and index.get("quantized", False)
              == (want_v == 2), f"restore {kind}: index version "
              f"{index['version']}, quantized {index.get('quantized')}")
        check(index["total_bytes"] == total, f"restore {kind}: the index "
              f"holds {index['total_bytes']} bytes, the params {total}")
        print(f"restore {kind}: saved v{index['version']} "
              f"({len(index['leaves'])} shards, quantized "
              f"{index.get('quantized', False)}) in {t_save:.3f} s, "
              f"{total / t_save / 1e9:.3f} GB/s ({card})")
        pinned_s = _pinned_copy_s(total)

        def report(label: str, st: dict) -> None:
            print(f"restore {kind} {label}: stream_shards wall "
                  f"{st['wall_s']:.3f} s, {st['bytes'] / st['wall_s'] / 1e9:.3f}"
                  f" GB/s; fetch_s {st['fetch_s']:.3f}, put_s "
                  f"{st['put_s']:.3f} (blocked on the consumer), consume_s "
                  f"{st['consume_s']:.3f}; pinned ring "
                  f"{default_consumer().pinned_bytes} bytes; a plain pinned "
                  f"copy_ of the same bytes {pinned_s:.3f} s, "
                  f"{total / pinned_s / 1e9:.3f} GB/s ({card})")

        # 2. restore from the page cache
        tree, st = _stream_restore(path, index)
        check(st["bytes"] == total, f"restore {kind}: streamed {st['bytes']}"
              f" bytes of {total}")
        _check_equal(kind, "warm", live, tree)
        report("warm", st)
        del tree
        # 3. restore after dropping the shards' pages
        drop = _drop_pages(path, index)
        label = drop["label"]
        print(f"restore {kind}: after fsync and posix_fadvise(DONTNEED) "
              f"{drop['resident']:.2%} of the shards' pages stay cached on "
              f"{drop['fs']}; the next restore ({label}) reads through "
              f"{drop['source']}")
        tree, cold = _stream_restore(path, index, drop["direct"])
        _check_equal(kind, label, live, tree)
        report(f"{label} through {drop['source']}", cold)
        launches = {}
        # 4. the runner's path: host tensors, then the card
        t0 = time.perf_counter()
        host = ckpt.load_params(mmap=False, device="cpu")
        t_host = time.perf_counter() - t0
        t0 = time.perf_counter()
        moved = ckpt.to_device(host, DEVICE)
        torch.cuda.synchronize()
        t_move = time.perf_counter() - t0
        _check_equal(kind, "runner", live, moved)
        del host, moved
        print(f"restore {kind} runner: ckpt.load_params(mmap=False) "
              f"{t_host:.3f} s ({total / t_host / 1e9:.3f} GB/s), to the card "
              f"{t_move:.3f} s ({total / t_move / 1e9:.3f} GB/s) ({card})")
        del tree
        # 5. the live engine's tokens, which the cold-started engines must
        # serve
        ref_prompt = make_prompts(cfg.vocab_size, seed=1)[2][:127]
        twin = InferenceEngine(live, cfg, engine.ecfg, device=DEVICE)
        twin.warmup()
        want, *_ = _serve_alone(twin, ref_prompt, count=False)
        del twin
        gc.collect()
        torch.cuda.empty_cache()
        # 6. the cold start as one wall each, serial and compile-ahead, in
        # turns (bf16 serial first, int8 compile-ahead first), each over a
        # restore after the shards' pages are dropped
        pair = (_cold_serial, _cold_ahead)
        for run in (pair if kind == "bf16" else pair[::-1]):
            launches[run.__name__] = run(engine, card, kind, path, index,
                                         ref_prompt, want)
    finally:
        if env_before is None:
            os.environ.pop("TPU9_WORKDIR", None)
        else:
            os.environ["TPU9_WORKDIR"] = env_before
        # 6. clean up before the next phase
        shutil.rmtree(workdir, ignore_errors=True)
    return {name: launches["_cold_ahead"][name] for name in ENGINES[kind][2]}


def _check_served(kind: str, label: str, engine, got, want, steps,
                  launches) -> dict:
    """A cold-started engine served the live engine's tokens, built nothing
    after warmup and launched its path's decode kernel ``n_layers x decode
    steps`` times."""
    check(got == want, f"restore {kind} {label}: served {got}, the live "
          f"engine {want}")
    post = engine.stats()["graph_compiles_post_warmup"]
    check(post == 0, f"restore {kind} {label}: {post} graphs built after "
          f"warmup")
    want_l = {name: 0 for name in KERNELS}
    for name in ENGINES[kind][2]:
        want_l[name] = engine.cfg.n_layers * steps
    check(steps > 0 and launches == want_l, f"restore {kind} {label}: "
          f"launches {launches}, expected {want_l}")
    check_captured(engine, f"restore {kind} {label}")
    return launches


def _cold_serial(live, card: str, kind: str, path: str, index: dict,
                 prompt: list[int], want: list[int]) -> dict:
    """The cold start as the port ran it before compile-ahead, one wall
    from the restore's start to the first token: restore the shards after
    dropping their pages, build an engine over them, warm it up (its
    captures), serve."""
    from tpu9_torch.serving.engine import InferenceEngine
    drop = _drop_pages(path, index)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tree, st = _stream_restore(path, index, drop["direct"])
    t_restore = time.perf_counter() - t0
    engine = InferenceEngine(tree, live.cfg, live.ecfg, device=DEVICE)
    engine.warmup()
    got, _, steps, launches, t_at = _serve_alone(engine, prompt, count=True)
    wall = t_at - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    _check_served(kind, "serial", engine, got, want, steps, launches)
    print(f"restore {kind} cold start, serial: {wall:.3f} s to the first "
          f"token ({drop['label']} through {drop['source']}): restore "
          f"{t_restore:.3f} s (stream wall {st['wall_s']:.3f}, fetch_s "
          f"{st['fetch_s']:.3f}, put_s {st['put_s']:.3f}), then build, "
          f"warmup and first token {wall - t_restore:.3f}; peak memory "
          f"{peak_gb:.2f} GB; launches {launches} ({card})")
    del engine, tree
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _cold_ahead(live, card: str, kind: str, path: str, index: dict,
                prompt: list[int], want: list[int]) -> dict:
    """The cold start with compile-ahead, one wall from the engine's
    construction to the first token: an engine on ``params_spec``
    (zero-filled weight storage) precompiles on the calling thread,
    capturing every window, while a thread restores the shards after
    dropping their pages (the sides of ``load_engine(compile_ahead=True)``:
    the captures cost a fresh thread far more CPU, PERF.md §6); then the
    join, ``bind_params`` (every ``data_ptr`` kept), ``warmup`` (nothing
    built) and the first token."""
    import threading

    from tpu9_torch.observability.coldstart import interval_overlap_s
    from tpu9_torch.serving import weights as wfmt
    from tpu9_torch.serving.engine import InferenceEngine
    from tpu9_torch.serving.presets import params_spec
    spec, cfg = params_spec(ENGINES[kind][0])
    drop = _drop_pages(path, index)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = InferenceEngine(spec, cfg, live.ecfg, device=DEVICE)
    ptrs = [t.data_ptr() for _, t in wfmt.flatten_tree(engine.params)[1]]
    loaded: dict = {}

    def restore() -> None:
        try:
            loaded["tree"], loaded["st"] = _stream_restore(path, index,
                                                           drop["direct"])
        finally:
            loaded["end"] = time.monotonic()

    loader = threading.Thread(target=restore, name="tpu9-weight-load")
    r0 = time.monotonic()
    loader.start()
    try:
        c0 = time.monotonic()
        timings = engine.precompile()
        c1 = time.monotonic()
    finally:
        loader.join()
    check("tree" in loaded, f"restore {kind} compile-ahead: the restore "
          f"beside the captures failed")
    r1, st = loaded["end"], loaded["st"]
    tb = time.perf_counter()
    engine.bind_params(loaded.pop("tree"))
    bind_s = time.perf_counter() - tb
    check(ptrs == [t.data_ptr()
                   for _, t in wfmt.flatten_tree(engine.params)[1]],
          f"restore {kind} compile-ahead: bind_params moved a param")
    built = engine.graphs.compiles
    engine.warmup()
    check(engine.graphs.compiles == built, f"restore {kind} compile-ahead: "
          f"warmup built {engine.graphs.compiles - built} computations")
    got, _, steps, launches, t_at = _serve_alone(engine, prompt, count=True)
    wall = t_at - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    _check_served(kind, "compile-ahead", engine, got, want, steps, launches)
    print(f"restore {kind} cold start, compile-ahead: {wall:.3f} s to the "
          f"first token ({drop['label']} through {drop['source']}): restore "
          f"{r1 - r0:.3f} s (stream wall {st['wall_s']:.3f}, fetch_s "
          f"{st['fetch_s']:.3f}, put_s {st['put_s']:.3f}) beside "
          f"compile_ahead_s {c1 - c0:.3f} ({len(timings)} "
          f"computations), compile_overlap_s "
          f"{interval_overlap_s((r0, r1), (c0, c1)):.3f}, bind_s "
          f"{bind_s:.3f}; every data_ptr kept by the bind; peak memory "
          f"{peak_gb:.2f} GB; launches {launches} ({card})")
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# -- phases 12 and 13: training at full width -----------------------------------

LORA_PRESET = "gemma-7b"
LORA_TOKENS = (8, 512)              # examples/05_gemma_lora_v5p64.py's batch
LORA_RANK = 16
# examples/05 trains at 1e-4; on random gemma-7b weights its deltas stay
# under half a bf16 ulp of the merged weights for the first steps, so the
# loss cannot move: the reference's own semantics. 1e-2, as
# tests/test_parallel.py's LoRA test uses, moves them
LORA_LR = 1e-2
FULL_PRESET = "llama-1b"
FULL_TOKENS = (4, 1024)
FULL_LR = 1e-3                      # about 8 bf16 ulps of a 0.02 weight
TRAIN_STEPS = 5                     # the first one is not timed
# the first LoRA step's adapter gradients, kernel path against twin path:
# the kernel's attention output may differ from the twin's by a bf16
# rounding and 2^-9 of the largest v it attends (flash_limit); every
# layer's bf16 activations carry such a difference on at its relative
# size, forward and backward, so the gradients may part by a few of
# those roundings over 28 layers, norm-wise
LORA_GRAD_RTOL = 5e-2
# the first step's loss against a no-grad forward over the same merged
# params: the same kernels on the same weights, so one bf16 rounding of
# the logits (2^-8) bounds it
LORA_LOSS_RTOL = 2.0 ** -8


def train_flops(cfg, batch: int, t: int, lora: bool) -> dict:
    """FLOPs of one checkpointed train step of ``cfg`` on ``batch`` x
    ``t`` tokens, by part: ``forward`` (2 per weight per token, the
    attention's 4 per (q head, dim) of each attended causal pair, the
    head); ``recompute`` (each layer again in the backward, without the
    head); ``dx`` (the activations' gradients: 2 per weight per token, 8
    per (q head, dim, pair) in the attention); ``dw`` (2 per weight per
    token, of the merged attention weights for LoRA, of every weight but
    the embedding's gather for a full step; the head's weight when it is
    not the tied embedding). The adapters' own products and the
    elementwise work are left out."""
    n = batch * t
    q_dim, kv_dim = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    attn_w = 2 * cfg.dim * q_dim + 2 * cfg.dim * kv_dim
    layer_w = attn_w + 3 * cfg.dim * cfg.hidden_dim
    head_w = cfg.vocab_size * cfg.dim
    attn = 4 * cfg.n_heads * cfg.head_dim * batch * t * (t + 1) // 2
    layers = cfg.n_layers * (2 * n * layer_w + attn)
    parts = {"forward": layers + 2 * n * head_w, "recompute": layers,
             "dx": layers + cfg.n_layers * attn + 2 * n * head_w}
    if lora:
        parts["dw"] = cfg.n_layers * 2 * n * attn_w
    else:
        parts["dw"] = (cfg.n_layers * 2 * n * layer_w
                       + (0 if cfg.tie_embeddings else 2 * n * head_w))
    return parts


def _zero_launches() -> None:
    for name in KERNELS:
        wrapper(name).launches = 0


def _launches() -> dict:
    return {name: wrapper(name).launches for name in KERNELS}


def _timed_steps(run, label: str) -> tuple[list[float], list[float]]:
    """``TRAIN_STEPS`` calls of ``run()`` (which returns the step's loss),
    each ended by a synchronize: (losses, step seconds)."""
    losses, secs = [], []
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        loss = run()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(loss))
        check(np.isfinite(losses[-1]), f"{label}: step {i} loss "
              f"{losses[-1]}")
    return losses, secs


def _report_steps(label: str, card: str, cfg, tokens: tuple[int, int],
                  secs: list[float], flops: dict, peak_gb: float,
                  launches: dict, losses: list[float], ranks: int = 1
                  ) -> None:
    """Median step ms over the steps after the first, tokens/s, MFU
    against the bf16 peak with its FLOP count, peak memory, launches (of
    ``ranks`` tp ranks a layer)."""
    step_s = float(np.median(secs[1:]))
    total = sum(flops.values())
    parts = " + ".join(f"{k} {v:.4e}" for k, v in flops.items())
    print(f"{label}: losses {[round(x, 4) for x in losses]}")
    print(f"{label}: step {step_s * 1e3:.1f} ms (median of steps 2-"
          f"{TRAIN_STEPS}; first {secs[0] * 1e3:.1f} ms), "
          f"{tokens[0] * tokens[1] / step_s:.0f} training tokens/s, MFU "
          f"{total / step_s / BF16_FLOP_PER_S:.1%} of {BF16_FLOP_PER_S:.3g} "
          f"FLOP/s bf16 ({total:.4e} FLOP a step = {parts}), peak "
          f"allocated {peak_gb:.2f} GB; B3 launches "
          f"{launches['flash_attention']} = {cfg.n_layers} layers x "
          f"{f'{ranks} ranks x ' if ranks > 1 else ''}2 (forward, recompute) "
          f"x {TRAIN_STEPS} steps, its backward "
          f"{launches['flash_attention_backward']} ({card})")


def _check_train_launches(label: str, cfg, launches: dict, steps: int,
                          ranks: int = 1) -> None:
    """B3 launched ``n_layers x ranks x 2 x steps`` times (each rank's
    forward and recompute a layer) and its backward ``n_layers x ranks x
    steps`` times, no other kernel."""
    want = {name: 0 for name in KERNELS}
    want["flash_attention"] = cfg.n_layers * ranks * 2 * steps
    want["flash_attention_backward"] = cfg.n_layers * ranks * steps
    check(launches == want, f"{label}: launches {launches}, expected {want}")


def _twin_attention(q, k, v, causal=True, kv_offset=0):
    """The decoder's attention with every shape on the twin: autograd
    differentiates it, no kernel runs."""
    from tpu9_torch.ops import attention as at
    return at.xla_attention(q, k, v, causal=causal, kv_offset=kv_offset)


def phase_train_lora(card: str) -> dict:
    """gemma-7b at full width and depth, LoRA of rank 16 on wq, wk, wv and
    wo (``examples/05``'s shapes: tokens (8, 512), ``lora_scale(16)``,
    adamw), remat on, through ``build_lora_train_step``. Before the steps:
    the adapter gradients through the kernel path against the twin path.
    Then ``TRAIN_STEPS`` steps on one repeated batch: the first step's loss
    against ``causal_lm_loss`` of a no-grad forward over the same merged
    params, every ``b`` off zero after it, every loss finite and the last
    under the first; B3 launched ``n_layers x 2 x steps`` times (forward
    and recompute) and no other kernel. One more step is profiled. Returns
    the steps' launches."""
    from tpu9_torch.models import lora, transformer
    from tpu9_torch.models.transformer import decoder_forward, init_decoder
    from tpu9_torch.serving.presets import PRESETS
    from tpu9_torch.train import build_lora_train_step, causal_lm_loss, optim
    from tpu9_torch.train.trainer import lora_value_and_grad

    label = f"train lora {LORA_PRESET}"
    cfg = PRESETS[LORA_PRESET]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(0)
    base = init_decoder(cfg, gen, DEVICE)
    adapters = lora.init_lora(gen, base, rank=LORA_RANK)
    tokens = torch.randint(0, cfg.vocab_size, LORA_TOKENS, generator=gen,
                           device=DEVICE, dtype=torch.int32)
    scale = lora.lora_scale(LORA_RANK)
    torch.cuda.synchronize()
    w_gb = sum(x.numel() * x.element_size()
               for x in optim.tree_leaves(base)) / 1e9
    print(f"{label}: {cfg.n_layers} layers, dim {cfg.dim}, heads "
          f"{cfg.n_heads}/{cfg.n_kv_heads} of {cfg.head_dim}, vocab "
          f"{cfg.vocab_size}: {w_gb:.2f} GB of {cfg.dtype} weights drawn in "
          f"{time.perf_counter() - t0:.2f} s; rank {LORA_RANK}, "
          f"{lora.trainable_count(adapters)} trainable, scale {scale}, "
          f"tokens {LORA_TOKENS}, adamw lr {LORA_LR}")

    with torch.no_grad():
        ref_loss = float(causal_lm_loss(decoder_forward(
            lora.merge(base, adapters, scale), tokens, cfg), tokens))

    # the first step's gradients, kernel path against twin path
    value_and_grad = lora_value_and_grad(cfg, scale, remat=True)
    _zero_launches()
    loss_k, grads_k = value_and_grad(adapters, base, tokens)
    torch.cuda.synchronize()
    check(_launches()["flash_attention"] == 2 * cfg.n_layers
          and _launches()["flash_attention_backward"] == cfg.n_layers,
          f"{label}: the gradient's forward, recompute and backward launched "
          f"{_launches()} (want {2 * cfg.n_layers} flash, {cfg.n_layers} "
          f"backward)")
    was = transformer.attention
    transformer.attention = _twin_attention
    try:
        loss_t, grads_t = value_and_grad(adapters, base, tokens)
    finally:
        transformer.attention = was
    gk, gt = optim.tree_leaves(grads_k), optim.tree_leaves(grads_t)
    diff = torch.sqrt(sum(((a - b) ** 2).sum() for a, b in zip(gk, gt)))
    rel = float(diff / optim.global_norm(grads_t))
    print(f"{label}: first-step adapter gradients, kernel path against the "
          f"twin path (remat on both: off, 28 layers of saved activations "
          f"and the twin's f32 scores would not fit beside the weights): "
          f"norm-wise {rel:.3e} (tolerance {LORA_GRAD_RTOL}); losses "
          f"{float(loss_k):.6f} and {float(loss_t):.6f}")
    check(rel <= LORA_GRAD_RTOL, f"{label}: kernel-path gradients part from "
          f"the twin path's by {rel:.3e}")
    del grads_k, grads_t, gk, gt

    opt = optim.adamw(LORA_LR)
    opt_state = opt.init(adapters)
    step = build_lora_train_step(cfg, opt, scale=scale, device=DEVICE)
    state = {"adapters": adapters, "opt": opt_state}
    moved = []

    def run():
        state["adapters"], state["opt"], metrics = step(
            state["adapters"], state["opt"], base, tokens)
        if not moved:
            moved.append(all(bool(entry["b"].any())
                             for layer in state["adapters"]["layers"]
                             for entry in layer.values()))
        return metrics["loss"]

    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    losses, secs = _timed_steps(run, label)
    launches = _launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    _check_train_launches(label, cfg, launches, TRAIN_STEPS)
    gap = abs(losses[0] - ref_loss)
    print(f"{label}: first step's loss {losses[0]:.6f} against a no-grad "
          f"forward's {ref_loss:.6f}: gap {gap:.3e} (tolerance "
          f"{LORA_LOSS_RTOL:.3e} x loss); every b off zero after step 1: "
          f"{moved[0]}")
    check(gap <= LORA_LOSS_RTOL * abs(ref_loss), f"{label}: the step's loss "
          f"{losses[0]} is not the forward's {ref_loss}")
    check(moved[0], f"{label}: some b stayed zero after the first step")
    check(losses[-1] < losses[0], f"{label}: the loss did not fall on a "
          f"repeated batch: {losses}")
    _report_steps(label, card, cfg, LORA_TOKENS, secs,
                  train_flops(cfg, *LORA_TOKENS, lora=True), peak_gb,
                  launches, losses)
    out_dir = ROOT / "build" / "profile"
    out_dir.mkdir(parents=True, exist_ok=True)
    _profile(lambda: step(state["adapters"], state["opt"], base, tokens),
             f"train_lora_{LORA_PRESET}_step", 1, out_dir)
    return launches


def phase_train_full(card: str) -> dict:
    """llama-1b at full width and depth (head_dim 64), every parameter
    trained: ``build_train_step`` with adam, remat on, tokens (4, 1024),
    ``TRAIN_STEPS`` steps on one repeated batch: every loss finite and the
    last under the first, B3 launched ``n_layers x 2 x steps`` times.
    Returns the steps' launches."""
    from tpu9_torch.models.transformer import init_decoder
    from tpu9_torch.serving.presets import PRESETS
    from tpu9_torch.train import build_train_step, optim
    from tpu9_torch.train.trainer import init_train_state

    label = f"train full {FULL_PRESET}"
    cfg = PRESETS[FULL_PRESET]
    torch.cuda.empty_cache()
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(0)
    opt = optim.adam(FULL_LR)
    state = {"s": init_train_state(init_decoder(cfg, gen, DEVICE), opt)}
    tokens = torch.randint(0, cfg.vocab_size, FULL_TOKENS, generator=gen,
                           device=DEVICE, dtype=torch.int32)
    step = build_train_step(cfg, opt, device=DEVICE)
    n_params = sum(x.numel() for x in optim.tree_leaves(state["s"].params))
    print(f"{label}: {cfg.n_layers} layers, dim {cfg.dim}, heads "
          f"{cfg.n_heads}/{cfg.n_kv_heads} of {cfg.head_dim}, {n_params} "
          f"params ({cfg.dtype}; adam moments in the params' dtypes), "
          f"tokens {FULL_TOKENS}, adam lr {FULL_LR}")
    norms = []

    def run():
        state["s"], metrics = step(state["s"], tokens)
        norms.append(float(metrics["grad_norm"]))
        return metrics["loss"]

    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    losses, secs = _timed_steps(run, label)
    launches = _launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    _check_train_launches(label, cfg, launches, TRAIN_STEPS)
    check(all(np.isfinite(norms)), f"{label}: grad norms {norms}")
    check(losses[-1] < losses[0], f"{label}: the loss did not fall on a "
          f"repeated batch: {losses}")
    print(f"{label}: grad norms {[round(x, 4) for x in norms]}")
    _report_steps(label, card, cfg, FULL_TOKENS, secs,
                  train_flops(cfg, *FULL_TOKENS, lora=False), peak_gb,
                  launches, losses)
    return launches


TRAIN_PHASES = {"lora": phase_train_lora, "full": phase_train_full}


# -- phases 14 to 18: the parallel layer and the sharded train steps -----------

# examples/05's mesh at tp=4 (make_mesh(fsdp=n // 4, tp=4)), its 8 ranks on
# one card; test_fsdp_train_step_loss_decreases's mesh for the full step
LORA_MESH = dict(dp=1, fsdp=2, sp=1, tp=4)
FULL_MESH = dict(dp=2, fsdp=2, sp=1, tp=2)
# A sharded step against the unsharded step from the same state (the same
# draws, and each step's state handed to both): each tp reduction adds the
# ranks' bf16 partials in f32 and rounds once, where one GEMM rounds its
# f32 sum once, so a block's output may move by one bf16 rounding of its
# partials (2^-8 relative) more than the unsharded step's. The loss, a mean
# over 4088 or 4092 targets of f32 log-softmaxes, averages those roundings
# out: one 2^-8 of the loss bounds it. The gradients carry such roundings
# as the kernel path's carry against the twin path's (``LORA_GRAD_RTOL``,
# norm-wise), and so does their norm. Two trajectories run apart on their
# own are not compared step by step: Adam at these rates moves every entry
# by about lr whatever its gradient's size, so an entry whose gradient
# sits near zero can step the other way, and on random weights the losses
# then part chaotically (on an H100 80GB HBM3 at 700 W, llama-1b's grad
# norms ran 11% apart by step 5, with every step from a shared state
# within 7e-4).
SHARD_LOSS_RTOL = 2.0 ** -8
RING_SHAPE = (1, 8192, 4, 128)      # B, T, H, D: the dense scores 1.07 GB f32
RING_SP = 8
RING_ATOL = 2e-5                    # tests/test_parallel.py's, f32
PIPE_DIM, PIPE_LAYERS, PIPE_STAGES = 2048, 8, 4
PIPE_X = (8, 256)                   # batch, rows a sample
PIPE_MICROBATCHES = (4, 8)
# pipeline against the sequential program, f32 under "highest": the same
# products on fewer rows a GEMM, which the card may sum in other orders.
# One f32 sum of dim terms in another order moves its result by about
# sqrt(dim) roundings (2^-24) of the largest term; the output goes through
# 2 products a layer, a gradient back through about 4 (the forward's and
# the backward's), so max |err| <= 4 x layers x sqrt(dim) x 2^-24 of the
# largest entry (8.6e-5). The reference test's own 1e-5 was set at dim 16,
# where a sum has 16 terms: at dim 2048 on an H100 80GB HBM3 at 700 W the
# output's gap was 2.003e-5 (1.6e-6 of its largest entry)
PIPE_TOL = 4 * PIPE_LAYERS * PIPE_DIM ** 0.5 * 2.0 ** -24
MOE_TRAIN_CFG = dict(dim=4096, hidden_dim=14336, n_experts=8, top_k=2)
MOE_TRAIN_X = (2, 256)              # 512 tokens: capacity 160 an expert
MOE_TRAIN_EP = 4
MOE_TRAIN_STEPS = 8
MOE_TRAIN_LR = 1e-3                 # about 16 bf16 ulps of a 0.01 weight
# ep=4 against ep=1: each token's two slots add in f32 with exact zeros
# from the ranks that do not hold them, so the forward is the unsharded
# one's where the per-expert GEMMs are; the card's batched GEMMs over 2 or
# 8 experts may round differently, one bf16 rounding (2^-8) of an expert's
# output, which the loss averages out; Adam's steps on near-zero gradients
# may part later as in the train steps
MOE_LOSS_RTOL = 2.0 ** -6


def _zero_launch_phase(label: str, launches: dict) -> None:
    want = {name: 0 for name in KERNELS}
    check(launches == want, f"{label}: launches {launches}, expected none "
          f"(plain torch ops)")


def _pass_ms(cfg, params, batch: int, t: int) -> tuple[float, float]:
    """Device ms of one pass's fsdp gathers (every rank's pieces of every
    layer joined on its device) and of its reductions (``2 x n_layers``
    sums of the ranks' ``[B, T, dim]`` partials onto rank 0's device), each
    timed alone with CUDA events. A remat step runs each twice (the
    forward and the backward's recompute)."""
    from tpu9_torch.parallel.sharding import gather_leaf, reduce_partials
    devs = params.devices

    def gathers():
        for i in range(cfg.n_layers):
            for shard, dev in zip(params, devs):
                for leaf in shard["layers"][i].values():
                    gather_leaf(leaf, dev)

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(1)
    parts = [torch.randn((batch, t, cfg.dim), generator=gen, device=DEVICE
                         ).to(cfg.dtype) for _ in devs]

    def reductions():
        for _ in range(2 * cfg.n_layers):
            reduce_partials(parts, devs[0])

    return time_ms(gathers, iters=5), time_ms(reductions, iters=5)


def _whole_leaves(tree) -> list:
    """A tree's leaves in sorted-key order, each sharded leaf's pieces
    joined on the card."""
    from tpu9_torch.parallel.sharding import Pieces, gather_leaf
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _whole_leaves(tree[k])]
    if isinstance(tree, list) and not isinstance(tree, Pieces):
        return [x for v in tree for x in _whole_leaves(v)]
    return [gather_leaf(tree, DEVICE)]


def _check_pairs(label: str, what: str, pairs: list, rtol: float) -> None:
    """``pairs`` of (sharded, unsharded) values, one a step, each from the
    same state: within ``rtol`` of the unsharded value."""
    gaps = [abs(a - b) / abs(b) for a, b in pairs]
    print(f"{label}: {what} a step, sharded against unsharded from the same "
          f"state: {[(round(a, 6), round(b, 6)) for a, b in pairs]}, relative "
          f"gaps {[f'{g:.2e}' for g in gaps]} (tolerance {rtol:.3e})")
    check(max(gaps) <= rtol, f"{label}: sharded {what} part from the "
          f"unsharded step's by {gaps}")


def phase_train_lora_fsdp(card: str) -> dict:
    """``examples/05``'s step on its mesh: gemma-7b at full width and depth,
    the base by ``decoder_param_specs`` and rank-16 adapters by
    ``fsdp_specs(min_size=1)`` on ``make_mesh(dp=1, fsdp=2, sp=1, tp=4,
    devices=[DEVICE] * 8)``, adamw, remat on, tokens (8, 512), the same
    draws as the unsharded LoRA phase (seed 0). The first step's adapter
    gradients against the unsharded kernel path's, norm-wise; then
    ``TRAIN_STEPS`` steps each run sharded and unsharded from the unsharded
    trajectory's state (adapters and adamw state sharded anew), the losses
    compared step by step. Then the full tree is freed and the sharded run
    goes on its own, timed: the loss falling, B3 launched ``n_layers x 4
    ranks x 2 x steps`` times and no other kernel; step ms, peak memory,
    one profiled step (busy, idle), one pass's gathers and reductions
    timed alone."""
    from tpu9_torch.models import lora
    from tpu9_torch.models.transformer import init_decoder
    from tpu9_torch.parallel import (decoder_param_specs, fsdp_specs,
                                     make_mesh, shard_params)
    from tpu9_torch.serving.presets import PRESETS
    from tpu9_torch.train import build_lora_train_step, optim
    from tpu9_torch.train.trainer import lora_value_and_grad

    label = f"train lora-fsdp {LORA_PRESET}"
    cfg = PRESETS[LORA_PRESET]
    ranks = LORA_MESH["tp"]
    torch.cuda.empty_cache()
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(0)
    base = init_decoder(cfg, gen, DEVICE)
    adapters = lora.init_lora(gen, base, rank=LORA_RANK)
    tokens = torch.randint(0, cfg.vocab_size, LORA_TOKENS, generator=gen,
                           device=DEVICE, dtype=torch.int32)
    scale = lora.lora_scale(LORA_RANK)
    mesh = make_mesh(**LORA_MESH, devices=[DEVICE] * 8)
    t0 = time.perf_counter()
    base_s = shard_params(base, mesh, decoder_param_specs(base))
    torch.cuda.synchronize()
    wq = base_s[0]["layers"][0]["wq"]
    print(f"{label}: mesh {mesh.shape} on one card ({card}): {len(base_s)} "
          f"tp ranks of {base_s.layout.resolve(cfg).q_heads} q heads, fsdp "
          f"pieces {[tuple(p.shape) for p in wq]} of a rank's wq; sharded in "
          f"{time.perf_counter() - t0:.2f} s")

    def sharded(tree):
        return shard_params(tree, mesh, fsdp_specs(tree, min_size=1))

    opt = optim.adamw(LORA_LR)
    step = build_lora_train_step(cfg, opt, scale=scale, device=DEVICE)
    with mesh:
        value_and_grad = lora_value_and_grad(cfg, scale, remat=True)
        _zero_launches()
        _, grads_s = value_and_grad(sharded(adapters), base_s, tokens)
        torch.cuda.synchronize()
        check(_launches()["flash_attention"] == 2 * cfg.n_layers * ranks
              and _launches()["flash_attention_backward"]
              == cfg.n_layers * ranks,
              f"{label}: the gradient's forward, recompute and backward "
              f"launched {_launches()}")
        _, grads_u = value_and_grad(adapters, base, tokens)
        got, want = _whole_leaves(grads_s), _whole_leaves(grads_u)
        diff = torch.sqrt(sum(((a - b) ** 2).sum() for a, b in zip(got, want)))
        rel = float(diff / torch.sqrt(sum((b ** 2).sum() for b in want)))
        print(f"{label}: first-step adapter gradients against the unsharded "
              f"kernel path's (same draws): norm-wise {rel:.3e} (tolerance "
              f"{LORA_GRAD_RTOL})")
        check(rel <= LORA_GRAD_RTOL, f"{label}: sharded gradients part from "
              f"the unsharded ones by {rel:.3e}")
        del grads_s, grads_u, got, want
        ad, st, pairs, unsharded = adapters, opt.init(adapters), [], []
        for _ in range(TRAIN_STEPS):
            loss_s = step(sharded(ad), sharded(st), base_s, tokens)[2]["loss"]
            ad, st, m_u = step(ad, st, base, tokens)
            pairs.append((float(loss_s), float(m_u["loss"])))
            unsharded.append(pairs[-1][1])
        _check_pairs(label, "loss", pairs, SHARD_LOSS_RTOL)
    del base, ad, st, m_u
    gc.collect()
    torch.cuda.empty_cache()
    print(f"{label}: {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated "
          f"once the full tree is freed")

    state = {"adapters": sharded(adapters)}
    state["opt"] = opt.init(state["adapters"])

    def run():
        state["adapters"], state["opt"], metrics = step(
            state["adapters"], state["opt"], base_s, tokens)
        return metrics["loss"]

    with mesh:
        torch.cuda.reset_peak_memory_stats()
        _zero_launches()
        losses, secs = _timed_steps(run, label)
        launches = _launches()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        _check_train_launches(label, cfg, launches, TRAIN_STEPS, ranks)
        print(f"{label}: the sharded run on its own: losses "
              f"{[round(x, 6) for x in losses]}, the unsharded run's "
              f"{[round(x, 6) for x in unsharded]}")
        check(losses[-1] < losses[0], f"{label}: the loss did not fall on a "
              f"repeated batch: {losses}")
        _report_steps(label, card, cfg, LORA_TOKENS, secs,
                      train_flops(cfg, *LORA_TOKENS, lora=True), peak_gb,
                      launches, losses, ranks)
        gathers, reductions = _pass_ms(cfg, base_s, *LORA_TOKENS)
        print(f"{label}: one pass's fsdp gathers {gathers:.3f} ms and "
              f"{2 * cfg.n_layers} reductions {reductions:.3f} ms, device "
              f"alone (a remat step runs each twice: forward and recompute; "
              f"{ranks} ranks on one card)")
        out_dir = ROOT / "build" / "profile"
        out_dir.mkdir(parents=True, exist_ok=True)
        _profile(lambda: step(state["adapters"], state["opt"], base_s,
                              tokens),
                 f"train_lora_fsdp_{LORA_PRESET}_step", 1, out_dir)
    return launches


def phase_train_full_fsdp(card: str) -> dict:
    """``test_fsdp_train_step_loss_decreases``'s mesh (dp=2, fsdp=2, tp=2,
    on one card) at the unsharded full phase's shape: llama-1b at full
    width and depth, every parameter, adam, tokens (4, 1024), the same
    draws (seed 0). ``TRAIN_STEPS`` steps each run sharded and unsharded
    from the unsharded trajectory's state (params and adam state sharded
    anew): the losses and grad norms step by step. Then a sharded run on
    its own from ``init_train_state(params, opt, mesh, specs)``, timed: the
    loss falling, B3 launched ``n_layers x 2 ranks x 2 x steps`` times."""
    from tpu9_torch.models.transformer import init_decoder
    from tpu9_torch.parallel import (decoder_param_specs, make_mesh,
                                     shard_params)
    from tpu9_torch.serving.presets import PRESETS
    from tpu9_torch.train import TrainState, build_train_step, optim
    from tpu9_torch.train.trainer import init_train_state

    label = f"train full-fsdp {FULL_PRESET}"
    cfg = PRESETS[FULL_PRESET]
    ranks = FULL_MESH["tp"]
    torch.cuda.empty_cache()
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(0)
    opt = optim.adam(FULL_LR)
    params = init_decoder(cfg, gen, DEVICE)
    tokens = torch.randint(0, cfg.vocab_size, FULL_TOKENS, generator=gen,
                           device=DEVICE, dtype=torch.int32)
    mesh = make_mesh(**FULL_MESH, devices=[DEVICE] * 8)
    specs = decoder_param_specs(params)
    step = build_train_step(cfg, opt, device=DEVICE)
    print(f"{label}: mesh {mesh.shape} on one card ({card}), {ranks} tp "
          f"ranks; tokens {FULL_TOKENS}, adam lr {FULL_LR}; the batch stays "
          f"whole (dp adds no rows)")

    def sharded(state):
        mu, nu = (shard_params(t, mesh, specs)
                  for t in (state.opt_state.mu, state.opt_state.nu))
        return TrainState(params=shard_params(state.params, mesh, specs),
                          opt_state=state.opt_state._replace(mu=mu, nu=nu),
                          step=state.step)

    with mesh:
        state_u, losses_p, norms_p, unsharded = (
            init_train_state(params, opt), [], [], [])
        for _ in range(TRAIN_STEPS):
            m_s = step(sharded(state_u), tokens)[1]
            state_u, m_u = step(state_u, tokens)
            losses_p.append((float(m_s["loss"]), float(m_u["loss"])))
            norms_p.append((float(m_s["grad_norm"]), float(m_u["grad_norm"])))
            unsharded.append(losses_p[-1][1])
        _check_pairs(label, "loss", losses_p, SHARD_LOSS_RTOL)
        _check_pairs(label, "grad norm", norms_p, LORA_GRAD_RTOL)
        del state_u, m_s, m_u
        state = {"s": init_train_state(params, opt, mesh, specs)}
        del params
        gc.collect()
        torch.cuda.empty_cache()
        norms = []

        def run():
            state["s"], metrics = step(state["s"], tokens)
            norms.append(float(metrics["grad_norm"]))
            return metrics["loss"]

        torch.cuda.reset_peak_memory_stats()
        _zero_launches()
        losses, secs = _timed_steps(run, label)
        launches = _launches()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
    _check_train_launches(label, cfg, launches, TRAIN_STEPS, ranks)
    print(f"{label}: the sharded run on its own: losses "
          f"{[round(x, 6) for x in losses]} (the unsharded run's "
          f"{[round(x, 6) for x in unsharded]}), grad norms "
          f"{[round(x, 4) for x in norms]}")
    check(all(np.isfinite(norms)), f"{label}: grad norms {norms}")
    check(losses[-1] < losses[0], f"{label}: the loss did not fall on a "
          f"repeated batch: {losses}")
    _report_steps(label, card, cfg, FULL_TOKENS, secs,
                  train_flops(cfg, *FULL_TOKENS, lora=False), peak_gb,
                  launches, losses, ranks)
    return launches


def _peak_delta_gb(fn):
    """``fn()``'s result and the peak device memory it allocated beyond
    what was allocated before it, GB."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    return out, (torch.cuda.max_memory_allocated() - before) / 1e9


def phase_ring(card: str) -> dict:
    """Ring attention on ``sp=8`` ranks on one card, B=1, T=8192, H=4,
    D=128, f32, causal and full, against the port's plain dense f32
    attention (the flash kernel's twin) on the same inputs (``RING_ATOL``,
    the reference test's): the max abs gap, both peak-memory deltas (the
    dense scores are ``B*H*T*T`` f32; a ring block's ``(T/8)^2``) and
    both times."""
    from tpu9_torch.ops.attention import xla_attention
    from tpu9_torch.parallel import make_mesh, ring_attention

    label = "ring"
    _check_precision(label)
    b, t, h, d = RING_SHAPE
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(2)
    q, k, v = (torch.randn(RING_SHAPE, generator=gen, device=DEVICE)
               for _ in range(3))
    mesh = make_mesh(sp=RING_SP, devices=[DEVICE] * RING_SP)
    _zero_launches()
    for causal in (True, False):
        ring, ring_gb = _peak_delta_gb(
            lambda: ring_attention(q, k, v, mesh, axis="sp", causal=causal))
        dense, dense_gb = _peak_delta_gb(
            lambda: xla_attention(q, k, v, causal=causal))
        err = float((ring - dense).abs().max())
        del ring, dense
        ring_ms = time_ms(lambda: ring_attention(q, k, v, mesh, causal=causal),
                          iters=5)
        dense_ms = time_ms(lambda: xla_attention(q, k, v, causal=causal),
                           iters=5)
        kind = "causal" if causal else "full"
        print(f"{label} {kind}: B={b} T={t} H={h} D={d} f32 on sp={RING_SP} "
              f"ranks ({card}): max abs gap to the dense attention "
              f"{err:.3e} (tolerance {RING_ATOL}); peak memory beyond the "
              f"inputs {ring_gb:.3f} GB ring, {dense_gb:.3f} GB dense (its "
              f"scores alone {b * h * t * t * 4 / 1e9:.2f} GB, one ring "
              f"block's {b * h * (t // RING_SP) ** 2 * 4 / 1e6:.1f} MB); "
              f"{ring_ms:.3f} ms ring, {dense_ms:.3f} ms dense")
        check(err <= RING_ATOL, f"{label} {kind}: ring attention parts from "
              f"the dense attention by {err:.3e}")
    launches = _launches()
    _zero_launch_phase(label, launches)
    _check_precision(label)
    return launches


def _mlp_block(layer, x):
    return x + torch.tanh(x @ layer["w1"]) @ layer["w2"]


def phase_pipeline(card: str) -> dict:
    """``pipeline_forward`` over 4 stages on one card: the reference test's
    MLP block at dim 2048, 8 layers, f32, x ``[8, 256, 2048]``, M=4 and
    M=8: the output and the gradients of a mean-square loss against the
    sequential program's (``PIPE_TOL`` of each one's largest entry), and
    both times."""
    from tpu9_torch.parallel import make_named_mesh, pipeline_forward
    from tpu9_torch.parallel import stack_layers

    label = "pipeline"
    _check_precision(label)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(3)
    layers = [{name: torch.randn((PIPE_DIM, PIPE_DIM), generator=gen,
                                 device=DEVICE) * PIPE_DIM ** -0.5
               for name in ("w1", "w2")} for _ in range(PIPE_LAYERS)]
    stacked = {k: v.requires_grad_(True)
               for k, v in stack_layers(layers).items()}
    x = torch.randn((*PIPE_X, PIPE_DIM), generator=gen, device=DEVICE)
    mesh = make_named_mesh({"pp": PIPE_STAGES}, devices=[DEVICE] * PIPE_STAGES)

    def sequential():
        y = x
        for i in range(PIPE_LAYERS):
            y = _mlp_block({k: w[i] for k, w in stacked.items()}, y)
        return y

    def grads(fn):
        y = fn()
        return y.detach(), torch.autograd.grad(
            torch.mean((y - 1.0) ** 2), list(stacked.values()))

    _zero_launches()
    want, want_g = grads(sequential)
    seq_ms = time_ms(lambda: grads(sequential), iters=5)
    for m in PIPE_MICROBATCHES:
        def pipe():
            return pipeline_forward(_mlp_block, stacked, x, mesh,
                                    n_microbatches=m)
        got, got_g = grads(pipe)
        errs = [float((g - w).abs().max() / w.abs().max())
                for g, w in zip((got, *got_g), (want, *want_g))]
        pipe_ms = time_ms(lambda: grads(pipe), iters=5)
        print(f"{label}: {PIPE_STAGES} stages, {PIPE_LAYERS} layers at dim "
              f"{PIPE_DIM}, x {list(x.shape)} f32, M={m} (bubble "
              f"{(PIPE_STAGES - 1) / (m + PIPE_STAGES - 1):.1%} of "
              f"{m + PIPE_STAGES - 1} steps, skipped) on one card ({card}): "
              f"max gap over the largest entry, output {errs[0]:.3e} "
              f"(max abs {float((got - want).abs().max()):.3e}), gradients "
              f"{max(errs[1:]):.3e} (tolerance {PIPE_TOL:.3e}); forward + "
              f"backward {pipe_ms:.3f} ms, sequential {seq_ms:.3f} ms")
        check(max(errs) <= PIPE_TOL, f"{label} M={m}: the pipeline parts "
              f"from the sequential program by {errs}")
    launches = _launches()
    _zero_launch_phase(label, launches)
    return launches


def phase_moe_train(card: str) -> dict:
    """``moe_ffn`` at mixtral-8x7b's FFN width (dim 4096, hidden 14336, 8
    experts, top-2, bf16) trained on ``ep=4`` ranks of one card against the
    same layer unsharded (``ep=1``): ``test_moe_train_step_loss_decreases``'s
    loss (mean square against x rolled by one, plus 0.01 of the balance
    loss), adam, ``MOE_TRAIN_STEPS`` steps each, the losses compared step
    by step (``MOE_LOSS_RTOL``), both step times."""
    from tpu9_torch.models.moe import (MoeConfig, init_moe_layer, moe_ffn,
                                       moe_param_specs)
    from tpu9_torch.parallel import make_named_mesh, shard_params
    from tpu9_torch.parallel.sharding import Pieces
    from tpu9_torch.train import optim

    label = f"moe-train ep={MOE_TRAIN_EP}"
    cfg = MoeConfig(**MOE_TRAIN_CFG, dtype=torch.bfloat16)
    torch.cuda.empty_cache()
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(4)
    whole = init_moe_layer(cfg, gen, DEVICE)
    x = torch.randn((*MOE_TRAIN_X, cfg.dim), generator=gen, device=DEVICE
                    ).to(cfg.dtype)
    target = torch.roll(x, 1, dims=-1).float()
    mesh = make_named_mesh({"ep": MOE_TRAIN_EP},
                           devices=[DEVICE] * MOE_TRAIN_EP)
    sharded = shard_params(whole, mesh, moe_param_specs(whole))
    check(isinstance(sharded["w_gate"], Pieces), f"{label}: not sharded")
    opt = optim.adam(MOE_TRAIN_LR)

    def trainer(params):
        state = {"p": params, "o": opt.init(params)}

        def one():
            live = optim.tree_map(lambda p: p.detach().requires_grad_(True),
                                  state["p"])
            y, aux = moe_ffn(live, x, cfg)
            loss = (torch.mean((y.float() - target) ** 2)
                    + 0.01 * aux["balance_loss"])
            leaves = optim.tree_leaves(live)
            by_id = dict(zip(map(id, leaves),
                             torch.autograd.grad(loss, leaves)))
            grads = optim.tree_map(lambda p: by_id[id(p)], live)
            updates, state["o"] = opt.update(grads, state["o"], state["p"])
            state["p"] = optim.apply_updates(state["p"], updates)
            return loss.detach()
        return one

    runs = {"ep=1": trainer(whole), f"ep={MOE_TRAIN_EP}": trainer(sharded)}
    del whole, sharded
    print(f"{label}: {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated "
          f"before the steps ({card})")
    _zero_launches()
    losses = {k: [] for k in runs}
    secs = {k: [] for k in runs}
    for _ in range(MOE_TRAIN_STEPS):
        for k, one in runs.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = float(one())
            secs[k].append(time.perf_counter() - t0)
            check(np.isfinite(loss), f"{label}: {k} loss {loss}")
            losses[k].append(loss)
    ref, got = losses["ep=1"], losses[f"ep={MOE_TRAIN_EP}"]
    gaps = [abs(a - b) / abs(b) for a, b in zip(got, ref)]
    ms = {k: float(np.median(v[1:])) * 1e3 for k, v in secs.items()}
    print(f"{label}: mixtral-8x7b FFN widths {MOE_TRAIN_CFG}, bf16, x "
          f"{list(x.shape)}, adam lr {MOE_TRAIN_LR}, on one card ({card}): "
          f"losses ep=1 {[round(v, 6) for v in ref]}, ep={MOE_TRAIN_EP} "
          f"{[round(v, 6) for v in got]}: relative gaps "
          f"{[f'{g:.2e}' for g in gaps]} (tolerance {MOE_LOSS_RTOL:.3e}); "
          f"step {ms['ep=1']:.2f} ms ep=1, {ms[f'ep={MOE_TRAIN_EP}']:.2f} ms "
          f"ep={MOE_TRAIN_EP} (median of steps 2-{MOE_TRAIN_STEPS}, host "
          f"clock to a synchronize)")
    check(max(gaps) <= MOE_LOSS_RTOL, f"{label}: ep-sharded losses part "
          f"from the unsharded ones by {gaps}")
    check(got[-1] < got[0], f"{label}: the loss did not fall: {got}")
    launches = _launches()
    _zero_launch_phase(label, launches)
    return launches


SHARD_PHASES = {"lora-fsdp": phase_train_lora_fsdp,
                "full-fsdp": phase_train_full_fsdp, "ring": phase_ring,
                "pipeline": phase_pipeline, "moe-train": phase_moe_train}


# -- phases 19 and 20: the encoders ---------------------------------------------

F32_FLOP_PER_S = 67e12             # H100 SXM f32 outside the tensor cores
                                   # (NVIDIA's data sheet, dense, 700 W)
VISION_IMAGES_SEED = 1
VISION_BATCHES = (1, 8, 64)
ENCODER_REPS = 10                  # timed calls after two warm ones
# The card's f32 forward against the port's CPU f32 forward of the same
# tree on the same 2 images, max abs of the unit embeddings. On the CPU a
# full-depth ViT-L/14 put two f32 implementations of the function (the
# port's and the JAX package's, sums in other orders) 1.5e-7 apart (8
# images); the card's products sum in yet another order, a gap of that
# size. 1e-5 keeps a wide margin and still catches TF32 products (10-bit
# mantissas: gaps near 1e-3).
VISION_F32_ATOL = 1e-5
# The card's bf16 forward against its f32 forward over the same draws
# upcast: on the CPU the JAX package's bf16 CLIP_VIT_L14 forward
# (PRNGKey(0) weights, 8 images from numpy's default_rng(1), 224 px) lies
# at cosine 0.9999379 or more from its f32 forward, so 1 - cos <= 6.21e-5
# (tests/test_torch_vision.py re-derives both CPU figures). These weights
# are other draws of the same distribution and the card's bf16 GEMMs round
# in other orders: the limit allows four times that gap.
VISION_JAX_BF16_GAP = 6.21e-5
VISION_BF16_COS = 1.0 - 4 * VISION_JAX_BF16_GAP
VISION_NORM_ATOL = 1e-3            # the bf16 embeddings' norms
VISION_BATCH_COS = 0.9999          # row 0 of B=64 against the image alone
CLS_TOKENS = (4, 128)
CLS_LENS = [128, 100, 37, 1]
CLS_BATCHES = (1, 32)
# The card's f32 logits against the port's CPU f32 forward of the same
# tree: on the CPU the port's and the JAX package's forwards of this config
# (PRNGKey(0) weights, these lengths) lie 1.9e-6 apart, logits near 2
# (re-derived by tests/test_torch_classifier.py); the card sums in yet
# another order. 2e-5 keeps a tenfold margin and still catches TF32
# products.
CLS_ATOL = 2e-5
# garbage tokens past each mask: the reference test's tolerance
# (tests/test_models.py::TestClassifier::test_padding_invariance)
CLS_PAD_ATOL = 1e-4


def vision_flops(cfg, batch: int) -> dict:
    """FLOPs of one ``clip_vision_forward`` of ``cfg`` on ``batch`` images,
    by the products' dtype: ``weights`` (in ``cfg.dtype``: 2 per weight
    per token in the patch embedding and each layer, 2 per weight per image
    in the projection) and ``attention`` (in f32: 4 per (dim, token pair)
    a layer, the scores and the product with v). The elementwise work is
    left out."""
    t = cfg.n_patches + 1
    patch_dim = 3 * cfg.patch_size ** 2
    layer_w = 4 * cfg.dim * cfg.dim + 2 * cfg.dim * cfg.hidden_dim
    weights = batch * (2 * cfg.n_patches * patch_dim * cfg.dim
                       + cfg.n_layers * 2 * t * layer_w
                       + 2 * cfg.dim * cfg.embed_dim)
    attention = batch * cfg.n_layers * 4 * t * t * cfg.dim
    return {"weights": weights, "attention": attention}


def _check_precision(label: str) -> None:
    """The encoders' f32 products must be full f32: under "high" they would
    run TF32 and part from the reference."""
    prec = torch.get_float32_matmul_precision()
    check(prec == "highest", f"{label}: the f32 matmul precision is {prec}, "
          f"not highest")


def _forward_ms(fn, reps: int = ENCODER_REPS) -> float:
    """Median host ms of one call of ``fn`` ended by a synchronize, after
    two warm calls: what a caller waiting for its result sees."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3


def capture_forward(fn, static_in: tuple):
    """``fn(*static_in)`` captured as one CUDA graph over static input
    buffers (the counterpart of ``jax.jit`` in ``examples/03``): the graph
    and its static output. Two eager calls on a side stream first load the
    kernels and the libraries' handles."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn(*static_in)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        out = fn(*static_in)
    return graph, out


def _check_replay(label: str, graph, out, static_in: tuple, fresh: tuple,
                  eager) -> None:
    """Copy ``fresh`` into the static buffers, replay, and hold the output
    against the eager call on ``fresh`` bit for bit."""
    for buf, x in zip(static_in, fresh):
        buf.copy_(x)
    graph.replay()
    torch.cuda.synchronize()
    if not torch.equal(out, eager):
        raise SmokeFailure(f"{label}: the captured forward's output is not "
                           f"the eager one's (max diff "
                           f"{float((out - eager).abs().max()):.3e})")


def _cosines(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1))


def phase_vision(card: str) -> dict:
    """CLIP ViT-L/14 (``examples/03``'s image embedder) at full width and
    depth from seed 0: the f32 forward on the card against the port's f32
    forward on the CPU, the bf16 forward against the f32 one, unit norms,
    batch invariance, none of the four kernels launched; the forward
    captured as a CUDA graph at B=1, 8 and 64, each replay equal to the
    eager call bit for bit; ms and images/s eager and captured, the share
    of the roofline, the peak memory and the attention's device time; one
    profiled B=64 forward. Returns the launches."""
    from tpu9_torch.models.clip_vit import (CLIP_VIT_L14, clip_vision_forward,
                                            init_clip_vision)
    from tpu9_torch.ops.attention import encoder_attention
    from tpu9_torch.train.optim import tree_leaves, tree_map

    label = "vision clip-vit-l14"
    _check_precision(label)
    cfg = CLIP_VIT_L14
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(0)
    params = init_clip_vision(cfg, gen, DEVICE)
    torch.cuda.synchronize()
    leaves = tree_leaves(params)
    n_params = sum(x.numel() for x in leaves)
    w_bytes = sum(x.numel() * x.element_size() for x in leaves)
    print(f"{label}: {cfg.n_layers} layers, dim {cfg.dim}, {cfg.n_heads} "
          f"heads of {cfg.head_dim}, {cfg.n_patches + 1} tokens an image, "
          f"{n_params} params, {w_bytes / 1e9:.3f} GB ({cfg.dtype}, norms "
          f"f32) drawn in {time.perf_counter() - t0:.2f} s")
    images = torch.from_numpy(np.random.default_rng(VISION_IMAGES_SEED).random(
        (max(VISION_BATCHES), cfg.image_size, cfg.image_size, 3),
        dtype=np.float32)).to(DEVICE)

    def forward(x):
        return clip_vision_forward(params, x, cfg)

    with torch.no_grad():
        _zero_launches()
        # f32 on the card against f32 on the CPU, the same draws upcast
        params32 = tree_map(lambda x: x.float(), params)
        got32 = clip_vision_forward(params32, images[:2], cfg32)
        cpu32 = clip_vision_forward(tree_map(lambda x: x.cpu(), params32),
                                    images[:2].cpu(), cfg32)
        err32 = float((got32.cpu() - cpu32).abs().max())
        print(f"{label}: f32 on the card against f32 on the CPU (2 images): "
              f"max abs {err32:.3e} (limit {VISION_F32_ATOL:g})")
        check(err32 <= VISION_F32_ATOL, f"{label}: the card's f32 embeddings "
              f"lie {err32:.3e} from the CPU's")
        # bf16 against f32, on the card
        emb = forward(images[:2])
        cos = float(_cosines(emb, got32).min())
        print(f"{label}: bf16 against f32 on the card: min cosine "
              f"{cos:.7f} (limit {VISION_BF16_COS:.7f})")
        check(cos >= VISION_BF16_COS, f"{label}: bf16 cosine {cos} to f32")
        del params32, got32, cpu32
        # unit norms and batch invariance at B=64
        emb64 = forward(images)
        norms = emb64.norm(dim=-1)
        check(bool(torch.isfinite(emb64).all()), f"{label}: NaN or inf")
        norm_err = float((norms - 1).abs().max())
        check(norm_err <= VISION_NORM_ATOL, f"{label}: norms off 1 by "
              f"{norm_err:.3e}")
        alone = forward(images[:1])
        bcos = float(_cosines(emb64[:1], alone))
        print(f"{label}: B=64 bf16 norms within {norm_err:.3e} of 1; row 0 "
              f"against the image alone: cosine {bcos:.7f} (limit "
              f"{VISION_BATCH_COS})")
        check(bcos >= VISION_BATCH_COS, f"{label}: batch variance {bcos}")
        torch.cuda.synchronize()
        launches = _launches()
        check(not any(launches.values()), f"{label}: kernels launched "
              f"{launches}")

        fresh = torch.from_numpy(np.random.default_rng(VISION_IMAGES_SEED + 1)
                                 .random(tuple(images.shape),
                                         dtype=np.float32)).to(DEVICE)
        for b in VISION_BATCHES:
            x = images[:b].clone()
            torch.cuda.reset_peak_memory_stats()
            eager_ms = _forward_ms(lambda: forward(x))
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            graph, out = capture_forward(forward, (x,))
            _check_replay(f"{label} B={b}", graph, out, (x,), (fresh[:b],),
                          forward(fresh[:b]))
            graph_ms = _forward_ms(graph.replay)
            flops = vision_flops(cfg, b)
            ops_ms = (flops["weights"] / BF16_FLOP_PER_S
                      + flops["attention"] / F32_FLOP_PER_S) * 1e3
            bytes_ms = (w_bytes + x.numel() * 4
                        + b * cfg.embed_dim * 4) / HBM_BYTES_PER_S * 1e3
            bound = max(ops_ms, bytes_ms)
            print(f"{label} B={b}: eager {eager_ms:.3f} ms "
                  f"({b / eager_ms * 1e3:.1f} images/s), captured "
                  f"{graph_ms:.3f} ms ({b / graph_ms * 1e3:.1f} images/s), "
                  f"replay equal to eager bit for bit; bound {bound:.4f} ms "
                  f"({'operations' if ops_ms >= bytes_ms else 'bytes'}: "
                  f"{flops['weights'] / b:.4e} FLOP an image in bf16 products "
                  f"at {BF16_FLOP_PER_S:.3g}/s + {flops['attention'] / b:.4e} "
                  f"in f32 attention at {F32_FLOP_PER_S:.3g}/s, one after the "
                  f"other; {w_bytes / 1e9:.3f} GB of weights at "
                  f"{HBM_BYTES_PER_S:.3g} B/s), {bound / graph_ms:.1%} of it "
                  f"captured, {bound / eager_ms:.1%} eager; peak allocated "
                  f"{peak_gb:.2f} GB eager ({card})")
            del graph, out

        # the f32 attention alone, device time, at B=64's shapes
        t = cfg.n_patches + 1
        qkv = torch.randn((max(VISION_BATCHES), t, 3, cfg.n_heads,
                           cfg.head_dim), generator=gen, device=DEVICE
                          ).to(cfg.dtype)
        q, k, v = qkv.unbind(2)
        attn_ms = time_ms(lambda: encoder_attention(q, k, v), iters=20,
                          hold=True) * cfg.n_layers
        print(f"{label} B=64: the f32 attention alone (scores, softmax, "
              f"product with v, casts) {attn_ms:.3f} ms of device time "
              f"over {cfg.n_layers} layers ({card})")
        out_dir = ROOT / "build" / "profile"
        out_dir.mkdir(parents=True, exist_ok=True)
        _profile(lambda: forward(images), "vision_clip_l14_B64", 1, out_dir)
    _check_precision(label)
    return launches


def phase_classifier(card: str) -> dict:
    """The text classifier (``examples/01``'s sentiment model) at its full
    config (f32, distilbert widths, 30,522 ids) from seed 0: logits of B=4,
    T=128 sequences of mixed lengths on the card against the port's CPU
    forward, garbage tokens past the mask, a fully masked row, negative and
    out-of-range ids (the clamped rows' logits, no device assert), none of
    the four kernels launched; sequences/s at B=1 and 32 eager and
    captured, the peak memory. Returns the launches."""
    from tpu9_torch.models.classifier import (TextClassifierConfig,
                                              classifier_forward,
                                              init_classifier)
    from tpu9_torch.train.optim import tree_leaves, tree_map

    label = "classifier distilbert-widths"
    _check_precision(label)
    cfg = TextClassifierConfig()
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(0)
    params = init_classifier(cfg, gen, DEVICE)
    n_params = sum(x.numel() for x in tree_leaves(params))
    print(f"{label}: {cfg.n_layers} layers, dim {cfg.dim}, {cfg.n_heads} "
          f"heads, vocab {cfg.vocab_size}, max_len {cfg.max_len}, "
          f"{n_params} params ({cfg.dtype})")
    rng = np.random.default_rng(2)
    b, t = CLS_TOKENS
    tokens = rng.integers(0, cfg.vocab_size, (b, t))
    mask = (np.arange(t)[None] < np.asarray(CLS_LENS)[:, None])
    garbage = np.where(mask, tokens, rng.integers(0, cfg.vocab_size, (b, t)))

    def on(x):
        return torch.from_numpy(np.asarray(x, dtype=np.int64)).to(DEVICE)

    def forward(tok, m):
        return classifier_forward(params, tok, m, cfg)

    with torch.no_grad():
        _zero_launches()
        got = forward(on(tokens), on(mask))
        want = classifier_forward(tree_map(lambda x: x.cpu(), params),
                                  torch.from_numpy(tokens),
                                  torch.from_numpy(mask.astype(np.int64)), cfg)
        err = float((got.cpu() - want).abs().max())
        pad = float((forward(on(garbage), on(mask)) - got).abs().max())
        print(f"{label}: B={b} T={t} lengths {CLS_LENS}: card against CPU "
              f"max abs {err:.3e} (limit {CLS_ATOL:g}), garbage past the "
              f"mask moves the logits {pad:.3e} (limit {CLS_PAD_ATOL:g})")
        check(err <= CLS_ATOL, f"{label}: logits {err:.3e} from the CPU's")
        check(pad <= CLS_PAD_ATOL, f"{label}: padding moved the logits {pad}")
        empty = forward(on(tokens[:2]), on(np.stack([mask[0], 0 * mask[0]])))
        check(bool((empty[1] == 0).all()) and bool(torch.isfinite(empty).all()),
              f"{label}: a fully masked row gave {empty[1].tolist()}")
        v = cfg.vocab_size
        wild = tokens[:2].copy()
        wild[:, :4] = [v + 5, -1, -v - 7, 3 * v]
        rows = np.where(wild < 0, wild + v, wild).clip(0, v - 1)
        full = np.ones_like(wild)
        clamped = forward(on(wild), on(full))
        torch.cuda.synchronize()           # a device assert would raise here
        check(torch.equal(clamped, forward(on(rows), on(full))),
              f"{label}: out-of-range ids did not read the clamped rows")
        print(f"{label}: a fully masked row gives zero logits; ids "
              f"{wild[0, :4].tolist()} read rows {rows[0, :4].tolist()}, no "
              f"device assert")
        torch.cuda.synchronize()
        launches = _launches()
        check(not any(launches.values()), f"{label}: kernels launched "
              f"{launches}")

        for bb in CLS_BATCHES:
            tok = on(rng.integers(0, v, (bb, t)))
            m = torch.ones_like(tok)
            torch.cuda.reset_peak_memory_stats()
            eager_ms = _forward_ms(lambda: forward(tok, m))
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            graph, out = capture_forward(forward, (tok, m))
            fresh = on(rng.integers(0, v, (bb, t)))
            _check_replay(f"{label} B={bb}", graph, out, (tok, m),
                          (fresh, m.clone()), forward(fresh, m))
            graph_ms = _forward_ms(graph.replay)
            print(f"{label} B={bb} T={t}: eager {eager_ms:.3f} ms "
                  f"({bb / eager_ms * 1e3:.1f} sequences/s), captured "
                  f"{graph_ms:.3f} ms ({bb / graph_ms * 1e3:.1f} "
                  f"sequences/s), replay equal to eager bit for bit; peak "
                  f"allocated {peak_gb:.3f} GB eager ({card})")
            del graph, out
    _check_precision(label)
    return launches


ENCODER_PHASES = {"vision": phase_vision, "classifier": phase_classifier}


# -- after phase 4: bench_reset_slots -----------------------------------------

BENCH_CTX0 = 1024
BENCH_BUDGET = 64
BENCH_WINDOW = 8


def phase_bench_reset(engine, card: str) -> None:
    """``bench_reset_slots(1024, 64)`` on the bf16 engine once its other
    phases are done: every slot's table row distinct blocks covering 1089
    positions, on the host and on the device, then the captured 8-step
    window replayed from length 1024 on every lane: B1 launched
    ``n_layers x 8`` times, the lanes advanced by 8 and each lane's new
    keys written into its own block past 1024 (the window read the new
    rows)."""
    from tpu9_torch.ops import paged_attention as pa
    t0 = time.perf_counter()
    cfg, pool = engine.cfg, engine.pool
    engine.bench_reset_slots(BENCH_CTX0, BENCH_BUDGET)
    need = -(-(BENCH_CTX0 + BENCH_BUDGET + 1) // pool.ecfg.kv_block_size)
    rows = pool.table_np[:, :need]
    check(all(len(b) == need for b in pool.slot_blocks),
          f"bench_reset_slots gave {[len(b) for b in pool.slot_blocks]} "
          f"blocks, {need} a slot cover {BENCH_CTX0 + BENCH_BUDGET + 1}")
    check(len(set(rows.ravel().tolist())) == rows.size
          and pool.trash_block not in rows,
          "bench_reset_slots rows share blocks or hold the trash block")
    check(np.array_equal(engine.kv_cache["table"].cpu().numpy(),
                         pool.table_np), "the device table is not the host's")
    check(engine.graphs.window.kv_cache["table"] is pool.table,
          "the window's table was rebound")
    check(engine._host_len.tolist() == [BENCH_CTX0] * engine.ecfg.max_batch,
          f"host lengths {engine._host_len.tolist()}")
    window = engine.graphs.decode_k(BENCH_WINDOW)
    check(type(window).__name__ == "CapturedWindow",
          f"the {BENCH_WINDOW}-step window is not captured")
    engine.cache_len.fill_(BENCH_CTX0)
    engine._active_dev.fill_(True)
    engine.last_token.fill_(1)
    # each lane's block holding positions 1024 onwards
    blk = torch.as_tensor(
        pool.table_np[:, BENCH_CTX0 // pool.ecfg.kv_block_size],
        dtype=torch.long, device=engine.device)
    k0 = engine.kv_cache["k"][0, blk].clone()
    torch.cuda.synchronize()
    pa.paged_decode_attention.launches = 0
    window()
    torch.cuda.synchronize()
    launches = pa.paged_decode_attention.launches
    want = cfg.n_layers * BENCH_WINDOW
    check(launches == want, f"the replay launched B1 {launches} times, "
          f"expected {want}")
    check(engine.cache_len.tolist() == [BENCH_CTX0 + BENCH_WINDOW]
          * engine.ecfg.max_batch, f"lanes at {engine.cache_len.tolist()}")
    k1 = engine.kv_cache["k"][0, blk]
    written = (k1[:, :BENCH_WINDOW] != k0[:, :BENCH_WINDOW]).flatten(1)
    check(bool(written.any(1).all()) and bool(torch.isfinite(k1).all()),
          "a lane's keys past its reset length were not written through "
          "its new table row")
    print(f"bench_reset_slots({BENCH_CTX0}, {BENCH_BUDGET}): {need} distinct "
          f"blocks a slot over {engine.ecfg.max_batch} slots, the table "
          f"written in place; the captured {BENCH_WINDOW}-step window "
          f"replayed from {BENCH_CTX0}: B1 {launches} launches "
          f"({cfg.n_layers} x {BENCH_WINDOW}), every lane's keys written "
          f"through its new row; {time.perf_counter() - t0:.2f} s ({card})")


# -- the runner zygote: llama3-8b served from a forked child --------------------

ZYGOTE_PROMPTS = (128, 256, 512, 1024)
ZYGOTE_NEW = 32
ZYGOTE_KERNELS = ("paged_decode_attention", "flash_attention")
ZYGOTE_LIMIT_S = 240
# the child module a zygote forks and a fresh interpreter runs: the bf16
# phase's engine (seed 0, full width and depth), four greedy requests at
# once; it prints its tokens, its launches between the serve's zeroing and
# its end, and wall-clock stamps of its start, its engine's readiness and
# its first token
ZYGOTE_CHILD = """
import time
T_START = time.time()
import asyncio, json
import numpy as np
import torch
from tpu9_torch.ops import _build, attention, paged_attention
from tpu9_torch.serving.presets import load_engine

# what loading the libraries before the fork would save: a cache hit
# after a zygote's KERNEL_PRELOAD, a dlopen here
t0 = time.perf_counter()
for name in {kernels!r}:
    _build.load(name)
KERNEL_LOAD_S = time.perf_counter() - t0


async def main():
    engine = load_engine("llama3-8b", max_batch=8, max_seq_len=2048,
                         seed=0, compile_ahead=True)
    engine.warmup()
    torch.cuda.synchronize()
    t_ready = time.time()
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, engine.cfg.vocab_size, n).tolist()
               for n in {lens!r}]
    firsts = []

    async def one(p):
        req = await engine.generate(p, max_new_tokens={new}, stream=True)
        toks = []
        while (tok := await req.queue.get()) is not None:
            if not toks:
                firsts.append(time.time())
            toks.append(tok)
        assert not req.error, req.error
        return toks

    await engine.start()
    try:
        steps0 = engine.stats()["decode_steps"]
        flash = (attention.flash_attention, attention.flash_attention_backward)
        for w in paged_attention.COUNTED + flash:
            w.launches = 0
        outs = await asyncio.gather(*[one(p) for p in prompts])
        launches = {{**paged_attention.launch_counts(),
                    **{{w.__name__: w.launches for w in flash}}}}
        steps = engine.stats()["decode_steps"] - steps0
    finally:
        await engine.stop()
    print("ZYGOTE_CHILD " + json.dumps({{
        "tokens": outs, "launches": launches, "steps": steps,
        "n_layers": engine.cfg.n_layers, "start": T_START,
        "ready": t_ready, "first": min(firsts),
        "cuda_at_start": CUDA_AT_START,
        "kernel_load_s": KERNEL_LOAD_S}}), flush=True)


CUDA_AT_START = [torch.cuda.is_initialized(), torch.cuda._is_in_bad_fork()]
asyncio.run(main())
""".format(lens=ZYGOTE_PROMPTS, new=ZYGOTE_NEW, kernels=ZYGOTE_KERNELS)


# what a zygote's --preload of it does: the built kernel libraries loaded
# before the fork (measured by scripts/zygote_coldstart.py, not kept: the
# cold start does not show it, PERF.md §6)
KERNEL_PRELOAD = """
from tpu9_torch.ops import _build
for name in {kernels!r}:
    if _build.library_path(name).exists():
        _build.load(name)
""".format(kernels=ZYGOTE_KERNELS)


def _compute_pids() -> set:
    smi = subprocess.run(["nvidia-smi", "--query-compute-apps=pid",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30)
    return {int(x) for x in smi.stdout.split() if x.strip().isdigit()}


def _nvidia_fds(pid: int) -> list:
    """The ``/dev/nvidia*`` files ``pid`` holds open: a CUDA context opens
    them, an import or a ``dlopen`` does not."""
    out = []
    for fd in Path(f"/proc/{pid}/fd").iterdir():
        try:
            target = os.readlink(fd)
        except OSError:
            continue
        if target.startswith("/dev/nvidia"):
            out.append(target)
    return out


def _start_zygote(sock: str, log: Path, preload=(),
                  path: str = "") -> subprocess.Popen:
    args = [a for m in preload for a in ("--preload", m)]
    env = _child_env()
    if path:
        env["PYTHONPATH"] += os.pathsep + path
    return subprocess.Popen(
        [sys.executable, "-m", "tpu9_torch.runner.zygote", "--sock", sock,
         *args], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=log.open("w"), start_new_session=True)


def _child_env() -> dict:
    env = {k: os.environ[k] for k in ("PATH", "HOME", "LANG", "CUDA_HOME",
                                       "LD_LIBRARY_PATH", "TMPDIR")
           if k in os.environ}
    env.update(PYTHONPATH=str(ROOT), PYTHONUNBUFFERED="1")
    return env


def _await_ready(proc: subprocess.Popen, label: str) -> float:
    t0 = time.perf_counter()
    import select
    ready, _, _ = select.select([proc.stdout], [], [], ZYGOTE_LIMIT_S)
    line = proc.stdout.readline().decode() if ready else ""
    check(line == "zygote: ready\n", f"{label} said {line!r}")
    return time.perf_counter() - t0


def _read_all(fd: int, into: list) -> None:
    with os.fdopen(fd, "rb") as f:
        into.append(f.read().decode())


def _child_result(out: str, label: str) -> dict:
    lines = [ln for ln in out.splitlines() if ln.startswith("ZYGOTE_CHILD ")]
    check(len(lines) == 1, f"{label} printed no result")
    return json.loads(lines[0][len("ZYGOTE_CHILD "):])


def _spawn_forked(sock: str, cwd: str, zygote_pid: int, label: str):
    """One spawn over the reference protocol (a JSON line with the
    child's stdout and stderr fds by ``SCM_RIGHTS``, then ``{"pid": N}``
    and ``{"exit": code}``), sampling the card's compute pids while the
    child runs. Returns (the child's result, the wall stamp of the spawn,
    every compute pid seen, the exit reply)."""
    import socket
    import threading
    out_r, out_w = os.pipe()
    err_r, err_w = os.pipe()
    payload = json.dumps({"env": _child_env(), "cwd": cwd,
                          "module": "zygote_child", "argv": []}).encode()
    t_spawn = time.time()
    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    s.settimeout(30.0)
    s.connect(sock)
    socket.send_fds(s, [payload + b"\n"], [out_w, err_w])
    os.close(out_w)
    os.close(err_w)
    reply = s.makefile("rb")
    pid = json.loads(reply.readline())["pid"]
    outs, errs = [], []
    readers = [threading.Thread(target=_read_all, args=(fd, into))
               for fd, into in ((out_r, outs), (err_r, errs))]
    for t in readers:
        t.start()
    seen: set = set()
    while readers[0].is_alive():
        seen |= _compute_pids()
        readers[0].join(0.5)
        check(time.time() - t_spawn < ZYGOTE_LIMIT_S,
              f"{label} child ran past {ZYGOTE_LIMIT_S} s")
    for t in readers:
        t.join()
    s.settimeout(ZYGOTE_LIMIT_S)
    exit_line = json.loads(reply.readline())
    s.close()
    check(exit_line == {"exit": 0}, f"{label} child ended {exit_line}: "
          f"{errs[0][-2000:]}")
    check(zygote_pid not in seen, f"the {label} zygote {zygote_pid} was a "
          f"CUDA compute app: {sorted(seen)}")
    return _child_result(outs[0], label), t_spawn, pid, seen


def zygote_runs(work: Path, order, card: str) -> list:
    """Run the child module (``ZYGOTE_CHILD``, written into ``work``) in
    ``order``: ``"zygote"`` forks it from the zygote,
    ``"zygote-kernels"`` from one that also preloads a module loading the
    built kernel libraries (``KERNEL_PRELOAD``, by ``dlopen``), ``"exec"``
    runs it in a fresh interpreter. Each zygote
    must report CUDA uninitialised after its warm-up, never be a CUDA
    compute app and hold no ``/dev/nvidia`` file; each forked child must
    find CUDA uninitialised at its start and exit 0, reaped
    (``{"exit": 0}``). Returns ``(label, result, wall stamp of the
    spawn)`` in ``order``."""
    (work / "zygote_child.py").write_text(ZYGOTE_CHILD)
    (work / "zygote_kernels.py").write_text(KERNEL_PRELOAD)
    zygotes = {}
    runs = []
    try:
        for label in dict.fromkeys(order):
            if label != "exec":
                kernels = label == "zygote-kernels"
                zygotes[label] = _start_zygote(
                    str(work / f"{label}.sock"), work / f"{label}.log",
                    ("zygote_kernels",) if kernels else (),
                    str(work) if kernels else "")
        for label, proc in zygotes.items():
            warm_s = _await_ready(proc, label)
            warm = (work / f"{label}.log").read_text()
            check("cuda initialized False" in warm, f"{label}: {warm}")
            print(f"zygote {label}: ready {warm_s:.2f} s after the wait "
                  f"began, pid {proc.pid}; "
                  f"{warm.strip().splitlines()[-1]}")
        for label in order:
            if label == "exec":
                t_spawn = time.time()
                proc = subprocess.run(
                    [sys.executable, str(work / "zygote_child.py")],
                    cwd=work, env=_child_env(), capture_output=True,
                    text=True, timeout=ZYGOTE_LIMIT_S)
                check(proc.returncode == 0, f"the exec'd child failed: "
                      f"{proc.stderr[-2000:]}")
                runs.append((label, _child_result(proc.stdout, label),
                             t_spawn))
                continue
            zproc = zygotes[label]
            res, t_spawn, pid, seen = _spawn_forked(
                str(work / f"{label}.sock"), str(work), zproc.pid, label)
            fds = _nvidia_fds(zproc.pid)
            check(not fds, f"the {label} zygote holds {fds}")
            check(res["cuda_at_start"] == [False, False],
                  f"the {label} child found CUDA state at its start: "
                  f"{res['cuda_at_start']}")
            where = ("seen" if pid in seen else "not seen: the card "
                     "reports pids of another namespace")
            print(f"zygote {label}: child {pid} served; compute pids seen "
                  f"{sorted(seen)} (the child {where}), the zygote "
                  f"{zproc.pid} never; the zygote holds no /dev/nvidia file")
            runs.append((label, res, t_spawn))
    finally:
        for proc in zygotes.values():
            try:
                os.killpg(proc.pid, 9)
            except ProcessLookupError:
                pass
            proc.wait(timeout=30)
    for label, res, t_spawn in runs:
        print(f"zygote {label}: from the spawn: module start "
              f"{res['start'] - t_spawn:.3f} s, engine ready "
              f"{res['ready'] - t_spawn:.3f} s, first token "
              f"{res['first'] - t_spawn:.3f} s; kernel libraries loaded in "
              f"{res['kernel_load_s'] * 1e3:.2f} ms ({card})")
    return runs


def phase_zygote(card: str) -> dict:
    """The zygote (``python -m tpu9_torch.runner.zygote``) forks the child
    module (``ZYGOTE_CHILD``: llama3-8b paged bf16 at
    full width and depth, phase 4's weights, four greedy requests of
    128-1024 tokens, 32 new tokens each), then a fresh interpreter runs
    it (``zygote_runs``): the same tokens, B1 ``n_layers x decode steps``
    launches in each and no other kernel's. Returns the forked child's
    launches."""
    import shutil
    import tempfile
    t_phase = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix="zygote-", dir=ROOT / "build"))
    try:
        runs = {label: (res, t) for label, res, t
                in zygote_runs(work, ("zygote", "exec"), card)}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    want = runs["exec"][0]["tokens"]
    for label, (res, _) in runs.items():
        check(res["tokens"] == want, f"{label} tokens differ from the exec'd "
              f"child's")
        check(all(len(t) == ZYGOTE_NEW for t in res["tokens"]),
              f"{label}: a request returned a short stream")
        b1 = res["n_layers"] * res["steps"]
        expect = {name: 0 for name in KERNELS}
        expect["paged_decode_attention"] = b1
        check(res["steps"] > 0 and res["launches"] == expect,
              f"{label} launches {res['launches']}, expected {expect}")
        print(f"zygote {label}: {len(want)} requests x {ZYGOTE_NEW} tokens, "
              f"the exec'd child's tokens; B1 {b1} launches "
              f"({res['n_layers']} layers x {res['steps']} decode steps), "
              f"B2-B4 none ({card})")
    (fork, t_f), (ex, t_e) = runs["zygote"], runs["exec"]
    print(f"zygote cold start, spawn to first token: forked "
          f"{fork['first'] - t_f:.3f} s, exec'd {ex['first'] - t_e:.3f} s; "
          f"phase {time.perf_counter() - t_phase:.1f} s ({card})")
    return fork["launches"]


# -- the graph check: the fake matrix, two real cells, two seeded faults ----------

# the cells run again over real CUDA tensors, and the kernel each launches
GRAPHCHECK_REAL = {"llama3-8b@1x1": "paged_decode_attention",
                   "llama3-8b@2x1+wint8+kvint8":
                   "paged_decode_attention_quant"}


def _seeded_faults() -> list:
    """The two seeded faults, traced over fake tensors on this build:
    an int8 weight sent to ``torch.matmul`` (GRA004) and a pool rebuilt
    out of place (GRA003). Returns each fault's rule ids."""
    from tpu9_torch.analysis.graphcheck import passes
    from tpu9_torch.analysis.graphcheck.matrix import find_cells

    def job(cs, key):
        return next(a for k, _, a in cs.jobs() if k == key)

    with passes.traced_cell(find_cells(["llama3-8b@2x1+wint8+kvint8"])[0]) \
            as cs:
        w = cs.params[0]["layers"][0]["wq"]["q"]

        def leaking(pool, row, scratch):
            torch.matmul(torch.zeros((2, w.shape[0]), dtype=torch.int8,
                                     device=w.device), w)
            return scratch

        int8_fs, _ = passes.check_job(cs, "gather", lambda: leaking,
                                      job(cs, "gather"))
    with passes.traced_cell(find_cells(["llama3-8b@1x1"])[0]) as cs:
        def rebuilding(pool, k, v, offset, phys):
            return {n: t.clone() for n, t in pool.items()}

        pool_fs, _ = passes.check_job(cs, "splice", lambda: rebuilding,
                                      job(cs, "splice"))
    return [sorted({f.rule for f in fs}) for fs in (int8_fs, pool_fs)]


def phase_graphcheck(card: str) -> dict:
    """``python -m tpu9_torch.analysis.graphcheck``'s Pass A over the whole
    matrix (fake CUDA tensors on this CUDA build) and Pass B, both without
    a finding; then ``GRAPHCHECK_REAL``'s cells over real CUDA tensors at
    full width (2 layers): no finding, and each launches its kernel the
    jobs' count (the 1- and 4-step windows and the verify window, a layer
    and a rank each); then the two seeded faults, each found under its
    rule. Returns the real cells' launches."""
    from tpu9_torch.analysis.graphcheck import lint_tree, passes
    from tpu9_torch.analysis.graphcheck.matrix import MATRIX, find_cells
    t0 = time.perf_counter()
    report = passes.run_matrix()
    lint = lint_tree(ROOT)
    fake_s = time.perf_counter() - t0
    found = [f.format() for f in report["findings"] + lint]
    check(not found, f"graphcheck findings: {found[:5]}")
    check(len(report["cells"]) == len(MATRIX), "a cell did not run")
    print(f"graphcheck: {len(MATRIX)} cells over fake CUDA tensors and Pass "
          f"B in {fake_s:.2f} s, no finding; cells "
          f"{[(c['cell'], c['elapsed_s']) for c in report['cells']]} "
          f"({card})")
    launches = {name: 0 for name in KERNELS}
    for cell in find_cells(list(GRAPHCHECK_REAL)):
        _zero_launches()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        findings, stats = passes.run_cell(cell, real=True)
        torch.cuda.synchronize()
        got = _launches()
        check(not findings, f"graphcheck {cell.name} real: "
              f"{[f.format() for f in findings][:5]}")
        tp = int(cell.topology.split("x")[0])
        name = GRAPHCHECK_REAL[cell.name]
        want = {n: 0 for n in KERNELS}
        want[name] = cell.n_layers * (sum(cell.decode_steps) + 1) * tp
        check(got == want and stats["kernels"] == {name: want[name]},
              f"graphcheck {cell.name} real launches {got} (recorded "
              f"{stats['kernels']}), expected {want}")
        launches[name] += got[name]
        print(f"graphcheck {cell.name} over real CUDA tensors: {stats['jobs']}"
              f" jobs in {time.perf_counter() - t1:.2f} s, no finding; "
              f"{name} {got[name]} launches ({cell.n_layers} layers x "
              f"{sum(cell.decode_steps) + 1} windows x {tp} ranks); peak "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB ({card})")
        gc.collect()
        torch.cuda.empty_cache()
    rules = _seeded_faults()
    check(rules == [["GRA004"], ["GRA003"]], f"seeded faults found {rules}")
    print(f"graphcheck seeded faults: an int8 weight into torch.matmul "
          f"found as {rules[0]}, a pool rebuilt out of place as {rules[1]}; "
          f"phase {time.perf_counter() - t0:.1f} s ({card})")
    return launches


PORT_PHASES = {"zygote": phase_zygote, "graphcheck": phase_graphcheck}


# -- optional (--profile): where each engine's time goes ---------------------

def _profile(fn, label: str, per: int, out_dir: Path) -> None:
    """Host clock over three calls of ``fn`` (each ended by a synchronize),
    then ``torch.profiler`` over one more: wall time and device-busy time
    (the union of the intervals of the device's own events: kernels,
    copies, sets) per ``per`` units, and the kernels that take the most
    device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / (3 * per)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    (out_dir / f"profile_{label}.txt").write_text(prof.key_averages().table(
        sort_by="self_cuda_time_total", row_limit=40))
    spans = sorted((ev.time_range.start, ev.time_range.end, ev.name)
                   for ev in prof.events() if ev.device_type == DeviceType.CUDA)
    if not spans:
        check(DEVICE != "cuda", f"profile {label}: the profiler saw no "
              f"device events")
        print(f"profile {label}: wall {wall_ms:.3f} ms; device time not "
              f"measured (the profiler saw no device events)")
        return
    busy_us, reach = 0.0, float("-inf")
    by_name: dict[str, float] = {}
    for start, end, name in spans:
        busy_us += max(0.0, end - max(start, reach))
        reach = max(reach, end)
        by_name[name] = by_name.get(name, 0.0) + (end - start)
    busy_ms = busy_us / 1e3 / per
    top = ", ".join(f"{name[:48]} {us / 1e3 / per:.3f}" for name, us in
                    sorted(by_name.items(), key=lambda kv: -kv[1])[:6])
    print(f"profile {label}: wall {wall_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms ({busy_ms / wall_ms:.1%}, idle "
          f"{1 - busy_ms / wall_ms:.1%}); top device ms: {top}")


PROFILE_LENS = [600, 1212, 128, 1536, 777, 1000, 1800, 400]


def _profile_lanes(e) -> list[int]:
    """All 8 lanes live at ``PROFILE_LENS`` (paged: each lane on its own
    pool blocks, written into the engine's table in place). Five replays of
    an 8-step window, or of a 9-position verify window, keep every lane
    inside its 2048 positions."""
    b = e.ecfg.max_batch
    if e.paged:
        mb = e.pool.mb
        per_row = mb - 1                            # the last column is trash
        check(1 + b * per_row <= e.pool.n_blocks, "pool too small to profile")
        tables = e.kv_cache["table"]
        # a rank-sharded engine holds one table a rank (one object where
        # the ranks share a card)
        for table in (tables if isinstance(tables, list) else [tables]):
            table.zero_()
            table[:, :per_row] = 1 + torch.arange(
                b * per_row, dtype=torch.int32,
                device=table.device).reshape(b, per_row)
    e.cache_len.copy_(torch.tensor(PROFILE_LENS, dtype=torch.int32))
    e._active_dev.fill_(True)
    e.last_token.zero_()
    return PROFILE_LENS


def profile_spec(engine, card: str, kind: str) -> None:
    """One replay of the spec engine's captured verify window (B=8, 8
    drafts a lane, every lane live) beside one of its 8-step decode window,
    per step, from the same lane state. The engine is done serving."""
    e = engine
    out_dir = ROOT / "build" / "profile"
    out_dir.mkdir(parents=True, exist_ok=True)
    b = e.ecfg.max_batch
    lens = _profile_lanes(e)
    e._drafts.copy_(torch.randint(0, e.cfg.vocab_size, e._drafts.shape,
                                  dtype=torch.int32))
    _profile(e.graphs.verify_fn(SPEC_LEN),
             f"{kind}_spec_verify_window_B{b}_s{SPEC_LEN}", 1, out_dir)
    _profile_lanes(e)
    _profile(e.graphs.decode_k(8), f"{kind}_spec_decode_step_B{b}", 8,
             out_dir)
    print(f"profile {kind}: one verify window ({SPEC_LEN} drafts, "
          f"{SPEC_LEN + 1} positions a lane) and per decode step (B={b}, "
          f"lengths {lens}) ({card})")


def phase_profile(engine, card: str, kind: str) -> None:
    """A replay of the engine's captured 8-step decode window with all 8
    lanes live at the engine phase's prompt lengths (paged: each lane on
    its own pool blocks, written into the engine's table in place), and
    one fused admission group of 4 chunks (paged) or one bucket-2048
    prefill (dense), each profiled. The engine is done serving: its
    window state is overwritten here. Per-kernel tables go to
    ``build/profile/``."""
    e = engine
    out_dir = ROOT / "build" / "profile"
    out_dir.mkdir(parents=True, exist_ok=True)
    b = e.ecfg.max_batch
    lens = _profile_lanes(e)
    k = 8
    _profile(e.graphs.decode_k(k), f"{kind}_decode_step_B{b}", k, out_dir)
    if not e.paged:
        bucket = e._buckets[-1]
        toks = torch.randint(0, e.cfg.vocab_size, (1, bucket),
                             device=e.device, dtype=torch.int32)
        prefill = e.graphs.prefill_fn(bucket)
        _profile(lambda: prefill(e.params, toks, bucket),
                 f"{kind}_prefill_{bucket}", 1, out_dir)
        print(f"profile {kind}: per decode step (B={b}, lengths {lens}) and "
              f"per {bucket}-token prefill ({card})")
        return
    g, c = 4, e.graphs.chunk
    group = e.graphs.chunk_group_fn(g)
    toks = torch.randint(0, e.cfg.vocab_size, (g, c), device=e.device,
                         dtype=torch.int32)
    offs = (np.arange(g) * c).astype(np.int32)
    lasts = np.full((g,), c - 1, dtype=np.int32)
    phys = np.full((g, c // e.ecfg.kv_block_size), e.pool.trash_block,
                   dtype=np.int32)
    _profile(lambda: group(e.params, e._pool_dict(), e._scratch, toks, offs,
                           lasts, phys), f"{kind}_prefill_chunk_{c}", g,
             out_dir)
    print(f"profile {kind}: per decode step (B={b}, lengths {lens}) and per "
          f"{c}-token prefill chunk ({card})")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    try:
        import tpu9_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the tpu9_torch package is not beside this script "
              f"({exc})", file=sys.stderr)
        return 1
    try:
        card = phase_card()
        # one source holds the three decode kernels, one the flash forward,
        # one its backward
        phase_build(["paged_decode_attention", "flash_attention",
                     "flash_attention_backward"])
        rows = phase_kernels()
        launches = {}
        profiling = "--profile" in sys.argv[1:]
        for kind in ENGINES:
            t_phase = time.perf_counter()
            launches[kind], engine = phase_engine(card, kind)
            if kind == "bf16":
                phase_sampled(engine, card)
            if kind in ("bf16", "int8"):
                phase_kv_motion(engine, card, kind)
            if kind in ("bf16", "int8", "dense"):
                launches[f"spec-{kind}"], spec = phase_spec(engine, card,
                                                            kind)
                if profiling:
                    profile_spec(spec, card, kind)
                del spec
            if kind in ("bf16", "int8"):
                launches[f"restore-{kind}"] = phase_restore(engine, card, kind)
                launches[f"tp-{kind}"] = phase_tp(engine, card, kind)
            # the MoE engines' window and chunk group are profiled on every
            # run: their phases serve no spec, KV-motion or restore phase
            if profiling or engine.cfg.n_experts:
                phase_profile(engine, card, kind)
            if kind == "bf16":
                # last: it leaves every slot holding blocks
                phase_bench_reset(engine, card)
            # free the engine before the next one loads
            del engine
            gc.collect()
            torch.cuda.empty_cache()
            print(f"phase {kind}: {time.perf_counter() - t_phase:.1f} s "
                  f"({card})")
        for kind, run in {**PORT_PHASES, **TRAIN_PHASES, **SHARD_PHASES,
                          **ENCODER_PHASES}.items():
            t_phase = time.perf_counter()
            launches[kind] = run(card)
            gc.collect()
            torch.cuda.empty_cache()
            print(f"phase {kind}: {time.perf_counter() - t_phase:.1f} s, "
                  f"{torch.cuda.memory_allocated() / 1e9:.2f} GB still "
                  f"allocated ({card})")
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    for row in rows:
        row["launches"] = launches[row["path"]][row["name"]]
    print(json.dumps({"kernels": rows}))
    from tpu9_torch.utils.platform import device_kind
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_kind(),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
