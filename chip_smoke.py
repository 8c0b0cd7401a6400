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
   at D 64, 128, 256) and a combine pass (D 64, 128, 256); the other the
   flash kernel's six instances, D 64, 128 and 256, causal or not),
   prints each instance's registers and spills from ``ptxas -v`` and any
   ``ptxas`` note on serialised ``wgmma`` products, and fails if an
   instance a served model runs spills: (G=4, D=128) of the decode kernels
   and D=128 flash (llama3-8b), (G=1, D=256) of the bf16-pool and
   contiguous decode kernels and D=256 flash (gemma-7b), (G=8, D=256) of
   the int8-pool kernel (gemma-2b);
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
   whose sequence after the last is NaN; times the kernel, the twin and
   one library call with CUDA events, as a host-bound step sees them and
   on the device alone, and the kernel wrapper's host time per call,
   beside the bound;
4. engine, bf16: ``load_engine("llama3-8b", device="cuda")`` at full width
   (random weights from a seed), ``warmup()`` (which captures each decode
   window size as a CUDA graph: the three must be captured), six
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
   pool, GQA group 8) and ``load_engine("gemma-7b", paged=False)``.

The kernel launch counts are zeroed just before each engine phase's
requests and read just after: each decode kernel of the phase's path must
have launched ``n_layers x decode steps`` times (a replayed window adds the
launches its capture counted), the flash kernel (dense path)
``n_layers x prefills``, and every other kernel never.

With ``--profile``, one replay of each engine's captured 8-step decode
window and one fused admission group of each paged engine (one bucket-2048
prefill of the dense engine) are profiled with ``torch.profiler`` (wall and
device-busy time, top kernels; full tables under ``build/profile/``).

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. It needs a CUDA device and the rest of
the repository beside it; without either it exits non-zero and prints no
result.
"""

from __future__ import annotations

import asyncio
import gc
import json
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
# the decode instances the served models run, which must not spill:
# llama3-8b (G = 4, D = 128), gemma-7b (G = 1, D = 256; bf16 pool and
# contiguous cache) and gemma-2b-int8 (G = 8, D = 256, int8 pool)
NO_SPILL = {("bf16", "Table", 4, 128), ("int8", "Table", 4, 128),
            ("bf16", "Contiguous", 4, 128), ("bf16", "Table", 1, 256),
            ("bf16", "Contiguous", 1, 256), ("int8", "Table", 8, 256)}
# the flash instances of llama3-8b's and gemma-7b's prefill (causal or not)
FLASH_NO_SPILL = {(128, True), (128, False), (256, True), (256, False)}


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
    seen, flash_seen = set(), set()
    for source, log in logs.items():
        for line in log.splitlines():
            # warnings, and ptxas's notes on serialised wgmma products
            if "warning" in line.lower() or "wgmma" in line:
                print(f"  nvcc {source}: {line.strip()}")
        for name, info in sorted(ptxas_report(log).items()):
            m = PTXAS_SPLIT.search(name)
            f = PTXAS_FLASH.search(name)
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
            print(f"  ptxas {source}: {label}: {info.get('registers')} "
                  f"registers, spill stores/loads {info.get('spills')}")
    if "paged_decode_attention" in logs:
        check(seen == NO_SPILL, f"ptxas reported no served decode instance "
              f"of {sorted(NO_SPILL - seen)}")
    if "flash_attention" in logs:
        check(flash_seen == FLASH_NO_SPILL, f"ptxas reported no served flash "
              f"instance of {sorted(FLASH_NO_SPILL - flash_seen)}")


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
    "ragged_decode_attention": ("tpu9/ops/paged_attention.py:93",
                                DECODE_SRC),
}


def wrapper(name: str):
    """The port's wrapper of a kernel of ``KERNELS``; it counts launches."""
    from tpu9_torch.ops import attention, paged_attention
    return getattr(attention if name == "flash_attention" else
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
                      seed: int, heads: tuple[int, int] = LLAMA_HEADS
                      ) -> dict:
    """The kernel call, its twin and the twin's result, the densified cache
    for the library call, and the bound, for one paged case with ``heads``
    = (q heads, kv heads)."""
    from tpu9_torch.ops import paged_attention as pa
    quant = name.endswith("_quant")
    launcher = wrapper(name)
    case = paged_case(batch=batch, q_heads=heads[0], kv_heads=heads[1],
                      head_dim=head_dim, block_s=128,
                      max_blocks=2048 // 128 + 1, lens=lens, seed=seed,
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
                       heads: tuple[int, int] = LLAMA_HEADS) -> dict:
    seed = head_dim + batch + sum(heads) - 48          # llama's: D + B - 8
    if name == "ragged_decode_attention":
        return ragged_kernel_case(head_dim, lens, seed=100 + seed,
                                  heads=heads)
    return paged_kernel_case(name, batch, head_dim, lens, seed=seed,
                             heads=heads)


def phase_decode_kernel(name: str, label: str, head_dim: int,
                        batch: int = 8, lens: list[int] = PAGED_LENS,
                        heads: tuple[int, int] = LLAMA_HEADS) -> dict:
    """One decode kernel at one shape: launched once, checked finite over
    the poisoned blocks (NaN positions) and against its twin, then timed
    beside the twin, one library call and its bound."""
    c = decode_kernel_case(name, batch, head_dim, lens, heads)
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
            keep(phase_decode_kernel(
                name, f"llama3-8b {what.format(n)} QH=32 KH=8 D=128 {bs}",
                128, batch=batch, lens=lens), llama_paths[name])
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
    return rows


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
}


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


def reference_check(engine, prompt: list[int], generated: list[int],
                    n_check: int = 8) -> tuple[float, int]:
    """Hold the engine's greedy tokens (chunked prefill + paged decode
    through the kernel) against a plain no-cache forward, over the same
    weights, of prompt + generated. Both paths round in bf16 at different
    places, and an int8 pool adds the noise of its quantized KV, which the
    reference's dense bf16 KV does not have: so a token passes when it is
    the reference argmax or its reference logit is within 1% of the
    reference logit range of the maximum. Tokens are judged up to and
    including the first one that is not the reference argmax (a fork), as
    ``tests/test_quant_serving.py`` judges forks. Returns the worst
    relative gap and the index of the fork (-1 for none)."""
    from tpu9_torch.models.transformer import decoder_forward
    seq = prompt + generated[:n_check]
    tokens = torch.tensor([seq], dtype=torch.int64, device=engine.device)
    with torch.no_grad():
        logits = decoder_forward(engine.params, tokens, engine.cfg)[0].float()
    worst = 0.0
    for i in range(n_check):
        row = logits[len(prompt) - 1 + i]
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


def phase_engine(card: str, kind: str):
    """Serve the six prompts, the repeat and the reference prompt through
    the ``kind`` engine of ``ENGINES``, then check the runner's surface;
    returns (its kernels' launches, the engine)."""
    from tpu9_torch.ops.quant import quantized_bytes
    from tpu9_torch.serving.paged_kv import kv_block_bytes
    from tpu9_torch.serving.presets import load_engine

    preset, knobs, path_kernels = ENGINES[kind]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = load_engine(preset, device=DEVICE, max_batch=8, max_seq_len=2048,
                         seed=0, **knobs)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine.warmup()
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    cfg, ecfg = engine.cfg, engine.ecfg
    check(engine.paged == knobs.get("paged", True), f"the {kind} engine has "
          f"paged={engine.paged}")
    if preset.endswith("-int8"):
        check(engine.params["layers"][0]["wq"]["q"].dtype == torch.int8,
              "the int8 preset did not build int8 weights")
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
    print(f"engine {kind}: {preset} {cfg.dtype} dim {cfg.dim} layers "
          f"{cfg.n_layers} heads {cfg.n_heads}/{cfg.n_kv_heads} vocab "
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
    lens = [600, 1212, 128, 1536, 777, 1000, 1800, 400]
    if e.paged:
        mb = e.pool.mb
        per_row = mb - 1                            # the last column is trash
        check(1 + b * per_row <= e.pool.n_blocks, "pool too small to profile")
        table = e.kv_cache["table"]
        table.zero_()
        table[:, :per_row] = 1 + torch.arange(
            b * per_row, dtype=torch.int32, device=e.device).reshape(b, per_row)
    # five replays of 8 steps keep every lane inside its 2048 positions
    e.cache_len.copy_(torch.tensor(lens, dtype=torch.int32))
    e._active_dev.fill_(True)
    e.last_token.zero_()
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
        # one source holds the three decode kernels, the other the flash one
        phase_build(["paged_decode_attention", "flash_attention"])
        rows = phase_kernels()
        launches = {}
        for kind in ENGINES:
            launches[kind], engine = phase_engine(card, kind)
            if kind == "bf16":
                phase_sampled(engine, card)
            if "--profile" in sys.argv[1:]:
                phase_profile(engine, card, kind)
            # free the engine before the next one loads
            del engine
            gc.collect()
            torch.cuda.empty_cache()
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
