#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``tpu9_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Phases, each of which must pass or the script exits non-zero:

1. card: the GPU's name and power limit (``nvidia-smi``), torch and CUDA
   versions;
2. build: compiles every CUDA kernel of the main path from
   ``tpu9_torch/csrc`` with ``nvcc`` (one process per source, in parallel);
3. kernels: each kernel against its plain PyTorch twin at the shapes the
   main path gives it, with table entries past every prefix pointing at
   NaN-filled pool blocks; times the kernel, the twin and one library call
   with CUDA events;
4. engine: ``load_engine("llama3-8b", device="cuda")`` at full width in
   bf16 (random weights from a seed), ``warmup()``, six concurrent
   ``generate`` requests (two share a 512-token prefix), a repeated greedy
   prompt, and a check of the generated tokens against a plain no-cache
   forward. The kernel launch counts are zeroed just before this phase and
   must equal ``n_layers x decode steps`` just after.

With ``--profile`` a fifth phase profiles one decode window and one fused
admission group with ``torch.profiler`` (wall and device-busy time, top
kernels; full tables under ``build/profile/``).

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. It needs a CUDA device and the rest of
the repository beside it; without either it exits non-zero and prints no
result.
"""

from __future__ import annotations

import asyncio
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
BF16_FLOP_PER_S = 989e12           # H100 SXM dense bf16 tensor-core peak
L2_FLUSH_BYTES = 256 << 20         # larger than the 50 MB L2


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

def phase_build(kernels: list[str]) -> None:
    from tpu9_torch.ops import _build
    t0 = time.perf_counter()
    logs = _build.build_all(kernels)
    print(f"build: {time.perf_counter() - t0:.2f} s for {kernels} "
          f"({len(logs)} compiled)")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"  ptxas {name}: {line.strip()}")


# -- phase 3: kernels against their twins -------------------------------------

def time_ms(fn, iters: int = 60) -> float:
    """Median device time of one call, CUDA events around each launch, with
    the L2 cache flushed before every launch (a decode step finds each
    layer's pool cold)."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def paged_case(batch: int, q_heads: int, kv_heads: int, head_dim: int,
               block_s: int, max_blocks: int, lens: list[int], seed: int):
    """Decode operands on the card: each sequence gets ceil(len/BS) distinct
    pool blocks, and every table entry past its prefix names a pool block
    filled with NaN."""
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
    dev = "cuda"
    q = torch.from_numpy(rng.standard_normal((batch, 1, q_heads, head_dim),
                                             dtype=np.float32)).to(dev, torch.bfloat16)
    shape = (n_blocks, block_s, kv_heads, head_dim)
    k = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev, torch.bfloat16)
    v = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev, torch.bfloat16)
    k[poison] = float("nan")
    v[poison] = float("nan")
    return dict(q=q, k=k, v=v, table=torch.from_numpy(table).to(dev),
                lens=torch.tensor(lens, dtype=torch.int32, device=dev),
                poison=torch.from_numpy(poison).to(dev))


def paged_bound(case, lens: list[int]) -> tuple[float, str]:
    """Least time for the work this case's data needs: each valid k/v row
    read once, q read and the output written once, the valid table entries
    and lengths read once; 4 flops per (query head, dim, position)."""
    q = case["q"]
    _, _, q_heads, head_dim = q.shape
    _, block_s, kv_heads, _ = case["k"].shape
    positions = sum(lens)
    n_bytes = (positions * kv_heads * head_dim * 2 * 2
               + 2 * q.numel() * 2
               + sum(-(-n // block_s) for n in lens) * 4 + len(lens) * 4)
    flops = 4 * positions * q_heads * head_dim
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sdpa_over_dense(case, k_dense, v_dense):
    """``F.scaled_dot_product_attention`` over the already densified cache:
    the yardstick ``library_ms``. The port never calls it."""
    import torch.nn.functional as F
    q = case["q"].transpose(1, 2)                      # [B, QH, 1, D]
    k = k_dense.transpose(1, 2).contiguous()           # [B, KH, S, D]
    v = v_dense.transpose(1, 2).contiguous()
    s = k.shape[2]
    mask = (torch.arange(s, device="cuda")[None, :]
            < case["lens"][:, None].long())[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  enable_gqa=True)


def phase_paged_kernel(label: str, head_dim: int) -> dict:
    from tpu9_torch.ops.paged_attention import (gather_paged,
                                                paged_decode_attention,
                                                xla_paged_decode_attention)
    lens = [1, 127, 128, 129, 1000, 2048, 513, 1777]
    case = paged_case(batch=8, q_heads=32, kv_heads=8, head_dim=head_dim,
                      block_s=128, max_blocks=2048 // 128 + 1, lens=lens,
                      seed=head_dim)
    q, k, v, table, clen = (case[n] for n in ("q", "k", "v", "table", "lens"))
    before = paged_decode_attention.launches
    got = paged_decode_attention(q, k, v, table, clen)
    torch.cuda.synchronize()
    check(paged_decode_attention.launches == before + 1,
          "paged_decode_attention did not launch its kernel")
    # the twin densifies every table entry, so it runs on a copy of the
    # pool whose NaN blocks are zeroed (they are masked either way)
    k_clean, v_clean = k.clone(), v.clone()
    k_clean[case["poison"]] = 0
    v_clean[case["poison"]] = 0
    want = xla_paged_decode_attention(q, k_clean, v_clean, table, clen)
    check(bool(torch.isfinite(got).all()),
          f"{label}: kernel output not finite (read a block past a prefix?)")
    err = (got.float() - want.float()).abs()
    # both round an f32 result to bf16; results that differ only in f32
    # summation order round at most one bf16 ulp apart (2^-7 relative),
    # and outputs near zero keep an absolute slack of 1e-4
    limit = 2.0 ** -7 * want.float().abs() + 1e-4
    max_err = float(err.max())
    print(f"kernel paged_decode_attention [{label}]: max_abs_err {max_err:.3e} "
          f"(tolerance |err| <= 2^-7*|twin| + 1e-4: one bf16 ulp of rounding "
          f"an f32 result whose summation order differs)")
    check(bool((err <= limit).all()), f"{label}: kernel disagrees with its twin "
          f"(max abs err {max_err})")

    ms = time_ms(lambda: paged_decode_attention(q, k, v, table, clen))
    plain_ms = time_ms(lambda: xla_paged_decode_attention(q, k_clean, v_clean,
                                                          table, clen))
    library_ms = time_ms(sdpa_over_dense(case, gather_paged(k_clean, table),
                                         gather_paged(v_clean, table)))
    bound_ms, bound_by = paged_bound(case, lens)
    print(f"kernel paged_decode_attention [{label}]: {ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}, {bound_ms / ms:.1%} of it), plain "
          f"twin {plain_ms:.4f} ms, sdpa over dense cache {library_ms:.4f} ms")
    return {"name": "paged_decode_attention", "route": "cuda",
            "source": "tpu9_torch/csrc/paged_decode_attention.cu",
            "replaces": "tpu9/ops/paged_attention.py:176",
            "shape": label, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


# -- phase 4: the engine at full width ----------------------------------------

PRESET = "llama3-8b"
DEVICE = "cuda"
MAX_NEW = 64


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
                    n_check: int = 8) -> float:
    """Hold the engine's greedy tokens (chunked prefill + paged decode
    through the kernel) against a plain no-cache forward over prompt +
    generated. Both paths round in bf16 at different places, so a token
    passes when it is the reference argmax or its reference logit is within
    1% of the reference logit range of the maximum. Returns the worst
    relative gap."""
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
    return worst


def phase_engine(card: str) -> dict:
    from tpu9_torch.ops.paged_attention import paged_decode_attention
    from tpu9_torch.serving.presets import load_engine

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = load_engine(PRESET, device=DEVICE, max_batch=8, max_seq_len=2048,
                         seed=0)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine.warmup()
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    cfg = engine.cfg
    print(f"engine: {PRESET} {cfg.dtype} dim {cfg.dim} layers {cfg.n_layers} heads "
          f"{cfg.n_heads}/{cfg.n_kv_heads} vocab {cfg.vocab_size}; block "
          f"{engine.ecfg.kv_block_size} chunk {engine.ecfg.prefill_chunk} pool "
          f"{engine.pool.n_blocks} blocks; load {t_load:.2f} s, warmup "
          f"{t_warm:.2f} s")
    prompts = make_prompts(cfg.vocab_size, seed=1)
    repeat = prompts[5]
    ref_prompt = prompts[2][:127]       # 127 tokens: the plain no-cache path

    async def main_path():
        await engine.start()
        try:
            steps0 = engine.stats()["decode_steps"]
            paged_decode_attention.launches = 0
            outs, t_submit, t_firsts, t_end = await _serve(engine, prompts,
                                                           MAX_NEW)
            rep_a = await engine.generate(repeat, max_new_tokens=32)
            rep_b = await engine.generate(repeat, max_new_tokens=32)
            ref_out = await engine.generate(ref_prompt, max_new_tokens=8)
            launches = paged_decode_attention.launches
            steps = engine.stats()["decode_steps"] - steps0
            stats = engine.stats()
        finally:
            await engine.stop()
        return outs, t_submit, t_firsts, t_end, rep_a, rep_b, ref_out, \
            launches, steps, stats

    (outs, t_submit, t_firsts, t_end, rep_a, rep_b, ref_out, launches, steps,
     stats) = asyncio.run(main_path())
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    for p, out in zip(prompts, outs):
        check(len(out) == MAX_NEW, f"a request returned {len(out)} tokens, "
              f"expected {MAX_NEW}")
        check(all(0 <= t < cfg.vocab_size for t in out), "token id out of range")
    check(rep_a == rep_b, f"repeated greedy prompt differs: {rep_a} vs {rep_b}")
    check(stats["prefix_cache"]["hits"] >= 1, "prefix reuse never ran")
    check(launches > 0, "the paged decode kernel never launched")
    check(launches == cfg.n_layers * steps,
          f"kernel launches {launches} != n_layers {cfg.n_layers} x decode "
          f"steps {steps}")
    worst = reference_check(engine, ref_prompt, ref_out)

    ttft = sorted(t - t_submit for t in t_firsts)
    n_tokens = sum(len(o) for o in outs)
    decode_tokens = n_tokens - len(outs)
    decode_tps = decode_tokens / (t_end - min(t_firsts))
    print(f"engine: {len(prompts)} requests, prompt lengths "
          f"{[len(p) for p in prompts]}, {MAX_NEW} new tokens each")
    print(f"engine: ttft p50 {np.median(ttft):.4f} s, max {ttft[-1]:.4f} s; "
          f"decode {decode_tps:.1f} tokens/s ({decode_tokens} tokens after the "
          f"first of each request, from the first first-token to the end); "
          f"all {n_tokens} tokens in {t_end - t_submit:.3f} s")
    print(f"engine: peak memory {peak_gb:.2f} GB; prefix cache "
          f"{stats['prefix_cache']}; repeat identical; reference worst gap "
          f"{worst:.3%} of logit range")
    print(f"engine: paged_decode_attention launches {launches} = "
          f"{cfg.n_layers} layers x {steps} decode steps ({card})")
    return {"paged_decode_attention": launches}, engine


# -- optional phase 5 (--profile): where the engine's time goes ---------------

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


def phase_profile(engine, card: str) -> None:
    """A decode window of 8 steps with all 8 lanes live at the engine
    phase's prompt lengths (each lane on its own pool blocks), and one fused
    admission group of 4 chunks, each profiled. Per-kernel tables go to
    ``build/profile/``."""
    e = engine
    out_dir = ROOT / "build" / "profile"
    out_dir.mkdir(parents=True, exist_ok=True)
    b, mb = e.ecfg.max_batch, e.pool.mb
    per_row = mb - 1                                # the last column is trash
    check(1 + b * per_row <= e.pool.n_blocks, "pool too small to profile")
    table = torch.zeros((b, mb), dtype=torch.int32, device=e.device)
    table[:, :per_row] = 1 + torch.arange(
        b * per_row, dtype=torch.int32, device=e.device).reshape(b, per_row)
    lens = [600, 1212, 128, 1536, 777, 1000, 1800, 400]
    kv = dict(e.kv_cache, table=table)
    cache_len = torch.tensor(lens, dtype=torch.int32, device=e.device)
    active = torch.ones((b,), dtype=torch.bool, device=e.device)
    last = torch.zeros((b, 1), dtype=torch.int32, device=e.device)
    k = 8
    window = e.graphs.build_decode(k)
    _profile(lambda: window(e.params, kv, last, cache_len, active, e._gen),
             f"decode_step_B{b}", k, out_dir)
    g, c = 4, e.graphs.chunk
    group = e.graphs.chunk_group_fn(g)
    toks = torch.randint(0, e.cfg.vocab_size, (g, c), device=e.device,
                         dtype=torch.int32)
    offs = (np.arange(g) * c).astype(np.int32)
    lasts = np.full((g,), c - 1, dtype=np.int32)
    phys = np.full((g, c // e.ecfg.kv_block_size), e.pool.trash_block,
                   dtype=np.int32)
    _profile(lambda: group(e.params, e._pool_dict(), e._scratch, toks, offs,
                           lasts, phys), f"prefill_chunk_{c}", g, out_dir)
    print(f"profile: per decode step (B={b}, lengths {lens}) and per "
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
        phase_build(["paged_decode_attention"])
        # one row per kernel, at the main path's shapes; the llama-1b
        # head_dim is checked and printed beside it
        rows = [phase_paged_kernel("llama3-8b decode B=8 QH=32 KH=8 D=128 "
                                   "BS=128 MB=17", 128)]
        phase_paged_kernel("llama-1b decode B=8 QH=32 KH=8 D=64 BS=128 MB=17",
                           64)
        launches, engine = phase_engine(card)
        if "--profile" in sys.argv[1:]:
            phase_profile(engine, card)
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    for row in rows:
        row["launches"] = launches[row["name"]]
    print(json.dumps({"kernels": rows}))
    from tpu9_torch.utils.platform import device_kind
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_kind(),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
