#!/usr/bin/env python3
"""Cold start of a restored engine, serial against compile-ahead, in turns,
on one CUDA device.

    python3 scripts/coldstart_overlap.py [PRESET] [--reps N]

Builds the kernels, draws the preset's weights from seed 0 (default
``llama3-8b``; ``llama3-8b-int8`` takes the int8 pool), serves the
reference prompt of ``chip_smoke.py`` from them for the tokens every cold
start must serve, and saves them as ``.tpu9w`` shards under
``build/coldstart-overlap/``. Then:

- ``precompile()`` alone, on the calling thread and on fresh threads, each
  on a fresh engine over zero-filled weights: the wall against the
  thread's own CPU time (``time.thread_time``), and the three windows'
  capture seconds;
- ``--reps`` rounds (default 3) of three cold starts, each one wall from
  its start to the first token over a restore after the shards' pages are
  dropped (``chip_smoke._drop_pages``): ``serial`` (restore, an engine
  over the tree, warmup), ``ahead`` (an engine on ``params_spec``
  precompiles on a thread while the calling thread restores, as
  ``chip_smoke.py``'s restore phase runs it) and ``ahead-caller`` (the
  same with the roles swapped: the restore on a thread, the captures on
  the calling thread). Each line gives the restore's seconds, ``fetch_s``
  and ``put_s``, the precompile's wall and CPU seconds and the captures.

Every cold start must serve the reference tokens. Prints the card's name
and power limit first; the shards are deleted at the end.
"""

from __future__ import annotations

import gc
import os
import shutil
import sys
import threading
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def caps(engine) -> dict:
    return {k: round(v, 3) for k, v in engine.graphs.capture_s.items()}


def free() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    args = sys.argv[1:]
    reps = 3
    if "--reps" in args:
        i = args.index("--reps")
        reps = int(args[i + 1])
        del args[i:i + 2]
    preset = args[0] if args else "llama3-8b"
    if not torch.cuda.is_available():
        print("coldstart_overlap: needs a CUDA device", file=sys.stderr)
        return 1
    from tpu9_torch.runner import ckpt
    from tpu9_torch.serving import weights as wfmt
    from tpu9_torch.serving.engine import InferenceEngine
    from tpu9_torch.serving.presets import load_engine, params_spec

    card = cs.phase_card()
    cs.phase_build(["paged_decode_attention", "flash_attention"])
    knobs = {"kv_quant": "int8"} if preset.endswith("-int8") else {}
    live = load_engine(preset, device=cs.DEVICE, max_batch=8,
                       max_seq_len=2048, seed=0, **knobs)
    live.warmup()
    prompt = cs.make_prompts(live.cfg.vocab_size, seed=1)[2][:127]
    want, *_ = cs._serve_alone(live, prompt, count=False)
    spec, cfg = params_spec(preset)
    ecfg = live.ecfg
    workdir = ROOT / "build" / "coldstart-overlap"
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    os.environ["TPU9_WORKDIR"] = str(workdir)
    try:
        path = ckpt.save_params(live.params)
        index = wfmt.read_index(path)
        del live
        free()
        print(f"{preset}: {index['total_bytes'] / 1e9:.3f} GB saved ({card})",
              flush=True)

        for i, where in enumerate(("caller", "thread", "caller", "thread")):
            engine = InferenceEngine(spec, cfg, ecfg, device=cs.DEVICE)
            out: dict = {}

            def run():
                t0, c0 = time.perf_counter(), time.thread_time()
                engine.precompile()
                out["wall"] = time.perf_counter() - t0
                out["cpu"] = time.thread_time() - c0
            if where == "caller":
                run()
            else:
                th = threading.Thread(target=run)
                th.start()
                th.join()
            print(f"alone {i} on the {where}: precompile {out['wall']:.3f} s"
                  f", its thread's cpu {out['cpu']:.3f} s, captures "
                  f"{caps(engine)} ({card})", flush=True)
            del engine
            free()

        def served(engine, t0: float, label: str, detail: str) -> None:
            got, _, _, _, t_at = cs._serve_alone(engine, prompt, count=False)
            cs.check(got == want, f"{label}: served {got}, want {want}")
            print(f"{label}: {t_at - t0:.3f} s to the first token; {detail}; "
                  f"captures {caps(engine)}; peak memory "
                  f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB ({card})",
                  flush=True)

        def serial(label: str) -> None:
            free()
            drop = cs._drop_pages(path, index)
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            tree, st = cs._stream_restore(path, index, drop["direct"])
            t_r = time.perf_counter() - t0
            engine = InferenceEngine(tree, cfg, ecfg, device=cs.DEVICE)
            engine.warmup()
            served(engine, t0, label, f"restore {t_r:.3f} s (fetch_s "
                   f"{st['fetch_s']}, put_s {st['put_s']})")

        def ahead(label: str, compile_on_thread: bool) -> None:
            free()
            drop = cs._drop_pages(path, index)
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            engine = InferenceEngine(spec, cfg, ecfg, device=cs.DEVICE)
            res: dict = {}

            def compile_() -> None:
                a, c0 = time.perf_counter(), time.thread_time()
                engine.precompile()
                res["c"] = time.perf_counter() - a
                res["cpu"] = time.thread_time() - c0

            def load() -> None:
                a = time.perf_counter()
                res["tree"], res["st"] = cs._stream_restore(path, index,
                                                            drop["direct"])
                res["r"] = time.perf_counter() - a
            side, own = (compile_, load) if compile_on_thread \
                else (load, compile_)
            th = threading.Thread(target=side, name="tpu9-compile-ahead"
                                  if compile_on_thread else "tpu9-restore")
            th.start()
            own()
            th.join()
            cs.check("tree" in res and "c" in res, f"{label}: a side failed")
            engine.bind_params(res.pop("tree"))
            engine.warmup()
            st = res["st"]
            served(engine, t0, label, f"restore {res['r']:.3f} s (fetch_s "
                   f"{st['fetch_s']}, put_s {st['put_s']}) beside precompile "
                   f"{res['c']:.3f} s (its thread's cpu {res['cpu']:.3f} s)")

        for rnd in range(reps):
            ahead(f"ahead {rnd}", compile_on_thread=True)
            ahead(f"ahead-caller {rnd}", compile_on_thread=False)
            serial(f"serial {rnd}")
            free()
    except cs.SmokeFailure as exc:
        print(f"coldstart_overlap: FAILED: {exc}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
