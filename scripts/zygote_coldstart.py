#!/usr/bin/env python3
"""Cold starts of the port's serving child three ways, in turns, on one GPU:
forked from a zygote that also preloads a module loading the built kernel
libraries (``chip_smoke.KERNEL_PRELOAD``, by ``dlopen``), forked from the
plain zygote, and run by a fresh interpreter.

    python3 scripts/zygote_coldstart.py [--reps N]

Each run is ``chip_smoke.ZYGOTE_CHILD``: llama3-8b paged bf16 at full
width and depth (random weights, seed 0, compile-ahead), four greedy
requests of 128-1024 tokens, 32 new tokens each. The order is A B B A
E E for one rep (A: with the kernels loaded, B: the plain zygote, E:
exec'd), reversed for the next. For each run it prints the seconds from
the spawn to the child's module start, its engine's readiness and its
first token, and the child's own time to load the two kernel libraries (a
cache hit where the zygote loaded them). Every run must give the same tokens and
the same launches, as ``chip_smoke.py``'s zygote phase checks them. About
2.5 minutes for one rep, the kernels' build included.
"""

from __future__ import annotations

import argparse
import shutil
import sys
import tempfile
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=1)
    args = ap.parse_args()
    card = cs.phase_card()
    cs.phase_build(list(cs.ZYGOTE_KERNELS))
    order = ("zygote-kernels", "zygote", "zygote", "zygote-kernels", "exec",
             "exec")
    runs = []
    work = Path(tempfile.mkdtemp(prefix="zygote-", dir=cs.ROOT / "build"))
    try:
        for rep in range(args.reps):
            runs += cs.zygote_runs(work, order if rep % 2 == 0
                                   else order[::-1], card)
    except cs.SmokeFailure as exc:
        print(f"zygote_coldstart: FAILED: {exc}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(work, ignore_errors=True)
    want = runs[0][1]
    for label, res, _ in runs:
        if res["tokens"] != want["tokens"] or \
                res["launches"] != want["launches"]:
            print(f"zygote_coldstart: {label} differs from the first run",
                  file=sys.stderr)
            return 1
    for label in dict.fromkeys(label for label, _, _ in runs):
        mine = [(res, t) for lab, res, t in runs if lab == label]
        first = [res["first"] - t for res, t in mine]
        ready = [res["ready"] - t for res, t in mine]
        load = [res["kernel_load_s"] * 1e3 for res, _ in mine]
        print(f"{label}: first token {['%.3f' % x for x in first]} s "
              f"(median {np.median(first):.3f}), engine ready "
              f"{['%.3f' % x for x in ready]} s, kernel libraries "
              f"{['%.2f' % x for x in load]} ms ({card})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
