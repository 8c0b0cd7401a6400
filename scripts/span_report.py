#!/usr/bin/env python3
"""One benchmark run of a cell, then what the program's span recorder saw.

    python3 scripts/span_report.py --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1> [--out FILE]

Runs ``portbench.run`` in this process as the benchmark runs it (its JSON
line is printed as usual), then reads the rows of the newest span recorder
(``tpu9_torch/observability/spans.py``) inside the run's window: the
window between the two stats snapshots of a serving cell, the window's
open to its end in a training cell. It prints one JSON line (also written
to ``--out``):

- serving: the seconds between the snapshots; the device seconds of the
  ``window`` and ``admit`` units; the idle gaps by the phase they are put
  down to (``serve.park`` and ``unattributed`` among them); the partition
  (units + gaps) and its ratio to those seconds; the windows by pick reason
  and size (count, device ms a step); the host seconds by phase;
- training: the steps, the seconds a step (the window's open to its end
  over the steps run), each unit's median device ms and their sum's share
  of a step, and the host seconds by phase a step.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from portbench import run as prun  # noqa: E402
from portbench import serve, span_readers, train  # noqa: E402


def serving_report(run) -> dict:
    rows, secs = span_readers.serve_rows(run)
    units, gaps, host, picks = {}, {}, {}, {}
    for r in rows:
        for into, parts in ((units, r.units), (gaps, r.gaps),
                            (host, r.host)):
            for name, s in parts.items():
                into[name] = into.get(name, 0.0) + s
        n, span, steps = picks.get((r.pick, r.k), (0, 0.0, 0))
        picks[(r.pick, r.k)] = (n + 1, span + r.span_s, steps + r.k)
    part = sum(units.values()) + sum(gaps.values())
    return {"seconds": secs, "windows": len(rows), "unit_s": units,
            "gap_s": gaps, "partition_s": part,
            "partition_share": part / secs if secs else None,
            "unattributed_share": gaps.get("unattributed", 0.0) / secs
            if secs else None,
            "by_pick": {f"{pick}/k{k}": {"windows": n,
                                         "device_ms_a_step": span / st * 1e3}
                        for (pick, k), (n, span, st) in sorted(picks.items())},
            "host_s": host}


def training_report(run) -> dict:
    w = run.window
    rows = span_readers.rows_in("train", w["open"], w["end"])
    step_s = (w["end"] - w["open"]) / run.steps if run.steps else None
    names = sorted({n for r in rows for n in r.units})
    med = {n: statistics.median(r.units[n] for r in rows if n in r.units)
           for n in names}
    host = {n: statistics.median(r.host[n] for r in rows if n in r.host)
            for n in sorted({n for r in rows for n in r.host})}
    return {"steps": run.steps, "rows": len(rows), "step_s": step_s,
            "unit_median_s": med,
            "units_share_of_step": sum(med.values()) / step_s
            if step_s and med else None,
            "host_median_s": host}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", default="")
    args, rest = p.parse_known_args(argv)
    seen = {}
    for mod in (serve, train):
        def keep(*a, _run=mod.run, **kw):
            seen["run"] = _run(*a, **kw)
            return seen["run"]
        mod.run = keep
    rc = prun.main(rest)
    run = seen.get("run")
    if run is None:
        return rc or 1
    report = serving_report(run) if run.kind == "serve" \
        else training_report(run)
    line = json.dumps({"span_report": report})
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return rc


if __name__ == "__main__":
    sys.exit(main())
