"""``python -m tpu9_torch.analysis.graphcheck``: Pass A over the matrix and
Pass B over ``tpu9_torch/``.

Exit codes: 0 clean, 1 findings, 2 an unknown cell. The reference's exit
code 3 (no forced 8-device CPU mesh) and its ``--no-compile`` have no
counterpart: the ranks here are one process's tensors on fake CUDA
devices, so no device count can run short, and there is no compiled
artifact apart from the trace (an executable's aliasing and input
shardings are what the reference compiles for; the in-place and shard
checks read the trace).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tpu9_torch.analysis.graphcheck",
        description="static verification of sharding, dtype and in-place "
                    "invariants in the port's serving computations")
    ap.add_argument("--cell", action="append", default=None,
                    help="run only this matrix cell (repeatable); default: "
                         "the full matrix")
    ap.add_argument("--list-cells", action="store_true")
    ap.add_argument("--no-lint", action="store_true",
                    help="skip Pass B (the AST rules)")
    ap.add_argument("--format", choices=("text", "json"), default="text",
                    help="report format (json: the finding schema shared "
                         "with the reference)")
    args = ap.parse_args(argv)

    from .matrix import MATRIX, find_cells
    if args.list_cells:
        for c in MATRIX:
            print(c.name)
        return 0
    try:
        cells = find_cells(args.cell)
    except KeyError as exc:
        print(f"graphcheck: {exc}", file=sys.stderr)
        return 2

    from ..findings import JSON_SCHEMA_VERSION, finding_json
    from . import passes
    from .astrules import lint_tree
    report = passes.run_matrix(cells)
    graph_findings = list(report["findings"])
    lint = [] if args.no_lint else lint_tree(
        Path(__file__).resolve().parents[3])
    if args.format == "json":
        print(json.dumps({
            "version": JSON_SCHEMA_VERSION,
            "tool": "graphcheck",
            "cells": report["cells"],
            "elapsed_s": report["elapsed_s"],
            "findings": [finding_json(f, "graph") for f in graph_findings]
            + [finding_json(f, "new") for f in lint],
        }, indent=1))
    else:
        for f in graph_findings + lint:
            print(f.format())
        cells_s = ", ".join(f"{s['cell']}({s['jobs']} graphs, "
                            f"{s['elapsed_s']}s)" for s in report["cells"])
        print(f"graphcheck: {len(report['cells'])} cells in "
              f"{report['elapsed_s']}s: {len(graph_findings) + len(lint)} "
              f"findings ({len(lint)} from Pass B)")
        print(f"  {cells_s}")
    return 1 if graph_findings or lint else 0


if __name__ == "__main__":
    sys.exit(main())
