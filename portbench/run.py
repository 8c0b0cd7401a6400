"""One run of one cell of the benchmark of ``tpu9_torch``:

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. It reads ``BENCHMARK.json``, finds the cell,
its configuration file and its mix (``portbench/mixes/<traffic>.json``),
builds and warms the system, measures for ``--seconds``, checks what the
timed path produced against the plain reference, and prints one JSON
line: the cell's end-to-end metrics (``--trace 0``) or its per-layer
metrics (``--trace 1``), each read by its own file under
``portbench/end_to_end/`` or ``portbench/layer_metrics/``. It exits
non-zero without a result when the cell's cards are missing, or when the
JAX package or JAX is loaded once the window has closed."""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "tpu9")
# build and kernel caches at fixed paths inside the checkout: only a
# checkout's first run builds
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": "build/portbench/torch_extensions",
              "TRITON_CACHE_DIR": "build/portbench/triton",
              "CUDA_CACHE_PATH": "build/portbench/cuda"}


def load_spec() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def find_cell(spec: dict, name: str) -> tuple:
    cells = {c["name"]: c for c in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; have {sorted(cells)}")
    cell = cells[name]
    conf_entry = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    conf = json.loads((ROOT / conf_entry["file"]).read_text())
    mix = json.loads((HERE / "mixes" / f"{cell['traffic']}.json").read_text())
    return cell, conf, mix


def applies(metric: dict, cell: dict) -> bool:
    return "workloads" not in metric or cell["name"] in metric["workloads"]


def reader(kind: str, name: str):
    """The ``read(run)`` function of ``portbench/<kind>/<name>.py``, or,
    where there is no such file, of the reader of its quantity, the name
    up to its first dot (``device_idle_pct.batch`` is read by
    ``device_idle_pct.py``)."""
    path = HERE / kind / f"{name}.py"
    if not path.exists():
        path = HERE / kind / f"{name.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name}".replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def loaded_forbidden() -> list:
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def metrics(spec: dict, cell: dict, run, trace: bool) -> dict:
    kind, key = (("layer_metrics", "per_layer") if trace
                 else ("end_to_end", "end_to_end"))
    out = {}
    for metric in spec[key]:
        if not applies(metric, cell):
            continue
        value = reader(kind, metric["name"])(run)
        if value is not None:
            out[metric["name"]] = {"value": value, "unit": metric["unit"]}
    return out


def result(spec: dict, cell: dict, run, args) -> dict:
    import torch
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": cell["chips"], "memory_peak_bytes": run.memory_peak_bytes}
    out = {"correct": run.checks["correct"], "attempted": run.attempted,
           "failed": run.failed,
           "metrics": metrics(spec, cell, run, bool(args.trace)),
           "device": dev}
    if args.trace and run.slice is not None:
        dev["busy_s"] = run.slice.busy_s
        dev["window_s"] = run.slice.window_s
        out["breakdown"] = run.slice.breakdown()
    out["checks"] = run.checks["numbers"]
    return out


def main(argv=None) -> int:
    args = parse(argv)
    spec = load_spec()
    cell, conf, mix = find_cell(spec, args.workload)
    for var, rel in CACHE_DIRS.items():
        os.environ[var] = str(ROOT / rel)
        (ROOT / rel).mkdir(parents=True, exist_ok=True)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    import torch
    chips = cell["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); this "
              f"machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    cell_kind = importlib.import_module(f"portbench.{mix['kind']}")
    run = cell_kind.run(cell, conf, mix, args, T_START)
    out = result(spec, cell, run, args)
    print(f"portbench: {out['device']['kind']}, power limit "
          f"{power_limit()}; setup {run.setup_s:.3f} s; generator late by "
          f"at most {max(run.window.get('lateness') or [0.0]):.4f} s; "
          f"compiles inside the window {run.compiles_in_window}",
          file=sys.stderr)
    found = loaded_forbidden()
    if found:
        print(f"portbench: loaded in this process: {found}; the benchmark "
              f"measures tpu9_torch alone", file=sys.stderr)
        return 3
    for name, num in out["checks"].items():
        print(f"check {name}: {num['value']} (limit {num['limit']})",
              file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
