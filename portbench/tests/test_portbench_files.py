"""The harness finds every configuration, mix and metric by the name in
BENCHMARK.json, and BENCHMARK.json keeps to the shape its runner reads."""

import json
import re

import pytest

from portbench import run as prun

SPEC = prun.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in SPEC[k]]
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in (
            "host_clock", "device_trace")


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda c: c["name"])
def test_cell_files_found(cell):
    found, conf, mix = prun.find_cell(SPEC, cell["name"])
    assert found is cell and cell["chips"] == 1
    assert conf["name"] == cell["config"]
    assert mix["kind"] in ("serve", "train")


@pytest.mark.parametrize("metric", SPEC["end_to_end"] + SPEC["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_reader_found(metric):
    kind = "end_to_end" if "bound" in metric else "layer_metrics"
    assert callable(prun.reader(kind, metric["name"]))


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda c: c["name"])
def test_cell_reports_what_its_layers_move(cell):
    e2e = {m["name"] for m in SPEC["end_to_end"] if prun.applies(m, cell)}
    layers = [m for m in SPEC["per_layer"] if prun.applies(m, cell)]
    assert "setup_s" in e2e and len(e2e) >= 2 and layers
    for m in layers:
        assert m["moves"] in e2e, (m["name"], cell["name"])


@pytest.mark.parametrize("conf", SPEC["configs"], ids=lambda c: c["name"])
def test_config_files(conf):
    data = json.loads((prun.ROOT / conf["file"]).read_text())
    assert data["source"] == conf["source"]
    assert data["reduced"] == conf["reduced"]
    for key in conf["reduced"]:
        assert data["published"][key] != data[key]


READERS = sorted((prun.HERE / "end_to_end").glob("*.py")) + \
    sorted((prun.HERE / "layer_metrics").glob("*.py"))


@pytest.mark.parametrize("path", READERS, ids=lambda p: p.stem)
def test_every_reader_file_loads(path):
    assert callable(prun.reader(path.parent.name, path.stem))


@pytest.mark.parametrize("kind", ["serve", "train"])
def test_per_layer_readers_read_a_traced_run(kind):
    """Every per-layer metric of the cells of a kind, read by the reader
    its name finds, over a traced run at a tiny size: a number above 0 or
    nothing (the CPU has no device trace, so only the counters read)."""
    import argparse
    import math
    import time
    from portbench import serve, train
    from portbench.tests import test_portbench_faults as faults
    if kind == "serve":
        args = argparse.Namespace(seed=2 ** 31 + 5, seconds=2.0, trace=1)
        run = serve.run({"name": "tiny.batch", "chips": 1},
                        faults.tiny_serving_conf("mistral-7b"), faults.MIX,
                        args, time.monotonic(), device="cpu")
    else:
        run = faults.train_once(trace=1)
    cells = [c for c in SPEC["workloads"]
             if prun.find_cell(SPEC, c["name"])[2]["kind"] == kind]
    read = {}
    for m in SPEC["per_layer"]:
        if any(prun.applies(m, c) for c in cells):
            read[m["name"]] = prun.reader("layer_metrics", m["name"])(run)
    assert read
    for name, value in read.items():
        assert value is None or (math.isfinite(value) and value > 0), name
    if kind == "serve":
        assert read["decode_step_ms.batch"] > 0
