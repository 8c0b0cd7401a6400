"""The port's graph check (``tpu9_torch.analysis.graphcheck``) on the CPU:
the matrix against the reference's, every clean cell without a finding
over fake CUDA tensors, one seeded fault per rule found under its id (the
mirror of ``tests/test_graphcheck.py``'s seeded violations), Pass B on
synthetic sources and on the clean tree, and the command line's exit codes
and JSON record against the reference's."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from tpu9.analysis.findings import Finding as RefFinding
from tpu9.analysis.findings import finding_json as ref_finding_json
from tpu9.analysis.graphcheck.matrix import MATRIX as REF_MATRIX
from tpu9_torch.analysis.findings import Finding, finding_json
from tpu9_torch.analysis.graphcheck import __main__ as cli
from tpu9_torch.analysis.graphcheck import passes
from tpu9_torch.analysis.graphcheck.astrules import (check_graph_file,
                                                     lint_tree)
from tpu9_torch.analysis.graphcheck.matrix import MATRIX, find_cells

ROOT = Path(__file__).resolve().parents[1]
CELLS = {c.name: c for c in MATRIX}


def test_matrix_names_equal_the_reference():
    assert [c.name for c in MATRIX] == [c.name for c in REF_MATRIX]
    assert all(c.n_layers == 2 for c in MATRIX)
    with pytest.raises(KeyError, match="unknown graphcheck cell"):
        find_cells(["llama3-8b@9x9"])
    assert find_cells(["gemma-7b@2x1"]) == [CELLS["gemma-7b@2x1"]]


@pytest.mark.parametrize("cell", MATRIX, ids=lambda c: c.name)
def test_clean_cell_has_no_finding(cell):
    findings, stats = passes.run_cell(cell)
    assert findings == [], [f.format() for f in findings]
    assert stats["jobs"] == 7
    # the traced kernel launches the jobs imply, each rank's own: paged
    # cells run B1 (B2 on the int8 pool) in the 1- and 4-step windows and
    # the verify window, a layer each; the dense cell's two prefills B3
    tp = int(cell.topology.split("x")[0])
    if cell.paged:
        kernel = "paged_decode_attention" + ("_quant" if cell.kv_quant
                                             else "")
        want = cell.n_layers * (sum(cell.decode_steps) + 1) * tp
    else:
        kernel, want = "flash_attention", cell.n_layers * 2 * tp
    assert stats["kernels"] == {kernel: want}


def _job(cs, key):
    return next((a for k, _, a in cs.jobs() if k == key))


def test_weight_left_whole_on_both_ranks_is_gra001():
    with passes.traced_cell(CELLS["llama3-8b@2x1"]) as cs:
        assert passes.weight_findings(cs) == []
        full = cs.full["layers"][0]["w_gate"]
        for r in range(2):
            cs.params[r]["layers"][0]["w_gate"] = torch.zeros(
                full.shape, dtype=full.dtype, device="cuda:0")
        fs = passes.weight_findings(cs)
    assert [f.rule for f in fs] == ["GRA001", "GRA001"]
    assert all("layers/0/w_gate" in f.message and "whole" in f.message
               for f in fs)


def test_pool_gathered_to_all_heads_is_gra002():
    def gathering(pool, k, v, offset, phys):
        torch.cat([pool[0]["k"], pool[1]["k"]], dim=-2)
        return pool

    with passes.traced_cell(CELLS["llama3-8b@2x1"]) as cs:
        fs, _ = passes.check_job(cs, "splice", lambda: gathering,
                                 _job(cs, "splice"))
    assert [f.rule for f in fs] == ["GRA002"]
    assert "every kv head" in fs[0].message


def test_cross_device_copy_on_one_device_is_gra002():
    def crossing(pool, row, scratch):
        scratch["k"].to("cuda:1")
        return scratch

    with passes.traced_cell(CELLS["llama3-8b@1x1"]) as cs:
        fs, _ = passes.check_job(cs, "gather", lambda: crossing,
                                 _job(cs, "gather"))
    assert [f.rule for f in fs] == ["GRA002"]
    assert "SINGLE-DEVICE" in fs[0].message


def test_pool_written_out_of_place_is_gra003():
    def rebuilding(pool, k, v, offset, phys):
        return {n: t.clone() for n, t in pool.items()}

    with passes.traced_cell(CELLS["llama3-8b@1x1"]) as cs:
        fs, _ = passes.check_job(cs, "splice", lambda: rebuilding,
                                 _job(cs, "splice"))
    assert {f.rule for f in fs} == {"GRA003"}
    assert any("not written in place" in f.message for f in fs)
    assert any("out of place" in f.message for f in fs)


def test_window_rebinding_its_pool_is_gra003():
    with passes.traced_cell(CELLS["llama3-8b@1x1"]) as cs:
        window = cs.factory.window

        def rebinding():
            window.kv_cache["k"] = window.kv_cache["k"].clone()

        fs, _ = passes.check_job(cs, ("decode", 1), lambda: rebinding, ())
    assert {f.rule for f in fs} == {"GRA003"}
    assert "kv_cache (the window's)" in fs[0].message


def test_int8_weight_reaching_matmul_is_gra004():
    with passes.traced_cell(CELLS["llama3-8b@2x1+wint8+kvint8"]) as cs:
        w = cs.params[0]["layers"][0]["wq"]["q"]
        assert w.dtype == torch.int8

        def leaking(pool, row, scratch):
            x = torch.zeros((2, w.shape[0]), dtype=torch.int8,
                            device=w.device)
            torch.matmul(x, w)
            return scratch

        fs, _ = passes.check_job(cs, "gather", lambda: leaking,
                                 _job(cs, "gather"))
    assert [f.rule for f in fs] == ["GRA004"]
    assert "int8 operand" in fs[0].message


def test_scale_plane_leaving_as_bf16_is_gra004():
    def leaky(pool, k, v, offset, phys):
        return [{n: (t.to(torch.bfloat16) if n.endswith("_scale") else t)
                 for n, t in rank.items()} for rank in pool]

    with passes.traced_cell(CELLS["llama3-8b@2x1+wint8+kvint8"]) as cs:
        args = _job(cs, "splice")
        fs, _ = passes.check_job(
            cs, "splice", lambda: lambda *a: type(args[0])(leaky(*a)), args)
    assert "GRA004" in {f.rule for f in fs}
    assert any(f.rule == "GRA004" and "scale plane" in f.message for f in fs)


def test_open_signature_set_is_gra005():
    with passes.traced_cell(CELLS["llama3-8b@1x1"]) as cs:
        have = {k for k, _, _ in cs.jobs()}
        want = cs.factory.reachable_keys(cs.buckets, cs.spec_lens)
    assert passes.signature_findings("c", have, want) == []
    fs = passes.signature_findings("c", have - {("verify", 4)}, want)
    assert [f.rule for f in fs] == ["GRA005"]
    assert "NOT precompiled" in fs[0].message
    fs = passes.signature_findings("c", have | {("decode", 99)}, want)
    assert [f.rule for f in fs] == ["GRA005"]
    assert "not reachable" in fs[0].message


# -- Pass B ------------------------------------------------------------------------

def _lint(path: str, src: str) -> list:
    return check_graph_file(path, ast.parse(src))


@pytest.mark.parametrize("path,src,rules", [
    ("tpu9_torch/serving/engine.py",
     "import torch\ng = torch.cuda.CUDAGraph()\n", ["SHD001"]),
    ("tpu9_torch/serving/schedule.py",
     "from torch.cuda import graph\nwith graph(g):\n    pass\n", ["SHD001"]),
    ("tpu9_torch/serving/presets.py",
     "import torch\nf = torch.compile(lambda x: x)\n", ["SHD001"]),
    ("tpu9_torch/serving/graphs.py",
     "import torch\ng = torch.cuda.CUDAGraph()\n", []),
    ("tpu9_torch/models/clip_vit.py",
     "import torch\ng = torch.cuda.CUDAGraph()\n", []),
])
def test_capture_outside_the_factory_is_shd001(path, src, rules):
    assert [f.rule for f in _lint(path, src)] == rules


ENGINE_SRC = '''
class InferenceEngine:
    def __init__(self, pool):
        self.kv_cache = pool.init_arrays()
        self.cache_len = zeros()
        self.kv_cache["table"] = pool.table

    def _push(self, slot, row):
        self.kv_cache["table"] = self.pool.push_table(slot)

    def _reset(self, n):
        self.cache_len = zeros(n)
        self.graphs.window.toks = zeros(n)

    def _fine(self, x):
        self.cache_len.copy_(x)
        self.kv_cache["k"][0] = x
        self._scratch = x
        table = self.kv_cache["table"]
'''


def test_rebinding_a_window_tensor_is_shd002():
    fs = _lint("tpu9_torch/serving/engine.py", ENGINE_SRC)
    assert [(f.rule, f.symbol) for f in fs] == [
        ("SHD002", "InferenceEngine._push"),
        ("SHD002", "InferenceEngine._reset"),
        ("SHD002", "InferenceEngine._reset")]
    assert "self.kv_cache['table']" in fs[0].message
    # the factory owns the window's state
    assert _lint("tpu9_torch/serving/graphs.py", ENGINE_SRC) == []


@pytest.mark.parametrize("path,src,n", [
    ("tpu9_torch/serving/engine.py",
     "from tpu9_torch.ops.quant import quantize_kv\n", 1),
    ("tpu9_torch/serving/kvpool.py",
     "from ..ops.quant import dequantize_kv, validate_quant_mode\n", 1),
    ("tpu9_torch/serving/paged_kv.py",
     "from ..ops.quant import quantize_kv\n", 0),
    ("tpu9_torch/models/transformer.py",
     "from ..ops.quant import quantize_kv\n", 0),
    ("tpu9_torch/ops/paged_attention.py",
     "from .quant import dequantize_kv\n", 0),
    ("tpu9_torch/models/moe.py",
     "from ..ops.quant import maybe_einsum\n", 0),
])
def test_raw_int8_symbols_outside_the_carriers_is_dty001(path, src, n):
    fs = _lint(path, src)
    assert [f.rule for f in fs] == ["DTY001"] * n


def test_the_clean_tree_has_no_pass_b_finding():
    assert lint_tree(ROOT) == []


# -- the command line ---------------------------------------------------------------

def test_cli_exit_codes_and_json(capsys, monkeypatch):
    assert cli.main(["--cell", "llama3-8b@1x1", "--format", "json"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert set(report) == {"version", "tool", "cells", "elapsed_s",
                           "findings"}
    assert report["version"] == 1 and report["tool"] == "graphcheck"
    assert [c["cell"] for c in report["cells"]] == ["llama3-8b@1x1"]
    assert report["findings"] == []

    assert cli.main(["--cell", "llama3-8b@7x7"]) == 2
    assert "unknown graphcheck cell" in capsys.readouterr().err

    seeded = Finding("GRA003", "graph://llama3-8b@1x1", 0, 0, "seeded",
                     symbol="splice")
    monkeypatch.setattr(passes, "run_matrix", lambda cells: {
        "findings": [seeded], "cells": [], "elapsed_s": 0.0})
    assert cli.main(["--no-lint", "--format", "json"]) == 1
    assert json.loads(capsys.readouterr().out)["findings"] == [
        finding_json(seeded, "graph")]
    assert cli.main(["--no-lint"]) == 1
    assert "GRA003 [splice] seeded" in capsys.readouterr().out


@pytest.mark.parametrize("status", ["new", "graph"])
def test_finding_json_equals_the_reference_record(status):
    args = ("SHD002", "tpu9_torch/serving/engine.py", 12, 8, "rebound")
    ours = finding_json(Finding(*args, symbol="E._push", occurrence=1),
                        status)
    ref = ref_finding_json(RefFinding(*args, symbol="E._push",
                                      occurrence=1), status)
    assert ours == ref


def test_module_entry_lists_the_cells():
    proc = subprocess.run([sys.executable, "-m",
                           "tpu9_torch.analysis.graphcheck", "--list-cells"],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == [c.name for c in REF_MATRIX]
