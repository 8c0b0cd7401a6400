"""The port stands alone: no module of ``tpu9_torch`` and not
``chip_smoke.py`` imports JAX or anything of the JAX package ``tpu9``, and
an entry point with no device does not quietly fall back to the CPU."""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import tpu9_torch

PORT = Path(tpu9_torch.__file__).resolve().parent
ROOT = PORT.parent
FORBIDDEN = ("jax", "jaxlib", "tpu9", "ml_dtypes", "flax", "optax")


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def _port_sources() -> list[Path]:
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_no_port_module_imports_jax_or_the_jax_package():
    sources = _port_sources()
    assert len(sources) > 15
    # the scan reaches every module: the int8 path's, the kvwire format
    # and host tier with the modules they extend, and the checkpoint layer
    # (the weight format and the runner and worker subpackages), and the
    # MoE decoder with its presets, and the LoRA and train layers, and the
    # multi-GPU layer (the planner, feasibility, policies, the layout), and
    # the encoders (the CLIP embedder and the text classifier), and the
    # parallel layer (meshes, ring attention, the pipeline, multi-host),
    # and the runner zygote and the graph check with its finding record
    for module in ("runner/zygote.py", "analysis/__init__.py",
                   "analysis/findings.py", "analysis/graphcheck/__init__.py",
                   "analysis/graphcheck/__main__.py",
                   "analysis/graphcheck/matrix.py",
                   "analysis/graphcheck/passes.py",
                   "analysis/graphcheck/astrules.py",
                   "models/moe.py", "models/mixtral.py", "models/lora.py",
                   "models/clip_vit.py", "models/classifier.py",
                   "types.py", "serving/feasibility.py",
                   "serving/shard/__init__.py", "serving/shard/plan.py",
                   "serving/shard/policy.py", "parallel/__init__.py",
                   "parallel/sharding.py", "parallel/mesh.py",
                   "parallel/ring.py", "parallel/pipeline.py",
                   "parallel/distributed.py",
                   "train/optim.py", "train/trainer.py", "train/__init__.py",
                   "ops/quant.py", "serving/kvwire.py", "serving/kvpool.py",
                   "serving/paged_kv.py", "serving/schedule.py",
                   "serving/engine.py", "utils/platform.py",
                   "serving/weights.py", "runner/ckpt.py",
                   "worker/weightstream.py", "observability/coldstart.py"):
        assert PORT / module in sources, module
    bad = {str(p.relative_to(ROOT)): sorted(_imported_roots(p) & set(FORBIDDEN))
           for p in sources}
    assert not {k: v for k, v in bad.items() if v}


def test_cuda_sources_include_only_the_toolkit_and_each_other():
    """The kernels' sources (the flash backward and the header it shares
    with the forward among them) include CUDA's and the C and C++ standard
    libraries' headers and files of ``tpu9_torch/csrc`` only."""
    csrc = PORT / "csrc"
    sources = sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh"))
    for name in ("flash_attention.cu", "flash_attention_backward.cu",
                 "hopper.cuh", "paged_decode_attention.cu"):
        assert csrc / name in sources, name
    system = {"cuda.h", "cuda_bf16.h", "cuda_runtime.h", "limits.h",
              "stdint.h", "type_traits"}
    for path in sources:
        for line in path.read_text().splitlines():
            m = re.match(r'\s*#\s*include\s*([<"])([^>"]+)[>"]', line)
            if not m:
                continue
            if m.group(1) == '"':
                assert (csrc / m.group(2)).exists(), (path.name, line)
            else:
                assert m.group(2) in system, (path.name, line)


def test_importing_the_serving_stack_loads_no_jax():
    code = ("import sys, tpu9_torch.serving.presets, tpu9_torch.bridge, "
            "tpu9_torch.serving.kvwire, tpu9_torch.runner.ckpt, "
            "tpu9_torch.worker.weightstream, "
            "tpu9_torch.observability.coldstart, tpu9_torch.train, "
            "tpu9_torch.serving.shard, tpu9_torch.serving.feasibility, "
            "tpu9_torch.parallel, tpu9_torch.parallel.distributed, "
            "tpu9_torch.types, "
            "tpu9_torch.models.clip_vit, tpu9_torch.models.classifier, "
            "tpu9_torch.runner.zygote, tpu9_torch.analysis.findings, "
            "tpu9_torch.analysis.graphcheck.passes, "
            "tpu9_torch.analysis.graphcheck.__main__; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]; print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_load_engine_without_a_device_raises_instead_of_using_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is that device")
    from tpu9_torch.serving.presets import load_engine
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_engine("llama-tiny")
    # the explicit opt-in works
    engine = load_engine("llama-tiny", device="cpu", max_batch=2,
                         max_seq_len=64, prefill_buckets=(16,),
                         kv_block_size=16)
    assert engine.device.type == "cpu" and engine.ecfg.kv_block_size == 16
