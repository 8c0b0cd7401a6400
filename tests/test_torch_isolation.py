"""The port stands alone: no module of ``tpu9_torch`` and not
``chip_smoke.py`` imports JAX or anything of the JAX package ``tpu9``, and
an entry point with no device does not quietly fall back to the CPU."""

import ast
import os
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
    # the scan reaches every module, the int8 slice's included
    assert PORT / "ops" / "quant.py" in sources
    bad = {str(p.relative_to(ROOT)): sorted(_imported_roots(p) & set(FORBIDDEN))
           for p in sources}
    assert not {k: v for k, v in bad.items() if v}


def test_importing_the_serving_stack_loads_no_jax():
    code = ("import sys, tpu9_torch.serving.presets, tpu9_torch.bridge; "
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
