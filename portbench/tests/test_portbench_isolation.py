"""Nothing under portbench imports JAX or the JAX package, compared by
whole top-level names (``tpu9_torch`` is not ``tpu9``); nothing under
portbench/reference imports the program either."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
JAX_SIDE = {"jax", "jaxlib", "tpu9", "flax", "optax"}
MODULES = sorted(p for p in HERE.rglob("*.py"))


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_side_import(path):
    found = top_level_imports(path) & JAX_SIDE
    assert not found, f"{path} imports {found}"
    if "reference" in path.relative_to(HERE).parts:
        assert "tpu9_torch" not in top_level_imports(path)


def test_rule_tells_the_port_from_the_package(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import tpu9_torch.serving\nfrom tpu9_torch import x\n"
                     "import tpu9.ops\n")
    assert top_level_imports(probe) == {"tpu9_torch", "tpu9"}
