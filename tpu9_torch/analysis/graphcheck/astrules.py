"""Pass B: AST rules over the port's sources (counterpart of
``tpu9/analysis/graphcheck/astrules.py``), configured by the module
constant ``GRAPH_CFG``.

- **SHD001** a CUDA graph capture (``torch.cuda.graph``,
  ``torch.cuda.CUDAGraph``, ``torch.cuda.make_graphed_callables``) or a
  ``torch.compile`` in a serving module that is not a declared capture
  owner: the factory (``serving/graphs.py``) is the one place a serving
  computation is captured, so the launch accounting, the graphs' shared
  pool and the post-warmup build sentinel all apply.
- **SHD002** the port's face of reading a donated buffer: a tensor a
  captured window holds rebound after construction. A replay keeps
  reading and writing the old tensor, so rebinding a ``WindowState``
  field (``<...>.window.kv_cache = ...``), an engine attribute the window
  holds (``self.cache_len = ...`` outside ``__init__``) or a key of the
  pool or cache dict (``self.kv_cache["table"] = ...``) silently
  detaches the host's view from what the device computes. Writes in
  place (``t.copy_(...)``, ``t[...] = ...``) are what the engine does.
- **DTY001** the raw int8 KV symbols (``quantize_kv``, ``dequantize_kv``)
  imported from ``tpu9_torch.ops.quant`` by a module outside the declared
  int8 carriers: everything else sees KV through the dequantizing
  readers.

There is no suppression comment and no baseline: the clean tree has no
finding.
"""

from __future__ import annotations

import ast
from pathlib import Path

from ..findings import Finding

GRAPH_AST_RULES = ("SHD001", "SHD002", "DTY001")

GRAPH_CFG = {
    "serving_scope": ["tpu9_torch/serving/"],
    "capture_owners": ["tpu9_torch/serving/graphs.py"],
    "capture_calls": ["torch.cuda.graph", "torch.cuda.CUDAGraph",
                      "torch.cuda.make_graphed_callables", "torch.compile"],
    # what a captured window holds: the WindowState fields, and the
    # engine's attributes that alias them
    "window_fields": ["params", "kv_cache", "last_token", "cache_len",
                      "active", "toks", "generator", "drafts", "out",
                      "n_acc"],
    "window_aliases": ["params", "kv_cache", "last_token", "cache_len",
                       "_active_dev", "_toks", "_gen", "_drafts",
                       "_spec_out", "_n_acc"],
    "kv_keys": ["k", "v", "k_scale", "v_scale", "table"],
    "int8_sources": ["tpu9_torch.ops.quant"],
    "int8_symbols": ["quantize_kv", "dequantize_kv"],
    "int8_carriers": ["tpu9_torch.ops", "tpu9_torch.models.transformer",
                      "tpu9_torch.serving.graphs",
                      "tpu9_torch.serving.paged_kv"],
}


def dotted_name(node) -> str:
    """``a.b.c`` of a Name/Attribute chain, or "" for anything else."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _in_scope(path: str, prefixes) -> bool:
    return any(path == p.rstrip("/") or path.startswith(p) for p in prefixes)


def _aliases(tree: ast.AST) -> dict:
    """Local name → the dotted name it imports (``import torch.cuda as
    tc``, ``from torch.cuda import graph``)."""
    out = {}
    for n in ast.walk(tree):
        if isinstance(n, ast.Import):
            for a in n.names:
                if a.asname:
                    out[a.asname] = a.name
        elif isinstance(n, ast.ImportFrom) and n.module and not n.level:
            for a in n.names:
                out[a.asname or a.name] = f"{n.module}.{a.name}"
    return out


def _resolve(name: str, aliases: dict) -> str:
    head, _, rest = name.partition(".")
    base = aliases.get(head, head)
    return f"{base}.{rest}" if rest else base


def _functions(tree: ast.AST):
    """``(function node, qualname)`` of every function, methods by
    ``Class.method``."""
    def walk(node, prefix):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                yield from walk(child, f"{prefix}{child.name}.")
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield child, f"{prefix}{child.name}"
                yield from walk(child, f"{prefix}{child.name}.")
            else:
                yield from walk(child, prefix)
    yield from walk(tree, "")


def _symbol_of(tree: ast.AST) -> dict:
    """Node id → the qualname of the innermost function around it."""
    out = {}
    for fn, qual in _functions(tree):
        for n in ast.walk(fn):
            out[id(n)] = qual            # inner functions come later
    return out


# -- SHD001 -------------------------------------------------------------------

def _check_capture_owner(path: str, tree: ast.AST, cfg: dict) -> list:
    if not _in_scope(path, cfg["serving_scope"]) \
            or path in cfg["capture_owners"]:
        return []
    aliases, symbols = _aliases(tree), _symbol_of(tree)
    findings = []
    for n in ast.walk(tree):
        if not isinstance(n, ast.Call):
            continue
        name = _resolve(dotted_name(n.func), aliases)
        if name in cfg["capture_calls"]:
            findings.append(Finding(
                "SHD001", path, n.lineno, n.col_offset,
                f"`{name}` outside the declared capture owners "
                f"{cfg['capture_owners']}: serving computations are "
                "captured by the GraphFactory, so the launch accounting, "
                "the windows' shared pool and the post-warmup build "
                "sentinel all apply", symbol=symbols.get(id(n), name)))
    return findings


# -- SHD002 -------------------------------------------------------------------

def _rebound_window_tensor(target, cfg: dict) -> str:
    """What ``target`` rebinds that a captured window holds, or ""."""
    if isinstance(target, ast.Attribute):
        base = dotted_name(target.value)
        if base.endswith("window") and target.attr in cfg["window_fields"]:
            return f"{base}.{target.attr}"
        if target.attr in cfg["window_aliases"] and base:
            return f"{base}.{target.attr}"
    if isinstance(target, ast.Subscript) \
            and isinstance(target.slice, ast.Constant) \
            and target.slice.value in cfg["kv_keys"] \
            and isinstance(target.value, ast.Attribute) \
            and target.value.attr in ("kv_cache", "params"):
        return f"{dotted_name(target.value)}[{target.slice.value!r}]"
    return ""


def _check_window_rebind(path: str, tree: ast.AST, cfg: dict) -> list:
    if not _in_scope(path, cfg["serving_scope"]) \
            or path in cfg["capture_owners"]:
        return []
    symbols = _symbol_of(tree)
    findings = []
    for n in ast.walk(tree):
        if isinstance(n, ast.Assign):
            targets = [t for tgt in n.targets
                       for t in (tgt.elts if isinstance(tgt, ast.Tuple)
                                 else [tgt])]
        elif isinstance(n, ast.AnnAssign):
            targets = [n.target]
        else:
            continue
        symbol = symbols.get(id(n), "<module>")
        if symbol.endswith("__init__"):
            continue                     # construction: nothing captured yet
        for t in targets:
            what = _rebound_window_tensor(t, cfg)
            if what:
                findings.append(Finding(
                    "SHD002", path, t.lineno, t.col_offset,
                    f"`{what}` is rebound after construction, but a "
                    "captured decode window holds the tensor it named: "
                    "every replay keeps reading and writing the old one; "
                    "write it in place (`copy_`, an indexed store)",
                    symbol=symbol))
    return findings


# -- DTY001 -------------------------------------------------------------------

def _module_of(path: str) -> str:
    mod = path[:-3].replace("/", ".")
    return mod[: -len(".__init__")] if mod.endswith(".__init__") else mod


def _check_int8_escape(path: str, tree: ast.AST, cfg: dict) -> list:
    mod = _module_of(path)
    if any(mod == c or mod.startswith(c + ".")
           for c in cfg["int8_carriers"]):
        return []
    findings = []
    for n in ast.walk(tree):
        if not isinstance(n, ast.ImportFrom):
            continue
        if n.level:
            parts = mod.split(".")
            if not path.endswith("__init__.py"):
                parts = parts[:-1]
            base = ".".join(parts[: len(parts) - n.level + 1])
            target = f"{base}.{n.module}" if n.module else base
        else:
            target = n.module or ""
        if target not in cfg["int8_sources"]:
            continue
        for a in n.names:
            if a.name in cfg["int8_symbols"]:
                findings.append(Finding(
                    "DTY001", path, n.lineno, n.col_offset,
                    f"`{mod}` imports raw int8 KV symbol `{a.name}` from "
                    f"`{target}`: only the declared int8 carriers "
                    f"{cfg['int8_carriers']} may touch the payload and "
                    "scale layout; everything else sees KV through the "
                    "dequantizing readers", symbol=a.name))
    return findings


def check_graph_file(path: str, tree: ast.AST,
                     cfg: dict | None = None) -> list:
    """The three rules over one parsed file at repo-relative ``path``."""
    cfg = cfg or GRAPH_CFG
    return (_check_capture_owner(path, tree, cfg)
            + _check_window_rebind(path, tree, cfg)
            + _check_int8_escape(path, tree, cfg))


def lint_tree(root, cfg: dict | None = None) -> list:
    """Pass B over every ``tpu9_torch/**/*.py`` under ``root``, each
    finding numbered by its occurrence within (rule, path, symbol)."""
    root = Path(root)
    findings = []
    for src in sorted((root / "tpu9_torch").rglob("*.py")):
        rel = src.relative_to(root).as_posix()
        findings += check_graph_file(rel, ast.parse(src.read_text(), rel),
                                     cfg)
    seen: dict = {}
    for f in findings:
        k = (f.rule, f.path, f.symbol)
        f.occurrence = seen.get(k, 0)
        seen[k] = f.occurrence + 1
    return findings
