"""The graph check of the port (counterpart of ``tpu9.analysis.graphcheck``):
static verification of sharding, dtype and in-place invariants in the
serving computations.

- **Pass A** (``passes.py``): for each preset × topology cell of the
  matrix (``matrix.py``), build what an engine of the cell holds and run
  every job ``GraphFactory.lowering_jobs`` enumerates under a recorder of
  every aten op and kernel launch, over fake CUDA tensors (no byte
  allocated), then check GRA001 (weights split as the layout declares),
  GRA002 (KV heads per rank; no cross-device copy or reduction on 1x1),
  GRA003 (round-trip buffers written in place), GRA004 (no int8 operand
  reaches a matmul; the KV dtypes close) and GRA005 (the precompiled key
  set equals the reachable one).
- **Pass B** (``astrules.py``): SHD001 (a CUDA graph capture or
  ``torch.compile`` outside the factory), SHD002 (a tensor a captured
  window holds rebound) and DTY001 (raw int8 KV symbols imported outside
  the carriers).

    python -m tpu9_torch.analysis.graphcheck              # matrix + Pass B
    python -m tpu9_torch.analysis.graphcheck --cell llama3-8b@2x1
    python -m tpu9_torch.analysis.graphcheck --format json

It runs on the CPU as well as beside a card: the fake tensors take the
card's branches either way.
"""

from .astrules import GRAPH_AST_RULES, check_graph_file, lint_tree

__all__ = ["GRAPH_AST_RULES", "check_graph_file", "lint_tree"]
