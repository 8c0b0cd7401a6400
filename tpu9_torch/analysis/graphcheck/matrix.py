"""The declared preset × topology matrix of the graph check (counterpart
of ``tpu9/analysis/graphcheck/matrix.py``): the same cells under the same
names.

Each cell names a preset, a topology and the engine knobs its serving
graphs are traced with. Depth is cut to ``n_layers=2``: layer 3 runs the
ops layer 2 runs, so the sharding, dtype and in-place invariants are
checked per layer all the same. Per-layer shapes are the flagship's (head
counts, head_dim, hidden and vocab widths), so a width that tp does not
divide is checked against the real arithmetic. A topology maps to the
single-controller serving policy (``serving/shard/policy.py``) with every
rank on one device.

A new preset or computation: add a Cell (or a knob) here; Pass A derives
the rest from ``GraphFactory.lowering_jobs``.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Cell:
    preset: str
    topology: str                 # "1x1", "2x1", "2x2", ...
    quantize: str = ""            # "" | "int8" weight quantization
    kv_quant: str = ""            # "" | "int8" paged-KV pool
    n_layers: int = 2             # depth cut (shapes stay flagship)
    paged: bool = True            # False = the dense-cache graph set
    max_batch: int = 2
    max_seq_len: int = 256
    kv_block_size: int = 64
    chunk: int = 128              # prefill chunk (paged) / smallest bucket
    prefill_buckets: tuple = (128, 256)   # dense-mode buckets
    decode_steps: tuple = (1, 4)
    spec_len: int = 4             # speculative-verify window length
    admit_group_chunks: int = 2   # fused admission group size
    kv_pool_blocks: int = 8

    @property
    def name(self) -> str:
        tags = [t for t in (self.quantize and f"w{self.quantize}",
                            self.kv_quant and f"kv{self.kv_quant}",
                            "" if self.paged else "dense") if t]
        return f"{self.preset}@{self.topology}" + \
            ("+" + "+".join(tags) if tags else "")


MATRIX: tuple = (
    # flagship
    Cell("llama3-8b", "1x1"),
    Cell("llama3-8b", "2x1"),
    Cell("llama3-8b", "2x2"),
    # quantized serving end to end: int8 weights and an int8 paged pool,
    # whose scale planes shard with the payload's heads
    Cell("llama3-8b", "2x1", quantize="int8", kv_quant="int8"),
    # 16 kv heads of 256
    Cell("gemma-7b", "1x1"),
    Cell("gemma-7b", "2x1"),
    Cell("gemma-7b", "2x2"),
    # MoE: the expert stacks shard over tp
    Cell("mixtral-8x7b", "1x1"),
    Cell("mixtral-8x7b", "2x1"),
    Cell("mixtral-8x7b", "2x2"),
    # the dense cache: bucketed prefill and the dense splice
    Cell("llama3-8b", "2x1", paged=False),
)


def find_cells(names=None) -> list:
    """The cells named (all of them for None); an unknown name raises
    ``KeyError``, so a mistyped ``--cell`` cannot verify nothing."""
    if not names:
        return list(MATRIX)
    by_name = {c.name: c for c in MATRIX}
    out = []
    for n in names:
        if n not in by_name:
            raise KeyError(
                f"unknown graphcheck cell {n!r}; have {sorted(by_name)}")
        out.append(by_name[n])
    return out
