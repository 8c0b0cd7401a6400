"""Pass A: the serving computations traced and verified (counterpart of
``tpu9/analysis/graphcheck/passes.py``).

For each matrix cell this module builds what an engine of the cell holds
(the DecoderConfig, the EngineConfig, the sharding policy, the weights,
the pool, the scratch, the ``WindowState`` and the ``GraphFactory``) and
runs every job ``GraphFactory.lowering_jobs`` enumerates under a recorder
of every aten op (a ``TorchDispatchMode``: op, operand and result dtypes,
shapes, devices and storages), then checks the record.

By default no byte is allocated: the state is made of fake CUDA tensors
(``FakeTensorMode``), so a trace takes the card's branches (an int8
weight's bf16 GEMM, the kernel wrappers' launch path), not the CPU twins.
The kernel launchers (``_launch``, ``_launch_ragged``, ``_launch_flash``)
call ``ctypes`` on data pointers, which fake tensors lack: for the length
of a trace each is swapped for a recorder that notes the kernel and its
operands and returns an empty output of the kernel's shape (the wrappers'
routing and casts before the launch run as on the card, and their launch
counts are set back after). With ``real=True`` (on the card) the state is
real CUDA tensors and the launchers run, recorded. A decode or verify
window is traced as the body its CUDA graph would capture
(``GraphFactory.captures = False``).

On a CPU-only build of torch a fake CUDA tensor's Python indexing and
``copy_`` look for a CUDA device guard that the build lacks: there
(``_CudaOnCpuBuild``) those calls see the fake tensors' device as the CPU
for the call's length, and device moves go to ``aten._to_copy`` directly.
A CUDA build needs no such help.

- **GRA001** weight sharding: under tp>1 every weight leaf the layout
  declares split must be split on every rank (a leaf left whole is all
  the memory and none of the capacity), and at least one matmul of the
  cell must take a rank shard as an operand.
- **GRA002** KV heads: under tp>1 every KV output of every rank keeps the
  rank's kv head count and no op makes a pool, cache or scratch plane
  with every head (a gather to all heads). On 1x1 no copy between CUDA
  devices and no ``reduce_partials`` of several partials may appear: the
  single-device graphs are the unsharded engine's.
- **GRA003** in place (the reference's donation): the pool, scratch or
  cache of each round-trip job (``EXPECTED_DONATION``) comes back in the
  storage it went in with, and no op makes a new tensor of a whole
  buffer's shape.
- **GRA004** dtype closure: no matmul-family aten op takes an int8
  operand (a kernel launch over an int8 pool dequantizes in registers and
  counts as dequantizing); scratch, gather and cache outputs stay the
  model's dtype; pool payloads stay int8 under ``kv_quant`` and scale
  planes f32.
- **GRA005** closed signatures: the ``lowering_jobs`` key set equals
  ``reachable_keys``.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, replace
from typing import Any, Optional

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from ...parallel.sharding import Pieces, Ranked, named_leaves
from ..findings import Finding
from .matrix import MATRIX, Cell

# the buffers each kind of job writes in place, as (name, argument index,
# output index): argument None is the window's kv_cache (a window takes
# no arguments), output None the job's whole result
EXPECTED_DONATION = {
    "decode": (("kv_cache", None, None),),
    "verify": (("kv_cache", None, None),),
    "chunk": (("scratch", 3, 1),),
    "splice": (("pool", 0, None),),
    "chunkgroup": (("pool", 1, 0), ("scratch", 2, 1)),
    "dsplice": (("cache k", 0, 0), ("cache v", 1, 1)),
    "prefill": (),
    "gather": (),
}

WINDOWS = ("decode", "verify")

# aten ops that multiply matrices (their overload packets' names)
MATMULS = frozenset({"mm", "bmm", "addmm", "baddbmm", "addbmm", "matmul",
                     "einsum", "linear", "dot", "mv", "addmv"})


def kind_of(key) -> str:
    if isinstance(key, tuple):
        return key[0]
    return "prefill" if isinstance(key, int) else key


def _f(rule: str, cell_name: str, key, message: str) -> Finding:
    return Finding(rule, f"graph://{cell_name}", 0, 0, message,
                   symbol=str(key))


# -- the record ---------------------------------------------------------------

@dataclass
class Op:
    """One recorded call: an aten op (``mm``), a kernel launch
    (``kernel:<wrapper>``) or ``reduce_partials``. ``inputs`` and
    ``outputs`` are ``(dtype, shape, device, storage)`` of each tensor;
    ``cross`` marks a copy between two CUDA devices."""
    name: str
    inputs: list
    outputs: list
    cross: bool = False


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _metas(tree) -> list:
    return [(t.dtype, tuple(t.shape), t.device, _storage(t))
            for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _crosses(metas) -> bool:
    return len({m[2] for m in metas if m[2].type == "cuda"}) > 1


class Recorder(TorchDispatchMode):
    """Every aten op under it, with its operands' and results' metadata."""

    def __init__(self):
        super().__init__()
        self.ops: list[Op] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.namespace == "aten":
            ins, outs = _metas((args, kwargs)), _metas(out)
            self.ops.append(Op(func.overloadpacket.__name__, ins, outs,
                               cross=_crosses(ins + outs)))
        return out


class _CudaOnCpuBuild(TorchFunctionMode):
    """Fake CUDA tensors on a CPU-only build of torch (module docstring):
    a call over fake CUDA tensors sees their device as the CPU for its
    length and its new fake results are put back on that CUDA device; a
    device move is ``aten._to_copy``. A call over fake tensors of two CUDA
    devices is noted in ``crossings`` (the recorder sees them as CPU
    tensors). Property reads pass through."""

    MOVES = (torch.Tensor.to, torch.Tensor.cpu, torch.Tensor.cuda)

    def __init__(self):
        super().__init__()
        self.crossings = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        kwargs = kwargs or {}
        if getattr(func, "__name__", "") == "__get__":
            return func(*args, **kwargs)
        if func in self.MOVES:
            return self._move(func, args, kwargs)
        fakes = {id(t): t for t in tree_flatten((args, kwargs))[0]
                 if isinstance(t, FakeTensor) and t.fake_device.type == "cuda"}
        if not fakes:
            return func(*args, **kwargs)
        devices = {t.fake_device for t in fakes.values()}
        if len(devices) > 1:
            self.crossings += 1
        device = min(devices, key=str)
        homes = [(t, t.fake_device) for t in fakes.values()]
        for t, _ in homes:
            t.fake_device = torch.device("cpu")
        try:
            out = func(*args, **kwargs)
        finally:
            for t, home in homes:
                t.fake_device = home
        for o in tree_flatten(out)[0]:
            if isinstance(o, FakeTensor) and o.fake_device.type == "cpu":
                o.fake_device = device
        return out

    @staticmethod
    def _move(func, args, kwargs):
        t = args[0]
        if func is torch.Tensor.cpu:
            device, dtype, non_blocking = torch.device("cpu"), None, False
        elif func is torch.Tensor.cuda:
            device, dtype, non_blocking = torch.device("cuda", 0), None, False
        else:
            device, dtype, non_blocking, _ = torch._C._nn._parse_to(
                *args[1:], **kwargs)
        if (device is None or torch.device(device) == t.device) \
                and (dtype is None or dtype == t.dtype):
            return t
        return torch.ops.aten._to_copy.default(
            t, dtype=dtype or t.dtype, device=device or t.device,
            non_blocking=non_blocking)


def _kernel_name(launcher: str, args, kwargs) -> str:
    if launcher == "_launch":
        k_scale = args[5] if len(args) > 5 else kwargs.get("k_scale")
        return "paged_decode_attention" + ("" if k_scale is None
                                           else "_quant")
    return {"_launch_ragged": "ragged_decode_attention",
            "_launch_flash": "flash_attention"}[launcher]


@contextlib.contextmanager
def recording(real: bool = False):
    """Record every aten op, kernel launch and ``reduce_partials`` call
    under it into the yielded :class:`Recorder`. Fake (``real=False``):
    each launcher returns an empty output of its kernel's shape and the
    wrappers' launch counts are set back after. Real: the kernels run."""
    from ...models import transformer
    from ...ops import attention, paged_attention
    rec = Recorder()
    swaps = [(paged_attention, "_launch"), (paged_attention, "_launch_ragged"),
             (attention, "_launch_flash"), (transformer, "reduce_partials")]
    saved = [(mod, name, getattr(mod, name)) for mod, name in swaps]
    counted = list(paged_attention.COUNTED) + [attention.flash_attention]
    counts = [w.launches for w in counted]

    def launcher(name, launch):
        def record(*args, **kwargs):
            op = Op("kernel:" + _kernel_name(name, args, kwargs),
                    _metas((args, kwargs)), [])
            rec.ops.append(op)
            out = launch(*args, **kwargs) if real else torch.empty_like(args[0])
            op.outputs = _metas(out)
            return out
        return record

    def reduce(reduce_partials):
        def record(parts, device):
            rec.ops.append(Op("reduce_partials", _metas(parts), []))
            return reduce_partials(parts, device)
        return record

    try:
        for mod, name, orig in saved:
            setattr(mod, name, reduce(orig) if name == "reduce_partials"
                    else launcher(name, orig))
        with rec:
            yield rec
    finally:
        for mod, name, orig in saved:
            setattr(mod, name, orig)
        if not real:
            for w, n in zip(counted, counts):
                w.launches = n


# -- the cell's state -----------------------------------------------------------

@dataclass
class CellState:
    """What an engine of ``cell`` holds, built by :func:`traced_cell`:
    ``full`` is the unsharded weight tree on ``meta`` (the shapes the
    layout slices), ``params`` the engine's weights (rank shards under
    tp > 1) and ``state`` the ``abstract_state`` trees."""
    cell: Cell
    cfg: Any
    ecfg: Any
    policy: Any
    factory: Any
    params: Any
    full: Any
    state: dict
    buckets: list
    spec_lens: tuple
    real: bool = False
    shim: Optional[_CudaOnCpuBuild] = None

    def jobs(self) -> list:
        return list(self.factory.lowering_jobs(
            self.params, self.state["kv_cache"], self.state["pool"],
            self.state["scratch"], self.state["mb"], self.buckets,
            self.spec_lens))

    @property
    def tp(self) -> int:
        return self.policy.topology.tp


def engine_config(cell: Cell):
    """The ``EngineConfig`` an engine of ``cell`` runs under."""
    from ...serving.engine import EngineConfig
    return EngineConfig(
        max_batch=cell.max_batch, max_seq_len=cell.max_seq_len,
        prefill_buckets=(cell.prefill_buckets if not cell.paged
                         else (cell.chunk, cell.max_seq_len)),
        decode_steps=cell.decode_steps,
        kv_block_size=cell.kv_block_size if cell.paged else 0,
        kv_pool_blocks=cell.kv_pool_blocks,
        prefill_chunk=cell.chunk if cell.paged else 0,
        spec_len=cell.spec_len, kv_quant=cell.kv_quant,
        admit_group_chunks=cell.admit_group_chunks)


@contextlib.contextmanager
def traced_cell(cell: Cell, real: bool = False, device="cuda:0"):
    """Build :class:`CellState` for ``cell`` and keep the mode it was built
    in for the jobs: fake CUDA tensors (and on a CPU-only build
    ``_CudaOnCpuBuild``), or with ``real`` real tensors on ``device``,
    zero-filled weights (a forward over zeros writes no NaN)."""
    from ...serving.graphs import GraphFactory, abstract_state, window_state
    from ...serving.presets import abstract_params_for, resolve_preset
    from ...serving.shard.plan import parse_topology
    from ...serving.shard.policy import make_policy

    cfg, quantized = resolve_preset(cell.preset, cell.quantize or None)
    cfg = replace(cfg, n_layers=cell.n_layers)
    ecfg = engine_config(cell)
    device = torch.device(device)
    topo = parse_topology(cell.topology)
    policy = make_policy(topo, devices=[device] * topo.n_chips)
    # meta trees are sliced before any fake mode: a fake tensor is never meta
    full = abstract_params_for(cfg, quantized)
    abstract = policy.abstract(full, cfg)
    with contextlib.ExitStack() as stack:
        shim = None
        if not real:
            from torch._subclasses.fake_tensor import FakeTensorMode
            stack.enter_context(FakeTensorMode(allow_non_fake_inputs=True))
            if not torch.backends.cuda.is_built():
                shim = stack.enter_context(_CudaOnCpuBuild())
        params = policy.materialize(abstract)
        state = abstract_state(cfg, ecfg, bool(cell.kv_quant), device=device,
                               policy=policy)
        # greedy windows draw nothing; a fake mode has no CUDA generator
        gen = None if real else torch.Generator()
        window = window_state(params, state["kv_cache"], ecfg, device, gen)
        factory = GraphFactory(cfg, ecfg, ecfg.prefill_chunk, device,
                               window=window, policy=policy)
        factory.captures = False
        buckets = sorted({min(bk, ecfg.max_seq_len)
                          for bk in ecfg.prefill_buckets})
        spec_lens = (ecfg.spec_len,) if ecfg.spec_len > 0 else ()
        yield CellState(cell, cfg, ecfg, policy, factory, params, full, state,
                        buckets, spec_lens, real, shim)


# -- the trees a job reads and writes -------------------------------------------

def kv_leaves(tree, name: str = "", rank: int = 0):
    """``(rank, name, tensor)`` of every tensor of a KV tree: a dict's
    entries by key, a :class:`Ranked`'s by rank."""
    if isinstance(tree, torch.Tensor):
        yield rank, name, tree
    elif isinstance(tree, Ranked):
        for r, sub in enumerate(tree):
            yield from kv_leaves(sub, name, r)
    elif isinstance(tree, dict):
        for k, sub in tree.items():
            yield from kv_leaves(sub, k, rank)


def _in_tree(args, window, index):
    return window.kv_cache if index is None else args[index]


def _out_tree(kind: str, out, window, index):
    if kind in WINDOWS:
        return window.kv_cache
    return out if index is None else out[index]


def kv_outputs(kind: str, out, window, paged: bool) -> list:
    """``(role, rank, name, tensor)`` of a job's KV results: role
    ``"pool"`` carries the pool's dtype (int8 under ``kv_quant``), role
    ``"model"`` the model's (scratch, gathered prefix, dense cache)."""
    if kind in WINDOWS:
        trees = [("pool" if paged else "model", window.kv_cache)]
    elif kind == "splice":
        trees = [("pool", out)]
    elif kind == "chunkgroup":
        trees = [("pool", out[0]), ("model", out[1])]
    elif kind == "gather":
        trees = [("model", out)]
    elif kind == "dsplice":
        trees = [("model", {"k": out[0], "v": out[1]})]
    else:                                   # chunk, prefill: (logits, kv)
        trees = [("model", out[1])]
    return [(role, r, n, t) for role, tree in trees
            for r, n, t in kv_leaves(tree)]


def _head_axis(name: str, ndim: int) -> int:
    return ndim - 1 if name.endswith("_scale") else ndim - 2


# -- per-job verification ---------------------------------------------------------

def check_job(cs: CellState, key, build, args) -> tuple[list, Recorder]:
    """Run one job (``build()(*args)``) under :func:`recording` and check
    GRA002-GRA004 on its record. Returns (findings, the record)."""
    kind = kind_of(key)
    name = cs.cell.name
    window = cs.factory.window
    donated = EXPECTED_DONATION.get(kind, ())
    before = {what: {(r, n): _storage(t) for r, n, t
                     in kv_leaves(_in_tree(args, window, i))}
              for what, i, _ in donated}
    crossings = cs.shim.crossings if cs.shim is not None else 0
    with recording(cs.real) as rec:
        out = build()(*args)
    findings: list[Finding] = []
    kv_outs = kv_outputs(kind, out, window, bool(cs.factory.chunk))

    # ---- GRA002 ----
    if cs.tp > 1:
        heads = [rc.n_kv_heads for _, rc in cs.policy.rank_specs(cs.cfg)]
        for _, r, n, t in kv_outs:
            if n == "table":
                continue
            got = t.shape[_head_axis(n, t.dim())]
            if got != heads[r]:
                findings.append(_f(
                    "GRA002", name, key,
                    f"KV output `{n}` of rank {r} holds {got} kv heads, the "
                    f"rank's share is {heads[r]}: the pool was gathered "
                    "across ranks"))
        gathered = _gathered_shapes(cs)
        for op in rec.ops:
            hit = next((gathered[m[1]] for m in op.outputs
                        if m[1] in gathered), None)
            if hit:
                findings.append(_f(
                    "GRA002", name, key,
                    f"`{op.name}` makes `{hit}` with every kv head: a rank "
                    "gathered the pool to all heads"))
                break
    else:
        if any(op.cross for op in rec.ops) or (
                cs.shim is not None and cs.shim.crossings > crossings):
            findings.append(_f(
                "GRA002", name, key,
                "a copy between CUDA devices in a SINGLE-DEVICE graph: the "
                "1x1 policy must run the unsharded engine's graphs"))
        # one rank's reduce_partials is its partial as it is
        if any(op.name == "reduce_partials" and len(op.inputs) > 1
               for op in rec.ops):
            findings.append(_f(
                "GRA002", name, key,
                "reduce_partials over several partials in a SINGLE-DEVICE "
                "graph: the 1x1 policy must run the unsharded engine's "
                "graphs"))

    # ---- GRA003 ----
    for what, i, j in donated:
        after = {(r, n): _storage(t) for r, n, t
                 in kv_leaves(_out_tree(kind, out, window, j))}
        moved = sorted(n for (r, n), st in before[what].items()
                       if after.get((r, n)) != st)
        if moved:
            arg = "the window's" if i is None else f"arg {i}"
            findings.append(_f(
                "GRA003", name, key,
                f"{what} ({arg}) is not written in place: `{moved[0]}` "
                "comes back in new storage, so every call would copy the "
                "buffer instead of updating it"))
        shapes = {tuple(t.shape): n for _, n, t
                  in kv_leaves(_in_tree(args, window, i)) if n != "table"}
        storages = set(before[what].values())
        for op in rec.ops:
            hit = next((shapes[m[1]] for m in op.outputs
                        if m[1] in shapes and m[3] not in storages), None)
            if hit:
                findings.append(_f(
                    "GRA003", name, key,
                    f"`{op.name}` makes a new tensor the shape of the whole "
                    f"`{hit}` of {what}: the job rebuilds the buffer out "
                    "of place"))
                break

    # ---- GRA004 ----
    for op in rec.ops:
        if op.name in MATMULS and any(m[0] == torch.int8 for m in op.inputs):
            findings.append(_f(
                "GRA004", name, key,
                f"`{op.name}` with int8 operand(s) "
                f"{[str(m[0]) for m in op.inputs]}: int8 storage reached a "
                "matmul undequantized, its values missing their scales"))
    model_dt = cs.cfg.dtype
    pool_dt = torch.int8 if cs.cell.kv_quant else model_dt
    for role, r, n, t in kv_outs:
        if n == "table":
            continue
        if n.endswith("_scale"):
            if t.dtype != torch.float32:
                findings.append(_f(
                    "GRA004", name, key,
                    f"scale plane `{n}` left the graph as {t.dtype}, "
                    "expected torch.float32"))
            continue
        want = pool_dt if role == "pool" else model_dt
        if t.dtype != want:
            findings.append(_f(
                "GRA004", name, key,
                f"KV output `{n}` left the graph as {t.dtype}, expected "
                f"{want} ({'pool storage' if role == 'pool' else 'model'} "
                "dtype): the quant boundary leaked"))
    return findings, rec


def _gathered_shapes(cs: CellState) -> dict:
    """The shapes of each rank KV plane (and of one layer of it) with
    every kv head: what a gather of the pool to all heads makes."""
    out = {}
    trees = [cs.state["kv_cache"]] + ([cs.state["scratch"]]
                                      if cs.factory.chunk else [])
    for tree in trees:
        for _, n, t in kv_leaves(tree):
            if n == "table":
                continue
            shape = list(t.shape)
            shape[_head_axis(n, t.dim())] *= cs.tp
            out[tuple(shape)] = n
            out[tuple(shape[1:])] = n
    return out


# -- GRA001: the weights over the ranks --------------------------------------------

def _weight_leaves(tree, path: str = ""):
    """``(path, leaf)`` of a rank's weight tree, a leaf being a tensor or
    :class:`Pieces` (fsdp pieces, not walked into)."""
    if isinstance(tree, (torch.Tensor, Pieces)):
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _weight_leaves(v, f"{path}/{k}".lstrip("/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _weight_leaves(v, f"{path}/{i}".lstrip("/"))


def _joined_shape(leaf) -> tuple:
    """A leaf's shape with its fsdp pieces joined."""
    if not isinstance(leaf, Pieces):
        return tuple(leaf.shape)
    shapes = [_joined_shape(p) for p in leaf]
    joined = list(shapes[0])
    joined[leaf.dim] = sum(s[leaf.dim] for s in shapes)
    return tuple(joined)


def _declared(lay, path: str, r: int, size: int) -> bool:
    """Whether the layout splits leaf ``path`` over tp (an int8 entry's
    payload by its owner's name; its scale may stay whole)."""
    parts = path.split("/")
    if parts[-1] == "scale":
        return False
    owner = parts[-2] if parts[-1] == "q" else parts[-1]
    return lay.tp_range(owner, r, size) is not None


def weight_findings(cs: CellState) -> list:
    """GRA001's static half: every leaf the layout declares split over tp
    is smaller on every rank than the full leaf."""
    if cs.tp == 1:
        return []
    lay = cs.policy.layout(cs.cfg)
    full = {p: tuple(t.shape) for p, t in named_leaves(cs.full)}
    findings = []
    for r, tree in enumerate(cs.params):
        held = dict(_weight_leaves(tree))
        for path, shape in full.items():
            if path not in held or not _declared(lay, path, r, shape[-1]):
                continue
            if _joined_shape(held[path]) == shape:
                findings.append(_f(
                    "GRA001", cs.cell.name, path,
                    f"weight leaf {path} is declared split over tp but rank "
                    f"{r} holds it whole {list(shape)}: every rank holds the "
                    "full tensor, all the memory and none of the capacity"))
    return findings


def shard_shapes(cs: CellState) -> set:
    """The shapes (and 2-d transposes) of the rank shards of every leaf the
    layout splits: a matmul operand of one of them takes a rank shard."""
    lay = cs.policy.layout(cs.cfg)
    full = {p: tuple(t.shape) for p, t in named_leaves(cs.full)}
    out = set()
    for r, tree in enumerate(cs.params):
        for path, leaf in _weight_leaves(tree):
            shape = _joined_shape(leaf)
            if path in full and shape != full[path] \
                    and _declared(lay, path, r, full[path][-1]):
                out.add(shape)
                if len(shape) == 2:
                    out.add(shape[::-1])
    return out


# -- the matrix runner --------------------------------------------------------------

def signature_findings(cell_name: str, have: set, want: set) -> list:
    """GRA005: the precompiled key set (``have``: the ``lowering_jobs``
    keys) equals the set the serve loop can request (``want``:
    ``reachable_keys``)."""
    findings: list[Finding] = []
    for k in sorted(map(str, want - have)):
        findings.append(_f(
            "GRA005", cell_name, k,
            "signature reachable from the WindowScheduler but NOT "
            "precompiled: the first request hitting it stalls every stream "
            "behind a build (and on the card a capture)"))
    for k in sorted(map(str, have - want)):
        findings.append(_f(
            "GRA005", cell_name, k,
            "signature precompiled but not reachable from the serve loop: "
            "dead bring-up work (or reachable_keys is stale)"))
    return findings


def check_cell(cs: CellState) -> tuple[list, dict]:
    """Every rule over every job of a built cell: (findings, the kernel
    launches each wrapper's kernel made or would make)."""
    jobs = cs.jobs()
    findings = signature_findings(
        cs.cell.name, {k for k, _, _ in jobs},
        cs.factory.reachable_keys(cs.buckets, cs.spec_lens))
    findings += weight_findings(cs)
    shards = shard_shapes(cs) if cs.tp > 1 else set()
    took_shard = False
    kernels: dict = {}
    for key, build, args in jobs:
        fs, rec = check_job(cs, key, build, args)
        findings += fs
        for op in rec.ops:
            if op.name.startswith("kernel:"):
                k = op.name[len("kernel:"):]
                kernels[k] = kernels.get(k, 0) + 1
            elif op.name in MATMULS and any(m[1] in shards
                                            for m in op.inputs):
                took_shard = True
    if cs.tp > 1 and not took_shard:
        findings.append(_f(
            "GRA001", cs.cell.name, "*",
            "no matmul takes a rank shard under tp>1: the layout did not "
            "split this param tree, every product runs on whole weights"))
    return findings, kernels


def run_cell(cell: Cell, real: bool = False, device="cuda:0") -> tuple:
    """(findings, stats) for one cell; ``stats["kernels"]`` counts the
    kernel launches of its jobs (made with ``real``, else traced)."""
    t0 = time.perf_counter()
    with traced_cell(cell, real=real, device=device) as cs:
        n_jobs = len(cs.jobs())
        findings, kernels = check_cell(cs)
    stats = {"cell": cell.name, "jobs": n_jobs,
             "elapsed_s": round(time.perf_counter() - t0, 3),
             "kernels": kernels}
    return findings, stats


def run_matrix(cells: Optional[list] = None, real: bool = False,
               device="cuda:0") -> dict:
    """Pass A over ``cells`` (the whole matrix by default). Returns
    ``{"findings": [...], "cells": [stats...], "elapsed_s": float}``."""
    t0 = time.perf_counter()
    findings: list[Finding] = []
    stats = []
    for cell in (cells if cells is not None else list(MATRIX)):
        f, s = run_cell(cell, real=real, device=device)
        findings.extend(f)
        stats.append(s)
    return {"findings": findings, "cells": stats,
            "elapsed_s": round(time.perf_counter() - t0, 3)}
