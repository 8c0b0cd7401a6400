"""Runner-side checkpoint hooks for a torch handler, the port's copy of
``tpu9/runner/ckpt.py``: save and restore model state inside the container
workdir, so the worker's filesystem snapshot carries it.

The handler persists its params as streamable ``.tpu9w`` shards
(``tpu9_torch.serving.weights``, byte for byte the JAX package's format)
and the runner marks readiness; a restored container finds the state and
skips re-initialization. The directory and marker files are the
reference's, so the unchanged runner's ``mark_ready`` and the worker's
snapshot and streaming restore see a torch handler's checkpoint as they
see a JAX one's.

Handler usage:

    from tpu9_torch.runner import ckpt

    def load_engine():
        params = ckpt.maybe_restore(lambda: init_decoder(cfg, gen, "cuda"))
        return InferenceEngine(params, cfg, EngineConfig(), device="cuda")

Restored and first boots hand back the same placement: the current CUDA
device unless the caller passes ``device="cpu"`` (a missing card raises).
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import shutil
from typing import Any, Callable

import torch

from ..observability import coldstart as cs
from ..serving import weights as wfmt
from ..utils.platform import default_device
from ..worker.weightstream import make_device_put

log = logging.getLogger("tpu9_torch.runner")

CKPT_DIR_NAME = ".tpu9-ckpt"
# the fallbacks for trees the format cannot represent, beside the .tpu9w
# dir: ``.pt`` for trees the safe unpickler restores (tensors, plain dicts,
# lists and tuples, Python scalars), ``.pickle`` for the rest (NamedTuple
# containers, object leaves), which restore through the full unpickler
FALLBACK_SUFFIX = ".pt"
PICKLE_SUFFIX = ".pickle"
_SAFE_LEAVES = (torch.Tensor, str, int, float, bool, type(None))


def env_checkpoint_enabled() -> bool:
    """``TPU9_CHECKPOINT_ENABLED=1``: arm the checkpoint plane. Copy of
    ``tpu9/config.py:env_checkpoint_enabled``."""
    return os.environ.get("TPU9_CHECKPOINT_ENABLED") == "1"


def ckpt_dir() -> str:
    base = os.environ.get("TPU9_WORKDIR", os.getcwd())
    d = os.path.join(base, CKPT_DIR_NAME)
    os.makedirs(d, exist_ok=True)
    return d


def is_restored() -> bool:
    return os.path.exists(os.path.join(ckpt_dir(), "READY"))


def mark_ready(meta: dict | None = None) -> None:
    with open(os.path.join(ckpt_dir(), "meta.json"), "w") as f:
        json.dump(meta or {}, f)
    with open(os.path.join(ckpt_dir(), "READY"), "w") as f:
        f.write("1")


def _weights_path(name: str) -> str:
    return os.path.join(ckpt_dir(), name + wfmt.WEIGHTS_SUFFIX)


def _fallback_path(name: str, safe: bool = True) -> str:
    return os.path.join(ckpt_dir(),
                        name + (FALLBACK_SUFFIX if safe else PICKLE_SUFFIX))


def _weights_only_safe(tree: Any) -> bool:
    """Whether ``torch.load(weights_only=True)`` restores ``tree``: plain
    dicts, lists and tuples of tensors and Python scalars."""
    if type(tree) is dict:
        return all(isinstance(k, _SAFE_LEAVES) and _weights_only_safe(v)
                   for k, v in tree.items())
    if type(tree) in (list, tuple):
        return all(_weights_only_safe(v) for v in tree)
    return isinstance(tree, _SAFE_LEAVES)


def save_params(params: Any, name: str = "params",
                quantize: str | None = None) -> str:
    """Persist a tree of tensors in the streamable ``.tpu9w`` format;
    returns the path written.

    ``quantize`` (default: the ``TPU9_CKPT_QUANT`` env, e.g. ``"int8"``)
    quantizes decoder projections at save time, emitting about 2x smaller
    v2 shards. The saved tree is what a restore serves, so only set it for
    deployments meant to serve int8.

    Trees the format cannot represent (NamedTuple containers, non-string
    dict keys, object leaves) fall back to ``torch.save`` of the tree
    beside the ``.tpu9w`` path, which ``load_params`` restores: a ``.pt``
    file where the safe unpickler can (``weights_only=True``), else a
    ``.pickle`` file."""
    if quantize is None:
        quantize = os.environ.get("TPU9_CKPT_QUANT", "") or None
    if quantize:
        # quantize BEFORE the representability try below: a bad mode or a
        # quantizer bug fails loudly here instead of riding the fallback
        # and shipping full-size shards
        from ..ops.quant import validate_quant_mode
        validate_quant_mode(quantize)
        if quantize != "int8":
            raise NotImplementedError(
                f"quantize mode {quantize!r} is not wired into ckpt save")
        if isinstance(params, dict) and "layers" in params:
            from ..ops.quant import quantize_decoder
            params = quantize_decoder(params)   # idempotent on int8 trees
        else:
            # the env var is deployment-wide; a handler's non-decoder side
            # state still saves streamable, just unquantized
            log.info("params %r is not a decoder tree; saving "
                     "unquantized despite TPU9_CKPT_QUANT=%s", name,
                     quantize)
    path = _weights_path(name)
    try:
        wfmt.build_index(params)           # representable, or TypeError
    except TypeError as exc:
        log.info("params %r not streamable (%s); saving via torch.save",
                 name, exc)
        fallback = _fallback_path(name, _weights_only_safe(params))
        torch.save(params, fallback)
        return fallback
    try:
        wfmt.save_params(params, path)
    except BaseException:
        shutil.rmtree(path, ignore_errors=True)   # no partial .tpu9w dir
        raise
    return path


def _tree_map(fn: Callable[[torch.Tensor], torch.Tensor], tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_tree_map(fn, v) for v in tree]
        if hasattr(tree, "_fields"):
            return type(tree)(*out)
        return type(tree)(out) if isinstance(tree, tuple) else out
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def to_device(tree: Any, device) -> Any:
    """``tree`` with every tensor on ``device``: host tensors move leaf by
    leaf through one ring of pinned buffers
    (``worker.weightstream.make_device_put``), tensors already there stay
    as they are."""
    put = make_device_put(default_device(device))
    return _tree_map(lambda t: t if t.device == put.device else put.move(t),
                     tree)


def _saved(name: str) -> str | None:
    """The path ``name`` was saved under, newest format first."""
    for path in (_weights_path(name), _fallback_path(name),
                 _fallback_path(name, safe=False)):
        if os.path.exists(path):
            return path
    return None


def load_params(name: str = "params", template: Any = None,
                mmap: bool = False, device=None, tracer=None) -> Any:
    """Load saved params onto ``device`` (default: the current CUDA device,
    raising without one; ``"cpu"`` keeps host tensors): the ``.tpu9w`` dir
    first (``mmap=True`` maps shards instead of reading them up front), else
    the ``torch.save`` fallback. Both reproduce the saved tree exactly
    (tuples included), so ``template``, which shapes the reference's legacy
    orbax restores, is not read. Host leaves move to a card through a ring
    of pinned buffers on a copy stream of its own (``worker.weightstream``),
    so a load can run beside captures on another thread. With a ``tracer``
    (the reference's ``Tracer``, or anything with its ``span``) a
    ``.tpu9w`` load, the move included, records the reference's
    ``restore.load`` span under the caller's current span.

    A ``.pt`` fallback loads with ``weights_only=True``. A ``.pickle`` one
    (NamedTuple containers, object leaves) runs the full unpickler: it
    trusts the workdir, which this program wrote and the worker's snapshot
    restored."""
    del template
    device = default_device(device)
    path = _saved(name)
    if path is None:
        raise FileNotFoundError(f"no saved params {name!r} under "
                                f"{ckpt_dir()}")
    if not os.path.isdir(path):
        tree = torch.load(path, map_location="cpu",
                          weights_only=path.endswith(FALLBACK_SUFFIX))
        return to_device(tree, device)
    with (tracer.span(cs.SPAN_LOAD, attrs={"name": name, "source": "tpu9w",
                                           "mmap": mmap})
          if tracer is not None else contextlib.nullcontext()):
        return to_device(wfmt.load_params(path, mmap=mmap), device)


def maybe_restore(init_fn: Callable[[], Any], name: str = "params",
                  device=None, tracer=None) -> Any:
    """Restore saved params when running from a checkpoint; otherwise init
    and, with checkpointing on, save them so the next cold start restores.
    Either way the tensors come back on ``device`` (default: the current
    CUDA device, raising without one; ``"cpu"`` for host tensors).
    ``tracer`` goes to :func:`load_params`."""
    device = default_device(device)
    if is_restored() and _saved(name) is not None:
        log.info("restoring %s from checkpoint", name)
        return load_params(name, device=device, tracer=tracer)
    params = to_device(init_fn(), device)
    if env_checkpoint_enabled():
        log.info("saving %s for future restores", name)
        save_params(params, name)
    return params
