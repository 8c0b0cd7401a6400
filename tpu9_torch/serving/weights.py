"""Streamable param-tree weight format (``*.tpu9w`` directories), the
port's copy of ``tpu9/serving/weights.py``.

A tree is saved as one raw little-endian shard file per tensor leaf plus an
``index.json`` describing dtype, shape and order, inside a directory whose
name ends in ``.tpu9w``. The files are byte for byte the ones the JAX
package writes for the same tree, so each package restores the other's
checkpoints. Because shards are raw bytes, checkpoint chunks can be fed
straight from the cache into a host buffer and handed to the device the
moment a shard completes (``tpu9_torch/worker/weightstream.py``).

Leaves are torch tensors; dtype names in the index are numpy's
(``bfloat16``, ``float32``, ``int8``, ``int32``). bf16 needs no
``ml_dtypes``: its shards are read as raw 16-bit words and viewed as
``torch.bfloat16``.

Scalars (python int/float/bool/str/None leaves) ride in the index skeleton;
only tensor leaves become shards.

Index versions (the ``version`` field; absent == 1):

- **v1** — plain param trees, every leaf an independent shard.
- **v2** — quantized trees: leaves come in ``{q: int8, scale: f32}`` pairs
  (``tpu9_torch.ops.quant``), annotated with a ``role`` field on their
  index entries and ``quantized: true`` at the top level. The byte layout
  is that of v1.

Readers call :func:`check_index` before touching leaves.
"""

from __future__ import annotations

import hashlib
import json
import os
import warnings
from typing import Any, Optional

import numpy as np
import torch

WEIGHTS_SUFFIX = ".tpu9w"
INDEX_NAME = "index.json"
FORMAT = "tpu9-weights-v1"
# index versions this reader understands (absent `version` field == 1)
SUPPORTED_VERSIONS = (1, 2)

_LEAF = "__leaf__"
_SCALAR = "__scalar__"
_TUPLE = "__tuple__"

# numpy dtype name -> (numpy dtype of the shard's words, torch dtype)
_DTYPES = {
    "bfloat16": (np.dtype(np.uint16), torch.bfloat16),
    "float16": (np.dtype(np.float16), torch.float16),
    "float32": (np.dtype(np.float32), torch.float32),
    "float64": (np.dtype(np.float64), torch.float64),
    "int8": (np.dtype(np.int8), torch.int8),
    "uint8": (np.dtype(np.uint8), torch.uint8),
    "int16": (np.dtype(np.int16), torch.int16),
    "int32": (np.dtype(np.int32), torch.int32),
    "int64": (np.dtype(np.int64), torch.int64),
    "bool": (np.dtype(np.bool_), torch.bool),
}
_NAME_OF = {tdt: name for name, (_, tdt) in _DTYPES.items()}


def _dtype(name: str) -> tuple[np.dtype, torch.dtype]:
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"{FORMAT}: dtype {name!r} is not supported by "
                         f"this reader (have {sorted(_DTYPES)})") from None


def dtype_name(t: torch.Tensor) -> str:
    """The numpy name of a tensor's dtype, as the index records it."""
    try:
        return _NAME_OF[t.dtype]
    except KeyError:
        raise TypeError(f"dtype {t.dtype} is not {FORMAT}-representable") \
            from None


def byte_view(t: torch.Tensor) -> torch.Tensor:
    """A non-empty tensor's bytes as a flat uint8 tensor (a view where it
    is contiguous)."""
    return t.contiguous().reshape(-1).view(torch.uint8)


def from_numpy(arr: np.ndarray) -> torch.Tensor:
    """A host tensor over ``arr``'s memory (without a copy where it is
    contiguous); a ``bfloat16``-named dtype (an ``ml_dtypes`` array) is
    taken as its 16-bit words."""
    if not arr.flags.c_contiguous:
        arr = np.ascontiguousarray(arr)       # (which makes 0-d arrays 1-d)
    bf16 = arr.dtype.name == "bfloat16"
    if bf16:
        arr = arr.view(np.uint16)
    with warnings.catch_warnings():
        # a read-only array (a read-only mapping) is only ever read here
        warnings.simplefilter("ignore", UserWarning)
        t = torch.from_numpy(arr)
    return t.view(torch.bfloat16) if bf16 else t


def _flatten(node: Any, path: str, leaves: list) -> Any:
    """Walk the tree depth-first, building a JSON skeleton whose tensor
    leaves are ``{"__leaf__": i}`` markers into ``leaves`` (order = stream
    order). Dicts keep insertion order."""
    if isinstance(node, dict):
        for k in node:
            if not isinstance(k, str) or k in (_LEAF, _SCALAR, _TUPLE):
                # int keys would come back as strings, marker-named keys
                # would be misparsed by _unflatten: refuse both (the
                # runner-level saver falls back to torch.save)
                raise TypeError(f"{path or '/'}: dict key {k!r} does not "
                                f"round-trip through {FORMAT}")
        return {k: _flatten(v, f"{path}/{k}", leaves)
                for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        if hasattr(node, "_fields"):
            # a NamedTuple would silently come back as a plain tuple
            raise TypeError(f"{path or '/'}: NamedTuple containers do not "
                            f"round-trip through {FORMAT}")
        out = [_flatten(v, f"{path}/{i}", leaves)
               for i, v in enumerate(node)]
        # tuples come back as tuples
        return {_TUPLE: out} if isinstance(node, tuple) else out
    if isinstance(node, (bool, int, float, str)) or node is None:
        return {_SCALAR: node}
    # a tensor leaf stays where it is (on the device) until its own write
    if not isinstance(node, torch.Tensor):
        arr = np.asarray(node)
        if arr.dtype == object:
            # an unrecognized container np.asarray'd into an object array
            raise TypeError(f"{path or '/'}: {type(node).__name__} is not a "
                            f"{FORMAT}-representable node")
        node = from_numpy(arr)
    leaves.append((path.lstrip("/"), node))
    return {_LEAF: len(leaves) - 1}


def _unflatten(skel: Any, arrays: list) -> Any:
    if isinstance(skel, dict):
        if _LEAF in skel:
            return arrays[skel[_LEAF]]
        if _SCALAR in skel:
            return skel[_SCALAR]
        if _TUPLE in skel:
            return tuple(_unflatten(v, arrays) for v in skel[_TUPLE])
        return {k: _unflatten(v, arrays) for k, v in skel.items()}
    if isinstance(skel, list):
        return [_unflatten(v, arrays) for v in skel]
    raise ValueError(f"malformed weights skeleton node: {skel!r}")


def flatten_tree(tree: Any) -> tuple[Any, list[tuple[str, torch.Tensor]]]:
    """Return ``(skeleton, [(key, tensor), ...])`` in stream order."""
    leaves: list[tuple[str, torch.Tensor]] = []
    skel = _flatten(tree, "", leaves)
    return skel, leaves


def check_index(index: dict, src: str = "") -> int:
    """Validate an index's format family AND version; returns the version.
    An unknown version fails here, not halfway through a restore."""
    where = f"{src}: " if src else ""
    if index.get("format") != FORMAT:
        raise ValueError(f"{where}not a {FORMAT} index: "
                         f"{index.get('format')!r}")
    version = index.get("version", 1)
    if version not in SUPPORTED_VERSIONS:
        raise ValueError(
            f"{where}.tpu9w index version {version} is not supported by "
            f"this reader (supported: {SUPPORTED_VERSIONS}) — upgrade "
            "tpu9 to restore this checkpoint")
    return version


def _mark_quant_pairs(entries: list[dict]) -> int:
    """Annotate quantized ``{q, scale}`` leaf pairs: an int8 leaf at
    ``<path>/q`` whose sibling ``<path>/scale`` exists gets ``role: "q"``
    and the sibling ``role: "scale"``. Returns the pair count — a nonzero
    count is what makes an index version 2."""
    by_key = {e["key"]: e for e in entries}
    pairs = 0
    for e in entries:
        if e["key"].endswith("/q") and e["dtype"] == "int8":
            sib = by_key.get(e["key"][:-len("/q")] + "/scale")
            if sib is not None:
                e["role"] = "q"
                sib["role"] = "scale"
                pairs += 1
    return pairs


def build_index(tree: Any) -> tuple[dict, list[torch.Tensor]]:
    skel, leaves = flatten_tree(tree)
    entries = []
    arrays = []
    for i, (key, t) in enumerate(leaves):
        entries.append({"i": i, "key": key, "file": f"{i:06d}.bin",
                        "dtype": dtype_name(t), "shape": list(t.shape),
                        "nbytes": t.numel() * t.element_size()})
        arrays.append(t)
    pairs = _mark_quant_pairs(entries)
    index = {"format": FORMAT, "version": 2 if pairs else 1,
             "skeleton": skel, "leaves": entries,
             "total_bytes": int(sum(e["nbytes"] for e in entries))}
    if pairs:
        index["quantized"] = True
    return index, arrays


def save_params(tree: Any, dest: str, quantize: Optional[str] = None) -> dict:
    """Write ``tree`` as a ``.tpu9w`` directory at ``dest`` (created); pick
    a ``dest`` ending in :data:`WEIGHTS_SUFFIX`.

    ``quantize="int8"`` runs ``tpu9_torch.ops.quant.quantize_decoder`` over
    the tree first: the shards land about 2x smaller, as v2. Trees already
    holding quantized pairs mark themselves v2 with or without the flag."""
    if quantize:
        from ..ops.quant import validate_quant_mode
        validate_quant_mode(quantize)
        if quantize != "int8":
            raise NotImplementedError(
                f"quantize mode {quantize!r} is not wired into save_params")
        if not (isinstance(tree, dict) and "layers" in tree):
            raise ValueError("quantize='int8' needs a decoder param tree "
                             "(dict with 'layers'); save this tree plain")
        from ..ops.quant import quantize_decoder
        tree = quantize_decoder(tree)
    index, arrays = build_index(tree)
    os.makedirs(dest, exist_ok=True)
    for entry, t in zip(index["leaves"], arrays):
        with open(os.path.join(dest, entry["file"]), "wb") as f:
            # ONE leaf on the host at a time, written through a uint8 view
            # (a bytes copy would double it): peak host memory stays one
            # leaf inside a container sized to the model
            if t.numel():
                f.write(byte_view(t.detach().to("cpu")).numpy().data)
    with open(os.path.join(dest, INDEX_NAME), "w") as f:
        json.dump(index, f)
    return index


def shard_to_array(buf, entry: dict) -> torch.Tensor:
    """Zero-copy view of a filled shard buffer (a writable buffer, or an
    ``np.memmap``) as its typed host tensor."""
    words, dtype = _dtype(entry["dtype"])
    arr = buf.view(words) if isinstance(buf, np.ndarray) \
        else np.frombuffer(buf, dtype=words)
    return from_numpy(arr.reshape(entry["shape"])).view(dtype)


def assemble(index: dict, arrays: list) -> Any:
    """Rebuild the tree from a parsed index + tensors in leaf order."""
    check_index(index)
    if len(arrays) != len(index["leaves"]):
        raise ValueError(f"have {len(arrays)} arrays for "
                         f"{len(index['leaves'])} leaves")
    return _unflatten(index["skeleton"], list(arrays))


def read_index(src: str) -> dict:
    """The checked index of the ``.tpu9w`` directory ``src``."""
    with open(os.path.join(src, INDEX_NAME)) as f:
        index = json.load(f)
    check_index(index, src)
    return index


def load_params(src: str, mmap: bool = False) -> Any:
    """Read a ``.tpu9w`` directory back into a tree of host tensors.
    ``mmap=True`` maps each shard (copy-on-write, so a tensor written to
    never touches the file) and wraps it without a copy; pages come in
    when read."""
    index = read_index(src)
    arrays = []
    for entry in index["leaves"]:
        path = os.path.join(src, entry["file"])
        need = int(entry["nbytes"])
        if mmap and need:
            buf = np.memmap(path, dtype=np.uint8, mode="c", shape=(need,))
        else:
            buf = np.empty(need, dtype=np.uint8)       # no zeroing pass
            with open(path, "rb") as f:
                got = f.readinto(buf)
            if got != need:
                raise IOError(f"{path}: shard has {got}/{need} bytes")
        arrays.append(shard_to_array(buf, entry))
    return assemble(index, arrays)


def is_weights_dir(path: str) -> bool:
    return path.endswith(WEIGHTS_SUFFIX) and os.path.isfile(
        os.path.join(path, INDEX_NAME))


def weight_group_of(rel_path: str) -> Optional[str]:
    """The ``.tpu9w`` group prefix of a manifest path, or None. The FIRST
    matching component wins (nested groups don't exist by construction)."""
    parts = rel_path.split("/")
    for i, part in enumerate(parts[:-1]):
        if part.endswith(WEIGHTS_SUFFIX):
            return "/".join(parts[: i + 1])
    return None


def manifest_weight_groups(manifest) -> dict[str, list]:
    """Group a manifest's entries (anything with ``.files`` whose entries
    carry ``.path``, ``.chunks`` and ``.link_target``) by ``.tpu9w``
    directory. Only groups with an ``index.json`` entry qualify. Symlink
    entries disqualify their group (a weights dir is flat regular files by
    construction)."""
    groups: dict[str, list] = {}
    bad: set[str] = set()
    for entry in manifest.files:
        group = weight_group_of(entry.path)
        if group is None:
            continue
        if entry.link_target:
            bad.add(group)
            continue
        groups.setdefault(group, []).append(entry)
    out = {}
    for group, entries in groups.items():
        if group in bad:
            continue
        if any(os.path.basename(e.path) == INDEX_NAME for e in entries):
            out[group] = entries
    return out


def content_key(entries) -> str:
    """Stable content hash of a weight group: the sorted (path, chunks)
    pairs, NUL-framed so no two groups share a key by concatenation. Two
    checkpoints of identical weights share the key."""
    h = hashlib.sha256()
    for entry in sorted(entries, key=lambda e: e.path):
        h.update(entry.path.encode() + b"\0")
        for c in entry.chunks:
            h.update(c.encode() + b"\0")
        h.update(b"\0")
    return h.hexdigest()
