"""Serializable paged-KV blocks: the port's own copy of
``tpu9/serving/kvwire.py``, one versioned wire format for disaggregated
prefill/decode, drain migration and block-ship failover resume.

A payload either parses completely against a version this reader knows, or
fails loudly before any pool mutation, never with half a prefix spliced
into the cache. The bytes are the reference's: a payload this module
encodes from the same planes is byte-identical to the JAX package's, so
either engine adopts what the other exported.

Format v1 (little-endian)::

    magic    b"TPU9KV\\0"          7 bytes
    version  u16                   = 1
    hlen     u32                   header JSON byte length
    header   JSON (utf-8, sorted keys)
    planes   raw plane bytes, concatenated in header["planes"] order

Header fields:

- geometry: ``n_layers``, ``kv_block_size``, ``n_kv_heads``,
  ``head_dim``, ``kv_dtype`` ("bfloat16" | "int8" | ...): must match the
  importing pool exactly (block ids are meaningless across geometries);
- ``n_blocks`` / ``n_tokens`` / ``prefix_key`` (hex sha1 of the
  block-aligned token prefix, ``PrefixCache._key``): what the importer
  adopts into its prefix cache;
- ``topology``: informational; planes are always canonical full-head
  arrays (``[L, nb, BS, KH, D]`` payload, ``[L, nb, BS, KH]`` f32 scales);
- ``planes``: ordered ``{name, dtype, shape, nbytes}`` records.

Planes are torch tensors on the host. numpy has no bfloat16, so a bf16
plane's bytes pass through numpy as 2-byte words and its record names the
torch dtype, ``"bfloat16"``, as the reference's does. Transport is not this
module's business: the runner moves payloads.
"""

from __future__ import annotations

import json
import struct

import numpy as np
import torch

MAGIC = b"TPU9KV\x00"
FORMAT_VERSION = 1

_PRELUDE = struct.Struct("<7sHI")          # magic, version, header length

# plane dtypes this reader will materialize: name -> torch dtype. An
# unlisted dtype in a well-formed v1 header is a forward-compat failure,
# reported as such.
_TORCH_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
                 "float16": torch.float16, "int8": torch.int8,
                 "int32": torch.int32}
_DTYPES = tuple(_TORCH_DTYPES)
_DTYPE_NAMES = {dt: name for name, dt in _TORCH_DTYPES.items()}
# numpy words of each plane dtype's width (bf16 travels as int16)
_NP_WORDS = {"bfloat16": np.int16, "float32": np.float32,
             "float16": np.float16, "int8": np.int8, "int32": np.int32}


class KvWireError(ValueError):
    """Malformed / unsupported / geometry-mismatched KV payload."""


def _torch_dtype(name: str) -> torch.dtype:
    if name not in _TORCH_DTYPES:
        raise KvWireError(f"kvwire: unsupported plane dtype {name!r} "
                          f"(supported: {', '.join(_DTYPES)})")
    return _TORCH_DTYPES[name]


def dtype_name(dtype: torch.dtype) -> str:
    """The wire name of a torch dtype (``torch.bfloat16`` → "bfloat16")."""
    if dtype not in _DTYPE_NAMES:
        raise KvWireError(f"kvwire: unsupported plane dtype {dtype} "
                          f"(supported: {', '.join(_DTYPES)})")
    return _DTYPE_NAMES[dtype]


def geometry(cfg, ecfg, kv_quant: bool) -> dict:
    """The pool-identity fields import refuses to cross."""
    return {"n_layers": int(cfg.n_layers),
            "kv_block_size": int(ecfg.kv_block_size),
            "n_kv_heads": int(cfg.n_kv_heads),
            "head_dim": int(cfg.head_dim),
            "kv_dtype": "int8" if kv_quant else dtype_name(cfg.dtype)}


def check_geometry(header: dict, geo: dict) -> None:
    """Every mismatch in one error: a cross-deployment ship failure should
    read like a diff."""
    bad = [f"{k}: payload={header.get(k)!r} pool={v!r}"
           for k, v in geo.items() if header.get(k) != v]
    if bad:
        raise KvWireError("kvwire: pool geometry mismatch ("
                          + "; ".join(bad) + ")")


def encode_blocks(meta: dict, planes: dict[str, torch.Tensor]) -> bytes:
    """``meta`` (geometry + prefix metadata + topology) + canonical host
    planes (CPU tensors) → one self-describing payload."""
    header = dict(meta)
    records = []
    blobs = []
    for name, t in planes.items():
        # the planes' own bytes: the join below is the one host copy
        raw = t.contiguous().reshape(-1).view(torch.uint8).numpy()
        records.append({"name": name, "dtype": dtype_name(t.dtype),
                        "shape": list(t.shape), "nbytes": raw.nbytes})
        blobs.append(raw)
    header["planes"] = records
    hjson = json.dumps(header, sort_keys=True).encode()
    return b"".join([_PRELUDE.pack(MAGIC, FORMAT_VERSION, len(hjson)),
                     hjson] + blobs)


def decode_header(data: bytes) -> tuple[dict, int]:
    """(header, plane-bytes offset). Version/shape gates live here so both
    full decodes and header-only peeks fail identically."""
    if len(data) < _PRELUDE.size:
        raise KvWireError(f"kvwire: payload truncated at {len(data)} "
                          f"bytes (prelude is {_PRELUDE.size})")
    magic, version, hlen = _PRELUDE.unpack_from(data)
    if magic != MAGIC:
        raise KvWireError("kvwire: bad magic (not a KV block payload)")
    if version != FORMAT_VERSION:
        raise KvWireError(
            f"kvwire: unsupported format version {version} (this reader "
            f"speaks v{FORMAT_VERSION}; refusing to guess at a newer "
            "layout)")
    off = _PRELUDE.size + hlen
    if len(data) < off:
        raise KvWireError("kvwire: payload truncated inside header")
    try:
        header = json.loads(data[_PRELUDE.size:off])
    except ValueError as exc:
        raise KvWireError(f"kvwire: undecodable header: {exc}") from exc
    if not isinstance(header, dict) or not isinstance(
            header.get("planes"), list):
        raise KvWireError("kvwire: header is not a plane-table dict")
    return header, off


def decode_blocks(data: bytes, pin_memory: bool = False
                  ) -> tuple[dict, dict[str, torch.Tensor]]:
    """Payload → (header, canonical host planes). Fully validated: every
    plane present, sized and shaped before anything is returned. Each
    plane is a fresh CPU tensor of its record's dtype (in pinned memory
    with ``pin_memory``, ready for one asynchronous host-to-device copy)."""
    header, off = decode_header(data)
    view = memoryview(data)
    words: dict[str, tuple[np.ndarray, torch.dtype]] = {}
    for rec in header["planes"]:
        try:
            name, nbytes = rec["name"], int(rec["nbytes"])
            shape = tuple(int(d) for d in rec["shape"])
            dt = _torch_dtype(str(rec["dtype"]))
        except (KeyError, TypeError, ValueError) as exc:
            raise KvWireError(
                f"kvwire: malformed plane record {rec!r}: {exc}") from exc
        if len(data) < off + nbytes:
            raise KvWireError(f"kvwire: plane {name!r} truncated")
        arr = np.frombuffer(view[off:off + nbytes],
                            dtype=_NP_WORDS[str(rec["dtype"])])
        if arr.size != int(np.prod(shape)):
            raise KvWireError(
                f"kvwire: plane {name!r} has {arr.size} elements, "
                f"shape {shape} needs {int(np.prod(shape))}")
        words[name] = (arr.reshape(shape), dt)
        off += nbytes
    planes = {}
    for name, (arr, dt) in words.items():
        t = torch.empty(arr.shape, dtype=dt, pin_memory=pin_memory)
        t.reshape(-1).view(torch.uint8).numpy()[:] = \
            arr.reshape(-1).view(np.uint8)
        planes[name] = t
    return header, planes
