"""Engine construction from model presets (counterpart of
``tpu9/serving/presets.py``): the same llama, gemma and mixtral preset
names, the same rule for when the engine is paged and the same
quantization knobs, with random weights drawn on the device from a seed.

``<preset>-int8`` or ``quantize="int8"`` serves int8 weight-only
projections (a mixtral's expert stacks per expert), on the paged or the
dense engine; ``kv_quant="int8"`` stores
the paged pool as int8 with per-vector scales, auto-sized to the bytes a
bf16 pool would take. The two knobs are independent; together they are
quantized serving end to end.

``compile_ahead=True`` builds the engine on the preset's abstract param
tree (``params_spec``) and precompiles it while the weights are drawn on a
thread, then binds them in place, as the reference's ``load_engine`` does
with the two sides swapped.

``topology="2x1"`` (or ``"tp=2,fsdp=2"``, or ``TPU9_TOPOLOGY``, or the
planner when a slice is named with ``tpu="h100-8"``) serves the preset
sharded over tp × fsdp ranks (``shard/``); ``devices`` puts the ranks on
given devices, repeats allowed (``["cuda:0", "cuda:0"]``: two ranks on
one card).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Optional

import torch

from ..models.gemma import GEMMA_PRESETS
from ..models.llama import LLAMA_PRESETS
from ..models.mixtral import MIXTRAL_PRESETS
from ..models.transformer import init_decoder
from ..observability import coldstart as cs
from ..ops.quant import init_quantized_decoder, validate_quant_mode
from ..parallel.sharding import tree_parts
from ..utils.platform import default_device
from .engine import EngineConfig, InferenceEngine
from .shard import make_policy, resolve_topology


PRESETS = {**LLAMA_PRESETS, **GEMMA_PRESETS, **MIXTRAL_PRESETS}


def resolve_preset(name: str, quantize: Optional[str] = None):
    """Return ``(DecoderConfig, quantized)`` for a preset name: a ``-int8``
    suffix or ``quantize="int8"`` selects int8 weights. An unknown name
    raises ``KeyError``."""
    quantize = validate_quant_mode(quantize)
    quantized = name.endswith("-int8") or quantize == "int8"
    base = name[:-len("-int8")] if name.endswith("-int8") else name
    if base not in PRESETS:
        raise KeyError(f"unknown model preset {base!r}; have "
                       f"{sorted(PRESETS)}")
    return PRESETS[base], quantized


def build_params(name: str, seed: int = 0, device=None,
                 quantize: Optional[str] = None, emit=None):
    """Random params for a preset, drawn on ``device`` from a generator
    seeded with ``seed``; int8 presets are drawn at int8, so no bf16 copy
    of the model ever exists. Returns ``(params, cfg)``. ``emit`` takes
    each top-level part as it is drawn (``init_decoder``)."""
    cfg, quantized = resolve_preset(name, quantize)
    device = default_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    init = init_quantized_decoder if quantized else init_decoder
    return init(cfg, gen, device, emit=emit), cfg


def bind_drawn(engine: InferenceEngine, name: str, seed: int = 0,
               quantize: Optional[str] = None) -> None:
    """Draw a preset's weights on the engine's rank-0 device part by part
    and bind each into the engine's storage as it is drawn
    (``bind_params(part, part=name)``), dropping it before the next is
    drawn: the device holds the engine's shards and one part of the full
    tree, never the whole tree. The draws are :func:`build_params`' in
    its order, so the weights are the 1x1 tree's, seed for seed. Raises
    unless every part of the engine's storage was bound."""
    bound: list = []

    def emit(part: str, tree) -> None:
        engine.bind_params(tree, part=part)
        bound.append(part)

    build_params(name, seed=seed, device=engine.device, quantize=quantize,
                 emit=emit)
    want = [part for part, _ in tree_parts(params_spec(name, quantize)[0])]
    if sorted(bound) != sorted(want):
        raise ValueError(f"bind_drawn: bound parts {bound}, the engine's "
                         f"are {want}")


def abstract_params_for(cfg, quantized: bool = False):
    """The ``device="meta"`` param tree of an explicit DecoderConfig: the
    same init functions the real params come from, run on the meta device
    without a generator, so spec and params cannot drift apart."""
    init = init_quantized_decoder if quantized else init_decoder
    return init(cfg, None, "meta")


def params_spec(name: str, quantize: Optional[str] = None):
    """The abstract (``device="meta"``) param tree of a preset and its
    config: the shapes compile-ahead needs before a weight exists."""
    cfg, quantized = resolve_preset(name, quantize)
    return abstract_params_for(cfg, quantized), cfg


def engine_config(*, max_batch: int = 8, max_seq_len: int = 2048,
                  prefill_buckets: tuple = (128, 512, 2048),
                  decode_steps: tuple = (1, 8, 32),
                  paged: Optional[bool] = None, kv_block_size: int = 256,
                  kv_pool_blocks: int = 0,
                  prefix_cache_blocks: Optional[int] = None,
                  kv_quant: Optional[str] = None, spec_len: int = 0,
                  spec_min_accept: float = 0.35) -> EngineConfig:
    """The ``EngineConfig`` that :func:`load_engine` builds from its knobs
    (which it documents), for a caller that builds the engine from an
    explicit ``DecoderConfig`` through ``InferenceEngine``."""
    kv_quant = validate_quant_mode(kv_quant, "kv_quant")
    chunk = min(prefill_buckets)
    block = min(kv_block_size, chunk)
    if paged is None:
        paged = (max_seq_len % block == 0 and chunk % block == 0
                 and max_seq_len % chunk == 0)
    if kv_quant and not paged:
        raise ValueError(
            "kv_quant='int8' needs the paged engine, but the alignment "
            f"invariants rejected paging (block {block}, chunk {chunk}, "
            f"max_seq_len {max_seq_len})")
    return EngineConfig(
        max_batch=max_batch, max_seq_len=max_seq_len,
        prefill_buckets=prefill_buckets, decode_steps=decode_steps,
        kv_block_size=block if paged else 0, kv_pool_blocks=kv_pool_blocks,
        prefill_chunk=chunk if paged else 0,
        # an explicit 0 disables the prefix cache; None is the default
        prefix_cache_blocks=prefix_cache_blocks
        if prefix_cache_blocks is not None
        else (max_seq_len // block if paged else 0),
        kv_quant=kv_quant, spec_len=spec_len,
        spec_min_accept=spec_min_accept)


def load_engine(name: str, *, device=None, max_batch: int = 8,
                max_seq_len: int = 2048,
                prefill_buckets: tuple = (128, 512, 2048),
                decode_steps: tuple = (1, 8, 32),
                paged: Optional[bool] = None,
                kv_block_size: int = 256,
                kv_pool_blocks: int = 0,
                prefix_cache_blocks: Optional[int] = None,
                quantize: Optional[str] = None,
                kv_quant: Optional[str] = None,
                spec_len: int = 0,
                spec_min_accept: float = 0.35,
                engine_cfg: Optional[EngineConfig] = None,
                seed: int = 0, compile_ahead: bool = False,
                tracer=None, topology=None, tpu=None,
                devices=None) -> InferenceEngine:
    """Build the serving engine for a preset on ``device`` (the current
    CUDA device when None; without one this raises).

    ``topology`` selects the serving grid, resolved by the reference's
    chain (``shard.resolve_topology``): the argument (``"2x1"``,
    ``"tp=2,fsdp=2"``, a ``Topology``, or ``"auto"``), then
    ``TPU9_TOPOLOGY``, then the planner when ``tpu`` names a slice (the
    reference's keyword, here a GPU slice such as ``"h100-8"``), then 1x1.
    A larger topology puts its ranks on ``devices`` (tp innermost,
    repeats allowed), by default on ``cuda:0..n-1``; ``device`` names the
    one card of a 1x1 engine, and with a larger topology raises. A 1x1
    engine is the single-card engine. A sharded engine is built on the
    preset's abstract tree and its weights are drawn on rank 0's device
    part by part, each bound into the rank shards before the next is
    drawn (:func:`bind_drawn`): a model larger than one card loads.

    ``paged=None`` pages the KV cache whenever block | chunk | max_seq_len
    holds, as the JAX ``load_engine`` does: the chunk is the smallest
    prefill bucket and the block is ``min(kv_block_size, chunk)``.
    Otherwise (or with ``paged=False``) the engine keeps a dense [B, S]
    cache and prefills whole bucketed prompts.
    ``prefix_cache_blocks=0`` disables the prefix cache (None = one
    sequence's worth of blocks when paged, 0 when dense). ``quantize`` and
    ``kv_quant`` are the int8 knobs of the module docstring; int8 weights
    serve on either engine, the int8 pool only on the paged one.
    ``spec_len > 0`` turns on speculative decoding with that many
    prompt-lookup drafts a verify window, gated by ``spec_min_accept``
    (see ``EngineConfig``).

    ``compile_ahead=True`` takes the reference's bring-up, its two sides
    swapped: the engine is built on ``params_spec`` (zero-filled storage),
    ``precompile`` runs on the calling thread (on the card it captures
    every window) while the weights are drawn on a thread named
    ``tpu9-weight-load`` (on the card on a stream of their own), and
    ``bind_params`` copies them in place.
    ``engine.compile_ahead_timings`` holds the precompile's seconds and
    ``engine.bringup`` ``load_s``, ``compile_ahead_s``, ``bind_s`` and
    ``compile_overlap_s``, which ``stats()`` forwards as ``coldstart_*``.
    With a ``tracer`` (the reference's ``Tracer``, or anything with its
    ``record_window`` and ``span``) the ``restore.load``,
    ``restore.compile_ahead`` and ``restore.bind`` spans are recorded
    under the caller's current span. Unlike the reference, which logs a
    failed precompile and compiles lazily, a precompile error is raised
    after the join: a capture that fails beside a weight load must not be
    hidden. ``tracer`` also goes to the engine (its request spans)."""
    resolve_preset(name, quantize)           # a bad name or mode fails first
    kv_quant = validate_quant_mode(kv_quant, "kv_quant")
    if engine_cfg is not None and kv_quant \
            and engine_cfg.kv_quant != kv_quant:
        # an explicit engine_cfg replaces every knob: a kv_quant it does
        # not carry would be dropped silently
        raise ValueError(
            "kv_quant conflicts with the explicit engine_cfg — set "
            "EngineConfig(kv_quant=...) there instead")
    topo = resolve_topology(topology, preset=name, tpu=tpu,
                            max_batch=max_batch, max_seq_len=max_seq_len,
                            quantize=quantize, kv_quant=bool(kv_quant))
    if device is not None and not topo.is_single:
        # one device for every rank would be a silent stack on one card:
        # sharing a card is asked for by naming it in devices
        raise ValueError(f"device={device!r} names one card, the topology "
                         f"{topo} has {topo.n_chips} ranks: give devices=")
    policy = make_policy(topo, devices=devices or (
        [device] if device is not None else None))
    ecfg = engine_cfg or engine_config(
        max_batch=max_batch, max_seq_len=max_seq_len,
        prefill_buckets=prefill_buckets, decode_steps=decode_steps,
        paged=paged, kv_block_size=kv_block_size,
        kv_pool_blocks=kv_pool_blocks,
        prefix_cache_blocks=prefix_cache_blocks, kv_quant=kv_quant,
        spec_len=spec_len, spec_min_accept=spec_min_accept)
    if compile_ahead:
        return _load_compile_ahead(name, quantize, seed, ecfg, policy,
                                   tracer)
    if not topo.is_single:
        spec, cfg = params_spec(name, quantize)
        engine = InferenceEngine(spec, cfg, ecfg, tracer=tracer,
                                 policy=policy)
        bind_drawn(engine, name, seed, quantize)
        return engine
    params, cfg = build_params(name, seed=seed, device=policy.device,
                               quantize=quantize)
    return InferenceEngine(params, cfg, ecfg, tracer=tracer, policy=policy)


def _load_compile_ahead(name: str, quantize: Optional[str], seed: int,
                        ecfg: EngineConfig, policy,
                        tracer) -> InferenceEngine:
    """``load_engine(compile_ahead=True)``: the reference's branch
    (``tpu9/serving/presets.py``) with its two sides swapped. The weights
    are drawn on a thread named ``tpu9-weight-load`` while the calling
    thread precompiles: the captures are Python-bound, and on a fresh
    thread they cost the card's host two to three times the CPU seconds
    they cost the calling thread (``scripts/coldstart_overlap.py``,
    PERF.md §6). An error on either side is raised after the join. A
    sharded engine's weights are bound part by part as the thread draws
    them (:func:`bind_drawn`), beside the captures, which read the shards
    only by address: the bind after the join is then empty."""
    spec, cfg = params_spec(name, quantize)
    engine = InferenceEngine(spec, cfg, ecfg, tracer=tracer, policy=policy)
    device = policy.device
    sharded = not policy.topology.is_single
    cuda = device.type == "cuda"
    on_device = (lambda: torch.cuda.device(device)) if cuda \
        else contextlib.nullcontext
    loaded: dict = {}

    def _load() -> None:
        try:
            # the draws go on a stream of their own: nothing of the load
            # touches the streams the captures beside it use
            stream = torch.cuda.Stream(device) if cuda else None
            with on_device(), torch.cuda.stream(stream):
                if sharded:
                    bind_drawn(engine, name, seed, quantize)
                else:
                    loaded["params"], _ = build_params(
                        name, seed=seed, device=device, quantize=quantize)
            if stream is not None:
                stream.synchronize()
        except Exception as exc:   # noqa: BLE001 — raised after the join
            loaded["error"] = exc
        finally:
            loaded["end"] = time.monotonic()

    wall_anchor = time.time()
    anchor_mono = time.monotonic()
    loader = threading.Thread(target=_load, name="tpu9-weight-load",
                              daemon=True)
    loader.start()
    timings: dict = {}
    failed = None
    # the monotonic window of the precompile, recorded as the
    # restore.compile_ahead span: its overlap with the load's window shows
    # that bring-up paid max(compile, load)
    compile_start = time.monotonic()
    try:
        with on_device():
            timings = engine.precompile()
    except Exception as exc:   # noqa: BLE001 — raised after the join
        failed = exc
    finally:
        compile_end = time.monotonic()
        loader.join()
    load_end = loaded["end"]
    if tracer is not None:
        tracer.record_window(cs.SPAN_LOAD, wall_anchor, anchor_mono,
                             anchor_mono, load_end,
                             attrs={"preset": name, "source": "build"})
        tracer.record_window(cs.SPAN_COMPILE_AHEAD, wall_anchor,
                             anchor_mono, compile_start, compile_end,
                             attrs={"preset": name, "graphs": len(timings),
                                    "failed": failed is not None})
    if failed is not None:
        raise RuntimeError(f"compile-ahead of {name} failed: "
                           f"{failed}") from failed
    if "error" in loaded:
        raise loaded["error"]
    bind_start = time.monotonic()
    with (tracer.span(cs.SPAN_BIND, attrs={"preset": name})
          if tracer is not None else contextlib.nullcontext()):
        if not sharded:
            engine.bind_params(loaded.pop("params"))
    bind_end = time.monotonic()
    engine.compile_ahead_timings = timings
    engine.bringup = {
        "load_s": round(load_end - anchor_mono, 4),
        "compile_ahead_s": round(compile_end - compile_start, 4),
        "bind_s": round(bind_end - bind_start, 4),
        "compile_overlap_s": round(cs.interval_overlap_s(
            (anchor_mono, load_end), (compile_start, compile_end)), 4)}
    return engine
