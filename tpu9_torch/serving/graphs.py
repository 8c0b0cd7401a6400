"""The engine's device computations (counterpart of
``tpu9/serving/graphs.py``): the decode window; for the paged engine one
chunked-prefill step, the scratch → pool block splice, the pool → scratch
prefix gather and the fused admission group; for the dense engine the
bucketed prefill and the splice of its KV into a slot's lanes.

The factory keeps every computation the serve loop dispatches in one cache,
under the JAX factory's keys, with one miss path (``_build``). It counts
misses, is sealed once warmup has built every key the serve loop can reach
(``seal``), and counts and times every miss after that: the engine's
``graph_compiles*`` stats, the compile sentinel of the reference.

On a CUDA engine a decode window is one CUDA graph per window size,
captured once over the engine's static device state (``WindowState``) and
replayed; all of an engine's window graphs share one memory pool. On a CPU
engine it is the same k-step loop run eagerly. The admission computations
run eagerly on both and write the pool and scratch in place (the JAX graphs
donated them).
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from ..models.transformer import decoder_forward, init_kv_cache, lm_logits
from ..ops.paged_attention import add_launches, captured_launches
from ..ops.quant import dequantize_kv, quantize_kv
from ..ops.rotary import rope_table
from ..ops.sampling import sample_logits

Params = dict[str, Any]

log = logging.getLogger("tpu9_torch.serving")


@dataclass
class WindowState:
    """The device state a decode window reads and writes. A captured
    window replays these addresses, so the engine owns every tensor here
    for its life and only ever writes them in place."""
    params: Params
    kv_cache: Params            # pool and table, or the dense cache
    last_token: torch.Tensor    # [B, 1] int32
    cache_len: torch.Tensor     # [B] int32
    active: torch.Tensor        # [B] bool
    toks: torch.Tensor          # [max k, B] int32: a k-window writes toks[:k]
    generator: torch.Generator


@dataclass
class CapturedWindow:
    """One decode window captured as a CUDA graph. A call replays it and
    adds to the decode wrappers' ``.launches`` the launches its capture
    counted (a replay runs no Python)."""
    graph: Any                  # torch.cuda.CUDAGraph, or a stand-in
    launches: dict = field(default_factory=dict)

    def __call__(self) -> None:
        self.graph.replay()
        add_launches(self.launches)


class GraphFactory:
    """The engine's computations for one (model, engine-config) pair.
    ``chunk`` is the validated chunked-prefill length (0 = dense mode);
    ``window`` the engine's static decode state (``decode_k`` needs it)."""

    def __init__(self, cfg, ecfg, chunk: int, device,
                 window: WindowState | None = None):
        self.cfg = cfg
        self.ecfg = ecfg
        self.chunk = chunk
        self.device = device
        self.window = window
        # computed once per engine (the JAX graphs constant-fold it)
        self.rope = rope_table(cfg.max_seq_len, cfg.head_dim, cfg.rope_theta,
                               device)
        self.compiled: dict[Any, Any] = {}
        # compile sentinel: cache misses. After seal() (warmup done) a miss
        # means a serving window stalls behind a build (and on the card a
        # capture): stats()["graph_compiles*"]
        self.compiles = 0
        self.post_seal_compiles = 0
        # seconds serving stalled behind post-seal misses: the build and
        # the first call
        self.post_seal_stall_s = 0.0
        self._sealed = False
        # CUDA only: the window graphs' shared memory pool, each window
        # size's capture seconds, and the device memory the captures
        # reserved
        self._graph_pool = None
        self._reserved_before = 0
        self.capture_s: dict[int, float] = {}
        self.pool_bytes = 0

    def _build(self, key, make):
        """Cache-or-build under ``key``: the ONE miss path, so the sentinel
        cannot be bypassed by a new getter."""
        fn = self.compiled.get(key)
        if fn is None:
            self.compiles += 1
            if self._sealed:
                self.post_seal_compiles += 1
                log.warning(
                    "post-warmup graph build: key=%r; a serving window is "
                    "stalling behind it (warmup did not reach this key)", key)
                t0 = time.perf_counter()
                real = make()
                self.post_seal_stall_s += time.perf_counter() - t0
                fn = self.compiled[key] = self._timed_first_call(key, real)
                return fn
            fn = self.compiled[key] = make()
        return fn

    def _timed_first_call(self, key, real):
        """Wrap a post-seal build so its first call is timed into
        ``post_seal_stall_s``, then unwrap."""
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            out = real(*args, **kwargs)
            self.post_seal_stall_s += time.perf_counter() - t0
            self.compiled[key] = real
            return out
        return timed

    def seal(self) -> None:
        """Mark the cache complete: warmup built every key the serve loop
        can request. Later misses are counted and logged."""
        self._sealed = True

    # -- decode window -------------------------------------------------------

    def build_decode(self, k: int = 1):
        """The k-step window as a plain function of its state (eager)."""
        cfg, ecfg, rope = self.cfg, self.ecfg, self.rope

        @torch.no_grad()
        def decode(params, kv_cache, last_token, cache_len, active,
                   generator):
            """k decode steps for the whole batch. Returns the new
            (last_token [B,1], kv_cache, cache_len [B], toks [k, B]); the
            pool in ``kv_cache`` is written in place."""
            toks = []
            step_len = active.to(torch.int32)
            for _ in range(k):
                positions = cache_len[:, None]      # next position per slot
                logits, kv_cache = decoder_forward(
                    params, last_token, cfg, positions=positions,
                    kv_cache=kv_cache, cache_len=cache_len + 1, decode=True,
                    rope=rope)
                next_tok = sample_logits(logits[:, -1], generator,
                                         temperature=ecfg.temperature,
                                         top_k=ecfg.top_k, top_p=ecfg.top_p)
                last_token = next_tok[:, None].to(torch.int32)
                # only live slots advance; idle lanes stay parked at 0
                cache_len = cache_len + step_len
                toks.append(last_token[:, 0])
            return last_token, kv_cache, cache_len, torch.stack(toks)

        return decode

    def decode_k(self, k: int):
        """The k-step window over ``self.window``, as a call with no
        arguments that writes last_token, cache_len and toks[:k] in place:
        a captured CUDA graph on the card, the eager loop on the CPU."""
        return self._build(("decode", k), lambda: self._window(k))

    def _window(self, k: int):
        st = self.window
        if st is None:
            raise RuntimeError("decode_k needs the engine's WindowState")
        decode = self.build_decode(k)

        def window() -> None:
            last, _, clen, toks = decode(st.params, st.kv_cache,
                                         st.last_token, st.cache_len,
                                         st.active, st.generator)
            st.last_token.copy_(last)
            st.cache_len.copy_(clen)
            st.toks[:k].copy_(toks)

        if self.device.type != "cuda":
            return window
        return self._capture(k, window)

    def _capture(self, k: int, window) -> CapturedWindow:
        """Capture ``window`` as a CUDA graph in the shared pool. A failed
        capture raises: the card never runs the eager loop."""
        if not self._sealed:
            # warmup, every lane inactive: one eager run loads the kernels
            # and the libraries' handles before the capture. A post-seal
            # capture skips it, or live lanes would advance twice.
            window()
        t0 = time.perf_counter()
        if self._graph_pool is None:
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
            self._reserved_before = torch.cuda.memory_reserved(self.device)
            self._graph_pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        # replays draw from the engine's generator and advance it
        graph.register_generator_state(self.window.generator)

        def capture() -> None:
            with torch.cuda.graph(graph, pool=self._graph_pool,
                                  capture_error_mode="thread_local"):
                window()

        launches = captured_launches(capture)
        self.capture_s[k] = time.perf_counter() - t0
        # the capture context empties the allocator's cache on entry, so
        # the growth of reserved memory since the first capture is the
        # graphs' pool
        self.pool_bytes = (torch.cuda.memory_reserved(self.device)
                           - self._reserved_before)
        return CapturedWindow(graph, launches)

    # -- dense prefill -------------------------------------------------------

    def prefill_fn(self, bucket: int):
        return self._build(bucket, lambda: self._prefill(bucket))

    def _prefill(self, bucket: int):
        """Prefill of one prompt padded to ``bucket`` tokens into a fresh
        batch-1 cache of ``bucket`` positions (the flash kernel at aligned
        buckets). Returns the logits at the last real token and the cache
        [L, 1, bucket, KH, D]. Only that row goes through the output head:
        the JAX graph computes every row's logits and slices one, which at
        bucket 2048 would be a [2048, vocab] f32 product made to keep one
        row."""
        cfg, rope, device = self.cfg, self.rope, self.device

        @torch.no_grad()
        def prefill(params, tokens, length: int):
            cache = init_kv_cache(cfg, 1, bucket, device=device)
            hidden, cache = decoder_forward(params, tokens, cfg,
                                            kv_cache=cache, rope=rope,
                                            return_hidden=True)
            last = lm_logits(params, hidden[:, length - 1], cfg)[0]
            return last, cache

        return prefill

    def dense_splice_fn(self, bucket: int):
        """Copy of a prefill's [L, 1, bucket, ...] k/v into one slot's lanes
        of the dense [L, B, S, ...] cache, in place (the JAX splice graph
        donated the cache). Returns the cache's k and v."""
        def build():
            @torch.no_grad()
            def splice(k, v, ck, cv, slot: int):
                k[:, slot, :bucket] = ck[:, 0, :bucket]
                v[:, slot, :bucket] = cv[:, 0, :bucket]
                return k, v

            return splice

        return self._build(("dsplice", bucket), build)

    # -- paged chunked prefill -----------------------------------------------

    @torch.no_grad()
    def traced_chunk_step(self, params, scratch, tok_row, offset: int,
                          last_idx: int):
        """Prefill one C-token chunk into the scratch at ``offset`` and
        return the logits at ``last_idx`` (shared by the single-chunk and
        fused-group admission paths)."""
        c = self.chunk
        positions = offset + torch.arange(c, device=self.device)[None, :]
        logits, scratch = decoder_forward(
            params, tok_row[None, :], self.cfg, positions=positions,
            kv_cache=scratch, cache_len=offset + c, rope=self.rope)
        return logits[0, last_idx], scratch

    @torch.no_grad()
    def traced_splice(self, pool, scratch_k, scratch_v, offset: int, phys):
        """Block copy: scratch positions [offset, offset+C) → pool blocks
        phys[0..C/BS). An int8 pool quantizes each block on the way in, its
        per-vector scales landing in the scale planes at the same physical
        index. In place: the JAX splice graph donated the pool."""
        bs = self.ecfg.kv_block_size
        for j in range(self.chunk // bs):
            start = offset + j * bs
            blk = int(phys[j])
            for name, scratch in (("k", scratch_k), ("v", scratch_v)):
                block = scratch[:, 0, start:start + bs]     # [L,BS,KH,D]
                if "k_scale" in pool:
                    block, pool[f"{name}_scale"][:, blk] = quantize_kv(block)
                pool[name][:, blk] = block
        return pool

    def chunk_fn(self):
        """One C-token chunk prefilled into the scratch at ``offset``:
        (params, tokens [1, C], offset, scratch, last_idx) → (the logits at
        ``last_idx``, scratch)."""
        def build():
            def chunk(params, tokens, offset: int, scratch, last_idx: int):
                return self.traced_chunk_step(params, scratch, tokens[0],
                                              offset, last_idx)

            return chunk

        return self._build(("chunk", self.chunk), build)

    def splice_fn(self):
        """One chunk's blocks from the scratch into their pool blocks
        (:meth:`traced_splice`)."""
        return self._build("splice", lambda: self.traced_splice)

    def gather_fn(self):
        """Densify one slot's table row into the scratch (prefix reuse: the
        cached blocks become the prefix chunk prefill attends). An int8
        pool is dequantized here, in f32, then cast to the model dtype: the
        scratch always holds the model dtype. The row's final, always-trash
        column is sliced off so the scratch keeps its [L, 1, S, KH, D]
        shape. Writes the scratch in place."""
        s = self.ecfg.max_seq_len

        def build():
            @torch.no_grad()
            def gather(pool, row, scratch):
                idx = torch.from_numpy(np.asarray(row, dtype=np.int64)).to(
                    self.device)
                for name in ("k", "v"):
                    g = pool[name][:, idx]                # [L, MB, BS, KH, D]
                    if f"{name}_scale" in pool:
                        g = dequantize_kv(g, pool[f"{name}_scale"][:, idx],
                                          scratch[name].dtype)
                    l_, mb, bs, kh, d = g.shape
                    scratch[name][:, 0] = g.reshape(l_, mb * bs, kh,
                                                    d)[:, :s]
                return scratch

            return gather

        return self._build("gather", build)

    def chunk_group_fn(self, g: int):
        """Fused admission: ``g`` chunks, each prefilled into the scratch
        and spliced into the pool. toks [g, C] on the device; offsets,
        last_idxs [g] and phys [g, C/BS] on the host. Returns (pool,
        scratch, the final chunk's last-token logits)."""
        def build():
            def group(params, pool, scratch, toks, offsets, last_idxs, phys):
                last = None
                for i in range(g):
                    last, scratch = self.traced_chunk_step(
                        params, scratch, toks[i], int(offsets[i]),
                        int(last_idxs[i]))
                    pool = self.traced_splice(pool, scratch["k"],
                                              scratch["v"], int(offsets[i]),
                                              phys[i])
                return pool, scratch, last

            return group

        return self._build(("chunkgroup", g), build)
