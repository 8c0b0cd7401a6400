"""The engine's device computations (counterpart of
``tpu9/serving/graphs.py``): the decode window and the speculative verify
window; for the paged engine one chunked-prefill step, the scratch → pool
block splice, the pool → scratch prefix gather and the fused admission
group; for the dense engine the bucketed prefill and the splice of its KV
into a slot's lanes.

The factory keeps every computation the serve loop dispatches in one cache,
under the JAX factory's keys, with one miss path (``_build``). It counts
misses, is sealed once warmup has built every key the serve loop can reach
(``seal``), and counts and times every miss after that: the engine's
``graph_compiles*`` stats, the compile sentinel of the reference.

On a CUDA engine a decode window is one CUDA graph per window size, and a
verify window one per draft length, each captured once over the engine's
static device state (``WindowState``) and replayed; all of an engine's
window graphs share one memory pool. On a CPU engine each is the same
computation run eagerly. The admission computations
run eagerly on both and write the pool and scratch in place (the JAX graphs
donated them).

Compile-ahead: ``lowering_jobs`` enumerates every key with the inputs of one
inactive run, ``precompile`` builds and runs each of them (capturing the
windows on the card) and seals, and ``reachable_keys`` is the set the serve
loop can request, which the enumeration must equal. The engine runs
``precompile`` over zero-filled weight storage while its weights load.

Under a sharding policy (``shard/policy.py``) the params are rank shards
and every KV tree (pool, scratch, dense cache) one tree per rank: the
forward runs the ranks and their reductions (``models/transformer.py``),
and the splice, gather and dense splice run rank by rank. Whether a
window is captured is decided by the placement: with every rank on one
device a window is one CUDA graph holding all of them; ranks on distinct
devices run their windows eagerly.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Any, Iterator

import numpy as np
import torch

from ..models.transformer import decoder_forward, lm_logits
from ..ops.paged_attention import add_launches, captured_launches
from ..ops.quant import dequantize_kv, quantize_kv
from ..ops.rotary import rope_table
from ..ops.sampling import sample_logits
from ..parallel.sharding import per_rank, ranks, to_device
from .kvpool import KvPool
from .shard.policy import SingleDevicePolicy

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
    # speculative verify (0 columns when speculation is off): the host
    # writes a window's drafts into drafts[:, :s] before it runs; it writes
    # the model's tokens into out[:, :s + 1] and the accepted counts
    drafts: torch.Tensor        # [B, max s] int32
    out: torch.Tensor           # [B, 1 + max s] int32
    n_acc: torch.Tensor         # [B] int32


@dataclass
class CapturedWindow:
    """One decode or verify window captured as a CUDA graph. A call
    replays it and adds to the decode wrappers' ``.launches`` the launches
    its capture counted (a replay runs no Python)."""
    graph: Any                  # torch.cuda.CUDAGraph, or a stand-in
    launches: dict = field(default_factory=dict)

    def __call__(self) -> None:
        self.graph.replay()
        add_launches(self.launches)


class GraphFactory:
    """The engine's computations for one (model, engine-config) pair.
    ``chunk`` is the validated chunked-prefill length (0 = dense mode);
    ``window`` the engine's static decode state (``decode_k`` needs it);
    ``policy`` the sharding policy (the identity policy on ``device`` by
    default)."""

    def __init__(self, cfg, ecfg, chunk: int, device,
                 window: WindowState | None = None, policy=None):
        self.cfg = cfg
        self.ecfg = ecfg
        self.chunk = chunk
        self.device = device
        self.window = window
        self.policy = policy or SingleDevicePolicy(device)
        # a window is captured when every rank is on one CUDA device; the
        # graph check sets this False to trace the bodies the captures hold
        self.captures = (torch.device(device).type == "cuda"
                         and self.policy.one_device)
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
        # CUDA only: the window graphs' shared memory pool, the capture
        # seconds of each window size k (and of each ("verify", s)), and
        # the device memory the pool holds
        self._graph_pool = None
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

        if not self.captures:
            return window
        return self._capture(k, window)

    # -- speculative verify window --------------------------------------------

    def build_verify(self, s: int):
        """One forward over ``t = 1 + s`` positions per slot as a plain
        function of its state: column 0 is the slot's last token, columns
        1..s the host's drafts. The model emits its own token at every
        position; a draft survives only while it equals the model's output
        at the position before it, so the stream is the one classic decode
        would give. Returns (bonus [B, 1], kv_cache, new cache_len [B], out
        [B, t], n_acc [B]): the accepted-prefix length, the model's token
        after it, and cache_len advanced past the accepted positions of
        active slots only. Rejected positions keep garbage KV that
        attention masks and the next window overwrites."""
        cfg, ecfg, rope = self.cfg, self.ecfg, self.rope
        t = s + 1

        @torch.no_grad()
        def verify(params, kv_cache, last_token, drafts, cache_len, active,
                   generator):
            tokens = torch.cat([last_token, drafts.to(torch.int32)], dim=1)
            positions = cache_len[:, None] + torch.arange(
                t, dtype=torch.int32, device=cache_len.device)[None, :]
            logits, kv_cache = decoder_forward(
                params, tokens, cfg, positions=positions, kv_cache=kv_cache,
                cache_len=cache_len + t, decode=False, rope=rope)
            out = sample_logits(logits, generator,
                                temperature=ecfg.temperature,
                                top_k=ecfg.top_k,
                                top_p=ecfg.top_p).to(torch.int32)   # [B, t]
            # the longest agreeing prefix of the drafts, per slot
            agree = (tokens[:, 1:] == out[:, :-1]).to(torch.int32)
            n_acc = torch.cumprod(agree, dim=1).sum(dim=1,
                                                    dtype=torch.int32)
            # the model's own token after the accepted run
            bonus = torch.gather(out, 1, n_acc[:, None].long())
            new_len = cache_len + (n_acc + 1) * active.to(torch.int32)
            return bonus, kv_cache, new_len, out, n_acc

        return verify

    def verify_fn(self, s: int):
        """The verify window for ``s`` drafts over ``self.window``, as a
        call with no arguments: it reads ``drafts[:, :s]`` and writes
        last_token, cache_len, ``out[:, :s + 1]`` and ``n_acc`` in place.
        A captured CUDA graph on the card, the eager forward on the
        CPU."""
        return self._build(("verify", s), lambda: self._verify_window(s))

    def _verify_window(self, s: int):
        st = self.window
        if st is None:
            raise RuntimeError("verify_fn needs the engine's WindowState")
        if s > st.drafts.shape[1]:
            raise ValueError(f"verify window of {s} drafts, the window state "
                             f"holds {st.drafts.shape[1]}")
        verify = self.build_verify(s)

        def window() -> None:
            last, _, clen, out, n_acc = verify(
                st.params, st.kv_cache, st.last_token, st.drafts[:, :s],
                st.cache_len, st.active, st.generator)
            st.last_token.copy_(last)
            st.cache_len.copy_(clen)
            st.out[:, :s + 1].copy_(out)
            st.n_acc.copy_(n_acc)

        if not self.captures:
            return window
        return self._capture(("verify", s), window)

    def _capture(self, key, window) -> CapturedWindow:
        """Capture ``window`` as a CUDA graph in the shared pool; ``key``
        names it in ``capture_s``. A failed capture raises: the card never
        runs the eager window."""
        if not self._sealed:
            # warmup, every lane inactive: one eager run loads the kernels
            # and the libraries' handles before the capture. A post-seal
            # capture skips it, or live lanes would advance twice.
            window()
        t0 = time.perf_counter()
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        # replays draw from the engine's generator and advance it
        graph.register_generator_state(self.window.generator)

        def capture() -> None:
            with torch.cuda.graph(graph, pool=self._graph_pool,
                                  capture_error_mode="thread_local"):
                window()

        launches = captured_launches(capture)
        self.capture_s[key] = time.perf_counter() - t0
        self.pool_bytes = self._pool_segment_bytes()
        return CapturedWindow(graph, launches)

    def _pool_segment_bytes(self) -> int:
        """The device memory of the window graphs' private pool: the sizes
        of the allocator's segments that this pool owns, as its snapshot
        tags them. Only the captures allocate there, so weights that load
        on another thread beside them, which reserved memory as a whole
        would count, are left out."""
        pool = tuple(self._graph_pool)
        return sum(seg["total_size"]
                   for seg in torch.cuda.memory_snapshot()
                   if tuple(seg["segment_pool_id"]) == pool)

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
        cfg, rope, policy = self.cfg, self.rope, self.policy

        @torch.no_grad()
        def prefill(params, tokens, length: int):
            cache = policy.init_kv_cache(cfg, 1, bucket)
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
                for kr, vr, ckr, cvr in zip(ranks(k), ranks(v), ranks(ck),
                                            ranks(cv)):
                    kr[:, slot, :bucket] = ckr[:, 0, :bucket]
                    vr[:, slot, :bucket] = cvr[:, 0, :bucket]
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
        index. In place: the JAX splice graph donated the pool. Rank by
        rank under a sharding policy."""
        bs = self.ecfg.kv_block_size
        for pool_r, k_r, v_r in zip(ranks(pool), ranks(scratch_k),
                                    ranks(scratch_v)):
            for j in range(self.chunk // bs):
                start = offset + j * bs
                blk = int(phys[j])
                for name, scratch in (("k", k_r), ("v", v_r)):
                    block = scratch[:, 0, start:start + bs]  # [L,BS,KH,D]
                    if "k_scale" in pool_r:
                        block, pool_r[f"{name}_scale"][:, blk] = \
                            quantize_kv(block)
                    pool_r[name][:, blk] = block
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
                for pool_r, scratch_r in zip(ranks(pool), ranks(scratch)):
                    idx_r = to_device(idx, pool_r["k"].device)
                    for name in ("k", "v"):
                        g = pool_r[name][:, idx_r]        # [L, MB, BS, KH, D]
                        if f"{name}_scale" in pool_r:
                            g = dequantize_kv(
                                g, pool_r[f"{name}_scale"][:, idx_r],
                                scratch_r[name].dtype)
                        l_, mb, bs, kh, d = g.shape
                        scratch_r[name][:, 0] = g.reshape(l_, mb * bs, kh,
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

    # -- compile-ahead -------------------------------------------------------

    def lowering_jobs(self, params, kv_cache: Params, pool: Params,
                      scratch: Params, mb: int, buckets,
                      spec_lens) -> Iterator[tuple]:
        """Every steady-state serving computation as ``(key, build,
        args)``: ``build()`` resolves ``key`` through its getter (so
        through the one miss path) and ``args`` are the inputs of one run
        with every lane inactive: zero tokens, every paged write to the
        trash block (physical block 0, ``KvPool``), dense writes to slot
        0's lanes, which no ``cache_len`` reaches. The windows take no
        arguments: they run over ``self.window``. The one enumeration
        :meth:`precompile` and the key-set check share (the JAX factory's
        ``lowering_jobs``, which lowers where this one runs)."""
        dev = self.device

        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.int32, device=dev)

        if self.chunk:
            bs = self.ecfg.kv_block_size
            c = self.chunk
            trash = np.zeros((c // bs,), dtype=np.int32)
            yield (("chunk", c), self.chunk_fn,
                   (params, zeros(1, c), 0, scratch, 0))
            yield ("splice", self.splice_fn,
                   (pool, scratch["k"], scratch["v"], 0, trash))
            yield ("gather", self.gather_fn,
                   (pool, np.zeros((mb,), dtype=np.int32), scratch))
            g = max(1, self.ecfg.admit_group_chunks)
            if g > 1:
                offs = np.minimum(np.arange(g) * c,
                                  self.ecfg.max_seq_len - c).astype(np.int32)
                yield (("chunkgroup", g), lambda: self.chunk_group_fn(g),
                       (params, pool, scratch, zeros(g, c), offs,
                        np.full((g,), c - 1, dtype=np.int32),
                        np.zeros((g, c // bs), dtype=np.int32)))
        else:
            for bucket in buckets:
                pre = self.policy.init_kv_cache(self.cfg, 1, bucket)
                yield (bucket, lambda b=bucket: self.prefill_fn(b),
                       (params, zeros(1, bucket), 1))
                yield (("dsplice", bucket),
                       lambda b=bucket: self.dense_splice_fn(b),
                       (kv_cache["k"], kv_cache["v"], pre["k"], pre["v"], 0))
        for k in self.ecfg.decode_steps:
            yield (("decode", k), lambda k=k: self.decode_k(k), ())
        for s in spec_lens:
            yield (("verify", s), lambda s=s: self.verify_fn(s), ())

    def reachable_keys(self, buckets, spec_lens) -> set:
        """Every key the serve loop can request in steady state; must equal
        the :meth:`lowering_jobs` key set (the reference's GRA005).

        - ``("decode", k)``: window picks come from ``ecfg.decode_steps``.
        - ``("verify", s)``: verify windows come from the engine's
          ``spec_lens`` buckets.
        - ``("chunk", c)`` / ``"splice"`` / ``"gather"``: paged admission,
          one validated chunk length; partial tail groups reuse these.
        - ``("chunkgroup", g)``: paged admission dispatches full groups
          only.
        - ``bucket`` / ``("dsplice", bucket)``: the dense buckets, clamped
          to max_seq_len by the engine.
        """
        keys: set = {("decode", k) for k in self.ecfg.decode_steps}
        keys |= {("verify", s) for s in spec_lens}
        if self.chunk:
            keys |= {("chunk", self.chunk), "splice", "gather"}
            g = max(1, self.ecfg.admit_group_chunks)
            if g > 1:
                keys.add(("chunkgroup", g))
        else:
            for bucket in buckets:
                keys |= {bucket, ("dsplice", bucket)}
        return keys

    def precompile(self, params, kv_cache: Params, pool: Params,
                   scratch: Params, mb: int, buckets, spec_lens) -> dict:
        """Build every :meth:`lowering_jobs` job and run it once with every
        lane inactive, then seal. On the card each decode and verify
        window is captured here (``_capture``: an eager run, then the
        capture) and replayed once; each eager path runs once, which loads
        its kernels and the libraries' handles. ``params`` may be the
        zero-filled storage the weights are bound into later
        (``InferenceEngine.bind_params``): a forward over zeros writes
        zeros, no NaN. Waits on the calling thread's stream only, so a
        weight load on another thread's stream runs on beside it. Returns
        the seconds of each job under the reference's
        ``compile_<key>_s`` names."""
        timings: dict[str, float] = {}
        self.window.active.zero_()
        self.window.drafts.zero_()
        for key, build, args in self.lowering_jobs(
                params, kv_cache, pool, scratch, mb, buckets, spec_lens):
            t0 = time.perf_counter()
            build()(*args)
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
            timings[f"compile_{key_name(key)}_s"] = \
                round(time.perf_counter() - t0, 4)
        self.seal()
        return timings


def key_name(key) -> str:
    """A cache key as the reference names it in its precompile timings:
    ``("decode", 4)`` is ``decode_4``, a dense bucket ``128`` is ``128``."""
    return "_".join(str(p) for p in key) if isinstance(key, tuple) \
        else str(key)


def window_state(params: Params, kv_cache: Params, ecfg, device,
                 generator: torch.Generator | None = None) -> WindowState:
    """A decode window's state over ``params`` and ``kv_cache``, every
    other tensor zeroed on ``device``: the slots' last tokens, lengths and
    active mask, the window's token buffer and the verify buffers (0
    draft columns when speculation is off). ``generator`` defaults to one
    on ``device`` seeded 0."""
    b = ecfg.max_batch
    s_max = max(ecfg.spec_len, 0)

    def zeros(*shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=device)

    if generator is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(0)
    return WindowState(params, kv_cache, last_token=zeros(b, 1),
                       cache_len=zeros(b), active=zeros(b, dtype=torch.bool),
                       toks=zeros(max(ecfg.decode_steps), b),
                       generator=generator, drafts=zeros(b, s_max),
                       out=zeros(b, 1 + s_max), n_acc=zeros(b))


def abstract_state(cfg, ecfg, kv_quant: bool = False, device="meta",
                   policy=None) -> dict:
    """The serving state an engine of this (model, engine-config) pair
    holds, built from the sources the engine allocates from (``KvPool``
    for the paged pool and table, the policy's ``init_kv_cache`` for the
    dense cache and the scratch): by default as ``device="meta"`` trees,
    so no byte is allocated; under a fake-tensor mode on the device the
    engine would serve from (the graph check). Returns ``{"kv_cache",
    "pool", "scratch", "mb"}``, one tree per rank under a sharding
    ``policy``; a dense engine's pool and scratch are empty and its mb is
    0."""
    device = torch.device(device)
    policy = policy or SingleDevicePolicy(device)
    if ecfg.kv_block_size:
        mgr = KvPool(cfg, ecfg, device, kv_quant, policy=policy)
        kv_cache = mgr.init_arrays()
        pool = per_rank(lambda kv: {k: v for k, v in kv.items()
                                    if k != "table"}, kv_cache)
        scratch = policy.init_kv_cache(cfg, 1, ecfg.max_seq_len)
        return {"kv_cache": kv_cache, "pool": pool, "scratch": scratch,
                "mb": mgr.mb}
    kv_cache = policy.init_kv_cache(cfg, ecfg.max_batch, ecfg.max_seq_len)
    return {"kv_cache": kv_cache, "pool": {}, "scratch": {}, "mb": 0}
