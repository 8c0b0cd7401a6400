"""LLM inference engine: continuous batching over a paged KV pool or a
dense KV cache (counterpart of ``tpu9/serving/engine.py``).

Slots are fixed ``max_batch`` decode lanes. In paged mode
(``kv_block_size > 0``) a request reserves its worst-case KV budget, reuses
any cached prefix blocks, chunk-prefills the rest of its prompt into a
batch-1 dense scratch (fused groups of chunks, each spliced into pool
blocks), and then joins the decode batch at its slot. In dense mode
(``kv_block_size == 0``, the ``EngineConfig`` default) every slot owns its
lanes of one contiguous [L, B, S, KH, D] cache: a request's prompt is padded
to a prefill bucket, prefilled in one call (the flash kernel) and spliced
into its slot's lanes; decode attends through the ragged kernel. Decode runs
in windows of k steps for the whole batch; the sampled ids of a window come
back to the host in one copy, and one window stays in flight while the host
fans out the previous one. On the card each window size is one captured
CUDA graph (``GraphFactory.decode_k``) replayed over device state the
engine owns at fixed addresses: the slots' last tokens, lengths and active
mask, the window's token buffer, the pool and its block table (or the
dense cache). Nothing the window reads is ever reassigned, only written in
place.

The paged pool is bf16, or int8 with f32 per-vector scales (``kv_quant``).
The runner's surface is the reference's: ``generate(..., trace=)``,
``cancel_request``, ``active_stream_requests``, ``flight_records``,
``arm_profile`` (``torch.profiler``), ``blackbox``/``last_postmortem``, the
tiering hooks of the pressure heartbeat, and the ``[surface.engine_stats]``
key set of ``stats()``. This port leaves out speculative decoding, the
tracer's engine spans, KV tiering, kvwire and sharding (ROADMAP queue A).
"""

from __future__ import annotations

import asyncio
import logging
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch

from ..models.transformer import DecoderConfig, init_kv_cache
from ..observability.metrics import Metrics
from ..ops.quant import validate_quant_mode
from ..ops.sampling import sample_logits
from ..utils.platform import default_device, host_to_device
from .flight import FlightRecorder
from .graphs import GraphFactory, WindowState
from .kvpool import KvPool
from .paged_kv import blocks_for
from .schedule import WindowScheduler

Params = dict[str, Any]

# deadline-expiry error prefix: a wire contract with the runner and the
# gateway (``tpu9.serving.engine.DEADLINE_ERROR``)
DEADLINE_ERROR = "deadline_exceeded"

log = logging.getLogger("tpu9_torch.serving")


@dataclass(frozen=True)
class EngineConfig:
    max_batch: int = 8
    max_seq_len: int = 2048
    prefill_buckets: tuple = (128, 512, 2048)
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    eos_id: int = -1              # -1 disables EOS stopping
    # decode-window buckets: K steps per host sync; K drops to the smallest
    # bucket whenever a waiting request could be admitted
    decode_steps: tuple = (1, 4, 16)
    # block size of the shared KV pool; 0 = the dense [B, S] cache
    kv_block_size: int = 0
    # pool size in blocks; 0 = auto (max_batch * max_seq/block)
    kv_pool_blocks: int = 0
    # chunked-prefill chunk length; 0 = the smallest prefill bucket
    prefill_chunk: int = 0
    # pool blocks the prefix cache may hold; 0 disables prefix reuse
    prefix_cache_blocks: int = 0
    # chunks per fused admission dispatch; a decode window is interleaved
    # between groups so a long admission does not starve the batch
    admit_group_chunks: int = 4
    # "int8": the pool stores int8 k/v with f32 per-(token, head) scales,
    # auto-sized to the bytes a bf16 pool would take; "" = model dtype
    kv_quant: str = ""


@dataclass
class _Window:
    """One dispatched decode window whose host fan-out is deferred.
    ``mask``/``reqs`` snapshot the active set at dispatch: a window delivers
    tokens only to the request that held the slot when it was dispatched.
    The rest is what its flight record needs, all host state."""
    k: int
    toks: torch.Tensor        # [k, B] on the host (filled by a copy in flight)
    ready: Any                # CUDA event recorded after the copy, or None
    mask: Any
    reqs: tuple
    t_mono: float = 0.0       # dispatch stamp
    pick: str = ""            # why this k
    kv_snap: tuple = ()       # (used, free, reserved) at dispatch (paged)
    delivered: Any = None     # {slot: tokens delivered} (host processing)


@dataclass
class _Request:
    request_id: str
    prompt: list[int]
    max_new_tokens: int
    slot: int = -1
    generated: list[int] = field(default_factory=list)
    done: asyncio.Event = field(default_factory=asyncio.Event)
    queue: Optional[asyncio.Queue] = None   # set for streaming requests
    error: str = ""
    cancelled: bool = False                 # client abandoned the request
    deadline_mono: float = 0.0              # 0 = no deadline
    # remote trace context (trace_id, parent span id) from the runner;
    # kept for the runner's drain, which reads it (no engine spans here)
    trace: Optional[tuple] = None
    t_enqueue_mono: float = 0.0
    t_first_mono: float = 0.0               # first token delivered
    admit_cached: int = 0                   # prefix-cache tokens reused
    admit_chunks: int = 0                   # prefill chunks dispatched


class InferenceEngine:
    """Continuous-batching engine around a decoder model."""

    def __init__(self, params: Params, cfg: DecoderConfig,
                 engine_cfg: EngineConfig = EngineConfig(), device=None):
        self.device = default_device(device)
        self.cfg = cfg
        self.ecfg = engine_cfg
        self.params = params
        b, s = engine_cfg.max_batch, engine_cfg.max_seq_len
        bs = engine_cfg.kv_block_size
        self.paged = bs > 0
        # "int8" is the one mode validate_quant_mode passes
        self.kv_quant = bool(validate_quant_mode(engine_cfg.kv_quant,
                                                 "kv_quant"))
        if self.kv_quant and not self.paged:
            raise ValueError("kv_quant='int8' requires the paged engine "
                             "(kv_block_size > 0)")
        self._chunk = 0
        if self.paged:
            if s % bs:
                raise ValueError(f"max_seq_len {s} % kv_block_size {bs}")
            chunk = engine_cfg.prefill_chunk \
                or min(engine_cfg.prefill_buckets)
            if chunk % bs:
                # a chunk smaller than a block would splice nothing
                raise ValueError(f"prefill_chunk {chunk} must be a multiple "
                                 f"of kv_block_size {bs}")
            if s % chunk:
                # the final chunk of a long prompt would run past the scratch
                raise ValueError(f"max_seq_len {s} must be a multiple of "
                                 f"prefill_chunk {chunk}")
            self._chunk = chunk
            self.pool = KvPool(cfg, engine_cfg, self.device, self.kv_quant)
            self.kv_cache = self.pool.init_arrays()
            self.allocator = self.pool.allocator
            self.prefix_cache = self.pool.prefix_cache
            # batch-1 dense scratch the chunked prefill writes through
            # before its blocks are spliced into the pool
            self._scratch = init_kv_cache(cfg, 1, s, device=self.device)
        else:
            self.pool = self.allocator = self.prefix_cache = None
            self.kv_cache = init_kv_cache(cfg, b, s, device=self.device)
        # the decode window's device state: owned here at fixed addresses
        # (a captured window replays them) and only written in place
        self.cache_len = torch.zeros((b,), dtype=torch.int32,
                                     device=self.device)
        self.last_token = torch.zeros((b, 1), dtype=torch.int32,
                                      device=self.device)
        self._active_dev = torch.zeros((b,), dtype=torch.bool,
                                       device=self.device)
        self._toks = torch.zeros((max(engine_cfg.decode_steps), b),
                                 dtype=torch.int32, device=self.device)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(0)
        self.graphs = GraphFactory(
            cfg, engine_cfg, self._chunk, self.device,
            window=WindowState(params, self.kv_cache, self.last_token,
                               self.cache_len, self._active_dev, self._toks,
                               self._gen))
        self.scheduler = WindowScheduler(self)
        # dense prefill buckets, clamped to the cache: a bucket wider than
        # max_seq_len would splice past the slot's lanes
        self._buckets = sorted({min(bk, s)
                                for bk in engine_cfg.prefill_buckets})
        self.active = np.zeros((b,), dtype=bool)
        self.slot_req: list[Optional[_Request]] = [None] * b
        self._queue: asyncio.Queue[_Request] = asyncio.Queue()
        self._loop_task: Optional[asyncio.Task] = None
        self._dead_reason: Optional[str] = None
        self._admitting: Optional[_Request] = None
        self._wait_room: list[_Request] = []
        # host mirror of cache_len: room checks never read the device
        self._host_len = np.zeros((b,), dtype=np.int64)
        # dispatched windows not yet host-processed; room accounting
        # includes their steps
        self._deferred_windows: list[_Window] = []
        self._inflight_steps = 0
        # spec_* stay 0 until speculative decoding is ported (queue A6)
        self._stats = {"active_streams": 0, "queued": 0,
                       "tokens_generated": 0, "decode_steps": 0,
                       "admit_dispatches": 0,
                       "admit_interleaved_windows": 0,
                       "spec_windows": 0, "spec_proposed": 0,
                       "spec_accepted": 0, "deadline_expired": 0}
        self._init_observability()

    def _init_observability(self) -> None:
        """The flight recorder, latency summaries, profiling hook, liveness
        watermark and HBM accounting, as the reference engine keeps them:
        host state only, read by ``stats()`` at heartbeat cadence."""
        self.flight = FlightRecorder()
        self.metrics = Metrics()
        # bring-up seconds, set by the runner; stats() forwards them flat
        self.bringup: dict = {}
        self._pick_reason = ""
        self._flight_kv_allocs = 0
        self._flight_evictions = 0
        # torch.profiler armed for the next N windows (arm_profile)
        self._profile_remaining = 0
        self._profile_active = False
        self._profile_path = ""
        self._profile_error = ""
        self._profiler = None
        self._profile_traces = 0
        # (monotonic, tokens_generated) pairs appended by stats()
        self._tps_window: list = []
        # decode physics per generated token: every step reads the whole
        # weight tree (KV bytes left out, as the reference does)
        weights = list(_tensor_leaves(self.params))
        wb = sum(t.numel() * t.element_size() for t in weights)
        self._phys_bytes_per_token_per_chip = wb
        self._phys_flops_per_token_per_chip = 2.0 * sum(t.numel()
                                                        for t in weights)
        self._device_kind = (torch.cuda.get_device_name(self.device)
                             if self.device.type == "cuda" else "cpu")
        # liveness watermark for the runner's watchdog
        self._windows_processed = 0
        self._last_dispatch_mono = 0.0
        self._last_progress_mono = time.monotonic()
        # HBM: live and peak from the allocator at stats() time; predicted
        # from the trees this engine holds (weights, KV, scratch); the
        # card's capacity read once
        self._hbm_peak_gb = 0.0
        kv = list(_tensor_leaves(self.kv_cache))
        if self.paged:
            kv += list(_tensor_leaves(self._scratch))
        kvb = sum(t.numel() * t.element_size() for t in kv)
        self.hbm_predicted_gb_per_chip = round((wb + kvb) / 1e9, 3)
        self._hbm_limit_gb = (round(torch.cuda.get_device_properties(
            self.device).total_memory / 1e9, 3)
            if self.device.type == "cuda" else 0.0)
        # black box: the serve loop's failure handler leaves its forensic
        # record here for the runner to ship
        self.last_postmortem: Optional[dict] = None

    def _bucket_for(self, n: int) -> int:
        for b in self._buckets:
            if n <= b:
                return b
        return self._buckets[-1]

    # -- paged-KV bookkeeping ------------------------------------------------

    def _pool_dict(self) -> dict:
        keys = ("k", "v", "k_scale", "v_scale") if self.kv_quant \
            else ("k", "v")
        return {k: self.kv_cache[k] for k in keys}

    def _worst_case_tokens(self, req: _Request) -> int:
        # prompt + generation budget + in-flight overshoot slack, clamped
        # to the cache
        slack = max(self.ecfg.decode_steps) + 1
        return min(len(req.prompt) + req.max_new_tokens + slack,
                   self.ecfg.max_seq_len)

    def _push_table(self, slot: int) -> None:
        self.pool.push_table(slot)           # one row, in place

    def _ensure_slot_blocks(self, slot: int, n_tokens: int) -> bool:
        if not self.pool.ensure_slot_blocks(slot, n_tokens):
            return False
        self._push_table(slot)
        return True

    # -- public API ----------------------------------------------------------

    async def start(self) -> None:
        if self._loop_task is None:
            self._loop_task = asyncio.create_task(self._serve_loop())

    async def stop(self) -> None:
        if self._profile_active:
            # a dangling trace outlives the engine otherwise
            self._profile_remaining = 0
            self._deferred_windows.clear()
            self._profile_maybe_stop()
        task, self._loop_task = self._loop_task, None
        if task is not None:
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                if asyncio.current_task().cancelling():
                    raise               # stop() itself was cancelled
            except Exception:           # noqa: BLE001 — the loop already
                pass                    # died; its failure was logged
        # a clean shutdown must not strand callers
        self._fail_all_requests("engine stopped")

    def warmup(self) -> dict:
        """Build every computation the serve loop can reach and run each
        once with all lanes inactive (paged writes land in the trash block,
        no slot advances), then seal the factory: the first request pays no
        kernel build, library set-up or capture, and a later build counts
        as a post-warmup compile. On the card each decode window is
        captured here (``graphs.capture_s`` has the seconds) and replayed
        once."""
        timings: dict[str, float] = {}
        if self.paged:
            self._warmup_paged(timings)
        else:
            self._warmup_dense(timings)
        self._active_dev.zero_()
        for k in self.ecfg.decode_steps:
            t0 = time.perf_counter()
            self.graphs.decode_k(k)()
            self._sync(self._toks)
            timings[f"decode_k{k}_s"] = time.perf_counter() - t0
        self.graphs.seal()
        return timings

    def _warmup_dense(self, timings: dict) -> None:
        """Each bucket's prefill and splice. Slot 0's lanes get the zero
        prompt's prefix; its cache_len stays 0, so nothing attends it."""
        for bucket in self._buckets:
            t0 = time.perf_counter()
            tokens = torch.zeros((1, bucket), dtype=torch.int32,
                                 device=self.device)
            last, cache = self.graphs.prefill_fn(bucket)(self.params, tokens,
                                                         1)
            self._sync(last)
            timings[f"prefill_{bucket}_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            self.graphs.dense_splice_fn(bucket)(
                self.kv_cache["k"], self.kv_cache["v"], cache["k"],
                cache["v"], 0)
            self._sync(self.kv_cache["k"][0, 0, 0])
            timings[f"dsplice_{bucket}_s"] = time.perf_counter() - t0

    def _warmup_paged(self, timings: dict) -> None:
        """The paged admission paths: chunk step, splice, prefix gather and
        the fused group."""
        bs = self.ecfg.kv_block_size
        c = self._chunk
        trash = np.full((c // bs,), self.pool.trash_block, dtype=np.int32)
        t0 = time.perf_counter()
        toks = torch.zeros((1, c), dtype=torch.int32, device=self.device)
        last, self._scratch = self.graphs.chunk_fn()(
            self.params, toks, 0, self._scratch, 0)
        self.graphs.splice_fn()(self._pool_dict(), self._scratch["k"],
                                self._scratch["v"], 0, trash)
        self.graphs.gather_fn()(self._pool_dict(), self.pool.table_np[0],
                                self._scratch)
        self._sync(last)
        timings[f"chunk_{c}_s"] = time.perf_counter() - t0
        g = max(1, self.ecfg.admit_group_chunks)
        if g > 1:
            t0 = time.perf_counter()
            offs = np.minimum(np.arange(g) * c,
                              self.ecfg.max_seq_len - c).astype(np.int32)
            _, self._scratch, last = self.graphs.chunk_group_fn(g)(
                self.params, self._pool_dict(), self._scratch,
                torch.zeros((g, c), dtype=torch.int32, device=self.device),
                offs, np.full((g,), c - 1, dtype=np.int32),
                np.full((g, c // bs), self.pool.trash_block, dtype=np.int32))
            self._sync(last)
            timings[f"chunk_group_{g}_s"] = time.perf_counter() - t0

    @staticmethod
    def _sync(t: torch.Tensor) -> None:
        t.reshape(-1)[:1].cpu()

    def cancel_request(self, req: _Request) -> None:
        """Abandon a request (client disconnected mid-stream): a waiting
        one is dropped at once, a live one retires its slot (and frees its
        blocks) at the next window's host processing instead of decoding
        its whole budget into a queue nobody reads."""
        req.cancelled = True
        if req.done.is_set():
            return
        if req in self._wait_room:
            self._wait_room.remove(req)
            self._finish(req)

    def active_stream_requests(self) -> list:
        """Live streaming requests (queue-backed, not cancelled): what the
        runner's graceful drain walks."""
        return [req for slot, req in enumerate(self.slot_req)
                if req is not None and self.active[slot]
                and req.queue is not None and not req.cancelled]

    async def generate(self, prompt: list[int], max_new_tokens: int = 32,
                       request_id: str = "", stream: bool = False,
                       trace: Optional[tuple] = None,
                       budget_s: Optional[float] = None):
        """Generate up to ``max_new_tokens`` ids after ``prompt``. With
        ``stream=True`` returns the request at once; its ``queue`` yields
        each id and then ``None``. ``trace`` is the runner's remote span
        context ``(trace_id, parent_span_id)``; it is kept on the request
        (the runner's drain reads it) but no engine spans are recorded.
        ``budget_s`` is the remaining deadline: a request still queued past
        it is never prefilled, and one still decoding is retired at the
        next window boundary."""
        if self._dead_reason is not None:
            raise RuntimeError(f"engine is dead: {self._dead_reason}")
        if budget_s is not None and budget_s <= 0:
            raise TimeoutError(f"{DEADLINE_ERROR}: budget exhausted "
                               "before admission")
        # chunked prefill (paged) has no bucket cap, only the cache's
        limit = self.ecfg.max_seq_len - 1 if self.paged else \
            min(self._buckets[-1], self.ecfg.max_seq_len - 1)
        if len(prompt) > limit:
            raise ValueError(
                f"prompt length {len(prompt)} exceeds engine limit {limit}")
        if not prompt:
            raise ValueError("empty prompt")
        now = time.monotonic()
        req = _Request(request_id=request_id or f"r{time.monotonic_ns()}",
                       prompt=list(prompt), max_new_tokens=max_new_tokens,
                       queue=asyncio.Queue() if stream else None,
                       trace=trace if trace and trace[0] else None,
                       t_enqueue_mono=now,
                       deadline_mono=now + budget_s if budget_s else 0.0)
        await self._queue.put(req)
        if stream:
            return req
        await req.done.wait()
        if req.error:
            if req.error.startswith(DEADLINE_ERROR):
                raise TimeoutError(req.error)
            if req.error.startswith("engine"):
                raise RuntimeError(req.error)
            raise ValueError(req.error)
        return req.generated

    def flight_records(self, limit: int = 256,
                       since_seq: int = 0) -> list[dict]:
        """Flight-recorder tail (newest last)."""
        return self.flight.snapshot(limit=limit, since_seq=since_seq)

    def blackbox(self, reason: str, exception: str = "") -> dict:
        """Raw forensic material for a post-mortem record: scalar stats,
        scheduler and KV-pool state, HBM, and the flight-recorder tail.
        Plain host reads only, safe next to a wedged or dead serve loop.
        ``spans`` stays empty: the port records no engine spans."""
        stats = self.stats()
        scheduler = {
            "active_slots": [int(i) for i in range(self.ecfg.max_batch)
                             if self.active[i]],
            "slot_requests": {
                str(i): req.request_id
                for i, req in enumerate(self.slot_req) if req is not None},
            "slot_generated": {
                str(i): len(req.generated)
                for i, req in enumerate(self.slot_req) if req is not None},
            "queued": self._queue.qsize(),
            "wait_room": len(self._wait_room),
            "admitting": (self._admitting.request_id
                          if self._admitting else ""),
            "inflight_steps": self._inflight_steps,
            "deferred_windows": len(self._deferred_windows),
            "pick_reason": self._pick_reason,
        }
        kv_pool = {}
        if self.paged:
            kv_pool = {"n_blocks": self.allocator.n_blocks,
                       "block_size": self.allocator.block_s,
                       "used": self.allocator.used_count,
                       "free": self.allocator.free_count,
                       "reserved": self.allocator.reserved,
                       "lifetime_allocs": self.pool.kv_allocs,
                       "kv_quant": self.ecfg.kv_quant if self.kv_quant
                       else "",
                       "prefix_cache": self.prefix_cache.stats()}
        hbm = {k: stats.get(k, 0.0)
               for k in ("hbm_used_gb_per_chip", "hbm_peak_gb_per_chip",
                         "hbm_predicted_gb_per_chip",
                         "hbm_limit_gb_per_chip")}
        return {
            "reason": reason,
            "exception": exception,
            "stats": {k: v for k, v in stats.items()
                      if isinstance(v, (int, float, str, bool))},
            "scheduler": scheduler,
            "kv_pool": kv_pool,
            "hbm": hbm,
            "flight": self.flight_records(limit=64),
            "spans": [],
        }

    def stats(self) -> dict:
        """The ``[surface.engine_stats]`` keys of the reference engine
        (``tpu9/analysis/contracts.toml``), but for the ``kvwire_`` and
        ``kvtier_`` families, which wait for their ports. Host state only:
        a device read here would stall the runner's event loop behind the
        window in flight."""
        out = dict(self._stats)
        out["active_streams"] = int(self.active.sum())
        out["queued"] = self._queue.qsize()
        out["engine_dead"] = self._dead_reason is not None
        out["token_pressure"] = float(
            self._host_len.sum()
            / (self.ecfg.max_batch * self.ecfg.max_seq_len))
        # compile sentinel: a post-warmup build stalled serving
        out["graph_compiles"] = self.graphs.compiles
        out["graph_compiles_post_warmup"] = self.graphs.post_seal_compiles
        out["graph_compile_stall_s"] = round(self.graphs.post_seal_stall_s,
                                             6)
        # tokens/s over the reads of the last 30 s (heartbeat cadence)
        now_m = time.monotonic()
        self._tps_window.append((now_m, self._stats["tokens_generated"]))
        while (len(self._tps_window) > 2
               and now_m - self._tps_window[0][0] > 30.0):
            self._tps_window.pop(0)
        t0, c0 = self._tps_window[0]
        span = now_m - t0
        out["tokens_per_sec"] = round(
            (self._stats["tokens_generated"] - c0) / span, 3) \
            if span > 0.5 else 0.0
        out["decode_bytes_per_token_per_chip"] = \
            self._phys_bytes_per_token_per_chip
        out["decode_flops_per_token_per_chip"] = \
            self._phys_flops_per_token_per_chip
        out["device_kind"] = self._device_kind
        # one card: no tensor or fsdp sharding yet (queue A9)
        out["topo_tp"] = out["topo_fsdp"] = out["topo_n_chips"] = 1
        out["hbm_used_gb_per_chip"] = (
            round(torch.cuda.memory_allocated(self.device) / 1e9, 3)
            if self.device.type == "cuda" else 0.0)
        out["windows_processed"] = self._windows_processed
        out["last_dispatch_age_s"] = (
            round(now_m - self._last_dispatch_mono, 3)
            if self._last_dispatch_mono else -1.0)
        out["last_progress_age_s"] = round(
            now_m - self._last_progress_mono, 3)
        self._hbm_peak_gb = max(self._hbm_peak_gb,
                                out["hbm_used_gb_per_chip"])
        out["hbm_peak_gb_per_chip"] = self._hbm_peak_gb
        out["hbm_predicted_gb_per_chip"] = self.hbm_predicted_gb_per_chip
        out["hbm_limit_gb_per_chip"] = self._hbm_limit_gb
        out["spec_enabled"] = False
        out["spec_acceptance_rate"] = 0.0
        out["flight"] = self.flight.summary()
        out["profile"] = {"armed": self._profile_remaining,
                          "active": self._profile_active,
                          "path": self._profile_path,
                          "error": self._profile_error}
        for k, v in self.bringup.items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                out[f"coldstart_{k}"] = v
        # no streaming restore is ported (queue A8): every replica is a
        # whole bring-up, fully ready
        out["scaleout_groups_total"] = out["scaleout_groups_ready"] = 0
        out["scaleout_ready_frac"] = 1.0
        out["scaleout_ready_groups"] = ""
        lat = {}
        summaries = self.metrics.to_dict()["summaries"]
        for phase in ("ttft", "tbt", "queue_wait", "prefill",
                      "decode_window", "e2e"):
            snap = summaries.get(f"tpu9_engine_{phase}_s")
            if snap:
                lat[f"{phase}_p50_s"] = round(snap["p50"], 6)
                lat[f"{phase}_p95_s"] = round(snap["p95"], 6)
                lat[f"{phase}_count"] = snap["count"]
                lat[f"{phase}_mean_s"] = round(snap["mean"], 6)
        out["latency"] = lat
        if self.paged:
            out["kv_blocks_used"] = self.allocator.used_count
            out["kv_blocks_free"] = self.allocator.free_count
            out["kv_blocks_reserved"] = self.allocator.reserved
            out["kv_block_size"] = self.allocator.block_s
            # the pool format ("" = model dtype), so a fleet can tell them
            # apart
            out["kv_quant"] = self.ecfg.kv_quant if self.kv_quant else ""
            out["queued"] += len(self._wait_room)
            out["prefix_cache"] = self.prefix_cache.stats()
            # reserved fraction is the honest "can I take another request"
            # signal under paging
            out["token_pressure"] = max(
                out["token_pressure"],
                self.allocator.reserved / max(self.allocator.n_blocks, 1))
        return out

    # -- the pressure heartbeat's tiering hooks ------------------------------
    # Only the device tier exists: every entry reads "d", and there are no
    # spills or tier decisions until the host tier is ported (queue A4).

    def kvtier_digest(self, top_k: int = 48) -> str:
        """Bounded top-K prefix-key summary for the directory heartbeat:
        ``hex16:tier:n_tokens`` comma-joined, MRU first."""
        if self.prefix_cache is None:
            return ""
        ents = sorted(self.prefix_cache._entries.values(),
                      key=lambda e: -e.last_used)[:top_k]
        return ",".join(f"{e.key.hex()[:16]}:d:{e.n_tokens}" for e in ents)

    def kvtier_deltas(self, since: int) -> tuple:
        """Tier-change journal after cursor ``since`` (evictions the
        directory must retract) and the new cursor."""
        if self.prefix_cache is None:
            return [], 0
        return self.prefix_cache.deltas_since(since)

    def drain_kv_spills(self) -> list:
        """Peer-cache spill payloads: none without a host tier."""
        return []

    def drain_kvtier_decisions(self) -> list:
        """Journaled ``kv_tier`` decisions: none without a host tier."""
        return []

    # -- observability hooks -------------------------------------------------
    # Host bookkeeping on state the loop already holds: latency observes
    # per request and per window, never per token, and flight records.

    def _obs_admit_end(self, req: _Request, t0_mono: float,
                       il0: int) -> None:
        dur = max(time.monotonic() - t0_mono, 0.0)
        self._last_progress_mono = time.monotonic()   # admission = progress
        self.metrics.observe("tpu9_engine_prefill_s", dur)
        self.flight.record(
            "admit", request_id=req.request_id, slot=req.slot,
            prompt_tokens=len(req.prompt), cached_tokens=req.admit_cached,
            chunks=req.admit_chunks,
            interleaved=self._stats["admit_interleaved_windows"] - il0,
            dur_s=round(dur, 6))

    def _obs_stamp_window(self, win: _Window) -> _Window:
        win.t_mono = time.monotonic()
        self._last_dispatch_mono = win.t_mono
        win.pick = self._pick_reason
        if self.paged:
            win.kv_snap = (self.allocator.used_count,
                           self.allocator.free_count,
                           self.allocator.reserved)
        return win

    def _obs_window(self, win: _Window, t_host0: float) -> None:
        """One flight record at host processing. ``wait_s`` (dispatch →
        fan-out start) includes the deliberate one-window overlap;
        ``host_s`` is the fan-out."""
        now_m = time.monotonic()
        self.metrics.observe("tpu9_engine_decode_window_s",
                             max(t_host0 - win.t_mono, 0.0))
        self._windows_processed += 1
        self._last_progress_mono = now_m
        rec = {"k": win.k, "pick": win.pick,
               "batch": int(win.mask.sum()),
               "slots": {s: r.request_id for s, r in enumerate(win.reqs)
                         if r is not None and win.mask[s]},
               "tokens": win.delivered or {},
               "wait_s": round(max(t_host0 - win.t_mono, 0.0), 6),
               "host_s": round(max(now_m - t_host0, 0.0), 6)}
        if win.kv_snap:
            used, free, reserved = win.kv_snap
            rec.update(kv_used=used, kv_free=free, kv_reserved=reserved,
                       kv_alloc=self.pool.kv_allocs - self._flight_kv_allocs)
            self._flight_kv_allocs = self.pool.kv_allocs
            ev = self.prefix_cache.evictions
            rec.update(prefix_evictions=ev - self._flight_evictions,
                       prefix_pinned=self.prefix_cache.pinned)
            self._flight_evictions = ev
        self.flight.record("decode", **rec)

    def _obs_first_token(self, req: _Request) -> None:
        req.t_first_mono = time.monotonic()
        self.metrics.observe(
            "tpu9_engine_ttft_s",
            max(req.t_first_mono - req.t_enqueue_mono, 0.0))

    def _obs_done(self, req: _Request) -> None:
        """Idempotent: reachable from both _retire and _finish; only the
        first call observes."""
        if not req.t_enqueue_mono:
            return
        now = time.monotonic()
        n = len(req.generated)
        self.metrics.observe("tpu9_engine_e2e_s",
                             max(now - req.t_enqueue_mono, 0.0))
        if req.t_first_mono and n > 1:
            self.metrics.observe("tpu9_engine_tbt_s",
                                 max(now - req.t_first_mono, 0.0) / (n - 1))
        req.t_enqueue_mono = 0.0

    # -- on-demand profiling -------------------------------------------------

    def arm_profile(self, windows: int = 8, out_dir: str = "") -> dict:
        """Arm ``torch.profiler`` for the next ``windows`` dispatched
        windows. Returns the dump directory at once; the trace starts at
        the next window boundary and stops once the armed windows have
        been host-processed (or the loop goes idle), and is written there
        as a Chrome trace."""
        if windows <= 0:
            raise ValueError(f"windows must be positive, got {windows}")
        if self._profile_active or self._profile_remaining > 0:
            return {"path": self._profile_path,
                    "windows": self._profile_remaining,
                    "already_armed": True}
        self._profile_path = out_dir or tempfile.mkdtemp(
            prefix="tpu9-profile-")
        self._profile_remaining = windows
        self._profile_error = ""
        self.flight.record("profile", event="armed", windows=windows,
                           path=self._profile_path)
        return {"path": self._profile_path, "windows": windows}

    def _profile_window_start(self) -> None:
        if self._profile_remaining <= 0 or self._profile_active:
            return
        try:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            os.makedirs(self._profile_path, exist_ok=True)
            self._profiler = profile(activities=acts)
            self._profiler.start()
            self._profile_active = True
        except Exception as exc:    # noqa: BLE001 — profiling must never
            # take the serve loop down; surface the failure in stats()
            self._profile_error = f"{type(exc).__name__}: {exc}"
            self._profile_remaining = 0
            self._profiler = None

    def _profile_window_dispatched(self) -> None:
        if self._profile_active and self._profile_remaining > 0:
            self._profile_remaining -= 1

    def _profile_maybe_stop(self, idle: bool = False) -> None:
        """Stop once every armed window has been host-processed, so the
        trace covers the whole window set; ``idle`` (the loop about to
        park) stops early with armed windows left."""
        if not self._profile_active or self._deferred_windows:
            return
        if self._profile_remaining > 0 and not idle:
            return
        left, self._profile_remaining = self._profile_remaining, 0
        prof, self._profiler = self._profiler, None
        self._profile_active = False
        self._profile_traces += 1
        trace = os.path.join(self._profile_path,
                             f"trace-{os.getpid()}-{self._profile_traces}"
                             ".json")
        try:
            prof.stop()
            prof.export_chrome_trace(trace)
        except Exception as exc:  # noqa: BLE001 — see start
            self._profile_error = f"{type(exc).__name__}: {exc}"
        self.flight.record("profile", event="stopped",
                           path=self._profile_path, trace=trace,
                           windows_left=left, error=self._profile_error)

    # -- admission -----------------------------------------------------------

    async def _admit(self, req: _Request, slot: int):
        """Prefill and splice one request into ``slot`` and sample its first
        token. Returns the first token as a device value; the serve loop
        reads all admissions' first tokens in one copy."""
        t0_mono = time.monotonic()
        self.metrics.observe("tpu9_engine_queue_wait_s",
                             max(t0_mono - req.t_enqueue_mono, 0.0))
        il0 = self._stats["admit_interleaved_windows"]
        if self.paged:
            first = await self._admit_paged(req, slot)
        else:
            first = self._admit_dense(req, slot)
        self._obs_admit_end(req, t0_mono, il0)
        return first

    def _admit_dense(self, req: _Request, slot: int):
        """Dense admission: pad the prompt to its bucket, prefill it in one
        call, copy its KV into the slot's lanes."""
        n = len(req.prompt)
        bucket = self._bucket_for(n)
        tokens = np.zeros((1, bucket), dtype=np.int32)
        tokens[0, :n] = req.prompt[:bucket]
        last, cache = self.graphs.prefill_fn(bucket)(
            self.params, torch.from_numpy(tokens).to(self.device), n)
        self.graphs.dense_splice_fn(bucket)(
            self.kv_cache["k"], self.kv_cache["v"], cache["k"], cache["v"],
            slot)
        self.cache_len[slot] = n
        self._host_len[slot] = n
        first = sample_logits(last, self._gen,
                              temperature=self.ecfg.temperature,
                              top_k=self.ecfg.top_k, top_p=self.ecfg.top_p)
        self.last_token[slot, 0] = first
        self._occupy_slot(req, slot)
        return first

    def _occupy_slot(self, req: _Request, slot: int) -> None:
        req.slot = slot
        self.active[slot] = True
        self.slot_req[slot] = req

    async def _admit_paged(self, req: _Request, slot: int):
        """Paged admission: reserve the worst case, reuse cached prefix
        blocks, chunk-prefill the suffix in fused groups (a decode window
        interleaved between groups), splice, and sample the first token."""
        bs = self.ecfg.kv_block_size
        n = len(req.prompt)
        if self.pool.slot_blocks[slot]:
            self.allocator.release(self.pool.slot_blocks[slot])
            self.pool.slot_blocks[slot] = []
        self.pool.slot_reserved[slot] = self.allocator.reserve(
            self._worst_case_tokens(req))

        entry = self.prefix_cache.lookup(req.prompt) \
            if self.ecfg.prefix_cache_blocks > 0 else None
        shared: list[int] = list(entry.blocks) if entry else []
        p = entry.n_tokens if entry else 0
        # cached prefixes end on block boundaries, chunk windows start on
        # chunk boundaries: round p down to a chunk multiple. Positions
        # [p', p) are recomputed and re-spliced with the same values.
        p -= p % self._chunk
        self.allocator.retain(shared)
        if entry is not None:
            # the blocks are retained: eviction can no longer free them
            self.prefix_cache.release_pin(entry)

        total_blocks = blocks_for(n + 1, bs)
        fresh = self.pool.alloc_blocks(total_blocks - len(shared))
        blocks = self.pool.slot_blocks[slot] = shared + fresh
        trash = self.pool.trash_block
        # the device table row stays all-trash until admission completes:
        # decode windows interleaved below write every inactive lane at
        # position 0 through its row, which must not be a block in use here
        row = np.full((self.pool.mb,), trash, dtype=np.int32)
        row[:len(blocks)] = blocks

        scratch = self._scratch
        if p:
            scratch = self.graphs.gather_fn()(self._pool_dict(), row, scratch)
            self._stats["admit_dispatches"] += 1

        c = self._chunk
        nb = c // bs
        suffix = req.prompt[p:]
        m = len(suffix)
        n_chunks = -(-m // c)
        req.admit_cached = p
        req.admit_chunks = n_chunks
        toks_all = np.zeros((n_chunks, c), dtype=np.int32)
        offsets = np.zeros((n_chunks,), dtype=np.int32)
        last_idxs = np.zeros((n_chunks,), dtype=np.int32)
        # chunk tail past the slot's blocks is padding: it goes to the
        # trash block, never a real one
        phys_all = np.full((n_chunks, nb), trash, dtype=np.int32)
        for k_chunk, i in enumerate(range(0, m, c)):
            valid = min(c, m - i)
            toks_all[k_chunk, :valid] = suffix[i:i + valid]
            offsets[k_chunk] = p + i
            last_idxs[k_chunk] = valid - 1
            first_block = (p + i) // bs
            for j in range(nb):
                idx = first_block + j
                if idx < len(blocks):
                    phys_all[k_chunk, j] = blocks[idx]
        toks_dev = torch.from_numpy(toks_all).to(self.device)

        last = None
        group = max(1, self.ecfg.admit_group_chunks)
        k_chunk = 0
        while k_chunk < n_chunks:
            # full groups take the fused path; a partial tail runs chunk by
            # chunk, as the JAX engine does to keep its graph set closed
            g = group if n_chunks - k_chunk >= group else 1
            sl = slice(k_chunk, k_chunk + g)
            if g > 1:
                _, scratch, last = self.graphs.chunk_group_fn(g)(
                    self.params, self._pool_dict(), scratch, toks_dev[sl],
                    offsets[sl], last_idxs[sl], phys_all[sl])
                self._stats["admit_dispatches"] += 1
            else:
                last, scratch = self.graphs.chunk_fn()(
                    self.params, toks_dev[sl], int(offsets[k_chunk]),
                    scratch, int(last_idxs[k_chunk]))
                self.graphs.splice_fn()(
                    self._pool_dict(), scratch["k"], scratch["v"],
                    int(offsets[k_chunk]), phys_all[k_chunk])
                self._stats["admit_dispatches"] += 2
            k_chunk += g
            if k_chunk < n_chunks:
                # long admission: keep the decode batch producing tokens
                self._interleave_decode_window()
                await asyncio.sleep(0)
        self._scratch = scratch

        if self.ecfg.prefix_cache_blocks > 0:
            self.prefix_cache.insert(req.prompt, blocks)

        self._push_table(slot)            # the real row becomes visible now
        self.cache_len[slot] = n
        self._host_len[slot] = n
        first = sample_logits(last, self._gen,
                              temperature=self.ecfg.temperature,
                              top_k=self.ecfg.top_k, top_p=self.ecfg.top_p)
        self.last_token[slot, 0] = first
        self._occupy_slot(req, slot)
        return first

    def _interleave_decode_window(self) -> None:
        """Dispatch one decode window for the active batch without syncing
        (processed after the admission sync). Room accounting includes the
        steps already in flight."""
        if not self.active.any():
            return
        ks = self.ecfg.decode_steps
        want = ks[1] if len(ks) > 1 else ks[0]
        # total in-flight overshoot stays within the reserved slack
        limit = min(want, max(ks) - self._inflight_steps)
        for slot in range(self.ecfg.max_batch):
            req = self.slot_req[slot]
            if req is None or not self.active[slot]:
                continue
            # budget is soft (overshoot tokens are discarded at retire);
            # cache room is hard
            remaining = (req.max_new_tokens - len(req.generated)
                         - self._inflight_steps)
            room = (self.ecfg.max_seq_len - 1 - int(self._host_len[slot])
                    - self._inflight_steps)
            limit = min(limit, max(1, remaining), max(0, room))
        k = max((cand for cand in ks if cand <= limit), default=0)
        if k <= 0:
            return              # out of cache room or reservation slack
        self._pick_reason = "interleave"
        self._deferred_windows.append(self._launch_window(k))
        self._stats["admit_interleaved_windows"] += 1

    def _deliver_first(self, req: _Request, first: int) -> None:
        req.generated.append(first)
        self._obs_first_token(req)
        if req.queue is not None:
            req.queue.put_nowait(first)
        if (req.max_new_tokens <= 1
                or (self.ecfg.eos_id >= 0 and first == self.ecfg.eos_id)):
            self._retire(req.slot)

    def _retire(self, slot: int) -> None:
        req = self.slot_req[slot]
        self.active[slot] = False
        self.slot_req[slot] = None
        self.cache_len[slot] = 0
        self._host_len[slot] = 0
        if self.paged:
            # physical blocks back to the pool, reservation released, the
            # table row back to trash (in place)
            self.pool.release_slot(slot)
        if req is not None:
            self._obs_done(req)
            if req.queue is not None:
                req.queue.put_nowait(None)
            req.done.set()

    def _room_for(self, req: _Request) -> bool:
        """Paged admission control: a request enters only when the pool
        can reserve its worst case, so mid-decode allocation never fails.
        A dense slot always has its whole lanes."""
        return (not self.paged
                or self.allocator.can_reserve(self._worst_case_tokens(req)))

    @staticmethod
    def _req_expired(req: _Request) -> bool:
        return req.deadline_mono > 0 and time.monotonic() > req.deadline_mono

    def _expire_unadmitted(self, req: _Request) -> None:
        self._stats["deadline_expired"] += 1
        self._finish(req, error=f"{DEADLINE_ERROR}: budget exhausted "
                                "before prefill")

    def _next_admittable(self) -> Optional[_Request]:
        while self.paged and self._wait_room:
            head = self._wait_room[0]
            if head.cancelled or self._req_expired(head):
                self._wait_room.pop(0)
                if head.cancelled:
                    self._finish(head)
                else:
                    self._expire_unadmitted(head)
                continue
            if self._room_for(head):
                return self._wait_room.pop(0)
            return None                     # FIFO: don't starve the head
        while not self._queue.empty():
            req = self._queue.get_nowait()
            if req.cancelled:
                self._finish(req)
                continue
            if self._req_expired(req):
                self._expire_unadmitted(req)
                continue
            if self._room_for(req):
                return req
            self._wait_room.append(req)
            return None
        return None

    def _finish(self, req: _Request, error: str = "") -> None:
        if error and not req.error:
            req.error = error
        self._obs_done(req)
        if req.queue is not None:
            req.queue.put_nowait(None)
        req.done.set()

    def _fail_all_requests(self, reason: str) -> None:
        """Give every known request a terminal answer."""
        for req in ([r for r in self.slot_req if r is not None]
                    + ([self._admitting] if self._admitting else [])
                    + list(self._wait_room)):
            self._finish(req, error=reason)
        self._wait_room.clear()
        self._admitting = None
        while not self._queue.empty():
            self._finish(self._queue.get_nowait(), error=reason)

    # -- serve loop ----------------------------------------------------------

    async def _serve_loop(self) -> None:
        try:
            await self._serve_loop_inner()
        except asyncio.CancelledError:
            raise
        except Exception as exc:      # noqa: BLE001 — boundary: fail every
            # request with the cause and make generate() fail fast
            log.exception("engine loop died")
            self._dead_reason = f"{type(exc).__name__}: {exc}"
            # black box first: the fan-out below clears the scheduler
            # state the record exists to capture, and a failing snapshot
            # must not mask the original failure
            try:
                self.last_postmortem = self.blackbox(
                    "engine_crash", f"{type(exc).__name__}: {exc}")
            except Exception:   # noqa: BLE001 — evidence is best-effort
                log.exception("post-mortem snapshot failed")
            self._fail_all_requests(f"engine failure: {exc}")
            raise

    async def _serve_loop_inner(self) -> None:
        while True:
            # an armed profile stops once its windows are processed
            self._profile_maybe_stop()
            # an imminent admission first drains the in-flight window: its
            # steps occupy the slack interleaved windows need, and its
            # retirements may free the slot being admitted into
            if self._deferred_windows and self.scheduler.admission_can_proceed():
                self._drain_windows()
            pending: list[tuple[_Request, Any]] = []
            while not self.active.all():
                req = self._next_admittable()
                if req is None:
                    break
                slot = int(np.argmin(self.active))
                self._admitting = req
                pending.append((req, await self._admit(req, slot)))
                self._admitting = None

            if not self.active.any() and not pending:
                if self.paged and self._wait_room:
                    # idle with a waiting head: reservations are zero, so it
                    # is bigger than the whole pool — fail it loudly
                    head = self._wait_room.pop(0)
                    self._finish(head, error="request exceeds KV pool capacity")
                    continue
                if self._deferred_windows:
                    self._drain_windows()
                # parked idle time must not leak into an armed trace
                self._profile_maybe_stop(idle=True)
                req = await self._queue.get()       # idle: block for work
                if req.cancelled:
                    self._finish(req)
                    continue
                if self._req_expired(req):
                    self._expire_unadmitted(req)
                    continue
                if not self._room_for(req):
                    self._wait_room.append(req)
                    continue
                self._admitting = req
                pending.append((req, await self._admit(req, 0)))
                self._admitting = None

            if pending:
                # one copy for every admitted request's first token
                firsts = torch.stack([f.reshape(()) for _, f in pending]).cpu()
                for (req, _), first in zip(pending, firsts.tolist()):
                    self._deliver_first(req, int(first))
                # windows dispatched during those admissions are done by now
                self._drain_windows()

            if not self.active.any():
                if self._deferred_windows:
                    self._drain_windows()
                continue

            self._profile_window_start()
            self._deferred_windows.append(self._dispatch_window())
            self._profile_window_dispatched()
            # keep exactly one window in flight: the host fan-out of the
            # older one runs while the new one computes
            while len(self._deferred_windows) > 1:
                self._process_window(self._deferred_windows.pop(0))
            await asyncio.sleep(0)

    def _launch_window(self, k: int) -> _Window:
        """Grow every active slot's blocks for ``k`` more writes (paged),
        dispatch a k-step decode window over the static state and start
        the copy of its tokens to the host."""
        for slot in range(self.ecfg.max_batch):
            if self.paged and self.active[slot]:
                self._ensure_slot_blocks(
                    slot, min(int(self._host_len[slot]) + self._inflight_steps
                              + k + 1, self.ecfg.max_seq_len))
        host_to_device(self._active_dev, self.active)
        self.graphs.decode_k(k)()
        self._stats["decode_steps"] += k
        self._inflight_steps += k
        toks = self._toks[:k]
        if toks.is_cuda:
            # queued behind the window: the next window's writes to the
            # token buffer come after this copy on the stream
            host = torch.empty(toks.shape, dtype=toks.dtype, pin_memory=True)
            host.copy_(toks, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record()
        else:
            host, ready = toks.clone(), None
        return self._obs_stamp_window(
            _Window(k=k, toks=host, ready=ready, mask=self.active.copy(),
                    reqs=tuple(self.slot_req)))

    def _dispatch_window(self) -> _Window:
        return self._launch_window(self.scheduler.pick_steps())

    def _drain_windows(self) -> None:
        wins, self._deferred_windows = self._deferred_windows, []
        for w in wins:
            self._process_window(w)

    def _process_window(self, win: _Window) -> None:
        """Host fan-out of one window's [k, B] tokens, after its copy has
        landed (the one host sync per window)."""
        if win.ready is not None:
            win.ready.synchronize()
        window = win.toks.numpy()
        t_host0 = time.monotonic()
        self._inflight_steps -= win.k
        delivered = [0] * self.ecfg.max_batch
        for step in range(win.k):
            for slot in range(self.ecfg.max_batch):
                if not self._slot_live(win, slot):
                    continue
                req = self.slot_req[slot]
                if req.cancelled:
                    # client gone mid-stream: free the slot for live work
                    self._retire(slot)
                    continue
                if self._req_expired(req):
                    # deadline passed mid-generation: free the slot now
                    self._stats["deadline_expired"] += 1
                    req.error = f"{DEADLINE_ERROR}: budget exhausted mid-decode"
                    self._retire(slot)
                    continue
                delivered[slot] += 1
                self._deliver_token(slot, int(window[step, slot]))
        win.delivered = {slot: n for slot, n in enumerate(delivered) if n}
        self._obs_window(win, t_host0)

    def _slot_live(self, win: _Window, slot: int) -> bool:
        """A window's tokens belong to a slot only if the request that held
        it at dispatch still holds it."""
        return (bool(win.mask[slot]) and bool(self.active[slot])
                and self.slot_req[slot] is win.reqs[slot])

    def _deliver_token(self, slot: int, tok: int) -> None:
        req = self.slot_req[slot]
        req.generated.append(tok)
        self._host_len[slot] += 1
        self._stats["tokens_generated"] += 1
        if req.queue is not None:
            req.queue.put_nowait(tok)
        hit_eos = self.ecfg.eos_id >= 0 and tok == self.ecfg.eos_id
        out_of_room = self._host_len[slot] >= self.ecfg.max_seq_len - 1
        if len(req.generated) >= req.max_new_tokens or hit_eos or out_of_room:
            # the rest of the window's tokens for this slot are discarded
            self._retire(slot)


def _tensor_leaves(tree):
    """Every tensor in a tree of dicts and lists (a param tree, a cache)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensor_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensor_leaves(v)
