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

With ``spec_len > 0`` the engine decodes speculatively, as the reference
does: each slot drafts up to ``spec_len`` tokens by prompt lookup
(``spec.py``), and a verify window (``GraphFactory.verify_fn``, one CUDA
graph per draft length on the card) runs one forward over the last token
and the drafts for the whole batch and keeps the drafts the model agrees
with, plus the model's own next token. A per-slot acceptance EWMA, fed by
verify windows and by shadow drafts graded in classic windows, decides
between verify and classic windows (``schedule.py``).

The paged pool is bf16, or int8 with f32 per-vector scales (``kv_quant``).
Its KV can leave the card: a cached prefix, or an in-flight stream's,
exports to kvwire bytes and another replica adopts them into its pool
(``export_prefix_kv``, ``export_request_kv``, ``adopt_kv``); with a host
tier (``kv_host_pool_mb``) an unpinned prefix down-pages to host DRAM at a
window boundary under pool pressure and a host hit up-pages it back into
fresh blocks. Both write the pool in place.
The runner's surface is the reference's: ``generate(..., trace=)``,
``cancel_request``, ``active_stream_requests``, ``flight_records``,
``arm_profile`` (``torch.profiler``), ``blackbox``/``last_postmortem``, the
kvwire and tiering hooks, and the ``[surface.engine_stats]`` key set of
``stats()``. Given a tracer (``InferenceEngine(..., tracer=)``, the
reference's ``Tracer`` or anything with its methods), a request that
carries a remote trace context records the reference's spans:
``engine.request`` backdated to its enqueue, ``engine.queue_wait``,
``engine.prefill`` and one ``engine.decode_window`` for each window that
delivered it tokens; ``blackbox()`` ships the tracer's tail.

The serve loop times itself (``observability/spans.py``): its phases tile
its wall time on the host's clock, each decode or verify window and each
admission dispatch is a device unit between two timing events (a window's
end event is the one the loop waits on), and at the loop's own sync points
the device's idle gaps between units are put down to the phase that was
running (``span_totals``; one row per window in ``spans.rows``).

Compile-ahead, as the reference's: an engine built on an abstract param
tree (``abstract_params``: ``device="meta"`` leaves) gives every leaf
zero-filled storage on its device, ``precompile()`` builds and captures
every serving computation over it, and ``bind_params`` then copies the real
weights into that storage in place, so every captured window reads them.

Multi-GPU serving goes through a sharding policy
(``InferenceEngine(..., policy=)``, ``shard/policy.py``), as the
reference's engine: every device placement below routes through it. The
identity policy (the default) leaves this engine as it was; a
``MeshPolicy`` holds the weights as tp × fsdp rank shards and the KV state
as one head shard per rank, one process driving every rank. The host
logic (slots, the allocator, the prefix cache, admission, windows) does
not see the topology.
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

from ..models.transformer import DecoderConfig
from ..observability.metrics import Metrics
from ..observability.spans import SpanRecorder
from ..ops.quant import validate_quant_mode
from ..ops.sampling import sample_logits
from ..parallel.sharding import (RankParams, map_leaves, named_leaves,
                                 per_rank, ranks)
from ..utils.platform import (default_device, env_kv_host_pool_mb,
                              env_kv_tier_on, host_to_device)
from .flight import FlightRecorder
from .graphs import GraphFactory, window_state
from .kvpool import KvPool, PoolExhausted
from .paged_kv import PrefixCache, blocks_for
from .schedule import WindowScheduler
from .shard.policy import SingleDevicePolicy
from .spec import build_drafts, make_slot_state

Params = dict[str, Any]

# deadline-expiry error prefix: a wire contract with the runner and the
# gateway (``tpu9.serving.engine.DEADLINE_ERROR``)
DEADLINE_ERROR = "deadline_exceeded"

log = logging.getLogger("tpu9_torch.serving")


def abstract_params(tree: Any) -> Any:
    """A tree of tensors → the same tree of ``device="meta"`` tensors of the
    same shapes and dtypes (the reference's ``jax.ShapeDtypeStruct`` tree):
    all an engine needs to be built and precompiled before its weights
    exist (:meth:`InferenceEngine.bind_params`)."""
    return map_leaves(
        lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), tree)


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
    # host-DRAM second tier for the paged pool, in MB; 0 disables tiering.
    # TPU9_KV_HOST_POOL_MB overrides it at engine construction, and
    # TPU9_KV_TIER=0 forces tiering off regardless
    kv_host_pool_mb: int = 0
    # speculative decoding: at most this many prompt-lookup drafts per
    # verify window; 0 disables it
    spec_len: int = 0
    # the floor of the mean effective acceptance EWMA over active slots
    # (a slot with nothing to propose counts 0) under which classic
    # windows run instead of verify windows
    spec_min_accept: float = 0.35
    # below the floor, force one verify window every N classic windows;
    # 0 leaves recovery to the shadow drafts graded in classic windows
    spec_probe_every: int = 0


@dataclass
class _Window:
    """One dispatched decode or verify window whose host fan-out is
    deferred. ``mask``/``reqs`` snapshot the active set at dispatch: a
    window delivers tokens only to the request that held the slot when it
    was dispatched. The rest is what its flight record needs, all host
    state."""
    k: int                    # device steps (verify: 1 + spec_len)
    toks: torch.Tensor        # decode [k, B], verify the model's [B, k],
                              # on the host (filled by a copy in flight)
    ready: Any                # CUDA event recorded after the copy, or None
    mask: Any
    reqs: tuple
    kind: str = "decode"      # "decode" or "verify"
    n_acc: Any = None         # verify: accepted drafts [B] on the host
    spec_len: int = 0         # verify: drafts per slot
    n_real: Any = None        # verify: real (unpadded) drafts [B]
    spec_stats: tuple = ()    # verify: (proposed, accepted) at processing
    t_mono: float = 0.0       # dispatch stamp
    t_wall: float = 0.0       # its wall anchor (decode_window spans)
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
    # span is the engine.request span opened at admission under it
    trace: Optional[tuple] = None
    span: Any = None
    span_id: str = ""    # survives _obs_done so the window that retires a
    #                      request can still parent its decode_window span
    t_enqueue_mono: float = 0.0
    t_enqueue_wall: float = 0.0
    t_first_mono: float = 0.0               # first token delivered
    admit_cached: int = 0                   # prefix-cache tokens reused
    admit_chunks: int = 0                   # prefill chunks dispatched


class InferenceEngine:
    """Continuous-batching engine around a decoder model."""

    def __init__(self, params: Params, cfg: DecoderConfig,
                 engine_cfg: EngineConfig = EngineConfig(), device=None,
                 tracer=None, policy=None):
        if policy is None:
            policy = SingleDevicePolicy(device)
        elif device is not None \
                and default_device(device) != policy.device:
            raise ValueError(f"device {device} is not the policy's rank-0 "
                             f"device {policy.device}")
        self.policy = policy
        self.device = policy.device
        tp = policy.topology.tp
        if tp > 1 and cfg.n_kv_heads % tp:
            # the pool shards on the head axis: a tp that does not divide
            # the kv heads would need every kv head on several ranks
            raise ValueError(
                f"tp={tp} does not divide n_kv_heads={cfg.n_kv_heads}: the "
                f"paged KV pool shards on the kv head axis (plan the "
                f"topology with candidate_topologies)")
        if all(t.is_meta for t in _tensor_leaves(params)):
            # compile-ahead: zeros, not torch.empty, since the captures run
            # a forward over this storage, and garbage weights could write
            # NaN into the pool's trash block
            params = policy.materialize(policy.abstract(params, cfg))
        else:
            # raw weights route through the policy here, not only in
            # load_engine: a mesh engine never serves a tree it did not
            # place
            params = policy.place_params(params, cfg)
        policy.check_placed(params)
        self.tracer = tracer
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
            host_mb = env_kv_host_pool_mb(engine_cfg.kv_host_pool_mb)
            if not env_kv_tier_on() or engine_cfg.prefix_cache_blocks <= 0:
                host_mb = 0
            self.pool = KvPool(cfg, engine_cfg, self.device, self.kv_quant,
                               host_pool_mb=host_mb, policy=policy)
            self.kv_cache = self.pool.init_arrays()
            self.allocator = self.pool.allocator
            self.prefix_cache = self.pool.prefix_cache
            # batch-1 dense scratch the chunked prefill writes through
            # before its blocks are spliced into the pool
            self._scratch = policy.init_kv_cache(cfg, 1, s)
        else:
            self.pool = self.allocator = self.prefix_cache = None
            self.kv_cache = policy.init_kv_cache(cfg, b, s)
        # the decode window's device state: owned here at fixed addresses
        # (a captured window replays them) and only written in place
        window = window_state(params, self.kv_cache, engine_cfg, self.device)
        self.cache_len = window.cache_len
        self.last_token = window.last_token
        self._active_dev = window.active
        self._toks = window.toks
        self._gen = window.generator
        # speculative decoding: one verify bucket, the full draft length.
        # A shorter bucket streams the same weights for fewer tokens, so
        # adaptivity lives in the acceptance gate, not in the window size
        self._spec_lens: tuple = ((engine_cfg.spec_len,)
                                  if engine_cfg.spec_len > 0 else ())
        self._spec_slots: list = [None] * b      # per-slot SlotSpecState
        self._spec_disabled_windows = 0
        self._drafts = window.drafts
        self._spec_out = window.out
        self._n_acc = window.n_acc
        # the serve loop's phases and device units (span_totals); the
        # factory counts the admission dispatches there
        self.spans = SpanRecorder("serve", self.device)
        self.graphs = GraphFactory(cfg, engine_cfg, self._chunk, self.device,
                                   window=window, policy=policy,
                                   spans=self.spans)
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
        # host-tier up-pages in flight, by prefix key: a second admission
        # hitting the same host entry awaits the first up-page instead of
        # filling fresh blocks twice
        self._uppage_inflight: dict = {}
        self._stats = {"active_streams": 0, "queued": 0,
                       "tokens_generated": 0, "decode_steps": 0,
                       "admit_dispatches": 0,
                       "admit_interleaved_windows": 0,
                       "spec_windows": 0, "spec_proposed": 0,
                       "spec_accepted": 0, "deadline_expired": 0,
                       # kvwire block-ship accounting, flat so the runner's
                       # heartbeat forwards them unchanged
                       "kvwire_exports": 0, "kvwire_export_misses": 0,
                       "kvwire_blocks_exported": 0,
                       "kvwire_bytes_exported": 0,
                       "kvwire_blocks_imported": 0,
                       "kvwire_bytes_imported": 0,
                       "kvwire_import_hits": 0,
                       "kvwire_import_fallbacks": 0,
                       # kv tiering: paging and recompute accounting
                       "kvtier_downpages": 0, "kvtier_uppages": 0,
                       "kvtier_uppage_failures": 0,
                       "kvtier_peer_spills": 0}
        self._init_observability()

    def _init_observability(self) -> None:
        """The flight recorder, latency summaries, profiling hook, liveness
        watermark and HBM accounting, as the reference engine keeps them:
        host state only, read by ``stats()`` at heartbeat cadence."""
        self.flight = FlightRecorder()
        self.metrics = Metrics()
        # bring-up seconds, set by load_engine and the runner; stats()
        # forwards them flat
        self.bringup: dict = {}
        # per-group readiness of a streaming restore (note_group_bound);
        # total 0 = not a partial bring-up, reported fully ready
        self._scaleout_groups: dict = {"total": 0, "bound": []}
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
        # weight tree (KV bytes left out, as the reference does), divided
        # over the cards as the shards divide it
        n_chips = self.policy.topology.n_chips
        if isinstance(self.params, RankParams):
            wb = self.params.global_nbytes
            numel = self.params.global_numel
        else:
            weights = list(_tensor_leaves(self.params))
            wb = sum(t.numel() * t.element_size() for t in weights)
            numel = sum(t.numel() for t in weights)
        self._phys_bytes_per_token_per_chip = wb / n_chips \
            if n_chips > 1 else wb
        self._phys_flops_per_token_per_chip = 2.0 * numel / n_chips
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
        # the busiest device's share, from where the trees were placed:
        # each device's weight shards and the KV state of the ranks on it,
        # a tensor that several ranks share counted once
        held: dict = {}
        seen: set = set()
        rank_devs = [dev for dev, _ in self.policy.rank_specs(self.cfg)]
        kv_trees = [self.kv_cache] + ([self._scratch] if self.paged else [])
        placed = list(self.policy.placed_tensors(self.params))
        for tree in kv_trees:
            placed += [(t, dev) for dev, kv in zip(rank_devs, ranks(tree))
                       for t in _tensor_leaves(kv)]
        for t, dev in placed:
            if id(t) not in seen:
                seen.add(id(t))
                held[dev] = held.get(dev, 0) + t.numel() * t.element_size()
        self.hbm_predicted_gb_per_chip = round(max(held.values()) / 1e9, 3)
        self._hbm_limit_gb = self.policy.hbm_limit_gb_per_chip()
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
        return per_rank(lambda kv: {k: kv[k] for k in keys}, self.kv_cache)

    def _worst_case_tokens(self, req: _Request) -> int:
        # prompt + generation budget + in-flight overshoot slack, clamped
        # to the cache. With speculation up to two verify windows can be in
        # flight past the budget check (the overlap window and the one
        # being dispatched), so the slack covers 2 * (1 + spec_len)
        slack = max(self.ecfg.decode_steps) + 1
        if self._spec_lens:
            slack = max(slack, 2 * (self._spec_lens[-1] + 1) + 1)
        return min(len(req.prompt) + req.max_new_tokens + slack,
                   self.ecfg.max_seq_len)

    def _push_table(self, slot: int) -> None:
        self.pool.push_table(slot)           # one row, in place

    def _ensure_slot_blocks(self, slot: int, n_tokens: int) -> bool:
        if not self.pool.ensure_slot_blocks(slot, n_tokens):
            return False
        self._push_table(slot)
        return True

    def bench_reset_slots(self, ctx0: int, budget: int) -> None:
        """Raw-loop benchmarking support: give every slot physical blocks
        covering [0, ctx0 + budget] and a host length of ``ctx0``, so a
        paged decode window moves the HBM traffic it would in production
        (an all-trash table would read one block B times). Each table row
        is written in place, so a captured window reads the new rows. A
        dense engine is left as it is."""
        if not self.paged:
            return
        for slot in range(self.ecfg.max_batch):
            blocks = self.pool.slot_blocks[slot]
            if blocks:
                self.allocator.release(blocks)
                self.pool.slot_blocks[slot] = []
            self._ensure_slot_blocks(slot, ctx0 + budget + 1)
            self._host_len[slot] = ctx0

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

    def precompile(self) -> dict:
        """Build every serving computation and run each once with every
        lane inactive, then seal the factory: on the card each decode and
        verify window is captured here. ``self.params`` may still be the
        zero-filled storage of an abstract tree, so bring-up can run this
        on a thread while the weights load, and :meth:`bind_params` them
        after. Returns the seconds of each computation under the
        reference's ``compile_<key>_s`` names (``GraphFactory.precompile``)."""
        return self.graphs.precompile(
            self.params, self.kv_cache,
            self._pool_dict() if self.paged else {},
            self._scratch if self.paged else {},
            self.pool.mb if self.paged else 0,
            self._buckets, self._spec_lens)

    def bind_params(self, params: Params, part: Optional[str] = None) -> None:
        """Copy ``params`` into the engine's param storage in place: every
        path, shape and dtype must equal the storage's, or this raises
        naming the first that differs, before anything is written. No
        entry of ``self.params`` is rebound (every captured window reads
        their addresses), so each ``data_ptr`` is the same after as before.
        Returns once the copies have run. A mesh engine takes the full
        tree (or its rank shards) and copies each shard's slice into that
        shard's storage, paths named by rank (``0/layers/0/wq``). With
        ``part`` (``"embed"``, ``"final_norm"``, ``"lm_head"`` or
        ``"layers/<i>"``, as ``parallel.sharding.tree_parts`` names them)
        ``params`` is that one part of the full tree, and only its storage
        is checked and written: a load binds part by part as it draws,
        never holding the whole tree (``presets.load_engine``)."""
        have = dict(named_leaves(self.params))
        if part is not None:
            roots = self.policy.part_paths(part)
            have = {path: t for path, t in have.items()
                    if any(path == root or path.startswith(root + "/")
                           for root in roots)}
        got = self.policy.bind_leaves(params, self.cfg, part)
        for path, t in have.items():
            src = got.get(path)
            if src is None:
                raise ValueError(f"bind_params: param {path} is missing")
            if src.shape != t.shape or src.dtype != t.dtype:
                raise ValueError(
                    f"bind_params: param {path} is {src.dtype} "
                    f"{list(src.shape)}, the engine's {t.dtype} "
                    f"{list(t.shape)}")
        extra = [p for p in got if p not in have]
        if extra:
            raise ValueError(f"bind_params: param {extra[0]} is not one of "
                             f"the engine's")
        with torch.no_grad():
            for path, t in have.items():
                t.copy_(got[path])
        for dev in self.policy.distinct_devices():
            if dev.type == "cuda":
                torch.cuda.current_stream(dev).synchronize()

    def note_group_bound(self, group: str, total: int) -> None:
        """One weight group of a streaming restore has been bound: recorded
        so the pressure heartbeat reports per-group readiness
        (``scaleout_*``) and the router can admit matching requests before
        the last group lands."""
        sg = self._scaleout_groups
        sg["total"] = max(int(total), sg["total"])
        if group and group not in sg["bound"]:
            sg["bound"].append(group)

    def warmup(self) -> dict:
        """Build every computation the serve loop can reach and run each
        once with all lanes inactive (paged writes land in the trash block,
        no slot advances), then seal the factory: the first request pays no
        kernel build, library set-up or capture, and a later build counts
        as a post-warmup compile. On the card each decode window and each
        verify window is captured here (``graphs.capture_s`` has the
        seconds) and replayed once. After :meth:`precompile` it builds
        nothing: it replays what was built."""
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
        for s in self._spec_lens:
            # zero drafts, every lane inactive: no slot advances
            t0 = time.perf_counter()
            self._drafts.zero_()
            self.graphs.verify_fn(s)()
            self._sync(self._spec_out)
            timings[f"verify_s{s}_s"] = time.perf_counter() - t0
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
            self._sync(self.kv_cache["k"])
            timings[f"dsplice_{bucket}_s"] = time.perf_counter() - t0

    def _warmup_paged(self, timings: dict) -> None:
        """The paged admission paths over the zeroed admission buffers
        (every write on the trash block): chunk step, splice, prefix gather
        and the fused group; on the card each is captured here."""
        a = self.graphs.admit
        a.packed.zero_()
        t0 = time.perf_counter()
        last, self._scratch = self.graphs.chunk_fn()(
            self.params, a.toks[:1], a.offsets[:1], self._scratch,
            a.last_idx[:1])
        self.graphs.splice_fn()(self._pool_dict(), self._scratch["k"],
                                self._scratch["v"], a.offsets[:1], a.phys[0])
        self.graphs.gather_fn()(self._pool_dict(), a.row, self._scratch)
        self._sync(last)
        timings[f"chunk_{self._chunk}_s"] = time.perf_counter() - t0
        g = max(1, self.ecfg.admit_group_chunks)
        if g > 1:
            t0 = time.perf_counter()
            _, self._scratch, last = self.graphs.chunk_group_fn(g)(
                self.params, self._pool_dict(), self._scratch, a.toks[:g],
                a.offsets[:g], a.last_idx[:g], a.phys[:g])
            self._sync(last)
            timings[f"chunk_group_{g}_s"] = time.perf_counter() - t0

    @staticmethod
    def _sync(t: torch.Tensor) -> None:
        for part in ranks(t):
            part.reshape(-1)[:1].cpu()

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
        context ``(trace_id, parent_span_id)``: with a tracer the request's
        spans are recorded under it (the module docstring names them), and
        the runner's drain reads it.
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
                       t_enqueue_mono=now, t_enqueue_wall=time.time(),
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

    # -- kvwire export / adopt ----------------------------------------------
    # Synchronous: these run on the event loop between awaits, so slot,
    # allocator and prefix-cache state cannot shift underneath them. An
    # export waits for its gather, which is queued behind the windows in
    # flight; an adopt queues its copy and returns.

    def export_prefix_kv(self, tokens: list[int]) -> Optional[bytes]:
        """Serialize the longest prefix-cached block run covering
        ``tokens`` into a kvwire payload (None = nothing cached). The entry
        stays PINNED across the gather, so an eviction cannot recycle a
        block under it."""
        if not self.paged or self.ecfg.prefix_cache_blocks <= 0:
            return None
        entry = self.prefix_cache.acquire_for_export(list(tokens))
        if entry is None:
            self._stats["kvwire_export_misses"] += 1
            return None
        t0 = time.perf_counter()
        try:
            payload = self.pool.export_blocks(
                self.kv_cache, entry.blocks, entry.key, entry.n_tokens)
        finally:
            self.prefix_cache.release_pin(entry)
        self.metrics.observe("tpu9_kvwire_export_s",
                             time.perf_counter() - t0)
        self._stats["kvwire_exports"] += 1
        self._stats["kvwire_blocks_exported"] += len(entry.blocks)
        self._stats["kvwire_bytes_exported"] += len(payload)
        return payload

    def export_request_kv(self, request_id: str) -> Optional[bytes]:
        """Serialize an in-flight request's full-block KV prefix (prompt +
        generated so far): the drain-migration export. The slot's own block
        refs keep the blocks alive; the window in flight only writes
        positions past the delivered sequence, in blocks past the shipped
        run. None = request not active or under one full block."""
        if not self.paged:
            return None
        for slot in range(self.ecfg.max_batch):
            req = self.slot_req[slot]
            if req is None or not self.active[slot] \
                    or req.request_id != request_id:
                continue
            seq = req.prompt + req.generated
            bs = self.ecfg.kv_block_size
            nb = min(len(seq) // bs, len(self.pool.slot_blocks[slot]))
            if nb <= 0:
                return None
            t0 = time.perf_counter()
            payload = self.pool.export_blocks(
                self.kv_cache, self.pool.slot_blocks[slot][:nb],
                PrefixCache._key(seq[:nb * bs]), nb * bs)
            self.metrics.observe("tpu9_kvwire_export_s",
                                 time.perf_counter() - t0)
            self._stats["kvwire_exports"] += 1
            self._stats["kvwire_blocks_exported"] += nb
            self._stats["kvwire_bytes_exported"] += len(payload)
            return payload
        return None

    def adopt_kv(self, payload: bytes) -> bool:
        """Write a kvwire payload into fresh pool blocks (in place) and
        adopt the prefix into the cache, so the next ``generate`` over
        those tokens admits through the ordinary prefix-reuse path. False =
        could not adopt (no free block, or the prefix budget): the caller
        falls back to plain re-prefill. A malformed payload raises
        :class:`~tpu9_torch.serving.kvwire.KvWireError` before any pool
        mutation."""
        if not self.paged or self.ecfg.prefix_cache_blocks <= 0:
            self._stats["kvwire_import_fallbacks"] += 1
            return False
        t0 = time.perf_counter()
        try:
            adopted, header = self.pool.import_blocks(self.kv_cache, payload)
        except PoolExhausted:
            # no room: re-prefill serves the request from scratch
            self._stats["kvwire_import_fallbacks"] += 1
            return False
        if not adopted:
            self._stats["kvwire_import_fallbacks"] += 1
            return False
        self.metrics.observe("tpu9_kvwire_import_s",
                             time.perf_counter() - t0)
        self._stats["kvwire_import_hits"] += 1
        self._stats["kvwire_blocks_imported"] += int(
            header.get("n_blocks", 0))
        self._stats["kvwire_bytes_imported"] += len(payload)
        return True

    def note_kvwire_ship(self, seconds: float) -> None:
        """Transport-side ship latency (cache put/get round trip), fed by
        the runner: the engine never touches the transport."""
        self.metrics.observe("tpu9_kvwire_ship_s", seconds)

    def note_kvwire_fallback(self) -> None:
        """A ship that never reached import (fetch failed, no transport):
        counted so hit against fallback covers the whole path."""
        self._stats["kvwire_import_fallbacks"] += 1

    def flight_records(self, limit: int = 256,
                       since_seq: int = 0) -> list[dict]:
        """Flight-recorder tail (newest last)."""
        return self.flight.snapshot(limit=limit, since_seq=since_seq)

    def blackbox(self, reason: str, exception: str = "") -> dict:
        """Raw forensic material for a post-mortem record: scalar stats,
        scheduler and KV-pool state, HBM, and the flight-recorder tail.
        Plain host reads only, safe next to a wedged or dead serve loop.
        ``spans`` is the tracer's tail (``[]`` without a tracer)."""
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
            "spans": (self.tracer.export(limit=128)
                      if self.tracer is not None else []),
        }

    def stats(self) -> dict:
        """The ``[surface.engine_stats]`` keys of the reference engine
        (``tpu9/analysis/contracts.toml``), with the ``kvwire_`` family and,
        when a host tier exists, the ``kvtier_`` family. Host state only:
        a device read here would stall the runner's event loop behind the
        window in flight."""
        out = dict(self._stats)
        if not self.paged or not self.pool.tiered:
            # no kvtier_ family without a host tier, as the reference
            for k in [k for k in out if k.startswith("kvtier_")]:
                del out[k]
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
        topo = self.policy.describe()
        out["topo_tp"] = topo["tp"]
        out["topo_fsdp"] = topo["fsdp"]
        out["topo_n_chips"] = topo["n_chips"]
        out["hbm_used_gb_per_chip"] = self.policy.hbm_used_gb_per_chip()
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
        # speculation: proposed and accepted are cumulative; the rate is
        # the fleet-comparable signal the runner forwards
        out["spec_enabled"] = bool(self._spec_lens)
        prop = self._stats["spec_proposed"]
        out["spec_acceptance_rate"] = (
            self._stats["spec_accepted"] / prop if prop else 0.0)
        out["flight"] = self.flight.summary()
        out["profile"] = {"armed": self._profile_remaining,
                          "active": self._profile_active,
                          "path": self._profile_path,
                          "error": self._profile_error}
        for k, v in self.bringup.items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                out[f"coldstart_{k}"] = v
        # per-group readiness, flat like coldstart_*; no partial bring-up
        # in flight (total 0) reports fully ready
        sg = self._scaleout_groups
        out["scaleout_groups_total"] = sg["total"]
        out["scaleout_groups_ready"] = len(sg["bound"])
        out["scaleout_ready_frac"] = round(
            len(sg["bound"]) / sg["total"], 4) if sg["total"] else 1.0
        out["scaleout_ready_groups"] = ",".join(sg["bound"])
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
        # kvwire latency percentiles, flat under the counters' prefix:
        # export/import are the engine's gather and write, ship the
        # transport round trip the runner reports
        for op in ("export", "import", "ship"):
            snap = summaries.get(f"tpu9_kvwire_{op}_s")
            if snap:
                out[f"kvwire_{op}_p50_s"] = round(snap["p50"], 6)
                out[f"kvwire_{op}_p95_s"] = round(snap["p95"], 6)
        if self.paged and self.pool.tiered:
            ts = self.pool.tier_stats()
            for k in ("device_blocks", "device_bytes", "host_blocks",
                      "host_bytes", "host_entries", "host_evictions"):
                out[f"kvtier_{k}"] = ts[k]
            out["kvtier_peer_spills"] = self.pool.peer_spills
            out["kvtier_hits_device"] = self.prefix_cache.hits_device
            out["kvtier_hits_host"] = self.prefix_cache.hits_host
            for op in ("downpage", "uppage"):
                snap = summaries.get(f"tpu9_kvtier_{op}_s")
                if snap:
                    out[f"kvtier_{op}_p50_s"] = round(snap["p50"], 6)
                    out[f"kvtier_{op}_p95_s"] = round(snap["p95"], 6)
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

    def span_totals(self) -> dict:
        """The serve loop's seconds since the engine was built, kept apart
        from ``stats()`` (whose key set is the reference's): host self time
        by phase (``serve.admit``, ``serve.first_token``,
        ``serve.window_wait``, ``serve.fanout``, ``serve.dispatch``,
        ``serve.yield``, ``serve.park``), device time by unit (``window``,
        ``admit``), the device's idle gaps by the phase that left the
        card waiting (or ``unattributed``), and the admission dispatches
        counted by kind as replayed graphs or eager runs (``counts``:
        ``chunk.replayed``, ``splice.eager``, ...). The device figures are
        empty without a CUDA device."""
        return self.spans.totals()

    # -- the pressure heartbeat's tiering hooks ------------------------------
    # Event-loop synchronous like the kvwire methods: pure host state.

    def kvtier_digest(self, top_k: int = 48) -> str:
        """Bounded top-K prefix-key summary for the directory heartbeat:
        ``hex16:tier:n_tokens`` comma-joined (tier ``d`` or ``h``), MRU
        first."""
        if self.prefix_cache is None:
            return ""
        ents = sorted(self.prefix_cache._entries.values(),
                      key=lambda e: -e.last_used)[:top_k]
        return ",".join(
            f"{e.key.hex()[:16]}:{'h' if e.tier == 'host' else 'd'}"
            f":{e.n_tokens}" for e in ents)

    def kvtier_deltas(self, since: int) -> tuple:
        """Tier-change journal after cursor ``since`` (evictions, spills
        and peer hand-offs the directory must apply) and the new cursor."""
        if self.prefix_cache is None:
            return [], 0
        return self.prefix_cache.deltas_since(since)

    def drain_kv_spills(self) -> list:
        """Queued peer-cache spill payloads ``(key_hex16, payload,
        n_tokens)``: the runner owns the transport. Destructive read."""
        if self.pool is None:
            return []
        return self.pool.drain_peer_spills()

    def drain_kvtier_decisions(self) -> list:
        """Journaled ``kv_tier`` decisions (spill, pull, recompute and
        evict choices made in the serving plane) for the runner's decision
        ledger. Destructive read."""
        if self.pool is None or not self.pool.kv_decisions:
            return []
        out = list(self.pool.kv_decisions)
        self.pool.kv_decisions.clear()
        return out

    # -- observability hooks -------------------------------------------------
    # Host bookkeeping on state the loop already holds: latency observes
    # per request and per window, never per token, flight records, and,
    # for a request carrying a remote trace context, spans in the tracer.

    def _obs_admit_start(self, req: _Request, t0_mono: float) -> None:
        self.metrics.observe("tpu9_engine_queue_wait_s",
                             max(t0_mono - req.t_enqueue_mono, 0.0))
        if req.trace is None or self.tracer is None:
            return
        trace_id, parent = req.trace
        req.span = self.tracer.start_span(
            "engine.request", trace_id=trace_id, parent_id=parent,
            attrs={"request_id": req.request_id,
                   "prompt_tokens": len(req.prompt),
                   "max_new_tokens": req.max_new_tokens,
                   # which submesh served this request, as the
                   # reference's
                   "tp": self.policy.topology.tp,
                   "n_chips": self.policy.topology.n_chips})
        req.span_id = req.span.span_id
        # backdated to the enqueue: the request span covers queue wait,
        # prefill and every decode window
        req.span.start, req.span.start_mono = (req.t_enqueue_wall,
                                               req.t_enqueue_mono)
        self.tracer.record_span(
            "engine.queue_wait", trace_id, req.span_id,
            req.t_enqueue_wall, req.t_enqueue_mono,
            attrs={"request_id": req.request_id}, end_mono=t0_mono)

    def _obs_admit_end(self, req: _Request, t0_mono: float, t0_wall: float,
                       il0: int, t1_mono: float) -> None:
        dur = max(t1_mono - t0_mono, 0.0)
        self._last_progress_mono = t1_mono            # admission = progress
        self.metrics.observe("tpu9_engine_prefill_s", dur)
        interleaved = self._stats["admit_interleaved_windows"] - il0
        if req.span is not None:
            self.tracer.record_span(
                "engine.prefill", req.trace[0], req.span_id, t0_wall,
                t0_mono,
                attrs={"request_id": req.request_id,
                       "prompt_tokens": len(req.prompt),
                       "cached_tokens": req.admit_cached,
                       "chunks": req.admit_chunks,
                       "interleaved_windows": interleaved})
        self.flight.record(
            "admit", request_id=req.request_id, slot=req.slot,
            prompt_tokens=len(req.prompt), cached_tokens=req.admit_cached,
            chunks=req.admit_chunks, interleaved=interleaved,
            dur_s=round(dur, 6))

    def _obs_stamp_window(self, win: _Window) -> _Window:
        win.t_mono = time.monotonic()
        win.t_wall = time.time()
        self._last_dispatch_mono = win.t_mono
        win.pick = self._pick_reason
        if self.paged:
            win.kv_snap = (self.allocator.used_count,
                           self.allocator.free_count,
                           self.allocator.reserved)
        return win

    def _obs_window(self, win: _Window, t_host0: float, now_m: float) -> None:
        """One flight record at host processing. ``wait_s`` (dispatch →
        fan-out start) includes the deliberate one-window overlap;
        ``host_s`` is the fan-out, to ``now_m``."""
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
        topo = self.policy.topology
        if topo.n_chips > 1:
            # the submesh on multi-rank records only: a 1x1 record stays
            # the single-card engine's, as in the reference
            rec.update(tp=topo.tp, n_chips=topo.n_chips)
        if win.kind == "verify":
            prop, acc = win.spec_stats or (0, 0)
            rec.update(spec_proposed=prop, spec_accepted=acc,
                       spec_rollback=prop - acc, spec_len=win.spec_len)
        if win.kv_snap:
            used, free, reserved = win.kv_snap
            rec.update(kv_used=used, kv_free=free, kv_reserved=reserved,
                       kv_alloc=self.pool.kv_allocs - self._flight_kv_allocs)
            self._flight_kv_allocs = self.pool.kv_allocs
            ev = self.prefix_cache.evictions
            rec.update(prefix_evictions=ev - self._flight_evictions,
                       prefix_pinned=self.prefix_cache.pinned)
            self._flight_evictions = ev
        self.flight.record(win.kind, **rec)
        for slot, n_tok in rec["tokens"].items():
            req = win.reqs[slot]
            if n_tok > 0 and req is not None and req.span_id:
                self.tracer.record_span(
                    "engine.decode_window", req.trace[0], req.span_id,
                    win.t_wall, win.t_mono,
                    attrs={"kind": win.kind, "k": win.k, "tokens": n_tok,
                           "pick": win.pick})

    def _obs_first_token(self, req: _Request) -> None:
        req.t_first_mono = time.monotonic()
        self.metrics.observe(
            "tpu9_engine_ttft_s",
            max(req.t_first_mono - req.t_enqueue_mono, 0.0))

    def _obs_done(self, req: _Request) -> None:
        """Idempotent: reachable from both _retire and _finish; only the
        first call observes and finishes the request's span."""
        now = time.monotonic()
        n = len(req.generated)
        if req.t_enqueue_mono:
            self.metrics.observe("tpu9_engine_e2e_s",
                                 max(now - req.t_enqueue_mono, 0.0))
            if req.t_first_mono and n > 1:
                self.metrics.observe(
                    "tpu9_engine_tbt_s",
                    max(now - req.t_first_mono, 0.0) / (n - 1))
            req.t_enqueue_mono = 0.0
        if req.span is not None:
            sp, req.span = req.span, None     # exactly one finish a span
            sp.attrs["tokens_generated"] = n
            self.tracer.finish_span(sp, status="error" if req.error else "ok")

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
        reads all admissions' first tokens in one copy. Its times are the
        ``serve.admit`` phase's boundaries."""
        t0_mono, t0_wall = self.spans.switch("serve.admit") / 1e9, time.time()
        self._obs_admit_start(req, t0_mono)
        il0 = self._stats["admit_interleaved_windows"]
        if self.paged:
            first = await self._admit_paged(req, slot)
        else:
            first = self._admit_dense(req, slot)
        self._obs_admit_end(req, t0_mono, t0_wall, il0,
                            self.spans.switch("serve.admit") / 1e9)
        return first

    def _admit_dense(self, req: _Request, slot: int):
        """Dense admission: pad the prompt to its bucket, prefill it in one
        call, copy its KV into the slot's lanes."""
        n = len(req.prompt)
        bucket = self._bucket_for(n)
        tokens = np.zeros((1, bucket), dtype=np.int32)
        tokens[0, :n] = req.prompt[:bucket]
        unit = self.spans.unit_start("admit")
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
        self.spans.unit_end(unit)
        self._occupy_slot(req, slot)
        return first

    def _occupy_slot(self, req: _Request, slot: int) -> None:
        req.slot = slot
        self.active[slot] = True
        self.slot_req[slot] = req
        if self._spec_lens:
            self._spec_slots[slot] = make_slot_state(req.prompt)

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
        if entry is not None and entry.tier == "host":
            # host-tier hit: write the planes back into fresh blocks before
            # they can be shared; a lost host copy degrades to a plain miss
            entry = await self._uppage_entry(entry, req.request_id)
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
        # the device table row stays all-trash until admission completes:
        # decode windows interleaved below write every inactive lane at
        # position 0 through its row, which must not be a block in use
        # here. The prefix gather reads the row from the admission buffers.

        sp = self.spans
        scratch = self._scratch
        a = self.graphs.admit
        unit = sp.unit_start("admit")
        # one copy of the row and every chunk's inputs; the graphs read them
        # on the device
        n_chunks = a.stage(blocks, req.prompt[p:], p)
        req.admit_cached = p
        req.admit_chunks = n_chunks
        if p:
            scratch = self.graphs.gather_fn()(self._pool_dict(), a.row,
                                              scratch)
            self._stats["admit_dispatches"] += 1

        last = None
        group = max(1, self.ecfg.admit_group_chunks)
        k_chunk = 0
        while k_chunk < n_chunks:
            # full groups take the fused path; a partial tail runs chunk by
            # chunk, as the JAX engine does to keep its graph set closed
            g = group if n_chunks - k_chunk >= group else 1
            a.take(k_chunk, g)
            if g > 1:
                _, scratch, last = self.graphs.chunk_group_fn(g)(
                    self.params, self._pool_dict(), scratch, a.toks[:g],
                    a.offsets[:g], a.last_idx[:g], a.phys[:g])
                self._stats["admit_dispatches"] += 1
            else:
                last, scratch = self.graphs.chunk_fn()(
                    self.params, a.toks[:1], a.offsets[:1], scratch,
                    a.last_idx[:1])
                self.graphs.splice_fn()(
                    self._pool_dict(), scratch["k"], scratch["v"],
                    a.offsets[:1], a.phys[0])
                self._stats["admit_dispatches"] += 2
            sp.unit_end(unit)
            k_chunk += g
            if k_chunk < n_chunks:
                # long admission: keep the decode batch producing tokens
                self._interleave_decode_window()
                sp.enter("serve.yield")
                await asyncio.sleep(0)
                sp.exit()
                unit = sp.unit_start("admit")
        self._scratch = scratch

        if self.ecfg.prefix_cache_blocks > 0:
            self.prefix_cache.insert(req.prompt, blocks)

        unit = sp.unit_start("admit")
        self._push_table(slot)            # the real row becomes visible now
        self.cache_len[slot] = n
        self._host_len[slot] = n
        first = sample_logits(last, self._gen,
                              temperature=self.ecfg.temperature,
                              top_k=self.ecfg.top_k, top_p=self.ecfg.top_p)
        self.last_token[slot, 0] = first
        sp.unit_end(unit)
        self._occupy_slot(req, slot)
        return first

    # -- KV tiering: up-page / down-page -------------------------------------

    async def _uppage_entry(self, entry, request_id: str = ""):
        """Write a host-tier prefix hit back into fresh pool blocks. The
        entry arrives PINNED from ``lookup`` and stays pinned for the whole
        up-page, so neither eviction nor a host reap can destroy it
        mid-copy. Returns the entry, device-resident and still pinned, or
        None (pin released) when the host copy is gone or the pool has no
        free block: the caller recomputes, never errors. A second admission
        hitting the same entry awaits the first up-page."""
        cache = self.prefix_cache
        key = entry.key
        fut = self._uppage_inflight.get(key)
        if fut is not None:
            cache.release_pin(entry)
            with self.spans.phase("serve.yield"):
                await fut
            ent = cache._entries.get(key)
            if ent is None or ent.tier != "device":
                return None                 # the first up-page failed
            ent.pins += 1                   # pin again for this admission
            cache.pinned += 1
            return ent
        fut = asyncio.get_running_loop().create_future()
        self._uppage_inflight[key] = fut
        t0 = time.perf_counter()
        try:
            planes = self.pool.uppage_planes(entry)
            if planes is None:
                # the host copy vanished between advertisement and use
                self._note_recompute(entry, request_id, "host_copy_lost")
                cache.release_pin(entry)
                if entry.pins == 0:
                    cache.drop(key, kind="evict")
                return None
            unit = self.spans.unit_start("admit")
            try:
                self.pool.complete_uppage(self._pool_dict(), entry, planes)
            except PoolExhausted:
                # the prefix stays on the host tier for a calmer window;
                # this admission recomputes
                self._note_recompute(entry, request_id, "pool_exhausted")
                cache.release_pin(entry)
                return None
            finally:
                self.spans.unit_end(unit)
            # the copy is queued, not waited for: the admission's own work
            # is queued behind it on the same stream
            with self.spans.phase("serve.yield"):
                await asyncio.sleep(0)
            dt = time.perf_counter() - t0
            self._stats["kvtier_uppages"] += 1
            self.metrics.observe("tpu9_kvtier_uppage_s", dt)
            self.pool.kv_decisions.append(
                {"decision": "pull", "request_id": request_id,
                 "chosen": f"host:{key.hex()[:16]}",
                 "signals": {"n_tokens": entry.n_tokens,
                             "uppage_s": round(dt, 6)}})
            return entry
        except BaseException:
            cache.release_pin(entry)
            raise
        finally:
            self._uppage_inflight.pop(key, None)
            if not fut.done():
                fut.set_result(True)

    def _note_recompute(self, entry, request_id: str, reason: str) -> None:
        self._stats["kvtier_uppage_failures"] += 1
        self.pool.kv_decisions.append(
            {"decision": "recompute", "request_id": request_id,
             "chosen": "recompute",
             "rejected": [{"alternative": f"host:{entry.key.hex()[:16]}",
                           "reason": reason}],
             "signals": {"n_tokens": entry.n_tokens}})

    def _kvtier_tick(self) -> None:
        """Window-boundary down-paging: when the scheduler's low-water
        check fires, LRU unpinned prefix entries spill to host DRAM before
        allocation pressure lets ``_evict_one`` destroy them. The gathers
        are queued behind the window in flight; nothing waits for them."""
        quota = self.scheduler.downpage_quota()
        if not quota:
            return
        for entry in self.prefix_cache.spill_candidates(quota):
            key_hex = entry.key.hex()[:16]
            n_tok = entry.n_tokens
            t0 = time.perf_counter()
            if not self.pool.downpage(self._pool_dict(), entry):
                continue
            dt = time.perf_counter() - t0
            self._stats["kvtier_downpages"] += 1
            self.metrics.observe("tpu9_kvtier_downpage_s", dt)
            self.pool.kv_decisions.append(
                {"decision": "spill", "chosen": f"host:{key_hex}",
                 "signals": {"n_tokens": n_tok,
                             "free_blocks": self.allocator.free_count,
                             "downpage_s": round(dt, 6)}})

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
        st = self._spec_slots[req.slot]
        if st is not None:
            st.proposer.append(first)
        if req.queue is not None:
            req.queue.put_nowait(first)
        if (req.max_new_tokens <= 1
                or (self.ecfg.eos_id >= 0 and first == self.ecfg.eos_id)):
            self._retire(req.slot)

    def _retire(self, slot: int) -> None:
        req = self.slot_req[slot]
        self.active[slot] = False
        self.slot_req[slot] = None
        self._spec_slots[slot] = None
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
        # the loop is always in one phase of its span recorder, so the
        # phases tile its wall time (span_totals)
        sp = self.spans
        sp.enter("serve.dispatch")
        try:
            while True:
                await self._serve_turn(sp)
        finally:
            sp.close_phases()

    async def _serve_turn(self, sp: SpanRecorder) -> None:
        """One turn of the serve loop: admissions, then one window."""
        # an armed profile stops once its windows are processed
        sp.switch("serve.dispatch")
        self._profile_maybe_stop()
        # an imminent admission first drains the in-flight window: its
        # steps occupy the slack interleaved windows need, and its
        # retirements may free the slot being admitted into
        if self._deferred_windows and self.scheduler.admission_can_proceed():
            self._drain_windows()
        sp.switch("serve.admit")
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
                return
            if self._deferred_windows:
                self._drain_windows()
            # parked idle time must not leak into an armed trace
            sp.switch("serve.dispatch")
            self._profile_maybe_stop(idle=True)
            sp.switch("serve.park")
            req = await self._queue.get()       # idle: block for work
            sp.switch("serve.admit")
            if req.cancelled:
                self._finish(req)
                return
            if self._req_expired(req):
                self._expire_unadmitted(req)
                return
            if not self._room_for(req):
                self._wait_room.append(req)
                return
            self._admitting = req
            pending.append((req, await self._admit(req, 0)))
            self._admitting = None

        if pending:
            # one copy for every admitted request's first token
            sp.switch("serve.first_token")
            unit = sp.unit_start("admit")
            firsts = torch.stack([f.reshape(()) for _, f in pending]).cpu()
            sp.unit_end(unit)
            sp.resolve()
            for (req, _), first in zip(pending, firsts.tolist()):
                self._deliver_first(req, int(first))
            # windows dispatched during those admissions are done by now
            self._drain_windows()

        if not self.active.any():
            if self._deferred_windows:
                self._drain_windows()
            return

        # window boundary: down-page LRU prefixes to host DRAM when the
        # pool nears eviction pressure (no-op without a host tier)
        sp.switch("serve.dispatch")
        if self.paged and self.pool.tiered:
            self._kvtier_tick()
        # one window for the whole batch: a verify window when the
        # acceptance EWMAs justify it, a classic k-step window otherwise
        self._profile_window_start()
        win = self._dispatch_window()
        if win is not None:
            self._profile_window_dispatched()
            self._deferred_windows.append(win)
        # keep exactly one window in flight: the host fan-out of the
        # older one runs while the new one computes
        while len(self._deferred_windows) > 1:
            self._process_window(self._deferred_windows.pop(0))
        sp.switch("serve.yield")
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
        unit = self.spans.unit_start("window")
        host_to_device(self._active_dev, self.active)
        self.graphs.decode_k(k)()
        self._stats["decode_steps"] += k
        self._inflight_steps += k
        (host,) = _to_host(self._toks[:k])
        ready = self.spans.unit_end(unit, row=(k, self._pick_reason))
        return self._obs_stamp_window(
            _Window(k=k, toks=host, ready=ready, mask=self.active.copy(),
                    reqs=tuple(self.slot_req)))

    def _dispatch_window(self) -> Optional[_Window]:
        s = self.scheduler.spec_room_len()
        if s > 0:
            s = self.scheduler.spec_gate(s)
        if s > 0:
            # drafts must continue the delivered history: drain the window
            # in flight first, so the proposers see what the device's last
            # tokens continue (a verify window pays this sync once for up
            # to 1 + s tokens a slot)
            self._drain_windows()
            if not self.active.any():
                return None
            drafts, n_real = build_drafts(self._spec_slots, self.active, s)
            if int(n_real.sum()) > 0:
                return self._dispatch_verify(s, drafts, n_real)
            # nothing to propose anywhere: a classic window
        return self._launch_window(self.scheduler.pick_steps())

    def _dispatch_verify(self, s: int, drafts: np.ndarray,
                         n_real: np.ndarray) -> _Window:
        """Grow every active slot's blocks for the window's ``1 + s``
        writes (paged), write the drafts into the device buffer, replay the
        verify window and start the copy of its tokens and accepted counts
        to the host."""
        t = s + 1
        for slot in range(self.ecfg.max_batch):
            if self.paged and self.active[slot]:
                self._ensure_slot_blocks(
                    slot, min(int(self._host_len[slot]) + t + 1,
                              self.ecfg.max_seq_len))
        unit = self.spans.unit_start("window")
        host_to_device(self._active_dev, self.active)
        host_to_device(self._drafts[:, :s], drafts)
        self.graphs.verify_fn(s)()
        self._stats["spec_windows"] += 1
        self._inflight_steps += t
        self._pick_reason = "spec"
        out, n_acc = _to_host(self._spec_out[:, :t], self._n_acc)
        ready = self.spans.unit_end(unit, row=(t, self._pick_reason))
        return self._obs_stamp_window(
            _Window(k=t, toks=out, ready=ready, mask=self.active.copy(),
                    reqs=tuple(self.slot_req), kind="verify", n_acc=n_acc,
                    spec_len=s, n_real=n_real))

    def _drain_windows(self) -> None:
        wins, self._deferred_windows = self._deferred_windows, []
        for w in wins:
            self._process_window(w)

    def _process_window(self, win: _Window) -> None:
        """Host fan-out of one window, after its copy has landed (the one
        host sync per window): a decode window's [k, B] tokens, or a verify
        window's model tokens [B, 1 + s] and accepted counts, 1 to 1 + s
        tokens a slot. The device units it has passed are resolved here."""
        sp = self.spans
        sp.enter("serve.window_wait")
        if win.ready is not None:
            win.ready.synchronize()
        window = win.toks.numpy()
        t_host0 = sp.switch("serve.fanout")
        sp.resolve()
        self._inflight_steps -= win.k
        if win.kind == "verify":
            self._process_verify(win, window, win.n_acc.numpy())
        else:
            self._process_decode(win, window)
        self._obs_window(win, t_host0 / 1e9, sp.switch("serve.fanout") / 1e9)
        sp.exit()

    def _retire_if_gone(self, slot: int) -> bool:
        """Retire a slot whose client went away (cancel) or whose deadline
        passed mid-generation; True if it did."""
        req = self.slot_req[slot]
        if req.cancelled:
            # client gone mid-stream: free the slot for live work
            self._retire(slot)
            return True
        if self._req_expired(req):
            # deadline passed mid-generation: free the slot now
            self._stats["deadline_expired"] += 1
            req.error = f"{DEADLINE_ERROR}: budget exhausted mid-decode"
            self._retire(slot)
            return True
        return False

    def _process_decode(self, win: _Window, window: np.ndarray) -> None:
        shadow: dict[int, list[int]] = {}
        if self._spec_lens:
            # shadow drafts: what prompt lookup would have proposed for
            # this window, graded against its real tokens below, a free
            # acceptance estimate that reopens the gate once a stream turns
            # repetitive. Proposed here, before any of the window's tokens
            # are appended, so the history is the pre-window state
            m = min(win.k, self._spec_lens[-1])
            for slot in range(self.ecfg.max_batch):
                st = self._spec_slots[slot]
                if st is not None and self._slot_live(win, slot):
                    shadow[slot] = st.proposer.propose(m)
        delivered: list[list[int]] = [[] for _ in range(self.ecfg.max_batch)]
        for step in range(win.k):
            for slot in range(self.ecfg.max_batch):
                if not self._slot_live(win, slot) or self._retire_if_gone(
                        slot):
                    continue
                tok = int(window[step, slot])
                delivered[slot].append(tok)
                self._deliver_token(slot, tok)
        for slot, sh in shadow.items():
            m = min(len(sh), len(delivered[slot]))
            if m == 0:
                continue
            acc = 0
            while acc < m and sh[acc] == delivered[slot][acc]:
                acc += 1
            st = self._spec_slots[slot]
            if st is not None:
                st.observe(m, acc)
        win.delivered = {slot: len(toks)
                         for slot, toks in enumerate(delivered) if toks}

    def _process_verify(self, win: _Window, out: np.ndarray,
                        n_acc: np.ndarray) -> None:
        """Deliver each live slot's accepted drafts and the model's token
        after them, stopping at EOS, budget or cache room. The EWMA and the
        counters see only the drafts a slot really proposed: padding (and a
        padded tail) accepted by chance is delivered, being the model's own
        output, but not counted."""
        win.delivered = {}
        win_proposed = win_accepted = 0
        for slot in range(self.ecfg.max_batch):
            if not self._slot_live(win, slot):
                continue
            acc = int(n_acc[slot])
            n_real = int(win.n_real[slot])
            if n_real > 0:
                win_proposed += n_real
                win_accepted += min(acc, n_real)
                st = self._spec_slots[slot]
                if st is not None:
                    st.observe(n_real, min(acc, n_real))
                    self._stats["spec_proposed"] += n_real
                    self._stats["spec_accepted"] += min(acc, n_real)
            if self._retire_if_gone(slot):
                continue
            req = self.slot_req[slot]
            n_delivered = 0
            for i in range(acc + 1):
                self._deliver_token(slot, int(out[slot, i]))
                n_delivered += 1
                if self.slot_req[slot] is not req:
                    break           # EOS, budget or room inside the run
            win.delivered[slot] = n_delivered
        win.spec_stats = (win_proposed, win_accepted)

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
        st = self._spec_slots[slot]
        if st is not None:
            st.proposer.append(tok)
        if req.queue is not None:
            req.queue.put_nowait(tok)
        hit_eos = self.ecfg.eos_id >= 0 and tok == self.ecfg.eos_id
        out_of_room = self._host_len[slot] >= self.ecfg.max_seq_len - 1
        if len(req.generated) >= req.max_new_tokens or hit_eos or out_of_room:
            # the rest of the window's tokens for this slot are discarded
            self._retire(slot)


def _to_host(*tensors: torch.Tensor) -> tuple:
    """Start copies of ``tensors`` to the host. On CUDA they go to pinned
    buffers, queued behind the window on the stream (the next window's
    writes to the device buffers come after them); the window unit's end
    event, recorded next, marks their landing. On the CPU they are
    clones."""
    if not tensors[0].is_cuda:
        return tuple(t.clone() for t in tensors)
    hosts = []
    for t in tensors:
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        hosts.append(host)
    return tuple(hosts)


def _tensor_leaves(tree):
    """Every tensor in a tree of dicts and lists (a param tree, a cache)."""
    for _, t in named_leaves(tree):
        yield t
