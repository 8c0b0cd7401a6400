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
fans out the previous one.

The paged pool is bf16, or int8 with f32 per-vector scales (``kv_quant``).
This port leaves out speculative decoding, the flight recorder, KV tiering,
kvwire, profiling and sharding (ROADMAP queue A).
"""

from __future__ import annotations

import asyncio
import logging
import time
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch

from ..models.transformer import DecoderConfig, init_kv_cache
from ..ops.quant import validate_quant_mode
from ..ops.sampling import sample_logits
from ..utils.platform import default_device
from .graphs import GraphFactory
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
    tokens only to the request that held the slot when it was dispatched."""
    k: int
    toks: torch.Tensor        # [k, B] on the host (filled by a copy in flight)
    ready: Any                # CUDA event recorded after the copy, or None
    mask: Any
    reqs: tuple


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
    deadline_mono: float = 0.0              # 0 = no deadline


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
        self.graphs = GraphFactory(cfg, engine_cfg, self._chunk, self.device)
        self.scheduler = WindowScheduler(self)
        # dense prefill buckets, clamped to the cache: a bucket wider than
        # max_seq_len would splice past the slot's lanes
        self._buckets = sorted({min(bk, s)
                                for bk in engine_cfg.prefill_buckets})
        self.cache_len = torch.zeros((b,), dtype=torch.int32,
                                     device=self.device)
        self.active = np.zeros((b,), dtype=bool)
        self.slot_req: list[Optional[_Request]] = [None] * b
        self.last_token = torch.zeros((b, 1), dtype=torch.int32,
                                      device=self.device)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(0)
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
        self._stats = {"tokens_generated": 0, "decode_steps": 0,
                       "admit_dispatches": 0,
                       "admit_interleaved_windows": 0,
                       "deadline_expired": 0}

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
        self.kv_cache["table"] = self.pool.push_table(slot)

    def _ensure_slot_blocks(self, slot: int, n_tokens: int) -> bool:
        if not self.pool.ensure_slot_blocks(slot, n_tokens):
            return False
        self._push_table(slot)
        return True

    def _active_device(self) -> torch.Tensor:
        return torch.from_numpy(self.active.copy()).to(self.device)

    # -- public API ----------------------------------------------------------

    async def start(self) -> None:
        if self._loop_task is None:
            self._loop_task = asyncio.create_task(self._serve_loop())

    async def stop(self) -> None:
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
        """Run every admission and decode-window path once with all lanes
        inactive (paged writes land in the trash block, no slot advances),
        so the first request pays no kernel build or library set-up."""
        timings: dict[str, float] = {}
        if self.paged:
            self._warmup_paged(timings)
        else:
            self._warmup_dense(timings)
        inactive = torch.zeros((self.ecfg.max_batch,), dtype=torch.bool,
                               device=self.device)
        for k in self.ecfg.decode_steps:
            t0 = time.perf_counter()
            self.last_token, self.kv_cache, self.cache_len, toks = \
                self.graphs.build_decode(k)(
                    self.params, self.kv_cache, self.last_token,
                    self.cache_len, inactive, self._gen)
            self._sync(toks)
            timings[f"decode_k{k}_s"] = time.perf_counter() - t0
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
            self.kv_cache["k"], self.kv_cache["v"] = \
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
        last, self._scratch = self.graphs.traced_chunk_step(
            self.params, self._scratch, toks[0], 0, 0)
        self.graphs.traced_splice(self._pool_dict(), self._scratch["k"],
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

    async def generate(self, prompt: list[int], max_new_tokens: int = 32,
                       request_id: str = "", stream: bool = False,
                       budget_s: Optional[float] = None):
        """Generate up to ``max_new_tokens`` ids after ``prompt``. With
        ``stream=True`` returns the request at once; its ``queue`` yields
        each id and then ``None``. ``budget_s`` is the remaining deadline:
        a request still queued past it is never prefilled, and one still
        decoding is retired at the next window boundary."""
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

    def stats(self) -> dict:
        out = dict(self._stats)
        out["active_streams"] = int(self.active.sum())
        out["queued"] = self._queue.qsize()
        out["engine_dead"] = self._dead_reason is not None
        out["token_pressure"] = float(
            self._host_len.sum()
            / (self.ecfg.max_batch * self.ecfg.max_seq_len))
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
        out["device_kind"] = (torch.cuda.get_device_name(self.device)
                              if self.device.type == "cuda" else "cpu")
        return out

    # -- admission -----------------------------------------------------------

    async def _admit(self, req: _Request, slot: int):
        """Prefill and splice one request into ``slot`` and sample its first
        token. Returns the first token as a device value; the serve loop
        reads all admissions' first tokens in one copy."""
        if self.paged:
            return await self._admit_paged(req, slot)
        return self._admit_dense(req, slot)

    def _admit_dense(self, req: _Request, slot: int):
        """Dense admission: pad the prompt to its bucket, prefill it in one
        call, copy its KV into the slot's lanes."""
        n = len(req.prompt)
        bucket = self._bucket_for(n)
        tokens = np.zeros((1, bucket), dtype=np.int32)
        tokens[0, :n] = req.prompt[:bucket]
        last, cache = self.graphs.prefill_fn(bucket)(
            self.params, torch.from_numpy(tokens).to(self.device), n)
        self.kv_cache["k"], self.kv_cache["v"] = self.graphs.dense_splice_fn(
            bucket)(self.kv_cache["k"], self.kv_cache["v"], cache["k"],
                    cache["v"], slot)
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
                last, scratch = self.graphs.traced_chunk_step(
                    self.params, scratch, toks_dev[k_chunk],
                    int(offsets[k_chunk]), int(last_idxs[k_chunk]))
                self.graphs.traced_splice(
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
        self._deferred_windows.append(self._launch_window(k))
        self._stats["admit_interleaved_windows"] += 1

    def _deliver_first(self, req: _Request, first: int) -> None:
        req.generated.append(first)
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
            # physical blocks back to the pool, reservation released
            self.kv_cache["table"] = self.pool.release_slot(slot)
        if req is not None:
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
            if self._req_expired(head):
                self._wait_room.pop(0)
                self._expire_unadmitted(head)
                continue
            if self._room_for(head):
                return self._wait_room.pop(0)
            return None                     # FIFO: don't starve the head
        while not self._queue.empty():
            req = self._queue.get_nowait()
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
            self._fail_all_requests(f"engine failure: {exc}")
            raise

    async def _serve_loop_inner(self) -> None:
        while True:
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
                req = await self._queue.get()       # idle: block for work
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

            self._deferred_windows.append(self._dispatch_window())
            # keep exactly one window in flight: the host fan-out of the
            # older one runs while the new one computes
            while len(self._deferred_windows) > 1:
                self._process_window(self._deferred_windows.pop(0))
            await asyncio.sleep(0)

    def _launch_window(self, k: int) -> _Window:
        """Grow every active slot's blocks for ``k`` more writes (paged),
        dispatch a k-step decode window and start the copy of its tokens to
        the host."""
        for slot in range(self.ecfg.max_batch):
            if self.paged and self.active[slot]:
                self._ensure_slot_blocks(
                    slot, min(int(self._host_len[slot]) + self._inflight_steps
                              + k + 1, self.ecfg.max_seq_len))
        self.last_token, self.kv_cache, self.cache_len, toks = \
            self.graphs.build_decode(k)(
                self.params, self.kv_cache, self.last_token, self.cache_len,
                self._active_device(), self._gen)
        self._stats["decode_steps"] += k
        self._inflight_steps += k
        if toks.is_cuda:
            host = torch.empty(toks.shape, dtype=toks.dtype, pin_memory=True)
            host.copy_(toks, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record()
        else:
            host, ready = toks, None
        return _Window(k=k, toks=host, ready=ready, mask=self.active.copy(),
                       reqs=tuple(self.slot_req))

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
        self._inflight_steps -= win.k
        for step in range(win.k):
            for slot in range(self.ecfg.max_batch):
                if not self._slot_live(win, slot):
                    continue
                req = self.slot_req[slot]
                if self._req_expired(req):
                    # deadline passed mid-generation: free the slot now
                    self._stats["deadline_expired"] += 1
                    req.error = f"{DEADLINE_ERROR}: budget exhausted mid-decode"
                    self._retire(slot)
                    continue
                self._deliver_token(slot, int(window[step, slot]))

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
