"""Paged KV-pool management (counterpart of ``tpu9/serving/kvpool.py``):
pool sizing (equal bytes for an int8 pool), the trash-block discipline,
slot → physical-block bookkeeping, worst-case reservations, the block
table, kvwire export/import and the host-DRAM second tier.

Every device tensor of the pool lives at one address for the engine's
life: a captured decode window reads the pool and the table there. So
nothing here rebinds a pool tensor. The table is written one row at a
time, and import and up-page write blocks in place (``index_copy_`` on
the block axis). Export and down-page gather blocks with ``index_select``
on the current stream, behind the windows already queued there (the
order XLA gives the reference), and copy them into host memory; every
later write to those blocks is queued behind that copy on the same
stream, so a block released right after a down-page is never overwritten
before it was read. On a CUDA engine the host copies are pinned, so an
up-page is one asynchronous host-to-device copy.

Under a sharding policy (``shard/policy.py``) each rank holds its head
shard of the pool, ``[L, N, BS, KH/tp, D]``, and a copy of the table on
its device; block ids are global, so everything else here is unchanged
host logic. Export and down-page gather the ranks' heads into canonical
full-head planes, and import and up-page place them back by head, so a
payload's geometry does not depend on the exporter's topology.
"""

from __future__ import annotations

import collections
import time
from typing import Any, Optional

import numpy as np
import torch

from ..parallel.sharding import Ranked, ranks, to_device
from ..utils.platform import host_to_device
from . import kvwire
from .paged_kv import BlockAllocator, PrefixCache, blocks_for, kv_block_bytes
from .shard.policy import SingleDevicePolicy

Params = dict[str, Any]

# host-tier spill scoring: a reaped host entry whose hits x recency score
# clears this goes to the peer cache instead of dying (system prompts and
# chat-session heads score high, one-shot prompts decay to zero)
PEER_SPILL_SCORE = 1.0
PEER_SPILL_HALF_LIFE_S = 300.0
PEER_SPILL_QUEUE_MAX = 8

class PoolExhausted(RuntimeError):
    """No free block even after evicting the prefix cache: an import or
    up-page under pressure, which falls back to recompute. Its own type,
    so a device error is never taken for it."""


class HostKvTier:
    """Host-DRAM second tier for the paged KV pool.

    Stores canonical pool planes per prefix key (the layout kvwire ships,
    as host tensors; pinned on a CUDA engine), so a down-page is one
    gather off the device, an up-page one scatter back, and a peer-cache
    spill a pure host ``kvwire.encode_blocks``. With ``kv_quant`` the
    planes are int8 (+ f32 scales). The byte budget counts plane bytes and
    is enforced on insert: LRU entries are reaped (the pool scores them
    for peer spill first); the ``skip`` predicate protects pinned ones.
    An entry's ``ready`` is the CUDA event after its device-to-host copy
    (None on the CPU): a host reader of its planes waits on it."""

    def __init__(self, capacity_bytes: int):
        self.capacity_bytes = int(capacity_bytes)
        # key -> {"planes", "n_tokens", "n_blocks", "nbytes", "ready"}
        self._entries: "collections.OrderedDict[bytes, dict]" = \
            collections.OrderedDict()
        self.used_bytes = 0
        self.inserts = 0
        self.evictions = 0
        self.rejected = 0

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: bytes) -> bool:
        return key in self._entries

    def get(self, key: bytes) -> Optional[dict]:
        ent = self._entries.get(key)
        if ent is not None:
            self._entries.move_to_end(key)
        return ent

    def peek(self, key: bytes) -> Optional[dict]:
        return self._entries.get(key)

    def pop(self, key: bytes) -> Optional[dict]:
        ent = self._entries.pop(key, None)
        if ent is not None:
            self.used_bytes -= ent["nbytes"]
        return ent

    def put(self, key: bytes, planes: dict, n_tokens: int,
            n_blocks: int, skip=None, ready=None) -> tuple[bool, list]:
        """Insert (or refresh) an entry, reaping LRU entries to fit.
        Returns ``(stored, reaped)``: ``reaped`` lists the ``(key, entry)``
        pairs evicted to make room. ``skip(key)`` excludes entries from
        reaping."""
        if key in self._entries:
            self.pop(key)
        nbytes = sum(int(p.nbytes) for p in planes.values())
        if nbytes > self.capacity_bytes:
            self.rejected += 1
            return False, []
        reaped: list = []
        while self.used_bytes + nbytes > self.capacity_bytes:
            victim = self._reap_one(skip)
            if victim is None:
                # it does not fit without touching skip-protected residents
                self.rejected += 1
                return False, reaped
            reaped.append(victim)
        self._entries[key] = {"planes": planes, "n_tokens": int(n_tokens),
                              "n_blocks": int(n_blocks), "nbytes": nbytes,
                              "ready": ready}
        self.used_bytes += nbytes
        self.inserts += 1
        return True, reaped

    def _reap_one(self, skip=None):
        for key in self._entries:           # OrderedDict: LRU first
            if skip is not None and skip(key):
                continue
            ent = self.pop(key)
            self.evictions += 1
            return key, ent
        return None

    def stats(self) -> dict:
        return {"entries": len(self._entries),
                "bytes": self.used_bytes,
                "capacity_bytes": self.capacity_bytes,
                "inserts": self.inserts, "evictions": self.evictions,
                "rejected": self.rejected}


def host_planes(ent: dict) -> dict:
    """A host-tier entry's planes, once its device-to-host copy landed."""
    if ent.get("ready") is not None:
        ent["ready"].synchronize()
    return ent["planes"]


class KvPool:
    """One engine's paged KV pool: the device tensors (built once by
    :meth:`init_arrays`), the block allocator and prefix cache, and the
    per-slot physical-block state the serve loop mutates. ``kv_quant``
    makes the pool int8 with f32 scale planes. ``policy`` places the
    device state (one head shard per rank under a ``MeshPolicy``); by
    default the identity policy on ``device``."""

    def __init__(self, cfg, ecfg, device, kv_quant: bool = False,
                 host_pool_mb: int = 0, policy=None):
        b, s = ecfg.max_batch, ecfg.max_seq_len
        bs = ecfg.kv_block_size
        self.cfg = cfg
        self.ecfg = ecfg
        self.device = device
        self.policy = policy or SingleDevicePolicy(device)
        self.kv_quant = kv_quant
        if ecfg.kv_pool_blocks:
            base_blocks = ecfg.kv_pool_blocks
        else:
            base_blocks = b * s // bs                       # dense parity
            if kv_quant:
                # equal-bytes sizing: the int8 pool spends what the bf16
                # pool would, so it holds ~2x the blocks (admission room)
                base_blocks = (base_blocks * kv_block_bytes(cfg, bs, False)
                               // kv_block_bytes(cfg, bs, True))
        # +1: one dedicated TRASH block absorbs the writes of inactive decode
        # lanes and of the padded tail of a non-block-aligned final chunk
        self.n_blocks = base_blocks + 1
        # table width: +1 ALWAYS-TRASH column, so a decode write at position
        # S (cache full) lands in trash instead of the last real block
        self.mb = s // bs + 1
        self.allocator = BlockAllocator(self.n_blocks, bs)
        self.trash_block = self.allocator.alloc(1)[0]
        # inactive lanes write through their table rows every step; a fresh
        # all-zero table relies on the trash block being physical block 0
        if self.trash_block != 0:
            raise AssertionError(f"trash block is {self.trash_block}, not 0")
        # the trash block is held forever: reservations must not count on it
        self.allocator.reserve_capacity = self.n_blocks - 1
        self.prefix_cache = PrefixCache(self.allocator,
                                        ecfg.prefix_cache_blocks)
        self.slot_blocks: list[list[int]] = [[] for _ in range(b)]
        self.slot_reserved = [0] * b
        self.table_np = np.zeros((b, self.mb), dtype=np.int32)
        self.table = torch.from_numpy(self.table_np.copy()).to(device)
        # the table replicated to each device the ranks live on
        self._tables = {torch.device(device): self.table}
        for dev in self.policy.distinct_devices():
            if dev not in self._tables:
                self._tables[dev] = torch.from_numpy(
                    self.table_np.copy()).to(dev)
        self.kv_allocs = 0           # lifetime block allocations
        # -- host-DRAM second tier; inert at 0 MB ----------------------------
        self.host_pool_mb = int(host_pool_mb)
        self.host_tier: Optional[HostKvTier] = None
        self.downpages = 0
        self.uppages = 0
        self.peer_spills = 0
        # (key_hex16, payload, n_tokens) encoded for the peer cache; the
        # runner drains this (the serving plane never touches transport)
        self.peer_spill_queue: collections.deque = \
            collections.deque(maxlen=PEER_SPILL_QUEUE_MAX)
        # kv_tier decision journal: plain dicts the runner drains into its
        # decision ledger on the heartbeat loop
        self.kv_decisions: collections.deque = collections.deque(maxlen=256)
        if self.host_pool_mb > 0:
            self.host_tier = HostKvTier(self.host_pool_mb * (1 << 20))
            # an entry prefilled again on the device drops its host copy
            self.prefix_cache.on_host_drop = self.host_tier.pop

    def init_arrays(self) -> Params:
        """The pool's device state: k/v [L, N, BS, KH, D] (int8 for an
        int8 pool, with f32 k_scale/v_scale [L, N, BS, KH] indexed like the
        payload) and the table; one such tree per rank, each of its heads,
        under a sharding policy."""
        return self.policy.join([self._rank_arrays(dev, rc) for dev, rc
                                 in self.policy.rank_specs(self.cfg)])

    def _rank_arrays(self, device, cfg) -> Params:
        ecfg = self.ecfg
        shape = (cfg.n_layers, self.n_blocks, ecfg.kv_block_size,
                 cfg.n_kv_heads, cfg.head_dim)
        dt = torch.int8 if self.kv_quant else cfg.dtype
        arrays = {name: torch.zeros(shape, dtype=dt, device=device)
                  for name in ("k", "v")}
        if self.kv_quant:
            for name in ("k_scale", "v_scale"):
                arrays[name] = torch.zeros(shape[:-1], dtype=torch.float32,
                                           device=device)
        arrays["table"] = self._tables[torch.device(device)]
        return arrays

    def plane_shape(self, name: str) -> tuple:
        """The canonical full-head shape of pool plane ``name``."""
        cfg = self.cfg
        shape = (cfg.n_layers, self.n_blocks, self.ecfg.kv_block_size,
                 cfg.n_kv_heads, cfg.head_dim)
        return shape[:-1] if name.endswith("_scale") else shape

    def alloc_blocks(self, n: int) -> list[int]:
        """Allocate physical blocks; evicts prefix-cache holdings if the
        free list runs short. Reservations make failure impossible."""
        if n <= 0:
            return []
        got = self.allocator.alloc(n)
        if got is None:
            self.prefix_cache.evict_for_space(n)
            got = self.allocator.alloc(n)
        if got is None:
            raise PoolExhausted(
                f"KV pool exhausted: need {n}, free "
                f"{self.allocator.free_count} (reservation bug)")
        self.kv_allocs += n
        return got

    # -- kvwire export / import ----------------------------------------------

    def wire_names(self) -> list[str]:
        """Pool tensors that ship on the wire, in the reference's order
        (payload, then int8 scale planes; the table is pool-local)."""
        return ["k", "v"] + (["k_scale", "v_scale"] if self.kv_quant else [])

    def _block_index(self, blocks: list[int]) -> torch.Tensor:
        idx = np.asarray(blocks, dtype=np.int64)
        if self.device.type == "cuda":
            dev = torch.empty(idx.shape, dtype=torch.int64,
                              device=self.device)
            host_to_device(dev, idx)
            return dev
        return torch.from_numpy(idx)

    def gather_blocks(self, kv, blocks: list[int]):
        """Queue a copy of ``blocks`` of every wire plane into host memory
        (pinned on CUDA) on the current stream, behind the work already
        queued there. Returns the canonical planes (the ranks' heads
        joined) and the CUDA event after the copy (None on the CPU, where
        the copy is done)."""
        idx = self._block_index(blocks)
        planes = {}
        for name in self.wire_names():
            got = self.policy.gather_heads(name, [
                part.index_select(1, to_device(idx, part.device))
                for part in ranks(kv[name])])
            if got.is_cuda:
                host = torch.empty(got.shape, dtype=got.dtype,
                                   pin_memory=True)
                host.copy_(got, non_blocking=True)
                got = host
            planes[name] = got
        ready = None
        if self.device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record()
        return planes, ready

    def _wire_meta(self, n_blocks: int, n_tokens: int,
                   prefix_key: bytes) -> dict:
        meta = kvwire.geometry(self.cfg, self.ecfg, self.kv_quant)
        meta.update({"n_blocks": int(n_blocks), "n_tokens": int(n_tokens),
                     "prefix_key": prefix_key.hex(),
                     "topology": self.policy.describe()})
        return meta

    def export_blocks(self, kv, blocks: list[int], prefix_key: bytes,
                      n_tokens: int) -> bytes:
        """Gather ``blocks`` of every wire plane into one kvwire payload.
        Waits for the gather, which runs after the windows in flight. The
        caller holds a pin on the blocks (prefix-cache export pin or a
        slot's own refs) for the duration."""
        planes, ready = self.gather_blocks(kv, blocks)
        if ready is not None:
            ready.synchronize()
        return kvwire.encode_blocks(
            self._wire_meta(len(blocks), n_tokens, prefix_key), planes)

    def import_blocks(self, kv, payload: bytes) -> tuple[bool, dict]:
        """Validate a kvwire payload, write it into fresh pool blocks in
        place and adopt them into the prefix cache under the exporter's
        key. Returns ``(adopted, header)``. Every validation runs before
        any allocation or write: a bad payload leaves the pool untouched.
        ``adopted=False`` means the entry could not fit the prefix budget
        (its blocks were released; the caller falls back to re-prefill).
        Raises :class:`PoolExhausted` when no block is free."""
        header, planes = kvwire.decode_blocks(
            payload, pin_memory=self.device.type == "cuda")
        kvwire.check_geometry(
            header, kvwire.geometry(self.cfg, self.ecfg, self.kv_quant))
        try:
            nb = int(header["n_blocks"])
            n_tokens = int(header["n_tokens"])
            key = bytes.fromhex(header["prefix_key"])
        except (KeyError, TypeError, ValueError) as exc:
            raise kvwire.KvWireError(
                f"kvwire: missing/malformed prefix metadata: {exc}") from exc
        if nb <= 0 or not key:
            raise kvwire.KvWireError(
                f"kvwire: empty prefix payload (n_blocks={nb})")
        for name in self.wire_names():
            if name not in planes:
                raise kvwire.KvWireError(
                    f"kvwire: payload missing plane {name!r}")
            pool_shape = (self.plane_shape(name) if isinstance(kv, Ranked)
                          else tuple(kv[name].shape))
            want = (pool_shape[0], nb) + pool_shape[2:]
            if tuple(planes[name].shape) != want:
                raise kvwire.KvWireError(
                    f"kvwire: plane {name!r} shape "
                    f"{tuple(planes[name].shape)} != pool slice {want}")
        if self.prefix_cache.contains(key):
            # this replica already holds the prefix (raced a local
            # prefill): the adopt is a no-op hit, zero pool work
            return True, header
        blocks = self.alloc_blocks(nb)
        try:
            self.place_host_blocks(kv, planes, blocks)
        except Exception:
            self.allocator.release(blocks)
            raise
        if not self.prefix_cache.adopt(key, blocks, n_tokens):
            self.allocator.release(blocks)
            return False, header
        return True, header

    def place_host_blocks(self, kv, planes: dict, blocks: list[int]) -> None:
        """Write canonical host planes into ``blocks`` of every wire plane,
        in place (one asynchronous copy from pinned memory per plane on
        CUDA, queued on the current stream), each rank its heads. Shared
        by the kvwire import and the host-tier up-page."""
        idx = self._block_index(blocks)
        for name in self.wire_names():
            dst = kv[name]
            if not isinstance(dst, Ranked):
                dst.index_copy_(1, idx, planes[name].to(
                    device=dst.device, dtype=dst.dtype, non_blocking=True))
                continue
            full = planes[name].to(device=self.device, dtype=dst[0].dtype,
                                   non_blocking=True)
            for part, heads in zip(dst, self.policy.split_heads(name, full)):
                part.index_copy_(1, to_device(idx, part.device),
                                 to_device(heads, part.device))

    # -- host-DRAM tier: down-page / up-page / peer spill --------------------

    @property
    def tiered(self) -> bool:
        return self.host_tier is not None

    def downpage(self, kv, entry) -> bool:
        """Move one unpinned device prefix entry to the host tier: gather
        its blocks to host memory, release the pool blocks, keep the entry
        alive under ``tier="host"``. The gather is queued, not waited for:
        the serve loop goes on dispatching. False = the host tier could not
        fit it (``_evict_one`` may destroy it later, as before)."""
        if self.host_tier is None or entry.pins or not entry.blocks:
            return False
        planes, ready = self.gather_blocks(kv, entry.blocks)
        stored, reaped = self.host_tier.put(
            entry.key, planes, entry.n_tokens, len(entry.blocks),
            skip=self._host_pin_guard, ready=ready)
        self._reap_to_peer(reaped)
        if not stored:
            return False
        self.prefix_cache.spill_to_host(entry)
        self.downpages += 1
        return True

    def _host_pin_guard(self, key: bytes) -> bool:
        """Host-tier reap skip predicate: a pinned host entry has an
        up-page in flight; its planes must not vanish mid-copy."""
        ent = self.prefix_cache._entries.get(key)
        return ent is not None and ent.pins > 0

    def uppage_planes(self, entry) -> Optional[dict]:
        """The host planes backing a host-tier entry (None = lost a race
        with a host reap; the caller recomputes)."""
        if self.host_tier is None:
            return None
        ent = self.host_tier.get(entry.key)
        return None if ent is None else ent["planes"]

    def complete_uppage(self, kv, entry, planes: dict) -> None:
        """Finish an up-page: write the planes into freshly allocated
        blocks in place and promote the entry back to device residency.
        The entry is PINNED by the caller for the whole up-page, and the
        caller keeps ``planes`` alive until this returns. Raises
        :class:`PoolExhausted` when no block is free."""
        blocks = self.alloc_blocks(len(entry.blocks) or
                                   blocks_for(entry.n_tokens,
                                              self.ecfg.kv_block_size))
        try:
            self.place_host_blocks(kv, planes, blocks)
        except Exception:
            self.allocator.release(blocks)
            raise
        self.prefix_cache.promote_to_device(entry, blocks)
        if self.host_tier is not None:
            self.host_tier.pop(entry.key)
        self.uppages += 1

    def _reap_to_peer(self, reaped: list) -> None:
        """Score host-tier reap victims on the hits x recency clock;
        winners serialize through kvwire onto the peer-spill queue, losers
        die and their prefix-cache entries are journaled as evicted. Either
        way the choice leaves a ``kv_tier`` decision record."""
        now = time.monotonic()
        for key, ent in reaped:
            pe = self.prefix_cache._entries.get(key)
            score = 0.0
            if pe is not None:
                age = max(0.0, now - pe.last_used)
                score = pe.hits * 0.5 ** (age / PEER_SPILL_HALF_LIFE_S)
            if score >= PEER_SPILL_SCORE:
                payload = kvwire.encode_blocks(
                    self._wire_meta(ent["n_blocks"], ent["n_tokens"], key),
                    host_planes(ent))
                self.peer_spill_queue.append(
                    (key.hex()[:16], payload, ent["n_tokens"]))
                self.peer_spills += 1
                self.prefix_cache.drop(key, kind="peer")
                self.kv_decisions.append(
                    {"decision": "spill",
                     "chosen": f"peer:{key.hex()[:16]}",
                     "signals": {"score": round(score, 4),
                                 "n_tokens": ent["n_tokens"]}})
            else:
                self.prefix_cache.drop(key, kind="evict")
                self.kv_decisions.append(
                    {"decision": "evict", "chosen": "drop",
                     "rejected": [{"alternative": f"peer:{key.hex()[:16]}",
                                   "reason": "score_below_spill_threshold"}],
                     "signals": {"score": round(score, 4),
                                 "n_tokens": ent["n_tokens"]}})

    def drain_peer_spills(self) -> list:
        """Hand the queued peer-cache payloads to the transport owner (the
        runner). Destructive read; bounded by the deque cap."""
        out = list(self.peer_spill_queue)
        self.peer_spill_queue.clear()
        return out

    def tier_stats(self) -> dict:
        """Flat occupancy/counter snapshot for the ``kvtier_`` stats family
        (device bytes priced at the pool's block bytes, host bytes as the
        planes' bytes)."""
        bb = kv_block_bytes(self.cfg, self.ecfg.kv_block_size,
                            self.kv_quant)
        held = self.prefix_cache.held_blocks
        out = {"device_blocks": held, "device_bytes": held * bb,
               "downpages": self.downpages, "uppages": self.uppages,
               "peer_spills": self.peer_spills,
               "host_blocks": 0, "host_bytes": 0, "host_entries": 0,
               "host_evictions": 0}
        if self.host_tier is not None:
            hs = self.host_tier.stats()
            out.update({
                "host_bytes": hs["bytes"], "host_entries": hs["entries"],
                "host_blocks": sum(e["n_blocks"] for e in
                                   self.host_tier._entries.values()),
                "host_evictions": hs["evictions"]})
        return out

    # -- the block table ------------------------------------------------------

    def push_table(self, slot: int) -> torch.Tensor:
        """Refresh one slot's table row from its block list (trash-padded)
        in place, on the host and on the device, and return the device
        table. The row's copy is queued behind the work already enqueued,
        so a window in flight still reads the row it was dispatched with."""
        row = np.full((self.mb,), self.trash_block, dtype=np.int32)
        blocks = self.slot_blocks[slot]
        row[:len(blocks)] = blocks
        self.table_np[slot] = row
        # every device's copy, each queued behind that device's work
        for table in self._tables.values():
            host_to_device(table[slot], row)
        return self.table

    def ensure_slot_blocks(self, slot: int, n_tokens: int) -> bool:
        """Grow the slot's physical block list to cover ``n_tokens``
        positions. True when the slot's block list grew (its table row
        then needs :meth:`push_table`)."""
        need = blocks_for(n_tokens, self.ecfg.kv_block_size)
        have = len(self.slot_blocks[slot])
        if need <= have:
            return False
        self.slot_blocks[slot].extend(self.alloc_blocks(need - have))
        return True

    def release_slot(self, slot: int) -> torch.Tensor:
        """Retirement: physical blocks back to the pool (prefix-cache refs
        keep shared prefix blocks alive), worst-case reservation released,
        the slot's table row back to trash. Returns the device table."""
        self.allocator.release(self.slot_blocks[slot])
        self.slot_blocks[slot] = []
        table = self.push_table(slot)
        self.allocator.unreserve(self.slot_reserved[slot])
        self.slot_reserved[slot] = 0
        return table
