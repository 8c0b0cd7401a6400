"""Host-side block allocator and prefix cache for the paged KV pool: the
port's own copy of ``tpu9/serving/paged_kv.py`` (allocation, reservations,
prefix lookup/insert, pins, LRU eviction, the kvwire export pin and
adoption, the device/host tier transitions and the tier-change journal the
runner's heartbeat ships).

The device cache is a pool of fixed-size blocks that the paged decode
kernel reads by table lookup; this allocator hands logical sequence
positions physical blocks, refcounted so full prefix blocks can back many
sequences. Admission reserves a worst-case budget in accounting only and
blocks are allocated lazily per decode window, so a mid-decode allocation
cannot fail.
"""

from __future__ import annotations

import collections
import hashlib
import time
from dataclasses import dataclass, field
from typing import Optional


def blocks_for(n_tokens: int, block_s: int) -> int:
    """Physical blocks needed so positions [0, n_tokens) are addressable."""
    return max(0, -(-n_tokens // block_s))


def kv_block_bytes(cfg, block_s: int, quantized: bool = False) -> int:
    """Device bytes one k+v pool block holds across all layers of ``cfg``:
    the model dtype per element, or for an int8 pool one byte per element
    plus one f32 scale per (position, head) vector
    (``ops.quant.quantize_kv``). The pool's equal-bytes auto sizing prices
    blocks with it."""
    per_vec = cfg.head_dim * (1 if quantized else cfg.dtype.itemsize)
    if quantized:
        per_vec += 4
    return 2 * cfg.n_layers * block_s * cfg.n_kv_heads * per_vec


@dataclass
class PrefixEntry:
    key: bytes
    blocks: list[int]          # full, block-aligned prefix blocks (shared)
    n_tokens: int
    last_used: float = field(default_factory=time.monotonic)
    # admissions holding this entry between lookup() and retaining its
    # blocks: eviction must not release blocks out from under them
    pins: int = 0
    # which tier physically holds the KV: "device" (blocks index the pool)
    # or "host" (blocks is empty; the planes live in the pool's HostKvTier
    # until an up-page places them again)
    tier: str = "device"
    # lifetime lookup hits; with last_used this is the hits x recency
    # clock the host tier scores peer-spill candidates by
    hits: int = 0


class BlockAllocator:
    def __init__(self, n_blocks: int, block_s: int):
        self.n_blocks = n_blocks
        self.block_s = block_s
        self._free: list[int] = list(range(n_blocks - 1, -1, -1))
        self._refs = [0] * n_blocks
        self.reserved = 0          # accounting-only worst-case reservations
        # blocks reservations may count on: excludes permanently-held
        # blocks (the engine's trash block) — the pool adjusts this
        self.reserve_capacity = n_blocks

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def used_count(self) -> int:
        return self.n_blocks - len(self._free)

    def alloc(self, n: int) -> Optional[list[int]]:
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._refs[b] = 1
        return out

    def retain(self, blocks: list[int]) -> None:
        for b in blocks:
            self._refs[b] += 1

    def release(self, blocks: list[int]) -> None:
        for b in blocks:
            self._refs[b] -= 1
            if self._refs[b] == 0:
                self._free.append(b)
            elif self._refs[b] < 0:
                raise AssertionError(f"double free of block {b}")

    def can_reserve(self, n_tokens: int) -> bool:
        return (self.reserved + blocks_for(n_tokens, self.block_s)
                <= self.reserve_capacity)

    def reserve(self, n_tokens: int) -> int:
        n = blocks_for(n_tokens, self.block_s)
        self.reserved += n
        return n

    def unreserve(self, n_blocks: int) -> None:
        self.reserved -= n_blocks
        if self.reserved < 0:
            raise AssertionError("unbalanced reservation release")


class PrefixCache:
    """KV prefix reuse over shared pool blocks. Entries hold refcounts on
    their blocks; eviction (LRU, or on demand when the allocator runs dry)
    releases them. Keys hash block-aligned token prefixes, so a lookup walks
    from the longest possible prefix down and the first hit is the best."""

    def __init__(self, allocator: BlockAllocator, max_blocks: int):
        self.allocator = allocator
        self.max_blocks = max_blocks
        self._entries: dict[bytes, PrefixEntry] = {}
        self.hits = 0
        self.misses = 0
        self.tokens_reused = 0
        self.evictions = 0
        self.pinned = 0         # live lookup pins
        self.adopted = 0        # entries imported off the wire
        self.spills = 0         # device → host down-pages (prefix survives)
        self.hits_device = 0    # lookup hits by serving tier
        self.hits_host = 0
        # tier-change journal for the fleet's prefix directory: every
        # eviction, spill or peer hand-off appends (seq, kind, key-hex16),
        # so the next heartbeat retracts or re-tiers the advertisement.
        # Bounded; a consumer that falls behind resyncs from the full digest.
        self._delta_seq = 0
        self._deltas: collections.deque = collections.deque(maxlen=512)
        # set by KvPool when host tiering is on: called with the entry key
        # when a host-tier copy must be discarded (the entry went back to
        # device residency)
        self.on_host_drop = None

    def _note_delta(self, kind: str, key: bytes) -> None:
        self._delta_seq += 1
        self._deltas.append((self._delta_seq, kind, key.hex()[:16]))

    def deltas_since(self, seq: int) -> tuple[list[tuple[str, str]], int]:
        """Tier-change events after journal position ``seq`` (oldest
        first) plus the new cursor. The caller advances its cursor only
        once the delta is known-delivered (heartbeat accepted)."""
        out = [(kind, hx) for s, kind, hx in self._deltas if s > seq]
        return out, self._delta_seq

    @staticmethod
    def _key(tokens: list[int]) -> bytes:
        h = hashlib.sha1()
        h.update(b",".join(str(t).encode() for t in tokens))
        return h.digest()

    @property
    def held_blocks(self) -> int:
        return sum(len(e.blocks) for e in self._entries.values())

    def contains(self, key: bytes) -> bool:
        return key in self._entries

    def lookup(self, prompt: list[int]) -> Optional[PrefixEntry]:
        """Longest cached block-aligned strict prefix of ``prompt`` (at
        least one prompt token must remain to prefill: admission samples
        the first output from the suffix's logits). The returned entry is
        PINNED; call :meth:`release_pin` once its blocks are retained."""
        bs = self.allocator.block_s
        nb = (len(prompt) - 1) // bs
        while nb > 0:
            entry = self._entries.get(self._key(prompt[:nb * bs]))
            if entry is not None:
                entry.last_used = time.monotonic()
                entry.pins += 1
                entry.hits += 1
                self.pinned += 1
                self.hits += 1
                if entry.tier == "host":
                    self.hits_host += 1
                else:
                    self.hits_device += 1
                self.tokens_reused += entry.n_tokens
                return entry
            nb -= 1
        self.misses += 1
        return None

    def release_pin(self, entry: PrefixEntry) -> None:
        entry.pins -= 1
        self.pinned -= 1
        if entry.pins < 0:
            raise AssertionError("unbalanced prefix-cache pin release")

    # -- kvwire export / adopt -----------------------------------------------

    def acquire_for_export(self,
                           tokens: list[int]) -> Optional[PrefixEntry]:
        """Longest cached block-aligned prefix of ``tokens`` held on the
        device, PINNED for the duration of the payload gather (an eviction
        interleaved with it must not recycle a block). Separate from
        :meth:`lookup`: export traffic is not admission traffic and leaves
        the hit/miss/tokens_reused signals alone. Non-strict: a
        whole-prompt entry is what a handoff wants to ship. Balance with
        :meth:`release_pin`."""
        bs = self.allocator.block_s
        nb = len(tokens) // bs
        while nb > 0:
            entry = self._entries.get(self._key(tokens[:nb * bs]))
            # host-tier entries hold no pool blocks to gather: walk down
            # to the longest device-resident prefix
            if entry is not None and entry.tier == "device":
                entry.last_used = time.monotonic()
                entry.pins += 1
                self.pinned += 1
                return entry
            nb -= 1
        return None

    def adopt(self, key: bytes, blocks: list[int], n_tokens: int) -> bool:
        """Register an imported prefix under the exporter's key, taking
        ownership of freshly allocated blocks (ref already 1 from the
        alloc). False = an entry under this key exists or the entry cannot
        fit the budget: the caller releases its blocks."""
        nb = len(blocks)
        if (nb == 0 or self.max_blocks <= 0 or nb > self.max_blocks
                or key in self._entries):
            return False
        self._entries[key] = PrefixEntry(key=key, blocks=list(blocks),
                                         n_tokens=n_tokens)
        self.adopted += 1
        self._evict_to_budget()
        return True

    def insert(self, prompt: list[int], slot_blocks: list[int]) -> None:
        """Register the prompt's full-block prefix, sharing the slot's
        physical blocks (retained; safe because decode never writes into
        full prefix blocks)."""
        bs = self.allocator.block_s
        nb = len(prompt) // bs
        # an entry alone bigger than the whole budget could only evict
        # everything and then itself — refuse it instead
        if nb == 0 or self.max_blocks <= 0 or nb > self.max_blocks:
            return
        key = self._key(prompt[:nb * bs])
        ent = self._entries.get(key)
        if ent is not None:
            ent.last_used = time.monotonic()
            # a host-tier entry prefilled again on the device (recompute
            # beat the up-page): upgrade it in place, sharing the fresh
            # slot blocks, and drop the redundant host copy
            if ent.tier == "host" and not ent.blocks:
                blocks = slot_blocks[:nb]
                self.allocator.retain(blocks)
                ent.blocks = blocks
                ent.tier = "device"
                ent.n_tokens = nb * bs
                if self.on_host_drop is not None:
                    self.on_host_drop(key)
            return
        blocks = slot_blocks[:nb]
        self.allocator.retain(blocks)
        self._entries[key] = PrefixEntry(key=key, blocks=blocks,
                                         n_tokens=nb * bs)
        self._evict_to_budget()

    def _evict_to_budget(self) -> None:
        while self.held_blocks > self.max_blocks and self._evict_one():
            pass

    def _evict_one(self) -> bool:
        """Evict the LRU unpinned device entry. Pinned entries (a lookup
        handed their blocks to an admission that has not retained them
        yet) are untouchable; host-tier entries hold no pool blocks, so
        the HostKvTier's byte budget reaps those instead."""
        victims = [e for e in self._entries.values()
                   if e.pins == 0 and e.tier == "device"]
        if not victims:
            return False
        oldest = min(victims, key=lambda e: e.last_used)
        del self._entries[oldest.key]
        self.allocator.release(oldest.blocks)
        self.evictions += 1
        self._note_delta("evict", oldest.key)
        return True

    # -- host tier transitions -----------------------------------------------

    def spill_candidates(self, n: int) -> list[PrefixEntry]:
        """Up to ``n`` LRU unpinned device entries: what a window-boundary
        down-page moves to host DRAM instead of letting ``_evict_one``
        destroy them."""
        victims = [e for e in self._entries.values()
                   if e.pins == 0 and e.tier == "device" and e.blocks]
        victims.sort(key=lambda e: e.last_used)
        return victims[:n]

    def spill_to_host(self, entry: PrefixEntry) -> None:
        """A device entry becomes host-resident: its pool blocks are
        released (the host tier holds the planes, gathered before any later
        write to those blocks), the entry survives for lookup."""
        if entry.pins or entry.tier != "device":
            raise AssertionError("spill of a pinned or host-tier entry")
        self.allocator.release(entry.blocks)
        entry.blocks = []
        entry.tier = "host"
        self.spills += 1
        self._note_delta("spill", entry.key)

    def promote_to_device(self, entry: PrefixEntry,
                          blocks: list[int]) -> None:
        """Complete an up-page: freshly allocated blocks (ref already 1)
        back the entry on the device again. The pool drops the host copy."""
        if entry.tier != "host" or entry.blocks:
            raise AssertionError("promote of a device-tier entry")
        entry.blocks = list(blocks)
        entry.tier = "device"

    def drop(self, key: bytes, kind: str = "evict") -> None:
        """Destroy an entry outright (host-tier reap, or a lost host copy),
        journaling the loss for the directory."""
        ent = self._entries.pop(key, None)
        if ent is None:
            return
        if ent.blocks:
            self.allocator.release(ent.blocks)
        self.evictions += 1
        self._note_delta(kind, key)

    def evict_for_space(self, blocks_needed: int) -> None:
        """Free cache-held blocks until the allocator can satisfy an
        allocation (called when a fresh alloc comes up short)."""
        while (self.allocator.free_count < blocks_needed
               and self._evict_one()):
            pass

    def stats(self) -> dict:
        return {"entries": len(self._entries),
                "held_blocks": self.held_blocks,
                "hits": self.hits, "misses": self.misses,
                "tokens_reused": self.tokens_reused,
                "evictions": self.evictions, "pinned": self.pinned,
                "adopted": self.adopted, "spills": self.spills,
                "hits_device": self.hits_device,
                "hits_host": self.hits_host}
