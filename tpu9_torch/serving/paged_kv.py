"""Host-side block allocator and prefix cache for the paged KV pool: the
port's own copy of ``tpu9/serving/paged_kv.py`` (allocation, reservations,
prefix lookup/insert, pins, LRU eviction and the tier-change journal the
runner's heartbeat ships; the kvwire export/adopt and host-tier
transitions are not in this slice, so every entry lives on the device).

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
        # kept at 0 until kvwire adoption and the host tier are ported;
        # the stats surface carries them as the reference does
        self.adopted = 0
        self.spills = 0
        self.hits_device = 0    # lookup hits by serving tier
        self.hits_host = 0
        # tier-change journal for the fleet's prefix directory: every
        # eviction appends (seq, kind, key-hex16), so the next heartbeat
        # retracts the advertisement. Bounded; a consumer that falls
        # behind resyncs from the full digest.
        self._delta_seq = 0
        self._deltas: collections.deque = collections.deque(maxlen=512)

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
                self.pinned += 1
                self.hits += 1
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
        """Evict the LRU unpinned entry; pinned entries (a lookup handed
        their blocks to an admission that has not retained them yet) are
        untouchable."""
        victims = [e for e in self._entries.values() if e.pins == 0]
        if not victims:
            return False
        oldest = min(victims, key=lambda e: e.last_used)
        del self._entries[oldest.key]
        self.allocator.release(oldest.blocks)
        self.evictions += 1
        self._note_delta("evict", oldest.key)
        return True

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
