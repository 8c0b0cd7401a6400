"""Paged KV-pool management (counterpart of ``tpu9/serving/kvpool.py``,
without the host-DRAM tier and kvwire): pool sizing (equal bytes for an
int8 pool), the trash-block discipline, slot → physical-block bookkeeping,
worst-case reservations and the block table, which lives on the device
at one address for the engine's life (a captured decode window reads it
there) and is written one row at a time."""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..utils.platform import host_to_device
from .paged_kv import BlockAllocator, PrefixCache, blocks_for, kv_block_bytes

Params = dict[str, Any]


class KvPool:
    """One engine's paged KV pool: the device tensors (built once by
    :meth:`init_arrays`), the block allocator and prefix cache, and the
    per-slot physical-block state the serve loop mutates. ``kv_quant``
    makes the pool int8 with f32 scale planes."""

    def __init__(self, cfg, ecfg, device, kv_quant: bool = False):
        b, s = ecfg.max_batch, ecfg.max_seq_len
        bs = ecfg.kv_block_size
        self.cfg = cfg
        self.ecfg = ecfg
        self.device = device
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
        self.kv_allocs = 0           # lifetime block allocations

    def init_arrays(self) -> Params:
        """The pool's device state: k/v [L, N, BS, KH, D] (int8 for an
        int8 pool, with f32 k_scale/v_scale [L, N, BS, KH] indexed like the
        payload) and the table."""
        cfg, ecfg = self.cfg, self.ecfg
        shape = (cfg.n_layers, self.n_blocks, ecfg.kv_block_size,
                 cfg.n_kv_heads, cfg.head_dim)
        dt = torch.int8 if self.kv_quant else cfg.dtype
        arrays = {name: torch.zeros(shape, dtype=dt, device=self.device)
                  for name in ("k", "v")}
        if self.kv_quant:
            for name in ("k_scale", "v_scale"):
                arrays[name] = torch.zeros(shape[:-1], dtype=torch.float32,
                                           device=self.device)
        arrays["table"] = self.table
        return arrays

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
            raise RuntimeError(
                f"KV pool exhausted: need {n}, free "
                f"{self.allocator.free_count} (reservation bug)")
        self.kv_allocs += n
        return got

    def push_table(self, slot: int) -> torch.Tensor:
        """Refresh one slot's table row from its block list (trash-padded)
        in place, on the host and on the device, and return the device
        table. The row's copy is queued behind the work already enqueued,
        so a window in flight still reads the row it was dispatched with."""
        row = np.full((self.mb,), self.trash_block, dtype=np.int32)
        blocks = self.slot_blocks[slot]
        row[:len(blocks)] = blocks
        self.table_np[slot] = row
        host_to_device(self.table[slot], row)
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
