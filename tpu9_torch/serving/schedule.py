"""Window scheduling (counterpart of ``tpu9/serving/schedule.py``): the
decode-window size, the admission-can-proceed check, the speculative
verify window's room and acceptance gate, and the host tier's down-page
quota at a window boundary. Pure host arithmetic over the
engine's scheduling state; it dispatches nothing, and records why it chose
a window in ``engine._pick_reason`` (the flight recorder's "why was K
small" answer)."""

from __future__ import annotations


class WindowScheduler:
    """Scheduling for one :class:`~tpu9_torch.serving.engine.
    InferenceEngine`, constructed by and reading that engine."""

    def __init__(self, engine):
        self.engine = engine

    def admission_can_proceed(self) -> bool:
        """True only when a waiting request could actually be admitted now
        (free slot + KV room for the FIFO head): the only case where
        shrinking the next window buys admission latency."""
        e = self.engine
        if e.active.all():
            return False
        head = None
        if e.paged and e._wait_room:
            head = e._wait_room[0]
        else:
            q = getattr(e._queue, "_queue", None)    # deque peek, no pop
            if q:
                head = q[0]
        return head is not None and e._room_for(head)

    def pick_steps(self) -> int:
        """Largest decode-window bucket every active slot can absorb: no
        slot may outrun its max_new_tokens budget past the window nor its
        cache room, counting steps already in flight. K=1 when an admission
        could proceed."""
        e = self.engine
        if self.admission_can_proceed():
            e._pick_reason = "admission"
            return e.ecfg.decode_steps[0]
        limit = max(e.ecfg.decode_steps)
        for slot in range(e.ecfg.max_batch):
            req = e.slot_req[slot]
            if req is None or not e.active[slot]:
                continue
            remaining = (req.max_new_tokens - len(req.generated)
                         - e._inflight_steps)
            room = (e.ecfg.max_seq_len - 1 - e._host_len[slot]
                    - e._inflight_steps)
            limit = min(limit, max(1, remaining), max(1, room))
        e._pick_reason = ("max" if limit >= max(e.ecfg.decode_steps)
                          else "budget")
        for k in reversed(e.ecfg.decode_steps):
            if k <= limit:
                return k
        return e.ecfg.decode_steps[0]

    def spec_room_len(self) -> int:
        """The largest spec bucket the batch has room for, or 0 when
        speculation is off or blocked: an admission that could proceed
        (its latency wins, as for K), a slot near its cache limit (a dense
        write past max_seq_len would clamp back over valid KV), or budgets
        with fewer than two tokens left."""
        e = self.engine
        if not e._spec_lens:
            return 0
        if self.admission_can_proceed():
            return 0
        min_room = e.ecfg.max_seq_len
        max_remaining = 0
        any_active = False
        for slot in range(e.ecfg.max_batch):
            req = e.slot_req[slot]
            if req is None or not e.active[slot]:
                continue
            any_active = True
            min_room = min(min_room, e.ecfg.max_seq_len - 1
                           - int(e._host_len[slot]) - e._inflight_steps)
            max_remaining = max(max_remaining,
                                req.max_new_tokens - len(req.generated)
                                - e._inflight_steps)
        if not any_active or max_remaining < 2:
            return 0
        for s in sorted(e._spec_lens, reverse=True):
            if s + 1 <= min_room:
                return s
        return 0

    def spec_gate(self, s: int) -> int:
        """The acceptance gate: ``s`` when the mean effective acceptance
        EWMA over active slots clears ``spec_min_accept``, else 0.
        Effective: a slot with nothing to propose right now counts 0 (a
        verify window gives it one token where a classic window gives it
        K), whatever its EWMA. Below the floor, one window in every
        ``spec_probe_every`` is let through as a probe."""
        e = self.engine
        total = 0.0
        n = 0
        for slot in range(e.ecfg.max_batch):
            if e.slot_req[slot] is None or not e.active[slot]:
                continue
            n += 1
            st = e._spec_slots[slot]
            if st is not None and st.proposer.propose(1):
                total += st.ewma
        if n == 0:
            return 0
        if total / n >= e.ecfg.spec_min_accept:
            e._spec_disabled_windows = 0
            return s
        e._spec_disabled_windows += 1
        pe = e.ecfg.spec_probe_every
        if pe > 0 and e._spec_disabled_windows >= pe:
            e._spec_disabled_windows = 0
            return s
        return 0

    def downpage_quota(self) -> int:
        """How many prefix-cache entries this window boundary should
        down-page to host DRAM: 0 unless the free list has sunk under the
        low-water mark, where the next burst of admissions would push
        ``evict_for_space`` into destroying prefixes the host tier could
        keep. Bounded per boundary, so a pressure spike spreads over
        windows."""
        e = self.engine
        pool = e.pool
        if pool is None or not pool.tiered:
            return 0
        alloc = pool.allocator
        # low water: an eighth of the pool, or at least two admission
        # chunks' worth of blocks
        chunk_blocks = max(1, e._chunk // e.ecfg.kv_block_size)
        low = max(2 * chunk_blocks, alloc.n_blocks // 8)
        if alloc.free_count >= low:
            return 0
        return 2
