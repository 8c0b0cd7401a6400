"""Window scheduling (counterpart of ``tpu9/serving/schedule.py``): the
decode-window size and the admission-can-proceed check. Pure host
arithmetic over the engine's scheduling state; it dispatches nothing, and
records why it chose a window in ``engine._pick_reason`` (the flight
recorder's "why was K small" answer)."""

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
