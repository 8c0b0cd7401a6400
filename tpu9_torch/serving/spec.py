"""Self-speculative decoding: prompt-lookup (n-gram) drafts and per-slot
acceptance control (the port's own copy of ``tpu9/serving/spec.py``).

No draft model: one decode step streams every weight byte to produce one
token per sequence, and a verify pass over ``1 + spec_len`` positions
streams the same bytes, so each accepted draft token costs little more than
the bytes it saves. Drafts come from the request's own context (prompt and
generated tokens): an n-gram lookup finds what repeats there, for every
preset, with no extra weights.

Correctness does not rest on the drafts: the verify window emits the
model's own token at every position and accepts a draft token only where it
equals that output, so the stream is the one classic decode would produce
(greedy parity is exact; sampled decode emits model samples). Bad drafts
cost verify compute, which :class:`SlotSpecState`'s EWMA bounds: below the
floor speculation turns off for that request, and shadow scoring (or a
probe) turns it back on when the stream becomes repetitive.

Host code only: nothing here touches a tensor.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


class NGramProposer:
    """Prompt-lookup drafting over one request's token history.

    Keeps, per n-gram length, an index from the n-gram to the position
    right after its latest occurrence, and the one before that; a proposal
    copies the continuation that followed the suffix's previous occurrence.
    The longest n wins; ``min_n`` defaults to 2 because 1-gram
    continuations are mostly noise that burns verify compute. Appending
    and proposing are both O(max_n), whatever the history's length.
    """

    def __init__(self, tokens: list[int], max_n: int = 3, min_n: int = 2):
        self.max_n = max(1, max_n)
        self.min_n = max(1, min(min_n, self.max_n))
        self.tokens: list[int] = []
        # per n: {n-gram: position after its latest occurrence}, and the
        # occurrence before that. The suffix is always the latest
        # occurrence of itself, so proposals read the previous one
        self._index: list[dict[tuple, int]] = [
            {} for _ in range(self.max_n + 1)]
        self._prev: list[dict[tuple, int]] = [
            {} for _ in range(self.max_n + 1)]
        self.extend(tokens)

    def extend(self, tokens: list[int]) -> None:
        for t in tokens:
            self.append(int(t))

    def append(self, tok: int) -> None:
        self.tokens.append(tok)
        end = len(self.tokens)
        for n in range(self.min_n, self.max_n + 1):
            if end >= n:
                key = tuple(self.tokens[end - n:end])
                old = self._index[n].get(key)
                if old is not None:
                    self._prev[n][key] = old
                self._index[n][key] = end

    def propose(self, k: int) -> list[int]:
        """Up to ``k`` draft tokens continuing the history, or ``[]`` when
        no n-gram of the suffix occurred before. When that occurrence lies
        within ``k`` tokens of the end, the history between it and the end
        is a cycle of period ``end - pos``, and the draft extrapolates the
        cycle instead of stopping short."""
        if k <= 0:
            return []
        end = len(self.tokens)
        for n in range(self.max_n, self.min_n - 1, -1):
            if end < n:
                continue
            pos = self._prev[n].get(tuple(self.tokens[end - n:end]))
            if pos is None:
                continue
            draft = self.tokens[pos:pos + k]
            period = end - pos
            while len(draft) < k:
                draft.append(draft[len(draft) - period])
            return draft
        return []


# EWMA weight of one window's acceptance: about three windows of memory, so
# a stream that turns repetitive (or stops) re-rates within a few windows
EWMA_ALPHA = 0.3


@dataclass
class SlotSpecState:
    """One slot's proposer and the acceptance EWMA the window chooser
    reads. It starts at 1.0, so every request tries speculation; a stream
    whose drafts keep failing decays below the floor within a few windows
    and falls back to classic windows."""

    proposer: NGramProposer
    ewma: float = 1.0
    proposed: int = 0
    accepted: int = 0
    windows: int = 0

    def observe(self, proposed: int, accepted: int) -> None:
        self.proposed += proposed
        self.accepted += accepted
        self.windows += 1
        if proposed > 0:
            rate = accepted / proposed
            self.ewma = (1.0 - EWMA_ALPHA) * self.ewma + EWMA_ALPHA * rate


def make_slot_state(prompt: list[int], max_n: int = 3) -> SlotSpecState:
    return SlotSpecState(proposer=NGramProposer(list(prompt), max_n=max_n))


def build_drafts(states: list[Optional[SlotSpecState]], active,
                 spec_len: int) -> tuple[np.ndarray, np.ndarray]:
    """The drafts of one verify window: int32 ``[B, spec_len]``, zero
    where a slot is inactive or has nothing (or less) to propose, so the
    window keeps one shape for any mix of slots (a padded draft only costs
    its position; the window emits the model's own tokens). Also returns
    ``n_real`` [B] int32, how many real drafts each slot supplied: the
    EWMA must not count padding a slot never proposed."""
    b = len(states)
    drafts = np.zeros((b, spec_len), dtype=np.int32)
    n_real = np.zeros((b,), dtype=np.int32)
    for slot, st in enumerate(states):
        if st is None or not active[slot]:
            continue
        prop = st.proposer.propose(spec_len)
        drafts[slot, :len(prop)] = prop
        n_real[slot] = len(prop)
    return drafts, n_real
