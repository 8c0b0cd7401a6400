"""The one traffic generator: it reads a mix file (``mixes/<name>.json``)
and gives the requests of one run from ``--seed``. A new mix is a new
data file: every shape of traffic below is a key of the file.

Every seed gets the same sizes and arrival gaps in another order: a mix's
lengths and gaps are the quantiles of its distributions at ``n`` evenly
spaced points, and the seed permutes them and draws the token ids. So two
seeds differ in which requests fall in the window, not in how much work
the traffic holds.

Mix keys:

- ``kind``: ``serve`` (``serve.py``) or ``train`` (``train.py``).
- ``loop``: ``open`` (Poisson arrivals at ``rate_per_s``) or ``closed``
  (``clients`` that each send the next request when the last completes,
  from a pool of ``clients * pool_per_client``).
- ``burst`` (open loop, optional): ``{"on_s", "off_s"}``: arrivals come
  at ``rate_per_s`` for ``on_s`` seconds, then none for ``off_s``, and
  so on from the first request.
- ``prompt``, ``output``: ``{"dist": "lognormal", "median", "sigma",
  "min", "max"}`` or ``{"dist": "uniform", "min", "max"}``: a request's
  own prompt tokens and its output tokens.
- ``shared_prefix`` (optional): ``{"count", "tokens"}``: ``count``
  prefixes of ``tokens`` tokens each, drawn from the seed; every request
  (every session's first turn) starts with one of them, the prefixes
  taking turns, before its own prompt tokens.
- ``text`` (optional): ``{"repeat": <dist>}``: each own prompt is a
  random phrase of a length from the distribution, repeated to its
  length (repetitive text, as prompt lookup finds it); without it every
  token is drawn anew.
- ``turns`` (optional): ``{"count": <dist>, "max_context"}``: each
  request opens a session of that many turns; a later turn's prompt is
  the previous turn's prompt, its served tokens and a new user part of
  ``prompt`` length, sent when the previous turn completes (an open
  loop's later turns after ``think_s``, default 0). A session ends early
  where a turn would pass ``max_context`` tokens with its output.
- ``engine`` (optional): engine knobs laid over the configuration's
  (``presets.engine_config``'s keywords: ``spec_len``, ``kv_quant``,
  ``paged``, ``prefix_cache_blocks``, ...).
- ``lead_in_s`` (traffic before the window, not counted), ``drain_s``
  (how long past the window the run waits for the window's requests),
  ``check_tokens`` (served tokens the correctness sample holds at least)
  and ``trace_s`` (the traced slice of a ``--trace 1`` run).

The optional keys draw from their own stream of the seed, so a mix
without them gives the requests it always gave."""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from statistics import NormalDist
from typing import Optional

import numpy as np


@dataclass
class Request:
    index: int
    prompt: list
    max_new: int
    due_s: Optional[float] = None       # open loop: offset from the start
    # later turns of its session: (user part, output tokens) each
    turns: list = field(default_factory=list)
    max_context: int = 0
    # filled by the client, on the host's monotonic clock
    sent: float = 0.0
    times: list = field(default_factory=list)
    tokens: list = field(default_factory=list)
    error: str = ""
    done: bool = False


def quantiles(dist: dict, n: int) -> np.ndarray:
    """The distribution's values at the n midpoints (i + 1/2) / n, rounded
    to whole tokens and clipped to [min, max]."""
    u = (np.arange(n) + 0.5) / n
    kind = dist["dist"]
    if kind == "lognormal":
        z = np.array([NormalDist().inv_cdf(float(x)) for x in u])
        vals = dist["median"] * np.exp(dist["sigma"] * z)
    elif kind == "uniform":
        vals = dist["min"] + u * (dist["max"] - dist["min"])
    else:
        raise ValueError(f"unknown distribution {kind!r}")
    return np.clip(np.rint(vals), dist["min"], dist["max"]).astype(np.int64)


def on_share(mix: dict) -> float:
    """The share of the time in which an open loop's arrivals come."""
    burst = mix.get("burst")
    if not burst:
        return 1.0
    return burst["on_s"] / (burst["on_s"] + burst["off_s"])


def pool_size(mix: dict, seconds: float) -> int:
    """How many requests (sessions) a run of ``seconds`` draws: an open
    loop's arrivals over the lead-in, the window and the drain; a closed
    loop's pool."""
    if mix["loop"] == "open":
        span = (mix["lead_in_s"] + seconds + mix["drain_s"]) * on_share(mix)
        return int(math.ceil(mix["rate_per_s"] * span)) + 1
    if mix["loop"] == "closed":
        return mix["clients"] * mix["pool_per_client"]
    raise ValueError(f"unknown loop {mix['loop']!r}")


def arrivals(mix: dict, gaps: np.ndarray) -> list:
    """Arrival offsets from the gaps: their running sum, with ``burst``'s
    off periods laid in after every ``on_s`` seconds of arrivals."""
    due = np.cumsum(gaps)
    burst = mix.get("burst")
    if burst:
        due = due + np.floor(due / burst["on_s"]) * burst["off_s"]
    return due.tolist()


def text(rng: np.random.Generator, n: int, vocab: int,
         period: Optional[int]) -> list:
    if not period:
        return rng.integers(0, vocab, n).tolist()
    phrase = rng.integers(0, vocab, min(period, n))
    return np.resize(phrase, n).tolist()


def requests(mix: dict, seed: int, seconds: float, vocab: int,
             rate: Optional[float] = None) -> list:
    """The run's requests in the order they are sent. ``rate`` overrides
    an open loop's ``rate_per_s`` (the sweep that fixes it)."""
    if rate is not None:
        mix = {**mix, "rate_per_s": rate}
    n = pool_size(mix, seconds)
    rng = np.random.default_rng(seed)
    prompts = rng.permutation(quantiles(mix["prompt"], n))
    outputs = rng.permutation(quantiles(mix["output"], n))
    due = [None] * n
    if mix["loop"] == "open":
        u = (np.arange(n) + 0.5) / n
        due = arrivals(mix, rng.permutation(-np.log1p(-u)
                                            / mix["rate_per_s"]))
    # the optional keys' draws: a stream of their own
    extra = np.random.default_rng([seed, 1])
    periods = [None] * n
    if "text" in mix:
        periods = extra.permutation(quantiles(mix["text"]["repeat"], n))
    prefixes = []
    if "shared_prefix" in mix:
        sp = mix["shared_prefix"]
        prefixes = [extra.integers(0, vocab, sp["tokens"]).tolist()
                    for _ in range(sp["count"])]
        owner = extra.permutation(np.arange(n) % sp["count"])
    out = []
    for i, (p, o) in enumerate(zip(prompts, outputs)):
        own = text(rng, int(p), vocab, periods[i]) if "text" in mix \
            else rng.integers(0, vocab, int(p)).tolist()
        prompt = (prefixes[int(owner[i])] if prefixes else []) + own
        out.append(Request(index=i, prompt=prompt, max_new=int(o),
                           due_s=due[i]))
    if "turns" in mix:
        add_turns(mix, out, extra, vocab, periods)
    return out


def add_turns(mix: dict, reqs: list, rng: np.random.Generator, vocab: int,
              periods: list) -> None:
    """Each request's later turns: how many from ``turns.count``, and for
    each a user part and an output drawn as the mix's first turns are."""
    t = mix["turns"]
    n = len(reqs)
    counts = rng.permutation(quantiles(t["count"], n))
    later = int(sum(counts) - n)
    parts = rng.permutation(quantiles(mix["prompt"], max(later, 1)))
    outs = rng.permutation(quantiles(mix["output"], max(later, 1)))
    at = 0
    for r, c, period in zip(reqs, counts, periods):
        r.max_context = t["max_context"]
        for _ in range(int(c) - 1):
            r.turns.append((text(rng, int(parts[at]), vocab, period),
                            int(outs[at])))
            at += 1


def next_turn(r: Request, index: int) -> Optional[Request]:
    """The session's next request after ``r`` completed: its prompt, its
    served tokens and the next user part; None where the session has no
    turn left or the next would pass its context."""
    if not r.turns or not r.done:
        return None
    part, out = r.turns[0]
    prompt = r.prompt + r.tokens + part
    if len(prompt) + out > r.max_context:
        return None
    return Request(index=index, prompt=prompt, max_new=out,
                   turns=r.turns[1:], max_context=r.max_context)
