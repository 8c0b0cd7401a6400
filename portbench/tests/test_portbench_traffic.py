"""Each mix is deterministic per seed, and every seed gets the same sizes
and gaps in another order."""

import json

import numpy as np
import pytest

from portbench import run as prun, traffic

SEEDS = (1, 2 ** 31 + 977, 2 ** 40 + 3)


def load(name):
    return json.loads((prun.HERE / "mixes" / f"{name}.json").read_text())


# the serving mixes: the training mix draws its rows in train.py
MIXES = sorted(p.stem for p in (prun.HERE / "mixes").glob("*.json")
               if load(p.stem)["kind"] == "serve")


@pytest.mark.parametrize("name", MIXES)
def test_deterministic_per_seed(name):
    mix = load(name)
    a = traffic.requests(mix, SEEDS[1], 10, 32768)
    b = traffic.requests(mix, SEEDS[1], 10, 32768)
    c = traffic.requests(mix, SEEDS[0], 10, 32768)
    assert [(r.prompt, r.max_new, r.due_s) for r in a] == \
        [(r.prompt, r.max_new, r.due_s) for r in b]
    assert [r.prompt for r in a] != [r.prompt for r in c]


@pytest.mark.parametrize("name", MIXES)
def test_same_work_every_seed(name):
    mix = load(name)
    runs = [traffic.requests(mix, s, 10, 32768) for s in SEEDS]
    sizes = [sorted(len(r.prompt) for r in rs) for rs in runs]
    outs = [sorted(r.max_new for r in rs) for rs in runs]
    assert sizes[0] == sizes[1] == sizes[2]
    assert outs[0] == outs[1] == outs[2]
    if mix["loop"] == "open":
        ends = [rs[-1].due_s for rs in runs]
        assert np.allclose(ends, ends[0])
    for rs in runs:
        assert min(len(r.prompt) for r in rs) >= mix["prompt"]["min"]
        assert max(len(r.prompt) + r.max_new for r in rs) <= 2048
        assert all(0 <= t < 32768 for r in rs for t in r.prompt)


def test_lognormal_median():
    vals = traffic.quantiles({"dist": "lognormal", "median": 384,
                              "sigma": 0.6, "min": 64, "max": 1536}, 1001)
    assert vals[500] == 384 and vals.min() >= 64 and vals.max() <= 1536


def test_open_loop_rate():
    mix = {"loop": "open", "rate_per_s": 4.0, "lead_in_s": 8, "drain_s": 60,
           "prompt": {"dist": "uniform", "min": 8, "max": 9},
           "output": {"dist": "uniform", "min": 4, "max": 5}}
    reqs = traffic.requests(mix, 5, 40, 100)
    assert len(reqs) == traffic.pool_size(mix, 40) == 433
    span = reqs[-1].due_s
    assert abs(len(reqs) / span - 4.0) < 0.1


# the requests the committed mixes give: the cells were measured on these
PINNED = {("batch", 1): "d53ee9d82d1e0940",
          ("batch", 2 ** 31 + 977): "bc5080d9791f975b",
          ("chat", 1): "2db3361441a3e341",
          ("chat", 2 ** 40 + 3): "911a1dcbebf2953d"}


@pytest.mark.parametrize("name,seed", sorted(PINNED))
def test_committed_mixes_unchanged(name, seed):
    import hashlib
    reqs = traffic.requests(load(name), seed, 45, 32768)
    digest = hashlib.sha256(json.dumps(
        [(r.prompt, r.max_new, r.due_s) for r in reqs]).encode())
    assert digest.hexdigest()[:16] == PINNED[(name, seed)]


BASE = {"kind": "serve", "lead_in_s": 2, "drain_s": 60,
        "prompt": {"dist": "uniform", "min": 16, "max": 48},
        "output": {"dist": "uniform", "min": 8, "max": 24}}


def test_burst_arrivals_leave_the_off_periods_empty():
    mix = {**BASE, "loop": "open", "rate_per_s": 10.0,
           "burst": {"on_s": 2.0, "off_s": 3.0}}
    reqs = traffic.requests(mix, SEEDS[1], 20, 1000)
    # 10 a second over the on share (2 of 5 s) of 82 s
    assert len(reqs) == traffic.pool_size(mix, 20) == 330
    phase = np.array([r.due_s for r in reqs]) % 5.0
    assert (phase < 2.0).all()
    # same arrivals, another order, at every seed
    other = traffic.requests(mix, SEEDS[2], 20, 1000)
    assert np.isclose(reqs[-1].due_s, other[-1].due_s)


def test_shared_prefixes_take_turns():
    mix = {**BASE, "loop": "closed", "clients": 4, "pool_per_client": 6,
           "shared_prefix": {"count": 3, "tokens": 40}}
    reqs = traffic.requests(mix, SEEDS[1], 10, 1000)
    heads = [tuple(r.prompt[:40]) for r in reqs]
    assert len(set(heads)) == 3
    assert sorted(heads.count(h) for h in set(heads)) == [8, 8, 8]
    own = sorted(len(r.prompt) - 40 for r in reqs)
    base = traffic.requests({k: v for k, v in mix.items()
                             if k != "shared_prefix"}, SEEDS[1], 10, 1000)
    assert own == sorted(len(r.prompt) for r in base)
    assert [r.prompt[40:] for r in reqs] == [r.prompt for r in base]


def test_repetitive_text():
    mix = {**BASE, "loop": "closed", "clients": 2, "pool_per_client": 5,
           "text": {"repeat": {"dist": "uniform", "min": 4, "max": 8}}}
    for r in traffic.requests(mix, SEEDS[0], 10, 1000):
        period = next(p for p in range(4, 9)
                      if r.prompt[p:] == r.prompt[:-p])
        assert 4 <= period <= 8 and len(r.prompt) >= 16


def test_sessions_chain_their_turns():
    mix = {**BASE, "loop": "closed", "clients": 2, "pool_per_client": 4,
           "turns": {"count": {"dist": "uniform", "min": 2, "max": 4},
                     "max_context": 200}}
    reqs = traffic.requests(mix, SEEDS[1], 10, 1000)
    counts = sorted(len(r.turns) + 1 for r in reqs)
    assert counts == sorted(len(r.turns) + 1 for r in
                            traffic.requests(mix, SEEDS[2], 10, 1000))
    assert min(counts) == 2 and max(counts) == 4
    r = reqs[0]
    assert traffic.next_turn(r, 99) is None          # not completed yet
    r.tokens, r.done = list(range(r.max_new)), True
    nxt = traffic.next_turn(r, 99)
    part, out = r.turns[0]
    assert nxt.prompt == r.prompt + r.tokens + part and nxt.max_new == out
    assert nxt.index == 99 and nxt.turns == r.turns[1:]
    r.max_context = len(nxt.prompt) + out - 1
    assert traffic.next_turn(r, 99) is None          # past the context
