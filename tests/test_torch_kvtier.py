"""The host-DRAM KV tier in the port (``HostKvTier`` and the pool's
down-page/up-page/peer spill in ``tpu9_torch/serving/kvpool.py``, the
prefix cache's tier transitions, the scheduler's down-page quota and the
engine's up-page on a host hit) against the JAX package, on the CPU.

The reference's pool and engine cells of ``tests/test_kvtier.py`` (all but
the tp=2 mesh cell), run on the port: the byte budget, LRU reap and pin
guard; tier transitions judged bit for bit; the eviction journal; peer
spill scoring; an up-page hit, a lost host copy and a replica death, each
at exact greedy parity at f32 on llama-tiny; ``TPU9_KV_TIER=0``.

Across the packages: a scripted trace of inserts, lookups, exports,
imports, down-pages, up-pages, reaps and drops makes the same decisions in
both pools (block ids, journal deltas, decision records, peer-spill
payload bytes), under one pinned step clock for the spill score; a tiered
engine under pool pressure serves the JAX engine's streams with the same
down-pages, up-pages, digests, deltas and decisions; ``TPU9_KV_TIER=0``
serves the streams of an engine without a tier, in both packages; and
adopt and up-page move no pool tensor and build nothing after warmup.
"""

import asyncio
import dataclasses
import hashlib
import itertools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu9.models import init_decoder as jax_init_decoder
from tpu9.models.llama import LLAMA_PRESETS as JAX_PRESETS
from tpu9.serving import kvpool as jkvpool
from tpu9.serving import paged_kv as jpaged_kv
from tpu9.serving.engine import EngineConfig as JaxEngineConfig
from tpu9.serving.engine import InferenceEngine as JaxEngine
from tpu9.serving.shard import make_policy
from tpu9_torch.bridge import params_from_jax
from tpu9_torch.models.llama import LLAMA_PRESETS
from tpu9_torch.serving import kvpool as tkvpool
from tpu9_torch.serving import kvwire
from tpu9_torch.serving import paged_kv as tpaged_kv
from tpu9_torch.serving.engine import EngineConfig, InferenceEngine
from tpu9_torch.serving.kvpool import HostKvTier, KvPool
from tpu9_torch.serving.paged_kv import BlockAllocator, PrefixCache

torch.set_num_threads(2)


@pytest.fixture
def jax_table_copies(monkeypatch):
    """The JAX paged engine's block table handed over as a copy at each
    push: ``jnp.asarray`` may wrap the pool's host table, which each push
    rewrites in place, so a window dispatched before an admission could
    read the admitted slot's new row (``tests/test_torch_spec.py`` says
    how). The port copies its table."""
    from tpu9.serving.shard.policy import SingleDevicePolicy
    monkeypatch.setattr(
        SingleDevicePolicy, "device_table",
        lambda policy, table: jnp.asarray(np.array(table, copy=True)))


JTINY = JAX_PRESETS["llama-tiny"]
TTINY = LLAMA_PRESETS["llama-tiny"]
BS = 32
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _tier_env(monkeypatch):
    """Every cell starts from the default environment: tiering armed, the
    host pool sized by ``kv_host_pool_mb`` alone."""
    monkeypatch.delenv("TPU9_KV_TIER", raising=False)
    monkeypatch.delenv("TPU9_KV_HOST_POOL_MB", raising=False)


def _ecfg_kw(**kw) -> dict:
    base = dict(max_batch=2, max_seq_len=256, prefill_buckets=(32, 64),
                decode_steps=(1, 4), kv_block_size=BS, kv_pool_blocks=16,
                prefill_chunk=32, prefix_cache_blocks=8)
    base.update(kw)
    return base


def _pool(kv_quant=False, host_mb=64, cfg=TTINY, **kw):
    pool = KvPool(cfg, EngineConfig(**_ecfg_kw(**kw)), CPU, kv_quant,
                  host_pool_mb=host_mb)
    return pool, pool.init_arrays()


def _values(pool, kv, n_blocks: int, seed: int) -> dict:
    """Random content for ``n_blocks`` blocks of every wire plane, drawn as
    the reference's ``_fill`` draws it."""
    rng = np.random.default_rng(seed)
    out = {}
    for name in pool.wire_names():
        shape = tuple(kv[name].shape)
        sub = (shape[0], n_blocks) + shape[2:]
        if kv[name].dtype in (torch.int8, jnp.int8):
            out[name] = rng.integers(-127, 128, size=sub, dtype=np.int8)
        else:
            out[name] = rng.standard_normal(sub).astype(np.float32)
    return out


def _fill(pool, kv, blocks, seed=0):
    idx = torch.tensor(blocks, dtype=torch.int64)
    for name, vals in _values(pool, kv, len(blocks), seed).items():
        kv[name].index_copy_(1, idx, torch.from_numpy(vals).to(kv[name].dtype))


def _jfill(pool, kv, blocks, seed=0):
    idx = jnp.asarray(blocks, dtype=jnp.int32)
    new = dict(kv)
    for name, vals in _values(pool, kv, len(blocks), seed).items():
        new[name] = new[name].at[:, idx].set(
            jnp.asarray(vals, dtype=new[name].dtype))
    return new


def _gather(pool, kv, blocks):
    idx = torch.tensor(blocks, dtype=torch.int64)
    return {name: kv[name][:, idx].clone() for name in pool.wire_names()}


def _ptrs(kv) -> dict:
    return {name: t.data_ptr() for name, t in kv.items()}


def _seed_entry(pool, kv, n_blocks=2, seed=0, start=1):
    """Fill + insert one prefix entry; returns (tokens, entry)."""
    blocks = pool.alloc_blocks(n_blocks)
    _fill(pool, kv, blocks, seed=seed)
    tokens = list(range(start, start + n_blocks * BS))
    pool.prefix_cache.insert(tokens, blocks)
    pool.allocator.release(blocks)
    return tokens, pool.prefix_cache._entries[PrefixCache._key(tokens)]


def _planes(nbytes):
    return {"k": torch.zeros(nbytes // 2, dtype=torch.int8),
            "v": torch.zeros(nbytes - nbytes // 2, dtype=torch.int8)}


# -- HostKvTier: byte budget, LRU reap, pin guard ---------------------------------

def test_host_tier_budget_lru_reap_and_skip():
    tier = HostKvTier(1000)
    assert tier.put(b"a", _planes(400), 32, 1)[0]
    assert tier.put(b"b", _planes(400), 32, 1)[0]
    # oversize entry refused outright, residents untouched
    stored, reaped = tier.put(b"huge", _planes(2000), 64, 2)
    assert not stored and not reaped and len(tier) == 2
    # budget overflow reaps LRU first ("a"), not MRU
    tier.get(b"b")
    stored, reaped = tier.put(b"c", _planes(400), 32, 1)
    assert stored and [k for k, _ in reaped] == [b"a"]
    assert tier.used_bytes <= 1000 and b"b" in tier
    # a skip-protected resident can make an insert impossible: refused,
    # protected entries never reaped
    stored, reaped = tier.put(b"d", _planes(900), 32, 1,
                              skip=lambda k: True)
    assert not stored and not reaped
    assert b"b" in tier and b"c" in tier
    st = tier.stats()
    assert st["entries"] == 2 and st["rejected"] == 2
    assert st["evictions"] == 1


# -- down-page / up-page: tier transitions, pins, bit-exactness ---------------------

def test_downpage_moves_entry_to_host_and_frees_blocks():
    pool, kv = _pool()
    tokens, entry = _seed_entry(pool, kv)
    used0 = pool.allocator.used_count
    assert pool.downpage(kv, entry)
    assert entry.tier == "host" and entry.blocks == []
    assert pool.allocator.used_count == used0 - 2
    assert PrefixCache._key(tokens) in pool.host_tier
    # lookup still finds it, and classifies the hit by tier
    hit = pool.prefix_cache.lookup(tokens + [999])
    assert hit is entry and pool.prefix_cache.hits_host == 1
    pool.prefix_cache.release_pin(entry)
    ts = pool.tier_stats()
    assert ts["downpages"] == 1 and ts["host_entries"] == 1
    assert ts["host_bytes"] > 0


def test_downpage_never_moves_a_pinned_entry():
    """Down-page against a lookup pin: an admission holding the pin is
    about to retain the blocks."""
    pool, kv = _pool()
    tokens, _ = _seed_entry(pool, kv)
    entry = pool.prefix_cache.lookup(tokens + [999])    # pinned
    assert entry is not None
    assert pool.downpage(kv, entry) is False
    assert entry.tier == "device" and entry.blocks
    assert entry not in pool.prefix_cache.spill_candidates(8)
    pool.prefix_cache.release_pin(entry)
    assert entry in pool.prefix_cache.spill_candidates(8)
    assert pool.downpage(kv, entry)


def test_uppage_pin_blocks_host_reap_and_eviction():
    """While a lookup pin holds a host-tier entry (up-page in flight),
    neither the host tier's LRU reap nor ``evict_for_space`` may destroy
    it."""
    pool, kv = _pool()
    tokens, entry = _seed_entry(pool, kv)
    assert pool.downpage(kv, entry)
    pinned = pool.prefix_cache.lookup(tokens + [999])
    assert pinned is entry and entry.pins == 1
    pool.prefix_cache.evict_for_space(16)
    assert pool.prefix_cache.contains(entry.key)
    pool.host_tier.capacity_bytes = pool.host_tier.used_bytes
    stored, reaped = pool.host_tier.put(
        b"intruder", _planes(64), BS, 1, skip=pool._host_pin_guard)
    assert not stored and not reaped
    assert entry.key in pool.host_tier
    pool.prefix_cache.release_pin(entry)


@pytest.mark.parametrize("kv_quant", [False, True],
                         ids=["bf16", "int8+scales"])
def test_downpage_uppage_roundtrip_bit_exact(kv_quant):
    """down-page → up-page reproduces the pool bytes bitwise in every wire
    plane (scales included), writing the pool in place."""
    pool, kv = _pool(kv_quant)
    ptrs = _ptrs(kv)
    blocks = pool.alloc_blocks(3)
    _fill(pool, kv, blocks)
    tokens = [(i * 7) % 211 + 1 for i in range(3 * BS)]
    before = _gather(pool, kv, blocks)
    pool.prefix_cache.insert(tokens, blocks)
    pool.allocator.release(blocks)
    entry = pool.prefix_cache._entries[PrefixCache._key(tokens)]
    assert pool.downpage(kv, entry)
    planes = pool.uppage_planes(entry)
    assert planes is not None
    pool.complete_uppage(kv, entry, planes)
    assert entry.tier == "device" and len(entry.blocks) == 3
    assert entry.key not in pool.host_tier           # host copy retired
    after = _gather(pool, kv, entry.blocks)
    for name in before:
        assert torch.equal(before[name], after[name]), name
    assert pool.tier_stats()["uppages"] == 1
    assert _ptrs(kv) == ptrs


def test_host_tier_entry_invisible_to_export():
    """A host-tier entry holds no pool blocks: ``acquire_for_export``
    skips it, never handing the exporter an empty block list."""
    pool, kv = _pool()
    tokens, entry = _seed_entry(pool, kv)
    assert pool.prefix_cache.acquire_for_export(tokens) is entry
    pool.prefix_cache.release_pin(entry)
    assert pool.downpage(kv, entry)
    assert pool.prefix_cache.acquire_for_export(tokens) is None


def test_insert_upgrades_host_entry_in_place():
    """A recompute that beat the up-page inserts the same prefix again:
    the entry upgrades to the device tier and the stale host copy drops."""
    pool, kv = _pool()
    tokens, entry = _seed_entry(pool, kv)
    assert pool.downpage(kv, entry)
    assert entry.key in pool.host_tier
    blocks = pool.alloc_blocks(2)
    pool.prefix_cache.insert(tokens, blocks)
    pool.allocator.release(blocks)
    assert entry.tier == "device" and entry.blocks == blocks
    assert entry.key not in pool.host_tier


# -- eviction-delta journal -------------------------------------------------------------

def test_eviction_journals_delta_for_next_heartbeat():
    a = BlockAllocator(8, 4)
    pc = PrefixCache(a, max_blocks=4)
    blocks = a.alloc(2)
    pc.insert(list(range(8)), blocks)
    a.release(blocks)
    key_hex = PrefixCache._key(list(range(8))).hex()[:16]
    deltas, seq = pc.deltas_since(0)
    assert deltas == []                       # inserts journal nothing
    pc.evict_for_space(8)
    deltas, seq2 = pc.deltas_since(seq)
    assert ("evict", key_hex) in deltas and seq2 > seq
    assert pc.deltas_since(seq2) == ([], seq2)
    assert pc.deltas_since(seq)[0] == deltas


def test_spill_and_peer_transitions_journal_distinct_kinds():
    pool, kv = _pool()
    tokens, entry = _seed_entry(pool, kv)
    assert pool.downpage(kv, entry)
    deltas, seq = pool.prefix_cache.deltas_since(0)
    key_hex = entry.key.hex()[:16]
    assert ("spill", key_hex) in deltas       # still locally resident
    pool.prefix_cache.drop(entry.key, kind="peer")
    deltas, _ = pool.prefix_cache.deltas_since(seq)
    assert deltas == [("peer", key_hex)]      # locally retracted


# -- peer-cache spill: scoring, wire payload, decision journal ---------------------------

def test_reap_scores_hot_prefix_to_peer_and_drops_cold():
    pool, kv = _pool()
    _, hot = _seed_entry(pool, kv, seed=1, start=1)
    _, cold = _seed_entry(pool, kv, seed=2, start=1000)
    assert pool.downpage(kv, hot) and pool.downpage(kv, cold)
    hot.hits = 5                              # a returning session head
    cold.hits = 0                             # a one-shot prompt
    reaped = [(hot.key, pool.host_tier.pop(hot.key)),
              (cold.key, pool.host_tier.pop(cold.key))]
    pool._reap_to_peer(reaped)
    spills = pool.drain_peer_spills()
    assert [s[0] for s in spills] == [hot.key.hex()[:16]]
    assert pool.drain_peer_spills() == []     # destructive read
    header, planes = kvwire.decode_blocks(spills[0][1])
    assert header["prefix_key"] == hot.key.hex()
    assert header["n_tokens"] == hot.n_tokens
    assert not pool.prefix_cache.contains(hot.key)
    assert not pool.prefix_cache.contains(cold.key)
    kinds = [(d["decision"], d["chosen"]) for d in pool.kv_decisions]
    assert ("spill", f"peer:{hot.key.hex()[:16]}") in kinds
    assert ("evict", "drop") in kinds
    rejected = [d for d in pool.kv_decisions
                if d["decision"] == "evict"][0]["rejected"]
    assert rejected[0]["reason"] == "score_below_spill_threshold"


# -- engine integration: up-page on hit, stale-window recompute, parity ---------------

@pytest.fixture(scope="module")
def tiny_f32():
    jcfg = dataclasses.replace(JTINY, dtype=jnp.float32)
    tcfg = dataclasses.replace(TTINY, dtype=torch.float32)
    jparams = jax_init_decoder(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              "cpu")
    return jcfg, jparams, tcfg, tparams


def _engine(tiny, **kw):
    _, _, tcfg, tparams = tiny
    return InferenceEngine(tparams, tcfg, EngineConfig(**_ecfg_kw(**kw)),
                           device="cpu")


def _jengine(tiny, **kw):
    jcfg, jparams, _, _ = tiny
    return JaxEngine(jparams, jcfg, JaxEngineConfig(**_ecfg_kw(**kw)))


def _run(coro):
    return asyncio.run(coro)


def _downpage_prompt_entry(eng, prompt):
    entry = eng.prefix_cache.acquire_for_export(prompt)
    assert entry is not None
    eng.prefix_cache.release_pin(entry)
    assert eng.pool.downpage(eng._pool_dict(), entry)
    return entry


def test_engine_uppage_hit_greedy_parity(tiny_f32):
    """A host-tier prefix hit is written back in place and the generation
    matches the all-device run exactly; the hit counts against the host
    tier."""
    prompt = [(i * 5) % 200 + 1 for i in range(80)]

    async def go():
        eng = _engine(tiny_f32, kv_host_pool_mb=64)
        assert eng.pool.tiered
        await eng.start()
        ref = await eng.generate(list(prompt), max_new_tokens=8)
        _downpage_prompt_entry(eng, prompt)
        out = await eng.generate(list(prompt), max_new_tokens=8)
        await eng.stop()
        return ref, out, eng

    ref, out, eng = _run(go())
    assert out == ref
    st = eng.stats()
    assert st["kvtier_uppages"] == 1
    assert st["kvtier_hits_host"] == 1
    assert st["kvtier_uppage_failures"] == 0
    assert "kvtier_device_blocks" in st and "kvtier_host_bytes" in st
    assert any(d["decision"] == "pull"
               for d in eng.drain_kvtier_decisions())


def test_stale_directory_hit_degrades_to_recompute(tiny_f32):
    """An entry can advertise a host copy that a reap already destroyed:
    the admission recomputes and serves the same tokens, never errors."""
    prompt = [(i * 3) % 150 + 1 for i in range(80)]

    async def go():
        eng = _engine(tiny_f32, kv_host_pool_mb=64)
        await eng.start()
        ref = await eng.generate(list(prompt), max_new_tokens=8)
        entry = _downpage_prompt_entry(eng, prompt)
        eng.pool.host_tier.pop(entry.key)     # the reap the beat missed
        out = await eng.generate(list(prompt), max_new_tokens=8)
        await eng.stop()
        return ref, out, eng

    ref, out, eng = _run(go())
    assert out == ref
    st = eng.stats()
    assert st["kvtier_uppage_failures"] == 1
    assert st["kvtier_uppages"] == 0
    rec = [d for d in eng.drain_kvtier_decisions()
           if d["decision"] == "recompute"]
    assert rec and rec[0]["rejected"][0]["reason"] == "host_copy_lost"


def test_peer_tier_survives_replica_death(tiny_f32):
    """A hot prefix down-pages, the host reap spills it to the peer wire
    format, the replica dies, and a fresh replica adopts the payload and
    continues with exact greedy parity."""
    prompt = [(i * 9) % 180 + 1 for i in range(80)]

    async def victim_go():
        eng = _engine(tiny_f32, kv_host_pool_mb=64)
        await eng.start()
        ref = await eng.generate(list(prompt), max_new_tokens=8)
        entry = _downpage_prompt_entry(eng, prompt)
        entry.hits = 10                       # hot: clears spill score
        ent = eng.pool.host_tier.pop(entry.key)
        eng.pool._reap_to_peer([(entry.key, ent)])
        spills = eng.drain_kv_spills()
        await eng.stop()
        return ref, spills

    ref, spills = _run(victim_go())
    assert len(spills) == 1
    _khex, payload, n_tokens = spills[0]
    assert n_tokens == 64                     # two full blocks

    async def survivor_go():
        eng = _engine(tiny_f32)               # an untiered survivor
        assert eng.adopt_kv(payload)
        await eng.start()
        out = await eng.generate(list(prompt), max_new_tokens=8)
        await eng.stop()
        return out, eng

    out, survivor = _run(survivor_go())
    assert out == ref
    assert survivor.prefix_cache.stats()["adopted"] == 1
    assert survivor.stats()["kvwire_import_hits"] == 1


def _gen(eng, prompt, n=8):
    async def go():
        await eng.start()
        try:
            return await eng.generate(list(prompt), max_new_tokens=n)
        finally:
            await eng.stop()

    return _run(go())


def test_kv_tier_off_is_bit_identical_to_baseline(tiny_f32, monkeypatch):
    """``TPU9_KV_TIER=0``: the pool carries no host tier, the stats carry
    no kvtier_ keys, and generation matches the untiered engine token for
    token, in both packages."""
    prompt = [(i * 7) % 190 + 1 for i in range(80)]
    base = _gen(_engine(tiny_f32), prompt)
    monkeypatch.setenv("TPU9_KV_TIER", "0")
    monkeypatch.setenv("TPU9_KV_HOST_POOL_MB", "64")
    gated = _engine(tiny_f32, kv_host_pool_mb=64)
    jgated = _jengine(tiny_f32, kv_host_pool_mb=64)
    for eng in (gated, jgated):
        assert not eng.pool.tiered and eng.pool.host_tier is None
        assert _gen(eng, prompt) == base
        assert not any(k.startswith("kvtier_") for k in eng.stats())
    assert set(gated.stats()) == set(jgated.stats())


# -- across the packages ------------------------------------------------------------------

def test_host_pool_env_overrides_engine_config(tiny_f32, monkeypatch):
    """``TPU9_KV_HOST_POOL_MB`` sizes the tier over ``kv_host_pool_mb``, a
    bad value falls back to the config, and a disabled prefix cache
    disarms the tier, in both packages alike."""
    cases = (({"TPU9_KV_HOST_POOL_MB": "3"}, {}, 3 << 20),
             ({"TPU9_KV_HOST_POOL_MB": "x"}, {"kv_host_pool_mb": 2}, 2 << 20),
             ({}, {"kv_host_pool_mb": 2, "prefix_cache_blocks": 0}, None))
    for env, kw, want in cases:
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        for eng in (_engine(tiny_f32, **kw), _jengine(tiny_f32, **kw)):
            tier = eng.pool.host_tier
            assert (None if tier is None else tier.capacity_bytes) == want, \
                (env, kw)
        monkeypatch.delenv("TPU9_KV_HOST_POOL_MB", raising=False)


class _Side:
    """One package's pool under the scripted trace; hides the JAX pool's
    rebinding behind the port's in-place interface."""

    def __init__(self, pkg: str):
        self.jax = pkg == "jax"
        kw = _ecfg_kw(kv_pool_blocks=12, prefix_cache_blocks=8)
        if self.jax:
            self.pool = jkvpool.KvPool(JTINY, JaxEngineConfig(**kw), False,
                                       make_policy(None), host_pool_mb=1)
        else:
            self.pool = KvPool(TTINY, EngineConfig(**kw), CPU, False,
                               host_pool_mb=1)
        self.kv = self.pool.init_arrays()
        # room for three blocks' planes: puts reap
        self.pool.host_tier.capacity_bytes = 3 * tpaged_kv.kv_block_bytes(
            TTINY, BS)

    def fill(self, blocks, seed):
        if self.jax:
            self.kv = _jfill(self.pool, self.kv, blocks, seed)
        else:
            _fill(self.pool, self.kv, blocks, seed)

    def import_blocks(self, payload):
        if self.jax:
            self.kv, adopted, _ = self.pool.import_blocks(self.kv, payload)
            return adopted
        return self.pool.import_blocks(self.kv, payload)[0]

    def complete_uppage(self, entry, planes):
        got = self.pool.complete_uppage(self.kv, entry, planes)
        if self.jax:
            self.kv = got


def _digest(payload: bytes) -> str:
    return hashlib.sha256(payload).hexdigest()[:16]


# insert, lookup, export, adopt, down-page, lose a host copy
OP_WEIGHTS = (0.25, 0.3, 0.1, 0.1, 0.2, 0.05)


def _tier_trace(pkg: str, seed: int, monkeypatch, steps: int = 120) -> list:
    """Inserts, lookups (up-paging host hits), exports, imports of earlier
    exports, down-pages, reaps and drops drawn from ``seed``; returns every
    decision and the pool's state after each step."""
    clock = itertools.count(1e9, 0.25)        # 0.25 s per reading
    fake = SimpleNamespace(monotonic=lambda: next(clock))
    mods = (jpaged_kv, jkvpool) if pkg == "jax" else (tpaged_kv, tkvpool)
    for mod in mods:
        monkeypatch.setattr(mod, "time", fake)
    side = _Side(pkg)
    pool, cache = side.pool, side.pool.prefix_cache
    rng = np.random.default_rng(seed)
    stems = [rng.integers(1, 400, 3 * BS).tolist() for _ in range(4)]
    payloads: list[bytes] = []
    log = []
    for step in range(steps):
        op = int(rng.choice(6, p=OP_WEIGHTS))
        stem = stems[int(rng.integers(len(stems)))]
        tokens = stem[:BS * int(rng.integers(1, 4))]
        event: tuple = (op,)
        try:
            if op == 0:                                   # prefill + insert
                if not cache.contains(PrefixCache._key(tokens)):
                    blocks = pool.alloc_blocks(len(tokens) // BS)
                    side.fill(blocks, seed=step)
                    cache.insert(tokens, blocks)
                    pool.allocator.release(blocks)
                    event += (blocks,)
            elif op == 1:                                 # admission lookup
                entry = cache.lookup(tokens + [7])
                if entry is not None:
                    event += (entry.key.hex()[:16], entry.tier, entry.hits)
                    planes = (pool.uppage_planes(entry)
                              if entry.tier == "host" else None)
                    if planes is not None:
                        side.complete_uppage(entry, planes)
                        event += (entry.blocks,)
                    cache.release_pin(entry)
                    if entry.tier == "host" and entry.pins == 0:
                        # the host copy was lost: the engine recomputes
                        cache.drop(entry.key, kind="evict")
            elif op == 2:                                 # export
                entry = cache.acquire_for_export(tokens)
                if entry is not None:
                    payloads.append(pool.export_blocks(
                        side.kv, entry.blocks, entry.key, entry.n_tokens))
                    cache.release_pin(entry)
                    event += (_digest(payloads[-1]),)
            elif op == 3 and payloads:                    # adopt
                payload = payloads[int(rng.integers(len(payloads)))]
                event += (side.import_blocks(payload),)
            elif op == 4:                                 # window boundary
                for entry in cache.spill_candidates(int(rng.integers(1, 3))):
                    event += (entry.key.hex()[:16],
                              pool.downpage(side.kv, entry))
            elif op == 5 and len(pool.host_tier):          # a missed reap
                key = list(pool.host_tier._entries)[
                    int(rng.integers(len(pool.host_tier)))]
                pool.host_tier.pop(key)
                event += (key.hex()[:16],)
        except RuntimeError as exc:                       # pool exhausted
            event += ("exhausted", str(exc))
        spills = [(k, _digest(p), n) for k, p, n in pool.drain_peer_spills()]
        decisions = list(pool.kv_decisions)
        pool.kv_decisions.clear()
        log.append((event, spills, decisions,
                    cache.deltas_since(0),
                    [(e.key.hex()[:16], e.tier, list(e.blocks), e.n_tokens,
                      e.hits, e.pins) for e in cache._entries.values()],
                    cache.stats(), pool.tier_stats(),
                    pool.host_tier.stats(), pool.allocator.free_count))
    return log


@pytest.mark.parametrize("seed", [2, 5, 6])
def test_tier_decisions_match_the_jax_pool(seed, monkeypatch):
    """The same scripted trace makes the same export, adopt, spill, reap,
    up-page and delta decisions in both pools, with byte-identical export
    and peer-spill payloads."""
    jlog = _tier_trace("jax", seed, monkeypatch)
    tlog = _tier_trace("torch", seed, monkeypatch)
    assert len(tlog) == len(jlog)
    for i, (t, j) in enumerate(zip(tlog, jlog)):
        assert t == j, f"step {i}"
    # the trace reached every kind of decision
    events = [e[0] for e in jlog]
    kinds = {d["decision"] for e in jlog for d in e[2]}
    assert {"spill", "evict"} <= kinds
    assert any(e[1] for e in jlog)                        # a peer spill
    assert any(ev[0] == 1 and len(ev) == 5 for ev in events)   # an up-page
    assert any(ev[0] == 3 and len(ev) == 2 for ev in events)   # an adopt


def _strip_times(decisions: list) -> list:
    """Decision records without their timings and the engines' own
    request ids (stamped from the clock)."""
    return [{**{k: v for k, v in d.items() if k != "request_id"},
             "signals": {k: v for k, v in d["signals"].items()
                         if not k.endswith("_s")}} for d in decisions]


@pytest.mark.usefixtures("jax_table_copies")
def test_tiered_engine_under_pressure_matches_the_jax_engine(tiny_f32):
    """A small pool with a host tier: window-boundary down-pages under
    pressure and up-pages of returning prefixes give the JAX engine's
    streams, stats, digest, deltas and decisions (timings aside)."""
    kw = dict(kv_pool_blocks=12, prefix_cache_blocks=12, kv_host_pool_mb=1)
    rng = np.random.default_rng(4)
    stems = [rng.integers(1, 500, 80).tolist() for _ in range(6)]
    script = [stems[i] + rng.integers(1, 500, 5).tolist()
              for i in (0, 1, 2, 3, 4, 5, 0, 1, 2, 3)]

    def serve(eng):
        async def go():
            await eng.start()
            try:
                outs = []
                for a, b in zip(script[::2], script[1::2]):
                    outs += await asyncio.gather(
                        eng.generate(a, max_new_tokens=12),
                        eng.generate(b, max_new_tokens=12))
                return outs
            finally:
                await eng.stop()

        return _run(go())

    jeng, teng = _jengine(tiny_f32, **kw), _engine(tiny_f32, **kw)
    assert serve(teng) == serve(jeng)
    js, ts = jeng.stats(), teng.stats()
    assert set(ts) == set(js)
    assert ts["kvtier_downpages"] > 0 and ts["kvtier_uppages"] > 0
    for key in [k for k in js if k.startswith(("kvtier_", "kvwire_"))
                and not k.endswith("_s")] + ["prefix_cache"]:
        assert ts[key] == js[key], key
    assert teng.kvtier_digest() == jeng.kvtier_digest()
    assert teng.kvtier_deltas(0) == jeng.kvtier_deltas(0)
    assert _strip_times(teng.drain_kvtier_decisions()) == \
        _strip_times(jeng.drain_kvtier_decisions())
    assert [(k, n) for k, _, n in teng.drain_kv_spills()] == \
        [(k, n) for k, _, n in jeng.drain_kv_spills()]


def test_adopt_and_uppage_move_no_pool_tensor(tiny_f32):
    """After warmup, an adopt and an up-page write the pool in place (every
    pool tensor and the table keep their addresses) and build nothing: the
    windows captured over those addresses stay valid."""
    prompt = [(i * 13) % 400 + 2 for i in range(75)]
    src = _engine(tiny_f32)
    want = _gen(src, prompt)
    payload = src.export_prefix_kv(prompt)
    eng = _engine(tiny_f32, kv_host_pool_mb=8)
    eng.warmup()
    ptrs = _ptrs(eng.kv_cache)

    async def go():
        await eng.start()
        try:
            assert eng.adopt_kv(payload)
            first = await eng.generate(prompt, max_new_tokens=8)
            _downpage_prompt_entry(eng, prompt)
            second = await eng.generate(prompt, max_new_tokens=8)
            return first, second
        finally:
            await eng.stop()

    first, second = _run(go())
    assert first == second == want
    st = eng.stats()
    assert st["kvwire_import_hits"] == 1 and st["kvtier_uppages"] == 1
    assert _ptrs(eng.kv_cache) == ptrs
    assert st["graph_compiles_post_warmup"] == 0
