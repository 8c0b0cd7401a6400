"""The port's host-side KV bookkeeping against the JAX package's: on the
same scripted traces, ``tpu9_torch.serving.paged_kv`` (block allocator,
prefix cache), ``tpu9_torch.serving.kvpool`` (pool and table) and
``tpu9_torch.serving.schedule`` (window sizes) make the same decisions as
their ``tpu9.serving`` counterparts. These are exact: no arithmetic is
involved, so every block id, eviction and window size must be equal. The
int8 pool's device side (the quantizing splice and the dequantizing
prefix gather) is held bit-exact against the JAX graphs.
"""

import asyncio
import collections
import dataclasses
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu9.models.llama import LLAMA_PRESETS as JAX_PRESETS
from tpu9.serving import graphs as jgraphs
from tpu9.serving import kvpool as jkvpool
from tpu9.serving import paged_kv as jpaged_kv
from tpu9.serving import schedule as jschedule
from tpu9.serving.engine import EngineConfig as JaxEngineConfig
from tpu9.serving.shard.policy import SingleDevicePolicy
from tpu9_torch.models.llama import LLAMA_PRESETS
from tpu9_torch.serving import kvpool as tkvpool
from tpu9_torch.serving import paged_kv as tpaged_kv
from tpu9_torch.serving import schedule as tschedule
from tpu9_torch.serving.engine import EngineConfig
from tpu9_torch.serving.graphs import GraphFactory

torch.set_num_threads(2)

BS = 4


def _trace(mod, seed: int, steps: int = 250) -> list:
    """Admissions (lookup, pin, retain, alloc with eviction on demand,
    insert), retirements, reservations and pinned lookups held across an
    eviction, drawn from ``seed``; returns every decision and the
    allocator/cache state after each step."""
    rng = np.random.default_rng(seed)
    alloc = mod.BlockAllocator(24, BS)
    cache = mod.PrefixCache(alloc, 10)
    stems = [rng.integers(0, 5, 16).tolist() for _ in range(3)]
    held: list[list[int]] = []
    reserved: list[int] = []
    log = []

    def prompt():
        # a shared stem of 0-4 whole blocks, then a short private tail
        stem = stems[int(rng.integers(3))][:BS * int(rng.integers(0, 5))]
        return stem + rng.integers(5, 9, int(rng.integers(1, BS))).tolist()

    for _ in range(steps):
        op = int(rng.integers(0, 5))
        if op == 0:
            p = prompt()
            entry = cache.lookup(p)
            shared = list(entry.blocks) if entry else []
            alloc.retain(shared)
            if entry is not None:
                cache.release_pin(entry)
            need = max(0, mod.blocks_for(len(p) + 1, BS) - len(shared))
            got = alloc.alloc(need)
            if got is None:
                cache.evict_for_space(need)
                got = alloc.alloc(need)
            if got is None:
                alloc.release(shared)
                log.append(("full", len(p), need))
            else:
                held.append(shared + got)
                cache.insert(p, held[-1])
                log.append(("admit", len(p), len(shared), tuple(held[-1])))
        elif op == 1 and held:
            blocks = held.pop(int(rng.integers(len(held))))
            alloc.release(blocks)
            log.append(("retire", tuple(blocks)))
        elif op == 2:
            n = int(rng.integers(1, 60))
            ok = alloc.can_reserve(n)
            if ok:
                reserved.append(alloc.reserve(n))
            log.append(("reserve", n, ok))
        elif op == 3 and reserved:
            alloc.unreserve(reserved.pop(0))
        elif op == 4:
            p = prompt()
            entry = cache.lookup(p)
            cache.evict_for_space(alloc.free_count + 2)
            if entry is not None:
                # a pinned entry survives any eviction
                assert cache.contains(entry.key)
                log.append(("pinned", entry.n_tokens, tuple(entry.blocks)))
                cache.release_pin(entry)
        log.append((alloc.free_count, alloc.used_count, alloc.reserved,
                    cache.held_blocks, cache.stats()))
    return log


@pytest.mark.parametrize("seed", range(4))
def test_allocator_and_prefix_cache_decisions_match(seed):
    want = _trace(jpaged_kv, seed)
    got = _trace(tpaged_kv, seed)
    keys = set(got[-1][-1])
    assert keys <= set(want[-1][-1])          # the port keeps a subset
    want = [e[:-1] + ({k: e[-1][k] for k in keys},)
            if isinstance(e[-1], dict) else e for e in want]
    assert got == want
    assert any(e[0] == "admit" and e[2] > 0 for e in got)  # reuse happened


def test_refcount_faults_raise_in_both():
    for mod in (jpaged_kv, tpaged_kv):
        a = mod.BlockAllocator(4, BS)
        blocks = a.alloc(2)
        a.release(blocks)
        with pytest.raises(AssertionError):
            a.release(blocks[:1])
        with pytest.raises(AssertionError):
            a.unreserve(1)


def test_block_sizing_matches():
    jcfg = JAX_PRESETS["llama3-8b"]
    tcfg = LLAMA_PRESETS["llama3-8b"]
    for bs in (16, 128, 256):
        assert tpaged_kv.kv_block_bytes(tcfg, bs) == \
            jpaged_kv.kv_block_bytes(jcfg, bs)
    for n in (0, 1, 127, 128, 129):
        assert tpaged_kv.blocks_for(n, 128) == jpaged_kv.blocks_for(n, 128)


@pytest.mark.parametrize("preset", ["llama-tiny", "llama-1b", "llama3-8b"])
@pytest.mark.parametrize("quantized", [False, True])
def test_block_bytes_match_for_both_pool_types(preset, quantized):
    jcfg, tcfg = JAX_PRESETS[preset], LLAMA_PRESETS[preset]
    for bs in (8, 128, 256):
        assert tpaged_kv.kv_block_bytes(tcfg, bs, quantized) == \
            jpaged_kv.kv_block_bytes(jcfg, bs, quantized)
    if preset == "llama3-8b":
        # the flagship int8 pool holds 1.94x the blocks of a bf16 one
        ratio = (tpaged_kv.kv_block_bytes(tcfg, 128, False)
                 / tpaged_kv.kv_block_bytes(tcfg, 128, True))
        assert ratio > 1.9


def _pools(kv_quant=False, **kw):
    base = dict(max_batch=3, max_seq_len=32, kv_block_size=BS,
                prefix_cache_blocks=6)
    base.update(kw)
    jcfg = dataclasses.replace(JAX_PRESETS["llama-tiny"], dtype=jnp.float32)
    tcfg = dataclasses.replace(LLAMA_PRESETS["llama-tiny"],
                               dtype=torch.float32)
    jpool = jkvpool.KvPool(jcfg, JaxEngineConfig(**base), kv_quant,
                           SingleDevicePolicy())
    tpool = tkvpool.KvPool(tcfg, EngineConfig(**base), torch.device("cpu"),
                           kv_quant)
    return jpool, tpool


@pytest.mark.parametrize("pool_blocks", [0, 12])
def test_int8_pool_sizing_and_planes_match(pool_blocks):
    """Auto sizing spends the bf16 pool's bytes on int8 blocks; an explicit
    size is taken as given. Both packages count the same blocks and lay
    out the same planes."""
    jpool, tpool = _pools(kv_quant=True, kv_pool_blocks=pool_blocks)
    assert (tpool.n_blocks, tpool.mb, tpool.trash_block) == \
        (jpool.n_blocks, jpool.mb, jpool.trash_block)
    if pool_blocks == 0:
        _, bf16 = _pools(kv_pool_blocks=0)
        assert tpool.n_blocks - 1 > 1.5 * (bf16.n_blocks - 1)
    arrays = tpool.init_arrays()
    want = jpool.array_shapes()
    assert set(arrays) == set(want)
    for name, t in arrays.items():
        shape, dt = want[name]
        assert tuple(t.shape) == tuple(shape), name
        assert str(t.dtype).removeprefix("torch.") == jnp.dtype(dt).name, name


def test_int8_splice_and_prefix_gather_match_jax_graphs():
    """One chunk of a scratch quantized into int8 pool blocks (payload and
    scale planes), then the slot's row densified back into the scratch
    with dequantization: both equal the JAX graphs' bit for bit."""
    c, s = 2 * BS, 32
    base = dict(max_batch=2, max_seq_len=s, kv_block_size=BS,
                prefill_chunk=c, kv_quant="int8")
    jcfg = dataclasses.replace(JAX_PRESETS["llama-tiny"], dtype=jnp.float32)
    tcfg = dataclasses.replace(LLAMA_PRESETS["llama-tiny"],
                               dtype=torch.float32)
    jg = jgraphs.GraphFactory(jcfg, JaxEngineConfig(**base),
                              SingleDevicePolicy(), c, kv_quant=True)
    tg = GraphFactory(tcfg, EngineConfig(**base), c, torch.device("cpu"))
    rng = np.random.default_rng(7)
    n_blocks = 6
    shape = (tcfg.n_layers, n_blocks, BS, tcfg.n_kv_heads, tcfg.head_dim)
    zeros = {"k": np.zeros(shape, np.int8), "v": np.zeros(shape, np.int8),
             "k_scale": np.zeros(shape[:-1], np.float32),
             "v_scale": np.zeros(shape[:-1], np.float32)}
    scr_shape = (tcfg.n_layers, 1, s, tcfg.n_kv_heads, tcfg.head_dim)
    scratch = {n: rng.standard_normal(scr_shape).astype(np.float32)
               for n in ("k", "v")}
    scratch["k"][:, :, 3] = 0.0                   # a zero vector
    tpool = {n: torch.from_numpy(a.copy()) for n, a in zeros.items()}
    jpool = {n: jnp.asarray(a) for n, a in zeros.items()}
    for offset, phys in ((0, [4, 1]), (c, [2, 5])):
        tg.traced_splice(tpool, torch.from_numpy(scratch["k"]),
                         torch.from_numpy(scratch["v"]),
                         torch.tensor([offset], dtype=torch.int32),
                         torch.tensor(phys, dtype=torch.int32))
        jpool = jg.traced_splice(jpool, jnp.asarray(scratch["k"]),
                                 jnp.asarray(scratch["v"]), offset,
                                 jnp.asarray(phys, jnp.int32))
    for name in zeros:
        assert tpool[name].dtype == (torch.int8 if name in "kv"
                                     else torch.float32)
        np.testing.assert_array_equal(tpool[name].numpy(),
                                      np.asarray(jpool[name]))
    row = np.zeros((s // BS + 1,), np.int32)      # trash past the prefix
    row[:4] = [4, 1, 2, 5]
    got = tg.gather_fn()(tpool, torch.from_numpy(row), {
        n: torch.zeros(scr_shape) for n in ("k", "v")})
    want = jg.gather_fn()(jpool, jnp.asarray(row))
    for name in ("k", "v"):
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]))
        # the spliced prefix comes back within the int8 bound
        err = np.abs(got[name].numpy() - scratch[name])[:, :, :2 * c]
        assert float(err.max()) <= float(np.abs(scratch[name]).max()) / 127


@pytest.mark.parametrize("pool_blocks", [0, 12])
def test_kv_pool_tables_match(pool_blocks):
    jpool, tpool = _pools(kv_pool_blocks=pool_blocks)
    assert (tpool.n_blocks, tpool.mb, tpool.trash_block) == \
        (jpool.n_blocks, jpool.mb, jpool.trash_block)
    assert tpool.trash_block == 0 and tpool.mb == 32 // BS + 1
    arrays = tpool.init_arrays()
    assert tuple(arrays["k"].shape) == (2, tpool.n_blocks, BS, 2, 32)
    assert tuple(arrays["table"].shape) == (3, tpool.mb)
    rng = np.random.default_rng(pool_blocks)
    for step in range(40):
        slot = int(rng.integers(3))
        if rng.random() < 0.7:
            n = int(rng.integers(1, 33))
            if jpool.allocator.can_reserve(n) and not jpool.slot_reserved[slot]:
                for p in (jpool, tpool):
                    p.slot_reserved[slot] = p.allocator.reserve(n)
            need = (jpaged_kv.blocks_for(min(n, 32), BS)
                    - len(jpool.slot_blocks[slot]))
            if need <= jpool.allocator.free_count:
                assert tpool.ensure_slot_blocks(slot, min(n, 32)) == \
                    jpool.ensure_slot_blocks(slot, min(n, 32))
            jt, tt = jpool.push_table(slot), tpool.push_table(slot)
        else:
            jt, tt = jpool.release_slot(slot), tpool.release_slot(slot)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        assert tpool.slot_blocks == jpool.slot_blocks
        assert tpool.kv_allocs == jpool.kv_allocs
        # an unused lane's row is all trash
        for s in range(3):
            if not tpool.slot_blocks[s]:
                assert not tt[s].any()


def _fake_engine(rng, steps=(1, 4, 16)):
    """The scheduling state both schedulers read, with a random batch."""
    b, s = 4, 64
    active = rng.random(b) < 0.7
    reqs = [SimpleNamespace(max_new_tokens=int(rng.integers(1, 40)),
                            generated=[0] * int(rng.integers(0, 10)),
                            prompt=[0] * int(rng.integers(1, 30)))
            if a else None for a in active]
    queue = asyncio.Queue()
    queue._queue = collections.deque(
        [SimpleNamespace(prompt=[0] * 8, max_new_tokens=8)]
        if rng.random() < 0.5 else [])
    room = rng.random() < 0.5
    return SimpleNamespace(
        paged=True, active=active, slot_req=reqs, _wait_room=[],
        _queue=queue, _room_for=lambda req: room,
        _inflight_steps=int(rng.integers(0, 8)),
        _host_len=rng.integers(0, s, b), _pick_reason="",
        ecfg=SimpleNamespace(decode_steps=steps, max_batch=b,
                             max_seq_len=s))


@pytest.mark.parametrize("steps", [(1, 4, 16), (1, 8, 32)])
def test_window_scheduler_picks_match(steps):
    rng = np.random.default_rng(len(steps) + steps[-1])
    for _ in range(200):
        e = _fake_engine(rng, steps)
        j, t = jschedule.WindowScheduler(e), tschedule.WindowScheduler(e)
        assert t.admission_can_proceed() == j.admission_can_proceed()
        assert t.pick_steps() == j.pick_steps()
