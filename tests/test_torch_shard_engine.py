"""The port's sharded serving engine on the CPU: the mirrors of
``tests/test_multichip_serving.py``'s engine cells on llama-tiny at f32,
with every rank on the CPU (``devices=["cpu"] * n``), judged by that
file's ``_assert_parity`` rule (token for token, a fork judged against
the full-context oracle's argmax margin), and the cross-package cell: the
port's tp=2 paged engine against the JAX paged engine under
``make_policy("2x1")`` on the 8 host devices.

Besides: a 1x1 policy leaves the engine as it was (the same keys, the
same launches, the same streams, no topology on its flight records), the
dense engine at tp=2, compile-ahead at tp=2 (``bind_params`` keeps every
rank shard's ``data_ptr``; streams equal a serial build's), and a kvwire
export of a tp=2 engine adopted by a tp=1 and a tp=2 engine (the same
tokens, the re-export byte for byte).
"""

import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu9.models import init_decoder as jax_init_decoder
from tpu9.models.llama import LLAMA_PRESETS as JAX_LLAMA
from tpu9.serving.engine import EngineConfig as JaxEngineConfig
from tpu9.serving.engine import InferenceEngine as JaxEngine
from tpu9.serving.shard import make_policy as jax_make_policy
from tpu9_torch.bridge import params_from_jax
from tpu9_torch.models.llama import LLAMA_PRESETS
from tpu9_torch.models.transformer import decoder_forward, init_decoder
from tpu9_torch.ops import paged_attention as tpaged
from tpu9_torch.parallel.sharding import (RankParams, Ranked, placed_leaves,
                                          ranks)
from tpu9_torch.serving import kvwire
from tpu9_torch.serving.engine import EngineConfig, InferenceEngine
from tpu9_torch.serving.presets import load_engine
from tpu9_torch.serving.shard import MeshPolicy, Topology, make_policy

torch.set_num_threads(2)

TINY = dataclasses.replace(LLAMA_PRESETS["llama-tiny"], dtype=torch.float32)
CPU8 = ["cpu"] * 8


@pytest.fixture(scope="module")
def tiny():
    jcfg = dataclasses.replace(JAX_LLAMA["llama-tiny"], dtype=jnp.float32)
    jparams = jax_init_decoder(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              "cpu")
    return jcfg, jparams, tparams


@pytest.fixture
def jax_table_copies(monkeypatch):
    """The JAX paged engine's block table handed over as a copy at each
    push (the reference's ``device_table`` may wrap the pool's host table,
    which each push rewrites in place, so a window dispatched before an
    admission could read the admitted slot's new row; ROADMAP C8). The
    port copies its table. Both policies' hooks, since a tp=2 engine
    places its table through the mesh policy."""
    from jax.sharding import NamedSharding, PartitionSpec
    from tpu9.serving.shard.policy import MeshPolicy as JaxMesh
    from tpu9.serving.shard.policy import SingleDevicePolicy as JaxSingle
    monkeypatch.setattr(
        JaxSingle, "device_table",
        lambda policy, table: jnp.asarray(np.array(table, copy=True)))
    monkeypatch.setattr(
        JaxMesh, "device_table",
        lambda policy, table: jax.device_put(
            jnp.asarray(np.array(table, copy=True)),
            NamedSharding(policy.mesh, PartitionSpec())))


BASE = dict(max_batch=2, max_seq_len=256, prefill_buckets=(32, 64),
            decode_steps=(1, 4), kv_block_size=32, kv_pool_blocks=16,
            prefill_chunk=32)


def _engine(params, topology=None, **kw):
    cfg = dict(BASE, **kw)
    policy = make_policy(topology, devices=CPU8)
    return InferenceEngine(params, TINY, EngineConfig(**cfg), policy=policy)


def _run(coro):
    return asyncio.run(coro)


def _generate_all(engine, jobs):
    async def go():
        await engine.start()
        outs = await asyncio.gather(*[
            engine.generate(list(p), max_new_tokens=n) for p, n in jobs])
        await engine.stop()
        return outs

    return _run(go())


JOBS = ([3, 1, 4, 1, 5, 9, 2, 6], 12), (list(range(2, 40)), 8)
CYCLER = [7, 8, 9, 7, 8, 9, 7, 8]


def _margin_vs_oracle(params, prompt, prefix, tok) -> float:
    toks = torch.tensor([list(prompt) + prefix])
    logits = decoder_forward(params, toks, TINY)[0, -1]
    return float(logits.max() - logits[tok])


def _assert_parity(params, jobs, ref_outs, outs):
    """Token for token, a fork judged against the full-context oracle's
    argmax margin (the reference's rule: sharded reductions may
    reassociate)."""
    for (prompt, _), a, b in zip(jobs, ref_outs, outs):
        assert len(a) == len(b)
        for i, (x, y) in enumerate(zip(a, b)):
            if x != y:
                margin = _margin_vs_oracle(params, prompt, b[:i], y)
                assert margin < 0.35, (i, margin)
                break


# -- the mirrors -----------------------------------------------------------------

def test_1x1_policy_is_the_unsharded_engine(tiny, monkeypatch):
    """A 1x1 policy is the identity: the same storage types, the same
    capture keys, the same decode-kernel launches (a head_dim-64 config
    reaches the paged wrapper, counted here), the same streams, and
    flight records without a topology."""
    _, _, params = tiny
    calls = {"n": 0}
    twin = tpaged.paged_decode_attention

    def counting(*a, **k):
        calls["n"] += 1
        return twin(*a, **k)

    monkeypatch.setattr(tpaged, "paged_decode_attention", counting)
    cfg = dataclasses.replace(TINY, head_dim=64)
    p64 = init_decoder(cfg, torch.Generator().manual_seed(1), "cpu")
    results = []
    for policy in (None, make_policy("1x1", devices=["cpu"])):
        calls["n"] = 0
        e = InferenceEngine(p64, cfg, EngineConfig(**BASE), device="cpu",
                            policy=policy)
        assert isinstance(e.kv_cache, dict) and e.params is p64
        e.warmup()
        outs = _generate_all(e, JOBS)
        results.append((sorted(map(str, e.graphs.compiled)), calls["n"],
                        outs, [sorted(r) for r in e.flight_records()]))
        assert all("tp" not in r for r in e.flight_records())
        st = e.stats()
        assert (st["topo_tp"], st["topo_fsdp"], st["topo_n_chips"]) == (1, 1,
                                                                         1)
    assert results[0] == results[1]
    assert results[0][1] > 0


def test_engine_refuses_oversubscribed_mesh():
    with pytest.raises(ValueError, match="devices"):
        make_policy("4x4", devices=CPU8)


def test_tp2_greedy_parity(tiny):
    """tp=2 paged engine against the single-device one (llama-tiny has 2
    kv heads: each rank holds one head's KV)."""
    _, _, params = tiny
    ref = _generate_all(_engine(params), JOBS)
    eng = _engine(params, topology="2x1")
    assert isinstance(eng.policy, MeshPolicy)
    _assert_parity(params, JOBS, ref, _generate_all(eng, JOBS))


def test_tp2xfsdp2_greedy_parity(tiny):
    _, _, params = tiny
    ref = _generate_all(_engine(params), JOBS)
    eng = _engine(params, topology="2x2")
    assert len(eng.policy.devices) == 4
    _assert_parity(params, JOBS, ref, _generate_all(eng, JOBS))


def test_tp2_weights_and_kv_actually_sharded(tiny):
    _, _, params = tiny
    eng = _engine(params, topology="2x1")
    assert isinstance(eng.params, RankParams) and len(eng.params) == 2
    wo = params["layers"][0]["wo"]                 # row parallel [HDh, D]
    for r, shard in enumerate(eng.params):
        assert shard["layers"][0]["wo"].shape[0] == wo.shape[0] // 2
        assert torch.equal(shard["layers"][0]["wo"],
                           wo[r * wo.shape[0] // 2:(r + 1) * wo.shape[0] // 2])
    assert isinstance(eng.kv_cache, Ranked)
    for rank in eng.kv_cache:
        for name in ("k", "v"):
            assert rank[name].shape[-2] == TINY.n_kv_heads // 2
    # the block table: global block ids, the same on every rank
    assert eng.kv_cache[0]["table"] is eng.kv_cache[1]["table"]
    assert eng._scratch[0]["k"].shape[-2] == TINY.n_kv_heads // 2


def test_engine_places_raw_params_through_policy(tiny):
    _, _, params = tiny
    eng = InferenceEngine(params, TINY, EngineConfig(**BASE),
                          policy=make_policy("2x1", devices=CPU8))
    wo = eng.params[0]["layers"][0]["wo"]
    assert wo.shape[0] == params["layers"][0]["wo"].shape[0] // 2
    # an already-placed tree passes through
    again = InferenceEngine(eng.params, TINY, EngineConfig(**BASE),
                            policy=eng.policy)
    assert again.params is eng.params


def test_non_dividing_tp_rejected_at_bind(tiny):
    _, _, params = tiny
    with pytest.raises(ValueError, match="n_kv_heads"):
        InferenceEngine(params, TINY, EngineConfig(**BASE),
                        policy=make_policy("3x1", devices=CPU8))


def test_sharded_spec_verify_parity(tiny):
    """Speculative decoding under tp=2 equals sharded classic decode (exact
    at f32: decode and verify share the head shard); the cyclic prompt
    makes prompt lookup propose, so verify windows run on the ranks."""
    _, _, params = tiny
    jobs = (CYCLER, 64), (list(range(2, 40)), 8)
    classic = _generate_all(_engine(params, topology="2x1"), jobs)
    spec_eng = _engine(params, topology="2x1", spec_len=4)
    outs = _generate_all(spec_eng, jobs)
    assert classic == outs
    assert spec_eng._stats["spec_proposed"] > 0


def test_sharded_int8_kv_parity(tiny):
    _, _, params = tiny
    ref = _generate_all(_engine(params, kv_quant="int8"), JOBS)
    eng = _engine(params, topology="2x1", kv_quant="int8")
    assert eng.kv_cache[0]["k_scale"].shape[-1] == TINY.n_kv_heads // 2
    assert eng.kv_cache[0]["k"].dtype == torch.int8
    _assert_parity(params, JOBS, ref, _generate_all(eng, JOBS))


def test_sharded_paged_kv_alloc_evict_prefix_reuse(tiny):
    _, _, params = tiny
    prefix = [(i * 5) % 200 + 1 for i in range(128)]
    cold = _engine(params, prefix_cache_blocks=0)
    warm = _engine(params, topology="2x1", prefix_cache_blocks=4)

    async def run(engine):
        await engine.start()
        a = await engine.generate(prefix + [7, 7, 7], max_new_tokens=5)
        b = await engine.generate(prefix + [9, 9, 9], max_new_tokens=5)
        await engine.stop()
        return a, b

    assert _run(run(cold)) == _run(run(warm))
    st = warm.prefix_cache.stats()
    assert st["hits"] >= 1
    assert st["tokens_reused"] >= 96
    held = warm.allocator.used_count - 1      # minus the trash block
    assert held <= st["held_blocks"], (held, st)
    other = [(i * 7) % 190 + 3 for i in range(128)]

    async def one(engine, prompt):
        await engine.start()
        out = await engine.generate(list(prompt), max_new_tokens=4)
        await engine.stop()
        return out

    _run(one(warm, other))
    assert warm.prefix_cache.evictions >= 1


def test_sharded_engine_stats_topology(tiny):
    _, _, params = tiny
    eng = _engine(params, topology="2x1")
    st = eng.stats()
    assert (st["topo_tp"], st["topo_fsdp"], st["topo_n_chips"]) == (2, 1, 2)
    assert "hbm_used_gb_per_chip" in st
    # per card: the weights over the two ranks
    one = _engine(params)
    assert st["decode_bytes_per_token_per_chip"] == \
        one.stats()["decode_bytes_per_token_per_chip"] / 2
    assert st["decode_flops_per_token_per_chip"] == \
        one.stats()["decode_flops_per_token_per_chip"] / 2
    st1 = one.stats()
    assert (st1["topo_tp"], st1["topo_n_chips"]) == (1, 1)
    assert _engine(params, topology="2x2").stats()["topo_n_chips"] == 4


def test_sharded_flight_records_carry_the_topology(tiny):
    _, _, params = tiny
    eng = _engine(params, topology="2x1")
    _generate_all(eng, JOBS[:1])
    recs = [r for r in eng.flight_records() if r.get("kind") == "decode"
            or "k" in r]
    assert recs and all((r["tp"], r["n_chips"]) == (2, 2) for r in recs)


def test_load_engine_topology_knob(monkeypatch):
    async def drive(engine):
        await engine.start()
        out = await engine.generate([5, 6, 7], max_new_tokens=3)
        await engine.stop()
        return out

    eng = load_engine("llama-tiny", devices=["cpu"] * 2, max_batch=2,
                      max_seq_len=256, topology="2x1")
    assert eng.policy.topology == Topology(2, 1)
    assert eng.policy.devices == [torch.device("cpu")] * 2
    assert len(_run(drive(eng))) == 3
    # device= names the one card of a 1x1 engine: every rank stacked on it
    # is asked for only through devices=
    with pytest.raises(ValueError, match="devices="):
        load_engine("llama-tiny", device="cpu", max_batch=2,
                    max_seq_len=256, topology="2x1")
    monkeypatch.setenv("TPU9_TOPOLOGY", "2x1")
    eng2 = load_engine("llama-tiny", devices=["cpu"] * 2, max_batch=2,
                       max_seq_len=256)
    assert eng2.policy.topology == Topology(2, 1)
    with pytest.raises(ValueError, match="devices="):
        load_engine("llama-tiny", device="cpu", max_batch=2,
                    max_seq_len=256)
    # devices= names the ranks' devices (repeats allowed)
    eng3 = load_engine("llama-tiny", max_batch=2, max_seq_len=256,
                       topology="2x2", devices=CPU8[:4])
    assert eng3.policy.describe() == {"tp": 2, "fsdp": 2, "n_chips": 4}
    monkeypatch.delenv("TPU9_TOPOLOGY")
    # a named slice plans: llama-tiny fits one card
    eng4 = load_engine("llama-tiny", device="cpu", max_batch=2,
                       max_seq_len=256, tpu="h100-8")
    assert eng4.policy.topology == Topology(1, 1)


# -- across packages ------------------------------------------------------------

@pytest.mark.multichip
@pytest.mark.usefixtures("jax_table_copies")
@pytest.mark.parametrize("kv_quant", ["", "int8"])
def test_tp2_streams_equal_the_jax_tp2_engine(tiny, kv_quant):
    """The port's tp=2 paged engine and the JAX paged engine under
    ``make_policy("2x1")`` (GSPMD over two of the 8 host devices) serve
    the same greedy streams, judged by the parity rule."""
    jcfg, jparams, params = tiny
    knobs = dict(BASE, kv_quant=kv_quant, prefix_cache_blocks=8)
    jpolicy = jax_make_policy("2x1")
    jeng = JaxEngine(jpolicy.place_params(jparams), jcfg,
                     JaxEngineConfig(**knobs), policy=jpolicy)
    teng = InferenceEngine(params, TINY, EngineConfig(**knobs),
                           policy=make_policy("2x1", devices=CPU8))
    jobs = JOBS + ((list(range(2, 40)) + [5, 5], 6),)
    want = _generate_all(jeng, jobs)
    got = _generate_all(teng, jobs)
    _assert_parity(params, jobs, want, got)
    assert teng.stats()["prefix_cache"]["hits"] == \
        jeng.stats()["prefix_cache"]["hits"]
    assert (teng.stats()["topo_tp"], teng.stats()["topo_n_chips"]) == (
        jeng.stats()["topo_tp"], jeng.stats()["topo_n_chips"])


# -- the dense engine, compile-ahead, kvwire --------------------------------------

DENSE = dict(max_batch=2, max_seq_len=256, prefill_buckets=(32, 64),
             decode_steps=(1, 4))


@pytest.mark.parametrize("topology", ["2x1", "2x2"])
def test_dense_engine_tp2_parity(tiny, topology):
    _, _, params = tiny
    ref = _generate_all(InferenceEngine(params, TINY, EngineConfig(**DENSE),
                                        device="cpu"), JOBS)
    eng = InferenceEngine(params, TINY, EngineConfig(**DENSE),
                          policy=make_policy(topology, devices=CPU8))
    assert not eng.paged and isinstance(eng.kv_cache, Ranked)
    assert eng.kv_cache[1]["k"].shape == (TINY.n_layers, 2, 256, 1,
                                          TINY.head_dim)
    _assert_parity(params, JOBS, ref, _generate_all(eng, JOBS))


def _ptrs(params) -> dict:
    return {path: t.data_ptr() for path, t, _ in placed_leaves(params)}


@pytest.mark.parametrize("paged", [True, False])
def test_compile_ahead_tp2_binds_in_place(paged):
    """``load_engine(compile_ahead=True)`` at tp=2: the engine is built on
    the preset's abstract tree (meta rank shards), precompiled over
    zero-filled shards, then the drawn weights are bound into each shard
    in place: every shard keeps its ``data_ptr``, and the streams equal a
    serial build's over the same seed."""
    knobs = dict(devices=["cpu"] * 2, max_batch=2, max_seq_len=256,
                 prefill_buckets=(32, 64), decode_steps=(1, 4),
                 paged=paged, topology="2x1")
    seen = {}
    real_bind = InferenceEngine.bind_params

    def bind(self, params, part=None):
        seen.setdefault("before", _ptrs(self.params))
        real_bind(self, params, part=part)
        seen["after"] = _ptrs(self.params)

    InferenceEngine.bind_params = bind
    try:
        ahead = load_engine("llama-tiny", compile_ahead=True, **knobs)
    finally:
        InferenceEngine.bind_params = real_bind
    assert seen["before"] == seen["after"] and len(seen["after"]) > 10
    assert set(ahead.bringup) == {"load_s", "compile_ahead_s", "bind_s",
                                  "compile_overlap_s"}
    built = ahead.graphs.compiles
    ahead.warmup()
    assert ahead.graphs.compiles == built
    serial = load_engine("llama-tiny", **knobs)
    for (pa, ta, _), (pb, tb, _) in zip(placed_leaves(ahead.params),
                                        placed_leaves(serial.params)):
        assert pa == pb and torch.equal(ta, tb), pa
    assert _generate_all(ahead, JOBS) == _generate_all(serial, JOBS)


@pytest.mark.parametrize("preset", ["llama-tiny", "llama-tiny-int8"])
def test_sharded_load_holds_one_part_of_the_tree(preset, monkeypatch):
    """``load_engine`` at tp=2 draws the weights part by part on rank 0's
    device and binds each into the rank shards before the next is drawn:
    the engine never receives the whole tree, no full leaf of a part
    already bound is alive when a part is bound or a tensor is drawn (so
    the device holds the shards and one part), every part is bound once,
    and the shards equal the slices of the 1x1 tree drawn from the same
    seed."""
    import weakref
    from tpu9_torch.parallel.sharding import named_leaves, tree_parts
    from tpu9_torch.serving.presets import build_params
    real_bind = InferenceEngine.bind_params
    earlier: list = []
    parts: list = []

    def none_alive(where):
        alive = [ref for ref in earlier if ref() is not None]
        assert not alive, f"{len(alive)} bound full leaves alive at {where}"

    def bind(self, params, part=None):
        assert part is not None, "the whole tree was bound"
        none_alive(part)
        real_bind(self, params, part=part)
        earlier.extend(weakref.ref(t) for _, t in named_leaves(params))
        parts.append(part)

    def drawing(draw):
        def checked(*args, **kwargs):
            none_alive(f"a draw after {parts[-1:]}")
            return draw(*args, **kwargs)
        return checked

    monkeypatch.setattr(InferenceEngine, "bind_params", bind)
    for name in ("randn", "rand", "randint"):
        monkeypatch.setattr(torch, name, drawing(getattr(torch, name)))
    eng = load_engine(preset, devices=["cpu"] * 2, topology="2x1",
                      max_batch=2, max_seq_len=256)
    monkeypatch.undo()
    assert not [ref for ref in earlier if ref() is not None]
    full, _ = build_params(preset, seed=0, device="cpu")
    assert sorted(parts) == sorted(name for name, _ in tree_parts(full))
    want = make_policy("2x1", devices=["cpu"] * 2).place_params(full,
                                                                eng.cfg)
    for (pa, ta, _), (pb, tb, _) in zip(placed_leaves(eng.params),
                                        placed_leaves(want)):
        assert pa == pb and torch.equal(ta, tb), pa


def test_hbm_prediction_follows_the_placement(tiny):
    """The predicted HBM is the busiest device's: two ranks on one device
    hold what the 1x1 engine holds there (shards summing to the tree,
    the replicated leaves and the table placed once), where dividing the
    tree by the chip count would halve the weights."""
    _, _, params = tiny
    one = _engine(params).hbm_predicted_gb_per_chip
    tree = sum(t.numel() * t.element_size()
               for _, t, _ in placed_leaves(_engine(params, "2x1").params))
    for topology in ("2x1", "2x2"):
        eng = InferenceEngine(params, TINY, EngineConfig(**BASE),
                              policy=make_policy(topology, devices=CPU8))
        assert eng.hbm_predicted_gb_per_chip == one, topology
    assert one > 0 and tree > 0


def test_bind_params_names_a_mismatched_shard(tiny):
    _, _, params = tiny
    from tpu9_torch.serving.engine import abstract_params
    eng = InferenceEngine(abstract_params(params), TINY, EngineConfig(**BASE),
                          policy=make_policy("2x1", devices=CPU8))
    bad = dict(params, final_norm=torch.zeros(3))
    with pytest.raises(ValueError, match="final_norm"):
        eng.bind_params(bad)
    eng.bind_params(params)
    assert torch.equal(eng.params[1]["layers"][0]["wo"],
                       params["layers"][0]["wo"][64:])


def _export_engine(params, topology, prompt):
    eng = _engine(params, topology=topology, prefix_cache_blocks=8)
    out = _generate_all(eng, [(prompt, 6)])[0]
    payload = eng.export_prefix_kv(prompt)
    assert payload is not None
    return eng, out, payload


@pytest.mark.parametrize("dst", [None, "2x1"])
def test_kvwire_tp2_export_adopted_by_tp1_and_tp2(tiny, dst):
    _, _, params = tiny
    prompt = [(i * 3) % 190 + 2 for i in range(70)]
    _, want, payload = _export_engine(params, "2x1", prompt)
    header = kvwire.decode_blocks(payload)[0]
    assert header["topology"] == {"tp": 2, "fsdp": 1, "n_chips": 2}
    # the same geometry as a tp=1 export: canonical full-head planes
    _, _, payload1 = _export_engine(params, None, prompt)
    h1 = kvwire.decode_blocks(payload1)[0]
    assert {k: v for k, v in header.items() if k != "topology"} == \
        {k: v for k, v in h1.items() if k != "topology"}
    eng = _engine(params, topology=dst, prefix_cache_blocks=8)
    ptrs = {n: t.data_ptr() for kv in ranks(eng.kv_cache)
            for n, t in kv.items()}
    assert eng.adopt_kv(payload)
    assert {n: t.data_ptr() for kv in ranks(eng.kv_cache)
            for n, t in kv.items()} == ptrs
    got = _generate_all(eng, [(prompt, 6)])[0]
    assert got == want
    assert eng.stats()["prefix_cache"]["hits"] >= 1
    back = eng.export_prefix_kv(prompt)
    hb, pb = kvwire.decode_blocks(back)
    h0, p0 = kvwire.decode_blocks(payload)
    assert hb.pop("topology") == eng.policy.describe()
    h0.pop("topology")
    assert hb == h0
    for name in p0:
        assert torch.equal(p0[name].view(torch.uint8),
                           pb[name].view(torch.uint8)), name
