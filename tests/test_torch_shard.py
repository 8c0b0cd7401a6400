"""The port's multi-GPU layer on the CPU, against the JAX package: the
topology planner and the feasibility arithmetic
(``tpu9_torch/serving/shard/plan.py``, ``tpu9_torch/serving/feasibility.py``
over a ``GpuSpec``), the layout table and ``fit_spec``
(``tpu9_torch/parallel/sharding.py``), the expert-sharded ``moe_ffn``, the
rank-by-rank decoder and the pool's head shards (``kvpool.py`` under a
``MeshPolicy``).

The host copies are held to the reference's own functions on equal
inputs: a ``GpuSpec`` priced by the port and a ``TpuSpec`` with the same
chips and GB per chip priced by the JAX package give the same budget, the
same plan and the same error text. The decoder over rank shards is held
to the unsharded decoder of both packages at f32 (the mirror of
``tests/test_models.py``'s mixtral-tiny tp × fsdp case at its
``rtol=atol=2e-4``), with ranks on ``["cpu"] * n``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu9.models import decoder_forward as jax_forward
from tpu9.models import init_decoder as jax_init_decoder
from tpu9.models.mixtral import MIXTRAL_PRESETS as JAX_MIXTRAL
from tpu9.models.llama import LLAMA_PRESETS as JAX_LLAMA
from tpu9.ops.quant import quantize_decoder as jax_quantize_decoder
from tpu9.parallel import decoder_param_specs as jax_param_specs
from tpu9.parallel import fit_spec as jax_fit_spec
from tpu9.parallel import make_mesh
from tpu9.serving import feasibility as jfeas
from tpu9.serving.engine import EngineConfig as JaxEngineConfig
from tpu9.serving.kvpool import KvPool as JaxKvPool
from tpu9.serving.paged_kv import PrefixCache as JaxPrefixCache
from tpu9.serving.shard import make_policy as jax_make_policy
from tpu9.serving.shard import plan as jplan
from tpu9.types import TpuSpec
from tpu9_torch.bridge import params_from_jax
from tpu9_torch.models.llama import LLAMA_PRESETS
from tpu9_torch.models.mixtral import MIXTRAL_PRESETS
from tpu9_torch.models.moe import MoeConfig, init_moe_layer, moe_ffn
from tpu9_torch.models.transformer import decoder_forward, init_kv_cache
from tpu9_torch.parallel.sharding import (P, Pieces, RankParams, Ranked,
                                          decoder_param_specs, fit_spec,
                                          rank_layout, reduce_partials)
from tpu9_torch.serving import feasibility as tfeas
from tpu9_torch.serving import kvwire
from tpu9_torch.serving.engine import EngineConfig
from tpu9_torch.serving.kvpool import KvPool
from tpu9_torch.serving.paged_kv import PrefixCache
from tpu9_torch.serving.shard import (MeshPolicy, SingleDevicePolicy,
                                      Topology, candidate_topologies,
                                      make_policy, parse_topology,
                                      plan_topology, resolve_topology)
from tpu9_torch.types import GPU_REGISTRY, InvalidGpuSpec, parse_gpu_spec

torch.set_num_threads(2)

CPU8 = ["cpu"] * 8


def _tpu_twin(gpu: str) -> TpuSpec:
    """A TpuSpec with a GpuSpec's name, chips and GB per chip: the slice
    the reference prices as the port prices the GPU slice."""
    g = GPU_REGISTRY[gpu]
    return TpuSpec(g.name, "v5p", g.chips, g.hosts, f"1x{g.chips}",
                   hbm_gb_per_chip=g.hbm_gb_per_chip,
                   bf16_tflops_per_chip=g.bf16_tflops_per_chip)


@pytest.fixture
def cached_jax_weight_bytes(monkeypatch):
    """The reference's ``weight_bytes`` traces a preset's init on every
    call; the tests price each preset many times, so its answers are
    memoized for the test (the function itself is untouched)."""
    monkeypatch.setattr(jfeas, "weight_bytes",
                        functools.lru_cache(jfeas.weight_bytes))


# -- topology syntax, the resolve chain, candidates ----------------------------

@pytest.mark.parametrize("text", ["2", "2x4", "tp=2,fsdp=4", "fsdp=2",
                                  "TP=4", " 8x1 ", "1x1", "4"])
def test_parse_topology_matches_the_reference(text):
    got, want = parse_topology(text), jplan.parse_topology(text)
    assert (got.tp, got.fsdp) == (want.tp, want.fsdp)
    assert got.as_dict() == want.as_dict() and str(got) == str(want)
    assert (got.n_chips, got.is_single) == (want.n_chips, want.is_single)


def test_parse_topology_passthrough_and_errors():
    assert parse_topology(None) is None and parse_topology("") is None
    t = Topology(tp=4)
    assert parse_topology(t) is t
    for bad in ("dp=2", "tp=2,pp=2"):
        with pytest.raises(ValueError) as got:
            parse_topology(bad)
        with pytest.raises(ValueError) as want:
            jplan.parse_topology(bad)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError):
        Topology(tp=0)
    assert Topology(2, 4).n_chips == 8 and Topology(1, 1).is_single
    assert Topology(2, 1).as_dict() == {"tp": 2, "fsdp": 1, "n_chips": 2}


def test_resolve_topology_chain(monkeypatch, cached_jax_weight_bytes):
    # explicit beats env beats the default, in both packages
    monkeypatch.setenv("TPU9_TOPOLOGY", "4x1")
    assert resolve_topology("2x1") == Topology(2, 1)
    assert resolve_topology(None) == Topology(4, 1)
    assert jplan.resolve_topology(None).tp == 4
    monkeypatch.delenv("TPU9_TOPOLOGY")
    assert resolve_topology(None) == Topology(1, 1)
    # auto needs a slice to price against
    with pytest.raises(ValueError, match="auto"):
        resolve_topology("auto", preset="llama3-8b")
    for preset in ("llama3-8b", "llama3-70b"):
        got = resolve_topology("auto", preset=preset, tpu="h100-8")
        want = jplan.resolve_topology("auto", preset=preset,
                                      tpu=_tpu_twin("h100-8"))
        assert (got.tp, got.fsdp) == (want.tp, want.fsdp)
    assert resolve_topology("auto", preset="llama3-70b",
                            tpu="h100-8") == Topology(4, 1)
    # a named slice plans when no topology is given; env auto likewise
    assert resolve_topology(None, preset="llama3-70b",
                            tpu="h100-8") == Topology(4, 1)
    monkeypatch.setenv("TPU9_TOPOLOGY", "auto")
    assert resolve_topology(None, preset="llama3-70b",
                            tpu=GPU_REGISTRY["h100-8"]) == Topology(4, 1)


@pytest.mark.parametrize("kv_heads", [1, 2, 3, 4, 8, 16])
@pytest.mark.parametrize("max_chips", [1, 2, 4, 8])
def test_candidate_topologies_match_the_reference(kv_heads, max_chips):
    got = candidate_topologies(kv_heads, max_chips)
    want = jplan.candidate_topologies(kv_heads, max_chips)
    assert [(t.tp, t.fsdp) for t in got] == [(t.tp, t.fsdp) for t in want]


def test_gpu_spec_registry():
    assert sorted(GPU_REGISTRY) == ["h100-1", "h100-2", "h100-4", "h100-8"]
    spec = parse_gpu_spec(" H100-4 ")
    assert (spec.chips, spec.hosts, spec.hbm_gb_per_chip) == (4, 1, 80)
    assert parse_gpu_spec("") is None and parse_gpu_spec(None) is None
    with pytest.raises(InvalidGpuSpec, match="h100-8"):
        parse_gpu_spec("v5e-8")


# -- feasibility: the reference's arithmetic over a GpuSpec --------------------

@pytest.mark.parametrize("preset", ["llama3-8b", "llama3-70b",
                                    "mixtral-8x7b"])
@pytest.mark.parametrize("quantize", [None, "int8"])
@pytest.mark.parametrize("kv_quant", [False, True])
def test_hbm_budget_equals_the_reference(preset, quantize, kv_quant,
                                         cached_jax_weight_bytes):
    for tp, fsdp in ((1, 1), (2, 1), (8, 1), (2, 2)):
        got = tfeas.hbm_budget(preset, "h100-8", tp=tp, fsdp=fsdp,
                               quantize=quantize, kv_quant=kv_quant)
        want = jfeas.hbm_budget(preset, _tpu_twin("h100-8"), tp=tp,
                                fsdp=fsdp, quantize=quantize,
                                kv_quant=kv_quant)
        g, w = got.as_dict(), want.as_dict()
        assert g.pop("gpu") == w.pop("tpu") == "h100-8"
        assert g == w, (tp, fsdp)
        assert got.required_gb_per_chip == want.required_gb_per_chip


def test_weight_and_kv_bytes_equal_the_reference():
    for name in ("llama-tiny", "llama3-8b", "mixtral-tiny"):
        presets = {**LLAMA_PRESETS, **MIXTRAL_PRESETS}
        jpresets = {**JAX_LLAMA, **JAX_MIXTRAL}
        for quantized in (False, True):
            assert tfeas.weight_bytes(presets[name], quantized) == \
                jfeas.weight_bytes(jpresets[name], quantized)
        for kvq in (False, True):
            assert tfeas.kv_cache_bytes(presets[name], 8, 2048, kvq) == \
                jfeas.kv_cache_bytes(jpresets[name], 8, 2048, kvq)


def test_budget_prices_fsdp_weight_only():
    tp2 = tfeas.hbm_budget("llama3-8b", "h100-8", tp=2, fsdp=1)
    tp2f2 = tfeas.hbm_budget("llama3-8b", "h100-8", tp=2, fsdp=2)
    assert tp2f2.weight_gb_per_chip == pytest.approx(
        tp2.weight_gb_per_chip / 2)
    assert tp2f2.kv_gb_per_chip == pytest.approx(tp2.kv_gb_per_chip)
    assert tp2f2.as_dict()["fsdp"] == 2


def test_planner_llama3_70b_on_eight_h100(cached_jax_weight_bytes):
    """llama3-70b in bf16 holds 141.1 GB of weights: one card needs 162 GB
    with its KV, scratch and 10% headroom, two cards 80.9 GB each, over
    the 80 GB of an H100; four cards need 40.5 GB each. So the plan is
    tp=4 (the 8 kv heads divide by 4), the smallest fit, with the two
    smaller candidates rejected: the reference's arithmetic."""
    plan = plan_topology("llama3-70b", "h100-8")
    assert plan.topology == Topology(4, 1)
    assert [t for t, _, _ in plan.rejected] == [Topology(1, 1),
                                                Topology(2, 1)]
    assert all(req > have == 80 for _, req, have in plan.rejected)
    assert plan.rejected[1][1] == pytest.approx(80.9, abs=0.1)
    assert plan.budget.required_gb_per_chip == pytest.approx(40.5, abs=0.1)
    want = jplan.plan_topology("llama3-70b", _tpu_twin("h100-8"))
    g, w = plan.as_dict(), want.as_dict()
    assert g["budget"].pop("gpu") == w["budget"].pop("tpu")
    assert g == w
    # int8 weights halve it: two cards suffice
    assert plan_topology("llama3-70b", "h100-8",
                         quantize="int8").topology == Topology(2, 1)
    # llama3-8b fits one card: spreading it would halve tokens/s a card
    assert plan_topology("llama3-8b", "h100-8").topology == Topology(1, 1)


def test_infeasible_error_text_equals_the_reference(cached_jax_weight_bytes):
    with pytest.raises(tfeas.InfeasibleDeployment) as got:
        plan_topology("llama3-70b", "h100-1")
    with pytest.raises(jfeas.InfeasibleDeployment) as want:
        jplan.plan_topology("llama3-70b", _tpu_twin("h100-1"))
    assert str(got.value) == str(want.value)
    assert "int8" in str(got.value)
    with pytest.raises(tfeas.InfeasibleDeployment) as got:
        tfeas.validate_llm_deployment("llama3-70b", "h100-2")
    with pytest.raises(jfeas.InfeasibleDeployment) as want:
        jfeas.validate_llm_deployment("llama3-70b", _tpu_twin("h100-2"))
    assert str(got.value) == str(want.value)
    ok = tfeas.validate_llm_deployment("llama3-8b", "h100-1")
    assert ok.fits and ok.as_dict()["gpu"] == "h100-1"


# -- the layout table ----------------------------------------------------------

def _jax_tree(cfg, quantized=False):
    params = jax_init_decoder(jax.random.PRNGKey(0), cfg)
    return jax_quantize_decoder(params) if quantized else params


def _spec_tuples(tree):
    """A spec tree (either package's) with each spec as a plain tuple."""
    if isinstance(tree, dict):
        return {k: _spec_tuples(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_spec_tuples(v) for v in tree]
    return tuple(tree)


@pytest.mark.parametrize("name,quantized", [("llama-tiny", False),
                                            ("llama-tiny", True),
                                            ("mixtral-tiny", False),
                                            ("mixtral-tiny", True)])
def test_decoder_param_specs_equal_the_reference(name, quantized):
    jcfg = {**JAX_LLAMA, **JAX_MIXTRAL}[name]
    jparams = _jax_tree(jcfg, quantized)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              "cpu")
    got = decoder_param_specs(tparams)
    want = jax_param_specs(jparams)
    assert _spec_tuples(got) == jax.tree_util.tree_map(
        tuple, want, is_leaf=lambda x: isinstance(x, tuple))


@pytest.mark.parametrize("shape", [(512, 128), (128, 256), (4, 128, 256),
                                   (6, 5), (128,), (2, 16, 4, 32)])
@pytest.mark.parametrize("spec", [("fsdp", "tp"), ("tp", "fsdp"),
                                  ("tp", None, None), (None, "tp"),
                                  (("tp", "fsdp"),), ()])
def test_fit_spec_equals_the_reference(shape, spec):
    from jax.sharding import PartitionSpec
    mesh = make_mesh(fsdp=2, tp=4)
    got = fit_spec(shape, P(*spec), {"tp": 4, "fsdp": 2})
    assert tuple(got) == tuple(jax_fit_spec(shape, PartitionSpec(*spec),
                                            mesh))


def test_rank_layout_of_the_served_shapes():
    llama = LLAMA_PRESETS["llama3-8b"]
    lay = rank_layout(llama, 2)
    assert (lay.attn, lay.q_heads, lay.kv_heads, lay.ffn, lay.head) == (
        "heads", 16, 4, True, True)
    rc = lay.rank_config(llama)
    assert (rc.n_heads, rc.n_kv_heads, rc.hidden_dim) == (16, 4, 7168)
    # tp past the kv heads: each rank a copy of the kv head its q heads read
    tiny = MIXTRAL_PRESETS["mixtral-tiny"]
    lay4 = rank_layout(tiny, 4)
    assert (lay4.attn, lay4.q_heads, lay4.kv_heads) == ("kv_copies", 1, 1)
    assert [lay4.kv_head_range(r) for r in range(4)] == [(0, 1), (0, 1),
                                                         (1, 2), (1, 2)]
    assert lay4.rank_config(tiny).n_experts == tiny.n_experts
    # nothing divides: every block replicated, computed on rank 0
    lay3 = rank_layout(LLAMA_PRESETS["llama-tiny"], 3)
    assert (lay3.attn, lay3.ffn, lay3.head) == ("replicated", False, False)
    # a tied head never splits
    assert not rank_layout(dataclasses.replace(llama, tie_embeddings=True),
                           2).head


# -- rank shards and the decoder over them ------------------------------------

@pytest.fixture(scope="module")
def tiny():
    jcfg = dataclasses.replace(JAX_LLAMA["llama-tiny"], dtype=jnp.float32)
    tcfg = dataclasses.replace(LLAMA_PRESETS["llama-tiny"],
                               dtype=torch.float32)
    jparams = jax_init_decoder(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              "cpu")
    return jcfg, tcfg, jparams, tparams


def test_shards_are_really_sliced(tiny):
    _, cfg, _, params = tiny
    rp = make_policy("2x2", devices=CPU8).place_params(params, cfg)
    assert isinstance(rp, RankParams) and len(rp) == 2
    wo = params["layers"][0]["wo"]                 # row parallel [HDh, D]
    for r, shard in enumerate(rp):
        layer = shard["layers"][0]
        # fsdp pieces on the other dimension, joined along it
        assert isinstance(layer["wo"], Pieces) and layer["wo"].dim == 1
        got = torch.cat(list(layer["wo"]), dim=1)
        half = wo.shape[0] // 2
        assert torch.equal(got, wo[r * half:(r + 1) * half])
        assert layer["wq"].dim == 0 and layer["wq"][0].shape == (
            cfg.dim // 2, cfg.n_heads * cfg.head_dim // 2)
        assert isinstance(layer["attn_norm"], torch.Tensor)
        assert shard["lm_head"][0].shape == (cfg.dim // 2,
                                             cfg.vocab_size // 2)
    # a replicated leaf on one device is one tensor, not a copy a rank
    assert rp[0]["final_norm"] is rp[1]["final_norm"]
    assert rp.global_nbytes == sum(
        t.numel() * t.element_size()
        for t in jax.tree_util.tree_leaves(params))


@pytest.mark.parametrize("topology", ["2x1", "2x2", "4x1", "4x2", "3x1",
                                      "8x1"])
def test_decoder_over_rank_shards_matches_unsharded(tiny, topology):
    jcfg, cfg, jparams, params = tiny
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (2, 16))
    want = np.asarray(jax_forward(jparams, jnp.asarray(toks, jnp.int32),
                                  jcfg))
    rp = make_policy(topology, devices=CPU8).place_params(params, cfg)
    got = decoder_forward(rp, torch.from_numpy(toks), cfg)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(
        got.numpy(), decoder_forward(params, torch.from_numpy(toks),
                                     cfg).numpy(), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("topology", ["4x2", "2x1"])
@pytest.mark.parametrize("quantized", [False, True])
def test_mixtral_tp_sharded_matches_single_device(topology, quantized):
    """The mirror of ``tests/test_models.py``'s mixtral-tiny case: the
    decoder over tp × fsdp rank shards (experts split over tp, routing on
    every rank, the capacity from the call's total tokens) against the
    single-device decoder of both packages, ``rtol=atol=2e-4``. The int8
    tree (not in the reference's case) is held at ``atol=1e-3``: an int8
    product rounds its f32 input to bf16 first, so where the sharded
    reduction's f32 sum differs in its last bit an input can round one
    bf16 ulp apart (3.4e-4 in the logits here)."""
    jcfg = dataclasses.replace(JAX_MIXTRAL["mixtral-tiny"],
                               dtype=jnp.float32)
    cfg = dataclasses.replace(MIXTRAL_PRESETS["mixtral-tiny"],
                              dtype=torch.float32)
    jparams = _jax_tree(jcfg, quantized)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                             "cpu")
    toks = np.array(jax.random.randint(jax.random.PRNGKey(1), (2, 16), 0,
                                       cfg.vocab_size))
    want = np.asarray(jax_forward(jparams, jnp.asarray(toks), jcfg))
    rp = make_policy(topology, devices=CPU8).place_params(params, cfg)
    assert rp.layout.ffn                   # mixtral-tiny's 4 experts split
    got, aux = decoder_forward(rp, torch.from_numpy(toks), cfg,
                               return_moe_aux=True)
    tol = 1e-3 if quantized else 2e-4
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)
    _, want_aux = decoder_forward(params, torch.from_numpy(toks), cfg,
                                  return_moe_aux=True)
    assert float(aux) == pytest.approx(float(want_aux), rel=1e-6)


@pytest.mark.parametrize("n_ranks", [2, 4])
def test_moe_ranks_sum_to_the_whole(n_ranks):
    cfg = MoeConfig(dim=32, hidden_dim=48, n_experts=4, top_k=2,
                    capacity_factor=0.5, dtype=torch.float32)
    params = init_moe_layer(cfg, torch.Generator().manual_seed(3), "cpu")
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (3, 8, 32)).astype(np.float32))
    want, want_aux = moe_ffn(params, x, cfg)
    e = cfg.n_experts // n_ranks
    parts = []
    for r in range(n_ranks):
        shard = {"router": params["router"],
                 **{k: params[k][r * e:(r + 1) * e]
                    for k in ("w_gate", "w_up", "w_down")}}
        y, aux = moe_ffn(shard, x, cfg, rank=(r, n_ranks))
        assert torch.equal(aux["balance_loss"], want_aux["balance_loss"])
        assert torch.equal(aux["dropped_frac"], want_aux["dropped_frac"])
        parts.append(y)
    # capacity 0.5 drops pairs: the ranks drop exactly the same ones
    assert float(want_aux["dropped_frac"]) > 0
    torch.testing.assert_close(reduce_partials(parts, "cpu"), want,
                               rtol=1e-5, atol=1e-6)


def test_reduction_sums_in_f32_and_rounds_once():
    rng = np.random.default_rng(5)
    parts = [torch.from_numpy(rng.standard_normal((4, 1, 64)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(2)]
    got = reduce_partials(parts, "cpu")
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, (parts[0].float() + parts[1].float()).to(
        torch.bfloat16))
    assert reduce_partials(parts[:1], "cpu") is parts[0]


def test_decoder_kv_cache_per_rank_matches_unsharded(tiny):
    """Dense prefill and decode through rank caches of ``KH/tp`` heads."""
    _, cfg, _, params = tiny
    pol = make_policy("2x1", devices=CPU8)
    rp = pol.place_params(params, cfg)
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (2, 8)))
    ref_cache = init_kv_cache(cfg, 2, 32)
    cache = pol.init_kv_cache(cfg, 2, 32)
    assert isinstance(cache, Ranked) and cache[0]["k"].shape[-2] == 1
    want, ref_cache = decoder_forward(params, toks, cfg, kv_cache=ref_cache)
    got, cache = decoder_forward(rp, toks, cfg, kv_cache=cache)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(torch.cat([c["k"] for c in cache], dim=-2),
                               ref_cache["k"], rtol=2e-5, atol=2e-5)
    tok = want[:, -1:].argmax(-1)
    pos = torch.full((2, 1), 8)
    clen = torch.full((2,), 9)
    want2, _ = decoder_forward(params, tok, cfg, positions=pos,
                               kv_cache=ref_cache, cache_len=clen,
                               decode=True)
    got2, _ = decoder_forward(rp, tok, cfg, positions=pos, kv_cache=cache,
                              cache_len=clen, decode=True)
    torch.testing.assert_close(got2, want2, rtol=2e-5, atol=2e-5)


# -- policies ---------------------------------------------------------------

def test_make_policy_identity_for_1x1():
    pol = make_policy(None, devices=["cpu"])
    assert isinstance(pol, SingleDevicePolicy)
    assert not isinstance(pol, MeshPolicy)
    assert make_policy("1x1", devices=["cpu"]).__class__ is SingleDevicePolicy
    x = torch.arange(8.0)
    assert pol.place_params({"w": x})["w"] is x
    assert pol.abstract({"w": x})["w"] is x
    assert pol.describe() == {"tp": 1, "fsdp": 1, "n_chips": 1} == \
        jax_make_policy(None).describe()
    assert pol.join([{"k": x}])["k"] is x
    assert pol.hbm_used_gb_per_chip() == 0.0


def test_make_policy_rejects_oversubscribed_mesh():
    with pytest.raises(ValueError, match="devices"):
        make_policy("4x4", devices=CPU8)
    if not torch.cuda.is_available():
        # the default devices are the cards this process sees: none here
        with pytest.raises(ValueError, match="needs 2 devices, have 0"):
            make_policy("2x1")


def test_mesh_policy_places_on_its_devices(tiny):
    _, cfg, _, params = tiny
    pol = make_policy("2x2", devices=CPU8)
    assert pol.describe() == {"tp": 2, "fsdp": 2, "n_chips": 4}
    assert pol.one_device and pol.distinct_devices() == [torch.device("cpu")]
    rp = pol.place_params(params, cfg)
    pol.check_placed(rp)
    with pytest.raises(ValueError, match="rank shards"):
        pol.check_placed(params)
    meta = pol.abstract(params, cfg)
    assert all(t.is_meta for t in jax.tree_util.tree_leaves(
        [list(p) if isinstance(p, Pieces) else p for p in
         jax.tree_util.tree_leaves(list(meta))]))
    zeros = pol.materialize(meta)
    assert zeros[0]["layers"][0]["wq"][0].shape == \
        rp[0]["layers"][0]["wq"][0].shape
    assert zeros[0]["final_norm"] is zeros[1]["final_norm"]


# -- the pool's head shards ------------------------------------------------------

BS = 32


def _ecfg_kw(**kw) -> dict:
    base = dict(max_batch=2, max_seq_len=256, prefill_buckets=(32, 64),
                decode_steps=(1, 4), kv_block_size=BS, kv_pool_blocks=16,
                prefill_chunk=32, prefix_cache_blocks=8)
    base.update(kw)
    return base


def _pool(kv_quant=False, topology=None):
    policy = make_policy(topology, devices=CPU8[:2])
    pool = KvPool(LLAMA_PRESETS["llama-tiny"],
                  EngineConfig(**_ecfg_kw()), torch.device("cpu"), kv_quant,
                  policy=policy)
    return pool, pool.init_arrays()


def _fill(pool, kv, blocks, seed=0):
    """Deterministic content in ``blocks`` of every wire plane: canonical
    full-head values, placed by head through the pool (the full int8
    range, or normal floats)."""
    rng = np.random.default_rng(seed)
    planes = {}
    for name in pool.wire_names():
        shape = pool.plane_shape(name)
        sub = (shape[0], len(blocks)) + shape[2:]
        if name in ("k", "v") and pool.kv_quant:
            planes[name] = torch.from_numpy(
                rng.integers(-127, 128, size=sub, dtype=np.int8))
        else:
            planes[name] = torch.from_numpy(
                rng.standard_normal(sub).astype(np.float32))
    pool.place_host_blocks(kv, planes, blocks)


def _export(pool, kv, blocks, tokens):
    return pool.export_blocks(kv, blocks, PrefixCache._key(tokens),
                              len(tokens))


def _bytes(t: torch.Tensor) -> bytes:
    return t.contiguous().view(torch.uint8).numpy().tobytes()


def _reexport(pool, kv, tokens):
    entry = pool.prefix_cache.acquire_for_export(tokens)
    try:
        return pool.export_blocks(kv, entry.blocks, entry.key,
                                  entry.n_tokens)
    finally:
        pool.prefix_cache.release_pin(entry)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_pool_head_shards_and_one_table(kv_quant):
    pool, kv = _pool(kv_quant, "2x1")
    assert isinstance(kv, Ranked) and len(kv) == 2
    for rank in kv:
        assert rank["k"].shape == (2, pool.n_blocks, BS, 1, 32)
        if kv_quant:
            assert rank["k_scale"].shape == (2, pool.n_blocks, BS, 1)
    # ranks on one device share the table; a push writes it once
    assert kv[0]["table"] is kv[1]["table"] is pool.table
    pool.slot_blocks[1] = pool.alloc_blocks(3)
    pool.push_table(1)
    assert kv[1]["table"][1, :3].tolist() == pool.slot_blocks[1]


@pytest.mark.parametrize("src,dst", [("2x1", None), (None, "2x1"),
                                     ("2x1", "2x1")])
@pytest.mark.parametrize("kv_quant", [False, True])
def test_reshard_roundtrip_is_canonical(src, dst, kv_quant):
    """The reference's re-shard cells: a payload's planes are canonical
    full-head planes whatever the exporter's topology, so a re-export from
    the other topology matches byte for byte except the informational
    topology field."""
    pool_a, kv_a = _pool(kv_quant, src)
    blocks = pool_a.alloc_blocks(3)
    _fill(pool_a, kv_a, blocks)
    tokens = [(i * 11) % 199 + 1 for i in range(3 * BS)]
    payload = _export(pool_a, kv_a, blocks, tokens)
    pool_b, kv_b = _pool(kv_quant, dst)
    adopted, _ = pool_b.import_blocks(kv_b, payload)
    assert adopted
    back = _reexport(pool_b, kv_b, tokens)
    h1, p1 = kvwire.decode_blocks(payload)
    h2, p2 = kvwire.decode_blocks(back)
    assert h1.pop("topology") == pool_a.policy.describe()
    assert h2.pop("topology") == pool_b.policy.describe()
    assert h1 == h2
    for name in p1:
        assert _bytes(p1[name]) == _bytes(p2[name]), name


def test_tp2_export_matches_the_jax_tp2_export(monkeypatch):
    """The same planes written into a JAX tp=2 pool (8 host devices) and a
    port tp=2 pool export to the same bytes, topology field included."""
    jcfg, tcfg = JAX_LLAMA["llama-tiny"], LLAMA_PRESETS["llama-tiny"]
    jpool = JaxKvPool(jcfg, JaxEngineConfig(**_ecfg_kw()), False,
                      jax_make_policy("2x1"))
    jkv = jpool.init_arrays()
    pool, kv = _pool(False, "2x1")
    blocks = pool.alloc_blocks(2)
    assert jpool.alloc_blocks(2) == blocks
    rng = np.random.default_rng(9)
    planes = {}
    for name in ("k", "v"):
        shape = pool.plane_shape(name)
        planes[name] = rng.standard_normal(
            (shape[0], 2) + shape[2:]).astype(np.float32)
    idx = jnp.asarray(blocks, dtype=jnp.int32)
    jkv = dict(jkv)
    for name, vals in planes.items():
        jkv[name] = jkv[name].at[:, idx].set(jnp.asarray(vals, jnp.bfloat16))
    jkv.update(jpool.policy.place_kv({n: jkv[n] for n in ("k", "v")}))
    pool.place_host_blocks(kv, {n: torch.from_numpy(v)
                                for n, v in planes.items()}, blocks)
    tokens = list(range(1, 2 * BS + 1))
    got = _export(pool, kv, blocks, tokens)
    want = jpool.export_blocks(jkv, blocks, JaxPrefixCache._key(tokens),
                               len(tokens))
    assert got == want
