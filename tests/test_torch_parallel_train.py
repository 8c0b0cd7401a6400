"""The port's sharded train steps (``tpu9_torch/train`` over
``parallel.shard_params``: the rank-by-rank ``decoder_core`` with a
gradient, LoRA's merge over rank shards, the ``ep``-sharded MoE FFN, the
optimizer over trees of rank containers) against ``tpu9.train`` under
the same mesh shapes on the CPU, at f32 on the tiny presets. The port's
meshes are ``["cpu"] * n`` (one process drives every rank), or
``"cpu:<i>"`` where replicas must be distinct tensors; JAX's are the 8
host devices of ``tests/conftest.py``.

Tolerances, from an error model of the two f32 programs: both compute the
same sums, but GSPMD and the port's rank shards split each product
differently (the port adds tp partial sums after the GEMMs, GSPMD inside
or across its own collectives), so each layer's output carries a few f32
roundings (2^-24 relative each) of the largest partial more than either
unsharded program. Two layers of them move the logits by about 1e-6 of
their range and the loss, a mean of log-softmaxes, by less: step 1's
losses agree within ``rtol=1e-6``. Adam then divides each gradient by its
own magnitude, so an entry whose gradient lies near its f32 rounding can
take a step of ``lr`` in one program and not the other (4.4e-5 was seen
in ``tests/test_torch_train.py`` against steps of 1e-2): later steps'
losses agree within ``rtol=1e-5`` (full, lr 1e-3) and ``2e-5`` (LoRA, lr
1e-2), which is the reference-against-port gap
``tests/test_torch_train.py`` holds its unsharded steps to, widened once
for the second program's own roundings.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import tpu9.parallel as jpar
from tpu9.models import init_decoder as jax_init_decoder
from tpu9.models import lora as jlora
from tpu9.models import moe as jmoe
from tpu9.models.gemma import GEMMA_PRESETS as JAX_GEMMA
from tpu9.models.llama import LLAMA_PRESETS as JAX_LLAMA
from tpu9.train import build_lora_train_step as jax_build_lora_step
from tpu9.train import build_train_step as jax_build_train_step
from tpu9.train.trainer import init_train_state as jax_init_train_state
from tpu9_torch import parallel as tpar
from tpu9_torch.bridge import params_from_jax
from tpu9_torch.models import lora as tlora
from tpu9_torch.models import moe as tmoe
from tpu9_torch.models import transformer
from tpu9_torch.models.gemma import GEMMA_PRESETS
from tpu9_torch.models.llama import LLAMA_PRESETS
from tpu9_torch.models.transformer import decoder_core
from tpu9_torch.parallel.sharding import (Pieces, RankParams, named_leaves,
                                          replica_groups)
from tpu9_torch.train import (build_lora_train_step, build_train_step,
                              causal_lm_loss, optim)
from tpu9_torch.train.trainer import init_train_state, lora_value_and_grad

torch.set_num_threads(2)

CPU8 = ["cpu"] * 8
DISTINCT8 = [f"cpu:{i}" for i in range(8)]
MODELS = {"llama-tiny": (JAX_LLAMA, LLAMA_PRESETS),
          "gemma-tiny": (JAX_GEMMA, GEMMA_PRESETS)}
LOSS_RTOL_FIRST = 1e-6
FULL_LOSS_RTOL = 1e-5
LORA_LOSS_RTOL = 2e-5
GRAD_NORM_RTOL = 1e-5


def _model(name: str, head_dim: int = 64, seed: int = 0):
    """JAX and port configs and params at f32; head_dim 64 and 128-token
    rows put the port's attention on the flash route (the Function: its
    twin forward, its torch-ops backward)."""
    jax_presets, presets = MODELS[name]
    jcfg = dataclasses.replace(jax_presets[name], dtype=jnp.float32,
                               head_dim=head_dim)
    tcfg = dataclasses.replace(presets[name], dtype=torch.float32,
                               head_dim=head_dim)
    jparams = jax_init_decoder(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, jparams, params_from_jax(jax.device_get(jparams),
                                                "cpu")


def _tokens(vocab: int, shape, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, shape
                                                ).astype(np.int32)


def _check_losses(got: list, want: list, rtol: float) -> None:
    np.testing.assert_allclose(got[0], want[0], rtol=LOSS_RTOL_FIRST,
                               err_msg="step 0")
    np.testing.assert_allclose(got, want, rtol=rtol)


def _at(tree, path: str):
    for part in path.split("/"):
        tree = tree[int(part)] if isinstance(tree, list) else tree[part]
    return tree


def _assemble(sharded: RankParams, full) -> dict:
    """The full tree's leaves, by path, rebuilt from rank shards: each
    placed tensor written at its region (its tp slice, then its fsdp
    piece); a tensor several ranks share, once."""
    out = {path: torch.zeros_like(t) for path, t in named_leaves(full)}
    done = set()
    for r, tree in enumerate(sharded):
        for path, t in named_leaves(tree):
            if id(t) in done:
                continue
            done.add(id(t))
            base, piece = path, None
            if path not in out:
                base, piece = path.rsplit("/", 1)
            region = [slice(0, n) for n in out[base].shape]
            key = sharded.slices[r].get(path)
            if key:
                d, (lo, hi) = key
                region[d] = slice(lo, hi)
            if piece is not None:
                d = _at(tree, base).dim
                start = region[d].start + int(piece) * t.shape[d]
                region[d] = slice(start, start + t.shape[d])
            out[base][tuple(region)] = t.detach()
    return out


# -- the steps against the reference's under one mesh -------------------------------------


def test_full_steps_match_the_reference_on_a_mesh():
    """The mirror of ``test_fsdp_train_step_loss_decreases``: dp=2 x
    fsdp=2 x tp=2, adam 1e-3, remat on, three steps: the losses step for
    step and ``grad_norm`` against ``tpu9.train``'s under the same mesh,
    the loss falling."""
    axes = dict(dp=2, fsdp=2, sp=1, tp=2)
    jcfg, tcfg, jparams, tparams = _model("llama-tiny")
    tokens = _tokens(jcfg.vocab_size, (4, 128), 1)
    jmesh, tmesh = jpar.make_mesh(**axes), tpar.make_mesh(**axes,
                                                          devices=CPU8)
    jopt, topt = optax.adam(1e-3), optim.adam(1e-3)
    jstate = jax_init_train_state(jparams, jopt, jmesh,
                                  jpar.decoder_param_specs(jparams))
    tstate = init_train_state(tparams, topt, tmesh,
                              tpar.decoder_param_specs(tparams))
    assert isinstance(tstate.params, RankParams)
    assert isinstance(tstate.opt_state.mu, RankParams)
    jstep = jax_build_train_step(jcfg, jopt, remat=True)
    tstep = build_train_step(tcfg, topt, remat=True, device="cpu")
    losses, jlosses, norms, jnorms = [], [], [], []
    for _ in range(3):
        with jmesh:
            jstate, jm = jstep(jstate, jnp.asarray(tokens))
        with tmesh:
            tstate, tm = tstep(tstate, tokens)
        losses.append(float(tm["loss"]))
        jlosses.append(float(jm["loss"]))
        norms.append(float(tm["grad_norm"]))
        jnorms.append(float(jm["grad_norm"]))
    _check_losses(losses, jlosses, FULL_LOSS_RTOL)
    np.testing.assert_allclose(norms, jnorms, rtol=GRAD_NORM_RTOL)
    assert losses[-1] < losses[0]
    assert isinstance(tstate.params, RankParams) and int(tstate.step) == 3


@pytest.mark.parametrize("name", list(MODELS))
def test_lora_steps_match_the_reference_on_a_mesh(name):
    """The mirror of ``test_lora_fsdp_train_step``: fsdp=4 x tp=2, the base
    by ``decoder_param_specs``, the adapters by ``fsdp_specs(min_size=1)``,
    adam 1e-2, remat on: three steps' losses against ``tpu9.train``'s."""
    axes = dict(dp=1, fsdp=4, sp=1, tp=2)
    jcfg, tcfg, jparams, tparams = _model(name)
    jad = jlora.init_lora(jax.random.PRNGKey(1), jparams, rank=4)
    tad = params_from_jax(jax.device_get(jad), "cpu")
    tokens = _tokens(jcfg.vocab_size, (2, 128), 2)
    jmesh, tmesh = jpar.make_mesh(**axes), tpar.make_mesh(**axes,
                                                          devices=CPU8)
    jbase = jpar.shard_params(jparams, jmesh, jpar.decoder_param_specs(jparams))
    jad = jpar.shard_params(jad, jmesh, jpar.fsdp_specs(jad, min_size=1))
    tbase = tpar.shard_params(tparams, tmesh,
                              tpar.decoder_param_specs(tparams))
    tad = tpar.shard_params(tad, tmesh, tpar.fsdp_specs(tad, min_size=1))
    assert isinstance(tad["layers"][0]["wq"]["a"], Pieces)
    jopt, topt = optax.adam(1e-2), optim.adam(1e-2)
    jstate, tstate = jopt.init(jad), topt.init(tad)
    jstep = jax_build_lora_step(jcfg, jopt, scale=2.0, remat=True)
    tstep = build_lora_train_step(tcfg, topt, scale=2.0, remat=True,
                                  device="cpu")
    losses, jlosses = [], []
    for _ in range(3):
        with jmesh:
            jad, jstate, jm = jstep(jad, jstate, jbase, jnp.asarray(tokens))
        with tmesh:
            tad, tstate, tm = tstep(tad, tstate, tbase, tokens)
        losses.append(float(tm["loss"]))
        jlosses.append(float(jm["loss"]))
    _check_losses(losses, jlosses, LORA_LOSS_RTOL)
    assert isinstance(tad["layers"][0]["wq"]["b"], Pieces)
    assert all(bool(torch.cat(list(layer[w]["b"]), 1).any())
               for layer in tad["layers"] for w in layer)


# -- the MoE FFN on an ep mesh -------------------------------------------------------------


def _moe(seed: int, dim: int = 32, hidden: int = 64, n_experts: int = 4,
         top_k: int = 2, capacity_factor: float = 1.25):
    kw = dict(dim=dim, hidden_dim=hidden, n_experts=n_experts, top_k=top_k,
              capacity_factor=capacity_factor)
    jcfg = jmoe.MoeConfig(**kw, dtype=jnp.float32)
    tcfg = tmoe.MoeConfig(**kw, dtype=torch.float32)
    jparams = jmoe.init_moe_layer(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, jparams, params_from_jax(jax.device_get(jparams),
                                                "cpu")


def _jax_ep(jparams, jmesh):
    from jax.sharding import NamedSharding
    specs = jmoe.moe_param_specs(jparams)
    return {k: jax.device_put(v, NamedSharding(jmesh, specs[k]))
            for k, v in jparams.items()}


def test_moe_ffn_on_ep8_matches_the_reference():
    """The mirror of ``test_moe_ffn_ep_sharded_matches_unsharded`` (its
    ``rtol=atol=2e-4``): the port's layer on ``ep=8`` against the JAX
    layer sharded on ``ep=8``, and against its own unsharded call, to
    which the shares add exactly."""
    jcfg, tcfg, jparams, tparams = _moe(0, dim=64, hidden=128, n_experts=8)
    x = np.random.default_rng(1).standard_normal((2, 32, 64), np.float32)
    jmesh = jpar.make_named_mesh({"ep": 8})
    with jmesh:
        want, jaux = jax.jit(lambda p, x: jmoe.moe_ffn(p, x, jcfg))(
            _jax_ep(jparams, jmesh), x)
    mesh = tpar.make_named_mesh({"ep": 8}, devices=CPU8)
    sharded = tpar.shard_params(tparams, mesh, tmoe.moe_param_specs(tparams))
    assert isinstance(sharded["w_up"], Pieces) and len(sharded["w_up"]) == 8
    got, aux = tmoe.moe_ffn(sharded, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    whole, whole_aux = tmoe.moe_ffn(tparams, torch.from_numpy(x), tcfg)
    assert torch.equal(got, whole)
    np.testing.assert_allclose(float(aux["balance_loss"]),
                               float(jaux["balance_loss"]), rtol=1e-6)
    assert float(aux["balance_loss"]) >= 1.0 - 1e-5


def test_moe_train_step_on_ep4_matches_the_reference():
    """The mirror of ``test_moe_train_step_loss_decreases``: ep=4, adam
    1e-2, eight steps, each loss against the JAX step's on the same mesh
    (``rtol=1e-5``, as the unsharded mirror in
    ``tests/test_torch_train.py``: no near tie flips an expert in these
    steps)."""
    jcfg, tcfg, jparams, tparams = _moe(0)
    x = np.random.default_rng(1).standard_normal((2, 64, 32), np.float32)
    target = np.roll(x, 1, axis=-1)
    jmesh = jpar.make_named_mesh({"ep": 4})
    jparams = _jax_ep(jparams, jmesh)
    jopt, topt = optax.adam(1e-2), optim.adam(1e-2)
    jstate = jopt.init(jparams)

    @jax.jit
    def jstep(params, opt_state):
        def loss_fn(p):
            y, aux = jmoe.moe_ffn(p, x, jcfg)
            return jnp.mean((y - target) ** 2) + 0.01 * aux["balance_loss"]
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = jopt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    mesh = tpar.make_named_mesh({"ep": 4}, devices=CPU8)
    params = tpar.shard_params(tparams, mesh, tmoe.moe_param_specs(tparams))
    state = topt.init(params)
    assert isinstance(state.mu["w_gate"], Pieces)
    tx, ttarget = torch.from_numpy(x), torch.from_numpy(target)
    losses, jlosses = [], []
    for _ in range(8):
        with jmesh:
            jparams, jstate, jl = jstep(jparams, jstate)
        live = optim.tree_map(lambda p: p.detach().requires_grad_(True),
                              params)
        y, aux = tmoe.moe_ffn(live, tx, tcfg)
        loss = torch.mean((y - ttarget) ** 2) + 0.01 * aux["balance_loss"]
        leaves = optim.tree_leaves(live)
        by_id = dict(zip(map(id, leaves), torch.autograd.grad(loss, leaves)))
        grads = optim.tree_map(lambda p: by_id[id(p)], live)
        updates, state = topt.update(grads, state, params)
        params = optim.apply_updates(params, updates)
        losses.append(float(loss))
        jlosses.append(float(jl))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert losses[-1] < losses[0]
    assert isinstance(params["w_down"], Pieces)


def test_moe_drops_and_balance_gradients_on_ep4_match_jax_grad():
    """The mirror of ``test_moe_capacity_drops_and_balance_grads``: a tiny
    capacity factor forces drops, reported as the reference reports them,
    and the gradients through the ep shards (the balance loss's into the
    router included) match ``jax.grad`` of the unsharded layer
    (``1e-5`` of each leaf's largest entry: f32 sums in other orders)."""
    jcfg, tcfg, jparams, tparams = _moe(0, top_k=1, capacity_factor=0.1)
    x = np.random.default_rng(1).standard_normal((4, 128, 32), np.float32)

    def jloss(p):
        y, aux = jmoe.moe_ffn(p, x, jcfg, ep_sharded=False)
        return jnp.mean(y ** 2) + 0.01 * aux["balance_loss"]

    jaux = jmoe.moe_ffn(jparams, x, jcfg, ep_sharded=False)[1]
    jgrads = jax.grad(jloss)(jparams)
    mesh = tpar.make_named_mesh({"ep": 4}, devices=CPU8)
    live = optim.tree_map(lambda p: p.requires_grad_(True), tpar.shard_params(
        tparams, mesh, tmoe.moe_param_specs(tparams)))
    y, aux = tmoe.moe_ffn(live, torch.from_numpy(x), tcfg)
    (torch.mean(y ** 2) + 0.01 * aux["balance_loss"]).backward()
    assert float(aux["dropped_frac"]) > 0
    np.testing.assert_allclose(float(aux["dropped_frac"]),
                               float(jaux["dropped_frac"]), rtol=1e-6)
    for name in ("router", "w_gate", "w_up", "w_down"):
        leaf = live[name]
        got = (torch.cat([p.grad for p in leaf]) if isinstance(leaf, Pieces)
               else leaf.grad)
        want = np.asarray(jgrads[name])
        assert np.abs(want).sum() > 0, name
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=name)


# -- remat over rank shards ------------------------------------------------------------------


def _grads(params, tokens, cfg, remat: bool):
    live = optim.tree_map(lambda x: x.detach().requires_grad_(True), params)
    loss = causal_lm_loss(decoder_core(live, tokens, cfg, remat=remat),
                          tokens)
    leaves = [x for x in optim.logical_leaves(live)]
    by_id = dict(zip(map(id, leaves), torch.autograd.grad(loss, leaves)))
    return float(loss), optim.tree_map(lambda x: by_id[id(x)], live)


@pytest.mark.parametrize("axes", [dict(fsdp=2, tp=2), dict(fsdp=2, tp=4)],
                         ids=["tp2xfsdp2", "tp4xfsdp2-regrouped"])
def test_remat_over_rank_shards_gives_the_unsharded_gradients(axes,
                                                              monkeypatch):
    """``decoder_core`` over rank shards with ``remat`` (refused before
    A14) gives the no-remat gradients, and both, assembled, give the
    unsharded tree's (``1e-5`` of each leaf's largest entry); each layer's
    fsdp gather runs inside its checkpoint: twice a layer under remat (the
    forward and the backward's recompute), once without."""
    _, tcfg, _, tparams = _model("llama-tiny")
    tokens = torch.from_numpy(_tokens(tcfg.vocab_size, (2, 128), 5))
    mesh = tpar.make_mesh(**axes, devices=CPU8)
    sharded = tpar.shard_params(tparams, mesh,
                                tpar.decoder_param_specs(tparams))
    gathers = []
    real = transformer.gather_leaf
    monkeypatch.setattr(transformer, "gather_leaf", lambda leaf, dev: (
        gathers.append(1) if isinstance(leaf, Pieces) else None)
        or real(leaf, dev))
    loss_r, g_remat = _grads(sharded, tokens, tcfg, remat=True)
    n_remat = len(gathers)
    gathers.clear()
    loss_n, g_plain = _grads(sharded, tokens, tcfg, remat=False)
    # per layer and rank: wq, wk, wv, wo, w_gate, w_up, w_down in pieces
    per_pass = tcfg.n_layers * axes["tp"] * 7
    assert len(gathers) - per_pass == n_remat - 2 * per_pass
    assert loss_r == loss_n
    for (pa, a), (pb, b) in zip(named_leaves(g_remat),
                                named_leaves(g_plain)):
        assert pa == pb
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6, msg=pa)
    loss_u, g_full = _grads(tparams, tokens, tcfg, remat=False)
    np.testing.assert_allclose(loss_r, loss_u, rtol=1e-6)
    full = dict(named_leaves(g_full))
    for path, got in _assemble(g_remat, tparams).items():
        want = full[path]
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-5 * float(want.abs().max()),
                                   msg=path)


def test_merge_over_rank_shards_is_the_unsharded_merge_sliced():
    _, tcfg, _, tparams = _model("gemma-tiny")
    rng = np.random.default_rng(6)
    ad = tlora.init_lora(torch.Generator().manual_seed(3), tparams, rank=4)
    ad = optim.tree_map(lambda x: torch.from_numpy(
        rng.standard_normal(tuple(x.shape)).astype(np.float32)), ad)
    mesh = tpar.make_mesh(fsdp=2, tp=4, devices=CPU8)
    base = tpar.shard_params(tparams, mesh, tpar.decoder_param_specs(tparams))
    sad = tpar.shard_params(ad, mesh, tpar.fsdp_specs(ad, min_size=1))
    merged = tlora.merge(base, sad, 2.0)
    assert isinstance(merged, RankParams) and merged.slices == base.slices
    want = dict(named_leaves(tlora.merge(tparams, ad, 2.0)))
    for path, got in _assemble(merged, tparams).items():
        torch.testing.assert_close(got, want[path], rtol=1e-6, atol=1e-6,
                                   msg=path)


# -- the optimizer over trees of rank containers ------------------------------------------------


def test_tree_map_keeps_rank_containers_and_shared_leaves():
    _, tcfg, _, tparams = _model("llama-tiny", head_dim=32)
    mesh = tpar.make_mesh(fsdp=2, tp=2, devices=CPU8)
    sharded = tpar.shard_params(tparams, mesh,
                                tpar.decoder_param_specs(tparams))
    out = optim.tree_map(torch.zeros_like, sharded)
    assert isinstance(out, RankParams)
    for attr in ("layout", "devices", "grid", "slices", "global_numel"):
        assert getattr(out, attr) == getattr(sharded, attr), attr
    wq = out[1]["layers"][0]["wq"]
    assert isinstance(wq, Pieces) and wq.dim == 0
    assert wq.devices == sharded[1]["layers"][0]["wq"].devices
    # a norm the ranks share on one device stays one tensor
    assert sharded[0]["layers"][0]["attn_norm"] is \
        sharded[1]["layers"][0]["attn_norm"]
    assert out[0]["layers"][0]["attn_norm"] is out[1]["layers"][0]["attn_norm"]
    state = optim.adam(1e-3).init(sharded)
    assert isinstance(state.mu, RankParams) and isinstance(
        state.nu[0]["embed"], Pieces)


@pytest.mark.parametrize("devices", [CPU8, DISTINCT8],
                         ids=["shared", "distinct"])
def test_a_replicated_leaf_counts_once_in_grad_norm(devices):
    _, _, _, tparams = _model("llama-tiny", head_dim=32)
    mesh = tpar.make_mesh(fsdp=2, tp=4, devices=devices)
    sharded = tpar.shard_params(tparams, mesh,
                                tpar.decoder_param_specs(tparams))
    groups = replica_groups(sharded)
    assert len(optim.logical_leaves(sharded)) == len(groups)
    assert max(map(len, groups)) == (4 if devices is DISTINCT8 else 1)
    np.testing.assert_allclose(float(optim.global_norm(sharded)),
                               float(optim.global_norm(tparams)), rtol=1e-6)


def test_replicas_on_distinct_devices_stay_equal_after_steps():
    """Rank shards on ``cpu:0``..``cpu:7``: the norms, the embedding's
    pieces and each rank's replicas are distinct tensors; only rank 0's
    norms are read, so the others' gradients come from the sum over the
    group, and every replica takes the same step. The losses are the
    shared-device run's."""
    axes = dict(fsdp=2, tp=4)
    _, tcfg, _, tparams = _model("llama-tiny")
    tokens = _tokens(tcfg.vocab_size, (2, 128), 7)
    runs = {}
    for label, devices in (("shared", CPU8), ("distinct", DISTINCT8)):
        mesh = tpar.make_mesh(**axes, devices=devices)
        opt = optim.adam(1e-2)
        state = init_train_state(tparams, opt, mesh,
                                 tpar.decoder_param_specs(tparams))
        step = build_train_step(tcfg, opt, device="cpu")
        losses = []
        for _ in range(2):
            state, metrics = step(state, tokens)
            losses.append(float(metrics["loss"]))
        runs[label] = (losses, state.params)
    params = runs["distinct"][1]
    copies = [g for g in replica_groups(params) if len(g) > 1]
    assert len(copies) > 0
    for group in copies:
        assert all(torch.equal(group[0], t) for t in group[1:])
    np.testing.assert_allclose(runs["distinct"][0], runs["shared"][0],
                               rtol=1e-6)


def test_lora_value_and_grad_over_rank_shards_reaches_only_the_adapters():
    _, tcfg, _, tparams = _model("gemma-tiny")
    mesh = tpar.make_mesh(fsdp=2, tp=2, devices=CPU8)
    base = tpar.shard_params(tparams, mesh, tpar.decoder_param_specs(tparams))
    ad = tlora.init_lora(torch.Generator().manual_seed(2), tparams, rank=4)
    sad = tpar.shard_params(ad, mesh, tpar.fsdp_specs(ad, min_size=1))
    tokens = torch.from_numpy(_tokens(tcfg.vocab_size, (1, 128), 5))
    loss, grads = lora_value_and_grad(tcfg, 2.0)(sad, base, tokens)
    want_loss, want = lora_value_and_grad(tcfg, 2.0)(ad, tparams, tokens)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-6)
    for i, layer in enumerate(grads["layers"]):
        for w, g in layer.items():
            b = torch.cat(list(g["b"]), dim=g["b"].dim)
            a = torch.cat(list(g["a"]), dim=g["a"].dim)
            assert not a.any() and b.any(), w
            ref = want["layers"][i][w]["b"]
            torch.testing.assert_close(b, ref, rtol=0,
                                       atol=1e-5 * float(ref.abs().max()))
    assert all(not t.requires_grad for _, t in named_leaves(base))
