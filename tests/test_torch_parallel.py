"""The port's parallel layer (``tpu9_torch/parallel``: meshes, the training
half of the sharding rules, ring attention, the GPipe pipeline and the
multi-host wiring) against ``tpu9.parallel`` on the CPU. Inputs are made
with numpy from a seed and handed to both packages; JAX params cross with
``params_from_jax``. The port runs its meshes on ``["cpu"] * n`` (one
process drives every rank); JAX runs on the 8 host devices that
``tests/conftest.py`` forces.

- Mesh shapes, ``sub_devices``' order against the JAX mesh's device grid,
  the ``ValueError`` of a mesh too large, no CPU fall back without
  devices, ``mesh_for_spec`` over a ``GpuSpec`` against the reference's
  over the ``TpuSpec`` of the same chips.
- ``fsdp_specs`` and ``replicate_specs`` trees equal to the reference's,
  tuple for tuple, over the tiny presets, adapters and adam state.
- ``constrain``: the identity outside a mesh and inside one, raising on
  an axis the mesh lacks.
- ``shard_params``: each placed piece's shape against the JAX shards'
  shapes; the tp=4 x fsdp=2 and dp=2 x tp=4 forwards, and a decoder
  placed by ``fsdp_specs`` alone, against JAX's sharded forward at f32
  within the reference's own ``atol=2e-3`` (the gap seen is about 2e-6,
  reported by the assert's message).
- Ring attention, causal and full, against ``tpu9.parallel.ring_attention``
  on ``sp=8`` (``atol=2e-5``, the reference test's), from whole tensors and
  from pieces, and its gradient against autograd of the dense twin.
- ``pipeline_forward`` at M=4 and M=8 against the reference's (``1e-5``),
  from whole and from staged params, and its gradient against
  ``jax.grad`` of the sequential program (the reference marks its own
  gradient test slow; at dim 8 the port's runs in well under a second).
- ``multihost_env`` over a table of environs against the reference's, and
  ``initialize_multihost`` through one 2-process gloo spawn on localhost.
"""

import dataclasses
import multiprocessing
import socket

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import tpu9.parallel as jpar
from tpu9.models import decoder_forward as jax_forward
from tpu9.models import init_decoder as jax_init_decoder
from tpu9.models import lora as jlora
from tpu9.models.gemma import GEMMA_PRESETS as JAX_GEMMA
from tpu9.models.llama import LLAMA_PRESETS as JAX_LLAMA
from tpu9.ops.attention import xla_attention as jax_xla_attention
from tpu9.parallel.distributed import multihost_env as jax_multihost_env
from tpu9.types import parse_tpu_spec
from tpu9_torch import parallel as tpar
from tpu9_torch.bridge import params_from_jax
from tpu9_torch.models.gemma import GEMMA_PRESETS
from tpu9_torch.models.llama import LLAMA_PRESETS
from tpu9_torch.models.transformer import decoder_forward
from tpu9_torch.ops.attention import xla_attention
from tpu9_torch.parallel.ring import _local_block
from tpu9_torch.parallel.sharding import Pieces, RankParams
from tpu9_torch.train import optim
from tpu9_torch.types import GpuSpec, parse_gpu_spec

torch.set_num_threads(2)

CPU8 = ["cpu"] * 8
MODELS = {"llama-tiny": (JAX_LLAMA, LLAMA_PRESETS),
          "gemma-tiny": (JAX_GEMMA, GEMMA_PRESETS)}


def _model(name: str, seed: int = 0):
    jax_presets, presets = MODELS[name]
    jcfg = dataclasses.replace(jax_presets[name], dtype=jnp.float32)
    tcfg = dataclasses.replace(presets[name], dtype=torch.float32)
    jparams = jax_init_decoder(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, jparams, params_from_jax(jax.device_get(jparams),
                                                "cpu")


def _spec_tuple(tree):
    """A spec tree as nested Python lists of plain tuples, for either
    package's ``P``."""
    if isinstance(tree, dict):
        return {k: _spec_tuple(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not _is_spec(tree):
        return [_spec_tuple(v) for v in tree]
    return tuple(tree)


def _is_spec(x) -> bool:
    return type(x).__name__ in ("P", "PartitionSpec")


# -- meshes --------------------------------------------------------------------------


@pytest.mark.parametrize("axes", [dict(dp=2, fsdp=2, sp=1, tp=2),
                                  dict(dp=1, fsdp=2, sp=1, tp=4),
                                  dict(sp=8), dict(tp=8)],
                         ids=["dp2fsdp2tp2", "fsdp2tp4", "sp8", "tp8"])
def test_make_mesh_shapes_match_the_reference(axes):
    want = jpar.make_mesh(**axes)
    got = tpar.make_mesh(**axes, devices=CPU8)
    assert got.shape == dict(want.shape)
    assert got.axis_names == tuple(want.axis_names) == tpar.MeshAxes
    with pytest.raises(ValueError, match="needs 16 devices, have 8"):
        tpar.make_mesh(dp=16, devices=CPU8)
    with pytest.raises(ValueError):
        jpar.make_mesh(dp=16)


@pytest.mark.parametrize("axes", [{"ep": 8}, {"pp": 4}, {"pp": 4, "dp": 2}],
                         ids=["ep8", "pp4", "pp4dp2"])
def test_make_named_mesh_shapes_match_the_reference(axes):
    want = jpar.make_named_mesh(axes)
    got = tpar.make_named_mesh(axes, devices=CPU8)
    assert got.shape == dict(want.shape)
    assert got.axis_names == tuple(axes)
    with pytest.raises(ValueError, match="needs 16 devices"):
        tpar.make_named_mesh({"ep": 16}, devices=CPU8)


@pytest.mark.parametrize("axes", [("fsdp", "tp"), ("tp", "fsdp"), ("sp",),
                                  ("dp", "fsdp")])
def test_sub_devices_follow_the_reference_grid(axes):
    """Distinct CPU indices stand for the JAX devices' ids: the port's
    subgrid order is the JAX mesh's, other axes at coordinate 0."""
    shape = dict(dp=2, fsdp=2, sp=1, tp=2)
    jmesh = jpar.make_mesh(**shape)
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    index = tuple(slice(None) if a in axes else 0 for a in jmesh.axis_names)
    kept = [a for a in jmesh.axis_names if a in axes]
    want = np.transpose(ids[index], [kept.index(a) for a in axes]).ravel()
    first = min(d.id for d in jax.devices())
    mesh = tpar.make_mesh(**shape, devices=[f"cpu:{d.id - first}"
                                            for d in jax.devices()])
    got = [d.index for d in mesh.sub_devices(axes)]
    assert got == list(want - first)


def test_a_mesh_without_devices_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is every card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpar.make_mesh(tp=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpar.mesh_for_spec(parse_gpu_spec("h100-1"))


@pytest.mark.parametrize("kw", [{}, {"tp": 4}, {"tp": 2, "sp": 2},
                                {"tp": 2, "dp": 2}, {"tp": 1}])
def test_mesh_for_spec_matches_the_reference(kw):
    want = jpar.mesh_for_spec(parse_tpu_spec("v5e-8"), **kw)
    got = tpar.mesh_for_spec(parse_gpu_spec("h100-8"), devices=CPU8, **kw)
    assert got.shape == dict(want.shape)


def test_mesh_for_spec_keeps_tp_on_a_host_and_refuses_a_bad_split():
    spec = parse_gpu_spec("h100-4")
    assert spec.chips_per_host == parse_tpu_spec("v5e-4").chips_per_host
    two_hosts = GpuSpec("h100-16", "h100", 16, 2, 80, 989.0)
    assert two_hosts.chips_per_host == 8
    mesh = tpar.mesh_for_spec(two_hosts, devices=["cpu"] * 16)
    assert mesh.shape == {"dp": 1, "fsdp": 2, "sp": 1, "tp": 8}
    with pytest.raises(ValueError, match="do not divide"):
        tpar.mesh_for_spec(spec, tp=3, devices=CPU8)


def test_the_mesh_context_nests():
    outer = tpar.make_mesh(tp=2, devices=CPU8)
    inner = tpar.make_named_mesh({"ep": 4}, devices=CPU8)
    from tpu9_torch.parallel.mesh import current_mesh
    assert current_mesh() is None
    with outer:
        with inner:
            assert current_mesh() is inner
        assert current_mesh() is outer
    assert current_mesh() is None


def test_the_exports_cover_the_reference():
    assert set(jpar.__all__) <= set(tpar.__all__)
    for name in tpar.__all__:
        assert getattr(tpar, name) is not None, name


# -- specs ---------------------------------------------------------------------------


def _spec_trees():
    """(name, JAX tree, port tree) pairs: the tiny presets, adapters of
    rank 4, and adam's moments over the adapters."""
    out = []
    for name in MODELS:
        _, _, jparams, tparams = _model(name)
        out.append((name, jparams, tparams))
        jad = jlora.init_lora(jax.random.PRNGKey(1), jparams, rank=4)
        tad = params_from_jax(jax.device_get(jad), "cpu")
        out.append((f"{name}-adapters", jad, tad))
    jad, tad = out[1][1], out[1][2]
    jstate = optax.adam(1e-2).init(jad)[0]
    tstate = optim.adam(1e-2).init(tad)
    out.append(("adam-moments", {"mu": jstate.mu, "nu": jstate.nu,
                                 "count": jstate.count},
                {"mu": tstate.mu, "nu": tstate.nu, "count": tstate.count}))
    return out


@pytest.mark.parametrize("min_size", [2 ** 14, 1, 4096],
                         ids=["default", "min1", "min4096"])
def test_fsdp_and_replicate_specs_match_the_reference(min_size):
    for name, jtree, ttree in _spec_trees():
        want = jpar.fsdp_specs(jtree, min_size=min_size)
        got = tpar.fsdp_specs(ttree, min_size=min_size)
        assert _spec_tuple(got) == _spec_tuple(want), name
        assert (_spec_tuple(tpar.replicate_specs(ttree))
                == _spec_tuple(jpar.replicate_specs(jtree))), name


def test_fsdp_specs_keep_the_optimizer_state_type():
    _, _, _, tparams = _model("llama-tiny")
    state = optim.adam(1e-3).init(tparams)
    specs = tpar.fsdp_specs(state, axis="dp")
    assert type(specs) is type(state)
    assert specs.count == tpar.P()
    assert specs.mu["embed"] == tpar.P("dp", None)


def test_constrain_is_the_identity_and_checks_axes_in_a_mesh():
    x = torch.arange(6.0).reshape(2, 3)
    assert tpar.constrain(x, tpar.P("nope", None)) is x
    mesh = tpar.make_mesh(dp=2, fsdp=2, tp=2, devices=CPU8)
    with mesh:
        assert tpar.constrain(x, tpar.P(("dp", "fsdp"), None)) is x
        with pytest.raises(ValueError, match="'nope'"):
            tpar.constrain(x, tpar.P("nope", None))
        with pytest.raises(ValueError, match="'ep'"):
            tpar.constrain(x, tpar.P(("dp", "ep"), None))


# -- shard_params ----------------------------------------------------------------------


def _piece_shapes(leaf) -> list:
    """The shapes of a placed leaf's pieces, innermost first in row-major
    order of their grid coordinates."""
    if isinstance(leaf, Pieces):
        return [s for p in leaf for s in _piece_shapes(p)]
    return [tuple(leaf.shape)]


@pytest.mark.parametrize("min_size", [1, 2 ** 14], ids=["min1", "default"])
def test_generic_shards_match_the_reference_shards(min_size):
    """Adapters and a whole decoder by ``fsdp_specs`` on fsdp=4 x tp=2:
    each leaf's distinct pieces have the JAX shards' shapes, a leaf the
    axis does not divide stays whole, and each piece lies on its device."""
    mesh_axes = dict(dp=1, fsdp=4, sp=1, tp=2)
    jmesh = jpar.make_mesh(**mesh_axes)
    tmesh = tpar.make_mesh(**mesh_axes, devices=CPU8)
    _, _, jparams, tparams = _model("llama-tiny")
    jad = jlora.init_lora(jax.random.PRNGKey(1), jparams, rank=4)
    tad = params_from_jax(jax.device_get(jad), "cpu")
    for jtree, ttree in ((jad, tad), (jparams, tparams)):
        jspecs = jpar.fsdp_specs(jtree, min_size=min_size)
        got = tpar.shard_params(ttree, tmesh,
                                tpar.fsdp_specs(ttree, min_size=min_size))
        want = jpar.shard_params(jtree, jmesh, jspecs)
        jl = jax.tree_util.tree_leaves(want)
        tl = [leaf for leaf in _logical(got)]
        assert len(jl) == len(tl)
        for a, b in zip(jl, tl):
            shapes = sorted({tuple(s.data.shape) for s in a.addressable_shards})
            assert sorted(set(_piece_shapes(b))) == shapes
            if isinstance(b, Pieces):
                assert len(b) == 4 and b.devices == [torch.device("cpu")] * 4


def _logical(tree):
    """A placed tree's leaves with :class:`Pieces` as one leaf, in JAX's
    order (sorted dict keys)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _logical(tree[k])
    elif isinstance(tree, list) and not isinstance(tree, Pieces):
        for v in tree:
            yield from _logical(v)
    else:
        yield tree


def test_decoder_shards_take_the_layout_table():
    _, tcfg, _, tparams = _model("llama-tiny")
    mesh = tpar.make_mesh(dp=1, fsdp=2, sp=1, tp=4,
                          devices=[f"cpu:{i}" for i in range(8)])
    sharded = tpar.shard_params(tparams, mesh,
                                tpar.decoder_param_specs(tparams))
    assert isinstance(sharded, RankParams) and len(sharded) == 4
    assert sharded.layout.attn == "even"
    assert sharded.layout.resolve(tcfg).attn == "kv_copies"
    assert [d.index for d in sharded.devices] == [0, 1, 2, 3]
    layer = sharded[1]["layers"][0]
    wq = tparams["layers"][0]["wq"]                      # [128, 128]
    # P(fsdp, tp): rank 1's columns 32:64, rows split over fsdp
    assert isinstance(layer["wq"], Pieces) and layer["wq"].dim == 0
    assert [d.index for d in layer["wq"].devices] == [1, 5]
    assert torch.equal(torch.cat(list(layer["wq"])), wq[:, 32:64])
    # P(tp, fsdp): rank 1's rows of wo, columns over fsdp
    assert torch.equal(torch.cat(list(layer["wo"]), dim=1),
                       tparams["layers"][0]["wo"][32:64])
    # replicated norms: one replica a rank device
    assert torch.equal(layer["attn_norm"], tparams["layers"][0]["attn_norm"])
    assert sharded.slices[1]["layers/0/wq/0"] == (1, (32, 64))
    assert "layers/0/attn_norm" not in sharded.slices[1]


@pytest.mark.parametrize("name", list(MODELS))
@pytest.mark.parametrize("axes", [dict(dp=1, fsdp=2, sp=1, tp=4),
                                  dict(dp=2, fsdp=1, sp=1, tp=4)],
                         ids=["tp4xfsdp2", "dp2xtp4"])
def test_sharded_forward_matches_the_jax_sharded_forward(axes, name):
    """The mirrors of ``test_tp_fsdp_forward_matches_single_device`` and
    ``test_dp_tp_forward_matches`` (``atol=2e-3``, the reference's): the
    port's rank shards (llama-tiny's 2 kv heads regrouped for tp=4)
    against the JAX package's GSPMD forward on the same mesh shape."""
    jcfg, tcfg, jparams, tparams = _model(name)
    tokens = np.array([[1, 2, 3, 4, 5, 6, 7, 8],
                       [8, 7, 6, 5, 4, 3, 2, 1]], np.int32)
    jmesh = jpar.make_mesh(**axes)
    jsharded = jpar.shard_params(jparams, jmesh,
                                 jpar.decoder_param_specs(jparams))
    with jmesh:
        want = np.asarray(jax.jit(lambda p, t: jax_forward(p, t, jcfg))(
            jsharded, jnp.asarray(tokens)))
    tmesh = tpar.make_mesh(**axes, devices=CPU8)
    sharded = tpar.shard_params(tparams, tmesh,
                                tpar.decoder_param_specs(tparams))
    with tmesh:
        got = decoder_forward(sharded, torch.from_numpy(tokens), tcfg)
    gap = float(np.abs(got.numpy() - want).max())
    assert gap <= 2e-3, f"max abs gap {gap:.3e}"


def test_an_fsdp_only_decoder_runs_as_one_rank_gathering_its_pieces():
    """A decoder placed by ``fsdp_specs`` (pieces, no rank shards) runs as
    one rank that gathers each piece where it reads it: the JAX forward
    under the same specs on fsdp=8 (``atol=2e-3``, the reference's)."""
    jcfg, tcfg, jparams, tparams = _model("gemma-tiny")
    tokens = np.random.default_rng(5).integers(0, jcfg.vocab_size, (2, 16)
                                               ).astype(np.int32)
    jmesh = jpar.make_mesh(fsdp=8)
    jsharded = jpar.shard_params(jparams, jmesh,
                                 jpar.fsdp_specs(jparams, min_size=1))
    with jmesh:
        want = np.asarray(jax.jit(lambda p, t: jax_forward(p, t, jcfg))(
            jsharded, jnp.asarray(tokens)))
    tmesh = tpar.make_mesh(fsdp=8, devices=CPU8)
    sharded = tpar.shard_params(tparams, tmesh,
                                tpar.fsdp_specs(tparams, min_size=1))
    assert not isinstance(sharded, RankParams)
    assert isinstance(sharded["embed"], Pieces) and len(sharded["embed"]) == 8
    got = decoder_forward(sharded, torch.from_numpy(tokens), tcfg).numpy()
    gap = float(np.abs(got - want).max())
    assert gap <= 2e-3, f"max abs gap {gap:.3e}"


# -- ring attention ---------------------------------------------------------------------


def _qkv(shape, seed: int = 0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape, np.float32) for _ in range(3)]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_ring_attention_matches_the_reference(causal):
    """``test_ring_attention_matches_dense``'s shapes and ``atol=2e-5``,
    against both the reference's ring and the dense attention."""
    q, k, v = _qkv((2, 64, 4, 16))
    jmesh = jpar.make_mesh(sp=8)
    want = np.asarray(jpar.ring_attention(*map(jnp.asarray, (q, k, v)),
                                          jmesh, axis="sp", causal=causal))
    dense = np.asarray(jax_xla_attention(*map(jnp.asarray, (q, k, v)),
                                         causal=causal))
    mesh = tpar.make_mesh(sp=8, devices=CPU8)
    got = tpar.ring_attention(*map(torch.from_numpy, (q, k, v)), mesh,
                              axis="sp", causal=causal)
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)
    np.testing.assert_allclose(got.numpy(), dense, atol=2e-5, rtol=0)


def test_ring_attention_takes_pieces_and_keeps_the_dtype():
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16)
               for x in _qkv((1, 64, 2, 16), seed=1))
    mesh = tpar.make_named_mesh({"sp": 4}, devices=CPU8)
    spec = tpar.P(None, "sp", None, None)
    pieces = [tpar.shard_params(x, mesh, spec) for x in (q, k, v)]
    assert isinstance(pieces[0], Pieces) and len(pieces[0]) == 4
    out = tpar.ring_attention(*pieces, mesh, axis="sp", causal=True)
    assert isinstance(out, Pieces) and out.dim == 1 and len(out) == 4
    whole = tpar.ring_attention(q, k, v, mesh, axis="sp", causal=True)
    assert whole.dtype == torch.bfloat16
    assert torch.equal(torch.cat(list(out), dim=1), whole)
    want = xla_attention(q.float(), k.float(), v.float(), causal=True)
    assert float((whole.float() - want).abs().max()) <= 2.0 ** -7 * float(
        want.abs().max())


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_ring_attention_gradient_matches_the_dense_twin(causal):
    q, k, v = (torch.from_numpy(x).requires_grad_(True)
               for x in _qkv((2, 64, 4, 16), seed=2))
    d_out = torch.from_numpy(_qkv((2, 64, 4, 16), seed=3)[0])
    mesh = tpar.make_mesh(sp=8, devices=CPU8)
    got = torch.autograd.grad(tpar.ring_attention(q, k, v, mesh,
                                                  causal=causal),
                              (q, k, v), d_out)
    want = torch.autograd.grad(xla_attention(q, k, v, causal=causal),
                               (q, k, v), d_out)
    for name, g, w in zip("qkv", got, want):
        # f32 sums of up to 64 terms in other orders
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=1e-5 * float(w.abs().max()),
                                   err_msg=name)


def test_a_fully_masked_block_contributes_zero():
    q, k, v = (torch.from_numpy(x) for x in _qkv((1, 8, 2, 4), seed=4))
    o, m, l = _local_block(q, k, v, q_off=0, k_off=8, causal=True,
                           scale=0.5)
    assert not o.any() and not l.any()
    assert bool((m == -1e30).all())


# -- pipeline ----------------------------------------------------------------------------


def _mlp_layers(n_layers: int, dim: int, seed: int = 0) -> list:
    rng = np.random.default_rng(seed)
    return [{"w1": (rng.standard_normal((dim, dim)) * 0.1).astype(np.float32),
             "w2": (rng.standard_normal((dim, dim)) * 0.1).astype(np.float32)}
            for _ in range(n_layers)]


def _jax_block(layer, x):
    return x + jnp.tanh(x @ layer["w1"]) @ layer["w2"]


def _block(layer, x):
    return x + torch.tanh(x @ layer["w1"]) @ layer["w2"]


@pytest.mark.parametrize("staged", [False, True], ids=["whole", "staged"])
@pytest.mark.parametrize("m", [4, 8])
def test_pipeline_forward_matches_the_reference(m, staged):
    """``test_pipeline_forward_matches_sequential`` (dim 16, 8 layers, 4
    stages, ``rtol=atol=1e-5``) against the reference's pipeline."""
    layers = _mlp_layers(8, 16)
    x = np.random.default_rng(1).standard_normal((8, 4, 16), np.float32)
    jmesh = jpar.make_named_mesh({"pp": 4})
    want = np.asarray(jpar.pipeline_forward(
        _jax_block, jpar.stack_layers(jax.tree_util.tree_map(jnp.asarray,
                                                             layers)),
        jnp.asarray(x), jmesh, n_microbatches=m))
    mesh = tpar.make_named_mesh({"pp": 4}, devices=CPU8)
    stacked = tpar.stack_layers(params_from_jax(layers, "cpu"))
    if staged:
        stacked = tpar.shard_params(stacked, mesh, tpar.stage_specs(stacked))
        assert isinstance(stacked["w1"], Pieces) and len(stacked["w1"]) == 4
    got = tpar.pipeline_forward(_block, stacked, torch.from_numpy(x), mesh,
                                n_microbatches=m)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    seq = torch.from_numpy(x)
    for layer in params_from_jax(layers, "cpu"):
        seq = _block(layer, seq)
    np.testing.assert_allclose(got.numpy(), seq.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_pipeline_gradient_matches_jax_grad_of_the_sequential_program():
    """``test_pipeline_is_differentiable`` (dim 8, 4 layers, 4 stages, M=4,
    ``rtol=1e-4, atol=1e-5``): the port's pipeline gradient against
    ``jax.grad`` of the sequential program."""
    layers = _mlp_layers(4, 8, seed=2)
    x = np.random.default_rng(3).standard_normal((4, 2, 8), np.float32)

    def seq_loss(p_list):
        y = jnp.asarray(x)
        for layer in p_list:
            y = _jax_block(layer, y)
        return jnp.mean((y - 1.0) ** 2)

    want = jpar.stack_layers(jax.grad(seq_loss)(
        jax.tree_util.tree_map(jnp.asarray, layers)))
    mesh = tpar.make_named_mesh({"pp": 4}, devices=CPU8)
    stacked = {k: v.requires_grad_(True) for k, v in tpar.stack_layers(
        params_from_jax(layers, "cpu")).items()}
    y = tpar.pipeline_forward(_block, stacked, torch.from_numpy(x), mesh,
                              n_microbatches=4)
    torch.mean((y - 1.0) ** 2).backward()
    for k in ("w1", "w2"):
        np.testing.assert_allclose(stacked[k].grad.numpy(),
                                   np.asarray(want[k]), rtol=1e-4, atol=1e-5)


def test_stack_layers_and_stage_specs_match_the_reference():
    layers = _mlp_layers(4, 8)
    want = jpar.stack_layers(jax.tree_util.tree_map(jnp.asarray, layers))
    got = tpar.stack_layers(params_from_jax(layers, "cpu"))
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert (_spec_tuple(tpar.stage_specs(got))
            == _spec_tuple(jpar.stage_specs(want)))
    with pytest.raises(ValueError, match="not divisible"):
        tpar.pipeline_forward(_block, got, torch.zeros((6, 8)),
                              tpar.make_named_mesh({"pp": 4}, devices=CPU8))


# -- multi-host --------------------------------------------------------------------------


@pytest.mark.parametrize("env", [
    {},
    {"TPU9_GANG_SIZE": "1", "TPU9_GANG_RANK": "0"},
    {"TPU9_GANG_SIZE": "4", "TPU9_GANG_RANK": "2",
     "TPU9_COORDINATOR_ADDR": "10.0.0.1:8476"},
    {"TPU9_GANG_SIZE": "2"},
    {"TPU9_GANG_SIZE": "16", "TPU9_GANG_RANK": "0",
     "TPU9_COORDINATOR_ADDR": "host-0:1234"},
], ids=["empty", "one", "rank2of4", "no-rank", "coordinator"])
def test_multihost_env_matches_the_reference(env):
    want = jax_multihost_env(env)
    got = tpar.multihost_env(env)
    if want is None:
        assert got is None
        assert tpar.initialize_multihost(env) is None
        return
    assert (got.rank, got.size, got.coordinator, got.is_coordinator) == (
        want.rank, want.size, want.coordinator, want.is_coordinator)


def test_initialize_multihost_needs_a_gpu_unless_told_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default backend is NCCL")
    env = {"TPU9_GANG_SIZE": "2", "TPU9_GANG_RANK": "0",
           "TPU9_COORDINATOR_ADDR": "127.0.0.1:1"}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpar.initialize_multihost(env)


def _gang_member(rank: int, port: int, out) -> None:
    import torch.distributed as dist
    torch.set_num_threads(1)
    env = {"TPU9_GANG_RANK": str(rank), "TPU9_GANG_SIZE": "2",
           "TPU9_COORDINATOR_ADDR": f"127.0.0.1:{port}"}
    info = tpar.initialize_multihost(env, device="cpu")
    x = torch.tensor([float(rank + 1)])
    dist.all_reduce(x)
    out.put((info.rank, info.size, info.is_coordinator,
             dist.get_backend(), float(x)))
    dist.destroy_process_group()


def test_initialize_multihost_joins_a_gloo_group():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_gang_member, args=(r, port, out))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        got = sorted(out.get(timeout=120) for _ in procs)
    finally:
        for p in procs:
            p.join(timeout=60)
    assert all(p.exitcode == 0 for p in procs)
    assert got == [(0, 2, True, "gloo", 3.0), (1, 2, False, "gloo", 3.0)]
