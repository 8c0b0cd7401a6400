"""The port's CLIP vision embedder (``tpu9_torch/models/clip_vit.py``) and
its ``layer_norm`` (``tpu9_torch/ops/norms.py``) against the JAX package's
on the CPU. Inputs are made with numpy from a seed and handed to both
packages; JAX trees cross with ``params_from_jax``.

- ``patchify`` bit for bit against ``tpu9.models.clip_vit.patchify``, the
  case of ``tests/test_models.py::TestClip::test_patchify_layout``
  included.
- Unit embeddings against ``clip_vision_forward`` at ``CLIP_VIT_TINY`` and
  at the published ViT-L/14 widths cut to 2 layers (B=2, 224 px), f32 and
  bf16.
- ``layer_norm`` against both of the reference's private copies
  (``clip_vit._layer_norm`` and ``classifier._ln``).
- The init tree's paths, shapes and dtypes against ``init_clip_vision``'s,
  bf16 leaves through ``params_from_jax`` bit for bit, and no quiet fall
  back to the CPU.
- The CPU figures behind ``chip_smoke.py``'s ViT-L/14 limits, at full
  depth: the JAX package's bf16-vs-f32 gap and the port's f32 forward
  against the JAX one.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tpu9.models import classifier as jcls
from tpu9.models import clip_vit as jclip
from tpu9_torch.bridge import params_from_jax
from tpu9_torch.models import clip_vit as tclip
from tpu9_torch.ops.norms import layer_norm

torch.set_num_threads(2)

# f32: the two packages sum products of up to 4096 terms in other orders,
# each result within a few f32 ulps (about sqrt(K) * 2^-24 = 4e-6 relative
# at K = 4096); a unit embedding's entries are at most 1
F32_ATOL = 1e-5
# bf16: each entry of a unit embedding is the bf16 projection over its
# norm, so rounding the same value to a neighbouring bf16 moves it by one
# bf16 ulp: at most 2^-8 for an entry under 1, at most 2^-7 of the entry.
# Roundings upstream that land differently move the projection's input by
# the same relative amounts. Two ulps bound an entry (a CPU probe saw
# 2.2e-3 at the tiny config) and, relative to each entry, the difference
# vector's norm: |d| <= 2 * 2^-7, so 1 - cos = |d|^2 / 2 <= 2^-13
BF16_ATOL = 2.0 ** -7
BF16_COS = 1.0 - 2.0 ** -13


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _paths(tree, prefix=""):
    """{path: (shape, dtype name)} of a JAX or torch tree."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_paths(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_paths(v, f"{prefix}/{i}"))
        return out
    name = str(tree.dtype).replace("torch.", "")
    return {prefix: (tuple(tree.shape), name)}


def _configs(name: str, dtype: str):
    jcfg = {"tiny": jclip.CLIP_VIT_TINY,
            "l14x2": dataclasses.replace(jclip.CLIP_VIT_L14, n_layers=2)}[name]
    tcfg = {"tiny": tclip.CLIP_VIT_TINY,
            "l14x2": dataclasses.replace(tclip.CLIP_VIT_L14, n_layers=2)}[name]
    if dtype == "f32":
        jcfg = dataclasses.replace(jcfg, dtype=jnp.float32)
        tcfg = dataclasses.replace(tcfg, dtype=torch.float32)
    return jcfg, tcfg


# -- patchify -------------------------------------------------------------------

def test_patchify_layout_case_is_bit_exact():
    img = np.arange(2 * 4 * 4 * 3, dtype=np.float32).reshape(2, 4, 4, 3)
    want = np.asarray(jclip.patchify(jnp.asarray(img), 2))
    got = tclip.patchify(torch.from_numpy(img), 2).numpy()
    assert got.shape == (2, 4, 12)
    np.testing.assert_array_equal(got, want)
    # the first patch is rows 0..1 x cols 0..1, in (row, column, channel)
    np.testing.assert_array_equal(got[0, 0], img[0, :2, :2].reshape(-1))


@pytest.mark.parametrize("shape,patch", [((3, 28, 28, 3), 14),
                                         ((2, 224, 224, 3), 14),
                                         ((1, 12, 18, 3), 6)])
def test_patchify_is_bit_exact(shape, patch):
    img = np.random.default_rng(3).random(shape, dtype=np.float32)
    want = np.asarray(jclip.patchify(jnp.asarray(img), patch))
    got = tclip.patchify(torch.from_numpy(img), patch).numpy()
    np.testing.assert_array_equal(got, want)


# -- the forward ------------------------------------------------------------------

@pytest.mark.parametrize("name,dtype,batch", [("tiny", "f32", 3),
                                              ("tiny", "bf16", 3),
                                              ("l14x2", "f32", 2),
                                              ("l14x2", "bf16", 2)])
def test_embeddings_match_jax(name, dtype, batch):
    jcfg, tcfg = _configs(name, dtype)
    jparams = jclip.init_clip_vision(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(_np_tree(jparams), "cpu")
    images = np.random.default_rng(1).random(
        (batch, jcfg.image_size, jcfg.image_size, 3), dtype=np.float32)
    want = np.asarray(jclip.clip_vision_forward(jparams, jnp.asarray(images),
                                                jcfg))
    got = tclip.clip_vision_forward(tparams, images, tcfg)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    got = got.numpy()
    assert got.shape == (batch, jcfg.embed_dim)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, rtol=1e-5)
    err = np.abs(got - want).max()
    if dtype == "f32":
        assert err <= F32_ATOL, err
    else:
        assert err <= BF16_ATOL, err
        assert (got * want).sum(-1).min() >= BF16_COS


# -- layer_norm --------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("eps", [1e-5, 1e-12])
def test_layer_norm_matches_both_jax_copies(dtype, eps):
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((4, 9, 96)) * 3 + 1).astype(np.float32)
    scale = rng.standard_normal(96).astype(np.float32)
    bias = rng.standard_normal(96).astype(np.float32)
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    jx = jnp.asarray(x).astype(jdt)
    tx = params_from_jax(np.asarray(jx), "cpu")
    got = layer_norm(tx, torch.from_numpy(scale), torch.from_numpy(bias), eps)
    assert got.dtype == tx.dtype
    got = got.float().numpy()
    for want in (jclip._layer_norm(jx, {"scale": scale, "bias": bias}, eps),
                 jcls._ln(jx, scale, bias, eps)):
        want = np.asarray(want.astype(jnp.float32))
        if dtype == "f32":
            # the variance in another order: a few f32 ulps of outputs
            # of a few units
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        else:
            # one f32 ulp apart before the cast can round to neighbouring
            # bf16 values: one bf16 ulp, at most 2^-7 of the value
            np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=0)


# -- the tree -----------------------------------------------------------------------

@pytest.mark.parametrize("name", ["tiny", "l14"])
def test_init_tree_matches_jax(name):
    jcfg = {"tiny": jclip.CLIP_VIT_TINY, "l14": jclip.CLIP_VIT_L14}[name]
    tcfg = {"tiny": tclip.CLIP_VIT_TINY, "l14": tclip.CLIP_VIT_L14}[name]
    want = _paths(jax.eval_shape(lambda k: jclip.init_clip_vision(k, jcfg),
                                 jax.random.PRNGKey(0)))
    if name == "tiny":
        gen = torch.Generator().manual_seed(0)
        tree = tclip.init_clip_vision(tcfg, gen, "cpu")
        # the class token starts at zero and the norms at identity
        assert not tree["cls_token"].any()
        assert torch.equal(tree["ln_pre"]["scale"], torch.ones(tcfg.dim))
        # the same seed draws the same tree
        again = tclip.init_clip_vision(tcfg, torch.Generator().manual_seed(0),
                                       "cpu")
        assert all(torch.equal(a, b) for a, b in
                   zip(jax.tree_util.tree_leaves(tree),
                       jax.tree_util.tree_leaves(again)))
    else:
        # ViT-L/14 on "meta": shapes and dtypes, nothing drawn
        tree = tclip.init_clip_vision(tcfg, None, "meta")
    assert _paths(tree) == want
    assert tclip.ClipVisionConfig().n_patches == 256
    assert tcfg.head_dim == jcfg.head_dim


def test_params_from_jax_moves_clip_bf16_leaves_bit_exact():
    jparams = _np_tree(jclip.init_clip_vision(jax.random.PRNGKey(2),
                                              jclip.CLIP_VIT_TINY))
    tparams = params_from_jax(jparams, "cpu")
    jl, tl = jax.tree_util.tree_leaves(jparams), jax.tree_util.tree_leaves(
        tparams)
    assert len(jl) == len(tl)
    bf16 = 0
    for a, b in zip(jl, tl):
        if a.dtype.name == "bfloat16":
            bf16 += 1
            assert b.dtype == torch.bfloat16
            np.testing.assert_array_equal(b.view(torch.int16).numpy(),
                                          a.view(np.int16))
        else:
            assert b.dtype == torch.float32
            np.testing.assert_array_equal(b.numpy(), a)
    # patch_proj, cls_token, pos_embed, proj and four products a layer
    assert bf16 == 4 + 4 * jclip.CLIP_VIT_TINY.n_layers


def test_init_without_a_device_raises_instead_of_using_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is that device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tclip.init_clip_vision(tclip.CLIP_VIT_TINY, torch.Generator())
    params = tclip.init_clip_vision(tclip.CLIP_VIT_TINY, torch.Generator(),
                                    device="cpu")
    assert params["proj"].device.type == "cpu"


def test_full_depth_figures_behind_the_card_limits():
    """``chip_smoke.VISION_BF16_COS`` allows four times the JAX package's
    own bf16-vs-f32 gap at full depth on these seeds, and
    ``VISION_F32_ATOL`` a wide margin over the gap between two f32
    implementations at full depth; the card's machine has no JAX, so both
    are derived here."""
    cfg = jclip.CLIP_VIT_L14
    cfg32 = dataclasses.replace(cfg, dtype=jnp.float32)
    p16 = jclip.init_clip_vision(jax.random.PRNGKey(0), cfg)
    p32 = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), p16)
    images = np.random.default_rng(1).random((8, 224, 224, 3),
                                             dtype=np.float32)
    e16 = np.asarray(jax.jit(lambda p, x: jclip.clip_vision_forward(
        p, x, cfg))(p16, images))
    e32 = np.asarray(jax.jit(lambda p, x: jclip.clip_vision_forward(
        p, x, cfg32))(p32, images))
    gap = 1.0 - (e16 * e32).sum(-1).min()
    # the constant is this gap (rounded up); a CPU of another kind may
    # round a few bf16 values differently
    assert gap <= chip_smoke.VISION_JAX_BF16_GAP * 1.05, gap
    assert chip_smoke.VISION_BF16_COS == 1.0 - 4 * chip_smoke.VISION_JAX_BF16_GAP
    got = tclip.clip_vision_forward(
        params_from_jax(_np_tree(p32), "cpu"), images[:2],
        dataclasses.replace(tclip.CLIP_VIT_L14, dtype=torch.float32)).numpy()
    assert np.abs(got - e32[:2]).max() * 10 <= chip_smoke.VISION_F32_ATOL
