"""The port's text classifier (``tpu9_torch/models/classifier.py``) against
the JAX package's on the CPU. Inputs are made with numpy from a seed and
handed to both packages; JAX trees cross with ``params_from_jax``.

- Logits against ``classifier_forward`` at ``TEXTCLS_TINY`` and at the
  default config's distilbert widths cut to 2 layers (T=128), with mixed
  mask lengths.
- The mask's cases: padding invariance (the mirror of
  ``tests/test_models.py::TestClassifier::test_padding_invariance``) and a
  fully masked row, whose logits are exactly zero in both packages.
- The embedding gather: negative and out-of-range ids read the rows JAX's
  clamped gather reads, and a sequence longer than ``max_len`` fails in
  both packages.
- The init tree's paths, shapes and dtypes against ``init_classifier``'s,
  and no quiet fall back to the CPU.
- The CPU figure behind ``chip_smoke.CLS_ATOL``: the port against the JAX
  package at the full config.
- One LocalStack e2e: ``examples/01``'s endpoint shape, its ``on_start``
  building the port's classifier on the CPU over the JAX package's
  ``TEXTCLS_TINY`` weights, served behind the unchanged
  ``tpu9/runner/endpoint.py``.
"""

import dataclasses
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tpu9.models import classifier as jcls
from tpu9_torch.bridge import params_from_jax
from tpu9_torch.models import classifier as tcls

torch.set_num_threads(2)

# f32 throughout: the two packages sum products of up to 3072 terms in
# other orders (about sqrt(K) * 2^-24 = 3.3e-6 relative), and the post-norm
# layers keep activations near unit size; logits stay under a few units
F32_ATOL = 1e-5


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


def _configs(name: str):
    if name == "tiny":
        return jcls.TEXTCLS_TINY, tcls.TEXTCLS_TINY
    return (dataclasses.replace(jcls.TextClassifierConfig(), n_layers=2),
            dataclasses.replace(tcls.TextClassifierConfig(), n_layers=2))


def _pair(name: str, seed: int = 0):
    jcfg, tcfg = _configs(name)
    jparams = jcls.init_classifier(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, jparams, params_from_jax(_np_tree(jparams), "cpu")


def _both(jparams, tparams, jcfg, tcfg, tokens, mask):
    want = np.asarray(jcls.classifier_forward(
        jparams, jnp.asarray(tokens), jnp.asarray(mask), jcfg))
    got = tcls.classifier_forward(tparams, torch.from_numpy(tokens),
                                  torch.from_numpy(mask), tcfg)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    return want, got.numpy()


def _mask(lens, t):
    return (np.arange(t)[None] < np.asarray(lens)[:, None]).astype(np.int32)


@pytest.mark.parametrize("name,t,lens", [("tiny", 32, [32, 17, 5, 1]),
                                         ("distil2", 128, [128, 100, 37, 1])])
def test_logits_match_jax(name, t, lens):
    jcfg, tcfg, jparams, tparams = _pair(name)
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, jcfg.vocab_size, (len(lens), t)).astype(np.int32)
    want, got = _both(jparams, tparams, jcfg, tcfg, tokens, _mask(lens, t))
    assert got.shape == (len(lens), jcfg.n_classes)
    assert np.abs(got - want).max() <= F32_ATOL


def test_padding_invariance():
    cfg = jcls.TEXTCLS_TINY
    jcfg, tcfg, jparams, tparams = _pair("tiny")
    t1 = np.array([[5, 6, 7, 0, 0, 0, 0, 0]], dtype=np.int32)
    m1 = np.array([[1, 1, 1, 0, 0, 0, 0, 0]], dtype=np.int32)
    t2 = np.array([[5, 6, 7, 99, 98, 97, 96, 95]], dtype=np.int32)
    want1, l1 = _both(jparams, tparams, jcfg, tcfg, t1, m1)
    _, l2 = _both(jparams, tparams, jcfg, tcfg, t2, m1)
    assert l1.shape == (1, cfg.n_classes)
    # the reference test's tolerance; a masked key's probability is
    # exactly zero in f32 (exp(-1e30 - max)), so garbage there moves nothing
    np.testing.assert_allclose(l1, l2, atol=1e-4)
    assert np.abs(l1 - want1).max() <= F32_ATOL


def test_fully_masked_row_gives_zero_logits():
    jcfg, tcfg, jparams, tparams = _pair("tiny")
    tokens = np.random.default_rng(5).integers(
        0, jcfg.vocab_size, (3, 16)).astype(np.int32)
    mask = _mask([16, 0, 4], 16)
    want, got = _both(jparams, tparams, jcfg, tcfg, tokens, mask)
    # the row attends uniformly (every score -1e30, never NaN) and pools
    # 0 / max(0, 1); the head has no bias
    assert np.all(want[1] == 0) and np.all(got[1] == 0)
    assert np.all(np.isfinite(got))
    assert np.abs(got - want).max() <= F32_ATOL


def test_out_of_range_ids_read_the_clamped_rows():
    jcfg, tcfg, jparams, tparams = _pair("tiny")
    v = jcfg.vocab_size
    ids = np.array([v + 5, -1, -v - 7, v - 1, 0, -v, 3 * v, 17], dtype=np.int32)
    # the rows JAX's gather reads, index for index
    rows = np.asarray(jnp.arange(v)[jnp.asarray(ids)])
    assert tcls.clamp_ids(torch.from_numpy(ids), v).tolist() == rows.tolist()
    tokens = np.stack([ids, np.roll(ids, 3)])
    mask = np.ones_like(tokens)
    want, got = _both(jparams, tparams, jcfg, tcfg, tokens, mask)
    assert np.abs(got - want).max() <= F32_ATOL
    # the same logits as the clamped ids themselves, bit for bit
    clamped = tcls.classifier_forward(
        tparams, torch.from_numpy(np.stack([rows, np.roll(rows, 3)])),
        torch.from_numpy(mask), tcfg).numpy()
    np.testing.assert_array_equal(got, clamped)


def test_a_sequence_past_max_len_fails_in_both():
    jcfg, tcfg, jparams, tparams = _pair("tiny")
    t = jcfg.max_len + 1
    tokens = np.zeros((1, t), dtype=np.int32)
    mask = np.ones_like(tokens)
    with pytest.raises((TypeError, ValueError)):
        jcls.classifier_forward(jparams, jnp.asarray(tokens),
                                jnp.asarray(mask), jcfg)
    with pytest.raises(RuntimeError):
        tcls.classifier_forward(tparams, torch.from_numpy(tokens),
                                torch.from_numpy(mask), tcfg)


def test_full_config_figure_behind_the_card_limit():
    """``chip_smoke.CLS_ATOL`` keeps a margin of about ten over the gap
    between two f32 implementations at the full config and the phase's
    lengths; the card's machine has no JAX, so it is derived here."""
    jcfg, tcfg = jcls.TextClassifierConfig(), tcls.TextClassifierConfig()
    jparams = jcls.init_classifier(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(_np_tree(jparams), "cpu")
    b, t = chip_smoke.CLS_TOKENS
    tokens = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (b, t)).astype(np.int32)
    want, got = _both(jparams, tparams, jcfg, tcfg, tokens,
                      _mask(chip_smoke.CLS_LENS, t))
    assert np.abs(got - want).max() * 8 <= chip_smoke.CLS_ATOL


@pytest.mark.parametrize("name", ["tiny", "default"])
def test_init_tree_matches_jax(name):
    jcfg = {"tiny": jcls.TEXTCLS_TINY,
            "default": jcls.TextClassifierConfig()}[name]
    tcfg = {"tiny": tcls.TEXTCLS_TINY,
            "default": tcls.TextClassifierConfig()}[name]
    want = _paths(jax.eval_shape(lambda k: jcls.init_classifier(k, jcfg),
                                 jax.random.PRNGKey(0)))
    if name == "tiny":
        tree = tcls.init_classifier(tcfg, torch.Generator().manual_seed(0),
                                    "cpu")
        layer = tree["layers"][0]
        assert torch.equal(layer["ln1_scale"], torch.ones(tcfg.dim))
        assert not layer["ln2_bias"].any()
        # the same seed draws the same tree
        again = tcls.init_classifier(tcfg, torch.Generator().manual_seed(0),
                                     "cpu")
        assert all(torch.equal(a, b) for a, b in
                   zip(jax.tree_util.tree_leaves(tree),
                       jax.tree_util.tree_leaves(again)))
    else:
        # distilbert widths on "meta": shapes and dtypes, nothing drawn
        tree = tcls.init_classifier(tcfg, None, "meta")
    assert _paths(tree) == want


def test_init_without_a_device_raises_instead_of_using_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is that device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcls.init_classifier(tcls.TEXTCLS_TINY, torch.Generator())
    params = tcls.init_classifier(tcls.TEXTCLS_TINY, torch.Generator(),
                                  device="cpu")
    assert params["head"].device.type == "cpu"


# -- the port's classifier behind the real endpoint runner (LocalStack) ----------

CLASSIFIER_APP = '''
import zlib

from tpu9 import endpoint


def tokenize(text, vocab):
    # a stable id a word: Python's hash() is salted per process
    return [zlib.crc32(w.encode()) % vocab for w in text.split()[:32]] or [0]


def load_model():
    # examples/01's fallback model: the JAX package's TEXTCLS_TINY weights
    # from PRNGKey(0), carried to the port's classifier on the CPU
    import jax
    import numpy as np
    import torch
    from tpu9.models.classifier import TEXTCLS_TINY as JAX_TINY
    from tpu9.models.classifier import init_classifier
    from tpu9_torch.bridge import params_from_jax
    from tpu9_torch.models.classifier import TEXTCLS_TINY, classifier_forward

    torch.set_num_threads(1)
    params = params_from_jax(jax.tree_util.tree_map(
        np.asarray, init_classifier(jax.random.PRNGKey(0), JAX_TINY)), "cpu")

    def tiny(text):
        tokens = torch.tensor([tokenize(text, TEXTCLS_TINY.vocab_size)])
        logits = classifier_forward(params, tokens, torch.ones_like(tokens),
                                    TEXTCLS_TINY)
        label = int(logits.argmax())
        return [{"label": ["NEGATIVE", "POSITIVE"][label],
                 "score": float(torch.softmax(logits, -1)[0, label]),
                 "tokens": tokens[0].tolist()}]

    return tiny


@endpoint(cpu=1, memory="2Gi", keep_warm_seconds=120, on_start=load_model)
def classify(text: str = "", context=None):
    return {"prediction": context(text)[0]}
'''


def _jax_prediction(text: str) -> dict:
    cfg = jcls.TEXTCLS_TINY
    tokens = [zlib.crc32(w.encode()) % cfg.vocab_size
              for w in text.split()[:32]] or [0]
    params = jcls.init_classifier(jax.random.PRNGKey(0), cfg)
    toks = jnp.asarray([tokens])
    logits = jcls.classifier_forward(params, toks, jnp.ones_like(toks), cfg)
    label = int(logits.argmax())
    return {"label": ["NEGATIVE", "POSITIVE"][label],
            "score": float(jax.nn.softmax(logits)[0, label]),
            "tokens": tokens}


@pytest.mark.e2e
async def test_torch_classifier_serves_behind_the_endpoint_runner():
    from tpu9.testing.localstack import LocalStack

    texts = ["tpu9 is great", "the port serves an encoder on the card too",
             ""]
    wants = [_jax_prediction(t) for t in texts]
    async with LocalStack() as stack:
        dep = await stack.deploy_endpoint(
            "sentiment-torch", {"app.py": CLASSIFIER_APP}, "app:classify",
            # kept warm well past the test, or the replica could scale to
            # zero between requests
            config_extra={"timeout_s": 120.0, "keep_warm_seconds": 120.0,
                          "runtime": {"cpu_millicores": 1000,
                                      "memory_mb": 3072},
                          "autoscaler": {"max_containers": 1}})
        for text, want in zip(texts, wants):
            out = await stack.invoke(dep, {"text": text}, timeout=180.0)
            got = out["prediction"]
            assert got["tokens"] == want["tokens"]
            assert got["label"] == want["label"]
            # one softmax of f32 logits F32_ATOL apart
            assert abs(got["score"] - want["score"]) <= F32_ATOL, (got, want)
