"""The port's LoRA and train layers (``tpu9_torch/models/lora.py``,
``tpu9_torch/train``, the flash kernel's gradient in
``tpu9_torch/ops/attention.py``, ``decoder_core``) against the JAX
package's on the CPU. Inputs are made with numpy from a seed and handed to
both packages; JAX trees cross with ``params_from_jax``.

- ``init_lora``'s tree (paths, shapes, dtypes, zero ``b``, ``a``'s spread),
  ``lora_scale`` and ``trainable_count`` against ``tpu9.models.lora``;
  ``merge`` bit for bit at an f32 and a bf16 base, with ``scale`` given and
  ``None``.
- ``causal_lm_loss`` with and without a mask (the mirror of
  ``tests/test_parallel.py::test_causal_lm_loss_masking``, and random
  logits within ``rtol=1e-6``).
- ``FlashAttention``'s backward (on a CPU tensor the twin of the backward
  kernel, ``xla_attention_backward``: probabilities from the forward's
  saved log-sum-exp, delta from its output) against ``jax.grad`` of
  ``tpu9.ops.attention.xla_attention`` at f32: causal and full, QH/KH 4/4,
  4/2, 4/1, D 64, 128 and 256, T=S 128 and 256, and full attention over
  more keys than queries (S = 2T), each gradient within ``1e-5 *
  max|reference|`` (f32 sums of up to 256 products in other orders);
  ``attention``'s routing under grad and without it; the backward
  wrapper's twin, launch count and refusals on the CPU.
- ``decoder_core``'s parameter gradients against ``jax.value_and_grad`` of
  the reference's loss, remat on and off, ``rtol=1e-4`` of each leaf's
  largest entry.
- ``adam`` and ``adamw`` against optax over three steps (updates, moments,
  count; ``rtol=1e-6``), the state's dtype, and ``global_norm``.
- Three LoRA steps on llama-tiny and gemma-tiny (f32, head_dim 64 and 128
  tokens, so attention takes the flash route; remat on and off) against
  ``build_lora_train_step`` with ``optax.adam(1e-2)``, and two full steps
  on llama-tiny against ``build_train_step`` with ``optax.adam(1e-3)``:
  losses within ``rtol=1e-6`` and ``grad_norm`` within ``rtol=1e-5``;
  adapters and params within ``atol=2e-4``. Adam divides each gradient's
  f32 rounding by ``|g| + eps``, so an entry whose gradient is near zero
  can move by a sizeable part of one step (``lr``) in one package and not
  the other: 4.4e-5 at most was seen, against steps of 1e-2 and 1e-3.
- Single-process mirrors of ``tests/test_parallel.py``'s
  ``test_fsdp_train_step_loss_decreases``, ``test_lora_fsdp_train_step``
  and ``test_moe_train_step_loss_decreases`` (no mesh), the MoE one step
  for step against the reference's losses; ``moe_ffn``'s gradients, the
  input's included, against ``jax.grad``.
- Adapters saved by either package's ``ckpt.save_params`` (the
  ``lora_adapters`` name of ``examples/05``) are byte-identical and load
  in the other bit for bit.
- The steps leave their inputs as they were, run on the CUDA device by
  default (raising here), and refuse trees on another device.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpu9.models import decoder_forward as jax_forward
from tpu9.models import init_decoder as jax_init_decoder
from tpu9.models import lora as jlora
from tpu9.models import moe as jmoe
from tpu9.models.gemma import GEMMA_PRESETS as JAX_GEMMA
from tpu9.models.llama import LLAMA_PRESETS as JAX_LLAMA
from tpu9.ops.attention import xla_attention as jax_xla_attention
from tpu9.runner import ckpt as jckpt
from tpu9.serving import weights as jw
from tpu9.train import build_lora_train_step as jax_build_lora_step
from tpu9.train import build_train_step as jax_build_train_step
from tpu9.train import causal_lm_loss as jax_causal_lm_loss
from tpu9.train.trainer import init_train_state as jax_init_train_state
from tpu9_torch.bridge import params_from_jax
from tpu9_torch.models import lora as tlora
from tpu9_torch.models import moe as tmoe
from tpu9_torch.models.gemma import GEMMA_PRESETS
from tpu9_torch.models.llama import LLAMA_PRESETS
from tpu9_torch.models.transformer import decoder_core, decoder_forward
from tpu9_torch.ops import attention as at
from tpu9_torch.runner import ckpt as tckpt
from tpu9_torch.serving import weights as tw
from tpu9_torch.train import (TrainState, build_lora_train_step,
                              build_train_step, causal_lm_loss, optim)
from tpu9_torch.train.trainer import init_train_state, lora_value_and_grad

torch.set_num_threads(2)

MODELS = {"llama-tiny": (JAX_LLAMA, LLAMA_PRESETS),
          "gemma-tiny": (JAX_GEMMA, GEMMA_PRESETS)}


def _cfgs(name: str, head_dim: int = 64):
    """The JAX and port configs of a tiny preset at f32; head_dim 64 puts
    block-aligned attention on the flash route."""
    jax_presets, presets = MODELS[name]
    return (dataclasses.replace(jax_presets[name], dtype=jnp.float32,
                                head_dim=head_dim),
            dataclasses.replace(presets[name], dtype=torch.float32,
                                head_dim=head_dim))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            return x.view(torch.uint16).numpy()
        return x.numpy()
    arr = np.asarray(x)
    return arr.view(np.uint16) if arr.dtype.name == "bfloat16" else arr


def _pairs(jtree, ttree):
    """(path, JAX leaf, port leaf) in JAX's flattening order."""
    jleaves = jax.tree_util.tree_leaves_with_path(jax.device_get(jtree))
    tleaves = optim.tree_leaves(ttree)
    assert len(jleaves) == len(tleaves)
    return [(jax.tree_util.keystr(p), a, b)
            for (p, a), b in zip(jleaves, tleaves)]


def _tokens(vocab: int, shape, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, shape
                                                ).astype(np.int32)


def _jax_model(name: str, head_dim: int = 64, seed: int = 0):
    jcfg, tcfg = _cfgs(name, head_dim)
    jparams = jax_init_decoder(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, jparams, params_from_jax(jax.device_get(jparams),
                                                "cpu")


# -- LoRA: init, scale, merge -------------------------------------------------------


@pytest.mark.parametrize("name", list(MODELS))
def test_init_lora_tree_matches_the_reference(name):
    jcfg, tcfg, jparams, tparams = _jax_model(name, head_dim=32)
    rank = 8
    jad = jlora.init_lora(jax.random.PRNGKey(1), jparams, rank=rank)
    tad = tlora.init_lora(torch.Generator().manual_seed(1), tparams,
                          rank=rank)
    pairs = _pairs(jad, tad)
    assert [p for p, _, _ in pairs] == [
        f"['layers'][{i}]['{w}']['{ab}']" for i in range(jcfg.n_layers)
        for w in sorted(tlora.DEFAULT_TARGETS) for ab in "ab"]
    for path, a, b in pairs:
        assert b.dtype == torch.float32 and tuple(b.shape) == a.shape, path
        if path.endswith("['b']"):
            assert not b.any(), path
        else:
            # N(0, 1) / rank, as the reference draws it
            assert abs(float(b.std()) * rank - 1) < 0.1, path
    assert tlora.trainable_count(tad) == jlora.trainable_count(jad)
    # a target the layer lacks is skipped, as in the reference
    only = tlora.init_lora(torch.Generator(), tparams, 2, ("wq", "w_x"))
    assert [list(layer) for layer in only["layers"]] == [["wq"]] * 2


def test_lora_scale_is_the_references():
    for rank in (1, 4, 8, 16, 64):
        assert tlora.lora_scale(rank) == jlora.lora_scale(rank)
        assert tlora.lora_scale(rank, 32.0) == jlora.lora_scale(rank, 32.0)


@pytest.mark.parametrize("scale", [2.0, None], ids=["scale2", "rank-scale"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_merge_is_the_references_bit_for_bit(dtype, scale):
    jcfg = dataclasses.replace(JAX_GEMMA["gemma-tiny"],
                               dtype=getattr(jnp, dtype))
    jparams = jax_init_decoder(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(4)
    jad = jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.standard_normal(x.shape, np.float32) * 0.01),
        jlora.init_lora(jax.random.PRNGKey(1), jparams, rank=8))
    want = jlora.merge(jparams, jad, scale)
    tparams = params_from_jax(jax.device_get(jparams), "cpu")
    got = tlora.merge(tparams, params_from_jax(jax.device_get(jad), "cpu"),
                      scale)
    for path, a, b in _pairs(want, got):
        # bf16 compares as its 16-bit words, so the dtypes must agree too
        assert str(a.dtype) == str(b.dtype).removeprefix("torch."), path
        np.testing.assert_array_equal(_np(a), _np(b), err_msg=path)
    # untouched leaves are the base tree's own tensors
    assert got["embed"] is tparams["embed"]
    assert got["layers"][0]["w_up"] is tparams["layers"][0]["w_up"]


# -- the loss -------------------------------------------------------------------------


def test_causal_lm_loss_masking():
    logits = torch.zeros((1, 4, 8))
    tokens = torch.tensor([[1, 2, 3, 4]])
    mask = torch.tensor([[1, 1, 0, 0]])
    # uniform logits: nll = log(8) either way
    np.testing.assert_allclose(float(causal_lm_loss(logits, tokens)),
                               np.log(8.0), rtol=1e-5)
    np.testing.assert_allclose(float(causal_lm_loss(logits, tokens, mask)),
                               np.log(8.0), rtol=1e-5)
    # no target left: the denominator is max(sum, 1)
    assert float(causal_lm_loss(logits, tokens, torch.zeros_like(mask))) == 0


@pytest.mark.parametrize("masked", [False, True], ids=["mean", "masked"])
def test_causal_lm_loss_matches_the_reference(masked):
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((3, 17, 50), np.float32) * 3
    tokens = rng.integers(0, 50, (3, 17)).astype(np.int32)
    mask = (rng.random((3, 17)) < 0.6).astype(np.int32) if masked else None
    want = jax_causal_lm_loss(jnp.asarray(logits), jnp.asarray(tokens),
                              None if mask is None else jnp.asarray(mask))
    got = causal_lm_loss(torch.from_numpy(logits), torch.from_numpy(tokens),
                         None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# -- B3's gradient -----------------------------------------------------------------------


def _flash_grads_against_jax(causal: bool, heads, head_dim: int, t: int,
                             s: int, seed: int) -> None:
    """``FlashAttention``'s gradients on CPU tensors against ``jax.grad`` of
    the JAX ``xla_attention`` on the same f32 inputs."""
    q_heads, kv_heads = heads
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((2, t, q_heads, head_dim), np.float32)
    k, v = (rng.standard_normal((2, s, kv_heads, head_dim), np.float32)
            for _ in range(2))
    d_out = rng.standard_normal(q.shape, np.float32)

    def jloss(q, k, v):
        return jnp.sum(jax_xla_attention(q, k, v, causal=causal) * d_out)

    want = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = at.attention(tq, tk, tv, causal=causal)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    (out * torch.from_numpy(d_out)).sum().backward()
    for name, x, w in zip("qkv", (tq, tk, tv), want):
        w = np.asarray(w)
        assert x.grad.shape == w.shape and x.grad.dtype == torch.float32
        np.testing.assert_allclose(x.grad.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(),
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("t", [128, 256])
@pytest.mark.parametrize("head_dim", [64, 128, 256])
@pytest.mark.parametrize("heads", [(4, 4), (4, 2), (4, 1)],
                         ids=["4-4", "4-2", "4-1"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_backward_matches_jax_grad_of_the_twin(causal, heads, head_dim,
                                                     t):
    _flash_grads_against_jax(causal, heads, head_dim, t, t,
                             t + head_dim + heads[0] * heads[1] + int(causal))


@pytest.mark.parametrize("head_dim", [64, 128, 256])
@pytest.mark.parametrize("heads", [(4, 2), (2, 1)], ids=["4-2", "2-1"])
def test_flash_backward_full_attention_over_more_keys(heads, head_dim):
    """S = 2T, full attention (the flash route takes any S that is a
    multiple of 128)."""
    _flash_grads_against_jax(False, heads, head_dim, 128, 256,
                             7 + head_dim + heads[0])


def test_flash_backward_wrapper_on_the_cpu():
    """On CPU tensors the wrapper computes the twin and counts no launch;
    the forward's lse is the twin's; an operand the kernel could not take
    raises before anything touches CUDA."""
    rng = np.random.default_rng(9)
    q, d_out = (torch.from_numpy(rng.standard_normal((1, 128, 4, 64),
                                                     np.float32))
                for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((1, 128, 2, 64), np.float32))
            for _ in range(2))
    out, lse = at.flash_attention(q, k, v, causal=True, with_lse=True)
    assert torch.equal(out, at.xla_attention(q, k, v))
    assert lse.shape == (1, 4, 128) and lse.dtype == torch.float32
    got = at.flash_attention_backward(q, k, v, out, lse, d_out, True)
    want = at.xla_attention_backward(q, k, v, out, lse, d_out, True)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert at.flash_attention_backward.launches == 0
    bf = [x.bfloat16() for x in (q, k, v, out, d_out)]
    with pytest.raises(ValueError, match="lse"):
        at._launch_flash_backward(*bf[:4], lse[:, :, :64], bf[4], True)
    with pytest.raises(ValueError, match="d_out"):
        at._launch_flash_backward(*bf[:4], lse, bf[4][:, :64], True)
    with pytest.raises(ValueError, match="bf16"):
        at._launch_flash_backward(q, k, v, out, lse, d_out, True)
    with pytest.raises(ValueError, match="no flash attention backward"):
        at.flash_attention_backward(*(x.to("meta") for x in
                                      (q, k, v, out, lse, d_out)), True)


def test_attention_routes_to_the_function_only_under_grad():
    rng = np.random.default_rng(6)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 128, 2, 64),
                                                    np.float32))
               for _ in range(3))
    want = at.xla_attention(q, k, v)
    # serving: no input requires grad, so the wrapper itself
    out = at.attention(q, k, v)
    assert out.grad_fn is None and torch.equal(out, want)
    q.requires_grad_(True)
    with torch.no_grad():
        assert at.attention(q, k, v).grad_fn is None
    out = at.attention(q, k, v)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    assert torch.equal(out.detach(), want)
    # a shape off the flash route is differentiated by autograd itself
    plain = at.attention(q[:, :100], k[:, :100], v[:, :100])
    assert type(plain.grad_fn).__name__ != "FlashAttentionBackward"
    # the CPU twin counts no kernel launch
    assert at.flash_attention.launches == 0


def test_serving_forward_carries_no_gradient():
    _, tcfg, _, tparams = _jax_model("llama-tiny")
    for leaf in optim.tree_leaves(tparams):
        leaf.requires_grad_(True)
    tokens = torch.from_numpy(_tokens(tcfg.vocab_size, (1, 128), 7))
    with torch.enable_grad():
        logits = decoder_forward(tparams, tokens, tcfg)
        core = decoder_core(tparams, tokens, tcfg)
    assert not logits.requires_grad and core.requires_grad
    assert torch.equal(logits, core.detach())
    with pytest.raises(ValueError, match="no-cache"):
        decoder_core(tparams, tokens, tcfg, kv_cache={}, remat=True)


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no-remat"])
@pytest.mark.parametrize("name", list(MODELS))
def test_decoder_gradients_match_jax(name, remat, monkeypatch):
    jcfg, tcfg, jparams, tparams = _jax_model(name)
    tokens = _tokens(jcfg.vocab_size, (2, 128), 8)

    def jloss(params):
        return jax_causal_lm_loss(jax_forward(params, jnp.asarray(tokens),
                                              jcfg), jnp.asarray(tokens))

    jl, jgrads = jax.value_and_grad(jloss)(jparams)
    backwards = []
    real = at.flash_attention_backward
    monkeypatch.setattr(at, "flash_attention_backward",
                        lambda *a: backwards.append(1) or real(*a))
    params = optim.tree_map(lambda x: x.clone().requires_grad_(True),
                            tparams)
    loss = causal_lm_loss(decoder_core(params, torch.from_numpy(tokens),
                                       tcfg, remat=remat),
                          torch.from_numpy(tokens))
    loss.backward()
    assert len(backwards) == tcfg.n_layers     # the flash route, each layer
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-6)
    for path, want, got in _pairs(jgrads, params):
        want = np.asarray(want)
        np.testing.assert_allclose(got.grad.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=path)


# -- the optimizers -----------------------------------------------------------------------


def _opt_tree(seed: int, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((6, 5)).astype(dtype),
            "layers": [{"a": rng.standard_normal((5, 3)).astype(dtype),
                        "b": np.zeros((3, 4), dtype)} for _ in range(2)]}


def _to_torch(tree):
    return optim.tree_map(lambda x: torch.from_numpy(np.array(x)), tree)


@pytest.mark.parametrize("kind", ["adam", "adamw"])
def test_optimizer_steps_match_optax(kind):
    lr = 1e-2
    jopt = getattr(optax, kind)(lr)
    topt = getattr(optim, kind)(lr)
    params = _opt_tree(9)
    jparams, tparams = jax.tree_util.tree_map(jnp.asarray, params), \
        _to_torch(params)
    jstate, tstate = jopt.init(jparams), topt.init(tparams)
    for i in range(3):
        grads = _opt_tree(10 + i)
        jup, jstate = jopt.update(jax.tree_util.tree_map(jnp.asarray, grads),
                                  jstate, jparams)
        tup, tstate = topt.update(_to_torch(grads), tstate, tparams)
        for path, a, b in _pairs(jup, tup):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                       atol=1e-9, err_msg=f"{i} {path}")
        jparams = optax.apply_updates(jparams, jup)
        tparams = optim.apply_updates(tparams, tup)
    adam_state = jstate[0]
    assert int(tstate.count) == int(adam_state.count) == 3
    for mine, theirs in ((tstate.mu, adam_state.mu),
                         (tstate.nu, adam_state.nu)):
        for path, a, b in _pairs(theirs, mine):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                       err_msg=path)
    # weight decay: optax's default, not torch.optim.AdamW's 0.01
    if kind == "adamw":
        import inspect
        want = inspect.signature(optax.adamw).parameters["weight_decay"]
        got = inspect.signature(optim.adamw).parameters["weight_decay"]
        assert got.default == want.default == 1e-4


def test_optimizer_state_keeps_the_params_dtype_and_global_norm():
    params = optim.tree_map(lambda x: x.to(torch.bfloat16),
                            _to_torch(_opt_tree(11)))
    state = optim.adamw(1e-3).init(params)
    assert all(x.dtype == torch.bfloat16 for x in
               optim.tree_leaves(state.mu) + optim.tree_leaves(state.nu))
    assert state.count.dtype == torch.int32
    grads = _opt_tree(12)
    want = optax.global_norm(jax.tree_util.tree_map(jnp.asarray, grads))
    np.testing.assert_allclose(float(optim.global_norm(_to_torch(grads))),
                               float(want), rtol=1e-6)


# -- the steps against the reference's ------------------------------------------------------

STEP_ATOL = 2e-4        # see the module docstring: Adam near zero gradients


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no-remat"])
@pytest.mark.parametrize("name", list(MODELS))
def test_lora_steps_match_the_reference(name, remat):
    jcfg, tcfg, jparams, tparams = _jax_model(name)
    jad = jlora.init_lora(jax.random.PRNGKey(1), jparams, rank=4)
    tad = params_from_jax(jax.device_get(jad), "cpu")
    tokens = _tokens(jcfg.vocab_size, (2, 128), 2)
    jopt, topt = optax.adam(1e-2), optim.adam(1e-2)
    jstate, tstate = jopt.init(jad), topt.init(tad)
    jstep = jax_build_lora_step(jcfg, jopt, scale=2.0, remat=remat)
    tstep = build_lora_train_step(tcfg, topt, scale=2.0, remat=remat,
                                  device="cpu")
    for i in range(3):
        jad, jstate, jm = jstep(jad, jstate, jparams, jnp.asarray(tokens))
        tad, tstate, tm = tstep(tad, tstate, tparams, tokens)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-6, err_msg=f"step {i}")
        for path, a, b in _pairs(jad, tad):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                       atol=STEP_ATOL,
                                       err_msg=f"step {i} {path}")
    # every b moved off zero; the base is untouched by the steps
    assert all(bool(layer[w]["b"].any()) for layer in tad["layers"]
               for w in layer)


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no-remat"])
def test_full_steps_match_the_reference(remat):
    jcfg, tcfg, jparams, tparams = _jax_model("llama-tiny")
    tokens = _tokens(jcfg.vocab_size, (2, 128), 3)
    jopt, topt = optax.adam(1e-3), optim.adam(1e-3)
    jstate = jax_init_train_state(jparams, jopt)
    tstate = init_train_state(tparams, topt)
    jstep = jax_build_train_step(jcfg, jopt, remat=remat)
    tstep = build_train_step(tcfg, topt, remat=remat, device="cpu")
    for i in range(2):
        jstate, jm = jstep(jstate, jnp.asarray(tokens))
        tstate, tm = tstep(tstate, torch.from_numpy(tokens))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-6, err_msg=f"step {i}")
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5,
                                   err_msg=f"step {i}")
        for path, a, b in _pairs(jstate.params, tstate.params):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                       atol=STEP_ATOL,
                                       err_msg=f"step {i} {path}")
    assert int(tstate.step) == int(jstate.step) == 2


def test_steps_leave_their_inputs_as_they_were():
    _, tcfg, _, tparams = _jax_model("llama-tiny", head_dim=32)
    before = optim.tree_map(torch.clone, tparams)
    tad = tlora.init_lora(torch.Generator().manual_seed(0), tparams, rank=2)
    opt = optim.adamw(1e-2)
    state = opt.init(tad)
    step = build_lora_train_step(tcfg, opt, device="cpu")
    tokens = _tokens(tcfg.vocab_size, (1, 16), 4)
    new_ad, new_state, _ = step(tad, state, tparams, tokens)
    assert int(state.count) == 0 and int(new_state.count) == 1
    assert not any(bool(layer[w]["b"].any()) for layer in tad["layers"]
                   for w in layer)
    assert all(bool(layer[w]["b"].any()) for layer in new_ad["layers"]
               for w in layer)
    for a, b in zip(optim.tree_leaves(before), optim.tree_leaves(tparams)):
        assert torch.equal(a, b) and not b.requires_grad


def test_steps_run_on_the_card_by_default_and_refuse_other_devices():
    _, tcfg, _, tparams = _jax_model("llama-tiny", head_dim=32)
    opt = optim.adam(1e-3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_train_step(tcfg, opt)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_lora_train_step(tcfg, opt)
    state = init_train_state(tparams, opt)
    step = build_train_step(tcfg, opt, device="meta")
    with pytest.raises(ValueError, match="state.params has a tensor on cpu"):
        step(state, np.zeros((1, 8), np.int32))


# -- mirrors of tests/test_parallel.py, one process, no mesh -------------------------------


def _losses_fall(losses):
    assert losses[-1] < losses[0], losses
    assert all(np.isfinite(losses)), losses


def test_full_train_step_loss_decreases():
    """``test_fsdp_train_step_loss_decreases`` on one device."""
    _, tcfg, _, tparams = _jax_model("llama-tiny", head_dim=32)
    opt = optim.adam(1e-3)
    state = init_train_state(tparams, opt)
    step = build_train_step(tcfg, opt, remat=True, device="cpu")
    tokens = _tokens(tcfg.vocab_size, (4, 32), 1)
    losses = []
    for _ in range(5):
        state, metrics = step(state, tokens)
        losses.append(float(metrics["loss"]))
    _losses_fall(losses)
    assert isinstance(state, TrainState) and int(state.step) == 5


def test_lora_train_step_loss_decreases():
    """``test_lora_fsdp_train_step`` on one device."""
    _, tcfg, _, tparams = _jax_model("llama-tiny", head_dim=32)
    tad = tlora.init_lora(torch.Generator().manual_seed(1), tparams, rank=4)
    opt = optim.adam(1e-2)
    state = opt.init(tad)
    step = build_lora_train_step(tcfg, opt, scale=2.0, remat=True,
                                 device="cpu")
    tokens = _tokens(tcfg.vocab_size, (2, 32), 2)
    losses = []
    for _ in range(5):
        tad, state, metrics = step(tad, state, tparams, tokens)
        losses.append(float(metrics["loss"]))
    _losses_fall(losses)


def _moe(seed: int, capacity_factor: float = 1.25, top_k: int = 2,
         n_experts: int = 4):
    jcfg = jmoe.MoeConfig(dim=32, hidden_dim=64, n_experts=n_experts,
                          top_k=top_k, capacity_factor=capacity_factor,
                          dtype=jnp.float32)
    tcfg = tmoe.MoeConfig(dim=32, hidden_dim=64, n_experts=n_experts,
                          top_k=top_k, capacity_factor=capacity_factor,
                          dtype=torch.float32)
    jparams = jmoe.init_moe_layer(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, jparams, params_from_jax(jax.device_get(jparams),
                                                "cpu")


def test_moe_train_step_loss_decreases():
    """``test_moe_train_step_loss_decreases`` on one device, its losses
    step for step against the reference's (no ``ep`` sharding): the
    routing follows the params, so the losses stay within ``rtol=1e-5``
    only while no near tie flips an expert; none does in these 8 steps."""
    jcfg, tcfg, jparams, tparams = _moe(0)
    x = np.random.default_rng(1).standard_normal((2, 64, 32), np.float32)
    target = np.roll(x, 1, axis=-1)
    jopt, topt = optax.adam(1e-2), optim.adam(1e-2)
    jstate, tstate = jopt.init(jparams), topt.init(tparams)

    @jax.jit
    def jstep(params, opt_state):
        def loss_fn(p):
            y, aux = jmoe.moe_ffn(p, x, jcfg, ep_sharded=False)
            return jnp.mean((y - target) ** 2) + 0.01 * aux["balance_loss"]
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = jopt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    tx, ttarget = torch.from_numpy(x), torch.from_numpy(target)
    losses = []
    for i in range(8):
        jparams, jstate, jl = jstep(jparams, jstate)
        live = optim.tree_map(lambda p: p.detach().requires_grad_(True),
                              tparams)
        y, aux = tmoe.moe_ffn(live, tx, tcfg)
        loss = torch.mean((y - ttarget) ** 2) + 0.01 * aux["balance_loss"]
        grads = dict(zip(live, torch.autograd.grad(loss, list(live.values()))))
        updates, tstate = topt.update(grads, tstate, tparams)
        tparams = optim.apply_updates(tparams, updates)
        losses.append(float(loss))
        np.testing.assert_allclose(losses[-1], float(jl), rtol=1e-5,
                                   err_msg=f"step {i}")
    _losses_fall(losses)


@pytest.mark.parametrize("case", [(1.25, 2), (0.25, 1)],
                         ids=["top2", "top1-drops"])
def test_moe_gradients_match_jax_grad(case):
    capacity_factor, top_k = case
    jcfg, tcfg, jparams, tparams = _moe(3, capacity_factor, top_k)
    x = np.random.default_rng(4).standard_normal((2, 48, 32), np.float32)

    def jloss(p, x):
        y, aux = jmoe.moe_ffn(p, x, jcfg, ep_sharded=False)
        return jnp.mean(jnp.tanh(y) * x) + 0.01 * aux["balance_loss"]

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jparams, x)
    live = {k: v.clone().requires_grad_(True) for k, v in tparams.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = tmoe.moe_ffn(live, tx, tcfg)
    (torch.mean(torch.tanh(y) * tx) + 0.01 * aux["balance_loss"]).backward()
    if capacity_factor < 1:
        assert float(aux["dropped_frac"]) > 0
    for name, got in list(live.items()) + [("x", tx)]:
        want = np.asarray(jgx if name == "x" else jg[name])
        assert np.abs(want).sum() > 0, name
        np.testing.assert_allclose(got.grad.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=name)


# -- adapters across the packages -------------------------------------------------------------


@pytest.fixture
def workdir(tmp_path, monkeypatch):
    monkeypatch.setenv("TPU9_WORKDIR", str(tmp_path))
    monkeypatch.delenv("TPU9_CKPT_QUANT", raising=False)
    return tmp_path


def _trained_adapters():
    """A JAX adapter tree with non-zero ``b``, as after training."""
    _, _, jparams, _ = _jax_model("gemma-tiny", head_dim=32)
    rng = np.random.default_rng(13)
    jad = jlora.init_lora(jax.random.PRNGKey(1), jparams, rank=4)
    return jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.standard_normal(x.shape, np.float32)), jad)


def _dir_bytes(path) -> dict:
    return {p.name: p.read_bytes() for p in sorted(path.iterdir())}


@pytest.mark.parametrize("first", ["jax", "torch"])
def test_adapters_saved_by_one_package_load_in_the_other(workdir, first):
    jad = _trained_adapters()
    tad = params_from_jax(jax.device_get(jad), "cpu")
    name = "lora_adapters"
    if first == "jax":
        path = jckpt.save_params(jad, name=name)
        back = tckpt.load_params(name, device="cpu")
        tw.save_params(tad, str(workdir / "other.tpu9w"))
    else:
        path = tckpt.save_params(tad, name=name)
        back = params_from_jax(jckpt.load_params(name), "cpu")
        jw.save_params(jad, str(workdir / "other.tpu9w"))
    assert path.endswith(name + tw.WEIGHTS_SUFFIX)
    assert _dir_bytes(Path(path)) == _dir_bytes(workdir / "other.tpu9w")
    for path_, a, b in _pairs(jad, back):
        assert b.dtype == torch.float32, path_
        np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                      err_msg=path_)
    # a loaded tree trains on: merge takes it as the live one
    _, _, _, tparams = _jax_model("gemma-tiny", head_dim=32)
    for a, b in zip(optim.tree_leaves(tlora.merge(tparams, back)),
                    optim.tree_leaves(tlora.merge(tparams, tad))):
        assert torch.equal(a, b)


def test_lora_gradients_reach_only_the_adapters():
    _, tcfg, _, tparams = _jax_model("gemma-tiny")
    tad = tlora.init_lora(torch.Generator().manual_seed(2), tparams, rank=4)
    tokens = torch.from_numpy(_tokens(tcfg.vocab_size, (1, 128), 5))
    loss, grads = lora_value_and_grad(tcfg, 2.0)(tad, tparams, tokens)
    assert not loss.requires_grad
    # b = 0 at init, so a's gradient is zero and b's is not
    for layer in grads["layers"]:
        for w, g in layer.items():
            assert not g["a"].any() and g["b"].any(), w
    assert all(leaf.grad is None and not leaf.requires_grad
               for leaf in optim.tree_leaves(tparams))
