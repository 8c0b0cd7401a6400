"""Gemma in the port (``tpu9_torch/models/gemma.py``) against the JAX
package, on the CPU.

- The presets field by field, ``resolve_preset`` for every gemma name and
  its int8 forms, and the mixtral presets field by field, plain and int8.
- The tied trees (no ``lm_head``), bf16 and int8, against the JAX trees,
  and the bridge carrying them bit for bit.
- The head_dim-256 twins of the four kernels against the JAX Pallas
  kernels in interpret mode, at GQA groups 1 and 8: the flash twin
  (``xla_attention``) at T = S = 256; the decode twins at lengths 1, a
  block edge, one past it and a full table, and the split-KV plan's
  partials merged by ``merge_partials`` (the combine kernel's twin) at
  those and length 0. f32 throughout, ``atol=2e-5`` as the JAX suite's
  kernel tests (every side sums in f32, in different orders); the bf16
  pool holds bf16 values stored in f32, the int8 pool is quantized by the
  JAX ``quantize_kv``, as in ``tests/test_torch_split_decode.py``.
- The decoder's branches (no-cache, dense prefill, chunked prefill, dense
  decode, paged decode over a bf16 and an int8 pool) on a head_dim-256
  test config, which reaches the flash, ragged and paged routes, and on
  gemma-tiny (head_dim 32, the plain paths), against the JAX
  ``decoder_forward`` at f32: logits within ``atol=1e-4`` (the llama
  tests' tolerance: two layers of f32 matmuls summed in other orders),
  greedy tokens identical.
- The embedding scale bit for bit at bf16, and a decode step that makes no
  host-to-device copy (a CUDA-graph capture of the window refuses one).
- The paged bf16, paged int8 and dense engines' greedy streams against the
  JAX engine's, and the stats key set against the JAX gemma engine's.

The test config is a test config, not a preset: ``gemma_config`` of each
package with vocab 512, dim 256, 2 layers, 2 q heads over 1 kv head,
head_dim 256, hidden 512 and a 2048-position rope table.
"""

import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu9.models.transformer as jtransformer
from tpu9.models import decoder_forward as jax_forward
from tpu9.models import init_decoder as jax_init_decoder
from tpu9.models.gemma import GEMMA_PRESETS as JAX_PRESETS
from tpu9.models.gemma import gemma_config as jax_gemma_config
from tpu9.models.mixtral import MIXTRAL_PRESETS as JAX_MIXTRAL
from tpu9.models.transformer import init_kv_cache as jax_init_kv_cache
from tpu9.ops import attention as jattn
from tpu9.ops import paged_attention as jpaged
from tpu9.ops import quant as jquant
from tpu9.serving.engine import EngineConfig as JaxEngineConfig
from tpu9.serving.engine import InferenceEngine as JaxEngine
from tpu9.serving.presets import resolve_preset as jax_resolve_preset
from tpu9_torch.bridge import params_from_jax
from tpu9_torch.models import transformer as ttransformer
from tpu9_torch.models.gemma import GEMMA_PRESETS, gemma_config
from tpu9_torch.models.transformer import (decoder_forward, embed_scale,
                                           init_decoder, init_kv_cache)
from tpu9_torch.ops import attention as tattn
from tpu9_torch.ops import paged_attention as tpaged
from tpu9_torch.ops import quant as tquant
from tpu9_torch.ops.rotary import rope_table
from tpu9_torch.serving import presets as tpresets
from tpu9_torch.serving.engine import EngineConfig, InferenceEngine

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


ATOL = 2e-5          # kernels' twins, f32
LOGIT_ATOL = 1e-4    # decoder logits, f32
TEST = dict(vocab_size=512, dim=256, n_layers=2, n_heads=2, n_kv_heads=1,
            head_dim=256, hidden_dim=512, max_seq_len=2048)


@pytest.fixture(scope="module", autouse=True)
def _pinned_numerics():
    """f32 matmuls at full precision on both sides, as
    ``tests/test_torch_dense.py`` pins them, restored after."""
    precision = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    with jax.default_matmul_precision("highest"):
        yield
    torch.set_float32_matmul_precision(precision)


def _close(got: torch.Tensor, want, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                               rtol=0)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/{i}"))
        return out
    return {prefix: tree}


def _dtype_name(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).removeprefix("torch.")
    return np.dtype(x.dtype).name


def _pair(name: str, quantize=False, bf16=False):
    """The JAX config and params of ``name`` ("test" or a preset) at f32
    (or bf16), optionally int8 weights, and the port's config and params
    carried over by the bridge."""
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if bf16
                else (jnp.float32, torch.float32))
    if name == "test":
        jcfg = jax_gemma_config(**TEST, dtype=jdt)
        tcfg = gemma_config(**TEST, dtype=tdt)
    else:
        jcfg = dataclasses.replace(JAX_PRESETS[name], dtype=jdt)
        tcfg = dataclasses.replace(GEMMA_PRESETS[name], dtype=tdt)
    jparams = jax_init_decoder(jax.random.PRNGKey(0), jcfg)
    if quantize:
        jparams = jquant.quantize_decoder(jparams)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              "cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module")
def test256():
    return _pair("test")


# -- presets -------------------------------------------------------------------

def test_presets_match_reference_field_by_field():
    assert set(GEMMA_PRESETS) == set(JAX_PRESETS)
    for name, cfg in GEMMA_PRESETS.items():
        ref = JAX_PRESETS[name]
        for f in dataclasses.fields(cfg):
            if f.name != "dtype":
                assert getattr(cfg, f.name) == getattr(ref, f.name), \
                    (name, f.name)
        assert cfg.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    a, b = gemma_config(**TEST), jax_gemma_config(**TEST)
    assert all(getattr(a, f.name) == getattr(b, f.name)
               for f in dataclasses.fields(a) if f.name != "dtype")


@pytest.mark.parametrize("name,quantize", [
    (n + s, q) for n in sorted(JAX_PRESETS) for s, q in
    (("", None), ("-int8", None), ("", "int8"))])
def test_resolve_preset_matches_jax(name, quantize):
    cfg, quantized = tpresets.resolve_preset(name, quantize)
    want, want_q = jax_resolve_preset(name, quantize)
    assert quantized == want_q
    assert all(getattr(cfg, f.name) == getattr(want, f.name)
               for f in dataclasses.fields(cfg) if f.name != "dtype")


def test_mixtral_presets_resolve_as_the_references():
    """The port resolves the reference's mixtral names, plain and int8,
    field for field as the reference does, and still answers a truly
    unknown name with ``KeyError``."""
    assert set(JAX_MIXTRAL) <= set(tpresets.PRESETS)
    for name in JAX_MIXTRAL:
        for form, quantize in ((name, None), (name + "-int8", None),
                               (name, "int8")):
            cfg, quantized = tpresets.resolve_preset(form, quantize)
            want, want_q = jax_resolve_preset(form, quantize)
            assert quantized == want_q == (form != name or quantize == "int8")
            assert cfg.n_experts == want.n_experts > 0
            assert all(getattr(cfg, f.name) == getattr(want, f.name)
                       for f in dataclasses.fields(cfg) if f.name != "dtype")
            assert cfg.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    for unknown in ("gemma-99b", "mixtral", "gemma-7b-fp8"):
        with pytest.raises(KeyError, match="unknown model preset"):
            tpresets.resolve_preset(unknown)


# -- tied trees and the bridge ---------------------------------------------------

@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_tied_trees_match_jax_and_cross_the_bridge(int8):
    """Both inits leave out ``lm_head`` for a tied config, with the JAX
    tree's paths, shapes and dtypes; a JAX tree crosses the bridge bit for
    bit."""
    jcfg, tcfg = JAX_PRESETS["gemma-tiny"], GEMMA_PRESETS["gemma-tiny"]
    jinit = jquant.init_quantized_decoder if int8 else jax_init_decoder
    tinit = tquant.init_quantized_decoder if int8 else init_decoder
    want = _flat(jax.eval_shape(lambda r: jinit(r, jcfg),
                                jax.random.PRNGKey(0)))
    got = _flat(tinit(tcfg, torch.Generator().manual_seed(0), "cpu"))
    assert set(got) == set(want)
    assert "/lm_head" not in got and not any(
        p.startswith("/lm_head") for p in got)
    for path, leaf in got.items():
        assert tuple(leaf.shape) == tuple(want[path].shape), path
        assert _dtype_name(leaf) == _dtype_name(want[path]), path
    jtree = jinit(jax.random.PRNGKey(5), jcfg)
    ttree = _flat(params_from_jax(jax.tree_util.tree_map(np.asarray, jtree),
                                  "cpu"))
    jflat = _flat(jtree)
    assert set(ttree) == set(jflat)
    for path, leaf in ttree.items():
        w = np.asarray(jflat[path])
        if w.dtype.name == "bfloat16":
            np.testing.assert_array_equal(leaf.view(torch.uint16).numpy(),
                                          w.view(np.uint16))
        else:
            np.testing.assert_array_equal(leaf.numpy(), w)


# -- the kernels' twins at head_dim 256 -------------------------------------------

D = 256
GROUPS = {"G1": (2, 2), "G8": (8, 1)}          # (q heads, kv heads)


@pytest.mark.parametrize("heads", [(2, 1), (2, 2)], ids=["QH2KH1", "QH2KH2"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_twin_d256_matches_jax_flash_interpret(causal, heads):
    rng = np.random.default_rng(70 + int(causal) + heads[1])
    q = rng.standard_normal((1, 256, heads[0], D)).astype(np.float32)
    k = rng.standard_normal((1, 256, heads[1], D)).astype(np.float32)
    v = rng.standard_normal((1, 256, heads[1], D)).astype(np.float32)
    want = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=causal,
                                 interpret=True)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    assert tattn.uses_flash(256, 256, D, 0)
    assert tattn.flash_kernel_supports(tq.bfloat16(), tk.bfloat16()) == ""
    before = tattn.flash_attention.launches
    _close(tattn.flash_attention(tq, tk, tv, causal=causal), want)
    _close(tattn.attention(tq, tk, tv, causal=causal), want)
    assert tattn.flash_attention.launches == before


BS, MB = 16, 8
LENS = [0, 1, BS, BS + 1, MB * BS]      # 0, 1, a block edge, past it, full


def _decode_case(kind: str, heads):
    """Decode operands at head_dim 256: a pool whose table entries past
    each prefix name blocks of large finite garbage (``kind`` "bf16" or
    "int8"), or a contiguous cache [B, MB*BS] whose positions past each
    length hold garbage ("ragged")."""
    q_heads, kv_heads = heads
    rng = np.random.default_rng(80 + len(kind) + q_heads)
    q = rng.standard_normal((len(LENS), 1, q_heads, D)).astype(np.float32)
    lens = np.array(LENS, np.int32)
    if kind == "ragged":
        shape = (len(LENS), MB * BS, kv_heads, D)
        k, v = (np.array(jnp.asarray(rng.standard_normal(shape), jnp.bfloat16
                                     ).astype(jnp.float32)) for _ in range(2))
        for b, n in enumerate(LENS):
            k[b, n:], v[b, n:] = 1e3, -1e3
        return dict(q=q, k=k, v=v, lens=lens)
    need = [-(-n // BS) for n in LENS]
    n_real, n_garbage = sum(need), 2
    table = np.empty((len(LENS), MB), np.int32)
    perm, used = rng.permutation(n_real), 0
    for i, nb in enumerate(need):
        table[i, :nb] = perm[used:used + nb]
        table[i, nb:] = rng.integers(n_real, n_real + n_garbage, MB - nb)
        used += nb
    shape = (n_real + n_garbage, BS, kv_heads, D)
    k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    if kind == "bf16":
        k, v = (np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
                for a in (k, v))
        k[n_real:], v[n_real:] = 1e3, -1e3
        return dict(q=q, k=k, v=v, table=table, lens=lens)
    (kq, ks), (vq, vs) = ((np.array(x) for x in jquant.quantize_kv(
        jnp.asarray(a))) for a in (k, v))
    kq[n_real:], vq[n_real:] = 127, 127
    ks[n_real:], vs[n_real:] = 1e3, 1e3
    return dict(q=q, k=kq, v=vq, ks=ks, vs=vs, table=table, lens=lens)


def _jax_kernel(kind: str, c: dict) -> np.ndarray:
    j = {n: jnp.asarray(a) for n, a in c.items()}
    if kind == "ragged":
        out = jpaged.ragged_decode_attention(j["q"], j["k"], j["v"], j["lens"],
                                             block_s=BS, interpret=True)
    elif kind == "int8":
        out = jpaged.paged_decode_attention_quant(
            j["q"], j["k"], j["v"], j["ks"], j["vs"], j["table"], j["lens"],
            interpret=True)
    else:
        out = jpaged.paged_decode_attention(j["q"], j["k"], j["v"],
                                            j["table"], j["lens"],
                                            interpret=True)
    return np.asarray(out)


def _merged_splits(c: dict, heads, tokens: int) -> torch.Tensor:
    """Each split's running max, sum and unnormalised output in f32 from
    the densified (dequantized) cache, cut at the plan's boundaries of
    ``tokens`` positions, merged by ``merge_partials``."""
    t = {n: torch.from_numpy(a) for n, a in c.items()}
    if "table" in t:
        k = tpaged.gather_paged(t["k"], t["table"], t.get("ks"), torch.float32)
        v = tpaged.gather_paged(t["v"], t["table"], t.get("vs"), torch.float32)
    else:
        k, v = t["k"], t["v"]
    group = heads[0] // heads[1]
    k, v = (x.repeat_interleave(group, dim=2) for x in (k, v))
    q = t["q"][:, 0] * D ** -0.5
    n_splits = -(-MB * BS // tokens)
    m = torch.full((len(LENS), heads[0], n_splits), float("nan"))
    l = torch.full_like(m, float("nan"))
    acc = torch.full((len(LENS), heads[0], n_splits, D), float("nan"))
    span = tokens
    for i, n in enumerate(LENS):
        for s in range(n_splits):
            lo, hi = s * span, min((s + 1) * span, n)
            if lo >= hi:
                continue
            logits = torch.einsum("hd,thd->ht", q[i], k[i, lo:hi])
            m[i, :, s] = logits.amax(-1)
            p = torch.exp(logits - m[i, :, s, None])
            l[i, :, s] = p.sum(-1)
            acc[i, :, s] = torch.einsum("ht,thd->hd", p, v[i, lo:hi])
    return tpaged.merge_partials(m, l, acc, t["lens"], tokens)


@pytest.mark.parametrize("group", list(GROUPS))
@pytest.mark.parametrize("kind", ["bf16", "int8", "ragged"])
def test_decode_twins_d256_match_jax_kernels_interpret(kind, group):
    """The twin against the JAX kernel at every length but 0 (where the
    contiguous twin's softmax over masked logits gives the mean of v and
    the kernels give zeros), and the split plan's partials merged at every
    length, 0 included."""
    heads = GROUPS[group]
    c = _decode_case(kind, heads)
    want = _jax_kernel(kind, c)
    t = {n: torch.from_numpy(a) for n, a in c.items()}
    live = np.array(LENS) > 0
    if kind == "ragged":
        assert tpaged.ragged_kernel_supports(
            t["q"].bfloat16(), t["k"].bfloat16(), BS) == ""
        twin = tpaged.ragged_decode_attention(t["q"], t["k"], t["v"],
                                              t["lens"], block_s=BS)
    else:
        scales = (t["ks"], t["vs"]) if kind == "int8" else ()
        assert tpaged.kernel_supports(
            t["q"].bfloat16(), t["k"] if scales else t["k"].bfloat16(),
            *scales[:1]) == ""
        twin = tattn.paged_attention_dispatch(t["q"], t["k"], t["v"],
                                              t["table"], t["lens"], *scales)
    _close(twin[live], want[live])
    # 64-position splits, four blocks each: the least a split takes
    n_splits, tokens = tpaged.split_plan(len(LENS), heads[1], MB, BS)
    assert (n_splits, tokens) == (2, 64)
    merged = _merged_splits(c, heads, tokens)
    _close(merged, want)
    assert torch.equal(merged[0], torch.zeros_like(merged[0]))


def test_partials_buffer_holds_the_d256_plan():
    """The launchers size the partials from D: [B, QH, NS, 256] then the
    (max, sum) pairs."""
    q = torch.zeros((8, 1, 16, D), dtype=torch.bfloat16)
    n_splits, tokens, scratch, (acc, ml) = tpaged._plan_and_scratch(
        q, 16, 17, 128)
    rows = 8 * 16 * n_splits
    assert scratch.shape == (rows * (D + 2),)
    assert ml - acc == 4 * rows * D


# -- the decoder -----------------------------------------------------------------

@pytest.fixture
def routes(monkeypatch):
    """Counts the calls that reach each kernel wrapper (on the CPU they
    compute the twin and count no launch)."""
    seen = {}
    for mod, name in ((tattn, "flash_attention"),
                      (tpaged, "ragged_decode_attention"),
                      (tpaged, "paged_decode_attention"),
                      (tpaged, "paged_decode_attention_quant")):
        real = getattr(mod, name)
        seen[name] = 0

        def spy(*a, _real=real, _name=name, **k):
            seen[_name] += 1
            return _real(*a, **k)
        monkeypatch.setattr(mod, name, spy)
    return seen


@pytest.fixture(scope="module", params=["test", "gemma-tiny"])
def model(request):
    return request.param, _pair(request.param)


def test_no_cache_and_dense_branches_match(model, routes):
    """No-cache forward and dense prefill of 128 tokens (the flash route at
    head_dim 256), then 3 dense decode steps over a 512-position cache (the
    ragged route), at per-row lengths."""
    name, (jcfg, jparams, tcfg, tparams) = model
    kernels = jcfg.head_dim == 256
    rng = np.random.default_rng(90)
    t = 128
    toks = rng.integers(0, jcfg.vocab_size, (2, t)).astype(np.int32)
    _close(decoder_forward(tparams, torch.from_numpy(toks), tcfg),
           jax_forward(jparams, jnp.asarray(toks), jcfg), LOGIT_ATOL)
    jl, jcache = jax_forward(jparams, jnp.asarray(toks), jcfg,
                             kv_cache=jax_init_kv_cache(jcfg, 2, t))
    tl, tcache = decoder_forward(tparams, torch.from_numpy(toks), tcfg,
                                 kv_cache=init_kv_cache(tcfg, 2, t))
    _close(tl, jl, LOGIT_ATOL)
    _close(tcache["k"], jcache["k"], LOGIT_ATOL)
    assert routes["flash_attention"] == (4 if kernels else 0)

    s = 512
    big = {n: np.zeros((jcfg.n_layers, 2, s, jcfg.n_kv_heads, jcfg.head_dim),
                       np.float32) for n in ("k", "v")}
    for n in ("k", "v"):
        big[n][:, :, :t] = np.asarray(jcache[n])
    jbig = {n: jnp.asarray(a) for n, a in big.items()}
    tbig = {n: torch.from_numpy(a.copy()) for n, a in big.items()}
    clen = np.array([t - 7, t], np.int32)
    tok = np.asarray(jl)[np.arange(2), clen - 1].argmax(-1).astype(np.int32)
    for _ in range(3):
        jl, jbig = jax_forward(
            jparams, jnp.asarray(tok[:, None]), jcfg,
            positions=jnp.asarray(clen[:, None]), kv_cache=jbig,
            cache_len=jnp.asarray(clen + 1), decode=True)
        tl, tbig = decoder_forward(
            tparams, torch.from_numpy(tok[:, None]), tcfg,
            positions=torch.from_numpy(clen[:, None]), kv_cache=tbig,
            cache_len=torch.from_numpy(clen + 1), decode=True)
        _close(tl, jl, LOGIT_ATOL)
        want = np.asarray(jl)[:, -1].argmax(-1)
        np.testing.assert_array_equal(tl[:, -1].argmax(-1).numpy(), want)
        tok, clen = want.astype(np.int32), clen + 1
    _close(tbig["k"], jbig["k"], LOGIT_ATOL)
    assert routes["ragged_decode_attention"] == (
        3 * jcfg.n_layers if kernels else 0)


S, C, PBS = 64, 16, 8         # scratch length, prefill chunk, pool block


@pytest.mark.parametrize("pool", ["bf16", "int8"])
def test_chunked_prefill_and_paged_decode_match(model, routes, pool):
    """Chunked prefill of two prompts into batch-1 scratches, the blocks
    moved by hand into a shared pool (quantized by the JAX ``quantize_kv``
    for the int8 pool, the same values on both sides) and 3 paged decode
    steps through the pool's route."""
    name, (jcfg, jparams, tcfg, tparams) = model
    rng = np.random.default_rng(91)
    prompts = [rng.integers(0, jcfg.vocab_size, n).tolist() for n in (37, 16)]
    mb, n_blocks = S // PBS + 1, 2 * (S // PBS) + 1
    shape = (jcfg.n_layers, n_blocks, PBS, jcfg.n_kv_heads, jcfg.head_dim)
    pools = {n: np.zeros(shape, np.float32) for n in ("k", "v")}
    perm = rng.permutation(np.arange(1, n_blocks))
    table = np.zeros((2, mb), np.int32)
    table[0, :S // PBS], table[1, :S // PBS] = perm[:S // PBS], perm[S // PBS:]
    last = []
    for b, prompt in enumerate(prompts):
        jscr, tscr = jax_init_kv_cache(jcfg, 1, S), init_kv_cache(tcfg, 1, S)
        for off in range(0, len(prompt), C):
            valid = min(C, len(prompt) - off)
            row = np.zeros((1, C), np.int32)
            row[0, :valid] = prompt[off:off + valid]
            pos = (off + np.arange(C, dtype=np.int32))[None, :]
            jl, jscr = jax_forward(jparams, jnp.asarray(row), jcfg,
                                   positions=jnp.asarray(pos),
                                   kv_cache=jscr, cache_len=off + C)
            tl, tscr = decoder_forward(tparams, torch.from_numpy(row), tcfg,
                                       positions=torch.from_numpy(pos),
                                       kv_cache=tscr, cache_len=off + C)
            _close(tl[0, :valid], np.asarray(jl)[0, :valid], LOGIT_ATOL)
        n = len(prompt)
        _close(tscr["k"][:, :, :n], np.asarray(jscr["k"])[:, :, :n],
               LOGIT_ATOL)
        assert int(tl[0, valid - 1].argmax()) == int(
            np.asarray(jl)[0, valid - 1].argmax())
        last.append(int(np.asarray(jl)[0, valid - 1].argmax()))
        for j, blk in enumerate(table[b, :-(-n // PBS)]):
            for nm in ("k", "v"):
                pools[nm][:, blk] = np.asarray(jscr[nm])[
                    :, 0, j * PBS:(j + 1) * PBS]
    jcache = {"table": jnp.asarray(table)}
    tcache = {"table": torch.from_numpy(table)}
    if pool == "int8":
        for nm in ("k", "v"):
            qv, sc = (np.array(x) for x in jquant.quantize_kv(
                jnp.asarray(pools[nm])))
            jcache[nm], jcache[f"{nm}_scale"] = jnp.asarray(qv), jnp.asarray(sc)
            tcache[nm] = torch.from_numpy(qv.copy())
            tcache[f"{nm}_scale"] = torch.from_numpy(sc.copy())
    else:
        for nm in ("k", "v"):
            jcache[nm] = jnp.asarray(pools[nm])
            tcache[nm] = torch.from_numpy(pools[nm].copy())
    clen = np.array([len(p) for p in prompts], np.int32)
    tok = np.array(last, np.int32)[:, None]
    for _ in range(3):
        jl, jcache = jax_forward(
            jparams, jnp.asarray(tok), jcfg,
            positions=jnp.asarray(clen[:, None]), kv_cache=jcache,
            cache_len=jnp.asarray(clen + 1), decode=True)
        tl, tcache = decoder_forward(
            tparams, torch.from_numpy(tok), tcfg,
            positions=torch.from_numpy(clen[:, None]), kv_cache=tcache,
            cache_len=torch.from_numpy(clen + 1), decode=True)
        _close(tl, jl, LOGIT_ATOL)
        want = np.asarray(jl)[:, -1].argmax(-1)
        np.testing.assert_array_equal(tl[:, -1].argmax(-1).numpy(), want)
        tok, clen = want.astype(np.int32)[:, None], clen + 1
    if pool == "int8":
        np.testing.assert_array_equal(tcache["k"].numpy(),
                                      np.asarray(jcache["k"]))
        _close(tcache["k_scale"], jcache["k_scale"])
    else:
        _close(tcache["k"], jcache["k"], LOGIT_ATOL)
    route = ("paged_decode_attention_quant" if pool == "int8"
             else "paged_decode_attention")
    assert routes[route] == 3 * jcfg.n_layers


# -- the embedding scale -----------------------------------------------------------

@pytest.mark.parametrize("dim", [2048, 3072, 256, 130])
def test_embed_scale_is_bit_exact_at_bf16(dim):
    """x * sqrt(dim): the port's Python scalar (sqrt(dim) rounded to bf16)
    against JAX's bf16 array, bit for bit, on every bf16 magnitude class
    of a random draw."""
    rng = np.random.default_rng(dim)
    x = np.asarray(jnp.asarray(rng.standard_normal(4096) * np.exp2(
        rng.integers(-20, 20, 4096)), jnp.bfloat16))
    want = np.asarray(jnp.asarray(x) * jnp.asarray(dim ** 0.5,
                                                   dtype=jnp.bfloat16))
    tx = torch.from_numpy(x.view(np.uint16).copy()).view(torch.bfloat16)
    got = tx * embed_scale(dim, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.uint16).numpy(),
                                  want.view(np.uint16))
    assert embed_scale(dim, torch.float32) == float(np.float32(dim ** 0.5))


def test_forward_embedding_is_bit_exact_at_bf16(monkeypatch):
    """The scaled embedding both decoders hand to their first norm, on
    gemma-tiny in bf16 (sqrt(128) is not a bf16 value), bit for bit."""
    jcfg, jparams, tcfg, tparams = _pair("gemma-tiny", bf16=True)
    seen = {}

    def recorder(key, real):
        def norm(x, *a, **k):
            seen.setdefault(key, x)
            return real(x, *a, **k)
        return norm
    monkeypatch.setattr(jtransformer, "rms_norm",
                        recorder("jax", jtransformer.rms_norm))
    monkeypatch.setattr(ttransformer, "rms_norm",
                        recorder("torch", ttransformer.rms_norm))
    toks = np.random.default_rng(92).integers(0, 512, (2, 9)).astype(np.int32)
    jax_forward(jparams, jnp.asarray(toks), jcfg)
    decoder_forward(tparams, torch.from_numpy(toks), tcfg)
    want = np.asarray(seen["jax"])
    assert want.dtype.name == "bfloat16"
    np.testing.assert_array_equal(seen["torch"].view(torch.uint16).numpy(),
                                  want.view(np.uint16))


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_decode_step_makes_no_host_to_device_copy(test256, monkeypatch,
                                                  paged):
    """A captured decode window runs ``decoder_forward(decode=True)``; a
    tensor built from host values inside it (``torch.tensor(...,
    device=)``) is a host-to-device copy, which a CUDA-graph capture
    refuses. On the CPU the same code runs, so building one fails here."""
    _, _, tcfg, tparams = test256
    rope = rope_table(tcfg.max_seq_len, tcfg.head_dim, tcfg.rope_theta)
    shape = (tcfg.n_layers, 4 if paged else 2, 512 if not paged else PBS,
             tcfg.n_kv_heads, tcfg.head_dim)
    cache = {"k": torch.zeros(shape), "v": torch.zeros(shape)}
    if paged:
        cache["table"] = torch.tensor([[1, 2], [3, 0]], dtype=torch.int32)
    toks = torch.tensor([[5], [7]])
    pos = torch.tensor([[3], [0]])
    clen = torch.tensor([4, 1], dtype=torch.int32)

    def refuse(*a, **k):
        raise AssertionError("a tensor built from host values in the window")
    monkeypatch.setattr(torch, "tensor", refuse)
    monkeypatch.setattr(torch, "as_tensor", refuse)
    logits, _ = decoder_forward(tparams, toks, tcfg, positions=pos,
                                kv_cache=cache, cache_len=clen, decode=True,
                                rope=rope)
    assert logits.shape == (2, 1, tcfg.vocab_size)
    assert bool(torch.isfinite(logits).all())


# -- engines -----------------------------------------------------------------------

PAGED = dict(max_batch=4, max_seq_len=128, prefill_buckets=(16, 64),
             decode_steps=(1, 4), kv_block_size=16, prefill_chunk=16,
             prefix_cache_blocks=16, admit_group_chunks=2)
# buckets of 128 reach the flash route, a 512-position cache the ragged one
DENSE = dict(max_batch=2, max_seq_len=512, prefill_buckets=(128, 256),
             decode_steps=(1, 4))


def _prompts():
    rng = np.random.default_rng(93)
    shared = rng.integers(1, 500, 40).tolist()
    return [shared + rng.integers(1, 500, 5).tolist(),
            shared + rng.integers(1, 500, 22).tolist(),
            rng.integers(1, 500, 23).tolist(),
            rng.integers(1, 500, 70).tolist()]


async def _serve(engine, prompts, max_new):
    await engine.start()
    try:
        outs = await asyncio.gather(*[
            engine.generate(p, max_new_tokens=max_new, request_id=f"r{i}")
            for i, p in enumerate(prompts)])
        again = await engine.generate(prompts[0], max_new_tokens=max_new)
    finally:
        await engine.stop()
    return list(outs), again


@pytest.mark.usefixtures("jax_table_copies")
@pytest.mark.parametrize("mode", ["paged-bf16", "paged-int8", "dense"])
def test_greedy_streams_identical_to_jax_engine(mode, routes):
    """The paged engine over a bf16 pool, the paged engine with int8
    weights (a JAX int8 tree) and an int8 pool, and the dense engine, each
    against the JAX engine of its configuration on the same weights, at
    f32: the same greedy tokens, token for token."""
    int8 = mode == "paged-int8"
    jcfg, jparams, tcfg, tparams = _pair("test", quantize=int8)
    kw = dict(DENSE if mode == "dense" else PAGED)
    if int8:
        kw["kv_quant"] = "int8"
    jeng = JaxEngine(jparams, jcfg, JaxEngineConfig(**kw))
    teng = InferenceEngine(tparams, tcfg, EngineConfig(**kw), device="cpu")
    assert teng.paged == jeng.paged == (mode != "dense")
    prompts = _prompts()
    want = asyncio.run(_serve(jeng, prompts, 8))
    got = asyncio.run(_serve(teng, prompts, 8))
    assert got == want
    assert all(len(o) == 8 for o in got[0])
    steps = teng.stats()["decode_steps"]
    if mode == "dense":
        assert routes["flash_attention"] == jcfg.n_layers * (len(prompts) + 1)
        assert routes["ragged_decode_attention"] == jcfg.n_layers * steps > 0
    else:
        route = ("paged_decode_attention_quant" if int8
                 else "paged_decode_attention")
        assert routes[route] >= jcfg.n_layers * steps > 0
        stats = teng.stats()
        assert stats["prefix_cache"]["hits"] == \
            jeng.stats()["prefix_cache"]["hits"] >= 2
        assert stats["kv_quant"] == ("int8" if int8 else "")
        # the int8 pool is sized to the bf16 pool's bytes, with one kv head
        assert teng.allocator.n_blocks == jeng.allocator.n_blocks


@pytest.mark.usefixtures("jax_table_copies")
@pytest.mark.parametrize("mode", ["paged", "dense"])
def test_stats_keys_equal_the_jax_gemma_engine(test256, mode):
    """The stats surface of a gemma engine: exactly the JAX engine's key
    set, the ``kvwire_`` family included, and the same predicted memory
    for the tied tree (the embedding counted once, no output head)."""
    jcfg, jparams, tcfg, tparams = test256
    kw = PAGED if mode == "paged" else DENSE
    jeng = JaxEngine(jparams, jcfg, JaxEngineConfig(**kw))
    teng = InferenceEngine(tparams, tcfg, EngineConfig(**kw), device="cpu")
    out = [asyncio.run(_serve(e, _prompts()[:2], 4)) for e in (jeng, teng)]
    assert out[0] == out[1]
    js, ts = jeng.stats(), teng.stats()
    assert set(ts) == set(js)
    for key in ("hbm_predicted_gb_per_chip", "decode_bytes_per_token_per_chip",
                "decode_flops_per_token_per_chip", "tokens_generated"):
        assert ts[key] == js[key], key
