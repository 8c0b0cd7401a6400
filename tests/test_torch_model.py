"""The port's decoder (``tpu9_torch.models.transformer``) against the JAX
``decoder_forward`` on llama-tiny at f32, with the JAX params converted by
``tpu9_torch.bridge.params_from_jax``: the no-cache forward, chunked
prefill into a dense scratch, the splice into a paged pool and paged decode
steps. Tolerance: f32 logits within ``atol=1e-4`` (two layers of f32
matmuls summed in different orders), greedy tokens identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu9.models import init_decoder as jax_init_decoder
from tpu9.models.llama import LLAMA_PRESETS as JAX_PRESETS
from tpu9.models.transformer import decoder_forward as jax_forward
from tpu9.models.transformer import init_kv_cache as jax_init_kv_cache
from tpu9_torch.bridge import params_from_jax
from tpu9_torch.models.llama import LLAMA_PRESETS
from tpu9_torch.models.transformer import decoder_forward, init_kv_cache
from tpu9_torch.serving.engine import EngineConfig
from tpu9_torch.serving.graphs import GraphFactory

torch.set_num_threads(2)

ATOL = 1e-4
S, C, BS = 64, 16, 8          # scratch length, prefill chunk, pool block


@pytest.fixture(scope="module")
def tiny():
    jcfg = dataclasses.replace(JAX_PRESETS["llama-tiny"], dtype=jnp.float32)
    tcfg = dataclasses.replace(LLAMA_PRESETS["llama-tiny"],
                               dtype=torch.float32)
    jparams = jax_init_decoder(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              "cpu")
    return jcfg, jparams, tcfg, tparams


def _close(got: torch.Tensor, want, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                               rtol=0)


def test_presets_match_reference_field_by_field():
    for name, cfg in LLAMA_PRESETS.items():
        ref = JAX_PRESETS[name]
        for f in dataclasses.fields(cfg):
            if f.name != "dtype":
                assert getattr(cfg, f.name) == getattr(ref, f.name), \
                    (name, f.name)
        assert cfg.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16


def test_bridge_moves_bf16_bit_exact():
    jcfg = JAX_PRESETS["llama-tiny"]                     # bf16 weights
    jparams = jax_init_decoder(jax.random.PRNGKey(1), jcfg)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              "cpu")
    want = np.asarray(jparams["layers"][1]["wq"])
    got = tparams["layers"][1]["wq"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.uint16).numpy(),
                                  want.view(np.uint16))
    assert tparams["final_norm"].dtype == torch.float32


def test_no_cache_logits_match(tiny):
    jcfg, jparams, tcfg, tparams = tiny
    toks = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 13))
    want = jax_forward(jparams, jnp.asarray(toks, jnp.int32), jcfg)
    got = decoder_forward(tparams, torch.from_numpy(toks), tcfg)
    _close(got, want)
    np.testing.assert_array_equal(got.argmax(-1).numpy(),
                                  np.asarray(want).argmax(-1))


def _chunked_prefill(tiny, prompt):
    """Both decoders prefill ``prompt`` chunk by chunk into a batch-1
    scratch; the last-token logits of every chunk must agree."""
    jcfg, jparams, tcfg, tparams = tiny
    jscratch = jax_init_kv_cache(jcfg, 1, S)
    tscratch = init_kv_cache(tcfg, 1, S)
    for off in range(0, len(prompt), C):
        valid = min(C, len(prompt) - off)
        row = np.zeros((1, C), np.int32)
        row[0, :valid] = prompt[off:off + valid]
        pos = (off + np.arange(C, dtype=np.int32))[None, :]
        jl, jscratch = jax_forward(jparams, jnp.asarray(row), jcfg,
                                   positions=jnp.asarray(pos),
                                   kv_cache=jscratch, cache_len=off + C)
        tl, tscratch = decoder_forward(tparams, torch.from_numpy(row), tcfg,
                                       positions=torch.from_numpy(pos),
                                       kv_cache=tscratch, cache_len=off + C)
        _close(tl[0, :valid], np.asarray(jl)[0, :valid])
    n = len(prompt)
    _close(tscratch["k"][:, :, :n], np.asarray(jscratch["k"])[:, :, :n])
    return np.asarray(jl)[0, valid - 1], tl[0, valid - 1], jscratch, tscratch


def test_chunked_prefill_splice_and_paged_decode_match(tiny):
    jcfg, jparams, tcfg, tparams = tiny
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, jcfg.vocab_size, n).tolist() for n in (37, 16)]
    mb = S // BS + 1                       # + the always-trash column
    n_blocks = 2 * (S // BS) + 1
    shape = (jcfg.n_layers, n_blocks, BS, jcfg.n_kv_heads, jcfg.head_dim)
    jk, jv = np.zeros(shape, np.float32), np.zeros(shape, np.float32)
    tpool = {"k": torch.zeros(shape), "v": torch.zeros(shape)}
    # scrambled physical blocks per sequence; the rest of a row is trash
    perm = rng.permutation(np.arange(1, n_blocks))
    table = np.zeros((2, mb), np.int32)
    table[0, :S // BS] = perm[:S // BS]
    table[1, :S // BS] = perm[S // BS:]
    ecfg = EngineConfig(max_batch=2, max_seq_len=S, kv_block_size=BS,
                        prefill_chunk=C)
    graphs = GraphFactory(tcfg, ecfg, C, torch.device("cpu"))
    last_tokens = []
    for b, prompt in enumerate(prompts):
        jlast, tlast, jscr, tscr = _chunked_prefill(tiny, prompt)
        assert int(tlast.argmax()) == int(jlast.argmax())
        last_tokens.append(int(jlast.argmax()))
        # the port splices with its own graph; the JAX side by hand
        for off in range(0, len(prompt), C):
            phys = table[b, off // BS:(off + C) // BS]
            graphs.traced_splice(tpool, tscr["k"], tscr["v"], off, phys)
            for j, blk in enumerate(phys):
                sl = slice(off + j * BS, off + (j + 1) * BS)
                jk[:, blk] = np.asarray(jscr["k"])[:, 0, sl]
                jv[:, blk] = np.asarray(jscr["v"])[:, 0, sl]
    _close(tpool["k"], jk)
    jcache = {"k": jnp.asarray(jk), "v": jnp.asarray(jv),
              "table": jnp.asarray(table)}
    tpool["table"] = torch.from_numpy(table)
    clen = np.array([len(p) for p in prompts], np.int32)
    tok = np.array(last_tokens, np.int32)[:, None]
    for _ in range(4):
        jl, jcache = jax_forward(
            jparams, jnp.asarray(tok), jcfg, positions=jnp.asarray(clen[:, None]),
            kv_cache=jcache, cache_len=jnp.asarray(clen + 1), decode=True)
        tl, tpool = decoder_forward(
            tparams, torch.from_numpy(tok), tcfg,
            positions=torch.from_numpy(clen[:, None]), kv_cache=tpool,
            cache_len=torch.from_numpy(clen + 1), decode=True)
        _close(tl, jl)
        want_tok = np.asarray(jl)[:, -1].argmax(-1)
        np.testing.assert_array_equal(tl[:, -1].argmax(-1).numpy(), want_tok)
        tok = want_tok.astype(np.int32)[:, None]
        clen = clen + 1
    # the decode writes landed in the same physical blocks
    _close(tpool["k"], jcache["k"])


def test_rope_length_check_and_unported_branches_raise(tiny):
    _, _, tcfg, tparams = tiny
    toks = torch.zeros((1, 4), dtype=torch.int64)
    too_long = init_kv_cache(tcfg, 1, tcfg.max_seq_len + 8)
    with pytest.raises(ValueError, match="rope table"):
        decoder_forward(tparams, toks, tcfg, kv_cache=too_long,
                        cache_len=torch.tensor(4))
    # the dense branches are ported: a dense prefill of 4 tokens into a
    # 32-position cache, then one dense decode step, both as in JAX
    jcfg, jparams = tiny[:2]
    dense = init_kv_cache(tcfg, 1, 32)
    jdense = jax_init_kv_cache(jcfg, 1, 32)
    tl, dense = decoder_forward(tparams, toks, tcfg, kv_cache=dense)
    jl, jdense = jax_forward(jparams, jnp.asarray(toks.numpy(), jnp.int32),
                             jcfg, kv_cache=jdense)
    _close(tl, jl)
    tl, dense = decoder_forward(
        tparams, toks[:, :1], tcfg, positions=torch.tensor([[4]]),
        kv_cache=dense, cache_len=torch.tensor([5], dtype=torch.int32),
        decode=True)
    jl, jdense = jax_forward(
        jparams, jnp.zeros((1, 1), jnp.int32), jcfg,
        positions=jnp.array([[4]]), kv_cache=jdense,
        cache_len=jnp.array([5], jnp.int32), decode=True)
    _close(tl, jl)
    _close(dense["k"], jdense["k"])
