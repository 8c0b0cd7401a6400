"""The port's paged serving engine (``tpu9_torch.serving.engine``) against
the JAX ``InferenceEngine`` on llama-tiny at f32, the port's params
converted from the JAX ones by ``params_from_jax``.

Both engines serve the same concurrent prompts (one pair shares a prefix,
so prefix reuse runs) through chunked prefill, fused admission groups and
paged decode windows. Greedy token streams must be identical: at f32 the
two decoders agree to ~1e-5 in the logits (``test_torch_model.py``), far
inside the margins greedy decoding turns on.

The int8 engines (a JAX int8 weight tree carried over by the bridge, an
int8 KV pool) are held to the same streams; a fork, should the two sums'
order ever tip a near-tie, is judged as the JAX suite judges one
(``tests/test_quant_serving.py``): the port's token must lie within 0.35 of
the argmax of a full-context JAX forward.
"""

import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu9.models import init_decoder as jax_init_decoder
from tpu9.models import decoder_forward as jax_forward
from tpu9.models.llama import LLAMA_PRESETS as JAX_PRESETS
from tpu9.ops.quant import quantize_decoder as jax_quantize_decoder
from tpu9.serving.engine import EngineConfig as JaxEngineConfig
from tpu9.serving.engine import InferenceEngine as JaxEngine
from tpu9.serving.presets import load_engine as jax_load_engine
from tpu9_torch.bridge import params_from_jax
from tpu9_torch.models.llama import LLAMA_PRESETS
from tpu9_torch.ops import paged_attention as tpaged
from tpu9_torch.serving.engine import EngineConfig, InferenceEngine
from tpu9_torch.serving.presets import load_engine

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


ENGINE = dict(max_batch=4, max_seq_len=128, prefill_buckets=(16, 64),
              decode_steps=(1, 4), kv_block_size=16, prefill_chunk=16,
              prefix_cache_blocks=16, admit_group_chunks=2)


@pytest.fixture(scope="module")
def engines():
    jcfg = dataclasses.replace(JAX_PRESETS["llama-tiny"], dtype=jnp.float32)
    tcfg = dataclasses.replace(LLAMA_PRESETS["llama-tiny"],
                               dtype=torch.float32)
    jparams = jax_init_decoder(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              "cpu")
    return (JaxEngine(jparams, jcfg, JaxEngineConfig(**ENGINE)),
            InferenceEngine(tparams, tcfg, EngineConfig(**ENGINE),
                            device="cpu"))


def _prompts():
    rng = np.random.default_rng(11)
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
        # then a repeat of the first prompt: its full-block prefix is hit
        again = await engine.generate(prompts[0], max_new_tokens=max_new)
    finally:
        await engine.stop()
    return outs, again


@pytest.mark.usefixtures("jax_table_copies")
def test_greedy_streams_identical_to_jax_engine(engines):
    jeng, teng = engines
    prompts = _prompts()
    tpaged.paged_decode_attention.launches = 0
    want = asyncio.run(_serve(jeng, prompts, 8))
    got = asyncio.run(_serve(teng, prompts, 8))
    assert got == want
    assert all(len(o) == 8 for o in got[0])
    stats = teng.stats()
    assert stats["prefix_cache"]["hits"] >= 2
    assert stats["prefix_cache"]["hits"] == jeng.stats()["prefix_cache"]["hits"]
    assert stats["decode_steps"] > 0 and stats["admit_dispatches"] > 0
    # every slot retired and gave its blocks back; the trash block and the
    # prefix cache's holdings stay allocated, the same blocks in both
    assert stats["active_streams"] == 0 and stats["kv_blocks_reserved"] == 0
    assert stats["kv_blocks_used"] == jeng.stats()["kv_blocks_used"] > 1
    assert stats["prefix_cache"] == {
        k: v for k, v in jeng.stats()["prefix_cache"].items()
        if k in stats["prefix_cache"]}
    # the CPU engine takes the kernel's plain twin: no launch is counted
    assert tpaged.paged_decode_attention.launches == 0


def test_prompt_over_the_limit_raises_in_both(engines):
    prompt = list(range(1, ENGINE["max_seq_len"] + 1))     # limit is S - 1
    for engine in engines:
        with pytest.raises(ValueError, match="exceeds engine limit"):
            asyncio.run(engine.generate(prompt, max_new_tokens=2))


def test_warmup_leaves_the_pool_and_slots_untouched(engines):
    _, teng = engines
    before = teng.allocator.used_count, teng.allocator.reserved
    timings = teng.warmup()
    assert set(timings) == {"chunk_16_s", "chunk_group_2_s", "decode_k1_s",
                            "decode_k4_s"}
    assert (teng.allocator.used_count, teng.allocator.reserved) == before
    assert not teng.active.any() and int(teng.cache_len.abs().sum()) == 0


@pytest.mark.parametrize("buckets,block,seq", [
    ((128, 512, 2048), 256, 512),      # the defaults' rule: block = chunk
    ((32, 64), 16, 256),
    ((48,), 32, 240),                  # block does not divide the chunk
])
def test_load_engine_pages_by_the_reference_rule(buckets, block, seq):
    kw = dict(max_batch=2, max_seq_len=seq, prefill_buckets=buckets,
              kv_block_size=block)
    jeng = jax_load_engine("llama-tiny", **kw)
    teng = load_engine("llama-tiny", device="cpu", **kw)
    want, got = jeng.ecfg, teng.ecfg
    for name in ("max_batch", "max_seq_len", "prefill_buckets",
                 "decode_steps", "kv_block_size", "kv_pool_blocks",
                 "prefill_chunk", "prefix_cache_blocks"):
        assert getattr(got, name) == getattr(want, name), name
    assert teng.paged == jeng.paged
    if not want.kv_block_size:
        # the reference falls back to its dense engine, and so does the
        # port: it serves, and stats carry no paged key, as in JAX
        assert not teng.paged
        assert "kv_block_size" not in teng.stats()
        assert "kv_block_size" not in jeng.stats()
        assert len(asyncio.run(_serve(teng, [[3, 1, 4]], 3))[0][0]) == 3


SMALL = dict(max_batch=2, max_seq_len=64, prefill_buckets=(16,),
             decode_steps=(1, 4), kv_block_size=16)


def test_int8_serving_covers_dense_and_moe_models(int8_engines):
    """The int8 presets serve (int8 weights by the suffix or by
    ``quantize=``, the int8 pool by ``kv_quant=``), int8 weights serve on
    the dense engine too, as the JAX engine's, and an int8 mixtral serves
    over the int8 pool, its expert stacks int8 per expert (the reference's
    ``test_moe_quantized_engine_serves``)."""
    for name, kw in (("llama-tiny-int8", {}),
                     ("llama-tiny", dict(quantize="int8"))):
        engine = load_engine(name, device="cpu", kv_quant="int8", **SMALL,
                             **kw)
        assert engine.params["layers"][0]["wq"]["q"].dtype == torch.int8
        assert engine.kv_cache["k"].dtype == torch.int8
        assert engine.stats()["kv_quant"] == "int8"
        out = asyncio.run(_serve(engine, [[3, 1, 4, 1, 5]], 6))[0]
        assert len(out[0]) == 6
    dense = load_engine("llama-tiny-int8", device="cpu", paged=False, **SMALL)
    assert not dense.paged and dense.ecfg.kv_block_size == 0
    assert dense.params["layers"][0]["wq"]["q"].dtype == torch.int8
    assert len(asyncio.run(_serve(dense, [[3, 1, 4, 1, 5]], 4))[0][0]) == 4
    # on the JAX int8 tree, the dense engines of both packages agree
    jparams, jcfg, _, teng = int8_engines
    kw = dict(max_batch=2, max_seq_len=64, prefill_buckets=(16,),
              decode_steps=(1, 4))
    prompt = [[3, 1, 4, 1, 5]]
    want = asyncio.run(_serve(JaxEngine(jparams, jcfg, JaxEngineConfig(**kw)),
                              prompt, 6))
    got = asyncio.run(_serve(InferenceEngine(teng.params, teng.cfg,
                                             EngineConfig(**kw),
                                             device="cpu"), prompt, 6))
    assert got == want
    moe = load_engine("mixtral-tiny-int8", device="cpu", kv_quant="int8",
                      **SMALL)
    assert moe.params["layers"][0]["moe"]["w_up"]["q"].dtype == torch.int8
    assert moe.params["layers"][0]["moe"]["router"].dtype == torch.float32
    assert moe.kv_cache["k"].dtype == torch.int8
    assert len(asyncio.run(_serve(moe, [[3, 1, 4, 1, 5]], 8))[0][0]) == 8


@pytest.fixture(scope="module")
def int8_engines():
    """The JAX engine on a JAX int8 tree with an int8 pool, and the port's
    on the same tree carried over by the bridge."""
    jcfg = dataclasses.replace(JAX_PRESETS["llama-tiny"], dtype=jnp.float32)
    tcfg = dataclasses.replace(LLAMA_PRESETS["llama-tiny"],
                               dtype=torch.float32)
    jparams = jax_quantize_decoder(
        jax_init_decoder(jax.random.PRNGKey(0), jcfg))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              "cpu")
    return (jparams, jcfg,
            JaxEngine(jparams, jcfg, JaxEngineConfig(**ENGINE,
                                                     kv_quant="int8")),
            InferenceEngine(tparams, tcfg,
                            EngineConfig(**ENGINE, kv_quant="int8"),
                            device="cpu"))


@pytest.mark.usefixtures("jax_table_copies")
def test_int8_greedy_streams_match_jax_engine(int8_engines):
    jparams, jcfg, jeng, teng = int8_engines
    prompts = _prompts()
    tpaged.paged_decode_attention_quant.launches = 0
    want = asyncio.run(_serve(jeng, prompts, 8))
    got = asyncio.run(_serve(teng, prompts, 8))
    for prompt, w, g in zip(prompts + [prompts[0]], want[0] + [want[1]],
                            got[0] + [got[1]]):
        assert len(g) == len(w) == 8
        for i, (a, b) in enumerate(zip(w, g)):
            if a != b:
                logits = jax_forward(
                    jparams, jnp.asarray([prompt + g[:i]], jnp.int32),
                    jcfg)[0, -1]
                assert float(jnp.max(logits) - logits[b]) < 0.35, (i, a, b)
                break
    stats = teng.stats()
    assert stats["kv_quant"] == "int8" == jeng.stats()["kv_quant"]
    assert stats["prefix_cache"]["hits"] >= 2
    assert teng.allocator.n_blocks == jeng.allocator.n_blocks
    assert stats["kv_blocks_used"] == jeng.stats()["kv_blocks_used"]
    # the CPU engine takes the int8 kernel's plain twin: no launch counted
    assert tpaged.paged_decode_attention_quant.launches == 0


def test_prefix_reuse_on_the_int8_pool_repeats_a_cold_admission():
    engine = load_engine("llama-tiny-int8", device="cpu", kv_quant="int8",
                         max_batch=2, max_seq_len=128, prefill_buckets=(16,),
                         decode_steps=(1, 4), kv_block_size=16,
                         prefix_cache_blocks=4)
    prompt = list(range(1, 40)) + [77]

    async def go():
        await engine.start()
        try:
            cold = await engine.generate(prompt, max_new_tokens=6)
            warm = await engine.generate(prompt, max_new_tokens=6)
        finally:
            await engine.stop()
        return cold, warm

    cold, warm = asyncio.run(go())
    assert cold == warm and len(cold) == 6
    assert engine.prefix_cache.hits >= 1


@pytest.mark.parametrize("case", ["dense_ecfg", "unaligned", "fp8",
                                  "engine_cfg", "quantize_fp8"])
def test_kv_quant_errors_match_jax(case):
    """Each misuse raises the same exception type with the same message in
    both packages."""
    tiny_t = LLAMA_PRESETS["llama-tiny"]
    tiny_j = JAX_PRESETS["llama-tiny"]
    ecfg = dict(kv_block_size=32, max_seq_len=256, max_batch=2,
                prefill_buckets=(32,), prefill_chunk=32)

    def port():
        if case == "dense_ecfg":
            InferenceEngine({}, tiny_t, EngineConfig(kv_block_size=0,
                                                     kv_quant="int8"),
                            device="cpu")
        elif case == "unaligned":
            load_engine("llama-tiny", device="cpu", max_batch=2,
                        max_seq_len=250, prefill_buckets=(33,),
                        kv_quant="int8")
        elif case == "fp8":
            load_engine("llama-tiny", device="cpu", max_batch=2,
                        kv_quant="fp8")
        elif case == "engine_cfg":
            load_engine("llama-tiny", device="cpu", kv_quant="int8",
                        engine_cfg=EngineConfig(**ecfg))
        else:
            load_engine("llama-tiny", device="cpu", quantize="fp8")

    def reference():
        if case == "dense_ecfg":
            JaxEngine({}, tiny_j, JaxEngineConfig(kv_block_size=0,
                                                  kv_quant="int8"))
        elif case == "unaligned":
            jax_load_engine("llama-tiny", max_batch=2, max_seq_len=250,
                            prefill_buckets=(33,), kv_quant="int8")
        elif case == "fp8":
            jax_load_engine("llama-tiny", max_batch=2, kv_quant="fp8")
        elif case == "engine_cfg":
            jax_load_engine("llama-tiny", kv_quant="int8",
                            engine_cfg=JaxEngineConfig(**ecfg))
        else:
            jax_load_engine("llama-tiny", quantize="fp8")

    with pytest.raises(ValueError) as want:
        reference()
    with pytest.raises(ValueError) as got:
        port()
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kv_quant", ["", "int8"])
def test_stats_report_the_pool_format(kv_quant):
    engine = load_engine("llama-tiny", device="cpu", kv_quant=kv_quant,
                         **SMALL)
    assert engine.stats()["kv_quant"] == kv_quant
    assert engine.kv_quant == bool(kv_quant)
    assert set(engine._pool_dict()) == (
        {"k", "v", "k_scale", "v_scale"} if kv_quant else {"k", "v"})
