"""The port's paged serving engine (``tpu9_torch.serving.engine``) against
the JAX ``InferenceEngine`` on llama-tiny at f32, the port's params
converted from the JAX ones by ``params_from_jax``.

Both engines serve the same concurrent prompts (one pair shares a prefix,
so prefix reuse runs) through chunked prefill, fused admission groups and
paged decode windows. Greedy token streams must be identical: at f32 the
two decoders agree to ~1e-5 in the logits (``test_torch_model.py``), far
inside the margins greedy decoding turns on.
"""

import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu9.models import init_decoder as jax_init_decoder
from tpu9.models.llama import LLAMA_PRESETS as JAX_PRESETS
from tpu9.serving.engine import EngineConfig as JaxEngineConfig
from tpu9.serving.engine import InferenceEngine as JaxEngine
from tpu9.serving.presets import load_engine as jax_load_engine
from tpu9_torch.bridge import params_from_jax
from tpu9_torch.models.llama import LLAMA_PRESETS
from tpu9_torch.ops import paged_attention as tpaged
from tpu9_torch.serving.engine import EngineConfig, InferenceEngine
from tpu9_torch.serving.presets import load_engine

torch.set_num_threads(2)

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
    want = jax_load_engine("llama-tiny", **kw).ecfg
    if want.kv_block_size == 0:
        # the reference falls back to its dense engine, which the port
        # does not have yet
        with pytest.raises(NotImplementedError, match="A11"):
            load_engine("llama-tiny", device="cpu", **kw)
        return
    got = load_engine("llama-tiny", device="cpu", **kw).ecfg
    for name in ("max_batch", "max_seq_len", "prefill_buckets",
                 "decode_steps", "kv_block_size", "kv_pool_blocks",
                 "prefill_chunk", "prefix_cache_blocks"):
        assert getattr(got, name) == getattr(want, name), name


def test_int8_serving_raises_until_its_slice():
    with pytest.raises(NotImplementedError, match="A7"):
        load_engine("llama-tiny-int8", device="cpu")
    with pytest.raises(NotImplementedError, match="A7"):
        load_engine("llama-tiny", device="cpu", kv_quant="int8")
