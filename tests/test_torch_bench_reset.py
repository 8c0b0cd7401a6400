"""``InferenceEngine.bench_reset_slots`` of the port against the JAX
engine's (``tpu9/serving/engine.py``) on llama-tiny: the same slot blocks,
host lengths, table rows and allocator free count after the same resets,
the table written in place (the decode windows' ``WindowState`` holds it),
and a dense engine left as it was."""

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
from tpu9_torch.bridge import params_from_jax
from tpu9_torch.models.llama import LLAMA_PRESETS
from tpu9_torch.serving.engine import EngineConfig, InferenceEngine

PAGED = dict(max_batch=4, max_seq_len=128, prefill_buckets=(16, 64),
             decode_steps=(1, 4), kv_block_size=16, prefill_chunk=16,
             prefix_cache_blocks=16, admit_group_chunks=2)
DENSE = dict(max_batch=2, max_seq_len=64, prefill_buckets=(16, 64),
             decode_steps=(1, 4))


@pytest.fixture(scope="module")
def weights():
    jcfg = dataclasses.replace(JAX_PRESETS["llama-tiny"], dtype=jnp.float32)
    tcfg = dataclasses.replace(LLAMA_PRESETS["llama-tiny"],
                               dtype=torch.float32)
    jparams = jax_init_decoder(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              "cpu")
    return jcfg, jparams, tcfg, tparams


def _pair(weights, knobs):
    jcfg, jparams, tcfg, tparams = weights
    return (JaxEngine(jparams, jcfg, JaxEngineConfig(**knobs)),
            InferenceEngine(tparams, tcfg, EngineConfig(**knobs),
                            device="cpu"))


def _assert_same_slots(jeng, teng):
    assert [list(b) for b in teng.pool.slot_blocks] == \
        [list(b) for b in jeng._slot_blocks]
    np.testing.assert_array_equal(teng._host_len, jeng._host_len)
    assert teng.allocator.free_count == jeng.allocator.free_count
    np.testing.assert_array_equal(teng.pool.table_np, jeng.pool.table_np)
    np.testing.assert_array_equal(teng.pool.table.numpy(),
                                  np.asarray(jeng.kv_cache["table"]))


@pytest.mark.parametrize("resets", [[(40, 20)], [(0, 5)], [(100, 27)],
                                    [(60, 30), (10, 4)],
                                    [(10, 4), (90, 37)]])
def test_bench_reset_slots_matches_the_jax_engine(weights, resets):
    jeng, teng = _pair(weights, PAGED)
    for ctx0, budget in resets:
        jeng.bench_reset_slots(ctx0, budget)
        teng.bench_reset_slots(ctx0, budget)
        _assert_same_slots(jeng, teng)
    ctx0, budget = resets[-1]
    bs = PAGED["kv_block_size"]
    need = -(-(ctx0 + budget + 1) // bs)
    blocks = [b for row in teng.pool.slot_blocks for b in row]
    # every slot covers ctx0 + budget + 1 positions with blocks of its own
    assert all(len(row) == need for row in teng.pool.slot_blocks)
    assert len(set(blocks)) == len(blocks)
    assert teng.pool.trash_block not in blocks


def test_bench_reset_writes_the_windows_table_in_place(weights):
    _, teng = _pair(weights, PAGED)
    window = teng.graphs.window
    table = window.kv_cache["table"]
    ptr = table.data_ptr()
    teng.bench_reset_slots(64, 32)
    assert window.kv_cache["table"] is table is teng.pool.table
    assert table.data_ptr() == ptr
    np.testing.assert_array_equal(table.numpy(), teng.pool.table_np)
    need = -(-(64 + 32 + 1) // PAGED["kv_block_size"])
    assert (table[:, :need] != teng.pool.trash_block).all()
    assert (table[:, need:] == teng.pool.trash_block).all()


def test_bench_reset_leaves_a_dense_engine_unchanged(weights):
    jeng, teng = _pair(weights, DENSE)
    before = {n: t.clone() for n, t in teng.kv_cache.items()}
    jeng.bench_reset_slots(20, 10)
    teng.bench_reset_slots(20, 10)
    assert teng.pool is None and not teng.paged
    np.testing.assert_array_equal(teng._host_len, jeng._host_len)
    assert not teng._host_len.any()
    for n, t in teng.kv_cache.items():
        assert torch.equal(t, before[n])
