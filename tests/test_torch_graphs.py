"""The port's graph factory (``tpu9_torch.serving.graphs``) against the JAX
``GraphFactory`` on llama-tiny: the compile sentinel counts as the
reference's does, warmup builds the reference's key set (verify keys
aside), serving adds no build after it, and a key outside the sealed set
is one counted and timed miss. The decode window's static device state
keeps its addresses, sampled windows draw anew each window in the eager
engine's order, and a replayed window adds the launches its capture
counted (a stand-in graph object: there is no card here)."""

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
from tpu9.serving.graphs import GraphFactory as JaxGraphFactory
from tpu9.serving.shard.policy import SingleDevicePolicy
from tpu9_torch.bridge import params_from_jax
from tpu9_torch.models.llama import LLAMA_PRESETS
from tpu9_torch.models.transformer import decoder_forward
from tpu9_torch.ops import paged_attention as pa
from tpu9_torch.ops.sampling import sample_logits
from tpu9_torch.serving.engine import EngineConfig, InferenceEngine
from tpu9_torch.serving.graphs import CapturedWindow, GraphFactory

torch.set_num_threads(2)

PAGED = dict(max_batch=2, max_seq_len=128, prefill_buckets=(16, 64),
             decode_steps=(1, 4), kv_block_size=16, prefill_chunk=16,
             prefix_cache_blocks=8, admit_group_chunks=2)
DENSE = dict(max_batch=2, max_seq_len=128, prefill_buckets=(16, 64, 256),
             decode_steps=(1, 4))
MODES = {"paged": PAGED, "dense": DENSE}


@pytest.fixture(scope="module")
def tiny():
    jcfg = dataclasses.replace(JAX_PRESETS["llama-tiny"], dtype=jnp.float32)
    tcfg = dataclasses.replace(LLAMA_PRESETS["llama-tiny"],
                               dtype=torch.float32)
    jparams = jax_init_decoder(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              "cpu")
    return jcfg, jparams, tcfg, tparams


def _engine(tiny, ecfg: dict) -> InferenceEngine:
    _, _, tcfg, tparams = tiny
    return InferenceEngine(tparams, tcfg, EngineConfig(**ecfg), device="cpu")


def _traffic():
    """Mixed traffic: a shared prefix (a cache hit), prompts of one chunk,
    of a full fused group and of a group plus a partial tail, and budgets
    that retire slots at staggered windows."""
    rng = np.random.default_rng(5)
    shared = rng.integers(1, 500, 40).tolist()
    return [(shared + rng.integers(1, 500, 5).tolist(), 9),
            (rng.integers(1, 500, 7).tolist(), 3),
            (shared + rng.integers(1, 500, 30).tolist(), 12),
            (rng.integers(1, 500, 60).tolist(), 6),
            (rng.integers(1, 500, 33).tolist(), 1)]


async def _serve(engine, traffic, stream_every: int = 2):
    await engine.start()
    try:
        async def one(i, prompt, n):
            if i % stream_every:
                return await engine.generate(prompt, max_new_tokens=n)
            req = await engine.generate(prompt, max_new_tokens=n,
                                        stream=True)
            out = []
            while (tok := await req.queue.get()) is not None:
                out.append(tok)
            return out
        return await asyncio.gather(*[one(i, p, n)
                                      for i, (p, n) in enumerate(traffic)])
    finally:
        await engine.stop()


@pytest.mark.parametrize("mode", list(MODES))
def test_sentinel_counts_misses_as_the_jax_factory(tiny, mode):
    """``compiles`` counts each new key once, a repeated key is a hit, and
    after ``seal`` a new key is a post-seal miss in both factories."""
    jcfg, _, tcfg, _ = tiny
    chunk = 16 if mode == "paged" else 0
    jg = JaxGraphFactory(jcfg, JaxEngineConfig(**MODES[mode]),
                         SingleDevicePolicy(), chunk=chunk)
    tg = GraphFactory(tcfg, EngineConfig(**MODES[mode]), chunk,
                      torch.device("cpu"))
    if mode == "paged":
        calls = ("chunk_fn", "gather_fn", "splice_fn", "chunk_fn",
                 ("chunk_group_fn", 2), "gather_fn", ("chunk_group_fn", 3))
    else:
        calls = (("prefill_fn", 16), ("dense_splice_fn", 16),
                 ("prefill_fn", 64), ("prefill_fn", 16),
                 ("dense_splice_fn", 64))
    for f in (jg, tg):
        for call in calls:
            name, *args = call if isinstance(call, tuple) else (call,)
            getattr(f, name)(*args)
    assert tg.compiles == jg.compiles == len(set(jg.compiled))
    assert set(tg.compiled) == set(jg.compiled)
    for f in (jg, tg):
        f.seal()
        name, *args = (calls[0] if isinstance(calls[0], tuple)
                       else (calls[0],))
        getattr(f, name)(*args)                        # a hit: not counted
    assert tg.post_seal_compiles == jg.post_seal_compiles == 0
    for f in (jg, tg):
        (f.chunk_group_fn(4) if mode == "paged" else f.prefill_fn(32))
    assert tg.post_seal_compiles == jg.post_seal_compiles == 1
    assert tg.compiles == jg.compiles


@pytest.mark.parametrize("mode", list(MODES))
def test_warmup_keys_equal_the_jax_factory(tiny, mode):
    jcfg, jparams, _, _ = tiny
    jeng = JaxEngine(jparams, jcfg, JaxEngineConfig(**MODES[mode]))
    teng = _engine(tiny, MODES[mode])
    jeng.warmup()
    teng.warmup()
    want = {k for k in jeng.graphs.compiled
            if not (isinstance(k, tuple) and k[0] == "verify")}
    assert set(teng.graphs.compiled) == want
    assert teng.graphs.compiles == len(want)
    if mode == "dense":
        # every bucket, each with its splice: the reference's warmup hole
        # of this kind stalled the first admission of a bucket
        assert {16, 64, 128, ("dsplice", 128)} <= want
    else:
        assert {("chunk", 16), "splice", "gather", ("chunkgroup", 2)} <= want
    assert {("decode", 1), ("decode", 4)} <= want


@pytest.mark.parametrize("mode", list(MODES))
def test_serving_after_warmup_builds_nothing_then_a_forced_key_is_timed(
        tiny, mode):
    teng = _engine(tiny, MODES[mode])
    teng.warmup()
    keys = set(teng.graphs.compiled)
    outs = asyncio.run(_serve(teng, _traffic()))
    assert [len(o) for o in outs] == [n for _, n in _traffic()]
    stats = teng.stats()
    assert stats["graph_compiles_post_warmup"] == 0
    assert stats["graph_compiles"] == len(keys) == teng.graphs.compiles
    assert stats["graph_compile_stall_s"] == 0.0
    assert set(teng.graphs.compiled) == keys
    if mode == "paged":
        assert stats["admit_interleaved_windows"] > 0
        assert stats["prefix_cache"]["hits"] > 0
    # a window size outside the sealed set: one counted, timed miss
    teng._active_dev.zero_()
    window = teng.graphs.decode_k(3)
    assert teng.graphs.post_seal_compiles == 1
    window()
    stall = teng.graphs.post_seal_stall_s
    assert stall > 0.0
    teng.graphs.decode_k(3)()                    # unwrapped: no more stall
    assert teng.graphs.post_seal_stall_s == stall
    stats = teng.stats()
    assert stats["graph_compiles_post_warmup"] == 1
    assert stats["graph_compiles"] == len(keys) + 1
    assert stats["graph_compile_stall_s"] > 0.0


@pytest.mark.parametrize("mode", list(MODES))
def test_window_state_keeps_its_addresses(tiny, mode):
    """A captured window replays fixed addresses: serving and admissions
    write the window's state and the block table in place, never anew."""
    teng = _engine(tiny, MODES[mode])
    st = teng.graphs.window

    def ptrs():
        out = {n: getattr(teng, n).data_ptr()
               for n in ("last_token", "cache_len", "_active_dev", "_toks")}
        out.update({f"kv_{n}": t.data_ptr()
                    for n, t in teng.kv_cache.items()})
        return out

    before = ptrs()
    assert st.kv_cache is teng.kv_cache and st.toks is teng._toks
    assert (st.last_token, st.cache_len, st.active) == (
        teng.last_token, teng.cache_len, teng._active_dev)
    teng.warmup()
    asyncio.run(_serve(teng, _traffic()))
    assert ptrs() == before
    assert st.kv_cache is teng.kv_cache
    if mode == "paged":
        assert teng.kv_cache["table"] is teng.pool.table
        # every slot retired: each table row is back to trash, in place
        assert not teng.pool.table.any()


def test_sampled_windows_draw_anew_in_the_eager_order(tiny):
    """temperature > 0: each window draws fresh noise from the engine's
    generator (a replay that repeated its capture's draw would repeat the
    tokens), and one request's stream is the sequence the eager engine
    drew before windows were captured: warmup's windows, the admission's
    draw, then one [B, V] draw per decode step, row 0 for slot 0."""
    _, _, tcfg, tparams = tiny
    ecfg = EngineConfig(**dict(PAGED, max_batch=2), temperature=0.8,
                        top_k=50)
    teng = InferenceEngine(tparams, tcfg, ecfg, device="cpu")
    teng.warmup()
    window = teng.graphs.decode_k(4)
    draws = []
    for _ in range(3):
        teng.last_token.fill_(7)
        teng.cache_len.fill_(3)
        window()
        draws.append(teng._toks[:4].clone())
    assert not torch.equal(draws[0], draws[1])
    assert not torch.equal(draws[1], draws[2])

    teng = InferenceEngine(tparams, tcfg, ecfg, device="cpu")
    teng.warmup()
    prompt = list(range(3, 23))
    out = asyncio.run(_serve(teng, [(prompt, 12)], stream_every=2))[0]

    gen = torch.Generator().manual_seed(0)
    b, vocab = ecfg.max_batch, tcfg.vocab_size
    for _ in range(sum(ecfg.decode_steps)):           # warmup's windows
        torch.rand((b, vocab), generator=gen)
    want = []
    for i in range(12):
        logits = decoder_forward(tparams, torch.tensor([prompt + want]),
                                 tcfg)[0, -1]
        rows = logits if i == 0 else logits[None].expand(b, vocab)
        tok = sample_logits(rows, gen, temperature=0.8, top_k=50)
        want.append(int(tok if i == 0 else tok[0]))
    assert out == want
    assert len(set(out)) > 3


def test_replay_adds_the_launches_its_capture_counted():
    """A capture runs the wrappers, which count launches that did not
    happen (the kernels went into the graph): ``captured_launches`` takes
    them back and returns them, and each replay adds them, as the decode
    kernels would have counted in an eager window."""
    names = [w.__name__ for w in pa.COUNTED]
    start = pa.launch_counts()

    def capture():
        # what one captured 3-layer, 2-step paged window counts
        pa.paged_decode_attention.launches += 6
        pa.ragged_decode_attention.launches += 0

    counted = pa.captured_launches(capture)
    assert counted == {"paged_decode_attention": 6}
    assert pa.launch_counts() == start

    class StandIn:
        replays = 0

        def replay(self):
            self.replays += 1

    graph = StandIn()
    window = CapturedWindow(graph, counted)
    for _ in range(3):
        window()
    assert graph.replays == 3
    got = pa.launch_counts()
    assert got["paged_decode_attention"] == start[
        "paged_decode_attention"] + 18
    assert all(got[n] == start[n] for n in names
               if n != "paged_decode_attention")
    pa.add_launches({"paged_decode_attention": -18})
    assert pa.launch_counts() == start


def test_a_failed_capture_raises_and_counts_nothing():
    """No fallback: a capture that fails propagates its error, and the
    launches it counted before failing are taken back."""
    start = pa.launch_counts()

    def capture():
        pa.paged_decode_attention_quant.launches += 2
        raise RuntimeError("capture failed")

    with pytest.raises(RuntimeError, match="capture failed"):
        pa.captured_launches(capture)
    assert pa.launch_counts() == start


def test_cpu_windows_are_the_eager_loop_and_need_the_window_state(tiny):
    _, _, tcfg, _ = tiny
    g = GraphFactory(tcfg, EngineConfig(**PAGED), 16, torch.device("cpu"))
    with pytest.raises(RuntimeError, match="WindowState"):
        g.decode_k(1)
    teng = _engine(tiny, PAGED)
    assert not isinstance(teng.graphs.decode_k(1), CapturedWindow)
    assert teng.graphs.capture_s == {} and teng.graphs.pool_bytes == 0
