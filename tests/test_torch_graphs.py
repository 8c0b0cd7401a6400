"""The port's graph factory (``tpu9_torch.serving.graphs``) against the JAX
``GraphFactory`` on llama-tiny: the compile sentinel counts as the
reference's does, warmup builds the reference's key set (with speculation
on, its verify keys too), serving adds no build after it, and a key
outside the sealed set is one counted and timed miss. The window's static
device state keeps its addresses (the verify buffers too), sampled
windows draw anew each window in the eager engine's order (a verify window
one [B, t] draw), and a replayed window adds the launches its capture
counted (a stand-in graph object: there is no card here). The paged
admission bodies, which read their offsets, last-token indices, block ids
and table row on the device, give bit for bit what the host-int bodies
they replaced gave (written out here as the reference); the admission
buffers keep their addresses; a captured admission replays only the
tensors it was captured over; and every admission dispatch is counted, as
a replay on a capturing factory (stand-in graphs) and as an eager run on
the CPU."""

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
from tpu9_torch.models.transformer import decoder_forward, init_decoder
from tpu9_torch.ops import paged_attention as pa
from tpu9_torch.ops.quant import dequantize_kv, quantize_kv
from tpu9_torch.ops.sampling import sample_logits
from tpu9_torch.serving.engine import EngineConfig, InferenceEngine
from tpu9_torch.serving.graphs import (CapturedAdmission, CapturedWindow,
                                       GraphFactory)

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
def test_warmup_keys_with_spec_equal_the_jax_factory(tiny, mode):
    """With ``spec_len=8`` warmup builds every key the reference's does,
    ``("verify", 8)`` among them, and serving speculatively builds no
    other."""
    jcfg, jparams, _, _ = tiny
    ecfg = dict(MODES[mode], spec_len=8)
    jeng = JaxEngine(jparams, jcfg, JaxEngineConfig(**ecfg))
    teng = _engine(tiny, ecfg)
    jeng.warmup()
    timings = teng.warmup()
    assert set(teng.graphs.compiled) == set(jeng.graphs.compiled)
    assert ("verify", 8) in teng.graphs.compiled
    assert "verify_s8_s" in timings
    assert teng.graphs.compiles == len(jeng.graphs.compiled)
    outs = asyncio.run(_serve(teng, _spec_traffic()))
    assert [len(o) for o in outs] == [n for _, n in _spec_traffic()]
    stats = teng.stats()
    assert stats["spec_windows"] > 0
    assert stats["graph_compiles_post_warmup"] == 0
    assert set(teng.graphs.compiled) == set(jeng.graphs.compiled)


def _spec_traffic():
    """Two cyclic prompts (prompt lookup proposes at once) and one random
    one."""
    rng = np.random.default_rng(9)
    return [([7, 8, 9] * 6, 40), (rng.integers(1, 500, 30).tolist(), 24),
            ([4, 5, 6, 7] * 5, 33)]


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


@pytest.mark.parametrize("mode", list(MODES))
def test_verify_buffers_keep_their_addresses(tiny, mode):
    """The verify window replays the drafts, out and n_acc buffers: speculative
    serving writes them (and the rest of the window state) in place."""
    teng = _engine(tiny, dict(MODES[mode], spec_len=8))
    st = teng.graphs.window
    assert (st.drafts, st.out, st.n_acc) == (teng._drafts, teng._spec_out,
                                             teng._n_acc)
    assert st.drafts.shape == (2, 8) and st.out.shape == (2, 9)
    assert st.n_acc.shape == (2,)
    names = ("last_token", "cache_len", "_active_dev", "_toks", "_drafts",
             "_spec_out", "_n_acc")

    def ptrs():
        out = {n: getattr(teng, n).data_ptr() for n in names}
        out.update({f"kv_{n}": t.data_ptr()
                    for n, t in teng.kv_cache.items()})
        return out

    before = ptrs()
    teng.warmup()
    asyncio.run(_serve(teng, _spec_traffic()))
    assert teng.stats()["spec_windows"] > 0
    assert ptrs() == before
    assert (st.drafts, st.out, st.n_acc) == (teng._drafts, teng._spec_out,
                                             teng._n_acc)


def test_sampled_verify_window_draws_b_by_t_in_the_eager_order(tiny):
    """temperature > 0: one verify window draws one [B, t, V] uniform from
    the engine's generator, as the eager forward and ``sample_logits`` over
    every row would, and the next window draws anew."""
    import copy
    _, _, tcfg, tparams = tiny
    ecfg = EngineConfig(**dict(PAGED, spec_len=4), temperature=0.8,
                        top_k=50)
    teng = InferenceEngine(tparams, tcfg, ecfg, device="cpu")
    teng.warmup()
    window = teng.graphs.verify_fn(4)
    b, t = ecfg.max_batch, 5

    def set_state():
        teng.last_token.copy_(torch.tensor([[7], [11]], dtype=torch.int32))
        teng.cache_len.copy_(torch.tensor([3, 9], dtype=torch.int32))
        teng._drafts.copy_(torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]],
                                        dtype=torch.int32))
        teng._active_dev.fill_(True)

    set_state()
    cache = copy.deepcopy(teng.kv_cache)
    gen = torch.Generator().manual_seed(0)
    gen.set_state(teng._gen.get_state())
    window()
    got = teng._spec_out[:, :t].clone()
    tokens = torch.tensor([[7, 1, 2, 3, 4], [11, 5, 6, 7, 8]])
    positions = torch.tensor([[3], [9]]) + torch.arange(t)[None]
    logits, _ = decoder_forward(tparams, tokens, tcfg, positions=positions,
                                kv_cache=cache, cache_len=positions[:, 0] + t)
    want = sample_logits(logits, gen, temperature=0.8, top_k=50)
    assert want.shape == (b, t)
    assert torch.equal(got, want.to(torch.int32))
    assert torch.equal(teng._gen.get_state(), gen.get_state())
    agree = (tokens[:, 1:] == want[:, :-1]).int().cumprod(1).sum(1)
    assert torch.equal(teng._n_acc, agree.to(torch.int32))
    assert torch.equal(teng.cache_len,
                       torch.tensor([3, 9], dtype=torch.int32) + agree + 1)
    set_state()
    window()
    assert not torch.equal(teng._spec_out[:, :t], got)


def test_verify_replay_adds_the_launches_its_capture_counted(tiny,
                                                            monkeypatch):
    """On the card the verify window calls each layer's decode wrapper once
    (the B*T rows in one call; modelled here by the card route in place of
    the CPU's twin): a capture counts those calls, takes them back, and
    each replay of the stand-in graph adds them, bf16 pool and int8 pool."""
    from tpu9_torch.models import transformer
    from tpu9_torch.ops.attention import verify_as_decode
    _, _, tcfg, tparams = tiny
    for kv_quant, name in (("", "paged_decode_attention"),
                           ("int8", "paged_decode_attention_quant")):
        wrapped = getattr(pa, name)

        def counting(*args, _w=wrapped):
            _w.launches += 1             # a CPU call counts nothing itself
            return _w(*args)

        monkeypatch.setattr(pa, name, counting)
        monkeypatch.setattr(transformer, "paged_verify_attention",
                            verify_as_decode)
        teng = InferenceEngine(tparams, tcfg, EngineConfig(
            **dict(PAGED, spec_len=4, kv_quant=kv_quant)), device="cpu")
        start = pa.launch_counts()
        counted = pa.captured_launches(teng.graphs.verify_fn(4))
        assert counted == {name: tcfg.n_layers}
        assert pa.launch_counts() == start

        class StandIn:
            def replay(self):
                pass

        window = CapturedWindow(StandIn(), counted)
        for _ in range(3):
            window()
        got = pa.launch_counts()
        assert got[name] == start[name] + 3 * tcfg.n_layers
        pa.add_launches({name: -3 * tcfg.n_layers})
        assert pa.launch_counts() == start
        monkeypatch.undo()


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


# -- paged admission over device-resident inputs -----------------------------

ADMIT = dict(max_batch=2, max_seq_len=128, prefill_buckets=(16, 64),
             decode_steps=(1, 4), kv_block_size=8, prefill_chunk=16,
             admit_group_chunks=3)
# (prompt tokens, cached prefix tokens): one chunk; a full group of 3; a
# group and a partial tail; 2 chunks after a 32-token prefix gather
ADMISSIONS = {"chunk": (11, 0), "group": (48, 0), "tail": (61, 0),
              "prefix": (60, 32)}


def _host_chunk_step(f, params, scratch, tok_row, offset: int,
                     last_idx: int):
    """The chunk step as it was with a host-int offset and index."""
    positions = offset + torch.arange(f.chunk)[None, :]
    logits, scratch = decoder_forward(
        params, tok_row[None, :], f.cfg, positions=positions,
        kv_cache=scratch, cache_len=offset + f.chunk, rope=f.rope)
    return logits[0, last_idx], scratch


def _host_splice(f, pool, scratch, offset: int, phys) -> None:
    """The splice as it was: block by block over host block ids."""
    bs = f.ecfg.kv_block_size
    for j in range(f.chunk // bs):
        start, blk = offset + j * bs, int(phys[j])
        for name in ("k", "v"):
            block = scratch[name][:, 0, start:start + bs]
            if "k_scale" in pool:
                block, pool[f"{name}_scale"][:, blk] = quantize_kv(block)
            pool[name][:, blk] = block


def _host_gather(f, pool, row, scratch) -> None:
    """The prefix gather as it was, over a numpy table row."""
    idx = torch.from_numpy(np.asarray(row, dtype=np.int64))
    for name in ("k", "v"):
        g = pool[name][:, idx]
        if f"{name}_scale" in pool:
            g = dequantize_kv(g, pool[f"{name}_scale"][:, idx],
                              scratch[name].dtype)
        l_, mb, bs, kh, d = g.shape
        scratch[name][:, 0] = g.reshape(l_, mb * bs, kh,
                                        d)[:, :f.ecfg.max_seq_len]


def _admission_inputs(f, prompt, p, blocks):
    """An admission's host values, as the engine builds them: the table
    row and each chunk's tokens, offset, last-token index and blocks
    (past the slot's blocks: the trash block 0)."""
    c, bs = f.chunk, f.ecfg.kv_block_size
    mb = f.ecfg.max_seq_len // bs + 1
    row = np.zeros((mb,), np.int32)
    row[:len(blocks)] = blocks
    suffix = prompt[p:]
    n = -(-len(suffix) // c)
    toks = np.zeros((n, c), np.int32)
    offs, lasts = np.zeros((n,), np.int32), np.zeros((n,), np.int32)
    phys = np.zeros((n, c // bs), np.int32)
    for k, i in enumerate(range(0, len(suffix), c)):
        valid = min(c, len(suffix) - i)
        toks[k, :valid] = suffix[i:i + valid]
        offs[k], lasts[k] = p + i, valid - 1
        for j in range(c // bs):
            if (p + i) // bs + j < len(blocks):
                phys[k, j] = blocks[(p + i) // bs + j]
    return row, toks, offs, lasts, phys


@pytest.mark.parametrize("case", list(ADMISSIONS))
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_device_admission_bodies_match_the_host_int_bodies(case, kv):
    """The admission computations over device-resident inputs (one packed
    copy, rows moved to the front per dispatch, the fused group for full
    groups) leave the scratch, every pool block but the trash block, the
    int8 scale planes and the last-token logits bit for bit as the host-int
    bodies did, chunk by chunk."""
    cfg = LLAMA_PRESETS["llama-tiny"]
    assert cfg.dtype == torch.bfloat16
    ecfg = EngineConfig(**ADMIT, kv_quant="int8" if kv == "int8" else "")
    f = GraphFactory(cfg, ecfg, 16, torch.device("cpu"))
    params = init_decoder(cfg, torch.Generator().manual_seed(3), "cpu")
    gen = torch.Generator().manual_seed(4)
    n_blocks, bs = 40, ecfg.kv_block_size
    shape = (cfg.n_layers, n_blocks, bs, cfg.n_kv_heads, cfg.head_dim)
    if kv == "int8":
        pool = {n: torch.randint(-127, 128, shape, generator=gen,
                                 dtype=torch.int8) for n in ("k", "v")}
        pool.update({f"{n}_scale": torch.rand(shape[:-1], generator=gen)
                     for n in ("k", "v")})
    else:
        pool = {n: torch.randn(shape, generator=gen).to(torch.bfloat16)
                for n in ("k", "v")}
    scr_shape = (cfg.n_layers, 1, ecfg.max_seq_len, cfg.n_kv_heads,
                 cfg.head_dim)
    scratch = {n: torch.randn(scr_shape, generator=gen).to(torch.bfloat16)
               for n in ("k", "v")}
    n, p = ADMISSIONS[case]
    prompt = torch.randint(1, cfg.vocab_size, (n,), generator=gen).tolist()
    blocks = torch.randperm(n_blocks - 1, generator=gen)[:n // bs + 1] + 1
    row, toks, offs, lasts, phys = _admission_inputs(f, prompt, p,
                                                     blocks.tolist())

    want_pool = {k: t.clone() for k, t in pool.items()}
    want_scr = {k: t.clone() for k, t in scratch.items()}
    if p:
        _host_gather(f, want_pool, row, want_scr)
    for k in range(len(toks)):
        want, want_scr = _host_chunk_step(
            f, params, want_scr, torch.from_numpy(toks[k]), int(offs[k]),
            int(lasts[k]))
        _host_splice(f, want_pool, want_scr, int(offs[k]), phys[k])

    a = f.admit
    assert a.stage(blocks.tolist(), prompt[p:], p) == len(toks)
    for got_rows, want_rows in ((a.row, row), (a.toks, toks),
                                (a.offsets, offs), (a.last_idx, lasts),
                                (a.phys, phys)):
        assert got_rows[:len(want_rows)].tolist() == want_rows.tolist()
    if p:
        f.gather_fn()(pool, a.row, scratch)
    k, group = 0, ecfg.admit_group_chunks
    while k < len(toks):
        g = group if len(toks) - k >= group else 1
        a.take(k, g)
        if g > 1:
            _, scratch, got = f.chunk_group_fn(g)(
                params, pool, scratch, a.toks[:g], a.offsets[:g],
                a.last_idx[:g], a.phys[:g])
        else:
            got, scratch = f.chunk_fn()(params, a.toks[:1], a.offsets[:1],
                                        scratch, a.last_idx[:1])
            f.splice_fn()(pool, scratch["k"], scratch["v"], a.offsets[:1],
                          a.phys[0])
        k += g
    assert case != "tail" or group == 3 and len(toks) == 4
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    for name in ("k", "v"):
        torch.testing.assert_close(scratch[name], want_scr[name], rtol=0,
                                   atol=0)
    for name, t in pool.items():
        # block 0 is the trash block: padded chunk positions land there
        torch.testing.assert_close(t[:, 1:], want_pool[name][:, 1:], rtol=0,
                                   atol=0)


def test_admission_buffers_keep_their_addresses(tiny):
    """A captured admission replays fixed addresses: mixed traffic (a
    prefix hit, single chunks, a full group, a group and a tail) writes
    the admission buffers, the scratch and the pool in place."""
    teng = _engine(tiny, PAGED)
    a = teng.graphs.admit

    def ptrs():
        out = {n: getattr(a, n).data_ptr()
               for n in ("packed", "row", "chunks", "toks", "offsets",
                         "last_idx", "phys", "logits")}
        out.update({f"scratch_{n}": t.data_ptr()
                    for n, t in teng._scratch.items()})
        out.update({f"kv_{n}": t.data_ptr()
                    for n, t in teng.kv_cache.items()})
        return out

    before = ptrs()
    assert a.chunks.data_ptr() == a.packed[a.row.numel():].data_ptr()
    assert a.toks.shape == (PAGED["max_seq_len"] // 16, 16)
    assert a.phys.shape == (PAGED["max_seq_len"] // 16, 1)
    assert a.logits.shape == (tiny[2].vocab_size,)
    teng.warmup()
    asyncio.run(_serve(teng, _traffic()))
    assert ptrs() == before
    assert teng.graphs.admit is a
    assert teng.stats()["prefix_cache"]["hits"] > 0


def test_admission_replay_adds_the_launches_its_capture_counted():
    """A captured admission replays its graph, adds the launches its
    capture counted, returns what the capture left, and refuses tensors
    other than those it was captured over."""
    start = pa.launch_counts()

    class StandIn:
        replays = 0

        def replay(self):
            self.replays += 1

    graph = StandIn()
    toks, offset = torch.zeros((1, 16), dtype=torch.int32), torch.zeros(
        (1,), dtype=torch.int32)
    logits = torch.zeros((8,))
    adm = CapturedAdmission(
        CapturedWindow(graph, {"paged_decode_attention": 2}),
        (toks.data_ptr(), offset.data_ptr()), (logits, {"k": None}))
    for _ in range(3):
        assert adm({}, toks, offset)[0] is logits
    assert graph.replays == 3
    assert pa.launch_counts()["paged_decode_attention"] == start[
        "paged_decode_attention"] + 6
    with pytest.raises(ValueError, match="captured over"):
        adm({}, toks.clone(), offset)
    assert graph.replays == 3
    pa.add_launches({"paged_decode_attention": -6})
    assert pa.launch_counts() == start


@pytest.mark.parametrize("captures", [False, True],
                         ids=["cpu_eager", "stand_in_graphs"])
def test_admission_dispatches_are_counted_replayed_or_eager(tiny, captures):
    """Every admission dispatch is counted in the engine's spans: on the
    CPU as an eager run; on a capturing factory (stand-in graphs whose
    replay runs what was captured over the fixed buffers) as one replay a
    dispatch, the warmup's included, and the served tokens are the eager
    engine's."""
    want = asyncio.run(_serve(_engine(tiny, PAGED), _traffic()))
    teng = _engine(tiny, PAGED)
    f = teng.graphs
    if captures:
        class StandIn:
            def __init__(self, fn):
                self.replay = fn

        def capture(key, window, draws=True):
            window()                        # the warm run before a capture
            return CapturedWindow(StandIn(window), {})

        f.captures, f._capture = True, capture
    teng.warmup()
    got = asyncio.run(_serve(teng, _traffic()))
    assert got == want
    st = teng.stats()
    assert st["graph_compiles_post_warmup"] == 0
    counts = teng.span_totals()["counts"]
    how = "replayed" if captures else "eager"
    assert {name.split(".")[1] for name in counts} == {how}
    assert {name.split(".")[0] for name in counts} == {
        "chunk", "splice", "gather", "chunkgroup"}
    # warmup dispatches each kind once; then admit_dispatches counts them
    assert sum(counts.values()) == st["admit_dispatches"] + 4
    assert counts[f"chunk.{how}"] == counts[f"splice.{how}"]
    assert counts[f"gather.{how}"] == st["prefix_cache"]["hits"] + 1
