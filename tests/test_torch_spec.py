"""The port's speculative decoding against the JAX package's.

- ``tpu9_torch.serving.spec`` (prompt-lookup proposer, drafts) against
  ``tpu9.serving.spec`` on seeded random and cyclic streams;
- ``paged_verify_attention``'s plain twin against the JAX function on bf16
  and int8 pools at head_dim 64, 128 and 256, with table padding and
  garbage blocks past every prefix; and the card route's reshaping (B*T
  one-token rows through the decode wrappers, which on a CPU tensor compute
  B1's and B2's plain twins) against both;
- a mirror of ``tests/test_spec_decode.py`` on the port's engine (llama-tiny
  at f32, the JAX weights carried over by ``params_from_jax``): greedy
  parity with speculation off, dense, paged and int8, EOS inside an
  accepted run, a cancel during a verify window, the acceptance gate,
  shadow scoring, an adversarial prompt, the proposer's cases;
- the port's spec-on streams and spec counters against the JAX spec-on
  engine's, dense, paged bf16 pool and paged int8 pool.

f32 throughout the engines: bf16 random-weight logits carry exact ties
whose argmax may break differently between the decode and verify shapes.
"""

import asyncio
import dataclasses
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu9.models import init_decoder as jax_init_decoder
from tpu9.models.llama import LLAMA_PRESETS as JAX_PRESETS
from tpu9.ops.attention import paged_verify_attention as jax_verify
from tpu9.ops.quant import quantize_decoder as jax_quantize_decoder
from tpu9.serving import spec as jax_spec
from tpu9.serving.engine import EngineConfig as JaxEngineConfig
from tpu9.serving.engine import InferenceEngine as JaxEngine
from tpu9_torch.bridge import params_from_jax
from tpu9_torch.models.llama import LLAMA_PRESETS
from tpu9_torch.ops import attention as at
from tpu9_torch.ops import paged_attention as pa
from tpu9_torch.serving import spec
from tpu9_torch.serving.engine import (EngineConfig, InferenceEngine,
                                       _Request)

torch.set_num_threads(2)


@pytest.fixture
def jax_table_copies(monkeypatch):
    """The JAX paged engine's block table handed over as a copy at each
    push, for the tests that hold its streams over interleaved admissions.

    On the CPU ``jnp.asarray`` of a 64-byte-aligned numpy array may wrap
    its memory without a copy, and the JAX pool rewrites its host table in
    place at each push (``tpu9/serving/kvpool.py`` ``push_table``). A
    window dispatched before an admission's push, which runs after it
    under load (dispatch is asynchronous), then reads the admitted slot's
    real blocks where its row was trash, and the inactive lane's write
    lands in the new request's first block. The port copies its table
    (``host_to_device``). Here the reference's policy hands the engine a
    copy of the table, the value it means to install."""
    from tpu9.serving.shard.policy import SingleDevicePolicy
    monkeypatch.setattr(
        SingleDevicePolicy, "device_table",
        lambda policy, table: jnp.asarray(np.array(table, copy=True)))


JCFG = dataclasses.replace(JAX_PRESETS["llama-tiny"], dtype=jnp.float32)
TCFG = dataclasses.replace(LLAMA_PRESETS["llama-tiny"], dtype=torch.float32)

# a prompt whose greedy trajectory turns repetitive early enough for
# speculation to engage within a ~200-token generation
CYCLER = [7, 8, 9, 7, 8, 9, 7, 8]


# -- proposer and drafts against the reference ---------------------------------

def _streams():
    """Seeded random streams over small vocabularies (many repeats), and
    cyclic ones with noise."""
    rng = np.random.default_rng(1994)
    out = [rng.integers(0, vocab, n).tolist()
           for vocab, n in ((3, 40), (6, 120), (20, 90), (2, 7), (500, 64))]
    for period in (1, 3, 5):
        cyc = [int(t) for t in rng.integers(0, 50, period)] * 12
        cyc[len(cyc) // 2] = 99
        out.append(cyc)
    return out


@pytest.mark.parametrize("i", range(8))
def test_proposer_matches_the_reference(i):
    toks = _streams()[i]
    for max_n, min_n in ((3, 2), (4, 1), (2, 2)):
        ours = spec.NGramProposer(toks, max_n=max_n, min_n=min_n)
        ref = jax_spec.NGramProposer(toks, max_n=max_n, min_n=min_n)
        for k in (0, 1, 4, 8, 13):
            assert ours.propose(k) == ref.propose(k), (max_n, min_n, k)
        # incremental equals bulk, after every appended token
        inc = spec.NGramProposer([], max_n=max_n, min_n=min_n)
        for j, t in enumerate(toks):
            inc.append(t)
            ref_j = jax_spec.NGramProposer(toks[:j + 1], max_n=max_n,
                                           min_n=min_n)
            assert inc.propose(6) == ref_j.propose(6)


def test_build_drafts_and_ewma_match_the_reference():
    streams = _streams()
    active = np.array([True, True, False, True, True, True, True, True])
    ours = [spec.make_slot_state(s) for s in streams]
    ref = [jax_spec.make_slot_state(s) for s in streams]
    ours[4] = ref[4] = None
    for s_len in (1, 4, 8):
        d, n = spec.build_drafts(ours, active, s_len)
        dj, nj = jax_spec.build_drafts(ref, active, s_len)
        assert d.dtype == np.int32 and n.dtype == np.int32
        assert d.shape == (len(streams), s_len)
        np.testing.assert_array_equal(d, dj)
        np.testing.assert_array_equal(n, nj)
    assert spec.EWMA_ALPHA == jax_spec.EWMA_ALPHA
    a, b = ours[0], ref[0]
    for prop, acc in ((8, 0), (8, 8), (0, 0), (5, 2), (8, 1)):
        a.observe(prop, acc)
        b.observe(prop, acc)
        assert (a.ewma, a.proposed, a.accepted, a.windows) == (
            b.ewma, b.proposed, b.accepted, b.windows)


# -- paged verify attention ------------------------------------------------------

def _verify_case(head_dim: int, quant: bool, dtype, seed: int,
                 heads=(4, 2)):
    """B=3 slots, T=5 window positions, blocks of 16. Each slot's blocks
    are distinct pool blocks; its table entries past its last block name
    garbage blocks (large finite values, so a read the mask does not hide
    shows; NaN would poison the twins' masked sums too). The windows cross
    block boundaries. Returns numpy operands and the positions."""
    rng = np.random.default_rng(seed)
    b, t, bs, mb = 3, 5, 16, 6
    q_heads, kv_heads = heads
    starts = [0, 14, 61]                    # first window position per slot
    need = [-(-(s + t) // bs) for s in starts]
    n_garbage = 3
    n_blocks = sum(need) + n_garbage
    perm = rng.permutation(sum(need))
    table = np.zeros((b, mb), dtype=np.int32)
    used = 0
    for i, nb in enumerate(need):
        table[i, :nb] = perm[used:used + nb]
        table[i, nb:] = rng.integers(sum(need), n_blocks, mb - nb)
        used += nb
    positions = (np.array(starts)[:, None] + np.arange(t)[None]).astype(
        np.int32)
    q = rng.standard_normal((b, t, q_heads, head_dim), dtype=np.float32)
    shape = (n_blocks, bs, kv_heads, head_dim)
    if quant:
        k = rng.integers(-127, 128, shape).astype(np.int8)
        v = rng.integers(-127, 128, shape).astype(np.int8)
        ks = rng.uniform(0.001, 0.02, shape[:-1]).astype(np.float32)
        vs = rng.uniform(0.001, 0.02, shape[:-1]).astype(np.float32)
        k[sum(need):] = 127
        v[sum(need):] = 127
        ks[sum(need):] = 40.0
        vs[sum(need):] = 40.0
        scales = (ks, vs)
    else:
        k = rng.standard_normal(shape, dtype=np.float32)
        v = rng.standard_normal(shape, dtype=np.float32)
        k[sum(need):] = 300.0
        v[sum(need):] = 300.0
        scales = ()
    return dict(q=q, k=k, v=v, table=table, positions=positions,
                scales=scales, dtype=dtype)


def _as_jax(c):
    jdt = jnp.bfloat16 if c["dtype"] == torch.bfloat16 else jnp.float32
    q = jnp.asarray(c["q"]).astype(jdt)
    if c["scales"]:
        k, v = jnp.asarray(c["k"]), jnp.asarray(c["v"])
    else:
        k, v = (jnp.asarray(c[n]).astype(jdt) for n in ("k", "v"))
    return (q, k, v, jnp.asarray(c["table"]), jnp.asarray(c["positions"]),
            *(jnp.asarray(s) for s in c["scales"]))


def _as_torch(c):
    dt = c["dtype"]
    q = torch.from_numpy(c["q"]).to(dt)
    if c["scales"]:
        k, v = torch.from_numpy(c["k"]), torch.from_numpy(c["v"])
    else:
        k, v = (torch.from_numpy(c[n]).to(dt) for n in ("k", "v"))
    return (q, k, v, torch.from_numpy(c["table"]),
            torch.from_numpy(c["positions"]),
            *(torch.from_numpy(s) for s in c["scales"]))


def _close(got: torch.Tensor, want: np.ndarray, dtype) -> None:
    """f32: within 2e-5 (summation order only). bf16: within one bf16 ulp
    of the reference's rounded result (2^-7 relative) plus 1e-5: both
    compute in f32 and round once, so only a rounding boundary can part
    them."""
    got = got.float().numpy()
    want = np.asarray(want, dtype=np.float32)
    assert np.isfinite(got).all()
    if dtype == torch.bfloat16:
        assert (np.abs(got - want) <= 2.0 ** -7 * np.abs(want) + 1e-5).all()
    else:
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


VERIFY_CASES = [(d, quant, dt) for d in (64, 128, 256)
                for quant in (False, True)
                for dt in (torch.float32, torch.bfloat16)]


@pytest.mark.parametrize("head_dim,quant,dtype", VERIFY_CASES)
def test_verify_twin_and_card_route_match_jax(head_dim, quant, dtype):
    c = _verify_case(head_dim, quant, dtype, seed=head_dim + int(quant))
    want = np.asarray(jax_verify(*_as_jax(c)).astype(jnp.float32))
    args = _as_torch(c)
    q, k, v, table, positions, *scales = args
    twin = at.xla_paged_verify_attention(q, k, v, table, positions, *scales)
    assert twin.shape == q.shape and twin.dtype == q.dtype
    _close(twin, want, dtype)
    # the engine's entry on a CPU tensor is the twin
    assert torch.equal(at.paged_verify_attention(*args), twin)
    # the card route: B*T one-token decodes through B1's / B2's wrappers,
    # which on a CPU tensor compute their plain twins and count nothing
    before = pa.launch_counts()
    route = at.verify_as_decode(*args)
    assert pa.launch_counts() == before
    assert route.shape == q.shape and route.dtype == q.dtype
    _close(route, want, dtype)
    # and the route agrees with the twin itself, to f32 summation order
    # (bf16: one rounding boundary)
    _close(route, twin.float().numpy(), dtype)


@pytest.mark.parametrize("heads,head_dim", [((32, 8), 128), ((16, 16), 256),
                                            ((8, 1), 256), ((4, 2), 64)])
@pytest.mark.parametrize("quant", [False, True])
def test_card_route_operands_are_ones_the_decode_kernels_take(heads,
                                                              head_dim,
                                                              quant):
    """The flattened operands of a bf16 verify window (B=8, T=9) at the
    served models' heads pass ``kernel_supports``, so on the card the route
    launches B1/B2 instead of raising, and they are laid out as the launch
    needs: contiguous rows, an int32 table repeated per row, int32
    lengths."""
    b, t, bs, mb = 8, 9, 128, 17
    q = torch.zeros((b, t, heads[0], head_dim), dtype=torch.bfloat16)
    dt = torch.int8 if quant else torch.bfloat16
    pool = torch.zeros((4, bs, heads[1], head_dim), dtype=dt)
    scale = torch.zeros((4, bs, heads[1])) if quant else None
    rows = q.reshape(b * t, 1, heads[0], head_dim)
    assert rows.data_ptr() == q.data_ptr() and rows.is_contiguous()
    assert pa.kernel_supports(rows, pool, scale) == ""
    table = torch.arange(b * mb, dtype=torch.int32).reshape(b, mb)
    rep = table.repeat_interleave(t, dim=0)
    assert rep.dtype == torch.int32 and rep.is_contiguous()
    assert torch.equal(rep[::t], table) and torch.equal(rep[t - 1::t], table)
    positions = torch.arange(t, dtype=torch.int32)[None] + torch.tensor(
        [[0], [5], [100], [1000], [127], [128], [2000], [40]],
        dtype=torch.int32)
    clen = (positions + 1).reshape(-1).to(torch.int32)
    assert clen.dtype == torch.int32 and clen[0] == 1 and clen[-1] == 49
    # the split plan reads only shapes: one plan for every row
    assert pa.split_plan(b * t, heads[1], mb, bs) == pa.split_plan(
        rows.shape[0], heads[1], rep.shape[1], bs)


def test_verify_route_needs_a_cuda_or_cpu_tensor():
    c = _verify_case(64, False, torch.float32, seed=3)
    q, *rest = _as_torch(c)
    with pytest.raises(ValueError, match="no paged verify path"):
        at.paged_verify_attention(q.to("meta"), *rest)


# -- the engine: a mirror of tests/test_spec_decode.py ---------------------------

@pytest.fixture(scope="module")
def weights():
    jparams = jax_init_decoder(jax.random.PRNGKey(0), JCFG)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              "cpu")
    return jparams, tparams


def _ecfg(spec_len=8, paged=False, max_batch=2, eos_id=-1, **kw) -> dict:
    base = dict(max_batch=max_batch, max_seq_len=512,
                prefill_buckets=(32, 64), decode_steps=(1, 4, 8),
                spec_len=spec_len, eos_id=eos_id)
    if paged:
        base.update(kv_block_size=32, kv_pool_blocks=0, prefill_chunk=32)
    base.update(kw)
    return base


def _engine(tparams, **kw) -> InferenceEngine:
    return InferenceEngine(tparams, TCFG, EngineConfig(**_ecfg(**kw)),
                           device="cpu")


def _generate(engine, prompts, max_new):
    """Every request is queued before the serve loop starts, so both
    engines admit all of them before their first window."""
    async def go():
        tasks = [asyncio.create_task(
            engine.generate(list(p), max_new_tokens=max_new))
            for p in prompts]
        await asyncio.sleep(0)
        await engine.start()
        try:
            return await asyncio.gather(*tasks)
        finally:
            await engine.stop()

    return asyncio.run(go())


def _engaged(stats: dict) -> None:
    # parity is vacuous if speculation never engaged
    assert stats["spec_windows"] > 0 and stats["spec_accepted"] > 0, stats


PROMPTS = [CYCLER, list(range(2, 40))]


def test_greedy_parity_dense(weights):
    _, tp = weights
    classic = _generate(_engine(tp, spec_len=0), PROMPTS, 200)
    eng = _engine(tp, spec_len=8)
    assert _generate(eng, PROMPTS, 200) == classic
    _engaged(eng.stats())


def test_greedy_parity_paged(weights):
    _, tp = weights
    classic = _generate(_engine(tp, spec_len=0, paged=True), PROMPTS, 200)
    dense_classic = _generate(_engine(tp, spec_len=0), PROMPTS, 200)
    eng = _engine(tp, spec_len=8, paged=True)
    # the same stream three ways: dense classic, paged classic, paged spec
    assert _generate(eng, PROMPTS, 200) == classic == dense_classic
    _engaged(eng.stats())


@pytest.mark.parametrize("kv_quant", ["", "int8"])
def test_greedy_parity_paged_quantized(weights, kv_quant):
    """int8 weights, with and without the int8 pool: decode and verify
    quantize their KV writes with the same per-vector math, so spec on
    equals spec off exactly."""
    jp, _ = weights
    qp = params_from_jax(jax.tree_util.tree_map(
        np.asarray, jax_quantize_decoder(jp)), "cpu")
    classic = _generate(_engine(qp, spec_len=0, paged=True,
                                kv_quant=kv_quant), PROMPTS, 200)
    eng = _engine(qp, spec_len=8, paged=True, kv_quant=kv_quant)
    assert _generate(eng, PROMPTS, 200) == classic
    _engaged(eng.stats())


def test_eos_inside_accepted_run(weights):
    """A token the trajectory first emits late, once speculation runs,
    made EOS: a verify window accepts a run holding it and delivery stops
    there."""
    _, tp = weights
    ref = _generate(_engine(tp, spec_len=0), [CYCLER], 200)[0]
    eos = max(set(ref), key=ref.index)
    stop_at = ref.index(eos)
    assert stop_at > 60, (eos, stop_at)
    classic = _generate(_engine(tp, spec_len=0, eos_id=eos), [CYCLER],
                        200)[0]
    eng = _engine(tp, spec_len=8, eos_id=eos)
    got = _generate(eng, [CYCLER], 200)[0]
    assert got == classic == ref[:stop_at + 1]
    assert got[-1] == eos
    assert eng.stats()["spec_windows"] > 0
    # the engine is idle again: slot freed, length reset
    assert not eng.active.any()
    assert int(eng._host_len.sum()) == 0


def test_cancel_during_spec_window(weights):
    _, tp = weights
    eng = _engine(tp, spec_len=8)

    async def go():
        await eng.start()
        req = await eng.generate(list(CYCLER), max_new_tokens=400,
                                 stream=True)
        got = []
        while len(got) < 40:            # well into speculative territory
            tok = await req.queue.get()
            assert tok is not None
            got.append(tok)
        assert eng.stats()["spec_windows"] > 0
        eng.cancel_request(req)
        while await req.queue.get() is not None:
            pass
        await req.done.wait()
        for _ in range(50):             # the loop notices at the next sync
            if not eng.active.any():
                break
            await asyncio.sleep(0.02)
        assert not eng.active.any()
        assert eng.slot_req[0] is None and eng._spec_slots[0] is None
        await eng.stop()
        return got

    got = asyncio.run(go())
    assert len(got) >= 40


def test_ewma_auto_disable_gate(weights):
    _, tp = weights

    def occupied(**kw):
        eng = _engine(tp, spec_len=8, **kw)
        req = _Request(request_id="r", prompt=list(CYCLER),
                       max_new_tokens=64)
        eng.slot_req[0] = req
        eng.active[0] = True
        eng._spec_slots[0] = spec.make_slot_state(req.prompt)
        return eng

    eng = occupied(spec_probe_every=0)
    st = eng._spec_slots[0]
    assert eng.scheduler.spec_gate(8) == 8          # optimistic start
    for _ in range(8):
        st.observe(8, 0)                           # drafts keep failing
    assert st.ewma < eng.ecfg.spec_min_accept
    assert eng.scheduler.spec_gate(8) == 0          # auto-disabled
    # probes force one verify window per spec_probe_every classic windows
    eng2 = occupied(spec_probe_every=3)
    for _ in range(8):
        eng2._spec_slots[0].observe(8, 0)
    assert [eng2.scheduler.spec_gate(8) for _ in range(6)] == [0, 0, 8, 0,
                                                               0, 8]
    # recovery without probes: matching drafts observed (shadow scoring)
    for _ in range(8):
        st.observe(8, 8)
    assert eng.scheduler.spec_gate(8) == 8
    # a slot with nothing to propose counts 0, whatever its EWMA
    eng._spec_slots[0] = spec.make_slot_state([1, 2, 3])
    assert eng.scheduler.spec_gate(8) == 0


def test_spec_room_len(weights):
    _, tp = weights
    eng = _engine(tp, spec_len=8)
    assert eng.scheduler.spec_room_len() == 0          # nothing active
    req = _Request(request_id="r", prompt=list(CYCLER), max_new_tokens=64)
    eng.slot_req[0] = req
    eng.active[0] = True
    eng._host_len[0] = 100
    assert eng.scheduler.spec_room_len() == 8
    eng._host_len[0] = 512 - 1 - 8                      # no room for 9
    assert eng.scheduler.spec_room_len() == 0
    eng._host_len[0] = 100
    req.generated = [0] * 63                            # one token left
    assert eng.scheduler.spec_room_len() == 0
    assert _engine(tp, spec_len=0).scheduler.spec_room_len() == 0


def test_shadow_scoring_recovers_ewma(weights):
    """A stream that turns repetitive mid-flight re-enables speculation
    with no probe windows: classic windows grade shadow drafts."""
    _, tp = weights
    eng = _engine(tp, spec_len=8, spec_probe_every=0)
    out = _generate(eng, [CYCLER], 300)[0]
    assert len(out) == 300
    _engaged(eng.stats())


def test_adversarial_prompt_mostly_classic(weights):
    """Random prompts leave nothing for prompt lookup: the gate keeps
    verify passes to a small share of the decode work."""
    _, tp = weights
    rng = random.Random(11)
    prompts = [[rng.randrange(1, 500) for _ in range(40)] for _ in range(2)]
    eng = _engine(tp, spec_len=8)
    outs = _generate(eng, prompts, 96)
    assert all(len(o) == 96 for o in outs)
    st = eng.stats()
    assert st["spec_windows"] * (eng.ecfg.spec_len + 1) <= st["decode_steps"]


def _brute_propose(tokens, k, max_n=3, min_n=2):
    end = len(tokens)
    for n in range(max_n, min_n - 1, -1):
        if end < n:
            continue
        suffix = tokens[end - n:end]
        pos = None
        for start in range(end - n - 1, -1, -1):   # latest prior occurrence
            if tokens[start:start + n] == suffix:
                pos = start + n
                break
        if pos is None:
            continue
        draft = tokens[pos:pos + k]
        period = end - pos
        while len(draft) < k:
            draft.append(draft[len(draft) - period])
        return draft
    return []


def test_proposer_matches_brute_force():
    rng = random.Random(1994)
    for trial in range(60):
        vocab = rng.choice([3, 6, 20])
        toks = [rng.randrange(vocab) for _ in range(rng.randrange(4, 120))]
        p = spec.NGramProposer(toks)
        for k in (1, 4, 8):
            got = p.propose(k)
            assert got == _brute_propose(list(toks), k), (trial, toks, k)
            assert len(got) in (0, k)


def test_proposer_incremental_equals_bulk():
    rng = random.Random(7)
    toks = [rng.randrange(5) for _ in range(200)]
    bulk = spec.NGramProposer(list(toks))
    inc = spec.NGramProposer([])
    for t in toks:
        inc.append(t)
    for k in (2, 8):
        assert bulk.propose(k) == inc.propose(k)


def test_proposer_cycle_extrapolation():
    p = spec.NGramProposer([1, 2, 3, 1, 2, 3, 1, 2, 3])
    assert p.propose(6) == [1, 2, 3, 1, 2, 3]
    assert spec.NGramProposer([9] * 10).propose(4) == [9, 9, 9, 9]


def test_build_drafts_padding_and_counts():
    states = [spec.SlotSpecState(proposer=spec.NGramProposer(
        [1, 2, 3, 1, 2, 3])), None,
        spec.SlotSpecState(proposer=spec.NGramProposer([4, 5, 6]))]
    drafts, n_real = spec.build_drafts(states, np.array([True] * 3), 4)
    assert drafts.shape == (3, 4)
    assert n_real.tolist() == [4, 0, 0]
    assert drafts[1].tolist() == [0, 0, 0, 0]
    _, n_real2 = spec.build_drafts(states, np.array([False, True, True]), 4)
    assert n_real2.tolist() == [0, 0, 0]


# -- the port's spec-on engine against the JAX spec-on engine --------------------

def _fork_report(weights, got, want, jeng, teng) -> str:
    """Where two streams part: for each request, the first differing step,
    the top two logits of a plain no-cache forward of each package over
    the common prefix (their margin says whether the step is a tie within
    f32 rounding), the windows (kind, tokens a slot) of both engines, and
    the thread counts."""
    from tpu9.models.transformer import decoder_forward as jax_forward
    from tpu9_torch.models.transformer import decoder_forward
    jp, tp = weights
    lines = [f"torch threads {torch.get_num_threads()}, interop "
             f"{torch.get_num_interop_threads()}"]
    for r, (prompt, g, w) in enumerate(zip(PROMPTS, got, want)):
        if g == w:
            continue
        i = next((i for i, (a, b) in enumerate(zip(g, w)) if a != b),
                 min(len(g), len(w)))
        seq = np.array([list(prompt) + list(w[:i])], dtype=np.int32)
        jl = np.asarray(jax_forward(jp, jnp.asarray(seq), JCFG))[0, -1]
        with torch.no_grad():
            tl = decoder_forward(tp, torch.from_numpy(seq).long(),
                                 TCFG)[0, -1].numpy()
        top = [(int(k), float(v[k])) for v in (jl, tl)
               for k in np.argsort(v)[-2:][::-1]]
        lines.append(f"request {r}: step {i}, tokens {g[i:i + 1]} against "
                     f"{w[i:i + 1]}; top-2 (id, logit) jax {top[:2]}, "
                     f"torch {top[2:]}")
    for name, eng in (("jax", jeng), ("torch", teng)):
        lines.append(f"{name} windows: " + str(
            [(f["kind"], f.get("tokens")) for f in eng.flight_records()]))
    return "\n".join(lines)


CROSS = {"dense": dict(), "paged": dict(paged=True),
         "paged-int8-pool": dict(paged=True, kv_quant="int8")}


@pytest.mark.usefixtures("jax_table_copies")
@pytest.mark.parametrize("mode", list(CROSS))
def test_spec_streams_and_counters_equal_the_jax_engine(weights, mode):
    """Both engines admit both requests before their first window, so the
    same tokens make the same proposals, EWMAs and window choices: streams
    and spec counters equal, and each stream equals spec off."""
    jp, tp = weights
    kw = CROSS[mode]
    jeng = JaxEngine(jp, JCFG, JaxEngineConfig(**_ecfg(**kw)))
    teng = _engine(tp, **kw)
    want = _generate(jeng, PROMPTS, 120)
    got = _generate(teng, PROMPTS, 120)
    assert got == want, _fork_report(weights, got, want, jeng, teng)
    off = _generate(_engine(tp, **dict(kw, spec_len=0)), PROMPTS, 120)
    assert got == off, _fork_report(weights, got, off, jeng, teng)
    js, ts = jeng.stats(), teng.stats()
    for key in ("spec_windows", "spec_proposed", "spec_accepted",
                "spec_acceptance_rate", "spec_enabled", "decode_steps",
                "tokens_generated"):
        assert ts[key] == js[key], key
    _engaged(ts)
    jv = [(r["spec_proposed"], r["spec_accepted"], r["tokens"])
          for r in jeng.flight_records() if r["kind"] == "verify"]
    tv = [(r["spec_proposed"], r["spec_accepted"], r["tokens"])
          for r in teng.flight_records() if r["kind"] == "verify"]
    assert tv == jv and len(tv) == ts["spec_windows"]
