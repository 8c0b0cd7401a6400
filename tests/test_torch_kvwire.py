"""kvwire in the port (``tpu9_torch/serving/kvwire.py``, the pool's
export/import and the engine's ``export_*``/``adopt_kv``) against the JAX
package, on the CPU.

The reference's cells of ``tests/test_kvwire.py`` (all but the tp=2
re-shard ones), run on the port: roundtrips judged byte for byte (bf16 and
int8 with scales), the version-gated reader refusing before any pool
mutation, the export pin against a concurrent eviction, and the shipped-KV
resume's greedy parity at f32 on llama-tiny.

Across the packages: the port's ``encode_blocks``/``decode_header``/
``decode_blocks`` give the reference's bytes and error texts on the same
planes; a payload one package's pool exports adopts into the other's and
re-exports to the same bytes (bf16 and int8 pools, head_dim 32 and 256);
a payload the JAX engine exports after a real prefill serves the same
greedy tokens from the torch engine, and back; the greedy resume after
``export_request_kv`` of an in-flight stream equals the uninterrupted
stream; the dense engine exports nothing and counts an adopt as a
fallback, as the JAX one does.
"""

import asyncio
import dataclasses
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu9.models import init_decoder as jax_init_decoder
from tpu9.models.llama import LLAMA_PRESETS as JAX_PRESETS
from tpu9.serving import kvwire as jkvwire
from tpu9.serving.engine import EngineConfig as JaxEngineConfig
from tpu9.serving.engine import InferenceEngine as JaxEngine
from tpu9.serving.kvpool import KvPool as JaxKvPool
from tpu9.serving.shard import make_policy
from tpu9_torch.bridge import params_from_jax
from tpu9_torch.models.llama import LLAMA_PRESETS
from tpu9_torch.serving import kvwire
from tpu9_torch.serving.engine import EngineConfig, InferenceEngine
from tpu9_torch.serving.kvpool import KvPool
from tpu9_torch.serving.paged_kv import BlockAllocator, PrefixCache

torch.set_num_threads(2)

JTINY = JAX_PRESETS["llama-tiny"]
TTINY = LLAMA_PRESETS["llama-tiny"]
BS = 32
CPU = torch.device("cpu")


def _ecfg_kw(**kw) -> dict:
    base = dict(max_batch=2, max_seq_len=256, prefill_buckets=(32, 64),
                decode_steps=(1, 4), kv_block_size=BS, kv_pool_blocks=16,
                prefill_chunk=32, prefix_cache_blocks=8)
    base.update(kw)
    return base


def _pool(kv_quant=False, cfg=TTINY, **kw):
    pool = KvPool(cfg, EngineConfig(**_ecfg_kw(**kw)), CPU, kv_quant)
    return pool, pool.init_arrays()


def _jpool(kv_quant=False, cfg=JTINY, **kw):
    pool = JaxKvPool(cfg, JaxEngineConfig(**_ecfg_kw(**kw)), kv_quant,
                     make_policy(None))
    return pool, pool.init_arrays()


def _values(pool, kv, n_blocks: int, seed: int) -> dict:
    """Deterministic non-trivial content for ``n_blocks`` blocks of every
    wire plane, drawn as the reference's ``_fill`` draws it: the full int8
    range, or normal floats (rounded to the pool dtype on the way in)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name in pool.wire_names():
        shape = tuple(kv[name].shape)
        sub = (shape[0], n_blocks) + shape[2:]
        if kv[name].dtype in (torch.int8, jnp.int8):
            out[name] = rng.integers(-127, 128, size=sub, dtype=np.int8)
        else:
            out[name] = rng.standard_normal(sub).astype(np.float32)
    return out


def _fill(pool, kv, blocks, seed=0):
    """Write ``_values`` into ``blocks`` of the port's pool, in place."""
    idx = torch.tensor(blocks, dtype=torch.int64)
    for name, vals in _values(pool, kv, len(blocks), seed).items():
        kv[name].index_copy_(1, idx, torch.from_numpy(vals).to(kv[name].dtype))


def _jfill(pool, kv, blocks, seed=0):
    """The same values into the JAX pool; returns the rebound pool."""
    idx = jnp.asarray(blocks, dtype=jnp.int32)
    new = dict(kv)
    for name, vals in _values(pool, kv, len(blocks), seed).items():
        new[name] = new[name].at[:, idx].set(
            jnp.asarray(vals, dtype=new[name].dtype))
    return new


def _export(pool, kv, blocks, tokens):
    return pool.export_blocks(kv, blocks, PrefixCache._key(tokens),
                              len(tokens))


def _reexport(pool, kv, tokens):
    """Serialize the adopted prefix again, from the importing pool."""
    entry = pool.prefix_cache.acquire_for_export(tokens)
    assert entry is not None and entry.n_tokens == len(tokens)
    try:
        return pool.export_blocks(kv, entry.blocks, entry.key,
                                  entry.n_tokens)
    finally:
        pool.prefix_cache.release_pin(entry)


def _ptrs(kv) -> dict:
    return {name: t.data_ptr() for name, t in kv.items()}


def _as_torch(arr: np.ndarray) -> torch.Tensor:
    """A reference plane (numpy, bf16 from ml_dtypes) as a torch tensor
    with the same bits."""
    if arr.dtype == jnp.bfloat16:
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr.copy())


# -- the reference's cells, on the port -----------------------------------------

@pytest.mark.parametrize("kv_quant", [False, True],
                         ids=["bf16", "int8+scales"])
def test_roundtrip_bit_exact(kv_quant):
    """export → import → re-export reproduces the payload byte for byte
    (header included), and the decoded planes match the source pool's
    blocks bitwise, payload and scale planes alike; the import writes the
    importing pool in place."""
    pool_a, kv_a = _pool(kv_quant)
    blocks = pool_a.alloc_blocks(3)
    _fill(pool_a, kv_a, blocks)
    tokens = [(i * 7) % 211 + 1 for i in range(3 * BS)]
    payload = _export(pool_a, kv_a, blocks, tokens)

    header, planes = kvwire.decode_blocks(payload)
    assert header["n_blocks"] == 3 and header["n_tokens"] == len(tokens)
    if kv_quant:
        assert set(planes) == {"k", "v", "k_scale", "v_scale"}
        assert planes["k_scale"].dtype == torch.float32
    for name in pool_a.wire_names():
        assert torch.equal(planes[name],
                           kv_a[name][:, torch.tensor(blocks)]), name

    pool_b, kv_b = _pool(kv_quant)
    before = _ptrs(kv_b)
    adopted, _ = pool_b.import_blocks(kv_b, payload)
    assert adopted
    assert _ptrs(kv_b) == before
    assert pool_b.prefix_cache.stats()["adopted"] == 1
    assert _reexport(pool_b, kv_b, tokens) == payload


def test_import_is_noop_hit_when_prefix_already_cached():
    pool_a, kv_a = _pool()
    blocks = pool_a.alloc_blocks(2)
    _fill(pool_a, kv_a, blocks)
    tokens = list(range(1, 2 * BS + 1))
    payload = _export(pool_a, kv_a, blocks, tokens)
    pool_b, kv_b = _pool()
    adopted, _ = pool_b.import_blocks(kv_b, payload)
    assert adopted
    used = pool_b.allocator.used_count
    snap = {n: t.clone() for n, t in kv_b.items()}
    adopted2, _ = pool_b.import_blocks(kv_b, payload)
    assert adopted2                               # raced a local prefill:
    assert pool_b.allocator.used_count == used    # zero pool work
    assert all(torch.equal(kv_b[n], snap[n]) for n in snap)


def test_import_over_budget_releases_blocks():
    """An adopt that cannot fit the prefix budget hands every block back
    (the caller falls back to re-prefill)."""
    pool_a, kv_a = _pool()
    blocks = pool_a.alloc_blocks(4)
    _fill(pool_a, kv_a, blocks)
    tokens = list(range(2, 4 * BS + 2))
    payload = _export(pool_a, kv_a, blocks, tokens)
    pool_b, kv_b = _pool(prefix_cache_blocks=2)
    adopted, _ = pool_b.import_blocks(kv_b, payload)
    assert not adopted
    assert pool_b.allocator.used_count == 1     # just the trash block


def _payload():
    pool, kv = _pool()
    blocks = pool.alloc_blocks(2)
    _fill(pool, kv, blocks)
    return _export(pool, kv, blocks, list(range(1, 2 * BS + 1)))


def test_unknown_version_refused_with_clear_error():
    data = bytearray(_payload())
    struct.pack_into("<H", data, 7, kvwire.FORMAT_VERSION + 1)
    with pytest.raises(kvwire.KvWireError, match="unsupported format "
                       "version 2"):
        kvwire.decode_header(bytes(data))
    # the pool path fails identically, and touches nothing
    pool, kv = _pool()
    with pytest.raises(kvwire.KvWireError, match="version"):
        pool.import_blocks(kv, bytes(data))
    assert pool.allocator.used_count == 1       # just the trash block
    assert pool.prefix_cache.stats()["adopted"] == 0


def test_bad_magic_and_truncation_refused():
    data = _payload()
    with pytest.raises(kvwire.KvWireError, match="bad magic"):
        kvwire.decode_header(b"NOTKV\x00\x00" + data[7:])
    with pytest.raises(kvwire.KvWireError, match="truncated"):
        kvwire.decode_header(data[:5])
    with pytest.raises(kvwire.KvWireError, match="truncated"):
        kvwire.decode_blocks(data[:-16])
    with pytest.raises(kvwire.KvWireError, match="truncated"):
        kvwire.decode_header(data[:kvwire._PRELUDE.size + 4])


def test_geometry_mismatch_reads_like_a_diff():
    payload = _payload()
    pool16, kv16 = _pool(kv_block_size=16, prefill_buckets=(16, 32),
                         prefill_chunk=16)
    with pytest.raises(kvwire.KvWireError, match="kv_block_size"):
        pool16.import_blocks(kv16, payload)
    pool_q, kv_q = _pool(kv_quant=True)
    with pytest.raises(kvwire.KvWireError, match="kv_dtype"):
        pool_q.import_blocks(kv_q, payload)
    assert pool_q.allocator.used_count == 1


def test_export_pin_blocks_concurrent_eviction():
    """An admission running dry calls evict_for_space while an export
    holds the entry pinned mid-gather: the entry and its blocks are
    untouchable until the pin is released."""
    a = BlockAllocator(8, 4)
    pc = PrefixCache(a, max_blocks=4)
    blocks = a.alloc(3)
    tokens = list(range(12))
    pc.insert(tokens, blocks)
    a.release(blocks)                   # only the cache holds them now
    entry = pc.acquire_for_export(tokens)
    assert entry is not None and entry.blocks == blocks
    pc.evict_for_space(6)               # the concurrent evictor runs dry
    assert pc.contains(entry.key)
    assert a.used_count == 3            # blocks NOT recycled mid-gather
    pc.release_pin(entry)
    pc.evict_for_space(6)
    assert not pc.contains(entry.key)   # unpinned → ordinary LRU victim
    assert a.used_count == 0


def test_acquire_for_export_does_not_skew_admission_signals():
    a = BlockAllocator(8, 4)
    pc = PrefixCache(a, max_blocks=4)
    blocks = a.alloc(2)
    pc.insert(list(range(8)), blocks)
    a.release(blocks)
    before = (pc.hits, pc.misses, pc.tokens_reused)
    entry = pc.acquire_for_export(list(range(8)))
    pc.release_pin(entry)
    assert pc.acquire_for_export([99] * 8) is None
    assert (pc.hits, pc.misses, pc.tokens_reused) == before


@pytest.fixture(scope="module")
def tiny_f32():
    jcfg = dataclasses.replace(JTINY, dtype=jnp.float32)
    tcfg = dataclasses.replace(TTINY, dtype=torch.float32)
    jparams = jax_init_decoder(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              "cpu")
    return jcfg, jparams, tcfg, tparams


def _engine(tiny, **kw):
    _, _, tcfg, tparams = tiny
    return InferenceEngine(tparams, tcfg, EngineConfig(**_ecfg_kw(**kw)),
                           device="cpu")


def _jengine(tiny, **kw):
    jcfg, jparams, _, _ = tiny
    return JaxEngine(jparams, jcfg, JaxEngineConfig(**_ecfg_kw(**kw)))


def _generate(engine, prompt, max_new):
    async def go():
        await engine.start()
        try:
            return await engine.generate(list(prompt), max_new_tokens=max_new)
        finally:
            await engine.stop()

    return asyncio.run(go())


def test_shipped_kv_resume_greedy_parity(tiny_f32):
    """The failover/drain resume at the engine layer: a victim generates
    part way, its prefix KV ships to a survivor by export → adopt, and the
    survivor's continuation equals the uninterrupted stream exactly."""
    prompt = [(i * 5) % 200 + 1 for i in range(80)]     # 2 full blocks
    ref = _generate(_engine(tiny_f32), prompt, 10)

    victim = _engine(tiny_f32)
    delivered = _generate(victim, prompt, 4)            # dies at wm=4
    payload = victim.export_prefix_kv(prompt)
    assert payload is not None
    assert victim.stats()["kvwire_exports"] == 1

    survivor = _engine(tiny_f32)
    assert survivor.adopt_kv(payload)
    rest = _generate(survivor, prompt + delivered, 10 - len(delivered))
    assert delivered + rest == ref

    st = survivor.stats()
    assert st["kvwire_import_hits"] == 1
    assert st["kvwire_blocks_imported"] == 2
    assert survivor.prefix_cache.stats()["adopted"] == 1
    # the adopt really fed admission: the resume hit the shipped prefix
    assert survivor.prefix_cache.stats()["hits"] >= 1


def test_adopt_kv_rejects_malformed_before_any_mutation(tiny_f32):
    eng = _engine(tiny_f32)
    with pytest.raises(kvwire.KvWireError):
        eng.adopt_kv(b"garbage")
    assert eng.stats()["kvwire_import_hits"] == 0
    assert eng.allocator.used_count == 1


def test_export_miss_counts_and_returns_none(tiny_f32):
    eng = _engine(tiny_f32)
    assert eng.export_prefix_kv(list(range(64))) is None
    assert eng.stats()["kvwire_export_misses"] == 1


# -- across the packages ----------------------------------------------------------

def _corruptions(data: bytes) -> dict:
    """Broken payloads that each fail a different gate of the reader."""
    hlen = struct.unpack_from("<I", data, 9)[0]
    off = kvwire._PRELUDE.size

    def with_header(mutate) -> bytes:
        import json
        header = json.loads(data[off:off + hlen])
        mutate(header)
        raw = json.dumps(header, sort_keys=True).encode()
        return (kvwire._PRELUDE.pack(kvwire.MAGIC, 1, len(raw)) + raw
                + data[off + hlen:])

    def plane(field, value):
        def mutate(h):
            h["planes"][0][field] = value
        return mutate

    return {
        "short-prelude": data[:5],
        "bad-magic": b"NOTKV\x00\x00" + data[7:],
        "version": data[:7] + struct.pack("<H", 9) + data[9:],
        "short-header": data[:off + 4],
        "bad-json": data[:off] + b"{" * hlen + data[off + hlen:],
        "not-a-dict": with_header(lambda h: h.update(planes=None)),
        "short-plane": data[:-16],
        "bad-dtype": with_header(plane("dtype", "complex64")),
        "no-nbytes": with_header(lambda h: h["planes"][0].pop("nbytes")),
        "bad-shape": with_header(plane("shape", [3, 5])),
    }


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
def test_encode_and_decode_match_the_reference(kv_quant):
    """On the same planes the port's encoder writes the reference's bytes,
    both readers return the same header and planes, and every broken
    payload fails in both with the same error text."""
    jpool, jkv = _jpool(kv_quant)
    blocks = jpool.alloc_blocks(2)
    jkv = _jfill(jpool, jkv, blocks, seed=5)
    idx = np.asarray(blocks)
    planes = {n: np.asarray(jkv[n])[:, idx] for n in jpool.wire_names()}
    meta = jkvwire.geometry(JTINY, jpool.ecfg, kv_quant)
    meta.update(n_blocks=2, n_tokens=2 * BS, prefix_key="ab" * 20,
                topology={"tp": 1, "fsdp": 1, "n_chips": 1})
    want = jkvwire.encode_blocks(meta, planes)
    tmeta = kvwire.geometry(TTINY, EngineConfig(**_ecfg_kw()), kv_quant)
    assert tmeta == jkvwire.geometry(JTINY, jpool.ecfg, kv_quant)
    tmeta.update(n_blocks=2, n_tokens=2 * BS, prefix_key="ab" * 20,
                 topology={"tp": 1, "fsdp": 1, "n_chips": 1})
    got = kvwire.encode_blocks(tmeta, {n: _as_torch(a)
                                       for n, a in planes.items()})
    assert got == want
    assert kvwire.decode_header(got) == jkvwire.decode_header(want)
    header, tplanes = kvwire.decode_blocks(got)
    jheader, jplanes = jkvwire.decode_blocks(want)
    assert header == jheader and list(tplanes) == list(jplanes)
    for name in jplanes:
        assert torch.equal(tplanes[name], _as_torch(jplanes[name])), name
    for label, bad in _corruptions(want).items():
        with pytest.raises(jkvwire.KvWireError) as jerr:
            jkvwire.decode_blocks(bad)
        with pytest.raises(kvwire.KvWireError) as terr:
            kvwire.decode_blocks(bad)
        assert str(terr.value) == str(jerr.value), label


POOLS = {"bf16": (False, 32), "int8": (True, 32), "bf16-d256": (False, 256),
         "int8-d256": (True, 256)}


@pytest.mark.parametrize("pool", list(POOLS))
@pytest.mark.parametrize("direction", ["jax-to-torch", "torch-to-jax"])
def test_payload_crosses_packages_byte_for_byte(pool, direction):
    """A payload one package's pool exports adopts into the other's pool
    and re-exports to the same bytes; the adopting pool holds the source
    blocks' values bit for bit."""
    kv_quant, head_dim = POOLS[pool]
    jcfg = dataclasses.replace(JTINY, head_dim=head_dim)
    tcfg = dataclasses.replace(TTINY, head_dim=head_dim)
    jpool, jkv = _jpool(kv_quant, cfg=jcfg)
    tpool, tkv = _pool(kv_quant, cfg=tcfg)
    tokens = [(i * 13) % 197 + 3 for i in range(3 * BS)]
    key = PrefixCache._key(tokens)
    if direction == "jax-to-torch":
        jblocks = jpool.alloc_blocks(3)
        jkv = _jfill(jpool, jkv, jblocks, seed=7)
        payload = _export(jpool, jkv, jblocks, tokens)
        adopted, _ = tpool.import_blocks(tkv, payload)
        assert adopted
        back = _reexport(tpool, tkv, tokens)
        tblocks = tpool.prefix_cache._entries[key].blocks
    else:
        tblocks = tpool.alloc_blocks(3)
        _fill(tpool, tkv, tblocks, seed=7)
        payload = _export(tpool, tkv, tblocks, tokens)
        jkv, adopted, _ = jpool.import_blocks(jkv, payload)
        assert adopted
        back = _reexport(jpool, jkv, tokens)
        jblocks = jpool.prefix_cache._entries[key].blocks
    assert back == payload
    # the adopted blocks hold the source values bit for bit
    for name in tpool.wire_names():
        want = np.asarray(jkv[name])[:, np.asarray(jblocks)]
        got = tkv[name][:, torch.tensor(tblocks)]
        assert torch.equal(got, _as_torch(want)), name


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
def test_engine_payloads_serve_across_packages(tiny_f32, kv_quant):
    """A payload the JAX engine exports after a real prefill serves the
    same greedy tokens from the torch engine (an import hit, a prefix hit)
    and re-exports to the same bytes; and a torch export adopts into the
    JAX engine the same way. f32 weights; the int8 pool quantizes."""
    prompt = [(i * 11) % 300 + 2 for i in range(80)]
    kw = {"kv_quant": "int8"} if kv_quant else {}
    for src_fn, dst_fn in ((_jengine, _engine), (_engine, _jengine)):
        src = src_fn(tiny_f32, **kw)
        want = _generate(src, prompt, 8)
        payload = src.export_prefix_kv(prompt)
        assert payload is not None
        dst = dst_fn(tiny_f32, **kw)
        assert dst.adopt_kv(payload)
        assert dst.export_prefix_kv(prompt) == payload
        assert _generate(dst, prompt, 8) == want
        st = dst.stats()
        assert st["kvwire_import_hits"] == 1
        assert st["prefix_cache"]["hits"] == 1


def test_export_request_kv_resume_greedy_parity(tiny_f32):
    """The drain export of a stream in flight: its full-block prefix
    (prompt + tokens delivered so far) ships, a survivor adopts it and
    continues from prompt + delivered, and the two halves equal the
    uninterrupted stream. The JAX engine's drain export of the same
    stream at the same point is the same payload."""
    prompt = [(i * 3) % 250 + 1 for i in range(90)]
    ref = _generate(_engine(tiny_f32), prompt, 16)

    async def drain(engine, n_before):
        await engine.start()
        try:
            req = await engine.generate(prompt, max_new_tokens=16,
                                        request_id="drained", stream=True)
            got = [await req.queue.get() for _ in range(n_before)]
            payload = engine.export_request_kv("drained")
            assert engine.export_request_kv("nobody") is None
            engine.cancel_request(req)
            return got, payload, list(req.generated)
        finally:
            await engine.stop()

    got, payload, generated = asyncio.run(drain(_engine(tiny_f32), 7))
    assert got == ref[:7]
    header, _ = kvwire.decode_header(payload)
    delivered = ref[:len(generated)]
    assert generated == delivered
    assert header["n_tokens"] == (len(prompt) + len(delivered)) // BS * BS
    survivor = _engine(tiny_f32)
    assert survivor.adopt_kv(payload)
    rest = _generate(survivor, prompt + delivered, 16 - len(delivered))
    assert delivered + rest == ref
    assert survivor.stats()["prefix_cache"]["hits"] == 1


def test_dense_engine_exports_nothing_and_counts_adopt_fallbacks(tiny_f32):
    prompt = list(range(1, 70))
    payload = _engine(tiny_f32)
    _generate(payload, prompt, 2)
    payload = payload.export_prefix_kv(prompt)
    dense_kw = dict(kv_block_size=0, kv_pool_blocks=0, prefill_chunk=0,
                    prefix_cache_blocks=0, prefill_buckets=(32, 128))
    for eng in (_engine(tiny_f32, **dense_kw), _jengine(tiny_f32, **dense_kw)):
        assert eng.export_prefix_kv(prompt) is None
        assert eng.export_request_kv("r0") is None
        assert eng.adopt_kv(payload) is False
        eng.note_kvwire_fallback()
        assert eng.stats()["kvwire_import_fallbacks"] == 2
