"""The port's checkpoint layer against the JAX package's, on the CPU.

- ``tpu9_torch.serving.weights`` against ``tpu9.serving.weights``: a mirror
  of the format tests of ``tests/test_weightstream.py``; the same tree
  saved by both packages gives byte-identical ``.tpu9w`` directories
  (llama-tiny bf16 as v1, llama-tiny quantized at save time as v2,
  gemma-tiny's tied tree, a tree with tuples); each package reads the
  other's directory back bit for bit, mapped or read; ``check_index``'s
  error texts and the format's refusals are the reference's;
- ``tpu9_torch.worker.weightstream.stream_shards`` against the reference's
  on the same chunk streams, results and errors; the unchanged reference
  worker's ``restore_params`` with the port's consumer;
- ``tpu9_torch.runner.ckpt``: init-and-save then restore, save-time int8,
  a bad mode failing before any write, and the ``torch.save`` fallback for
  trees the format cannot represent;
- an engine over a restored tree serves the in-memory tree's greedy
  stream, and an engine refuses a leaf that is not on its device.

Every comparison is exact: the format moves bytes.
"""

import asyncio
import dataclasses
import os
import typing
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from tpu9.cache import CacheClient, DiskStore
from tpu9.cache.store import chunk_hash
from tpu9.models import init_decoder as jax_init_decoder
from tpu9.models.gemma import GEMMA_PRESETS as JAX_GEMMA
from tpu9.models.llama import LLAMA_PRESETS as JAX_LLAMA
from tpu9.serving import weights as jw
from tpu9.worker.checkpoint import CheckpointManager
from tpu9.worker.weightpool import WeightPool
from tpu9.worker.weightstream import stream_shards as jax_stream_shards
from tpu9_torch.bridge import params_from_jax
from tpu9_torch.models.llama import LLAMA_PRESETS
from tpu9_torch.runner import ckpt
from tpu9_torch.serving import weights as tw
from tpu9_torch.serving.engine import EngineConfig, InferenceEngine
from tpu9_torch.worker import weightstream as tws

torch.set_num_threads(2)


def _np(leaf) -> np.ndarray:
    """A leaf of either package as numpy, bf16 as its 16-bit words."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.uint16).numpy()
        return leaf.numpy()
    arr = np.asarray(leaf)
    return arr.view(np.uint16) if arr.dtype.name == "bfloat16" else arr


def _assert_same(a, b):
    """Trees equal bit for bit, with the same containers (tuples stay
    tuples) and dtype names."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b)
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    elif isinstance(a, (torch.Tensor, np.ndarray, np.generic)) \
            or hasattr(a, "shape"):
        x, y = _np(a), _np(b)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)
    else:
        assert a == b and type(a) is type(b)


def _read_dir(path: str) -> dict:
    out = {}
    for name in sorted(os.listdir(path)):
        with open(os.path.join(path, name), "rb") as f:
            out[name] = f.read()
    return out


# -- the format: a mirror of tests/test_weightstream.py ---------------------------

def _tree():
    gen = torch.Generator().manual_seed(7)
    return {"embed": torch.randn((32, 16), generator=gen),
            "layers": [{"w": torch.randn((16, 16), generator=gen),
                        "scale": torch.tensor(0.5)} for _ in range(3)],
            "step": 42, "name": "m", "flag": True, "none": None}


def test_weights_roundtrip(tmp_path):
    tree = _tree()
    dest = str(tmp_path / "m.tpu9w")
    index = tw.save_params(tree, dest)
    assert index["format"] == tw.FORMAT and index["version"] == 1
    assert tw.is_weights_dir(dest)
    _assert_same(tree, tw.load_params(dest))
    # a mapped load pages shards lazily but reads identical values
    _assert_same(tree, tw.load_params(dest, mmap=True))


def test_weights_scalars_ride_the_index(tmp_path):
    dest = str(tmp_path / "s.tpu9w")
    index = tw.save_params({"lr": 0.1, "steps": 10, "w": torch.ones(4)}, dest)
    assert len(index["leaves"]) == 1           # only the tensor is a shard
    back = tw.load_params(dest)
    assert back["lr"] == 0.1 and back["steps"] == 10


def test_weight_group_recognition():
    for path in ("ck/params.tpu9w/000000.bin", "ck/params.tpu9w/index.json",
                 "ck/code/app.py", "ck/params.tpu9w", "a.tpu9w/b.tpu9w/x"):
        assert tw.weight_group_of(path) == jw.weight_group_of(path), path
    assert tw.weight_group_of("ck/params.tpu9w/000000.bin") \
        == "ck/params.tpu9w"
    assert tw.weight_group_of("ck/params.tpu9w") is None


def test_manifest_groups_and_content_key_match_the_reference():
    def e(path, chunks=("c1",), link=""):
        return SimpleNamespace(path=path, chunks=list(chunks),
                               link_target=link)

    manifest = SimpleNamespace(files=[
        e("a/p.tpu9w/index.json"), e("a/p.tpu9w/000000.bin", ("x", "y")),
        e("a/q.tpu9w/000000.bin"),                         # no index
        e("a/r.tpu9w/index.json"), e("a/r.tpu9w/l", link="/etc"),
        e("app.py")])
    got, want = tw.manifest_weight_groups(manifest), \
        jw.manifest_weight_groups(manifest)
    assert list(got) == list(want) == ["a/p.tpu9w"]
    assert tw.content_key(got["a/p.tpu9w"]) \
        == jw.content_key(want["a/p.tpu9w"])
    # NUL framing: a path ending in a digest is not a shorter path + chunk
    assert tw.content_key([e("ab", ("c",))]) \
        != tw.content_key([e("a", ("bc",))])


# -- byte identity with the JAX package ---------------------------------------------

def _jax_tree(name: str):
    jcfg = {**JAX_LLAMA, **JAX_GEMMA}[name]
    return jax.tree_util.tree_map(
        np.asarray, jax_init_decoder(jax.random.PRNGKey(3), jcfg))


TREES = {"llama-tiny": ("llama-tiny", None, 1),
         "llama-tiny-int8": ("llama-tiny", "int8", 2),
         "gemma-tiny": ("gemma-tiny", None, 1)}


@pytest.fixture(scope="module", params=list(TREES))
def saved(request, tmp_path_factory):
    """The same tree saved by each package: (jax dir, port dir, jax tree,
    version)."""
    name, quantize, version = TREES[request.param]
    jtree = _jax_tree(name)
    root = tmp_path_factory.mktemp(request.param)
    jdir, tdir = str(root / "jax.tpu9w"), str(root / "torch.tpu9w")
    jindex = jw.save_params(jtree, jdir, quantize=quantize)
    tindex = tw.save_params(params_from_jax(jtree, "cpu"), tdir,
                            quantize=quantize)
    assert jindex == tindex
    return jdir, tdir, jtree, version


def test_the_directories_are_byte_identical(saved):
    jdir, tdir, _, version = saved
    jfiles, tfiles = _read_dir(jdir), _read_dir(tdir)
    assert list(jfiles) == list(tfiles)
    for name in jfiles:
        assert jfiles[name] == tfiles[name], name
    index = tw.read_index(tdir)
    assert index["version"] == version
    assert index.get("quantized", False) == (version == 2)
    if version == 2:
        roles = {e["role"] for e in index["leaves"] if "role" in e}
        assert roles == {"q", "scale"}


@pytest.mark.parametrize("mmap", [False, True], ids=["read", "mmap"])
def test_each_package_reads_the_others_directory(saved, mmap):
    jdir, tdir, _, _ = saved
    # the port reads the JAX directory as the JAX package does, and back
    _assert_same(jw.load_params(jdir, mmap=mmap), tw.load_params(jdir,
                                                                 mmap=mmap))
    _assert_same(tw.load_params(tdir, mmap=mmap), jw.load_params(tdir,
                                                                 mmap=mmap))


def test_gemma_tree_is_tied():
    index = tw.build_index(params_from_jax(_jax_tree("gemma-tiny"),
                                           "cpu"))[0]
    assert not any(e["key"].startswith("lm_head") for e in index["leaves"])


def test_tuples_and_scalars_are_byte_identical_and_come_back(tmp_path):
    rng = np.random.default_rng(11)
    jtree = {"pair": (rng.standard_normal((3, 5)).astype(np.float32),
                      rng.integers(-9, 9, 7).astype(np.int32)),
             "nested": [(np.ones(2, ml_dtypes.bfloat16), 3, (1.5, None))],
             "int8": {"q": rng.integers(-127, 128, (4, 2)).astype(np.int8),
                      "scale": rng.random((1, 2)).astype(np.float32)}}
    ttree = {"pair": (torch.from_numpy(jtree["pair"][0]),
                      torch.from_numpy(jtree["pair"][1])),
             "nested": [(torch.ones(2, dtype=torch.bfloat16), 3,
                         (1.5, None))],
             "int8": {k: torch.from_numpy(v)
                      for k, v in jtree["int8"].items()}}
    jw.save_params(jtree, str(tmp_path / "j.tpu9w"))
    tw.save_params(ttree, str(tmp_path / "t.tpu9w"))
    assert _read_dir(str(tmp_path / "j.tpu9w")) \
        == _read_dir(str(tmp_path / "t.tpu9w"))
    back = tw.load_params(str(tmp_path / "j.tpu9w"))
    _assert_same(ttree, back)
    assert isinstance(back["nested"][0][2], tuple)
    assert tw.read_index(str(tmp_path / "t.tpu9w"))["version"] == 2


@pytest.mark.parametrize("index", [
    {"format": "other"}, {"version": 1},
    {"format": tw.FORMAT, "version": 3},
    {"format": tw.FORMAT, "version": "2"}])
@pytest.mark.parametrize("src", ["", "/ck/p.tpu9w"])
def test_check_index_errors_are_the_references(index, src):
    with pytest.raises(ValueError) as ours:
        tw.check_index(index, src)
    with pytest.raises(ValueError) as ref:
        jw.check_index(index, src)
    assert str(ours.value) == str(ref.value)
    assert tw.check_index({"format": tw.FORMAT}) == 1


class Pair(typing.NamedTuple):
    a: object
    b: object


def _unrepresentable():
    """(name, the JAX tree, the port's tree) for each refusal."""
    w = np.ones((2, 2), np.float32)
    t = torch.ones((2, 2))
    return [("namedtuple", {"p": Pair(w, 1)}, {"p": Pair(t, 1)}),
            ("int-key", {"layers": {0: w}}, {"layers": {0: t}}),
            ("marker-key", {"__leaf__": w}, {"__leaf__": t}),
            ("object-leaf", {"x": [object()]}, {"x": [object()]})]


@pytest.mark.parametrize("case", range(4))
def test_refusals_are_the_references(tmp_path, case):
    _, jtree, ttree = _unrepresentable()[case]
    with pytest.raises(TypeError) as ours:
        tw.save_params(ttree, str(tmp_path / "t.tpu9w"))
    with pytest.raises(TypeError) as ref:
        jw.save_params(jtree, str(tmp_path / "j.tpu9w"))
    assert str(ours.value) == str(ref.value)


# -- stream_shards against the reference --------------------------------------------

def _arrays():
    rng = np.random.default_rng(0)
    return [rng.standard_normal(1024).astype(np.float32),
            rng.integers(-127, 128, (33, 7)).astype(np.int8),
            np.ones(0, np.float32),
            rng.standard_normal((5, 3)).astype(ml_dtypes.bfloat16)]


def _entries(arrays):
    return [{"i": i, "key": f"k{i}", "file": f"{i:06d}.bin",
             "dtype": a.dtype.name, "shape": list(a.shape),
             "nbytes": int(a.nbytes)} for i, a in enumerate(arrays)]


async def _chunks_of(arrays, chunk=1000):
    for a in arrays:
        raw = a.tobytes()
        for off in range(0, len(raw), chunk):
            part = raw[off:off + chunk]
            yield chunk_hash(part), part


@pytest.mark.parametrize("put", ["keep", "device-put"])
async def test_stream_shards_match_the_reference(put):
    """A consumer that keeps what it is handed (each shard lands in a
    fresh buffer, so what it kept stays intact), and the port's device
    put, which copies."""
    arrays = _arrays() + _arrays()[::-1]
    put = tws.make_device_put("cpu") if put == "device-put" else (
        lambda e, a: a)
    got, st = await tws.stream_shards(_entries(arrays), _chunks_of(arrays),
                                      consume=put)
    want, jst = await jax_stream_shards(_entries(arrays), _chunks_of(arrays),
                                        consume=lambda e, a: a.copy())
    for g, w in zip(got, want):
        _assert_same(w, g)
    assert set(st) == set(jst)
    for key in ("bytes", "shards"):
        assert st[key] == jst[key]
    assert st["fetch_first_mono"] <= st["fetch_last_mono"]
    assert st["put_first_mono"] <= st["put_last_mono"] <= st["end_mono"]


def _bad_streams():
    """(name, entries, chunk stream factory): a truncated stream, a missing
    chunk, a chunk that overflows its shard."""
    arrays = [np.ones(256, np.float32)]
    long = _entries(arrays)
    long[0]["nbytes"] *= 2

    async def missing():
        yield "deadbeef", None

    async def overflow():
        yield "a", b"\0" * 1000
        yield "b", b"\0" * 100

    return {"truncated": (long, lambda: _chunks_of(arrays)),
            "missing": (_entries(arrays), missing),
            "overflow": (_entries(arrays), overflow)}


@pytest.mark.parametrize("case", ["truncated", "missing", "overflow"])
async def test_stream_shards_errors_are_the_references(case):
    entries, stream = _bad_streams()[case]
    with pytest.raises(IOError) as ours:
        await tws.stream_shards(entries, stream(), consume=lambda e, a: a)
    with pytest.raises(IOError) as ref:
        await jax_stream_shards(entries, stream(), consume=lambda e, a: a)
    assert str(ours.value) == str(ref.value)


def test_consumer_takes_the_reference_workers_arrays():
    """The reference worker hands numpy arrays, bf16 as ml_dtypes."""
    put = tws.make_device_put("cpu")
    for arr in _arrays():
        entry = _entries([arr])[0]
        out = put(entry, arr)
        assert tw.dtype_name(out) == entry["dtype"]
        np.testing.assert_array_equal(_np(out), _np(arr))
        # the shard's memory is not shared with the result
        assert arr.size == 0 or out.data_ptr() != \
            tw.from_numpy(arr).data_ptr()


def test_default_device_put_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is that device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tws.default_device_put(*_entries([np.ones(2, np.float32)]),
                               np.ones(2, np.float32))


# -- the reference worker's direct-to-device restore with the port's consumer ----


class _Ckpts:
    def __init__(self):
        self.manifests = {}

    async def record(self, stub, ws, cid):
        return f"ck-{len(self.manifests)}"

    async def store(self, cid, blob):
        self.manifests[cid] = blob

    async def fetch(self, cid):
        return self.manifests.get(cid)


async def _no_peers():
    return []


async def test_reference_worker_restores_through_the_ports_consumer(tmp_path):
    src = str(tmp_path / "src")
    os.makedirs(src)
    tree = params_from_jax(_jax_tree("llama-tiny"), "cpu")
    tw.save_params(tree, os.path.join(src, "params.tpu9w"))
    with open(os.path.join(src, "app.py"), "w") as f:
        f.write("print('hi')\n")
    pool = WeightPool(1 << 30)
    client = CacheClient(DiskStore(str(tmp_path / "cache")), peers=_no_peers)
    cks = _Ckpts()
    cm = CheckpointManager(client, record=cks.record, store_manifest=cks.store,
                           fetch_manifest=cks.fetch, weight_pool=pool)
    put = tws.make_device_put("cpu")
    try:
        ck = await cm.create("stub", "ws", "c0", src)
        trees, metrics = await cm.restore_params(ck, device_put=put)
        assert not metrics["warm_pool_hit"]
        assert set(trees) == {"params.tpu9w"}
        want = tw.load_params(os.path.join(src, "params.tpu9w"))
        _assert_same(want, trees["params.tpu9w"])
        _assert_same(tree, trees["params.tpu9w"])
        # the Nth replica: pooled host arrays go straight through the port
        trees2, metrics2 = await cm.restore_params(ck, device_put=put)
        assert metrics2["warm_pool_hit"]
        _assert_same(want, trees2["params.tpu9w"])
    finally:
        await client.close()


# -- ckpt: the runner's hooks ----------------------------------------------------


@pytest.fixture
def workdir(tmp_path, monkeypatch):
    monkeypatch.setenv("TPU9_WORKDIR", str(tmp_path))
    monkeypatch.setenv("TPU9_CHECKPOINT_ENABLED", "1")
    monkeypatch.delenv("TPU9_CKPT_QUANT", raising=False)
    return tmp_path


def _torch_tiny():
    return params_from_jax(_jax_tree("llama-tiny"), "cpu")


def test_maybe_restore_inits_and_saves_then_restores(workdir):
    calls = []

    def init():
        calls.append(1)
        return _torch_tiny()

    first = ckpt.maybe_restore(init, device="cpu")
    assert calls == [1] and not ckpt.is_restored()
    path = os.path.join(ckpt.ckpt_dir(), "params" + tw.WEIGHTS_SUFFIX)
    assert tw.is_weights_dir(path)
    # the reference's runner marks readiness; the next boot restores
    ckpt.mark_ready({"handler": "app:load"})
    second = ckpt.maybe_restore(init, device="cpu")
    assert calls == [1]
    _assert_same(first, second)
    _assert_same(first, ckpt.load_params(device="cpu"))
    _assert_same(first, ckpt.load_params(mmap=True, device="cpu"))


@pytest.mark.parametrize("restored", [False, True], ids=["first", "restored"])
def test_boots_without_a_device_land_on_the_card(workdir, restored):
    """With no ``device`` argument the first boot and a restored one both
    hand back tensors on the current CUDA device, and raise without a
    card; ``init`` does not run before the device is known."""
    calls = []

    def init():
        calls.append(1)
        return {"w": torch.ones(4), "n": 3}

    if restored:
        ckpt.save_params(init())
        ckpt.mark_ready()
        calls.clear()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ckpt.maybe_restore(init)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ckpt.load_params()
        assert calls == []
        return
    params = ckpt.maybe_restore(init)
    assert params["w"].is_cuda and params["n"] == 3
    assert calls == ([] if restored else [1])


def test_maybe_restore_does_not_save_with_checkpointing_off(workdir,
                                                            monkeypatch):
    monkeypatch.delenv("TPU9_CHECKPOINT_ENABLED")
    ckpt.maybe_restore(lambda: {"w": torch.ones(2)}, device="cpu")
    assert os.listdir(ckpt.ckpt_dir()) == []


def test_env_quant_writes_v2_identical_to_the_reference(workdir,
                                                        monkeypatch):
    monkeypatch.setenv("TPU9_CKPT_QUANT", "int8")
    path = ckpt.save_params(_torch_tiny())
    index = tw.read_index(path)
    assert index["version"] == 2 and index["quantized"]
    ref = str(workdir / "ref.tpu9w")
    jw.save_params(_jax_tree("llama-tiny"), ref, quantize="int8")
    assert _read_dir(path) == _read_dir(ref)
    # a non-decoder tree still saves, unquantized
    side = tw.read_index(ckpt.save_params({"w": torch.ones(3)}, "side"))
    assert side["version"] == 1


@pytest.mark.parametrize("mode", ["fp4", "int4"])
def test_a_bad_quant_mode_raises_before_any_write(workdir, monkeypatch, mode):
    monkeypatch.setenv("TPU9_CKPT_QUANT", mode)
    with pytest.raises(ValueError, match="unknown quantize mode"):
        ckpt.save_params(_torch_tiny())
    assert os.listdir(ckpt.ckpt_dir()) == []


@pytest.mark.parametrize("case", range(4))
def test_unrepresentable_trees_fall_back_to_torch_save(workdir, case):
    """Plain trees (an int key, a marker key) save as ``.pt`` and load with
    ``weights_only=True``; a NamedTuple container or an object leaf, which
    the safe unpickler refuses, saves as ``.pickle``."""
    name, _, tree = _unrepresentable()[case]
    path = ckpt.save_params(tree, name)
    assert path.endswith(ckpt.PICKLE_SUFFIX if case in (0, 3)
                         else ckpt.FALLBACK_SUFFIX)
    assert not os.path.exists(os.path.join(ckpt.ckpt_dir(),
                                           name + tw.WEIGHTS_SUFFIX))
    if case not in (0, 3):
        _assert_same(tree, torch.load(path, weights_only=True))
    back = ckpt.load_params(name, device="cpu")
    if case == 3:                          # an object comes back an object
        assert type(back["x"][0]) is object
    else:
        _assert_same(tree, back)
    ckpt.mark_ready()
    assert type(ckpt.maybe_restore(lambda: None, name, device="cpu")) \
        is type(tree)


def test_a_failed_shard_read_raises(workdir):
    path = ckpt.save_params({"w": torch.ones(64)})
    with open(os.path.join(path, "000000.bin"), "r+b") as f:
        f.truncate(10)
    ckpt.mark_ready()
    with pytest.raises(IOError, match="10/256"):
        ckpt.maybe_restore(lambda: None, device="cpu")


# -- the engine over a restored tree ---------------------------------------------

TCFG = dataclasses.replace(LLAMA_PRESETS["llama-tiny"], dtype=torch.float32)
ECFG = EngineConfig(max_batch=2, max_seq_len=128, prefill_buckets=(16, 64),
                    decode_steps=(1, 4), kv_block_size=16, prefill_chunk=16)


def _greedy(params, prompt):
    engine = InferenceEngine(params, TCFG, ECFG, device="cpu")

    async def go():
        await engine.start()
        try:
            return await engine.generate(prompt, max_new_tokens=12)
        finally:
            await engine.stop()

    return asyncio.run(go())


@pytest.mark.parametrize("quantize", [None, "int8"], ids=["v1", "v2"])
def test_engine_serves_a_restored_tree_as_the_live_one(tmp_path, quantize):
    jcfg = dataclasses.replace(JAX_LLAMA["llama-tiny"], dtype=jnp.float32)
    live = params_from_jax(jax.tree_util.tree_map(
        np.asarray, jax_init_decoder(jax.random.PRNGKey(1), jcfg)), "cpu")
    if quantize:
        from tpu9_torch.ops.quant import quantize_decoder
        live = quantize_decoder(live)
    dest = str(tmp_path / "p.tpu9w")
    tw.save_params(live, dest)
    restored = tw.load_params(dest, mmap=True)
    prompt = [5, 3, 9, 14, 2, 7]
    assert _greedy(restored, prompt) == _greedy(live, prompt)


def test_engine_names_a_leaf_off_its_device():
    params = _torch_tiny()
    params["layers"][1]["wq"] = params["layers"][1]["wq"].to("meta")
    with pytest.raises(ValueError, match="layers/1/wq"):
        InferenceEngine(params, LLAMA_PRESETS["llama-tiny"], ECFG,
                        device="cpu")
