"""The port's runner zygote (``python -m tpu9_torch.runner.zygote``) driven by
the reference's unchanged client, ``tpu9.runtime.zygote_client.ZygoteClient
.spawn``: the mirror of ``tests/test_zygote.py`` (env, cwd, stdio and exit
code; children isolated from each other; the orphan of a client that
disconnects killed; a child running torch), then the port's own cases: no
JAX and no CUDA in the zygote, ``--preload``, a child's own thread count
and visible devices, and a forked child serving llama-tiny with the JAX
engine's greedy tokens. Each test has its own time limit."""

import asyncio
import dataclasses
import json
import os
import select
import signal
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu9.models import init_decoder as jax_init_decoder
from tpu9.models.llama import LLAMA_PRESETS as JAX_PRESETS
from tpu9.runtime.zygote_client import ZygoteClient
from tpu9.serving.engine import EngineConfig as JaxEngineConfig
from tpu9.serving.engine import InferenceEngine as JaxEngine

ROOT = Path(__file__).resolve().parents[1]
LIMIT_S = 120.0


def _start(tmp_path, *extra):
    """A port zygote on ``tmp_path/zy.sock``: (process, socket path, its
    warm-up line)."""
    sock = str(tmp_path / "zy.sock")
    env = {k: v for k in ("PATH", "HOME", "LANG")
           if (v := os.environ.get(k)) is not None}
    env.update(PYTHONPATH=str(ROOT), PYTHONUNBUFFERED="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpu9_torch.runner.zygote", "--sock", sock,
         *extra], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        start_new_session=True)

    def line(stream) -> str:
        ready, _, _ = select.select([stream], [], [], LIMIT_S)
        assert ready, "the zygote said nothing in time"
        return stream.readline().decode()

    try:
        assert line(proc.stdout) == "zygote: ready\n"
        warm = ""
        while "zygote: warm" not in warm:
            warm = line(proc.stderr)
    except BaseException:
        _stop(proc)
        raise
    return proc, sock, warm


def _stop(proc) -> None:
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    proc.wait(timeout=30)


@pytest.fixture
def zygote(tmp_path):
    proc, sock, warm = _start(tmp_path)
    yield sock, warm
    _stop(proc)


async def _pump_all(reader: asyncio.StreamReader) -> str:
    out = []
    while True:
        line = await reader.readline()
        if not line:
            break
        out.append(line.decode())
    return "".join(out)


async def _run(sock, env, cwd, module, limit=LIMIT_S):
    """Spawn ``module`` through the reference client: (stdout, stderr,
    exit code) within ``limit`` seconds."""
    proc = await ZygoteClient(sock).spawn(env, str(cwd), module)
    assert proc.pid > 0
    return await asyncio.wait_for(asyncio.gather(
        _pump_all(proc.stdout), _pump_all(proc.stderr), proc.wait()), limit)


def _module(tmp_path, name: str, src: str) -> Path:
    mods = tmp_path / "mods"
    mods.mkdir(exist_ok=True)
    (mods / f"{name}.py").write_text(textwrap.dedent(src))
    return mods


def _env(mods, **extra) -> dict:
    return {"PYTHONPATH": str(mods), "PATH": os.environ.get("PATH", ""),
            **extra}


async def test_spawn_env_cwd_stdio_and_exit(zygote, tmp_path):
    sock, _ = zygote
    mods = _module(tmp_path, "fakerunner", """
        import os, sys
        print('env=' + os.environ.get('TPU9_MARK', ''))
        print('cwd=' + os.getcwd())
        sys.stderr.write('err-stream\\n')
        sys.exit(7)
        """)
    wd = tmp_path / "wd"
    wd.mkdir()
    out, err, code = await _run(sock, _env(mods, TPU9_MARK="forked"), wd,
                                "fakerunner")
    assert "env=forked" in out
    assert f"cwd={wd}" in out
    assert "err-stream" in err
    assert code == 7


async def test_children_are_isolated(zygote, tmp_path):
    """Two forks share no env mutation and no module global."""
    sock, _ = zygote
    mods = _module(tmp_path, "mutator", """
        import os
        import tpu9_torch.serving.engine as e
        prev = getattr(e, 'ZYGOTE_TAINT', None)
        e.ZYGOTE_TAINT = os.environ['WHO']
        print(f"who={os.environ['WHO']} prev={prev}")
        """)
    out1, _, code1 = await _run(sock, _env(mods, WHO="a"), tmp_path,
                                "mutator")
    out2, _, code2 = await _run(sock, _env(mods, WHO="b"), tmp_path,
                                "mutator")
    assert (code1, code2) == (0, 0)
    assert "who=a prev=None" in out1
    assert "who=b prev=None" in out2


async def test_orphan_is_killed_when_the_client_disconnects(zygote,
                                                            tmp_path):
    sock, _ = zygote
    mods = _module(tmp_path, "sleeper", "import time\ntime.sleep(600)\n")
    stdout_r, stdout_w = os.pipe()
    stderr_r, stderr_w = os.pipe()
    payload = json.dumps({"env": _env(mods), "cwd": str(tmp_path),
                          "module": "sleeper", "argv": []}).encode() + b"\n"

    def handshake():
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.settimeout(30.0)
        s.connect(sock)
        socket.send_fds(s, [payload], [stdout_w, stderr_w])
        line = s.makefile("rb").readline()
        return s, json.loads(line)["pid"]

    s, pid = await asyncio.wait_for(asyncio.to_thread(handshake), LIMIT_S)
    for fd in (stdout_w, stderr_w):
        os.close(fd)
    os.kill(pid, 0)                      # the child is alive
    s.close()                            # the worker dies mid-spawn
    for _ in range(100):
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            break
        await asyncio.sleep(0.1)
    else:
        pytest.fail("the orphan survived its client's disconnect")
    os.close(stdout_r)
    os.close(stderr_r)


async def test_child_runs_a_multithreaded_torch_matmul(zygote, tmp_path):
    """The zygote started no intra-op pool, so a child's first parallel
    op runs to completion (a pool inherited across fork would hang)."""
    sock, _ = zygote
    mods = _module(tmp_path, "matmuler", """
        import torch
        torch.set_num_threads(4)
        x = torch.ones(512, 512)
        y = float((x @ x).sum())
        print(f"y={y} threads={torch.get_num_threads()}")
        """)
    out, err, code = await _run(sock, _env(mods), tmp_path, "matmuler",
                                limit=60.0)
    assert code == 0, err
    assert f"y={512.0 ** 3}" in out and "threads=4" in out


async def test_zygote_holds_no_jax_and_no_cuda(zygote, tmp_path):
    sock, warm = zygote
    # the zygote's own report after warm-up: one Python thread, no CUDA
    assert "python threads ['MainThread']" in warm
    assert "cuda initialized False" in warm
    # a child starts from the zygote's memory: what it finds loaded at its
    # start the zygote had loaded
    mods = _module(tmp_path, "inspector", """
        import sys, torch
        bad = sorted(m for m in sys.modules
                     if m.split('.')[0] in ('jax', 'jaxlib', 'tpu9'))
        port = sorted(m for m in sys.modules if m.startswith('tpu9_torch'))
        print('bad=' + repr(bad))
        print('serving=' + str('tpu9_torch.serving.presets' in port))
        print('cuda=' + str(torch.cuda.is_initialized()))
        print('bad_fork=' + str(torch.cuda._is_in_bad_fork()))
        """)
    out, err, code = await _run(sock, _env(mods), tmp_path, "inspector")
    assert code == 0, err
    assert "bad=[]" in out and "serving=True" in out
    assert "cuda=False" in out and "bad_fork=False" in out


async def test_preload_imports_a_caller_named_module(tmp_path):
    mods = _module(tmp_path, "ctlplane", "LOADED_BY = 'zygote'\n")
    env = dict(os.environ, PYTHONPATH=f"{ROOT}{os.pathsep}{mods}")
    sock = str(tmp_path / "zy.sock")
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpu9_torch.runner.zygote", "--sock", sock,
         "--preload", "ctlplane", "--preload", "no_such_module_here"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        start_new_session=True)
    try:
        ready, _, _ = select.select([proc.stdout], [], [], LIMIT_S)
        assert ready and proc.stdout.readline() == b"zygote: ready\n"
        probe = _module(tmp_path, "probe", """
            import sys
            print('preloaded=' + str('ctlplane' in sys.modules))
            """)
        # the probe's env does not name ctlplane's directory: only the
        # zygote's import can have loaded it
        out, err, code = await _run(sock, _env(probe), tmp_path, "probe")
        assert code == 0, err
        assert "preloaded=True" in out
        # a failed preload is reported and skipped
        ready, _, _ = select.select([proc.stderr], [], [], LIMIT_S)
        assert ready
        assert b"preload no_such_module_here failed" in \
            proc.stderr.readline()
    finally:
        _stop(proc)


async def test_child_threads_and_devices_are_its_own(zygote, tmp_path):
    sock, _ = zygote
    mods = _module(tmp_path, "envprobe", """
        import os, torch
        print('threads=' + str(torch.get_num_threads()))
        print('visible=' + os.environ.get('CUDA_VISIBLE_DEVICES', '-'))
        print('alloc=' + os.environ.get('PYTORCH_CUDA_ALLOC_CONF', '-'))
        print('cuda=' + str(torch.cuda.is_initialized()))
        """)
    outs = []
    for threads, visible in (("3", "1"), ("2", "0,1")):
        out, err, code = await _run(
            sock, _env(mods, OMP_NUM_THREADS=threads,
                       CUDA_VISIBLE_DEVICES=visible,
                       PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True"),
            tmp_path, "envprobe")
        assert code == 0, err
        outs.append(out)
    assert "threads=3" in outs[0] and "visible=1" in outs[0]
    assert "threads=2" in outs[1] and "visible=0,1" in outs[1]
    # CUDA is still to be initialised, so it reads the child's variables
    assert all("cuda=False" in o and "alloc=expandable_segments:True" in o
               for o in outs)


ENGINE = dict(max_batch=4, max_seq_len=128, prefill_buckets=(16, 64),
              decode_steps=(1, 4), kv_block_size=16, prefill_chunk=16,
              prefix_cache_blocks=16, admit_group_chunks=2)
PROMPTS = [list(range(3, 40)), [7, 11, 13] * 7]


async def test_forked_child_serves_the_jax_engines_tokens(zygote, tmp_path,
                                                          monkeypatch):
    """llama-tiny at f32, paged, the JAX weights carried over by
    ``params_from_jax``: a forked child's greedy tokens equal the JAX
    engine's."""
    from tpu9.serving.shard.policy import SingleDevicePolicy
    # the JAX engine's table handed over as a copy at each push
    # (tests/test_torch_engine.py's jax_table_copies)
    monkeypatch.setattr(
        SingleDevicePolicy, "device_table",
        lambda policy, table: jnp.asarray(np.array(table, copy=True)))
    sock, _ = zygote
    jcfg = dataclasses.replace(JAX_PRESETS["llama-tiny"], dtype=jnp.float32)
    jparams = jax_init_decoder(jax.random.PRNGKey(0), jcfg)
    flat = {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                jparams)[0]}
    np.savez(tmp_path / "weights.npz", **flat)
    jeng = JaxEngine(jparams, jcfg, JaxEngineConfig(**ENGINE))
    await jeng.start()
    try:
        want = [await jeng.generate(p, max_new_tokens=8) for p in PROMPTS]
    finally:
        await jeng.stop()

    mods = _module(tmp_path, "tinyserve", f"""
        import asyncio, dataclasses, json, sys
        import numpy as np, torch
        from tpu9_torch.bridge import params_from_jax
        from tpu9_torch.models.llama import LLAMA_PRESETS
        from tpu9_torch.serving.engine import EngineConfig, InferenceEngine

        def nest(flat):
            tree = {{}}
            for path, arr in flat.items():
                *head, last = path.split('/')
                node = tree
                for k in head:
                    node = node.setdefault(k, {{}})
                node[last] = arr
            tree['layers'] = [tree['layers'][str(i)]
                              for i in range(len(tree['layers']))]
            return tree

        with np.load({str(tmp_path / 'weights.npz')!r}) as z:
            params = params_from_jax(nest(dict(z)), 'cpu')
        cfg = dataclasses.replace(LLAMA_PRESETS['llama-tiny'],
                                  dtype=torch.float32)
        engine = InferenceEngine(params, cfg, EngineConfig(**{ENGINE!r}),
                                 device='cpu')

        async def main():
            await engine.start()
            try:
                return [await engine.generate(p, max_new_tokens=8)
                        for p in {PROMPTS!r}]
            finally:
                await engine.stop()

        print('tokens=' + json.dumps(asyncio.run(main())))
        """)
    out, err, code = await _run(sock, _env(mods, OMP_NUM_THREADS="2"),
                                tmp_path, "tinyserve")
    assert code == 0, err
    got = json.loads(out.split("tokens=", 1)[1])
    assert got == want
    assert all(len(t) == 8 for t in got)
