"""Pre-warmed runner template (fork-server) for the port (counterpart of
``tpu9/runner/zygote.py``).

One long-lived process per worker pays the expensive imports (torch,
numpy, the port's kernels' wrappers, decoder and serving stack, and any
control-plane module the caller names with ``--preload``) **without
initialising CUDA**, and forks a child per container. The child applies
the container's env, cwd and stdio, re-points what torch reads from the
environment at the env it just received, and runs the requested module,
skipping interpreter boot and imports.

Fork-safety contract (``tests/test_torch_zygote.py``):

- the zygote imports but never runs a torch computation and never asks
  CUDA anything (``torch.cuda.is_available()`` and ``device_count()``
  initialise CUDA, after which a forked child cannot use the card):
  no CUDA context, no intra-op or BLAS pool started by work; after
  warm-up only the main Python thread exists;
- each child initialises CUDA itself, after the fork, under its own
  ``CUDA_VISIBLE_DEVICES`` and ``PYTORCH_CUDA_ALLOC_CONF`` (both read
  when CUDA initialises), sets torch's intra-op threads from its own
  ``OMP_NUM_THREADS`` (the OpenMP runtime read the zygote's at import),
  and ``ops/_build.py`` reads its ``CUDA_HOME`` when it builds (a child
  loads a kernel library at its first launch; the zygote never runs
  ``nvcc``).

Protocol, byte for byte the reference's (SOCK_STREAM unix socket, one
connection per spawn):

  worker → zygote: JSON line {"env": {...}, "cwd": ..., "module": ...,
                    "argv": [...]} with [stdout_w, stderr_w] fds attached
                    via SCM_RIGHTS on the first byte
  zygote → worker: {"pid": N}\\n  ...then, when the child exits...
                   {"exit": code}\\n  (connection close = zygote died)

    python -m tpu9_torch.runner.zygote --sock PATH [--preload MODULE]...

(or ``TPU9_ZYGOTE_SOCK`` for the socket); it prints ``zygote: ready`` on
stdout once it listens.
"""

from __future__ import annotations

import argparse
import array
import json
import os
import selectors
import signal
import socket
import sys
import threading

PRELOADS = ("torch", "numpy",
            "tpu9_torch.ops.attention", "tpu9_torch.ops.paged_attention",
            "tpu9_torch.ops.quant", "tpu9_torch.ops.norms",
            "tpu9_torch.ops.rotary", "tpu9_torch.ops.sampling",
            "tpu9_torch.models.transformer", "tpu9_torch.serving.engine",
            "tpu9_torch.serving.presets", "tpu9_torch.serving.graphs")


def _warm_imports(extra=()) -> None:
    import importlib
    for mod in PRELOADS + tuple(extra):
        try:
            importlib.import_module(mod)
        except Exception as exc:      # noqa: BLE001 — degraded, not fatal
            print(f"zygote: preload {mod} failed: {exc}", file=sys.stderr)
    import torch
    threads = [t.name for t in threading.enumerate()]
    print(f"zygote: warm: python threads {threads}, cuda initialized "
          f"{torch.cuda.is_initialized()}", file=sys.stderr, flush=True)


def _repoint_torch(env: dict) -> None:
    """What torch read from the zygote's environment, re-read from the
    child's. CUDA reads ``CUDA_VISIBLE_DEVICES`` and
    ``PYTORCH_CUDA_ALLOC_CONF`` when it initialises, which only the child
    does, and ``CUDA_HOME`` is read at each build; the intra-op thread
    count was fixed at import."""
    if "torch" not in sys.modules:
        return
    import torch
    if torch.cuda.is_initialized():
        raise RuntimeError("the zygote initialised CUDA before the fork")
    threads = env.get("OMP_NUM_THREADS", "")
    if threads.isdigit() and int(threads) > 0:
        torch.set_num_threads(int(threads))


def _child_setup(req: dict, stdout_fd: int, stderr_fd: int) -> None:
    # a runner child dies on SIGTERM exactly like an exec'd runner would
    for sig in (signal.SIGTERM, signal.SIGINT, signal.SIGHUP):
        signal.signal(sig, signal.SIG_DFL)
    os.setsid()
    os.dup2(stdout_fd, 1)
    os.dup2(stderr_fd, 2)
    os.close(stdout_fd)
    os.close(stderr_fd)
    env = req.get("env", {})
    os.environ.clear()
    os.environ.update(env)
    cwd = req.get("cwd") or "/"
    os.chdir(cwd)
    # the interpreter is already up: PYTHONPATH in env is NOT re-read, so
    # mirror it into sys.path (front, order kept) for app imports
    for entry in reversed(env.get("PYTHONPATH", "").split(os.pathsep)):
        if entry and entry not in sys.path:
            sys.path.insert(0, entry)
    if cwd not in sys.path:
        sys.path.insert(0, cwd)
    _repoint_torch(env)
    sys.argv = [req.get("module", "")] + list(req.get("argv", []))


def _spawn(conn: socket.socket, req: dict, fds: list[int],
           inherited: list[socket.socket]) -> int:
    pid = os.fork()
    if pid != 0:
        for fd in fds:
            os.close(fd)
        return pid
    # ---- child ----
    try:
        # drop every inherited zygote fd: the listener and other children's
        # notify connections (a child holding a sibling's conn would keep
        # the worker from seeing EOF after a zygote crash)
        conn.close()
        for s in inherited:
            try:
                s.close()
            except OSError:
                pass
        _child_setup(req, fds[0], fds[1])
        module = req["module"]
        import importlib
        mod = importlib.import_module(module) \
            if module in sys.modules else None
        if mod is not None and hasattr(mod, "main"):
            # a preloaded runner: call its entry point (runpy would warn
            # about re-executing an imported module)
            mod.main()
        else:
            import runpy
            runpy.run_module(module, run_name="__main__", alter_sys=True)
        code = 0
    except SystemExit as exc:
        code = exc.code if isinstance(exc.code, int) else 0
    except BaseException:             # noqa: BLE001
        import traceback
        traceback.print_exc()
        code = 1
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)


def _recv_request(conn: socket.socket):
    """The first message carries the fds; read until newline for the
    JSON."""
    buf = bytearray()
    fds: list[int] = []
    while b"\n" not in buf:
        if not fds:
            msg, anc, _flags, _addr = conn.recvmsg(
                65536, socket.CMSG_LEN(2 * array.array("i").itemsize))
            for level, typ, data in anc:
                if level == socket.SOL_SOCKET and typ == socket.SCM_RIGHTS:
                    a = array.array("i")
                    a.frombytes(data[:len(data) - len(data) % a.itemsize])
                    fds.extend(a)
        else:
            msg = conn.recv(65536)
        if not msg:
            return None, fds
        buf.extend(msg)
    line = bytes(buf).split(b"\n", 1)[0]
    return json.loads(line), fds


def serve(sock_path: str, preload=()) -> None:
    _warm_imports(preload)
    try:
        os.unlink(sock_path)
    except OSError:
        pass
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    srv.bind(sock_path)
    srv.listen(64)
    srv.setblocking(False)
    print("zygote: ready", flush=True)

    sel = selectors.DefaultSelector()
    sel.register(srv, selectors.EVENT_READ, "accept")
    children: dict[int, socket.socket] = {}    # pid -> notify conn

    def close_conn(conn: socket.socket) -> None:
        try:
            sel.unregister(conn)
        except (KeyError, ValueError):
            pass
        try:
            conn.close()
        except OSError:
            pass

    def reap() -> None:
        while True:
            try:
                pid, status = os.waitpid(-1, os.WNOHANG)
            except ChildProcessError:
                return
            if pid == 0:
                return
            conn = children.pop(pid, None)
            if conn is not None:
                code = (os.WEXITSTATUS(status) if os.WIFEXITED(status)
                        else 128 + os.WTERMSIG(status))
                try:
                    conn.sendall(json.dumps({"exit": code}).encode() + b"\n")
                except OSError:
                    pass
                close_conn(conn)

    while True:
        events = sel.select(timeout=0.2)
        reap()
        for key, _mask in events:
            if key.data == "accept":
                try:
                    conn, _ = srv.accept()
                except OSError:
                    continue
                # bounded handshake: a half-open client must not wedge the
                # single-threaded fork-server
                conn.settimeout(10.0)
                try:
                    req, fds = _recv_request(conn)
                    conn.settimeout(None)
                except (OSError, ValueError):
                    conn.close()
                    continue
                if req is None or len(fds) < 2:
                    for fd in fds:
                        os.close(fd)
                    conn.close()
                    continue
                pid = _spawn(conn, req, fds,
                             [srv] + list(children.values()))
                children[pid] = conn
                # the protocol has no further client traffic, so the only
                # READ event on this conn is EOF: the worker died or gave up
                # on the spawn, and its child must not run on unsupervised
                sel.register(conn, selectors.EVENT_READ, ("client", pid))
                try:
                    conn.sendall(json.dumps({"pid": pid}).encode() + b"\n")
                except OSError:
                    pass
            else:
                _kind, pid = key.data
                conn = key.fileobj
                try:
                    data = conn.recv(4096)
                except OSError:
                    data = b""
                if data:
                    continue               # stray bytes: ignore, stay open
                if children.pop(pid, None) is not None:
                    # the child setsid()s at start (pgid == pid) and a
                    # runner may fork its own subprocesses: kill the group
                    try:
                        os.killpg(pid, signal.SIGKILL)
                    except ProcessLookupError:
                        # before its setsid: the lone pid
                        try:
                            os.kill(pid, signal.SIGKILL)
                        except ProcessLookupError:
                            pass
                close_conn(conn)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m tpu9_torch.runner.zygote")
    ap.add_argument("--sock", default=os.environ.get("TPU9_ZYGOTE_SOCK", ""))
    ap.add_argument("--preload", action="append", default=[],
                    help="also import this module before forking "
                         "(repeatable): the control plane's runner modules")
    args = ap.parse_args(argv)
    if not args.sock:
        print("usage: python -m tpu9_torch.runner.zygote --sock PATH",
              file=sys.stderr)
        sys.exit(2)
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(0))
    serve(args.sock, args.preload)


if __name__ == "__main__":
    main()
