"""The serving cells: the configuration's engine built through
``InferenceEngine`` and ``presets.engine_config`` over the benchmark's
weights, warmed, then driven through ``InferenceEngine.generate`` by the
mix's clients, each token stamped on the host's clock as the client
receives it. After the window the engine is freed and the reference
judges a sample of the window's finished requests.

The benchmark records what it needs around four of the engine's calls,
from this file: ``_occupy_slot`` (a lane's length at admission),
``_launch_window`` (each decode window's lanes, lengths and steps),
``_admit`` (each admission's prompt and cached tokens) and, in a traced
run, the profiler's start and stop at window boundaries outside any
admission."""

from __future__ import annotations

import asyncio
import gc
import itertools
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from . import arch as archs, check, traffic
from .trace import Profiler


@dataclass
class Recorder:
    """What the benchmark saw of the engine's work: decode windows
    ``(t, k, lengths at dispatch)``, admissions ``(t_start, t_end, prompt
    tokens, cached tokens)``, stats snapshots, and the traced slice."""
    lens: dict = field(default_factory=dict)
    windows: list = field(default_factory=list)
    admissions: list = field(default_factory=list)
    stats: dict = field(default_factory=dict)
    prof: Profiler = None
    trace_from: float = float("inf")
    trace_s: float = 0.0
    traced: dict = field(default_factory=lambda: {"t0": None, "t1": None})
    slice: object = None
    engine: object = None
    stats_at: dict = field(default_factory=dict)


def with_mix_engine(conf: dict, mix: dict) -> dict:
    """The configuration with the mix's ``engine`` knobs laid over its
    own."""
    if "engine" not in mix:
        return conf
    return {**conf, "engine": {**conf["engine"], **mix["engine"]}}


def build_engine(conf: dict, m, weights, device):
    """The engine as ``load_engine`` builds it: the configuration's
    architecture's ``DecoderConfig`` and ``presets.engine_config`` over
    every knob of its ``engine`` but the decoder's
    ``moe_capacity_factor``."""
    from tpu9_torch.serving.engine import InferenceEngine
    from tpu9_torch.serving.presets import engine_config
    knobs = {k: tuple(v) if isinstance(v, list) else v
             for k, v in conf["engine"].items()
             if k != "moe_capacity_factor"}
    return InferenceEngine(weights, archs.of(conf).decoder_config(conf, m),
                           engine_config(**knobs), device=device)


def instrument(engine, rec: Recorder) -> None:
    """Wrap the engine's calls that the benchmark reads around (on the
    instance, so nothing of the program changes)."""
    occupy, launch, admit, process = (engine._occupy_slot,
                                      engine._launch_window, engine._admit,
                                      engine._process_window)
    prof = rec.prof or Profiler()
    rec.engine = engine

    def _occupy_slot(req, slot):
        rec.lens[slot] = len(req.prompt)
        return occupy(req, slot)

    def _launch_window(k):
        if engine._admitting is None:
            _trace_edge(rec, time.monotonic())
        now = time.monotonic()
        active = np.flatnonzero(engine.active)
        lens = [rec.lens[int(s)] for s in active]
        for s in active:
            rec.lens[int(s)] += k
        rec.windows.append((now, k, lens))
        with prof.phase("engine._launch_window"):
            return launch(k)

    def _process_window(win):
        with prof.phase("engine._process_window"):
            return process(win)

    async def _admit(req, slot):
        t0 = time.monotonic()
        with prof.phase("engine._admit"):
            first = await admit(req, slot)
        rec.admissions.append((t0, time.monotonic(), len(req.prompt),
                               req.admit_cached))
        return first

    engine._occupy_slot = _occupy_slot
    engine._launch_window = _launch_window
    engine._process_window = _process_window
    engine._admit = _admit


def _trace_edge(rec: Recorder, now: float) -> None:
    """At a window boundary outside any admission: start the traced slice
    once ``trace_from`` has passed, stop it ``trace_s`` later."""
    if rec.prof is None:
        return
    if rec.traced["t0"] is None and now >= rec.trace_from:
        # the window in flight finishes first, so the slice holds the
        # kernels of exactly the windows launched inside it
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        rec.prof.start()
        rec.traced["t0"] = time.monotonic()
    elif rec.traced["t0"] is not None and rec.traced["t1"] is None \
            and now >= rec.traced["t0"] + rec.trace_s:
        # the stats window of a traced run closes here: the profiler's
        # stop holds the serve loop
        rec.stats["close"] = rec.engine.stats()
        rec.stats_at["close"] = time.monotonic()
        rec.prof.stop()
        rec.traced["t1"] = time.monotonic()


async def _consume(engine, r: traffic.Request) -> None:
    r.sent = time.monotonic()
    try:
        req = await engine.generate(r.prompt, r.max_new,
                                    request_id=f"q{r.index}", stream=True)
        while True:
            tok = await req.queue.get()
            if tok is None:
                break
            r.times.append(time.monotonic())
            r.tokens.append(tok)
        r.error = req.error
    except (RuntimeError, ValueError, TimeoutError) as exc:
        r.error = f"{type(exc).__name__}: {exc}"
    r.done = not r.error and len(r.tokens) == r.max_new


async def drive(engine, mix: dict, reqs: list, seconds: float,
                rec: Recorder) -> dict:
    """Serve ``reqs`` by the mix's loop; returns the window's clock
    readings. The window opens ``lead_in_s`` after the first request;
    a run waits at most ``drain_s`` past its close for the window's
    requests. A request with later turns opens a session: its next turn
    goes out when it completes (``traffic.next_turn``)."""
    await engine.start()
    t0 = time.monotonic()
    open_at = t0 + mix["lead_in_s"]
    close_at = open_at + seconds
    give_up = close_at + mix["drain_s"]
    tasks: list = []
    every = list(reqs)      # with the sessions' later turns as they go out
    counted: list = []
    lateness: list = []
    stop = asyncio.Event()

    async def snapshot(name: str, at: float) -> None:
        await asyncio.sleep(max(0.0, at - time.monotonic()))
        if name not in rec.stats:
            rec.stats[name] = engine.stats()
            rec.stats_at[name] = time.monotonic()

    snaps = [asyncio.create_task(snapshot("open", open_at)),
             asyncio.create_task(snapshot("close", close_at))]

    indices = itertools.count(len(reqs))

    def later_turn(r: traffic.Request):
        return traffic.next_turn(r, next(indices))

    if mix["loop"] == "open":
        task_of: dict = {}
        sessions: list = []

        async def session(r: traffic.Request) -> None:
            while True:
                task_of[r.index] = asyncio.create_task(_consume(engine, r))
                tasks.append(task_of[r.index])
                await task_of[r.index]
                r = later_turn(r)
                if r is None:
                    return
                await asyncio.sleep(mix.get("think_s", 0.0))
                if stop.is_set():
                    return
                r.due_s = time.monotonic()
                every.append(r)
                if open_at <= r.due_s < close_at:
                    counted.append(r)

        async def generator() -> None:
            for r in reqs:
                due = t0 + r.due_s
                delay = due - time.monotonic()
                if delay > 0:
                    await asyncio.sleep(delay)
                if stop.is_set():
                    return
                lateness.append(time.monotonic() - due)
                r.due_s = due
                if open_at <= due < close_at:
                    counted.append(r)
                if r.turns:
                    sessions.append(asyncio.create_task(session(r)))
                    continue
                task_of[r.index] = asyncio.create_task(_consume(engine, r))
                tasks.append(task_of[r.index])
        gen = asyncio.create_task(generator())
        await asyncio.sleep(max(0.0, close_at - time.monotonic()))
        window_tasks = [task_of[r.index] for r in counted
                        if r.index in task_of]
    else:
        pool = iter(reqs)
        sessions = []

        async def client() -> None:
            for r in pool:
                while r is not None:
                    if time.monotonic() >= close_at or stop.is_set():
                        return
                    if r.index >= len(reqs):
                        every.append(r)
                    task = asyncio.create_task(_consume(engine, r))
                    tasks.append(task)
                    await task
                    r = later_turn(r)
        gen = asyncio.gather(*[client() for _ in range(mix["clients"])])
        await asyncio.sleep(max(0.0, close_at - time.monotonic()))
        window_tasks = [t for t in tasks if not t.done()]
    # wait for the window's requests, the traffic running on
    if window_tasks:
        await asyncio.wait(window_tasks,
                           timeout=max(0.0, give_up - time.monotonic()))
    end = time.monotonic()
    stop.set()
    if mix["loop"] == "closed":
        # sent before the close and not finished before the open
        counted = [r for r in every if r.sent and r.sent < close_at
                   and not (r.done and r.times[-1] < open_at)]
    gen.cancel()
    for task in tasks + sessions:
        task.cancel()
    await asyncio.gather(gen, *tasks, *sessions, *snaps,
                         return_exceptions=True)
    if rec.prof is not None and rec.traced["t0"] is not None:
        if rec.traced["t1"] is None:
            rec.prof.stop()
            rec.traced["t1"] = time.monotonic()
        rec.slice = rec.prof.read()
    await engine.stop()
    return {"open": open_at, "close": close_at, "end": end,
            "counted": counted, "all": every, "lateness": lateness}


def run(cell: dict, conf: dict, mix: dict, args, t_start: float, *,
        device="cuda", control: bool = False, rate=None, witness=None):
    """One run of a serving cell (``args``: ``seed``, ``seconds``,
    ``trace``); returns what the readers read. ``control`` adds the
    control's reading to the check, ``rate`` overrides an open loop's rate
    (both for the readings and the sweep), and ``witness(conf, model,
    weights, requests)`` runs after the check, over the same weights (the
    readings' second witness)."""
    device = torch.device(device)
    conf = with_mix_engine(conf, mix)
    arch = archs.of(conf)
    m = arch.model_from_config(conf)
    weights = arch.draw_weights(m, args.seed, device)
    engine = build_engine(conf, m, weights, device)
    engine.warmup()
    reqs = traffic.requests(mix, args.seed, args.seconds, m.vocab_size,
                            rate=rate)
    rec = Recorder()
    if args.trace:
        rec.prof = Profiler()
        rec.trace_s = mix["trace_s"]
        rec.prof.warm()
    # after the profiler is set: the wrappers' host phases bind to it
    instrument(engine, rec)
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.monotonic() - t_start
    loop_start = time.monotonic()
    rec.trace_from = loop_start + mix["lead_in_s"] + max(
        0.0, (args.seconds - mix["trace_s"]) / 2)
    window = asyncio.run(drive(engine, mix, reqs, args.seconds, rec))
    rec.engine = None
    compiles = engine.stats()["graph_compiles_post_warmup"]
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    del engine
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = check.serving(arch, m, weights, window["counted"], mix,
                           args.seed, conf["check"], control=control)
    if witness is not None:
        checks["witness"] = witness(conf, m, weights, window["counted"])
    return RunData(kind="serve", seed=args.seed, seconds=args.seconds,
                   setup_s=setup_s, arch=arch, model=m, mix=mix,
                   window=window, rec=rec, memory_peak_bytes=int(peak),
                   checks=checks, compiles_in_window=compiles)


@dataclass
class RunData:
    kind: str
    seed: int
    seconds: float
    setup_s: float
    arch: object        # the configuration's module (``portbench/arch``)
    model: object       # its ``model_from_config``
    mix: dict
    window: dict
    rec: Recorder
    memory_peak_bytes: int
    checks: dict
    compiles_in_window: int = 0

    @property
    def attempted(self) -> int:
        return len(self.window["counted"])

    @property
    def failed(self) -> int:
        return sum(1 for r in self.window["counted"] if not r.done)

    @property
    def slice(self):
        return self.rec.slice
