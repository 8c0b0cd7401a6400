"""The training cell: the LoRA step that
``tpu9_torch.train.build_lora_train_step`` returns, over the benchmark's
base weights and adapters (``a`` N(0, 1) / rank, ``b`` zero, as
``examples/05`` initialises them), fed fresh seeded rows every step.

Set-up builds the one step object and its optimizer state and drives them
through the mix's first ``setup_steps`` steps (they also build every
kernel); the readings the check needs are taken from those steps: each
step's loss, each adapter leaf's first gradient worked out from AdamW's
first moment after step 1 (``mu / (1 - b1)``), and each leaf's change
after the last set-up step. The same object then runs for the window.
After it, the plain reference (the architecture module's ``lora_steps``)
follows the set-up steps from the same adapters on the same rows."""

from __future__ import annotations

import gc
import time
from dataclasses import dataclass

import torch

from . import arch as archs
from .reference.shared import fp8_weight, leaves
from .trace import Profiler

B1 = 0.9   # optax's adamw default, which the program's adamw keeps


def leaf_norms(tree: dict, scale: float = 1.0) -> dict:
    return {k: float(v.float().norm()) * scale
            for k, v in leaves(tree).items()}


@dataclass
class TrainRun:
    kind: str
    seed: int
    seconds: float
    setup_s: float
    arch: object        # the configuration's module (``portbench/arch``)
    model: object       # its ``model_from_config``
    mix: dict
    window: dict
    memory_peak_bytes: int
    checks: dict
    slice: object = None
    compiles_in_window: int = 0
    steps: int = 0
    traced_steps: int = 0

    @property
    def attempted(self) -> int:
        return self.steps

    @property
    def failed(self) -> int:
        return 0 if self.checks.get("finite", True) else self.steps


def run(cell: dict, conf: dict, mix: dict, args, t_start: float, *,
        device="cuda", control: bool = False, fault=None) -> TrainRun:
    """One run of the training cell (``args``: ``seed``, ``seconds``,
    ``trace``). ``control`` adds the control's readings to the check;
    ``fault`` wraps the program's step (the fault tests and readings)."""
    from tpu9_torch.train import build_lora_train_step, optim
    device = torch.device(device)
    arch = archs.of(conf)
    m = arch.model_from_config(conf)
    weights = arch.draw_weights(m, args.seed, device)
    cfg = arch.decoder_config(conf, m)
    rank, scale = mix["rank"], mix["alpha"] / mix["rank"]
    adapters0 = arch.draw_adapters(m, mix["targets"], rank, args.seed,
                                   device)
    opt = optim.adamw(mix["learning_rate"],
                      weight_decay=mix["weight_decay"])
    step = build_lora_train_step(cfg, opt, scale=scale, device=device)
    if fault is not None:
        step = fault(step)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed + 2)
    shape = (mix["batch"], mix["seq_len"])

    def rows():
        return torch.randint(0, m.vocab_size, shape, generator=gen,
                             device=device, dtype=torch.int32)

    adapters = {"layers": [{n: {p: t.clone() for p, t in e.items()}
                            for n, e in layer.items()}
                           for layer in adapters0["layers"]]}
    opt_state = opt.init(adapters)
    batches, losses = [], []
    first_grad = {}
    for i in range(mix["setup_steps"]):
        tokens = rows()
        batches.append(tokens)
        adapters, opt_state, out = step(adapters, opt_state, weights, tokens)
        losses.append(out["loss"])
        if i == 0:
            first_grad = leaf_norms({"layers": opt_state.mu["layers"]},
                                    1.0 / (1.0 - B1))
    after = leaves(adapters)
    before = leaves(adapters0)
    delta = {k: float((after[k] - before[k]).norm()) for k in after}
    losses = [float(x) for x in losses]
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.monotonic() - t_start

    prof = Profiler() if args.trace else None
    traced = 0
    n = 0
    t_open = time.monotonic()
    close = t_open + args.seconds
    sl = None
    while time.monotonic() < close:
        if prof is not None and sl is None \
                and time.monotonic() >= t_open + args.seconds / 3:
            if device.type == "cuda":
                torch.cuda.synchronize()
            prof.start()
            for _ in range(mix["trace_steps"]):
                with prof.phase("lora step"):
                    adapters, opt_state, out = step(adapters, opt_state,
                                                    weights, rows())
                n += 1
                traced += 1
            prof.stop()
            sl = prof.read()
            continue
        adapters, opt_state, out = step(adapters, opt_state, weights, rows())
        n += 1
    last_loss = float(out["loss"]) if n else float("nan")
    t_end = time.monotonic()
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    del adapters, opt_state, out, step
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = check_steps(arch, m, weights, adapters0, batches, mix, scale,
                         losses, first_grad, delta, conf["check"],
                         control=control)
    checks["finite"] = last_loss == last_loss
    checks["correct"] = checks["correct"] and checks["finite"]
    return TrainRun(kind="train", seed=args.seed, seconds=args.seconds,
                    setup_s=setup_s, arch=arch, model=m, mix=mix,
                    window={"open": t_open, "close": close, "end": t_end,
                            "lateness": []},
                    memory_peak_bytes=int(peak), checks=checks, slice=sl,
                    steps=n, traced_steps=traced)


def worst_gap(program: dict, reference: dict, keep) -> float:
    """The worst leaf's gap of norms, against the reference's norm of that
    leaf or of the median leaf, whichever is larger; over the leaves
    ``keep`` names."""
    kept = sorted(k for k in reference if keep(k))
    if not kept:
        return float("nan")
    vals = sorted(reference[k] for k in kept)
    median = vals[len(vals) // 2]
    return max(abs(program[k] - reference[k]) / max(reference[k], median)
               for k in kept)


def compare(prog: dict, ref: dict) -> dict:
    """The numbers compared: the worst step's relative loss gap, the worst
    leaf's first-gradient gap and the worst leaf's change gap. Leaves whose
    reference gradient is under a thousandth of the median leaf's (in the
    first step for the gradient, in every step for the change) move by
    round-off alone and are left out."""
    grads = sorted(ref["first_grad"].values())
    g_med = grads[len(grads) // 2]
    seen = sorted(ref["grad_seen"].values())
    s_med = seen[len(seen) // 2]
    return {
        "loss_gap": max(abs(p - r) / abs(r)
                        for p, r in zip(prog["losses"], ref["losses"])),
        "first_grad_gap": worst_gap(
            prog["first_grad"], ref["first_grad"],
            lambda k: ref["first_grad"][k] >= 1e-3 * g_med),
        "change_gap": worst_gap(
            prog["delta"], ref["delta"],
            lambda k: ref["grad_seen"][k] >= 1e-3 * s_med)}


def verdict(got: dict, limits: dict, readings: bool = False) -> dict:
    """The numbers compared, each with its limit from the configuration's
    ``check``, and whether all hold. A number the configuration gives no
    limit is not compared (PERF.md names it with its readings); with
    ``readings`` it is reported with no limit."""
    nums = {k: {"value": v, "limit": limits[k]} for k, v in got.items()
            if k in limits}
    ok = all(v["value"] <= v["limit"] for v in nums.values())
    if readings:
        nums.update({k: {"value": v, "limit": None} for k, v in got.items()
                     if k not in limits})
    return {"correct": ok, "numbers": nums}


def check_steps(arch, m, weights, adapters0, batches, mix, scale, losses,
                first_grad, delta, limits: dict,
                control: bool = False) -> dict:
    """The program's verdict (limits set from the program's and the
    control's readings on the card, PERF.md). With ``control``, the
    control's verdict by the same comparison is added under ``control``:
    the reference's steps with float8 weights in the program's place."""
    ref = arch.lora_steps(m, weights, adapters0, batches, scale,
                          mix["learning_rate"], mix["weight_decay"])
    out = verdict(compare({"losses": losses, "first_grad": first_grad,
                           "delta": delta}, ref), limits, readings=control)
    if control:
        low = arch.lora_steps(m, weights, adapters0, batches, scale,
                              mix["learning_rate"], mix["weight_decay"],
                              weight=fp8_weight)
        out["control"] = verdict(compare(low, ref), limits, readings=True)
    return out
