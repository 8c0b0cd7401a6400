"""The readings a correctness limit is set from: one cell run over many
seeds in one process (imports and kernel builds paid once), each with the
control beside it, printing the numbers compared and both verdicts: the
program's, and the control's by the same comparison in its place. Run
when a limit is set, never by the benchmark:

    python3 -m portbench.readings --workload mixtral-8x7b.batch \\
        --seconds 15 --seeds 101 102 103

``--witness`` (serving) adds the program's own no-cache forward over the
sampled sequences: the served tokens' gaps under it, and its own greedy
tokens' gaps under the reference; ``--fault half_batch`` (training) runs
the program's step on the first half of each batch's rows.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import time

import torch

from . import arch as archs, check, run as prun


def witness(conf, m, weights, counted, mix, seed) -> dict:
    """The program's no-cache forward (``decoder_forward``) over the same
    prompts and served tokens: how far the served tokens lie below its
    best (the serving path against the model at its own precision), and
    how far its best lies below the reference's."""
    from tpu9_torch.models.transformer import decoder_forward
    arch = archs.of(conf)
    cfg = arch.decoder_config(conf, m)
    own, ref_gap = [], []
    for r in check.sample(counted, mix, seed):
        seq = r.prompt + r.tokens[:-1]
        rows = slice(len(r.prompt) - 1, len(seq))
        toks = torch.as_tensor([seq], device=weights["embed"].device)
        prog = decoder_forward(weights, toks, cfg)[0, rows].float()
        want = torch.as_tensor(r.tokens, device=prog.device)
        own += (prog.max(-1).values
                - prog.gather(1, want[:, None])[:, 0]).tolist()
        ref = arch.forward_logits(m, weights, seq, positions=rows)
        pick = prog.argmax(-1)
        ref_gap += (ref.max(-1).values
                    - ref.gather(1, pick[:, None])[:, 0]).tolist()
    return {"served_under_program": check.spread(own),
            "program_under_reference": check.spread(ref_gap),
            "widest": [max(own), max(ref_gap)]}


def values(verdict: dict) -> dict:
    return {k: v["value"] for k, v in verdict["numbers"].items()}


def half_batch(step):
    def run(adapters, opt_state, base, tokens):
        return step(adapters, opt_state, base, tokens[: tokens.shape[0] // 2])
    return run


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--rate", type=float, default=None)
    p.add_argument("--witness", type=int, default=0,
                   help="seeds (the first ones) that also read the witness")
    p.add_argument("--fault", choices=("half_batch",), default=None)
    args = p.parse_args()
    cell, conf, mix = prun.find_cell(prun.load_spec(), args.workload)
    cell_kind = importlib.import_module(f"portbench.{mix['kind']}")
    for i, seed in enumerate(args.seeds):
        ns = argparse.Namespace(seed=seed, seconds=args.seconds, trace=0)
        extra = {"control": args.fault is None}
        if mix["kind"] == "serve" and args.rate is not None:
            extra["rate"] = args.rate
        if mix["kind"] == "train" and args.fault:
            extra["fault"] = half_batch
        if mix["kind"] == "serve" and i < args.witness:
            extra["witness"] = lambda c, m, w, reqs, s=seed: witness(
                c, m, w, reqs, mix, s)
        t0 = time.monotonic()
        run = cell_kind.run(cell, conf, mix, ns, t0, **extra)
        ctl = run.checks.get("control")
        print(json.dumps({"seed": seed, "fault": args.fault,
                          "correct": run.checks["correct"],
                          "attempted": run.attempted, "failed": run.failed,
                          "setup_s": run.setup_s,
                          "run_s": time.monotonic() - t0,
                          **values(run.checks),
                          "control": ctl and {"correct": ctl["correct"],
                                              **values(ctl)},
                          "spread": run.checks.get("spread"),
                          "witness": run.checks.get("witness")}),
              flush=True)
        del run
        gc.collect()
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
