"""The sweep that fixes an open-loop mix's rate: one cell's engine built
anew over the same weights for each offered rate, each served as a
measured run would be, printing the tail, the decode step and how far the
queue ran behind. Run once when a mix is made, never by the benchmark:

    python3 -m portbench.sweep --workload mistral-7b.chat --seed 7 \\
        --seconds 20 --rates 3 4 5 6
"""

from __future__ import annotations

import argparse
import asyncio
import gc
import json
import time

import torch

from . import arch as archs, readers, run as prun, serve, traffic, yardstick


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    args = p.parse_args()
    cell, conf, mix = prun.find_cell(prun.load_spec(), args.workload)
    conf = serve.with_mix_engine(conf, mix)
    arch = archs.of(conf)
    m = arch.model_from_config(conf)
    device = torch.device("cuda")
    weights = arch.draw_weights(m, args.seed, device)
    for rate in args.rates:
        engine = serve.build_engine(conf, m, weights, device)
        engine.warmup()
        rec = serve.Recorder()
        serve.instrument(engine, rec)
        reqs = traffic.requests(mix, args.seed, args.seconds, m.vocab_size,
                                rate=rate)
        window = asyncio.run(serve.drive(engine, mix, reqs, args.seconds,
                                         rec))
        run = serve.RunData(kind="serve", seed=args.seed,
                            seconds=args.seconds, setup_s=0.0, arch=arch,
                            model=m, mix=mix, window=window, rec=rec,
                            memory_peak_bytes=0, checks={})
        ttft = readers.ttft_s(run)
        tpot = readers.tpot_s(run)
        print(json.dumps({
            "rate": rate, "requests": len(window["counted"]),
            "unfinished": sum(1 for r in window["counted"] if not r.done),
            "ttft_p50_ms": yardstick.percentile(ttft, 50) * 1e3,
            "ttft_p90_ms": yardstick.percentile(ttft, 90) * 1e3,
            "tpot_p90_ms": (yardstick.percentile(tpot, 90) * 1e3
                            if tpot else None),
            "output_tokens_per_s": readers.tokens_in_window(run)
            / args.seconds,
            "decode_step_ms": readers.decode_step_ms(run),
            "generator_late_max_s": max(window["lateness"] or [0.0]),
            "queued_at_close": rec.stats.get("close", {}).get("queued"),
            "at": time.strftime("%H:%M:%S")}), flush=True)
        del engine
        gc.collect()
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
