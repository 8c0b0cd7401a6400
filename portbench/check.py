"""How ``correct`` is decided for a served model: the plain reference of
the configuration's architecture (its module's ``forward_logits``, float32)
runs once over each sampled prompt
with its served tokens, and each served token's logit is read against the
reference's best at its position. The statistics of those gaps that a
configuration limits (its ``check``) are compared with their limits:
the widest gap over the sample, the median over the sample, and the
worst request's median (a fault confined to one request or one slot).
Greedy tokens of a sound program lie within rounding of the reference's
best.

The control is judged by the same comparison: the reference with float8
weights is put in the program's place, and at each position of the same
prompts and served tokens the token it puts first is read against the
reference's best. Its verdict has to come out false.

The sample is drawn from ``--seed`` among the window's finished requests
and always holds the longest of them; it grows until it holds the mix's
``check_tokens`` served tokens."""

from __future__ import annotations

import numpy as np
import torch

from .reference.shared import as_f32, fp8_weight

# the statistics of a sample's gaps, by the name a configuration's
# ``check`` limits them under
STATISTICS = ("served_logit_gap", "served_logit_gap_median",
              "served_request_median_gap")


def sample(reqs: list, mix: dict, seed: int) -> list:
    finished = [r for r in reqs if r.done]
    if not finished:
        return []
    longest = max(finished, key=lambda r: len(r.prompt) + len(r.tokens))
    order = np.random.default_rng(seed ^ 0x5EED).permutation(len(finished))
    picked, served = [longest], len(longest.tokens)
    for i in order:
        r = finished[int(i)]
        if served >= mix["check_tokens"]:
            break
        if r is not longest:
            picked.append(r)
            served += len(r.tokens)
    return picked


def token_gaps(arch, m, weights: dict, picked: list, control: bool) -> dict:
    """Per sampled request, the gap of each served token under the
    reference of ``arch`` (the configuration's module); with ``control``,
    also the gap of the token the float8 reference puts first at the same
    positions."""
    out = {"served": [], "control": []}
    for r in picked:
        seq = r.prompt + r.tokens[:-1]
        rows = slice(len(r.prompt) - 1, len(seq))
        ref = arch.forward_logits(m, weights, seq, as_f32, positions=rows)
        want = torch.as_tensor(r.tokens, device=ref.device)
        best = ref.max(dim=-1).values
        out["served"].append(
            (best - ref.gather(1, want[:, None])[:, 0]).tolist())
        if control:
            low = arch.forward_logits(m, weights, seq, fp8_weight,
                                      positions=rows)
            pick = low.argmax(dim=-1)
            out["control"].append(
                (best - ref.gather(1, pick[:, None])[:, 0]).tolist())
            del low
        del ref
    return out


def median(values: list) -> float:
    """The lower median (the value at rank ceil(n/2))."""
    vals = sorted(values)
    return vals[(len(vals) - 1) // 2] if vals else float("nan")


def statistics(per_request: list) -> dict:
    every = [g for gaps in per_request for g in gaps]
    return {"served_logit_gap": max(every),
            "served_logit_gap_median": median(every),
            "served_request_median_gap": max(median(g)
                                             for g in per_request)}


def spread(gaps: list) -> dict:
    """Quantiles of a run's per-position gaps and the shares above a few
    thresholds: what a limit on another statistic would read."""
    g = sorted(gaps)
    if not g:
        return {}
    q = {f"q{p}": g[min(len(g) - 1, int(p / 100 * len(g)))]
         for p in (50, 90, 95, 99)}
    q.update({f"over_{t}": sum(x > t for x in g) / len(g)
              for t in (0.1, 0.5, 1.0, 2.0)})
    return q


def judge(per_request: list, failed: int, mix: dict, limits: dict,
          every_statistic: bool = False) -> dict:
    """The verdict on one set of tokens (the program's served tokens, or
    the control's in their place): the numbers compared, each with its
    limit, and whether all hold. ``limits`` is the configuration's
    ``check``; a statistic it does not name is not compared, and is
    reported with no limit where ``every_statistic`` asks for it (the
    readings a limit is set from)."""
    nums = {"failed_requests": {"value": failed, "limit": 0}}
    ok = failed == 0 and bool(per_request)
    if not per_request:
        return {"correct": False, "numbers": nums}
    for key, value in statistics(per_request).items():
        if key in limits:
            nums[key] = {"value": value, "limit": limits[key]}
            ok = ok and value <= limits[key]
        elif every_statistic:
            nums[key] = {"value": value, "limit": None}
    positions = sum(len(g) for g in per_request)
    nums["checked_tokens"] = {"value": positions,
                              "limit": mix["check_tokens"]}
    ok = ok and positions >= mix["check_tokens"]
    return {"correct": ok, "numbers": nums}


def serving(arch, m, weights: dict, counted: list, mix: dict, seed: int,
            limits: dict, control: bool = False) -> dict:
    """The program's verdict: ``served_logit_gap`` limits the widest gap
    (in logits) by which a served greedy token lies below the reference's
    best at its position, ``served_logit_gap_median`` the median over the
    sampled positions, ``served_request_median_gap`` the largest of the
    sampled requests' medians; a configuration names the statistics that
    tell its sound runs from its control (PERF.md gives the readings each
    limit was set from). With ``control``, the control's verdict by the
    same comparison is added under ``control``."""
    picked = sample(counted, mix, seed)
    failed = sum(1 for r in counted if not r.done)
    gaps = token_gaps(arch, m, weights, picked, control)
    out = judge(gaps["served"], failed, mix, limits, every_statistic=control)
    if control:
        out["control"] = judge(gaps["control"], failed, mix, limits,
                               every_statistic=True)
        out["spread"] = {k: spread([g for gs in v for g in gs])
                         for k, v in gaps.items()}
    return out
