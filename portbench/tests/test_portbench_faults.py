"""Runs on the CPU at small sizes, past the harness's look for a card,
with the timed path sound and broken underneath. Serving: a sound run
comes out correct; the control (the reference with float8 weights in the
program's place), judged by the same comparison, does not; nor does a run
whose engine alters the tokens it produces, nor a sample in which one
request's (one slot's) tokens are altered. Training: a sound run comes out
correct; the control, a step that returns its state unchanged, and one
that leaves half of the batch out, do not."""

import argparse
import time

import pytest

from portbench import serve
from portbench.tests.test_portbench_reference import tiny_conf

MIX = {"kind": "serve", "loop": "closed", "clients": 3,
       "pool_per_client": 32, "lead_in_s": 0.2, "drain_s": 30,
       "prompt": {"dist": "uniform", "min": 8, "max": 40},
       "output": {"dist": "uniform", "min": 4, "max": 12},
       "check_tokens": 24, "trace_s": 0.5}


def tiny_serving_conf(name: str) -> dict:
    conf = tiny_conf(name)
    conf["engine"].update(max_batch=2, max_seq_len=128,
                          prefill_buckets=[32, 128], decode_steps=[1, 4],
                          kv_block_size=32)
    return conf


def serve_once(conf, control=False):
    args = argparse.Namespace(seed=2 ** 31 + 99, seconds=3.0, trace=0)
    return serve.run({"name": "tiny.batch", "chips": 1}, conf, MIX, args,
                     time.monotonic(), device="cpu", control=control)


# the fewest layers of width 256 found at which float8 weights put first
# tokens that fail the cell's limits, with a sound run well inside them
CONTROL_LAYERS = {"mistral-7b": 16, "mixtral-8x7b": 24}


def control_conf(name: str) -> dict:
    """Width 256 and the published vocabulary, the init scaled so the
    logits spread as at full width."""
    conf = tiny_serving_conf(name)
    conf.update(hidden_size=256, intermediate_size=384,
                num_hidden_layers=CONTROL_LAYERS[name], vocab_size=32768,
                initializer_range=0.02 * (4096 / 256) ** 0.5)
    return conf


@pytest.mark.parametrize("name", ["mistral-7b", "mixtral-8x7b"])
def test_sound_run_is_correct_and_control_is_not(name):
    run = serve_once(control_conf(name), control=True)
    assert run.checks["correct"], run.checks["numbers"]
    assert run.attempted > 0 and run.failed == 0
    ctl = run.checks["control"]
    assert not ctl["correct"], ctl["numbers"]
    assert any(num["limit"] is not None and num["value"] > num["limit"]
               for key, num in ctl["numbers"].items()
               if key.startswith("served_"))


def greedy(arch, m, weights, prompt, n):
    toks = list(prompt)
    for _ in range(n):
        toks.append(int(arch.forward_logits(m, weights, toks)[-1].argmax()))
    return toks[len(prompt):]


@pytest.mark.parametrize("name", ["mistral-7b", "mixtral-8x7b"])
def test_one_request_altered_is_not_correct(name):
    """One of four sampled requests, not the longest, has every token
    altered, as one slot reading a wrong page would: under a quarter of
    the sample's tokens, which the median over the sample lets pass."""
    import torch
    from portbench import arch as archs, check, traffic
    conf = tiny_conf(name)
    arch = archs.of(conf)
    m = arch.model_from_config(conf)
    weights = arch.draw_weights(m, 2 ** 31 + 7, "cpu")
    gen = torch.Generator().manual_seed(11)
    reqs = []
    for i, (p, n) in enumerate([(30, 12), (20, 9), (24, 8), (16, 10)]):
        prompt = torch.randint(0, m.vocab_size, (p,), generator=gen).tolist()
        reqs.append(traffic.Request(index=i, prompt=prompt, max_new=n,
                                    tokens=greedy(arch, m, weights, prompt,
                                                  n),
                                    done=True))
    sound = check.serving(arch, m, weights, reqs, {"check_tokens": 39}, 5,
                          conf["check"])
    assert sound["correct"], sound["numbers"]
    reqs[2].tokens = [(t + 1) % m.vocab_size for t in reqs[2].tokens]
    out = check.serving(arch, m, weights, reqs, {"check_tokens": 39}, 5,
                        conf["check"])
    assert out["numbers"]["checked_tokens"]["value"] == 39
    assert not out["correct"], out["numbers"]
    stats = check.statistics(check.token_gaps(arch, m, weights, reqs,
                                              False)["served"])
    assert stats["served_logit_gap_median"] <= 1.0


@pytest.mark.parametrize("name", ["mistral-7b", "mixtral-8x7b"])
def test_altered_token_is_not_correct(name, monkeypatch):
    from tpu9_torch.serving.engine import InferenceEngine
    deliver = InferenceEngine._deliver_token
    vocab = tiny_conf(name)["vocab_size"]

    def altered(self, slot, tok):
        return deliver(self, slot, (tok + 1) % vocab)

    monkeypatch.setattr(InferenceEngine, "_deliver_token", altered)
    run = serve_once(tiny_serving_conf(name))
    assert not run.checks["correct"], run.checks
    assert any(num["value"] > num["limit"]
               for key, num in run.checks["numbers"].items()
               if key.startswith("served_"))


def train_once(fault=None, control=False, trace=0):
    import json
    from portbench import run as prun, train
    mix = json.loads((prun.HERE / "mixes" / "lora.json").read_text())
    mix.update(batch=4, seq_len=32, trace_steps=1)
    args = argparse.Namespace(seed=2 ** 31 + 41, seconds=1.0, trace=trace)
    return train.run({"name": "tiny.lora", "chips": 1},
                     tiny_conf("mistral-7b"), mix, args, time.monotonic(),
                     device="cpu", control=control, fault=fault)


def test_sound_train_run_is_correct_and_control_is_not():
    run = train_once(control=True)
    assert run.checks["correct"], run.checks["numbers"]
    ctl = run.checks["control"]
    assert not ctl["correct"], ctl["numbers"]


def _unchanged(step):
    def run(adapters, opt_state, base, tokens):
        _, _, out = step(adapters, opt_state, base, tokens)
        return adapters, opt_state, out
    return run


def _half_batch(step):
    def run(adapters, opt_state, base, tokens):
        return step(adapters, opt_state, base, tokens[: tokens.shape[0] // 2])
    return run


@pytest.mark.parametrize("fault", [_unchanged, _half_batch],
                         ids=["state_unchanged", "half_batch"])
def test_train_fault_is_not_correct(fault):
    run = train_once(fault=fault)
    assert not run.checks["correct"], run.checks["numbers"]
