"""The architecture modules (``portbench/arch``): the Mistral/Mixtral
decoder's draws, reference logits, engine config and counts equal what the
harness gave before they moved there; every configuration resolves to a
module that gives the whole interface, with its ``"reference"``; and an
architecture that ``arch/decoder.py`` refuses is served and judged correct
from files of its own."""

import argparse
import dataclasses
import hashlib
import json
import sys
import time
import types

import pytest
import torch

from portbench import arch as archs, readers, run as prun, serve
from portbench.layer_metrics import b1_roofline, b3_roofline, mfu
from portbench.reference import shared
from portbench.tests.test_portbench_faults import MIX, tiny_serving_conf
from portbench.tests.test_portbench_isolation import top_level_imports
from portbench.tests.test_portbench_reference import tiny_conf

SPEC = prun.load_spec()
SEED = 2 ** 31 + 5


def digest(obj) -> str:
    """sha256 of tensors' dtype, shape and bytes, dicts by sorted key,
    lists in order, anything else by its repr."""
    h = hashlib.sha256()

    def walk(x):
        if isinstance(x, torch.Tensor):
            t = x.detach().contiguous().cpu()
            h.update(str((t.dtype, tuple(t.shape))).encode())
            h.update(t.view(torch.uint8).numpy().tobytes() if t.numel()
                     else b"")
        elif isinstance(x, dict):
            for k in sorted(x):
                h.update(k.encode())
                walk(x[k])
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        else:
            h.update(repr(x).encode())
    walk(obj)
    return h.hexdigest()[:16]


# Recorded from the tree before the move (``portbench/weights.py``,
# ``serve.decoder_config``, ``train.draw_adapters``, the readers over
# ``run.shape``), unpacked by ``git archive`` and run with the same inputs
# on the CPU: the draws, logits and counts of the cells must not move.
ENGINE = {"vocab_size": 97, "dim": 64, "n_layers": 2, "n_heads": 4,
          "n_kv_heads": 2, "head_dim": 16, "hidden_dim": 96,
          "norm_eps": 1e-05, "rope_theta": 1000000.0, "max_seq_len": 256,
          "act": "silu", "norm_offset": 0.0, "embed_scale": False,
          "logit_softcap": 0.0, "tie_embeddings": False,
          "dtype": torch.bfloat16}
TINY = {
    "mistral-7b": {
        "model": "Model(name='mistral-7b', dim=64, n_layers=2, n_heads=4, "
                 "n_kv_heads=2, head_dim=16, hidden_dim=96, vocab_size=97, "
                 "norm_eps=1e-05, rope_theta=1000000.0, init_std=0.16, "
                 "n_experts=0, top_k=0)",
        "engine": {**ENGINE, "n_experts": 0},
        "weights": "13fc06625fc2d8d7", "logits": "d0f80ccfbeed36c6",
        "control_rows": "6393ad2fa2e0e9ff", "adapters": "6906c201be2f6656",
        "lora_steps": "b08706255511e649"},
    "mixtral-8x7b": {
        "model": "Model(name='mixtral-8x7b', dim=64, n_layers=2, n_heads=4, "
                 "n_kv_heads=2, head_dim=16, hidden_dim=96, vocab_size=97, "
                 "norm_eps=1e-05, rope_theta=1000000.0, init_std=0.16, "
                 "n_experts=4, top_k=2)",
        "engine": {**ENGINE, "n_experts": 4, "moe_top_k": 2,
                   "moe_capacity_factor": 2.0},
        "weights": "e7a203c84342e302", "logits": "89a81020370b5661",
        "control_rows": "c706c189127dfdaf", "adapters": "6906c201be2f6656"},
}
COUNTS = {
    "mistral-7b": {"b1_roofline": 58.1146235430209,
                   "mfu.serve": 1.644900959152275,
                   "served_flops": 48804211458048,
                   "b3_roofline": 1.2820797898507463,
                   "mfu.train": 26.12655965402467,
                   "train_flops": 129195837489152},
    "mixtral-8x7b": {"b1_roofline": 29.05731177151045,
                     "mfu.serve": 1.47078583322575,
                     "served_flops": 43638215671808,
                     "b3_roofline": 0.6410398949253732,
                     "mfu.train": 22.615565028510414,
                     "train_flops": 111833969065984},
}


@pytest.mark.parametrize("name", sorted(TINY))
def test_draws_reference_and_engine_config_unchanged(name):
    want = TINY[name]
    conf = tiny_conf(name)
    arch = archs.of(conf)
    m = arch.model_from_config(conf)
    assert repr(m) == want["model"]
    cfg = arch.decoder_config(conf, m)
    assert {k: getattr(cfg, k) for k in want["engine"]} == want["engine"]
    w = arch.draw_weights(m, SEED, "cpu")
    assert digest(w) == want["weights"]
    gen = torch.Generator().manual_seed(3)
    toks = torch.randint(0, m.vocab_size, (40,), generator=gen).tolist()
    assert digest(arch.forward_logits(m, w, toks)) == want["logits"]
    assert digest(arch.forward_logits(m, w, toks, shared.fp8_weight,
                                      positions=slice(30, 40))) \
        == want["control_rows"]
    ad = arch.draw_adapters(m, ["wq", "wk", "wv", "wo"], 4, SEED, "cpu")
    assert digest(ad) == want["adapters"]
    if "lora_steps" in want:
        batches = [torch.randint(0, m.vocab_size, (2, 12), generator=gen,
                                 dtype=torch.int32) for _ in range(2)]
        assert digest(arch.lora_steps(m, w, ad, batches, 1.0, 1e-2, 1e-4)) \
            == want["lora_steps"]


def traced_serve(arch, m):
    """A traced serving run's windows ``(t, k, lengths)`` and admissions,
    and a slice whose split kernels number the windows' calls."""
    wins = []
    for i, k in enumerate([1, 8, 32, 8, 1, 32]):
        lens = [128 + (97 * (i + 1) * (j + 3)) % 1700 for j in range(32 - i)]
        wins.append((10.0 + i, k, lens))
    adms = [(10.5 + i, 10.6 + i, 128 + 61 * i, 128 * (i % 2))
            for i in range(5)]
    calls = arch.decode_attention_calls(m, sum(k for _, k, _ in wins))
    sl = types.SimpleNamespace(
        window_s=3.0, busy_s=2.5,
        kernel_s=lambda *subs: ((0.125, calls) if "split_decode_kernel"
                                in subs else (0.03125, calls)))
    return types.SimpleNamespace(
        kind="serve", slice=sl, arch=arch, model=m, mix={},
        rec=types.SimpleNamespace(traced={"t0": 9.0, "t1": 20.0},
                                  windows=wins, admissions=adms))


def traced_train(arch, m):
    steps = 3
    sl = types.SimpleNamespace(
        window_s=1.5, busy_s=1.0,
        kernel_s=lambda *subs: ((0.25, arch.train_attention_calls(m, steps))
                                if "flash_kernel" in subs else (0.5, 0)))
    return types.SimpleNamespace(kind="train", slice=sl, arch=arch, model=m,
                                 mix={"batch": 8, "seq_len": 512},
                                 traced_steps=steps)


@pytest.mark.parametrize("name", sorted(COUNTS))
def test_counts_unchanged(name):
    """At the configurations' own sizes: the readers' FLOPs, bytes and
    calls through the module read what they read over ``run.shape``."""
    conf = json.loads((prun.ROOT / f"portbench/configs/{name}.json")
                      .read_text())
    arch = archs.of(conf)
    m = arch.model_from_config(conf)
    want = COUNTS[name]
    run = traced_serve(arch, m)
    assert b1_roofline.read(run) == want["b1_roofline"]
    assert mfu.read(run) == want["mfu.serve"]
    assert readers.served_flops(run) == want["served_flops"]
    run = traced_train(arch, m)
    assert b3_roofline.read(run) == want["b3_roofline"]
    assert mfu.read(run) == want["mfu.train"]
    assert arch.lora_step_flops(m, 8, 512) == want["train_flops"]


def kinds_naming(config: str) -> set:
    return {prun.find_cell(SPEC, c["name"])[2]["kind"]
            for c in SPEC["workloads"] if c["config"] == config}


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda c: c["name"])
def test_config_resolves_to_a_whole_module(entry):
    conf = json.loads((prun.ROOT / entry["file"]).read_text())
    arch = archs.of(conf)
    names = archs.SERVING + (archs.TRAINING if "train" in
                             kinds_naming(entry["name"]) else ())
    missing = [n for n in names if not hasattr(arch, n)]
    assert not missing, (conf["architecture"], missing)
    assert all(callable(getattr(arch, n)) for n in names if n != "REFERENCE")
    assert conf["reference"] == arch.REFERENCE
    assert "tpu9_torch" not in top_level_imports(prun.ROOT / arch.REFERENCE)
    arch.model_from_config(conf)


@pytest.mark.parametrize("value", [None, "", "no_such_arch", "../decoder",
                                   "decoder.x"])
def test_unnamed_or_missing_architecture_is_an_error(value):
    conf = tiny_conf("mistral-7b")
    if value is None:
        del conf["architecture"]
    else:
        conf["architecture"] = value
    with pytest.raises(ValueError, match="architecture"):
        archs.of(conf)


def tied_gelu_conf() -> dict:
    from portbench.tests import tied_gelu_arch
    conf = tiny_serving_conf("mistral-7b")
    conf.update(architecture="tied_gelu", hidden_act="gelu_pytorch_tanh",
                tie_word_embeddings=True, reference=tied_gelu_arch.REFERENCE)
    return conf


@pytest.fixture
def tied_gelu(monkeypatch):
    from portbench.tests import tied_gelu_arch
    monkeypatch.setitem(sys.modules, "portbench.arch.tied_gelu",
                        tied_gelu_arch)
    return tied_gelu_arch


def test_new_architecture_matches_the_port_f32(tied_gelu):
    from portbench.arch import decoder
    from tpu9_torch.models.transformer import decoder_forward
    conf = tied_gelu_conf()
    with pytest.raises(ValueError):
        decoder.model_from_config(conf)
    arch = archs.of(conf)
    assert arch is tied_gelu and conf["reference"] == arch.REFERENCE
    assert "tpu9_torch" not in top_level_imports(prun.ROOT / arch.REFERENCE)
    m = arch.model_from_config(conf)
    w = arch.draw_weights(m, SEED, "cpu", dtype=torch.float32)
    assert "lm_head" not in w
    cfg = dataclasses.replace(arch.decoder_config(conf, m),
                              dtype=torch.float32)
    assert cfg.act == "gelu" and cfg.tie_embeddings
    tokens = torch.randint(0, m.vocab_size, (1, 40),
                           generator=torch.Generator().manual_seed(3))
    port = decoder_forward(w, tokens, cfg)[0]
    mine = arch.forward_logits(m, w, tokens[0].tolist())
    assert torch.allclose(port, mine, rtol=1e-4, atol=1e-4), \
        (port - mine).abs().max()
    # the Mistral reference over the same layers (a separate head equal
    # to the tied one, SiLU) is another model
    silu = decoder.forward_logits(m, {**w, "lm_head": w["embed"].t()},
                                  tokens[0].tolist())
    assert (silu - mine).abs().max() > 1e-2


def test_new_architecture_is_served_and_judged_correct(tied_gelu):
    """Served through ``serve.run`` by the batch mix's closed loop, traced,
    with the module's counts read by the readers."""
    args = argparse.Namespace(seed=2 ** 31 + 77, seconds=2.0, trace=1)
    run = serve.run({"name": "tiny.batch", "chips": 1}, tied_gelu_conf(),
                    MIX, args, time.monotonic(), device="cpu")
    assert run.arch is tied_gelu
    assert run.checks["correct"], run.checks["numbers"]
    assert run.attempted > 0 and run.failed == 0
    assert readers.served_flops(run) > 0
