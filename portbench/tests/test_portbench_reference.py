"""The plain reference against the port at tiny sizes, in float32, on the
weights the benchmark draws: the dense decoder and the dropless MoE one.
(A test may import both; the reference itself imports nothing of the
port.)"""

import dataclasses
import json

import pytest
import torch

from portbench import arch as archs, run as prun
from portbench.reference import shared


def tiny_conf(name: str) -> dict:
    conf = json.loads((prun.ROOT / f"portbench/configs/{name}.json")
                      .read_text())
    # the init scaled by sqrt(4096 / 64): the logits spread as at the
    # published width, so the cells' limits apply at this size
    conf.update(hidden_size=64, intermediate_size=96, num_hidden_layers=2,
                num_attention_heads=4, num_key_value_heads=2,
                vocab_size=97, max_position_embeddings=256,
                initializer_range=0.16)
    if "num_local_experts" in conf:
        conf["num_local_experts"] = 4
        conf["engine"]["moe_capacity_factor"] = 2.0   # E / k: dropless
    return conf


@pytest.mark.parametrize("name", ["mistral-7b", "mixtral-8x7b"])
def test_reference_matches_port_f32(name):
    from tpu9_torch.models.transformer import decoder_forward
    conf = tiny_conf(name)
    arch = archs.of(conf)
    m = arch.model_from_config(conf)
    w = arch.draw_weights(m, 2 ** 31 + 5, "cpu", dtype=torch.float32)
    cfg = dataclasses.replace(arch.decoder_config(conf, m),
                              dtype=torch.float32)
    tokens = torch.randint(0, m.vocab_size, (1, 40),
                           generator=torch.Generator().manual_seed(3))
    port = decoder_forward(w, tokens, cfg)[0]
    mine = arch.forward_logits(m, w, tokens[0].tolist())
    assert torch.allclose(port, mine, rtol=1e-4, atol=1e-4), \
        (port - mine).abs().max()
    rows = arch.forward_logits(m, w, tokens[0].tolist(),
                               positions=slice(30, 40))
    assert torch.allclose(rows, mine[30:40], rtol=1e-5, atol=1e-5)


def test_fp8_weight_rounds():
    w = torch.randn(64, 32, generator=torch.Generator().manual_seed(1))
    low = shared.fp8_weight(w)
    rel = ((low - w).norm() / w.norm()).item()
    assert 0.005 < rel < 0.08
    assert torch.equal(shared.fp8_weight(low), low) or \
        (shared.fp8_weight(low) - low).abs().max() < 1e-6


def test_tf32_restored():
    before = torch.backends.cuda.matmul.allow_tf32
    with shared.f32_products():
        assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.backends.cuda.matmul.allow_tf32 == before
