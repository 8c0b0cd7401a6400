"""A test-only architecture that ``portbench/arch/decoder.py`` refuses: the
dense decoder with a GELU-gated FFN (``"hidden_act":
"gelu_pytorch_tanh"``) and an output head tied to the embedding
(``"tie_word_embeddings": true``), two switches the port's
``DecoderConfig`` has. It gives the serving interface of
``portbench/arch`` from its own file and its own reference
(``tied_gelu_reference.py``); the tests register it as
``portbench.arch.tied_gelu``, where a file dropped into ``portbench/arch/``
would be found."""

from __future__ import annotations

import dataclasses

import torch

from portbench.arch import decoder as base
from portbench.tests.tied_gelu_reference import forward_logits  # noqa: F401

REFERENCE = "portbench/tests/tied_gelu_reference.py"

# the counts do not see the activation; the tied head is as many weights
# as a separate one
window_flops = base.window_flops
admission_flops = base.admission_flops
decode_attention_calls = base.decode_attention_calls
decode_attention_bytes = base.decode_attention_bytes


def model_from_config(conf: dict) -> base.Model:
    if conf["hidden_act"] != "gelu_pytorch_tanh" \
            or not conf["tie_word_embeddings"] \
            or conf.get("sliding_window") is not None \
            or conf.get("num_local_experts"):
        raise ValueError(f"{conf['name']}: tied_gelu runs dense, tied, "
                         f"GELU-gated, full-attention decoders only")
    return base.model_from_config({**conf, "hidden_act": "silu",
                                   "tie_word_embeddings": False})


def draw_weights(m: base.Model, seed: int, device,
                 dtype=torch.bfloat16) -> dict:
    """As ``arch.decoder`` draws them, with no head: one draw for the
    embedding and one for each layer."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    ones = torch.ones((m.dim,), dtype=torch.float32, device=device)
    embed = base.draw(m.vocab_size * m.dim, m.init_std, gen, dtype, device)
    tree = {"embed": embed.view(m.vocab_size, m.dim),
            "final_norm": ones.clone(), "layers": []}
    shapes = base.layer_shapes(m)
    total = sum(int(torch.Size(s).numel()) for _, s in shapes)
    for _ in range(m.n_layers):
        layer = base.views(base.draw(total, m.init_std, gen, dtype, device),
                           shapes)
        tree["layers"].append({"attn_norm": ones.clone(),
                               "mlp_norm": ones.clone(), **layer})
    return tree


def decoder_config(conf: dict, m: base.Model):
    return dataclasses.replace(base.decoder_config(conf, m), act="gelu",
                               tie_embeddings=True)
