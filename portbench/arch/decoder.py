"""The Mistral/Mixtral decoder (``"architecture": "decoder"``): RMSNorm,
rotary embeddings, grouped-query causal attention over every position,
a SiLU-gated FFN or top-k softmax-routed experts in every layer, an untied
head. Its model's sizes from a configuration file, its weights drawn from
``--seed`` on the device, in the dtype they are served in, one draw a
layer (the tree has the port's paths and layouts, every projection
``[in, out]``; the program and the reference read the same tensors), the
port's ``DecoderConfig``, its plain reference and the counts the readers
take, built from ``yardstick``'s frozen arithmetic."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import yardstick as ys
from ..reference.decoder import forward_logits  # noqa: F401 (the interface)
from ..reference.lora import steps as lora_steps  # noqa: F401

REFERENCE = "portbench/reference/decoder.py"


@dataclass(frozen=True)
class Model:
    """A configuration file's model, in the sizes the benchmark uses."""
    name: str
    dim: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    hidden_dim: int
    vocab_size: int
    norm_eps: float
    rope_theta: float
    init_std: float
    n_experts: int = 0
    top_k: int = 0

    @property
    def shape(self) -> ys.Shape:
        return ys.Shape(dim=self.dim, n_layers=self.n_layers,
                        n_heads=self.n_heads, n_kv_heads=self.n_kv_heads,
                        head_dim=self.head_dim, hidden_dim=self.hidden_dim,
                        vocab_size=self.vocab_size, n_experts=self.n_experts,
                        top_k=self.top_k)


def model_from_config(conf: dict) -> Model:
    """The sizes of a configuration file (Hugging Face ``config.json``
    keys); a head size not given is ``hidden_size / num_attention_heads``,
    as the file's ``assumed`` says. Only SiLU-gated decoders with untied
    heads and no sliding window are read."""
    if conf["hidden_act"] != "silu" or conf["tie_word_embeddings"] \
            or conf.get("sliding_window") is not None:
        raise ValueError(f"{conf['name']}: the benchmark's reference runs "
                         f"SiLU, untied, full-attention decoders only")
    heads = conf["num_attention_heads"]
    return Model(name=conf["name"], dim=conf["hidden_size"],
                 n_layers=conf["num_hidden_layers"], n_heads=heads,
                 n_kv_heads=conf["num_key_value_heads"],
                 head_dim=conf.get("head_dim",
                                   conf["hidden_size"] // heads),
                 hidden_dim=conf["intermediate_size"],
                 vocab_size=conf["vocab_size"],
                 norm_eps=conf["rms_norm_eps"],
                 rope_theta=conf["rope_theta"],
                 init_std=conf["initializer_range"],
                 n_experts=conf.get("num_local_experts", 0),
                 top_k=conf.get("num_experts_per_tok", 0))


def layer_shapes(m: Model) -> list:
    """``(path, shape)`` of one layer's matrices, in the order drawn."""
    q, kv = m.n_heads * m.head_dim, m.n_kv_heads * m.head_dim
    shapes = [("wq", (m.dim, q)), ("wk", (m.dim, kv)), ("wv", (m.dim, kv)),
              ("wo", (q, m.dim))]
    if m.n_experts:
        e = m.n_experts
        shapes += [("moe/router", (m.dim, e)),
                   ("moe/w_gate", (e, m.dim, m.hidden_dim)),
                   ("moe/w_up", (e, m.dim, m.hidden_dim)),
                   ("moe/w_down", (e, m.hidden_dim, m.dim))]
    else:
        shapes += [("w_gate", (m.dim, m.hidden_dim)),
                   ("w_up", (m.dim, m.hidden_dim)),
                   ("w_down", (m.hidden_dim, m.dim))]
    return shapes


def views(flat: torch.Tensor, shapes: list) -> dict:
    """Consecutive views of ``flat``, one of each ``(path, shape)``."""
    out, at = {}, 0
    for name, shape in shapes:
        n = 1
        for s in shape:
            n *= s
        out[name] = flat[at:at + n].view(shape)
        at += n
    return out


def draw(n: int, std: float, gen: torch.Generator, dtype,
         device) -> torch.Tensor:
    """``n`` values N(0, std) in ``dtype`` on ``device``, in one draw."""
    flat = torch.empty((n,), dtype=dtype, device=device)
    return flat.normal_(0.0, std, generator=gen)


def draw_weights(m: Model, seed: int, device, dtype=torch.bfloat16) -> dict:
    """Every weight of ``m`` from ``seed``: N(0, init_std) matrices (the
    source's ``initializer_range``) drawn in ``dtype`` on ``device``, one
    draw for the embedding and the head and one for each layer; RMSNorm
    weights 1 in f32; a MoE router rounded to ``dtype`` and held in f32,
    as the port holds it."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    ones = torch.ones((m.dim,), dtype=torch.float32, device=device)
    io = [("embed", (m.vocab_size, m.dim)), ("lm_head", (m.dim, m.vocab_size))]
    tree = views(draw(sum(a * b for _, (a, b) in io), m.init_std, gen,
                      dtype, device), io)
    tree["final_norm"] = ones.clone()
    shapes = layer_shapes(m)
    total = sum(int(torch.Size(s).numel()) for _, s in shapes)
    tree["layers"] = []
    for _ in range(m.n_layers):
        drawn = views(draw(total, m.init_std, gen, dtype, device), shapes)
        layer = {"attn_norm": ones.clone(), "mlp_norm": ones.clone()}
        for name, t in drawn.items():
            if name.startswith("moe/"):
                sub = layer.setdefault("moe", {})
                key = name[len("moe/"):]
                sub[key] = t.float() if key == "router" else t
            else:
                layer[name] = t
        tree["layers"].append(layer)
    return tree


def draw_adapters(m: Model, targets, rank: int, seed: int, device) -> dict:
    """LoRA adapters of the ``targets`` projections, as ``examples/05``
    initialises them: ``a`` N(0, 1) / rank in one draw from ``seed + 1``,
    ``b`` zero, in f32."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 1)
    shapes = {"wq": (m.dim, m.n_heads * m.head_dim),
              "wk": (m.dim, m.n_kv_heads * m.head_dim),
              "wv": (m.dim, m.n_kv_heads * m.head_dim),
              "wo": (m.n_heads * m.head_dim, m.dim)}
    rows = sum(shapes[n][0] for n in targets) * m.n_layers
    a_all = torch.empty((rows, rank), dtype=torch.float32, device=device)
    a_all.normal_(0.0, 1.0 / rank, generator=gen)
    layers, at = [], 0
    for _ in range(m.n_layers):
        entry = {}
        for n in targets:
            fan_in, out = shapes[n]
            entry[n] = {"a": a_all[at:at + fan_in],
                        "b": torch.zeros((rank, out), dtype=torch.float32,
                                         device=device)}
            at += fan_in
        layers.append(entry)
    return {"layers": layers}


def decoder_config(conf: dict, m: Model):
    """The port's ``DecoderConfig``: SiLU, no norm offset or embedding
    scale, an untied head, bf16; the experts' capacity from the
    configuration's ``engine``."""
    from tpu9_torch.models.transformer import DecoderConfig
    eng = conf["engine"]
    extra = {}
    if m.n_experts:
        extra = dict(n_experts=m.n_experts, moe_top_k=m.top_k,
                     moe_capacity_factor=eng["moe_capacity_factor"])
    return DecoderConfig(
        vocab_size=m.vocab_size, dim=m.dim, n_layers=m.n_layers,
        n_heads=m.n_heads, n_kv_heads=m.n_kv_heads, head_dim=m.head_dim,
        hidden_dim=m.hidden_dim, norm_eps=m.norm_eps,
        rope_theta=m.rope_theta, max_seq_len=conf["max_position_embeddings"],
        act="silu", norm_offset=0.0, embed_scale=False, logit_softcap=0.0,
        tie_embeddings=False, dtype=torch.bfloat16, **extra)


def window_flops(m: Model, k: int, lens) -> int:
    """A decode window's live lanes' ``k`` steps: a lane of length L
    attends L + j + 1 positions at step j, in every layer."""
    attended = sum(ys.causal_pairs(n, k) for n in lens)
    tokens = k * len(lens)
    return ys.serve_flops(m.shape, tokens, attended, tokens)


def admission_flops(m: Model, tokens: int, cached: int) -> int:
    """An admission's uncached prompt tokens with its first token's head
    row."""
    return ys.serve_flops(m.shape, tokens - cached,
                          ys.causal_pairs(cached, tokens - cached), 1)


def decode_attention_calls(m: Model, steps: int) -> int:
    """One B1 call a layer a step."""
    return steps * m.n_layers


def decode_attention_bytes(m: Model, lengths) -> int:
    """Every layer's call over the same ``lengths``: each layer attends
    every position."""
    return m.n_layers * ys.decode_attention_bytes(m.shape, lengths)


def lora_step_flops(m: Model, batch: int, t: int) -> int:
    return ys.train_flops(m.shape, batch, t, lora=True)


def train_attention_calls(m: Model, steps: int) -> int:
    """B3's forward runs twice a layer a step under remat."""
    return 2 * m.n_layers * steps


def train_attention_bound_s(m: Model, batch: int, t: int,
                            steps: int) -> float:
    """Each layer's causal attention at ``batch`` x ``t``: the forward
    twice (remat) and the backward once, each at its bound."""
    return steps * m.n_layers * (
        2 * ys.flash_bound_s(m.shape, batch, t, backward=False)
        + ys.flash_bound_s(m.shape, batch, t, backward=True))
