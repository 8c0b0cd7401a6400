"""The benchmark's model: its sizes from a configuration file and its
weights drawn from ``--seed`` on the device, in the dtype they are served
in, one draw a layer. The tree has the port's paths and layouts (every
projection ``[in, out]``); the program and the reference read the same
tensors."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .yardstick import Shape


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
    def shape(self) -> Shape:
        return Shape(dim=self.dim, n_layers=self.n_layers,
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


def _layer_shapes(m: Model) -> list:
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


def _views(flat: torch.Tensor, shapes: list) -> dict:
    out, at = {}, 0
    for name, shape in shapes:
        n = 1
        for s in shape:
            n *= s
        out[name] = flat[at:at + n].view(shape)
        at += n
    return out


def _draw(n: int, std: float, gen: torch.Generator, dtype,
          device) -> torch.Tensor:
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
    tree = _views(_draw(sum(a * b for _, (a, b) in io), m.init_std, gen,
                        dtype, device), io)
    tree["final_norm"] = ones.clone()
    shapes = _layer_shapes(m)
    total = sum(int(torch.Size(s).numel()) for _, s in shapes)
    tree["layers"] = []
    for _ in range(m.n_layers):
        views = _views(_draw(total, m.init_std, gen, dtype, device), shapes)
        layer = {"attn_norm": ones.clone(), "mlp_norm": ones.clone()}
        for name, t in views.items():
            if name.startswith("moe/"):
                sub = layer.setdefault("moe", {})
                key = name[len("moe/"):]
                sub[key] = t.float() if key == "router" else t
            else:
                layer[name] = t
        tree["layers"].append(layer)
    return tree
