"""Weight-only int8 quantization and the int8 KV cache (counterpart of
``tpu9/ops/quant.py``).

Projection weights are stored int8 with one f32 scale per output channel;
KV vectors are stored int8 with one f32 absmax scale per (token, head)
vector. Both quantizers round half to even, as ``jnp.round`` does, so the
port's int8 values equal the JAX package's bit for bit. Per-expert MoE
stacks are not in this slice (ROADMAP queue A10).
"""

from __future__ import annotations

from typing import Any

import torch

Params = dict[str, Any]

# decoder projection weights worth quantizing (2-D, large)
_TARGETS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "lm_head")

# quantization modes the serving stack understands; every knob's
# validation funnels through validate_quant_mode
SUPPORTED_MODES = ("int8",)


def validate_quant_mode(mode, what: str = "quantize") -> str:
    """Normalize a quantization-mode knob: ``None``/``""`` → ``""`` (off),
    a supported mode passes through, anything else raises ``ValueError``."""
    if mode in (None, ""):
        return ""
    if mode not in SUPPORTED_MODES:
        raise ValueError(f"unknown {what} mode {mode!r} "
                         f"(supported: {', '.join(SUPPORTED_MODES)})")
    return mode


def _quantize_along(w: torch.Tensor, axis: int) -> dict:
    """Symmetric absmax int8 with per-output-channel scales along ``axis``."""
    wf = w.float()
    scale = wf.abs().amax(dim=axis, keepdim=True) / 127.0
    scale = scale.clamp_min(1e-8)
    q = torch.round(wf / scale).clamp(-127, 127).to(torch.int8)
    return {"q": q, "scale": scale}


def quantize_weight(w: torch.Tensor) -> dict:
    """[in, out] → int8 values + f32 per-output-channel scales [1, out]."""
    return _quantize_along(w, axis=0)


def dequantize_weight(entry: dict, dtype=torch.bfloat16) -> torch.Tensor:
    return (entry["q"].float() * entry["scale"]).to(dtype)


def quantized_matmul(x: torch.Tensor, entry: dict) -> torch.Tensor:
    """``x @ dequant(w)`` in the JAX order: x cast to bf16 (whatever x's
    dtype), the int8 weight as a bf16 operand, the sum in f32, the scale
    applied to the f32 product, the result cast to x's dtype.

    On the CPU the product is an f32 matmul of the bf16-rounded operands:
    each product of two bf16 values is exact in f32, so this is the JAX
    dot with ``preferred_element_type=f32``. On the card it is one bf16
    GEMM: cuBLAS sums in f32 but writes its output in bf16, so the sum is
    rounded to bf16 once, before the scale. Either way the weight's bf16
    copy is made on every call (a W8A16 kernel is later work)."""
    xb = x.to(torch.bfloat16)
    wb = entry["q"].to(torch.bfloat16)
    if x.is_cuda:
        acc = torch.matmul(xb, wb).float()
    else:
        acc = torch.matmul(xb.float(), wb.float())
    return (acc * entry["scale"]).to(x.dtype)


def is_quantized_entry(w) -> bool:
    """True for a ``{q, scale}`` pair this module produced."""
    return isinstance(w, dict) and "q" in w


def maybe_matmul(x: torch.Tensor, w) -> torch.Tensor:
    """Matmul that takes a plain weight or a quantized entry, so the
    decoder runs on mixed trees."""
    if is_quantized_entry(w):
        return quantized_matmul(x, w)
    return x @ w


def _no_moe() -> NotImplementedError:
    return NotImplementedError("per-expert int8 MoE: ROADMAP queue A10")


def quantize_decoder(params: Params) -> Params:
    """Quantize a decoder tree's 2-D projections (norms and embeddings stay
    in full precision; an embedding is a gather, not a matmul). Idempotent:
    entries already quantized pass through untouched."""
    out = dict(params)
    if "lm_head" in params and not is_quantized_entry(params["lm_head"]):
        out["lm_head"] = quantize_weight(params["lm_head"])
    out["layers"] = []
    for layer in params["layers"]:
        if "moe" in layer:
            raise _no_moe()
        new_layer = dict(layer)
        for name in _TARGETS:
            if name in layer and getattr(layer[name], "ndim", 0) == 2:
                new_layer[name] = quantize_weight(layer[name])
        out["layers"].append(new_layer)
    return out


def _random_quantized(gen: torch.Generator, in_dim: int, out_dim: int,
                      device) -> dict:
    """A random int8 entry drawn straight on ``device``, with scales that
    give the dense init's magnitude: int8 values ~U[-127, 127] have a std
    of ~73, so scale ≈ std/73 with std = sqrt(2/(in+out)), jittered by
    U[0.8, 1.2]. No full-precision copy of the weight is ever made."""
    q = torch.randint(-127, 128, (in_dim, out_dim), generator=gen,
                      dtype=torch.int8, device=device)
    std = (2.0 / (in_dim + out_dim)) ** 0.5
    scale = torch.rand((1, out_dim), generator=gen, dtype=torch.float32,
                       device=device)
    return {"q": q, "scale": scale.mul_(0.4).add_(0.8).mul_(std / 73.0)}


def init_quantized_decoder(cfg, generator: torch.Generator, device) -> Params:
    """An ``init_decoder``-shaped tree with int8 projections drawn on
    ``device`` from ``generator`` (which must live there): the paths,
    shapes and dtypes of the JAX ``init_quantized_decoder``. The draws
    differ from ``jax.random``; tests carry JAX trees over with
    ``params_from_jax`` instead."""
    if cfg.n_experts:
        raise _no_moe()

    def norm_weight():
        return torch.ones((cfg.dim,), dtype=torch.float32,
                          device=device) - cfg.norm_offset

    embed = torch.randn((cfg.vocab_size, cfg.dim), generator=generator,
                        dtype=torch.float32, device=device)
    params: Params = {"embed": embed.mul_(0.02).to(cfg.dtype),
                      "final_norm": norm_weight(), "layers": []}
    del embed
    if not cfg.tie_embeddings:
        params["lm_head"] = _random_quantized(generator, cfg.dim,
                                              cfg.vocab_size, device)
    q_dim = cfg.n_heads * cfg.head_dim
    kv_dim = cfg.n_kv_heads * cfg.head_dim
    for _ in range(cfg.n_layers):
        params["layers"].append({
            "attn_norm": norm_weight(), "mlp_norm": norm_weight(),
            "wq": _random_quantized(generator, cfg.dim, q_dim, device),
            "wk": _random_quantized(generator, cfg.dim, kv_dim, device),
            "wv": _random_quantized(generator, cfg.dim, kv_dim, device),
            "wo": _random_quantized(generator, q_dim, cfg.dim, device),
            "w_gate": _random_quantized(generator, cfg.dim, cfg.hidden_dim,
                                        device),
            "w_up": _random_quantized(generator, cfg.dim, cfg.hidden_dim,
                                      device),
            "w_down": _random_quantized(generator, cfg.hidden_dim, cfg.dim,
                                        device)})
    return params


# ---------------------------------------------------------------------------
# int8 KV cache (paged pool)
# ---------------------------------------------------------------------------

def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``x [..., D]`` → ``(int8 [..., D], f32 scales [...])``, one
    symmetric absmax scale per (token, head) vector, so writing a new
    token never requantizes the blocks already in the pool."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1).clamp_min(1e-8) / 127.0
    q = torch.round(xf / scale[..., None]).clamp(-127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype=torch.bfloat16) -> torch.Tensor:
    """Inverse of :func:`quantize_kv` (the scale broadcasts over D)."""
    return (q.float() * scale[..., None]).to(dtype)


def quantized_bytes(params: Params) -> int:
    """Device bytes of a (possibly mixed) param tree at its stored dtypes."""
    def leaves(tree):
        if isinstance(tree, dict):
            for v in tree.values():
                yield from leaves(v)
        elif isinstance(tree, (list, tuple)):
            for v in tree:
                yield from leaves(v)
        else:
            yield tree
    return sum(t.numel() * t.element_size() for t in leaves(params))
