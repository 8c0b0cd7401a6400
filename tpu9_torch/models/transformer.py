"""Decoder-only transformer core (counterpart of
``tpu9/models/transformer.py``).

Params are a plain dict with the JAX package's paths and layouts (every
projection stored [in, out], so the forward is ``x @ w``, or an int8
``{q, scale}`` entry, see ``ops/quant.py``); a JAX param tree converts with
:func:`tpu9_torch.bridge.params_from_jax`. ``decoder_forward``
runs the no-cache forward, dense prefill, chunked prefill into a dense
scratch, dense decode and paged decode. KV writes go into the cache tensors
in place where the JAX graphs donated the buffer.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.nn.functional as F

from ..ops.attention import (attention, chunk_prefill_attention,
                             decode_attention, paged_attention_dispatch)
from ..ops.norms import rms_norm
from ..ops.quant import maybe_matmul, quantize_kv
from ..ops.rotary import apply_rope, rope_table

Params = dict[str, Any]


@dataclass(frozen=True)
class DecoderConfig:
    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    head_dim: int = 128
    hidden_dim: int = 14336
    norm_eps: float = 1e-5
    rope_theta: float = 500000.0
    max_seq_len: int = 8192
    # family switches
    act: str = "silu"              # silu (llama) | gelu (gemma)
    norm_offset: float = 0.0       # 1.0 for gemma's (1+w) RMSNorm
    embed_scale: bool = False      # gemma scales embeddings by sqrt(dim)
    logit_softcap: float = 0.0     # gemma-2 style; 0 = off
    tie_embeddings: bool = False   # output head = embed^T
    # sparse-MoE FFN (mixtral family): n_experts 0 = dense
    n_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    dtype: torch.dtype = torch.bfloat16

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads


def _dense_init(gen: torch.Generator, in_dim: int, out_dim: int, dtype,
                device) -> torch.Tensor:
    scale = (2.0 / (in_dim + out_dim)) ** 0.5
    w = torch.randn((in_dim, out_dim), generator=gen, dtype=torch.float32,
                    device=device)
    return w.mul_(scale).to(dtype)


def init_decoder(cfg: DecoderConfig, generator: torch.Generator,
                 device) -> Params:
    """Random params drawn from ``generator`` on ``device`` (the generator
    must live on that device). The draws differ from ``jax.random``; tests
    convert JAX params with ``params_from_jax`` instead."""
    if cfg.n_experts:
        raise NotImplementedError("MoE decoder: ROADMAP queue A10")
    dt = cfg.dtype

    def norm_weight():
        return torch.ones((cfg.dim,), dtype=torch.float32,
                          device=device) - cfg.norm_offset

    embed = torch.randn((cfg.vocab_size, cfg.dim), generator=generator,
                        dtype=torch.float32, device=device)
    params: Params = {"embed": embed.mul_(0.02).to(dt),
                      "final_norm": norm_weight(), "layers": []}
    del embed
    if not cfg.tie_embeddings:
        params["lm_head"] = _dense_init(generator, cfg.dim, cfg.vocab_size,
                                        dt, device)
    q_dim = cfg.n_heads * cfg.head_dim
    kv_dim = cfg.n_kv_heads * cfg.head_dim
    for _ in range(cfg.n_layers):
        params["layers"].append({
            "attn_norm": norm_weight(), "mlp_norm": norm_weight(),
            "wq": _dense_init(generator, cfg.dim, q_dim, dt, device),
            "wk": _dense_init(generator, cfg.dim, kv_dim, dt, device),
            "wv": _dense_init(generator, cfg.dim, kv_dim, dt, device),
            "wo": _dense_init(generator, q_dim, cfg.dim, dt, device),
            "w_gate": _dense_init(generator, cfg.dim, cfg.hidden_dim, dt,
                                  device),
            "w_up": _dense_init(generator, cfg.dim, cfg.hidden_dim, dt,
                                device),
            "w_down": _dense_init(generator, cfg.hidden_dim, cfg.dim, dt,
                                  device)})
    return params


def init_kv_cache(cfg: DecoderConfig, batch: int, max_len: int = 0,
                  dtype=None, device=None) -> Params:
    """Contiguous per-sequence KV cache: k/v [L, B, S, KH, D]."""
    s = max_len or cfg.max_seq_len
    shape = (cfg.n_layers, batch, s, cfg.n_kv_heads, cfg.head_dim)
    dt = dtype or cfg.dtype
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


@functools.cache
def embed_scale(dim: int, dtype: torch.dtype) -> float:
    """sqrt(dim) rounded to ``dtype``, as a Python float. Times a tensor
    of ``dtype`` it gives JAX's ``x * jnp.asarray(dim ** 0.5, dtype)``:
    the product of two bf16 values is exact in f32 and rounds once."""
    return torch.full((), dim ** 0.5, dtype=dtype).item()


def _act(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")
    raise ValueError(kind)


def _attn_block(layer: Params, x: torch.Tensor, cfg: DecoderConfig,
                positions: torch.Tensor, sin, cos,
                kv_cache: Optional[Params], layer_idx: int,
                cache_len: Optional[torch.Tensor], decode: bool):
    b, t, _ = x.shape
    h = rms_norm(x, layer["attn_norm"], cfg.norm_eps, cfg.norm_offset)
    q = maybe_matmul(h, layer["wq"]).reshape(b, t, cfg.n_heads, cfg.head_dim)
    k = maybe_matmul(h, layer["wk"]).reshape(b, t, cfg.n_kv_heads, cfg.head_dim)
    v = maybe_matmul(h, layer["wv"]).reshape(b, t, cfg.n_kv_heads, cfg.head_dim)
    q = apply_rope(q, positions, sin, cos)
    k = apply_rope(k, positions, sin, cos)

    if kv_cache is None:
        out = attention(q, k, v, causal=True)
    elif decode and "table" in kv_cache:
        # paged decode: write this token's k/v into the slot's physical
        # pool block, then block-table paged attention over the prefix.
        # The pool [N_BLOCKS, BS, KH, D] is shared by every sequence. An
        # int8 pool ("k_scale" present) quantizes the write per (token,
        # head) vector and the kernel dequantizes after its loads.
        table = kv_cache["table"]                        # [B, MB]
        k_pool = kv_cache["k"][layer_idx]                # [N, BS, KH, D]
        v_pool = kv_cache["v"][layer_idx]
        bs = k_pool.shape[1]
        pos = positions[:, 0].long()                     # [B]
        rows = torch.arange(b, device=x.device)
        bi = table[rows, pos // bs].long()
        oi = pos % bs
        # in place: the JAX decode graph donated the pool to this write
        if "k_scale" in kv_cache:
            k_sc = kv_cache["k_scale"][layer_idx]        # [N, BS, KH]
            v_sc = kv_cache["v_scale"][layer_idx]
            k_pool[bi, oi], k_sc[bi, oi] = quantize_kv(k[:, 0])
            v_pool[bi, oi], v_sc[bi, oi] = quantize_kv(v[:, 0])
            out = paged_attention_dispatch(q, k_pool, v_pool, table,
                                           cache_len, k_sc, v_sc)
        else:
            k_pool[bi, oi] = k[:, 0]
            v_pool[bi, oi] = v[:, 0]
            out = paged_attention_dispatch(q, k_pool, v_pool, table,
                                           cache_len)
    elif "table" in kv_cache:
        raise NotImplementedError(
            "paged multi-token verify (speculative decoding): ROADMAP queue A6")
    elif decode:
        # dense decode: write this token's k/v at each row's position of the
        # contiguous cache, then attend over the prefix (the ragged kernel
        # reads only ceil(len/block) blocks of each row). In place: the JAX
        # decode graph donated the cache. Positions clamp to the cache as
        # JAX's dynamic_update_slice does; the engine never passes one past.
        k_cache = kv_cache["k"][layer_idx]               # [B, S, KH, D]
        v_cache = kv_cache["v"][layer_idx]
        pos = positions[:, 0].long().clamp(0, k_cache.shape[1] - 1)
        rows = torch.arange(b, device=x.device)
        k_cache[rows, pos] = k[:, 0]
        v_cache[rows, pos] = v[:, 0]
        out = decode_attention(q, k_cache, v_cache, cache_len)
    elif cache_len is not None:
        # chunked prefill: write the chunk at each row's positions, then
        # attend over prefix + chunk with the absolute-position mask
        k_cache = kv_cache["k"][layer_idx]               # [B, S, KH, D]
        v_cache = kv_cache["v"][layer_idx]
        rows = torch.arange(b, device=x.device)[:, None]
        idx = positions.long()
        # in place: the JAX chunk graph donated the scratch to this write
        k_cache[rows, idx] = k
        v_cache[rows, idx] = v
        out = chunk_prefill_attention(q, k_cache, v_cache, positions)
    else:
        # dense prefill: write [0, t) of the given cache (in place, as the
        # JAX prefill graph's update), then causal attention within the
        # prompt: the flash kernel at block-aligned t
        kv_cache["k"][layer_idx][:, :t] = k
        kv_cache["v"][layer_idx][:, :t] = v
        out = attention(q, k, v, causal=True)

    out = out.reshape(b, t, cfg.n_heads * cfg.head_dim)
    return x + maybe_matmul(out, layer["wo"])


def _mlp_block(layer: Params, x: torch.Tensor, cfg: DecoderConfig):
    h = rms_norm(x, layer["mlp_norm"], cfg.norm_eps, cfg.norm_offset)
    gated = (_act(maybe_matmul(h, layer["w_gate"]), cfg.act)
             * maybe_matmul(h, layer["w_up"]))
    return x + maybe_matmul(gated, layer["w_down"])


def lm_logits(params: Params, x: torch.Tensor,
              cfg: DecoderConfig) -> torch.Tensor:
    """The output head: final-norm hidden [..., dim] → f32 logits [..., V]
    (tied or separate head, soft-capped where the config says so)."""
    if cfg.tie_embeddings:
        logits = (x @ params["embed"].T.to(cfg.dtype)).float()
    else:
        logits = maybe_matmul(x, params["lm_head"]).float()
    if cfg.logit_softcap > 0:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits


@torch.no_grad()
def decoder_forward(params: Params, tokens: torch.Tensor, cfg: DecoderConfig,
                    positions: Optional[torch.Tensor] = None,
                    kv_cache: Optional[Params] = None,
                    cache_len: Optional[torch.Tensor] = None,
                    decode: bool = False, rope=None,
                    return_hidden: bool = False):
    """Run the decoder.

    - eval:           ``decoder_forward(params, tokens, cfg)`` → logits [B,T,V]
    - dense prefill:  ``kv_cache`` a contiguous [L,B,S,...] cache and no
      ``cache_len`` → (logits, kv_cache) with positions [0, T) written
    - chunked prefill: ``kv_cache`` a dense [L,B,S,...] scratch, ``positions``
      [B,C] and any ``cache_len`` → (logits, kv_cache)
    - decode:         ``decode=True``, tokens [B,1], positions [B,1],
      cache_len [B] → (logits [B,1,V], kv_cache); ``kv_cache`` is the
      contiguous cache, or a pool with ``"table"`` (and ``"k_scale"``/
      ``"v_scale"`` planes for an int8 pool)

    The returned cache is ``kv_cache`` itself, written in place. ``rope`` is
    an optional precomputed ``rope_table(cfg.max_seq_len, ...)`` pair.
    ``return_hidden`` returns the final-norm hidden states [B,T,dim] in
    place of the logits, so a caller can project only the rows it needs
    with :func:`lm_logits`.
    """
    b, t = tokens.shape
    if positions is None:
        positions = torch.arange(t, device=tokens.device).expand(b, t)

    x = params["embed"][tokens.long()].to(cfg.dtype)
    if cfg.embed_scale:
        # a Python scalar, so no host-to-device copy (a CUDA-graph capture
        # refuses one): sqrt(dim) rounded to cfg.dtype first, as the JAX
        # code rounds it, so the product rounds as JAX's does
        x = x * embed_scale(cfg.dim, cfg.dtype)

    # the rope table must cover every cache slot: a position past it would
    # rotate wrongly (or fault), so catch the shape mismatch up front
    rope_len = cfg.max_seq_len
    if kv_cache is not None and "table" not in kv_cache:
        cache_s = kv_cache["k"].shape[2]
        if cache_s > rope_len:
            raise ValueError(
                f"kv cache length {cache_s} exceeds rope table "
                f"{rope_len} — positions past it would alias")
    if rope is None:
        rope = rope_table(rope_len, cfg.head_dim, cfg.rope_theta, x.device)
    sin, cos = rope

    for i, layer in enumerate(params["layers"]):
        x = _attn_block(layer, x, cfg, positions, sin, cos, kv_cache, i,
                        cache_len, decode)
        x = _mlp_block(layer, x, cfg)

    x = rms_norm(x, params["final_norm"], cfg.norm_eps, cfg.norm_offset)
    out = x if return_hidden else lm_logits(params, x, cfg)
    if kv_cache is not None:
        return out, kv_cache
    return out
