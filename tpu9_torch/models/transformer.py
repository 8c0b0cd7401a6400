"""Decoder-only transformer core (counterpart of
``tpu9/models/transformer.py``).

Params are a plain dict with the JAX package's paths and layouts (every
projection stored [in, out], so the forward is ``x @ w``, or an int8
``{q, scale}`` entry, see ``ops/quant.py``); a JAX param tree converts with
:func:`tpu9_torch.bridge.params_from_jax`. A config with ``n_experts`` (the
mixtral family) has a ``"moe"`` subtree in each layer in place of
``w_gate``/``w_up``/``w_down``, and its FFN is :func:`moe.moe_ffn`.
``decoder_forward`` runs the no-cache forward, dense prefill, chunked
prefill into a dense scratch (also the dense engine's speculative verify),
dense decode, paged decode and the paged speculative verify, without
grad. KV writes go into the cache tensors in place where the JAX graphs
donated the buffer. ``decoder_core`` is the same forward under the
caller's grad mode, with per-layer activation checkpointing (``remat``):
the train step's forward (``tpu9_torch/train``). Both run the layers rank
by rank over tp rank shards (``parallel/sharding.py``), a plain tree
being one rank.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.attention import (attention, chunk_prefill_attention,
                             decode_attention, paged_attention_dispatch,
                             paged_verify_attention)
from ..ops.norms import rms_norm
from ..ops.quant import maybe_matmul, quantize_kv
from ..ops.rotary import apply_rope, rope_table
from ..parallel.sharding import (RankLayout, RankParams, gather_leaf,
                                 leaf_device, rank_layout, ranks,
                                 reduce_partials, regroup_attention,
                                 to_device)
from .moe import MoeConfig, init_moe_layer, moe_ffn

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
                 device, emit=None) -> Params:
    """Random params drawn from ``generator`` on ``device`` (the generator
    must live on that device). The draws differ from ``jax.random``; tests
    convert JAX params with ``params_from_jax`` instead. On ``"meta"``,
    with ``generator=None``, nothing is drawn: the tree of shapes and
    dtypes compile-ahead builds on (``presets.params_spec``). Each
    top-level part (``"embed"``, ``"final_norm"``, ``"lm_head"``,
    ``"layers/<i>"``) goes through ``emit(name, part)`` as soon as it is
    drawn and the tree keeps what that returns: a load that binds each
    part into rank shards never holds the whole tree."""
    emit = emit or (lambda name, part: part)
    dt = cfg.dtype

    def norm_weight():
        return torch.ones((cfg.dim,), dtype=torch.float32,
                          device=device) - cfg.norm_offset

    embed = torch.randn((cfg.vocab_size, cfg.dim), generator=generator,
                        dtype=torch.float32, device=device)
    embed = embed.mul_(0.02).to(dt)
    params: Params = {"embed": emit("embed", embed)}
    del embed
    params["final_norm"] = emit("final_norm", norm_weight())
    params["layers"] = []
    if not cfg.tie_embeddings:
        params["lm_head"] = emit("lm_head", _dense_init(
            generator, cfg.dim, cfg.vocab_size, dt, device))
    q_dim = cfg.n_heads * cfg.head_dim
    kv_dim = cfg.n_kv_heads * cfg.head_dim
    for _ in range(cfg.n_layers):
        layer = {
            "attn_norm": norm_weight(), "mlp_norm": norm_weight(),
            "wq": _dense_init(generator, cfg.dim, q_dim, dt, device),
            "wk": _dense_init(generator, cfg.dim, kv_dim, dt, device),
            "wv": _dense_init(generator, cfg.dim, kv_dim, dt, device),
            "wo": _dense_init(generator, q_dim, cfg.dim, dt, device)}
        if cfg.n_experts:
            layer["moe"] = init_moe_layer(_moe_cfg(cfg), generator, device)
        else:
            layer["w_gate"] = _dense_init(generator, cfg.dim, cfg.hidden_dim,
                                          dt, device)
            layer["w_up"] = _dense_init(generator, cfg.dim, cfg.hidden_dim,
                                        dt, device)
            layer["w_down"] = _dense_init(generator, cfg.hidden_dim, cfg.dim,
                                          dt, device)
        params["layers"].append(emit(f"layers/{len(params['layers'])}",
                                     layer))
        del layer
    return params


def _moe_cfg(cfg: DecoderConfig) -> MoeConfig:
    return MoeConfig(dim=cfg.dim, hidden_dim=cfg.hidden_dim,
                     n_experts=cfg.n_experts, top_k=cfg.moe_top_k,
                     capacity_factor=cfg.moe_capacity_factor,
                     act=cfg.act, dtype=cfg.dtype)


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


def _attention(layer: Params, h: torch.Tensor, cfg: DecoderConfig,
               positions: torch.Tensor, sin, cos,
               kv_cache: Optional[Params], layer_idx: int,
               cache_len: Optional[torch.Tensor], decode: bool):
    """Attention of the normed input ``h`` through ``wo``, without the
    residual: on a rank shard, that rank's partial sum."""
    b, t, _ = h.shape
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
        rows = torch.arange(b, device=h.device)
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
        # paged multi-token verify (speculative decoding): write all T
        # window tokens' k/v into the slots' pool blocks at once, then each
        # query attends its own absolute-position prefix. Rejected draft
        # positions keep garbage KV: attention masks it by position and
        # the next window overwrites it. In place, as the decode write
        table = kv_cache["table"]                        # [B, MB]
        k_pool = kv_cache["k"][layer_idx]                # [N, BS, KH, D]
        v_pool = kv_cache["v"][layer_idx]
        bs = k_pool.shape[1]
        pos = positions.long()                           # [B, T]
        bi = torch.gather(table, 1, pos // bs).long()
        oi = pos % bs
        if "k_scale" in kv_cache:
            k_sc = kv_cache["k_scale"][layer_idx]        # [N, BS, KH]
            v_sc = kv_cache["v_scale"][layer_idx]
            k_pool[bi, oi], k_sc[bi, oi] = quantize_kv(k)
            v_pool[bi, oi], v_sc[bi, oi] = quantize_kv(v)
            out = paged_verify_attention(q, k_pool, v_pool, table, positions,
                                         k_sc, v_sc)
        else:
            k_pool[bi, oi] = k
            v_pool[bi, oi] = v
            out = paged_verify_attention(q, k_pool, v_pool, table, positions)
    elif decode:
        # dense decode: write this token's k/v at each row's position of the
        # contiguous cache, then attend over the prefix (the ragged kernel
        # reads only ceil(len/block) blocks of each row). In place: the JAX
        # decode graph donated the cache. Positions clamp to the cache as
        # JAX's dynamic_update_slice does; the engine never passes one past.
        k_cache = kv_cache["k"][layer_idx]               # [B, S, KH, D]
        v_cache = kv_cache["v"][layer_idx]
        pos = positions[:, 0].long().clamp(0, k_cache.shape[1] - 1)
        rows = torch.arange(b, device=h.device)
        k_cache[rows, pos] = k[:, 0]
        v_cache[rows, pos] = v[:, 0]
        out = decode_attention(q, k_cache, v_cache, cache_len)
    elif cache_len is not None:
        # chunked prefill: write the chunk at each row's positions, then
        # attend over prefix + chunk with the absolute-position mask
        k_cache = kv_cache["k"][layer_idx]               # [B, S, KH, D]
        v_cache = kv_cache["v"][layer_idx]
        rows = torch.arange(b, device=h.device)[:, None]
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
    return maybe_matmul(out, layer["wo"])


def _ffn(layer: Params, h: torch.Tensor, cfg: DecoderConfig,
         rank: tuple[int, int] = (0, 1)):
    """The FFN of the normed input ``h``, without the residual; returns
    (y, the MoE aux or None). ``rank`` names a MoE rank shard's experts
    (``moe_ffn``); a dense rank shard needs none: its columns are its
    own."""
    if cfg.n_experts:
        return moe_ffn(layer["moe"], h, _moe_cfg(cfg), rank=rank)
    gated = (_act(maybe_matmul(h, layer["w_gate"]), cfg.act)
             * maybe_matmul(h, layer["w_up"]))
    return maybe_matmul(gated, layer["w_down"]), None




def lm_logits(params: Params, x: torch.Tensor,
              cfg: DecoderConfig) -> torch.Tensor:
    """The output head: final-norm hidden [..., dim] → f32 logits [..., V]
    (tied or separate head, soft-capped where the config says so). On a
    :class:`RankParams` whose layout splits the head, each rank's column
    shard gives its slice of the vocabulary, gathered along V on rank 0's
    device; a tied or unsplit head runs once, on x's device."""
    if isinstance(params, RankParams) and params.layout.head:
        devs = params.devices
        parts = [maybe_matmul(to_device(x, dev),
                              gather_leaf(shard["lm_head"], dev)).float()
                 for shard, dev in zip(params, devs)]
        logits = torch.cat([to_device(p, devs[0]) for p in parts], dim=-1)
    else:
        head = ranks(params)[0]
        if cfg.tie_embeddings:
            embed = gather_leaf(head["embed"], x.device)
            logits = (x @ embed.T.to(cfg.dtype)).float()
        else:
            logits = maybe_matmul(
                x, gather_leaf(head["lm_head"], x.device)).float()
    if cfg.logit_softcap > 0:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits


@torch.no_grad()
def decoder_forward(params: Params, tokens: torch.Tensor, cfg: DecoderConfig,
                    positions: Optional[torch.Tensor] = None,
                    kv_cache: Optional[Params] = None,
                    cache_len: Optional[torch.Tensor] = None,
                    decode: bool = False, rope=None,
                    return_hidden: bool = False,
                    return_moe_aux: bool = False):
    """:func:`decoder_core` without grad: the serving forward."""
    return decoder_core(params, tokens, cfg, positions, kv_cache, cache_len,
                        decode, rope, return_hidden, return_moe_aux)


def _layer(shards: list, x: torch.Tensor, cfg: DecoderConfig, rcfg,
           lay: RankLayout, devs: list, on: list, kvs: list, layer_idx: int,
           decode: bool):
    """One layer over the ranks: ``shards[r]`` is rank r's layer for
    ``devs[r]`` (its fsdp pieces gathered there first, here, so a
    checkpointed layer holds only the pieces), ``on[r]`` its (positions,
    sin, cos, cache_len) and ``kvs[r]`` its KV shard. Returns (x, the MoE
    aux or None)."""
    layers = regroup_attention(
        [{k: gather_leaf(v, d) for k, v in shard.items()}
         for shard, d in zip(shards, devs)], lay, devs)
    dev0 = devs[0]
    attn_ranks = range(len(devs)) if lay.attn_split else range(1)
    ffn_ranks = range(len(devs)) if lay.ffn else range(1)
    h = rms_norm(x, layers[0]["attn_norm"], cfg.norm_eps, cfg.norm_offset)
    parts = [_attention(layers[r], to_device(h, devs[r]),
                        rcfg if lay.attn_split else cfg, on[r][0], on[r][1],
                        on[r][2], kvs[r], layer_idx, on[r][3], decode)
             for r in attn_ranks]
    x = x + reduce_partials(parts, dev0)
    h = rms_norm(x, layers[0]["mlp_norm"], cfg.norm_eps, cfg.norm_offset)
    outs = [_ffn(layers[r], to_device(h, devs[r]), rcfg if lay.ffn else cfg,
                 rank=(r, len(ffn_ranks)))
            for r in ffn_ranks]
    x = x + reduce_partials([y for y, _ in outs], dev0)
    return x, outs[0][1]


def decoder_core(params: Params, tokens: torch.Tensor, cfg: DecoderConfig,
                 positions: Optional[torch.Tensor] = None,
                 kv_cache: Optional[Params] = None,
                 cache_len: Optional[torch.Tensor] = None,
                 decode: bool = False, rope=None,
                 return_hidden: bool = False,
                 return_moe_aux: bool = False, remat: bool = False):
    """Run the decoder, under whatever grad mode the caller is in (the
    train step's forward; serving calls :func:`decoder_forward`).

    - eval:           ``decoder_forward(params, tokens, cfg)`` → logits [B,T,V]
    - dense prefill:  ``kv_cache`` a contiguous [L,B,S,...] cache and no
      ``cache_len`` → (logits, kv_cache) with positions [0, T) written
    - chunked prefill: ``kv_cache`` a dense [L,B,S,...] scratch, ``positions``
      [B,C] and any ``cache_len`` → (logits, kv_cache)
    - decode:         ``decode=True``, tokens [B,1], positions [B,1],
      cache_len [B] → (logits [B,1,V], kv_cache); ``kv_cache`` is the
      contiguous cache, or a pool with ``"table"`` (and ``"k_scale"``/
      ``"v_scale"`` planes for an int8 pool)
    - paged verify:   a pool with ``"table"``, ``decode=False``, tokens and
      positions [B,T] → (logits [B,T,V], kv_cache)

    The returned cache is ``kv_cache`` itself, written in place. ``rope`` is
    an optional precomputed ``rope_table(cfg.max_seq_len, ...)`` pair.
    ``return_hidden`` returns the final-norm hidden states [B,T,dim] in
    place of the logits, so a caller can project only the rows it needs
    with :func:`lm_logits`. ``return_moe_aux`` appends the MoE balance loss
    averaged over the layers (an f32 scalar, 0 for a dense model) to what
    is returned.

    The layers run rank by rank (``parallel.sharding``): a plain tree is
    one rank, a :class:`RankParams` tp rank shards with ``kv_cache`` their
    :class:`Ranked` KV shards. The residual stream lives on rank 0's
    device. Each block is normed there once; a split block then runs on
    each rank's device and config (its q and kv heads, its FFN columns or
    experts, its KV shard), and the partial sums are reduced onto rank 0's
    device (:func:`reduce_partials`) before the residual is added: one
    reduction after ``wo`` and one after ``w_down`` or the expert combine.
    A block the layout replicates runs once, on rank 0. Routing is each
    rank's own (the same f32 arithmetic on the same input), and the MoE
    capacity follows the call's total token count on every rank. The
    logits are gathered along V (:func:`lm_logits`). Over one rank every
    copy and gather is the identity and the reduction is the partial
    itself.

    Rank shards sliced without a config (``parallel.shard_params``) are
    fitted to ``cfg`` here (``RankLayout.resolve``): where its layout
    wants other kv slices than the even ones, each layer regroups them
    from the ranks that hold them. A plain tree may hold :class:`Pieces`
    (a tree sharded by ``fsdp_specs``): it runs as one rank, gathering
    them. ``tokens`` move to rank 0's device.

    ``remat`` checkpoints each layer of the no-cache forward
    (``torch.utils.checkpoint``, non-reentrant): under grad a layer keeps
    only its input and the shards it reads, and runs again in the
    backward, the reference's remat on the layer boundary. A layer's fsdp
    pieces are gathered inside it, so the gathered weights are not kept
    but gathered again in the backward, as the reference's remat under
    GSPMD does. Only the no-cache forward carries a gradient; over rank
    shards it reaches every rank's leaves through the copies between
    devices.
    """
    if remat and kv_cache is not None:
        raise ValueError("remat applies to the no-cache forward only")
    shards = ranks(params)
    if isinstance(params, RankParams):
        devs, lay = params.devices, params.layout.resolve(cfg)
    else:
        devs, lay = [leaf_device(params["embed"])], rank_layout(cfg, 1)
    dev0 = devs[0]
    tokens = to_device(tokens, dev0)
    b, t = tokens.shape
    if positions is None:
        positions = torch.arange(t, device=tokens.device).expand(b, t)

    x = gather_leaf(shards[0]["embed"], dev0)[tokens.long()].to(cfg.dtype)
    if cfg.embed_scale:
        # a Python scalar, so no host-to-device copy (a CUDA-graph capture
        # refuses one): sqrt(dim) rounded to cfg.dtype first, as the JAX
        # code rounds it, so the product rounds as JAX's does
        x = x * embed_scale(cfg.dim, cfg.dtype)

    # the rope table must cover every cache slot: a position past it would
    # rotate wrongly (or fault), so catch the shape mismatch up front
    kvs = ranks(kv_cache) if kv_cache is not None else [None] * len(devs)
    if kvs[0] is not None and "table" not in kvs[0]:
        cache_s = kvs[0]["k"].shape[2]
        if cache_s > cfg.max_seq_len:
            raise ValueError(
                f"kv cache length {cache_s} exceeds rope table "
                f"{cfg.max_seq_len} — positions past it would alias")
    if rope is None:
        rope = rope_table(cfg.max_seq_len, cfg.head_dim, cfg.rope_theta,
                          dev0)
    rcfg = lay.rank_config(cfg)
    # what each rank reads, on its device (no copy where it is rank 0's)
    on = [tuple(to_device(a, d) for a in (positions, *rope, cache_len))
          for d in devs]

    balances = []
    for i in range(len(shards[0]["layers"])):
        layers = [shard["layers"][i] for shard in shards]
        args = (layers, x, cfg, rcfg, lay, devs, on, kvs, i, decode)
        if remat and torch.is_grad_enabled():
            x, aux = checkpoint(_layer, *args, use_reentrant=False)
        else:
            x, aux = _layer(*args)
        if aux is not None:
            balances.append(aux["balance_loss"])

    x = rms_norm(x, gather_leaf(shards[0]["final_norm"], dev0), cfg.norm_eps,
                 cfg.norm_offset)
    out = x if return_hidden else lm_logits(params, x, cfg)
    ret = (out,) if kv_cache is None else (out, kv_cache)
    if return_moe_aux:
        # summed layer by layer from zero, in the reference's order
        balance = torch.zeros((), dtype=torch.float32, device=dev0)
        for layer_balance in balances:
            balance = balance + to_device(layer_balance, dev0)
        ret += (balance / max(cfg.n_layers, 1),)
    return ret if len(ret) > 1 else out
