"""The engine's device computations (counterpart of
``tpu9/serving/graphs.py``): the decode window; for the paged engine one
chunked-prefill step, the scratch → pool block splice, the pool → scratch
prefix gather and the fused admission group; for the dense engine the
bucketed prefill and the splice of its KV into a slot's lanes.

The JAX package jit-compiles each of these into one XLA graph and donates
the pool and scratch buffers; here they run eagerly and write the pool and
scratch in place. A decode window is a Python loop of k steps whose sampled
tokens stay on the device as one [k, B] tensor, so the host syncs once per
window. (Capturing them as CUDA graphs is later perf work.)
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..models.transformer import decoder_forward, init_kv_cache, lm_logits
from ..ops.quant import dequantize_kv, quantize_kv
from ..ops.rotary import rope_table
from ..ops.sampling import sample_logits

Params = dict[str, Any]


class GraphFactory:
    """The engine's computations for one (model, engine-config) pair.
    ``chunk`` is the validated chunked-prefill length (0 = dense mode)."""

    def __init__(self, cfg, ecfg, chunk: int, device):
        self.cfg = cfg
        self.ecfg = ecfg
        self.chunk = chunk
        self.device = device
        # computed once per engine (the JAX graphs constant-fold it)
        self.rope = rope_table(cfg.max_seq_len, cfg.head_dim, cfg.rope_theta,
                               device)

    # -- decode window -------------------------------------------------------

    def build_decode(self, k: int = 1):
        cfg, ecfg, rope = self.cfg, self.ecfg, self.rope

        @torch.no_grad()
        def decode(params, kv_cache, last_token, cache_len, active,
                   generator):
            """k decode steps for the whole batch. Returns the new
            (last_token [B,1], kv_cache, cache_len [B], toks [k, B]); the
            pool in ``kv_cache`` is written in place."""
            toks = []
            step_len = active.to(torch.int32)
            for _ in range(k):
                positions = cache_len[:, None]      # next position per slot
                logits, kv_cache = decoder_forward(
                    params, last_token, cfg, positions=positions,
                    kv_cache=kv_cache, cache_len=cache_len + 1, decode=True,
                    rope=rope)
                next_tok = sample_logits(logits[:, -1], generator,
                                         temperature=ecfg.temperature,
                                         top_k=ecfg.top_k, top_p=ecfg.top_p)
                last_token = next_tok[:, None].to(torch.int32)
                # only live slots advance; idle lanes stay parked at 0
                cache_len = cache_len + step_len
                toks.append(last_token[:, 0])
            return last_token, kv_cache, cache_len, torch.stack(toks)

        return decode

    # -- dense prefill -------------------------------------------------------

    def prefill_fn(self, bucket: int):
        """Prefill of one prompt padded to ``bucket`` tokens into a fresh
        batch-1 cache of ``bucket`` positions (the flash kernel at aligned
        buckets). Returns the logits at the last real token and the cache
        [L, 1, bucket, KH, D]. Only that row goes through the output head:
        the JAX graph computes every row's logits and slices one, which at
        bucket 2048 would be a [2048, vocab] f32 product made to keep one
        row."""
        cfg, rope, device = self.cfg, self.rope, self.device

        @torch.no_grad()
        def prefill(params, tokens, length: int):
            cache = init_kv_cache(cfg, 1, bucket, device=device)
            hidden, cache = decoder_forward(params, tokens, cfg,
                                            kv_cache=cache, rope=rope,
                                            return_hidden=True)
            last = lm_logits(params, hidden[:, length - 1], cfg)[0]
            return last, cache

        return prefill

    def dense_splice_fn(self, bucket: int):
        """Copy of a prefill's [L, 1, bucket, ...] k/v into one slot's lanes
        of the dense [L, B, S, ...] cache, in place (the JAX splice graph
        donated the cache). Returns the cache's k and v."""
        @torch.no_grad()
        def splice(k, v, ck, cv, slot: int):
            k[:, slot, :bucket] = ck[:, 0, :bucket]
            v[:, slot, :bucket] = cv[:, 0, :bucket]
            return k, v

        return splice

    # -- paged chunked prefill -----------------------------------------------

    @torch.no_grad()
    def traced_chunk_step(self, params, scratch, tok_row, offset: int,
                          last_idx: int):
        """Prefill one C-token chunk into the scratch at ``offset`` and
        return the logits at ``last_idx`` (shared by the single-chunk and
        fused-group admission paths)."""
        c = self.chunk
        positions = offset + torch.arange(c, device=self.device)[None, :]
        logits, scratch = decoder_forward(
            params, tok_row[None, :], self.cfg, positions=positions,
            kv_cache=scratch, cache_len=offset + c, rope=self.rope)
        return logits[0, last_idx], scratch

    @torch.no_grad()
    def traced_splice(self, pool, scratch_k, scratch_v, offset: int, phys):
        """Block copy: scratch positions [offset, offset+C) → pool blocks
        phys[0..C/BS). An int8 pool quantizes each block on the way in, its
        per-vector scales landing in the scale planes at the same physical
        index. In place: the JAX splice graph donated the pool."""
        bs = self.ecfg.kv_block_size
        for j in range(self.chunk // bs):
            start = offset + j * bs
            blk = int(phys[j])
            for name, scratch in (("k", scratch_k), ("v", scratch_v)):
                block = scratch[:, 0, start:start + bs]     # [L,BS,KH,D]
                if "k_scale" in pool:
                    block, pool[f"{name}_scale"][:, blk] = quantize_kv(block)
                pool[name][:, blk] = block
        return pool

    def gather_fn(self):
        """Densify one slot's table row into the scratch (prefix reuse: the
        cached blocks become the prefix chunk prefill attends). An int8
        pool is dequantized here, in f32, then cast to the model dtype: the
        scratch always holds the model dtype. The row's final, always-trash
        column is sliced off so the scratch keeps its [L, 1, S, KH, D]
        shape. Writes the scratch in place."""
        s = self.ecfg.max_seq_len

        @torch.no_grad()
        def gather(pool, row, scratch):
            idx = torch.from_numpy(np.asarray(row, dtype=np.int64)).to(
                self.device)
            for name in ("k", "v"):
                g = pool[name][:, idx]                    # [L, MB, BS, KH, D]
                if f"{name}_scale" in pool:
                    g = dequantize_kv(g, pool[f"{name}_scale"][:, idx],
                                      scratch[name].dtype)
                l_, mb, bs, kh, d = g.shape
                scratch[name][:, 0] = g.reshape(l_, mb * bs, kh, d)[:, :s]
            return scratch

        return gather

    def chunk_group_fn(self, g: int):
        """Fused admission: ``g`` chunks, each prefilled into the scratch
        and spliced into the pool. toks [g, C] on the device; offsets,
        last_idxs [g] and phys [g, C/BS] on the host. Returns (pool,
        scratch, the final chunk's last-token logits)."""
        def group(params, pool, scratch, toks, offsets, last_idxs, phys):
            last = None
            for i in range(g):
                last, scratch = self.traced_chunk_step(
                    params, scratch, toks[i], int(offsets[i]),
                    int(last_idxs[i]))
                pool = self.traced_splice(pool, scratch["k"], scratch["v"],
                                          int(offsets[i]), phys[i])
            return pool, scratch, last

        return group
