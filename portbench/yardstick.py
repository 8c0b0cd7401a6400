"""The benchmark's frozen arithmetic: the H100's peaks, tails over every
request, and the operations and bytes of the work the cells drive,
counted from shapes alone. Nothing here reads the program."""

from __future__ import annotations

import math
from dataclasses import dataclass

# NVIDIA's data sheet, H100 SXM5 80 GB, dense rates, at the full 700 W:
# the card's power limit is printed beside every result
BF16_FLOP_PER_S = 989e12
HBM_BYTES_PER_S = 3.35e12
BF16_BYTES = 2


def percentile(values, q: float) -> float:
    """The nearest-rank q-th percentile of ``values`` (0 < q <= 100): the
    smallest value with at least q% of the values at or below it."""
    vals = sorted(values)
    if not vals:
        raise ValueError("percentile of no values")
    rank = max(1, math.ceil(q / 100.0 * len(vals)))
    return vals[rank - 1]


@dataclass(frozen=True)
class Shape:
    """The sizes of a decoder that the counts need."""
    dim: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    hidden_dim: int
    vocab_size: int
    n_experts: int = 0
    top_k: int = 0

    @property
    def attn_weights(self) -> int:
        q = self.n_heads * self.head_dim
        kv = self.n_kv_heads * self.head_dim
        return 2 * self.dim * q + 2 * self.dim * kv

    @property
    def ffn_weights_active(self) -> int:
        """FFN weights one token goes through: the dense FFN, or its top-k
        experts and the router."""
        expert = 3 * self.dim * self.hidden_dim
        if self.n_experts:
            return self.top_k * expert + self.dim * self.n_experts
        return expert

    @property
    def head_weights(self) -> int:
        return self.dim * self.vocab_size


def attention_flops(shape: Shape, attended: int) -> int:
    """One layer's q.k and p.v products for queries that attend
    ``attended`` (query, key) pairs in all: 4 per (q head, dim, pair)."""
    return 4 * shape.n_heads * shape.head_dim * attended


def serve_flops(shape: Shape, tokens: int, attended: int,
                head_rows: int) -> int:
    """Model FLOPs of ``tokens`` tokens through every layer's active
    weights (2 a weight a token), their attention over ``attended`` pairs
    a layer, and ``head_rows`` rows through the output head."""
    per_token = shape.n_layers * (shape.attn_weights
                                  + shape.ffn_weights_active)
    return (2 * tokens * per_token
            + shape.n_layers * attention_flops(shape, attended)
            + 2 * head_rows * shape.head_weights)


def causal_pairs(offset: int, length: int) -> int:
    """(query, key) pairs of ``length`` queries at positions offset ..
    offset + length - 1, each attending every key up to its own."""
    return length * offset + length * (length + 1) // 2


def decode_attention_bytes(shape: Shape, lengths) -> int:
    """The least bytes one decode attention call over a batch moves: each
    cached k and v vector of every attended position read once (bf16),
    each query read once and each output written once. ``lengths`` are
    the positions each live sequence attends in the call."""
    kv_vec = shape.n_kv_heads * shape.head_dim * BF16_BYTES
    q_vec = shape.n_heads * shape.head_dim * BF16_BYTES
    return sum(2 * n * kv_vec + 2 * q_vec for n in lengths)


def train_flops(shape: Shape, batch: int, t: int, lora: bool) -> int:
    """Model FLOPs of one train step on ``batch`` x ``t`` tokens: the
    forward (2 a weight a token, 4 per (q head, dim, causal pair), the
    head), the activations' gradients (the same again, twice for the
    attention's pairs) and the weights' gradients (of the merged
    attention weights for LoRA, of every weight but the embedding's
    gather for a full step). The recompute of a checkpointed layer is
    hardware work, not model work, and is not counted; nor are the
    adapters' own products and the elementwise passes."""
    n = batch * t
    attn = attention_flops(shape, batch * causal_pairs(0, t))
    layer_w = shape.attn_weights + shape.ffn_weights_active
    layers = shape.n_layers * (2 * n * layer_w + attn)
    forward = layers + 2 * n * shape.head_weights
    dx = layers + shape.n_layers * attn + 2 * n * shape.head_weights
    if lora:
        dw = shape.n_layers * 2 * n * shape.attn_weights
    else:
        dw = shape.n_layers * 2 * n * layer_w + 2 * n * shape.head_weights
    return forward + dx + dw


def flash_bound_s(shape: Shape, batch: int, t: int, backward: bool) -> float:
    """The least time of the causal flash attention of one layer at
    ``batch`` x ``t`` (forward, or its backward): the larger of its
    products at the bf16 peak and its bytes at the HBM peak. Forward:
    q, k, v read and out written, 4 per (q head, dim, pair). Backward:
    q, k, v, out, d_out read and dq, dk, dv written, the forward's
    product of the scores again and four more (dv, dp, dq, dk): 10 per
    (q head, dim, pair)."""
    pairs = batch * causal_pairs(0, t)
    q = batch * t * shape.n_heads * shape.head_dim * BF16_BYTES
    kv = batch * t * shape.n_kv_heads * shape.head_dim * BF16_BYTES
    if backward:
        flops = 10 * shape.n_heads * shape.head_dim * pairs
        nbytes = 4 * q + 4 * kv
    else:
        flops = attention_flops(shape, pairs)
        nbytes = q + 2 * kv + q
    return max(flops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S)
