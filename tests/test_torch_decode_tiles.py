"""The numerics of the Hopper decode kernels
(``tpu9_torch/csrc/paged_decode_attention.cu``) on the CPU, where the
kernels cannot run.

``kernel_model`` repeats the split kernel's arithmetic in PyTorch: each
split of ``split_plan``'s positions walked in 64-position tiles; the
scores as bf16 q . bf16 k products summed in f32, then multiplied by the
f32 ``D^-0.5 * log2(e)`` (and, for the int8 pool, by the token's ``s_k``);
keys past the length masked to -1e30; a base-2 online softmax with f32
running max, sum and accumulators; each probability (times the token's
``s_v`` for the int8 pool) entering the PV product as two bf16 parts,
``P_hi = bf16(p)`` and ``P_lo = bf16(p - P_hi)``, each part's product
accumulated apart and the two added once at the end; the split's max
written in natural-log units; then ``merge_partials`` (the combine
kernel's twin) and one rounding to bf16.

On inputs made from a seed at gemma-2b's heads (8 q heads over 1 kv head,
GQA 8), D = 256, blocks of 128 and 256 positions and lengths at and around
the 64-position tiles, the model stays within ``chip_smoke.check_twin``'s
rule (one bf16 ulp of the reference plus 1e-4) of the port's twin, as the
card computes it, and of the JAX Pallas kernel in interpret mode. So the
design's rounding fits the check the card holds it to, unchanged. With P
rounded once to bf16 instead, the same cases leave that rule.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tpu9.ops import paged_attention as jpaged
from tpu9.ops import quant as jquant
from tpu9_torch.ops import attention as tattn
from tpu9_torch.ops import paged_attention as tpaged

torch.set_num_threads(2)

TILE = 64
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
NEG_INF = -1e30
Q_HEADS, KV_HEADS, D = 8, 1, 256
LENS = [1, 63, 64, 65, 129, 300, 513, 640]


def kernel_model(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 lens: list[int], split_tokens: int,
                 k_scale: torch.Tensor = None, v_scale: torch.Tensor = None,
                 split_p: bool = True) -> torch.Tensor:
    """The split and combine kernels' arithmetic. q [B,1,QH,D] holding bf16
    values; k, v [B,S,KH,D] the densified cache, holding bf16 values, or
    int8 values with k/v_scale [B,S,KH]. ``split_p=False`` rounds P to bf16
    once (the design this module shows too coarse). Returns [B,1,QH,D]
    bf16."""
    batch, _, q_heads, d = q.shape
    s_max, kv_heads = k.shape[1], k.shape[2]
    group = q_heads // kv_heads
    scale_log2 = (torch.tensor(d ** -0.5, dtype=torch.float32)
                  * torch.tensor(LOG2E, dtype=torch.float32))
    n_splits = -(-s_max // split_tokens)
    shape = (batch, q_heads, n_splits)
    m = torch.full(shape, float("nan"))
    l = torch.full(shape, float("nan"))
    acc = torch.full(shape + (d,), float("nan"))
    qg = q[:, 0].float().reshape(batch, kv_heads, group, d)
    for b, n in enumerate(lens):
        for s in range(n_splits):
            lo, hi = s * split_tokens, min((s + 1) * split_tokens, n)
            if lo >= hi:
                continue
            m2 = torch.full((kv_heads, group), NEG_INF)
            l_run = torch.zeros((kv_heads, group))
            o_hi = torch.zeros((kv_heads, group, d))
            o_lo = torch.zeros((kv_heads, group, d))
            for p0 in range(lo, hi, TILE):
                keys = slice(p0, min(p0 + TILE, hi))
                kt = k[b, keys].float().permute(1, 2, 0)          # [KH, D, T]
                vt = v[b, keys].float().permute(1, 0, 2)          # [KH, T, D]
                x = (qg[b] @ kt) * scale_log2                     # [KH, G, T]
                if k_scale is not None:
                    x = x * k_scale[b, keys].T[:, None, :]
                m_new = torch.maximum(m2, x.amax(-1))
                alpha = torch.exp2(m2 - m_new)
                p = torch.exp2(x - m_new[..., None])
                l_run = l_run * alpha + p.sum(-1)
                if v_scale is not None:
                    p = p * v_scale[b, keys].T[:, None, :]
                p_hi = p.bfloat16().float()
                p_lo = (p - p_hi).bfloat16().float() if split_p else 0 * p
                o_hi = o_hi * alpha[..., None] + p_hi @ vt
                o_lo = o_lo * alpha[..., None] + p_lo @ vt
                m2 = m_new
            m[b, :, s] = (m2 * LN2).reshape(-1)
            l[b, :, s] = l_run.reshape(-1)
            acc[b, :, s] = (o_hi + o_lo).reshape(q_heads, d)
    merged = tpaged.merge_partials(m, l, acc, torch.tensor(lens),
                                   split_tokens)
    return merged.to(torch.bfloat16)


def _case(kind: str, block_s: int) -> dict:
    """Operands made from a seed: a pool of bf16 values ("bf16"), an int8
    pool quantized by the JAX ``quantize_kv`` ("int8"), each sequence on
    its own blocks, the table entries past its prefix naming blocks of
    large finite garbage; or a contiguous cache whose positions past each
    length hold garbage ("ragged")."""
    rng = np.random.default_rng(90 + block_s + len(kind))
    max_blocks = -(-max(LENS) // block_s)
    q = np.array(jnp.asarray(rng.standard_normal(
        (len(LENS), 1, Q_HEADS, D)), jnp.bfloat16).astype(jnp.float32))
    lens = np.array(LENS, np.int32)

    def bf16(shape):
        return np.array(jnp.asarray(rng.standard_normal(shape), jnp.bfloat16
                                    ).astype(jnp.float32))
    if kind == "ragged":
        shape = (len(LENS), max_blocks * block_s, KV_HEADS, D)
        k, v = bf16(shape), bf16(shape)
        for b, n in enumerate(LENS):
            k[b, n:], v[b, n:] = 1e3, -1e3
        return dict(q=q, k=k, v=v, lens=lens)
    need = [-(-n // block_s) for n in LENS]
    n_real, n_garbage = sum(need), 2
    table = np.empty((len(LENS), max_blocks), np.int32)
    perm, used = rng.permutation(n_real), 0
    for i, nb in enumerate(need):
        table[i, :nb] = perm[used:used + nb]
        table[i, nb:] = rng.integers(n_real, n_real + n_garbage,
                                     max_blocks - nb)
        used += nb
    shape = (n_real + n_garbage, block_s, KV_HEADS, D)
    if kind == "bf16":
        k, v = bf16(shape), bf16(shape)
        k[n_real:], v[n_real:] = 1e3, -1e3
        return dict(q=q, k=k, v=v, table=table, lens=lens)
    (kq, ks), (vq, vs) = ((np.array(x) for x in jquant.quantize_kv(
        jnp.asarray(rng.standard_normal(shape).astype(np.float32))))
        for _ in range(2))
    kq[n_real:], vq[n_real:] = 127, 127
    ks[n_real:], vs[n_real:] = 1e3, 1e3
    return dict(q=q, k=kq, v=vq, ks=ks, vs=vs, table=table, lens=lens)


def _references(kind: str, c: dict, block_s: int):
    """The port's twin as the card's check computes it (bf16 q and cache;
    f32 q over the dequantized int8 pool), rounded to bf16, and the JAX
    kernel in interpret mode rounded to bf16."""
    t = {n: torch.from_numpy(a) for n, a in c.items()}
    j = {n: jnp.asarray(a) for n, a in c.items()}
    if kind == "ragged":
        twin = tattn.xla_decode_attention(t["q"].bfloat16(), t["k"].bfloat16(),
                                          t["v"].bfloat16(), t["lens"])
        jax_out = jpaged.ragged_decode_attention(
            j["q"], j["k"], j["v"], j["lens"], block_s=block_s,
            interpret=True)
    elif kind == "int8":
        twin = tpaged.xla_paged_decode_attention(
            t["q"], t["k"], t["v"], t["table"], t["lens"], t["ks"], t["vs"])
        jax_out = jpaged.paged_decode_attention_quant(
            j["q"], j["k"], j["v"], j["ks"], j["vs"], j["table"], j["lens"],
            interpret=True)
    else:
        twin = tpaged.xla_paged_decode_attention(
            t["q"].bfloat16(), t["k"].bfloat16(), t["v"].bfloat16(),
            t["table"], t["lens"])
        jax_out = jpaged.paged_decode_attention(
            j["q"], j["k"], j["v"], j["table"], j["lens"], interpret=True)
    jax_bf16 = torch.from_numpy(np.array(jax_out)).to(torch.bfloat16)
    return twin.to(torch.bfloat16).float(), jax_bf16.float()


def _model(kind: str, c: dict, block_s: int, split_p: bool = True):
    """The kernel model over the densified operands, at the plan the
    wrapper gives this batch, kv head count and table."""
    t = {n: torch.from_numpy(a) for n, a in c.items()}
    n_blocks = t["k"].shape[1] // block_s if kind == "ragged" \
        else t["table"].shape[1]
    _, tokens = tpaged.split_plan(len(LENS), KV_HEADS, n_blocks, block_s,
                                  kind == "int8")
    if kind == "ragged":
        k, v, ks, vs = t["k"], t["v"], None, None
    else:
        k, v = (tpaged.gather_paged(t[n], t["table"]) for n in ("k", "v"))
        ks, vs = (t[n][t["table"].reshape(-1).long()].reshape(
            k.shape[:3]) if kind == "int8" else None for n in ("ks", "vs"))
    return kernel_model(t["q"], k, v, LENS, tokens, ks, vs, split_p), tokens


@pytest.mark.parametrize("block_s", [128, 256])
@pytest.mark.parametrize("kind", ["bf16", "int8", "ragged"])
def test_kernel_model_within_chip_tolerance_of_twin_and_jax(kind, block_s):
    """gemma-2b's heads at D = 256: 64-position splits, each cutting a
    block; the model within ``check_twin``'s rule of the twin and of the
    JAX kernel."""
    c = _case(kind, block_s)
    twin, jax_out = _references(kind, c, block_s)
    got, tokens = _model(kind, c, block_s)
    assert tokens == 64 < block_s
    assert got.shape == twin.shape and got.dtype == torch.bfloat16
    label = f"{kind} BS={block_s} model"
    chip_smoke.check_twin(kind, label + " vs twin", got, twin)
    chip_smoke.check_twin(kind, label + " vs jax", got, jax_out)


def test_p_rounded_once_to_bf16_leaves_the_chip_tolerance():
    """The same case with P rounded once to bf16 (no P_lo) misses the
    rule near zero outputs: the reason the kernel splits P in two."""
    c = _case("bf16", 128)
    twin, _ = _references("bf16", c, 128)
    got, _ = _model("bf16", c, 128, split_p=False)
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.check_twin("bf16", "model with one bf16 P", got, twin)
