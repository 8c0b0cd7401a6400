"""The numerics of the Hopper flash kernel (``tpu9_torch/csrc/flash_attention.cu``)
on the CPU, where the kernel cannot run.

``kernel_model`` repeats the kernel's arithmetic in PyTorch: 128-row q
tiles over 128-key k/v tiles (64-key at D = 256), zero-filled past T and S
as TMA fills them;
scores in f32, scaled by ``D^-0.5 * log2(e)`` for ``exp2``; keys past S and,
when causal, keys past the row masked to -1e30 (the kernel masks only the
tiles that cross the diagonal or S, where the mask can be true); a causal q
tile stops at its diagonal tile; f32 running max, sum and accumulator;
each probability rounded to bf16 for the PV product; the row sum floored at
1e-30 and the output rounded to bf16.

On the same inputs made from a seed (bf16 values; B=2, GQA 4, T = S = 256
and 320, which is a multiple of 64 and not of 128; D 64, 128 and 256; causal
and not), the JAX Pallas ``flash_attention`` in interpret mode is the
reference: the port's twin ``xla_attention`` matches it in f32 at
``atol=2e-5``, and the model stays within ``chip_smoke.flash_limit`` of the
twin, the tolerance ``chip_smoke.py`` holds the kernel to on the card. So
that tolerance holds for this design by construction.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tpu9.ops import attention as jattn
from tpu9_torch.ops import attention as tattn

torch.set_num_threads(2)

TILE = 128                    # q rows of a tile


def key_tile(d: int) -> int:
    """Keys of a k/v tile: 64 at D = 256 (the q tile and two stages of
    128-key k and v tiles would not fit in shared memory), else 128."""
    return 64 if d == 256 else 128
ATOL = 2e-5
LOG2E = 1.4426950408889634


def kernel_model(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 causal: bool) -> torch.Tensor:
    """The kernel's arithmetic. q [B,T,QH,D], k/v [B,S,KH,D] holding bf16
    values (any float dtype); returns [B,T,QH,D] in bf16."""
    batch, t, q_heads, d = q.shape
    s, kv_heads = k.shape[1], k.shape[2]
    group = q_heads // kv_heads
    bn = key_tile(d)
    scale_log2 = torch.tensor(d ** -0.5, dtype=torch.float32) * torch.tensor(
        LOG2E, dtype=torch.float32)

    def tiles(x, n, rows):
        """[B, L, H, D] -> [B, H, n tiles, rows, D] in f32, zero-filled."""
        pad = n * rows - x.shape[1]
        x = torch.nn.functional.pad(x.float(), (0, 0, 0, 0, 0, pad))
        return x.reshape(batch, n, rows, x.shape[2], d).permute(0, 3, 1, 2, 4)

    n_q, n_k = -(-t // TILE), -(-s // bn)
    qs = tiles(q, n_q, TILE)
    ks = tiles(k, n_k, bn).repeat_interleave(group, dim=1)
    vs = tiles(v, n_k, bn).repeat_interleave(group, dim=1)
    out = torch.empty((batch, q_heads, n_q, TILE, d), dtype=torch.float32)
    for qt in range(n_q):
        rows = qt * TILE + torch.arange(TILE)
        m = torch.full((batch, q_heads, TILE), -1e30)
        l = torch.zeros((batch, q_heads, TILE))
        o = torch.zeros((batch, q_heads, TILE, d))
        # a causal q tile stops at the last key tile its rows reach
        for j in range(min(n_k, (qt + 1) * TILE // bn) if causal else n_k):
            x = qs[:, :, qt] @ ks[:, :, j].transpose(-1, -2) * scale_log2
            cols = j * bn + torch.arange(bn)
            masked = (cols >= s)[None, :].expand(TILE, bn)
            if causal:
                masked = masked | (cols[None, :] > rows[:, None])
            x = x.masked_fill(masked, -1e30)
            m_new = torch.maximum(m, x.amax(-1))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(x - m_new[..., None])
            l = l * alpha + p.sum(-1)
            o = o * alpha[..., None] + p.bfloat16().float() @ vs[:, :, j]
            m = m_new
        out[:, :, qt] = o / torch.clamp(l, min=1e-30)[..., None]
    out = out.reshape(batch, q_heads, n_q * TILE, d)[:, :, :t]
    return out.permute(0, 2, 1, 3).to(torch.bfloat16)


def _bf16_values(rng, shape) -> np.ndarray:
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return x.bfloat16().float().numpy()


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("t", [256, 320])
def test_kernel_model_within_chip_tolerance_of_twin_and_jax(t, d, causal):
    rng = np.random.default_rng(1000 + t + d + int(causal))
    q = _bf16_values(rng, (2, t, 8, d))
    k = _bf16_values(rng, (2, t, 2, d))
    v = _bf16_values(rng, (2, t, 2, d))
    block = math.gcd(t, TILE)               # the JAX kernel's blocks divide T
    want = np.array(jattn.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        block_q=block, block_k=block, interpret=True))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    np.testing.assert_allclose(tattn.xla_attention(tq, tk, tv, causal).numpy(),
                               want, atol=ATOL, rtol=0)

    got = kernel_model(tq, tk, tv, causal).float()
    bf = [x.bfloat16() for x in (tq, tk, tv)]
    twin = tattn.xla_attention(*bf, causal=causal).float()
    for ref in (twin, torch.from_numpy(want)):
        limit = chip_smoke.flash_limit(ref, tv, 8, causal)
        err = (got - ref).abs()
        assert bool((err <= limit).all()), float((err - limit).max())
    # the model is not the twin: the bf16 probabilities move some outputs
    assert float((got - twin).abs().max()) > 0

