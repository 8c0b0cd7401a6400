"""Token sampling (counterpart of ``tpu9/ops/sampling.py``): greedy,
temperature, top-k and top-p, with an explicit ``torch.Generator``."""

from __future__ import annotations

from typing import Optional

import torch


def sample_logits(logits: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  temperature: float = 0.0, top_k: int = 0,
                  top_p: float = 1.0) -> torch.Tensor:
    """Sample token ids from ``logits`` [..., vocab]. ``temperature == 0``
    is greedy (the first index of the maximum, as ``jnp.argmax``); otherwise
    top-k then top-p filtering and a Gumbel-max draw from ``generator``."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)

    logits = logits.float() / max(temperature, 1e-6)

    if top_k > 0:
        kth = torch.sort(logits, dim=-1).values[..., -top_k, None]
        logits = logits.masked_fill(logits < kth, float("-inf"))

    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        # keep the smallest prefix with cumulative prob >= top_p (always 1)
        cutoff_idx = (cum < top_p).sum(dim=-1, keepdim=True).clamp_max(
            logits.shape[-1] - 1)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
        logits = logits.masked_fill(logits < cutoff, float("-inf"))

    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
    return torch.argmax(logits + gumbel, dim=-1)
