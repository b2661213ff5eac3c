"""Token sampling for the serving engine."""
from __future__ import annotations

from typing import Optional

import torch


def sample(logits: torch.Tensor, *, temperature: float = 0.0,
           top_k: int = 0,
           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """logits: (B, V) -> (B,) int64 on the logits' device.  Temperature 0
    (or no generator) is greedy ``argmax``.  Non-greedy draws come from
    ``generator`` and cannot reproduce the reference's
    ``jax.random.categorical`` stream."""
    if temperature <= 0.0 or generator is None:
        return torch.argmax(logits, dim=-1)
    logits = logits.float() / temperature
    if top_k > 0:
        cutoff = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = logits.masked_fill(logits < cutoff, -1e30)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]
