"""Plain PyTorch versions of the attention kernels.

Each function is the semantic ground truth its hand-written CUDA
kernel is held against (on the card by ``chip_smoke.py``) and the path
``kernels.ops`` takes for tensors on the CPU.  Written the obvious way:
materialise the full score matrix, mask with -1e30, softmax in fp32.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         lengths: torch.Tensor) -> torch.Tensor:
    """q: (B, H, D); k, v: (B, S, KV, D); lengths: (B,) -> (B, H, D)."""
    b, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    g = h // kv
    qg = q.reshape(b, kv, g, d).float()
    scores = torch.einsum("bkgd,bskd->bkgs", qg, k.float()) / math.sqrt(d)
    idx = torch.arange(s, device=q.device)[None, None, None, :]
    valid = idx < lengths.to(q.device)[:, None, None, None]
    scores = scores.masked_fill(~valid, NEG_INF)
    p = torch.exp(scores - scores.amax(-1, keepdim=True))
    p = p / torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
    out = torch.einsum("bkgs,bskd->bkgd", p, v.float())
    return out.reshape(b, h, d).to(q.dtype)


def prefill_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          prefix_len: Optional[torch.Tensor] = None,
                          q_offset: Optional[torch.Tensor] = None, *,
                          causal: bool = True) -> torch.Tensor:
    """q: (B, T, H, D); k, v: (B, S, KV, D), S >= T -> (B, T, H, D).

    ``q_offset`` (B,) shifts each row's queries to absolute positions
    (chunked prefill): query i attends kv positions <= q_offset[b] + i.
    ``prefix_len`` (B,) makes keys below it visible to every query.
    """
    b, t, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    g = h // kv
    qg = q.reshape(b, t, kv, g, d).float()
    scores = torch.einsum("btkgd,bskd->btkgs", qg, k.float()) / math.sqrt(d)
    if causal:
        qi = torch.arange(t, device=q.device)[None, :, None]
        if q_offset is not None:
            qi = qi + q_offset.to(q.device)[:, None, None]
        ki = torch.arange(s, device=q.device)[None, None, :]
        mask = ki <= qi                                   # (B|1, T, S)
        if prefix_len is not None:
            mask = mask | (ki < prefix_len.to(q.device)[:, None, None])
        mask = mask.expand(b, t, s)
        scores = scores.masked_fill(~mask[:, :, None, None, :], NEG_INF)
    p = torch.exp(scores - scores.amax(-1, keepdim=True))
    p = p / torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
    out = torch.einsum("btkgs,bskd->btkgd", p, v.float())
    return out.reshape(b, t, h, d).to(q.dtype)
