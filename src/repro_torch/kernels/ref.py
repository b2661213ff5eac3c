"""Plain PyTorch versions of the kernels.

Each function is the semantic ground truth its hand-written CUDA
kernel is held against (on the card by ``chip_smoke.py``) and the path
``kernels.ops`` takes for tensors on the CPU.  Written the obvious way:
attention materialises the full score matrix, masks with -1e30 and takes
the softmax in fp32; the selective scan is a loop over time.
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


def mamba_selective_scan_ref(dt: torch.Tensor, x: torch.Tensor,
                             b: torch.Tensor, c: torch.Tensor,
                             a_neg: torch.Tensor, d_skip: torch.Tensor,
                             h0: torch.Tensor,
                             lens: Optional[torch.Tensor] = None):
    """Mamba-1 selective scan.  dt, x (B,T,I); b, c (B,T,N); a_neg (I,N);
    d_skip (I,); h0 (B,I,N); lens (B,) or None (every token real).

    h advances only while t < lens[b]; y_t is taken from the pre-freeze
    h_new.  Returns (y (B,T,I), h_final (B,I,N)), both fp32."""
    bsz, t = dt.shape[:2]
    dt, x, b, c = (v.float() for v in (dt, x, b, c))
    a_neg, d_skip = a_neg.float(), d_skip.float()
    if lens is None:
        lens = torch.full((bsz,), t, dtype=torch.int32, device=dt.device)
    lens = lens.to(dt.device)
    h = h0.float()
    ys = []
    for i in range(t):
        da = torch.exp(dt[:, i, :, None] * a_neg[None])
        h_new = da * h + (dt[:, i] * x[:, i])[..., None] * b[:, i, None, :]
        ys.append((h_new * c[:, i, None, :]).sum(-1) + d_skip * x[:, i])
        h = torch.where((i < lens)[:, None, None], h_new, h)
    return torch.stack(ys, dim=1), h
