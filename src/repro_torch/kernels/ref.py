"""Plain PyTorch versions of the kernels.

Each function is the semantic ground truth its hand-written CUDA
kernel is held against (on the card by ``chip_smoke.py``) and the path
``kernels.ops`` takes for tensors on the CPU.  Written the obvious way:
attention materialises the full score matrix, masks with -1e30 and takes
the softmax in fp32; the selective scan is a loop over time.  The two
backward functions write the gradient formulas out (not by autograd), as
their kernels compute them: attention recomputes the probabilities from
the forward's log-sum-exp, the scan runs its recurrence in reverse.
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


def _prefill_scores(q: torch.Tensor, k: torch.Tensor,
                    prefix_len: Optional[torch.Tensor],
                    q_offset: Optional[torch.Tensor],
                    causal: bool) -> torch.Tensor:
    """Scaled fp32 scores (B, T, KV, G, S), masked entries at NEG_INF."""
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
    return scores


def prefill_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          prefix_len: Optional[torch.Tensor] = None,
                          q_offset: Optional[torch.Tensor] = None, *,
                          causal: bool = True, return_lse: bool = False):
    """q: (B, T, H, D); k, v: (B, S, KV, D), S >= T -> (B, T, H, D).

    ``q_offset`` (B,) shifts each row's queries to absolute positions
    (chunked prefill): query i attends kv positions <= q_offset[b] + i.
    ``prefix_len`` (B,) makes keys below it visible to every query.
    ``return_lse`` also returns each row's natural-log log-sum-exp of its
    scaled scores, (B, H, T) fp32: what the forward saves for the
    backward.
    """
    scores = _prefill_scores(q, k, prefix_len, q_offset, causal)
    out = _attend(scores, v, q)
    if not return_lse:
        return out
    b, t, h, _ = q.shape
    lse = torch.logsumexp(scores, dim=-1)                 # (B, T, KV, G)
    return out, lse.reshape(b, t, h).transpose(1, 2).contiguous()


def _attend(scores: torch.Tensor, v: torch.Tensor,
            q: torch.Tensor) -> torch.Tensor:
    """fp32 softmax of (B, T, KV, G, S) scores over v, in q's shape and
    dtype."""
    p = torch.exp(scores - scores.amax(-1, keepdim=True))
    p = p / torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
    out = torch.einsum("btkgs,bskd->btkgd", p, v.float())
    return out.reshape(q.shape).to(q.dtype)


def prefill_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, o: torch.Tensor,
                              lse: torch.Tensor, do: torch.Tensor,
                              prefix_len: Optional[torch.Tensor] = None,
                              causal: bool = True):
    """Gradients of ``prefill_attention_ref`` (queries at positions
    0..T-1): (dq, dk, dv) in q's, k's and v's dtypes, from the forward's
    output ``o`` and log-sum-exp ``lse`` (B, H, T).  P = exp(S - lse);
    dV = P^T dO and dK = scale dS^T Q, both summed over each kv head's G
    query heads; dS = P (dO V^T - rowsum(dO o)); dQ = scale dS K."""
    b, t, h, d = q.shape
    kv = k.shape[2]
    g = h // kv
    scale = 1.0 / math.sqrt(d)
    scores = _prefill_scores(q, k, prefix_len, None, causal)
    lse_r = lse.float().transpose(1, 2).reshape(b, t, kv, g)
    p = torch.exp(scores - lse_r[..., None])              # masked -> 0
    dof = do.float().reshape(b, t, kv, g, d)
    delta = (dof * o.float().reshape(b, t, kv, g, d)).sum(-1)
    dv = torch.einsum("btkgs,btkgd->bskd", p, dof)
    dp = torch.einsum("btkgd,bskd->btkgs", dof, v.float())
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("btkgs,bskd->btkgd", ds, k.float()) * scale
    dk = torch.einsum("btkgs,btkgd->bskd", ds,
                      q.float().reshape(b, t, kv, g, d)) * scale
    return (dq.reshape(b, t, h, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


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


def mamba_selective_scan_bwd_ref(dt: torch.Tensor, x: torch.Tensor,
                                 b: torch.Tensor, c: torch.Tensor,
                                 a_neg: torch.Tensor, d_skip: torch.Tensor,
                                 h0: torch.Tensor, dy: torch.Tensor,
                                 dh_final: Optional[torch.Tensor] = None):
    """Gradients of ``mamba_selective_scan_ref`` over every step (no
    lens) given dy (B, T, I) and the final state's gradient (or none):
    (ddt, dx, db, dc, da_neg, dd_skip, dh0), each in its input's dtype.
    A reverse scan of g_t = dL/dh_t = c_t dy_t + exp(dt_{t+1} A) g_{t+1}
    over the states the forward loop keeps."""
    bsz, t = dt.shape[:2]
    dtf, xf, bf, cf = (v.float() for v in (dt, x, b, c))
    a, dyf = a_neg.float(), dy.float()
    h = h0.float()
    hs, das = [h], []
    for i in range(t):
        da = torch.exp(dtf[:, i, :, None] * a[None])
        h = da * h + (dtf[:, i] * xf[:, i])[..., None] * bf[:, i, None, :]
        hs.append(h)
        das.append(da)
    g = torch.zeros_like(h) if dh_final is None else dh_final.float()
    ddt, dx = torch.zeros_like(dtf), torch.zeros_like(xf)
    db, dc = torch.zeros_like(bf), torch.zeros_like(cf)
    da_neg = torch.zeros_like(a)
    for i in reversed(range(t)):
        g = g + cf[:, i, None, :] * dyf[:, i, :, None]
        dc[:, i] = (dyf[:, i, :, None] * hs[i + 1]).sum(1)
        db[:, i] = (g * (dtf[:, i] * xf[:, i])[..., None]).sum(1)
        dah = das[i] * hs[i]
        ddt[:, i] = (g * (a[None] * dah
                          + xf[:, i, :, None] * bf[:, i, None, :])).sum(-1)
        dx[:, i] = d_skip.float() * dyf[:, i] \
            + dtf[:, i] * (g * bf[:, i, None, :]).sum(-1)
        da_neg = da_neg + (g * dtf[:, i, :, None] * dah).sum(0)
        g = das[i] * g
    dd_skip = (dyf * xf).sum((0, 1))
    return (ddt.to(dt.dtype), dx.to(x.dtype), db.to(b.dtype), dc.to(c.dtype),
            da_neg.to(a_neg.dtype), dd_skip.to(d_skip.dtype),
            g.to(h0.dtype))
