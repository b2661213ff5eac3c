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
from typing import Optional, Tuple

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


# ---------------------------------------------------------------------------
# xLSTM recurrences (the reference's ``lax.scan``s of ``models/ssm.py``)
# ---------------------------------------------------------------------------


def _keep(lens: Optional[torch.Tensor], t: int, ndim: int):
    """(B, 1, ...) of rank ``ndim``: True where step t is a real token;
    None when every token is real."""
    if lens is None:
        return None
    return (t < lens).reshape((-1,) + (1,) * (ndim - 1))


def _masked(keep: Optional[torch.Tensor], new: torch.Tensor,
            old: torch.Tensor) -> torch.Tensor:
    return new if keep is None else torch.where(keep, new, old)


def _max_weights(a: torch.Tensor, b: torch.Tensor):
    """The shares of ``maximum(a, b)``'s gradient that go to a and to b:
    all to the larger, half each on a tie (JAX's and PyTorch's rule)."""
    half = 0.5 * (a == b).float()
    return (a > b).float() + half, (b > a).float() + half


def slstm_recurrence_ref(gates_x: torch.Tensor, r: torch.Tensor,
                         bias: torch.Tensor, c: torch.Tensor,
                         n: torch.Tensor, h: torch.Tensor, m: torch.Tensor,
                         lens: Optional[torch.Tensor] = None,
                         save: bool = False):
    """The sLSTM recurrence, one step per token.  gates_x (B, T, 4d) fp32
    input contribution, head-major (head j's four gates i, f, z, o at
    ``[4 hd j, 4 hd (j + 1))``); r (H, hd, 4hd) recurrent gates (applied
    in fp32); bias (4d,) or (H, 4hd) fp32; the state c, n, h, m (B, H, hd)
    fp32; lens (B,) or None (every token real).

    Past a row's length its state, and the hidden state it emits, stay as
    they were (the reference's scan emits the masked h).  Returns (hs
    (B, T, H, hd) fp32, c, n, h, m); with ``save`` also (acts (B, T, H,
    4hd): each step's gate pre-activations, and cs, ns, ms (B, T, H, hd):
    the state after each step), what the backward reads."""
    b, t = gates_x.shape[:2]
    nh, hd = r.shape[0], r.shape[1]
    r = r.float()
    bias = bias.reshape(nh, 4 * hd)
    if lens is not None:
        lens = lens.to(gates_x.device)
    hs, acts, cs, ns, ms = [], [], [], [], []
    for i in range(t):
        rec = torch.einsum("bhd,hde->bhe", h, r)
        gx = gates_x[:, i].reshape(b, nh, 4 * hd) + rec + bias
        i_t, f_t, z_t, o_t = gx.chunk(4, dim=-1)
        m_new = torch.maximum(f_t + m, i_t)
        i_g = torch.exp(i_t - m_new)
        f_g = torch.exp(f_t + m - m_new)
        c_new = f_g * c + i_g * torch.tanh(z_t)
        n_new = f_g * n + i_g
        h_new = torch.sigmoid(o_t) * c_new / torch.clamp(n_new.abs(),
                                                         min=1e-6)
        keep = _keep(lens, i, 3)
        c, n, h, m = (_masked(keep, new, old) for new, old in
                      ((c_new, c), (n_new, n), (h_new, h), (m_new, m)))
        hs.append(h)
        if save:
            acts.append(gx)
            cs.append(c)
            ns.append(n)
            ms.append(m)
    out = (torch.stack(hs, dim=1), c, n, h, m)
    if save:
        out += tuple(torch.stack(v, dim=1) for v in (acts, cs, ns, ms))
    return out


def slstm_recurrence_bwd_ref(r: torch.Tensor, acts: torch.Tensor,
                             cs: torch.Tensor, ns: torch.Tensor,
                             ms: torch.Tensor, c0: torch.Tensor,
                             n0: torch.Tensor, m0: torch.Tensor,
                             dhs: torch.Tensor,
                             dstate: Tuple[Optional[torch.Tensor], ...]
                             = (None, None, None, None)):
    """The reverse walk of ``slstm_recurrence_ref`` over every step (no
    lens), from what its ``save`` form returns: r (H, hd, 4hd), acts
    (B, T, H, 4hd), cs, ns, ms (B, T, H, hd), the initial c0, n0, m0, the
    emitted h's gradient dhs (B, T, H, hd) and the final state's
    (dc, dn, dh, dm) or None each.  Returns (dacts (B, T, H, 4hd): the
    gradient of every step's gate pre-activations, which is gates_x's
    and, summed, the bias's; dc0, dn0, dh0, dm0), fp32.  The recurrent
    gates' gradient is sum_t h_{t-1} (x) dacts_t, one product after the
    walk (``kernels.xlstm``).  Step t's carried dh picks up r . dacts_t,
    and m's gradient follows ``maximum`` (half each on a tie)."""
    b, t, nh, hd = cs.shape
    r = r.float()
    zero = torch.zeros((b, nh, hd), dtype=torch.float32, device=cs.device)
    dc, dn, dh, dm = (zero if g is None else g.float() for g in dstate)
    dacts = torch.empty((b, t, nh, 4 * hd), dtype=torch.float32,
                        device=cs.device)
    for i in reversed(range(t)):
        c_prev, n_prev, m_prev = ((c0, n0, m0) if i == 0 else
                                  (cs[:, i - 1], ns[:, i - 1], ms[:, i - 1]))
        gi, gf, gz, go = acts[:, i].chunk(4, dim=-1)
        a = gf + m_prev
        m_new = torch.maximum(a, gi)
        i_g = torch.exp(gi - m_new)
        f_g = torch.exp(a - m_new)
        tz, so = torch.tanh(gz), torch.sigmoid(go)
        c_new, n_new = cs[:, i], ns[:, i]
        den = torch.clamp(n_new.abs(), min=1e-6)
        dh_new = dh + dhs[:, i]
        dgo = dh_new * c_new / den * so * (1 - so)
        dc_new = dc + dh_new * so / den
        w_abs, _ = _max_weights(n_new.abs(), torch.full_like(n_new, 1e-6))
        dn_new = dn - dh_new * so * c_new / (den * den) \
            * torch.sign(n_new) * w_abs
        df_g = dc_new * c_prev + dn_new * n_prev
        di_g = dc_new * tz + dn_new
        dgz = dc_new * i_g * (1 - tz * tz)
        dm_tot = dm - di_g * i_g - df_g * f_g
        w_a, w_i = _max_weights(a, gi)
        dgi = di_g * i_g + dm_tot * w_i
        dm = df_g * f_g + dm_tot * w_a
        dg = torch.cat([dgi, dm, dgz, dgo], dim=-1)
        dacts[:, i] = dg
        dc, dn = dc_new * f_g, dn_new * f_g
        dh = torch.einsum("bhe,hde->bhd", dg, r)
    return dacts, dc, dn, dh, dm


def mlstm_recurrence_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         i_pre: torch.Tensor, f_pre: torch.Tensor,
                         cmat: torch.Tensor, n: torch.Tensor,
                         m: torch.Tensor,
                         lens: Optional[torch.Tensor] = None):
    """The mLSTM recurrence, one step of the matrix memory per token.  q,
    k, v (B, T, H, hd) fp32 (k already scaled by 1/sqrt(hd)); i_pre,
    f_pre (B, T, H) fp32 (f_pre already through log-sigmoid); the state
    cmat (B, H, hd, hd), n (B, H, hd), m (B, H) fp32; lens (B,) or None.

    Each step emits h from the unmasked new memory; past a row's length
    only the state is held (the reference masks the state alone).
    Returns (hs (B, T, H, hd) fp32, cmat, n, m)."""
    t = q.shape[1]
    if lens is not None:
        lens = lens.to(q.device)
    hs = []
    for i in range(t):
        qi, ki, vi = q[:, i], k[:, i], v[:, i]                    # (B,H,hd)
        m_new = torch.maximum(f_pre[:, i] + m, i_pre[:, i])       # (B,H)
        i_g = torch.exp(i_pre[:, i] - m_new)
        f_g = torch.exp(f_pre[:, i] + m - m_new)
        kv = vi[..., :, None] * ki[..., None, :]                 # (B,H,hd,hd)
        c_new = f_g[..., None, None] * cmat + i_g[..., None, None] * kv
        n_new = f_g[..., None] * n + i_g[..., None] * ki
        num = torch.einsum("bhvk,bhk->bhv", c_new, qi)
        den = torch.clamp(torch.einsum("bhk,bhk->bh", n_new, qi).abs(),
                          min=1.0)[..., None]
        hs.append(num / den)
        cmat = _masked(_keep(lens, i, 4), c_new, cmat)
        n = _masked(_keep(lens, i, 3), n_new, n)
        m = _masked(_keep(lens, i, 2), m_new, m)
    return torch.stack(hs, dim=1), cmat, n, m


def mlstm_recurrence_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, i_pre: torch.Tensor,
                             f_pre: torch.Tensor, cmat0: torch.Tensor,
                             n0: torch.Tensor, m0: torch.Tensor,
                             hs: torch.Tensor, dhs: torch.Tensor,
                             dstate: Tuple[Optional[torch.Tensor], ...]
                             = (None, None, None)):
    """Gradients of ``mlstm_recurrence_ref`` over every step (no lens)
    given the emitted h's (``hs``) gradient dhs (B, T, H, hd) and the
    final state's (dcmat, dn, dm) or None each: (dq, dk, dv, di, df,
    dcmat0, dn0, dm0), fp32.  The memory before each step is recomputed
    by a forward loop and walked in reverse.  With den = max(|n . q|, 1)
    and h = C q / den, den's gradient is -sum(dh h) / den (taken from
    the emitted h, as the kernel takes it); m's follows ``maximum``."""
    b, t, nh, hd = q.shape
    cmat, n, m = cmat0.float(), n0.float(), m0.float()
    before = []
    for i in range(t):
        before.append((cmat, n, m))
        m_new = torch.maximum(f_pre[:, i] + m, i_pre[:, i])
        i_g = torch.exp(i_pre[:, i] - m_new)
        f_g = torch.exp(f_pre[:, i] + m - m_new)
        kv = v[:, i, ..., :, None] * k[:, i, ..., None, :]
        cmat = f_g[..., None, None] * cmat + i_g[..., None, None] * kv
        n = f_g[..., None] * n + i_g[..., None] * k[:, i]
        m = m_new
    dcmat, dn, dm = (torch.zeros_like(s) if g is None else g.float()
                     for s, g in zip((cmat, n, m), dstate))
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    di, df = torch.empty_like(i_pre), torch.empty_like(f_pre)
    for i in reversed(range(t)):
        c_prev, n_prev, m_prev = before[i]
        qi, ki, vi = q[:, i], k[:, i], v[:, i]
        a = f_pre[:, i] + m_prev
        m_new = torch.maximum(a, i_pre[:, i])
        i_g = torch.exp(i_pre[:, i] - m_new)
        f_g = torch.exp(a - m_new)
        kv = vi[..., :, None] * ki[..., None, :]
        c_new = f_g[..., None, None] * c_prev + i_g[..., None, None] * kv
        n_new = f_g[..., None] * n_prev + i_g[..., None] * ki
        s = torch.einsum("bhk,bhk->bh", n_new, qi)
        den = torch.clamp(s.abs(), min=1.0)
        dh = dhs[:, i]
        dnum = dh / den[..., None]
        dden = -(dh * hs[:, i]).sum(-1) / den
        w_abs, _ = _max_weights(s.abs(), torch.ones_like(s))
        ds = dden * torch.sign(s) * w_abs
        dc_new = dcmat + dnum[..., :, None] * qi[..., None, :]
        dn_new = dn + ds[..., None] * qi
        dq[:, i] = torch.einsum("bhvk,bhv->bhk", c_new, dnum) \
            + ds[..., None] * n_new
        rv = torch.einsum("bhvk,bhk->bhv", dc_new, ki)
        df_g = (dc_new * c_prev).sum((-2, -1)) + (dn_new * n_prev).sum(-1)
        di_g = (rv * vi).sum(-1) + (dn_new * ki).sum(-1)
        dv[:, i] = i_g[..., None] * rv
        dk[:, i] = i_g[..., None] * (
            torch.einsum("bhvk,bhv->bhk", dc_new, vi) + dn_new)
        dm_tot = dm - di_g * i_g - df_g * f_g
        w_a, w_i = _max_weights(a, i_pre[:, i])
        di[:, i] = di_g * i_g + dm_tot * w_i
        dm = df_g * f_g + dm_tot * w_a
        df[:, i] = dm
        dcmat, dn = f_g[..., None, None] * dc_new, f_g[..., None] * dn_new
    return dq, dk, dv, di, df, dcmat, dn, dm


def _stabiliser(i_pre: torch.Tensor, f_pre: torch.Tensor, m0: torch.Tensor):
    """The mLSTM stabiliser's max-plus chain, step by step: each step's
    log gates lf = f + m_{t-1} - m_t and li = i - m_t, the share of
    ``maximum``'s gradient that goes to f + m_{t-1} (B, H, T each), and
    the last m (B, H)."""
    ih, fh = i_pre.float().transpose(1, 2), f_pre.float().transpose(1, 2)
    m = m0.float()
    lf, li, w_a = [], [], []
    for i in range(ih.shape[-1]):
        a = fh[..., i] + m
        m_new = torch.maximum(a, ih[..., i])
        lf.append(a - m_new)
        li.append(ih[..., i] - m_new)
        w_a.append(_max_weights(a, ih[..., i])[0])
        m = m_new
    return (*(torch.stack(x, -1) for x in (lf, li, w_a)), m)


def _chunk_decays(lf: torch.Tensor, li: torch.Tensor, c0: int, c1: int):
    """One chunk's decays (steps c0..c1-1): alpha_j (from the chunk's
    start to j), w_j (j's update at the chunk's end) and W_jr (r's at j,
    r <= j).  The log decays are sums of lf over each span itself (never
    a difference of prefix sums: a first step's lf of ~-1e30 from m0 =
    -1e30 would swallow every later lf of a prefix sum)."""
    lfc, li_c = lf[..., c0:c1], li[..., c0:c1]
    idx = torch.arange(c1 - c0, device=lf.device)
    span = (idx[None, :, None] < idx[None, None, :]) \
        & (idx[None, None, :] <= idx[:, None, None])          # (j, r, p)
    lw = torch.where(span, lfc[..., None, None, :], 0.0).sum(-1)
    big_w = torch.where(idx[None, :] <= idx[:, None],
                        torch.exp(lw + li_c[..., None, :]), 0.0)
    head = torch.where(idx[None, :] <= idx[:, None],
                       lfc[..., None, :], 0.0).sum(-1)
    return torch.exp(head), big_w[..., -1, :], big_w


def _boundaries(cmat0, n0, v1, kh, bounds, gates):
    """The boundary memories [C; n] ((hd + 1) x hd) before each chunk and
    at the end: B_{c+1} = alpha_last B_c + [V; 1]^T diag(w) K."""
    bnd = [torch.cat([cmat0.float(), n0.float()[..., None, :]], -2)]
    for c0, c1 in bounds:
        alpha, w, _ = gates(c0, c1)
        upd = torch.einsum("bhsv,bhsk->bhvk", w[..., None] * v1[..., c0:c1, :],
                           kh[..., c0:c1, :])
        bnd.append(alpha[..., -1, None, None] * bnd[-1] + upd)
    return bnd


def mlstm_chunkwise_fwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, i_pre: torch.Tensor,
                            f_pre: torch.Tensor, cmat0: torch.Tensor,
                            n0: torch.Tensor, m0: torch.Tensor,
                            chunk: int = 64):
    """``mlstm_recurrence_ref`` over every step (no lens) in the
    chunkwise-parallel form of its kernel's chunkwise route
    (``csrc/mlstm_scan.cu``): the same arguments and results (hs, cmat,
    n, m), the arithmetic regrouped into products over chunks of
    ``chunk`` steps.  Only the tests call it; it proves the algebra.

    With lf, li, alpha, w and W as in ``mlstm_chunkwise_bwd_ref`` and the
    boundary memory B_c = [C_c; n_c] before chunk c:
      1. boundaries: B_{c+1} = alpha_last B_c + [V; 1]^T diag(w) K; the
         last is the final [C; n], and m is the stabiliser's last;
      2. per chunk, all at once: WS = W * Q K^T, s_j = alpha_j q_j . n_c
         + sum_r WS_jr, den_j = max(|s_j|, 1), h_j = (alpha_j C_c q_j +
         sum_r WS_jr v_r) / den_j."""
    b, t, nh, hd = q.shape
    qh, kh, vh = (x.float().transpose(1, 2) for x in (q, k, v))
    lf, li, _, m = _stabiliser(i_pre, f_pre, m0)
    bounds = [(c0, min(c0 + chunk, t)) for c0 in range(0, t, chunk)]
    v1 = torch.cat([vh, torch.ones((b, nh, t, 1), dtype=torch.float32,
                                   device=q.device)], -1)

    def gates(c0, c1):
        return _chunk_decays(lf, li, c0, c1)

    bnd = _boundaries(cmat0, n0, v1, kh, bounds, gates)
    hs = torch.empty((b, nh, t, hd), dtype=torch.float32, device=q.device)
    for c, (c0, c1) in enumerate(bounds):
        alpha, _, big_w = gates(c0, c1)
        qc = qh[..., c0:c1, :]
        ws = big_w * (qc @ kh[..., c0:c1, :].transpose(-1, -2))
        s = alpha * (qc @ bnd[c][..., hd, :, None])[..., 0] + ws.sum(-1)
        den = torch.clamp(s.abs(), min=1.0)
        num = alpha[..., None] * (qc @ bnd[c][..., :hd, :].transpose(-1, -2)) \
            + ws @ vh[..., c0:c1, :]
        hs[..., c0:c1, :] = num / den[..., None]
    return (hs.transpose(1, 2).contiguous(), bnd[-1][..., :hd, :],
            bnd[-1][..., hd, :], m)


def mlstm_chunkwise_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, i_pre: torch.Tensor,
                            f_pre: torch.Tensor, cmat0: torch.Tensor,
                            n0: torch.Tensor, m0: torch.Tensor,
                            hs: torch.Tensor, dhs: torch.Tensor,
                            dstate: Tuple[Optional[torch.Tensor], ...]
                            = (None, None, None), chunk: int = 64):
    """``mlstm_recurrence_bwd_ref`` in the chunkwise-parallel form its
    kernel (``csrc/mlstm_scan_bwd.cu``) computes: the same arguments and
    results, the arithmetic regrouped into products over chunks of
    ``chunk`` steps.  Only the tests call it; it proves the algebra.

    With m_t the stabiliser after step t, each step's forget and input
    gates are exp(lf_t) and exp(li_t), lf_t = f_t + m_{t-1} - m_t and
    li_t = i_t - m_t, both <= 0.  Inside a chunk, G_j is the sum of lf
    over its steps up to j, alpha_j = exp(G_j) the decay from the
    chunk's start, w_j = exp(G_last - G_j + li_j) the weight of step j's
    update at the chunk's end and W_jr = exp(G_j - G_r + li_r) (r <= j)
    that of step r's update at step j; every exponent is <= 0 and is
    summed over its own span of steps.  The
    memory and the normaliser travel together as one (hd + 1, hd)
    matrix [C; n] (v extended by a 1), their gradients as [dC; dn] (dnum
    = dh / den extended by ds):
      1. boundaries: B_{c+1} = alpha_last B_c + [V; 1]^T diag(w) K;
      2. per chunk: s_j = alpha_j q_j . n_c + sum_r W_jr q_j . k_r, den,
         ds; P = dnum V^T + ds, WP = W * P, WS = W * Q K^T;
      3. carried gradients: E_{c-1} = alpha_last E_c + (alpha [dnum,
         ds])^T Q, from E_last = the final state's gradient;
      4. per chunk: dq = alpha [dnum, ds] B_c + WP K, dk = w ([V, 1] E_c)
         + WP^T Q, dv = w (K dC_c^T) + WS^T dnum;
      5. the gates: X_j = dk_j . k_j is di_g i_g; Y_j = df_g f_g = <E_c,
         B_{c+1}> + sum_{s >= j in the chunk} (dh_s . h_s + ds_s s_s -
         X_s), 0 where f_g is 0; then m's chain in reverse,
         dm_{t-1} = Y + w_a (dm - X - Y)
         (``maximum``: half each on a tie)."""
    b, t, nh, hd = q.shape
    f32 = dict(dtype=torch.float32, device=q.device)
    qh, kh, vh, hh, dhh = (x.float().transpose(1, 2) for x in
                           (q, k, v, hs, dhs))                # (B,H,T,hd)
    lf, li, w_a, _ = _stabiliser(i_pre, f_pre, m0)
    bounds = [(c0, min(c0 + chunk, t)) for c0 in range(0, t, chunk)]
    v1 = torch.cat([vh, torch.ones((b, nh, t, 1), **f32)], -1)  # [V, 1]

    def gates(c0, c1):
        return _chunk_decays(lf, li, c0, c1)

    # 1. the boundary memories [C; n] before each chunk and at the end
    bnd = _boundaries(cmat0, n0, v1, kh, bounds, gates)
    # 2. per chunk: the normaliser's dot, den, ds and the masked products
    per = []
    for c, (c0, c1) in enumerate(bounds):
        alpha, w, big_w = gates(c0, c1)
        qc, kc, vc = qh[..., c0:c1, :], kh[..., c0:c1, :], vh[..., c0:c1, :]
        s_qk = qc @ kc.transpose(-1, -2)
        s = alpha * (qc @ bnd[c][..., hd, :, None])[..., 0] \
            + (big_w * s_qk).sum(-1)
        den = torch.clamp(s.abs(), min=1.0)
        hdot = (dhh[..., c0:c1, :] * hh[..., c0:c1, :]).sum(-1)
        w_abs, _ = _max_weights(s.abs(), torch.ones_like(s))
        ds = -hdot / den * torch.sign(s) * w_abs
        dnum = dhh[..., c0:c1, :] / den[..., None]
        wp = big_w * (dnum @ vc.transpose(-1, -2) + ds[..., None])
        per.append((alpha, w, torch.cat([dnum, ds[..., None]], -1), wp,
                    big_w * s_qk, hdot + ds * s))
    # 3. the carried gradients [dC; dn] at each chunk's end
    zero = torch.zeros((b, nh), **f32)
    fin = [torch.zeros_like(x) if g is None else g.float()
           for x, g in zip((cmat0, n0, zero), dstate)]
    carry = torch.cat([fin[0], fin[1][..., None, :]], -2)
    ends, p_c = [None] * len(bounds), [None] * len(bounds)
    for c in reversed(range(len(bounds))):
        c0, c1 = bounds[c]
        alpha, _, dnum1 = per[c][:3]
        ends[c] = carry
        p_c[c] = (carry * bnd[c + 1]).sum((-2, -1))
        carry = alpha[..., -1, None, None] * carry + torch.einsum(
            "bhsv,bhsk->bhvk", alpha[..., None] * dnum1, qh[..., c0:c1, :])
    # 4. the intra-chunk gradients, every chunk alike
    dq, dk, dv = (torch.empty((b, nh, t, hd), **f32) for _ in range(3))
    x_g = torch.empty((b, nh, t), **f32)
    y_g = torch.empty((b, nh, t), **f32)
    for c, (c0, c1) in enumerate(bounds):
        alpha, w, dnum1, wp, ws, e = per[c]
        qc, kc = qh[..., c0:c1, :], kh[..., c0:c1, :]
        dq[..., c0:c1, :] = alpha[..., None] * (dnum1 @ bnd[c]) + wp @ kc
        dk[..., c0:c1, :] = w[..., None] * (v1[..., c0:c1, :] @ ends[c]) \
            + wp.transpose(-1, -2) @ qc
        dv[..., c0:c1, :] = w[..., None] * (kc @ ends[c][..., :hd, :]
                                            .transpose(-1, -2)) \
            + ws.transpose(-1, -2) @ dnum1[..., :hd]
        x = (dk[..., c0:c1, :] * kc).sum(-1)
        x_g[..., c0:c1] = x
        # where f_g is 0 (m0 = -1e30, or a reset far above a), df_g f_g
        # is 0 exactly, not the sum's rounding
        y_g[..., c0:c1] = torch.where(
            lf[..., c0:c1].exp() == 0, 0.0, p_c[c][..., None] + torch.flip(
                torch.cumsum(torch.flip(e - x, [-1]), -1), [-1]))
    # 5. the stabiliser's chain in reverse
    dm = fin[2]
    di, df = torch.empty((b, nh, t), **f32), torch.empty((b, nh, t), **f32)
    for i in reversed(range(t)):
        dm_tot = dm - x_g[..., i] - y_g[..., i]
        wa = w_a[..., i]
        di[..., i] = x_g[..., i] + dm_tot * (1.0 - wa)
        dm = y_g[..., i] + dm_tot * wa
        df[..., i] = dm
    back = [x.transpose(1, 2).contiguous() for x in (dq, dk, dv, di, df)]
    return (*back, carry[..., :hd, :], carry[..., hd, :], dm)
