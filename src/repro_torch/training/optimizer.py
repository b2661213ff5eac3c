"""Optimizers over the parameter tree: AdamW and Adafactor.

Port of ``repro/training/optimizer.py``, written as plain functions over
the tree in the reference's arithmetic (bias correction, decay of
matrices only, factored second moments, update clipping by RMS), not
``torch.optim``, whose AdamW and Adafactor compute otherwise.  State
trees have the parameters' structure (NamedTuples ``AdamWState`` and
``AdafactorState`` with a 0-d int32 ``step``, kept on the host), so a
checkpoint of either package restores in the other.

``update`` runs under ``torch.no_grad()`` and updates the parameters and
the moments **in place** (the returned trees hold the same tensors): at
llama3.1-8b's published width a second copy of the 16 GB of weights
would not fit beside the gradients.  For the same reason every leaf is
updated in slabs of at most ``SLAB`` elements along its leading rows
(one group of a stacked (G, ...) leaf at a time): Adafactor's fp32
temporaries for one (32, 4096, 14336) bf16 leaf would take ~30 GB
whole.  Adafactor's RMS clip is over the whole leaf, so it first sums
the squares of the update over the slabs, then applies it.

A DTensor leaf (the dry-run's sharded state) is updated through its
local shard, with the gradient, moments and parameter sharded alike:
AdamW is elementwise, and the sums over a sharded dim (Adafactor's row
and column means, its RMS clip, the global norm) are completed by an
all-reduce over the mesh dims that shard it (``_complete_sum``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterator, NamedTuple, Tuple

import torch

from repro_torch.core.tree import tree_flatten, tree_map
from repro_torch.distributed.sharding import is_dtensor

SLAB = 1 << 26          # elements per fp32 temporary (256 MB)


def _rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` as a (rows, last dim) view ((1, 1) for a 0-d tensor); writes
    into the view land in ``t``."""
    if not t.is_contiguous():
        raise ValueError("optimizer leaves must be contiguous (they are "
                         "updated in place through views)")
    if t.dim() == 0:
        return t.reshape(1, 1)
    return t.reshape(-1, t.shape[-1])


def _slabs(n_rows: int, n_cols: int) -> Iterator[slice]:
    """Row ranges of at most ``SLAB`` elements (at least one row)."""
    step = max(1, SLAB // max(n_cols, 1))
    for r0 in range(0, n_rows, step):
        yield slice(r0, min(r0 + step, n_rows))


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (updates land in the DTensor); else t."""
    return t.to_local() if is_dtensor(t) else t


def _complete_sum(part: torch.Tensor, leaf: torch.Tensor,
                  dims: Tuple[int, ...]) -> torch.Tensor:
    """A sum of ``leaf``'s local shard over its tensor dims ``dims`` (as
    non-negative indices), completed over the ranks that shard any of
    them: one all-reduce per such mesh dim.  ``part`` itself for a plain
    leaf."""
    if not is_dtensor(leaf):
        return part
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import Shard
    mesh = leaf.device_mesh
    for m, p in enumerate(leaf.placements):
        if isinstance(p, Shard) and p.dim in dims and mesh.size(m) > 1:
            part = funcol.all_reduce(part, "sum", (mesh, m))
    return part


def _scalar(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


class AdamWState(NamedTuple):
    step: torch.Tensor    # 0-d int32 on the host
    m: Any
    v: Any


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    # bf16 moments halve optimizer memory at negligible quality cost
    moment_dtype: str = "float32"

    def init(self, params) -> AdamWState:
        dt = getattr(torch, self.moment_dtype)
        zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
        return AdamWState(step=torch.zeros((), dtype=torch.int32),
                          m=tree_map(zeros, params),
                          v=tree_map(zeros, params))

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params
               ) -> Tuple[Any, AdamWState]:
        """One step; ``params``, ``state.m`` and ``state.v`` are updated
        in place and returned."""
        step = state.step + 1
        sf = _scalar(float(step))
        b1, b2 = self.b1, self.b2
        c1 = 1.0 - _scalar(b1) ** sf
        c2 = 1.0 - _scalar(b2) ** sf
        gl, spec = tree_flatten(grads)
        ml, vl, pl = (_leaves_like(spec, t) for t in
                      (state.m, state.v, params))
        for g, m, v, p in zip(gl, ml, vl, pl):
            c1d, c2d = c1.to(p.device), c2.to(p.device)
            g2, m2d, v2d, p2 = (_rows(_local(t)) for t in (g, m, v, p))
            for rs in _slabs(*p2.shape):
                gf = g2[rs].float()
                mn = b1 * m2d[rs].float() + (1 - b1) * gf
                vn = b2 * v2d[rs].float() + (1 - b2) * gf * gf
                delta = (mn / c1d) / (torch.sqrt(vn / c2d) + self.eps)
                pf = p2[rs].float()
                if p.dim() >= 2:   # decay matrices only (standard practice)
                    delta = delta + self.weight_decay * pf
                p2[rs] = (pf - self.lr * delta).to(p.dtype)
                m2d[rs] = mn.to(m.dtype)
                v2d[rs] = vn.to(v.dtype)
        return params, AdamWState(step=step, m=state.m, v=state.v)


class AdafactorState(NamedTuple):
    step: torch.Tensor    # 0-d int32 on the host
    vr: Any     # row second moments (or full v for <2D params)
    vc: Any     # col second moments (zeros for <2D params)


@dataclasses.dataclass(frozen=True)
class Adafactor:
    """Factored second-moment optimizer (Shazeer & Stern, 2018): rows +
    cols of second moments per matrix instead of rows x cols, over the
    last two axes."""

    lr: float = 1e-3
    decay: float = 0.8        # beta2_t = 1 - step^-decay
    eps: float = 1e-30
    clip_threshold: float = 1.0
    weight_decay: float = 0.0

    def init(self, params) -> AdafactorState:
        def rows(p):
            shape = p.shape[:-1] if p.dim() >= 2 else p.shape
            return torch.zeros(shape, dtype=torch.float32, device=p.device)

        def cols(p):
            shape = p.shape[:-2] + p.shape[-1:] if p.dim() >= 2 else ()
            return torch.zeros(shape, dtype=torch.float32, device=p.device)

        return AdafactorState(step=torch.zeros((), dtype=torch.int32),
                              vr=tree_map(rows, params),
                              vc=tree_map(cols, params))

    @torch.no_grad()
    def update(self, grads, state: AdafactorState, params
               ) -> Tuple[Any, AdafactorState]:
        """One step; ``params``, ``state.vr`` and ``state.vc`` are updated
        in place and returned."""
        step = state.step + 1
        beta2 = 1.0 - _scalar(float(step)) ** (-self.decay)
        gl, spec = tree_flatten(grads)
        vrl, vcl, pl = (_leaves_like(spec, t) for t in
                        (state.vr, state.vc, params))
        for g, vr, vc, p in zip(gl, vrl, vcl, pl):
            b2 = beta2.to(p.device)
            if p.dim() >= 2:
                self._factored(g, vr, vc, p, b2)
            else:
                self._full(g, vr, p, b2)
        return params, AdafactorState(step=step, vr=state.vr, vc=state.vc)

    def _apply(self, p: torch.Tensor, update: torch.Tensor,
               denom: torch.Tensor) -> torch.Tensor:
        pf = p.float()
        new_p = pf - self.lr * (update / denom)
        if self.weight_decay and p.dim() >= 2:
            new_p = new_p - self.lr * self.weight_decay * pf
        return new_p.to(p.dtype)

    def _denom(self, sumsq: torch.Tensor, numel: int) -> torch.Tensor:
        rms = torch.sqrt(sumsq / numel + self.eps)
        return torch.clamp(rms / self.clip_threshold, min=1.0)

    def _full(self, g, vr, p, b2) -> None:
        gf = _local(g).float()
        vl, pl = _local(vr), _local(p)
        vl.copy_(b2 * vl + (1 - b2) * (gf * gf + self.eps))
        update = gf * torch.rsqrt(torch.clamp(vl, min=self.eps))
        sumsq = _complete_sum(update.square().sum(), p,
                              tuple(range(p.dim())))
        denom = self._denom(sumsq, max(p.numel(), 1))
        pl.copy_(self._apply(pl, update, denom))

    def _factored(self, g, vr, vc, p, b2) -> None:
        n_r, n_c = p.shape[-2], p.shape[-1]          # global sizes
        rows_dim, cols_dim = p.dim() - 2, p.dim() - 1
        gl, pl = _local(g), _local(p)
        lr, lc = pl.shape[-2], pl.shape[-1]          # this rank's shard
        g3, p3 = gl.reshape(-1, lr, lc), pl.reshape(-1, lr, lc)
        vr2, vc2 = _local(vr).reshape(-1, lr), _local(vc).reshape(-1, lc)
        eps = self.eps
        # moments, one group (and slab of rows) at a time
        for lg in range(g3.shape[0]):
            colsum = torch.zeros(lc, dtype=torch.float32, device=pl.device)
            for rs in _slabs(lr, lc):
                gsq = g3[lg, rs].float().square() + eps
                if lc == n_c:
                    row = gsq.mean(-1)
                else:
                    row = _complete_sum(gsq.sum(-1), p, (cols_dim,)) / n_c
                vr2[lg, rs] = b2 * vr2[lg, rs] + (1 - b2) * row
                colsum += gsq.sum(0)
            colsum = _complete_sum(colsum, p, (rows_dim,))
            vc2[lg] = b2 * vc2[lg] + (1 - b2) * (colsum / n_r)

        def updates():
            for lg in range(g3.shape[0]):
                if lr == n_r:
                    row_mean = vr2[lg].mean()
                else:
                    row_mean = _complete_sum(vr2[lg].sum(), p,
                                             (rows_dim,)) / n_r
                row_mean = torch.clamp(row_mean, min=eps)
                for rs in _slabs(lr, lc):
                    r = vr2[lg, rs] / row_mean
                    precond = r[:, None] * vc2[lg][None, :]
                    yield lg, rs, g3[lg, rs].float() * torch.rsqrt(
                        torch.clamp(precond, min=eps))

        # update clipping: RMS over the whole leaf, then the step
        sumsq = torch.zeros((), dtype=torch.float32, device=pl.device)
        for _, _, u in updates():
            sumsq = sumsq + u.square().sum()
        sumsq = _complete_sum(sumsq, p, tuple(range(p.dim())))
        denom = self._denom(sumsq, p.numel())
        for lg, rs, u in updates():
            p3[lg, rs] = self._apply(p3[lg, rs], u, denom)


def _leaves_like(spec, tree) -> list:
    """The leaves of ``tree``, which must have ``spec``'s leaf count."""
    leaves = tree_flatten(tree)[0]
    if len(leaves) != spec.num_leaves:
        raise ValueError(f"a tree of {len(leaves)} leaves where "
                         f"{spec.num_leaves} are expected")
    return leaves


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32 (a 0-d tensor on
    the leaves' device), taken in slabs."""
    total = None
    for leaf in tree_flatten(tree)[0]:
        rows = _rows(_local(leaf))
        if is_dtensor(leaf):        # the shard's sum, completed once
            part = sum(rows[rs].float().square().sum()
                       for rs in _slabs(*rows.shape))
            part = _complete_sum(part, leaf, tuple(range(leaf.dim())))
            total = part if total is None else total + part
            continue
        for rs in _slabs(*rows.shape):
            part = rows[rs].float().square().sum()
            total = part if total is None else total + part.to(total.device)
    if total is None:
        return torch.zeros((), dtype=torch.float32)
    return torch.sqrt(total)


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """Scale every gradient by min(1, max_norm / norm) **in place** (in
    fp32, cast back to each leaf's dtype); returns (grads, norm)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    for leaf in tree_flatten(grads)[0]:
        # a 0-d fp32 factor: the product is taken in fp32 and rounded once
        # to the leaf's dtype, the reference's (g.astype(f32) * s).astype
        _local(leaf).mul_(scale.to(leaf.device))
    return grads, norm


def make_optimizer(name: str, **kwargs):
    if name == "adamw":
        return AdamW(**kwargs)
    if name == "adafactor":
        return Adafactor(**kwargs)
    raise KeyError(name)
