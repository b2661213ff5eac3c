"""Training step: causal-LM loss, gradient accumulation, remat,
compression, clipping and the optimizer.

Port of ``repro/training/train_step.py``.  ``make_train_step`` builds
step(state, batch, rng) -> (state, metrics): loss -> grad (autograd
through the stateless forward, whose attention and Mamba scan run their
hand-written backward kernels on the card) -> optional int8 compression
with error feedback -> clip by global norm -> optimizer.  Microbatches
of ``accum_steps`` run one after another with fp32 gradient sums.  On
DTensor parameters (the dry-run's) the loss is vocab-parallel and each
gradient is brought to its parameter's placements.  The optimizer updates the parameters in place, so the returned
state holds the tensors of the one passed in.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.core.tree import tree_flatten, tree_map
from repro_torch.distributed import compression
from repro_torch.distributed.sharding import is_dtensor
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import unembed
from repro_torch.models.model import (forward_hidden, forward_train,
                                      params_from_numpy)
from repro_torch.training.optimizer import (AdafactorState, AdamWState,
                                            clip_by_global_norm)


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    error_feedback: Optional[Any]    # compression residuals (or None)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: str = "adamw"
    grad_clip: float = 1.0
    accum_steps: int = 1             # microbatch count per step
    remat: bool = True
    compress_grads: bool = False     # int8 + error feedback
    z_loss: float = 0.0              # logit norm regularizer
    # chunked loss: unembed + cross-entropy over sequence chunks of this
    # many tokens, never holding the whole (B, T, V) fp32 logits (the
    # dominant activation at 100k+ vocabularies); 0 = off
    loss_chunk: int = 0


def _nll(logits: torch.Tensor, labels: torch.Tensor,
         z_loss: float) -> torch.Tensor:
    logits = logits.float()
    if is_dtensor(logits):
        return _nll_vocab_parallel(logits, labels, z_loss)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if z_loss:
        nll = nll + z_loss * logz.square()
    return nll


def _nll_vocab_parallel(logits: torch.Tensor, labels: torch.Tensor,
                        z_loss: float) -> torch.Tensor:
    """``_nll`` of DTensor logits (B, T, V), on each rank's vocab shard
    (Megatron's vocab-parallel cross-entropy): the log-sum-exp from a max
    and a sum completed over the vocab's mesh dims, the gold logit from
    the shard that holds it.  No mesh dim gathers the vocab, forward or
    backward.  Labels (B, T) -> (B, T), placed as the logits' rows."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh, vocab_dim = logits.device_mesh, logits.dim() - 1
    pl = [Replicate() if p.is_partial() else p for p in logits.placements]
    logits = logits.redistribute(mesh, pl)
    vocab = tuple(m for m, p in enumerate(pl)
                  if isinstance(p, Shard) and p.dim == vocab_dim)
    row_pl = [Replicate() if m in vocab else p for m, p in enumerate(pl)]
    _, offset = compute_local_shape_and_global_offset(logits.shape, mesh, pl)
    ids = _as_placed(labels, mesh, row_pl).to_local().long()
    nll = _VocabParallelNLL.apply(logits.to_local(), ids - offset[-1],
                                  mesh, vocab, z_loss)
    return DTensor.from_local(nll, mesh, row_pl, run_check=False,
                              shape=labels.shape,
                              stride=(labels.shape[1], 1))


def _as_placed(x: torch.Tensor, mesh, placements) -> torch.Tensor:
    from repro_torch.distributed.sharding import as_dtensor
    return as_dtensor(x, mesh).redistribute(mesh, placements)


class _VocabParallelNLL(torch.autograd.Function):
    """nll = logz - gold (+ z_loss * logz^2) of one rank's vocab shard of
    fp32 logits (..., V_local), ``ids`` already relative to the shard's
    first id; the max, the sum and the gold logit are completed by
    all-reduces over ``vocab`` (mesh dims of ``mesh``).  The gradient,
    softmax * (1 + 2 z logz) - onehot, is local."""

    @staticmethod
    def forward(ctx, local, ids, mesh, vocab, z_loss):
        from torch.distributed import _functional_collectives as funcol

        def complete(x, op):
            for m in vocab:
                if mesh.size(m) > 1:
                    x = funcol.all_reduce(x, op, (mesh, m))
            return x

        m = complete(local.amax(-1), "max")
        e = torch.exp(local - m[..., None])
        logz = torch.log(complete(e.sum(-1), "sum")) + m
        hit = (ids >= 0) & (ids < local.shape[-1])
        safe = ids.clamp(0, local.shape[-1] - 1)
        gold = torch.where(hit, torch.gather(local, -1, safe[..., None])[..., 0],
                           torch.zeros((), dtype=local.dtype,
                                       device=local.device))
        nll = logz - complete(gold, "sum")
        if z_loss:
            nll = nll + z_loss * logz.square()
        ctx.save_for_backward(local, logz, safe, hit)
        ctx.z_loss = z_loss
        return nll

    @staticmethod
    def backward(ctx, dnll):
        local, logz, safe, hit = ctx.saved_tensors
        scale = dnll if not ctx.z_loss else dnll * (1 + 2 * ctx.z_loss * logz)
        grad = torch.exp(local - logz[..., None]) * scale[..., None]
        grad = grad.scatter_add(-1, safe[..., None],
                                -(dnll * hit)[..., None])
        return grad, None, None, None, None


def causal_lm_loss(logits: torch.Tensor, labels: torch.Tensor,
                   mask: Optional[torch.Tensor] = None,
                   z_loss: float = 0.0) -> torch.Tensor:
    """Next-token cross-entropy in fp32.  logits: (B, T, V); labels:
    (B, T); ``mask`` (B, T) weights each position."""
    nll = _nll(logits, labels, z_loss)
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def make_loss_fn(cfg: ModelConfig, tcfg: TrainConfig) -> Callable:
    """loss_fn(params, batch, rng) -> (loss + aux, {"loss", "aux_loss"});
    ``rng`` is a ``torch.Generator`` for the router jitter or None."""
    if tcfg.loss_chunk:
        return _make_chunked_loss_fn(cfg, tcfg)

    def loss_fn(params, batch: Dict[str, torch.Tensor], rng):
        logits, aux = forward_train(params, cfg, batch, rng=rng,
                                    remat=tcfg.remat)
        # shift by one inside the batch: predict tokens[t + 1]
        labels = batch["labels"]
        mask = batch.get("mask")
        loss = causal_lm_loss(logits[:, :-1], labels[:, 1:],
                              None if mask is None else mask[:, 1:],
                              z_loss=tcfg.z_loss)
        return loss + aux, {"loss": loss, "aux_loss": aux}
    return loss_fn


def _make_chunked_loss_fn(cfg: ModelConfig, tcfg: TrainConfig) -> Callable:
    """Unembed + cross-entropy over sequence chunks of ``loss_chunk``
    tokens: the dense path's loss where the chunk divides T - 1; else,
    as the reference, the last (T - 1) mod chunk positions are left out
    (ROADMAP queue 3).  Each chunk is recomputed in the backward
    (``torch.utils.checkpoint``), so only its hidden states are kept,
    never its (B, C, V) fp32 logits."""

    def chunk_sum(embedding, hc, yc):
        return _nll(unembed(embedding, hc), yc, tcfg.z_loss).sum()

    def loss_fn(params, batch: Dict[str, torch.Tensor], rng):
        hidden, aux = forward_hidden(params, cfg, batch, rng=rng,
                                     remat=tcfg.remat)
        labels = batch["labels"]
        b, t, _ = hidden.shape
        c = min(tcfg.loss_chunk, t - 1)
        n = (t - 1) // c
        total = torch.zeros((), dtype=torch.float32, device=hidden.device)
        for i in range(n):
            args = (params.embedding, hidden[:, i * c:(i + 1) * c],
                    labels[:, 1 + i * c:1 + (i + 1) * c])
            if torch.is_grad_enabled():
                total = total + torch.utils.checkpoint.checkpoint(
                    chunk_sum, *args, use_reentrant=False)
            else:
                total = total + chunk_sum(*args)
        loss = total / (b * n * c)
        return loss + aux, {"loss": loss, "aux_loss": aux}
    return loss_fn


def loss_grads(loss_fn: Callable, params, batch, rng):
    """(gradient tree in the parameters' dtypes, detached metrics): every
    parameter leaf is made to require a gradient for the call only.  An
    unused leaf (the token embedding of an audio model) gets zeros, as
    JAX's grad gives."""
    leaves, spec = tree_flatten(params)
    before = [p.requires_grad for p in leaves]
    try:
        with torch.enable_grad():
            for p in leaves:
                p.requires_grad_(True)
            total, metrics = loss_fn(params, batch, rng)
            grads = torch.autograd.grad(total, leaves, allow_unused=True)
    finally:
        for p, flag in zip(leaves, before):
            p.requires_grad_(flag)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, leaves)]
    # a sharded parameter's gradient takes its placements (FSDP's
    # reduce-scatter), so the optimizer updates each rank's shard
    grads = [g.redistribute(p.device_mesh, p.placements)
             if is_dtensor(p) and tuple(g.placements) != tuple(p.placements)
             else g for g, p in zip(grads, leaves)]
    return spec.unflatten(grads), {k: v.detach() for k, v in metrics.items()}


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, optimizer
                    ) -> Callable:
    """Returns step(state, batch, rng) -> (state, metrics) with metrics
    ``loss``, ``aux_loss`` and ``grad_norm`` (0-d tensors).

    With ``accum_steps > 1`` the batch's leading dim must be divisible by
    it; microbatches run in order (each draws its router jitter from
    ``rng`` in turn) and their gradients are averaged in fp32.  The
    parameters and optimizer moments are updated in place."""
    loss_fn = make_loss_fn(cfg, tcfg)

    def accumulate(params, batch, rng):
        n = tcfg.accum_steps
        micro = {k: v.reshape((n, v.shape[0] // n) + v.shape[1:])
                 for k, v in batch.items()}
        acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params)
        acc_leaves = tree_flatten(acc)[0]
        metrics = None
        for i in range(n):
            g, m = loss_grads(loss_fn, params, {k: v[i] for k, v in
                                            micro.items()}, rng)
            for a, gg in zip(acc_leaves, tree_flatten(g)[0]):
                a.add_(gg.float() / n)
            del g
            metrics = {k: v / n for k, v in m.items()} if metrics is None \
                else {k: metrics[k] + v / n for k, v in m.items()}
        return acc, metrics

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             rng: Optional[torch.Generator] = None
             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        if tcfg.accum_steps > 1:
            grads, metrics = accumulate(state.params, batch, rng)
        else:
            grads, metrics = loss_grads(loss_fn, state.params, batch, rng)
        ef = state.error_feedback
        if tcfg.compress_grads:
            grads, ef = compression.compress_decompress_with_feedback(grads,
                                                                      ef)
        grads, gnorm = clip_by_global_norm(grads, tcfg.grad_clip)
        metrics["grad_norm"] = gnorm
        params, opt_state = optimizer.update(grads, state.opt_state,
                                             state.params)
        return TrainState(params, opt_state, ef), metrics

    return step


def init_train_state(cfg: ModelConfig, tcfg: TrainConfig, optimizer,
                     params) -> TrainState:
    ef = None
    if tcfg.compress_grads:
        ef = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device), params)
    return TrainState(params=params, opt_state=optimizer.init(params),
                      error_feedback=ef)


def train_state_from_numpy(cfg: ModelConfig, tree: Any,
                           device: torch.device | str) -> TrainState:
    """The reference's ``TrainState`` with numpy (or array-like) leaves
    -- parameters, an ``AdamWState`` or ``AdafactorState`` (told apart by
    their field names) and the error feedback (or None) -- as the port's,
    on ``device``.  The optimizer's step stays on the host."""
    def like_params(t):         # every state tree has the params' shape
        return params_from_numpy(cfg, t, device)

    params = like_params(tree.params)
    opt = tree.opt_state
    step = torch.tensor(int(opt.step), dtype=torch.int32)
    if hasattr(opt, "m"):
        opt_state = AdamWState(step=step, m=like_params(opt.m),
                               v=like_params(opt.v))
    else:
        opt_state = AdafactorState(step=step, vr=like_params(opt.vr),
                                   vc=like_params(opt.vc))
    ef = None if tree.error_feedback is None \
        else like_params(tree.error_feedback)
    return TrainState(params=params, opt_state=opt_state, error_feedback=ef)
