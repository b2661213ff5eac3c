"""Mixture-of-experts FFN: token-choice top-k routing, dropless below a
token threshold, GShard-style capacity above it.

Routing runs in fp32: softmax over the router's logits, the top-k
experts with ties going to the lower expert id (``jax.lax.top_k``'s
order, taken here from a stable descending sort), and the selected
probabilities renormalised to sum to one (DeepSeek).  Each token's
output is the fp32 sum over its k experts of probability x expert
SwiGLU, plus the shared experts' SwiGLU (DeepSeek-MoE) over every token.

  * ``_moe_ffn_gather`` (n <= ``DROPLESS_TOKEN_THRESHOLD`` tokens, i.e.
    every decode step): exact, independent of what else is in the
    batch.  The reference gathers each token's k expert weight slices
    ((n, k, d, f) copies: ~0.8 GB per layer at deepseek-moe-16b's width
    and 6 rows); here every expert runs over every token in three
    batched products and each token keeps its k experts' outputs.
  * ``moe_ffn`` above the threshold: a stable sort places each
    assignment at its position within its expert; assignments past
    ``expert_capacity`` are dropped (contribute zero); the kept tokens
    fill an (E, C, d) buffer and the experts run as batched products
    over it.  What is dropped depends on every token of the call, the
    padded positions of a chunk included, as in the reference.

Expert products are plain matrix products (the reference computes them
outside any Pallas kernel).  Port of ``repro/models/moe.py``.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import constrain, is_dtensor
from repro_torch.models.config import MoEConfig
from repro_torch.models.layers import Params, dense_init_, mlp

# At or below this many tokens the dropless path runs: at decode scale,
# capacity drops would corrupt tokens and make a row's output depend on
# the rows beside it (the host rows ride along in the decode batch).
DROPLESS_TOKEN_THRESHOLD = 256


class DispatchCounts:
    """Calls of each path and assignments dropped at capacity, summed over
    the process since the last ``reset``.  The dropped count accumulates
    on the tensors' device, so counting adds no host sync; ``snapshot``
    reads it."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.dropless = 0
        self.capacity = 0
        self._dropped: Dict[torch.device, torch.Tensor] = {}

    def add_dropped(self, n: torch.Tensor) -> None:
        acc = self._dropped.get(n.device)
        if acc is None:
            self._dropped[n.device] = n.to(torch.int64).clone()
        else:
            acc.add_(n)

    def snapshot(self) -> Dict[str, int]:
        return {"dropless": self.dropless, "capacity": self.capacity,
                "dropped": sum(int(t) for t in self._dropped.values())}


COUNTS = DispatchCounts()


def moe_init(d_model: int, cfg: MoEConfig, gen: torch.Generator, *,
             groups: int, dtype: torch.dtype, device: torch.device
             ) -> Params:
    """Random MoE leaves stacked over ``groups``, with the reference's
    names and dtypes: ``router`` (G, d, E) fp32, ``we_gate``/``we_up``
    (G, E, d, f), ``we_down`` (G, E, f, d) and, with shared experts,
    ``ws_gate``/``ws_up`` (G, d, S * f_s), ``ws_down`` (G, S * f_s, d);
    fan-in truncated normals as the reference draws them."""
    e, f = cfg.num_experts, cfg.expert_ffn_dim

    def dense(*shape, dt=dtype):
        return dense_init_(torch.empty((groups,) + shape, dtype=dt,
                                       device=device), gen)

    params = {"router": dense(d_model, e, dt=torch.float32),
              "we_gate": dense(e, d_model, f), "we_up": dense(e, d_model, f),
              "we_down": dense(e, f, d_model)}
    if cfg.num_shared_experts > 0:
        hidden = cfg.num_shared_experts * cfg.shared_ffn_dim
        params.update(ws_gate=dense(d_model, hidden),
                      ws_up=dense(d_model, hidden),
                      ws_down=dense(hidden, d_model))
    return params


def expert_capacity(num_tokens: int, cfg: MoEConfig,
                    capacity_factor: float = 1.25) -> int:
    cap = math.ceil(cfg.top_k * num_tokens / cfg.num_experts
                    * capacity_factor)
    return max(cap, 1)


def _route(params: Params, tokens: torch.Tensor, cfg: MoEConfig,
           generator: Optional[torch.Generator] = None):
    """fp32 router: (probs (n, E), renormalised top-k probs (n, k), top-k
    expert ids (n, k)), ties to the lower id."""
    logits = tokens.float() @ params["router"]
    if generator is not None and cfg.router_jitter > 0:
        logits = logits + cfg.router_jitter * torch.randn(
            logits.shape, generator=generator, device=logits.device)
    probs = torch.softmax(logits, dim=-1)
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_probs, top_ids = vals[:, :cfg.top_k], ids[:, :cfg.top_k]
    return probs, top_probs / top_probs.sum(-1, keepdim=True), top_ids


def _shared_and_aux(params: Params, cfg: MoEConfig, tokens: torch.Tensor,
                    combined: torch.Tensor, probs: torch.Tensor,
                    top_ids: torch.Tensor):
    """Add the shared experts' SwiGLU; the Switch-style load-balance loss
    (fraction of assignments per expert x mean router probability)."""
    if "ws_gate" in params:
        combined = combined + mlp({"w_gate": params["ws_gate"],
                                   "w_up": params["ws_up"],
                                   "w_down": params["ws_down"]}, tokens)
    assign_frac = F.one_hot(top_ids, cfg.num_experts).float().mean((0, 1))
    aux = cfg.aux_loss_coef * cfg.num_experts * (
        assign_frac * probs.mean(0)).sum()
    return combined, aux


def capacity_slots(flat_ids: torch.Tensor, cap: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each assignment's position within its expert's buffer and whether
    it fits under ``cap``: a stable sort groups the (token-major)
    assignments by expert, and position = index - first index of the
    expert's run, so an expert's first ``cap`` assignments in token order
    are kept."""
    order = torch.argsort(flat_ids, stable=True)
    sorted_ids = flat_ids[order]
    first = torch.searchsorted(sorted_ids, sorted_ids, side="left")
    flat_pos = torch.empty_like(order)
    flat_pos[order] = torch.arange(flat_ids.numel(),
                                   device=flat_ids.device) - first
    return flat_pos, flat_pos < cap


def moe_ffn(params: Params, x: torch.Tensor, cfg: MoEConfig, *,
            capacity_factor: float = 1.25,
            generator: Optional[torch.Generator] = None,
            dropless: Optional[bool] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply the MoE FFN.  x: (B, T, d).  Returns (out, aux_loss).
    ``generator`` draws router jitter on the capacity path only (serving
    passes none)."""
    b, t, d = x.shape
    n, k, e = b * t, cfg.top_k, cfg.num_experts
    if dropless is None:
        dropless = n <= DROPLESS_TOKEN_THRESHOLD
    if dropless:
        return _moe_ffn_gather(params, x, cfg)
    COUNTS.capacity += 1
    tokens = x.reshape(n, d)
    cap = expert_capacity(n, cfg, capacity_factor)
    probs, top_probs, top_ids = _route(params, tokens, cfg, generator)
    if is_dtensor(x):
        return _moe_ffn_capacity_sharded(params, x, cfg, cap, tokens, probs,
                                         top_probs, top_ids)

    flat_ids = top_ids.reshape(-1)
    flat_pos, keep = capacity_slots(flat_ids, cap)
    COUNTS.add_dropped((~keep).sum())

    # dispatch: kept tokens into (E, C, d) buffers
    safe_pos = torch.where(keep, flat_pos, 0)
    contrib = torch.where(keep[:, None], tokens.repeat_interleave(k, 0),
                          torch.zeros((), dtype=x.dtype, device=x.device))
    buf = torch.zeros((e, cap, d), dtype=x.dtype, device=x.device)
    buf.index_put_((flat_ids, safe_pos), contrib, accumulate=True)
    buf = constrain(buf, "experts", None, None)

    # experts: batched SwiGLU over the experts dim
    gate = F.silu(torch.bmm(buf, params["we_gate"]).float()).to(x.dtype)
    up = torch.bmm(buf, params["we_up"])
    out_buf = torch.bmm(gate * up, params["we_down"])
    out_buf = constrain(out_buf, "experts", None, None)

    # combine: fp32 probability-weighted sum over each token's k experts
    gathered = out_buf[flat_ids, safe_pos]                     # (n*k, d)
    weights = (top_probs.reshape(-1) * keep).float()
    combined = (gathered.float() * weights[:, None]).reshape(n, k, d) \
        .sum(1).to(x.dtype)
    combined, aux = _shared_and_aux(params, cfg, tokens, combined, probs,
                                    top_ids)
    return combined.reshape(b, t, d), aux


def _moe_ffn_capacity_sharded(params: Params, x, cfg: MoEConfig, cap: int,
                              tokens, probs, top_probs, top_ids):
    """The capacity path on DTensors (the dry-run's): the same dispatch,
    experts and combine.  Capacity is assigned over every token of the
    call in token order, as on one device, so the routing ids, the
    tokens and the expert outputs are gathered to every rank and the
    index arithmetic (sort, searchsorted, scatter-add, gather; ops
    DTensor does not shard) runs on plain local tensors; the expert
    products run on the expert-sharded buffer against the sharded
    weights."""
    from torch.distributed.tensor import DTensor, Replicate
    b, t, d = x.shape
    n, k, e = b * t, cfg.top_k, cfg.num_experts
    mesh = x.device_mesh
    rep = [Replicate()] * mesh.ndim

    def gathered(a):
        return a.redistribute(mesh, rep).to_local()

    flat_ids = gathered(top_ids).reshape(-1)
    flat_pos, keep = capacity_slots(flat_ids, cap)
    COUNTS.add_dropped((~keep).sum())
    safe_pos = torch.where(keep, flat_pos, 0)
    tok = gathered(tokens)
    contrib = torch.where(keep[:, None], tok.repeat_interleave(k, 0),
                          torch.zeros((), dtype=x.dtype, device=tok.device))
    buf = torch.zeros((e, cap, d), dtype=x.dtype, device=tok.device)
    buf.index_put_((flat_ids, safe_pos), contrib, accumulate=True)
    buf = constrain(DTensor.from_local(buf, mesh, rep, run_check=False),
                    "experts", None, None)
    gate = F.silu(torch.bmm(buf, params["we_gate"]).float()).to(x.dtype)
    up = torch.bmm(buf, params["we_up"])
    out_buf = torch.bmm(gate * up, params["we_down"])
    out_buf = constrain(out_buf, "experts", None, None)
    picked = gathered(out_buf)[flat_ids, safe_pos]             # (n*k, d)
    weights = (gathered(top_probs).reshape(-1) * keep).float()
    combined = (picked.float() * weights[:, None]).reshape(n, k, d) \
        .sum(1).to(x.dtype)
    combined = DTensor.from_local(combined, mesh, rep, run_check=False
                                  ).redistribute(mesh, [
                                      Replicate() if p.is_partial() else p
                                      for p in tokens.placements])
    combined, aux = _shared_and_aux(params, cfg, tokens, combined, probs,
                                    top_ids)
    return combined.reshape(b, t, d), aux


def _pick_sharded(out, top_ids):
    """``out[top_ids, token]`` (n, k, d) of DTensors out (E, n, d) and
    top_ids (n, k): each rank picks from its own tokens, with the expert
    and model dims of ``out`` gathered (DTensor's index op does not take
    ids split over two mesh dims, as (pod, data) splits the tokens)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = out.device_mesh
    ids_pl = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
              for p in top_ids.placements]
    local_out = out.redistribute(mesh, [
        Shard(1) if isinstance(p, Shard) else Replicate()
        for p in ids_pl]).to_local()
    ids = top_ids.redistribute(mesh, ids_pl).to_local()
    picked = local_out[ids, torch.arange(ids.shape[0],
                                         device=ids.device)[:, None]]
    (n, k), d = top_ids.shape, out.shape[-1]
    return DTensor.from_local(picked, mesh, ids_pl, run_check=False,
                              shape=(n, k, d), stride=(k * d, d, 1))


def _moe_ffn_gather(params: Params, x: torch.Tensor, cfg: MoEConfig
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dropless path: every assignment computed, whatever else is in the
    batch, then the fp32 weighted sum over k.  Every expert runs over
    every token in three batched products (all expert weights read once,
    no host sync, each row's products at the call's fixed M), and each
    token keeps its k selected experts' outputs."""
    COUNTS.dropless += 1
    b, t, d = x.shape
    n = b * t
    tokens = x.reshape(n, d)
    probs, top_probs, top_ids = _route(params, tokens, cfg)
    xs = tokens.expand(cfg.num_experts, n, d)
    gate = F.silu(torch.bmm(xs, params["we_gate"]).float()).to(x.dtype)
    out = torch.bmm(gate * torch.bmm(xs, params["we_up"]),
                    params["we_down"])                          # (E, n, d)
    if is_dtensor(out):
        out_k = _pick_sharded(out, top_ids)
    else:
        out_k = out[top_ids, torch.arange(n, device=x.device)[:, None]]
    combined = (out_k.float() * top_probs[..., None]).sum(1).to(x.dtype)
    combined, aux = _shared_and_aux(params, cfg, tokens, combined, probs,
                                    top_ids)
    return combined.reshape(b, t, d), aux
