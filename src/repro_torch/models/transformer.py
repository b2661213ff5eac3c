"""Attention-only block stack: init, prefill forward, and the APEX
unified decode step.

Parameters and decode states carry a leading G (= num_groups) axis, as
in the reference, so layer = g * period + j; the reference's ``lax.scan``
over groups is a Python loop here.

The decode step implements the paper's Asynchronous Overlap semantics
(``repro/models/transformer.py``):

  * device rows and host-offloaded rows share every linear op in one
    unified batch;
  * device rows run attention on the card against the slot KV cache
    (``kernels.ops.decode_attention``);
  * host rows *consume* the host-computed attention for their current
    layer and *emit* fresh Q/K/V for their next attention layer;
  * host rows commit residual updates only inside their layer window
    [window_start, window_end); elsewhere they ride along.

KV caches are written in place (the reference's ``.at[].set`` on donated
buffers), so the state passed in is the state updated.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.models.config import FFNKind, ModelConfig
from repro_torch.models.kv_cache import AttnKV, StackState
from repro_torch.models.layers import (Params, attention_output, dense_init_,
                                       mlp, qkv_project, rmsnorm,
                                       rope_frequencies)


class HostIO(NamedTuple):
    """Per-iteration host-offload interface of the unified decode step.
    Layer indices and the window are host ints; tensors live on the
    model's device."""

    x_carry: torch.Tensor       # (Bc, d) residual carry of host rows
    positions: torch.Tensor     # (Bc,) int32 token positions of host rows
    attn_in: torch.Tensor       # (Bc, H, D) fp32 host attention for consume_layer
    consume_layer: int          # absolute layer index, -1 = none
    emit_layer: int             # attention layer to emit QKV at, -1 = none
    window_start: int           # first layer host rows commit at
    window_end: int             # exclusive end of the commit window
    row_valid: torch.Tensor     # (Bc,) bool rows in the active cohort


class QKVOut(NamedTuple):
    """Q/K/V emitted for the host backend, fp32 (zeros when no layer
    emitted this step)."""

    q: torch.Tensor  # (Bc, H, D)
    k: torch.Tensor  # (Bc, KV, D)
    v: torch.Tensor  # (Bc, KV, D)


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.has_recurrent or cfg.ffn_kind != FFNKind.DENSE \
            or cfg.frontend != "none" or not cfg.causal:
        raise NotImplementedError(
            f"{cfg.name}: the port runs dense causal attention-only "
            "stacks with token inputs")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def stack_init(cfg: ModelConfig, gen: torch.Generator,
               device: torch.device) -> Tuple[Params, ...]:
    """Random blocks: a tuple over pattern entries, leaves (G, ...)."""
    _check_supported(cfg)
    dt = getattr(torch, cfg.param_dtype)
    d, hd, g = cfg.d_model, cfg.resolved_head_dim, cfg.num_groups

    def dense(i, o):
        return dense_init_(torch.empty((g, i, o), dtype=dt, device=device),
                           gen)

    def ones():
        return torch.ones((g, d), dtype=dt, device=device)

    out = []
    for _ in cfg.block_pattern:
        out.append({
            "ln1": {"scale": ones()},
            "attn": {"wq": dense(d, cfg.num_heads * hd),
                     "wk": dense(d, cfg.num_kv_heads * hd),
                     "wv": dense(d, cfg.num_kv_heads * hd),
                     "wo": dense(cfg.num_heads * hd, d)},
            "ln2": {"scale": ones()},
            "ffn": {"w_gate": dense(d, cfg.d_ff), "w_up": dense(d, cfg.d_ff),
                    "w_down": dense(cfg.d_ff, d)},
        })
    return tuple(out)


def state_init(cfg: ModelConfig, *, device_batch: int, cache_len: int,
               device: torch.device,
               kv_dtype: torch.dtype = torch.bfloat16) -> StackState:
    """Zero decode state.  The KV cache is bf16 whatever the parameter
    dtype, as in the reference."""
    _check_supported(cfg)
    shape = (cfg.num_groups, device_batch, cache_len, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    per_entry = tuple(
        AttnKV(k=torch.zeros(shape, dtype=kv_dtype, device=device),
               v=torch.zeros(shape, dtype=kv_dtype, device=device))
        for _ in cfg.block_pattern)
    return StackState(per_entry=per_entry,
                      lengths=torch.zeros((device_batch,), dtype=torch.int32,
                                          device=device))


def layer_params(blocks: Tuple[Params, ...], j: int, g: int) -> Params:
    """Views of pattern entry j's parameters at group g."""
    return {name: {k: w[g] for k, w in sub.items()}
            for name, sub in blocks[j].items()}


# ---------------------------------------------------------------------------
# Prefill forward
# ---------------------------------------------------------------------------


def _ffn(p: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    h2 = rmsnorm(p["ln2"], x, cfg.norm_eps)
    return x + mlp(p["ffn"], h2)


def _attn_full(p: Params, cfg: ModelConfig, x: torch.Tensor,
               positions: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
               lengths: torch.Tensor, inv_freq: torch.Tensor) -> torch.Tensor:
    """Prefill attention block.  x: (B, T, d); kc, vc: this layer's
    (B, S, KV, D) cache, written in place at [lengths, lengths + T)."""
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    q, k, v = qkv_project(p["attn"], h, cfg.num_heads, cfg.num_kv_heads,
                          cfg.resolved_head_dim, positions, inv_freq)
    b, t = x.shape[:2]
    rows = torch.arange(b, device=x.device)[:, None]
    # padding past the cache end lands on its last column, which no real
    # token occupies at prefill and decode overwrites before reading (the
    # reference's scatter drops out-of-range writes instead)
    cols = positions.long().clamp(max=kc.shape[1] - 1)
    # in place: the reference's .at[rows, cols].set on a donated cache
    kc[rows, cols] = k.to(kc.dtype)
    vc[rows, cols] = v.to(vc.dtype)
    # causality on absolute positions (k <= lengths + i) also hides every
    # cache column past the span just written
    attn = ops.prefill_attention(q, kc, vc, q_offset=lengths)
    return _ffn(p, cfg, x + attention_output(p["attn"], attn))


def stack_forward(blocks: Tuple[Params, ...], cfg: ModelConfig,
                  x: torch.Tensor, positions: torch.Tensor,
                  state: StackState) -> Tuple[torch.Tensor, StackState]:
    """Run the stack over a (right-padded) token span, writing its K/V
    into ``state`` in place; returns (x, state with lengths + T)."""
    _check_supported(cfg)
    inv_freq = rope_frequencies(cfg.resolved_head_dim, cfg.rope_theta,
                                x.device)
    for g in range(cfg.num_groups):
        for j in range(cfg.pattern_period):
            kv = state.per_entry[j]
            x = _attn_full(layer_params(blocks, j, g), cfg, x, positions,
                           kv.k[g], kv.v[g], state.lengths, inv_freq)
    return x, StackState(per_entry=state.per_entry,
                         lengths=state.lengths + x.shape[1])


# ---------------------------------------------------------------------------
# Unified decode step (APEX Asynchronous Overlap semantics)
# ---------------------------------------------------------------------------


def _attn_decode(p: Params, cfg: ModelConfig, x: torch.Tensor,
                 positions: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
                 rows: torch.Tensor, lengths: torch.Tensor,
                 layer_idx: int, host: Optional[HostIO], device_batch: int,
                 inv_freq: torch.Tensor):
    """One attention block for one decode token.  x: (B, d).

    Returns (x_new (pre-commit), q, k, v) with q/k/v (B, 1, heads, D)."""
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)[:, None]               # (B,1,d)
    q, k, v = qkv_project(p["attn"], h, cfg.num_heads, cfg.num_kv_heads,
                          cfg.resolved_head_dim, positions[:, None], inv_freq)
    bg = device_batch
    # device rows: write the fresh token in place, attend over the cache
    kc[rows, lengths] = k[:bg, 0].to(kc.dtype)
    vc[rows, lengths] = v[:bg, 0].to(vc.dtype)
    attn = ops.decode_attention(q[:bg, 0], kc, vc, (lengths + 1).int())
    if host is not None:
        if layer_idx == host.consume_layer:
            attn_c = host.attn_in.to(attn.dtype)
        else:
            attn_c = torch.zeros((x.shape[0] - bg,) + attn.shape[1:],
                                 dtype=attn.dtype, device=x.device)
        attn = torch.cat([attn, attn_c], dim=0)                   # (B,H,D)
    x = x + attention_output(p["attn"], attn[:, None])[:, 0]
    return _ffn(p, cfg, x[:, None])[:, 0], q, k, v


def decode_step(blocks: Tuple[Params, ...], cfg: ModelConfig,
                x: torch.Tensor, positions: torch.Tensor, state: StackState,
                host: Optional[HostIO] = None):
    """One decode iteration over the unified batch.

    x: (B, d) residual-stream input -- device rows carry the fresh token
    embedding, host rows carry ``host.x_carry``.  positions: (B,).
    Returns (x_final (B, d), new_state, qkv_out | None).
    """
    _check_supported(cfg)
    device_batch = state.lengths.shape[0]
    total = x.shape[0]
    period = cfg.pattern_period
    inv_freq = rope_frequencies(cfg.resolved_head_dim, cfg.rope_theta,
                                x.device)
    rows = torch.arange(device_batch, device=x.device)
    lengths = state.lengths.long()
    qkv_out = None
    if host is not None:
        bc = total - device_batch
        hd = cfg.resolved_head_dim
        qkv_out = QKVOut(
            q=torch.zeros((bc, cfg.num_heads, hd), device=x.device),
            k=torch.zeros((bc, cfg.num_kv_heads, hd), device=x.device),
            v=torch.zeros((bc, cfg.num_kv_heads, hd), device=x.device))
    for g in range(cfg.num_groups):
        for j in range(period):
            layer_idx = g * period + j
            kv = state.per_entry[j]
            x_new, q, k, v = _attn_decode(
                layer_params(blocks, j, g), cfg, x, positions, kv.k[g],
                kv.v[g], rows, lengths, layer_idx, host, device_batch,
                inv_freq)
            if host is None:
                x = x_new
                continue
            if layer_idx == host.emit_layer:
                # fresh tensors (never aliased by a later in-place cache
                # write), fp32 as the reference's accumulator promotes
                qkv_out = QKVOut(q=q[device_batch:, 0].float(),
                                 k=k[device_batch:, 0].float(),
                                 v=v[device_batch:, 0].float())
            if host.window_start <= layer_idx < host.window_end:
                host_rows = torch.where(host.row_valid[:, None],
                                        x_new[device_batch:], x[device_batch:])
            else:
                host_rows = x[device_batch:]
            x = torch.cat([x_new[:device_batch], host_rows], dim=0)
    new_state = StackState(per_entry=state.per_entry,
                           lengths=state.lengths + 1)
    return x, new_state, qkv_out
