"""Block stack (attention and Mamba entries, dense or MoE FFNs): init,
prefill forward, and the APEX unified decode step.

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

Recurrent (Mamba) state spans every row of the unified batch: host rows
keep their recurrent state on the device and commit it only inside their
window, as their residual.  Attention caches hold the device rows only.
KV caches and recurrent states are written in place (the reference's
``.at[].set`` on donated buffers), so the state passed in is the state
updated.

An entry's FFN is an MoE (``models.moe``) where
``cfg.ffn_kind_for_entry(j)`` says so at init (every ``moe_period``-th
entry), and wherever a ``router`` leaf is present at apply time, in every
forward: bucketed and chunked prefill, decode and the host rows' ride
along.  The MoE sees the whole call's tokens, so the capacity path above
``moe.DROPLESS_TOKEN_THRESHOLD`` tokens routes over a chunk's padded
positions too, as the reference does.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.models import moe, ssm
from repro_torch.models.config import BlockKind, FFNKind, ModelConfig
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


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a stack the port cannot run yet,
    naming the ROADMAP item that brings it."""
    other = sorted({k.value for k in cfg.block_pattern}
                   - {BlockKind.ATTN.value, BlockKind.MAMBA.value})
    if other:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(other)} blocks are not ported yet "
            "(xLSTM, ROADMAP queue 1 item 7)")
    if cfg.ffn_kind not in (FFNKind.DENSE, FFNKind.MOE) \
            or cfg.frontend != "none" or not cfg.causal:
        raise NotImplementedError(
            f"{cfg.name}: the port runs causal stacks of attention and "
            "Mamba blocks with dense or MoE FFNs and token inputs (the "
            "encoder and VLM frontends: ROADMAP queue 1 item 12)")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def stack_init(cfg: ModelConfig, gen: torch.Generator,
               device: torch.device) -> Tuple[Params, ...]:
    """Random blocks: a tuple over pattern entries, leaves (G, ...), with
    the reference's parameter names."""
    check_supported(cfg)
    dt = getattr(torch, cfg.param_dtype)
    d, hd, g = cfg.d_model, cfg.resolved_head_dim, cfg.num_groups

    def dense(i, o):
        return dense_init_(torch.empty((g, i, o), dtype=dt, device=device),
                           gen)

    def ones():
        return torch.ones((g, d), dtype=dt, device=device)

    out = []
    for j, kind in enumerate(cfg.block_pattern):
        if kind == BlockKind.ATTN:
            p = {"ln1": {"scale": ones()},
                 "attn": {"wq": dense(d, cfg.num_heads * hd),
                          "wk": dense(d, cfg.num_kv_heads * hd),
                          "wv": dense(d, cfg.num_kv_heads * hd),
                          "wo": dense(cfg.num_heads * hd, d)}}
        else:
            p = {"ln1": {"scale": ones()},
                 "mamba": ssm.mamba_init(cfg.mamba, d, gen, groups=g,
                                         dtype=dt, device=device)}
        p["ln2"] = {"scale": ones()}
        if cfg.ffn_kind_for_entry(j) == FFNKind.MOE:
            p["ffn"] = moe.moe_init(d, cfg.moe, gen, groups=g, dtype=dt,
                                    device=device)
        else:
            p["ffn"] = {"w_gate": dense(d, cfg.d_ff),
                        "w_up": dense(d, cfg.d_ff),
                        "w_down": dense(cfg.d_ff, d)}
        out.append(p)
    return tuple(out)


def state_init(cfg: ModelConfig, *, device_batch: int, host_batch: int = 0,
               cache_len: int, device: torch.device,
               kv_dtype: torch.dtype = torch.bfloat16) -> StackState:
    """Zero decode state.  Attention caches hold the ``device_batch`` rows
    (host rows' KV lives in the host pool) and are bf16 whatever the
    parameter dtype, as in the reference; Mamba states hold every row,
    ``device_batch + host_batch``."""
    check_supported(cfg)
    shape = (cfg.num_groups, device_batch, cache_len, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    per_entry = tuple(
        AttnKV(k=torch.zeros(shape, dtype=kv_dtype, device=device),
               v=torch.zeros(shape, dtype=kv_dtype, device=device))
        if kind == BlockKind.ATTN else
        ssm.mamba_init_state(cfg.mamba, cfg.d_model,
                             device_batch + host_batch, device=device,
                             groups=cfg.num_groups)
        for kind in cfg.block_pattern)
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
    """Residual FFN over x (B, T, d); a ``router`` leaf marks an MoE
    (its load-balance loss is a training term, dropped here)."""
    h2 = rmsnorm(p["ln2"], x, cfg.norm_eps)
    if "router" in p["ffn"]:
        return x + moe.moe_ffn(p["ffn"], h2, cfg.moe)[0]
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


def _mamba_block(p: Params, cfg: ModelConfig, x: torch.Tensor,
                 st: ssm.MambaState, g: int,
                 valid_lens: Optional[torch.Tensor]) -> torch.Tensor:
    """Mamba block over x (B, T, d); group g of the entry's state ``st``
    is updated in place (rows with valid_lens 0 keep theirs): the scan
    writes the SSM state straight back into its slice."""
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    carried = ssm.MambaState(conv=st.conv[g], ssm=st.ssm[g])
    if valid_lens is None:
        y, new = ssm.mamba_forward(p["mamba"], cfg.mamba, h, carried,
                                   h_out=st.ssm[g])
    else:
        y, new = ssm.mamba_forward_chunk(p["mamba"], cfg.mamba, h, carried,
                                         valid_lens, h_out=st.ssm[g])
    st.conv[g].copy_(new.conv)
    return _ffn(p, cfg, x + y)


def stack_forward(blocks: Tuple[Params, ...], cfg: ModelConfig,
                  x: torch.Tensor, positions: torch.Tensor,
                  state: StackState,
                  valid_lens: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, StackState]:
    """Run the stack over a (right-padded) token span, writing its K/V and
    recurrent state into ``state`` in place; returns (x, state with
    lengths + T).  ``valid_lens`` (B,) counts each row's real tokens:
    Mamba blocks freeze their state past it; attention ignores it (the
    absolute-position causal mask already hides padded positions).  A
    chunk of a prefill advances the lengths by its real tokens instead
    (``model.prefill_chunk``)."""
    check_supported(cfg)
    inv_freq = rope_frequencies(cfg.resolved_head_dim, cfg.rope_theta,
                                x.device)
    for g in range(cfg.num_groups):
        for j, kind in enumerate(cfg.block_pattern):
            p = layer_params(blocks, j, g)
            entry = state.per_entry[j]
            if kind == BlockKind.ATTN:
                x = _attn_full(p, cfg, x, positions, entry.k[g], entry.v[g],
                               state.lengths, inv_freq)
            else:
                x = _mamba_block(p, cfg, x, entry, g, valid_lens)
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
    check_supported(cfg)
    device_batch = state.lengths.shape[0]
    total = x.shape[0]
    period = cfg.pattern_period
    inv_freq = rope_frequencies(cfg.resolved_head_dim, cfg.rope_theta,
                                x.device)
    rows = torch.arange(device_batch, device=x.device)
    lengths = state.lengths.long()
    qkv_out = None
    # per-row commit lengths of the Mamba state (1 = commit, 0 = ride
    # along) inside and outside the host rows' window; None: all commit
    commit_in = commit_out = None
    if host is not None:
        bc = total - device_batch
        hd = cfg.resolved_head_dim
        qkv_out = QKVOut(
            q=torch.zeros((bc, cfg.num_heads, hd), device=x.device),
            k=torch.zeros((bc, cfg.num_kv_heads, hd), device=x.device),
            v=torch.zeros((bc, cfg.num_kv_heads, hd), device=x.device))
        if cfg.has_recurrent:
            ones = torch.ones((device_batch,), dtype=torch.int32,
                              device=x.device)
            commit_in = torch.cat([ones, host.row_valid.int()])
            commit_out = torch.cat([ones, torch.zeros(
                (bc,), dtype=torch.int32, device=x.device)])
    for g in range(cfg.num_groups):
        for j, kind in enumerate(cfg.block_pattern):
            layer_idx = g * period + j
            in_window = host is not None and \
                host.window_start <= layer_idx < host.window_end
            p = layer_params(blocks, j, g)
            entry = state.per_entry[j]
            if kind == BlockKind.ATTN:
                x_new, q, k, v = _attn_decode(
                    p, cfg, x, positions, entry.k[g], entry.v[g], rows,
                    lengths, layer_idx, host, device_batch, inv_freq)
                if host is not None and layer_idx == host.emit_layer:
                    # fresh tensors (never aliased by a later in-place
                    # cache write), fp32 as the reference's accumulator
                    # promotes
                    qkv_out = QKVOut(q=q[device_batch:, 0].float(),
                                     k=k[device_batch:, 0].float(),
                                     v=v[device_batch:, 0].float())
            else:
                # host rows outside their window keep their state: a
                # commit length of 0 freezes it bit for bit
                x_new = _mamba_block(p, cfg, x[:, None], entry, g,
                                     commit_in if in_window
                                     else commit_out)[:, 0]
            if host is None:
                x = x_new
                continue
            if in_window:
                host_rows = torch.where(host.row_valid[:, None],
                                        x_new[device_batch:], x[device_batch:])
            else:
                host_rows = x[device_batch:]
            x = torch.cat([x_new[:device_batch], host_rows], dim=0)
    new_state = StackState(per_entry=state.per_entry,
                           lengths=state.lengths + 1)
    return x, new_state, qkv_out
