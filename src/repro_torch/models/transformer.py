"""Block stack (attention, Mamba, sLSTM and mLSTM entries; dense, MoE or
no FFNs): init, the stateless forward, prefill, and the APEX unified
decode step.

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

The decode step and the span forward (prefill, a prefill chunk) are
built as a ``graphs.Chain``: pieces cut at each attention call, run
eagerly here, replayed as CUDA graphs by ``graphs.StepGraphs``.  The host
rows' layer fields enter the decode step as data (``host_controls``, per
layer masks read by ``torch.where``), so one capture serves every phase
of a cohort's journey; each select returns one operand, bit for bit.

Recurrent (Mamba, xLSTM) state spans every row of the unified batch:
host rows keep their recurrent state on the device and commit it only
inside their window, as their residual.  Attention caches hold the
device rows only.  KV caches and recurrent states are written in place
(the reference's ``.at[].set`` on donated buffers), so the state passed
in is the state updated.

Attention takes ``cfg.causal`` and a prefix-LM ``prefix_len`` (the VLM's
patch prefix) into ``kernels.ops.prefill_attention`` on every forward;
the stateless forward (``model.forward_train``) attends over the span
itself, as the reference's does.

The stateless forward is the training path: recurrent blocks start from
fresh zero state and nothing is written in place, so autograd follows it
through both kernels' ``torch.autograd.Function``s.  ``remat`` recomputes
each pattern group in the backward
(``torch.utils.checkpoint.checkpoint``, the reference's
``jax.checkpoint(group)``); router jitter draws from a generator seeded
per layer (the reference's ``fold_in(rng, layer)``), so the recompute
draws the same noise.

The reference's sharding constraints (``distributed.sharding.constrain``)
sit at its sites: a no-op unless a mesh is active and the tensor is a
DTensor (the dry-run).

An entry's FFN is an MoE (``models.moe``) where
``cfg.ffn_kind_for_entry(j)`` says so at init (every ``moe_period``-th
entry), and wherever a ``router`` leaf is present at apply time, in every
forward: bucketed and chunked prefill, decode and the host rows' ride
along.  The MoE sees the whole call's tokens, so the capacity path above
``moe.DROPLESS_TOKEN_THRESHOLD`` tokens routes over a chunk's padded
positions too, as the reference does.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch.distributed.sharding import constrain, is_dtensor
from repro_torch.kernels import ops
from repro_torch.models import moe, ssm
from repro_torch.models.config import BlockKind, FFNKind, ModelConfig
from repro_torch.models.graphs import IO, Chain, Op
from repro_torch.models.kv_cache import AttnKV, StackState, write_rows
from repro_torch.models.layers import (Params, attention_output, dense_init_,
                                       mlp, qkv_project, rmsnorm,
                                       rope_frequencies)
from repro_torch.tracing import span


class HostIO(NamedTuple):
    """Per-iteration host-offload interface of the unified decode step.
    Layer indices and the window are host ints (the step takes them as
    data: ``host_controls``); tensors live on the model's device."""

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


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def stack_init(cfg: ModelConfig, gen: torch.Generator,
               device: torch.device) -> Tuple[Params, ...]:
    """Random blocks: a tuple over pattern entries, leaves (G, ...), with
    the reference's parameter names.  Attention and Mamba entries carry
    an FFN unless the config's kind is NONE; xLSTM entries carry none."""
    dt = getattr(torch, cfg.param_dtype)
    d, hd, g = cfg.d_model, cfg.resolved_head_dim, cfg.num_groups

    def dense(i, o):
        return dense_init_(torch.empty((g, i, o), dtype=dt, device=device),
                           gen)

    def ones():
        return torch.ones((g, d), dtype=dt, device=device)

    out = []
    for j, kind in enumerate(cfg.block_pattern):
        p: Params = {"ln1": {"scale": ones()}}
        if kind == BlockKind.ATTN:
            p["attn"] = {"wq": dense(d, cfg.num_heads * hd),
                         "wk": dense(d, cfg.num_kv_heads * hd),
                         "wv": dense(d, cfg.num_kv_heads * hd),
                         "wo": dense(cfg.num_heads * hd, d)}
        elif kind == BlockKind.MAMBA:
            p["mamba"] = ssm.mamba_init(cfg.mamba, d, gen, groups=g,
                                        dtype=dt, device=device)
        else:
            init = ssm.slstm_init if kind == BlockKind.SLSTM \
                else ssm.mlstm_init
            p[kind.value] = init(d, cfg.num_heads, gen, groups=g, dtype=dt,
                                 device=device)
            out.append(p)
            continue
        ffn_kind = cfg.ffn_kind_for_entry(j)
        if ffn_kind == FFNKind.NONE:
            out.append(p)
            continue
        p["ln2"] = {"scale": ones()}
        if ffn_kind == FFNKind.MOE:
            p["ffn"] = moe.moe_init(d, cfg.moe, gen, groups=g, dtype=dt,
                                    device=device)
        else:
            p["ffn"] = {"w_gate": dense(d, cfg.d_ff),
                        "w_up": dense(d, cfg.d_ff),
                        "w_down": dense(cfg.d_ff, d)}
        out.append(p)
    return tuple(out)


def recurrent_state_init(cfg: ModelConfig, kind: BlockKind, batch: int,
                         device: torch.device):
    """Zero state of one recurrent pattern entry for ``batch`` rows,
    stacked over the G groups (the xLSTM stabilisers at -1e30)."""
    if kind == BlockKind.MAMBA:
        return ssm.mamba_init_state(cfg.mamba, cfg.d_model, batch,
                                    device=device, groups=cfg.num_groups)
    init = ssm.slstm_init_state if kind == BlockKind.SLSTM \
        else ssm.mlstm_init_state
    return init(cfg.d_model, cfg.num_heads, batch, device=device,
                groups=cfg.num_groups)


def state_init(cfg: ModelConfig, *, device_batch: int, host_batch: int = 0,
               cache_len: int, device: torch.device,
               kv_dtype: torch.dtype = torch.bfloat16) -> StackState:
    """Zero decode state.  Attention caches hold the ``device_batch`` rows
    (host rows' KV lives in the host pool) and are bf16 whatever the
    parameter dtype, as in the reference; recurrent states hold every
    row, ``device_batch + host_batch``."""
    shape = (cfg.num_groups, device_batch, cache_len, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    per_entry = tuple(
        AttnKV(k=torch.zeros(shape, dtype=kv_dtype, device=device),
               v=torch.zeros(shape, dtype=kv_dtype, device=device))
        if kind == BlockKind.ATTN else
        recurrent_state_init(cfg, kind, device_batch + host_batch, device)
        for kind in cfg.block_pattern)
    return StackState(per_entry=per_entry,
                      lengths=torch.zeros((device_batch,), dtype=torch.int32,
                                          device=device))


def layer_params(blocks: Tuple[Params, ...], j: int, g: int) -> Params:
    """Views of pattern entry j's parameters at group g."""
    return {name: {k: w[g] for k, w in sub.items()}
            for name, sub in blocks[j].items()}


# ---------------------------------------------------------------------------
# Full-span forward (stateless, prefill, chunk)
# ---------------------------------------------------------------------------


def _residual(x: torch.Tensor) -> torch.Tensor:
    """The residual stream (B, T, d) after a mixer's or an FFN's add, held
    batch-sharded and replicated over "model" under a mesh (a partial sum
    is all-reduced there, Megatron's row-parallel form).  Sites the
    reference does not have: left free, DTensor may shard T over "model"
    and later flatten (B, T) into a strided shard, whose redistribution
    plans take seconds each on the (2, 16, 16) mesh."""
    return constrain(x, "batch", "seq", None)


def _ffn(p: Params, cfg: ModelConfig, x: torch.Tensor,
         aux: Optional[List[torch.Tensor]] = None,
         generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Residual FFN over x (B, T, d); x itself where the entry has none.
    A ``router`` leaf marks an MoE, whose load-balance loss is appended
    to ``aux`` when given (a training term: serving drops it);
    ``generator`` draws its router jitter (training only)."""
    if "ffn" not in p:
        return x
    with span("model.ffn"):
        h2 = rmsnorm(p["ln2"], x, cfg.norm_eps)
        if "router" in p["ffn"]:
            out, loss = moe.moe_ffn(p["ffn"], h2, cfg.moe,
                                    generator=generator)
            if aux is not None:
                aux.append(loss)
            return _residual(x + out)
        return _residual(x + mlp(p["ffn"], h2))


def _attn_in(p: Params, cfg: ModelConfig, x: torch.Tensor,
             positions: torch.Tensor, inv_freq: torch.Tensor,
             kc: Optional[torch.Tensor] = None,
             vc: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The attention block over x (B, T, d) up to its attention call:
    pre-norm, Q/K/V and RoPE.  With a cache (kc, vc: this layer's (B, S,
    KV, D)) the span's K/V are written in place at ``positions``.
    Returns (q, k, v)."""
    with span("model.attention"):
        h = rmsnorm(p["ln1"], x, cfg.norm_eps)
        q, k, v = qkv_project(p["attn"], h, cfg.num_heads, cfg.num_kv_heads,
                              cfg.resolved_head_dim, positions, inv_freq)
        q = constrain(q, "batch", None, "heads", None)
        if kc is not None:
            b = x.shape[0]
            rows = torch.arange(b, device=x.device)[:, None]
            # padding past the cache end lands on its last column, which
            # no real token occupies at prefill and decode overwrites
            # before reading (the reference's scatter drops out-of-range
            # writes instead)
            cols = positions.long().clamp(max=kc.shape[1] - 1)
            # in place: the reference's .at[rows, cols].set on a donated
            # cache
            if is_dtensor(kc):
                write_rows(kc, cols, k.to(kc.dtype))
                write_rows(vc, cols, v.to(vc.dtype))
            else:
                kc[rows, cols] = k.to(kc.dtype)
                vc[rows, cols] = v.to(vc.dtype)
    return q, k, v


def _attn_out(p: Params, cfg: ModelConfig, x: torch.Tensor,
              attn: torch.Tensor, aux: Optional[List[torch.Tensor]] = None,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The attention block over x (B, T, d) from its attention output
    (B, T, H, D): the output projection, the residual, then the FFN."""
    with span("model.attention"):
        attn = constrain(attn, "batch", None, "heads", None)
        x = _residual(x + attention_output(p["attn"], attn))
    return _ffn(p, cfg, x, aux, generator)


def _attn_full(p: Params, cfg: ModelConfig, x: torch.Tensor,
               positions: torch.Tensor, inv_freq: torch.Tensor,
               prefix_len: Optional[torch.Tensor] = None,
               aux: Optional[List[torch.Tensor]] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Attention block over x (B, T, d) attending over the span itself
    (the stateless forward)."""
    q, k, v = _attn_in(p, cfg, x, positions, inv_freq)
    with span("model.attention"):
        attn = ops.prefill_attention(q, k, v, prefix_len, causal=cfg.causal)
    return _attn_out(p, cfg, x, attn, aux, generator)


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
    return _ffn(p, cfg, _residual(x + y))


_XLSTM_FORWARD = {BlockKind.SLSTM: ssm.slstm_forward,
                  BlockKind.MLSTM: ssm.mlstm_forward}


def _xlstm_block(p: Params, cfg: ModelConfig, kind: BlockKind,
                 x: torch.Tensor, st, g: int,
                 valid_lens: Optional[torch.Tensor]) -> torch.Tensor:
    """sLSTM or mLSTM block over x (B, T, d): pre-norm, the recurrence
    from group g of the entry's state ``st``, the residual; the new state
    is copied back into that group (rows with valid_lens 0 keep theirs
    bit for bit).  No FFN."""
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    carried = type(st)(*(a[g] for a in st))
    y, new = _XLSTM_FORWARD[kind](p[kind.value], h, carried, cfg.num_heads,
                                  valid_lens)
    for dst, src in zip(st, new):
        dst[g].copy_(src)
    return _residual(x + y)


def _stateless_group(group: Tuple[Params, ...], cfg: ModelConfig, g: int,
                     x: torch.Tensor, positions: torch.Tensor,
                     inv_freq: torch.Tensor,
                     prefix_len: Optional[torch.Tensor],
                     seed: Optional[int]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Group g's entries (``group[j]``: entry j's parameters at group g)
    over the span: recurrent blocks from fresh zero state, nothing
    written in place.  Returns (x, the group's MoE
    load-balance loss): as the reference's stateless scan takes it, the
    last pattern entry's only (on Jamba, one of its four MoE entries;
    ROADMAP queue 3)."""
    b = x.shape[0]
    loss = torch.zeros((), dtype=torch.float32, device=x.device)
    for j, kind in enumerate(cfg.block_pattern):
        p = group[j]
        gen = None
        if seed is not None:
            gen = torch.Generator(device=x.device).manual_seed(
                seed + g * cfg.pattern_period + j)
        entry_aux: List[torch.Tensor] = []
        if kind == BlockKind.ATTN:
            x = _attn_full(p, cfg, x, positions, inv_freq, prefix_len,
                           entry_aux, gen)
        elif kind == BlockKind.MAMBA:
            zero = ssm.mamba_init_state(cfg.mamba, cfg.d_model, b,
                                        device=x.device)
            y, _ = ssm.mamba_forward(p["mamba"], cfg.mamba,
                                     rmsnorm(p["ln1"], x, cfg.norm_eps), zero)
            x = _ffn(p, cfg, _residual(x + y), entry_aux, gen)
        else:
            init = ssm.slstm_init_state if kind == BlockKind.SLSTM \
                else ssm.mlstm_init_state
            zero = init(cfg.d_model, cfg.num_heads, b, device=x.device)
            y, _ = _XLSTM_FORWARD[kind](p[kind.value],
                                        rmsnorm(p["ln1"], x, cfg.norm_eps),
                                        zero, cfg.num_heads)
            x = _residual(x + y)
        loss = entry_aux[0] if entry_aux else torch.zeros_like(loss)
    return x, loss


def stack_forward_stateless(blocks: Tuple[Params, ...], cfg: ModelConfig,
                            x: torch.Tensor, positions: torch.Tensor,
                            prefix_len: Optional[torch.Tensor] = None, *,
                            remat: bool = False,
                            seed: Optional[int] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The stateless forward over a span (``model.forward_train``):
    attention over the span itself, recurrent blocks from zero state,
    nothing written in place.  Returns (x, the MoE load-balance loss
    summed over groups).  ``remat`` recomputes each group in the backward
    when a gradient is being taken; ``seed`` seeds the router jitter of
    layer l with ``seed + l`` (None: no jitter)."""
    x = constrain(x, "batch", "seq", None)
    inv_freq = rope_frequencies(cfg.resolved_head_dim, cfg.rope_theta,
                                x.device)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    recompute = remat and torch.is_grad_enabled()
    # every stacked leaf unbound once: the backward then writes each
    # leaf's gradient with one stack of its G slices (indexing it per
    # group would zero-fill and add a whole (G, ...) tensor per layer)
    per_group = [{name: {k: w.unbind(0) for k, w in sub.items()}
                  for name, sub in entry.items()} for entry in blocks]
    for g in range(cfg.num_groups):
        group = tuple({name: {k: ws[g] for k, ws in sub.items()}
                       for name, sub in entry.items()} for entry in per_group)
        args = (group, cfg, g, x, positions, inv_freq, prefix_len, seed)
        if recompute:
            x, loss = torch.utils.checkpoint.checkpoint(
                _stateless_group, *args, use_reentrant=False)
        else:
            x, loss = _stateless_group(*args)
        x = constrain(x, "batch", "seq", None)
        total = total + loss
    return x, total


def span_layers(chain: Chain, blocks: Tuple[Params, ...],
                cfg: ModelConfig, state: StackState) -> None:
    """``stack_forward``'s layers appended to ``chain``, cut at each
    attention call.  ``io`` holds "x" (B, T, d), "positions" (B, T) and
    "lengths" (B,), the state's; optionally "valid_lens" and "prefix_len"
    (B,).  "x" holds the output."""
    inv_freq = rope_frequencies(cfg.resolved_head_dim, cfg.rope_theta,
                                state.lengths.device)

    def begin(io: IO) -> None:
        io["x"] = constrain(io["x"], "batch", "seq", None)
        if not cfg.causal:
            # full attention over the written positions: the causal mask
            # OR a prefix reaching the span's end is exactly
            # k < lengths + T
            io["prefix_len"] = (io["lengths"]
                                + io["x"].shape[1]).to(torch.int32)

    def group_end(io: IO) -> None:
        io["x"] = constrain(io["x"], "batch", "seq", None)

    chain.add(begin)
    for g in range(cfg.num_groups):
        for j, kind in enumerate(cfg.block_pattern):
            p = layer_params(blocks, j, g)
            entry = state.per_entry[j]
            if kind == BlockKind.ATTN:
                _span_attention(chain, p, cfg, entry.k[g], entry.v[g],
                                inv_freq)
            else:
                chain.add(_span_recurrent(p, cfg, kind, entry, g))
        chain.add(group_end)


def _span_attention(chain: Chain, p: Params, cfg: ModelConfig,
                    kc: torch.Tensor, vc: torch.Tensor,
                    inv_freq: torch.Tensor) -> None:
    def head(io: IO) -> None:
        io["q"] = _attn_in(p, cfg, io["x"], io["positions"], inv_freq, kc,
                           vc)[0]

    def attend(io: IO) -> torch.Tensor:
        # causality on absolute positions (k <= lengths + i) also hides
        # every cache column past the span just written
        with span("model.attention"):
            return ops.prefill_attention(io["q"], kc, vc,
                                         io.get("prefix_len"),
                                         q_offset=io["lengths"])

    def tail(io: IO) -> None:
        io["x"] = _attn_out(p, cfg, io["x"], io["attn"])

    chain.add(head)
    chain.cut(attend)
    chain.add(tail)


def _span_recurrent(p: Params, cfg: ModelConfig, kind: BlockKind, entry,
                    g: int) -> Op:
    def recurrent(io: IO) -> None:
        if kind == BlockKind.MAMBA:
            io["x"] = _mamba_block(p, cfg, io["x"], entry, g,
                                   io.get("valid_lens"))
        else:
            io["x"] = _xlstm_block(p, cfg, kind, io["x"], entry, g,
                                   io.get("valid_lens"))
    return recurrent


def stack_forward(blocks: Tuple[Params, ...], cfg: ModelConfig,
                  x: torch.Tensor, positions: torch.Tensor,
                  state: StackState,
                  valid_lens: Optional[torch.Tensor] = None,
                  prefix_len: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, StackState]:
    """Run the stack over a (right-padded) token span, writing its K/V and
    recurrent state into ``state`` in place; returns (x, state with
    lengths + T).  ``valid_lens`` (B,) counts each row's real tokens:
    recurrent blocks freeze their state past it, attention ignores it
    (the absolute-position causal mask already hides padded positions).
    A chunk of a prefill advances the lengths by its real tokens instead
    (``model.prefill_chunk``).  ``prefix_len`` (B,) makes keys below it
    visible to every query (prefix-LM).  The stateless forward is
    ``stack_forward_stateless``."""
    chain = Chain()
    span_layers(chain, blocks, cfg, state)
    io = {"x": x, "positions": positions, "lengths": state.lengths}
    if valid_lens is not None:
        io["valid_lens"] = valid_lens
    if prefix_len is not None:
        io["prefix_len"] = prefix_len
    x = chain.run(io)["x"]
    return x, StackState(per_entry=state.per_entry,
                         lengths=state.lengths + x.shape[1])


# ---------------------------------------------------------------------------
# Unified decode step (APEX Asynchronous Overlap semantics)
# ---------------------------------------------------------------------------

# the rows of ``host_controls``: per layer, whether the host rows take
# ``attn_in`` as their attention there, commit there (their window), and
# emit their Q/K/V there
CONSUME, COMMIT, EMIT = range(3)


def host_controls(cfg: ModelConfig, host: HostIO) -> np.ndarray:
    """``host``'s layer fields as data: (3, num_layers) bool, rows
    CONSUME, COMMIT and EMIT."""
    layer = np.arange(cfg.num_layers)
    return np.stack([layer == host.consume_layer,
                     (host.window_start <= layer) & (layer < host.window_end),
                     layer == host.emit_layer])


def decode_layers(chain: Chain, blocks: Tuple[Params, ...],
                  cfg: ModelConfig, state: StackState,
                  host_rows: Optional[int] = None) -> None:
    """The decode step's layers over the unified batch appended to
    ``chain``, cut at each attention call.

    ``io`` holds "x" (B, d) -- device rows carry the fresh token
    embedding, host rows their residual carry -- "positions" (B,) and
    "lengths" (Bg,), the state's.  With ``host_rows`` (Bc) also
    "attn_in" (Bc, H, D) fp32 host attention, "row_valid" (Bc,) and
    "controls" (``host_controls``).  Outputs: "x" (x_final) and, with
    host rows, "emit_q" / "emit_k" / "emit_v", fp32 (zeros where no layer
    emits)."""
    bg = state.lengths.shape[0]
    device = state.lengths.device
    hosted = host_rows is not None
    inv_freq = rope_frequencies(cfg.resolved_head_dim, cfg.rope_theta,
                                device)
    rows = torch.arange(bg, device=device)

    def begin(io: IO) -> None:
        io["x"] = constrain(io["x"], "batch", None)
        io["len_idx"] = io["lengths"].long()
        io["attn_lens"] = (io["len_idx"] + 1).int()
        if not hosted:
            return
        hd = cfg.resolved_head_dim
        for name, heads in (("q", cfg.num_heads), ("k", cfg.num_kv_heads),
                            ("v", cfg.num_kv_heads)):
            io["emit_" + name] = torch.zeros((host_rows, heads, hd),
                                             device=device)
        # the controls read once a step: per layer, the host rows'
        # attention (``attn_in`` at the consume layer, else zeros), the
        # rows that commit (device rows; valid host rows in their window)
        # and whether the host rows emit their Q/K/V
        ctl = io["controls"]
        io["emit"] = ctl[EMIT]
        io["consume"] = ctl[CONSUME]
        io["host_attn"] = io["attn_in"].to(io["x"].dtype)
        window = ctl[COMMIT][:, None]
        io["keep"] = torch.cat([
            torch.ones((cfg.num_layers, bg), dtype=torch.bool, device=device),
            window & io["row_valid"][None, :]], dim=1)
        if cfg.has_recurrent:
            # per-row commit lengths of the recurrent state (1 = commit,
            # 0 = ride along) inside and outside the host rows' window
            ones = torch.ones((bg,), dtype=torch.int32, device=device)
            commit_in = torch.cat([ones, io["row_valid"].int()])
            commit_out = torch.cat([ones, torch.zeros(
                (host_rows,), dtype=torch.int32, device=device)])
            io["commit_lens"] = torch.where(window, commit_in[None, :],
                                            commit_out[None, :])

    def commit(io: IO, layer: int, x_new: torch.Tensor) -> None:
        """Device rows take the layer's output; host rows inside their
        window too, valid rows only; the others ride along, bit for
        bit."""
        if hosted:
            x_new = torch.where(io["keep"][layer][:, None], x_new, io["x"])
        io["x"] = constrain(x_new, "batch", None)

    chain.add(begin)
    for g in range(cfg.num_groups):
        for j, kind in enumerate(cfg.block_pattern):
            layer = g * cfg.pattern_period + j
            p = layer_params(blocks, j, g)
            entry = state.per_entry[j]
            if kind == BlockKind.ATTN:
                _decode_attention(chain, p, cfg, layer, entry.k[g],
                                  entry.v[g], rows, inv_freq, hosted, commit)
            else:
                chain.add(_decode_recurrent(p, cfg, kind, layer, entry, g,
                                            hosted, commit))


def _decode_attention(chain: Chain, p: Params, cfg: ModelConfig,
                      layer: int, kc: torch.Tensor, vc: torch.Tensor,
                      rows: torch.Tensor, inv_freq: torch.Tensor,
                      hosted: bool, commit) -> None:
    """One attention block for one decode token.  A decode token attends
    every cached position up to its own, so causal and full attention
    are the same here, as in the reference."""
    bg = rows.shape[0]

    def head(io: IO) -> None:
        with span("model.attention"):
            h = rmsnorm(p["ln1"], io["x"], cfg.norm_eps)[:, None]  # (B,1,d)
            q, k, v = qkv_project(p["attn"], h, cfg.num_heads,
                                  cfg.num_kv_heads, cfg.resolved_head_dim,
                                  io["positions"][:, None], inv_freq)
            # device rows: write the fresh token in place
            lengths = io["len_idx"]
            if is_dtensor(kc):
                write_rows(kc, lengths[:, None], k[:bg].to(kc.dtype))
                write_rows(vc, lengths[:, None], v[:bg].to(vc.dtype))
            else:
                kc[rows, lengths] = k[:bg, 0].to(kc.dtype)
                vc[rows, lengths] = v[:bg, 0].to(vc.dtype)
        io["q"] = q[:bg, 0]
        if hosted:
            # fresh tensors (never aliased by a later in-place cache
            # write), fp32 as the reference's accumulator promotes (the
            # select promotes to the fp32 buffer, exactly)
            emit = io["emit"][layer]
            for name, t in (("q", q), ("k", k), ("v", v)):
                key = "emit_" + name
                io[key] = torch.where(emit, t[bg:, 0], io[key])

    def attend(io: IO) -> torch.Tensor:
        with span("model.attention"):
            return ops.decode_attention(io["q"], kc, vc, io["attn_lens"])

    def tail(io: IO) -> None:
        attn = io["attn"]
        with span("model.attention"):
            if hosted:
                host_attn = torch.where(io["consume"][layer],
                                        io["host_attn"], 0.0)
                attn = torch.cat([attn, host_attn], dim=0)        # (B,H,D)
            x = io["x"] + attention_output(p["attn"], attn[:, None])[:, 0]
        commit(io, layer, _ffn(p, cfg, x[:, None])[:, 0])

    chain.add(head)
    chain.cut(attend)
    chain.add(tail)


def _decode_recurrent(p: Params, cfg: ModelConfig, kind: BlockKind,
                      layer: int, entry, g: int, hosted: bool, commit) -> Op:
    def recurrent(io: IO) -> None:
        # host rows outside their window keep their state: a commit
        # length of 0 freezes it bit for bit
        lens = io["commit_lens"][layer] if hosted else None
        x = io["x"][:, None]
        if kind == BlockKind.MAMBA:
            x_new = _mamba_block(p, cfg, x, entry, g, lens)
        else:
            x_new = _xlstm_block(p, cfg, kind, x, entry, g, lens)
        commit(io, layer, x_new[:, 0])
    return recurrent
