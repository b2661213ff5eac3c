"""Recurrent blocks: the Mamba-1 block of the hybrid (Jamba-family)
stacks and the xLSTM blocks (sLSTM, mLSTM).

Port of ``repro/models/ssm.py``.  Every block has the same contract:

  * ``<kind>_init(...)``                        -- random parameters
  * ``<kind>_init_state(...)``                  -- zero decode state
  * ``<kind>_forward(params, ..., x, state, valid_lens)``
                                              -> (y, new_state)
  * ``<kind>_forward_chunk(..., chunk_lens, q_offset)`` -- the same block
    resuming a chunked prefill from its carried state

``x`` is (B, T, d_model); decode is the same block at T = 1.  The Mamba
selective scan runs in ``kernels.ops.mamba_selective_scan`` and the
sLSTM / mLSTM recurrences in ``kernels.ops.slstm_recurrence`` /
``mlstm_recurrence`` (hand-written CUDA kernels on the card, their plain
loops on the CPU), where the reference runs ``lax.scan``s.

Length-masked scan: ``valid_lens`` (B,) int32 counts the real tokens of
each row in this call.  Every block freezes a row's carry past its
length and gathers its rolling conv window at the row's true end, so a
right-padded batch carries bit-identical state to unpadded per-request
runs, and a row with length 0 keeps its state bit for bit (the decode
step passes the host rows' commit mask this way).

dtype steps follow the reference exactly: the conv windows are stored in
bf16 whatever the parameter dtype; the depthwise convs and their SiLU
run in fp32 and cast to x's dtype; Mamba's dt is ``softplus`` in fp32
and its scan inputs are fp32; the xLSTM cells run in fp32 with
exponential gates stabilised by the running maximum ``m`` (mLSTM's
forget gate through ``log_sigmoid``), and their hidden states are cast
to x's dtype before the output projections.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import (as_dtensor, constrain,
                                              is_dtensor, merge_heads,
                                              pointwise, split_last)
from repro_torch.kernels import ops
from repro_torch.models.config import MambaConfig
from repro_torch.models.layers import Params, dense_init_


class MambaState(NamedTuple):
    conv: torch.Tensor   # (B, conv_dim-1, inner) bf16 rolling conv window
    ssm: torch.Tensor    # (B, inner, N) fp32 SSM hidden state


def mamba_init(cfg: MambaConfig, d_model: int, gen: torch.Generator, *,
               groups: int, dtype: torch.dtype,
               device: torch.device) -> Params:
    """Random parameters of ``groups`` stacked blocks (leading G axis) in
    the reference's names and layout (weights (in, out), applied as
    ``x @ w``; dt_bias, a_log and d_skip fp32).  A is the S4 init
    A_n = -(n+1); dt_bias is the inverse softplus of dt drawn log-uniform
    in [1e-3, 1e-1]; D is one."""
    inner = cfg.expand * d_model
    dtr = cfg.resolved_dt_rank(d_model)
    n = cfg.state_dim
    f32 = torch.float32

    def dense(i, o):
        return dense_init_(torch.empty((groups, i, o), dtype=dtype,
                                       device=device), gen)

    p = {"in_proj": dense(d_model, 2 * inner)}
    conv = torch.randn((groups, inner, cfg.conv_dim), generator=gen,
                       dtype=f32, device=device) / math.sqrt(cfg.conv_dim)
    p["conv_w"] = conv.to(dtype)
    p["conv_b"] = torch.zeros((groups, inner), dtype=dtype, device=device)
    p["x_proj"] = dense(inner, dtr + 2 * n)
    p["dt_proj"] = dense(dtr, inner)
    u = torch.rand((groups, inner), generator=gen, dtype=f32, device=device)
    dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    p["dt_bias"] = dt + torch.log(-torch.expm1(-dt))
    a = torch.arange(1, n + 1, dtype=f32, device=device)
    p["a_log"] = torch.log(a).expand(groups, inner, n).contiguous()
    p["d_skip"] = torch.ones((groups, inner), dtype=f32, device=device)
    p["out_proj"] = dense(inner, d_model)
    return p


def mamba_init_state(cfg: MambaConfig, d_model: int, batch: int, *,
                     device: torch.device,
                     groups: Optional[int] = None) -> MambaState:
    """Zero state for ``batch`` rows, with a leading ``groups`` axis when
    given (the stack's per-entry layout)."""
    inner = cfg.expand * d_model
    lead = (batch,) if groups is None else (groups, batch)
    return MambaState(
        conv=torch.zeros(lead + (cfg.conv_dim - 1, inner),
                         dtype=torch.bfloat16, device=device),
        ssm=torch.zeros(lead + (inner, cfg.state_dim), dtype=torch.float32,
                        device=device))


def _gather_conv_window(window: torch.Tensor, valid_lens: torch.Tensor,
                        tail: int) -> torch.Tensor:
    """Row b's next conv state: ``window[b, len_b : len_b + tail]`` of the
    (B, tail + T, I) window, the inputs before its true end.  len_b == 0
    returns the carried state."""
    idx = valid_lens.long()[:, None] + torch.arange(
        tail, device=window.device)[None, :]                      # (B, tail)
    idx = idx[..., None].expand(-1, -1, window.shape[-1])
    return torch.gather(window, 1, idx)


def mamba_forward(params: Params, cfg: MambaConfig, x: torch.Tensor,
                  state: MambaState,
                  valid_lens: Optional[torch.Tensor] = None,
                  h_out: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, MambaState]:
    """x: (B, T, d_model) -> (y (B, T, d_model), new_state).  The state
    passed in is not modified, unless ``h_out`` is given: the new SSM
    state is then written into ``h_out`` (contiguous fp32 (B, I, N)),
    which may be ``state.ssm`` itself to update it in place, and
    ``new_state.ssm`` is ``h_out``."""
    _, t, d = x.shape
    dtr = cfg.resolved_dt_rank(d)
    n = cfg.state_dim
    xin, z = (x @ params["in_proj"]).chunk(2, dim=-1)             # (B,T,I)

    # causal depthwise conv over time, seeded with the rolling state
    window = torch.cat([state.conv.to(xin.dtype), xin], dim=1)
    tail = cfg.conv_dim - 1
    if tail <= 0:
        new_conv = state.conv
    elif valid_lens is None:
        new_conv = window[:, -tail:]
    else:
        new_conv = _gather_conv_window(window, valid_lens, tail)
    # K shifted windows, multiplied and summed in fp32 (not F.conv1d,
    # which takes cuDNN's TF32 path on the card)
    conv_w = params["conv_w"].float()                              # (I, K)
    xc = window[:, 0:t].float() * conv_w[:, 0]
    for k in range(1, cfg.conv_dim):
        xc = xc + window[:, k:k + t].float() * conv_w[:, k]
    xc = F.silu(xc + params["conv_b"].float()).to(x.dtype)

    # x_proj contracts the inner dim: under a mesh its partial sums are
    # completed here, before the dt projection and the scan take them
    proj = constrain(xc @ params["x_proj"], "batch", "seq", None)
    dt_r, bmat, cmat = proj.split([dtr, n, n], dim=-1)
    # jax.nn.softplus is logaddexp(v, 0)
    v = (dt_r @ params["dt_proj"]).float() + params["dt_bias"]
    dt = torch.logaddexp(v, torch.zeros((), device=v.device))
    a_neg = -torch.exp(params["a_log"])                            # (I, N)
    lens = None if valid_lens is None else valid_lens.int()
    y, h_final = ops.mamba_selective_scan(
        dt.contiguous(), xc.float().contiguous(), bmat.float().contiguous(),
        cmat.float().contiguous(), a_neg, params["d_skip"],
        state.ssm.contiguous(), lens, h_out)
    y = y.to(x.dtype) * F.silu(z.float()).to(x.dtype)
    out = y @ params["out_proj"]
    return out, MambaState(conv=new_conv.to(state.conv.dtype), ssm=h_final)


def mamba_forward_chunk(params: Params, cfg: MambaConfig, x: torch.Tensor,
                        state: MambaState, chunk_lens: torch.Tensor,
                        q_offset: Optional[torch.Tensor] = None,
                        h_out: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, MambaState]:
    """Resume a Mamba scan from the carried ``state`` (conv window and
    SSM state of positions < ``q_offset``) and consume ``chunk_lens[b]``
    real tokens per row -- the recurrent analogue of attention's
    ``q_offset``.  The offset is unused: a recurrence holds its past in
    the state, so resuming is the length-masked forward from it, and a
    row with ``chunk_lens`` 0 keeps its state bit for bit."""
    del q_offset
    return mamba_forward(params, cfg, x, state, chunk_lens, h_out)


# ---------------------------------------------------------------------------
# xLSTM -- sLSTM (scalar memory) and mLSTM (matrix memory)
# ---------------------------------------------------------------------------


class SLSTMState(NamedTuple):
    c: torch.Tensor   # (B, H, hd) fp32 cell
    n: torch.Tensor   # (B, H, hd) fp32 normaliser
    h: torch.Tensor   # (B, H, hd) fp32 hidden (the recurrent input)
    m: torch.Tensor   # (B, H, hd) fp32 stabiliser


class MLSTMState(NamedTuple):
    """The mLSTM block's state.  The reference nests the cell's state
    (``MLSTMState(cmat, n, m)``) inside ``MLSTMBlockState(cell, conv)``;
    here the four tensors are one flat tuple, so every row move that
    walks an entry's tensors (``serving.tiermove``) takes it as it
    takes Mamba's."""

    cmat: torch.Tensor  # (B, H, hd, hd) fp32 matrix memory
    n: torch.Tensor     # (B, H, hd) fp32 normaliser
    m: torch.Tensor     # (B, H) fp32 stabiliser
    conv: torch.Tensor  # (B, 3, inner) bf16 rolling conv window


# the stabiliser's initial value: exp(x - m) of the first step is then
# exp(x - max(x, f - 1e30)) = 1
M_INIT = -1e30
MLSTM_PROJ_FACTOR = 2       # mLSTM inner width = 2 * d_model
MLSTM_CONV = 4              # mLSTM causal depthwise conv width


def slstm_init(d_model: int, num_heads: int, gen: torch.Generator, *,
               groups: int, dtype: torch.dtype,
               device: torch.device) -> Params:
    """Random sLSTM parameters of ``groups`` stacked blocks in the
    reference's names and layout: input gates (d, 4d), per-head recurrent
    gates (H, hd, 4hd) drawn normal / sqrt(hd), fp32 gate bias, the
    (d, d) output projection."""
    hd = d_model // num_heads

    def dense(i, o):
        return dense_init_(torch.empty((groups, i, o), dtype=dtype,
                                       device=device), gen)

    p = {"w_gates": dense(d_model, 4 * d_model)}
    r = torch.randn((groups, num_heads, hd, 4 * hd), generator=gen,
                    dtype=torch.float32, device=device) / math.sqrt(hd)
    p["r_gates"] = r.to(dtype)
    p["b_gates"] = torch.zeros((groups, 4 * d_model), dtype=torch.float32,
                               device=device)
    p["down_proj"] = dense(d_model, d_model)
    return p


def mlstm_init(d_model: int, num_heads: int, gen: torch.Generator, *,
               groups: int, dtype: torch.dtype,
               device: torch.device) -> Params:
    """Random mLSTM parameters of ``groups`` stacked blocks in the
    reference's names and layout: the (d, 2 inner) up projection, the
    conv taps drawn normal / 2 and a zero bias, the (inner, 3 inner)
    q/k/v projection, fp32 (inner, 2H) input and forget gates, the
    (inner, d) down projection."""
    inner = MLSTM_PROJ_FACTOR * d_model

    def dense(i, o, dt=dtype):
        return dense_init_(torch.empty((groups, i, o), dtype=dt,
                                       device=device), gen)

    p = {"in_proj": dense(d_model, 2 * inner)}
    conv = torch.randn((groups, inner, MLSTM_CONV), generator=gen,
                       dtype=torch.float32, device=device) / 2.0
    p["conv_w"] = conv.to(dtype)
    p["conv_b"] = torch.zeros((groups, inner), dtype=dtype, device=device)
    p["w_qkv"] = dense(inner, 3 * inner)
    p["w_gates"] = dense(inner, 2 * num_heads, torch.float32)
    p["down_proj"] = dense(inner, d_model)
    return p


def slstm_init_state(d_model: int, num_heads: int, batch: int, *,
                     device: torch.device,
                     groups: Optional[int] = None) -> SLSTMState:
    """Zero cell, normaliser and hidden state, the stabiliser at -1e30;
    a leading ``groups`` axis when given."""
    lead = (batch,) if groups is None else (groups, batch)
    shape = lead + (num_heads, d_model // num_heads)
    zeros = [torch.zeros(shape, dtype=torch.float32, device=device)
             for _ in range(3)]
    return SLSTMState(*zeros, m=torch.full(shape, M_INIT,
                                           dtype=torch.float32,
                                           device=device))


def mlstm_init_state(d_model: int, num_heads: int, batch: int, *,
                     device: torch.device,
                     groups: Optional[int] = None) -> MLSTMState:
    """Zero matrix memory, normaliser and conv window, the stabiliser at
    -1e30; a leading ``groups`` axis when given."""
    lead = (batch,) if groups is None else (groups, batch)
    inner = MLSTM_PROJ_FACTOR * d_model
    hd = inner // num_heads
    f32 = torch.float32
    return MLSTMState(
        cmat=torch.zeros(lead + (num_heads, hd, hd), dtype=f32,
                         device=device),
        n=torch.zeros(lead + (num_heads, hd), dtype=f32, device=device),
        m=torch.full(lead + (num_heads,), M_INIT, dtype=f32, device=device),
        conv=torch.zeros(lead + (MLSTM_CONV - 1, inner),
                         dtype=torch.bfloat16, device=device))


def _whole_heads(x: Optional[torch.Tensor],
                 like: torch.Tensor) -> Optional[torch.Tensor]:
    """A recurrence's input (or state, or lens) held as the kernels take
    it under a mesh: split over the batch's axes only, whole over every
    other dim (4 heads cannot split over a 16-way "model" axis), so the
    trace counts the collective a sharded run pays.  A plain tensor
    beside DTensor inputs (a block's fresh zero state) is taken as
    replicated first, which costs no collective.  A no-op off a mesh."""
    if x is None:
        return x
    if is_dtensor(like) and not is_dtensor(x):
        x = as_dtensor(x, like.device_mesh)
    return constrain(x, "batch", *(None,) * (x.dim() - 1))


def slstm_forward(params: Params, x: torch.Tensor, state: SLSTMState,
                  num_heads: int,
                  valid_lens: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, SLSTMState]:
    """x: (B, T, d) -> (y (B, T, d), new_state): the input gates, the
    recurrence (``ops.slstm_recurrence``: one kernel launch on the card),
    the output projection.  Past a row's ``valid_lens`` its state, and
    the hidden state it outputs, stay as they were (the reference's scan
    emits the masked ``h``).  The state passed in is not modified."""
    b, t, d = x.shape
    # the projections are held batch-sharded and replicated over "model"
    # under a mesh (the recurrence takes whole heads): left free, DTensor
    # shards T over "model" and its plans over the strided shards take
    # seconds each on the (2, 16, 16) mesh
    gates_all = constrain(x @ params["w_gates"], "batch", "seq",
                          None).float()                          # (B,T,4d)
    lens = None if valid_lens is None else valid_lens.to(x.device)
    c, n, h, m, lens = (_whole_heads(v, gates_all) for v in (*state, lens))
    hs, c, n, h, m = ops.slstm_recurrence(
        gates_all, params["r_gates"], params["b_gates"], c, n, h, m, lens)
    y = merge_heads(hs).to(x.dtype)
    return y @ params["down_proj"], SLSTMState(c=c, n=n, h=h, m=m)


def _mlstm_conv(params: Params, xin: torch.Tensor, conv_state: torch.Tensor,
                valid_lens: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal depthwise conv(4) with the rolling window: xin (B, T, I) ->
    (SiLU(conv) in xin's dtype, the next window in xin's dtype).  The
    shifted windows are multiplied and summed in fp32 (not F.conv1d,
    which takes cuDNN's TF32 path on the card)."""
    kdim = params["conv_w"].shape[-1]
    t = xin.shape[1]
    window = torch.cat([conv_state.to(xin.dtype), xin], dim=1)
    conv_w = params["conv_w"].float()
    out = window[:, 0:t].float() * conv_w[:, 0]
    for k in range(1, kdim):
        out = out + window[:, k:k + t].float() * conv_w[:, k]
    out = F.silu(out + params["conv_b"].float())
    if valid_lens is None:
        new_conv = window[:, -(kdim - 1):]
    else:
        new_conv = _gather_conv_window(window, valid_lens, kdim - 1)
    return out.to(xin.dtype), new_conv


def mlstm_forward(params: Params, x: torch.Tensor, state: MLSTMState,
                  num_heads: int,
                  valid_lens: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, MLSTMState]:
    """The mLSTM block body (the caller adds the residual): x (B, T, d)
    -> (y (B, T, d), new_state): the up projection, the conv, q/k/v and
    the gates, the recurrence (``ops.mlstm_recurrence``: one kernel
    launch on the card), the SiLU gate and the down projection.  Past a
    row's ``valid_lens`` its state stays as it was (the emitted h is
    still taken from the unmasked memory, as the reference's).  The
    state passed in is not modified."""
    b, t, _ = x.shape
    # projections held as in ``slstm_forward``
    xin, z = constrain(x @ params["in_proj"], "batch", "seq",
                       None).chunk(2, dim=-1)                     # (B,T,I)
    inner = xin.shape[-1]
    hd = inner // num_heads
    lens = None if valid_lens is None else valid_lens.to(x.device)
    xc, new_conv = _mlstm_conv(params, xin, state.conv, lens)
    q, k, v = constrain(xc @ params["w_qkv"], "batch", "seq",
                        None).chunk(3, dim=-1)
    q = split_last(q, num_heads, hd).float()
    k = (split_last(k, num_heads, hd) / math.sqrt(hd)).float()
    v = split_last(v, num_heads, hd).float()
    i_pre, f_pre = constrain(xc.float() @ params["w_gates"], "batch", "seq",
                             None).chunk(2, dim=-1)
    f_pre = pointwise(F.logsigmoid, f_pre)  # log-sigmoid forget gate
    q, k, v, i_pre, f_pre, cmat, n, m, lens = (
        _whole_heads(a, q) for a in (q, k, v, i_pre, f_pre, state.cmat,
                                     state.n, state.m, lens))
    hs, cmat, n, m = ops.mlstm_recurrence(q, k, v, i_pre, f_pre, cmat, n, m,
                                          lens)
    h = merge_heads(hs).to(x.dtype)
    h = h * F.silu(z.float()).to(x.dtype)
    return h @ params["down_proj"], MLSTMState(
        cmat=cmat, n=n, m=m, conv=new_conv.to(state.conv.dtype))


def slstm_forward_chunk(params: Params, x: torch.Tensor, state: SLSTMState,
                        num_heads: int, chunk_lens: torch.Tensor,
                        q_offset: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, SLSTMState]:
    """Resume an sLSTM from the carried ``state`` (see
    ``mamba_forward_chunk``)."""
    del q_offset
    return slstm_forward(params, x, state, num_heads, chunk_lens)


def mlstm_forward_chunk(params: Params, x: torch.Tensor, state: MLSTMState,
                        num_heads: int, chunk_lens: torch.Tensor,
                        q_offset: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, MLSTMState]:
    """Resume an mLSTM block from the carried ``state`` (see
    ``mamba_forward_chunk``)."""
    del q_offset
    return mlstm_forward(params, x, state, num_heads, chunk_lens)
