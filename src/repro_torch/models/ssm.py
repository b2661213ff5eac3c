"""Mamba-1 block: the recurrent half of the hybrid (Jamba-family) stacks.

Port of the Mamba part of ``repro/models/ssm.py``.  The contract:

  * ``mamba_init(cfg, d_model, gen, ...)``         -- random parameters
  * ``mamba_init_state(cfg, d_model, batch, ...)`` -- zero decode state
  * ``mamba_forward(params, cfg, x, state, valid_lens, h_out)``
                                                 -> (y, new_state)

``x`` is (B, T, d_model); decode is the same block at T = 1.  The
selective scan itself runs in ``kernels.ops.mamba_selective_scan`` (the
hand-written CUDA kernel on the card, its plain loop on the CPU), where
the reference runs a ``lax.scan``.

Length-masked scan: ``valid_lens`` (B,) int32 counts the real tokens of
each row in this call.  The scan freezes a row's carry past its length
and the rolling conv window is gathered at the row's true end, so a
right-padded batch carries bit-identical state to unpadded per-request
runs, and a row with length 0 keeps its state bit for bit (the decode
step passes the host rows' commit mask this way).

dtype steps follow the reference exactly: the conv window is stored in
bf16 whatever the parameter dtype; the depthwise conv and its SiLU run
in fp32 and cast to x's dtype; dt is ``softplus`` in fp32; the scan
inputs are fp32; ``y`` is cast to x's dtype before the ``silu(z)`` gate.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

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

    dt_r, bmat, cmat = (xc @ params["x_proj"]).split([dtr, n, n], dim=-1)
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
