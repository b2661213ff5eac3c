"""Kernel entry points the model calls: attention and the selective scan.

A tensor on the CPU takes the plain PyTorch version in ``ref``; any
other device goes to the hand-written CUDA kernel, whose wrapper raises
on what it cannot take.  There is no fallback between the two.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import mamba_scan as _scan
from repro_torch.kernels import prefill_attention as _pre
from repro_torch.kernels import ref as _ref


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """(B,H,D) x (B,S,KV,D) -> (B,H,D) over the first lengths[b] positions."""
    if q.device.type == "cpu":
        return _ref.decode_attention_ref(q, k, v, lengths)
    return _dec.decode_attention_cuda(q, k, v, lengths)


def prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      prefix_len: Optional[torch.Tensor] = None,
                      q_offset: Optional[torch.Tensor] = None, *,
                      causal: bool = True) -> torch.Tensor:
    """(B,T,H,D) x (B,S,KV,D) causal attention at absolute positions
    ``q_offset[b] + i`` (chunked prefill), optional prefix-LM mask."""
    if q.device.type == "cpu":
        return _ref.prefill_attention_ref(q, k, v, prefix_len, q_offset,
                                          causal=causal)
    return _pre.prefill_attention_cuda(q, k, v, prefix_len, q_offset,
                                       causal=causal)


def mamba_selective_scan(dt: torch.Tensor, x: torch.Tensor, b: torch.Tensor,
                         c: torch.Tensor, a_neg: torch.Tensor,
                         d_skip: torch.Tensor, h0: torch.Tensor,
                         lens: Optional[torch.Tensor] = None,
                         h_out: Optional[torch.Tensor] = None):
    """Selective scan: dt, x (B,T,I); b, c (B,T,N); a_neg (I,N); d_skip
    (I,); h0 (B,I,N); state frozen past ``lens[b]`` -> (y, h_final) fp32.
    With ``h_out`` (contiguous fp32 (B,I,N), may be h0) the final state
    is written there and returned."""
    if dt.device.type == "cpu":
        _scan.check_h_out(h0, h_out)
        y, h = _ref.mamba_selective_scan_ref(dt, x, b, c, a_neg, d_skip, h0,
                                             lens)
        if h_out is None:
            return y, h
        return y, h_out.copy_(h)
    return _scan.mamba_selective_scan_cuda(dt, x, b, c, a_neg, d_skip, h0,
                                           lens, h_out)
