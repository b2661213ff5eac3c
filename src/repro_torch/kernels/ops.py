"""Attention entry points the model calls.

A tensor on the CPU takes the plain PyTorch version in ``ref``; any
other device goes to the hand-written CUDA kernel, whose wrapper raises
on what it cannot take.  There is no fallback between the two.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import decode_attention as _dec
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
