"""Kernel entry points the model calls: attention, the selective scan and
the xLSTM recurrences.

A tensor on the CPU takes the plain PyTorch version in ``ref``; any
other device goes to the hand-written CUDA kernel, whose wrapper raises
on what it cannot take.  There is no fallback between the two.

A call that needs a gradient (grad mode on and an input that requires
one) goes through the kernel's ``torch.autograd.Function``, whose
backward is the backward kernel on the card and the plain backward on
the CPU.  Training passes neither ``q_offset`` nor ``lens`` nor
``h_out``; such a call is refused.

A tensor on the ``meta`` device (a DTensor whose local tensor is on
``meta`` included: the dry-run's) gets outputs of the kernel's shapes
and dtypes and nothing computed, forward and backward; ``empty_like``
carries DTensor placements through.  No aten op stands for a kernel, so
a dry-run counts the kernels' work from the calls ``record_meta_calls``
collects.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Optional, Tuple

import torch

from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import mamba_scan as _scan
from repro_torch.kernels import prefill_attention as _pre
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import xlstm as _xl


def _needs_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


_META_CALLS: List[List[Tuple[str, Dict[str, object]]]] = []


@contextlib.contextmanager
def record_meta_calls() -> Iterator[List[Tuple[str, Dict[str, object]]]]:
    """Collect (kernel name, local shapes) of every meta-rule call made
    inside the block, the backward rules' included."""
    calls: List[Tuple[str, Dict[str, object]]] = []
    _META_CALLS.append(calls)
    try:
        yield calls
    finally:
        _META_CALLS.remove(calls)


def meta_call(name: str, **shapes: object) -> None:
    """Note one kernel call that a meta rule stood for."""
    for calls in _META_CALLS:
        calls.append((name, shapes))


def local_shape(t: torch.Tensor) -> Tuple[int, ...]:
    """The shape of this rank's part of ``t`` (its local shard if it is a
    DTensor): what the kernel would run on."""
    return tuple(t.to_local().shape if hasattr(t, "to_local") else t.shape)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """(B,H,D) x (B,S,KV,D) -> (B,H,D) over the first lengths[b] positions."""
    if q.device.type == "meta":
        meta_call("decode_attention", q=local_shape(q), k=local_shape(k),
                  dtype=k.dtype)
        return torch.empty_like(q)
    if q.device.type == "cpu":
        return _ref.decode_attention_ref(q, k, v, lengths)
    return _dec.decode_attention_cuda(q, k, v, lengths)


def prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      prefix_len: Optional[torch.Tensor] = None,
                      q_offset: Optional[torch.Tensor] = None, *,
                      causal: bool = True) -> torch.Tensor:
    """(B,T,H,D) x (B,S,KV,D) causal attention at absolute positions
    ``q_offset[b] + i`` (chunked prefill), optional prefix-LM mask."""
    if _needs_grad(q, k, v):
        if q_offset is not None:
            raise ValueError("prefill_attention has no gradient through "
                             "q_offset (no training path takes one)")
        return _pre.PrefillAttentionFn.apply(q, k, v, prefix_len, causal)
    if q.device.type == "meta":
        _pre.meta_prefill(q, k, causal, q_offset is not None)
        return torch.empty_like(q)
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
    if _needs_grad(dt, x, b, c, a_neg, d_skip, h0):
        if lens is not None or h_out is not None:
            raise ValueError("mamba_selective_scan has no gradient with "
                             "lens or h_out (no training path takes them)")
        return _scan.MambaScanFn.apply(dt, x, b, c, a_neg, d_skip, h0)
    if dt.device.type == "meta":
        return _scan.meta_scan(dt, b, h0, h_out)
    if dt.device.type == "cpu":
        _scan.check_h_out(h0, h_out)
        y, h = _ref.mamba_selective_scan_ref(dt, x, b, c, a_neg, d_skip, h0,
                                             lens)
        if h_out is None:
            return y, h
        return y, h_out.copy_(h)
    return _scan.mamba_selective_scan_cuda(dt, x, b, c, a_neg, d_skip, h0,
                                           lens, h_out)


def _int_lens(lens: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if lens is None else lens.to(torch.int32).contiguous()


def slstm_recurrence(gates_x: torch.Tensor, r: torch.Tensor,
                     bias: torch.Tensor, c: torch.Tensor, n: torch.Tensor,
                     h: torch.Tensor, m: torch.Tensor,
                     lens: Optional[torch.Tensor] = None):
    """sLSTM over T: gates_x (B,T,4d) fp32, r (H,hd,4hd), bias (4d,), the
    state c, n, h, m (B,H,hd) fp32, state and emitted h frozen past
    ``lens[b]`` -> (hs (B,T,H,hd) fp32, c, n, h, m)."""
    if _needs_grad(gates_x, r, bias, c, n, h, m):
        if lens is not None:
            raise ValueError("slstm_recurrence has no gradient with lens "
                             "(no training path takes them)")
        return _xl.SLSTMFn.apply(gates_x, r, bias, c, n, h, m)
    if gates_x.device.type == "meta":
        return _xl.meta_slstm(gates_x, r, c, n, h, m)
    if gates_x.device.type == "cpu":
        return _ref.slstm_recurrence_ref(gates_x, r, bias, c, n, h, m, lens)
    return _xl.slstm_scan_cuda(
        gates_x.contiguous(), r.contiguous(), bias.contiguous(),
        *(x.contiguous() for x in (c, n, h, m)), _int_lens(lens))


def mlstm_recurrence(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     i_pre: torch.Tensor, f_pre: torch.Tensor,
                     cmat: torch.Tensor, n: torch.Tensor, m: torch.Tensor,
                     lens: Optional[torch.Tensor] = None):
    """mLSTM over T: q, k, v (B,T,H,hd) fp32, i_pre, f_pre (B,T,H) fp32,
    the state cmat (B,H,hd,hd), n (B,H,hd), m (B,H) fp32, the state (not
    the emitted h) frozen past ``lens[b]`` -> (hs (B,T,H,hd) fp32, cmat,
    n, m)."""
    if _needs_grad(q, k, v, i_pre, f_pre, cmat, n, m):
        if lens is not None:
            raise ValueError("mlstm_recurrence has no gradient with lens "
                             "(no training path takes them)")
        return _xl.MLSTMFn.apply(q, k, v, i_pre, f_pre, cmat, n, m)
    if q.device.type == "meta":
        return _xl.meta_mlstm(q, cmat, n, m)
    if q.device.type == "cpu":
        return _ref.mlstm_recurrence_ref(q, k, v, i_pre, f_pre, cmat, n, m,
                                         lens)
    return _xl.mlstm_scan_cuda(
        *(x.contiguous() for x in (q, k, v, i_pre, f_pre, cmat, n, m)),
        _int_lens(lens))
