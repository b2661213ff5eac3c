"""Mamba-1 selective scan on the card: wrapper of ``csrc/mamba_scan.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/mamba_scan.py``
(``mamba_selective_scan`` / ``_scan_kernel``).  A lane keeps eight
consecutive fp32 states of one (batch row, inner channel) in registers
and walks T, so N / 8 neighbouring lanes share a channel (two at
Jamba's N 16), h0 and h_final move as 16-byte vectors, and y is summed
in one fixed order (a shuffle across the lanes).  A CTA of 128 threads
takes the channels of one row; T-tiles of their dt and x and of the
row's b and c arrive in shared memory by cp.async, double-buffered.  At
one decode step it is bound by the bytes of the state; over a prompt by
the bytes of dt, x and y and the N ``exp`` calls per step, and in
practice by the instructions of an ``expf`` accurate to 1e-5.
Sequential in T, so splitting a call in T with the state carried
between the parts gives the bits of one call.  The TPU kernel's
``resolve_block_i`` is tiling for the TPU and has no counterpart: the
kernel masks a ragged inner dimension itself.

``h_out`` takes the final state in place of a fresh tensor and may be
``h0`` itself: the model writes each layer's state back into its slice
of the stacked state this way, with no copy.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

STATE_DIMS = (8, 16)                 # N: reduced configs and Jamba
IN_DTYPES = (torch.float32, torch.bfloat16)

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = build.load("mamba_scan")
    fn = lib.apex_mamba_scan
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                       _I, _I, _I, _I, _I, _P]
        fn.restype = _I
    return lib


def check_h_out(h0: torch.Tensor, h_out: Optional[torch.Tensor]) -> None:
    """``h_out`` must be a contiguous fp32 tensor of h0's shape on h0's
    device, either h0 itself or apart from it."""
    if h_out is None:
        return
    if h_out.dtype != torch.float32 or h_out.shape != h0.shape \
            or h_out.device != h0.device or not h_out.is_contiguous():
        raise ValueError(f"h_out must be a contiguous float32 "
                         f"{tuple(h0.shape)} tensor on {h0.device}; got "
                         f"{h_out.dtype} {tuple(h_out.shape)} on "
                         f"{h_out.device}")
    lo, hi = h0.data_ptr(), h0.data_ptr() + 4 * h0.numel()
    o_lo, o_hi = h_out.data_ptr(), h_out.data_ptr() + 4 * h_out.numel()
    if o_lo != lo and o_lo < hi and lo < o_hi:
        raise ValueError("h_out overlaps h0 without being h0")


def _check(dt: torch.Tensor, x: torch.Tensor, b: torch.Tensor,
           c: torch.Tensor, a_neg: torch.Tensor, d_skip: torch.Tensor,
           h0: torch.Tensor, lens: Optional[torch.Tensor],
           h_out: Optional[torch.Tensor]) -> None:
    if not dt.is_cuda:
        raise ValueError("mamba_selective_scan_cuda takes CUDA tensors")
    if dt.dim() != 3 or x.shape != dt.shape:
        raise ValueError(f"want dt, x (B,T,I); got {tuple(dt.shape)}, "
                         f"{tuple(x.shape)}")
    bsz, t, inner = dt.shape
    n = b.shape[-1] if b.dim() == 3 else -1
    if b.shape != (bsz, t, n) or c.shape != (bsz, t, n):
        raise ValueError(f"want b, c (B,T,N) beside dt {tuple(dt.shape)}; "
                         f"got {tuple(b.shape)}, {tuple(c.shape)}")
    if n not in STATE_DIMS:
        raise ValueError(f"state dim N = {n} not in {STATE_DIMS}")
    if a_neg.shape != (inner, n) or d_skip.shape != (inner,) \
            or h0.shape != (bsz, inner, n):
        raise ValueError(f"want a_neg (I,N), d_skip (I,), h0 (B,I,N) for "
                         f"B {bsz}, I {inner}, N {n}; got "
                         f"{tuple(a_neg.shape)}, {tuple(d_skip.shape)}, "
                         f"{tuple(h0.shape)}")
    if dt.dtype not in IN_DTYPES or any(v.dtype != dt.dtype
                                        for v in (x, b, c)):
        raise ValueError(f"dt, x, b, c must share one dtype out of "
                         f"{IN_DTYPES}; got {dt.dtype}, {x.dtype}, "
                         f"{b.dtype}, {c.dtype}")
    for name, v in (("a_neg", a_neg), ("d_skip", d_skip), ("h0", h0)):
        if v.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {v.dtype}")
    named = [("dt", dt), ("x", x), ("b", b), ("c", c), ("a_neg", a_neg),
             ("d_skip", d_skip), ("h0", h0)]
    if lens is not None:
        if lens.dtype != torch.int32 or lens.shape != (bsz,):
            raise ValueError("lens must be (B,) int32")
        named.append(("lens", lens))
    for name, v in named:
        if v.device != dt.device:
            raise ValueError(f"{name} is on {v.device}, dt on {dt.device}")
        if not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    check_h_out(h0, h_out)
    for name, v in (("a_neg", a_neg), ("h0", h0), ("h_out", h_out)):
        if v is not None and v.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary "
                             "(the state moves as 16-byte vectors)")


def mamba_selective_scan_cuda(dt: torch.Tensor, x: torch.Tensor,
                              b: torch.Tensor, c: torch.Tensor,
                              a_neg: torch.Tensor, d_skip: torch.Tensor,
                              h0: torch.Tensor,
                              lens: Optional[torch.Tensor] = None,
                              h_out: Optional[torch.Tensor] = None):
    """dt, x (B,T,I); b, c (B,T,N), all fp32 or all bf16; a_neg (I,N),
    d_skip (I,), h0 (B,I,N) fp32; lens (B,) int32 or None (every token
    real) -> (y (B,T,I), h_final (B,I,N)), both fp32.  y is freshly
    allocated; h_final is ``h_out`` when given (it may be h0: the state
    is then updated in place), else fresh.  One launch on the current
    stream, no sync."""
    _check(dt, x, b, c, a_neg, d_skip, h0, lens, h_out)
    bsz, t, inner = dt.shape
    n = b.shape[-1]
    y = torch.empty((bsz, t, inner), dtype=torch.float32, device=dt.device)
    h_final = torch.empty_like(h0) if h_out is None else h_out
    stream = torch.cuda.current_stream(dt.device).cuda_stream
    rc = _lib().apex_mamba_scan(
        dt.data_ptr(), x.data_ptr(), b.data_ptr(), c.data_ptr(),
        a_neg.data_ptr(), d_skip.data_ptr(), h0.data_ptr(),
        lens.data_ptr() if lens is not None else None,
        y.data_ptr(), h_final.data_ptr(), bsz, t, inner, n,
        int(dt.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"mamba_scan kernel launch failed: cudaError {rc}")
    mamba_selective_scan_cuda.launches += 1
    return y, h_final


mamba_selective_scan_cuda.launches = 0
