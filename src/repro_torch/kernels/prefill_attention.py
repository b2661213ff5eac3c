"""Causal prefill attention on the card: wrapper of ``csrc/prefill_attention.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/prefill_attention.py``
(``prefill_attention`` / ``_prefill_kernel``).  FlashAttention-2 style:
a CTA takes a 16-query block of up to four query heads of one kv head
(a warp per head; three at group 6) and walks 32-key tiles in absolute order up to the
block's causal limit, K/V streaming through a cp.async ring.  bf16 runs
both products on tensor cores (mma.sync, fp32 accumulate, scores and
probabilities in registers); an fp32 query uses plain FMA.  Tile
boundaries do not depend on ``q_offset`` or T, so a token's output is
bitwise the same however its prompt is split into chunks.

Training: ``PrefillAttentionFn`` is the autograd Function of the
stateless forward.  Its forward is this kernel, which then also writes
each row's log-sum-exp; its backward is ``csrc/prefill_attention_bwd.cu``
(FlashAttention-2's split: a dK/dV kernel over key blocks, a dQ kernel
over query blocks, no atomics; on wgmma with TMA-fed tiles at bf16 head
dims 64 and 128, on mma.sync at the other bf16 head dims, plain FMA at
fp32 -- ``prefill_attention_bwd_route`` names the route) on the card and
``ref.prefill_attention_bwd_ref`` on the CPU.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref
from repro_torch.kernels.launches import counted

HEAD_DIMS = (32, 64, 80, 128, 160, 256)
GROUPS = (1, 2, 4, 6, 8, 16)         # query heads per kv head
# (q, kv) dtypes: one type throughout, or an fp32 model over the bf16 cache
DTYPE_PAIRS = ((torch.float32, torch.float32),
               (torch.bfloat16, torch.bfloat16),
               (torch.float32, torch.bfloat16))

_P = ctypes.c_void_p
_I = ctypes.c_int
_fn = None
_bwd_fn = None
_zeros: Dict[torch.device, torch.Tensor] = {}  # read-only (B,) default rows


def _launcher():
    global _fn
    if _fn is None:
        fn = build.load("prefill_attention").apex_prefill_attention
        fn.argtypes = [_P, _P, _P, _P, _P, _P, _P,
                       _I, _I, _I, _I, _I, _I, _I, _I, _I, _P]
        fn.restype = _I
        _fn = fn
    return _fn


def _bwd_launcher():
    global _bwd_fn
    if _bwd_fn is None:
        fn = build.load("prefill_attention_bwd").apex_prefill_attention_bwd
        fn.argtypes = [_P] * 11 + [_I] * 8 + [_P]
        fn.restype = _I
        _bwd_fn = fn
    return _bwd_fn


def _row_vector(x: Optional[torch.Tensor], b: int, device: torch.device,
                name: str) -> torch.Tensor:
    if x is None:
        zeros = _zeros.get(device)
        if zeros is None or zeros.numel() < b:
            zeros = _zeros[device] = torch.zeros((max(b, 64),),
                                                 dtype=torch.int32,
                                                 device=device)
        return zeros[:b]
    if x.dtype != torch.int32 or x.shape != (b,) or x.device != device \
            or not x.is_contiguous():
        raise ValueError(f"{name} must be a contiguous (B,) int32 tensor "
                         f"on {device}")
    return x


def check_geometry(h: int, kv: int, d: int) -> None:
    """Raise ``ValueError`` unless the kernel is built for H query heads
    over KV kv heads of head_dim D."""
    if kv < 1 or h % kv or h // kv not in GROUPS:
        raise ValueError(f"H/KV = {h}/{kv} not in {GROUPS}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {HEAD_DIMS}")


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if not q.is_cuda:
        raise ValueError("prefill_attention_cuda takes CUDA tensors")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q (B,T,H,D) and k, v (B,S,KV,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, _, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} "
                         "disagree on batch or head_dim")
    check_geometry(h, k.shape[2], d)
    if (q.dtype, k.dtype) not in DTYPE_PAIRS or v.dtype != k.dtype:
        raise ValueError(f"dtypes q {q.dtype}, k {k.dtype}, v {v.dtype}: "
                         f"want (q, k=v) in {DTYPE_PAIRS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


@counted
def prefill_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           prefix_len: Optional[torch.Tensor] = None,
                           q_offset: Optional[torch.Tensor] = None, *,
                           causal: bool = True, return_lse: bool = False):
    """q (B,T,H,D), k/v (B,S,KV,D) -> (B,T,H,D) in q's dtype; with
    ``return_lse`` also each row's natural-log log-sum-exp of its scaled
    scores, (B,H,T) fp32.  Launches on the current stream, no sync."""
    _check(q, k, v)
    b, t, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    prefix_len = _row_vector(prefix_len, b, q.device, "prefix_len")
    q_offset = _row_vector(q_offset, b, q.device, "q_offset")
    out = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device) \
        if return_lse else None
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _launcher()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), prefix_len.data_ptr(),
        q_offset.data_ptr(), out.data_ptr(),
        lse.data_ptr() if lse is not None else None, b, t, s, h, kv, d,
        int(q.dtype == torch.bfloat16),
        int(k.dtype == torch.bfloat16), int(causal), stream)
    if rc != 0:
        raise RuntimeError(f"prefill_attention kernel launch failed: "
                           f"cudaError {rc}")
    prefill_attention_cuda.add_launch()
    return (out, lse) if return_lse else out


@counted
def prefill_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, out: torch.Tensor,
                               lse: torch.Tensor, dout: torch.Tensor,
                               prefix_len: Optional[torch.Tensor] = None, *,
                               causal: bool = True):
    """Gradients of ``prefill_attention_cuda`` (queries at positions
    0..T-1, no q_offset) from its output ``out``, its log-sum-exp ``lse``
    (B,H,T) fp32 and dO (B,T,H,D): (dq, dk, dv) in the inputs' dtype,
    dk and dv summed over each kv head's query heads.  q, k and v share
    one dtype, fp32 or bf16.  One call launches the delta, dK/dV and dQ
    kernels on the current stream, no sync."""
    _check(q, k, v)
    b, t, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    if k.dtype != q.dtype:
        raise ValueError(f"the backward takes one dtype for q, k and v; got "
                         f"q {q.dtype}, k {k.dtype}")
    for name, x in (("out", out), ("dout", dout)):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device \
                or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {q.dtype} "
                             f"{tuple(q.shape)} tensor on {q.device}")
    if lse.shape != (b, h, t) or lse.dtype != torch.float32 \
            or lse.device != q.device or not lse.is_contiguous():
        raise ValueError(f"lse must be a contiguous float32 {(b, h, t)} "
                         f"tensor on {q.device}")
    prefix_len = _row_vector(prefix_len, b, q.device, "prefix_len")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _bwd_launcher()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), prefix_len.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, t, s, h, kv, d, int(q.dtype == torch.bfloat16), int(causal),
        stream)
    if rc != 0:
        raise RuntimeError(f"prefill_attention_bwd kernel launch failed: "
                           f"cudaError {rc}")
    prefill_attention_bwd_cuda.add_launch()
    return dq, dk, dv


_BWD_ROUTES = {0: "fma", 1: "mma.sync", 2: "wgmma"}


def prefill_attention_bwd_route(d: int, dtype: torch.dtype) -> str:
    """The kernels ``prefill_attention_bwd_cuda`` launches at head_dim
    ``d`` and ``dtype``, as the library's dispatch says: "wgmma" (bf16 at
    D 64 and 128), "mma.sync" (the other bf16 head_dims) or "fma" (fp32)."""
    fn = build.load("prefill_attention_bwd").apex_prefill_attention_bwd_route
    fn.argtypes = [_I, _I]
    fn.restype = _I
    route = fn(d, int(dtype == torch.bfloat16))
    if route < 0:
        raise ValueError(f"no backward kernel takes head_dim {d}")
    return _BWD_ROUTES[route]


def meta_prefill(q: torch.Tensor, k: torch.Tensor, causal: bool,
                 offset: bool, backward: bool = False) -> None:
    """Note a call that a meta rule stands for (``ops.record_meta_calls``)."""
    from repro_torch.kernels.ops import local_shape, meta_call
    meta_call("prefill_attention_bwd" if backward else "prefill_attention",
              q=local_shape(q), k=local_shape(k), dtype=q.dtype,
              causal=causal, offset=offset)


class PrefillAttentionFn(torch.autograd.Function):
    """Differentiable prefill attention over a span of its own (queries at
    positions 0..T-1): the kernel and its backward kernel on the card,
    the plain versions on the CPU (by the tensors' device, as
    ``kernels.ops``).  Saves q, k, v, the output and the log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v, prefix_len, causal):
        if q.device.type == "meta":      # shapes only (``kernels.ops``)
            meta_prefill(q, k, causal, False)
            ctx.save_for_backward(q, k, v)
            ctx.causal = causal
            return torch.empty_like(q)
        if q.device.type == "cpu":
            out, lse = ref.prefill_attention_ref(q, k, v, prefix_len,
                                                 causal=causal,
                                                 return_lse=True)
        else:
            out, lse = prefill_attention_cuda(q, k, v, prefix_len,
                                              causal=causal, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse, prefix_len)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        if dout.device.type == "meta":
            q, k, v = ctx.saved_tensors
            meta_prefill(q, k, ctx.causal, False, backward=True)
            return (torch.empty_like(q), torch.empty_like(k),
                    torch.empty_like(v), None, None)
        q, k, v, out, lse, prefix_len = ctx.saved_tensors
        dout = dout.contiguous()
        if q.device.type == "cpu":
            dq, dk, dv = ref.prefill_attention_bwd_ref(
                q, k, v, out, lse, dout, prefix_len, ctx.causal)
        else:
            dq, dk, dv = prefill_attention_bwd_cuda(
                q, k, v, out, lse, dout, prefix_len, causal=ctx.causal)
        return dq, dk, dv, None, None
