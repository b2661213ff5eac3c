"""Causal prefill attention on the card: wrapper of ``csrc/prefill_attention.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/prefill_attention.py``
(``prefill_attention`` / ``_prefill_kernel``).  FlashAttention-2 style:
a CTA takes a 16-query block of up to four query heads of one kv head
(a warp per head) and walks 32-key tiles in absolute order up to the
block's causal limit, K/V streaming through a cp.async ring.  bf16 runs
both products on tensor cores (mma.sync, fp32 accumulate, scores and
probabilities in registers); an fp32 query uses plain FMA.  Tile
boundaries do not depend on ``q_offset`` or T, so a token's output is
bitwise the same however its prompt is split into chunks.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from repro_torch.kernels import build

HEAD_DIMS = (32, 64, 128)
GROUPS = (1, 2, 4, 8)                # query heads per kv head
# (q, kv) dtypes: one type throughout, or an fp32 model over the bf16 cache
DTYPE_PAIRS = ((torch.float32, torch.float32),
               (torch.bfloat16, torch.bfloat16),
               (torch.float32, torch.bfloat16))

_P = ctypes.c_void_p
_I = ctypes.c_int
_fn = None
_zeros: Dict[torch.device, torch.Tensor] = {}  # read-only (B,) default rows


def _launcher():
    global _fn
    if _fn is None:
        fn = build.load("prefill_attention").apex_prefill_attention
        fn.argtypes = [_P, _P, _P, _P, _P, _P,
                       _I, _I, _I, _I, _I, _I, _I, _I, _I, _P]
        fn.restype = _I
        _fn = fn
    return _fn


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
    if h % k.shape[2] or h // k.shape[2] not in GROUPS:
        raise ValueError(f"H/KV = {h}/{k.shape[2]} not in {GROUPS}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {HEAD_DIMS}")
    if (q.dtype, k.dtype) not in DTYPE_PAIRS or v.dtype != k.dtype:
        raise ValueError(f"dtypes q {q.dtype}, k {k.dtype}, v {v.dtype}: "
                         f"want (q, k=v) in {DTYPE_PAIRS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def prefill_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           prefix_len: Optional[torch.Tensor] = None,
                           q_offset: Optional[torch.Tensor] = None, *,
                           causal: bool = True) -> torch.Tensor:
    """q (B,T,H,D), k/v (B,S,KV,D) -> (B,T,H,D) in q's dtype.  Launches
    on the current stream, no sync."""
    _check(q, k, v)
    b, t, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    prefix_len = _row_vector(prefix_len, b, q.device, "prefix_len")
    q_offset = _row_vector(q_offset, b, q.device, "q_offset")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _launcher()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), prefix_len.data_ptr(),
        q_offset.data_ptr(), out.data_ptr(), b, t, s, h, kv, d,
        int(q.dtype == torch.bfloat16),
        int(k.dtype == torch.bfloat16), int(causal), stream)
    if rc != 0:
        raise RuntimeError(f"prefill_attention kernel launch failed: "
                           f"cudaError {rc}")
    prefill_attention_cuda.launches += 1
    return out


prefill_attention_cuda.launches = 0
