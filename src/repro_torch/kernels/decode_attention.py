"""GQA decode attention on the card: wrapper of ``csrc/decode_attention.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/decode_attention.py``
(``decode_attention`` / ``_decode_kernel``).  The kernel is split-KV
flash decoding: one CTA per (split, kv_head, batch row) writes an fp32
partial (m, l, acc) into scratch this wrapper allocates, and a combine
kernel folds the splits.  It is bound by the bytes of the K/V positions
it reads; it reads only positions below ``lengths[b]``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

SPLIT_SIZE = 32                      # cache positions per CTA
HEAD_DIMS = (32, 64, 128)
GROUPS = (1, 2, 4, 8)                # query heads per kv head
# (q, kv) dtypes: one type throughout, or an fp32 model over the bf16 cache
DTYPE_PAIRS = ((torch.float32, torch.float32),
               (torch.bfloat16, torch.bfloat16),
               (torch.float32, torch.bfloat16))

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = build.load("decode_attention")
    fn = lib.apex_decode_attention
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _P, _P, _P, _P,
                       _I, _I, _I, _I, _I, _I, _I, _I, _I, _P]
        fn.restype = _I
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           lengths: torch.Tensor) -> None:
    if not q.is_cuda:
        raise ValueError("decode_attention_cuda takes CUDA tensors")
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q (B,H,D) and k, v (B,S,KV,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} "
                         "disagree on batch or head_dim")
    kv = k.shape[2]
    if h % kv or h // kv not in GROUPS:
        raise ValueError(f"H/KV = {h}/{kv} not in {GROUPS}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {HEAD_DIMS}")
    if (q.dtype, k.dtype) not in DTYPE_PAIRS or v.dtype != k.dtype:
        raise ValueError(f"dtypes q {q.dtype}, k {k.dtype}, v {v.dtype}: "
                         f"want (q, k=v) in {DTYPE_PAIRS}")
    if lengths.dtype != torch.int32 or lengths.shape != (b,):
        raise ValueError("lengths must be (B,) int32")
    for name, t in (("q", q), ("k", k), ("v", v), ("lengths", lengths)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          lengths: torch.Tensor) -> torch.Tensor:
    """q (B,H,D), k/v (B,S,KV,D), lengths (B,) int32 in [1, S] ->
    (B,H,D) in q's dtype.  Launches on the current stream, no sync."""
    _check(q, k, v, lengths)
    b, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    g = h // kv
    splits = -(-s // SPLIT_SIZE)
    out = torch.empty_like(q)
    part_ml = torch.empty((b, kv, splits, g, 2), dtype=torch.float32,
                          device=q.device)
    part_acc = torch.empty((b, kv, splits, g, d), dtype=torch.float32,
                           device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _lib().apex_decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), part_ml.data_ptr(), part_acc.data_ptr(),
        b, h, kv, s, d, int(q.dtype == torch.bfloat16),
        int(k.dtype == torch.bfloat16), SPLIT_SIZE, splits,
        stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: "
                           f"cudaError {rc}")
    decode_attention_cuda.launches += 1
    return out


decode_attention_cuda.launches = 0
