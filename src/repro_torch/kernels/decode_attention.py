"""GQA decode attention on the card: wrapper of ``csrc/decode_attention.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/decode_attention.py``
(``decode_attention`` / ``_decode_kernel``).  Split-KV flash decoding in
one launch: ``plan_splits`` picks the number of splits per (row, kv
head) from the shape and the SM count; on the device each row's split
size follows from its own length, so every split that runs reads only
positions below ``lengths[b]``.  Splits of a row write fp32 partials
into a workspace allocated once per device (and regrown only when a
larger shape needs it); the split that finishes last merges them.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Tuple

import torch

from repro_torch.kernels import build

TILE = 32                            # positions per staged K/V tile
# decode CTAs resident on one SM (bf16: 128 threads, ~52 KB of shared
# memory each); one wave is CTAS_PER_SM * sm_count CTAs
CTAS_PER_SM = 4
HEAD_DIMS = (32, 64, 128)
GROUPS = (1, 2, 4, 8)                # query heads per kv head
# (q, kv) dtypes: one type throughout, or an fp32 model over the bf16 cache
DTYPE_PAIRS = ((torch.float32, torch.float32),
               (torch.bfloat16, torch.bfloat16),
               (torch.float32, torch.bfloat16))

_P = ctypes.c_void_p
_I = ctypes.c_int
_fn = None
_sm_count: Dict[int, int] = {}
# device index -> (counters int32, all 0 between calls; fp32 partials)
_workspace: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}


def plan_splits(b: int, kv: int, s: int, sm_count: int) -> int:
    """Splits per (row, kv head): as many as one wave of resident CTAs
    holds over the B*KV pairs (rounded down: a second, partial wave would
    double the time of a long row), at most one split per 32-position
    tile of S, at least one split."""
    wave = CTAS_PER_SM * sm_count
    return max(1, min(-(-s // TILE), wave // (b * kv)))


def split_bounds(length: int, splits: int) -> List[Tuple[int, int]]:
    """The [start, end) positions each split of a row of ``length``
    valid positions reads, as the kernel derives them; splits past the
    row's length do not run."""
    size = -(-(-(-length // splits)) // TILE) * TILE
    return [(s0, min(s0 + size, length)) for s0 in range(0, length, size)]


def _launcher():
    global _fn
    if _fn is None:
        fn = build.load("decode_attention").apex_decode_attention
        fn.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P,
                       _I, _I, _I, _I, _I, _I, _I, _I, _P]
        fn.restype = _I
        _fn = fn
    return _fn


def _buffers(idx: int, device: torch.device, pairs: int,
             floats: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Device ``idx``'s workspace, regrown (counters zeroed) when too
    small for this call."""
    ws = _workspace.get(idx)
    if ws is None or ws[0].numel() < pairs or ws[1].numel() < floats:
        if ws is not None:
            pairs = max(pairs, ws[0].numel())
            floats = max(floats, ws[1].numel())
        ws = (torch.zeros(pairs, dtype=torch.int32, device=device),
              torch.empty(floats, dtype=torch.float32, device=device))
        _workspace[idx] = ws
    return ws


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
    (B,H,D) in q's dtype.  One launch on the current stream, no sync;
    calls on one device share its workspace, so they are ordered on
    one stream."""
    _check(q, k, v, lengths)
    b, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    fn = _launcher()
    dev = q.device
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    sms = _sm_count.get(idx)
    if sms is None:
        sms = _sm_count[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    splits = plan_splits(b, kv, s, sms)
    n_acc = b * kv * splits * (h // kv) * d
    counters, partials = _buffers(idx, dev, b * kv, n_acc + 2 * n_acc // d)
    out = torch.empty_like(q)
    acc_ptr = partials.data_ptr()
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), counters.data_ptr(), acc_ptr + 4 * n_acc,
            acc_ptr, b, h, kv, s, d, int(q.dtype == torch.bfloat16),
            int(k.dtype == torch.bfloat16), splits,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: "
                           f"cudaError {rc}")
    decode_attention_cuda.launches += 1
    return out


decode_attention_cuda.launches = 0
