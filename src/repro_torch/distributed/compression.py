"""Gradient compression, host-KV quantization and the cold-page codec.

  * ``quantize_int8`` / ``dequantize_int8`` /
    ``compress_decompress_with_feedback`` -- per-tensor symmetric int8
    of the gradients with error feedback (the trainer's
    ``compress_grads``): on a multi-pod mesh the int8 all-reduce moves a
    quarter of the fp32 bytes, and the residual carried to the next step
    keeps the optimizer unbiased over time.  Tensors on any device.

  * ``quantize_kv_rows`` / ``dequantize_kv_rows`` -- symmetric int8 with
    one fp32 scale per token row, which the paged host pool uses to store
    K/V at one byte per element.  Per-row scaling makes requantizing a
    dequantized row exact: its largest element maps back to +-127, so
    the recomputed scale equals the original and the int8 codes
    round-trip bit for bit through gather -> write_prompt chains.
  * ``compress_page_bytes`` / ``decompress_page_bytes`` -- a lossless
    byte codec for cold pages: zstd when the ``zstandard`` package
    imports, zlib otherwise (``PAGE_CODEC`` names the one in use).  Both
    decompress bit-exactly, so a compressed page never changes a token.

Port of ``repro/distributed/compression.py``.
"""
from __future__ import annotations

import zlib
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.tree import tree_flatten

try:                                    # optional: not every host has it
    import zstandard
except ModuleNotFoundError:             # pragma: no cover - env dependent
    zstandard = None


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8.  Returns (q int8, scale 0-d fp32), the
    scale floored at 1e-12 / 127 so an all-zero tensor stays zero."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_decompress_with_feedback(grads: Any,
                                      error_feedback: Optional[Any]
                                      ) -> Tuple[Any, Any]:
    """Int8 round trip of every gradient leaf with error feedback:
    new_grad = dequant(quant(grad + residual)), residual' = grad +
    residual - new_grad, both fp32 and of the grads' structure (zero
    residuals when ``error_feedback`` is None)."""
    gl, spec = tree_flatten(grads)
    efl = [None] * len(gl) if error_feedback is None \
        else tree_flatten(error_feedback)[0]
    if len(efl) != len(gl):
        raise ValueError(f"{len(efl)} residuals for {len(gl)} gradients")
    new_g, new_ef = [], []
    for g, ef in zip(gl, efl):
        corrected = g.float() if ef is None else g.float() + ef
        deq = dequantize_int8(*quantize_int8(corrected))
        new_g.append(deq)
        new_ef.append(corrected - deq)
    return spec.unflatten(new_g), spec.unflatten(new_ef)


def quantize_kv_rows(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric int8 over the trailing axes, one scale per leading row.

    ``x``: (T, kv_heads, head_dim) float.  Returns ``(q, scales)``: ``q``
    int8 of the same shape, ``scales`` (T,) float32 (floored at 1e-12 /
    127 so an all-zero row stays exactly zero)."""
    xf = np.asarray(x, np.float32)
    amax = np.abs(xf).max(axis=(-2, -1)) if xf.size else \
        np.zeros(xf.shape[0], np.float32)
    scales = (np.maximum(amax, 1e-12) / 127.0).astype(np.float32)
    q = np.clip(np.rint(xf / scales[:, None, None]), -127, 127)
    return q.astype(np.int8), scales


def dequantize_kv_rows(q: np.ndarray, scales: np.ndarray) -> np.ndarray:
    """Inverse of ``quantize_kv_rows``: (T, kv, d) int8 x (T,) -> fp32."""
    return q.astype(np.float32) * np.asarray(scales,
                                             np.float32)[:, None, None]


PAGE_CODEC = "zstd" if zstandard is not None else "zlib"


def compress_page_bytes(raw: bytes) -> bytes:
    """Losslessly compress one page blob (zstd level 3, else zlib 6)."""
    if zstandard is not None:
        return zstandard.ZstdCompressor(level=3).compress(raw)
    return zlib.compress(raw, 6)


def decompress_page_bytes(blob: bytes) -> bytes:
    if zstandard is not None:
        return zstandard.ZstdDecompressor().decompress(blob)
    return zlib.decompress(blob)
