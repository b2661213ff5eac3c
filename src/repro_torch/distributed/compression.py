"""Host-KV quantization and the cold-page codec (numpy, host side).

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

Port of the host half of ``repro/distributed/compression.py``; the
gradient half (per-tensor int8 with error feedback) belongs to training.
"""
from __future__ import annotations

import zlib
from typing import Tuple

import numpy as np

try:                                    # optional: not every host has it
    import zstandard
except ModuleNotFoundError:             # pragma: no cover - env dependent
    zstandard = None


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
