"""Host-tier paged attention in numpy (CPU code, not a device kernel).

Layout: pages (2, P, page_size, KV, D) -- index 0 keys, 1 values --
with page tables (B, max_pages) and per-row lengths, matching
``repro_torch.models.kv_cache.PagedKVPool``.  The host executor shards
a job's rows across worker threads; numpy's BLAS releases the GIL.

An optional ``scales`` operand, (2, P, page_size) fp32, selects the int8
pool's fused-dequant path: ``pages`` holds symmetric int8 and each row's
own page chain is dequantized inside its gather (``k = q * scale`` beside
the ``astype``), so a full-precision copy of the pool is never made.

Port of ``host_paged_attention_numpy`` of
``repro/kernels/host_paged_attention.py``; its jax-cpu path is not
ported (the executor runs the numpy one).
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np


def host_paged_attention_numpy(q: np.ndarray, pages: np.ndarray,
                               page_table: np.ndarray, lengths: np.ndarray,
                               *, page_size: int,
                               scales: Optional[np.ndarray] = None,
                               out: Optional[np.ndarray] = None) -> np.ndarray:
    """q (B, H, D) float32 -> (B, H, D) float32 attention of each row
    over the first ``lengths[i]`` positions of its page chain.  ``out``,
    when given, is written in place (disjoint row shards of one job);
    ``scales`` dequantizes int8 pages row by row."""
    b, h, d = q.shape
    kv = pages.shape[3]
    g = h // kv
    scale = 1.0 / math.sqrt(d)
    if out is None:
        out = np.empty((b, h, d), np.float32)
    for i in range(b):
        n = int(lengths[i])
        npages = -(-n // page_size) if n else 0
        chain = page_table[i, :npages]
        k = pages[0, chain].reshape(-1, kv, d)[:n].astype(np.float32)
        v = pages[1, chain].reshape(-1, kv, d)[:n].astype(np.float32)
        if scales is not None:
            k *= scales[0, chain].reshape(-1)[:n, None, None]
            v *= scales[1, chain].reshape(-1)[:n, None, None]
        qi = q[i].reshape(kv, g, d).astype(np.float32)
        scores = np.einsum("kgd,skd->kgs", qi, k) * scale
        m = scores.max(-1, keepdims=True)
        p = np.exp(scores - m)
        p /= np.maximum(p.sum(-1, keepdims=True), 1e-30)
        out[i] = np.einsum("kgs,skd->kgd", p, v).reshape(h, d)
    return out
