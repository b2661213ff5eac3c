"""Decode-state containers and the paged host KV pool.

  * **Contiguous slot cache** (``AttnKV``) -- (G, B, S, KV, D) tensors on
    the device, one slot per active request; decode and prefill write
    into them in place.
  * **Paged pool** (``PagedKVPool``) -- vLLM-style page tables over a
    host-memory numpy pool, read by the host attention backend for
    offloaded requests (the paper's CPU tier).  fp32 pages only.

``StackState`` bundles the per-pattern-entry states (``AttnKV`` for
attention entries, ``models.ssm.MambaState`` for Mamba entries); every
leaf carries a leading G (pattern groups) axis.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, List, NamedTuple, Tuple

import numpy as np
import torch


class AttnKV(NamedTuple):
    """Contiguous KV slots for one attention entry, stacked over groups.

    k, v: (G, B, S, KV, D); a row grows by writing at index ``lengths``.
    """

    k: torch.Tensor
    v: torch.Tensor


@dataclasses.dataclass
class StackState:
    """Decode state of the whole block stack.

    ``per_entry`` is a tuple over pattern entries: ``AttnKV`` (G, Bg, ...)
    for attention entries over the device rows only, ``MambaState``
    (G, Bg + Bc, ...) for Mamba entries over device and host rows;
    ``lengths`` is (Bg,) int32 on the device -- the number of tokens
    already cached per device row.
    """

    per_entry: Tuple[Any, ...]
    lengths: torch.Tensor


class PagedKVPool:
    """Paged KV storage in host memory, one pool shared by all layers.

    Layout: ``pages[2, num_pages, page_size, kv_heads, head_dim]``
    (index 0 = K, 1 = V).  Each (request, layer) owns a chain of pages
    recorded in ``page_tables``; allocation is a LIFO free list.

    Page-chain mutation (``allocate``/``extend``/``free``) is guarded by
    a lock: the engine reserves chains on its own thread while the host
    executor's in-flight job may extend a chain.  ``can_admit`` is an
    advisory lock-free read -- callers tolerate ``allocate`` raising
    ``MemoryError``.
    """

    def __init__(self, num_pages: int, page_size: int, num_layers: int,
                 kv_heads: int, head_dim: int, dtype=np.float32) -> None:
        self.page_size = page_size
        self.num_layers = num_layers
        self.pages = np.zeros((2, num_pages, page_size, kv_heads, head_dim),
                              dtype=dtype)
        self.free_pages: List[int] = list(range(num_pages - 1, -1, -1))
        # (request_id, layer) -> list of page indices
        self.page_tables: Dict[Tuple[int, int], List[int]] = {}
        # request_id -> token count (same across layers)
        self.lengths: Dict[int, int] = {}
        self._alloc_lock = threading.Lock()

    @property
    def num_free(self) -> int:
        return len(self.free_pages)

    def pages_short(self, total_tokens: int, chain_len: int) -> int:
        """Pages a chain of ``chain_len`` is short of holding
        ``total_tokens`` -- the capacity predicate ``extend`` and the
        bulk write path share."""
        return max(0, -(-total_tokens // self.page_size) - chain_len)

    def can_admit(self, tokens: int) -> bool:
        per_layer = -(-tokens // self.page_size)
        return self.num_free >= per_layer * self.num_layers

    def allocate(self, request_id: int, tokens: int) -> None:
        """Reserve page chains for a new request with ``tokens`` capacity."""
        per_layer = -(-tokens // self.page_size)
        with self._alloc_lock:
            if self.num_free < per_layer * self.num_layers:
                raise MemoryError("paged pool exhausted")
            for layer in range(self.num_layers):
                self.page_tables[(request_id, layer)] = [
                    self.free_pages.pop() for _ in range(per_layer)]
            self.lengths[request_id] = 0

    def extend(self, request_id: int, extra_tokens: int) -> None:
        """Grow every layer's chain to hold lengths + extra_tokens."""
        cur = self.lengths[request_id]
        with self._alloc_lock:
            chain_len = len(self.page_tables[(request_id, 0)])
            need = self.pages_short(cur + extra_tokens, chain_len)
            if need * self.num_layers > self.num_free:
                raise MemoryError("paged pool exhausted on extend")
            for layer in range(self.num_layers):
                self.page_tables[(request_id, layer)].extend(
                    self.free_pages.pop() for _ in range(need))

    def write_prompt(self, request_id: int, layer: int, k: np.ndarray,
                     v: np.ndarray, advance: bool) -> None:
        """Bulk-write a prompt's K/V (T, kv_heads, head_dim) for one
        layer: one strided write per page span."""
        t = k.shape[0]
        start = self.lengths[request_id]
        chain = self.page_tables[(request_id, layer)]
        if self.pages_short(start + t, len(chain)):
            self.extend(request_id, t)
        off = 0
        while off < t:
            pos = start + off
            page = chain[pos // self.page_size]
            slot = pos % self.page_size
            span = min(self.page_size - slot, t - off)
            self.pages[0, page, slot:slot + span] = k[off:off + span]
            self.pages[1, page, slot:slot + span] = v[off:off + span]
            off += span
        if advance:
            self.lengths[request_id] = start + t

    def append_rows(self, request_ids, layer: int, positions: np.ndarray,
                    k: np.ndarray, v: np.ndarray) -> None:
        """One-token-per-request append at explicit positions (the host
        cohort's per-layer write) as a single fancy-index store.  k, v:
        (B, kv_heads, head_dim).  ``lengths`` is not advanced."""
        ps = self.page_size
        positions = np.asarray(positions, np.int64)
        pages = np.empty(len(request_ids), np.int64)
        for i, rid in enumerate(request_ids):
            page_idx = int(positions[i]) // ps
            if page_idx >= len(self.page_tables[(rid, layer)]):
                self.extend(rid, int(positions[i]) + 1 - self.lengths[rid])
            pages[i] = self.page_tables[(rid, layer)][page_idx]
        self.pages[0, pages, positions % ps] = k
        self.pages[1, pages, positions % ps] = v

    def gather(self, request_id: int, layer: int) -> Tuple[np.ndarray,
                                                          np.ndarray]:
        """(K, V) of shape (len, kv_heads, head_dim) for one layer."""
        n = self.lengths[request_id]
        chain = self.page_tables[(request_id, layer)]
        idx = np.asarray(chain[:-(-n // self.page_size)], np.int64)
        kv_heads, head_dim = self.pages.shape[-2:]
        k = self.pages[0, idx].reshape(-1, kv_heads, head_dim)[:n]
        v = self.pages[1, idx].reshape(-1, kv_heads, head_dim)[:n]
        return k, v

    def free(self, request_id: int) -> None:
        with self._alloc_lock:
            for layer in range(self.num_layers):
                self.free_pages.extend(
                    self.page_tables.pop((request_id, layer), []))
            self.lengths.pop(request_id, None)
