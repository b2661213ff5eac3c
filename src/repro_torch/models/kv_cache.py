"""Decode-state containers and the paged host KV pool.

  * **Contiguous slot cache** (``AttnKV``) -- (G, B, S, KV, D) tensors on
    the device, one slot per active request; decode and prefill write
    into them in place.
  * **Paged pool** (``PagedKVPool``) -- vLLM-style page tables over a
    host-memory numpy pool, read by the host attention backend for
    offloaded requests (the paper's CPU tier), with refcounted
    copy-on-write pages for the prefix cache.  fp32 pages only.

``StackState`` bundles the per-pattern-entry states (``AttnKV`` for
attention entries, ``models.ssm.MambaState`` for Mamba entries); every
leaf carries a leading G (pattern groups) axis.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

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
    (index 0 = K, 1 = V).  Each (owner, layer) holds a chain of pages
    recorded in ``page_tables``; owners are requests (ids >= 0) and
    prefix-cache entries (ids < 0).  Pages are refcounted
    (``page_refs``): ``fork`` aliases a chain's leading pages into a new
    owner without copying, and every write path copies a shared page
    first (copy-on-write), so a cached prefix is never mutated in place.
    Owners registered with ``mark_evictable`` form an LRU that
    allocation pressure reclaims, firing ``on_evict(owner)`` after the
    lock is released.

    Page-chain mutation is guarded by a lock: the engine reserves chains
    on its own thread while the host executor's in-flight job may extend
    one.  ``can_admit`` is an advisory lock-free read -- callers tolerate
    ``allocate`` raising ``MemoryError``.  fp32 pages only (the int8
    tier and cold-page compression are not ported).
    """

    def __init__(self, num_pages: int, page_size: int, num_layers: int,
                 kv_heads: int, head_dim: int, dtype=np.float32) -> None:
        self.page_size = page_size
        self.num_layers = num_layers
        self.pages = np.zeros((2, num_pages, page_size, kv_heads, head_dim),
                              dtype=dtype)
        self.free_pages: List[int] = list(range(num_pages - 1, -1, -1))
        # (owner, layer) -> list of page indices
        self.page_tables: Dict[Tuple[int, int], List[int]] = {}
        # owner -> token count (same across layers)
        self.lengths: Dict[int, int] = {}
        # physical page -> owners referencing it (absent == free)
        self.page_refs: Dict[int, int] = {}
        # LRU registry of owners the pool may reclaim under pressure
        self._evictable: Dict[int, int] = {}
        self._tick = 0
        self.evictions = 0
        self.on_evict: Optional[Callable[[int], None]] = None
        # chaos hook (serving.faults): called at the top of ``allocate``
        # and may raise MemoryError to simulate exhaustion; only admission
        # and preemption allocate, and both tolerate it
        self.fault_hook: Optional[Callable[[], None]] = None
        self._alloc_lock = threading.Lock()

    @property
    def num_free(self) -> int:
        return len(self.free_pages)

    def pages_short(self, total_tokens: int, chain_len: int) -> int:
        """Pages a chain of ``chain_len`` is short of holding
        ``total_tokens`` -- the capacity predicate ``extend`` and the
        bulk write path share."""
        return max(0, -(-total_tokens // self.page_size) - chain_len)

    def reclaimable_pages(self) -> int:
        """Advisory count of pages LRU eviction could free right now:
        exclusively owned (refcount 1) pages of evictable owners."""
        total = 0
        for owner in list(self._evictable):
            for layer in range(self.num_layers):
                total += sum(1 for p in self.page_tables.get((owner, layer),
                                                             [])
                             if self.page_refs.get(p, 1) <= 1)
        return total

    def can_admit(self, tokens: int) -> bool:
        per_layer = -(-tokens // self.page_size)
        return (self.num_free + self.reclaimable_pages()
                >= per_layer * self.num_layers)

    # --- internal helpers (call with ``_alloc_lock`` held) ----------------
    def _free_locked(self, owner: int) -> None:
        for layer in range(self.num_layers):
            for p in self.page_tables.pop((owner, layer), []):
                r = self.page_refs.get(p, 1) - 1
                if r <= 0:
                    self.page_refs.pop(p, None)
                    self.free_pages.append(p)
                else:
                    self.page_refs[p] = r
        self.lengths.pop(owner, None)
        self._evictable.pop(owner, None)

    def _reclaim_locked(self, need: int) -> List[int]:
        """LRU-evict whole evictable owners until ``need`` pages are
        free; returns the evicted owners (the caller fires ``on_evict``
        after releasing the lock)."""
        evicted: List[int] = []
        while len(self.free_pages) < need and self._evictable:
            owner = min(self._evictable, key=self._evictable.get)
            self._free_locked(owner)
            evicted.append(owner)
            self.evictions += 1
        return evicted

    def _notify(self, evicted: List[int]) -> None:
        if self.on_evict is not None:
            for owner in evicted:
                self.on_evict(owner)

    def _grab_locked(self, n: int) -> List[int]:
        pages = [self.free_pages.pop() for _ in range(n)]
        for p in pages:
            self.page_refs[p] = 1
        return pages

    def allocate(self, request_id: int, tokens: int) -> None:
        """Reserve page chains for a new owner with ``tokens`` capacity."""
        if self.fault_hook is not None:
            self.fault_hook()
        per_layer = -(-tokens // self.page_size)
        need = per_layer * self.num_layers
        evicted: List[int] = []
        try:
            with self._alloc_lock:
                evicted = self._reclaim_locked(need)
                if self.num_free < need:
                    raise MemoryError("paged pool exhausted")
                for layer in range(self.num_layers):
                    self.page_tables[(request_id, layer)] = \
                        self._grab_locked(per_layer)
                self.lengths[request_id] = 0
        finally:
            self._notify(evicted)

    def extend(self, request_id: int, extra_tokens: int) -> None:
        """Grow every layer's chain to hold lengths + extra_tokens."""
        cur = self.lengths[request_id]
        evicted: List[int] = []
        try:
            with self._alloc_lock:
                chain_len = len(self.page_tables[(request_id, 0)])
                need = self.pages_short(cur + extra_tokens, chain_len)
                evicted = self._reclaim_locked(need * self.num_layers)
                if need * self.num_layers > self.num_free:
                    raise MemoryError("paged pool exhausted on extend")
                for layer in range(self.num_layers):
                    self.page_tables[(request_id, layer)].extend(
                        self._grab_locked(need))
        finally:
            self._notify(evicted)

    # --- prefix-cache surface: sharing, LRU --------------------------------
    def fork(self, src_owner: int, dst_id: int, tokens: int) -> None:
        """Alias the pages holding ``src_owner``'s first ``tokens``
        positions into new owner ``dst_id`` (refcount++, zero copies).
        The new owner starts at length ``tokens``; a later write into a
        shared page goes through copy-on-write."""
        per_layer = -(-tokens // self.page_size)
        with self._alloc_lock:
            for layer in range(self.num_layers):
                shared = self.page_tables[(src_owner, layer)][:per_layer]
                self.page_tables[(dst_id, layer)] = list(shared)
                for p in shared:
                    self.page_refs[p] = self.page_refs.get(p, 1) + 1
            self.lengths[dst_id] = tokens

    def mark_evictable(self, owner: int) -> None:
        """Register ``owner`` with the LRU: the pool may reclaim its
        exclusively owned pages under allocation pressure."""
        with self._alloc_lock:
            self._tick += 1
            self._evictable[owner] = self._tick

    def touch(self, owner: int) -> None:
        """Refresh ``owner``'s LRU position (a cache hit)."""
        with self._alloc_lock:
            if owner in self._evictable:
                self._tick += 1
                self._evictable[owner] = self._tick

    def owner_pages(self, owner: int) -> int:
        """Pages referenced by ``owner`` across all layer chains."""
        return sum(len(self.page_tables.get((owner, layer), []))
                   for layer in range(self.num_layers))

    @property
    def page_bytes(self) -> int:
        """Bytes of one physical page (K + V)."""
        return int(self.pages[0, 0].nbytes) * 2

    def _writable_page(self, request_id: int, layer: int,
                       page_idx: int) -> int:
        """The physical page backing ``chain[page_idx]``, copied to a
        fresh exclusively owned page first when shared (copy-on-write).
        Every write path funnels through here."""
        chain = self.page_tables[(request_id, layer)]
        page = chain[page_idx]
        if self.page_refs.get(page, 1) <= 1:
            return page
        evicted: List[int] = []
        try:
            with self._alloc_lock:
                page = chain[page_idx]   # may have changed before the lock
                if self.page_refs.get(page, 1) <= 1:
                    return page
                evicted = self._reclaim_locked(1)
                if not self.free_pages:
                    raise MemoryError("paged pool exhausted on copy-on-write")
                if self.page_refs.get(page, 1) <= 1:
                    return page           # the reclaim released the sharer
                fresh = self._grab_locked(1)[0]
                self.pages[:, fresh] = self.pages[:, page]
                self.page_refs[page] -= 1
                chain[page_idx] = fresh
                return fresh
        finally:
            self._notify(evicted)

    # --- KV writes and reads -------------------------------------------------
    def write_prompt(self, request_id: int, layer: int, k: np.ndarray,
                     v: np.ndarray, advance: bool) -> None:
        """Bulk-write K/V (T, kv_heads, head_dim) for one layer at the
        owner's length: one strided write per page span."""
        t = k.shape[0]
        start = self.lengths[request_id]
        chain = self.page_tables[(request_id, layer)]
        if self.pages_short(start + t, len(chain)):
            self.extend(request_id, t)
        off = 0
        while off < t:
            pos = start + off
            page = self._writable_page(request_id, layer,
                                       pos // self.page_size)
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
            pages[i] = self._writable_page(rid, layer, page_idx)
        self.pages[0, pages, positions % ps] = k
        self.pages[1, pages, positions % ps] = v

    def gather(self, request_id: int, layer: int, n: Optional[int] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """(K, V) of shape (len, kv_heads, head_dim) for one layer --
        optionally only the first ``n`` positions (a truncated
        prefix-cache hit)."""
        total = self.lengths[request_id]
        n = total if n is None else min(n, total)
        chain = self.page_tables[(request_id, layer)]
        idx = np.asarray(chain[:-(-n // self.page_size)], np.int64)
        kv_heads, head_dim = self.pages.shape[-2:]
        k = self.pages[0, idx].reshape(-1, kv_heads, head_dim)[:n]
        v = self.pages[1, idx].reshape(-1, kv_heads, head_dim)[:n]
        return k, v

    def free(self, request_id: int) -> None:
        """Drop an owner: refcounts decrement, exclusively owned pages
        return to the free list (pages still shared survive)."""
        with self._alloc_lock:
            self._free_locked(request_id)
