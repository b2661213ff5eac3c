"""Decode-state containers and the paged host KV pool.

  * **Contiguous slot cache** (``AttnKV``) -- (G, B, S, KV, D) tensors on
    the device, one slot per active request; decode and prefill write
    into them in place.
  * **Paged pool** (``PagedKVPool``) -- vLLM-style page tables over a
    host-memory numpy pool, read by the host attention backend for
    offloaded requests (the paper's CPU tier), with refcounted
    copy-on-write pages for the prefix cache, fp32 or int8 pages, and
    lossless compression of cold pages.

``StackState`` bundles the per-pattern-entry states (``AttnKV`` for
attention entries, ``models.ssm.MambaState`` for Mamba entries); every
leaf carries a leading G (pattern groups) axis.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import (Any, Callable, Dict, Iterable, List, NamedTuple,
                    Optional, Tuple)

import numpy as np
import torch

from repro_torch.distributed.compression import (compress_page_bytes,
                                                 decompress_page_bytes,
                                                 dequantize_kv_rows,
                                                 quantize_kv_rows)


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


def write_rows(cache: torch.Tensor, cols: torch.Tensor,
               val: torch.Tensor) -> None:
    """``cache[b, cols[b, i]] = val[b, i]`` for every row b, in place, on a
    DTensor cache (B, S, ...): each rank writes the positions that fall
    in its own shard, from ``val`` and ``cols`` (B, T) brought to the
    cache's batch and channel sharding (the reference's scatter into a
    donated sharded cache, which XLA partitions the same way).  A plain
    cache is written with one index assignment by its caller."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from repro_torch.distributed.sharding import as_dtensor
    mesh, pl = cache.device_mesh, tuple(cache.placements)
    seq_sharded = any(isinstance(p, Shard) and p.dim == 1 for p in pl)
    val_pl = tuple(Replicate() if isinstance(p, Shard) and p.dim == 1 else p
                   for p in pl)
    col_pl = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                   for p in pl)
    val = as_dtensor(val, mesh).redistribute(mesh, val_pl).to_local()
    cols = as_dtensor(cols, mesh).redistribute(mesh, col_pl).to_local()
    local = cache.to_local()
    rows = torch.arange(local.shape[0], device=local.device)[:, None]
    if not seq_sharded:
        local[rows, cols.long()] = val
        return
    _, offset = compute_local_shape_and_global_offset(cache.shape, mesh, pl)
    lc = cols.long() - offset[1]
    inside = (lc >= 0) & (lc < local.shape[1])
    lc = lc.clamp(0, local.shape[1] - 1)
    keep = inside.reshape(inside.shape + (1,) * (val.dim() - 2))
    local[rows, lc] = torch.where(keep, val, local[rows, lc])


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
    ``allocate`` raising ``MemoryError``.

    **Precision.** With ``host_kv_dtype="int8"`` pages hold symmetric
    int8 with one fp32 scale per (K|V, page, slot), i.e. per token row,
    in ``scales`` (2, num_pages, page_size), indexed by physical page so
    that copy-on-write copies and ``fork`` aliases carry their scales by
    page identity.  Every write quantizes on entry; ``gather`` and the
    host attention dequantize on the fly, and the pool never holds a
    full-precision copy of itself.

    **Cold pages.** With ``cold_page_compress_after > 0``, the
    exclusively owned pages of an owner idle that many seconds are
    compressed losslessly (``distributed.compression``): the page's
    bytes (and scale rows) move into a blob behind a negative sentinel id
    spliced into the chains, and the physical page returns to the free
    list.  A write, a ``gather`` or ``ensure_hot`` rehydrates it.  Under
    allocation pressure the reclaim compresses evictable owners' pages
    before it evicts whole owners.  The cold sweep passes over the owners
    the caller names as live (the engine's host cohort, whose jobs read
    their chains outside the lock).
    """

    def __init__(self, num_pages: int, page_size: int, num_layers: int,
                 kv_heads: int, head_dim: int, dtype=np.float32,
                 host_kv_dtype: str = "fp32",
                 cold_page_compress_after: float = 0.0) -> None:
        if host_kv_dtype not in ("fp32", "int8"):
            raise ValueError(f"host_kv_dtype must be fp32|int8, "
                             f"got {host_kv_dtype!r}")
        self.page_size = page_size
        self.num_layers = num_layers
        self.host_kv_dtype = host_kv_dtype
        self.quantized = host_kv_dtype == "int8"
        # what ``gather`` hands back; the stored dtype is int8 when
        # quantized
        self.logical_dtype = np.dtype(dtype)
        self.pages = np.zeros((2, num_pages, page_size, kv_heads, head_dim),
                              dtype=np.int8 if self.quantized else dtype)
        self.scales: Optional[np.ndarray] = (
            np.ones((2, num_pages, page_size), np.float32)
            if self.quantized else None)
        # cold-page compression: sentinel id (< 0) -> compressed blob
        self.cold_page_compress_after = float(cold_page_compress_after)
        self._compressed: Dict[int, bytes] = {}
        self._next_blob_id = -1
        self._last_touch: Dict[int, float] = {}
        self.pages_compressed = 0
        self.pages_decompressed = 0
        self.compressed_ratio_ewma: Optional[float] = None
        self.free_pages: List[int] = list(range(num_pages - 1, -1, -1))
        # (owner, layer) -> list of page indices
        self.page_tables: Dict[Tuple[int, int], List[int]] = {}
        # owner -> token count (same across layers)
        self.lengths: Dict[int, int] = {}
        # physical page (or sentinel) -> owners referencing it
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
        exclusively owned (refcount 1) physical pages of evictable
        owners."""
        total = 0
        for owner in list(self._evictable):
            for layer in range(self.num_layers):
                total += sum(1 for p in self.page_tables.get((owner, layer),
                                                             [])
                             if p >= 0 and self.page_refs.get(p, 1) <= 1)
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
                    if p < 0:
                        self._compressed.pop(p, None)
                    else:
                        self.free_pages.append(p)
                else:
                    self.page_refs[p] = r
        self.lengths.pop(owner, None)
        self._evictable.pop(owner, None)
        self._last_touch.pop(owner, None)

    def _grab_locked(self, n: int) -> List[int]:
        pages = [self.free_pages.pop() for _ in range(n)]
        for p in pages:
            self.page_refs[p] = 1
        return pages

    def _splice_locked(self, old: int, new: int) -> None:
        for chain in self.page_tables.values():
            for i, p in enumerate(chain):
                if p == old:
                    chain[i] = new

    def _compress_page_locked(self, phys: int) -> int:
        """Move physical page ``phys`` into a compressed blob behind a
        fresh sentinel id, splice the sentinel into every chain holding
        the page, and free the page."""
        raw = self.pages[:, phys].tobytes()
        if self.scales is not None:
            raw += self.scales[:, phys].tobytes()
        blob = compress_page_bytes(raw)
        sid = self._next_blob_id
        self._next_blob_id -= 1
        self._compressed[sid] = blob
        self.page_refs[sid] = self.page_refs.pop(phys, 1)
        self._splice_locked(phys, sid)
        self.free_pages.append(phys)
        self.pages_compressed += 1
        ratio = len(blob) / max(len(raw), 1)
        self.compressed_ratio_ewma = (
            ratio if self.compressed_ratio_ewma is None
            else 0.8 * self.compressed_ratio_ewma + 0.2 * ratio)
        return sid

    def _blob_arrays_locked(self, sid: int
                            ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """Blob ``sid`` decoded: the page's (2, page_size, kv_heads,
        head_dim) K/V and, in an int8 pool, its (2, page_size) scales."""
        raw = decompress_page_bytes(self._compressed[sid])
        shape = self.pages[:, 0].shape
        kv_nbytes = self.pages[:, 0].nbytes
        kv = np.frombuffer(raw[:kv_nbytes], self.pages.dtype).reshape(shape)
        scales = None if self.scales is None else np.frombuffer(
            raw[kv_nbytes:], np.float32).reshape(2, self.page_size)
        return kv, scales

    def _fill_from_blob_locked(self, sid: int, phys: int) -> None:
        kv, scales = self._blob_arrays_locked(sid)
        self.pages[:, phys] = kv
        if scales is not None:
            self.scales[:, phys] = scales

    def _decompress_page_locked(self, sid: int, evicted: List[int],
                                keep: Optional[int] = None) -> int:
        """Rehydrate sentinel ``sid`` into a fresh physical page spliced
        back into every chain (its sharers keep sharing the hot page);
        the reclaim that makes room spares owner ``keep``."""
        evicted += self._reclaim_locked(1, keep)
        if not self.free_pages:
            raise MemoryError("paged pool exhausted rehydrating a "
                              "compressed page")
        fresh = self.free_pages.pop()
        self._fill_from_blob_locked(sid, fresh)
        del self._compressed[sid]
        self.page_refs[fresh] = self.page_refs.pop(sid, 1)
        self._splice_locked(sid, fresh)
        self.pages_decompressed += 1
        return fresh

    def _reclaim_locked(self, need: int,
                        keep: Optional[int] = None) -> List[int]:
        """Free pages until ``need`` exist: with cold-page compression on,
        first compress evictable owners' exclusively owned pages (the
        entry survives, colder), then LRU-evict whole owners.  Owner
        ``keep``, whose chains the caller is rehydrating or writing, is
        neither compressed nor evicted (the reference's reclaim may do
        either to it, and its reader then indexes a sentinel or a freed
        chain: ROADMAP queue 3).  Returns the evicted owners (the caller
        fires ``on_evict`` after releasing the lock)."""
        evicted: List[int] = []
        if self.cold_page_compress_after > 0 \
                and len(self.free_pages) < need:
            for owner in sorted(self._evictable, key=self._evictable.get):
                if owner == keep:
                    continue
                if len(self.free_pages) >= need:
                    break
                for layer in range(self.num_layers):
                    for p in list(self.page_tables.get((owner, layer), [])):
                        if p >= 0 and self.page_refs.get(p, 1) <= 1:
                            self._compress_page_locked(p)
                            if len(self.free_pages) >= need:
                                break
                    if len(self.free_pages) >= need:
                        break
        while len(self.free_pages) < need:
            others = [o for o in self._evictable if o != keep]
            if not others:
                break
            owner = min(others, key=self._evictable.get)
            self._free_locked(owner)
            evicted.append(owner)
            self.evictions += 1
        return evicted

    def _notify(self, evicted: List[int]) -> None:
        if self.on_evict is not None:
            for owner in evicted:
                self.on_evict(owner)

    def _touch_owner(self, owner: int) -> None:
        if self.cold_page_compress_after > 0:
            self._last_touch[owner] = time.monotonic()

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
                self._touch_owner(request_id)
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
        positions into new owner ``dst_id`` (refcount++, zero copies;
        compressed pages are shared as blobs).  The new owner starts at
        length ``tokens``; a later write into a shared page goes through
        copy-on-write."""
        per_layer = -(-tokens // self.page_size)
        with self._alloc_lock:
            for layer in range(self.num_layers):
                shared = self.page_tables[(src_owner, layer)][:per_layer]
                self.page_tables[(dst_id, layer)] = list(shared)
                for p in shared:
                    self.page_refs[p] = self.page_refs.get(p, 1) + 1
            self.lengths[dst_id] = tokens
            self._touch_owner(dst_id)

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

    # --- byte accounting and cold pages --------------------------------------
    @property
    def page_bytes(self) -> int:
        """Bytes of one physical page as stored: K + V at the stored
        element size, plus the page's scale rows when quantized -- what
        capacity predicates and byte gauges charge."""
        per = int(self.pages[0, 0].nbytes) * 2
        if self.scales is not None:
            per += int(self.scales[:, 0].nbytes)
        return per

    @property
    def kv_dtype_bytes(self) -> int:
        """Stored bytes per KV element (1 for int8, 4 for fp32)."""
        return int(self.pages.dtype.itemsize)

    @property
    def has_compressed(self) -> bool:
        """Advisory lock-free check for any cold compressed page."""
        return bool(self._compressed)

    def byte_stats(self) -> Dict[str, int]:
        """Stored bytes by state: hot (occupied physical pages),
        compressed (cold blobs), free (unoccupied physical pages)."""
        num_pages = self.pages.shape[1]
        pb = self.page_bytes
        free = len(self.free_pages)
        comp = sum(len(b) for b in list(self._compressed.values()))
        return {"hot": (num_pages - free) * pb, "compressed": comp,
                "free": free * pb}

    def ensure_hot(self, owner: int) -> None:
        """Rehydrate every compressed page of ``owner``'s chains, so that
        readers (host attention, gather) see physical page ids."""
        if not self._compressed:
            return
        evicted: List[int] = []
        try:
            with self._alloc_lock:
                for layer in range(self.num_layers):
                    for p in list(self.page_tables.get((owner, layer), [])):
                        if p < 0:
                            self._decompress_page_locked(p, evicted,
                                                         keep=owner)
        finally:
            self._notify(evicted)

    def maybe_compress_cold(self, now: Optional[float] = None,
                            skip: Iterable[int] = ()) -> int:
        """Compress the exclusively owned pages of owners idle past
        ``cold_page_compress_after`` seconds, except those in ``skip``;
        returns the pages compressed.  The engine calls it once per
        iteration and skips the live host cohort: its jobs read the chains
        outside the lock, one layer per iteration."""
        if self.cold_page_compress_after <= 0:
            return 0
        now = time.monotonic() if now is None else now
        skip = set(skip)
        count = 0
        with self._alloc_lock:
            for owner, ts in list(self._last_touch.items()):
                if now - ts < self.cold_page_compress_after or owner in skip:
                    continue
                for layer in range(self.num_layers):
                    for p in list(self.page_tables.get((owner, layer), [])):
                        if p >= 0 and self.page_refs.get(p, 1) <= 1:
                            self._compress_page_locked(p)
                            count += 1
        return count

    def _writable_page(self, request_id: int, layer: int,
                       page_idx: int) -> int:
        """The physical page backing ``chain[page_idx]``, rehydrated first
        when compressed and copied to a fresh exclusively owned page first
        when shared (copy-on-write).  Every write path funnels through
        here."""
        chain = self.page_tables[(request_id, layer)]
        page = chain[page_idx]
        if page >= 0 and self.page_refs.get(page, 1) <= 1:
            return page
        evicted: List[int] = []
        try:
            with self._alloc_lock:
                page = chain[page_idx]   # may have changed before the lock
                if page < 0:
                    if self.page_refs.get(page, 1) <= 1:
                        return self._decompress_page_locked(
                            page, evicted, keep=request_id)
                    # a shared compressed page: a private hot copy for
                    # this chain, the blob stays for the other sharers
                    evicted += self._reclaim_locked(1, request_id)
                    if not self.free_pages:
                        raise MemoryError(
                            "paged pool exhausted on copy-on-write")
                    fresh = self._grab_locked(1)[0]
                    self._fill_from_blob_locked(page, fresh)
                    self.page_refs[page] -= 1
                    chain[page_idx] = fresh
                    return fresh
                if self.page_refs.get(page, 1) <= 1:
                    return page
                evicted += self._reclaim_locked(1, request_id)
                if not self.free_pages:
                    raise MemoryError("paged pool exhausted on copy-on-write")
                if self.page_refs.get(page, 1) <= 1:
                    return page           # the reclaim released the sharer
                fresh = self._grab_locked(1)[0]
                self.pages[:, fresh] = self.pages[:, page]
                if self.scales is not None:
                    self.scales[:, fresh] = self.scales[:, page]
                self.page_refs[page] -= 1
                chain[page_idx] = fresh
                return fresh
        finally:
            self._notify(evicted)

    # --- KV writes and reads -------------------------------------------------
    def append(self, request_id: int, layer: int, k: np.ndarray,
               v: np.ndarray, advance: bool) -> None:
        """Append one token's K/V (kv_heads, head_dim) for (owner, layer);
        ``advance`` bumps the shared length (pass True once per token, on
        the last layer written)."""
        pos = self.lengths[request_id]
        if pos // self.page_size >= len(self.page_tables[(request_id,
                                                          layer)]):
            self.extend(request_id, 1)
        page = self._writable_page(request_id, layer, pos // self.page_size)
        slot = pos % self.page_size
        if self.quantized:
            qk, sk = quantize_kv_rows(np.asarray(k, np.float32)[None])
            qv, sv = quantize_kv_rows(np.asarray(v, np.float32)[None])
            self.pages[0, page, slot] = qk[0]
            self.pages[1, page, slot] = qv[0]
            self.scales[0, page, slot] = sk[0]
            self.scales[1, page, slot] = sv[0]
        else:
            self.pages[0, page, slot] = k
            self.pages[1, page, slot] = v
        self._touch_owner(request_id)
        if advance:
            self.lengths[request_id] = pos + 1

    def write_prompt(self, request_id: int, layer: int, k: np.ndarray,
                     v: np.ndarray, advance: bool) -> None:
        """Bulk-write K/V (T, kv_heads, head_dim) for one layer at the
        owner's length: one strided write per page span."""
        t = k.shape[0]
        start = self.lengths[request_id]
        chain = self.page_tables[(request_id, layer)]
        if self.pages_short(start + t, len(chain)):
            self.extend(request_id, t)
        sk = sv = None
        if self.quantized:
            k, sk = quantize_kv_rows(np.asarray(k, np.float32))
            v, sv = quantize_kv_rows(np.asarray(v, np.float32))
        off = 0
        while off < t:
            pos = start + off
            page = self._writable_page(request_id, layer,
                                       pos // self.page_size)
            slot = pos % self.page_size
            span = min(self.page_size - slot, t - off)
            self.pages[0, page, slot:slot + span] = k[off:off + span]
            self.pages[1, page, slot:slot + span] = v[off:off + span]
            if self.quantized:
                self.scales[0, page, slot:slot + span] = sk[off:off + span]
                self.scales[1, page, slot:slot + span] = sv[off:off + span]
            off += span
        self._touch_owner(request_id)
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
        if self.quantized:
            k, sk = quantize_kv_rows(np.asarray(k, np.float32))
            v, sv = quantize_kv_rows(np.asarray(v, np.float32))
            self.scales[0, pages, positions % ps] = sk
            self.scales[1, pages, positions % ps] = sv
        self.pages[0, pages, positions % ps] = k
        self.pages[1, pages, positions % ps] = v
        if self.cold_page_compress_after > 0:
            now = time.monotonic()
            for rid in request_ids:
                self._last_touch[rid] = now

    def gather(self, request_id: int, layer: int, n: Optional[int] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """(K, V) of shape (len, kv_heads, head_dim) for one layer in the
        logical dtype (dequantized from an int8 pool), optionally only the
        first ``n`` positions (a truncated prefix-cache hit).  Compressed
        pages rehydrate first; where the pool has no room for that short
        of reclaiming this owner, they are read from their blobs."""
        total = self.lengths[request_id]
        n = total if n is None else min(n, total)
        npages = -(-n // self.page_size)
        if any(p < 0 for p in self.page_tables[(request_id, layer)][:npages]):
            try:
                self.ensure_hot(request_id)
            except MemoryError:
                pass                  # the rest is read from the blobs
        self._touch_owner(request_id)
        kv_heads, head_dim = self.pages.shape[-2:]
        if n == 0:
            empty = np.zeros((0, kv_heads, head_dim), self.logical_dtype)
            return empty, empty.copy()
        with self._alloc_lock:
            chain = self.page_tables[(request_id, layer)][:npages]
            idx = np.maximum(np.asarray(chain, np.int64), 0)
            kv = self.pages[:, idx]                   # a copy
            scales = None if self.scales is None else self.scales[:, idx]
            for i, p in enumerate(chain):
                if p < 0:
                    kv[:, i], blob_scales = self._blob_arrays_locked(p)
                    if scales is not None:
                        scales[:, i] = blob_scales
        k = kv[0].reshape(-1, kv_heads, head_dim)[:n]
        v = kv[1].reshape(-1, kv_heads, head_dim)[:n]
        if scales is not None:
            k = dequantize_kv_rows(k, scales[0].reshape(-1)[:n])
            v = dequantize_kv_rows(v, scales[1].reshape(-1)[:n])
        return k, v

    def free(self, request_id: int) -> None:
        """Drop an owner: refcounts decrement, exclusively owned pages
        (and blobs) are released (pages still shared survive)."""
        with self._alloc_lock:
            self._free_locked(request_id)
