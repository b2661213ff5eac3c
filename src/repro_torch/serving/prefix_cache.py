"""Cross-request prefix cache spanning both KV tiers.

Port of ``repro/serving/prefix_cache.py``.  Chat traffic shares long
system prompts and conversation histories; an admission that matches a
cached prefix prefills only its suffix.  This module is the cache's
index and policy; the K/V moves are ``tiermove``'s:

  * **Device tier** -- hot prefixes live in rows of a dedicated
    ``StackState`` (``EngineConfig.prefix_cache_slots`` rows, apart from
    the decode state, whose every row decode writes each step).
    Publication and seeding are one full-row ``copy_state_row`` each
    way, recurrent carry (hybrids) included.
  * **Host tier** -- overflow demotes to the ``PagedKVPool``: entries own
    refcounted page chains under negative owner ids (request ids are
    non-negative) registered with the pool's LRU, so allocation pressure
    reclaims them.  A host-tier admission hitting a host entry forks the
    chains (refcount++, no copy); copy-on-write guards the shared pages
    when the request writes past the prefix.

Match: the longest common prefix over whole entries, capped at
``prompt_len - 1`` (at least one suffix token prefills, so the first
output token's logits are computed fresh).  Attention-only stacks may
truncate an entry to the common prefix; hybrid stacks need the whole
entry, because a running carry exists only at the entry's end.

At retirement a request's prompt span is published: to a device row
(LRU-demoting a colder device entry to the pool when none is free), else
to the pool; a host retiree's chains are forked.  Only prompt positions:
prefill computed them at the fixed chunk geometry
(``RequestLifecycle.plan_chunks``), so they hold the bits a cold prefill
of any extending prompt would produce; decode-written K/V comes from
another kernel and would break that bar.  A hybrid's carry is the one
snapshotted when its prefill graduated (``Request.prefix_carry``).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core import placement
from repro_torch.core.overlap_engine import stack_row_kv_to_pool_layers
from repro_torch.models.config import BlockKind
from repro_torch.serving.tiermove import (copy_state_row, set_recurrent_row,
                                          snapshot_recurrent_row)

__all__ = ["PrefixCache", "PrefixEntry", "publish_retired"]


@dataclasses.dataclass
class PrefixEntry:
    """One cached prefix.  ``tokens`` is the cached prompt span; a device
    entry lives in ``row`` of the engine's prefix state, a host entry
    owns pool chains under owner id ``-entry_id`` (with its recurrent
    carry, if any, in ``carry``)."""

    entry_id: int
    tokens: Tuple[int, ...]
    tier: str                          # "device" | "host"
    row: Optional[int] = None          # prefix-state row (device tier)
    carry: Optional[List] = None       # recurrent snapshot (host tier)
    last_use: int = 0

    @property
    def owner(self) -> int:
        """Pool owner id of the host-tier chains."""
        return -self.entry_id


class PrefixCache:
    """The index: longest-prefix match, LRU order, device-row accounting,
    eviction and demotion.  The engine executes the K/V moves."""

    def __init__(self, *, device_rows: int, hybrid: bool,
                 max_entries: int = 64) -> None:
        self.hybrid = hybrid
        self.max_entries = max_entries
        self.entries: Dict[int, PrefixEntry] = {}
        self._free_rows: List[int] = list(range(device_rows))
        self._ids = itertools.count(1)
        self._tick = 0

    def _touch(self, e: PrefixEntry) -> None:
        self._tick += 1
        e.last_use = self._tick

    # --- matching ------------------------------------------------------
    def _usable(self, e: PrefixEntry, prompt: Sequence[int]) -> int:
        """Usable hit length of ``e`` against ``prompt`` (0 = miss)."""
        raw = placement.longest_common_prefix(e.tokens, prompt)
        if self.hybrid and raw < len(e.tokens):
            return 0                   # no carry exists mid-entry
        cap = len(prompt) - placement.chargeable_prefill_tokens(
            len(prompt), raw)
        if self.hybrid and cap < len(e.tokens):
            return 0                   # the whole entry would not fit
        return cap

    def match(self, prompt: Sequence[int]
              ) -> Optional[Tuple[PrefixEntry, int]]:
        """Longest usable cached prefix of ``prompt`` (ties prefer the
        device tier), refreshing the winner's LRU position; None on a
        miss."""
        best: Optional[PrefixEntry] = None
        best_n = 0
        # list(): the pool's on_evict may pop an entry from the host
        # executor's thread mid-walk
        for e in list(self.entries.values()):
            n = self._usable(e, prompt)
            if n > best_n or (n == best_n and n > 0 and best is not None
                              and best.tier == "host"
                              and e.tier == "device"):
                best, best_n = e, n
        if best is None or best_n <= 0:
            return None
        self._touch(best)
        return best, best_n

    def match_len(self, prompt: Sequence[int]) -> int:
        """Pure probe (no LRU touch): deadline backpressure prices the
        uncached suffix with it."""
        return max((self._usable(e, prompt)
                    for e in list(self.entries.values())), default=0)

    # --- eviction ------------------------------------------------------
    def forget_owner(self, owner: int, stats) -> None:
        """The pool's LRU reclaimed a host entry's pages: drop the index
        entry (may run on the host executor's thread)."""
        if self.entries.pop(-owner, None) is not None:
            stats.prefix_evictions += 1

    def drop(self, eng, e: PrefixEntry) -> None:
        """Remove an entry outright, releasing its storage."""
        self.entries.pop(e.entry_id, None)
        if e.tier == "device":
            self._free_rows.append(e.row)
        elif eng.executor is not None:
            eng.executor.pool.free(e.owner)
        eng.stats.prefix_evictions += 1

    def _demote_or_drop(self, eng, e: PrefixEntry) -> None:
        """Evict a device entry: demote its K/V (and carry) to the pool
        when there is room, else drop it.  Its device row frees."""
        pool = eng.executor.pool if eng.executor is not None else None
        n = len(e.tokens)
        if pool is None or not pool.can_admit(n):
            self.drop(eng, e)
            return
        try:
            eng.executor.migrate_prompt(e.owner, stack_row_kv_to_pool_layers(
                eng.cfg, eng.prefix_state, e.row, n))
        except MemoryError:
            self.drop(eng, e)
            return
        if self.hybrid:
            e.carry = snapshot_recurrent_row(eng.cfg, eng.prefix_state, e.row)
        self._free_rows.append(e.row)
        e.tier, e.row = "host", None
        pool.mark_evictable(e.owner)
        eng.stats.prefix_demotions += 1

    def _claim_row(self, eng) -> Optional[int]:
        """A free device row, LRU-demoting the coldest device entry when
        every row is held; None when the cache has no device rows."""
        if self._free_rows:
            return self._free_rows.pop()
        dev = [e for e in list(self.entries.values()) if e.tier == "device"]
        if not dev:
            return None
        self._demote_or_drop(eng, min(dev, key=lambda e: e.last_use))
        return self._free_rows.pop() if self._free_rows else None

    # --- resident-byte gauges --------------------------------------------
    def device_bytes(self, eng) -> int:
        per_tok = 0
        if eng.prefix_state is not None:
            for kind, entry in zip(eng.cfg.block_pattern,
                                   eng.prefix_state.per_entry):
                if kind == BlockKind.ATTN:
                    k = entry.k                           # (G, B, S, KV, D)
                    per_tok += 2 * k.shape[0] * k.shape[3] * k.shape[4] \
                        * k.element_size()
        return sum(len(e.tokens) for e in list(self.entries.values())
                   if e.tier == "device") * per_tok

    def host_bytes(self, eng) -> int:
        if eng.executor is None:
            return 0
        pool = eng.executor.pool
        return sum(pool.owner_pages(e.owner)
                   for e in list(self.entries.values())
                   if e.tier == "host") * pool.page_bytes


def publish_retired(eng, req) -> bool:
    """Publish a retiring request's prompt span to the cache.  Returns
    True when the cache adopted the request's pool chains (the caller
    then skips freeing them); the fork path below shares pages instead
    and returns False, so the normal free drops the request's refs."""
    cache = eng.prefix
    if cache is None or req.error is not None:
        return False
    n = req.prompt_len
    if n < 2:
        return False
    carry = req.prefix_carry
    if cache.hybrid and carry is None:
        return False                   # no graduation snapshot
    tokens = tuple(req.prompt)[:n]
    for e in list(cache.entries.values()):
        if len(e.tokens) >= n and e.tokens[:n] == tokens:
            cache._touch(e)            # already covered by a cached entry
            return False
        if tokens[:len(e.tokens)] == e.tokens:
            cache.drop(eng, e)         # strictly extended: supersede
    while len(cache.entries) >= cache.max_entries:
        cache.drop(eng, min(list(cache.entries.values()),
                            key=lambda e: e.last_use))
    eid = next(cache._ids)
    pool = eng.executor.pool if eng.executor is not None else None
    if req.tier == "device":
        row = cache._claim_row(eng)
        if row is not None:
            # the slot's first n positions are prefill-written (decode
            # appends past them); the row's recurrent state is replaced
            # by the graduation carry (the slot's has decode folded in)
            copy_state_row(eng.cfg, eng.prefix_state, eng.state, req.slot,
                           row, n)
            if cache.hybrid:
                set_recurrent_row(eng.cfg, eng.prefix_state, row, carry)
            e = PrefixEntry(entry_id=eid, tokens=tokens, tier="device",
                            row=row)
        elif pool is not None and pool.can_admit(n):
            # no device row: demote straight from the slot
            e = PrefixEntry(entry_id=eid, tokens=tokens, tier="host")
            try:
                eng.executor.migrate_prompt(
                    e.owner, stack_row_kv_to_pool_layers(eng.cfg, eng.state,
                                                         req.slot, n))
            except MemoryError:
                eng.refresh_prefix_gauges()
                return False
            if cache.hybrid:
                e.carry = carry
            pool.mark_evictable(e.owner)
        else:
            return False
        cache.entries[eid] = e
        cache._touch(e)
        eng.refresh_prefix_gauges()
        return False                   # the slot itself still frees
    if pool is None:
        return False
    # host tier: fork the request's chains (the prompt pages are shared;
    # the retire-time free then drops the request's own references).  The
    # last forked page may hold decode positions past n: the entry's
    # length hides them, and copy-on-write keeps them from being written.
    e = PrefixEntry(entry_id=eid, tokens=tokens, tier="host")
    try:
        pool.fork(req.request_id, e.owner, n)
    except KeyError:
        eng.refresh_prefix_gauges()
        return False
    if cache.hybrid:
        e.carry = carry
    pool.mark_evictable(e.owner)
    cache.entries[eid] = e
    cache._touch(e)
    eng.refresh_prefix_gauges()
    return False
