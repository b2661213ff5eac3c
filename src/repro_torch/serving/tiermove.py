"""Row moves of KV and recurrent state between decode states and tiers
(the lifecycle decides, this moves).

Port of ``repro/serving/tiermove.py``.  Host->device **migration**
uploads a request's paged KV (gathered per attention layer by
``HostExecutor.gather_request``) into a freed device slot and splices
its recurrent rows (hybrids) over from the host row it leaves.
Device->host **preemption** is the inverse: the slot's KV goes to the
paged pool (``stack_row_kv_to_pool_layers`` + ``migrate_prompt``) and its
recurrent rows into the host row.  The prefix cache's moves -- a full
row copy between states, a host entry written into a staging row, a
hybrid's carry snapshot and restore -- live here too.

The reference returns new states; these write in place.  Every
destination is storage of its own (a row of another state, a fresh
clone), never a view of the source, so a later in-place decode or chunk
write to the source cannot reach a copy.  Each move copies cached
values bit for bit, apart from the fp32 host K/V rounded to the bf16
device cache on upload, as in the reference.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.overlap_engine import to_device
from repro_torch.models.config import BlockKind, ModelConfig
from repro_torch.models.kv_cache import StackState


def splice_recurrent_rows(cfg: ModelConfig, state: StackState,
                          src_entries: Sequence, src_row: int,
                          dst_row: int) -> None:
    """Copy row ``src_row`` of every recurrent (non-ATTN) entry of
    ``src_entries`` into row ``dst_row`` of ``state``, in place.
    Attention entries are untouched: host rows hold no device KV."""
    for kind, entry, src in zip(cfg.block_pattern, state.per_entry,
                                src_entries):
        if kind == BlockKind.ATTN:
            continue
        for big, small in zip(entry, src):
            big[:, dst_row].copy_(small[:, src_row])


def zero_recurrent_rows(cfg: ModelConfig, state: StackState,
                        rows: List[int]) -> None:
    """Reset ``rows`` of every recurrent entry to the zero carry of a
    fresh prefill.  A recycled staging row needs this: the previous
    occupant's attention K/V is hidden by length, but a chunk resumes
    whatever carry sits in the row."""
    idx = torch.as_tensor(rows, dtype=torch.long)
    for kind, entry in zip(cfg.block_pattern, state.per_entry):
        if kind == BlockKind.ATTN:
            continue
        for a in entry:
            a[:, idx.to(a.device)] = 0


def _write_kv_span(cfg: ModelConfig, state: StackState,
                   per_layer_kv: List[Tuple[np.ndarray, np.ndarray]],
                   row: int, n: int) -> None:
    """Positions [0, n) of ``row`` in every attention entry from
    per-attention-layer host (K, V): one upload and one device copy per
    pattern entry (all its groups stacked)."""
    for j, kind in enumerate(cfg.block_pattern):
        if kind != BlockKind.ATTN:
            continue
        entry = state.per_entry[j]
        layers = [cfg.attn_layer_indices.index(g * cfg.pattern_period + j)
                  for g in range(cfg.num_groups)]
        for dst, which in ((entry.k, 0), (entry.v, 1)):
            span = np.stack([per_layer_kv[li][which][:n] for li in layers])
            dst[:, row, :n].copy_(to_device(span, dst.device))


def upload_host_kv_to_slot(cfg: ModelConfig, state: StackState,
                           per_layer_kv: List[Tuple[np.ndarray, np.ndarray]],
                           slot: int, n: int, host_row: int) -> None:
    """Splice a migrating request into device ``slot``: its ``n`` cached
    positions of per-attention-layer (K, V) into the slot cache, its
    recurrent rows from ``host_row``, and the slot's length set to n."""
    splice_recurrent_rows(cfg, state, state.per_entry, host_row, slot)
    _write_kv_span(cfg, state, per_layer_kv, slot, n)
    state.lengths[slot] = n


def copy_state_row(cfg: ModelConfig, dst_state: StackState,
                   src_state: StackState, src_row: int, dst_row: int,
                   n: int) -> None:
    """Copy one row of every entry (attention K/V and recurrent carry)
    from ``src_state`` into ``dst_state`` and set the destination
    length to ``n`` -- the prefix cache's device-side move: publication
    (slot -> cache row) and seeding (cache row -> staging row).
    Positions past ``n`` ride along, causally invisible behind it."""
    for entry, src in zip(dst_state.per_entry, src_state.per_entry):
        for big, small in zip(entry, src):
            big[:, dst_row].copy_(small[:, src_row])
    dst_state.lengths[dst_row] = n


def write_prefix_into_row(cfg: ModelConfig, state: StackState,
                          per_layer_kv: List[Tuple[np.ndarray, np.ndarray]],
                          row: int, n: int) -> None:
    """Seed ``row`` with ``n`` cached positions of per-attention-layer
    (K, V) from the host tier (a prefix-cache hit on a pool entry).  No
    recurrent rows move: a hybrid entry's carry is restored separately
    (``set_recurrent_row``)."""
    _write_kv_span(cfg, state, per_layer_kv, row, n)
    state.lengths[row] = n


def snapshot_recurrent_row(cfg: ModelConfig, state: StackState,
                           row: int) -> List:
    """Clones of one row of every recurrent entry (None at attention
    entries): the carry a hybrid prefix-cache entry keeps, since paged
    K/V cannot represent a running state.  The clones stay on the
    state's device, in storage of their own."""
    return [None if kind == BlockKind.ATTN
            else tuple(a[:, row].clone() for a in entry)
            for kind, entry in zip(cfg.block_pattern, state.per_entry)]


def set_recurrent_row(cfg: ModelConfig, state: StackState, row: int,
                      carry: List) -> None:
    """Restore a ``snapshot_recurrent_row`` carry into ``row``."""
    for entry, snap in zip(state.per_entry, carry):
        if snap is None:
            continue
        for big, small in zip(entry, snap):
            big[:, row].copy_(small)


def demote_slot_to_host_row(cfg: ModelConfig, state: StackState, slot: int,
                            host_row: int) -> None:
    """Vacate device ``slot`` for a preempted request: its recurrent rows
    go to ``host_row`` (its attention K/V lives in the paged pool from
    here on) and the slot's length drops to 0."""
    splice_recurrent_rows(cfg, state, state.per_entry, slot, host_row)
    state.lengths[slot] = 0
