"""Row moves of recurrent state between decode states.

Port of ``splice_recurrent_rows`` from ``repro/serving/tiermove.py``: a
hybrid request's recurrent (Mamba) state stays on the device whichever
tier decodes it, so placing a prefilled request on the host tier copies
its recurrent rows into the unified state's host row.  The copy is in
place (the reference returns a new state).  Zeroing of recycled rows,
migration and the prefix-cache moves come with the slices that need
them.
"""
from __future__ import annotations

from typing import Sequence

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
