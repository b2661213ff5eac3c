"""Admission-time prefill: the bucketed whole-prompt fast path.

Prompt lengths bucket to powers of two and same-bucket admissions
prefill in ONE device call; device placements are spliced into their
slot rows of the shared decode state (in place), host placements have
their attention KV migrated to the paged host pool and, on hybrid
stacks, their recurrent state spliced into the unified host row.
"""
from __future__ import annotations

import time
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.core.overlap_engine import stack_row_kv_to_pool_layers
from repro_torch.serving.lifecycle import pow2_ceil, transition
from repro_torch.serving.request import Phase, Request
from repro_torch.serving.sampler import sample
from repro_torch.serving.tiermove import splice_recurrent_rows


def prefill_batched(eng, placements: List[Tuple[Request, str, int]]) -> None:
    groups: Dict[int, list] = {}
    for p in placements:
        groups.setdefault(pow2_ceil(p[0].prompt_len), []).append(p)
    for blen in sorted(groups):
        group = groups[blen]
        bb = pow2_ceil(len(group))
        tokens = np.zeros((bb, blen), np.int64)
        plens = np.ones((bb,), np.int64)   # padded rows: discarded
        for j, (req, _, _) in enumerate(group):
            transition(req, Phase.PREFILL)
            tokens[j, :req.prompt_len] = req.prompt
            plens[j] = req.prompt_len
        logits, sub = eng.prefill(tokens, plens)
        toks = sample(logits).cpu().numpy()
        now = time.perf_counter()
        for j, (req, tier, slot) in enumerate(group):
            req.output.append(int(toks[j]))
            if req.first_token_time is None:
                req.first_token_time = now
            if tier == "device":
                eng.splice_device_row(sub, j, slot, req.prompt_len)
                transition(req, Phase.DECODE_DEVICE)
            else:
                if eng.cfg.has_recurrent:
                    # recurrent state stays on the device in the unified
                    # host row; only attention KV goes to the pool
                    splice_recurrent_rows(eng.cfg, eng.state, sub.per_entry,
                                          j, eng.e.device_slots + slot)
                eng.executor.migrate_prompt(
                    req.request_id,
                    stack_row_kv_to_pool_layers(eng.cfg, sub, j,
                                                req.prompt_len))
                transition(req, Phase.DECODE_HOST)
