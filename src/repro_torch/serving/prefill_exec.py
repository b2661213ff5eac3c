"""Admission-time prefill: the whole-prompt paths and the chunked path's
admission seeding and chunk completion.

  * ``prefill_into_slot`` / ``prefill_to_host`` -- one prompt at its own
    length (``bucketed_prefill=False``);
  * ``prefill_batched`` -- prompt lengths bucket to powers of two and
    same-bucket admissions prefill in ONE device call; device placements
    are spliced into their slot rows (in place), host placements have
    their attention K/V moved to the paged pool and, on hybrid stacks,
    their recurrent state spliced into the unified host row.
  * ``seed_prefix_hits`` -- a freshly staged admission that matches a
    cached prefix gets it in its staging row (and pool chains, on the
    host tier), so chunked prefill resumes at the suffix.
  * ``finish_chunks`` -- after a chunk: stream host rows' chunk K/V to
    the pool, and graduate completed prompts (first token, splice or
    host activation, staging row freed).
"""
from __future__ import annotations

import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.core.overlap_engine import (stack_row_kv_to_pool_layers,
                                             to_device)
from repro_torch.models import init_decode_state, prefill
from repro_torch.serving.lifecycle import ChunkPlan, pow2_ceil, transition
from repro_torch.serving.request import Phase, Request
from repro_torch.serving.sampler import sample
from repro_torch.serving.tiermove import (copy_state_row, set_recurrent_row,
                                          snapshot_recurrent_row,
                                          splice_recurrent_rows,
                                          write_prefix_into_row)


def seed_prefix_hits(eng, placements: List[Tuple[Request, str, int]],
                     rows: List[int]) -> None:
    """Prefix-cache matching for freshly staged admissions: seed each
    hit's staging row with the cached K/V (and carry, for hybrids) and
    advance ``InflightPrefill.consumed`` to the hit length -- chunked
    prefill resumes at the suffix and the chunk backlog prices only the
    uncached tokens.  A host-tier admission also gets the prefix into its
    pool chains: a fork of a host entry, or the device row written out.
    Every move copies bits, so tokens match a cache-off run."""
    cache = eng.prefix
    pool = eng.executor.pool if eng.executor is not None else None
    for (req, tier, _), row in zip(placements, rows):
        eng.stats.prefix_lookups += 1
        hit = cache.match(req.prompt)
        if hit is None:
            continue
        entry, n = hit
        if entry.tier == "host":
            # fallible pool reads first: the LRU may reclaim the entry
            # from the executor's thread between match and here, and the
            # admission then degrades to a miss before touching the row
            try:
                per_layer = [pool.gather(entry.owner, li, n)
                             for li in range(eng.cfg.num_attn_layers)]
                pool.touch(entry.owner)
            except KeyError:
                continue
            write_prefix_into_row(eng.cfg, eng.staging_state, per_layer,
                                  row, n)
            if entry.carry is not None:
                set_recurrent_row(eng.cfg, eng.staging_state, row,
                                  entry.carry)
            eng.stats.prefix_host_hits += 1
        else:
            copy_state_row(eng.cfg, eng.staging_state, eng.prefix_state,
                           entry.row, row, n)
            eng.stats.prefix_device_hits += 1
        if tier == "host":
            # the request's chains must hold the prefix too (host decode
            # reads the whole sequence from the pool): drop the admission
            # reservation, then fork a host entry or write a device one out
            pool.free(req.request_id)
            if entry.tier == "host":
                try:
                    pool.fork(entry.owner, req.request_id, n)
                except KeyError:
                    # evicted between gather and fork: rebuild the chains
                    # from the gathered arrays
                    pool.allocate(req.request_id, req.prompt_len)
                    eng.executor.migrate_prompt(req.request_id, per_layer)
            else:
                eng.executor.migrate_prompt(
                    req.request_id, stack_row_kv_to_pool_layers(
                        eng.cfg, eng.prefix_state, entry.row, n))
        eng.lc.staging[row].consumed = n
        eng.stats.prefix_hits += 1
        eng.stats.prefix_hit_tokens += n
    eng.refresh_prefix_gauges()


def finish_chunks(eng, plan: ChunkPlan, clogits: torch.Tensor) -> None:
    """Bookkeeping after a chunk: host-tier rows stream the chunk's K/V
    into the paged pool; rows whose prompt completed graduate -- first
    token sampled, device rows spliced into their slot, host rows
    activated for the next cohort (recurrent rows spliced into the
    unified host row) -- and their staging rows free."""
    staging = eng.lc.staging
    done_rows = [row for row, c in zip(plan.rows, plan.lens)
                 if staging[row].consumed + c >= staging[row].req.prompt_len]
    toks: Dict[int, int] = {}
    if done_rows:
        picked = sample(clogits[torch.as_tensor(done_rows,
                                                device=clogits.device)],
                        temperature=eng.e.temperature)
        toks = dict(zip(done_rows, picked.cpu().tolist()))
    now = time.perf_counter()
    freed: List[int] = []
    for row, c in zip(plan.rows, plan.lens):
        ent = staging[row]
        start = ent.consumed
        ent.consumed += c
        if ent.tier == "host":
            # K/V streams to the pool at chunk granularity
            eng.executor.migrate_prompt(
                ent.req.request_id, stack_row_kv_to_pool_layers(
                    eng.cfg, eng.staging_state, row, ent.consumed,
                    start=start))
        if ent.consumed < ent.req.prompt_len:
            continue
        req = ent.req
        if eng.prefix is not None and eng.cfg.has_recurrent:
            # the row's carry right now is the prompt-end carry, the only
            # moment it exists before decode advances it
            req.prefix_carry = snapshot_recurrent_row(
                eng.cfg, eng.staging_state, row)
        req.output.append(toks[row])
        if req.first_token_time is None:
            req.first_token_time = now
        if ent.tier == "device":
            eng.splice_device_row(eng.staging_state, row, ent.slot,
                                  req.prompt_len)
            transition(req, Phase.DECODE_DEVICE)
        else:
            if eng.cfg.has_recurrent:
                splice_recurrent_rows(eng.cfg, eng.state,
                                      eng.staging_state.per_entry, row,
                                      eng.e.device_slots + ent.slot)
            transition(req, Phase.DECODE_HOST)
        eng.lc.release_staging_row(row)
        freed.append(row)
    if freed:
        eng.staging_state.lengths[torch.as_tensor(
            freed, device=eng.staging_state.lengths.device)] = 0


def _prefill_one(eng, req: Request):
    """Prefill one prompt at its own length into a fresh one-row state;
    returns (that state, its first token)."""
    transition(req, Phase.PREFILL)
    sub = init_decode_state(eng.cfg, device_batch=1,
                            cache_len=eng.e.cache_len, device=eng.device)
    prompt = to_device(np.asarray([req.prompt], np.int64), eng.device)
    logits, sub = prefill(eng.params, eng.cfg, {"tokens": prompt}, sub)
    req.output.append(int(sample(logits, temperature=eng.e.temperature)[0]))
    if req.first_token_time is None:
        req.first_token_time = time.perf_counter()
    return sub


def prefill_into_slot(eng, req: Request, slot: int) -> None:
    """Prefill one prompt and splice its state row into device ``slot``."""
    sub = _prefill_one(eng, req)
    eng.splice_device_row(sub, 0, slot, req.prompt_len)
    transition(req, Phase.DECODE_DEVICE)


def prefill_to_host(eng, req: Request, host_slot: int) -> None:
    """Prefill one prompt on the device and move its attention K/V to the
    paged pool; recurrent state (hybrids) stays on the device in the
    unified host row."""
    sub = _prefill_one(eng, req)
    if eng.cfg.has_recurrent:
        splice_recurrent_rows(eng.cfg, eng.state, sub.per_entry, 0,
                              eng.e.device_slots + host_slot)
    eng.executor.migrate_prompt(
        req.request_id,
        stack_row_kv_to_pool_layers(eng.cfg, sub, 0, req.prompt_len))
    transition(req, Phase.DECODE_HOST)


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
        toks = sample(logits, temperature=eng.e.temperature).cpu().numpy()
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
