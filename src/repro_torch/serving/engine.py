"""Online serving engine -- execution orchestrator of the APEX design.

The engine owns execution: the model steps on the card, the
Asynchronous Overlap runtime (``OverlapController`` + ``HostExecutor``),
K/V movement between the tiers, and the per-iteration dispatch of
Algorithm 1's ``Decision``:

  * ``GPU_ONLY``       -- device-only decode (no host-designated rows);
  * ``ASYNC_OVERLAP``  -- deferred sync: the previous iteration's host job
    is *polled*; late host rows ride along (the §3.4 re-check);
  * ``ASYM_PIPELINE``  -- host attention is *waited for* between two
    consecutive device steps, so every cycle advances the cohort.

``RequestLifecycle`` decides which request is where; the engine
executes its decisions:

  * **chunked prefill** -- admissions claim staging rows and advance in
    token-budgeted chunks; each iteration enqueues the decode step and
    one chunk over every staging row (``decode_with_chunked_prefill``),
    submitting the host job between the two so host attention overlaps
    the chunk.  ``chunk_tokens=0`` keeps whole-prompt bucketed prefill.
  * **prefix cache** -- retired prompts publish their K/V to device rows
    or the paged pool; matching admissions resume at the suffix.
  * **host->device migration** -- when a device slot frees and the
    drain-time predicate says it pays, a host resident's paged K/V is
    uploaded into the slot (an in-flight host prefill retargets by
    bookkeeping: its K/V already lives in the staging row).
  * **device->host preemption** -- an urgent admission demotes a strictly
    lower-priority device resident: its K/V is swapped to the pool, or
    dropped and replayed through the queue (recompute) when no host room
    exists or the replay is priced cheaper.
  * **host-job watchdog** -- a host job that failed, or missed its
    deadline (the calibrated ``t_catt`` prediction times
    ``host_job_slack``, at least ``host_job_min_timeout``), is abandoned
    and rerun on the engine thread; consecutive fallbacks open a circuit
    breaker that keeps the engine on the device for a doubling cooldown.
  * **cancel** -- a request is aborted wherever it sits, its resources
    freed (a host resident mid-journey at the next token boundary).
  * **CUDA graphs** -- on the card, where ``models.graphs.capturable``
    says so, the decode step (device slots, and with the host slots
    riding along) and the chunk are captured at build, piece by piece
    between their attention calls, and replayed every iteration
    (``EngineStats.graph_steps`` of ``model_steps``).

All moves copy values, so greedy tokens match a run without them (up
to the bf16 device / fp32 host K/V of decode tokens, as in the
reference).  Tokens, masks and host-row scalars go up through pinned
memory without waiting; the host job's Q/K/V are copied down by the
executor's worker.
"""
from __future__ import annotations

import inspect
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import placement
from repro_torch.core.overlap_engine import (Cohort, HostExecutor,
                                             OverlapController,
                                             stack_row_kv_to_pool_layers,
                                             to_device)
from repro_torch.core.perf_model import OnlineCalibrator, resolve_perf_model
from repro_torch.core.scheduler import (AdmissionController, ApexScheduler,
                                        Decision, StrategyKind)
from repro_torch.distributed.fault_tolerance import RestartPolicy
from repro_torch.models import (ModelParams, StepGraphs, capture_chunk,
                                capture_decode, decode_step,
                                decode_with_chunked_prefill,
                                init_decode_state, prefill_bucketed,
                                prefill_chunk)
from repro_torch.models.config import ModelConfig
from repro_torch.models.kv_cache import PagedKVPool, StackState
from repro_torch.models.transformer import HostIO, QKVOut
from repro_torch.serving.lifecycle import (ChunkPlan, EngineConfig,
                                           EngineStats, RequestLifecycle,
                                           TierPlacer, pow2_ceil, reject,
                                           transition)
from repro_torch.serving.faults import FaultInjector
from repro_torch.serving.prefill_exec import (finish_chunks, prefill_batched,
                                              prefill_into_slot,
                                              prefill_to_host,
                                              seed_prefix_hits)
from repro_torch.serving.prefix_cache import PrefixCache, publish_retired
from repro_torch.serving.request import Phase, Request
from repro_torch.serving.sampler import sample
from repro_torch.serving.tiermove import (demote_slot_to_host_row,
                                          upload_host_kv_to_slot,
                                          zero_recurrent_rows)
from repro_torch.tracing import span

__all__ = ["Engine", "EngineConfig", "EngineStats", "resolve_device"]


def resolve_device(device) -> torch.device:
    """The torch device an entry point runs on; a CUDA device without a
    card raises (there is no silent fall back to the CPU)."""
    d = torch.device(device)
    if d.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return d


def check_servable(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for an encoder: the serving engine decodes, and
    an encoder (``causal=False``) has no decode.  (The reference's engine
    runs one anyway, embedding token ids where the model takes frame
    embeddings and decoding through full attention: ROADMAP queue 3.)"""
    if cfg.is_encoder_only:
        raise ValueError(
            f"{cfg.name} is an encoder (causal=False): it has no KV cache "
            "and no decode, so the serving engine does not run it; its "
            "path is model.forward_train over frame embeddings")


class Engine:
    def __init__(self, cfg: ModelConfig, params: ModelParams,
                 ecfg: Optional[EngineConfig] = None,
                 scheduler: Optional[ApexScheduler] = None) -> None:
        check_servable(cfg)
        self.cfg = cfg
        self.params = params
        self.e = ecfg or EngineConfig()
        self.device = resolve_device(self.e.device)
        emb = params.embedding["embed"]
        if emb.device.type != self.device.type:
            raise ValueError(f"params live on {emb.device}, the engine is "
                             f"configured for {self.device}")
        if not cfg.has_kv_cache:
            self.e.enable_offload = False   # APEX inapplicable (xLSTM)
        # recurrent state also spans the host rows
        self.state = init_decode_state(
            cfg, device_batch=self.e.device_slots,
            host_batch=self.e.host_slots if self.e.enable_offload else 0,
            cache_len=self.e.cache_len, device=self.device)
        self.stats = EngineStats()
        self.stats.degradation_window = self.e.degradation_window
        self.scheduler = scheduler
        # deterministic chaos (None without a plan): the injector threads
        # through the executor and the paged pool
        self.faults = FaultInjector.from_config(self.e.fault_plan)
        self._calibrator: Optional[OnlineCalibrator] = None
        if self.scheduler is None and self.e.use_scheduler:
            self._calibrator = OnlineCalibrator(resolve_perf_model(
                self.e.perf_model, cfg, platform=self.e.platform,
                profile_cache=self.e.profile_cache,
                profile_grid=self.e.profile_grid, device=str(self.device),
                host_kv_dtype=self.e.host_kv_dtype))
            self.stats.perf_model_spec = self.e.perf_model
            self.scheduler = ApexScheduler(
                self._calibrator, host_min_ratio=self.e.host_min_ratio,
                max_pipeline_sub_batch=self.e.max_pipeline_sub_batch)
        # an injected scheduler without the chunk arguments still works:
        # the engine then sizes the chunk budget itself
        self._sched_chunk_aware = self.scheduler is not None and \
            "chunk_tokens_max" in inspect.signature(
                self.scheduler.schedule).parameters
        # KV budgets: the overrides, else slot and pool capacity
        device_budget = (self.e.device_kv_budget_tokens
                         if self.e.device_kv_budget_tokens is not None
                         else self.e.device_slots * self.e.cache_len)
        host_budget = 0
        if self.e.enable_offload:
            host_budget = (self.e.host_kv_budget_tokens
                           if self.e.host_kv_budget_tokens is not None
                           else self.e.host_pool_pages * self.e.page_size)
        self.admission = AdmissionController(
            device_kv_budget_tokens=device_budget,
            host_kv_budget_tokens=host_budget)
        placer = TierPlacer(admission=self.admission,
                            perf_model=self._calibrator,
                            iters_per_host_token=cfg.num_attn_layers + 1)
        self.lc = RequestLifecycle(self.e, stats=self.stats, placer=placer)
        self._prefill_shapes: set = set()
        self._idle_io: Optional[HostIO] = None
        # chunked prefill (and the prefix cache on it) rides on bucketing
        self._chunked = self.e.chunk_tokens > 0 and self.e.bucketed_prefill
        self.staging_state: Optional[StackState] = None
        if self._chunked:
            # one staging row per admissible request: prompts prefill
            # there chunk by chunk, then splice into their device slot or
            # (host tier) finish streaming to the paged pool
            n_staging = self.e.device_slots + (
                self.e.host_slots if self.e.enable_offload else 0)
            self.staging_state = init_decode_state(
                cfg, device_batch=n_staging, cache_len=self.e.cache_len,
                device=self.device)
            self.lc.staging = [None] * n_staging
        self._overlap: Optional[OverlapController] = None
        self.executor: Optional[HostExecutor] = None
        if self.e.enable_offload:
            self._overlap = OverlapController(cfg)
            pool = PagedKVPool(
                self.e.host_pool_pages, self.e.page_size,
                cfg.num_attn_layers, cfg.num_kv_heads, cfg.resolved_head_dim,
                host_kv_dtype=self.e.host_kv_dtype,
                cold_page_compress_after=self.e.cold_page_compress_after)
            pool.fault_hook = (self.faults.on_pool_alloc
                               if self.faults is not None else None)
            self.executor = HostExecutor(cfg, pool,
                                         workers=self.e.host_workers,
                                         faults=self.faults)
            self.stats.host_workers = self.executor.workers
            self._cohort: Optional[Cohort] = None
            self._pending_job: Optional[int] = None
            self._pending_host_pred = 0.0   # predicted time of pending job
            self._host_compute_seen = 0.0   # executor compute_time watermark
            self._job_ids = iter(range(1, 1 << 30))
            # host-job watchdog: the pending job's arguments and deadline,
            # so a stalled or failed job can be rerun on this thread
            self._pending_meta: Optional[dict] = None
            self._pending_deadline = 0.0
            # circuit breaker over consecutive fallbacks: while open (now <
            # _breaker_until) no host job is submitted and nothing is
            # placed on or demoted to the host tier; RestartPolicy doubles
            # the cooldown per trip, a healthy host job resets it
            self._fallback_streak = 0
            self._breaker_until = 0.0
            self._breaker = RestartPolicy(
                max_restarts=1 << 30,
                backoff_base=max(self.e.host_breaker_cooldown, 1e-3),
                backoff_cap=max(self.e.host_breaker_cooldown, 1e-3) * 32)
        # cross-request prefix cache; rides the chunked path (a hit
        # resumes a prompt mid-way)
        self.prefix: Optional[PrefixCache] = None
        self.prefix_state: Optional[StackState] = None
        if self.e.prefix_cache and self._chunked:
            n_rows = max(self.e.prefix_cache_slots, 0)
            self.prefix = PrefixCache(device_rows=n_rows,
                                      hybrid=cfg.has_recurrent)
            if n_rows > 0:
                # a state of its own: decode writes every row of the
                # decode state each step
                self.prefix_state = init_decode_state(
                    cfg, device_batch=n_rows, cache_len=self.e.cache_len,
                    device=self.device)
            placer.cached_prefix_probe = self.prefix.match_len
            if self.executor is not None:
                self.executor.pool.on_evict = self._on_pool_evict
        # device K/V rows the engine holds: decode slots, staging rows and
        # prefix rows, each of cache_len positions
        self._kv_rows = 0
        if cfg.has_kv_cache:
            self._kv_rows = self.e.device_slots + len(self.lc.staging) + (
                self.prefix_state.lengths.shape[0]
                if self.prefix_state is not None else 0)
        # CUDA graphs of the model step's pieces, where the stack allows
        # them (``graphs.capturable``): every shape the steps take is
        # known now, and captured now, while no row holds anything
        self.graphs = StepGraphs.for_device(cfg, self.device)
        if self.graphs.captures:
            self._capture_steps()

    def _capture_steps(self) -> None:
        """Capture the decode step over the device slots, with the host
        slots riding along too when offload is on, and the chunk over the
        staging rows."""
        capture_decode(self.params, self.cfg, self.graphs, self.state)
        if self.executor is not None:
            capture_decode(self.params, self.cfg, self.graphs, self.state,
                           self._zero_host_io())
        if self._chunked:
            capture_chunk(self.params, self.cfg, self.graphs,
                          self.staging_state, pow2_ceil(self.e.chunk_tokens))

    def _on_pool_evict(self, owner: int) -> None:
        """The pool's LRU reclaimed a cached prefix chain: the first rung
        of the degradation ladder."""
        self.prefix.forget_owner(owner, self.stats)
        self.stats.note_pressure("prefix_evict")

    # --- lifecycle views ---------------------------------------------------
    @property
    def queue(self):
        return self.lc.queue

    @property
    def slots(self) -> List[Optional[Request]]:
        return self.lc.slots

    @property
    def host_requests(self) -> Dict[int, Request]:
        return self.lc.host_requests

    @property
    def has_work(self) -> bool:
        return self.lc.has_work

    def submit(self, request: Request) -> None:
        self.lc.submit(request)

    @staticmethod
    def reject(request: Request, reason: str) -> None:
        reject(request, reason)

    @staticmethod
    def prompt_reject_reason(prompt_len: int,
                             cache_len: int) -> Optional[str]:
        """None when the prompt is non-empty and leaves room to generate
        at least one token, else the rejection reason."""
        if prompt_len < 1:
            return "empty prompt"
        if prompt_len < cache_len - 1:
            return None
        return (f"prompt of {prompt_len} tokens does not fit "
                f"cache_len={cache_len} with room to generate")

    # --- prefill ----------------------------------------------------------
    def prefill(self, tokens: np.ndarray, plens: np.ndarray):
        """Bucketed prefill of right-padded prompts on the engine's
        device; returns (logits, filled sub-state)."""
        self._prefill_shapes.add(tokens.shape)
        return prefill_bucketed(self.params, self.cfg,
                                to_device(tokens, self.device),
                                to_device(plens, self.device),
                                cache_len=self.e.cache_len)

    def splice_device_row(self, sub: StackState, row: int, slot: int,
                          plen: int) -> None:
        """Copy one prefilled sub-state row of every entry (attention KV
        and recurrent state) into a slot row of the shared state in place
        (the reference's dynamic_update on donated buffers)."""
        for entry, small in zip(self.state.per_entry, sub.per_entry):
            for big, src in zip(entry, small):
                big[:, slot].copy_(src[:, row])
        self.state.lengths[slot] = plen

    def _admit(self) -> List[Request]:
        """Admit queued requests through the lifecycle (budgets, slots,
        deadline backpressure and preemption in one placement decision),
        then stage (chunked) or prefill them.  Returns the requests
        placed this iteration.  While the breaker is open, nothing goes to
        the host tier."""
        host_ok = self.executor is not None and not self._breaker_open()
        demote = None
        if self.e.preemption and host_ok:
            demote = self._preempt_to_host
        placements = self.lc.admit(
            pool=self.executor.pool if host_ok else None,
            demote=demote, prompt_reject_reason=self.prompt_reject_reason)
        if not placements:
            return []
        if self._chunked:
            rows = self.lc.stage(placements)
            if self.cfg.has_recurrent:
                # a recycled row still holds its last occupant's carry,
                # which the first chunk would resume
                zero_recurrent_rows(self.cfg, self.staging_state, rows)
            if self.prefix is not None:
                seed_prefix_hits(self, placements, rows)
        elif self.e.bucketed_prefill:
            prefill_batched(self, placements)
            self.stats.prefill_compilations = len(self._prefill_shapes)
        else:
            for req, tier, slot in placements:
                if tier == "device":
                    prefill_into_slot(self, req, slot)
                else:
                    prefill_to_host(self, req, slot)
        return [p[0] for p in placements]

    # --- tier moves (the placer decides; the engine moves the K/V) --------
    def _migrate_host_to_device(self, req: Request, slot: int) -> None:
        """Promote a host resident into a freed device slot: its paged
        K/V uploaded into the slot cache, its recurrent rows (hybrids)
        spliced from the host row.  Runs only at cohort token boundaries
        (or for requests outside the cohort), so no host job touches its
        chains meanwhile."""
        transition(req, Phase.MIGRATING)
        n = self.executor.pool.lengths[req.request_id]
        upload_host_kv_to_slot(
            self.cfg, self.state, self.executor.gather_request(
                req.request_id), slot, n,
            host_row=self.e.device_slots + req.slot)
        self.executor.free(req.request_id)
        self.lc.note_migrated(req, slot)

    def _retarget_staging(self, req: Request, slot: int) -> None:
        """Mid-prefill host->device retarget: the staging row already
        holds the K/V on the device, so the move is bookkeeping -- free
        the pool chains of the chunks streamed so far and flip the
        entry's tier; completion then splices into the device slot."""
        ent = next(self.lc.staging[row] for row in self.lc.staging_order
                   if self.lc.staging[row].req is req)
        transition(req, Phase.MIGRATING)
        self.executor.free(req.request_id)
        self.lc.note_migrated(req, slot, to_prefill=True)
        ent.tier = "device"
        ent.slot = slot

    def _rebalance(self) -> None:
        """Host->device rebalancing: promote host residents into free
        device slots while the shared drain-time predicate says each
        move pays.  Cohort members move only at token boundaries."""
        if not (self.e.tier_rebalance and self.executor is not None):
            return
        lc = self.lc
        while True:
            slot = lc.free_slot()
            if slot is None or lc.queue:
                return
            boundary = self._cohort is None or self._cohort.attn_ptr == -1
            mid_journey = (set(self._cohort.slot_rids)
                           if self._cohort is not None and not boundary
                           else set())
            candidates = [r for r in lc.decoding_hosts()
                          if r.request_id not in mid_journey]
            if self._chunked:
                candidates += [lc.staging[row].req
                               for row in lc.staging_order
                               if lc.staging[row].tier == "host"]
            cand = lc.placer.rebalance_candidate(
                candidates, waiting=len(lc.queue), device_slot_free=True,
                device_batch=sum(r is not None for r in lc.slots))
            if cand is None:
                return
            if cand.phase is Phase.PREFILL:
                self._retarget_staging(cand, slot)
            else:
                self._migrate_host_to_device(cand, slot)

    def _preempt_to_host(self, urgent: Request) -> Optional[int]:
        """Demote the placer's lowest-priority device resident to the host
        tier and return its freed slot; None when preemption cannot help.
        When the swap cannot proceed (no host slot or pool room, a lost
        allocation race) or a replay is priced below the K/V move, the
        victim is recompute-preempted instead (if ``recompute_fallback``).
        The swap reads the slot's K/V into host memory before returning,
        so the urgent request may overwrite the slot right after."""
        lc = self.lc
        hslot = lc.free_host_slot()
        residents = [r for r in lc.slots
                     if r is not None and not r.done
                     and r.phase is Phase.DECODE_DEVICE]
        victim = lc.placer.preemption_victim(
            residents, urgent=urgent, host_slot_free=hslot is not None,
            pool_ok=self.executor.pool.can_admit)
        if victim is None:
            return self._recompute_preempt(urgent, residents)
        if self.e.recompute_fallback and lc.placer.prefer_recompute(victim):
            return self._recompute_victim(victim)
        slot = victim.slot
        n = victim.total_len - 1           # cached positions in the slot
        try:
            self.executor.pool.allocate(victim.request_id, n)
        except MemoryError:
            # can_admit is advisory: recompute rather than strand the
            # urgent request behind a full pool
            return self._recompute_victim(victim)
        transition(victim, Phase.PREEMPTED)
        self.executor.migrate_prompt(
            victim.request_id,
            stack_row_kv_to_pool_layers(self.cfg, self.state, slot, n))
        demote_slot_to_host_row(self.cfg, self.state, slot,
                                host_row=self.e.device_slots + hslot)
        lc.note_preempted(victim, hslot)
        # the cohort picks the demoted request up at its next boundary
        return slot

    def _recompute_preempt(self, urgent: Request,
                           residents: List[Request]) -> Optional[int]:
        """No swap capacity: recompute-preempt the structural victim
        (lowest priority, smallest K/V) if the escape hatch is on and a
        strictly lower-priority resident exists."""
        if not self.e.recompute_fallback:
            return None
        victim = placement.pick_preemption_victim(
            residents, urgent_priority=urgent.priority)
        if victim is None:
            return None
        return self._recompute_victim(victim)

    def _recompute_victim(self, victim: Request) -> int:
        """Drop a device resident's K/V and requeue it on the RECOMPUTE
        edge; returns its freed slot (length hygiene hides the stale
        rows, and the replay prefills fresh ones)."""
        slot = victim.slot
        self.lc.note_recomputed(victim)
        return slot

    # --- host-tier fault tolerance ------------------------------------------
    def _breaker_open(self) -> bool:
        """True while the host-tier circuit breaker holds the engine on the
        device: no host-job submits, no host placements or demotions,
        until the cooldown elapses and the host tier is probed again."""
        return (self.executor is not None
                and time.perf_counter() < self._breaker_until)

    def _host_fallback(self) -> np.ndarray:
        """Watchdog recovery: abandon the pending host job (late, or died
        with an exception) and rerun it on this thread through the
        executor's injection-free path.  The job's Q/K/V are its own
        tensors and ``append_rows`` writes at explicit positions, so the
        rerun gives the tokens of a fault-free run; the abandoned worker
        writes nothing once ``cancel`` returns.  Consecutive fallbacks
        trip the breaker with a cooldown that doubles per trip."""
        meta = self._pending_meta
        self.executor.cancel(self._pending_job)
        out = self.executor.execute_sync(
            next(self._job_ids), meta["layer"], meta["request_ids"],
            meta["q"], meta["k"], meta["v"], meta["positions"],
            rows=meta["rows"])
        self.stats.host_fallbacks += 1
        self._fallback_streak += 1
        # a recovery's time says nothing of a healthy host tier: never
        # feed it to the calibrator
        self._pending_host_pred = 0.0
        if self._fallback_streak >= self.e.host_breaker_threshold:
            self._fallback_streak = 0
            delay = self._breaker.next_delay() or self.e.host_breaker_cooldown
            self._breaker_until = time.perf_counter() + delay
            self.stats.host_breaker_trips += 1
        return out

    # --- client aborts ------------------------------------------------------
    def cancel(self, request_id: int) -> bool:
        """Abort a live request wherever it sits -- queue, staging row,
        device slot or host tier -- releasing what it holds (K/V budget,
        slot, pool chains, staging row); it finishes with
        ``error='cancelled'``.  A host resident inside an in-flight cohort
        journey is finished at the next token boundary (membership is
        frozen mid-journey).  Returns True when the request was live."""
        lc = self.lc
        req = lc.queue.remove(request_id)
        if req is not None:                       # queued (or RECOMPUTE wait)
            reject(req, "cancelled")
            self.stats.cancelled += 1
            return True
        for row in list(lc.staging_order):        # mid-chunked-prefill
            ent = lc.staging[row]
            if ent.req.request_id != request_id:
                continue
            lc.release_staging_row(row)
            req = ent.req
            if ent.tier == "device":
                lc.slots[ent.slot] = None
                lc.admission.release("device", req.kv_reserved)
            else:
                self.executor.free(request_id)
                lc.host_slot_owner.pop(ent.slot, None)
                lc.host_requests.pop(request_id, None)
                lc.admission.release("host", req.kv_reserved)
            req.kv_reserved = 0
            req.slot = None
            reject(req, "cancelled")
            self.stats.cancelled += 1
            return True
        for i, r in enumerate(lc.slots):          # device resident
            if r is not None and r.request_id == request_id and not r.done:
                reject(r, "cancelled")
                lc.admission.release("device", r.kv_reserved)
                lc.slots[i] = None
                r.slot = None
                self.stats.cancelled += 1
                return True
        req = lc.host_requests.get(request_id)    # host resident: deferred
        if req is not None and not req.done:
            req.cancel_requested = True
            self._apply_host_cancels()
            return True
        return False

    def _apply_host_cancels(self) -> None:
        """Finish host residents whose cancel was deferred -- only at a
        cohort token boundary (attn_ptr == -1), where no host job is
        pending and no recurrent commit is mid-journey.  Runs at the top
        of every step and from cancel()."""
        if self.executor is None:
            return
        if self._cohort is not None and self._cohort.attn_ptr != -1:
            return
        lc = self.lc
        doomed = [rid for rid, r in lc.host_requests.items()
                  if r.cancel_requested and not r.done]
        for rid in doomed:
            r = lc.host_requests.pop(rid)
            reject(r, "cancelled")
            lc.admission.release("host", r.kv_reserved)
            self.executor.free(rid)
            lc.host_slot_owner.pop(r.slot, None)
            r.slot = None
            r.kv_reserved = 0
            self.stats.cancelled += 1

    def refresh_prefix_gauges(self) -> None:
        """Resident-byte gauges of the prefix cache, per tier, kept
        current on every cache mutation."""
        if self.prefix is None:
            return
        self.stats.prefix_device_bytes = self.prefix.device_bytes(self)
        self.stats.prefix_host_bytes = self.prefix.host_bytes(self)

    # --- cohort management ------------------------------------------------
    def _ensure_cohort(self) -> Optional[Cohort]:
        """(Re)build the host cohort -- only at token boundaries."""
        c = self._cohort
        if c is not None and c.attn_ptr != -1:
            return c
        hosts = self.lc.host_requests
        slot_rids = [rid if rid >= 0 and not hosts[rid].done
                     and hosts[rid].phase is Phase.DECODE_HOST else -1
                     for rid in (self.lc.host_slot_owner.get(i, -1)
                                 for i in range(self.e.host_slots))]
        last_tokens = [hosts[rid].output[-1] if rid >= 0 else 0
                       for rid in slot_rids]
        positions = [hosts[rid].total_len - 1 if rid >= 0 else 0
                     for rid in slot_rids]
        self._cohort = self._overlap.build_cohort(
            self.params.embedding["embed"], slot_rids, last_tokens,
            positions)
        return self._cohort

    # --- Algorithm 1 ---------------------------------------------------------
    def _schedule(self, admitted: List[Request],
                  active_rows: List[int]) -> Optional[Decision]:
        if self.scheduler is None:
            return None
        prefill_q, decode_gpu, decode_cpu, backlog = \
            self.lc.schedule_snapshots(admitted, active_rows,
                                       chunked=self._chunked)
        if self._chunked:
            # a chunk-aware scheduler grants the budget (the mixed
            # branch's prefill share) itself; for another, price the
            # budget step() will grant
            prefill_tokens = 0 if self._sched_chunk_aware else (
                min(backlog, self._fallback_chunk_budget(active_rows))
                if prefill_q else 0)
        else:
            prefill_tokens = sum(r.prompt_len for r in admitted)
        if not (prefill_q or decode_gpu or decode_cpu):
            return None                      # idle iteration
        contexts = [r.total_len for r in decode_gpu + decode_cpu]
        mean_context = float(np.mean(contexts)) if contexts else 1.0
        kw = {}
        if self._sched_chunk_aware:
            kw = dict(chunk_backlog_tokens=backlog,
                      chunk_tokens_max=(self.e.chunk_tokens
                                        if self._chunked else 0))
        decision = self.scheduler.schedule(
            prefill_q, decode_gpu, decode_cpu,
            mean_context=max(mean_context, 1.0),
            prefill_tokens=prefill_tokens, **kw)
        self.stats.record_decision(decision)
        return decision

    def _fallback_chunk_budget(self, active_rows: List[int]) -> int:
        """Chunk budget without a chunk-aware scheduler: the whole backlog
        while nothing decodes, the ``chunk_tokens`` cap otherwise."""
        if not active_rows and not self.lc.decoding_hosts():
            return self.lc.staging_backlog()
        return self.e.chunk_tokens

    # --- one engine iteration ------------------------------------------------
    def step(self) -> None:
        with span("serve.step"):
            self._step()

    def _step(self) -> None:
        if self.executor is not None and self.e.cold_page_compress_after > 0:
            # before the timed section: compression is pool maintenance,
            # not iteration work the calibrator should learn from.  The
            # live cohort is skipped: its jobs read its chains outside the
            # pool's lock, one layer per iteration, so it is never cold
            self.executor.pool.maybe_compress_cold(
                skip=self._cohort.request_ids if self._cohort is not None
                else ())
        t0 = time.perf_counter()
        if self.faults is not None:
            spike = self.faults.on_engine_step()
            if spike is not None:
                # after t0 on purpose: the spike lands inside the timed
                # section, so the calibrator sees it like a real stall
                time.sleep(spike)
        with span("serve.admit"):
            self._apply_host_cancels()
            admitted = self._admit()
            self._rebalance()
        # rows whose request already reached max_new_tokens straight out
        # of prefill, and chunked admissions still mid-prefill, do not
        # ride this iteration's decode batch
        active_rows = [i for i, r in enumerate(self.lc.slots)
                       if r is not None and not r.done
                       and r.phase is Phase.DECODE_DEVICE]
        with span("serve.schedule"):
            decision = self._schedule(admitted, active_rows)
        plan = None
        if self._chunked and self.lc.staging_order:
            budget = (decision.chunk_tokens
                      if decision is not None and self._sched_chunk_aware
                      else self._fallback_chunk_budget(active_rows))
            with span("serve.plan"):
                plan = self.lc.plan_chunks(budget)
        tokens = np.zeros((self.e.device_slots,), np.int64)
        for i in active_rows:
            tokens[i] = self.lc.slots[i].output[-1]
        # lengths hygiene for empty slots, as a device op
        mask = np.zeros((self.e.device_slots,), bool)
        mask[active_rows] = True
        lengths = torch.where(to_device(mask, self.device),
                              self.state.lengths, 0)
        self.state = StackState(per_entry=self.state.per_entry,
                                lengths=lengths)
        cohort = self._ensure_cohort() if self.e.enable_offload else None
        tokens_d = to_device(tokens, self.device)
        if cohort is not None:
            wait = (decision is not None
                    and decision.strategy == StrategyKind.ASYM_PIPELINE)
            self._step_overlap(tokens_d, cohort, active_rows, wait=wait,
                               plan=plan)
        elif active_rows or plan is not None:
            self._step_device_only(tokens_d, active_rows, plan)
        if plan is not None:
            self.stats.prefill_chunks += len(plan.rows)
            self.stats.chunked_prefill_tokens += sum(plan.lens)
            if active_rows or cohort is not None:
                self.stats.chunk_co_run_iterations += 1
            self._prefill_shapes.add(plan.tokens.shape)
            self.stats.prefill_compilations = len(self._prefill_shapes)
        self.stats.model_steps = self.graphs.steps
        self.stats.graph_steps = self.graphs.replays
        self.stats.iterations += 1
        self.lc.note_iteration()
        self._note_kv()
        dt = time.perf_counter() - t0
        self.stats.wall_time += dt
        predicted = getattr(decision, "predicted_time", 0.0) \
            if decision is not None else 0.0
        if predicted > 0.0:
            self.stats.predicted_time += predicted
            self.stats.observed_time += dt
            if self._calibrator is not None:
                self._calibrator.observe_step(predicted, dt)
                self.stats.step_error_ewma = self._calibrator.step_error_ewma
        with span("serve.retire"):
            self.lc.retire(free_host=(self.executor.free
                                      if self.executor is not None
                                      else lambda rid: None),
                           publish=(self._publish if self.prefix is not None
                                    else None))

    def _note_kv(self) -> None:
        """This iteration's device K/V occupancy, from host-side lengths:
        positions holding tokens in the decode slots, the staging rows and
        the prefix rows, against those rows' reserved positions."""
        if not self._kv_rows:
            return
        lc = self.lc
        used = sum(r.total_len - 1 for r in lc.slots
                   if r is not None and r.phase is Phase.DECODE_DEVICE)
        used += sum(lc.staging[row].consumed for row in lc.staging_order)
        if self.prefix_state is not None:
            used += sum(len(e.tokens) for e in self.prefix.entries.values()
                        if e.tier == "device")
        self.stats.kv_used_tokens += used
        self.stats.kv_reserved_tokens += self._kv_rows * self.e.cache_len

    def _finish_chunks(self, plan: ChunkPlan, clogits: torch.Tensor) -> None:
        with span("serve.finish_chunks"):
            finish_chunks(self, plan, clogits)

    def _publish(self, req: Request) -> bool:
        with span("serve.publish"):
            return publish_retired(self, req)

    def _chunk_inputs(self, plan: ChunkPlan):
        return (to_device(plan.tokens, self.device),
                to_device(plan.clens, self.device))

    def _step_device_only(self, tokens: torch.Tensor, active_rows: List[int],
                          plan: Optional[ChunkPlan]) -> None:
        if plan is None:
            logits, self.state, _, _ = decode_step(
                self.params, self.cfg, tokens, self.state,
                self._idle_host_io(), graphs=self.graphs)
            self._commit_device(logits, active_rows)
            return
        ctoks, clens = self._chunk_inputs(plan)
        if not active_rows:
            clogits, self.staging_state = prefill_chunk(
                self.params, self.cfg, ctoks, clens, self.staging_state,
                graphs=self.graphs)
            self._finish_chunks(plan, clogits)
            return
        logits, self.state, _, _, clogits, self.staging_state = \
            decode_with_chunked_prefill(
                self.params, self.cfg, tokens, self.state,
                self._idle_host_io(), ctoks, clens, self.staging_state,
                graphs=self.graphs)
        self._commit_device(logits, active_rows)
        self._finish_chunks(plan, clogits)

    def _idle_host_io(self) -> Optional[HostIO]:
        """The step's ``HostIO`` when no cohort is live: None, except for a
        hybrid with offload, whose recurrent state spans the host rows --
        it decodes through the unified step with every host row idle (no
        emit, no consume, an empty commit window).  Built once."""
        if self.executor is None or not self.cfg.has_recurrent:
            return None
        if self._idle_io is None:
            self._idle_io = self._zero_host_io()
        return self._idle_io

    def _zero_host_io(self) -> HostIO:
        """Every host slot empty and idle: no emit, no consume, an empty
        commit window."""
        bc = self.e.host_slots
        emb = self.params.embedding["embed"]
        return HostIO(
            x_carry=torch.zeros((bc, self.cfg.d_model), dtype=emb.dtype,
                                device=self.device),
            positions=torch.zeros((bc,), dtype=torch.int32,
                                  device=self.device),
            attn_in=torch.zeros((bc, self.cfg.num_heads,
                                 self.cfg.resolved_head_dim),
                                dtype=torch.float32, device=self.device),
            consume_layer=-1, emit_layer=-1, window_start=0, window_end=0,
            row_valid=torch.zeros((bc,), dtype=torch.bool,
                                  device=self.device))

    def _commit_device(self, logits: torch.Tensor,
                       active_rows: List[int]) -> np.ndarray:
        """Greedy tokens of every row, read back once -- the iteration's
        one sync; device rows append theirs."""
        with span("serve.commit"):
            toks = sample(logits,
                          temperature=self.e.temperature).cpu().numpy()
            now = time.perf_counter()
            for i in active_rows:
                r = self.lc.slots[i]
                r.output.append(int(toks[i]))
                self.stats.device_tokens += 1
                if r.first_token_time is None:
                    r.first_token_time = now
        return toks

    def _step_overlap(self, tokens: torch.Tensor, cohort: Cohort,
                      active_rows: List[int], *, wait: bool = False,
                      plan: Optional[ChunkPlan] = None) -> None:
        """One hybrid iteration (paper §3.3).

        ``wait=False`` -- Asynchronous Overlap: poll the pending host
        job; if late, host rows ride along untouched.  ``wait=True`` --
        Asymmetric Pipelining: block until the host result is ready.
        The host job is submitted with the device Q/K/V of the decode
        step plus a CUDA event recorded right after it, before the
        iteration's prefill chunk is enqueued: the worker's copy and the
        host attention overlap the chunk's compute.  A job that failed or
        is past its watchdog deadline is rerun on this thread
        (``_host_fallback``); while the breaker is open, host attention
        runs here at the emit point instead of being submitted.
        """
        ctl = self._overlap
        valid = cohort.valid_slots
        bg = self.e.device_slots
        if self._pending_job is not None:
            t_wait = time.perf_counter()
            fell_back = False
            self.stats.host_consumes += 1
            with span("serve.host_wait"):
                try:
                    if wait:
                        timeout = 120.0
                        if self.e.recompute_fallback \
                                and self._pending_deadline:
                            timeout = max(self._pending_deadline
                                          - time.perf_counter(), 0.001)
                        out = self.executor.result(self._pending_job,
                                                   timeout=timeout)
                    else:
                        out = self.executor.poll(self._pending_job)
                        if out is None and self.e.recompute_fallback \
                                and self._pending_deadline \
                                and time.perf_counter() \
                                > self._pending_deadline:
                            raise TimeoutError(
                                f"host job {self._pending_job} missed its "
                                "watchdog deadline")
                except (RuntimeError, TimeoutError):
                    # a worker exception (RuntimeError from the executor)
                    # or the deadline: without the fallback, host faults
                    # fail the engine
                    if not self.e.recompute_fallback:
                        raise
                    out = self._host_fallback()
                    fell_back = True
            self.stats.host_wait_time += time.perf_counter() - t_wait
            if out is None:
                self.stats.host_late_polls += 1
                host_idle = ctl.host_io(cohort)._replace(
                    consume_layer=-1, emit_layer=-1, window_start=0,
                    window_end=0)
                if plan is None:
                    logits, self.state, _, _ = decode_step(
                        self.params, self.cfg, tokens, self.state, host_idle,
                        graphs=self.graphs)
                    self._commit_device(logits, active_rows)
                    return
                logits, self.state, _, _, clogits, self.staging_state = \
                    decode_with_chunked_prefill(
                        self.params, self.cfg, tokens, self.state, host_idle,
                        *self._chunk_inputs(plan), self.staging_state,
                        graphs=self.graphs)
                self._commit_device(logits, active_rows)
                self._finish_chunks(plan, clogits)
                return
            buf = np.zeros(tuple(cohort.attn_in.shape), np.float32)
            buf[np.asarray(valid, np.int64)] = out
            cohort.attn_in = to_device(buf, self.device)
            self.executor.recycle(out)
            self._pending_job = None
            self._pending_meta = None
            self._pending_deadline = 0.0
            if not fell_back:
                # a healthy consume closes the fallback streak and resets
                # the breaker's cooldown
                self._fallback_streak = 0
                self._breaker.record_success()
            # host-side calibration against the executor's compute time
            if self._calibrator is not None and self._pending_host_pred > 0:
                self._calibrator.observe_host(
                    self._pending_host_pred,
                    self.executor.compute_time - self._host_compute_seen)
            self._host_compute_seen = self.executor.compute_time
            self._pending_host_pred = 0.0

        io = ctl.host_io(cohort)
        emit_layer = ctl.emit_layer(cohort)
        completes = ctl.completes_token(cohort)
        idx = np.asarray(valid, np.int64)
        positions = cohort.positions[idx]
        breaker_open = emit_layer >= 0 and self._breaker_open()

        def submit_host_job(qkv: Optional[QKVOut]) -> None:
            if emit_layer < 0 or breaker_open:
                return
            with span("serve.host_submit"):
                ready = None
                if self.device.type == "cuda":
                    ready = torch.cuda.Event()
                    ready.record()
                # submitted before the chunk and before the logits sync: the
                # worker copies Q/K/V and computes while the card runs them
                job = next(self._job_ids)
                self.executor.submit(job, emit_layer, cohort.request_ids,
                                     qkv.q, qkv.k, qkv.v, positions, rows=idx,
                                     ready=ready)
                self._pending_job = job
                # watchdog stash: what the job needs to be rerun here
                self._pending_meta = dict(
                    layer=emit_layer, request_ids=cohort.request_ids,
                    q=qkv.q, k=qkv.k, v=qkv.v, positions=positions, rows=idx)
                pred = 0.0
                if self._calibrator is not None:
                    pred = self._calibrator.t_catt(
                        len(valid), float(np.mean(positions + 1)), layers=1)
                    self._pending_host_pred = pred
                self._pending_deadline = time.perf_counter() + max(
                    pred * self.e.host_job_slack, self.e.host_job_min_timeout)

        clogits = None
        if plan is None:
            logits, self.state, qkv, x_final = decode_step(
                self.params, self.cfg, tokens, self.state, io,
                graphs=self.graphs)
            submit_host_job(qkv)
        else:
            logits, self.state, qkv, x_final, clogits, self.staging_state = \
                decode_with_chunked_prefill(
                    self.params, self.cfg, tokens, self.state, io,
                    *self._chunk_inputs(plan), self.staging_state,
                    after_decode=submit_host_job, graphs=self.graphs)
        if breaker_open:
            # the async host tier is suspect: this layer's host attention
            # runs here, synchronously (ASYM_PIPELINE semantics, no
            # injection), so in-flight journeys finish without a worker
            with span("serve.host_wait"):
                out = self.executor.execute_sync(
                    next(self._job_ids), emit_layer, cohort.request_ids,
                    qkv.q, qkv.k, qkv.v, positions, rows=idx)
            buf = np.zeros(tuple(cohort.attn_in.shape), np.float32)
            buf[idx] = out
            cohort.attn_in = to_device(buf, self.device)
            self.executor.recycle(out)
            # keep the compute-time watermark current so the next async
            # consume is not charged for this work
            self._host_compute_seen = self.executor.compute_time
        toks = self._commit_device(logits, active_rows)
        cohort.x_carry = x_final[bg:]
        if completes:
            for i in valid:
                r = self.lc.host_requests[cohort.slot_rids[i]]
                r.output.append(int(toks[bg + i]))
                self.stats.host_tokens += 1
                cohort.positions[i] += 1
            idx = np.asarray(valid, np.int64)
            emb = self.params.embedding["embed"]
            cohort.x_carry[to_device(idx, self.device)] = emb[
                to_device(toks[bg + idx], self.device)].to(
                    cohort.x_carry.dtype)
            self.executor.advance_token(cohort.request_ids)
            cohort.attn_in = torch.zeros_like(cohort.attn_in)
        for rid in cohort.request_ids:
            self.lc.host_requests[rid].layer_progress = \
                ctl.layer_progress(cohort)
        ctl.advance(cohort)
        if plan is not None:
            self._finish_chunks(plan, clogits)

    # --- driver -------------------------------------------------------------
    def run(self, requests: List[Request], *, max_iterations: int = 100000
            ) -> EngineStats:
        for r in requests:
            self.submit(r)
        it = 0
        while self.has_work and it < max_iterations:
            self.step()
            it += 1
        self.sync_host_stats()
        return self.stats

    def sync_host_stats(self) -> None:
        """Copy the host tier's busy split, the pool's byte accounting at
        its stored dtype and the cold-page counters onto the stats."""
        if self.executor is None:
            return
        self.stats.host_busy_time = self.executor.busy_time
        self.stats.host_transfer_time = self.executor.transfer_time
        pool = self.executor.pool
        b = pool.byte_stats()
        self.stats.host_pool_hot_bytes = b["hot"]
        self.stats.host_pool_compressed_bytes = b["compressed"]
        self.stats.host_pool_free_bytes = b["free"]
        self.stats.host_kv_dtype_bytes = pool.kv_dtype_bytes
        self.stats.host_pages_compressed = pool.pages_compressed
        self.stats.host_pages_decompressed = pool.pages_decompressed
        self.stats.host_compressed_ratio_ewma = pool.compressed_ratio_ewma

    def shutdown(self) -> None:
        if self.executor is not None:
            self.executor.shutdown()
