"""Online serving engine -- execution orchestrator of the APEX design.

The engine owns execution: the model steps on the card, the
Asynchronous Overlap runtime (``OverlapController`` + ``HostExecutor``),
KV movement to the host tier at admission, and the per-iteration
dispatch of Algorithm 1's ``Decision``:

  * ``GPU_ONLY``       -- device-only decode (no host-designated rows);
  * ``ASYNC_OVERLAP``  -- deferred sync: the previous iteration's host job
    is *polled*; late host rows ride along (the §3.4 re-check);
  * ``ASYM_PIPELINE``  -- host attention is *waited for* between two
    consecutive device steps, so every cycle advances the cohort.

``RequestLifecycle`` decides which request is where; prefill is the
bucketed whole-prompt path (``prefill_exec``).  Each iteration has one
device->host sync, the logits readback in ``_commit_device``: tokens,
masks and host-row scalars go up through pinned memory without waiting,
and the host job's Q/K/V are copied down by the executor's worker.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.overlap_engine import (Cohort, HostExecutor,
                                             OverlapController, to_device)
from repro_torch.core.perf_model import OnlineCalibrator, resolve_perf_model
from repro_torch.core.scheduler import (AdmissionController, ApexScheduler,
                                        Decision, StrategyKind)
from repro_torch.models import (ModelParams, decode_step, init_decode_state,
                                prefill_bucketed)
from repro_torch.models.config import ModelConfig
from repro_torch.models.kv_cache import PagedKVPool, StackState
from repro_torch.models.transformer import HostIO
from repro_torch.serving.lifecycle import (EngineConfig, EngineStats,
                                           RequestLifecycle, reject)
from repro_torch.serving.prefill_exec import prefill_batched
from repro_torch.serving.request import Phase, Request
from repro_torch.serving.sampler import sample

__all__ = ["Engine", "EngineConfig", "EngineStats", "resolve_device"]


def resolve_device(device) -> torch.device:
    """The torch device an entry point runs on; a CUDA device without a
    card raises (there is no silent fall back to the CPU)."""
    d = torch.device(device)
    if d.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return d


class Engine:
    def __init__(self, cfg: ModelConfig, params: ModelParams,
                 ecfg: Optional[EngineConfig] = None,
                 scheduler: Optional[ApexScheduler] = None) -> None:
        self.cfg = cfg
        self.params = params
        self.e = ecfg or EngineConfig()
        self.device = resolve_device(self.e.device)
        emb = params.embedding["embed"]
        if emb.device.type != self.device.type:
            raise ValueError(f"params live on {emb.device}, the engine is "
                             f"configured for {self.device}")
        if not cfg.has_kv_cache:
            self.e.enable_offload = False   # APEX inapplicable
        # recurrent (Mamba) state also spans the host rows
        self.state = init_decode_state(
            cfg, device_batch=self.e.device_slots,
            host_batch=self.e.host_slots if self.e.enable_offload else 0,
            cache_len=self.e.cache_len, device=self.device)
        self.stats = EngineStats()
        self.scheduler = scheduler
        self._calibrator: Optional[OnlineCalibrator] = None
        if self.scheduler is None:
            self._calibrator = OnlineCalibrator(resolve_perf_model(
                self.e.perf_model, cfg, platform=self.e.platform))
            self.stats.perf_model_spec = self.e.perf_model
            self.scheduler = ApexScheduler(
                self._calibrator, host_min_ratio=self.e.host_min_ratio,
                max_pipeline_sub_batch=self.e.max_pipeline_sub_batch)
        # KV budgets from slot and pool capacity
        self.admission = AdmissionController(
            device_kv_budget_tokens=self.e.device_slots * self.e.cache_len,
            host_kv_budget_tokens=(self.e.host_pool_pages * self.e.page_size
                                   if self.e.enable_offload else 0))
        self.lc = RequestLifecycle(self.e, stats=self.stats,
                                   admission=self.admission)
        self._prefill_shapes: set = set()
        self._idle_io: Optional[HostIO] = None
        self._overlap: Optional[OverlapController] = None
        self.executor: Optional[HostExecutor] = None
        if self.e.enable_offload:
            self._overlap = OverlapController(cfg)
            pool = PagedKVPool(self.e.host_pool_pages, self.e.page_size,
                               cfg.num_attn_layers, cfg.num_kv_heads,
                               cfg.resolved_head_dim)
            self.executor = HostExecutor(cfg, pool,
                                         workers=self.e.host_workers)
            self.stats.host_workers = self.executor.workers
            self._cohort: Optional[Cohort] = None
            self._pending_job: Optional[int] = None
            self._pending_host_pred = 0.0   # predicted time of pending job
            self._host_compute_seen = 0.0   # executor compute_time watermark
            self._job_ids = iter(range(1, 1 << 30))

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
        placements = self.lc.admit(
            pool=self.executor.pool if self.executor is not None else None,
            prompt_reject_reason=self.prompt_reject_reason)
        if placements:
            prefill_batched(self, placements)
            self.stats.prefill_compilations = len(self._prefill_shapes)
        return [p[0] for p in placements]

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
        prefill_q, decode_gpu, decode_cpu = self.lc.schedule_snapshots(
            admitted, active_rows)
        if not (prefill_q or decode_gpu or decode_cpu):
            return None                      # idle iteration
        contexts = [r.total_len for r in decode_gpu + decode_cpu]
        mean_context = float(np.mean(contexts)) if contexts else 1.0
        decision = self.scheduler.schedule(
            prefill_q, decode_gpu, decode_cpu,
            mean_context=max(mean_context, 1.0),
            prefill_tokens=sum(r.prompt_len for r in admitted))
        self.stats.record_decision(decision)
        return decision

    # --- one engine iteration ------------------------------------------------
    def step(self) -> None:
        t0 = time.perf_counter()
        admitted = self._admit()
        # rows whose request already reached max_new_tokens straight out
        # of prefill do not ride this iteration's decode batch
        active_rows = [i for i, r in enumerate(self.lc.slots)
                       if r is not None and not r.done
                       and r.phase is Phase.DECODE_DEVICE]
        decision = self._schedule(admitted, active_rows)
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
        if cohort is not None:
            wait = (decision is not None
                    and decision.strategy == StrategyKind.ASYM_PIPELINE)
            self._step_overlap(to_device(tokens, self.device), cohort,
                               active_rows, wait=wait)
        elif active_rows:
            logits, self.state, _, _ = decode_step(
                self.params, self.cfg, to_device(tokens, self.device),
                self.state, self._idle_host_io())
            self._commit_device(logits, active_rows)
        self.stats.iterations += 1
        self.lc.note_iteration()
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
        self.lc.retire(free_host=(self.executor.free
                                  if self.executor is not None
                                  else lambda rid: None))

    def _idle_host_io(self) -> Optional[HostIO]:
        """The step's ``HostIO`` when no cohort is live: None, except for a
        hybrid with offload, whose recurrent state spans the host rows --
        it decodes through the unified step with every host row idle (no
        emit, no consume, an empty commit window).  Built once."""
        if self.executor is None or not self.cfg.has_recurrent:
            return None
        if self._idle_io is None:
            bc = self.e.host_slots
            emb = self.params.embedding["embed"]
            self._idle_io = HostIO(
                x_carry=torch.zeros((bc, self.cfg.d_model), dtype=emb.dtype,
                                    device=self.device),
                positions=torch.zeros((bc,), dtype=torch.int32,
                                      device=self.device),
                attn_in=torch.zeros((bc, self.cfg.num_heads,
                                     self.cfg.resolved_head_dim),
                                    dtype=torch.float32, device=self.device),
                consume_layer=-1, emit_layer=-1, window_start=0,
                window_end=0,
                row_valid=torch.zeros((bc,), dtype=torch.bool,
                                      device=self.device))
        return self._idle_io

    def _commit_device(self, logits: torch.Tensor,
                       active_rows: List[int]) -> np.ndarray:
        """Greedy tokens of every row, read back once -- the iteration's
        one sync; device rows append theirs."""
        toks = sample(logits).cpu().numpy()
        now = time.perf_counter()
        for i in active_rows:
            r = self.lc.slots[i]
            r.output.append(int(toks[i]))
            self.stats.device_tokens += 1
            if r.first_token_time is None:
                r.first_token_time = now
        return toks

    def _step_overlap(self, tokens: torch.Tensor, cohort: Cohort,
                      active_rows: List[int], *, wait: bool = False) -> None:
        """One hybrid iteration (paper §3.3).

        ``wait=False`` -- Asynchronous Overlap: poll the pending host
        job; if late, host rows ride along untouched.  ``wait=True`` --
        Asymmetric Pipelining: block until the host result is ready.
        The host job is submitted with the device Q/K/V straight from the
        step plus a CUDA event recorded after it; the worker copies them.
        """
        ctl = self._overlap
        valid = cohort.valid_slots
        bg = self.e.device_slots
        if self._pending_job is not None:
            if wait:
                out = self.executor.result(self._pending_job, timeout=120.0)
            else:
                out = self.executor.poll(self._pending_job)
            if out is None:
                host_idle = ctl.host_io(cohort)._replace(
                    consume_layer=-1, emit_layer=-1, window_start=0,
                    window_end=0)
                logits, self.state, _, _ = decode_step(
                    self.params, self.cfg, tokens, self.state, host_idle)
                self._commit_device(logits, active_rows)
                return
            buf = np.zeros(tuple(cohort.attn_in.shape), np.float32)
            buf[np.asarray(valid, np.int64)] = out
            cohort.attn_in = to_device(buf, self.device)
            self.executor.recycle(out)
            self._pending_job = None
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
        logits, self.state, qkv, x_final = decode_step(
            self.params, self.cfg, tokens, self.state, io)
        if emit_layer >= 0:
            ready = None
            if self.device.type == "cuda":
                ready = torch.cuda.Event()
                ready.record()
            # submit BEFORE the logits sync: the worker copies Q/K/V and
            # computes while the engine waits on the device logits
            job = next(self._job_ids)
            idx = np.asarray(valid, np.int64)
            positions = cohort.positions[idx]
            self.executor.submit(job, emit_layer, cohort.request_ids,
                                 qkv.q, qkv.k, qkv.v, positions, rows=idx,
                                 ready=ready)
            self._pending_job = job
            if self._calibrator is not None:
                self._pending_host_pred = self._calibrator.t_catt(
                    len(valid), float(np.mean(positions + 1)), layers=1)
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
        if self.executor is not None:
            self.stats.host_busy_time = self.executor.busy_time
            self.stats.host_transfer_time = self.executor.transfer_time

    def shutdown(self) -> None:
        if self.executor is not None:
            self.executor.shutdown()
