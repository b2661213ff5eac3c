"""Request lifecycle: engine config and stats, the admission queue, the
tier placer, and the registries of which request is where.

  * the per-request **state machine** (``transition`` enforces edges)

        QUEUED -> PREFILL -> DECODE_DEVICE -+-> FINISHED
                     |           | (preempt) +-> PREEMPTED -> DECODE_HOST
                     |           +-> RECOMPUTE -> PREFILL (re-queued)
                     +-> DECODE_HOST -+-> FINISHED
                                      +-> MIGRATING -> DECODE_DEVICE

    (a mid-prefill retarget passes through MIGRATING back to PREFILL);
  * ``AdmissionQueue`` -- higher ``Request.priority`` first, earliest
    deadline next (EDF within a priority class), then arrival order;
  * ``TierPlacer`` -- where a new request goes (rule 1, GPU-first),
    whether a host resident should move into a freed device slot (the
    drain-time predicate of ``core.placement``), which device resident
    to demote for an urgent admission, swap against recompute, and
    deadline backpressure, all over the calibrated perf model;
  * ``RequestLifecycle`` -- device slots, host residents and in-flight
    chunked prefills (staging rows), admission, chunk planning, the
    bookkeeping of tier moves, retirement and latency/SLO accounting.
    It decides; the engine executes through narrow callbacks.

Port of ``repro/serving/lifecycle.py``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import placement
from repro_torch.core.scheduler import AdmissionController, Decision
from repro_torch.serving.request import Phase, Request


def pow2_ceil(n: int) -> int:
    """Smallest power of two >= n -- the bucket rule for prefill lengths,
    batch sizes and the chunk width."""
    return 1 << max(n - 1, 0).bit_length()


@dataclasses.dataclass
class EngineConfig:
    device_slots: int = 8
    host_slots: int = 8
    cache_len: int = 256
    page_size: int = 32
    host_pool_pages: int = 512
    max_queue: int = 1024
    # sampling temperature passed to ``sample``; the engine holds no
    # generator, so decoding is greedy whatever the value, as in the
    # reference (ROADMAP queue 3)
    temperature: float = 0.0
    # host-tier worker threads sharding each host-attention job's cohort
    # rows (0 = auto: cpu_count - 1, leaving a core for the device thread)
    host_workers: int = 0
    # bucketed prefill: prompt lengths padded to powers of two and
    # same-bucket admissions prefilled in one call; False prefills each
    # prompt alone at its own length (and turns chunking and the prefix
    # cache off, which ride on bucketing)
    bucketed_prefill: bool = True
    # chunked prefill co-scheduled with decode: prompts advance in
    # token-budgeted chunks inside the continuous-batching loop, each
    # iteration running the decode batch and one chunk over the staging
    # rows; 0 = whole-prompt bucketed prefill before decode
    chunk_tokens: int = 64
    enable_offload: bool = True
    # host->device rebalancing: when a device slot frees and the
    # drain-time predicate says the move pays off, promote a host
    # resident (or retarget a mid-prefill host admission) into it
    tier_rebalance: bool = True
    # SLO-aware preemptive admission: an urgent request (higher
    # priority) may demote a strictly lower-priority device resident
    preemption: bool = True
    # cross-request prefix cache: retired prompts publish their K/V,
    # admissions matching a cached prefix prefill only the suffix; rides
    # the chunked path (chunk_tokens 0 disables it too)
    prefix_cache: bool = True
    # device-resident cache rows (a state of their own); 0 keeps the
    # cache in the paged host pool only
    prefix_cache_slots: int = 2
    # Algorithm-1 scheduling: the perf-model spec resolved by
    # PerfModelProvider ("analytic" | "analytic:<platform>" | "measured"
    # | "file:<path>"), the profile cache and grid of "measured", the
    # platform backing the analytic specs, and the §4.2 knobs passed to
    # ApexScheduler; use_scheduler=False runs without Algorithm 1
    perf_model: str = "analytic"
    profile_cache: Optional[str] = None
    profile_grid: Optional[Dict[str, tuple]] = None
    platform: str = "h100"
    host_min_ratio: float = 0.0
    max_pipeline_sub_batch: int = 256
    use_scheduler: bool = True
    # KV-budget overrides for the AdmissionController; None derives them
    # from slot and pool capacity (tighter values model a smaller card)
    device_kv_budget_tokens: Optional[int] = None
    host_kv_budget_tokens: Optional[int] = None
    # --- fault tolerance ----------------------------------------------
    # deterministic fault injection (serving.faults): a FaultPlan or its
    # parse string ("host_stall@3x2:0.5,..."); None = no injection
    fault_plan: Optional[Any] = None
    # host-job watchdog: a submitted host job must land within
    # max(calibrated t_catt prediction * host_job_slack,
    # host_job_min_timeout) seconds of its submit, or the engine abandons
    # it and recomputes the cohort's attention on its own thread
    host_job_slack: float = 8.0
    host_job_min_timeout: float = 0.25
    # master switch of both recompute escape hatches: the watchdog's
    # fallback above, and recompute-from-scratch preemption when a swap
    # has no host capacity (or is priced dearer).  False: host faults
    # fail the engine, blocked swaps requeue the urgent request
    recompute_fallback: bool = True
    # host-tier circuit breaker: this many consecutive fallbacks pin the
    # engine to the device (no host jobs, placements or demotions) for a
    # cooldown that doubles per trip and resets after a healthy host job
    host_breaker_threshold: int = 3
    host_breaker_cooldown: float = 1.0
    # sliding window (seconds) of the degradation-ladder level
    degradation_window: float = 5.0
    # --- host-KV precision and cold-page compression ------------------
    # stored dtype of the paged host pool: "fp32" (exact) or "int8"
    # (symmetric per-token quantization with fp32 scales: ~4x the
    # resident tokens per byte of host memory, cheaper tier moves, and
    # the perf model prices t_catt / t_migrate at the stored size); int8
    # logits drift within the reference's bounded-drift envelope
    host_kv_dtype: str = "fp32"
    # seconds a host-pool owner may sit untouched before its pages are
    # compressed losslessly in place (rehydrated on the next touch; the
    # reclaim also compresses evictable owners' pages before evicting
    # them); 0 disables compression
    cold_page_compress_after: float = 0.0
    # where the model and the device KV cache live; "cuda" needs a card
    device: str = "cuda"


LEGAL_TRANSITIONS: Dict[Phase, Tuple[Phase, ...]] = {
    Phase.QUEUED: (Phase.PREFILL, Phase.FINISHED),
    Phase.PREFILL: (Phase.DECODE_DEVICE, Phase.DECODE_HOST,
                    Phase.MIGRATING, Phase.FINISHED),
    Phase.DECODE_DEVICE: (Phase.PREEMPTED, Phase.RECOMPUTE, Phase.FINISHED),
    Phase.DECODE_HOST: (Phase.MIGRATING, Phase.FINISHED),
    Phase.MIGRATING: (Phase.DECODE_DEVICE, Phase.PREFILL),
    Phase.PREEMPTED: (Phase.DECODE_HOST,),
    # a recompute-preempted victim waits in the queue and re-prefills
    Phase.RECOMPUTE: (Phase.PREFILL, Phase.FINISHED),
    Phase.FINISHED: (),
}


def transition(req: Request, to: Phase) -> None:
    """Move a request along a legal state-machine edge (raises on an
    illegal one -- a lifecycle bug, not a recoverable condition)."""
    if to not in LEGAL_TRANSITIONS[req.phase]:
        raise RuntimeError(
            f"illegal lifecycle transition {req.phase.value} -> {to.value} "
            f"for request {req.request_id}")
    req.phase = to


def reject(req: Request, reason: str) -> None:
    """Fail a request without admitting it: FINISHED with ``error`` set."""
    req.error = reason
    transition(req, Phase.FINISHED)
    req.finish_time = time.perf_counter()


@dataclasses.dataclass
class EngineStats:
    """Serving counters.  ``prefill_compilations`` counts the distinct
    (bucket_len, batch_bucket) prefill shapes run: the reference counts
    jit traces, one per such shape; eager PyTorch traces nothing, so the
    port counts the shapes themselves."""

    device_tokens: int = 0
    host_tokens: int = 0
    iterations: int = 0
    wall_time: float = 0.0
    # resolved host-tier worker count (0 when offload is off)
    host_workers: int = 0
    # host-executor busy split: compute (KV append + paged attention) vs
    # device->host QKV transfer; busy = compute + transfer
    host_busy_time: float = 0.0
    host_transfer_time: float = 0.0
    prefill_compilations: int = 0
    # seconds the engine thread spent in the host tier's result calls
    # (blocking under ASYM_PIPELINE, a poll under ASYNC_OVERLAP)
    host_wait_time: float = 0.0
    # chunked prefill: chunks run, prompt tokens prefilled through them,
    # and iterations where a chunk ran beside decode
    prefill_chunks: int = 0
    chunked_prefill_tokens: int = 0
    chunk_co_run_iterations: int = 0
    # tier moves: host->device promotions (mid-prefill retargets
    # included) and device->host demotions
    migrations: int = 0
    preemptions: int = 0
    # urgent requests that found a lower-priority victim but no room to
    # demote it and stayed queued (once per request), and victims
    # recompute-preempted (K/V dropped, replayed through the queue)
    preemption_requeues: int = 0
    preemption_recomputes: int = 0
    # TTFT SLO outcomes: first tokens past arrival + deadline, and
    # requests rejected at admission as already impossible
    deadline_misses: int = 0
    deadline_rejections: int = 0
    # prefix cache: lookups, hits (split by the tier of the entry that
    # served them) and prompt tokens served from the cache; evictions
    # count entries leaving the index, demotions device->pool moves; the
    # byte gauges track resident cached K/V per tier
    prefix_lookups: int = 0
    prefix_hits: int = 0
    prefix_device_hits: int = 0
    prefix_host_hits: int = 0
    prefix_hit_tokens: int = 0
    prefix_evictions: int = 0
    prefix_demotions: int = 0
    prefix_device_bytes: int = 0
    prefix_host_bytes: int = 0
    # host-tier fault tolerance: host jobs abandoned by the watchdog
    # (deadline or worker exception) and recomputed on the engine thread,
    # breaker trips, and requests aborted by Engine.cancel
    host_fallbacks: int = 0
    host_breaker_trips: int = 0
    cancelled: int = 0
    # host-pool byte accounting at the stored dtype (hot = occupied
    # physical pages, compressed = cold blobs, free = unoccupied pages),
    # stored bytes per KV element (1 = int8, 4 = fp32), and cold-page
    # compression activity (counters, and the codec's compressed/raw
    # ratio EWMA, None until the first compression); the engine copies
    # them from the pool when its stats are read
    host_pool_hot_bytes: int = 0
    host_pool_compressed_bytes: int = 0
    host_pool_free_bytes: int = 0
    host_kv_dtype_bytes: int = 0
    host_pages_compressed: int = 0
    host_pages_decompressed: int = 0
    host_compressed_ratio_ewma: Optional[float] = None
    # per-tier occupancy: slot-iterations accumulated each iteration
    device_slot_iterations: int = 0
    host_slot_iterations: int = 0
    # device K/V occupancy summed each iteration over the decode slots,
    # staging rows and prefix rows: positions holding tokens, and the
    # rows' reserved positions (rows x cache_len)
    kv_used_tokens: int = 0
    kv_reserved_tokens: int = 0
    # ASYNC_OVERLAP / ASYM_PIPELINE: tries to take the pending host job,
    # and tries that found it unfinished (the host rows rode untouched)
    host_consumes: int = 0
    host_late_polls: int = 0
    # model steps run (decode steps and prefill chunks), and those served
    # by replaying their CUDA graphs (models.graphs)
    model_steps: int = 0
    graph_steps: int = 0
    # latency distributions over retired requests (seconds)
    ttft_samples: List[float] = dataclasses.field(default_factory=list)
    itl_samples: List[float] = dataclasses.field(default_factory=list)
    # per-iteration Algorithm-1 outcomes: StrategyKind.value -> count
    strategy_counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    last_decision: Optional[Decision] = None
    # scheduling accuracy: model-predicted vs measured step times
    perf_model_spec: str = ""
    predicted_time: float = 0.0
    observed_time: float = 0.0
    step_error_ewma: Optional[float] = None
    # last time (perf_counter) each rung of the degradation ladder
    # (``placement.DEGRADATION_LADDER``) fired
    pressure_marks: Dict[str, float] = dataclasses.field(default_factory=dict)
    # the engine copies EngineConfig.degradation_window in
    degradation_window: float = 5.0

    def note_pressure(self, rung: str) -> None:
        self.pressure_marks[rung] = time.perf_counter()

    def degradation(self, window: Optional[float] = None) -> str:
        """The most severe ladder rung that fired within ``window`` s
        (default: ``degradation_window``)."""
        w = self.degradation_window if window is None else window
        now = time.perf_counter()
        return placement.degradation_level(
            {rung: now - t <= w for rung, t in self.pressure_marks.items()})

    def record_decision(self, decision: Decision) -> None:
        key = decision.strategy.value
        self.strategy_counts[key] = self.strategy_counts.get(key, 0) + 1
        self.last_decision = decision

    @property
    def throughput(self) -> float:
        return (self.device_tokens + self.host_tokens) / max(self.wall_time,
                                                             1e-9)

    @property
    def device_occupancy(self) -> float:
        return self.device_slot_iterations / max(self.iterations, 1)

    @property
    def host_occupancy(self) -> float:
        return self.host_slot_iterations / max(self.iterations, 1)

    @staticmethod
    def _pct(samples: List[float], q: float) -> Optional[float]:
        if not samples:
            return None
        return float(np.percentile(np.asarray(samples, float), q))

    @property
    def ttft_p50(self) -> Optional[float]:
        return self._pct(self.ttft_samples, 50)

    @property
    def ttft_p95(self) -> Optional[float]:
        return self._pct(self.ttft_samples, 95)

    @property
    def itl_p50(self) -> Optional[float]:
        return self._pct(self.itl_samples, 50)

    @property
    def itl_p95(self) -> Optional[float]:
        return self._pct(self.itl_samples, 95)

    def snapshot(self) -> Dict[str, Optional[float]]:
        """Flat metric name -> value view of the serving counters (the
        surface the reference's gateway exports); None marks a
        distribution without samples."""
        return {
            "iterations": float(self.iterations),
            "device_tokens": float(self.device_tokens),
            "host_tokens": float(self.host_tokens),
            "wall_time_seconds": self.wall_time,
            "decode_iters_per_s": self.iterations / max(self.wall_time,
                                                        1e-9),
            "tokens_per_s": self.throughput,
            "migrations": float(self.migrations),
            "preemptions": float(self.preemptions),
            "preemption_requeues": float(self.preemption_requeues),
            "preemption_recomputes": float(self.preemption_recomputes),
            "host_fallbacks": float(self.host_fallbacks),
            "host_breaker_trips": float(self.host_breaker_trips),
            "cancelled": float(self.cancelled),
            "degradation_level": float(
                placement.DEGRADATION_LADDER.index(self.degradation())),
            "deadline_misses": float(self.deadline_misses),
            "deadline_rejections": float(self.deadline_rejections),
            "device_occupancy": self.device_occupancy,
            "host_occupancy": self.host_occupancy,
            "kv_used_tokens": float(self.kv_used_tokens),
            "kv_reserved_tokens": float(self.kv_reserved_tokens),
            "host_consumes": float(self.host_consumes),
            "host_late_polls": float(self.host_late_polls),
            "prefill_chunks": float(self.prefill_chunks),
            "prefix_lookups": float(self.prefix_lookups),
            "prefix_hits": float(self.prefix_hits),
            "prefix_hit_tokens": float(self.prefix_hit_tokens),
            "prefix_evictions": float(self.prefix_evictions),
            "prefix_demotions": float(self.prefix_demotions),
            "prefix_device_bytes": float(self.prefix_device_bytes),
            "prefix_host_bytes": float(self.prefix_host_bytes),
            "host_pool_hot_bytes": float(self.host_pool_hot_bytes),
            "host_pool_compressed_bytes": float(
                self.host_pool_compressed_bytes),
            "host_pool_free_bytes": float(self.host_pool_free_bytes),
            "host_kv_dtype_bytes": float(self.host_kv_dtype_bytes),
            "host_pages_compressed": float(self.host_pages_compressed),
            "host_pages_decompressed": float(self.host_pages_decompressed),
            "host_compressed_ratio_ewma": self.host_compressed_ratio_ewma,
            "ttft_p50_seconds": self.ttft_p50,
            "ttft_p95_seconds": self.ttft_p95,
            "itl_p50_seconds": self.itl_p50,
            "itl_p95_seconds": self.itl_p95,
        }

    @property
    def prediction_error(self) -> Optional[float]:
        """Aggregate |predicted - observed| / observed over decided
        iterations (None until the first decision lands)."""
        if self.observed_time <= 0.0:
            return None
        return abs(self.predicted_time - self.observed_time) \
            / self.observed_time


@dataclasses.dataclass
class InflightPrefill:
    """One admission advancing chunk by chunk through a staging row."""

    req: Request
    tier: str                        # "device" | "host"
    slot: int                        # device slot / host slot index
    consumed: int = 0                # prompt tokens already prefilled

    @property
    def remaining(self) -> int:
        return self.req.prompt_len - self.consumed


@dataclasses.dataclass
class ChunkPlan:
    """This iteration's chunk assignment over the staging rows."""

    rows: List[int]                  # staging rows advancing
    lens: List[int]                  # real tokens granted per row
    tokens: np.ndarray               # (P, C) right-padded chunk tokens
    clens: np.ndarray                # (P,) per-row chunk length (0 = idle)


class AdmissionQueue:
    """The waiting line, ordered by (priority desc, due time asc, arrival
    asc); ``push`` is O(1), ordering is applied lazily at ``pop``."""

    def __init__(self) -> None:
        self._q: List[Request] = []
        self._sorted = True

    @staticmethod
    def _key(r: Request):
        arrival = r.arrival_time if r.arrival_time is not None else 0.0
        due = arrival + r.deadline if r.deadline is not None \
            else float("inf")
        return (-r.priority, due, arrival, r.request_id)

    def push(self, req: Request) -> None:
        self._q.append(req)
        self._sorted = False

    def _sort(self) -> None:
        if not self._sorted:
            self._q.sort(key=self._key)
            self._sorted = True

    def peek(self) -> Optional[Request]:
        self._sort()
        return self._q[0] if self._q else None

    def pop(self) -> Request:
        self._sort()
        return self._q.pop(0)

    def remove(self, request_id: int) -> Optional[Request]:
        """Pull a specific request out of the line; None when it is not
        queued."""
        for i, r in enumerate(self._q):
            if r.request_id == request_id:
                return self._q.pop(i)
        return None

    def __len__(self) -> int:
        return len(self._q)

    def __bool__(self) -> bool:
        return bool(self._q)

    def __iter__(self):
        self._sort()
        return iter(list(self._q))

    def snapshot(self) -> List[Request]:
        """Point-in-time copy of the queued requests, unsorted: safe from
        a thread other than the engine's (a plain list copy never touches
        the ordering state)."""
        return list(self._q)


@dataclasses.dataclass
class TierPlacer:
    """Placement policy over the shared budgets and the calibrated perf
    model.  Pure decisions -- the engine executes the K/V moves.

    ``perf_model`` is the engine's ``OnlineCalibrator`` (or any object
    with ``timings``/``t_catt``/``t_migrate``/``t_prefill``/
    ``t_recompute``); None degrades to the structural rules.
    """

    admission: AdmissionController
    perf_model: Any = None
    iters_per_host_token: int = 1    # num_attn_layers + 1 under overlap
    # prompt -> cached-prefix length (0 = miss): the engine wires the
    # prefix cache's probe here, so deadline backpressure prices only
    # the uncached suffix
    cached_prefix_probe: Optional[Callable[[Sequence[int]], int]] = None

    def place(self, need_tokens: int, *, device_ok: bool,
              host_ok: bool) -> Optional[str]:
        return self.admission.place(need_tokens, device_ok=device_ok,
                                    host_ok=host_ok)

    def tier_token_times(self, *, device_batch: int, host_batch: int,
                         context: float
                         ) -> Tuple[Optional[float], Optional[float]]:
        """(device, host) seconds per token at the current operating
        point: one device token per iteration; one host token per
        ``iters_per_host_token`` iterations, each as wide as the slower
        of the device step and the cohort's one-layer host attention."""
        pm = self.perf_model
        if pm is None:
            return None, None
        t = pm.timings(max(device_batch, 1), max(context, 1.0))
        iter_time = t.t_glinear + t.t_gatt
        t_host_layer = pm.t_catt(max(host_batch, 1), max(context, 1.0),
                                 layers=1)
        return iter_time, self.iters_per_host_token * max(iter_time,
                                                          t_host_layer)

    def migration_cost(self, n_tokens: int) -> float:
        if self.perf_model is None:
            return 0.0
        return float(self.perf_model.t_migrate(n_tokens))

    def rebalance_candidate(self, candidates: List[Request], *,
                            waiting: int, device_slot_free: bool,
                            device_batch: int) -> Optional[Request]:
        """The host resident to promote into a freed device slot, or
        None (candidate choice and predicate from ``core.placement``)."""
        cand = placement.pick_rebalance_candidate(candidates)
        if cand is None:
            return None
        remaining = cand.max_new_tokens - cand.tokens_generated
        dev_s, host_s = self.tier_token_times(
            device_batch=device_batch, host_batch=len(candidates),
            context=float(cand.total_len))
        # a mid-prefill retarget moves no K/V (the staging row already
        # holds it on the device): only decoding residents pay transfer
        cost = (0.0 if cand.phase is Phase.PREFILL
                else self.migration_cost(cand.total_len))
        ok = placement.should_rebalance_to_device(
            waiting=waiting, device_slot_free=device_slot_free,
            device_kv_headroom=self.admission.headroom("device"),
            need_tokens=cand.kv_reserved, remaining_tokens=remaining,
            migration_cost=cost,
            device_s_per_token=dev_s, host_s_per_token=host_s)
        return cand if ok else None

    def preemption_victim(self, residents: List[Request], *,
                          urgent: Request, host_slot_free: bool,
                          pool_ok: Callable[[int], bool]
                          ) -> Optional[Request]:
        """The device resident to demote so ``urgent`` can take its
        slot, or None when a swap cannot help: no strictly lower-priority
        resident, no host slot or pool room for the victim, or the freed
        device budget still would not fit the urgent request."""
        if not host_slot_free:
            return None
        victim = placement.pick_preemption_victim(
            residents, urgent_priority=urgent.priority)
        if victim is None:
            return None
        if not pool_ok(victim.kv_demand()):
            return None
        if self.admission.headroom("host") < victim.kv_reserved:
            return None
        if self.admission.headroom("device") + victim.kv_reserved \
                < urgent.kv_demand():
            return None
        return victim

    def prefer_recompute(self, victim: Request) -> bool:
        """True when dropping a victim's K/V and replaying it is priced
        below moving it to the host tier (a feasible swap).  Without a
        perf model, swap (which keeps the work) wins."""
        pm = self.perf_model
        if pm is None:
            return False
        return placement.should_recompute_instead_of_swap(
            t_swap=self.migration_cost(victim.total_len),
            t_recompute=float(pm.t_recompute(victim.prompt_len,
                                             victim.tokens_generated)))

    def deadline_impossible(self, req: Request, *, now: float) -> bool:
        """True when the time already spent queued plus the predicted
        prefill of the uncached suffix exceeds the TTFT deadline;
        without a perf model, when the deadline has already passed."""
        if req.deadline is None:
            return False
        elapsed = (now - req.arrival_time
                   if req.arrival_time is not None else 0.0)
        predicted = 0.0
        if self.perf_model is not None:
            cached = (self.cached_prefix_probe(req.prompt)
                      if self.cached_prefix_probe is not None else 0)
            charge = placement.chargeable_prefill_tokens(req.prompt_len,
                                                         cached)
            if charge < req.prompt_len:
                predicted = float(self.perf_model.t_prefill_suffix(
                    charge, req.prompt_len))
            else:
                predicted = float(self.perf_model.t_prefill(
                    charge, req.prompt_len))
        return placement.deadline_impossible(
            elapsed=elapsed, deadline=req.deadline, predicted_ttft=predicted)


class RequestLifecycle:
    """Owns the request registries and every lifecycle decision; the
    engine executes (prefill, K/V moves, device steps).  ``admit`` takes
    the engine's ``demote(urgent) -> freed slot | None`` callback."""

    def __init__(self, e: EngineConfig, *, stats: EngineStats,
                 placer: TierPlacer) -> None:
        self.e = e
        self.stats = stats
        self.placer = placer
        self.admission = placer.admission
        self.queue = AdmissionQueue()
        self.slots: List[Optional[Request]] = [None] * e.device_slots
        self.host_requests: Dict[int, Request] = {}
        self.host_slot_owner: Dict[int, int] = {}    # host slot -> request_id
        # chunked-prefill staging registry (rows claimed by admissions)
        self.staging: List[Optional[InflightPrefill]] = []
        self.staging_order: List[int] = []           # rows in admission order
        # urgent requests already counted as a swap-to-queue fallback
        self._preempt_noted: set = set()

    def submit(self, req: Request) -> None:
        if req.arrival_time is None:
            req.arrival_time = time.perf_counter()
        req.phase = Phase.QUEUED
        self.queue.push(req)

    def free_slot(self) -> Optional[int]:
        for i, r in enumerate(self.slots):
            if r is None:
                return i
        return None

    def free_host_slot(self) -> Optional[int]:
        for i in range(self.e.host_slots):
            if i not in self.host_slot_owner:
                return i
        return None

    @property
    def has_work(self) -> bool:
        return bool(self.queue or any(r is not None for r in self.slots)
                    or self.host_requests)

    def decoding_hosts(self) -> List[Request]:
        """Host residents actually decoding (mid-prefill and retiring
        ones excluded): the decode_cpu snapshot and the rebalance pool."""
        return [r for r in self.host_requests.values()
                if not r.done and r.phase is Phase.DECODE_HOST]

    def schedule_snapshots(self, admitted: List[Request],
                           active_rows: List[int], *, chunked: bool
                           ) -> Tuple[List[Request], List[Request],
                                      List[Request], int]:
        """Algorithm 1's snapshots: (prefill_q, decode_gpu, decode_cpu,
        chunk backlog tokens).  Device requests admitted this iteration
        are the prefill queue, not decodes; host requests stay in
        decode_cpu even when just admitted (their cohort decode runs in
        this same step).  Chunked mode snapshots every in-flight prefill
        instead (the scheduler grants the chunk budget from the
        backlog)."""
        new_ids = {r.request_id for r in admitted}
        decode_gpu = [r for r in (self.slots[i] for i in active_rows)
                      if r.request_id not in new_ids]
        decode_cpu = self.decoding_hosts()
        if not chunked:
            return admitted, decode_gpu, decode_cpu, 0
        inflight = [self.staging[row] for row in self.staging_order]
        return ([e.req for e in inflight], decode_gpu, decode_cpu,
                sum(e.remaining for e in inflight))

    def admit(self, *, pool: Any,
              demote: Optional[Callable[[Request], Optional[int]]],
              prompt_reject_reason: Callable[[int, int], Optional[str]],
              ) -> List[Tuple[Request, str, int]]:
        """Pop the queue into tier placements until the first request
        that cannot be placed: rejections of degenerate prompts and of
        impossible deadlines first, then rule 1, then (for an urgent
        request with no device slot) preemption through ``demote``.
        Returns (req, tier, slot) with slots, budgets and pool chains
        already reserved; the engine prefills or stages them."""
        placements: List[Tuple[Request, str, int]] = []
        now = time.perf_counter()
        while self.queue:
            req = self.queue.peek()
            reason = prompt_reject_reason(req.prompt_len, self.e.cache_len)
            if reason is not None:
                reject(self.queue.pop(), reason)
                self._preempt_noted.discard(req.request_id)
                continue
            # a recompute-preempted victim has streamed tokens already:
            # the deadline gate applies to fresh admissions only
            if req.phase is not Phase.RECOMPUTE \
                    and self.placer.deadline_impossible(req, now=now):
                self.stats.deadline_rejections += 1
                self._preempt_noted.discard(req.request_id)
                reject(self.queue.pop(),
                       f"deadline {req.deadline:.3f}s impossible: queue "
                       f"wait + predicted prefill already exceeds it")
                continue
            if req.prompt_len + req.max_new_tokens >= self.e.cache_len:
                req.max_new_tokens = self.e.cache_len - req.prompt_len - 1
            need = req.kv_demand()
            slot = self.free_slot()
            hslot = self.free_host_slot() if self.e.enable_offload else None
            tier = self.placer.place(
                need, device_ok=slot is not None,
                host_ok=(hslot is not None and pool is not None
                         and pool.can_admit(need)))
            if tier is None and demote is not None and slot is None:
                slot = demote(req)
                if slot is not None:
                    tier = self.placer.place(need, device_ok=True,
                                             host_ok=False)
                elif any(r is not None and not r.done
                         and r.phase is Phase.DECODE_DEVICE
                         and r.priority < req.priority
                         for r in self.slots):
                    # swap-to-queue: a lower-priority victim exists but
                    # there is no room to demote it; the urgent request
                    # keeps its place at the head and retries
                    if req.request_id not in self._preempt_noted:
                        self._preempt_noted.add(req.request_id)
                        self.stats.preemption_requeues += 1
            if tier is None:
                break
            req = self.queue.pop()
            self._preempt_noted.discard(req.request_id)
            req.tier = tier
            req.kv_reserved = need
            if tier == "device":
                self.slots[slot] = req          # reserve before prefill
                req.slot = slot
                if req.admit_time is None:      # a re-admission keeps it
                    req.admit_time = now
                placements.append((req, "device", slot))
                continue
            try:
                pool.allocate(req.request_id, req.prompt_len)
            except MemoryError:
                # can_admit is advisory: undo the claim, retry later
                self.admission.release("host", need)
                req.tier = None
                req.kv_reserved = 0
                self.queue.push(req)
                break
            self.host_slot_owner[hslot] = req.request_id
            self.host_requests[req.request_id] = req
            req.slot = hslot
            if req.admit_time is None:
                req.admit_time = now
            placements.append((req, "host", hslot))
        return placements

    # --- chunked-prefill staging ----------------------------------------
    def stage(self, placements: List[Tuple[Request, str, int]]) -> List[int]:
        """Claim a staging row per admission: its prompt prefills there
        chunk by chunk.  Returns the claimed rows (recycled rows still
        hold the previous occupant's recurrent state)."""
        rows: List[int] = []
        for req, tier, s in placements:
            # chunk padding past the cache end lands on its last column
            # (transformer._attn_full): no real prompt token may sit there
            if req.prompt_len > self.e.cache_len - 2:
                raise RuntimeError(
                    f"request {req.request_id}: prompt of {req.prompt_len} "
                    f"tokens reaches the last cache column "
                    f"(cache_len={self.e.cache_len})")
            row = self.staging.index(None)
            transition(req, Phase.PREFILL)
            self.staging[row] = InflightPrefill(req=req, tier=tier, slot=s)
            self.staging_order.append(row)
            rows.append(row)
        return rows

    def staging_backlog(self) -> int:
        return sum(self.staging[r].remaining for r in self.staging_order)

    def plan_chunks(self, budget: int) -> Optional[ChunkPlan]:
        """Assign this iteration's chunk budget over in-flight prefills:
        priority classes first, admission (FIFO) order within a class,
        each grant capped at ``chunk_tokens``.  The token buffer is
        always (staging rows, ``pow2_ceil(chunk_tokens)``): the chunk's
        GEMMs run over B * C rows and cuBLAS picks its algorithm by that
        M, so one geometry for every chunk call keeps a token's K/V
        independent of how its prompt was chunked -- the prefix cache's
        warm == cold bar rests on it."""
        if budget <= 0:
            return None
        rows: List[int] = []
        lens: List[int] = []
        left = budget
        order = sorted(self.staging_order,        # stable: FIFO in a class
                       key=lambda row: -self.staging[row].req.priority)
        for row in order:
            if left <= 0:
                break
            c = min(self.staging[row].remaining, left, self.e.chunk_tokens)
            if c <= 0:
                continue
            rows.append(row)
            lens.append(c)
            left -= c
        if not rows:
            return None
        toks = np.zeros((len(self.staging), pow2_ceil(self.e.chunk_tokens)),
                        np.int64)
        clens = np.zeros((len(self.staging),), np.int32)
        for row, c in zip(rows, lens):
            ent = self.staging[row]
            toks[row, :c] = ent.req.prompt[ent.consumed:ent.consumed + c]
            clens[row] = c
        return ChunkPlan(rows=rows, lens=lens, tokens=toks, clens=clens)

    def release_staging_row(self, row: int) -> None:
        self.staging[row] = None
        self.staging_order.remove(row)

    # --- tier-move bookkeeping ------------------------------------------
    def note_migrated(self, req: Request, slot: int, *,
                      to_prefill: bool = False) -> None:
        """Registry flip for a host->device promotion the engine just
        executed (``to_prefill``: a mid-prefill retarget -- the request
        returns to PREFILL in its staging row)."""
        self.host_requests.pop(req.request_id, None)
        if req.slot is not None:
            self.host_slot_owner.pop(req.slot, None)
        self.admission.transfer("host", "device", req.kv_reserved)
        self.slots[slot] = req
        req.slot = slot
        req.tier = "device"
        transition(req, Phase.PREFILL if to_prefill else Phase.DECODE_DEVICE)
        self.stats.migrations += 1

    def note_preempted(self, victim: Request, hslot: int) -> None:
        """Registry flip for a device->host demotion."""
        self.slots[victim.slot] = None
        self.admission.transfer("device", "host", victim.kv_reserved)
        self.host_slot_owner[hslot] = victim.request_id
        self.host_requests[victim.request_id] = victim
        victim.slot = hslot
        victim.tier = "host"
        transition(victim, Phase.DECODE_HOST)
        self.stats.preemptions += 1
        self.stats.note_pressure("demote")

    def note_recomputed(self, victim: Request) -> None:
        """Registry flip for a recompute-from-scratch preemption: the
        victim loses its slot and budget and re-enters the queue on the
        RECOMPUTE edge.  ``output.clear()`` is in place on purpose:
        token streams hold the same list and forward only tokens past
        their high-water mark, so the deterministic replay regenerates
        the indices below it without the consumer seeing duplicates."""
        transition(victim, Phase.RECOMPUTE)
        self.slots[victim.slot] = None
        self.admission.release("device", victim.kv_reserved)
        victim.slot = None
        victim.tier = None
        victim.kv_reserved = 0
        victim.output.clear()
        victim.layer_progress = 0
        self.queue.push(victim)
        self.stats.preemption_recomputes += 1
        self.stats.note_pressure("recompute")

    # --- per-iteration accounting ---------------------------------------
    def note_iteration(self) -> None:
        self.stats.device_slot_iterations += sum(
            r is not None for r in self.slots)
        self.stats.host_slot_iterations += len(self.host_requests)

    def _latency_sample(self, r: Request) -> None:
        if r.arrival_time is None or r.first_token_time is None:
            return
        ttft = r.first_token_time - r.arrival_time
        self.stats.ttft_samples.append(ttft)
        if r.deadline is not None and ttft > r.deadline:
            self.stats.deadline_misses += 1
        if r.finish_time is not None and len(r.output) > 1:
            self.stats.itl_samples.append(
                (r.finish_time - r.first_token_time) / (len(r.output) - 1))

    def retire(self, *, free_host: Callable[[int], None],
               publish: Optional[Callable[[Request], bool]] = None) -> None:
        """Finish done requests on both tiers: release budgets and slots,
        sample latencies and SLO outcomes.  ``publish`` (the prefix
        cache's hook) sees each request while its K/V is still live; a
        True return means the cache adopted a host retiree's chains, so
        ``free_host`` is skipped."""
        now = time.perf_counter()
        for i, r in enumerate(self.slots):
            if r is not None and r.done:
                if publish is not None:
                    publish(r)
                transition(r, Phase.FINISHED)
                r.finish_time = now
                self.admission.release("device", r.kv_reserved)
                self.slots[i] = None
                self._latency_sample(r)
        for rid in [rid for rid, r in self.host_requests.items() if r.done]:
            r = self.host_requests.pop(rid)
            adopted = publish(r) if publish is not None else False
            transition(r, Phase.FINISHED)
            r.finish_time = now
            self.admission.release("host", r.kv_reserved)
            if not adopted:
                free_host(rid)
            self.host_slot_owner.pop(r.slot, None)
            self._latency_sample(r)
