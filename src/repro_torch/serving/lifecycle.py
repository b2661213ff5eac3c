"""Request lifecycle: engine config and stats, the admission queue, and
the registries of which request is where.

  * the per-request **state machine** (``transition`` enforces edges):
    QUEUED -> PREFILL -> DECODE_DEVICE | DECODE_HOST -> FINISHED;
  * ``AdmissionQueue`` -- higher ``Request.priority`` first, earliest
    deadline next (EDF within a priority class), then arrival order;
  * ``RequestLifecycle`` -- device slots, host residents, admission
    (rule 1, GPU-first, through the shared ``AdmissionController``
    budgets), retirement and latency accounting.

Port of ``repro/serving/lifecycle.py`` without deadlines backpressure,
tier rebalancing, preemption and chunked-prefill staging.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.scheduler import AdmissionController, Decision
from repro_torch.serving.request import Phase, Request


def pow2_ceil(n: int) -> int:
    """Smallest power of two >= n -- the bucket rule for prefill lengths
    and batch sizes."""
    return 1 << max(n - 1, 0).bit_length()


@dataclasses.dataclass
class EngineConfig:
    device_slots: int = 8
    host_slots: int = 8
    cache_len: int = 256
    page_size: int = 32
    host_pool_pages: int = 512
    max_queue: int = 1024
    # host-tier worker threads sharding each host-attention job's cohort
    # rows (0 = auto: cpu_count - 1, leaving a core for the device thread)
    host_workers: int = 0
    enable_offload: bool = True
    # Algorithm-1 scheduling: the perf-model spec ("analytic" |
    # "analytic:<platform>"), the platform backing "analytic", and the
    # §4.2 knobs passed to ApexScheduler
    perf_model: str = "analytic"
    platform: str = "h100"
    host_min_ratio: float = 0.0
    max_pipeline_sub_batch: int = 256
    # where the model and the device KV cache live; "cuda" needs a card
    device: str = "cuda"


LEGAL_TRANSITIONS: Dict[Phase, Tuple[Phase, ...]] = {
    Phase.QUEUED: (Phase.PREFILL, Phase.FINISHED),
    Phase.PREFILL: (Phase.DECODE_DEVICE, Phase.DECODE_HOST, Phase.FINISHED),
    Phase.DECODE_DEVICE: (Phase.FINISHED,),
    Phase.DECODE_HOST: (Phase.FINISHED,),
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
    # per-tier occupancy: slot-iterations accumulated each iteration
    device_slot_iterations: int = 0
    host_slot_iterations: int = 0
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

    @property
    def prediction_error(self) -> Optional[float]:
        """Aggregate |predicted - observed| / observed over decided
        iterations (None until the first decision lands)."""
        if self.observed_time <= 0.0:
            return None
        return abs(self.predicted_time - self.observed_time) \
            / self.observed_time


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

    def __len__(self) -> int:
        return len(self._q)

    def __bool__(self) -> bool:
        return bool(self._q)

    def __iter__(self):
        self._sort()
        return iter(list(self._q))


class RequestLifecycle:
    """Owns the request registries and the admission/retirement
    decisions; the Engine executes (prefill, KV moves, device steps)."""

    def __init__(self, e: EngineConfig, *, stats: EngineStats,
                 admission: AdmissionController) -> None:
        self.e = e
        self.stats = stats
        self.admission = admission
        self.queue = AdmissionQueue()
        self.slots: List[Optional[Request]] = [None] * e.device_slots
        self.host_requests: Dict[int, Request] = {}
        self.host_slot_owner: Dict[int, int] = {}    # host slot -> request_id

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
        """Host residents actually decoding (retiring ones excluded)."""
        return [r for r in self.host_requests.values()
                if not r.done and r.phase is Phase.DECODE_HOST]

    def schedule_snapshots(self, admitted: List[Request],
                           active_rows: List[int]
                           ) -> Tuple[List[Request], List[Request],
                                      List[Request]]:
        """Algorithm 1's queue snapshots: (prefill_q, decode_gpu,
        decode_cpu).  Device requests admitted this iteration are the
        prefill queue, not decodes; host requests stay in decode_cpu even
        when just admitted (their cohort decode runs in this same step)."""
        new_ids = {r.request_id for r in admitted}
        decode_gpu = [r for r in (self.slots[i] for i in active_rows)
                      if r.request_id not in new_ids]
        return admitted, decode_gpu, self.decoding_hosts()

    def admit(self, *, pool: Any,
              prompt_reject_reason: Callable[[int, int], Optional[str]],
              ) -> List[Tuple[Request, str, int]]:
        """Pop the queue into tier placements until the first request that
        cannot be placed.  Returns (req, tier, slot) with slots, budgets
        and pool chains already reserved; the engine prefills them."""
        placements: List[Tuple[Request, str, int]] = []
        while self.queue:
            req = self.queue.peek()
            reason = prompt_reject_reason(req.prompt_len, self.e.cache_len)
            if reason is not None:
                reject(self.queue.pop(), reason)
                continue
            if req.prompt_len + req.max_new_tokens >= self.e.cache_len:
                req.max_new_tokens = self.e.cache_len - req.prompt_len - 1
            need = req.kv_demand()
            slot = self.free_slot()
            hslot = self.free_host_slot() if self.e.enable_offload else None
            tier = self.admission.place(
                need, device_ok=slot is not None,
                host_ok=(hslot is not None and pool is not None
                         and pool.can_admit(need)))
            if tier is None:
                break
            req = self.queue.pop()
            req.tier = tier
            req.kv_reserved = need
            if tier == "device":
                self.slots[slot] = req          # reserve before prefill
                req.slot = slot
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
            placements.append((req, "host", hslot))
        return placements

    def note_iteration(self) -> None:
        self.stats.device_slot_iterations += sum(
            r is not None for r in self.slots)
        self.stats.host_slot_iterations += len(self.host_requests)

    def _latency_sample(self, r: Request) -> None:
        if r.arrival_time is None or r.first_token_time is None:
            return
        ttft = r.first_token_time - r.arrival_time
        self.stats.ttft_samples.append(ttft)
        if r.finish_time is not None and len(r.output) > 1:
            self.stats.itl_samples.append(
                (r.finish_time - r.first_token_time) / (len(r.output) - 1))

    def retire(self, *, free_host: Callable[[int], None]) -> None:
        """Finish done requests on both tiers: release budgets and slots,
        sample latencies."""
        now = time.perf_counter()
        for i, r in enumerate(self.slots):
            if r is not None and r.done:
                transition(r, Phase.FINISHED)
                r.finish_time = now
                self.admission.release("device", r.kv_reserved)
                self.slots[i] = None
                self._latency_sample(r)
        for rid in [rid for rid, r in self.host_requests.items() if r.done]:
            r = self.host_requests.pop(rid)
            transition(r, Phase.FINISHED)
            r.finish_time = now
            self.admission.release("host", r.kv_reserved)
            free_host(rid)
            self.host_slot_owner.pop(r.slot, None)
            self._latency_sample(r)
