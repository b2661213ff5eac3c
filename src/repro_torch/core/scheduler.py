"""APEX scheduling algorithm (paper Algorithm 1).

Four rules, verbatim from §3.4:

  1. **GPU-first** — the host tier is involved only when device memory
     cannot hold the KV cache of all admitted requests.
  2. **Decode-only optimization** — with no prefill present, evaluate
     Inequality (5)/(6); pick Asymmetric Pipelining iff it holds, else
     Asynchronous Overlap.
  3. **Mixed workload handling** — with prefill present, use the
     widened window N_Ctotal = N_C (T_glinear_pref + T_glinear +
     T_gatt_pref).
  4. **Partial-progress prioritization** — offloaded requests that
     already completed i layers are preferred into the CPU sub-batch
     (they cost only (L - i) * T_glinear more).

The scheduler is deliberately pure: it consumes queue snapshots +
profiled ``Timings`` and returns a ``Decision``; the serving engine
owns all state mutation.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Any, List, Optional, Sequence

from repro_torch.core import analytical
from repro_torch.core.analytical import Timings


class StrategyKind(str, enum.Enum):
    GPU_ONLY = "gpu_only"
    ASYM_PIPELINE = "asym_pipeline"
    ASYNC_OVERLAP = "async_overlap"


@dataclasses.dataclass
class Decision:
    strategy: StrategyKind
    prefill: List[Any]
    decode_gpu: List[Any]
    decode_cpu: List[Any]
    # Asymmetric Pipelining partition (paper Fig. 2): sub-batch 1 =
    # prefill + device decodes (+ host decodes that fit), sub-batch 2 =
    # host-only decodes.
    sub_batch_1: Optional[List[Any]] = None
    sub_batch_2: Optional[List[Any]] = None
    reason: str = ""
    # model-predicted critical-path time of this iteration (seconds);
    # the engine compares it against the measured wall time to drive
    # the OnlineCalibrator and the EngineStats accuracy metric
    predicted_time: float = 0.0
    # chunked-prefill plan: prefill tokens granted to this iteration's
    # fused chunk (0 = no chunk).  The mixed-branch timings above are
    # evaluated at exactly this share, not the whole prompt backlog.
    chunk_tokens: int = 0


def _progress(req: Any) -> int:
    """Layers already completed by an offloaded request (rule 4)."""
    return getattr(req, "layer_progress", 0)


@dataclasses.dataclass
class ApexScheduler:
    """Algorithm 1 over profiled timings.

    ``perf_model`` must expose ``timings(decode_batch, mean_context,
    prefill_tokens)`` (see repro_torch.core.perf_model).
    ``host_min_ratio`` is the §4.2 admission threshold: host cohorts
    smaller than ratio*device_batch don't amortize thread overheads.
    """

    perf_model: Any
    host_min_ratio: float = 0.0
    max_pipeline_sub_batch: int = 256

    def schedule(self, prefill: Sequence[Any], decode_gpu: Sequence[Any],
                 decode_cpu: Sequence[Any], *, mean_context: float,
                 prefill_tokens: int = 0, chunk_backlog_tokens: int = 0,
                 chunk_tokens_max: int = 0) -> Decision:
        prefill = list(prefill)
        decode_gpu = list(decode_gpu)
        decode_cpu = list(decode_cpu)

        batch = max(len(decode_gpu), 1)
        chunk = 0
        if chunk_tokens_max > 0 and chunk_backlog_tokens > 0:
            # Chunked prefill: this iteration's fused chunk budget IS
            # the mixed branch's prefill share — size it from the perf
            # model (below) and evaluate rule 3 at that share.  An
            # urgent prefill (elevated priority) takes the TTFT-first
            # cap instead of the host-window-minimal chunk: shaving
            # the chunk to the cohort's attention window would stretch
            # an SLO-bound prompt over backlog/chunk extra iterations.
            # A deadline alone does NOT trigger this — operators stamp
            # loose default SLOs on whole workloads, and disabling the
            # window sizing for all of them would silently cost the
            # overlap efficiency the chunk rule exists to protect.
            urgent = any(getattr(r, "priority", 0) > 0 for r in prefill)
            chunk = self.chunk_budget(
                len(decode_gpu), len(decode_cpu), mean_context,
                backlog=chunk_backlog_tokens, cap=chunk_tokens_max,
                urgent=urgent)
            prefill_tokens = chunk
        t = self.perf_model.timings(batch, mean_context,
                                    prefill_tokens=prefill_tokens)
        mixed = bool(prefill) and t.t_glinear_pref > 0.0

        # Rule 1 fallout: nothing designated for the host => GPU-only.
        if not decode_cpu:
            return Decision(StrategyKind.GPU_ONLY, prefill, decode_gpu, [],
                            reason="no host-offloaded requests",
                            predicted_time=self._aligned_time(t, mixed),
                            chunk_tokens=chunk)

        # §4.2 admission threshold: handle too-small cohorts GPU-aligned
        # (deferred synchronization; host rows never stall the device)
        # instead of evaluating the pipeline inequalities.
        if analytical.host_cohort_below_min_ratio(
                len(decode_cpu), len(decode_gpu), self.host_min_ratio):
            return Decision(
                StrategyKind.ASYNC_OVERLAP, prefill, decode_gpu, decode_cpu,
                reason=f"host cohort {len(decode_cpu)} < host_min_ratio "
                       f"{self.host_min_ratio:g} x batch {batch}",
                predicted_time=self._aligned_time(t, mixed),
                chunk_tokens=chunk)

        if not prefill:
            # Rule 2 — decode-only: Inequality (5).
            if analytical.pipelining_beneficial_decode_only(t):
                return self._pipeline_decision(prefill, decode_gpu,
                                               decode_cpu, t, mixed,
                                               reason="Ineq(5) holds",
                                               chunk=chunk)
            return Decision(StrategyKind.ASYNC_OVERLAP, prefill, decode_gpu,
                            decode_cpu,
                            reason=f"Ineq(6): N_G/N_C={t.n_g / t.n_c:.1f} >= "
                                   f"{analytical.ineq6_threshold(t):.1f}",
                            predicted_time=self._aligned_time(t, mixed),
                            chunk_tokens=chunk)

        # Rule 3 — mixed: widened host window.
        if analytical.pipelining_beneficial_mixed(t):
            return self._pipeline_decision(prefill, decode_gpu, decode_cpu, t,
                                           mixed, reason="mixed Ineq holds",
                                           chunk=chunk)
        return Decision(StrategyKind.ASYNC_OVERLAP, prefill, decode_gpu,
                        decode_cpu, reason="mixed Ineq fails",
                        predicted_time=self._aligned_time(t, mixed),
                        chunk_tokens=chunk)

    # --- chunked-prefill budget ------------------------------------------
    def chunk_budget(self, n_gpu: int, n_cpu: int, mean_context: float,
                     *, backlog: int, cap: int,
                     urgent: bool = False) -> int:
        """Per-iteration prefill chunk budget (tokens).

        With nothing decoding there is nothing to stall: grant the
        whole backlog (TTFT-optimal, the pre-chunking behaviour).
        With an active host cohort, pick the *smallest* power-of-two
        chunk whose predicted mixed-iteration device time
        (``t_glinear_pref + t_gatt_pref``) still covers the cohort's
        one-layer host-attention time — the chunk keeps the
        ASYNC_OVERLAP/ASYM_PIPELINE window wide enough that the host
        job lands in-iteration (never late), while staying as small as
        inter-token latency allows.  Device-only decode has no window
        to protect, so the cap (the ``chunk_tokens`` knob) applies
        directly.
        """
        if n_gpu == 0 and n_cpu == 0:
            return backlog
        budget = cap
        if urgent:
            # SLO-bound prefill: the cap (the operator's latency/
            # throughput trade-off) applies directly — never shave
            # below it for host-window overlap
            return max(1, min(budget, backlog))
        if n_cpu > 0:
            t_catt = getattr(self.perf_model, "t_catt", None)
            if t_catt is not None:
                t_host = t_catt(n_cpu, mean_context, layers=1)
                c = 1
                while c < cap:
                    t = self.perf_model.timings(max(n_gpu, 1), mean_context,
                                                prefill_tokens=c)
                    if t.t_glinear_pref + t.t_gatt_pref >= t_host:
                        break
                    c <<= 1
                budget = min(c, cap)
        return max(1, min(budget, backlog))

    # --- predicted iteration times (Eqs. 1/2 + mixed variants) ----------
    @staticmethod
    def _aligned_time(t: Timings, mixed: bool) -> float:
        """GPU-aligned iteration (GPU_ONLY / ASYNC_OVERLAP): Eq. (1)."""
        if mixed:
            return t.t_glinear_pref + t.t_gatt_pref
        return analytical.t_gpu_only(t)

    @staticmethod
    def _pipeline_time(t: Timings, mixed: bool) -> float:
        """Asymmetric-pipelining cycle: Eq. (2) / the rule-3 window."""
        if mixed:
            return t.t_glinear_pref + t.t_glinear + t.t_gatt_pref
        return analytical.t_overlap(t)

    def _pipeline_decision(self, prefill, decode_gpu, decode_cpu,
                           t: Timings, mixed: bool, reason: str,
                           chunk: int = 0) -> Decision:
        # Rule 4 — partially processed offloaded requests go first into
        # the CPU-only sub-batch.
        cpu_sorted = sorted(decode_cpu, key=_progress, reverse=True)
        sb2 = cpu_sorted[: self.max_pipeline_sub_batch]
        overflow = cpu_sorted[self.max_pipeline_sub_batch:]
        sb1 = prefill + decode_gpu + overflow
        return Decision(StrategyKind.ASYM_PIPELINE, prefill, decode_gpu,
                        decode_cpu, sub_batch_1=sb1, sub_batch_2=sb2,
                        reason=reason,
                        predicted_time=self._pipeline_time(t, mixed),
                        chunk_tokens=chunk)


@dataclasses.dataclass
class AdmissionController:
    """Rule 1 (GPU-first) at request admission.

    New requests claim device KV slots while they fit; once the device
    budget is exhausted, requests are designated host-offloaded
    (provided the host pool can hold them — else they wait).

    The serving engine passes ``device_ok`` / ``host_ok`` to fold its
    structural constraints (a free batch slot, paged-pool pages) into
    the same placement decision, so KV budgets and slot management are
    one mechanism.
    """

    device_kv_budget_tokens: int
    host_kv_budget_tokens: int
    device_used: int = 0
    host_used: int = 0

    def place(self, need_tokens: int, *, device_ok: bool = True,
              host_ok: bool = True) -> Optional[str]:
        """Returns "device" | "host" | None (must wait)."""
        if device_ok and \
                self.device_used + need_tokens <= self.device_kv_budget_tokens:
            self.device_used += need_tokens
            return "device"
        if host_ok and \
                self.host_used + need_tokens <= self.host_kv_budget_tokens:
            self.host_used += need_tokens
            return "host"
        return None

    def release(self, tier: str, tokens: int) -> None:
        if tier == "device":
            self.device_used = max(0, self.device_used - tokens)
        elif tier == "host":
            self.host_used = max(0, self.host_used - tokens)

    def headroom(self, tier: str) -> int:
        """Unclaimed KV budget on a tier — the placement signal the
        ``TierPlacer`` steers rebalancing/preemption by."""
        if tier == "device":
            return self.device_kv_budget_tokens - self.device_used
        return self.host_kv_budget_tokens - self.host_used

    def transfer(self, src: str, dst: str, tokens: int) -> None:
        """Move a resident request's claim between tiers (host→device
        migration / device→host preemption).  Capacity on ``dst`` must
        be checked by the caller (``headroom``) before the KV move."""
        self.release(src, tokens)
        if dst == "device":
            self.device_used += tokens
        elif dst == "host":
            self.host_used += tokens
