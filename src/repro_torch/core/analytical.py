"""The paper's analytical scheduling model (§3.2), verbatim.

Equations (1)–(6) plus the mixed-workload variant from Algorithm 1 and
the §5.2 speedup approximation S ≈ b/a.  ``tests/test_analytical.py``
property-checks the algebraic equivalence of Inequality (5) and (6)
with hypothesis.

Beyond the paper: ``plan_async_overlap`` derives the throughput-optimal
host cohort size for the Asynchronous Overlap strategy from the same
profiled quantities — the paper picks the offload set by KV residency
only; we additionally bound it by the host's sustainable attention rate
so the host never becomes the critical path (§6 "online profiling"
discussion, made static).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Timings:
    """Profiled quantities the scheduler reasons over (seconds / rates).

    Matches the paper's notation: T_glinear / T_gatt are the device
    linear-op and attention times for the *current decode batch*;
    N_G / N_C are device and host attention processing rates in
    tokens/second (a "token" of attention work = one KV-cache position
    scanned).  The ``*_pref`` variants are the with-prefill timings of
    Algorithm 1's mixed branch.
    """

    t_glinear: float
    t_gatt: float
    n_g: float
    n_c: float
    t_glinear_pref: float = 0.0
    t_gatt_pref: float = 0.0

    def __post_init__(self) -> None:
        if min(self.t_glinear, self.t_gatt) <= 0:
            raise ValueError("timings must be positive")
        if min(self.n_g, self.n_c) <= 0:
            raise ValueError("rates must be positive")


def t_gpu_only(t: Timings) -> float:
    """Eq. (1): device-only iteration time."""
    return t.t_glinear + t.t_gatt


def t_overlap(t: Timings) -> float:
    """Eq. (2): asymmetric-pipelining effective cycle time (the batch
    split doubles the linear-op term)."""
    return 2.0 * t.t_glinear + t.t_gatt


def tokens_gpu(t: Timings) -> float:
    """Eq. (3): device attention tokens per pipeline segment."""
    return t.n_g * t.t_gatt


def tokens_cpu(t: Timings) -> float:
    """Eq. (4): host attention tokens processed during T_overlap."""
    return t.n_c * t_overlap(t)


def pipelining_beneficial_decode_only(t: Timings) -> bool:
    """Inequality (5): asymmetric pipelining beats device-only."""
    lhs = (tokens_gpu(t) + tokens_cpu(t)) / t_overlap(t)
    rhs = tokens_gpu(t) / t_gpu_only(t)
    return lhs > rhs


def ineq6_threshold(t: Timings) -> float:
    """RHS of Inequality (6): the N_G/N_C break-even ratio."""
    r = t.t_glinear / t.t_gatt
    return 2.0 * r + 3.0 + 1.0 / r


def pipelining_beneficial_ineq6(t: Timings) -> bool:
    """Inequality (6) — algebraically equivalent to (5)."""
    return t.n_g / t.n_c < ineq6_threshold(t)


def pipelining_beneficial_mixed(t: Timings) -> bool:
    """Algorithm 1's mixed prefill+decode branch: Eq. (4) widens to
    N_Ctotal = N_C (T_glinear_pref + T_glinear + T_gatt_pref)."""
    t_ov_pref = t.t_glinear_pref + t.t_glinear + t.t_gatt_pref
    lhs = (tokens_gpu(t) + t.n_c * t_ov_pref) / t_overlap(t)
    rhs = tokens_gpu(t) / t_gpu_only(t)
    return lhs > rhs


def host_cohort_below_min_ratio(host_batch: int, device_batch: int,
                                ratio: float) -> bool:
    """§4.2 admission threshold, the single shared predicate: a host
    cohort smaller than ratio * device_batch cannot amortize the
    dedicated CPU sub-batch's thread/dispatch overheads."""
    return ratio > 0 and host_batch < ratio * max(device_batch, 1)


def speedup_estimate(power_ratio_a: float, decode_fraction_b: float) -> float:
    """§5.2: achievable throughput gain S ≈ b/a over a device-only
    baseline (a = device:host compute-power ratio, b = fraction of time
    in decode-intensive phases).  Returned as the multiplicative gain."""
    return decode_fraction_b / power_ratio_a


# ---------------------------------------------------------------------------
# Asynchronous Overlap planning (beyond-paper extension of the model)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class OverlapPlan:
    """Sizing decision for the Asynchronous Overlap strategy."""

    device_batch: int          # rows decoded fully on-device per iteration
    host_batch: int            # rows in the host cohort
    iterations_per_host_token: int
    iteration_time: float      # predicted engine iteration latency (s)
    device_tokens_per_s: float
    host_tokens_per_s: float

    @property
    def total_tokens_per_s(self) -> float:
        return self.device_tokens_per_s + self.host_tokens_per_s


def plan_async_overlap(t: Timings, *, device_batch: int,
                       host_queue: int, num_attn_layers: int,
                       mean_context: float,
                       host_min_ratio: float = 0.0) -> OverlapPlan:
    """Choose the host cohort size for Asynchronous Overlap.

    The host computes one layer's attention for the whole cohort per
    engine iteration; it stays off the critical path while
    ``host_batch * mean_context <= n_c * iteration_time``.  The
    iteration time itself is flat in the cohort size (unified linear
    ops — the paper's Fig. 1a observation), so the bound is explicit.

    ``host_min_ratio`` reproduces the paper's §4.2 threshold (host
    requests >= 8x device requests) under which thread/dispatch
    overheads amortize; cohorts below it are rejected (host_batch=0).
    """
    iter_time = t_gpu_only(t)
    budget_tokens = t.n_c * iter_time            # host KV positions / iter
    max_cohort = int(budget_tokens / max(mean_context, 1.0))
    host_batch = max(0, min(host_queue, max_cohort))
    if host_cohort_below_min_ratio(host_batch, device_batch, host_min_ratio):
        # too small to amortize host-thread overheads — the paper's
        # empirical admission threshold (§4.2)
        host_batch = 0
    iters_per_tok = num_attn_layers + 1
    return OverlapPlan(
        device_batch=device_batch,
        host_batch=host_batch,
        iterations_per_host_token=iters_per_tok,
        iteration_time=iter_time,
        device_tokens_per_s=device_batch / iter_time,
        host_tokens_per_s=host_batch / (iters_per_tok * iter_time),
    )
