"""Tier placement and rebalancing predicates (NEO's load-aware rule).

APEX's premise is that placement across heterogeneous tiers should be
dynamic: a request parked on the slow host tier should move back when
a device slot frees up *and the move pays for itself*.  NEO
(arXiv:2411.01142) frames the rule as drain-time balancing — the slow
tier must never become the makespan bottleneck — and HeteGen makes the
same case for dynamic placement under memory pressure.

This module is the one home of those predicates in the port: the
engine's ``TierPlacer`` (``repro_torch.serving.lifecycle``) and the
prefix cache call these functions, and a later simulator will call the
same ones.  The functions are pure: callers supply the queue depths,
headrooms and per-token time estimates (the engine from the
``OnlineCalibrator``'s corrected timings), and get a decision back.
Port of ``repro/core/placement.py``.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional, Sequence


def _remaining(req: Any) -> int:
    """Decode tokens a request still owes."""
    return max(int(req.max_new_tokens) - len(req.output), 0)


def should_rebalance_to_device(*, waiting: int, device_slot_free: bool,
                               device_kv_headroom: int, need_tokens: int,
                               remaining_tokens: int,
                               migration_cost: float = 0.0,
                               device_s_per_token: Optional[float] = None,
                               host_s_per_token: Optional[float] = None
                               ) -> bool:
    """Host→device migration predicate (the simulator's ``rebalance``
    rule, shared with the engine).

    Structural gate first: the device must have *idle* capacity — a
    free slot, KV headroom for the request's full demand, and no
    waiting admissions that would claim it (new arrivals keep the
    GPU-first right of way).  Then the drain-time model: migrating
    pays off iff the predicted decode-time saving over the request's
    remaining tokens exceeds the one-shot KV transfer cost.  Callers
    without per-token estimates (no perf model wired) fall back to the
    structural idle-capacity rule alone.
    """
    if waiting > 0 or not device_slot_free:
        return False
    if need_tokens > device_kv_headroom or remaining_tokens <= 0:
        return False
    if device_s_per_token is None or host_s_per_token is None:
        return True
    saving = remaining_tokens * (host_s_per_token - device_s_per_token)
    return saving > migration_cost


def pick_rebalance_candidate(host_requests: Sequence[Any]) -> Optional[Any]:
    """The host resident worth moving first: the one with the most
    remaining decode tokens (largest stake in the fast tier — the
    simulator's historical choice, now shared)."""
    live = [r for r in host_requests if _remaining(r) > 0]
    if not live:
        return None
    return max(live, key=_remaining)


def should_preempt(urgent_priority: int, victim_priority: int) -> bool:
    """Preemption is strictly priority-ordered: an urgent request may
    displace only a strictly lower-priority resident (equal priorities
    never churn)."""
    return urgent_priority > victim_priority


def pick_preemption_victim(residents: Sequence[Any], *,
                           urgent_priority: int) -> Optional[Any]:
    """The device resident to demote for an urgent admission: lowest
    priority first, cheapest KV to move (shortest context) on ties.
    None when no resident is strictly lower-priority."""
    eligible = [r for r in residents
                if should_preempt(urgent_priority, getattr(r, "priority", 0))]
    if not eligible:
        return None
    return min(eligible,
               key=lambda r: (getattr(r, "priority", 0), r.total_len))


def longest_common_prefix(a: Sequence[int], b: Sequence[int]) -> int:
    """Length of the shared leading run of two token sequences — the
    match rule of the cross-request prefix cache (engine) and of the
    simulator's cache model.  One definition so the two cannot
    disagree on what counts as a hit."""
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


def chargeable_prefill_tokens(prompt_len: int, cached_prefix: int) -> int:
    """Prompt tokens an admission must actually prefill given a cached
    prefix of ``cached_prefix`` tokens — THE shared pricing predicate
    between the engine (chunk backlog, deadline backpressure) and the
    simulator's admission model, so sim and engine cannot drift on
    cache-aware admission.

    The usable prefix is capped at ``prompt_len - 1``: at least one
    suffix token always runs through prefill so the first output
    token's logits are computed fresh (an exact-hit prompt still
    prefills its final token).  A non-positive match charges the whole
    prompt."""
    if prompt_len <= 0:
        return 0
    usable = min(max(cached_prefix, 0), prompt_len - 1)
    return prompt_len - usable


def deadline_impossible(*, elapsed: float, deadline: Optional[float],
                        predicted_ttft: float) -> bool:
    """Admission backpressure: True when a request's TTFT deadline
    cannot be met even if it were admitted *right now* (time already
    burned in the queue plus the model-predicted prefill exceeds the
    SLO).  Rejecting here beats admitting doomed work that would only
    steal capacity from requests that can still make their deadlines."""
    if deadline is None:
        return False
    return elapsed + predicted_ttft > deadline


# --- graceful-degradation ladder ---------------------------------------
#
# Under memory pressure the serving stack sheds load in ONE fixed,
# observable order — cheapest reversible action first, hard refusal
# last.  Each rung names the action taken, and doubles as the /health
# degradation level (index into the tuple = severity).  Engine and
# gateway both map their recent-pressure signals through
# ``degradation_level`` so the ladder cannot drift between layers.
DEGRADATION_LADDER = (
    "ok",            # no recent pressure
    "prefix_evict",  # LRU-reclaimed cached prefix chains from the host pool
    "demote",        # preempted device residents to the host tier (swap)
    "recompute",     # dropped a victim's KV; it re-enters the queue
    "shed",          # gateway refused new work outright (503)
)


def degradation_level(recent: Mapping[str, bool]) -> str:
    """The current ladder rung: the most severe action with recent
    activity (callers decide what "recent" means — the engine uses a
    sliding window over pressure timestamps).  Unknown keys are
    ignored so layers can carry private signals."""
    level = "ok"
    for rung in DEGRADATION_LADDER:
        if recent.get(rung, False):
            level = rung
    return level


def should_recompute_instead_of_swap(*, t_swap: float,
                                     t_recompute: float) -> bool:
    """Preemption escape-hatch pricing: drop the victim's KV and
    recompute from scratch only when the perf model predicts that is
    strictly cheaper than swapping the KV to the host tier.  Recompute
    charges a full re-prefill plus re-decoding every already-emitted
    token, so swap wins whenever it is feasible at realistic sizes —
    recompute earns its keep when the swap path is blocked (no host
    capacity), where callers invoke it unconditionally instead."""
    return t_recompute < t_swap
