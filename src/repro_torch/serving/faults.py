"""Deterministic fault injection for chaos-testing the serving stack.

A :class:`FaultPlan` names *which* failure hits *which* occurrence of an
eligible event; a :class:`FaultInjector` owns the per-kind event
counters and decides, at each instrumented call site, whether this
event is the one that fails.  Schedules are counter-based — the Nth
host job, the Nth pool allocation — never wall-clock or RNG based, so
the same plan against the same workload injects the same faults every
run.  Tests and ``chip_smoke.py``'s faults phase share plans through
``EngineConfig.fault_plan`` / ``ServerConfig.fault_plan``.

Port of ``repro/serving/faults.py`` (the port imports nothing of the
reference package, so it keeps this copy).

Fault kinds and their injection sites:

========================  ====================================================
``host_error``            ``HostExecutor._execute`` raises
                          :class:`FaultInjectedError` (a host worker died
                          mid-job); the engine's watchdog recomputes the
                          cohort's attention on the engine thread.
``host_stall``            ``HostExecutor._execute`` sleeps ``duration``
                          seconds before doing any work (a wedged worker);
                          the watchdog deadline expires and triggers the
                          same recompute fallback.
``pool_alloc``            ``PagedKVPool.allocate`` raises :class:`MemoryError`
                          (pool exhausted); admission requeues, preemption
                          falls back to recompute-from-scratch.
``driver_crash``          ``Replica._drive`` raises on its next pump
                          (absorbs the older ``Replica.inject_fault`` test
                          hook); the pool fails in-flight handles and
                          respawns the replica.
``latency_spike``         ``Engine.step`` sleeps ``duration`` seconds at the
                          top of the iteration (GC pause / noisy neighbor).
========================  ====================================================

Plans parse from a compact string for CLI/bench use::

    "host_stall@3x2:0.5,pool_alloc@1"

reads as "stall the 3rd and 4th host jobs for 0.5 s each, and fail the
1st pool allocation".  ``kind[@at][xcount][:duration]`` — ``at`` is the
1-based index of the first eligible event hit (default 1), ``count`` the
number of consecutive events hit from there (default 1), ``duration``
the sleep in seconds for stall/spike kinds (default 0.05).
"""
from __future__ import annotations

import dataclasses
import re
import threading
import time
from typing import Dict, Optional, Sequence, Tuple, Union

FAULT_KINDS = (
    "host_error",
    "host_stall",
    "pool_alloc",
    "driver_crash",
    "latency_spike",
)


class FaultInjectedError(RuntimeError):
    """Raised at an injection site standing in for a real crash."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault: hit events ``at .. at+count-1`` of ``kind``."""

    kind: str
    at: int = 1
    count: int = 1
    duration: float = 0.05

    def __post_init__(self) -> None:
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; expected one of {FAULT_KINDS}")
        if self.at < 1 or self.count < 1:
            raise ValueError("FaultSpec.at and .count are 1-based and >= 1")

    def hits(self, event_index: int) -> bool:
        return self.at <= event_index < self.at + self.count


_SPEC_RE = re.compile(
    r"^(?P<kind>[a-z_]+)"
    r"(?:@(?P<at>\d+))?"
    r"(?:x(?P<count>\d+))?"
    r"(?::(?P<duration>[0-9.]+))?$")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """An immutable set of :class:`FaultSpec`; the unit of configuration."""

    specs: Tuple[FaultSpec, ...] = ()

    @classmethod
    def parse(cls, text: str) -> "FaultPlan":
        specs = []
        for part in text.split(","):
            part = part.strip()
            if not part:
                continue
            m = _SPEC_RE.match(part)
            if m is None:
                raise ValueError(f"unparseable fault spec {part!r} "
                                 "(expected kind[@at][xcount][:duration])")
            specs.append(FaultSpec(
                kind=m.group("kind"),
                at=int(m.group("at") or 1),
                count=int(m.group("count") or 1),
                duration=float(m.group("duration") or 0.05)))
        return cls(specs=tuple(specs))

    @classmethod
    def coerce(cls, plan: Union[None, str, "FaultPlan",
                                Sequence[FaultSpec]]) -> Optional["FaultPlan"]:
        """Accept the forms a config field may carry; None stays None."""
        if plan is None:
            return None
        if isinstance(plan, FaultPlan):
            return plan
        if isinstance(plan, str):
            return cls.parse(plan)
        return cls(specs=tuple(plan))

    def describe(self) -> str:
        return ",".join(
            f"{s.kind}@{s.at}" + (f"x{s.count}" if s.count > 1 else "")
            + (f":{s.duration:g}" if s.kind in ("host_stall", "latency_spike")
               else "")
            for s in self.specs)


class FaultInjector:
    """Thread-safe realization of a :class:`FaultPlan`.

    Each call to :meth:`fire` counts one eligible event of ``kind``
    (counters are per kind, so interleaving between kinds cannot shift
    a schedule) and returns the matching :class:`FaultSpec` when this
    event is scheduled to fail, else ``None``.  The *caller* performs
    the failure — raise, sleep, or return an error — so each site keeps
    its native failure type.
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._lock = threading.Lock()
        self._events: Dict[str, int] = {k: 0 for k in FAULT_KINDS}
        self._fired: Dict[str, int] = {k: 0 for k in FAULT_KINDS}

    @classmethod
    def from_config(cls, plan: Union[None, str, FaultPlan,
                                     Sequence[FaultSpec]],
                    ) -> Optional["FaultInjector"]:
        coerced = FaultPlan.coerce(plan)
        if coerced is None or not coerced.specs:
            return None
        return cls(coerced)

    def fire(self, kind: str) -> Optional[FaultSpec]:
        with self._lock:
            self._events[kind] += 1
            n = self._events[kind]
            for spec in self.plan.specs:
                if spec.kind == kind and spec.hits(n):
                    self._fired[kind] += 1
                    return spec
        return None

    def snapshot(self) -> Dict[str, Dict[str, int]]:
        with self._lock:
            return {"events": dict(self._events), "fired": dict(self._fired)}

    # --- convenience hooks, one per call-site failure type ---------------

    def on_host_job(self) -> None:
        """Hook for ``HostExecutor._execute`` (called duck-typed so the
        core executor needs no import from the serving layer): a
        ``host_error`` kills this worker job, a ``host_stall`` wedges
        it past the engine's watchdog deadline.  Each job counts one
        eligible event of *both* kinds."""
        if self.fire("host_error") is not None:
            raise FaultInjectedError("host worker failed (injected)")
        spec = self.fire("host_stall")
        if spec is not None:
            time.sleep(spec.duration)

    def on_pool_alloc(self) -> None:
        """Hook for ``PagedKVPool.allocate``: fail with the pool's
        native exhaustion error so every tolerant caller path (requeue,
        recompute-preempt) is exercised exactly as if the pool ran dry."""
        if self.fire("pool_alloc") is not None:
            raise MemoryError("paged pool exhausted (injected)")

    def on_driver_pump(self) -> None:
        """Hook for ``Replica._drive`` (the gateway pool's driver loop),
        called before every engine step it pumps: a ``driver_crash``
        takes the pool's crash-containment and respawn path."""
        if self.fire("driver_crash") is not None:
            raise FaultInjectedError("replica driver crash (injected)")

    def on_engine_step(self) -> Optional[float]:
        """Returns the spike duration to sleep, or None.  The engine
        sleeps (rather than us) so the pause lands inside its timed
        section and the calibrator sees it like a real stall."""
        spec = self.fire("latency_spike")
        return spec.duration if spec is not None else None
