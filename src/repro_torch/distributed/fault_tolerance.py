"""Fault-tolerance primitives shared by training and serving.

Pure-logic (testable without hardware) components:

  * ``HeartbeatMonitor`` — marks workers dead after ``timeout`` without
    a beat, and flags *stragglers* whose step time exceeds
    ``straggler_factor`` x the fleet median (the reference's train
    launcher and gateway replica pool feed it; both are still to port).
  * ``RestartPolicy`` — crash-loop backoff with a budget.  The serving
    engine uses it as the host-tier circuit breaker's cooldown schedule
    (each breaker trip doubles the GPU-only pin window, a healthy host
    job resets it).

Port of ``repro/distributed/fault_tolerance.py``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence


@dataclasses.dataclass
class WorkerInfo:
    worker_id: int
    last_beat: float = 0.0
    last_step_time: Optional[float] = None
    alive: bool = True


class HeartbeatMonitor:
    def __init__(self, worker_ids: Sequence[int], *, timeout: float = 60.0,
                 straggler_factor: float = 2.0) -> None:
        self.timeout = timeout
        self.straggler_factor = straggler_factor
        self.workers: Dict[int, WorkerInfo] = {
            w: WorkerInfo(w) for w in worker_ids}

    def beat(self, worker_id: int, now: float,
             step_time: Optional[float] = None) -> None:
        w = self.workers[worker_id]
        w.last_beat = now
        w.alive = True
        if step_time is not None:
            w.last_step_time = step_time

    def sweep(self, now: float) -> List[int]:
        """Mark and return workers newly considered dead."""
        newly_dead = []
        for w in self.workers.values():
            if w.alive and now - w.last_beat > self.timeout:
                w.alive = False
                newly_dead.append(w.worker_id)
        return newly_dead

    def alive_workers(self) -> List[int]:
        return [w.worker_id for w in self.workers.values() if w.alive]

    def stragglers(self) -> List[int]:
        times = sorted(w.last_step_time for w in self.workers.values()
                       if w.alive and w.last_step_time is not None)
        if len(times) < 3:
            return []
        median = times[len(times) // 2]
        return [w.worker_id for w in self.workers.values()
                if w.alive and w.last_step_time is not None
                and w.last_step_time > self.straggler_factor * median]


@dataclasses.dataclass
class RestartPolicy:
    max_restarts: int = 10
    backoff_base: float = 5.0
    backoff_cap: float = 300.0
    restarts: int = 0

    def next_delay(self) -> Optional[float]:
        """Seconds to wait before the next restart; None = give up."""
        if self.restarts >= self.max_restarts:
            return None
        delay = min(self.backoff_cap,
                    self.backoff_base * math.pow(2.0, self.restarts))
        self.restarts += 1
        return delay

    def record_success(self) -> None:
        """A healthy interval resets the crash-loop counter."""
        self.restarts = 0
