"""The benchmark's client over ``repro_torch.serving.api.InferenceServer``:
it submits the traffic's turns when they are due, drives ``step()``,
and notes when each token appears.  A warm-up of the cell's own traffic
precedes the measured window.
"""
from __future__ import annotations

import contextlib
import dataclasses
import heapq
import time
from typing import Dict, List, Optional

from portbench.harness.traffic import Session, Traffic, clients

# the longest a warm-up waits for the first round's first tokens: past
# it the window opens anyway and the cell's TTFT shows the stall
WARMUP_MAX_S = 150.0


@dataclasses.dataclass
class Track:
    """One request as the client sees it."""

    req: object
    session: Session
    turn: int
    client: int
    due: float
    times: List[float] = dataclasses.field(default_factory=list)
    history: List[List[int]] = dataclasses.field(default_factory=list)
    host: bool = False           # seen decoding on the host tier
    done_at: Optional[float] = None


class Spans:
    """The benchmark's own spans around its calls into the server (names
    in the profiler's trace when one runs; nothing otherwise)."""

    def __init__(self, traced: bool) -> None:
        self.traced = traced

    def __call__(self, name: str):
        if not self.traced:
            return contextlib.nullcontext()
        import torch
        return torch.profiler.record_function(f"portbench.{name}")


class Client:
    """Closed or open loop over one server, as the mix says."""

    def __init__(self, server, traffic: Traffic, engine: dict, *,
                 spans: Optional[Spans] = None) -> None:
        from repro_torch.serving.request import Phase, Request
        self._Phase, self._Request = Phase, Request
        self.server = server
        self.traffic = traffic
        self.mix = traffic.mix
        self.think = float(self.mix.get("think_s", 0.0))
        self.closed = self.mix["loop"] == "closed"
        self.n_clients = clients(self.mix, engine) if self.closed else 0
        self.spans = spans or Spans(False)
        self.live: Dict[int, Track] = {}
        self.finished: List[Track] = []
        self.all: List[Track] = []
        self._due: list = []          # heap of (due, seq, session, turn,
        self._seq = 0                 # client, history)
        self._next_session = 0
        self._t0: Optional[float] = None
        self.steps = 0
        self.step_times: List[float] = []
        self.late: List[float] = []   # submit time - due time, a request
        self.priority = int(self.mix.get("priority", 0))
        self.on_step = None           # called after each step (traced run)

    # --- scheduling ---------------------------------------------------
    def _push(self, due: float, session: Session, turn: int, client: int,
              history: List[List[int]]) -> None:
        heapq.heappush(self._due, (due, self._seq, session, turn, client,
                                   history))
        self._seq += 1

    def _new_session(self, due: float, client: int) -> None:
        s = self.traffic.session(self._next_session)
        self._next_session += 1
        self._push(due, s, 0, client, [])

    def start(self) -> None:
        self._t0 = time.perf_counter()
        if self.closed:
            for c in range(self.n_clients):
                self._new_session(self._t0, c)
        else:
            self._new_session(self._t0 + self.traffic.arrival(0), -1)

    def _submit_due(self, now: float) -> None:
        while self._due and self._due[0][0] <= now:
            due, _, s, turn, client, history = heapq.heappop(self._due)
            if not self.closed and turn == 0:
                # the open schedule: the next session's arrival
                i = s.sid + 1
                self._push(self._t0 + self.traffic.arrival(i),
                           self.traffic.session(i), 0, -1, [])
                self._next_session = max(self._next_session, i + 1)
            req = self._Request(prompt=self.traffic.prompt(s, turn, history),
                                max_new_tokens=s.replies[turn],
                                arrival_time=due, priority=self.priority)
            tr = Track(req, s, turn, client, due, history=history)
            self.late.append(time.perf_counter() - due)
            with self.spans("submit"):
                self.server.submit(req)
            self.all.append(tr)
            self.live[req.request_id] = tr

    def _collect(self, now: float) -> None:
        phase = self._Phase
        for rid in list(self.live):
            tr = self.live[rid]
            out = tr.req.output
            while len(tr.times) < len(out):
                tr.times.append(now)
            if tr.req.phase is phase.DECODE_HOST:
                tr.host = True
            if tr.req.phase is phase.FINISHED or tr.req.failed:
                tr.done_at = now
                del self.live[rid]
                self.finished.append(tr)
                self._follow(tr, now)

    def _follow(self, tr: Track, now: float) -> None:
        s = tr.session
        if tr.turn + 1 < len(s.users):
            history = tr.history + [list(tr.req.output)]
            self._push(now + self.think, s, tr.turn + 1, tr.client, history)
        elif self.closed:
            self._new_session(now, tr.client)

    # --- driving ------------------------------------------------------
    def run_until(self, t_end: float) -> float:
        """Submit and step until the first step boundary at or past
        ``t_end``; returns that time."""
        engine = self.server.engine
        while True:
            now = time.perf_counter()
            if now >= t_end:
                return now
            self._submit_due(now)
            if engine.has_work:
                with self.spans("step"):
                    self.server.step()
                self.steps += 1
                self.step_times.append(time.perf_counter() - now)
                if self.on_step is not None:
                    self.on_step()
            else:
                nxt = self._due[0][0] if self._due else t_end
                with self.spans("wait"):
                    time.sleep(max(0.0, min(nxt, t_end) - now))
            with self.spans("collect"):
                self._collect(time.perf_counter())

    def warm_up(self, seconds: float) -> None:
        """Drive the traffic for ``seconds``; a closed loop also until
        every request of its first round (one a client) has its first
        token, so the window opens past the start-up transient whatever
        the host's speed; at most ``WARMUP_MAX_S``."""
        t0 = time.perf_counter()
        self.run_until(t0 + seconds)
        if not self.closed:
            return
        first = list(self.all[:max(self.n_clients, 1)])
        while any(not t.times for t in first) and \
                time.perf_counter() < t0 + WARMUP_MAX_S:
            self.run_until(time.perf_counter() + 0.5)
