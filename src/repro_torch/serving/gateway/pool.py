"""Engine replica pool: the execution backend of the HTTP gateway.

``EngineReplicaPool`` owns N ``InferenceServer`` replicas, each with a
dedicated **driver thread** that pumps ``step()`` whenever the replica
has work and fans freshly generated tokens out to per-request streams.
That inverts the in-process API's pull model (where
``RequestHandle.tokens()`` drives the engine): pool consumers only
*read* — from a thread-safe queue or via a listener callback — so a
token stream can be consumed from any thread, including an asyncio
event loop, without ever touching the engine.

Contracts:

  * **Single driver.** The driver thread is the only caller of
    ``server.step()`` for its replica.  Submission from gateway worker
    threads is safe because ``InferenceServer`` serializes ``submit``
    and ``step`` on its internal lock.
  * **Least-loaded routing + leases.** ``submit()`` routes to the live
    replica with the fewest in-flight streams; ``acquire``/``release``
    (or the ``checkout()`` context manager) pin a replica for session
    use — a lease counts toward its load so routing steers around it.
  * **Session affinity.** ``submit(..., session_id=...)`` pins the
    session to the replica that served its first turn, so follow-up
    turns land where the engine's prefix cache already holds the
    conversation's KV.  A dead or respawned pin (generation mismatch)
    falls back to least-loaded routing and re-pins there.
  * **Crash containment + respawn.** A driver exception marks the
    replica dead, fails every in-flight request on it (the error lands
    on ``Request.error`` / the stream's terminal event — other
    replicas' requests are untouched), shuts the broken engine down,
    and — unless the pool is closing — rebuilds the replica from the
    factory and restarts its driver.

Port of ``repro/serving/gateway/pool.py``.  On the card every replica's
driver thread launches the hand-written kernels on that thread's
current stream; replicas built by one factory share its parameters.
"""
from __future__ import annotations

import contextlib
import logging
import queue as queue_mod
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, \
    Tuple, Union

from repro_torch.core.placement import DEGRADATION_LADDER
from repro_torch.distributed.fault_tolerance import HeartbeatMonitor
from repro_torch.serving.api import InferenceServer
from repro_torch.serving.request import Phase, Request

logger = logging.getLogger(__name__)

# stream events: ("token", <int>) while generating, then exactly one
# ("done", None | "<error reason>") terminal event
PoolEvent = Tuple[str, Any]


class ReplicaDead(RuntimeError):
    """Raised when a submission targets a dead replica (or the whole
    pool has no live replica left)."""


class _Stream:
    """Per-request fan-out channel between a driver thread and one
    consumer.  Events buffer in a thread-safe queue until a listener
    is attached; attaching replays the backlog first, so no token can
    be lost to the attach race."""

    def __init__(self, request: Request) -> None:
        self.request = request
        self.sent = 0                      # tokens already fanned out
        self._q: queue_mod.Queue = queue_mod.Queue()
        self._listener: Optional[Callable[[PoolEvent], None]] = None
        self._lock = threading.Lock()
        self._flush_lock = threading.Lock()
        self._closed = False
        self._listener_warned = False
        # replica-wired counter hook: every swallowed listener
        # exception is counted even though only the first is logged
        self.on_listener_error: Optional[Callable[[], None]] = None

    def emit(self, event: PoolEvent) -> None:
        with self._lock:
            if self._closed:
                return                     # terminal event already sent
            if event[0] == "done":
                self._closed = True
            if self._listener is not None:
                try:
                    self._listener(event)
                except Exception:
                    # a broken consumer (e.g. an HTTP client that hung
                    # up and closed its event loop) must never kill the
                    # driver thread that feeds every other request —
                    # but it must not be invisible either: log once per
                    # stream, count every occurrence
                    if self.on_listener_error is not None:
                        self.on_listener_error()
                    if not self._listener_warned:
                        self._listener_warned = True
                        logger.warning(
                            "stream listener for request %d raised; "
                            "suppressing further errors on this stream",
                            self.request.request_id, exc_info=True)
            else:
                self._q.put(event)

    def flush(self) -> bool:
        """Emit tokens past the high-water mark, then the terminal
        event once the request finished.  Atomic per stream — the
        driver's fan-out pass and a cancelling thread can both call
        this without double-sending a token.  Returns True when the
        terminal event has been emitted (stream can be deregistered)."""
        with self._flush_lock:
            out = self.request.output
            while self.sent < len(out):
                self.emit(("token", out[self.sent]))
                self.sent += 1
            if self.request.phase == Phase.FINISHED:
                self.emit(("done", self.request.error))
                return True
        return False

    def attach(self, listener: Callable[[PoolEvent], None]) -> None:
        with self._lock:
            while True:                    # replay the buffered backlog
                try:
                    listener(self._q.get_nowait())
                except queue_mod.Empty:
                    break
            self._listener = listener

    def get(self, timeout: Optional[float] = None) -> PoolEvent:
        return self._q.get(timeout=timeout)


class PoolHandle:
    """Streaming view of one pool-submitted request.

    Unlike ``RequestHandle``, iterating does **not** drive the engine —
    the replica's driver thread does.  ``tokens()``/``events()`` block
    on the fan-out queue; ``add_listener`` instead pushes every event
    into a callback (called from the driver thread), which is how the
    HTTP gateway bridges into asyncio."""

    def __init__(self, request: Request, stream: _Stream,
                 replica_index: int,
                 canceller: Optional[Callable[[int], bool]] = None) -> None:
        self.request = request
        self.replica_index = replica_index
        self._stream = stream
        self._canceller = canceller

    @property
    def request_id(self) -> int:
        return self.request.request_id

    @property
    def done(self) -> bool:
        return self.request.phase == Phase.FINISHED

    @property
    def failed(self) -> bool:
        return self.request.failed

    @property
    def error(self) -> Optional[str]:
        return self.request.error

    @property
    def output(self) -> List[int]:
        return self.request.output

    def add_listener(self, listener: Callable[[PoolEvent], None]) -> None:
        self._stream.attach(listener)

    def events(self, timeout: Optional[float] = None
               ) -> Iterator[PoolEvent]:
        """Yield stream events until (and including) the terminal
        ``("done", error)`` event.  ``timeout`` bounds the wait for
        each individual event (``queue.Empty`` on expiry)."""
        while True:
            event = self._stream.get(timeout=timeout)
            yield event
            if event[0] == "done":
                return

    def tokens(self, timeout: Optional[float] = None) -> Iterator[int]:
        """Per-token stream; raises ``RuntimeError`` if the request
        ends with an error (rejection or replica crash)."""
        for kind, payload in self.events(timeout=timeout):
            if kind == "token":
                yield payload
            elif payload is not None:
                raise RuntimeError(payload)

    def result(self, timeout: Optional[float] = None) -> List[int]:
        """Block until finished; returns all tokens (raises on error)."""
        return list(self.tokens(timeout=timeout))

    def cancel(self) -> bool:
        """Abort the request on its replica (client hung up / lost
        interest): engine-side resources are freed and the stream gets
        its terminal ``("done", "cancelled")`` event.  Returns True
        when the request was still live.  No-op after completion."""
        if self._canceller is None or self.done:
            return False
        return self._canceller(self.request_id)


class Replica:
    """One ``InferenceServer`` plus its driver thread and fan-out
    registry.  Create via the pool; ``start()`` launches the driver."""

    _IDLE_POLL_S = 0.02      # fallback wakeup while idle (belt for the
    #                          condition-notify braces on submit)

    def __init__(self, index: int,
                 factory: Callable[[], InferenceServer], *,
                 generation: int = 0) -> None:
        self.index = index
        self.generation = generation     # bumped on every respawn
        self.server = factory()
        self.alive = True
        self.error: Optional[str] = None
        self.leases = 0
        self.listener_errors = 0         # swallowed stream-listener raises
        self.on_beat: Optional[Callable[[int], None]] = None
        self._streams: Dict[int, _Stream] = {}
        self._cond = threading.Condition()
        self._stop = False
        self._fault: Optional[BaseException] = None
        self._on_death: Optional[Callable[["Replica"], None]] = None
        self._thread = threading.Thread(
            target=self._drive, name=f"replica-{index}-driver", daemon=True)

    def start(self, on_death: Optional[Callable[["Replica"], None]] = None
              ) -> None:
        self._on_death = on_death
        self._thread.start()

    # --- load / liveness ------------------------------------------------
    @property
    def load(self) -> int:
        """In-flight streams plus held leases — the routing signal."""
        with self._cond:
            return len(self._streams) + self.leases

    @property
    def driver_alive(self) -> bool:
        return self._thread.is_alive()

    # --- submission -----------------------------------------------------
    def submit(self, request: Request) -> PoolHandle:
        """Register a fan-out stream, then hand the request to the
        server (that order matters: the driver may finish the request
        within one pump, and the final fan-out pass must find the
        stream).  Safe from any thread."""
        stream = _Stream(request)
        stream.on_listener_error = self._note_listener_error
        with self._cond:
            if not self.alive:
                raise ReplicaDead(
                    f"replica {self.index} is dead: {self.error}")
            self._streams[request.request_id] = stream
            self._cond.notify_all()
        try:
            handle = self.server.submit(request)
        except Exception as exc:         # e.g. engine queue full
            with self._cond:
                self._streams.pop(request.request_id, None)
            if request.error is None:
                request.error = str(exc)
            request.phase = Phase.FINISHED
            stream.emit(("done", request.error))
            return PoolHandle(request, stream, self.index, self.cancel)
        if handle.failed:
            # rejected at submit (oversized prompt, impossible
            # deadline): terminal event now — emit() dedups if the
            # driver's fan-out pass also saw the FINISHED phase
            with self._cond:
                self._streams.pop(request.request_id, None)
            stream.emit(("done", request.error))
        return PoolHandle(request, stream, self.index, self.cancel)

    def cancel(self, request_id: int) -> bool:
        """Abort one request on this replica: engine-side resources are
        freed inline (``Engine.cancel``) and the stream gets its
        terminal event as soon as the request reaches FINISHED — for a
        host resident mid-cohort-journey that is the next token
        boundary, fanned out by the driver."""
        found = self.server.cancel(request_id)
        with self._cond:
            stream = self._streams.get(request_id)
            self._cond.notify_all()      # wake the driver for fan-out
        if stream is not None and stream.flush():
            with self._cond:
                self._streams.pop(request_id, None)
        return found

    def _note_listener_error(self) -> None:
        self.listener_errors += 1

    # --- the driver loop ------------------------------------------------
    def _beat(self) -> None:
        if self.on_beat is not None:
            self.on_beat(self.index)

    def _drive(self) -> None:
        try:
            while True:
                with self._cond:
                    while not (self._stop or self._fault is not None
                               or self.server.engine.has_work):
                        self._beat()
                        self._cond.wait(timeout=self._IDLE_POLL_S)
                    if self._stop:
                        return
                while not self._stop:
                    self._beat()
                    if self._fault is not None:
                        fault, self._fault = self._fault, None
                        raise fault
                    # the engine's chaos matrix reaches the driver too:
                    # a scheduled driver_crash raises here and takes
                    # the crash-containment path (absorbing the older
                    # inject_fault test hook's semantics)
                    faults = self.server.engine.faults
                    if faults is not None:
                        faults.on_driver_pump()
                    if not self.server.engine.has_work:
                        break
                    self.server.step()
                    self._fanout()
                self._fanout()           # instant finishes / rejections
        except BaseException as exc:     # driver crash: contain + report
            self._crash(exc)

    def _fanout(self) -> None:
        """Push tokens generated since the last pass to their streams;
        emit the terminal event and deregister finished requests.
        Per-stream flushing is atomic (``_Stream.flush``), so a
        concurrent ``cancel`` cannot double-send."""
        with self._cond:
            items = list(self._streams.items())
        finished = [rid for rid, stream in items if stream.flush()]
        if finished:
            with self._cond:
                for rid in finished:
                    self._streams.pop(rid, None)

    def _crash(self, exc: BaseException) -> None:
        reason = (f"replica {self.index} driver died: "
                  f"{type(exc).__name__}: {exc}")
        with self._cond:
            self.alive = False
            self.error = reason
            orphans = list(self._streams.values())
            self._streams.clear()
        for stream in orphans:
            req = stream.request
            if req.error is None:
                req.error = reason
            # the engine is gone — bypass the lifecycle transition map
            req.phase = Phase.FINISHED
            stream.emit(("done", req.error))
        try:
            self.server.shutdown()
        except Exception:
            pass
        if self._on_death is not None:
            self._on_death(self)

    # --- fault injection / shutdown -------------------------------------
    def inject_fault(self, exc: Optional[BaseException] = None) -> None:
        """Make the driver raise on its next pump — the chaos hook the
        crash-respawn tests (and drills) use."""
        with self._cond:
            self._fault = exc or RuntimeError("injected fault")
            self._cond.notify_all()

    def stop(self, *, reason: str = "pool shutting down") -> None:
        with self._cond:
            self._stop = True
            orphans = list(self._streams.values())
            self._streams.clear()
            self._cond.notify_all()
        self._thread.join(timeout=30.0)
        for stream in orphans:
            req = stream.request
            if req.error is None:
                req.error = reason
            req.phase = Phase.FINISHED
            stream.emit(("done", req.error))
        try:
            self.server.shutdown()
        except Exception:
            pass


class EngineReplicaPool:
    """N engine replicas behind driver threads: least-loaded routing,
    acquire/release leases, liveness reporting, crash respawn, and the
    predicted-wait estimate the gateway's admission backpressure uses.

    ``factory`` builds one configured ``InferenceServer`` (replicas
    typically share the model params — they are read-only)."""

    # sticky-session table bound: oldest pins fall off first (a pin is
    # only a routing hint — losing one degrades to least-loaded)
    _SESSION_CAP = 4096

    def __init__(self, factory: Callable[[], InferenceServer], *,
                 replicas: int = 2, auto_respawn: bool = True,
                 heartbeat_timeout: float = 60.0) -> None:
        if replicas < 1:
            raise ValueError("need at least one replica")
        self._factory = factory
        self._auto_respawn = auto_respawn
        self._lock = threading.Lock()
        self._closing = False
        # session_id -> (replica index, generation): follow-up turns
        # route to the replica whose prefix cache holds the session
        self._sessions: Dict[str, Tuple[int, int]] = {}
        self.respawns = 0
        # driver-stall detection: every driver loop beats its index;
        # /health sweeps and flags drivers silent past the timeout
        # (a wedged step — distinct from a *crashed* driver, which the
        # containment path already marks dead and respawns)
        self._heartbeats = HeartbeatMonitor(
            range(replicas), timeout=heartbeat_timeout)
        self.replicas: List[Replica] = [Replica(i, factory)
                                        for i in range(replicas)]
        for rep in self.replicas:
            self._start_replica(rep)

    def _start_replica(self, rep: Replica) -> None:
        rep.on_beat = self._beat
        self._heartbeats.beat(rep.index, time.perf_counter())
        rep.start(self._replica_died)

    def _beat(self, index: int) -> None:
        self._heartbeats.beat(index, time.perf_counter())

    # --- respawn ---------------------------------------------------------
    def _replica_died(self, dead: Replica) -> None:
        """Runs on the dying driver thread: rebuild the replica from
        the factory (in-flight requests were already failed by the
        crash handler) unless the pool is closing.  The fresh replica's
        driver starts before it is published, both under the pool's
        lock: ``shutdown`` then never meets a replica whose driver
        thread it cannot join, and routing never sees one half set up."""
        with self._lock:
            if self._closing or not self._auto_respawn:
                return
        try:
            fresh = Replica(dead.index, self._factory,
                            generation=dead.generation + 1)
        except Exception:
            return        # factory broken too: /health keeps it dead
        with self._lock:
            if self._closing:
                fresh.server.shutdown()
                return
            self._start_replica(fresh)
            self.replicas[dead.index] = fresh
            self.respawns += 1

    # --- routing ---------------------------------------------------------
    def live_replicas(self) -> List[Replica]:
        with self._lock:
            reps = list(self.replicas)
        return [r for r in reps if r.alive]

    def least_loaded(self) -> Replica:
        live = self.live_replicas()
        if not live:
            raise ReplicaDead("no live replicas in the pool")
        return min(live, key=lambda r: (r.load, r.index))

    def route(self, session_id: Optional[str] = None) -> Replica:
        """The replica a submission should land on: the session's
        pinned replica while it is still the same live incarnation
        (its prefix cache holds the conversation), else least-loaded —
        re-pinning the session there.  Raises ``ReplicaDead`` only
        when NO live replica exists."""
        if session_id is not None:
            with self._lock:
                pin = self._sessions.get(session_id)
                pinned = (self.replicas[pin[0]] if pin is not None
                          and pin[0] < len(self.replicas) else None)
            if pinned is not None and pinned.alive \
                    and pinned.generation == pin[1]:
                return pinned
        rep = self.least_loaded()
        if session_id is not None:
            with self._lock:
                self._sessions.pop(session_id, None)
                self._sessions[session_id] = (rep.index, rep.generation)
                while len(self._sessions) > self._SESSION_CAP:
                    self._sessions.pop(next(iter(self._sessions)))
        return rep

    def acquire(self) -> Replica:
        """Lease the least-loaded live replica (its load rises so
        routing steers around it until ``release``)."""
        rep = self.least_loaded()
        with rep._cond:
            rep.leases += 1
        return rep

    def release(self, rep: Replica) -> None:
        with rep._cond:
            rep.leases = max(0, rep.leases - 1)

    @contextlib.contextmanager
    def checkout(self):
        rep = self.acquire()
        try:
            yield rep
        finally:
            self.release(rep)

    # --- submission ------------------------------------------------------
    def submit(self, request: Union[Request, Sequence[int]],
               max_new_tokens: Optional[int] = None, *,
               deadline: Optional[float] = None,
               priority: int = 0,
               session_id: Optional[str] = None) -> PoolHandle:
        rep = self.route(session_id)
        if not isinstance(request, Request):
            request = Request(
                prompt=[int(t) for t in request],
                max_new_tokens=(rep.server.config.output_len
                                if max_new_tokens is None
                                else max_new_tokens),
                deadline=(deadline if deadline is not None
                          else rep.server.config.deadline),
                priority=priority)
        return rep.submit(request)

    # --- load / backpressure signals -------------------------------------
    def depth(self) -> int:
        """In-flight requests across live replicas (queued + admitted +
        leases) — the gateway's bounded-queue signal."""
        return sum(r.load for r in self.live_replicas())

    def predicted_wait(self, rep: Optional[Replica] = None) -> float:
        """Seconds of prefill work already queued ahead of a new
        arrival on ``rep`` (default: the replica routing would pick),
        from the replica's calibrated perf model — the estimate the
        gateway feeds into the shared ``deadline_impossible`` edge
        rejection.  0.0 when no perf model is wired."""
        if rep is None:
            rep = self.least_loaded()
        cal = rep.server.engine._calibrator
        if cal is None:
            return 0.0
        wait = 0.0
        for r in rep.server.engine.queue.snapshot():
            wait += float(cal.t_prefill(r.prompt_len, r.prompt_len))
        return wait

    def admission_estimate(self, prompt_len: int) -> float:
        """Predicted TTFT were a ``prompt_len`` request submitted right
        now: queued prefill backlog plus its own prefill."""
        try:
            rep = self.least_loaded()
        except ReplicaDead:
            return float("inf")
        cal = rep.server.engine._calibrator
        own = (float(cal.t_prefill(prompt_len, prompt_len))
               if cal is not None else 0.0)
        return self.predicted_wait(rep) + own

    # --- introspection ---------------------------------------------------
    def health(self) -> dict:
        self._heartbeats.sweep(time.perf_counter())
        beating = set(self._heartbeats.alive_workers())
        reps = []
        worst = "ok"
        for r in self.replicas:
            entry = {"index": r.index, "alive": r.alive,
                     "driver_alive": r.driver_alive,
                     "driver_stalled": r.alive and r.index not in beating,
                     "generation": r.generation, "load": r.load,
                     "error": r.error}
            if r.alive:
                entry["pending"] = r.server.pending
                entry["active"] = r.server.active
                # the replica's graceful-degradation rung over the
                # engine's sliding pressure window (core.placement)
                rung = r.server.stats.degradation()
                entry["degradation"] = rung
                if DEGRADATION_LADDER.index(rung) \
                        > DEGRADATION_LADDER.index(worst):
                    worst = rung
            reps.append(entry)
        n_alive = sum(r.alive for r in self.replicas)
        status = ("down" if not n_alive
                  else "degraded" if (n_alive < len(self.replicas)
                                      or worst != "ok")
                  else "ok")
        return {"status": status, "degradation": worst, "replicas": reps,
                "queue_depth": self.depth(), "respawns": self.respawns}

    def stats(self) -> List[dict]:
        """Per-replica EngineStats snapshots (live replicas only)."""
        out = []
        for r in self.replicas:
            if not r.alive:
                continue
            snap = r.server.stats.snapshot()
            snap["replica"] = r.index
            snap["generation"] = r.generation
            snap["listener_errors"] = r.listener_errors
            out.append(snap)
        return out

    # --- chaos / shutdown ------------------------------------------------
    def inject_fault(self, index: int,
                     exc: Optional[BaseException] = None) -> None:
        self.replicas[index].inject_fault(exc)

    def shutdown(self) -> None:
        with self._lock:
            self._closing = True
            reps = list(self.replicas)
        for r in reps:
            r.stop()

    def __enter__(self) -> "EngineReplicaPool":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()
