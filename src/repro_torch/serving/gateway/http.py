"""Async HTTP/SSE front door over an ``EngineReplicaPool``.

Pure stdlib ``asyncio`` streams — no FastAPI/uvicorn dependency — so
the gateway runs anywhere the engine does.  Three endpoints:

  * ``POST /v1/chat`` — submit a request, stream tokens back as
    Server-Sent Events.  JSON body::

        {"prompt": [1, 2, 3],        # token ids (required)
         "max_new_tokens": 16,       # optional
         "deadline": 0.5,            # optional TTFT SLO, seconds
         "priority": 1,              # optional admission priority
         "session_id": "conv-42"}    # optional session affinity

    ``session_id`` pins the conversation to the replica that served
    its first turn, so follow-up prompts hit that engine's prefix
    cache; a dead pin falls back to least-loaded routing.

    Response is ``text/event-stream``: one ``data: {"token": t,
    "index": i}`` event per token, then a terminal ``data: {"done":
    true, "error": null, ...}`` event.  The connection closes after
    the terminal event (``Connection: close`` framing).

  * ``GET /health`` — replica liveness, per-replica load and the pool
    queue depth (200 while any replica lives, 503 when none does).

  * ``GET /metrics`` — Prometheus text format (see ``metrics.py``).

Admission backpressure runs *before* submission, at the edge:

  * pool depth >= ``max_queue_depth`` → **503** (bounded gateway
    queue; overload sheds here instead of growing TTFT inside the
    engine);
  * a request deadline that is already impossible given the pool's
    predicted wait (queued prefill backlog + own prefill, from the
    replica's calibrated perf model) → **429**, via the same
    ``repro_torch.core.placement.deadline_impossible`` predicate the
    engine's admission uses.

Port of ``repro/serving/gateway/http.py``.
"""
from __future__ import annotations

import asyncio
import collections
import json
import threading
import time
from typing import Callable, Dict, Optional, Tuple

from repro_torch.core import placement
from repro_torch.serving.gateway.metrics import render_prometheus
from repro_torch.serving.gateway.pool import EngineReplicaPool, ReplicaDead

_STATUS = {200: "200 OK", 400: "400 Bad Request", 404: "404 Not Found",
           405: "405 Method Not Allowed", 429: "429 Too Many Requests",
           500: "500 Internal Server Error",
           503: "503 Service Unavailable"}
_MAX_BODY = 1 << 20                        # 1 MiB request-body cap


class HTTPGateway:
    """The asyncio server.  ``start()`` binds (port 0 = ephemeral;
    the bound port lands on ``self.port``), ``serve_forever()`` runs
    until cancelled, ``stop()`` closes the listener."""

    def __init__(self, pool: EngineReplicaPool, *, host: str = "127.0.0.1",
                 port: int = 8080, max_queue_depth: int = 64) -> None:
        self.pool = pool
        self.host = host
        self.port = port
        self.max_queue_depth = max_queue_depth
        self.counters: Dict[str, int] = {
            "requests": 0, "streams": 0, "shed_429": 0, "shed_503": 0,
            "cancelled": 0, "errors": 0}
        # the degradation ladder's final rung is gateway-side: recent
        # shed (503) timestamps over a sliding window, merged into
        # /health alongside the per-replica engine rungs
        self.shed_window = 5.0
        self._shed_times: collections.deque = collections.deque()
        self._server: Optional[asyncio.AbstractServer] = None

    # --- lifecycle -------------------------------------------------------
    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle_connection, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]

    async def serve_forever(self) -> None:
        if self._server is None:
            await self.start()
        async with self._server:
            await self._server.serve_forever()

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    # --- connection handling ---------------------------------------------
    async def _handle_connection(self, reader: asyncio.StreamReader,
                                 writer: asyncio.StreamWriter) -> None:
        try:
            request = await self._read_request(reader)
            if request is None:
                return
            method, path, body = request
            if path.startswith("/v1/chat"):
                if method != "POST":
                    await self._respond_json(writer, 405,
                                             {"error": "POST required"})
                else:
                    await self._handle_chat(reader, writer, body)
            elif path.startswith("/health"):
                await self._handle_health(writer)
            elif path.startswith("/metrics"):
                await self._handle_metrics(writer)
            else:
                await self._respond_json(writer, 404,
                                         {"error": f"no route {path}"})
        except (ConnectionError, asyncio.IncompleteReadError,
                asyncio.TimeoutError):
            pass                            # client hung up mid-exchange
        except Exception as exc:
            self.counters["errors"] += 1
            try:
                await self._respond_json(writer, 500, {"error": str(exc)})
            except Exception:
                pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:
                pass

    @staticmethod
    async def _read_request(reader: asyncio.StreamReader
                            ) -> Optional[Tuple[str, str, bytes]]:
        line = await reader.readline()
        if not line:
            return None
        parts = line.decode("latin-1").split()
        if len(parts) < 2:
            return None
        method, path = parts[0].upper(), parts[1]
        headers = {}
        while True:
            h = await reader.readline()
            if h in (b"\r\n", b"\n", b""):
                break
            key, _, value = h.decode("latin-1").partition(":")
            headers[key.strip().lower()] = value.strip()
        n = min(int(headers.get("content-length", 0) or 0), _MAX_BODY)
        body = await reader.readexactly(n) if n else b""
        return method, path, body

    # --- responses -------------------------------------------------------
    async def _respond_json(self, writer: asyncio.StreamWriter, status: int,
                            payload: dict, *,
                            extra_headers: str = "") -> None:
        body = json.dumps(payload).encode()
        await self._respond_raw(writer, status, body, "application/json",
                                extra_headers=extra_headers)

    async def _respond_raw(self, writer: asyncio.StreamWriter, status: int,
                           body: bytes, ctype: str, *,
                           extra_headers: str = "") -> None:
        head = (f"HTTP/1.1 {_STATUS[status]}\r\n"
                f"Content-Type: {ctype}\r\n"
                f"Content-Length: {len(body)}\r\n"
                f"Connection: close\r\n{extra_headers}\r\n")
        writer.write(head.encode() + body)
        await writer.drain()

    # --- /v1/chat --------------------------------------------------------
    async def _handle_chat(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter,
                           body: bytes) -> None:
        try:
            payload = json.loads(body.decode() or "{}")
            prompt = payload["prompt"]
            if not isinstance(prompt, list) or not prompt \
                    or not all(isinstance(t, int) for t in prompt):
                raise ValueError("prompt must be a non-empty list of "
                                 "token ids")
        except (KeyError, ValueError, json.JSONDecodeError) as exc:
            await self._respond_json(writer, 400, {"error": str(exc)})
            return
        max_new = payload.get("max_new_tokens")
        deadline = payload.get("deadline")
        priority = int(payload.get("priority", 0))
        session_id = payload.get("session_id")
        if session_id is not None:
            session_id = str(session_id)

        # --- edge backpressure (before any engine state is touched) ---
        depth = self.pool.depth()
        if depth >= self.max_queue_depth:
            self.counters["shed_503"] += 1
            self._shed_times.append(time.perf_counter())
            await self._respond_json(
                writer, 503,
                {"error": "gateway queue full", "queue_depth": depth,
                 "max_queue_depth": self.max_queue_depth},
                extra_headers="Retry-After: 1\r\n")
            return
        if deadline is not None:
            predicted = self.pool.admission_estimate(len(prompt))
            if placement.deadline_impossible(elapsed=0.0,
                                             deadline=float(deadline),
                                             predicted_ttft=predicted):
                self.counters["shed_429"] += 1
                await self._respond_json(
                    writer, 429,
                    {"error": f"deadline {deadline}s impossible: "
                              f"predicted wait + prefill is "
                              f"{predicted:.4f}s",
                     "predicted_ttft": predicted},
                    extra_headers="Retry-After: 1\r\n")
                return

        try:
            handle = self.pool.submit(prompt, max_new,
                                      deadline=deadline, priority=priority,
                                      session_id=session_id)
        except ReplicaDead as exc:
            self.counters["shed_503"] += 1
            await self._respond_json(writer, 503, {"error": str(exc)})
            return
        self.counters["requests"] += 1

        # --- SSE stream: driver thread -> asyncio queue -> socket -----
        loop = asyncio.get_running_loop()
        events: asyncio.Queue = asyncio.Queue()
        handle.add_listener(
            lambda ev: loop.call_soon_threadsafe(events.put_nowait, ev))
        writer.write(b"HTTP/1.1 200 OK\r\n"
                     b"Content-Type: text/event-stream\r\n"
                     b"Cache-Control: no-cache\r\n"
                     b"Connection: close\r\n\r\n")
        await writer.drain()
        t0 = time.perf_counter()
        ttft: Optional[float] = None
        index = 0
        # client-disconnect watcher: an SSE consumer sends no further
        # bytes, so this read only completes when the peer hangs up
        # (EOF) or resets — either way the stream is dead and the
        # request must be aborted instead of generating into the void
        hangup = asyncio.ensure_future(reader.read(1))
        try:
            while True:
                get = asyncio.ensure_future(events.get())
                done, _ = await asyncio.wait(
                    {get, hangup}, return_when=asyncio.FIRST_COMPLETED)
                if get not in done:
                    get.cancel()
                    raise ConnectionResetError("SSE client disconnected")
                kind, value = get.result()
                if kind == "token":
                    if ttft is None:
                        ttft = time.perf_counter() - t0
                    event = {"token": value, "index": index}
                    index += 1
                else:
                    event = {"done": True, "request_id": handle.request_id,
                             "replica": handle.replica_index, "error": value,
                             "tokens": index,
                             "ttft_ms": None if ttft is None else 1e3 * ttft}
                writer.write(f"data: {json.dumps(event)}\n\n".encode())
                await writer.drain()          # ConnectionError on hang-up
                if kind == "done":
                    break
        except ConnectionError:
            # free the engine-side resources the dead client was
            # holding (slot/pool pages/queue position)
            if handle.cancel():
                self.counters["cancelled"] += 1
            raise
        finally:
            if not hangup.done():
                hangup.cancel()
        self.counters["streams"] += 1

    # --- /health ---------------------------------------------------------
    async def _handle_health(self, writer: asyncio.StreamWriter) -> None:
        health = self.pool.health()
        # merge the ladder's gateway-side rung: recent 503 shedding is
        # the most severe degradation level short of "down"
        now = time.perf_counter()
        while self._shed_times and now - self._shed_times[0] \
                > self.shed_window:
            self._shed_times.popleft()
        if self._shed_times:
            health["degradation"] = "shed"
            if health["status"] == "ok":
                health["status"] = "degraded"
        health["gateway"] = {"max_queue_depth": self.max_queue_depth,
                             **self.counters}
        status = 200 if health["status"] in ("ok", "degraded") else 503
        await self._respond_json(writer, status, health)

    # --- /metrics --------------------------------------------------------
    async def _handle_metrics(self, writer: asyncio.StreamWriter) -> None:
        text = render_prometheus(self.pool, self.counters)
        await self._respond_raw(writer, 200, text.encode(),
                                "text/plain; version=0.0.4")


def serve_in_thread(pool: EngineReplicaPool, *, host: str = "127.0.0.1",
                    port: int = 0, max_queue_depth: int = 64
                    ) -> Tuple[HTTPGateway, Callable[[], None]]:
    """Run a gateway on a background event-loop thread (tests, the
    chip smoke phase and the CLI smoke test use this).  Returns the bound
    gateway (``gateway.port`` is the real port) and a ``stop()``
    callable that tears the loop down."""
    gateway = HTTPGateway(pool, host=host, port=port,
                          max_queue_depth=max_queue_depth)
    loop = asyncio.new_event_loop()
    started = threading.Event()
    startup_error: list = []

    def _run() -> None:
        asyncio.set_event_loop(loop)
        try:
            loop.run_until_complete(gateway.start())
        except Exception as exc:
            startup_error.append(exc)
            started.set()
            return
        started.set()
        try:
            loop.run_forever()
        finally:
            loop.run_until_complete(loop.shutdown_asyncgens())
            loop.close()

    thread = threading.Thread(target=_run, name="gateway-http", daemon=True)
    thread.start()
    started.wait(timeout=30.0)
    if startup_error:
        raise startup_error[0]

    def stop() -> None:
        async def _close() -> None:
            await gateway.stop()
        try:
            asyncio.run_coroutine_threadsafe(_close(), loop).result(10.0)
        except Exception:
            pass
        loop.call_soon_threadsafe(loop.stop)
        thread.join(timeout=10.0)

    return gateway, stop
