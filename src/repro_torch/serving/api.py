"""Serving surface: scheduler-driven ``InferenceServer``.

    server = InferenceServer(cfg, params, ServerConfig(device_slots=2,
                                                       host_slots=6))
    handle = server.submit([5, 42, 7], max_new_tokens=16)
    for tok in handle.tokens():      # per-token streaming; drives the
        print(tok)                   # engine's continuous-batching loop

Drivers over the same continuous-batching iteration: ``step()``,
``run_until_idle()`` and ``serve(requests)`` (open-loop replay of
relative arrival offsets).  ``ServerConfig.device`` defaults to
``"cuda"``; without a card the server raises unless ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Iterable, Iterator, List, Optional, Sequence, Union

from repro_torch.core.scheduler import ApexScheduler
from repro_torch.models.config import ModelConfig
from repro_torch.serving.engine import Engine, EngineConfig, EngineStats
from repro_torch.serving.request import Phase, Request

_DRIVE_LIMIT = 1_000_000     # runaway guard for handle-driven stepping


@dataclasses.dataclass
class ServerConfig:
    """Structured serving configuration: engine + scheduler + workload."""

    # --- engine capacity -------------------------------------------------
    device_slots: int = 8
    host_slots: int = 8
    cache_len: int = 256
    page_size: int = 32
    host_pool_pages: int = 512
    max_queue: int = 1024
    enable_offload: bool = True
    host_workers: int = 0
    device: str = "cuda"
    # --- Algorithm-1 scheduler ------------------------------------------
    perf_model: str = "analytic"
    platform: str = "h100"
    host_min_ratio: float = 0.0
    max_pipeline_sub_batch: int = 256
    # --- workload --------------------------------------------------------
    workload: Optional[str] = None   # azure-conv | livebench | dolphin-r1 | osc
    num_requests: int = 12
    arrival_rate: Optional[float] = None    # req/s Poisson; None = closed loop
    prompt_len: int = 16             # synthetic length / workload prompt cap
    output_len: int = 24             # synthetic length / workload output cap
    seed: int = 0

    def engine_config(self) -> EngineConfig:
        return EngineConfig(**{f.name: getattr(self, f.name)
                               for f in dataclasses.fields(EngineConfig)})

    def build_requests(self, *, vocab: int) -> List[Request]:
        """Sample the configured workload trace (or a synthetic one),
        capped to lengths that fit this server's KV cache."""
        import numpy as np
        from repro_torch.serving import workloads
        from repro_torch.serving.request import make_synthetic_request
        prompt_cap = min(self.prompt_len, max(self.cache_len - 2, 1))
        output_cap = min(self.output_len,
                         max(self.cache_len - prompt_cap - 1, 1))
        if self.workload is None:
            rng = np.random.default_rng(self.seed)
            reqs = [make_synthetic_request(rng, prompt_len=prompt_cap,
                                           output_len=output_cap,
                                           vocab=vocab)
                    for _ in range(self.num_requests)]
            if self.arrival_rate:
                offsets = workloads.poisson_offsets(
                    rng, self.arrival_rate, self.num_requests)
                for r, a in zip(reqs, offsets):
                    r.arrival_time = a
            return reqs
        reqs = workloads.generate(
            self.workload, num_requests=self.num_requests, vocab=vocab,
            arrival_rate=self.arrival_rate, seed=self.seed)
        for r in reqs:
            r.prompt = r.prompt[:prompt_cap]
            r.max_new_tokens = min(r.max_new_tokens, output_cap)
        return reqs


class RequestHandle:
    """Streaming view of one submitted request; pulling ``tokens()``
    drives ``server.step()`` so every in-flight request advances."""

    def __init__(self, server: "InferenceServer", request: Request) -> None:
        self._server = server
        self.request = request

    @property
    def request_id(self) -> int:
        return self.request.request_id

    @property
    def phase(self) -> Phase:
        return self.request.phase

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

    def tokens(self) -> Iterator[int]:
        sent = 0
        driven = 0
        while True:
            out = self.request.output
            while sent < len(out):
                yield out[sent]
                sent += 1
            if self.request.phase == Phase.FINISHED:
                return
            if not self._server.engine.has_work:
                raise RuntimeError(
                    f"request {self.request_id} not finished but the "
                    f"engine is idle (was it submitted?)")
            self._server.step()
            driven += 1
            if driven > _DRIVE_LIMIT:
                raise RuntimeError("token stream stalled: engine made no "
                                   f"progress in {_DRIVE_LIMIT} iterations")

    def result(self) -> List[int]:
        for _ in self.tokens():
            pass
        return self.request.output

    def time_to_first_token(self) -> Optional[float]:
        return self.request.time_to_first_token()

    def per_token_latency(self) -> Optional[float]:
        return self.request.per_token_latency()


class InferenceServer:
    """Scheduler-driven serving facade over the APEX engine."""

    def __init__(self, cfg: ModelConfig, params,
                 config: Optional[ServerConfig] = None,
                 scheduler: Optional[ApexScheduler] = None) -> None:
        self.config = config or ServerConfig()
        self.engine = Engine(cfg, params, self.config.engine_config(),
                             scheduler=scheduler)
        # one engine iteration at a time: handles pulled from several
        # threads, and submit(), serialize on this lock
        self._step_lock = threading.RLock()

    def submit(self, request: Union[Request, Sequence[int]],
               max_new_tokens: Optional[int] = None, *,
               priority: int = 0) -> RequestHandle:
        """Submit a Request (or a raw token prompt); arrival is stamped
        now unless the request already carries a wall-clock stamp."""
        if not isinstance(request, Request):
            request = Request(prompt=[int(t) for t in request],
                              max_new_tokens=(self.config.output_len
                                              if max_new_tokens is None
                                              else max_new_tokens),
                              priority=priority)
        if request.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {request.max_new_tokens} "
                f"(the prefill itself emits the first token)")
        reason = Engine.prompt_reject_reason(request.prompt_len,
                                             self.config.cache_len)
        if reason is not None:
            if request.arrival_time is None:
                request.arrival_time = time.perf_counter()
            Engine.reject(request, reason)
            return RequestHandle(self, request)
        with self._step_lock:
            if len(self.engine.queue) >= self.config.max_queue:
                raise RuntimeError(f"queue full ({self.config.max_queue})")
            self.engine.submit(request)
        return RequestHandle(self, request)

    def step(self) -> None:
        """One continuous-batching iteration: admit -> Algorithm 1 ->
        dispatch (GPU_ONLY / ASYNC_OVERLAP / ASYM_PIPELINE) -> retire."""
        with self._step_lock:
            self.engine.step()

    def run_until_idle(self, *, max_iterations: int = 100000) -> EngineStats:
        it = 0
        while self.engine.has_work and it < max_iterations:
            self.step()
            it += 1
        return self.stats

    def serve(self, requests: Iterable[Request], *, realtime: bool = True,
              max_iterations: int = 1_000_000) -> List[RequestHandle]:
        """Open-loop replay: each request's ``arrival_time`` is a relative
        offset from serve start (None = immediately)."""
        order = sorted(requests, key=lambda r: r.arrival_time or 0.0)
        handles = []
        start = time.perf_counter()
        i = 0
        it = 0
        while (i < len(order) or self.engine.has_work) \
                and it < max_iterations:
            now = time.perf_counter() - start
            while i < len(order):
                offset = order[i].arrival_time or 0.0
                if realtime and offset > now:
                    break
                if len(self.engine.queue) >= self.config.max_queue:
                    break
                r = order[i]
                r.arrival_time = start + offset if realtime else None
                handles.append(self.submit(r))
                i += 1
                now = time.perf_counter() - start
            if self.engine.has_work:
                self.step()
                it += 1
            elif i < len(order):
                next_due = start + (order[i].arrival_time or 0.0)
                time.sleep(max(0.0, min(next_due - time.perf_counter(),
                                        0.01)))
        return handles

    @property
    def stats(self) -> EngineStats:
        self.engine.sync_host_stats()
        return self.engine.stats

    @property
    def pending(self) -> int:
        return len(self.engine.queue)

    @property
    def active(self) -> int:
        return (sum(r is not None for r in self.engine.slots)
                + len(self.engine.host_requests))

    def shutdown(self) -> None:
        self.engine.shutdown()

    def __enter__(self) -> "InferenceServer":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()
