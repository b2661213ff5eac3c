"""Production front door: HTTP/SSE gateway over an engine replica pool.

``EngineReplicaPool`` turns N in-process ``InferenceServer`` replicas
into a crash-contained, least-loaded-routed serving backend (each
replica pumped by its own driver thread); ``HTTPGateway`` exposes the
pool over ``POST /v1/chat`` (SSE token streams), ``GET /health`` and
``GET /metrics`` (Prometheus), with queue-depth + predicted-wait
backpressure shedding overload at the edge (HTTP 429/503) before it
can blow TTFT inside the engine.  Port of ``repro/serving/gateway``.
"""
from repro_torch.serving.gateway.http import HTTPGateway, serve_in_thread
from repro_torch.serving.gateway.metrics import render_prometheus
from repro_torch.serving.gateway.pool import (EngineReplicaPool, PoolHandle,
                                              Replica, ReplicaDead)

__all__ = ["EngineReplicaPool", "HTTPGateway", "PoolHandle", "Replica",
           "ReplicaDead", "render_prometheus", "serve_in_thread"]
