"""HTTP/SSE gateway launcher of the port: the production front door.

Builds the model once, fronts ``--replicas`` engine replicas (sharing
its parameters) with the asyncio gateway, and serves::

    POST /v1/chat     SSE token stream ({"prompt": [ids], "deadline",
                      "priority", "max_new_tokens", "session_id"})
    GET  /health      replica liveness + queue depth
    GET  /metrics     Prometheus text format

    PYTHONPATH=src python -m repro_torch.launch.gateway --replicas 2 \\
        --port 8080 --max-queue-depth 64

``--smoke-test`` instead runs an in-process closed-loop client burst
against the freshly started gateway, asserts non-empty SSE streams, a
green ``/health`` and parseable ``/metrics``, then exits non-zero on
any failure.

By default the architecture is reduced to a small geometry;
``--published`` serves it at its published width (``--layers`` then
cuts depth only).  Weights are random, from ``--seed``.  Replicas run on
the card (``--device``, default ``cuda``); without a card and without
``--device cpu`` the launcher raises.  On the card the kernels are built
before the replicas' driver threads start, so no replica's first step
pays the ``nvcc`` build.

The perf-model flags mirror ``repro_torch.launch.serve``; the default
here is ``analytic`` (instant startup -- ``measured`` would profile at
every replica build, respawns included; point ``--profile-cache`` at a
shared file to profile once).

Port of ``repro/launch/gateway.py``.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import threading
import time

import numpy as np

from repro_torch.configs import get_config, list_archs
from repro_torch.models import init_params
from repro_torch.serving import InferenceServer, ServerConfig
from repro_torch.serving.engine import check_servable, resolve_device
from repro_torch.serving.gateway import EngineReplicaPool, serve_in_thread
from repro_torch.serving.gateway.client import get_json, get_text, sse_chat
from repro_torch.serving.gateway.http import HTTPGateway


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--max-queue-depth", type=int, default=64,
                    help="bounded gateway queue: submissions beyond this "
                         "in-flight depth shed with HTTP 503")
    # model / engine flags (mirroring repro_torch.launch.serve)
    ap.add_argument("--arch", default="llama3.1-8b", choices=list_archs())
    ap.add_argument("--published", action="store_true",
                    help="serve the architecture at its published width "
                         "(bf16); --layers, when given, cuts depth")
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--layers", type=int, default=None,
                    help="depth (default 4 reduced, all layers published)")
    ap.add_argument("--device-slots", type=int, default=4)
    ap.add_argument("--host-slots", type=int, default=8)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--output-len", type=int, default=24,
                    help="default max_new_tokens when a request omits it")
    ap.add_argument("--chunk-tokens", type=int, default=64)
    ap.add_argument("--host-workers", type=int, default=0,
                    help="host-attention worker threads per replica "
                         "(0 = auto: cpu_count - 1 each)")
    ap.add_argument("--host-kv-dtype", default="fp32",
                    choices=["fp32", "int8"],
                    help="host KV pool precision per replica (int8 = "
                         "quantized pages + fused-dequant host attention)")
    ap.add_argument("--cold-page-compress-after", type=float, default=0.0,
                    help="compress idle host KV pages after this many "
                         "seconds (0 = off)")
    ap.add_argument("--platform", default="h100",
                    help="platform backing the analytic perf model")
    ap.add_argument("--perf-model", default="analytic",
                    help="perf-model spec per replica: analytic | "
                         "analytic:<platform> | measured | file:<path>")
    ap.add_argument("--profile-cache", default=None,
                    help="JSON path of the measured profile: the first "
                         "replica profiles and writes it, every later "
                         "build (respawns included) loads it")
    ap.add_argument("--deadline", type=float, default=None,
                    help="default TTFT SLO stamped on requests that "
                         "omit one")
    ap.add_argument("--no-offload", action="store_true")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="disable each replica's cross-request prefix "
                         "cache (session_id routing still works, it "
                         "just stops paying off)")
    ap.add_argument("--prefix-cache-slots", type=int, default=2,
                    help="device-resident prefix-cache entries per "
                         "replica (0 = host-pool-only caching)")
    ap.add_argument("--host-job-slack", type=float, default=8.0,
                    help="host-job watchdog deadline = predicted t_catt "
                         "x this slack (floored at 0.25s)")
    ap.add_argument("--no-recompute-fallback", action="store_true",
                    help="disable the recompute fallback and "
                         "recompute-from-scratch preemption on every "
                         "replica (host faults fail the replica)")
    ap.add_argument("--fault-plan", default=None,
                    help="deterministic fault plan injected into every "
                         "replica, e.g. 'host_stall@3x2:0.5,pool_alloc@1' "
                         "(see repro_torch.serving.faults)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of every replica (default cuda; "
                         "cpu runs the plain PyTorch attention)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke-test", action="store_true",
                    help="start the gateway, run a closed-loop client "
                         "burst, assert SSE/health/metrics, exit")
    return ap


def build_pool(args: argparse.Namespace) -> EngineReplicaPool:
    base = get_config(args.arch)
    if args.published:
        cfg = base
        if args.layers is not None:
            cfg = dataclasses.replace(cfg, num_layers=args.layers,
                                      name=f"{cfg.name}-{args.layers}L")
    else:
        cfg = base.reduced(layers=args.layers or 4, d_model=args.d_model,
                           vocab=512)
    check_servable(cfg)
    device = resolve_device(args.device)
    if device.type == "cuda":
        from repro_torch.kernels import build
        build.load_all()
    params = init_params(cfg, seed=args.seed, device=device)
    scfg = ServerConfig(
        device_slots=args.device_slots, host_slots=args.host_slots,
        cache_len=args.cache_len, enable_offload=not args.no_offload,
        host_workers=args.host_workers, chunk_tokens=args.chunk_tokens,
        host_kv_dtype=args.host_kv_dtype,
        cold_page_compress_after=args.cold_page_compress_after,
        platform=args.platform, perf_model=args.perf_model,
        profile_cache=args.profile_cache, deadline=args.deadline,
        prefix_cache=not args.no_prefix_cache,
        prefix_cache_slots=args.prefix_cache_slots,
        host_job_slack=args.host_job_slack,
        recompute_fallback=not args.no_recompute_fallback,
        fault_plan=args.fault_plan, device=str(device),
        output_len=args.output_len, seed=args.seed)
    print(f"gateway model {cfg.name}: {cfg.param_count()/1e6:.1f}M params "
          f"on {device}; {args.replicas} replicas x (device_slots="
          f"{scfg.device_slots} host_slots={scfg.host_slots}) "
          f"perf_model={scfg.perf_model}:{scfg.platform}")

    def factory() -> InferenceServer:
        # each replica gets its own config copy (engines mutate knobs
        # like enable_offload for inapplicable stacks); params are
        # read-only and shared across replicas
        return InferenceServer(cfg, params, dataclasses.replace(scfg))

    return EngineReplicaPool(factory, replicas=args.replicas)


def smoke_test(pool: EngineReplicaPool, args: argparse.Namespace) -> int:
    """Closed-loop burst over real sockets; non-zero exit on any
    failed check."""
    gateway, stop = serve_in_thread(pool, host=args.host, port=0,
                                    max_queue_depth=args.max_queue_depth)
    failures = []
    try:
        host, port = args.host, gateway.port
        rng = np.random.default_rng(0)
        clients, per_client = 4, 2
        results = []
        lock = threading.Lock()

        def client_loop() -> None:
            for _ in range(per_client):
                prompt = [int(t) for t in rng.integers(0, 256, 8)]
                r = sse_chat(host, port, prompt, max_new_tokens=6)
                with lock:
                    results.append(r)

        threads = [threading.Thread(target=client_loop)
                   for _ in range(clients)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180.0)
        wall = time.perf_counter() - t0
        ok = [r for r in results if r["status"] == 200 and not r["error"]]
        if len(results) != clients * per_client:
            failures.append(f"only {len(results)}/{clients * per_client} "
                            f"requests returned")
        if not ok or any(not r["tokens"] for r in ok):
            failures.append("empty SSE stream(s) in the burst")
        health = get_json(host, port, "/health")
        if health["status"] != 200 or health["body"]["status"] != "ok":
            failures.append(f"/health not green: {health}")
        metrics = get_text(host, port, "/metrics")
        if metrics["status"] != 200 \
                or "apex_replica_up" not in metrics["body"] \
                or "apex_engine_iterations_total" not in metrics["body"]:
            failures.append("/metrics missing expected families")
        ttfts = sorted(r["ttft_s"] for r in ok if r["ttft_s"] is not None)
        print(f"smoke burst: {len(ok)}/{len(results)} streams ok in "
              f"{wall:.2f}s; TTFT p95 "
              f"{1e3 * ttfts[int(0.95 * (len(ttfts) - 1))]:.0f}ms"
              if ttfts else "smoke burst: no TTFT samples")
    finally:
        stop()
    if failures:
        print("GATEWAY SMOKE FAILED:")
        for f in failures:
            print(f"  {f}")
        return 1
    print("gateway smoke OK: SSE streams non-empty, /health green, "
          "/metrics parseable")
    return 0


def main() -> None:
    args = build_parser().parse_args()
    pool = build_pool(args)
    try:
        if args.smoke_test:
            sys.exit(smoke_test(pool, args))
        import asyncio
        gateway = HTTPGateway(pool, host=args.host, port=args.port,
                              max_queue_depth=args.max_queue_depth)

        async def run() -> None:
            await gateway.start()
            print(f"listening on http://{args.host}:{gateway.port}  "
                  f"(POST /v1/chat | GET /health | GET /metrics)")
            await gateway.serve_forever()

        try:
            asyncio.run(run())
        except KeyboardInterrupt:
            print("shutting down")
    finally:
        pool.shutdown()


if __name__ == "__main__":
    main()
