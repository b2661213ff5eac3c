"""End-to-end online-serving driver of the port.

Serves a model through the scheduler-driven ``InferenceServer`` on the
card: requests come from a paper workload trace (``--workload``) or the
synthetic default, and Algorithm 1 picks the execution strategy every
iteration.  By default the architecture is reduced to a small geometry;
``--published`` serves it at its published width (``--layers`` then cuts
depth only).  Weights are random, from ``--seed``.

    python -m repro_torch.launch.serve --arch llama3.1-8b \
        --requests 16 --device-slots 2 --host-slots 6
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

from repro_torch.configs import get_config
from repro_torch.models import check_supported, init_params
from repro_torch.serving import InferenceServer, ServerConfig
from repro_torch.serving.engine import resolve_device
from repro_torch.serving.workloads import WORKLOADS


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.1-8b")
    ap.add_argument("--published", action="store_true",
                    help="serve the architecture at its published width "
                         "(bf16); --layers, when given, cuts depth")
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--layers", type=int, default=None,
                    help="depth (default 4 reduced, all layers published)")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--output-len", type=int, default=24)
    ap.add_argument("--device-slots", type=int, default=4)
    ap.add_argument("--host-slots", type=int, default=8)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--platform", default="h100",
                    help="platform backing the analytic perf model")
    ap.add_argument("--perf-model", default="analytic",
                    help="perf-model spec feeding Algorithm 1: analytic | "
                         "analytic:<platform>")
    ap.add_argument("--workload", default=None,
                    choices=sorted(WORKLOADS) + ["synthetic"],
                    help="paper trace driving request generation "
                         "(default: synthetic fixed-length)")
    ap.add_argument("--arrival-rate", type=float, default=None,
                    help="Poisson arrivals in req/s (default: closed loop)")
    ap.add_argument("--host-workers", type=int, default=0,
                    help="host-attention worker threads per job "
                         "(0 = auto: cpu_count - 1)")
    ap.add_argument("--no-offload", action="store_true")
    ap.add_argument("--no-stream", action="store_true",
                    help="suppress the per-token stream of request 0")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch attention)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    base = get_config(args.arch)
    if args.published:
        cfg = base
        if args.layers is not None:
            cfg = dataclasses.replace(
                cfg, num_layers=args.layers,
                name=f"{cfg.name}-{args.layers}L")
    else:
        cfg = base.reduced(layers=args.layers or 4, d_model=args.d_model,
                           vocab=512)
    # an architecture the port cannot run yet (Jamba's MoE FFN) fails here
    # with the ROADMAP item that brings it, before any device is touched
    check_supported(cfg)
    device = resolve_device(args.device)
    scfg = ServerConfig(
        device_slots=args.device_slots, host_slots=args.host_slots,
        cache_len=args.cache_len,
        enable_offload=not args.no_offload, host_workers=args.host_workers,
        device=str(device), platform=args.platform,
        perf_model=args.perf_model,
        workload=None if args.workload in (None, "synthetic")
        else args.workload,
        num_requests=args.requests, arrival_rate=args.arrival_rate,
        prompt_len=args.prompt_len, output_len=args.output_len,
        seed=args.seed)
    print(f"serving {cfg.name}: {cfg.param_count() / 1e6:.1f}M params on "
          f"{device}; device_slots={scfg.device_slots} "
          f"host_slots={scfg.host_slots} offload={scfg.enable_offload} "
          f"workload={scfg.workload or 'synthetic'} "
          f"perf_model={scfg.perf_model}:{scfg.platform}")
    params = init_params(cfg, seed=args.seed, device=device)

    t0 = time.time()
    with InferenceServer(cfg, params, scfg) as server:
        reqs = scfg.build_requests(vocab=cfg.vocab_size)
        if args.no_stream or args.arrival_rate:
            handles = server.serve(reqs,
                                   realtime=args.arrival_rate is not None)
        else:
            handles = [server.submit(r) for r in reqs]
            print("request 0 stream: ", end="", flush=True)
            for tok in handles[0].tokens():
                print(tok, end=" ", flush=True)
            print()
            server.run_until_idle()
        stats = server.stats
    wall = time.time() - t0

    done = [h.request for h in handles]
    failed = [r for r in done if r.failed]
    lats = [r.per_token_latency() for r in done if r.per_token_latency()]
    print(f"finished {len(done)} requests ({len(failed)} rejected) in "
          f"{wall:.2f}s")
    print(f"tokens: device={stats.device_tokens} host={stats.host_tokens} "
          f"-> {(stats.device_tokens + stats.host_tokens) / wall:.1f} tok/s")
    print(f"strategy decisions: {stats.strategy_counts}")
    if stats.prediction_error is not None:
        print(f"scheduling accuracy ({stats.perf_model_spec}): predicted "
              f"{stats.predicted_time:.3f}s vs observed "
              f"{stats.observed_time:.3f}s "
              f"(err={100 * stats.prediction_error:.0f}%)")
    if lats:
        print(f"avg per-token latency: {np.mean(lats) * 1e3:.1f} ms")
    if stats.ttft_p50 is not None:
        print(f"TTFT p50/p95: {stats.ttft_p50 * 1e3:.1f}/"
              f"{stats.ttft_p95 * 1e3:.1f} ms")
    print(f"occupancy device={stats.device_occupancy:.2f}/"
          f"{scfg.device_slots} host={stats.host_occupancy:.2f}/"
          f"{scfg.host_slots}; prefill shapes {stats.prefill_compilations}")
    if stats.host_busy_time:
        print(f"host attention busy: {stats.host_busy_time:.2f}s "
              f"({100 * stats.host_busy_time / wall:.0f}% of wall)")
    if failed:
        raise SystemExit(f"{len(failed)} requests were rejected: "
                         f"{failed[0].error}")


if __name__ == "__main__":
    main()
