"""End-to-end online-serving driver of the port.

Serves a model through the scheduler-driven ``InferenceServer`` on the
card: requests come from a paper workload trace (``--workload``) or the
synthetic default, and Algorithm 1 picks the execution strategy every
iteration.  The defaults are the reference's: chunked prefill (64
tokens) beside decode, the prefix cache, rebalancing, preemption with
the recompute fallback and the host-job watchdog; the ``--no-*`` flags
and ``--chunk-tokens 0`` turn them off.  Algorithm 1 runs on a measured
profile of the port's own ops by default (``--perf-model measured``:
``OfflineProfiler`` at startup, reused from ``--profile-cache`` when it
holds this model's profile).  ``--fault-plan`` injects deterministic
faults.  ``--host-kv-dtype int8`` stores the host tier's K/V in int8 and
``--cold-page-compress-after S`` compresses idle host pages.  By default
the architecture is reduced to a small geometry;
``--published`` serves it at its published width (``--layers`` then cuts
depth only).  Weights are random, from ``--seed``.

    python -m repro_torch.launch.serve --arch llama3.1-8b \
        --requests 16 --device-slots 2 --host-slots 6
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np

from repro_torch.configs import get_config, list_archs
from repro_torch.models import init_params
from repro_torch.serving import InferenceServer, ServerConfig
from repro_torch.serving.engine import check_servable, resolve_device
from repro_torch.serving.workloads import WORKLOADS


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.1-8b", choices=list_archs())
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
    ap.add_argument("--perf-model", default="measured",
                    help="perf-model spec feeding Algorithm 1: analytic | "
                         "analytic:<platform> | measured | file:<path> "
                         "(default: measured -- profile the port's ops on "
                         "the device and the host tier at startup)")
    ap.add_argument("--profile-cache", default=None,
                    help="JSON path of the measured profile: loaded when "
                         "it holds this model's, else written after "
                         "profiling")
    ap.add_argument("--workload", default=None,
                    choices=sorted(WORKLOADS) + ["synthetic"],
                    help="paper trace driving request generation "
                         "(default: synthetic fixed-length)")
    ap.add_argument("--arrival-rate", type=float, default=None,
                    help="Poisson arrivals in req/s (default: closed loop)")
    ap.add_argument("--host-workers", type=int, default=0,
                    help="host-attention worker threads per job "
                         "(0 = auto: cpu_count - 1)")
    ap.add_argument("--no-bucketed-prefill", action="store_true",
                    help="prefill each prompt alone at its own length "
                         "(turns chunking and the prefix cache off)")
    ap.add_argument("--chunk-tokens", type=int, default=64,
                    help="chunked-prefill budget per iteration while "
                         "decode is active (0 = whole-prompt prefill "
                         "before decode)")
    ap.add_argument("--no-offload", action="store_true")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="disable the cross-request prefix cache (tokens "
                         "are identical either way)")
    ap.add_argument("--prefix-cache-slots", type=int, default=2,
                    help="device-resident prefix-cache entries (0 = "
                         "host-pool-only caching)")
    ap.add_argument("--no-tier-rebalance", action="store_true",
                    help="disable host->device migration when device "
                         "slots free up")
    ap.add_argument("--no-preemption", action="store_true",
                    help="disable SLO-aware preemptive admission (urgent "
                         "requests demoting low-priority device residents "
                         "to the host tier)")
    ap.add_argument("--deadline", type=float, default=None,
                    help="TTFT deadline (seconds from arrival) stamped on "
                         "every generated request; impossible deadlines "
                         "are rejected at admission, late first tokens "
                         "count as deadline misses")
    ap.add_argument("--host-job-slack", type=float, default=8.0,
                    help="host-job watchdog deadline = predicted t_catt x "
                         "this slack (at least 0.25 s); a late job is "
                         "rerun on the engine thread")
    ap.add_argument("--no-recompute-fallback", action="store_true",
                    help="disable the watchdog's rerun and recompute-from-"
                         "scratch preemption (host faults fail the engine, "
                         "blocked swaps requeue the urgent request)")
    ap.add_argument("--fault-plan", default=None,
                    help="deterministic fault plan, e.g. "
                         "'host_stall@3x2:0.5,pool_alloc@1' (see "
                         "repro_torch.serving.faults)")
    ap.add_argument("--host-kv-dtype", default="fp32",
                    choices=["fp32", "int8"],
                    help="host KV pool storage: int8 stores quantized "
                         "pages with per-token scales and dequantizes "
                         "inside the host attention")
    ap.add_argument("--cold-page-compress-after", type=float, default=0.0,
                    help="compress a host owner's pages losslessly after "
                         "this many idle seconds (0 = never)")
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
    # an encoder has no decode to serve: refused here, before any device
    # is touched
    check_servable(cfg)
    device = resolve_device(args.device)
    scfg = ServerConfig(
        device_slots=args.device_slots, host_slots=args.host_slots,
        cache_len=args.cache_len,
        enable_offload=not args.no_offload, host_workers=args.host_workers,
        device=str(device), platform=args.platform,
        bucketed_prefill=not args.no_bucketed_prefill,
        chunk_tokens=args.chunk_tokens,
        prefix_cache=not args.no_prefix_cache,
        prefix_cache_slots=args.prefix_cache_slots,
        tier_rebalance=not args.no_tier_rebalance,
        preemption=not args.no_preemption, deadline=args.deadline,
        recompute_fallback=not args.no_recompute_fallback,
        host_job_slack=args.host_job_slack, fault_plan=args.fault_plan,
        perf_model=args.perf_model, profile_cache=args.profile_cache,
        host_kv_dtype=args.host_kv_dtype,
        cold_page_compress_after=args.cold_page_compress_after,
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
    if scfg.perf_model == "measured" and not (
            scfg.profile_cache and os.path.exists(scfg.profile_cache)):
        print("profiling the device and host tiers at startup "
              "(--profile-cache reuses a profile, --perf-model analytic "
              "skips it)...", flush=True)

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
    if stats.prefill_chunks:
        print(f"chunked prefill: {stats.prefill_chunks} chunks "
              f"({stats.chunked_prefill_tokens} tokens), "
              f"{stats.chunk_co_run_iterations} iterations co-ran with "
              "decode")
    if stats.prefix_lookups:
        print(f"prefix cache: {stats.prefix_hits}/{stats.prefix_lookups} "
              f"hits ({stats.prefix_device_hits} device rows, "
              f"{stats.prefix_host_hits} host pool), "
              f"{stats.prefix_hit_tokens} prompt tokens served")
    print(f"tier moves: {stats.migrations} migrations, "
          f"{stats.preemptions} preemptions, "
          f"{stats.preemption_recomputes} recompute preemptions; occupancy "
          f"device={stats.device_occupancy:.2f}/{scfg.device_slots} "
          f"host={stats.host_occupancy:.2f}/{scfg.host_slots}; prefill "
          f"shapes {stats.prefill_compilations}")
    if scfg.enable_offload:
        print(f"host pool ({scfg.host_kv_dtype}, "
              f"{stats.host_kv_dtype_bytes} B per element): hot "
              f"{stats.host_pool_hot_bytes} B, compressed "
              f"{stats.host_pool_compressed_bytes} B, free "
              f"{stats.host_pool_free_bytes} B; pages compressed "
              f"{stats.host_pages_compressed}, decompressed "
              f"{stats.host_pages_decompressed}")
    if stats.deadline_misses or stats.deadline_rejections:
        print(f"SLO: {stats.deadline_misses} deadline misses, "
              f"{stats.deadline_rejections} impossible-deadline "
              "rejections")
    if stats.host_fallbacks or stats.preemption_recomputes \
            or stats.cancelled or scfg.fault_plan:
        fired = (server.engine.faults.snapshot()["fired"]
                 if server.engine.faults is not None else {})
        print(f"fault tolerance: host_fallbacks={stats.host_fallbacks} "
              f"host_breaker_trips={stats.host_breaker_trips} "
              f"preemption_recomputes={stats.preemption_recomputes} "
              f"cancelled={stats.cancelled} "
              f"degradation={stats.degradation()}; faults fired "
              f"{ {k: n for k, n in fired.items() if n} }")
    if stats.host_busy_time:
        print(f"host attention busy: {stats.host_busy_time:.2f}s "
              f"({100 * stats.host_busy_time / wall:.0f}% of wall)")
    if failed:
        raise SystemExit(f"{len(failed)} requests were rejected: "
                         f"{failed[0].error}")


if __name__ == "__main__":
    main()
