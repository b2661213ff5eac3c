"""Find an open-loop mix's knee on the card: the cell's traffic at each
of several session rates, one window each on the same weights, with the
backlog at the window's start and end.  The knee is the highest rate at
which the backlog does not grow.

    python3 portbench/tools/sweep.py --workload internlm2-20b.prefix-chat \
        --rates 0.5 1 2 4 --seconds 30

Prints one JSON line a rate.  Not run by the benchmark's runs.
"""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=4242)
    args = ap.parse_args()
    import torch
    from portbench.harness import bench, spec, timeline
    from portbench.harness.weights import make_params
    if not torch.cuda.is_available():
        print("sweep: no CUDA device", file=sys.stderr)
        return 3
    cell = spec.find_cell(spec.load_benchmark(ROOT), args.workload)
    config = spec.load_config(cell["config"])
    cfg = bench.model_config(config)
    params = make_params(cfg, seed=args.seed, device="cuda")
    for rate in args.rates:
        mix = dict(spec.load_traffic(cell["traffic"]), rate_per_s=rate)
        out = bench.run(cell, seed=args.seed, seconds=args.seconds,
                        traced=False, device="cuda",
                        t_start=time.perf_counter(), mix=mix,
                        check_requests=False, params=params)
        rec = out["record"]
        reqs = rec["requests"]
        t_open, t_close = rec["t_open"], rec["t_close"]
        c = rec["counters"]
        print(json.dumps({
            "rate_per_s": rate,
            "in_flight_and_queued_at_open_and_close": rec["backlog"],
            "due_in_window": sum(1 for due, _ in reqs
                                 if t_open <= due < t_close),
            "ttft_p95_s": timeline.percentile(
                timeline.ttfts(reqs, t_open, t_close), 95),
            "tpot_p95_s": timeline.percentile(
                timeline.tpots(reqs, t_open, t_close), 95),
            "tokens_per_s": timeline.tokens_in(reqs, t_open, t_close)
            / rec["window_s"],
            "host_tokens": c.get("host_tokens"),
            "device_tokens": c.get("device_tokens"),
            "iterations": c.get("iterations"),
            "strategy_counts": c.get("strategy_counts")}), flush=True)
        del out
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
