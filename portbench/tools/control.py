"""The check's two readings for a cell, on the card: for each seed, one
run of the cell at its own load (the program's reading over its sample,
and its verdict), then the control -- the reference in int8 put in the
program's place -- over the same prompts and served tokens, judged by
the cell's own limits (``checks/<cell>.json``) as the program is.

    python3 portbench/tools/control.py --workload internlm2-20b.offload-chat \
        --seeds 101 202 303 --seconds 51

Prints one JSON line a seed; ``control_correct`` has to read false.  Not
run by the benchmark's runs.
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
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args()
    import torch
    from portbench.harness import bench, check, spec
    from portbench.harness.weights import plain_weights
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    cell = spec.find_cell(spec.load_benchmark(ROOT), args.workload)
    config = spec.load_config(cell["config"])
    check_cfg = spec.load_check(cell["name"])
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = bench.run(cell, seed=seed, seconds=args.seconds, traced=False,
                        device="cuda", t_start=t0)
        t1 = time.perf_counter()
        ctl = check.control_gap(config, plain_weights(out["params"]),
                                out["sample"])
        ctl_checks, ctl_ok = check.judge(check_cfg, ctl["control"])
        print(json.dumps({
            "workload": cell["name"], "seed": seed, "correct": out["correct"],
            "control_correct": ctl_ok, "control_checks": ctl_checks,
            "program": ctl["served"], "control": ctl["control"],
            "tokens": ctl["tokens"],
            "host_requests": sum(s["host"] for s in out["sample"]),
            "later_turns": sum(s["turn"] > 0 for s in out["sample"]),
            "control_s": time.perf_counter() - t1}), flush=True)
        del out
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
