"""Run one cell of the benchmark of ``repro_torch`` once.

    python3 portbench/run.py --workload internlm2-20b.offload-chat \
        --seed 1234 --seconds 30 --trace 0

Prints, as the last line of standard output, one JSON object with
``correct``, ``attempted``, ``failed``, ``metrics``, ``device`` (and
``breakdown`` with ``--trace 1``), and last ``checks``: each number the
check compared, beside its limit (also the last lines of standard
error).  Exits non-zero, printing no result, without a CUDA card or
with fewer cards than the cell asks for.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# one process with few threads: the host tier's workers parallelise
# over rows, so BLAS inside each stays on one thread
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_var] = "1"
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (the part before the first
    dot, compared whole) is a JAX package or the JAX reference package."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> str:
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout else ""
    except (OSError, subprocess.TimeoutExpired):
        return ""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from portbench.harness import bench, spec

    bench_json = spec.load_benchmark(ROOT)
    cell = spec.find_cell(bench_json, args.workload)
    import torch
    if not torch.cuda.is_available():
        print("portbench: no CUDA device; the benchmark runs on the card",
              file=sys.stderr)
        return 3
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"portbench: {cell['name']} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 3

    out = bench.run(cell, seed=args.seed, seconds=args.seconds,
                    traced=bool(args.trace), device="cuda",
                    t_start=T_START)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 4

    record = out["record"]
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": int(cell["chips"]),
              "memory_peak_bytes": int(out["memory_peak_bytes"])}
    if args.trace:
        device["busy_s"] = record["trace"]["busy_s"]
        device["window_s"] = record["trace"]["window_s"]
    card = power_limit()
    record["card"] = card
    metrics = spec.read_metrics(
        spec.metrics_for(bench_json, cell["name"], bool(args.trace)),
        record)
    result = {"correct": bool(out["correct"]),
              "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": device}
    if args.trace:
        result["breakdown"] = out["breakdown"]
    result["checks"] = out["checks"]
    print(f"[portbench] card: {card}; metrics: {json.dumps(metrics)}",
          file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
