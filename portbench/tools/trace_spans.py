"""A traced run of one cell, on the card, read by the program's own spans
as well as the benchmark's: ``portbench/run.py --trace 1`` as the
benchmark runs it (its result line comes first), then one JSON line of
what ``harness.program_spans`` reads in the same window.

    python3 portbench/tools/trace_spans.py --workload \
        internlm2-20b.offload-chat --seed 1234 --seconds 51

The line holds the window's device idle time in parts, in % of the
window (``dispatch_idle_pct``, ``engine_idle_pct``, ``publish_idle_pct``,
the rest outside the engine step, and the idle time inside the
benchmark's own ``step`` spans), the idle time and the pageable
device-to-host copies under each span as the innermost one over them,
and the ten longest idle gaps with the benchmark's label and the
program's.  Not run by the benchmark's runs.
"""
import argparse
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


# the device-to-pageable-host copies (their names in the profiler)
D2H = "Memcpy DtoH (Device -> Pageable)"


def _seconds(ns_by_name: dict) -> dict:
    return {k: v / 1e9 for k, v in sorted(ns_by_name.items(),
                                          key=lambda kv: -kv[1])}


def readings(tl: dict, program: list) -> dict:
    """What the program's spans read in a traced window: ``tl`` as
    ``trace.device_timeline`` gives it, ``program`` as
    ``program_spans.collect``."""
    from portbench.harness import program_spans, trace
    ops = tl["ops"]
    t0, t1 = next((s, e) for n, s, e in tl["spans"] if n == "window")
    bench = [sp for sp in tl["spans"] if sp[0] != "window"]
    _, gaps = trace.busy_and_gaps(ops, t0, t1)
    within = [(s, e) for n, s, e in bench if n == "step"]
    parts = program_spans.idle_by_span(gaps, program, within)

    def pct(ns):
        return 100.0 * ns / (t1 - t0)

    innermost = program_spans.by_innermost(gaps, program)
    d2h = program_spans.by_innermost(
        [(s, e) for n, s, e in ops if n.startswith(D2H) and t0 <= s < t1],
        program)
    gaps.sort(key=lambda g: g[0] - g[1])
    return {
        "device_idle_pct": pct(parts["idle"]),
        "dispatch_idle_pct": pct(parts["dispatch"]),
        "decode_idle_pct": pct(parts["decode"]),
        "chunk_idle_pct": pct(parts["chunk"]),
        "engine_idle_pct": pct(parts["engine"]),
        "publish_idle_pct": pct(parts["publish"]),
        "outside_step_idle_pct": pct(parts["idle"] - parts["step"]),
        "bench_step_idle_pct": pct(parts["within"]),
        "idle_s_by_innermost_span": _seconds(innermost),
        "pageable_d2h_s_by_innermost_span": _seconds(d2h),
        "idle_gaps": [[trace.label_gap(bench, s, e),
                       program_spans.label_gap(program, bench, s, e),
                       (e - s) / 1e9] for s, e in gaps[:10]],
        "program_spans": len(program),
        "program_ops": sum(n.startswith(program_spans.PREFIXES)
                           for n, _, _ in ops)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    args = ap.parse_args()
    from portbench.harness import program_spans, trace

    seen = {}
    timeline = trace.device_timeline

    def device_timeline(prof):
        tl = timeline(prof)
        seen.update(tl, program=program_spans.collect(prof))
        return tl

    spec = importlib.util.spec_from_file_location(
        "portbench_run", ROOT / "portbench" / "run.py")
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    trace.device_timeline = device_timeline
    rc = run.main(["--workload", args.workload, "--seed", str(args.seed),
                   "--seconds", str(args.seconds), "--trace", "1"])
    if rc or not seen:
        return rc or 1

    print(json.dumps(dict(readings(seen, seen["program"]),
                          workload=args.workload, seed=args.seed)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
