"""Find a cell's pieces by name: ``BENCHMARK.json`` at the root of the
checkout, ``configs/<config>.json``, ``traffic/<mix>.json``,
``checks/<workload>.json`` and ``metrics/<metric>.py`` under this
benchmark's folder.

A new configuration, traffic mix or per-layer metric is a new file and
an entry in ``BENCHMARK.json``; nothing here changes for it.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_benchmark(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"no BENCHMARK.json at {root}")
    return json.loads(path.read_text())


def find_cell(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                   f"{[c['name'] for c in bench['workloads']]}")


def load_config(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    return json.loads((bench_dir / "configs" / f"{name}.json").read_text())


def load_traffic(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    return json.loads((bench_dir / "traffic" / f"{name}.json").read_text())


def load_check(workload: str, bench_dir: Path = BENCH_DIR) -> dict:
    """``checks/<workload>.json``: the numbers the cell's check compares,
    their limits, and the size of its sample."""
    return json.loads((bench_dir / "checks" / f"{workload}.json")
                      .read_text())


def metrics_for(bench: dict, cell: str, trace: bool) -> List[dict]:
    """The metrics a run of ``cell`` reports: its end-to-end metrics with
    ``trace`` off, its per-layer metrics with it on.  A metric without a
    ``workloads`` key belongs to every cell (a per-layer one to every
    cell that reports the end-to-end metric it moves)."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell]) and m["moves"] in names]


def load_reader(name: str, bench_dir: Path = BENCH_DIR
                ) -> Callable[[dict], Optional[float]]:
    """``metrics/<name>.py``'s ``read(record) -> number | None``."""
    path = bench_dir / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(metrics: List[dict], record: dict,
                 bench_dir: Path = BENCH_DIR) -> Dict[str, dict]:
    """Each metric's reader over the run's record; a reader that finds
    nothing to read returns None and the metric is left out."""
    out = {}
    for m in metrics:
        value = load_reader(m["name"], bench_dir)(record)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
