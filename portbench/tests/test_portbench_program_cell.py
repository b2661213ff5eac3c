"""The reduced cell's traced run reads the program's serving counters:
the device K/V in use and (with host rows) the host-job polls that
found the job unfinished; the metrics read from the device's trace find
nothing on the CPU."""
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench.harness import bench, small, spec  # noqa: E402


@pytest.mark.parametrize("registry,kind", [
    ("internlm2-20b", "offload-chat"), ("deepseek-moe-16b", "long-prompt")])
def test_traced_reduced_cell_reads_the_program_counters(registry, kind):
    torch.set_num_threads(1)
    torch.manual_seed(0)
    cfg, keys = small.reduced_config(registry)
    with small.fp32_caches():
        out = bench.run({"name": f"{registry}.{kind}", "config": registry,
                         "traffic": kind, "chips": 1}, seed=2**31 + 5,
                        seconds=2.0, traced=True, device="cpu",
                        t_start=time.perf_counter(), config=keys,
                        mix=small.small_mix(kind), model_cfg=cfg,
                        check_cfg=small.small_checks())
    rec = out["record"]
    c = rec["counters"]
    bench_json = spec.load_benchmark(ROOT)
    got = spec.read_metrics(bench_json["per_layer"], rec)
    assert got["kv_used_pct"]["value"] == pytest.approx(
        100.0 * c["kv_used_tokens"] / c["kv_reserved_tokens"])
    assert 0 < got["kv_used_pct"]["value"] <= 100
    assert c["kv_used_tokens"] <= c["kv_reserved_tokens"]
    if kind == "offload-chat":
        assert c["host_consumes"] > 0
        assert 0 <= got["host_late_poll_pct"]["value"] <= 100
    device = [m["name"] for m in bench_json["per_layer"]
              if m["source"] == "device_trace"]
    assert device and not set(device) & set(got)
