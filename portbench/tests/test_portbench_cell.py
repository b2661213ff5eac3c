"""A reduced cell end to end on the port's CPU path: warm-up, window,
metrics and the check against the reference; the same run with the
served path broken underneath comes out not correct, as does the
control (the reference in int8 put in the program's place)."""
import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench.harness import bench, check, small, spec  # noqa: E402
from portbench.harness.weights import plain_weights  # noqa: E402

SEED = 2**31 + 77


def _run(registry, kind, *, traced=False, seconds=3.0, sample_tokens=0):
    # one thread: the suite runs beside other test files on every core
    torch.set_num_threads(1)
    torch.manual_seed(0)
    cfg, keys = small.reduced_config(registry)
    check_cfg = small.small_checks(sample_tokens or 32)
    with small.fp32_caches():
        out = bench.run({"name": f"{registry}.{kind}", "config": registry,
                         "traffic": kind, "chips": 1}, seed=SEED,
                        seconds=seconds, traced=traced, device="cpu",
                        t_start=time.perf_counter(), config=keys,
                        mix=small.small_mix(kind), model_cfg=cfg,
                        check_cfg=check_cfg)
    return out, check_cfg


@pytest.mark.parametrize("registry,kind", [
    ("internlm2-20b", "offload-chat"), ("internlm2-20b", "prefix-chat"),
    ("deepseek-moe-16b", "long-prompt")])
def test_reduced_cell_end_to_end(registry, kind):
    out, keys = _run(registry, kind, traced=True)
    rec = out["record"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert rec["counters"]["iterations"] > 10
    bench_json = spec.load_benchmark(ROOT)
    got = spec.read_metrics(bench_json["end_to_end"]
                            + bench_json["per_layer"], rec)
    for name in ("output_tokens_per_s", "tpot_p95_ms", "setup_s",
                 "ttft_p95_ms.closed", "tpot_p95_ms.closed",
                 "iteration_ms", "mfu.serve"):
        assert got[name]["value"] > 0, name
    assert out["checks"]["served_tokens_at_least"]["value"] >= 4
    if registry == "internlm2-20b":
        # fp32 program against the fp32 reference: the greedy tokens are
        # the reference's own best
        assert out["checks"]["mean_logit_gap"]["value"] < 1e-4
        assert out["correct"]
    if kind == "offload-chat":
        assert rec["counters"]["host_tokens"] > 0
        sc = rec["counters"]["strategy_counts"]
        assert sum(sc.values()) == rec["counters"]["iterations"]
    if kind == "prefix-chat":
        assert rec["counters"]["prefix_hit_tokens"] > 0
    tr = rec["trace"]
    assert tr["required_s"] > 0 and tr["decode_bound_s"] > 0
    assert tr["prefill_bound_s"] > 0


def _alter_tokens(monkeypatch):
    """A token altered where it is produced: the sampler's pick shifted
    by one on every row."""
    from repro_torch.serving import engine as eng
    real = eng.sample

    def sample(logits, **kw):
        return (real(logits, **kw) + 1) % logits.shape[-1]
    monkeypatch.setattr(eng, "sample", sample)


def _stale_cache(monkeypatch):
    """A step that leaves its state unchanged: decode attention reads
    the cache as it was before the step wrote this token's K/V."""
    from repro_torch.kernels import ops
    real = ops.decode_attention

    def decode_attention(q, k, v, lengths):
        return real(q, k, v, torch.clamp(lengths - 1, min=1))
    monkeypatch.setattr(ops, "decode_attention", decode_attention)


@pytest.mark.parametrize("fault", [_alter_tokens, _stale_cache])
def test_broken_served_path_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    out, keys = _run("internlm2-20b", "offload-chat", sample_tokens=96)
    assert out["checks"]["served_tokens_at_least"]["value"] >= 32
    assert out["checks"]["mean_logit_gap"]["value"] > \
        keys["limits"]["mean_logit_gap"]
    assert not out["correct"]


def test_control_is_not_correct():
    out, keys = _run("internlm2-20b", "offload-chat", sample_tokens=400)
    assert out["checks"]["served_tokens_at_least"]["value"] >= 200
    _, model_keys = small.reduced_config("internlm2-20b")
    ctl = check.control_gap(model_keys, plain_weights(out["params"]),
                            out["sample"])
    limit = keys["limits"]["mean_logit_gap"]
    assert ctl["served"]["mean_logit_gap"] <= limit
    assert ctl["control"]["mean_logit_gap"] > limit
    assert check.judge(keys, ctl["served"])[1]
    assert not check.judge(keys, ctl["control"])[1]


def test_run_refuses_without_a_card():
    proc = subprocess.run(
        [sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
         "internlm2-20b.offload-chat", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=120,
        cwd=ROOT)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_a_run_loads_no_jax_and_no_reference_package():
    code = f"""
import sys, time, importlib.util
sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]
from portbench.harness import bench, small
cfg, keys = small.reduced_config("deepseek-moe-16b")
bench.run({{"name": "x", "config": "x", "traffic": "x", "chips": 1}},
          seed=3, seconds=0.5, traced=False, device="cpu",
          t_start=time.perf_counter(), config=keys,
          mix=small.small_mix("offload-chat"), model_cfg=cfg,
          check_cfg=small.small_checks())
spec = importlib.util.spec_from_file_location(
    "portbench_run", {str(ROOT / 'portbench' / 'run.py')!r})
run = importlib.util.module_from_spec(spec)
spec.loader.exec_module(run)
print(repr(run.forbidden_modules()))
print(repr(sorted({{m.split('.')[0] for m in sys.modules}})))
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = proc.stdout.strip().splitlines()
    assert eval(lines[-2]) == []
    loaded = eval(lines[-1])
    assert "repro_torch" in loaded
    for bad in ("jax", "jaxlib", "flax", "repro"):
        assert bad not in loaded
