"""The port's serving simulator against the JAX reference's on the CPU.

  * for every scheduler (``gpu_only``, ``neo``, ``apex``, ``apex+``) on
    the ``a10`` and ``t4`` platforms, over the reference's ``osc`` traces,
    the port's ``SimResult`` equals the reference's: requests finished,
    output tokens and strategy counts exactly, makespan, throughput and
    latencies to a relative 1e-12; also with the int8 host pool and with
    the prefix cache off;
  * the port's copies of the reference's simulator tests
    (tests/test_simulator.py);
  * on the port's ``h100`` (the analytic h100 model, not a measurement):
    conservation of tokens, and a model that does not fit raises.
"""
import pytest

from repro.configs import get_config as ref_get_config
from repro.serving import workloads as ref_workloads
from repro.serving.simulator import ServingSimulator as RefSimulator
from repro.serving.simulator import SimConfig as RefSimConfig
from repro_torch.configs import get_config
from repro_torch.serving import workloads
from repro_torch.serving.request import Request
from repro_torch.serving.simulator import (ServingSimulator, SimConfig,
                                           SimResult, compare_schedulers)

SCHEDULERS = ("gpu_only", "neo", "apex", "apex+")
# the reference's tests put llama3.1-8b on the A10 and llama2-7b on the T4
# (llama3.1-8b's 16 GB of weights leave no KV room on a 16 GB card)
PLATFORM_MODELS = {"a10": "llama3.1-8b", "t4": "llama2-7b"}
VARIANTS = {"defaults": {}, "int8": dict(host_kv_dtype="int8"),
            "no-prefix": dict(prefix_cache=False)}
REL = 1e-12


def _trace(cfg, n=40, **kw):
    return lambda: workloads.generate("osc", num_requests=n,
                                      vocab=cfg.vocab_size, seed=3, **kw)


def _ref_trace(name, n=40, **kw):
    vocab = ref_get_config(name).vocab_size
    return ref_workloads.generate("osc", num_requests=n, vocab=vocab,
                                  seed=3, **kw)


def _port_copy(ref_reqs):
    return [Request(prompt=list(r.prompt), max_new_tokens=r.max_new_tokens,
                    arrival_time=r.arrival_time, deadline=r.deadline,
                    priority=r.priority) for r in ref_reqs]


def _assert_equal(mine: SimResult, ref) -> None:
    assert mine.name == ref.name
    assert mine.requests_finished == ref.requests_finished
    assert mine.total_output_tokens == ref.total_output_tokens
    assert mine.host_tokens == ref.host_tokens
    assert mine.device_tokens == ref.device_tokens
    assert mine.strategy_iterations == ref.strategy_iterations
    for field in ("makespan", "throughput", "avg_per_token_latency",
                  "p99_per_token_latency"):
        assert getattr(mine, field) == pytest.approx(getattr(ref, field),
                                                     rel=REL, abs=0.0), field


# gpu_only on the T4 stalls in both packages: the trace's longest prompt
# (3340 tokens) exceeds llama2-7b's 3286 tokens of device KV room, the
# admission cap shortens only its output, and the FIFO head then blocks
# every later request until max_iterations (2M iterations, ~3 min a run);
# both packages are compared over this many iterations there instead
STALL_ITERATIONS = 20_000


def _stalls(scheduler, platform):
    return (scheduler, platform) == ("gpu_only", "t4")


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("platform", sorted(PLATFORM_MODELS))
@pytest.mark.parametrize("scheduler", SCHEDULERS)
def test_sim_result_equals_reference(scheduler, platform, variant):
    name = PLATFORM_MODELS[platform]
    kw = dict(scheduler=scheduler, **VARIANTS[variant])
    run = (dict(max_iterations=STALL_ITERATIONS)
           if _stalls(scheduler, platform) else {})
    ref_reqs = _ref_trace(name)
    reqs = _port_copy(ref_reqs)
    ref = RefSimulator(ref_get_config(name), platform,
                       RefSimConfig(**kw)).run(ref_reqs, **run)
    mine = ServingSimulator(get_config(name), platform,
                            SimConfig(**kw)).run(reqs, **run)
    if _stalls(scheduler, platform):
        assert mine.requests_finished < len(reqs)
        assert sum(mine.strategy_iterations.values()) == STALL_ITERATIONS
    else:
        assert mine.requests_finished == len(reqs)
    _assert_equal(mine, ref)


def test_gpu_only_stall_on_the_t4_is_the_references():
    """The stall above, in both packages: the request at the head of the
    queue needs more KV than the device holds, and nothing behind it is
    admitted (hybrid schedulers cap by the host tier's room and finish)."""
    name = PLATFORM_MODELS["t4"]
    sim = ServingSimulator(get_config(name), "t4",
                           SimConfig(scheduler="gpu_only"))
    ref_sim = RefSimulator(ref_get_config(name), "t4",
                           RefSimConfig(scheduler="gpu_only"))
    reqs, ref_reqs = _trace(get_config(name))(), _ref_trace(name)
    longest = max(r.prompt_len for r in reqs)
    assert longest > sim.device_kv_tokens == ref_sim.device_kv_tokens
    mine = sim.run(reqs, max_iterations=2_000)
    _assert_equal(mine, ref_sim.run(ref_reqs, max_iterations=2_000))
    stuck = [r for r in reqs if r.phase.value == "queued"]
    assert stuck and stuck[0].prompt_len == longest


@pytest.mark.parametrize("platform", sorted(PLATFORM_MODELS))
def test_decode_heavy_trace_equals_reference(platform):
    """The paper's decode-heavy regime (output mean 800), where the host
    tier carries tokens: every scheduler's result equals the reference's,
    the per-iteration trace hook included."""
    name = PLATFORM_MODELS[platform]
    for scheduler in SCHEDULERS:
        ref_reqs = _ref_trace(name, output_mean_override=800)
        ref_sim = RefSimulator(ref_get_config(name), platform,
                               RefSimConfig(scheduler=scheduler))
        sim = ServingSimulator(get_config(name), platform,
                               SimConfig(scheduler=scheduler))
        ref_rows, rows = [], []
        ref_sim.trace_hook, sim.trace_hook = ref_rows.append, rows.append
        run = (dict(max_iterations=STALL_ITERATIONS)
               if _stalls(scheduler, platform) else {})
        _assert_equal(sim.run(_port_copy(ref_reqs), **run),
                      ref_sim.run(ref_reqs, **run))
        assert rows == ref_rows


def test_workload_trace_equals_reference():
    """The port's ``osc`` trace is the reference's, so the port's own
    tests below run the reference's inputs."""
    cfg = get_config("llama3.1-8b")
    for kw in ({}, dict(output_mean_override=800)):
        mine, ref = _trace(cfg, **kw)(), _ref_trace("llama3.1-8b", **kw)
        assert [(r.prompt, r.max_new_tokens, r.arrival_time) for r in mine] \
            == [(list(r.prompt), r.max_new_tokens, r.arrival_time)
                for r in ref]


def test_platform_capacities_equal_reference():
    for platform, name in PLATFORM_MODELS.items():
        for dtype in ("fp32", "int8"):
            mine = ServingSimulator(get_config(name), platform,
                                    SimConfig(host_kv_dtype=dtype))
            ref = RefSimulator(ref_get_config(name), platform,
                               RefSimConfig(host_kv_dtype=dtype))
            assert (mine.device_kv_tokens, mine.host_kv_tokens) \
                == (ref.device_kv_tokens, ref.host_kv_tokens)


# --- the reference's simulator tests, on the port -------------------------

def test_conservation_of_tokens():
    cfg = get_config("llama3.1-8b")
    reqs = _trace(cfg)()
    expected = sum(r.max_new_tokens for r in reqs)
    sim = ServingSimulator(cfg, "a10", SimConfig(scheduler="apex"))
    res = sim.run(reqs)
    assert res.requests_finished == len(reqs)
    assert res.total_output_tokens == sum(r.max_new_tokens for r in reqs)
    assert res.total_output_tokens <= expected  # truncation only shrinks


def test_apex_beats_gpu_only_in_decode_heavy_regime():
    """Paper Fig. 5/7: hybrid APEX > device-only for long outputs."""
    cfg = get_config("llama3.1-8b")
    res = compare_schedulers(
        cfg, "a10", _trace(cfg, output_mean_override=800),
        schedulers=("gpu_only", "apex"))
    assert res["apex"].throughput > res["gpu_only"].throughput
    assert res["apex"].host_tokens > 0


def test_apex_never_pathological_vs_neo():
    """Paper §5.2: APEX >= NEO (the Ineq gate avoids NEO's bad greedy
    pipelining)."""
    cfg = get_config("llama3.1-8b")
    res = compare_schedulers(cfg, "a10",
                             _trace(cfg, output_mean_override=600),
                             schedulers=("neo", "apex"))
    assert res["apex"].throughput >= 0.95 * res["neo"].throughput


def test_strategy_selection_matches_regime():
    """On A10 decode-heavy, Algorithm 1 mostly picks async overlap."""
    cfg = get_config("llama3.1-8b")
    sim = ServingSimulator(cfg, "a10", SimConfig(scheduler="apex"))
    res = sim.run(_trace(cfg, output_mean_override=800)())
    counts = res.strategy_iterations
    assert counts.get("async_overlap", 0) > counts.get("asym_pipeline", 0)


def test_t4_memory_pressure_admits_few_device_requests():
    """Paper's T4 regime: llama2-7b leaves only a few thousand KV tokens
    on a 16 GB device."""
    sim = ServingSimulator(get_config("llama2-7b"), "t4",
                           SimConfig(scheduler="gpu_only"))
    assert sim.device_kv_tokens < 10_000
    sim_a10 = ServingSimulator(get_config("llama3.1-8b"), "a10")
    assert sim_a10.device_kv_tokens > 30_000


def test_model_too_big_raises():
    with pytest.raises(ValueError):
        ServingSimulator(get_config("llama3-405b"), "t4")


# --- the port's h100 (the analytic h100 model) ----------------------------

@pytest.mark.parametrize("scheduler", SCHEDULERS)
def test_h100_conservation_of_tokens(scheduler):
    cfg = get_config("llama3.1-8b")
    for kw in ({}, dict(output_mean_override=800)):
        reqs = _trace(cfg, **kw)()
        want = sum(r.max_new_tokens for r in reqs)
        res = ServingSimulator(cfg, "h100",
                               SimConfig(scheduler=scheduler)).run(reqs)
        assert res.requests_finished == len(reqs)
        assert res.total_output_tokens == want
        assert res.device_tokens + res.host_tokens == want
        assert res.makespan > 0 and res.throughput > 0
        assert sum(res.strategy_iterations.values()) > 0


def test_h100_model_too_big_raises():
    with pytest.raises(ValueError, match="does not fit h100"):
        ServingSimulator(get_config("kimi-k2-1t-a32b"), "h100")


def test_unknown_platform_raises():
    with pytest.raises(KeyError):       # the port has no TPU platform
        ServingSimulator(get_config("llama3.1-8b"), "v5e")
