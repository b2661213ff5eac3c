"""The port's fault handling against the JAX reference on the CPU.

  * ``FaultPlan`` / ``FaultInjector`` and ``RestartPolicy`` /
    ``HeartbeatMonitor`` give the reference's answers on the same inputs;
  * the reference's chaos matrix (tests/test_faults.py) on the port's
    engine, for the dense and the hybrid stack: a host worker dying or
    stalling past the watchdog deadline, consecutive fallbacks tripping
    the breaker, the fallback disabled, a failed pool allocation, latency
    spikes, a blocked swap recomputed, and ``cancel`` in every place a
    request can sit.  Every completed stream equals the reference
    engine's fault-free stream, and every run leaves no residue;
  * an abandoned, stalled host job changes no pool bytes.
"""
import dataclasses
import threading
import time

import jax
import numpy as np
import pytest
torch = pytest.importorskip("torch")  # the port needs PyTorch

from repro.configs import get_config as ref_get_config
from repro.distributed.fault_tolerance import \
    HeartbeatMonitor as RefHeartbeat
from repro.distributed.fault_tolerance import RestartPolicy as RefRestart
from repro.models import init_params as ref_init
from repro.models.config import FFNKind as RefFFNKind
from repro.serving import Engine as RefEngine
from repro.serving import EngineConfig as RefEngineConfig
from repro.serving import Request as RefRequest
from repro.serving.faults import FaultInjector as RefInjector
from repro.serving.faults import FaultPlan as RefPlan
from repro.serving.request import make_synthetic_request
from repro_torch.configs import get_config
from repro_torch.core.overlap_engine import HostExecutor
from repro_torch.distributed.fault_tolerance import (HeartbeatMonitor,
                                                     RestartPolicy)
from repro_torch.models import params_from_numpy
from repro_torch.models.config import FFNKind
from repro_torch.models.kv_cache import PagedKVPool
from repro_torch.serving import (Engine, EngineConfig, InferenceServer,
                                 Request, ServerConfig)
from repro_torch.serving.faults import (FAULT_KINDS, FaultInjectedError,
                                        FaultInjector, FaultPlan, FaultSpec)
from repro_torch.serving.request import Phase

ARCHS = ["internlm2-1.8b", "jamba-1.5-large-398b"]
# fp32 parameters: at bf16 the two packages' logits differ by bf16 ULPs
# and greedy tokens part even without faults (ROADMAP queue 3)
FP32 = dict(param_dtype="float32", compute_dtype="float32")
PLANS = ["host_stall@3x2:0.5, pool_alloc@1,host_error",
         "latency_spike@2:0.125,driver_crash@4x3", "host_error@1x99",
         "pool_alloc@2,host_stall@4:1.5,host_error@2,latency_spike@3"]


def _pair(arch, **kw):
    """tests/test_faults.py's stacks in both packages at fp32, the
    reference's weights bridged; Jamba with dense FFNs (the port has no
    MoE FFN)."""
    rcfg = ref_get_config(arch).reduced(d_model=64, vocab=64, **kw)
    cfg = get_config(arch).reduced(d_model=64, vocab=64, **kw)
    if "jamba" in arch:
        rcfg = dataclasses.replace(rcfg, ffn_kind=RefFFNKind.DENSE, moe=None)
        cfg = dataclasses.replace(cfg, ffn_kind=FFNKind.DENSE, moe=None)
    rcfg = dataclasses.replace(rcfg, **FP32)
    cfg = dataclasses.replace(cfg, **FP32)
    rparams = ref_init(jax.random.PRNGKey(0), rcfg)
    return rcfg, rparams, cfg, params_from_numpy(
        cfg, jax.tree.map(np.asarray, rparams), "cpu")


@pytest.fixture(scope="module", params=ARCHS)
def arch_stack(request):
    return _pair(request.param, layers=None)


@pytest.fixture(scope="module")
def dense():
    return _pair("internlm2-1.8b", layers=None)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads while this file runs: its tensors are small,
    and the suite runs beside other workers' timing-sensitive tests."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _protos(n, vocab=64):
    # tests/test_faults.py's prompts (seeded for margin-robust argmaxes)
    rng = np.random.default_rng(1)
    return [list(make_synthetic_request(rng, prompt_len=7, output_len=1,
                                        vocab=vocab).prompt)
            for _ in range(n)]


def _reference(stack, prompts, out_len):
    """The reference engine's fault-free, device-only streams."""
    rcfg, rparams = stack[:2]
    eng = RefEngine(rcfg, rparams, RefEngineConfig(
        device_slots=len(prompts) + 1, cache_len=64, enable_offload=False,
        prefix_cache=False))
    reqs = [RefRequest(prompt=list(p), max_new_tokens=out_len)
            for p in prompts]
    eng.run(reqs)
    eng.shutdown()
    return {tuple(r.prompt): r.output for r in reqs}


def _chaos_run(stack, prompts, out_len, **ecfg):
    cfg, params = stack[2:]
    kw = dict(device_slots=2, host_slots=len(prompts), cache_len=64,
              prefix_cache=False, device="cpu")
    kw.update(ecfg)
    eng = Engine(cfg, params, EngineConfig(**kw))
    reqs = [Request(prompt=list(p), max_new_tokens=out_len)
            for p in prompts]
    try:
        stats = eng.run(reqs)
    finally:
        eng.shutdown()
    return reqs, stats, eng


def _assert_no_leaks(eng):
    """No occupied slot or staging row, an empty pool with every page
    free, no host registration (prefix cache off: cached prefixes keep
    chains on purpose)."""
    lc = eng.lc
    assert all(r is None for r in lc.slots)
    assert all(e is None for e in (lc.staging or []))
    assert lc.staging_order == []
    assert lc.admission.device_used == 0
    if eng.executor is not None:
        pool = eng.executor.pool
        assert pool.lengths == {}
        assert pool.page_tables == {}
        assert pool.num_free == pool.pages.shape[1]
        assert lc.host_requests == {}
        assert lc.host_slot_owner == {}
        assert lc.admission.host_used == 0


def _assert_streams(reqs, ref):
    for r in reqs:
        assert not r.failed, r.error
        assert r.output == ref[tuple(r.prompt)], \
            f"request {r.request_id} parted from the fault-free stream"


# ---------------------------------------------------------------------------
# plans, the injector and the restart policy against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("text", PLANS)
def test_fault_plan_and_injector_match_reference(text):
    plan, ref = FaultPlan.parse(text), RefPlan.parse(text)
    assert plan.describe() == ref.describe()
    assert FaultPlan.parse(plan.describe()) == plan
    assert [dataclasses.astuple(s) for s in plan.specs] == \
        [dataclasses.astuple(s) for s in ref.specs]
    inj, rinj = FaultInjector(plan), RefInjector(ref)
    rng = np.random.default_rng(len(text))
    for kind in rng.choice(FAULT_KINDS, size=40):
        a, b = inj.fire(kind), rinj.fire(kind)
        assert (a is None) == (b is None)
        if a is not None:
            assert dataclasses.astuple(a) == dataclasses.astuple(b)
    assert inj.snapshot() == rinj.snapshot()


def test_fault_plan_edges_and_hooks():
    with pytest.raises(ValueError):
        FaultPlan.parse("segfault@1")          # unknown kind
    with pytest.raises(ValueError):
        FaultSpec(kind="host_stall", at=0)     # 1-based schedule
    plan = FaultPlan.parse("driver_crash@2")
    assert FaultPlan.coerce(None) is None
    assert FaultPlan.coerce(plan) is plan
    assert FaultPlan.coerce("driver_crash@2") == plan
    assert FaultPlan.coerce(list(plan.specs)) == plan
    assert FaultInjector.from_config(None) is None
    assert FaultInjector.from_config("") is None
    with pytest.raises(FaultInjectedError):
        FaultInjector(FaultPlan.parse("host_error@1")).on_host_job()
    with pytest.raises(MemoryError):
        FaultInjector(FaultPlan.parse("pool_alloc@1")).on_pool_alloc()
    with pytest.raises(FaultInjectedError):
        FaultInjector(FaultPlan.parse("driver_crash@1")).on_driver_pump()
    spike = FaultInjector(FaultPlan.parse("latency_spike@1:0.01"))
    assert spike.on_engine_step() == 0.01
    assert spike.on_engine_step() is None


@pytest.mark.parametrize("base,cap,budget", [(5.0, 300.0, 10),
                                             (0.05, 1.6, 1 << 30),
                                             (1e-3, 1e-3, 3)])
def test_restart_policy_matches_reference(base, cap, budget):
    ours = RestartPolicy(max_restarts=budget, backoff_base=base,
                         backoff_cap=cap)
    ref = RefRestart(max_restarts=budget, backoff_base=base,
                     backoff_cap=cap)
    seq, rseq = [], []
    for i in range(14):
        if i == 9:
            ours.record_success()
            ref.record_success()
        seq.append(ours.next_delay())
        rseq.append(ref.next_delay())
    assert seq == rseq


def test_heartbeat_monitor_matches_reference():
    ours = HeartbeatMonitor([0, 1, 2, 3], timeout=1.0, straggler_factor=2.0)
    ref = RefHeartbeat([0, 1, 2, 3], timeout=1.0, straggler_factor=2.0)
    beats = [(0, 0.1, 1.0), (1, 0.2, 1.1), (2, 0.3, 5.0), (3, 0.4, None),
             (0, 1.0, 1.0), (1, 1.2, 0.9)]
    for w, now, st in beats:
        ours.beat(w, now, st)
        ref.beat(w, now, st)
    assert ours.stragglers() == ref.stragglers() == [2]
    for now in (1.25, 1.5, 2.5):
        assert ours.sweep(now) == ref.sweep(now)
        assert ours.alive_workers() == ref.alive_workers()


# ---------------------------------------------------------------------------
# the chaos matrix on the port's engine
# ---------------------------------------------------------------------------


def test_host_error_fallback_gives_reference_streams(arch_stack):
    """A host worker dying mid-job: the watchdog reruns the cohort's
    attention on the engine thread, for dense and hybrid stacks."""
    prompts = _protos(5)
    ref = _reference(arch_stack, prompts, out_len=6)
    reqs, stats, eng = _chaos_run(arch_stack, prompts, out_len=6,
                                  fault_plan="host_error@1x2")
    assert stats.host_tokens > 0, "offload never engaged"
    assert stats.host_fallbacks >= 1
    assert eng.faults.snapshot()["fired"]["host_error"] >= 1
    _assert_streams(reqs, ref)
    _assert_no_leaks(eng)


def test_host_stall_fallback_gives_reference_streams(arch_stack):
    """A wedged worker, stalled far past the deadline, is abandoned and
    rerun; it wakes up later and writes nothing."""
    prompts = _protos(5)
    ref = _reference(arch_stack, prompts, out_len=6)
    reqs, stats, eng = _chaos_run(
        arch_stack, prompts, out_len=6, fault_plan="host_stall@1:2.5",
        host_job_slack=2.0, host_job_min_timeout=0.15)
    assert stats.host_tokens > 0, "offload never engaged"
    assert stats.host_fallbacks >= 1
    _assert_streams(reqs, ref)
    _assert_no_leaks(eng)


def test_breaker_trips_on_consecutive_fallbacks_then_recovers(dense):
    """Three consecutive fallbacks trip the breaker (device pin for a
    cooldown, host attention at the emit point); after the cooldown the
    host tier is probed again and the run still gives the streams."""
    prompts = _protos(6)
    ref = _reference(dense, prompts, out_len=8)
    reqs, stats, eng = _chaos_run(
        dense, prompts, out_len=8, fault_plan="host_error@1x3",
        host_breaker_threshold=3, host_breaker_cooldown=0.05)
    assert stats.host_fallbacks >= 3
    assert stats.host_breaker_trips >= 1
    _assert_streams(reqs, ref)
    _assert_no_leaks(eng)


def test_fallbacks_propagate_when_recompute_disabled(dense):
    cfg, params = dense[2:]
    eng = Engine(cfg, params, EngineConfig(
        device_slots=2, host_slots=5, cache_len=64, prefix_cache=False,
        fault_plan="host_error@1x99", recompute_fallback=False,
        device="cpu"))
    try:
        with pytest.raises(RuntimeError):
            eng.run([Request(prompt=p, max_new_tokens=6)
                     for p in _protos(5)])
        assert eng.stats.host_fallbacks == 0
    finally:
        eng.shutdown()


def test_pool_alloc_failure_requeues_and_completes(dense):
    prompts = _protos(5)
    ref = _reference(dense, prompts, out_len=6)
    reqs, stats, eng = _chaos_run(dense, prompts, out_len=6,
                                  fault_plan="pool_alloc@1")
    assert eng.faults.snapshot()["fired"]["pool_alloc"] == 1
    _assert_streams(reqs, ref)
    _assert_no_leaks(eng)


def test_latency_spike_only_stretches_wall_time(dense):
    prompts = _protos(3)
    ref = _reference(dense, prompts, out_len=4)
    reqs, stats, eng = _chaos_run(dense, prompts, out_len=4,
                                  fault_plan="latency_spike@1x2:0.15")
    assert eng.faults.snapshot()["fired"]["latency_spike"] == 2
    assert stats.wall_time >= 0.3        # both spikes inside the steps
    _assert_streams(reqs, ref)
    _assert_no_leaks(eng)


def test_blocked_swap_recomputes_victim():
    """The reference's blocked-swap scenario (victim found, no host room):
    the victim's K/V is dropped and replayed, its stream (tokens emitted
    before the preemption too) equals an uncontended run's and the
    reference engine's, and nothing leaks."""
    rcfg, rparams, cfg, params = _pair("internlm2-1.8b", layers=2)
    work = [([1] * 12, 48), ([2] * 200, 4), ([3] * 6, 4)]
    reng = RefEngine(rcfg, rparams, RefEngineConfig(
        device_slots=4, host_slots=0, enable_offload=False, cache_len=256,
        prefix_cache=False))
    rreqs = [RefRequest(prompt=p, max_new_tokens=n) for p, n in work]
    reng.run(rreqs)
    reng.shutdown()
    ref = {tuple(r.prompt): r.output for r in rreqs}
    scfg = ServerConfig(device_slots=1, host_slots=1, cache_len=256,
                        page_size=32, host_pool_pages=1, output_len=48,
                        prefix_cache=False, device="cpu")
    with InferenceServer(cfg, params, scfg) as server:
        # kv demand 12 + 48 > 32: the one-page pool can never hold the
        # resident, so the swap is blocked
        resident = server.submit([1] * 12, max_new_tokens=48)
        server.step()
        assert server.active == 1
        urgent = server.submit([2] * 200, max_new_tokens=4, priority=1)
        lowprio = server.submit([3] * 6, max_new_tokens=4)
        server.run_until_idle()
        stats = server.stats
        assert stats.preemption_recomputes >= 1
        assert stats.preemption_requeues == 0
        for h in (resident, urgent, lowprio):
            assert h.done and not h.failed
            assert h.output == ref[tuple(h.request.prompt)]
        assert stats.degradation(1e9) == "recompute"
        assert stats.snapshot()["preemption_recomputes"] >= 1.0
        _assert_no_leaks(server.engine)


def test_cancel_in_every_place(dense):
    """``cancel`` of a queued request, a mid-chunked-prefill one, a device
    resident and a host resident (deferred to the cohort's token
    boundary): each finishes with ``error='cancelled'`` and frees what it
    held; the survivors give the reference engine's streams."""
    prompts = _protos(7)
    long_prompt = list(range(1, 40))
    ref = _reference(dense, prompts[:5], out_len=12)
    cfg, params = dense[2:]
    scfg = ServerConfig(device_slots=2, host_slots=4, cache_len=64,
                        output_len=12, prefix_cache=False, chunk_tokens=8,
                        device="cpu")
    with InferenceServer(cfg, params, scfg) as server:
        eng = server.engine
        handles = [server.submit(p) for p in prompts[:5]]
        for _ in range(40):              # place across both tiers
            server.step()
            if eng.lc.host_requests and all(
                    r is not None and r.phase is Phase.DECODE_DEVICE
                    for r in eng.slots) and any(
                    r.phase is Phase.DECODE_HOST
                    for r in eng.lc.host_requests.values()):
                break
        host_rid = next(rid for rid, r in eng.lc.host_requests.items()
                        if r.phase is Phase.DECODE_HOST)
        device_rid = eng.slots[0].request_id
        # a long prompt stages over several 8-token chunks in the last
        # host slot; one more request waits behind the full tiers
        staged = server.submit(long_prompt)
        queued = server.submit(prompts[5])
        server.step()
        assert any(eng.lc.staging[row].req is staged.request
                   for row in eng.lc.staging_order), "never staged"
        assert queued.request.phase is Phase.QUEUED
        doomed = [queued.request_id, staged.request_id, device_rid,
                  host_rid]
        for rid in doomed:
            assert server.cancel(rid) is True
        assert server.cancel(10_000) is False     # unknown id
        server.run_until_idle()
        assert server.cancel(device_rid) is False  # already finished
        assert server.stats.cancelled == 4
        by_id = {h.request_id: h for h in handles + [staged, queued]}
        for rid in doomed:
            assert by_id[rid].failed and by_id[rid].error == "cancelled"
        survivors = [h for h in handles if h.request_id not in doomed]
        assert len(survivors) == 3
        for h in survivors:
            assert not h.failed and h.output == ref[tuple(h.request.prompt)]
        _assert_no_leaks(eng)


# ---------------------------------------------------------------------------
# an abandoned job writes nothing
# ---------------------------------------------------------------------------


def test_abandoned_stalled_job_changes_no_pool_bytes():
    """A job stalled in the worker and abandoned by ``cancel`` wakes up,
    copies its Q/K/V and stops before its K/V append: request 0's pages
    keep their bytes.  A job submitted after it (same worker, so it runs
    once the stalled one is done) appends as usual, and the unstalled
    rerun of the abandoned job writes what the worker would have."""
    cfg = get_config("internlm2-1.8b").reduced(layers=4, d_model=64,
                                               vocab=64)
    hd, kv, h = cfg.resolved_head_dim, cfg.num_kv_heads, cfg.num_heads
    pool = PagedKVPool(16, 8, cfg.num_attn_layers, kv, hd)
    ex = HostExecutor(cfg, pool, workers=1,
                      faults=FaultInjector(FaultPlan.parse(
                          "host_stall@1:0.4")))
    gen = torch.Generator().manual_seed(0)
    try:
        for rid in (0, 1):
            pool.allocate(rid, 12)
            pool.lengths[rid] = 5
        chain = list(pool.page_tables[(0, 0)])
        before = pool.pages[:, chain].copy()
        q, k, v = (torch.randn((1, n, hd), generator=gen)
                   for n in (h, kv, kv))
        ex.submit(1, 0, [0], q, k, v, np.array([5]))
        time.sleep(0.05)                 # the worker is inside its stall
        ex.cancel(1)
        q2, k2, v2 = (torch.randn((1, n, hd), generator=gen)
                      for n in (h, kv, kv))
        chain1 = list(pool.page_tables[(1, 0)])
        before1 = pool.pages[:, chain1].copy()
        ex.submit(2, 0, [1], q2, k2, v2, np.array([5]))
        ex.recycle(ex.result(2, timeout=10.0))
        assert np.array_equal(pool.pages[:, chain], before)
        assert not np.array_equal(pool.pages[:, chain1], before1)
        assert ex._results == {} and ex._abandoned == set()
        # the engine's rerun of job 1 on its own thread, no injection
        ex.recycle(ex.execute_sync(3, 0, [0], q, k, v, np.array([5])))
        written = pool.pages[:, chain].reshape(2, -1, kv, hd)[:, 5]
        assert np.array_equal(written[0], k[0].numpy())
        assert np.array_equal(written[1], v[0].numpy())
    finally:
        ex.shutdown()


def test_cancel_after_publish_recycles_the_result():
    """A job abandoned after it published: the result is dropped and its
    buffer reused, and a poll finds nothing."""
    cfg = get_config("internlm2-1.8b").reduced(layers=4, d_model=64,
                                               vocab=64)
    hd, kv, h = cfg.resolved_head_dim, cfg.num_kv_heads, cfg.num_heads
    pool = PagedKVPool(8, 8, cfg.num_attn_layers, kv, hd)
    ex = HostExecutor(cfg, pool, workers=1)
    try:
        pool.allocate(0, 8)
        pool.lengths[0] = 2
        q = torch.ones((1, h, hd))
        k = torch.ones((1, kv, hd))
        done = threading.Event()
        ex.submit(1, 0, [0], q, k, k, np.array([2]))
        for _ in range(200):
            with ex._lock:
                if 1 in ex._results:
                    done.set()
                    break
            time.sleep(0.01)
        assert done.is_set()
        ex.cancel(1)
        assert ex.poll(1) is None
        assert ex._free_bufs[(1, h, hd)]
    finally:
        ex.shutdown()
