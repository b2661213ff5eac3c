"""The port's request lifecycle against the JAX reference on the CPU.

  * decisions on the same registries: ``plan_chunks`` (urgent staging
    first, the cap, the fixed geometry), the ``TierPlacer`` (rebalance
    candidate, preemption victim, swap against recompute, deadline
    backpressure) and the shared placement predicates give the
    reference's answers;
  * the reference's lifecycle scenarios (tests/test_lifecycle.py and the
    recompute case of tests/test_faults.py) on the port's engine:
    host->device migration, the mid-prefill retarget, hybrid migration,
    swap and recompute preemption, and both deadline paths.  Each emits
    the reference engine's greedy tokens and the tokens of a port run
    with the mechanism off, and its counter shows that it fired.
"""
import dataclasses

import jax
import numpy as np
import pytest
torch = pytest.importorskip("torch")  # the port needs PyTorch

from repro.configs import get_config as ref_get_config
from repro.core import placement as ref_placement
from repro.core.perf_model import OnlineCalibrator as RefCalibrator
from repro.core.perf_model import analytic_model as ref_analytic
from repro.core.scheduler import AdmissionController as RefAdmission
from repro.models import init_params as ref_init
from repro.models.config import FFNKind as RefFFNKind
from repro.serving import Engine as RefEngine
from repro.serving import EngineConfig as RefEngineConfig
from repro.serving import Request as RefRequest
from repro.serving.lifecycle import EngineStats as RefStats
from repro.serving.lifecycle import InflightPrefill as RefInflight
from repro.serving.lifecycle import RequestLifecycle as RefLifecycle
from repro.serving.lifecycle import TierPlacer as RefPlacer
from repro.serving.request import Phase as RefPhase
from repro_torch.configs import get_config
from repro_torch.core import placement
from repro_torch.core.perf_model import OnlineCalibrator, analytic_model
from repro_torch.core.scheduler import AdmissionController
from repro_torch.models import params_from_numpy
from repro_torch.models.config import FFNKind
from repro_torch.serving import (Engine, EngineConfig, InferenceServer,
                                 Request, ServerConfig)
from repro_torch.serving.lifecycle import (EngineStats, InflightPrefill,
                                           RequestLifecycle, TierPlacer,
                                           transition)
from repro_torch.serving.request import Phase

FP32 = dict(param_dtype="float32", compute_dtype="float32")
A10 = "analytic:a10"


def _pair(arch, seed=0, **kw):
    rcfg = ref_get_config(arch).reduced(d_model=64, vocab=64, **kw)
    cfg = get_config(arch).reduced(d_model=64, vocab=64, **kw)
    if "jamba" in arch:
        rcfg = dataclasses.replace(rcfg, ffn_kind=RefFFNKind.DENSE, moe=None)
        cfg = dataclasses.replace(cfg, ffn_kind=FFNKind.DENSE, moe=None)
    rcfg = dataclasses.replace(rcfg, **FP32)
    cfg = dataclasses.replace(cfg, **FP32)
    rparams = ref_init(jax.random.PRNGKey(seed), rcfg)
    return rcfg, rparams, cfg, params_from_numpy(
        cfg, jax.tree.map(np.asarray, rparams), "cpu")


@pytest.fixture(scope="module")
def dense():
    """tests/test_lifecycle.py's stack: internlm2-1.8b, 4 layers."""
    return _pair("internlm2-1.8b", layers=4)



@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads while this file runs: its tensors are small,
    and the suite runs beside other workers' timing-sensitive tests."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)

# ---------------------------------------------------------------------------
# decisions on the same registries
# ---------------------------------------------------------------------------


def _twins(prompt_len, max_new, priority=0, out=0, deadline=None):
    """The same request in both packages, ``out`` tokens emitted."""
    kw = dict(prompt=list(range(prompt_len)), max_new_tokens=max_new,
              priority=priority, deadline=deadline, arrival_time=0.0)
    return Request(output=[1] * out, **kw), RefRequest(output=[1] * out,
                                                       **kw)


def test_plan_chunks_matches_reference():
    """Urgent staging first, FIFO inside a class, the chunk cap, and a
    token buffer of (staging rows, pow2_ceil(chunk_tokens)) whatever the
    budget."""
    lcs = []
    for lc_cls, placer_cls, adm, stats, e_cls, infl in (
            (RequestLifecycle, TierPlacer, AdmissionController, EngineStats,
             EngineConfig, InflightPrefill),
            (RefLifecycle, RefPlacer, RefAdmission, RefStats,
             RefEngineConfig, RefInflight)):
        lc = lc_cls(e_cls(device_slots=2, host_slots=2, chunk_tokens=24),
                    stats=stats(), placer=placer_cls(admission=adm(1000,
                                                                   1000)))
        lc.staging = [None] * 4
        lcs.append((lc, infl))
    reqs = [_twins(100, 4), _twins(50, 4, priority=1), _twins(7, 4)]
    for (lc, infl), side in zip(lcs, (0, 1)):
        for row, pair in zip((0, 2, 3), reqs):
            lc.staging[row] = infl(req=pair[side], tier="device", slot=0)
        lc.staging_order = [0, 2, 3]
    for budget in (0, 5, 24, 30, 60, 200):
        plans = [lc.plan_chunks(budget) for lc, _ in lcs]
        if plans[1] is None:
            assert plans[0] is None
            continue
        assert plans[0].rows == plans[1].rows
        assert plans[0].lens == plans[1].lens
        np.testing.assert_array_equal(plans[0].tokens, plans[1].tokens)
        np.testing.assert_array_equal(plans[0].clens, plans[1].clens)
        assert plans[0].tokens.shape == (4, 32)
    assert lcs[0][0].plan_chunks(30).rows == [2, 0]   # urgent first


def _placers(free_device=100, free_host=100):
    port_pm = OnlineCalibrator(analytic_model("a10", get_config(
        "llama3.1-8b")))
    ref_pm = RefCalibrator(ref_analytic("a10", ref_get_config(
        "llama3.1-8b")))
    out = []
    for placer, adm, pm in ((TierPlacer, AdmissionController, port_pm),
                            (RefPlacer, RefAdmission, ref_pm)):
        a = adm(device_kv_budget_tokens=free_device,
                host_kv_budget_tokens=free_host)
        out.append(placer(admission=a, perf_model=pm,
                          iters_per_host_token=33))
    return out


@pytest.mark.parametrize("remaining,context", [(1, 40), (30, 40),
                                               (200, 3000), (5, 10)])
def test_rebalance_candidate_matches_reference(remaining, context):
    placers = _placers(free_device=4000)
    pairs = [_twins(context, remaining + 2, out=2),
             _twins(context // 2, remaining, out=0)]
    picks = []
    for side, placer in enumerate(placers):
        cands = [p[side] for p in pairs]
        for r in cands:
            r.phase = (Phase, RefPhase)[side].DECODE_HOST
            r.kv_reserved = r.kv_demand()
        got = placer.rebalance_candidate(cands, waiting=0,
                                         device_slot_free=True,
                                         device_batch=1)
        picks.append(None if got is None else cands.index(got))
    assert picks[0] == picks[1]
    assert placers[0].migration_cost(context) == pytest.approx(
        placers[1].migration_cost(context), rel=1e-12)


@pytest.mark.parametrize("urgent_pri,host_free,pool_ok", [
    (1, True, True), (1, False, True), (1, True, False), (0, True, True),
    (2, True, True)])
def test_preemption_victim_and_recompute_pricing_match_reference(
        urgent_pri, host_free, pool_ok):
    placers = _placers(free_device=50, free_host=500)
    pairs = [_twins(8, 20, priority=0, out=3), _twins(30, 20, priority=0),
             _twins(9, 5, priority=1, out=1)]
    urgent = _twins(40, 5, priority=urgent_pri)
    picks = []
    for side, placer in enumerate(placers):
        res = [p[side] for p in pairs]
        for r in res:
            r.kv_reserved = r.kv_demand()
        v = placer.preemption_victim(res, urgent=urgent[side],
                                     host_slot_free=host_free,
                                     pool_ok=lambda n: pool_ok)
        picks.append(None if v is None else res.index(v))
        if v is not None:
            picks.append(placer.prefer_recompute(v))
        picks.append([placer.prefer_recompute(r) for r in res])
    half = len(picks) // 2
    assert picks[:half] == picks[half:]


@pytest.mark.parametrize("deadline,cached", [(None, 0), (1e-12, 0),
                                             (1e-4, 0), (10.0, 0),
                                             (1e-4, 30)])
def test_deadline_backpressure_matches_reference(deadline, cached):
    placers = _placers()
    for placer in placers:
        placer.cached_prefix_probe = lambda prompt: cached
    pair = _twins(32, 4, deadline=deadline)
    answers = [placer.deadline_impossible(r, now=0.0)
               for placer, r in zip(placers, pair)]
    assert answers[0] == answers[1]


def test_placement_predicates_match_reference():
    cases = [dict(waiting=w, device_slot_free=f, device_kv_headroom=h,
                  need_tokens=10, remaining_tokens=r, migration_cost=c,
                  device_s_per_token=d, host_s_per_token=hs)
             for w in (0, 1) for f in (True, False) for h in (5, 100)
             for r in (0, 5) for c in (0.1, 0.3)
             for d, hs in ((None, None), (0.01, 0.05))]
    for kw in cases:
        assert placement.should_rebalance_to_device(**kw) == \
            ref_placement.should_rebalance_to_device(**kw)
    for a, b in (([1, 2, 3], [1, 2, 9]), ([], [1]), ([4], [4, 5])):
        assert placement.longest_common_prefix(a, b) == \
            ref_placement.longest_common_prefix(a, b)
    for n, c in ((10, 0), (10, 4), (10, 10), (10, 50), (10, -3), (0, 5)):
        assert placement.chargeable_prefill_tokens(n, c) == \
            ref_placement.chargeable_prefill_tokens(n, c)
    for t in ((0.1, 0.2), (0.2, 0.1), (0.1, 0.1)):
        assert placement.should_recompute_instead_of_swap(
            t_swap=t[0], t_recompute=t[1]) == \
            ref_placement.should_recompute_instead_of_swap(
                t_swap=t[0], t_recompute=t[1])
    assert placement.DEGRADATION_LADDER == ref_placement.DEGRADATION_LADDER


def test_admission_queue_order_and_remove():
    """Priority first, EDF inside a class, arrival last (the reference's
    order), and ``remove`` pulls one request out by id."""
    from repro_torch.serving.lifecycle import AdmissionQueue
    a = Request(prompt=[1], max_new_tokens=1, arrival_time=0.0)
    b = Request(prompt=[1], max_new_tokens=1, arrival_time=1.0, priority=1)
    c = Request(prompt=[1], max_new_tokens=1, arrival_time=2.0, priority=1,
                deadline=0.5)
    d = Request(prompt=[1], max_new_tokens=1, arrival_time=0.5)
    q = AdmissionQueue()
    for r in (a, b, c, d):
        q.push(r)
    assert q.remove(d.request_id) is d and q.remove(d.request_id) is None
    assert [q.pop() for _ in range(3)] == [c, b, a] and not q


def test_state_machine_edges():
    r = Request(prompt=[1], max_new_tokens=1)
    with pytest.raises(RuntimeError):
        transition(r, Phase.DECODE_DEVICE)              # must prefill first
    for to in (Phase.PREFILL, Phase.DECODE_HOST, Phase.MIGRATING,
               Phase.DECODE_DEVICE, Phase.PREEMPTED, Phase.DECODE_HOST,
               Phase.FINISHED):
        transition(r, to)
    r2 = Request(prompt=[1], max_new_tokens=1)
    for to in (Phase.PREFILL, Phase.DECODE_DEVICE, Phase.RECOMPUTE,
               Phase.PREFILL, Phase.MIGRATING, Phase.PREFILL):
        transition(r2, to)
    with pytest.raises(RuntimeError):
        transition(r2, Phase.QUEUED)


# ---------------------------------------------------------------------------
# the reference's scenarios on the engine
# ---------------------------------------------------------------------------


def _clone(protos, cls):
    return [cls(prompt=list(r.prompt), max_new_tokens=r.max_new_tokens,
                deadline=r.deadline, priority=r.priority) for r in protos]


def _drive(engine, first, later, *, warmup, limit=3000):
    """Run ``first`` for ``warmup`` iterations, submit ``later``, and step
    until idle; returns the requests and the stats."""
    try:
        for r in first:
            engine.submit(r)
        for _ in range(warmup):
            engine.step()
        for r in later:
            engine.submit(r)
        it = 0
        while engine.has_work and it < limit:
            engine.step()
            it += 1
    finally:
        engine.shutdown()
    return first + later, engine.stats


def _three_runs(pair, kw, off, protos_first, protos_later=(), warmup=0):
    """(port, port with ``off``, reference) request lists and stats."""
    rcfg, rparams, cfg, params = pair
    out = []
    for eng_cls, cfg_cls, req_cls, c, p, extra in (
            (Engine, EngineConfig, Request, cfg, params, dict(device="cpu")),
            (Engine, EngineConfig, Request, cfg, params,
             dict(off, device="cpu")),
            (RefEngine, RefEngineConfig, RefRequest, rcfg, rparams, {})):
        eng = eng_cls(c, p, cfg_cls(**kw, **extra))
        out.append(_drive(eng, _clone(protos_first, req_cls),
                          _clone(protos_later, req_cls), warmup=warmup))
    (port, ps), (port_off, ps_off), (ref, rs) = out
    assert [r.output for r in port] == [r.output for r in ref]
    assert [r.output for r in port] == [r.output for r in port_off]
    assert all(not r.failed for r in port)
    return (port, ps), (port_off, ps_off), (ref, rs)


def test_host_to_device_migration(dense):
    rng = np.random.default_rng(3)
    protos = [Request(prompt=list(rng.integers(0, 64, 6)), max_new_tokens=3)
              for _ in range(2)]
    protos += [Request(prompt=list(rng.integers(0, 64, 6)),
                       max_new_tokens=24) for _ in range(4)]
    kw = dict(device_slots=2, host_slots=4, cache_len=64, perf_model=A10,
              host_workers=2, preemption=False)
    (_, s), (_, s_off), (_, rs) = _three_runs(
        dense, kw, dict(tier_rebalance=False), protos)
    assert s.migrations == rs.migrations >= 1 and s_off.migrations == 0
    assert s.device_tokens > s_off.device_tokens


def test_mid_prefill_retarget(dense):
    """A host admission still mid-prefill retargets to a freed device slot
    by bookkeeping and finishes there."""
    rng = np.random.default_rng(4)
    short = Request(prompt=list(rng.integers(0, 64, 4)), max_new_tokens=2)
    longr = Request(prompt=list(rng.integers(0, 64, 40)), max_new_tokens=6)
    kw = dict(device_slots=1, host_slots=2, cache_len=128, chunk_tokens=4,
              perf_model=A10, host_workers=2, preemption=False)
    (port, s), (port_off, s_off), (ref, rs) = _three_runs(
        dense, kw, dict(tier_rebalance=False), [short], [longr], warmup=1)
    assert s.migrations == rs.migrations >= 1
    assert port[1].tier == ref[1].tier == "device"
    assert port_off[1].tier == "host"


def test_hybrid_migration():
    pair = _pair("jamba-1.5-large-398b", seed=1, layers=8)
    rng = np.random.default_rng(5)
    protos = [Request(prompt=list(rng.integers(0, 64, 5)), max_new_tokens=2)]
    protos += [Request(prompt=list(rng.integers(0, 64, 5)),
                       max_new_tokens=10) for _ in range(2)]
    kw = dict(device_slots=1, host_slots=2, cache_len=64, perf_model=A10,
              host_workers=2, preemption=False)
    (_, s), _, (_, rs) = _three_runs(pair, kw, dict(tier_rebalance=False),
                                     protos)
    assert s.migrations == rs.migrations >= 1


def test_swap_preemption(dense):
    """An urgent request too large for the host pool demotes a low-priority
    device resident to the host tier and takes its slot; without
    preemption it queues."""
    rng = np.random.default_rng(6)
    lows = [Request(prompt=list(rng.integers(0, 64, 8)), max_new_tokens=20)
            for _ in range(2)]
    urgent = Request(prompt=list(rng.integers(0, 64, 100)),
                     max_new_tokens=5, priority=1, deadline=120.0)
    kw = dict(device_slots=2, host_slots=4, cache_len=128, page_size=32,
              host_pool_pages=8, perf_model=A10, host_workers=2)
    (_, s), (_, s_off), (_, rs) = _three_runs(
        dense, kw, dict(preemption=False), lows, [urgent], warmup=4)
    assert s.preemptions == rs.preemptions >= 1 and s_off.preemptions == 0
    assert s.preemption_recomputes == 0 and s.deadline_misses == 0
    assert "demote" in s.pressure_marks


def test_recompute_preemption(dense):
    """No host room for the victim: it is recompute-preempted, replays
    through the queue and emits the stream of an uncontended run."""
    first = [Request(prompt=[1] * 12, max_new_tokens=48)]
    later = [Request(prompt=[2] * 100, max_new_tokens=4, priority=1),
             Request(prompt=[3] * 6, max_new_tokens=4)]
    kw = dict(device_slots=1, host_slots=1, cache_len=256, page_size=32,
              host_pool_pages=1, perf_model=A10, host_workers=2,
              prefix_cache=False)
    (port, s), (_, s_off), (_, rs) = _three_runs(
        dense, kw, dict(preemption=False), first, later, warmup=1)
    assert s.preemption_recomputes == rs.preemption_recomputes >= 1
    assert s.preemption_requeues == 0 and s_off.preemption_recomputes == 0
    assert len(port[0].output) == 48
    assert s.degradation(1e9) == "recompute"


def test_recompute_fallback_off_requeues(dense):
    """With the escape hatch off, the blocked swap requeues the urgent
    request (counted once) and nothing is recomputed."""
    rcfg, rparams, cfg, params = dense
    with InferenceServer(cfg, params, ServerConfig(
            device_slots=1, host_slots=1, cache_len=256, page_size=32,
            host_pool_pages=1, perf_model=A10, host_workers=2,
            recompute_fallback=False, device="cpu")) as server:
        resident = server.submit([1] * 12, max_new_tokens=12)
        server.step()
        urgent = server.submit([2] * 100, max_new_tokens=4, priority=1)
        stats = server.run_until_idle()
    assert stats.preemption_recomputes == 0
    assert stats.preemption_requeues == 1
    assert resident.done and urgent.done and not urgent.failed


def test_deadlines(dense):
    """An impossible deadline is rejected at admission (backpressure, not a
    miss); a deadline the prediction allows but the run misses counts at
    retirement -- as in the reference."""
    rcfg, rparams, cfg, params = dense
    rng = np.random.default_rng(7)
    prompts = [list(rng.integers(0, 64, 8)) for _ in range(3)]
    results = []
    for eng_cls, cfg_cls, req_cls, c, p, extra in (
            (Engine, EngineConfig, Request, cfg, params, dict(device="cpu")),
            (RefEngine, RefEngineConfig, RefRequest, rcfg, rparams, {})):
        eng = eng_cls(c, p, cfg_cls(device_slots=2, cache_len=64,
                                    enable_offload=False, perf_model=A10,
                                    **extra))
        # 1e-4 s: above the a10 model's prefill prediction for 8 tokens
        # (~10 us), below any first iteration on the CPU
        reqs = [req_cls(prompt=prompts[0], max_new_tokens=4,
                        deadline=1e-12),
                req_cls(prompt=prompts[1], max_new_tokens=4),
                req_cls(prompt=prompts[2], max_new_tokens=3,
                        deadline=1e-4)]
        stats = eng.run(reqs)
        eng.shutdown()
        results.append(([r.output for r in reqs], [r.failed for r in reqs],
                        stats.deadline_rejections, stats.deadline_misses))
    assert results[0] == results[1]
    outputs, failed, rejections, misses = results[0]
    assert failed == [True, False, False] and outputs[0] == []
    assert rejections == 1 and misses == 1
