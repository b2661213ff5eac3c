"""The port's gateway against the JAX reference's on the CPU.

  * the reference's gateway scenarios (tests/test_gateway.py) on the
    port's replica pool and HTTP/SSE gateway: concurrent submission equal
    to a serial run, token iterators under the step lock, crash
    containment and respawn, the preemption requeue counter, SSE equal to
    a direct run, ``/health`` and ``/metrics``, bad requests, 503 and 429
    at the edge, session affinity in process and over HTTP;
  * across packages: the same prompts through the reference's gateway
    and the port's give equal greedy SSE streams, ``render_prometheus``
    gives the same families with the same label sets, and
    ``pool.health()`` the same keys;
  * the ``driver_crash`` fault fires from the port's ``Replica._drive``.

fp32 parameters bridged from the reference's (at bf16 the two packages'
greedy tokens part on logit ties).  Every wait carries a timeout: a hung
socket or driver fails the test instead of stalling the suite.
"""
import dataclasses
import re
import threading
import time

import jax
import numpy as np
import pytest
torch = pytest.importorskip("torch")  # the port needs PyTorch

from repro.configs import get_config as ref_get_config
from repro.models import init_params as ref_init
from repro.serving import InferenceServer as RefServer
from repro.serving import ServerConfig as RefServerConfig
from repro.serving.gateway import EngineReplicaPool as RefPool
from repro.serving.gateway import render_prometheus as ref_render
from repro.serving.gateway import serve_in_thread as ref_serve_in_thread
from repro_torch.configs import get_config
from repro_torch.models import params_from_numpy
from repro_torch.serving import (EngineReplicaPool, InferenceServer,
                                 ServerConfig)
from repro_torch.serving.faults import FaultInjector
from repro_torch.serving.gateway import render_prometheus, serve_in_thread
from repro_torch.serving.gateway.pool import Replica
from repro_torch.serving.gateway.client import get_json, get_text, sse_chat

FP32 = dict(param_dtype="float32", compute_dtype="float32")
WAIT = 120.0            # seconds: the bound on every join, get and result
HOST = "127.0.0.1"


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads while this file runs: its tensors are small,
    and the suite runs beside other workers' timing-sensitive tests."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def served():
    """tests/test_gateway.py's model in both packages at fp32, the
    reference's weights bridged into the port."""
    rcfg = dataclasses.replace(ref_get_config("stablelm-12b").reduced(
        layers=2, d_model=64, vocab=64), **FP32)
    cfg = dataclasses.replace(get_config("stablelm-12b").reduced(
        layers=2, d_model=64, vocab=64), **FP32)
    rparams = ref_init(jax.random.PRNGKey(0), rcfg)
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, rparams), "cpu")
    return rcfg, rparams, cfg, params


def _server_config(**kw):
    defaults = dict(device_slots=2, host_slots=3, cache_len=64,
                    prompt_len=6, output_len=5, num_requests=5, device="cpu")
    defaults.update(kw)
    return ServerConfig(**defaults)


def _factory(cfg, params, **kw):
    def factory():
        return InferenceServer(cfg, params, _server_config(**kw))
    return factory


def _prompts(n, base=2):
    # distinct prompts so concurrent outputs can be matched to their
    # serial counterparts regardless of completion order
    return [[base + i, 3, 5, 7] for i in range(n)]


def _run_threads(targets):
    threads = [threading.Thread(target=t) for t in targets]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT)
    assert not any(t.is_alive() for t in threads), "a worker thread hung"


def _wait_for(predicate, timeout=30.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return True
        time.sleep(0.02)
    return False


# --- pool semantics (the reference's scenarios) ---------------------------

def test_concurrent_submission_bit_identical_to_serial(served):
    """8 submitter threads through a single replica produce exactly the
    outputs a serial in-process run produces."""
    _, _, cfg, params = served
    prompts = _prompts(8)
    with InferenceServer(cfg, params, _server_config()) as ref:
        serial = {tuple(p): ref.submit(p, max_new_tokens=5).result()
                  for p in prompts}

    with EngineReplicaPool(_factory(cfg, params), replicas=1) as pool:
        results, errors = {}, []
        lock = threading.Lock()

        def worker(p):
            def run():
                try:
                    out = pool.submit(p, 5).result(timeout=WAIT)
                    with lock:
                        results[tuple(p)] = out
                except Exception as exc:   # pragma: no cover - failure path
                    with lock:
                        errors.append(exc)
            return run

        _run_threads([worker(p) for p in prompts])
        assert not errors
    assert results == serial           # bit-identical, all 8 present


def test_step_lock_allows_concurrent_token_iterators(served):
    """Two RequestHandle.tokens() iterators pulled from different threads
    both drive step(); the lock serializes them."""
    _, _, cfg, params = served
    with InferenceServer(cfg, params, _server_config()) as server:
        handles = [server.submit(p, max_new_tokens=8)
                   for p in _prompts(4, base=11)]
        outs, errors = {}, []
        lock = threading.Lock()

        def pull(h):
            def run():
                try:
                    toks = list(h.tokens())
                    with lock:
                        outs[h.request_id] = toks
                except Exception as exc:   # pragma: no cover
                    with lock:
                        errors.append(exc)
            return run

        _run_threads([pull(h) for h in handles])
        assert not errors
        for h in handles:
            assert outs[h.request_id] == h.output
            assert len(h.output) == 8


def test_replica_crash_respawn_and_error_handles(served):
    """A driver fault kills one replica; its in-flight handles finish with
    errors, the pool respawns it, the other replica is untouched, and new
    submissions succeed."""
    _, _, cfg, params = served
    factory = _factory(cfg, params, output_len=64, cache_len=128)
    with EngineReplicaPool(factory, replicas=2) as pool:
        h0 = pool.submit([2, 3, 5, 7], 64)
        h1 = pool.submit([11, 13, 17, 19], 64)
        assert {h0.replica_index, h1.replica_index} == {0, 1}
        victim = h0.replica_index
        pool.inject_fault(victim)

        events = list(h0.events(timeout=60.0))
        kind, err = events[-1]
        assert kind == "done" and err is not None and "died" in err
        assert h0.failed and h0.error == err

        out = h1.result(timeout=WAIT)     # the survivor's stream completes
        assert len(out) == 64 and h1.error is None

        assert _wait_for(lambda: len(pool.live_replicas()) == 2)
        assert pool.health()["status"] == "ok"
        assert pool.respawns == 1
        assert pool.replicas[victim].generation == 1

        out2 = pool.submit([23, 29, 31, 37], 6).result(timeout=WAIT)
        assert len(out2) == 6


def test_preemption_requeue_surfaced_in_stats(served):
    """An urgent request whose preemption finds a victim but no host
    capacity stays queued at its EDF position, counted once."""
    _, _, cfg, params = served
    scfg = _server_config(device_slots=1, host_slots=1, cache_len=256,
                          page_size=32, host_pool_pages=1, output_len=48,
                          recompute_fallback=False)
    with InferenceServer(cfg, params, scfg) as server:
        server.submit([1] * 12, max_new_tokens=48, priority=0)
        server.step()
        assert server.active == 1
        urgent = server.submit([2] * 200, max_new_tokens=4, priority=1)
        lowprio = server.submit([3] * 6, max_new_tokens=4, priority=0)
        for _ in range(4):
            server.step()
        stats = server.stats
        assert stats.preemption_requeues >= 1
        assert stats.preemptions == 0
        server.run_until_idle()
        assert urgent.done and not urgent.failed
        assert lowprio.done and not lowprio.failed
        assert server.stats.preemption_requeues == 1
        assert urgent.request.first_token_time \
            <= lowprio.request.first_token_time
        assert "preemption_requeues" in server.stats.snapshot()


# --- HTTP/SSE ---------------------------------------------------------------

@pytest.fixture(scope="module")
def gateway_stack(served):
    _, _, cfg, params = served
    pool = EngineReplicaPool(_factory(cfg, params), replicas=2)
    gateway, stop = serve_in_thread(pool, port=0, max_queue_depth=8)
    yield cfg, params, pool, gateway
    stop()
    pool.shutdown()


def test_sse_stream_bit_identical_to_direct_run(gateway_stack):
    cfg, params, _, gateway = gateway_stack
    prompt = [9, 8, 7, 6]
    with InferenceServer(cfg, params, _server_config()) as ref:
        expected = ref.submit(prompt, max_new_tokens=5).result()
    r = sse_chat(HOST, gateway.port, prompt, max_new_tokens=5, timeout=WAIT)
    assert r["status"] == 200 and r["error"] is None
    assert r["tokens"] == expected
    assert r["done"]["done"] is True
    assert r["done"]["tokens"] == len(expected)
    assert r["ttft_s"] is not None and r["ttft_s"] >= 0.0


def test_health_and_metrics_endpoints(gateway_stack):
    _, _, _, gateway = gateway_stack
    health = get_json(HOST, gateway.port, "/health")
    assert health["status"] == 200
    assert health["body"]["status"] == "ok"
    assert len(health["body"]["replicas"]) == 2
    assert all(rep["alive"] for rep in health["body"]["replicas"])

    metrics = get_text(HOST, gateway.port, "/metrics")
    assert metrics["status"] == 200
    sample = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*"
                        r"(\{[^}]*\})? -?[0-9.eE+-]+(\n|$)")
    families = set()
    for line in metrics["body"].strip().splitlines():
        if line.startswith("#"):
            assert re.match(r"^# (HELP|TYPE) [a-zA-Z_:][a-zA-Z0-9_:]*", line)
            continue
        assert sample.match(line), f"unparseable sample: {line!r}"
        families.add(line.split("{")[0].split(" ")[0])
    assert "apex_replica_up" in families
    assert "apex_engine_iterations_total" in families
    assert "apex_gateway_requests_total" in families
    helps = re.findall(r"# HELP (\S+)", metrics["body"])
    assert len(helps) == len(set(helps))


def test_bad_requests_rejected(gateway_stack):
    _, _, _, gateway = gateway_stack
    r = sse_chat(HOST, gateway.port, [], timeout=WAIT)
    assert r["status"] == 400
    assert get_json(HOST, gateway.port, "/nope")["status"] == 404


def test_backpressure_503_queue_full(served):
    _, _, cfg, params = served
    with EngineReplicaPool(_factory(cfg, params), replicas=1) as pool:
        gateway, stop = serve_in_thread(pool, port=0, max_queue_depth=0)
        try:
            r = sse_chat(HOST, gateway.port, [1, 2, 3], timeout=WAIT)
            assert r["status"] == 503
            assert "queue full" in r["error"]
            metrics = get_text(HOST, gateway.port, "/metrics")
            assert 'apex_gateway_shed_total{code="503"} 1' \
                in metrics["body"]
        finally:
            stop()


def test_backpressure_429_deadline_impossible(served):
    _, _, cfg, params = served
    with EngineReplicaPool(_factory(cfg, params), replicas=1) as pool:
        gateway, stop = serve_in_thread(pool, port=0, max_queue_depth=8)
        try:
            # the analytic perf model predicts a strictly positive prefill
            # time, so a zero deadline is impossible at the edge
            r = sse_chat(HOST, gateway.port, [1, 2, 3, 4], deadline=0.0,
                         timeout=WAIT)
            assert r["status"] == 429
            assert "deadline" in r["error"]
            assert pool.depth() == 0       # shed before any engine state
        finally:
            stop()


# --- session affinity -------------------------------------------------------

def test_session_affinity_sticky_and_failover(served):
    """A session is pinned to the replica of its first turn; a dead pin
    falls back to a live replica and re-pins.  The generation is part of
    the pin, so a respawned replica never satisfies a stale pin."""
    _, _, cfg, params = served
    with EngineReplicaPool(_factory(cfg, params), replicas=2) as pool:
        rep = pool.route("conv-a")
        for _ in range(4):                 # sticky regardless of load
            assert pool.route("conv-a") is rep
        other = pool.route("conv-b")       # independent pin
        assert pool.route("conv-b") is other

        h1 = pool.submit([2, 3, 5], 4, session_id="conv-a")
        h2 = pool.submit([2, 3, 5, 7], 4, session_id="conv-a")
        assert h1.replica_index == h2.replica_index == rep.index
        assert h1.result(timeout=WAIT) and h2.result(timeout=WAIT)
        assert pool.submit([2, 3], 4).result(timeout=WAIT)

        pool.inject_fault(rep.index)
        assert _wait_for(lambda: not pool.replicas[rep.index].alive
                         or pool.replicas[rep.index].generation
                         != rep.generation)
        rep2 = pool.route("conv-a")
        assert rep2.alive
        assert (rep2.index, rep2.generation) != (rep.index, rep.generation)
        assert pool.route("conv-a").index == rep2.index


def test_respawn_starts_before_it_is_published(served, monkeypatch):
    """The respawned replica's driver starts before the pool publishes
    it: held inside ``Replica.start``, the fresh replica is not yet in
    ``pool.replicas``, so a concurrent ``shutdown`` waits for it and then
    joins its running driver (it used to meet a published replica whose
    thread had not started, and ``join`` raised)."""
    _, _, cfg, params = served
    entered, go = threading.Event(), threading.Event()
    published = []
    holder = []
    start = Replica.start

    def held_start(self, on_death=None):
        if self.generation > 0:
            published.append(any(r is self for r in holder[0].replicas))
            entered.set()
            assert go.wait(WAIT)
        start(self, on_death)

    monkeypatch.setattr(Replica, "start", held_start)
    pool = EngineReplicaPool(_factory(cfg, params), replicas=2)
    holder.append(pool)
    errors = []

    def shutdown():
        try:
            pool.shutdown()
        except BaseException as exc:     # pragma: no cover - the old race
            errors.append(exc)

    try:
        pool.inject_fault(0)
        assert entered.wait(WAIT)
        assert published == [False]
        assert pool.replicas[0].generation == 0
        closer = threading.Thread(target=shutdown)
        closer.start()
    finally:
        go.set()
    closer.join(WAIT)
    assert not closer.is_alive() and errors == []
    assert pool.respawns == 1 and pool.replicas[0].generation == 1
    assert not any(r.driver_alive for r in pool.replicas)


def test_routing_while_respawn_builds(served):
    """While the respawn is held inside the factory, a pinned session
    routes to the live replica; a shutdown then closes the pool and the
    fresh replica is shut down unpublished."""
    _, _, cfg, params = served
    building, go = threading.Event(), threading.Event()
    builds = []
    make = _factory(cfg, params)

    def factory():
        builds.append(1)
        if len(builds) > 2:              # the respawn of replica 0
            building.set()
            assert go.wait(WAIT)
        return make()

    pool = EngineReplicaPool(factory, replicas=2)
    closer = threading.Thread(target=pool.shutdown)
    try:
        rep = pool.route("conv-a")
        assert rep.index == 0
        pool.inject_fault(0)
        assert building.wait(WAIT)
        assert not pool.replicas[0].alive
        rep2 = pool.route("conv-a")
        assert rep2.alive and rep2.index == 1
        assert pool.route("conv-a") is rep2
        closer.start()
        assert _wait_for(lambda: pool._closing, timeout=WAIT)
    finally:
        go.set()
    closer.join(WAIT)
    assert not closer.is_alive()
    assert pool.respawns == 0 and pool.replicas[0].generation == 0
    assert not pool.replicas[0].alive and len(builds) == 3


def test_session_affinity_over_http(gateway_stack):
    _, _, _, gateway = gateway_stack
    r1 = sse_chat(HOST, gateway.port, [4, 5, 6], max_new_tokens=3,
                  session_id="http-conv", timeout=WAIT)
    r2 = sse_chat(HOST, gateway.port, [4, 5, 6, 7, 8], max_new_tokens=3,
                  session_id="http-conv", timeout=WAIT)
    assert r1["status"] == r2["status"] == 200
    assert r1["done"]["replica"] == r2["done"]["replica"]


# --- the driver_crash fault -------------------------------------------------

def _crash_first_build(factory_kw, plan):
    """A factory whose first build carries ``plan``; respawns do not."""
    builds = []

    def factory(cfg, params):
        def build():
            kw = dict(factory_kw)
            if not builds:
                kw["fault_plan"] = plan
            builds.append(1)
            return InferenceServer(cfg, params, _server_config(**kw))
        return build
    return factory, builds


@pytest.mark.parametrize("at", [1, 3, 6])
def test_driver_crash_fires_from_drive(served, at):
    """``driver_crash@at`` fires on replica 0's at-th pump: the request
    streams the at - 1 tokens of the steps before it (one per step), then
    the crash's error; the replica respawns without the plan, and the
    other replica never sees the fault."""
    _, _, cfg, params = served
    make, builds = _crash_first_build(dict(output_len=32, cache_len=128),
                                      f"driver_crash@{at}")
    with EngineReplicaPool(make(cfg, params), replicas=2) as pool:
        dead = pool.replicas[0]
        h = pool.submit([2, 3, 5, 7], 32)
        assert h.replica_index == 0
        events = list(h.events(timeout=WAIT))
        assert events[-1] == ("done", h.error)
        assert "replica 0 driver died: FaultInjectedError: replica driver " \
            "crash (injected)" == h.error
        assert [e[0] for e in events[:-1]] == ["token"] * (at - 1)
        assert dead.server.engine.faults.snapshot()["fired"][
            "driver_crash"] == 1
        assert _wait_for(lambda: pool.respawns == 1
                         and pool.replicas[0].alive)
        fresh = pool.replicas[0]
        assert fresh is not dead and fresh.generation == 1
        assert fresh.server.engine.faults is None and len(builds) == 3
        assert pool.replicas[1].server.engine.faults is None
        h2 = pool.submit([2, 3, 5, 7], 32)
        assert len(h2.result(timeout=WAIT)) == 32
        assert pool.health()["status"] == "ok"


def test_driver_crash_reaches_only_its_replica(served):
    """A plan that crashes replica 0 while replica 1 streams: replica 1's
    request finishes cleanly and its engine counts no fault."""
    _, _, cfg, params = served
    make, _ = _crash_first_build(dict(output_len=24, cache_len=128),
                                 "driver_crash@4")
    with EngineReplicaPool(make(cfg, params), replicas=2) as pool:
        h0 = pool.submit([2, 3, 5, 7], 24)
        h1 = pool.submit([11, 13, 17, 19], 24)
        assert (h0.replica_index, h1.replica_index) == (0, 1)
        with pytest.raises(RuntimeError, match="injected"):
            h0.result(timeout=WAIT)
        assert len(h1.result(timeout=WAIT)) == 24 and h1.error is None
        assert _wait_for(lambda: pool.respawns == 1)
        assert pool.replicas[1].generation == 0


def test_fault_injector_driver_pump_matches_reference():
    """The hook's schedule is the reference's: the same plan fires on the
    same pumps."""
    from repro.serving.faults import FaultInjector as RefInjector

    def fired(injector, n):
        hits = []
        for i in range(n):
            try:
                injector.on_driver_pump()
            except Exception as exc:
                hits.append((i, str(exc)))
        return hits

    for plan in ("driver_crash@2x3", "driver_crash@5,host_error@1"):
        assert fired(FaultInjector.from_config(plan), 10) \
            == fired(RefInjector.from_config(plan), 10)


# --- across packages --------------------------------------------------------

@pytest.fixture(scope="module")
def ref_stack(served):
    rcfg, rparams, _, _ = served

    def factory():
        return RefServer(rcfg, rparams, RefServerConfig(
            device_slots=2, host_slots=3, cache_len=64, prompt_len=6,
            output_len=5, num_requests=5))

    pool = RefPool(factory, replicas=2)
    gateway, stop = ref_serve_in_thread(pool, port=0, max_queue_depth=8)
    yield pool, gateway
    stop()
    pool.shutdown()


CROSS_PROMPTS = [[9, 8, 7, 6], [2, 3, 5, 7, 11, 13], [40, 41], [1] * 12,
                 [63, 0, 31, 17, 5]]


def test_sse_streams_equal_reference_gateway(gateway_stack, ref_stack):
    """The same prompts through the reference's gateway and the port's:
    equal greedy SSE streams, and the same terminal event fields."""
    _, _, _, gateway = gateway_stack
    _, ref_gateway = ref_stack
    for i, prompt in enumerate(CROSS_PROMPTS):
        n = 3 + i
        mine = sse_chat(HOST, gateway.port, prompt, max_new_tokens=n,
                        timeout=WAIT)
        ref = sse_chat(HOST, ref_gateway.port, prompt, max_new_tokens=n,
                       timeout=WAIT)
        assert mine["status"] == ref["status"] == 200
        assert mine["tokens"] == ref["tokens"] and len(ref["tokens"]) == n
        assert set(mine["done"]) == set(ref["done"])
        assert mine["error"] is ref["error"] is None


def _labelled_families(text):
    """family -> set of label-name tuples of its samples."""
    out = {}
    for line in text.strip().splitlines():
        if line.startswith("#"):
            continue
        name, _, rest = line.partition("{")
        name = name.split(" ")[0]
        labels = tuple(sorted(re.findall(r'(\w+)="', rest))) if rest else ()
        out.setdefault(name, set()).add(labels)
    return out


# the port's own engine families: K/V occupancy and host-job polls, per
# replica
PORT_FAMILIES = {f"apex_engine_{name}_total" for name in (
    "kv_used_tokens", "kv_reserved_tokens", "host_consumes",
    "host_late_polls")}


def test_prometheus_families_match_reference(gateway_stack, ref_stack):
    """After both gateways served the cross prompts, ``render_prometheus``
    of the two pools gives the same families, each with the same label
    names, and the same HELP and TYPE lines; the port adds its own
    counter families, one sample per replica, and only those."""
    _, _, pool, gateway = gateway_stack
    ref_pool, ref_gateway = ref_stack
    for port in (gateway.port, ref_gateway.port):
        assert sse_chat(HOST, port, [5, 6, 7], max_new_tokens=4,
                        timeout=WAIT)["status"] == 200
    mine, ref = render_prometheus(pool), ref_render(ref_pool)
    fams = _labelled_families(mine)
    assert {f: fams.pop(f) for f in PORT_FAMILIES} == {
        f: {("replica",)} for f in PORT_FAMILIES}
    assert fams == _labelled_families(ref)
    meta = re.compile(r"^# (?:HELP|TYPE) (\S+) .*$", re.M)
    assert [m.group(0) for m in meta.finditer(mine)
            if m.group(1) not in PORT_FAMILIES] == \
        [m.group(0) for m in meta.finditer(ref)]
    assert re.search(r"^# TYPE apex_engine_host_late_polls_total counter$",
                     mine, re.M)
    sample = re.search(r'^apex_engine_kv_reserved_tokens_total'
                       r'\{replica="0"\} (\d+)$', mine, re.M)
    assert sample and int(sample.group(1)) > 0
    # the edge counters the gateway passes in render the same way
    counters = {"requests": 3, "streams": 2, "shed_429": 1, "shed_503": 0,
                "cancelled": 0, "errors": 0}
    head = [ln for ln in render_prometheus(pool, counters).splitlines()
            if ln.startswith("apex_gateway_")]
    assert head == [ln for ln in ref_render(ref_pool, counters).splitlines()
                    if ln.startswith("apex_gateway_")]


def test_health_keys_match_reference(gateway_stack, ref_stack):
    _, _, pool, _ = gateway_stack
    ref_pool, _ = ref_stack
    mine, ref = pool.health(), ref_pool.health()
    assert set(mine) == set(ref)
    assert [set(r) for r in mine["replicas"]] \
        == [set(r) for r in ref["replicas"]]
    assert mine["status"] == ref["status"] == "ok"
    assert set(pool.stats()[0]) >= {"replica", "generation",
                                    "listener_errors"}
