"""The port's spans and serving counters on the CPU: ``tracing.span`` is
free of ``record_function`` while no profiler runs; under
``torch.profiler`` the serving step's and the model's spans appear and
nest; the engine stamps admissions and counts K/V occupancy and host-job
polls."""
import dataclasses

import pytest
torch = pytest.importorskip("torch")  # the port needs PyTorch

from repro_torch import tracing
from repro_torch.configs import get_config
from repro_torch.models import init_params
from repro_torch.serving import Engine, EngineConfig, Request
from repro_torch.serving.request import Phase

ENGINE = dict(device_slots=2, host_slots=2, cache_len=64, chunk_tokens=8,
              prefix_cache_slots=1, perf_model="analytic:a10",
              host_workers=1, device="cpu")


@pytest.fixture(scope="module")
def model():
    cfg = dataclasses.replace(
        get_config("internlm2-20b").reduced(layers=2, d_model=64, vocab=128),
        param_dtype="float32", compute_dtype="float32")
    return cfg, init_params(cfg, seed=0, device="cpu")


def _requests(n=6):
    # a shared head, so retiring prompts publish and later ones hit
    return [Request(prompt=[3, 1, 4, 1, 5] + [7 + i] * (4 + 3 * i),
                    max_new_tokens=5) for i in range(n)]


def _serve(model, reqs, **kw):
    cfg, params = model
    engine = Engine(cfg, params, EngineConfig(**dict(ENGINE, **kw)))
    try:
        stats = engine.run(reqs)
    finally:
        engine.shutdown()
    return engine, stats


def test_span_is_a_shared_no_op_without_a_profiler(monkeypatch):
    def record_function(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", record_function)
    assert not torch.autograd._profiler_enabled()
    first, second = tracing.span("serve.step"), tracing.span("model.ffn")
    assert first is second
    with first:
        pass


def _program_spans(prof):
    out = {}
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        if name.startswith(("serve.", "model.")):
            s = ev.start_ns()
            out.setdefault(name, []).append((s, s + ev.duration_ns()))
    return out


def _inside(inner, outers):
    s, e = inner
    return any(os <= s and e <= oe for os, oe in outers)


def test_serving_spans_appear_and_nest(model):
    from torch.profiler import ProfilerActivity, profile
    reqs = _requests()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _serve(model, reqs)
    assert all(r.output for r in reqs)
    spans = _program_spans(prof)
    for name in ("serve.step", "serve.admit", "serve.schedule", "serve.plan",
                 "serve.host_submit", "serve.host_wait", "serve.commit",
                 "serve.finish_chunks", "serve.retire", "serve.publish",
                 "model.decode", "model.chunk", "model.attention",
                 "model.ffn"):
        assert spans.get(name), f"no {name} span"
    step = spans["serve.step"]
    for name in ("serve.admit", "serve.schedule", "serve.plan",
                 "serve.host_submit", "serve.host_wait", "serve.commit",
                 "serve.finish_chunks", "serve.retire", "model.decode",
                 "model.chunk"):
        assert all(_inside(iv, step) for iv in spans[name]), name
    # serve.step > model.decode > model.attention, one chain at least
    decode = [iv for iv in spans["model.decode"] if _inside(iv, step)]
    assert any(_inside(iv, decode) for iv in spans["model.attention"])
    assert any(_inside(iv, decode) for iv in spans["model.ffn"])
    # the retire hook publishes
    assert all(_inside(iv, spans["serve.retire"])
               for iv in spans["serve.publish"])


def test_admission_stamps_and_counters(model):
    reqs = _requests()
    engine, stats = _serve(model, reqs)
    for r in reqs:
        assert r.arrival_time <= r.admit_time <= r.first_token_time
    # every request decoded somewhere; some on the host tier
    assert stats.host_tokens > 0
    assert 0 <= stats.host_late_polls <= stats.host_consumes
    assert stats.host_consumes > 0
    rows = ENGINE["device_slots"] + len(engine.lc.staging) + 1
    assert stats.kv_reserved_tokens == \
        stats.iterations * rows * ENGINE["cache_len"]
    assert 0 < stats.kv_used_tokens <= stats.kv_reserved_tokens
    snap = stats.snapshot()
    assert snap["host_consumes"] == stats.host_consumes
    assert snap["host_late_polls"] == stats.host_late_polls
    assert snap["kv_used_tokens"] == stats.kv_used_tokens
    assert snap["kv_reserved_tokens"] == stats.kv_reserved_tokens


def test_kv_used_counts_each_row_kind(model):
    """One iteration's addend is the positions the decode slots, staging
    rows and prefix rows hold, from the requests' host-side lengths
    (checked on iterations that retire nothing, whose rows are the same
    after the step as when it counted them)."""
    cfg, params = model
    engine = Engine(cfg, params, EngineConfig(**dict(ENGINE,
                                                     enable_offload=False)))
    reqs = _requests(4)
    try:
        for r in reqs:
            engine.submit(r)
        kinds = set()
        while engine.has_work:
            before = engine.stats.kv_used_tokens
            finished = sum(r.phase is Phase.FINISHED for r in reqs)
            engine.step()
            if sum(r.phase is Phase.FINISHED for r in reqs) != finished:
                continue
            lc = engine.lc
            slots = sum(r.total_len - 1 for r in lc.slots
                        if r is not None and r.phase is Phase.DECODE_DEVICE)
            staging = sum(lc.staging[row].consumed
                          for row in lc.staging_order)
            prefix = sum(len(e.tokens) for e in engine.prefix.entries.values()
                         if e.tier == "device")
            assert engine.stats.kv_used_tokens - before == \
                slots + staging + prefix
            kinds |= {k for k, n in (("slots", slots), ("staging", staging),
                                     ("prefix", prefix)) if n}
        assert kinds == {"slots", "staging", "prefix"}
    finally:
        engine.shutdown()
