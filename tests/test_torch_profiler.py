"""Profiling-informed scheduling of the port against the JAX reference on
the CPU.

  * one ``TablePerfModel`` built from the same tables in both packages
    predicts the same times and rates (rtol 1e-12), and Algorithm 1 takes
    the same decisions on it;
  * a profile saved by either package loads in the other, and
    ``model_fingerprint`` strings agree;
  * ``PerfModelProvider`` treats a cached profile of another model or
    grid, a missing file and a wrong ``file:`` profile as the reference
    does;
  * the port's ``OfflineProfiler`` (plain versions on the CPU, reduced
    width) gives the reference's tables, grid and fingerprint;
  * a reference-style ``ServerConfig`` / ``EngineConfig`` with every
    fault, budget, prefill and profile field constructs in the port and
    reaches the engine.
"""
import dataclasses
import json

import numpy as np
import pytest
torch = pytest.importorskip("torch")  # the port needs PyTorch

from repro.configs import get_config as ref_get_config
from repro.core.perf_model import PerfModelProvider as RefProvider
from repro.core.perf_model import TablePerfModel as RefTable
from repro.core.perf_model import model_fingerprint as ref_fingerprint
from repro.core.profiler import OfflineProfiler as RefProfiler
from repro.core.scheduler import ApexScheduler as RefScheduler
from repro.models.config import FFNKind as RefFFNKind
from repro.serving import EngineConfig as RefEngineConfig
from repro.serving import ServerConfig as RefServerConfig
from repro_torch.configs import get_config
from repro_torch.core.perf_model import (STARTUP_PROFILE_GRID,
                                         OnlineCalibrator, PerfModelProvider,
                                         TablePerfModel, model_fingerprint,
                                         resolve_perf_model)
from repro_torch.core.profiler import OfflineProfiler
from repro_torch.core.scheduler import ApexScheduler
from repro_torch.models import init_params
from repro_torch.models.config import FFNKind
from repro_torch.serving import (Engine, EngineConfig, InferenceServer,
                                 ServerConfig)

# a few points per op, shaped like a real profile: a flat then rising
# linear table, attention linear in KV positions with an offset, the host
# tier ~10x slower (paper Fig. 1b), a noisy flat transfer tail
TABLES = {
    "linear": [(1.0, 0.020), (8.0, 0.0205), (32.0, 0.022), (128.0, 0.031)],
    "gatt": [(128.0, 2.1e-4), (512.0, 3.0e-4), (1024.0, 4.1e-4),
             (4096.0, 1.2e-3), (16384.0, 4.4e-3), (65536.0, 1.7e-2)],
    "catt": [(128.0, 1.5e-3), (512.0, 4.0e-3), (1024.0, 7.9e-3),
             (4096.0, 3.1e-2), (16384.0, 0.12), (65536.0, 0.49)],
    "transfer": [(65536.0, 4.0e-5), (1048576.0, 1.3e-4),
                 (16777216.0, 1.2e-4)],
    "prefill": [(1.0, 0.021), (8.0, 0.0215), (32.0, 0.024), (128.0, 0.040)],
}
GRID = dict(token_counts=[1, 8], kv_positions=[128, 512],
            transfer_sizes=[1 << 12])


def _configs():
    """(port, reference) configs: published llama3.1-8b and llama2-7b,
    reduced internlm2-1.8b, the reduced dense-FFN Jamba."""
    out = []
    for name in ("llama3.1-8b", "llama2-7b"):
        out.append((get_config(name), ref_get_config(name)))
    out.append((get_config("internlm2-1.8b").reduced(layers=4, d_model=64,
                                                     vocab=64),
                ref_get_config("internlm2-1.8b").reduced(
                    layers=4, d_model=64, vocab=64)))
    jam = get_config("jamba-1.5-large-398b").reduced(d_model=64, vocab=64)
    rjam = ref_get_config("jamba-1.5-large-398b").reduced(d_model=64,
                                                          vocab=64)
    out.append((dataclasses.replace(jam, ffn_kind=FFNKind.DENSE, moe=None),
                dataclasses.replace(rjam, ffn_kind=RefFFNKind.DENSE,
                                    moe=None)))
    return out


def _models(cfg, rcfg, **kw):
    from repro.core.perf_model import ModelCosts as RefCosts
    rc = RefCosts.from_config(rcfg)
    common = dict(kv_bytes_per_pos=rc.kv_bytes_per_pos,
                  num_attn_layers=rc.num_attn_layers,
                  state_bytes_per_row=rc.state_bytes_per_row, **kw)
    return (TablePerfModel(TABLES, fingerprint=model_fingerprint(cfg),
                           **common),
            RefTable(TABLES, fingerprint=ref_fingerprint(rcfg), **common))


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def test_fingerprints_match_reference():
    for cfg, rcfg in _configs():
        assert model_fingerprint(cfg) == ref_fingerprint(rcfg)


@pytest.mark.parametrize("pair", range(4))
def test_table_model_predictions_match_reference(pair):
    cfg, rcfg = _configs()[pair]
    ours, ref = _models(cfg, rcfg)
    approx = dict(rel=1e-12, abs=0.0)
    for batch in (1, 2, 3, 4, 6, 8, 16):
        for ctx in (1.0, 64.0, 128.0, 300.0, 512.0, 2048.0, 100000.0):
            for pre in (0, 1, 64, 200):
                a = ours.timings(batch, ctx, prefill_tokens=pre)
                b = ref.timings(batch, ctx, prefill_tokens=pre)
                assert dataclasses.asdict(a) == pytest.approx(
                    dataclasses.asdict(b), **approx)
            for layers in (None, 1, 3):
                assert ours.t_catt(batch, ctx, layers=layers) == \
                    pytest.approx(ref.t_catt(batch, ctx, layers=layers),
                                  **approx)
            assert ours.n_g(ctx) == pytest.approx(ref.n_g(ctx), **approx)
            assert ours.n_c(ctx) == pytest.approx(ref.n_c(ctx), **approx)
    for n in (0, 1, 17, 300, 5000):
        assert ours.t_migrate(n) == pytest.approx(ref.t_migrate(n), **approx)
        assert ours.t_prefill_suffix(n, 4 * n + 1) == pytest.approx(
            ref.t_prefill_suffix(n, 4 * n + 1), **approx)
        for emitted in (0, 5, 40):
            assert ours.t_recompute(n, emitted) == pytest.approx(
                ref.t_recompute(n, emitted), **approx)


@pytest.mark.parametrize("calibrated", [False, True])
def test_scheduler_decisions_on_tables_match_reference(calibrated):
    """Algorithm 1 over a sweep of queue snapshots (batches, contexts,
    whole-prompt and chunked prefill, urgent prefills): the same
    strategy, predicted time, chunk budget and sub-batches."""
    from repro.core.perf_model import OnlineCalibrator as RefCalibrator
    cfg, rcfg = _configs()[0]
    ours_m, ref_m = _models(cfg, rcfg)
    if calibrated:
        ours_m, ref_m = OnlineCalibrator(ours_m), RefCalibrator(ref_m)
        for pred, obs in ((0.02, 0.05), (0.03, 0.031), (0.05, 0.01)):
            ours_m.observe_step(pred, obs)
            ref_m.observe_step(pred, obs)
        ours_m.observe_host(0.01, 0.03)
        ref_m.observe_host(0.01, 0.03)
    ours, ref = ApexScheduler(ours_m), RefScheduler(ref_m)

    class Urgent:
        priority = 1

    seen = set()
    for gpu in (0, 1, 2, 4):
        for cpu in (0, 1, 3, 6):
            for ctx in (64.0, 200.0, 512.0, 4096.0):
                for pre, backlog, urgent in ((0, 0, False), (128, 0, False),
                                             (0, 300, False),
                                             (0, 40, False), (0, 300, True)):
                    prefill = ([Urgent()] if urgent else ["p"]) \
                        if (pre or backlog) else []
                    kw = dict(mean_context=ctx, prefill_tokens=pre,
                              chunk_backlog_tokens=backlog,
                              chunk_tokens_max=64 if backlog else 0)
                    a = ours.schedule(prefill, ["g"] * gpu, ["c"] * cpu,
                                      **kw)
                    b = ref.schedule(prefill, ["g"] * gpu, ["c"] * cpu,
                                     **kw)
                    assert a.strategy.value == b.strategy.value
                    assert a.chunk_tokens == b.chunk_tokens
                    assert a.predicted_time == pytest.approx(
                        b.predicted_time, rel=1e-12)
                    assert (a.sub_batch_1, a.sub_batch_2) == \
                        (b.sub_batch_1, b.sub_batch_2)
                    seen.add((a.strategy.value, a.chunk_tokens))
    # the sweep reaches every strategy and several chunk budgets
    assert {s for s, _ in seen} == {"gpu_only", "async_overlap",
                                    "asym_pipeline"}
    assert len({c for _, c in seen}) >= 3


def test_saved_profiles_load_in_either_package(tmp_path):
    cfg, rcfg = _configs()[2]
    grid = {k: list(v) for k, v in STARTUP_PROFILE_GRID.items()}
    ours, ref = _models(cfg, rcfg, profile_grid=grid)
    ours.save(tmp_path / "port.json")
    ref.save(tmp_path / "ref.json")
    assert json.loads((tmp_path / "port.json").read_text()) == \
        json.loads((tmp_path / "ref.json").read_text())
    theirs = RefTable.load(tmp_path / "port.json")
    mine = TablePerfModel.load(tmp_path / "ref.json")
    for a, b in ((mine, ref), (ours, theirs)):
        assert a.fingerprint == b.fingerprint
        assert a.profile_grid == b.profile_grid
        assert a.host_kv_bytes_per_pos == b.host_kv_bytes_per_pos
        for batch, ctx in ((1, 100.0), (4, 512.0), (32, 9000.0)):
            assert dataclasses.asdict(a.timings(batch, ctx, 64)) == \
                dataclasses.asdict(b.timings(batch, ctx, 64))
    # "file:" resolves the other package's profile in both
    spec = f"file:{tmp_path / 'ref.json'}"
    assert PerfModelProvider(cfg).resolve(spec).fingerprint == \
        RefProvider(rcfg).resolve(f"file:{tmp_path / 'port.json'}"
                                  ).fingerprint


def test_provider_cache_rules_match_reference(tmp_path):
    """A cache of another model, or of another grid when a grid is
    requested, is profiled again and overwritten; one of this model is
    loaded; ``file:`` refuses another model's profile; unknown specs and
    missing files raise -- in both packages."""
    cfg, rcfg = _configs()[2]
    other, rother = _configs()[3]
    outcomes = []
    for side in ("port", "ref"):
        prov_cls = PerfModelProvider if side == "port" else RefProvider
        kw = {"device": "cpu"} if side == "port" else {}
        c, oc = (cfg, other) if side == "port" else (rcfg, rother)
        table = TablePerfModel if side == "port" else RefTable
        fp = model_fingerprint if side == "port" else ref_fingerprint
        common = dict(kv_bytes_per_pos=1, num_attn_layers=1)
        res = []
        for name, cached_fp, cached_grid, want_grid in (
                ("stale model", fp(oc), GRID, None),
                ("no fingerprint", None, GRID, None),
                ("this model", fp(c), GRID, None),
                ("this model, its grid", fp(c), GRID, GRID),
                ("this model, another grid", fp(c), GRID,
                 dict(GRID, transfer_sizes=[1 << 13]))):
            path = tmp_path / f"{side}-{len(res)}.json"
            table(TABLES, fingerprint=cached_fp, profile_grid=cached_grid,
                  **common).save(path)
            m = prov_cls(c, profile_cache=str(path), profile_grid=want_grid,
                         **kw).resolve("measured")
            reprofiled = m.kv_bytes_per_pos != 1
            on_disk = json.loads(path.read_text())
            res.append((name, reprofiled, m.fingerprint == fp(c),
                        on_disk["fingerprint"] == fp(c),
                        on_disk["profile_grid"] == m.profile_grid))
        bad = tmp_path / f"{side}-other.json"
        table(TABLES, fingerprint=fp(oc), **common).save(bad)
        for spec in (f"file:{bad}", f"file:{tmp_path / 'missing.json'}",
                     "bogus", "analytic:tpu9"):
            with pytest.raises(ValueError):
                prov_cls(c, **kw).resolve(spec)
        outcomes.append(res)
    assert outcomes[0] == outcomes[1]
    assert [r[1] for r in outcomes[0]] == [True, True, False, False, True]


def test_offline_profiler_matches_reference_layout():
    """At a reduced width the port's profiler (plain versions on the CPU)
    and the reference's give the same ops, x points, grid, fingerprint
    and byte counts; every time is finite and positive."""
    cfg, rcfg = _configs()[2]
    kw = dict(token_counts=(1, 8, 32), kv_positions=(128, 1024, 4096),
              transfer_sizes=(1 << 16,))
    ours = OfflineProfiler(cfg, device="cpu").run(**kw)
    ref = RefProfiler(rcfg).run(**kw)
    assert ours.tables.keys() == ref.tables.keys()
    for op, (xs, ys) in ours.tables.items():
        assert xs.tolist() == ref.tables[op][0].tolist()
        assert np.isfinite(ys).all() and (ys > 0).all()
    assert ours.fingerprint == ref.fingerprint
    assert ours.profile_grid == ref.profile_grid
    for attr in ("kv_bytes_per_pos", "num_attn_layers",
                 "state_bytes_per_row", "host_kv_bytes_per_pos"):
        assert getattr(ours, attr) == getattr(ref, attr)
    # the prefill table sits on the linear table (attention on top)
    assert (ours.tables["prefill"][1] > ours.tables["linear"][1]).all()
    # the hybrid's one-layer weights come from its attention entry
    hyb, rhyb = _configs()[3]
    h = OfflineProfiler(hyb, device="cpu").run(**kw)
    assert h.fingerprint == ref_fingerprint(rhyb)
    assert h.state_bytes_per_row > 0


def test_reference_style_configs_construct_in_the_port(tmp_path):
    """Every field of the reference's ServerConfig / EngineConfig the
    port has ported is accepted, copied to the engine config and
    honoured: KV budgets, use_scheduler, bucketed_prefill, the fault
    plan, the watchdog and breaker knobs, the profile cache."""
    fields = dict(
        temperature=0.0, bucketed_prefill=False, use_scheduler=True,
        device_kv_budget_tokens=96, host_kv_budget_tokens=256,
        profile_cache=str(tmp_path / "p.json"),
        profile_grid=dict(GRID), fault_plan="latency_spike@1:0.01",
        host_job_slack=4.0, host_job_min_timeout=0.5,
        host_breaker_threshold=2, host_breaker_cooldown=0.5,
        degradation_window=3.0, perf_model="measured")
    RefServerConfig(**fields)
    RefEngineConfig(**fields)
    scfg = ServerConfig(device="cpu", device_slots=2, host_slots=2,
                        cache_len=64, **fields)
    ecfg = scfg.engine_config()
    for k, v in fields.items():
        assert getattr(ecfg, k) == v
    EngineConfig(**fields)
    cfg = get_config("internlm2-1.8b").reduced(layers=2, d_model=64,
                                               vocab=64)
    params = init_params(cfg, seed=0, device="cpu")
    with InferenceServer(cfg, params, scfg) as server:
        eng = server.engine
        assert eng.admission.device_kv_budget_tokens == 96
        assert eng.admission.host_kv_budget_tokens == 256
        assert eng.stats.degradation_window == 3.0
        assert eng.staging_state is None and eng.prefix is None
        assert eng.faults is not None
        assert (tmp_path / "p.json").exists()       # profiled, cached
        handles = [server.submit([3, 5, 7, 11 + i], max_new_tokens=4)
                   for i in range(3)]
        server.run_until_idle()
        assert all(h.done and not h.failed and len(h.output) == 4
                   for h in handles)
        assert eng.stats.prefill_chunks == 0       # whole-prompt prefill
    # the cached profile is reused: a second engine loads it
    model = resolve_perf_model("measured", cfg, profile_cache=str(
        tmp_path / "p.json"), profile_grid=dict(GRID), device="cpu")
    assert model.fingerprint == model_fingerprint(cfg)
    eng = Engine(cfg, params, EngineConfig(device="cpu", use_scheduler=False,
                                           device_slots=2, host_slots=2,
                                           cache_len=64))
    try:
        assert eng.scheduler is None and eng._calibrator is None
    finally:
        eng.shutdown()
