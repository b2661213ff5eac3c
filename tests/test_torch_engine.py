"""The port's serving engine on the CPU: against the reference engine,
and its own APEX exactness bar (host-offloaded rows emit the tokens
device rows emit), as tests/test_overlap.py and examples/quickstart.py
hold the reference to.
"""
import dataclasses

import jax
import numpy as np
import pytest
torch = pytest.importorskip("torch")  # the port needs PyTorch

from repro.configs import get_config as ref_get_config
from repro.core.analytical import Timings as RefTimings
from repro.core.perf_model import analytic_model as ref_analytic_model
from repro.core.scheduler import ApexScheduler as RefScheduler
from repro.models import init_params as ref_init
from repro.serving import Engine as RefEngine
from repro.serving import EngineConfig as RefEngineConfig
from repro.serving import Request as RefRequest
from repro_torch.configs import get_config
from repro_torch.core.analytical import Timings
from repro_torch.core.overlap_engine import Cohort, OverlapController
from repro_torch.core.perf_model import PLATFORMS, analytic_model
from repro_torch.core.scheduler import ApexScheduler, Decision, StrategyKind
from repro_torch.models import (decode_step, init_decode_state, init_params,
                                params_from_numpy, prefill)
from repro_torch.models.kv_cache import PagedKVPool
from repro_torch.serving import (Engine, EngineConfig, InferenceServer,
                                 Request, ServerConfig)

QUICKSTART_PROMPT = [5, 42, 7, 1, 99, 3, 17, 56]
# the quickstart's engine shape; the features this slice lacks off on the
# reference side (chunked prefill, prefix cache, rebalance, preemption)
COMMON = dict(device_slots=1, host_slots=2, cache_len=64,
              perf_model="analytic:a10", host_workers=2)
REF_ONLY = dict(chunk_tokens=0, prefix_cache=False, tier_rebalance=False,
                preemption=False)


@pytest.fixture(scope="module")
def llama_pair():
    """llama3.1-8b reduced as in examples/quickstart.py, fp32, reference
    weights carried across."""
    kw = dict(layers=4, d_model=128, vocab=512)
    rcfg = dataclasses.replace(ref_get_config("llama3.1-8b").reduced(**kw),
                               param_dtype="float32")
    cfg = dataclasses.replace(get_config("llama3.1-8b").reduced(**kw),
                              param_dtype="float32")
    rparams = ref_init(jax.random.PRNGKey(0), rcfg)
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, rparams), "cpu")
    return rcfg, rparams, cfg, params


def _run(engine, prompts, n_new, request_cls):
    reqs = [request_cls(prompt=list(p), max_new_tokens=n_new)
            for p in prompts]
    stats = engine.run(reqs)
    engine.shutdown()
    return [r.output for r in reqs], stats


def test_engine_matches_reference_engine(llama_pair):
    """The quickstart scenario plus three more prompts of other lengths:
    one device slot, so most of them decode on the host tier."""
    rcfg, rparams, cfg, params = llama_pair
    rng = np.random.default_rng(1)
    prompts = [QUICKSTART_PROMPT] * 2 + [
        rng.integers(0, 512, n).tolist() for n in (7, 12, 5)]
    common = dict(COMMON, host_slots=4)
    ref_out, ref_stats = _run(
        RefEngine(rcfg, rparams, RefEngineConfig(**common, **REF_ONLY)),
        prompts, 8, RefRequest)
    out, stats = _run(Engine(cfg, params, EngineConfig(**common,
                                                       device="cpu")),
                      prompts, 8, Request)
    assert stats.host_tokens > 0 and ref_stats.host_tokens > 0
    assert out == ref_out
    assert stats.device_tokens + stats.host_tokens == \
        ref_stats.device_tokens + ref_stats.host_tokens


def test_quickstart_twin_raw_device_host_agree(llama_pair):
    _, _, cfg, params = llama_pair
    state = init_decode_state(cfg, device_batch=1, cache_len=64,
                              device="cpu")
    logits, state = prefill(params, cfg, {"tokens": torch.tensor(
        [QUICKSTART_PROMPT])}, state)
    toks = [int(logits.argmax(-1)[0])]
    for _ in range(7):
        logits, state, _, _ = decode_step(params, cfg,
                                          torch.tensor([toks[-1]]), state)
        toks.append(int(logits.argmax(-1)[0]))
    with InferenceServer(cfg, params, ServerConfig(
            device_slots=1, host_slots=2, cache_len=64, host_workers=2,
            device="cpu")) as server:
        h1 = server.submit(Request(prompt=list(QUICKSTART_PROMPT),
                                   max_new_tokens=8))
        h2 = server.submit(list(QUICKSTART_PROMPT), max_new_tokens=8)
        streamed = list(h2.tokens())
        stats = server.run_until_idle()
    assert stats.host_tokens > 0
    assert h1.output == toks and streamed == toks


class _AlwaysPipeline:
    """Scheduler stub forcing the blocking ASYM_PIPELINE dispatch."""

    def schedule(self, prefill, decode_gpu, decode_cpu, *, mean_context,
                 prefill_tokens=0):
        if not decode_cpu:
            return Decision(StrategyKind.GPU_ONLY, list(prefill),
                            list(decode_gpu), [], reason="stub")
        return Decision(StrategyKind.ASYM_PIPELINE, list(prefill),
                        list(decode_gpu), list(decode_cpu), reason="stub")


@pytest.mark.parametrize("scheduler", ["algorithm1", "always_pipeline"])
def test_device_rows_match_host_rows(scheduler):
    """Twin of tests/test_overlap.py: offloaded requests emit the tokens
    they would emit device-resident."""
    cfg = get_config("internlm2-1.8b").reduced(layers=None, d_model=128,
                                               vocab=64)
    params = init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, 7).tolist() for _ in range(5)]
    ref_out, _ = _run(Engine(cfg, params, EngineConfig(
        device_slots=6, cache_len=64, enable_offload=False, device="cpu")),
        prompts, 6, Request)
    sched = _AlwaysPipeline() if scheduler == "always_pipeline" else None
    out, stats = _run(Engine(cfg, params, EngineConfig(
        device_slots=2, host_slots=5, cache_len=64, host_workers=2,
        device="cpu"), scheduler=sched), prompts, 6, Request)
    assert stats.host_tokens > 0
    assert out == ref_out
    hybrid = (stats.strategy_counts.get(StrategyKind.ASYNC_OVERLAP.value, 0)
              + stats.strategy_counts.get(StrategyKind.ASYM_PIPELINE.value,
                                          0))
    assert hybrid > 0
    assert stats.prefill_compilations >= 1


def test_entry_points_need_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("internlm2-1.8b").reduced(layers=2, d_model=64)
    params = init_params(cfg, seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(cfg, params, EngineConfig(enable_offload=False))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceServer(cfg, params, ServerConfig(enable_offload=False))
    from repro_torch.launch import serve
    monkeypatch.setattr("sys.argv", ["serve"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main()
    eng = Engine(cfg, params, EngineConfig(enable_offload=False,
                                           device="cpu"))
    assert eng.device.type == "cpu"
    eng.shutdown()


def test_cohort_windows_tile_the_stack():
    """Every layer is committed exactly once per token journey and every
    attention layer emits its Q/K/V once."""
    cfg = get_config("llama3.1-8b").reduced(layers=4)
    ctl = OverlapController(cfg)
    cohort = Cohort(slot_rids=[0], positions=np.zeros(1, np.int64),
                    x_carry=torch.zeros((1, cfg.d_model)),
                    attn_in=torch.zeros((1, cfg.num_heads,
                                         cfg.resolved_head_dim)))
    covered, emitted = [], []
    for _ in range(ctl.iterations_per_token):
        io = ctl.host_io(cohort)
        covered.extend(range(io.window_start, io.window_end))
        if io.emit_layer >= 0:
            emitted.append(io.emit_layer)
        ctl.advance(cohort)
    assert sorted(covered) == list(range(cfg.num_layers))
    assert sorted(emitted) == list(cfg.attn_layer_indices)
    assert cohort.attn_ptr == -1


def test_paged_pool_chains_and_reuse():
    pool = PagedKVPool(16, 4, 2, 2, 8)
    assert pool.can_admit(12) and not pool.can_admit(40)
    pool.allocate(1, 6)
    assert pool.num_free == 12
    k = np.arange(6 * 2 * 8, dtype=np.float32).reshape(6, 2, 8)
    for li in range(2):
        pool.write_prompt(1, li, k + li, -k, advance=li == 1)
    pool.append_rows([1], 0, np.array([6]), k[:1] + 100, k[:1])
    pool.append_rows([1], 1, np.array([6]), k[:1] + 200, k[:1])
    pool.lengths[1] += 1
    gk, gv = pool.gather(1, 1)
    np.testing.assert_array_equal(gk[:6], k + 1)
    np.testing.assert_array_equal(gk[6], k[0] + 200)
    np.testing.assert_array_equal(gv[:6], -k)
    pool.free(1)
    assert pool.num_free == 16 and not pool.lengths


def _dense_jamba(get, ffn_kind):
    return dataclasses.replace(
        get("jamba-1.5-large-398b").reduced(d_model=64, vocab=64),
        ffn_kind=ffn_kind, moe=None)


def test_algorithm1_decisions_match_reference():
    assert "h100" in PLATFORMS and "v5e" not in PLATFORMS
    from repro.models.config import FFNKind as RefFFNKind
    from repro_torch.models.config import FFNKind
    pairs = [(get_config("llama3.1-8b"), ref_get_config("llama3.1-8b")),
             # the reduced hybrid: Mamba state priced per row
             (_dense_jamba(get_config, FFNKind.DENSE),
              _dense_jamba(ref_get_config, RefFFNKind.DENSE))]
    for cfg, rcfg in pairs:
        ours_model = analytic_model("a10", cfg)
        theirs_model = ref_analytic_model("a10", rcfg)
        assert ours_model.costs.state_bytes_per_row == \
            theirs_model.costs.state_bytes_per_row
        assert (ours_model.costs.state_bytes_per_row > 0) == \
            cfg.has_recurrent
        ours = ApexScheduler(ours_model)
        theirs = RefScheduler(theirs_model)
        for gpu, cpu, pre, ctx in [(4, 0, 0, 512.0), (4, 4, 0, 512.0),
                                   (1, 8, 0, 4096.0), (2, 6, 128, 1024.0),
                                   (8, 2, 0, 64.0)]:
            a = ours.schedule(["p"] * (pre > 0), ["g"] * gpu, ["c"] * cpu,
                              mean_context=ctx, prefill_tokens=pre)
            b = theirs.schedule(["p"] * (pre > 0), ["g"] * gpu, ["c"] * cpu,
                                mean_context=ctx, prefill_tokens=pre)
            assert a.strategy.value == b.strategy.value
            assert a.predicted_time == pytest.approx(b.predicted_time,
                                                     rel=1e-12)
    cfg = get_config("llama3.1-8b")
    t = analytic_model("h100", cfg).timings(4, 512.0)
    assert isinstance(t, Timings) and t.t_glinear > 0 and t.n_g > t.n_c
    assert RefTimings.__dataclass_fields__.keys() == \
        Timings.__dataclass_fields__.keys()
