"""The port's MoE FFN against the JAX reference on the CPU.

  * ``moe_ffn`` on the same numpy-seeded tokens and bridged weights: the
    dropless path (n = 256), the capacity path (n = 257) and a call that
    drops assignments, with and without shared experts (DeepSeek-MoE and
    Jamba, reduced), at the reference's kernel tolerances (fp32 1e-5,
    bf16 2e-2); the top-k ids, capacity positions and drop masks equal
    the reference's, ties going to the lower expert id;
  * the reduced models -- deepseek-moe-16b, kimi-k2-1t-a32b and Jamba as
    published -- prefill and decode logits (fp32 KV cache, 1e-4) and
    greedy tokens, and a bucketed prefill long enough for the capacity
    path, with padded positions in its routing;
  * the serving engine with host rows on reduced deepseek: the reference
    engine's greedy streams;
  * ``OfflineProfiler`` refuses a stack whose profiled entry has an MoE
    FFN, by name, where the reference raises ``KeyError``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
torch = pytest.importorskip("torch")  # the port needs PyTorch

from repro.configs import get_config as ref_get_config
from repro.core.profiler import OfflineProfiler as RefProfiler
from repro.models import decode_step as _ref_decode
from repro.models import init_decode_state as ref_state
from repro.models import init_params as ref_init
from repro.models import moe as ref_moe
from repro.models import prefill as _ref_prefill
from repro.models import prefill_bucketed as _ref_bucketed
from repro.serving import Engine as RefEngine
from repro.serving import EngineConfig as RefEngineConfig
from repro.serving import Request as RefRequest
from repro_torch.configs import get_config
from repro_torch.core.profiler import OfflineProfiler
from repro_torch.models import (decode_step, init_decode_state,
                                init_params, moe, params_from_numpy, prefill,
                                prefill_bucketed)
from repro_torch.models.config import BlockKind
from repro_torch.models.kv_cache import AttnKV, StackState
from repro_torch.models.ssm import MambaState
from repro_torch.serving import Engine, EngineConfig, Request

ref_decode = jax.jit(_ref_decode, static_argnums=(1,))
ref_prefill = jax.jit(_ref_prefill, static_argnums=(1,))
ref_bucketed = jax.jit(_ref_bucketed, static_argnums=(1,),
                       static_argnames=("cache_len", "kv_dtype"))

FP32 = dict(param_dtype="float32", compute_dtype="float32")
MOE_ARCHS = ["deepseek-moe-16b", "kimi-k2-1t-a32b", "jamba-1.5-large-398b"]
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads while this file runs: its tensors are small,
    and the suite runs beside other workers' timing-sensitive tests."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _leaf(a):
    """numpy / jax leaf -> torch, bf16 bit-exact through a uint16 view."""
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


# ---------------------------------------------------------------------------
# the MoE FFN alone
# ---------------------------------------------------------------------------

# (tokens, capacity factor): the last dropless size, the first capacity
# size, and a capacity call whose factor forces drops
MOE_CASES = {"dropless-256": (256, 1.25), "capacity-257": (257, 1.25),
             "drops-300": (300, 0.5)}


def _ref_slots(rparams, tokens, mcfg, cap):
    """The reference's routing and capacity positions, in its own ops
    (``repro/models/moe.py:78-94``)."""
    probs = jax.nn.softmax(tokens.astype(jnp.float32) @ rparams["router"],
                           axis=-1)
    _, top_ids = jax.lax.top_k(probs, mcfg.top_k)
    flat = top_ids.reshape(-1)
    order = jnp.argsort(flat, stable=True)
    srt = flat[order]
    first = jnp.searchsorted(srt, srt, side="left")
    pos = jnp.zeros(flat.shape, jnp.int32).at[order].set(
        jnp.arange(flat.shape[0], dtype=jnp.int32) - first)
    return np.asarray(top_ids), np.asarray(pos), np.asarray(pos < cap)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(MOE_CASES))
@pytest.mark.parametrize("arch", ["deepseek-moe-16b",
                                  "jamba-1.5-large-398b"])
def test_moe_ffn_matches_reference(arch, case, dtype):
    """Same tokens, same weights: outputs and the load-balance loss agree
    at the kernel tolerance, the path taken is the reference's, and on
    the capacity path the expert ids, positions and drop masks are the
    reference's exactly."""
    n, factor = MOE_CASES[case]
    mcfg = get_config(arch).reduced(d_model=64).moe
    rcfg = ref_get_config(arch).reduced(d_model=64).moe
    assert (mcfg.num_shared_experts > 0) == (arch == "deepseek-moe-16b")
    rparams = ref_moe.moe_init(jax.random.PRNGKey(1), 64, rcfg,
                               getattr(jnp, dtype))
    params = {k: _leaf(v) for k, v in rparams.items()}
    x = np.random.default_rng(n).standard_normal((1, n, 64)).astype(
        np.float32)
    jx, tx = jnp.asarray(x, getattr(jnp, dtype)), torch.from_numpy(x).to(
        getattr(torch, dtype))
    rout, raux = ref_moe.moe_ffn(rparams, jx, rcfg, capacity_factor=factor)
    moe.COUNTS.reset()
    out, aux = moe.moe_ffn(params, tx, mcfg, capacity_factor=factor)
    np.testing.assert_allclose(_np(out), _np(rout), rtol=TOL[dtype],
                               atol=TOL[dtype])
    np.testing.assert_allclose(float(aux), float(raux), rtol=1e-5)
    counts = moe.COUNTS.snapshot()
    capacity = n > moe.DROPLESS_TOKEN_THRESHOLD
    assert counts["capacity"] == int(capacity)
    assert counts["dropless"] == int(not capacity)
    if not capacity:
        return
    cap = moe.expert_capacity(n, mcfg, factor)
    assert cap == ref_moe.expert_capacity(n, rcfg, factor)
    rids, rpos, rkeep = _ref_slots(rparams, jx.reshape(n, 64), rcfg, cap)
    _, _, ids = moe._route(params, tx.reshape(n, 64), mcfg)
    np.testing.assert_array_equal(ids.numpy(), rids)
    pos, keep = moe.capacity_slots(ids.reshape(-1), cap)
    np.testing.assert_array_equal(pos.numpy(), rpos)
    np.testing.assert_array_equal(keep.numpy(), rkeep)
    assert counts["dropped"] == int((~rkeep).sum())
    assert (counts["dropped"] > 0) == (case == "drops-300")


def test_topk_ties_go_to_the_lower_expert_id():
    """Equal router probabilities pick the lower expert ids, in order, as
    ``jax.lax.top_k`` does -- the capacity positions follow from it."""
    mcfg = get_config("deepseek-moe-16b").reduced().moe   # 8 experts, top 2
    router = np.zeros((4, mcfg.num_experts), np.float32)
    router[0, [5, 2, 7]] = 1.0       # token 0: three-way tie at the top
    router[1, [6, 1]] = 2.0          # token 1: two-way tie
    tokens = np.eye(4, dtype=np.float32)
    _, ids = jax.lax.top_k(jax.nn.softmax(jnp.asarray(tokens @ router), -1),
                           mcfg.top_k)
    _, _, mine = moe._route({"router": torch.from_numpy(router)},
                            torch.from_numpy(tokens), mcfg)
    np.testing.assert_array_equal(mine.numpy(), np.asarray(ids))
    assert mine[0].tolist() == [2, 5] and mine[1].tolist() == [1, 6]


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

_MODELS = {}


def _model_pair(arch):
    """(reference cfg, reference params, port cfg, port params), reduced to
    d_model 64 in fp32, the reference's weights carried across."""
    if arch not in _MODELS:
        rcfg = dataclasses.replace(
            ref_get_config(arch).reduced(d_model=64, vocab=64), **FP32)
        cfg = dataclasses.replace(
            get_config(arch).reduced(d_model=64, vocab=64), **FP32)
        rparams = ref_init(jax.random.PRNGKey(0), rcfg)
        _MODELS[arch] = (rcfg, rparams, cfg, params_from_numpy(
            cfg, jax.tree.map(np.asarray, rparams), "cpu"))
    return _MODELS[arch]


def _port_state(cfg, rst):
    """The reference's StackState as the port's, leaf for leaf."""
    entries = tuple(
        (AttnKV if kind == BlockKind.ATTN else MambaState)(
            *(_leaf(v) for v in e))
        for kind, e in zip(cfg.block_pattern, rst.per_entry))
    return StackState(per_entry=entries, lengths=_leaf(rst.lengths))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_init_and_bridge_keep_the_reference_layout(arch):
    """The port's random init names, shapes and types every expert leaf as
    the reference does, and ``params_from_numpy`` carries the reference's
    expert leaves across bit for bit (the bridge is generic over dicts)."""
    rcfg, rparams, cfg, params = _model_pair(arch)
    ours = init_params(cfg, seed=0, device="cpu")
    flat = jax.tree_util.tree_flatten_with_path
    theirs = {jax.tree_util.keystr(k): v
              for k, v in flat(tuple(rparams.blocks))[0]}
    mine = {jax.tree_util.keystr(k): v
            for k, v in flat(tuple(ours.blocks))[0]}
    bridged = {jax.tree_util.keystr(k): v
               for k, v in flat(tuple(params.blocks))[0]}
    assert mine.keys() == theirs.keys() == bridged.keys()
    assert any("we_gate" in key for key in theirs)
    for key, v in theirs.items():
        assert tuple(mine[key].shape) == v.shape, key
        assert str(mine[key].dtype).replace("torch.", "") == str(v.dtype)
        np.testing.assert_array_equal(bridged[key].numpy(), np.asarray(v))
    for j in range(cfg.pattern_period):
        has_router = "router" in params.blocks[j]["ffn"]
        assert has_router == (cfg.ffn_kind_for_entry(j).value == "moe")


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_decode_match_reference(arch):
    """Prefill and five greedy decode steps (fp32 KV cache): the same
    tokens, and logits at 1e-4.  Each step runs from the reference's own
    state, so a hybrid's bf16 conv window cannot carry a one-ULP parting
    forward (ROADMAP queue 3); the free-running chains are held to greedy
    tokens."""
    rcfg, rparams, cfg, params = _model_pair(arch)
    prompt = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 9))
    rst = ref_state(rcfg, device_batch=2, cache_len=32, kv_dtype=jnp.float32)
    rlog, rst = ref_prefill(rparams, rcfg,
                            {"tokens": jnp.asarray(prompt, jnp.int32)}, rst)
    st = init_decode_state(cfg, device_batch=2, cache_len=32, device="cpu",
                           kv_dtype=torch.float32)
    moe.COUNTS.reset()
    log, st = prefill(params, cfg, {"tokens": torch.from_numpy(prompt)}, st)
    np.testing.assert_allclose(_np(log), _np(rlog), rtol=1e-4, atol=1e-4)
    for _ in range(5):
        rtok = np.argmax(np.asarray(rlog), -1)
        np.testing.assert_array_equal(log.argmax(-1).numpy(), rtok)
        here = _port_state(cfg, rst)
        rlog, rst, _, _ = ref_decode(rparams, rcfg,
                                     jnp.asarray(rtok, jnp.int32), rst)
        one, _, _, _ = decode_step(params, cfg, torch.from_numpy(rtok), here)
        np.testing.assert_allclose(_np(one), _np(rlog), rtol=1e-4,
                                   atol=1e-4)
        log, st, _, _ = decode_step(params, cfg,
                                    log.argmax(-1), st)
    np.testing.assert_array_equal(log.argmax(-1).numpy(),
                                  np.argmax(np.asarray(rlog), -1))
    counts = moe.COUNTS.snapshot()
    assert counts["dropless"] > 0 and counts["capacity"] == 0


@pytest.mark.parametrize("arch", ["deepseek-moe-16b",
                                  "jamba-1.5-large-398b"])
def test_bucketed_prefill_on_the_capacity_path(arch):
    """Four right-padded prompts in one call, 4 x 96 = 384 tokens: the
    capacity path, whose routing sees the padded positions (they pile onto
    the same experts, so assignments are dropped), as in the reference.
    Logits of each prompt's last real token at 1e-4."""
    rcfg, rparams, cfg, params = _model_pair(arch)
    rng = np.random.default_rng(3)
    plens = [96, 40, 71, 17]
    tokens = np.zeros((4, 96), np.int64)
    for i, n in enumerate(plens):
        tokens[i, :n] = rng.integers(1, cfg.vocab_size, n)
    lens = np.array(plens, np.int64)
    moe.COUNTS.reset()
    logits, _ = prefill_bucketed(params, cfg, torch.from_numpy(tokens),
                                 torch.from_numpy(lens), cache_len=128,
                                 kv_dtype=torch.float32)
    rlogits, _ = ref_bucketed(rparams, rcfg, jnp.asarray(tokens, jnp.int32),
                              jnp.asarray(lens, jnp.int32), cache_len=128,
                              kv_dtype=jnp.float32)
    np.testing.assert_allclose(_np(logits), _np(rlogits), rtol=1e-4,
                               atol=1e-4)
    counts = moe.COUNTS.snapshot()
    assert counts["capacity"] > 0 and counts["dropped"] > 0


def test_engine_with_host_rows_matches_reference_engine():
    """Reduced deepseek at fp32, whole-prompt bucketed prefill, two device
    and four host slots: the port's engine emits the reference engine's
    greedy streams, with tokens decoded on both tiers."""
    rcfg, rparams, cfg, params = _model_pair("deepseek-moe-16b")
    rng = np.random.default_rng(1)
    protos = [rng.integers(1, 64, (n,)).tolist() for n in (5, 11, 3, 17, 8)]
    kw = dict(device_slots=2, host_slots=4, cache_len=64,
              perf_model="analytic:a10", host_workers=2, chunk_tokens=0,
              prefix_cache=False, tier_rebalance=False, preemption=False)

    def streams(engine, request_cls):
        reqs = [request_cls(prompt=list(p), max_new_tokens=6) for p in protos]
        try:
            stats = engine.run(reqs)
        finally:
            engine.shutdown()
        return [r.output for r in reqs], stats

    ref_out, ref_stats = streams(RefEngine(rcfg, rparams,
                                           RefEngineConfig(**kw)), RefRequest)
    out, stats = streams(Engine(cfg, params, EngineConfig(**kw,
                                                          device="cpu")),
                         Request)
    assert out == ref_out
    assert all(len(o) == 6 for o in out)
    assert stats.host_tokens > 0 and ref_stats.host_tokens > 0


# ---------------------------------------------------------------------------
# the profiler
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_profiler_names_the_moe_gap(arch):
    """The reference profiles one layer built from pattern entry 0 as a
    dense MLP: an MoE entry 0 (deepseek, kimi) raises ``KeyError`` there;
    the port refuses it by name and points at ``--perf-model analytic``.
    Jamba's entry 0 has a dense FFN, and both packages profile it."""
    cfg = get_config(arch).reduced(d_model=64, vocab=64)
    rcfg = ref_get_config(arch).reduced(d_model=64, vocab=64)
    if cfg.ffn_kind_for_entry(0).value == "moe":
        with pytest.raises(KeyError, match="w_gate"):
            RefProfiler(rcfg).profile_linear([1])
        with pytest.raises(NotImplementedError,
                           match="perf-model analytic"):
            OfflineProfiler(cfg, device="cpu")
    else:
        table = OfflineProfiler(cfg, device="cpu").profile_linear([1])
        assert len(RefProfiler(rcfg).profile_linear([1])) == len(table) == 1
        assert table[0][1] > 0


@pytest.mark.parametrize("n", [1, 3, 16])
def test_dropless_path_matches_reference_at_decode_sizes(n):
    """64 experts top-2, as few tokens as a decode step (n * k from 2 to
    32 of 64 experts): the dropless path, which runs every expert over
    every token, gives the reference's dropless output."""
    from repro.models.config import MoEConfig as RefMoEConfig
    from repro_torch.models.config import MoEConfig
    kw = dict(num_experts=64, top_k=2, expert_ffn_dim=32,
              num_shared_experts=1, shared_ffn_dim=32)
    mcfg, rcfg = MoEConfig(**kw), RefMoEConfig(**kw)
    rparams = ref_moe.moe_init(jax.random.PRNGKey(2), 64, rcfg, jnp.float32)
    params = {k: _leaf(v) for k, v in rparams.items()}
    x = np.random.default_rng(n).standard_normal((1, n, 64)).astype(
        np.float32)
    rout, _ = ref_moe.moe_ffn(rparams, jnp.asarray(x), rcfg)
    moe.COUNTS.reset()
    out, _ = moe.moe_ffn(params, torch.from_numpy(x), mcfg)
    np.testing.assert_allclose(_np(out), _np(rout), rtol=1e-5, atol=1e-5)
    assert moe.COUNTS.snapshot()["dropless"] == 1
