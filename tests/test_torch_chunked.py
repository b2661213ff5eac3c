"""The port's chunked prefill against the JAX reference on the CPU.

Two levels, fed the same numpy-seeded inputs and the reference's weights:

  * the model: ``prefill_chunk`` advancing one staging row chunk by chunk
    (chunk 1, 4 and the whole prompt, at the engine's fixed chunk
    geometry) gives the reference's logits and K/V at the established
    bars -- fp32 cache 1e-4, bf16 cache 2e-3 plus greedy -- and, within
    the port, a whole-prompt prefill's at the same bars;
  * the engine: with chunked prefill at ``chunk_tokens`` 1, 4 and 64
    (prompts longer than the chunk, so they span several iterations
    beside decode), the port's engine emits the reference engine's
    greedy token streams on the device tier, the host tier and the
    Mamba hybrid.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")  # the port needs PyTorch

from repro.configs import get_config as ref_get_config
from repro.models import init_decode_state as ref_state
from repro.models import init_params as ref_init
from repro.models import prefill_chunk as _ref_prefill_chunk
from repro.models.config import FFNKind as RefFFNKind
from repro.serving import Engine as RefEngine
from repro.serving import EngineConfig as RefEngineConfig
from repro.serving import Request as RefRequest
from repro_torch.configs import get_config
from repro_torch.models import (init_decode_state, params_from_numpy,
                                prefill, prefill_chunk)
from repro_torch.models.config import BlockKind, FFNKind
from repro_torch.serving import Engine, EngineConfig, Request
from repro_torch.serving.lifecycle import pow2_ceil

ref_prefill_chunk = jax.jit(_ref_prefill_chunk, static_argnums=(1,))
FP32 = dict(param_dtype="float32", compute_dtype="float32")


def _pair(arch, **kw):
    """(reference cfg, reference params, port cfg, port params), fp32;
    the hybrid with dense FFNs on both sides."""
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


@pytest.fixture(scope="module")
def llama():
    return _pair("llama3.1-8b", layers=2)


@pytest.fixture(scope="module")
def hybrid():
    """One period of Jamba: 8 layers, attention at 3."""
    return _pair("jamba-1.5-large-398b", layers=8)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)



@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads while this file runs: its tensors are small,
    and the suite runs beside other workers' timing-sensitive tests."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)

# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv_dtype,tol", [("float32", 1e-4),
                                          ("bfloat16", 2e-3)])
@pytest.mark.parametrize("chunk", [1, 4, 19])
def test_prefill_chunk_matches_reference(llama, chunk, kv_dtype, tol):
    """A 19-token prompt advances through staging row 1 of 3 in chunks of
    ``chunk`` at the fixed geometry (3, pow2_ceil(chunk)): the last
    chunk's logits and the row's K/V agree with the reference's
    ``prefill_chunk`` on the same weights, the greedy token too, the
    idle rows keep length 0, and the port's chunked row agrees with its
    own whole-prompt prefill at the same bar (CPU GEMMs may sum a row in
    another order at another M, so not bitwise here)."""
    rcfg, rparams, cfg, params = llama
    rng = np.random.default_rng(0)
    plen, cache, p = 19, 64, 3
    prompt = rng.integers(0, cfg.vocab_size, plen)
    rst = ref_state(rcfg, device_batch=p, cache_len=cache,
                    kv_dtype=getattr(jnp, kv_dtype))
    st = init_decode_state(cfg, device_batch=p, cache_len=cache,
                           device="cpu", kv_dtype=getattr(torch, kv_dtype))
    cb = pow2_ceil(chunk)
    consumed = 0
    while consumed < plen:
        c = min(chunk, plen - consumed)
        toks = np.zeros((p, cb), np.int32)
        lens = np.zeros((p,), np.int32)
        toks[1, :c] = prompt[consumed:consumed + c]
        lens[1] = c
        rlogits, rst = ref_prefill_chunk(rparams, rcfg, jnp.asarray(toks),
                                         jnp.asarray(lens), rst)
        logits, st = prefill_chunk(params, cfg, torch.from_numpy(toks),
                                   torch.from_numpy(lens), st)
        consumed += c
    assert st.lengths.tolist() == [0, plen, 0] == np.asarray(
        rst.lengths).tolist()
    np.testing.assert_allclose(_np(logits[1]), _np(rlogits[1]), rtol=tol,
                               atol=tol)
    assert int(logits[1].argmax()) == int(np.argmax(rlogits[1]))
    for kind, e, re_ in zip(cfg.block_pattern, st.per_entry, rst.per_entry):
        if kind == BlockKind.ATTN:
            for a, ra in ((e.k, re_.k), (e.v, re_.v)):
                np.testing.assert_allclose(_np(a[:, 1, :plen]),
                                           _np(ra[:, 1, :plen]), rtol=tol,
                                           atol=tol)
    whole = init_decode_state(cfg, device_batch=1, cache_len=cache,
                              device="cpu", kv_dtype=getattr(torch, kv_dtype))
    wlogits, whole = prefill(params, cfg,
                             {"tokens": torch.from_numpy(prompt)[None]}, whole)
    np.testing.assert_allclose(_np(logits[1]), _np(wlogits[0]), rtol=tol,
                               atol=tol)
    for e, w in zip(st.per_entry, whole.per_entry):
        np.testing.assert_allclose(_np(e.k[:, 1, :plen]),
                                   _np(w.k[:, 0, :plen]), rtol=tol, atol=tol)


def test_hybrid_prefill_chunk_keeps_idle_rows_and_carries_state(hybrid):
    """On the hybrid, a row with chunk length 0 keeps its Mamba state bit
    for bit while another row advances, and the advancing row's last
    logits agree with the reference's at 1e-4."""
    rcfg, rparams, cfg, params = hybrid
    rng = np.random.default_rng(1)
    plen, p = 12, 2
    prompt = rng.integers(0, cfg.vocab_size, plen)
    rst = ref_state(rcfg, device_batch=p, cache_len=32,
                    kv_dtype=jnp.float32)
    st = init_decode_state(cfg, device_batch=p, cache_len=32, device="cpu",
                           kv_dtype=torch.float32)
    mamba = [j for j, k in enumerate(cfg.block_pattern)
             if k == BlockKind.MAMBA]
    for j in mamba:                        # row 0 holds a carried state
        st.per_entry[j].ssm[:, 0] = 0.25
    before = [st.per_entry[j].ssm[:, 0].clone() for j in mamba]
    for start in range(0, plen, 8):
        c = min(8, plen - start)
        toks = np.zeros((p, 8), np.int32)
        toks[1, :c] = prompt[start:start + c]
        lens = np.array([0, c], np.int32)
        rlogits, rst = ref_prefill_chunk(rparams, rcfg, jnp.asarray(toks),
                                         jnp.asarray(lens), rst)
        logits, st = prefill_chunk(params, cfg, torch.from_numpy(toks),
                                   torch.from_numpy(lens), st)
    for j, b in zip(mamba, before):
        assert torch.equal(st.per_entry[j].ssm[:, 0], b)
    np.testing.assert_allclose(_np(logits[1]), _np(rlogits[1]), rtol=1e-4,
                               atol=1e-4)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

# chunking only: the prefix cache and tier moves have files of their own
CHUNK_ONLY = dict(prefix_cache=False, tier_rebalance=False, preemption=False)
TIERS = {
    # every request on a device slot
    "device": dict(device_slots=4, cache_len=128, enable_offload=False),
    # one device slot: the rest prefill on the host tier's staging rows
    "host": dict(device_slots=1, host_slots=3, cache_len=128,
                 host_workers=2),
}


def _streams(engine, protos, request_cls, n_new=5):
    reqs = [request_cls(prompt=list(p), max_new_tokens=n_new)
            for p in protos]
    stats = engine.run(reqs)
    engine.shutdown()
    return [r.output for r in reqs], stats


@pytest.mark.parametrize("chunk", [1, 4, 64])
@pytest.mark.parametrize("arch,tier", [("llama", "device"),
                                       ("llama", "host"),
                                       ("hybrid", "host")])
def test_engine_chunked_matches_reference_engine(request, arch, tier, chunk):
    """Four prompts, some longer than the chunk, through both engines with
    the same chunk budget: identical greedy streams, chunks co-running
    with decode, and (host tier) tokens decoded on the host."""
    rcfg, rparams, cfg, params = request.getfixturevalue(arch)
    lengths = {1: [5, 7, 3, 6], 4: [9, 13, 6, 11], 64: [9, 23, 70, 14]}[chunk]
    rng = np.random.default_rng(2)
    protos = [rng.integers(1, cfg.vocab_size, n).tolist() for n in lengths]
    kw = dict(TIERS[tier], chunk_tokens=chunk, perf_model="analytic:a10",
              **CHUNK_ONLY)
    ref_out, ref_stats = _streams(
        RefEngine(rcfg, rparams, RefEngineConfig(**kw)), protos, RefRequest)
    out, stats = _streams(Engine(cfg, params, EngineConfig(**kw,
                                                           device="cpu")),
                          protos, Request)
    assert out == ref_out
    assert all(len(o) == 5 for o in out)
    assert stats.prefill_chunks == ref_stats.prefill_chunks > len(protos)
    assert stats.chunked_prefill_tokens == sum(lengths)
    assert stats.chunk_co_run_iterations > 0
    if tier == "host":
        assert stats.host_tokens > 0 and ref_stats.host_tokens > 0
