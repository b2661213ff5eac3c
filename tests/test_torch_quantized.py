"""The port's int8 host KV tier and cold-page compression against the JAX
reference on the CPU.

  * ``quantize_kv_rows`` is the reference's bit for bit, and the page
    codec round-trips;
  * the port's ``PagedKVPool`` and the reference's, fp32 and int8, with
    and without cold-page compression, driven through one seeded sequence
    of the ops the engine performs (allocate, write_prompt, append,
    append_rows, fork, gather, cold sweep, ensure_hot, a reclaim that
    compresses before it evicts, free): page tables, refcounts, free
    lists, stored pages, scales, blobs, byte accounting and gathered K/V
    equal after every op;
  * the fused-dequant numpy host attention against the reference's at
    1e-6;
  * the int8 pricing: ``host_kv_el_bytes``, ``ModelCosts``, the analytic
    model's host terms, the fingerprints and the profiler's int8 table;
  * the engine: the reference's lossless-compression and bounded-drift
    gates mirrored on the port (int8 against fp32 by a logit drift bound,
    never by the reference's int8 token gate, which fails on its own
    migration scenario: ROADMAP queue 3), the byte gauges and the serve
    CLI's two flags.
"""
import dataclasses

import jax
import numpy as np
import pytest
torch = pytest.importorskip("torch")  # the port needs PyTorch

from repro.configs import get_config as ref_get_config
from repro.core import perf_model as ref_pm
from repro.distributed import compression as ref_comp
from repro.kernels.host_paged_attention import \
    host_paged_attention_numpy as ref_host_attention
from repro.models import init_params as ref_init
from repro.models.kv_cache import PagedKVPool as RefPool
from repro.serving.lifecycle import EngineStats as RefEngineStats
from repro_torch.configs import get_config
from repro_torch.core import perf_model as pm
from repro_torch.core.profiler import OfflineProfiler
from repro_torch.core.scheduler import Decision, StrategyKind
from repro_torch.distributed import compression as comp
from repro_torch.kernels.host_paged_attention import \
    host_paged_attention_numpy
from repro_torch.models import params_from_numpy
from repro_torch.models.kv_cache import PagedKVPool
from repro_torch.serving import Engine, EngineConfig
from repro_torch.serving.lifecycle import EngineStats
from repro_torch.serving.request import make_synthetic_request


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads while this file runs: its tensors are small,
    and the suite runs beside other workers' timing-sensitive tests."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _rows(rng, n, kv=1, d=2):
    # magnitudes over decades, so that per-row scaling matters
    mags = np.logspace(-2, 2, max(n, 1))[:n, None, None]
    return (rng.standard_normal((n, kv, d)) * mags).astype(np.float32)


# ---------------------------------------------------------------------------
# quantization and the codec
# ---------------------------------------------------------------------------


def test_quantize_rows_bit_equal_and_codec_round_trips():
    """Codes and scales equal the reference's bit for bit (zero rows
    included), dequantization too, requantizing a dequantized row gives
    the same codes, and a page blob survives compression exactly."""
    rng = np.random.default_rng(0)
    x = _rows(rng, 33, 4, 8)
    x[5] = 0.0
    q, s = comp.quantize_kv_rows(x)
    rq, rs = ref_comp.quantize_kv_rows(x)
    np.testing.assert_array_equal(q, rq)
    np.testing.assert_array_equal(s, rs)
    deq = comp.dequantize_kv_rows(q, s)
    np.testing.assert_array_equal(deq, ref_comp.dequantize_kv_rows(rq, rs))
    assert not deq[5].any()
    q2, s2 = comp.quantize_kv_rows(deq)
    np.testing.assert_array_equal(q2, q)
    np.testing.assert_array_equal(s2, s)
    raw = q.tobytes() + s.tobytes()
    blob = comp.compress_page_bytes(raw)
    assert comp.decompress_page_bytes(blob) == raw
    assert comp.PAGE_CODEC == ref_comp.PAGE_CODEC
    assert blob == ref_comp.compress_page_bytes(raw)


# ---------------------------------------------------------------------------
# the pool under one op sequence
# ---------------------------------------------------------------------------


def _assert_same(pool, ref, evicted, ref_evicted):
    assert pool.page_tables == ref.page_tables
    assert pool.page_refs == ref.page_refs
    assert pool.free_pages == ref.free_pages
    assert pool.lengths == ref.lengths
    assert pool.evictions == ref.evictions and evicted == ref_evicted
    np.testing.assert_array_equal(pool.pages, ref.pages)
    assert pool.pages.dtype == ref.pages.dtype
    if ref.scales is None:
        assert pool.scales is None
    else:
        np.testing.assert_array_equal(pool.scales, ref.scales)
    assert pool._compressed == ref._compressed
    assert (pool.pages_compressed, pool.pages_decompressed) == \
        (ref.pages_compressed, ref.pages_decompressed)
    assert pool.compressed_ratio_ewma == ref.compressed_ratio_ewma
    assert pool.byte_stats() == ref.byte_stats()
    assert (pool.page_bytes, pool.kv_dtype_bytes, pool.has_compressed) == \
        (ref.page_bytes, ref.kv_dtype_bytes, ref.has_compressed)


@pytest.mark.parametrize("compress", [0.0, 1e-6])
@pytest.mark.parametrize("host_kv_dtype", ["fp32", "int8"])
def test_pool_matches_reference_under_one_op_sequence(host_kv_dtype,
                                                      compress):
    kw = dict(num_pages=20, page_size=4, num_layers=2, kv_heads=2,
              head_dim=3, host_kv_dtype=host_kv_dtype,
              cold_page_compress_after=compress)
    pool, ref = PagedKVPool(**kw), RefPool(**kw)
    evicted, ref_evicted = [], []
    pool.on_evict, ref.on_evict = evicted.append, ref_evicted.append
    rng = np.random.default_rng(11)
    later = 1e9                       # a cold sweep that finds every owner idle

    def both(name, *args, **kwargs):
        out = getattr(pool, name)(*args, **kwargs)
        rout = getattr(ref, name)(*args, **kwargs)
        _assert_same(pool, ref, evicted, ref_evicted)
        return out, rout

    def rows(n):
        return _rows(rng, n, 2, 3), _rows(rng, n, 2, 3)

    def gather_all(owner):
        for layer in range(2):
            for a, b in zip(*both("gather", owner, layer)):
                np.testing.assert_array_equal(a, b)
                assert a.dtype == np.float32

    # two requests' prompts, then decode appends of both kinds
    for rid, n in ((1, 7), (2, 5)):
        both("allocate", rid, n)
        k, v = rows(n)
        for layer in range(2):
            both("write_prompt", rid, layer, k, v, advance=(layer == 1))
    for _ in range(2):
        k, v = rows(1)
        for layer in range(2):
            both("append", 1, layer, k[0], v[0], advance=(layer == 1))
    positions = np.array([pool.lengths[1], pool.lengths[2]])
    for layer in range(2):
        k, v = rows(2)
        both("append_rows", [1, 2], layer, positions, k, v)
    for rid in (1, 2):
        pool.lengths[rid] += 1
        ref.lengths[rid] += 1
    gather_all(1)
    # publish request 1's prompt as a prefix entry, hit it, write past it
    both("fork", 1, -3, 6)
    both("mark_evictable", -3)
    both("fork", -3, 4, 6)
    both("touch", -3)
    k, v = rows(1)
    for layer in range(2):                  # copy-on-write of the shared page
        both("append", 4, layer, k[0], v[0], advance=(layer == 1))
    gather_all(-3)
    gather_all(4)
    # cold sweep, then rehydration by a gather, by ensure_hot and by a write
    n, rn = both("maybe_compress_cold", now=later)
    assert n == rn and (n > 0) == (compress > 0)
    gather_all(2)
    both("ensure_hot", 4)
    k, v = rows(1)
    for layer in range(2):
        both("append", 1, layer, k[0], v[0], advance=(layer == 1))
    both("maybe_compress_cold", now=later)
    # retire request 1 and let the prefix entry's pages go under pressure:
    # compressed first when compression is on, then evicted
    both("free", 1)
    both("free", 4)
    both("allocate", 5, 28)
    gather_all(2)
    if compress:
        assert pool.pages_compressed > 0 and pool.pages_decompressed > 0
    both("free", 5)
    both("free", 2)
    for owner in list(pool.lengths):
        both("free", owner)
    assert len(pool.free_pages) == 20 and not pool.page_refs


def test_live_owners_are_not_swept_cold():
    """An owner the caller names live (the engine's host cohort) keeps
    its pages hot; the sweep compresses it once it is not named."""
    pool = PagedKVPool(8, 4, 1, 1, 2, host_kv_dtype="int8",
                       cold_page_compress_after=1e-6)
    rng = np.random.default_rng(3)
    for rid in (1, 2):
        pool.allocate(rid, 4)
        pool.write_prompt(rid, 0, *(_rows(rng, 4),) * 2, advance=True)
    assert pool.maybe_compress_cold(now=1e9, skip=[1]) == 1
    assert pool.page_tables[(1, 0)][0] >= 0 > pool.page_tables[(2, 0)][0]
    assert pool.maybe_compress_cold(now=1e9) == 1


@pytest.mark.parametrize("free_pages", [0, 1])
def test_reading_a_cold_entry_spares_it(free_pages):
    """A cold prefix entry (evictable, both its pages compressed) read by
    ``gather`` while the pool holds ``free_pages`` free pages, the rest
    held by a live owner: the rehydration's reclaim neither compresses
    nor evicts the entry being read (the reference's may do either, and
    its gather then indexes a sentinel or a freed chain), and what the
    pool cannot rehydrate is read from its blob.  The values are the
    entry's before it went cold."""
    pool = PagedKVPool(4, 4, 1, 1, 2, host_kv_dtype="int8",
                       cold_page_compress_after=1e-6)
    rng = np.random.default_rng(5)
    pool.allocate(-1, 8)
    pool.write_prompt(-1, 0, *(_rows(rng, 8),) * 2, advance=True)
    pool.mark_evictable(-1)
    hot = pool.gather(-1, 0)
    assert pool.maybe_compress_cold(now=1e9) == 2
    pool.allocate(7, 4 * (4 - free_pages))         # live: never reclaimed
    k, v = pool.gather(-1, 0)
    np.testing.assert_array_equal(k, hot[0])
    np.testing.assert_array_equal(v, hot[1])
    assert -1 in pool.lengths and pool.evictions == 0
    assert sum(p >= 0 for p in pool.page_tables[(-1, 0)]) == free_pages
    assert pool.pages_decompressed == free_pages


# ---------------------------------------------------------------------------
# fused-dequant host attention
# ---------------------------------------------------------------------------


def test_fused_dequant_attention_matches_reference():
    """int8 pages with scales, ragged lengths over scattered page chains:
    the port's numpy host attention against the reference's at 1e-6, and
    against attention over the dequantized fp32 pages; the fp32 path
    equals the reference's."""
    rng = np.random.default_rng(7)
    b, ps, kv, d, h, npages = 4, 4, 2, 8, 4, 16
    kf = rng.standard_normal((2, npages * ps, kv, d)).astype(np.float32)
    q8 = np.zeros((2, npages, ps, kv, d), np.int8)
    scales = np.zeros((2, npages, ps), np.float32)
    deq = np.zeros((2, npages, ps, kv, d), np.float32)
    for side in range(2):
        codes, s = comp.quantize_kv_rows(kf[side])
        q8[side] = codes.reshape(npages, ps, kv, d)
        scales[side] = s.reshape(npages, ps)
        deq[side] = comp.dequantize_kv_rows(codes, s).reshape(npages, ps,
                                                              kv, d)
    pt = rng.permutation(npages).astype(np.int32).reshape(b, 4)
    lengths = np.array([1, 7, 16, 11], np.int32)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    fused = host_paged_attention_numpy(q, q8, pt, lengths, page_size=ps,
                                       scales=scales)
    np.testing.assert_allclose(
        fused, ref_host_attention(q, q8, pt, lengths, page_size=ps,
                                  scales=scales), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        fused, host_paged_attention_numpy(q, deq, pt, lengths, page_size=ps),
        rtol=1e-5, atol=1e-6)
    out = np.empty_like(fused)
    host_paged_attention_numpy(q, deq, pt, lengths, page_size=ps, out=out)
    np.testing.assert_array_equal(
        out, ref_host_attention(q, deq, pt, lengths, page_size=ps))


# ---------------------------------------------------------------------------
# pricing
# ---------------------------------------------------------------------------

PRICED = ["llama3.1-8b", "deepseek-moe-16b", "jamba-1.5-large-398b"]


@pytest.mark.parametrize("arch", PRICED)
def test_int8_pricing_and_fingerprints_equal_reference(arch):
    """Stored bytes per element, the cost fields, the analytic model's host
    terms and the fingerprints: the reference's, for both dtypes.  The
    int8 pool is priced at one byte per element plus a K and a V fp32
    scale per position and layer."""
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    for dt in ("fp32", "int8"):
        assert pm.host_kv_el_bytes(dt) == ref_pm.host_kv_el_bytes(dt)
        el = pm.host_kv_el_bytes(dt)
        mine = pm.ModelCosts.from_config(cfg, host_kv_bytes_per_el=el)
        theirs = ref_pm.ModelCosts.from_config(rcfg, host_kv_bytes_per_el=el)
        for f in dataclasses.fields(mine):
            assert getattr(mine, f.name) == getattr(theirs, f.name), f.name
        assert pm.model_fingerprint(cfg, dt) == \
            ref_pm.model_fingerprint(rcfg, dt)
        a = pm.analytic_model("a10", cfg, dt)
        r = ref_pm.analytic_model("a10", rcfg, dt)
        for ctx in (128.0, 4096.0):
            assert a.t_catt(4, ctx) == pytest.approx(r.t_catt(4, ctx),
                                                     rel=1e-12)
            assert a.n_c(ctx) == pytest.approx(r.n_c(ctx), rel=1e-12)
        assert a.t_migrate(300) == pytest.approx(r.t_migrate(300),
                                                 rel=1e-12)
    fp = pm.ModelCosts.from_config(cfg)
    q8 = pm.ModelCosts.from_config(cfg, host_kv_bytes_per_el=1)
    # the fp32 pool is priced at the device's bf16 bytes, as the
    # reference prices it
    assert fp.host_kv_bytes_per_pos == fp.kv_bytes_per_pos
    assert q8.host_kv_bytes_per_pos == fp.kv_bytes_per_pos // 2 \
        + 8 * cfg.num_attn_layers
    assert pm.model_fingerprint(cfg, "int8").endswith(":hostkv-int8")
    assert pm.model_fingerprint(cfg) == pm.model_fingerprint(cfg, "fp32")


def test_int8_profile_and_provider(tmp_path):
    """The profiler's int8 catt table runs the fused-dequant path and
    carries the int8 fingerprint and stored bytes; a profile of the other
    dtype is refused by ``file:``."""
    cfg = get_config("internlm2-1.8b").reduced(layers=2, d_model=64,
                                               vocab=64)
    grid = dict(token_counts=(1, 8), kv_positions=(128, 512),
                transfer_sizes=(1 << 12,))
    model = OfflineProfiler(cfg, device="cpu", host_kv_dtype="int8").run(
        **grid)
    assert model.fingerprint == ref_pm.model_fingerprint(
        ref_get_config("internlm2-1.8b").reduced(layers=2, d_model=64,
                                                 vocab=64), "int8")
    costs = pm.ModelCosts.from_config(cfg, host_kv_bytes_per_el=1)
    assert model.host_kv_bytes_per_pos == costs.host_kv_bytes_per_pos
    assert (model.tables["catt"][1] > 0).all()
    path = str(tmp_path / "int8.json")
    model.save(path)
    assert pm.resolve_perf_model(f"file:{path}", cfg, device="cpu",
                                 host_kv_dtype="int8").fingerprint == \
        model.fingerprint
    with pytest.raises(ValueError, match="hostkv-int8"):
        pm.resolve_perf_model(f"file:{path}", cfg, device="cpu")


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

_MODELS = {}


def _model(arch):
    """Port cfg and the reference's weights carried across: d_model 64,
    vocab 64, as the reference's int8 gates build them."""
    if arch not in _MODELS:
        rcfg = ref_get_config(arch).reduced(layers=None, d_model=64,
                                            vocab=64)
        cfg = get_config(arch).reduced(layers=None, d_model=64, vocab=64)
        rparams = ref_init(jax.random.PRNGKey(0), rcfg)
        _MODELS[arch] = cfg, params_from_numpy(
            cfg, jax.tree.map(np.asarray, rparams), "cpu")
    return _MODELS[arch]


class _Pipelined:
    """Algorithm 1 pinned to Asymmetric Pipelining: every host job is
    waited for, so the iterations (and the logits each one samples) do
    not depend on host timing and two runs align call for call."""

    def schedule(self, prefill, decode_gpu, decode_cpu, *, mean_context,
                 prefill_tokens=0, chunk_backlog_tokens=0,
                 chunk_tokens_max=0):
        return Decision(StrategyKind.ASYM_PIPELINE, list(prefill),
                        list(decode_gpu), list(decode_cpu),
                        chunk_tokens=min(chunk_backlog_tokens,
                                         chunk_tokens_max))


def _run(cfg, params, ecfg_kw, *, seed=1, record=None, monkeypatch=None):
    """Five requests of 7 -> 4 tokens (the reference gates' traffic);
    returns (streams, stats).  ``record`` collects every logit row the
    engine samples from, in order."""
    if record is not None:
        from repro_torch.serving import engine as eng_mod
        from repro_torch.serving import prefill_exec
        from repro_torch.serving.sampler import sample

        def spy(logits, **kw):
            record.append(logits.float().numpy().copy())
            return sample(logits, **kw)

        monkeypatch.setattr(eng_mod, "sample", spy)
        monkeypatch.setattr(prefill_exec, "sample", spy)
    rng = np.random.default_rng(seed)
    reqs = [make_synthetic_request(rng, prompt_len=7, output_len=4,
                                   vocab=cfg.vocab_size) for _ in range(5)]
    eng = Engine(cfg, params, EngineConfig(device="cpu", **ecfg_kw),
                 scheduler=_Pipelined())
    try:
        eng.run(reqs)
    finally:
        eng.shutdown()
    return [r.output for r in reqs], eng.stats


def test_compression_keeps_tokens_identical():
    """The reference's lossless-compression gate on the port: an int8
    engine whose pages go cold after 1e-9 s emits the tokens of one
    without compression, and pages did compress and rehydrate."""
    cfg, params = _model("internlm2-1.8b")
    base = dict(device_slots=2, host_slots=5, cache_len=64,
                host_kv_dtype="int8")
    plain, s1 = _run(cfg, params, base, seed=9)
    squeezed, s2 = _run(cfg, params, dict(base,
                                          cold_page_compress_after=1e-9),
                        seed=9)
    assert plain == squeezed
    assert s1.host_tokens > 0
    assert s2.host_pages_compressed > 0 and s2.host_pages_decompressed > 0
    assert s1.host_pages_compressed == 0


def _ulp_bf16(x: float) -> float:
    return 2.0 ** (np.floor(np.log2(max(abs(x), 1e-30))) - 7)


def test_bounded_logit_drift_int8(monkeypatch):
    """The reference's drift gate on the port (the tie-prone hybrid, bf16
    logits): every logit the int8 run samples stays within the
    reference's 0.75 envelope of the fp32 run's, and differs from it (the
    host tier did read int8).  Greedy tokens agree but where the fp32
    run's top two logits lie within two bf16 ULPs (the tie rule of the
    card's serving checks); steps are compared up to the first such
    parting, after which the two trajectories are no longer aligned."""
    cfg, params = _model("jamba-1.5-large-398b")
    kw = dict(device_slots=2, host_slots=5, cache_len=64)
    fp_log, q_log = [], []
    fp_out, fp_stats = _run(cfg, params, dict(kw, host_kv_dtype="fp32"),
                            record=fp_log, monkeypatch=monkeypatch)
    q_out, q_stats = _run(cfg, params, dict(kw, host_kv_dtype="int8"),
                          record=q_log, monkeypatch=monkeypatch)
    assert fp_stats.host_tokens > 0 and q_stats.host_kv_dtype_bytes == 1
    assert len(fp_log) == len(q_log)
    drift, ties = 0.0, 0
    for a, b in zip(fp_log, q_log):
        drift = max(drift, float(np.abs(a - b).max()))
        flipped = np.nonzero(a.argmax(-1) != b.argmax(-1))[0]
        for row in flipped:
            top2 = np.sort(a[row])[-2:]
            assert top2[1] - top2[0] <= 2 * _ulp_bf16(top2[1]), \
                f"greedy token parted at a top-2 gap of {top2[1] - top2[0]}"
        if len(flipped):
            ties = len(flipped)
            break
    assert 0.0 < drift < 0.75, f"logit drift {drift} out of envelope"
    assert sum(x != y for x, y in zip(fp_out, q_out)) <= ties


def test_host_pool_gauges_and_snapshot():
    """After a run the stats carry the pool's bytes at its stored dtype
    (an int8 page is (2 x page x KV x D) bytes plus its scale rows), and
    ``snapshot`` has every host-pool key the reference's has."""
    cfg, params = _model("internlm2-1.8b")
    pages = 64
    for dt, el in (("fp32", 4), ("int8", 1)):
        _, stats = _run(cfg, params, dict(device_slots=2, host_slots=5,
                                          cache_len=64, host_pool_pages=pages,
                                          host_kv_dtype=dt))
        page = 2 * 32 * cfg.num_kv_heads * cfg.resolved_head_dim * el \
            + (2 * 32 * 4 if dt == "int8" else 0)
        assert stats.host_kv_dtype_bytes == el
        assert stats.host_pool_hot_bytes + stats.host_pool_free_bytes == \
            pages * page
        assert stats.host_pool_compressed_bytes == 0
    keys = {k for k in RefEngineStats().snapshot() if k.startswith("host_")}
    assert keys <= set(EngineStats().snapshot())
    assert {"host_kv_dtype_bytes", "host_pages_compressed",
            "host_compressed_ratio_ewma"} <= keys


def test_serve_cli_int8_flags(monkeypatch, capsys):
    """``--host-kv-dtype int8 --cold-page-compress-after`` on an MoE arch
    with the analytic perf model serves on the CPU and reports the pool;
    the default measured perf model refuses the MoE arch by name."""
    from repro_torch.launch import serve
    argv = ["serve", "--arch", "deepseek-moe-16b", "--device", "cpu",
            "--d-model", "64", "--layers", "2", "--requests", "4",
            "--prompt-len", "6", "--output-len", "3", "--device-slots", "1",
            "--host-slots", "3", "--cache-len", "32", "--no-stream"]
    monkeypatch.setattr("sys.argv", argv + [
        "--perf-model", "analytic", "--host-kv-dtype", "int8",
        "--cold-page-compress-after", "0.001"])
    serve.main()
    out = capsys.readouterr().out
    assert "host pool (int8, 1 B per element)" in out
    monkeypatch.setattr("sys.argv", argv)
    with pytest.raises(NotImplementedError, match="perf-model analytic"):
        serve.main()
