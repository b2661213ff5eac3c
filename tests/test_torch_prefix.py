"""The port's prefix cache against the JAX reference on the CPU.

  * the refcounted copy-on-write pool: the port's ``PagedKVPool`` and the
    reference's, driven through one seeded interleaving of the ops the
    engine performs (admit, decode append, publish by fork, hit by fork,
    retire, drop, and allocations that make the LRU reclaim), hold the
    same page tables, refcounts, free lists, evictions and gathered K/V
    after every op, and no cached prefix is ever written in place;
  * the reference's multi-turn chat matrix (tests/test_prefix_cache.py:
    attention-only and hybrid stacks, device cache rows and host-pool
    entries) on the port: prefix cache on == off == the reference
    engine's tokens, with hits on the tier the case exercises.
"""
import dataclasses

import jax
import numpy as np
import pytest
torch = pytest.importorskip("torch")  # the port needs PyTorch

from repro.configs import get_config as ref_get_config
from repro.models import init_params as ref_init
from repro.models.config import FFNKind as RefFFNKind
from repro.models.kv_cache import PagedKVPool as RefPool
from repro.serving import Engine as RefEngine
from repro.serving import EngineConfig as RefEngineConfig
from repro.serving import Request as RefRequest
from repro_torch.configs import get_config
from repro_torch.core import placement
from repro_torch.models import params_from_numpy
from repro_torch.models.config import FFNKind
from repro_torch.models.kv_cache import PagedKVPool
from repro_torch.serving import Engine, EngineConfig, Request
from repro_torch.serving.prefix_cache import PrefixCache, PrefixEntry



@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads while this file runs: its tensors are small,
    and the suite runs beside other workers' timing-sensitive tests."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)

# ---------------------------------------------------------------------------
# the pool
# ---------------------------------------------------------------------------


def _pools(num_pages=24, page_size=4, num_layers=2):
    kw = dict(num_pages=num_pages, page_size=page_size,
              num_layers=num_layers, kv_heads=1, head_dim=2)
    return PagedKVPool(**kw), RefPool(**kw, host_kv_dtype="fp32")


def _assert_same(pool, ref, owners):
    assert pool.page_tables == ref.page_tables
    assert pool.page_refs == ref.page_refs
    assert pool.free_pages == ref.free_pages
    assert pool.lengths == ref.lengths
    assert pool.evictions == ref.evictions
    # refcounts balance: each page's count is its occurrences in chains
    occ = {}
    for chain in pool.page_tables.values():
        for p in chain:
            occ[p] = occ.get(p, 0) + 1
    assert occ == pool.page_refs
    assert set(pool.free_pages).isdisjoint(occ)
    assert len(pool.free_pages) + len(occ) == pool.pages.shape[1]
    for owner in owners:
        if (owner, 0) not in pool.page_tables:
            continue
        for layer in range(pool.num_layers):
            for a, b in zip(pool.gather(owner, layer), ref.gather(owner,
                                                                  layer)):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", range(6))
def test_pool_matches_reference_under_one_op_sequence(seed):
    rng = np.random.default_rng(seed)
    pool, ref = _pools()
    evicted, ref_evicted = [], []
    pool.on_evict, ref.on_evict = evicted.append, ref_evicted.append
    live, snapshots = [], {}
    next_id = 1

    def both(op, *args):
        """Run ``op`` on both pools; both raise MemoryError or neither."""
        outcome = []
        for p in (pool, ref):
            try:
                getattr(p, op)(*args)
                outcome.append(None)
            except MemoryError:
                outcome.append(MemoryError)
        assert outcome[0] is outcome[1]
        return outcome[0] is None

    def fill(rid, tokens):
        if not both("allocate", rid, tokens):
            return False
        for layer in range(2):
            k = rng.random((tokens, 1, 2)).astype(np.float32)
            v = rng.random((tokens, 1, 2)).astype(np.float32)
            both("write_prompt", rid, layer, k, v, layer == 1)
        return True

    for _ in range(150):
        op = int(rng.integers(0, 6))
        if op == 0:                                   # admit + prefill
            rid, next_id = next_id, next_id + 1
            if fill(rid, int(rng.integers(1, 10))):
                live.append(rid)
        elif op == 1 and live:                        # decode append
            rid = live[int(rng.integers(len(live)))]
            pos = np.array([pool.lengths[rid]])
            ok = True
            for layer in range(2):
                tok = rng.random((1, 1, 2)).astype(np.float32)
                ok = ok and both("append_rows", [rid], layer, pos, tok, tok)
            if ok:
                pool.lengths[rid] += 1
                ref.lengths[rid] += 1
        elif op == 2 and live:                        # publish
            rid = live[int(rng.integers(len(live)))]
            n = pool.lengths[rid]
            if n:
                owner, next_id = -next_id, next_id + 1
                both("fork", rid, owner, n)
                both("mark_evictable", owner)
                snapshots[owner] = [pool.gather(owner, la) for la in range(2)]
        elif op == 3 and live:                        # retire
            both("free", live.pop(int(rng.integers(len(live)))))
        elif op == 4 and snapshots:                   # cache hit
            owner = list(snapshots)[int(rng.integers(len(snapshots)))]
            if (owner, 0) in pool.page_tables:
                rid, next_id = next_id, next_id + 1
                both("fork", owner, rid, pool.lengths[owner])
                both("touch", owner)
                live.append(rid)
        elif op == 5 and snapshots:                   # drop an entry
            owner = list(snapshots)[int(rng.integers(len(snapshots)))]
            snapshots.pop(owner)
            both("free", owner)
        assert evicted == ref_evicted
        for owner in evicted:
            snapshots.pop(owner, None)
        _assert_same(pool, ref, live + list(snapshots))
        for owner, snap in snapshots.items():         # cached K/V immutable
            for layer in range(2):
                for a, b in zip(pool.gather(owner, layer), snap[layer]):
                    np.testing.assert_array_equal(a, b)
    assert pool.evictions > 0            # the LRU reclaim path ran


def test_cow_write_never_mutates_a_shared_page():
    pool, _ = _pools()
    rng = np.random.default_rng(1)
    pool.allocate(1, 6)
    for layer in range(2):
        kv = rng.random((6, 1, 2)).astype(np.float32)
        pool.write_prompt(1, layer, kv, kv, advance=(layer == 1))
    pool.fork(1, -5, 6)
    cached = [pool.gather(-5, layer) for layer in range(2)]
    shared = [pool.page_tables[(1, layer)][1] for layer in range(2)]
    for layer in range(2):           # position 6 lands in the shared page
        tok = rng.random((1, 1, 2)).astype(np.float32)
        pool.append_rows([1], layer, np.array([6]), tok, tok)
    for layer in range(2):
        assert pool.page_tables[(1, layer)][1] != shared[layer]
        assert pool.page_tables[(-5, layer)][1] == shared[layer]
        assert pool.page_refs[shared[layer]] == 1
        for a, b in zip(pool.gather(-5, layer), cached[layer]):
            np.testing.assert_array_equal(a, b)


def test_cache_match_rules():
    """Longest usable prefix, capped at prompt_len - 1; a hybrid needs the
    whole entry (no carry exists mid-entry); ties prefer the device."""
    attn = PrefixCache(device_rows=0, hybrid=False)
    attn.entries = {1: PrefixEntry(1, (1, 2, 3, 4), "host"),
                    2: PrefixEntry(2, (1, 2, 3, 4), "device", row=0)}
    entry, n = attn.match([1, 2, 3, 9, 9])
    assert n == 3 and entry.tier == "device"
    assert attn.match([1, 2, 3, 4])[1] == 3          # one token prefills
    assert attn.match([7, 7]) is None
    hyb = PrefixCache(device_rows=0, hybrid=True)
    hyb.entries = {1: PrefixEntry(1, (1, 2, 3, 4), "host")}
    assert hyb.match([1, 2, 3, 9, 9]) is None        # partial: a miss
    assert hyb.match([1, 2, 3, 4, 5])[1] == 4
    assert hyb.match_len([1, 2, 3, 4]) == 0          # would not fit the cap
    assert placement.chargeable_prefill_tokens(10, 10) == 1


# ---------------------------------------------------------------------------
# the engine: the reference's multi-turn matrix
# ---------------------------------------------------------------------------

MATRIX = [
    ("internlm2-1.8b", 2, True),    # attention-only, device cache rows
    ("internlm2-1.8b", 0, True),    # attention-only, host-pool entries
    ("jamba-1.5-large-398b", 2, False),  # hybrid, device rows only
    ("jamba-1.5-large-398b", 0, True),   # hybrid, host pool + carry
]


def _configs(arch):
    """The reference test's reduced config (bf16 parameters, where the
    bf16 Mamba conv window is lossless, so chunk boundaries are inert on
    the hybrid too), the hybrid with dense FFNs on both sides."""
    layers = 8 if "jamba" in arch else 2
    rcfg = ref_get_config(arch).reduced(layers=layers, d_model=64, vocab=128)
    cfg = get_config(arch).reduced(layers=layers, d_model=64, vocab=128)
    if "jamba" in arch:
        rcfg = dataclasses.replace(rcfg, ffn_kind=RefFFNKind.DENSE, moe=None)
        cfg = dataclasses.replace(cfg, ffn_kind=FFNKind.DENSE, moe=None)
    return rcfg, cfg


def _multi_turn(engine, request_cls, vocab):
    """Two sessions of two turns over one 24-token system prompt; each
    turn's prompt is the history plus 5 new tokens."""
    try:
        rng = np.random.default_rng(7)
        sys_prompt = [int(t) for t in rng.integers(1, vocab, 24)]
        outs = []
        for _ in range(2):
            history = list(sys_prompt)
            for _ in range(2):
                user = [int(t) for t in rng.integers(1, vocab, 5)]
                req = request_cls(prompt=history + user, max_new_tokens=5)
                engine.run([req])
                outs.append(list(req.output))
                history = list(req.prompt) + list(req.output)
        return outs, engine.stats
    finally:
        engine.shutdown()


@pytest.mark.parametrize("arch,slots,offload", MATRIX)
def test_multi_turn_prefix_on_equals_off_equals_reference(arch, slots,
                                                          offload):
    rcfg, cfg = _configs(arch)
    rparams = ref_init(jax.random.PRNGKey(0), rcfg)
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, rparams), "cpu")
    kw = dict(device_slots=2, host_slots=4, cache_len=128, page_size=16,
              host_pool_pages=256, chunk_tokens=16, enable_offload=offload,
              perf_model="analytic:a10", prefix_cache_slots=slots)
    ref_out, ref_stats = _multi_turn(
        RefEngine(rcfg, rparams, RefEngineConfig(**kw)), RefRequest,
        rcfg.vocab_size)
    warm, stats = _multi_turn(
        Engine(cfg, params, EngineConfig(**kw, device="cpu")), Request,
        cfg.vocab_size)
    cold, cold_stats = _multi_turn(
        Engine(cfg, params, EngineConfig(**kw, device="cpu",
                                         prefix_cache=False)),
        Request, cfg.vocab_size)
    assert warm == cold == ref_out
    assert cold_stats.prefix_hits == 0
    assert stats.prefix_hits == ref_stats.prefix_hits > 0
    assert stats.prefix_hit_tokens == ref_stats.prefix_hit_tokens
    tier_hits = stats.prefix_device_hits if slots else stats.prefix_host_hits
    assert tier_hits == stats.prefix_hits
