"""The traffic generator: deterministic by seed, the same work for every
seed, caps that fit the cache."""
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench.harness import spec, traffic  # noqa: E402

MIXES = ["offload-chat", "prefix-chat", "long-prompt"]


def _lengths(t: traffic.Traffic, n: int):
    return [(len(u), r) for i in range(n)
            for u, r in zip(t.session(i).users, t.session(i).replies)]


@pytest.mark.parametrize("mix", MIXES)
def test_same_seed_same_sessions(mix):
    m = spec.load_traffic(mix)
    a = traffic.Traffic(m, seed=2**31 + 11, vocab=1000, cache_len=4096)
    b = traffic.Traffic(m, seed=2**31 + 11, vocab=1000, cache_len=4096)
    for i in range(5):
        sa, sb = a.session(i), b.session(i)
        assert sa.users == sb.users and sa.replies == sb.replies
        assert sa.arrival == sb.arrival
    assert a.prefix == b.prefix


@pytest.mark.parametrize("mix", MIXES)
def test_seeds_share_the_multiset_of_sizes(mix):
    m = spec.load_traffic(mix)
    pool = traffic.POOL
    turns = m["turns"]
    a = traffic.Traffic(m, seed=1, vocab=1000, cache_len=4096)
    b = traffic.Traffic(m, seed=2, vocab=1000, cache_len=4096)
    la, lb = _lengths(a, pool // turns), _lengths(b, pool // turns)
    assert la != lb                               # another order
    assert sorted(x for x, _ in la) == sorted(x for x, _ in lb)
    assert sorted(y for _, y in la) == sorted(y for _, y in lb)
    assert a.session(0).users[0] != b.session(0).users[0]


def test_quantile_pool_moments():
    pool = traffic.quantile_pool({"mean": 1020, "cv": 1.2, "min": 4,
                                  "max": 10**6}, 4096)
    assert abs(pool.mean() / 1020 - 1) < 0.05
    assert abs(pool.std() / pool.mean() / 1.2 - 1) < 0.15


def test_caps_fit_the_cache():
    m = traffic.resolve_caps(spec.load_traffic("offload-chat"), 2048)
    assert m["user"]["max"] == 2048 - 512 - 1
    with pytest.raises(ValueError):
        traffic.resolve_caps(spec.load_traffic("prefix-chat"), 1024)
    t = traffic.Traffic(spec.load_traffic("offload-chat"), seed=3,
                        vocab=50, cache_len=2048)
    for i in range(200):
        s = t.session(i)
        assert len(s.users[0]) + s.replies[0] <= 2047
        assert all(0 <= x < 50 for x in s.users[0])


def test_open_loop_arrivals_and_turn_prompts():
    m = spec.load_traffic("prefix-chat")
    t = traffic.Traffic(m, seed=5, vocab=100, cache_len=2048)
    arr = [t.arrival(i) for i in range(traffic.POOL + 1)]
    assert arr[0] == 0.0 and all(b > a for a, b in zip(arr, arr[1:]))
    gaps = np.diff(arr)
    assert abs(gaps.mean() * m["rate_per_s"] - 1) < 0.01
    s = t.session(3)
    p0 = t.prompt(s, 0, [])
    reply = [7, 8, 9]
    p1 = t.prompt(s, 1, [reply])
    assert p0[:m["shared_prefix"]] == t.prefix
    assert p1 == p0 + reply + s.users[1]
