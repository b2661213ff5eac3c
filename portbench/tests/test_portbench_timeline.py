"""The end-to-end arithmetic on hand-made timelines."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import pytest  # noqa: E402

from portbench.harness import timeline  # noqa: E402


def test_percentile_nearest_rank():
    vals = list(range(1, 101))
    assert timeline.percentile(vals, 95) == 95
    assert timeline.percentile(vals, 50) == 50
    assert timeline.percentile([3.0], 95) == 3.0
    assert timeline.percentile([], 95) is None
    assert timeline.percentile(list(range(1, 21)), 95) == 19


def test_ttft_over_every_request_due_in_the_window_with_censoring():
    reqs = [(0.5, [0.9, 1.0]),        # due before the window: not counted
            (1.0, [1.5, 2.0]),        # 0.5
            (2.0, [2.2]),             # 0.2
            (3.0, []),                # no token by the close at 10: 7.0
            (4.0, [10.5]),            # first token after the close: 6.0
            (10.0, [])]               # due at the close: not counted
    got = sorted(timeline.ttfts(reqs, 1.0, 10.0))
    assert got == pytest.approx([0.2, 0.5, 6.0, 7.0])
    assert timeline.percentile(got, 95) == 7.0


def test_tpot_takes_tokens_inside_the_window():
    reqs = [(0.0, [0.5, 1.5, 2.5, 3.5]),     # 3 in (1, 3]: (2.5-1.5)/1
            (0.0, [2.0, 4.0, 6.0, 8.0]),     # 2.0..6.0 inside (1, 7]: 2.0
            (0.0, [5.0])]                    # one token: none
    assert timeline.tpots(reqs, 1.0, 3.0) == [1.0]
    assert sorted(timeline.tpots(reqs, 1.0, 7.0)) == [1.0, 2.0]
    assert timeline.tokens_in(reqs, 1.0, 7.0) == 3 + 3 + 1


def test_counter_delta():
    before = {"iterations": 10, "host_wait_time": 1.5,
              "strategy_counts": {"gpu_only": 4}, "name": "x",
              "flag": True}
    after = {"iterations": 25, "host_wait_time": 2.0,
             "strategy_counts": {"gpu_only": 9, "async_overlap": 3},
             "name": "x", "flag": True}
    d = timeline.counter_delta(before, after)
    assert d == {"iterations": 15, "host_wait_time": 0.5,
                 "strategy_counts": {"gpu_only": 5, "async_overlap": 3}}
