"""Each kernel's operations and bytes against shapes worked by hand, and
the configurations' sizes against their published parameter counts."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench.harness import costs, spec, trace  # noqa: E402


def test_decode_attention_cost():
    # q (2, 48, 128), k (2, 2048, 8, 128) bf16; rows at 100 and 300
    f, b = costs.decode_attention_cost((2, 48, 128), (2, 2048, 8, 128), 2,
                                       [100, 300])
    assert f == 4 * 400 * 48 * 128
    assert b == 2 * 400 * 8 * 128 * 2 + 2 * 2 * 48 * 128 * 2 + 4 * 2


def test_prefill_attention_cost_causal_at_offsets():
    # one row of T 4 at offset 2 over S 8: keys seen 3, 4, 5, 6 = 18 pairs
    f, b = costs.prefill_attention_cost((1, 4, 2, 16), (1, 8, 1, 16), 2,
                                        [2])
    assert f == 4 * 18 * 2 * 16
    assert b == 2 * 4 * 2 * 16 * 2 + 2 * 6 * 1 * 16 * 2 + 4
    # capped by the cache: offset 6, T 4, S 8 -> 7, 8, 8, 8 = 31 pairs
    f, _ = costs.prefill_attention_cost((1, 4, 2, 16), (1, 8, 1, 16), 2,
                                        [6])
    assert f == 4 * 31 * 2 * 16
    # no offset: T(T+1)/2
    f, _ = costs.prefill_attention_cost((3, 5, 1, 8), (3, 5, 1, 8), 2, None)
    assert f == 4 * 3 * 15 * 8


def test_roofline_takes_the_larger_bound():
    assert costs.roofline_s(989e12, 0) == pytest.approx(1.0)
    assert costs.roofline_s(0, 3.35e12) == pytest.approx(1.0)
    assert costs.roofline_s(989e9, 3.35e12) == pytest.approx(1.0)


@pytest.mark.parametrize("name,params", [("internlm2-20b", 19.86e9),
                                         ("deepseek-moe-16b", 16.88e9)])
def test_model_sizes(name, params):
    sz = costs.model_sizes(spec.load_config(name))
    # bf16 weights (the MoE router in fp32: count it as two halves)
    assert sz["weight_bytes"] / 2 == pytest.approx(params, rel=0.01)
    assert sz["kv_bytes_per_token"] == {"internlm2-20b": 192 * 1024,
                                        "deepseek-moe-16b": 224 * 1024}[name]


def test_busy_union_and_gaps():
    ops = [("a", 10, 20), ("b", 15, 30), ("c", 40, 50)]
    busy, gaps = trace.busy_and_gaps(ops, 0, 60)
    assert busy == 30
    assert gaps == [(0, 10), (30, 40), (50, 60)]
    spans = [("step", 0, 35), ("collect", 35, 45)]
    assert trace.label_gap(spans, 30, 40) == "step" or \
        trace.label_gap(spans, 30, 40) == "collect"
    assert trace.label_gap(spans, 36, 40) == "collect"
    assert trace.top_ops(ops + [("a", 60, 65)])[0] == ["a", 15e-9]
