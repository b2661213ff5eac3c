"""The program's spans in a traced window (``harness.program_spans``) on
hand-made timelines and on a CPU profile of the reduced engine: gaps
labelled by the innermost span over most of them, idle time split into
disjoint parts that add up, and the spans' device-side annotations kept
out of the device's operations."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import pytest  # noqa: E402

from portbench.harness import program_spans, trace  # noqa: E402

# one engine iteration, in ns: the step holds a decode dispatch (with an
# attention block inside), a host submit, a chunk dispatch, the commit
# and the retire, which publishes
PROGRAM = [
    ("serve.step", 100, 1000),
    ("serve.admit", 100, 150),
    ("model.decode", 150, 400),
    ("model.attention", 160, 300),
    ("serve.host_submit", 400, 420),
    ("model.chunk", 420, 700),
    ("serve.commit", 700, 800),
    ("serve.retire", 800, 1000),
    ("serve.publish", 820, 990),
]
BENCH = [("step", 90, 1010), ("collect", 1010, 1100)]


@pytest.mark.parametrize("gap,label", [
    ((170, 290), "model.attention"),   # inside the attention block
    ((300, 390), "model.decode"),      # in decode, outside attention
    ((150, 400), "model.attention"),   # attention over half of it
    ((140, 430), "model.decode"),      # attention under half of it
    ((830, 980), "serve.publish"),
    ((805, 1000), "serve.publish"),    # mostly the publish
    ((700, 1000), "serve.publish"),    # retire 2/3, publish 17/30
    ((760, 880), "serve.retire"),      # retire 2/3, publish 1/2
    ((390, 430), "serve.step"),        # no child over half of it
    ((1000, 1010), "step"),            # outside the program's spans
    ((1020, 1090), "collect"),
    ((2000, 2100), "outside"),
])
def test_gap_takes_the_innermost_span_over_most_of_it(gap, label):
    assert program_spans.label_gap(PROGRAM, BENCH, *gap) == label


def test_gap_keeps_the_benchmarks_label_without_program_spans():
    assert program_spans.label_gap([], BENCH, 170, 290) == "step"


def test_idle_parts_are_disjoint_and_add_up():
    ops = [("k", 0, 160), ("k", 200, 250), ("k", 450, 500),
           ("copy", 850, 900), ("k", 1050, 1200)]
    _, gaps = trace.busy_and_gaps(ops, 0, 1200)
    assert gaps == [(160, 200), (250, 450), (500, 850), (900, 1050)]
    within = [(s, e) for n, s, e in BENCH if n == "step"]
    parts = program_spans.idle_by_span(gaps, PROGRAM, within)
    # dispatch: decode 160-200, 250-400; chunk 420-450, 500-700
    assert parts["dispatch"] == 40 + 150 + 30 + 200
    assert (parts["decode"], parts["chunk"]) == (40 + 150, 30 + 200)
    # publish: 820-850, 900-990
    assert parts["publish"] == 30 + 90
    # the rest of the step: 400-420 (submit), 700-820, 990-1000
    assert parts["engine"] == 20 + 120 + 10
    assert parts["step"] == parts["dispatch"] + parts["publish"] \
        + parts["engine"]
    assert parts["idle"] == 40 + 200 + 350 + 150
    # the benchmark's step (90-1010) holds the program's and 10 ns more
    assert parts["within"] == parts["step"] + 10
    assert parts["step"] <= parts["within"] <= parts["idle"]
    inner = program_spans.by_innermost(gaps, PROGRAM)
    assert inner == {"model.attention": 40 + 50, "model.decode": 100,
                     "serve.host_submit": 20, "model.chunk": 30 + 200,
                     "serve.commit": 100, "serve.retire": 20 + 10,
                     "serve.publish": 30 + 90, "none": 50}
    assert sum(inner.values()) == parts["idle"]


def test_no_program_spans_read_zero():
    parts = program_spans.idle_by_span([(0, 10), (20, 30)], [])
    assert parts == {"idle": 20, "step": 0, "dispatch": 0, "decode": 0,
                     "chunk": 0, "publish": 0, "engine": 0, "within": 0}
    assert program_spans.by_innermost([(0, 10)], []) == {"none": 10}


class _Event:
    def __init__(self, name, device, start, dur, annotation=False):
        self._n, self._d, self._s, self._t = name, device, start, dur
        self._a = annotation

    def name(self):
        return self._n

    def device_type(self):
        return f"DeviceType.{self._d}"

    def is_user_annotation(self):
        return self._a

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._t


class _Profile:
    def __init__(self, events):
        class _R:
            def events(_):
                return events

        class _P:
            kineto_results = _R()
        self.profiler = _P()


def test_program_annotations_stay_out_of_the_device_ops():
    prof = _Profile([
        _Event("portbench.step", "CPU", 0, 1000, True),
        _Event("serve.step", "CPU", 10, 900, True),
        _Event("model.decode", "CPU", 20, 300, True),
        # the profiler's device-side copies of the host annotations
        _Event("serve.step", "CUDA", 15, 950, True),
        _Event("model.decode", "CUDA", 25, 400, True),
        _Event("gemm_kernel", "CUDA", 100, 50),
        _Event("aten::mm", "CPU", 30, 20),
    ])
    tl = trace.device_timeline(prof)
    assert tl["ops"] == [("gemm_kernel", 100, 150)]
    assert tl["spans"] == [("step", 0, 1000)]
    busy, _ = trace.busy_and_gaps(tl["ops"], 0, 1000)
    assert busy == 50
    assert [n for n, _ in trace.top_ops(tl["ops"])] == ["gemm_kernel"]
    assert program_spans.collect(prof) == [("serve.step", 10, 910),
                                           ("model.decode", 20, 320)]


def test_spans_of_a_profiled_engine_run():
    """A CPU profile of the reduced engine: the collected spans nest,
    and a gap laid over a publish or an attention block takes its name."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from portbench.harness import small
    from repro_torch.models import init_params
    from repro_torch.serving import Engine, EngineConfig, Request
    torch.set_num_threads(1)
    cfg, keys = small.reduced_config("internlm2-20b")
    params = init_params(cfg, seed=0, device="cpu")
    engine = Engine(cfg, params, EngineConfig(**keys["engine"],
                                              device="cpu"))
    reqs = [Request(prompt=[1, 2, 3, 4] + [5 + i] * (6 + 2 * i),
                    max_new_tokens=4) for i in range(5)]
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            engine.run(reqs)
    finally:
        engine.shutdown()
    spans = program_spans.collect(prof)
    names = {n for n, _, _ in spans}
    assert {"serve.step", "serve.publish", "model.decode", "model.chunk",
            "model.attention", "model.ffn"} <= names
    starts = [s for _, s, _ in spans]
    assert starts == sorted(starts)
    # one thread: any two spans nest or are disjoint
    stack = []
    for _, s, e in spans:
        while stack and stack[-1] <= s:
            stack.pop()
        assert not stack or e <= stack[-1]
        stack.append(e)
    for want in ("serve.publish", "model.attention"):
        _, s, e = next(sp for sp in spans if sp[0] == want)
        assert program_spans.label_gap(spans, [], s, e) == want
    step = [(s, e) for n, s, e in spans if n == "serve.step"]
    parts = program_spans.idle_by_span(step, spans)
    assert parts["step"] == parts["idle"] > 0
    assert 0 < parts["dispatch"] < parts["step"]
    assert parts["publish"] > 0 and parts["engine"] > 0


def test_the_span_tools_readings_on_a_hand_made_window():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "trace_spans", ROOT / "portbench" / "tools" / "trace_spans.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    tl = {"ops": [("k", 0, 160), ("k", 200, 250), ("k", 450, 500),
                  (tool.D2H, 850, 900), ("k", 1050, 1200)],
          "spans": [("window", 0, 1000)] + BENCH}
    got = tool.readings(tl, PROGRAM)
    # idle in the window: 160-200, 250-450, 500-850, 900-1000
    assert got["device_idle_pct"] == pytest.approx(69.0)
    assert got["dispatch_idle_pct"] == pytest.approx(42.0)
    assert got["publish_idle_pct"] == pytest.approx(12.0)
    assert got["engine_idle_pct"] == pytest.approx(15.0)
    assert got["outside_step_idle_pct"] == pytest.approx(0.0)
    assert got["bench_step_idle_pct"] == pytest.approx(69.0)
    assert got["idle_gaps"][0] == ["step", "model.chunk", 350e-9]
    assert got["pageable_d2h_s_by_innermost_span"] == {
        "serve.publish": 50e-9, "none": 0.0}
    assert got["program_ops"] == 0 and got["program_spans"] == 9
