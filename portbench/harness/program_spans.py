"""The program's own spans in a traced window: the serving step's
(``serve.*``) and the model's (``model.*``) ``record_function`` ranges,
which ``repro_torch.tracing.span`` puts on the profiler's timeline.

They label each idle gap of the device by what the host was doing, and
split the window's idle time into disjoint parts: inside the model's
dispatch (``model.decode``, ``model.chunk``), inside the prefix cache's
publish (``serve.publish``), elsewhere inside the engine step
(``serve.step``), and outside the step.  A program without the spans
gives none: every gap keeps the benchmark's own label and every part
reads 0.

Spans are (name, start_ns, end_ns) on the profiler's clock, as
``trace.device_timeline`` gives the benchmark's; program spans are all
on the engine's thread, so any two are nested or disjoint.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from portbench.harness import trace

PREFIXES = ("serve.", "model.")
DISPATCH = ("model.decode", "model.chunk")
PUBLISH = ("serve.publish",)
STEP = ("serve.step",)

Interval = Tuple[int, int]
Span = Tuple[str, int, int]


def collect(prof) -> List[Span]:
    """The program's host spans of a profiled window, by start.  Their
    device-side annotations are no device work and are not taken."""
    out = []
    for ev in prof.profiler.kineto_results.events():
        if str(ev.device_type()).endswith("CPU") \
                and ev.name().startswith(PREFIXES):
            s = ev.start_ns()
            out.append((ev.name(), s, s + ev.duration_ns()))
    out.sort(key=lambda sp: (sp[1], -sp[2]))
    return out


def label_gap(program: Sequence[Span], bench: Sequence[Span], start: int,
              end: int) -> str:
    """The innermost program span that covers more than half of the gap
    [start, end); else the benchmark's label (``trace.label_gap``).
    Spans covering more than half of one gap overlap one another, so
    they nest: the shortest is the innermost."""
    best: Optional[Span] = None
    for sp in program:
        name, s, e = sp
        if s >= end:
            break
        if 2 * (min(e, end) - max(s, start)) > end - start and (
                best is None or e - s < best[2] - best[1]):
            best = sp
    return best[0] if best is not None else trace.label_gap(bench, start,
                                                            end)


def _union(intervals: Sequence[Interval]) -> List[Interval]:
    out: List[Interval] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        elif e > s:
            out.append((s, e))
    return out


def _intersect(a: Sequence[Interval], b: Sequence[Interval]
               ) -> List[Interval]:
    """Intersection of two sorted, disjoint interval lists."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if e > s:
            out.append((s, e))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def _total(intervals: Sequence[Interval]) -> int:
    return sum(e - s for s, e in intervals)


def _of(program: Sequence[Span], names: Tuple[str, ...]) -> List[Interval]:
    return _union([(s, e) for n, s, e in program if n in names])


def idle_by_span(gaps: Sequence[Interval], program: Sequence[Span],
                 within: Sequence[Interval] = ()) -> Dict[str, int]:
    """Idle ns of the device (``gaps``, as ``trace.busy_and_gaps`` gives
    them) in disjoint parts: ``dispatch`` inside ``model.decode``
    (``decode``) or ``model.chunk`` (``chunk``), ``publish`` inside
    ``serve.publish``, ``engine``
    elsewhere inside ``serve.step``; ``idle`` all of it, ``step`` all of
    it inside the step, and ``within`` all of it inside the intervals
    given (the benchmark's own ``step`` spans)."""
    idle = _union(gaps)
    step = _intersect(idle, _of(program, STEP))
    decode, chunk = (_total(_intersect(step, _of(program, (name,))))
                     for name in DISPATCH)
    publish = _total(_intersect(step, _of(program, PUBLISH)))
    return {"idle": _total(idle), "step": _total(step),
            "dispatch": decode + chunk, "decode": decode, "chunk": chunk,
            "publish": publish,
            "engine": _total(step) - decode - chunk - publish,
            "within": _total(_intersect(idle, _union(within)))}


def by_innermost(intervals: Sequence[Interval], program: Sequence[Span]
                 ) -> Dict[str, int]:
    """The ns of ``intervals`` (idle gaps, or the device's copies) under
    each span name, each ns given to the innermost program span over it
    ("none" outside every span)."""
    # the innermost span at each instant: a sweep over nested spans
    segs: List[Tuple[int, int, str]] = []
    stack: List[Span] = []
    cur = None

    def close_to(t: int) -> None:
        nonlocal cur
        while stack and stack[-1][2] <= t:
            top = stack.pop()
            segs.append((cur, top[2], top[0]))
            cur = top[2]
    for sp in program:
        close_to(sp[1])
        if stack:
            segs.append((cur, sp[1], stack[-1][0]))
        stack.append(sp)
        cur = sp[1]
    close_to(1 << 62)
    out: Dict[str, int] = {}
    idle = _union(intervals)
    i = 0
    for s, e, name in segs:           # time-ordered and disjoint
        while i < len(idle) and idle[i][1] <= s:
            i += 1
        j = i
        while j < len(idle) and idle[j][0] < e:
            n = min(e, idle[j][1]) - max(s, idle[j][0])
            if n > 0:
                out[name] = out.get(name, 0) + n
            j += 1
    out["none"] = _total(idle) - sum(out.values())
    return out
