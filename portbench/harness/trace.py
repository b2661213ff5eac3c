"""The traced run's readings: what each attention kernel call was given
(wrapping the entry points of ``repro_torch.kernels.ops`` for the window
only), what each engine iteration did, and the device timeline from
``torch.profiler``.

The wrappers keep each call's shapes and a device-side copy of its
length tensor; nothing is read back before the window closes.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

DECODE_KERNELS = ("decode_kernel",)
PREFILL_KERNELS = ("prefill_mma_kernel", "prefill_fma_kernel")


class Recorder:
    """Attention calls and chunk plans of the window, by iteration."""

    def __init__(self) -> None:
        self.step = 0
        self.decode: List[Tuple[int, tuple, tuple, int, object]] = []
        self.prefill: List[Tuple[int, tuple, tuple, int, object, bool]] = []
        self.chunks: List[Tuple[int, List[int], List[int]]] = []
        self.steps: List[Tuple[int, Dict[str, int]]] = []

    @contextlib.contextmanager
    def wrapping(self, engine):
        """Wrap ``ops.decode_attention``, ``ops.prefill_attention`` and the
        engine's chunk planner for the block's duration."""
        from repro_torch.kernels import ops
        dec, pre = ops.decode_attention, ops.prefill_attention
        lc = engine.lc
        plan_chunks = lc.plan_chunks

        def decode_attention(q, k, v, lengths):
            self.decode.append((self.step, tuple(q.shape), tuple(k.shape),
                                k.element_size(), lengths.clone()))
            return dec(q, k, v, lengths)

        def prefill_attention(q, k, v, prefix_len=None, q_offset=None, *,
                              causal=True):
            self.prefill.append((
                self.step, tuple(q.shape), tuple(k.shape), k.element_size(),
                None if q_offset is None else q_offset.clone(), causal))
            return pre(q, k, v, prefix_len, q_offset, causal=causal)

        def planned(budget):
            plan = plan_chunks(budget)
            if plan is not None:
                self.chunks.append((self.step, [
                    lc.staging[r].consumed for r in plan.rows],
                    list(plan.lens)))
            return plan

        ops.decode_attention = decode_attention
        ops.prefill_attention = prefill_attention
        lc.plan_chunks = planned
        try:
            yield self
        finally:
            ops.decode_attention = dec
            ops.prefill_attention = pre
            del lc.plan_chunks

    def note_step(self, stats) -> None:
        self.steps.append((self.step, {
            "device_tokens": stats.device_tokens,
            "host_tokens": stats.host_tokens,
            "chunk_tokens": stats.chunked_prefill_tokens}))
        self.step += 1


def _span(ev) -> Tuple[int, int]:
    return ev.start_ns(), ev.start_ns() + ev.duration_ns()


def device_timeline(prof) -> dict:
    """Device operations of a profiled window: each kernel, copy and
    fill as (name, start_ns, end_ns), and the host spans named
    ``portbench.*``."""
    ops, spans = [], []
    for ev in prof.profiler.kineto_results.events():
        dt = str(ev.device_type())
        if dt.endswith("CUDA") and not ev.is_user_annotation() \
                and not ev.name().startswith("portbench."):
            s, e = _span(ev)
            if e > s:
                ops.append((ev.name(), s, e))
        elif dt.endswith("CPU") and ev.name().startswith("portbench."):
            s, e = _span(ev)
            spans.append((ev.name()[len("portbench."):], s, e))
    ops.sort(key=lambda o: o[1])
    spans.sort(key=lambda o: o[1])
    return {"ops": ops, "spans": spans}


def busy_and_gaps(ops: List[tuple], t0: Optional[int] = None,
                  t1: Optional[int] = None):
    """(busy ns: the union of the ops' intervals, the idle gaps between
    them as (start, end)) within [t0, t1]."""
    busy = 0
    gaps = []
    cur_s = cur_e = None
    for _, s, e in ops:
        if t0 is not None:
            s = max(s, t0)
        if t1 is not None:
            e = min(e, t1)
        if e <= s:
            continue
        if cur_e is None:
            if t0 is not None and s > t0:
                gaps.append((t0, s))
            cur_s, cur_e = s, e
        elif s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
        if t1 is not None and t1 > cur_e:
            gaps.append((cur_e, t1))
    return busy, gaps


def label_gap(spans: List[tuple], start: int, end: int) -> str:
    """The host span that covers most of a device gap ("outside" where
    none of the benchmark's spans does)."""
    best, cover = "outside", 0
    for name, s, e in spans:
        if e <= start:
            continue
        if s >= end:
            break
        c = min(e, end) - max(s, start)
        if c > cover:
            best, cover = name, c
    return best


def kernel_time_s(ops: List[tuple], names: Tuple[str, ...]) -> float:
    return sum(e - s for n, s, e in ops if any(k in n for k in names)) / 1e9


def top_ops(ops: List[tuple], n: int = 10) -> List[list]:
    """Device operations by total time, largest first: [name, seconds]."""
    tot: Dict[str, int] = {}
    for name, s, e in ops:
        key = name if len(name) <= 160 else name[:157] + "..."
        tot[key] = tot.get(key, 0) + (e - s)
    ranked = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
    return [[k, v / 1e9] for k, v in ranked]
