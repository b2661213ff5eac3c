"""Step analysis for the roofline: collective bytes and analytic costs.

  * ``CollectiveCounter`` -- a ``TorchDispatchMode`` that sees every
    ``_c10d_functional`` collective a traced step issues (DTensor's
    redistributions and the optimizer's explicit all-reduces) and
    attributes each its output bytes on this rank, keyed by the
    reference's kind names.  It stands in for the reference's HLO walk:
    the port has no HLO.  The port's program is eager, so a stacked
    layer's collectives are issued once per layer and need no
    loop-trip scaling (``unscaled_bytes`` equals the total).
  * ``collective_bytes_from_hlo`` -- the reference's HLO walker, kept as
    framework-free text parsing (it reads HLO text from anywhere).
  * ``analytic_costs`` -- shape-derived FLOPs/bytes for each step kind,
    the primary roofline source in both packages.

Port of ``repro/launch/analysis.py``.
"""
from __future__ import annotations

import dataclasses
import re
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.models.config import ModelConfig

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "token": 0, "s4": 1, "u4": 1, "f8e4m3fn": 1, "f8e5m2": 1,
}

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")


def _shape_bytes(type_str: str) -> int:
    """Bytes of an HLO type string (handles tuples)."""
    total = 0
    for dtype, dims in _SHAPE_RE.findall(type_str):
        size = _DTYPE_BYTES.get(dtype)
        if size is None:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * size
    return total


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_kind: Dict[str, float]
    count_by_kind: Dict[str, int]
    unscaled_bytes: float

    @property
    def total_bytes(self) -> float:
        return sum(self.bytes_by_kind.values())


# the functional collectives DTensor and the optimizer issue, by the
# reference's HLO kind names
_FUNCOL_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "broadcast": "collective-permute",
}


def _out_bytes(out) -> int:
    if isinstance(out, torch.Tensor):
        return out.numel() * out.element_size()
    if isinstance(out, (list, tuple)):
        return sum(_out_bytes(o) for o in out)
    return 0


def _group_size(args) -> Optional[int]:
    """The size of the process group a functional collective names (None
    if no argument names one)."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    for a in args:
        if isinstance(a, str):
            try:
                return _resolve_process_group(a).size()
            except (ValueError, RuntimeError, KeyError):
                continue
    return None


class CollectiveCounter(TorchDispatchMode):
    """Counts the collectives issued under it, with their output bytes on
    this rank (an all-gather's gathered tensor, a reduce-scatter's
    shard, an all-reduce's whole tensor), as the reference's HLO walk
    attributes them; one over a group of one rank moves nothing and is
    not counted.  DTensor ops pass through to DTensor, whose local
    collectives then come back here."""

    def __init__(self) -> None:
        super().__init__()
        self.bytes_by_kind: Dict[str, float] = defaultdict(float)
        self.count_by_kind: Dict[str, int] = defaultdict(int)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if func.namespace in ("_c10d_functional", "_dtensor"):
            kind = _FUNCOL_KINDS.get(func._schema.name.split("::")[-1])
            if kind is not None and _group_size(args) != 1:
                self.bytes_by_kind[kind] += _out_bytes(out)
                self.count_by_kind[kind] += 1
        return out

    def stats(self) -> CollectiveStats:
        by_kind = dict(self.bytes_by_kind)
        return CollectiveStats(by_kind, dict(self.count_by_kind),
                               sum(by_kind.values()))


def _split_computations(hlo: str) -> Dict[str, List[str]]:
    """computation name -> list of op lines.

    Headers look like ``%name (p: (s32[], f32[8])) -> (s32[], f32[8]) {``
    (params may nest parens, so match on name + '->' + trailing '{')."""
    comps: Dict[str, List[str]] = {}
    current: Optional[str] = None
    for line in hlo.splitlines():
        stripped = line.strip()
        # op lines contain " = "; headers may contain "=" only inside
        # /*index=N*/ comments of tuple types
        if stripped.endswith("{") and "->" in stripped and " = " not in \
                stripped.split("->")[0]:
            header = re.match(r"(?:ENTRY\s+)?%?([\w.\-]+)\s*\(", stripped)
            if header:
                current = header.group(1)
                comps[current] = []
                continue
        if stripped == "}":
            current = None
            continue
        if current is not None and stripped:
            comps[current].append(stripped)
    return comps


def _trip_count(cond_lines: List[str]) -> int:
    """Trip count from a while condition: compare(iv, constant(N)) LT."""
    consts: Dict[str, int] = {}
    for line in cond_lines:
        m = re.match(r"%?([\w.\-]+)\s*=\s*s(?:32|64)\[\]\s+constant\((\d+)\)",
                     line)
        if m:
            consts[m.group(1)] = int(m.group(2))
    for line in cond_lines:
        if "compare(" not in line:
            continue
        args = re.search(r"compare\(([^)]*)\)", line)
        if not args:
            continue
        names = [a.strip().lstrip("%") for a in args.group(1).split(",")]
        for n in names:
            if n in consts:
                return max(consts[n], 1)
    # fallback: any constant in the condition, else 1
    return max(consts.values(), default=1)


def collective_bytes_from_hlo(hlo: str) -> CollectiveStats:
    comps = _split_computations(hlo)

    # find while ops: body/condition computation references
    def analyze(comp: str, mult: float, seen: Tuple[str, ...]
                ) -> Tuple[Dict[str, float], Dict[str, int], float]:
        by_kind: Dict[str, float] = defaultdict(float)
        counts: Dict[str, int] = defaultdict(int)
        unscaled = 0.0
        if comp not in comps or comp in seen:
            return by_kind, counts, unscaled
        for line in comps[comp]:
            m = re.match(r"%?[\w.\-]+\s*=\s*(\([^=]*?\)|\S+)\s+([a-z\-]+)", line)
            if m:
                opcode = m.group(2)
                # async collectives appear as <op>-start/<op>-done;
                # count the -start (the -done carries the same bytes)
                base = opcode[:-6] if opcode.endswith("-start") else opcode
                if base in _COLLECTIVES and not opcode.endswith("-done"):
                    nbytes = _shape_bytes(m.group(1))
                    by_kind[base] += nbytes * mult
                    counts[base] += 1
                    unscaled += nbytes
            if " while(" in line:
                body = re.search(r"body=%?([\w.\-]+)", line)
                cond = re.search(r"condition=%?([\w.\-]+)", line)
                if body:
                    trips = _trip_count(comps.get(cond.group(1), [])) \
                        if cond else 1
                    b2, c2, u2 = analyze(body.group(1), mult * trips,
                                         seen + (comp,))
                    for k, v in b2.items():
                        by_kind[k] += v
                    for k, v in c2.items():
                        counts[k] += v
                    unscaled += u2
            # calls into sub-computations (fusions never hold collectives,
            # but conditionals/calls may)
            cm = re.search(r"(?:call|conditional)\(.*?to_apply=%?([\w.\-]+)",
                           line)
            if cm:
                b2, c2, u2 = analyze(cm.group(1), mult, seen + (comp,))
                for k, v in b2.items():
                    by_kind[k] += v
                for k, v in c2.items():
                    counts[k] += v
                unscaled += u2
        return by_kind, counts, unscaled

    entry = None
    for line in hlo.splitlines():
        m = re.match(r"ENTRY\s+%?([\w.\-]+)", line.strip())
        if m:
            entry = m.group(1)
            break
    if entry is None:
        return CollectiveStats({}, {}, 0.0)
    by_kind, counts, unscaled = analyze(entry, 1.0, ())
    return CollectiveStats(dict(by_kind), dict(counts), unscaled)


# ---------------------------------------------------------------------------
# Analytic FLOPs / bytes per step (global; divide by chips for per-device)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class StepCosts:
    flops: float              # useful FLOPs (MODEL_FLOPS convention)
    hbm_bytes: float          # params + KV + states traffic
    model_flops: float        # 6ND / 2ND reference
    notes: str = ""


def analytic_costs(cfg: ModelConfig, kind: str, *, seq_len: int,
                   global_batch: int, remat: bool = True,
                   host_fraction: float = 0.0) -> StepCosts:
    """First-principles cost of one step (whole mesh, not per-device)."""
    n_active = cfg.active_param_count()
    head = cfg.resolved_head_dim
    kv_bytes_tok = 2 * cfg.num_attn_layers * cfg.num_kv_heads * head * 2
    b, t = global_batch, seq_len

    if kind == "train":
        tokens = b * t
        # fwd+bwd linear = 6ND; remat re-runs the fwd inside bwd (+2ND)
        linear = (8.0 if remat else 6.0) * n_active * tokens
        # causal attention fwd: QK^T + PV = 2 matmuls x 2 FLOPs x 0.5
        # causal = 2*B*T^2*H*D per layer; bwd 2x fwd (+1x under remat)
        attn_fwd = 2.0 * b * (t ** 2) * cfg.num_heads * head \
            * cfg.num_attn_layers
        attn = attn_fwd * (4.0 if remat else 3.0)
        flops = linear + attn
        # params read (fwd+bwd+wgrad ~3x) + grads written + opt states rw
        param_bytes = cfg.param_count() * 2
        hbm = 3 * param_bytes + 2 * param_bytes + 4 * param_bytes \
            + tokens * cfg.d_model * 2 * cfg.num_layers * 2
        return StepCosts(flops=flops, hbm_bytes=hbm,
                         model_flops=6.0 * n_active * tokens,
                         notes="linear 8ND w/ remat + causal attn")

    if kind == "prefill":
        tokens = b * t
        linear = 2.0 * n_active * tokens
        attn = 2.0 * b * (t ** 2) * cfg.num_heads * head * cfg.num_attn_layers
        param_bytes = cfg.param_count() * 2
        hbm = param_bytes + tokens * kv_bytes_tok \
            + tokens * cfg.d_model * 2 * cfg.num_layers * 2
        return StepCosts(flops=linear + attn, hbm_bytes=hbm,
                         model_flops=2.0 * n_active * tokens,
                         notes="prefill: linear + causal attn")

    if kind == "decode":
        device_rows = int(b * (1.0 - host_fraction))
        linear = 2.0 * n_active * b            # unified batch (APEX!)
        # decode attention: QK^T + PV over the full cache = 2 matmuls
        # x 2 FLOPs = 4*rows*S*H*D per layer (no causal halving: every
        # cached position is attended)
        attn = 4.0 * device_rows * t * cfg.num_heads * head \
            * cfg.num_attn_layers
        param_bytes = cfg.active_param_count() * 2
        kv_read = device_rows * t * kv_bytes_tok
        hbm = param_bytes + kv_read + device_rows * kv_bytes_tok
        return StepCosts(flops=linear + attn, hbm_bytes=hbm,
                         model_flops=2.0 * n_active * b,
                         notes=f"decode: {device_rows}/{b} rows on-device")

    raise ValueError(kind)


# ---------------------------------------------------------------------------
# The hand kernels' work from their shapes (they dispatch no aten op, so a
# flop counter cannot see them); the formulas behind PERF.md's bounds
# ---------------------------------------------------------------------------


def _attn_pairs(b: int, t: int, s: int, causal: bool) -> int:
    """Visible (query, key) pairs of a span of T queries at positions
    0..T-1 over S keys: T(T+1)/2 a row causal, T*S full."""
    return b * (t * (t + 1) // 2 if causal else t * s)


# The xLSTM recurrences' arithmetic, as the function needs it (not as a
# kernel's design may repeat it).  sLSTM, beyond its product with R: per
# unit and step of the update (gate sums, stabiliser, exp, tanh, sigmoid,
# cell, normaliser, h) and of its reverse walk.  mLSTM, per element of
# the matrix memory and step: forward f C + (i v) k (3) and the read-out
# C q (2); backward the memory rebuilt once (3), dC += dnum q (2),
# C^T dnum (2), <dC, C_prev> (2), dC k (2), dC^T v (2) and f dC (1).
# Per element of its vectors and step: i v (1), n (3), n . q (2), h (1)
# forward, and four times that backward.
SLSTM_POINT_FLOPS = 26
SLSTM_BWD_POINT_FLOPS = 50
MLSTM_CELL_FLOPS = 5
MLSTM_BWD_CELL_FLOPS = 14
MLSTM_VEC_FLOPS = 7


def xlstm_costs(name: str, a) -> Tuple[float, float]:
    """(flops, bytes) of one xLSTM recurrence call at the shapes its meta
    rule records: each input read once, each output written once."""
    if name.startswith("slstm"):
        b, t, four_d = a["gates"]
        _, nh, hd = a["state"]
        d = four_d // 4
        r_bytes = nh * hd * 4 * hd * torch.empty(
            (), dtype=a["dtype"]).element_size()
        if name == "slstm_recurrence":
            flops = 2.0 * b * t * nh * hd * 4 * hd \
                + SLSTM_POINT_FLOPS * b * t * nh * hd
            nbytes = (4.0 * b * t * four_d + r_bytes + 4 * four_d
                      + 2 * 4 * 4 * b * d + 4 * b * t * d + 4 * b)
            if a.get("save"):
                nbytes += 4.0 * b * t * four_d + 3 * 4 * b * t * d
            return flops, nbytes
        flops = 2.0 * b * t * nh * hd * 4 * hd \
            + SLSTM_BWD_POINT_FLOPS * b * t * nh * hd
        nbytes = (2 * 4.0 * b * t * four_d + 4 * 4 * b * t * d + r_bytes
                  + (3 + 4 + 4) * 4 * b * d)
        return flops, nbytes
    b, t, nh, hd = a["q"]
    state = 4.0 * b * nh * (hd * hd + hd + 1)
    seq, gates = 4.0 * b * t * nh * hd, 4.0 * b * t * nh
    if name == "mlstm_recurrence":
        flops = b * t * nh * (MLSTM_CELL_FLOPS * hd * hd
                              + MLSTM_VEC_FLOPS * hd)
        return float(flops), 4 * seq + 2 * gates + 2 * state + 4 * b
    flops = b * t * nh * (MLSTM_BWD_CELL_FLOPS * hd * hd
                          + 4 * MLSTM_VEC_FLOPS * hd)
    return float(flops), 8 * seq + 4 * gates + 3 * state


def kernel_costs(calls) -> Tuple[float, float]:
    """(flops, bytes) of the kernel calls ``kernels.ops.record_meta_calls``
    collected, each at the shapes it records (a rank's local shapes): a
    decode row attends its whole cache (the analytic model's
    assumption), a prefill span starts at position 0."""
    flops = nbytes = 0.0
    for name, a in calls:
        el = torch.empty((), dtype=a["dtype"]).element_size()
        if name == "decode_attention":
            b, h, d = a["q"]
            _, s, kv, _ = a["k"]
            flops += 4.0 * b * s * h * d
            nbytes += 2.0 * b * s * kv * d * el + 2 * b * h * d * el + 4 * b
        elif name in ("prefill_attention", "prefill_attention_bwd"):
            b, t, h, d = a["q"]
            _, s, kv, _ = a["k"]
            pairs = _attn_pairs(b, t, s, a["causal"])
            if name == "prefill_attention":
                flops += 4.0 * pairs * h * d
                nbytes += 2.0 * b * t * h * d * el + 2 * b * s * kv * d * el \
                    + 4 * b
            else:
                flops += 10.0 * pairs * h * d
                nbytes += el * (4.0 * b * t * h * d + 4 * b * t * kv * d) \
                    + 4 * b * h * t
        elif name == "mamba_selective_scan":
            b, t, i = a["dt"]
            n = a["b"][-1]
            flops += 5.0 * b * t * i * n
            nbytes += (2.0 * b * t * i * el + 2 * b * t * n * el
                       + i * n * 4 + i * 4 + 2 * b * i * n * 4 + b * 4
                       + b * t * i * 4)
        elif name == "mamba_selective_scan_bwd":
            b, t, i = a["dt"]
            n = a["b"][-1]
            flops += 14.0 * b * t * i * n
            nbytes += (5.0 * b * t * i * 4 + 4 * b * t * n * 4
                       + 2 * (i * n * 4 + i * 4 + b * i * n * 4))
        elif name in ("slstm_recurrence", "slstm_recurrence_bwd",
                      "mlstm_recurrence", "mlstm_recurrence_bwd"):
            f, nb = xlstm_costs(name, a)
            flops += f
            nbytes += nb
        else:
            raise KeyError(name)
    return flops, nbytes
