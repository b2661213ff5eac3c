#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of APEX on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. environment: torch/CUDA versions, device, nvidia-smi name and power limit;
  2. kernels: builds every CUDA kernel from src/repro_torch/csrc with nvcc
     (sm_90a), holds each against its plain PyTorch version over the
     reference sweeps and at the main-path shapes, checks that prefill
     output is bitwise independent of how a prompt is split and the
     scan's of how a call is split in T (state carried), in place or
     not, that decode attention and the scan are one launch per call
     with no allocation but their outputs, and times kernel, plain
     version and one library call (where one exists) against the card's
     bound -- at the main-path shapes, and also at a long decode (B 8,
     S 8192), a long causal prefill (T 4096) and a long scan (B 1,
     T 4096);
  3. exactness: llama3.1-8b and the dense-FFN Jamba hybrid, each reduced
     to d_model 256 in fp32 -- greedy tokens from raw prefill+decode,
     engine device rows and host-offloaded rows must be identical;
  4. serving: InferenceServer on llama3.1-8b at its published width (bf16,
     random weights from a seed), 8 requests over 4 device + 4 host slots;
  5. serving-hybrid: the same traffic on Jamba-1.5-Large with dense FFNs
     at its published width, depth cut to 2 periods (16 layers);
  6. cli: ``python -m repro_torch.launch.serve`` with its defaults.

The line before the last is the JSON ``kernels`` record; the last line is
``{"ok": true, "device": {...}}``.  ``--phases`` runs a subset (the
``kernels`` record needs the serving phases for its launch counts; each
serving phase zeroes the launch counts just before its measured run and
reads them just after).
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and dense
# tensor-core / CUDA-core rates.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
# exp() results per second: 16 per SM per clock on the special function
# units (Hopper white paper) x 132 SMs x 1.98 GHz boost clock
PEAK_EXP_PER_S = 16 * 132 * 1.98e9

DECODE_SWEEP = [            # (B, H, KV, D, S) -- tests/test_kernels.py
    (1, 4, 4, 64, 128),
    (2, 8, 2, 64, 512),
    (3, 8, 1, 128, 384),
    (2, 16, 8, 128, 1024),
]
PREFILL_SWEEP = [           # (B, T, H, KV, D, causal)
    (1, 128, 4, 4, 64, True),
    (2, 256, 8, 2, 64, True),
    (1, 200, 4, 1, 64, True),
    (2, 128, 4, 4, 64, False),
]
CHUNK_SWEEP = [             # (B, T_chunk, S_cache, H, KV, D)
    (2, 64, 160, 4, 2, 64),
    (1, 32, 96, 4, 1, 64),
]
SCAN_SWEEP = [              # (B, T, I, N) -- tests/test_kernels.py
    (1, 16, 64, 8),
    (2, 33, 128, 16),
    (2, 64, 256, 16),
]
SCAN_CUTS = (1, 31, 32, 33, 64)   # where a T 70 scan is split in two calls
TOL = {("decode", "float32"): 1e-5, ("decode", "bfloat16"): 2e-2,
       ("prefill", "float32"): 1e-5, ("prefill", "bfloat16"): 3e-2,
       ("scan", "float32"): 1e-5, ("scan", "bfloat16"): 3e-2}

# main-path shapes of llama3.1-8b in the serving phase
MAIN = dict(heads=32, kv_heads=8, head_dim=128, layers=32, cache_len=512,
            device_slots=4, host_slots=4, prompt_len=128, output_len=16,
            requests=8)
# the selective scan in the hybrid serving phase (Jamba: inner 2 x 8192,
# N 16, 14 Mamba layers): prefill of one bucket of 8 prompts of 128, and
# decode of 4 device + 4 host rows
SCAN_MAIN = dict(inner=16384, state=16, mamba_layers=14, rows=8,
                 prompt_len=128)
# long shapes where bytes (decode) and flops (prefill) dominate; timed and
# printed beside the records, not records themselves
LONG_DECODE = dict(rows=8, cache_len=8192, min_len=7936)
LONG_PREFILL = dict(rows=1, prompt_len=4096)
LONG_SCAN = dict(rows=1, prompt_len=4096)      # one long prompt into Jamba
CARD = ""           # nvidia-smi's "name, power.limit", set by phase 1
# a part of each hand-written kernel's name, as the profiler reports it
PORT_KERNELS = {"decode_attention": "decode_kernel",
                "prefill_attention": "prefill_", "mamba_selective_scan":
                "mamba_scan_kernel"}


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"FAIL: {msg}")


def dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


def close(out, ref, tol):
    """(max |out - ref|, allclose at atol = rtol = tol)."""
    import torch
    o, r = out.float(), ref.float()
    err = (o - r).abs()
    ok = bool((err <= tol + tol * r.abs()).all())
    return float(err.max()), ok


def time_ms(fn, *, warmup: int = 3, reps: int = 20,
            rounds: int = 5) -> float:
    """Per-call time of ``fn`` on the card: CUDA events around ``reps``
    back-to-back calls, divided by ``reps``; median of ``rounds``.  Where
    the host enqueues slower than the card runs, this is the host's rate."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def device_ms(fn, *, reps: int = 20):
    """Device time per call of ``fn``: the summed self time of every
    kernel it ran, from ``torch.profiler`` (no host enqueue); None when
    the profiler reports no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = 0.0
    for ev in prof.key_averages():
        total_us += getattr(ev, "self_device_time_total",
                            getattr(ev, "self_cuda_time_total", 0.0))
    return total_us / reps / 1e3 if total_us > 0 else None


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------


def phase_env() -> dict:
    import torch
    name = torch.cuda.get_device_name(0)
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}  device {name}  "
        f"count {torch.cuda.device_count()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    global CARD
    CARD = card
    return {"name": name, "card": card}


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------


def _randn(gen, shape, dtype, device):
    import torch
    return torch.randn(shape, generator=gen, device=device,
                       dtype=torch.float32).to(dtype)


def _decode_case(gen, b, h, kv, d, s, dtype, lengths=None):
    import torch
    q = _randn(gen, (b, h, d), dtype, "cuda")
    k = _randn(gen, (b, s, kv, d), dtype, "cuda")
    v = _randn(gen, (b, s, kv, d), dtype, "cuda")
    if lengths is None:
        lengths = torch.randint(1, s + 1, (b,), generator=gen,
                                device="cuda", dtype=torch.int32)
    return q, k, v, lengths


def check_sweeps(gen) -> None:
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.prefill_attention import prefill_attention_cuda
    for dtype in (torch.float32, torch.bfloat16):
        dn = dtype_name(dtype)
        for b, h, kv, d, s in DECODE_SWEEP:
            q, k, v, lengths = _decode_case(gen, b, h, kv, d, s, dtype)
            out = decode_attention_cuda(q, k, v, lengths)
            err, ok = close(out, ref.decode_attention_ref(q, k, v, lengths),
                            TOL["decode", dn])
            log(f"  decode  {dn:8s} B{b} H{h} KV{kv} D{d} S{s}: "
                f"max_abs_err {err:.3e}")
            if not ok:
                fail(f"decode_attention {dn} {(b, h, kv, d, s)} err {err}")
        for b, t, h, kv, d, causal in PREFILL_SWEEP:
            q = _randn(gen, (b, t, h, d), dtype, "cuda")
            k = _randn(gen, (b, t, kv, d), dtype, "cuda")
            v = _randn(gen, (b, t, kv, d), dtype, "cuda")
            prefix = torch.randint(0, t // 2, (b,), generator=gen,
                                   device="cuda", dtype=torch.int32)
            out = prefill_attention_cuda(q, k, v, prefix, causal=causal)
            expect = ref.prefill_attention_ref(q, k, v, prefix, causal=causal)
            err, ok = close(out, expect, TOL["prefill", dn])
            log(f"  prefill {dn:8s} B{b} T{t} H{h} KV{kv} D{d} "
                f"causal={causal}: max_abs_err {err:.3e}")
            if not ok:
                fail(f"prefill_attention {dn} {(b, t, h, kv, d)} err {err}")
        for b, t, s, h, kv, d in CHUNK_SWEEP:
            q = _randn(gen, (b, t, h, d), dtype, "cuda")
            k = _randn(gen, (b, s, kv, d), dtype, "cuda")
            v = _randn(gen, (b, s, kv, d), dtype, "cuda")
            off = torch.randint(0, s - t + 1, (b,), generator=gen,
                                device="cuda", dtype=torch.int32)
            out = prefill_attention_cuda(q, k, v, None, off)
            err, ok = close(out, ref.prefill_attention_ref(q, k, v, None, off),
                            TOL["prefill", dn])
            log(f"  chunk   {dn:8s} B{b} T{t} S{s} H{h} KV{kv} D{d}: "
                f"max_abs_err {err:.3e}")
            if not ok:
                fail(f"chunked prefill {dn} {(b, t, s)} err {err}")
    # two cases where the Pallas kernel departs from the oracle: a prefix
    # past the first query block, and full attention over a ragged S
    for t, causal, pre in ((128, True, 100), (100, False, 0)):
        q = _randn(gen, (1, t, 2, 32), torch.float32, "cuda")
        k = _randn(gen, (1, t, 2, 32), torch.float32, "cuda")
        v = _randn(gen, (1, t, 2, 32), torch.float32, "cuda")
        prefix = torch.tensor([pre], dtype=torch.int32, device="cuda")
        err, ok = close(prefill_attention_cuda(q, k, v, prefix,
                                               causal=causal),
                        ref.prefill_attention_ref(q, k, v, prefix,
                                                  causal=causal), 1e-5)
        log(f"  prefill edge T{t} causal={causal} prefix {pre}: "
            f"max_abs_err {err:.3e}")
        if not ok:
            fail(f"prefill edge case T{t} causal={causal}: err {err}")
    # prefix tokens see each other bidirectionally
    q = _randn(gen, (1, 64, 2, 32), torch.float32, "cuda")
    k = _randn(gen, (1, 64, 2, 32), torch.float32, "cuda")
    v = _randn(gen, (1, 64, 2, 32), torch.float32, "cuda")
    zero = torch.zeros(1, dtype=torch.int32, device="cuda")
    no_pre = prefill_attention_cuda(q, k, v, zero)
    with_pre = prefill_attention_cuda(q, k, v, zero + 16)
    if torch.allclose(no_pre[0, 0], with_pre[0, 0]):
        fail("prefix_len did not change token 0's attention")


def check_chunk_split_bitwise(gen) -> None:
    """A token's prefill output must not depend on how its prompt was
    split into chunks (q_offset) -- bitwise."""
    import torch
    from repro_torch.kernels.prefill_attention import prefill_attention_cuda
    b, t, s, h, kv, d = 2, 200, 256, 8, 2, 128
    for dtype in (torch.float32, torch.bfloat16):
        q = _randn(gen, (b, t, h, d), dtype, "cuda")
        k = _randn(gen, (b, s, kv, d), dtype, "cuda")
        v = _randn(gen, (b, s, kv, d), dtype, "cuda")
        whole = prefill_attention_cuda(q, k, v)
        for cuts in ((0, 48, 112, 200), (0, 1, 77, 130, 200), (0, 64, 200)):
            for a, e in zip(cuts[:-1], cuts[1:]):
                off = torch.full((b,), a, dtype=torch.int32, device="cuda")
                part = prefill_attention_cuda(q[:, a:e].contiguous(), k, v,
                                              None, off)
                if not torch.equal(part, whole[:, a:e]):
                    fail(f"prefill {dtype_name(dtype)}: chunk [{a},{e}) of "
                         f"split {cuts} differs from the whole prompt")
        log(f"  chunk-split bitwise {dtype_name(dtype)}: identical over 3 "
            "splittings")


def _scan_case(gen, b, t, i, n, dtype, h0_scale=0.5):
    import torch
    import torch.nn.functional as F
    dt = F.softplus(_randn(gen, (b, t, i), torch.float32, "cuda")).to(dtype)
    x = _randn(gen, (b, t, i), dtype, "cuda")
    bb = _randn(gen, (b, t, n), dtype, "cuda")
    cc = _randn(gen, (b, t, n), dtype, "cuda")
    a_neg = -torch.exp(_randn(gen, (i, n), torch.float32, "cuda"))
    d_skip = _randn(gen, (i,), torch.float32, "cuda")
    h0 = h0_scale * _randn(gen, (b, i, n), torch.float32, "cuda")
    return dt, x, bb, cc, a_neg, d_skip, h0


def check_scan(gen) -> None:
    """The selective-scan kernel against its plain version: the reference
    sweep (N 8 and N 16), right-padded rows (with a row of length 0, over
    a ragged inner dim, at N 8 and N 16), and bitwise: a padded row's
    state equals its unpadded run's, a call split in T with h0 carried
    equals one call (splits across the 32-step tiles), and the state
    written in place over h0 equals a fresh h_final."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.mamba_scan import mamba_selective_scan_cuda
    for dtype in (torch.float32, torch.bfloat16):
        dn = dtype_name(dtype)
        tol = TOL["scan", dn]
        for b, t, i, n in SCAN_SWEEP:
            args = _scan_case(gen, b, t, i, n, dtype, h0_scale=0.0)
            ys, hs = mamba_selective_scan_cuda(*args)
            yr, hr = ref.mamba_selective_scan_ref(*args)
            err = max(close(ys, yr, tol)[0], close(hs, hr, tol)[0])
            log(f"  scan    {dn:8s} B{b} T{t} I{i} N{n}: max_abs_err "
                f"{err:.3e}")
            if not (close(ys, yr, tol)[1] and close(hs, hr, tol)[1]):
                fail(f"mamba_scan {dn} {(b, t, i, n)} err {err}")
        for n in (8, 16):
            b, t, i = 4, 33, 200
            args = _scan_case(gen, b, t, i, n, dtype)
            lens = torch.tensor([33, 20, 0, 1], dtype=torch.int32,
                                device="cuda")
            ys, hs = mamba_selective_scan_cuda(*args, lens)
            yr, hr = ref.mamba_selective_scan_ref(*args, lens)
            err = max(close(ys, yr, tol)[0], close(hs, hr, tol)[0])
            log(f"  scan    {dn:8s} lens {lens.tolist()} B{b} T{t} I{i} "
                f"N{n}: max_abs_err {err:.3e}")
            if not (close(ys, yr, tol)[1] and close(hs, hr, tol)[1]):
                fail(f"mamba_scan {dn} N{n} with lens: err {err}")
            if not torch.equal(hs[2], args[6][2]):
                fail(f"mamba_scan {dn}: a row of length 0 changed its state")
            for row in (1, 3):
                real = int(lens[row])
                one = [v[row:row + 1, :real].contiguous() for v in args[:4]]
                _, h_one = mamba_selective_scan_cuda(
                    *one, *args[4:6], args[6][row:row + 1].contiguous())
                if not torch.equal(h_one[0], hs[row]):
                    fail(f"mamba_scan {dn} N{n}: padded row {row}'s state "
                         "differs from its unpadded run")
        # h0 threading: two halves == one call
        b, t, i, n = 1, 32, 64, 8
        args = _scan_case(gen, b, t, i, n, dtype)
        y_full, h_full = mamba_selective_scan_cuda(*args)
        half = [v[:, :16].contiguous() for v in args[:4]]
        rest = [v[:, 16:].contiguous() for v in args[:4]]
        y1, h_mid = mamba_selective_scan_cuda(*half, *args[4:])
        y2, h_end = mamba_selective_scan_cuda(*rest, *args[4:6], h_mid)
        if not (torch.equal(torch.cat([y1, y2], 1), y_full)
                and torch.equal(h_end, h_full)):
            fail(f"mamba_scan {dn}: h0 carried across calls differs from "
                 "one call")
        # splits of a T 70 call before, at and after the tile edges
        b, t, i, n = 2, 70, 256, 16
        args = _scan_case(gen, b, t, i, n, dtype)
        y_full, h_full = mamba_selective_scan_cuda(*args)
        for cut in SCAN_CUTS:
            y1, h_mid = mamba_selective_scan_cuda(
                *[v[:, :cut].contiguous() for v in args[:4]], *args[4:])
            y2, h_end = mamba_selective_scan_cuda(
                *[v[:, cut:].contiguous() for v in args[:4]], *args[4:6],
                h_mid)
            if not (torch.equal(torch.cat([y1, y2], 1), y_full)
                    and torch.equal(h_end, h_full)):
                fail(f"mamba_scan {dn}: T {t} split at {cut} with h0 "
                     "carried differs from one call")
        # in place: h_out is h0
        state = args[6].clone()
        y_in, h_in = mamba_selective_scan_cuda(*args[:6], state,
                                               h_out=state)
        if not (h_in is state and torch.equal(y_in, y_full)
                and torch.equal(state, h_full)):
            fail(f"mamba_scan {dn}: the state written over h0 differs from "
                 "a fresh h_final")
        log(f"  scan    {dn:8s} padded rows == unpadded runs (N 8, N 16), "
            f"h0 carry == one call (splits at {SCAN_CUTS} of T {t}), in "
            "place == fresh: bitwise")


def check_scan_one_launch(gen) -> None:
    """mamba_selective_scan_cuda is one kernel launch per call and
    allocates only y, and h_final when no h_out is given."""
    import torch
    from repro_torch.kernels.mamba_scan import mamba_selective_scan_cuda
    b, i, n = SCAN_MAIN["rows"], SCAN_MAIN["inner"], SCAN_MAIN["state"]
    args = _scan_case(gen, b, 1, i, n, torch.float32)
    lens = torch.tensor([1, 1, 0, 1, 0, 1, 1, 1], dtype=torch.int32,
                        device="cuda")
    state = args[6].clone()
    mamba_selective_scan_cuda(*args, lens)
    torch.cuda.synchronize()
    calls = 10
    for h_out, per_call in ((None, 2), (state, 1)):
        def call():
            return mamba_selective_scan_cuda(*args[:6], state, lens, h_out)
        allocs = torch.cuda.memory_stats().get("allocation.all.allocated", 0)
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
        allocs = torch.cuda.memory_stats().get("allocation.all.allocated",
                                               0) - allocs
        kinds = graph_launches(call, calls,
                               PORT_KERNELS["mamba_selective_scan"])
        how = "in place" if h_out is not None else "fresh h_final"
        log(f"  mamba_selective_scan_cuda ({how}): graph nodes {kinds} and "
            f"{allocs} allocations over {calls} calls")
        if kinds != {"kernel": calls}:
            fail(f"mamba_selective_scan_cuda ({how}) put {kinds} on the "
                 f"stream in {calls} calls; want one launch of its kernel "
                 "per call")
        if allocs != per_call * calls:
            fail(f"mamba_selective_scan_cuda ({how}) made {allocs} "
                 f"allocations in {calls} calls; want {per_call} per call")


def scan_bound(b: int, t: int, i: int, n: int, el: int = 4) -> dict:
    """The least time of a selective scan on the card: every input byte
    read once and every output byte written once (dt, x, b, c in ``el``
    bytes; A, D, h0, y, h_final fp32; lens int32), against B*T*I*N exp
    calls on the SFUs and 5 fp32 flops per exp."""
    nbytes = (2 * b * t * i * el + 2 * b * t * n * el     # dt, x, b, c
              + i * n * 4 + i * 4 + b * i * n * 4 + b * 4  # A, D, h0, lens
              + b * t * i * 4 + b * i * n * 4)            # y, h_final
    exps = b * t * i * n
    flops = 5 * exps          # dt*A, *h, +dt*x*b, h*c, sum
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_exp = exps / PEAK_EXP_PER_S * 1e3
    t_flop = flops / PEAK_FLOPS["float32"] * 1e3
    bound = max(t_bytes, t_exp, t_flop)
    return {"bound_ms": bound,
            "bound_by": "bytes" if t_bytes >= max(t_exp, t_flop)
            else "operations", "bytes": nbytes, "exp": exps,
            "flops": flops, "t_bytes": t_bytes, "t_exp": t_exp,
            "t_flop": t_flop}


def _bound_text(bd: dict) -> str:
    return (f"bound {bd['bound_ms']:.5f} ms ({bd['bound_by']}; bytes "
            f"{bd['bytes']} B -> {bd['t_bytes']:.5f} ms, exp {bd['exp']} -> "
            f"{bd['t_exp']:.5f} ms, fp32 {bd['flops']} flop -> "
            f"{bd['t_flop']:.5f} ms)")


def bench_scan(gen) -> dict:
    """Kernel vs plain version at the hybrid serving phase's two shapes
    (profiler device time per call, CUDA events around back-to-back
    calls beside it), and the kernel alone at one long prompt (events,
    profiler beside); no single PyTorch call computes a selective scan
    (library: none)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.mamba_scan import mamba_selective_scan_cuda
    i, n, layers = SCAN_MAIN["inner"], SCAN_MAIN["state"], \
        SCAN_MAIN["mamba_layers"]
    b, plen = SCAN_MAIN["rows"], SCAN_MAIN["prompt_len"]
    out = {}
    for shape, t in (("prefill", plen), ("decode", 1)):
        args = _scan_case(gen, b, t, i, n, torch.float32)
        lens = torch.full((b,), t, dtype=torch.int32, device="cuda")
        ys, hs = mamba_selective_scan_cuda(*args, lens)
        yr, hr = ref.mamba_selective_scan_ref(*args, lens)
        err = max(close(ys, yr, TOL["scan", "float32"])[0],
                  close(hs, hr, TOL["scan", "float32"])[0])
        if not (close(ys, yr, 1e-5)[1] and close(hs, hr, 1e-5)[1]):
            fail(f"mamba_scan at the {shape} shape: err {err}")
        # one (a_neg, d_skip, h0) per Mamba layer, rotated, so the state
        # comes from HBM as in a real step (14 x 8.4 MB > the 50 MB L2)
        per_layer = [(-torch.exp(_randn(gen, (i, n), torch.float32, "cuda")),
                      _randn(gen, (i,), torch.float32, "cuda"),
                      0.5 * _randn(gen, (b, i, n), torch.float32, "cuda"))
                     for _ in range(layers)]
        layer = [0]

        def rot(fn):
            def call():
                a, d, h0 = per_layer[layer[0] % layers]
                layer[0] += 1
                return fn(*args[:4], a, d, h0, lens)
            return call

        times = {}
        for key, fn in (("ms", rot(mamba_selective_scan_cuda)),
                        ("plain_ms", rot(ref.mamba_selective_scan_ref))):
            per_call = time_ms(fn, reps=20 if t > 1 else 100)
            dev = device_ms(fn)
            times[key] = dev if dev is not None else per_call
            times[key + "_per_call"] = per_call
        bd = scan_bound(b, t, i, n)
        ms = times["ms"]
        log(f"  mamba_selective_scan @ {shape} B{b} T{t} I{i} N{n} fp32: "
            f"device time per call: kernel {ms:.5f} ms, plain "
            f"{times['plain_ms']:.5f} ms; CUDA events, back to back (with "
            f"host enqueue) {times['ms_per_call']:.5f} / "
            f"{times['plain_ms_per_call']:.5f} ms; {_bound_text(bd)}, kernel "
            f"at {100 * bd['bound_ms'] / ms:.2f}% of bound; max_abs_err "
            f"{err:.3e} [{CARD}]")
        out[shape] = {"ms": ms, "plain_ms": times["plain_ms"],
                      "ms_events": times["ms_per_call"],
                      "bound_ms": bd["bound_ms"], "bound_by": bd["bound_by"],
                      "max_abs_err": err, "bytes": bd["bytes"],
                      "exp": bd["exp"]}
    # one long prompt: the card runs each call longer than the host takes
    # to enqueue it, so events around back-to-back calls give its rate
    b, t = LONG_SCAN["rows"], LONG_SCAN["prompt_len"]
    args = _scan_case(gen, b, t, i, n, torch.float32)
    ys, hs = mamba_selective_scan_cuda(*args)
    yr, hr = ref.mamba_selective_scan_ref(*args)
    err = max(close(ys, yr, 1e-5)[0], close(hs, hr, 1e-5)[0])
    if not (close(ys, yr, 1e-5)[1] and close(hs, hr, 1e-5)[1]):
        fail(f"mamba_scan at the long shape: err {err}")
    del ys, hs, yr, hr
    fn = lambda: mamba_selective_scan_cuda(*args)
    ms = time_ms(fn, reps=10)
    prof = device_ms(fn, reps=10) or float("nan")
    bd = scan_bound(b, t, i, n)
    log(f"  mamba_selective_scan @ long B{b} T{t} I{i} N{n} fp32: time per "
        f"call, back to back: kernel {ms:.5f} ms (profiler {prof:.5f} ms); "
        f"{_bound_text(bd)}, kernel at {100 * bd['bound_ms'] / ms:.2f}% of "
        f"bound; max_abs_err {err:.3e} [{CARD}]")
    out["long"] = {"ms": ms, "ms_profiler": prof, "bound_ms": bd["bound_ms"],
                   "bound_by": bd["bound_by"], "max_abs_err": err}
    # the record: the decode shape (14 launches every iteration), with
    # the prefill shape (14 per admission bucket) and the long prompt
    # beside it
    dec = out["decode"]
    return {"name": "mamba_selective_scan", "route": "cuda",
            "source": "src/repro_torch/csrc/mamba_scan.cu",
            "replaces": "src/repro/kernels/mamba_scan.py:87", "launches": 0,
            "max_abs_err": max(dec["max_abs_err"],
                               out["prefill"]["max_abs_err"]),
            "ms": dec["ms"], "plain_ms": dec["plain_ms"],
            "bound_ms": dec["bound_ms"], "bound_by": dec["bound_by"],
            "library_ms": None,
            "shape": f"decode B{SCAN_MAIN['rows']} T1 I{i} N{n} fp32",
            "prefill_shape": dict(out["prefill"],
                                  shape=f"B{SCAN_MAIN['rows']} T{plen} I{i} "
                                  f"N{n} fp32"),
            "long_shape": dict(out["long"], shape=f"B{b} T{t} I{i} N{n} "
                               "fp32")}


def bench_main_shapes(gen) -> dict:
    """Kernel vs plain vs library at the serving phase's shapes."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.prefill_attention import prefill_attention_cuda
    dt = torch.bfloat16
    el = 2
    h, kv, d = MAIN["heads"], MAIN["kv_heads"], MAIN["head_dim"]
    s, layers, b = MAIN["cache_len"], MAIN["layers"], MAIN["device_slots"]
    out = {}

    # decode: one call per layer over the stacked cache (G, B, S, KV, D),
    # rotating layers so K/V come from HBM as in a real step
    kc = _randn(gen, (layers, b, s, kv, d), dt, "cuda")
    vc = _randn(gen, (layers, b, s, kv, d), dt, "cuda")
    q = _randn(gen, (b, h, d), dt, "cuda")
    lengths = torch.randint(MAIN["prompt_len"] + 1,
                            MAIN["prompt_len"] + MAIN["output_len"] + 1, (b,),
                            generator=gen, device="cuda", dtype=torch.int32)
    got = decode_attention_cuda(q, kc[0], vc[0], lengths)
    err, ok = close(got, ref.decode_attention_ref(q, kc[0], vc[0], lengths),
                    TOL["decode", "bfloat16"])
    if not ok:
        fail(f"decode at main shape: err {err}")
    layer = [0]

    def rot(fn):
        def call():
            g = layer[0] % layers
            layer[0] += 1
            return fn(kc[g], vc[g])
        return call

    mask = (torch.arange(s, device="cuda")[None, :]
            < lengths[:, None])[:, None, None, :]
    times = _times(
        rot(lambda k, v: decode_attention_cuda(q, k, v, lengths)),
        rot(lambda k, v: ref.decode_attention_ref(q, k, v, lengths)),
        rot(lambda k, v: F.scaled_dot_product_attention(
            q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, enable_gqa=True)))
    n_pos = int(lengths.sum())
    nbytes = 2 * n_pos * kv * d * el + 2 * b * h * d * el + 4 * b
    flops = 4 * n_pos * h * d
    out["decode_attention"] = _record(
        "decode_attention", "src/repro_torch/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention.py:99", err, times, nbytes,
        flops, "bfloat16",
        f"B{b} H{h} KV{kv} D{d} S{s} lengths {lengths.tolist()} bf16")

    # prefill: one admission bucket -- 8 prompts of 128 into a 512 cache
    pb, t = MAIN["requests"], MAIN["prompt_len"]
    q = _randn(gen, (pb, t, h, d), dt, "cuda")
    k = _randn(gen, (pb, s, kv, d), dt, "cuda")
    v = _randn(gen, (pb, s, kv, d), dt, "cuda")
    off = torch.zeros((pb,), dtype=torch.int32, device="cuda")
    got = prefill_attention_cuda(q, k, v, None, off)
    err, ok = close(got, ref.prefill_attention_ref(q, k, v, None, off),
                    TOL["prefill", "bfloat16"])
    if not ok:
        fail(f"prefill at main shape: err {err}")
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    times = _times(
        lambda: prefill_attention_cuda(q, k, v, None, off),
        lambda: ref.prefill_attention_ref(q, k, v, None, off),
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                               enable_gqa=True))
    pairs = pb * t * (t + 1) // 2              # visible (query, key) pairs
    nbytes = 2 * pb * t * h * d * el + 2 * pb * t * kv * d * el
    flops = 4 * pairs * h * d
    out["prefill_attention"] = _record(
        "prefill_attention", "src/repro_torch/csrc/prefill_attention.cu",
        "src/repro/kernels/prefill_attention.py:128", err, times, nbytes,
        flops, "bfloat16",
        f"B{pb} T{t} S{s} H{h} KV{kv} D{d} q_offset 0 bf16")
    return out


def graph_launches(fn, calls: int, kernel: str) -> dict:
    """What ``calls`` calls of ``fn`` put on the stream, by graph node
    type, with launches of ``kernel`` apart: the calls are captured in
    one CUDA graph and its nodes read back from the graph's debug dump,
    which, unlike a profiler trace, drops no record."""
    import collections
    import re
    import torch
    from repro_torch.kernels import build
    fn()                                # one-time set-up outside the graph
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)   # dumpable after capture
    graph.enable_debug_mode()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    path = build.BUILD_DIR / "launch_check.dot"
    graph.debug_dump(str(path))
    # a node is defined at the start of a line ("graph_G_node_N"[...]);
    # an edge's target is followed by a space
    nodes = re.split(r'^"graph_\d+_node_\d+"\[', path.read_text(),
                     flags=re.M)[1:]
    if not nodes:
        fail(f"no node in the CUDA graph's dump {path}")
    kinds = collections.Counter()
    for node in nodes:
        kind = re.search(r'label="\{(\w+)', node)
        kinds["kernel" if kernel in node else
              kind.group(1) if kind else "?"] += 1
    return dict(kinds)


def check_decode_one_launch(gen) -> None:
    """decode_attention_cuda is one kernel launch per call and, once its
    workspace exists, allocates nothing but its output."""
    import torch
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    h, kv, d = MAIN["heads"], MAIN["kv_heads"], MAIN["head_dim"]
    b, s = MAIN["device_slots"], MAIN["cache_len"]
    q, k, v, _ = _decode_case(gen, b, h, kv, d, s, torch.bfloat16)
    lengths = torch.tensor([1, 140, 300, s], dtype=torch.int32, device="cuda")
    decode_attention_cuda(q, k, v, lengths)
    torch.cuda.synchronize()
    calls = 10
    allocs = torch.cuda.memory_stats().get("allocation.all.allocated", 0)
    outs = [decode_attention_cuda(q, k, v, lengths) for _ in range(calls)]
    torch.cuda.synchronize()
    allocs = torch.cuda.memory_stats().get("allocation.all.allocated",
                                           0) - allocs
    kinds = graph_launches(lambda: decode_attention_cuda(q, k, v, lengths),
                           calls, PORT_KERNELS["decode_attention"])
    log(f"  decode_attention_cuda: graph nodes {kinds} and {allocs} "
        f"allocations over {calls} calls (lengths {lengths.tolist()})")
    if kinds != {"kernel": calls}:
        fail(f"decode_attention_cuda put {kinds} on the stream in {calls} "
             "calls; want one launch of its kernel per call")
    if allocs != calls:
        fail(f"decode_attention_cuda made {allocs} allocations in {calls} "
             "calls; want only its outputs")
    if not all(torch.equal(o, outs[0]) for o in outs):
        fail("decode_attention_cuda: repeated calls on one workspace differ")


def bench_long_shapes(gen) -> None:
    """Decode over a long cache (bytes) and a long causal prefill (tensor
    cores), each beside SDPA on the same inputs; printed, not recorded.
    Each call runs longer on the card than the host takes to enqueue it,
    so CUDA events around back-to-back calls give the device's rate;
    the profiler's sum of kernel times is printed beside it."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.prefill_attention import prefill_attention_cuda
    dt, el = torch.bfloat16, 2
    h, kv, d = MAIN["heads"], MAIN["kv_heads"], MAIN["head_dim"]

    b, s = LONG_DECODE["rows"], LONG_DECODE["cache_len"]
    q, k, v, _ = _decode_case(gen, b, h, kv, d, s, dt)
    lengths = torch.randint(LONG_DECODE["min_len"], s + 1, (b,),
                            generator=gen, device="cuda", dtype=torch.int32)
    err, ok = close(decode_attention_cuda(q, k, v, lengths),
                    ref.decode_attention_ref(q, k, v, lengths),
                    TOL["decode", "bfloat16"])
    if not ok:
        fail(f"decode at the long shape: err {err}")
    mask = (torch.arange(s, device="cuda")[None, :]
            < lengths[:, None])[:, None, None, :]
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    times = {}
    for key, fn in (("ms", lambda: decode_attention_cuda(q, k, v, lengths)),
                    ("sdpa", lambda: F.scaled_dot_product_attention(
                        q[:, :, None], kt, vt, attn_mask=mask,
                        enable_gqa=True))):
        times[key] = time_ms(fn)
        times[key + "_profiler"] = device_ms(fn) or float("nan")
    nbytes = 2 * int(lengths.sum()) * kv * d * el + 2 * b * h * d * el + 4 * b
    bound = nbytes / PEAK_BYTES_PER_S * 1e3
    log(f"  decode_attention @ long B{b} H{h} KV{kv} D{d} S{s} lengths "
        f"{lengths.tolist()} bf16: time per call, back to back: kernel "
        f"{times['ms']:.5f} ms, sdpa {times['sdpa']:.5f} ms (profiler: "
        f"{times['ms_profiler']:.5f} / {times['sdpa_profiler']:.5f} ms); "
        f"bound {bound:.5f} ms (bytes: {nbytes} B), kernel at "
        f"{100 * bound / times['ms']:.2f}% of bound; max_abs_err {err:.3e} "
        f"[{CARD}]")
    del q, k, v, kt, vt

    b, t = LONG_PREFILL["rows"], LONG_PREFILL["prompt_len"]
    q = _randn(gen, (b, t, h, d), dt, "cuda")
    k = _randn(gen, (b, t, kv, d), dt, "cuda")
    v = _randn(gen, (b, t, kv, d), dt, "cuda")
    out = prefill_attention_cuda(q, k, v)
    tail = 256                  # the plain version on the last queries
    off = torch.full((b,), t - tail, dtype=torch.int32, device="cuda")
    err, ok = close(out[:, -tail:],
                    ref.prefill_attention_ref(q[:, -tail:], k, v, None, off),
                    TOL["prefill", "bfloat16"])
    if not ok:
        fail(f"prefill at the long shape: err {err}")
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    times = {}
    for key, fn in (("ms", lambda: prefill_attention_cuda(q, k, v)),
                    ("sdpa", lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=True, enable_gqa=True))):
        times[key] = time_ms(fn, reps=10)
        times[key + "_profiler"] = device_ms(fn, reps=10) or float("nan")
    flops = 4 * b * t * (t + 1) // 2 * h * d
    bound = flops / PEAK_FLOPS["bfloat16"] * 1e3
    log(f"  prefill_attention @ long B{b} T{t} S{t} H{h} KV{kv} D{d} bf16: "
        f"time per call, back to back: kernel {times['ms']:.5f} ms, sdpa "
        f"{times['sdpa']:.5f} ms (profiler: {times['ms_profiler']:.5f} / "
        f"{times['sdpa_profiler']:.5f} ms); bound {bound:.5f} ms "
        f"(operations: {flops} flop), kernel at "
        f"{100 * bound / times['ms']:.2f}% of bound, sdpa at "
        f"{100 * bound / times['sdpa']:.2f}%; max_abs_err {err:.3e} (last "
        f"{tail} queries) [{CARD}]")


def _times(kernel, plain, library) -> dict:
    """Device time per call of the kernel, its plain version and the
    library call (profiler; event-timed calls where it reports nothing),
    and their event-timed per-call times with host enqueue."""
    out = {}
    for key, fn in (("ms", kernel), ("plain_ms", plain),
                    ("library_ms", library)):
        per_call = time_ms(fn)
        dev = device_ms(fn)
        if dev is None:
            log(f"  {key}: the profiler reported no device time; using "
                "the event-timed per-call time")
        out[key] = dev if dev is not None else per_call
        out[key + "_per_call"] = per_call
    return out


def _record(name, source, replaces, err, times, nbytes, flops, dt,
            shape) -> dict:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dt] * 1e3
    bound = max(t_bytes, t_ops)
    by = "bytes" if t_bytes >= t_ops else "operations"
    ms = times["ms"]
    log(f"  {name} @ {shape}: device time per call: kernel {ms:.5f} ms, "
        f"plain {times['plain_ms']:.5f} ms, sdpa {times['library_ms']:.5f} "
        f"ms; with host enqueue: {times['ms_per_call']:.5f} / "
        f"{times['plain_ms_per_call']:.5f} / "
        f"{times['library_ms_per_call']:.5f} ms; bound {bound:.5f} ms "
        f"({by}: {nbytes} B, {flops} flop), kernel at "
        f"{100 * bound / ms:.2f}% of bound; max_abs_err {err:.3e} [{CARD}]")
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": 0, "max_abs_err": err,
            "ms": ms, "plain_ms": times["plain_ms"], "bound_ms": bound,
            "bound_by": by, "library_ms": times["library_ms"]}


def phase_kernels() -> dict:
    import torch
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    logs = build.build()
    log(f"built {', '.join(build.KERNELS)} with nvcc in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  [{name}] {line.strip()}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    check_sweeps(gen)
    check_chunk_split_bitwise(gen)
    check_scan(gen)
    torch.cuda.synchronize()
    check_decode_one_launch(gen)
    check_scan_one_launch(gen)
    records = bench_main_shapes(gen)
    bench_long_shapes(gen)
    records["mamba_selective_scan"] = bench_scan(gen)
    return records


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------


def hybrid_config(**kw):
    """Jamba-1.5-Large with dense FFNs (the MoE FFN is not ported)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.config import FFNKind
    return dataclasses.replace(get_config("jamba-1.5-large-398b"),
                               ffn_kind=FFNKind.DENSE, moe=None, **kw)


def _exactness(cfg) -> None:
    """Raw prefill+decode, an engine device row and a host-offloaded row
    give identical greedy tokens (fp32 model, bf16 KV cache).  Seeds are
    scanned until every top-2 logit gap exceeds 1e-3."""
    import torch
    from repro_torch.models import (decode_step, init_decode_state,
                                    init_params, prefill)
    from repro_torch.serving import InferenceServer, Request, ServerConfig
    prompt = [5, 42, 7, 1, 99, 3, 17, 56]
    n_new = 8
    for seed in range(16):
        params = init_params(cfg, seed=seed, device="cuda")
        state = init_decode_state(cfg, device_batch=1, cache_len=64,
                                  device="cuda")
        logits, state = prefill(params, cfg, {"tokens": torch.tensor(
            [prompt], device="cuda")}, state)
        toks, gaps = [], []
        for i in range(n_new):
            top2 = torch.topk(logits[0].float(), 2).values
            gaps.append(float(top2[0] - top2[1]))
            toks.append(int(logits[0].argmax()))
            if i + 1 < n_new:
                logits, state, _, _ = decode_step(
                    params, cfg, torch.tensor([toks[-1]], device="cuda"),
                    state)
        if min(gaps) > 1e-3:
            break
        log(f"  seed {seed}: smallest top-2 gap {min(gaps):.2e} <= 1e-3, "
            "next seed")
    else:
        fail("no seed in 0..15 has every top-2 logit gap above 1e-3")
    with InferenceServer(cfg, params, ServerConfig(
            device_slots=1, host_slots=2, cache_len=64)) as server:
        h1 = server.submit(Request(prompt=list(prompt), max_new_tokens=n_new))
        h2 = server.submit(list(prompt), max_new_tokens=n_new)
        host_stream = list(h2.tokens())
        server.run_until_idle()
        stats = server.stats
    log(f"  {cfg.name} fp32 seed {seed}: raw {toks}")
    log(f"  device row {h1.output}; host row {host_stream} "
        f"(host tokens {stats.host_tokens}); smallest top-2 gap "
        f"{min(gaps):.3e}")
    if stats.host_tokens == 0:
        fail("the exactness run never offloaded")
    if not (h1.output == toks and host_stream == toks):
        fail("device, host-offloaded and raw greedy tokens differ")


def phase_exactness() -> None:
    """llama3.1-8b and the dense-FFN Jamba hybrid (16 layers, attention
    at 3 and 11), each reduced to d_model 256 in fp32."""
    import dataclasses
    from repro_torch.configs import get_config
    fp32 = dict(param_dtype="float32", compute_dtype="float32")
    _exactness(dataclasses.replace(
        get_config("llama3.1-8b").reduced(layers=4, d_model=256, vocab=512),
        **fp32))
    _exactness(dataclasses.replace(
        hybrid_config().reduced(d_model=256, vocab=512), **fp32))


# ---------------------------------------------------------------------------
# phase 4
# ---------------------------------------------------------------------------


def _serve_once(cfg, params, scfg, prompts, output_len):
    import torch
    from repro_torch.serving import InferenceServer, Request
    from repro_torch.serving.engine import Engine
    nan = torch.zeros((), dtype=torch.bool, device="cuda")
    commit, prefill = Engine._commit_device, Engine.prefill
    buckets = [0]

    def commit_checked(self, logits, rows):       # device-side flag, no sync
        nan.logical_or_(torch.isnan(logits).any())
        return commit(self, logits, rows)

    def prefill_checked(self, tokens, plens):
        buckets[0] += 1
        logits, sub = prefill(self, tokens, plens)
        nan.logical_or_(torch.isnan(logits).any())
        return logits, sub

    Engine._commit_device, Engine.prefill = commit_checked, prefill_checked
    try:
        with InferenceServer(cfg, params, scfg) as server:
            reqs = [Request(prompt=list(p), max_new_tokens=output_len)
                    for p in prompts]
            t0 = time.perf_counter()
            for r in reqs:
                server.submit(r)
            stats = server.run_until_idle()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        Engine._commit_device, Engine.prefill = commit, prefill
    return reqs, stats, wall, bool(nan), buckets[0]


def _traced_window(cfg, params, scfg, prompts, output_len, iters):
    """A separate traced run: ``iters`` engine iterations in steady decode
    under ``torch.profiler``.  Returns (device-busy share of the wall
    time, wall ms per iteration, device ms per iteration by kernel, and
    (ms per iteration, calls per iteration, op, input shapes) of every
    PyTorch op by the device time of the kernels it launched itself, over
    a few more iterations traced on the host too).  Kernels on the
    executor's copy stream may overlap others, so the share is an upper
    bound."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving import InferenceServer, Request
    with InferenceServer(cfg, params, scfg) as server:
        for p in prompts:
            server.submit(Request(prompt=list(p), max_new_tokens=output_len))
        for _ in range(3):                    # admission + first decodes
            server.step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            t0 = time.perf_counter()
            for _ in range(iters):
                server.step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        attributed = 4
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     record_shapes=True) as by_op:
            for _ in range(attributed):
                server.step()
            torch.cuda.synchronize()
    ops = []
    for ev in by_op.key_averages(group_by_input_shape=True):
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        if us > 0 and ev.key.startswith("aten::"):
            ops.append((us / attributed / 1e3, ev.count // attributed,
                        ev.key, ev.input_shapes))
    per_kernel = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        if us > 0:
            per_kernel[ev.key] = per_kernel.get(ev.key, 0.0) + us / iters / 1e3
    busy = sum(per_kernel.values()) * iters / 1e3
    return busy / wall, 1e3 * wall / iters, per_kernel, sorted(ops,
                                                                reverse=True)


def _kernel_wrappers() -> dict:
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.mamba_scan import mamba_selective_scan_cuda
    from repro_torch.kernels.prefill_attention import prefill_attention_cuda
    return {"decode_attention": decode_attention_cuda,
            "prefill_attention": prefill_attention_cuda,
            "mamba_selective_scan": mamba_selective_scan_cuda}


def _serve_published(cfg, traced_iters: int) -> dict:
    """Serve MAIN's traffic on ``cfg`` (random bf16 weights, seed 0)
    through InferenceServer; print the end-to-end numbers and fail on a
    wrong run.  Returns each kernel's launches over the measured run."""
    import numpy as np
    import torch
    from repro_torch.core.scheduler import StrategyKind
    from repro_torch.models import init_params
    from repro_torch.models.config import BlockKind
    from repro_torch.serving import ServerConfig
    log(f"  {cfg.name}: d_model {cfg.d_model}, heads {cfg.num_heads}/"
        f"{cfg.num_kv_heads}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
        f"{cfg.num_layers} layers (attention at {cfg.attn_layer_indices}), "
        f"{cfg.param_dtype}, {cfg.param_count() / 1e9:.2f} B parameters")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"  random weights from torch.Generator(seed 0) in "
        f"{time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    plen, out_len = MAIN["prompt_len"], MAIN["output_len"]
    page_size = 32
    # one resident's pages over every attention layer
    pages_per_resident = (-(-(plen + out_len) // page_size)) \
        * cfg.num_attn_layers
    scfg = ServerConfig(device_slots=MAIN["device_slots"],
                        host_slots=MAIN["host_slots"],
                        cache_len=MAIN["cache_len"], page_size=page_size,
                        host_pool_pages=pages_per_resident
                        * MAIN["host_slots"], device="cuda")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, plen).tolist()
               for _ in range(MAIN["requests"])]
    # warm-up: one short request through its own server (cuBLAS handles,
    # first launches); not part of the measured run
    _serve_once(cfg, params, scfg, prompts[:1], 2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wrappers = _kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    reqs, stats, wall, saw_nan, buckets = _serve_once(cfg, params, scfg,
                                                      prompts, out_len)
    launches = {name: fn.launches for name, fn in wrappers.items()}
    pool_bytes = scfg.host_pool_pages * page_size * cfg.num_kv_heads \
        * cfg.resolved_head_dim * 4 * 2
    log(f"  {len(reqs)} requests x prompt {plen} -> {out_len} tokens in "
        f"{wall:.3f} s wall: {stats.iterations} iterations "
        f"({stats.iterations / wall:.2f} decode iters/s), "
        f"{(stats.device_tokens + stats.host_tokens) / wall:.2f} output "
        f"tokens/s (device {stats.device_tokens}, host {stats.host_tokens} "
        f"decoded; prefill emits the first token of each)")
    log(f"  TTFT p50 {stats.ttft_p50 * 1e3:.1f} ms, p95 "
        f"{stats.ttft_p95 * 1e3:.1f} ms; ITL p50 "
        f"{(stats.itl_p50 or 0) * 1e3:.1f} ms; host busy "
        f"{stats.host_busy_time:.3f} s (transfer "
        f"{stats.host_transfer_time:.3f} s); strategies "
        f"{stats.strategy_counts}")
    log(f"  launches {launches} over {buckets} admission bucket(s); host "
        f"pool {scfg.host_pool_pages} pages = {pool_bytes / 2**20:.0f} MiB; "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        " GiB")
    share, ms_iter, per_kernel, ops = _traced_window(
        cfg, params, scfg, prompts, out_len, traced_iters)
    log(f"  traced window ({traced_iters} iterations, separate run): "
        f"{ms_iter:.2f} ms per iteration, device busy {100 * share:.1f}% of "
        f"wall (idle {100 * (1 - share):.1f}%); top kernels by device time:")
    for key, ms in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]:
        log(f"    {ms:8.3f} ms/iter  {key[:100]}")
    port = {name: sum(ms for key, ms in per_kernel.items() if tag in key)
            for name, tag in PORT_KERNELS.items()}
    log("  the port's kernels, device ms per iteration: "
        + ", ".join(f"{name} {ms:.4f}" for name, ms in port.items()))
    log("  PyTorch ops by the device time of their own kernels (4 more "
        "iterations, traced on the host too); the top ones, then the "
        "copies:")
    copies = [o for o in ops if o[2] == "aten::copy_"]
    for ms, count, key, shapes in ops[:8] + copies[:6]:
        log(f"    {ms:8.3f} ms/iter  {count:4d} calls/iter  {key} "
            f"{str(shapes)[:110]}")
    bad = [r.request_id for r in reqs
           if r.failed or len(r.output) != out_len]
    if bad:
        fail(f"requests {bad} did not finish with {out_len} tokens")
    if saw_nan:
        fail("a logit was NaN")
    if stats.host_tokens <= 0:
        fail("no token was decoded on the host tier")
    hybrid = sum(n for k, n in stats.strategy_counts.items()
                 if k != StrategyKind.GPU_ONLY.value)
    if hybrid < 1:
        fail(f"Algorithm 1 took no hybrid decision: {stats.strategy_counts}")
    device_iters = max(len(r.output) - 1 for r in reqs if r.tier == "device")
    n_attn = cfg.num_attn_layers
    n_mamba = sum(k == BlockKind.MAMBA
                  for k in cfg.block_pattern) * cfg.num_groups
    need = {"decode_attention": n_attn * device_iters,
            "prefill_attention": n_attn * buckets,
            "mamba_selective_scan": n_mamba * (device_iters + buckets)}
    for name, n in need.items():
        if launches[name] < n:
            fail(f"{name} launched {launches[name]} times; the path needs "
                 f"at least {n} ({device_iters} device-row iterations, "
                 f"{buckets} admission buckets)")
    return launches


def phase_serving() -> dict:
    from repro_torch.configs import get_config
    return _serve_published(get_config("llama3.1-8b"), traced_iters=40)


def phase_serving_hybrid() -> dict:
    """Jamba-1.5-Large at published width with dense FFNs (the MoE FFN
    is not ported; with experts one 8-layer period alone is 90 GB in
    bf16), depth cut to 2 periods: 14 Mamba + 2 attention layers."""
    return _serve_published(hybrid_config(num_layers=16), traced_iters=24)


# ---------------------------------------------------------------------------
# phase 5
# ---------------------------------------------------------------------------


def phase_cli() -> None:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve"],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=600)
    for line in proc.stdout.strip().splitlines()[-6:]:
        log(f"  | {line}")
    if proc.returncode != 0:
        log(proc.stderr[-3000:])
        fail(f"python -m repro_torch.launch.serve exited {proc.returncode}")
    log(f"  launch.serve with its defaults: exit 0 in "
        f"{time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

PHASES = ("env", "kernels", "exactness", "serving", "serving-hybrid", "cli")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma list out of {PHASES}")
    args = ap.parse_args()
    phases = args.phases.split(",")
    import torch
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device visible to torch", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"FAIL: the repro_torch package is not beside this script "
              f"({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("== environment")
    env = phase_env()
    records = {}
    if "kernels" in phases:
        log("== kernels against their plain versions")
        records = phase_kernels()
    if "exactness" in phases:
        log("== exactness at a reduced size")
        phase_exactness()
    launches = {}       # path -> kernel -> launches over its measured run
    if "serving" in phases:
        log("== serving llama3.1-8b at published width")
        launches["serving"] = phase_serving()
    if "serving-hybrid" in phases:
        log("== serving Jamba-1.5-Large (dense FFN, 16 layers) at published "
            "width")
        launches["serving-hybrid"] = phase_serving_hybrid()
    if "cli" in phases:
        log("== python -m repro_torch.launch.serve")
        phase_cli()
    if records and launches:
        for name, rec in records.items():
            by_path = {path: counts[name]
                       for path, counts in launches.items()}
            rec["launches"] = sum(by_path.values())
            rec["launches_by_path"] = by_path
        print(json.dumps({"kernels": list(records.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": env["name"],
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
