#!/usr/bin/env python3
"""Time design variants of the four redesigned xLSTM kernels on one GPU.

    python3 tools/xlstm_variants.py [--baseline DIR]
        [--only slstm|mlstm|mlstm_fwd|slstm_bwd]

Each variant is ``src/repro_torch/csrc/slstm_scan.cu``,
``mlstm_scan_bwd.cu``, ``mlstm_scan.cu`` or ``slstm_scan_bwd.cu`` built
with some of its design switches set by ``-D`` (the sources'
``APEX_SLSTM_*`` / ``APEX_MLSTM_BWD_*`` / ``APEX_MLSTM_FWD_*`` /
``APEX_SLSTM_BWD_*`` macros), with the flags of
``repro_torch.kernels.build``, into
``src/repro_torch/_build/variants/`` (one nvcc per variant, all at once),
and called through the port's own wrapper with its library swapped in
(``build.load`` patched, so the wrapper sets the library's argtypes).

  sLSTM forward (xlstm-125m: 4 heads of 192, bf16 R), at decode (B 2,
    T 1), the chat chunk (B 2, T 64) and the train shape (B 2, T 1024,
    saving what the backward reads): the h exchange (a cluster barrier a
    step, as first written, or mbarriers fed by st.async), the cell's
    lanes (all alike, as first written, or with roles), R's load (strided
    from device memory, as first written, staged through shared memory,
    or read from a copy packed in the threads' order, which this tool
    makes) and a cluster of 4 or 8 CTAs.  Every variant must give the
    as-built kernel's bits.
  mLSTM backward (4 heads of 384, fp32), at the train shape (B 2,
    T 1024): chunks of 32, 64 or 128 steps, products in 3xTF32 on tensor
    cores or on fp32 FMAs.
  mLSTM forward's chunkwise route (mlstm_fwd; 4 heads of 384), at the
    train shape (B 2, T 1024) and the long call (B 1, T 4096): chunks of
    32, 64 or 128 steps, 3xTF32 or FMAs, each part's time by the
    profiler; then the route crossover: the walk (crossover past every
    T) against the chunkwise route (crossover 1) at B 2 and T from 4 to
    128, and the first T where the chunkwise route wins.
  sLSTM backward (slstm_bwd; 4 heads of 192, bf16 R), at the train shape
    (B 2, T 1024): the exchange (a cluster barrier a step, or mbarriers
    fed by st.async), a cluster of 4 or 8 CTAs, and the recurrent
    product reduce-scattered (partial dh sums to each unit's owner) or
    with dpre broadcast (every CTA sums over all 4 hd columns for its
    own units); the two exchanges of one cluster and product give the
    same bits.

``--baseline DIR`` adds the sources found in DIR (e.g. the parent
commit's ``src/repro_torch/csrc``, unpacked with ``git archive`` into a
git-ignored directory) as one more variant each: an older sLSTM (forward
or backward) has the same C interface; the older mLSTM forward (the
walk alone) is called through its C function; the older mLSTM backward
(the step-wise reverse walk
with checkpoints, its last source before the chunkwise form) is called
through its own interface, once with its ~680 MB of scratch allocated
every call as its wrapper did and once with the scratch allocated before
the loop (a chunkwise backward is called through the port's wrapper).
Every variant prints its kernels' registers and spills, its
largest error against the plain version relative to the largest value,
and its time per call: the kernels' device time by the profiler and, for
the long calls, by CUDA events, in two rounds in opposite orders.
Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

P, I = ctypes.c_void_p, ctypes.c_int
SLSTM = {
    # name: the APEX_SLSTM_* switches
    "barrier, alike, strided R, 4 (first design)": dict(
        EXCHANGE=0, ROLES=0, STAGE_R=0, CLUSTER=4),
    "barrier, roles, staged R, 4": dict(EXCHANGE=0, ROLES=1, STAGE_R=1,
                                        CLUSTER=4),
    "mbarrier, alike, strided R, 4": dict(EXCHANGE=1, ROLES=0, STAGE_R=0,
                                          CLUSTER=4),
    "mbarrier, alike, staged R, 4": dict(EXCHANGE=1, ROLES=0, STAGE_R=1,
                                         CLUSTER=4),
    "mbarrier, roles, staged R, 4": dict(EXCHANGE=1, ROLES=1, STAGE_R=1,
                                         CLUSTER=4),
    "barrier, roles, staged R, 8": dict(EXCHANGE=0, ROLES=1, STAGE_R=1,
                                        CLUSTER=8),
    "mbarrier, alike, staged R, 8": dict(EXCHANGE=1, ROLES=0, STAGE_R=1,
                                         CLUSTER=8),
    "mbarrier, roles, staged R, 8": dict(EXCHANGE=1, ROLES=1, STAGE_R=1,
                                         CLUSTER=8),
    "mbarrier, alike, packed R, 4": dict(EXCHANGE=1, ROLES=0, STAGE_R=2,
                                         CLUSTER=4),
    "mbarrier, alike, packed R, 8": dict(EXCHANGE=1, ROLES=0, STAGE_R=2,
                                         CLUSTER=8),
}
MLSTM = {f"L {ch}, {'3xTF32' if tc else 'FMA'}": dict(CHUNK=ch, TF32X3=tc)
         for ch in (32, 64, 128) for tc in (1, 0)}
MLSTM_FWD = {f"L {ch}, {'3xTF32' if tc else 'FMA'}": dict(CHUNK=ch,
                                                            TF32X3=tc)
             for ch in (32, 64, 128) for tc in (1, 0)}
# the route crossover's two ends: every call on the walk, every call
# without lens chunkwise
MLSTM_FWD.update({"walk at every T": dict(CROSSOVER=1 << 30),
                  "chunkwise at every T": dict(CROSSOVER=1)})
SLSTM_BWD = {f"{'mbarrier' if ex else 'barrier'}, {cl}, "
             f"{'dpre broadcast' if bc else 'reduce-scatter'}":
             dict(EXCHANGE=ex, CLUSTER=cl, BROADCAST=bc)
             for bc in (0, 1) for cl in (4, 8) for ex in (0, 1)}
SOURCES = {"slstm": ("slstm_scan", "APEX_SLSTM_", SLSTM),
           "mlstm": ("mlstm_scan_bwd", "APEX_MLSTM_BWD_", MLSTM),
           "mlstm_fwd": ("mlstm_scan", "APEX_MLSTM_FWD_", MLSTM_FWD),
           "slstm_bwd": ("slstm_scan_bwd", "APEX_SLSTM_BWD_", SLSTM_BWD)}


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def defaults(src: str, prefix: str) -> dict:
    """The switches' values as the source sets them (the as-built kernel)."""
    return {m.group(1): int(m.group(2)) for m in re.finditer(
        rf"#define {prefix}(\w+) (\d+)", src)}


def build_variants(kinds, baseline):
    """(kind, name) -> library path; marks the as-built variant and prints
    each build's registers and spills."""
    from repro_torch.kernels import build
    out = build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    procs, built = {}, {}
    for kind in kinds:
        src, prefix, table = SOURCES[kind]
        path = build.CSRC_DIR / f"{src}.cu"
        as_built = defaults(path.read_text(), prefix)
        jobs = {}
        for name, flags in table.items():
            mark = " [as built]" if all(as_built.get(k) == v for k, v in
                                        flags.items()) else ""
            jobs[name + mark] = (path, [f"-D{prefix}{k}={v}"
                                        for k, v in flags.items()])
        if baseline:
            jobs["older source (baseline)"] = (Path(baseline) / f"{src}.cu",
                                               [])
        for name, (cu, flags) in jobs.items():
            so = out / f"{kind}{len(procs)}.so"
            procs[(kind, name)] = (so, subprocess.Popen(
                [build.nvcc_path(), *build.NVCC_FLAGS, *flags, "-o", str(so),
                 str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    for (kind, name), (so, proc) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{text[-3000:]}")
        regs = re.findall(r"Used (\d+) registers", text)
        spills = re.findall(r"(\d+) bytes spill stores", text)
        print(f"  [{kind}: {name}] registers {'/'.join(regs)}, spill stores "
              f"{'/'.join(spills)} B", flush=True)
        built[(kind, name)] = so
    return built


def events(fn, reps=5, rounds=3) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def device_split(fn, reps, key) -> dict:
    """The device time a call of each kernel whose name holds ``key``, by
    the profiler (ms, by the kernel's name up to its parameters)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {re.split(r"[<(]", e.key.replace("(anonymous namespace)::", "")
                     )[0].split()[-1]: e.device_time_total / 1e3 / reps
            for e in prof.key_averages() if key in e.key}


def device_ms(fn, reps, key) -> float:
    """The device time a call of the kernels whose names hold ``key``."""
    return sum(device_split(fn, reps, key).values())


def rel(got, want) -> float:
    return max(float((g.float().reshape(w.shape) - w.float()).abs().max())
               / max(float(w.float().abs().max()), 1e-12)
               for g, w in zip(got, want))


def pack_r(r, cluster: int):
    """R (H, hd, 4 hd) in the order of APEX_SLSTM_STAGE_R 2's threads:
    [head][cta][input i][thread], thread = 8 unit + 2 gate + half, which
    reads input half * hd/2 + i of column gate * hd + cta * U + unit."""
    import torch
    hd = r.shape[1]
    units = hd // cluster
    dev = r.device
    cta = torch.arange(cluster, device=dev)[:, None, None]
    i = torch.arange(hd // 2, device=dev)[None, :, None]
    tid = torch.arange(8 * units, device=dev)[None, None, :]
    row = (tid % 2) * (hd // 2) + i
    col = (tid // 2) % 4 * hd + cta * units + tid // 8
    return r[:, row, col].contiguous().reshape(r.shape)


def slstm(libs) -> None:
    import torch
    from repro_torch.kernels import build, ref, xlstm
    names = [n for (k, n) in libs if k == "slstm"]
    loaded = {n: ctypes.CDLL(str(libs[("slstm", n)])) for n in names}
    gen = torch.Generator(device="cuda").manual_seed(0)
    rn = lambda *s: torch.randn(s, generator=gen, device="cuda")
    nh, hd = 4, 192
    saved = build.load
    try:
        for label, b, t in (("decode", 2, 1), ("chat chunk", 2, 64),
                            ("train", 2, 1024)):
            d = nh * hd
            args = [rn(b, t, 4 * d),
                    (rn(nh, hd, 4 * hd) / hd ** 0.5).to(torch.bfloat16),
                    0.1 * rn(4 * d), rn(b, nh, hd),
                    1.0 + rn(b, nh, hd).abs(), rn(b, nh, hd), rn(b, nh, hd)]
            save = t > 64
            want = ref.slstm_recurrence_ref(*args, save=save)
            outs, res = {}, {n: [] for n in names}

            flags = {n: SLSTM.get(n.replace(" [as built]", ""), {})
                     for n in names}
            packed = {c: pack_r(args[1], c) for c in (4, 8)}

            def call(n):
                build.load = lambda name, n=n: loaded[n]
                r = packed[flags[n]["CLUSTER"]] \
                    if flags[n].get("STAGE_R") == 2 else args[1]
                return xlstm.slstm_scan_cuda(args[0], r, *args[2:],
                                             save=save)
            for n in names:
                outs[n] = call(n)
            ref_name = next((n for n in names if "as built" in n), names[0])
            for order in (names, names[::-1]):
                for n in order:
                    res[n].append(device_ms(lambda: call(n), 20 if t < 1024
                                            else 5, "slstm_scan_kernel"))
            for n in names:
                same = all(torch.equal(a, c) for a, c in
                           zip(outs[n], outs[ref_name]))
                us = [1e3 * x / t for x in res[n]]
                print(f"  sLSTM {label} B{b} T{t} [{n}]: {res[n][0]:.5f} / "
                      f"{res[n][1]:.5f} ms ({us[0]:.3f} / {us[1]:.3f} us a "
                      f"step), err {rel(outs[n], want):.3e}, bits of the "
                      f"as-built {same}", flush=True)
            del args, want, outs
    finally:
        build.load = saved


def _old_mlstm_call(lib, args, hs, dhs, dstate, prealloc):
    """The step-wise mLSTM backward through its own C interface (its
    wrapper's scratch: checkpoints, stash, per-slab partials)."""
    import torch
    fn = lib.apex_mlstm_scan_bwd
    fn.argtypes = [P] * 13 + [P] * 6 + [P] * 8 + [I] * 4 + [P]
    fn.restype = I
    q = args[0]
    b, t, nh, hd = q.shape
    chunk, slabs = lib.apex_mlstm_scan_bwd_chunk(), \
        hd // lib.apex_mlstm_scan_bwd_rows()
    nck = -(-t // chunk)
    f32 = dict(dtype=torch.float32, device=q.device)

    def scratch():
        return [torch.empty((b, nh, nck, hd, hd), **f32),
                torch.empty((b, nh, slabs, nck, hd + 4), **f32),
                torch.empty((b, nh, slabs, chunk, hd * hd // slabs), **f32),
                torch.empty((2, slabs, b, t, nh, hd), **f32),
                torch.empty((b, nh, t, slabs, 2), **f32),
                torch.empty((b, nh, t, 2), **f32)]
    fixed = scratch() if prealloc else None
    if prealloc:
        print(f"  mLSTM backward B{b} T{t} H{nh} hd{hd} [step-wise walk]: "
              f"scratch {sum(x.numel() for x in fixed) * 4 / 1e6:.1f} MB",
              flush=True)

    def call():
        sc = fixed if prealloc else scratch()
        outs = [torch.empty_like(x) for x in args]
        rc = fn(*(x.data_ptr() for x in args), hs.data_ptr(), dhs.data_ptr(),
                *(x.data_ptr() for x in dstate), *(x.data_ptr() for x in sc),
                *(x.data_ptr() for x in outs), b, t, nh, hd,
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"cudaError {rc}")
        return outs
    return call


def mlstm(libs) -> None:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import build, ref, xlstm
    names = [n for (k, n) in libs if k == "mlstm"]
    loaded = {n: ctypes.CDLL(str(libs[("mlstm", n)])) for n in names}
    gen = torch.Generator(device="cuda").manual_seed(0)
    rn = lambda *s: torch.randn(s, generator=gen, device="cuda")
    b, t, nh, hd = 2, 1024, 4, 384
    args = [rn(b, t, nh, hd), rn(b, t, nh, hd) / hd ** 0.5, rn(b, t, nh, hd),
            rn(b, t, nh), F.logsigmoid(rn(b, t, nh) + 2.0),
            0.3 * rn(b, nh, hd, hd), 0.3 * rn(b, nh, hd), rn(b, nh)]
    hs = xlstm.mlstm_scan_cuda(*args)[0]
    dhs = rn(b, t, nh, hd)
    dstate = (rn(b, nh, hd, hd), rn(b, nh, hd), rn(b, nh))
    want = ref.mlstm_recurrence_bwd_ref(*args, hs, dhs, dstate)
    calls = {}
    saved = build.load
    for n in names:
        if "baseline" in n and hasattr(loaded[n], "apex_mlstm_scan_bwd_rows"):
            calls[n + ", scratch allocated a call"] = _old_mlstm_call(
                loaded[n], args, hs, dhs, dstate, False)
            calls[n + ", scratch allocated once"] = _old_mlstm_call(
                loaded[n], args, hs, dhs, dstate, True)
        else:
            lib = loaded[n]
            lib.apex_mlstm_scan_bwd_scratch_floats.argtypes = [I] * 4
            lib.apex_mlstm_scan_bwd_scratch_floats.restype = \
                ctypes.c_longlong
            ch = lib.apex_mlstm_scan_bwd_chunk()
            # the chunkwise form's products, 2 flops a multiply-add: per
            # step 4 (hd + 1) hd (boundaries, carried gradients, dq's and
            # dk's state terms), hd^2 (dv's) and 5 L hd (the masked ones)
            flops = 2.0 * b * t * nh * (4 * (hd + 1) * hd + hd * hd
                                        + 5 * ch * hd)
            mb = lib.apex_mlstm_scan_bwd_scratch_floats(b, t, nh, hd) * 4e-6
            print(f"  mLSTM backward B{b} T{t} H{nh} hd{hd} [{n}]: scratch "
                  f"{mb:.1f} MB; products {flops / 1e9:.3f} Gflop, "
                  f"{flops / 67e12 * 1e3:.5f} ms at 67 TFLOP/s fp32",
                  flush=True)

            def call(n=n):
                build.load = lambda name, n=n: loaded[n] \
                    if name == "mlstm_scan_bwd" else saved(name)
                return xlstm.mlstm_scan_bwd_cuda(*args, hs, dhs, dstate)
            calls[n] = call
    try:
        res = {n: [] for n in calls}
        errs, base = {}, None
        for n, c in reversed(calls.items()):   # the baseline's first
            got = c()
            again = c()
            torch.cuda.synchronize()
            if "baseline" in n and base is None:
                base = got
            errs[n] = (rel(got, want),
                       all(torch.equal(a, g) for a, g in zip(again, got)),
                       base is not None and all(
                           torch.equal(a, g) for a, g in zip(base, got)))
            del got, again
        del base
        for order in (list(calls), list(calls)[::-1]):
            for n in order:
                res[n].append((events(calls[n]),
                               device_ms(calls[n], 3, "mlstm_bwd")))
        for n, ((e1, k1), (e2, k2)) in res.items():
            split = device_split(calls[n], 3, "mlstm_bwd")
            print(f"  mLSTM backward B{b} T{t} H{nh} hd{hd} [{n}]: events "
                  f"{e1:.5f} / {e2:.5f} ms, kernels {k1:.5f} / {k2:.5f} ms "
                  "(" + ", ".join(f"{k} {v:.5f}" for k, v in split.items())
                  + f"), err {errs[n][0]:.3e}, repeat bitwise {errs[n][1]}"
                  f", the baseline's bits {errs[n][2]}", flush=True)
    finally:
        build.load = saved


def _mlstm_args(gen, b, t, nh=4, hd=384):
    import torch
    import torch.nn.functional as F
    rn = lambda *s: torch.randn(s, generator=gen, device="cuda")
    return [rn(b, t, nh, hd), rn(b, t, nh, hd) / hd ** 0.5, rn(b, t, nh, hd),
            rn(b, t, nh), F.logsigmoid(rn(b, t, nh) + 2.0),
            0.3 * rn(b, nh, hd, hd), 0.3 * rn(b, nh, hd), rn(b, nh)]


def _walk_call(lib, args):
    """An older mLSTM forward (the walk alone) through its C function."""
    import torch
    fn = lib.apex_mlstm_scan
    fn.argtypes = [P] * 9 + [P] * 4 + [I] * 4 + [P]
    fn.restype = I
    b, t, nh, hd = args[0].shape

    def call():
        outs = [torch.empty_like(x) for x in (args[0], *args[5:])]
        rc = fn(*(x.data_ptr() for x in args), None,
                *(x.data_ptr() for x in outs), b, t, nh, hd,
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"cudaError {rc}")
        return outs
    return call


def mlstm_fwd(libs) -> None:
    import torch
    from repro_torch.kernels import build, ref, xlstm
    names = [n for (k, n) in libs if k == "mlstm_fwd"]
    loaded = {n: ctypes.CDLL(str(libs[("mlstm_fwd", n)])) for n in names}
    gen = torch.Generator(device="cuda").manual_seed(0)
    saved = build.load

    def through(n, args):
        def call():
            build.load = lambda name: loaded[n] if name == "mlstm_scan" \
                else saved(name)
            return xlstm.mlstm_scan_cuda(*args)
        return call
    try:
        for label, b, t in (("train", 2, 1024), ("long", 1, 4096)):
            args = _mlstm_args(gen, b, t)
            want = ref.mlstm_recurrence_ref(*args)
            calls = {n: _walk_call(loaded[n], args) if "baseline" in n
                     else through(n, args) for n in names}
            errs = {}
            for n, c in calls.items():
                got, again = c(), c()
                torch.cuda.synchronize()
                errs[n] = (rel(got, want), all(torch.equal(a, g)
                                               for a, g in zip(again, got)))
                del got, again
            res = {n: [] for n in calls}
            for order in (list(calls), list(calls)[::-1]):
                for n in order:
                    res[n].append(events(calls[n]))
            for n, c in calls.items():
                split = device_split(c, 3, "mlstm_")
                print(f"  mLSTM forward {label} B{b} T{t} [{n}]: events "
                      f"{res[n][0]:.5f} / {res[n][1]:.5f} ms, kernels "
                      f"{sum(split.values()):.5f} ms ("
                      + ", ".join(f"{k} {v:.5f}" for k, v in split.items())
                      + f"), err {errs[n][0]:.3e}, repeat bitwise "
                      f"{errs[n][1]}", flush=True)
            del args, want
        # the crossover: both routes at short T, in turns
        # (events: back-to-back calls, host-bound at short T; kernels: the
        # profiler's device time)
        ends = ("walk at every T", "chunkwise at every T")
        if all(e in names for e in ends):
            first = {"events": None, "kernels": None}
            for t in (4, 8, 12, 16, 24, 32, 48, 64, 96, 128):
                args = _mlstm_args(gen, 2, t)
                ms = {(e, w): [] for e in ends for w in first}
                for order in (ends, ends[::-1]):
                    for e in order:
                        ms[(e, "events")].append(events(through(e, args),
                                                        reps=20))
                        ms[(e, "kernels")].append(device_ms(
                            through(e, args), 20, "mlstm_"))
                line = []
                for w in first:
                    walk, chunk = (statistics.mean(ms[(e, w)]) for e in ends)
                    if first[w] is None and chunk < walk:
                        first[w] = t
                    line.append(f"{w} walk {walk:.5f} / chunkwise "
                                f"{chunk:.5f} ms")
                print(f"  mLSTM forward B2 T{t}: " + "; ".join(line),
                      flush=True)
            print(f"  mLSTM forward: the chunkwise route first wins at T "
                  f"{first['events']} by events, {first['kernels']} by "
                  "device time (as built: APEX_MLSTM_FWD_CROSSOVER)",
                  flush=True)
    finally:
        build.load = saved


def slstm_bwd(libs) -> None:
    import torch
    from repro_torch.kernels import build, ref, xlstm
    names = [n for (k, n) in libs if k == "slstm_bwd"]
    loaded = {n: ctypes.CDLL(str(libs[("slstm_bwd", n)])) for n in names}
    gen = torch.Generator(device="cuda").manual_seed(0)
    rn = lambda *s: torch.randn(s, generator=gen, device="cuda")
    b, t, nh, hd = 2, 1024, 4, 192
    d = nh * hd
    gx, r, bias = (rn(b, t, 4 * d),
                   (rn(nh, hd, 4 * hd) / hd ** 0.5).to(torch.bfloat16),
                   0.1 * rn(4 * d))
    c, n, h, m = (rn(b, nh, hd), 1.0 + rn(b, nh, hd).abs(), rn(b, nh, hd),
                  rn(b, nh, hd))
    hs, _, _, _, _, acts, cs, ns, ms = xlstm.slstm_scan_cuda(
        gx, r, bias, c, n, h, m, save=True)
    dhs = rn(b, t, nh, hd)
    dstate = tuple(rn(b, nh, hd) for _ in range(4))
    args = (r, acts, cs, ns, ms, c, n, m, dhs, dstate)
    want = ref.slstm_recurrence_bwd_ref(
        r, acts.reshape(b, t, nh, 4 * hd), cs, ns, ms, c, n, m, dhs, dstate)
    saved = build.load

    def call(n):
        build.load = lambda name: loaded[n] if name == "slstm_scan_bwd" \
            else saved(name)
        return xlstm.slstm_scan_bwd_cuda(*args)
    try:
        outs, errs = {}, {}
        for n in names:
            outs[n] = call(n)
            again = call(n)
            errs[n] = (rel(outs[n], want),
                       all(torch.equal(a, g) for a, g in zip(again,
                                                              outs[n])))
        res = {n: [] for n in names}
        for order in (names, names[::-1]):
            for n in order:
                res[n].append(events(lambda: call(n)))
        for n in names:
            flags = SLSTM_BWD.get(n.replace(" [as built]", ""))
            twins = [o for o in names if flags is not None and o != n
                     and {k: v for k, v in SLSTM_BWD.get(
                         o.replace(" [as built]", ""), {}).items()
                         if k != "EXCHANGE"} == {k: v for k, v in
                                                 flags.items()
                                                 if k != "EXCHANGE"}]
            same = all(all(torch.equal(a, g) for a, g in
                           zip(outs[o], outs[n])) for o in twins)
            split = device_split(lambda: call(n), 3, "slstm_bwd")
            us = [1e3 * x / t for x in res[n]]
            print(f"  sLSTM backward B{b} T{t} H{nh} hd{hd} bf16 [{n}]: "
                  f"events {res[n][0]:.5f} / {res[n][1]:.5f} ms ({us[0]:.3f}"
                  f" / {us[1]:.3f} us a step), kernel "
                  f"{sum(split.values()):.5f} ms, err {errs[n][0]:.3e}, "
                  f"repeat bitwise {errs[n][1]}, bits of the other exchange "
                  f"{same}", flush=True)
    finally:
        build.load = saved


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", help="a directory holding older "
                    "slstm_scan.cu, mlstm_scan_bwd.cu, mlstm_scan.cu and "
                    "slstm_scan_bwd.cu")
    ap.add_argument("--only", choices=sorted(SOURCES))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    print(f"card: {card()}", flush=True)
    kinds = [args.only] if args.only else list(SOURCES)
    libs = build_variants(kinds, args.baseline)
    if "slstm" in kinds:
        slstm(libs)
    if "mlstm" in kinds:
        mlstm(libs)
    if "mlstm_fwd" in kinds:
        mlstm_fwd(libs)
    if "slstm_bwd" in kinds:
        slstm_bwd(libs)
    print(f"card: {card()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
