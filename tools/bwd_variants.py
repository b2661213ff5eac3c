#!/usr/bin/env python3
"""Time variants of the two backward kernels side by side on one GPU.

    python3 tools/bwd_variants.py [--baseline DIR]

Each variant is a copy of ``src/repro_torch/csrc/prefill_attention_bwd.cu``
or ``mamba_scan_bwd.cu`` with a constant changed or one phase cut out,
built with the flags of ``repro_torch.kernels.build`` into
``src/repro_torch/_build/variants/`` (one nvcc per copy, all at once) and
loaded with ctypes through the library's own C entry point.  The cuts
compute wrong gradients on purpose: they say where the time goes.

  attention (bf16, causal): llama3.1-8b's training shape (B 2, T 1024,
    32/8 heads of 128), Jamba's (B 1, 64/8), and D 64 (B 2, 16/4);
    variants: as built; without the dQ kernel (the dK/dV kernel alone);
    dK/dV without its S^T and dP^T products; dK/dV without its dV and dK
    products (the compiler then drops the products before them too: the
    load pipeline alone);
  scan (fp32): Jamba's training shape (B 1, T 1024, I 16384, N 16);
    variants: as built; the forward pass over T alone; without the
    reverse walk (forward pass, chunk recompute, db/dc sums); checkpoints
    every 8 steps.

``--baseline DIR`` adds the two sources found in DIR (e.g. the parent
commit's ``src/repro_torch/csrc``, unpacked with ``git archive`` into a
git-ignored directory) as one more variant each.  Every variant prints
its kernels' registers and spills (``-Xptxas -v``), its largest error
against the plain version relative to the largest gradient, and its
time per call by CUDA events, taken in two rounds in opposite orders.
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
NODQ = [("  auto kern = dq_wgmma_kernel<D>;",
         "  return 0;\n  auto kern = dq_wgmma_kernel<D>;")]
SS = """        wgmma_ss_n64(st, kd + off, qd + off, kk > 0);
        wgmma_ss_n64(dpt, vd + off, od + off, kk > 0);"""
RS = """        wgmma_rs_d<D>(dva, pa[kk], omn + kk * (16 * ROW_B >> 4));
        wgmma_rs_d<D>(dka, sa[kk], qmn + kk * (16 * ROW_B >> 4));"""
ATTN = {
    "as built": [],
    "dK/dV alone": NODQ,
    "dK/dV, no S/dP products": NODQ + [(SS, "")],
    "dK/dV, no dV/dK products": NODQ + [(RS, "")],
}
SCAN = {
    "as built": [],
    "forward pass only": [
        ("  // 2. the reverse scan, chunk by chunk from the end",
         "  return;")],
    "no reverse walk": [
        ("    for (int tt = kChunk - 1; tt >= 0; --tt) {",
         "    for (int tt = kChunk - 1; tt >= kChunk; --tt) {")],
    "checkpoints every 8": [("constexpr int kChunk = 16;",
                             "constexpr int kChunk = 8;")],
}


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def build_variants(baseline):
    """name -> (library path, kind); prints each build's registers."""
    from repro_torch.kernels import build
    out = build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for kind, table, src in (("attn", ATTN, "prefill_attention_bwd"),
                             ("scan", SCAN, "mamba_scan_bwd")):
        text = (build.CSRC_DIR / f"{src}.cu").read_text()
        for name, pairs in table.items():
            var = text
            for old, new in pairs:
                if old not in var:
                    raise SystemExit(f"{name}: not in the source: {old!r}")
                var = var.replace(old, new)
            jobs[(kind, name)] = var
        if baseline:
            jobs[(kind, "baseline")] = (Path(baseline)
                                        / f"{src}.cu").read_text()
    procs = {}
    for i, ((kind, name), text) in enumerate(jobs.items()):
        cu, so = out / f"v{i}.cu", out / f"v{i}.so"
        cu.write_text(text)
        procs[(kind, name)] = (so, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for (kind, name), (so, proc) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{text[-3000:]}")
        entry, stores = None, "?"
        for line in text.splitlines():
            m = re.search(r"entry function '(\S+)'", line)
            if m:
                entry = re.search(r"(\w+_kernel)ILi(\d+)", m.group(1))
            spill = re.search(r"(\d+) bytes spill stores", line)
            if spill:
                stores = spill.group(1)
            m = re.search(r"Used (\d+) registers", line)
            if m and entry and ("wgmma" in entry.group(1)
                                or "scan_bwd" in entry.group(1)):
                print(f"  [{kind} {name}] {entry.group(1)}<{entry.group(2)}>"
                      f": {m.group(1)} registers, {stores} B spilled")
        libs[(kind, name)] = so
    return libs


def events(fn, reps=10, rounds=5) -> float:
    import torch
    for _ in range(3):
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


def rel(got, want) -> float:
    return max(float((g.float() - w.float()).abs().max())
               / max(float(w.float().abs().max()), 1e-12)
               for g, w in zip(got, want))


def attention(libs) -> None:
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.prefill_attention import prefill_attention_cuda
    fns = {}
    for (kind, name), so in libs.items():
        if kind == "attn":
            fn = ctypes.CDLL(str(so)).apex_prefill_attention_bwd
            fn.argtypes = [P] * 11 + [I] * 8 + [P]
            fn.restype = I
            fns[name] = fn

    def call(fn, q, k, v, o, lse, do, pre):
        b, t, h, d = q.shape
        dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
        delta = torch.empty((b, h, t), dtype=torch.float32, device="cuda")
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                do.data_ptr(), lse.data_ptr(), pre.data_ptr(),
                delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                b, t, k.shape[1], h, k.shape[2], d, 1, 1,
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"cudaError {rc}")
        return dq, dk, dv

    gen = torch.Generator(device="cuda").manual_seed(0)
    for label, b, t, h, kv, d in (("llama3.1-8b", 2, 1024, 32, 8, 128),
                                  ("jamba", 1, 1024, 64, 8, 128),
                                  ("D 64", 2, 1024, 16, 4, 64)):
        mk = lambda s: torch.randn(s, generator=gen, device="cuda").to(
            torch.bfloat16)
        q, k, v, do = mk((b, t, h, d)), mk((b, t, kv, d)), mk((b, t, kv, d)), \
            mk((b, t, h, d))
        pre = torch.zeros((b,), dtype=torch.int32, device="cuda")
        out, lse = prefill_attention_cuda(q, k, v, pre, return_lse=True)
        want = ref.prefill_attention_bwd_ref(q, k, v, out, lse, do, pre)
        res = {n: [rel(call(f, q, k, v, out, lse, do, pre), want)]
               for n, f in fns.items()}
        for order in (list(fns), list(fns)[::-1]):
            for n in order:
                res[n].append(events(lambda: call(fns[n], q, k, v, out, lse,
                                                  do, pre)))
        for n, (err, t1, t2) in res.items():
            print(f"  attention {label} B{b} T{t} H{h}/{kv} D{d} [{n}]: "
                  f"{t1:.5f} / {t2:.5f} ms, err {err:.3e}", flush=True)


def scan(libs) -> None:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    b, t, i, n = 1, 1024, 16384, 16
    gen = torch.Generator(device="cuda").manual_seed(0)
    rn = lambda s: torch.randn(s, generator=gen, device="cuda")
    args = (F.softplus(rn((b, t, i))), rn((b, t, i)), rn((b, t, n)),
            rn((b, t, n)), -torch.exp(rn((i, n)) * 0.5), rn((i,)),
            rn((b, i, n)) * 0.5, rn((b, t, i)))
    want = ref.mamba_selective_scan_bwd_ref(*args)
    calls = {}
    for (kind, name), so in libs.items():
        if kind != "scan":
            continue
        lib = ctypes.CDLL(str(so))
        lib.apex_mamba_scan_bwd.argtypes = [P] * 20 + [I] * 4 + [P]
        lib.apex_mamba_scan_bwd.restype = I
        lib.apex_mamba_scan_bwd_channels.argtypes = [I]
        chunk = lib.apex_mamba_scan_bwd_chunk()
        nblk = -(-i // lib.apex_mamba_scan_bwd_channels(n))
        f32 = dict(dtype=torch.float32, device="cuda")
        scratch = (torch.empty((b, -(-t // chunk), i, n), **f32),
                   torch.empty((b, nblk, t, 2 * n), **f32),
                   torch.empty((b, i, n), **f32), torch.empty((b, i), **f32))
        outs = [torch.empty_like(x) for x in args[:7]]

        def call(lib=lib, scratch=scratch, outs=outs):
            rc = lib.apex_mamba_scan_bwd(
                *(x.data_ptr() for x in args), None,
                *(x.data_ptr() for x in scratch),
                *(x.data_ptr() for x in outs), b, t, i, n,
                torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"cudaError {rc}")
            return outs
        calls[name] = call
    res = {nm: [rel(c(), want)] for nm, c in calls.items()}
    for order in (list(calls), list(calls)[::-1]):
        for nm in order:
            res[nm].append(events(calls[nm]))
    for nm, (err, t1, t2) in res.items():
        print(f"  scan backward B{b} T{t} I{i} N{n} [{nm}]: {t1:.5f} / "
              f"{t2:.5f} ms, err {err:.3e}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", help="a directory holding older "
                    "prefill_attention_bwd.cu and mamba_scan_bwd.cu")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    print(f"card: {card()}", flush=True)
    libs = build_variants(args.baseline)
    attention(libs)
    scan(libs)
    print(f"card: {card()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
