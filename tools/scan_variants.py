#!/usr/bin/env python3
"""Time variants of the selective-scan kernel side by side on one GPU.

    python3 tools/scan_variants.py [--baseline OLD_mamba_scan.cu]

Each variant is a copy of ``src/repro_torch/csrc/mamba_scan.cu`` with one
or two constants changed, built with the flags of
``repro_torch.kernels.build`` into ``src/repro_torch/_build/variants/``
(one nvcc per copy, all at once), loaded with ctypes through the same C
entry point ``apex_mamba_scan``, held to the plain version at 1e-5 and
timed at three shapes (Jamba's inner 16384, N 16, fp32 inputs):

  decode   B 8, T 1 (14 layers' A and h0 rotated, so the state comes
           from device memory as in a serving step);
  prefill  B 8, T 128 (one admission bucket of the serving phase);
  long     B 1, T 4096 (one long prompt).

Variants: as built (S 8 states per lane, 32-step T-tiles); S 16, 4 and
2; T-tiles of 16 and 64 steps, and of 16 at S 16; ex2.approx(dt * A
log2 e) in place of CUDA's expf(dt * A); staging with plain loads
instead of cp.async.  ``--baseline`` adds an older source of the same C
entry (e.g. the parent commit's, unpacked with ``git archive`` into a
git-ignored directory) as one more column.  Each cell is the device time
per call from ``torch.profiler``, with CUDA events around back-to-back
calls beside it, the kernel's share of its bound
(``chip_smoke.scan_bound``) and its largest error against the plain
version.  The as-built kernel's compiled step loop is counted by
opcode (``cuobjdump -sass``).  Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

P, I = ctypes.c_void_p, ctypes.c_int
S_ = "constexpr int kStates = 8;"
T_ = "constexpr int kTileT = 32;"
SUBS = {
    "as built": [],
    "S 16": [(S_, "constexpr int kStates = 16;")],
    "S 4": [(S_, "constexpr int kStates = 4;")],
    "S 2": [(S_, "constexpr int kStates = 2;")],
    "T-tile 16": [(T_, "constexpr int kTileT = 16;")],
    "T-tile 64": [(T_, "constexpr int kTileT = 64;")],
    "S 16, T-tile 16": [(S_, "constexpr int kStates = 16;"),
                        (T_, "constexpr int kTileT = 16;")],
    "ex2.approx": [("constexpr bool kExp2 = false;",
                    "constexpr bool kExp2 = true;")],
    "plain loads": [("constexpr bool kAsync = true;",
                     "constexpr bool kAsync = false;")],
}
SHAPES = {"decode": (8, 1), "prefill": (8, 128), "long": (1, 4096)}
INNER, STATE, LAYERS = 16384, 16, 14
STATES_PER_LANE = 8                  # kStates as built


def build_variants(baseline: Path | None) -> tuple[dict, dict]:
    """name -> ctypes function, name -> ptxas register/spill lines."""
    from repro_torch.kernels import build
    out_dir = build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    text = (build.CSRC_DIR / "mamba_scan.cu").read_text()
    jobs = {}
    for name, subs in SUBS.items():
        src = text
        for a, b in subs:
            if a not in src:
                raise SystemExit(f"variant {name!r}: {a!r} not in the source")
            src = src.replace(a, b)
        jobs[name] = src
    if baseline is not None:
        jobs["baseline"] = baseline.read_text()

    def compile_one(item):
        name, src = item
        key = "scan_" + "".join(ch if ch.isalnum() else "_" for ch in name)
        cu, so = out_dir / f"{key}.cu", out_dir / f"{key}.so"
        cu.write_text(src)
        proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o",
                               str(so), str(cu)], capture_output=True,
                              text=True)
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{proc.stdout}"
                             f"{proc.stderr}")
        lines = (proc.stdout + proc.stderr).splitlines()
        regs = [ln.strip() for ln in lines if "registers" in ln
                or ("spill" in ln and " 0 bytes spill stores" not in ln)]
        return name, so, regs

    with ThreadPoolExecutor(len(jobs)) as pool:
        built = list(pool.map(compile_one, jobs.items()))
    fns, logs = {}, {}
    for name, so, regs in built:
        fn = ctypes.CDLL(str(so)).apex_mamba_scan
        fn.argtypes = [P] * 10 + [I] * 5 + [P]
        fn.restype = I
        fns[name], logs[name] = fn, regs
    logs["as built"].append(loop_mix(dict((n, so) for n, so, _ in built)
                                     ["as built"]))
    return fns, logs


def loop_mix(so: Path) -> str:
    """Instructions per thread-step in the compiled step loop of the
    fp32 N 16 kernel of ``so``: the stretch between two branches with
    the most MUFU.EX2 (the unrolled loop), from ``cuobjdump -sass``."""
    from repro_torch.kernels import build
    cuobjdump = Path(build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(so)],
                          capture_output=True, text=True).stdout
    body = sass.split("mamba_scan_kernelILi16EfE", 1)[1].split(
        "Function :", 1)[0]
    ops = [m.group(1) for m in re.finditer(
        r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)", body)]
    branches = [k for k, op in enumerate(ops) if op == "BRA"]
    a, b = max(zip(branches, branches[1:]),
               key=lambda ab: ops[ab[0]:ab[1]].count("MUFU.EX2"))
    loop = ops[a + 1:b]
    steps = loop.count("MUFU.EX2") // STATES_PER_LANE
    mix = Counter(loop).most_common(8)
    return (f"{len(loop) / steps:.1f} instructions per thread-step "
            f"({steps} steps of {STATES_PER_LANE} states unrolled): "
            + ", ".join(f"{op} {n / steps:.2f}" for op, n in mix))


def run_shape(fns, gen, label, b, t, card) -> None:
    import torch
    import torch.nn.functional as F
    from chip_smoke import device_ms, scan_bound, time_ms
    from repro_torch.kernels import ref

    def rn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    i, n = INNER, STATE
    dt = F.softplus(rn(b, t, i))
    x, bb, cc = rn(b, t, i), rn(b, t, n), rn(b, t, n)
    layers = LAYERS if t == 1 else 1
    per_layer = [(-torch.exp(rn(i, n)), rn(i), 0.5 * rn(b, i, n))
                 for _ in range(layers)]
    y = torch.empty((b, t, i), device="cuda")
    h = torch.empty((b, i, n), device="cuda")
    a0, d0, h00 = per_layer[0]
    y_ref, h_ref = ref.mamba_selective_scan_ref(dt, x, bb, cc, a0, d0, h00)
    stream = torch.cuda.current_stream().cuda_stream
    bd = scan_bound(b, t, i, n)
    cells = []
    for name, fn in fns.items():
        layer = [0]

        def call(fn=fn):
            a, d, h0 = per_layer[layer[0] % layers]
            layer[0] += 1
            rc = fn(dt.data_ptr(), x.data_ptr(), bb.data_ptr(), cc.data_ptr(),
                    a.data_ptr(), d.data_ptr(), h0.data_ptr(), None,
                    y.data_ptr(), h.data_ptr(), b, t, i, n, 0, stream)
            if rc:
                raise SystemExit(f"{name} at {label}: cudaError {rc}")
        call()
        torch.cuda.synchronize()
        err = max(float((y - y_ref).abs().max()),
                  float((h - h_ref).abs().max()))
        ok = bool(((y - y_ref).abs() <= 1e-5 + 1e-5 * y_ref.abs()).all()
                  and ((h - h_ref).abs() <= 1e-5 + 1e-5 * h_ref.abs()).all())
        reps = 100 if t == 1 else (20 if t <= 128 else 10)
        prof = device_ms(call, reps=reps)
        events = time_ms(call, reps=reps)
        ms = prof if prof is not None else events
        cells.append(f"{name} {ms:.5f} (events {events:.5f}; "
                     f"{100 * bd['bound_ms'] / ms:.1f}% of bound; err "
                     f"{err:.1e}{'' if ok else ' > 1e-5'})")
    print(f"scan {label} B{b} T{t} I{i} N{n} fp32, bound "
          f"{bd['bound_ms']:.5f} ms ({bd['bound_by']}), device ms per call: "
          + " | ".join(cells) + f" [{card}]", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=Path, default=None,
                    help="an older mamba_scan.cu with the same C entry")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    fns, logs = build_variants(args.baseline)
    for name, regs in logs.items():
        for line in regs:
            print(f"  [{name}] {line}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for label, (b, t) in SHAPES.items():
        run_shape(fns, gen, label, b, t, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
