#!/usr/bin/env python3
"""How far the selective-scan kernel and its plain fp32 version each sit
from exact, at one long prompt, on one GPU.

    python3 tools/scan_float64.py [--seeds 6]

For each seed, draws the inputs ``chip_smoke.py`` draws for a scan of
B 1, T 4096, I 16384, N 16 (fp32), runs the CUDA kernel, the plain
PyTorch version (fp32, ``kernels.ref``) and the same loop in float64,
and prints the largest |y| error of each fp32 path against float64, the
kernel-against-plain error, and whether ``chip_smoke.close`` holds them
at 1e-5.  Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def float64_scan(dt, x, b, c, a_neg, d_skip, h0):
    """The plain loop of ``kernels.ref.mamba_selective_scan_ref`` in
    float64 (every step advances: no lengths)."""
    import torch
    dt, x, b, c, a_neg, d_skip, h = (v.double() for v in
                                     (dt, x, b, c, a_neg, d_skip, h0))
    ys = []
    for i in range(dt.shape[1]):
        h = torch.exp(dt[:, i, :, None] * a_neg[None]) * h \
            + (dt[:, i] * x[:, i])[..., None] * b[:, i, None, :]
        ys.append((h * c[:, i, None, :]).sum(-1) + d_skip * x[:, i])
    return torch.stack(ys, 1)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=6)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device visible to torch", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import ref
    from repro_torch.kernels.mamba_scan import mamba_selective_scan_cuda
    for seed in range(args.seeds):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        inputs = cs._scan_case(gen, 1, 4096, 16384, 16, torch.float32)
        y_kernel, _ = mamba_selective_scan_cuda(*inputs)
        y_plain, _ = ref.mamba_selective_scan_ref(*inputs)
        y64 = float64_scan(*inputs)
        err_k = (y_kernel.double() - y64).abs().max().item()
        err_p = (y_plain.double() - y64).abs().max().item()
        kp, ok = cs.close(y_kernel, y_plain, 1e-5)
        print(f"seed {seed}: |kernel - f64| {err_k:.3e}, |plain - f64| "
              f"{err_p:.3e}, |kernel - plain| {kp:.3e} (within 1e-5: "
              f"{ok}); max |y| {y64.abs().max().item():.3e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
