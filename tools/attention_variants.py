#!/usr/bin/env python3
"""Time variants of the two attention kernels side by side on one GPU.

    python3 tools/attention_variants.py

Each variant is a copy of ``prefill_attention.cu`` or ``decode_attention.cu``
(``src/repro_torch/csrc/``) with one constant changed (or a phase cut
out), built with the flags of ``repro_torch.kernels.build`` into
``src/repro_torch/_build/variants/`` (one nvcc per copy, all at once),
loaded with ctypes through the same C entry point, and timed with
``torch.profiler`` (device time per call) beside
``scaled_dot_product_attention`` on the same inputs.  Prefill variants
are held to the plain version at the serving shape (the cut-down ones
are timing probes whose output is not used):

  prefill  as built; 64-key tiles; 3-stage ring; two heads per CTA;
           and the cost breakdown: an empty launch of the grid, the loads
           alone, the loads and the stores (no products);
  decode   the planned split count, half of it and twice it.

Shapes: the serving phase's (prefill B 8, T 128, S 512, H 32/8, D 128;
decode B 4, S 512, lengths 129-144), Jamba's G 8 prefill, and the long
ones (prefill T 4096; decode B 8 over S 8192).  Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

P, I = ctypes.c_void_p, ctypes.c_int
PREFILL_SUBS = {
    "as built": [],
    "64-key tiles": [("constexpr int MBK = 32;", "constexpr int MBK = 64;")],
    "3-stage ring": [("constexpr int STAGES = 2;",
                      "constexpr int STAGES = 3;")],
    "two heads per CTA": [("    case 4:\n    case 8:\n"
                           "      return launch_mma<D, 4>",
                           "    case 4:\n    case 8:\n"
                           "      return launch_mma<D, 2>")],
    "probe: empty launch": [("  using L = MmaSmem<D, GH>;\n"
                             "  extern __shared__",
                             "  if (T_len > 0) return;\n"
                             "  using L = MmaSmem<D, GH>;\n"
                             "  extern __shared__")],
    "probe: loads only": [
        ("    const __nv_bfloat16* Ks = ring + (kt % STAGES)",
         "    if (T_len > 0) continue;\n"
         "    const __nv_bfloat16* Ks = ring + (kt % STAGES)"),
        ("  // normalise, stage the warp's rows",
         "  if (T_len > 0) return;\n  // normalise, stage the warp's rows")],
    "probe: loads and stores": [
        ("    const __nv_bfloat16* Ks = ring + (kt % STAGES)",
         "    if (T_len > 0) continue;\n"
         "    const __nv_bfloat16* Ks = ring + (kt % STAGES)")],
}


def build_variants() -> dict:
    from repro_torch.kernels import build
    out_dir = build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    text = (build.CSRC_DIR / "prefill_attention.cu").read_text()
    jobs = {"decode": (build.CSRC_DIR / "decode_attention.cu").read_text()}
    for i, (name, subs) in enumerate(PREFILL_SUBS.items()):
        src = text
        for a, b in subs:
            if a not in src:
                raise SystemExit(f"variant {name!r}: {a!r} not in the source")
            src = src.replace(a, b)
        jobs[f"prefill{i}"] = src

    def compile_one(item):
        key, src = item
        cu, so = out_dir / f"{key}.cu", out_dir / f"{key}.so"
        cu.write_text(src)
        proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o",
                               str(so), str(cu)], capture_output=True,
                              text=True)
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {key}:\n{proc.stdout}"
                             f"{proc.stderr}")
        return key, so

    with ThreadPoolExecutor(len(jobs)) as pool:
        built = dict(pool.map(compile_one, jobs.items()))
    fns = {}
    for key, so in built.items():
        lib = ctypes.CDLL(str(so))
        if key == "decode":
            fn = lib.apex_decode_attention
            fn.argtypes = [P] * 8 + [I] * 8 + [P]
        else:
            fn = lib.apex_prefill_attention
            fn.argtypes = [P] * 6 + [I] * 9 + [P]
        fn.restype = I
        fns[key] = fn
    return fns


def device_ms(fn, reps: int = 30) -> float:
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(e, "self_device_time_total", 0.0)
                for e in prof.key_averages())
    return total / reps / 1e3


def prefill(fns, gen, card) -> None:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    shapes = {"serving B8 T128 S512 H32/8": (8, 128, 512, 32, 8),
              "Jamba G8 B8 T128 S512 H64/8": (8, 128, 512, 64, 8),
              "long B1 T4096 S4096 H32/8": (1, 4096, 4096, 32, 8)}
    d = 128
    for label, (b, t, s, h, kv) in shapes.items():
        rn = lambda *shape: torch.randn(shape, generator=gen,
                                        device="cuda").to(torch.bfloat16)
        q, k, v = rn(b, t, h, d), rn(b, s, kv, d), rn(b, s, kv, d)
        zero = torch.zeros(b, dtype=torch.int32, device="cuda")
        out = torch.empty_like(q)
        stream = torch.cuda.current_stream().cuda_stream
        expect = (ref.prefill_attention_ref(q, k, v, None, zero).float()
                  if t <= 128 else None)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        sdpa = device_ms(lambda: F.scaled_dot_product_attention(
            qt, kt[:, :, :t], vt[:, :, :t], is_causal=True, enable_gqa=True))
        cells = [f"sdpa {sdpa:.5f}"]
        for i, name in enumerate(PREFILL_SUBS):
            fn = fns[f"prefill{i}"]

            def call(fn=fn):
                rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        zero.data_ptr(), zero.data_ptr(), out.data_ptr(), b,
                        t, s, h, kv, d, 1, 1, 1, stream)
                if rc:
                    raise SystemExit(f"{name}: cudaError {rc}")
            call()
            torch.cuda.synchronize()
            if expect is not None and not name.startswith("probe"):
                err = float((out.float() - expect).abs().max())
                if err > 3e-2:
                    raise SystemExit(f"prefill {name} at {label}: err {err}")
            cells.append(f"{name} {device_ms(call):.5f}")
        print(f"prefill {label} bf16, device ms per call: "
              + " | ".join(cells) + f" [{card}]", flush=True)


def decode(fns, gen, card) -> None:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import plan_splits
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    h, kv, d = 32, 8, 128
    for label, (b, s, lo, layers) in {
            "serving B4 S512": (4, 512, 129, 32),
            "long B8 S8192": (8, 8192, 7936, 1)}.items():
        rn = lambda *shape: torch.randn(shape, generator=gen,
                                        device="cuda").to(torch.bfloat16)
        q = rn(b, h, d)
        kc, vc = rn(layers, b, s, kv, d), rn(layers, b, s, kv, d)
        hi = s + 1 if lo > 512 else 145
        lengths = torch.randint(lo, hi, (b,), generator=gen, device="cuda",
                                dtype=torch.int32)
        expect = ref.decode_attention_ref(q, kc[0], vc[0], lengths).float()
        bound = 2 * int(lengths.sum()) * kv * d * 2 / 3.35e12 * 1e3
        mask = (torch.arange(s, device="cuda")[None]
                < lengths[:, None])[:, None, None, :]
        sdpa = device_ms(lambda: F.scaled_dot_product_attention(
            q[:, :, None], kc[0].transpose(1, 2), vc[0].transpose(1, 2),
            attn_mask=mask, enable_gqa=True))
        cells = [f"bound {bound:.5f}", f"sdpa {sdpa:.5f}"]
        planned = plan_splits(b, kv, s, sms)
        for splits in sorted({max(1, planned // 2), planned, 2 * planned}):
            n_acc = b * kv * splits * (h // kv) * d
            work = torch.empty(n_acc + 2 * n_acc // d, device="cuda")
            counters = torch.zeros(b * kv, dtype=torch.int32, device="cuda")
            out = torch.empty_like(q)
            stream = torch.cuda.current_stream().cuda_stream
            layer = [0]

            def call():
                i = layer[0] % layers
                layer[0] += 1
                rc = fns["decode"](
                    q.data_ptr(), kc[i].data_ptr(), vc[i].data_ptr(),
                    lengths.data_ptr(), out.data_ptr(), counters.data_ptr(),
                    work.data_ptr() + 4 * n_acc, work.data_ptr(), b, h, kv, s,
                    d, 1, 1, splits, stream)
                if rc:
                    raise SystemExit(f"decode: cudaError {rc}")
            layer[0] = 0
            call()
            torch.cuda.synchronize()
            err = float((out.float() - expect).abs().max())
            if err > 2e-2:
                raise SystemExit(f"decode x{splits} at {label}: err {err}")
            ms = device_ms(call)
            tag = " (planned)" if splits == planned else ""
            cells.append(f"{splits} splits{tag} {ms:.5f} "
                         f"({100 * bound / ms:.1f}% of bound)")
        print(f"decode {label} lengths {lengths.tolist()} bf16, device ms "
              "per call: " + " | ".join(cells) + f" [{card}]", flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    fns = build_variants()
    gen = torch.Generator(device="cuda").manual_seed(0)
    prefill(fns, gen, card)
    decode(fns, gen, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
