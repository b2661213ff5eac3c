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
     bound -- at the main-path shapes (llama3.1-8b's, and deepseek-moe-
     16b's: group 1, head_dim 128), and also at a long decode (B 8,
     S 8192), a long causal prefill (T 4096) and a long scan (B 1,
     T 4096); then the xLSTM recurrences at xlstm-125m's shapes (sLSTM
     4 heads of 192, mLSTM 4 of 384): the chat chunk (B 2 x T 64) and
     decode (B 2 x T 1) at 1e-5 of the largest value, frozen rows and a
     split in T bitwise, one launch per call, one long call (T 4096;
     the sLSTM against a float64 loop; the mLSTM's on its chunkwise
     route), the mLSTM's chunkwise route at the training shape (B 2 x
     T 1024) from a carried and from the zero state at 1e-5, bitwise on
     repeat, each call's route printed, both forward kernels timed at
     the training shape with the time a step, both
     backward kernels there at 1e-4 (the mLSTM's against its plain
     version in float64) and bitwise on repeat, the mLSTM forward's four
     chunkwise kernels and its backward's six by the profiler beside
     the call by events;
  3. profile: ``OfflineProfiler`` on llama3.1-8b at published width over
     the startup grid -- every table point finite and positive, both
     attention kernels launched, the profile saved under chiprun_out/ and
     reloaded through ``file:`` unchanged, and its predictions printed
     beside the analytic h100 model's at the chat operating points;
  4. exactness: llama3.1-8b and the dense-FFN Jamba hybrid, each reduced
     to d_model 256 in fp32 -- greedy tokens from raw prefill+decode,
     engine device rows and host-offloaded rows must be identical; and
     serving-chunked's chat traffic must give the same streams with and
     without the prefix cache, rebalancing and preemption; xlstm-125m
     at published width in fp32, prefill + 8 greedy steps through the
     recurrences' kernels against the CPU's plain loops and the card's
     (logits within 2e-3 of the largest, equal tokens up to ties);
  5. serving: InferenceServer on llama3.1-8b at its published width, cut
     to 16 layers (bf16, random weights from a seed), 8 requests over 4
     device + 4 host slots, whole-prompt prefill, no prefix cache or tier
     moves;
  6. serving-hybrid: the same traffic on Jamba-1.5-Large with dense FFNs
     at its published width, depth cut to 2 periods (16 layers);
  7. faults: the reference's fault soak on llama3.1-8b at published width
     cut to 8 layers -- a fault-free control (no host fallback), the plan
     (a host worker's death and stall, a failed pool allocation, a
     latency spike), consecutive fallbacks tripping the breaker, a
     blocked swap recomputed, cancels of a queued request, a device and a
     host resident: streams held to the control's, the pool whole;
  8. serving-chunked: the reference's default configuration (chunked
     prefill beside decode, the prefix cache on both tiers, migration,
     preemption) on multi-turn chat, llama3.1-8b (8 layers) and the
     8-layer Jamba at published width: every mechanism must fire, the
     streams must equal a run with the prefix cache and tier moves off (a
     stream may part only at a top-2 tie of two logit ULPs), and the pool
     must end whole; llama runs the traffic once more on a measured
     profile taken at engine startup, and twice with the int8 host pool,
     without and with cold-page compression: pages must compress and
     rehydrate, with the streams of the run without;
  9. serving-moe: deepseek-moe-16b at published width (28 layers, 64
     routed experts top-6 + 2 shared) on the analytic perf model, 8
     requests of 128 -> 16 tokens over 2 device + 4 host slots with
     whole-prompt prefill (the serving phase's path), once with the fp32
     host pool and once with the int8 pool and cold-page compression
     (every host owner there decodes, so none goes cold; serving-chunked
     runs the compression): both attention kernels held to their plain
     versions at its head geometry (group 1, head_dim 128), no host
     fallback, int8 streams equal to fp32's up to two-ULP ties, ~4x fewer
     host bytes per token, both MoE paths run; the logit drift is printed,
     and held under the reference's 0.75 on llama3.1-8b cut to 8 layers
     run the same way (on this MoE geometry the reference's own int8 drift
     exceeds 0.75: tools/moe_drift_cpu.py);
 10. serving-registry: stablelm-12b (head_dim 160, cut to 16 layers),
     internlm2-20b (group 6, cut to 16 layers) and llama3-405b (group
     16, cut to 4 layers) at published width, 4 requests of 128 -> 16 tokens over 2
     device + 2 host slots, whole-prompt prefill, the analytic h100 perf
     model: both tiers decode, no host fallback, both kernels launched;
 11. serving-xlstm: xlstm-125m at published width and depth (bf16),
     GPU-only, on serving-chunked's chat traffic with the defaults and
     with the prefix cache, rebalancing and preemption off: the streams
     equal up to two-ULP ties, both recurrence kernels launched; traced
     windows with the kernels and with the plain loops, in turns;
 12. vlm: paligemma-3b at published width served as a text model
     (phase 5's traffic), then prefix-LM prefill over 256 patch
     embeddings + 32 tokens and 8 decode steps (fp32), held against
     forward_train's teacher-forced logits at 2e-2;
 13. encoder: hubert-xlarge at published width, forward_train over 4 x
     500 frames (full attention, head_dim 80): finite logits, and its
     first two layers against the CPU's fp32 forward at 5e-2;
 14. cli: ``python -m repro_torch.launch.serve`` with its defaults (the
     measured perf model), with ``--fault-plan host_error@2``, with
     ``--arch deepseek-moe-16b --perf-model analytic --host-kv-dtype
     int8``, with ``--arch xlstm-125m --perf-model analytic`` and with
     ``--arch paligemma-3b``;
 15. gateway: llama3.1-8b at published width (bf16, cut to 8 layers) served
     by two ``InferenceServer`` replicas sharing one copy of the weights
     behind the HTTP/SSE gateway (the reference's default path on 2 device
     + 2 host slots each, one measured profile that every replica build
     loads): a closed-loop burst of 8 requests (128 -> 16 tokens) from 4
     client threads over real sockets, its streams equal to a direct
     ``InferenceServer`` run up to two-ULP ties, /health and /metrics,
     no host fallback; two 3-turn sessions pinned to their replica with
     prefix hits; 503 at a full queue and 429 behind a backlog; a
     ``driver_crash`` fault plan on one replica (its streams end with the
     crash's error, the other's finish, exactly one respawn, /health green
     again, the next request on the respawned replica); the burst on one
     replica, and on one replica holding both replicas' device slots;
     ``python -m repro_torch.launch.gateway --published --layers 4
     --smoke-test``;
 16. train: llama3.1-8b at published width and depth (bf16, Adafactor
     lr 1e-4, remat, the loss over chunks of 256 tokens), 5 steps of B 2 x
     T 1024 on one synthetic batch, the dense-FFN Jamba period (8
     layers) at published width, 3 steps of B 1 x T 1024, and
     xlstm-125m at published width and depth, 3 steps of B 2 x T 1024:
     every loss and grad norm finite, the last loss below the first,
     step time, tokens/s, peak memory and launches (each attention,
     Mamba, sLSTM and mLSTM layer's forward twice a step, its backward
     kernel once) and a profiled step's split by kernel (the xLSTM
     recurrences summed); one fp32 backward of the three models cut to 2 layers
     (Jamba: a Mamba and its attention layer) on the card against the
     CPU's plain versions, leaf by leaf; 2 steps,
     checkpoint, restore into a fresh state and a 3rd step bitwise the
     uninterrupted one; ``python -m repro_torch.launch.train --steps 30
     --ckpt-every 10`` and its ``--resume``.
 17. dryrun: ``python -m repro_torch.launch.dryrun`` on five cells at
     published width and depth, on the production meshes over a fake
     process group (llama3.1-8b decode_32k overlap on 16x16 and train_4k
     on 2x16x16, deepseek-moe-16b decode_32k with expert-TP, Jamba
     long_500k, xlstm-125m train_4k through the recurrences' meta rules):
     no "error", ``argument_bytes`` equal to the specs' own
     sum, collectives on the multi-pod train cell; then the memory check:
     llama3.1-8b cut to 2 layers, one AdamW step at B 2 x T 1024 traced on
     a (1, 1) mesh and taken on the card, ``argument_bytes`` equal to the
     growth of ``memory_allocated`` within the allocator's 512-byte
     rounding a tensor, ``total_per_device`` printed beside the step's
     peak growth;
 18. examples: the four ``examples/torch_*.py`` on the card, each to its
     own assertion; quickstart must launch both attention kernels.

Phase 2 also holds both attention kernels at the registry's published
head geometries (group 6, group 16, head_dim 160 and 256; the VLM's
prefix-LM span; the encoder's full attention at head_dim 80 over T 500)
and the fp32 prefill at head_dims 80, 160 and 256, and prints every
kernel instantiation's registers and spills from ``-Xptxas -v``.  It
holds the two backward kernels (training) against their plain versions:
attention at llama3.1-8b's and Jamba's training shapes, the registry's
other geometries and in fp32, timed beside SDPA's forward + backward;
the scan at a reduced width and at Jamba's I 16384, T 256 and its
training shape B 1 x T 1024.

The line before the last is the JSON ``kernels`` record; the last line is
``{"ok": true, "device": {...}}``.  ``--phases`` runs a subset (the
``kernels`` record needs the serving phases for its launch counts; each
serving phase zeroes the launch counts just before its measured run and
reads them just after).
"""
from __future__ import annotations

import argparse
import contextlib
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
# what serving-chunked's second run turns off (chunked prefill stays on)
FEATURES_OFF = dict(prefix_cache=False, tier_rebalance=False,
                    preemption=False)
# 4 conversations x 3 turns over one shared system prompt; each turn's
# prompt is the previous prompt, its output and new user tokens (176,
# 240, 304 tokens: 3-5 chunks of 64); each conversation submits its next
# turn when the last one finishes; one priority-1 request (400 tokens ->
# 96) arrives once both device slots hold priority-0 residents with one
# token left to decode (see chat_run); the int8 chat runs compress host
# pages idle for 10 ms
# serving-moe: deepseek-moe-16b at published width (MHA, 16 heads of 128,
# 28 layers), 8 requests of 128 -> 16 tokens over 2 device + 4 host slots,
# the host pool in fp32 and then in int8 with pages compressed after 10 ms
# idle
MOE_SERVE = dict(heads=16, kv_heads=16, head_dim=128, layers=28,
                 cache_len=512, device_slots=2, host_slots=4, page_size=32,
                 prompt_len=128, output_len=16, requests=8,
                 compress_after=0.01)
CHAT = dict(conversations=4, turns=3, system_len=128, user_len=48,
            output_len=16, urgent_len=400, urgent_output=96, device_slots=2,
            host_slots=4, cache_len=512, page_size=32, llama_layers=8,
            compress_after=0.01)
# the reference registry's published head geometries that the main path
# never reaches, as (H, KV, D): group 6, group 16, head_dim 160 and 256
# (decode and causal prefill, B 4: S 512 and T 128), the VLM's prefix
# (256 patches + 32 text tokens, prefix_len 256) and the encoder's full
# attention (head_dim 80, T 500: ten seconds of audio at HuBERT's 50 Hz)
REGISTRY_ATTN = {"internlm2-20b": (48, 8, 128), "llama3-405b": (128, 8, 128),
                 "stablelm-12b": (32, 8, 160), "paligemma-3b": (8, 1, 256)}
REGISTRY_BENCH = dict(rows=4, cache_len=512, lo=129, hi=145, prompt_len=128,
                      layers=8)
VLM = dict(rows=4, patches=256, text=32, decode_steps=8)
ENCODER = dict(rows=4, frames=500, check_layers=2)
# serving-registry: the dense configs at published width, 4 requests of
# 128 -> 16 tokens over 2 device + 2 host slots, whole-prompt prefill,
# the analytic h100 perf model; stablelm-12b cut to 16 of its 40 layers
# (at 40 the phase took 81 s, and the train phase needed the time),
# internlm2-20b to 16 of its 48 (at 48 its host rows decode a token
# every 49 iterations: 87 s for the phase's traffic) and llama3-405b to
# 4 of its 126 (one layer is 6.4 GB of bf16 weights)
REGISTRY_SERVE = dict(requests=4, prompt_len=128, output_len=16,
                      device_slots=2, host_slots=2, cache_len=512)
REGISTRY_LAYERS = {"stablelm-12b": 16, "internlm2-20b": 16,
                   "llama3-405b": 4}
CARD = ""           # nvidia-smi's "name, power.limit", set by phase 1
# a part of each hand-written kernel's name, as the profiler reports it
PORT_KERNELS = {"decode_attention": "decode_kernel",
                "prefill_attention": "prefill_", "mamba_selective_scan":
                "mamba_scan_kernel"}


_T0 = time.perf_counter()


def log(msg: str) -> None:
    """Print a line; a phase's header carries the seconds since start."""
    if msg.startswith("== "):
        msg += f"  [{time.perf_counter() - _T0:.1f} s]"
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


def device_ms_by_kernel(fn, *, reps: int = 20) -> dict:
    """Device time per call of ``fn``, by the name of each kernel it ran
    (the self time ``torch.profiler`` reports, no host enqueue); empty
    when the profiler reports no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    parts = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        if us > 0:
            parts[ev.key] = parts.get(ev.key, 0.0) + us / reps / 1e3
    return parts


def device_ms(fn, *, reps: int = 20):
    """Device time per call of ``fn``: the summed self time of every
    kernel it ran (``device_ms_by_kernel``); None when the profiler
    reports no device time."""
    total = sum(device_ms_by_kernel(fn, reps=reps).values())
    return total if total > 0 else None


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


def _bench_decode(gen, *, b, h, kv, d, s, layers, lo, hi) -> dict:
    """Decode attention at a serving shape: one call per layer over the
    stacked cache (G, B, S, KV, D), rotating layers so K/V come from HBM
    as in a real step; lengths drawn in [lo, hi).  Kernel vs plain
    version vs SDPA with the length mask made explicit."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    dt, el = torch.bfloat16, 2
    kc = _randn(gen, (layers, b, s, kv, d), dt, "cuda")
    vc = _randn(gen, (layers, b, s, kv, d), dt, "cuda")
    q = _randn(gen, (b, h, d), dt, "cuda")
    lengths = torch.randint(lo, hi, (b,), generator=gen, device="cuda",
                            dtype=torch.int32)
    got = decode_attention_cuda(q, kc[0], vc[0], lengths)
    err, ok = close(got, ref.decode_attention_ref(q, kc[0], vc[0], lengths),
                    TOL["decode", "bfloat16"])
    shape = f"B{b} H{h} KV{kv} D{d} S{s} lengths {lengths.tolist()} bf16"
    if not ok:
        fail(f"decode at {shape}: err {err}")
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
    return _record(
        "decode_attention", "src/repro_torch/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention.py:99", err, times, nbytes,
        flops, "bfloat16", shape)


def _bench_chunk(gen, *, cb, ct, s, h, kv, d, label="chunk",
                 spread=True) -> dict:
    """Prefill attention at a chunk of the chunked path: every staging row
    advances ``ct`` tokens at its own offset into an ``s`` cache (offset
    0 for every row when not ``spread``: a whole-prompt bucket); kernel
    vs plain version vs SDPA with the causal mask made explicit (SDPA
    cannot take per-row offsets as a causal flag).  The bound counts the
    keys each row's chunk sees."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.prefill_attention import prefill_attention_cuda
    dt, el = torch.bfloat16, 2
    q = _randn(gen, (cb, ct, h, d), dt, "cuda")
    k = _randn(gen, (cb, s, kv, d), dt, "cuda")
    v = _randn(gen, (cb, s, kv, d), dt, "cuda")
    off = torch.linspace(0, s - ct, cb, device="cuda").round().to(
        torch.int32) * int(spread)
    shape = f"{label} B{cb} T{ct} S{s} H{h} KV{kv} D{d} q_offset " \
        f"{off.tolist()} bf16"
    got = prefill_attention_cuda(q, k, v, None, off)
    err, ok = close(got, ref.prefill_attention_ref(q, k, v, None, off),
                    TOL["prefill", "bfloat16"])
    if not ok:
        fail(f"prefill at {shape}: err {err}")
    qpos = off[:, None] + torch.arange(ct, device="cuda")[None, :]
    mask = (torch.arange(s, device="cuda")[None, None, :]
            <= qpos[:, :, None])[:, None]             # (B, 1, T, S)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    times = _times(
        lambda: prefill_attention_cuda(q, k, v, None, off),
        lambda: ref.prefill_attention_ref(q, k, v, None, off),
        lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                               enable_gqa=True))
    visible = int((off.long() + ct).sum())     # keys each row's chunk sees
    pairs = int((ct * off.long() + ct * (ct + 1) // 2).sum())
    nbytes = 2 * cb * ct * h * d * el + 2 * visible * kv * d * el + 4 * cb
    flops = 4 * pairs * h * d
    return _record(
        "prefill_attention", "src/repro_torch/csrc/prefill_attention.cu",
        "src/repro/kernels/prefill_attention.py:128", err, times, nbytes,
        flops, "bfloat16", shape)


def _sub_record(rec: dict) -> dict:
    """The measured numbers of a kernel record at a second shape, nested
    in the kernel's main record."""
    return {key: rec[key] for key in ("ms", "plain_ms", "bound_ms",
                                      "bound_by", "library_ms",
                                      "max_abs_err", "shape")}


def bench_main_shapes(gen) -> dict:
    """Kernel vs plain vs library at the serving phase's shapes."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.prefill_attention import prefill_attention_cuda
    dt = torch.bfloat16
    el = 2
    h, kv, d = MAIN["heads"], MAIN["kv_heads"], MAIN["head_dim"]
    s = MAIN["cache_len"]
    out = {"decode_attention": _bench_decode(
        gen, b=MAIN["device_slots"], h=h, kv=kv, d=d, s=s,
        layers=MAIN["layers"], lo=MAIN["prompt_len"] + 1,
        hi=MAIN["prompt_len"] + MAIN["output_len"] + 1)}

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


def bench_chunk_shape(gen) -> dict:
    """Prefill attention at a chunk of llama's chunked path: 2 device + 4
    host staging rows, 64 tokens each, into a 512 cache."""
    rec = _bench_chunk(gen, cb=CHAT["device_slots"] + CHAT["host_slots"],
                       ct=64, s=CHAT["cache_len"], h=MAIN["heads"],
                       kv=MAIN["kv_heads"], d=MAIN["head_dim"])
    return _sub_record(rec)


def bench_moe_shapes(gen) -> dict:
    """Both attention kernels at deepseek-moe-16b's serving shapes (MHA:
    group 1, head_dim 128): decode over the 2 device rows of 28 layers'
    caches, and the first admission bucket (6 prompts of 128)."""
    m = MOE_SERVE
    dec = _bench_decode(gen, b=m["device_slots"], h=m["heads"],
                        kv=m["kv_heads"], d=m["head_dim"],
                        s=m["cache_len"], layers=m["layers"],
                        lo=m["prompt_len"] + 1,
                        hi=m["prompt_len"] + m["output_len"] + 1)
    pre = _bench_chunk(gen, cb=m["device_slots"] + m["host_slots"],
                       ct=m["prompt_len"], s=m["cache_len"], h=m["heads"],
                       kv=m["kv_heads"], d=m["head_dim"],
                       label="deepseek bucket", spread=False)
    return {"decode_attention": _sub_record(dec),
            "prefill_attention": _sub_record(pre)}


def _bench_span(gen, *, b, t, h, kv, d, causal=True, prefix=0,
                label="span") -> dict:
    """Prefill attention over a span of its own (S = T, the stateless
    forward's shape): causal with a prefix-LM prefix, or full attention
    (the encoder); kernel vs plain version vs SDPA with the mask made
    explicit.  The bound counts the (query, key) pairs the mask leaves
    visible."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.prefill_attention import prefill_attention_cuda
    dt, el = torch.bfloat16, 2
    q = _randn(gen, (b, t, h, d), dt, "cuda")
    k = _randn(gen, (b, t, kv, d), dt, "cuda")
    v = _randn(gen, (b, t, kv, d), dt, "cuda")
    pre = torch.full((b,), prefix, dtype=torch.int32, device="cuda")
    shape = f"{label} B{b} T{t} H{h} KV{kv} D{d} " + (
        f"causal, prefix_len {prefix}" if causal else "full") + " bf16"
    got = prefill_attention_cuda(q, k, v, pre, causal=causal)
    err, ok = close(got, ref.prefill_attention_ref(q, k, v, pre,
                                                   causal=causal),
                    TOL["prefill", "bfloat16"])
    if not ok:
        fail(f"prefill at {shape}: err {err}")
    idx = torch.arange(t, device="cuda")
    mask = ((idx[None, :] <= idx[:, None]) | (idx[None, :] < prefix)) \
        if causal else torch.ones((t, t), dtype=torch.bool, device="cuda")
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    times = _times(
        lambda: prefill_attention_cuda(q, k, v, pre, causal=causal),
        lambda: ref.prefill_attention_ref(q, k, v, pre, causal=causal),
        lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask if causal else None, enable_gqa=True))
    pairs = b * int(mask.sum())
    nbytes = 2 * b * t * h * d * el + 2 * b * t * kv * d * el + 4 * b
    flops = 4 * pairs * h * d
    return _record(
        "prefill_attention", "src/repro_torch/csrc/prefill_attention.cu",
        "src/repro/kernels/prefill_attention.py:128", err, times, nbytes,
        flops, "bfloat16", shape)


def check_fma_new_dims(gen) -> None:
    """The fp32 (FMA) prefill kernel at head_dims 80, 160 and 256 against
    the fp32 plain version at the 1e-5 bar: full attention over a ragged
    T, and causal with a prefix past the first query blocks, over an
    fp32 and a bf16 cache."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.prefill_attention import prefill_attention_cuda
    for (h, kv, d), kv_dtype in (((16, 16, 80), torch.float32),
                                 ((32, 8, 160), torch.bfloat16),
                                 ((8, 1, 256), torch.float32),
                                 ((8, 1, 256), torch.bfloat16)):
        b, t = 2, 100
        q = _randn(gen, (b, t, h, d), torch.float32, "cuda")
        k = _randn(gen, (b, t, kv, d), kv_dtype, "cuda")
        v = _randn(gen, (b, t, kv, d), kv_dtype, "cuda")
        pre = torch.tensor([70, 5], dtype=torch.int32, device="cuda")
        for causal in (True, False):
            err, ok = close(prefill_attention_cuda(q, k, v, pre,
                                                   causal=causal),
                            ref.prefill_attention_ref(q, k, v, pre,
                                                      causal=causal), 1e-5)
            log(f"  prefill fp32 FMA H{h} KV{kv} D{d} cache "
                f"{dtype_name(kv_dtype)} causal={causal}: max_abs_err "
                f"{err:.3e}")
            if not ok:
                fail(f"fp32 prefill at D {d}, causal={causal}: err {err}")


def bench_registry_shapes(gen) -> dict:
    """Both attention kernels at the reference registry's published head
    geometries (``REGISTRY_ATTN``): decode over B 4 rows of a 512 cache,
    a causal bucket of B 4 prompts of 128, the VLM's prefix-LM span and
    the encoder's full attention over T 500."""
    r = REGISTRY_BENCH
    out = {"decode_attention": {}, "prefill_attention": {}}
    for name, (h, kv, d) in REGISTRY_ATTN.items():
        out["decode_attention"][name] = _sub_record(_bench_decode(
            gen, b=r["rows"], h=h, kv=kv, d=d, s=r["cache_len"],
            layers=r["layers"], lo=r["lo"], hi=r["hi"]))
        out["prefill_attention"][name] = _sub_record(_bench_chunk(
            gen, cb=r["rows"], ct=r["prompt_len"], s=r["cache_len"], h=h,
            kv=kv, d=d, label=f"{name} bucket", spread=False))
    out["prefill_attention"]["paligemma-3b prefix"] = _sub_record(
        _bench_span(gen, b=VLM["rows"], t=VLM["patches"] + VLM["text"],
                    h=8, kv=1, d=256, prefix=VLM["patches"],
                    label="paligemma-3b patches + text"))
    out["prefill_attention"]["hubert-xlarge"] = _sub_record(_bench_span(
        gen, b=ENCODER["rows"], t=ENCODER["frames"], h=16, kv=16, d=80,
        causal=False, label="hubert-xlarge frames"))
    return out


def ptxas_report(logs: dict) -> None:
    """Every kernel instantiation's registers and spill bytes from the
    ``-Xptxas -v`` build logs, one line each under chiprun_out/, and a
    line per (source, head_dim) here; any spill is printed by name."""
    import re
    import shutil
    entries = []
    for src, text in logs.items():
        name, spill = None, None
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                name = m.group(1)
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                spill = (int(m.group(1)), int(m.group(2)))
                continue
            m = re.search(r"Used (\d+) registers", line)
            if m and name is not None:
                entries.append([src, name, int(m.group(1)), spill or (0, 0)])
                name, spill = None, None
    if shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(
            e[1] for e in entries), capture_output=True, text=True).stdout
        for e, dem in zip(entries, names.splitlines()):
            e[1] = dem.replace("(anonymous namespace)::", "").split(
                "(")[0].replace("void ", "").strip()
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "ptxas.txt").write_text("".join(
        f"{src}\t{name}\t{regs} registers\t{st} B spill stores\t{ld} B "
        f"spill loads\n" for src, name, regs, (st, ld) in entries))
    groups = {}
    for src, name, regs, (st, ld) in entries:
        args = re.search(r"<(.*)>", name)
        dims = [a for a in (args.group(1).split(", ") if args else [])
                if a.strip().isdigit() and int(a) >= 32]
        key = (src, name.split("<")[0].split("::")[-1],
               dims[0] if dims else "-")
        g = groups.setdefault(key, [10**9, 0, 0, 0])
        g[0], g[1] = min(g[0], regs), max(g[1], regs)
        g[2], g[3] = g[2] + st, g[3] + ld
        if st or ld:
            log(f"  [ptxas] {name}: {regs} registers, {st} B spill stores, "
                f"{ld} B spill loads")
    for (src, kern, dim), (lo, hi, st, ld) in sorted(
            groups.items(), key=lambda kv: (kv[0][:2], int(kv[0][2])
                                            if kv[0][2].isdigit() else 0)):
        log(f"  [ptxas] {kern} D {dim}: {lo}-{hi} registers, spills "
            f"{st} B stored / {ld} B loaded over its instantiations")
    log(f"  [ptxas] {len(entries)} instantiations; one line each in "
        f"chiprun_out/ptxas.txt")


def check_bwd_builds(logs: dict) -> None:
    """The backward kernels' builds: the wgmma route's dK/dV and dQ
    kernels at D 64 and 128 are in the attention library (their ptxas
    entries name them), and the scan backward takes at most 128
    registers a thread with no spill (two CTAs of 256 threads an SM)."""
    import re
    att = logs.get("prefill_attention_bwd", "")
    for kern in ("dkdv_wgmma_kernel", "dq_wgmma_kernel"):
        for d in (64, 128):
            if not re.search(rf"{kern}ILi{d}E", att):
                fail(f"no {kern}<{d}> in the attention backward's build")
    name = None
    for line in logs.get("mamba_scan_bwd", "").splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name and "scan_bwd_kernel" in name and int(m.group(1)):
            fail(f"{name} spills {m.group(1)} bytes")
        m = re.search(r"Used (\d+) registers", line)
        if m and name and "scan_bwd_kernel" in name:
            n = name.split("ILi")[1].split("E")[0]
            log(f"  [ptxas] scan backward N {n}: {m.group(1)} registers, "
                "no spill")
            if int(m.group(1)) > 128:
                fail(f"{name} takes {m.group(1)} registers (at most 128)")
    log("  [ptxas] attention backward: dkdv_wgmma_kernel and "
        "dq_wgmma_kernel built at D 64 and 128")


def graph_launches(fn, calls: int, kernel) -> dict:
    """What ``calls`` calls of ``fn`` put on the stream, by graph node
    type, with launches of ``kernel`` (a name, or a tuple of names) apart:
    the calls are captured in
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
        names = (kernel,) if isinstance(kernel, str) else kernel
        kinds["kernel" if any(k in node for k in names) else
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
            "bound_by": by, "library_ms": times["library_ms"],
            "shape": shape}


# ---------------------------------------------------------------------------
# phase 2: the backward kernels (training)
# ---------------------------------------------------------------------------

# attention backward cases, (label, B, T, H, KV, D, causal, prefix, dtype):
# llama3.1-8b's and Jamba's training shapes, the registry's other head
# geometries, an fp32 (FMA) case, and the wgmma route's ragged edges: T
# not a multiple of its 64-query and 64-key tiles, and a prefix that
# ends inside a key block
ATTN_BWD_CASES = [
    ("llama3.1-8b train", 2, 1024, 32, 8, 128, True, 0, "bfloat16"),
    ("jamba train", 1, 1024, 64, 8, 128, True, 0, "bfloat16"),
    ("internlm2-20b G6", 2, 256, 48, 8, 128, True, 0, "bfloat16"),
    ("llama3-405b G16", 1, 256, 128, 8, 128, True, 0, "bfloat16"),
    ("stablelm-12b D160", 2, 256, 32, 8, 160, True, 0, "bfloat16"),
    ("paligemma-3b prefix", 2, 288, 8, 1, 256, True, 256, "bfloat16"),
    ("hubert-xlarge full", 2, 500, 16, 16, 80, False, 0, "bfloat16"),
    ("llama3.1-8b fp32", 1, 128, 32, 8, 128, True, 0, "float32"),
    ("ragged T 1000 G4", 1, 1000, 16, 4, 128, True, 0, "bfloat16"),
    ("prefix 200 over a key block", 2, 320, 16, 4, 128, True, 200,
     "bfloat16"),
]
# bf16 gradients carry the probabilities and dS rounded to bf16 before the
# products; fp32 ones differ from the plain version by sums in other
# orders (each bar relative to the gradient's largest |element|)
BWD_TOL = {"bfloat16": 2e-2, "float32": 1e-5}
# scan backward cases, (label, B, T, I, N): a reduced width, one whose T
# is not a multiple of the 16-step checkpoint interval, Jamba's at T
# 256, and Jamba's training shape (the train phase's B 1 x T 1024),
# where the record is taken
SCAN_BWD_CASES = [("reduced", 2, 256, 1024, 16),
                  ("ragged T 1000", 2, 1000, 1024, 16),
                  ("jamba", 2, 256, 16384, 16),
                  ("jamba train", 1, 1024, 16384, 16)]
# the scan's gradients sum 16384 channels (db, dc) and B*T steps (dA, dD)
# in other orders than the plain loop
SCAN_BWD_TOL = 1e-4


def _rel_err(got, want) -> float:
    """max |got - want| over max |want| (gradients sum over T and G)."""
    g, w = got.float(), want.float()
    return float((g - w).abs().max()) / max(float(w.abs().max()), 1e-12)


def _attn_bwd_case(gen, b, t, h, kv, d, causal, prefix, dtype):
    import torch
    dt = getattr(torch, dtype)
    q = _randn(gen, (b, t, h, d), dt, "cuda")
    k = _randn(gen, (b, t, kv, d), dt, "cuda")
    v = _randn(gen, (b, t, kv, d), dt, "cuda")
    do = _randn(gen, (b, t, h, d), dt, "cuda")
    pre = torch.full((b,), prefix, dtype=torch.int32, device="cuda")
    return q, k, v, do, pre


def check_attention_bwd(gen) -> dict:
    """The attention backward kernel against the plain backward at every
    case of ``ATTN_BWD_CASES`` (on the kernel forward's output and
    log-sum-exp, itself held to the plain log-sum-exp), twice, bitwise
    the same; returns (max |err|, max |err| / max |grad|) per case."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.prefill_attention import (
        prefill_attention_bwd_cuda, prefill_attention_bwd_route,
        prefill_attention_cuda)
    errs = {}
    for label, b, t, h, kv, d, causal, prefix, dtype in ATTN_BWD_CASES:
        q, k, v, do, pre = _attn_bwd_case(gen, b, t, h, kv, d, causal,
                                          prefix, dtype)
        out, lse = prefill_attention_cuda(q, k, v, pre, causal=causal,
                                          return_lse=True)
        _, lse_ref = ref.prefill_attention_ref(q, k, v, pre, causal=causal,
                                               return_lse=True)
        lse_err = float((lse - lse_ref).abs().max())
        got = prefill_attention_bwd_cuda(q, k, v, out, lse, do, pre,
                                         causal=causal)
        again = prefill_attention_bwd_cuda(q, k, v, out, lse, do, pre,
                                           causal=causal)
        want = ref.prefill_attention_bwd_ref(q, k, v, out, lse, do, pre,
                                             causal)
        torch.cuda.synchronize()
        err = max(_rel_err(g, w) for g, w in zip(got, want))
        abs_err = max(float((g.float() - w.float()).abs().max())
                      for g, w in zip(got, want))
        same = all(torch.equal(a, g) for a, g in zip(again, got))
        route = prefill_attention_bwd_route(d, q.dtype)
        log(f"  prefill_attention_bwd {label} B{b} T{t} H{h} KV{kv} D{d} "
            f"{'causal' if causal else 'full'}"
            f"{f', prefix {prefix}' if prefix else ''} {dtype} ({route}): "
            f"dq/dk/dv "
            f"max |err| / max |grad| {err:.3e} (bar {BWD_TOL[dtype]}), lse "
            f"max |err| {lse_err:.3e}, repeat bitwise {same}")
        if err > BWD_TOL[dtype] or lse_err > 1e-3 or not same:
            fail(f"prefill_attention_bwd at {label}: rel err {err}, lse "
                 f"err {lse_err}, repeat bitwise {same}")
        errs[label] = (abs_err, err)
        del q, k, v, do, out, lse, got, again, want
    return errs


def _attn_bwd_bound(b, t, h, kv, d, pairs, el):
    """Bytes: q, k, v, o, dO and lse read once, dq, dk, dv written once;
    operations: the five products over the visible (query, key) pairs
    (S = QK^T again, dP = dO V^T, dV = P^T dO, dK = dS^T Q, dQ = dS K),
    10 * D flops per pair and query head."""
    nbytes = el * (4 * b * t * h * d + 4 * b * t * kv * d) + 4 * b * h * t
    return nbytes, 10 * pairs * h * d


def bench_attention_bwd(gen, errs) -> dict:
    """The record: the attention backward at llama3.1-8b's training shape
    (B 2, T 1024, 32/8 heads of 128, causal, bf16) -- kernel, plain
    backward, and as the yardstick ``scaled_dot_product_attention``'s
    backward alone (``torch.autograd.grad`` on a saved output, the graph
    retained; timed only), its forward + backward beside it; Jamba's
    shape (64/8) too."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.prefill_attention import (
        prefill_attention_bwd_cuda, prefill_attention_bwd_route,
        prefill_attention_cuda)
    rec = None
    for label, b, t, h, kv, d, causal, prefix, dtype in ATTN_BWD_CASES[:2]:
        q, k, v, do, pre = _attn_bwd_case(gen, b, t, h, kv, d, causal,
                                          prefix, dtype)
        out, lse = prefill_attention_cuda(q, k, v, pre, return_lse=True)
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        dot = do.transpose(1, 2)

        def sdpa_fwd_bwd():
            o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                               enable_gqa=True)
            return torch.autograd.grad(o, (qt, kt, vt), dot)

        saved = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                               enable_gqa=True)

        def library():
            return torch.autograd.grad(saved, (qt, kt, vt), dot,
                                       retain_graph=True)

        def kernel():
            return prefill_attention_bwd_cuda(q, k, v, out, lse, do, pre)

        def plain():
            return ref.prefill_attention_bwd_ref(q, k, v, out, lse, do, pre)

        def fwd_bwd():
            o, s = prefill_attention_cuda(q, k, v, pre, return_lse=True)
            return prefill_attention_bwd_cuda(q, k, v, o, s, do, pre)

        shape = f"{label} B{b} T{t} H{h} KV{kv} D{d} causal {dtype}"
        if rec is None:
            times = _times(kernel, plain, library)
            pairs = b * t * (t + 1) // 2
            nbytes, flops = _attn_bwd_bound(b, t, h, kv, d, pairs, 2)
            rec = _record("prefill_attention_bwd",
                          "src/repro_torch/csrc/prefill_attention_bwd.cu",
                          "src/repro/kernels/prefill_attention.py:128",
                          errs[label][0], times, nbytes, flops,
                          "bfloat16", shape)
            rec["library"] = ("torch.nn.functional.scaled_dot_product_"
                              "attention backward alone (autograd.grad on "
                              "a saved output)")
            # "route" stays "cuda" (the record's contract); which of the
            # library's three kernel pairs ran goes beside it
            rec["kernel_route"] = prefill_attention_bwd_route(d, q.dtype)
            rec["cases_rel_err"] = {k: v[1] for k, v in errs.items()}
        fb = time_ms(fwd_bwd, reps=10)
        lib_fb = time_ms(sdpa_fwd_bwd, reps=10)
        lib = time_ms(library, reps=10)
        bwd = time_ms(kernel, reps=10)
        log(f"  {shape}: CUDA events per call: backward kernel {bwd:.4f} "
            f"ms, forward + backward kernels {fb:.4f} ms; SDPA backward "
            f"alone {lib:.4f} ms, forward + backward {lib_fb:.4f} ms "
            f"[{CARD}]")
        rec.setdefault("fwd_bwd", {})[label] = {
            "ms_events": fb, "library_fwd_bwd_ms_events": lib_fb,
            "library_bwd_ms_events": lib, "bwd_ms_events": bwd}
        del q, k, v, do, out, lse, qt, kt, vt, saved
    return rec


def scan_bwd_bound(b: int, t: int, i: int, n: int) -> dict:
    """Bytes: dt, x, dy, b, c, A, D, h0 read once, ddt, dx, db, dc, dA, dD,
    dh0 written once (fp32); operations: the B*T*I*N exp(dt A) factors
    on the SFUs and ~14 fp32 flops per state and step."""
    nbytes = (3 * b * t * i * 4 + 2 * b * t * n * 4 + i * n * 4 + i * 4
              + b * i * n * 4                          # inputs
              + 2 * b * t * i * 4 + 2 * b * t * n * 4 + i * n * 4 + i * 4
              + b * i * n * 4)                         # gradients
    exps = b * t * i * n
    flops = 14 * exps
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_exp = exps / PEAK_EXP_PER_S * 1e3
    t_flop = flops / PEAK_FLOPS["float32"] * 1e3
    bound = max(t_bytes, t_exp, t_flop)
    return {"bound_ms": bound,
            "bound_by": "bytes" if t_bytes >= max(t_exp, t_flop)
            else "operations", "bytes": nbytes, "exp": exps,
            "flops": flops, "t_bytes": t_bytes, "t_exp": t_exp,
            "t_flop": t_flop}


def bench_scan_bwd(gen) -> dict:
    """The scan's backward kernel against the plain backward at
    ``SCAN_BWD_CASES`` (with and without the final state's gradient;
    twice, bitwise the same), and its record at the last case, Jamba's
    training shape (I 16384, N 16, B 1 x T 1024); no PyTorch call
    computes it (library: none)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.mamba_scan import mamba_selective_scan_bwd_cuda
    rec = None
    for label, b, t, i, n in SCAN_BWD_CASES:
        args = _scan_case(gen, b, t, i, n, torch.float32)
        dy = _randn(gen, (b, t, i), torch.float32, "cuda")
        dh = _randn(gen, (b, i, n), torch.float32, "cuda")
        err = abs_err = 0.0
        for dh_final in (dh, None):
            got = mamba_selective_scan_bwd_cuda(*args, dy, dh_final)
            again = mamba_selective_scan_bwd_cuda(*args, dy, dh_final)
            want = ref.mamba_selective_scan_bwd_ref(*args, dy, dh_final)
            torch.cuda.synchronize()
            e = max(_rel_err(g, w) for g, w in zip(got, want))
            same = all(torch.equal(a, g) for a, g in zip(again, got))
            if e > SCAN_BWD_TOL or not same:
                fail(f"mamba_scan_bwd at {label}: rel err {e}, repeat "
                     f"bitwise {same}")
            err = max(err, e)
            abs_err = max(abs_err, max(float((g - w).abs().max())
                                       for g, w in zip(got, want)))
        del got, again, want
        kernel = lambda: mamba_selective_scan_bwd_cuda(*args, dy)
        plain = lambda: ref.mamba_selective_scan_bwd_ref(*args, dy)
        # CUDA events: a call is one long kernel and its reduction, longer
        # than its enqueue; the profiler dropped records of it (0.576
        # against 0.956 ms in one call on one H100)
        kms = time_ms(kernel, reps=10)
        dev = device_ms(kernel, reps=10) or float("nan")
        plain_ms = time_ms(plain, warmup=1, reps=2, rounds=2)
        bd = scan_bwd_bound(b, t, i, n)
        log(f"  mamba_selective_scan_bwd {label} B{b} T{t} I{i} N{n} fp32: "
            f"max |err| {abs_err:.3e}, max |err| / max |grad| {err:.3e} "
            f"(bar {SCAN_BWD_TOL}), repeat bitwise; time per call (events): "
            f"kernel {kms:.5f} ms (profiler {dev:.5f} ms), plain "
            f"{plain_ms:.3f} ms; {_bound_text(bd)}, kernel at "
            f"{100 * bd['bound_ms'] / kms:.2f}% of bound [{CARD}]")
        rec = {"name": "mamba_selective_scan_bwd", "route": "cuda",
               "source": "src/repro_torch/csrc/mamba_scan_bwd.cu",
               "replaces": "src/repro/kernels/mamba_scan.py:87",
               "launches": 0, "max_abs_err": abs_err, "rel_err": err,
               "ms": kms, "plain_ms": plain_ms, "bound_ms": bd["bound_ms"],
               "bound_by": bd["bound_by"], "library_ms": None,
               "shape": f"{label} B{b} T{t} I{i} N{n} fp32"}
        del args, dy, dh
    return rec


def phase_kernels_bwd(gen) -> dict:
    errs = check_attention_bwd(gen)
    return {"prefill_attention_bwd": bench_attention_bwd(gen, errs),
            "mamba_selective_scan_bwd": bench_scan_bwd(gen)}


def phase_kernels() -> dict:
    import torch
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    logs = build.build()
    log(f"built {', '.join(build.KERNELS)} with nvcc in "
        f"{time.perf_counter() - t0:.1f} s")
    ptxas_report(logs)
    check_bwd_builds(logs)
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
    # last, so every earlier case draws the inputs it drew without them
    records["prefill_attention"]["chunk_shape"] = bench_chunk_shape(gen)
    for name, rec in bench_moe_shapes(gen).items():
        records[name]["moe_shape"] = rec
    # last again, so every earlier case draws the inputs it drew: the
    # registry's head geometries
    check_fma_new_dims(gen)
    for name, recs in bench_registry_shapes(gen).items():
        records[name]["registry_shapes"] = recs
    # last again: the backward kernels (training)
    records.update(phase_kernels_bwd(gen))
    # last again: the xLSTM recurrences
    records.update(phase_kernels_xlstm(gen))
    return records


# ---------------------------------------------------------------------------
# phase 2: the xLSTM recurrences (forward and backward)
# ---------------------------------------------------------------------------

# xlstm-125m's recurrences: the sLSTM over d 768 (4 heads of 192, bf16
# recurrent gates), the mLSTM over inner 1536 (4 heads of 384); serving-
# xlstm's chat traffic decodes 2 device rows and prefills chunks of 64
# tokens; one long call of 4096 tokens; the train phase's B 2 x T 1024
XLSTM = dict(heads=4, slstm_hd=192, mlstm_hd=384, rows=2, chunk=64,
             long=4096, train_rows=2, train_seq=1024, cut=17)
XLSTM_TOL = 1e-5        # |kernel - plain| over the largest |value|
XLSTM_LONG_TOL = 1e-4   # the mLSTM at T 4096 (the measured ratio printed)
XLSTM_BWD_TOL = 1e-4    # of each gradient's largest |element|
# The mLSTM backward kernel is held against its plain version run in
# float64 on the same (fp32) values: the mLSTM's gradient jumps where
# |n . q| crosses the clamp at 1, and at B 2 x T 1024 one step's |n . q|
# is 0.99999999698 in float64, 1.0000004768 by the plain fp32 walk and
# <= 1 by the kernel (one H100 80GB HBM3, 700.00 W): the fp32 walk alone
# takes the far side there and parts from both by 0.61 of the largest
# dq.  The fp32 plain version's difference is printed beside.
# The sLSTM at T 4096 is held against a float64 loop instead: its
# stabiliser m drifts up to ~2000 over such a call, where fp32 rounds
# f + m to ~1e-4, so any two fp32 versions part by ~1e-3 of the largest
# h, and the plain version itself lies 1.4e-3 to 3.0e-3 from float64.
# In each of XLSTM_F64_DRAWS draws the kernel's error against float64
# must be within XLSTM_F64_FACTOR times the plain version's: the draws
# read 0.825x, 0.584x and 1.348x on one H100 80GB HBM3, 700.00 W.
XLSTM_F64_FACTOR = 2
XLSTM_F64_DRAWS = 3
# the mLSTM forward's chunkwise route (no lens, T at or above the
# crossover) is a sequence of four kernels, its launch count counts calls:
# the stabiliser's scan, the boundary memories, each chunk's masked
# products and the output tiles
MLSTM_FWD_PARTS = ("mlstm_fwd_gates", "mlstm_fwd_bounds", "mlstm_fwd_chunk",
                   "mlstm_fwd_out")
XLSTM_KERNELS = {
    # name: (wrapper, its kernels' names in a graph dump, source, replaces)
    "slstm_recurrence": ("slstm_scan_cuda", ("slstm_scan_kernel",),
                         "src/repro_torch/csrc/slstm_scan.cu",
                         "src/repro/models/ssm.py:246"),
    "mlstm_recurrence": ("mlstm_scan_cuda",
                         ("mlstm_scan_kernel",) + MLSTM_FWD_PARTS,
                         "src/repro_torch/csrc/mlstm_scan.cu",
                         "src/repro/models/ssm.py:369"),
    "slstm_recurrence_bwd": ("slstm_scan_bwd_cuda", ("slstm_bwd_kernel",),
                             "src/repro_torch/csrc/slstm_scan_bwd.cu",
                             "src/repro/models/ssm.py:246"),
    "mlstm_recurrence_bwd": ("mlstm_scan_bwd_cuda", ("mlstm_bwd_",),
                             "src/repro_torch/csrc/mlstm_scan_bwd.cu",
                             "src/repro/models/ssm.py:369"),
}
# the mLSTM backward's call is a sequence of six kernels (chunkwise-
# parallel), its launch count counts calls: the stabiliser's scan, the
# boundary memories, the per-chunk products, the carried gradients, the
# intra-chunk gradients and the gates' chain
MLSTM_BWD_PARTS = ("mlstm_bwd_gates_fwd", "mlstm_bwd_bounds",
                   "mlstm_bwd_chunk", "mlstm_bwd_carry", "mlstm_bwd_intra",
                   "mlstm_bwd_gates")


def _slstm_case(gen, b, t):
    """gates_x, r (bf16, as served), bias and a carried state c, n, h, m
    at xlstm-125m's sLSTM shapes."""
    import torch
    nh, hd = XLSTM["heads"], XLSTM["slstm_hd"]
    d = nh * hd
    return [_randn(gen, (b, t, 4 * d), torch.float32, "cuda"),
            (_randn(gen, (nh, hd, 4 * hd), torch.float32, "cuda")
             / hd ** 0.5).to(torch.bfloat16),
            0.1 * _randn(gen, (4 * d,), torch.float32, "cuda"),
            _randn(gen, (b, nh, hd), torch.float32, "cuda"),
            1.0 + _randn(gen, (b, nh, hd), torch.float32, "cuda").abs(),
            _randn(gen, (b, nh, hd), torch.float32, "cuda"),
            _randn(gen, (b, nh, hd), torch.float32, "cuda")]


def _mlstm_case(gen, b, t):
    """q, k, v, i_pre, f_pre and a carried state cmat, n, m at
    xlstm-125m's mLSTM shapes."""
    import torch
    nh, hd = XLSTM["heads"], XLSTM["mlstm_hd"]
    q, k, v = (_randn(gen, (b, t, nh, hd), torch.float32, "cuda")
               for _ in range(3))
    return [q, k / hd ** 0.5, v,
            _randn(gen, (b, t, nh), torch.float32, "cuda"),
            torch.nn.functional.logsigmoid(
                _randn(gen, (b, t, nh), torch.float32, "cuda") + 2.0),
            0.3 * _randn(gen, (b, nh, hd, hd), torch.float32, "cuda"),
            0.3 * _randn(gen, (b, nh, hd), torch.float32, "cuda"),
            _randn(gen, (b, nh), torch.float32, "cuda")]


def _xlstm_fns(kind):
    """(case maker, kernel wrapper, plain version, number of per-step
    inputs) of one recurrence."""
    from repro_torch.kernels import ref, xlstm
    if kind == "slstm":
        return (_slstm_case, xlstm.slstm_scan_cuda,
                ref.slstm_recurrence_ref, 1)
    return _mlstm_case, xlstm.mlstm_scan_cuda, ref.mlstm_recurrence_ref, 5


def xlstm_bound(name: str, b: int, t: int) -> dict:
    """The least time of one call at xlstm-125m's shapes, from the
    formulas the dry-run counts with (``analysis.xlstm_costs``): every
    input byte read once and every output byte written once, against the
    fp32 operations on the CUDA cores (67 TFLOP/s)."""
    import torch
    from repro_torch.launch.analysis import xlstm_costs
    nh = XLSTM["heads"]
    if name.startswith("slstm"):
        hd = XLSTM["slstm_hd"]
        shapes = dict(gates=(b, t, 4 * nh * hd), state=(b, nh, hd),
                      dtype=torch.bfloat16,
                      save=name == "slstm_recurrence" and t == XLSTM[
                          "train_seq"])
    else:
        shapes = dict(q=(b, t, nh, XLSTM["mlstm_hd"]), dtype=torch.float32)
    flops, nbytes = xlstm_costs(name, shapes)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_flop = flops / PEAK_FLOPS["float32"] * 1e3
    return {"bound_ms": max(t_bytes, t_flop),
            "bound_by": "bytes" if t_bytes >= t_flop else "operations",
            "bytes": nbytes, "flops": flops}


def _slstm_f64(gx, r, bias, c, n, h, m):
    """The sLSTM's emitted h by ``ref.slstm_recurrence_ref``'s loop in
    float64 (every token real)."""
    import torch
    b, t = gx.shape[:2]
    nh, hd = r.shape[0], r.shape[1]
    gx, r, bias, c, n, h, m = (x.double() for x in (gx, r, bias, c, n, h,
                                                    m))
    bias = bias.reshape(nh, 4 * hd)
    hs = []
    for i in range(t):
        g = gx[:, i].reshape(b, nh, 4 * hd) \
            + torch.einsum("bhd,hde->bhe", h, r) + bias
        i_t, f_t, z_t, o_t = g.chunk(4, dim=-1)
        m_new = torch.maximum(f_t + m, i_t)
        i_g, f_g = torch.exp(i_t - m_new), torch.exp(f_t + m - m_new)
        c = f_g * c + i_g * torch.tanh(z_t)
        n = f_g * n + i_g
        h = torch.sigmoid(o_t) * c / torch.clamp(n.abs(), min=1e-6)
        m = m_new
        hs.append(h)
    return torch.stack(hs, dim=1)


def _slstm_long_f64(gen):
    """The sLSTM kernel and its plain version over one call of T 4096
    (a carried state, then the zero state, alternately), each against
    the float64 loop, as a share of the largest |h|: the worst kernel
    error over the draws, the worst ratio of the kernel's error to the
    plain version's in one draw, and the worst kernel-against-plain.
    Each draw's pair is printed."""
    from repro_torch.kernels import ref, xlstm
    k_err = ratio = kp = 0.0
    for draw in range(XLSTM_F64_DRAWS):
        args = _slstm_case(gen, 1, XLSTM["long"])
        if draw % 2:
            args[3:6] = [x.zero_() for x in args[3:6]]
            args[6].fill_(-1e30)
        got = xlstm.slstm_scan_cuda(*args)[0]
        plain = ref.slstm_recurrence_ref(*args)[0]
        exact = _slstm_f64(*args)
        scale = float(exact.abs().max())
        k_draw = float((got.double() - exact).abs().max()) / scale
        p_draw = float((plain.double() - exact).abs().max()) / scale
        log(f"  slstm_recurrence at T {XLSTM['long']}, draw {draw}: against "
            f"float64 kernel {k_draw:.3e}, plain {p_draw:.3e} of the "
            f"largest |h| ({k_draw / p_draw:.3f}x)")
        k_err, ratio = max(k_err, k_draw), max(ratio, k_draw / p_draw)
        kp = max(kp, _rel_err(got, plain))
        del args, got, plain, exact
    return k_err, ratio, kp


def _mlstm_chunkwise_checks(gen) -> str:
    """The mLSTM forward's chunkwise route against its plain version: at
    the train shape (B 2 x T 1024) from a carried state and from the zero
    state (m0 = -1e30) within XLSTM_TOL of the largest |value|, at the
    long call (B 1 x T 4096) within XLSTM_LONG_TOL, each bitwise on
    repeat and its route printed.  Returns the long call's text."""
    import torch
    from repro_torch.kernels import ref, xlstm
    long_text = ""
    for b, t, state in ((XLSTM["train_rows"], XLSTM["train_seq"], "carried"),
                        (XLSTM["train_rows"], XLSTM["train_seq"], "zero"),
                        (1, XLSTM["long"], "carried")):
        args = _mlstm_case(gen, b, t)
        if state == "zero":
            args[5:] = [torch.zeros_like(args[5]), torch.zeros_like(args[6]),
                        torch.full_like(args[7], -1e30)]
        route = xlstm.mlstm_scan_route(t, None)
        got = xlstm.mlstm_scan_cuda(*args)
        again = xlstm.mlstm_scan_cuda(*args)
        want = ref.mlstm_recurrence_ref(*args)
        torch.cuda.synchronize()
        err = max(_rel_err(g, w) for g, w in zip(got, want))
        same = all(torch.equal(a, g) for a, g in zip(again, got))
        bar = XLSTM_LONG_TOL if t == XLSTM["long"] else XLSTM_TOL
        log(f"  mlstm_recurrence B {b} x T {t}, {state} state: route "
            f"{route}, |kernel - plain| / max |value| {err:.3e} (bar {bar}), "
            f"repeat bitwise {same}")
        if route != "chunkwise" or err > bar or not same:
            fail(f"mlstm_recurrence B {b} x T {t} ({state} state): route "
                 f"{route}, err {err:.3e} (bar {bar}), repeat bitwise {same}")
        if t == XLSTM["long"]:
            long_text = f"{err:.3e} (bar {bar}; chunkwise route)"
        del args, got, again, want
    return long_text


def check_xlstm(gen) -> dict:
    """Both forward kernels against their plain versions at the chat
    traffic's prefill chunk (B 2 x T 64, one row ending at 40) and its
    decode (B 2 x T 1, one row frozen), both with lens, so the mLSTM
    walks: within XLSTM_TOL of the largest
    |value|, the frozen row's state bit for bit, a chunk split in T with
    the state carried bitwise one call, one launch per call (graph
    dump); then the mLSTM's chunkwise route (``_mlstm_chunkwise_checks``,
    its long call B 1 x T 4096 within XLSTM_LONG_TOL) and the sLSTM's
    long call against a float64 loop (XLSTM_F64_FACTOR).
    Returns the worst (ratio, absolute error) at the serving shapes per
    kernel."""
    import torch
    from repro_torch.kernels import xlstm
    errs = {}
    rows, chunk, cut = XLSTM["rows"], XLSTM["chunk"], XLSTM["cut"]
    for kind in ("slstm", "mlstm"):
        case, kernel, plain, nseq = _xlstm_fns(kind)
        name = f"{kind}_recurrence"
        worst = worst_abs = 0.0
        routes = []
        for t, lens_v in ((chunk, [chunk, 40]), (1, [1, 0])):
            args = case(gen, rows, t)
            lens = torch.tensor(lens_v, dtype=torch.int32, device="cuda")
            if kind == "mlstm":
                routes.append(xlstm.mlstm_scan_route(t, lens))
                if routes[-1] != "walk":
                    fail(f"{name}: a call with lens took {routes[-1]}")
            got = kernel(*args, lens)
            want = plain(*args, lens)
            torch.cuda.synchronize()
            err = max(_rel_err(g, w) for g, w in zip(got, want))
            worst = max(worst, err)
            worst_abs = max(worst_abs, max(float((g - w).abs().max())
                                           for g, w in zip(got, want)))
            if err > XLSTM_TOL:
                fail(f"{name} at B {rows} x T {t}: |kernel - plain| / max "
                     f"{err:.3e} > {XLSTM_TOL}")
            if t == 1 and not all(torch.equal(g[1], s[1]) for g, s in
                                  zip(got[1:], args[-len(got) + 1:])):
                fail(f"{name}: a row of length 0 changed its state")
            if t == chunk:
                seq, rest = args[:nseq], args[nseq:-(len(got) - 1)]
                state = args[-(len(got) - 1):]
                first = kernel(*[x[:, :cut].contiguous() for x in seq],
                               *rest, *state, torch.clamp(lens, max=cut))
                second = kernel(*[x[:, cut:].contiguous() for x in seq],
                                *rest, *first[1:],
                                torch.clamp(lens - cut, min=0))
                if not (torch.equal(torch.cat([first[0], second[0]], 1),
                                    got[0])
                        and all(torch.equal(a, b) for a, b in
                                zip(second[1:], got[1:]))):
                    fail(f"{name}: a chunk split at {cut} is not bitwise "
                         "one call")
            else:
                kinds = graph_launches(lambda: kernel(*args, lens), 10,
                                       XLSTM_KERNELS[name][1])
                if kinds != {"kernel": 10}:
                    fail(f"{name}: 10 decode calls put {kinds} on the "
                         "stream; want one launch each")
        if kind == "mlstm":
            long_text = _mlstm_chunkwise_checks(gen)
        else:
            k_err, ratio, kp = _slstm_long_f64(gen)
            long_text = (f"against float64: kernel up to {k_err:.3e}, up to "
                         f"{ratio:.3f}x the plain version's in a draw (bar "
                         f"{XLSTM_F64_FACTOR}x), kernel against plain "
                         f"{kp:.3e}")
            if ratio > XLSTM_F64_FACTOR:
                fail(f"{name} at T {XLSTM['long']}: {long_text}")
        log(f"  {name}: |kernel - plain| / max |value| {worst:.3e} at the "
            f"chunk and decode shapes (bar {XLSTM_TOL}"
            + (f"; routes {routes}" if routes else "") + f"); at B 1 x T "
            f"{XLSTM['long']} {long_text}; frozen row bitwise, split at "
            f"{cut} bitwise, one launch per call")
        errs[name] = (worst, worst_abs)
    return errs


def _to_f64(args):
    """``args`` with every tensor (also inside a tuple) in float64."""
    import torch
    return tuple(_to_f64(a) if isinstance(a, tuple) else
                 a.double() if isinstance(a, torch.Tensor) else a
                 for a in args)


def _xlstm_bwd_case(gen, kind):
    """The backward kernel's inputs at the train phase's shape: the saved
    forward (sLSTM) or the forward's inputs and h (mLSTM), dhs and the
    final state's gradients."""
    import torch
    from repro_torch.kernels import xlstm
    b, t = XLSTM["train_rows"], XLSTM["train_seq"]
    if kind == "slstm":
        gx, r, bias, c, n, h, m = _slstm_case(gen, b, t)
        hs, _, _, _, _, acts, cs, ns, ms = xlstm.slstm_scan_cuda(
            gx, r, bias, c, n, h, m, save=True)
        dhs = _randn(gen, hs.shape, torch.float32, "cuda")
        dstate = tuple(_randn(gen, c.shape, torch.float32, "cuda")
                       for _ in range(4))
        nh, hd = XLSTM["heads"], XLSTM["slstm_hd"]
        return ((r, acts, cs, ns, ms, c, n, m, dhs, dstate),
                (r, acts.reshape(b, t, nh, 4 * hd), cs, ns, ms, c, n, m, dhs,
                 dstate))
    args = _mlstm_case(gen, b, t)
    hs = xlstm.mlstm_scan_cuda(*args)[0]
    dhs = _randn(gen, hs.shape, torch.float32, "cuda")
    dstate = tuple(_randn(gen, x.shape, torch.float32, "cuda")
                   for x in args[5:])
    full = (*args, hs, dhs, dstate)
    return full, full


def _xlstm_record(name, errs, ms, plain_ms, b, t, shape) -> dict:
    bd = xlstm_bound(name, b, t)
    _, _, source, replaces = XLSTM_KERNELS[name]
    rel, err = errs
    log(f"  {name} @ {shape}: time per call: kernel {ms:.5f} ms, plain "
        f"{plain_ms:.5f} ms; bound {bd['bound_ms']:.5f} ms "
        f"({bd['bound_by']}: {bd['bytes']:.0f} B, {bd['flops']:.0f} fp32 "
        f"flop), kernel at {100 * bd['bound_ms'] / ms:.2f}% of bound; max "
        f"|kernel - plain| {err:.3e} ({rel:.3e} of the largest) [{CARD}]")
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": 0, "max_abs_err": err,
            "rel_err": rel, "ms": ms, "plain_ms": plain_ms, "bound_ms": bd["bound_ms"],
            "bound_by": bd["bound_by"], "library_ms": None, "shape": shape}


def bench_xlstm(gen, errs) -> dict:
    """Device time of each forward kernel and its plain version at the
    chat chunk with lens, as served (the records; the mLSTM's walk), at
    decode, at the long call and at the train shape (events, printed,
    with the time a step and the mLSTM's route; its chunkwise route's
    four kernels also by the profiler); each backward
    kernel against its plain version (the mLSTM's in float64) at the
    train shape
    (XLSTM_BWD_TOL of each gradient's max, bitwise on repeat) and timed
    there (events; the plain version once, in fp32), the mLSTM's also by
    the profiler, kernel by kernel.  No PyTorch call computes these
    recurrences (library: none)."""
    import torch
    from repro_torch.kernels import ref, xlstm
    records = {}
    rows, chunk = XLSTM["rows"], XLSTM["chunk"]
    for kind in ("slstm", "mlstm"):
        case, kernel, plain, _ = _xlstm_fns(kind)
        name = f"{kind}_recurrence"
        args = case(gen, rows, chunk)
        full = torch.full((rows,), chunk, dtype=torch.int32, device="cuda")
        kms = device_ms(lambda: kernel(*args, full)) or time_ms(
            lambda: kernel(*args, full))
        pms = device_ms(lambda: plain(*args, full), reps=3) or time_ms(
            lambda: plain(*args, full), warmup=1, reps=3, rounds=1)
        rec = _xlstm_record(name, errs[name], kms, pms, rows, chunk,
                            f"chat chunk B{rows} T{chunk} H4 "
                            f"hd{XLSTM[kind + '_hd']}")
        dec = case(gen, rows, 1)
        dms = time_ms(lambda: kernel(*dec))
        dpl = time_ms(lambda: plain(*dec), reps=5, rounds=3)
        dprof = device_ms(lambda: kernel(*dec))
        ld = case(gen, 1, XLSTM["long"])
        lms = time_ms(lambda: kernel(*ld), warmup=1, reps=3, rounds=3)
        dbd = xlstm_bound(name, rows, 1)
        lbd = xlstm_bound(name, 1, XLSTM["long"])
        route = (lambda t: xlstm.mlstm_scan_route(t, None)) \
            if kind == "mlstm" else (lambda t: "one kernel")
        log(f"  {name} decode B{rows} T1 (events): kernel {dms:.5f} ms "
            f"(profiler {dprof or 0.0:.5f}), "
            f"plain {dpl:.5f} ms, bound {dbd['bound_ms']:.5f} ms "
            f"({dbd['bound_by']}); long B1 T{XLSTM['long']} (events, "
            f"{route(XLSTM['long'])}): "
            f"kernel {lms:.5f} ms, bound {lbd['bound_ms']:.5f} ms "
            f"({lbd['bound_by']}) [{CARD}]")
        rec["decode"] = {"ms": dms, "profiler_ms": dprof, "plain_ms": dpl,
                         "bound_ms": dbd["bound_ms"]}
        rec["long"] = {"ms": lms, "bound_ms": lbd["bound_ms"],
                       "route": route(XLSTM["long"])}
        # the train phase's shape: the sLSTM saving what its backward reads
        tb, tt = XLSTM["train_rows"], XLSTM["train_seq"]
        tr = case(gen, tb, tt)
        kw = {"save": True} if kind == "slstm" else {}
        tms = time_ms(lambda: kernel(*tr, **kw), warmup=1, reps=3, rounds=3)
        tbd = xlstm_bound(name, tb, tt)
        log(f"  {name} train B{tb} T{tt} (events, {route(tt)}): kernel "
            f"{tms:.5f} ms, "
            f"bound {tbd['bound_ms']:.5f} ms ({tbd['bound_by']}); a step "
            f"{1e3 * kms / chunk:.3f} us at T {chunk}, "
            f"{1e3 * tms / tt:.3f} us at T {tt} [{CARD}]")
        rec["train"] = {"ms": tms, "bound_ms": tbd["bound_ms"],
                        "bound_by": tbd["bound_by"], "route": route(tt)}
        if kind == "mlstm":
            # the chunkwise call is four kernels; its count counts calls
            by_kernel = device_ms_by_kernel(lambda: kernel(*tr, **kw),
                                            reps=3)
            parts = {short: ms for short in MLSTM_FWD_PARTS
                     for key, ms in by_kernel.items()
                     if f"::{short}(" in key}
            every = sum(by_kernel.values())
            log(f"  {name} train: device ms per call by kernel (profiler) "
                + ", ".join(f"{k} {v:.5f}" for k, v in parts.items())
                + f"; every kernel {every:.5f}, the call by events "
                f"{tms:.5f} [{CARD}]")
            if set(parts) != set(MLSTM_FWD_PARTS):
                fail(f"{name}: the profiler saw {sorted(parts)} at the train "
                     f"shape, want {list(MLSTM_FWD_PARTS)}")
            rec["train"].update(profiler_ms=every, parts_ms=parts)
        records[name] = rec
        del args, dec, ld, tr
    b, t = XLSTM["train_rows"], XLSTM["train_seq"]
    for kind in ("slstm", "mlstm"):
        name = f"{kind}_recurrence_bwd"
        kernel = getattr(xlstm, XLSTM_KERNELS[name][0])
        plain = getattr(ref, f"{kind}_recurrence_bwd_ref")
        kargs, pargs = _xlstm_bwd_case(gen, kind)
        got = kernel(*kargs)
        again = kernel(*kargs)
        t0 = time.perf_counter()
        want32 = plain(*pargs)
        torch.cuda.synchronize()
        pms = (time.perf_counter() - t0) * 1e3
        # the mLSTM's yardstick: its plain version in float64 on the same
        # values (see XLSTM_BWD_TOL)
        want = plain(*_to_f64(pargs)) if kind == "mlstm" else want32
        errs = [_rel_err(g.reshape(w.shape), w) for g, w in zip(got, want)]
        err = max(errs)
        abs_err = max(float((g.reshape(w.shape) - w).abs().max())
                      for g, w in zip(got, want))
        err32 = max(_rel_err(g.reshape(w.shape), w)
                    for g, w in zip(got, want32))
        same = all(torch.equal(a, g) for a, g in zip(again, got))
        if err > XLSTM_BWD_TOL or not same:
            fail(f"{name} at B {b} x T {t}: |kernel - plain| / "
                 f"max grad {err:.3e} (bar {XLSTM_BWD_TOL}; each "
                 "gradient's: " + ", ".join(f"{e:.3e}" for e in errs)
                 + f"), repeat bitwise {same}")
        del got, again, want, want32
        kms = time_ms(lambda: kernel(*kargs), warmup=1, reps=3, rounds=3)
        yard = "plain (float64)" if kind == "mlstm" else "plain"
        log(f"  {name}: |kernel - {yard}| / max |grad| {err:.3e} (bar "
            f"{XLSTM_BWD_TOL}), repeat bitwise; against the plain version "
            f"in fp32 {err32:.3e}")
        records[name] = _xlstm_record(
            name, (err, abs_err), kms, pms, b, t,
            f"train B{b} T{t} H4 hd{XLSTM[kind + '_hd']} (events; plain "
            "one call, host clock)")
        if kind == "mlstm":
            # one call is six kernels; its count counts calls
            by_kernel = device_ms_by_kernel(lambda: kernel(*kargs), reps=3)
            parts = {short: ms for short in MLSTM_BWD_PARTS
                     for key, ms in by_kernel.items()
                     if f"::{short}(" in key}
            every = sum(by_kernel.values())
            log(f"  {name}: device ms per call by kernel (profiler) "
                + ", ".join(f"{k} {v:.5f}" for k, v in parts.items())
                + f"; every kernel {every:.5f}, the call by events "
                f"{kms:.5f} ({kms - every:.5f} outside the kernels) "
                f"[{CARD}]")
            if set(parts) != set(MLSTM_BWD_PARTS):
                fail(f"{name}: the profiler saw {sorted(parts)}, want "
                     f"{list(MLSTM_BWD_PARTS)}")
            records[name].update(kernels_per_call=len(MLSTM_BWD_PARTS),
                                 parts_ms=parts)
        del kargs, pargs
    return records


def phase_kernels_xlstm(gen) -> dict:
    return bench_xlstm(gen, check_xlstm(gen))


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------


def hybrid_config(**kw):
    """Jamba-1.5-Large with dense FFNs: with its published MoE FFN one
    8-layer period holds 77 GB of experts, more than one card."""
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


# xlstm-125m at published width and depth in fp32: one prompt of 64
# tokens, then 8 greedy steps, on the card through the recurrences'
# kernels, on the card through their plain loops and on the CPU through
# the plain loops, from the same weights; every step's logits within
# XLSTM_LOGIT_TOL of the largest |logit|, card against CPU and kernels
# against plain loops (fp32 products of widths 768-3072 and recurrences
# summed in other orders through 12 layers: a first bar of 1e-4 read
# 6.55e-4 on one H100 80GB HBM3, 700.00 W, with equal tokens)
XLSTM_EXACT = dict(prompt_len=64, decode=8)
XLSTM_LOGIT_TOL = 2e-3


def _xlstm_exactness() -> None:
    """xlstm-125m (fp32) prefill + 8 greedy steps on the card (kernels)
    against the CPU, and against the card's plain loops: logits within
    XLSTM_LOGIT_TOL, the greedy tokens equal (a stream may part only
    where the other's top-2 gap is within two logit ULPs, and is
    compared no further), both forward kernels launched."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_map
    from repro_torch.models import (ModelParams, decode_step,
                                    init_decode_state, init_params, prefill)
    cfg = dataclasses.replace(get_config("xlstm-125m"),
                              param_dtype="float32", compute_dtype="float32")
    cpu_params = init_params(cfg, seed=0, device="cpu")
    card_params = ModelParams(*(tree_map(lambda a: a.cuda(), part)
                                for part in cpu_params))
    prompt = np.random.default_rng(3).integers(
        0, cfg.vocab_size, XLSTM_EXACT["prompt_len"]).tolist()
    wrappers = _kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    runs = {}
    for dev, params, plain in (("cuda", card_params, False),
                               ("cuda plain", card_params, True),
                               ("cpu", cpu_params, False)):
        t0 = time.perf_counter()
        dev_label, dev = dev, dev.split()[0]
        with _plain_recurrences(plain):
            state = init_decode_state(cfg, device_batch=1, cache_len=128,
                                      device=dev)
            logits, state = prefill(params, cfg, {"tokens": torch.tensor(
                [prompt], device=dev)}, state)
            toks, seen = [], []
            for i in range(XLSTM_EXACT["decode"]):
                seen.append(logits[0].float().cpu())
                toks.append(int(logits[0].argmax()))
                if i + 1 < XLSTM_EXACT["decode"]:
                    logits, state, _, _ = decode_step(
                        params, cfg, torch.tensor([toks[-1]], device=dev),
                        state)
        if dev_label == "cuda":
            torch.cuda.synchronize()
            counts = {k: wrappers[k].launches
                      for k in ("slstm_recurrence", "mlstm_recurrence")}
        runs[dev_label] = (toks, seen, time.perf_counter() - t0)
    ct, cl, cs = runs["cuda"]
    texts = []
    for other in ("cpu", "cuda plain"):
        pt, pl, ps = runs[other]
        worst, parted = 0.0, None
        for i, (a, b) in enumerate(zip(cl, pl)):
            worst = max(worst, float((a - b).abs().max())
                        / float(b.abs().max()))
            if ct[i] != pt[i]:
                top2 = torch.topk(b, 2).values
                gap = float(top2[0] - top2[1])
                if gap > 2 * logit_ulp(torch.float32, float(top2[0])):
                    fail(f"xlstm-125m fp32: the kernels' greedy token "
                         f"{ct[i]} parts from {other}'s {pt[i]} at step {i} "
                         f"(top-2 gap {gap:.3e})")
                parted = (i, gap)
                break
        texts.append(f"against {other}: tokens {pt}, worst |diff| / max "
                     f"|logit| {worst:.3e}" + (
                         f", parted at a tie at step {parted[0]} (gap "
                         f"{parted[1]:.2e})" if parted else "")
                     + f" ({ps:.1f} s)")
        if worst > XLSTM_LOGIT_TOL:
            fail(f"xlstm-125m fp32: the kernels' logits part from {other}'s "
                 f"by {worst:.3e} of the largest")
    log(f"  xlstm-125m fp32, {XLSTM_EXACT['prompt_len']} + "
        f"{XLSTM_EXACT['decode']} tokens on the card's kernels: {ct} "
        f"({cs:.1f} s); " + "; ".join(texts)
        + f" (bar {XLSTM_LOGIT_TOL}); launches {counts}")
    if min(counts.values()) <= 0:
        fail(f"xlstm-125m fp32: a recurrence kernel did not run: {counts}")
    del card_params, cpu_params
    _free_device()


def phase_exactness() -> None:
    """llama3.1-8b and the dense-FFN Jamba hybrid (16 layers, attention
    at 3 and 11), each reduced to d_model 256 in fp32: device, host and
    raw rows agree; then the chat traffic of serving-chunked gives the
    same streams with and without the prefix cache and tier moves.  The
    hybrid's chat runs with bf16 parameters: with fp32 ones the bf16 conv
    window rounds the Mamba input at every chunk boundary, so a prompt's
    state depends on where its chunks start (the reference's too; ROADMAP
    queue 3), and a prefix hit moves the boundaries."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    fp32 = dict(param_dtype="float32", compute_dtype="float32")
    llama = dataclasses.replace(
        get_config("llama3.1-8b").reduced(layers=4, d_model=256, vocab=512),
        **fp32)
    hybrid = hybrid_config().reduced(d_model=256, vocab=512)
    _exactness(llama)
    _exactness(dataclasses.replace(hybrid, **fp32))
    for cfg in (llama, hybrid):
        _chat_identity(cfg, init_params(cfg, seed=0, device="cuda"), "cuda",
                       f"{cfg.name} {cfg.param_dtype} chat", whole=True)
    _xlstm_exactness()


# ---------------------------------------------------------------------------
# phase 4
# ---------------------------------------------------------------------------


def _serve_once(cfg, params, scfg, prompts, output_len):
    import torch
    from repro_torch.serving import InferenceServer, Request
    from repro_torch.serving.engine import Engine
    nan = torch.zeros((), dtype=torch.bool, device=scfg.device)
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
            if scfg.device == "cuda":
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
    from repro_torch.kernels import xlstm
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.mamba_scan import (mamba_selective_scan_bwd_cuda,
                                                mamba_selective_scan_cuda)
    from repro_torch.kernels.prefill_attention import (
        prefill_attention_bwd_cuda, prefill_attention_cuda)
    return {"decode_attention": decode_attention_cuda,
            "prefill_attention": prefill_attention_cuda,
            "mamba_selective_scan": mamba_selective_scan_cuda,
            "prefill_attention_bwd": prefill_attention_bwd_cuda,
            "mamba_selective_scan_bwd": mamba_selective_scan_bwd_cuda,
            **{name: getattr(xlstm, wrapper) for name, (wrapper, *_)
               in XLSTM_KERNELS.items()}}


def _serve_published(cfg, traced_iters: int, traffic: dict = MAIN) -> dict:
    """Serve ``traffic`` (MAIN's by default) on ``cfg`` (random bf16
    weights, seed 0) through InferenceServer; print the end-to-end
    numbers, and a traced window when ``traced_iters``; fail on a wrong
    run (a request short of its tokens, a NaN, a tier that decoded
    nothing, a host fallback, no hybrid decision, a kernel launched fewer
    times than the path needs).  Returns each kernel's launches over the
    measured run."""
    import numpy as np
    import torch
    from repro_torch.models import init_params
    from repro_torch.serving import ServerConfig
    log(f"  {cfg.name}: d_model {cfg.d_model}, heads {cfg.num_heads}/"
        f"{cfg.num_kv_heads} of {cfg.resolved_head_dim}, d_ff {cfg.d_ff}, "
        f"vocab {cfg.vocab_size}, "
        f"{cfg.num_layers} layers (attention at {cfg.attn_layer_indices}), "
        f"{cfg.param_dtype}, {cfg.param_count() / 1e9:.2f} B parameters")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"  random weights from torch.Generator(seed 0) in "
        f"{time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    plen, out_len = traffic["prompt_len"], traffic["output_len"]
    page_size = 32
    # one resident's pages over every attention layer
    pages_per_resident = (-(-(plen + out_len) // page_size)) \
        * cfg.num_attn_layers
    # whole-prompt bucketed prefill and no tier moves or prefix cache:
    # the path these two phases have measured since their first runs
    # (serving-chunked drives the defaults)
    scfg = ServerConfig(device_slots=traffic["device_slots"],
                        host_slots=traffic["host_slots"],
                        cache_len=traffic["cache_len"], page_size=page_size,
                        host_pool_pages=pages_per_resident
                        * traffic["host_slots"], device="cuda",
                        chunk_tokens=0, **FEATURES_OFF)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, plen).tolist()
               for _ in range(traffic["requests"])]
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
        f"{stats.host_transfer_time:.3f} s); host fallbacks "
        f"{stats.host_fallbacks}; strategies {stats.strategy_counts}")
    log(f"  launches {launches} over {buckets} admission bucket(s); host "
        f"pool {scfg.host_pool_pages} pages = {pool_bytes / 2**20:.0f} MiB; "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        f" GiB [{CARD}]")
    _check_served(cfg, reqs, stats, saw_nan, out_len, launches, buckets)
    if traced_iters:
        _print_traced(*_traced_window(cfg, params, scfg, prompts, out_len,
                                      traced_iters), traced_iters)
    return launches


def _print_traced(share, ms_iter, per_kernel, ops, traced_iters) -> None:
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


def _check_served(cfg, reqs, stats, saw_nan, out_len, launches,
                  buckets) -> None:
    from repro_torch.core.scheduler import StrategyKind
    from repro_torch.models.config import BlockKind
    bad = [r.request_id for r in reqs
           if r.failed or len(r.output) != out_len]
    if bad:
        fail(f"{cfg.name}: requests {bad} did not finish with {out_len} "
             "tokens")
    if saw_nan:
        fail(f"{cfg.name}: a logit was NaN")
    if stats.host_tokens <= 0 or stats.device_tokens <= 0:
        fail(f"{cfg.name}: a tier decoded nothing (device "
             f"{stats.device_tokens}, host {stats.host_tokens} tokens)")
    if stats.host_fallbacks:
        fail(f"{cfg.name}: {stats.host_fallbacks} host fallbacks")
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
            fail(f"{cfg.name}: {name} launched {launches[name]} times; the "
                 f"path needs at least {n} ({device_iters} device-row "
                 f"iterations, {buckets} admission buckets)")


# the serving phase's depth: llama3.1-8b cut to 16 of its 32 layers (at
# 32 the phase took ~90 s, and the dry-run and examples phases needed
# the room; a host-tier token then takes 17 iterations, not 33)
SERVING_LAYERS = 16


def phase_serving() -> dict:
    import dataclasses
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("llama3.1-8b"),
                              num_layers=SERVING_LAYERS,
                              name=f"llama3.1-8b-{SERVING_LAYERS}L")
    return _serve_published(cfg, traced_iters=40)


def phase_serving_hybrid() -> dict:
    """Jamba-1.5-Large at published width with dense FFNs (the MoE FFN
    is not ported; with experts one 8-layer period alone is 90 GB in
    bf16), depth cut to 2 periods: 14 Mamba + 2 attention layers."""
    return _serve_published(hybrid_config(num_layers=16), traced_iters=24)


# ---------------------------------------------------------------------------
# phase 6: the reference's default serving path on multi-turn chat
# ---------------------------------------------------------------------------

def chat_pool_pages(cfg) -> int:
    """Host pool pages: four first-turn residents (176 + 16 tokens, 6
    pages per attention layer) plus 3 pages per layer for prefix chains,
    which the LRU reclaims under pressure.  With two first-turn residents
    on the host, the urgent request's 496 tokens (16 pages per layer) do
    not fit there and a first-turn victim's 6 do: it preempts."""
    first = CHAT["system_len"] + CHAT["user_len"] + CHAT["output_len"]
    return cfg.num_attn_layers * (4 * -(-first // CHAT["page_size"]) + 3)


def chat_config(cfg, device: str, **features):
    from repro_torch.serving import ServerConfig
    kw = dict(device_slots=CHAT["device_slots"],
              host_slots=CHAT["host_slots"], cache_len=CHAT["cache_len"],
              page_size=CHAT["page_size"],
              host_pool_pages=chat_pool_pages(cfg), device=device)
    return ServerConfig(**{**kw, **features})


class _Watch:
    """Device-side watches over one run, read once at its end (no sync on
    the way): a NaN flag over every logit row a token is taken from, and
    each token's top-2 logit gap and top logit, keyed by (request id,
    token index) -- device rows at every commit, host rows when their
    token completes, first tokens at graduation.  Also counts the chunk
    budgets Algorithm 1 granted (budget -> iterations).  With
    ``keep_rows`` it keeps each of those logit rows too (``logit_rows``),
    for comparing two runs' logits token by token.  Engines on several
    threads (the gateway's replicas) may share one watch."""

    def __init__(self, device: str, keep_rows: bool = False):
        import collections
        import threading
        import torch
        self.nan = torch.zeros((), dtype=torch.bool, device=device)
        self.keys, self.tops, self.kept = [], [], []
        self.keep_rows = keep_rows
        self.last = {}          # engine -> its last committed logits
        self.dtype = None
        self.budgets = collections.Counter()
        self._lock = threading.Lock()

    def rows(self, logits, rows, keys):
        import torch
        if len(rows) == 0:
            return
        sel = logits[torch.as_tensor(rows, device=logits.device)].float()
        top = torch.topk(sel, 2, dim=-1).values
        with self._lock:
            self.dtype = logits.dtype
            self.tops.append(top)
            if self.keep_rows:
                self.kept.append(sel)
            self.keys += keys
            self.nan.logical_or_(torch.isnan(sel).any())

    def logit_rows(self) -> dict:
        """(request id, token index) -> that token's fp32 logit row."""
        import torch
        if not self.kept:
            return {}
        rows = torch.cat(self.kept).cpu().numpy()
        return dict(zip(self.keys, rows))

    def margins(self) -> dict:
        """(request id, token index) -> (top-2 gap, top logit); a token
        recomputed after a recompute preemption keeps its last value."""
        import torch
        if not self.tops:
            return {}
        tops = torch.cat(self.tops).cpu().tolist()
        return {k: (t[0] - t[1], t[0]) for k, t in zip(self.keys, tops)}

    def __enter__(self):
        from repro_torch.serving import engine
        watch = self
        commit = engine.Engine._commit_device
        overlap = engine.Engine._step_overlap
        finish = engine.finish_chunks
        schedule = engine.Engine._schedule

        def schedule_watched(eng, admitted, rows):
            decision = schedule(eng, admitted, rows)
            if decision is not None and decision.chunk_tokens:
                with watch._lock:
                    watch.budgets[decision.chunk_tokens] += 1
            return decision

        def commit_watched(eng, logits, rows):
            watch.last[id(eng)] = logits
            watch.rows(logits, rows, [
                (eng.lc.slots[i].request_id, len(eng.lc.slots[i].output))
                for i in rows])
            return commit(eng, logits, rows)

        def overlap_watched(eng, tokens, cohort, rows, **kw):
            before = eng.stats.host_tokens
            valid = list(cohort.valid_slots)
            overlap(eng, tokens, cohort, rows, **kw)
            if eng.stats.host_tokens > before:
                reqs = [eng.lc.host_requests[cohort.slot_rids[i]]
                        for i in valid]
                watch.rows(watch.last[id(eng)], [eng.e.device_slots + i
                                        for i in valid],
                           [(r.request_id, len(r.output) - 1)
                            for r in reqs])

        def finish_watched(eng, plan, clogits):
            staging = eng.lc.staging
            done = [row for row, c in zip(plan.rows, plan.lens)
                    if staging[row].consumed + c
                    >= staging[row].req.prompt_len]
            watch.rows(clogits, done, [
                (staging[row].req.request_id, len(staging[row].req.output))
                for row in done])
            return finish(eng, plan, clogits)

        self._saved = (commit, overlap, finish, schedule)
        engine.Engine._commit_device = commit_watched
        engine.Engine._step_overlap = overlap_watched
        engine.finish_chunks = finish_watched
        engine.Engine._schedule = schedule_watched
        return self

    def __exit__(self, *exc):
        from repro_torch.serving import engine
        (engine.Engine._commit_device, engine.Engine._step_overlap,
         engine.finish_chunks, engine.Engine._schedule) = self._saved


def logit_ulp(dtype, x: float) -> float:
    """One unit in the last place of ``x`` in the logits' dtype."""
    import math
    import torch
    mant = {torch.bfloat16: 7, torch.float16: 10}.get(dtype, 23)
    return 2.0 ** (math.floor(math.log2(max(abs(x), 1e-30))) - mant)


def check_pool(engine) -> str:
    """No leaked pages and no refcount below one: every page's refcount
    is its number of occurrences in the chains, free pages are the
    unreferenced ones, and the only owners left are prefix-cache entries
    the cache still indexes."""
    pool = engine.executor.pool
    occ = {}
    for chain in pool.page_tables.values():
        for p in chain:
            occ[p] = occ.get(p, 0) + 1
    owners = {owner for owner, _ in pool.page_tables}
    entries = {e.owner for e in engine.prefix.entries.values()
               if e.tier == "host"} if engine.prefix is not None else set()
    if occ != pool.page_refs or min(pool.page_refs.values(), default=1) < 1:
        fail("pool refcounts do not balance the page chains")
    # compressed pages hold negative sentinel ids and no physical page
    phys = {p for p in occ if p >= 0}
    if set(pool.free_pages) & phys or \
            len(pool.free_pages) + len(phys) != pool.pages.shape[1]:
        fail("pool pages leaked or double-freed")
    if {p for p in occ if p < 0} != set(pool._compressed):
        fail("compressed pages and their blobs disagree")
    if owners - entries:
        fail(f"pool owners {sorted(owners - entries)} outlived their "
             "requests")
    return (f"{len(occ)} pages held by {len(owners)} prefix entries, "
            f"{len(pool.free_pages)} free of {pool.pages.shape[1]}")


def chat_run(cfg, params, scfg, *, seed: int = 0, trace_iters: int = 0,
             scheduler=None, urgent_request: bool = True):
    """Drive the chat traffic through ``InferenceServer`` until every turn
    and the urgent request finished.  Returns (outputs by (conversation,
    turn) and "urgent", stats, wall seconds, (watch, each stream's
    per-token (top-2 gap, top logit)), server's engine, traced ops or
    None).  ``scheduler`` replaces Algorithm 1 (``Pipelined``);
    ``urgent_request=False`` leaves the priority-1 request out.  With
    ``trace_iters``, the run is cut short:
    ``torch.profiler`` traces that many iterations once chunks co-run
    with decode on both tiers, and the traced kernels are returned."""
    import numpy as np
    import torch
    from repro_torch.serving import InferenceServer, Request
    from repro_torch.serving.request import Phase
    rng = np.random.default_rng(seed)
    v = cfg.vocab_size
    system = rng.integers(0, v, CHAT["system_len"]).tolist()
    users = [[rng.integers(0, v, CHAT["user_len"]).tolist()
              for _ in range(CHAT["turns"])]
             for _ in range(CHAT["conversations"])]
    urgent_prompt = rng.integers(0, v, CHAT["urgent_len"]).tolist()
    n_out = CHAT["output_len"]
    outs, rids, traced = {}, {}, None
    with _Watch(scfg.device) as watch, InferenceServer(
            cfg, params, scfg, scheduler=scheduler) as server:
        eng = server.engine
        live = {c: (0, server.submit(Request(prompt=system + users[c][0],
                                             max_new_tokens=n_out)))
                for c in range(CHAT["conversations"])}
        urgent = None
        t0 = time.perf_counter()
        for it in range(20000):
            if trace_iters and eng.stats.chunk_co_run_iterations >= 2 \
                    and eng.lc.host_requests:
                from torch.profiler import ProfilerActivity, profile
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA],
                             acc_events=True) as prof:
                    t_tr = time.perf_counter()
                    for _ in range(trace_iters):
                        server.step()
                    torch.cuda.synchronize()
                    traced = (prof, time.perf_counter() - t_tr)
                break
            server.step()
            # the urgent request arrives once both device slots hold
            # priority-0 residents with one token left: the swapped victim
            # finishes on the host while the urgent request still decodes
            # (so no slot frees to migrate it back), publishes its prompt
            # by forking its pool chains, and its next turn hits that entry
            if urgent_request and urgent is None and all(
                    r is not None and r.priority == 0
                    and r.phase is Phase.DECODE_DEVICE
                    and len(r.output) == n_out - 1 for r in eng.slots):
                urgent = server.submit(Request(
                    prompt=urgent_prompt, max_new_tokens=CHAT[
                        "urgent_output"], priority=1))
            for c, (turn, h) in list(live.items()):
                if not h.done:
                    continue
                if h.failed:
                    fail(f"conversation {c} turn {turn}: {h.error}")
                outs[c, turn] = list(h.output)
                rids[c, turn] = h.request_id
                if turn + 1 < CHAT["turns"]:
                    prompt = list(h.request.prompt) + list(h.output) \
                        + users[c][turn + 1]
                    live[c] = (turn + 1, server.submit(Request(
                        prompt=prompt, max_new_tokens=n_out)))
                else:
                    del live[c]
            if not live and (not urgent_request
                             or urgent is not None and urgent.done):
                break
        else:
            fail("the chat traffic did not finish in 20000 iterations")
        if scfg.device == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if not trace_iters and urgent_request:
            if urgent is None:
                fail("both device slots never held priority-0 residents")
            if urgent.failed:
                fail(f"the urgent request failed: {urgent.error}")
            outs["urgent"] = list(urgent.output)
            rids["urgent"] = urgent.request_id
        stats = server.stats
    margins = watch.margins()
    return outs, stats, wall, (watch, {k: [margins.get((rid, j))
                                          for j in range(len(outs[k]))]
                                      for k, rid in rids.items()}), eng, \
        traced


def compare_streams(on: dict, off: dict, on_m: dict, off_m: dict,
                    dtype):
    """Greedy streams of two runs that placed requests on other tiers.
    A device row's decode K/V is bf16 and a host row's fp32, and the host
    sums attention in numpy: a token whose top-2 logits are within two
    ULPs of each other (in either run) may go either way, and the
    conversation's later turns then follow different prompts.  Returns
    (identical streams, descriptions of partings at a tie, of other
    partings)."""
    same, flips, other, parted = 0, [], [], set()
    for key in on:
        a, b = on[key], off.get(key)
        if a == b:
            same += 1
            continue
        conv = key[0] if isinstance(key, tuple) else key
        if conv in parted:
            continue                  # downstream of a flip in its history
        j = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                 min(len(a), len(b)))
        ma = on_m[key][j] if j < len(on_m[key]) else None
        mb = off_m[key][j] if j < len(off_m[key]) else None
        tie = [m for m in (ma, mb) if m is not None
               and m[0] <= 2 * logit_ulp(dtype, m[1])]
        parted.add(conv)
        if tie:
            flips.append(f"{key} at token {j}, top-2 gap {tie[0][0]:.3e} at "
                         f"logit {tie[0][1]:.3f}")
        else:
            other.append(f"{key} at token {j} ({a[j:j + 3]} against "
                         f"{b[j:j + 3]}), top-2 gaps {ma} / {mb}")
    return same, flips, other


def _chat_identity(cfg, params, device: str, label: str,
                   wrappers=None, whole: bool = False) -> dict:
    """The chat traffic with the reference's defaults (the measured run),
    then again with the prefix cache, rebalancing and preemption off:
    every stream identical but where it parts at a logit tie
    (``compare_streams``), every mechanism fired, the pool whole at the
    end.  ``wrappers``' launch counts are zeroed just before the measured
    run and read just after it, with the peak device memory.  ``whole``
    also runs the traffic with whole-prompt prefill and reports how its
    streams compare with the chunked ones."""
    import torch
    if wrappers:
        for fn in wrappers.values():
            fn.launches = 0
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    on, stats, wall, watch, eng, _ = chat_run(
        cfg, params, chat_config(cfg, device))
    launches = {name: fn.launches for name, fn in (wrappers or {}).items()}
    peak = (torch.cuda.max_memory_allocated() / 2**30 if device == "cuda"
            else None)
    pool = check_pool(eng)
    off, off_stats, off_wall, off_watch, _, _ = chat_run(
        cfg, params, chat_config(cfg, device, **FEATURES_OFF))
    counters = dict(
        prefill_chunks=stats.prefill_chunks,
        chunk_co_run_iterations=stats.chunk_co_run_iterations,
        prefix_device_hits=stats.prefix_device_hits,
        prefix_host_hits=stats.prefix_host_hits,
        migrations=stats.migrations, preemptions=stats.preemptions)
    (watch, on_m), (off_watch, off_m) = watch, off_watch
    gap = min((m[0] for ms in on_m.values() for m in ms if m is not None),
              default=float("nan"))
    log(f"  {label}: {counters}, prefix hit tokens "
        f"{stats.prefix_hit_tokens}, recompute preemptions "
        f"{stats.preemption_recomputes}; pool at the end: {pool}; smallest "
        f"top-2 logit gap {gap:.3e}")
    if bool(watch.nan) or bool(off_watch.nan):
        fail(f"{label}: a logit was NaN")
    zero = [k for k, n in counters.items() if n <= 0]
    if zero:
        fail(f"{label}: {zero} did not fire")
    same, flips, other = compare_streams(on, off, on_m, off_m, watch.dtype)
    log(f"  {label}: {same} of {len(on)} streams identical to the run with "
        f"the prefix cache, rebalancing and preemption off ({wall:.2f} s "
        f"and {off_wall:.2f} s wall)"
        + ("" if not flips else "; parted at a tie (the conversation's "
           "later turns follow): " + "; ".join(flips)))
    if other:
        fail(f"{label}: streams part by more than two logit ULPs: "
             + "; ".join(other))
    if whole:
        # not a bar: whole-prompt prefill runs other GEMM shapes, so a
        # token's K/V may differ in the last bit from the chunked path's
        wh, _, _, (_, wh_m), _, _ = chat_run(cfg, params, chat_config(
            cfg, device, chunk_tokens=0, **FEATURES_OFF))
        same, flips, other = compare_streams(off, wh, off_m, wh_m,
                                             watch.dtype)
        log(f"  {label}: chunked against whole-prompt prefill (both with "
            f"the features off): {same} of {len(wh)} streams identical"
            + "".join(f"; parted at a tie: {f}" for f in flips)
            + "".join(f"; parted: {f}" for f in other))
    return dict(stats=stats, wall=wall, outs=on, gap=gap, flips=flips,
                off_stats=off_stats, off_wall=off_wall, launches=launches,
                peak=peak, off=off, off_m=off_m, budgets=watch.budgets)


def _budgets_text(budgets) -> str:
    return ", ".join(f"{b}: {n}" for b, n in sorted(budgets.items()))


def _measured_chat(cfg, params, res: dict) -> None:
    """The chat traffic once more with Algorithm 1 on the measured profile
    (``perf_model="measured"``: ``OfflineProfiler`` at engine startup, as
    the serve CLI does): its numbers beside the analytic run's, and its
    streams held to the tie-aware bar against the features-off run."""
    on, st, wall, (watch, on_m), _, _ = chat_run(cfg, params, chat_config(
        cfg, "cuda", perf_model="measured"))
    if bool(watch.nan):
        fail("measured chat run: a logit was NaN")
    same, flips, other = compare_streams(on, res["off"], on_m, res["off_m"],
                                         watch.dtype)
    if other:
        fail("measured chat run: streams part by more than two logit ULPs "
             "from the features-off run: " + "; ".join(other))
    n_tok = sum(len(o) for o in on.values())
    for label, s, w, budgets in (
            ("analytic h100 (the defaults run)", res["stats"], res["wall"],
             res["budgets"]),
            ("measured profile", st, wall, watch.budgets)):
        log(f"  {label}: {s.iterations} iterations in {w:.3f} s "
            f"({s.iterations / w:.2f}/s), {n_tok / w:.2f} output tokens/s; "
            f"TTFT p50 {s.ttft_p50 * 1e3:.1f} ms, p95 "
            f"{s.ttft_p95 * 1e3:.1f} ms; ITL p50 {s.itl_p50 * 1e3:.1f} ms; "
            f"chunk budgets (tokens: iterations) {{{_budgets_text(budgets)}}}"
            f"; strategies {s.strategy_counts}; predicted step time "
            f"{s.predicted_time:.3f} s against {s.observed_time:.3f} s "
            f"observed (step error EWMA {s.step_error_ewma:.3f}); "
            f"host fallbacks {s.host_fallbacks} [{CARD}]")
    if st.host_fallbacks:
        fail(f"measured chat run: {st.host_fallbacks} host fallbacks on a "
             "healthy card")
    log(f"  measured run: {same} of {len(on)} streams identical to the "
        "features-off run" + ("" if not flips else "; parted at a tie: "
                              + "; ".join(flips)))


class Pipelined:
    """Algorithm 1 pinned to Asymmetric Pipelining with the whole chunk
    budget: every host job is waited for, so no decision depends on step
    times and two runs of the same traffic take the same iterations."""

    def schedule(self, prefill, decode_gpu, decode_cpu, *, mean_context,
                 prefill_tokens=0, chunk_backlog_tokens=0,
                 chunk_tokens_max=0):
        from repro_torch.core.scheduler import Decision, StrategyKind
        return Decision(StrategyKind.ASYM_PIPELINE, list(prefill),
                        list(decode_gpu), list(decode_cpu),
                        chunk_tokens=min(chunk_backlog_tokens,
                                         chunk_tokens_max))


class _PoolPaths:
    """Counts, over a run, the host pool's page compressions and
    rehydrations by the method that asked for them: the cold sweep or
    the reclaim; a write, or ``ensure_hot`` on behalf of ``gather`` or a
    host job.  Both counted methods run under the pool's lock."""

    NAMES = ("_compress_page_locked", "_decompress_page_locked")

    def __enter__(self):
        import collections
        import sys
        from repro_torch.models.kv_cache import PagedKVPool
        self.counts = collections.Counter()
        self._saved = {name: getattr(PagedKVPool, name) for name in self.NAMES}

        def counted(name, orig):
            verb = name.split("_")[1]

            def call(pool, *args, **kw):
                frame = sys._getframe(1)
                who = frame.f_code.co_name
                if who == "ensure_hot":
                    who += f" ({frame.f_back.f_code.co_name})"
                self.counts[f"{verb} by {who}"] += 1
                return orig(pool, *args, **kw)
            return call
        for name, orig in self._saved.items():
            setattr(PagedKVPool, name, counted(name, orig))
        return self

    def __exit__(self, *exc):
        from repro_torch.models.kv_cache import PagedKVPool
        for name, orig in self._saved.items():
            setattr(PagedKVPool, name, orig)


def _int8_chat(cfg, params, device: str) -> None:
    """The chat traffic with the host tier in int8.  First twice, without
    and with pages compressed after ``CHAT["compress_after"]`` s idle,
    with Algorithm 1 pinned (``Pipelined``), twice ``chat_pool_pages``
    and the conversations only (pinned, both device slots need not ever
    hold residents one token from their end, which the urgent request
    waits for): neither run reclaims, so compression changes neither
    timing-driven decisions nor what the prefix cache keeps, and as it is
    lossless the streams must be identical.  Idle prefix entries and host
    residents waiting to decode go cold; writes and host jobs rehydrate
    them.  Then once more on the chat phase's own configuration (its
    pool, Algorithm 1, the urgent request) with pages going cold only
    after an hour: only the LRU reclaim compresses then, before it
    evicts, under allocation pressure (what it compresses may be evicted
    before anything reads it).  Each run: no NaN, no host fallback, the
    pool whole at the end, and where pages were compressed and
    rehydrated, by which path."""
    runs = {}
    cold = dict(cold_page_compress_after=CHAT["compress_after"])
    for label, kw, pinned in (
            ("int8, pinned", {}, True),
            ("int8 + cold pages, pinned", cold, True),
            ("int8 + pages cold after an hour, the phase's configuration",
             dict(cold_page_compress_after=3600.0), False)):
        extra = dict(host_pool_pages=2 * chat_pool_pages(cfg)) \
            if pinned else {}
        with _PoolPaths() as paths:
            outs, st, wall, (watch, _), eng, _ = chat_run(
                cfg, params, chat_config(cfg, device, host_kv_dtype="int8",
                                         **kw, **extra),
                scheduler=Pipelined() if pinned else None,
                urgent_request=not pinned)
        pool = check_pool(eng)
        if bool(watch.nan):
            fail(f"{label} chat run: a logit was NaN")
        if st.host_fallbacks:
            fail(f"{label} chat run: {st.host_fallbacks} host fallbacks on "
                 "a healthy run")
        if st.host_kv_dtype_bytes != 1:
            fail(f"{label} chat run: the pool did not store int8")
        n_tok = sum(len(o) for o in outs.values())
        log(f"  {label} chat run: {st.iterations} iterations in "
            f"{wall:.3f} s, {n_tok / wall:.2f} output tokens/s; prefix hits "
            f"(device / host) {st.prefix_device_hits} / "
            f"{st.prefix_host_hits}, preemptions {st.preemptions}; pages "
            f"compressed {st.host_pages_compressed}, decompressed "
            f"{st.host_pages_decompressed} (compressed/raw EWMA "
            f"{st.host_compressed_ratio_ewma}), by path "
            f"{dict(sorted(paths.counts.items()))}; pool reclaims "
            f"{eng.executor.pool.evictions}; pool at the end: {pool} "
            f"[{CARD}]")
        if pinned and kw and (st.host_pages_compressed <= 0
                              or st.host_pages_decompressed <= 0):
            fail(f"{label} chat run compressed {st.host_pages_compressed} "
                 f"and decompressed {st.host_pages_decompressed} pages; "
                 "both must be > 0")
        if not kw and (st.host_pages_compressed
                       or st.host_pages_decompressed):
            fail(f"{label} chat run compressed pages")
        if not pinned and paths.counts["compress by _reclaim_locked"] <= 0:
            fail(f"{label} chat run: the reclaim compressed no page")
        runs[label] = (outs, eng.executor.pool.evictions)
    (plain, pev), (squeezed, cev), _ = runs.values()
    if pev or cev:
        fail(f"the pinned int8 chat runs reclaimed {pev} / {cev} pool "
             "owners under pressure")
    parted = [key for key in plain if plain[key] != squeezed.get(key)]
    log(f"  cold pages against none (both int8, pinned): "
        f"{len(plain) - len(parted)} of {len(plain)} streams identical")
    if parted:
        fail(f"cold-page compression changed the streams of {parted}")


def _chunked_published(cfg, trace_iters: int, measured: bool = False,
                       int8: bool = False) -> dict:
    """The chat traffic on ``cfg`` at published width (random bf16 weights,
    seed 0): identity against the features-off run, the end-to-end
    numbers of the measured (defaults) run, a traced window, and each
    kernel's launches over the measured run.  ``measured`` adds a run on
    the measured perf model (``_measured_chat``), ``int8`` the int8 host
    tier with and without cold pages (``_int8_chat``)."""
    import torch
    from repro_torch.models import init_params
    from repro_torch.models.config import BlockKind
    log(f"  {cfg.name}: {cfg.num_layers} layers (attention at "
        f"{cfg.attn_layer_indices}), {cfg.param_dtype}, "
        f"{cfg.param_count() / 1e9:.2f} B parameters; host pool "
        f"{chat_pool_pages(cfg)} pages")
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    # warm-up: one short request through its own server, not measured
    _serve_once(cfg, params, chat_config(cfg, "cuda"), [[1] * 70], 2)
    torch.cuda.synchronize()
    res = _chat_identity(cfg, params, "cuda", cfg.name, _kernel_wrappers())
    launches, peak = res["launches"], res["peak"]
    st, wall = res["stats"], res["wall"]
    n_tok = sum(len(o) for o in res["outs"].values())
    log(f"  measured run (defaults): {len(res['outs'])} requests, {n_tok} "
        f"output tokens in {wall:.3f} s: {n_tok / wall:.2f} output "
        f"tokens/s, {st.iterations} iterations ({st.iterations / wall:.2f}"
        f" iterations/s); TTFT p50 {st.ttft_p50 * 1e3:.1f} ms, p95 "
        f"{st.ttft_p95 * 1e3:.1f} ms; ITL p50 {st.itl_p50 * 1e3:.1f} ms; "
        f"host wait {1e3 * st.host_wait_time / st.iterations:.3f} ms per "
        f"iteration (host busy {st.host_busy_time:.3f} s, transfer "
        f"{st.host_transfer_time:.3f} s); {st.prefill_chunks} chunks, "
        f"{st.chunked_prefill_tokens} chunked tokens; strategies "
        f"{st.strategy_counts}; peak device memory {peak:.2f} GiB; "
        f"launches {launches} [{CARD}]")
    ost, owall = res["off_stats"], res["off_wall"]
    log(f"  features-off run: {n_tok / owall:.2f} output tokens/s, "
        f"{ost.iterations} iterations ({ost.iterations / owall:.2f}/s); "
        f"TTFT p50 {ost.ttft_p50 * 1e3:.1f} ms, p95 "
        f"{ost.ttft_p95 * 1e3:.1f} ms; ITL p50 {ost.itl_p50 * 1e3:.1f} ms; "
        f"host wait {1e3 * ost.host_wait_time / ost.iterations:.3f} ms per "
        "iteration")
    n_attn = cfg.num_attn_layers
    n_mamba = sum(k == BlockKind.MAMBA
                  for k in cfg.block_pattern) * cfg.num_groups
    # at least one chunk call per iteration that ran a chunk, one decode
    # per iteration with a device row
    need = {"prefill_attention": n_attn * st.chunk_co_run_iterations,
            "decode_attention": n_attn * st.chunk_co_run_iterations,
            "mamba_selective_scan": n_mamba * st.chunk_co_run_iterations}
    for name, n in need.items():
        if launches[name] < n:
            fail(f"{name} launched {launches[name]} times in the chunked "
                 f"run; it needs at least {n}")
    if st.host_fallbacks or ost.host_fallbacks:
        fail(f"host fallbacks on a healthy card: {st.host_fallbacks} / "
             f"{ost.host_fallbacks}")
    if measured:
        _measured_chat(cfg, params, res)
    if int8:
        _int8_chat(cfg, params, "cuda")
    _, _, _, _, _, traced = chat_run(cfg, params, chat_config(cfg, "cuda"),
                                     trace_iters=trace_iters)
    prof, twall = traced
    per_kernel = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        if us > 0:
            per_kernel[ev.key] = per_kernel.get(ev.key, 0.0) \
                + us / trace_iters / 1e3
    busy = sum(per_kernel.values()) * trace_iters / 1e3
    log(f"  traced window ({trace_iters} iterations with a chunk beside "
        f"device and host decode, separate run): "
        f"{1e3 * twall / trace_iters:.2f} ms per iteration, device busy "
        f"{100 * busy / twall:.1f}% (idle {100 * (1 - busy / twall):.1f}%);"
        " top kernels by device time:")
    for key, ms in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]:
        log(f"    {ms:8.3f} ms/iter  {key[:100]}")
    port = {name: sum(ms for key, ms in per_kernel.items() if tag in key)
            for name, tag in PORT_KERNELS.items()}
    log("  the port's kernels, device ms per iteration: "
        + ", ".join(f"{name} {ms:.4f}" for name, ms in port.items()))
    return launches


def phase_serving_chunked() -> dict:
    """The reference's default serving configuration on llama3.1-8b and
    the dense-FFN Jamba at published width, cut to save run time: llama
    to 8 layers (16 until the whole run came within one slow host of its
    1200 s limit; 32 before serving-moe needed the room: at 32 its
    features-off run took ~1500 iterations, its host-tier turns decoding
    at 33 iterations per token), Jamba to one period (8 layers: 7 Mamba,
    attention at 3).  llama also runs the traffic on a measured profile
    taken at engine startup, and with the int8 host pool without and with
    cold-page compression."""
    import dataclasses
    from repro_torch.configs import get_config
    llama = dataclasses.replace(get_config("llama3.1-8b"),
                                num_layers=CHAT["llama_layers"],
                                name=f"llama3.1-8b-{CHAT['llama_layers']}L")
    log(f"  -- llama3.1-8b, {llama.num_layers} layers")
    counts = _chunked_published(llama, trace_iters=12, measured=True,
                                int8=True)
    log("  -- Jamba-1.5-Large, dense FFN, 8 layers")
    hyb = _chunked_published(hybrid_config(num_layers=8), trace_iters=12)
    return {name: counts[name] + hyb[name] for name in counts}


# ---------------------------------------------------------------------------
# serving-moe: deepseek-moe-16b with the host tier in fp32 and in int8
# ---------------------------------------------------------------------------


def moe_pool_pages(cfg) -> int:
    """Four host residents: 128 + 16 tokens, 5 pages per attention layer."""
    m = MOE_SERVE
    per = -(-(m["prompt_len"] + m["output_len"]) // m["page_size"])
    return cfg.num_attn_layers * m["host_slots"] * per


def moe_config(cfg, device: str, **kw):
    """Whole-prompt bucketed prefill, no tier moves or prefix cache (the
    serving phase's path): every run prefills the same buckets (six
    prompts, then two), so the capacity path drops the same assignments in
    both runs and an int8 run differs from the fp32 one by its host tier
    alone.  A chunk's contents follow Algorithm 1's budgets, which follow
    measured step times, and its padded positions take expert capacity
    (ROADMAP queue 3)."""
    from repro_torch.serving import ServerConfig
    m = MOE_SERVE
    return ServerConfig(device_slots=m["device_slots"],
                        host_slots=m["host_slots"], cache_len=m["cache_len"],
                        page_size=m["page_size"],
                        host_pool_pages=moe_pool_pages(cfg), device=device,
                        perf_model="analytic", chunk_tokens=0,
                        **FEATURES_OFF, **kw)


def check_moe_attention(gen) -> None:
    """Both attention kernels against their plain versions at
    deepseek-moe-16b's head geometry (MHA: group 1, head_dim 128), fp32
    and bf16: decode over the 2 device rows, the 6 x 64 chunk."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.prefill_attention import prefill_attention_cuda
    m = MOE_SERVE
    h, kv, d, s = m["heads"], m["kv_heads"], m["head_dim"], m["cache_len"]
    b, cb = m["device_slots"], m["device_slots"] + m["host_slots"]
    errs = []
    for dt in (torch.float32, torch.bfloat16):
        name = dtype_name(dt)
        q = _randn(gen, (b, h, d), dt, "cuda")
        k = _randn(gen, (b, s, kv, d), dt, "cuda")
        v = _randn(gen, (b, s, kv, d), dt, "cuda")
        lengths = torch.tensor([m["prompt_len"] + 1, s], dtype=torch.int32,
                               device="cuda")
        err, ok = close(decode_attention_cuda(q, k, v, lengths),
                        ref.decode_attention_ref(q, k, v, lengths),
                        TOL["decode", name])
        errs.append(f"decode {name} {err:.2e}")
        if not ok:
            fail(f"decode attention at H{h} KV{kv} D{d} {name}: err {err}")
        q = _randn(gen, (cb, 64, h, d), dt, "cuda")
        k = _randn(gen, (cb, s, kv, d), dt, "cuda")
        v = _randn(gen, (cb, s, kv, d), dt, "cuda")
        off = torch.linspace(0, s - 64, cb, device="cuda").round().to(
            torch.int32)
        err, ok = close(prefill_attention_cuda(q, k, v, None, off),
                        ref.prefill_attention_ref(q, k, v, None, off),
                        TOL["prefill", name])
        errs.append(f"chunk {name} {err:.2e}")
        if not ok:
            fail(f"prefill attention at H{h} KV{kv} D{d} {name}: err {err}")
    log(f"  both attention kernels at H{h} KV{kv} D{d} (group 1) against "
        f"their plain versions: max_abs_err {', '.join(errs)}")


def _moe_run(cfg, params, scfg, prompts, out_len: int) -> dict:
    """One closed-loop run of the traffic through ``InferenceServer``:
    streams, per-token (top-2 gap, top logit) and logit rows keyed by
    (request index, token index), the stats, the MoE dispatch counts and
    the pool's byte accounting."""
    import torch
    from repro_torch.models import moe
    from repro_torch.serving import InferenceServer, Request
    with _Watch(scfg.device, keep_rows=True) as watch, \
            InferenceServer(cfg, params, scfg) as server:
        handles = [server.submit(Request(prompt=list(p),
                                         max_new_tokens=out_len))
                   for p in prompts]
        moe.COUNTS.reset()
        t0 = time.perf_counter()
        server.run_until_idle()
        if scfg.device == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = moe.COUNTS.snapshot()
        stats = server.stats
        pool = server.engine.executor.pool
        whole = check_pool(server.engine)
        per_token = pool.page_bytes * cfg.num_attn_layers / pool.page_size
    if any(h.failed or len(h.output) != out_len for h in handles):
        fail(f"{scfg.host_kv_dtype} run: a request did not finish with "
             f"{out_len} tokens")
    if bool(watch.nan):
        fail(f"{scfg.host_kv_dtype} run: a logit was NaN")
    margins, rows = watch.margins(), watch.logit_rows()
    ids = [h.request_id for h in handles]
    outs = {i: list(h.output) for i, h in enumerate(handles)}
    return dict(
        outs=outs, stats=stats, wall=wall, counts=counts, pool=whole,
        bytes_per_token=per_token, dtype=watch.dtype,
        margins={i: [margins.get((rid, j)) for j in range(len(outs[i]))]
                 for i, rid in enumerate(ids)},
        rows={(i, j): rows[(rid, j)] for i, rid in enumerate(ids)
              for j in range(len(outs[i])) if (rid, j) in rows})


def logit_drift(fp: dict, q: dict) -> dict:
    """Token index -> the largest |int8 - fp32| logit difference over the
    requests whose two streams agree before that token (a token where they
    part still counts; what follows it is not comparable)."""
    import numpy as np
    by_j = {}
    for i, a in fp["outs"].items():
        b = q["outs"][i]
        for j in range(min(len(a), len(b))):
            ra, rb = fp["rows"].get((i, j)), q["rows"].get((i, j))
            if ra is not None and rb is not None:
                by_j[j] = max(by_j.get(j, 0.0), float(np.abs(ra - rb).max()))
            if a[j] != b[j]:
                break
    return by_j


def _serve_moe(cfg, params, device: str, traced_iters: int,
               wrappers=None) -> dict:
    """MOE_SERVE's traffic on ``cfg`` (``moe_config``: the analytic perf
    model), once with the fp32 host pool and once with the int8 pool and
    cold-page compression; the int8 run is held to the fp32 run as the
    reference holds int8: streams equal up to top-2 ties of two logit
    ULPs, and, on a dense-FFN stack, every logit within the reference's
    0.75 drift envelope.  On an MoE stack the drift is printed only: a
    near-tied expert choice that the int8 error flips moves the logits by
    more than the envelope the reference set on its reduced models, in
    the reference as in the port (``tools/moe_drift_cpu.py`` runs both on
    this traffic at d_model 512).  Every host owner decodes in every
    iteration, so the cold sweep, which skips the live cohort, compresses
    nothing here (``_int8_chat`` runs it).
    ``wrappers``' launch counts are zeroed just before the fp32 run and
    read just after the int8 run."""
    import numpy as np
    import torch
    m = MOE_SERVE
    out_len = m["output_len"]
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, m["prompt_len"]).tolist()
               for _ in range(m["requests"])]
    configs = {"fp32": moe_config(cfg, device),
               "int8": moe_config(
                   cfg, device, host_kv_dtype="int8",
                   cold_page_compress_after=m["compress_after"])}
    # warm-up: one short request through its own server, not measured
    _serve_once(cfg, params, configs["fp32"], prompts[:1], 2)
    for fn in (wrappers or {}).values():
        fn.launches = 0
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    runs = {label: _moe_run(cfg, params, scfg, prompts, out_len)
            for label, scfg in configs.items()}
    launches = {name: fn.launches for name, fn in (wrappers or {}).items()}
    peak = (torch.cuda.max_memory_allocated() / 2**30 if device == "cuda"
            else float("nan"))
    n_tok = m["requests"] * out_len
    for label, r in runs.items():
        st, wall, c = r["stats"], r["wall"], r["counts"]
        log(f"  {label} host pool: {st.iterations} iterations in {wall:.3f} "
            f"s ({st.iterations / wall:.2f}/s), {n_tok / wall:.2f} output "
            f"tokens/s (device {st.device_tokens}, host {st.host_tokens} "
            f"decoded); TTFT p50 {st.ttft_p50 * 1e3:.1f} ms; ITL p50 "
            f"{st.itl_p50 * 1e3:.1f} ms; host wait "
            f"{1e3 * st.host_wait_time / st.iterations:.3f} ms per iteration "
            f"(host busy {st.host_busy_time:.3f} s); host fallbacks "
            f"{st.host_fallbacks}; strategies {st.strategy_counts}; "
            f"migrations {st.migrations}, prefix hits {st.prefix_hits} "
            f"[{CARD}]")
        log(f"  {label} pool: {r['bytes_per_token']:.0f} B per token "
            f"({st.host_kv_dtype_bytes} B per element), bytes hot "
            f"{st.host_pool_hot_bytes} / compressed "
            f"{st.host_pool_compressed_bytes} / free "
            f"{st.host_pool_free_bytes}; pages compressed "
            f"{st.host_pages_compressed}, decompressed "
            f"{st.host_pages_decompressed} (compressed/raw EWMA "
            f"{st.host_compressed_ratio_ewma}); at the end: {r['pool']}")
        per_it = [c[path] / st.iterations for path in ("dropless",
                                                       "capacity")]
        log(f"  {label} MoE dispatch: {c['dropless']} dropless and "
            f"{c['capacity']} capacity calls ({per_it[0]:.2f} / "
            f"{per_it[1]:.2f} per iteration), {c['dropped']} assignments "
            "dropped at capacity")
    fp, q = runs["fp32"], runs["int8"]
    same, flips, other = compare_streams(fp["outs"], q["outs"],
                                         fp["margins"], q["margins"],
                                         fp["dtype"])
    drift = logit_drift(fp, q)
    worst = max(drift.values(), default=0.0)
    ratio = fp["bytes_per_token"] / q["bytes_per_token"]
    moe_stack = cfg.moe is not None
    gap = min((g[0] for ms in fp["margins"].values() for g in ms
               if g is not None), default=float("nan"))
    log(f"  int8 against fp32: {same} of {len(fp['outs'])} streams "
        f"identical" + ("" if not flips else "; parted at a tie: "
                        + "; ".join(flips))
        + f"; logit drift per decode step (token index: max |int8 - fp32|)"
        f" {{{', '.join(f'{j}: {x:.4f}' for j, x in sorted(drift.items()))}"
        f"}}, max {worst:.4f} (envelope 0.75"
        + (", held on dense-FFN stacks" if moe_stack else "")
        + f"); smallest fp32 top-2 gap "
        f"{gap:.3e}; host bytes per token fp32 / int8 = {ratio:.3f}; peak "
        f"device memory {peak:.2f} GiB; launches {launches} [{CARD}]")
    if other:
        fail("int8 streams part from fp32 by more than two logit ULPs: "
             + "; ".join(other))
    if worst <= 0.0:
        fail("the int8 run's logits equal the fp32 run's: the host tier "
             "never read int8")
    if not moe_stack and worst >= 0.75:
        fail(f"int8 logit drift {worst} outside the envelope 0.75")
    if not 3.9 < ratio < 4.0:
        fail(f"int8 pool stores {ratio:.3f}x fewer bytes per token, not ~4x")
    for label, r in runs.items():
        st, c = r["stats"], r["counts"]
        if st.host_fallbacks:
            fail(f"{label}: {st.host_fallbacks} host fallbacks on a healthy "
                 "run")
        if st.host_tokens <= 0:
            fail(f"{label}: no token was decoded on the host tier")
        if moe_stack and (c["dropless"] <= 0 or c["capacity"] <= 0):
            fail(f"{label}: the MoE ran only one of its paths: {c}")
    if q["stats"].host_kv_dtype_bytes != 1 \
            or fp["stats"].host_kv_dtype_bytes != 4:
        fail("the pools did not store int8 and fp32")
    if wrappers:
        # both runs: a decode per device-row iteration, a prefill per
        # admission bucket (six prompts, then two)
        iters = 2 * (out_len - 1)
        need = {"decode_attention": cfg.num_attn_layers * iters,
                "prefill_attention": cfg.num_attn_layers * 2 * 2}
        for name, n in need.items():
            if launches[name] < n:
                fail(f"{name} launched {launches[name]} times over the two "
                     f"runs; they need at least {n}")
    if traced_iters:
        share, ms_iter, per_kernel, _ = _traced_window(
            cfg, params, configs["int8"], prompts, out_len, traced_iters)
        log(f"  traced window (int8 pool, {traced_iters} iterations, "
            f"separate run): {ms_iter:.2f} ms per iteration, device busy "
            f"{100 * share:.1f}% of wall (idle {100 * (1 - share):.1f}%); "
            "top kernels by device time:")
        for key, ms in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]:
            log(f"    {ms:8.3f} ms/iter  {key[:100]}")
        port = {name: sum(ms for key, ms in per_kernel.items() if tag in key)
                for name, tag in PORT_KERNELS.items()}
        log("  the port's kernels, device ms per iteration: "
            + ", ".join(f"{name} {ms:.4f}" for name, ms in port.items()))
    return launches


def phase_serving_moe() -> dict:
    """deepseek-moe-16b at published width (28 layers, 64 routed experts
    top-6 + 2 shared, 16.9 B parameters, 33.8 GB in bf16), random weights
    from seed 0: both attention kernels held to their plain versions at
    its head geometry, then ``_serve_moe``; then ``_serve_moe`` on
    llama3.1-8b cut to 8 layers, which holds the int8 drift envelope.
    Its depth stays: cut to 14 layers, the int8 and fp32 streams parted
    at a top-2 gap of 0.094, past the two-ULP tie bar (measured on one H100)."""
    import dataclasses
    import gc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    gc.collect()            # earlier phases' engines hold reference cycles
    torch.cuda.empty_cache()
    check_moe_attention(torch.Generator(device="cuda").manual_seed(0))
    cfg = get_config("deepseek-moe-16b")
    e = cfg.moe
    log(f"  {cfg.name}: d_model {cfg.d_model}, heads {cfg.num_heads}/"
        f"{cfg.num_kv_heads} of {cfg.resolved_head_dim}, {e.num_experts} "
        f"experts top-{e.top_k} of width {e.expert_ffn_dim} + "
        f"{e.num_shared_experts} shared, vocab {cfg.vocab_size}, "
        f"{cfg.num_layers} layers, {cfg.param_dtype}, "
        f"{cfg.param_count() / 1e9:.2f} B parameters "
        f"({cfg.active_param_count() / 1e9:.2f} B active); host pool "
        f"{moe_pool_pages(cfg)} pages")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"  random weights from torch.Generator(seed 0) in "
        f"{time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    launches = _serve_moe(cfg, params, "cuda", traced_iters=12,
                          wrappers=_kernel_wrappers())
    del params
    torch.cuda.empty_cache()
    # the drift envelope's control: the same traffic, pools and checks on
    # a dense-FFN stack, where no expert choice can flip
    dense = dataclasses.replace(get_config("llama3.1-8b"), num_layers=8,
                                name="llama3.1-8b-8L")
    log(f"  control: {dense.name} at published width, dense FFN, "
        f"{dense.num_layers} layers")
    _serve_moe(dense, init_params(dense, seed=0, device="cuda"), "cuda",
               traced_iters=0)
    return launches


# ---------------------------------------------------------------------------
# profile
# ---------------------------------------------------------------------------


def phase_profile() -> tuple:
    """``OfflineProfiler`` on llama3.1-8b at published width (bf16, random
    weights from seed 0) over ``STARTUP_PROFILE_GRID``: every table point
    finite and positive, both attention kernels launched, the profile
    saved under chiprun_out/ and reloaded through ``file:`` unchanged, and
    the table model's predictions beside the analytic h100 model's at the
    chat traffic's operating points.  Returns (profile path, launches)."""
    import math
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.perf_model import (STARTUP_PROFILE_GRID,
                                             analytic_model,
                                             resolve_perf_model)
    from repro_torch.core.profiler import OfflineProfiler
    cfg = get_config("llama3.1-8b")
    wrappers = _kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    model = OfflineProfiler(cfg, seed=0, device="cuda").run(
        **STARTUP_PROFILE_GRID)
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in wrappers.items()}
    log(f"  {model.fingerprint}: profiled in {wall:.2f} s over "
        f"{dict(STARTUP_PROFILE_GRID)}; launches {launches} [{CARD}]")
    for op, (xs, ys) in model.tables.items():
        log(f"    {op:8s} " + "  ".join(f"{x:g}: {1e3 * y:.4f} ms"
                                        for x, y in zip(xs, ys)))
        if not all(math.isfinite(y) and y > 0 for y in ys):
            fail(f"profile table {op} has a point that is not finite and "
                 "positive")
    for name in ("decode_attention", "prefill_attention"):
        if launches[name] <= 0:
            fail(f"the profile never launched {name}")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    path = out / f"profile-{cfg.name}.json"
    model.save(str(path))
    loaded = resolve_perf_model(f"file:{path}", cfg, device="cuda")
    analytic = analytic_model("h100", cfg)
    for b in (2, 4, 6):
        for ctx in (128.0, 256.0, 512.0):
            for pre in (0, 64):
                if loaded.timings(b, ctx, pre) != model.timings(b, ctx, pre):
                    fail("the profile reloaded through file: predicts "
                         "other timings")
    log("  table (measured) against analytic h100, per iteration: "
        "t_glinear, t_gatt (all layers), t_catt (one layer, the cohort of "
        "b rows), n_g, n_c (KV positions/s); the 64-token chunk's "
        "t_glinear_pref, t_gatt_pref")
    for b in (2, 4, 6):
        for ctx in (128.0, 256.0, 512.0):
            cells = []
            for m in (model, analytic):
                t = m.timings(b, ctx, 64)
                cells.append(
                    f"{1e3 * t.t_glinear:.3f} / {1e3 * t.t_gatt:.4f} / "
                    f"{1e3 * m.t_catt(b, ctx, layers=1):.4f} ms, "
                    f"n_g {t.n_g:.3e}, n_c {t.n_c:.3e}; chunk "
                    f"{1e3 * t.t_glinear_pref:.3f} / "
                    f"{1e3 * t.t_gatt_pref:.3f} ms")
            log(f"    b {b} ctx {ctx:g}: table {cells[0]} | analytic "
                f"{cells[1]}")
    del model, loaded
    torch.cuda.empty_cache()
    return str(path), launches


# ---------------------------------------------------------------------------
# faults
# ---------------------------------------------------------------------------

# the reference's fault_soak (benchmarks/bench_engine.py bench_fault_soak)
FAULTS = dict(plan="host_error@2,host_stall@4:1.5,pool_alloc@2,"
              "latency_spike@3:0.05", requests=10, prompt_len=12,
              output_len=24, layers=8, device_slots=2, cache_len=128,
              page_size=32, pool_pages=512)


def _fault_config(**kw):
    from repro_torch.serving import EngineConfig
    kw = dict(dict(device_slots=FAULTS["device_slots"],
                   host_slots=FAULTS["requests"],
                   cache_len=FAULTS["cache_len"],
                   page_size=FAULTS["page_size"],
                   host_pool_pages=FAULTS["pool_pages"],
                   perf_model="analytic", tier_rebalance=False,
                   prefix_cache=False, device="cuda"), **kw)
    return EngineConfig(**kw)


def _fault_run(cfg, params, protos, **kw):
    """``protos`` through one engine at the soak's geometry; returns (the
    requests, stats, the engine, streams and per-token margins by index,
    wall seconds)."""
    import torch
    from repro_torch.serving import Engine, Request
    eng = Engine(cfg, params, _fault_config(**kw))
    reqs = [Request(prompt=list(p.prompt), max_new_tokens=p.max_new_tokens)
            for p in protos]
    with _Watch("cuda") as watch:
        try:
            t0 = time.perf_counter()
            eng.run(reqs, max_iterations=20000)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            eng.shutdown()
    if bool(watch.nan):
        fail("faults: a logit was NaN")
    margins = watch.margins()
    outs = {i: list(r.output) for i, r in enumerate(reqs)}
    marg = {i: [margins.get((r.request_id, j)) for j in range(len(r.output))]
            for i, r in enumerate(reqs)}
    return reqs, eng.stats, eng, outs, marg, wall, watch.dtype


def _pool_whole(eng, label: str) -> str:
    pool = eng.executor.pool
    text = check_pool(eng)
    if pool.num_free != pool.pages.shape[1] or pool.page_tables \
            or eng.lc.host_requests or eng.lc.host_slot_owner \
            or any(r is not None for r in eng.lc.slots):
        fail(f"{label}: pages, host slots or device slots leaked ({text})")
    return text


def phase_faults() -> dict:
    """The reference's fault soak on the port: llama3.1-8b at published
    width, depth cut to 8 layers (a host token costs 9 iterations), 10
    requests of prompt 12 -> 24 tokens over 2 device and 10 host slots.
    A fault-free control run, then the plan, the breaker plan, a blocked
    swap recomputed, and cancels of a queued request, a device resident
    and a host resident.  Returns the kernels' launches over the soak."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serving import (Engine, InferenceServer, Request,
                                     ServerConfig)
    from repro_torch.serving.faults import FaultPlan
    from repro_torch.serving.request import Phase, make_synthetic_request
    base = get_config("llama3.1-8b")
    cfg = dataclasses.replace(base, num_layers=FAULTS["layers"],
                              name=f"{base.name}-{FAULTS['layers']}L")
    params = init_params(cfg, seed=0, device="cuda")
    rng = np.random.default_rng(9)
    protos = [make_synthetic_request(rng, prompt_len=FAULTS["prompt_len"],
                                     output_len=FAULTS["output_len"],
                                     vocab=cfg.vocab_size)
              for _ in range(FAULTS["requests"])]
    log(f"  {cfg.name}: {cfg.num_layers} layers, {cfg.param_dtype}, "
        f"{cfg.param_count() / 1e9:.2f} B parameters; {len(protos)} "
        f"requests of {FAULTS['prompt_len']} -> {FAULTS['output_len']} "
        f"tokens; plan {FAULTS['plan']}")
    # warm-up (not measured): cuBLAS heuristics, allocator growth and the
    # first host jobs, so no healthy job misses its deadline
    _fault_run(cfg, params, protos[:4], host_slots=FAULTS["requests"])
    _, ctl, ctl_eng, ctl_out, ctl_m, ctl_wall, dtype = _fault_run(
        cfg, params, protos)
    log(f"  control (no faults): {ctl.iterations} iterations in "
        f"{ctl_wall:.2f} s, host tokens {ctl.host_tokens}, host fallbacks "
        f"{ctl.host_fallbacks}; pool: {_pool_whole(ctl_eng, 'control')}")
    if ctl.host_fallbacks != 0:
        fail(f"the fault-free control read {ctl.host_fallbacks} host "
             "fallbacks")
    if ctl.host_tokens <= 0:
        fail("the control never decoded on the host tier")

    def held_to_control(label, out, marg):
        same, flips, other = compare_streams(out, ctl_out, marg, ctl_m,
                                             dtype)
        if other:
            fail(f"{label}: streams part from the control by more than two "
                 "logit ULPs: " + "; ".join(other))
        return f"{same} of {len(out)} streams identical to the control" + (
            "" if not flips else " (parted at a tie: " + "; ".join(flips)
            + ")")

    wrappers = _kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    reqs, st, eng, out, marg, wall, _ = _fault_run(
        cfg, params, protos, fault_plan=FAULTS["plan"])
    launches = {name: fn.launches for name, fn in wrappers.items()}
    fired = eng.faults.snapshot()["fired"]
    log(f"  soak: {st.iterations} iterations in {wall:.2f} s; host "
        f"fallbacks {st.host_fallbacks}, breaker trips "
        f"{st.host_breaker_trips}, faults fired "
        f"{ {k: n for k, n in fired.items() if n} }, degradation "
        f"{st.degradation()}; {held_to_control('soak', out, marg)}; pool: "
        f"{_pool_whole(eng, 'soak')}; decode attention launches "
        f"{launches['decode_attention']} [{CARD}]")
    if any(r.failed or not r.done for r in reqs):
        fail("soak: a request did not complete")
    if st.host_fallbacks < 1:
        fail("soak: no host fallback")
    planned = {s.kind: s.count
               for s in FaultPlan.parse(FAULTS["plan"]).specs}
    if any(fired[k] != n for k, n in planned.items()):
        fail(f"soak: faults fired {fired}, planned {planned}")

    reqs, st, eng, out, marg, wall, _ = _fault_run(
        cfg, params, protos, fault_plan="host_error@1x3",
        host_breaker_threshold=3, host_breaker_cooldown=0.05)
    log(f"  breaker (host_error@1x3, threshold 3, cooldown 0.05 s): host "
        f"fallbacks {st.host_fallbacks}, breaker trips "
        f"{st.host_breaker_trips}; {held_to_control('breaker', out, marg)};"
        f" pool: {_pool_whole(eng, 'breaker')}")
    if st.host_fallbacks < 3 or st.host_breaker_trips < 1:
        fail("breaker: it never tripped")

    # a blocked swap: the one-page pool cannot take the victim, so the
    # urgent admission recomputes it from scratch
    eng = Engine(cfg, params, _fault_config(
        device_slots=1, host_slots=1, cache_len=256, host_pool_pages=1,
        tier_rebalance=True))
    try:
        resident = Request(prompt=[1] * 12, max_new_tokens=16)
        eng.submit(resident)
        eng.step()
        urgent = Request(prompt=[2] * 200, max_new_tokens=4, priority=1)
        eng.submit(urgent)
        while eng.has_work and eng.stats.iterations < 4000:
            eng.step()
        rec = eng.stats.preemption_recomputes
        ok = all(r.done and not r.failed for r in (resident, urgent))
    finally:
        eng.shutdown()
    log(f"  blocked swap: {rec} recompute preemptions, both requests "
        f"{'completed' if ok else 'NOT completed'}")
    if rec < 1 or not ok:
        fail("blocked swap: no recompute preemption, or a request failed")

    # cancels: 13 requests fill 2 device and 10 host slots, one queues
    rng = np.random.default_rng(10)
    scfg = ServerConfig(**dataclasses.asdict(_fault_config()))
    with InferenceServer(cfg, params, scfg) as server:
        eng = server.engine
        handles = [server.submit(make_synthetic_request(
            rng, prompt_len=FAULTS["prompt_len"],
            output_len=FAULTS["output_len"], vocab=cfg.vocab_size))
            for _ in range(13)]
        for _ in range(200):
            server.step()
            if eng._cohort is not None and eng._cohort.attn_ptr != -1:
                break               # mid-journey: the host cancel defers
        queued = next(h for h in handles if h.phase is Phase.QUEUED)
        device = next(r for r in eng.slots if r is not None)
        host = next(r for r in eng.lc.host_requests.values()
                    if r.phase is Phase.DECODE_HOST)
        for rid in (queued.request_id, device.request_id, host.request_id):
            if not server.cancel(rid):
                fail(f"cancel of live request {rid} returned False")
        server.run_until_idle()
        st = server.stats
        survivors = [h for h in handles if h.request_id not in (
            queued.request_id, device.request_id, host.request_id)]
        pool = _pool_whole(eng, "cancel")
    log(f"  cancel (a queued request, a device resident, a host resident "
        f"mid-journey): cancelled {st.cancelled}; survivors "
        f"{sum(h.done and not h.failed for h in survivors)} of "
        f"{len(survivors)} finished; pool: {pool}")
    if st.cancelled != 3 or any(h.failed or not h.done for h in survivors):
        fail("cancel: wrong count, or a survivor did not finish")
    del params
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# cli
# ---------------------------------------------------------------------------


def _serve_cli(*extra: str, cli: str = "serve") -> str:
    """Run ``python -m repro_torch.launch.<cli>`` with ``extra``; fail
    unless it exits 0.  Returns its standard output."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", f"repro_torch.launch.{cli}",
                           *extra], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=600)
    for line in proc.stdout.strip().splitlines()[-7:]:
        log(f"  | {line}")
    if proc.returncode != 0:
        log(proc.stderr[-3000:])
        fail(f"python -m repro_torch.launch.{cli} {' '.join(extra)} exited "
             f"{proc.returncode}")
    log(f"  launch.{cli} {' '.join(extra) or 'with its defaults'}: exit 0 "
        f"in {time.perf_counter() - t0:.1f} s")
    return proc.stdout


def phase_cli() -> None:
    """The serve CLI with its defaults (the measured perf model, profiled
    at startup), then with one injected host-worker death, which the
    watchdog must absorb, then an MoE arch (reduced) on the analytic perf
    model with the int8 host pool."""
    import re
    out = _serve_cli()
    if "perf_model=measured" not in out:
        fail("launch.serve's default perf model is not 'measured'")
    out = _serve_cli("--fault-plan", "host_error@2")
    m = re.search(r"host_fallbacks=(\d+)", out)
    if m is None or int(m.group(1)) < 1:
        fail("launch.serve --fault-plan host_error@2 printed no host "
             "fallback")
    out = _serve_cli("--arch", "deepseek-moe-16b", "--perf-model",
                     "analytic", "--host-kv-dtype", "int8")
    m = re.search(r"tokens: device=(\d+) host=(\d+)", out)
    if "host pool (int8, 1 B per element)" not in out or m is None \
            or int(m.group(2)) < 1:
        fail("launch.serve --arch deepseek-moe-16b --host-kv-dtype int8 "
             "decoded no token on an int8 host pool")
    # the xLSTM stack (GPU-only) and the VLM as a text model, reduced
    for extra, host in ((("--arch", "xlstm-125m", "--perf-model",
                          "analytic"), False), (("--arch", "paligemma-3b"),
                                                True)):
        out = _serve_cli(*extra)
        m = re.search(r"tokens: device=(\d+) host=(\d+)", out)
        if m is None or int(m.group(1)) < 1 or (int(m.group(2)) > 0) != host:
            fail(f"launch.serve {' '.join(extra)}: tokens "
                 f"{m.groups() if m else None}, want host tokens: {host}")


# ---------------------------------------------------------------------------
# the rest of the reference registry at published width
# ---------------------------------------------------------------------------


def _free_device() -> None:
    import gc
    import torch
    gc.collect()            # earlier phases' engines hold reference cycles
    torch.cuda.empty_cache()


def _new_params(cfg):
    """Random bf16 weights from seed 0 on the card, timed."""
    import torch
    from repro_torch.models import init_params
    log(f"  {cfg.name}: d_model {cfg.d_model}, heads {cfg.num_heads}/"
        f"{cfg.num_kv_heads} of {cfg.resolved_head_dim}, d_ff {cfg.d_ff}, "
        f"vocab {cfg.vocab_size}, {cfg.num_layers} layers "
        f"{[k.value for k in cfg.block_pattern]}, {cfg.param_dtype}, "
        f"{cfg.param_count() / 1e9:.2f} B parameters")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"  random weights from torch.Generator(seed 0) in "
        f"{time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    return params


def phase_serving_registry() -> dict:
    """stablelm-12b (head_dim 160), internlm2-20b (group 6, cut to 16 of
    its 48 layers) and llama3-405b (group 16, cut to 4 of its 126) at
    published width in bf16, REGISTRY_SERVE's traffic through
    ``_serve_published``."""
    import dataclasses
    from repro_torch.configs import get_config
    total = {}
    for name, layers in REGISTRY_LAYERS.items():
        cfg = get_config(name)
        if layers != cfg.num_layers:
            cfg = dataclasses.replace(cfg, num_layers=layers,
                                      name=f"{name}-{layers}L")
        log(f"  -- {cfg.name}: group {cfg.q_per_kv}, head_dim "
            f"{cfg.resolved_head_dim}")
        t0 = time.perf_counter()
        counts = _serve_published(cfg, 0, REGISTRY_SERVE)
        _free_device()
        log(f"  {cfg.name}: {time.perf_counter() - t0:.1f} s with set-up")
        total = {k: total.get(k, 0) + n for k, n in counts.items()}
    return total


@contextlib.contextmanager
def _plain_recurrences(on: bool):
    """Inside the block (when ``on``), ``kernels.ops`` sends CUDA tensors
    of the xLSTM recurrences to their plain loops instead of the kernels:
    the path before this port had the kernels, for a comparison in the
    same run."""
    from repro_torch.kernels import ref, xlstm
    saved = xlstm.slstm_scan_cuda, xlstm.mlstm_scan_cuda
    if on:
        xlstm.slstm_scan_cuda = ref.slstm_recurrence_ref
        xlstm.mlstm_scan_cuda = ref.mlstm_recurrence_ref
    try:
        yield
    finally:
        xlstm.slstm_scan_cuda, xlstm.mlstm_scan_cuda = saved


def phase_serving_xlstm() -> dict:
    """xlstm-125m at published width and depth (12 layers of mLSTM and
    sLSTM blocks, d_model 768, 4 heads, vocab 50304) in bf16, served
    GPU-only (no KV cache: offload off): serving-chunked's chat traffic
    with the reference's defaults but one prefix-cache device row per
    conversation (without a host pool an entry evicted from the default
    two rows is dropped, and four conversations then never hit), then
    with the prefix cache, rebalancing and preemption off; the streams
    must be equal up to two-ULP ties.  At fp32 parameters a recurrent stack is not
    chunk-boundary invariant (its conv window is bf16), hence bf16.  Both
    recurrences' kernels must launch.  Then a traced window of decode
    iterations, and the same window with the plain loops patched in
    for the kernels (the path before they existed), in turns."""
    import numpy as np
    from repro_torch.configs import get_config
    _free_device()
    cfg = get_config("xlstm-125m")
    params = _new_params(cfg)
    wrappers = _kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    scfg = chat_config(cfg, "cuda",
                       prefix_cache_slots=CHAT["conversations"])
    on, stats, wall, (watch, on_m), eng, _ = chat_run(cfg, params, scfg)
    launches = {name: fn.launches for name, fn in wrappers.items()}
    if eng.e.enable_offload or stats.host_tokens:
        fail("xlstm-125m: the host tier ran (it has no KV cache)")
    if min(launches["slstm_recurrence"], launches["mlstm_recurrence"]) <= 0:
        fail(f"xlstm-125m: a recurrence kernel did not run: {launches}")
    off, off_stats, off_wall, (off_watch, off_m), _, _ = chat_run(
        cfg, params, chat_config(cfg, "cuda", **FEATURES_OFF))
    counters = dict(prefill_chunks=stats.prefill_chunks,
                    chunk_co_run_iterations=stats.chunk_co_run_iterations,
                    prefix_device_hits=stats.prefix_device_hits)
    log(f"  defaults: {stats.iterations} iterations in {wall:.2f} s "
        f"({1e3 * wall / stats.iterations:.2f} ms per iteration), "
        f"{(stats.device_tokens) / wall:.2f} output tokens/s, TTFT p50 "
        f"{stats.ttft_p50 * 1e3:.1f} ms, ITL p50 "
        f"{(stats.itl_p50 or 0) * 1e3:.1f} ms, {counters}; features off: "
        f"{off_stats.iterations} iterations in {off_wall:.2f} s; launches "
        f"{launches} [{CARD}]")
    if bool(watch.nan) or bool(off_watch.nan):
        fail("xlstm-125m: a logit was NaN")
    zero = [k for k, n in counters.items() if n <= 0]
    if zero:
        fail(f"xlstm-125m: {zero} did not fire")
    same, flips, other = compare_streams(on, off, on_m, off_m, watch.dtype)
    log(f"  {same} of {len(on)} streams identical to the features-off run"
        + ("" if not flips else "; parted at a tie: " + "; ".join(flips)))
    if other:
        fail("xlstm-125m: streams part by more than two logit ULPs: "
             + "; ".join(other))
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, 128).tolist()
               for _ in range(CHAT["device_slots"])]
    for label, plain in (("plain loops", True), ("kernels", False),
                         ("kernels", False), ("plain loops", True)):
        with _plain_recurrences(plain):
            share, ms_iter, per_kernel, _ = _traced_window(
                cfg, params, scfg, prompts, 32, 16)
        log(f"  traced window, {label} (16 decode iterations, separate "
            f"run): {ms_iter:.2f} ms per iteration, device busy "
            f"{100 * share:.1f}% (idle {100 * (1 - share):.1f}%) [{CARD}]; "
            "top kernels:")
        for key, ms in sorted(per_kernel.items(),
                              key=lambda kv: -kv[1])[:4]:
            log(f"    {ms:8.3f} ms/iter  {key[:100]}")
    del params, eng
    _free_device()
    return launches


def phase_vlm() -> dict:
    """paligemma-3b at published width and depth (18 layers, d_model 2048,
    MQA 8/1 heads of 256, d_ff 16384, vocab 257216, tied embeddings):
    first served as the reference's engine serves it, a text model
    (MAIN's traffic, ``_serve_published``, bf16); then ``model.prefill``
    over 256 random patch embeddings + 32 text tokens on 4 rows and 8
    greedy decode steps, held as the reference's prefill/decode
    consistency test holds them: against ``forward_train``'s
    teacher-forced logits at 2e-2.  That check runs in fp32 with an fp32
    cache: in bf16 the two paths round in other places, and 18 layers
    put their logits (up to ~8) several bf16 ULPs apart (0.14), where
    the reference's test runs 2 layers of d_model 64.  The bf16 kernels
    are held at this prefix shape in phase 2."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import (decode_step, forward_train,
                                    init_decode_state, prefill)
    _free_device()
    cfg = get_config("paligemma-3b")
    launches = _serve_published(cfg, traced_iters=12)
    _free_device()
    cfg = dataclasses.replace(cfg, param_dtype="float32",
                              compute_dtype="float32")
    params = _new_params(cfg)
    gen = torch.Generator(device="cuda").manual_seed(1)
    b, n_pre, n_text, steps = (VLM["rows"], VLM["patches"], VLM["text"],
                               VLM["decode_steps"])
    patches = _randn(gen, (b, n_pre, cfg.d_model), torch.float32, "cuda")
    text = torch.randint(0, cfg.vocab_size, (b, n_text), generator=gen,
                         device="cuda")
    state = init_decode_state(cfg, device_batch=b,
                              cache_len=n_pre + n_text + steps + 1,
                              device="cuda", kv_dtype=torch.float32)
    wrappers = _kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    logits, state = prefill(params, cfg, {"patches": patches,
                                          "tokens": text}, state)
    steps_out, toks = [logits], []
    for _ in range(steps):
        toks.append(steps_out[-1].argmax(-1))
        logits, state, _, _ = decode_step(params, cfg, toks[-1], state)
        steps_out.append(logits)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {name: fn.launches for name, fn in wrappers.items()}
    full, _ = forward_train(params, cfg, {
        "patches": patches, "tokens": torch.cat([text] + [
            t[:, None] for t in toks], dim=1)})
    start = n_pre + n_text - 1
    worst = 0.0
    for i, got in enumerate(steps_out[:-1]):
        err, ok = close(got, full[:, start + i], 2e-2)
        worst = max(worst, err)
        if not ok:
            fail(f"paligemma-3b: {'prefill' if i == 0 else f'decode {i}'} "
                 f"logits part from forward_train's by {err:.3e}")
    log(f"  fp32 prefix-LM prefill of {n_pre} patches + {n_text} tokens on "
        f"{b} rows and {steps} decode steps in {wall:.3f} s; every step's "
        f"logits within 2e-2 of forward_train's (max |diff| {worst:.3e}); "
        f"launches {counts} [{CARD}]")
    n_attn = cfg.num_attn_layers
    if counts["prefill_attention"] < n_attn \
            or counts["decode_attention"] < n_attn * steps:
        fail(f"paligemma-3b: launches {counts} below {n_attn} prefill and "
             f"{n_attn * steps} decode")
    del params, state, full
    _free_device()
    return {name: launches[name] + counts[name] for name in launches}


def phase_encoder() -> dict:
    """hubert-xlarge at published width and depth (48 layers, d_model 1280,
    16 heads of 80, vocab 504): ``forward_train`` over 4 x 500 random
    frame embeddings (ten seconds of audio at 50 Hz) through the
    full-attention prefill kernel; finite logits of (4, 500, 504).  Its
    first two layers on the card (bf16, the kernel) are held against the
    port's fp32 forward of the same weights on the CPU (the plain
    versions) at atol = rtol = 5e-2: bf16's 8-bit mantissa rounds the
    weights, activations and the kernel's probabilities, and the plain
    version in bf16 alone is 0.026 off the fp32 one on such an input."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import ModelParams, forward_train
    _free_device()
    cfg = get_config("hubert-xlarge")
    params = _new_params(cfg)
    gen = torch.Generator(device="cuda").manual_seed(2)
    frames = _randn(gen, (ENCODER["rows"], ENCODER["frames"], cfg.d_model),
                    torch.bfloat16, "cuda")
    wrappers = _kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    logits, _ = forward_train(params, cfg, {"embeds": frames})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {name: fn.launches for name, fn in wrappers.items()}
    want = (ENCODER["rows"], ENCODER["frames"], cfg.vocab_size)
    finite = bool(torch.isfinite(logits.float()).all())
    log(f"  forward_train over {want[0]} x {want[1]} frames in {wall:.3f} "
        f"s (first call): logits {tuple(logits.shape)}, finite {finite}; "
        f"launches {counts} [{CARD}]")
    if tuple(logits.shape) != want or not finite:
        fail(f"hubert-xlarge: logits {tuple(logits.shape)}, finite "
             f"{finite}")
    if counts["prefill_attention"] < cfg.num_attn_layers:
        fail(f"hubert-xlarge: prefill_attention launched "
             f"{counts['prefill_attention']} times for "
             f"{cfg.num_attn_layers} layers")
    n = ENCODER["check_layers"]
    short = dataclasses.replace(cfg, num_layers=n)
    cut = ModelParams(params.embedding, tuple(
        {name: {k: w[:n] for k, w in sub.items()} for name, sub in e.items()}
        for e in params.blocks), params.final_norm)
    card, _ = forward_train(cut, short, {"embeds": frames})
    f32 = dataclasses.replace(short, param_dtype="float32",
                              compute_dtype="float32")
    cpu = ModelParams(*(torch.utils._pytree.tree_map(
        lambda a: a.float().cpu(), part) for part in cut))
    plain, _ = forward_train(cpu, f32, {"embeds": frames.float().cpu()})
    err, ok = close(card.float().cpu(), plain, 5e-2)
    log(f"  first {n} layers, bf16 on the card against fp32 on the CPU: "
        f"max |diff| {err:.3e} (logits up to "
        f"{float(plain.abs().max()):.3f})")
    if not ok:
        fail(f"hubert-xlarge: the card's {n}-layer logits part from the "
             f"CPU's fp32 ones by {err:.3e}")
    del params, cut, logits, card
    _free_device()
    return counts


# ---------------------------------------------------------------------------
# the HTTP/SSE gateway over engine replicas
# ---------------------------------------------------------------------------

# llama3.1-8b at published width behind the gateway: replicas share one
# copy of the weights; each runs the reference's default serving path
# (chunk 64, prefix cache, rebalancing, preemption) on 2 device + 2 host
# slots over an fp32 host pool, Algorithm 1 on one measured profile
GATEWAY = dict(replicas=2, device_slots=2, host_slots=2, cache_len=512,
               page_size=32, clients=4, per_client=2, prompt_len=128,
               output_len=16, conversations=2, turns=3, turn_tokens=32,
               crash_at=6, crash_output=32, backlog=16, layers=8)
CRASH_REASON = ("replica 0 driver died: FaultInjectedError: replica driver "
                "crash (injected)")


def gateway_config(cfg, profile: Path, **kw):
    from repro_torch.serving import ServerConfig
    g = GATEWAY
    pages_per_row = g["cache_len"] // g["page_size"]
    base = dict(device_slots=g["device_slots"], host_slots=g["host_slots"],
                cache_len=g["cache_len"], page_size=g["page_size"],
                # each host slot a whole cache, and as much again for the
                # prefix cache's chains
                host_pool_pages=cfg.num_attn_layers * pages_per_row
                * 2 * g["host_slots"],
                device="cuda", perf_model="measured",
                profile_cache=str(profile),
                # two replicas in one process: half the cores each for
                # their host-attention workers
                host_workers=max(1, (os.cpu_count() or 2) // 2),
                output_len=g["output_len"])
    return ServerConfig(**{**base, **kw})


def _gateway_pool(cfg, params, scfg, replicas: int, first_plan=None):
    """``replicas`` InferenceServers over the one ``params``, behind an
    EngineReplicaPool; the factory's first build carries the fault plan
    ``first_plan`` (later builds, respawns included, carry none)."""
    import dataclasses
    from repro_torch.serving import InferenceServer
    from repro_torch.serving.gateway import EngineReplicaPool
    builds = []

    def factory():
        plan = first_plan if not builds else None
        builds.append(plan)
        return InferenceServer(cfg, params,
                               dataclasses.replace(scfg, fault_plan=plan))

    return EngineReplicaPool(factory, replicas=replicas)


def _check_shared_weights(pool, params) -> str:
    import torch
    leaves = torch.utils._pytree.tree_leaves(params)
    ptrs = sorted(t.data_ptr() for t in leaves)
    for rep in pool.replicas:
        mine = torch.utils._pytree.tree_leaves(rep.server.engine.params)
        if sorted(t.data_ptr() for t in mine) != ptrs:
            fail(f"gateway: replica {rep.index} does not share the weights' "
                 "storage")
    nbytes = sum(t.numel() * t.element_size() for t in leaves)
    return (f"{len(leaves)} weight tensors ({nbytes / 2**30:.2f} GiB) shared "
            f"by all {len(pool.replicas)} replicas (same data_ptr)")


def _burst(port: int, prompts, out_len: int, clients: int):
    """A closed loop over real sockets: ``clients`` threads, each sending
    its share of ``prompts`` one after another through ``POST /v1/chat``.
    Returns (SSE results by prompt index, wall seconds)."""
    import threading
    from repro_torch.serving.gateway.client import sse_chat
    results = {}
    lock = threading.Lock()

    def client(share):
        for i in share:
            r = sse_chat("127.0.0.1", port, prompts[i],
                         max_new_tokens=out_len, timeout=600.0)
            with lock:
                results[i] = r

    threads = [threading.Thread(target=client, args=(
        range(c, len(prompts), clients),)) for c in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900.0)
    if any(t.is_alive() for t in threads) or len(results) != len(prompts):
        fail(f"gateway: {len(results)} of {len(prompts)} SSE streams "
             "returned")
    return results, time.perf_counter() - t0


def _iterations(pool) -> dict:
    """Replica -> (iterations, host-row tokens) so far."""
    return {s["replica"]: (int(s["iterations"]), int(s["host_tokens"]))
            for s in pool.stats()}


def _burst_numbers(label: str, results: dict, wall: float, pool,
                   before: dict) -> float:
    """Print a burst's output tokens/s, TTFT and ITL from the SSE client's
    clock, and each replica's iterations and host-row tokens since
    ``before``."""
    import numpy as np
    ttft = [r["ttft_s"] for r in results.values() if r["ttft_s"] is not None]
    itl = [x for r in results.values() for x in r["itl_s"]]
    n = sum(len(r["tokens"]) for r in results.values())
    now = _iterations(pool)
    iters = {i: now[i][0] - before[i][0] for i in now}
    host = {i: now[i][1] - before[i][1] for i in now}
    log(f"  {label}: {len(results)} streams, {n} tokens in {wall:.3f} s: "
        f"{n / wall:.2f} output tokens/s; TTFT p50 "
        f"{1e3 * np.percentile(ttft, 50):.1f} ms, p95 "
        f"{1e3 * np.percentile(ttft, 95):.1f} ms, ITL p50 "
        f"{1e3 * np.percentile(itl, 50):.1f} ms (the SSE client's clock); "
        f"iterations per replica {iters} ({sum(iters.values()) / wall:.2f} "
        f"a second over all, {1e3 * wall / max(iters.values()):.1f} ms each "
        f"on the busiest), host-row tokens {host} [{CARD}]")
    return n / wall


def _check_streams(label: str, results: dict, out_len: int) -> None:
    bad = {i: (r["status"], r.get("error"), len(r["tokens"]))
           for i, r in results.items()
           if r["status"] != 200 or r["error"] or len(r["tokens"]) != out_len}
    if bad:
        fail(f"gateway {label}: streams without {out_len} tokens "
             f"(status, error, tokens): {bad}")


def _wait(predicate, what: str, timeout: float = 120.0) -> None:
    deadline = time.perf_counter() + timeout
    while not predicate():
        if time.perf_counter() > deadline:
            fail(f"gateway: {what} within {timeout:.0f} s")
        time.sleep(0.05)


def _gateway_sessions(port: int, pool, prompts) -> None:
    """``conversations`` chats of ``turns`` turns, one thread each, with a
    ``session_id``: each turn's prompt is the last one, its output and
    ``turn_tokens`` new tokens.  Every follow-up must land on the
    conversation's pinned replica, and that replica must record a prefix
    hit for each."""
    import threading
    from repro_torch.serving.gateway.client import sse_chat
    g = GATEWAY
    first, news = prompts
    before = {s["replica"]: s["prefix_hits"] for s in pool.stats()}
    served = {c: [] for c in range(g["conversations"])}

    def chat(c):
        prompt = first[c]
        for turn in range(g["turns"]):
            r = sse_chat("127.0.0.1", port, prompt,
                         max_new_tokens=g["output_len"],
                         session_id=f"conversation-{c}", timeout=600.0)
            served[c].append(r)
            if r["status"] != 200 or r["error"]:
                return
            if turn + 1 < g["turns"]:
                prompt = prompt + r["tokens"] + news[c][turn]

    threads = [threading.Thread(target=chat, args=(c,)) for c in served]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900.0)
    follow_ups = {}
    for c, turns in served.items():
        _check_streams(f"session {c}", dict(enumerate(turns)), g["output_len"])
        if len(turns) != g["turns"]:
            fail(f"gateway: conversation {c} ran {len(turns)} turns")
        reps = [r["done"]["replica"] for r in turns]
        if len(set(reps)) != 1:
            fail(f"gateway: conversation {c} moved between replicas {reps}")
        follow_ups[reps[0]] = follow_ups.get(reps[0], 0) + len(turns) - 1
    after = {s["replica"]: s["prefix_hits"] for s in pool.stats()}
    hits = {i: int(after[i] - before[i]) for i in follow_ups}
    log(f"  sessions: {len(served)} conversations x {g['turns']} turns, "
        f"pinned to replicas {sorted(follow_ups)}; follow-ups per replica "
        f"{follow_ups}, prefix hits recorded {hits}")
    short = {i: (hits[i], n) for i, n in follow_ups.items() if hits[i] < n}
    if short:
        fail(f"gateway: pinned replicas recorded fewer prefix hits than "
             f"follow-ups (hits, follow-ups): {short}")


def _gateway_backpressure(pool, prompts) -> None:
    """503 from a gateway whose queue is full, and 429 for a deadline that
    the queued backlog makes impossible (the same deadline is possible on
    an idle pool)."""
    from repro_torch.serving.gateway import serve_in_thread
    from repro_torch.serving.gateway.client import sse_chat
    g = GATEWAY
    stops, held = [], []
    try:
        idle = pool.admission_estimate(g["prompt_len"])
        held.append(pool.submit(prompts[0], g["output_len"]))
        narrow, stop = serve_in_thread(pool, port=0, max_queue_depth=1)
        stops.append(stop)
        r = sse_chat("127.0.0.1", narrow.port, prompts[1],
                     max_new_tokens=g["output_len"], timeout=120.0)
        if r["status"] != 503 or "queue full" not in str(r["error"]):
            fail(f"gateway: a full queue (depth 1) answered {r['status']}: "
                 f"{r.get('body')}")
        wide, stop = serve_in_thread(pool, port=0, max_queue_depth=64)
        stops.append(stop)
        held += [pool.submit(prompts[i % len(prompts)], g["output_len"])
                 for i in range(g["backlog"] - 1)]
        deadline = 1.5 * idle
        r = sse_chat("127.0.0.1", wide.port, prompts[2],
                     max_new_tokens=g["output_len"], deadline=deadline,
                     timeout=120.0)
        queued = sum(len(rep.server.engine.queue.snapshot())
                     for rep in pool.live_replicas())
        if r["status"] != 429 or "deadline" not in str(r["error"]):
            fail(f"gateway: a {deadline:.4f} s deadline behind "
                 f"{g['backlog']} requests answered {r['status']}: "
                 f"{r.get('body')}")
        log(f"  backpressure: 503 at queue depth 1; 429 for a "
            f"{1e3 * deadline:.2f} ms deadline behind {g['backlog']} "
            f"requests ({queued} still queued after the answer): predicted "
            f"TTFT {1e3 * r['body']['predicted_ttft']:.2f} ms against "
            f"{1e3 * idle:.2f} ms on the idle pool")
    finally:
        for h in held:
            h.cancel()
        for h in held:
            list(h.events(timeout=120.0))
        for stop in stops:
            stop()
    _wait(lambda: pool.depth() == 0, "the cancelled backlog did not drain")


def _gateway_crash(cfg, params, scfg, prompts, profile: Path) -> None:
    """A ``driver_crash`` fault plan on replica 0's first build: its
    in-flight streams end with the crash's error event, replica 1's finish
    cleanly, the pool respawns replica 0 once (generation 1, loading the
    profile, not taking it), ``/health`` is green again, and the next
    request finishes on the respawned replica."""
    import torch
    from repro_torch.serving.gateway import serve_in_thread
    from repro_torch.serving.gateway.client import get_json, sse_chat
    g = GATEWAY
    stamp = profile.stat().st_mtime_ns
    torch.cuda.reset_peak_memory_stats()
    pool = _gateway_pool(cfg, params, scfg, 2,
                         first_plan=f"driver_crash@{g['crash_at']}")
    gateway, stop = serve_in_thread(pool, port=0)
    try:
        dead = pool.replicas[0]
        results, _ = _burst(gateway.port, prompts, g["crash_output"],
                            len(prompts))
        _wait(lambda: pool.respawns >= 1 and pool.replicas[0].alive,
              "replica 0 was not respawned")
        errs = {i: r["error"] for i, r in results.items() if r["error"]}
        on0 = [i for i, r in results.items() if r["done"]["replica"] == 0]
        clean = {i: r for i, r in results.items()
                 if r["done"]["replica"] == 1}
        if not errs or set(errs) - set(on0) \
                or set(errs.values()) != {CRASH_REASON}:
            fail(f"gateway: the crash's streams ended with {errs} (replica "
                 f"0 served {on0}); want {CRASH_REASON!r} on replica 0 only")
        if not clean:
            fail("gateway: replica 1 served none of the crash burst")
        _check_streams("crash burst, replica 1", clean, g["crash_output"])
        fired = dead.server.engine.faults.snapshot()["fired"]
        health = get_json("127.0.0.1", gateway.port, "/health")
        _wait(lambda: get_json("127.0.0.1", gateway.port, "/health")[
            "body"]["status"] == "ok", "/health did not return to ok")
        r = sse_chat("127.0.0.1", gateway.port, prompts[0],
                     max_new_tokens=g["output_len"], timeout=600.0)
        _check_streams("after the respawn", {0: r}, g["output_len"])
        fresh, other = pool.replicas
        log(f"  crash: driver_crash@{g['crash_at']} on replica 0 ended "
            f"{len(errs)} of its {len(on0)} streams with {CRASH_REASON!r}; "
            f"replica 1 finished {len(clean)} of {len(results)} cleanly; "
            f"faults fired {fired}; respawns {pool.respawns}, generations "
            f"{[rep.generation for rep in pool.replicas]}; /health "
            f"{health['body']['status']} after the crash, ok again; the next "
            f"request ran on replica {r['done']['replica']} (generation "
            f"{fresh.generation}); peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB with the "
            f"dead replica's state still held [{CARD}]")
        if fired.get("driver_crash") != 1 or pool.respawns != 1:
            fail(f"gateway: {fired} fired and {pool.respawns} respawns; want "
                 "exactly one crash and one respawn")
        if (fresh.generation, other.generation) != (1, 0) \
                or r["done"]["replica"] != 0 or fresh.server.engine.faults \
                or other.error is not None or dead.error != CRASH_REASON:
            fail(f"gateway: after the respawn generations "
                 f"{(fresh.generation, other.generation)}, the next request "
                 f"on replica {r['done']['replica']}, errors "
                 f"{(dead.error, other.error)}")
        if profile.stat().st_mtime_ns != stamp:
            fail("gateway: a replica build wrote the profile again instead "
                 "of loading it")
    finally:
        stop()
        pool.shutdown()


def _one_replica_burst(cfg, params, scfg, prompts, warm, label: str
                       ) -> float:
    """The burst through a gateway over one replica (after a one-request
    warm-up); returns its output tokens/s."""
    from repro_torch.serving.gateway import serve_in_thread
    g = GATEWAY
    pool = _gateway_pool(cfg, params, scfg, 1)
    gateway, stop = serve_in_thread(pool, port=0, max_queue_depth=64)
    try:
        _burst(gateway.port, [warm], 2, 1)
        before = _iterations(pool)
        results, wall = _burst(gateway.port, prompts, g["output_len"],
                               g["clients"])
        _check_streams(label, results, g["output_len"])
        return _burst_numbers(label, results, wall, pool, before)
    finally:
        stop()
        pool.shutdown()
        _free_device()


def phase_gateway() -> dict:
    """llama3.1-8b at published width, cut to 8 layers (16 until the
    whole run came within one slow host of its 1200 s limit), behind the
    HTTP/SSE gateway, two replicas sharing its weights: a closed-loop
    burst over real sockets (streams equal to a direct InferenceServer
    run up to two-ULP ties, /health, /metrics, no host fallback), sticky
    sessions with prefix hits, backpressure (503, 429), a driver crash
    and its respawn, the burst on one replica (as configured, and with
    both replicas' device slots), and the gateway CLI.  Returns the
    burst's launches."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.perf_model import resolve_perf_model
    from repro_torch.kernels import build
    from repro_torch.serving import InferenceServer, Request
    from repro_torch.serving.gateway import serve_in_thread
    from repro_torch.serving.gateway.client import get_json, get_text
    g = GATEWAY
    t_phase = time.perf_counter()
    build.load_all()            # no replica's first step pays for nvcc
    # 16 of llama's 32 layers: at 32 the phase took 148 s (the direct run
    # and the one-replica burst 100 s of it), and training needed the time
    cfg = dataclasses.replace(get_config("llama3.1-8b"),
                              num_layers=g["layers"],
                              name=f"llama3.1-8b-{g['layers']}L")
    params = _new_params(cfg)
    profile = ROOT / "chiprun_out" / f"profile-gateway-{cfg.name}.json"
    profile.parent.mkdir(exist_ok=True)
    profile.unlink(missing_ok=True)
    t0 = time.perf_counter()
    resolve_perf_model("measured", cfg, profile_cache=str(profile),
                       device="cuda")
    log(f"  measured profile taken once in {time.perf_counter() - t0:.2f} s "
        f"into {profile.relative_to(ROOT)}; every replica build loads it")
    scfg = gateway_config(cfg, profile)
    rng = np.random.default_rng(0)
    v, plen, n_out = cfg.vocab_size, g["prompt_len"], g["output_len"]
    prompts = [rng.integers(0, v, plen).tolist()
               for _ in range(g["clients"] * g["per_client"])]
    warm = [rng.integers(0, v, plen).tolist() for _ in range(g["replicas"])]
    sessions = ([rng.integers(0, v, plen).tolist()
                 for _ in range(g["conversations"])],
                [[rng.integers(0, v, g["turn_tokens"]).tolist()
                  for _ in range(g["turns"] - 1)]
                 for _ in range(g["conversations"])])
    wrappers = _kernel_wrappers()
    with _Watch("cuda") as watch:
        pool = _gateway_pool(cfg, params, scfg, g["replicas"])
        gateway, stop = serve_in_thread(pool, port=0, max_queue_depth=64)
        try:
            log(f"  {g['replicas']} replicas x ({g['device_slots']} device + "
                f"{g['host_slots']} host slots, cache_len {g['cache_len']}, "
                f"host pool {scfg.host_pool_pages} fp32 pages, "
                f"{scfg.host_workers} host workers each); "
                + _check_shared_weights(pool, params) + "; "
                f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
            # warm-up: one request per replica (cuBLAS handles, first
            # launches); not part of the measured run
            _burst(gateway.port, warm, 2, len(warm))
            torch.cuda.synchronize()
            before = _iterations(pool)
            torch.cuda.reset_peak_memory_stats()
            for fn in wrappers.values():
                fn.launches = 0
            results, wall = _burst(gateway.port, prompts, n_out,
                                   g["clients"])
            launches = {name: fn.launches for name, fn in wrappers.items()}
            _check_streams("burst", results, n_out)
            two = _burst_numbers(f"burst on {g['replicas']} replicas "
                                 f"({g['clients']} clients x "
                                 f"{g['per_client']} requests of {plen} -> "
                                 f"{n_out} tokens)", results, wall, pool,
                                 before)
            log(f"  launches over the burst {launches}; peak device memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
                f"[{CARD}]")
            need = cfg.num_attn_layers
            if launches["decode_attention"] < need * (n_out - 1) \
                    or launches["prefill_attention"] < need:
                fail(f"gateway: the burst launched {launches}; the path "
                     f"needs decode >= {need * (n_out - 1)}, prefill >= "
                     f"{need}")
            health = get_json("127.0.0.1", gateway.port, "/health")
            metrics = get_text("127.0.0.1", gateway.port, "/metrics")
            if health["status"] != 200 or health["body"]["status"] != "ok":
                fail(f"gateway: /health after the burst: {health}")
            if metrics["status"] != 200 or not all(
                    f in metrics["body"] for f in (
                        "apex_replica_up", "apex_engine_iterations_total")):
                fail("gateway: /metrics lacks apex_replica_up or "
                     "apex_engine_iterations_total")
            fallbacks = sum(s["host_fallbacks"] for s in pool.stats())
            if fallbacks:
                fail(f"gateway: {fallbacks} host fallbacks on a healthy card")
            direct = [Request(prompt=list(p), max_new_tokens=n_out)
                      for p in prompts]
            t0 = time.perf_counter()
            with InferenceServer(cfg, params, scfg) as server:
                for r in direct:
                    server.submit(r)
                server.run_until_idle()
            t_direct = time.perf_counter() - t0
            margins = watch.margins()
            on = {i: r["tokens"] for i, r in results.items()}
            off = {i: list(r.output) for i, r in enumerate(direct)}
            on_m = {i: [margins.get((results[i]["done"]["request_id"], j))
                        for j in range(len(on[i]))] for i in on}
            off_m = {i: [margins.get((direct[i].request_id, j))
                         for j in range(len(off[i]))] for i in off}
            same, flips, other = compare_streams(on, off, on_m, off_m,
                                                 watch.dtype)
            log(f"  {same} of {len(on)} SSE streams identical to a direct "
                f"InferenceServer run of the same prompts ({t_direct:.1f} s)"
                + "".join(f"; parted at a tie: {f}" for f in flips))
            if other or bool(watch.nan):
                fail("gateway: SSE streams part from the direct run by more "
                     "than two logit ULPs (or a logit was NaN): "
                     + "; ".join(other))
            t0 = time.perf_counter()
            _gateway_sessions(gateway.port, pool, sessions)
            _gateway_backpressure(pool, prompts)
            log(f"  sessions and backpressure in "
                f"{time.perf_counter() - t0:.1f} s")
        finally:
            stop()
            pool.shutdown()
    del pool
    _free_device()
    t0 = time.perf_counter()
    _gateway_crash(cfg, params, scfg, prompts[:g["clients"]], profile)
    log(f"  crash step in {time.perf_counter() - t0:.1f} s")
    _free_device()
    # the burst on one replica as configured, then on one replica holding
    # both replicas' device slots (the same device rows in one engine)
    one = _one_replica_burst(cfg, params, scfg, prompts, warm[0],
                             "the same burst on 1 replica")
    wide = _one_replica_burst(
        cfg, params, dataclasses.replace(
            scfg, device_slots=g["replicas"] * g["device_slots"]),
        prompts, warm[0], f"the same burst on 1 replica with "
        f"{g['replicas'] * g['device_slots']} device slots")
    log(f"  output tokens/s: {g['replicas']} replicas {two:.2f}, 1 replica "
        f"{one:.2f} ({two / one:.2f}x), 1 replica with "
        f"{g['replicas'] * g['device_slots']} device slots {wide:.2f} "
        f"({two / wide:.2f}x) [{CARD}]")
    del params
    _free_device()
    _serve_cli("--published", "--layers", "4", "--smoke-test",
               cli="gateway")
    log(f"  gateway phase in {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# training on the card
# ---------------------------------------------------------------------------

# llama3.1-8b at published width and depth: Adafactor, remat, the
# chunked loss over 256 tokens, B 2 x T 1024 of the synthetic batch, 5
# steps on one batch; the dense-FFN Jamba period (8 layers) at published
# width, B 1 x T 1024, 3 steps.  lr 1e-4: at Adafactor's default 1e-3
# (the reference's choice for giant archs) its RMS-clipped update moves
# every weight by ~1e-3 a step, 6-9% of these widths' initial scale, and
# from random weights the loss overshoots on the one batch, through the
# plain versions as through the kernels (tools/train_lr_probe.py on one
# H100 80GB HBM3, 700.00 W: llama kernels 12.12, 8.86, 7.73, 15.63,
# 10.85, plain 12.12, 8.85, 7.65, 15.56, 10.45; Jamba kernels 11.53,
# 8.75, 16.01, plain 11.53, 8.74, 16.57)
TRAIN = dict(rows=2, seq=1024, steps=5, lr=1e-4, loss_chunk=256)
TRAIN_HYBRID = dict(rows=1, seq=1024, steps=3)
# xlstm-125m at published width and depth (12 layers, bf16)
TRAIN_XLSTM = dict(rows=2, seq=1024, steps=3)
# a profiled xlstm-125m step's time in the two recurrences before their
# redesigns (the mLSTM forward's chunkwise route, the sLSTM backward's
# mbarrier exchange; ms, H100 80GB HBM3, 700.00 W; PERF.md §5), printed
# beside
XLSTM_STEP_BEFORE = {"mLSTM forward": 15.6, "sLSTM backward": 13.1}
# one loss.backward() in fp32 on the card (kernels) against the CPU (plain
# versions): both models at published width cut to 2 layers, B 1 x T 128;
# each leaf's gradient within GRAD_TOL of its largest |element| (fp32
# products of widths up to 24576 summed in other orders)
GRAD_CHECK = dict(rows=1, seq=128, layers=2)
GRAD_TOL = 1e-3
# checkpoint and resume: llama3.1-8b at published width cut to 2 layers
RESUME = dict(layers=2, rows=2, seq=256)


def _train_setup(cfg, params, loss_chunk=TRAIN["loss_chunk"]):
    from repro_torch.training import (TrainConfig, init_train_state,
                                      make_optimizer, make_train_step)
    tcfg = TrainConfig(optimizer="adafactor", remat=True,
                       loss_chunk=loss_chunk)
    opt = make_optimizer("adafactor", lr=TRAIN["lr"])
    return (make_train_step(cfg, tcfg, opt),
            init_train_state(cfg, tcfg, opt, params), tcfg, opt)


def _batch(cfg, rows, seq, seed=0):
    import numpy as np
    import torch
    from repro_torch.launch.train import synthetic_batch
    return synthetic_batch(np.random.default_rng(seed), cfg, rows, seq,
                           torch.device("cuda"))


def _train_run(cfg, rows: int, seq: int, steps: int) -> dict:
    """``steps`` train steps of ``cfg`` (random weights from seed 0) on one
    synthetic batch: every loss and grad norm finite, the last loss below
    the first, each attention layer's forward launched twice a step
    (remat) and its backward once, each Mamba layer's likewise."""
    import math
    import torch
    from repro_torch.models.config import BlockKind
    params = _new_params(cfg)
    step, state, _, _ = _train_setup(cfg, params)
    batch = _batch(cfg, rows, seq)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wrappers = _kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    times, losses, norms = [], [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    counts = {name: fn.launches for name, fn in wrappers.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    ms = statistics.median(times[1:]) * 1e3
    tokens = rows * seq
    split = _step_split(cfg, state, batch)
    log(f"  {steps} steps of B {rows} x T {seq}: losses "
        f"{[round(x, 4) for x in losses]}, grad norms "
        f"{[round(x, 3) for x in norms]}")
    log(f"  step time {ms:.1f} ms (median of steps 2-{steps}; first "
        f"{times[0] * 1e3:.0f} ms), {tokens / ms * 1e3:.1f} tokens/s, peak "
        f"device memory {peak:.2f} GiB; launches {counts} [{CARD}]")
    if not all(math.isfinite(x) for x in losses + norms):
        fail(f"{cfg.name}: a loss or grad norm is not finite")
    if not losses[-1] < losses[0]:
        fail(f"{cfg.name}: the loss did not fall ({losses})")
    if peak > 70:
        fail(f"{cfg.name}: peak {peak:.1f} GiB; the optimizer's per-group "
             "update should hold it near 40")
    n_attn = cfg.num_attn_layers
    need = {"prefill_attention": 2 * n_attn * steps,
            "prefill_attention_bwd": n_attn * steps}
    for kind, name in ((BlockKind.MAMBA, "mamba_selective_scan"),
                       (BlockKind.SLSTM, "slstm_recurrence"),
                       (BlockKind.MLSTM, "mlstm_recurrence")):
        n = sum(k == kind for k in cfg.block_pattern) * cfg.num_groups
        need[name] = 2 * n * steps
        need[name + "_bwd"] = n * steps
    for name, n in need.items():
        if counts[name] < n:
            fail(f"{cfg.name}: {name} launched {counts[name]} times in "
                 f"{steps} steps; the path needs {n}")
    del params, state, batch
    _free_device()
    return {"counts": counts, "step_ms": ms, "tokens_per_s": tokens / ms * 1e3,
            "peak_gib": peak, "losses": losses, "split": split}


def _step_split(cfg, state, batch) -> dict:
    """One more step in its parts, each timed to a synchronize: loss and
    gradients, clipping, the optimizer; then a step under
    ``torch.profiler``: device busy share and the kernels by device
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.training.optimizer import clip_by_global_norm
    from repro_torch.training.train_step import loss_grads, make_loss_fn
    step, _, tcfg, opt = _train_setup(cfg, state.params)
    loss_fn = make_loss_fn(cfg, tcfg)
    marks = [time.perf_counter()]
    grads, _ = loss_grads(loss_fn, state.params, batch, None)
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    grads, _ = clip_by_global_norm(grads, tcfg.grad_clip)
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    opt.update(grads, state.opt_state, state.params)
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    del grads
    parts = {k: (marks[i + 1] - marks[i]) * 1e3 for i, k in
             enumerate(("loss_and_grads_ms", "clip_ms", "optimizer_ms"))}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        if us > 0:
            per[ev.key] = per.get(ev.key, 0.0) + us / 1e3
    busy = sum(per.values()) / (wall * 1e3)
    log(f"  one step in parts: loss + gradients "
        f"{parts['loss_and_grads_ms']:.1f} ms, clip {parts['clip_ms']:.1f} "
        f"ms, Adafactor {parts['optimizer_ms']:.1f} ms; a profiled step "
        f"{wall * 1e3:.1f} ms, device busy {100 * busy:.1f}%; top kernels "
        f"by device time:")
    for key, ms in sorted(per.items(), key=lambda kv: -kv[1])[:8]:
        log(f"    {ms:9.3f} ms  {key[:100]}")
    # the recurrences' kernels, each summed over the step
    # (the mLSTM forward by both routes: the walk and the chunkwise parts)
    groups = {"sLSTM forward": ("::slstm_scan_kernel<",),
              "sLSTM backward": ("::slstm_bwd_kernel<",),
              "mLSTM forward": ("::mlstm_scan_kernel<", "::mlstm_fwd_"),
              "mLSTM backward": ("::mlstm_bwd_",)}
    split = {g: sum(ms for key, ms in per.items()
                    if any(pat in key for pat in pats))
             for g, pats in groups.items()}
    if any(split.values()):
        log("  the recurrences in the profiled step: " + ", ".join(
            f"{g} {ms:.3f} ms" + (f" (before its redesign: "
                                  f"{XLSTM_STEP_BEFORE[g]} ms)"
                                  if g in XLSTM_STEP_BEFORE else "")
            for g, ms in split.items()))
    return dict(parts, profiled_ms=wall * 1e3, busy=busy,
                recurrences_ms=split)


def _cut(cfg, layers: int, **kw):
    import dataclasses
    return dataclasses.replace(cfg, num_layers=layers,
                               name=f"{cfg.name}-{layers}L", **kw)


def _grad_check(cfg) -> None:
    """One loss.backward() of ``cfg`` in fp32 on the card, through the
    kernels and their backward kernels, against the same weights and batch
    on the CPU through the plain versions: the loss and every leaf."""
    import torch
    from repro_torch.core.tree import tree_flatten, tree_map
    from repro_torch.models import ModelParams, init_params
    from repro_torch.training import TrainConfig
    from repro_torch.training.train_step import loss_grads, make_loss_fn
    from repro_torch.models.config import BlockKind
    kw = dict(param_dtype="float32", compute_dtype="float32")
    if BlockKind.MAMBA in cfg.block_pattern:   # a Mamba layer, attention
        kw["block_pattern"] = (BlockKind.MAMBA, BlockKind.ATTN)
    f32 = _cut(cfg, GRAD_CHECK["layers"], **kw)
    params = init_params(f32, seed=0, device="cuda")
    cpu = ModelParams(*(tree_map(lambda a: a.cpu(), part)
                        for part in params))
    batch = _batch(f32, GRAD_CHECK["rows"], GRAD_CHECK["seq"])
    loss_fn = make_loss_fn(f32, TrainConfig(remat=True))
    wrappers = _kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    card, m_card = loss_grads(loss_fn, params, batch, None)
    torch.cuda.synchronize()
    counts = {name: fn.launches for name, fn in wrappers.items()}
    t1 = time.perf_counter()
    plain, m_cpu = loss_grads(loss_fn, cpu, {k: v.cpu() for k, v in
                                         batch.items()}, None)
    t2 = time.perf_counter()
    worst, where = 0.0, None
    for i, (g, r) in enumerate(zip(tree_flatten(card)[0],
                                   tree_flatten(plain)[0])):
        ratio = float((g.cpu() - r).abs().max()) / max(
            float(r.abs().max()), 1e-12)
        if ratio > worst:
            worst, where = ratio, (i, tuple(r.shape))
    dl = abs(float(m_card["loss"]) - float(m_cpu["loss"]))
    log(f"  {f32.name} fp32 {[k.value for k in f32.block_pattern]}, B "
        f"{GRAD_CHECK['rows']} x T {GRAD_CHECK['seq']}: loss card "
        f"{float(m_card['loss']):.6f}, CPU {float(m_cpu['loss']):.6f}; "
        f"worst leaf |card - CPU| / max |grad| {worst:.3e} (leaf {where}; "
        f"bar {GRAD_TOL}); card {t1 - t0:.1f} s, CPU {t2 - t1:.1f} s; "
        f"launches {counts}")
    if worst > GRAD_TOL or dl > 1e-4 * abs(float(m_cpu["loss"])):
        fail(f"{f32.name}: the card's gradients part from the CPU's "
             f"(worst {worst:.3e}, loss diff {dl:.3e})")
    need = [name for kind, name in (
        (BlockKind.ATTN, "prefill_attention_bwd"),
        (BlockKind.MAMBA, "mamba_selective_scan_bwd"),
        (BlockKind.SLSTM, "slstm_recurrence_bwd"),
        (BlockKind.MLSTM, "mlstm_recurrence_bwd")) if kind in
        f32.block_pattern]
    if any(counts[name] < 1 for name in need):
        fail(f"{f32.name}: a backward kernel did not run: {counts}")
    del params, cpu, card, plain
    _free_device()


def _resume_check() -> None:
    """llama3.1-8b at published width cut to 2 layers: 2 steps, save,
    restore into a fresh state (other weights), a 3rd step, against the
    uninterrupted 3rd step: the restored state and the step after it
    bitwise the same (the kernels use no atomics)."""
    import shutil
    import tempfile
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_flatten
    from repro_torch.models import init_params
    from repro_torch.training import checkpoint
    cfg = _cut(get_config("llama3.1-8b"), RESUME["layers"])
    step, state, _, _ = _train_setup(cfg, init_params(
        cfg, seed=0, device="cuda"))
    batches = [_batch(cfg, RESUME["rows"], RESUME["seq"], seed=s)
               for s in range(3)]
    for b in batches[:2]:
        state, _ = step(state, b)
    d = tempfile.mkdtemp(prefix="apex_ckpt_")
    try:
        t0 = time.perf_counter()
        checkpoint.save(d, 2, state)
        _, fresh, _, _ = _train_setup(cfg, init_params(cfg, seed=1,
                                                       device="cuda"))
        at, fresh = checkpoint.restore(d, fresh)
        t_io = time.perf_counter() - t0
        nbytes = sum(os.path.getsize(os.path.join(r, f))
                     for r, _, fs in os.walk(d) for f in fs)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    same_restore = all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(
        tree_flatten(state)[0], tree_flatten(fresh)[0]))
    state, m1 = step(state, batches[2])
    fresh, m2 = step(fresh, batches[2])
    diffs = [float((a.float() - b.float()).abs().max()) for a, b in zip(
        tree_flatten(state)[0], tree_flatten(fresh)[0])]
    n_diff = sum(x > 0 for x in diffs)
    log(f"  {cfg.name}: 2 steps, checkpoint of {nbytes / 2**30:.2f} GiB "
        f"saved and restored in {t_io:.1f} s (step {at}), restored state "
        f"bitwise {same_restore}; step 3 loss {float(m1['loss']):.6f} "
        f"uninterrupted, {float(m2['loss']):.6f} resumed; leaves that "
        f"differ after it: {n_diff} of {len(diffs)} (max |diff| "
        f"{max(diffs):.3e})")
    if at != 2 or not same_restore or n_diff or \
            float(m1["loss"]) != float(m2["loss"]):
        fail(f"{cfg.name}: the resumed step 3 is not the uninterrupted one")
    del state, fresh, batches
    _free_device()


def _train_cli() -> None:
    """``python -m repro_torch.launch.train --device cuda --steps 30
    --ckpt-every 10``, then ``--resume`` to step 40."""
    import shutil
    import tempfile
    d = tempfile.mkdtemp(prefix="apex_train_cli_")
    try:
        out = _serve_cli("--device", "cuda", "--steps", "30",
                         "--ckpt-every", "10", "--ckpt-dir", d, cli="train")
        if "final checkpoint committed" not in out or \
                sorted(os.listdir(d)) != ["LATEST", "step_000000010",
                                          "step_000000020",
                                          "step_000000030"]:
            fail(f"launch.train: checkpoints {sorted(os.listdir(d))}")
        out = _serve_cli("--device", "cuda", "--steps", "40",
                         "--ckpt-every", "10", "--ckpt-dir", d, "--resume",
                         cli="train")
        if "resumed from step 30" not in out or \
                "step_000000040" not in os.listdir(d):
            fail("launch.train --resume did not continue from step 30")
    finally:
        shutil.rmtree(d, ignore_errors=True)


def phase_train() -> dict:
    """Training on the card: llama3.1-8b at published width and depth, the
    dense-FFN Jamba period at published width, gradients against the
    CPU's, checkpoint and resume, the train CLI.  Returns the launches
    of the llama and Jamba runs (summed)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    t_phase = time.perf_counter()
    build.load_all()            # no first step pays for nvcc
    _free_device()
    llama = _train_run(get_config("llama3.1-8b"), TRAIN["rows"],
                       TRAIN["seq"], TRAIN["steps"])
    jamba = _train_run(hybrid_config(num_layers=8), TRAIN_HYBRID["rows"],
                       TRAIN_HYBRID["seq"], TRAIN_HYBRID["steps"])
    xlstm = _train_run(get_config("xlstm-125m"), TRAIN_XLSTM["rows"],
                       TRAIN_XLSTM["seq"], TRAIN_XLSTM["steps"])
    for cfg in (get_config("llama3.1-8b"), hybrid_config(num_layers=8),
                get_config("xlstm-125m")):
        _grad_check(cfg)
    _resume_check()
    _train_cli()
    log(f"  train phase in {time.perf_counter() - t_phase:.1f} s")
    return {name: llama["counts"][name] + jamba["counts"][name]
            + xlstm["counts"][name] for name in llama["counts"]}


# ---------------------------------------------------------------------------
# dryrun and examples
# ---------------------------------------------------------------------------

# the dry-run's cells at published width and depth:
# (arch, shape, multi-pod, variant)
DRYRUN_CELLS = (("llama3.1-8b", "decode_32k", False, "overlap"),
                ("llama3.1-8b", "train_4k", True, "baseline"),
                ("deepseek-moe-16b", "decode_32k", False, "baseline"),
                ("jamba-1.5-large-398b", "long_500k", False, "baseline"),
                ("xlstm-125m", "train_4k", False, "baseline"))
# the recurrences' meta rules each xLSTM train cell must go through
XLSTM_CALLS = ("slstm_recurrence", "slstm_recurrence_bwd",
               "mlstm_recurrence", "mlstm_recurrence_bwd")
# the memory check: llama3.1-8b cut to 2 layers at published width, one
# train step at the train phase's B 2 x T 1024 on a (1, 1) mesh
DRYRUN_MEMORY = dict(arch="llama3.1-8b", layers=2, rows=TRAIN["rows"],
                     seq=TRAIN["seq"])
ALLOC_ROUND = 512           # the caching allocator's block rounding


def _dryrun_tag(arch, shape, multi_pod, variant) -> str:
    return f"{arch}__{shape}__{'mp' if multi_pod else 'sp'}__{variant}"


def _dryrun_input_bytes(arch, shape_name, multi_pod, variant) -> int:
    """Rank 0's bytes of a cell's inputs, summed over the specs alone
    (``param_shardings`` / ``fitted_param_specs`` and the input specs of
    ``launch.shapes``), apart from the trace that the record's
    ``argument_bytes`` comes from."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding
    from repro_torch.launch import dryrun, mesh, shapes
    from repro_torch.models import abstract_params
    cfg, shape = get_config(arch), shapes.SHAPES[shape_name]
    m = mesh.make_production_mesh(multi_pod=multi_pod)
    try:
        params = abstract_params(cfg)
        if shape.kind == "train":
            (state, batch), (sspecs, bspecs) = dryrun.train_inputs(
                cfg, shape, m, params)
            return dryrun.spec_bytes(m, state, sspecs) + \
                dryrun.spec_bytes(m, batch, bspecs)
        rules = dryrun.cell_rules(m, shape.kind, {})
        total = dryrun.spec_bytes(m, params, sharding.fitted_param_specs(
            m, params, rules))
        dev, host = dryrun.decode_batches(shape, variant)
        st = shapes.abstract_state(cfg, device_batch=dev, host_batch=host,
                                   cache_len=shape.seq_len)
        total += dryrun.spec_bytes(m, st, shapes.state_specs(
            cfg, st, m, long_context=shape_name == "long_500k"))
        tok, tspec = shapes.decode_token_specs(cfg, dev, m)
        total += dryrun.spec_bytes(m, [tok], [tspec])
        if host:
            hio, hspec = shapes.host_io_specs(cfg, host, m)
            total += dryrun.spec_bytes(m, hio, hspec)
        return total
    finally:
        mesh.destroy()


def _check_dryrun_cell(cell, out_dir: Path, rc: int, err: str) -> None:
    """One cell's record: no "error", ``argument_bytes`` equal to the
    phase's own sum over the specs, collectives on the multi-pod train
    cell; its line printed."""
    tag = _dryrun_tag(*cell)
    if rc != 0:
        log(err[-3000:])
        fail(f"dryrun {tag}: exit {rc}")
    rec = json.loads((out_dir / f"{tag}.json").read_text())
    if "error" in rec:
        log(rec.get("traceback", "")[-3000:])
        fail(f"dryrun {tag}: {rec['error']}")
    mem, coll = rec["memory"], rec["collectives"]
    want = _dryrun_input_bytes(*cell)
    if mem["argument_bytes"] != want:
        fail(f"dryrun {tag}: argument_bytes {mem['argument_bytes']}, "
             f"the specs sum to {want}")
    if cell[1] == "train_4k" and cell[2] and coll["total_bytes"] <= 0:
        fail(f"dryrun {tag}: no collectives on the multi-pod train cell")
    calls = rec["cost_analysis"]["kernel_calls"]
    if cell[0] == "xlstm-125m" and any(calls.get(k, 0) <= 0
                                       for k in XLSTM_CALLS):
        fail(f"dryrun {tag}: kernel calls {calls} miss a recurrence")
    by_kind = ", ".join(f"{k} {v / 1e6:.1f}" for k, v in
                        sorted(coll["bytes_by_kind"].items()))
    log(f"  {tag}: {mem['total_per_device'] / 1e9:.3f} GB per rank "
        f"(arguments {mem['argument_bytes'] / 1e9:.3f} = the specs' "
        f"sum, temp {mem['temp_bytes'] / 1e9:.3f}, out "
        f"{mem['output_bytes'] / 1e9:.3f}, aliased "
        f"{mem['alias_bytes'] / 1e9:.3f}); collectives MB: "
        f"{by_kind or 'none'}; flops per rank "
        f"{rec['cost_analysis']['flops']:.4g}; trace_s {rec['trace_s']}")


def _dryrun_memory_check() -> dict:
    """The train step's trace on a (1, 1) mesh against the card: the
    same params, train state and batch materialised there must grow
    ``memory_allocated`` by the record's ``argument_bytes`` (within the
    allocator's rounding, per tensor); one real step's peak growth is
    printed beside the record's ``total_per_device``.  Returns the
    step's launches."""
    import dataclasses
    import math
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch import dryrun, mesh, shapes
    from repro_torch.models import init_params
    from repro_torch.training import init_train_state, make_train_step
    mc = DRYRUN_MEMORY
    cfg = dataclasses.replace(get_config(mc["arch"]),
                              num_layers=mc["layers"])
    spec = shapes.ShapeSpec(f"train_{mc['rows']}x{mc['seq']}", "train",
                            mc["seq"], mc["rows"])
    try:
        rec = dryrun.dryrun_cell(mc["arch"], spec.name, cfg=cfg, shape=spec,
                                 mesh=mesh.make_local_mesh())
    finally:
        mesh.destroy()
    mem = rec["memory"]
    _free_device()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    _, tcfg, opt = dryrun.train_setup(cfg)
    state = init_train_state(cfg, tcfg, opt,
                             init_params(cfg, seed=0, device="cuda"))
    toks = _batch(cfg, mc["rows"], mc["seq"])["tokens"]
    batch = {"tokens": toks, "labels": toks.clone()}    # two inputs
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated() - base
    n_tensors = sum(1 for x in tree_leaves((state, batch))
                    if isinstance(x, torch.Tensor) and x.is_cuda)
    arg = mem["argument_bytes"]
    log(f"  memory check ({mc['arch']} cut to {mc['layers']} layers, "
        f"{spec.name}, {rec['optimizer']}): argument_bytes {arg} vs "
        f"memory_allocated growth {grown} over {n_tensors} tensors "
        f"(difference {grown - arg}) [{CARD}]")
    if abs(grown - arg) > ALLOC_ROUND * n_tensors:
        fail(f"memory check: argument_bytes {arg} against a growth of "
             f"{grown} bytes for {n_tensors} tensors")
    wrappers = _kernel_wrappers()
    step = make_train_step(cfg, tcfg, opt)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for fn in wrappers.values():
        fn.launches = 0
    state, metrics = step(state, batch, None)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in wrappers.items()}
    peak = torch.cuda.max_memory_allocated() - before
    total = mem["total_per_device"]
    loss = float(metrics["loss"])
    log(f"  one step: loss {loss:.4f}, peak growth {peak} bytes beside "
        f"the record's total_per_device {total} (temp {mem['temp_bytes']}, "
        f"out {mem['output_bytes']}, aliased {mem['alias_bytes']}): "
        f"total_per_device / (arguments + peak growth) "
        f"{total / (arg + peak):.4f}; launches {launches} [{CARD}]")
    if not math.isfinite(loss):
        fail(f"memory check: loss {loss}")
    for name in ("prefill_attention", "prefill_attention_bwd"):
        if launches[name] < mc["layers"]:
            fail(f"memory check: {name} launched {launches[name]} times")
    del state, batch
    _free_device()
    return launches


EXAMPLES = ("quickstart", "offload_demo", "serve_chat", "train_tiny")


def phase_dryrun_examples(dryrun: bool, examples: bool) -> dict:
    """The dry-run's five cells (``python -m repro_torch.launch.dryrun``
    each, on the host's CPU), its memory check on the card (this script
    with ``--memory-check``: a process of its own, so nothing else
    allocates on the card while it measures) and the four examples
    (``examples/torch_*.py`` with their defaults; tiny models), all as
    processes side by side; then each checked.  Returns the launches of
    each path: the memory check's step, and what quickstart and
    train_tiny print."""
    t0 = time.perf_counter()
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    out_dir = ROOT / "chiprun_out" / "dryrun"
    out_dir.mkdir(parents=True, exist_ok=True)
    cmds = {}
    if dryrun:
        for cell in DRYRUN_CELLS:
            arch, shape, mp, variant = cell
            cmds[cell] = [sys.executable, "-m", "repro_torch.launch.dryrun",
                          "--arch", arch, "--shape", shape, "--variant",
                          variant, "--out", str(out_dir)] + (
                              ["--multi-pod"] if mp else [])
        cmds["memory"] = [sys.executable, str(Path(__file__).resolve()),
                          "--memory-check"]
    if examples:
        for name in EXAMPLES:
            cmds[name] = [sys.executable,
                          str(ROOT / "examples" / f"torch_{name}.py")]
    procs = {key: subprocess.Popen(cmd, cwd=ROOT, env=env,
                                   stdout=subprocess.PIPE,
                                   stderr=subprocess.PIPE, text=True)
             for key, cmd in cmds.items()}
    outs = {}
    try:
        for key, proc in procs.items():
            outs[key] = proc.communicate(timeout=600)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
    log(f"  {len(procs)} processes in {time.perf_counter() - t0:.1f} s")
    result = {}
    if dryrun:
        for cell in DRYRUN_CELLS:
            _check_dryrun_cell(cell, out_dir, procs[cell].returncode,
                               outs[cell][1])
        out, err = outs["memory"]
        for line in out.strip().splitlines():
            if not line.startswith("MEMCHECK "):
                log(line)
        if procs["memory"].returncode != 0:
            log(err[-3000:])
            fail(f"memory check exited {procs['memory'].returncode}")
        result["dryrun"] = json.loads(next(
            ln for ln in out.splitlines()
            if ln.startswith("MEMCHECK "))[len("MEMCHECK "):])
    if examples:
        launches = {name: 0 for name in _kernel_wrappers()}
        for name in EXAMPLES:
            out, err = outs[name]
            for line in out.strip().splitlines()[-4:]:
                log(f"  {name} | {line}")
            if procs[name].returncode != 0:
                log(err[-3000:])
                fail(f"examples/torch_{name}.py exited "
                     f"{procs[name].returncode}")
            for line in out.splitlines():
                if line.startswith("kernel launches:"):
                    for k, v in json.loads(line.split(":", 1)[1]).items():
                        launches[k] += v
        if "all agree" not in outs["quickstart"][0]:
            fail("torch_quickstart.py did not print its agreement")
        for name in ("decode_attention", "prefill_attention"):
            if launches[name] <= 0:
                fail(f"examples: {name} launched {launches[name]} times")
        log(f"  examples' launches {launches} [{CARD}]")
        result["examples"] = launches
    log(f"  dryrun / examples phase in {time.perf_counter() - t0:.1f} s")
    return result


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

PHASES = ("env", "kernels", "profile", "exactness", "serving",
          "serving-hybrid", "faults", "serving-chunked", "serving-moe",
          "serving-registry", "serving-xlstm", "vlm", "encoder", "cli",
          "gateway", "train", "dryrun", "examples")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma list out of {PHASES}")
    ap.add_argument("--memory-check", action="store_true",
                    help="only the dryrun phase's memory check (the phase "
                    "runs it so, in a process of its own)")
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
    if args.memory_check:
        global CARD
        CARD = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
        print("MEMCHECK " + json.dumps(_dryrun_memory_check()), flush=True)
        return 0
    log("== environment")
    env = phase_env()
    records = {}
    t_run = time.perf_counter()
    if "kernels" in phases:
        log("== kernels against their plain versions")
        records = phase_kernels()
        log(f"  kernels phase in {time.perf_counter() - t_run:.1f} s")
    launches = {}       # path -> kernel -> launches over its measured run
    if "profile" in phases:
        log("== profile: OfflineProfiler on llama3.1-8b at published width")
        _, launches["profile"] = phase_profile()
    if "exactness" in phases:
        log("== exactness at a reduced size")
        phase_exactness()
    if "serving" in phases:
        log(f"== serving llama3.1-8b at published width ({SERVING_LAYERS} "
            "layers)")
        launches["serving"] = phase_serving()
    if "serving-hybrid" in phases:
        log("== serving Jamba-1.5-Large (dense FFN, 16 layers) at published "
            "width")
        launches["serving-hybrid"] = phase_serving_hybrid()
    if "faults" in phases:
        log("== faults: the fault soak, breaker, recompute and cancel on "
            "llama3.1-8b (8 layers) at published width")
        launches["faults"] = phase_faults()
    if "serving-chunked" in phases:
        log("== serving with the reference's defaults (chunked prefill, "
            "prefix cache, migration, preemption): multi-turn chat")
        launches["serving-chunked"] = phase_serving_chunked()
    if "serving-moe" in phases:
        log("== serving deepseek-moe-16b at published width, the host tier "
            "in fp32 and in int8")
        launches["serving-moe"] = phase_serving_moe()
    if "serving-registry" in phases:
        log("== serving stablelm-12b, internlm2-20b (16 layers) and "
            "llama3-405b (4 layers) at published width")
        launches["serving-registry"] = phase_serving_registry()
    if "serving-xlstm" in phases:
        log("== serving xlstm-125m at published width, GPU-only: "
            "multi-turn chat")
        launches["serving-xlstm"] = phase_serving_xlstm()
    if "vlm" in phases:
        log("== paligemma-3b at published width: served as a text model, "
            "then prefix-LM prefill over patches + decode")
        launches["vlm"] = phase_vlm()
    if "encoder" in phases:
        log("== hubert-xlarge at published width: the encoder's "
            "forward_train")
        launches["encoder"] = phase_encoder()
    if "cli" in phases:
        log("== python -m repro_torch.launch.serve")
        phase_cli()
    if "gateway" in phases:
        log("== the HTTP/SSE gateway over two llama3.1-8b replicas at "
            "published width")
        launches["gateway"] = phase_gateway()
    if "train" in phases:
        log("== training: llama3.1-8b and the dense-FFN Jamba period at "
            "published width, gradients, checkpoint and resume, the CLI")
        launches["train"] = phase_train()
    if "dryrun" in phases or "examples" in phases:
        log("== the dry-run (five cells on the production meshes over a "
            "fake process group, the memory check on the card) and the "
            "four examples, side by side")
        launches.update(phase_dryrun_examples("dryrun" in phases,
                                              "examples" in phases))
    log(f"== every phase in {time.perf_counter() - t_run:.1f} s")
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
