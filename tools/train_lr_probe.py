#!/usr/bin/env python3
"""Train steps at two learning rates, through the kernels and through the
plain versions, on one GPU.

    python3 tools/train_lr_probe.py [--lrs 1e-3,1e-4]

The train phase of ``chip_smoke.py`` at its shapes: llama3.1-8b at
published width and depth (bf16, 5 steps of B 2 x T 1024) and the
dense-FFN Jamba-1.5-Large period (8 layers, 3 steps of B 1 x T 1024),
Adafactor, remat, the chunked loss over 256 tokens, one synthetic batch,
random weights from seed 0.  Each model takes its steps at each learning
rate twice from the same weights:

  kernels  the port as it is: the prefill attention and selective scan
           kernels and their backward kernels;
  plain    ``kernels.ops.prefill_attention`` replaced by autograd through
           ``ref.prefill_attention_ref`` on the card, and
           ``kernels.ops.mamba_selective_scan`` by the plain forward and
           the plain backward (``ref.mamba_selective_scan_bwd_ref``);
           no kernel of the port launches (checked).

Prints the losses and grad norms of each run side by side, and writes
them to ``chiprun_out/train_lr_probe.json``.  If the plain path's
trajectory rises where the kernels' does, the rise is the optimizer's
arithmetic at this width, not a backward kernel's.  Needs a CUDA card
and nvcc.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels.mamba_scan import (  # noqa: E402
    mamba_selective_scan_bwd_cuda, mamba_selective_scan_cuda)
from repro_torch.kernels.prefill_attention import (  # noqa: E402
    prefill_attention_bwd_cuda, prefill_attention_cuda)
from repro_torch.launch.train import synthetic_batch  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.models.config import FFNKind  # noqa: E402
from repro_torch.training import (TrainConfig, init_train_state,  # noqa: E402
                                  make_optimizer, make_train_step)

WRAPPERS = (prefill_attention_cuda, prefill_attention_bwd_cuda,
            mamba_selective_scan_cuda, mamba_selective_scan_bwd_cuda)


def _plain_attention(q, k, v, prefix_len=None, q_offset=None, *,
                     causal=True):
    return ref.prefill_attention_ref(q, k, v, prefix_len, q_offset,
                                     causal=causal)


class _PlainScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dt, x, b, c, a_neg, d_skip, h0):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(dt, x, b, c, a_neg, d_skip, h0)
        return ref.mamba_selective_scan_ref(dt, x, b, c, a_neg, d_skip, h0)

    @staticmethod
    def backward(ctx, dy, dh_final):
        args = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(args[0].shape, dtype=torch.float32,
                             device=args[0].device)
        return ref.mamba_selective_scan_bwd_ref(
            *args, dy.contiguous(),
            None if dh_final is None else dh_final.contiguous())


def _plain_scan(dt, x, b, c, a_neg, d_skip, h0, lens=None, h_out=None):
    assert lens is None and h_out is None
    return _PlainScan.apply(dt, x, b, c, a_neg, d_skip, h0)


def _run(cfg, rows: int, seq: int, steps: int, lr: float, plain: bool,
         device: str = "cuda") -> dict:
    saved = ops.prefill_attention, ops.mamba_selective_scan
    if plain:
        ops.prefill_attention, ops.mamba_selective_scan = (_plain_attention,
                                                           _plain_scan)
    try:
        tcfg = TrainConfig(optimizer="adafactor", remat=True, loss_chunk=256)
        opt = make_optimizer("adafactor", lr=lr)
        params = init_params(cfg, seed=0, device=device)
        state = init_train_state(cfg, tcfg, opt, params)
        step = make_train_step(cfg, tcfg, opt)
        batch = synthetic_batch(np.random.default_rng(0), cfg, rows, seq,
                                torch.device(device))
        for fn in WRAPPERS:
            fn.launches = 0
        losses, norms = [], []
        t0 = time.perf_counter()
        for _ in range(steps):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        wall = time.perf_counter() - t0
        launches = sum(fn.launches for fn in WRAPPERS)
    finally:
        ops.prefill_attention, ops.mamba_selective_scan = saved
    if plain and launches:
        raise RuntimeError(f"the plain path launched {launches} kernels")
    if not plain and not launches:
        raise RuntimeError("the kernel path launched no kernel")
    return {"losses": losses, "grad_norms": norms, "launches": launches,
            "seconds": wall}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lrs", default="1e-3,1e-4")
    args = ap.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    build.load_all()
    jamba = dataclasses.replace(get_config("jamba-1.5-large-398b"),
                                ffn_kind=FFNKind.DENSE, moe=None,
                                num_layers=8)
    models = [(get_config("llama3.1-8b"), 2, 1024, 5), (jamba, 1, 1024, 3)]
    out = []
    for cfg, rows, seq, steps in models:
        for lr in (float(x) for x in args.lrs.split(",")):
            for plain in (False, True):
                r = _run(cfg, rows, seq, steps, lr, plain)
                gc.collect()
                torch.cuda.empty_cache()
                r.update(model=cfg.name, lr=lr,
                         path="plain" if plain else "kernels")
                out.append(r)
                print(f"{cfg.name} B {rows} x T {seq} lr {lr:g} "
                      f"{r['path']:7s}: losses "
                      f"{[round(x, 4) for x in r['losses']]}, grad norms "
                      f"{[round(x, 3) for x in r['grad_norms']]}, "
                      f"{r['launches']} kernel launches, "
                      f"{r['seconds']:.1f} s [{card}]", flush=True)
    dest = ROOT / "chiprun_out" / "train_lr_probe.json"
    dest.parent.mkdir(exist_ok=True)
    dest.write_text(json.dumps({"card": card, "runs": out}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
