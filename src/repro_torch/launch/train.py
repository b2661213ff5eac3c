"""End-to-end training driver of the port.

Port of ``repro/launch/train.py``: trains any architecture of the
registry on the reference's synthetic Markov batches
(``np.random.default_rng(0)``) with checkpoints every ``--ckpt-every``
steps, ``--resume`` from the newest committed one, and the
``RestartPolicy`` supervision contract.  A checkpoint's step is the number
of steps taken, so ``--resume`` continues with the next one (the
reference saves step k's state under k and the final one under the step
count, so its resume repeats a step, and a resume from a multiple of
``--ckpt-every`` writes an existing step's directory and fails; ROADMAP
queue 3).  Reduced by default (d_model 256,
vocab 1024, as the reference); ``--published`` trains the published
width (``--layers`` then cuts depth).  Runs on the card (the default;
the kernels are built before the first step) or, with ``--device cpu``,
on the plain PyTorch versions.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --steps 30 --ckpt-every 10
    python -m repro_torch.launch.train --published --layers 4 \\
        --optimizer adafactor --lr 1e-4 --batch 2 --seq 1024 --steps 5
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.distributed.fault_tolerance import RestartPolicy
from repro_torch.models import init_params
from repro_torch.serving.engine import resolve_device
from repro_torch.training import (TrainConfig, checkpoint, init_train_state,
                                  make_optimizer, make_train_step)


def synthetic_batch(rng: np.random.Generator, cfg, batch: int, seq: int,
                    device: torch.device) -> Dict[str, torch.Tensor]:
    """Markov-ish synthetic LM data (learnable, unlike iid uniform), the
    reference's draws from ``rng``: token ids, or frame embeddings (bf16)
    and labels for an audio model."""
    base = rng.integers(0, cfg.vocab_size, (batch, 1))
    drift = rng.integers(-3, 4, (batch, seq)).cumsum(axis=1)
    toks = torch.from_numpy(((base + drift) % cfg.vocab_size).astype(
        np.int32)).to(device)
    if cfg.frontend == "audio":
        emb = rng.standard_normal((batch, seq, cfg.d_model)).astype(
            np.float32)
        return {"embeds": torch.from_numpy(emb).to(device, torch.bfloat16),
                "labels": toks}
    return {"tokens": toks, "labels": toks}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="internlm2-1.8b", choices=list_archs())
    ap.add_argument("--published", action="store_true",
                    help="train the published width (its dtypes); "
                         "--layers, when given, cuts depth")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "adafactor"])
    ap.add_argument("--accum-steps", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch versions of the kernels)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and router jitter")
    return ap


def model_config(args: argparse.Namespace):
    base = get_config(args.arch)
    if not args.published:
        return base.reduced(layers=args.layers, d_model=args.d_model,
                            vocab=1024)
    if args.layers is None:
        return base
    return dataclasses.replace(base, num_layers=args.layers,
                               name=f"{base.name}-{args.layers}L")


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    """Run the loop; returns {"start": first step, "losses": [...]}."""
    args = build_parser().parse_args(argv)
    cfg = model_config(args)
    device = resolve_device(args.device)
    if device.type == "cuda":
        from repro_torch.kernels import build
        build.load_all()
    print(f"training {cfg.name}: {cfg.param_count()/1e6:.1f}M params, "
          f"{cfg.num_layers}L d={cfg.d_model} on {device}", flush=True)
    tcfg = TrainConfig(optimizer=args.optimizer,
                       accum_steps=args.accum_steps,
                       compress_grads=args.compress_grads, remat=True)
    opt = make_optimizer(args.optimizer, lr=args.lr)
    step_fn = make_train_step(cfg, tcfg, opt)

    params = init_params(cfg, seed=args.seed, device=device)
    state = init_train_state(cfg, tcfg, opt, params)
    start = 0
    if args.resume and checkpoint.latest_step(args.ckpt_dir) is not None:
        start, state = checkpoint.restore(args.ckpt_dir, state)
        print(f"resumed from step {start}", flush=True)

    rng = np.random.default_rng(0)
    policy = RestartPolicy()
    t0 = time.time()
    tokens_done = 0
    losses: List[float] = []
    saved = start          # a checkpoint's step counts the steps taken
    for step in range(start, args.steps):
        batch = synthetic_batch(rng, cfg, args.batch, args.seq, device)
        # the reference's fold_in(key, step): jitter drawn per step
        gen = torch.Generator(device=device).manual_seed(
            (args.seed + 1) * 1_000_003 + step)
        state, metrics = step_fn(state, batch, gen)
        tokens_done += args.batch * args.seq
        losses.append(float(metrics["loss"]))
        if step % 10 == 0 or step == args.steps - 1:
            dt = time.time() - t0
            print(f"step {step:5d} loss {losses[-1]:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"{tokens_done / max(dt, 1e-9):,.0f} tok/s", flush=True)
        if args.ckpt_every and (step + 1) % args.ckpt_every == 0:
            saved = step + 1
            checkpoint.save(args.ckpt_dir, saved, state)
            policy.record_success()
    if saved != args.steps:
        checkpoint.save(args.ckpt_dir, args.steps, state)
    print(f"done in {time.time() - t0:.1f}s; final checkpoint committed",
          flush=True)
    return {"start": start, "losses": losses}


if __name__ == "__main__":
    main()
