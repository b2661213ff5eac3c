"""Train a ~100M-class hybrid (Jamba-family) model on the port for a few
steps with checkpoint/resume -- the training driver in example form.
Twin of ``examples/train_tiny.py``; the checkpoint goes under a fresh
temporary directory.  On the card the attention and the Mamba scan run
forward and backward in the hand-written CUDA kernels; their launch
counts are printed at the end.

    PYTHONPATH=src python examples/torch_train_tiny.py [--device cpu]
"""
import argparse
import json
import tempfile

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.mamba_scan import (mamba_selective_scan_bwd_cuda,
                                            mamba_selective_scan_cuda)
from repro_torch.kernels.prefill_attention import (prefill_attention_bwd_cuda,
                                                   prefill_attention_cuda)
from repro_torch.models import init_params
from repro_torch.training import (TrainConfig, checkpoint, init_train_state,
                                  make_optimizer, make_train_step)

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
ap.add_argument("--steps", type=int, default=60)
ap.add_argument("--batch", type=int, default=4)
ap.add_argument("--seq", type=int, default=64)
args = ap.parse_args()
device = torch.device(args.device)
WRAPPERS = {"prefill_attention": prefill_attention_cuda,
            "mamba_selective_scan": mamba_selective_scan_cuda,
            "prefill_attention_bwd": prefill_attention_bwd_cuda,
            "mamba_selective_scan_bwd": mamba_selective_scan_bwd_cuda}
for fn in WRAPPERS.values():
    fn.launches = 0

cfg = get_config("jamba-1.5-large-398b").reduced(layers=8, d_model=256,
                                                 vocab=2048)
print(f"{cfg.name}: {cfg.param_count()/1e6:.1f}M params "
      f"(pattern {[k.value for k in cfg.block_pattern]})")
tcfg = TrainConfig(optimizer="adamw", remat=True, loss_chunk=32)
opt = make_optimizer("adamw", lr=3e-4)
step = make_train_step(cfg, tcfg, opt)
state = init_train_state(cfg, tcfg, opt, init_params(cfg, seed=0,
                                                     device=device))
rng = np.random.default_rng(0)
gen = torch.Generator(device=device).manual_seed(1)
for i in range(args.steps):
    base = rng.integers(0, cfg.vocab_size, (args.batch, 1))
    toks = (base + rng.integers(-3, 4, (args.batch, args.seq)).cumsum(1)) \
        % cfg.vocab_size
    batch = {"tokens": torch.as_tensor(toks, dtype=torch.int32,
                                       device=device),
             "labels": torch.as_tensor(toks, dtype=torch.int32,
                                       device=device)}
    state, m = step(state, batch, gen)
    if i % 10 == 0:
        print(f"step {i:3d} loss {float(m['loss']):.3f}")
with tempfile.TemporaryDirectory() as ckpt_dir:
    checkpoint.save(ckpt_dir, args.steps, state)
    s, _ = checkpoint.restore(ckpt_dir, state)
print(f"checkpoint committed and restored at step {s}")
print("kernel launches:", json.dumps({name: fn.launches
                                      for name, fn in WRAPPERS.items()}))
