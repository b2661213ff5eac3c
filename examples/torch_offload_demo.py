"""The paper's mechanism, visualized on the port: Asynchronous Overlap
cohort windows for a hybrid model (one attention layer per 8-layer
period -- the host window spans the 7 Mamba layers between attention
layers).  Twin of ``examples/offload_demo.py``.

    PYTHONPATH=src python examples/torch_offload_demo.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.overlap_engine import Cohort, OverlapController

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
args = ap.parse_args()
device = torch.device(args.device)

cfg = get_config("jamba-1.5-large-398b").reduced(layers=16)
ctl = OverlapController(cfg)
print(f"{cfg.name}: {cfg.num_layers} layers, attention at "
      f"{cfg.attn_layer_indices}")
print(f"one host token takes {ctl.iterations_per_token} engine iterations\n")
cohort = Cohort(slot_rids=[0], positions=np.zeros(1, np.int64),
                x_carry=torch.zeros((1, cfg.d_model), device=device),
                attn_in=torch.zeros((1, cfg.num_heads, cfg.resolved_head_dim),
                                    device=device))
for it in range(ctl.iterations_per_token):
    io = ctl.host_io(cohort)
    emit = ctl.emit_layer(cohort)
    print(f"iter {it}: consume host attn for layer "
          f"{int(io.consume_layer):3d} | commit layers "
          f"[{int(io.window_start)}, {int(io.window_end)}) | "
          f"emit QKV at layer {emit}"
          + ("  <- token completes" if ctl.completes_token(cohort) else ""))
    ctl.advance(cohort)
