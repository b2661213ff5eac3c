"""Quickstart on the port: build a small model, prefill, decode -- then do
the same through the APEX engine with host offload and verify identical
output.  Twin of ``examples/quickstart.py``.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

On the card the decode and prefill attention run in the hand-written
CUDA kernels; their launch counts are printed at the end.
"""
import argparse
import json

import torch

from repro_torch.configs import get_config
from repro_torch.kernels.decode_attention import decode_attention_cuda
from repro_torch.kernels.mamba_scan import (mamba_selective_scan_bwd_cuda,
                                            mamba_selective_scan_cuda)
from repro_torch.kernels.prefill_attention import (prefill_attention_bwd_cuda,
                                                   prefill_attention_cuda)
from repro_torch.models import (decode_step, init_decode_state, init_params,
                                prefill)
from repro_torch.serving import InferenceServer, Request, ServerConfig

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
args = ap.parse_args()
device = torch.device(args.device)
WRAPPERS = {"decode_attention": decode_attention_cuda,
            "prefill_attention": prefill_attention_cuda,
            "mamba_selective_scan": mamba_selective_scan_cuda,
            "prefill_attention_bwd": prefill_attention_bwd_cuda,
            "mamba_selective_scan_bwd": mamba_selective_scan_bwd_cuda}
for fn in WRAPPERS.values():
    fn.launches = 0

# 1. a reduced-geometry Llama-3.1-family model (the paper's A10 model)
cfg = get_config("llama3.1-8b").reduced(layers=4, d_model=128, vocab=512)
params = init_params(cfg, seed=0, device=device)
print(f"model: {cfg.name}, {cfg.param_count()/1e6:.1f}M params")

# 2. raw API: prefill a prompt, then greedy-decode 8 tokens
prompt = torch.tensor([[5, 42, 7, 1, 99, 3, 17, 56]], dtype=torch.int32,
                      device=device)
state = init_decode_state(cfg, device_batch=1, cache_len=64, device=device)
with torch.no_grad():
    logits, state = prefill(params, cfg, {"tokens": prompt}, state)
    toks = [int(torch.argmax(logits, -1)[0])]
    for _ in range(7):
        logits, state, _, _ = decode_step(
            params, cfg, torch.tensor([toks[-1]], dtype=torch.int32,
                                      device=device), state)
        toks.append(int(torch.argmax(logits, -1)[0]))
print("raw decode:   ", toks)

# 3. the APEX server: 1 device slot forces offload of the second
#    request; h2 streams per-token while the scheduler-driven
#    continuous-batching loop advances both requests
with InferenceServer(cfg, params, ServerConfig(
        device_slots=1, host_slots=2, cache_len=64,
        device=args.device)) as server:
    h1 = server.submit(Request(prompt=[int(t) for t in prompt[0]],
                               max_new_tokens=8))
    h2 = server.submit([int(t) for t in prompt[0]], max_new_tokens=8)
    streamed = list(h2.tokens())     # pulls tokens as they are produced
    server.run_until_idle()
    stats = server.stats
print("device request:", h1.output)
print("host request:  ", streamed, "(host tokens:", stats.host_tokens, ")")
print("strategies:    ", stats.strategy_counts)
if stats.prediction_error is not None:   # predicted-vs-observed step time
    print(f"sched accuracy: {100 * stats.prediction_error:.0f}% error "
          f"({stats.perf_model_spec} model, online-calibrated)")
print("kernel launches:", json.dumps({name: fn.launches
                                      for name, fn in WRAPPERS.items()}))
assert h1.output == toks and streamed == toks, "outputs must be identical"
print("OK — device, host-offloaded and raw decode all agree")
