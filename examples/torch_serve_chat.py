"""Online serving on the port under a conversation-trace workload through
the scheduler-driven ``InferenceServer`` -- streams tokens per request
and reports throughput / latency / per-iteration strategy decisions.
Twin of ``examples/serve_chat.py``.

    PYTHONPATH=src python examples/torch_serve_chat.py [--device cpu]
"""
import argparse
import os
import tempfile
import time

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.perf_model import analytic_model
from repro_torch.core.scheduler import ApexScheduler
from repro_torch.models import init_params
from repro_torch.serving import InferenceServer, ServerConfig

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
ap.add_argument("--requests", type=int, default=10)
ap.add_argument("--perf-model", default="measured",
                help="measured (profiled at startup) or analytic")
args = ap.parse_args()

cfg = get_config("llama2-7b").reduced(layers=4, d_model=128, vocab=512)
params = init_params(cfg, seed=0, device=args.device)

# Algorithm 1 standalone, on the paper's T4 calibration: the same
# scheduler the server runs every iteration.
sched = ApexScheduler(analytic_model("t4", get_config("llama2-7b")))
d = sched.schedule([], list(range(4)), list(range(24)), mean_context=1024)
print(f"Algorithm 1 decode-only decision on T4: {d.strategy.value} "
      f"({d.reason})")

# one structured config: engine capacity + scheduler + workload.
# perf_model="measured" is the profiling-informed mode (§3.1): the
# server runs the OfflineProfiler on the port's own ops at startup
# (cached to profile_cache) and schedules off the measured tables,
# refined online by the EWMA calibrator.
with tempfile.TemporaryDirectory() as tmp:
    scfg = ServerConfig(device_slots=3, host_slots=6, cache_len=96,
                        perf_model=args.perf_model,
                        profile_cache=os.path.join(tmp, "profile.json"),
                        profile_grid=dict(token_counts=(1, 4, 16),
                                          kv_positions=(64, 256, 1024),
                                          transfer_sizes=(1 << 16,)),
                        workload="azure-conv", num_requests=args.requests,
                        prompt_len=24, output_len=16, device=args.device)

    t0 = time.perf_counter()
    with InferenceServer(cfg, params, scfg) as server:
        handles = [server.submit(r)
                   for r in scfg.build_requests(vocab=cfg.vocab_size)]
        # stream the first response token-by-token; pulling the iterator
        # drives the continuous-batching loop, so every request advances
        print("request 0 stream:", end=" ", flush=True)
        for tok in handles[0].tokens():
            print(tok, end=" ", flush=True)
        print()
        server.run_until_idle()
        stats = server.stats
    wall = time.perf_counter() - t0

reqs = [h.request for h in handles]
lats = [r.per_token_latency() for r in reqs if r.per_token_latency()]
print(f"{len(reqs)} requests, {stats.device_tokens} device + "
      f"{stats.host_tokens} host tokens in {wall:.1f}s "
      f"({(stats.device_tokens + stats.host_tokens)/wall:.1f} tok/s)")
print(f"per-iteration strategy decisions: {stats.strategy_counts}")
print(f"avg per-token latency {np.mean(lats)*1e3:.0f} ms; "
      f"host attention busy {stats.host_busy_time:.2f}s (overlapped)")
print(f"scheduling accuracy ({stats.perf_model_spec}): predicted "
      f"{stats.predicted_time:.2f}s vs observed {stats.observed_time:.2f}s "
      f"(step-error ewma {100 * (stats.step_error_ewma or 0):.0f}%)")
