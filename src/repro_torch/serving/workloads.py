"""Synthetic workload generators modeled on the paper's evaluation
traces (§5.1): Azure LLM inference conversation trace, LiveBench,
Dolphin-r1 (reasoning / long CoT outputs) and the OpenAI Summarization
Comparison (OSC) set.

The public datasets are not available offline, so each generator
reproduces the *statistical shape* that drives scheduler behaviour —
the prompt/output length distributions and arrival process — with the
moments reported in the respective papers/cards.  Arrivals are Poisson
unless a trace is replayed closed-loop.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from repro_torch.serving.request import Request


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    name: str
    prompt_mean: float
    prompt_cv: float            # coefficient of variation (lognormal)
    output_mean: float
    output_cv: float
    prompt_max: int = 8192
    output_max: int = 4096


# Means chosen to match the published characterizations: Azure
# conversation (medium prompts, short-to-medium outputs), LiveBench
# (long analytic prompts, medium outputs), Dolphin-r1 (CoT: short
# prompts, long outputs), OSC (long documents, short summaries — the
# paper varies output length on this one).
WORKLOADS = {
    "azure-conv": WorkloadSpec("azure-conv", prompt_mean=1020, prompt_cv=1.2,
                               output_mean=210, output_cv=0.8),
    "livebench": WorkloadSpec("livebench", prompt_mean=1800, prompt_cv=0.7,
                              output_mean=350, output_cv=0.6),
    "dolphin-r1": WorkloadSpec("dolphin-r1", prompt_mean=420, prompt_cv=0.6,
                               output_mean=900, output_cv=0.7),
    "osc": WorkloadSpec("osc", prompt_mean=1000, prompt_cv=0.4,
                        output_mean=300, output_cv=0.5),
}


def poisson_offsets(rng: np.random.Generator, rate: float,
                    n: int) -> List[float]:
    """Poisson-process arrival offsets (seconds from trace start)."""
    return [float(a) for a in np.cumsum(rng.exponential(1.0 / rate, n))]


def _lognormal(rng: np.random.Generator, mean: float, cv: float,
               lo: int, hi: int, n: int) -> np.ndarray:
    sigma2 = np.log(1.0 + cv * cv)
    mu = np.log(mean) - sigma2 / 2.0
    x = rng.lognormal(mu, np.sqrt(sigma2), n)
    return np.clip(x.round().astype(int), lo, hi)


def generate(name: str, *, num_requests: int, vocab: int,
             arrival_rate: Optional[float] = None, seed: int = 0,
             output_mean_override: Optional[float] = None) -> List[Request]:
    """Sample a request trace.

    ``arrival_rate`` (req/s) => Poisson arrivals, expressed as
    *relative offsets* from trace start (the simulator's virtual clock;
    ``InferenceServer.serve`` rebases them onto the wall clock).
    None => closed-loop (the paper's throughput experiments): requests
    carry no arrival stamp and the engine stamps them at ``submit()``.
    ``output_mean_override`` reproduces the paper's §5.4 output-length
    sweep on a fixed workload.
    """
    spec = WORKLOADS[name]
    rng = np.random.default_rng(seed)
    prompts = _lognormal(rng, spec.prompt_mean, spec.prompt_cv, 4,
                         spec.prompt_max, num_requests)
    out_mean = output_mean_override or spec.output_mean
    outputs = _lognormal(rng, out_mean, spec.output_cv, 1,
                         spec.output_max, num_requests)
    if arrival_rate:
        arrivals = poisson_offsets(rng, arrival_rate, num_requests)
    else:
        arrivals = [None] * num_requests
    return [
        Request(prompt=list(rng.integers(0, vocab, int(p))),
                max_new_tokens=int(o),
                arrival_time=None if a is None else float(a))
        for p, o, a in zip(prompts, outputs, arrivals)
    ]


def fixed_length_trace(*, num_requests: int, prompt_len: int,
                       output_len: int, vocab: int, seed: int = 0
                       ) -> List[Request]:
    """Uniform trace for controlled experiments (paper §5.4 style:
    fixed input 1000, swept output)."""
    rng = np.random.default_rng(seed)
    return [Request(prompt=list(rng.integers(0, vocab, prompt_len)),
                    max_new_tokens=output_len) for _ in range(num_requests)]
