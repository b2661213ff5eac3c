"""Discrete-event serving simulator driven by the performance model.

Reproduces the paper's evaluation (Figs. 5-7) on the host by
simulating the three scheduler families over the calibrated analytic
platforms (T4 / A10 / H100):

  * ``gpu_only``  — vLLM/SwiftLLM-class device-only continuous batching.
  * ``neo``       — NEO's greedy hybrid: offload when device KV is
    full, and *always* run Asymmetric Pipelining when host decodes
    exist (the batch-split 2xT_glinear cost of Eq. (2), host attention
    on the critical path of its sub-batch).
  * ``apex``      — Algorithm 1: per-iteration strategy selection via
    Inequality (5)/(6) + mixed variant; Asynchronous Overlap keeps the
    host off the critical path (one layer per iteration per cohort,
    deferred sync) at 1/(L_a+1) host token rate.

The simulator advances in engine iterations (the natural clock of
continuous batching); every per-op duration comes from the same
``PerfModel`` the real scheduler uses — so scheduler decisions here
are exactly the decisions the engine takes.  It does no tensor work:
an ``h100`` run is the analytic h100 model's prediction, not a
measurement.

Port of ``repro/serving/simulator.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core import analytical, placement
from repro_torch.core.perf_model import (AnalyticPerfModel, ModelCosts,
                                         PLATFORMS, host_kv_el_bytes)
from repro_torch.models.config import ModelConfig
from repro_torch.serving.request import Phase, Request


@dataclasses.dataclass
class SimResult:
    name: str
    total_output_tokens: int
    makespan: float
    requests_finished: int
    avg_per_token_latency: float
    p99_per_token_latency: float
    strategy_iterations: Dict[str, int]
    host_tokens: int
    device_tokens: int

    @property
    def throughput(self) -> float:
        return self.total_output_tokens / max(self.makespan, 1e-9)


@dataclasses.dataclass
class SimConfig:
    scheduler: str = "apex"            # gpu_only | neo | apex | apex+
    prefill_chunk: int = 4096          # prefill tokens per iteration
    host_dispatch_overhead: float = 300e-6   # §4.2 thread/dispatch cost
    host_min_ratio: float = 0.0        # §4.2 admission threshold (8x)
    num_cohorts: int = 1               # >1 = beyond-paper task-pool staggering
    kv_headroom: float = 0.95          # usable fraction of memory budgets
    max_device_batch: int = 512
    # engine-level tier rebalancing: when the device idles (no waiting
    # work) host-resident requests migrate back, paying one KV transfer.
    # Applied to every hybrid scheduler so APEX-vs-NEO deltas remain
    # attributable to strategy selection alone.
    tier_rebalance: bool = True
    # cross-request prefix cache (mirrors EngineConfig.prefix_cache):
    # admitted prompts are charged only their uncached suffix, through
    # the SAME repro_torch.core.placement predicate the engine prices with
    prefix_cache: bool = True
    prefix_cache_entries: int = 32
    # host-tier stored KV precision (mirrors EngineConfig.host_kv_dtype):
    # int8 quadruples host-resident token capacity and prices t_catt /
    # t_migrate / prompt-offload transfers at the stored element size
    host_kv_dtype: str = "fp32"


class ServingSimulator:
    def __init__(self, cfg: ModelConfig, platform: str,
                 sim: Optional[SimConfig] = None) -> None:
        self.cfg = cfg
        self.sim = sim or SimConfig()
        self.platform = PLATFORMS[platform]
        self.costs = ModelCosts.from_config(
            cfg, host_kv_bytes_per_el=host_kv_el_bytes(
                self.sim.host_kv_dtype))
        self.pm = AnalyticPerfModel(self.platform, self.costs)
        param_bytes = cfg.param_count() * 2
        device_free = max(self.platform.device_mem * self.sim.kv_headroom
                          - param_bytes, 0.0)
        self.device_kv_tokens = int(device_free
                                    / max(self.costs.kv_bytes_per_pos, 1))
        # host capacity at the *stored* element size: the same DRAM
        # budget holds ~4x the tokens when the pool is int8
        self.host_kv_tokens = int(
            self.platform.host_mem * 0.8
            / max(self.costs.host_kv_bytes_per_pos, 1))
        if self.device_kv_tokens <= 0:
            raise ValueError(
                f"{cfg.name} does not fit {platform} device memory")
        self.trace_hook = None   # optional callable(dict) for debugging

    # ------------------------------------------------------------------
    def _host_rate_per_layer(self) -> float:
        """Host KV positions/s counting ONE attention layer, at the
        stored (possibly quantized) element size."""
        return self.platform.host_bw / self.costs.host_kv_bytes_per_pos_layer

    def _io_bytes_per_req_layer(self) -> float:
        """fp32 Q, K and V shipped to the host tier per offloaded request
        and attention layer, plus the attention result shipped back (the
        reference keeps these two in ``ModelCosts``; the port's engine
        does not price them, so they live here)."""
        qkv = self.cfg.num_heads + 2 * self.cfg.num_kv_heads
        return (qkv + self.cfg.num_heads) * self.cfg.resolved_head_dim * 4

    def run(self, requests: List[Request], *, max_iterations: int = 2_000_000
            ) -> SimResult:
        s = self.sim
        hybrid = s.scheduler in ("neo", "apex", "apex+")
        for r in requests:
            if r.arrival_time is None:   # unstamped => virtual-clock t=0
                r.arrival_time = 0.0
        waiting = sorted(requests, key=lambda r: r.arrival_time)
        min_budget = (max(self.device_kv_tokens, self.host_kv_tokens)
                      if hybrid else self.device_kv_tokens)
        for r in waiting:
            r.phase = Phase.QUEUED
            r.output = []
            # max-model-len style cap so every request is admissible
            if r.kv_demand() > min_budget:
                r.max_new_tokens = max(1, min_budget - r.prompt_len)
        prefill_q: List[Request] = []
        dev: List[Request] = []
        host: List[Request] = []
        finished: List[Request] = []
        dev_used = 0
        host_used = 0
        t = 0.0
        dev_tokens = 0
        host_tokens = 0
        # host cohorts progress one attention layer per iteration
        iters_per_host_token = self.cfg.num_attn_layers + 1
        host_phase = 0.0
        strategy_counts: Dict[str, int] = {}
        n_attn = self.costs.num_attn_layers

        def tier_rates() -> tuple:
            """Steady-state token-rate estimates for drain balancing.
            The device rate uses the *measured* cumulative emission rate
            once enough signal exists (the paper's §6 online-profiling
            refinement), falling back to the model early on."""
            demands = [r.kv_demand() for r in dev + host + waiting] or [1]
            ctx_est = max(float(np.mean(demands)) * 0.75, 1.0)
            bg_ss = max(1, min(s.max_device_batch,
                               int(self.device_kv_tokens
                                   / max(np.mean(demands), 1))))
            t_it = self.pm.t_linear(bg_ss) + self.pm.t_gatt(bg_ss, ctx_est)
            dev_tps = bg_ss / t_it
            if t > 3.0 and dev_tokens > 100:
                dev_tps = dev_tokens / t
            host_tps = self._host_rate_per_layer() / (
                ctx_est * (self.cfg.num_attn_layers + 1))
            # serviceable host concurrency: one cohort's worth per layer
            # of per-iteration host bandwidth (times cohort count)
            host_cap = max(1, int(s.num_cohorts * t_it
                                  * self._host_rate_per_layer() / ctx_est))
            return dev_tps, host_tps, host_cap

        # prefix cache mirror: retired prompts publish their token
        # tuples; admission charges each prompt only its uncached
        # suffix via the SHARED predicate
        # (placement.chargeable_prefill_tokens) — the same rule the
        # engine's seed_prefix_hits/TierPlacer price with, so sim and
        # engine TTFT effects cannot drift.  KV *residency* still
        # reserves the full prompt (cached KV occupies memory too).
        published: List[tuple] = []

        def cached_prefix(prompt) -> int:
            if not s.prefix_cache:
                return 0
            return max((placement.longest_common_prefix(p, prompt)
                        for p in published), default=0)

        def publish(r: Request) -> None:
            if not s.prefix_cache:
                return
            tok = tuple(r.prompt)
            for p in published:
                if len(p) >= len(tok) and p[:len(tok)] == tok:
                    return             # covered by an existing entry
            published[:] = [p for p in published if tok[:len(p)] != p]
            published.append(tok)
            if len(published) > s.prefix_cache_entries:
                published.pop(0)       # FIFO ≈ LRU at this granularity

        def admit() -> None:
            """GPU-first placement (rule 1).  Overflow goes to the host
            tier only while (a) the host can actually service it — the
            active set is bounded by cohort serviceability — and (b)
            tier drain times stay balanced (NEO's load-aware rule: an
            unboundedly deep host queue makes the slow tier the
            makespan bottleneck)."""
            nonlocal dev_used, host_used
            dev_tps, host_tps, host_cap = tier_rates()
            host_queued = len(host) + sum(
                1 for r in prefill_q if getattr(r, "_host", False))
            while waiting and waiting[0].arrival_time <= t:
                r = waiting[0]
                need = r.kv_demand()
                if (dev_used + need <= self.device_kv_tokens
                        and len(dev) + len(prefill_q) < s.max_device_batch):
                    dev_used += need
                    r.phase = Phase.PREFILL
                    r._charge = placement.chargeable_prefill_tokens(
                        r.prompt_len, cached_prefix(r.prompt))
                    prefill_q.append(waiting.pop(0))
                    continue
                if (hybrid and host_used + need <= self.host_kv_tokens
                        and host_queued < host_cap):
                    # backlog per tier INCLUDING requests still in the
                    # prefill queue, attributed to their assigned tier
                    host_remaining = sum(
                        rr.max_new_tokens - rr.tokens_generated
                        for rr in host) + sum(
                        rr.max_new_tokens for rr in prefill_q
                        if getattr(rr, "_host", False))
                    dev_remaining = sum(
                        rr.max_new_tokens - rr.tokens_generated
                        for rr in dev) + sum(
                        rr.max_new_tokens for rr in waiting) + sum(
                        rr.max_new_tokens for rr in prefill_q
                        if not getattr(rr, "_host", False))
                    host_drain = (host_remaining + r.max_new_tokens) \
                        / max(host_tps, 1e-9)
                    dev_drain = dev_remaining / max(dev_tps, 1e-9)
                    if host_drain < dev_drain:
                        host_used += need
                        host_queued += 1
                        r.phase = Phase.PREFILL
                        r._host = True  # type: ignore[attr-defined]
                        r._charge = placement.chargeable_prefill_tokens(
                            r.prompt_len, cached_prefix(r.prompt))
                        prefill_q.append(waiting.pop(0))
                        continue
                break

        def rebalance() -> float:
            """Migrate host-resident requests back to an idle device
            (pays one KV transfer per migration).  Returns time spent.
            Candidate choice and the pays-off predicate come from
            ``repro_torch.core.placement`` — the SAME rule the real engine's
            TierPlacer runs, so sim and engine cannot drift."""
            nonlocal dev_used, host_used
            if not (s.tier_rebalance and hybrid):
                return 0.0
            spent = 0.0
            while host:
                dev_tps, host_tps, _ = tier_rates()
                r = placement.pick_rebalance_candidate(host)
                if r is None:
                    break
                need = r.kv_demand()
                if not placement.should_rebalance_to_device(
                        waiting=len(waiting),
                        device_slot_free=len(dev) < s.max_device_batch,
                        device_kv_headroom=self.device_kv_tokens - dev_used,
                        need_tokens=need,
                        remaining_tokens=(r.max_new_tokens
                                          - r.tokens_generated),
                        migration_cost=self.pm.t_migrate(r.total_len),
                        device_s_per_token=1.0 / max(dev_tps, 1e-9),
                        host_s_per_token=1.0 / max(host_tps, 1e-9)):
                    break
                host.remove(r)
                host_used -= need
                dev_used += need
                r._host = False  # type: ignore[attr-defined]
                dev.append(r)
                r.phase = Phase.DECODE_DEVICE
                spent += self.pm.t_migrate(r.total_len)
            return spent

        it = 0
        while (waiting or prefill_q or dev or host) and it < max_iterations:
            it += 1
            if not (prefill_q or dev or host) and waiting:
                t = max(t, waiting[0].arrival_time)   # idle: next arrival
            admit()
            migration_time = rebalance()

            # ---- prefill chunk ------------------------------------------
            iter_time = migration_time
            prefill_tokens = 0
            while prefill_q and prefill_tokens < s.prefill_chunk:
                r = prefill_q[0]
                # only the uncached suffix costs prefill compute (and,
                # for host placements, link transfer — a cached prefix
                # is forked inside the pool, no bytes cross)
                charge = getattr(r, "_charge", r.prompt_len)
                if prefill_tokens + charge > s.prefill_chunk and prefill_tokens:
                    break
                prefill_tokens += charge
                r.phase = (Phase.DECODE_HOST
                           if getattr(r, "_host", False) else Phase.DECODE_DEVICE)
                (host if getattr(r, "_host", False) else dev).append(r)
                prefill_q.pop(0)
                if getattr(r, "_host", False):
                    # offloaded (uncached) prompt KV crosses the link
                    # in its host-stored (possibly quantized) form
                    iter_time += self.pm.t_transfer(
                        charge * self.costs.host_kv_bytes_per_pos)
            if prefill_tokens:
                iter_time += self.pm.t_prefill(prefill_tokens, prefill_tokens)

            bg, bc = len(dev), len(host)
            ctx_dev = (float(np.mean([r.total_len for r in dev]))
                       if dev else 1.0)
            ctx_host = (float(np.mean([r.total_len for r in host]))
                        if host else 1.0)

            # ---- strategy selection (Algorithm 1 / baselines) -------------
            strategy = "gpu_only"
            if hybrid and bc:
                if s.scheduler == "neo":
                    strategy = "asym_pipeline"   # greedy: always pipeline
                elif s.scheduler == "apex":
                    timings = self.pm.timings(max(bg, 1), max(ctx_dev, 1.0),
                                              prefill_tokens=prefill_tokens)
                    ok = (analytical.pipelining_beneficial_mixed(timings)
                          if prefill_tokens else
                          analytical.pipelining_beneficial_decode_only(timings))
                    strategy = "asym_pipeline" if ok else "async_overlap"
                else:  # apex+ (beyond-paper): pick the higher predicted rate
                    strategy = self._best_predicted(bg, bc, ctx_dev, ctx_host)
            strategy_counts[strategy] = strategy_counts.get(strategy, 0) + 1

            # ---- decode execution ------------------------------------------
            if bg or bc:
                t_ga = self.pm.t_gatt(bg, ctx_dev) if bg else 0.0
                if strategy == "gpu_only":
                    if bg:
                        iter_time += self.pm.t_linear(bg) + t_ga
                        dev_tokens += self._emit(dev, t, iter_time)
                elif strategy == "asym_pipeline":
                    cap, cycle = self._plan_pipeline(bg, bc, ctx_dev, ctx_host)
                    active = host[:cap]
                    iter_time += cycle
                    dev_tokens += self._emit(dev, t, iter_time)
                    host_tokens += self._emit(active, t, iter_time)
                    host[:] = host[cap:] + active   # round-robin fairness
                else:  # async_overlap
                    cohorts = max(1, min(s.num_cohorts, n_attn))
                    cap, cycle = self._plan_overlap(bg, bc, ctx_dev, ctx_host,
                                                    cohorts)
                    active = host[:cap]
                    iter_time += cycle
                    dev_tokens += self._emit(dev, t, iter_time)
                    host_phase += cohorts
                    if host_phase >= iters_per_host_token:
                        host_phase -= iters_per_host_token
                        host_tokens += self._emit(active, t, iter_time)
                        host[:] = host[cap:] + active

            t += max(iter_time, 1e-9)

            if self.trace_hook is not None:
                self.trace_hook(dict(it=it, t=t, iter_time=iter_time,
                                     strategy=strategy, dev=len(dev),
                                     host=len(host), waiting=len(waiting),
                                     prefill_q=len(prefill_q),
                                     prefill_tokens=prefill_tokens,
                                     dev_used=dev_used, host_used=host_used,
                                     dev_tokens=dev_tokens,
                                     host_tokens=host_tokens))

            # ---- retire finished ------------------------------------------
            for pool, tier in ((dev, "dev"), (host, "host")):
                for r in [r for r in pool if r.done]:
                    r.phase = Phase.FINISHED
                    r.finish_time = t
                    pool.remove(r)
                    finished.append(r)
                    publish(r)
                    if tier == "dev":
                        dev_used -= r.kv_demand()
                    else:
                        host_used -= r.kv_demand()

        lats = [r.per_token_latency() for r in finished
                if r.per_token_latency() is not None]
        return SimResult(
            name=f"{self.cfg.name}/{self.platform.name}/{s.scheduler}",
            total_output_tokens=dev_tokens + host_tokens,
            makespan=t, requests_finished=len(finished),
            avg_per_token_latency=float(np.mean(lats)) if lats else 0.0,
            p99_per_token_latency=float(np.percentile(lats, 99)) if lats else 0.0,
            strategy_iterations=strategy_counts,
            host_tokens=host_tokens, device_tokens=dev_tokens)

    def _plan_pipeline(self, bg: int, bc: int, ctx_dev: float,
                       ctx_host: float) -> tuple:
        """Asymmetric Pipelining plan: (host sub-batch, cycle time).

        Eq. (2): the split doubles linear time (when a device sub-batch
        exists at all).  The host sub-batch is SIZED to the window (the
        scheduler "calculates how many tokens the CPU can process
        within 2*T_glinear + T_gatt", §3.4) — all attention layers per
        token on the host path, 0.9 safety for transfer/dispatch."""
        n_attn = self.costs.num_attn_layers
        t_ga = self.pm.t_gatt(bg, ctx_dev) if bg else 0.0
        splits = 2.0 if bg else 1.0
        window = splits * self.pm.t_linear(max(bg, 1)) + t_ga
        budget = max(window * 0.9 - self.sim.host_dispatch_overhead, 1e-5)
        cap = max(1, int(budget * self._host_rate_per_layer()
                         / (max(ctx_host, 1.0) * n_attn)))
        cap = min(cap, bc) if bc else 0
        t_host = (self.pm.t_catt(cap, ctx_host)
                  + self.pm.t_transfer(cap * n_attn
                                       * self._io_bytes_per_req_layer())
                  + self.sim.host_dispatch_overhead) if cap else 0.0
        return cap, max(window, t_host)

    def _plan_overlap(self, bg: int, bc: int, ctx_dev: float,
                      ctx_host: float, cohorts: int) -> tuple:
        """Asynchronous Overlap plan: (cohort size, iteration time).
        Unified linear ops (no split); the host computes one layer per
        cohort per iteration, sized to stay off the critical path."""
        t_ga = self.pm.t_gatt(bg, ctx_dev) if bg else 0.0
        device_path = self.pm.t_linear(max(bg + bc, 1)) + t_ga
        budget = max(device_path * 0.9 - self.sim.host_dispatch_overhead, 1e-5)
        cap = max(1, int(budget * self._host_rate_per_layer()
                         / (max(ctx_host, 1.0) * cohorts)))
        cap = min(cap, bc) if bc else 0
        t_host = (self.pm.t_catt(cap, ctx_host, layers=cohorts)
                  + self.pm.t_transfer(cap * cohorts
                                       * self._io_bytes_per_req_layer())
                  + self.sim.host_dispatch_overhead) if cap else 0.0
        return cap, max(device_path, t_host)

    def _best_predicted(self, bg: int, bc: int, ctx_dev: float,
                        ctx_host: float) -> str:
        """apex+ (beyond-paper): predicted-token-rate argmax between the
        two hybrid strategies — using the exact execution plans, not the
        Ineq-(5) proxy."""
        n_attn = self.costs.num_attn_layers
        cohorts = max(1, min(self.sim.num_cohorts, n_attn))
        cap_p, cycle_p = self._plan_pipeline(bg, bc, ctx_dev, ctx_host)
        cap_a, cycle_a = self._plan_overlap(bg, bc, ctx_dev, ctx_host, cohorts)
        rate_pipeline = (bg + cap_p) / cycle_p
        rate_async = (bg + cap_a * cohorts / (n_attn + 1)) / cycle_a
        return "asym_pipeline" if rate_pipeline > rate_async else "async_overlap"

    @staticmethod
    def _emit(pool: List[Request], t: float, iter_time: float) -> int:
        n = 0
        for r in pool:
            if not r.done:
                r.output.append(0)
                if r.first_token_time is None:
                    r.first_token_time = t + iter_time
                n += 1
        return n


def compare_schedulers(cfg: ModelConfig, platform: str,
                       requests_fn, schedulers=("gpu_only", "neo", "apex"),
                       **sim_kwargs) -> Dict[str, SimResult]:
    """Run the same trace under each scheduler (fresh request copies)."""
    out = {}
    for sched in schedulers:
        reqs = requests_fn()
        sim = ServingSimulator(cfg, platform,
                               SimConfig(scheduler=sched, **sim_kwargs))
        out[sched] = sim.run(reqs)
    return out
