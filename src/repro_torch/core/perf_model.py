"""Profiling-informed performance model feeding Algorithm 1 (paper §3.1
"Offline Profiler and Performance Model").

Two sources yield the ``Timings`` the scheduler consumes:

  * **measured tables** -- ``core.profiler.OfflineProfiler`` times the
    port's own ops on the card (the hand-written attention kernels, the
    linear ops, the numpy host tier, the copies) and stores (x, seconds)
    samples per op; ``TablePerfModel`` interpolates them
    piecewise-linearly and extrapolates along the last segment;
  * **analytic platforms** -- first-principles roofline timing from
    hardware constants (FLOP/s, HBM bandwidth, host attention bandwidth,
    link bandwidth).

``PerfModelProvider`` resolves a spec string into either; at serving time
an ``OnlineCalibrator`` corrects the result from observed iteration times.

Port of ``repro/core/perf_model.py``.  The host tier is priced at the
bytes its pool stores per position: the device's for the fp32 pool, one
byte per element plus a K and a V fp32 scale for the int8 pool.  A saved
profile has the reference's JSON format, so either package loads the
other's.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.analytical import Timings
from repro_torch.models.config import BlockKind, ModelConfig


@dataclasses.dataclass(frozen=True)
class Platform:
    """Hardware constants; *effective* (derated) rates, not peaks."""

    name: str
    device_flops: float          # dense matmul FLOP/s (effective)
    device_bw: float             # device HBM bytes/s
    host_bw: float               # host-tier attention memory bytes/s
    link_bw: float               # device<->host transfer bytes/s
    link_latency: float          # per-transfer fixed cost (s)
    device_mem: float            # HBM bytes
    host_mem: float              # DRAM bytes
    kernel_overhead: float = 10e-6   # per-op launch/dispatch overhead (s)


# Effective rates ~60-70% of peak (the usual achievable fraction).  Host
# bw is the *effective paged-attention* rate, not DRAM peak: CPU attention
# at small batch is parallelism/compute limited well below its DRAM
# bandwidth (paper §2.4, Fig. 1b).
PLATFORMS: Dict[str, Platform] = {
    "a10": Platform("a10", device_flops=125e12 * 0.6, device_bw=600e9 * 0.7,
                    host_bw=12e9, link_bw=12e9, link_latency=15e-6,
                    device_mem=24e9, host_mem=250e9),
    "t4": Platform("t4", device_flops=65e12 * 0.6, device_bw=320e9 * 0.7,
                   host_bw=15e9, link_bw=10e9, link_latency=15e-6,
                   device_mem=16e9, host_mem=180e9),
    # NVIDIA H100 SXM data sheet: 989 TFLOP/s dense bf16, 3.35 TB/s HBM3,
    # 80 GB, PCIe Gen5 x16 (64 GB/s each way, derated by half).  host_bw
    # is a modelling assumption for the CPU tier's paged attention, not a
    # measurement.
    "h100": Platform("h100", device_flops=989e12 * 0.6,
                     device_bw=3.35e12 * 0.7, host_bw=30e9,
                     link_bw=64e9 * 0.5, link_latency=10e-6,
                     device_mem=80e9, host_mem=96e9),
}


@dataclasses.dataclass(frozen=True)
class ModelCosts:
    """Shape-derived per-op costs of one decoder iteration."""

    linear_params: int           # params touched by linear ops (active)
    linear_flops_per_token: int  # 2 * linear_params
    kv_bytes_per_pos: int        # bytes of K+V per cached position (all layers)
    kv_bytes_per_pos_layer: int  # per attention layer
    num_attn_layers: int
    bytes_per_param: int = 2
    state_bytes_per_row: int = 0  # recurrent (SSM/xLSTM) state per request,
    #                               all layers -- 0 for attention-only stacks
    # bytes per cached position as the host tier stores them -- what
    # t_catt (host attention is bandwidth bound on them), t_migrate (they
    # cross the link) and n_c charge; 0 means "as the device fields" (an
    # unquantized pool); from_config(host_kv_bytes_per_el=1) prices the
    # int8 pool (one byte per element plus a K and a V fp32 scale)
    host_kv_bytes_per_pos: int = 0
    host_kv_bytes_per_pos_layer: int = 0

    def __post_init__(self) -> None:
        if self.host_kv_bytes_per_pos == 0:
            object.__setattr__(self, "host_kv_bytes_per_pos",
                               self.kv_bytes_per_pos)
        if self.host_kv_bytes_per_pos_layer == 0:
            object.__setattr__(self, "host_kv_bytes_per_pos_layer",
                               self.kv_bytes_per_pos_layer)

    @classmethod
    def from_config(cls, cfg: ModelConfig, bytes_per_param: int = 2,
                    kv_bytes_per_el: int = 2,
                    host_kv_bytes_per_el: Optional[int] = None
                    ) -> "ModelCosts":
        head = cfg.resolved_head_dim
        kv_per_layer = 2 * cfg.num_kv_heads * head * kv_bytes_per_el
        host_per_layer = 0
        if host_kv_bytes_per_el is not None:
            host_per_layer = 2 * cfg.num_kv_heads * head * host_kv_bytes_per_el
            if host_kv_bytes_per_el < kv_bytes_per_el:   # quantized: scales
                host_per_layer += 2 * 4
        # linear params = everything except the embedding table (decode
        # touches one row): attention projections + FFN + head
        linear = max(cfg.active_param_count() - cfg.vocab_size * cfg.d_model,
                     1)
        return cls(
            linear_params=linear,
            linear_flops_per_token=2 * linear,
            kv_bytes_per_pos=kv_per_layer * cfg.num_attn_layers,
            kv_bytes_per_pos_layer=kv_per_layer,
            num_attn_layers=max(cfg.num_attn_layers, 1),
            bytes_per_param=bytes_per_param,
            state_bytes_per_row=_recurrent_state_bytes(cfg),
            host_kv_bytes_per_pos=host_per_layer * cfg.num_attn_layers,
            host_kv_bytes_per_pos_layer=host_per_layer,
        )


def _recurrent_state_bytes(cfg: ModelConfig) -> int:
    """Per-request bytes of recurrent state across the whole stack (row
    shapes as the states are stored: conv windows bf16, scan carries
    fp32) -- what a hybrid tier move carries besides the paged KV."""
    d = cfg.d_model
    per_entry = 0
    for kind in cfg.block_pattern:
        if kind == BlockKind.MAMBA:
            m = cfg.mamba
            inner = m.expand * d
            per_entry += (m.conv_dim - 1) * inner * 2 + inner * m.state_dim * 4
        elif kind == BlockKind.SLSTM:
            per_entry += 4 * d * 4                      # c, n, h, m fp32
        elif kind == BlockKind.MLSTM:
            inner = 2 * d
            hd = inner // cfg.num_heads
            per_entry += (cfg.num_heads * hd * hd * 4   # cmat
                          + cfg.num_heads * hd * 4      # n
                          + cfg.num_heads * 4           # m
                          + 3 * inner * 2)              # conv window bf16
    return per_entry * cfg.num_groups


class AnalyticPerfModel:
    """Roofline timing from (Platform, ModelCosts)."""

    def __init__(self, platform: Platform, costs: ModelCosts) -> None:
        self.platform = platform
        self.costs = costs

    def t_linear(self, n_tokens: int) -> float:
        """Device linear-op time for n_tokens rows: flat (bandwidth bound
        on the weights) until the FLOP term takes over (Fig. 1a)."""
        p = self.platform
        weight_time = self.costs.linear_params * self.costs.bytes_per_param \
            / p.device_bw
        flop_time = self.costs.linear_flops_per_token * n_tokens \
            / p.device_flops
        return max(weight_time, flop_time) + p.kernel_overhead

    def t_prefill(self, n_tokens: int, context: float) -> float:
        """Prefill compute for n_tokens (linear + quadratic attention)."""
        p = self.platform
        linear = self.costs.linear_flops_per_token * n_tokens / p.device_flops
        attn_flops = (2.0 * n_tokens * max(context, 1.0) / 2.0
                      * (self.costs.kv_bytes_per_pos / 2) * 2)
        return linear + attn_flops / p.device_flops + p.kernel_overhead

    def t_prefill_suffix(self, n_new: int, total_context: float) -> float:
        """Prefill compute for the last ``n_new`` tokens of a
        ``total_context``-long prompt (a prefix-cache continuation):
        linear work scales with the suffix, each suffix query attends
        the full cached context.  Equals ``t_prefill(T, T)`` when
        ``n_new == total_context``."""
        p = self.platform
        linear = self.costs.linear_flops_per_token * n_new / p.device_flops
        mean_ctx = max(total_context - n_new / 2.0, 1.0)
        attn_flops = 2.0 * n_new * mean_ctx * (self.costs.kv_bytes_per_pos
                                               / 2) * 2
        return linear + attn_flops / p.device_flops + p.kernel_overhead

    def t_gatt(self, batch: int, context: float) -> float:
        """Device decode attention: KV-bandwidth bound."""
        p = self.platform
        kv_bytes = batch * max(context, 1.0) * self.costs.kv_bytes_per_pos
        return kv_bytes / p.device_bw + p.kernel_overhead

    def t_catt(self, batch: int, context: float,
               layers: Optional[int] = None) -> float:
        """Host attention over ``layers`` (default: all attention layers),
        at the host tier's stored bytes per position."""
        p = self.platform
        n_layers = self.costs.num_attn_layers if layers is None else layers
        kv_bytes = (batch * max(context, 1.0)
                    * self.costs.host_kv_bytes_per_pos_layer * n_layers)
        return kv_bytes / p.host_bw + p.kernel_overhead

    def t_transfer(self, n_bytes: float) -> float:
        p = self.platform
        return n_bytes / p.link_bw + p.link_latency

    def t_migrate(self, n_tokens: int) -> float:
        """Tier-move cost: a request's cached KV span over every
        attention layer (in its host-stored form) plus its recurrent-state
        row (hybrids) crossing the device<->host link once -- charged
        against rebalance and preemption decisions by the ``TierPlacer``."""
        return self.t_transfer(max(n_tokens, 0)
                               * self.costs.host_kv_bytes_per_pos
                               + self.costs.state_bytes_per_row)

    def t_recompute(self, prompt_tokens: int, emitted_tokens: int = 0
                    ) -> float:
        """Recompute-from-scratch preemption cost: re-prefill the whole
        prompt and re-decode every token already emitted (mean attended
        context grows from the prompt over the emitted span)."""
        prompt_tokens = max(prompt_tokens, 1)
        emitted = max(emitted_tokens, 0)
        t = self.t_prefill(prompt_tokens, prompt_tokens)
        mean_ctx = prompt_tokens + emitted / 2.0
        t += emitted * (self.t_linear(1) + self.t_gatt(1, mean_ctx))
        return t

    def n_g(self, context: float) -> float:
        """Device attention rate: KV positions scanned per second."""
        return self.platform.device_bw / max(self.costs.kv_bytes_per_pos, 1)

    def n_c(self, context: float) -> float:
        """Host attention rate at the stored element size: KV positions
        scanned per second."""
        return self.platform.host_bw / max(self.costs.host_kv_bytes_per_pos,
                                           1)

    def timings(self, decode_batch: int, mean_context: float,
                prefill_tokens: int = 0) -> Timings:
        t_lin = self.t_linear(max(decode_batch, 1))
        t_att = self.t_gatt(max(decode_batch, 1), mean_context)
        kw = {}
        if prefill_tokens:
            kw = dict(
                t_glinear_pref=self.t_linear(decode_batch + prefill_tokens),
                t_gatt_pref=(self.t_gatt(decode_batch, mean_context)
                             + self.t_prefill(prefill_tokens, prefill_tokens)
                             * 0.5),
            )
        return Timings(t_glinear=t_lin, t_gatt=t_att,
                       n_g=self.n_g(mean_context), n_c=self.n_c(mean_context),
                       **kw)


class TablePerfModel:
    """Piecewise-linear interpolation over measured (x, seconds) samples.

    Ops: "linear" (x = tokens), "gatt" (x = batch * context KV
    positions), "catt" (same, host), "transfer" (x = bytes), "prefill"
    (x = tokens).  Each table covers the whole stack (every layer, or
    every attention layer), as ``OfflineProfiler`` scales them.
    """

    def __init__(self, tables: Dict[str, List[Tuple[float, float]]],
                 *, kv_bytes_per_pos: int, num_attn_layers: int,
                 state_bytes_per_row: int = 0,
                 host_kv_bytes_per_pos: Optional[int] = None,
                 fingerprint: Optional[str] = None,
                 profile_grid: Optional[Dict[str, List[float]]] = None
                 ) -> None:
        self.tables = {k: (np.asarray([p[0] for p in v], float),
                           np.asarray([p[1] for p in v], float))
                       for k, v in tables.items()}
        for xs, _ in self.tables.values():
            if not (np.diff(xs) > 0).all():
                raise ValueError("table x values must be increasing")
        self.kv_bytes_per_pos = kv_bytes_per_pos
        self.num_attn_layers = num_attn_layers
        self.state_bytes_per_row = state_bytes_per_row
        # bytes per position as the host pool stores them (None: as the
        # device does -- the fp32 pool)
        self.host_kv_bytes_per_pos = (kv_bytes_per_pos
                                      if host_kv_bytes_per_pos is None
                                      else host_kv_bytes_per_pos)
        # the model shape the tables were measured for (model_fingerprint)
        # and the sample points; None for hand-built tables
        self.fingerprint = fingerprint
        self.profile_grid = (None if profile_grid is None else
                             {k: [float(x) for x in v]
                              for k, v in profile_grid.items()})

    def _eval(self, op: str, x: float) -> float:
        xs, ys = self.tables[op]
        if x >= xs[-1] and len(xs) >= 2:   # extrapolate the last segment
            # an op never gets cheaper with size: a noisy flat tail must
            # not extrapolate below the last sample (or to <= 0, which
            # Timings refuses)
            slope = max((ys[-1] - ys[-2]) / (xs[-1] - xs[-2]), 0.0)
            return float(ys[-1] + slope * (x - xs[-1]))
        return float(np.interp(x, xs, ys))

    def t_linear(self, n_tokens: int) -> float:
        return self._eval("linear", n_tokens)

    def t_gatt(self, batch: int, context: float) -> float:
        return self._eval("gatt", batch * max(context, 1.0))

    def t_catt(self, batch: int, context: float,
               layers: Optional[int] = None) -> float:
        n_layers = self.num_attn_layers if layers is None else layers
        per_all = self._eval("catt", batch * max(context, 1.0))
        return per_all * n_layers / self.num_attn_layers

    def t_transfer(self, n_bytes: float) -> float:
        return self._eval("transfer", n_bytes)

    def t_migrate(self, n_tokens: int) -> float:
        """A request's cached K/V span (every attention layer, at the
        host-stored size) plus its recurrent-state row across the link."""
        return self.t_transfer(max(n_tokens, 0) * self.host_kv_bytes_per_pos
                               + self.state_bytes_per_row)

    def t_recompute(self, prompt_tokens: int, emitted_tokens: int = 0
                    ) -> float:
        """Re-prefill the prompt plus re-decode each emitted token at its
        growing context."""
        prompt_tokens = max(prompt_tokens, 1)
        emitted = max(emitted_tokens, 0)
        t = self.t_prefill(prompt_tokens, prompt_tokens)
        mean_ctx = prompt_tokens + emitted / 2.0
        t += emitted * (self.t_linear(1) + self.t_gatt(1, mean_ctx))
        return t

    def t_prefill(self, n_tokens: int, context: float) -> float:
        return self._eval("prefill", n_tokens)

    def t_prefill_suffix(self, n_new: int, total_context: float) -> float:
        """A prefix-cache continuation: the table is keyed by token count
        alone, so the suffix's tokens are charged (monotone in the cached
        length, which admission backpressure needs)."""
        return self._eval("prefill", n_new)

    def n_g(self, context: float) -> float:
        """Device attention rate in KV positions/s at the operating
        context (the secant through the table)."""
        x = max(float(context), 1.0)
        return x / max(self._eval("gatt", x), 1e-9)

    def n_c(self, context: float) -> float:
        x = max(float(context), 1.0)
        return x / max(self._eval("catt", x), 1e-9)

    def timings(self, decode_batch: int, mean_context: float,
                prefill_tokens: int = 0) -> Timings:
        kw = {}
        if prefill_tokens:
            # as AnalyticPerfModel: the mixed branch's attention term is
            # decode attention plus half the prefill's (causal triangle)
            kw = dict(t_glinear_pref=self.t_linear(decode_batch
                                                   + prefill_tokens),
                      t_gatt_pref=(self.t_gatt(decode_batch, mean_context)
                                   + 0.5 * self.t_prefill(prefill_tokens,
                                                          prefill_tokens)))
        return Timings(
            t_glinear=self.t_linear(max(decode_batch, 1)),
            t_gatt=self.t_gatt(max(decode_batch, 1), mean_context),
            n_g=self.n_g(mean_context), n_c=self.n_c(mean_context), **kw)

    def save(self, path: str) -> None:
        payload = {
            "tables": {k: list(map(list, zip(xs.tolist(), ys.tolist())))
                       for k, (xs, ys) in self.tables.items()},
            "kv_bytes_per_pos": self.kv_bytes_per_pos,
            "num_attn_layers": self.num_attn_layers,
            "state_bytes_per_row": self.state_bytes_per_row,
            "host_kv_bytes_per_pos": self.host_kv_bytes_per_pos,
            "fingerprint": self.fingerprint,
            "profile_grid": self.profile_grid,
        }
        with open(path, "w") as f:
            json.dump(payload, f, indent=1)

    @classmethod
    def load(cls, path: str) -> "TablePerfModel":
        with open(path) as f:
            payload = json.load(f)
        return cls({k: [tuple(p) for p in v]
                    for k, v in payload["tables"].items()},
                   kv_bytes_per_pos=payload["kv_bytes_per_pos"],
                   num_attn_layers=payload["num_attn_layers"],
                   state_bytes_per_row=payload.get("state_bytes_per_row", 0),
                   host_kv_bytes_per_pos=payload.get("host_kv_bytes_per_pos"),
                   fingerprint=payload.get("fingerprint"),
                   profile_grid=payload.get("profile_grid"))


HOST_KV_EL_BYTES: Dict[str, int] = {"fp32": 4, "int8": 1}


def host_kv_el_bytes(host_kv_dtype: Optional[str]) -> Optional[int]:
    """Stored bytes per element of a host-pool dtype, or None for fp32
    (which keeps the ``ModelCosts`` host fields at the device's)."""
    if host_kv_dtype in (None, "fp32"):
        return None
    return HOST_KV_EL_BYTES[host_kv_dtype]


def analytic_model(platform: str, cfg: ModelConfig,
                   host_kv_dtype: str = "fp32") -> AnalyticPerfModel:
    if platform not in PLATFORMS:
        raise ValueError(f"unknown platform {platform!r}; "
                         f"have {sorted(PLATFORMS)}")
    return AnalyticPerfModel(PLATFORMS[platform], ModelCosts.from_config(
        cfg, host_kv_bytes_per_el=host_kv_el_bytes(host_kv_dtype)))


def model_fingerprint(cfg: ModelConfig, host_kv_dtype: str = "fp32") -> str:
    """Identity of the model shape a measured profile belongs to; host
    independent (the same model profiled on another machine is a fair
    reuse, another model's tables are not).  A quantized host tier adds a
    suffix: its catt table is measured at the stored dtype.  The
    reference's string."""
    costs = ModelCosts.from_config(cfg)
    base = (f"{cfg.name}:d{cfg.d_model}:L{cfg.num_layers}"
            f":attn{costs.num_attn_layers}:kv{costs.kv_bytes_per_pos}")
    if host_kv_dtype not in (None, "fp32"):
        base += f":hostkv-{host_kv_dtype}"
    return base


# the grid the engine profiles at startup: smaller than OfflineProfiler's
# defaults so that serving starts quickly; the small kv points cover the
# short contexts of modest serving configurations (the profiler shrinks
# the context to the total), the large ones batched long contexts
STARTUP_PROFILE_GRID: Dict[str, Tuple[int, ...]] = dict(
    token_counts=(1, 8, 32, 128),
    kv_positions=(128, 512, 1024, 4096, 16384, 65536),
    transfer_sizes=(1 << 16, 1 << 20),
)


@dataclasses.dataclass
class PerfModelProvider:
    """Resolves a perf-model spec into the ``timings()`` interface:

      * ``"analytic"``            -- analytic model for ``platform``;
      * ``"analytic:<platform>"`` -- analytic model for a named platform;
      * ``"measured"``            -- ``OfflineProfiler`` on ``device`` (a
        profile cached at ``profile_cache`` for this model, and for
        ``profile_grid`` when one is given, is loaded instead; a fresh
        profile is saved there);
      * ``"file:<path>"``         -- a saved profile.
    """

    cfg: ModelConfig
    platform: str = "h100"
    profile_cache: Optional[str] = None
    profile_grid: Optional[Dict[str, Tuple[int, ...]]] = None
    device: str = "cuda"
    host_kv_dtype: str = "fp32"

    def resolve(self, spec: str):
        spec = (spec or "analytic").strip()
        if spec == "analytic":
            return analytic_model(self.platform, self.cfg, self.host_kv_dtype)
        if spec.startswith("analytic:"):
            return analytic_model(spec.split(":", 1)[1], self.cfg,
                                  self.host_kv_dtype)
        if spec.startswith("file:"):
            path = spec.split(":", 1)[1]
            if not os.path.exists(path):
                raise ValueError(f"perf-model profile not found: {path!r}")
            model = TablePerfModel.load(path)
            want = model_fingerprint(self.cfg, self.host_kv_dtype)
            if model.fingerprint is not None and model.fingerprint != want:
                raise ValueError(
                    f"profile {path!r} was measured for "
                    f"{model.fingerprint} but this server runs {want}")
            return model
        if spec == "measured":
            if self.profile_cache and os.path.exists(self.profile_cache):
                model = TablePerfModel.load(self.profile_cache)
                if model.fingerprint == model_fingerprint(
                        self.cfg, self.host_kv_dtype) \
                        and self._grid_matches(model):
                    return model
                # stale (another model, no fingerprint, or not measured
                # at the requested grid): profile again and overwrite
            from repro_torch.core.profiler import OfflineProfiler
            grid = dict(self.profile_grid or STARTUP_PROFILE_GRID)
            model = OfflineProfiler(self.cfg, device=self.device,
                                    host_kv_dtype=self.host_kv_dtype
                                    ).run(**grid)
            if self.profile_cache:
                model.save(self.profile_cache)
            return model
        raise ValueError(
            f"unknown perf-model spec {spec!r}; expected 'analytic', "
            f"'analytic:<platform>', 'measured' or 'file:<path>'")

    def _grid_matches(self, model: TablePerfModel) -> bool:
        """A cache satisfies an explicitly requested grid only if it was
        measured at those points; with none requested, any measurement
        of this model does."""
        if self.profile_grid is None:
            return True
        want = {k: [float(x) for x in v]
                for k, v in self.profile_grid.items()}
        return model.profile_grid == want


def resolve_perf_model(spec: str, cfg: ModelConfig, *, platform: str = "h100",
                       profile_cache: Optional[str] = None,
                       profile_grid: Optional[Dict[str, Tuple[int, ...]]]
                       = None, device: str = "cuda",
                       host_kv_dtype: str = "fp32"):
    return PerfModelProvider(cfg, platform=platform,
                             profile_cache=profile_cache,
                             profile_grid=profile_grid, device=device,
                             host_kv_dtype=host_kv_dtype).resolve(spec)


class OnlineCalibrator:
    """Wraps a base perf model and refines its predictions with EWMA
    corrections from observed per-iteration timings.

    ``device_scale`` multiplies the device op times and divides ``n_g``;
    ``host_scale`` scales ``t_catt`` and divides ``n_c``.  Each
    observation moves ``log(scale)`` a step ``alpha`` toward
    ``log(observed/predicted)``, the per-update ratio clipped to
    ``[1/max_step, max_step]`` so one-off outliers cannot destroy the
    estimate.  ``step_error_ewma`` tracks |observed - predicted| /
    observed of the corrected predictions.
    """

    def __init__(self, base: Any, *, alpha: float = 0.2,
                 max_step: float = 4.0) -> None:
        self.base = base
        self.alpha = alpha
        self.max_step = max_step
        self.device_scale = 1.0
        self.host_scale = 1.0
        self.step_error_ewma: Optional[float] = None
        self.steps_observed = 0
        self.host_observed = 0

    def _walk(self, scale: float, predicted: float, observed: float) -> float:
        if predicted <= 0.0 or observed <= 0.0:
            return scale
        ratio = min(max(observed / predicted, 1.0 / self.max_step),
                    self.max_step)
        return float(scale * math.exp(self.alpha * math.log(ratio)))

    def observe_step(self, predicted: float, observed: float) -> None:
        """Feed one engine iteration's predicted vs observed wall time."""
        if predicted <= 0.0 or observed <= 0.0:
            return
        err = abs(observed - predicted) / observed
        self.step_error_ewma = (err if self.step_error_ewma is None else
                                (1.0 - self.alpha) * self.step_error_ewma
                                + self.alpha * err)
        self.device_scale = self._walk(self.device_scale, predicted, observed)
        self.steps_observed += 1

    def observe_host(self, predicted: float, observed: float) -> None:
        """Feed one host-attention job's predicted vs observed *compute*
        time (the device->host QKV transfer is accounted separately)."""
        if predicted <= 0.0 or observed <= 0.0:
            return
        self.host_scale = self._walk(self.host_scale, predicted, observed)
        self.host_observed += 1

    def timings(self, decode_batch: int, mean_context: float,
                prefill_tokens: int = 0) -> Timings:
        t = self.base.timings(decode_batch, mean_context,
                              prefill_tokens=prefill_tokens)
        s = self.device_scale
        return dataclasses.replace(
            t, t_glinear=t.t_glinear * s, t_gatt=t.t_gatt * s,
            t_glinear_pref=t.t_glinear_pref * s,
            t_gatt_pref=t.t_gatt_pref * s,
            n_g=t.n_g / s, n_c=t.n_c / self.host_scale)

    def t_catt(self, batch: int, context: float,
               layers: Optional[int] = None) -> float:
        return self.base.t_catt(batch, context, layers=layers) \
            * self.host_scale

    def __getattr__(self, name: str):
        # delegate everything else (t_linear, t_prefill, t_migrate,
        # t_recompute, ...): tier moves and replays are priced on the
        # base model, uncorrected, as in the reference
        return getattr(self.base, name)
