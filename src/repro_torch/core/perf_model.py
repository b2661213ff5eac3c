"""Analytic performance model feeding Algorithm 1 (paper §3.1).

First-principles roofline timing from hardware constants (FLOP/s, HBM
bandwidth, host attention bandwidth, link bandwidth), wrapped at serving
time in an ``OnlineCalibrator`` that corrects it from observed iteration
times.  Yields the ``Timings`` the scheduler consumes.

Port of ``repro/core/perf_model.py`` without the measured tables
(``TablePerfModel``, ``OfflineProfiler``, the ``"measured"`` and
``"file:"`` specs) and without the quantized host tier's pricing.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

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

    @classmethod
    def from_config(cls, cfg: ModelConfig, bytes_per_param: int = 2,
                    kv_bytes_per_el: int = 2) -> "ModelCosts":
        head = cfg.resolved_head_dim
        kv_per_layer = 2 * cfg.num_kv_heads * head * kv_bytes_per_el
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

    def t_gatt(self, batch: int, context: float) -> float:
        """Device decode attention: KV-bandwidth bound."""
        p = self.platform
        kv_bytes = batch * max(context, 1.0) * self.costs.kv_bytes_per_pos
        return kv_bytes / p.device_bw + p.kernel_overhead

    def t_catt(self, batch: int, context: float,
               layers: Optional[int] = None) -> float:
        """Host attention over ``layers`` (default: all attention layers)."""
        p = self.platform
        n_layers = self.costs.num_attn_layers if layers is None else layers
        kv_bytes = (batch * max(context, 1.0)
                    * self.costs.kv_bytes_per_pos_layer * n_layers)
        return kv_bytes / p.host_bw + p.kernel_overhead

    def n_g(self, context: float) -> float:
        """Device attention rate: KV positions scanned per second."""
        return self.platform.device_bw / max(self.costs.kv_bytes_per_pos, 1)

    def n_c(self, context: float) -> float:
        """Host attention rate: KV positions scanned per second."""
        return self.platform.host_bw / max(self.costs.kv_bytes_per_pos, 1)

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


def analytic_model(platform: str, cfg: ModelConfig) -> AnalyticPerfModel:
    if platform not in PLATFORMS:
        raise ValueError(f"unknown platform {platform!r}; "
                         f"have {sorted(PLATFORMS)}")
    return AnalyticPerfModel(PLATFORMS[platform], ModelCosts.from_config(cfg))


def resolve_perf_model(spec: str, cfg: ModelConfig, *,
                       platform: str = "h100") -> AnalyticPerfModel:
    """``"analytic"`` (for ``platform``) or ``"analytic:<platform>"``."""
    spec = (spec or "analytic").strip()
    if spec == "analytic":
        return analytic_model(platform, cfg)
    if spec.startswith("analytic:"):
        return analytic_model(spec.split(":", 1)[1], cfg)
    raise ValueError(f"unknown perf-model spec {spec!r}; the port has "
                     "'analytic' and 'analytic:<platform>'")


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
        # delegate everything else (t_linear, t_prefill, ...)
        return getattr(self.base, name)
