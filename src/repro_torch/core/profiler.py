"""Offline profiler (paper §3.1): times the ops the scheduler predicts --
device linear time against tokens (Fig. 1a), device against host
attention against KV positions (Fig. 1b), prefill cost, and the copy
between the tiers -- and emits a ``TablePerfModel``.

It times the port's own serving path: decode and prefill attention
through ``kernels.ops`` (the hand-written CUDA kernels on the card, at the
dtypes the model's steps pass them), one attention layer's projections
and MLP, the numpy host tier the executor runs, and the pinned upload and
device->host copy the engine uses.  Device ops are timed with CUDA events
after a warm-up; the host tier by wall clock.  With ``device="cpu"`` the
same code times the plain versions.

Port of ``repro/core/profiler.py``: the same tables, grid and scaling by
depth (one layer measured, multiplied by the stack's layers or attention
layers), and the int8 host pool's ``catt`` table measured on int8 pages
through the fused-dequant path.  Like the reference, it takes one
layer's weights from pattern entry 0 and prices its FFN as a dense MLP,
so a stack whose entry 0 has an MoE FFN cannot be profiled (the
reference fails there with ``KeyError: 'w_gate'``); the port says so.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.overlap_engine import to_device
from repro_torch.core.perf_model import (ModelCosts, TablePerfModel,
                                         host_kv_el_bytes, model_fingerprint)
from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import \
    check_geometry as decode_geometry
from repro_torch.kernels.prefill_attention import \
    check_geometry as prefill_geometry
from repro_torch.kernels.host_paged_attention import \
    host_paged_attention_numpy
from repro_torch.models.config import BlockKind, FFNKind, ModelConfig
from repro_torch.models.layers import mlp, qkv_project, rope_frequencies
from repro_torch.models.transformer import layer_params, stack_init

Table = List[Tuple[float, float]]


class OfflineProfiler:
    """Profiles one model config on ``device`` and the host's numpy tier."""

    def __init__(self, cfg: ModelConfig, seed: int = 0,
                 device: str = "cuda", host_kv_dtype: str = "fp32") -> None:
        if cfg.ffn_kind_for_entry(0) == FFNKind.MOE:
            raise NotImplementedError(
                f"{cfg.name}: OfflineProfiler prices one layer's FFN as a "
                "dense MLP, and this stack's first entry has an MoE FFN "
                "(the reference's profiler fails there too, with KeyError "
                "'w_gate'; ROADMAP queue 3); serve it with --perf-model "
                "analytic or file:<path>")
        self.cfg = cfg
        self.device = torch.device(device)
        if self.device.type == "cuda":
            self._check_kernel_geometry()
        self.host_kv_dtype = host_kv_dtype
        self.costs = ModelCosts.from_config(
            cfg, host_kv_bytes_per_el=host_kv_el_bytes(host_kv_dtype))
        self.dtype = getattr(torch, cfg.compute_dtype)
        # one attention layer's weights are enough: scaled by depth below
        one = dataclasses.replace(cfg, block_pattern=(BlockKind.ATTN,),
                                  num_layers=1)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.layer_params = layer_params(stack_init(one, gen, self.device),
                                         0, 0)
        self.inv_freq = rope_frequencies(cfg.resolved_head_dim,
                                         cfg.rope_theta, self.device)

    def _check_kernel_geometry(self) -> None:
        """Both attention kernels must take the config's head geometry.
        A stack without attention (xLSTM) is priced, as in the reference,
        with one attention layer of its head geometry (``ModelCosts``
        counts at least one), which need not be one the kernels are built
        for: xlstm-125m's head_dim is 192."""
        cfg = self.cfg
        for check in (decode_geometry, prefill_geometry):
            try:
                check(cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim)
            except ValueError as e:
                raise NotImplementedError(
                    f"{cfg.name}: OfflineProfiler times one attention layer "
                    f"of {cfg.num_heads}/{cfg.num_kv_heads} heads of "
                    f"{cfg.resolved_head_dim} on the card, and the kernels "
                    f"do not take it ({e}; the stack has "
                    f"{cfg.num_attn_layers} attention layers; ROADMAP queue "
                    "3); serve it with --perf-model analytic") from None

    # --- timing ----------------------------------------------------------
    def _time(self, fn: Callable[[], object], *, warmup: int = 2,
              iters: int = 5) -> float:
        """Seconds per call of ``fn`` on the profiler's device: CUDA events
        around ``iters`` calls after ``warmup`` on the card, the host clock
        on the CPU."""
        for _ in range(warmup):
            fn()
        if self.device.type != "cuda":
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            return (time.perf_counter() - t0) / iters
        torch.cuda.synchronize(self.device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / iters

    # --- ops under test ----------------------------------------------------
    def _linear_ops(self, x: torch.Tensor, positions: torch.Tensor):
        cfg = self.cfg
        q, k, v = qkv_project(self.layer_params["attn"], x, cfg.num_heads,
                              cfg.num_kv_heads, cfg.resolved_head_dim,
                              positions, self.inv_freq)
        # an xLSTM config's attention layer has no FFN (FFNKind.NONE), as
        # in the reference's one-layer build
        f = mlp(self.layer_params["ffn"], x) if "ffn" in self.layer_params \
            else x
        return q, k, v, f

    def profile_linear(self, token_counts: Sequence[int]) -> Table:
        """Fig. 1a: one layer's linear ops against token count, scaled to
        the full stack."""
        cfg = self.cfg
        out = []
        for n in token_counts:
            x = torch.ones((n, 1, cfg.d_model), dtype=self.dtype,
                           device=self.device)
            pos = torch.zeros((n, 1), dtype=torch.int32, device=self.device)
            t = self._time(lambda: self._linear_ops(x, pos))
            out.append((float(n), t * cfg.num_layers))
        return out

    def profile_gatt(self, kv_positions: Sequence[int], context: int = 1024
                     ) -> Table:
        """Device decode attention against total KV positions (batch x
        context), scaled to all attention layers.  Totals below
        ``context`` measure one short row, the regime small serving
        batches visit."""
        cfg = self.cfg
        hd = cfg.resolved_head_dim
        out = []
        for total in kv_positions:
            ctx = min(context, total)
            batch = max(1, total // ctx)
            q = torch.ones((batch, cfg.num_heads, hd), dtype=self.dtype,
                           device=self.device)
            k = torch.ones((batch, ctx, cfg.num_kv_heads, hd),
                           dtype=torch.bfloat16, device=self.device)
            lengths = torch.full((batch,), ctx, dtype=torch.int32,
                                 device=self.device)
            t = self._time(lambda: ops.decode_attention(q, k, k, lengths))
            out.append((float(batch * ctx),
                        t * self.costs.num_attn_layers))
        return out

    def profile_catt(self, kv_positions: Sequence[int], context: int = 1024,
                     page_size: int = 64) -> Table:
        """Host paged attention against KV positions (one layer, on the
        calling thread), scaled to all attention layers -- at the pool's
        stored dtype (int8 pages and the fused-dequant path when the host
        tier is quantized)."""
        cfg = self.cfg
        hd = cfg.resolved_head_dim
        quant = self.host_kv_dtype == "int8"
        out = []
        for total in kv_positions:
            ctx = min(context, total)
            batch = max(1, total // ctx)
            pages_per = -(-ctx // page_size)
            npages = batch * pages_per
            pages = np.ones((2, npages, page_size, cfg.num_kv_heads, hd),
                            np.int8 if quant else np.float32)
            scales = (np.ones((2, npages, page_size), np.float32)
                      if quant else None)
            pt = np.arange(npages, dtype=np.int32).reshape(batch, pages_per)
            lengths = np.full((batch,), ctx, np.int32)
            q = np.ones((batch, cfg.num_heads, hd), np.float32)
            iters = 3
            t0 = time.perf_counter()
            for _ in range(iters):
                host_paged_attention_numpy(q, pages, pt, lengths,
                                           page_size=page_size,
                                           scales=scales)
            t = (time.perf_counter() - t0) / iters
            out.append((float(batch * ctx),
                        t * self.costs.num_attn_layers))
        return out

    def profile_prefill(self, token_counts: Sequence[int],
                        linear_table: Table) -> Table:
        """Prefill cost against tokens: the linear table plus causal
        prefill attention (one layer measured, over a bf16 K/V span as the
        cache holds it), scaled to all attention layers."""
        cfg = self.cfg
        hd = cfg.resolved_head_dim
        lin = dict(linear_table)
        out = []
        for n in token_counts:
            q = torch.ones((1, n, cfg.num_heads, hd), dtype=self.dtype,
                           device=self.device)
            k = torch.ones((1, n, cfg.num_kv_heads, hd),
                           dtype=torch.bfloat16, device=self.device)
            t = self._time(lambda: ops.prefill_attention(q, k, k))
            out.append((float(n),
                        lin[float(n)] + t * self.costs.num_attn_layers))
        return out

    def profile_transfer(self, sizes: Sequence[int]) -> Table:
        """Round trip of ``n`` bytes between the tiers by wall clock: the
        engine's pinned upload and the executor's copy back into a pinned
        buffer."""
        out = []
        for n in sizes:
            a = np.ones((n // 4,), np.float32)
            back = torch.empty((n // 4,), dtype=torch.float32,
                               pin_memory=self.device.type == "cuda")

            def round_trip():
                back.copy_(to_device(a, self.device), non_blocking=True)
                if self.device.type == "cuda":
                    torch.cuda.current_stream(self.device).synchronize()
                return back.numpy()

            round_trip()
            iters = 5
            t0 = time.perf_counter()
            for _ in range(iters):
                round_trip()
            out.append((float(n), (time.perf_counter() - t0) / iters))
        return out

    # --- entry point ---------------------------------------------------------
    def run(self, *, token_counts=(1, 8, 32, 128, 256),
            kv_positions=(1024, 8192, 32768, 131072),
            transfer_sizes=(1 << 16, 1 << 20, 1 << 24)) -> TablePerfModel:
        tables: Dict[str, Table] = {
            "linear": self.profile_linear(token_counts),
            "gatt": self.profile_gatt(kv_positions),
            "catt": self.profile_catt(kv_positions),
            "transfer": self.profile_transfer(transfer_sizes),
        }
        tables["prefill"] = self.profile_prefill(token_counts,
                                                 tables["linear"])
        return TablePerfModel(tables,
                              kv_bytes_per_pos=self.costs.kv_bytes_per_pos,
                              num_attn_layers=self.costs.num_attn_layers,
                              state_bytes_per_row=self.costs
                              .state_bytes_per_row,
                              host_kv_bytes_per_pos=self.costs
                              .host_kv_bytes_per_pos,
                              fingerprint=model_fingerprint(
                                  self.cfg, self.host_kv_dtype),
                              profile_grid=dict(
                                  token_counts=list(token_counts),
                                  kv_positions=list(kv_positions),
                                  transfer_sizes=list(transfer_sizes)))
