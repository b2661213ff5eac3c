"""Asynchronous Overlap runtime (paper §3.3 + §4.2).

  * ``OverlapController`` -- the deferred-synchronization state machine.
    A *cohort* of host-offloaded requests advances one attention layer
    per engine iteration: it consumes the host-computed attention for
    layer k (produced during the previous iteration), commits the
    layers in [k, next_attn(k)), and emits fresh Q/K/V at next_attn(k).
    A token completes every (num_attn_layers + 1) iterations.
  * ``HostExecutor`` -- the parallel host attention runtime: a
    dispatcher thread plus a worker pool whose numpy/BLAS kernels
    release the GIL.  It owns the paged host KV pool, copies each job's
    device Q/K/V to pinned host buffers *inside* the worker (after a
    CUDA event the engine recorded right after the producing step, on a
    copy stream of its own, so the engine thread never waits), appends
    the emitted K/V with one vectorized write, shards the cohort's rows
    across workers, and buffers results for the next iteration.
"""
from __future__ import annotations

import dataclasses
import os
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels.host_paged_attention import \
    host_paged_attention_numpy
from repro_torch.models.config import BlockKind, ModelConfig
from repro_torch.models.kv_cache import PagedKVPool
from repro_torch.models.transformer import HostIO


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> tensor on ``device`` without a hidden sync: a CUDA
    upload goes through pinned memory with ``non_blocking`` (the pinned
    allocator keeps the staging block until the copy has run)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


@dataclasses.dataclass
class Cohort:
    """A set of host-offloaded requests progressing in lockstep.

    Rows are stable host slots: slot i occupies unified-batch row
    device_slots + i; membership changes only at token boundaries
    (attn_ptr == -1); empty slots carry rid -1 and row_valid False.
    """

    slot_rids: List[int]             # (Bc,) request id per slot, -1 = empty
    positions: np.ndarray            # (Bc,) position of the token in flight
    x_carry: torch.Tensor            # (Bc, d) residual carry (device)
    attn_in: torch.Tensor            # (Bc, H, D) fp32 host result (device)
    attn_ptr: int = -1               # index into attn_layers; -1 = token start

    @property
    def valid_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slot_rids) if r >= 0]

    @property
    def request_ids(self) -> List[int]:
        return [r for r in self.slot_rids if r >= 0]

    def row_valid(self) -> np.ndarray:
        return np.asarray([r >= 0 for r in self.slot_rids], bool)


class OverlapController:
    """Computes per-iteration HostIO windows and advances cohorts."""

    def __init__(self, cfg: ModelConfig) -> None:
        self.cfg = cfg
        self.attn_layers: Tuple[int, ...] = cfg.attn_layer_indices
        if not self.attn_layers:
            raise ValueError(
                f"{cfg.name}: no attention layers — APEX offload inapplicable")
        self.num_layers = cfg.num_layers

    @property
    def iterations_per_token(self) -> int:
        return len(self.attn_layers) + 1

    def host_io(self, cohort: Cohort) -> HostIO:
        a = self.attn_layers
        if cohort.attn_ptr < 0:
            consume, ws, we = -1, 0, a[0]
        else:
            consume = ws = a[cohort.attn_ptr]
            we = (a[cohort.attn_ptr + 1]
                  if cohort.attn_ptr + 1 < len(a) else self.num_layers)
        device = cohort.x_carry.device
        return HostIO(
            x_carry=cohort.x_carry,
            positions=to_device(cohort.positions.astype(np.int32), device),
            attn_in=cohort.attn_in, consume_layer=consume,
            emit_layer=self.emit_layer(cohort), window_start=ws,
            window_end=we,
            row_valid=to_device(cohort.row_valid(), device))

    def emit_layer(self, cohort: Cohort) -> int:
        """Absolute layer whose QKV this iteration emits (-1 = none)."""
        a = self.attn_layers
        if cohort.attn_ptr < 0:
            return a[0]
        if cohort.attn_ptr + 1 < len(a):
            return a[cohort.attn_ptr + 1]
        return -1

    def completes_token(self, cohort: Cohort) -> bool:
        """True if this iteration commits the final layer window."""
        return cohort.attn_ptr == len(self.attn_layers) - 1

    def advance(self, cohort: Cohort) -> None:
        cohort.attn_ptr = (-1 if self.completes_token(cohort)
                           else cohort.attn_ptr + 1)

    def layer_progress(self, cohort: Cohort) -> int:
        """Layers completed for the in-flight token (scheduler rule 4)."""
        if cohort.attn_ptr < 0:
            return 0
        a = self.attn_layers
        return (a[cohort.attn_ptr + 1]
                if cohort.attn_ptr + 1 < len(a) else self.num_layers)

    def build_cohort(self, emb: torch.Tensor, slot_rids: List[int],
                     last_tokens: Sequence[int],
                     positions: Sequence[int]) -> Optional[Cohort]:
        """A fresh token-boundary cohort from per-slot membership
        (``slot_rids[i] = -1`` marks an empty slot); None if all empty."""
        if all(r < 0 for r in slot_rids):
            return None
        valid = to_device(np.asarray([r >= 0 for r in slot_rids], bool),
                          emb.device)
        toks = to_device(np.asarray(last_tokens, np.int64), emb.device)
        x_carry = torch.where(valid[:, None], emb[toks],
                              torch.zeros((), dtype=emb.dtype,
                                          device=emb.device))
        return Cohort(
            slot_rids=list(slot_rids),
            positions=np.asarray(positions, np.int64), x_carry=x_carry,
            attn_in=torch.zeros((len(slot_rids), self.cfg.num_heads,
                                 self.cfg.resolved_head_dim),
                                dtype=torch.float32, device=emb.device))


@dataclasses.dataclass
class _Job:
    job_id: int
    layer: int                       # absolute layer index of the QKV
    request_ids: List[int]
    q: Any                           # (Bc, H, D) tensor (any device) or numpy;
    k: Any                           # (Bc, KV, D)  the device->host copy
    v: Any                           #              happens in the worker
    positions: np.ndarray            # (n,) token positions of valid rows
    rows: Optional[np.ndarray]       # (n,) valid row indices into q/k/v
    ready: Optional[Any] = None      # CUDA event recorded after q/k/v exist


def stack_row_kv_to_pool_layers(cfg: ModelConfig, state: Any, row: int,
                                plen: int) -> List[tuple]:
    """Host (numpy fp32) copies of one state row's attention KV span
    ``[0, plen)`` as the per-attention-layer [(k, v), ...] list
    ``HostExecutor.migrate_prompt`` takes, in absolute attention-layer
    order.  A blocking device->host copy: it runs at admission."""
    ordered: List[Any] = [None] * cfg.num_attn_layers
    for j, kind in enumerate(cfg.block_pattern):
        if kind != BlockKind.ATTN:
            continue
        k = state.per_entry[j].k[:, row, :plen].float().cpu().numpy()
        v = state.per_entry[j].v[:, row, :plen].float().cpu().numpy()
        for g in range(cfg.num_groups):
            abs_layer = g * cfg.pattern_period + j
            ordered[cfg.attn_layer_indices.index(abs_layer)] = (k[g], v[g])
    return ordered


class HostExecutor:
    """Parallel host-attention runtime owning the paged KV pool.

    ``submit`` is non-blocking and accepts device tensors: the worker
    waits on the job's CUDA event, copies Q/K/V into pinned host buffers
    on its own stream, and computes -- overlapped with the engine's next
    device dispatch.  ``result`` blocks only if the host is genuinely
    the straggler.  Busy time is split into ``transfer_time`` (device ->
    host copy) and ``compute_time`` (KV append + paged attention).
    """

    def __init__(self, cfg: ModelConfig, pool: PagedKVPool,
                 *, workers: int = 0) -> None:
        self.cfg = cfg
        self.pool = pool
        self.page_size = pool.page_size
        if workers <= 0:     # leave a core for the device dispatch thread
            workers = max(1, (os.cpu_count() or 2) - 1)
        self.workers = workers
        self._shards: Optional[ThreadPoolExecutor] = (
            ThreadPoolExecutor(max_workers=workers,
                               thread_name_prefix="host-attn")
            if workers > 1 else None)
        self._results: Dict[int, Any] = {}
        self._lock = threading.Lock()
        self._done = threading.Condition(self._lock)
        self._queue: "queue.Queue[Optional[_Job]]" = queue.Queue()
        self._free_bufs: Dict[tuple, List[np.ndarray]] = {}
        self._pinned: Dict[tuple, List[torch.Tensor]] = {}
        self._copy_stream: Optional[Any] = None
        self._transfer_time = 0.0
        self._compute_time = 0.0
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="host-dispatch")
        self._worker.start()

    def _pool_layer(self, abs_layer: int) -> int:
        """The host pool indexes attention layers densely (0..n_attn-1)."""
        return self.cfg.attn_layer_indices.index(abs_layer)

    # --- API -----------------------------------------------------------------
    def submit(self, job_id: int, layer: int, request_ids: Sequence[int],
               q, k, v, positions, *, rows=None, ready=None) -> None:
        """Enqueue one layer's host attention for a cohort.  q/k/v may be
        device tensors covering the whole cohort (the job keeps them
        alive); ``rows`` selects the valid slots; ``ready`` is a CUDA
        event recorded after the step that produced them."""
        job = _Job(job_id, layer, list(request_ids), q, k, v,
                   np.asarray(positions),
                   None if rows is None else np.asarray(rows, np.int64),
                   ready)
        self._queue.put(job)

    @staticmethod
    def _unwrap(job_id: int, out):
        # a failed job publishes its exception as its result so the
        # engine fails loudly at the next poll
        if isinstance(out, BaseException):
            raise RuntimeError(f"host job {job_id} failed") from out
        return out

    def result(self, job_id: int, timeout: Optional[float] = None
               ) -> np.ndarray:
        with self._done:
            while job_id not in self._results:
                if not self._done.wait(timeout):
                    raise TimeoutError(f"host job {job_id} not ready")
            return self._unwrap(job_id, self._results.pop(job_id))

    def poll(self, job_id: int) -> Optional[np.ndarray]:
        """Non-blocking readiness check (the paper's GPU re-check)."""
        with self._lock:
            return self._unwrap(job_id, self._results.pop(job_id, None))

    def recycle(self, buf: np.ndarray) -> None:
        """Return a consumed result buffer for reuse by later jobs."""
        with self._lock:
            self._free_bufs.setdefault(buf.shape, []).append(buf)

    def migrate_prompt(self, request_id: int, per_layer_kv) -> None:
        """Move a prefilled request's KV (list over attention layers of
        (T, KV, D) arrays) into its reserved pool chains."""
        t = per_layer_kv[0][0].shape[0]
        if request_id not in self.pool.lengths:
            self.pool.allocate(request_id, t)
        n_layers = len(per_layer_kv)
        for li, (k, v) in enumerate(per_layer_kv):
            self.pool.write_prompt(request_id, li, k, v,
                                   advance=(li == n_layers - 1))

    def free(self, request_id: int) -> None:
        self.pool.free(request_id)

    def shutdown(self) -> None:
        self._queue.put(None)
        self._worker.join(timeout=5)
        if self._shards is not None:
            self._shards.shutdown(wait=False)

    @property
    def busy_time(self) -> float:
        return self._transfer_time + self._compute_time

    @property
    def transfer_time(self) -> float:
        """Seconds spent copying device QKV to the host."""
        return self._transfer_time

    @property
    def compute_time(self) -> float:
        """Seconds of host attention work (append + paged attention)."""
        return self._compute_time

    # --- worker ----------------------------------------------------------------
    def _run(self) -> None:
        while True:
            job = self._queue.get()
            if job is None:
                return
            try:
                self._execute(job)
            except BaseException as e:          # noqa: BLE001 — surfaced
                with self._done:
                    self._results[job.job_id] = e
                    self._done.notify_all()

    def _out_buffer(self, shape: tuple) -> np.ndarray:
        with self._lock:
            free = self._free_bufs.get(shape)
            if free:
                return free.pop()
        return np.empty(shape, np.float32)

    def _to_host(self, jobs_tensors: Sequence[Any], ready) -> List[np.ndarray]:
        """fp32 numpy views of the job's Q/K/V.  CUDA tensors: wait on the
        producing step's event on a private stream, copy into pinned
        buffers, and wait for that copy only."""
        if not any(isinstance(t, torch.Tensor) and t.is_cuda
                   for t in jobs_tensors):
            return [t if isinstance(t, np.ndarray)
                    else t.detach().float().numpy() for t in jobs_tensors]
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(jobs_tensors[0].device)
        stream = self._copy_stream
        bufs = []
        with torch.cuda.stream(stream):
            if ready is not None:
                stream.wait_event(ready)
            for t in jobs_tensors:
                free = self._pinned.setdefault(tuple(t.shape), [])
                buf = free.pop() if free else torch.empty(
                    t.shape, dtype=torch.float32, pin_memory=True)
                buf.copy_(t, non_blocking=True)
                bufs.append(buf)
        stream.synchronize()
        return bufs

    def _execute(self, job: _Job) -> None:
        t0 = time.perf_counter()
        staged = self._to_host((job.q, job.k, job.v), job.ready)
        q, k, v = (b.numpy() if isinstance(b, torch.Tensor) else b
                   for b in staged)
        if job.rows is not None:
            q, k, v = q[job.rows], k[job.rows], v[job.rows]
        job.q = job.k = job.v = None  # release the device tensors
        t1 = time.perf_counter()
        li = self._pool_layer(job.layer)
        n = len(job.request_ids)
        # the fresh token's K/V for this layer, one vectorized write (the
        # length advances only once the token's final layer is written)
        self.pool.append_rows(job.request_ids, li, job.positions, k, v)
        chains = [self.pool.page_tables[(rid, li)] for rid in job.request_ids]
        pt = np.zeros((n, max(len(c) for c in chains)), np.int32)
        for i, c in enumerate(chains):
            pt[i, :len(c)] = c
        lengths = job.positions.astype(np.int32) + 1
        out = self._out_buffer(q.shape)
        if self._shards is None or n < 2:
            host_paged_attention_numpy(q, self.pool.pages, pt, lengths,
                                       page_size=self.page_size, out=out)
        else:
            bounds = np.linspace(0, n, min(self.workers, n) + 1).astype(int)
            futs = [
                self._shards.submit(
                    host_paged_attention_numpy, q[a:b], self.pool.pages,
                    pt[a:b], lengths[a:b], page_size=self.page_size,
                    out=out[a:b])
                for a, b in zip(bounds[:-1], bounds[1:]) if b > a]
            for f in futs:
                f.result()
        for b in staged:              # pinned staging buffers are reusable
            if isinstance(b, torch.Tensor):
                self._pinned[tuple(b.shape)].append(b)
        t2 = time.perf_counter()
        with self._done:
            self._results[job.job_id] = out
            self._transfer_time += t1 - t0
            self._compute_time += t2 - t1
            self._done.notify_all()

    def advance_token(self, request_ids: Sequence[int]) -> None:
        """Bump pool lengths after a cohort completes a token."""
        for rid in request_ids:
            self.pool.lengths[rid] += 1
