"""Multi-pod dry-run: prove the distribution config is coherent.

For every (architecture x shape) cell and both production meshes
(16x16 single-pod, 2x16x16 multi-pod) this traces the real step function
of the port on the ``meta`` device: parameters, state and inputs are
DTensors whose local shards hold no memory, placed by the logical-axis
rules (``distributed.sharding``) on a mesh over a fake process group
(``launch.mesh``), and every cell runs under ``implicit_replication``
(the model's own plain tensors -- positions, RoPE tables, masks -- take
part as replicated).  It records the traced step's memory on rank 0, its
flops and its collectives (``launch.analysis``) into the reference's
JSON schema.

Port of ``repro/launch/dryrun.py``.  What the records hold differs where
the programs differ:
  * ``memory``: ``argument_bytes`` sums the local shards of the inputs;
    ``output_bytes`` and ``alias_bytes`` those of the outputs and of the
    outputs that are donated inputs updated in place; ``temp_bytes`` is
    the peak of the bytes the step allocated on rank 0, less those still
    live at its end (a dispatch-mode tracker, ``_RankOps``).
  * ``cost_analysis.flops``: rank 0's matrix-product flops at its local
    shapes (``torch.utils.flop_counter``'s formulas), plus the hand
    kernels' (which dispatch no aten op) from their local shapes with the
    formulas behind PERF.md's bounds: per device, as XLA's.
  * ``collectives``: the functional collectives DTensor and the
    optimizer issue (``analysis.CollectiveCounter``), not an HLO walk.
  * ``trace_s`` takes the place of ``lower_s`` / ``compile_s``.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.1-8b \\
        --shape decode_32k [--multi-pod] [--variant overlap]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
import weakref
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import get_config, list_archs
from repro_torch.core.tree import tree_flatten
from repro_torch.distributed import sharding
from repro_torch.kernels import ops
from repro_torch.launch import analysis, shapes
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import abstract_params, decode_step, prefill
from repro_torch.models import forward_train
from repro_torch.models.config import ModelConfig
from repro_torch.training import (TrainConfig, init_train_state,
                                  make_optimizer, make_train_step)

# beside the reference's ``results/dryrun``, never in it
RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")

# Giant archs get factored optimizer state (AdamW bf16 moments would
# exceed one pod's memory).
ADAFACTOR_THRESHOLD = 6e11

NOTES = ("port dry-run: a traced step on the meta device over a fake "
         "process group; memory is rank 0's local shards (temp_bytes from "
         "a dispatch-mode live-bytes tracker), flops are rank 0's (its "
         "local matrix products plus the hand kernels' shape formulas at "
         "their local shapes), collectives are the functional collectives "
         "DTensor and the optimizer issue")


# ---------------------------------------------------------------------------
# Placing meta tensors on the mesh
# ---------------------------------------------------------------------------


def to_dtensor(mesh, leaf: Any, spec) -> Any:
    """A meta DTensor of ``leaf``'s global shape and dtype placed by
    ``spec`` (a tensor's local shard on ``meta``); a non-tensor leaf (a
    host int, the optimizer's host step) stays as it is."""
    if not isinstance(leaf, torch.Tensor) or leaf.device.type != "meta":
        return leaf
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    placements = sharding.to_placements(mesh, spec, leaf.dim())
    local_shape, _ = compute_local_shape_and_global_offset(
        leaf.shape, mesh, placements)
    local = torch.empty(local_shape, dtype=leaf.dtype, device="meta")
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=leaf.shape, stride=leaf.stride())


def place(mesh, tree: Any, specs: Any) -> Any:
    """``tree``'s meta leaves as DTensors, each by the spec at its place
    in ``specs`` (a tree of the same structure)."""
    leaves, treedef = tree_flatten(tree)
    spec_leaves = tree_flatten(specs)[0]
    if len(spec_leaves) != len(leaves):
        raise ValueError(f"{len(leaves)} leaves, {len(spec_leaves)} specs")
    return treedef.unflatten([to_dtensor(mesh, x, s)
                              for x, s in zip(leaves, spec_leaves)])


def local_bytes(x: Any) -> int:
    """Bytes of one rank's shard of a tensor (of the tensor itself when
    plain); 0 for a non-tensor."""
    if not isinstance(x, torch.Tensor):
        return 0
    if sharding.is_dtensor(x):
        x = x.to_local()
    return x.numel() * x.element_size()


def spec_bytes(mesh, tree: Any, specs: Any) -> int:
    """Bytes of rank 0's shards of ``tree``'s tensors under ``specs``,
    from the shapes alone (what the chip phase and the tests hold
    ``argument_bytes`` to)."""
    total = 0
    for leaf, spec in zip(tree_flatten(tree)[0], tree_flatten(specs)[0]):
        if isinstance(leaf, torch.Tensor):
            n = 1
            for d in sharding.shard_shape(mesh, spec, leaf.shape):
                n *= d
            total += n * leaf.element_size()
    return total


# ---------------------------------------------------------------------------
# Measuring a traced step
# ---------------------------------------------------------------------------


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class _RankOps(TorchDispatchMode):
    """What the ops under it do on this rank: the bytes of the storages
    they create, live and at their peak, and the flops of the matrix
    products among them (``torch.utils.flop_counter``'s formulas at the
    local shapes).  DTensor ops pass through to DTensor, whose local ops
    come back here; a storage counts until it dies (its Python object
    lives as long as the storage does).  The
    fake tensors of DTensor's sharding propagation (global shapes, never
    allocated or computed) are not counted."""

    def __init__(self) -> None:
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flop_fns = flop_registry
        self.live = 0
        self.peak = 0
        self.flops = 0
        self._sizes: Dict[int, int] = {}

    def _release(self, key: int) -> None:
        self.live -= self._sizes.pop(key)

    def _track(self, out: Any, known: set) -> None:
        if isinstance(out, (list, tuple)):
            for o in out:
                self._track(o, known)
            return
        if not isinstance(out, torch.Tensor):
            return
        key = _storage_key(out)
        if key in known or key in self._sizes:   # a view, an in-place op
            return
        storage = out.untyped_storage()   # one object while it lives
        self._sizes[key] = storage.nbytes()
        self.live += self._sizes[key]
        self.peak = max(self.peak, self.live)
        weakref.finalize(storage, self._release, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        known = {_storage_key(a) for a in tree_flatten((args, kwargs))[0]
                 if isinstance(a, torch.Tensor)}
        out = func(*args, **kwargs)
        first = out[0] if isinstance(out, (list, tuple)) and out else out
        if isinstance(first, FakeTensor):       # DTensor's shape analysis
            return out
        self._track(out, known)
        count = self._flop_fns.get(func._overloadpacket)
        if count is not None:
            self.flops += count(*args, **kwargs, out_val=out)
        return out


def _measure(fn, inputs: Tuple[Any, ...]) -> dict:
    """Trace ``fn()`` once with its flops, collectives and memory taken."""
    from torch.distributed.tensor.experimental import implicit_replication
    in_leaves = [x for x in tree_flatten(inputs)[0]
                 if isinstance(x, torch.Tensor)]
    in_keys = {_storage_key(x.to_local() if sharding.is_dtensor(x) else x)
               for x in in_leaves}
    colls = analysis.CollectiveCounter()
    rank = _RankOps()
    t0 = time.perf_counter()
    with ops.record_meta_calls() as calls, implicit_replication(), colls, \
            rank:
        out = fn()
        end_live = rank.live
    trace_s = time.perf_counter() - t0
    out_bytes = alias = 0
    seen = set()
    for x in tree_flatten(out)[0]:
        if not isinstance(x, torch.Tensor):
            continue
        local = x.to_local() if sharding.is_dtensor(x) else x
        key = _storage_key(local)
        if key in seen:
            continue
        seen.add(key)
        nb = local.numel() * local.element_size()
        out_bytes += nb
        if key in in_keys:
            alias += nb
    arg = sum(local_bytes(x) for x in in_leaves)
    temp = max(rank.peak - end_live, 0)
    kflops, kbytes = analysis.kernel_costs(calls)
    stats = colls.stats()
    return {
        "trace_s": round(trace_s, 2),
        "memory": {
            "argument_bytes": arg, "output_bytes": out_bytes,
            "temp_bytes": temp, "alias_bytes": alias,
            "total_per_device": arg + temp + out_bytes - alias,
        },
        "cost_analysis": {
            "flops": float(rank.flops + kflops),
            "kernel_flops": float(kflops),
            "kernel_bytes": float(kbytes),
            "kernel_calls": _count_calls(calls),
            "scope": "per device (rank 0's local shapes)",
        },
        "collectives": {
            "bytes_by_kind": stats.bytes_by_kind,
            "count_by_kind": stats.count_by_kind,
            "total_bytes": stats.total_bytes,
            "unscaled_bytes": stats.unscaled_bytes,
        },
    }


def _count_calls(calls) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for name, _ in calls:
        out[name] = out.get(name, 0) + 1
    return out


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------


def dryrun_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
                variant: str = "baseline", options: Optional[dict] = None,
                mesh=None, cfg: Optional[ModelConfig] = None,
                shape: Optional[shapes.ShapeSpec] = None) -> dict:
    """Trace one cell.  variant: baseline | overlap.

    ``options`` are the reference's perf-iteration knobs:
      loss_chunk: int      -- fused chunked unembed+CE (train)
      seq_parallel: bool   -- residual-stream sequence parallelism
      host_fraction: float -- APEX offload fraction (overlap variant)
      expert_shard: str    -- "ep" | "tp" expert-weight layout
      weight_stationary: bool -- serve weights TP-only (no ZeRO gathers)

    ``mesh``, ``cfg`` and ``shape`` override the production mesh, the
    registry's config and the shape grid's entry (a cut-down model or a
    (1, 1) mesh for the card's memory check).
    """
    options = dict(options or {})
    cfg = cfg or get_config(arch)
    shape = shape or shapes.SHAPES[shape_name]
    skip = (shapes.overlap_applicable(cfg, shape) if variant == "overlap"
            else shapes.applicability(cfg, shape))
    record = {
        "arch": arch, "shape": shape_name, "variant": variant,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "params": cfg.param_count(), "active_params": cfg.active_param_count(),
    }
    if mesh is not None:
        record["mesh"] = "x".join(str(s) for s in mesh.mesh.shape)
    if skip:
        record["skipped"] = skip
        return record

    mesh = mesh if mesh is not None else make_production_mesh(
        multi_pod=multi_pod)
    chips = mesh.mesh.numel()
    rules = cell_rules(mesh, shape.kind, options)
    params_meta = abstract_params(cfg)
    with sharding.use_sharding(mesh, rules):
        if shape.kind == "train":
            record.update(trace_train(cfg, shape, mesh, params_meta,
                                      options))
        else:
            params = place(mesh, params_meta, sharding.fitted_param_specs(
                mesh, params_meta, rules))
            if shape.kind == "prefill":
                record.update(trace_prefill(cfg, shape, mesh, params))
            else:
                record.update(trace_decode(cfg, shape, mesh, params,
                                           variant, options))

    hf = options.get("host_fraction", shapes.HOST_FRACTION)
    costs = analysis.analytic_costs(
        cfg, shape.kind, seq_len=shape.seq_len,
        global_batch=shape.global_batch,
        host_fraction=hf if variant == "overlap" else 0.0)
    record["options"] = options
    record["analytic"] = {
        "flops_global": costs.flops, "hbm_bytes_global": costs.hbm_bytes,
        "model_flops_global": costs.model_flops, "chips": chips,
        "notes": costs.notes,
    }
    record["notes"] = NOTES
    return record


def cell_rules(mesh, kind: str, options: dict) -> sharding.Rules:
    """The rule set of a cell: train or serve rules, with the options'
    overrides."""
    rules = sharding.rules_for_mesh(mesh, "train" if kind == "train"
                                    else "serve")
    if options.get("seq_parallel"):
        rules = dict(rules, seq="model")
    if options.get("weight_stationary"):
        # keep weights TP-only (no fsdp dim) so decode steps never
        # all-gather parameters
        rules = dict(rules, fsdp=None)
    if options.get("expert_shard") == "tp":
        rules = dict(rules, experts=None)
    elif options.get("expert_shard") == "ep":
        rules = dict(rules, experts="model", ffn=None)
    return rules


def train_setup(cfg: ModelConfig, options: Optional[dict] = None):
    """(optimizer name, TrainConfig, optimizer) of a train cell."""
    options = options or {}
    opt_name = ("adafactor" if cfg.param_count() > ADAFACTOR_THRESHOLD
                else "adamw")
    kwargs = {} if opt_name == "adafactor" else {"moment_dtype": "bfloat16"}
    opt = make_optimizer(opt_name, **kwargs)
    tcfg = TrainConfig(optimizer=opt_name, remat=True,
                       accum_steps=options.get("accum_steps", 1),
                       loss_chunk=options.get("loss_chunk", 0))
    return opt_name, tcfg, opt


def train_inputs(cfg: ModelConfig, shape: shapes.ShapeSpec, mesh,
                 params_meta, options: Optional[dict] = None):
    """((meta train state, meta batch), (state specs, batch specs)): the
    state's specs under the mesh's train rules, as the reference's."""
    _, tcfg, opt = train_setup(cfg, options)
    state = init_train_state(cfg, tcfg, opt, params_meta)
    state_specs = sharding.fitted_param_specs(mesh, state,
                                              sharding.rules_for_mesh(mesh))
    batch, batch_specs = shapes.train_batch_specs(cfg, shape, mesh)
    return (state, batch), (state_specs, batch_specs)


def trace_train(cfg: ModelConfig, shape, mesh, params_meta, options=None
                ) -> dict:
    """The train step (loss, gradients, clip, optimizer update) on the
    sharded meta state.  The router jitter's generator is left out (no
    generator draws on ``meta``)."""
    opt_name, tcfg, opt = train_setup(cfg, options)
    step = make_train_step(cfg, tcfg, opt)
    (state, batch), (sspecs, bspecs) = train_inputs(cfg, shape, mesh,
                                                    params_meta, options)
    state = place(mesh, state, sspecs)
    batch = place(mesh, batch, bspecs)
    out = _measure(lambda: step(state, batch, None), (state, batch))
    out["optimizer"] = opt_name
    return out


def trace_prefill(cfg: ModelConfig, shape, mesh, params) -> dict:
    inputs, ispecs = shapes.prefill_input_specs(cfg, shape, mesh)
    inputs = place(mesh, inputs, ispecs)
    if cfg.is_encoder_only:
        # encoder "prefill" = one full forward (no cache)
        with torch.no_grad():
            return _measure(lambda: forward_train(params, cfg, inputs),
                            (params, inputs))
    state = shapes.abstract_state(cfg, device_batch=shape.global_batch,
                                  host_batch=0, cache_len=shape.seq_len)
    state = place(mesh, state, shapes.state_specs(
        cfg, state, mesh, long_context=False, for_prefill=True))
    with torch.no_grad():
        return _measure(lambda: prefill(params, cfg, inputs, state),
                        (params, inputs, state))


def decode_batches(shape, variant: str, options: Optional[dict] = None
                   ) -> Tuple[int, int]:
    """(device rows, host rows) of a decode cell."""
    if variant != "overlap":
        return shape.global_batch, 0
    hf = (options or {}).get("host_fraction", shapes.HOST_FRACTION)
    host = int(shape.global_batch * hf)
    return shape.global_batch - host, host


def trace_decode(cfg: ModelConfig, shape, mesh, params, variant,
                 options=None) -> dict:
    long_ctx = shape.name == "long_500k"
    device_batch, host_batch = decode_batches(shape, variant, options)
    state = shapes.abstract_state(cfg, device_batch=device_batch,
                                  host_batch=host_batch,
                                  cache_len=shape.seq_len)
    state = place(mesh, state, shapes.state_specs(
        cfg, state, mesh, long_context=long_ctx))
    tok, tspec = shapes.decode_token_specs(cfg, device_batch, mesh)
    tok = to_dtensor(mesh, tok, tspec)
    host = None
    if variant == "overlap":
        host, hspec = shapes.host_io_specs(cfg, host_batch, mesh)
        host = place(mesh, host, hspec)
    with torch.no_grad():
        out = _measure(lambda: decode_step(params, cfg, tok, state, host),
                       (params, tok, state, host))
    out["device_batch"] = device_batch
    out["host_batch"] = host_batch
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(shapes.SHAPES))
    ap.add_argument("--variant", default="baseline",
                    choices=["baseline", "overlap"])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="run every (arch x shape) baseline cell")
    ap.add_argument("--out", default=RESULTS_DIR)
    args = ap.parse_args()

    os.makedirs(args.out, exist_ok=True)
    cells = []
    if args.all:
        for arch in list_archs(assigned_only=True):
            for shape_name in shapes.SHAPES:
                cells.append((arch, shape_name, args.multi_pod, "baseline"))
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required without --all")
        cells.append((args.arch, args.shape, args.multi_pod, args.variant))

    for arch, shape_name, multi_pod, variant in cells:
        tag = f"{arch}__{shape_name}__{'mp' if multi_pod else 'sp'}__{variant}"
        print(f"=== {tag}", flush=True)
        try:
            rec = dryrun_cell(arch, shape_name, multi_pod=multi_pod,
                              variant=variant)
        except Exception as e:  # a failure here is a sharding bug
            rec = {"arch": arch, "shape": shape_name, "variant": variant,
                   "mesh": "2x16x16" if multi_pod else "16x16",
                   "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()}
            print(rec["error"], flush=True)
        path = os.path.join(args.out, tag + ".json")
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        if "memory" in rec:
            mem = rec["memory"]["total_per_device"] / 1e9
            print(f"    traced in {rec['trace_s']}s; {mem:.2f} GB/device; "
                  f"collectives {rec['collectives']['total_bytes']/1e6:.1f}"
                  f" MB", flush=True)


if __name__ == "__main__":
    main()
