"""Assigned input-shape grid + meta input specs for the dry-run.

Every (architecture x shape) cell resolves here to:
  * which step function to trace (train_step / prefill / decode_step,
    the latter in gpu_only and APEX async_overlap flavors),
  * ``meta``-device stand-ins for every input (no allocation),
  * PartitionSpec trees for the inputs under the production rules.

Skip rules (recorded): encoder-only archs have no decode shapes;
``long_500k`` needs sub-quadratic decode (SSM/hybrid only); the APEX
offload variant needs a KV cache and a splittable batch.

Port of ``repro/launch/shapes.py``: the reference's ``ShapeDtypeStruct``
is a tensor on the ``meta`` device here, its ``NamedSharding`` a
``sharding.PartitionSpec`` beside the mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.distributed.sharding import PartitionSpec as P
from repro_torch.distributed.sharding import mesh_shape
from repro_torch.core.tree import tree_map_with_path
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.models.kv_cache import StackState
from repro_torch.models.transformer import HostIO

META = torch.device("meta")


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str            # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}

# APEX offload fraction for the async_overlap decode variant
HOST_FRACTION = 0.25


def applicability(cfg: ModelConfig, shape: ShapeSpec) -> Optional[str]:
    """None if the cell runs; else the skip reason (recorded in tables)."""
    if cfg.is_encoder_only and shape.kind == "decode":
        return "encoder-only: no autoregressive decode"
    if shape.name == "long_500k" and not cfg.supports_long_context_decode:
        return "full quadratic attention: no sub-quadratic long-context path"
    return None


def overlap_applicable(cfg: ModelConfig, shape: ShapeSpec) -> Optional[str]:
    """Whether the APEX async_overlap variant exists for this cell."""
    base = applicability(cfg, shape)
    if base:
        return base
    if shape.kind != "decode":
        return "offload targets decode"
    if not cfg.has_kv_cache:
        return "no KV cache to offload (recurrent decode)"
    if int(shape.global_batch * HOST_FRACTION) < 1:
        return "batch too small to split a host cohort"
    return None


def _maybe(axes, dim: int, mesh):
    """Axes only if they divide the dim; else replicate."""
    if axes is None:
        return None
    axes_t = (axes,) if isinstance(axes, str) else tuple(axes)
    sizes = mesh_shape(mesh)
    size = 1
    for a in axes_t:
        size *= sizes[a]
    return axes if dim % size == 0 and size > 1 else None


def _batch_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


# ---------------------------------------------------------------------------
# Input specs
# ---------------------------------------------------------------------------


def train_batch_specs(cfg: ModelConfig, shape: ShapeSpec, mesh):
    """(meta batch dict, spec dict)."""
    b, t = shape.global_batch, shape.seq_len
    batch_ax = _batch_axes(mesh)
    dt = getattr(torch, cfg.compute_dtype)
    if cfg.frontend == "audio":
        meta = {"embeds": _meta((b, t, cfg.d_model), dt),
                "labels": _meta((b, t), torch.int32)}
        spec = {"embeds": P(batch_ax, None, None),
                "labels": P(batch_ax, None)}
    elif cfg.frontend == "vision":
        p = cfg.frontend_tokens
        meta = {"patches": _meta((b, p, cfg.d_model), dt),
                "tokens": _meta((b, t - p), torch.int32),
                "labels": _meta((b, t), torch.int32)}
        spec = {"patches": P(batch_ax, None, None),
                "tokens": P(batch_ax, None),
                "labels": P(batch_ax, None)}
    else:
        meta = {"tokens": _meta((b, t), torch.int32),
                "labels": _meta((b, t), torch.int32)}
        spec = {k: P(batch_ax, None) for k in meta}
    return meta, spec


def prefill_input_specs(cfg: ModelConfig, shape: ShapeSpec, mesh):
    b, t = shape.global_batch, shape.seq_len
    batch_ax = _batch_axes(mesh)
    dt = getattr(torch, cfg.compute_dtype)
    if cfg.frontend == "audio":
        meta = {"embeds": _meta((b, t, cfg.d_model), dt)}
        spec = {"embeds": P(batch_ax, None, None)}
    elif cfg.frontend == "vision":
        p = cfg.frontend_tokens
        meta = {"patches": _meta((b, p, cfg.d_model), dt),
                "tokens": _meta((b, t - p), torch.int32)}
        spec = {"patches": P(batch_ax, None, None),
                "tokens": P(batch_ax, None)}
    else:
        meta = {"tokens": _meta((b, t), torch.int32)}
        spec = {"tokens": P(batch_ax, None)}
    return meta, spec


def abstract_state(cfg: ModelConfig, *, device_batch: int, host_batch: int,
                   cache_len: int) -> StackState:
    """The zero decode state's tensors on the ``meta`` device."""
    return transformer.state_init(cfg, device_batch=device_batch,
                                  host_batch=host_batch, cache_len=cache_len,
                                  device=META)


def state_specs(cfg: ModelConfig, state: StackState, mesh,
                *, long_context: bool, for_prefill: bool = False):
    """PartitionSpec tree for the decode/prefill state.

    KV caches: batch over (pod, data); kv_heads over model when they
    divide.  Otherwise *decode* takes the model axis on the kv-seq dim
    (flash-decoding split), while *prefill* takes it on head_dim.
    long_context (batch=1) shards kv-seq over everything.
    """
    batch_ax = _batch_axes(mesh)
    model = "model" if "model" in mesh.mesh_dim_names else None
    sizes = mesh_shape(mesh)

    def spec_for(path, leaf):
        name = None
        for key in reversed(path):
            if isinstance(key, str):
                name = key
                break
        nd = len(leaf.shape)
        if name in ("k", "v") and nd == 5:       # (G, B, S, KV, D)
            _, b, s, kv, hd = leaf.shape
            if long_context:
                seq_ax = _maybe(("data", "model") if "pod" not in
                                mesh.mesh_dim_names
                                else ("pod", "data", "model"), s, mesh)
                return P(None, None, seq_ax, None, None)
            bax = _maybe(batch_ax, b, mesh)
            if model and kv % sizes[model] == 0:
                return P(None, bax, None, model, None)
            if for_prefill:
                d_ax = _maybe(model, hd, mesh)
                return P(None, bax, None, None, d_ax)
            seq_ax = _maybe(model, s, mesh)
            return P(None, bax, seq_ax, None, None)
        if name == "conv" and nd == 4:            # (G, B, K-1, I)
            _, b, _, inner = leaf.shape
            return P(None, _maybe(batch_ax, b, mesh), None,
                     _maybe(model, inner, mesh))
        if name == "ssm" and nd == 4:             # (G, B, I, N)
            _, b, inner, _ = leaf.shape
            return P(None, _maybe(batch_ax, b, mesh),
                     _maybe(model, inner, mesh), None)
        if name == "lengths":
            return P(_maybe(batch_ax, leaf.shape[0], mesh))
        # xLSTM states & anything else: batch-shard when possible
        if nd >= 2:
            bax = _maybe(batch_ax, leaf.shape[1], mesh)
            return P(*([None, bax] + [None] * (nd - 2)))
        return P()

    return tree_map_with_path(spec_for, state)


def host_io_layers(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    """(consume_layer, emit_layer, window_start, window_end) of the traced
    overlap step: the reference's are traced values, the port's host
    ints, so the step is traced at one window -- host rows consume at
    the first attention layer, emit at the next (the first again on a
    one-attention stack) and commit across the whole stack, so every
    layer runs its host-row select."""
    attn = cfg.attn_layer_indices
    if not attn:                  # no KV cache: nothing to offload
        return -1, -1, 0, cfg.num_layers
    emit = attn[1] if len(attn) > 1 else attn[0]
    return attn[0], emit, 0, cfg.num_layers


def host_io_specs(cfg: ModelConfig, host_batch: int, mesh):
    """(meta HostIO, spec HostIO); the layer fields are host ints, their
    spec ``P()``."""
    d = cfg.d_model
    h, hd = cfg.num_heads, cfg.resolved_head_dim
    bax = _maybe(_batch_axes(mesh), host_batch, mesh)
    model = "model" if "model" in mesh.mesh_dim_names else None
    hax = _maybe(model, h, mesh)
    dt = getattr(torch, cfg.compute_dtype)
    consume, emit, start, end = host_io_layers(cfg)
    meta = HostIO(
        x_carry=_meta((host_batch, d), dt),
        positions=_meta((host_batch,), torch.int32),
        attn_in=_meta((host_batch, h, hd), torch.float32),
        consume_layer=consume, emit_layer=emit, window_start=start,
        window_end=end,
        row_valid=_meta((host_batch,), torch.bool))
    spec = HostIO(
        x_carry=P(bax, None), positions=P(bax), attn_in=P(bax, hax, None),
        consume_layer=P(), emit_layer=P(), window_start=P(), window_end=P(),
        row_valid=P(bax))
    return meta, spec


def decode_token_specs(cfg: ModelConfig, device_batch: int, mesh):
    bax = _maybe(_batch_axes(mesh), device_batch, mesh)
    return _meta((device_batch,), torch.int32), P(bax)
