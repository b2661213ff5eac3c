"""Logical-axis sharding rules (MaxText-style) for DP / FSDP / TP / SP / EP
on a ``torch.distributed`` ``DeviceMesh``.

Model code annotates tensors with *logical* axis names
(``constrain(x, "batch", None, "heads", None)``).  The launch layer
activates a mesh and a rule set; the rules map logical names onto mesh
axes.  Outside an active context, or on a plain tensor, every annotation
is a no-op, so model code runs unchanged on one device.

Port of ``repro/distributed/sharding.py``.  torch has no
``PartitionSpec``: ``PartitionSpec`` here is a tuple of ``None``, axis
names or tuples of axis names, with the reference's equality (a
singleton tuple is its bare name), and ``to_placements`` turns one into
DTensor placements.  Parameter trees are walked in ``core.tree``'s leaf
order, which is ``jax.tree_util``'s.
"""
from __future__ import annotations

import contextlib
import sys
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.core.tree import (tree_flatten, tree_flatten_with_path,
                                   tree_map_with_path)

MeshAxes = Union[None, str, Tuple[str, ...]]
Rules = Dict[str, MeshAxes]

# Default production rules for the (pod, data, model) mesh.
# "fsdp" is the parameter ZeRO-3 dim; "batch" the activation DP dim.
DEFAULT_RULES: Rules = {
    "batch": ("pod", "data"),
    "seq": None,
    "seq_sp": "model",            # sequence-parallel residual stream (opt-in)
    "kv_seq": None,               # sharded for long-context decode (opt-in)
    "d_model": None,
    "heads": "model",
    "kv_heads": "model",
    "ffn": "model",
    "experts": "model",
    "expert_capacity": None,
    "vocab": "model",
    "stack": None,                # leading layer-stack dim of stacked params
    "fsdp": ("pod", "data"),
    "mamba_inner": "model",
    "state": None,
    "replicated": None,
}

# Single-pod rules only differ in which axes exist; names stay the same.
SINGLE_POD_RULES: Rules = dict(DEFAULT_RULES, batch=("data",), fsdp=("data",))

# Serving rules: expert weights TP-sharded on the FFN dim (expert-TP)
# instead of EP, so the dropless decode gather needs no collectives.
SERVE_RULES: Rules = dict(DEFAULT_RULES, experts=None)
SERVE_SINGLE_POD_RULES: Rules = dict(SINGLE_POD_RULES, experts=None)


class PartitionSpec(tuple):
    """Per tensor dim: ``None`` (replicated), a mesh axis name, or a tuple
    of axis names (the dim split over their product, in that order).  A
    singleton tuple is stored as its bare name, so specs compare as the
    reference's do; a spec shorter than the tensor replicates the rest."""

    def __new__(cls, *parts: MeshAxes) -> "PartitionSpec":
        norm = []
        for p in parts:
            if isinstance(p, (tuple, list)):
                p = tuple(p)
                if len(p) == 1:
                    p = p[0]
            norm.append(p)
        return super().__new__(cls, norm)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class _Context(threading.local):
    def __init__(self) -> None:
        self.mesh = None
        self.rules: Rules = {}


_CTX = _Context()


def is_dtensor(x: Any) -> bool:
    """Whether ``x`` is a DTensor (without importing DTensor where nothing
    has: no tensor can be one then)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def as_dtensor(x: torch.Tensor, mesh) -> Any:
    """``x`` itself if a DTensor, else a plain tensor as one replicated
    over ``mesh`` (what ``implicit_replication`` takes it for)."""
    if is_dtensor(x):
        return x
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def split_last(x: torch.Tensor, *sizes: int) -> torch.Tensor:
    """``x`` with its last dim split into ``sizes`` (heads, head_dim).  A
    DTensor whose last dim is sharded over more ranks than divide
    ``sizes[0]`` (8 kv heads over a 16-way model axis) is first
    replicated over those mesh dims: DTensor cannot split one mesh dim
    across two tensor dims, as XLA's tiled shardings can."""
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate, Shard
        last = x.dim() - 1
        split = [m for m, p in enumerate(x.placements)
                 if isinstance(p, Shard) and p.dim == last]
        ways = 1
        for m in split:
            ways *= x.device_mesh.size(m)
        if sizes[0] % ways:
            x = x.redistribute(x.device_mesh, [
                Replicate() if m in split else p
                for m, p in enumerate(x.placements)])
    return x.reshape(*x.shape[:-1], *sizes)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, T, H, hd) -> (B, T, H * hd), ``split_last``'s inverse for a
    tensor whose heads are whole on every rank (as the xLSTM recurrences
    emit them): a DTensor is reshaped shard by shard, so its gradient
    comes back to the heads' placements whatever the later products
    leave it in (DTensor cannot split a dim sharded 16 ways into 4
    heads)."""
    if not is_dtensor(x):
        return x.reshape(*x.shape[:2], -1)
    from torch.distributed.tensor import DTensor
    local = x.to_local()
    shape = (*x.shape[:2], x.shape[2] * x.shape[3])
    return DTensor.from_local(local.reshape(*local.shape[:2], -1),
                              x.device_mesh, x.placements, run_check=False,
                              shape=shape,
                              stride=(shape[1] * shape[2], shape[2], 1))


def pointwise(fn, x: Any) -> Any:
    """``fn`` (elementwise) of ``x``; on a DTensor it runs on the local
    shard (pending sums completed first), for the ops DTensor has no
    sharding rule for (``log_sigmoid``'s backward).  The placements are
    kept."""
    if not is_dtensor(x):
        return fn(x)
    from torch.distributed.tensor import DTensor, Partial, Replicate
    if any(isinstance(p, Partial) for p in x.placements):
        x = x.redistribute(x.device_mesh, [
            Replicate() if isinstance(p, Partial) else p
            for p in x.placements])
    return DTensor.from_local(fn(x.to_local()), x.device_mesh, x.placements,
                              run_check=False, shape=x.shape,
                              stride=x.stride())


def lookup_rows(table: Any, idx: Any) -> Any:
    """``table[idx]`` for a DTensor table (V, d) and ids (...) -> (..., d),
    vocab-parallel (Megatron's embedding): the table's rows stay
    split as they are (the vocab over "model"), its columns are gathered
    (FSDP's gather before use); each rank looks up the ids in its own
    rows (zero for the others) and the rows come out as a partial sum
    over the vocab's mesh dims, placed as the ids are on the others.
    DTensor's own strategies for an index op do not all take ids split
    over two mesh dims, as (pod, data) splits the batch."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh = table.device_mesh
    rows = [isinstance(p, Shard) and p.dim == 0 for p in table.placements]
    tpl = [p if r else Replicate() for p, r in zip(table.placements, rows)]
    local = table.redistribute(mesh, tpl).to_local()
    _, offset = compute_local_shape_and_global_offset(table.shape, mesh, tpl)
    idx = as_dtensor(idx, mesh)
    ipl = [Replicate() if r else p for p, r in zip(idx.placements, rows)]
    ids = idx.redistribute(mesh, ipl).to_local().long() - offset[0]
    hit = (ids >= 0) & (ids < local.shape[0])
    out = torch.where(hit[..., None], local[ids.clamp(0, local.shape[0] - 1)],
                      torch.zeros((), dtype=local.dtype, device=local.device))
    shape = torch.Size(tuple(idx.shape) + (table.shape[1],))
    return DTensor.from_local(
        out, mesh, [Partial() if r else p for p, r in zip(ipl, rows)],
        run_check=False, shape=shape,
        stride=torch.empty(shape, device="meta").stride())


def mesh_shape(mesh) -> Dict[str, int]:
    """Axis name -> size of a ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


@contextlib.contextmanager
def use_sharding(mesh, rules: Optional[Rules] = None):
    """Activate a mesh + logical rules for model-code annotations."""
    if rules is None:
        rules = rules_for_mesh(mesh)
    prev = (_CTX.mesh, _CTX.rules)
    _CTX.mesh, _CTX.rules = mesh, dict(rules)
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules = prev


def rules_for_mesh(mesh, mode: str = "train") -> Rules:
    """Pick the rule set matching the mesh's axis names and mode
    ("train" = EP experts; "serve" = expert-TP for dropless decode)."""
    names = set(mesh.mesh_dim_names)
    if mode == "serve":
        base = SERVE_RULES if "pod" in names else SERVE_SINGLE_POD_RULES
    else:
        base = DEFAULT_RULES if "pod" in names else SINGLE_POD_RULES
    return {logical: _filter_axes(axes, names)
            for logical, axes in base.items()}


def _filter_axes(axes: MeshAxes, available: set) -> MeshAxes:
    if axes is None:
        return None
    if isinstance(axes, str):
        return axes if axes in available else None
    kept = tuple(a for a in axes if a in available)
    return kept if kept else None


def active_mesh():
    return _CTX.mesh


def resolve(*logical: Optional[str]) -> PartitionSpec:
    """Map logical axis names to a PartitionSpec under the active rules."""
    rules = _CTX.rules
    parts: List[MeshAxes] = []
    used: set = set()
    for name in logical:
        if name is None:
            parts.append(None)
            continue
        axes = rules.get(name)
        # A mesh axis may appear at most once in a PartitionSpec.
        if axes is None:
            parts.append(None)
        elif isinstance(axes, str):
            parts.append(axes if axes not in used else None)
            used.add(axes)
        else:
            fresh = tuple(a for a in axes if a not in used)
            used.update(fresh)
            parts.append(fresh[0] if len(fresh) == 1
                         else (fresh if fresh else None))
    return PartitionSpec(*parts)


def fit_spec(mesh, spec: PartitionSpec, shape) -> PartitionSpec:
    """Drop mesh axes that do not divide the corresponding dim (small
    vocabularies, few KV heads, xLSTM gate widths...)."""
    sizes = mesh_shape(mesh)
    parts: List[MeshAxes] = []
    for i, axes in enumerate(tuple(spec) + (None,) * (len(shape) - len(spec))):
        if axes is None:
            parts.append(None)
            continue
        axes_t = (axes,) if isinstance(axes, str) else tuple(axes)
        kept = []
        size = 1
        for a in axes_t:
            if shape[i] % (size * sizes[a]) == 0:
                kept.append(a)
                size *= sizes[a]
        parts.append(tuple(kept) if len(kept) > 1
                     else (kept[0] if kept else None))
    return PartitionSpec(*parts)


def to_placements(mesh, spec: PartitionSpec, ndim: int) -> Tuple[Any, ...]:
    """DTensor placements of ``spec`` on ``mesh``: per mesh dim,
    ``Shard(i)`` where the spec puts that axis on tensor dim i, else
    ``Replicate()``.  A dim split over several axes is split in mesh-dim
    order (DTensor's only order); a spec that lists them in another
    order is refused."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    if len(spec) > ndim:
        raise ValueError(f"{spec} has more entries than {ndim} dims")
    out: List[Any] = [Replicate()] * len(names)
    for i, axes in enumerate(spec):
        if axes is None:
            continue
        axes_t = (axes,) if isinstance(axes, str) else tuple(axes)
        dims = [names.index(a) for a in axes_t]
        if dims != sorted(dims):
            raise ValueError(f"{spec}: dim {i} is split over {axes_t}, "
                             f"against the mesh's axis order {tuple(names)}"
                             "; DTensor cannot express that order")
        for m in dims:
            if not isinstance(out[m], Replicate):
                raise ValueError(f"{spec}: mesh axis {names[m]!r} twice")
            out[m] = Shard(i)
    return tuple(out)


def shard_shape(mesh, spec: PartitionSpec, shape) -> Tuple[int, ...]:
    """The local shape of one rank's shard (every split divides)."""
    sizes = mesh_shape(mesh)
    out = list(shape)
    for i, axes in enumerate(spec):
        if axes is None:
            continue
        for a in ((axes,) if isinstance(axes, str) else axes):
            out[i] //= sizes[a]
    return tuple(out)


def constrain(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """Redistribute a DTensor to the placements of the logical names
    under the active rules; a no-op without a mesh or on a plain
    tensor."""
    mesh = _CTX.mesh
    if mesh is None or not is_dtensor(x):
        return x
    spec = fit_spec(mesh, resolve(*logical), x.shape)
    placements = to_placements(mesh, spec, x.dim())
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(mesh, placements)


def named(mesh, *logical: Optional[str], rules: Optional[Rules] = None
          ) -> PartitionSpec:
    """The PartitionSpec of logical names without an active context (the
    reference's ``NamedSharding``: the mesh travels beside it)."""
    rules = rules if rules is not None else rules_for_mesh(mesh)
    prev = (_CTX.mesh, _CTX.rules)
    _CTX.mesh, _CTX.rules = mesh, dict(rules)
    try:
        return resolve(*logical)
    finally:
        _CTX.mesh, _CTX.rules = prev


# ---------------------------------------------------------------------------
# Parameter sharding: leaf-name -> logical axes, by convention.
# Stacked params get a leading "stack" dim prepended.
# ---------------------------------------------------------------------------

# (logical axes per dim, from the LAST dims backwards). Matching is on the
# leaf key name; ``ndim`` beyond the listed dims is padded with "stack".
_PARAM_LOGICAL: Dict[str, Tuple[Optional[str], ...]] = {
    # attention
    "wq": ("fsdp", "heads"),
    "wk": ("fsdp", "kv_heads"),
    "wv": ("fsdp", "kv_heads"),
    "wo": ("heads", "fsdp"),
    # dense FFN
    "w_gate": ("fsdp", "ffn"),
    "w_up": ("fsdp", "ffn"),
    "w_down": ("ffn", "fsdp"),
    # MoE (leading experts dim listed explicitly).  Under the default
    # rules "experts" wins the "model" axis and "ffn" resolves to None
    # (EP); under SERVE_RULES "experts" is unsharded and "ffn" takes
    # "model" (expert-TP) so the dropless decode gather is local.
    "we_gate": ("experts", "fsdp", "ffn"),
    "we_up": ("experts", "fsdp", "ffn"),
    "we_down": ("experts", "ffn", "fsdp"),
    "ws_gate": ("fsdp", "ffn"),
    "ws_up": ("fsdp", "ffn"),
    "ws_down": ("ffn", "fsdp"),
    "router": ("fsdp", None),
    # embeddings
    "embed": ("vocab", "fsdp"),
    "unembed": ("fsdp", "vocab"),
    # norms / scalars
    "scale": (None,),
    "bias": (None,),
    # mamba
    "in_proj": ("fsdp", "mamba_inner"),
    "conv_w": ("mamba_inner", None),
    "conv_b": ("mamba_inner",),
    "x_proj": ("mamba_inner", None),
    "dt_proj": (None, "mamba_inner"),
    "dt_bias": ("mamba_inner",),
    "a_log": ("mamba_inner", None),
    "d_skip": ("mamba_inner",),
    "out_proj": ("mamba_inner", "fsdp"),
    # xLSTM
    "w_gates": ("fsdp", "mamba_inner"),
    "w_qkv": ("fsdp", "mamba_inner"),
    "w_io": ("fsdp", "mamba_inner"),
    "up_proj": ("fsdp", "mamba_inner"),
    "down_proj": ("mamba_inner", "fsdp"),
}


def logical_for_leaf(path: Sequence[Any], leaf) -> Tuple[Optional[str], ...]:
    """Logical axes for one param leaf, inferred from its key name + rank.

    ``path`` holds the leaf's keys from the root (``core.tree``'s key
    paths: dict keys and NamedTuple field names are strings).  Optimizer
    state trees reuse the param leaf names, so AdamW moments inherit the
    param sharding (ZeRO).  Adafactor's factored moments drop dims from
    the *right* ('vr' drops the last, 'vc' the second-to-last) --
    detected from the field name in the path.
    """
    name = None
    field_names = []
    for key in reversed(tuple(path)):
        if isinstance(key, str):
            field_names.append(key)
            if name is None and key in _PARAM_LOGICAL:
                name = key
    logical = list(_PARAM_LOGICAL.get(name, ()))
    if "vr" in field_names and logical:
        logical = logical[:-1]                       # rows: last dim dropped
    elif "vc" in field_names and len(logical) >= 2:
        logical = logical[:-2] + logical[-1:]        # cols: dim -2 dropped
    ndim = len(leaf.shape)
    if len(logical) > ndim:
        logical = logical[len(logical) - ndim:]
    # leading dims (layer-stack) are unsharded
    return ("stack",) * (ndim - len(logical)) + tuple(logical)


def param_specs(params) -> Any:
    """PartitionSpec tree for a parameter tree under the active rules."""
    return tree_map_with_path(
        lambda path, leaf: resolve(*logical_for_leaf(path, leaf)), params)


def fitted_param_specs(mesh, params, rules: Optional[Rules] = None) -> Any:
    """The fitted PartitionSpec tree of a parameter (or meta) tree: the
    reference's ``param_shardings`` without the mesh (the specs are
    leaves of the tree returned)."""
    rules = rules if rules is not None else rules_for_mesh(mesh)
    prev = (_CTX.mesh, _CTX.rules)
    _CTX.mesh, _CTX.rules = mesh, dict(rules)
    try:
        return tree_map_with_path(
            lambda path, leaf: fit_spec(
                mesh, resolve(*logical_for_leaf(path, leaf)), leaf.shape),
            params)
    finally:
        _CTX.mesh, _CTX.rules = prev


def param_shardings(mesh, params, rules: Optional[Rules] = None) -> Any:
    """The DTensor placements of every leaf of a parameter (or meta) tree
    on ``mesh``, as a tree of ``params``' structure.  Placements are
    tuples, so walk this tree beside ``params``' leaves
    (``core.tree.tree_flatten(params)``), not on its own."""
    with_path, treedef = tree_flatten_with_path(
        fitted_param_specs(mesh, params, rules))
    leaves = tree_flatten(params)[0]
    return treedef.unflatten([to_placements(mesh, spec, len(leaf.shape))
                              for (_, spec), leaf in zip(with_path, leaves)])
