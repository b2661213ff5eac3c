"""The port's dry-run family against the reference's, on the CPU.

The shape grid and its skip rules, the analytic costs, the HLO parser,
the logical-axis rules, ``resolve``, ``fit_spec`` and every parameter /
optimizer-state / decode-state / input spec are held to
``repro.launch`` and ``repro.distributed.sharding`` leaf by leaf, at
published width for all twelve archs, on the (16, 16) and (2, 16, 16)
meshes (the reference's side on ``jax.sharding.AbstractMesh``, the
port's on a fake process group).  A few cells are traced end to end;
their ``argument_bytes`` equal the sum over the reference's specs.  The
kernels' meta rules give the plain versions' shapes and dtypes and keep
DTensor placements.  The kernel launch counters lose no increment under
threads.
"""
import dataclasses
import functools
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.distributed import sharding as ref_sharding  # noqa: E402
from repro.launch import analysis as ref_analysis  # noqa: E402
from repro.launch import shapes as ref_shapes  # noqa: E402
from repro.models import abstract_params as ref_abstract_params  # noqa: E402
from repro.training import (TrainConfig as RefTrainConfig,  # noqa: E402
                            init_train_state as ref_init_train_state,
                            make_optimizer as ref_make_optimizer)

from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.core.tree import tree_flatten_with_path  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.launches import counted  # noqa: E402
from repro_torch.launch import analysis, dryrun, mesh, shapes  # noqa: E402
from repro_torch.models import abstract_params  # noqa: E402
from repro_torch.training import init_train_state, make_optimizer  # noqa: E402
from repro_torch.training import TrainConfig  # noqa: E402

ARCHS = list_archs()
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture(autouse=True)
def _no_process_group_left():
    """Other files share this worker (``--dist loadfile``): leave no fake
    process group behind."""
    yield
    mesh.destroy()


def port_mesh(name: str):
    return mesh.make_production_mesh(multi_pod=name == "2x16x16")


def ref_mesh(name: str):
    shape, axes = MESHES[name]
    return AbstractMesh(shape, axes)


def norm(spec) -> tuple:
    """A spec as a tuple of None / axis name / tuple of names, singleton
    tuples as their bare name (the reference's equality)."""
    out = []
    for p in spec:
        if isinstance(p, (tuple, list)):
            p = tuple(p)
            if len(p) == 1:
                p = p[0]
        out.append(p)
    return tuple(out)


def ref_key(entry):
    for attr in ("key", "name", "idx"):
        if hasattr(entry, attr):
            return getattr(entry, attr)
    raise TypeError(entry)


def ref_leaves(tree):
    """[(path tuple, leaf)] of a reference pytree, None leaves dropped as
    the port's trees drop them.  The reference nests the mLSTM cell's
    state under ``cell`` (``MLSTMBlockState(cell, conv)``), the port's
    ``MLSTMState`` is flat with the same leaves in the same order: the
    ``cell`` key is left out."""
    pairs, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(tuple(ref_key(k) for k in path if ref_key(k) != "cell"), leaf)
            for path, leaf in pairs]


def dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


@functools.lru_cache(maxsize=None)
def both_params(arch: str):
    return abstract_params(get_config(arch)), \
        ref_abstract_params(ref_get_config(arch))


# ---------------------------------------------------------------------------
# Shape grid, analytic costs, the HLO parser
# ---------------------------------------------------------------------------


def test_shape_grid_and_skip_rules():
    assert shapes.HOST_FRACTION == ref_shapes.HOST_FRACTION
    assert list(shapes.SHAPES) == list(ref_shapes.SHAPES)
    for name, spec in shapes.SHAPES.items():
        assert dataclasses.asdict(spec) == dataclasses.asdict(
            ref_shapes.SHAPES[name])
    for arch in ARCHS:
        cfg, rcfg = get_config(arch), ref_get_config(arch)
        for name in shapes.SHAPES:
            s, rs = shapes.SHAPES[name], ref_shapes.SHAPES[name]
            assert shapes.applicability(cfg, s) == \
                ref_shapes.applicability(rcfg, rs), (arch, name)
            assert shapes.overlap_applicable(cfg, s) == \
                ref_shapes.overlap_applicable(rcfg, rs), (arch, name)


@pytest.mark.parametrize("arch", ARCHS)
def test_analytic_costs_match_reference(arch):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    for spec in shapes.SHAPES.values():
        for kind in ("train", "prefill", "decode"):
            for hf in (0.0, 0.25):
                kw = dict(seq_len=spec.seq_len,
                          global_batch=spec.global_batch, host_fraction=hf)
                got = analysis.analytic_costs(cfg, kind, **kw)
                want = ref_analysis.analytic_costs(rcfg, kind, **kw)
                assert dataclasses.asdict(got) == dataclasses.asdict(want)


WHILE_HLO = """
HloModule test

%body (p: (s32[], f32[8])) -> (s32[], f32[8]) {
  %p = (s32[], f32[8]) parameter(0)
  %i = s32[] get-tuple-element(%p), index=0
  %x = f32[8] get-tuple-element(%p), index=1
  %ar = f32[8]{0} all-reduce(%x), replica_groups={}, to_apply=%add
  %one = s32[] constant(1)
  %i2 = s32[] add(%i, %one)
  ROOT %t = (s32[], f32[8]) tuple(%i2, %ar)
}

%cond (p: (s32[], f32[8])) -> pred[] {
  %p = (s32[], f32[8]) parameter(0)
  %i = s32[] get-tuple-element(%p), index=0
  %n = s32[] constant(7)
  ROOT %lt = pred[] compare(%i, %n), direction=LT
}

ENTRY %main (a: f32[8]) -> f32[8] {
  %a = f32[8] parameter(0)
  %ar0 = f32[8]{0} all-reduce(%a), replica_groups={}, to_apply=%add
  %init = (s32[], f32[8]) tuple(%c0, %ar0)
  %w = (s32[], f32[8]) while(%init), condition=%cond, body=%body
  ROOT %out = f32[8] get-tuple-element(%w), index=1
}
"""

ASYNC_HLO = """
HloModule async

ENTRY %main (a: bf16[4,16]) -> bf16[64,16] {
  %a = bf16[4,16]{1,0} parameter(0)
  %ags = (bf16[4,16], bf16[64,16]) all-gather-start(%a), dimensions={0}
  %agd = bf16[64,16]{1,0} all-gather-done(%ags)
  %rs = f32[2,16]{1,0} reduce-scatter(%a), dimensions={0}
  %cp = bf16[4,16]{1,0} collective-permute(%a), source_target_pairs={{0,1}}
  ROOT %r = bf16[64,16]{1,0} copy(%agd)
}
"""


@pytest.mark.parametrize("hlo", [WHILE_HLO, ASYNC_HLO, "no entry here"],
                         ids=["while", "async", "empty"])
def test_hlo_parser_matches_reference(hlo):
    got = analysis.collective_bytes_from_hlo(hlo)
    want = ref_analysis.collective_bytes_from_hlo(hlo)
    assert got.bytes_by_kind == want.bytes_by_kind
    assert got.count_by_kind == want.count_by_kind
    assert got.unscaled_bytes == want.unscaled_bytes
    assert got.total_bytes == want.total_bytes
    for t in ("f32[8,4]", "bf16[2,3,4]", "(f32[2], s32[4])", "pred[]",
              "(bf16[4,16], bf16[64,16])", "token[]"):
        assert analysis._shape_bytes(t) == ref_analysis._shape_bytes(t)


# ---------------------------------------------------------------------------
# Rules, resolve, fit_spec, placements
# ---------------------------------------------------------------------------

LOGICALS = [("batch", "seq", None), ("batch", None, "heads", None),
            ("experts", "fsdp", "ffn"), ("fsdp", "vocab"),
            ("vocab", "fsdp"), ("batch", "vocab"), ("stack", "fsdp", "heads"),
            ("batch", "batch"), ("heads", "kv_heads"), ("mamba_inner",),
            ("seq_sp", "model_missing"), ()]


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_rules_resolve_fit_spec_match_reference(mesh_name):
    for table in ("DEFAULT_RULES", "SINGLE_POD_RULES", "SERVE_RULES",
                  "SERVE_SINGLE_POD_RULES"):
        assert getattr(sharding, table) == getattr(ref_sharding, table)
    assert sharding._PARAM_LOGICAL == ref_sharding._PARAM_LOGICAL
    pm, rm = port_mesh(mesh_name), ref_mesh(mesh_name)
    shapes_ = [(256, 4096, 128), (8, 1024), (50304, 768), (6, 10, 12),
               (1, 2, 3)]
    for mode in ("train", "serve"):
        rules = sharding.rules_for_mesh(pm, mode)
        assert rules == ref_sharding.rules_for_mesh(rm, mode)
        with sharding.use_sharding(pm, rules), \
                ref_sharding.use_sharding(rm, rules):
            assert sharding.active_mesh() is pm
            for logical in LOGICALS:
                got = sharding.resolve(*logical)
                want = ref_sharding.resolve(*logical)
                assert norm(got) == norm(want), logical
                for shape in shapes_:
                    if len(shape) < len(logical):
                        continue
                    assert norm(sharding.fit_spec(pm, got, shape)) == norm(
                        ref_sharding.fit_spec(rm, want, shape)), \
                        (logical, shape)
        for logical in LOGICALS:
            assert norm(sharding.named(pm, *logical, rules=rules)) == norm(
                ref_sharding.named(rm, *logical, rules=rules).spec)
    assert sharding.active_mesh() is None


def test_partition_spec_equality_and_placements():
    from torch.distributed.tensor import Replicate, Shard
    P = sharding.PartitionSpec
    assert P(("data",), None) == P("data", None)
    assert P("data") != P("data", None)
    assert P() != P(None)
    pm = port_mesh("2x16x16")
    assert sharding.to_placements(pm, P(("pod", "data"), None, "model"), 3) \
        == (Shard(0), Shard(0), Shard(2))
    assert sharding.to_placements(pm, P(None, "data"), 3) == \
        (Replicate(), Shard(1), Replicate())
    # DTensor splits a dim over several axes in mesh-dim order only
    with pytest.raises(ValueError, match="mesh's axis order"):
        sharding.to_placements(pm, P(("data", "pod")), 1)
    with pytest.raises(ValueError, match="twice"):
        sharding.to_placements(pm, P("data", "data"), 2)


def test_constrain_is_a_noop_without_a_mesh_or_on_a_plain_tensor():
    x = torch.arange(12.0).reshape(3, 4)
    assert sharding.constrain(x, "batch", None) is x
    pm = port_mesh("16x16")
    with sharding.use_sharding(pm):
        assert sharding.constrain(x, "batch", None) is x


def test_constrain_redistributes_a_dtensor_to_the_fitted_placements():
    from torch.distributed.tensor import Replicate, Shard
    pm = port_mesh("16x16")
    meta = torch.empty((32, 48, 64), dtype=torch.bfloat16, device="meta")
    x = dryrun.to_dtensor(pm, meta, sharding.PartitionSpec())
    with sharding.use_sharding(pm, sharding.rules_for_mesh(pm, "serve")):
        y = sharding.constrain(x, "batch", None, "heads")
        assert tuple(y.placements) == (Shard(0), Shard(2))
        z = sharding.constrain(x[:, :, :8], "batch", None, "heads")
        # 8 heads do not divide 16: fit_spec drops "model"
        assert tuple(z.placements) == (Shard(0), Replicate())
        assert y.to_local().shape == (2, 48, 4)


# ---------------------------------------------------------------------------
# Parameters and their specs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_match_reference(arch):
    params, rparams = both_params(arch)
    got, _ = tree_flatten_with_path(params)
    want = ref_leaves(rparams)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, leaf), (_, rleaf) in zip(got, want):
        assert leaf.device.type == "meta", path
        assert tuple(leaf.shape) == tuple(rleaf.shape), path
        assert dtype_name(leaf.dtype) == str(rleaf.dtype), path


def check_specs(pm, rm, tree, rtree, specs, rspecs) -> None:
    """Leaf by leaf: the paths, the specs and the local shard shapes."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    leaves, _ = tree_flatten_with_path(tree)
    spec_leaves = [s for _, s in tree_flatten_with_path(specs)[0]]
    rl = ref_leaves(rtree)
    rs = [s for _, s in ref_leaves(rspecs)]
    rs = [s.spec if hasattr(s, "spec") else s for s in rs]
    tensors = [(p, x) for p, x in leaves]
    assert [p for p, _ in tensors] == [p for p, _ in rl]
    assert len(spec_leaves) == len(rs) == len(rl)
    for (path, leaf), spec, (_, rleaf), rspec in zip(tensors, spec_leaves,
                                                     rl, rs):
        assert norm(spec) == norm(rspec), path
        if not isinstance(leaf, torch.Tensor):
            continue
        placements = sharding.to_placements(pm, spec, leaf.dim())
        local, _ = compute_local_shape_and_global_offset(
            leaf.shape, pm, placements)
        want = ref_sharding.NamedSharding(rm, rspec).shard_shape(
            tuple(rleaf.shape))
        assert tuple(local) == tuple(want), path
        assert tuple(local) == sharding.shard_shape(pm, spec, leaf.shape)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_optimizer_specs_match_reference(arch, mesh_name):
    pm, rm = port_mesh(mesh_name), ref_mesh(mesh_name)
    params, rparams = both_params(arch)
    for mode in ("train", "serve"):
        rules = sharding.rules_for_mesh(pm, mode)
        specs = sharding.fitted_param_specs(pm, params, rules)
        rspecs = ref_sharding.param_shardings(rm, rparams, rules)
        check_specs(pm, rm, params, rparams, specs, rspecs)
    placements = sharding.param_shardings(pm, params)
    first = tree_flatten_with_path(params)[0][0][1]
    assert placements.embedding["embed"] == sharding.to_placements(
        pm, sharding.fitted_param_specs(pm, params).embedding["embed"],
        first.dim())
    # the train state: AdamW moments and Adafactor's vr / vc
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    for name, kw in (("adamw", {"moment_dtype": "bfloat16"}),
                     ("adafactor", {})):
        state = init_train_state(cfg, TrainConfig(optimizer=name),
                                 make_optimizer(name, **kw), params)
        ropt = ref_make_optimizer(name, **kw)
        rstate = jax.eval_shape(
            lambda p: ref_init_train_state(
                rcfg, RefTrainConfig(optimizer=name), ropt, p), rparams)
        specs = sharding.fitted_param_specs(pm, state)
        rspecs = ref_sharding.param_shardings(rm, rstate)
        check_specs(pm, rm, state, rstate, specs, rspecs)


# ---------------------------------------------------------------------------
# Decode / prefill state and the inputs
# ---------------------------------------------------------------------------


def state_cases():
    """(shape name, device rows, host rows, long_context, for_prefill)."""
    return [("decode_32k", 128, 0, False, False),
            ("decode_32k", 96, 32, False, False),
            ("long_500k", 1, 0, True, False),
            ("prefill_32k", 32, 0, False, True)]


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_state_and_input_specs_match_reference(arch, mesh_name):
    pm, rm = port_mesh(mesh_name), ref_mesh(mesh_name)
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    for name, dev, host, long_ctx, pre in state_cases():
        spec = shapes.SHAPES[name]
        st = shapes.abstract_state(cfg, device_batch=dev, host_batch=host,
                                   cache_len=spec.seq_len)
        rst = ref_shapes.abstract_state(rcfg, device_batch=dev,
                                        host_batch=host,
                                        cache_len=spec.seq_len)
        check_specs(pm, rm, st, rst,
                    shapes.state_specs(cfg, st, pm, long_context=long_ctx,
                                       for_prefill=pre),
                    ref_shapes.state_specs(rcfg, rst, rm,
                                           long_context=long_ctx,
                                           for_prefill=pre))
        tok, tspec = shapes.decode_token_specs(cfg, dev, pm)
        rtok, rtspec = ref_shapes.decode_token_specs(rcfg, dev, rm)
        check_specs(pm, rm, [tok], [rtok], [tspec], [rtspec])
        if host:
            hio, hspec = shapes.host_io_specs(cfg, host, pm)
            rhio, rhspec = ref_shapes.host_io_specs(rcfg, host, rm)
            check_specs(pm, rm, hio, rhio, hspec, rhspec)
    # the inputs of the cells that take them (as the reference's dry-run)
    for name, port_fn, ref_fn in (
            ("train_4k", shapes.train_batch_specs,
             ref_shapes.train_batch_specs),
            ("prefill_32k", shapes.prefill_input_specs,
             ref_shapes.prefill_input_specs)):
        meta, specs = port_fn(cfg, shapes.SHAPES[name], pm)
        rmeta, rspecs = ref_fn(rcfg, ref_shapes.SHAPES[name], rm)
        check_specs(pm, rm, meta, rmeta, specs, rspecs)
        for k in meta:
            assert dtype_name(meta[k].dtype) == str(rmeta[k].dtype)


# ---------------------------------------------------------------------------
# Traced cells
# ---------------------------------------------------------------------------


def ref_spec_bytes(rm, rtree, rspecs, skip=()) -> int:
    """Rank 0's bytes of the reference's inputs under its specs (the
    leaves whose path holds a name in ``skip`` left out)."""
    total = 0
    rs = [s.spec if hasattr(s, "spec") else s
          for _, s in ref_leaves(rspecs)]
    for (path, leaf), spec in zip(ref_leaves(rtree), rs):
        if any(k in skip for k in path):
            continue
        shard = ref_sharding.NamedSharding(rm, spec).shard_shape(
            tuple(leaf.shape))
        total += int(np.prod(shard, dtype=np.int64)) * leaf.dtype.itemsize
    return total


def check_analytic(rec, arch, shape_name, hf):
    spec = ref_shapes.SHAPES[shape_name]
    want = ref_analysis.analytic_costs(
        ref_get_config(arch), spec.kind, seq_len=spec.seq_len,
        global_batch=spec.global_batch, host_fraction=hf)
    a = rec["analytic"]
    assert (a["flops_global"], a["hbm_bytes_global"],
            a["model_flops_global"], a["notes"]) == (
        want.flops, want.hbm_bytes, want.model_flops, want.notes)


def test_dryrun_decode_overlap_cell_bytes_and_costs():
    rec = dryrun.dryrun_cell("llama3.1-8b", "decode_32k", variant="overlap")
    assert "error" not in rec and "skipped" not in rec
    rm = ref_mesh("16x16")
    rcfg = ref_get_config("llama3.1-8b")
    rules = ref_sharding.rules_for_mesh(rm, "serve")
    rparams = both_params("llama3.1-8b")[1]
    dev, host = rec["device_batch"], rec["host_batch"]
    assert (dev, host) == (96, 32)
    rst = ref_shapes.abstract_state(rcfg, device_batch=dev, host_batch=host,
                                    cache_len=32768)
    rtok, rtspec = ref_shapes.decode_token_specs(rcfg, dev, rm)
    rhio, rhspec = ref_shapes.host_io_specs(rcfg, host, rm)
    want = (ref_spec_bytes(rm, rparams,
                           ref_sharding.param_shardings(rm, rparams, rules))
            + ref_spec_bytes(rm, rst, ref_shapes.state_specs(
                rcfg, rst, rm, long_context=False))
            + ref_spec_bytes(rm, [rtok], [rtspec])
            # the port's window fields are host ints, not 0-d arrays
            + ref_spec_bytes(rm, rhio, rhspec, skip=(
                "consume_layer", "emit_layer", "window_start",
                "window_end")))
    assert rec["memory"]["argument_bytes"] == want
    # the donated state is updated in place: every byte of it aliases
    assert rec["memory"]["alias_bytes"] > 0
    assert rec["collectives"]["total_bytes"] > 0
    assert rec["cost_analysis"]["kernel_calls"] == {"decode_attention": 32}
    check_analytic(rec, "llama3.1-8b", "decode_32k", 0.25)


def test_dryrun_xlstm_long_context_cell():
    rec = dryrun.dryrun_cell("xlstm-125m", "long_500k", multi_pod=True)
    assert "error" not in rec and "skipped" not in rec
    rm = ref_mesh("2x16x16")
    rcfg = ref_get_config("xlstm-125m")
    rparams = both_params("xlstm-125m")[1]
    rules = ref_sharding.rules_for_mesh(rm, "serve")
    rst = ref_shapes.abstract_state(rcfg, device_batch=1, host_batch=0,
                                    cache_len=524288)
    rtok, rtspec = ref_shapes.decode_token_specs(rcfg, 1, rm)
    want = (ref_spec_bytes(rm, rparams,
                           ref_sharding.param_shardings(rm, rparams, rules))
            + ref_spec_bytes(rm, rst, ref_shapes.state_specs(
                rcfg, rst, rm, long_context=True))
            + ref_spec_bytes(rm, [rtok], [rtspec]))
    assert rec["memory"]["argument_bytes"] == want
    check_analytic(rec, "xlstm-125m", "long_500k", 0.0)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("shape_name", ["prefill_32k", "train_4k"])
def test_dryrun_xlstm_span_cells_trace(shape_name, mesh_name):
    """xlstm-125m's prefill (32 x 32768) and train (256 x 4096) cells trace
    as the reference's do: each recurrence one kernel call a layer (its
    meta rule), the train step's remat running each forward twice; the
    argument bytes are the reference's specs' sum."""
    arch = "xlstm-125m"
    rec = dryrun.dryrun_cell(arch, shape_name,
                             multi_pod=mesh_name == "2x16x16")
    assert "error" not in rec and "skipped" not in rec
    rm = ref_mesh(mesh_name)
    rcfg = ref_get_config(arch)
    spec = ref_shapes.SHAPES[shape_name]
    calls = rec["cost_analysis"]["kernel_calls"]
    if shape_name == "train_4k":
        rparams = ref_abstract_params(rcfg)
        ropt = ref_make_optimizer("adamw", moment_dtype="bfloat16")
        rstate = jax.eval_shape(lambda p: ref_init_train_state(
            rcfg, RefTrainConfig(remat=True), ropt, p), rparams)
        rbatch, rbspec = ref_shapes.train_batch_specs(rcfg, spec, rm)
        want = (ref_spec_bytes(rm, rstate,
                               ref_sharding.param_shardings(rm, rstate))
                + ref_spec_bytes(rm, rbatch, rbspec))
        assert calls == {"mlstm_recurrence": 12, "slstm_recurrence": 12,
                         "mlstm_recurrence_bwd": 6,
                         "slstm_recurrence_bwd": 6}
    else:
        rparams = both_params(arch)[1]
        rules = ref_sharding.rules_for_mesh(rm, "serve")
        rin, rinspec = ref_shapes.prefill_input_specs(rcfg, spec, rm)
        rst = ref_shapes.abstract_state(rcfg, device_batch=spec.global_batch,
                                        host_batch=0,
                                        cache_len=spec.seq_len)
        want = (ref_spec_bytes(rm, rparams,
                               ref_sharding.param_shardings(rm, rparams,
                                                            rules))
                + ref_spec_bytes(rm, rin, rinspec)
                + ref_spec_bytes(rm, rst, ref_shapes.state_specs(
                    rcfg, rst, rm, long_context=False, for_prefill=True)))
        assert calls == {"mlstm_recurrence": 6, "slstm_recurrence": 6}
    assert rec["memory"]["argument_bytes"] == want
    assert rec["cost_analysis"]["kernel_flops"] > 0
    check_analytic(rec, arch, shape_name, 0.0)


def test_dryrun_train_cell_on_production_and_local_meshes():
    """One train step (loss, gradients, clip, AdamW) of llama3.1-8b cut to
    2 layers at published width and the train_4k batch: its argument
    bytes equal the reference's specs' sum, it issues collectives on the
    16x16 mesh and none on a (1, 1) mesh."""
    arch = "llama3.1-8b"
    cfg = dataclasses.replace(get_config(arch), num_layers=2)
    rcfg = dataclasses.replace(ref_get_config(arch), num_layers=2)
    rec = dryrun.dryrun_cell(arch, "train_4k", cfg=cfg)
    assert rec["optimizer"] == "adamw"
    rm = ref_mesh("16x16")
    rparams = ref_abstract_params(rcfg)
    ropt = ref_make_optimizer("adamw", moment_dtype="bfloat16")
    rstate = jax.eval_shape(lambda p: ref_init_train_state(
        rcfg, RefTrainConfig(remat=True), ropt, p), rparams)
    rbatch, rbspec = ref_shapes.train_batch_specs(
        rcfg, ref_shapes.SHAPES["train_4k"], rm)
    want = (ref_spec_bytes(rm, rstate,
                           ref_sharding.param_shardings(rm, rstate))
            + ref_spec_bytes(rm, rbatch, rbspec))
    assert rec["memory"]["argument_bytes"] == want
    # the optimizer updates the state in place: params and moments alias
    assert rec["memory"]["alias_bytes"] == want - ref_spec_bytes(
        rm, rbatch, rbspec) - 4          # the host step is a new tensor
    assert rec["collectives"]["count_by_kind"].get("reduce-scatter", 0) + \
        rec["collectives"]["count_by_kind"].get("all-reduce", 0) > 0
    calls = rec["cost_analysis"]["kernel_calls"]
    # remat runs each layer's forward twice
    assert calls == {"prefill_attention": 4, "prefill_attention_bwd": 2}
    local = dryrun.dryrun_cell(arch, "train_4k", cfg=cfg,
                               mesh=mesh.make_local_mesh())
    assert local["collectives"]["total_bytes"] == 0
    assert local["collectives"]["count_by_kind"] == {}
    assert local["mesh"] == "1x1"
    # per device: one rank of 256 does a part of the (1, 1) mesh's work
    assert 0 < rec["cost_analysis"]["flops"] < \
        local["cost_analysis"]["flops"]


# ---------------------------------------------------------------------------
# The kernels' meta rules
# ---------------------------------------------------------------------------


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_meta_rules_give_the_plain_versions_shapes_and_dtypes():
    gen = torch.Generator().manual_seed(0)

    def cpu(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen).to(dtype)

    b, t, h, kv, d, s = 2, 5, 4, 2, 16, 9
    for dt in (torch.float32, torch.bfloat16):
        q, k, v = cpu(b, h, d, dtype=dt), cpu(b, s, kv, d, dtype=dt), \
            cpu(b, s, kv, d, dtype=dt)
        lens = torch.tensor([3, 9], dtype=torch.int32)
        want = ref.decode_attention_ref(q, k, v, lens)
        got = ops.decode_attention(q.to("meta"), k.to("meta"), v.to("meta"),
                                   lens.to("meta"))
        assert (got.shape, got.dtype, got.device.type) == (
            want.shape, want.dtype, "meta")
        q4 = cpu(b, t, h, d, dtype=dt)
        want = ref.prefill_attention_ref(q4, k, v, None,
                                         torch.zeros(b, dtype=torch.int32))
        got = ops.prefill_attention(q4.to("meta"), k.to("meta"),
                                    v.to("meta"), None,
                                    torch.zeros(b, dtype=torch.int32,
                                                device="meta"))
        assert (got.shape, got.dtype) == (want.shape, want.dtype)
    # the scan, and its in-place form
    i, n = 6, 8
    args = [cpu(b, t, i), cpu(b, t, i), cpu(b, t, n), cpu(b, t, n),
            -cpu(i, n).abs(), cpu(i), cpu(b, i, n)]
    y, hf = ref.mamba_selective_scan_ref(*args)
    my, mh = ops.mamba_selective_scan(*[a.to("meta") for a in args])
    assert (my.shape, my.dtype, mh.shape, mh.dtype) == (
        y.shape, y.dtype, hf.shape, hf.dtype)
    h0 = args[6].to("meta")
    _, mh = ops.mamba_selective_scan(*[a.to("meta") for a in args[:6]], h0,
                                     None, h0)
    assert mh is h0


def test_meta_rules_with_a_gradient_and_dtensor_placements():
    from torch.distributed.tensor import Shard
    pm = port_mesh("16x16")
    P = sharding.PartitionSpec
    b, t, h, kv, d = 32, 64, 32, 16, 128
    q = dryrun.to_dtensor(pm, meta(b, t, h, d), P("data", None, "model"))
    k = dryrun.to_dtensor(pm, meta(b, t, kv, d), P("data", None, "model"))
    v = dryrun.to_dtensor(pm, meta(b, t, kv, d), P("data", None, "model"))
    for x in (q, k, v):
        x.requires_grad_(True)
    with ops.record_meta_calls() as calls:
        out = ops.prefill_attention(q, k, v)
        assert tuple(out.placements) == (Shard(0), Shard(2))
        assert out.shape == q.shape and out.dtype == q.dtype
        gq, gk, gv = torch.autograd.grad(out.sum(), (q, k, v))
    for g, x in ((gq, q), (gk, k), (gv, v)):
        assert g.shape == x.shape and g.device.type == "meta"
    assert [c[0] for c in calls] == ["prefill_attention",
                                     "prefill_attention_bwd"]
    i, n = 256, 16
    dt = dryrun.to_dtensor(pm, meta(b, t, i), P("data", None, "model"))
    dt.requires_grad_(True)
    bm = dryrun.to_dtensor(pm, meta(b, t, n), P("data"))
    a = dryrun.to_dtensor(pm, meta(i, n), P("model"))
    dd = dryrun.to_dtensor(pm, meta(i), P("model"))
    h0 = dryrun.to_dtensor(pm, meta(b, i, n), P("data", "model"))
    with ops.record_meta_calls() as calls:
        y, hfin = ops.mamba_selective_scan(dt, dt, bm, bm, a, dd, h0)
        assert tuple(y.placements) == tuple(dt.placements)
        assert y.dtype == torch.float32 and hfin.shape == h0.shape
        (gdt,) = torch.autograd.grad(y.sum(), (dt,))
    assert gdt.shape == dt.shape
    assert [c[0] for c in calls] == ["mamba_selective_scan",
                                     "mamba_selective_scan_bwd"]
    flops, nbytes = analysis.kernel_costs(calls)
    # at rank 0's local shapes: batch over 16, channels over 16
    assert flops == (5 + 14) * (b // 16) * t * (i // 16) * n and nbytes > 0


def test_kernel_costs_follow_the_bound_formulas():
    calls = [("decode_attention", dict(q=(2, 8, 64), k=(2, 100, 2, 64),
                                       dtype=torch.bfloat16)),
             ("prefill_attention", dict(q=(1, 10, 4, 32), k=(1, 10, 4, 32),
                                        dtype=torch.bfloat16, causal=True,
                                        offset=False))]
    flops, _ = analysis.kernel_costs(calls)
    assert flops == 4 * 2 * 100 * 8 * 64 + 4 * 55 * 4 * 32


def test_vocab_parallel_nll_equals_the_plain_loss_and_gradient():
    """The DTensor train step's cross-entropy (each rank's vocab shard,
    the sums completed by all-reduces) on a (1, 1) mesh, where nothing is
    reduced: the values and gradients of the plain ``_nll``."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.training import train_step
    mesh.make_local_mesh()             # a world of one rank
    pm = DeviceMesh("cpu", torch.arange(1).view(1, 1),
                    mesh_dim_names=("data", "model"))   # values on the CPU
    gen = torch.Generator().manual_seed(0)
    logits = torch.randn((2, 5, 11), generator=gen) * 3
    labels = torch.randint(0, 11, (2, 5), generator=gen, dtype=torch.int32)
    for z in (0.0, 1e-3):
        x = logits.clone().requires_grad_(True)
        want = train_step._nll(x, labels, z)
        (gw,) = torch.autograd.grad(want.sum() * 0.5, (x,))
        xd = DTensor.from_local(logits.clone(), pm, [Shard(0), Shard(2)],
                                run_check=False).requires_grad_(True)
        lab = DTensor.from_local(labels, pm, [Shard(0), Replicate()],
                                 run_check=False)
        got = train_step._nll(xd, lab, z)
        (gd,) = torch.autograd.grad(got.sum() * 0.5, (xd,))
        torch.testing.assert_close(got.full_tensor(), want, rtol=1e-6,
                                   atol=1e-6)
        torch.testing.assert_close(gd.full_tensor(), gw, rtol=1e-6,
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# Launch counters
# ---------------------------------------------------------------------------


def test_launch_counter_loses_no_increment_under_threads():
    @counted
    def fake_kernel():
        fake_kernel.add_launch()

    fake_kernel.launches = 0
    start = threading.Barrier(8)

    def work():
        start.wait()
        for _ in range(100_000):
            fake_kernel()

    threads = [threading.Thread(target=work) for _ in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert fake_kernel.launches == 800_000
    fake_kernel.launches = 0
    assert fake_kernel.launches == 0
    assert fake_kernel.__name__ == "fake_kernel"
