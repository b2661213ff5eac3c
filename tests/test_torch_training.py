"""Training of the port against the JAX reference, on the CPU.

The same numpy-seeded weights (the reference's, through
``params_from_numpy`` / ``train_state_from_numpy``) and inputs go through
both packages in fp32 (``param_dtype``/``compute_dtype`` float32: XLA's
CPU backend keeps fused bf16 intermediates in fp32, which breaks bf16
comparisons; ROADMAP queue 3), with no router jitter (``jax.random``
cannot be matched):

  * loss and every gradient leaf of ``make_loss_fn`` against
    ``jax.value_and_grad`` of the reference's, for six families (dense,
    the dense-FFN Jamba hybrid, the MoE on its dropless and capacity
    paths, xLSTM, the HuBERT encoder on frame embeddings, the PaliGemma
    prefix-LM), remat on and off, each leaf within 1e-4 of its largest
    |gradient| (fp32 sums in other orders over up to 16 layers);
  * the chunked unembed + cross-entropy against the dense loss;
  * three train steps (AdamW, Adafactor, accumulation over 4
    microbatches, int8 compression with error feedback) against the
    reference's steps from the same state;
  * the reference's own ``tests/test_training.py`` scenarios on the port;
  * checkpoints written by either package restored by the other, bf16
    leaves included;
  * the plain backward functions of both kernels against
    ``torch.autograd`` on their plain forwards and against ``jax.vjp`` of
    the reference's oracles.

The backward kernels themselves run on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""
import dataclasses
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st
torch = pytest.importorskip("torch")  # the port needs PyTorch

from repro.configs import get_config as ref_get_config
from repro.kernels.mamba_scan import mamba_selective_scan_ref as jax_scan
from repro.kernels.ref import prefill_attention_ref as jax_attention
from repro.models import init_params as ref_init
from repro.models.config import FFNKind as RefFFNKind
from repro.training import TrainConfig as RefTrainConfig
from repro.training import checkpoint as ref_checkpoint
from repro.training import init_train_state as ref_init_state
from repro.training import make_optimizer as ref_make_optimizer
from repro.training import make_train_step as ref_make_step
from repro.training.train_step import make_loss_fn as ref_make_loss_fn
from repro_torch.configs import get_config
from repro_torch.core.tree import tree_flatten, tree_leaves
from repro_torch.distributed.compression import (
    compress_decompress_with_feedback, dequantize_int8, quantize_int8)
from repro_torch.kernels import ops, ref
from repro_torch.launch import train as train_cli
from repro_torch.models import init_params, params_from_numpy
from repro_torch.models.config import FFNKind
from repro_torch.training import (TrainConfig, checkpoint, init_train_state,
                                  make_optimizer, make_train_step,
                                  train_state_from_numpy)
from repro_torch.training import optimizer as optimizer_mod
from repro_torch.training.train_step import loss_grads, make_loss_fn

F32 = dict(param_dtype="float32", compute_dtype="float32")


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x)


# ---------------------------------------------------------------------------
# loss and gradients of six families
# ---------------------------------------------------------------------------

# name -> (arch, batch, length): the capacity case runs 2 x 130 = 260
# tokens, past the MoE's 256-token dropless threshold
FAMILIES = {"internlm2-1.8b": ("internlm2-1.8b", 2, 12),
            "jamba-dense": ("jamba-1.5-large-398b", 2, 12),
            "deepseek-moe-dropless": ("deepseek-moe-16b", 2, 12),
            "deepseek-moe-capacity": ("deepseek-moe-16b", 2, 130),
            "xlstm-125m": ("xlstm-125m", 2, 12),
            "hubert-xlarge": ("hubert-xlarge", 2, 12),
            "paligemma-3b": ("paligemma-3b", 2, 8)}


def _configs(family):
    arch = FAMILIES[family][0]
    if family == "jamba-dense":
        return tuple(dataclasses.replace(
            get(arch).reduced(d_model=64, vocab=64), ffn_kind=kind.DENSE,
            moe=None, **F32) for get, kind in ((ref_get_config, RefFFNKind),
                                               (get_config, FFNKind)))
    return (dataclasses.replace(ref_get_config(arch).reduced(), **F32),
            dataclasses.replace(get_config(arch).reduced(), **F32))


def _batch(cfg, b, t, seed=0):
    """Numpy inputs per the frontend, labels over every position the
    logits have (the VLM's patches too)."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.frontend == "audio":
        out["embeds"] = rng.standard_normal((b, t, cfg.d_model)).astype(
            np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab_size, (b, t))
    n = t
    if cfg.frontend == "vision":
        out["patches"] = rng.standard_normal(
            (b, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
        n += cfg.frontend_tokens
    out["labels"] = rng.integers(0, cfg.vocab_size, (b, n))
    return out


def _jax(batch):
    return {k: jnp.asarray(v, jnp.int32 if v.dtype.kind == "i" else None)
            for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


_REF = {}


def _reference(family, tcfg_kw=()):
    """(port cfg, port params, numpy batch, reference loss, metrics,
    grads as numpy leaves) for a family, computed once per module."""
    key = (family, tcfg_kw)
    if key not in _REF:
        rcfg, cfg = _configs(family)
        _, b, t = FAMILIES[family]
        rparams = ref_init(jax.random.PRNGKey(0), rcfg)
        batch = _batch(cfg, b, t)
        loss_fn = ref_make_loss_fn(rcfg, RefTrainConfig(remat=False,
                                                        **dict(tcfg_kw)))
        (total, metrics), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(rparams, _jax(batch), None)
        params = params_from_numpy(cfg, jax.tree.map(np.asarray, rparams),
                                   "cpu")
        _REF[key] = (cfg, params, batch, float(total),
                     {k: float(v) for k, v in metrics.items()},
                     [np.asarray(g) for g in jax.tree.leaves(grads)])
    return _REF[key]


def _port_grads(cfg, params, batch, tcfg):
    grads, metrics = loss_grads(make_loss_fn(cfg, tcfg), params,
                                _torch(batch), None)
    metrics = {k: float(v) for k, v in metrics.items()}
    return (metrics["loss"] + metrics["aux_loss"], metrics,
            tree_leaves(grads))


def _assert_grads(mine, theirs, tol=1e-4):
    assert len(mine) == len(theirs)
    for i, (g, r) in enumerate(zip(mine, theirs)):
        g = _np(g)
        assert g.shape == r.shape, i
        bar = tol * max(float(np.abs(r).max()), 1e-6)
        err = float(np.abs(g - r).max())
        assert err <= bar, (i, g.shape, err, bar)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_loss_and_grads_match_reference(family, remat):
    cfg, params, batch, total, metrics, rgrads = _reference(family)
    mine, mmetrics, grads = _port_grads(cfg, params, batch,
                                        TrainConfig(remat=remat))
    assert mine == pytest.approx(total, rel=1e-5)
    assert mmetrics["loss"] == pytest.approx(metrics["loss"], rel=1e-5)
    assert mmetrics["aux_loss"] == pytest.approx(metrics["aux_loss"],
                                                 rel=1e-4, abs=1e-7)
    _assert_grads(grads, rgrads)


def test_chunked_loss_matches_dense():
    """Over chunks of 4 of the 12 predicted positions (T 13): the same
    loss and gradients as the whole logits, and the reference's loss."""
    rcfg, cfg = _configs("internlm2-1.8b")
    rparams = ref_init(jax.random.PRNGKey(0), rcfg)
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, rparams), "cpu")
    batch = _batch(cfg, 2, 13)
    dense = _port_grads(cfg, params, batch, TrainConfig(remat=False))
    chunked = _port_grads(cfg, params, batch,
                          TrainConfig(remat=True, loss_chunk=4))
    ref_total, _ = ref_make_loss_fn(rcfg, RefTrainConfig(loss_chunk=4))(
        rparams, _jax(batch), None)
    assert chunked[0] == pytest.approx(dense[0], rel=1e-6)
    assert chunked[0] == pytest.approx(float(ref_total), rel=1e-5)
    _assert_grads(chunked[2], [_np(g) for g in dense[2]], tol=1e-5)


def test_z_loss_and_mask_match_reference():
    """z-loss and a per-position mask through the dense loss."""
    rcfg, cfg = _configs("internlm2-1.8b")
    rparams = ref_init(jax.random.PRNGKey(0), rcfg)
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, rparams), "cpu")
    batch = _batch(cfg, 2, 12)
    batch["mask"] = (np.random.default_rng(3).random((2, 12)) < 0.7
                     ).astype(np.float32)
    (total, _), rgrads = jax.value_and_grad(
        ref_make_loss_fn(rcfg, RefTrainConfig(z_loss=1e-3, remat=False)),
        has_aux=True)(rparams, _jax(batch), None)
    mine, _, grads = _port_grads(cfg, params, batch,
                                 TrainConfig(z_loss=1e-3, remat=False))
    assert mine == pytest.approx(float(total), rel=1e-5)
    _assert_grads(grads, [np.asarray(g) for g in jax.tree.leaves(rgrads)])


# ---------------------------------------------------------------------------
# train steps against the reference's
# ---------------------------------------------------------------------------


def _small():
    """The reference's tests/test_training.py model: internlm2-1.8b cut
    to 2 layers, d_model 64, vocab 128 (fp32 here)."""
    rcfg = dataclasses.replace(ref_get_config("internlm2-1.8b").reduced(
        layers=2, d_model=64, vocab=128), **F32)
    cfg = dataclasses.replace(get_config("internlm2-1.8b").reduced(
        layers=2, d_model=64, vocab=128), **F32)
    return rcfg, cfg


STEP_CASES = {"adamw": dict(optimizer="adamw"),
              "adafactor": dict(optimizer="adafactor"),
              "adamw-accum4": dict(optimizer="adamw", accum_steps=4),
              "adamw-compress": dict(optimizer="adamw", compress_grads=True),
              "adafactor-accum4-compress": dict(optimizer="adafactor",
                                                accum_steps=4,
                                                compress_grads=True),
              # the optimizers' slab loops: every leaf in slabs of at most
              # 64 elements (one row of a 64-wide matrix), a stacked leaf
              # one group at a time, as at published width (64 M)
              "adamw-slab64": dict(optimizer="adamw"),
              "adafactor-slab64": dict(optimizer="adafactor")}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_train_steps_match_reference(case, monkeypatch):
    """Three steps from the reference's initial state on the same
    batches: per-step loss, aux loss and grad norm at 1e-5, and every
    leaf of the final state (parameters, moments, residuals) within
    1e-5 (the updates are lr 1e-3 a step).  With int8 compression a
    gradient element on a rounding boundary may round to the
    neighbouring code in one package (the inputs differ in their last
    bits), which moves that element's residual by one quantization step
    and its update by up to 2 lr, after which the two trajectories part
    everywhere by a little: so there each step starts from the
    reference's state, and per leaf at most 3 elements, or one in a
    thousand, may lie outside 1e-5 (by less than one quantization step
    of the leaf, 2 max|g| / 127)."""
    kw = STEP_CASES[case]
    if case.endswith("slab64"):
        monkeypatch.setattr(optimizer_mod, "SLAB", 64)
    rcfg, cfg = _small()
    rparams = ref_init(jax.random.PRNGKey(0), rcfg)
    ropt = ref_make_optimizer(kw["optimizer"], lr=1e-3)
    opt = make_optimizer(kw["optimizer"], lr=1e-3)
    rtcfg = RefTrainConfig(remat=True, **kw)
    rstate = ref_init_state(rcfg, rtcfg, ropt, rparams)
    state = train_state_from_numpy(cfg, jax.tree.map(np.asarray, rstate),
                                   "cpu")
    rstep = jax.jit(ref_make_step(rcfg, rtcfg, ropt))
    step = make_train_step(cfg, TrainConfig(remat=True, **kw), opt)
    rng = np.random.default_rng(1)
    compress = kw.get("compress_grads", False)
    for i in range(3):
        toks = rng.integers(0, cfg.vocab_size, (4, 16))
        batch = {"tokens": toks, "labels": toks}
        if compress:
            state = train_state_from_numpy(
                cfg, jax.tree.map(np.asarray, rstate), "cpu")
        rstate, rm = rstep(rstate, _jax(batch), jax.random.PRNGKey(i))
        state, m = step(state, _torch(batch), None)
        for k in ("loss", "aux_loss", "grad_norm"):
            assert float(m[k]) == pytest.approx(float(rm[k]), rel=1e-5,
                                                abs=1e-7), (i, k)
        mine, theirs = tree_leaves(state), jax.tree.leaves(rstate)
        assert len(mine) == len(theirs)
        for j, (a, r) in enumerate(zip(mine, theirs)):
            a, r = _np(a), np.asarray(r)
            if not compress:
                if i == 2:
                    np.testing.assert_allclose(a, r, atol=1e-5, rtol=1e-5,
                                               err_msg=str(j))
                continue
            off = np.abs(a - r) > 1e-5 + 1e-5 * np.abs(r)
            assert off.sum() <= max(3, off.size // 1000), (i, j, off.sum())
    assert int(state.opt_state.step) == int(rstate.opt_state.step) == 3
    if compress:    # the residuals' quantization step bounds the flips
        for a, r in zip(tree_leaves(state.error_feedback),
                        jax.tree.leaves(rstate.error_feedback)):
            r = np.asarray(r)
            assert float(np.abs(_np(a) - r).max()) <= \
                2 * float(np.abs(r).max()) + 1e-6


# ---------------------------------------------------------------------------
# the reference's tests/test_training.py scenarios on the port
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def setup():
    cfg = get_config("internlm2-1.8b").reduced(layers=2, d_model=64,
                                               vocab=128)
    params = init_params(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (4, 32)))
    return cfg, params, {"tokens": toks, "labels": toks}


def _fresh(params):
    return type(params)(*(tree_flatten(part)[1].unflatten(
        [t.clone() for t in tree_leaves(part)]) for part in params))


@pytest.mark.parametrize("opt_name", ["adamw", "adafactor"])
def test_loss_decreases(setup, opt_name):
    cfg, params, batch = setup
    tcfg = TrainConfig(optimizer=opt_name, remat=True)
    opt = make_optimizer(opt_name, lr=1e-3)
    step = make_train_step(cfg, tcfg, opt)
    state = init_train_state(cfg, tcfg, opt, _fresh(params))
    losses = []
    for i in range(6):
        state, m = step(state, batch,
                        torch.Generator().manual_seed(i))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]
    assert type(state.params).__name__ == "ModelParams"  # structure survives


def test_grad_accumulation_matches_full_batch(setup):
    cfg, params, batch = setup
    opt = make_optimizer("adamw", lr=1e-3)
    out = []
    for n in (1, 4):
        tcfg = TrainConfig(accum_steps=n, remat=False)
        state = init_train_state(cfg, tcfg, opt, _fresh(params))
        state, m = make_train_step(cfg, tcfg, opt)(state, batch, None)
        out.append((state, m))
    (s1, m1), (s2, m4) = out
    # same data => statistically identical loss; grads averaged over
    # microbatches equal the full-batch mean
    assert float(m1["loss"]) == pytest.approx(float(m4["loss"]), rel=1e-3)
    for a, b in zip(tree_leaves(s1.params), tree_leaves(s2.params)):
        np.testing.assert_allclose(_np(a), _np(b), atol=3e-2)


@given(st.lists(st.floats(-100, 100, allow_nan=False), min_size=1,
                max_size=64))
@settings(max_examples=100, deadline=None)
def test_int8_quantization_error_bound(vals):
    x = torch.tensor(vals, dtype=torch.float32)
    q, scale = quantize_int8(x)
    err = (dequantize_int8(q, scale) - x).abs()
    assert float(err.max()) <= float(scale) / 2 + 1e-6


def test_int8_quantization_matches_reference():
    """The codes and scale of the reference's quantize_int8, bit for bit,
    on a seeded sweep (all-zero and one-element tensors included)."""
    from repro.distributed.compression import quantize_int8 as ref_quantize
    rng = np.random.default_rng(0)
    cases = [np.zeros(5, np.float32), np.array([3.0], np.float32)] + [
        (rng.standard_normal(rng.integers(1, 300)) * 10 ** rng.uniform(
            -3, 3)).astype(np.float32) for _ in range(20)]
    for x in cases:
        q, s = quantize_int8(torch.from_numpy(x))
        rq, rs = ref_quantize(jnp.asarray(x))
        np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
        assert float(s) == float(rs)


def test_error_feedback_is_unbiased_over_time():
    """With a CONSTANT gradient, error feedback must make the running
    mean of compressed grads converge to the true gradient."""
    g = {"w": torch.tensor([[0.3, -1.7], [2.4, 0.01]])}
    ef = None
    acc = np.zeros((2, 2), np.float32)
    n = 200
    for _ in range(n):
        out, ef = compress_decompress_with_feedback(g, ef)
        acc += out["w"].numpy()
    np.testing.assert_allclose(acc / n, g["w"].numpy(), atol=1e-3)


def test_checkpoint_atomicity_and_resume(setup):
    cfg, params, _ = setup
    with tempfile.TemporaryDirectory() as d:
        checkpoint.save(d, 10, params, keep=2)
        checkpoint.save(d, 20, params, keep=2)
        checkpoint.save(d, 30, params, keep=2)
        # keep=2 garbage-collects step 10
        assert checkpoint.latest_step(d) == 30
        assert not os.path.exists(os.path.join(d, "step_000000010"))
        # a crashed (tmp) write never shadows a committed step
        os.makedirs(os.path.join(d, "step_000000040.tmp"))
        step, tree = checkpoint.restore(d, params)
        assert step == 30
        assert not os.path.exists(os.path.join(d, "step_000000040.tmp"))
        for a, b in zip(tree_leaves(params), tree_leaves(tree)):
            assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_rejects_wrong_structure(setup):
    cfg, params, _ = setup
    with tempfile.TemporaryDirectory() as d:
        checkpoint.save(d, 1, {"a": torch.zeros(3)})
        with pytest.raises(ValueError):
            checkpoint.restore(d, params)


# ---------------------------------------------------------------------------
# checkpoints across the packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("opt_name,compress", [("adamw", False),
                                                ("adafactor", True)])
def test_checkpoints_cross_packages(dtype, opt_name, compress):
    """A reference TrainState saved by the reference restores in the port
    bit for bit (step, moments, residuals; bf16 parameters as bf16), and
    the port's saved state restores in the reference the same."""
    kw = dict(param_dtype=dtype, compute_dtype=dtype)
    rcfg = dataclasses.replace(ref_get_config("internlm2-1.8b").reduced(
        layers=2, d_model=64, vocab=128), **kw)
    cfg = dataclasses.replace(get_config("internlm2-1.8b").reduced(
        layers=2, d_model=64, vocab=128), **kw)
    tcfg = RefTrainConfig(optimizer=opt_name, compress_grads=compress)
    ropt = ref_make_optimizer(opt_name)
    rstate = ref_init_state(rcfg, tcfg, ropt,
                            ref_init(jax.random.PRNGKey(0), rcfg))
    # a step, so the moments and the step counter are not zeros
    toks = jnp.asarray(np.random.default_rng(0).integers(0, 128, (2, 8)),
                       jnp.int32)
    rstate, _ = jax.jit(ref_make_step(rcfg, tcfg, ropt))(
        rstate, {"tokens": toks, "labels": toks}, jax.random.PRNGKey(0))
    template = init_train_state(
        cfg, TrainConfig(optimizer=opt_name, compress_grads=compress),
        make_optimizer(opt_name), init_params(cfg, seed=1, device="cpu"))
    theirs = jax.tree.leaves(rstate)
    with tempfile.TemporaryDirectory() as d:
        ref_checkpoint.save(d, 7, rstate)
        step, state = checkpoint.restore(d, template)
        assert step == 7
        mine = tree_leaves(state)
        assert len(mine) == len(theirs)
        for a, r in zip(mine, theirs):
            r = np.asarray(r)
            assert tuple(a.shape) == r.shape
            if r.dtype.name == "bfloat16":
                assert a.dtype == torch.bfloat16
                np.testing.assert_array_equal(
                    a.view(torch.int16).numpy(), r.view(np.int16))
            else:
                np.testing.assert_array_equal(a.numpy(), r)
    with tempfile.TemporaryDirectory() as d:
        checkpoint.save(d, 9, state)
        step, back = ref_checkpoint.restore(d, rstate)
        assert step == 9
        for r, b in zip(theirs, jax.tree.leaves(back)):
            assert np.asarray(b).dtype == np.asarray(r).dtype
            np.testing.assert_array_equal(np.asarray(b), np.asarray(r))


# ---------------------------------------------------------------------------
# the kernels' plain backward functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("h,kv", [(2, 2), (4, 2), (6, 1)])
@pytest.mark.parametrize("mask", ["causal", "prefix", "full"])
def test_attention_bwd_ref_matches_autograd_and_jax(h, kv, mask):
    """prefill_attention_bwd_ref at groups 1, 2 and 6, odd T 7 over S 9
    keys, against torch.autograd of the plain forward, jax.vjp of the
    reference's oracle, and the Function ``ops`` routes a gradient to."""
    rng = np.random.default_rng(h * 10 + kv)
    b, t, s, d = 2, 7, 9, 8
    qn, kn, vn = (rng.standard_normal(shape).astype(np.float32) for shape in
                  ((b, t, h, d), (b, s, kv, d), (b, s, kv, d)))
    don = rng.standard_normal((b, t, h, d)).astype(np.float32)
    pre = np.array([4, 0], np.int32) if mask == "prefix" else None
    causal = mask != "full"
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in (qn, kn, vn))
    tp = None if pre is None else torch.from_numpy(pre)
    out = ref.prefill_attention_ref(q, k, v, tp, causal=causal)
    auto = torch.autograd.grad(out, (q, k, v), torch.from_numpy(don))
    o, lse = ref.prefill_attention_ref(q.detach(), k.detach(), v.detach(),
                                       tp, causal=causal, return_lse=True)
    mine = ref.prefill_attention_bwd_ref(q.detach(), k.detach(), v.detach(),
                                         o, lse, torch.from_numpy(don), tp,
                                         causal)
    jp = None if pre is None else jnp.asarray(pre)
    _, vjp = jax.vjp(lambda a, bb, c: jax_attention(a, bb, c, jp,
                                                    causal=causal),
                     jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn))
    theirs = vjp(jnp.asarray(don))
    via_ops = torch.autograd.grad(ops.prefill_attention(q, k, v, tp,
                                                        causal=causal),
                                  (q, k, v), torch.from_numpy(don))
    for m, a, j, w in zip(mine, auto, theirs, via_ops):
        np.testing.assert_allclose(m.numpy(), a.numpy(), atol=1e-5)
        np.testing.assert_allclose(m.numpy(), np.asarray(j), atol=1e-5)
        assert torch.equal(w, m)


def test_scan_bwd_ref_matches_autograd_and_jax():
    """mamba_selective_scan_bwd_ref from a nonzero h0 with gradients on
    both outputs, against torch.autograd of the plain loop, jax.vjp of
    the reference's oracle, and the Function ``ops`` routes to."""
    rng = np.random.default_rng(0)
    b, t, i, n = 2, 9, 6, 8
    dtn = np.log1p(np.exp(rng.standard_normal((b, t, i)))).astype(
        np.float32)
    xn = rng.standard_normal((b, t, i)).astype(np.float32)
    bn, cn = (rng.standard_normal((b, t, n)).astype(np.float32)
              for _ in range(2))
    an = -np.exp(rng.standard_normal((i, n))).astype(np.float32)
    dn = rng.standard_normal(i).astype(np.float32)
    hn = rng.standard_normal((b, i, n)).astype(np.float32)
    dyn = rng.standard_normal((b, t, i)).astype(np.float32)
    dhn = rng.standard_normal((b, i, n)).astype(np.float32)
    args = [torch.from_numpy(a).requires_grad_()
            for a in (dtn, xn, bn, cn, an, dn, hn)]
    y, h = ref.mamba_selective_scan_ref(*args)
    auto = torch.autograd.grad((y, h), args, (torch.from_numpy(dyn),
                                              torch.from_numpy(dhn)))
    mine = ref.mamba_selective_scan_bwd_ref(
        *(a.detach() for a in args), torch.from_numpy(dyn),
        torch.from_numpy(dhn))
    _, vjp = jax.vjp(jax_scan, *(jnp.asarray(a) for a in
                                 (dtn, xn, bn, cn, an, dn, hn)))
    theirs = vjp((jnp.asarray(dyn), jnp.asarray(dhn)))
    y2, h2 = ops.mamba_selective_scan(*args)
    via_ops = torch.autograd.grad((y2, h2), args, (torch.from_numpy(dyn),
                                                   torch.from_numpy(dhn)))
    for m, a, j, w in zip(mine, auto, theirs, via_ops):
        scale = max(float(np.abs(np.asarray(j)).max()), 1.0)
        np.testing.assert_allclose(m.numpy(), a.numpy(), atol=1e-5 * scale)
        np.testing.assert_allclose(m.numpy(), np.asarray(j),
                                   atol=1e-5 * scale)
        assert torch.equal(w, m)


@pytest.mark.parametrize("t,pre", [(1000, None), (320, (200, 130))])
def test_attention_bwd_ref_ragged_tiles_matches_jax(t, pre):
    """prefill_attention_bwd_ref at the card's ragged cases: T 1000 (not
    a multiple of the kernels' 64-query and 64-key tiles), and prefixes
    200 and 130 that end inside a key block; group 4, against
    jax.vjp of the reference's oracle."""
    rng = np.random.default_rng(t)
    b, h, kv, d = (1 if pre is None else 2), 4, 1, 16
    qn, kn, vn, don = (rng.standard_normal(shape).astype(np.float32)
                       for shape in ((b, t, h, d), (b, t, kv, d),
                                     (b, t, kv, d), (b, t, h, d)))
    tp = None if pre is None else torch.tensor(pre, dtype=torch.int32)
    o, lse = ref.prefill_attention_ref(
        *(torch.from_numpy(a) for a in (qn, kn, vn)), tp, return_lse=True)
    mine = ref.prefill_attention_bwd_ref(
        *(torch.from_numpy(a) for a in (qn, kn, vn)), o, lse,
        torch.from_numpy(don), tp)
    jp = None if pre is None else jnp.asarray(pre, jnp.int32)
    _, vjp = jax.vjp(lambda a, bb, c: jax_attention(a, bb, c, jp),
                     jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn))
    for m, j in zip(mine, vjp(jnp.asarray(don))):
        np.testing.assert_allclose(m.numpy(), np.asarray(j), atol=1e-5)


def test_scan_bwd_ref_ragged_interval_matches_jax():
    """mamba_selective_scan_bwd_ref over T 1000, not a multiple of the
    kernel's 16-step checkpoint interval, against jax.vjp of the
    reference's oracle."""
    rng = np.random.default_rng(1)
    b, t, i, n = 1, 1000, 6, 16
    dtn = np.log1p(np.exp(rng.standard_normal((b, t, i)))).astype(
        np.float32)
    xn = rng.standard_normal((b, t, i)).astype(np.float32)
    bn, cn = (rng.standard_normal((b, t, n)).astype(np.float32)
              for _ in range(2))
    an = -np.exp(rng.standard_normal((i, n))).astype(np.float32)
    dn = rng.standard_normal(i).astype(np.float32)
    hn = rng.standard_normal((b, i, n)).astype(np.float32)
    dyn = rng.standard_normal((b, t, i)).astype(np.float32)
    dhn = rng.standard_normal((b, i, n)).astype(np.float32)
    mine = ref.mamba_selective_scan_bwd_ref(
        *(torch.from_numpy(a) for a in (dtn, xn, bn, cn, an, dn, hn)),
        torch.from_numpy(dyn), torch.from_numpy(dhn))
    _, vjp = jax.vjp(jax_scan, *(jnp.asarray(a) for a in
                                 (dtn, xn, bn, cn, an, dn, hn)))
    for m, j in zip(mine, vjp((jnp.asarray(dyn), jnp.asarray(dhn)))):
        scale = max(float(np.abs(np.asarray(j)).max()), 1.0)
        np.testing.assert_allclose(m.numpy(), np.asarray(j),
                                   atol=1e-5 * scale)


def test_ops_refuse_gradients_they_do_not_have():
    q = torch.randn(1, 3, 2, 8, requires_grad=True)
    k = torch.randn(1, 5, 2, 8)
    off = torch.tensor([2], dtype=torch.int32)
    with pytest.raises(ValueError, match="q_offset"):
        ops.prefill_attention(q, k, k, None, off)
    with torch.no_grad():     # serving: no gradient, offsets accepted
        ops.prefill_attention(q, k, k, None, off)
    dt = torch.rand(1, 3, 4, requires_grad=True)
    with pytest.raises(ValueError, match="lens"):
        ops.mamba_selective_scan(dt, dt.detach(), torch.randn(1, 3, 8),
                                 torch.randn(1, 3, 8), -torch.ones(4, 8),
                                 torch.ones(4), torch.zeros(1, 4, 8),
                                 torch.tensor([2], dtype=torch.int32))


# ---------------------------------------------------------------------------
# the train CLI
# ---------------------------------------------------------------------------


def test_train_cli_checkpoints_and_resumes(capsys):
    """``python -m repro_torch.launch.train --device cpu`` at a tiny size:
    a checkpoint every 2 steps under the count of steps taken, the final
    one committed, and ``--resume`` continuing from it -- also from a
    step that is a multiple of ``--ckpt-every`` (the reference's loop
    would write that step's directory again there and fail)."""
    with tempfile.TemporaryDirectory() as d:
        argv = ["--device", "cpu", "--layers", "2", "--d-model", "64",
                "--batch", "2", "--seq", "16", "--ckpt-every", "2",
                "--ckpt-dir", d, "--optimizer", "adafactor"]
        first = train_cli.main(argv + ["--steps", "5"])
        assert first["start"] == 0 and len(first["losses"]) == 5
        assert np.isfinite(first["losses"]).all()
        assert sorted(os.listdir(d)) == ["LATEST", "step_000000002",
                                         "step_000000004", "step_000000005"]
        for start, stop in ((5, 8), (8, 10)):
            run = train_cli.main(argv + ["--steps", str(stop), "--resume"])
            assert run["start"] == start
            assert len(run["losses"]) == stop - start
            assert checkpoint.latest_step(d) == stop
        assert sorted(os.listdir(d)) == ["LATEST", "step_000000006",
                                         "step_000000008", "step_000000010"]
    out = capsys.readouterr().out
    assert "resumed from step 5" in out and "resumed from step 8" in out
