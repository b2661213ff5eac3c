"""The xLSTM recurrences as kernel ops (``kernels.ops.slstm_recurrence``
/ ``mlstm_recurrence``) on the CPU.

The ops route a CPU tensor to the plain loops of ``kernels.ref`` (the
blocks' results unchanged bit for bit) and a ``meta`` tensor to shapes
only, noted for the dry-run's cost count.  A call that needs a gradient
goes through ``SLSTMFn`` / ``MLSTMFn``, whose CPU backward is the
written-out reverse walk: the sLSTM and mLSTM blocks' gradients (every
parameter, the input and the carried state) are held to the reference's
``jax.grad`` of ``slstm_forward`` / ``mlstm_forward`` at the reduced
width in fp32, each within 1e-4 of its leaf's largest |gradient|; the
plain backward functions to PyTorch's autograd of the plain forwards.
Frozen rows keep their state bit for bit, and a call split in T with the
state carried gives the bits of one call.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")  # the port needs PyTorch

from repro.models import ssm as rssm
from repro_torch.kernels import ops, ref, xlstm
from repro_torch.launch import analysis
from repro_torch.models import ssm

D, H = 64, 4            # reduced width: sLSTM hd 16, mLSTM inner 128, hd 32
GRAD_TOL = 1e-4         # of each leaf's largest |gradient|


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _slstm_args(rng, b, t, nh, hd, carried=True):
    """gates_x, r, bias, c, n, h, m of a carried (or the zero) state."""
    d = nh * hd
    gx = _t(rng.standard_normal((b, t, 4 * d)))
    r = _t(rng.standard_normal((nh, hd, 4 * hd)) / np.sqrt(hd))
    bias = _t(0.1 * rng.standard_normal(4 * d))
    if carried:
        st = [_t(rng.standard_normal((b, nh, hd))),
              _t(rng.uniform(0.5, 2.0, (b, nh, hd))),
              _t(rng.standard_normal((b, nh, hd))),
              _t(rng.standard_normal((b, nh, hd)))]
    else:
        st = [torch.zeros(b, nh, hd) for _ in range(3)] + [
            torch.full((b, nh, hd), ssm.M_INIT)]
    return [gx, r, bias] + st


def _mlstm_args(rng, b, t, nh, hd, carried=True):
    """q, k, v, i_pre, f_pre, cmat, n, m."""
    q, k, v = (_t(rng.standard_normal((b, t, nh, hd))) for _ in range(3))
    k = k / np.sqrt(hd)
    i_pre = _t(rng.standard_normal((b, t, nh)))
    f_pre = torch.nn.functional.logsigmoid(
        _t(rng.standard_normal((b, t, nh)) + 2.0))
    if carried:
        st = [_t(0.3 * rng.standard_normal((b, nh, hd, hd))),
              _t(0.3 * rng.standard_normal((b, nh, hd))),
              _t(rng.standard_normal((b, nh)))]
    else:
        st = [torch.zeros(b, nh, hd, hd), torch.zeros(b, nh, hd),
              torch.full((b, nh), ssm.M_INIT)]
    return [q, k, v, i_pre, f_pre] + st


# ---------------------------------------------------------------------------
# Routing: CPU -> the plain loops, meta -> shapes only
# ---------------------------------------------------------------------------


def test_ops_route_cpu_to_plain_and_meta_to_shapes():
    rng = np.random.default_rng(0)
    lens = torch.tensor([5, 2, 0], dtype=torch.int32)
    sargs = _slstm_args(rng, 3, 5, 2, 16)
    got = ops.slstm_recurrence(*sargs, lens)
    want = ref.slstm_recurrence_ref(*sargs, lens)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    margs = _mlstm_args(rng, 3, 5, 2, 32)
    got = ops.mlstm_recurrence(*margs, lens)
    want = ref.mlstm_recurrence_ref(*margs, lens)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with ops.record_meta_calls() as calls:
        mout = ops.slstm_recurrence(*[a.to("meta") for a in sargs],
                                    lens.to("meta"))
        mmout = ops.mlstm_recurrence(*[a.to("meta") for a in margs],
                                     lens.to("meta"))
    for m_, w in zip(mout + mmout, ref.slstm_recurrence_ref(*sargs, lens)
                     + ref.mlstm_recurrence_ref(*margs, lens)):
        assert (m_.shape, m_.dtype, m_.device.type) == (w.shape, w.dtype,
                                                        "meta")
    assert [c[0] for c in calls] == ["slstm_recurrence", "mlstm_recurrence"]
    flops, nbytes = analysis.kernel_costs(calls)
    assert flops > 0 and nbytes > 0


def test_meta_gradient_rules_note_both_directions():
    rng = np.random.default_rng(1)
    sargs = [a.to("meta").requires_grad_(True)
             for a in _slstm_args(rng, 2, 4, 2, 16)]
    margs = [a.to("meta").requires_grad_(True)
             for a in _mlstm_args(rng, 2, 4, 2, 32)]
    with ops.record_meta_calls() as calls:
        hs = ops.slstm_recurrence(*sargs)[0]
        gs = torch.autograd.grad(hs.sum(), sargs)
        hm = ops.mlstm_recurrence(*margs)[0]
        gm = torch.autograd.grad(hm.sum(), margs)
    for g, a in zip(gs + gm, sargs + margs):
        assert g.shape == a.shape and g.device.type == "meta"
    assert [c[0] for c in calls] == [
        "slstm_recurrence", "slstm_recurrence_bwd", "mlstm_recurrence",
        "mlstm_recurrence_bwd"]
    assert dict(calls)["slstm_recurrence"]["save"] is True


def test_kernel_costs_of_the_recurrences():
    b, t, nh, hd = 2, 8, 4, 192
    calls = [("slstm_recurrence", dict(gates=(b, t, 4 * nh * hd),
                                       state=(b, nh, hd),
                                       dtype=torch.bfloat16, save=False)),
             ("mlstm_recurrence", dict(q=(b, t, nh, 384),
                                       dtype=torch.float32))]
    flops, _ = analysis.kernel_costs(calls[:1])
    assert flops == 2.0 * b * t * nh * hd * 4 * hd \
        + analysis.SLSTM_POINT_FLOPS * b * t * nh * hd
    # the mLSTM's arithmetic per step and (row, head), counted as the
    # function needs it: forward f C + (i v) k and C q over the memory,
    # i v, n, n . q and h over the vectors; backward the memory rebuilt
    # once and five products and f dC over it, four times the vectors'
    hd = 384
    flops, _ = analysis.kernel_costs(calls[1:])
    assert flops == b * t * nh * ((3 + 2) * hd * hd + (1 + 3 + 2 + 1) * hd)
    flops, _ = analysis.kernel_costs([("mlstm_recurrence_bwd",
                                       calls[1][1])])
    assert flops == b * t * nh * ((3 + 2 * 5 + 1) * hd * hd
                                  + 4 * (1 + 3 + 2 + 1) * hd)


def test_gradients_with_lens_are_refused():
    rng = np.random.default_rng(2)
    sargs = _slstm_args(rng, 2, 3, 2, 16)
    sargs[0].requires_grad_(True)
    with pytest.raises(ValueError, match="no gradient with lens"):
        ops.slstm_recurrence(*sargs, torch.tensor([3, 1]))
    margs = _mlstm_args(rng, 2, 3, 2, 32)
    margs[0].requires_grad_(True)
    with pytest.raises(ValueError, match="no gradient with lens"):
        ops.mlstm_recurrence(*margs, torch.tensor([3, 1]))


# ---------------------------------------------------------------------------
# Frozen rows and split-in-T continuation on the plain path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["slstm", "mlstm"])
def test_frozen_rows_and_split_in_t_are_bitwise(kind):
    rng = np.random.default_rng(3)
    if kind == "slstm":
        args, nstate, op = _slstm_args(rng, 3, 9, 2, 16), 4, \
            ops.slstm_recurrence
    else:
        args, nstate, op = _mlstm_args(rng, 3, 9, 2, 32), 3, \
            ops.mlstm_recurrence
    nseq = 1 if kind == "slstm" else 5
    seq, rest, state = args[:nseq], args[nseq:-nstate], args[-nstate:]
    lens = torch.tensor([9, 4, 0], dtype=torch.int32)
    whole = op(*seq, *rest, *state, lens)
    # a row of length 0 keeps its state bit for bit; a row of length 4
    # ends where its own 4-token call ends (the CPU's products may sum in
    # another order at another batch size: to 1e-6)
    for a, s0 in zip(whole[1:], state):
        assert torch.equal(a[2], s0[2])
    short = op(*[x[1:2, :4] for x in seq], *rest,
               *[s[1:2] for s in state])
    for a, b in zip(whole[1:], short[1:]):
        torch.testing.assert_close(a[1:2], b, rtol=1e-6, atol=1e-6)
    # past its length the sLSTM emits its frozen h; the mLSTM row 0's
    # h is its own
    if kind == "slstm":
        assert torch.equal(whole[0][1, 4:], whole[3][1:2].expand(5, -1, -1))
    for cut in (1, 4, 8):
        first = op(*[x[:, :cut] for x in seq], *rest, *state,
                   torch.clamp(lens, max=cut))
        second = op(*[x[:, cut:] for x in seq], *rest, *first[1:],
                    torch.clamp(lens - cut, min=0))
        for a, b in zip(whole[1:], second[1:]):
            assert torch.equal(a, b)
        assert torch.equal(torch.cat([first[0], second[0]], dim=1),
                           whole[0])


# ---------------------------------------------------------------------------
# The plain backward functions against autograd of the plain forwards
# ---------------------------------------------------------------------------


def _close(got, want, tol=GRAD_TOL):
    scale = max(float(want.abs().max()), 1e-30)
    err = float((got - want).abs().max())
    assert err <= tol * scale, (err, scale)


@pytest.mark.parametrize("carried", [True, False], ids=["carried", "zero"])
def test_plain_backwards_match_autograd(carried):
    rng = np.random.default_rng(4)
    sargs = [a.requires_grad_(True)
             for a in _slstm_args(rng, 2, 6, 2, 16, carried)]
    outs = ref.slstm_recurrence_ref(*sargs, save=True)
    cots = [_t(rng.standard_normal(o.shape)) for o in outs[:5]]
    want = torch.autograd.grad(outs[:5], sargs, cots, allow_unused=True)
    _, r, bias, c0, n0, h0, m0 = (a.detach() for a in sargs)
    hs, _, _, _, _, acts, cs, ns, ms = (o.detach() for o in outs)
    dacts, *g0 = ref.slstm_recurrence_bwd_ref(
        r, acts, cs, ns, ms, c0, n0, m0, cots[0], tuple(cots[1:]))
    dr, dbias = xlstm._slstm_dparams(r, bias, h0, hs, dacts)
    got = [dacts.reshape(sargs[0].shape), dr, dbias] + g0
    for g, w in zip(got, want):
        _close(g, w if w is not None else torch.zeros_like(g))
    margs = [a.requires_grad_(True)
             for a in _mlstm_args(rng, 2, 6, 2, 32, carried)]
    outs = ref.mlstm_recurrence_ref(*margs)
    cots = [_t(rng.standard_normal(o.shape)) for o in outs]
    want = torch.autograd.grad(outs, margs, cots, allow_unused=True)
    got = ref.mlstm_recurrence_bwd_ref(
        *[a.detach() for a in margs], outs[0].detach(), cots[0],
        tuple(cots[1:]))
    for g, w in zip(got, want):
        _close(g, w if w is not None else torch.zeros_like(g))


# ---------------------------------------------------------------------------
# The blocks' gradients against the reference's jax.grad
# ---------------------------------------------------------------------------


def _block_case(kind, rng, b, t):
    init = getattr(rssm, f"{kind}_init")
    rparams = init(jax.random.PRNGKey(5), D, H, jnp.float32)
    x = rng.standard_normal((b, t, D)).astype(np.float32)
    if kind == "slstm":
        rstate = rssm.SLSTMState(
            c=rng.standard_normal((b, H, D // H)).astype(np.float32),
            n=rng.uniform(0.5, 2.0, (b, H, D // H)).astype(np.float32),
            h=rng.standard_normal((b, H, D // H)).astype(np.float32),
            m=rng.standard_normal((b, H, D // H)).astype(np.float32))
    else:
        hd = 2 * D // H
        rstate = rssm.MLSTMBlockState(
            cell=rssm.MLSTMState(
                cmat=(0.3 * rng.standard_normal((b, H, hd, hd))
                      ).astype(np.float32),
                n=(0.3 * rng.standard_normal((b, H, hd))).astype(np.float32),
                m=rng.standard_normal((b, H)).astype(np.float32)),
            conv=jnp.asarray(rng.standard_normal((b, 3, 2 * D)),
                             jnp.bfloat16))
    return rparams, x, rstate


@pytest.mark.parametrize("kind", ["slstm", "mlstm"])
def test_block_gradients_match_reference_jax_grad(kind):
    rng = np.random.default_rng(6)
    b, t = 2, 7
    rparams, x, rstate = _block_case(kind, rng, b, t)
    wy = rng.standard_normal((b, t, D)).astype(np.float32)
    cell = rstate if kind == "slstm" else rstate.cell
    wst = [rng.standard_normal(np.shape(a)).astype(np.float32)
           for a in cell]

    def ref_loss(p, xx, st):
        full = st if kind == "slstm" else rssm.MLSTMBlockState(
            cell=st, conv=rstate.conv)
        y, fin = getattr(rssm, f"{kind}_forward")(p, xx, full, H)
        fcell = fin if kind == "slstm" else fin.cell
        return jnp.sum(y * wy) + sum(jnp.sum(a * w)
                                     for a, w in zip(fcell, wst))

    rg = jax.grad(ref_loss, argnums=(0, 1, 2))(rparams, jnp.asarray(x),
                                              cell)
    params = {k: _t(v).requires_grad_(True) for k, v in rparams.items()}
    xt = _t(x).requires_grad_(True)
    st = [_t(a).requires_grad_(True) for a in cell]
    if kind == "slstm":
        state = ssm.SLSTMState(*st)
    else:
        conv = torch.from_numpy(np.asarray(rstate.conv).view(np.uint16)
                                .copy()).view(torch.bfloat16)
        state = ssm.MLSTMState(*st, conv=conv)
    y, fin = getattr(ssm, f"{kind}_forward")(params, xt, state, H)
    loss = (y * _t(wy)).sum() + sum((a * _t(w)).sum()
                                    for a, w in zip(fin, wst))
    grads = torch.autograd.grad(loss, list(params.values()) + [xt] + st)
    want = [rg[0][k] for k in params] + [rg[1]] + list(rg[2])
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        _close(g, _t(w))
