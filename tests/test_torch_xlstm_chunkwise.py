"""The mLSTM forward and backward in chunkwise-parallel form on the CPU.

``kernels.ref.mlstm_chunkwise_bwd_ref`` states in PyTorch the algebra the
card's backward kernel (``csrc/mlstm_scan_bwd.cu``) computes: boundary
memories per chunk, the carried gradients walked over chunks in reverse,
the intra-chunk gradients as masked products, and the stabiliser's chain.
Here it is held, on the same numpy-made inputs, to the recurrent plain
backward (``mlstm_recurrence_bwd_ref``) and to ``jax.grad`` of a
``lax.scan`` over the reference's own cell (``repro.models.ssm``
``_mlstm_cell``, the scan of ``mlstm_forward``) run in float64 on the
same fp32 values (in fp32 the reference's own rounding lies up to ~8e-6
of the largest |di| from the exact gradient where di cancels: the bar
would measure the reference).  Each gradient of the fp32 chunkwise form
lies within GRAD_TOL of its largest |element|: chunks of 4 and 16 steps; T of
1, a chunk less one and three chunks and 5; head_dims 32 and 64; the
final state's gradients carried or absent; m0 finite, m0 = -1e30 (the
zero state) and inputs with ties in the stabiliser's max; in every case
some steps with the normaliser's clamp max(|n . q|, 1) active and some
with it inactive.

``kernels.ref.mlstm_chunkwise_fwd_ref`` states the forward's chunkwise
route (``csrc/mlstm_scan.cu``: boundary memories per chunk of 64 steps,
each chunk's h as masked products) likewise: its hs and final state are
held to the recurrent plain forward (``mlstm_recurrence_ref``) and to a
float64 ``lax.scan`` of the reference's ``_mlstm_cell`` on the same fp32
values, within FWD_TOL of the largest |value|, at T 1, 63, 64, 65 and 200
(head_dim 64) and T 129 (head_dim 384), from a carried state, the zero
state and with ties in the stabiliser.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")  # the port needs PyTorch

from repro.models import ssm as rssm
from repro_torch.kernels import ref

# fp32 sums in another order than the recurrent walk's: a few ulps of the
# largest gradient over the shapes here
GRAD_TOL = 1e-5
# the forward's h and final state: fp32 sums in another order than the
# walk's (the card's chunkwise route is held to XLSTM_TOL 1e-5 likewise)
FWD_TOL = 1e-5
FWD_CHUNK = 64   # the kernel's (APEX_MLSTM_FWD_CHUNK)
B, H = 2, 2


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _inputs(rng, t, hd, kind):
    """q, k, v, i_pre, f_pre, cmat0, n0, m0 as float32 numpy arrays.  Head
    0's q is scaled up and head 1's down, so the clamp is active on some
    steps and inactive on others; with ``kind == "tie"`` i_pre equals
    f_pre + m (in fp32, as the recurrence adds them) on every third
    step."""
    f32 = np.float32
    q = rng.standard_normal((B, t, H, hd)).astype(f32)
    q[:, :, 0] *= 4.0
    q[:, :, 1] *= 0.05
    k = (rng.standard_normal((B, t, H, hd)) / np.sqrt(hd)).astype(f32)
    v = rng.standard_normal((B, t, H, hd)).astype(f32)
    i_pre = rng.standard_normal((B, t, H)).astype(f32)
    f_pre = np.log(1.0 / (1.0 + np.exp(-(rng.standard_normal((B, t, H))
                                         + 2.0)))).astype(f32)
    if kind == "zero":
        cmat0 = np.zeros((B, H, hd, hd), f32)
        n0 = np.zeros((B, H, hd), f32)
        m0 = np.full((B, H), -1e30, f32)
    else:
        cmat0 = (0.3 * rng.standard_normal((B, H, hd, hd))).astype(f32)
        n0 = (0.3 * rng.standard_normal((B, H, hd))).astype(f32)
        m0 = rng.standard_normal((B, H)).astype(f32)
    if kind == "tie":
        # gates and m0 on a grid of 1/64, so every f + m is exact in any
        # order of summation, and i_pre = f_pre + m on every third step
        f_pre = -rng.integers(1, 65, (B, t, H)).astype(f32) / 64
        i_pre = rng.integers(-128, 129, (B, t, H)).astype(f32) / 64
        m0 = rng.integers(-64, 65, (B, H)).astype(f32) / 64
        m = m0.copy()
        for s in range(t):
            a = f_pre[:, s] + m
            if s % 3 == 0:
                i_pre[:, s] = a
            m = np.maximum(a, i_pre[:, s])
    return [q, k, v, i_pre, f_pre, cmat0, n0, m0]


def _jax_loss(q, k, v, i_pre, f_pre, cmat0, n0, m0, dh, dc, dn, dm):
    def step(s, inp):
        return rssm._mlstm_cell(rssm._MLSTMInputs(*inp), s)
    xs = tuple(jnp.moveaxis(a, 1, 0) for a in (q, k, v, i_pre, f_pre))
    fin, hs = jax.lax.scan(step, rssm.MLSTMState(cmat0, n0, m0), xs)
    return (jnp.sum(jnp.moveaxis(hs, 0, 1) * dh) + jnp.sum(fin.cmat * dc)
            + jnp.sum(fin.n * dn) + jnp.sum(fin.m * dm))


_jax_grad = jax.jit(jax.grad(_jax_loss, argnums=tuple(range(8))))


def _close(got, want, name):
    scale = max(float(want.abs().max()), 1e-30)
    err = float((got - want).abs().max())
    assert err <= GRAD_TOL * scale, (name, err, scale)


@pytest.mark.parametrize("kind", ["finite", "zero", "tie"])
@pytest.mark.parametrize("carried", [True, False],
                         ids=["carried", "no_final_grad"])
@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("t_of", ["one", "chunk_less_one", "three_chunks_5"])
@pytest.mark.parametrize("chunk", [4, 16])
def test_chunkwise_bwd_matches_recurrent_and_jax_grad(chunk, t_of, hd,
                                                       carried, kind):
    t = {"one": 1, "chunk_less_one": chunk - 1,
         "three_chunks_5": 3 * chunk + 5}[t_of]
    rng = np.random.default_rng([chunk, t, hd, int(carried),
                                 ("finite", "zero", "tie").index(kind)])
    arrs = _inputs(rng, t, hd, kind)
    args = [torch.from_numpy(a) for a in arrs]
    hs = ref.mlstm_recurrence_ref(*args)[0]
    dh = rng.standard_normal((B, t, H, hd)).astype(np.float32)
    fin = [rng.standard_normal(a.shape).astype(np.float32) if carried
           else np.zeros(a.shape, np.float32) for a in arrs[5:]]
    dstate = tuple(torch.from_numpy(a) for a in fin) if carried \
        else (None, None, None)
    got = ref.mlstm_chunkwise_bwd_ref(*args, hs, torch.from_numpy(dh),
                                      dstate, chunk=chunk)
    walk = ref.mlstm_recurrence_bwd_ref(*args, hs, torch.from_numpy(dh),
                                        dstate)
    with jax.enable_x64(True):
        jgrad = [np.array(g, np.float64) for g in _jax_grad(
            *(jnp.asarray(a, jnp.float64) for a in arrs + [dh] + fin))]
    names = ("dq", "dk", "dv", "di", "df", "dcmat0", "dn0", "dm0")
    for name, g, w, j in zip(names, got, walk, jgrad):
        _close(g, w, name)
        _close(g.double(), torch.from_numpy(j), name)


def test_inputs_cover_both_sides_of_the_clamp_and_ties():
    """The inputs above put the clamp max(|n . q|, 1) on both sides and the
    stabiliser's max on a tie where asked."""
    rng = np.random.default_rng(0)
    t, hd = 53, 32
    for kind in ("finite", "zero", "tie"):
        arrs = _inputs(rng, t, hd, kind)
        q, k, v, i_pre, f_pre, cmat0, n0, m0 = (torch.from_numpy(a)
                                                for a in arrs)
        n, m, ties, above = n0, m0, 0, []
        for s in range(t):
            a = f_pre[:, s] + m
            ties += int((a == i_pre[:, s]).sum())
            m_new = torch.maximum(a, i_pre[:, s])
            i_g, f_g = torch.exp(i_pre[:, s] - m_new), torch.exp(a - m_new)
            n = f_g[..., None] * n + i_g[..., None] * k[:, s]
            above.append(torch.einsum("bhk,bhk->bh", n, q[:, s]).abs() > 1)
            m = m_new
        above = torch.stack(above)
        assert bool(above.any()) and bool((~above).any()), kind
        assert (ties > 0) == (kind == "tie"), (kind, ties)


def _jax_scan(q, k, v, i_pre, f_pre, cmat0, n0, m0):
    def step(s, inp):
        return rssm._mlstm_cell(rssm._MLSTMInputs(*inp), s)
    xs = tuple(jnp.moveaxis(a, 1, 0) for a in (q, k, v, i_pre, f_pre))
    fin, hs = jax.lax.scan(step, rssm.MLSTMState(cmat0, n0, m0), xs)
    return jnp.moveaxis(hs, 0, 1), fin.cmat, fin.n, fin.m


_jax_fwd = jax.jit(_jax_scan)


@pytest.mark.parametrize("kind", ["finite", "zero", "tie"])
@pytest.mark.parametrize("t,hd", [(1, 64), (63, 64), (64, 64), (65, 64),
                                  (200, 64), (129, 384)])
def test_chunkwise_fwd_matches_recurrent_and_jax_scan(t, hd, kind):
    rng = np.random.default_rng([t, hd, ("finite", "zero", "tie").index(
        kind), 7])
    arrs = _inputs(rng, t, hd, kind)
    args = [torch.from_numpy(a) for a in arrs]
    got = ref.mlstm_chunkwise_fwd_ref(*args, chunk=FWD_CHUNK)
    walk = ref.mlstm_recurrence_ref(*args)
    with jax.enable_x64(True):
        exact = [np.array(x, np.float64) for x in _jax_fwd(
            *(jnp.asarray(a, jnp.float64) for a in arrs))]
    for name, g, w, j in zip(("hs", "cmat", "n", "m"), got, walk, exact):
        assert g.shape == w.shape and g.dtype == torch.float32, name
        assert bool(torch.isfinite(g).all()), name
        scale = max(float(w.abs().max()), 1e-30)
        assert float((g - w).abs().max()) <= FWD_TOL * scale, name
        assert float((g.double() - torch.from_numpy(j)).abs().max()) \
            <= FWD_TOL * scale, name
