"""The selective scan's state written in place, on the CPU.

The scan takes an optional ``h_out`` (``ops.mamba_selective_scan``,
``ssm.mamba_forward``) and the Mamba block writes each layer's state
straight back into its slice of the stacked state.  Held here:

  * ``h_out`` as a view of a stacked (G, B, I, N) state -- over h0 itself
    or over another group's slice -- gives the bits of the out-of-place
    result, a row of length 0 keeps its state, the other groups are
    untouched, and both agree at 1e-5 with the JAX package's oracle and
    its Pallas kernel in interpret mode (numpy-seeded inputs);
  * malformed ``h_out`` tensors are refused;
  * a reduced hybrid decode step with the in-place write gives the
    state and logits of the block as it was (scan out of place, then a
    copy into the stack), bit for bit, with and without host rows.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")  # the port needs PyTorch

from repro.kernels.mamba_scan import mamba_selective_scan as jax_scan
from repro.kernels.mamba_scan import mamba_selective_scan_ref as jax_scan_ref
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models import (HostIO, decode_step, init_decode_state,
                                init_params, prefill)
from repro_torch.models import transformer
from repro_torch.models.config import BlockKind, FFNKind
from repro_torch.models.kv_cache import StackState

ARCH = "jamba-1.5-large-398b"


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _scan_inputs(b, t, i, n, seed=0, h0_scale=0.5):
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.standard_normal((b, t, i)))).astype(np.float32)
    x = rng.standard_normal((b, t, i)).astype(np.float32)
    bb = rng.standard_normal((b, t, n)).astype(np.float32)
    cc = rng.standard_normal((b, t, n)).astype(np.float32)
    a_neg = -np.exp(rng.standard_normal((i, n))).astype(np.float32)
    d_skip = rng.standard_normal((i,)).astype(np.float32)
    h0 = (h0_scale * rng.standard_normal((b, i, n))).astype(np.float32)
    return dt, x, bb, cc, a_neg, d_skip, h0


# ---------------------------------------------------------------------------
# h_out
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("target", ["over h0", "other group"])
def test_h_out_into_stacked_state_view(target):
    """The state of group 1 of a (G 3, B, I, N) stack, scanned with
    ``h_out`` a view of the stack: bitwise the out-of-place result; a
    row of length 0 keeps its state; the groups not written keep theirs;
    1e-5 against the Pallas kernel (interpret mode) and its oracle."""
    b, t, i, n = 4, 33, 128, 16
    arrays = _scan_inputs(b, t, i, n, seed=5)
    lens = np.array([33, 0, 20, 1], np.int32)
    tt = [torch.from_numpy(a) for a in arrays]
    tl = torch.from_numpy(lens)
    stack = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (3, b, i, n)).astype(np.float32))
    stack[1] = tt[6]
    before = stack.clone()
    y_ref, h_ref = ops.mamba_selective_scan(*tt[:6], stack[1], tl)
    assert torch.equal(stack, before)            # out of place: untouched
    dst = 1 if target == "over h0" else 2
    y, h = ops.mamba_selective_scan(*tt[:6], stack[1], tl, stack[dst])
    assert h.data_ptr() == stack[dst].data_ptr()
    assert torch.equal(y, y_ref) and torch.equal(stack[dst], h_ref)
    assert torch.equal(stack[dst][1], before[1][1])      # lens 0
    for g in {0, 1, 2} - {dst}:
        assert torch.equal(stack[g], before[g])
    j = [jnp.asarray(a) for a in arrays]
    for jy, jh in (jax_scan(*j, jnp.asarray(lens), block_i=64,
                            interpret=True),
                   jax_scan_ref(*j, jnp.asarray(lens))):
        np.testing.assert_allclose(_np(y), _np(jy), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(_np(stack[dst]), _np(jh), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("bad", ["dtype", "shape", "strided", "overlap"])
def test_h_out_refuses_malformed(bad):
    b, t, i, n = 2, 3, 64, 8
    tt = [torch.from_numpy(a) for a in _scan_inputs(b, t, i, n)]
    h0 = tt[6]
    if bad == "dtype":
        h_out = torch.empty_like(h0, dtype=torch.float64)
    elif bad == "shape":
        h_out = torch.empty((b, i, 2 * n))
    elif bad == "strided":
        h_out = torch.empty((b, n, i)).transpose(1, 2)
    else:
        wide = torch.zeros(2 * b * i * n)
        h0 = wide[:b * i * n].view(b, i, n)
        h_out = wide[n:n + b * i * n].view(b, i, n)
    with pytest.raises(ValueError, match="h_out"):
        ops.mamba_selective_scan(*tt[:6], h0, None, h_out)


# ---------------------------------------------------------------------------
# the decode step
# ---------------------------------------------------------------------------


def _copying_block(p, cfg, x, st, g, valid_lens):
    """The Mamba block as it was: the scan out of place, then both
    states copied into the stack."""
    from repro_torch.models import ssm
    h = transformer.rmsnorm(p["ln1"], x, cfg.norm_eps)
    y, new = ssm.mamba_forward(p["mamba"], cfg.mamba, h,
                               ssm.MambaState(conv=st.conv[g],
                                              ssm=st.ssm[g]), valid_lens)
    st.conv[g].copy_(new.conv)
    st.ssm[g].copy_(new.ssm)
    return transformer._ffn(p, cfg, x + y)


def _clone(state):
    return StackState(per_entry=tuple(type(e)(*(v.clone() for v in e))
                                      for e in state.per_entry),
                      lengths=state.lengths.clone())


@pytest.fixture(scope="module")
def hybrid():
    """Jamba reduced to d_model 64 with dense FFNs (16 layers, attention
    at 3 and 11), fp32, random weights: a state of two prefilled device
    rows, and the same rows with three host rows of random recurrent
    state beside them."""
    cfg = dataclasses.replace(
        get_config(ARCH).reduced(d_model=64, vocab=64),
        ffn_kind=FFNKind.DENSE, moe=None, param_dtype="float32",
        compute_dtype="float32")
    params = init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(9)
    dev = init_decode_state(cfg, device_batch=2, cache_len=32, device="cpu",
                            kv_dtype=torch.float32)
    _, dev = prefill(params, cfg, {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (2, 7)))}, dev)
    both = init_decode_state(cfg, device_batch=2, host_batch=3,
                             cache_len=32, device="cpu",
                             kv_dtype=torch.float32)
    for kind, mine, theirs in zip(cfg.block_pattern, both.per_entry,
                                  dev.per_entry):
        for a, v in zip(mine, theirs):
            if kind == BlockKind.ATTN:
                a.copy_(v)
            else:
                a[:, :2] = v
                a[:, 2:] = torch.from_numpy(0.5 * rng.standard_normal(
                    a[:, 2:].shape)).to(a.dtype)
    both = StackState(per_entry=both.per_entry, lengths=dev.lengths)
    return cfg, params, dev, both


@pytest.mark.parametrize("with_host", [False, True])
def test_decode_step_in_place_matches_copying_block(hybrid, monkeypatch,
                                                    with_host):
    """Two decode steps with the scan writing the stack's state in place
    give the logits and every state leaf of the copying block, bitwise;
    with host rows, one outside the cohort (row_valid False) and a
    window over layers 3-11."""
    cfg, params, dev, both = hybrid
    tokens = torch.tensor([5, 17])
    st, host = dev, None
    if with_host:
        rng = np.random.default_rng(4)
        st = both
        host = HostIO(
            x_carry=torch.from_numpy(
                0.5 * rng.standard_normal((3, cfg.d_model))).float(),
            positions=torch.tensor([6, 3, 9], dtype=torch.int32),
            attn_in=torch.from_numpy(rng.standard_normal(
                (3, cfg.num_heads, cfg.resolved_head_dim))).float(),
            consume_layer=3, emit_layer=11, window_start=3, window_end=11,
            row_valid=torch.tensor([True, False, True]))
    outs = []
    for block in (None, _copying_block):
        if block is not None:
            monkeypatch.setattr(transformer, "_mamba_block", block)
        state = _clone(st)
        logs = []
        for _ in range(2):
            log, state, _, _ = decode_step(params, cfg, tokens, state, host)
            logs.append(log)
        outs.append((logs, state))
    (logs_a, st_a), (logs_b, st_b) = outs
    assert all(torch.equal(a, b) for a, b in zip(logs_a, logs_b))
    for ea, eb in zip(st_a.per_entry, st_b.per_entry):
        for a, b in zip(ea, eb):
            assert torch.equal(a, b)
    assert torch.equal(st_a.lengths, st_b.lengths)
    # the steps moved the state: the comparison is not of two no-ops
    j = cfg.block_pattern.index(BlockKind.MAMBA)
    assert not torch.equal(st_a.per_entry[j].ssm, st.per_entry[j].ssm)
