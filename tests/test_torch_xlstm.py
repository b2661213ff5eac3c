"""The port's xLSTM (sLSTM and mLSTM blocks, ``xlstm-125m``) against the
JAX reference on the CPU.

The blocks take the reference's parameters and the same numpy-seeded
inputs and carried states: outputs and states match at 1e-5 in fp32 and
at 2e-2 / 3e-2 in bf16 (outputs / states; the kernel sweeps' bars), a
row of length 0 keeps its state bit for bit, and a call split in T
continues as one call.  The mLSTM block state, which the reference nests
(``MLSTMBlockState(cell=MLSTMState(cmat, n, m), conv)``), is one flat
tuple in the port in the same leaf order; every tier-move helper moves
it as the reference's does, bitwise.  The serving engine runs
``xlstm-125m`` reduced GPU-only (no KV cache, so no host tier) over the
reference's hybrid fast-path matrix (tests/test_hybrid_fastpath.py):
against the reference engine in fp32 (at bf16 the packages round fused
intermediates differently: tests/test_torch_archs.py), and against its
own per-request whole-prompt path in bf16, as the reference's matrix
holds itself.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
torch = pytest.importorskip("torch")  # the port needs PyTorch

from repro.configs import get_config as ref_get_config
from repro.models import init_decode_state as ref_state
from repro.models import init_params as ref_init
from repro.models import ssm as rssm
from repro.models.kv_cache import StackState as RefStackState
from repro.serving import Engine as RefEngine
from repro.serving import EngineConfig as RefEngineConfig
from repro.serving import Request as RefRequest
from repro.serving import tiermove as rtm
from repro_torch.configs import get_config
from repro_torch.models import init_decode_state, params_from_numpy
from repro_torch.models import ssm
from repro_torch.models.config import BlockKind
from repro_torch.models.kv_cache import AttnKV, StackState
from repro_torch.serving import Engine, EngineConfig, Request
from repro_torch.serving import tiermove as tm

ARCH = "xlstm-125m"
D, H = 64, 4
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 3e-2)}


def _leaf(a):
    """A reference array as a torch tensor (bf16 bit for bit)."""
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _block(kind, dtype):
    """(reference params, port params) of one block: the reference's
    init, carried across leaf by leaf."""
    init = getattr(rssm, f"{kind}_init")
    rparams = init(jax.random.PRNGKey(3), D, H, jnp.dtype(dtype))
    return rparams, {k: _leaf(v) for k, v in rparams.items()}


def _states(kind, b, rng, rparams=None):
    """(reference state, port state) for ``b`` rows: the zero init, or,
    given the block's reference parameters, the carry the reference
    leaves after six tokens of a prompt."""
    if kind == "slstm":
        ref = rssm.slstm_init_state(D, H, b)
    else:
        ref = rssm.mlstm_block_init_state(D, H, b)
    if rparams is not None:
        x = rng.standard_normal((b, 6, D)).astype(np.float32)
        dtype = rparams["down_proj"].dtype
        _, ref = getattr(rssm, f"{kind}_forward")(
            rparams, jnp.asarray(x, dtype), ref, H)
    cls = ssm.SLSTMState if kind == "slstm" else ssm.MLSTMState
    return ref, cls(*(_leaf(a) for a in jax.tree.leaves(ref)))


def _forward(kind, chunk=False):
    name = f"{kind}_forward" + ("_chunk" if chunk else "")
    return getattr(rssm, name), getattr(ssm, name)


def _assert_state(ours, ref, tol):
    for a, r in zip(ours, jax.tree.leaves(ref)):
        np.testing.assert_allclose(_np(a), _np(r), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["slstm", "mlstm"])
def test_block_matches_reference_with_frozen_rows(kind, dtype):
    """From the zero state, rows of lengths 9, 4 and 0 in a T 9 window:
    outputs and states as the reference's; the length-0 row's state
    (the -1e30 stabiliser included) is bitwise the state passed in."""
    rparams, params = _block(kind, dtype)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 9, D)).astype(np.float32)
    lens = np.array([9, 4, 0], np.int32)
    rst, st = _states(kind, 3, rng)
    ref_fwd, fwd = _forward(kind)
    ry, rnew = ref_fwd(rparams, jnp.asarray(x, dtype), rst, H,
                       valid_lens=jnp.asarray(lens))
    y, new = fwd(params, torch.from_numpy(x).to(getattr(torch, dtype)), st,
                 H, torch.from_numpy(lens))
    y_tol, s_tol = TOL[dtype]
    assert y.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_np(y), _np(ry), rtol=y_tol, atol=y_tol)
    _assert_state(new, rnew, s_tol)
    for a, old in zip(new, st):
        assert torch.equal(a[2], old[2])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["slstm", "mlstm"])
def test_chunk_form_matches_reference_from_a_carry(kind, dtype):
    """The chunk-continuation entry point from a carried state at absolute
    offsets (unused by a recurrence), rows of 5, 1 and 0 tokens."""
    rparams, params = _block(kind, dtype)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 5, D)).astype(np.float32)
    lens = np.array([5, 1, 0], np.int32)
    off = np.array([7, 30, 2], np.int32)
    rst, st = _states(kind, 3, rng, rparams)
    ref_fwd, fwd = _forward(kind, chunk=True)
    ry, rnew = ref_fwd(rparams, jnp.asarray(x, dtype), rst, H,
                       jnp.asarray(lens), q_offset=jnp.asarray(off))
    y, new = fwd(params, torch.from_numpy(x).to(getattr(torch, dtype)), st,
                 H, torch.from_numpy(lens), q_offset=torch.from_numpy(off))
    y_tol, s_tol = TOL[dtype]
    np.testing.assert_allclose(_np(y[:, :1]), _np(ry[:, :1]), rtol=y_tol,
                               atol=y_tol)
    np.testing.assert_allclose(_np(y[0]), _np(ry[0]), rtol=y_tol,
                               atol=y_tol)
    _assert_state(new, rnew, s_tol)
    for a, old in zip(new, st):
        assert torch.equal(a[2], old[2])


@pytest.mark.parametrize("kind", ["slstm", "mlstm"])
def test_split_in_t_continues_as_one_call(kind):
    """Ten tokens in one call against 4 then 6 with the state carried
    between (rows of lengths 10 and 7: the second row freezes inside the
    second call), bitwise.  At bf16 parameters: with fp32 ones the mLSTM
    conv window, stored in bf16 between calls as in the reference, rounds
    where one call keeps fp32 values (1e-3 apart here; the same holds for
    Mamba, ROADMAP queue 3)."""
    rparams, params = _block(kind, "bfloat16")
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((2, 10, D)).astype(
        np.float32)).to(torch.bfloat16)
    _, st = _states(kind, 2, rng, rparams)
    _, fwd = _forward(kind, chunk=True)
    lens = torch.tensor([10, 7], dtype=torch.int32)
    y, whole = fwd(params, x, st, H, lens)
    y1, mid = fwd(params, x[:, :4], st, H, torch.tensor([4, 4],
                                                         dtype=torch.int32))
    y2, last = fwd(params, x[:, 4:], mid, H, lens - 4)
    assert torch.equal(torch.cat([y1, y2], 1)[0], y[0])
    assert torch.equal(torch.cat([y1, y2], 1)[1, :7], y[1, :7])
    for a, b in zip(last, whole):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# tier moves on the nested mLSTM state
# ---------------------------------------------------------------------------


def _stack_pair(seed):
    """A reference StackState of xlstm-125m reduced (mLSTM + sLSTM, two
    groups) over 2 device + 2 host rows filled with random values, and
    the port's copy."""
    cfg = get_config(ARCH).reduced(d_model=D, vocab=64)
    rst = ref_state(ref_get_config(ARCH).reduced(d_model=D, vocab=64),
                    device_batch=2, host_batch=2, cache_len=16)
    rng = np.random.default_rng(seed)
    entries = tuple(jax.tree.map(
        lambda a: jnp.asarray((rng.standard_normal(a.shape)).astype(a.dtype)),
        e) for e in rst.per_entry)
    rst = RefStackState(per_entry=entries,
                        lengths=jnp.asarray([5, 3], jnp.int32))
    return cfg, rst, _port(cfg, rst)


def _port(cfg, rst):
    cls = {BlockKind.SLSTM: ssm.SLSTMState, BlockKind.MLSTM: ssm.MLSTMState,
           BlockKind.ATTN: AttnKV}
    return StackState(per_entry=tuple(
        cls[kind](*(_leaf(a) for a in jax.tree.leaves(e)))
        for kind, e in zip(cfg.block_pattern, rst.per_entry)),
        lengths=_leaf(rst.lengths))


def _assert_bitwise(st, rst):
    assert [k.value for k in get_config(ARCH).block_pattern] == \
        ["mlstm", "slstm"]
    for e, re in zip(st.per_entry, rst.per_entry):
        leaves = jax.tree.leaves(re)
        assert len(e) == len(leaves)
        for a, r in zip(e, leaves):
            np.testing.assert_array_equal(_np(a), _np(r))
    np.testing.assert_array_equal(st.lengths.numpy(), np.asarray(rst.lengths))


MOVES = {
    # name: (port move in place, the reference's move returning a state)
    "splice": (lambda cfg, st, src: tm.splice_recurrent_rows(
        cfg, st, src.per_entry, 3, 0),
        lambda cfg, st, src: rtm.splice_recurrent_rows(
            cfg, st, src.per_entry, 3, 0)),
    "zero": (lambda cfg, st, src: tm.zero_recurrent_rows(cfg, st, [1, 2]),
             lambda cfg, st, src: rtm.zero_recurrent_rows(cfg, st, [1, 2])),
    "copy_row": (lambda cfg, st, src: tm.copy_state_row(cfg, st, src, 2, 1,
                                                        4),
                 lambda cfg, st, src: rtm.copy_state_row(cfg, st, src, 2, 1,
                                                         4)),
    "demote": (lambda cfg, st, src: tm.demote_slot_to_host_row(cfg, st, 1, 3),
               lambda cfg, st, src: rtm.demote_slot_to_host_row(cfg, st, 1,
                                                                3)),
    "upload": (lambda cfg, st, src: tm.upload_host_kv_to_slot(
        cfg, st, [], 0, 6, 2),
        lambda cfg, st, src: rtm.upload_host_kv_to_slot(cfg, st, [], 0, 6,
                                                        2)),
}


@pytest.mark.parametrize("move", list(MOVES))
def test_tier_moves_match_reference_on_the_xlstm_state(move):
    """Each row move on both packages' states (a second random state as
    the source where the move takes one): every leaf, the mLSTM matrix
    memory, normaliser, stabiliser and bf16 conv window included, and
    the lengths bitwise equal afterwards."""
    cfg, rst, st = _stack_pair(0)
    _, rsrc, src = _stack_pair(1)
    ours, theirs = MOVES[move]
    ours(cfg, st, src)
    rcfg = ref_get_config(ARCH).reduced(d_model=D, vocab=64)
    _assert_bitwise(st, theirs(rcfg, rst, rsrc))


def test_recurrent_snapshot_round_trip_matches_reference():
    """A prefix-cache carry: the snapshot of row 1 holds the reference's
    values, leaves in its order, in storage of its own; restored into
    row 3 it leaves the state the reference's restore leaves."""
    cfg, rst, st = _stack_pair(2)
    rcfg = ref_get_config(ARCH).reduced(d_model=D, vocab=64)
    snap = tm.snapshot_recurrent_row(cfg, st, 1)
    rsnap = rtm.snapshot_recurrent_row(rcfg, rst, 1)
    for mine, theirs in zip(snap, rsnap):
        for a, r in zip(mine, jax.tree.leaves(theirs)):
            np.testing.assert_array_equal(_np(a), _np(r))
    st.per_entry[0].cmat[:, 1] += 1.0          # the snapshot is a copy
    assert not torch.equal(snap[0][0], st.per_entry[0].cmat[:, 1])
    tm.set_recurrent_row(cfg, st, 3, snap)
    rst = rtm.set_recurrent_row(rcfg, rst, 3, rsnap)
    for j in range(2):
        for a, r in zip(st.per_entry[j], jax.tree.leaves(rst.per_entry[j])):
            np.testing.assert_array_equal(_np(a[:, 3]), _np(r[:, 3]))


# ---------------------------------------------------------------------------
# the serving engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def xlstm(request):
    """(reference cfg, reference params, port cfg, port params) of
    xlstm-125m reduced to d_model 64, vocab 64, 4 layers."""
    kw = dict(param_dtype=request.param, compute_dtype=request.param)
    rcfg, cfg = (dataclasses.replace(
        get(ARCH).reduced(d_model=D, vocab=64), **kw)
        for get in (ref_get_config, get_config))
    rparams = ref_init(jax.random.PRNGKey(0), rcfg)
    return rcfg, rparams, cfg, params_from_numpy(
        cfg, jax.tree.map(np.asarray, rparams), "cpu")


def _streams(engine, protos, request_cls, max_new=6):
    reqs = [request_cls(prompt=list(p), max_new_tokens=max_new)
            for p in protos]
    stats = engine.run(reqs)
    engine.shutdown()
    return [r.output for r in reqs], stats


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 64, (n,)).tolist() for n in lengths]


# the reference's fast-path matrix (tests/test_hybrid_fastpath.py): the
# engine settings of each cell and its prompts
MATRIX = {
    "bucketed": (dict(device_slots=5, cache_len=64, chunk_tokens=0),
                 (0, [5, 11, 3, 17, 8])),
    "chunk1": (dict(device_slots=2, host_slots=4, cache_len=64,
                    chunk_tokens=1), (2, [5, 11, 3, 17])),
    "chunk16": (dict(device_slots=2, host_slots=4, cache_len=64,
                     chunk_tokens=16), (2, [5, 11, 3, 17])),
    "staging_reuse": (dict(device_slots=2, cache_len=64, chunk_tokens=8),
                      (5, [7, 9, 5, 12, 6, 10])),
    "migration": (dict(device_slots=1, host_slots=2, cache_len=64,
                       chunk_tokens=4, preemption=False), (3, [5, 5, 5])),
    # one slot: each turn is admitted after the last retired and
    # published its prompt
    "prefix_on": (dict(device_slots=1, cache_len=64, chunk_tokens=8),
                  (6, None)),
    "prefix_off": (dict(device_slots=1, cache_len=64, chunk_tokens=8,
                        prefix_cache=False), (6, None)),
}


def _cell_prompts(cell):
    seed, lengths = MATRIX[cell][1]
    if lengths is not None:
        return _prompts(seed, lengths)
    # turns of one conversation, each prompt extending the last: a
    # recurrent stack's cache hits whole entries only (their carry holds
    # the state at the entry's end)
    turns, prompt = [], _prompts(seed, [12])[0]
    for extra in _prompts(seed + 1, [3, 5, 4, 6]):
        prompt = prompt + extra
        turns.append(prompt)
    return turns


@pytest.mark.parametrize("cell", list(MATRIX))
def test_engine_matches_reference_engine(xlstm, cell):
    """fp32: the port's engine and the reference's give the same greedy
    streams in every cell (offload is off in both: no KV cache).  bf16:
    the port's fast path gives its own per-request whole-prompt path's
    streams, as the reference's matrix holds itself."""
    rcfg, rparams, cfg, params = xlstm
    kw = dict(MATRIX[cell][0])
    protos = _cell_prompts(cell)
    out, stats = _streams(Engine(cfg, params, EngineConfig(
        **kw, device="cpu")), protos, Request)
    assert all(len(o) == 6 for o in out)
    assert stats.host_tokens == 0
    if cell == "prefix_on":
        assert stats.prefix_hits > 0
    if cfg.param_dtype == "float32":
        ref_out, _ = _streams(RefEngine(rcfg, rparams,
                                        RefEngineConfig(**kw)),
                              protos, RefRequest)
    else:
        ref_out, _ = _streams(Engine(cfg, params, EngineConfig(
            device_slots=kw["device_slots"], cache_len=64,
            bucketed_prefill=False, chunk_tokens=0, device="cpu")), protos,
            Request)
    assert out == ref_out


def test_engine_preemption_matches_reference_engine(xlstm):
    """The matrix's preemption cell: two low-priority residents, then an
    urgent request (priority 1) with preemption on.  Without a host tier
    nothing is preempted; every stream equals the reference engine's
    (fp32) or the port's own run with preemption off (bf16)."""
    rcfg, rparams, cfg, params = xlstm
    rng = np.random.default_rng(4)
    lows = [rng.integers(1, 64, (8,)).tolist() for _ in range(2)]
    urgent = rng.integers(1, 64, (30,)).tolist()

    def run(engine, request_cls):
        ls = [request_cls(prompt=list(p), max_new_tokens=20) for p in lows]
        u = request_cls(prompt=list(urgent), max_new_tokens=5, priority=1,
                        deadline=120.0)
        try:
            engine.run(ls, max_iterations=4)
            engine.submit(u)
            for _ in range(3000):
                if not engine.has_work:
                    break
                engine.step()
        finally:
            engine.shutdown()
        return [r.output for r in ls + [u]], engine.stats

    kw = dict(device_slots=2, host_slots=4, cache_len=64, page_size=32,
              host_pool_pages=2, chunk_tokens=8)
    out, stats = run(Engine(cfg, params, EngineConfig(
        **kw, preemption=True, device="cpu")), Request)
    assert stats.preemptions == 0 and stats.host_tokens == 0
    if cfg.param_dtype == "float32":
        ref_out, _ = run(RefEngine(rcfg, rparams, RefEngineConfig(
            **kw, preemption=True)), RefRequest)
    else:
        ref_out, _ = run(Engine(cfg, params, EngineConfig(
            **kw, preemption=False, device="cpu")), Request)
    assert out == ref_out
    assert [len(o) for o in out] == [20, 20, 5]


def test_offload_is_forced_off(xlstm):
    """No KV cache, so APEX's host tier has nothing to hold: the engine
    turns offload off whatever it was given, as the reference's does,
    and its recurrent state spans the device rows only."""
    rcfg, rparams, cfg, params = xlstm
    assert not cfg.has_kv_cache and cfg.is_recurrent_decode
    eng = Engine(cfg, params, EngineConfig(device_slots=2, host_slots=4,
                                           enable_offload=True,
                                           device="cpu"))
    ref = RefEngine(rcfg, rparams, RefEngineConfig(device_slots=2,
                                                   host_slots=4,
                                                   enable_offload=True))
    try:
        assert eng.e.enable_offload is False
        assert ref.e.enable_offload is False
        assert eng.executor is None
        for e in eng.state.per_entry:
            assert all(a.shape[1] == 2 for a in e)
    finally:
        eng.shutdown()
        ref.shutdown()
