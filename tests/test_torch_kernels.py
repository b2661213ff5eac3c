"""The port's attention entry points against the JAX reference on the CPU.

Inputs come from numpy seeds and go through both packages: the port's
plain PyTorch versions (what ``kernels.ops`` runs for CPU tensors) are
held against ``repro.kernels.ref`` over the reference's own sweeps and
tolerances (tests/test_kernels.py), and in fp32 on part of each sweep
against the Pallas kernels run in interpret mode.  The CUDA kernels
themselves run only on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
torch = pytest.importorskip("torch")  # the port needs PyTorch

from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention as pallas_decode
from repro.kernels.host_paged_attention import \
    host_paged_attention_numpy as ref_host_paged
from repro.kernels.prefill_attention import prefill_attention as pallas_prefill
from repro_torch.kernels import ops, ref
from repro_torch.kernels.decode_attention import (CTAS_PER_SM, TILE,
                                                  decode_attention_cuda,
                                                  plan_splits, split_bounds)
from repro_torch.kernels.host_paged_attention import \
    host_paged_attention_numpy
from repro_torch.kernels.prefill_attention import prefill_attention_cuda

DECODE_SWEEP = [
    # (B, H, KV, D, S, block_s) -- the reference's sweep
    (1, 4, 4, 64, 128, 64),        # MHA
    (2, 8, 2, 64, 512, 256),       # GQA 4:1
    (3, 8, 1, 128, 384, 128),      # MQA, non-pow2 batch, pad path
    (2, 16, 8, 128, 1024, 512),    # wide
]
PREFILL_SWEEP = [
    # (B, T, H, KV, D, BQ, BK, causal)
    (1, 128, 4, 4, 64, 64, 64, True),
    (2, 256, 8, 2, 64, 128, 128, True),
    (1, 200, 4, 1, 64, 128, 64, True),     # padding path
    (2, 128, 4, 4, 64, 64, 128, False),    # encoder
]
CHUNK_SWEEP = [
    # (B, T_chunk, S_cache, H, KV, D, BQ, BK)
    (2, 64, 160, 4, 2, 64, 32, 64),
    (1, 32, 96, 4, 1, 64, 32, 32),
]
# Cases also run through the interpret-mode Pallas kernels (fp32; about
# 2.5 s each on the CPU).  The rest are held to the jnp oracle, which
# tests/test_kernels.py holds to the same Pallas kernels.
PALLAS_DECODE = {DECODE_SWEEP[0], DECODE_SWEEP[2]}
PALLAS_PREFILL = {PREFILL_SWEEP[0], PREFILL_SWEEP[2], PREFILL_SWEEP[3]}
DTYPES = {"float32": (np.float32, jnp.float32, torch.float32, 1e-5),
          "bfloat16": (ml_dtypes.bfloat16, jnp.bfloat16, torch.bfloat16,
                       None)}


def _pair(a: np.ndarray, dtype: str):
    """The same values as a jax array and a torch tensor of ``dtype``."""
    np_dt, jnp_dt, torch_dt, _ = DTYPES[dtype]
    a = np.asarray(a, np.float32).astype(np_dt)
    if dtype == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return jnp.asarray(a, jnp_dt), t


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("b,h,kv,d,s,bs", DECODE_SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_ref_matches_reference(b, h, kv, d, s, bs, dtype):
    rng = np.random.default_rng(s + b)
    qj, qt = _pair(rng.standard_normal((b, h, d)), dtype)
    kj, kt = _pair(rng.standard_normal((b, s, kv, d)), dtype)
    vj, vt = _pair(rng.standard_normal((b, s, kv, d)), dtype)
    lengths = rng.integers(1, s + 1, b).astype(np.int32)
    out = ref.decode_attention_ref(qt, kt, vt, torch.from_numpy(lengths))
    assert out.dtype == qt.dtype and out.shape == (b, h, d)
    expect = jref.decode_attention_ref(qj, kj, vj, jnp.asarray(lengths))
    tol = DTYPES[dtype][3] or 2e-2
    np.testing.assert_allclose(_f32(out), _f32(expect), atol=tol, rtol=tol)
    if dtype == "float32" and (b, h, kv, d, s, bs) in PALLAS_DECODE:
        pallas = pallas_decode(qj, kj, vj, jnp.asarray(lengths), block_s=bs,
                               interpret=True)
        np.testing.assert_allclose(_f32(out), _f32(pallas), atol=tol,
                                   rtol=tol)


@pytest.mark.parametrize("b,t,h,kv,d,bq,bk,causal", PREFILL_SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_ref_matches_reference(b, t, h, kv, d, bq, bk, causal, dtype):
    rng = np.random.default_rng(t + b)
    qj, qt = _pair(rng.standard_normal((b, t, h, d)), dtype)
    kj, kt = _pair(rng.standard_normal((b, t, kv, d)), dtype)
    vj, vt = _pair(rng.standard_normal((b, t, kv, d)), dtype)
    prefix = rng.integers(0, t // 2, b).astype(np.int32)
    out = ref.prefill_attention_ref(qt, kt, vt, torch.from_numpy(prefix),
                                    causal=causal)
    expect = jref.prefill_attention_ref(qj, kj, vj, jnp.asarray(prefix),
                                        causal=causal)
    tol = DTYPES[dtype][3] or 3e-2
    np.testing.assert_allclose(_f32(out), _f32(expect), atol=tol, rtol=tol)
    if dtype == "float32" and (b, t, h, kv, d, bq, bk, causal) \
            in PALLAS_PREFILL:
        pallas = pallas_prefill(qj, kj, vj, jnp.asarray(prefix),
                                causal=causal, block_q=bq, block_k=bk,
                                interpret=True)
        np.testing.assert_allclose(_f32(out), _f32(pallas), atol=tol,
                                   rtol=tol)


@pytest.mark.parametrize("b,t,s,h,kv,d,bq,bk", CHUNK_SWEEP)
def test_prefill_ref_chunk_offsets_match_reference(b, t, s, h, kv, d, bq, bk):
    """q_offset places each row's chunk at absolute positions."""
    rng = np.random.default_rng(s)
    qj, qt = _pair(rng.standard_normal((b, t, h, d)), "float32")
    kj, kt = _pair(rng.standard_normal((b, s, kv, d)), "float32")
    vj, vt = _pair(rng.standard_normal((b, s, kv, d)), "float32")
    off = rng.integers(0, s - t + 1, b).astype(np.int32)
    out = ref.prefill_attention_ref(qt, kt, vt, None, torch.from_numpy(off))
    expect = jref.prefill_attention_ref(qj, kj, vj, None, jnp.asarray(off))
    pallas = pallas_prefill(qj, kj, vj, None, jnp.asarray(off), block_q=bq,
                            block_k=bk, interpret=True)
    for other in (expect, pallas):
        np.testing.assert_allclose(_f32(out), _f32(other), atol=1e-5,
                                   rtol=1e-5)


def test_ops_cpu_tensors_take_the_plain_path_and_count_nothing():
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((2, 8, 64)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 96, 2, 64)).astype(
        np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 96, 2, 64)).astype(
        np.float32))
    lengths = torch.tensor([5, 96], dtype=torch.int32)
    before = (decode_attention_cuda.launches, prefill_attention_cuda.launches)
    out = ops.decode_attention(q, k, v, lengths)
    assert torch.equal(out, ref.decode_attention_ref(q, k, v, lengths))
    qp = q[:, None].expand(2, 4, 8, 64).contiguous()
    off = torch.tensor([0, 90], dtype=torch.int32)
    out = ops.prefill_attention(qp, k, v, q_offset=off)
    assert torch.equal(out, ref.prefill_attention_ref(qp, k, v, None, off))
    assert (decode_attention_cuda.launches,
            prefill_attention_cuda.launches) == before


def test_cuda_wrappers_refuse_cpu_tensors_and_bad_shapes():
    q = torch.zeros((1, 4, 64))
    k = torch.zeros((1, 8, 4, 64))
    with pytest.raises(ValueError):
        decode_attention_cuda(q, k, k, torch.ones(1, dtype=torch.int32))
    with pytest.raises(ValueError):
        prefill_attention_cuda(q[:, None], k, k)
    assert decode_attention_cuda.launches == 0


@pytest.mark.parametrize("b,kv,s,one_split", [
    (4, 8, 512, False),         # the serving path's decode (llama3.1-8b)
    (8, 8, 8192, False),        # long context
    (1, 8, 8192, False),        # one row: many splits per kv head
    (4, 8, 32, True),           # one tile of cache: one split
    (128, 8, 4096, True),       # B*KV alone fills a wave: one split
])
def test_decode_split_plan(b, kv, s, one_split):
    """The host's split count fills between half of one and one wave of
    resident CTAs on an H100's 132 SMs, unless S has no more tiles to
    split; one split where S or the batch leaves nothing to split; every
    split the kernel derives from a row's length covers [0, length)
    without gaps or overlap."""
    sms = 132
    splits = plan_splits(b, kv, s, sms)
    tiles = -(-s // TILE)
    assert 1 <= splits <= tiles
    waves = b * kv * splits / (CTAS_PER_SM * sms)
    if one_split:
        assert splits == 1
    else:
        assert waves <= 1 and (waves > 0.5 or splits == tiles)
    for length in sorted({1, 2, TILE - 1, TILE, TILE + 1, s // 3, s - 1,
                          s} & set(range(1, s + 1))):
        bounds = split_bounds(length, splits)
        assert 1 <= len(bounds) <= splits
        assert bounds[0][0] == 0 and bounds[-1][1] == length
        for (a0, a1), (b0, _) in zip(bounds, bounds[1:]):
            assert a1 == b0 and (a1 - a0) % TILE == 0
        assert all(e > a for a, e in bounds)


@pytest.mark.parametrize("b,pages,page_size", [(2, 8, 16), (3, 12, 32)])
def test_host_paged_attention_matches_reference(b, pages, page_size):
    rng = np.random.default_rng(pages)
    kv, h, d = 2, 8, 64
    pg = rng.standard_normal((2, pages, page_size, kv, d)).astype(np.float32)
    per = pages // b
    pt = rng.permutation(pages)[: b * per].reshape(b, per).astype(np.int32)
    lengths = rng.integers(1, per * page_size + 1, b).astype(np.int32)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    out = host_paged_attention_numpy(q, pg, pt, lengths, page_size=page_size)
    np.testing.assert_array_equal(
        out, ref_host_paged(q, pg, pt, lengths, page_size=page_size))
    np.testing.assert_allclose(
        out, jref.host_paged_attention_ref(q, pg, pt, lengths,
                                           page_size=page_size),
        atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("case", ["prefix_past_first_q_block",
                                  "non_causal_ragged_s"])
def test_prefill_edge_cases_where_pallas_differs(case):
    """Two inputs outside the reference sweep on which the Pallas prefill
    kernel departs from its own oracle: its tile skip ignores prefix_len
    (prefix 100 with 64-query blocks), and with causal=False it attends
    the zero padding of a ragged S.  The port follows the oracle, and its
    CUDA kernel is held to the same two cases on the card."""
    rng = np.random.default_rng(0)
    t = 128 if case == "prefix_past_first_q_block" else 100
    qj, qt = _pair(rng.standard_normal((1, t, 2, 32)), "float32")
    kj, kt = _pair(rng.standard_normal((1, t, 2, 32)), "float32")
    vj, vt = _pair(rng.standard_normal((1, t, 2, 32)), "float32")
    causal = case == "prefix_past_first_q_block"
    pre = np.array([100], np.int32) if causal else None
    expect = jref.prefill_attention_ref(
        qj, kj, vj, None if pre is None else jnp.asarray(pre), causal=causal)
    out = ref.prefill_attention_ref(
        qt, kt, vt, None if pre is None else torch.from_numpy(pre),
        causal=causal)
    np.testing.assert_allclose(_f32(out), _f32(expect), atol=1e-5, rtol=1e-5)
    pallas = pallas_prefill(qj, kj, vj,
                            None if pre is None else jnp.asarray(pre),
                            causal=causal, block_q=64, block_k=64,
                            interpret=True)
    assert np.abs(_f32(pallas) - _f32(expect)).max() > 1e-2
