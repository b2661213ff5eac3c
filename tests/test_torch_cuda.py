"""The CUDA kernels against their plain PyTorch versions, on the card.

Needs an NVIDIA GPU and nvcc; skips elsewhere.  Imports only the port
(no JAX), so it also runs where JAX is not installed:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import pytest
torch = pytest.importorskip("torch")  # the port needs PyTorch

from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import decode_attention_cuda
from repro_torch.kernels.mamba_scan import (mamba_selective_scan_bwd_cuda,
                                            mamba_selective_scan_cuda)
from repro_torch.kernels.prefill_attention import (
    prefill_attention_bwd_cuda, prefill_attention_bwd_route,
    prefill_attention_cuda)

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


@pytest.mark.parametrize("q_dtype,kv_dtype,tol", [
    (torch.float32, torch.float32, 1e-5),
    (torch.bfloat16, torch.bfloat16, 2e-2),
    (torch.float32, torch.bfloat16, 1e-5)])
def test_decode_kernel_matches_plain(gen, q_dtype, kv_dtype, tol):
    b, h, kv, d, s = 3, 32, 8, 128, 512
    q = _randn(gen, (b, h, d), q_dtype)
    k = _randn(gen, (b, s, kv, d), kv_dtype)
    v = _randn(gen, (b, s, kv, d), kv_dtype)
    lengths = torch.tensor([1, 200, 512], dtype=torch.int32, device="cuda")
    out = decode_attention_cuda(q, k, v, lengths)
    torch.testing.assert_close(out.float(),
                               ref.decode_attention_ref(q, k, v,
                                                        lengths).float(),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("q_dtype,kv_dtype,tol", [
    (torch.float32, torch.float32, 1e-5),
    (torch.bfloat16, torch.bfloat16, 3e-2),
    (torch.float32, torch.bfloat16, 1e-5)])
def test_prefill_kernel_matches_plain_and_is_split_invariant(gen, q_dtype,
                                                             kv_dtype, tol):
    b, t, s, h, kv, d = 2, 150, 256, 8, 2, 64
    q = _randn(gen, (b, t, h, d), q_dtype)
    k = _randn(gen, (b, s, kv, d), kv_dtype)
    v = _randn(gen, (b, s, kv, d), kv_dtype)
    whole = prefill_attention_cuda(q, k, v)
    torch.testing.assert_close(whole.float(),
                               ref.prefill_attention_ref(q, k, v).float(),
                               atol=tol, rtol=tol)
    off = torch.full((b,), 70, dtype=torch.int32, device="cuda")
    tail = prefill_attention_cuda(q[:, 70:].contiguous(), k, v, None, off)
    assert torch.equal(tail, whole[:, 70:])


@pytest.mark.parametrize("t", [1, 33])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 3e-2)])
def test_scan_kernel_matches_plain(gen, t, dtype, tol):
    """Ragged I (not a multiple of the 128-channel block), lens with a 0
    and a short row; a row with lens 0 keeps h0 bit for bit."""
    b, i, n = 4, 200, 16
    dt = torch.nn.functional.softplus(_randn(gen, (b, t, i), torch.float32))
    dt, x, bb, cc = (dt.to(dtype), _randn(gen, (b, t, i), dtype),
                     _randn(gen, (b, t, n), dtype),
                     _randn(gen, (b, t, n), dtype))
    a_neg = -torch.exp(_randn(gen, (i, n), torch.float32))
    d_skip = _randn(gen, (i,), torch.float32)
    h0 = 0.5 * _randn(gen, (b, i, n), torch.float32)
    lens = torch.tensor([t, 0, 1, max(t // 2, 1)], dtype=torch.int32,
                        device="cuda")
    for ln in (None, lens):
        y, h = mamba_selective_scan_cuda(dt, x, bb, cc, a_neg, d_skip, h0,
                                         ln)
        y_ref, h_ref = ref.mamba_selective_scan_ref(dt, x, bb, cc, a_neg,
                                                    d_skip, h0, ln)
        assert y.dtype == h.dtype == torch.float32
        torch.testing.assert_close(y, y_ref, atol=tol, rtol=tol)
        torch.testing.assert_close(h, h_ref, atol=tol, rtol=tol)
    assert torch.equal(h[1], h0[1])


def _scan_args(gen, b, t, i, n, dtype):
    dt = torch.nn.functional.softplus(_randn(gen, (b, t, i), torch.float32))
    return (dt.to(dtype), _randn(gen, (b, t, i), dtype),
            _randn(gen, (b, t, n), dtype), _randn(gen, (b, t, n), dtype),
            -torch.exp(_randn(gen, (i, n), torch.float32)),
            _randn(gen, (i,), torch.float32),
            0.5 * _randn(gen, (b, i, n), torch.float32))


@pytest.mark.parametrize("n", [8, 16])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 3e-2)])
def test_scan_kernel_state_dims(gen, n, dtype, tol):
    """N 8 (one lane per channel) and N 16 (two) over T-tile edges
    (T 70), a ragged I and lens with a 0; a padded row's state is its
    unpadded run's, bit for bit."""
    b, t, i = 3, 70, 200
    args = _scan_args(gen, b, t, i, n, dtype)
    lens = torch.tensor([70, 0, 33], dtype=torch.int32, device="cuda")
    y, h = mamba_selective_scan_cuda(*args, lens)
    y_ref, h_ref = ref.mamba_selective_scan_ref(*args, lens)
    torch.testing.assert_close(y, y_ref, atol=tol, rtol=tol)
    torch.testing.assert_close(h, h_ref, atol=tol, rtol=tol)
    assert torch.equal(h[1], args[6][1])
    one = [v[2:3, :33].contiguous() for v in args[:4]]
    _, h_one = mamba_selective_scan_cuda(*one, *args[4:6],
                                         args[6][2:3].contiguous())
    assert torch.equal(h_one[0], h[2])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scan_kernel_carry_split_bitwise(gen, dtype):
    """A T 70 call split in two at t = 1, 31, 32, 33 and 64 (before, at
    and after the 32-step tiles' edges), h0 carried between the parts:
    the bits of one call."""
    b, t, i, n = 2, 70, 256, 16
    args = _scan_args(gen, b, t, i, n, dtype)
    y_full, h_full = mamba_selective_scan_cuda(*args)
    for cut in (1, 31, 32, 33, 64):
        y1, h_mid = mamba_selective_scan_cuda(
            *[v[:, :cut].contiguous() for v in args[:4]], *args[4:])
        y2, h_end = mamba_selective_scan_cuda(
            *[v[:, cut:].contiguous() for v in args[:4]], *args[4:6], h_mid)
        assert torch.equal(torch.cat([y1, y2], 1), y_full), cut
        assert torch.equal(h_end, h_full), cut


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scan_kernel_in_place(gen, dtype):
    """h_out is h0, a view of a stacked (G, B, I, N) state: the bits of
    the call with a fresh h_final, a row of length 0 unchanged, the
    other group untouched."""
    b, t, i, n = 4, 40, 256, 16
    args = _scan_args(gen, b, t, i, n, dtype)
    lens = torch.tensor([40, 0, 7, 1], dtype=torch.int32, device="cuda")
    y_sep, h_sep = mamba_selective_scan_cuda(*args, lens)
    stack = torch.stack([args[6], 0.5 * _randn(gen, (b, i, n),
                                               torch.float32)])
    other = stack[1].clone()
    y, h = mamba_selective_scan_cuda(*args[:6], stack[0], lens, stack[0])
    assert h.data_ptr() == stack[0].data_ptr()
    assert torch.equal(y, y_sep) and torch.equal(stack[0], h_sep)
    assert torch.equal(stack[0][1], args[6][1])
    assert torch.equal(stack[1], other)


@pytest.mark.parametrize("g", [1, 4, 8])
@pytest.mark.parametrize("d", [64, 128])
def test_prefill_bf16_heads_per_cta(gen, g, d):
    """The tensor-core path over head groups (one CTA takes up to four
    query heads of a kv head): T not a multiple of the query block or
    the key tile, a non-zero prefix, and full attention over a ragged
    S."""
    b, t, kv = 2, 100, 2
    h = g * kv
    q = _randn(gen, (b, t, h, d), torch.bfloat16)
    k = _randn(gen, (b, t, kv, d), torch.bfloat16)
    v = _randn(gen, (b, t, kv, d), torch.bfloat16)
    prefix = torch.tensor([70, 5], dtype=torch.int32, device="cuda")
    for causal in (True, False):
        out = prefill_attention_cuda(q, k, v, prefix, causal=causal)
        torch.testing.assert_close(
            out.float(), ref.prefill_attention_ref(q, k, v, prefix,
                                                   causal=causal).float(),
            atol=3e-2, rtol=3e-2)


def test_prefill_bf16_chunk_split_bitwise_g8(gen):
    """Jamba's G 8 (two CTAs per kv head) at D 128: a token's output is
    bitwise the same however its prompt is split."""
    b, t, s, h, kv, d = 2, 200, 256, 16, 2, 128
    q = _randn(gen, (b, t, h, d), torch.bfloat16)
    k = _randn(gen, (b, s, kv, d), torch.bfloat16)
    v = _randn(gen, (b, s, kv, d), torch.bfloat16)
    whole = prefill_attention_cuda(q, k, v)
    for a, e in ((0, 1), (1, 77), (77, 130), (130, 200)):
        off = torch.full((b,), a, dtype=torch.int32, device="cuda")
        part = prefill_attention_cuda(q[:, a:e].contiguous(), k, v, None, off)
        assert torch.equal(part, whole[:, a:e]), (a, e)


@pytest.mark.parametrize("b", [1, 3])
def test_decode_long_context_splits(gen, b):
    """S 8192: one row (many splits per kv head) and three rows of
    lengths 1, 4097 and 8192 (one split, an uneven and a full split)."""
    h, kv, d, s = 32, 8, 128, 8192
    q = _randn(gen, (b, h, d), torch.bfloat16)
    k = _randn(gen, (b, s, kv, d), torch.bfloat16)
    v = _randn(gen, (b, s, kv, d), torch.bfloat16)
    lengths = torch.tensor([1, 4097, 8192][-b:], dtype=torch.int32,
                           device="cuda")
    out = decode_attention_cuda(q, k, v, lengths)
    torch.testing.assert_close(
        out.float(), ref.decode_attention_ref(q, k, v, lengths).float(),
        atol=2e-2, rtol=2e-2)


def test_decode_workspace_reused_across_calls(gen):
    """The split counters are reset by the kernel: calls in a row on the
    same workspace, and a smaller call after a larger one, agree."""
    b, h, kv, d, s = 4, 32, 8, 128, 2048
    q = _randn(gen, (b, h, d), torch.float32)
    k = _randn(gen, (b, s, kv, d), torch.bfloat16)
    v = _randn(gen, (b, s, kv, d), torch.bfloat16)
    lengths = torch.tensor([2048, 700, 33, 1500], dtype=torch.int32,
                           device="cuda")
    first = decode_attention_cuda(q, k, v, lengths)
    again = decode_attention_cuda(q, k, v, lengths)
    small = decode_attention_cuda(q[:1].contiguous(), k[:1].contiguous(),
                                  v[:1].contiguous(), lengths[:1].contiguous())
    third = decode_attention_cuda(q, k, v, lengths)
    torch.testing.assert_close(first, ref.decode_attention_ref(q, k, v,
                                                               lengths),
                               atol=1e-5, rtol=1e-5)
    assert torch.equal(again, first) and torch.equal(third, first)
    torch.testing.assert_close(small, first[:1], atol=1e-6, rtol=1e-6)


def test_chunked_staging_kv_split_invariant_and_prefix_row_is_a_copy(gen):
    """At the engine's fixed chunk geometry (3 staging rows x 64 tokens) a
    prompt's staging K/V and last logits are bitwise the same under two
    budget splits, while the other rows carry other prompts; and a prefix
    row published from the staging row keeps its bits after the staging
    row is overwritten by the next prompt."""
    import dataclasses

    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import init_decode_state, init_params, \
        prefill_chunk
    from repro_torch.serving.tiermove import copy_state_row
    cfg = get_config("llama3.1-8b").reduced(layers=2, d_model=256,
                                            vocab=512)
    cfg = dataclasses.replace(cfg, name="llama-chunk-card")
    params = init_params(cfg, seed=0, device="cuda")
    rows, width, cache, plen = 3, 64, 256, 150
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (rows, plen))

    def run(grants):
        """Advance every row by ``grants`` tokens per call (row 1's split
        is the list given; the others take 64 whenever they can)."""
        st = init_decode_state(cfg, device_batch=rows, cache_len=cache,
                               device="cuda")
        done = [0] * rows
        logits = None
        for g in grants:
            toks = np.zeros((rows, width), np.int64)
            lens = np.zeros((rows,), np.int32)
            for r in range(rows):
                c = g if r == 1 else min(width, plen - done[r])
                toks[r, :c] = prompts[r, done[r]:done[r] + c]
                lens[r] = c
                done[r] += c
            logits, st = prefill_chunk(
                params, cfg, torch.from_numpy(toks).cuda(),
                torch.from_numpy(lens).cuda(), st)
            if done[1] == plen:
                return logits[1].clone(), st
        raise AssertionError("split does not cover the prompt")

    la, sa = run([64, 64, 22])
    lb, sb = run([40, 64, 46])
    assert sa.lengths[1].item() == sb.lengths[1].item() == plen
    assert torch.equal(la, lb)
    for ea, eb in zip(sa.per_entry, sb.per_entry):
        assert torch.equal(ea.k[:, 1, :plen], eb.k[:, 1, :plen])
        assert torch.equal(ea.v[:, 1, :plen], eb.v[:, 1, :plen])
    prefix = init_decode_state(cfg, device_batch=1, cache_len=cache,
                               device="cuda")
    copy_state_row(cfg, prefix, sa, 1, 0, plen)
    kept = [(e.k[:, 0].clone(), e.v[:, 0].clone()) for e in prefix.per_entry]
    sa.lengths[1] = 0                        # the row is recycled
    other = (prompts[:, :width] + 1) % cfg.vocab_size
    prefill_chunk(params, cfg, torch.from_numpy(other).cuda(),
                  torch.full((rows,), width, dtype=torch.int32,
                             device="cuda"), sa)
    assert not torch.equal(sa.per_entry[0].k[:, 1, :width],
                           kept[0][0][:, :width])
    for e, (k, v) in zip(prefix.per_entry, kept):
        assert torch.equal(e.k[:, 0], k) and torch.equal(e.v[:, 0], v)
    assert prefix.lengths[0].item() == plen


# head geometries of the reference registry's published configs: (H, KV,
# D) of internlm2-20b (group 6), llama3-405b (group 16), stablelm-12b
# (head_dim 160), paligemma-3b (MQA, head_dim 256) and hubert-xlarge
# (MHA, head_dim 80; prefill only: an encoder has no decode)
NEW_DECODE_GEOMETRIES = [(48, 8, 128), (128, 8, 128), (32, 8, 160),
                         (8, 1, 256)]
NEW_PREFILL_GEOMETRIES = NEW_DECODE_GEOMETRIES + [(16, 16, 80)]


@pytest.mark.parametrize("h,kv,d", NEW_DECODE_GEOMETRIES)
@pytest.mark.parametrize("q_dtype,kv_dtype,tol", [
    (torch.float32, torch.float32, 1e-5),
    (torch.bfloat16, torch.bfloat16, 2e-2),
    (torch.float32, torch.bfloat16, 1e-5)])
def test_decode_new_geometries(gen, h, kv, d, q_dtype, kv_dtype, tol):
    """Groups 6 and 16 and head_dims 160 and 256 against the plain
    version: rows of one position, of a partial tile and of many
    splits."""
    b, s = 3, 700
    q = _randn(gen, (b, h, d), q_dtype)
    k = _randn(gen, (b, s, kv, d), kv_dtype)
    v = _randn(gen, (b, s, kv, d), kv_dtype)
    lengths = torch.tensor([1, 45, 700], dtype=torch.int32, device="cuda")
    out = decode_attention_cuda(q, k, v, lengths)
    torch.testing.assert_close(
        out.float(), ref.decode_attention_ref(q, k, v, lengths).float(),
        atol=tol, rtol=tol)


@pytest.mark.parametrize("h,kv,d", NEW_PREFILL_GEOMETRIES)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 3e-2)])
def test_prefill_new_geometries(gen, h, kv, d, dtype, tol):
    """Groups 6 and 16, head_dims 80, 160 and 256, on the tensor-core (bf16)
    and the FMA (fp32) kernel: T not a multiple of the query block or
    the key tile, causal with a prefix past the first blocks, full
    attention over the ragged S, and a chunk at an offset bitwise equal
    to the whole prompt's rows."""
    b, t = 2, 100
    q = _randn(gen, (b, t, h, d), dtype)
    k = _randn(gen, (b, t, kv, d), dtype)
    v = _randn(gen, (b, t, kv, d), dtype)
    prefix = torch.tensor([70, 5], dtype=torch.int32, device="cuda")
    for causal in (True, False):
        out = prefill_attention_cuda(q, k, v, prefix, causal=causal)
        torch.testing.assert_close(
            out.float(), ref.prefill_attention_ref(q, k, v, prefix,
                                                   causal=causal).float(),
            atol=tol, rtol=tol)
    whole = prefill_attention_cuda(q, k, v)
    off = torch.full((b,), 37, dtype=torch.int32, device="cuda")
    tail = prefill_attention_cuda(q[:, 37:].contiguous(), k, v, None, off)
    assert torch.equal(tail, whole[:, 37:])


# (H, KV, D) covering every query group (1/2/4/6/8/16) and head_dim
# (32/64/80/128/160/256) the backward kernel is built for
BWD_GEOMETRIES = [(4, 4, 64), (8, 4, 128), (8, 2, 32), (12, 2, 80),
                  (16, 2, 160), (16, 1, 256)]


def _rel_close(got, want, tol):
    """max |got - want| within tol of max |want| (the gradients' sums
    grow with T and G, so the bar is relative to their scale)."""
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    assert err <= tol * max(scale, 1e-6), (err, scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prefill_lse_output(gen, dtype):
    """The forward's log-sum-exp against the plain one, and the output
    with it bitwise the output without it."""
    b, t, h, kv, d = 2, 77, 8, 2, 64
    q, k, v = (_randn(gen, (b, t, n, d), dtype) for n in (h, kv, kv))
    prefix = torch.tensor([40, 3], dtype=torch.int32, device="cuda")
    for causal in (True, False):
        out, lse = prefill_attention_cuda(q, k, v, prefix, causal=causal,
                                          return_lse=True)
        assert torch.equal(out, prefill_attention_cuda(q, k, v, prefix,
                                                       causal=causal))
        _, want = ref.prefill_attention_ref(q, k, v, prefix, causal=causal,
                                            return_lse=True)
        torch.testing.assert_close(lse, want, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("h,kv,d", BWD_GEOMETRIES)
@pytest.mark.parametrize("mask", ["causal", "prefix", "full"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_prefill_bwd_kernel_matches_plain(gen, h, kv, d, mask, dtype, tol):
    """dq, dk, dv against the plain backward on the same forward output
    and log-sum-exp: odd T over several query and key blocks, a prefix
    past the first blocks on one row; twice, bitwise the same."""
    b, t = 2, 77
    q, k, v = (_randn(gen, (b, t, n, d), dtype) for n in (h, kv, kv))
    prefix = torch.tensor([45, 0], dtype=torch.int32, device="cuda") \
        if mask == "prefix" else None
    causal = mask != "full"
    out, lse = prefill_attention_cuda(q, k, v, prefix, causal=causal,
                                      return_lse=True)
    dout = _randn(gen, (b, t, h, d), dtype)
    got = prefill_attention_bwd_cuda(q, k, v, out, lse, dout, prefix,
                                     causal=causal)
    want = ref.prefill_attention_bwd_ref(q, k, v, out, lse, dout, prefix,
                                         causal)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        _rel_close(g, w, tol)
    again = prefill_attention_bwd_cuda(q, k, v, out, lse, dout, prefix,
                                       causal=causal)
    assert all(torch.equal(a, g) for a, g in zip(again, got))


@pytest.mark.parametrize("b,t,h,kv,d,prefix", [
    (1, 1000, 16, 4, 128, None),          # T past the last full tiles
    (2, 320, 16, 4, 128, (200, 130)),     # prefixes ending inside a block
    (2, 200, 8, 2, 64, (70, 0)),          # D 64, ragged T and prefix
])
def test_prefill_bwd_wgmma_ragged_edges(gen, b, t, h, kv, d, prefix):
    """The wgmma route at the edges of its 64-query and 64-key tiles: T
    not a multiple of either, prefixes that end inside a key block;
    against the plain backward, twice, bitwise the same."""
    assert prefill_attention_bwd_route(d, torch.bfloat16) == "wgmma"
    q, k, v = (_randn(gen, (b, t, n, d), torch.bfloat16)
               for n in (h, kv, kv))
    pre = None if prefix is None else torch.tensor(
        prefix, dtype=torch.int32, device="cuda")
    out, lse = prefill_attention_cuda(q, k, v, pre, return_lse=True)
    dout = _randn(gen, (b, t, h, d), torch.bfloat16)
    got = prefill_attention_bwd_cuda(q, k, v, out, lse, dout, pre)
    want = ref.prefill_attention_bwd_ref(q, k, v, out, lse, dout, pre)
    for g, w in zip(got, want):
        _rel_close(g, w, 2e-2)
    again = prefill_attention_bwd_cuda(q, k, v, out, lse, dout, pre)
    assert all(torch.equal(a, g) for a, g in zip(again, got))


@pytest.mark.parametrize("n", [8, 16])
@pytest.mark.parametrize("t", [1, 21, 64])
def test_scan_bwd_kernel_matches_plain(gen, n, t):
    """Every gradient of the scan against the plain backward: a ragged I,
    T across and inside one checkpoint chunk, a nonzero h0 and the final
    state's gradient, with and without it; twice, bitwise the same."""
    b, i = 3, 200
    dt, x, bb, cc, a_neg, d_skip, h0 = _scan_args(gen, b, t, i, n,
                                                  torch.float32)
    dy = _randn(gen, (b, t, i), torch.float32)
    dh = _randn(gen, (b, i, n), torch.float32)
    for dh_final in (dh, None):
        args = (dt, x, bb, cc, a_neg, d_skip, h0, dy, dh_final)
        got = mamba_selective_scan_bwd_cuda(*args)
        want = ref.mamba_selective_scan_bwd_ref(*args)
        for g, w in zip(got, want):
            assert g.shape == w.shape
            _rel_close(g, w, 1e-5)
        again = mamba_selective_scan_bwd_cuda(*args)
        assert all(torch.equal(a, g) for a, g in zip(again, got))


@pytest.mark.parametrize("n", [8, 16])
def test_scan_bwd_ragged_checkpoint_interval(gen, n):
    """T 1000, not a multiple of the 16-step checkpoint interval, over a
    ragged I (300 channels: CTAs of 64 at N 16, of 128 at N 8); against
    the plain backward, twice, bitwise the same."""
    b, t, i = 2, 1000, 300
    dt, x, bb, cc, a_neg, d_skip, h0 = _scan_args(gen, b, t, i, n,
                                                  torch.float32)
    dy = _randn(gen, (b, t, i), torch.float32)
    dh = _randn(gen, (b, i, n), torch.float32)
    args = (dt, x, bb, cc, a_neg, d_skip, h0, dy, dh)
    got = mamba_selective_scan_bwd_cuda(*args)
    want = ref.mamba_selective_scan_bwd_ref(*args)
    for g, w in zip(got, want):
        _rel_close(g, w, 1e-4)
    again = mamba_selective_scan_bwd_cuda(*args)
    assert all(torch.equal(a, g) for a, g in zip(again, got))


# ---------------------------------------------------------------------------
# The xLSTM recurrences (sLSTM and mLSTM, forward and backward)
# ---------------------------------------------------------------------------


def _slstm_inputs(gen, b, t, nh, hd, r_dtype):
    d = nh * hd
    gx = _randn(gen, (b, t, 4 * d), torch.float32)
    r = (_randn(gen, (nh, hd, 4 * hd), torch.float32) / hd ** 0.5).to(r_dtype)
    bias = 0.1 * _randn(gen, (4 * d,), torch.float32)
    state = [_randn(gen, (b, nh, hd), torch.float32),
             1.0 + _randn(gen, (b, nh, hd), torch.float32).abs(),
             _randn(gen, (b, nh, hd), torch.float32),
             _randn(gen, (b, nh, hd), torch.float32)]
    return [gx, r, bias] + state


def _mlstm_inputs(gen, b, t, nh, hd):
    q, k, v = (_randn(gen, (b, t, nh, hd), torch.float32) for _ in range(3))
    k = k / hd ** 0.5
    i_pre = _randn(gen, (b, t, nh), torch.float32)
    f_pre = torch.nn.functional.logsigmoid(
        _randn(gen, (b, t, nh), torch.float32) + 2.0)
    state = [0.3 * _randn(gen, (b, nh, hd, hd), torch.float32),
             0.3 * _randn(gen, (b, nh, hd), torch.float32),
             _randn(gen, (b, nh), torch.float32)]
    return [q, k, v, i_pre, f_pre] + state


def _close_to_max(got, want, tol):
    scale = float(want.abs().max())
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol * max(scale, 1e-30), (err, scale)


@pytest.mark.parametrize("t", [1, 37])
@pytest.mark.parametrize("hd,r_dtype", [(16, torch.float32),
                                        (32, torch.float32),
                                        (192, torch.float32),
                                        (192, torch.bfloat16)])
def test_slstm_kernel_matches_plain_and_splits_bitwise(gen, t, hd, r_dtype):
    from repro_torch.kernels.xlstm import slstm_scan_cuda
    args = _slstm_inputs(gen, 3, t, 4, hd, r_dtype)
    lens = torch.tensor([t, max(t // 2, 1), 0], dtype=torch.int32,
                        device="cuda")
    got = slstm_scan_cuda(*args, lens)
    want = ref.slstm_recurrence_ref(*args, lens)
    for g, w in zip(got, want):
        _close_to_max(g, w, 1e-5)
    for g, s0 in zip(got[1:], args[3:]):
        assert torch.equal(g[2], s0[2])           # a row of length 0
    if t > 1:
        cut = t // 3
        first = slstm_scan_cuda(args[0][:, :cut].contiguous(), *args[1:],
                                torch.clamp(lens, max=cut))
        second = slstm_scan_cuda(args[0][:, cut:].contiguous(), *args[1:3],
                                 *first[1:], torch.clamp(lens - cut, min=0))
        assert torch.equal(torch.cat([first[0], second[0]], 1), got[0])
        for a, b in zip(second[1:], got[1:]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("t", [1, 37])
@pytest.mark.parametrize("hd", [32, 64, 384])
def test_mlstm_kernel_matches_plain_and_splits_bitwise(gen, t, hd):
    from repro_torch.kernels.xlstm import mlstm_scan_cuda
    args = _mlstm_inputs(gen, 3, t, 4, hd)
    lens = torch.tensor([t, max(t // 2, 1), 0], dtype=torch.int32,
                        device="cuda")
    got = mlstm_scan_cuda(*args, lens)
    want = ref.mlstm_recurrence_ref(*args, lens)
    for g, w in zip(got, want):
        _close_to_max(g, w, 1e-5)
    for g, s0 in zip(got[1:], args[5:]):
        assert torch.equal(g[2], s0[2])
    if t > 1:
        cut = t // 3
        first = mlstm_scan_cuda(*[a[:, :cut].contiguous() for a in args[:5]],
                                *args[5:], torch.clamp(lens, max=cut))
        second = mlstm_scan_cuda(*[a[:, cut:].contiguous() for a in args[:5]],
                                 *first[1:], torch.clamp(lens - cut, min=0))
        assert torch.equal(torch.cat([first[0], second[0]], 1), got[0])
        for a, b in zip(second[1:], got[1:]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("t", [1, 21])
@pytest.mark.parametrize("hd,r_dtype", [(32, torch.float32),
                                        (192, torch.bfloat16)])
def test_slstm_bwd_kernel_matches_plain(gen, t, hd, r_dtype):
    from repro_torch.kernels.xlstm import slstm_scan_bwd_cuda, slstm_scan_cuda
    gx, r, bias, c, n, h, m = _slstm_inputs(gen, 2, t, 4, hd, r_dtype)
    hs, _, _, _, _, acts, cs, ns, ms = slstm_scan_cuda(gx, r, bias, c, n, h,
                                                       m, save=True)
    dhs = _randn(gen, hs.shape, torch.float32)
    dstate = tuple(_randn(gen, c.shape, torch.float32) for _ in range(4))
    got = slstm_scan_bwd_cuda(r, acts, cs, ns, ms, c, n, m, dhs, dstate)
    again = slstm_scan_bwd_cuda(r, acts, cs, ns, ms, c, n, m, dhs, dstate)
    bsz, _, nh, _ = hs.shape
    want = ref.slstm_recurrence_bwd_ref(
        r, acts.reshape(bsz, t, nh, 4 * hd), cs, ns, ms, c, n, m, dhs, dstate)
    for g, w, a in zip(got, want, again):
        _close_to_max(g.reshape(w.shape), w, 1e-4)
        assert torch.equal(g, a)


@pytest.mark.parametrize("t", [1, 21, 40])
@pytest.mark.parametrize("hd", [32, 384])
def test_mlstm_bwd_kernel_matches_plain(gen, t, hd):
    from repro_torch.kernels.xlstm import mlstm_scan_bwd_cuda, mlstm_scan_cuda
    args = _mlstm_inputs(gen, 2, t, 4, hd)
    hs = mlstm_scan_cuda(*args)[0]
    dhs = _randn(gen, hs.shape, torch.float32)
    dstate = tuple(_randn(gen, x.shape, torch.float32) for x in args[5:])
    got = mlstm_scan_bwd_cuda(*args, hs, dhs, dstate)
    again = mlstm_scan_bwd_cuda(*args, hs, dhs, dstate)
    want = ref.mlstm_recurrence_bwd_ref(*args, hs, dhs, dstate)
    for g, w, a in zip(got, want, again):
        _close_to_max(g, w, 1e-4)
        assert torch.equal(g, a)


def _gates_with_ties(b, t, nh):
    """i_pre, f_pre, m0 on a grid of 1/64 with i_pre = f_pre + m on every
    third step: exact in any order of summation, so the kernel's parallel
    scan of the stabiliser meets the same ties as the plain walk."""
    g = torch.Generator().manual_seed(t)
    f_pre = -torch.randint(1, 65, (b, t, nh), generator=g).float() / 64
    i_pre = torch.randint(-128, 129, (b, t, nh), generator=g).float() / 64
    m0 = torch.randint(-64, 65, (b, nh), generator=g).float() / 64
    m = m0.clone()
    for s in range(t):
        a = f_pre[:, s] + m
        if s % 3 == 0:
            i_pre[:, s] = a
        m = torch.maximum(a, i_pre[:, s])
    return i_pre.cuda(), f_pre.cuda(), m0.cuda()


@pytest.mark.parametrize("state", ["carried", "zero", "tie"])
@pytest.mark.parametrize("t,hd", [(63, 64), (64, 64), (65, 64), (200, 64),
                                  (129, 384)])
def test_mlstm_bwd_kernel_chunk_edges_states_and_ties(gen, t, hd, state):
    """The chunkwise backward at T ending inside, on and just past a chunk
    of 64, from the zero state (m0 = -1e30, no final gradient), a carried
    one, and with ties in the stabiliser's max: within 1e-4 of each
    gradient's largest element, bitwise on repeat."""
    from repro_torch.kernels.xlstm import mlstm_scan_bwd_cuda, mlstm_scan_cuda
    b, nh = 2, 4
    args = _mlstm_inputs(gen, b, t, nh, hd)
    if state == "zero":
        args[5:] = [torch.zeros_like(args[5]), torch.zeros_like(args[6]),
                    torch.full_like(args[7], -1e30)]
    elif state == "tie":
        args[3], args[4], args[7] = _gates_with_ties(b, t, nh)
    hs = mlstm_scan_cuda(*args)[0]
    dhs = _randn(gen, hs.shape, torch.float32)
    dstate = (None, None, None) if state == "zero" else tuple(
        _randn(gen, x.shape, torch.float32) for x in args[5:])
    got = mlstm_scan_bwd_cuda(*args, hs, dhs, dstate)
    again = mlstm_scan_bwd_cuda(*args, hs, dhs, dstate)
    want = ref.mlstm_recurrence_bwd_ref(*args, hs, dhs, dstate)
    for g, w, a in zip(got, want, again):
        assert bool(torch.isfinite(g).all())
        _close_to_max(g, w, 1e-4)
        assert torch.equal(g, a)


@pytest.mark.parametrize("state", ["carried", "zero", "tie"])
@pytest.mark.parametrize("t", [63, 64, 65, 200, 1024, 4096])
@pytest.mark.parametrize("hd", [32, 64, 384])
def test_mlstm_chunkwise_route_matches_plain(gen, hd, t, state):
    """The mLSTM forward's chunkwise route at T ending inside, on and past
    a chunk of 64, from a carried state, the zero state (m0 = -1e30) and
    with ties in the stabiliser: hs and the final state within 1e-5 of
    the largest |value| of the plain walk (1e-4 at T 4096, as
    chip_smoke's XLSTM_LONG_TOL), bitwise on repeat.  Below the crossover
    (T 63-65) the route is named, as calls take the walk there."""
    from repro_torch.kernels import xlstm
    b, nh = (1, 4) if t == 4096 else (2, 4)
    args = _mlstm_inputs(gen, b, t, nh, hd)
    if state == "zero":
        args[5:] = [torch.zeros_like(args[5]), torch.zeros_like(args[6]),
                    torch.full_like(args[7], -1e30)]
    elif state == "tie":
        args[3], args[4], args[7] = _gates_with_ties(b, t, nh)
    if xlstm.mlstm_scan_route(t, None) == "chunkwise":
        call = xlstm.mlstm_scan_cuda
    else:
        def call(*a):
            return xlstm._mlstm_scan(*a, None, "chunkwise")
    got = call(*args)
    again = call(*args)
    want = ref.mlstm_recurrence_ref(*args)
    for g, w, a in zip(got, want, again):
        assert bool(torch.isfinite(g).all())
        _close_to_max(g, w, 1e-4 if t == 4096 else 1e-5)
        assert torch.equal(g, a)


def test_mlstm_scan_route_keeps_the_walk_for_lens_and_short_calls(gen):
    """Every call with lens, and every call below the crossover, takes the
    walk (decode, the serving chunk, frozen rows, splits in T); the
    chunkwise route begins at one T and holds above it."""
    from repro_torch.kernels.xlstm import mlstm_scan_route
    lens = torch.ones(2, dtype=torch.int32, device="cuda")
    for t in (1, 17, 64, 1024, 4096):
        assert mlstm_scan_route(t, lens) == "walk"
    assert mlstm_scan_route(1, None) == "walk"
    routes = [mlstm_scan_route(t, None) for t in range(1, 4097)]
    first = routes.index("chunkwise")
    assert 1 < first + 1 <= 128
    assert set(routes[:first]) == {"walk"}
    assert set(routes[first:]) == {"chunkwise"}
    assert mlstm_scan_route(1024, None) == "chunkwise"


@pytest.mark.parametrize("t", [1, 21, 1024])
@pytest.mark.parametrize("r_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [16, 32, 64, 192])
def test_slstm_bwd_kernel_head_dims_dtypes_and_long(gen, hd, r_dtype, t):
    """The sLSTM backward (its exchange with no cluster barrier a step) at
    every head_dim the port serves, fp32 and bf16 R, one step, a few and
    the train phase's 1024: within 1e-4 of each gradient's largest
    element of the plain reverse walk, bitwise on repeat."""
    from repro_torch.kernels.xlstm import slstm_scan_bwd_cuda, slstm_scan_cuda
    gx, r, bias, c, n, h, m = _slstm_inputs(gen, 2, t, 4, hd, r_dtype)
    hs, _, _, _, _, acts, cs, ns, ms = slstm_scan_cuda(gx, r, bias, c, n, h,
                                                       m, save=True)
    dhs = _randn(gen, hs.shape, torch.float32)
    dstate = tuple(_randn(gen, c.shape, torch.float32) for _ in range(4))
    got = slstm_scan_bwd_cuda(r, acts, cs, ns, ms, c, n, m, dhs, dstate)
    again = slstm_scan_bwd_cuda(r, acts, cs, ns, ms, c, n, m, dhs, dstate)
    want = ref.slstm_recurrence_bwd_ref(
        r, acts.reshape(2, t, 4, 4 * hd), cs, ns, ms, c, n, m, dhs, dstate)
    for g, w, a in zip(got, want, again):
        assert bool(torch.isfinite(g).all())
        _close_to_max(g.reshape(w.shape), w, 1e-4)
        assert torch.equal(g, a)


def test_slstm_kernel_long_frozen_row_and_split_bitwise(gen):
    """xlstm-125m's sLSTM over T 1024: a row of length 0 keeps its state
    bit for bit, a row stopped at 600 emits its frozen h over the rest,
    and a call split at 401 with the state carried is bitwise one call."""
    from repro_torch.kernels.xlstm import slstm_scan_cuda
    t, cut = 1024, 401
    args = _slstm_inputs(gen, 3, t, 4, 192, torch.bfloat16)
    lens = torch.tensor([t, 600, 0], dtype=torch.int32, device="cuda")
    got = slstm_scan_cuda(*args, lens)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    for g, s0 in zip(got[1:], args[3:]):
        assert torch.equal(g[2], s0[2])
    assert torch.equal(got[0][1, 600:],
                       got[3][1:2].expand(t - 600, -1, -1))
    first = slstm_scan_cuda(args[0][:, :cut].contiguous(), *args[1:],
                            torch.clamp(lens, max=cut))
    second = slstm_scan_cuda(args[0][:, cut:].contiguous(), *args[1:3],
                             *first[1:], torch.clamp(lens - cut, min=0))
    assert torch.equal(torch.cat([first[0], second[0]], 1), got[0])
    for a, b in zip(second[1:], got[1:]):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# CUDA graphs of the model step's pieces (models.graphs)
# ---------------------------------------------------------------------------


def _graph_twins(slots=8, host=8, staging=16, width=64, cache=256):
    """Reduced internlm2-1.8b (bf16, head_dim 128) with every step shape
    captured on one set of states, and a twin set the steps run on
    eagerly; both start empty."""
    from repro_torch.configs import get_config
    from repro_torch.models import (HostIO, StepGraphs, capture_chunk,
                                    capture_decode, init_decode_state,
                                    init_params)
    cfg = get_config("internlm2-1.8b").reduced(layers=4, d_model=512,
                                               vocab=512)
    params = init_params(cfg, seed=0, device="cuda")
    graphs = StepGraphs.for_device(cfg, torch.device("cuda"))
    assert graphs.captures

    def states():
        return (init_decode_state(cfg, device_batch=slots, cache_len=cache,
                                  device="cuda"),
                init_decode_state(cfg, device_batch=staging, cache_len=cache,
                                  device="cuda"))

    dec, stg = states()
    zero_host = HostIO(
        x_carry=torch.zeros((host, cfg.d_model), dtype=torch.bfloat16,
                            device="cuda"),
        positions=torch.zeros((host,), dtype=torch.int32, device="cuda"),
        attn_in=torch.zeros((host, cfg.num_heads, cfg.resolved_head_dim),
                            device="cuda"),
        consume_layer=-1, emit_layer=-1, window_start=0, window_end=0,
        row_valid=torch.zeros((host,), dtype=torch.bool, device="cuda"))
    capture_decode(params, cfg, graphs, dec)
    capture_decode(params, cfg, graphs, dec, zero_host)
    capture_chunk(params, cfg, graphs, stg, width)
    for st in (dec, stg):                   # the warm-ups' writes
        for entry in st.per_entry:
            for t in entry:
                t.zero_()
        st.lengths.zero_()
    return cfg, params, graphs, (dec, stg), states()


def _same_state(a, b):
    return torch.equal(a.lengths, b.lengths) and all(
        torch.equal(x, y) for ea, eb in zip(a.per_entry, b.per_entry)
        for x, y in zip(ea, eb))


def test_step_graphs_replay_matches_the_eager_step(gen):
    """Chunks over 16 staging rows, device-only decode over 8 slots and a
    16-row cohort decode through every phase of a token's journey (the
    late-poll idle one included), replayed from CUDA graphs against the
    same steps run eagerly on twin states: K/V, logits, x_final, emitted
    Q/K/V and greedy tokens bit for bit, one replay a step."""
    import numpy as np
    from repro_torch.core.overlap_engine import Cohort, OverlapController
    from repro_torch.models import decode_step, prefill_chunk
    cfg, params, graphs, (dec, stg), (dec_e, stg_e) = _graph_twins()
    rng = np.random.default_rng(0)
    plens = rng.integers(70, 200, 16)
    prompts = rng.integers(0, cfg.vocab_size, (16, 200))
    done = np.zeros(16, np.int64)
    while (done < plens).any():
        toks = np.zeros((16, 64), np.int64)
        lens = np.minimum(plens - done, 64).astype(np.int32)
        for r in range(16):
            toks[r, :lens[r]] = prompts[r, done[r]:done[r] + lens[r]]
        done += lens
        args = (torch.from_numpy(toks).cuda(), torch.from_numpy(lens).cuda())
        before = graphs.replays
        got, stg = prefill_chunk(params, cfg, *args, stg, graphs=graphs)
        want, stg_e = prefill_chunk(params, cfg, *args, stg_e)
        assert graphs.replays == before + 1
        assert torch.equal(got, want) and _same_state(stg, stg_e)
    for st, big in ((stg, dec), (stg_e, dec_e)):    # rows 0-7 to the slots
        for eb, es in zip(big.per_entry, st.per_entry):
            for b, s in zip(eb, es):
                b.copy_(s[:, :8])
        big.lengths.copy_(st.lengths[:8])
    tokens = want[:8].argmax(-1)
    for _ in range(3):
        got, dec, _, x = decode_step(params, cfg, tokens, dec, graphs=graphs)
        want, dec_e, _, x_e = decode_step(params, cfg, tokens, dec_e)
        assert torch.equal(got, want) and torch.equal(x, x_e)
        assert _same_state(dec, dec_e)
        tokens = got.argmax(-1)
    ctl = OverlapController(cfg)
    cohort = Cohort(slot_rids=[1, 2, -1, 3, 4, -1, 5, 6],
                    positions=rng.integers(50, 150, 8),
                    x_carry=torch.randn((8, cfg.d_model), generator=gen,
                                        device="cuda").to(torch.bfloat16),
                    attn_in=torch.zeros((8, cfg.num_heads,
                                         cfg.resolved_head_dim),
                                        device="cuda"))
    phases = []
    for i in range(ctl.iterations_per_token):
        phases.append(ctl.host_io(cohort))
        if i == 1:
            phases.append(phases[-1]._replace(
                consume_layer=-1, emit_layer=-1, window_start=0,
                window_end=0))
        ctl.advance(cohort)
    for host in phases:
        host = host._replace(x_carry=cohort.x_carry, attn_in=torch.randn(
            tuple(host.attn_in.shape), generator=gen, device="cuda"))
        before = graphs.replays
        got, dec, qkv, x = decode_step(params, cfg, tokens, dec, host,
                                       graphs=graphs)
        want, dec_e, qkv_e, x_e = decode_step(params, cfg, tokens, dec_e,
                                              host)
        assert graphs.replays == before + 1
        assert torch.equal(got, want) and torch.equal(x, x_e)
        assert all(torch.equal(a, b) for a, b in zip(qkv, qkv_e))
        assert _same_state(dec, dec_e)
        assert torch.equal(got.argmax(-1), want.argmax(-1))
        tokens = got[:8].argmax(-1)
        cohort.x_carry = x[8:]


def test_step_graphs_keep_one_attention_launch_a_layer(gen):
    """A replayed decode step launches the decode kernel once per
    attention layer, a replayed chunk the prefill kernel once per layer,
    each through ``kernels.ops`` (a wrapper put there sees every call)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.prefill_attention import prefill_attention_cuda
    from repro_torch.models import decode_step, prefill_chunk
    cfg, params, graphs, (dec, stg), _ = _graph_twins()
    seen = []
    dec_op, pre_op = ops.decode_attention, ops.prefill_attention
    ops.decode_attention = lambda *a: seen.append("d") or dec_op(*a)
    ops.prefill_attention = lambda *a, **k: seen.append("p") or \
        pre_op(*a, **k)
    try:
        decode_attention_cuda.launches = prefill_attention_cuda.launches = 0
        tokens = torch.zeros((8,), dtype=torch.int64, device="cuda")
        decode_step(params, cfg, tokens, dec, graphs=graphs)
        assert decode_attention_cuda.launches == cfg.num_attn_layers
        prefill_chunk(params, cfg,
                      torch.zeros((16, 64), dtype=torch.int64, device="cuda"),
                      torch.full((16,), 64, dtype=torch.int32, device="cuda"),
                      stg, graphs=graphs)
        assert prefill_attention_cuda.launches == cfg.num_attn_layers
    finally:
        ops.decode_attention, ops.prefill_attention = dec_op, pre_op
    assert graphs.replays == 2
    assert seen == ["d"] * cfg.num_attn_layers + ["p"] * cfg.num_attn_layers
    # the device's graphs share one pool: a replay on another stream
    # could overlap another engine's, and is refused
    with torch.cuda.stream(torch.cuda.Stream()):
        with pytest.raises(RuntimeError, match="default stream"):
            decode_step(params, cfg, tokens, dec, graphs=graphs)
    assert graphs.replays == 2


def test_two_engines_in_two_threads_capture_and_serve_alike(gen):
    """Two threads each build, run and drop an engine three times, as a
    gateway's replica is respawned beside a live one: captures and frees
    of one thread's graphs fall between the other's replays (one memory
    pool).  Every engine serves the tokens one engine serves alone, every
    model step replayed."""
    import gc
    import threading

    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serving import Engine, EngineConfig, Request
    cfg = get_config("internlm2-1.8b").reduced(layers=4, d_model=512,
                                               vocab=512)
    params = init_params(cfg, seed=1, device="cuda")
    rng = np.random.default_rng(2)
    prompts = [list(rng.integers(0, cfg.vocab_size, n))
               for n in (40, 90, 130, 20, 75, 60)]

    def serve(out, i):
        eng = Engine(cfg, params, EngineConfig(
            device="cuda", device_slots=2, host_slots=2, cache_len=256,
            chunk_tokens=32, host_workers=1, tier_rebalance=False,
            preemption=False))
        try:
            reqs = [Request(prompt=list(p), max_new_tokens=12)
                    for p in prompts]
            eng.run(reqs)
            out[i] = ([r.output for r in reqs], eng.stats)
        finally:
            eng.shutdown()

    def rounds(out, i):
        for r in range(3):
            serve(out, (i, r))
            gc.collect()                # this engine's graphs go now

    alone = {}
    serve(alone, 0)
    both = {}
    threads = [threading.Thread(target=rounds, args=(both, i))
               for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    tokens, stats = alone[0]
    assert stats.host_tokens > 0
    assert stats.graph_steps == stats.model_steps > 0
    assert len(both) == 6
    for out, st in both.values():
        assert out == tokens
        assert st.graph_steps == st.model_steps > 0
