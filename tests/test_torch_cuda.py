"""The CUDA kernels against their plain PyTorch versions, on the card.

Needs an NVIDIA GPU and nvcc; skips elsewhere.  Imports only the port
(no JAX), so it also runs where JAX is not installed:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import pytest
torch = pytest.importorskip("torch")  # the port needs PyTorch

from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import decode_attention_cuda
from repro_torch.kernels.mamba_scan import mamba_selective_scan_cuda
from repro_torch.kernels.prefill_attention import prefill_attention_cuda

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
