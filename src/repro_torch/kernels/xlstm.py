"""The xLSTM recurrences on the card: wrappers of ``csrc/slstm_scan.cu``,
``csrc/slstm_scan_bwd.cu``, ``csrc/mlstm_scan.cu`` and
``csrc/mlstm_scan_bwd.cu``.

They replace no Pallas kernel: the reference runs each recurrence as one
``lax.scan`` (``repro/models/ssm.py``: the sLSTM's at ``:246``, its cell
at ``:209``; the mLSTM's at ``:369``, its cell at ``:285``), and the
port ran them as Python loops of ~15-20 PyTorch ops a step.

  * sLSTM: a cluster of eight CTAs per (row, head) (four at head_dim
    16), each holding the recurrent gates' columns of its units in
    registers (staged once per call through shared memory); each step
    every CTA computes its units' four gates and the update and stores
    its new h into every CTA's next buffer with st.async, which
    completes an mbarrier's transaction there: no cluster barrier in the
    step loop.  The backward walks T in reverse over the states the
    forward saved and reduces dh_{t-1} = R . dgates_t across its cluster
    by the same exchange: each CTA's partial sums go to each unit's
    owner by st.async, added there in rank order.
  * mLSTM, by two routes (``mlstm_scan_route``).  The walk (a call with
    lens, or shorter than the source's crossover): a CTA owns a slab of
    32 v-rows of one (row, head)'s matrix memory in registers across the
    whole walk and recomputes the head's normaliser itself; no exchange
    between CTAs.  Chunkwise (no lens, T at or above the crossover:
    training's forward and the long call; ``ref.mlstm_chunkwise_fwd_ref``'s
    algebra): the stabiliser's scan, the memory at chunk boundaries
    walked over chunks of 64 steps, and h of every chunk at once as
    masked matrix products.  The backward is
    chunkwise-parallel (``ref.mlstm_chunkwise_bwd_ref``'s algebra): the
    memory at chunk boundaries and its gradient carried back are walked
    over chunks of 64 steps, the gradients inside the chunks are masked
    matrix products, all chunks at once, and the stabiliser's chain is a
    scan over lane segments; every sum in one fixed order, no atomics
    (bitwise on repeat).

On the sLSTM and the mLSTM's walk, every step's arithmetic is the same
wherever a call starts and however long it is, so a call split in T
with the state carried gives the bits of one call, and a row past its
length keeps its state bit for bit.  The mLSTM's chunkwise route sums
in another order (bitwise on repeat, not across a split).

``SLSTMFn`` / ``MLSTMFn`` are the autograd Functions of the recurrences
over every step (no lens): the kernels and their backward kernels on the
card, the plain versions (``ref``) on the CPU, shapes only on ``meta``.
The sLSTM's recurrent-gate and bias gradients are one product and one
sum after the reverse walk, as the reference leaves them to XLA.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref
from repro_torch.kernels.launches import counted

# xlstm-125m's (sLSTM 768 / 4 heads, mLSTM 1536 / 4), the serve CLI's
# reduced width (d_model 128) and the reduced configs' (d_model 64)
SLSTM_HEAD_DIMS = (16, 32, 64, 192)
MLSTM_HEAD_DIMS = (32, 64, 384)

_P = ctypes.c_void_p
_I = ctypes.c_int
F32 = torch.float32


def _seq_like(state: torch.Tensor, t: int) -> torch.Tensor:
    """A fresh (B, T, ...) fp32 tensor placed as the (B, ...) ``state``."""
    return torch.empty_like(state.unsqueeze(1).expand(
        state.shape[0], t, *state.shape[1:]), dtype=F32)


def _meta_note(name: str, **shapes) -> None:
    from repro_torch.kernels.ops import local_shape, meta_call
    meta_call(name, **{k: (local_shape(v) if isinstance(v, torch.Tensor)
                           else v) for k, v in shapes.items()})


# ---------------------------------------------------------------------------
# Checks shared by the wrappers
# ---------------------------------------------------------------------------


def _check_tensors(device, named, dtype=F32) -> None:
    for name, v in named:
        if v is None:
            continue
        if v.device != device:
            raise ValueError(f"{name} is on {v.device}, want {device}")
        if dtype is not None and v.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {v.dtype}")
        if not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if v.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")


def _check_shape(name: str, v: Optional[torch.Tensor], shape) -> None:
    if v is not None and tuple(v.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, got "
                         f"{tuple(v.shape)}")


def _check_lens(lens: Optional[torch.Tensor], bsz: int, device) -> None:
    if lens is None:
        return
    if lens.dtype != torch.int32 or tuple(lens.shape) != (bsz,) \
            or lens.device != device or not lens.is_contiguous():
        raise ValueError(f"lens must be a contiguous (B,) int32 tensor on "
                         f"{device}")


def _ptr(v: Optional[torch.Tensor]):
    return None if v is None else v.data_ptr()


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _raise_rc(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def _slstm_dims(gates_x: torch.Tensor, r: torch.Tensor):
    if gates_x.dim() != 3 or r.dim() != 3:
        raise ValueError(f"want gates_x (B,T,4d) and r (H,hd,4hd); got "
                         f"{tuple(gates_x.shape)}, {tuple(r.shape)}")
    bsz, t, four_d = gates_x.shape
    nh, hd = r.shape[0], r.shape[1]
    if r.shape[2] != 4 * hd or four_d != 4 * nh * hd:
        raise ValueError(f"gates_x {tuple(gates_x.shape)} and r "
                         f"{tuple(r.shape)} disagree on H x 4hd")
    if hd not in SLSTM_HEAD_DIMS:
        raise ValueError(f"sLSTM head_dim {hd} not in {SLSTM_HEAD_DIMS}")
    if r.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"r must be float32 or bfloat16, got {r.dtype}")
    return bsz, t, nh, hd


def _slstm_lib() -> ctypes.CDLL:
    lib = build.load("slstm_scan")
    fn = lib.apex_slstm_scan
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _I, _P] + [_P] * 5 + [_P] * 5 + [_P] * 4 \
            + [_I] * 4 + [_P]
        fn.restype = _I
    return lib


@counted
def slstm_scan_cuda(gates_x: torch.Tensor, r: torch.Tensor,
                    bias: torch.Tensor, c: torch.Tensor, n: torch.Tensor,
                    h: torch.Tensor, m: torch.Tensor,
                    lens: Optional[torch.Tensor] = None,
                    save: bool = False):
    """``ref.slstm_recurrence_ref`` in one launch: gates_x (B,T,4d) fp32,
    r (H,hd,4hd) fp32 or bf16, bias (4d,) fp32, c/n/h/m (B,H,hd) fp32,
    lens (B,) int32 or None -> (hs (B,T,H,hd), c, n, h, m), fresh fp32
    tensors; with ``save`` also (acts (B,T,4d), cs, ns, ms (B,T,H,hd)).
    On the current stream, no sync."""
    if not gates_x.is_cuda:
        raise ValueError("slstm_scan_cuda takes CUDA tensors")
    bsz, t, nh, hd = _slstm_dims(gates_x, r)
    for name, v in (("c", c), ("n", n), ("h", h), ("m", m)):
        _check_shape(name, v, (bsz, nh, hd))
    _check_shape("bias", bias, (4 * nh * hd,))
    dev = gates_x.device
    _check_tensors(dev, [("gates_x", gates_x), ("bias", bias), ("c", c),
                         ("n", n), ("h", h), ("m", m)])
    _check_tensors(dev, [("r", r)], dtype=None)
    _check_lens(lens, bsz, dev)
    if save and lens is not None:
        raise ValueError("the saved form runs every step (no lens)")
    hs = torch.empty((bsz, t, nh, hd), dtype=F32, device=dev)
    outs = [torch.empty_like(v) for v in (c, n, h, m)]
    aux = [torch.empty_like(gates_x)] + [torch.empty_like(hs)
                                         for _ in range(3)] if save else []
    rc = _slstm_lib().apex_slstm_scan(
        gates_x.data_ptr(), r.data_ptr(), int(r.dtype == torch.bfloat16),
        bias.data_ptr(), c.data_ptr(), n.data_ptr(), h.data_ptr(),
        m.data_ptr(), _ptr(lens), hs.data_ptr(),
        *[o.data_ptr() for o in outs],
        *([a.data_ptr() for a in aux] if save else [None] * 4),
        bsz, t, nh, hd, _stream(dev))
    _raise_rc("slstm_scan", rc)
    slstm_scan_cuda.add_launch()
    return (hs, *outs, *aux)


def _slstm_bwd_lib() -> ctypes.CDLL:
    lib = build.load("slstm_scan_bwd")
    fn = lib.apex_slstm_scan_bwd
    if fn.argtypes is None:
        fn.argtypes = [_P, _I] + [_P] * 12 + [_P] * 5 + [_I] * 4 + [_P]
        fn.restype = _I
    return lib


@counted
def slstm_scan_bwd_cuda(r: torch.Tensor, acts: torch.Tensor,
                        cs: torch.Tensor, ns: torch.Tensor, ms: torch.Tensor,
                        c0: torch.Tensor, n0: torch.Tensor, m0: torch.Tensor,
                        dhs: torch.Tensor,
                        dstate: Tuple[Optional[torch.Tensor], ...]
                        = (None, None, None, None)):
    """``ref.slstm_recurrence_bwd_ref`` in one launch: r (H,hd,4hd), acts
    (B,T,4d) and cs, ns, ms (B,T,H,hd) from the saved forward, c0, n0, m0
    (B,H,hd), dhs (B,T,H,hd), the final state's gradients (dc, dn, dh,
    dm) or None each -> (dacts (B,T,4d), dc0, dn0, dh0, dm0), fp32."""
    if not acts.is_cuda:
        raise ValueError("slstm_scan_bwd_cuda takes CUDA tensors")
    bsz, t, nh, hd = _slstm_dims(acts, r)
    dev = acts.device
    for name, v in (("cs", cs), ("ns", ns), ("ms", ms), ("dhs", dhs)):
        _check_shape(name, v, (bsz, t, nh, hd))
    for name, v in (("c0", c0), ("n0", n0), ("m0", m0)) + tuple(
            zip(("dc", "dn", "dh", "dm"), dstate)):
        _check_shape(name, v, (bsz, nh, hd))
    _check_tensors(dev, [("acts", acts), ("cs", cs), ("ns", ns),
                         ("ms", ms), ("c0", c0), ("n0", n0), ("m0", m0),
                         ("dhs", dhs)] + list(zip(("dc", "dn", "dh", "dm"),
                                                  dstate)))
    _check_tensors(dev, [("r", r)], dtype=None)
    dacts = torch.empty_like(acts)
    grads0 = [torch.empty_like(c0) for _ in range(4)]
    rc = _slstm_bwd_lib().apex_slstm_scan_bwd(
        r.data_ptr(), int(r.dtype == torch.bfloat16), acts.data_ptr(),
        cs.data_ptr(), ns.data_ptr(), ms.data_ptr(), c0.data_ptr(),
        n0.data_ptr(), m0.data_ptr(), dhs.data_ptr(),
        *[_ptr(g) for g in dstate], dacts.data_ptr(),
        *[g.data_ptr() for g in grads0], bsz, t, nh, hd, _stream(dev))
    _raise_rc("slstm_scan_bwd", rc)
    slstm_scan_bwd_cuda.add_launch()
    return (dacts, *grads0)


def meta_slstm(gates_x, r, c, n, h, m, save: bool = False,
               backward: bool = False):
    """The sLSTM outputs' shapes for a meta call, noted for
    ``ops.record_meta_calls``: (hs, c, n, h, m), and with ``save`` the
    saved (acts, cs, ns, ms)."""
    _meta_note("slstm_recurrence_bwd" if backward else "slstm_recurrence",
               gates=gates_x, state=c, dtype=r.dtype, save=save)
    t = gates_x.shape[1]
    hs = _seq_like(h, t)
    outs = (hs,) + tuple(torch.empty_like(v) for v in (c, n, h, m))
    if save:
        outs += (torch.empty_like(gates_x),) + tuple(
            _seq_like(h, t) for _ in range(3))
    return outs


def _slstm_dparams(r, bias, h0, hs, dacts):
    """The recurrent gates' and the bias's gradients after the walk:
    dR = sum_{b,t} h_{t-1} (x) dacts_t (one batched product), dbias =
    sum_{b,t} dacts_t."""
    bsz, t, nh, hd = hs.shape
    d4 = dacts.reshape(bsz, t, nh, 4 * hd)
    h_prev = torch.cat([h0.unsqueeze(1), hs[:, :-1]], dim=1)
    dr = torch.einsum("bthd,bthe->hde", h_prev, d4)
    return dr.to(r.dtype), d4.sum((0, 1)).reshape(bias.shape).to(bias.dtype)


class SLSTMFn(torch.autograd.Function):
    """Differentiable sLSTM recurrence over every step (no lens): (hs, c,
    n, h, m) of ``ref.slstm_recurrence_ref``.  Saves r, the initial
    state, hs and the forward's per-step gate pre-activations and states;
    the backward walks them in reverse."""

    @staticmethod
    def forward(ctx, gates_x, r, bias, c, n, h, m):
        ctx.set_materialize_grads(False)
        if gates_x.device.type == "meta":     # shapes only (``kernels.ops``)
            hs, co, no, ho, mo, acts, cs, ns, ms = meta_slstm(
                gates_x, r, c, n, h, m, save=True)
        elif gates_x.device.type == "cpu":
            hs, co, no, ho, mo, acts, cs, ns, ms = ref.slstm_recurrence_ref(
                gates_x, r, bias, c, n, h, m, save=True)
        else:
            hs, co, no, ho, mo, acts, cs, ns, ms = slstm_scan_cuda(
                gates_x.contiguous(), r.contiguous(), bias.contiguous(),
                *(v.contiguous() for v in (c, n, h, m)), save=True)
        ctx.save_for_backward(r, bias, c, n, h, m, hs, acts, cs, ns, ms)
        ctx.gates_shape = gates_x.shape
        return hs, co, no, ho, mo

    @staticmethod
    def backward(ctx, dhs, dc, dn, dh, dm):
        r, bias, c0, n0, h0, m0, hs, acts, cs, ns, ms = ctx.saved_tensors
        bsz, t, nh, hd = hs.shape
        dstate = tuple(None if g is None else g.contiguous()
                       for g in (dc, dn, dh, dm))
        dhs = torch.zeros_like(hs) if dhs is None else dhs.contiguous()
        if hs.device.type == "meta":
            meta_slstm(acts, r, c0, n0, h0, m0, backward=True)
            dacts = torch.empty_like(acts)
            grads0 = tuple(torch.empty_like(v) for v in (c0, n0, h0, m0))
        elif hs.device.type == "cpu":
            dacts, *grads0 = ref.slstm_recurrence_bwd_ref(
                r, acts, cs, ns, ms, c0, n0, m0, dhs, dstate)
            dacts = dacts.reshape(acts.shape)
        else:
            dacts, *grads0 = slstm_scan_bwd_cuda(
                r.contiguous(), acts, cs, ns, ms, c0.contiguous(),
                n0.contiguous(), m0.contiguous(), dhs, dstate)
        dr, dbias = _slstm_dparams(r, bias, h0, hs, dacts)
        return (dacts.reshape(ctx.gates_shape), dr, dbias, *grads0)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def _mlstm_dims(q: torch.Tensor):
    if q.dim() != 4:
        raise ValueError(f"want q (B,T,H,hd); got {tuple(q.shape)}")
    bsz, t, nh, hd = q.shape
    if hd not in MLSTM_HEAD_DIMS:
        raise ValueError(f"mLSTM head_dim {hd} not in {MLSTM_HEAD_DIMS}")
    return bsz, t, nh, hd


def _check_mlstm(q, k, v, i_pre, f_pre, cmat, n, m) -> Tuple[int, ...]:
    bsz, t, nh, hd = _mlstm_dims(q)
    for name, x in (("k", k), ("v", v)):
        _check_shape(name, x, (bsz, t, nh, hd))
    for name, x in (("i_pre", i_pre), ("f_pre", f_pre)):
        _check_shape(name, x, (bsz, t, nh))
    _check_shape("cmat", cmat, (bsz, nh, hd, hd))
    _check_shape("n", n, (bsz, nh, hd))
    _check_shape("m", m, (bsz, nh))
    _check_tensors(q.device, [("q", q), ("k", k), ("v", v),
                              ("i_pre", i_pre), ("f_pre", f_pre),
                              ("cmat", cmat), ("n", n), ("m", m)])
    return bsz, t, nh, hd


def _mlstm_lib() -> ctypes.CDLL:
    lib = build.load("mlstm_scan")
    fn = lib.apex_mlstm_scan
    if fn.argtypes is None:
        fn.argtypes = [_P] * 9 + [_P] * 4 + [_I] * 4 + [_P]
        fn.restype = _I
        lib.apex_mlstm_scan_chunkwise.argtypes = [_P] * 8 + [_P] * 5 \
            + [_I] * 4 + [_P]
        lib.apex_mlstm_scan_chunkwise.restype = _I
        lib.apex_mlstm_scan_chunkwise_scratch_floats.argtypes = [_I] * 4
        lib.apex_mlstm_scan_chunkwise_scratch_floats.restype = \
            ctypes.c_longlong
        lib.apex_mlstm_scan_route.argtypes = [_I, _I]
        lib.apex_mlstm_scan_route.restype = _I
    return lib


_MLSTM_ROUTES = ("walk", "chunkwise")


def mlstm_scan_route(t: int, lens: Optional[torch.Tensor]) -> str:
    """The kernels ``mlstm_scan_cuda`` launches for a call of T ``t``, as
    the library's dispatch says: "walk" (one kernel a call, step by step;
    any call with ``lens``, and calls below the source's crossover) or
    "chunkwise" (four kernels, parallel within chunks of 64 steps)."""
    return _MLSTM_ROUTES[_mlstm_lib().apex_mlstm_scan_route(
        t, int(lens is not None))]


def _mlstm_scan(q, k, v, i_pre, f_pre, cmat, n, m, lens, route: str):
    """``mlstm_scan_cuda``'s launch by the named route ("chunkwise" takes
    no lens); the card's tests also call it to hold the chunkwise route
    below the crossover."""
    if not q.is_cuda:
        raise ValueError("mlstm_scan_cuda takes CUDA tensors")
    bsz, t, nh, hd = _check_mlstm(q, k, v, i_pre, f_pre, cmat, n, m)
    _check_lens(lens, bsz, q.device)
    lib = _mlstm_lib()
    hs = torch.empty_like(q)
    outs = [torch.empty_like(x) for x in (cmat, n, m)]
    ins = [x.data_ptr() for x in (q, k, v, i_pre, f_pre, cmat, n, m)]
    tail = [hs.data_ptr(), *[o.data_ptr() for o in outs], bsz, t, nh, hd,
            _stream(q.device)]
    if route == "walk":
        rc = lib.apex_mlstm_scan(*ins, _ptr(lens), *tail)
    elif route == "chunkwise" and lens is None:
        scratch = torch.empty(
            (lib.apex_mlstm_scan_chunkwise_scratch_floats(bsz, t, nh, hd),),
            dtype=F32, device=q.device)
        rc = lib.apex_mlstm_scan_chunkwise(*ins, scratch.data_ptr(), *tail)
    else:
        raise ValueError(f"no mLSTM route {route!r} with lens {lens}")
    _raise_rc("mlstm_scan", rc)
    return (hs, *outs)


@counted
def mlstm_scan_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    i_pre: torch.Tensor, f_pre: torch.Tensor,
                    cmat: torch.Tensor, n: torch.Tensor, m: torch.Tensor,
                    lens: Optional[torch.Tensor] = None):
    """``ref.mlstm_recurrence_ref`` in one call: q, k, v (B,T,H,hd),
    i_pre, f_pre (B,T,H), cmat (B,H,hd,hd), n (B,H,hd), m (B,H), all fp32;
    lens (B,) int32 or None -> (hs (B,T,H,hd), cmat, n, m), fresh fp32
    tensors.  The walk is one launch; the chunkwise route
    (``mlstm_scan_route``) launches the source's four kernels over one
    scratch tensor.  On the current stream, no sync."""
    if not q.is_cuda:
        raise ValueError("mlstm_scan_cuda takes CUDA tensors")
    outs = _mlstm_scan(q, k, v, i_pre, f_pre, cmat, n, m, lens,
                       mlstm_scan_route(q.shape[1], lens))
    mlstm_scan_cuda.add_launch()
    return outs


def _mlstm_bwd_lib() -> ctypes.CDLL:
    lib = build.load("mlstm_scan_bwd")
    fn = lib.apex_mlstm_scan_bwd
    if fn.argtypes is None:
        fn.argtypes = [_P] * 13 + [_P] + [_P] * 8 + [_I] * 4 + [_P]
        fn.restype = _I
        lib.apex_mlstm_scan_bwd_scratch_floats.argtypes = [_I] * 4
        lib.apex_mlstm_scan_bwd_scratch_floats.restype = ctypes.c_longlong
    return lib


@counted
def mlstm_scan_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        i_pre: torch.Tensor, f_pre: torch.Tensor,
                        cmat0: torch.Tensor, n0: torch.Tensor,
                        m0: torch.Tensor, hs: torch.Tensor,
                        dhs: torch.Tensor,
                        dstate: Tuple[Optional[torch.Tensor], ...]
                        = (None, None, None)):
    """``ref.mlstm_recurrence_bwd_ref`` in one call: the forward's inputs,
    its emitted hs, dhs (B,T,H,hd) and the final state's gradients
    (dcmat, dn, dm) or None each -> (dq, dk, dv, di, df, dcmat0, dn0,
    dm0), fp32.  Chunkwise-parallel (``ref.mlstm_chunkwise_bwd_ref``'s
    algebra): one scratch tensor holds the boundary memories and their
    gradients, the chunks' masked products and the per-step scalars.
    Launches the source's six kernels on the current stream, no sync."""
    if not q.is_cuda:
        raise ValueError("mlstm_scan_bwd_cuda takes CUDA tensors")
    bsz, t, nh, hd = _check_mlstm(q, k, v, i_pre, f_pre, cmat0, n0, m0)
    dev = q.device
    _check_shape("hs", hs, q.shape)
    _check_shape("dhs", dhs, q.shape)
    for name, g, x in zip(("dcmat", "dn", "dm"), dstate, (cmat0, n0, m0)):
        _check_shape(name, g, x.shape)
    _check_tensors(dev, [("hs", hs), ("dhs", dhs)]
                   + list(zip(("dcmat", "dn", "dm"), dstate)))
    lib = _mlstm_bwd_lib()
    scratch = torch.empty(
        (lib.apex_mlstm_scan_bwd_scratch_floats(bsz, t, nh, hd),),
        dtype=F32, device=dev)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    di, df = torch.empty_like(i_pre), torch.empty_like(f_pre)
    grads0 = [torch.empty_like(x) for x in (cmat0, n0, m0)]
    rc = lib.apex_mlstm_scan_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), i_pre.data_ptr(),
        f_pre.data_ptr(), cmat0.data_ptr(), n0.data_ptr(), m0.data_ptr(),
        hs.data_ptr(), dhs.data_ptr(), *[_ptr(g) for g in dstate],
        scratch.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        di.data_ptr(), df.data_ptr(), *[g.data_ptr() for g in grads0],
        bsz, t, nh, hd, _stream(dev))
    _raise_rc("mlstm_scan_bwd", rc)
    mlstm_scan_bwd_cuda.add_launch()
    return (dq, dk, dv, di, df, *grads0)


def meta_mlstm(q, cmat, n, m, backward: bool = False):
    """The mLSTM outputs' shapes for a meta call, noted for
    ``ops.record_meta_calls``: (hs, cmat, n, m)."""
    _meta_note("mlstm_recurrence_bwd" if backward else "mlstm_recurrence",
               q=q, dtype=q.dtype)
    return (torch.empty_like(q, dtype=F32),) + tuple(
        torch.empty_like(x) for x in (cmat, n, m))


class MLSTMFn(torch.autograd.Function):
    """Differentiable mLSTM recurrence over every step (no lens): (hs,
    cmat, n, m) of ``ref.mlstm_recurrence_ref``.  Saves the inputs and
    hs; the backward recomputes the memory."""

    @staticmethod
    def forward(ctx, q, k, v, i_pre, f_pre, cmat, n, m):
        ctx.set_materialize_grads(False)
        if q.device.type == "meta":           # shapes only (``kernels.ops``)
            outs = meta_mlstm(q, cmat, n, m)
        elif q.device.type == "cpu":
            outs = ref.mlstm_recurrence_ref(q, k, v, i_pre, f_pre, cmat, n,
                                            m)
        else:
            q, k, v, i_pre, f_pre, cmat, n, m = (
                x.contiguous() for x in (q, k, v, i_pre, f_pre, cmat, n, m))
            outs = mlstm_scan_cuda(q, k, v, i_pre, f_pre, cmat, n, m)
        ctx.save_for_backward(q, k, v, i_pre, f_pre, cmat, n, m, outs[0])
        return outs

    @staticmethod
    def backward(ctx, dhs, dcmat, dn, dm):
        q, k, v, i_pre, f_pre, cmat0, n0, m0, hs = ctx.saved_tensors
        dstate = tuple(None if g is None else g.contiguous()
                       for g in (dcmat, dn, dm))
        dhs = torch.zeros_like(hs) if dhs is None else dhs.contiguous()
        if q.device.type == "meta":
            meta_mlstm(q, cmat0, n0, m0, backward=True)
            return tuple(torch.empty_like(x) for x in
                         (q, k, v, i_pre, f_pre, cmat0, n0, m0))
        if q.device.type == "cpu":
            return ref.mlstm_recurrence_bwd_ref(q, k, v, i_pre, f_pre, cmat0,
                                                n0, m0, hs, dhs, dstate)
        return mlstm_scan_bwd_cuda(q, k, v, i_pre, f_pre, cmat0, n0, m0, hs,
                                   dhs, dstate)
