"""Wrappers of the hand-written CUDA K-list continuous-conv kernels
(forward ``csrc/cconv_klist.cu``, backward ``csrc/cconv_klist_bwd.cu``) and
their plain PyTorch versions.

Port of the TPU kernel ``dmcf_tpu/experimental/pallas_cconv.py``
``pallas_continuous_conv``.  Contract (both versions):

  idx    [Q, K] int32 neighbor indices into ``feats``, clamped into
         [0, N) inside the kernel and the twin: an index past the end
         reads row N-1, as JAX's clamped gather does; a negative one
         reads row 0, a safety clamp of the port only (JAX wraps it to
         idx + N first; the model makes no negative index)
  a      [Q, K] fp32 per-slot weight (validity * window), 0 on empty slots
  t      [Q, K, 3] fp32 centred filter coordinates (tz, ty, tx), after the
         ball->cube mapping
  feats  [N, Cin] fp32
  w      [S*Cin, Cout] fp32, the filter array [kz, ky, kx, Cin, Cout]
         flattened
  qfeats [Q, Cin] fp32 or None; given, the symmetric (ASCC) self term
         ``(sum_k A[k]) f_q`` is added to T
  precision "highest" (fp32 throughout) or None / "default" (the bf16
         variant, below)
  returns out [Q, Cout] fp32

The bf16 variant is the JAX package's ``fast_bf16`` contraction
(``dmcf_tpu/ops/cconv.py:continuous_conv`` at ``precision="default"``,
:241, :279-312): the taps rounded once, ``A = bf16(((wz*wy)*wx)*a)``;
the features rounded to bf16 before the gather; ``T = bf16(sum_k A f)``,
exact products summed in fp32 and rounded once; ``out = sum T bf16(W)``,
summed in fp32, with an fp32 output.  It has no symmetric form (JAX's
depends on the platform there; the model's ASCC convs run "highest").
On CUDA tensors the features and W go to the kernels as bf16 tensors,
converted once a conv (``feats``/``w`` may also be given as bf16).
Its derivative rounds where JAX's VJP does: ``dT = bf16(bf16(W)^T dout)``,
the slots' tap gradients ``bf16(sum_c dT g)``, ``dW = bf16(T^T dout)``.
JAX scatter-adds the slots' feature gradients in bf16; here they are
summed in fp32 and rounded to bf16 once (ROADMAP §3).

The kernels take S <= 1024, S*Cin <= 8192, 1 <= Cout <= 256 and K, N >= 1.
A CPU tensor goes to ``cconv_klist_reference``, which autograd
differentiates; a CUDA tensor goes through ``_KListConv``, an autograd
Function whose forward launches the forward kernel and whose backward
launches the two backward kernels (``cconv_klist_bwd_data`` for the
gradients of feats, qfeats, a and t; ``cconv_klist_bwd_filter`` for w), or
raises — there is no fallback.

The hats' derivative is PyTorch autograd's on the twin's
``relu(1 - |clamp(t, -h, h) - p|)``: clamp' = 1 on [-h, h] (bounds
included), |u|' = sign(u) (0 at 0), relu'(v) = 1 for v > 0 (0 at 0).  The
backward kernels and ``cconv_klist_bwd_reference`` follow it.  JAX takes
|u|'(0) = 1 and a clip's gradient 1/2 at a bound, so on a 2D config (z
axis of size 1, t_z clamped to [0, 0]) the gradient in t_z differs; t_z is
z scaled by 0, so position and parameter gradients do not (ROADMAP §3).
An out-of-range ``idx`` sends its slot's gradient to row N-1, the row the
forward read; JAX's gather VJP drops it (ROADMAP §3).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..ops.coords import axis_interp_weights
from .build import load_library


def _tap_tensor(t, a, kernel_size):
    """Dense tap tensor A [Q, K, S] = ((wz * wy) * wx) * a, in the
    reference's product order."""
    kz, ky, kx = kernel_size
    q, k = a.shape
    wz = axis_interp_weights(t[..., 0], kz, "linear")
    wy = axis_interp_weights(t[..., 1], ky, "linear")
    wx = axis_interp_weights(t[..., 2], kx, "linear")
    wzy = (wz[..., :, None] * wy[..., None, :]).reshape(q, k, kz * ky)
    A = (wzy[..., :, None] * wx[..., None, :]).reshape(q, k, kz * ky * kx)
    return A * a[..., None]


def is_bf16(precision):
    """Whether ``precision`` selects the bf16 contraction (JAX's
    ``fast_bf16``: None or "default"); raises on a value the port does not
    know."""
    if precision in (None, "default"):
        return True
    if precision == "highest":
        return False
    raise ValueError(f"precision must be None, 'default' or 'highest', "
                     f"got {precision!r}")


def round_bf16(x):
    """x rounded to bf16 (round to nearest even), held in fp32."""
    return x.to(torch.bfloat16).float()


def cconv_klist_reference(idx, a, t, feats, w, kernel_size, qfeats=None,
                          precision="highest"):
    """Plain PyTorch twin of the kernel (same contract).  Under autograd
    its casts round the cotangents as the bf16 kernels do."""
    q, k = idx.shape
    cin = feats.shape[1]
    s_total = kernel_size[0] * kernel_size[1] * kernel_size[2]
    bf16 = is_bf16(precision)
    if bf16 and qfeats is not None:
        raise NotImplementedError(
            "the symmetric K-list conv has no bf16 variant")
    A = _tap_tensor(t, a, kernel_size)
    if bf16:
        A, feats, w = round_bf16(A), round_bf16(feats), round_bf16(w)
    # JAX clamps out-of-range gathers and the reference's obs_conv relies on
    # it (ROADMAP §3): clamp so the twin reads the same rows
    f = feats[idx.long().clamp(0, feats.shape[0] - 1)]
    T = torch.einsum("qks,qkc->qsc", A, f)
    if qfeats is not None:
        T = T + A.sum(dim=1)[:, :, None] * qfeats[:, None, :]
    if bf16:
        T = round_bf16(T)
    return T.reshape(q, s_total * cin) @ w


def rounding_flips(got, want):
    """Compares two bf16 tensors (or fp32 ones holding bf16 values) that
    round the same fp32 sums taken in different orders, so that an element
    lying at a rounding midpoint may come out one bf16 step apart: returns
    (max abs difference over the elements that are not one step apart,
    number of elements exactly one step apart)."""
    w = want.to(torch.bfloat16)
    bits = w.view(torch.int16)
    g = got.float()
    flip = torch.zeros_like(g, dtype=torch.bool)
    for step in (1, -1):  # the neighbours away from and towards zero
        n = (bits + step).view(torch.bfloat16).float()
        flip |= (g == n) & (w != 0)
    err = torch.where(flip, 0.0, (g - w.float()).abs())
    return float(err.max()) if err.numel() else 0.0, int(flip.sum())


def _check(name, x, dtype, shape, device):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                         f"{tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def cconv_klist_bwd_reference(dout, idx, a, t, feats, w, kernel_size,
                              qfeats=None, precision="highest"):
    """Plain PyTorch backward of the K-list conv: the vector-Jacobian
    product of ``cconv_klist_reference`` with ``dout`` [Q, Cout], by
    autograd of the dense taps (and of the twin's casts, in the bf16
    variant).  Returns (dfeats [N, Cin], dqfeats [Q, Cin] or None, dw
    [S*Cin, Cout], da [Q, K], dt [Q, K, 3]).  An out-of-range ``idx``
    sends its slot's gradient to the clamped row."""
    leaves = [x.detach().requires_grad_(True) for x in (a, t, feats, w)]
    qf = None if qfeats is None else qfeats.detach().requires_grad_(True)
    with torch.enable_grad():
        out = cconv_klist_reference(idx, *leaves, kernel_size, qfeats=qf,
                                    precision=precision)
        grads = torch.autograd.grad(
            out, leaves + ([] if qf is None else [qf]), dout,
            allow_unused=True)
    da, dt, dfeats, dw = (torch.zeros_like(x) if g is None else g
                          for x, g in zip(leaves, grads[:4]))
    dqfeats = None if qf is None else grads[4]
    return dfeats, dqfeats, dw, da, dt


@functools.cache
def _launcher():
    """``cconv_klist_launch`` of the built library, its ctypes signature
    set once."""
    fn = load_library("cconv_klist").cconv_klist_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 \
        + [ctypes.c_void_p]
    return fn


@functools.cache
def _bwd_launchers():
    """The backward library's (data, filter, filter workspace) entry
    points, their ctypes signatures set once."""
    lib = load_library("cconv_klist_bwd")
    data = lib.cconv_klist_bwd_data_launch
    data.restype = ctypes.c_int
    data.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 9 \
        + [ctypes.c_void_p]
    filt = lib.cconv_klist_bwd_filter_launch
    filt.restype = ctypes.c_int
    filt.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 \
        + [ctypes.c_void_p]
    work = lib.cconv_klist_bwd_filter_workspace
    work.restype = ctypes.c_longlong
    work.argtypes = [ctypes.c_int] * 8
    return data, filt, work


@functools.lru_cache(maxsize=1024)
def _filter_workspace(q, k, n, cin, cout, kz, ky, kx):
    """Floats of the filter kernel's workspace at this shape (0: none)."""
    return int(_bwd_launchers()[2](q, k, n, cin, cout, kz, ky, kx))


def _shapes(idx, a, t, feats, w, kernel_size, qfeats, dout=None):
    """Checks the contract's inputs on one CUDA device (feats and w fp32,
    or both bf16 with no qfeats: the bf16 variant); returns (q, k, n, cin,
    cout, kz, ky, kx, bf16)."""
    q, k = idx.shape
    n, cin = feats.shape
    kz, ky, kx = (int(s) for s in kernel_size)
    s_total = kz * ky * kx
    cout = w.shape[1]
    dev = feats.device
    bf16 = feats.dtype == torch.bfloat16
    _check("idx", idx, torch.int32, (q, k), dev)
    _check("a", a, torch.float32, (q, k), dev)
    _check("t", t, torch.float32, (q, k, 3), dev)
    _check("feats", feats, torch.bfloat16 if bf16 else torch.float32,
           (n, cin), dev)
    _check("w", w, feats.dtype, (s_total * cin, cout), dev)
    if qfeats is not None:
        if bf16:
            raise NotImplementedError(
                "the symmetric K-list conv has no bf16 variant")
        _check("qfeats", qfeats, torch.float32, (q, cin), dev)
    if dout is not None:
        _check("dout", dout, torch.float32, (q, cout), dev)
    if not (1 <= cout <= 256 and s_total <= 1024
            and s_total * cin <= 8192 and k >= 1 and n >= 1):
        raise ValueError(
            f"cconv_klist kernels take S <= 1024, S*Cin <= 8192, "
            f"1 <= Cout <= 256 and K, N >= 1 (got S={s_total}, Cin={cin}, "
            f"Cout={cout}, K={k}, N={n})")
    return q, k, n, cin, cout, kz, ky, kx, int(bf16)


def _raise_on(err, name):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _ptr(x):
    return None if x is None else x.data_ptr()


def _count(fn, bf16):
    if bf16:
        fn.launches_bf16 += 1
    else:
        fn.launches += 1


def _variant(feats, w, precision):
    """feats and w in the dtype of the variant ``precision`` selects."""
    if is_bf16(precision):
        return feats.to(torch.bfloat16), w.to(torch.bfloat16)
    return feats, w


def _launch(idx, a, t, feats, w, kernel_size, qfeats):
    shape = _shapes(idx, a, t, feats, w, kernel_size, qfeats)
    q, cout = shape[0], shape[4]
    out = torch.empty((q, cout), dtype=torch.float32, device=feats.device)
    stream = torch.cuda.current_stream(feats.device).cuda_stream
    _raise_on(_launcher()(idx.data_ptr(), a.data_ptr(), t.data_ptr(),
                          feats.data_ptr(), _ptr(qfeats), w.data_ptr(),
                          out.data_ptr(), *shape, stream), "cconv_klist")
    _count(cconv_klist, shape[-1])
    return out


def cconv_klist_bwd_data(dout, idx, a, t, feats, w, kernel_size,
                         qfeats=None, precision="highest"):
    """Gradients of the K-list conv in its data inputs: (dfeats, dqfeats or
    None, da, dt).  CUDA tensors launch ``cconv_klist_bwd_data_kernel``
    (dfeats and dqfeats summed with float atomics: two launches may differ
    in the last bits; in the bf16 variant dfeats is then rounded to a bf16
    tensor); CPU tensors take ``cconv_klist_bwd_reference``."""
    if not feats.is_cuda:
        dfeats, dqfeats, _, da, dt = cconv_klist_bwd_reference(
            dout, idx, a, t, feats, w, kernel_size, qfeats, precision)
        return dfeats, dqfeats, da, dt
    feats, w = _variant(feats, w, precision)
    shape = _shapes(idx, a, t, feats, w, kernel_size, qfeats, dout)
    dfeats = torch.zeros(feats.shape, dtype=torch.float32,
                         device=feats.device)
    dqfeats = None if qfeats is None else torch.zeros_like(qfeats)
    da = torch.empty_like(a)
    dt = torch.empty_like(t)
    stream = torch.cuda.current_stream(feats.device).cuda_stream
    _raise_on(_bwd_launchers()[0](
        idx.data_ptr(), a.data_ptr(), t.data_ptr(), feats.data_ptr(),
        _ptr(qfeats), w.data_ptr(), dout.data_ptr(), dfeats.data_ptr(),
        _ptr(dqfeats), da.data_ptr(), dt.data_ptr(), *shape, stream),
        "cconv_klist_bwd_data")
    _count(cconv_klist_bwd_data, shape[-1])
    return dfeats.to(feats.dtype), dqfeats, da, dt


def cconv_klist_bwd_filter(dout, idx, a, t, feats, w, kernel_size,
                           qfeats=None, precision="highest"):
    """Gradient of the K-list conv in its filter ``w``: dw [S*Cin, Cout].
    CUDA tensors launch ``cconv_klist_bwd_filter_kernel`` (deterministic:
    per-group partials over query tiles, summed in a fixed order by a
    second kernel where there is more than one group, so two launches give
    the same bits; in the bf16 variant dw is then rounded to a bf16
    tensor); CPU tensors take ``cconv_klist_bwd_reference``.  One call
    counts as one launch, whether it ran one kernel or two."""
    if not feats.is_cuda:
        return cconv_klist_bwd_reference(dout, idx, a, t, feats, w,
                                         kernel_size, qfeats, precision)[2]
    feats, w = _variant(feats, w, precision)
    shape = _shapes(idx, a, t, feats, w, kernel_size, qfeats, dout)
    dw = torch.empty(w.shape, dtype=torch.float32, device=w.device)
    nwork = _filter_workspace(*shape[:-1])
    work = torch.empty(nwork, dtype=torch.float32, device=w.device) \
        if nwork > 0 else None
    stream = torch.cuda.current_stream(feats.device).cuda_stream
    _raise_on(_bwd_launchers()[1](
        idx.data_ptr(), a.data_ptr(), t.data_ptr(), feats.data_ptr(),
        _ptr(qfeats), dout.data_ptr(), dw.data_ptr(), _ptr(work), *shape,
        stream), "cconv_klist_bwd_filter")
    _count(cconv_klist_bwd_filter, shape[-1])
    return dw.to(w.dtype)


class _KListConv(torch.autograd.Function):
    """The K-list conv on CUDA tensors: forward kernel, backward kernels,
    of the variant ``precision`` selects (feats and w arrive in its dtype).
    ``idx`` and ``kernel_size`` get no gradient; the data kernel runs when
    feats, qfeats, a or t needs one, the filter kernel when w does."""

    @staticmethod
    def forward(ctx, idx, a, t, feats, w, kernel_size, qfeats, precision):
        ctx.kernel_size = kernel_size
        ctx.precision = precision
        ctx.save_for_backward(idx, a, t, feats, w, qfeats)
        return _launch(idx, a, t, feats, w, kernel_size, qfeats)

    @staticmethod
    def backward(ctx, dout):
        idx, a, t, feats, w, qfeats = ctx.saved_tensors
        need = ctx.needs_input_grad
        dout = dout.contiguous()
        args = (dout, idx, a, t, feats, w, ctx.kernel_size, qfeats,
                ctx.precision)
        da = dt = dfeats = dqfeats = dw = None
        if need[1] or need[2] or need[3] or need[6]:
            dfeats, dqfeats, da, dt = cconv_klist_bwd_data(*args)
        if need[4]:
            dw = cconv_klist_bwd_filter(*args)
        return (None, da if need[1] else None, dt if need[2] else None,
                dfeats if need[3] else None, dw, None,
                dqfeats if need[6] else None, None)


def cconv_klist(idx, a, t, feats, w, kernel_size, qfeats=None,
                precision="highest"):
    """K-list continuous conv (see module docstring).  CUDA tensors go
    through the hand-written kernels of the variant ``precision`` selects
    (forward, and backward under autograd); CPU tensors take the plain
    twin."""
    if not feats.is_cuda:
        return cconv_klist_reference(idx, a, t, feats, w, kernel_size,
                                     qfeats, precision)
    feats, w = _variant(feats, w, precision)
    return _KListConv.apply(idx, a, t, feats, w, kernel_size, qfeats,
                            precision)


# launches of each CUDA kernel, per variant: ``launches`` the fp32 one,
# ``launches_bf16`` the bf16 one (plain-version calls are not counted)
cconv_klist.launches = cconv_klist.launches_bf16 = 0
cconv_klist_bwd_data.launches = cconv_klist_bwd_data.launches_bf16 = 0
cconv_klist_bwd_filter.launches = cconv_klist_bwd_filter.launches_bf16 = 0
