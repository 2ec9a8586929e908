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
raises — there is no fallback.  Every kernel is deterministic: no float
atomics, so two launches give the same bits.

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
    flip = _one_step(got, w)
    err = torch.where(flip, 0.0, (got.float() - w.float()).abs())
    return float(err.max()) if err.numel() else 0.0, int(flip.sum())


def _one_step(got, want):
    """Where ``got`` lies exactly one bf16 step from the bf16 ``want``."""
    bits = want.view(torch.int16)
    g = got.float()
    flip = torch.zeros_like(g, dtype=torch.bool)
    for step in (1, -1):  # the neighbours away from and towards zero
        n = (bits + step).view(torch.bfloat16).float()
        flip |= (g == n) & (want != 0)
    return flip


def bwd_data_from_dT(dT, idx, a, t, feats, kernel_size):
    """The bf16 plain backward's data gradients (dfeats, da, dt) with the
    gradient of T, dT [Q, S, Cin], given: the twin's T (rounded to bf16,
    as ``cconv_klist_reference`` rounds it) differentiated by autograd with
    that dT.  Fed the plain dT = bf16(dout bf16(W)^T) it is
    ``cconv_klist_bwd_reference``'s; fed the kernel's dT it shows what
    else the kernel's bf16 roundings moved."""
    leaves = [x.detach().float().requires_grad_(True) for x in (a, t, feats)]
    with torch.enable_grad():
        A = round_bf16(_tap_tensor(leaves[1], leaves[0], kernel_size))
        f = round_bf16(leaves[2])[idx.long().clamp(0, feats.shape[0] - 1)]
        T = round_bf16(torch.einsum("qks,qkc->qsc", A, f))
        da, dt, dfeats = torch.autograd.grad(T, leaves, dT)
    return dfeats, da, dt


def bf16_data_flips(dout, idx, a, t, feats, w, kernel_size, got, tol):
    """Holds the bf16 data kernel's (dfeats, da, dt) ``got`` on CUDA
    tensors the way the bf16 forward's T is held: the tensor cores sum dT
    in another order than the plain backward's fp32 product, so an element
    of dT lying at a rounding midpoint can come out one bf16 step apart,
    and move dA, da and dt downstream.  Relaunches the kernel (two
    launches give the same bits) to read its dT, and returns a dict: the
    one-step flips of dT against the plain dT (``dT_flips`` of
    ``dT_elements``, the elements on the tap rows the query's slots
    touch, the only ones the kernel reads; ``dT_err`` the largest
    difference of the other elements, ``dT_scale`` the plain dT's max);
    ``forced``, the errors of da and dt (max abs over the max) and of
    dfeats (apart from one-step flips, and their count) against
    ``bwd_data_from_dT`` fed the kernel's dT (``dfeats_scale`` its
    max); ``beyond``, the elements of da and dt beyond ``tol`` of the max
    against the plain backward itself; ``unexplained``, those of them
    whose slot touches no tap row of its query where dT flipped (a slot's
    da and dt read dT only there, so a flip can move no other)."""
    q, cin = idx.shape[0], feats.shape[1]
    s_total = int(kernel_size[0]) * int(kernel_size[1]) * int(kernel_size[2])
    f16, w16 = feats.to(torch.bfloat16), w.to(torch.bfloat16)
    shape = _shapes(idx, a, t, f16, w16, kernel_size, None, dout)
    work = torch.empty(data_workspace_bytes(*shape), dtype=torch.uint8,
                       device=dout.device)
    again = _bwd_data_launch(dout, idx, a, t, f16, w16, kernel_size, None,
                             work=work)
    if not all(torch.equal(x.to(y.dtype), y) for x, y in zip(
            (again[0], again[2], again[3]), got)):
        raise AssertionError("the data kernel's relaunch differs")
    # the kernel forms dT only on tap rows a slot of the query's tile
    # touches, and reads it only on those of the query's own slots
    hz = _tap_tensor(t, torch.ones_like(a), kernel_size) != 0
    rows = hz.any(dim=1)
    dT = work[:2 * q * s_total * cin].view(torch.bfloat16).float().reshape(
        q, s_total, cin)
    dT = torch.where(rows[..., None], dT, 0.0)
    plain = round_bf16(dout @ round_bf16(w.detach().float()).T).reshape(
        dT.shape)
    plain = torch.where(rows[..., None], plain, 0.0)
    n = int(rows.sum()) * cin
    dT_err, flips = rounding_flips(dT, plain)
    f_dfeats, f_da, f_dt = bwd_data_from_dT(dT, idx, a, t, feats,
                                            kernel_size)
    forced = {"dfeats": rounding_flips(got[0], f_dfeats)}
    for name, x, y in (("da", got[1], f_da), ("dt", got[2], f_dt)):
        scale = float(y.abs().max())
        forced[name] = float((x - y).abs().max()) / scale if scale else 0.0
    _, _, _, r_da, r_dt = cconv_klist_bwd_reference(
        dout, idx, a, t, f16, w16, kernel_size, precision="default")
    flipped = _one_step(dT, plain.to(torch.bfloat16)).any(dim=2)  # [Q, S]
    explained = (hz & flipped[:, None, :]).any(dim=2)             # [Q, K]
    beyond, unexplained = {}, {}
    for name, x, y in (("da", got[1], r_da), ("dt", got[2], r_dt)):
        far = ((x - y).abs() > tol * float(y.abs().max())).reshape(
            explained.shape + (-1,))
        beyond[name] = int(far.sum())
        unexplained[name] = int((far & ~explained[..., None]).sum())
    return {"dT_flips": flips, "dT_elements": n, "dT_err": dT_err,
            "dT_scale": float(plain.abs().max()), "forced": forced,
            "beyond": beyond, "unexplained": unexplained,
            "dfeats_scale": float(f_dfeats.abs().max())}


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
    data.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 9 \
        + [ctypes.c_void_p]
    data_work = lib.cconv_klist_bwd_data_workspace
    data_work.restype = ctypes.c_longlong
    data_work.argtypes = [ctypes.c_int] * 9
    filt = lib.cconv_klist_bwd_filter_launch
    filt.restype = ctypes.c_int
    filt.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 \
        + [ctypes.c_void_p]
    work = lib.cconv_klist_bwd_filter_workspace
    work.restype = ctypes.c_longlong
    work.argtypes = [ctypes.c_int] * 8
    return data, filt, work, data_work


def data_workspace_bytes(q, k, n, cin, cout, kz, ky, kx, bf16):
    """Bytes of the data launch's workspace at this shape: dT [Q, S*Cin]
    (bf16 in the bf16 variant) and the feats rows' counters [N + 1]."""
    return _data_workspace(q, k, n, cin, cout, kz, ky, kx, int(bf16))


@functools.lru_cache(maxsize=1024)
def _data_workspace(*shape):
    nbytes = int(_bwd_launchers()[3](*shape))
    if nbytes < 0:
        raise ValueError(f"the data kernels do not take the shape {shape}")
    return nbytes


def transposed_slots(idx, a, n):
    """The data kernel's transposed neighbour list, plain PyTorch: the
    slots that add to dfeats, grouped by the feats row they read.  A slot
    (flat id q*K + k) is listed under its clamped row ``clamp(idx, 0, n -
    1)`` (a negative index under row 0, one past the end under row n - 1,
    the rows the forward reads) when ``a != 0``; the slots with ``a == 0``
    (the padded ones, idx 0) add nothing and are left out.  Returns (order
    [Q*K] int32: the listed slot ids by row, ascending within a row, then
    the ones left out, ascending; offsets [n + 1] int32: row r's slots are
    ``order[offsets[r]:offsets[r + 1]]``).  A stable sort of the clamped
    rows, the slots left out keyed n; the card's data launch builds the
    same list of the listed slots itself (``_bwd_data_launch``)."""
    key = idx.clamp(0, n - 1).masked_fill_(a == 0, n).reshape(-1)
    rows, order = torch.sort(key, stable=True)
    offsets = torch.searchsorted(
        rows, torch.arange(n + 1, dtype=rows.dtype, device=rows.device),
        out_int32=True)
    return order.to(torch.int32), offsets


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


def _bwd_data_launch(dout, idx, a, t, feats, w, kernel_size, qfeats,
                     work=None):
    """One data launch on CUDA tensors of the variant's dtypes: (dfeats
    fp32, dqfeats or None, da, dt, order, offsets), the last two the
    transposed list the launch built: ``transposed_slots``'s, but for
    ``order`` past ``offsets[-1]`` (the slots left out), undefined.  A
    ``work`` of ``data_workspace_bytes`` uint8 given, it holds dT [Q,
    S*Cin] (fp32, or bf16) in its first bytes afterwards."""
    shape = _shapes(idx, a, t, feats, w, kernel_size, qfeats, dout)
    q, k, n, cin = shape[:4]
    dev = feats.device
    if work is None:
        work = torch.empty(data_workspace_bytes(*shape), dtype=torch.uint8,
                           device=dev)
    order = torch.empty(q * k, dtype=torch.int32, device=dev)
    offsets = torch.empty(n + 1, dtype=torch.int32, device=dev)
    dfeats = torch.empty((n, cin), dtype=torch.float32, device=dev)
    dqfeats = None if qfeats is None else torch.empty_like(qfeats)
    da = torch.empty_like(a)
    dt = torch.empty_like(t)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _raise_on(_bwd_launchers()[0](
        idx.data_ptr(), a.data_ptr(), t.data_ptr(), feats.data_ptr(),
        _ptr(qfeats), w.data_ptr(), dout.data_ptr(), order.data_ptr(),
        offsets.data_ptr(), work.data_ptr(), dfeats.data_ptr(),
        _ptr(dqfeats), da.data_ptr(), dt.data_ptr(), *shape, stream),
        "cconv_klist_bwd_data")
    _count(cconv_klist_bwd_data, shape[-1])
    cconv_klist_bwd_data.workspace_peak = max(
        cconv_klist_bwd_data.workspace_peak, work.numel())
    return dfeats, dqfeats, da, dt, order, offsets


def cconv_klist_bwd_data(dout, idx, a, t, feats, w, kernel_size,
                         qfeats=None, precision="highest"):
    """Gradients of the K-list conv in its data inputs: (dfeats, dqfeats or
    None, da, dt).  CUDA tensors launch the data kernels of
    ``csrc/cconv_klist_bwd.cu``: dT on the tensor cores into a workspace
    allocated here, the transposed list (``transposed_slots``, built on
    the card), the slot walk for da, dt and dqfeats, dfeats summed a row at
    a time through the list in ascending slot id.  Deterministic: two
    launches give the same bits; in the bf16 variant dfeats is then
    rounded to a bf16 tensor.  One call counts as one launch, however many
    kernels it runs.  CPU tensors take ``cconv_klist_bwd_reference``."""
    if not feats.is_cuda:
        dfeats, dqfeats, _, da, dt = cconv_klist_bwd_reference(
            dout, idx, a, t, feats, w, kernel_size, qfeats, precision)
        return dfeats, dqfeats, da, dt
    feats, w = _variant(feats, w, precision)
    dfeats, dqfeats, da, dt, _, _ = _bwd_data_launch(
        dout, idx, a, t, feats, w, kernel_size, qfeats)
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
# the largest dT workspace a data launch allocated, bytes (set it to 0 to
# measure a span)
cconv_klist_bwd_data.workspace_peak = 0
cconv_klist_bwd_filter.launches = cconv_klist_bwd_filter.launches_bf16 = 0
