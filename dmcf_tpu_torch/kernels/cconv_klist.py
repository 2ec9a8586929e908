"""Wrapper of the hand-written CUDA K-list continuous-conv kernel
(``csrc/cconv_klist.cu``) and its plain PyTorch twin.

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
  returns out [Q, Cout] fp32

The kernel takes S <= 1024, S*Cin <= 8192, 1 <= Cout <= 256 and K, N >= 1.
A CPU tensor goes to ``cconv_klist_reference``; a CUDA tensor launches the
kernel or raises — there is no fallback.
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


def cconv_klist_reference(idx, a, t, feats, w, kernel_size, qfeats=None):
    """Plain PyTorch twin of the kernel (same contract)."""
    q, k = idx.shape
    cin = feats.shape[1]
    s_total = kernel_size[0] * kernel_size[1] * kernel_size[2]
    A = _tap_tensor(t, a, kernel_size)
    # JAX clamps out-of-range gathers and the reference's obs_conv relies on
    # it (ROADMAP §3): clamp so the twin reads the same rows
    f = feats[idx.long().clamp(0, feats.shape[0] - 1)]
    T = torch.einsum("qks,qkc->qsc", A, f)
    if qfeats is not None:
        T = T + A.sum(dim=1)[:, :, None] * qfeats[:, None, :]
    return T.reshape(q, s_total * cin) @ w


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


@functools.cache
def _launcher():
    """``cconv_klist_launch`` of the built library, its ctypes signature
    set once."""
    fn = load_library("cconv_klist").cconv_klist_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 \
        + [ctypes.c_void_p]
    return fn


def _launch(idx, a, t, feats, w, kernel_size, qfeats):
    q, k = idx.shape
    n, cin = feats.shape
    kz, ky, kx = (int(s) for s in kernel_size)
    s_total = kz * ky * kx
    cout = w.shape[1]
    dev = feats.device
    _check("idx", idx, torch.int32, (q, k), dev)
    _check("a", a, torch.float32, (q, k), dev)
    _check("t", t, torch.float32, (q, k, 3), dev)
    _check("feats", feats, torch.float32, (n, cin), dev)
    _check("w", w, torch.float32, (s_total * cin, cout), dev)
    if qfeats is not None:
        _check("qfeats", qfeats, torch.float32, (q, cin), dev)
    if not (1 <= cout <= 256 and s_total <= 1024
            and s_total * cin <= 8192 and k >= 1 and n >= 1):
        raise ValueError(
            f"cconv_klist kernel takes S <= 1024, S*Cin <= 8192, "
            f"1 <= Cout <= 256 and K, N >= 1 (got S={s_total}, Cin={cin}, "
            f"Cout={cout}, K={k}, N={n})")
    out = torch.empty((q, cout), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _launcher()(idx.data_ptr(), a.data_ptr(), t.data_ptr(),
                      feats.data_ptr(),
                      None if qfeats is None else qfeats.data_ptr(),
                      w.data_ptr(), out.data_ptr(), q, k, n, cin, cout, kz,
                      ky, kx, stream)
    if err != 0:
        raise RuntimeError(f"cconv_klist kernel launch failed: CUDA error "
                           f"{err}")
    cconv_klist.launches += 1
    return out


def cconv_klist(idx, a, t, feats, w, kernel_size, qfeats=None):
    """K-list continuous conv (see module docstring).  CUDA tensors launch
    the hand-written kernel; CPU tensors take the plain twin."""
    if not feats.is_cuda:
        return cconv_klist_reference(idx, a, t, feats, w, kernel_size, qfeats)
    return _launch(idx, a, t, feats, w, kernel_size, qfeats)


# launches of the CUDA kernel (plain-twin calls are not counted)
cconv_klist.launches = 0
