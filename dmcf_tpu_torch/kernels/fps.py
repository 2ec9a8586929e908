"""Wrapper of the hand-written CUDA farthest-point-sampling kernel
(``csrc/fps.cu``) and its plain PyTorch version.

Counterpart of ``dmcf_tpu/ops/sph.py:farthest_point_sample`` (an XLA
``fori_loop``; the JAX package has no TPU kernel for it).  Contract (both
versions):

  pos     [N, 3] or [B, N, 3] fp32 point sets (masked rows anywhere)
  mask    [N] or [B, N] bool
  count   the samples wanted a set (an int, or an int32 tensor, 0-dim or
          [B], on the device: it is never read on the host)
  returns idx [S] or [B, S] int32, S = ``sample_max``: idx[0] the lowest
          valid row (argmax of the mask), then each pick the row whose
          smallest squared distance to the picks so far is largest (the
          lowest row among equal ones; masked rows hold -inf and are
          picked only when no valid row is left), for all S picks; and
          sel [S] or [B, S] bool, ``arange(S) < count``

The squared distance is ``fma(dz, dz, fma(dy, dy, dx * dx))`` with
``dx = p - cur``: what XLA's CPU compiler makes of JAX's
``sum((pos - cur) ** 2, -1)`` (it contracts the sum into fused
multiply-adds; a plain ``(dx*dx + dy*dy) + dz*dz`` differs from it in the
last bit for ~20 % of the pairs of a 3D lattice, and every later pick
moves).  So the plain version picks JAX's rows bit for bit, on lattices
with exact ties too (``tests/test_torch_fps.py``), and the kernel picks
the plain version's (the file note of ``csrc/fps.cu``).

A CPU tensor goes to ``farthest_point_sample_reference``; a CUDA tensor
launches the kernel (one launch samples every set of the batch) or
raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .build import load_library


def _batched(pos, mask, count):
    single = pos.dim() == 2
    if single:
        pos, mask = pos[None], mask[None]
    b = pos.shape[0]
    count = torch.as_tensor(count, dtype=torch.int32, device=pos.device)
    count = count.reshape(-1).expand(b) if count.numel() == 1 \
        else count.reshape(b)
    return single, pos, mask.bool(), count


def fma(a, b, c):
    """``a * b + c`` rounded once to fp32, as a fused multiply-add does.
    The product of two fp32 values is exact in fp64; the sum is split
    into its fp64 rounding ``s`` and the exact error ``e`` (Knuth's
    TwoSum), and where ``s`` falls exactly halfway between two fp32 values
    the error decides the side (rounding s alone would round twice)."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)
    f = s.float()
    other = torch.nextafter(f, torch.where(f.double() > s, -torch.inf,
                                           torch.inf).float())
    tie = (f.double() + other.double() == 2.0 * s) & (e != 0)
    toward = torch.where(e > 0, torch.maximum(f, other),
                         torch.minimum(f, other))
    return torch.where(tie, toward, f)


def farthest_point_sample_reference(pos, mask, sample_max, count):
    """Plain PyTorch version of the kernel (module docstring), batched
    over the sets."""
    single, pos, mask, count = _batched(pos, mask, count)
    b = pos.shape[0]
    inf = torch.tensor(float("inf"), dtype=pos.dtype, device=pos.device)
    min_d = torch.where(mask, inf, -inf)
    idx = torch.zeros((b, sample_max), dtype=torch.int32, device=pos.device)
    rows = torch.arange(b, device=pos.device)
    last = mask.to(torch.uint8).argmax(dim=1)
    idx[:, 0] = last
    for i in range(1, sample_max):
        d3 = pos - pos[rows, last][:, None, :]
        dx, dy, dz = d3.unbind(-1)
        d = fma(dz, dz, fma(dy, dy, dx * dx))
        min_d = torch.minimum(min_d, torch.where(mask, d, -inf))
        last = min_d.argmax(dim=1)
        idx[:, i] = last
    sel = torch.arange(sample_max, device=pos.device)[None, :] \
        < count[:, None]
    return (idx[0], sel[0]) if single else (idx, sel)


@functools.cache
def _library():
    """The built library, its ctypes signatures set once."""
    lib = load_library("fps")
    lib.fps_launch.restype = ctypes.c_int
    lib.fps_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p] * 4
    lib.fps_work_floats.restype = ctypes.c_int
    lib.fps_work_floats.argtypes = [ctypes.c_int]
    return lib


def farthest_point_sample(pos, mask, sample_max, count):
    """Farthest-point sampling (module docstring): CUDA tensors launch
    ``csrc/fps.cu``, CPU tensors take the plain version."""
    if not pos.is_cuda:
        return farthest_point_sample_reference(pos, mask, sample_max, count)
    single, pos, mask, count = _batched(pos, mask, count)
    b, n, three = pos.shape
    if pos.dtype != torch.float32 or three != 3 or n < 1 \
            or sample_max < 1 or tuple(mask.shape) != (b, n):
        raise ValueError(f"fps takes fp32 positions [B, N, 3] with N >= 1, "
                         f"a mask [B, N] and sample_max >= 1 (got "
                         f"{pos.dtype} {tuple(pos.shape)}, mask "
                         f"{tuple(mask.shape)}, sample_max {sample_max})")
    pos = pos.contiguous()
    mask = mask.contiguous()
    count = count.contiguous()
    lib = _library()
    idx = torch.empty((b, sample_max), dtype=torch.int32, device=pos.device)
    sel = torch.empty((b, sample_max), dtype=torch.bool, device=pos.device)
    floats = lib.fps_work_floats(n)
    work = torch.empty((b, floats), dtype=torch.float32, device=pos.device) \
        if floats else None
    stream = torch.cuda.current_stream(pos.device).cuda_stream
    err = lib.fps_launch(pos.data_ptr(), mask.data_ptr(), count.data_ptr(),
                         b, n, sample_max, idx.data_ptr(), sel.data_ptr(),
                         None if work is None else work.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"fps kernel launch failed: CUDA error {err}")
    farthest_point_sample.launches += 1
    return (idx[0], sel[0]) if single else (idx, sel)


# launches of the CUDA kernel (plain-version calls are not counted)
farthest_point_sample.launches = 0
