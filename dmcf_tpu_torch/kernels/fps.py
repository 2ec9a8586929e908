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
raises.  ``schedule`` chooses how the kernel lays a set out (its regime,
warps and rows a thread) from the set's size; the launcher passes it in.
"""

from __future__ import annotations

import ctypes
import functools
import math
import re
from typing import NamedTuple

import torch

from .build import CSRC, load_library


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


def _items_table():
    """``csrc/fps.cu``'s ``FPS_ITEMS_TABLE``: {rows a thread its register
    kernels are built for: the most threads a block of them may have}."""
    text = (CSRC / "fps.cu").read_text()
    body = re.search(r"#define FPS_ITEMS_TABLE\(X\)((?:.*\\\n)*.*)", text)
    return {int(i): int(c)
            for i, c in re.findall(r"X\((\d+),\s*(\d+)\)", body.group(1))}


_CAPS = _items_table()
ITEMS = tuple(sorted(_CAPS))     # rows a thread may hold in registers
# the registers' capacity (8,192 rows): larger sets keep their minima in a
# workspace
REGISTER_ROWS = max(i * c for i, c in _CAPS.items())
# From scripts/torch_fps_sweep.py on an H100: one warp beats every block up
# to 384 rows (12 a lane) and loses from 512; a block of 16 warps is the
# fastest width, or within 2 % of it, from 512 to 8,192 rows but at 768
# (8 warps 12 % faster).
WARP_ROWS = 384          # sets of at most this many rows take one warp
BLOCK_WARPS = 16         # larger sets a block of this many warps


class Schedule(NamedTuple):
    """How ``csrc/fps.cu`` lays a set out: ``regime`` "warp" (one warp a
    set, ``warps`` 1), "block" (a block of ``warps`` warps a set) or
    "workspace" (the same, the minima in device memory);
    ``items`` rows a thread holds in registers (0 for "workspace")."""
    regime: str
    warps: int
    items: int


def threads_cap(items):
    """Threads a block of ``items`` rows a thread may have (the kernel's
    launch bounds)."""
    return _CAPS[items]


def fit_items(rows):
    """The fewest rows a thread of ``ITEMS`` that hold ``rows``."""
    return next(i for i in ITEMS if i >= rows)


def schedule(n):
    """The kernel's schedule for sets of ``n`` rows (constants above)."""
    if n <= WARP_ROWS:
        return Schedule("warp", 1, fit_items(math.ceil(n / 32)))
    if n <= REGISTER_ROWS:
        return Schedule("block", BLOCK_WARPS,
                        fit_items(math.ceil(n / (32 * BLOCK_WARPS))))
    return Schedule("workspace", 32, 0)


_REGIMES = {"warp": 0, "block": 1, "workspace": 2}


@functools.cache
def _library():
    """The built library, its ctypes signatures set once."""
    lib = load_library("fps")
    lib.fps_launch.restype = ctypes.c_int
    lib.fps_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p] * 4
    return lib


def farthest_point_sample(pos, mask, sample_max, count):
    """Farthest-point sampling (module docstring): CUDA tensors launch
    ``csrc/fps.cu`` with ``schedule``'s layout, CPU tensors take the plain
    version."""
    if not pos.is_cuda:
        return farthest_point_sample_reference(pos, mask, sample_max, count)
    return _launch(pos, mask, sample_max, count)


def _launch(pos, mask, sample_max, count, sched=None):
    """One launch of ``csrc/fps.cu`` on CUDA tensors, with ``sched``'s
    layout (a sweep's or a test's candidate) or ``schedule``'s."""
    single, pos, mask, count = _batched(pos, mask, count)
    b, n, three = pos.shape
    if pos.dtype != torch.float32 or three != 3 or n < 1 \
            or sample_max < 1 or tuple(mask.shape) != (b, n):
        raise ValueError(f"fps takes fp32 positions [B, N, 3] with N >= 1, "
                         f"a mask [B, N] and sample_max >= 1 (got "
                         f"{pos.dtype} {tuple(pos.shape)}, mask "
                         f"{tuple(mask.shape)}, sample_max {sample_max})")
    sched = sched or schedule(n)
    pos = pos.contiguous()
    mask = mask.contiguous()
    count = count.contiguous()
    lib = _library()
    idx = torch.empty((b, sample_max), dtype=torch.int32, device=pos.device)
    sel = torch.empty((b, sample_max), dtype=torch.bool, device=pos.device)
    work = torch.empty((b, n), dtype=torch.float32, device=pos.device) \
        if sched.regime == "workspace" else None
    stream = torch.cuda.current_stream(pos.device).cuda_stream
    err = lib.fps_launch(pos.data_ptr(), mask.data_ptr(), count.data_ptr(),
                         b, n, sample_max, _REGIMES[sched.regime],
                         sched.warps, sched.items, idx.data_ptr(),
                         sel.data_ptr(),
                         None if work is None else work.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"fps kernel launch failed ({sched}): CUDA "
                           f"error {err}")
    farthest_point_sample.launches += 1
    return (idx[0], sel[0]) if single else (idx, sel)


# launches of the CUDA kernel (plain-version calls are not counted)
farthest_point_sample.launches = 0
