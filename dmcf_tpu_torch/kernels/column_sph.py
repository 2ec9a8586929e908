"""Wrapper of the hand-written CUDA SPH1D column solver
(``csrc/column_sph.cu``) and its plain PyTorch version.

Counterpart of ``dmcf_tpu/data/generators.py:_column_solve_jax``, the
JAX package's compiled SPH1D time integration (XLA, pinned to the CPU
there; no TPU kernel).  Contract (both versions):

  x0, v0  [S, P] fp32 initial positions and velocities of S scenes, each
          scene's ``counts[s]`` particles first (the first ``bcnt`` of
          them boundary), the rest padding; P <= 64
  counts  [S] int32 particles a scene, bcnt < counts[s] <= P
  returns xs, vs [S, T, P] fp32 (frame t holds the state before step t,
          padding 0), iters [S, T] int32, the projection iterations each
          frame ran, and pairs [S, T, 4] int32, the particle pairs (i, j
          both of the scene, i = j included) at distance q <= 0.5 (the
          spline's inner arm) and at 0.5 < q <= 1 (its outer arm) in the
          frame's viscosity step, then the same two counts summed over its
          projection iterations; pairs beyond q = 1 add nothing to any sum
          (the counts let a bound count only the work the data needs)

Each step applies viscosity and gravity, predicts, then runs the
pressure projection: its first iteration always runs, and a scene stops
at ``err < eps`` (``err`` the largest fluid over-density of that
iteration) or at ``max_iter``, on its own.  The elementwise arithmetic is
JAX's, operation by operation in fp32 (no fused multiply-add).  Every
pair sum over a scene's particles is taken over 64 zero-padded slots in
one fixed tree order (``tree_sum``: slot j pairs with j + 32, then
j + 16, ...), in both versions.  The kernel gives each particle row a
warp: lane l adds the leaves of slots l and l + 32, and xor shuffles over
16, 8, 4, 2 and 1 finish the sum, which is that order with some additions
commuted (bitwise the same; ``csrc/column_sph.cu`` has the design).  So
the kernel and the plain version give the same bits and two launches are
bitwise equal; JAX's ``jnp.sum``
sums in XLA's order, so the port drifts from JAX by rounding over the
iterations (``tests/test_torch_column.py`` and ``PERF.md`` state how
far).

A CPU tensor goes to ``column_solve_reference``; a CUDA tensor launches
the kernel (one launch solves every scene for every frame) or raises.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .build import load_library

SLOTS = 64  # pair sums run over this many zero-padded slots


@functools.cache
def constants(mass, gravity, rest_dens, stiffness, visc, h, dt, eps):
    """The solver's scalars as the fp32 values JAX computes with: Python
    floats rounded once to fp32, the compound ones (4/(3h), 0.01 h^2,
    dt^2) formed in double first, as Python does before JAX sees them."""
    f = np.float32
    return dict(mass=f(mass), gravity=f(gravity), rest=f(rest_dens),
                stiff=f(stiffness), visc=f(visc), cw=f(4 / (3 * h)),
                soft=f(0.01 * h ** 2), dt=f(dt), dt2=f(dt ** 2),
                eps=f(eps))


def tree_sum(x):
    """Sum over the last axis (64 slots) in the kernel's order: slot j
    with j + 32, then j + 16, ..., then the last pair."""
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = x[..., :half] + x[..., half:]
    return x[..., 0]


def _w(q, c):
    """Cubic spline on raw distances q >= 0 (JAX's ``kernel``)."""
    q2 = q * q
    inner = 6.0 * (q * q2 - q2) + 1.0
    u = 1.0 - q
    outer = 2.0 * (u * (u * u))
    return c["cw"] * torch.where(q <= 1.0, torch.where(q <= 0.5, inner,
                                                       outer), 0.0)


def _dw(q, c):
    """Its derivative on signed distances (JAX's ``kernel_grad``)."""
    a = q.abs()
    sg = torch.sign(q)
    inner = (18.0 * sg) * (q * q) - 12.0 * q
    u = 1.0 - a
    outer = (-6.0 * sg) * (u * u)
    return c["cw"] * torch.where(a <= 1.0, torch.where(a <= 0.5, inner,
                                                       outer), 0.0)


def column_solve_reference(x0, v0, counts, *, bcnt, timesteps, mass=1.0,
                           gravity=-1000.0, rest_dens=2.0, stiffness=20.0,
                           visc=0.1, h=1.0, dt=0.01, eps=0.01,
                           max_iter=10000):
    """Plain PyTorch version of the kernel (module docstring), batched over
    the scenes: one projection loop in which each scene has its own done
    flag."""
    dev = x0.device
    n_s, p = x0.shape
    if p > SLOTS:
        raise ValueError(f"the column solver takes at most {SLOTS} "
                         f"particles a scene, got {p}")
    c = {k: torch.tensor(v, dtype=torch.float32, device=dev)
         for k, v in constants(mass, gravity, rest_dens, stiffness, visc, h,
                               dt, eps).items()}
    pad = SLOTS - p
    x = torch.nn.functional.pad(x0.float(), (0, pad))
    v = torch.nn.functional.pad(v0.float(), (0, pad))
    slot = torch.arange(SLOTS, device=dev)
    valid = slot[None, :] < counts.to(dev)[:, None]               # [S, P]
    fluid = valid & (slot[None, :] >= bcnt)
    pair = valid[:, None, :]                      # slot j of row i counts
    zero = torch.zeros((), dtype=torch.float32, device=dev)

    both = valid[:, :, None] & pair

    def dens_of(x):
        """The densities and the pairs in each spline arm [S, 2]."""
        d = (x[:, :, None] - x[:, None, :]).abs()
        dens = tree_sum(torch.where(pair, c["mass"] * _w(d, c), zero))
        arms = torch.stack([(both & (d <= 0.5)).sum((1, 2)),
                            (both & (d > 0.5) & (d <= 1.0)).sum((1, 2))], 1)
        return torch.where(valid, dens, 1.0), arms.to(torch.int32)

    xs = torch.zeros((n_s, timesteps, p), dtype=torch.float32, device=dev)
    vs = torch.zeros_like(xs)
    iters = torch.zeros((n_s, timesteps), dtype=torch.int32, device=dev)
    pairs = torch.zeros((n_s, timesteps, 4), dtype=torch.int32, device=dev)
    for t in range(timesteps):
        xs[:, t], vs[:, t] = x[:, :p], v[:, :p]
        # viscosity and gravity, then the prediction
        dens, pairs[:, t, :2] = dens_of(x)
        ds = x[:, :, None] - x[:, None, :]
        md = c["mass"] / dens
        lap = ((md[:, None, :] * (v[:, :, None] - v[:, None, :])) * ds
               * _dw(ds, c)) / (ds * ds + c["soft"])
        lap = 2.0 * tree_sum(torch.where(pair, lap, zero))
        v = torch.where(fluid, v + c["dt"] * (c["gravity"]
                                              + c["visc"] * lap), v)
        x = torch.where(fluid, x + c["dt"] * v, x)
        # the pressure projection
        it = torch.zeros(n_s, dtype=torch.int32, device=dev)
        active = torch.full((n_s,), max_iter > 0, device=dev)
        while bool(active.any()):
            dens, arms = dens_of(x)
            pairs[:, t, 2:] += torch.where(active[:, None], arms, 0)
            r = dens / c["rest"]
            r2 = r * r
            pres = torch.clamp(c["stiff"] * ((r * r2) * (r2 * r2) - 1.0),
                               min=0.0)
            pres = torch.where(slot[None, :] < bcnt, pres[:, bcnt:bcnt + 1],
                               pres)
            err = torch.where(fluid, torch.clamp(dens - c["rest"], min=0.0),
                              zero).amax(dim=1)
            pd = pres / (dens * dens)
            ds = x[:, :, None] - x[:, None, :]
            contrib = (c["mass"] * (pd[:, :, None] + pd[:, None, :])) \
                * _dw(ds, c)
            grad = dens * tree_sum(torch.where(pair, contrib, zero))
            f_pres = -(c["mass"] / dens) * grad
            move = fluid & active[:, None]
            v = torch.where(move, v + (c["dt"] * f_pres) / c["mass"], v)
            x = torch.where(move, x + (c["dt2"] * f_pres) / c["mass"], x)
            it = it + active.to(torch.int32)
            active = active & (it < max_iter) & (err >= c["eps"])
        iters[:, t] = it
    return xs, vs, iters, pairs


def _check(name, x, dtype, shape, device):
    if x.device != device or x.dtype != dtype or tuple(x.shape) != shape \
            or not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous {dtype} tensor of "
                         f"shape {shape} on {device}, got {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")


@functools.cache
def _launcher():
    """``column_sph_launch`` of the built library, its ctypes signature
    set once."""
    fn = load_library("column_sph").column_sph_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 \
        + [ctypes.c_float] * 10 + [ctypes.c_void_p]
    return fn


def column_solve(x0, v0, counts, *, bcnt, timesteps, mass=1.0,
                 gravity=-1000.0, rest_dens=2.0, stiffness=20.0, visc=0.1,
                 h=1.0, dt=0.01, eps=0.01, max_iter=10000):
    """The column solver (module docstring): CUDA tensors launch
    ``csrc/column_sph.cu``, CPU tensors take the plain version."""
    kw = dict(bcnt=bcnt, timesteps=timesteps, mass=mass, gravity=gravity,
              rest_dens=rest_dens, stiffness=stiffness, visc=visc, h=h,
              dt=dt, eps=eps, max_iter=max_iter)
    if not x0.is_cuda:
        return column_solve_reference(x0, v0, counts, **kw)
    n_s, p = x0.shape
    dev = x0.device
    _check("x0", x0, torch.float32, (n_s, p), dev)
    _check("v0", v0, torch.float32, (n_s, p), dev)
    _check("counts", counts, torch.int32, (n_s,), dev)
    if not (1 <= p <= SLOTS and 0 <= bcnt and timesteps >= 1
            and max_iter >= 0):
        raise ValueError(f"column_sph takes 1 <= P <= {SLOTS} particles a "
                         f"scene, bcnt >= 0, timesteps >= 1 (got P={p}, "
                         f"bcnt={bcnt}, timesteps={timesteps})")
    xs = torch.empty((n_s, timesteps, p), dtype=torch.float32, device=dev)
    vs = torch.empty_like(xs)
    iters = torch.empty((n_s, timesteps), dtype=torch.int32, device=dev)
    pairs = torch.empty((n_s, timesteps, 4), dtype=torch.int32, device=dev)
    c = constants(mass, gravity, rest_dens, stiffness, visc, h, dt, eps)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _launcher()(
        x0.data_ptr(), v0.data_ptr(), counts.data_ptr(), xs.data_ptr(),
        vs.data_ptr(), iters.data_ptr(), pairs.data_ptr(), n_s, p,
        timesteps, bcnt, max_iter,
        *(float(c[k]) for k in ("mass", "gravity", "rest", "stiff", "visc",
                                "cw", "soft", "dt", "dt2", "eps")),
        stream)
    if err != 0:
        raise RuntimeError(f"column_sph kernel launch failed: CUDA error "
                           f"{err}")
    column_solve.launches += 1
    return xs, vs, iters, pairs


# launches of the CUDA kernel (plain-version calls are not counted)
column_solve.launches = 0
