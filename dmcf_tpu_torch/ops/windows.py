"""Radial window (SPH smoothing) functions (port of dmcf_tpu/ops/windows.py).

All windows take the *normalized squared distance* q = d^2 / r^2.
"""

from __future__ import annotations

import torch


def _safe_sqrt(q):
    """sqrt with a 1e-12 floor (finite gradient at coincident pairs)."""
    return torch.sqrt(torch.clamp(q, min=1e-12))


def poly6(q, fac=1.0):
    return fac * torch.clamp((1.0 - q) ** 3, 0.0, 1.0)


def cubic(q, fac=1.0):
    q_sqrt = _safe_sqrt(q)
    inner = torch.where(q_sqrt <= 0.5, 6.0 * (q_sqrt**3 - q) + 1.0,
                        2.0 * (1.0 - q_sqrt) ** 3)
    return fac * (4.0 / 3.0) * torch.where(q <= 1.0, inner,
                                           torch.zeros_like(q))


def linear(q, fac=1.0):
    return fac * (1.0 - _safe_sqrt(q))


def peak(q, fac=1.0):
    q_sqrt = _safe_sqrt(q)
    return fac * (1.0 - 2.0 * q_sqrt + q)


def cubic_grad(q, fac=1.0):
    q_sqrt = _safe_sqrt(q)
    inner = torch.where(q_sqrt <= 0.5, 18.0 * q - 12.0 * q_sqrt,
                        -6.0 * (1.0 - q_sqrt) ** 2)
    return fac * (4.0 / 3.0) * torch.where(q <= 1.0, inner,
                                           torch.zeros_like(q))


_WINDOWS = {
    "poly6": poly6,
    "cubic": cubic,
    "linear": linear,
    "peak": peak,
    "cubic_grad": cubic_grad,
}


def get_window_func(typ, fac=1.0):
    """Window factory; None for ``typ is None`` ("no window")."""
    if typ is None:
        return None
    if callable(typ):
        return typ
    if typ not in _WINDOWS:
        raise NotImplementedError(f"unknown window function: {typ}")
    fn = _WINDOWS[typ]

    def func(q):
        return fn(q, fac=fac)

    return func
