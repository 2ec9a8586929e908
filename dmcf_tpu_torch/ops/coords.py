"""Filter-coordinate computation for continuous convolutions (port of
dmcf_tpu/ops/coords.py).

The filter array layout is [z][y][x][Cin][Cout]; relative offsets arrive in
x/y/z order in the unit ball and are mapped to *centered* filter
coordinates (tap i sits at ``i - (size-1)/2``), which keeps the mirror
``t(-rel) == -t(rel)`` bitwise exact — the ASCC momentum guarantee rests
on it.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-12


def map_ball_to_cube_radial(x, y, z):
    """Radial stretch: scale by |p|_2 / |p|_inf (unit ball -> unit cube)."""
    sq_norm = x * x + y * y + z * z
    zero = sq_norm < _EPS
    norm = torch.sqrt(torch.where(zero, 1.0, sq_norm))
    linf = torch.maximum(torch.maximum(x.abs(), y.abs()), z.abs())
    s = torch.where(zero, 0.0, norm / torch.where(
        zero, 1.0, torch.clamp(linf, min=_EPS)))
    return x * s, y * s, z * s


def map_sphere_to_cylinder(x, y, z):
    """Volume-preserving unit-ball -> unit-cylinder map (axis = z)."""
    sq_norm = x * x + y * y + z * z
    rho_sq = x * x + y * y
    zero = sq_norm < _EPS
    rho_zero = rho_sq < _EPS
    cone = (5.0 / 4.0) * z * z > rho_sq

    norm = torch.sqrt(torch.where(zero, 1.0, sq_norm))

    s_cone = torch.sqrt(3.0 * norm
                        / torch.where(zero, 1.0, norm + z.abs()))
    x_cone = x * s_cone
    y_cone = y * s_cone
    z_cone = torch.sign(z) * norm

    rho = torch.sqrt(torch.where(rho_zero, 1.0, rho_sq))
    s_side = norm / torch.where(rho_zero, 1.0, rho)
    x_side = x * s_side
    y_side = y * s_side
    z_side = z * (3.0 / 2.0)

    xo = torch.where(zero, 0.0, torch.where(cone, x_cone, x_side))
    yo = torch.where(zero, 0.0, torch.where(cone, y_cone, y_side))
    zo = torch.where(zero, 0.0, torch.where(cone, z_cone, z_side))
    return xo, yo, zo


def map_cylinder_to_cube(x, y, z):
    """Area-preserving disc -> square map applied per z-slice."""
    sq_norm = x * x + y * y
    zero = sq_norm < _EPS
    norm = torch.sqrt(torch.where(zero, 1.0, sq_norm))
    x_dom = x * x >= y * y

    four_over_pi = 4.0 / math.pi
    xd_x = torch.sign(x) * norm
    xd_y = torch.sign(x) * four_over_pi * norm * torch.atan(
        y / torch.where(x.abs() < _EPS, 1.0, x))
    yd_y = torch.sign(y) * norm
    yd_x = torch.sign(y) * four_over_pi * norm * torch.atan(
        x / torch.where(y.abs() < _EPS, 1.0, y))

    xo = torch.where(zero, 0.0, torch.where(x_dom, xd_x, yd_x))
    yo = torch.where(zero, 0.0, torch.where(x_dom, xd_y, yd_y))
    return xo, yo, z


def apply_coordinate_mapping(x, y, z, mapping):
    if mapping == "ball_to_cube_radial":
        return map_ball_to_cube_radial(x, y, z)
    if mapping == "ball_to_cube_volume_preserving":
        x, y, z = map_sphere_to_cylinder(x, y, z)
        return map_cylinder_to_cube(x, y, z)
    if mapping == "identity":
        return x, y, z
    raise NotImplementedError(f"unknown coordinate_mapping: {mapping}")


def compute_centered_filter_coordinates(rel, filter_size, mapping,
                                        align_corners):
    """Unit-ball offsets ``rel`` [..., 3] (x/y/z) -> centered continuous
    filter coordinates (tz, ty, tx), each [...].  ``t = u * scale`` with no
    additive shift, so the mirror holds bitwise."""
    sz, sy, sx = filter_size
    x, y, z = apply_coordinate_mapping(rel[..., 0], rel[..., 1],
                                       rel[..., 2], mapping)

    def to_centered(u, size):
        scale = 0.5 * (size - 1) if align_corners else 0.5 * size
        return u * scale

    return to_centered(z, sz), to_centered(y, sy), to_centered(x, sx)


def axis_interp_weights(t, size, interpolation):
    """Per-axis interpolation weights [..., size] over the taps.

    'linear' is the hat form ``relu(1 - |clamp(t) - p_i|)`` on centered
    coordinates — bitwise mirror-exact, unlike floor/frac trilinear
    weights.  A filter axis of size 1 gives weight 1 at tap 0.
    """
    half = 0.5 * (size - 1)
    taps = torch.arange(size, dtype=t.dtype, device=t.device) - half
    if interpolation == "nearest_neighbor":
        idx = torch.clamp(torch.round(t + half), 0, size - 1)
        return (torch.arange(size, dtype=t.dtype, device=t.device)
                == idx[..., None]).to(t.dtype)
    if interpolation == "linear":
        t = torch.clamp(t, -half, half)
        return torch.relu(1.0 - (t[..., None] - taps).abs())
    if interpolation == "linear_border":
        return torch.relu(1.0 - (t[..., None] - taps).abs())
    raise NotImplementedError(f"unknown interpolation: {interpolation}")
