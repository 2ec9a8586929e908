"""Continuous convolution (port of dmcf_tpu/ops/cconv.py).

For each output point i

    y_i = 1/psi_i * sum_{j in N(i)} a_ij * f_j * g(Lambda((x_j - x_i)/r))

with ``g`` the filter array interpolated at mapped coordinates and ``a_ij``
an optional radial window.  ``continuous_conv`` (K-list neighbors) computes
the per-slot geometry here in plain PyTorch — window weights and centred
filter coordinates after the ball->cube mapping — and hands the contraction
to ``kernels.cconv_klist``: for CUDA tensors an autograd Function over the
hand-written CUDA kernels (forward, and the backward kernels for the
gradients of features, filter, window weights and filter coordinates), for
CPU tensors the plain twin, which autograd differentiates.  Autograd
carries the gradients of ``a`` and ``t`` back through the plain geometry
into the positions.  ``continuous_conv_reference`` runs the
same geometry into the plain twin on any device.  ``continuous_conv_dense``
(every source point a candidate) is plain PyTorch in this slice.

``precision`` is the JAX package's: "highest" computes fp32 throughout
(the default here, as in JAX's ``continuous_conv``); None or "default"
is JAX's bf16 contraction (``kernels/cconv_klist.py`` states it), for the
dense conv too, whose tap-field and filter products stay plain matrix
products of bf16-rounded operands with fp32 sums and outputs.
"""

from __future__ import annotations

import torch

from ..kernels.cconv_klist import (cconv_klist, cconv_klist_reference,
                                   is_bf16, round_bf16)
from .coords import axis_interp_weights, compute_centered_filter_coordinates
from .neighbors import NeighborList


def build_symmetric_kernel(half_kernel, sym_axis):
    """Full antisymmetric kernel ``concat([-flip(K, all spatial axes), K],
    axis=sym_axis)``; satisfies ``G(-x) = -G(x)`` under the mirror."""
    flipped = torch.flip(half_kernel, dims=(0, 1, 2))
    return torch.cat([-flipped, half_kernel], dim=sym_axis)


def _radius_terms(extents, like):
    """(1/radius, radius^2) in the working dtype, as the reference forms
    them (radius = extents / 2)."""
    ext = torch.as_tensor(extents, dtype=like.dtype, device=like.device)
    if ext.ndim != 0:
        raise NotImplementedError("per-query extents are not ported yet")
    radius = 0.5 * ext
    return 1.0 / radius, radius * radius


def klist_geometry(neighbors: NeighborList, extents, filter_size, *,
                   out_positions=None, inp_positions=None,
                   window_fn=None,
                   coordinate_mapping="ball_to_cube_volume_preserving",
                   align_corners=True, bf16_window=False):
    """Per-slot inputs of the K-list contraction: (idx, a, t).

    idx [Q, K] int32 as the list holds them (the contraction clamps
    out-of-range entries); a [Q, K] = mask * window(d^2/r^2), the window
    rounded to bf16 first with ``bf16_window``; t [Q, K, 3] centred filter
    coordinates (tz, ty, tx).
    """
    idx, mask = neighbors.idx, neighbors.mask
    rel_scale, r_sq = _radius_terms(extents, neighbors.dist)
    if neighbors.disp is not None:
        rel = neighbors.disp * rel_scale
    else:
        nbr_pos = inp_positions[idx.long()]
        rel = (nbr_pos - out_positions[:, None, :]) * rel_scale
    tz, ty, tx = compute_centered_filter_coordinates(
        rel, filter_size, coordinate_mapping, align_corners)
    t = torch.stack([tz, ty, tx], dim=-1)
    a = mask.to(neighbors.dist.dtype)
    if window_fn is not None:
        win = window_fn(neighbors.dist / r_sq)
        a = a * (round_bf16(win) if bf16_window else win)
    return idx.to(torch.int32).contiguous(), a.contiguous(), t.contiguous()


def _continuous_conv(contract, kernel, out_positions, inp_positions,
                     inp_features, neighbors, extents, *, window_fn,
                     coordinate_mapping, interpolation, align_corners,
                     normalize, inp_importance, symmetric, query_features,
                     precision, cached_taps):
    if symmetric and is_bf16(precision):
        raise NotImplementedError(
            "a symmetric conv at bf16 precision is not ported (JAX's "
            "depends on the platform; the model's ASCC convs run "
            "'highest')")
    if interpolation != "linear":
        raise NotImplementedError(
            f"interpolation {interpolation!r} is not ported yet (the "
            "K-list kernel computes the clamped 'linear' hats)")
    if inp_importance is not None:
        raise NotImplementedError("inp_importance is not ported yet")
    kz, ky, kx, cin, cout = kernel.shape
    idx, a, t = klist_geometry(
        neighbors, extents, (kz, ky, kx), out_positions=out_positions,
        inp_positions=inp_positions, window_fn=window_fn,
        coordinate_mapping=coordinate_mapping, align_corners=align_corners,
        bf16_window=cached_taps and is_bf16(precision))
    qf = None
    if symmetric:
        if query_features is None:
            raise ValueError("symmetric conv requires query_features")
        qf = query_features.contiguous()
    out = contract(idx, a, t, inp_features.contiguous(),
                   kernel.reshape(kz * ky * kx * cin, cout).contiguous(),
                   (kz, ky, kx), qfeats=qf, precision=precision)
    if normalize:
        if window_fn is not None:
            denom = a.sum(dim=1)
        else:
            denom = neighbors.mask.sum(dim=1).to(out.dtype)
        out = torch.where(denom[:, None] > 1e-9, out / denom[:, None], 0.0)
    return out


def continuous_conv(kernel, out_positions, inp_positions, inp_features,
                    neighbors: NeighborList, extents, *, window_fn=None,
                    coordinate_mapping="ball_to_cube_volume_preserving",
                    interpolation="linear", align_corners=True,
                    normalize=False, inp_importance=None, symmetric=False,
                    query_features=None, precision="highest",
                    cached_taps=False):
    """K-list continuous conv at ``out_positions`` -> [Q, Cout].

    kernel [kz, ky, kx, Cin, Cout] (already expanded for symmetric
    variants); inp_features [N, Cin]; ``neighbors`` a padded NeighborList of
    input points per output point; ``extents`` the scalar filter diameter.
    ``symmetric`` adds the antisymmetric self term and needs
    ``query_features`` [Q, Cin] (fp32 only).  CUDA tensors run the
    hand-written kernels of the ``precision``'s variant, forward and
    backward.  ``cached_taps`` computes what JAX's conv computes over a
    tap tensor the model cached (``dmcf_tpu/models/pbf.py:pair_taps``,
    built in bf16 at the default precision: the window weights are
    rounded to bf16 before the tap product, :517-519 and
    ``ops/cconv.py:build_tap_tensor``); it changes nothing at "highest".
    """
    return _continuous_conv(
        cconv_klist, kernel, out_positions, inp_positions, inp_features,
        neighbors, extents, window_fn=window_fn,
        coordinate_mapping=coordinate_mapping, interpolation=interpolation,
        align_corners=align_corners, normalize=normalize,
        inp_importance=inp_importance, symmetric=symmetric,
        query_features=query_features, precision=precision,
        cached_taps=cached_taps)


def continuous_conv_reference(kernel, out_positions, inp_positions,
                              inp_features, neighbors: NeighborList,
                              extents, *, window_fn=None,
                              coordinate_mapping=
                              "ball_to_cube_volume_preserving",
                              interpolation="linear", align_corners=True,
                              normalize=False, inp_importance=None,
                              symmetric=False, query_features=None,
                              precision="highest", cached_taps=False):
    """Plain PyTorch twin of :func:`continuous_conv` on any device."""
    return _continuous_conv(
        cconv_klist_reference, kernel, out_positions, inp_positions,
        inp_features, neighbors, extents, window_fn=window_fn,
        coordinate_mapping=coordinate_mapping, interpolation=interpolation,
        align_corners=align_corners, normalize=normalize,
        inp_importance=inp_importance, symmetric=symmetric,
        query_features=query_features, precision=precision,
        cached_taps=cached_taps)


def _dense_T(rel, a, feats, filter_size, coordinate_mapping, interpolation,
             align_corners, bf16):
    """T[q, s, c] = sum_n (a[q, n] * w[q, n, s]) f[n, c] for one source
    slice, in fp32 (with ``bf16``, of the tap field and features rounded
    to bf16).  The tap field is built source-minor, [q, s, n], so the
    contraction is one [q*s, n] x [n, c] product with no transpose copy
    of the (largest) tap field."""
    q, n = a.shape
    fz, fy, fx = filter_size
    tz, ty, tx = compute_centered_filter_coordinates(
        rel, filter_size, coordinate_mapping, align_corners)
    wz = axis_interp_weights(tz, fz, interpolation).transpose(1, 2)
    wy = axis_interp_weights(ty, fy, interpolation).transpose(1, 2)
    wx = axis_interp_weights(tx, fx, interpolation).transpose(1, 2)
    wzy = (wz[:, :, None, :] * wy[:, None, :, :]).reshape(q, fz * fy, n)
    A = (wzy[:, :, None, :] * wx[:, None, :, :]).reshape(q, fz * fy * fx, n)
    A = A * a[:, None, :]
    if bf16:
        return round_bf16(A) @ round_bf16(feats)
    return A @ feats


def continuous_conv_dense(kernel, rel, a, inp_features, *,
                          coordinate_mapping="ball_to_cube_volume_preserving",
                          interpolation="linear", align_corners=True,
                          n_chunk: int = 0, precision="highest"):
    """Continuous conv evaluated densely over ALL source points.

    rel [Q, N, 3] displacement ``src - query`` already scaled by 1/radius;
    a [Q, N] validity * window weights (0 for out-of-radius or masked
    pairs); inp_features [N, Cin].  With ``0 < n_chunk < N`` the source
    dimension is summed in slices of that width, bounding the [Q, chunk, S]
    tap field; the result equals the unchunked one to summation order (at
    bf16, the chunks' fp32 sums are added and T is rounded once, as JAX's
    chunked scan does).
    """
    kz, ky, kx, cin, cout = kernel.shape
    q, n = a.shape
    fsz = (kz, ky, kx)
    bf16 = is_bf16(precision)
    if 0 < n_chunk < n:
        T = torch.zeros((q, kz * ky * kx, cin), dtype=inp_features.dtype,
                        device=inp_features.device)
        for start in range(0, n, n_chunk):
            sl = slice(start, start + n_chunk)
            T = T + _dense_T(rel[:, sl], a[:, sl], inp_features[sl], fsz,
                             coordinate_mapping, interpolation,
                             align_corners, bf16)
    else:
        T = _dense_T(rel, a, inp_features, fsz, coordinate_mapping,
                     interpolation, align_corners, bf16)
    w = kernel.reshape(-1, cout)
    if bf16:
        T, w = round_bf16(T), round_bf16(w)
    return T.reshape(q, kz * ky * kx * cin) @ w
