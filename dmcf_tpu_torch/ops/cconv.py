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
(every source point a candidate) and ``continuous_conv_dense_lazy`` (the
same with the pair field rebuilt a source chunk at a time) are plain
PyTorch.

``precision`` is the JAX package's: "highest" computes fp32 throughout
(the default here, as in JAX's ``continuous_conv``; so does every other
name JAX takes but "default"); None or "default" is JAX's bf16
contraction (``kernels/cconv_klist.py`` states it), for the dense conv
too, whose tap-field and filter products stay plain matrix products of
bf16-rounded operands with fp32 sums and outputs.  ``interpolation``
("linear", "linear_border", "nearest_neighbor") reaches the kernels as
their mode.  ``extents`` is the scalar filter diameter or one a query
([Q]); ``inp_importance`` [N] scales each slot's weight by its source's.
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


def build_circular_kernel(radial_kernel, kernel_size, symmetric=False):
    """Expand a radial weight stack [R, Cin, Cout] to the cube kernel
    [kz, ky, kx, Cin, Cout]: each cell takes the radial weight indexed by
    the largest |centred coordinate| of the cell (a gather, so autograd
    carries the cube's gradient back to the stack).  With ``symmetric``
    the kernel is multiplied by the normalised signed coordinate (x, y, z
    on Cout's three channels): an odd vector field."""
    ks = tuple(int(s) for s in kernel_size)
    dev = radial_kernel.device
    zr, yr, xr = torch.meshgrid(torch.arange(ks[0], device=dev),
                                torch.arange(ks[1], device=dev),
                                torch.arange(ks[2], device=dev),
                                indexing="ij")
    grid = torch.stack([xr, yr, zr], dim=-1).to(torch.float32)
    ks_rev = torch.tensor([ks[2], ks[1], ks[0]], dtype=torch.float32,
                          device=dev)
    grid = grid - ks_rev / 2.0 + 0.5
    idx = torch.floor(grid.abs()).amax(dim=-1).long()
    kernel = radial_kernel[idx]
    if symmetric:
        kernel = kernel * (grid * 2.0 / ks_rev)[..., None, :]
    return kernel


def point_sampling(inp_features, neighbors: NeighborList, extents, *,
                   window_fn=None, normalize=True):
    """Windowed average (or sum) of the neighbours' features: the
    reference's PointSampling, an identity-kernel continuous conv.
    ``extents`` is the filter diameter, scalar or [Q].  A row with no
    weight is 0,
    as in the reference, whose division by that zero weight inside the
    ``where`` makes the gradient NaN (0 times an infinite or NaN partial)
    for every input that reaches it: the port divides by 1 there, so its
    values are the reference's and its gradients finite (ROADMAP §3)."""
    a = neighbors.mask.to(inp_features.dtype)
    if window_fn is not None:
        _, r_sq = _radius_terms(extents, a)
        a = a * window_fn(neighbors.dist / r_sq).to(a.dtype)
    f = inp_features[neighbors.idx.long()]
    out = torch.einsum("qk,qkc->qc", a, f)
    if normalize:
        denom = a.sum(dim=1)[:, None]
        has = denom > 1e-9
        out = torch.where(has, out / torch.where(has, denom, 1.0), 0.0)
    return out


def reduce_neighbor_count(neighbors: NeighborList, num_out=None):
    """Each output's valid neighbour count as float32, the first
    ``num_out`` outputs where given (the reference's
    ``reduce_subarrays_sum`` over ones)."""
    cnt = neighbors.mask.sum(dim=1).to(torch.float32)
    return cnt if num_out is None else cnt[:num_out]


def _radius_terms(extents, like):
    """(1/radius, radius^2) in the working dtype, as the reference forms
    them (radius = extents / 2); for per-query extents [Q], shaped [Q, 1,
    1] and [Q, 1] to scale the slots' offsets and distances."""
    ext = torch.as_tensor(extents, dtype=like.dtype, device=like.device)
    radius = 0.5 * ext
    if ext.ndim == 0:
        return 1.0 / radius, radius * radius
    return (1.0 / radius)[:, None, None], (radius * radius)[:, None]


def klist_geometry(neighbors: NeighborList, extents, filter_size, *,
                   out_positions=None, inp_positions=None,
                   window_fn=None,
                   coordinate_mapping="ball_to_cube_volume_preserving",
                   align_corners=True, offset=None, inp_importance=None,
                   bf16_window=False):
    """Per-slot inputs of the K-list contraction: (idx, a, t).

    idx [Q, K] int32 as the list holds them (the contraction clamps
    out-of-range entries); a [Q, K] = mask * window(d^2/r^2) *
    inp_importance[idx], the window rounded to bf16 first with
    ``bf16_window``; t [Q, K, 3] centred filter coordinates (tz, ty, tx),
    shifted by ``offset`` (x/y/z).
    """
    idx, mask = neighbors.idx, neighbors.mask
    rel_scale, r_sq = _radius_terms(extents, neighbors.dist)
    if neighbors.disp is not None:
        rel = neighbors.disp * rel_scale
    else:
        # clamped, as JAX's gather is (the obs_conv offset, ROADMAP §3)
        nbr_pos = inp_positions[idx.long().clamp(0, inp_positions.shape[0]
                                                 - 1)]
        rel = (nbr_pos - out_positions[:, None, :]) * rel_scale
    tz, ty, tx = compute_centered_filter_coordinates(
        rel, filter_size, coordinate_mapping, align_corners, offset)
    t = torch.stack([tz, ty, tx], dim=-1)
    a = mask.to(neighbors.dist.dtype)
    if window_fn is not None:
        win = window_fn(neighbors.dist / r_sq)
        a = a * (round_bf16(win) if bf16_window else win)
    if inp_importance is not None:
        # clamped, as JAX's gather is
        a = a * inp_importance[idx.long().clamp(
            0, inp_importance.shape[0] - 1)].to(a.dtype)
    return idx.to(torch.int32).contiguous(), a.contiguous(), t.contiguous()


def _continuous_conv(contract, kernel, out_positions, inp_positions,
                     inp_features, neighbors, extents, *, window_fn,
                     coordinate_mapping, interpolation, align_corners,
                     normalize, offset, inp_importance, symmetric,
                     query_features, precision, cached_taps):
    if symmetric and is_bf16(precision):
        raise NotImplementedError(
            "a symmetric conv at bf16 precision is not ported (JAX's "
            "depends on the platform; the model's ASCC convs run "
            "'highest')")
    kz, ky, kx, cin, cout = kernel.shape
    idx, a, t = klist_geometry(
        neighbors, extents, (kz, ky, kx), out_positions=out_positions,
        inp_positions=inp_positions, window_fn=window_fn,
        coordinate_mapping=coordinate_mapping, align_corners=align_corners,
        offset=offset, inp_importance=inp_importance,
        bf16_window=cached_taps and is_bf16(precision))
    qf = None
    if symmetric:
        if query_features is None:
            raise ValueError("symmetric conv requires query_features")
        qf = query_features.contiguous()
    out = contract(idx, a, t, inp_features.contiguous(),
                   kernel.reshape(kz * ky * kx * cin, cout).contiguous(),
                   (kz, ky, kx), qfeats=qf, precision=precision,
                   interpolation=interpolation)
    if normalize:
        if window_fn is not None or inp_importance is not None:
            denom = a.sum(dim=1)
        else:
            denom = neighbors.mask.sum(dim=1).to(out.dtype)
        out = torch.where(denom[:, None] > 1e-9, out / denom[:, None], 0.0)
    return out


def continuous_conv(kernel, out_positions, inp_positions, inp_features,
                    neighbors: NeighborList, extents, *, window_fn=None,
                    coordinate_mapping="ball_to_cube_volume_preserving",
                    interpolation="linear", align_corners=True,
                    normalize=False, offset=None, inp_importance=None,
                    symmetric=False, query_features=None,
                    precision="highest", cached_taps=False):
    """K-list continuous conv at ``out_positions`` -> [Q, Cout].

    kernel [kz, ky, kx, Cin, Cout] (already expanded for symmetric
    variants); inp_features [N, Cin]; ``neighbors`` a padded NeighborList of
    input points per output point; ``extents`` the filter diameter, scalar
    or [Q]; ``offset`` [3] (x/y/z) shifts the filter coordinates;
    ``inp_importance`` [N] scales each slot by its source's importance
    (``normalize`` then divides by the weights' sum, as with a window).
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
        align_corners=align_corners, normalize=normalize, offset=offset,
        inp_importance=inp_importance, symmetric=symmetric,
        query_features=query_features, precision=precision,
        cached_taps=cached_taps)


def continuous_conv_reference(kernel, out_positions, inp_positions,
                              inp_features, neighbors: NeighborList,
                              extents, *, window_fn=None,
                              coordinate_mapping=
                              "ball_to_cube_volume_preserving",
                              interpolation="linear", align_corners=True,
                              normalize=False, offset=None,
                              inp_importance=None, symmetric=False,
                              query_features=None, precision="highest",
                              cached_taps=False):
    """Plain PyTorch twin of :func:`continuous_conv` on any device."""
    return _continuous_conv(
        cconv_klist_reference, kernel, out_positions, inp_positions,
        inp_features, neighbors, extents, window_fn=window_fn,
        coordinate_mapping=coordinate_mapping, interpolation=interpolation,
        align_corners=align_corners, normalize=normalize, offset=offset,
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


def dense_geometry(points, pmask, queries, qmask, radius):
    """A dense pair's field (rel [Q, N, 3] scaled by 1/radius, qnorm
    [Q, N], valid [Q, N]); the eager and the lazy dense paths both build it
    here, so they agree bit for bit.  Invalid pairs are pinned to harmless
    geometry just outside the ball (padded rows sit at 1e8 sentinels);
    masks, not distances, keep them out."""
    r = torch.tensor(float(radius), dtype=points.dtype,
                     device=points.device)
    rel = points[None, :, :] - queries[:, None, :]
    d2 = (rel * rel).sum(dim=-1)
    r2 = r * r
    valid = (d2 <= r2) & pmask[None, :].bool() & qmask[:, None].bool()
    rel = torch.where(valid[..., None], rel * (1.0 / r), 1.0)
    qnorm = torch.where(valid, d2 * (1.0 / r2), 2.0)
    return rel, qnorm, valid


def _dense_conv(kernel, n, n_chunk, chunk_T, bf16):
    """T summed over source slices of ``n_chunk`` (one slice unless
    0 < n_chunk < n), ``chunk_T(slice)`` giving each slice's [Q, S, Cin]
    part, then the filter product (T and W rounded to bf16 with
    ``bf16``)."""
    kz, ky, kx, cin, cout = kernel.shape
    if 0 < n_chunk < n:
        T = None
        for start in range(0, n, n_chunk):
            part = chunk_T(slice(start, start + n_chunk))
            # a sum from zeros, as JAX's chunked scan carries it
            T = torch.zeros_like(part) + part if T is None else T + part
    else:
        T = chunk_T(slice(0, n))
    w = kernel.reshape(-1, cout)
    if bf16:
        T, w = round_bf16(T), round_bf16(w)
    return T.reshape(T.shape[0], kz * ky * kx * cin) @ w


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
    fsz = tuple(kernel.shape[:3])
    bf16 = is_bf16(precision)
    return _dense_conv(
        kernel, a.shape[1], n_chunk,
        lambda sl: _dense_T(rel[:, sl], a[:, sl], inp_features[sl], fsz,
                            coordinate_mapping, interpolation,
                            align_corners, bf16), bf16)


def continuous_conv_dense_lazy(kernel, src_pos, src_mask, dst_pos, dst_mask,
                               radius, inp_features, *, window_fn=None,
                               coordinate_mapping=
                               "ball_to_cube_volume_preserving",
                               interpolation="linear", align_corners=True,
                               n_chunk: int = 512, precision="highest"):
    """:func:`continuous_conv_dense` with the pair field rebuilt for each
    ``n_chunk``-wide slice of the sources (512 where ``n_chunk`` <= 0), so
    no [Q, N] array is kept: the reference's lazy dense conv.  Each slice's
    field comes from ``dense_geometry`` as the eager DensePair's does, and
    the slices are summed as the eager conv sums its chunks: equal bit for
    bit to the eager conv at the same ``n_chunk``."""
    fsz = tuple(kernel.shape[:3])
    bf16 = is_bf16(precision)

    def chunk_T(sl):
        rel, qnorm, valid = dense_geometry(src_pos[sl], src_mask[sl],
                                           dst_pos, dst_mask, radius)
        a = valid.to(inp_features.dtype)
        if window_fn is not None:
            a = a * torch.where(valid, window_fn(qnorm), 0.0)
        return _dense_T(rel, a, inp_features[sl], fsz, coordinate_mapping,
                        interpolation, align_corners, bf16)

    return _dense_conv(kernel, src_pos.shape[0],
                       n_chunk if n_chunk > 0 else 512, chunk_T, bf16)
