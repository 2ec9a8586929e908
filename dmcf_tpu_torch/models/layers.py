"""Layers around the conv ops (port of dmcf_tpu/models/layers.py).

Parameter names and shapes match the flax modules, so a flax param tree
loads by module path (``interop.params_from_flax``): a conv holds
``kernel`` [kz, ky, kx, Cin, Cout] (the half kernel along ``sym_axis`` when
symmetric, the radial stack [ceil(max(ks) / 2), Cin, Cout] when circular)
and ``bias`` [Cout], as do ``SparseConv`` and ``SparseConvTranspose``;
``PointSampling`` holds none; a ``Dense`` holds ``Dense_0.kernel``
[in, out] and ``Dense_0.bias`` [out].
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..ops.cconv import (build_circular_kernel, build_symmetric_kernel,
                         continuous_conv, continuous_conv_dense,
                         continuous_conv_dense_lazy, point_sampling)
from ..ops.neighbors import (DensePair, LazyDensePair, NeighborList,
                             all_rows, fixed_radius_search,
                             invert_neighbors_list, take_rows)


def _uniform(shape, scale, generator, device):
    u = torch.rand(shape, generator=generator, dtype=torch.float32)
    return (u * (2.0 * scale) - scale).to(device)


class ContinuousConv(nn.Module):
    """Continuous convolution layer (dense, symmetric/ASCC or circular
    kernel).  A circular kernel is a radial weight stack expanded to the
    cube at each call (``build_circular_kernel``; odd when ``symmetric``),
    and its conv adds no ASCC self term, as in the reference.

    Dispatches on the neighbor structure: a ``NeighborList`` runs the
    K-list conv (the hand-written kernel on CUDA), a ``DensePair`` the
    dense plain-PyTorch conv, a ``LazyDensePair`` the same a source chunk
    at a time (``n_chunk``, 512 where 0).  ``precision`` is the ops'
    ("highest" fp32, None / "default" JAX's bf16 contraction, which has no
    symmetric form).

    ``k_chunk`` > 0 splits a K-list conv whose K exceeds it into chunks of
    ``k_chunk`` slots, as the reference does where the conv builds its
    taps inline (no cached taps) and ``normalize`` is off
    (``dmcf_tpu/models/layers.py:178-214``): each chunk is a conv of its
    own (on CUDA one kernel launch, and one backward, a chunk; on the CPU
    the plain version's [Q, K, S] tap transient is bounded by the chunk)
    and the chunk outputs are summed in fp32 in chunk order.  At the
    default precision each chunk rounds its T to bf16 on its own, so the
    chunked conv is not bit for bit the unchunked one, in either package.
    ``inp_importance`` [N] scales each source's slots (the K-list conv's
    per-slot weight; on a DensePair the pair field's); the lazy dense path
    raises for it, as the reference asserts.

    A neighbor structure with ``rows`` (the sharded step's, see
    ``parallel/spatial.py``) holds one rank's block of the query rows: the
    conv computes those rows alone, the query-side inputs (output
    positions, query features, per-query extents) cut to them, and
    returns every row, gathered from the ranks.
    """

    def __init__(self, in_channels: int, filters: int,
                 kernel_size: Sequence[int], *, use_bias: bool = True,
                 align_corners: bool = True,
                 coordinate_mapping: str = "ball_to_cube_volume_preserving",
                 interpolation: str = "linear", normalize: bool = False,
                 window_function: Optional[Callable] = None,
                 symmetric: bool = False, sym_axis: int = 2,
                 circular: bool = False, k_chunk: int = 0,
                 precision: Optional[str] = "highest",
                 generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        self.k_chunk = int(k_chunk)
        self.filters = filters
        self.kernel_size = tuple(int(k) for k in kernel_size)
        self.use_bias = use_bias
        self.align_corners = align_corners
        self.coordinate_mapping = coordinate_mapping
        self.interpolation = interpolation
        self.normalize = normalize
        self.window_function = window_function
        self.symmetric = symmetric
        self.sym_axis = sym_axis
        self.circular = circular
        self.precision = precision
        shape = list(self.kernel_size)
        if circular:
            shape = [-(-max(shape) // 2)]
        elif symmetric:
            if shape[sym_axis] % 2:
                raise ValueError(
                    "symmetric kernel size must be even along sym_axis")
            shape[sym_axis] //= 2
        self.kernel = nn.Parameter(_uniform(
            (*shape, in_channels, filters), 0.05, generator, device))
        self.bias = (nn.Parameter(torch.zeros(filters, device=device))
                     if use_bias else None)

    def resize_input(self, in_channels, generator):
        """Re-draw the kernel for ``in_channels`` inputs, in place: the
        same Parameter, so an optimizer made before still holds it."""
        shape = (*self.kernel.shape[:-2], in_channels, self.filters)
        self.kernel.data = _uniform(shape, 0.05, generator,
                                    self.kernel.device)

    @property
    def symmetric_conv(self):
        """Whether the conv adds the ASCC self term (not with a circular
        kernel, whose odd field is in the kernel itself)."""
        return self.symmetric and not self.circular

    def full_kernel(self):
        if self.circular:
            return build_circular_kernel(self.kernel, self.kernel_size,
                                         symmetric=self.symmetric)
        if self.symmetric:
            return build_symmetric_kernel(self.kernel, self.sym_axis)
        return self.kernel

    def forward(self, inp_features, inp_positions, out_positions, extents,
                neighbors, query_features=None, n_chunk: int = 0,
                cached_taps: bool = False, inp_importance=None):
        """``cached_taps``: the K-list conv computes what the reference's
        conv over a model-cached tap tensor does (``ops.cconv``)."""
        kernel = self.full_kernel()
        rows = getattr(neighbors, "rows", None)
        if rows is not None:
            out_positions = rows.take(out_positions)
            if self.symmetric_conv and query_features is None:
                query_features = inp_features
            query_features = take_rows(rows, query_features)
            if torch.is_tensor(extents) and extents.ndim == 1:
                extents = rows.take(extents)
        if isinstance(neighbors, (DensePair, LazyDensePair)) and (
                self.symmetric_conv or self.normalize):
            raise ValueError("dense conv path covers plain trunk convs only")
        if isinstance(neighbors, LazyDensePair) and \
                inp_importance is not None:
            raise ValueError("lazy dense path folds importance into "
                             "features")
        if isinstance(neighbors, LazyDensePair):
            lp = neighbors
            out = continuous_conv_dense_lazy(
                kernel, lp.src_pos, lp.src_mask, lp.dst_pos, lp.dst_mask,
                lp.radius, inp_features, window_fn=self.window_function,
                coordinate_mapping=self.coordinate_mapping,
                interpolation=self.interpolation,
                align_corners=self.align_corners, n_chunk=n_chunk,
                precision=self.precision)
        elif isinstance(neighbors, DensePair):
            a = neighbors.valid.to(inp_features.dtype)
            if self.window_function is not None:
                a = a * torch.where(neighbors.valid,
                                    self.window_function(neighbors.qnorm),
                                    0.0)
            if inp_importance is not None:
                a = a * inp_importance[None, :].to(a.dtype)
            out = continuous_conv_dense(
                kernel, neighbors.rel, a, inp_features,
                coordinate_mapping=self.coordinate_mapping,
                interpolation=self.interpolation,
                align_corners=self.align_corners, n_chunk=n_chunk,
                precision=self.precision)
        elif isinstance(neighbors, NeighborList):
            if self.symmetric_conv and query_features is None:
                query_features = inp_features
            k = neighbors.idx.shape[1]
            kc = self.k_chunk
            chunked = not cached_taps and 0 < kc < k and not self.normalize
            out = None
            for start in range(0, k, kc if chunked else k):
                nl = neighbors if not chunked else _k_slice(
                    neighbors, start, start + kc)
                y = continuous_conv(
                    kernel, out_positions, inp_positions, inp_features,
                    nl, extents, window_fn=self.window_function,
                    coordinate_mapping=self.coordinate_mapping,
                    interpolation=self.interpolation,
                    align_corners=self.align_corners,
                    normalize=self.normalize, symmetric=self.symmetric_conv,
                    inp_importance=inp_importance,
                    query_features=query_features,
                    precision=self.precision, cached_taps=cached_taps)
                out = y if out is None else out + y
        else:
            raise NotImplementedError(
                f"neighbor structure {type(neighbors).__name__} is not "
                "ported yet")
        if self.bias is not None:
            out = out + self.bias
        return all_rows(rows, out)


class _SparseBase(nn.Module):
    """The voxel-grid convs' parameters and filter-coordinate offset: a
    kernel [*kernel_size, Cin, Cout] drawn as ``ContinuousConv``'s, a zero
    bias; ``offset`` (x/y/z, in voxels) defaults to -1/2 on an even kernel,
    0 on an odd one."""

    def __init__(self, in_channels: int, filters: int,
                 kernel_size: Sequence[int], *,
                 activation: Optional[Callable] = None,
                 use_bias: bool = True, normalize: bool = False,
                 offset: Optional[Sequence[float]] = None,
                 neighbor_k: int = 32,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.kernel_size = tuple(int(k) for k in kernel_size)
        self.activation = activation
        self.normalize = normalize
        self.offset = offset
        self.neighbor_k = int(neighbor_k)
        self.kernel = nn.Parameter(_uniform(
            (*self.kernel_size, in_channels, filters), 0.05, generator,
            device))
        self.bias = (nn.Parameter(torch.zeros(filters, device=device))
                     if use_bias else None)

    def _shift(self, voxel_size, like):
        """offset * voxel_size, formed in float32 as the reference's
        numpy product."""
        if self.offset is not None:
            off = np.asarray(self.offset, np.float32)
        else:
            off = np.full(3, -0.5 if self.kernel_size[0] % 2 == 0 else 0.0,
                          np.float32)
        return torch.as_tensor(np.asarray(off * voxel_size, np.float32),
                               device=like.device)

    def _conv(self, out_positions, inp_positions, inp_features, nl,
              voxel_size, importance):
        out = continuous_conv(
            self.kernel, out_positions, inp_positions, inp_features, nl,
            voxel_size * self.kernel_size[-1],
            coordinate_mapping="identity",
            interpolation="nearest_neighbor", align_corners=False,
            normalize=self.normalize, inp_importance=importance)
        if self.bias is not None:
            out = out + self.bias
        return self.activation(out) if self.activation is not None else out


class SparseConv(_SparseBase):
    """Voxel-grid sparse convolution (the reference's SparseConv): points
    on a regular grid, an Linf search of radius ``kernel_size * voxel_size
    * 0.51`` about the output points shifted by the offset, the identity
    coordinate mapping, nearest-neighbour taps, ``align_corners=False``;
    on CUDA the K-list kernels' nearest_neighbor mode."""

    def forward(self, inp_features, inp_positions, out_positions,
                voxel_size, inp_mask=None, out_mask=None,
                inp_importance=None):
        q_pos = out_positions - self._shift(voxel_size, out_positions)
        radius = self.kernel_size[-1] * voxel_size * 0.51
        nl = fixed_radius_search(inp_positions, q_pos, radius,
                                 self.neighbor_k, points_mask=inp_mask,
                                 queries_mask=out_mask, metric="Linf")
        return self._conv(q_pos, inp_positions, inp_features, nl,
                          voxel_size, inp_importance)


class SparseConvTranspose(_SparseBase):
    """Transposed voxel-grid sparse convolution (the reference's): the
    shifted input points search the output points (Linf), and the list is
    inverted (``invert_neighbors_list``) into the output points' lists of
    input points; then the conv as ``SparseConv``'s."""

    def forward(self, inp_features, inp_positions, out_positions,
                voxel_size, inp_mask=None, out_mask=None,
                out_importance=None):
        i_pos = inp_positions - self._shift(voxel_size, inp_positions)
        radius = self.kernel_size[-1] * voxel_size * 0.51
        nl_inp = fixed_radius_search(out_positions, i_pos, radius,
                                     self.neighbor_k, points_mask=out_mask,
                                     queries_mask=inp_mask, metric="Linf")
        nl = invert_neighbors_list(nl_inp, out_positions.shape[0],
                                   self.neighbor_k)
        return self._conv(out_positions, i_pos, inp_features, nl,
                          voxel_size, out_importance)


class PointSampling(nn.Module):
    """Windowed scatter or average between point sets (the reference's
    PointSampling, a layer with no parameters): an L2 search of radius
    ``extents / 2``, then ``ops.cconv.point_sampling``."""

    def __init__(self, window_function: Optional[Callable] = None,
                 normalize: bool = True, neighbor_k: int = 32):
        super().__init__()
        self.window_function = window_function
        self.normalize = normalize
        self.neighbor_k = int(neighbor_k)

    def forward(self, inp_features, inp_positions, out_positions, extents,
                inp_mask=None, out_mask=None):
        nl = fixed_radius_search(inp_positions, out_positions,
                                 float(extents) / 2.0, self.neighbor_k,
                                 points_mask=inp_mask,
                                 queries_mask=out_mask)
        return point_sampling(inp_features, nl, extents,
                              window_fn=self.window_function,
                              normalize=self.normalize)


def _k_slice(nl: NeighborList, start, stop) -> NeighborList:
    """Slots [start, stop) of a neighbor list (a ``k_chunk`` chunk)."""
    return NeighborList(
        idx=nl.idx[:, start:stop], mask=nl.mask[:, start:stop],
        dist=nl.dist[:, start:stop], count=nl.count,
        cell_overflow=nl.cell_overflow,
        disp=None if nl.disp is None else nl.disp[:, start:stop],
        rows=nl.rows)


def _glorot(in_features, units, generator, device):
    limit = (6.0 / (in_features + units)) ** 0.5  # glorot uniform
    return _uniform((in_features, units), limit, generator, device)


class _Linear(nn.Module):
    """flax ``nn.Dense`` parameters: ``kernel`` [in, out], ``bias``."""

    def __init__(self, in_features, units, use_bias, generator, device):
        super().__init__()
        self.kernel = nn.Parameter(_glorot(in_features, units, generator,
                                           device))
        self.bias = (nn.Parameter(torch.zeros(units, device=device))
                     if use_bias else None)

    def forward(self, x):
        y = x @ self.kernel
        return y + self.bias if self.bias is not None else y


class Dense(nn.Module):
    """Per-point dense layer (glorot uniform kernel, zero bias)."""

    def __init__(self, in_features: int, units: int, use_bias: bool = True,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.Dense_0 = _Linear(in_features, units, use_bias, generator,
                               device)

    def resize_input(self, in_features, generator):
        """Re-draw the kernel for ``in_features`` inputs, in place (as
        ``ContinuousConv.resize_input``)."""
        kernel = self.Dense_0.kernel
        kernel.data = _glorot(in_features, kernel.shape[1], generator,
                              kernel.device)

    def forward(self, x):
        return self.Dense_0(x)
