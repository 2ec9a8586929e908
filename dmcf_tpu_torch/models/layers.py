"""Layers around the conv ops (port of dmcf_tpu/models/layers.py).

Parameter names and shapes match the flax modules, so a flax param tree
loads by module path (``interop.params_from_flax``): a conv holds
``kernel`` [kz, ky, kx, Cin, Cout] (the half kernel along ``sym_axis`` when
symmetric) and ``bias`` [Cout]; a ``Dense`` holds ``Dense_0.kernel``
[in, out] and ``Dense_0.bias`` [out].
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
from torch import nn

from ..ops.cconv import (build_symmetric_kernel, continuous_conv,
                         continuous_conv_dense)
from ..ops.neighbors import DensePair, NeighborList


def _uniform(shape, scale, generator, device):
    u = torch.rand(shape, generator=generator, dtype=torch.float32)
    return (u * (2.0 * scale) - scale).to(device)


class ContinuousConv(nn.Module):
    """Continuous convolution layer (dense or symmetric/ASCC kernel).

    Dispatches on the neighbor structure: a ``NeighborList`` runs the
    K-list conv (the hand-written kernel on CUDA), a ``DensePair`` the
    dense plain-PyTorch conv.  ``precision`` is the ops' ("highest" fp32,
    None / "default" JAX's bf16 contraction, which has no symmetric form).
    Not ported in this slice (raise):
    ``circular`` kernels, ``k_chunk``, lazy dense pairs, ``inp_importance``.
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
        if circular:
            raise NotImplementedError("circular kernels are not ported yet")
        if k_chunk:
            raise NotImplementedError("k_chunk is not ported yet")
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
        self.precision = precision
        shape = list(self.kernel_size)
        if symmetric:
            if shape[sym_axis] % 2:
                raise ValueError(
                    "symmetric kernel size must be even along sym_axis")
            shape[sym_axis] //= 2
        self.kernel = nn.Parameter(_uniform(
            (*shape, in_channels, filters), 0.05, generator, device))
        self.bias = (nn.Parameter(torch.zeros(filters, device=device))
                     if use_bias else None)

    def full_kernel(self):
        if self.symmetric:
            return build_symmetric_kernel(self.kernel, self.sym_axis)
        return self.kernel

    def forward(self, inp_features, inp_positions, out_positions, extents,
                neighbors, query_features=None, n_chunk: int = 0,
                cached_taps: bool = False):
        """``cached_taps``: the K-list conv computes what the reference's
        conv over a model-cached tap tensor does (``ops.cconv``)."""
        kernel = self.full_kernel()
        if isinstance(neighbors, DensePair):
            if self.symmetric or self.normalize:
                raise ValueError(
                    "dense conv path covers plain trunk convs only")
            a = neighbors.valid.to(inp_features.dtype)
            if self.window_function is not None:
                a = a * torch.where(neighbors.valid,
                                    self.window_function(neighbors.qnorm),
                                    0.0)
            out = continuous_conv_dense(
                kernel, neighbors.rel, a, inp_features,
                coordinate_mapping=self.coordinate_mapping,
                interpolation=self.interpolation,
                align_corners=self.align_corners, n_chunk=n_chunk,
                precision=self.precision)
        elif isinstance(neighbors, NeighborList):
            if self.symmetric and query_features is None:
                query_features = inp_features
            out = continuous_conv(
                kernel, out_positions, inp_positions, inp_features,
                neighbors, extents, window_fn=self.window_function,
                coordinate_mapping=self.coordinate_mapping,
                interpolation=self.interpolation,
                align_corners=self.align_corners, normalize=self.normalize,
                symmetric=self.symmetric, query_features=query_features,
                precision=self.precision, cached_taps=cached_taps)
        else:
            raise NotImplementedError(
                f"neighbor structure {type(neighbors).__name__} is not "
                "ported yet")
        if self.bias is not None:
            out = out + self.bias
        return out


class _Linear(nn.Module):
    """flax ``nn.Dense`` parameters: ``kernel`` [in, out], ``bias``."""

    def __init__(self, in_features, units, use_bias, generator, device):
        super().__init__()
        limit = (6.0 / (in_features + units)) ** 0.5  # glorot uniform
        self.kernel = nn.Parameter(_uniform((in_features, units), limit,
                                            generator, device))
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

    def forward(self, x):
        return self.Dense_0(x)
