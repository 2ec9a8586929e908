"""PBF physics scaffold shared by the learned-SPH models (port of
dmcf_tpu/models/pbf.py: the rollout and training paths).

A sample is padded fluid/boundary tensors with validity masks; padded
particles sit at far sentinel positions and every op is mask-exact.  One
neighbor search per (point-set pair, radius) per step is shared by every
conv through ``SearchCache``; the scale-0 all->all search also serves the
fluid->all and box->all convs by subsetting.  Large scenes: ``search_method``
picks the search ('auto': the cell search past N*Q = 3e7, its window budget
from ``cell_occ_cap``), ``boundary_crop_max`` compacts the boundary in
contact with the fluid into that many slots before any search, and HRNet's
dense pairs past ``dense_lazy_min_elems`` rebuild their geometry a source
chunk at a time (``LazyDensePair``).

Every model option of the reference is here: density and pressure
features (``dens_feats``, ``pres_feats``, ``dens_radius``, ``stiffness``),
the density-normalised trunk (``dens_norm``), per-particle input
features (``use_feats``; their width sized at the first forward or
state-dict load, where flax sizes it at init), the pre-advection branch
(``use_pre_adv``), the
equivariant output (``equivar``), circular kernels, the farthest-point
pyramid (``voxel_size: None``, the hand-written CUDA kernel on the card),
a first stride other than 1 and ``transpose_search_reuse``.  Left out on
purpose: the reference's batched pair prefetch and tap-tensor caching
are TPU launch-count devices that give bitwise-identical lists (the
K-list kernel builds its taps inline; the reference's cached bf16 taps
equal the inline ones rounded once).  Config keys the port has no use
for (the reference's TPU tuning knobs) are dropped with a warning by
``build_model``.  ``window_dens`` and ``rest_dens`` are kept on the
module, as in the reference, because the valid suite's max-density
metric reads ``window_dens`` from the model.

``precision`` is the reference's trunk knob (``pbf.py:300-304``): its
default "default" (or None) runs every conv that ``make_cconv`` builds —
the scale-0 convs and the trunk — in JAX's bf16 contraction, "highest" in
fp32; the ASCC convs pin "highest" (``symnet.py``).  The ``Dense`` layers
and all geometry stay fp32, and the weights are fp32 at either precision.
The reference's K-list convs run over cached tap tensors wherever the
pair's Q*K*S is at most 32M (``pbf.py:498-519``), and
bf16-built taps round the window weights to bf16 before the tap product;
the port's convs do the same there (``caches_taps``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from .. import resolve_device
from ..ops.cconv import dense_geometry, point_sampling
from ..ops.neighbors import (DensePair, LazyDensePair, NeighborList,
                             all_rows, gather_list, invert_neighbors_list,
                             search, select_k_valid, slice_list, take_rows)
from ..ops.sph import (align_vector, compute_pressure,
                       compute_transformed_dx, get_dilated_pos,
                       masked_positions)
from ..ops.windows import get_window_func
from ..kernels.cconv_klist import is_bf16
from .layers import ContinuousConv, Dense


def subset_neighbors(nl: NeighborList, keep) -> NeighborList:
    """Restrict a padded neighbor list to neighbors with ``keep(idx,
    dist)`` (carves fluid->all and box->all lists out of one search)."""
    mask = nl.mask & keep(nl.idx, nl.dist)
    return NeighborList(
        idx=torch.where(mask, nl.idx, 0), mask=mask,
        dist=torch.where(mask, nl.dist, 0.0),
        count=mask.sum(dim=1, dtype=torch.int32),
        disp=None if nl.disp is None else
        torch.where(mask[..., None], nl.disp, 0.0), rows=nl.rows)


def drop_coincident(nl: NeighborList, points=None,
                    queries=None) -> NeighborList:
    """The ``ignore_query_point`` variant of a neighbor list: drops slots
    whose neighbour sits exactly on the query (zero displacement, or, where
    the search kept no ``disp``, equal ``points[idx]`` and ``queries``)."""
    if nl.disp is not None:
        same = nl.mask & (nl.disp == 0.0).all(dim=-1)
    else:
        same = (points[nl.idx.long()]
                == take_rows(nl.rows, queries)[:, None, :]).all(dim=-1)
    return subset_neighbors(nl, lambda idx, dist: ~same)


class SearchCache:
    """One fixed-radius search per (src, dst, radius) per step, and one
    dense pair field per (src, dst, radius), shared by every conv.  With
    ``transpose_reuse`` a pair whose transpose was searched already is
    that list inverted (``invert_neighbors_list``), exact wherever the
    transpose kept every neighbour.

    ``split`` (the sharded step's ``parallel.spatial.RowSplit``; None in
    one process): every structure holds this rank's block of its query
    rows (``rows``), and ``pmax`` / ``psum`` reduce over the ranks."""

    def __init__(self, k: int, method: str = "auto", occ_cap: int = 128,
                 transpose_reuse: bool = False, split=None):
        self.k = k
        self.method = method
        self.occ_cap = occ_cap
        self.transpose_reuse = transpose_reuse
        self.split = split
        self._cache: Dict[Tuple, object] = {}

    def rows(self, n):
        """This rank's rows of an n-row query set (None in one process)."""
        return None if self.split is None else self.split.rows(n)

    def pmax(self, t):
        return t if self.split is None else self.split.pmax(t)

    def psum(self, t):
        return t if self.split is None else self.split.psum(t)

    def get_dense(self, src_name, dst_name, radius, points, pmask, queries,
                  qmask, lazy=False):
        """The pair's DensePair, or with ``lazy`` a LazyDensePair that
        holds the point sets only (``ops.cconv.continuous_conv_dense_lazy``
        rebuilds the field a source chunk at a time)."""
        key = ("dense", src_name, dst_name, float(radius))
        if key not in self._cache:
            rows = self.rows(queries.shape[0])
            queries, qmask = take_rows(rows, queries), take_rows(rows, qmask)
            if lazy:
                self._cache[key] = LazyDensePair(
                    src_pos=points, src_mask=pmask.bool(), dst_pos=queries,
                    dst_mask=qmask.bool(), radius=float(radius), rows=rows)
            else:
                rel, qnorm, valid = dense_geometry(points, pmask, queries,
                                                   qmask, radius)
                self._cache[key] = DensePair(
                    rel=rel, qnorm=qnorm, valid=valid,
                    count=valid.sum(dim=1, dtype=torch.int32), rows=rows)
        return self._cache[key]

    def get(self, src_name, dst_name, radius, points, pmask, queries, qmask,
            occ_cap=None, k=None) -> NeighborList:
        key = (src_name, dst_name, float(radius))
        tkey = (dst_name, src_name, float(radius))
        if key not in self._cache and self.transpose_reuse \
                and src_name != dst_name and tkey in self._cache:
            # the transpose's whole list (its rows from every rank), then
            # this rank's rows of its inverse
            self._cache[key] = slice_list(invert_neighbors_list(
                gather_list(self._cache[tkey]), queries.shape[0],
                k or self.k), self.rows(queries.shape[0]))
        elif key not in self._cache:
            self._cache[key] = search(
                points, queries, radius, k or self.k, method=self.method,
                points_mask=pmask, queries_mask=qmask,
                occ_cap=occ_cap or self.occ_cap,
                rows=self.rows(queries.shape[0]))
        return self._cache[key]



class PBFNet(nn.Module):
    """Physics scaffold base module.  Subclasses build the trunk in
    ``setup_net`` and run it in ``net_forward``.  Config names mirror the
    reference's so shipped YAML model sections construct it."""

    defaults = dict(
        kernel_size=(4, 4, 4), channels=16, strides=(1,),
        particle_radii=(0.05,),
        coordinate_mapping="ball_to_cube_volume_preserving",
        interpolation="linear", window=None, window_dens=None,
        rest_dens=3.5, ignore_query_points=False, grav=-9.81,
        transformation=None, timestep=0.01, circular=False, dens_feats=False,
        pres_feats=False, equivar=False, use_vel=True, use_acc=True,
        use_feats=False, use_box_feats=True, use_pre_adv=False,
        use_bnds=True, dens_norm=False, dens_radius=None, stiffness=20.0,
        voxel_size=None, centralize=False, out_scale=(0.01, 0.01, 0.01),
        sample_pad=0, sample_hyst=0.1, part_scale=1.0, sym_axis=2,
        neighbor_k=64, neighbor_k_gaps=None, neighbor_k_pairs=None,
        transpose_search_reuse=False, conv_k_chunk=0, dense_pair_min_k=0,
        dense_n_chunk=0, dense_n_chunk_eval=None,
        dense_lazy_min_elems=1 << 24, boundary_crop_max=0,
        boundary_crop_mode="contact", cell_occ_cap=None,
        scale_size_factor=1.0, search_method="auto", precision="default",
        # the reference caches a pair's taps up to this many elements
        # (``pbf.py:498``, a TPU memory knob no shipped config sets); a
        # conv over cached taps is never chunked over K
        tap_cache_max_elems=32 * 1024 * 1024,
    )

    def __init__(self, *, generator=None, device="cuda", **cfg):
        super().__init__()
        unknown = set(cfg) - set(self.defaults)
        if unknown:
            raise TypeError(f"unknown {type(self).__name__} options: "
                            f"{sorted(unknown)}")
        for k, v in {**self.defaults, **cfg}.items():
            setattr(self, k, v)
        self.device = resolve_device(device)
        is_bf16(self.precision)  # raises on an unknown precision
        self._radii = tuple(float(r) for r in self.particle_radii)
        self._dens_radii = (self._radii if self.dens_radius is None else
                            tuple(float(r) for r in self.dens_radius))
        self.window_dens_fn = get_window_func(self.window_dens)
        self._transform_cfg = dict(self.transformation or {})
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self._generator = generator
        extra = int(self.dens_feats) + int(self.pres_feats)
        # the fluid features but the sample's "feats" (``_fit_feats``)
        self.fluid_in = 1 + 3 * int(self.use_vel) + 3 * int(self.use_acc) \
            + extra
        self._feats_width = None
        self._feats_seed = int(torch.randint(
            2 ** 31 - 1, (1,), generator=generator)) if self.use_feats else 0
        box_in = 1 + 3 * int(self.use_box_feats) + extra
        # the scale-0 features: fluid conv, boundary conv, (pre-advection
        # conv,) dense, (pre-advection dense)
        self.scale0_channels = self.channels * (
            5 if self.use_pre_adv and self._use_scale0_convs() else 3)
        if self._use_scale0_convs():
            self.fluid_obs = self.make_cconv("fluid_obs", self.fluid_in,
                                             self.channels,
                                             window_func=self.window)
            self.fluid_dense = self.make_dense(self.fluid_in, self.channels)
            self.obs_conv = self.make_cconv("obs_conv", box_in,
                                            self.channels,
                                            window_func=self.window)
            self.obs_dense = self.make_dense(box_in, self.channels)
            if self.use_pre_adv:
                # the reference also declares adv_conv1 / adv_dense1; flax
                # creates no parameter for a module never called
                pre_in = 1 + 3 * int(self.use_vel)
                self.adv_conv0 = self.make_cconv("adv_conv0", pre_in,
                                                 self.channels,
                                                 window_func=self.window)
                self.adv_dense0 = self.make_dense(pre_in, self.channels)
        self.setup_net()
        if self.equivar:
            # the reference's "rot" Dense is never called: no parameter
            self.scale = self.make_dense(self.out_channels, 1)
        del self._generator

    def setup_net(self):
        raise NotImplementedError

    def _fluid_input_layers(self):
        """(name, layer) of each layer that takes the fluid features."""
        return [("fluid_obs", self.fluid_obs),
                ("fluid_dense", self.fluid_dense)]

    def _fit_feats(self, width):
        """``use_feats``: the fluid-input layers take ``width`` feature
        channels more, fixed by the first forward (its sample's "feats",
        0 without) or state dict (its kernels), as flax sizes them at init
        from the first sample.  Their kernels are re-drawn in place from
        the model's generator, so an optimizer made before holds them
        still; a later width that differs raises."""
        if self._feats_width is None:
            if width:
                g = torch.Generator().manual_seed(self._feats_seed)
                for _, layer in self._fluid_input_layers():
                    layer.resize_input(self.fluid_in + width, g)
            self._feats_width = width
        elif width != self._feats_width:
            raise ValueError(f"the sample's feats have {width} channels, "
                             f"the model takes {self._feats_width}")

    def _load_from_state_dict(self, state_dict, prefix, *args, **kw):
        if self.use_feats:
            name, layer = self._fluid_input_layers()[0]
            key = prefix + name + "." + next(
                k for k, _ in layer.named_parameters() if k.endswith("kernel"))
            if key in state_dict:
                self._fit_feats(state_dict[key].shape[-2] - self.fluid_in)
        super()._load_from_state_dict(state_dict, prefix, *args, **kw)

    def _use_scale0_convs(self):
        """Whether preprocess runs the scale-0 fluid/boundary convs
        (PointNet skips them)."""
        return True

    def net_forward(self, ctx, data, training=False):
        raise NotImplementedError

    def make_cconv(self, name, in_channels, filters, kernel_size=None,
                   window_func=None, normalize=False, symmetric=False,
                   sym_axis=2, use_bias=True, precision=None):
        """Conv factory registered under the flax module name; ``precision``
        defaults to the model's (the ASCC convs pin "highest")."""
        conv = ContinuousConv(
            in_channels, filters,
            tuple(kernel_size or self.kernel_size), use_bias=use_bias,
            align_corners=True, interpolation=self.interpolation,
            coordinate_mapping=self.coordinate_mapping,
            normalize=normalize,
            window_function=get_window_func(window_func),
            symmetric=symmetric, sym_axis=sym_axis, circular=self.circular,
            k_chunk=self.conv_k_chunk,
            precision=precision if precision is not None else self.precision,
            generator=self._generator,
            device=self.device)
        self.add_module(name, conv)
        return conv

    def make_dense(self, in_features, units, name=None):
        dense = Dense(in_features, units, generator=self._generator,
                      device=self.device)
        if name is not None:
            self.add_module(name, dense)
        return dense

    def caches_taps(self, nl, kernel_size=None):
        """Whether the reference caches the taps of a K-list conv over
        ``nl`` (``pbf.py:pair_taps``: Q*K*S at most
        ``tap_cache_max_elems``; Q of the whole query set where ``nl``
        holds one rank's rows)."""
        q, k = nl.idx.shape
        if nl.rows is not None:
            q = nl.rows.n
        return q * k * int(np.prod(kernel_size or self.kernel_size)) \
            <= self.tap_cache_max_elems

    def dense_chunk_for(self, training):
        if training:
            return self.dense_n_chunk
        return (self.dense_n_chunk_eval
                if self.dense_n_chunk_eval is not None else 0)

    def occ_for_radius(self, radius):
        """The cell search's window budget for a search radius
        (``cell_occ_cap``: scalar, or per scale by the nearest particle
        radius; None = 48 at the finest radius, 128 at the others)."""
        caps = self.cell_occ_cap
        if caps is None:
            caps = [48] + [128] * max(len(self._radii) - 1, 0)
        if not isinstance(caps, (list, tuple)):
            return int(caps)
        idx = int(np.argmin([abs(float(radius) - r) for r in self._radii]))
        return int(caps[min(idx, len(caps) - 1)])

    def _crop_boundary(self, pos, fluid_mask, box, bfeats, box_mask, ext):
        """Compact the boundary into ``boundary_crop_max`` slots.  Mode
        "contact": the boundary within ``ext`` of some fluid particle, the
        most-contacted first (a stable sort, ties to the lower row, as the
        reference's ``argsort(-w)``), so the slots' order is the
        reference's; mode "aabb": the boundary in the fluid's box grown by
        ``ext``, the first by row.  Returns (box, bfeats, mask, count of
        boundary in contact or in range)."""
        k = self.boundary_crop_max
        if self.boundary_crop_mode == "contact":
            from ..ops.cell_search import contact_weight_dense
            w = contact_weight_dense(pos, box, ext, points_mask=fluid_mask,
                                     queries_mask=box_mask)
            idx = torch.argsort(-w, stable=True)[:k]
            mask = w[idx] > 0
            count = (w > 0).sum(dtype=torch.int32)
        else:
            fm = fluid_mask[:, None]
            lo = torch.where(fm, pos, torch.inf).amin(dim=0) - ext
            hi = torch.where(fm, pos, -torch.inf).amax(dim=0) + ext
            in_range = box_mask & ((box >= lo) & (box <= hi)).all(dim=-1)
            idx, mask, _, count = select_k_valid(in_range[None, :], None, k)
            idx, mask, count = idx[0].long(), mask[0], count[0]
        return box[idx], bfeats[idx], mask, count

    def k_for_pair(self, inp_scale, out_scale):
        """Neighbor budget for a trunk conv from ``inp_scale`` to
        ``out_scale`` (``neighbor_k_pairs`` / ``neighbor_k_gaps``)."""
        i, j = int(inp_scale), int(out_scale)
        if self.neighbor_k_pairs is not None:
            m = self.neighbor_k_pairs
            row = m[min(i, len(m) - 1)]
            return int(row[min(j, len(row) - 1)])
        gap = j - i
        if gap <= 0 or self.neighbor_k_gaps is None:
            return self.neighbor_k
        gaps = self.neighbor_k_gaps
        if not isinstance(gaps, (list, tuple)):
            return int(gaps)
        return int(gaps[min(gap - 1, len(gaps) - 1)])

    # ------------------------------------------------------------------
    # physics

    def _gravity(self, like):
        g = torch.tensor([0.0, self.grav, 0.0], dtype=like.dtype,
                         device=like.device)
        return g.expand(like.shape)

    def integrate_pos_vel(self, pos1, vel1, acc1=None):
        """Semi-implicit Euler advection."""
        dt = self.timestep
        acc = acc1 if acc1 is not None else self._gravity(vel1)
        vel2 = vel1 + dt * acc
        pos2 = pos1 + dt * vel2
        return pos2, vel2

    def compute_new_pos_vel(self, pos1, vel1, pos2, vel2, pos_correction):
        """Apply the predicted correction; velocity from position delta."""
        pos = pos2 + pos_correction
        vel = (pos - pos1) / self.timestep
        return pos, vel

    def transform(self, sample):
        """Global translate/scale/gravity-equivariant rotation of the
        scene.  Returns (sample', rotation or None): ``grav_eqvar`` turns
        the scene so that its gravity (row 0 of ``grav``) points along the
        configured vector.  A ``grid_center`` (the voxel grids' anchor
        that the slab decomposition supplies) moves with the positions."""
        cfg = self._transform_cfg
        s = dict(sample)
        R = None
        dev = s["pos"].device
        if "translate" in cfg:
            t = torch.tensor(cfg["translate"], dtype=torch.float32,
                             device=dev)
            s["pos"] = s["pos"] + t
            s["box"] = s["box"] + t
            if s.get("grid_center") is not None:
                s["grid_center"] = s["grid_center"] + t
        if "scale" in cfg:
            sc = torch.tensor(cfg["scale"], dtype=torch.float32, device=dev)
            s["pos"] = s["pos"] * sc
            s["box"] = s["box"] * sc
            s["vel"] = s["vel"] * sc
            if s.get("grav") is not None:
                s["grav"] = s["grav"] * sc
            if s.get("grid_center") is not None:
                s["grid_center"] = s["grid_center"] * sc
        if "grav_eqvar" in cfg:
            target = torch.tensor(cfg["grav_eqvar"], dtype=torch.float32,
                                  device=dev)
            # same gravity for all particles of a sequence (row 0 is valid)
            R = align_vector(target, s["grav"][0])
            for k in ("pos", "vel", "grav", "box", "box_normals",
                      "grid_center"):
                if s.get(k) is not None:
                    s[k] = s[k] @ R
        return s, R

    def inv_transform(self, pos, vel, R=None):
        cfg = self._transform_cfg
        if "grav_eqvar" in cfg and R is not None:
            pos = pos @ R.T
            vel = vel @ R.T
        if "scale" in cfg:
            sc = torch.clamp(torch.tensor(cfg["scale"], dtype=torch.float32,
                                          device=pos.device), min=1e-5)
            pos = pos / sc
            vel = vel / sc
        if "translate" in cfg:
            pos = pos - torch.tensor(cfg["translate"], dtype=torch.float32,
                                     device=pos.device)
        return pos, vel

    # ------------------------------------------------------------------
    # main step

    def forward(self, sample, training=False, vel_corr=None, split=None):
        """One simulation step.

        ``sample``: dict of padded tensors ``pos`` [N,3], ``vel`` [N,3],
        optional ``grav`` [N,3], ``box`` [B,3], ``box_normals`` [B,3],
        ``fluid_mask`` [N], ``box_mask`` [B], optional ``grid_center`` [3]
        (the voxel pyramid's anchor; default the centroid).  ``vel_corr``:
        an externally corrected velocity (the training ``iterations``
        loop), used in place of the advected one, its gradient stopped.
        ``training`` selects the dense pairs' source chunking
        (``dense_n_chunk``).  ``split``: the sharded step's query-row
        split (``parallel.spatial.make_sharded_step``; the sample whole on
        every rank).  Returns (pos, vel, aux).
        """
        data, R = self.transform(sample)
        ctx = self.preprocess(data, vel_corr=vel_corr, split=split)
        out = self.net_forward(ctx, data, training=training)
        pos, vel, aux = self.postprocess(out, ctx, data, vel_corr=vel_corr)
        pos, vel = self.inv_transform(pos, vel, R)
        fm = data["fluid_mask"].bool()
        pos = torch.where(fm[:, None], pos, sample["pos"])
        vel = torch.where(fm[:, None], vel, 0.0)
        return pos, vel, aux

    def preprocess(self, data, vel_corr=None, split=None):
        """Advect (or take ``vel_corr``), assemble features, run the
        scale-0 convs, build the position pyramid (and the density
        pyramid with ``dens_norm``); ``split`` as ``forward``'s."""
        acc = data.get("grav")
        feats_in = data.get("feats")
        box, bfeats = data["box"], data["box_normals"]
        fluid_mask = data["fluid_mask"].bool()
        box_mask = data["box_mask"].bool()
        n_fluid = data["pos"].shape[0]

        if vel_corr is not None:
            vel = vel_corr.detach()
            pos = data["pos"] + vel * self.timestep
        else:
            pos, vel = self.integrate_pos_vel(data["pos"], data["vel"], acc)
        filter_extent = tuple(2.0 * r for r in self._radii)
        r0 = self._radii[0]

        pos = masked_positions(pos, fluid_mask)
        crop_count = None
        if 0 < self.boundary_crop_max < box.shape[0]:
            box, bfeats, box_mask, crop_count = self._crop_boundary(
                pos, fluid_mask, box, bfeats, box_mask, filter_extent[-1])
        box_pos = masked_positions(box, box_mask)
        all_pos = torch.cat([pos, box_pos], dim=0)
        all_mask = torch.cat([fluid_mask, box_mask], dim=0)

        cache = SearchCache(self.neighbor_k, method=self.search_method,
                            occ_cap=self.occ_for_radius(self._radii[-1]),
                            transpose_reuse=self.transpose_search_reuse,
                            split=split)

        # the pyramid is built over every particle, or over the fluid alone
        # without ``use_bnds``
        if self.use_bnds:
            base_pos, base_mask = all_pos, all_mask
        else:
            base_pos, base_mask = pos, fluid_mask
        all_max = base_pos.shape[0]
        if isinstance(self.scale_size_factor, (list, tuple)):
            factors = list(self.scale_size_factor)
        else:
            factors = [float(self.scale_size_factor)] * len(self.strides)
        out_maxes = [all_max if s == 1 else
                     max(8, int(np.ceil(all_max * factors[si])))
                     for si, s in enumerate(self.strides)]
        dpos, dmask, dcount, didx = get_dilated_pos(
            base_pos, base_mask, list(self.strides), out_maxes,
            voxel_size=(None if self.voxel_size is None
                        else np.asarray(self.voxel_size, np.float32)),
            centralize=self.centralize, pad=self.sample_pad,
            hyst=self.sample_hyst, center=data.get("grid_center"))

        # where scale 0 of the pyramid IS all_pos (stride 1, use_bnds), one
        # all->all search at the finest radius serves the trunk pair
        # (0, 0), the scale-0 convs, the densities and the ASCC layer
        name0 = "dilated0" if self.strides[0] == 1 and self.use_bnds \
            else "all"
        nl_all0 = cache.get(name0, name0, r0, all_pos, all_mask, all_pos,
                            all_mask, occ_cap=self.occ_for_radius(r0))
        nl_fluid0 = subset_neighbors(nl_all0, lambda i, d: i < n_fluid)
        nl_box0 = subset_neighbors(nl_all0, lambda i, d: i >= n_fluid)

        fluid_feats = [torch.where(fluid_mask[:, None], 1.0, 0.0)]
        if self.use_vel:
            fluid_feats.append(vel)
        if self.use_acc:
            fluid_feats.append(acc if acc is not None
                               else self._gravity(vel))
        if self.use_feats:
            self._fit_feats(0 if feats_in is None else feats_in.shape[-1])
            if feats_in is not None:
                fluid_feats.append(feats_in)
        box_feats = [torch.where(box_mask[:, None], 1.0, 0.0)]
        if self.use_box_feats:
            box_feats.append(bfeats)

        dens = None
        if self.dens_feats or self.dens_norm or self.pres_feats:
            rd = self._dens_radii[0]
            nl_dens = nl_all0 if rd == r0 else cache.get(
                "all", "all", rd, all_pos, all_mask, all_pos, all_mask,
                occ_cap=self.occ_for_radius(rd))
            # the reference divides by the Python float rd ** 2
            q = nl_dens.dist / torch.tensor(rd ** 2, dtype=torch.float32,
                                            device=all_pos.device)
            w = self.window_dens_fn(q) if self.window_dens_fn is not None \
                else q
            dens = all_rows(nl_dens.rows,
                            torch.where(nl_dens.mask, w, 0.0).sum(dim=1))
            if self.dens_feats:
                fluid_feats.append(dens[:n_fluid, None])
                box_feats.append(dens[n_fluid:, None])
            if self.pres_feats:
                pres = compute_pressure(dens, self.rest_dens, self.stiffness)
                fluid_feats.append(pres[:n_fluid, None])
                box_feats.append(pres[n_fluid:, None])
        fluid_feats = torch.where(fluid_mask[:, None],
                                  torch.cat(fluid_feats, dim=-1), 0.0)
        box_feats = torch.where(box_mask[:, None],
                                torch.cat(box_feats, dim=-1), 0.0)

        if not self._use_scale0_convs():
            # PointNet: raw fluid features, no scale-0 convs
            feats = fluid_feats
        else:
            ext0 = filter_extent[0]
            # the reference's scale-0 convs share the all->all pair's taps
            cached = self.caches_taps(nl_all0)
            ans_conv = self.fluid_obs(fluid_feats * self.part_scale, pos,
                                      all_pos, ext0, nl_fluid0,
                                      cached_taps=cached)
            ans_dense = self.fluid_dense(fluid_feats)
            # nl_box0 indexes all_pos (offset by n_fluid) while the features
            # are box rows: continuous_conv clamps the gather exactly as the
            # reference's JAX gather does (ROADMAP §3, obs_conv gather
            # offset).  Where the search kept no disp, the reference's
            # geometry comes from its cached all->all taps (all_pos) or,
            # past the tap cache, from box_pos by the same clamped gather
            ans_obs = self.obs_conv(box_feats * self.part_scale,
                                    all_pos if cached else box_pos,
                                    all_pos, ext0, nl_box0,
                                    cached_taps=cached)
            ans_dense_obs = self.obs_dense(box_feats)
            ans_dense = torch.cat([ans_dense, ans_dense_obs], dim=0)
            if self.use_pre_adv:
                # a conv over the un-advected fluid positions
                pre_pos = masked_positions(data["pos"], fluid_mask)
                pre_feats = [torch.where(fluid_mask[:, None], 1.0, 0.0)]
                if self.use_vel:
                    pre_feats.append(data["vel"])
                pre_feats = torch.where(fluid_mask[:, None],
                                        torch.cat(pre_feats, dim=-1), 0.0)
                nl_pre = cache.get("pre", "all", r0, pre_pos, fluid_mask,
                                   all_pos, all_mask,
                                   occ_cap=self.occ_for_radius(r0))
                ans_adv = self.adv_conv0(pre_feats * self.part_scale,
                                         pre_pos, all_pos, ext0, nl_pre)
                ans_dense_adv = torch.cat(
                    [self.adv_dense0(pre_feats), ans_dense_obs], dim=0)
                feats = torch.cat([ans_conv, ans_obs, ans_adv, ans_dense,
                                   ans_dense_adv], dim=-1)
            else:
                feats = torch.cat([ans_conv, ans_obs, ans_dense], dim=-1)
            feats = torch.where(all_mask[:, None], feats, 0.0)

        dens_pyramid = None
        if self.dens_norm:
            d0 = dens if self.use_bnds else dens[:n_fluid]
            dens_pyramid = [torch.where(base_mask, torch.clamp(d0, min=1e-2),
                                        1.0)[:, None]]
            for scale in range(1, len(self._dens_radii)):
                ext_s = self._dens_radii[scale]
                nl_s = cache.get(f"dilated{scale - 1}", f"dilated{scale}",
                                 ext_s / 2.0, dpos[scale - 1],
                                 dmask[scale - 1], dpos[scale], dmask[scale],
                                 occ_cap=self.occ_for_radius(ext_s / 2.0),
                                 k=self.k_for_pair(scale - 1, scale))
                d = all_rows(nl_s.rows, torch.clamp(point_sampling(
                    dens_pyramid[-1], nl_s, ext_s,
                    window_fn=self.window_dens_fn, normalize=True), min=1e-2))
                dens_pyramid.append(torch.where(dmask[scale][:, None], d,
                                                1.0))

        return {
            "cache": cache,
            "boundary_crop_count": crop_count,
            "all_pos": all_pos,
            "all_mask": all_mask,
            "n_fluid": n_fluid,
            "filter_extent": filter_extent,
            "feats": feats,
            "dilated_pos": dpos,
            "dilated_mask": dmask,
            "dilated_count": dcount,
            "dilated_caps": out_maxes,
            "dilated_idx": didx,
            "dens_pyramid": dens_pyramid,
            "nl_all0": nl_all0,
            "nl_fluid0": nl_fluid0,
        }

    def equivariant_output(self, out, ctx):
        """``equivar``: the output becomes the mean displacement to the
        neighbours at the finest radius, each scaled by the neighbour's
        learned scale (the reference's ``rot`` is never applied)."""
        return compute_transformed_dx(ctx["all_pos"], ctx["all_mask"],
                                      scale=self.scale(out), rot=None,
                                      radius=self._radii[0],
                                      k=self.neighbor_k)

    @staticmethod
    def pair_excess(ctx):
        """Worst per-pair K-budget excess over every search of the step
        (> 0: a conv dropped in-radius neighbours), and each pair's.  Dense
        pairs cannot overflow: their detail entry is the always <= 0 margin
        max true count - N; a lazy one has no field to reduce and no
        entry."""
        dev = ctx["all_pos"].device
        excess, detail = [torch.zeros((), dtype=torch.int32, device=dev)], {}
        for ckey, nl in ctx["cache"]._cache.items():
            if isinstance(nl, LazyDensePair):
                continue
            if isinstance(nl, DensePair):
                detail[f"{ckey[1]}>{ckey[2]}@{ckey[3]:g}(dense)"] = \
                    nl.count.max() - nl.valid.shape[1]
                continue
            e = nl.count.max() - nl.idx.shape[1]
            excess.append(e)
            detail[f"{ckey[0]}>{ckey[1]}@{ckey[2]:g}"] = e
        return torch.stack(excess).max(), detail

    def neighbor_stats(self, ctx, nl, mask):
        """The step's neighbour statistics: over ``nl``'s rows (``mask``
        their validity, the whole set's) the largest count, the sum of the
        valid rows' counts and the largest cell overflow (None without),
        and ``pair_excess``.  In the sharded step each is over every
        rank's rows: one ``pmax``, one ``psum``."""
        cache = ctx["cache"]
        excess, detail = self.pair_excess(ctx)
        top = [nl.count.max(), excess, *detail.values()]
        if nl.cell_overflow is not None:
            top.append(nl.cell_overflow.max())
        top = cache.pmax(torch.stack([t.to(torch.int32) for t in top]))
        total = cache.psum(torch.where(take_rows(nl.rows, mask), nl.count,
                                       0).sum())
        return dict(
            neighbor_overflow=top[0], count_sum=total, pair_overflow=top[1],
            pair_overflow_detail=dict(zip(detail, top[2:2 + len(detail)])),
            cell_overflow=top[-1] if nl.cell_overflow is not None else None)

    def postprocess(self, out, ctx, data, vel_corr=None):
        """Scale the net output into a position correction, re-integrate,
        and report the neighbor statistics."""
        pos, vel = data["pos"], data["vel"]
        fluid_mask = data["fluid_mask"].bool()
        n_fluid = ctx["n_fluid"]
        dev = pos.device

        nl_fluid0 = ctx["nl_fluid0"]
        num_fluid_neighbors = all_rows(nl_fluid0.rows, nl_fluid0.mask.sum(
            dim=1).to(torch.float32))[:n_fluid]

        if self.equivar:
            out = self.equivariant_output(out, ctx)
        if out.shape[-1] == 1:
            out = out.repeat(1, 3)
        elif out.shape[-1] == 2:
            out = torch.cat([out, out[:, :1]], dim=-1)
        out_scale = torch.tensor(self.out_scale, dtype=torch.float32,
                                 device=dev)
        pos_correction = torch.where(fluid_mask[:, None],
                                     out_scale * out[:n_fluid], 0.0)

        if vel_corr is not None:
            vel2 = vel_corr.detach()
            pos2 = pos + vel2 * self.timestep
        else:
            pos2, vel2 = self.integrate_pos_vel(pos, vel, data.get("grav"))
        pos_out, vel_out = self.compute_new_pos_vel(pos, vel, pos2, vel2,
                                                    pos_correction)

        all_mask = ctx["all_mask"]
        n_valid = torch.clamp(all_mask.sum(), min=1)
        stats = self.neighbor_stats(ctx, ctx["nl_all0"], all_mask)
        aux = {
            "num_fluid_neighbors": num_fluid_neighbors,
            "pos_correction": pos_correction,
            "neighbor_overflow": stats["neighbor_overflow"],
            "pair_overflow": stats["pair_overflow"],
            "pair_overflow_detail": stats["pair_overflow_detail"],
            "avg_neighbors": stats["count_sum"] / n_valid,
            "scale_counts": torch.stack([c.to(torch.int32)
                                         for c in ctx["dilated_count"]]),
            "scale_caps": torch.tensor(ctx["dilated_caps"],
                                       dtype=torch.int32, device=dev),
        }
        if stats["cell_overflow"] is not None:
            aux["cell_overflow"] = stats["cell_overflow"]
        if ctx["boundary_crop_count"] is not None:
            aux["boundary_crop_count"] = ctx["boundary_crop_count"]
        return pos_out, vel_out, aux
