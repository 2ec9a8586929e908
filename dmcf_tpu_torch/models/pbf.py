"""PBF physics scaffold shared by the learned-SPH models (port of
dmcf_tpu/models/pbf.py: the rollout and training paths).

A sample is padded fluid/boundary tensors with validity masks; padded
particles sit at far sentinel positions and every op is mask-exact.  One
neighbor search per (point-set pair, radius) per step is shared by every
conv through ``SearchCache``; the scale-0 all->all search also serves the
fluid->all and box->all convs by subsetting.

Left out on purpose: the reference's batched pair prefetch and tap-tensor
caching are TPU launch-count devices that give bitwise-identical lists
(the K-list kernel builds its taps inline; the reference's cached bf16
taps equal the inline ones rounded once).  Options this slice does not
port raise instead of being ignored; config keys the port has no use for
(the reference's TPU tuning knobs, the density-feature constants) are
dropped with a warning by ``build_model``.  ``window_dens`` and
``rest_dens`` are kept on the module, as in the reference, because the
valid suite's max-density metric reads ``window_dens`` from the model.

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
from ..ops.neighbors import DensePair, NeighborList, search
from ..ops.sph import get_dilated_pos, masked_positions
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
        disp=torch.where(mask[..., None], nl.disp, 0.0))


def drop_coincident(nl: NeighborList) -> NeighborList:
    """The ``ignore_query_point`` variant of a neighbor list: drops slots
    whose displacement is exactly zero (coincident positions)."""
    same = nl.mask & (nl.disp == 0.0).all(dim=-1)
    return subset_neighbors(nl, lambda idx, dist: ~same)


class SearchCache:
    """One fixed-radius search per (src, dst, radius) per step, and one
    dense pair field per (src, dst, radius), shared by every conv."""

    def __init__(self, k: int, method: str = "auto"):
        self.k = k
        self.method = method
        self._cache: Dict[Tuple, object] = {}

    def get_dense(self, src_name, dst_name, radius, points, pmask, queries,
                  qmask) -> DensePair:
        key = ("dense", src_name, dst_name, float(radius))
        if key not in self._cache:
            r = torch.tensor(float(radius), dtype=points.dtype,
                             device=points.device)
            rel = points[None, :, :] - queries[:, None, :]  # [Q, N, 3]
            d2 = (rel * rel).sum(dim=-1)
            r2 = r * r
            valid = ((d2 <= r2) & pmask[None, :].bool()
                     & qmask[:, None].bool())
            # invalid pairs pinned to harmless geometry just outside the
            # ball (padded rows sit at 1e8 sentinels); masks, not
            # distances, keep them out
            rel = torch.where(valid[..., None], rel * (1.0 / r), 1.0)
            qnorm = torch.where(valid, d2 * (1.0 / r2), 2.0)
            self._cache[key] = DensePair(
                rel=rel, qnorm=qnorm, valid=valid,
                count=valid.sum(dim=1, dtype=torch.int32))
        return self._cache[key]

    def get(self, src_name, dst_name, radius, points, pmask, queries, qmask,
            k=None) -> NeighborList:
        key = (src_name, dst_name, float(radius))
        if key not in self._cache:
            self._cache[key] = search(
                points, queries, radius, k or self.k, method=self.method,
                points_mask=pmask, queries_mask=qmask)
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
        use_bnds=True, dens_norm=False,
        voxel_size=None, centralize=False, out_scale=(0.01, 0.01, 0.01),
        sample_pad=0, sample_hyst=0.1, part_scale=1.0, sym_axis=2,
        neighbor_k=64, neighbor_k_gaps=None, neighbor_k_pairs=None,
        transpose_search_reuse=False, conv_k_chunk=0, dense_pair_min_k=0,
        dense_n_chunk=0, dense_n_chunk_eval=None,
        dense_lazy_min_elems=1 << 24, boundary_crop_max=0,
        scale_size_factor=1.0, search_method="auto", precision="default",
    )
    # the reference caches a pair's taps up to this many elements
    # (``pbf.py:498``, a TPU memory knob no shipped config sets)
    TAP_CACHE_MAX_ELEMS = 32 * 1024 * 1024

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
        self._check_supported()
        self._radii = tuple(float(r) for r in self.particle_radii)
        self._transform_cfg = dict(self.transformation or {})
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self._generator = generator
        fluid_in = 1 + 3 * int(self.use_vel) + 3 * int(self.use_acc)
        box_in = 1 + 3 * int(self.use_box_feats)
        self.fluid_obs = self.make_cconv("fluid_obs", fluid_in,
                                         self.channels,
                                         window_func=self.window)
        self.fluid_dense = self.make_dense(fluid_in, self.channels)
        self.obs_conv = self.make_cconv("obs_conv", box_in, self.channels,
                                        window_func=self.window)
        self.obs_dense = self.make_dense(box_in, self.channels)
        self.setup_net()
        del self._generator

    def _check_supported(self):
        unported = {
            "transformation.grav_eqvar":
                "grav_eqvar" in (self.transformation or {}),
            "use_pre_adv": self.use_pre_adv,
            "equivar": self.equivar,
            "dens_feats": self.dens_feats,
            "dens_norm": self.dens_norm,
            "pres_feats": self.pres_feats,
            "boundary_crop_max > 0": self.boundary_crop_max > 0,
            "voxel_size: None (FPS pyramid)": self.voxel_size is None,
            "use_bnds: False": not self.use_bnds,
            "use_feats": self.use_feats,
            "strides[0] != 1": tuple(self.strides)[0] != 1,
            "transpose_search_reuse": self.transpose_search_reuse,
        }
        bad = [name for name, on in unported.items() if on]
        if bad:
            raise NotImplementedError(
                f"{type(self).__name__} options not ported yet: {bad}")

    def setup_net(self):
        raise NotImplementedError

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
        ``TAP_CACHE_MAX_ELEMS``)."""
        q, k = nl.idx.shape
        return q * k * int(np.prod(kernel_size or self.kernel_size)) \
            <= self.TAP_CACHE_MAX_ELEMS

    def dense_chunk_for(self, training):
        if training:
            return self.dense_n_chunk
        return (self.dense_n_chunk_eval
                if self.dense_n_chunk_eval is not None else 0)

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
        """Global translate/scale of the scene."""
        cfg = self._transform_cfg
        s = dict(sample)
        dev = s["pos"].device
        if "translate" in cfg:
            t = torch.tensor(cfg["translate"], dtype=torch.float32,
                             device=dev)
            s["pos"] = s["pos"] + t
            s["box"] = s["box"] + t
        if "scale" in cfg:
            sc = torch.tensor(cfg["scale"], dtype=torch.float32, device=dev)
            s["pos"] = s["pos"] * sc
            s["box"] = s["box"] * sc
            s["vel"] = s["vel"] * sc
            if s.get("grav") is not None:
                s["grav"] = s["grav"] * sc
        return s

    def inv_transform(self, pos, vel):
        cfg = self._transform_cfg
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

    def forward(self, sample, training=False, vel_corr=None):
        """One simulation step.

        ``sample``: dict of padded tensors ``pos`` [N,3], ``vel`` [N,3],
        optional ``grav`` [N,3], ``box`` [B,3], ``box_normals`` [B,3],
        ``fluid_mask`` [N], ``box_mask`` [B].  ``vel_corr``: an externally
        corrected velocity (the training ``iterations`` loop), used in
        place of the advected one, its gradient stopped.  ``training``
        selects the dense pairs' source chunking (``dense_n_chunk``).
        Returns (pos, vel, aux).
        """
        data = self.transform(sample)
        ctx = self.preprocess(data, vel_corr=vel_corr)
        out = self.net_forward(ctx, data, training=training)
        pos, vel, aux = self.postprocess(out, ctx, data, vel_corr=vel_corr)
        pos, vel = self.inv_transform(pos, vel)
        fm = data["fluid_mask"].bool()
        pos = torch.where(fm[:, None], pos, sample["pos"])
        vel = torch.where(fm[:, None], vel, 0.0)
        return pos, vel, aux

    def preprocess(self, data, vel_corr=None):
        """Advect (or take ``vel_corr``), assemble features, run the
        scale-0 convs, build the position pyramid."""
        acc = data.get("grav")
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
        box_pos = masked_positions(box, box_mask)
        all_pos = torch.cat([pos, box_pos], dim=0)
        all_mask = torch.cat([fluid_mask, box_mask], dim=0)

        cache = SearchCache(self.neighbor_k, method=self.search_method)

        all_max = all_pos.shape[0]
        if isinstance(self.scale_size_factor, (list, tuple)):
            factors = list(self.scale_size_factor)
        else:
            factors = [float(self.scale_size_factor)] * len(self.strides)
        out_maxes = [all_max if s == 1 else
                     max(8, int(np.ceil(all_max * factors[si])))
                     for si, s in enumerate(self.strides)]
        dpos, dmask, dcount = get_dilated_pos(
            all_pos, all_mask, list(self.strides), out_maxes,
            voxel_size=np.asarray(self.voxel_size, np.float32),
            centralize=self.centralize, pad=self.sample_pad,
            hyst=self.sample_hyst)

        # scale 0 of the pyramid IS all_pos: one all->all search at the
        # finest radius serves the trunk pair (0, 0), the scale-0 convs and
        # the ASCC layer
        nl_all0 = cache.get("dilated0", "dilated0", r0, all_pos, all_mask,
                            all_pos, all_mask)
        nl_fluid0 = subset_neighbors(nl_all0, lambda i, d: i < n_fluid)
        nl_box0 = subset_neighbors(nl_all0, lambda i, d: i >= n_fluid)

        fluid_feats = [torch.where(fluid_mask[:, None], 1.0, 0.0)]
        if self.use_vel:
            fluid_feats.append(vel)
        if self.use_acc:
            fluid_feats.append(acc if acc is not None
                               else self._gravity(vel))
        box_feats = [torch.where(box_mask[:, None], 1.0, 0.0)]
        if self.use_box_feats:
            box_feats.append(bfeats)
        fluid_feats = torch.where(fluid_mask[:, None],
                                  torch.cat(fluid_feats, dim=-1), 0.0)
        box_feats = torch.where(box_mask[:, None],
                                torch.cat(box_feats, dim=-1), 0.0)

        ext0 = filter_extent[0]
        # the reference's scale-0 convs share the all->all pair's taps
        cached = self.caches_taps(nl_all0)
        ans_conv = self.fluid_obs(fluid_feats * self.part_scale, pos,
                                  all_pos, ext0, nl_fluid0,
                                  cached_taps=cached)
        ans_dense = self.fluid_dense(fluid_feats)
        # nl_box0 indexes all_pos (offset by n_fluid) while the features
        # are box rows: continuous_conv clamps the gather exactly as the
        # reference's JAX gather does (ROADMAP §3, obs_conv gather offset)
        ans_obs = self.obs_conv(box_feats * self.part_scale, box_pos,
                                all_pos, ext0, nl_box0, cached_taps=cached)
        ans_dense = torch.cat([ans_dense, self.obs_dense(box_feats)], dim=0)
        feats = torch.cat([ans_conv, ans_obs, ans_dense], dim=-1)
        feats = torch.where(all_mask[:, None], feats, 0.0)

        return {
            "cache": cache,
            "all_pos": all_pos,
            "all_mask": all_mask,
            "n_fluid": n_fluid,
            "filter_extent": filter_extent,
            "feats": feats,
            "dilated_pos": dpos,
            "dilated_mask": dmask,
            "dilated_count": dcount,
            "dilated_caps": out_maxes,
            "nl_all0": nl_all0,
            "nl_fluid0": nl_fluid0,
        }

    def postprocess(self, out, ctx, data, vel_corr=None):
        """Scale the net output into a position correction, re-integrate,
        and report the neighbor statistics."""
        pos, vel = data["pos"], data["vel"]
        fluid_mask = data["fluid_mask"].bool()
        n_fluid = ctx["n_fluid"]
        dev = pos.device

        num_fluid_neighbors = ctx["nl_fluid0"].mask.sum(dim=1).to(
            torch.float32)[:n_fluid]

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

        # worst per-pair K-budget excess over every search of the step
        # (dense pairs cannot overflow: their detail entry is the always
        # <= 0 margin max true count - N)
        excess, detail = [torch.zeros((), dtype=torch.int32, device=dev)], {}
        for ckey, nl in ctx["cache"]._cache.items():
            if isinstance(nl, DensePair):
                detail[f"{ckey[1]}>{ckey[2]}@{ckey[3]:g}(dense)"] = \
                    nl.count.max() - nl.valid.shape[1]
                continue
            e = nl.count.max() - nl.idx.shape[1]
            excess.append(e)
            detail[f"{ckey[0]}>{ckey[1]}@{ckey[2]:g}"] = e
        all_mask = ctx["all_mask"]
        n_valid = torch.clamp(all_mask.sum(), min=1)
        nl_all0 = ctx["nl_all0"]
        aux = {
            "num_fluid_neighbors": num_fluid_neighbors,
            "pos_correction": pos_correction,
            "neighbor_overflow": nl_all0.count.max(),
            "pair_overflow": torch.stack(excess).max(),
            "pair_overflow_detail": detail,
            "avg_neighbors": torch.where(all_mask, nl_all0.count, 0).sum()
            / n_valid,
            "scale_counts": torch.stack([c.to(torch.int32)
                                         for c in ctx["dilated_count"]]),
            "scale_caps": torch.tensor(ctx["dilated_caps"],
                                       dtype=torch.int32, device=dev),
        }
        return pos_out, vel_out, aux
