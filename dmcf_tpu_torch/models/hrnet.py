"""HRNet: multi-scale continuous-conv trunk over the position pyramid (port
of dmcf_tpu/models/hrnet.py).

A grid of convs ``layer_channels[layer][scale][conv_idx]``: each layer
computes every output scale from every input scale (the coarser scale's
radius), merged by sum or concat, then runs the scale's extra convs
(``conv_idx >= 1``) on the merged output.  Same-scale and upsampling pairs
use K-list neighbor lists; pairs whose K budget reaches
``dense_pair_min_k`` (the downsampling pairs of WaterRamps) run densely
over all source points, and where the pair's Q*N reaches
``dense_lazy_min_elems`` without keeping the [Q, N] field
(``LazyDensePair``).  On the farthest-point pyramid (``voxel_size: None``)
a cross-scale pair also adds a dense layer of its input carried across
the scales by the pyramid's indices: gathered down, scatter-added up.
With ``dens_norm`` every trunk conv of a scale with a density takes
``[f, f / dens^2]``.
"""

from __future__ import annotations

import torch

from ..ops.neighbors import NeighborList
from .pbf import PBFNet, drop_coincident


def _act(name):
    if name == "tanh":
        return torch.tanh
    if name is None:
        return lambda x: x
    raise NotImplementedError(f"unknown out_activation: {name}")


class HRNet(PBFNet):
    defaults = dict(PBFNet.defaults, layer_channels=((16,), (32,), (32,),
                                                     (3,)),
                    add_merge=False, out_activation=None)

    def setup_net(self):
        """``self.convs[i][j][k][l]`` and ``self.denses[i][j][k][l]`` are
        the reference's ``conv{i+1}{j}{k}_{l}`` and ``dense{i+1}{j}{k}_{l}``
        (None where the reference never calls the dense: a cross-scale
        input of the voxel pyramid)."""
        lc = self.layer_channels
        n_dens = len(self._dens_radii) if self.dens_norm else 0
        prev = [self.scale0_channels]
        self.convs, self.denses = [], []
        for i in range(1, len(lc)):
            convs_i, denses_i, widths = [], [], []
            # the inputs' widths, doubled where dens_norm appends f / dens^2
            cin = [w * (2 if l < n_dens else 1) for l, w in enumerate(prev)]
            for j in range(len(lc[i])):
                convs_j, denses_j = [], []
                for k, ch in enumerate(lc[i][j]):
                    if k == 0:
                        convs_j.append([
                            self.make_cconv(f"conv{i}{j}0_{l}", cin[l], ch,
                                            window_func=self.window)
                            for l in range(len(prev))])
                        denses_j.append([
                            self.make_dense(cin[l], ch,
                                            name=f"dense{i}{j}0_{l}")
                            if l == j or self.voxel_size is None else None
                            for l in range(len(prev))])
                        width = ch if self.add_merge else ch * len(prev)
                    else:
                        convs_j.append([self.make_cconv(
                            f"conv{i}{j}{k}_0", width, ch,
                            window_func=self.window)])
                        denses_j.append([self.make_dense(
                            width, ch, name=f"dense{i}{j}{k}_0")])
                        width = ch
                convs_i.append(convs_j)
                denses_i.append(denses_j)
                widths.append(width)
            self.convs.append(convs_i)
            self.denses.append(denses_i)
            prev = widths
        self.out_channels = prev[0]

    def _pair_neighbors(self, ctx, inp_scale, out_scale, radius,
                        ignore_query=False):
        """Cached neighbor structure for a scale pair: a DensePair when the
        pair's K budget reaches ``dense_pair_min_k`` (a LazyDensePair where
        its Q*N reaches ``dense_lazy_min_elems``), else a NeighborList."""
        dpos, dmask = ctx["dilated_pos"], ctx["dilated_mask"]
        if (0 < self.dense_pair_min_k
                <= self.k_for_pair(inp_scale, out_scale)
                and not ignore_query):
            n = dpos[inp_scale].shape[0]
            q = dpos[out_scale].shape[0]
            return ctx["cache"].get_dense(
                f"dilated{inp_scale}", f"dilated{out_scale}", radius,
                dpos[inp_scale], dmask[inp_scale], dpos[out_scale],
                dmask[out_scale], lazy=q * n >= self.dense_lazy_min_elems)
        nl = ctx["cache"].get(
            f"dilated{inp_scale}", f"dilated{out_scale}", radius,
            dpos[inp_scale], dmask[inp_scale], dpos[out_scale],
            dmask[out_scale], occ_cap=self.occ_for_radius(radius),
            k=self.k_for_pair(inp_scale, out_scale))
        if ignore_query:
            nl = drop_coincident(nl, dpos[inp_scale], dpos[out_scale])
        return nl

    def _conv(self, conv, ctx, f, inp_scale, out_scale, ext, ignore_query,
              n_chunk):
        pos = ctx["dilated_pos"]
        nl = self._pair_neighbors(ctx, inp_scale, out_scale, ext / 2.0,
                                  ignore_query=ignore_query)
        cached = isinstance(nl, NeighborList) and self.caches_taps(nl)
        return conv(f, pos[inp_scale], pos[out_scale], ext, nl,
                    n_chunk=n_chunk, cached_taps=cached)

    def net_forward(self, ctx, data, training=False):
        masks = ctx["dilated_mask"]
        idx = [None if i is None else i.long() for i in ctx["dilated_idx"]]
        dens = ctx["dens_pyramid"]
        filter_extent = ctx["filter_extent"]
        nck = self.dense_chunk_for(training)

        feats = ctx["feats"]
        if not self.use_bnds:  # the pyramid holds the fluid alone
            feats = feats[:ctx["n_fluid"]]
        ans_convs = [[feats]]
        for layer in range(len(self.convs)):
            ans = []
            for scale in range(len(self.convs[layer])):
                importance = self.part_scale if scale == 0 else 1.0
                convs = self.convs[layer][scale]
                denses = self.denses[layer][scale]
                inp = []
                ext = filter_extent[0]
                for inp_scale in range(len(ans_convs[-1])):
                    f = torch.relu(ans_convs[-1][inp_scale])
                    ext = filter_extent[max(inp_scale, scale)]
                    if dens is not None and inp_scale < len(dens):
                        f = torch.cat([f, f / dens[inp_scale] ** 2], dim=-1)
                    f = torch.where(masks[inp_scale][:, None], f, 0.0)
                    ans_conv = self._conv(
                        convs[0][inp_scale], ctx, f * importance, inp_scale,
                        scale, ext, self.ignore_query_points
                        and scale == inp_scale, nck)
                    if scale == inp_scale:
                        ans_conv = ans_conv + denses[0][inp_scale](f)
                        if ans_conv.shape[-1] == \
                                ans_convs[-1][scale].shape[-1]:
                            ans_conv = ans_conv + ans_convs[-1][scale]
                    elif self.voxel_size is None and scale > inp_scale:
                        # the input carried down the pyramid's picks
                        g = f
                        for i in range(inp_scale, scale):
                            g = g[idx[i + 1]]
                        ans_conv = ans_conv + denses[0][inp_scale](g)
                    elif self.voxel_size is None:
                        # and scatter-added up to the rows it was picked
                        # from
                        ind = idx[scale + 1]
                        for i in range(scale + 1, inp_scale):
                            ind = ind[idx[i + 1]]
                        d = torch.where(masks[inp_scale][:, None],
                                        denses[0][inp_scale](f), 0.0)
                        ans_conv = ans_conv.index_add(0, ind, d)
                    inp.append(ans_conv)
                if self.add_merge:
                    merged = inp[0]
                    for t in inp[1:]:
                        merged = merged + t
                else:
                    merged = torch.cat(inp, dim=-1)
                # the scale's extra convs, at the last input's extent (the
                # reference's loop variable, reproduced on purpose)
                for k in range(1, len(convs)):
                    f = torch.where(masks[scale][:, None], merged, 0.0)
                    ans_conv = self._conv(
                        convs[k][0], ctx, f * importance, scale, scale, ext,
                        self.ignore_query_points, nck) \
                        + denses[k][0](merged)
                    if len(ans_convs[-1]) > scale and ans_conv.shape[-1] \
                            == ans_convs[-1][scale].shape[-1]:
                        ans_conv = ans_conv + ans_convs[-1][scale]
                    merged = ans_conv
                ans.append(merged)
            ans_convs.append(ans)
        return _act(self.out_activation)(ans_convs[-1][0])
