"""HRNet: multi-scale continuous-conv trunk over the voxel pyramid (port of
dmcf_tpu/models/hrnet.py).

A grid of convs ``layer_channels[layer][scale][conv_idx]``: each layer
computes every output scale from every input scale (the coarser scale's
radius), merged by sum or concat.  Same-scale and upsampling pairs use
K-list neighbor lists; pairs whose K budget reaches ``dense_pair_min_k``
(the downsampling pairs of WaterRamps) run densely over all source points,
and where the pair's Q*N reaches ``dense_lazy_min_elems`` without keeping
the [Q, N] field (``LazyDensePair``).
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
        lc = self.layer_channels
        # scale-0 features: fluid conv, boundary conv, dense — channels each
        prev = [3 * self.channels]
        self.convs, self.denses = [], []
        for i in range(1, len(lc)):
            convs_i, denses_i, widths = [], [], []
            for j in range(len(lc[i])):
                if len(lc[i][j]) != 1:
                    raise NotImplementedError(
                        "extra per-scale convs (conv_idx >= 1) are not "
                        "ported yet")
                ch = lc[i][j][0]
                convs_i.append([
                    self.make_cconv(f"conv{i}{j}0_{l}", prev[l], ch,
                                    window_func=self.window)
                    for l in range(len(prev))])
                # same-scale inputs get a dense skip; cross-scale ones do
                # not (voxel pyramid), so the reference never creates them
                denses_i.append(
                    self.make_dense(prev[j], ch, name=f"dense{i}{j}0_{j}")
                    if j < len(prev) else None)
                widths.append(ch if self.add_merge else ch * len(prev))
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

    def net_forward(self, ctx, data, training=False):
        pos = ctx["dilated_pos"]
        masks = ctx["dilated_mask"]
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
                inp = []
                for inp_scale in range(len(ans_convs[-1])):
                    f = torch.relu(ans_convs[-1][inp_scale])
                    ext = filter_extent[max(inp_scale, scale)]
                    f = torch.where(masks[inp_scale][:, None], f, 0.0)
                    nl = self._pair_neighbors(
                        ctx, inp_scale, scale, ext / 2.0,
                        ignore_query=self.ignore_query_points
                        and scale == inp_scale)
                    conv = self.convs[layer][scale][inp_scale]
                    cached = (isinstance(nl, NeighborList)
                              and self.caches_taps(nl))
                    ans_conv = conv(f * importance, pos[inp_scale],
                                    pos[scale], ext, nl, n_chunk=nck,
                                    cached_taps=cached)
                    if scale == inp_scale:
                        ans_conv = ans_conv + self.denses[layer][scale](f)
                        if ans_conv.shape[-1] == \
                                ans_convs[-1][scale].shape[-1]:
                            ans_conv = ans_conv + ans_convs[-1][scale]
                    inp.append(ans_conv)
                if self.add_merge:
                    merged = inp[0]
                    for t in inp[1:]:
                        merged = merged + t
                else:
                    merged = torch.cat(inp, dim=-1)
                ans.append(merged)
            ans_convs.append(ans)
        return _act(self.out_activation)(ans_convs[-1][0])
