"""PointNet baseline: dense layers with neighbourhood sum pooling (port of
dmcf_tpu/models/pointnet.py).

No conv pyramid and no scale-0 convs: per-point dense layers whose outputs
are sum-pooled over a fixed-radius search at ``particle_radii[0]`` (not
doubled), every block.  The dense layers see the fluid features; the
boundary rows are zero-padded, so boundary neighbours add zero, as the
reference's out-of-range gather does.  With ``equivar`` the output
becomes the equivariant displacement field (``sph.compute_transformed_dx``,
as in ``PBFNet``), not broadcast to 3D either.
"""

from __future__ import annotations

import torch

from ..ops.neighbors import all_rows
from .hrnet import _act
from .pbf import PBFNet


class PointNet(PBFNet):
    defaults = dict(PBFNet.defaults, layer_channels=(32, 64, 64, 3),
                    out_activation=None)

    def _use_scale0_convs(self):
        return False

    def _fluid_input_layers(self):
        return [("dense0", self.denses[0])]

    def setup_net(self):
        self.denses = []
        prev = self.fluid_in
        for i, ch in enumerate(self.layer_channels):
            self.denses.append(self.make_dense(prev, ch, name=f"dense{i}"))
            prev = ch
        self.out_channels = prev

    def net_forward(self, ctx, data, training=False):
        pos = ctx["dilated_pos"][0]
        mask = ctx["dilated_mask"][0]
        feats = ctx["feats"]
        n_all = pos.shape[0]
        if feats.shape[0] < n_all:
            feats = torch.nn.functional.pad(
                feats, (0, 0, 0, n_all - feats.shape[0]))

        nl = ctx["cache"].get("pn", "pn", self._radii[0], pos, mask, pos,
                              mask)
        ctx["nl_pointnet"] = nl

        ans = feats
        for dense in self.denses:
            f = torch.where(mask[:, None], torch.relu(ans), 0.0)
            d = torch.where(mask[:, None], dense(f), 0.0)
            pooled = all_rows(nl.rows, torch.where(
                nl.mask[..., None], d[nl.idx.long()], 0.0).sum(dim=1))
            ans = pooled + ans if pooled.shape[-1] == ans.shape[-1] \
                else pooled
        return _act(self.out_activation)(ans)

    def postprocess(self, out, ctx, data, vel_corr=None):
        """The reference's PointNet variant: neighbour counts from its own
        search, and a low-dimensional output is not broadcast to 3D.  The
        aux adds the pipeline's neighbour statistics (``avg_neighbors``,
        ``pair_overflow``, ``scale_caps``), which the reference's PointNet
        leaves out and its simulator then fails to find."""
        pos, vel = data["pos"], data["vel"]
        fluid_mask = data["fluid_mask"].bool()
        n_fluid = ctx["n_fluid"]
        nl = ctx["nl_pointnet"]
        num_fluid_neighbors = all_rows(nl.rows, nl.mask.sum(dim=1).to(
            torch.float32))[:n_fluid]
        if self.equivar:
            out = self.equivariant_output(out, ctx)
        out_scale = torch.tensor(self.out_scale, dtype=torch.float32,
                                 device=pos.device)
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
        stats = self.neighbor_stats(ctx, nl, all_mask)
        aux = {
            "num_fluid_neighbors": num_fluid_neighbors,
            "pos_correction": pos_correction,
            "neighbor_overflow": stats["neighbor_overflow"],
            "scale_counts": torch.stack([c.to(torch.int32)
                                         for c in ctx["dilated_count"]]),
            "avg_neighbors": stats["count_sum"]
            / torch.clamp(all_mask.sum(), min=1),
            "pair_overflow": stats["pair_overflow"],
            "pair_overflow_detail": stats["pair_overflow_detail"],
            "scale_caps": torch.tensor(ctx["dilated_caps"],
                                       dtype=torch.int32, device=pos.device),
        }
        return pos_out, vel_out, aux
