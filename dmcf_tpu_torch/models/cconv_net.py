"""CConv baseline: a single-scale continuous-conv residual stack (the
Ummenhofer & Koltun ICLR 2020 architecture; port of
dmcf_tpu/models/cconv_net.py).

Fluid-only queries over one fluid->fluid K-list search at the finest
radius (coincident points dropped with ``ignore_query_points``); each
layer adds a K-list conv (the hand-written kernel on CUDA) and a dense
layer, plus the input when the widths agree.
"""

from __future__ import annotations

import torch

from .hrnet import _act
from .pbf import PBFNet, drop_coincident


class CConv(PBFNet):
    defaults = dict(PBFNet.defaults, layer_channels=(32, 64, 64, 3),
                    out_activation=None)

    def setup_net(self):
        lc = self.layer_channels
        prev = self.scale0_channels
        self.convs, self.denses = [], []
        for i in range(1, len(lc)):
            self.convs.append(self.make_cconv(f"conv{i}", prev, lc[i],
                                              window_func=self.window))
            self.denses.append(self.make_dense(prev, lc[i],
                                               name=f"dense{i}"))
            prev = lc[i]
        self.out_channels = prev

    def net_forward(self, ctx, data, training=False):
        n_fluid = ctx["n_fluid"]
        pos = ctx["dilated_pos"][0][:n_fluid]
        mask = ctx["dilated_mask"][0][:n_fluid]
        feats = ctx["feats"][:n_fluid]
        ext = ctx["filter_extent"][0]

        nl = ctx["cache"].get("fluid_only", "fluid_only", ext / 2.0, pos,
                              mask, pos, mask)
        if self.ignore_query_points:
            nl = drop_coincident(nl, pos, pos)

        ans = feats
        for conv, dense in zip(self.convs, self.denses):
            f = torch.where(mask[:, None], torch.relu(ans), 0.0)
            out = conv(f, pos, pos, ext, nl) + dense(f)
            ans = out + ans if out.shape[-1] == ans.shape[-1] else out
        # postprocess takes the first n_fluid rows: the output is aligned
        return _act(self.out_activation)(ans)
