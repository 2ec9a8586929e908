"""SymNet: HRNet trunk + antisymmetric continuous-conv (ASCC) output stack
(port of dmcf_tpu/models/symnet.py).

The trunk's finest-scale output passes through antisymmetric convs over
all particles at the finest radius (coincident points dropped), giving a
position correction whose pairwise exchanges cancel; they run fp32
("highest") whatever the trunk's ``precision``, as in the reference
(``symnet.py:43-46``).
"""

from __future__ import annotations

import torch

from .hrnet import HRNet, _act
from .pbf import drop_coincident


class SymNet(HRNet):
    # ``layer_channels`` here is already the trunk and ``sym_channels`` the
    # ASCC stack: build_model performs the reference's split
    defaults = dict(HRNet.defaults, sym_kernel_size=(6, 6, 6),
                    window_sym=None, sym_channels=(3,))

    def setup_net(self):
        super().setup_net()
        self.sym_convs = []
        cin = self.out_channels
        for i, ch in enumerate(self.sym_channels):
            self.sym_convs.append(self.make_cconv(
                f"sym_conv{i}", cin, ch, use_bias=False, symmetric=True,
                kernel_size=self.sym_kernel_size,
                window_func=self.window_sym, sym_axis=self.sym_axis,
                precision="highest"))
            cin = ch

    def net_forward(self, ctx, data, training=False):
        return self.ascc(HRNet.net_forward(self, ctx, data,
                                           training=training), ctx)

    def ascc(self, ans, ctx):
        """The ASCC output stack on the trunk's finest-scale output."""
        all_pos = ctx["all_pos"]
        all_mask = ctx["all_mask"]
        ext = ctx["filter_extent"][0]
        nl = drop_coincident(ctx["nl_all0"])
        for conv in self.sym_convs:
            ans = torch.where(all_mask[:, None], torch.relu(ans), 0.0)
            ans = conv(ans * self.part_scale, all_pos, all_pos, ext, nl)
        return _act(self.out_activation)(ans)
