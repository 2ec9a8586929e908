"""Weight bridge from the JAX package's flax param tree to the port.

The port's modules carry the flax module paths as their PyTorch names
(HRNet/SymNet ``conv{i}{j}{k}_{l}.kernel``, ``dense{i}{j}{k}_{l}.Dense_0
.kernel`` — extra per-scale convs k >= 1, the cross-scale denses of the
farthest-point pyramid —, ``sym_conv0.kernel`` — the half kernel, or the
radial stack of a circular kernel; ``adv_conv0`` and ``adv_dense0`` of
the pre-advection branch; ``scale`` of the equivariant output; CConv
``conv{i}.kernel`` and ``dense{i}.Dense_0.kernel``; PointNet
``dense{i}.Dense_0.kernel``), and create a parameter exactly where flax
does (not for a module flax declares and never calls, such as the
reference's ``rot``, ``adv_conv1`` and ``adv_dense1``), so the bridge is
a path flattening and the state dict loads strictly.  The tree
arrives as nested dicts of numpy arrays, so the port never imports flax.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch


def params_from_flax(tree) -> "OrderedDict[str, torch.Tensor]":
    """Flax param tree (``{"params": {...}}`` or the inner dict; nested
    dicts of arrays) -> a state dict for ``module.load_state_dict``."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    out = OrderedDict()

    def walk(node, prefix):
        for name in sorted(node):
            value = node[name]
            path = f"{prefix}.{name}" if prefix else name
            if isinstance(value, dict):
                walk(value, path)
            else:
                out[path] = torch.from_numpy(
                    np.array(value, dtype=np.float32, copy=True))

    walk(tree, "")
    return out
