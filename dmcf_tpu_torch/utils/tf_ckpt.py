"""Reference TensorFlow checkpoints into the port's state dict (the port
of dmcf_tpu/utils/tf_ckpt.py).

The reference (DMCF, tum-pbs) ships pretrained ``tf.train.Checkpoint``
bundles of ``(step, optimizer, model)``.  Their conventions are the
port's: conv kernels ``[kz, ky, kx, Cin, Cout]``, the symmetric half
kernel expanded at call time, Dense kernels ``[in, out]``; so a variable
goes to a parameter by name alone.  Variable layout of those bundles:

* ``model/fluid_convs/{kernel,bias}``    -> ``fluid_obs``
* ``model/obs_convs/{kernel,bias}``      -> ``obs_conv``
* ``model/{fluid,obs}_dense/...``        -> ``{fluid,obs}_dense``
* ``model/_all_convs/{n}/1/...``         -> trunk convs in creation order
  (index 0/1 are the fluid/obs convs, stored under their attribute names,
  so the trunk starts at n=2; after ``adv_conv{0,1}`` with
  ``use_pre_adv``)
* ``model/denses/{i-1}/{j}/{k}/{l}/...`` -> ``dense{i}{j}{k}_{l}``
* ``model/sym_convs/{n}/kernel``         -> ``sym_conv{n}`` (half kernel)
* ``model/adv_convs/...``, ``model/adv_dense/...`` with ``use_pre_adv``

The port's parameter names are the flax module paths joined by ``.``
(``interop.py``): a key's first component is the module, the rest its
leaf, with the ``Dense_0`` level skipped as the checkpoint has none.  The
bundle is read by ``tf_bundle`` (numpy and ``struct``; no TensorFlow).
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from .tf_bundle import load_checkpoint

_VV = "/.ATTRIBUTES/VARIABLE_VALUE"


def _reference_conv_order(layer_channels, use_pre_adv=False):
    """Replicate the reference's ``_all_convs`` append order
    (models/pbf_model.py:132-161 then hrnet.py:39-62): returns our module
    name per ``_all_convs`` index."""
    order = ["fluid_obs", "obs_conv"]
    if use_pre_adv:
        order += ["adv_conv0", "adv_conv1"]
    lc = layer_channels
    for i in range(1, len(lc)):
        for j in range(len(lc[i])):
            for k in range(len(lc[i][j])):
                n_inp = len(lc[i - 1]) if k == 0 else 1
                for l in range(n_inp):
                    order.append(f"conv{i}{j}{k}_{l}")
    return order


def _leaf(parts):
    """The checkpoint-style leaf of a parameter path below its module
    (``Dense_*`` levels skipped, as ``_flatten_module`` skips them)."""
    return "/".join(p for p in parts if not p.startswith("Dense_"))


def load_tf_reference_checkpoint(ckpt_path, model, strict=True):
    """Read a reference TF checkpoint into a state dict for ``model``.

    Args:
      ckpt_path: checkpoint prefix (e.g. ``.../checkpoints/Liquid3d/ckpt``).
      model: the port's model (SymNet / PBFNet); its ``state_dict()`` is
        the template (names, shapes, dtypes), its ``layer_channels`` (the
        trunk's, after the SymNet split) and ``use_pre_adv`` give the
        reference's conv creation order.
      strict: require every model variable in the checkpoint to be
        consumed and every module to be assigned.

    Returns:
      An ordered state dict (CPU tensors) for
      ``model.load_state_dict(..., strict=True)``.  A module that is not
      converted (``strict=False``) keeps the template's values.
    """
    rd = load_checkpoint(ckpt_path)
    shape_map = rd.get_variable_to_shape_map()
    model_vars = {k[len("model/"):-len(_VV)]
                  for k in shape_map
                  if k.startswith("model/") and k.endswith(_VV)
                  and ".OPTIMIZER_SLOT" not in k}

    conv_order = _reference_conv_order(model.layer_channels,
                                       bool(model.use_pre_adv))

    def ckpt_prefixes(name):
        """Candidate checkpoint prefixes for one of our module names."""
        cands = []
        if name == "fluid_obs":
            cands = ["fluid_convs", "_all_convs/0/1"]
        elif name == "obs_conv":
            cands = ["obs_convs", "_all_convs/1/1"]
        elif name in ("fluid_dense", "obs_dense"):
            cands = [name]
        elif name.startswith("sym_conv"):
            n = int(name[len("sym_conv"):])
            cands = [f"sym_convs/{n}",
                     f"_all_convs/{len(conv_order) + n}/1"]
        elif name.startswith("adv_conv"):
            n = int(name[len("adv_conv"):])
            cands = [f"adv_convs/{n}", f"_all_convs/{2 + n}/1"]
        elif name.startswith("adv_dense"):
            n = int(name[len("adv_dense"):])
            cands = [f"adv_dense/{n}"]
        elif name.startswith("conv"):
            idx = conv_order.index(name)
            cands = [f"_all_convs/{idx}/1"]
        elif name.startswith("dense"):
            digits, l = name[len("dense"):].split("_")
            i, j, k = int(digits[0]), int(digits[1]), int(digits[2:])
            cands = [f"denses/{i - 1}/{j}/{k}/{l}"]
        elif name in ("scale", "rot"):  # equivar heads
            cands = [f"{name}_dens", name]
        return cands

    def fetch(prefix, leaf):
        if f"{prefix}/{leaf}" in model_vars:
            model_vars.discard(f"{prefix}/{leaf}")
            return rd.get_tensor(f"model/{prefix}/{leaf}{_VV}")
        return None

    template = model.state_dict()
    modules = OrderedDict()                 # module -> [(leaf, key)]
    for key in template:
        parts = key.split(".")
        modules.setdefault(parts[0], []).append((_leaf(parts[1:]), key))

    out = OrderedDict((k, v.detach().cpu().clone())
                      for k, v in template.items())
    missing = []
    for name, leaves in modules.items():
        got = {}
        for cand in ckpt_prefixes(name):
            hit = False
            for leaf, key in leaves:
                val = fetch(cand, leaf)
                if val is not None:
                    want = tuple(template[key].shape)
                    if want != tuple(val.shape):
                        raise ValueError(
                            f"{name}: checkpoint {cand}/{leaf} shape "
                            f"{tuple(val.shape)} != param shape {want}")
                    got[key] = torch.from_numpy(np.ascontiguousarray(
                        val.astype(np.float32))).to(template[key].dtype)
                    hit = True
            if hit:
                break
        if len(got) != len(leaves):
            missing.append(name)
            continue
        out.update(got)

    if strict and missing:
        raise ValueError(f"unconverted flax modules: {missing}")
    if strict and model_vars:
        raise ValueError(f"unconsumed checkpoint variables: "
                         f"{sorted(model_vars)}")
    return out
