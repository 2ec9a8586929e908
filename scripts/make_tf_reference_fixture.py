"""Write the reference-checkpoint and dataset-file fixtures of the port's
checkpoint and loader tests and of ``chip_smoke.py`` phase 23:

    python -m scripts.make_tf_reference_fixture

* ``tests/data/tf_ckpt_liquid3d/ckpt.{index,data-00000-of-00001}``: a
  ``tf.train.Checkpoint(model=..., step=...)`` written by TensorFlow,
  its objects nested so that the variable keys take the layout of the
  reference's pretrained bundles (``dmcf_tpu/utils/tf_ckpt.py``, module
  docstring): ``model/fluid_convs/...``, ``model/_all_convs/{n}/1/...``,
  ``model/denses/{i-1}/{j}/{k}/{l}/...``, ``model/sym_convs/{n}/...``.
  The weights are the JAX package's init of ``configs/Liquid3d.yml``'s
  SymNet at ``PRNGKey(0)`` (with ``tests/test_tf_ckpt.py``'s sample), at
  full width: a checkpoint in the reference's format, not the reference's
  trained weights.  The JAX package's own
  ``load_tf_reference_checkpoint(..., strict=True)`` must consume it
  whole and give those weights back; the script checks both.
* ``tests/data/liquid_block.msgpack.zst``: frame 0 of ``chip_smoke.py``
  phase 16's scene (``liquid_scene``: the 22 x 6 x 22 block, 2,904 fluid
  and 1,220 boundary rows, zero velocity) as a one-frame scene file,
  written by the port's ``write_msgpack_zst``.
* ``tests/data/fixtures.json``: the bundle's tensor count and the sum of
  |w| over them (``math.fsum`` in float64, so no order enters), both
  taken with ``tf.train.load_checkpoint``, the same over the ``model/``
  variables alone, and the sha256 of each array of the scene.

Imports TensorFlow and JAX: this script is no part of the port.
``write_reference_checkpoint`` is also what the port's tests use to
write small bundles.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
CKPT = os.path.join(DATA, "tf_ckpt_liquid3d", "ckpt")
SCENE = os.path.join(DATA, "liquid_block.msgpack.zst")
FIXTURES = os.path.join(DATA, "fixtures.json")
VV = "/.ATTRIBUTES/VARIABLE_VALUE"


def reference_layout(names, layer_channels, use_pre_adv=False):
    """Each flax module name -> the object paths it takes in a reference
    bundle (the first is where TensorFlow stores its variables, the
    shortest path; the others alias the same object, as the reference's
    ``_all_convs`` list does)."""
    from dmcf_tpu.utils.tf_ckpt import _reference_conv_order

    order = _reference_conv_order(layer_channels, use_pre_adv)
    out = {}
    for name in names:
        if name == "fluid_obs":
            out[name] = [("fluid_convs",), ("_all_convs", 0, 1)]
        elif name == "obs_conv":
            out[name] = [("obs_convs",), ("_all_convs", 1, 1)]
        elif name in ("fluid_dense", "obs_dense"):
            out[name] = [(name,)]
        elif name.startswith("sym_conv"):
            n = int(name[len("sym_conv"):])
            out[name] = [("sym_convs", n), ("_all_convs", len(order) + n, 1)]
        elif name.startswith("adv_conv"):
            n = int(name[len("adv_conv"):])
            out[name] = [("adv_convs", n), ("_all_convs", 2 + n, 1)]
        elif name.startswith("adv_dense"):
            out[name] = [("adv_dense", int(name[len("adv_dense"):]))]
        elif name.startswith("conv"):
            out[name] = [("_all_convs", order.index(name), 1)]
        elif name.startswith("dense"):
            digits, l = name[len("dense"):].split("_")
            out[name] = [("denses", int(digits[0]) - 1, int(digits[1]),
                          int(digits[2:]), int(l))]
        else:
            raise ValueError(f"no reference layout for module {name}")
    return out


def write_reference_checkpoint(prefix, params, layer_channels,
                               use_pre_adv=False, step=0):
    """Write the flax tree ``params`` (``{"params": {...}}`` of numpy
    arrays) as a ``tf.train.Checkpoint(model=..., step=...)`` in the
    reference's variable layout (``reference_layout``).  Returns the
    prefix written."""
    import tensorflow as tf

    params = params.get("params", params)
    objs = {}

    def leaves(tree):          # the Dense_0 level is not stored
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from (leaves(v) if k.startswith("Dense_") else
                            ((f"{k}/{n}", x) for n, x in leaves(v)))
            else:
                yield k, v

    for name, tree in params.items():
        mod = tf.Module()
        for leaf, value in leaves(tree):
            if "/" in leaf:
                raise ValueError(f"{name}: nested leaf {leaf}")
            setattr(mod, leaf, tf.Variable(np.asarray(value), name=leaf))
        objs[name] = mod

    # a tree of python dicts keyed by path components, lists made below
    tree = {}
    for name, paths in reference_layout(list(params), layer_channels,
                                        use_pre_adv).items():
        for path in paths:
            node = tree
            for part in path[:-1]:
                node = node.setdefault(part, {})
            node[path[-1]] = objs[name]

    def build(node):
        if isinstance(node, tf.Module):
            return node
        if all(isinstance(k, int) for k in node):
            # list positions the reference fills with objects that hold
            # no variables (the first element of each _all_convs entry,
            # the convs flax never creates) get an empty module
            return [build(node[i]) if i in node else tf.Module()
                    for i in range(max(node) + 1)]
        mod = tf.Module()
        for k in sorted(node):
            setattr(mod, k, build(node[k]))
        return mod

    model = build(tree)
    ckpt = tf.train.Checkpoint(model=model,
                               step=tf.Variable(step, dtype=tf.int64))
    return ckpt.write(prefix)


def bundle_stats(prefix):
    """(tensors, sum |w|) over all non-string tensors and over the
    ``model/`` variables, read with TensorFlow."""
    import tensorflow as tf

    rd = tf.train.load_checkpoint(prefix)
    dtypes = rd.get_variable_to_dtype_map()
    keys = sorted(k for k in dtypes if dtypes[k] != tf.string)
    sums = {k: math.fsum(np.abs(np.asarray(rd.get_tensor(k),
                                           np.float64)).ravel())
            for k in keys}
    model = [k for k in keys if k.startswith("model/") and k.endswith(VV)]
    return {"tensors": len(keys), "abs_sum": math.fsum(sums.values()),
            "model_tensors": len(model),
            "model_abs_sum": math.fsum(sums[k] for k in model)}


def sha256(arr):
    arr = np.ascontiguousarray(arr)
    return hashlib.sha256(arr.tobytes()).hexdigest()


def liquid3d_init():
    """configs/Liquid3d.yml's JAX SymNet and its PRNGKey(0) init on
    tests/test_tf_ckpt.py's sample (numpy tree)."""
    import jax
    import yaml

    from dmcf_tpu.models import build_model

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from test_tf_ckpt import _sample

    with open(os.path.join(ROOT, "configs", "Liquid3d.yml")) as f:
        cfg = yaml.safe_load(f)["model"]
    model = build_model(cfg)
    params = jax.jit(lambda k, s: model.init(k, s, training=False))(
        jax.random.PRNGKey(0), _sample())
    return model, jax.tree.map(np.asarray, params)


def main():
    import jax
    jax.config.update("jax_platforms", "cpu")

    from dmcf_tpu.utils.tf_ckpt import load_tf_reference_checkpoint

    sys.path.insert(0, ROOT)
    from chip_smoke import liquid_scene
    from dmcf_tpu_torch.data import write_msgpack_zst

    model, params = liquid3d_init()
    os.makedirs(os.path.dirname(CKPT), exist_ok=True)
    write_reference_checkpoint(CKPT, params, model.layer_channels,
                               model.use_pre_adv)
    zeros = jax.tree.map(np.zeros_like, params)
    back = load_tf_reference_checkpoint(CKPT, zeros, model.layer_channels,
                                        use_pre_adv=model.use_pre_adv,
                                        strict=True)
    same = jax.tree.map(lambda a, b: bool(np.array_equal(a, b)), params,
                        back)
    assert all(jax.tree.leaves(same)), "JAX loader does not return init"
    stats = bundle_stats(CKPT)

    pos, box, nrm = liquid_scene()
    frame = {"pos": pos, "vel": np.zeros_like(pos), "box": box,
             "box_normals": nrm, "frame_id": 0, "scene_id": "liquid_block"}
    write_msgpack_zst(SCENE, [frame])
    fixtures = {
        "tf_ckpt_liquid3d": dict(stats, prefix="tests/data/tf_ckpt_liquid3d"
                                 "/ckpt", weights="dmcf_tpu Liquid3d SymNet"
                                 " init at PRNGKey(0), not trained"),
        "liquid_block": {
            "path": "tests/data/liquid_block.msgpack.zst",
            "n_fluid": int(len(pos)), "n_boundary": int(len(box)),
            "sha256": {k: sha256(frame[k]) for k in
                       ("pos", "vel", "box", "box_normals")}},
    }
    with open(FIXTURES, "w") as f:
        json.dump(fixtures, f, indent=1, sort_keys=True)
        f.write("\n")
    print(json.dumps(fixtures, indent=1, sort_keys=True))
    for p in sorted(os.listdir(os.path.dirname(CKPT))) + [SCENE]:
        full = os.path.join(os.path.dirname(CKPT), p)
        print(p, os.path.getsize(full if os.path.exists(full) else p))


if __name__ == "__main__":
    main()
