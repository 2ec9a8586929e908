"""The port's model options against the JAX reference, on the CPU: density
and pressure features, ``dens_norm``, ``use_feats``, the pre-advection
branch, the equivariant output, circular kernels, extra per-scale convs,
the farthest-point pyramid (``voxel_size: None``), a first stride of 2
and ``transpose_search_reuse`` (their ops: ``test_torch_option_ops.py``).

Each model case builds a narrow 2D model (kernel [1, 4, 4], widths <= 8)
in both packages at ``precision: highest``, carries the flax weights
across (``interop.params_from_flax``, strictly: the port has exactly
JAX's parameters) and runs one step on a 100-particle fluid block over a
floor.  Tolerances: the position correction within 1e-5 of its max
(fp32 sums in other orders through ~10 convs; measured gaps are stated
at ``test_option_step_matches_jax``), positions within 1e-6, integer aux
(overflow, scale counts) exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmcf_tpu.models import build_model as jax_build_model
from dmcf_tpu.ops import sph as jsph
from dmcf_tpu_torch.interop import params_from_flax
from dmcf_tpu_torch.models import build_model

# two intra-op threads: the suite runs files side by side on a few cores
torch.set_num_threads(2)

T = torch.from_numpy

BASE = {
    "name": "HRNet",
    "layer_channels": [[[8]], [[8], [4]], [[2]]],
    "kernel_size": [1, 4, 4],
    "window": "poly6",
    "window_dens": "poly6",
    "strides": [1, 2],
    "particle_radii": [0.05, 0.1],
    "voxel_size": [0.025, 0.025, 0.0],
    "timestep": 0.0025,
    "out_scale": [1e-4, 1e-4, 0.0],
    "add_merge": True,
    "neighbor_k": 40,
    "precision": "highest",
}

OPTIONS = {
    "dens_pres_feats": dict(dens_feats=True, pres_feats=True, rest_dens=6.0,
                            stiffness=10.0),
    "dens_norm": dict(dens_norm=True, dens_radius=[0.06, 0.1]),
    "use_feats": dict(use_feats=True),
    "use_pre_adv": dict(use_pre_adv=True),
    "equivar_hrnet": dict(equivar=True),
    "equivar_pointnet": dict(name="PointNet", layer_channels=[8, 8, 3],
                             equivar=True, out_scale=[1e-4, 1e-4, 1e-4]),
    "circular_hrnet": dict(circular=True),
    "circular_symnet": dict(name="SymNet", circular=True,
                            sym_kernel_size=[1, 4, 4], sym_axis=1,
                            layer_channels=[[[8]], [[8], [4]], [[8]],
                                            [[3]]]),
    "extra_conv": dict(layer_channels=[[[8]], [[8, 8], [4, 4]], [[2]]]),
    "fps_pyramid": dict(voxel_size=None, scale_size_factor=[1.0, 0.5]),
    "stride0_2": dict(strides=[2, 4]),
    "transpose_search_reuse": dict(transpose_search_reuse=True),
}


def make_sample(seed=0):
    """A 10 x 10 fluid block at spacing 0.025 (noise 1e-3) resting 0.02
    above a 48-point floor, padded to 112 fluid and 56 boundary rows.  The
    floor's spacing (0.0131) puts no pair at a search radius: where a
    distance equals the radius, jitted JAX (which fuses the search's
    expansion into multiply-adds) and eager JAX disagree on membership."""
    rng = np.random.RandomState(seed)
    g = np.stack(np.meshgrid(np.arange(10), np.arange(10), indexing="ij"),
                 -1).reshape(-1, 2) * 0.025
    pos = np.zeros((112, 3), np.float32)
    pos[:100, :2] = g - 0.1 + rng.normal(scale=1e-3, size=g.shape)
    vel = np.zeros((112, 3), np.float32)
    vel[:100, :2] = rng.randn(100, 2) * 0.05
    box = np.zeros((56, 3), np.float32)
    box[:48, 0] = np.arange(48) * 0.0131 - 0.3
    box[:48, 1] = -0.1213
    nrm = np.zeros((56, 3), np.float32)
    nrm[:48, 1] = 1.0
    fm, bm = np.arange(112) < 100, np.arange(56) < 48
    grav = np.zeros((112, 3), np.float32)
    grav[:, 1] = -9.81
    return {"pos": np.array(jsph.masked_positions(jnp.asarray(pos),
                                                  jnp.asarray(fm))),
            "vel": vel, "grav": grav, "box": box, "box_normals": nrm,
            "fluid_mask": fm, "box_mask": bm,
            "feats": rng.randn(112, 2).astype(np.float32)}


def both(cfg, sample, precision="highest"):
    """The JAX model, a flax param tree of its shapes (``eval_shape`` of
    its init: no compile) filled from a seeded generator, the sample as
    JAX arrays, and the port's model with those weights, loaded
    strictly."""
    cfg = dict(cfg, precision=precision)
    jmodel = jax_build_model(cfg)
    js = {k: jnp.asarray(v) for k, v in sample.items()}
    shapes = jax.eval_shape(
        lambda key, s: jmodel.init(key, s, training=True),
        jax.random.PRNGKey(0), js)
    rng = np.random.RandomState(0)
    params = jax.tree.map(lambda a: rng.uniform(
        -0.3, 0.3, a.shape).astype(np.float32), shapes)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_flax(params))
    return jmodel, params, js, model


def check_step(jout, tout, tol=1e-5):
    (jp, jv, jaux), (tp, tv, taux) = jout, tout
    want = np.asarray(jaux["pos_correction"])
    scale = np.abs(want).max()
    assert scale > 0
    err = np.abs(taux["pos_correction"].detach().numpy() - want).max()
    assert err <= tol * scale, (err, scale)
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp),
                               atol=1e-6)
    for k in ("neighbor_overflow", "scale_counts"):
        np.testing.assert_array_equal(taux[k].numpy(), np.asarray(jaux[k]),
                                      err_msg=k)
    if "pair_overflow" in jaux:
        assert int(taux["pair_overflow"]) == int(jaux["pair_overflow"])
        assert set(taux["pair_overflow_detail"]) == set(
            jaux["pair_overflow_detail"])
    return err / scale


@pytest.fixture(scope="module")
def sample():
    return make_sample()


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_option_step_matches_jax(option, sample):
    """One step with the option on, JAX's weights in the port (measured
    gaps 3.3e-7 to 2.3e-6 of the correction's max, dens_norm the largest),
    then one train step of the port."""
    cfg = dict(BASE, **OPTIONS[option])
    jmodel, params, js, model = both(cfg, sample)
    jout = jax.jit(lambda p, s: jmodel.apply(p, s, training=True))(
        params, js)
    with torch.no_grad():
        tout = model({k: T(v) for k, v in sample.items()}, training=True)
    check_step(jout, tout)
    names = {n.split(".")[0] for n, _ in model.named_parameters()}
    if option == "use_pre_adv":
        assert "adv_conv0" in names and "adv_dense0" in names
    if option.startswith("equivar"):
        assert "scale" in names
    if option == "extra_conv":
        assert {"conv101_0", "dense101_0", "conv111_0"} <= names
    if option == "fps_pyramid":
        # the cross-scale denses the index transitions call
        assert {"dense110_0", "dense200_1"} <= names
    train_step(model, sample)


@pytest.mark.parametrize("name", ["HRNet", "PointNet"])
def test_use_feats_width_from_first_sample(name, sample):
    """``use_feats`` names no width: the first forward sizes the
    fluid-input layers from its sample's feats (as flax's init does), in
    place, so an optimizer made before holds the resized kernels; a state
    dict gives a fresh model its width; another width then raises."""
    cfg = dict(BASE, name=name, use_feats=True)
    if name == "PointNet":
        cfg.update(layer_channels=[8, 8, 3], out_scale=[1e-4, 1e-4, 1e-4])
    model = build_model(cfg, device="cpu")
    kernels = [layer.get_parameter(k) for _, layer in
               model._fluid_input_layers()
               for k, _ in layer.named_parameters() if k.endswith("kernel")]
    opt = torch.optim.Adam(model.parameters())
    s = {k: T(v) for k, v in sample.items()}
    with torch.no_grad():
        out = model(s)
    assert [k.shape[-2] for k in kernels] == [model.fluid_in + 2] * 2 \
        if name == "HRNet" else [model.fluid_in + 2]
    held = {id(p) for g in opt.param_groups for p in g["params"]}
    assert all(id(k) in held for k in kernels)
    fresh = build_model(cfg, device="cpu")
    fresh.load_state_dict(model.state_dict())
    with torch.no_grad():
        again = fresh(s)
    torch.testing.assert_close(again[2]["pos_correction"],
                               out[2]["pos_correction"], rtol=0, atol=0)
    with pytest.raises(ValueError, match="feats have 1 channels"):
        fresh(dict(s, feats=s["feats"][:, :1]))


def train_step(model, sample, window=2):
    """One train step of the port (batch 1, ``window`` steps, targets off
    the model's own rollout): a finite loss, finite gradients, most of
    them non-zero."""
    from dmcf_tpu_torch.models.losses import get_loss
    from dmcf_tpu_torch.pipelines.simulator import (make_optimizer,
                                                    make_train_step)
    rng = np.random.RandomState(1)
    n = sample["pos"].shape[0]
    pos = sample["pos"] + np.concatenate([np.zeros((1, n, 3)), rng.normal(
        scale=1e-3, size=(window, n, 3))]).astype(np.float32) \
        * sample["fluid_mask"][:, None]
    batch = {"pos": T(pos[None]),
             "vel": T(np.repeat(sample["vel"][None], window + 1, 0)[None]),
             "pre": torch.zeros(1, dtype=torch.int32)}
    for k in ("box", "box_normals", "fluid_mask", "box_mask", "feats"):
        batch[k] = T(sample[k][None])
    loss = {"mse": get_loss("weighted_mse", fac=1000.0, gamma=0.5,
                            neighbor_scale=0.0625)}
    step = make_train_step(model, loss, *make_optimizer(
        model, {"lr_boundaries": [], "lr_values": [1e-3]}), window=window)
    lvec, _, _ = step(batch, np.ones(window, np.float32))
    assert torch.isfinite(lvec).all()
    grads = [p.grad for p in model.parameters()]
    assert all(torch.isfinite(g).all() for g in grads)
    assert sum(bool((g != 0).any()) for g in grads) >= len(grads) // 2
