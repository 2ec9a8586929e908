"""The port's baselines, CConv (2D and 3D) and PointNet, against the JAX
package's with bridged weights (``interop.params_from_flax``), on
generated scenes, on the CPU: one model step at ``precision: highest``
and at the default (the bf16 trunk), and one vector-Jacobian product of
the position correction in the parameters.

The shipped configs (``configs/other/cconv.yml``, ``cconv3d.yml``,
``pointnet.yml``) at narrower widths.  Tolerances, of each output's max
abs: the position correction 1e-5 at "highest" (fp32 sums in another
order through 3-4 layers; measured 3.4e-7-4.7e-7) and 2e-6 at the
default (measured 3.3e-7-4.2e-7: the port rounds where JAX rounds, and
JAX's K-list convs run over inline taps here, as the port's do);
positions 1e-6; parameter gradients 1e-4 of each tensor's max at
"highest"; integer aux exactly.  The default must also lie far from
"highest": CConv's bf16 trunk moves the correction by 1.7e-3-2.0e-3 of
its max (measured), so a port that ran fp32 at the default would fail.
PointNet has no precision knob in either package (dense layers and a
pooling sum in fp32): its two outputs are one.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from dmcf_tpu.models import build_model as jax_build_model
from dmcf_tpu_torch.interop import params_from_flax
from dmcf_tpu_torch.models import build_model
from dmcf_tpu_torch.scene import bench_sample, build_scene

# two intra-op threads: the suite runs files side by side on a few cores
torch.set_num_threads(2)

CONFIG_DIR = os.path.join(os.path.dirname(__file__), "..", "configs")
TOL = {"highest": 1e-5, "default": 2e-6}


def model_cfg(name, **override):
    with open(os.path.join(CONFIG_DIR, "other", name)) as f:
        cfg = yaml.safe_load(f)["model"]
    cfg.update(override)
    return cfg


def block_3d(side=5, spacing=0.05):
    """A ``side``^3 block of fluid at ``spacing`` resting one spacing above
    a floor of boundary particles, with a little noise (seeded)."""
    rng = np.random.RandomState(3)
    g = np.arange(side, dtype=np.float32) * spacing
    pos = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    pos = pos + rng.normal(scale=spacing * 0.01, size=pos.shape)
    f = np.arange(-1, side + 1, dtype=np.float32) * spacing
    fx, fz = np.meshgrid(f, f, indexing="ij")
    box = np.stack([fx.ravel(), np.full(fx.size, -spacing), fz.ravel()], -1)
    nrm = np.zeros_like(box)
    nrm[:, 1] = 1.0
    return pos.astype(np.float32), box.astype(np.float32), nrm


CASES = {
    "cconv2d": (lambda: model_cfg("cconv.yml", layer_channels=[8, 16, 16, 3]),
                lambda: build_scene(200)),
    "cconv3d": (lambda: model_cfg("cconv3d.yml",
                                  layer_channels=[8, 16, 16, 3]),
                block_3d),
    # its pooling has no window, so neighbours exactly at its radius (0.01)
    # would count or not by rounding: a spacing off the radius
    "pointnet": (lambda: model_cfg("pointnet.yml",
                                   layer_channels=[16, 32, 32, 3]),
                 lambda: build_scene(200, spacing=0.008)),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def bridged(request):
    make_cfg, make_scene = CASES[request.param]
    base = make_cfg()
    pos, box, nrm = make_scene()
    if request.param != "cconv3d":
        pos[:, :2] -= 0.043  # the block's lowest rows near the floor
    grav = -9.81
    sample = bench_sample(pos, box, nrm, grav=grav, device="cpu")
    jsample = {k: jnp.asarray(v.numpy()) for k, v in sample.items()}
    out = {"name": request.param, "sample": sample, "jsample": jsample}
    for prec in ("highest", "default"):
        cfg = dict(base, precision=prec)
        jmodel = jax_build_model(cfg)
        if prec == "highest":
            params = jax.jit(lambda key, s: jmodel.init(
                key, s, training=False))(jax.random.PRNGKey(0), jsample)
            params = jax.tree.map(np.asarray, params)
            out["params"] = params
        model = build_model(cfg, device="cpu")
        model.load_state_dict(params_from_flax(out["params"]))
        out[prec] = (jmodel, model)
    return out


@pytest.mark.parametrize("prec", ["highest", "default"])
def test_one_step_matches_jax(bridged, prec):
    jmodel, model = bridged[prec]
    jp, _, jaux = jax.jit(lambda p, s: jmodel.apply(p, s, training=False))(
        bridged["params"], bridged["jsample"])
    with torch.no_grad():
        tp, tv, taux = model(bridged["sample"])
    pc_j = np.asarray(jaux["pos_correction"])
    scale = np.abs(pc_j).max()
    assert scale > 0
    np.testing.assert_allclose(taux["pos_correction"].numpy(), pc_j,
                               atol=TOL[prec] * scale)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-6)
    for k in jaux:
        if k in ("pos_correction", "pair_overflow_detail"):
            continue
        np.testing.assert_array_equal(taux[k].numpy(), np.asarray(jaux[k]),
                                      err_msg=k)
    assert bool(torch.isfinite(tv).all())
    if prec == "default":
        # the bf16 trunk ran: its correction is not the fp32 one
        with torch.no_grad():
            hi = bridged["highest"][1](bridged["sample"])[2][
                "pos_correction"]
        gap = float((taux["pos_correction"] - hi).abs().max()) / scale
        if bridged["name"] == "pointnet":
            assert gap == 0.0
        else:
            assert gap > 1e-3, gap
    # every fluid particle sees neighbours: the convs and pools act
    fm = bridged["sample"]["fluid_mask"]
    assert float(taux["num_fluid_neighbors"][fm].min()) >= 1


def test_parameter_vjp_matches_jax(bridged):
    jmodel, model = bridged["highest"]
    sample = bridged["sample"]
    n = sample["pos"].shape[0]
    ct = np.random.RandomState(5).randn(n, 3).astype(np.float32)

    def jloss(p):
        _, _, aux = jmodel.apply(p, bridged["jsample"], training=False)
        return jnp.sum(aux["pos_correction"] * ct)

    jgrads = jax.jit(jax.grad(jloss))(bridged["params"])
    flat = params_from_flax(jax.tree.map(np.asarray, jgrads))
    model.zero_grad()
    _, _, aux = model(sample)
    (aux["pos_correction"] * torch.from_numpy(ct)).sum().backward()
    named = dict(model.named_parameters())
    assert set(named) == set(flat)
    moved = 0
    for k, want in flat.items():
        got = named[k].grad
        got = torch.zeros_like(want) if got is None else got
        scale = float(want.abs().max())
        moved += scale > 0
        np.testing.assert_allclose(got.numpy(), want.numpy(),
                                   atol=1e-4 * scale + 1e-12, err_msg=k)
    assert moved >= len(flat) // 2


def test_cconv_uses_fluid_only_lists_without_boundary_pyramid():
    cfg = model_cfg("cconv.yml", layer_channels=[4, 8, 8, 3],
                    precision="highest")
    model = build_model(cfg, device="cpu")
    pos, box, nrm = build_scene(64)
    sample = bench_sample(pos, box, nrm, device="cpu")
    with torch.no_grad():
        ctx = model.preprocess(model.transform(sample)[0])
    n_fluid = sample["pos"].shape[0]
    # use_bnds: False builds the pyramid over the fluid rows alone
    assert ctx["dilated_pos"][0].shape[0] == n_fluid
    assert ("all", "all", 0.025) in ctx["cache"]._cache
