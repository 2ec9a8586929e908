"""The PyTorch port's SymNet step and rollout against the JAX reference
with bridged weights, on a narrow WaterRamps-shaped model (kernel [1,4,4],
channels <= 8, same 3-scale trunk, dense downsampling pairs, ASCC output)
over a 256-fluid bench scene moved so the fluid touches the boundary (the
boundary convs see real neighbors).  The JAX model is built with
``precision: highest`` (fp32 in both packages; the bf16 trunk of the
default precision is held in ``test_torch_precision.py``).

Tolerances: the position correction to 1e-5 of its own magnitude (fp32
contraction order through 27 convs); positions to 1e-6 (fp32 rounding of
|x| <= 0.5); velocities, a position difference over dt = 0.0025, to 1e-4;
integer aux (overflow counts, voxel counts) exactly.
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
from dmcf_tpu_torch.kernels.cconv_klist import (cconv_klist,
                                                cconv_klist_reference)
from dmcf_tpu_torch.models import build_model
from dmcf_tpu_torch.models.layers import ContinuousConv
from dmcf_tpu_torch.ops import cconv
from dmcf_tpu_torch.profile_step import record_launches
from dmcf_tpu_torch.rollout import rollout
from dmcf_tpu_torch.scene import bench_sample, build_scene

# two intra-op threads: the suite runs files side by side on a few cores
torch.set_num_threads(2)

CONFIG_DIR = os.path.join(os.path.dirname(__file__), "..", "configs")


def model_cfg(name):
    with open(os.path.join(CONFIG_DIR, name)) as f:
        return yaml.safe_load(f)["model"]


def narrow_cfg():
    cfg = model_cfg("WaterRamps.yml")
    cfg.update(kernel_size=[1, 4, 4], sym_kernel_size=[1, 4, 4],
               precision="highest", out_scale=[1e-2, 1e-2, 0.0],
               scale_size_factor=[1.0, 1.0, 0.5],
               layer_channels=[[[4]], [[8], [4], [4]], [[8], [4], [4]],
                               [[8], [4], [4]], [[8]], [[2]]])
    return cfg


@pytest.fixture(scope="module")
def bridged():
    cfg = narrow_cfg()
    pos, box, nrm = build_scene(256)
    pos[:, :2] -= 0.04  # lowest row 0.01 above the floor: within r0 = 0.02
    sample = bench_sample(pos, box, nrm, device="cpu")
    jsample = {k: jnp.asarray(v.numpy()) for k, v in sample.items()}
    jmodel = jax_build_model(cfg)
    params = jax.jit(lambda key, s: jmodel.init(key, s, training=False))(
        jax.random.PRNGKey(0), jsample)
    params = jax.tree.map(np.asarray, params)
    step = jax.jit(lambda p, s: jmodel.apply(p, s, training=False))
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_flax(params))
    return dict(cfg=cfg, sample=sample, jsample=jsample, params=params,
                step=step, model=model)


def test_params_from_flax_round_trip(bridged):
    params = bridged["params"]["params"]
    sd = bridged["model"].state_dict()
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            path = f"{prefix}.{k}" if prefix else k
            if isinstance(v, dict):
                walk(v, path)
            else:
                flat[path] = v

    walk(params, "")
    assert set(sd) == set(flat)
    for k, v in flat.items():
        assert sd[k].shape == v.shape, k
        np.testing.assert_array_equal(sd[k].numpy(), v)
    # the ASCC layer stores the half kernel (sym_axis 1), flax Dense [in, out]
    assert tuple(sd["sym_conv0.kernel"].shape) == (1, 2, 4, 8, 2)
    assert tuple(sd["dense100_0.Dense_0.kernel"].shape) == (12, 8)


def _check_step(jout, tout):
    jp, jv, jaux = jout
    tp, tv, taux = tout
    pc_j = np.asarray(jaux["pos_correction"])
    pc_t = taux["pos_correction"].numpy()
    scale = np.abs(pc_j).max()
    assert scale > 0
    np.testing.assert_allclose(pc_t, pc_j, atol=1e-5 * scale)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-6)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-4)
    for k in ("neighbor_overflow", "pair_overflow", "scale_counts",
              "scale_caps"):
        np.testing.assert_array_equal(taux[k].numpy(), np.asarray(jaux[k]),
                                      err_msg=k)
    assert set(taux["pair_overflow_detail"]) == set(
        jaux["pair_overflow_detail"])


def test_one_step_matches_jax(bridged):
    jout = bridged["step"](bridged["params"], bridged["jsample"])
    with torch.no_grad():
        tout = bridged["model"](bridged["sample"])
    _check_step(jout, tout)
    # the boundary convs saw fluid neighbors
    nl_counts = tout[2]["num_fluid_neighbors"]
    assert float(nl_counts.max()) > 0


def test_rollout_tracks_jax(bridged):
    steps = 5
    js = dict(bridged["jsample"])
    for _ in range(steps):
        jp, jv, jaux = bridged["step"](bridged["params"], js)
        js["pos"], js["vel"] = jp, jv
    tp, tv, gate = rollout(bridged["model"], bridged["sample"], steps)
    fm = bridged["sample"]["fluid_mask"].numpy()
    assert np.isfinite(tp.numpy()[fm]).all()
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-5)
    assert gate["exact"] and gate["scales_fit"]
    assert gate["max_neighbors"] <= bridged["cfg"]["neighbor_k"]


def test_step_with_saturated_scales_matches_jax(bridged):
    """The coarse scales' capacities cut below their voxel counts on the
    first step (as the bench rollout reaches late on): the voxels that
    survive, and so the whole step, still match JAX."""
    cfg = dict(bridged["cfg"], scale_size_factor=[1.0, 0.05, 0.02])
    jmodel = jax_build_model(cfg)
    jout = jax.jit(lambda p, s: jmodel.apply(p, s, training=False))(
        bridged["params"], bridged["jsample"])
    model = build_model(cfg, device="cpu")
    model.load_state_dict(bridged["model"].state_dict())
    with torch.no_grad():
        tout = model(bridged["sample"])
    counts = tout[2]["scale_counts"].tolist()
    caps = tout[2]["scale_caps"].tolist()
    assert counts[1] > caps[1] and counts[2] > caps[2], (counts, caps)
    _check_step(jout, tout)


def test_record_launches_keeps_each_klist_conv(bridged):
    """The recorder ``chip_smoke.py`` times the kernel with: one step's
    outputs unchanged, each of its 19 K-list conv calls kept with its
    conv's name and its output, and the ops module's wrapper restored."""
    model, sample = bridged["model"], bridged["sample"]
    with torch.no_grad():
        want = model(sample)
    got, log = record_launches(model, sample)
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
    np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())
    assert cconv.cconv_klist is cconv_klist
    names = {n for n, m in model.named_modules()
             if isinstance(m, ContinuousConv)}
    assert len(log) == 19
    assert {"fluid_obs", "obs_conv", "sym_conv0"} <= {e[0] for e in log}
    for name, args, kw, out in log:
        assert name in names
        assert torch.equal(out, cconv_klist_reference(*args, **kw)), name


@pytest.mark.parametrize("precision", ["default", "highest"])
def test_symnet_correction_sums_to_zero_without_boundary(precision):
    """Momentum twin of tests/test_models.py::TestMomentumConservation:
    with no boundary particles the ASCC correction sums to ~0 over the
    fluid (Liquid3d, 3D, sym kernel 6x6x6), with the trunk in bf16 (the
    config's default) or fp32: the ASCC conv runs fp32 either way."""
    cfg = model_cfg("Liquid3d.yml")
    cfg["out_scale"] = [1.0, 1.0, 1.0]
    cfg["conv_k_chunk"] = 0  # chunking is summation-exact; not ported
    cfg["precision"] = precision
    model = build_model(cfg, device="cpu")
    assert model.sym_conv0.precision == "highest"
    rng = np.random.RandomState(6)
    pos = rng.uniform(-0.2, 0.2, (64, 3)).astype(np.float32)
    sample = {
        "pos": torch.from_numpy(pos),
        "vel": torch.from_numpy(rng.randn(64, 3).astype(np.float32) * 0.01),
        "grav": torch.tensor([[0.0, -9.81, 0.0]]).repeat(64, 1),
        "box": torch.zeros((8, 3)), "box_normals": torch.zeros((8, 3)),
        "fluid_mask": torch.ones(64, dtype=torch.bool),
        "box_mask": torch.zeros(8, dtype=torch.bool),
    }
    with torch.no_grad():
        _, _, aux = model(sample)
    corr = aux["pos_correction"].numpy()
    total = np.abs(corr.sum(axis=0))
    scale = np.abs(corr).sum() + 1e-12
    assert np.all(total / scale < 1e-5), (total, scale)


def test_cuda_entry_points_raise_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        build_model(narrow_cfg())
    pos, box, nrm = build_scene(64)
    with pytest.raises(RuntimeError, match="cuda"):
        bench_sample(pos, box, nrm)
