"""The port's slab-decomposed model step (``dmcf_tpu_torch/parallel/
halo_model.py``) against the JAX package's (``dmcf_tpu/parallel/
halo_model.py``) and against its own single-process step, on the CPU:
JAX on 2 of the 8 virtual CPU devices, the port on 2 gloo ranks
(``parallel.dist.spawn``; rank bodies in ``_torch_ranks.py``), both at
``precision: highest`` with JAX's weights carried over by ``interop``,
on the JAX tests' scene and small multi-scale SymNet
(``test_halo_model.CFG``, ``_scene``).

Tolerances (JAX's own, ``tests/test_halo_model.py`` and
``test_halo_rollout.py``): the D=2 step's positions within 2e-5 and
velocities within 2e-3 of JAX's halo step (velocity = a position
difference over dt 0.01); the loss within 1e-5 relative and its
parameter gradients within rtol 5e-4 (atol 5e-6 of the gradient's max);
integer reports exactly (``test_torch_halo_rollout.py`` holds the
rollout).  The port anchors the voxel grids at the
centroid of the advected positions, as the single-process model does
(JAX's halo step takes it before the advection), so it sits closer to
the single-process step than JAX's halo step does: 1e-6 here.
"""

import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from dmcf_tpu.models import build_model as jax_build_model
from dmcf_tpu.parallel import halo_model as jhm
from dmcf_tpu.parallel.spatial import make_spatial_mesh
from dmcf_tpu_torch.interop import params_from_flax
from dmcf_tpu_torch.models import build_model
from dmcf_tpu_torch.parallel import halo_model as hm
from dmcf_tpu_torch.parallel.dist import spawn

import _torch_ranks
from test_halo_model import CFG, _scene

# two intra-op threads: the suite runs files side by side on a few cores
torch.set_num_threads(2)

CONFIG_DIR = os.path.join(os.path.dirname(__file__), "..", "configs")
PBF_CONFIGS = ["Liquid3d.yml", "WBC-SPH.yml", "WaterRamps.yml",
               "column/hrnet.yml", "column/symnet.yml",
               "column/symnet_wide.yml", "other/WaterRamps5steps.yml",
               "other/momentum.yml"]


@pytest.fixture(scope="module")
def bridged():
    jmodel = jax_build_model(dict(CFG))
    sample = _scene()
    jsample = {k: jnp.asarray(v) for k, v in sample.items()}
    params = jax.jit(lambda key, s: jmodel.init(key, s, training=False))(
        jax.random.PRNGKey(0), jsample)
    state = params_from_flax(jax.tree.map(np.asarray, params))
    model = build_model(dict(CFG), device="cpu")
    model.load_state_dict(state)
    tsample = {k: torch.from_numpy(v) for k, v in sample.items()}
    return dict(jmodel=jmodel, params=params, state=state, model=model,
                sample=sample, tsample=tsample)


def _pbf(name):
    with open(os.path.join(CONFIG_DIR, name)) as f:
        return yaml.safe_load(f)["model"]


@pytest.mark.parametrize("name", ["test_halo_model.CFG"] + PBF_CONFIGS)
def test_receptive_field_matches_jax(name):
    cfg = dict(CFG) if name == "test_halo_model.CFG" else _pbf(name)
    want = jhm.receptive_field(jax_build_model(dict(cfg)))
    got = hm.receptive_field(build_model(dict(cfg), device="cpu"))
    assert got == want


def test_partition_matches_jax(bridged):
    sample = bridged["sample"]
    rf = hm.receptive_field(bridged["model"])
    want = jhm.partition_model_sample(sample, 2, rf)
    got = hm.partition_model_sample(bridged["tsample"], 2, rf)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(want[key]), err_msg=key)


def test_halo_step_and_loss_match_jax(bridged):
    """The D=2 step, its reports and the loss with its gradients, against
    JAX's make_halo_model_step on the same weights and sample."""
    jmodel, params, sample = (bridged["jmodel"], bridged["params"],
                              bridged["sample"])
    rf = jhm.receptive_field(jmodel)
    parts = jhm.partition_model_sample(sample, 2, rf)
    n = sample["pos"].shape[0]
    rng = np.random.RandomState(7)
    tgt = np.stack([sample["pos"] + rng.normal(scale=1e-3, size=(n, 3))
                    .astype(np.float32), sample["vel"] * 0.9], 1)
    tgt_sh = tgt[parts["src"]]                       # [D, fcap, 2, 3]

    # the ranks run while JAX compiles and runs its step here
    with ThreadPoolExecutor(1) as pool:
        spawned = pool.submit(spawn, _torch_ranks.halo_step, 2,
                              args=(dict(CFG), bridged["state"], parts, rf,
                                    512, tgt_sh))
        mesh = make_spatial_mesh(jax.devices()[:2])
        jparts = jhm.shard_model_parts(parts, mesh)
        jstep = jhm.make_halo_model_step(jmodel, mesh, halo_width=rf,
                                         halo_cap=512)
        jp, jv, _ = jax.jit(jstep)(params, jparts)
        jl, jg = jax.jit(jax.value_and_grad(lambda pr: jstep.loss(
            pr, jparts, jnp.asarray(tgt_sh), w_pos=1.0, w_vel=0.5)))(params)
        ranks = spawned.result()
    fm = sample["fluid_mask"]
    got_p = hm.gather_owned(parts, torch.cat([r["pos"] for r in ranks]), n)
    got_v = hm.gather_owned(parts, torch.cat([r["vel"] for r in ranks]), n)
    want_p = jhm.gather_owned(parts, np.asarray(jp), n)
    want_v = jhm.gather_owned(parts, np.asarray(jv), n)
    np.testing.assert_allclose(got_p[fm], want_p[fm], rtol=0, atol=2e-5)
    np.testing.assert_allclose(got_v[fm], want_v[fm], rtol=0, atol=2e-3)

    # the single-process step: the port's decomposition within 1e-6 of it
    with torch.no_grad():
        p1, v1, aux1 = bridged["model"](bridged["tsample"])
    np.testing.assert_allclose(got_p[fm], p1.numpy()[fm], rtol=0, atol=1e-6)

    aux = ranks[0]["aux"]
    for r in ranks:      # every rank holds the same reduced reports
        for k, v in r["aux"].items():
            assert torch.equal(v, aux[k]), k
    assert int(aux["halo_overflow"]) == 0
    assert int(aux["halo_escaped"]) == 0
    # the ranks see the single-process neighbourhoods: the same K excess
    assert int(aux["pair_overflow"]) == int(aux1["pair_overflow"])
    assert int(aux["neighbor_overflow"]) == int(aux1["neighbor_overflow"])
    # every occupied voxel of the single-process pyramid is stamped by at
    # least its owner (grids anchored at the psum'd center): per coarse
    # scale each rank counts at most the single count, together at least
    counts_sh = aux["scale_counts"].numpy()          # [D, n_scales]
    counts_1 = aux1["scale_counts"].numpy()
    for s in range(1, counts_1.shape[0]):
        assert counts_sh[:, s].sum() >= counts_1[s], (s, counts_sh, counts_1)
        assert (counts_sh[:, s] <= counts_1[s]).all(), (s, counts_sh,
                                                         counts_1)

    for r in ranks:
        np.testing.assert_allclose(r["loss"], float(jl), rtol=1e-5)
    flat = params_from_flax(jax.tree.map(np.asarray, jg))
    for r in ranks:
        assert set(r["grads"]) == set(flat)
        for name, want in flat.items():
            np.testing.assert_allclose(
                r["grads"][name].numpy(), want.numpy(), rtol=5e-4,
                atol=5e-6 * max(1.0, float(want.abs().max())), err_msg=name)


def test_fps_transitions_rejected():
    cfg = dict(CFG, voxel_size=None)
    model = build_model(cfg, device="cpu")
    with pytest.raises(NotImplementedError):
        hm.make_halo_model_step(model, None, halo_width=1.0, halo_cap=64)
