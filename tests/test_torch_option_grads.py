"""Model options in the PyTorch port against the JAX reference, on the
CPU: one gradient against ``jax.grad`` over the farthest-point pyramid
with dens_norm, the pre-advection branch and circular kernels, and the
bf16 trunk with those options, on the narrow models and the scene of
``test_torch_options.py`` (tolerances stated at each test).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmcf_tpu_torch.interop import params_from_flax
from tests.test_torch_options import BASE, both, check_step, make_sample

# two intra-op threads: the suite runs files side by side on a few cores
torch.set_num_threads(2)

T = torch.from_numpy


@pytest.fixture(scope="module")
def sample():
    return make_sample()


def test_fps_dens_norm_pre_adv_circular_grads_match_jax(sample):
    """One gradient against ``jax.grad``: the FPS pyramid with dens_norm,
    the pre-advection branch and circular kernels, the loss a fixed
    weighting of the position correction; every parameter's gradient
    within 1e-4 of its largest JAX element (fp32 sums in other orders)."""
    cfg = dict(BASE, voxel_size=None, scale_size_factor=[1.0, 0.5],
               dens_norm=True, use_pre_adv=True, circular=True)
    jmodel, params, js, model = both(cfg, sample)
    wts = np.random.RandomState(9).randn(112, 3).astype(np.float32)

    def jloss(p):
        return jnp.sum(jmodel.apply(p, js, training=True)[2][
            "pos_correction"] * wts)

    jgrads = params_from_flax(jax.tree.map(
        np.asarray, jax.jit(jax.grad(jloss))(params)))
    loss = (model({k: T(v) for k, v in sample.items()}, training=True)[2][
        "pos_correction"] * T(wts)).sum()
    loss.backward()
    got = {n: p.grad for n, p in model.named_parameters()}
    assert set(got) == set(jgrads)
    moved = 0
    for name, want in jgrads.items():
        scale = float(want.abs().max())
        err = float((got[name] - want).abs().max())
        assert err <= 1e-4 * scale, (name, err, scale)
        moved += scale > 0
    # all but obs_conv's kernel: its gather reads the boundary's last
    # (padded, zero) row, in both packages (ROADMAP §3)
    assert moved == len(jgrads) - 1


def test_options_bf16_step_matches_jax_default(sample):
    """The FPS pyramid with dens_norm and the pre-advection branch at the
    default precision (the bf16 trunk): within 2e-4 of the correction's
    max of JAX's, as ``test_torch_precision.py`` holds the WaterRamps
    step (measured 6.2e-7)."""
    cfg = dict(BASE, voxel_size=None, scale_size_factor=[1.0, 0.5],
               dens_norm=True, use_pre_adv=True)
    jmodel, params, js, model = both(cfg, sample, precision="default")
    assert model.precision == "default"
    jout = jax.jit(lambda p, s: jmodel.apply(p, s, training=True))(
        params, js)
    with torch.no_grad():
        tout = model({k: T(v) for k, v in sample.items()}, training=True)
    check_step(jout, tout, tol=2e-4)
