"""The K-list conv's interpolation modes ("linear", "linear_border",
"nearest_neighbor") in the port's plain twin against the JAX package's
``continuous_conv``, on the CPU, on a small 3D cloud whose queries are not
its points (no coincident pair, so no hat sits on a kink).

``align_corners=False`` maps the unit ball past the outer taps (|t| up to
size / 2 against h = (size - 1) / 2): there linear clamps and
linear_border does not, so the two differ; ``align_corners=True`` keeps t
inside the span, where they agree.

Tolerances (of each output's or gradient's max abs): fp32 outputs 2e-5
absolute (sum order); bf16 at JAX's default 1e-4 (as
``test_torch_precision.py``: a sum order can flip an element of T by one
bf16 step); gradients 1e-5 of each one's max (fp32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmcf_tpu.ops import cconv as jcc
from dmcf_tpu.ops import coords as jcoords
from dmcf_tpu.ops import neighbors as jnb
from dmcf_tpu.ops import windows as jwin
from dmcf_tpu_torch.kernels.cconv_klist import (cconv_klist_bwd_reference,
                                                cconv_klist_reference)
from dmcf_tpu_torch.ops import cconv, coords, neighbors, windows

# two intra-op threads: the suite runs files side by side on a few cores
torch.set_num_threads(2)

T = torch.from_numpy
MODES = ("linear", "linear_border", "nearest_neighbor")
MAPPINGS = ("ball_to_cube_volume_preserving", "identity")
KSIZE = (3, 4, 4)


@pytest.fixture(scope="module")
def cloud():
    """48 points and 20 other queries in a 0.6 cube, radius 0.2 (K 16),
    8 -> 4 channels, a [3, 4, 4] filter (odd and even axes)."""
    rng = np.random.RandomState(11)
    pts = rng.uniform(-0.3, 0.3, (48, 3)).astype(np.float32)
    qry = rng.uniform(-0.3, 0.3, (20, 3)).astype(np.float32)
    feats = rng.randn(48, 8).astype(np.float32)
    kern = (rng.randn(*KSIZE, 8, 4) * 0.1).astype(np.float32)
    nl = jax.jit(lambda p, q: jnb.fixed_radius_search(p, q, 0.2, 16))(
        pts, qry)
    assert int(nl.count.max()) <= 16 and int(nl.count.min()) > 0
    tnl = neighbors.NeighborList(
        idx=T(np.array(nl.idx)), mask=T(np.array(nl.mask)),
        dist=T(np.array(nl.dist)), count=T(np.array(nl.count)))
    jnl = jnb.NeighborList(idx=nl.idx, mask=nl.mask, dist=nl.dist,
                           count=nl.count)
    return dict(pts=pts, qry=qry, feats=feats, kern=kern, nl=tnl, jnl=jnl,
                rng=rng)


def _both(c, mode, align, mapping, precision, **kw):
    """(JAX, port) conv outputs at one setting (the lists without disp:
    the offsets come from the positions in both)."""
    win = kw.pop("window", "poly6")
    want = np.asarray(jcc.continuous_conv(
        jnp.asarray(c["kern"]), jnp.asarray(c["qry"]), jnp.asarray(c["pts"]),
        jnp.asarray(c["feats"]), c["jnl"], 0.4,
        window_fn=jwin.get_window_func(win), coordinate_mapping=mapping,
        interpolation=mode, align_corners=align, precision=precision,
        **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}))
    got = cconv.continuous_conv(
        T(c["kern"]), T(c["qry"]), T(c["pts"]), T(c["feats"]), c["nl"], 0.4,
        window_fn=windows.get_window_func(win), coordinate_mapping=mapping,
        interpolation=mode, align_corners=align, precision=precision,
        **{k: T(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()})
    return want, got.numpy()


@pytest.mark.parametrize("mapping", MAPPINGS)
@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("mode", MODES)
def test_conv_modes_match_jax(cloud, mode, align, mapping):
    want, got = _both(cloud, mode, align, mapping, "highest")
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, atol=2e-5)
    want16, got16 = _both(cloud, mode, align, mapping, "default")
    assert np.abs(got16 - want16).max() <= 1e-4 * np.abs(want16).max()
    if not align:
        # past the span linear clamps and linear_border does not
        other = "linear_border" if mode == "linear" else "linear"
        if mode != "nearest_neighbor":
            _, alt = _both(cloud, other, align, mapping, "highest")
            assert np.abs(alt - got).max() > 1e-3 * np.abs(got).max()


@pytest.mark.parametrize("mode", MODES)
def test_symmetric_conv_modes_match_jax(cloud, mode):
    """The ASCC conv (self term, antisymmetric kernel) in each mode."""
    c = cloud
    half = c["kern"][:, :, :2]
    full_j = jcc.build_symmetric_kernel(jnp.asarray(half), 2)
    full_t = cconv.build_symmetric_kernel(T(half), 2)
    want = np.asarray(jcc.continuous_conv(
        full_j, jnp.asarray(c["qry"]), jnp.asarray(c["pts"]),
        jnp.asarray(c["feats"]), c["jnl"], 0.4,
        window_fn=jwin.get_window_func("poly6"), interpolation=mode,
        symmetric=True, query_features=jnp.asarray(c["feats"][:20])))
    got = cconv.continuous_conv(
        full_t, T(c["qry"]), T(c["pts"]), T(c["feats"]), c["nl"], 0.4,
        window_fn=windows.get_window_func("poly6"), interpolation=mode,
        symmetric=True, query_features=T(c["feats"][:20]))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("mode", MODES)
def test_conv_mode_gradients_match_jax(cloud, mode, align):
    """Gradients in the features, the filter and both point sets against
    jax.grad of the same weighted sum (nearest_neighbor's are 0 in the
    positions in both)."""
    c = cloud
    r = c["rng"].randn(20, 4).astype(np.float32)
    kw = dict(interpolation=mode, align_corners=align,
              coordinate_mapping="identity")

    def jloss(kern, qry, pts, feats):
        out = jcc.continuous_conv(kern, qry, pts, feats, c["jnl"], 0.4,
                                  window_fn=jwin.get_window_func("poly6"),
                                  **kw)
        return jnp.sum(out * r)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(c[k]) for k in ("kern", "qry", "pts", "feats")))
    leaves = [T(c[k]).clone().requires_grad_(True)
              for k in ("kern", "qry", "pts", "feats")]
    out = cconv.continuous_conv(*leaves[:3], leaves[3], c["nl"], 0.4,
                                window_fn=windows.get_window_func("poly6"),
                                **kw)
    got = torch.autograd.grad((out * T(r)).sum(), leaves, allow_unused=True)
    for name, g, w in zip(("kernel", "queries", "points", "feats"), got,
                          want):
        w = np.asarray(w)
        g = torch.zeros(w.shape) if g is None else g
        scale = max(float(np.abs(w).max()), 1e-12)
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5 * scale,
                                   err_msg=name)
        if mode == "nearest_neighbor" and name in ("queries", "points"):
            assert float(g.abs().max()) == 0.0
        elif name in ("kernel", "feats"):
            assert float(g.abs().max()) > 0.0


@pytest.mark.parametrize("mode", MODES)
def test_twin_backward_takes_the_mode(cloud, mode):
    """The plain backward the card's kernels are held against: its
    gradients are autograd's of the twin in the same mode (dt 0 for
    nearest_neighbor, non-zero for the hats)."""
    c = cloud
    idx, a, t = cconv.klist_geometry(
        c["nl"], 0.4, KSIZE, out_positions=T(c["qry"]),
        inp_positions=T(c["pts"]), coordinate_mapping="identity",
        align_corners=False)
    w = T(c["kern"]).reshape(-1, 4)
    dout = T(c["rng"].randn(20, 4).astype(np.float32))
    dfeats, _, dw, da, dt = cconv_klist_bwd_reference(
        dout, idx, a, t, T(c["feats"]), w, KSIZE, interpolation=mode)
    leaves = [x.clone().requires_grad_(True) for x in (a, t, T(c["feats"]),
                                                       w)]
    out = cconv_klist_reference(idx, *leaves, KSIZE, interpolation=mode)
    ga, gt, gf, gw = torch.autograd.grad(out, leaves, dout,
                                         allow_unused=True)
    gt = torch.zeros_like(t) if gt is None else gt
    for got, want in ((dfeats, gf), (dw, gw), (da, ga), (dt, gt)):
        assert torch.equal(got, want)
    if mode == "nearest_neighbor":
        assert float(dt.abs().max()) == 0.0
    else:
        assert float(dt.abs().max()) > 0.0


def test_nearest_ties_round_half_even():
    """At t + h exactly on a half (t = 0 on an even axis) the nearest tap
    is JAX's round half to even, in the port's weights as in JAX's."""
    for size in (1, 3, 4):
        half = 0.5 * (size - 1)
        t = (np.arange(-2 * size, 2 * size + 1) * 0.5
             - half % 1.0).astype(np.float32)
        for mode in MODES:
            want = np.asarray(jcoords.axis_interp_weights(
                jnp.asarray(t), size, mode))
            got = coords.axis_interp_weights(T(t), size, mode).numpy()
            np.testing.assert_array_equal(got, want, err_msg=(size, mode))
    w = coords.axis_interp_weights(torch.tensor([0.0, 1.0, -1.0]), 4,
                                   "nearest_neighbor")
    # t + h: 1.5 -> 2, 2.5 -> 2, 0.5 -> 0
    assert w.argmax(dim=1).tolist() == [2, 2, 0]


def test_offset_and_index_coordinates_match_jax(cloud):
    """``offset`` shifts the centred coordinates; the index-space ones are
    the centred ones shifted by (size - 1) / 2."""
    rel = cloud["rng"].uniform(-1, 1, (30, 3)).astype(np.float32)
    off = np.asarray([0.25, -0.5, 0.125], np.float32)
    for fn in ("compute_filter_coordinates",
               "compute_centered_filter_coordinates"):
        for align in (True, False):
            want = getattr(jcoords, fn)(jnp.asarray(rel), KSIZE,
                                        "ball_to_cube_radial", align, off)
            got = getattr(coords, fn)(T(rel), KSIZE, "ball_to_cube_radial",
                                      align, off)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    want, got = _both(cloud, "linear_border", False, "identity", "highest",
                      offset=np.asarray([0.5, 0.0, -0.5], np.float32))
    np.testing.assert_allclose(got, want, atol=2e-5)
