"""Leaf ops of the PyTorch port (dmcf_tpu_torch.ops) against the JAX
reference on identical numpy inputs, on the CPU (fp32).

Tolerances: elementwise math 1e-6 absolute (same formulas, different
libm); the K-list conv 2e-5 (the tolerance tests/test_pallas_kernel.py
holds the Pallas kernel to, covering contraction order); integer outputs
(indices, masks, counts) exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmcf_tpu.experimental.pallas_cconv import pallas_continuous_conv
from dmcf_tpu.models.pbf import drop_coincident as jax_drop_coincident
from dmcf_tpu.ops import cconv as jcc
from dmcf_tpu.ops import coords as jcoords
from dmcf_tpu.ops import neighbors as jnb
from dmcf_tpu.ops import sph as jsph
from dmcf_tpu.ops import windows as jwin
from dmcf_tpu_torch.models.pbf import drop_coincident
from dmcf_tpu_torch.ops import cconv, coords, neighbors, sph, windows

# two intra-op threads: the suite runs files side by side on a few cores
torch.set_num_threads(2)

T = torch.from_numpy


def to_torch_nl(nl):
    """A JAX NeighborList as the port's NeighborList (same lists)."""
    return neighbors.NeighborList(
        idx=T(np.array(nl.idx)), mask=T(np.array(nl.mask)),
        dist=T(np.array(nl.dist)), count=T(np.array(nl.count)),
        disp=T(np.array(nl.disp)))


def random_cloud(rng, n, dim=3, lo=-0.3, hi=0.3):
    pts = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    pts[:, dim:] = 0.0
    return pts


@pytest.mark.parametrize("name", ["poly6", "cubic", "linear", "peak",
                                  "cubic_grad"])
def test_windows_match_jax(name):
    q = np.concatenate([np.linspace(0.0, 1.3, 261),
                        [0.0, 0.25, 1.0]]).astype(np.float32)
    got = windows.get_window_func(name)(T(q)).numpy()
    ref = np.asarray(jwin.get_window_func(name)(jnp.asarray(q)))
    np.testing.assert_allclose(got, ref, atol=1e-6)


@pytest.mark.parametrize("mapping", ["ball_to_cube_radial",
                                     "ball_to_cube_volume_preserving",
                                     "identity"])
def test_filter_coordinates_and_hats_match_jax(mapping):
    rng = np.random.RandomState(0)
    rel = rng.uniform(-1, 1, (500, 3)).astype(np.float32)
    rel /= np.maximum(np.linalg.norm(rel, axis=1, keepdims=True), 1.0)
    rel[:100, 2] = 0.0          # 2D offsets
    rel[100:110] = 0.0          # coincident pairs
    rel[110:120, 1:] = 0.0      # on an axis
    for fsz in [(1, 8, 8), (4, 4, 4), (6, 6, 6)]:
        got = coords.compute_centered_filter_coordinates(T(rel), fsz,
                                                         mapping, True)
        ref = jcoords.compute_centered_filter_coordinates(
            jnp.asarray(rel), fsz, mapping, True)
        for g, r, size in zip(got, ref, fsz):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-6)
            for interp in ("linear", "linear_border", "nearest_neighbor"):
                w_got = coords.axis_interp_weights(g, size, interp).numpy()
                w_ref = np.asarray(jcoords.axis_interp_weights(
                    jnp.asarray(g.numpy()), size, interp))
                np.testing.assert_array_equal(w_got, w_ref, err_msg=interp)


def test_hat_weights_are_mirror_exact():
    """relu(1 - |clamp(t) - p_i|) on centred coordinates: w(-t) is w(t)
    reversed, bitwise (the ASCC momentum guarantee rests on it)."""
    t = torch.linspace(-4.5, 4.5, 1001)
    for size in (1, 2, 4, 6, 8):
        w = coords.axis_interp_weights(t, size, "linear")
        w_m = coords.axis_interp_weights(-t, size, "linear")
        assert torch.equal(w_m, torch.flip(w, dims=(-1,)))
    assert torch.equal(coords.axis_interp_weights(t, 1, "linear"),
                       torch.ones(1001, 1))


def _hat_edge_points(size):
    """A sweep of t with the edge points of a size-``size`` axis: tap
    centres, half-way points, +-h, beyond the clamp, and the float
    neighbours of each (where a rounded ``clamp(t) + h`` lands on the next
    integer)."""
    half = 0.5 * (size - 1)
    centres = np.arange(size, dtype=np.float64) - half
    pts = np.concatenate([centres, centres + 0.5, [-half, half],
                          [-half - 0.3, half + 0.3, -10.0, 10.0, 0.0]])
    pts = pts.astype(np.float32)
    near = np.concatenate([np.nextafter(pts, np.float32(np.inf)),
                           np.nextafter(pts, np.float32(-np.inf)),
                           pts - np.float32(2 ** -24),
                           pts + np.float32(2 ** -24)])
    sweep = np.linspace(-half - 1, half + 1, 997, dtype=np.float32)
    return np.concatenate([pts, near, -near, sweep]).astype(np.float32)


@pytest.mark.parametrize("size", [1, 4, 6, 8])
def test_hat_nonzero_taps_are_the_closed_form_pair(size):
    """The invariant the K-list kernel's tap skipping rests on: on the
    twin's own hats, every non-zero weight lies at i0 = floor(clamp(t) + h)
    or i0 + 1, with the floor taken of the exact sum (the kernel's
    round-down add), and the kernel's closed form gives those weights
    bitwise."""
    t = _hat_edge_points(size)
    w = coords.axis_interp_weights(T(t), size, "linear").numpy()
    half = np.float32(0.5 * (size - 1))
    tc = np.clip(t, -half, half)
    # float64 holds the sum of two float32 exactly: its floor is the floor
    # of the kernel's __fadd_rd(tc, h)
    i0 = np.minimum(np.floor(tc.astype(np.float64) + half).astype(np.int64),
                    size - 1)

    def hat(tc, i):
        p = i.astype(np.float32) - half
        return np.maximum(np.float32(1) - np.abs(tc - p), np.float32(0))

    cols = np.arange(size)[None, :]
    in_pair = (cols == i0[:, None]) | (cols == i0[:, None] + 1)
    assert not np.any(w[~in_pair]), "a non-zero hat outside (i0, i0 + 1)"
    rows = np.arange(len(t))
    np.testing.assert_array_equal(w[rows, i0], hat(tc, i0))
    has1 = i0 + 1 < size
    np.testing.assert_array_equal(w[rows[has1], i0[has1] + 1],
                                  hat(tc[has1], i0[has1] + 1))
    if size == 8:
        # a round-to-nearest floor(clamp(t) + h) would miss a 2^-24 tap:
        # at t = 0.5 - 2^-24 the float sum rounds up to 4, tap 3 is 2^-24
        rounded = np.minimum(np.floor(tc + half).astype(np.int64), size - 1)
        assert np.any((rounded != i0) & (w[rows, i0] != 0))


@pytest.mark.parametrize("ignore_query_point", [False, True])
def test_fixed_radius_search_matches_jax(ignore_query_point):
    rng = np.random.RandomState(1)
    pts = random_cloud(rng, 300, dim=2)
    qs = np.concatenate([random_cloud(rng, 150, dim=2), pts[:50]])
    pm = rng.rand(300) > 0.1
    qm = rng.rand(200) > 0.1
    k = 12  # small enough that dense queries overflow
    ref = jnb.fixed_radius_search(jnp.asarray(pts), jnp.asarray(qs), 0.09,
                                  k, points_mask=jnp.asarray(pm),
                                  queries_mask=jnp.asarray(qm),
                                  ignore_query_point=ignore_query_point)
    got = neighbors.search(T(pts), T(qs), 0.09, k, points_mask=T(pm),
                           queries_mask=T(qm),
                           ignore_query_point=ignore_query_point)
    assert got.idx.dtype == torch.int32
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(ref.idx))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(ref.mask))
    np.testing.assert_array_equal(got.count.numpy(), np.asarray(ref.count))
    np.testing.assert_allclose(got.dist.numpy(), np.asarray(ref.dist),
                               atol=1e-6)
    np.testing.assert_allclose(got.disp.numpy(), np.asarray(ref.disp),
                               atol=1e-6)
    assert (got.count.numpy() > k).any()


@pytest.mark.parametrize("k", [8, 200])
def test_select_k_valid_first_k_by_index(k):
    rng = np.random.RandomState(2)
    valid = rng.rand(64, 150) < 0.3
    dist = rng.rand(64, 150).astype(np.float32)
    got = neighbors.select_k_valid(T(valid), T(dist), k)
    ref = jnb.select_k_valid(jnp.asarray(valid), jnp.asarray(dist), k)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def _dilated_pos_both(caps):
    """The voxel pyramid of one scene from JAX and from the port: a
    rest-spacing block with jitter (no point on a voxel edge) plus padded
    rows at the sentinels."""
    rng = np.random.RandomState(3)
    g = np.stack(np.meshgrid(np.arange(20), np.arange(14), indexing="ij"),
                 -1).reshape(-1, 2) * 0.01
    pos = np.zeros((320, 3), np.float32)
    pos[:280, :2] = g + rng.normal(scale=1e-3, size=g.shape)
    mask = np.arange(320) < 280
    pos = np.array(jsph.masked_positions(jnp.asarray(pos),
                                         jnp.asarray(mask)))
    vox = np.asarray([0.01, 0.01, 0.0], np.float32)
    # JAX's pyramid compiled whole (eager, each op compiles on its own)
    ref = jax.jit(lambda p, m: jsph.get_dilated_pos(
        p, m, [1, 2, 4], caps, voxel_size=vox, centralize=True))(
        jnp.asarray(pos), jnp.asarray(mask))
    got = sph.get_dilated_pos(T(pos), T(mask), [1, 2, 4], caps,
                              voxel_size=vox, centralize=True)
    for s in range(3):
        np.testing.assert_array_equal(got[1][s].numpy(),
                                      np.asarray(ref[1][s]))
        assert int(got[2][s]) == int(ref[2][s])
        # equal up to the centroid's fp32 summation order
        np.testing.assert_allclose(got[0][s].numpy(), np.asarray(ref[0][s]),
                                   rtol=1e-7, atol=1e-7)
    return got


def test_get_dilated_pos_matches_jax():
    got = _dilated_pos_both([320, 160, 80])
    assert int(got[2][1]) > 0 and int(got[2][2]) > 0


def test_get_dilated_pos_saturated_matches_jax():
    """Capacities below the occupied-voxel counts: which voxels survive the
    cut follows the dedup's row order, and the port keeps JAX's (the
    counts still report every occupied voxel)."""
    caps = [320, 40, 16]
    got = _dilated_pos_both(caps)
    for s in (1, 2):
        assert int(got[2][s]) > caps[s]
        assert bool(got[1][s].all())


def _conv_inputs(seed, q=256, k=16, cin=8, ignore_query_point=False):
    rng = np.random.RandomState(seed)
    pts = random_cloud(rng, q)
    feats = rng.randn(q, cin).astype(np.float32)
    ext = 0.15
    # JAX's search compiled whole (eager, each op compiles on its own)
    nl = jax.jit(lambda p: jnb.fixed_radius_search(
        p, p, ext / 2, k, ignore_query_point=ignore_query_point))(
        jnp.asarray(pts))
    if ignore_query_point:
        nl = jax_drop_coincident(nl, jnp.asarray(pts), jnp.asarray(pts))
    return rng, pts, feats, ext, nl


@pytest.mark.parametrize("mapping", ["ball_to_cube_volume_preserving",
                                     "ball_to_cube_radial"])
@pytest.mark.parametrize("symmetric", [False, True])
def test_continuous_conv_matches_jax(symmetric, mapping):
    rng, pts, feats, ext, nl = _conv_inputs(
        4, ignore_query_point=symmetric)
    win = "peak" if symmetric else "poly6"
    if symmetric:
        kh = (rng.randn(2, 2, 4, 8, 3) * 0.1).astype(np.float32)
        kern_j = jcc.build_symmetric_kernel(jnp.asarray(kh), 2)
        kern_t = cconv.build_symmetric_kernel(T(kh), 2)
        np.testing.assert_array_equal(kern_t.numpy(), np.asarray(kern_j))
    else:
        kern_t = T((rng.randn(1, 8, 8, 8, 4) * 0.1).astype(np.float32))
        kern_j = jnp.asarray(kern_t.numpy())
    # JAX's conv compiled whole (eager, each op compiles on its own)
    ref = jax.jit(lambda k_, p_, f_, nl_: jcc.continuous_conv(
        k_, p_, p_, f_, nl_, ext, window_fn=jwin.get_window_func(win),
        coordinate_mapping=mapping, symmetric=symmetric,
        query_features=f_ if symmetric else None))(
        kern_j, jnp.asarray(pts), jnp.asarray(feats), nl)
    kw = dict(window_fn=windows.get_window_func(win),
              coordinate_mapping=mapping, symmetric=symmetric,
              query_features=T(feats) if symmetric else None)
    args = (kern_t, T(pts), T(pts), T(feats), to_torch_nl(nl), ext)
    got = cconv.continuous_conv_reference(*args, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)
    # on CPU tensors the dispatching entry point is the plain twin
    assert torch.equal(cconv.continuous_conv(*args, **kw), got)


@pytest.mark.parametrize("symmetric", [False, True])
def test_klist_contract_matches_pallas_interpret(symmetric):
    """The kernel contract (idx, a, t, feats, W) against the TPU kernel
    itself, run in interpret mode on pre-gathered inputs (Q 128, K 8)."""
    rng, pts, feats, ext, nl = _conv_inputs(
        5, q=128, k=8, ignore_query_point=symmetric)
    radius = ext / 2
    win = "peak" if symmetric else "poly6"
    if symmetric:
        kern = np.asarray(jcc.build_symmetric_kernel(jnp.asarray(
            (rng.randn(1, 4, 4, 8, 2) * 0.1).astype(np.float32)), 1))
    else:
        kern = (rng.randn(1, 8, 8, 8, 4) * 0.1).astype(np.float32)
    idx = np.asarray(nl.idx)
    mask = np.asarray(nl.mask)
    rel = np.where(mask[..., None], (pts[idx] - pts[:, None, :]) / radius,
                   0.0).astype(np.float32)
    a = (mask * np.asarray(jwin.get_window_func(win)(
        jnp.asarray(np.asarray(nl.dist) / radius**2)))).astype(np.float32)
    fg = np.where(mask[..., None], feats[idx], 0.0).astype(np.float32)
    ref = pallas_continuous_conv(
        jnp.asarray(kern), jnp.asarray(rel), jnp.asarray(a),
        jnp.asarray(fg), query_feats=jnp.asarray(feats) if symmetric
        else None, symmetric=symmetric, interpret=True)
    got = cconv.continuous_conv_reference(
        T(kern), T(pts), T(pts), T(feats), to_torch_nl(nl), ext,
        window_fn=windows.get_window_func(win), symmetric=symmetric,
        query_features=T(feats) if symmetric else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)


def test_klist_conv_clamps_out_of_range_gather_like_jax():
    """Pins the reference's obs_conv gather offset (ROADMAP §3): neighbor
    indices that point past the feature rows read the last row, as JAX's
    clamped gather does — the port reproduces it on purpose."""
    rng, pts, feats, ext, nl = _conv_inputs(6, q=128, k=8)
    small = feats[:40]  # indices >= 40 are out of range for these rows
    kern = (rng.randn(1, 8, 8, 8, 4) * 0.1).astype(np.float32)
    win = "poly6"
    ref = jcc.continuous_conv(jnp.asarray(kern), jnp.asarray(pts),
                              jnp.asarray(pts), jnp.asarray(small), nl, ext,
                              window_fn=jwin.get_window_func(win))
    tnl = to_torch_nl(nl)
    assert int(tnl.idx.max()) >= 40
    got = cconv.continuous_conv(T(kern), T(pts), T(pts), T(small), tnl, ext,
                                window_fn=windows.get_window_func(win))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)
    clamped = cconv.continuous_conv(
        T(kern), T(pts), T(pts), T(small[np.minimum(np.arange(128), 39)]),
        tnl, ext, window_fn=windows.get_window_func(win))
    np.testing.assert_allclose(got.numpy(), clamped.numpy(), atol=1e-6)


def test_klist_wrapper_clamps_out_of_range_idx():
    """The contraction's own contract: an index past the feature rows reads
    the last row, in the wrapper as in its plain twin."""
    from dmcf_tpu_torch.kernels.cconv_klist import (cconv_klist,
                                                    cconv_klist_reference)
    rng = np.random.RandomState(9)
    idx = T(rng.randint(0, 64, (32, 8)).astype(np.int32))
    a = T(rng.rand(32, 8).astype(np.float32))
    t = T(rng.uniform(-2, 2, (32, 8, 3)).astype(np.float32))
    feats = T(rng.randn(40, 4).astype(np.float32))
    w = T(rng.randn(2 * 4 * 4 * 4, 3).astype(np.float32))
    assert int(idx.max()) >= 40
    before = cconv_klist.launches
    got = cconv_klist(idx, a, t, feats, w, (2, 4, 4))
    clamped = cconv_klist_reference(idx.clamp(max=39), a, t, feats, w,
                                    (2, 4, 4))
    assert torch.equal(got, clamped)
    assert cconv_klist.launches == before  # CPU tensors take the twin


@pytest.mark.parametrize("n_chunk", [0, 100])
def test_continuous_conv_dense_matches_jax(n_chunk):
    rng = np.random.RandomState(7)
    src = random_cloud(rng, 300, dim=2)
    dst = random_cloud(rng, 120, dim=2)
    radius = 0.12
    rel = (src[None] - dst[:, None]) / radius
    d2 = (rel * rel).sum(-1)
    valid = d2 <= 1.0
    rel = np.where(valid[..., None], rel, 1.0).astype(np.float32)
    a = np.where(valid, np.asarray(jwin.poly6(jnp.asarray(d2))),
                 0.0).astype(np.float32)
    feats = rng.randn(300, 8).astype(np.float32)
    kern = (rng.randn(1, 8, 8, 8, 4) * 0.1).astype(np.float32)
    # JAX's dense conv compiled whole (eager, each op compiles on its own)
    ref = jax.jit(lambda *xs: jcc.continuous_conv_dense(
        *xs, precision="highest"))(jnp.asarray(kern), jnp.asarray(rel),
                                   jnp.asarray(a), jnp.asarray(feats))
    got = cconv.continuous_conv_dense(T(kern), T(rel), T(a), T(feats),
                                      n_chunk=n_chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)


def test_symmetric_conv_conserves_momentum():
    rng = np.random.RandomState(8)
    pts = T(random_cloud(rng, 256))
    feats = T(np.abs(rng.randn(256, 8)).astype(np.float32))
    nl = drop_coincident(neighbors.search(pts, pts, 0.075, 24))
    kern = cconv.build_symmetric_kernel(
        T((rng.randn(2, 2, 2, 8, 3) * 0.1).astype(np.float32)), 2)
    out = cconv.continuous_conv(kern, pts, pts, feats, nl, 0.15,
                                window_fn=windows.get_window_func("peak"),
                                symmetric=True, query_features=feats)
    ratio = out.sum(0).abs() / out.abs().sum()
    assert bool((ratio < 1e-5).all()), ratio


# ---------------------------------------------------------------------------
# the K-list conv's VJP: the port's autograd (plain twin) and
# ``cconv_klist_bwd_reference`` against jax.vjp of continuous_conv, with the
# neighbour displacement and distance recomputed from the positions so that
# the window weights and filter coordinates carry position gradients.
# Tolerance: 1e-5 of each gradient's largest JAX entry (fp32 sums in another
# order; measured ~1e-7).


def _vjp_both(pts, feats, kern, nl, symmetric, win, ext=0.15):
    """Gradients of sum(dout * conv) in (kernel, features, query features,
    positions) from JAX and from the port's twin, and the port's contract
    inputs.  ``feats`` may have fewer rows than ``pts`` (clamped gather)."""
    idx, mask = np.asarray(nl.idx), np.asarray(nl.mask)
    count = np.asarray(nl.count)
    rng = np.random.RandomState(11)
    dout = rng.randn(pts.shape[0], kern.shape[-1]).astype(np.float32)
    qf = rng.randn(pts.shape[0], feats.shape[1]).astype(np.float32)

    def jconv(kernel, f, q, p):
        disp = jnp.where(mask[..., None], p[idx] - p[:, None], 0.0)
        n = jnb.NeighborList(
            idx=jnp.asarray(idx), mask=jnp.asarray(mask),
            dist=jnp.where(mask, (disp ** 2).sum(-1), 0.0),
            count=jnp.asarray(count), disp=disp)
        return jcc.continuous_conv(
            kernel, p, p, f, n, ext, window_fn=jwin.get_window_func(win),
            symmetric=symmetric, query_features=q if symmetric else None)

    # one compiled VJP: eager, every primitive of the backward compiles
    want = [np.asarray(g) for g in jax.jit(
        lambda *xs: jax.vjp(jconv, *xs)[1](jnp.asarray(dout)))(
            *(jnp.asarray(x) for x in (kern, feats, qf, pts)))]
    leaves = [T(x.copy()).requires_grad_(True) for x in (kern, feats, qf,
                                                         pts)]
    k_, f_, q_, p_ = leaves
    ti, tm = T(idx.copy()), T(mask.copy())
    disp = torch.where(tm[..., None], p_[ti.long()] - p_[:, None], 0.0)
    tnl = neighbors.NeighborList(
        idx=ti, mask=tm, dist=torch.where(tm, (disp ** 2).sum(-1), 0.0),
        count=T(count), disp=disp)
    out = cconv.continuous_conv(
        k_, p_, p_, f_, tnl, ext, window_fn=windows.get_window_func(win),
        symmetric=symmetric, query_features=q_ if symmetric else None)
    got = torch.autograd.grad(out, leaves, T(dout), allow_unused=True)
    got = [np.zeros_like(w) if g is None else g.numpy()
           for g, w in zip(got, want)]
    geom = cconv.klist_geometry(tnl, ext, kern.shape[:3],
                                window_fn=windows.get_window_func(win))
    return want, got, T(dout), geom, T(qf)


def _close(got, want, what):
    scale = np.abs(want).max()
    assert scale > 0, what
    np.testing.assert_allclose(got, want, atol=1e-5 * scale, err_msg=what)


@pytest.mark.parametrize("symmetric,ksize,dim", [
    (False, (4, 4, 4), 3), (True, (1, 8, 8), 2)])
def test_klist_conv_vjp_matches_jax(symmetric, ksize, dim):
    from dmcf_tpu_torch.kernels.cconv_klist import cconv_klist_bwd_reference
    rng = np.random.RandomState(12)
    pts = random_cloud(rng, 200, dim=dim)
    feats = rng.randn(200, 6).astype(np.float32)
    kern = (rng.randn(*ksize, 6, 3) * 0.1).astype(np.float32)
    if symmetric:
        kern = np.asarray(jcc.build_symmetric_kernel(
            jnp.asarray(kern[:, :4]), 1))
    nl = jax.jit(lambda p: jnb.fixed_radius_search(
        p, p, 0.075, 24, ignore_query_point=symmetric))(jnp.asarray(pts))
    win = "peak" if symmetric else "poly6"
    want, got, dout, (idx, a, t), qf = _vjp_both(pts, feats, kern, nl,
                                                 symmetric, win)
    names = ["kernel", "features", "query features"]
    for g, w, name in zip(got[:3], want[:3], names):
        if name != "query features" or symmetric:
            _close(g, w, name)
    _close(got[3][:, :2], want[3][:, :2], "x/y positions")
    if dim == 3:
        _close(got[3][:, 2], want[3][:, 2], "z positions")
    # the plain backward on the contract: filter, features, query features
    dfeats, dqfeats, dw, da, dt = cconv_klist_bwd_reference(
        dout, idx, a, t, T(feats), T(kern).reshape(-1, 3), ksize,
        qf if symmetric else None)
    _close(dw.reshape(kern.shape).numpy(), want[0], "reference dw")
    _close(dfeats.numpy(), want[1], "reference dfeats")
    if symmetric:
        _close(dqfeats.numpy(), want[2], "reference dqfeats")
    assert da.shape == a.shape and dt.shape == t.shape
    assert float(da.abs().max()) > 0 and float(dt.abs().max()) > 0


def test_klist_conv_vjp_clamped_idx_lands_in_last_row():
    """obs_conv's out-of-range gather (ROADMAP §3): a slot whose index is
    past the feature rows reads row N-1, so the port's gradient (the twin's
    autograd and ``cconv_klist_bwd_reference``) adds that slot into row
    N-1.  JAX's forward reads row N-1 too, but the VJP of its gather drops
    out-of-range slots: the two agree on every other row, and on row N-1
    differ by exactly the clamped slots' share.  In the model only
    obs_conv's box features meet this, and they take no gradient."""
    from dmcf_tpu_torch.kernels.cconv_klist import cconv_klist_bwd_reference
    rng, pts, _, ext, nl = _conv_inputs(6, q=128, k=8)
    feats = rng.randn(40, 4).astype(np.float32)
    kern = (rng.randn(1, 4, 4, 4, 3) * 0.1).astype(np.float32)
    want, got, dout, (idx, a, t), _ = _vjp_both(pts, feats, kern, nl,
                                                False, "poly6", ext)
    assert int(idx.max()) >= 40
    _close(got[0], want[0], "kernel")
    _close(got[1][:39], want[1][:39], "features, rows < N-1")
    w2 = T(kern).reshape(-1, 3)
    dfeats = cconv_klist_bwd_reference(dout, idx, a, t, T(feats), w2,
                                       (1, 4, 4))[0].numpy()
    np.testing.assert_allclose(dfeats, got[1], atol=1e-6)
    clamped = cconv_klist_bwd_reference(
        dout, idx, torch.where(idx >= 40, a, 0.0), t, T(feats), w2,
        (1, 4, 4))[0].numpy()
    assert not clamped[:39].any() and np.abs(clamped[39]).max() > 1e-2
    np.testing.assert_allclose(got[1][39], want[1][39] + clamped[39],
                               atol=1e-5 * np.abs(got[1]).max())


def test_klist_conv_vjp_2d_kink_convention():
    """On a 2D config the z axis has size 1: t_z is clamped to [0, 0] and
    sits on the kinks of both the clamp and |.|.  The port's hats follow
    PyTorch autograd (clamp' 1 at a bound, |u|'(0) = 0): its gradient in
    t_z is exactly 0, where JAX's subgradients (clip' 1/4 at a degenerate
    bound, |u|'(0) = 1) give -1/4 per hat.  Neither reaches the positions:
    t_z is z scaled by (1 - 1) / 2 = 0, so both packages' z position
    gradients are 0, and x/y agree."""
    from dmcf_tpu_torch.kernels.cconv_klist import cconv_klist_bwd_reference
    rng = np.random.RandomState(13)
    pts = random_cloud(rng, 150, dim=2)
    feats = rng.randn(150, 4).astype(np.float32)
    kern = (rng.randn(1, 4, 4, 4, 3) * 0.1).astype(np.float32)
    nl = jax.jit(lambda p: jnb.fixed_radius_search(p, p, 0.075, 24))(
        jnp.asarray(pts))
    want, got, dout, (idx, a, t), _ = _vjp_both(pts, feats, kern, nl,
                                                False, "poly6")
    _close(got[3][:, :2], want[3][:, :2], "x/y positions")
    assert not got[3][:, 2].any() and not want[3][:, 2].any()
    assert not t[..., 0].any()
    _, _, _, da, dt = cconv_klist_bwd_reference(
        dout, idx, a, t, T(feats), T(kern).reshape(-1, 3), (1, 4, 4))
    assert not dt[..., 0].any() and dt[..., 1:].abs().max() > 0
    jgrad = jax.grad(lambda x: jcoords.axis_interp_weights(
        x, 1, "linear").sum())(0.0)
    tz = torch.zeros((), requires_grad=True)
    (tgrad,) = torch.autograd.grad(
        coords.axis_interp_weights(tz, 1, "linear").sum(), tz)
    assert float(jgrad) == -0.25 and float(tgrad) == 0.0
