"""The port's hand-written CUDA kernels against their plain PyTorch twins
on the card.  CUDA-only: each test skips where no GPU is present (a CUDA
kernel has no CPU or interpret mode); run them on a GPU machine with
``python -m pytest --noconftest tests/test_torch_kernels.py -q`` (the
suite's conftest sets up JAX, which a GPU machine need not have).

Tolerances: the forward 2e-5 absolute (the kernel sums the K slots and the
S*Cin filter product in another order than the twin's einsum/matmul; fp32,
TF32 off); each backward gradient within 1e-5 of that gradient's largest
reference entry (sums over slots and queries in another order, float
atomics); a train step's parameter gradients, card against CPU, within
1e-4 of each tensor's largest (fp32 through a two-step window of 25 convs).
The bf16 variants: the forward within 1e-4 of max |out| (sums taken in
another order before T's bf16 rounding can move an element of T by one
bf16 step); each backward gradient within 2e-3 of its max, where dfeats
and dW, rounded to bf16 last, are compared apart from elements exactly one
bf16 step from the plain version's (at most max(4, 1e-3 of them)); a
train step's gradients card against CPU within 2e-2 of each tensor's max.
"""

import numpy as np
import pytest
import torch

from dmcf_tpu_torch.kernels.cconv_klist import (cconv_klist,
                                                cconv_klist_bwd_data,
                                                cconv_klist_bwd_filter,
                                                cconv_klist_bwd_reference,
                                                cconv_klist_reference,
                                                rounding_flips)
from dmcf_tpu_torch.ops import cconv, coords, neighbors, windows
from dmcf_tpu_torch.models.pbf import drop_coincident

# two intra-op threads: the suite runs files side by side on a few cores
torch.set_num_threads(2)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def w_scale(cin):
    """Filter scale that keeps the output O(1) at any Cin, so the absolute
    tolerance stays meaningful for the deep filter products."""
    return 0.1 * min(1.0, (32 / cin) ** 0.5)


def _edge_points(size):
    """Filter coordinates of one axis on its edges: tap centres, half-way
    points, +-h, beyond the clamp, and their float neighbours."""
    half = 0.5 * (size - 1)
    pts = np.concatenate([np.arange(size) - half, np.arange(size) - half
                          + 0.5, [-half, half, -half - 0.4, half + 0.4,
                                  -7.0, 7.0]]).astype(np.float32)
    return np.concatenate([pts, np.nextafter(pts, np.float32(np.inf)),
                           np.nextafter(pts, np.float32(-np.inf)),
                           pts - np.float32(2 ** -24)])


def edge_inputs(q, k, cin, cout, ksize, symmetric, seed):
    """Contract inputs whose filter coordinates sit on the hats' edges,
    with empty slots (a == 0, t non-zero) and one query whose slots are
    all empty."""
    rng = np.random.RandomState(seed)
    t = np.stack([rng.choice(_edge_points(s), (q, k)) for s in ksize], -1)
    a = rng.uniform(0.05, 1.0, (q, k)).astype(np.float32)
    a[rng.rand(q, k) < 0.3] = 0.0
    a[0] = 0.0
    feats = rng.randn(q, cin).astype(np.float32)
    idx = rng.randint(0, q, (q, k)).astype(np.int32)
    w = (rng.randn(int(np.prod(ksize)) * cin, cout)
         * w_scale(cin)).astype(np.float32)
    T = torch.from_numpy
    return [T(x) for x in (idx, a, t.astype(np.float32), feats, w)], \
        (T(feats) if symmetric else None)


def klist_inputs(q, k, cin, cout, ksize, window, symmetric, seed, device,
                 geometry="search"):
    """Contract inputs from a real neighbor search over a 2D/3D cloud, or
    (``geometry="edges"``) on the hats' edge points."""
    if geometry == "edges":
        xs, qf = edge_inputs(q, k, cin, cout, ksize, symmetric, seed)
    else:
        g = torch.Generator().manual_seed(seed)
        dim = 2 if ksize[0] == 1 else 3
        pts = torch.rand((q, 3), generator=g) * 0.6 - 0.3
        pts[:, dim:] = 0.0
        # ~9 neighbors per point in 2D: well inside K, so lists are
        # symmetric
        radius = 0.02 if dim == 2 else 0.12
        nl = neighbors.search(pts, pts, radius, k)
        if symmetric:
            nl = drop_coincident(nl)
        feats = torch.randn((q, cin), generator=g)
        idx, a, t = cconv.klist_geometry(
            nl, 2 * radius, ksize, window_fn=windows.get_window_func(window))
        w = torch.randn((int(np.prod(ksize)) * cin, cout),
                        generator=g) * w_scale(cin)
        xs, qf = [idx, a, t, feats, w], (feats if symmetric else None)
    to = lambda x: None if x is None else x.to(device)  # noqa: E731
    return [to(x) for x in xs], to(qf)


CASES = [  # q, k, cin, cout, ksize, window, symmetric, geometry
    (2688, 40, 32, 32, (1, 8, 8), "poly6", False, "search"),  # widest trunk
    (2688, 40, 32, 2, (1, 8, 8), "peak", True, "search"),     # ASCC layer
    (2688, 40, 4, 8, (1, 8, 8), "poly6", False, "search"),    # scale-0 convs
    (1344, 40, 16, 16, (1, 8, 8), "poly6", False, "search"),
    (300, 96, 32, 3, (6, 6, 6), "peak", True, "search"),      # Liquid3d ASCC
    (130, 20, 8, 4, (4, 4, 4), "poly6", False, "search"),     # ragged tail
    # geometry edges: taps on centres, half-way, at and beyond +-h, empty
    # slots with non-zero t, a query with every slot empty
    (200, 40, 32, 32, (1, 8, 8), None, False, "edges"),
    (200, 40, 32, 2, (1, 8, 8), None, True, "edges"),
    (100, 24, 8, 5, (4, 4, 4), None, False, "edges"),
    (100, 24, 4, 3, (6, 6, 6), None, True, "edges"),
    # contract corners: Cin, Cout, S*Cin = 8192 (by tap rows and by
    # channels), K, kernel sizes
    (257, 40, 1, 8, (1, 8, 8), "poly6", False, "search"),
    (257, 40, 3, 8, (1, 8, 8), "poly6", False, "search"),
    (257, 40, 24, 16, (1, 8, 8), "poly6", False, "search"),
    (257, 40, 64, 32, (1, 8, 8), "poly6", False, "search"),
    (257, 40, 16, 1, (1, 8, 8), "poly6", False, "search"),
    (257, 40, 16, 2, (1, 8, 8), "poly6", False, "search"),
    (257, 40, 16, 3, (1, 8, 8), "poly6", False, "search"),
    (257, 40, 16, 64, (1, 8, 8), "poly6", False, "search"),
    (257, 40, 16, 256, (1, 8, 8), "poly6", False, "search"),
    (257, 40, 128, 256, (1, 8, 8), "poly6", False, "search"),
    (130, 40, 8192, 4, (1, 1, 1), "poly6", False, "search"),
    (130, 40, 8192, 3, (1, 1, 1), "poly6", True, "search"),
    (200, 40, 8, 8, (4, 4, 4), "poly6", True, "edges"),
    (257, 1, 16, 8, (1, 8, 8), "poly6", False, "search"),
    (257, 33, 16, 8, (1, 8, 8), "poly6", False, "search"),
    (257, 96, 16, 8, (1, 8, 8), "poly6", True, "search"),
    (257, 40, 8, 8, (1, 8, 1), "poly6", False, "search"),
    (257, 40, 8, 8, (4, 8, 1), "poly6", False, "search"),
    (257, 40, 8, 8, (1, 4, 4), "poly6", False, "search"),
    (257, 40, 8, 8, (4, 4, 4), "poly6", True, "search"),
    (257, 40, 32, 8, (6, 6, 6), "poly6", False, "search"),
]


@pytest.mark.parametrize("q,k,cin,cout,ksize,window,symmetric,geometry",
                         CASES)
def test_kernel_matches_twin(cuda, q, k, cin, cout, ksize, window,
                             symmetric, geometry):
    (idx, a, t, feats, w), qf = klist_inputs(q, k, cin, cout, ksize, window,
                                             symmetric, 0, cuda, geometry)
    before = cconv_klist.launches
    got = cconv_klist(idx, a, t, feats, w, ksize, qfeats=qf)
    torch.cuda.synchronize()
    assert cconv_klist.launches == before + 1
    ref = cconv_klist_reference(idx, a, t, feats, w, ksize, qfeats=qf)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, ref, atol=2e-5, rtol=0)


@pytest.mark.parametrize("q,n,k,cin,cout", [
    (80, 320, 256, 24, 4),     # conv120_0: scale 0 -> 2, gap 2
    (80, 320, 256, 16, 8),     # conv220_0
    (160, 320, 96, 24, 8),     # conv110_0: scale 0 -> 1, gap 1
    (160, 320, 96, 16, 16),    # conv210_0
    (80, 160, 96, 8, 8),       # conv220_1: scale 1 -> 2
])
def test_kernel_matches_twin_long_lists(cuda, q, n, k, cin, cout):
    """The downsampling pairs of configs/other/momentum.yml, which run the
    K-list kernel at K 96 and K 256 (no dense pairs there), at that
    model's Q, N, Cin and Cout, with long lists: N points in a square, Q
    queries among them, the radius sized to ~0.8 K points (edge queries
    see fewer: lists hold about half of K on average and over 3/4 of K at
    the longest)."""
    g = torch.Generator().manual_seed(k + cin)
    side = 0.1
    pts = torch.rand((n, 3), generator=g) * side
    pts[:, 2] = 0.0
    radius = side * (0.8 * k / (n * np.pi)) ** 0.5
    nl = neighbors.search(pts, pts[:q], radius, k)
    assert int(nl.mask.sum(1).max()) > k * 3 // 4
    idx, a, t = cconv.klist_geometry(nl, 2 * radius, (1, 8, 8),
                                     window_fn=windows.get_window_func(
                                         "poly6"))
    feats = torch.randn((n, cin), generator=g)
    w = torch.randn((64 * cin, cout), generator=g) * w_scale(cin)
    xs = [x.to(cuda) for x in (idx, a, t, feats, w)]
    got = cconv_klist(*xs, (1, 8, 8))
    ref = cconv_klist_reference(*xs, (1, 8, 8))
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, ref, atol=2e-5, rtol=0)


BF16_CASES = [c for c in CASES if not c[6]]  # the bf16 variant has no
#   symmetric form


@pytest.mark.parametrize("q,k,cin,cout,ksize,window,symmetric,geometry",
                         BF16_CASES)
def test_bf16_kernel_matches_twin(cuda, q, k, cin, cout, ksize, window,
                                  symmetric, geometry):
    """The bf16 variant against its plain twin (the same casts), two
    launches bitwise equal, one bf16 launch counted."""
    (idx, a, t, feats, w), _ = klist_inputs(q, k, cin, cout, ksize, window,
                                            False, 0, cuda, geometry)
    before = (cconv_klist.launches, cconv_klist.launches_bf16)
    got = cconv_klist(idx, a, t, feats, w, ksize, precision="default")
    again = cconv_klist(idx, a, t, feats, w, ksize, precision="default")
    torch.cuda.synchronize()
    assert (cconv_klist.launches, cconv_klist.launches_bf16) == \
        (before[0], before[1] + 2)
    assert got.dtype == torch.float32 and torch.equal(got, again)
    ref = cconv_klist_reference(idx, a, t, feats, w, ksize,
                                precision="default")
    assert torch.isfinite(got).all()
    scale = float(ref.abs().max())
    assert float((got - ref).abs().max()) <= 1e-4 * scale
    # bf16 inputs are taken as they are
    torch.testing.assert_close(
        cconv_klist(idx, a, t, feats.bfloat16(), w.bfloat16(), ksize,
                    precision="default"), got, atol=0, rtol=0)


@pytest.mark.parametrize("q,n,k,cin,cout", [
    (80, 320, 256, 24, 4), (160, 320, 96, 24, 8), (80, 160, 96, 8, 8)])
def test_bf16_kernel_matches_twin_long_lists(cuda, q, n, k, cin, cout):
    """The momentum model's K 96 and K 256 pairs at bf16."""
    xs = long_list_inputs(q, n, k, cin, cout, k + cin, cuda)
    got = cconv_klist(*xs, (1, 8, 8), precision="default")
    ref = cconv_klist_reference(*xs, (1, 8, 8), precision="default")
    assert torch.isfinite(got).all()
    assert float((got - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


def test_bf16_kernel_rejects_symmetric(cuda):
    (idx, a, t, feats, w), qf = klist_inputs(256, 16, 8, 4, (1, 8, 8),
                                             "poly6", True, 2, cuda)
    with pytest.raises(NotImplementedError):
        cconv_klist(idx, a, t, feats, w, (1, 8, 8), qfeats=qf,
                    precision="default")


@pytest.mark.parametrize("cout,symmetric", [(32, False), (2, True)])
def test_kernel_is_deterministic(cuda, cout, symmetric):
    """Two launches on the same inputs give equal bits (no float atomics:
    each T element is summed by one lane in slot order)."""
    (idx, a, t, feats, w), qf = klist_inputs(2688, 40, 32, cout, (1, 8, 8),
                                             "poly6", symmetric, 4, cuda)
    first = cconv_klist(idx, a, t, feats, w, (1, 8, 8), qfeats=qf)
    second = cconv_klist(idx, a, t, feats, w, (1, 8, 8), qfeats=qf)
    assert torch.equal(first, second)


def test_kernel_symmetric_momentum(cuda):
    (idx, a, t, feats, _), qf = klist_inputs(2688, 40, 32, 2, (1, 8, 8),
                                             "peak", True, 1, cuda)
    half = torch.randn((1, 4, 8, 32, 2), device=cuda) * 0.1
    w = cconv.build_symmetric_kernel(half, 1).reshape(-1, 2).contiguous()
    out = cconv_klist(idx, a, t, feats.abs().contiguous(), w, (1, 8, 8),
                      qfeats=qf.abs().contiguous())
    ratio = out.sum(0).abs() / out.abs().sum()
    assert bool((ratio < 1e-5).all()), ratio


def test_kernel_rejects_bad_inputs(cuda):
    (idx, a, t, feats, w), _ = klist_inputs(256, 16, 8, 4, (1, 8, 8),
                                            "poly6", False, 2, cuda)
    with pytest.raises(TypeError):
        cconv_klist(idx.long(), a, t, feats, w, (1, 8, 8))
    with pytest.raises(ValueError):
        cconv_klist(idx, a, t, feats.t().contiguous().t(), w, (1, 8, 8))
    with pytest.raises(ValueError):
        cconv_klist(idx, a.cpu(), t, feats, w, (1, 8, 8))


def test_kernel_clamps_out_of_range_idx(cuda):
    """Indices past the feature rows read the last row, as JAX's clamped
    gather does, and negative ones the first, a safety clamp of the port
    only (JAX would wrap them); never memory outside ``feats``."""
    (idx, a, t, feats, w), _ = klist_inputs(256, 16, 8, 4, (1, 8, 8),
                                            "poly6", False, 3, cuda)
    small = feats[:40].contiguous()
    idx = torch.where(idx % 7 == 3, -idx - 1, idx).contiguous()
    assert int(idx.max()) >= 40 and int(idx.min()) < 0
    got = cconv_klist(idx, a, t, small, w, (1, 8, 8))
    ref = cconv_klist(idx.clamp(0, 39), a, t, small, w, (1, 8, 8))
    torch.testing.assert_close(got, ref, atol=0, rtol=0)
    torch.testing.assert_close(
        got, cconv_klist_reference(idx, a, t, small, w, (1, 8, 8)),
        atol=2e-5, rtol=0)


def test_hats_mirror_on_card(cuda):
    """The mirror property survives the move to the card."""
    t = torch.linspace(-4.5, 4.5, 1001, device=cuda)
    w = coords.axis_interp_weights(t, 8, "linear")
    assert torch.equal(coords.axis_interp_weights(-t, 8, "linear"),
                       torch.flip(w, dims=(-1,)))


def long_list_inputs(q, n, k, cin, cout, seed, device):
    """The momentum model's downsampling-pair shape: N points in a square,
    Q queries among them, the radius sized to ~0.8 K points."""
    g = torch.Generator().manual_seed(seed)
    side = 0.1
    pts = torch.rand((n, 3), generator=g) * side
    pts[:, 2] = 0.0
    radius = side * (0.8 * k / (n * np.pi)) ** 0.5
    nl = neighbors.search(pts, pts[:q], radius, k)
    idx, a, t = cconv.klist_geometry(nl, 2 * radius, (1, 8, 8),
                                     window_fn=windows.get_window_func(
                                         "poly6"))
    feats = torch.randn((n, cin), generator=g)
    w = torch.randn((64 * cin, cout), generator=g) * w_scale(cin)
    return [x.to(device) for x in (idx, a, t, feats, w)]


BWD_CASES = [  # q, n, k, cin, cout, ksize, symmetric, geometry
    (2688, 2688, 40, 32, 32, (1, 8, 8), False, "search"),  # trunk
    (2688, 2688, 40, 32, 2, (1, 8, 8), True, "search"),    # ASCC
    (2688, 2688, 40, 4, 8, (1, 8, 8), False, "search"),
    (320, 320, 48, 16, 8, (1, 8, 8), False, "search"),     # momentum K 48
    (160, 320, 96, 24, 8, (1, 8, 8), False, "long"),       # K 96
    (80, 320, 256, 24, 4, (1, 8, 8), False, "long"),       # K 256
    (80, 320, 256, 16, 8, (1, 8, 8), True, "long"),
    (200, 200, 40, 32, 32, (1, 8, 8), False, "edges"),
    (200, 200, 40, 8, 3, (4, 4, 4), True, "edges"),
    (130, 130, 40, 8192, 3, (1, 1, 1), True, "search"),
    (257, 257, 40, 128, 256, (1, 8, 8), False, "search"),
    (257, 257, 40, 16, 3, (1, 8, 8), False, "search"),     # Cout % 4 != 0
]


@pytest.mark.parametrize("q,n,k,cin,cout,ksize,symmetric,geometry",
                         BWD_CASES)
def test_bwd_kernels_match_reference(cuda, q, n, k, cin, cout, ksize,
                                     symmetric, geometry):
    if geometry == "long":
        idx, a, t, feats, w = long_list_inputs(q, n, k, cin, cout, k + cin,
                                               cuda)
        qf = feats[:q].contiguous() if symmetric else None
    else:
        (idx, a, t, feats, w), qf = klist_inputs(
            q, k, cin, cout, ksize, "poly6", symmetric, 7, cuda, geometry)
    dout = torch.randn((q, cout), device=cuda)
    before = (cconv_klist_bwd_data.launches, cconv_klist_bwd_filter.launches)
    args = (dout, idx, a, t, feats, w, ksize, qf)
    dfeats, dqfeats, da, dt = cconv_klist_bwd_data(*args)
    dw = cconv_klist_bwd_filter(*args)
    torch.cuda.synchronize()
    assert (cconv_klist_bwd_data.launches,
            cconv_klist_bwd_filter.launches) == (before[0] + 1,
                                                 before[1] + 1)
    ref = cconv_klist_bwd_reference(*args)
    for name, got, want in zip(("dfeats", "dqfeats", "dw", "da", "dt"),
                               (dfeats, dqfeats, dw, da, dt), ref):
        if want is None:
            assert got is None, name
            continue
        assert torch.isfinite(got).all(), name
        # a zero gradient (dt of a [1, 1, 1] kernel: size-1 axes have no
        # slope) must come out exactly zero
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        assert err <= 1e-5 * scale, (name, err, scale)


def check_bf16_grads(got, ref, tol=2e-3):
    """The bf16 backward's gradients against the plain backward's: dfeats
    and dw (rounded to bf16 last) apart from one-step rounding flips (~1e-4
    of the elements on the card; at most max(4, 1e-3 of them)), da and dt
    within ``tol`` of their max."""
    for name, g, want in zip(("dfeats", "dqfeats", "dw", "da", "dt"), got,
                             ref):
        if want is None:
            assert g is None, name
            continue
        assert torch.isfinite(g.float()).all(), name
        scale = float(want.abs().max())
        if name in ("dfeats", "dw"):
            assert g.dtype == torch.bfloat16, name
            err, flips = rounding_flips(g, want)
            assert flips <= max(4, 1e-3 * want.numel()), (name, flips)
        else:
            err = float((g - want).abs().max())
        assert err <= tol * scale, (name, err, scale)


@pytest.mark.parametrize("q,n,k,cin,cout,ksize,symmetric,geometry",
                         [c for c in BWD_CASES if not c[6]])
def test_bf16_bwd_kernels_match_reference(cuda, q, n, k, cin, cout, ksize,
                                          symmetric, geometry):
    if geometry == "long":
        idx, a, t, feats, w = long_list_inputs(q, n, k, cin, cout, k + cin,
                                               cuda)
    else:
        (idx, a, t, feats, w), _ = klist_inputs(
            q, k, cin, cout, ksize, "poly6", False, 7, cuda, geometry)
    dout = torch.randn((q, cout), device=cuda)
    counts = [(f.launches, f.launches_bf16)
              for f in (cconv_klist_bwd_data, cconv_klist_bwd_filter)]
    args = (dout, idx, a, t, feats, w, ksize, None)
    dfeats, dqfeats, da, dt = cconv_klist_bwd_data(*args,
                                                   precision="default")
    dw = cconv_klist_bwd_filter(*args, precision="default")
    torch.cuda.synchronize()
    assert [(f.launches, f.launches_bf16) for f in
            (cconv_klist_bwd_data, cconv_klist_bwd_filter)] == \
        [(c[0], c[1] + 1) for c in counts]
    check_bf16_grads((dfeats, dqfeats, dw, da, dt),
                     cconv_klist_bwd_reference(*args, precision="default"))


def test_bwd_kernels_clamped_idx(cuda):
    """Out-of-range indices: the gradient of a slot that read row N-1 lands
    in row N-1, as in the plain backward."""
    (idx, a, t, feats, w), _ = klist_inputs(256, 16, 8, 4, (1, 8, 8),
                                            "poly6", False, 3, cuda)
    small = feats[:40].contiguous()
    assert int(idx.max()) >= 40
    dout = torch.randn((256, 4), device=cuda)
    args = (dout, idx, a, t, small, w, (1, 8, 8))
    dfeats = cconv_klist_bwd_data(*args)[0]
    dw = cconv_klist_bwd_filter(*args)
    rf, _, rw, _, _ = cconv_klist_bwd_reference(*args)
    assert float(dfeats[39].abs().max()) > 0
    torch.testing.assert_close(dfeats, rf, rtol=0,
                               atol=1e-5 * float(rf.abs().max()))
    torch.testing.assert_close(dw, rw, rtol=0,
                               atol=1e-5 * float(rw.abs().max()))


def test_autograd_runs_the_bwd_kernels(cuda):
    """Under autograd a CUDA K-list conv launches its forward kernel once
    and, in the backward, the data kernel and the filter kernel once each;
    the gradients are the plain backward's."""
    (idx, a, t, feats, w), qf = klist_inputs(512, 24, 8, 4, (1, 8, 8),
                                             "poly6", True, 5, cuda)
    leaves = [x.clone().requires_grad_(True) for x in (a, t, feats, w, qf)]
    counts = [f.launches for f in (cconv_klist, cconv_klist_bwd_data,
                                   cconv_klist_bwd_filter)]
    out = cconv_klist(idx, *leaves[:4], (1, 8, 8), qfeats=leaves[4])
    dout = torch.randn_like(out)
    out.backward(dout)
    assert [f.launches for f in (cconv_klist, cconv_klist_bwd_data,
                                 cconv_klist_bwd_filter)] == \
        [c + 1 for c in counts]
    dfeats, dqfeats, dw, da, dt = cconv_klist_bwd_reference(
        dout, idx, a, t, feats, w, (1, 8, 8), qf)
    for got, want in zip([x.grad for x in leaves],
                         (da, dt, dfeats, dw, dqfeats)):
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-5 * float(want.abs().max()))


def test_autograd_runs_the_bf16_bwd_kernels(cuda):
    """Under autograd a bf16 CUDA K-list conv launches the bf16 forward
    kernel once and, in the backward, both bf16 backward kernels once; the
    fp32 leaves get the plain backward's gradients (feats and w rounded to
    bf16, as JAX's are)."""
    (idx, a, t, feats, w), _ = klist_inputs(512, 24, 8, 4, (1, 8, 8),
                                            "poly6", False, 5, cuda)
    leaves = [x.clone().requires_grad_(True) for x in (a, t, feats, w)]
    fns = (cconv_klist, cconv_klist_bwd_data, cconv_klist_bwd_filter)
    counts = [(f.launches, f.launches_bf16) for f in fns]
    out = cconv_klist(idx, *leaves, (1, 8, 8), precision="default")
    dout = torch.randn_like(out)
    out.backward(dout)
    assert [(f.launches, f.launches_bf16) for f in fns] == \
        [(c[0], c[1] + 1) for c in counts]
    dfeats, _, dw, da, dt = cconv_klist_bwd_reference(
        dout, idx, a, t, feats, w, (1, 8, 8), precision="default")
    got = [x.grad for x in leaves]
    assert all(g.dtype == torch.float32 for g in got)
    check_bf16_grads((got[2].bfloat16(), None, got[3].bfloat16(), got[0],
                      got[1]), (dfeats, None, dw, da, dt))


@pytest.mark.parametrize("precision", ["highest", "default"])
def test_symnet_train_step_grads_match_cpu(cuda, precision):
    """The gradient-cut fault closed: a two-step BPTT train step of a
    narrow momentum SymNet on the card gives every trunk and ASCC conv
    weight a non-zero gradient, equal to the CPU path's (the boundary conv
    sees no neighbour in these scenes and learns nothing on either), with
    the trunk in fp32 and in bf16."""
    import copy
    import os

    import yaml

    from dmcf_tpu_torch.data import batch_samples, gen_momentum_data
    from dmcf_tpu_torch.models import build_model
    from dmcf_tpu_torch.models.layers import ContinuousConv
    from dmcf_tpu_torch.models.losses import get_loss
    from dmcf_tpu_torch.pipelines.simulator import (make_optimizer,
                                                    make_train_step)

    root = os.path.join(os.path.dirname(__file__), "..")
    with open(os.path.join(root, "configs", "other", "momentum.yml")) as f:
        cfg = yaml.safe_load(f)["model"]
    cfg.update(kernel_size=[1, 4, 4], sym_kernel_size=[1, 4, 4],
               strides=[1, 2], particle_radii=[0.02, 0.04],
               scale_size_factor=[1.0, 0.5], out_scale=[1e-2, 1e-2, 0.0],
               neighbor_k=16, neighbor_k_gaps=[32],
               layer_channels=[[[4]], [[4], [4]], [[4], [4]], [[4]], [[2]]])
    np.random.seed(42)
    scene = gen_momentum_data(data_cnt=1, timesteps=6, res=100, radius=12,
                              dt=0.0025, speed=30.0)[0]
    items = []
    for st in (0, 2):
        fr = scene[st:st + 3]
        items.append({
            "pos": np.stack([f["pos"] for f in fr]) * np.float32(0.9),
            "vel": np.stack([f["vel"] for f in fr]) * np.float32(0.9),
            "grav": None, "pre": 0,
            "box": np.asarray(scene[0]["box"], np.float32).reshape(-1, 3),
            "box_normals": np.zeros((1, 3), np.float32)})
    batch = {k: torch.as_tensor(v) for k, v in batch_samples(items).items()
             if v is not None}
    loss = {"weighted_mse": get_loss(**cfg["loss"]["weighted_mse"])}
    grads = []
    # seed 42, run_pipeline's default (this narrow net's seed-0 weights
    # leave every ReLU before the ASCC layer closed: no gradient anywhere)
    cfg["precision"] = precision
    model = build_model(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(42))
    bf16 = precision == "default"
    for dev in (cuda, torch.device("cpu")):
        m = copy.deepcopy(model).to(dev)
        opt, sch = make_optimizer(m, {})
        fns = (cconv_klist_bwd_data, cconv_klist_bwd_filter)
        counts = [(f.launches, f.launches_bf16) for f in fns]
        make_train_step(m, loss, opt, sch, window=2)(
            {k: v.to(dev) for k, v in batch.items()}, np.ones(2, np.float32))
        if dev.type == "cuda":
            # 2 items x 2 steps x 11 convs: the filter kernel every time,
            # the data kernel but for the 2 scale-0 convs of step 0; at
            # bf16 the ASCC conv (1 of the 11) stays fp32
            got = [(f.launches - c[0], f.launches_bf16 - c[1])
                   for f, c in zip(fns, counts)]
            assert got == ([(4, 36), (4, 40)] if bf16 else
                           [(40, 0), (44, 0)]), got
        grads.append({n: p.grad.cpu() for n, p in m.named_parameters()})
    convs = [n for n, mod in model.named_modules()
             if isinstance(mod, ContinuousConv) and n != "obs_conv"]
    for name, want in grads[1].items():
        scale = float(want.abs().max())
        err = float((grads[0][name] - want).abs().max())
        assert err <= (2e-2 if bf16 else 1e-4) * scale, (name, err, scale)
    for name in convs:
        assert float(grads[0][f"{name}.kernel"].abs().max()) > 0, name
