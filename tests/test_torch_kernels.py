"""The port's hand-written CUDA kernels against their plain PyTorch twins
on the card.  CUDA-only: each test skips where no GPU is present (a CUDA
kernel has no CPU or interpret mode); run them on a GPU machine with
``python -m pytest --noconftest tests/test_torch_kernels.py -q`` (the
suite's conftest sets up JAX, which a GPU machine need not have).

Tolerance 2e-5 absolute: the kernel sums the K slots and the S*Cin filter
product in another order than the twin's einsum/matmul (fp32, TF32 off).
"""

import numpy as np
import pytest
import torch

from dmcf_tpu_torch.kernels.cconv_klist import (cconv_klist,
                                                cconv_klist_reference)
from dmcf_tpu_torch.ops import cconv, coords, neighbors, windows
from dmcf_tpu_torch.models.pbf import drop_coincident

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
