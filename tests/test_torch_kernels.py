"""The port's hand-written CUDA kernels against their plain PyTorch twins
on the card.  CUDA-only: each test skips where no GPU is present (a CUDA
kernel has no CPU or interpret mode); run them on a GPU machine with
``python -m pytest --noconftest tests/test_torch_kernels.py -q`` (the
suite's conftest sets up JAX, which a GPU machine need not have).

Tolerances: the forward 2e-5 absolute (the kernel sums the K slots and the
S*Cin filter product in another order than the twin's einsum/matmul; fp32,
TF32 off); each backward gradient within 1e-5 of that gradient's largest
reference entry (sums over slots and queries in another order; every
kernel is deterministic, two launches bitwise equal); a train step's
parameter gradients, card against CPU, within 1e-4 of each tensor's
largest (fp32 through a two-step window of 25 convs).
The bf16 variants: the forward within 1e-4 of max |out| (sums taken in
another order before T's bf16 rounding can move an element of T by one
bf16 step); each backward gradient within 2e-3 of its max, where dfeats
and dW, rounded to bf16 last, are compared apart from elements exactly one
bf16 step from the plain version's (at most max(4, 1e-3 of them)), and da
and dt as the forward's T is held: the data kernel's dT (tensor cores,
another sum order) one bf16 step from the plain dT at most max(4, 1e-3 of
its elements), da and dt within 2e-3 of the max against the plain
backward fed the kernel's dT, and beyond it against the plain backward
itself only where dT flips were counted (``check_bf16_grads``); a train
step's gradients card against CPU within 2e-2 of each tensor's max.
The farthest-point kernel picks the plain version's rows bit for bit.
The interpolation modes linear_border and nearest_neighbor (every
variant, forward and backward) are held as linear is, at the same
tolerances, on lists whose filter coordinates pass the span's ends
(``align_corners=False``) and on the hats' edge points (exact ties of
nearest_neighbor among them).
"""

import os
import sys

import numpy as np
import pytest
import torch

from dmcf_tpu_torch.kernels.cconv_klist import (_bwd_data_launch,
                                                cconv_klist,
                                                cconv_klist_bwd_data,
                                                cconv_klist_bwd_filter,
                                                cconv_klist_bwd_reference,
                                                cconv_klist_reference,
                                                bf16_data_flips,
                                                rounding_flips,
                                                transposed_slots)
from dmcf_tpu_torch.ops import cconv, coords, neighbors, windows
from dmcf_tpu_torch.models.pbf import drop_coincident

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from chip_smoke import fps_cases, fps_sets  # noqa: E402

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
    """Contract inputs from a real neighbor search over a 2D/3D cloud (with
    ``geometry="outside"`` mapped by the identity, ``align_corners=False``:
    the filter coordinates reach past the span's ends), or
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
        outside = dict(coordinate_mapping="identity", align_corners=False)
        idx, a, t = cconv.klist_geometry(
            nl, 2 * radius, ksize, window_fn=windows.get_window_func(window),
            **(outside if geometry == "outside" else {}))
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


def check_bf16_grads(got, ref, inputs, tol=2e-3, interpolation="linear"):
    """The bf16 backward's gradients against the plain backward's: dfeats
    and dw (rounded to bf16 last) apart from one-step rounding flips (~1e-4
    of the elements on the card; at most max(4, 1e-3 of them)).  da and
    dt as the bf16 forward's T is held (``bf16_data_flips``: the data
    kernel's dT on the tensor cores can land one bf16 step from the plain
    dT, and move dA downstream): dT's one-step flips at most max(4, 1e-3
    of its elements), its other elements within 1e-4 of its max; da, dt
    within ``tol`` of their max and dfeats as above against the plain
    backward fed the kernel's dT; against the plain backward itself, an
    element of da or dt beyond ``tol`` of the max only in a slot that
    touches a tap row of its query where dT flipped.
    ``inputs``: (dout, idx, a, t, feats, w, kernel_size)."""
    for name, g, want in zip(("dfeats", "dqfeats", "dw", "da", "dt"), got,
                             ref):
        if want is None:
            assert g is None, name
            continue
        assert torch.isfinite(g.float()).all(), name
        if name in ("dfeats", "dw"):
            assert g.dtype == torch.bfloat16, name
            err, flips = rounding_flips(g, want)
            assert flips <= max(4, 1e-3 * want.numel()), (name, flips)
            assert err <= tol * float(want.abs().max()), (name, err)
    if got[0] is None:
        return
    res = bf16_data_flips(*inputs, (got[0], got[3], got[4]), tol,
                          interpolation)
    assert res["dT_flips"] <= max(4, 1e-3 * res["dT_elements"]), res
    assert res["dT_err"] <= 1e-4 * res["dT_scale"], res
    err, flips = res["forced"]["dfeats"]
    assert flips <= max(4, 1e-3 * got[0].numel()), res
    assert err <= tol * res["dfeats_scale"], res
    assert res["forced"]["da"] <= tol and res["forced"]["dt"] <= tol, res
    assert res["unexplained"] == {"da": 0, "dt": 0}, res


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
                     cconv_klist_bwd_reference(*args, precision="default"),
                     args[:7])


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
                      got[1]), (dfeats, None, dw, da, dt),
                     (dout, idx, a, t, feats, w, (1, 8, 8)))


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


def cloud_inputs(q, n, k, cin, cout, ksize, dim, symmetric, seed, device):
    """Contract inputs from a search over N points in a 1D (y), 2D (x, y)
    or 3D cell, the radius sized to ~0.8 K neighbours a query (so the
    widest lists hold ~K slots), Q queries among the points."""
    g = torch.Generator().manual_seed(seed)
    side = 0.1
    pts = torch.rand((n, 3), generator=g) * side
    keep = {1: (1,), 2: (0, 1), 3: (0, 1, 2)}[dim]
    for axis in range(3):
        if axis not in keep:
            pts[:, axis] = 0.0
    frac = 0.8 * k / n
    radius = side * {1: frac / 2, 2: (frac / np.pi) ** 0.5,
                     3: (3 * frac / (4 * np.pi)) ** (1 / 3)}[dim]
    nl = neighbors.search(pts, pts[:q], radius, k)
    if symmetric:
        nl = drop_coincident(nl)
    idx, a, t = cconv.klist_geometry(
        nl, 2 * radius, ksize,
        window_fn=windows.get_window_func("peak" if symmetric else "poly6"))
    feats = torch.randn((n, cin), generator=g)
    w = torch.randn((int(np.prod(ksize)) * cin, cout),
                    generator=g) * w_scale(cin)
    xs = [x.to(device) for x in (idx, a, t, feats, w)]
    return xs, (xs[3][:q].contiguous() if symmetric else None), int(
        nl.count.max())


WIDE_CASES = [  # q, n, k, cin, cout, ksize, dim, symmetric, precision
    # Liquid3d's widest pair (scale 0 -> 2, K 1856), bf16 trunk and fp32
    (300, 4000, 1856, 24, 32, (4, 4, 4), 3, False, "default"),
    (300, 4000, 1856, 24, 32, (4, 4, 4), 3, False, "highest"),
    # Liquid3d's ASCC conv: the symmetric 6x6x6 kernel (S 216), fp32
    (600, 600, 96, 32, 3, (6, 6, 6), 3, True, "highest"),
    # the column configs: 1D, kernel [1, 8, 1] (S 8), trunk and ASCC
    (256, 256, 48, 16, 8, (1, 8, 1), 1, False, "default"),
    (256, 256, 48, 16, 1, (1, 8, 1), 1, True, "highest"),
]


@pytest.mark.parametrize("q,n,k,cin,cout,ksize,dim,symmetric,precision",
                         WIDE_CASES, ids=["K1856_bf16", "K1856_fp32",
                                          "S216_sym", "1d_S8_bf16",
                                          "1d_S8_sym"])
def test_kernels_at_the_new_configs_shapes(cuda, q, n, k, cin, cout, ksize,
                                           dim, symmetric, precision):
    (idx, a, t, feats, w), qf, most = cloud_inputs(
        q, n, k, cin, cout, ksize, dim, symmetric, 11, cuda)
    assert most > k // 2  # the lists are long
    kw = dict(qfeats=qf, precision=precision)
    got = cconv_klist(idx, a, t, feats, w, ksize, **kw)
    ref = cconv_klist_reference(idx, a, t, feats, w, ksize, **kw)
    torch.cuda.synchronize()
    bf16 = precision == "default"
    tol = 1e-4 * float(ref.abs().max()) if bf16 else 2e-5
    assert float((got - ref).abs().max()) <= tol
    dout = torch.randn((q, cout), device=cuda)
    args = (dout, idx, a, t, feats, w, ksize, qf)
    dfeats, dqfeats, da, dt = cconv_klist_bwd_data(*args,
                                                   precision=precision)
    dw = cconv_klist_bwd_filter(*args, precision=precision)
    ref = cconv_klist_bwd_reference(*args, precision=precision)
    if bf16:
        check_bf16_grads((dfeats, dqfeats, dw, da, dt), ref, args[:7])
        return
    for name, g_, want in zip(("dfeats", "dqfeats", "dw", "da", "dt"),
                              (dfeats, dqfeats, dw, da, dt), ref):
        if want is None:
            assert g_ is None, name
            continue
        scale = float(want.abs().max())
        assert float((g_ - want).abs().max()) <= 1e-5 * scale, name


def column_initial_state(counts, device):
    from dmcf_tpu_torch.data.generators import SPH1D

    solver = SPH1D(radius=0.25, mass=1.0, stiffness=20.0, visc=0.1,
                   gravity=-1000.0)
    p = max(counts) + 2
    x0 = torch.zeros((len(counts), p))
    for s, n in enumerate(counts):
        solver.setup(n, 2)
        x0[s, :n + 2] = torch.from_numpy(solver.particles[:, 0])
    kw = dict(bcnt=2, gravity=solver.gravity, rest_dens=solver.rest_dens,
              stiffness=20.0, visc=0.1, h=solver.h, dt=0.0025)
    return (x0.to(device), torch.zeros_like(x0).to(device),
            torch.tensor([n + 2 for n in counts], dtype=torch.int32,
                         device=device), kw)


def test_column_kernel_matches_plain(cuda):
    """The column solver kernel against its plain version on the card and
    on the CPU: the same operations and the same fixed pair-sum tree, so
    the same bits; two launches equal; iteration counts equal."""
    from dmcf_tpu_torch.kernels.column_sph import (column_solve,
                                                   column_solve_reference)

    x0, v0, counts, kw = column_initial_state([1, 5, 20, 40], cuda)
    kw.update(timesteps=4, max_iter=300)
    before = column_solve.launches
    got = column_solve(x0, v0, counts, **kw)
    again = column_solve(x0, v0, counts, **kw)
    torch.cuda.synchronize()
    assert column_solve.launches == before + 2
    ref = column_solve_reference(x0, v0, counts, **kw)
    cpu = column_solve_reference(x0.cpu(), v0.cpu(), counts.cpu(), **kw)
    for g_, a_, r_, c_ in zip(got, again, ref, cpu):
        assert torch.equal(g_, a_)
        assert torch.equal(g_, r_)
        assert torch.equal(g_.cpu(), c_)
    assert int(got[2].max()) == 300 and int(got[2].min()) >= 1


def column_scenes(p, seed):
    """Scenes of a split padded to P particles: one of P, one of about half
    and one of bcnt + 1 (bcnt = min(2, P - 1) boundary particles first), a
    column at spacing ~0.45 h with jitter and random velocities."""
    rng = np.random.RandomState(seed)
    bcnt = min(2, p - 1)
    counts = [p, max(bcnt + 1, p // 2), bcnt + 1]
    x0 = np.zeros((len(counts), p), np.float32)
    v0 = np.zeros_like(x0)
    for s, n in enumerate(counts):
        x0[s, :n] = 0.45 * np.arange(n) + rng.uniform(-0.05, 0.05, n)
        v0[s, :n] = rng.uniform(-1.0, 1.0, n)
    return x0, v0, np.asarray(counts, np.int32), bcnt


@pytest.mark.parametrize("max_iter", [1, 40])
@pytest.mark.parametrize("p", [1, 31, 32, 33, 64])
def test_column_kernel_bitwise_at_each_width(cuda, p, max_iter):
    """The column kernel at each of its layouts (a warp a row up to P 32,
    two rows a warp past it, P odd leaving a row of the last warp unused)
    against its plain version, on the card and on the CPU: the same bits,
    scenes narrower than P included; two launches equal; max_iter 1 runs
    exactly one projection iteration a frame."""
    from dmcf_tpu_torch.kernels.column_sph import (column_solve,
                                                   column_solve_reference)

    x0, v0, counts, bcnt = column_scenes(p, p)
    kw = dict(bcnt=bcnt, timesteps=3, max_iter=max_iter, dt=0.0025)
    args = [torch.from_numpy(a) for a in (x0, v0, counts)]
    card = [a.to(cuda) for a in args]
    before = column_solve.launches
    got = column_solve(*card, **kw)
    again = column_solve(*card, **kw)
    torch.cuda.synchronize()
    assert column_solve.launches == before + 2
    ref = column_solve_reference(*card, **kw)
    cpu = column_solve_reference(*args, **kw)
    for g_, a_, r_, c_ in zip(got, again, ref, cpu):
        assert torch.equal(g_, a_)
        assert torch.equal(g_, r_)
        assert torch.equal(g_.cpu(), c_)
    assert bool(torch.isfinite(got[0]).all())
    if max_iter == 1:
        assert bool((got[2] == 1).all())


FILTER_DET_CASES = [  # q, n, k, cin, cout, ksize, dim, symmetric
    (2688, 2688, 40, 32, 32, (1, 8, 8), 2, False),  # WaterRamps trunk
    (80, 320, 256, 16, 8, (1, 8, 8), 2, False),     # momentum K 256
    (600, 600, 96, 32, 3, (6, 6, 6), 3, True),      # 3D S 216, symmetric
    (130, 130, 40, 8192, 4, (1, 1, 1), 3, False),   # Cin past the chunk
    (257, 257, 40, 160, 256, (1, 4, 4), 2, False),  # Cout 256, channel
    #                                                 chunks of 128
    (1001, 1001, 40, 24, 16, (1, 8, 8), 2, False),  # Q not a multiple of 16
]


@pytest.mark.parametrize(
    "q,n,k,cin,cout,ksize,dim,symmetric,precision",
    [c + (prec,) for c in FILTER_DET_CASES for prec in ("highest", "default")
     if prec == "highest" or not c[7]],  # the bf16 variant: no symmetric
    ids=[f"{name}_{prec}" for name, c in zip(
        ("trunk", "K256", "S216_sym", "Cin8192", "Cout256", "Q1001"),
        FILTER_DET_CASES) for prec in ("fp32", "bf16")
        if prec == "fp32" or not c[7]])
def test_filter_kernel_is_deterministic(cuda, q, n, k, cin, cout, ksize,
                                        dim, symmetric, precision):
    """The filter kernel sums its query tiles' partials in a fixed order
    and builds T without atomics: two launches give the same bits, in
    both variants, and stay within the plain backward's tolerance."""
    (idx, a, t, feats, w), qf, _ = cloud_inputs(
        q, n, k, cin, cout, ksize, dim, symmetric, 13, cuda)
    dout = torch.randn((q, cout), device=cuda)
    args = (dout, idx, a, t, feats, w, ksize, qf)
    first = cconv_klist_bwd_filter(*args, precision=precision)
    second = cconv_klist_bwd_filter(*args, precision=precision)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    want = cconv_klist_bwd_reference(*args, precision=precision)[2]
    scale = float(want.abs().max())
    assert scale > 0
    if precision == "default":
        err, flips = rounding_flips(first, want)
        assert flips <= max(4, 1e-3 * want.numel()), flips
        assert err <= 2e-3 * scale, (err, scale)
    else:
        assert float((first - want).abs().max()) <= 1e-5 * scale


DATA_DET_CASES = [c + (prec, "as_is") for c in FILTER_DET_CASES
                  for prec in ("highest", "default")
                  if prec == "highest" or not c[7]] + [
    # most slots padded (idx 0, a 0: the row-0 pile-up the transposed list
    # leaves out) and indices past the end (landing in row N-1)
    (2688, 2688, 40, 32, 32, (1, 8, 8), 2, False, prec, variant)
    for variant in ("padded", "clamped") for prec in ("highest", "default")]


@pytest.mark.parametrize(
    "q,n,k,cin,cout,ksize,dim,symmetric,precision,variant", DATA_DET_CASES,
    ids=[f"{name}_{prec}" for name, c in zip(
        ("trunk", "K256", "S216_sym", "Cin8192", "Cout256", "Q1001"),
        FILTER_DET_CASES) for prec in ("fp32", "bf16")
        if prec == "fp32" or not c[7]]
    + [f"{v}_{p}" for v in ("padded", "clamped") for p in ("fp32", "bf16")])
def test_data_kernel_is_deterministic(cuda, q, n, k, cin, cout, ksize, dim,
                                      symmetric, precision, variant):
    """The data kernels sum dfeats a feats row at a time through the
    transposed neighbour list, in ascending slot id, and dqfeats, da and dt
    with one writer each: two launches give the same bits for all four,
    in both variants, and stay within the plain backward's tolerance."""
    (idx, a, t, feats, w), qf, _ = cloud_inputs(
        q, n, k, cin, cout, ksize, dim, symmetric, 17, cuda)
    if variant == "padded":
        pad = torch.from_numpy(np.random.RandomState(3).rand(q, k) < 0.9)
        pad = pad.to(cuda)
        idx = torch.where(pad, 0, idx).contiguous()
        a = torch.where(pad, 0.0, a).contiguous()
    elif variant == "clamped":
        feats = feats[:40].contiguous()
        assert int(idx.max()) >= 40
    dout = torch.randn((q, cout), device=cuda)
    args = (dout, idx, a, t, feats, w, ksize, qf)
    first = cconv_klist_bwd_data(*args, precision=precision)
    second = cconv_klist_bwd_data(*args, precision=precision)
    torch.cuda.synchronize()
    for name, x, y in zip(("dfeats", "dqfeats", "da", "dt"), first, second):
        assert (x is None and y is None) or torch.equal(x, y), name
    ref = cconv_klist_bwd_reference(*args, precision=precision)
    if variant == "clamped":
        assert float(first[0][39].abs().max()) > 0
    got = (first[0], first[1], None, first[2], first[3])
    if precision == "default":
        check_bf16_grads(got, ref[:2] + (None,) + ref[3:], args[:7])
        return
    for name, g_, want in zip(("dfeats", "dqfeats", "dw", "da", "dt"), got,
                              ref):
        if name == "dw" or want is None:
            assert g_ is None, name
            continue
        scale = float(want.abs().max())
        assert float((g_ - want).abs().max()) <= 1e-5 * scale, name


@pytest.mark.parametrize("variant", ["as_is", "padded", "clamped"])
def test_data_kernel_transposed_list_matches_plain(cuda, variant):
    """The transposed neighbour list the data launch builds on the card
    (the rows' counts and offsets, each slot filed into its row's run, each
    run sorted) is ``transposed_slots``'s, element for element over the
    listed slots (the card leaves the rest of ``order`` undefined)."""
    (idx, a, t, feats, w), _, _ = cloud_inputs(
        2688, 2688, 40, 32, 32, (1, 8, 8), 2, False, 19, cuda)
    if variant == "padded":
        pad = torch.from_numpy(np.random.RandomState(4).rand(2688, 40)
                               < 0.9).to(cuda)
        idx = torch.where(pad, 0, idx).contiguous()
        a = torch.where(pad, 0.0, a).contiguous()
    elif variant == "clamped":
        feats = feats[:40].contiguous()
    dout = torch.randn((2688, 32), device=cuda)
    *_, order, offsets = _bwd_data_launch(dout, idx, a, t, feats, w,
                                          (1, 8, 8), None)
    want_order, want_offsets = transposed_slots(idx.cpu(), a.cpu(),
                                                feats.shape[0])
    torch.cuda.synchronize()
    assert torch.equal(offsets.cpu(), want_offsets)
    listed = int(want_offsets[-1])
    assert torch.equal(order.cpu()[:listed], want_order[:listed])


def fps_inputs(b, n, dim, lattice, holes, seed, device):
    """Point sets [b, n, 3] (random, or an exact lattice at spacing 0.01
    with its distance ties), every ``holes``-th row masked at the
    sentinel positions."""
    from dmcf_tpu_torch.ops.sph import masked_positions
    rng = np.random.RandomState(seed)
    if lattice:
        side = int(np.ceil(n ** (1.0 / dim)))
        g = np.stack(np.meshgrid(*[np.arange(side)] * dim, indexing="ij"),
                     -1).reshape(-1, dim)[:n] * 0.01
        pos = np.zeros((b, n, 3), np.float32)
        pos[:, :, :dim] = g
    else:
        pos = rng.uniform(-0.5, 0.5, (b, n, 3)).astype(np.float32)
        pos[:, :, dim:] = 0.0
    mask = np.ones((b, n), bool)
    if holes:
        mask[:, ::holes] = False
    pos = torch.stack([masked_positions(torch.from_numpy(p),
                                        torch.from_numpy(m))
                       for p, m in zip(pos, mask)])
    return pos.to(device), torch.from_numpy(mask).to(device)


FPS_CASES = fps_cases()


@pytest.mark.parametrize("b,n,sample_max,sched",
                         [c[1:] for c in FPS_CASES],
                         ids=[c[0] for c in FPS_CASES])
def test_fps_kernel_matches_plain(cuda, b, n, sample_max, sched):
    """The farthest-point kernel picks the plain version's rows bit for
    bit (idx and mask) under every schedule (one warp a set, a block of
    warps a set, the workspace with the positions in shared or global
    memory; ``chip_smoke.fps_cases``), on unequal sets with lattice ties,
    masked rows and counts below ``sample_max``; two launches are bitwise
    equal, and each call counts one launch."""
    from dmcf_tpu_torch.kernels.fps import (_launch, farthest_point_sample,
                                            farthest_point_sample_reference)
    pos, mask, count = fps_sets(b, n, sample_max, cuda)
    before = farthest_point_sample.launches
    idx, sel = _launch(pos, mask, sample_max, count, sched)
    again, _ = _launch(pos, mask, sample_max, count, sched)
    torch.cuda.synchronize()
    assert farthest_point_sample.launches == before + 2
    ref_idx, ref_sel = farthest_point_sample_reference(pos, mask,
                                                       sample_max, count)
    assert torch.equal(idx, ref_idx)
    assert torch.equal(sel, ref_sel)
    assert torch.equal(idx, again)
    one, one_sel = farthest_point_sample(pos[1], mask[1], sample_max,
                                         count[1])
    assert torch.equal(one, idx[1]) and torch.equal(one_sel, sel[1])


def test_fps_kernel_rejects_bad_inputs(cuda):
    from dmcf_tpu_torch.kernels.fps import (Schedule, _launch,
                                            farthest_point_sample)
    pos, mask = fps_inputs(1, 64, 3, False, 0, 0, cuda)
    with pytest.raises(ValueError):
        farthest_point_sample(pos.double(), mask, 8, 8)
    with pytest.raises(ValueError):
        farthest_point_sample(pos, mask, 0, 8)
    # schedules the kernel is not built for or that do not hold the set
    for sched in (Schedule("warp", 1, 1), Schedule("warp", 2, 2),
                  Schedule("block", 2, 5), Schedule("block", 3, 1),
                  Schedule("block", 32, 12)):
        with pytest.raises(RuntimeError):
            _launch(pos, mask, 8, 8, sched)


MODES = ("linear_border", "nearest_neighbor")
MODE_CASES = [  # q, k, cin, cout, ksize, window, symmetric, geometry
    (2688, 40, 32, 32, (1, 8, 8), "poly6", False, "outside"),  # trunk
    (2688, 40, 32, 2, (1, 8, 8), "peak", True, "outside"),     # ASCC
    (2688, 40, 4, 8, (1, 8, 8), "poly6", False, "search"),
    (300, 96, 32, 3, (6, 6, 6), "peak", True, "outside"),
    (200, 40, 32, 32, (1, 8, 8), None, False, "edges"),
    (200, 40, 32, 2, (1, 8, 8), None, True, "edges"),
    (100, 24, 8, 5, (4, 4, 4), None, False, "edges"),
    (100, 24, 4, 3, (6, 6, 6), None, True, "edges"),
    (257, 40, 64, 32, (1, 8, 8), "poly6", False, "outside"),  # row chunks
    (130, 40, 8192, 4, (1, 1, 1), "poly6", False, "outside"),  # channels
    (257, 40, 8, 8, (4, 4, 4), "poly6", True, "outside"),
]


@pytest.mark.parametrize("q,k,cin,cout,ksize,window,symmetric,geometry",
                         MODE_CASES)
@pytest.mark.parametrize("mode", MODES)
def test_mode_kernels_match_twin(cuda, mode, q, k, cin, cout, ksize,
                                 window, symmetric, geometry):
    """The forward of a mode, fp32 (or symmetric) and bf16, against its
    plain twin; two launches bitwise equal, each counted under its mode."""
    (idx, a, t, feats, w), qf = klist_inputs(q, k, cin, cout, ksize, window,
                                             symmetric, 3, cuda, geometry)
    precisions = ["highest"] + ([] if symmetric else ["default"])
    for prec in precisions:
        half = prec == "default"
        before = list(cconv_klist.mode_launches[mode])
        kw = dict(qfeats=qf, precision=prec, interpolation=mode)
        got = cconv_klist(idx, a, t, feats, w, ksize, **kw)
        again = cconv_klist(idx, a, t, feats, w, ksize, **kw)
        torch.cuda.synchronize()
        before[int(half)] += 2
        assert cconv_klist.mode_launches[mode] == before
        assert torch.equal(got, again)
        ref = cconv_klist_reference(idx, a, t, feats, w, ksize, **kw)
        assert torch.isfinite(got).all()
        err = float((got - ref).abs().max())
        assert err <= (1e-4 * float(ref.abs().max()) if half else 2e-5), \
            (prec, err)
        lin = cconv_klist_reference(idx, a, t, feats, w, ksize, qfeats=qf,
                                    precision=prec)
        if geometry != "search" and ksize != (1, 1, 1):
            assert float((lin - ref).abs().max()) > 1e-4 * float(
                ref.abs().max())  # the case tells the modes apart


@pytest.mark.parametrize("q,n,k,cin,cout,ksize,symmetric,geometry", [
    (2688, 2688, 40, 32, 32, (1, 8, 8), False, "outside"),  # trunk
    (2688, 2688, 40, 32, 2, (1, 8, 8), True, "outside"),    # ASCC
    (200, 200, 40, 32, 32, (1, 8, 8), False, "edges"),
    (200, 200, 40, 8, 3, (4, 4, 4), True, "edges"),
    (300, 300, 96, 32, 3, (6, 6, 6), True, "outside"),
    (257, 257, 40, 128, 256, (1, 8, 8), False, "outside"),
    (130, 130, 40, 8192, 3, (1, 1, 1), True, "outside"),
])
@pytest.mark.parametrize("mode", MODES)
def test_mode_bwd_kernels_match_reference(cuda, mode, q, n, k, cin, cout,
                                          ksize, symmetric, geometry):
    """Both backward kernels of a mode, each variant, against the plain
    backward of that mode; nearest_neighbor's dt is exactly 0."""
    (idx, a, t, feats, w), qf = klist_inputs(
        q, k, cin, cout, ksize, "poly6", symmetric, 7, cuda, geometry)
    dout = torch.randn((q, cout), device=cuda)
    for prec in ["highest"] + ([] if symmetric else ["default"]):
        half = prec == "default"
        fns = (cconv_klist_bwd_data, cconv_klist_bwd_filter)
        before = [list(f.mode_launches[mode]) for f in fns]
        args = (dout, idx, a, t, feats, w, ksize, qf)
        kw = dict(precision=prec, interpolation=mode)
        dfeats, dqfeats, da, dt = cconv_klist_bwd_data(*args, **kw)
        dw = cconv_klist_bwd_filter(*args, **kw)
        again = cconv_klist_bwd_data(*args, **kw)
        dw2 = cconv_klist_bwd_filter(*args, **kw)
        torch.cuda.synchronize()
        for b in before:
            b[int(half)] += 2
        assert [f.mode_launches[mode] for f in fns] == before
        assert torch.equal(dw, dw2)
        for x, y in zip((dfeats, da, dt), (again[0], again[2], again[3])):
            assert torch.equal(x, y)
        ref = cconv_klist_bwd_reference(*args, **kw)
        if mode == "nearest_neighbor":
            assert float(dt.abs().max()) == 0.0
        if half:
            check_bf16_grads((dfeats, dqfeats, dw, da, dt), ref, args[:7],
                             interpolation=mode)
            continue
        for name, got, want in zip(("dfeats", "dqfeats", "dw", "da", "dt"),
                                   (dfeats, dqfeats, dw, da, dt), ref):
            if want is None:
                assert got is None, name
                continue
            scale = float(want.abs().max())
            err = float((got - want).abs().max())
            assert err <= 1e-5 * scale, (name, err, scale)


@pytest.mark.parametrize("mode", MODES)
def test_mode_autograd_runs_the_kernels(cuda, mode):
    """Under autograd a conv of a mode launches that mode's forward, data
    and filter kernels once each; a mode the kernels do not take raises
    on the card, before any launch."""
    (idx, a, t, feats, w), _ = klist_inputs(512, 24, 8, 4, (1, 8, 8),
                                            "poly6", False, 5, cuda,
                                            "outside")
    leaves = [x.clone().requires_grad_(True) for x in (a, t, feats, w)]
    fns = (cconv_klist, cconv_klist_bwd_data, cconv_klist_bwd_filter)
    counts = [list(f.mode_launches[mode]) for f in fns]
    out = cconv_klist(idx, *leaves, (1, 8, 8), interpolation=mode)
    out.backward(torch.randn_like(out))
    assert [f.mode_launches[mode] for f in fns] == \
        [[c[0] + 1, c[1]] for c in counts]
    with pytest.raises(NotImplementedError):
        cconv_klist(idx, a, t, feats, w, (1, 8, 8), interpolation="cubic")
