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


def klist_inputs(q, k, cin, cout, ksize, window, symmetric, seed, device):
    """Contract inputs from a real neighbor search over a 2D/3D cloud."""
    g = torch.Generator().manual_seed(seed)
    dim = 2 if ksize[0] == 1 else 3
    pts = torch.rand((q, 3), generator=g) * 0.6 - 0.3
    pts[:, dim:] = 0.0
    # ~9 neighbors per point in 2D: well inside K, so lists are symmetric
    radius = 0.02 if dim == 2 else 0.12
    nl = neighbors.search(pts, pts, radius, k)
    if symmetric:
        nl = drop_coincident(nl)
    feats = torch.randn((q, cin), generator=g)
    idx, a, t = cconv.klist_geometry(
        nl, 2 * radius, ksize, window_fn=windows.get_window_func(window))
    w = torch.randn((int(np.prod(ksize)) * cin, cout), generator=g) * 0.1
    qf = feats if symmetric else None
    to = lambda x: None if x is None else x.to(device)  # noqa: E731
    return [to(x) for x in (idx, a, t, feats, w)], to(qf)


@pytest.mark.parametrize("q,k,cin,cout,ksize,window,symmetric", [
    (2688, 40, 32, 32, (1, 8, 8), "poly6", False),   # widest trunk conv
    (2688, 40, 32, 2, (1, 8, 8), "peak", True),      # ASCC layer
    (2688, 40, 4, 8, (1, 8, 8), "poly6", False),     # scale-0 convs
    (1344, 40, 16, 16, (1, 8, 8), "poly6", False),
    (300, 96, 32, 3, (6, 6, 6), "peak", True),       # Liquid3d ASCC
    (130, 20, 8, 4, (4, 4, 4), "poly6", False),      # ragged tail block
])
def test_kernel_matches_twin(cuda, q, k, cin, cout, ksize, window,
                             symmetric):
    (idx, a, t, feats, w), qf = klist_inputs(q, k, cin, cout, ksize, window,
                                             symmetric, 0, cuda)
    before = cconv_klist.launches
    got = cconv_klist(idx, a, t, feats, w, ksize, qfeats=qf)
    torch.cuda.synchronize()
    assert cconv_klist.launches == before + 1
    ref = cconv_klist_reference(idx, a, t, feats, w, ksize, qfeats=qf)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, ref, atol=2e-5, rtol=0)


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
    """Indices past the feature rows read the last row (JAX's clamped
    gather), never memory beyond ``feats``."""
    (idx, a, t, feats, w), _ = klist_inputs(256, 16, 8, 4, (1, 8, 8),
                                            "poly6", False, 3, cuda)
    small = feats[:40].contiguous()
    assert int(idx.max()) >= 40
    got = cconv_klist(idx, a, t, small, w, (1, 8, 8))
    ref = cconv_klist(idx.clamp(max=39), a, t, small, w, (1, 8, 8))
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
