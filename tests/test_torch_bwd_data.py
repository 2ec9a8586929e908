"""The structure of the K-list data-gradient kernel (``cconv_klist_bwd.cu``:
dT a query, the slot walk, dfeats summed a feats row at a time through the
transposed neighbour list) on the CPU.

The kernel runs only on the card; here its index preparation
(``transposed_slots``) is held against a numpy brute force, and a plain
PyTorch emulation of its summation order (dT = W dout a query, dA a tap, dg
a slot, each row's slots added in ascending slot id, dqfeats as the tap
rows' sums times dT) against ``cconv_klist_bwd_reference`` and against
``jax.vjp`` of ``dmcf_tpu/ops/cconv.py:continuous_conv``.  Tolerances: fp32
within 1e-5 of each gradient's max (sums in another order); the bf16
variant within 2e-3 of the max for da and dt, and dfeats (rounded to bf16
last) apart from elements exactly one bf16 step from the reference's, at
most max(4, 1e-3 of them): an fp32 sum taken in another order can meet a
rounding midpoint.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmcf_tpu.ops import cconv as jcc
from dmcf_tpu.ops import neighbors as jnb
from dmcf_tpu_torch.kernels.cconv_klist import (_tap_tensor,
                                                cconv_klist_bwd_reference,
                                                round_bf16, rounding_flips,
                                                transposed_slots)
from tests.test_torch_ops import _vjp_both, random_cloud

# two intra-op threads: the suite runs files side by side on a few cores
torch.set_num_threads(2)

T = torch.from_numpy


def brute_force_lists(idx, a, n):
    """Row r's slot ids (q*K + k with a != 0 and idx clamped to r), in
    ascending order, by a plain loop."""
    rows = [[] for _ in range(n)]
    for e, (i, w) in enumerate(zip(idx.reshape(-1), a.reshape(-1))):
        if w != 0:
            rows[min(max(int(i), 0), n - 1)].append(e)
    return rows


@pytest.mark.parametrize("q,k,n,empty,case", [
    (37, 24, 50, 0.3, "random"),       # negative and past-the-end indices
    (64, 40, 64, 0.9, "padded"),       # most slots padded: idx 0, a 0
    (5, 8, 9, 1.0, "all_empty"),
    (16, 12, 1, 0.2, "one_row"),
])
def test_transposed_slots_matches_brute_force(q, k, n, empty, case):
    rng = np.random.RandomState(q + k + n)
    idx = rng.randint(-3, n + 3, (q, k)).astype(np.int32)
    a = rng.uniform(0.1, 1.0, (q, k)).astype(np.float32)
    pad = rng.rand(q, k) < empty
    a[pad] = 0.0
    if case == "padded":
        idx[pad] = 0
    order, offsets = transposed_slots(T(idx), T(a), n)
    assert order.dtype == torch.int32 and offsets.dtype == torch.int32
    assert order.shape == (q * k,) and offsets.shape == (n + 1,)
    # every slot once; the listed ones first, row by row
    assert sorted(order.tolist()) == list(range(q * k))
    offsets = offsets.tolist()
    want = brute_force_lists(idx, a, n)
    assert offsets[0] == 0
    for r in range(n):
        assert order[offsets[r]:offsets[r + 1]].tolist() == want[r], r
    assert offsets[n] == int((a != 0).sum())
    # the padded slots (a == 0) are left out, whatever their idx
    assert not a.reshape(-1)[order[offsets[n]:].numpy()].any()


def emulate_bwd_data(dout, idx, a, t, feats, w, ksize, qfeats=None,
                     bf16=False):
    """The data kernel's gradients (dfeats, dqfeats, da, dt) in its
    summation structure: dT [Q, S, Cin] = W dout a query (rounded to bf16
    once in the bf16 variant); a slot's dA [S] = dT . g (rounded once a
    tap), da = dA . H and dt = a dA . dH/dt; a slot's dg = sum_s A dT; row
    r of dfeats the sum of its slots' dg through ``transposed_slots``, one
    slot at a time in ascending slot id; dqfeats[q] = sum_s (sum_k A[k, s])
    dT[s]."""
    q, k = idx.shape
    n, cin = feats.shape
    s_total = int(np.prod(ksize))
    tt = t.detach().clone().requires_grad_(True)
    with torch.enable_grad():
        H = _tap_tensor(tt, torch.ones_like(a), ksize)
    A = H.detach() * a[..., None]
    if bf16:
        A, feats, w = round_bf16(A), round_bf16(feats), round_bf16(w)
    dT = (dout @ w.T).reshape(q, s_total, cin)
    if bf16:
        dT = round_bf16(dT)
    g = feats[idx.long().clamp(0, n - 1)]
    if qfeats is not None:
        g = g + qfeats[:, None, :]
    dA = torch.einsum("qsc,qkc->qks", dT, g)
    if bf16:
        dA = round_bf16(dA)
    da = (dA * H.detach()).sum(-1)
    (dt,) = torch.autograd.grad(H, tt, dA * a[..., None])
    dg = torch.einsum("qks,qsc->qkc", A, dT).reshape(q * k, cin)
    order, offsets = transposed_slots(idx, a, n)
    first, count = offsets[:-1].long(), (offsets[1:] - offsets[:-1]).long()
    dfeats = torch.zeros((n, cin))
    for j in range(int(count.max()) if n else 0):  # a row's j-th slot
        has = count > j
        dfeats[has] += dg[order[first[has] + j]]
    dqfeats = None if qfeats is None else torch.einsum(
        "qs,qsc->qc", A.sum(dim=1), dT)
    return dfeats, dqfeats, da, dt


def search_inputs(symmetric, ksize, dim, seed, n_feats=None):
    """A JAX search over a random cloud and the port's conv on it through
    ``_vjp_both``: JAX's and the port's gradients, dout, the contract's
    (idx, a, t), qfeats, feats and the filter."""
    rng = np.random.RandomState(seed)
    pts = random_cloud(rng, 200, dim=dim)
    feats = rng.randn(n_feats or 200, 6).astype(np.float32)
    kern = (rng.randn(*ksize, 6, 3) * 0.1).astype(np.float32)
    if symmetric:
        kern = np.asarray(jcc.build_symmetric_kernel(
            jnp.asarray(kern[:, :ksize[1] // 2]), 1))
    nl = jax.jit(lambda p: jnb.fixed_radius_search(
        p, p, 0.075, 24, ignore_query_point=symmetric))(jnp.asarray(pts))
    win = "peak" if symmetric else "poly6"
    want, _, dout, geom, qf = _vjp_both(pts, feats, kern, nl, symmetric,
                                        win)
    return (want, dout, tuple(x.detach() for x in geom), qf, T(feats),
            T(kern).reshape(-1, 3))


def _close(got, want, what, tol=1e-5):
    scale = float(np.abs(np.asarray(want)).max())
    assert scale > 0, what
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    assert err <= tol * scale, (what, err, scale)


CASES = [(False, (4, 4, 4), 3), (True, (1, 8, 8), 2), (False, (1, 8, 8), 2),
         (True, (4, 4, 4), 3)]


@pytest.mark.parametrize("symmetric,ksize,dim", CASES,
                         ids=["3d", "2d_sym", "2d", "3d_sym"])
def test_emulated_data_grads_match_reference(symmetric, ksize, dim):
    _, dout, (idx, a, t), qf, feats, w = search_inputs(symmetric, ksize,
                                                       dim, 21)
    qf = qf if symmetric else None
    assert bool((a == 0).any())  # padded slots: idx 0, a 0
    got = emulate_bwd_data(dout, idx, a, t, feats, w, ksize, qf)
    dfeats, dqfeats, _, da, dt = cconv_klist_bwd_reference(
        dout, idx, a, t, feats, w, ksize, qf)
    for name, g, want in zip(("dfeats", "dqfeats", "da", "dt"), got,
                             (dfeats, dqfeats, da, dt)):
        if want is None:
            assert g is None, name
            continue
        _close(g, want, name)


@pytest.mark.parametrize("symmetric,ksize,dim", CASES[:2],
                         ids=["3d", "2d_sym"])
def test_emulated_data_grads_match_jax(symmetric, ksize, dim):
    """The tolerances of ``test_torch_ops.test_klist_conv_vjp_matches_jax``:
    1e-5 of the max, features and query features."""
    want, dout, (idx, a, t), qf, feats, w = search_inputs(symmetric, ksize,
                                                          dim, 12)
    dfeats, dqfeats, _, _ = emulate_bwd_data(
        dout, idx, a, t, feats, w, ksize, qf if symmetric else None)
    _close(dfeats.numpy(), want[1], "features")
    if symmetric:
        _close(dqfeats.numpy(), want[2], "query features")


def test_emulated_clamped_idx_lands_in_last_row():
    """Slots whose index is past the feature rows read row N-1, and their
    dg is summed into row N-1 through the transposed list, as in the plain
    backward."""
    ksize = (1, 4, 4)
    _, dout, (idx, a, t), _, feats, w = search_inputs(False, ksize, 2, 6,
                                                      n_feats=40)
    assert int(idx.max()) >= 40
    got = emulate_bwd_data(dout, idx, a, t, feats, w, ksize)
    dfeats, _, _, da, dt = cconv_klist_bwd_reference(dout, idx, a, t, feats,
                                                     w, ksize)
    assert float(got[0][39].abs().max()) > 0
    for name, g, want in zip(("dfeats", "da", "dt"), (got[0], got[2],
                                                      got[3]),
                             (dfeats, da, dt)):
        _close(g, want, name)


@pytest.mark.parametrize("ksize,dim", [((4, 4, 4), 3), ((1, 8, 8), 2)],
                         ids=["3d", "2d"])
def test_emulated_bf16_data_grads_match_reference(ksize, dim):
    _, dout, (idx, a, t), _, feats, w = search_inputs(False, ksize, dim, 31)
    got = emulate_bwd_data(dout, idx, a, t, feats, w, ksize, bf16=True)
    dfeats, _, _, da, dt = cconv_klist_bwd_reference(
        dout, idx, a, t, feats, w, ksize, precision="default")
    # the wrapper rounds the fp32 sum to bf16 once
    err, flips = rounding_flips(got[0].bfloat16(), dfeats)
    assert flips <= max(4, 1e-3 * dfeats.numel()), flips
    assert err <= 2e-3 * float(dfeats.abs().max()), err
    _close(got[2], da, "da", tol=2e-3)
    _close(got[3], dt, "dt", tol=2e-3)
