"""The whole model step under slab decomposition (port of
dmcf_tpu/parallel/halo_model.py).

Space is split into D slabs along one axis.  Rank d owns its slab's fluid
and a static slice of the boundary (the slab widened by the halo width on
both sides), and each step ONE ``Group.exchange`` sends the fluid rows
within the model's one-step receptive field of a slab plane to the two
neighbouring ranks.  The whole PBFNet step (voxel pyramid, the pairs'
searches, the trunk's K-list convs, ASCC) then runs on the rank's owned
plus halo rows, and only the owned rows' outputs are kept:

    points a rank      ~ N/D + 2H   (H: the halo zone's occupancy)
    compute a rank     ~ 1/D of the single-process step
    communication      ~ 2H rows, point to point, once a step

An owned row's output depends on the sources within ``receptive_field``;
with the halo width at least that and every slab at least that wide, the
owned and halo rows cover it.  The voxel pyramid anchors at the centroid
of the whole scene (``grid_center``: the ranks' sums over their owned
rows, ``psum``'d), so every rank's grids line up.  The centroid is taken
over the advected positions, as the single-process model takes it (the
JAX package's step takes it before the model advects, which moves the
grids by dt times the mean velocity against the single-device step).

Voxel-pyramid models only: farthest-point transitions (``voxel_size:
None``) subsample globally and raise ``NotImplementedError``.  Each rank
holds only its boundary slice, so the full boundary runs without the
single-card crop.

Ownership is fixed between (re)partitions: a row that drifts across a
slab plane is still updated by its owner; ``aux['halo_escaped']`` counts
owned rows past half the halo margin, and ``halo_rollout_host`` cuts new
slabs when any did.  Every branch a rank takes on a value (re-partition,
the reports, ``halo_cap``) reads a value every rank holds alike: a
reduced one, or numpy over the same global arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from .halo import exchange_halo, shard_parts, slab_partition

_FAR = 1e9
_MODEL_KEYS = ("pos", "mask", "src", "bounds", "payload", "box",
               "box_normals", "box_mask", "box_owned")


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def receptive_field(model, *, voxel_margin=2.0):
    """Conservative one-step influence radius of a PBF-family model: the
    search radii along the deepest influence chain (scale-0 convs r0, each
    trunk layer (1 + its extra convs) hops at the coarsest radius, the
    ASCC stack, pre-advection, the density pyramid's chain under
    ``dens_norm``) plus a voxel-stamp margin of the coarsest grid."""
    radii = [float(r) for r in model.particle_radii]
    r0, r_max = radii[0], max(radii)
    lc = model.layer_channels
    rf = r0
    for layer in lc[1:] if len(lc) > 1 else []:
        extra = max((len(ch) - 1 for ch in layer), default=0)
        rf += (1 + extra) * r_max
    if getattr(model, "sym_channels", None):
        rf += r0 * len(model.sym_channels)
    if model.use_pre_adv:
        rf += r0
    if model.dens_norm:
        rf += sum(radii[1:])
    if model.voxel_size is not None:
        vs = float(np.max(np.asarray(model.voxel_size)))
        stride = max(int(s) for s in model.strides)
        rf += voxel_margin * vs * stride
    return rf


def partition_model_sample(sample, n_dev, halo_width, *, axis=None,
                           bcap_round=8):
    """The slab layout of a model sample (numpy; the JAX package's arrays
    bit for bit).  The fluid is split into equal-count slabs (exchanged
    every step); the boundary is sliced per slab WITH its halo
    ([lo - halo, hi + halo)), its rows inside [lo, hi) flagged
    ``box_owned`` so that reductions count each once.  Returns stacked
    [D, ...] arrays and the metadata; ``shard_model_parts`` takes a
    rank's row.

    The model's ``obs_conv`` gathers boundary rows at ``min(idx, B-1)``
    (a reference behaviour, ROADMAP §3): a rank equals one process where
    its fluid rows (owned plus halo slots) and the sample's both
    outnumber the boundary rows and the last boundary row is padding, as
    a generous ``bcap_round`` leaves it."""
    pos = _np(sample["pos"])
    fmask = _np(sample["fluid_mask"]).astype(bool)
    payload = np.concatenate([_np(sample["vel"]), _np(sample["grav"])],
                             axis=-1)
    parts = slab_partition(pos, fmask, n_dev, axis=axis, payload=payload)
    axis = parts["axis"]
    bounds = parts["bounds"]

    box = _np(sample["box"])
    nrm = _np(sample["box_normals"])
    bmask = _np(sample["box_mask"]).astype(bool)
    coord = box[:, axis]
    sel = []
    for d in range(n_dev):
        lo, hi = bounds[d]
        lo_h = -np.inf if not np.isfinite(lo) else lo - halo_width
        hi_h = np.inf if not np.isfinite(hi) else hi + halo_width
        sel.append(np.nonzero(bmask & (coord >= lo_h) & (coord < hi_h))[0])
    bcap = max(max((s.size for s in sel), default=1), 1)
    # rounded up generously (halo_rollout_host passes 1024): re-partitions
    # move the planes, and a shape a re-partition is new work each time
    bcap = int(-(-bcap // bcap_round) * bcap_round)
    bpos = np.zeros((n_dev, bcap, 3), box.dtype)
    bnrm = np.zeros((n_dev, bcap, 3), nrm.dtype)
    bm = np.zeros((n_dev, bcap), bool)
    bown = np.zeros((n_dev, bcap), bool)
    for d in range(n_dev):
        s = sel[d]
        k = s.size
        bpos[d, :k] = box[s]
        bpos[d, k:] = _FAR + np.arange(bcap - k)[:, None] * 7.0
        bnrm[d, :k] = nrm[s]
        bm[d, :k] = True
        lo, hi = bounds[d]
        bown[d, :k] = (box[s, axis] >= lo) & (box[s, axis] < hi)
    parts.update(box=bpos, box_normals=bnrm, box_mask=bm,
                 box_owned=bown, halo_width=float(halo_width))
    return parts


def shard_model_parts(parts, rank, device):
    """Rank ``rank``'s row of ``partition_model_sample``'s arrays, as
    tensors on ``device``."""
    return shard_parts(parts, rank, device, keys=_MODEL_KEYS)


def make_halo_model_step(model, group, *, halo_width, halo_cap, axis=0,
                         training=False):
    """The slab-decomposed step a rank runs.

    Returns ``run(parts) -> (pos, vel, aux)``: ``parts`` this rank's
    ``shard_model_parts``, pos / vel [fcap, 3] its rows (concatenated in
    rank order, the JAX package's shard order: ``gather_owned`` maps them
    to input rows).  ``aux``, the same on every rank: ``halo_overflow``
    (zone rows beyond ``halo_cap``, summed: exact iff 0), ``halo_escaped``
    (owned rows past half the halo margin, summed), the model's
    ``neighbor_overflow`` and ``pair_overflow`` (max over the ranks; and
    ``cell_overflow`` where the model reports it) and ``scale_counts``
    [D, n_scales] (each rank's voxel counts).

    ``run.loss(parts, target, w_pos=1.0, w_vel=0.0)``: the masked MSE of
    the owned one-step prediction against ``target`` [fcap, 2, 3] (pos,
    vel), over the owned rows of every rank; its value is the whole
    loss, its gradient this rank's share: call
    ``group.psum_grads(model.parameters())`` after ``backward()``.

    ``run.rollout(parts, length) -> (traj [length, fcap, 3], parts',
    aux)``: ``length`` steps with ownership fixed, ``parts'`` holding the
    final pos and payload; ``aux`` over the steps (``halo_overflow``
    summed, the others their max; ``scale_counts`` each rank's largest
    voxel counts of the steps, against the ``scale_caps``)."""
    if model.voxel_size is None and any(int(s) != 1 for s in model.strides):
        raise NotImplementedError(
            "halo decomposition requires the voxel pyramid; FPS "
            "transitions (voxel_size: None) subsample globally")
    payload_c = 6  # vel ++ grav

    def core(parts, pos, payload):
        """One step of this rank's owned rows at ``pos`` / ``payload``
        (its other arrays from ``parts``); aux unreduced."""
        mask, bown, bpos = parts["mask"], parts["box_owned"], parts["box"]
        lo, hi = parts["bounds"][0], parts["bounds"][1]
        local_pos, local_mask, local_pay, over = exchange_halo(
            group, pos, mask, payload, axis, lo, hi, halo_width, halo_cap,
            far=(2 * _FAR, 3 * _FAR))
        s = {"pos": local_pos, "vel": local_pay[:, :3],
             "grav": local_pay[:, 3:payload_c], "fluid_mask": local_mask,
             "box": bpos, "box_normals": parts["box_normals"],
             "box_mask": parts["box_mask"]}
        if model.centralize:
            # the centroid of the scene's pyramid base, each row counted by
            # its owner, at the positions the model advects to
            adv, _ = model.integrate_pos_vel(pos, payload[:, :3],
                                             payload[:, 3:payload_c])
            fsum = torch.where(mask[:, None], adv, 0.0).sum(0)
            fcnt = mask.sum()
            if model.use_bnds:
                fsum = fsum + torch.where(bown[:, None], bpos, 0.0).sum(0)
                fcnt = fcnt + bown.sum()
            tot = group.psum(torch.cat([fsum, fcnt[None].to(fsum.dtype)]))
            s["grid_center"] = tot[:3] / torch.clamp(tot[3], min=1.0)
        p2, v2, aux = model(s, training=training)
        fcap = pos.shape[0]
        escaped = (mask & ((pos[:, axis] < lo - 0.5 * halo_width)
                           | (pos[:, axis] >= hi + 0.5 * halo_width))).sum()
        out = {"halo_overflow": over.to(torch.int32),
               "halo_escaped": escaped.to(torch.int32),
               "neighbor_overflow": aux["neighbor_overflow"].to(torch.int32),
               "pair_overflow": aux["pair_overflow"].to(torch.int32),
               "scale_counts": aux["scale_counts"],
               "scale_caps": aux["scale_caps"]}
        if "cell_overflow" in aux:
            out["cell_overflow"] = aux["cell_overflow"].to(torch.int32)
        return p2[:fcap], v2[:fcap], out

    def reduce(aux, summed):
        """Every rank's aux in one psum, one pmax and (for the voxel
        counts) one all_gather."""
        keys = [k for k in ("halo_overflow", "halo_escaped",
                            "neighbor_overflow", "pair_overflow",
                            "cell_overflow") if k in aux]
        s_keys = [k for k in keys if k in summed]
        m_keys = [k for k in keys if k not in summed]
        out = {}
        if s_keys:
            tot = group.psum(torch.stack([aux[k] for k in s_keys]))
            out.update(zip(s_keys, tot))
        if m_keys:
            top = group.pmax(torch.stack([aux[k] for k in m_keys]))
            out.update(zip(m_keys, top))
        if "scale_counts" in aux:
            out["scale_counts"] = group.all_gather(aux["scale_counts"])
            out["scale_caps"] = aux["scale_caps"]   # alike on every rank
        return out

    def run(parts):
        p2, v2, aux = core(parts, parts["pos"], parts["payload"])
        return p2, v2, reduce(aux, ("halo_overflow", "halo_escaped"))

    def loss(parts, target, *, w_pos=1.0, w_vel=0.0):
        p2, v2, _ = core(parts, parts["pos"], parts["payload"])
        m = parts["mask"][:, None]
        err = (w_pos * torch.where(m, (p2 - target[:, 0]) ** 2, 0.0).sum()
               + w_vel * torch.where(m, (v2 - target[:, 1]) ** 2,
                                     0.0).sum())
        cnt = group.psum(parts["mask"].sum().to(err.dtype))
        local = err / torch.clamp(cnt, min=1.0)
        return local + (group.psum(local) - local).detach()

    @torch.no_grad()
    def rollout(parts, length):
        pos, payload = parts["pos"], parts["payload"]
        traj, acc = [], None
        for _ in range(int(length)):
            pos, v2, aux = core(parts, pos, payload)
            payload = torch.cat([v2, payload[:, 3:]], -1)
            traj.append(pos)
            if acc is None:
                acc = aux
            else:
                acc = {k: (acc[k] + v if k == "halo_overflow"
                           else v if k == "scale_caps"
                           else torch.maximum(acc[k], v))
                       for k, v in aux.items()}
        new_parts = dict(parts, pos=pos, payload=payload)
        return torch.stack(traj), new_parts, reduce(acc, ("halo_overflow",))

    run.loss = loss
    run.rollout = rollout
    return run


def gather_owned(parts, arr, n_total):
    """Rank-order rows [D*cap, C] (numpy or a tensor) back to input order
    [n_total, C]; ``parts`` the stacked (global) partition."""
    arr = _np(arr)
    src = np.asarray(parts["src"]).reshape(-1)
    mask = np.asarray(parts["mask"]).reshape(-1)
    out = np.zeros((n_total,) + arr.shape[1:], arr.dtype)
    out[src[mask]] = arr[mask]
    return out


def zone_rows(parts, halo_width):
    """[D, 2]: the fluid rows of each slab within ``halo_width`` of its
    left and right planes (what its neighbours receive; 0 at the ends)."""
    axis = parts["axis"]
    out = np.zeros((len(parts["bounds"]), 2), np.int64)
    for d, (lo, hi) in enumerate(parts["bounds"]):
        c, m = parts["pos"][d, :, axis], parts["mask"][d]
        if np.isfinite(lo):
            out[d, 0] = np.sum(m & (c <= lo + halo_width))
        if np.isfinite(hi):
            out[d, 1] = np.sum(m & (c >= hi - halo_width))
    return out


def default_halo_cap(parts, halo_width):
    """Twice the largest zone's rows of a (global) partition, at least 16,
    a multiple of 16: the same on every rank."""
    occ = max(int(zone_rows(parts, halo_width).max()), 1)
    return int(-(-max(2 * occ, 16) // 16) * 16)


def halo_rollout_host(model, group, sample, n_steps, *, chunk=10,
                      halo_width=None, halo_cap=None, safety=1.5, axis=None,
                      bcap_round=1024, log=None):
    """A multi-step slab-decomposed rollout with re-partition, run by
    every rank of ``group`` on the same global ``sample`` (numpy arrays or
    tensors) and weights.

    Steps run in ``chunk``-step pieces; after each, the largest
    ``halo_escaped`` (reduced, so every rank branches alike) decides
    whether the final state is all-gathered and cut into fresh
    equal-count slabs, the same on every rank (numpy over the same
    arrays).  ``halo_width`` defaults to ``safety`` x the receptive field,
    ``halo_cap`` to twice the initial zones' largest occupancy (at least
    16, a multiple of 16).  Returns ``(traj, report)``: ``traj`` [n_steps,
    N, 3] in input order, zeros on rows outside ``fluid_mask``, on rank 0
    (the frames are gathered there alone; None on the other ranks), and
    ``report``, the same on every rank: the exchange's and the searches'
    overflows, the re-partitions, and each rank's largest voxel counts
    of the rollout (``scale_counts`` [D][n_scales]) against the pyramid's
    ``scale_caps``, ``scales_fit`` where none outgrew its cap.  No inflow
    (ownership is fixed within a chunk)."""
    rf = receptive_field(model)
    if halo_width is None:
        halo_width = safety * rf
    n_dev = group.world_size
    sample = {k: _np(v) for k, v in sample.items() if v is not None}
    n_total = int(sample["pos"].shape[0])
    if axis is None:
        # pinned up front (largest fluid extent): re-partitions keep it
        p0, m0 = sample["pos"], sample["fluid_mask"].astype(bool)
        ext = p0[m0].max(0) - p0[m0].min(0) if m0.any() else np.ones(3)
        axis = int(np.argmax(ext))

    def partition(smp):
        return partition_model_sample(smp, n_dev, halo_width, axis=axis,
                                      bcap_round=bcap_round)

    gparts = partition(sample)
    if halo_cap is None:
        halo_cap = default_halo_cap(gparts, halo_width)

    step = make_halo_model_step(model, group, halo_width=halo_width,
                                halo_cap=halo_cap, axis=axis)
    parts = shard_model_parts(gparts, group.rank, group.device)
    frames = []
    report = {"halo_cap": halo_cap, "halo_width": float(halo_width),
              "repartitions": 0, "halo_overflow": 0, "halo_escaped_max": 0,
              "neighbor_overflow": 0, "pair_overflow": -(2 ** 30)}
    counts = None
    done = 0
    while done < n_steps:
        length = min(chunk, n_steps - done)
        traj, parts, aux = step.rollout(parts, length)
        esc = int(aux["halo_escaped"])
        report["halo_overflow"] += int(aux["halo_overflow"])
        report["halo_escaped_max"] = max(report["halo_escaped_max"], esc)
        report["neighbor_overflow"] = max(report["neighbor_overflow"],
                                          int(aux["neighbor_overflow"]))
        report["pair_overflow"] = max(report["pair_overflow"],
                                      int(aux["pair_overflow"]))
        if "cell_overflow" in aux:
            report["cell_overflow"] = max(report.get("cell_overflow", 0),
                                          int(aux["cell_overflow"]))
        c = aux["scale_counts"].cpu().numpy()
        counts = c if counts is None else np.maximum(counts, c)
        caps = aux["scale_caps"].cpu().numpy()
        report.update(scale_counts=counts.tolist(), scale_caps=caps.tolist(),
                      scales_fit=bool((counts <= caps).all()))
        # [D, L, fcap, 3] -> [L, D * fcap, 3], the rank order, on rank 0
        every = group.gather(traj)
        if every is not None:
            every = every.transpose(0, 1).reshape(length, -1, 3)
            for i in range(length):
                frames.append(gather_owned(gparts, every[i], n_total))
        done += length
        if esc > 0 and done < n_steps:
            state = group.all_gather(
                torch.cat([parts["pos"], parts["payload"][:, :3]], 1))
            state = gather_owned(gparts, state.reshape(-1, 6), n_total)
            smp = dict(sample, pos=state[:, :3], vel=state[:, 3:])
            gparts = partition(smp)
            parts = shard_model_parts(gparts, group.rank, group.device)
            report["repartitions"] += 1
            if log is not None:
                log(f"halo re-partition at step {done} (escaped={esc})")
    return (np.stack(frames, 0) if group.rank == 0 else None), report
