"""Rollout loop: repeated model steps with the bench's exactness gate."""

from __future__ import annotations

import torch


class Gate:
    """The exactness gate's counters over a rollout, kept on the device.

    ``update(aux)`` takes a model step's aux: the running max of
    ``neighbor_overflow`` (max true finest-radius count), ``pair_overflow``
    (worst per-pair K-budget excess), each pair's excess over its K budget,
    the per-scale voxel counts, and ``boundary_crop_count`` and
    ``cell_overflow`` where the model reports them, and the sum of
    ``avg_neighbors``.  ``result(neighbor_k, steps)`` reads them once, as
    ``bench.py`` does: ``max_neighbors``, ``pair_overflow``, ``neighbor_k``,
    ``avg_neighbors``, ``pair_excess``, ``scale_counts``/``scale_caps``/
    ``scales_fit``, the optional keys, and ``exact`` (no conv dropped an
    in-radius neighbor).
    """

    OPTIONAL = ("boundary_crop_count", "cell_overflow")

    def __init__(self, device):
        i32 = dict(dtype=torch.int32, device=device)
        self.mx = torch.zeros((), **i32)
        self.po = torch.full((), -(2**30), **i32)
        self.av = torch.zeros((), dtype=torch.float32, device=device)
        self.counts = self.caps = self.pairs = None
        self.keys = ()
        self.extra = {}

    def update(self, aux):
        self.mx = torch.maximum(self.mx, aux["neighbor_overflow"])
        self.po = torch.maximum(self.po, aux["pair_overflow"])
        self.av = self.av + aux["avg_neighbors"]
        self.counts = (aux["scale_counts"] if self.counts is None
                       else torch.maximum(self.counts, aux["scale_counts"]))
        self.caps = aux["scale_caps"]
        detail = aux["pair_overflow_detail"]
        if detail:
            excess = torch.stack(list(detail.values()))
            self.keys = tuple(detail)
            self.pairs = (excess if self.pairs is None
                          else torch.maximum(self.pairs, excess))
        for key in self.OPTIONAL:
            if key in aux:
                self.extra[key] = (aux[key] if key not in self.extra else
                                   torch.maximum(self.extra[key], aux[key]))

    def result(self, neighbor_k, steps):
        gate = {"max_neighbors": int(self.mx),
                "pair_overflow": int(self.po),
                "neighbor_k": int(neighbor_k),
                "avg_neighbors": float(self.av) / max(steps, 1)}
        gate.update({k: int(v) for k, v in self.extra.items()})
        gate["pair_excess"] = ({} if self.pairs is None else
                               dict(zip(self.keys, self.pairs.tolist())))
        if self.counts is not None:
            gate["scale_counts"] = self.counts.tolist()
            gate["scale_caps"] = self.caps.tolist()
            gate["scales_fit"] = all(
                c <= k for c, k in zip(gate["scale_counts"],
                                       gate["scale_caps"]))
        gate["exact"] = (gate["pair_overflow"] <= 0
                         and gate["max_neighbors"] <= gate["neighbor_k"])
        return gate


@torch.no_grad()
def rollout(model, sample, steps, frames=None):
    """Run ``steps`` model steps from ``sample``, with the ``Gate``'s
    counters on the device, read once at the end.  ``frames``, a pair of
    device tensors (pos, vel) of shape [steps + 1, N, 3], receives every
    state: row 0 the input, row i + 1 the state after step i.
    Returns (pos, vel, gate): ``gate["exact"]`` is the bench's gate (no
    conv dropped an in-radius neighbor over the whole rollout),
    ``gate["scales_fit"]`` says no pyramid scale outgrew its capacity.
    """
    s = dict(sample)
    pos, vel = s["pos"], s["vel"]
    gate = Gate(pos.device)
    if frames is not None:
        frames[0][0], frames[1][0] = pos, vel
    for i in range(steps):
        s["pos"], s["vel"] = pos, vel
        pos, vel, aux = model(s)
        gate.update(aux)
        if frames is not None:
            frames[0][i + 1], frames[1][i + 1] = pos, vel
    return pos, vel, gate.result(model.neighbor_k, steps)
