"""Simulator pipeline: rollout, test and validation (port of
dmcf_tpu/pipelines/simulator.py:86-512; training comes with a later slice).

Where JAX runs a whole horizon as one ``lax.scan`` and a sequence's
device-side metrics as one ``lax.map``, the port loops over the steps and
frames on the device and reads back once per sequence (or per
``rollout_chunk``): the rollout writes every frame into a preallocated
[T, N, 3] device tensor, and the per-frame metrics are stacked on the
device.  The semantics are the JAX package's, including its clipping of
predictions to the boundary's bounding box (ROADMAP §3: with one boundary
point that box is a point).
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from datetime import datetime
from glob import glob

import numpy as np
import torch

from ..data import get_rollout, pad_rollout_state, write_results
from ..models.losses import density_loss
from ..ops.emd import emd_loss
from ..ops.windows import get_window_func
from ..rollout import rollout
from .base import BasePipeline
from .metrics import chamfer_distance, compare_dist, distance, merge_dicts

log = logging.getLogger(__name__)

_STATE_KEYS = ("pos", "vel", "grav", "box", "box_normals", "fluid_mask",
               "box_mask")


class Simulator(BasePipeline):
    def __init__(self, model, dataset=None, name="Simulator",
                 main_log_dir="./logs", device="cuda", split="train",
                 **kwargs):
        super().__init__(model=model, dataset=dataset, name=name,
                         main_log_dir=main_log_dir, device=device,
                         split=split, **kwargs)

    @contextlib.contextmanager
    def _file_log(self, split):
        """Per-run log file, detached and closed when the run ends."""
        timestamp = datetime.now().strftime("%Y-%m-%d_%H:%M:%S")
        log_path = os.path.join(self.cfg.logs_dir,
                                f"log_{split}_{timestamp}.txt")
        log.info("Logging in file : %s", log_path)
        handler = logging.FileHandler(log_path)
        pkg_log = logging.getLogger("dmcf_tpu_torch")
        pkg_log.addHandler(handler)
        try:
            yield log_path
        finally:
            pkg_log.removeHandler(handler)
            handler.close()

    # ------------------------------------------------------------------
    # single-step / rollout inference
    # ------------------------------------------------------------------

    def _device_state(self, state, frame=None):
        """A padded numpy state as a model sample on the pipeline's device:
        ``pos``/``vel``/``grav`` from ``frame`` (all frames when None)."""
        out = {}
        for k in _STATE_KEYS:
            v = state.get(k)
            if v is None:
                continue
            if frame is not None and k in ("pos", "vel", "grav"):
                v = v[frame]
            out[k] = torch.as_tensor(np.ascontiguousarray(v),
                                     device=self.device)
        return out

    @torch.no_grad()
    def run_inference(self, state):
        """One simulation step on a padded state dict."""
        s = {k: state[k] for k in _STATE_KEYS if state.get(k) is not None}
        pos, vel, _ = self.model(s)
        out = dict(state)
        out["pos"], out["vel"] = pos, vel
        return out

    def run_rollout(self, rollout_data, timesteps=2, bucket=64):
        """Free rollouts over full horizons.  Returns per sequence
        (positions [T, n, 3], velocities [T, n, 3]) as numpy arrays.

        ``pipeline.rollout_chunk`` (default 0 = the whole horizon) bounds
        the steps run between two reads of the frames back to the host;
        a chunked run equals the whole-horizon run.
        """
        chunk = int(self.cfg.get("rollout_chunk") or 0)
        results, timings = [], []
        for data in rollout_data:
            state = pad_rollout_state(data, bucket=bucket)
            s = self._device_state(state, frame=0)
            n_steps = max(timesteps - 1, 1)
            exe_steps = min(chunk, n_steps) if chunk else n_steps
            shape = (exe_steps + 1,) + tuple(s["pos"].shape)
            frames = (torch.empty(shape, device=self.device),
                      torch.empty(shape, device=self.device))
            ps_parts, vs_parts = [], []
            max_nbr, pair_over, avg_sum = 0, -(2 ** 30), 0.0
            t0 = time.time()
            done = 0
            while done < n_steps:
                take = min(exe_steps, n_steps - done)
                _, _, gate = rollout(self.model, s, take, frames=frames)
                # frame 0 of each chunk repeats the last one read; copied
                # out, since the next chunk reuses the buffer (on the CPU
                # .cpu() is no copy)
                first = 0 if done == 0 else 1
                ps_parts.append(np.array(frames[0][first:take + 1].cpu()))
                vs_parts.append(np.array(frames[1][first:take + 1].cpu()))
                max_nbr = max(max_nbr, gate["max_neighbors"])
                pair_over = max(pair_over, gate["pair_overflow"])
                avg_sum += gate["avg_neighbors"] * take
                s["pos"] = frames[0][take].clone()
                s["vel"] = frames[1][take].clone()
                done += take
            timings.append((time.time() - t0) / n_steps)
            n = state["n_fluid"]
            log.info("rollout %d: max_neighbors=%d avg_neighbors=%.1f (K=%d)",
                     len(results), max_nbr, avg_sum / n_steps,
                     int(getattr(self.model, "neighbor_k", 0)))
            self._check_neighbor_overflow(max_nbr, f"rollout {len(results)}")
            self._check_pair_overflow(pair_over, f"rollout {len(results)}")
            ps = np.concatenate(ps_parts, 0)
            vs = np.concatenate(vs_parts, 0)
            results.append((ps[:, :n], vs[:, :n]))
        mean = max(float(np.mean(timings)), 1e-9)
        log.info("Average runtime: %.5f s/step (%.1f steps/s)", mean,
                 1.0 / mean)
        self.last_steps_per_sec = 1.0 / mean
        return results

    def _check_neighbor_overflow(self, max_neighbors, where):
        """Warn (default) or raise (``strict_overflow: true``) when the true
        neighbor count at the finest radius exceeds the padded K budget:
        dropped neighbors silently change the physics."""
        k = int(getattr(self.model, "neighbor_k", 0))
        if k and max_neighbors > k:
            msg = (f"neighbor overflow at {where}: max true neighbor count "
                   f"{int(max_neighbors)} > neighbor_k={k}; neighbors are "
                   f"being dropped — raise model.neighbor_k")
            if bool(self.cfg.get("strict_overflow", False)):
                raise RuntimeError(msg)
            log.warning(msg)

    def _check_pair_overflow(self, excess, where):
        """Cross-scale trunk pairs have their own K budgets
        (``model.neighbor_k_gaps``); ``excess`` is the worst
        ``true_count - K`` over every cached pair search."""
        if excess > 0:
            msg = (f"pair-search overflow at {where}: worst true neighbor "
                   f"count exceeds its pair K budget by {int(excess)}; "
                   f"neighbors are being dropped — raise model.neighbor_k"
                   f"_gaps (or neighbor_k)")
            if bool(self.cfg.get("strict_overflow", False)):
                raise RuntimeError(msg)
            log.warning(msg)

    # ------------------------------------------------------------------
    # test / valid
    # ------------------------------------------------------------------

    def _split_data(self, split):
        dg_cfg = dict(self.cfg.get("data_generator") or {})
        split_cfg = dict(dg_cfg.pop(split, {}) or {})
        for other in ("train", "valid", "test"):
            dg_cfg.pop(other, None)
        return (get_rollout(getattr(self.dataset, split), **dg_cfg,
                            **split_cfg), split_cfg)

    def run_test(self, epoch=None):
        with self._file_log("test"):
            return self._run_test(epoch)

    def _run_test(self, epoch=None):
        test_data, _ = self._split_data("test")
        if epoch is None:
            epoch = self.load_ckpt(self.model_cfg.get("ckpt_path"))
        log.info("Started testing")

        horizon = test_data[0]["pos"].shape[0]
        results = self.run_rollout(test_data, horizon)

        for i, (ps, vs) in enumerate(results):
            data = test_data[i]
            out_dir = os.path.join(self.cfg.out_dir, "visual", "%04d" % i)
            os.makedirs(out_dir, exist_ok=True)
            output = [
                (ps, {"name": "pred", "type": "PARTICLE"}),
                (data["pos"], {"name": "gt", "type": "PARTICLE"}),
                (data["box"], {"name": "bnd", "type": "PARTICLE"}),
            ]
            path = os.path.join(out_dir, "%04d.hdf5" % epoch)
            write_results(path, type(self.model).__name__, output)
            for f in glob(os.path.join(out_dir, "*.hdf5")):
                if f != path:
                    os.remove(f)

        if self.cfg.get("test_compute_metric", False):
            self.run_valid(epoch)

    def run_valid(self, epoch=None):
        with self._file_log("valid"):
            return self._run_valid(epoch)

    def _run_valid(self, epoch=None):
        """Validation metric suite: mse, chamfer both directions, density /
        max-density, EMD, velocity-distribution KL, single-step mse.  The
        device-side metrics of a sequence come back in one read
        (``_seq_device_metrics``); the numpy metrics run per frame."""
        valid_data, valid_cfg = self._split_data("valid")
        if epoch is None:
            epoch = self.load_ckpt(self.model_cfg.get("ckpt_path"))
        log.info("Started validation")

        horizon = valid_data[0]["pos"].shape[0]
        results = self.run_rollout(valid_data, horizon)

        eval_stride = int(valid_cfg.get("eval_stride", 1))
        split = self.cfg.get("split", "train")
        # the full suite runs outside the train split;
        # ``valid_full_metrics: true`` forces it during training
        full = bool(self.cfg.get("valid_full_metrics", split != "train"))

        losses = []
        for i, data in enumerate(valid_data):
            target_pos, target_vel = data["pos"], data["vel"]
            box = data["box"]
            ps, vs = results[i]
            dev = self._seq_device_metrics(data, ps, full)
            seq_losses = []
            for t in range(1, target_pos.shape[0]):
                if t % eval_stride != 0:
                    continue
                pos, vel = ps[t], vs[t]
                if box.shape[0] > 0:
                    pos = np.clip(pos, box.min(axis=0), box.max(axis=0))
                entry = {}
                entry["mse_val"] = float(np.mean(distance(target_pos[t],
                                                          pos)))
                entry["chamfer_val"] = float(np.mean(
                    chamfer_distance(target_pos[t], pos)))
                if full:
                    entry["dens_val"] = float(dev["dens_val"][t - 1])
                    entry["max_dens_val"] = float(
                        dev["max_dens_val"][t - 1])
                    entry["chamfer_val_2"] = float(np.mean(
                        chamfer_distance(pos, target_pos[t])))
                    entry["emd"] = float(dev["emd"][t - 1])
                    entry["vel_diff_val"] = float(
                        compare_dist(target_vel[t], vel))
                    entry["vel_diff_val_2"] = float(
                        compare_dist(vel, target_vel[t]))
                # single-step prediction from ground truth
                entry["mse_single_val"] = float(
                    dev["mse_single_val"][t - 1])
                losses.append(entry)
                seq_losses.append(entry)

            if seq_losses:
                mean_seq = merge_dicts(
                    seq_losses, lambda x, y: x + y / len(seq_losses))
                log.info("%d - %s", i, " ".join(
                    "%s: %.5f" % (k, v) for k, v in mean_seq.items()))

        loss = merge_dicts(losses, lambda x, y: x + y / max(len(losses), 1))
        loss["loss"] = sum(loss.values())
        log.info("validation of epoch %d - %s > loss: %.5f", epoch,
                 " ".join("%s: %.5f" % (k, v) for k, v in loss.items()
                          if k != "loss"), loss["loss"])
        self.valid_loss = loss
        return loss

    def _density_metrics(self, gt, pred, box, mask, bmask, radius0=0.01):
        win_poly6 = get_window_func("poly6")
        win_dens = get_window_func(getattr(self.model, "window_dens", None))
        pred_all = torch.cat([pred, box], 0)
        gt_all = torch.cat([gt, box], 0)
        allmask = torch.cat([mask, bmask], 0)
        k = int(getattr(self.model, "neighbor_k", 64))
        # the in-sets are crossed (prediction scored against the ground
        # truth's surroundings and back), as in the JAX package
        dens_v = density_loss(gt, pred, mask, mask, gt_in=pred_all,
                              pred_in=gt_all, gt_in_mask=allmask,
                              pred_in_mask=allmask, win=win_poly6, k=k,
                              radius=0.005)
        maxd_v = density_loss(pred, gt, mask, mask, gt_in=pred_all,
                              pred_in=gt_all, gt_in_mask=allmask,
                              pred_in_mask=allmask, radius=radius0,
                              win=win_dens, use_max=True, k=k)
        return dens_v, maxd_v

    @torch.no_grad()
    def _seq_device_metrics(self, data, pred, full, bucket=64):
        """The device-side valid metrics of one sequence, read back once.

        Returns numpy arrays of shape [T-1]: ``mse_single_val`` and (when
        ``full``) ``dens_val`` / ``max_dens_val`` / ``emd``; index t-1
        scores frame t.  The single-step prediction runs the model from
        ground-truth frame t-1; the others score the rollout frame t,
        clipped to the boundary's bounding box."""
        state = pad_rollout_state(data, bucket=bucket)
        n = state["n_fluid"]
        pred_pad = state["pos"].copy()
        pred_pad[:, :n] = pred
        seq = self._device_state(state)
        pred_pos = torch.as_tensor(pred_pad, device=self.device)
        gt_pos, gt_vel, grav = seq["pos"], seq["vel"], seq.get("grav")
        box, fm, bm = seq["box"], seq["fluid_mask"], seq["box_mask"]
        radius0 = float(self.model.particle_radii[0])
        n_valid = torch.clamp(fm.sum(), min=1)
        have_box = bm.any()
        lo = torch.where(have_box, torch.where(bm[:, None], box, torch.inf)
                         .min(dim=0).values, -torch.inf)
        hi = torch.where(have_box, torch.where(bm[:, None], box, -torch.inf)
                         .max(dim=0).values, torch.inf)
        base = {k: seq[k] for k in ("box", "box_normals", "fluid_mask",
                                    "box_mask")}
        nn = fm.sum(dtype=torch.int32)[None]
        out = {k: [] for k in (("mse_single_val", "dens_val",
                                "max_dens_val", "emd") if full
                               else ("mse_single_val",))}
        for t in range(1, gt_pos.shape[0]):
            g_t = gt_pos[t]
            p_c = torch.clamp(pred_pos[t], lo, hi)
            s = dict(base, pos=gt_pos[t - 1], vel=gt_vel[t - 1])
            if grav is not None:
                s["grav"] = grav[t - 1]
            ps_, _, _ = self.model(s)
            d = torch.sqrt(((ps_ - g_t) ** 2).sum(dim=-1))
            out["mse_single_val"].append(
                torch.where(fm, d, 0.0).sum() / n_valid)
            if full:
                dens_v, maxd_v = self._density_metrics(
                    g_t, p_c, box, fm, bm, radius0=radius0)
                out["dens_val"].append(dens_v)
                out["max_dens_val"].append(maxd_v)
                out["emd"].append(emd_loss(g_t[None], p_c[None], n=nn,
                                           m=nn)[0])
        stacked = torch.stack([torch.stack(v) for v in out.values()]).cpu()
        return {k: stacked[i].numpy() for i, k in enumerate(out)}

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------

    def run_train(self):
        raise NotImplementedError(
            "training is ported in a later slice (ROADMAP queue 1 item 10: "
            "the BPTT loop and the K-list conv's backward)")
