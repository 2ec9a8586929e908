"""Simulator pipeline: rollout, test, validation and training (port of
dmcf_tpu/pipelines/simulator.py).

Where JAX runs a whole horizon as one ``lax.scan`` and a sequence's
device-side metrics as one ``lax.map``, the port loops over the steps and
frames on the device and reads back once per sequence (or per
``rollout_chunk``): the rollout writes every frame into a preallocated
[T, N, 3] device tensor, and the per-frame metrics are stacked on the
device.  The semantics are the JAX package's, including its clipping of
predictions to the boundary's bounding box (ROADMAP §3: with one boundary
point that box is a point).

Training (``make_train_step``, ``Simulator.run_train``) is JAX's BPTT step
with the batch as a Python loop over items: each item's warm-up runs under
``torch.no_grad``, its window unrolls with ``torch.utils.checkpoint`` per
step (JAX's ``jax.checkpoint(step)``), and its loss, normalised by the
full batch's ``sum(time_w) * B``, is back-propagated on its own.  The loss
is a sum over items, so the summed gradients are the batch's, and only one
item's window is held at a time (what JAX's ``grad_accum`` is for).

Data-parallel training (``data_parallel``, ``_setup_data_parallel``): one
process a rank; rank 0 draws the global batch and scatters it, each
rank receiving only its contiguous slice, which it steps normalised by
the GLOBAL ``sum(time_w) *
B``, and the step sums the gradients over the ranks in one flat
all-reduce before ``w_decay`` and the clip, as JAX's GSPMD step does.
Only rank 0 writes checkpoints and summaries and runs valid and test; the
others wait at a barrier.
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
from torch.utils.checkpoint import checkpoint

from ..data import get_dataloader, get_rollout, pad_rollout_state, \
    write_results
from ..models.losses import density_loss, get_loss
from ..ops.emd import emd_loss
from ..ops.windows import get_window_func
from ..rollout import rollout
from .base import BasePipeline
from .metrics import chamfer_distance, compare_dist, distance, merge_dicts

log = logging.getLogger(__name__)

_STATE_KEYS = ("pos", "vel", "grav", "box", "box_normals", "fluid_mask",
               "box_mask")


def _clip_by_norm(g, norm):
    """``g`` scaled to L2 norm ``norm`` when longer (each tensor on its
    own, not by the global norm)."""
    n = torch.sqrt((g * g).sum())
    return torch.where(n > norm, g * (norm / n), g)


def compute_time_weights(step, window_it, windows, window_bnds, time_blend):
    """Per-unroll-step loss weights with the curriculum cross-fade: after a
    window boundary the newly added trailing steps fade in linearly over
    ``time_blend`` optimizer steps."""
    window = windows[window_it]
    time_w = np.ones((window,), np.float32)
    if window_it > 0:
        a = (step - window_bnds[window_it - 1] + 1) / time_blend
        if a < 1.0:
            diff = windows[window_it] - windows[window_it - 1]
            time_w[-diff:] = np.clip(a - np.arange(diff) / diff, 0.0, 1.0)
    return time_w


def advance_curriculum(step, state, windows, window_bnds, max_warm_up,
                       warm_up_bnds, iterations, its_bnds):
    """Advance (window_it, warm_up_it, it_idx) past any boundaries crossed
    at ``step``; returns the new state and whether the loader must be
    rebuilt."""
    window_it, warm_up_it, it_idx = state
    rebuild = False
    while window_it < min(len(windows) - 1, len(window_bnds)) \
            and step >= window_bnds[window_it]:
        window_it += 1
        rebuild = True
    while warm_up_it < min(len(max_warm_up) - 1, len(warm_up_bnds)) \
            and step >= warm_up_bnds[warm_up_it]:
        warm_up_it += 1
        rebuild = True
    while it_idx < min(len(iterations) - 1, len(its_bnds)) \
            and step >= its_bnds[it_idx]:
        it_idx += 1
    return (window_it, warm_up_it, it_idx), rebuild


def lr_schedule(opt_cfg):
    """Piecewise-constant learning rate of the config's ``optimizer``
    section: ``lr_values[i]`` from update ``lr_boundaries[i - 1]`` on
    (update counted from 0; boundaries compared by ``step >= b``)."""
    bounds = [int(b) for b in opt_cfg.get("lr_boundaries", [])]
    values = [float(v) for v in opt_cfg.get("lr_values", [1e-3])]
    return lambda step: values[sum(step >= b for b in bounds)]


def make_optimizer(model, opt_cfg):
    """Adam (eps 1e-6) and its LR schedule, as optax evaluates it: update
    i uses ``lr(i)``.  Returns (optimizer, scheduler); call
    ``scheduler.step()`` after each ``optimizer.step()``."""
    opt = torch.optim.Adam(model.parameters(), lr=1.0, eps=1e-6)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, lr_schedule(opt_cfg))


class Simulator(BasePipeline):
    def __init__(self, model, dataset=None, name="Simulator",
                 main_log_dir="./logs", device="cuda", split="train",
                 **kwargs):
        super().__init__(model=model, dataset=dataset, name=name,
                         main_log_dir=main_log_dir, device=device,
                         split=split, **kwargs)
        self.loss_cfg = dict(self.cfg.get("loss_cfg") or {})
        if not self.loss_cfg:
            self.loss_cfg = {
                "weighted_mse": {"typ": "weighted_mse", "fac": 1.0,
                                 "gamma": 0.25, "neighbor_scale": 0.025}}
        self.loss_fns = {k: get_loss(**dict(v))
                         for k, v in self.loss_cfg.items()}
        self.group = None  # the data-parallel group (run_train)

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

    def _make_train_step(self, window, its, max_err, max_dens_err):
        return make_train_step(
            self.model, self.loss_fns, self.optimizer, self.scheduler,
            window=window, its=its, max_err=max_err,
            max_dens_err=max_dens_err,
            w_decay=float(self.cfg.get("w_decay", 0) or 0),
            grad_norm=float(self.cfg.get("grad_clip_norm", -1) or -1),
            grad_accum=int(self.cfg.get("grad_accum", 1) or 1),
            group=self.group)

    def _device_batch(self, batch):
        """(``batch`` on the pipeline's device, the host buffers its copies
        read).  On the card each array goes through pinned host memory
        and a ``non_blocking`` copy on the current stream, the one the
        step runs on, so the copy overlaps the step in flight; keep the
        host buffers until the batch is consumed."""
        host = {k: torch.as_tensor(v) for k, v in batch.items()
                if v is not None}
        if self.device.type != "cuda":
            return {k: v.to(self.device) for k, v in host.items()}, None
        pinned = {k: v.pin_memory() for k, v in host.items()}
        return {k: v.to(self.device, non_blocking=True)
                for k, v in pinned.items()}, pinned

    def _setup_data_parallel(self):
        """Data-parallel training over the ranks of the process group
        (``torchrun``'s, or one already running).  ``data_parallel: auto``
        (default) engages when the world size is above 1 and divides the
        batch; ``true`` requires that it divides (a world of one runs the
        collectives too); ``false`` disables.  The parameters start as
        rank 0's."""
        from ..parallel.dist import env_rank

        mode = self.cfg.get("data_parallel", "auto")
        world = (torch.distributed.get_world_size()
                 if torch.distributed.is_initialized() else env_rank()[1])
        bs = int(self.cfg.get("batch_size", 1))
        enable = (world > 1 and bs % world == 0) if mode == "auto" \
            else bool(mode)
        self.group = None
        if not enable:
            return
        if bs % world:
            raise ValueError(f"data_parallel: batch_size {bs} not "
                             f"divisible by the world size {world}")
        from ..parallel import make_mesh, replicated_sharding
        self.group = make_mesh(self.device)
        replicated_sharding(self.model, self.group)
        log.info("data-parallel training over %d ranks (%s, per-rank "
                 "batch %d)", world, self.group.transport, bs // world)

    @staticmethod
    def _pack_train_stats(lvec, pre_eff, stats):
        """One fp32 vector on ``lvec``'s device, JAX's layout: the loss
        vector, then the mean of ``pre_eff``, ``max_neighbors``,
        ``pair_overflow`` and ``avg_neighbors``; formed without reading the
        device back (``pre_eff``, on the host, goes up non-blocking)."""
        pre = pre_eff.float().mean()
        if pre.device != lvec.device:
            pre = pre.pin_memory().to(lvec.device, non_blocking=True)
        return torch.cat([lvec.float(), torch.stack([
            pre, stats["max_neighbors"].float(),
            stats["pair_overflow"].float(),
            stats["avg_neighbors"].float()])])

    def _flush_train_logs(self, queue):
        """Reads the queued entries' packed vectors back in one stacked
        transfer and emits each; returns their logged entries."""
        mat = torch.stack([e[-1] for e in queue]).cpu().numpy()
        return [self._emit_train_log(*e[:-1], vec)
                for e, vec in zip(queue, mat)]

    def _emit_train_log(self, step, pre, time_w, lr, vec):
        n = len(self.loss_fns)
        losses = {k: float(v) for k, v in zip(self.loss_fns, vec[:n])}
        losses["loss"] = float(sum(losses.values()))
        losses["timesteps"] = float(np.sum(time_w))
        losses["warmup"] = float(np.mean(pre))
        losses["warmup_diff"] = losses["warmup"] - float(vec[n])
        losses["max_neighbors"] = float(vec[n + 1])
        losses["avg_neighbors"] = float(vec[n + 3])
        self._check_neighbor_overflow(losses["max_neighbors"],
                                      f"train step {step}")
        self._check_pair_overflow(float(vec[n + 2]), f"train step {step}")
        log.info("step %d - %s", step, " ".join(
            "%s: %.5f" % (k, v) for k, v in losses.items()))
        losses["learning_rate"] = lr
        self.save_logs(self.writer, step, [losses], "train")
        return dict(losses, step=step)

    def _profile_start(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        return prof

    def _profile_stop(self, prof, step):
        """Ends the capture of train step ``step`` (the card synchronised
        first), writes its Chrome trace to ``logs_dir/profile/
        train_step_<step>[_rank<r>].json`` and logs its path, and on the
        card its summary where it holds device events."""
        from ..profile_step import format_report, trace_file_summary

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        out = os.path.join(self.cfg.logs_dir, "profile")
        os.makedirs(out, exist_ok=True)
        rank = "" if self.group is None else f"_rank{self.group.rank}"
        path = os.path.join(out, f"train_step_{step}{rank}.json")
        prof.export_chrome_trace(path)
        log.info("profiler trace written to %s", path)
        if self.device.type != "cuda":
            return
        summary = trace_file_summary(path)
        if summary["device_events"]:
            log.info("train step %d on the device:\n%s", step,
                     "\n".join(format_report(summary, top=10)))

    def run_train(self):
        """The BPTT training loop (curricula, loader rebuilds, logs to
        ``metrics.jsonl``, checkpoints, valid / test per epoch).  Returns
        the logged step entries (one dict per ``log_every`` steps).

        As JAX's loop: the next batch is drawn and sent to the device
        while the step runs (one deep; dropped when the curriculum
        rebuilds the loader); each log interval's telemetry stays on the
        device, packed in one vector, and is read back in one transfer
        every ``log_flush_steps`` (default 1000) entries and at each
        epoch's end, where an overflow then raises; ``profile_step: N``
        (N >= 0) wraps global train step N (``epoch * iter + i``) in
        ``torch.profiler`` (CPU, and CUDA on the card), written as a Chrome
        trace under ``logs_dir/profile/`` (JAX writes a TensorBoard
        profile directory there; ``profile_step.trace_file_summary`` reads
        the trace); ``DMCF_LOOP_TIMING=1`` logs the host seconds of the
        loop's fetch, dispatch, prefetch, log and other sections each log
        interval (no synchronisation added: on the card ``dispatch`` is
        the host's time to issue the step)."""
        with self._file_log("train"):
            return self._run_train()

    def _run_train(self):
        cfg = self.cfg
        if cfg.get("grad_accum_host", False):
            raise NotImplementedError(
                "grad_accum_host is a TPU execution mode, not ported")
        dg_cfg = dict(cfg.get("data_generator") or {})
        train_cfg = dict(dg_cfg.pop("train", {}) or {})
        dg_cfg.pop("valid", None)
        dg_cfg.pop("test", None)

        windows = list(cfg.get("windows", [2]))
        window_bnds = list(cfg.get("window_bnds", []))
        max_warm_up = list(cfg.get("max_warm_up", [0]))
        warm_up_bnds = list(cfg.get("warm_up_bnds", []))
        iterations = list(cfg.get("iterations", [0]))
        its_bnds = list(cfg.get("its_bnds", []))
        time_blend = int(cfg.get("time_blend", 1))
        max_err = cfg.get("max_err", None)
        max_dens_err = cfg.get("max_dens_err", None)
        log_every = int(cfg.get("log_every", 10))
        flush_every = int(cfg.get("log_flush_steps", 1000))
        profile_at = int(cfg.get("profile_step", -1))
        loop_timing = bool(int(os.environ.get("DMCF_LOOP_TIMING", "0")))
        tmr = dict.fromkeys(("fetch", "dispatch", "prefetch", "log",
                             "other"), 0.0)

        self.optimizer, self.scheduler = make_optimizer(
            self.model, dict(cfg.get("optimizer") or {}))
        start_ep = self.load_ckpt(
            self.model_cfg.get("ckpt_path"),
            is_resume=bool(self.model_cfg.get("is_resume", True)))
        self._setup_data_parallel()
        group = self.group
        main = group is None or group.rank == 0

        def make_loader(window, warm):
            # under data parallelism rank 0 draws the global batch
            if not main:
                return None
            return get_dataloader(self.dataset.train,
                                  batch_size=int(cfg.batch_size),
                                  window=window, pre_frames=warm,
                                  **dg_cfg, **train_cfg)

        def fetch():
            """(this rank's items of the next global batch on the device,
            their host buffers, the global batch's warm-up frames
            ``pre``); every rank calls it at the same step, so the
            scatter pairs"""
            if group is None:
                batch = next(loader)
                return (*self._device_batch(batch), batch["pre"])
            mine = None
            if main:
                from ..parallel import shard_batch
                batch = next(loader)
                mine = [(shard_batch(batch, group, r), batch["pre"])
                        for r in range(group.world_size)]
            batch, pre = group.scatter_object(mine)
            return (*self._device_batch(batch), pre)

        window_it, warm_up_it, it_idx = 0, 0, 0
        logged, queue, pending = [], [], None
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        log.info("Writing summary in %s.", self.tensorboard_dir)
        log.info("Started training")
        loader = make_loader(windows[0], max_warm_up[0])
        t_prev = time.perf_counter()
        try:
            for epoch in range(start_ep, int(cfg.max_epoch) + 1):
                log.info("=== EPOCH %d/%d ===", epoch, int(cfg.max_epoch))
                for i in range(int(cfg.iter)):
                    step = epoch * int(cfg.iter) + i
                    (window_it, warm_up_it, it_idx), rebuild = \
                        advance_curriculum(
                            step, (window_it, warm_up_it, it_idx), windows,
                            window_bnds, max_warm_up, warm_up_bnds,
                            iterations, its_bnds)
                    if rebuild:
                        if loader is not None:
                            loader.close()
                        loader = make_loader(windows[window_it],
                                             max_warm_up[warm_up_it])
                        pending = None  # drawn for the old window
                    t0 = time.perf_counter()
                    tmr["other"] += t0 - t_prev
                    batch, _, pre = pending or fetch()
                    time_w = compute_time_weights(step, window_it, windows,
                                                  window_bnds, time_blend)
                    t1 = time.perf_counter()
                    tmr["fetch"] += t1 - t0
                    train_step = self._make_train_step(
                        windows[window_it], iterations[it_idx], max_err,
                        max_dens_err)
                    prof = self._profile_start() if step == profile_at \
                        else None
                    lvec, pre_eff, stats = train_step(batch, time_w)
                    t2 = time.perf_counter()
                    tmr["dispatch"] += t2 - t1
                    pending = fetch()
                    t3 = time.perf_counter()
                    tmr["prefetch"] += t3 - t2
                    if prof is not None:
                        self._profile_stop(prof, step)
                    if i == 0 and epoch == start_ep:
                        log.info("Parameter count '%s': %d",
                                 type(self.model).__name__,
                                 sum(p.numel()
                                     for p in self.model.parameters()))
                    t_prev = time.perf_counter()
                    if i % log_every == 0:
                        queue.append((step, pre, time_w,
                                      self.optimizer.param_groups[0]["lr"],
                                      self._pack_train_stats(lvec, pre_eff,
                                                             stats)))
                        if len(queue) >= flush_every:
                            logged += self._flush_train_logs(queue)
                            queue = []
                        if loop_timing:
                            tmr["log"] += time.perf_counter() - t3
                            log.info("loop timing (s since last): "
                                     + " ".join("%s=%.2f" % kv
                                                for kv in tmr.items()))
                            tmr = dict.fromkeys(tmr, 0.0)

                if queue:
                    logged += self._flush_train_logs(queue)
                    queue = []
                if main:
                    self._end_epoch(epoch)
                if group is not None:
                    group.barrier()
        finally:
            if loader is not None:
                loader.close()
            if group is not None:
                group.close()
        if self.device.type == "cuda":
            peak = torch.cuda.max_memory_allocated(self.device) / 2 ** 30
            log.info("peak device memory allocated: %.2f GiB", peak)
            self.writer.scalar("train/peak_memory_gib", peak, 0)
            self.writer.flush()
        return logged

    def _end_epoch(self, epoch):
        """Checkpoint, valid and test at the end of an epoch, as configured
        (rank 0 alone under data parallelism)."""
        cfg = self.cfg
        if epoch % int(cfg.get("save_ckpt_freq", 1)) == 0:
            self.save_ckpt(epoch)
        # True = every epoch, False/0 = never, int N = every N
        valid_every = cfg.get("run_valid_every_epoch", True)
        if valid_every and epoch % max(int(valid_every), 1) == 0:
            self.run_valid(epoch)
            self.save_logs(self.writer, epoch, [self.valid_loss], "valid")
        test_every = cfg.get("run_test_every_epoch", True)
        if test_every and epoch % max(int(test_every), 1) == 0:
            self.run_test(epoch)


def make_train_step(model, loss_fns, optimizer, scheduler=None, *, window,
                    its=0, max_err=None, max_dens_err=None, w_decay=0.0,
                    grad_norm=-1.0, grad_accum=1, group=None):
    """The BPTT train step (standalone; used by ``Simulator.run_train``).

    Returns ``step(batch, time_w) -> (lvec, pre_eff, stats)``: ``batch`` a
    dict of device tensors (``pos``/``vel``[/``grav``] [B, T, N, 3],
    ``box``/``box_normals`` [B, Nb, 3], masks, ``pre`` [B]), ``time_w``
    the window's loss weights.  The step leaves the batch's gradients in
    each parameter's ``.grad`` (after ``w_decay`` and the per-tensor clip),
    then runs ``optimizer.step()`` and ``scheduler.step()``.  ``lvec`` is
    the loss vector (one entry per loss, normalised by ``sum(time_w) *
    B``), ``pre_eff`` [B] the warm-up steps kept, ``stats`` the step's
    neighbour-budget health (``max_neighbors``, ``pair_overflow``,
    ``avg_neighbors``).  ``grad_accum`` must divide B: items are
    back-propagated one at a time, so any grouping gives the full batch's
    gradient.

    With a ``group`` (``parallel.dist.Group``) the step is data-parallel:
    ``batch`` is this rank's slice of the global batch, each item's loss is
    normalised by the global ``sum(time_w) * B * world_size``, the
    gradients are summed over the ranks (one flat all-reduce) before
    ``w_decay`` and the clip, and ``lvec``, ``pre_eff`` and ``stats`` are
    the global batch's, the same on every rank.
    """
    win_dens = get_window_func(getattr(model, "window_dens", None))
    radius0 = float(model.particle_radii[0])
    k = int(getattr(model, "neighbor_k", 64))
    params = [p for p in model.parameters() if p.requires_grad]

    def eval_losses(sample, pos, aux, target, target_prev, pre_eff):
        mask = sample["fluid_mask"]
        return torch.stack([
            fn(target, pos, mask,
               num_fluid_neighbors=aux["num_fluid_neighbors"],
               input_pos=sample["pos"], target_prev=target_prev,
               pre_steps=pre_eff, pos_correction=aux["pos_correction"])
            for fn in loss_fns.values()])

    def warmup(item, pre, make_sample):
        """Self-rollout warm-up with the divergence guards (no grads)."""
        pos, vel = item["pos"][0], item["vel"][0]
        p, prev_err, prev_derr = 0, 0.0, 0.0
        fm, bm = item["fluid_mask"], item["box_mask"]
        with torch.no_grad():
            while p < pre:
                pos2, vel2, _ = model(make_sample(pos, vel), training=True)
                diverged = False
                tgt = item["pos"][p]
                if max_err is not None:
                    err = float(torch.where(
                        fm, (pos2 - tgt).abs().sum(-1), 0.0).max())
                    diverged |= p > 0 and err > prev_err and err > max_err
                    prev_err = err
                if max_dens_err is not None:
                    allm = torch.cat([fm, bm])
                    derr = float(density_loss(
                        pos2, tgt, fm, fm,
                        gt_in=torch.cat([pos2, item["box"]], 0),
                        pred_in=torch.cat([tgt, item["box"]], 0),
                        gt_in_mask=allm, pred_in_mask=allm, radius=radius0,
                        win=win_dens, use_max=True, k=k))
                    diverged |= p > 0 and derr > prev_derr \
                        and derr > max_dens_err
                    prev_derr = derr
                if diverged:  # stop WITHOUT committing this step
                    break
                pos, vel, p = pos2, vel2, p + 1
        # the final loop counter: pre - 1 when completed, else the break
        pre_eff = max(pre - 1, 0) if p == pre else p
        return pos, vel, pre_eff

    def item_loss(item, time_w, denom):
        """One item's warm-up and window; back-propagates its share of the
        batch loss.  Returns (its lvec share, pre_eff, stats)."""
        # per-particle "feats" (use_feats) ride along where a batch has
        # them; the JAX package's batches never do
        base = {k2: item[k2] for k2 in ("box", "box_normals", "fluid_mask",
                                        "box_mask", "feats") if k2 in item}
        grav0 = item["grav"][0] if "grav" in item else None

        def make_sample(pos, vel):
            s = dict(base, pos=pos, vel=vel)
            if grav0 is not None:
                s["grav"] = grav0
            return s

        pos, vel, pre_eff = warmup(item, int(item["pre"]), make_sample)

        def step(pos, vel, t):
            sample = make_sample(pos, vel)
            target = item["pos"][t + pre_eff + 1]
            target_prev = item["pos"][t + pre_eff]
            pos2, vel2, aux = model(sample, training=True)
            losses = [eval_losses(sample, pos2, aux, target, target_prev,
                                  pre_eff)]
            for _ in range(1, max(its, 1)):
                pos2, vel2, aux = model(sample, training=True,
                                        vel_corr=vel2)
                losses.append(eval_losses(sample, pos2, aux, target,
                                          target_prev, pre_eff))
            lvec = torch.stack(losses).mean(dim=0)
            stats = torch.stack([
                aux["neighbor_overflow"].float(),
                aux["pair_overflow"].float(), aux["avg_neighbors"].float()])
            return pos2, vel2, lvec * time_w[t], stats

        lvecs, stats = [], []
        for t in range(window):
            pos, vel, lvec, st = checkpoint(step, pos, vel, t,
                                            use_reentrant=False)
            lvecs.append(lvec)
            stats.append(st)
        lvec = torch.stack(lvecs).sum(dim=0) / denom
        lvec.sum().backward()
        st = torch.stack(stats)
        return lvec.detach(), pre_eff, (st[:, 0].max(), st[:, 1].max(),
                                        st[:, 2].mean())

    def train_step(batch, time_w):
        n_items = batch["pos"].shape[0]
        if n_items % int(grad_accum):
            raise ValueError(f"grad_accum {grad_accum} must divide the "
                             f"batch {n_items}")
        time_w = torch.as_tensor(np.asarray(time_w, np.float32),
                                 device=batch["pos"].device)
        world = 1 if group is None else group.world_size
        denom = time_w.sum() * (n_items * world)
        for p in params:
            p.grad = None
        lvec, pres, stats = 0.0, [], []
        for b in range(n_items):
            item = {k2: v[b] for k2, v in batch.items()}
            lv, pre_eff, st = item_loss(item, time_w, denom)
            lvec = lvec + lv
            pres.append(pre_eff)
            stats.append(torch.stack(st))
        st = torch.stack(stats)
        stats = {"max_neighbors": st[:, 0].max(),
                 "pair_overflow": st[:, 1].max(),
                 "avg_neighbors": st[:, 2].mean()}
        pres = torch.tensor(pres)
        if group is not None:
            group.psum_grads(params)
            tot = group.psum(torch.cat([lvec, stats["avg_neighbors"][None]]))
            lvec, stats["avg_neighbors"] = tot[:-1], tot[-1] / world
            top = group.pmax(torch.stack([stats["max_neighbors"],
                                          stats["pair_overflow"]]))
            stats["max_neighbors"], stats["pair_overflow"] = top
            pres = group.all_gather(pres).reshape(-1)
        with torch.no_grad():
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                if w_decay > 0:
                    p.grad.add_(p, alpha=2.0 * w_decay)
                if grad_norm > 0:
                    p.grad.copy_(_clip_by_norm(p.grad, grad_norm))
        optimizer.step()
        if scheduler is not None:
            scheduler.step()
        return lvec, pres, stats

    return train_step
