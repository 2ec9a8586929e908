"""Windowed training samples, evaluation sequences and fixed-shape padding
(the port's copy of dmcf_tpu/data/dataflow.py: ``random_rotation_matrix``,
``WindowSampler`` with its random augmentations (rotate, jitter,
jitter_inp) and global transform, ``get_normalization_stats``,
``get_rollout``, ``pad_particles``,
``sentinel_rows``, ``batch_samples``, ``pad_rollout_state``, the thread
``Prefetcher`` and ``get_dataloader``).

A seeded sampler draws from ``np.random.RandomState`` in the JAX package's
order, so it gives the same samples.

Batch layout (numpy; the pipeline moves it to the device):
  pos, vel[, grav]:  [B, T, N, 3]   T = max_pre + window + 1 frames
  box, box_normals:  [B, Nb, 3]     static geometry from frame 0
  fluid_mask:        [B, N] bool    box_mask: [B, Nb] bool
  pre:               [B] int32      per-sample warm-up frames drawn
Samples shorter than T repeat their last frame; those frames are never
read.
"""

from __future__ import annotations

import queue
import threading

import numpy as np

from ..ops.sph import PAD_POS


def random_rotation_matrix(rng, rot_axis=None, dtype=np.float32):
    """Axis-aligned random rotation by an angle drawn from ``rng``."""
    theta = rng.rand(3)[0] * 2 * np.pi
    st, ct = np.sin(theta), np.cos(theta)
    if rot_axis == 0:
        return np.array([[1, 0, 0], [0, ct, st], [0, -st, ct]], dtype)
    if rot_axis == 1:
        return np.array([[ct, 0, st], [0, 1, 0], [-st, 0, ct]], dtype)
    return np.array([[ct, st, 0], [-st, ct, 0], [0, 0, 1]], dtype)


def align_vector_np(v0, v1):
    """Rotation matrix aligning v0 to v1 (numpy, as ``ops.sph.
    align_vector``); parallel vectors give +/-I."""
    v0n = v0 / (np.linalg.norm(v0) + 1e-9)
    v1n = v1 / (np.linalg.norm(v1) + 1e-9)
    v = np.cross(v0n, v1n)
    c = float(np.dot(v0n, v1n))
    s = float(np.linalg.norm(v))
    if s < 1e-6:
        return (np.eye(3) * (-1.0 if c < 0 else 1.0)).astype(np.float32)
    vx = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    return (np.eye(3) + vx + vx @ vx / (1 + c)).astype(np.float32)


def augment(s, translate=None, scale=None, grav_eqvar=None):
    """The global translate/scale/gravity alignment of a sequence dict
    (``pos``/``vel``/``grav`` [T, N, 3], ``box`` [B, 3]), as
    ``WindowSampler._augment`` applies them after its random
    augmentations.  ``grav_eqvar`` turns the sequence so that its gravity
    (frame 0, particle 0) points along the given vector and keeps the
    original as ``orig_grav``."""
    if translate is not None:
        s["pos"] = s["pos"] + translate
        s["box"] = s["box"] + translate
    if scale is not None:
        s["pos"] = s["pos"] * scale
        s["box"] = s["box"] * scale
        s["vel"] = s["vel"] * scale
        if s.get("grav") is not None:
            s["grav"] = s["grav"] * scale
    if grav_eqvar is not None:
        R = align_vector_np(np.asarray(grav_eqvar, np.float32),
                            s["grav"][0, 0])
        s["orig_grav"] = s["grav"][0, 0]
        for k in ("box", "box_normals", "pos", "vel", "grav"):
            s[k] = np.matmul(s[k], R)
    return s


class WindowSampler:
    """Yields per-sample dicts of stacked frame windows with augmentation:
    a sample is ``pre + window + 1`` consecutive frames from a random
    start, ``pre`` drawn uniformly from [0, pre_frames]; the static box
    geometry comes from frame 0.  The 'rotate' augmentation rotates
    gravity into ``grav`` (the JAX package's fix of the reference)."""

    def __init__(self, dataset, window=1, pre_frames=0, stride=1,
                 shuffle=False, sample_cnt=None, augment=None,
                 translate=None, scale=None, grav_eqvar=None, seed=None,
                 **kwargs):
        self.dataset = dataset
        self.window = window + 1
        self.pre_frames = pre_frames
        self.stride = stride
        self.shuffle = shuffle
        self.sample_cnt = sample_cnt
        self.augment = dict(augment or {})
        self.translate = translate
        self.scale = scale
        self.grav_eqvar = grav_eqvar
        self.rng = np.random.RandomState(seed)

    def _augment(self, s):
        for mode, config in self.augment.items():
            config = dict(config or {})
            if mode == "rotate":
                R = random_rotation_matrix(self.rng, **config)
                for k in ("box", "box_normals", "pos", "vel"):
                    s[k] = np.matmul(s[k], R)
                if s.get("grav") is not None:
                    s["grav"] = np.matmul(s["grav"], R)
            elif mode == "jitter":
                for k, v in config.get("channels", {}).items():
                    s[k] = s[k] + self.rng.normal(scale=v, size=s[k].shape)
            elif mode == "jitter_inp":
                for k, v in config.get("channels", {}).items():
                    s[k][0] = s[k][0] + self.rng.normal(scale=v,
                                                        size=s[k][0].shape)
            else:
                raise NotImplementedError(f"augment mode: {mode}")
        return augment(s, translate=self.translate, scale=self.scale,
                       grav_eqvar=self.grav_eqvar)

    def __iter__(self):
        file_idxs = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(file_idxs)
        for fi in file_idxs:
            scene = self.dataset[fi]
            span = (self.window - 1 + self.pre_frames) * self.stride
            starts = np.arange(len(scene) - span)
            if len(starts) == 0:
                raise ValueError("scene shorter than the sample window")
            if self.shuffle:
                self.rng.shuffle(starts)
            if self.sample_cnt is not None:
                starts = starts[:self.sample_cnt]
            for start in starts:
                pre = int(self.rng.randint(self.pre_frames + 1))
                frames = [scene[start + i * self.stride]
                          for i in range(pre + self.window)]
                s = {"pre": pre}
                for k in ("pos", "vel"):
                    s[k] = np.stack([np.asarray(f[k], np.float32)
                                     for f in frames], 0)
                s["grav"] = None
                if frames[0].get("grav") is not None:
                    g = np.stack([np.asarray(f["grav"], np.float32)
                                  for f in frames], 0)
                    if g.ndim == 2:  # [T, 3] scene gravity -> per particle
                        g = np.broadcast_to(g[:, None, :],
                                            s["vel"].shape).copy()
                    s["grav"] = g
                s["box"] = np.asarray(scene[0].get(
                    "box", np.empty((0, 3))), np.float32).reshape(-1, 3)
                s["box_normals"] = np.asarray(scene[0].get(
                    "box_normals", np.empty((0, 3))),
                    np.float32).reshape(-1, 3)
                s["frame_id"] = np.array([f["frame_id"] for f in frames])
                s["scene_id"] = frames[0].get("scene_id", str(fi))
                yield self._augment(s)


def get_normalization_stats(dataset, dt):
    """GNS-style velocity/acceleration statistics over a dataset (the
    learning_to_simulate metadata format; no pipeline calls it)."""
    vel_means, vel_vars = [], []
    acc_means, acc_vars = [], []
    cnts = []
    frame_cnt = 0
    for si in range(len(dataset)):
        scene = dataset[si]
        frame_cnt = max(frame_cnt, max(f["frame_id"] for f in scene))
        p = np.stack([np.asarray(f["pos"]) for f in scene], axis=0)
        v = p[1:] - p[:-1]
        a = v[1:] - v[:-1]
        v = v[:-1].reshape(-1, 3)
        a = a.reshape(-1, 3)
        cnts.append(v.shape[0])
        vel_means.append(v.mean(0))
        vel_vars.append(v.var(0))
        acc_means.append(a.mean(0))
        acc_vars.append(a.var(0))
    cnts = np.asarray(cnts)[:, None]
    vel_means = np.stack(vel_means)
    acc_means = np.stack(acc_means)
    vel_mean = np.sum(vel_means * cnts, 0) / cnts.sum()
    acc_mean = np.sum(acc_means * cnts, 0) / cnts.sum()
    vel_var = np.sum((np.stack(vel_vars) +
                      (vel_means - vel_mean) ** 2) * cnts, 0) / cnts.sum()
    acc_var = np.sum((np.stack(acc_vars) +
                      (acc_means - acc_mean) ** 2) * cnts, 0) / cnts.sum()
    return {
        "acc_mean": acc_mean, "acc_std": np.sqrt(acc_var),
        "vel_mean": vel_mean, "vel_std": np.sqrt(vel_var),
        "dim": 3, "dt": dt,
        "default_connectivity_radius": 0.015,
        "bounds": [[-1.0, 1.0], [-1.0, 1.0]],
        "sequence_length": int(frame_cnt),
    }


def get_rollout(dataset, stride=1, time_start=0, time_end=None,
                random_start=1, cnt=None, translate=None, scale=None,
                grav_eqvar=None, seed=None, **kwargs):
    """Full evaluation sequences: per scene, frames [time_start(+rand),
    time_end) at ``stride``, merged into arrays of shape [T, N, 3].  The
    random start offset comes from ``np.random.RandomState(seed)``, drawn
    per scene in order, as in the JAX package."""
    rng = np.random.RandomState(seed)
    out = []
    for si in range(len(dataset)):
        if cnt is not None and len(out) >= cnt:
            break
        scene = dataset[si]
        off = rng.randint(random_start * stride) if random_start > 1 else 0
        sel = [f for f in scene
               if f["frame_id"] >= time_start * stride + off
               and f["frame_id"] % stride == 0
               and (time_end is None
                    or f["frame_id"] < time_end * stride + off)]
        if not sel:
            continue
        merged = {}
        for k in ("pos", "vel"):
            merged[k] = np.stack([np.asarray(f[k], np.float32)
                                  for f in sel], 0)
        g = sel[0].get("grav")
        if g is not None:
            g = np.stack([np.asarray(f["grav"], np.float32) for f in sel], 0)
            if g.ndim == 2:
                g = np.broadcast_to(g[:, None, :],
                                    merged["vel"].shape).copy()
        merged["grav"] = g
        merged["box"] = np.asarray(scene[0].get("box", np.empty((0, 3))),
                                   np.float32).reshape(-1, 3)
        merged["box_normals"] = np.asarray(
            scene[0].get("box_normals", np.empty((0, 3))),
            np.float32).reshape(-1, 3)
        merged["frame_id"] = np.array([f["frame_id"] for f in sel])
        out.append(augment(merged, translate=translate, scale=scale,
                           grav_eqvar=grav_eqvar))
    return out


def _round_up(n, m):
    return int(-(-n // m) * m)


def pad_particles(arr, n_max, fill=0.0):
    """[..., N, 3] -> [..., n_max, 3]."""
    pad = n_max - arr.shape[-2]
    if pad <= 0:
        return arr
    widths = [(0, 0)] * (arr.ndim - 2) + [(0, pad), (0, 0)]
    return np.pad(arr, widths, constant_values=fill)


def sentinel_rows(n, offset=0):
    out = np.zeros((n, 3), np.float32)
    out[:, 0] = PAD_POS + (np.arange(n) + offset) * 1e3
    return out


def pad_rollout_state(data, bucket=64):
    """Rollout sequence dict (``pos``/``vel``/``grav`` [T, N, 3], ``box`` /
    ``box_normals`` [B, 3]) -> fixed-shape padded numpy state."""
    n = data["pos"].shape[1]
    nb = max(data["box"].shape[0], 1)
    n_max = _round_up(n, bucket)
    b_max = _round_up(nb, bucket)
    pos = pad_particles(data["pos"].astype(np.float32), n_max)
    pos[:, n:, :] = sentinel_rows(n_max - n)[None]
    vel = pad_particles(data["vel"].astype(np.float32), n_max)
    box = pad_particles(data["box"].astype(np.float32), b_max)
    box[data["box"].shape[0]:, :] = sentinel_rows(
        b_max - data["box"].shape[0], offset=n_max)
    nrm = pad_particles(data["box_normals"].astype(np.float32), b_max)
    grav = None
    if data.get("grav") is not None:
        grav = pad_particles(data["grav"].astype(np.float32), n_max)
    return {
        "pos": pos, "vel": vel, "grav": grav, "box": box,
        "box_normals": nrm,
        "fluid_mask": np.arange(n_max) < n,
        "box_mask": np.arange(b_max) < data["box"].shape[0],
        "n_fluid": n,
    }


def batch_samples(samples, bucket=64, t_total=None):
    """Pad a list of window samples to a common fixed-shape batch dict."""
    n_max = _round_up(max(s["pos"].shape[1] for s in samples), bucket)
    b_max = _round_up(max(max(s["box"].shape[0] for s in samples), 1),
                      bucket)
    if t_total is None:
        t_total = max(s["pos"].shape[0] for s in samples)

    def tpad(x):  # time-pad by repeating the final frame (never read)
        if x.shape[0] < t_total:
            x = np.concatenate(
                [x, np.repeat(x[-1:], t_total - x.shape[0], axis=0)], 0)
        return x

    batch = {k: [] for k in ("pos", "vel", "grav", "box", "box_normals",
                             "fluid_mask", "box_mask", "pre")}
    has_grav = samples[0].get("grav") is not None
    for s in samples:
        n = s["pos"].shape[1]
        nb = s["box"].shape[0]
        pos = pad_particles(tpad(s["pos"]).astype(np.float32), n_max)
        # padded particles at spread sentinels (outside any neighborhood)
        pos[:, n:, :] = sentinel_rows(n_max - n)[None]
        vel = pad_particles(tpad(s["vel"]).astype(np.float32), n_max)
        box = pad_particles(s["box"].astype(np.float32), b_max)
        box[nb:, :] = sentinel_rows(b_max - nb, offset=n_max)
        batch["pos"].append(pos)
        batch["vel"].append(vel)
        if has_grav:
            batch["grav"].append(pad_particles(
                tpad(s["grav"]).astype(np.float32), n_max))
        batch["box"].append(box)
        batch["box_normals"].append(pad_particles(
            s["box_normals"].astype(np.float32), b_max))
        batch["fluid_mask"].append(np.arange(n_max) < n)
        batch["box_mask"].append(np.arange(b_max) < nb)
        batch["pre"].append(s.get("pre", 0))

    out = {k: np.stack(v) for k, v in batch.items() if v}
    if not has_grav:
        out["grav"] = None
    out["pre"] = np.asarray(out["pre"], np.int32)
    return out


class Prefetcher:
    """Background sample prefetch and batch assembly: ``num_workers``
    threads each run an independent sampler stream (their own seeds) into
    a shared sample queue, through a per-worker shuffle buffer; a batcher
    thread pads fixed-shape batches.  ``close`` stops the threads."""

    def __init__(self, sampler_fn, batch_size, bucket=64, t_total=None,
                 repeat=True, shuffle_buffer=None, num_workers=1, depth=4):
        self.sampler_fn = sampler_fn
        self.batch_size = batch_size
        self.bucket = bucket
        self.t_total = t_total
        self.repeat = repeat
        self.num_workers = max(int(num_workers or 1), 1)
        self.shuffle_buffer = (
            max(shuffle_buffer // self.num_workers, 1)
            if shuffle_buffer else shuffle_buffer)
        self.q = queue.Queue(maxsize=depth)
        self._sample_q = queue.Queue(
            maxsize=max(depth * batch_size, 2 * batch_size))
        self._stop = threading.Event()
        self.threads = [
            threading.Thread(target=self._sample_worker, args=(w,),
                             daemon=True)
            for w in range(self.num_workers)]
        self.threads.append(threading.Thread(target=self._batcher,
                                             daemon=True))
        for t in self.threads:
            t.start()

    def _sample_stream(self, worker_idx):
        rng = np.random.RandomState((worker_idx * 7919 + 13) & 0x7FFFFFFF)
        while True:
            it = iter(self.sampler_fn(worker_idx))
            if self.shuffle_buffer:
                buf = []
                for s in it:
                    if self._stop.is_set():
                        return
                    buf.append(s)
                    if len(buf) >= self.shuffle_buffer:
                        yield buf.pop(rng.randint(len(buf)))
                while buf:
                    yield buf.pop()
            else:
                for s in it:
                    if self._stop.is_set():
                        return
                    yield s
            if not self.repeat:
                return

    def _put(self, q, item):
        """``q.put`` that gives up once the loader is closed."""
        while not self._stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _sample_worker(self, worker_idx):
        try:
            for s in self._sample_stream(worker_idx):
                if not self._put(self._sample_q, s):
                    return
        finally:
            self._put(self._sample_q, None)  # this worker's end marker

    def _batcher(self):
        done_workers = 0
        batch = []
        try:
            while done_workers < self.num_workers:
                try:
                    s = self._sample_q.get(timeout=0.1)
                except queue.Empty:
                    if self._stop.is_set():
                        return
                    continue
                if s is None:
                    done_workers += 1
                    continue
                batch.append(s)
                if len(batch) == self.batch_size:
                    if not self._put(self.q, batch_samples(
                            batch, self.bucket, self.t_total)):
                        return
                    batch = []
            if batch:
                self._put(self.q, batch_samples(batch, self.bucket,
                                                self.t_total))
        finally:
            self._put(self.q, None)

    def __iter__(self):
        return self

    def __next__(self):
        item = self.q.get()
        if item is None:
            raise StopIteration
        return item

    def close(self, timeout=5.0):
        self._stop.set()
        for t in self.threads:
            t.join(timeout)


def get_dataloader(dataset, batch_size=1, window=1, repeat=False,
                   shuffle_buffer=None, num_workers=1, pre_frames=0,
                   stride=1, translate=None, scale=None, grav_eqvar=None,
                   augment=None, bucket=64, seed=None, sample_cnt=None,
                   **kwargs):
    """The training loader: ``Prefetcher`` over ``WindowSampler`` streams
    (worker w seeded ``seed + w``; unseeded when ``seed`` is None)."""
    t_total = pre_frames + window + 1

    def make_sampler(worker_idx=0):
        wseed = None if seed is None else int(seed) + worker_idx
        return WindowSampler(dataset, window=window, pre_frames=pre_frames,
                             stride=stride, shuffle=bool(shuffle_buffer),
                             augment=augment, translate=translate,
                             scale=scale, grav_eqvar=grav_eqvar, seed=wseed,
                             sample_cnt=sample_cnt)

    return Prefetcher(make_sampler, batch_size, bucket=bucket,
                      t_total=t_total, repeat=repeat,
                      shuffle_buffer=shuffle_buffer,
                      num_workers=num_workers)
