"""2D rollout renderer: hdf5 rollouts -> frame strips / per-frame PNGs
(the port's copy of dmcf_tpu/viz/draw2d.py; the same pixels).

    python -m dmcf_tpu_torch.viz.draw2d <out>/0000.hdf5 strip.png

Reads the pred/gt/bnd particle groups that the test pipeline and
``run_sample`` write (``data.write_results``), autoscales the canvas from
the boundary bounding box and renders selected frames side by side per
point set, with matplotlib's Agg backend.  ``h5py`` and ``matplotlib`` are
imported where a file is read or drawn; the GPU machine has no ``h5py``,
so the renderer runs on a CPU machine.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def _pyplot():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _argb_to_rgba(argb: int):
    a = (argb >> 24) & 0xFF
    r = (argb >> 16) & 0xFF
    g = (argb >> 8) & 0xFF
    b = argb & 0xFF
    return (r / 255, g / 255, b / 255, a / 255)


def load_groups(path):
    """Read all point-set datasets from the first model group in the file."""
    import h5py

    with h5py.File(path, "r") as f:
        model = list(f.keys())[0]
        return {k: np.asarray(f[model][k]) for k in f[model]}


def _bounds(data, margin):
    bnd = data.get("bnd")
    src = bnd if bnd is not None and bnd.size else \
        data.get("gt", data.get("pred"))
    pts = src.reshape(-1, src.shape[-1])
    finite = np.all(np.isfinite(pts), axis=-1) & (np.abs(pts) < 1e6).all(-1)
    pts = pts[finite]
    lo = pts.min(axis=0)
    hi = pts.max(axis=0)
    pad = (hi - lo) * margin
    return lo - pad, hi + pad


def draw_frame(ax, points, radius, color, bnd=None, bnd_radius=None,
               bounds=None):
    """Render one frame of particles (optionally over boundary points)."""
    def scatter(p, r, c):
        if p is None or len(p) == 0:
            return
        keep = np.all(np.isfinite(p), -1) & (np.abs(p) < 1e6).all(-1)
        p = p[keep]
        # marker size in points^2 from data-units radius
        span = (bounds[1] - bounds[0]).max() if bounds is not None else 1.0
        s = max((r / max(span, 1e-9) * 360) ** 2, 0.3)
        ax.scatter(p[:, 0], p[:, 1], s=s, c=[c], linewidths=0)

    if bnd is not None:
        scatter(bnd, bnd_radius or radius, (0.4, 0.4, 0.4, 1.0))
    scatter(points, radius, color)
    if bounds is not None:
        ax.set_xlim(bounds[0][0], bounds[1][0])
        ax.set_ylim(bounds[0][1], bounds[1][1])
    ax.set_aspect("equal")
    ax.axis("off")


def render(path, output=None, out_pattern=None, pointsets=(("gt", "GT"),
                                                          ("pred", "Ours")),
           num_frames=5, frames=None, particle_radius=0.005,
           boundary_radius=None, margin=0.1, height=360,
           particle_color=0xFF0071C5, font_size=36.0):
    plt = _pyplot()
    data = load_groups(path)
    first = data[pointsets[0][0]]
    total = first.shape[0]
    if frames is None:
        frames = np.linspace(0, total - 1, num_frames).astype(int).tolist()
    bounds = _bounds(data, margin)
    color = _argb_to_rgba(particle_color)
    bnd = data.get("bnd")

    if out_pattern:
        for name, label in pointsets:
            for t in frames:
                fig, ax = plt.subplots(figsize=(height / 72, height / 72))
                draw_frame(ax, data[name][t], particle_radius, color,
                           bnd=bnd, bnd_radius=boundary_radius,
                           bounds=bounds)
                out = out_pattern.format(pointset=name, frame=t)
                os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
                fig.savefig(out, dpi=72, bbox_inches="tight")
                plt.close(fig)
        return

    nrows, ncols = len(pointsets), len(frames)
    fig, axes = plt.subplots(nrows, ncols,
                             figsize=(ncols * height / 72,
                                      nrows * height / 72), squeeze=False)
    for r, (name, label) in enumerate(pointsets):
        for c, t in enumerate(frames):
            draw_frame(axes[r][c], data[name][t], particle_radius, color,
                       bnd=bnd, bnd_radius=boundary_radius, bounds=bounds)
            if c == 0:
                axes[r][c].text(0.02, 0.95, label,
                                transform=axes[r][c].transAxes,
                                fontsize=font_size * 0.5, va="top")
    os.makedirs(os.path.dirname(output) or ".", exist_ok=True)
    fig.savefig(output, dpi=72, bbox_inches="tight")
    plt.close(fig)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Renders a simulation sequence from an hdf5 file.")
    parser.add_argument("path", type=str)
    parser.add_argument("output", type=str)
    parser.add_argument("--out_pattern", type=str)
    parser.add_argument("--height", type=int, default=360)
    parser.add_argument("--width", type=int)
    parser.add_argument("--pr", dest="particle_radius", type=float,
                        default=0.005)
    parser.add_argument("--br", dest="boundary_radius", type=float)
    parser.add_argument("--margin", type=float, default=0.1)
    parser.add_argument("--pointsets", type=str, nargs="+",
                        default=["gt,GT", "pred,Ours"])
    parser.add_argument("--font_size", type=float, default=36.0)
    parser.add_argument("--num_frames", type=int, default=5)
    parser.add_argument("--frames", type=int, nargs="+")
    parser.add_argument("--pc", type=str, default="0xff0071c5")
    args = parser.parse_args(argv)

    pointsets = [tuple(p.split(",")) for p in args.pointsets]
    render(args.path, args.output, out_pattern=args.out_pattern,
           pointsets=pointsets, num_frames=args.num_frames,
           frames=args.frames, particle_radius=args.particle_radius,
           boundary_radius=args.boundary_radius, margin=args.margin,
           height=args.height, particle_color=int(args.pc, 16),
           font_size=args.font_size)
    return 0


if __name__ == "__main__":
    sys.exit(main())
