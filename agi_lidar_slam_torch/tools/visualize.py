"""Render SLAM run artifacts to PNG: trajectory, map, per-scan metrics (port
of tools/visualize.py).

The reference systems show their output in rviz. Offline, the equivalent is
a rendering of the same three things an rviz session shows: the estimated
path (against ground truth when given), the accumulated map cloud, and the
run's health curves.

Inputs are what the runner (agi_lidar_slam_torch/tools/run_slam.py) writes:
  --traj     KITTI-format trajectory (12 floats a row) from --traj-out
  --gt       optional ground-truth trajectory, same format
  --map      PCD file or a --save-map directory (corner/surf/global PCDs)
  --metrics  JSONL from --metrics
  --out      output PNG (default slam_viz.png)

Usage:
  python -m agi_lidar_slam_torch.tools.visualize --traj /tmp/traj.txt \\
      --map /tmp/maps --metrics /tmp/run.jsonl --out /tmp/run.png

It draws with matplotlib, which is imported only when a figure is drawn:
where matplotlib is not installed, drawing raises an ImportError that says
so, and the rest of the package does not need it.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ..io.checkpoint import read_pcd

# series colors: fixed assignment (estimate = blue, ground truth = warm red),
# a pair that color-vision deficiency keeps apart; map height uses a single
# perceptually uniform sequential map
C_EST = "#2563eb"
C_GT = "#d97706"
C_MUTED = "#6b7280"
SEQ_CMAP = "viridis"


def require_matplotlib():
    """matplotlib's pyplot on the headless Agg backend; raises an ImportError
    naming matplotlib where it is not installed."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("the PNG renderer (tools/visualize.py, run_slam --viz) needs "
                          "matplotlib, which is not installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def load_kitti_traj(path: str) -> np.ndarray:
    """KITTI odometry format: each row the top 3x4 of T_w_cam; returns (N,3)."""
    M = np.loadtxt(path).reshape(-1, 3, 4)
    return M[:, :, 3]


def load_map_points(path: str, max_pts: int = 300_000) -> np.ndarray:
    """The points of a PCD file, or of a --save-map directory's GlobalMap,
    SurfMap and CornerMap PCDs (any PCDs there if it has none of those),
    subsampled to `max_pts` with a fixed seed."""
    if os.path.isdir(path):
        cands = [os.path.join(path, n) for n in
                 ("GlobalMap.pcd", "SurfMap.pcd", "CornerMap.pcd")]
        pts = [read_pcd(c) for c in cands if os.path.exists(c)]
        if not pts:
            pts = [read_pcd(os.path.join(path, n)) for n in os.listdir(path)
                   if n.endswith(".pcd")]
        xyz = np.concatenate(pts, axis=0)
    else:
        xyz = read_pcd(path)
    if xyz.shape[0] > max_pts:
        sel = np.random.default_rng(0).choice(xyz.shape[0], max_pts, replace=False)
        xyz = xyz[sel]
    return xyz


def load_metrics(path: str) -> list[dict]:
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    return rows


def style_axis(ax):
    ax.grid(True, color="#e5e7eb", linewidth=0.6)
    ax.set_axisbelow(True)
    for s in ("top", "right"):
        ax.spines[s].set_visible(False)
    for s in ("left", "bottom"):
        ax.spines[s].set_color("#9ca3af")


def panel_trajectory(ax, est: np.ndarray, gt: np.ndarray | None):
    ax.plot(est[:, 0], est[:, 1], color=C_EST, linewidth=1.6, label="estimate")
    if gt is not None:
        ax.plot(gt[:, 0], gt[:, 1], color=C_GT, linewidth=1.6,
                linestyle="--", label="ground truth")
    ax.scatter([est[0, 0]], [est[0, 1]], s=40, color=C_EST, marker="o", zorder=5)
    ax.scatter([est[-1, 0]], [est[-1, 1]], s=46, color=C_EST, marker="s", zorder=5)
    ax.annotate("start", est[0, :2], textcoords="offset points",
                xytext=(6, 6), fontsize=8, color=C_MUTED)
    ax.annotate("end", est[-1, :2], textcoords="offset points",
                xytext=(6, 6), fontsize=8, color=C_MUTED)
    ax.set_aspect("equal", adjustable="datalim")
    ax.set_xlabel("x (m)")
    ax.set_ylabel("y (m)")
    title = "Trajectory (top view)"
    if gt is not None:
        n = min(len(est), len(gt))
        ate = float(np.sqrt(np.mean(np.sum((est[:n] - gt[:n]) ** 2, axis=1))))
        title += f" — ATE RMSE {ate:.2f} m"
        ax.legend(frameon=False, fontsize=8, loc="best")
    ax.set_title(title, fontsize=10)
    style_axis(ax)


def panel_map(ax, fig, xyz: np.ndarray, traj: np.ndarray | None):
    z = xyz[:, 2]
    lo, hi = np.percentile(z, [2, 98])
    sc = ax.scatter(xyz[:, 0], xyz[:, 1], c=np.clip(z, lo, hi), s=0.3,
                    cmap=SEQ_CMAP, linewidths=0, rasterized=True)
    if traj is not None:
        ax.plot(traj[:, 0], traj[:, 1], color="#111827", linewidth=1.0)
    ax.set_aspect("equal", adjustable="datalim")
    ax.set_xlabel("x (m)")
    ax.set_ylabel("y (m)")
    ax.set_title(f"Map ({xyz.shape[0]:,} pts, color = height)", fontsize=10)
    cb = fig.colorbar(sc, ax=ax, shrink=0.75, pad=0.02)
    cb.set_label("z (m)", fontsize=8)
    cb.ax.tick_params(labelsize=7)
    style_axis(ax)


def panel_metrics(ax, fig, rows: list[dict]):
    """Two stacked single-axis panels (never a dual-axis chart): scan time
    on top, residual RMS below."""
    def series(key):
        v = [r.get(key) for r in rows]
        return None if all(x is None for x in v) else np.asarray(
            [np.nan if x is None else float(x) for x in v])

    t_ms = series("wall_ms")
    if t_ms is not None and len(t_ms) > 3:
        med = np.nanmedian(t_ms[1:])
        t_ms = np.where(t_ms > 10 * med, np.nan, t_ms)  # drop first-call spikes
    rms = series("rms")

    gs = ax.get_subplotspec().subgridspec(2, 1, hspace=0.35)
    ax.remove()
    top = fig.add_subplot(gs[0])
    bot = fig.add_subplot(gs[1])
    if t_ms is not None:
        top.plot(t_ms, color=C_EST, linewidth=1.2)
    top.set_ylabel("scan time (ms)")
    top.set_title("Per-scan health", fontsize=10)
    if rms is not None:
        bot.plot(rms, color=C_GT, linewidth=1.2)
    bot.set_ylabel("residual RMS (m)")
    bot.set_xlabel("scan index")
    style_axis(top)
    style_axis(bot)


def render(out: str, traj: str | None = None, gt: str | None = None,
           map_path: str | None = None, metrics: str | None = None) -> int:
    """Draw the panels the inputs allow into the PNG `out`; returns 0, or 2
    (drawing nothing) when no input is given, as the reference tool does."""
    est = load_kitti_traj(traj) if traj else None
    gt_xyz = load_kitti_traj(gt) if gt else None
    panels = (["traj"] if est is not None else []) + (["map"] if map_path else []) \
        + (["metrics"] if metrics else [])
    if not panels:
        print("nothing to draw: pass --traj / --map / --metrics")
        return 2
    plt = require_matplotlib()
    fig, axes = plt.subplots(1, len(panels), figsize=(6 * len(panels), 5.4), dpi=130)
    if len(panels) == 1:
        axes = [axes]
    for ax, kind in zip(axes, panels):
        if kind == "traj":
            panel_trajectory(ax, est, gt_xyz)
        elif kind == "map":
            panel_map(ax, fig, load_map_points(map_path), est)
        else:
            panel_metrics(ax, fig, load_metrics(metrics))
    fig.tight_layout()
    fig.savefig(out)
    plt.close(fig)
    print(f"wrote {out}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--traj", help="KITTI-format trajectory txt")
    ap.add_argument("--gt", help="ground-truth trajectory txt")
    ap.add_argument("--map", help="PCD file or save-map directory")
    ap.add_argument("--metrics", help="JSONL metrics path")
    ap.add_argument("--out", default="slam_viz.png")
    args = ap.parse_args(argv)
    return render(args.out, traj=args.traj, gt=args.gt, map_path=args.map,
                  metrics=args.metrics)


if __name__ == "__main__":
    raise SystemExit(main())
