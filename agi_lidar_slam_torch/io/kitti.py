"""KITTI odometry dataset loader (port of agi_lidar_slam_tpu/io/kitti.py).

Replaces A-LOAM's kittiHelper node (kittiHelper.cpp:40-205: reads
`velodyne/xxxx.bin` float32 x,y,z,intensity rows + times.txt + ground-truth
poses and republishes at 10 Hz). Here it is a host-side generator feeding
ScanGrids straight into the engine — no ROS, no republishing.

KITTI ground-truth poses are in the left-camera frame; `load_poses` converts
them into the velodyne frame via the calib Tr matrix so estimates compare
directly (lidar FLU end-to-end; converted only here, at dataset I/O).
"""

from __future__ import annotations

import os
from typing import Iterator, Optional

import numpy as np

from ..pointcloud.cloud import ScanGrid, grid_from_unorganized

# HDL-64E geometry (A-LOAM scanRegistration.cpp:191-204 beam formulas)
HDL64_RINGS = 64
HDL64_FOV_UP = 2.0
HDL64_FOV_DOWN = -24.8


def read_velodyne_bin(path: str) -> np.ndarray:
    """One KITTI scan: (N,4) float32 [x,y,z,intensity] (kittiHelper.cpp:25-38)."""
    data = np.fromfile(path, dtype=np.float32)
    return data.reshape(-1, 4)


def load_calib_tr(calib_path: str) -> np.ndarray:
    """4x4 Tr (velodyne -> cam0) from a KITTI calib.txt."""
    with open(calib_path) as f:
        for line in f:
            if line.startswith("Tr"):
                vals = np.array(line.split(":", 1)[1].split(), dtype=np.float64)
                Tr = np.eye(4)
                Tr[:3, :4] = vals.reshape(3, 4)
                return Tr
    raise ValueError(f"no Tr entry in {calib_path}")


def load_poses(pose_path: str, calib_path: Optional[str] = None) -> np.ndarray:
    """Ground-truth poses (N,4,4), converted to the velodyne frame when calib
    is given: T_velo(k) = Tr^-1 @ T_cam(k) @ Tr."""
    rows = np.loadtxt(pose_path).reshape(-1, 3, 4)
    n = rows.shape[0]
    T = np.tile(np.eye(4), (n, 1, 1))
    T[:, :3, :4] = rows
    if calib_path is not None and os.path.exists(calib_path):
        Tr = load_calib_tr(calib_path)
        Tr_inv = np.linalg.inv(Tr)
        T = Tr_inv[None] @ T @ Tr[None]
    return T


def scan_paths(sequence_dir: str) -> list[str]:
    vdir = os.path.join(sequence_dir, "velodyne")
    return [os.path.join(vdir, f) for f in sorted(os.listdir(vdir)) if f.endswith(".bin")]


def iter_scans(
    sequence_dir: str,
    width: int = 1800,
    rings: int = HDL64_RINGS,
    max_scans: Optional[int] = None,
    device=None,
) -> Iterator[ScanGrid]:
    """Stream a KITTI sequence as ScanGrids (ring-major grids) on `device`
    (default: cuda)."""
    paths = scan_paths(sequence_dir)
    if max_scans is not None:
        paths = paths[:max_scans]
    for p in paths:
        pts = read_velodyne_bin(p)
        yield grid_from_unorganized(
            pts[:, :3], rings=rings, width=width,
            fov_up_deg=HDL64_FOV_UP, fov_down_deg=HDL64_FOV_DOWN, device=device,
        )
