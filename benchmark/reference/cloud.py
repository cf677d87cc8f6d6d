# Frozen copy of agi_lidar_slam_torch/pointcloud/cloud.py at commit 88e7c49, for the
# benchmark's plain reference: it imports nothing of the program, and
# later changes to the program do not reach it.
"""Fixed-shape point-cloud containers (port of agi_lidar_slam_tpu/pointcloud/cloud.py).

A scan is a (rings, width) grid of points with a validity mask; a flat point
set is a padded (N, 3) batch with a mask.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .device import default_device, host_to_device


class ScanGrid(NamedTuple):
    """A single lidar sweep as a ring-major grid.

    xyz:  (R, W, 3) float32, sensor-frame coordinates.
    mask: (R, W)    bool, True where a return exists.
    time: (R, W)    float32, relative time in [0,1) within the sweep.
    """

    xyz: torch.Tensor
    mask: torch.Tensor
    time: torch.Tensor

    @property
    def rings(self) -> int:
        return self.xyz.shape[0]

    @property
    def width(self) -> int:
        return self.xyz.shape[1]


class PointBatch(NamedTuple):
    """A flat, padded set of points. xyz (N,3) f32; mask (N) bool."""

    xyz: torch.Tensor
    mask: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]


def grid_from_unorganized(
    xyz: np.ndarray,
    rings: int,
    width: int,
    fov_up_deg: float,
    fov_down_deg: float,
    min_range: float = 0.5,
    device=None,
) -> ScanGrid:
    """Host-side: bin an unorganized cloud (e.g. KITTI .bin) into a ring-major
    grid by elevation/azimuth, returned as tensors on `device` (default: cuda;
    copied there without a host sync, `host_to_device`)."""
    device = default_device(device)
    xyz = np.asarray(xyz, dtype=np.float32)
    r = np.linalg.norm(xyz, axis=-1)
    keep = r > min_range  # blind-zone removal
    xyz = xyz[keep]
    r = r[keep]
    elev = np.degrees(np.arcsin(np.clip(xyz[:, 2] / np.maximum(r, 1e-6), -1, 1)))
    azim = np.arctan2(xyz[:, 1], xyz[:, 0])  # (-pi, pi]
    ring = np.round((elev - fov_down_deg) / (fov_up_deg - fov_down_deg) * (rings - 1))
    col = np.round((azim + np.pi) / (2 * np.pi) * (width - 1))
    ok = (ring >= 0) & (ring < rings) & (col >= 0) & (col < width)
    ring = ring[ok].astype(np.int32)
    col = col[ok].astype(np.int32)
    xyz = xyz[ok]
    grid = np.zeros((rings, width, 3), dtype=np.float32)
    mask = np.zeros((rings, width), dtype=bool)
    grid[ring, col] = xyz
    mask[ring, col] = True
    time = np.broadcast_to(
        (np.arange(width, dtype=np.float32) / width)[None, :], (rings, width)
    ).copy()
    return ScanGrid(host_to_device(grid, device), host_to_device(mask, device),
                    host_to_device(time, device))


def flatten_grid(scan: ScanGrid) -> PointBatch:
    return PointBatch(scan.xyz.reshape(-1, 3), scan.mask.reshape(-1))
