"""Mount-angle self-calibration, LIO-Livox segment/pointsCorrect.cpp
(port of agi_lidar_slam_tpu/features/mount_calib.py).

* flat-ground cells of a 2x2 m grid over a 40x20 m box (more than 3 points,
  max-mean height spread < 0.4 m, mean height < 2 m);
* the ground normal as the smallest eigenvector of the retained points'
  covariance;
* an exponentially averaged normal with the reference's consistency gate and
  a hard reset after 10 misses;
* the correction rotates the ground normal to +z and removes the height.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import default_device
from ..fit.geometry_fit import eigvals3x3, eigvec3x3
from ..pointcloud.voxel import div_exact

# grid geometry (pointsCorrect.cpp:53-60)
_DX = 2.0
_X_LEN, _Y_LEN = 20.0, 10.0
_NX = int(2 * _X_LEN / _DX)  # 20
_NY = int(2 * _Y_LEN / _DX)  # 10
_FLAT_THR = 0.4  # max-mean height spread
_MIN_CELL_PTS = 4  # "imgNumZ > 3"
_MAX_MEAN_Z = 2.0


class GroundEstimate(NamedTuple):
    normal: torch.Tensor  # (3,) unit, oriented toward +z
    height: torch.Tensor  # () mean ground height along the normal
    n_points: torch.Tensor  # () int32 retained ground points
    ok: torch.Tensor  # () bool: enough support for a trustworthy normal


class MountState(NamedTuple):
    """EMA'd ground estimate across frames (GetGndPos)."""

    normal: torch.Tensor  # (3,)
    height: torch.Tensor  # ()
    initialized: torch.Tensor  # () bool
    misses: torch.Tensor  # () int32 consecutive rejected frames


def init_mount_state(device=None) -> MountState:
    """Level mount, not initialized, on `device` (default: cuda)."""
    device = default_device(device)
    normal = torch.zeros((3,), device=device)
    normal[2].fill_(1.0)  # a fill, not a host-to-device copy
    return MountState(normal, torch.zeros((), device=device),
                      torch.zeros((), dtype=torch.bool, device=device),
                      torch.zeros((), dtype=torch.int32, device=device))


def estimate_ground(xyz: torch.Tensor, mask: torch.Tensor) -> GroundEstimate:
    """One-frame ground-plane estimate from flat grid cells. xyz (N,3)."""
    dev = xyz.device
    inb = mask & (torch.abs(xyz[:, 0]) < _X_LEN) & (torch.abs(xyz[:, 1]) < _Y_LEN)
    ix = torch.clamp(div_exact(xyz[:, 0] + _X_LEN, _DX).to(torch.int32), 0, _NX - 1)
    iy = torch.clamp(div_exact(xyz[:, 1] + _Y_LEN, _DX).to(torch.int32), 0, _NY - 1)
    C = _NX * _NY
    cell = torch.where(inb, ix + iy * _NX, torch.full_like(ix, C)).long()  # C: overflow bin

    z = xyz[:, 2]
    n_c = torch.zeros((C + 1,), device=dev).index_add_(0, cell, inb.to(z.dtype))[:C]
    zsum = torch.zeros((C + 1,), device=dev).index_add_(
        0, cell, torch.where(inb, z, torch.zeros_like(z)))[:C]
    zmax = torch.full((C + 1,), -float("inf"), device=dev).scatter_reduce_(
        0, cell, torch.where(inb, z, torch.full_like(z, -float("inf"))), "amax")[:C]
    zmean = zsum / torch.clamp(n_c, min=1.0)
    flat = (n_c >= _MIN_CELL_PTS) & ((zmax - zmean) < _FLAT_THR) & (zmean < _MAX_MEAN_Z)

    keep = inb & flat[torch.clamp(cell, max=C - 1)]
    w = keep.to(z.dtype)[:, None]
    n_pts = torch.sum(keep, dtype=torch.int32)
    denom = torch.clamp(torch.sum(w), min=1.0)
    centroid = torch.sum(xyz * w, dim=0) / denom
    d = (xyz - centroid) * w
    cov = d.T @ d / denom
    vals = eigvals3x3(cov)
    normal = eigvec3x3(cov, vals[2])
    normal = torch.where(normal[2] < 0, -normal, normal)  # toward +z
    height = torch.dot(normal, centroid)
    # support gates: enough points, plane-like (smallest eigenvalue well
    # separated), and a plausible tilt (< 30 deg)
    ok = (n_pts > 50) & (vals[1] > 10.0 * torch.clamp(vals[2], min=1e-9)) & (normal[2] > 0.866)
    return GroundEstimate(normal, height, n_pts, ok)


def update_mount(state: MountState, xyz: torch.Tensor,
                 mask: torch.Tensor) -> tuple[MountState, GroundEstimate]:
    """Per-frame EMA update with the reference's consistency gate."""
    est = estimate_ground(xyz, mask)
    close = ((torch.abs(state.normal[0] - est.normal[0]) < 0.1)
             & (torch.abs(state.normal[1] - est.normal[1]) < 0.1))
    accept_first = est.ok & ~state.initialized
    accept_ema = est.ok & state.initialized & close
    hard_reset = est.ok & (state.misses >= 10)  # frame_lenth_threshold analog
    take = accept_first | hard_reset

    mean_n = 0.5 * (state.normal + est.normal)
    mean_n = mean_n / torch.clamp(torch.linalg.vector_norm(mean_n), min=1e-9)
    new_n = torch.where(take, est.normal, torch.where(accept_ema, mean_n, state.normal))
    new_h = torch.where(take, est.height,
                        torch.where(accept_ema, 0.5 * (state.height + est.height), state.height))
    new_miss = torch.where(take | accept_ema, torch.zeros_like(state.misses), state.misses + 1)
    return MountState(new_n, new_h, state.initialized | accept_first, new_miss), est


def mount_rotation(normal: torch.Tensor) -> torch.Tensor:
    """Rotation matrix taking `normal` to +z (GetRTMatrix_cor), Rodrigues'
    closed form."""
    zero = torch.zeros_like(normal[0])
    v = torch.stack([normal[1], -normal[0], zero])  # normal x z
    s = torch.linalg.vector_norm(v)
    c = normal[2]
    K = torch.stack([torch.stack([zero, -v[2], v[1]]),
                     torch.stack([v[2], zero, -v[0]]),
                     torch.stack([-v[1], v[0], zero])])
    # R = I + K + K^2 (1-c)/s^2; series-safe when s -> 0 (already aligned)
    k2 = torch.where(s > 1e-6, (1.0 - c) / torch.clamp(s * s, min=1e-12),
                     torch.full_like(s, 0.5))
    return torch.eye(3, dtype=normal.dtype, device=normal.device) + K + k2 * (K @ K)


def correct_points(xyz: torch.Tensor, state: MountState) -> torch.Tensor:
    """Rotate the ground normal to +z and zero the ground height
    (CorrectPoints_cor). Identity until initialized."""
    out = xyz @ mount_rotation(state.normal).T
    out = torch.cat([out[:, :2], out[:, 2:] - state.height], dim=1)
    return torch.where(state.initialized, out, xyz)
