"""IMU-interpolated sweep deskew and IMU-rate pose fusion
(port of agi_lidar_slam_tpu/imu/deskew.py).

* `gyro_rotation_track` integrates the gyro window into orientations relative
  to the sweep start, sample by sample as the reference's `lax.scan` does;
* `deskew_imu_rotation` maps every point into the sweep-start frame by a
  slerp on that track plus a constant-velocity translation (LIO-Livox
  IMU_Mode 1, RemoveLidarDistortion);
* `fuse_imu_rate` composes a scan-rate pose with IMU-rate increments
  (LeGO-LOAM TransformFusion).
"""

from __future__ import annotations

import torch

from ..geometry import so3
from ..pointcloud.cloud import ScanGrid


def _track(q0: torch.Tensor, dtheta: torch.Tensor) -> torch.Tensor:
    """Orientations after each step: q_k = normalize(q_{k-1} Exp(dtheta_k)),
    (M,4). The per-step exponentials are taken at once."""
    steps = so3.quat_exp(dtheta)
    q, out = q0, []
    for k in range(dtheta.shape[0]):
        q = so3.quat_normalize(so3.quat_mul(q, steps[k]))
        out.append(q)
    return torch.stack(out)


def gyro_rotation_track(gyro: torch.Tensor, dts: torch.Tensor,
                        mask: torch.Tensor) -> torch.Tensor:
    """gyro (M,3) rad/s, dts (M,) s, mask (M,) -> qs (M+1,4): qs[0] identity,
    qs[i] the rotation from the sweep start to sample i. Masked samples
    integrate as no rotation."""
    dtheta = torch.where(mask[:, None], gyro * dts[:, None], torch.zeros_like(gyro))
    q0 = so3.quat_identity(dtype=gyro.dtype, device=gyro.device)
    return torch.cat([q0[None], _track(q0, dtheta)], dim=0)


def deskew_imu_rotation(scan: ScanGrid, gyro: torch.Tensor, dts: torch.Tensor,
                        imu_mask: torch.Tensor, rel_t: torch.Tensor) -> ScanGrid:
    """Map every point into the sweep-START frame: p' = q(tau) p + tau rel_t.

    `scan.time` is the in-sweep fraction in [0, 1); the IMU window covers the
    sweep (sample i sits at the cumulative time sum(dts[:i+1]))."""
    qs = gyro_rotation_track(gyro, dts, imu_mask)
    cum = torch.cumsum(torch.where(imu_mask, dts, torch.zeros_like(dts)), dim=0)
    total = torch.clamp(cum[-1], min=1e-9)
    ts = torch.cat([torch.zeros_like(cum[:1]), cum]) / total  # (M+1,) in [0, 1]

    tau = scan.time.reshape(-1)
    idx = torch.clamp(torch.searchsorted(ts, tau, right=True), 1, ts.shape[0] - 1)
    t0, t1 = ts[idx - 1], ts[idx]
    s = torch.clamp((tau - t0) / torch.clamp(t1 - t0, min=1e-9), 0.0, 1.0)
    q_tau = so3.slerp(qs[idx - 1], qs[idx], s)
    xyz = so3.quat_rotate(q_tau, scan.xyz.reshape(-1, 3)) + tau[:, None] * rel_t
    return ScanGrid(xyz.reshape(scan.xyz.shape).to(scan.xyz.dtype), scan.mask, scan.time)


def fuse_imu_rate(pose_q: torch.Tensor, pose_t: torch.Tensor, v_world: torch.Tensor,
                  gyro: torch.Tensor, dt: torch.Tensor, mask: torch.Tensor):
    """One world pose per IMU sample: the sweep-start pose (q wxyz, t)
    composed with the integrated gyro rotation, translated at the scan-rate
    velocity v_world. Returns (qs (M,4), ps (M,3), valid (M,))."""
    dts = torch.where(mask, dt, torch.zeros_like(dt))
    qs = _track(pose_q, gyro * dts[:, None])
    ps = pose_t[None, :] + torch.cumsum(dts, dim=0)[:, None] * v_world[None, :]
    return qs, ps, mask
