"""Analytic circle trajectory with exact IMU signals, for LIO runs and tests
(port of the circle functions of agi_lidar_slam_tpu/sim/trajectory.py).

Convention: gravity g_world = (0,0,-G); the IMU measures specific force
f_body = R^T (a_world - g_world) and body rates w_body.

Times `t` may be a Python scalar, a sequence or a tensor. The result lies on
`device`; without one, on the device of a tensor `t`, else on cuda.
"""

from __future__ import annotations

import torch

from ..device import default_device
from ..geometry import se3, so3

G = 9.81


def _times(t, device) -> torch.Tensor:
    if device is None and isinstance(t, torch.Tensor):
        device = t.device
    return torch.as_tensor(t, dtype=torch.float32, device=default_device(device))


def circle_pose(t, radius: float, omega: float, device=None) -> se3.Pose:
    """Pose on a CCW circle in the XY plane, body x tangent to the path.
    t may be scalar or (...,)."""
    t = _times(t, device)
    th = omega * t
    zeros = torch.zeros_like(th)
    p = torch.stack([radius * torch.sin(th), radius * (1.0 - torch.cos(th)), zeros], dim=-1)
    q = so3.quat_exp(torch.stack([zeros, zeros, th], dim=-1))
    return se3.Pose(q, p)


def circle_velocity(t, radius: float, omega: float, device=None) -> torch.Tensor:
    t = _times(t, device)
    th = omega * t
    v = radius * omega
    return torch.stack([v * torch.cos(th), v * torch.sin(th), torch.zeros_like(th)], dim=-1)


def circle_imu(t, radius: float, omega: float, device=None):
    """Exact IMU at time t: (gyro_body (...,3), acc_body specific force (...,3)).
    In the body frame the tangent/normal decomposition gives a constant
    specific force (0, v*omega, G) and body rate (0, 0, omega)."""
    t = _times(t, device)
    v = radius * omega
    zeros = torch.zeros_like(t)
    acc_body = torch.stack([zeros, torch.full_like(t, v * omega), torch.full_like(t, G)], dim=-1)
    gyro_body = torch.stack([zeros, zeros, torch.full_like(t, omega)], dim=-1)
    return gyro_body, acc_body
