"""Analytic trajectories with exact IMU signals, for LIO runs and tests
(port of agi_lidar_slam_tpu/sim/trajectory.py): the circle, the rounded
square loop of the city world and the straight drive of the corridor.

Convention: gravity g_world = (0,0,-G); the IMU measures specific force
f_body = R^T (a_world - g_world) and body rates w_body.

Times `t` may be a Python scalar, a sequence or a tensor. The result lies on
`device`; without one, on the device of a tensor `t`, else on cuda.
"""

from __future__ import annotations

import math

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


def square_loop_pose(s, side: float, corner: float = 4.0, device=None) -> se3.Pose:
    """Pose at arc-length s along a CCW rounded square in the XY plane,
    centered at the origin, body x tangent to the path. `side` is the
    straight-segment length; `corner` the quarter-circle corner radius.
    The city-block driving pattern (KITTI urban loops): four straights with
    90-degree turns, closing on itself."""
    s = _times(s, device)
    arc = 0.5 * math.pi * corner
    leg = side + arc  # one straight + one corner
    perim = 4.0 * leg
    s = torch.remainder(s, perim)
    k = torch.floor(s / leg)  # which leg (0..3)
    u = s - k * leg  # arc length into the leg
    h = side / 2.0
    # leg-local: straight from (-h, -h-corner) towards +x, then corner turning left
    on_straight = u < side
    zeros = torch.zeros_like(s)
    xs = torch.where(on_straight, u - h, zeros + h)
    ys = torch.full_like(s, -h - corner)
    ang = torch.where(on_straight, zeros, (u - side) / corner)  # turned angle
    cx, cy = h, -h  # corner circle center in leg frame
    xc = cx + corner * torch.sin(ang)
    yc = cy - corner * torch.cos(ang)
    x = torch.where(on_straight, xs, xc)
    y = torch.where(on_straight, ys, yc)
    yaw_local = torch.where(on_straight, zeros, ang)
    # rotate leg frame by k * 90 deg
    rot = k * 0.5 * math.pi
    cr, sr = torch.cos(rot), torch.sin(rot)
    p = torch.stack([cr * x - sr * y, sr * x + cr * y, zeros], dim=-1)
    yaw = yaw_local + rot
    q = so3.quat_exp(torch.stack([zeros, zeros, yaw], dim=-1))
    return se3.Pose(q, p)


def square_loop_imu(t, side: float, corner: float = 4.0, speed: float = 3.5, device=None):
    """Exact IMU for square_loop_pose driven at constant speed: zero body
    rates on the straights, yaw rate v/r and centripetal v^2/r on the
    rounded corners. Piecewise-constant (discontinuous at segment joins,
    like a real vehicle's steering input). t scalar or (...,) seconds;
    arc length s = speed * t."""
    t = _times(t, device)
    s = torch.remainder(speed * t, 4.0 * (side + 0.5 * math.pi * corner))
    leg = side + 0.5 * math.pi * corner
    u = s - torch.floor(s / leg) * leg
    on_corner = u >= side
    zeros = torch.zeros_like(t)
    w = torch.where(on_corner, zeros + speed / corner, zeros)
    a_lat = torch.where(on_corner, zeros + speed**2 / corner, zeros)
    gyro = torch.stack([zeros, zeros, w], dim=-1)
    acc = torch.stack([zeros, a_lat, torch.full_like(t, G)], dim=-1)
    return gyro, acc


def straight_imu(t, speed: float = 3.5, device=None):
    """Exact IMU for a constant-velocity straight drive (corridor world)."""
    t = _times(t, device)
    zeros = torch.zeros_like(t)
    gyro = torch.stack([zeros, zeros, zeros], dim=-1)
    acc = torch.stack([zeros, zeros, torch.full_like(t, G)], dim=-1)
    return gyro, acc
