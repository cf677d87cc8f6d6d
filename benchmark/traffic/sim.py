# Frozen copy of the simulator of agi_lidar_slam_torch/sim/world.py
# (`default_world`, `ray_dirs`, `_raycast_boxes`, `simulate_scan`) and
# agi_lidar_slam_torch/sim/trajectory.py (`circle_pose`, `circle_imu`) at
# commit 88e7c49 (`circle_imu` takes the gravity's magnitude as an argument):
# the benchmark's traffic comes from here, so that changes to the program's
# simulator cannot move it. benchmark/tests/test_bench_sim.py holds it to the
# program's simulator at that commit, bit for bit.
"""Synthetic LiDAR sweeps: axis-aligned box worlds and exact raycasting, the
sensor moving during the sweep (a spinning lidar's motion-distorted cloud).
Random draws come from an explicit torch.Generator on the world's device."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from benchmark.reference import se3, so3
from benchmark.reference.cloud import ScanGrid
from benchmark.reference.device import default_device


class BoxWorld(NamedTuple):
    lo: torch.Tensor  # (M,3) box minima
    hi: torch.Tensor  # (M,3) box maxima
    # optional per-box velocity (M,3) m/s: moving objects
    vel: torch.Tensor | None = None


def _generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(seed)
    return g


def default_world(seed: int = 0, n_pillars: int = 24, extent: float = 18.0,
                  device=None) -> BoxWorld:
    """A walled arena with a ground slab and random pillars, with a clear
    corridor along +x so trajectories from the origin never enter a pillar.
    Made on `device` (default: cuda)."""
    device = default_device(device)
    g = _generator(seed, device)
    e = extent
    boxes_lo = [
        [-e, -e, -1.2],  # ground slab (top at z=-1.0 -> sensor 1 m above ground)
        [-e, -e, -1.0], [e - 0.4, -e, -1.0],  # x walls
        [-e, -e, -1.0], [-e, e - 0.4, -1.0],  # y walls
    ]
    boxes_hi = [
        [e, e, -1.0],
        [-e + 0.4, e, 4.0], [e, e, 4.0],
        [e, -e + 0.4, 4.0], [e, e, 4.0],
    ]
    centers = -0.8 * e + 1.6 * e * torch.rand((n_pillars, 2), generator=g, device=device)
    sizes = 0.3 + 1.1 * torch.rand((n_pillars, 2), generator=g, device=device)
    cy = centers[:, 1]
    centers[:, 1] = torch.where(torch.abs(cy) < 3.5, cy + torch.sign(cy + 0.1) * 3.5, cy)
    ones = torch.ones((n_pillars, 1), device=device)
    p_lo = torch.cat([centers - sizes, -1.0 * ones], dim=-1)
    p_hi = torch.cat([centers + sizes, 2.5 * ones], dim=-1)
    lo = torch.cat([torch.tensor(boxes_lo, dtype=torch.float32, device=device), p_lo])
    hi = torch.cat([torch.tensor(boxes_hi, dtype=torch.float32, device=device), p_hi])
    return BoxWorld(lo, hi)


def ray_dirs(rings: int, width: int, fov_up_deg: float, fov_down_deg: float,
             device=None) -> torch.Tensor:
    """Sensor-frame unit ray directions (R, W, 3) on `device` (default:
    cuda); azimuth sweeps column-major."""
    device = default_device(device)
    elev = torch.deg2rad(torch.linspace(fov_down_deg, fov_up_deg, rings, device=device))
    azim = -math.pi + (2 * math.pi / width) * torch.arange(width, device=device)
    ce, se_ = torch.cos(elev)[:, None], torch.sin(elev)[:, None]
    ca, sa = torch.cos(azim)[None, :], torch.sin(azim)[None, :]
    return torch.stack([ce * ca, ce * sa, se_.expand(rings, width)], dim=-1)


def _raycast_boxes(origins: torch.Tensor, dirs: torch.Tensor, world: BoxWorld,
                   max_range: float, box_shift: torch.Tensor | None = None) -> torch.Tensor:
    """Slab-method AABB raycast. origins/dirs (...,3) -> hit range (...,), inf
    if miss. box_shift (broadcastable to (...,M,3)) translates each box: the
    moving-object path (at 64x1800 with a few dozen boxes its (R,W,M,3)
    shifted boxes are tens of MB, which the card holds easily)."""
    o = origins[..., None, :]  # (...,1,3)
    d = dirs[..., None, :]
    tiny = torch.where(d >= 0, torch.full_like(d, 1e-9), torch.full_like(d, -1e-9))
    inv = 1.0 / torch.where(torch.abs(d) < 1e-9, tiny, d)
    lo, hi = world.lo, world.hi
    if box_shift is not None:
        lo = lo + box_shift
        hi = hi + box_shift
    t0 = (lo - o) * inv
    t1 = (hi - o) * inv
    t_enter = torch.amax(torch.minimum(t0, t1), dim=-1)  # (...,M)
    t_exit = torch.amin(torch.maximum(t0, t1), dim=-1)
    hit = (t_enter <= t_exit) & (t_exit > 0.0) & (t_enter > 1e-3)
    t = torch.amin(torch.where(hit, t_enter, torch.full_like(t_enter, math.inf)), dim=-1)
    return torch.where(t < max_range, t, torch.full_like(t, math.inf))


def simulate_scan(
    world: BoxWorld,
    pose_start: se3.Pose,
    pose_end: se3.Pose,
    rings: int = 16,
    width: int = 900,
    fov_up_deg: float = 15.0,
    fov_down_deg: float = -15.0,
    max_range: float = 80.0,
    noise_std: float = 0.0,
    seed: int = 0,
    t0: float = 0.0,
    scan_period: float = 0.1,
) -> ScanGrid:
    """One sweep with the sensor moving pose_start -> pose_end during the
    sweep: each column is measured in the sensor's instantaneous frame, the
    motion-distorted cloud a spinning lidar emits. Range noise is drawn from a
    torch.Generator seeded with `seed`, on the world's device.

    Worlds with movers (world.vel set): boxes sit at lo + vel * (t0 +
    tau * scan_period) when column tau fires — movers smear within the sweep
    and advance across frames via t0 (world time at sweep start, seconds)."""
    dev = world.lo.device
    W = width
    tau = torch.arange(W, dtype=torch.float32, device=dev) / W
    col_pose = se3.interpolate(pose_start, pose_end, tau)  # batched over W
    dirs_s = ray_dirs(rings, W, fov_up_deg, fov_down_deg, device=dev)  # (R,W,3)
    Rw = so3.quat_to_matrix(col_pose.q)  # (W,3,3)
    dirs_w = torch.einsum("wij,rwj->rwi", Rw, dirs_s)
    origins_w = col_pose.t[None, :, :].expand(rings, W, 3)
    shift = None
    if world.vel is not None:
        t_abs = t0 + tau * scan_period  # (W,)
        # (W,M,3), broadcast against origins (R,W,1,3) -> (R,W,M,3)
        shift = t_abs[:, None, None] * world.vel[None, :, :]
    t_hit = _raycast_boxes(origins_w, dirs_w, world, max_range, box_shift=shift)
    if noise_std > 0.0:
        noise = torch.randn(t_hit.shape, generator=_generator(seed, dev), device=dev)
        t_hit = t_hit + noise_std * noise
    mask = torch.isfinite(t_hit)
    rng = torch.where(mask, t_hit, torch.zeros_like(t_hit))
    pts_inst = dirs_s * rng[..., None]  # instantaneous-frame (motion-distorted) cloud
    time = tau[None, :].expand(rings, W).contiguous()
    return ScanGrid(pts_inst.contiguous(), mask, time)


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


G = 9.81


def circle_imu(t, radius: float, omega: float, device=None, gravity: float = G):
    """Exact IMU at time t: (gyro_body (...,3), acc_body specific force (...,3)).
    In the body frame the tangent/normal decomposition gives a constant
    specific force (0, v*omega, gravity) and body rate (0, 0, omega)."""
    t = _times(t, device)
    v = radius * omega
    zeros = torch.zeros_like(t)
    acc_body = torch.stack([zeros, torch.full_like(t, v * omega), torch.full_like(t, gravity)],
                           dim=-1)
    gyro_body = torch.stack([zeros, zeros, torch.full_like(t, omega)], dim=-1)
    return gyro_body, acc_body
