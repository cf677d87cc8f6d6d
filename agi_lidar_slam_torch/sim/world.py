"""Synthetic LiDAR simulator: axis-aligned box worlds + exact raycasting
(port of the parts of agi_lidar_slam_tpu/sim/world.py the main path uses).

Random draws come from an explicit torch.Generator on the world's device, so
the same seed gives another world (and other noise) than the JAX simulator's;
tests hand both simulators one world through convert.world_from_numpy.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..device import default_device
from ..geometry import se3, so3
from ..pointcloud.cloud import ScanGrid


class BoxWorld(NamedTuple):
    lo: torch.Tensor  # (M,3) box minima
    hi: torch.Tensor  # (M,3) box maxima


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
                   max_range: float) -> torch.Tensor:
    """Slab-method AABB raycast. origins/dirs (...,3) -> hit range (...,), inf if miss."""
    o = origins[..., None, :]  # (...,1,3)
    d = dirs[..., None, :]
    tiny = torch.where(d >= 0, torch.full_like(d, 1e-9), torch.full_like(d, -1e-9))
    inv = 1.0 / torch.where(torch.abs(d) < 1e-9, tiny, d)
    t0 = (world.lo - o) * inv
    t1 = (world.hi - o) * inv
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
) -> ScanGrid:
    """One sweep with the sensor moving pose_start -> pose_end during the
    sweep: each column is measured in the sensor's instantaneous frame, the
    motion-distorted cloud a spinning lidar emits. Range noise is drawn from a
    torch.Generator seeded with `seed`, on the world's device."""
    dev = world.lo.device
    W = width
    tau = torch.arange(W, dtype=torch.float32, device=dev) / W
    col_pose = se3.interpolate(pose_start, pose_end, tau)  # batched over W
    dirs_s = ray_dirs(rings, W, fov_up_deg, fov_down_deg, device=dev)  # (R,W,3)
    Rw = so3.quat_to_matrix(col_pose.q)  # (W,3,3)
    dirs_w = torch.einsum("wij,rwj->rwi", Rw, dirs_s)
    origins_w = col_pose.t[None, :, :].expand(rings, W, 3)
    t_hit = _raycast_boxes(origins_w, dirs_w, world, max_range)
    if noise_std > 0.0:
        noise = torch.randn(t_hit.shape, generator=_generator(seed, dev), device=dev)
        t_hit = t_hit + noise_std * noise
    mask = torch.isfinite(t_hit)
    rng = torch.where(mask, t_hit, torch.zeros_like(t_hit))
    pts_inst = dirs_s * rng[..., None]  # instantaneous-frame (motion-distorted) cloud
    time = tau[None, :].expand(rings, W).contiguous()
    return ScanGrid(pts_inst.contiguous(), mask, time)
