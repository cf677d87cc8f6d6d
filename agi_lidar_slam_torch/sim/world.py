"""Synthetic LiDAR simulator: axis-aligned box worlds + exact raycasting
(port of agi_lidar_slam_tpu/sim/world.py): the arena, city and corridor
worlds, moving boxes.

Random draws come from an explicit torch.Generator (on the world's device
for the arena, on the CPU for the city's and corridor's box loops, whose
finished boxes then move to the device once), so the same seed gives another
world (and other noise) than the JAX simulator's; tests hand both simulators
one world through convert.world_from_numpy.
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
    # optional per-box velocity (M,3) m/s: moving objects (cars/pedestrians).
    # Boxes translate with world time: within a sweep (per-column box
    # positions, so movers smear as a rolling-shutter lidar sees them) and
    # across frames (pass t0 to simulate_scan)
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


def _boxes(lo, hi, device) -> BoxWorld:
    return BoxWorld(torch.tensor(lo, dtype=torch.float32).to(device),
                    torch.tensor(hi, dtype=torch.float32).to(device))


def city_world(seed: int = 0, blocks: int = 3, building: float = 16.0,
               street: float = 10.0, max_height: float = 14.0, device=None) -> BoxWorld:
    """Manhattan grid of buildings — the urban-canyon stress case real KITTI
    drives exercise (tall walls both sides, ground, repeated structure).
    `blocks` x `blocks` buildings, separated by `street`-wide streets; the
    sensor drives the street grid. Heights vary so the skyline is not
    degenerate. The draws are made on the CPU, the boxes moved to `device`
    (default: cuda) once."""
    device = default_device(device)
    g = _generator(seed, "cpu")
    pitch = building + street
    span = blocks * pitch + street
    half = span / 2.0
    # ground slab under everything (top at z=-1.0: sensor 1 m up)
    lo = [[-half - 5.0, -half - 5.0, -1.2]]
    hi = [[half + 5.0, half + 5.0, -1.0]]
    hts = (4.0 + (max_height - 4.0) * torch.rand((blocks, blocks), generator=g)).tolist()
    # shrink each building footprint a touch so corners are distinct
    shr = (2.0 * torch.rand((blocks, blocks, 2), generator=g)).tolist()
    for i in range(blocks):
        for j in range(blocks):
            x0 = -half + street + i * pitch
            y0 = -half + street + j * pitch
            sx, sy = shr[i][j]
            lo.append([x0 + sx, y0 + sy, -1.0])
            hi.append([x0 + building - sx, y0 + building - sy, hts[i][j]])
    return _boxes(lo, hi, device)


def corridor_world(length: float = 120.0, width: float = 6.0,
                   height: float = 4.0, n_alcoves: int = 0,
                   seed: int = 0, device=None) -> BoxWorld:
    """Degenerate corridor/tunnel along +x (the LIO-Livox '4 km tunnel'
    robustness case, LIO-Livox/README.md:5-7): two side walls + ground +
    ceiling give no constraint along x, so the solver must detect/clamp it
    (degen_eig_thresh) rather than hallucinate. n_alcoves > 0 adds door-frame
    niches that restore weak x-observability. On `device` (default: cuda)."""
    device = default_device(device)
    w2 = width / 2.0
    lo = [
        [-5.0, -w2 - 0.4, -1.2],               # ground
        [-5.0, -w2 - 0.4, -1.0],               # left wall
        [-5.0, w2, -1.0],                      # right wall
        [-5.0, -w2 - 0.4, height],             # ceiling
        [-5.0, -w2 - 0.4, -1.0],               # back wall (behind start)
    ]
    hi = [
        [length, w2 + 0.4, -1.0],
        [length, -w2, height + 0.4],
        [length, w2 + 0.4, height + 0.4],
        [length, w2 + 0.4, height + 0.4],
        [-4.6, w2 + 0.4, height + 0.4],
    ]
    if n_alcoves:
        g = _generator(seed, "cpu")
        xs = (5.0 + (length - 10.0) * torch.rand((n_alcoves,), generator=g)).tolist()
        for k, x in enumerate(xs):
            # a 1 m-deep, 1.5 m-wide pillar jutting into the corridor from
            # alternating walls: breaks the wall plane with two x-facing faces
            if k % 2 == 0:
                lo.append([x, w2 - 1.0, -1.0])
                hi.append([x + 1.5, w2, height * 0.6])
            else:
                lo.append([x, -w2, -1.0])
                hi.append([x + 1.5, -w2 + 1.0, height * 0.6])
    return _boxes(lo, hi, device)


def with_movers(world: BoxWorld, seed: int = 0, n: int = 4,
                speed: float = 3.0, lane_y: float = 0.0,
                x_range: tuple = (5.0, 15.0)) -> BoxWorld:
    """Add car-sized moving boxes oncoming along -x in a lane near y=lane_y
    (the LIO-Livox dynamic-vehicle case PCSeg removes, segment.hpp:118-125).
    Static world boxes get zero velocity. Spawn x in x_range — keep it inside
    the world's walls or the movers are occluded. On the world's device."""
    dev = world.lo.device
    g = _generator(seed + 17, dev)
    xs = x_range[0] + (x_range[1] - x_range[0]) * torch.rand((n,), generator=g, device=dev)
    ys = lane_y - 1.0 + 2.0 * torch.rand((n,), generator=g, device=dev)
    car_l, car_w, car_h = 4.2, 1.8, 1.5  # L x W x H
    lo_m = torch.stack([xs, ys - car_w / 2, torch.full_like(xs, -1.0)], dim=-1)
    hi_m = lo_m + torch.stack([torch.full_like(xs, car_l), torch.full_like(xs, car_w),
                               torch.full_like(xs, car_h)], dim=-1)
    vel_m = torch.zeros_like(lo_m)
    vel_m[:, 0].fill_(-speed)
    vel = torch.cat([torch.zeros_like(world.lo) if world.vel is None else world.vel, vel_m])
    return BoxWorld(torch.cat([world.lo, lo_m]), torch.cat([world.hi, hi_m]), vel)


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
