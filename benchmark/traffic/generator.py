"""The one traffic generator: a traffic file of benchmark/traffic/ (its
`scene`) and a configuration's sensor give one lap of sweeps, made on the
device from the seed.

A `circle_lap` scene is a walled box arena (the simulator's `default_world`
with its extent and pillar count set by the scene) around a circle of
`radius_m` that the sensor drives once in `scans_per_lap` sweeps, at the
lidar's scan period, at one speed and yaw rate; every pillar is moved off the
lap by `clear_margin_m`, so the same count stands in every seed's world. The
lap closes on itself, so replaying it lap after lap is a continuous drive
around a mapped area. The seed draws the pillars and each sweep's range
noise; every seed gives the same sizes, the same trajectory and the same
number of sweeps.

A scene may carry an `imu` block: an IMU on the sensor's body frame sampled
at `rate_hz` from the lap's start, its exact readings (the frozen simulator's
`circle_imu`, specific force under a gravity of magnitude `gravity` m/s^2)
plus a constant bias and white noise. Each axis of the gyroscope's bias is
drawn once a lap with the standard deviation `gyro_bias` (rad/s), of the
accelerometer's with `acc_bias` (m/s^2); each sample's noise with
`gyro_noise` (rad/s) and `acc_noise` (m/s^2). They come from a generator of
their own (tag IMU_TAG), drawn in that order (the two biases, then the
gyroscope's noise, then the accelerometer's), so the block leaves every
sweep as it is without it. A sweep's samples are those whose time lies in
[sweep start, next sweep's start); the lap closes on itself, and so do its
readings, which a replay repeats lap after lap.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from benchmark.reference import se3
from benchmark.traffic.sim import BoxWorld, _generator, circle_imu, circle_pose, simulate_scan

SEED_MOD = 2**63  # torch.Generator seeds are 64-bit; the run's seed may be larger
IMU_TAG = 3  # the IMU's generator; 1 is the world's and 2 the sweeps'


class Imu(NamedTuple):
    """A lap's IMU stream, in the body frame of the sensor."""

    t: torch.Tensor  # (m,) seconds from the lap's start
    gyro: torch.Tensor  # (m, 3) body rates, rad/s
    acc: torch.Tensor  # (m, 3) specific force, m/s^2
    ranges: torch.Tensor  # (n + chunk - 1, 2) int64, each sweep's [first, end) sample


class Lap(NamedTuple):
    """One lap of sweeps, with the first `chunk - 1` repeated at the end so
    that every chunk of consecutive sweeps is one contiguous slice."""

    xyz: torch.Tensor  # (n + chunk - 1, R, W, 3) sensor-frame points
    mask: torch.Tensor  # (n + chunk - 1, R, W) valid returns
    time: torch.Tensor  # (n + chunk - 1, R, W) time in the sweep, 0..1
    n: int  # sweeps in a lap
    gt: se3.Pose  # (n,) sweep-start poses
    start: se3.Pose  # the pose one sweep before the lap's first
    before_start: se3.Pose  # and two sweeps before it
    imu: Imu | None = None  # where the scene has an `imu` block


def _seed(*parts: int) -> int:
    s = 0
    for p in parts:
        s = (s * 1_000_003 + int(p)) % SEED_MOD
    return s


def lap_world(seed: int, scene: dict, device) -> BoxWorld:
    """default_world's walled arena and pillars, centred on the lap's centre
    (0, radius), with pillars cleared off the lap."""
    g = _generator(_seed(seed, 1), device)
    e, r = float(scene["extent_m"]), float(scene["radius_m"])
    n = int(scene["pillars"])
    boxes_lo = [[-e, -e, -1.2], [-e, -e, -1.0], [e - 0.4, -e, -1.0],
                [-e, -e, -1.0], [-e, e - 0.4, -1.0]]
    boxes_hi = [[e, e, -1.0], [-e + 0.4, e, 4.0], [e, e, 4.0],
                [e, -e + 0.4, 4.0], [e, e, 4.0]]
    centers = -0.8 * e + 1.6 * e * torch.rand((n, 2), generator=g, device=device)
    sizes = 0.3 + 1.1 * torch.rand((n, 2), generator=g, device=device)
    d = torch.linalg.vector_norm(centers, dim=-1)
    need = float(scene["clear_margin_m"]) + torch.linalg.vector_norm(sizes, dim=-1)
    close = torch.abs(d - r) < need
    target = torch.where(d >= r, r + need, r - need)
    centers = torch.where(close[:, None], centers * (target / torch.clamp(d, min=1e-6))[:, None],
                          centers)
    ones = torch.ones((n, 1), device=device)
    lo = torch.cat([torch.tensor(boxes_lo, device=device),
                    torch.cat([centers - sizes, -1.0 * ones], dim=-1)])
    hi = torch.cat([torch.tensor(boxes_hi, device=device),
                    torch.cat([centers + sizes, 2.5 * ones], dim=-1)])
    shift = torch.tensor([0.0, r, 0.0], device=device)
    return BoxWorld(lo + shift, hi + shift)


def make_lap(scene: dict, sensor: dict, seed: int, chunk: int, device) -> Lap:
    """The scene's lap of sweeps for this sensor, on `device`."""
    if scene["kind"] != "circle_lap":
        raise ValueError(f"unknown scene kind {scene['kind']!r}")
    n, r = int(scene["scans_per_lap"]), float(scene["radius_m"])
    dt = float(sensor["scan_period_s"])
    omega = 2.0 * math.pi / (n * dt)
    world = lap_world(seed, scene, device)
    times = torch.arange(-2, n + 1, dtype=torch.float32, device=device) * dt
    poses = circle_pose(times, r, omega, device=device)  # sweeps -2 .. n

    def at(i):
        return se3.Pose(poses.q[i + 2], poses.t[i + 2])

    sweeps = [simulate_scan(world, at(i), at(i + 1), rings=sensor["rings"],
                            width=sensor["width"], fov_up_deg=sensor["fov_up_deg"],
                            fov_down_deg=sensor["fov_down_deg"],
                            max_range=sensor["max_range_m"], noise_std=sensor["noise_std_m"],
                            seed=_seed(seed, 2, i), scan_period=dt)
              for i in range(n)]
    sweeps += sweeps[:chunk - 1]
    xyz, mask, time = (torch.stack(f) for f in zip(*sweeps))
    imu = make_imu(scene["imu"], seed, n, dt, r, omega, chunk, device) if "imu" in scene else None
    return Lap(xyz, mask, time, n, se3.Pose(poses.q[2:n + 2], poses.t[2:n + 2]), at(-1), at(-2),
               imu)


def make_imu(block: dict, seed: int, n: int, dt: float, radius: float, omega: float,
             chunk: int, device) -> Imu:
    """The IMU stream of a lap of n sweeps of dt seconds on the circle."""
    rate = float(block["rate_hz"])
    # sample k lies in sweep floor(k / (rate * dt)); the rounding keeps a
    # sample that falls on a sweep's start in that sweep
    first = [math.ceil(round(i * dt * rate, 6)) for i in range(n + 1)]
    m = first[n]
    t = torch.arange(m, dtype=torch.float64, device=device).div_(rate).float()
    gyro, acc = circle_imu(t, radius, omega, device=device, gravity=float(block["gravity"]))
    g = _generator(_seed(seed, IMU_TAG), device)
    bias_g = float(block["gyro_bias"]) * torch.randn(3, generator=g, device=device)
    bias_a = float(block["acc_bias"]) * torch.randn(3, generator=g, device=device)
    noise_g = float(block["gyro_noise"]) * torch.randn((m, 3), generator=g, device=device)
    noise_a = float(block["acc_noise"]) * torch.randn((m, 3), generator=g, device=device)
    ranges = torch.tensor([[first[i % n], first[i % n + 1]] for i in range(n + chunk - 1)],
                          dtype=torch.int64, device=device)
    return Imu(t, gyro + bias_g + noise_g, acc + bias_a + noise_a, ranges)
