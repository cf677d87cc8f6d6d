"""The frozen simulator (benchmark/traffic/sim.py) gives the program's
simulator's sweeps and IMU bit for bit, at tiny sizes on the CPU, and the
generator's laps are what they were before laps had an IMU stream."""

import hashlib
import math

import numpy as np
import pytest
import torch

from agi_lidar_slam_torch.sim import trajectory as prog_traj
from agi_lidar_slam_torch.sim import world as prog_world
from benchmark.traffic import generator, sim


@pytest.mark.parametrize("fov", [(2.0, -24.8, 80.0), (15.0, -15.0, 100.0)])
@pytest.mark.parametrize("seed", [0, 5, 2**31 + 3])
def test_frozen_simulator_is_the_programs(seed, fov):
    up, down, rng = fov
    w = sim.default_world(seed=seed, n_pillars=12, extent=20.0, device="cpu")
    pw = prog_world.default_world(seed=seed, n_pillars=12, extent=20.0, device="cpu")
    assert torch.equal(w.lo, pw.lo) and torch.equal(w.hi, pw.hi)
    for i in range(2):
        a, b = sim.circle_pose(i * 0.1, 8.0, 0.25, device="cpu"), sim.circle_pose(
            (i + 1) * 0.1, 8.0, 0.25, device="cpu")
        pa, pb = prog_traj.circle_pose(i * 0.1, 8.0, 0.25, device="cpu"), prog_traj.circle_pose(
            (i + 1) * 0.1, 8.0, 0.25, device="cpu")
        assert torch.equal(a.q, pa.q) and torch.equal(a.t, pa.t)
        got = sim.simulate_scan(w, a, b, rings=6, width=48, fov_up_deg=up, fov_down_deg=down,
                                max_range=rng, noise_std=0.01, seed=seed + i)
        want = prog_world.simulate_scan(pw, pa, pb, rings=6, width=48, fov_up_deg=up,
                                        fov_down_deg=down, max_range=rng, noise_std=0.01,
                                        seed=seed + i)
        for x, y in zip(got, want):
            assert torch.equal(x, y)


@pytest.mark.parametrize("times", [0.0, [0.0, 0.005, 25.095], torch.arange(7) * 0.1])
def test_frozen_imu_is_the_programs(times):
    got = sim.circle_imu(times, 39.948, 0.2503, device="cpu")
    want = prog_traj.circle_imu(times, 39.948, 0.2503, device="cpu")
    for x, y in zip(got, want):
        assert torch.equal(x, y)


SCENE = {"kind": "circle_lap", "radius_m": 8.0, "scans_per_lap": 12, "extent_m": 35.0,
         "pillars": 48, "clear_margin_m": 2.0, "warmup_scans": 4}
SENSOR = {"rings": 4, "width": 32, "fov_up_deg": 15.0, "fov_down_deg": -15.0,
          "max_range_m": 100.0, "noise_std_m": 0.01, "scan_period_s": 0.1}
IMU = {"rate_hz": 200.0, "gyro_noise": 0.002, "acc_noise": 0.02, "gyro_bias": 0.001,
       "acc_bias": 0.05, "gravity": 9.81}
# sha256 over the bytes of xyz, mask, time, gt q, gt t, start q, start t,
# before_start q, before_start t of SCENE's lap at SENSOR, chunk 4, on the
# CPU, as the generator made them before laps had an IMU stream
PARENT_LAPS = {1: "677eed9e0b9005e30c9b8070bb2288e5eba78c9f36d8ee130643f99fcb3172d7",
               2**31 + 11: "925d3b419750d34c0bc6c93c4da0408f8ce8d7154785539fe07ee9dc977b95d9"}


def _digest(lap) -> str:
    h = hashlib.sha256()
    for t in (lap.xyz, lap.mask, lap.time, *lap.gt, *lap.start, *lap.before_start):
        h.update(t.contiguous().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("seed", sorted(PARENT_LAPS))
def test_lap_without_imu_is_bit_for_bit_as_before(seed):
    lap = generator.make_lap(SCENE, SENSOR, seed, 4, "cpu")
    assert lap.imu is None and _digest(lap) == PARENT_LAPS[seed]


@pytest.mark.parametrize("seed", sorted(PARENT_LAPS))
def test_imu_block_leaves_the_sweeps_as_they_were(seed):
    lap = generator.make_lap(dict(SCENE, imu=IMU), SENSOR, seed, 4, "cpu")
    assert _digest(lap) == PARENT_LAPS[seed]
    imu = lap.imu
    assert imu.t.shape == (240,) and imu.gyro.shape == imu.acc.shape == (240, 3)
    # 20 samples a sweep at 200 Hz, the lap's first three sweeps repeated
    assert torch.equal(imu.ranges[:, 1] - imu.ranges[:, 0], torch.full((15,), 20))
    assert torch.equal(imu.ranges[12:], imu.ranges[:3]) and int(imu.ranges[11, 1]) == 240
    # noise and bias are the IMU's own draws: the seed moves them, not the sweeps
    other = generator.make_lap(dict(SCENE, imu=IMU), SENSOR, seed + 1, 4, "cpu").imu
    assert not torch.equal(imu.gyro, other.gyro) and not torch.equal(imu.acc, other.acc)
    again = generator.make_lap(dict(SCENE, imu=IMU), SENSOR, seed, 4, "cpu").imu
    assert all(torch.equal(a, b) for a, b in zip(imu, again))


def _so3_exp(w: np.ndarray) -> np.ndarray:
    th = float(np.linalg.norm(w))
    k = np.array([[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]], [-w[1], w[0], 0.0]])
    if th < 1e-12:
        return np.eye(3) + k
    return np.eye(3) + math.sin(th) / th * k + (1.0 - math.cos(th)) / th**2 * k @ k


def test_noiseless_imu_integrates_around_the_lap():
    """Strapdown integration of the noiseless IMU (rotation by the exact
    exponential of each sample's rate, velocity and position by the
    trapezoid rule, in float64) from the lap's start pose and speed comes
    back to the start after one lap. Tolerances: the readings are float32,
    so the gravity of 9.81 reads 4.2e-7 m/s^2 high, 1.3e-4 m of height over
    the 25.1 s lap, and the trapezoid rule's error at 200 Hz is about 1e-5
    m (measured: 1.3e-4 m and 2.7e-7 rad); 1e-3 m and 1e-5 rad leave room
    for the summation order, and a vertical bias of 1e-3 m/s^2 alone would
    miss by 0.3 m."""
    n, dt, r = 251, 0.1, 39.94789071606573
    scene = {"kind": "circle_lap", "radius_m": r, "scans_per_lap": n, "extent_m": 60.0,
             "pillars": 4, "clear_margin_m": 2.0, "warmup_scans": 16,
             "imu": dict(IMU, gyro_noise=0.0, acc_noise=0.0, gyro_bias=0.0, acc_bias=0.0)}
    lap = generator.make_lap(scene, dict(SENSOR, rings=1, width=4), 5, 1, "cpu")
    gyro, acc, h = lap.imu.gyro.double().numpy(), lap.imu.acc.double().numpy(), 1.0 / 200.0
    assert gyro.shape == (5020, 3)
    omega = 2.0 * math.pi / (n * dt)
    R, p = np.eye(3), np.zeros(3)
    v, g = np.array([r * omega, 0.0, 0.0]), np.array([0.0, 0.0, -9.81])
    for w, f in zip(gyro, acc):
        R1 = R @ _so3_exp(w * h)
        v1 = v + 0.5 * ((R @ f + g) + (R1 @ f + g)) * h
        p, v, R = p + 0.5 * (v + v1) * h, v1, R1
    assert np.linalg.norm(p - lap.gt.t[0].double().numpy()) < 1e-3
    angle = math.acos(min(1.0, (np.trace(R) - 1.0) / 2.0))
    assert angle < 1e-5


def test_lap_is_the_same_work_for_every_seed_and_closes():
    scene = {"kind": "circle_lap", "radius_m": 8.0, "scans_per_lap": 12, "extent_m": 35.0,
             "pillars": 48, "clear_margin_m": 2.0, "warmup_scans": 4}
    sensor = {"rings": 4, "width": 32, "fov_up_deg": 15.0, "fov_down_deg": -15.0,
              "max_range_m": 100.0, "noise_std_m": 0.01, "scan_period_s": 0.1}
    laps = [generator.make_lap(scene, sensor, s, 4, "cpu") for s in (1, 2, 2**40 + 1)]
    for lap in laps:
        assert lap.xyz.shape == (15, 4, 32, 3) and lap.n == 12
        assert torch.equal(lap.xyz[12:], lap.xyz[:3])
    # the lap closes: the sweep after the last starts where the first does
    end = sim.circle_pose(12 * 0.1, 8.0, 2 * math.pi / 1.2, device="cpu")
    assert torch.allclose(end.t, laps[0].gt.t[0], atol=1e-5)
    assert not torch.equal(laps[0].xyz, laps[1].xyz)
    again = generator.make_lap(scene, sensor, 2, 4, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(again[:3], laps[1][:3]))
    world = generator.lap_world(7, scene, "cpu")
    centers = (world.lo[5:, :2] + world.hi[5:, :2]) / 2 - torch.tensor([0.0, 8.0])
    half = torch.linalg.vector_norm((world.hi[5:, :2] - world.lo[5:, :2]) / 2, dim=-1)
    assert torch.all(torch.abs(torch.linalg.vector_norm(centers, dim=-1) - 8.0) >= half + 2.0 - 1e-4)
