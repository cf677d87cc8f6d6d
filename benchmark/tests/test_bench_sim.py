"""The frozen simulator (benchmark/traffic/sim.py) gives the program's
simulator's sweeps bit for bit, at tiny sizes on the CPU."""

import math

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
