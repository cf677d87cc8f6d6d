"""Parity of the port's livox engine (LIO-Livox: LO bootstrap, MAP
initialization, sliding-window MAP LIO with marginalization) with the
reference, on the CPU, for the slice as a whole: `LivoxDriver` in IMU_Mode
2 through the LO scans, the engagement and three window scans; one
`process_livox_scan` step from a carried-over reference state (the window
solve and the marginalization inside it); IMU_Mode 0 and 1.

Inputs are the port's simulator scans on the CPU (seeded; its parity with
the reference's is tests/test_torch_sim.py) along bench.py's circle, as
numpy, with exact 200 Hz IMU windows. Sizes are tiny: 16x720 scans,
256/1024/512 corner/surf/other slots, maps of 2^10-2^11 slots, one
association pass (each unrolled pass is a compile of the reference; the
cache's re-rank and re-probe, in the scan-to-map and the window solve, are
held to the reference in tests/test_torch_livox_units.py).
The reference compiles its LO step, its engine step and `map_initialize`
once each: its driver's engagement preintegrates op by op, which compiles
every op apart, so the fixture hands it the same `preintegrate` jitted.
Modes 0 and 1 reuse the LO step's compile: the reference's `_lo_step` never
reads `imu_mode`, so mode 0's reference is mode 2's LO scans, and mode 1's
is the reference driver's mode-1 branch (the gyro deskew, then `_lo_step`)
composed here from the same functions.

Tolerances, with the figure measured on the CPU beside each:
* poses, per scan, through LO, engagement and the window scans: 1e-3 m and
  1e-3 per quaternion component (measured 2.2e-5; with two association
  passes 3.8e-4 m: the window solve's f32 normal equations carry
  information of 1e8 beside 1, and the two libraries round them
  differently); the engagement scan and every n_dropped equal;
* `init_result`: gravity and velocities within 5e-4 of their largest entry,
  biases within 1e-4 (measured 4.3e-5 of it, 6.8e-6: the LO poses it starts
  from differ by the figure above);
* the step from a carried-over state: the window within 1e-3 (m, m/s and
  per quaternion component; measured 8.6e-5), residual within 1e-3
  relative, the prior's information and information vector within 1e-3 of
  their largest entries (measured 3.8e-7 and 1.1e-4 of it);
* modes 0 and 1: poses within 1e-4 m and 1e-4 (measured 6.0e-7).
"""

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agi_lidar_slam_torch import convert
from agi_lidar_slam_torch.geometry import se3 as tse3
from agi_lidar_slam_torch.pointcloud.cloud import ScanGrid as TScanGrid
from agi_lidar_slam_torch.runtime import livox_pipeline as tlp
from agi_lidar_slam_torch.runtime.lio_pipeline import ImuWindow as TImuWindow
from agi_lidar_slam_torch.sim import trajectory as ttraj
from agi_lidar_slam_torch.sim import world as tworld
from agi_lidar_slam_tpu.config import MapConfig, SolverConfig
from agi_lidar_slam_tpu.features.livox import LivoxFeatureConfig
from agi_lidar_slam_tpu.geometry import se3 as jse3
from agi_lidar_slam_tpu.geometry import so3 as jso3
from agi_lidar_slam_tpu.imu import deskew as jdsk
from agi_lidar_slam_tpu.imu import preintegration as jpre
from agi_lidar_slam_tpu.map.hash_map import empty_map as jempty_map
from agi_lidar_slam_tpu.pointcloud.cloud import ScanGrid as JScanGrid
from agi_lidar_slam_tpu.runtime import livox_pipeline as jlp
from agi_lidar_slam_tpu.runtime.lio_pipeline import ImuWindow as JImuWindow
from tests._torch_threads import torch_one_thread  # noqa: F401 (autouse)

CFG = jlp.LivoxConfig(
    features=LivoxFeatureConfig(max_corners=256, max_surfs=1024, max_others=512),
    corner_map=MapConfig(sub_voxel=0.5, block_sub=4, log2_slots=10),
    surf_map=MapConfig(sub_voxel=0.6, block_sub=4, log2_slots=11),
    other_map=MapConfig(sub_voxel=1.0, block_sub=4, log2_slots=10),
    solver=SolverConfig(n_outer=1, n_inner=1, degen_eig_thresh=10.0, cand_k=8))
T_CFG = convert.config_from_reference(CFG)
RADIUS, OMEGA, DT, M = 8.0, 0.25, 0.1, 20  # bench.py's circle, 200 Hz IMU
INIT_FRAMES = 4
N_SCANS = INIT_FRAMES + 3  # LO scans, the engagement, three window scans
N_LO = 3  # scans of modes 0 and 1
T_TOL, Q_TOL = 1e-3, 1e-3


def _np(tree):
    return jax.tree.map(np.array, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(t, j, atol, rtol=0.0):
    np.testing.assert_allclose(t.numpy() if isinstance(t, torch.Tensor) else t,
                               np.asarray(j), rtol=rtol, atol=atol)


def _close_rel(t, j, rel):
    j = np.asarray(j)
    _close(t, j, atol=rel * max(np.abs(j).max(), 1e-30))


def _inputs():
    """The circle's sweeps from the port's simulator, as numpy, and x0."""
    cpu = "cpu"
    world = tworld.default_world(seed=3, n_pillars=48, extent=35.0, device=cpu)
    items = []
    for i in range(N_SCANS):
        t0, t1 = i * DT, (i + 1) * DT
        s = tworld.simulate_scan(world, ttraj.circle_pose(t0, RADIUS, OMEGA, cpu),
                                 ttraj.circle_pose(t1, RADIUS, OMEGA, cpu), rings=16, width=720,
                                 fov_up_deg=2.0, fov_down_deg=-24.8, noise_std=0.01, seed=i)
        gy, ac = ttraj.circle_imu(t0 + (torch.arange(M) + 0.5) * (DT / M), RADIUS, OMEGA)
        items.append((tuple(a.numpy() for a in s),
                      (gy.numpy(), ac.numpy(), np.full(M, DT / M, np.float32), np.ones(M, bool))))
    p0 = ttraj.circle_pose(0.0, RADIUS, OMEGA, cpu)
    return items, (p0.q.numpy(), p0.t.numpy())


def _jin(item):
    s, w = item
    return JScanGrid(*map(jnp.asarray, s)), JImuWindow(*map(jnp.asarray, w))


def _reference_mode2(items, x0):
    drv = jlp.LivoxDriver(CFG, init_frames=INIT_FRAMES, x0=jse3.Pose(*map(jnp.asarray, x0)))
    results, engaged, states = [], [], {}
    with mock.patch.object(jlp, "preintegrate", jax.jit(jpre.preintegrate)):
        for i, item in enumerate(items):
            results.append(_np(drv.process(*_jin(item))))
            engaged.append(drv.engaged)
            if drv.engaged:  # process_livox_scan donates its state: copy it now
                states[i] = _np(drv.state)
    return dict(results=results, engaged=engaged, states=states, init=_np(drv.init_result))


def _reference_mode1(items, x0):
    """The reference driver's IMU_Mode 1 branch: the gyro deskew with the
    constant-velocity translation, then the LO step."""
    p0 = jse3.Pose(*map(jnp.asarray, x0))
    lo = jlp._LoState(p0, p0, *(jempty_map(c) for c in (CFG.corner_map, CFG.surf_map,
                                                        CFG.other_map)))
    deskew = jax.jit(jdsk.deskew_imu_rotation)
    poses = []
    for item in items[:N_LO]:
        scan, imu = _jin(item)
        rel_t = jso3.quat_rotate(jso3.quat_conj(lo.pose.q), lo.pose.t - lo.prev_pose.t)
        lo, pose, *_ = jlp._lo_step(lo, deskew(scan, imu.gyro, imu.dt, imu.mask, rel_t), CFG)
        poses.append(_np(pose))
    return poses


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


# one reference run a fixture: a test builds only the ones it compares against
@pytest.fixture(scope="module")
def ref(inputs):
    """The inputs, and the reference's IMU_Mode 2 run."""
    items, x0 = inputs
    return dict(items=items, x0=x0, mode2=_reference_mode2(items, x0))


@pytest.fixture(scope="module")
def mode1(inputs):
    return _reference_mode1(*inputs)


def _tin(item):
    s, w = item
    return TScanGrid(*map(_t, s)), TImuWindow(*map(_t, w))


def _driver(ref, cfg=T_CFG):
    return tlp.LivoxDriver(cfg, init_frames=INIT_FRAMES, x0=tse3.Pose(*map(_t, ref["x0"])),
                           device="cpu")


def _pose_close(tp, jp, t_tol=T_TOL, q_tol=Q_TOL):
    _close(tp.t, jp.t, t_tol)
    _close(tp.q, jp.q, q_tol)


def test_livox_driver_imu_mode_2(ref):
    """LO bootstrap, the MAP initialization at the same scan, then the
    window LIO: poses scan by scan, init_result, n_dropped."""
    r = ref["mode2"]
    drv = _driver(ref)
    for item, jres, jeng in zip(ref["items"], r["results"], r["engaged"]):
        res = drv.process(*_tin(item))
        assert drv.engaged == jeng
        _pose_close(res.pose, jres.pose)
        assert int(res.n_dropped) == int(jres.n_dropped)
    assert r["engaged"].index(True) == INIT_FRAMES - 1
    init, jinit = drv.init_result, r["init"]
    for f in ("grav", "v"):
        _close_rel(getattr(init, f), getattr(jinit, f), 5e-4)
    for f in ("bg", "ba"):
        _close(getattr(init, f), getattr(jinit, f), 1e-4)
    assert bool(init.ok) == bool(jinit.ok)
    assert int(drv.state.frame) == N_SCANS


def test_process_livox_scan_from_carried_over_state(ref):
    """livox_state_from_numpy carries the reference's state after the first
    window scan over (window, embedded prior, the three feature batches and
    maps); the port's step on the next scan gives the reference's window
    (the solve's state), residual (its final norm) and prior (the
    marginalization of its information), and leaves its input unchanged."""
    r = ref["mode2"]
    k = INIT_FRAMES
    jst, jnext, jres = r["states"][k], r["states"][k + 1], r["results"][k + 1]
    state = convert.livox_state_from_numpy(jst, "cpu")
    back = convert.state_to_numpy(state)
    np.testing.assert_array_equal(back["other_map"]["keys"], jst.other_map.keys)
    np.testing.assert_array_equal(back["prior"]["H"], jst.prior.H)
    kept = [t.clone() for t in state.surf_map]
    new, res = tlp.process_livox_scan(state, *_tin(ref["items"][k + 1]), T_CFG)
    assert all(torch.equal(a, b) for a, b in zip(kept, state.surf_map))
    for f in ("q", "t", "v", "bg", "ba"):
        _close(getattr(new.ws, f), getattr(jnext.ws, f), T_TOL)
    np.testing.assert_allclose(float(res.residual), float(jres.residual), rtol=1e-3)
    _close_rel(new.prior.H, jnext.prior.H, 1e-3)
    _close_rel(new.prior.b, jnext.prior.b, 1e-3)
    assert int(res.n_dropped) == int(jres.n_dropped)
    for f in ("corner_map", "surf_map", "other_map"):
        assert int(getattr(new, f).occ.sum()) == int(getattr(jnext, f).occ.sum())
    assert int(new.frame) == int(jnext.frame)


def test_sharded_livox_step_on_two_ranks(ref, tmp_path):
    """parallel/sharding.sharded_livox_step on two gloo ranks, each with its
    block of every frame's feature points, through the three window scans
    from the reference's state at the engagement: both ranks alike, poses
    within 5e-3 m of the reference's and the surf map's occupancy equal after
    every scan (the JAX package's own tolerance for its sharded window step,
    tests/test_sharding_parity.py:186-188)."""
    from tests.test_torch_parallel import check_engine_ranks, engine_rank, launch_two

    r, k = ref["mode2"], INIT_FRAMES - 1
    assert r["engaged"][k] and not r["engaged"][k - 1]
    state = convert.livox_state_from_numpy(r["states"][k], "cpu")
    items = [_tin(item) for item in ref["items"][k + 1:]]
    ranks = launch_two(engine_rank, ("livox", T_CFG, [(state, items)]), tmp_path)
    check_engine_ranks(ranks, [res.pose.t for res in r["results"][k + 1:]],
                       [r["states"][i].surf_map.occ for i in range(k + 1, N_SCANS)])


@pytest.mark.parametrize("mode", [0, 1])
def test_livox_driver_lidar_only(ref, request, mode):
    """IMU_Mode 0 (LiDAR-only) and 1 (gyro deskew, then LiDAR-only): never
    engages; poses as the reference's."""
    want = ([res.pose for res in ref["mode2"]["results"][:N_LO]] if mode == 0
            else request.getfixturevalue("mode1"))
    drv = _driver(ref, dataclasses.replace(T_CFG, imu_mode=mode))
    for item, jp in zip(ref["items"], want):
        res = drv.process(*_tin(item))
        _pose_close(res.pose, jp, 1e-4, 1e-4)
    assert not drv.engaged and drv.init_result is None


def test_config_and_solve_hook(ref):
    """The config conversion, and the multi-device hooks of the window step:
    _process_livox_body with a solve_fn that wraps solve_window with
    group=None and a knn_fn wrapping nn.knn.knn gives process_livox_scan's
    result bit for bit, from the reference's engaged state."""
    from agi_lidar_slam_torch.estimators import window_map as twm
    from agi_lidar_slam_torch.nn.knn import knn

    assert dataclasses.asdict(T_CFG) == dataclasses.asdict(CFG)
    # the port's defaults are the reference's: LivoxConfig() is bench.py's livox headline
    assert convert.config_from_reference(jlp.LivoxConfig()) == tlp.LivoxConfig()
    assert T_CFG.dynamic.grid == CFG.dynamic.grid == 128
    state = convert.livox_state_from_numpy(ref["mode2"]["states"][INIT_FRAMES], "cpu")
    calls = []

    def knn_fn(*a, **kw):
        calls.append("knn")
        return knn(*a, **kw)

    def solve_fn(*a, **kw):
        calls.append("solve")
        return twm.solve_window(*a, group=None, knn_fn=knn_fn, **kw)

    plain = tlp.process_livox_scan(state, *_tin(ref["items"][0]), T_CFG)
    hooked = tlp._process_livox_body(state, *_tin(ref["items"][0]), T_CFG, solve_fn=solve_fn)
    pl, hk = jax.tree.leaves(plain), jax.tree.leaves(hooked)
    assert len(pl) == len(hk) > 20 and all(torch.equal(a, b) for a, b in zip(pl, hk))
    assert calls[0] == "solve" and calls.count("knn") >= 3
