"""Parity of the port's slam and LIO-SAM engines with the reference, on the
CPU: IMU preintegration and deskew, one LIO-SAM step from a carried-over
JAX state, and both drivers end to end.

Inputs come from the port's simulator on the CPU (seeded; its parity with
the reference's is tests/test_torch_sim.py) as numpy, so the reference
compiles only its engine: the drivers' own jitted steps (`_slam_step`,
`_gps_edge`, `_align_step`, `_correct_and_rebuild`, `_liosam_fused_step`,
`_detect_step`, `imu_rate_poses`) and one program for the units. Sizes are
tiny: 16x720 scans, 512/2048 feature slots, odometry maps of 2^10/2^11
slots, a bank of 16 keyframes, loop maps of 2^10 slots with block_sub=2. The
reference unrolls the solver's association passes, a compile each, so both
solvers here make one pass (`n_outer=1`; tests/test_torch_pipeline.py runs
the preset's two).

Tolerances, with the figure measured on the CPU beside each:
* `preintegrate`: mean within 1e-5, covariance and bias Jacobian within 1e-4
  relative with a floor of 1e-4 of the largest entry (the doubling scan
  groups the f32 products another way; measured 6.0e-8, and 6.7e-8 and
  7.5e-9 of the largest entry);
* `deskew_with_imu`: 1e-5 m (measured 3.8e-6 m);
* the LIO-SAM step from a carried-over state: 1e-3 m / 1e-3 per
  quaternion component / 1e-3 m/s (measured 6.0e-8 m, 7.0e-11, 1.8e-7 m/s);
* `imu_rate_poses` (the driver's IMU-rate stream): 1e-5 (measured 1.3e-7);
* `align_loop`: z_rel within 1e-3 m and 1e-3 per quaternion component,
  fitness within 1e-4, `ok` equal (measured 2.4e-7 m, 3.7e-8, 2.6e-8);
* both drivers: poses and keyframe poses within 1e-3 m and 1e-3, keyframe,
  edge and closed-loop counts equal (measured 6.3e-7 m and 3.4e-6 for slam,
  keyframes 4.8e-7 m and 9.9e-8; 1.4e-7 m and 3.7e-9 for LIO-SAM);
* correspondence counts within 1% (measured: equal, but for one surf of 319
  on the slam run's scan after the closure, also from the carried-over
  state: a surf centroid of the extraction's 0.4 m downsample, 4e-6 m apart
  between the two, lies that close to a 0.8 m leaf boundary of the second
  downsample, which then puts it in the neighbouring voxel).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agi_lidar_slam_torch import convert
from agi_lidar_slam_torch.geometry import se3 as tse3
from agi_lidar_slam_torch.geometry import so3 as tso3
from agi_lidar_slam_torch.graph import loop_closure as tlc
from agi_lidar_slam_torch.imu import preintegration as tpre
from agi_lidar_slam_torch.pointcloud.cloud import ScanGrid as TScanGrid
from agi_lidar_slam_torch.runtime import liosam_pipeline as tls
from agi_lidar_slam_torch.runtime import slam_pipeline as tslam
from agi_lidar_slam_torch.runtime.lio_pipeline import ImuWindow as TImuWindow
from agi_lidar_slam_torch.sim import trajectory as ttraj
from agi_lidar_slam_torch.sim import world as tworld
from agi_lidar_slam_tpu.config import MapConfig, SolverConfig, preset_aloam_kitti64
from agi_lidar_slam_tpu.geometry import se3 as jse3
from agi_lidar_slam_tpu.geometry import so3 as jso3
from agi_lidar_slam_tpu.graph.loop_closure import LoopConfig
from agi_lidar_slam_tpu.imu import preintegration as jpre
from agi_lidar_slam_tpu.pointcloud.cloud import ScanGrid as JScanGrid
from agi_lidar_slam_tpu.runtime import liosam_pipeline as jls
from agi_lidar_slam_tpu.runtime import slam_pipeline as jslam
from agi_lidar_slam_tpu.runtime.lio_pipeline import ImuWindow as JImuWindow
from tests._torch_threads import torch_one_thread  # noqa: F401 (autouse)

_BASE = preset_aloam_kitti64()
PIPE = dataclasses.replace(
    _BASE,
    features=dataclasses.replace(_BASE.features, max_corners=512, max_surfs=2048),
    corner_map=dataclasses.replace(_BASE.corner_map, log2_slots=10),
    surf_map=dataclasses.replace(_BASE.surf_map, log2_slots=11),
    solver=dataclasses.replace(_BASE.solver, n_outer=1),
)
SLAM = jslam.SlamConfig(
    pipeline=PIPE, bank_capacity=16, edge_capacity=48, kf_dist=1.0, kf_angle=0.2,
    loop=LoopConfig(radius=3.0, min_stamp_sep=3, submap_half=0, fitness_thresh=0.3,
                    min_matches=50,
                    map_cfg=MapConfig(sub_voxel=0.4, block_sub=2, log2_slots=10,
                                      neighborhood="full27"),
                    solver=SolverConfig(n_outer=1, n_inner=3, surf_gate_sq=1.0,
                                        corner_gate_sq=1.0, degen_eig_thresh=10.0)),
    loop_every=2)
T_SLAM = convert.config_from_reference(SLAM)
LIOSAM = jls.LioSamConfig(slam=SLAM, scan_period=0.1)
T_LIOSAM = convert.config_from_reference(LIOSAM)
RINGS, WIDTH = 16, 720
N_SLAM = 6  # scans of the slam run; the external closure comes after scan 3
STEP, YAW = 0.7, 0.01  # m and rad a scan: keyframes at every second scan
RADIUS, OMEGA, SCAN_DT, IMU_N = 8.0, 0.25, 0.1, 20  # bench.py's LIO-SAM circle
N_LIOSAM = 4
T_TOL, Q_TOL = 1e-3, 1e-3


def _np(tree):
    return jax.tree.map(np.array, tree)


def _inputs():
    """The runs' scans from the port's simulator (numpy), and IMU windows."""
    rng = np.random.default_rng(9)
    cpu = "cpu"
    world = tworld.default_world(seed=0, n_pillars=48, extent=35.0, device=cpu)
    step = tse3.Pose(tso3.quat_exp(torch.tensor([0.0, 0.0, YAW])), torch.tensor([STEP, 0.0, 0.0]))
    pose = tse3.Pose.identity(device=cpu)
    slam_scans, gps = [], []
    for i in range(N_SLAM):
        nxt = tse3.compose(pose, step)
        s = tworld.simulate_scan(world, pose, nxt, rings=RINGS, width=WIDTH, fov_up_deg=2.0,
                                 fov_down_deg=-24.8, noise_std=0.01, seed=i)
        slam_scans.append(tuple(a.numpy() for a in s))
        gps.append((nxt.t.numpy() + rng.normal(scale=0.05, size=3)).astype(np.float32))
        pose = nxt
    world = tworld.default_world(seed=3, n_pillars=48, extent=35.0, device=cpu)
    lio = []
    for i in range(N_LIOSAM):
        t0, t1 = i * SCAN_DT, (i + 1) * SCAN_DT
        s = tworld.simulate_scan(world, ttraj.circle_pose(t0, RADIUS, OMEGA, cpu),
                                 ttraj.circle_pose(t1, RADIUS, OMEGA, cpu), rings=RINGS,
                                 width=WIDTH, fov_up_deg=2.0, fov_down_deg=-24.8,
                                 noise_std=0.01, seed=i)
        ts = t0 + (torch.arange(IMU_N) + 0.5) * (SCAN_DT / IMU_N)
        gy, ac = ttraj.circle_imu(ts, RADIUS, OMEGA)
        win = (gy.numpy(), ac.numpy(), np.full(IMU_N, SCAN_DT / IMU_N, np.float32),
               np.ones(IMU_N, bool))
        lio.append((tuple(a.numpy() for a in s), win))
    # a window with masked and uneven samples for the units
    gyro = (rng.normal(size=(IMU_N, 3)) * 0.3).astype(np.float32)
    acc = (rng.normal(size=(IMU_N, 3)) + [0.0, 0.0, 9.81]).astype(np.float32)
    dts = rng.uniform(0.003, 0.007, IMU_N).astype(np.float32)
    mask = np.ones(IMU_N, bool)
    mask[[3, 11, 17, 18, 19]] = False
    units = {"imu": (gyro, acc, dts, mask),
             "bg": (rng.normal(size=3) * 0.01).astype(np.float32),
             "ba": (rng.normal(size=3) * 0.05).astype(np.float32),
             "v_body": np.asarray([2.0, 0.3, -0.1], np.float32),
             "scan": slam_scans[1]}
    return slam_scans, gps, lio, units


@jax.jit
def _reference_units(u):
    g, a, dt, m = u["imu"]
    pre = jpre.preintegrate(g, a, dt, m, u["bg"], u["ba"])
    dsk = jls.deskew_with_imu(JScanGrid(*u["scan"]), JImuWindow(g, a, dt, m), u["bg"],
                              u["v_body"], 0.1)
    return pre, dsk


def _moving_start(engine, step_back):
    """The engine started with the trajectory's velocity (see
    tests/test_torch_pipeline.py: from rest this preset does not recover the
    first step)."""
    p1 = jse3.compose(engine.pose, step_back)
    return engine._replace(pose=p1, prev_pose=jse3.compose(p1, step_back))


def _reference_slam(scans, gps):
    """The reference's SlamDriver: GPS fixes on every scan (a (position,
    weight) pair on scan 2), an external closure (keyframe 1 -> 0) after
    scan 3, and the cadence's own detection read at finalize."""
    drv = jslam.SlamDriver(SLAM)
    back = jse3.inverse(jse3.Pose(jso3.quat_exp(jnp.asarray([0.0, 0.0, YAW])),
                                  jnp.asarray([STEP, 0.0, 0.0])))
    drv.state = drv.state._replace(engine=_moving_start(drv.state.engine, back))
    start = _np(drv.state.engine)
    results, closed = [], None
    for i, (s, fix) in enumerate(zip(scans, gps)):
        res = drv.process(JScanGrid(*map(jnp.asarray, s)),
                          gps=(jnp.asarray(fix), 0.5) if i == 2 else jnp.asarray(fix))
        results.append(_np(res))
        if i == 3:
            closed = drv.close_loop_external(1, 0)
        if i == N_SLAM - 2:
            mid = _np(drv.state)
    drv.finalize()
    # the alignment alone, keyframe 2 against keyframe 0, on the mid-run
    # bank: the driver's own compiled step, whose edge set holds z_rel
    b, e = (jax.tree.map(jnp.asarray, x) for x in (mid.bank, mid.edges))
    align = _np(jslam._align_step(b, e, jnp.int32(0), SLAM, cur=jnp.int32(2)))
    return dict(start=start, results=results, closed=closed, mid=mid, state=_np(drv.state),
                n_loops=drv.n_loops_closed, traj=drv.trajectory(), align=align)


def _reference_liosam(items):
    x0 = jse3.Pose(*(jnp.asarray(a) for a in _circle0()[0]))
    drv = jls.LioSamDriver(LIOSAM, x0=x0, v0=jnp.asarray(_circle0()[1]), emit_imu_rate=True)
    states, results = [_np(drv.state)], []
    for i, (s, w) in enumerate(items):
        res = drv.process(JScanGrid(*map(jnp.asarray, s)), JImuWindow(*map(jnp.asarray, w)),
                          gps=jnp.asarray([0.0, 0.2, 0.0]) if i == 1 else None)
        states.append(_np(drv.state))
        results.append(_np(res))
    drv._try_close_loop()
    return dict(states=states, results=results, bank=_np(drv.bank), edges=_np(drv.edges),
                imu_rate=_np(drv.imu_rate_out), n_loops=drv.n_loops_closed)


def _circle0():
    cpu = "cpu"
    p = ttraj.circle_pose(0.0, RADIUS, OMEGA, cpu)
    return (p.q.numpy(), p.t.numpy()), ttraj.circle_velocity(0.0, RADIUS, OMEGA, cpu).numpy()


@pytest.fixture(scope="module")
def inputs():
    slam_scans, gps, lio, units = _inputs()
    return dict(slam_scans=slam_scans, gps=gps, lio=lio, units=units)


# one reference run a fixture: a test builds only the ones it compares against
@pytest.fixture(scope="module")
def units_ref(inputs):
    return _np(_reference_units(inputs["units"]))


@pytest.fixture(scope="module")
def slam_ref(inputs):
    return _reference_slam(inputs["slam_scans"], inputs["gps"])


@pytest.fixture(scope="module")
def liosam_ref(inputs):
    return _reference_liosam(inputs["lio"])


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(t, j, atol, rtol=0.0):
    np.testing.assert_allclose(t.numpy() if isinstance(t, torch.Tensor) else t,
                               np.asarray(j), rtol=rtol, atol=atol)


def _close_cov(t, j, rtol=1e-4):
    """Relative tolerance with an absolute floor of rtol of the largest entry."""
    j = np.asarray(j)
    _close(t, j, atol=rtol * np.abs(j).max(), rtol=rtol)


def test_preintegrate_masked_window(inputs, units_ref):
    u, jpre_ = inputs["units"], units_ref[0]
    g, a, dt, m = (_t(x) for x in u["imu"])
    got = tpre.preintegrate(g, a, dt, m, _t(u["bg"]), _t(u["ba"]))
    for f in ("dq", "dp", "dv", "dt", "bg", "ba"):
        _close(getattr(got, f), getattr(jpre_, f), 1e-5)
    _close_cov(got.cov, jpre_.cov)
    _close_cov(got.J_bias, jpre_.J_bias)
    # masked samples count for nothing
    np.testing.assert_allclose(float(got.dt), float(dt[m].sum()), rtol=1e-6)


def test_deskew_with_imu(inputs, units_ref):
    u = inputs["units"]
    win = TImuWindow(*(_t(x) for x in u["imu"]))
    got = tls.deskew_with_imu(TScanGrid(*map(_t, u["scan"])), win, _t(u["bg"]),
                              _t(u["v_body"]), 0.1)
    jd = units_ref[1]
    _close(got.xyz, jd.xyz, 1e-5)
    np.testing.assert_array_equal(got.mask.numpy(), jd.mask)


def _scan(s):
    return TScanGrid(*map(_t, s))


def _win(w):
    return TImuWindow(*map(_t, w))


def _counts_close(stats, jstats):
    """Correspondence counts within 1% (see the module docstring)."""
    for f in ("n_corner", "n_surf"):
        got, want = int(getattr(stats, f)), int(getattr(jstats, f))
        assert abs(got - want) <= 0.01 * want, (f, got, want)


def _pose_close(tp, jp):
    _close(tp.t, jp.t, T_TOL)
    _close(tp.q, jp.q, Q_TOL)


def test_liosam_step_from_carried_over_state(inputs, liosam_ref):
    """One step of the port from the reference's state after scan 2 matches
    the reference's scan 3."""
    r = liosam_ref
    state = convert.liosam_state_from_numpy(r["states"][2], "cpu")
    np.testing.assert_array_equal(state.engine.surf_map.keys.numpy(),
                                  r["states"][2].engine.surf_map.keys)
    s, w = inputs["lio"][2]
    new, res = tls.process_liosam_scan(state, _scan(s), _win(w), T_LIOSAM)
    jst, jres = r["states"][3], r["results"][2]
    _pose_close(res.pose, jres.pose)
    _close(new.v, jst.v, 1e-3)
    _close(new.bg, jst.bg, 1e-3)
    _close(new.ba, jst.ba, 1e-3)
    _counts_close(res.stats, jres.stats)
    assert int(res.stats.n_surf) > 100


def test_sharded_liosam_step_on_two_ranks(inputs, liosam_ref, tmp_path):
    """parallel/sharding.sharded_liosam_step on two gloo ranks, each with its
    block of every scan's feature points, one step from each of the
    reference driver's states: both ranks alike, poses within 5e-3 m of the
    reference's and the surf map's occupancy equal (the JAX package's own
    tolerance for its sharded LIO-SAM step,
    tests/test_sharding_parity.py:211-213)."""
    from tests.test_torch_parallel import check_engine_ranks, engine_rank, launch_two

    r = liosam_ref
    runs = [(convert.liosam_state_from_numpy(r["states"][i], "cpu"), [(_scan(s), _win(w))])
            for i, (s, w) in enumerate(inputs["lio"])]
    ranks = launch_two(engine_rank, ("liosam", T_LIOSAM, runs), tmp_path)
    check_engine_ranks(ranks, [res.pose.t for res in r["results"]],
                       [st.engine.surf_map.occ for st in r["states"][1:]])


def test_liosam_driver(inputs, liosam_ref):
    """LioSamDriver over 4 scans on the circle with the IMU-rate stream on and
    a GPS fix on scan 1, then its synchronous loop-closure entry."""
    r = liosam_ref
    (q0, t0), v0 = _circle0()
    drv = tls.LioSamDriver(T_LIOSAM, x0=tse3.Pose(_t(q0), _t(t0)), v0=_t(v0),
                           emit_imu_rate=True, device="cpu")
    for i, ((s, w), jres) in enumerate(zip(inputs["lio"], r["results"])):
        res = drv.process(_scan(s), _win(w), gps=torch.tensor([0.0, 0.2, 0.0]) if i == 1 else None)
        _pose_close(res.pose, jres.pose)
        _close(res.v, jres.v, 1e-3)
        _counts_close(res.stats, jres.stats)
    for (qs, ps, mask), (jqs, jps, jmask) in zip(drv.imu_rate_out, r["imu_rate"]):
        _close(qs, jqs, 1e-5)
        _close(ps, jps, 1e-5)
        np.testing.assert_array_equal(mask.numpy(), jmask)
    # the synchronous detect-and-align entry: one keyframe, no candidate
    drv._try_close_loop()
    assert drv.n_loops_closed == r["n_loops"] == 0
    assert int(drv.bank.count) == int(r["bank"].count) >= 1
    assert int(drv.edges.count) == int(r["edges"].count)
    np.testing.assert_array_equal(drv.edges.kind.numpy(), r["edges"].kind)
    _close(drv.bank.t, r["bank"].t, T_TOL)


def test_slam_driver(inputs, slam_ref):
    """SlamDriver over 6 scans with GPS fixes, an external closure after scan
    3 and the cadence's detection drained at finalize: poses, keyframes,
    edges and closures as the reference's."""
    r = slam_ref
    drv = tslam.SlamDriver(T_SLAM, device="cpu")
    drv.state = drv.state._replace(engine=convert.state_from_numpy(r["start"], "cpu"))
    closed = None
    for i, (s, fix, jres) in enumerate(zip(inputs["slam_scans"], inputs["gps"], r["results"])):
        res = drv.process(_scan(s), gps=(_t(fix), 0.5) if i == 2 else _t(fix))
        _pose_close(res.pose, jres.pose)
        _counts_close(res.stats, jres.stats)
        if i == 3:
            closed = drv.close_loop_external(1, 0)
    drv.finalize()
    st, jst = drv.state, r["state"]
    assert closed == r["closed"] is True
    assert drv.n_loops_closed == r["n_loops"] >= 1
    for f in ("count", "stamp"):
        np.testing.assert_array_equal(getattr(st.bank, f).numpy(), getattr(jst.bank, f))
    for f in ("count", "i", "j", "kind", "valid"):
        np.testing.assert_array_equal(getattr(st.edges, f).numpy(), getattr(jst.edges, f))
    _close(st.bank.t, jst.bank.t, T_TOL)
    _close(st.bank.q, jst.bank.q, Q_TOL)
    _close(drv.trajectory(), r["traj"], T_TOL)
    _pose_close(st.engine.pose, jst.engine.pose)
    # the maps rebuilt from the corrected bank hold the same points
    assert int(st.engine.surf_map.num_points()) == int(
        np.asarray(jst.engine.surf_map.occ)[:-1].sum())
    assert int(st.bank.count) >= 3 and int(st.edges.count) >= 5


def test_slam_step_from_carried_over_state(inputs, slam_ref):
    """slam_state_from_numpy carries the reference's state over: from its
    state after scan 4 (bank, edges and the maps rebuilt by the closure), the
    port's step on scan 5 matches the reference's."""
    r = slam_ref
    state = convert.slam_state_from_numpy(r["mid"], "cpu")
    back = convert.state_to_numpy(state)
    np.testing.assert_array_equal(back["bank"]["surf_xyz"], r["mid"].bank.surf_xyz)
    np.testing.assert_array_equal(back["edges"]["z_t"], r["mid"].edges.z_t)
    new, res, added, cand, found = tslam._slam_step(state, _scan(inputs["slam_scans"][-1]), T_SLAM)
    jres = r["results"][-1]
    _pose_close(res.pose, jres.pose)
    _counts_close(res.stats, jres.stats)
    assert int(new.bank.count) == int(r["state"].bank.count)
    assert int(new.last_kf_idx) == int(r["state"].last_kf_idx)


def test_align_loop(slam_ref):
    """Keyframe 2 registered against keyframe 0's cloud (1.4 m apart) on the
    slam run's bank after scan 4: z_rel, fitness and the acceptance as the
    reference's."""
    r = slam_ref
    state = convert.slam_state_from_numpy(r["mid"], "cpu")
    z, fitness, ok = tlc.align_loop(state.bank, torch.tensor(2, dtype=torch.int32),
                                    torch.tensor(0, dtype=torch.int32), T_SLAM.loop)
    jedges, jok, jfit = r["align"]
    slot = int(r["mid"].edges.count)
    assert bool(ok) == bool(jok) is True
    assert int(jedges.count) == slot + 1
    _close(z.t, jedges.z_t[slot], 1e-3)
    _close(z.q, jedges.z_q[slot], 1e-3)
    np.testing.assert_allclose(float(fitness), float(jfit), rtol=0, atol=1e-4)
