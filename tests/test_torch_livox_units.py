"""Parity of the port's livox modules with the reference, module by module,
on the CPU: the candidate-cache association of the scan-to-map solver, the
livox features, dynamic removal, mount calibration, MAP initialization, the
IMU deskew and fusion, and the window's information and marginalization.
(`solve_window` from a carried-over state is held to the reference's engine
step in tests/test_torch_livox.py, which compiles it anyway.)

Inputs come from the port's simulator on the CPU (seeded; its parity with the
reference's is tests/test_torch_sim.py) and numpy seeds; the maps are built
by the port and handed to both sides. The reference runs in four jitted
programs (`_reference_units`) at tiny shapes: 16x720 scans, 128/256/128
corner/surf/other feature slots (64/128/64 in the window), maps of 2^10-2^11
slots.

Tolerances, with the figure measured on the CPU beside each:
* `associate_cached` and the window's `associate_window`: masks equal,
  line and plane primitives within 1e-4 plus 1e-5 relative (plane offsets
  of 35 m, where an f32 ulp is 4e-6; measured 6.5e-6, and 1.0e-4 on an
  offset of 46 m); the cache's candidates equal;
* `extract_livox_features`: masks equal, points within 3e-5 m (voxel
  centroids fused differently, as in tests/test_torch_voxel_features.py;
  measured 3.8e-6);
* `remove_dynamic` at G = 128 and 200: the keep mask equal;
* mount calibration: normal and height within 1e-5, the corrected points
  within 1e-4 m (measured 1.2e-7, 1.9e-6 m);
* `map_initialize`: gravity and velocities within 1e-4 of their largest
  entry, biases within 1e-5 (measured 1.2e-6 of it, 4.0e-7); in the
  rank-deficient two-frame case, whose answer is the minimum-norm one,
  gravity and velocities within 1e-3 of it (measured 8.6e-5: with one
  interval the gravity direction rests on few equations);
* gyro track, deskew, fusion: 1e-5 (measured 3.8e-6);
* `window_information`: H within 1e-4 of its largest entry, b within 3e-4
  (measured 8.0e-8 and 3.1e-5 of it: b = -J^T r sums rows of both signs);
  `marginalize_oldest` within 1e-4 (measured 2.2e-6);
* the window solve's closed-form IMU Jacobian (port only) against
  torch.func.jacfwd of the residual: within 1e-5 of the largest entry
  (measured 8.1e-7).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agi_lidar_slam_torch import convert
from agi_lidar_slam_torch.estimators import gn_scan2map as tgn
from agi_lidar_slam_torch.estimators import window_map as twm
from agi_lidar_slam_torch.features import dynamic_removal as tdyn
from agi_lidar_slam_torch.features import livox as tlf
from agi_lidar_slam_torch.features import mount_calib as tmc
from agi_lidar_slam_torch.geometry import se3 as tse3
from agi_lidar_slam_torch.geometry import so3 as tso3
from agi_lidar_slam_torch.imu import deskew as tdsk
from agi_lidar_slam_torch.imu import initialization as tinit
from agi_lidar_slam_torch.imu.preintegration import Preintegrated as TPre
from agi_lidar_slam_torch.map import hash_map as thm
from agi_lidar_slam_torch.pointcloud.cloud import PointBatch as TBatch
from agi_lidar_slam_torch.pointcloud.cloud import ScanGrid as TScanGrid
from agi_lidar_slam_torch.sim import trajectory as ttraj
from agi_lidar_slam_torch.sim import world as tworld
from agi_lidar_slam_tpu.config import MapConfig, SolverConfig
from agi_lidar_slam_tpu.estimators import gn_scan2map as jgn
from agi_lidar_slam_tpu.estimators import window_map as jwm
from agi_lidar_slam_tpu.features import dynamic_removal as jdyn
from agi_lidar_slam_tpu.features import livox as jlf
from agi_lidar_slam_tpu.features import mount_calib as jmc
from agi_lidar_slam_tpu.geometry import se3 as jse3
from agi_lidar_slam_tpu.imu import deskew as jdsk
from agi_lidar_slam_tpu.imu import initialization as jinit
from agi_lidar_slam_tpu.imu import preintegration as jpre
from agi_lidar_slam_tpu.map.hash_map import HashVoxelMap as JMap
from agi_lidar_slam_tpu.pointcloud.cloud import PointBatch as JBatch
from agi_lidar_slam_tpu.pointcloud.cloud import ScanGrid as JScanGrid
from agi_lidar_slam_tpu.runtime import livox_pipeline as jlp
from tests._torch_threads import torch_one_thread  # noqa: F401 (autouse)

RADIUS, OMEGA, DT, M = 8.0, 0.25, 0.1, 20  # bench.py's circle, 200 Hz IMU
RINGS, WIDTH = 16, 720
FEAT = jlf.LivoxFeatureConfig(max_corners=128, max_surfs=256, max_others=128)
CMAP = MapConfig(sub_voxel=0.5, block_sub=4, log2_slots=10)
SMAP = MapConfig(sub_voxel=0.6, block_sub=4, log2_slots=11)
OMAP = MapConfig(sub_voxel=1.0, block_sub=4, log2_slots=10)
SOLVER = SolverConfig(n_outer=2, n_inner=1, degen_eig_thresh=10.0, cand_k=8)
# the livox engine's grid (G = 128, decimated statistics) and the default (G = 200)
DYN = {"livox": jlp.LivoxConfig().dynamic, "default": jdyn.DynamicRemovalConfig()}
GRAV = np.asarray([0.0, 0.0, -9.81], np.float32)
T = convert.config_from_reference


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree.map(np.array, tree)


def _close(t, j, atol, rtol=0.0):
    np.testing.assert_allclose(t.numpy() if isinstance(t, torch.Tensor) else t,
                               np.asarray(j), rtol=rtol, atol=atol)


def _close_rel(t, j, rel):
    """Within `rel` of the largest entry of the reference."""
    j = np.asarray(j)
    _close(t, j, atol=rel * max(np.abs(j).max(), 1e-30))


def _sim(world, t0, seed):
    cpu = "cpu"
    return tuple(a.numpy() for a in tworld.simulate_scan(
        world, ttraj.circle_pose(t0, RADIUS, OMEGA, cpu),
        ttraj.circle_pose(t0 + DT, RADIUS, OMEGA, cpu), rings=RINGS, width=WIDTH,
        fov_up_deg=2.0, fov_down_deg=-24.8, noise_std=0.01, seed=seed))


def _imu(t0):
    ts = t0 + (torch.arange(M) + 0.5) * (DT / M)
    gy, ac = ttraj.circle_imu(ts, RADIUS, OMEGA)
    return gy.numpy(), ac.numpy()


def _world_batch(b, pose):
    R = tso3.quat_to_matrix(pose.q)
    return b.xyz @ R.T + pose.t


def _inputs():
    """Every unit input, from the port's simulator and numpy seeds."""
    cpu = "cpu"
    rng = np.random.default_rng(21)
    world = tworld.default_world(seed=3, n_pillars=48, extent=35.0, device=cpu)
    scans = [_sim(world, i * DT, i) for i in range(2)]
    # a car-sized box in the open ahead of the sensor (tests/test_livox_pipeline.py)
    car = tworld.BoxWorld(torch.cat([world.lo, torch.tensor([[6.0, -1.0, -1.5]])]),
                          torch.cat([world.hi, torch.tensor([[8.0, 1.0, 0.2]])]))
    p = tse3.Pose.identity(device=cpu)
    car_scan = tuple(a.numpy() for a in tworld.simulate_scan(car, p, p, rings=RINGS, width=WIDTH,
                                                             fov_up_deg=2.0, fov_down_deg=-24.8))
    # window frames 0 and 1: livox features, maps of both at ground truth
    tfeat = T(FEAT)
    poses = [ttraj.circle_pose(i * DT, RADIUS, OMEGA, cpu) for i in range(2)]
    feats = [tlf.extract_livox_features(TScanGrid(*map(_t, s)), tfeat) for s in scans]
    maps = []
    for cfg, cls in ((CMAP, "corners"), (SMAP, "surfs"), (OMAP, "others")):
        m = thm.empty_map(T(cfg), cpu)
        for f, pose in zip(feats, poses):
            b = getattr(f, cls)
            m = thm.insert(m, _world_batch(b, pose), b.mask, T(cfg))
        maps.append(tuple(a.numpy() for a in m))
    # the window keeps a prefix of each class (the downsample front-packs)
    window = {cls: tuple(torch.stack([getattr(getattr(f, cls), a)[:n] for f in feats]).numpy()
                         for a in ("xyz", "mask"))
              for cls, n in (("corners", 64), ("surfs", 128), ("others", 64))}
    vel = [ttraj.circle_velocity(i * DT, RADIUS, OMEGA, cpu).numpy() for i in range(2)]
    ws_gt = dict(q=np.stack([p.q.numpy() for p in poses]), t=np.stack([p.t.numpy() for p in poses]),
                 v=np.stack(vel), bg=np.zeros((2, 3), np.float32),
                 ba=np.full((2, 3), 0.01, np.float32))
    # the window moved a little (inside the cache's skin) and past it
    ws_moves = [dict(ws_gt, t=ws_gt["t"] + np.float32(off),
                     q=tso3.quat_mul(_t(ws_gt["q"]), tso3.quat_exp(torch.tensor(w))).numpy())
                for off, w in (([0.01, 0.0, 0.0], [0.0, 0.0, 0.0005]),
                               ([0.2, 0.1, 0.0], [0.0, 0.0, 0.01]))]
    # the cached association: a probe at `pa`, a re-rank after a small move,
    # a re-probe after one past the cache's skin (0.3 m at the 30 m lever)
    pa = np.concatenate([poses[1].q.numpy(), poses[1].t.numpy() + np.float32([0.05, 0.02, 0.0])])
    moves = [np.concatenate([tso3.quat_mul(_t(pa[:4]), tso3.quat_exp(torch.tensor(w))).numpy(),
                             pa[4:] + np.float32(off)])
             for w, off in (([0.0, 0.0, 0.0005], [0.01, 0.0, 0.0]),
                            ([0.0, 0.0, 0.01], [0.2, 0.1, 0.0]))]
    # a gyro window with masked and uneven samples
    gyro = (rng.normal(size=(M, 3)) * 0.3).astype(np.float32)
    dts = rng.uniform(0.003, 0.007, M).astype(np.float32)
    imask = np.ones(M, bool)
    imask[[4, 9, 17, 18, 19]] = False
    # a tilted ground with clutter on one side, as seen by a tilted mount
    g = np.stack([rng.uniform(-18, 18, 3000), rng.uniform(-9, 9, 3000),
                  -1.2 + rng.normal(0, 0.02, 3000)], 1)
    w = np.stack([rng.uniform(-18, -10, 800), rng.uniform(-9, -5, 800),
                  rng.uniform(0.0, 3.0, 800)], 1)
    tilt = tso3.exp_matrix(torch.tensor([0.05, 0.08, 0.0])).numpy()
    ground = (np.concatenate([g, w]) @ tilt.T).astype(np.float32)
    return dict(
        scans=scans, car_scan=car_scan, maps=maps, window=window,
        feat1={cls: tuple(getattr(getattr(feats[1], cls), a).numpy() for a in ("xyz", "mask"))
               for cls in ("corners", "surfs")}, ws_gt=ws_gt, ws_moves=ws_moves,
        imu=[_imu(i * DT) for i in range(3)], pa=pa, moves=moves,
        gyro=gyro, dts=dts, imask=imask, rel_t=np.asarray([0.2, 0.01, -0.02], np.float32),
        v_world=np.asarray([2.0, 0.3, 0.0], np.float32), ground=ground,
        init_q=np.stack([ttraj.circle_pose(i * DT, RADIUS, OMEGA, cpu).q.numpy()
                         for i in range(4)]),
        init_t=np.stack([ttraj.circle_pose(i * DT, RADIUS, OMEGA, cpu).t.numpy()
                         for i in range(4)]),
        bias=(np.asarray([0.01, -0.02, 0.005], np.float32),
              np.asarray([0.05, 0.02, -0.03], np.float32)))


def _jmap(m):
    return JMap(*m)


def _jpose(v):
    return jse3.Pose(v[:4], v[4:])


def _jbatch(b):
    return JBatch(*b)


# The reference's unit pieces, jitted in groups: XLA:CPU compiles five
# programs of this size faster than their union (29 against 36 s, measured).

@jax.jit
def _ref_association(d):
    cmap, smap, omap = (_jmap(m) for m in d["maps"])
    c1, s1 = _jbatch(d["feat1"]["corners"]), _jbatch(d["feat1"]["surfs"])
    corr_a, cand = jgn.associate_cached(_jpose(d["pa"]), c1, s1, cmap, smap, CMAP, SMAP, SOLVER)
    # the window's association: a probe, then a re-rank and a re-probe (the
    # reference's lax.cond) at moved windows
    win = d["window"]
    wc, wsb = _jbatch(win["corners"]), _jbatch(win["surfs"])
    owin = dict(others=_jbatch(win["others"]), other_map=omap, omap_cfg=OMAP)
    first = jwm.associate_window(jwm.WindowState(**d["ws_gt"]), wc, wsb, cmap, smap, CMAP,
                                 SMAP, SOLVER, **owin)
    return {"assoc": (corr_a, cand) + tuple(
                jgn.associate_cached(_jpose(m), c1, s1, cmap, smap, CMAP, SMAP, SOLVER,
                                     cand=cand)[0] for m in d["moves"]),
            "assoc_window": (first[:2],) + tuple(
                jwm.associate_window(jwm.WindowState(**m), wc, wsb, cmap, smap, CMAP, SMAP,
                                     SOLVER, cand=first[2], **owin)[:2]
                for m in d["ws_moves"])}


@jax.jit
def _ref_scan(d):
    scan0 = JScanGrid(*d["scans"][0])
    car = JScanGrid(*d["car_scan"])
    gxyz = d["ground"]
    gmask = jnp.ones(gxyz.shape[0], bool)
    st1, est = jmc.update_mount(jmc.init_mount_state(), gxyz, gmask)
    st2, _ = jmc.update_mount(st1, gxyz * 1.01, gmask)  # the EMA branch
    pa = _jpose(d["pa"])
    return {"features": jlf.extract_livox_features(scan0, FEAT),
            "dynamic": {name: jdyn.remove_dynamic(car, cfg) for name, cfg in DYN.items()},
            "mount": (est, st1, st2, jmc.correct_points(gxyz, st2)),
            "track": jdsk.gyro_rotation_track(d["gyro"], d["dts"], d["imask"]),
            "deskew": jdsk.deskew_imu_rotation(scan0, d["gyro"], d["dts"], d["imask"],
                                               d["rel_t"]),
            "fuse": jdsk.fuse_imu_rate(pa.q, pa.t, d["v_world"], d["gyro"], d["dts"],
                                       d["imask"])}


@jax.jit
def _ref_init(d):
    bg, ba = d["bias"]
    pres = [jpre.preintegrate(g + bg, a + ba, jnp.full((M,), DT / M), jnp.ones(M, bool),
                              jnp.zeros(3), jnp.zeros(3)) for g, a in d["imu"]]
    preints = jax.tree.map(lambda *x: jnp.stack(x), *pres)
    # two frames: 9 equations in 12 unknowns, the minimum-norm solution
    return {"init": (preints, jinit.map_initialize(d["init_q"], d["init_t"], preints),
                     jinit.map_initialize(d["init_q"][:2], d["init_t"][:2],
                                          jax.tree.map(lambda x: x[:1], preints)))}


@jax.jit
def _ref_window(d, pre1):
    cmap, smap, omap = (_jmap(m) for m in d["maps"])
    win = d["window"]
    ws = jwm.WindowState(**d["ws_gt"])
    H, b = jwm.window_information(ws, _jbatch(win["corners"]), _jbatch(win["surfs"]), cmap,
                                  smap, pre1, GRAV, CMAP, SMAP, SOLVER,
                                  others=_jbatch(win["others"]), other_map=omap, omap_cfg=OMAP)
    return {"window": (H, b, jwm.marginalize_oldest(ws, H, b))}


def _reference_units(d):
    u = {**_ref_association(d), **_ref_scan(d), **_ref_init(d)}
    u.update(_ref_window(d, jax.tree.map(lambda x: x[:1], u["init"][0])))
    return u


@pytest.fixture(scope="module")
def ref():
    d = _inputs()
    return dict(d=d, u=_np(_reference_units(d)))


def _tmaps(ref):
    return [thm.HashVoxelMap(*map(_t, m)) for m in ref["d"]["maps"]]


def _tbatch(b):
    return TBatch(*map(_t, b))


def _tpose(v):
    return tse3.Pose(_t(v[:4]), _t(v[4:]))


def _corr_close(corr, jcorr, min_surfs=50):
    for f in ("ok_c", "ok_s"):
        np.testing.assert_array_equal(getattr(corr, f).numpy(), getattr(jcorr, f))
    assert int(corr.ok_c.sum()) > 0 and int(corr.ok_s.sum()) > min_surfs
    for f, ok in (("line_centroid", "ok_c"), ("line_dir", "ok_c"), ("plane_n", "ok_s"),
                  ("plane_d", "ok_s")):
        m = getattr(jcorr, ok)
        _close(getattr(corr, f).numpy()[m], getattr(jcorr, f)[m], 1e-4, rtol=1e-5)


def test_associate_cached_and_cached_solve(ref, monkeypatch):
    """A probe, a re-rank after a small move and a re-probe after a large one
    (one map probe each for the first and the last) against the reference;
    then the cached solve_scan2map on the port alone: its poses are held to
    the reference's in every LO step of tests/test_torch_livox.py."""
    probes = []
    real = tgn.knn_cand
    monkeypatch.setattr(tgn, "knn_cand", lambda *a, **k: probes.append(1) or real(*a, **k))
    d, u = ref["d"], ref["u"]
    cmap, smap, _ = _tmaps(ref)
    c1, s1 = _tbatch(d["feat1"]["corners"]), _tbatch(d["feat1"]["surfs"])
    tcfg = (T(CMAP), T(SMAP), T(SOLVER))
    corr, cand = tgn.associate_cached(_tpose(d["pa"]), c1, s1, cmap, smap, *tcfg)
    assert len(probes) == 2  # corners and surfs
    jcorr, jcand, jcorr_b, jcorr_c = u["assoc"]
    _corr_close(corr, jcorr)
    for tc, jc in zip(cand[:2], jcand[:2]):  # the reference keeps (C, N) planes
        valid = jc.valid.T
        np.testing.assert_array_equal(tc.valid.numpy(), valid)
        _close(tc.points.numpy()[valid], np.stack([jc.x.T, jc.y.T, jc.z.T], -1)[valid], 0.0)
    for move, jc, n_probes in zip(d["moves"], (jcorr_b, jcorr_c), (2, 4)):
        corr, _ = tgn.associate_cached(_tpose(move), c1, s1, cmap, smap, *tcfg, cand=cand)
        assert len(probes) == n_probes  # the small move re-ranks, the large one re-probes
        _corr_close(corr, jc)
    # the solve: a probe in its first pass, and a re-rank or a re-probe in its second
    probes.clear()
    _, stats = tgn.solve_scan2map(_tpose(d["pa"]), c1, s1, cmap, smap, *tcfg)
    assert len(probes) in (2, 4) and int(stats.n_surf) > 50
    # 0 < cand_k < k_neighbors runs plain association, as in the reference
    probes.clear()
    plain = [tgn.solve_scan2map(_tpose(d["pa"]), c1, s1, cmap, smap, *tcfg[:2],
                                dataclasses.replace(tcfg[2], cand_k=ck))[0] for ck in (0, 3)]
    assert not probes and torch.equal(plain[0].t, plain[1].t)


def test_extract_livox_features(ref):
    got = tlf.extract_livox_features(TScanGrid(*map(_t, ref["d"]["scans"][0])), T(FEAT))
    for cls in ("corners", "surfs", "others"):
        b, jb = getattr(got, cls), getattr(ref["u"]["features"], cls)
        np.testing.assert_array_equal(b.mask.numpy(), jb.mask)
        _close(b.xyz, jb.xyz, 3e-5)
        assert int(b.mask.sum()) > 20, cls


@pytest.mark.parametrize("name", sorted(DYN))
def test_remove_dynamic(ref, name):
    """G = 128 (the livox engine's) and G = 200, within the reference's
    exact range (G <= 256): the keep mask is the reference's."""
    keep = tdyn.remove_dynamic(TScanGrid(*map(_t, ref["d"]["car_scan"])), T(DYN[name]))
    jkeep = ref["u"]["dynamic"][name]
    np.testing.assert_array_equal(keep.numpy(), jkeep)
    assert int((ref["d"]["car_scan"][1] & ~jkeep).sum()) > 20  # something was removed


def test_remove_dynamic_large_grid():
    """G = 300 (> 256, where the reference's bf16 label gathers corrupt the
    clustering): a car-sized box whose cells lie beyond index 256 is removed
    and the tall walls are kept (tests/test_livox_pipeline.py's check)."""
    world = tworld.default_world(seed=3, n_pillars=0, extent=35.0, device="cpu")
    lo, hi = torch.tensor([[22.0, -1.0, -1.0]]), torch.tensor([[24.0, 1.0, 0.6]])
    world2 = tworld.BoxWorld(torch.cat([world.lo, lo]), torch.cat([world.hi, hi]))
    p = tse3.Pose.identity(device="cpu")
    scan = tworld.simulate_scan(world2, p, p, rings=32, width=1800)
    cfg = tdyn.DynamicRemovalConfig(cell=0.2, half_extent=30.0)
    assert cfg.grid == 300
    keep = tdyn.remove_dynamic(scan, cfg).numpy()
    xyz, mask = scan.xyz.numpy(), scan.mask.numpy()
    on_car = (mask & (xyz[..., 0] > 21.9) & (xyz[..., 0] < 24.1) & (np.abs(xyz[..., 1]) < 1.1)
              & (xyz[..., 2] > -0.6))  # above the ground band
    # the car's cells: x indices past 256
    assert np.all((xyz[on_car][:, 0] + 30.0) / 0.2 > 256)
    assert on_car.sum() > 30
    assert (keep & on_car).sum() < 0.2 * on_car.sum(), "car not removed"
    far_wall = mask & (np.abs(xyz[..., 0]) > 15.0) & (xyz[..., 2] > 0.5) & ~on_car
    assert far_wall.sum() > 50
    assert (keep & far_wall).sum() > 0.8 * far_wall.sum()


def test_mount_calibration(ref):
    """estimate_ground, two update_mount steps (first acceptance, then the
    EMA) and correct_points."""
    xyz = _t(ref["d"]["ground"])
    mask = torch.ones(xyz.shape[0], dtype=torch.bool)
    jest, jst1, jst2, jcorr = ref["u"]["mount"]
    est = tmc.estimate_ground(xyz, mask)
    st1, _ = tmc.update_mount(tmc.init_mount_state("cpu"), xyz, mask)
    st2, _ = tmc.update_mount(st1, xyz * 1.01, mask)
    assert bool(est.ok) == bool(jest.ok) is True
    assert int(est.n_points) == int(jest.n_points)
    _close(est.normal, jest.normal, 1e-5)
    _close(est.height, jest.height, 1e-5)
    for st, jst in ((st1, jst1), (st2, jst2)):
        _close(st.normal, jst.normal, 1e-5)
        _close(st.height, jst.height, 1e-5)
        assert bool(st.initialized) == bool(jst.initialized)
        assert int(st.misses) == int(jst.misses)
    _close(tmc.correct_points(xyz, st2), jcorr, 1e-4)


@pytest.mark.parametrize("frames", [4, 2], ids=["circle", "rank_deficient"])
def test_map_initialize(ref, frames):
    """Four frames on the circle with biased IMU; and two, where the linear
    systems are rank-deficient (9 equations, 12 and 11 unknowns) and the
    answer is their minimum-norm solution."""
    d = ref["d"]
    preints, jres = ref["u"]["init"][0], ref["u"]["init"][1 if frames == 4 else 2]
    got = tinit.map_initialize(_t(d["init_q"][:frames]), _t(d["init_t"][:frames]),
                               TPre(*(_t(x[:frames - 1]) for x in preints)))
    for f in ("grav", "v"):  # see the module docstring
        _close_rel(getattr(got, f), getattr(jres, f), 1e-4 if frames == 4 else 1e-3)
    for f in ("bg", "ba"):
        _close(getattr(got, f), getattr(jres, f), 1e-5)
    assert bool(got.ok) == bool(jres.ok)
    np.testing.assert_allclose(float(got.rms), float(jres.rms), rtol=1e-3, atol=1e-6)
    if frames == 4:
        assert np.linalg.norm(jres.grav - GRAV) < 0.1  # the reference recovers gravity


def test_gyro_track_deskew_and_fusion(ref):
    d, u = ref["d"], ref["u"]
    g, dts, m = _t(d["gyro"]), _t(d["dts"]), _t(d["imask"])
    _close(tdsk.gyro_rotation_track(g, dts, m), u["track"], 1e-5)
    got = tdsk.deskew_imu_rotation(TScanGrid(*map(_t, d["scans"][0])), g, dts, m, _t(d["rel_t"]))
    _close(got.xyz, u["deskew"].xyz, 1e-5)
    pa = _tpose(d["pa"])
    qs, ps, valid = tdsk.fuse_imu_rate(pa.q, pa.t, _t(d["v_world"]), g, dts, m)
    for a, b in zip((qs, ps), u["fuse"][:2]):
        _close(a, b, 1e-5)
    np.testing.assert_array_equal(valid.numpy(), u["fuse"][2])


def _tws(node):
    return twm.WindowState(**{k: _t(v) for k, v in node.items()})


def test_window_information_and_marginalize(ref):
    """The full-stack jacfwd information of the window at ground truth, and
    the Schur complement of the reference's information."""
    d = ref["d"]
    jH, jb, jsmall = ref["u"]["window"]
    preints = ref["u"]["init"][0]
    cmap, smap, omap = _tmaps(ref)
    win = d["window"]
    ws = _tws(d["ws_gt"])
    H, b = twm.window_information(
        ws, _tbatch(win["corners"]), _tbatch(win["surfs"]), cmap, smap,
        TPre(*(_t(x[:1]) for x in preints)), _t(GRAV), T(CMAP), T(SMAP), T(SOLVER),
        others=_tbatch(win["others"]), other_map=omap, omap_cfg=T(OMAP))
    _close_rel(H, jH, 1e-4)
    _close_rel(b, jb, 3e-4)
    small = twm.marginalize_oldest(ws, _t(jH), _t(jb))
    _close_rel(small.H, jsmall.H, 1e-4)
    _close_rel(small.b, jsmall.b, 1e-4)
    _close(small.q0, jsmall.q0, 0.0)


def test_imu_jacobian_matches_jacfwd(ref):
    """The window solve's closed-form IMU-factor Jacobian against
    torch.func.jacfwd of the residual (the reference's jax.jacfwd form), at
    ground truth, and at random windows with bias offsets and large
    rotations."""
    d = ref["d"]
    preints = ref["u"]["init"][0]
    grav = _t(GRAV)
    rng = np.random.default_rng(5)
    states = [_tws(d["ws_gt"])]
    for _ in range(3):
        q = rng.normal(size=(2, 4)).astype(np.float32)
        states.append(twm.WindowState(
            tso3.quat_normalize(_t(q)), *(_t(rng.normal(scale=s, size=(2, 3)).astype(np.float32))
                                          for s in (2.0, 1.0, 0.02, 0.1))))
    for ws in states:
        for i in range(2):  # both intervals of a three-frame window
            q3 = tso3.quat_mul(ws.q[-1:], tso3.quat_exp(torch.tensor([[0.02, -0.01, 0.05]])))
            ws3 = twm.WindowState(torch.cat([ws.q, q3]),
                                  *(torch.cat([x, x[-1:] * 0.9]) for x in ws[1:]))
            pre = TPre(*(_t(x[i]) for x in preints))
            J = twm._imu_jacobian(ws3, i, pre, grav)
            Jf = torch.func.jacfwd(lambda dx, i=i, pre=pre, ws3=ws3: twm._imu_residual(
                twm._apply_delta(ws3, dx), i, pre, grav))(torch.zeros(45))
            _close_rel(J, Jf, 1e-5)


def test_associate_window_cached(ref, monkeypatch):
    """The window's association, all three classes in one KNN call each:
    the probe, a re-rank after a small move of the window and a re-probe
    after a large one (its worst-moved frame past the skin)."""
    probes = []
    real = twm.knn_cand
    monkeypatch.setattr(twm, "knn_cand", lambda *a, **k: probes.append(1) or real(*a, **k))
    d, win = ref["d"], ref["d"]["window"]
    cmap, smap, omap = _tmaps(ref)
    args = (_tbatch(win["corners"]), _tbatch(win["surfs"]), cmap, smap, T(CMAP), T(SMAP),
            T(SOLVER))
    kw = dict(others=_tbatch(win["others"]), other_map=omap, omap_cfg=T(OMAP))
    corr, ocorr, cand = twm.associate_window(_tws(d["ws_gt"]), *args, **kw)
    results = [(corr, ocorr)]
    for move, n_probes in zip(d["ws_moves"], (3, 6)):
        results.append(twm.associate_window(_tws(move), *args, cand=cand, **kw)[:2])
        assert len(probes) == n_probes  # the small move re-ranks, the large one re-probes
    for (corr, ocorr), (jcorr, jocorr) in zip(results, ref["u"]["assoc_window"]):
        _corr_close(corr, jcorr, min_surfs=10)
        np.testing.assert_array_equal(ocorr.ok.numpy(), jocorr.ok)
        assert int(ocorr.ok.sum()) > 10
        _close(ocorr.n.numpy()[jocorr.ok], jocorr.n[jocorr.ok], 1e-4)
        _close(ocorr.d.numpy()[jocorr.ok], jocorr.d[jocorr.ok], 1e-4, rtol=1e-5)
