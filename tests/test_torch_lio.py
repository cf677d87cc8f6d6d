"""Parity of the port's LIO engine (FAST-LIO2 IESKF) with the reference, on
the CPU, module by module and for the slice as a whole.

The reference runs jitted, in three compiles per file: the unit pieces in
one program, the simulator's scans in another, `process_lio_scan` (itself
jitted) for the sequence. Inputs come from numpy with a seed.

Tolerances, and why:
* trajectory, `predict`, `boxplus`, `boxminus`, `lidar_to_world`: 1e-6
  absolute (the same f32 formulas; XLA contracts FMAs and multiplies by
  reciprocals under jit, a few ulps);
* `quat_prefix`, `compose_ltv`, `_propagate_window`: 1e-5 relative (the
  port composes by a doubling scan, XLA by its own associative-scan tree:
  the f32 products group differently); unit quaternions 1e-6 absolute,
  covariances with an absolute floor of 1e-5 of their largest entry;
* `voxel_downsample`, `undistort_to_end`: 3e-5 m (centroid arithmetic fused
  differently, as in tests/test_torch_voxel_features.py);
* `knn_cand` / `knn_reselect`: valid flags and points exact, squared
  distances 3e-6 (one ulp of distance evaluation order), ties to the first
  candidate on both sides;
* `update_iterated` from one state and map: state within 1e-5 (m, rad,
  m/s), n_valid equal; with a covariance that is not positive-definite,
  NaN on both sides after one iteration;
* the slice, 3 scans of tests/test_lio.py's small config on 16x720 scans:
  poses within 1e-4 m and 1e-4 per quaternion component, n_matches within
  0.5%.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agi_lidar_slam_torch import convert, preset_aloam_kitti64
from agi_lidar_slam_torch.config import MapConfig as TMapConfig
from agi_lidar_slam_torch.estimators import gn_scan2map as tgn
from agi_lidar_slam_torch.estimators import ieskf as tieskf
from agi_lidar_slam_torch.geometry import se3 as tse3
from agi_lidar_slam_torch.geometry import so3 as tso3
from agi_lidar_slam_torch.imu import eskf as teskf
from agi_lidar_slam_torch.graph import keyframes as tkf
from agi_lidar_slam_torch.graph import pose_graph as tpg
from agi_lidar_slam_torch.imu import preintegration as tpre
from agi_lidar_slam_torch.map import hash_map as thm
from agi_lidar_slam_torch.nn import knn as tknn
from agi_lidar_slam_torch.pointcloud import voxel as tvox
from agi_lidar_slam_torch.pointcloud.cloud import PointBatch as TBatch
from agi_lidar_slam_torch.runtime import liosam_pipeline as tls
from agi_lidar_slam_torch.runtime import lio_pipeline as tlio
from agi_lidar_slam_torch.runtime import pipeline as tpipe
from agi_lidar_slam_torch.runtime import slam_pipeline as tslam
from agi_lidar_slam_torch.sim import trajectory as ttraj
from agi_lidar_slam_torch.sim import world as tworld
from agi_lidar_slam_tpu.config import MapConfig
from agi_lidar_slam_tpu.estimators import gn_scan2map as jgn
from agi_lidar_slam_tpu.estimators import ieskf as jieskf
from agi_lidar_slam_tpu.geometry import se3 as jse3
from agi_lidar_slam_tpu.geometry import so3 as jso3
from agi_lidar_slam_tpu.imu import eskf as jeskf
from agi_lidar_slam_tpu.imu import preintegration as jpre
from agi_lidar_slam_tpu.map import hash_map as jhm
from agi_lidar_slam_tpu.nn import knn as jknn
from agi_lidar_slam_tpu.pointcloud import voxel as jvox
from agi_lidar_slam_tpu.pointcloud.cloud import PointBatch as JBatch
from agi_lidar_slam_tpu.runtime import lio_pipeline as jlio
from agi_lidar_slam_tpu.sim import trajectory as jtraj
from agi_lidar_slam_tpu.sim import world as jworld
from tests._torch_threads import torch_one_thread  # noqa: F401 (autouse)

# tests/test_lio.py's small LIO configuration and trajectory
RADIUS, OMEGA = 6.0, 0.25
SCAN_DT = 0.2
IMU_PER_SCAN = 20
N_SCANS = 3
CFG = jlio.LioConfig(
    map=MapConfig(sub_voxel=0.4, block_sub=4, log2_slots=15, neighborhood="octant8"),
    ieskf=jieskf.IeskfConfig(max_iters=4, gate_sq=0.64),
    scan_voxel=0.3,
    max_scan_pts=4096,
)
T_CFG = convert.config_from_reference(CFG)
# a small octant8 map for the unit pieces
UMAP = MapConfig(sub_voxel=0.4, block_sub=4, log2_slots=12, neighborhood="octant8")
T_UMAP = convert.config_from_reference(UMAP)
# update_iterated variants: (config, initial offset (dp, yaw)); map probes
PROBES = {"cache_refresh": 2, "cache": 1, "sform_no_cache": 0, "extrinsic": 1}
UPDATES = {
    # the correction moves the queries past cand_refresh: one re-probe
    "cache_refresh": (jieskf.IeskfConfig(), ([0.05, -0.04, 0.12], 0.012)),
    # a small correction: the cache serves every iteration
    "cache": (jieskf.IeskfConfig(), ([0.02, 0.01, -0.03], 0.001)),
    # the reference's s-form residual gate, a map probe per iteration
    "sform_no_cache": (jieskf.IeskfConfig(resid_gate="sform", gate_sq=5.0, cand_k=0),
                       ([0.03, 0.0, 0.05], 0.002)),
    "extrinsic": (jieskf.IeskfConfig(est_extrinsic=True), ([0.02, -0.01, 0.04], 0.002)),
}


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    """A numpy copy (process_lio_scan donates its state's buffers)."""
    return jax.tree.map(np.array, tree)


def _rand_nav(rng):
    q = rng.normal(size=4).astype(np.float32)
    q /= np.linalg.norm(q)
    ql = np.asarray([1.0, 0.01, -0.02, 0.03], np.float32)
    ql /= np.linalg.norm(ql)
    return jeskf.NavState(
        p=rng.normal(size=3).astype(np.float32), q=q, q_li=ql,
        t_li=np.asarray([0.05, -0.02, 0.1], np.float32),
        v=rng.normal(size=3).astype(np.float32),
        bg=(rng.normal(size=3) * 0.01).astype(np.float32),
        ba=(rng.normal(size=3) * 0.05).astype(np.float32),
        g=np.asarray([0.0, 0.0, -9.81], np.float32))


def _tnav(x):
    return convert.nav_state_from_numpy(x, "cpu")


def _spd(rng, scale=1e-3):
    a = rng.normal(size=(24, 24)) * 0.1
    return ((a @ a.T + np.eye(24)) * scale).astype(np.float32)


def _planes(rng):
    """Map points on a ground plane and two walls, and measurement points from
    the same surfaces (lidar frame = world at identity)."""
    g = np.stack(np.meshgrid(np.linspace(-8, 8, 60), np.linspace(-8, 8, 60)), -1).reshape(-1, 2)
    ground = np.concatenate([g, np.full((g.shape[0], 1), -1.0)], 1)
    w = np.stack(np.meshgrid(np.linspace(-8, 8, 60), np.linspace(-1, 3, 16)), -1).reshape(-1, 2)
    wall_x = np.stack([np.full(w.shape[0], 7.0), w[:, 0], w[:, 1]], 1)
    wall_y = np.stack([w[:, 0], np.full(w.shape[0], -6.0), w[:, 1]], 1)
    mpts = np.concatenate([ground, wall_x, wall_y]).astype(np.float32)
    spts = mpts[rng.choice(mpts.shape[0], 1500, replace=False)]
    spts = (spts + rng.normal(scale=0.01, size=spts.shape)).astype(np.float32)
    return mpts, spts


def _inputs():
    """Every unit input, from numpy seeds."""
    rng = np.random.default_rng(11)
    x = _rand_nav(rng)
    M = IMU_PER_SCAN
    r5 = np.random.RandomState(5)  # tests/test_lio.py's propagation case
    win = jlio.ImuWindow(
        (r5.randn(M, 3) * 0.3).astype(np.float32),
        (r5.randn(M, 3) + np.array([0, 0, 9.81])).astype(np.float32),
        np.full((M,), 0.005, np.float32), r5.rand(M) > 0.15)
    mpts, spts = _planes(rng)
    upd = {}
    for name, (_, (dp, yaw)) in UPDATES.items():
        q = np.asarray([np.cos(yaw / 2), 0.0, 0.0, np.sin(yaw / 2)], np.float32)
        upd[name] = jeskf.NavState(
            p=np.asarray(dp, np.float32), q=q,
            q_li=np.asarray([1.0, 0, 0, 0], np.float32), t_li=np.zeros(3, np.float32),
            v=np.asarray([1.0, 0.2, 0.0], np.float32), bg=np.zeros(3, np.float32),
            ba=np.zeros(3, np.float32), g=np.asarray([0.0, 0.0, -9.81], np.float32))
    kq = rng.uniform(-8, 8, (512, 3)).astype(np.float32)
    kq[:, 2] = rng.uniform(-1.5, 3.0, 512)
    return dict(
        t=np.linspace(0.0, 3.0, 7).astype(np.float32),
        x=x, P=_spd(rng), gyro=(rng.normal(size=3) * 0.3).astype(np.float32),
        acc=(rng.normal(size=3) + [0, 0, 9.81]).astype(np.float32),
        dx=(rng.normal(size=24) * 0.05).astype(np.float32), x2=_rand_nav(rng),
        pts=rng.uniform(-20, 20, (300, 3)).astype(np.float32),
        win=win, P0=np.eye(24, dtype=np.float32) * 1e-3,
        pts_t=rng.uniform(0.0, 0.1, 3000).astype(np.float32),
        cloud=rng.uniform(-30, 30, (3000, 3)).astype(np.float32),
        cloud_mask=rng.uniform(size=3000) > 0.1,
        mpts=mpts, spts=spts, kq=kq, kq_mask=rng.uniform(size=512) > 0.1,
        kq_moved=(kq + rng.normal(scale=0.05, size=kq.shape)).astype(np.float32),
        upd=upd, P_upd=np.eye(24, dtype=np.float32) * 1e-2,
        P_nonpd=np.diag(np.where(np.arange(24) == 5, -1e-3, 1e-2)).astype(np.float32),
        ref_q=np.asarray([np.cos(0.01), 0, np.sin(0.01), 0], np.float32),
        ref_t=np.asarray([0.3, -0.2, 0.1], np.float32))


@jax.jit
def _reference_units(d):
    """The reference's unit pieces, in one compile."""
    out = {}
    out["circle"] = (jtraj.circle_pose(d["t"], RADIUS, OMEGA),
                     jtraj.circle_velocity(d["t"], RADIUS, OMEGA),
                     jtraj.circle_imu(d["t"], RADIUS, OMEGA))
    x = d["x"]
    out["predict"] = jeskf.predict(x, d["P"], d["gyro"], d["acc"], 0.005)
    out["predict_dt0"] = jeskf.predict(x, d["P"], d["gyro"], d["acc"], 0.0)
    out["boxplus"] = jeskf.boxplus(x, d["dx"])
    out["boxminus"] = jeskf.boxminus(d["x2"], x)
    out["identity"] = jeskf.NavState.identity()
    out["lidar_to_world"] = jeskf.lidar_to_world(x, d["pts"])
    win = d["win"]
    out["quat_prefix"] = jpre.quat_prefix(jso3.quat_exp(win.gyro * 0.05))
    prop = jlio._propagate_window(d["x"]._replace(p=d["x"].p * 0), d["P0"], win,
                                  jeskf.EskfNoise())
    out["propagate"] = prop
    x_end, _, qs, ps, ts = prop
    out["undistort"] = jlio.undistort_to_end(d["cloud"] * 0.3, d["pts_t"], x_end, qs, ps, ts)
    out["static_init"] = jlio.static_init(win.gyro, win.acc, win.mask)
    out["voxel"] = jvox.voxel_downsample(d["cloud"], d["cloud_mask"], 0.8, 1024)
    out["cache_motion"] = jgn._cache_motion(jse3.Pose(x.q, x.p), d["ref_q"], d["ref_t"])
    smap = jhm.insert(jhm.empty_map(UMAP), d["mpts"], jnp.ones(d["mpts"].shape[0], bool), UMAP)
    out["map"] = smap
    cand, res = jknn.knn_cand(smap, d["kq"], d["kq_mask"], 8, UMAP, k=5)
    out["knn_cand"] = (cand, res, jknn.knn_reselect(cand, d["kq_moved"], d["kq_mask"], 5))
    pts = JBatch(d["spts"], jnp.ones(d["spts"].shape[0], bool))
    out["update"] = {name: jieskf.update_iterated(d["upd"][name], d["P_upd"], pts, smap, UMAP,
                                                  UPDATES[name][0])
                     for name in UPDATES}
    # a covariance that is not positive-definite
    out["update"]["non_pd"] = jieskf.update_iterated(d["upd"]["cache"], d["P_nonpd"], pts, smap,
                                                     UMAP, UPDATES["cache"][0])
    return out


@jax.jit
def _reference_scans():
    """tests/test_lio.py's sequence: world seed 4, 16x720 scans along the
    circle, exact 100 Hz IMU windows."""
    world = jworld.default_world(seed=4)
    scans, wins, gts = [], [], []
    for i in range(N_SCANS):
        t0, t1 = i * SCAN_DT, (i + 1) * SCAN_DT
        p0, p1 = jtraj.circle_pose(t0, RADIUS, OMEGA), jtraj.circle_pose(t1, RADIUS, OMEGA)
        scans.append(jworld.simulate_scan(world, p0, p1, rings=16, width=720,
                                          noise_std=0.003, seed=i))
        ts = t0 + (jnp.arange(IMU_PER_SCAN) + 0.5) * (SCAN_DT / IMU_PER_SCAN)
        gy, ac = jtraj.circle_imu(ts, RADIUS, OMEGA)
        wins.append(jlio.ImuWindow(gy, ac, jnp.full((IMU_PER_SCAN,), SCAN_DT / IMU_PER_SCAN),
                                   jnp.ones((IMU_PER_SCAN,), bool)))
        gts.append(p1)
    x0 = jeskf.NavState.identity()._replace(v=jtraj.circle_velocity(0.0, RADIUS, OMEGA))
    return scans, wins, gts, jlio.init_lio_state(CFG, x0)


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


# one reference run a fixture: a test builds only the ones it compares against
@pytest.fixture(scope="module")
def ref(inputs):
    """The inputs, and the reference's unit outputs as numpy."""
    return dict(d=inputs, units=_np(_reference_units(inputs)))


@pytest.fixture(scope="module")
def seq(inputs):
    """The inputs, and the reference's states and results of the 3-scan
    sequence as numpy."""
    scans, wins, gts, state = _reference_scans()
    flat = [(s.xyz.reshape(-1, 3), (s.time * SCAN_DT).reshape(-1), s.mask.reshape(-1))
            for s in scans]
    states, results = [_np(state)], []
    for (p, t, m), w in zip(flat, wins):
        state, res = jlio.process_lio_scan(state, p, t, m, w, CFG)
        states.append(_np(state))
        results.append(_np(res))
    # scan 1 again from a covariance that is not positive-definite (the
    # compiled step: the same shapes and weak types)
    nonpd = jax.tree.map(jnp.asarray, states[1]._replace(P=-inputs["P_upd"]))
    fallback = _np(jlio.process_lio_scan(nonpd, *flat[1], wins[1], CFG))
    return dict(d=inputs, flat=_np(flat), wins=_np(wins), gts=_np(gts),
                states=states, results=results, fallback=fallback)


def _close(t, j, atol, rtol=0.0):
    np.testing.assert_allclose(t.numpy() if isinstance(t, torch.Tensor) else t,
                               np.asarray(j), rtol=rtol, atol=atol)


def _nav_close(tx, jx, atol):
    for f in teskf.NavState._fields:
        _close(getattr(tx, f), getattr(jx, f), atol)


def test_circle_trajectory(ref):
    jpose, jvel, (jgy, jac) = ref["units"]["circle"]
    t = _t(ref["d"]["t"])
    pose = ttraj.circle_pose(t, RADIUS, OMEGA)
    _close(pose.q, jpose.q, 1e-6)
    _close(pose.t, jpose.t, 1e-6)
    _close(ttraj.circle_velocity(t, RADIUS, OMEGA), jvel, 1e-6)
    gy, ac = ttraj.circle_imu(t, RADIUS, OMEGA)
    _close(gy, jgy, 1e-6)
    _close(ac, jac, 1e-6)
    # a scalar time lands on the device it is given
    assert ttraj.circle_pose(0.5, RADIUS, OMEGA, device="cpu").t.shape == (3,)


@pytest.mark.parametrize("dt", [0.005, 0.0], ids=["step", "masked"])
def test_predict(ref, dt):
    d = ref["d"]
    jx, jP = ref["units"]["predict" if dt else "predict_dt0"]
    tx, tP = teskf.predict(_tnav(d["x"]), _t(d["P"]), _t(d["gyro"]), _t(d["acc"]), dt)
    _nav_close(tx, jx, 1e-6)
    _close(tP, jP, 1e-6)
    if not dt:
        assert torch.equal(tP, _t(d["P"]))  # an exact no-op


def test_boxplus_boxminus_lidar_to_world(ref):
    d, u = ref["d"], ref["units"]
    x = _tnav(d["x"])
    _nav_close(teskf.boxplus(x, _t(d["dx"])), u["boxplus"], 1e-6)
    _close(teskf.boxminus(_tnav(d["x2"]), x), u["boxminus"], 1e-6)
    _close(teskf.lidar_to_world(x, _t(d["pts"])), u["lidar_to_world"], 1e-5)
    _nav_close(teskf.NavState.identity("cpu"), u["identity"], 0.0)


def test_quat_prefix_and_compose_ltv(ref):
    d = ref["d"]
    dqs = tso3.quat_exp(_t(d["win"].gyro) * 0.05)
    _close(tpre.quat_prefix(dqs), ref["units"]["quat_prefix"], 1e-6)  # unit norm
    # compose_ltv against the step-by-step recurrence, in float64 numpy
    rng = np.random.default_rng(3)
    F = (np.eye(6) + rng.normal(scale=0.1, size=(13, 6, 6))).astype(np.float32)
    Q = np.stack([_spd(rng)[:6, :6] for _ in range(13)])
    A, C = tpre.compose_ltv(_t(F), _t(Q))
    a, c = np.eye(6), np.zeros((6, 6))
    for k in range(13):
        a, c = F[k].astype(np.float64) @ a, F[k] @ c @ F[k].T + Q[k]
        np.testing.assert_allclose(A[k].numpy(), a, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(C[k].numpy(), c, rtol=1e-5, atol=1e-8)


def test_propagate_window(ref):
    d = ref["d"]
    jx, jP, jqs, jps, jts = ref["units"]["propagate"]
    x0 = _tnav(d["x"])._replace(p=torch.zeros(3))
    tx, tP, qs, ps, ts = tlio._propagate_window(x0, _t(d["P0"]), tlio.ImuWindow(
        *(_t(a) for a in d["win"])), teskf.EskfNoise())
    for a, b in [(qs, jqs), (ps, jps), (ts, jts)]:
        _close(a, b, 1e-6, rtol=1e-5)
    _nav_close(tx, jx, 1e-5)
    _close(tP, jP, 1e-5 * np.abs(jP).max(), rtol=1e-5)


def test_undistort_and_static_init(ref):
    d, u = ref["d"], ref["units"]
    x0 = _tnav(d["x"])._replace(p=torch.zeros(3))
    tx, _, qs, ps, ts = tlio._propagate_window(x0, _t(d["P0"]), tlio.ImuWindow(
        *(_t(a) for a in d["win"])), teskf.EskfNoise())
    und = tlio.undistort_to_end(_t(d["cloud"]) * 0.3, _t(d["pts_t"]), tx, qs, ps, ts)
    _close(und, u["undistort"], 3e-5)
    w = tlio.ImuWindow(*(_t(a) for a in d["win"]))
    _nav_close(tlio.static_init(w.gyro, w.acc, w.mask), u["static_init"], 1e-6)


def test_voxel_downsample(ref):
    d = ref["d"]
    jb = ref["units"]["voxel"]
    tb = tvox.voxel_downsample(_t(d["cloud"]), _t(d["cloud_mask"]), 0.8, 1024)
    np.testing.assert_array_equal(tb.mask.numpy(), jb.mask)
    _close(tb.xyz, jb.xyz, 3e-5)


def _umap(ref):
    return convert.lio_state_from_numpy(
        {"x": ref["d"]["x"], "P": ref["d"]["P"], "map": ref["units"]["map"], "frame": 0},
        "cpu").map


def test_knn_cand_and_reselect(ref):
    """Against the reference's XLA gather path (its CPU path): points and
    flags exact, sq 3e-6. The reference's cache is (C,N) planes, the port's
    (N,C,3)."""
    d = ref["d"]
    jcand, jres, jsel = ref["units"]["knn_cand"]
    cand, res = tknn.knn_cand(_umap(ref), _t(d["kq"]), _t(d["kq_mask"]), 8, T_UMAP, k=5)
    jpts = np.stack([jcand.x.T, jcand.y.T, jcand.z.T], -1)
    np.testing.assert_array_equal(cand.valid.numpy(), jcand.valid.T)
    assert cand.valid.numpy().mean() > 0.3  # real neighbourhoods
    v = cand.valid.numpy()
    np.testing.assert_array_equal(cand.points.numpy()[v], jpts[v])
    np.testing.assert_array_equal(res.valid.numpy(), jres.valid)
    np.testing.assert_array_equal(res.points.numpy(), jres.points)
    _close(res.sq_dists, jres.sq_dists, 3e-6, rtol=3e-6)
    sel = tknn.knn_reselect(cand, _t(d["kq_moved"]), _t(d["kq_mask"]), 5)
    np.testing.assert_array_equal(sel.valid.numpy(), jsel.valid)
    np.testing.assert_array_equal(sel.points.numpy(), jsel.points)
    _close(sel.sq_dists, jsel.sq_dists, 3e-6, rtol=3e-6)


def test_knn_reselect_ties():
    """Exact ties: queries on a 1/8 m grid and candidates at +-0.5 m or
    +-1 m per axis, so that many candidates share one distance exactly. Both
    sides take tied candidates in candidate order (the reference's first-hit
    rule), which a stable sort in float64 reproduces."""
    rng = np.random.default_rng(8)
    N, C, k = 64, 8, 5
    q = (rng.integers(-40, 40, (N, 3)) / 8).astype(np.float32)
    off = rng.choice([-0.5, 0.5], size=(N, C, 3)) * rng.choice([1.0, 2.0], size=(N, C, 1))
    pts = (q[:, None, :] + off).astype(np.float32)
    valid = rng.uniform(size=(N, C)) > 0.2
    mask = rng.uniform(size=N) > 0.1
    jc = jknn.CandCache(*(jnp.asarray(a) for a in (pts[..., 0].T, pts[..., 1].T,
                                                   pts[..., 2].T, valid.T)))
    j = jax.jit(jknn.knn_reselect, static_argnums=3)(jc, jnp.asarray(q), jnp.asarray(mask), k)
    t = tknn.knn_reselect(tknn.CandCache(_t(pts), _t(valid)), _t(q), _t(mask), k)
    np.testing.assert_array_equal(t.valid.numpy(), np.asarray(j.valid))
    np.testing.assert_array_equal(t.points.numpy(), np.asarray(j.points))
    _close(t.sq_dists, j.sq_dists, 3e-6, rtol=3e-6)
    d2 = np.where(valid & mask[:, None], ((pts - q[:, None]) ** 2).sum(-1), np.inf)
    order = np.argsort(d2, axis=1, kind="stable")[:, :k]
    live = np.take_along_axis(d2, order, 1) < np.inf
    expect = np.where(live[..., None], np.take_along_axis(pts, order[..., None], 1), 0.0)
    np.testing.assert_array_equal(t.points.numpy(), expect)
    assert live.sum() > N  # ties were exercised


def test_cache_motion(ref):
    d, x = ref["d"], ref["d"]["x"]
    m = tgn._cache_motion(tse3.Pose(_t(x.q), _t(x.p)), _t(d["ref_q"]), _t(d["ref_t"]))
    _close(m, ref["units"]["cache_motion"], 1e-5, rtol=1e-6)


@pytest.mark.parametrize("name", sorted(UPDATES))
def test_update_iterated(ref, name, monkeypatch):
    """From one state and one map (carried over from the reference); the
    candidate cache is probed once, plus once when the correction outran it,
    and never with cand_k=0."""
    probes = []
    real = tieskf.knn_cand
    monkeypatch.setattr(tieskf, "knn_cand", lambda *a, **k: probes.append(1) or real(*a, **k))
    d = ref["d"]
    jx, jP, jn, jrms = ref["units"]["update"][name]
    pts = TBatch(_t(d["spts"]), torch.ones(d["spts"].shape[0], dtype=torch.bool))
    x, P, n, rms = tieskf.update_iterated(_tnav(d["upd"][name]), _t(d["P_upd"]), pts,
                                          _umap(ref), T_UMAP,
                                          convert.config_from_reference(UPDATES[name][0]))
    assert int(n) == int(jn) and int(n) > 500
    assert len(probes) == PROBES[name]
    _nav_close(x, jx, 1e-5)
    _close(rms, jrms, 1e-6, rtol=1e-4)
    if name == "extrinsic":
        # with a zero extrinsic the extrinsic columns of H repeat the pose
        # columns: A = P^-1 + H^T H / R is near singular along their
        # difference (condition ~1e5 in f32), so P differs by up to 5% of its
        # largest entry between two Cholesky orders. It stays symmetric. The
        # correction splits between pose and extrinsic, on both sides.
        assert torch.equal(P, P.T) and bool(torch.isfinite(P).all())
    else:
        _close(P, jP, 1e-5 * np.abs(jP).max(), rtol=1e-4)
        assert abs(float(x.p[2])) < 0.02  # the offset is corrected


def test_update_iterated_non_pd_covariance(ref, monkeypatch):
    """A P_prop that is not positive-definite: the reference's Cholesky is
    all NaN, so its update is NaN and its loop stops after the first
    iteration (|dx| >= eps is false for NaN). The port's is the same: NaN
    state and covariance, one linearization, and the count and residual of
    that first iteration."""
    calls = []
    real = tieskf._h_model
    monkeypatch.setattr(tieskf, "_h_model", lambda *a, **k: calls.append(1) or real(*a, **k))
    d = ref["d"]
    jx, jP, jn, jrms = ref["units"]["update"]["non_pd"]
    pts = TBatch(_t(d["spts"]), torch.ones(d["spts"].shape[0], dtype=torch.bool))
    x, P, n, rms = tieskf.update_iterated(_tnav(d["upd"]["cache"]), _t(d["P_nonpd"]), pts,
                                          _umap(ref), T_UMAP,
                                          convert.config_from_reference(UPDATES["cache"][0]))
    assert np.isnan(jx.p).all() and np.isnan(jP).all()
    assert all(bool(torch.isnan(a).all()) for a in (x.p, x.q, x.v, P))
    assert len(calls) == 1
    assert int(n) == int(jn) > 500
    _close(rms, jrms, 1e-6, rtol=1e-4)


def test_lio_step_divergence_fallback(seq):
    """One LIO step from the state after scan 0 with a negative-definite
    covariance (it stays so through the propagation): on both sides the
    update is NaN and the divergence fallback takes over (the propagated
    pose, zero velocity and biases, P = 0.1 I), and the map grows at the
    fallback pose."""
    jstate = seq["states"][1]._replace(P=-seq["d"]["P_upd"])
    jnew, jres = seq["fallback"]
    new, res = tlio.process_lio_scan(convert.lio_state_from_numpy(jstate, "cpu"),
                                     *_tflat(seq, 1), _twin(seq, 1), T_CFG)
    for x, P in ((jnew.x, jnew.P), (new.x, new.P.numpy())):
        assert not np.asarray(x.v).any() and not np.asarray(x.bg).any()
        assert not np.asarray(x.ba).any()
        np.testing.assert_array_equal(P, np.eye(24, dtype=np.float32) * 0.1)
    _nav_close(new.x, jnew.x, 1e-5)
    assert int(res.n_dropped) == int(jres.n_dropped)
    assert int(new.map.occ.sum()) == int(np.asarray(jnew.map.occ).sum())
    assert int(new.map.occ.sum()) > int(np.asarray(jstate.map.occ).sum())


def _tflat(ref, i):
    return [_t(a) for a in ref["flat"][i]]


def _twin(ref, i):
    return tlio.ImuWindow(*(_t(np.asarray(a)) for a in ref["wins"][i]))


def test_lio_slice_3_scans(seq):
    state = convert.lio_state_from_numpy(seq["states"][0], "cpu")
    for i, jres in enumerate(seq["results"]):
        state, res = tlio.process_lio_scan(state, *_tflat(seq, i), _twin(seq, i), T_CFG)
        _close(res.x.p, jres.x.p, 1e-4)
        _close(res.x.q, jres.x.q, 1e-4)
        jn = int(jres.n_matches)
        assert abs(int(res.n_matches) - jn) <= 0.005 * jn, (int(res.n_matches), jn)
        assert int(res.n_dropped) == int(jres.n_dropped)
    assert int(seq["results"][-1].n_matches) > 1000  # the engine tracks: real matches
    np.testing.assert_allclose(state.x.p.numpy(), seq["gts"][-1].t, atol=0.1)
    assert int(state.frame) == N_SCANS


def test_lio_step_from_carried_over_state(seq):
    """One step from the reference's state after scan 1 (NavState, P, map
    carried over); the input state is left as it was."""
    carried = convert.lio_state_from_numpy(seq["states"][1], "cpu")
    back = convert.state_to_numpy(carried)
    np.testing.assert_array_equal(back["map"]["keys"], seq["states"][1].map.keys)
    kept = [t.clone() for t in carried.map]
    state, res = tlio.process_lio_scan(carried, *_tflat(seq, 1), _twin(seq, 1), T_CFG)
    jres = seq["results"][1]
    _close(res.x.p, jres.x.p, 1e-4)
    _close(state.P, seq["states"][2].P, 1e-4 * np.abs(seq["states"][2].P).max(), rtol=1e-3)
    assert all(torch.equal(a, b) for a, b in zip(kept, carried.map))


def test_sharded_lio_step_on_two_ranks(seq, tmp_path):
    """parallel/sharding.sharded_lio_step on two gloo ranks, each with its
    block of every scan's points, through the 3-scan sequence from the
    reference's first state: both ranks alike, poses within 5e-3 m of the
    reference's and the map's occupancy equal after every scan (the JAX
    package's own tolerance for its sharded LIO step,
    tests/test_sharding_parity.py:163-165)."""
    from tests.test_torch_parallel import check_engine_ranks, engine_rank, launch_two

    items = [(*_tflat(seq, i), _twin(seq, i)) for i in range(N_SCANS)]
    state = convert.lio_state_from_numpy(seq["states"][0], "cpu")
    ranks = launch_two(engine_rank, ("lio", T_CFG, [(state, items)]), tmp_path)
    check_engine_ranks(ranks, [r.x.p for r in seq["results"]],
                       [s.map.occ for s in seq["states"][1:]])


def test_config_and_update_hook(seq):
    """The config conversion, and the multi-device hooks of the LIO step:
    _process_lio_body with an update_fn that wraps update_iterated, and
    update_iterated with group=None, each give the plain call's result bit
    for bit (state, covariance, map and result), from the reference's state
    after scan 1."""
    t = convert.config_from_reference(CFG)
    assert isinstance(t.map, TMapConfig) and isinstance(t.ieskf, tieskf.IeskfConfig)
    assert t == tlio.LioConfig(map=TMapConfig(sub_voxel=0.4, block_sub=4, log2_slots=15),
                               ieskf=tieskf.IeskfConfig(max_iters=4, gate_sq=0.64),
                               scan_voxel=0.3, max_scan_pts=4096)
    assert convert.config_from_reference(jlio.LioConfig()) == tlio.LioConfig()
    with pytest.raises(TypeError, match="no port config"):
        convert.config_from_reference(dataclasses.make_dataclass("Other", [])())
    calls = []

    def update_fn(*a, **kw):
        calls.append(len(a))
        return tieskf.update_iterated(*a, group=None, **kw)

    carried = convert.lio_state_from_numpy(seq["states"][1], "cpu")
    plain = tlio.process_lio_scan(carried, *_tflat(seq, 1), _twin(seq, 1), T_CFG)
    hooked = tlio._process_lio_body(carried, *_tflat(seq, 1), _twin(seq, 1), T_CFG,
                                    update_fn=update_fn)
    leaves = [(a, b) for x, y in zip(plain, hooked) for a, b in zip(_leaves(x), _leaves(y))]
    assert calls == [6] and len(leaves) > 8 and all(torch.equal(a, b) for a, b in leaves)
    assert int(plain[1].n_matches) > 1000  # a real update on a built map


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [leaf for x in tree for leaf in _leaves(x)]


ENTRY_POINTS = {
    "empty_map": lambda: thm.empty_map(T_UMAP),
    "init_state": lambda: tpipe.init_state(preset_aloam_kitti64()),
    "init_lio_state": lambda: tlio.init_lio_state(T_CFG),
    "default_world": lambda: tworld.default_world(seed=1),
    "NavState.identity": teskf.NavState.identity,
    "circle_pose": lambda: ttraj.circle_pose(0.0, RADIUS, OMEGA),
    "init_slam": lambda: tslam.init_slam(tslam.SlamConfig(bank_capacity=2, edge_capacity=2)),
    "empty_bank": lambda: tkf.empty_bank(2, 4, 4),
    "empty_edges": lambda: tpg.empty_edges(2),
    "init_liosam_state": lambda: tls.init_liosam_state(tls.LioSamConfig()),
    "SlamDriver": lambda: tslam.SlamDriver(
        tslam.SlamConfig(bank_capacity=2, edge_capacity=2)).state,
    "LioSamDriver": lambda: tls.LioSamDriver(tls.LioSamConfig(
        slam=tslam.SlamConfig(bank_capacity=2, edge_capacity=2))).state,
}


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_entry_points_default_to_cuda(entry):
    """Without a device, state is made on cuda: on a machine without a card
    that is torch's own error, on one with a card cuda tensors."""
    if torch.cuda.is_available():
        assert jax.tree.leaves(ENTRY_POINTS[entry]())[0].device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            ENTRY_POINTS[entry]()
