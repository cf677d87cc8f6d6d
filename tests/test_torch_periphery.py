"""Parity of the port's periphery (checkpoints and relocalization, the navsat
ESKF, the step-by-step preintegration and bias correction, the city /
corridor / mover worlds, the square-loop and straight trajectories, the
multi-session merge, the run metrics) with agi_lidar_slam_tpu.

Tolerances, each stated where it is checked:
* checkpoints carry bytes, relocalized maps are the hashed insert of the
  same points: exact;
* navsat over 3 IMU windows and 2 fixes: p, v within 1e-5, P within rtol
  1e-4 (f32 15x15 products in another order);
* preintegrate_scan, bias_corrected: within 1e-5 (covariance within rtol
  1e-4 of its own scale);
* worlds: the reference's worlds carried over by convert.world_from_numpy,
  noise-free scans: masks differ in at most 0.1% of the rays, points within
  1e-4 m (the bound of tests/test_torch_sim.py);
* trajectories and their exact IMU: within 1e-5;
* multi-session: merged banks, odometry edges and merged map keys exact.

Every JAX reference is jitted once per file at tiny shapes."""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agi_lidar_slam_torch import convert
from agi_lidar_slam_torch.convert import config_from_reference as port_cfg
from agi_lidar_slam_torch.geometry import se3 as tse3
from agi_lidar_slam_torch.graph import keyframes as tkf
from agi_lidar_slam_torch.imu import navsat as tnav
from agi_lidar_slam_torch.imu import preintegration as tpre
from agi_lidar_slam_torch.io import checkpoint as tck
from agi_lidar_slam_torch.runtime import lio_pipeline as tlio
from agi_lidar_slam_torch.runtime import metrics as tmet
from agi_lidar_slam_torch.runtime import multisession as tms
from agi_lidar_slam_torch.runtime import pipeline as tpipe
from agi_lidar_slam_torch.sim import trajectory as ttraj
from agi_lidar_slam_torch.sim import world as tworld
from agi_lidar_slam_tpu.config import MapConfig, preset_sim16
from agi_lidar_slam_tpu.geometry import se3 as jse3
from agi_lidar_slam_tpu.geometry import so3 as jso3
from agi_lidar_slam_tpu.graph import keyframes as jkf
from agi_lidar_slam_tpu.imu import navsat as jnav
from agi_lidar_slam_tpu.imu import preintegration as jpre
from agi_lidar_slam_tpu.io import checkpoint as jck
from agi_lidar_slam_tpu.runtime import lio_pipeline as jlio
from agi_lidar_slam_tpu.runtime import metrics as jmet
from agi_lidar_slam_tpu.runtime import multisession as jms
from agi_lidar_slam_tpu.runtime import pipeline as jpipe
from agi_lidar_slam_tpu.sim import trajectory as jtraj
from agi_lidar_slam_tpu.sim import world as jworld
from tests._torch_threads import torch_one_thread  # noqa: F401 (autouse)

SMALL = MapConfig(sub_voxel=0.4, block_sub=2, log2_slots=8)
JCFG = dataclasses.replace(preset_sim16(), corner_map=SMALL, surf_map=SMALL)
TCFG = port_cfg(JCFG)
JLIO = jlio.LioConfig(map=MapConfig(sub_voxel=0.5, block_sub=4, log2_slots=8))
TLIO = port_cfg(JLIO)

j_preint_scan = jax.jit(jpre.preintegrate_scan)
j_bias_corrected = jax.jit(jpre.bias_corrected)
j_simulate = jax.jit(jworld.simulate_scan, static_argnames=("rings", "width"))
j_square_pose = jax.jit(jtraj.square_loop_pose, static_argnums=(1, 2))
j_square_imu = jax.jit(jtraj.square_loop_imu, static_argnums=(1, 2, 3))
j_straight_imu = jax.jit(jtraj.straight_imu, static_argnums=1)
j_merged_map = jax.jit(jms.build_merged_map, static_argnums=1)


def _random_like(tree, seed):
    """The tree with every leaf replaced by random numpy data of its shape
    and dtype."""
    rng = np.random.default_rng(seed)

    def fill(a):
        a = np.asarray(a)
        if a.dtype == bool:
            return rng.random(a.shape) < 0.5
        if np.issubdtype(a.dtype, np.integer):
            return rng.integers(-1000, 1000, a.shape).astype(a.dtype)
        return rng.normal(0, 3, a.shape).astype(a.dtype)

    return jax.tree_util.tree_map(fill, tree)


def _leaves_equal(jtree, ttree):
    jl = jax.tree_util.tree_leaves(jtree)
    tl = [v for _, v in tck._leaves(ttree)]
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert np.asarray(a).dtype == b.numpy().dtype
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


_STATES = {
    "engine": (lambda: jpipe.init_state(JCFG), lambda: tpipe.init_state(TCFG, "cpu")),
    "lio": (lambda: jlio.init_lio_state(JLIO), lambda: tlio.init_lio_state(TLIO, device="cpu")),
}


@pytest.mark.parametrize("kind", sorted(_STATES))
def test_checkpoint_jax_to_port_and_back(tmp_path, kind):
    """A checkpoint written by the JAX package loads into the port's
    template and one written by the port into the JAX template, bit for bit
    (the same .npz keys)."""
    make_j, make_t = _STATES[kind]
    jstate = _random_like(make_j(), seed=1)
    jck.save_state(str(tmp_path / "j.npz"), jstate)
    tstate = tck.load_state(str(tmp_path / "j.npz"), make_t())
    _leaves_equal(jstate, tstate)
    assert sorted(np.load(tmp_path / "j.npz").files) == sorted(tck._flatten_keys(tstate))

    tck.save_state(str(tmp_path / "t.npz"), _random_port(make_t(), seed=2))
    back = jck.load_state(str(tmp_path / "t.npz"), make_j())
    _leaves_equal(back, tck.load_state(str(tmp_path / "t.npz"), make_t()))
    with pytest.raises(KeyError):
        tck.load_state(str(tmp_path / "t.npz"), {"missing": torch.zeros(1)})


def _random_port(tree, seed):
    leaves = [v for _, v in tck._leaves(tree)]
    rng = np.random.default_rng(seed)
    out = []
    for v in leaves:
        a = v.numpy()
        if a.dtype == bool:
            out.append(torch.from_numpy(rng.random(a.shape) < 0.5))
        elif np.issubdtype(a.dtype, np.integer):
            out.append(torch.from_numpy(rng.integers(-9, 9, a.shape).astype(a.dtype)))
        else:
            out.append(torch.from_numpy(rng.normal(0, 2, a.shape).astype(a.dtype)))
    return tck._rebuild(tree, iter(out))


def _cloud(n, seed):
    return np.random.default_rng(seed).uniform(-12, 12, (n, 3)).astype(np.float32)


_RELOC_POSES = {"engine": ([0.0, 0.0, 0.4], [1.0, -2.0, 0.5]),
                "lio": ([0.0, 0.0, -0.7], [0.3, 0.2, -0.1])}


@functools.lru_cache(maxsize=1)
def _reference_relocalized():
    """The reference's relocalize_state and relocalize_lio_state on the
    clouds and seeds of the two tests below, in one compile; the seeds as
    numpy (q, t)."""
    seeds = {k: (np.asarray(jso3.quat_exp(jnp.asarray(w))), np.asarray(t, np.float32))
             for k, (w, t) in _RELOC_POSES.items()}

    @jax.jit
    def both(corner, surf, pts, pose, lio_pose):
        return (jck.relocalize_state(JCFG, corner, surf, pose),
                jck.relocalize_lio_state(JLIO, pts, lio_pose))

    return both(_cloud(300, 3), _cloud(700, 4), _cloud(900, 5),
                jse3.Pose(*seeds["engine"]), jse3.Pose(*seeds["lio"])), seeds


def test_relocalize_state_matches_reference():
    corner, surf = _cloud(300, 3), _cloud(700, 4)
    (js, _), seeds = _reference_relocalized()
    q, t = seeds["engine"]
    ts = tck.relocalize_state(TCFG, corner, surf, tse3.Pose(torch.tensor(q), torch.tensor(t)),
                              device="cpu")
    _leaves_equal(js, ts)
    assert ts.pose.t.data_ptr() != ts.prev_pose.t.data_ptr()
    assert int(ts.surf_map.num_points()) > 100
    np.testing.assert_array_equal(tck.map_to_points(ts.surf_map),
                                  jck.map_to_points(js.surf_map))


def test_relocalize_lio_state_matches_reference():
    pts = _cloud(900, 5)
    (_, js), seeds = _reference_relocalized()
    q, t = seeds["lio"]
    ts = tck.relocalize_lio_state(TLIO, pts, tse3.Pose(torch.tensor(q), torch.tensor(t)),
                                  device="cpu")
    _leaves_equal(js, ts)


def test_map_bundle_pcd(tmp_path):
    ts = tck.relocalize_state(TCFG, _cloud(200, 6), _cloud(400, 7), device="cpu")
    tck.save_map_bundle(str(tmp_path), ts, trajectory=np.zeros((3, 3)))
    g = tck.read_pcd(str(tmp_path / "GlobalMap.pcd"))
    assert g.shape[0] == int(ts.corner_map.num_points()) + int(ts.surf_map.num_points())
    assert open(tmp_path / "SurfMap.pcd").read() == _ref_pcd(tmp_path, tck.map_to_points(
        ts.surf_map))


def _ref_pcd(tmp_path, pts):
    jck.export_pcd(str(tmp_path / "ref.pcd"), pts)
    return open(tmp_path / "ref.pcd").read()


def _imu_windows(seed=0, m=20):
    rng = np.random.default_rng(seed)
    out = []
    for k in range(3):
        gy = rng.normal(0, 0.05, (m, 3)).astype(np.float32) + [0, 0, 0.3]
        ac = rng.normal(0, 0.2, (m, 3)).astype(np.float32) + [0.5, 0.2, 9.81]
        dt = np.full((m,), 0.005, np.float32)
        mask = np.ones((m,), bool)
        mask[-2:] = k == 0  # padded tail on the later windows
        out.append((gy.astype(np.float32), ac.astype(np.float32), dt, mask))
    return out


def test_navsat_filter_matches_reference():
    """3 IMU windows with fixes after the first and the third: p, v within
    1e-5, P within rtol 1e-4 (atol 1e-9 for its near-zero cross terms)."""
    fixes = {0: (np.asarray([0.2, 0.1, 0.0], np.float32), np.asarray([1.0, 1.0, 4.0], np.float32)),
             2: (np.asarray([0.3, 0.2, 0.05], np.float32), None)}
    jf, tf = jnav.NavsatFilter(), tnav.NavsatFilter(device="cpu")
    for k, (gy, ac, dt, mask) in enumerate(_imu_windows()):
        fix, cov = fixes.get(k, (None, None))
        jp, jc = jf.step(gy, ac, dt, mask, fix=fix, fix_cov=cov)
        tp, tc = tf.step(gy, ac, dt, mask, fix=fix, fix_cov=cov)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=1e-5)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-4, atol=1e-9)
        np.testing.assert_allclose(tf.state.v.numpy(), np.asarray(jf.state.v), rtol=0, atol=1e-5)
        np.testing.assert_allclose(tf.state.q.numpy(), np.asarray(jf.state.q), rtol=0, atol=1e-5)
        np.testing.assert_allclose(tf.state.P.numpy(), np.asarray(jf.state.P), rtol=1e-4,
                                   atol=1e-9)


def test_preintegrate_scan_and_bias_corrected_match_reference():
    """The step-by-step oracle against the reference's and against the
    port's batched preintegrate: within 1e-5 (covariance within rtol 1e-4,
    atol 1e-9); bias correction within 1e-5."""
    gy, ac, dt, mask = _imu_windows(seed=3)[1]
    bg, ba = np.asarray([0.01, -0.02, 0.005], np.float32), np.asarray([0.05, 0.0, -0.1], np.float32)
    jp = j_preint_scan(gy, ac, dt, mask, bg, ba)
    T = [torch.from_numpy(a) for a in (gy, ac, dt, mask, bg, ba)]
    tp = tpre.preintegrate_scan(*T)
    batched = tpre.preintegrate(*T)
    for f in tpre.Preintegrated._fields:
        a, b = getattr(tp, f).numpy(), np.asarray(getattr(jp, f))
        if f == "cov":
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-9)
            np.testing.assert_allclose(a, getattr(batched, f).numpy(), rtol=1e-4, atol=1e-9)
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5, err_msg=f)
            np.testing.assert_allclose(a, getattr(batched, f).numpy(), rtol=0, atol=1e-5,
                                       err_msg=f)
    bg2, ba2 = bg + [0.003, 0.001, -0.002], ba + [0.02, -0.01, 0.0]
    jc = j_bias_corrected(jp, bg2.astype(np.float32), ba2.astype(np.float32))
    tc = tpre.bias_corrected(tp, torch.from_numpy(bg2.astype(np.float32)),
                             torch.from_numpy(ba2.astype(np.float32)))
    for a, b in zip(tc, jc):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-5)


def _carried(jw):
    return convert.world_from_numpy(np.asarray(jw.lo), np.asarray(jw.hi), device="cpu",
                                    vel=None if jw.vel is None else np.asarray(jw.vel))


_WORLDS = {
    "city": lambda: jworld.city_world(seed=0),
    "corridor": lambda: jworld.corridor_world(length=40.0, n_alcoves=2),
    "movers": lambda: jworld.with_movers(jworld.default_world(seed=1), n=3),
}


@pytest.mark.parametrize("name", sorted(_WORLDS))
def test_world_scans_match_reference(name):
    """The reference's world carried over, noise-free, a moving sensor (and
    moving boxes at t0 = 0.35 s): masks differ in at most 0.1% of the rays,
    points within 1e-4 m."""
    jw = _WORLDS[name]()
    tw = _carried(jw)
    q0, q1 = (np.asarray(jso3.quat_exp(jnp.asarray([0.0, 0.0, a]))) for a in (0.1, 0.13))
    start = {"city": [-13.0, -13.0, 0.0], "corridor": [2.0, 0.0, 0.0],
             "movers": [0.0, 0.0, 0.0]}[name]
    t0 = np.asarray(start, np.float32)
    t1 = t0 + np.asarray([0.35, 0.02, 0.0], np.float32)
    js = j_simulate(jw, jse3.Pose(q0, t0), jse3.Pose(q1, t1), rings=8, width=256, t0=0.35)
    ts = tworld.simulate_scan(tw, tse3.Pose(torch.tensor(q0), torch.tensor(t0)),
                              tse3.Pose(torch.tensor(q1), torch.tensor(t1)), rings=8, width=256,
                              t0=0.35)
    jm, tm = np.asarray(js.mask), ts.mask.numpy()
    assert jm.mean() > 0.4
    assert (jm != tm).mean() <= 1e-3
    both = jm & tm
    np.testing.assert_allclose(ts.xyz.numpy()[both], np.asarray(js.xyz)[both], rtol=0, atol=1e-4)


def test_flatten_grid_matches_reference():
    from agi_lidar_slam_torch.pointcloud import cloud as tcloud
    from agi_lidar_slam_tpu.pointcloud import cloud as jcloud

    rng = np.random.default_rng(8)
    xyz = rng.normal(0, 5, (4, 6, 3)).astype(np.float32)
    mask = rng.random((4, 6)) < 0.7
    time = np.broadcast_to(np.arange(6, dtype=np.float32) / 6, (4, 6)).copy()
    tb = tcloud.flatten_grid(tcloud.ScanGrid(*map(torch.from_numpy, (xyz, mask, time))))
    jb = jcloud.flatten_grid(jcloud.ScanGrid(xyz, mask, time))
    np.testing.assert_array_equal(tb.xyz.numpy(), np.asarray(jb.xyz))
    np.testing.assert_array_equal(tb.mask.numpy(), np.asarray(jb.mask))


def test_port_worlds_layout():
    """The port's own worlds: the corridor's boxes are the reference's
    exactly (no draws without alcoves), the city and alcove worlds have the
    reference's box counts and fixed boxes (their draws come from a torch
    Generator), movers are car-sized boxes at -speed with static boxes at
    rest."""
    tc = tworld.corridor_world(length=40.0, device="cpu")
    jc = jworld.corridor_world(length=40.0)
    np.testing.assert_array_equal(tc.lo.numpy(), np.asarray(jc.lo))
    np.testing.assert_array_equal(tc.hi.numpy(), np.asarray(jc.hi))
    ta = tworld.corridor_world(length=40.0, n_alcoves=3, device="cpu")
    assert ta.lo.shape == (8, 3) and torch.equal(ta.lo[:5], tc.lo)
    tcity, jcity = tworld.city_world(seed=0, device="cpu"), jworld.city_world(seed=0)
    assert tcity.lo.shape == np.asarray(jcity.lo).shape
    np.testing.assert_array_equal(tcity.lo[0].numpy(), np.asarray(jcity.lo)[0])
    assert bool((tcity.hi[1:, 2] >= 4.0).all() and (tcity.hi[1:, 2] <= 14.0).all())
    base = tworld.default_world(seed=1, device="cpu")
    mv = tworld.with_movers(base, n=3, speed=2.5)
    assert mv.lo.shape[0] == base.lo.shape[0] + 3 and mv.vel is not None
    assert bool((mv.vel[:-3] == 0).all())
    np.testing.assert_array_equal(mv.vel[-3:].numpy(), np.tile([[-2.5, 0.0, 0.0]], (3, 1)))
    np.testing.assert_allclose((mv.hi - mv.lo)[-3:].numpy(), np.tile([[4.2, 1.8, 1.5]], (3, 1)),
                               atol=1e-5)


def test_trajectories_match_reference():
    """square_loop_pose over all four legs and corners, square_loop_imu and
    straight_imu: within 1e-5."""
    s = np.linspace(0.0, 100.0, 97).astype(np.float32)
    jp, tp = j_square_pose(s, 18.0, 4.0), ttraj.square_loop_pose(s, 18.0, 4.0, device="cpu")
    np.testing.assert_allclose(tp.t.numpy(), np.asarray(jp.t), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tp.q.numpy(), np.asarray(jp.q), rtol=0, atol=1e-5)
    t = s / 3.5
    for a, b in zip(ttraj.square_loop_imu(t, 18.0, 4.0, 3.5, device="cpu"),
                    j_square_imu(t, 18.0, 4.0, 3.5)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-5)
    for a, b in zip(ttraj.straight_imu(t, 3.5, device="cpu"), j_straight_imu(t, 3.5)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-5)


def _banks(seed=0):
    """Two JAX keyframe banks (capacity 8, 5 and 6 live keyframes of 32
    corner / 64 surf points), filled with random data, and the port's."""
    rng = np.random.default_rng(seed)
    jb, tb = [], []
    for n, y in ((5, 0.0), (6, 1.0)):
        b = jkf.empty_bank(8, 32, 64)
        yaw = rng.uniform(-0.3, 0.3, 8)
        q = np.stack([np.cos(yaw / 2), 0 * yaw, 0 * yaw, np.sin(yaw / 2)], 1).astype(np.float32)
        t = np.stack([np.arange(8) * 1.5, np.full(8, y), np.zeros(8)], 1).astype(np.float32)
        b = b._replace(q=jnp.asarray(q), t=jnp.asarray(t),
                       stamp=jnp.arange(8, dtype=jnp.int32),
                       corner_xyz=jnp.asarray(rng.uniform(-6, 6, (8, 32, 3)).astype(np.float32)),
                       corner_mask=jnp.asarray(rng.random((8, 32)) < 0.8),
                       surf_xyz=jnp.asarray(rng.uniform(-6, 6, (8, 64, 3)).astype(np.float32)),
                       surf_mask=jnp.asarray(rng.random((8, 64)) < 0.8),
                       count=jnp.int32(n))
        jb.append(b)
        tb.append(tkf.KeyframeBank(*(torch.from_numpy(np.array(a)) for a in b)))
    return jb, tb


def test_multisession_merge_matches_reference():
    """merge_banks, odometry_edges, cross_session_candidates and the merged
    map of a 16-keyframe merged bank: exact; the merged map built slot-sharded
    on a one-rank gloo mesh is the same map (the 2-rank map is in
    tests/test_torch_parallel.py)."""
    jb, tb = _banks()
    (jm, jsid), (tm, tsid) = jms.merge_banks(jb, capacity=16), tms.merge_banks(tb, capacity=16)
    np.testing.assert_array_equal(tsid, jsid)
    _leaves_equal(jm, tm)
    je, te = jms.odometry_edges(jb, capacity=32), tms.odometry_edges(tb, capacity=32)
    _leaves_equal(je, te)
    assert int(te.count) == 9
    assert (tms.cross_session_candidates(tm, tsid, 2.0)
            == jms.cross_session_candidates(jm, jsid, 2.0))
    mcfg = MapConfig(sub_voxel=0.4, block_sub=2, log2_slots=10)
    jmap, tmap = j_merged_map(jm, mcfg), tms.build_merged_map(tm, port_cfg(mcfg))
    np.testing.assert_array_equal(tmap.keys.numpy(), np.asarray(jmap.keys))
    np.testing.assert_array_equal(tmap.occ.numpy(), np.asarray(jmap.occ))
    assert int(tmap.num_points()) > 300
    import torch.distributed as dist

    from agi_lidar_slam_torch.parallel.distributed import make_mesh_2d

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        smap = tms.build_merged_map(tm, port_cfg(mcfg), mesh=make_mesh_2d(device="cpu"))
    finally:
        dist.destroy_process_group()
    assert all(torch.equal(a, b) for a, b in zip(smap, tmap))


def test_multisession_merge_sessions_runs():
    """Port only: the full merge (candidates, alignments, joint pose-graph
    solve) on two small random sessions keeps every keyframe and stays
    finite; session 0's first keyframe is the anchor."""
    from agi_lidar_slam_torch.graph.loop_closure import LoopConfig

    _, tb = _banks(seed=1)
    loop = LoopConfig(submap_half=2, map_cfg=port_cfg(MapConfig(
        sub_voxel=0.4, block_sub=4, log2_slots=10, neighborhood="full27")))
    bank, sid, n_acc = tms.merge_sessions(tb, loop_cfg=loop, pair_radius=2.0, max_pairs=2,
                                          n_gn_iters=2)
    assert int(bank.count) == 11 and list(sid[:11]) == [0] * 5 + [1] * 6
    assert 0 <= n_acc <= 2
    assert bool(torch.isfinite(bank.t).all() and torch.isfinite(bank.q).all())
    np.testing.assert_allclose(bank.t[0].numpy(), tb[0].t[0].numpy(), atol=1e-3)


def _results():
    """A ScanResult and a LioResult of the port on the CPU."""
    from agi_lidar_slam_torch.estimators.gn_scan2map import GnStats
    from agi_lidar_slam_torch.imu.eskf import NavState
    from agi_lidar_slam_torch.pointcloud.cloud import PointBatch

    pose = tse3.Pose(torch.tensor([0.9, 0.1, -0.2, 0.37]), torch.tensor([1.23456, -2.5, 0.01]))
    stats = GnStats(torch.tensor(57, dtype=torch.int32), torch.tensor(1203, dtype=torch.int32),
                    torch.tensor(0.0412345), torch.tensor(False))
    pb = PointBatch(torch.zeros((2, 3)), torch.zeros(2, dtype=torch.bool))
    scan = tpipe.ScanResult(pose, stats, pb, pb, torch.tensor(3, dtype=torch.int32))
    x = NavState.identity("cpu")._replace(p=torch.tensor([0.5, 0.25, -1.0]))
    lio = tlio.LioResult(x, torch.tensor(812, dtype=torch.int32), torch.tensor(0.0123),
                         torch.tensor(0, dtype=torch.int32))
    return {"scan": scan, "lio": lio}


@pytest.mark.parametrize("kind", ["scan", "lio"])
def test_metrics_records_match_reference(tmp_path, kind):
    """The JSONL record of one result: the reference's MetricsWriter (which
    reads each field by int()/float()) and the port's (one host read) write
    the same keys and values; StageTimer's summary has the same shape."""
    res = _results()[kind]
    tw, jw = tmet.MetricsWriter(str(tmp_path / "t.jsonl")), jmet.MetricsWriter(
        str(tmp_path / "j.jsonl"))
    tw.log_scan(4, res, 12.3456, extra={"k": 1})
    jw.log_scan(4, res, 12.3456, extra={"k": 1})
    tw.close()
    jw.close()
    t_rec = json.loads(open(tmp_path / "t.jsonl").read())
    assert t_rec == json.loads(open(tmp_path / "j.jsonl").read())
    assert ("t" in t_rec) == (kind == "scan")
    s = tmet.scan_scalars(res)
    assert len(s["q"]) == 4 and len(s["t"]) == 3
    timer = tmet.StageTimer("cpu")
    with timer.stage("scan"):
        pass
    assert timer.summary()["scan"].keys() == {"total_s", "mean_ms", "count"}
