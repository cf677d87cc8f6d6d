"""The port's main path against the reference's, end to end on the CPU.

* Slice parity: a small octant8 variant of preset_aloam_kitti64 (16x900
  scans, 512/2048 feature slots, 2^10/2^11 map slots, the preset's voxel and
  block sizes) over 5 scans of the reference simulator, both engines started
  from one state. Target: 1e-3 m and 1e-3 per quaternion component, equal
  correspondence counts. Measured on the CPU: at most 4.8e-7 m and 8.8e-8
  (f32 reductions in another order; the correspondence counts are equal).
* One step from a JAX state carried over mid-sequence (convert.py).
* process_scan_chunk: the 5 scans as one chunk against the reference's
  poses at the same tolerances (its own tests/test_gn_e2e.py holds its chunk
  to its sequential run), and as chunks of 2 and 3, the state carried
  across, against the port's sequential results bit for bit.
* deskew_constant_velocity against the reference's on one small grid.
* The port never imports jax or anything of the JAX package.
"""

import dataclasses
import functools
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agi_lidar_slam_torch.convert import config_from_reference, state_from_numpy, state_to_numpy
from agi_lidar_slam_torch.estimators.gn_scan2map import solve_scan2map
from agi_lidar_slam_torch.estimators.two_step import solve_scan2map_two_step
from agi_lidar_slam_torch.pointcloud.cloud import PointBatch
from agi_lidar_slam_torch.pointcloud.cloud import ScanGrid as TScanGrid
from agi_lidar_slam_torch.runtime import pipeline as tpipe
from agi_lidar_slam_tpu.config import preset_aloam_kitti64
from agi_lidar_slam_tpu.geometry import se3 as jse3
from agi_lidar_slam_tpu.geometry import so3 as jso3
from agi_lidar_slam_tpu.runtime import pipeline as jpipe
from agi_lidar_slam_tpu.sim.world import default_world, simulate_scan
from tests._torch_threads import torch_one_thread  # noqa: F401 (autouse)

_BASE = preset_aloam_kitti64()
CFG = dataclasses.replace(
    _BASE,
    features=dataclasses.replace(_BASE.features, max_corners=512, max_surfs=2048),
    corner_map=dataclasses.replace(_BASE.corner_map, log2_slots=10),
    surf_map=dataclasses.replace(_BASE.surf_map, log2_slots=11),
)
T_CFG = config_from_reference(CFG)  # the port's own PipelineConfig, same fields
N_SCANS = 5
T_TOL, Q_TOL = 1e-3, 1e-3


def _np_tree(x):
    return jax.tree.map(np.asarray, x)


@jax.jit
def _reference_setup():
    """The world, the arc's poses at each sweep start and the engine's initial
    state, in one compile (the suite serializes compiles across workers)."""
    world = default_world(seed=0, n_pillars=48, extent=35.0)
    step = jse3.Pose(jso3.quat_exp(jnp.asarray([0.0, 0.0, 0.01])), jnp.asarray([1.0, 0.0, 0.0]))
    poses = [jse3.Pose.identity()]
    for _ in range(N_SCANS):
        poses.append(jse3.compose(poses[-1], step))
    state = jpipe.init_state(CFG)
    back = jse3.inverse(step)
    p1 = jse3.compose(state.pose, back)
    return world, poses, state._replace(pose=p1, prev_pose=jse3.compose(p1, back))


@functools.lru_cache(maxsize=1)
def _reference_run():
    """Scans along a 1 m / 0.01 rad-per-scan arc and the reference engine's
    states and results over them, as numpy. The engine starts with the arc's
    velocity as its constant-velocity prior (from rest this preset does not
    recover a 1 m first step, in either implementation)."""
    world, poses, state = _reference_setup()
    sim = jax.jit(simulate_scan, static_argnames=("rings", "width", "fov_up_deg",
                                                  "fov_down_deg", "noise_std"))
    scans = [_np_tree(sim(world, poses[i], poses[i + 1], rings=16, width=900,
                          fov_up_deg=2.0, fov_down_deg=-24.8, noise_std=0.01, seed=i))
             for i in range(N_SCANS)]
    states, results = [_np_tree(state)], []
    for s in scans:
        state, res = jpipe.process_scan(state, jpipe.ScanGrid(*map(jnp.asarray, s)), CFG)
        states.append(_np_tree(state))
        results.append(_np_tree(res))
    return scans, states, results


def _tscan(s):
    return TScanGrid(*(torch.from_numpy(np.array(a)) for a in s))


def _check_step(jres, tres):
    np.testing.assert_allclose(tres.pose.t.numpy(), jres.pose.t, rtol=0, atol=T_TOL)
    np.testing.assert_allclose(tres.pose.q.numpy(), jres.pose.q, rtol=0, atol=Q_TOL)
    assert int(tres.stats.n_corner) == int(jres.stats.n_corner)
    assert int(tres.stats.n_surf) == int(jres.stats.n_surf)
    assert int(tres.n_dropped) == int(jres.n_dropped)


def test_slice_parity_5_scans():
    _, _, results = _reference_run()
    states, port_results = _port_run()
    for jres, tres in zip(results, port_results):
        _check_step(jres, tres)
    assert int(results[-1].stats.n_surf) > 100  # the engine tracks: real correspondences
    assert int(states[-1].frame) == N_SCANS


@functools.lru_cache(maxsize=1)
def _port_run():
    """The port's sequential run over the reference's scans from its first
    state: (states, results)."""
    scans, states, _ = _reference_run()
    state = state_from_numpy(states[0], "cpu")
    out_states, out_results = [state], []
    for s in scans:
        state, res = tpipe.process_scan(state, _tscan(s), T_CFG)
        out_states.append(state)
        out_results.append(res)
    return out_states, out_results


def _chunk(scans):
    return TScanGrid(*(torch.stack([torch.from_numpy(np.array(a)) for a in f])
                       for f in zip(*scans)))


def _at(tree, i):
    return jax.tree.map(lambda x: x[i], tree)


def test_chunk_matches_reference():
    """The 5 scans as one chunk: every step's pose within T_TOL / Q_TOL of
    the reference's sequential run, equal correspondence and drop counts."""
    scans, states, results = _reference_run()
    state, res = tpipe.process_scan_chunk(state_from_numpy(states[0], "cpu"), _chunk(scans),
                                          T_CFG)
    assert res.pose.t.shape == (N_SCANS, 3) and res.corners.xyz.shape[0] == N_SCANS
    for i, jres in enumerate(results):
        _check_step(jres, _at(res, i))
    assert int(state.frame) == N_SCANS


def test_chunks_carry_state():
    """Chunks of 2 and 3 scans, the first chunk's state handed to the
    second: every field of every result and of the final state equals the
    port's sequential process_scan run, bit for bit."""
    scans, states, _ = _reference_run()
    seq_states, seq_results = _port_run()
    state, first = tpipe.process_scan_chunk(state_from_numpy(states[0], "cpu"),
                                            _chunk(scans[:2]), T_CFG)
    state, second = tpipe.process_scan_chunk(state, _chunk(scans[2:]), T_CFG)
    got = [_at(first, i) for i in range(2)] + [_at(second, i) for i in range(3)]
    for a, b in zip(got, seq_results):
        assert all(torch.equal(x, y) for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)))
    assert all(torch.equal(x, y) for x, y in zip(jax.tree.leaves(state),
                                                  jax.tree.leaves(seq_states[-1])))


def test_deskew_constant_velocity():
    """The whole-grid deskew against the reference's (eager JAX) on a 4x64
    grid with times in [0, 1): 1e-6 m (f32 rotation of points within 20 m)."""
    rng = np.random.default_rng(3)
    xyz = rng.uniform(-20, 20, (4, 64, 3)).astype(np.float32)
    mask = rng.uniform(size=(4, 64)) > 0.2
    tm = np.broadcast_to(np.linspace(0, 1, 64, endpoint=False, dtype=np.float32), (4, 64))
    q = np.array([0.995, 0.02, -0.01, 0.098], np.float32)
    q /= np.linalg.norm(q)
    t = np.array([0.9, -0.1, 0.05], np.float32)
    jout = jpipe.deskew_constant_velocity(jpipe.ScanGrid(*map(jnp.asarray, (xyz, mask, tm))),
                                          jse3.Pose(jnp.asarray(q), jnp.asarray(t)))
    tout = tpipe.deskew_constant_velocity(_tscan((xyz, mask, tm)),
                                          tpipe.se3.Pose(torch.from_numpy(q), torch.from_numpy(t)))
    np.testing.assert_allclose(tout.xyz.numpy(), np.asarray(jout.xyz), rtol=0, atol=1e-6)
    assert torch.equal(tout.mask, torch.from_numpy(mask))
    assert float(np.abs(np.asarray(jout.xyz) - xyz).max()) > 0.5  # it moved the points


def test_one_step_from_carried_over_state():
    scans, states, results = _reference_run()
    carried = state_from_numpy(states[3], "cpu")
    # the carried map is the reference's, bit for bit, and converts back
    back = state_to_numpy(carried)
    np.testing.assert_array_equal(back["surf_map"]["keys"], states[3].surf_map.keys)
    np.testing.assert_array_equal(back["corner_map"]["points"], states[3].corner_map.points)
    kept = [t.clone() for t in carried.surf_map]
    state, tres = tpipe.process_scan(carried, _tscan(scans[3]), T_CFG)
    _check_step(results[3], tres)
    # the step did not modify the state it was given
    assert all(torch.equal(a, b) for a, b in zip(kept, carried.surf_map))
    assert int(state.surf_map.num_points()) > int(carried.surf_map.num_points())


def test_pipeline_hooks_match_plain_call():
    """The multi-device hooks of the scan step and both scan-to-map solvers:
    group=None runs the plain code, a knn_fn that wraps nn.knn.knn gives its
    result, and _process_scan_body with its solver, insert and bound
    operations wrapped gives process_scan's result: each bit for bit, on
    the slice's scans (the odometry stage and the two-step solver have their
    parity in tests/test_torch_presets.py and tests/test_torch_lego.py)."""
    from agi_lidar_slam_torch.map.hash_map import bound_map, insert_with_stats
    from agi_lidar_slam_torch.nn.knn import knn

    scans, states, results = _reference_run()
    state = state_from_numpy(states[2], "cpu")
    res = results[1]
    def t(tree):
        return [torch.from_numpy(np.array(a)) for a in tree]

    feats = PointBatch(*t(res.corners)), PointBatch(*t(res.surfs))
    args = (tpipe.se3.Pose(*t(res.pose)), *feats, state.corner_map,
            state.surf_map, T_CFG.corner_map, T_CFG.surf_map, T_CFG.solver)
    calls = []

    def wrap(fn):
        def inner(*a, **kw):
            calls.append(fn.__name__)
            return fn(*a, **kw)
        inner.__name__ = fn.__name__
        return inner

    def same(x, y):
        xs, ys = jax.tree.leaves(x), jax.tree.leaves(y)
        return len(xs) == len(ys) and all(torch.equal(a, b) for a, b in zip(xs, ys))

    for solve in (solve_scan2map, solve_scan2map_two_step):
        plain = solve(*args)
        assert same(solve(*args, group=None), plain)
        assert same(solve(*args, knn_fn=wrap(knn)), plain) and calls.count("knn") >= 2
    assert int(plain[1].n_surf) > 100  # a real solve on a built map

    calls.clear()
    step, res_plain = tpipe.process_scan(state, _tscan(scans[2]), T_CFG)
    hooked = tpipe._process_scan_body(
        state, _tscan(scans[2]), T_CFG, solve_fn=wrap(solve_scan2map),
        solve_two_fn=wrap(solve_scan2map_two_step), insert_fn=wrap(insert_with_stats),
        bound_fn=wrap(bound_map))
    assert same(hooked, (step, res_plain))
    assert sorted(calls) == ["bound_map"] * 2 + ["insert_with_stats"] * 2 + ["solve_scan2map"]


def test_port_never_imports_jax():
    """In a fresh interpreter where `jax` and the JAX package cannot be
    imported, every module of the port (parallel/*, estimators/sym_eig and
    tools/visualize included) and chip_smoke.py import, and one CPU scan of
    each engine (odometry with octant8 maps, so the kernel module too, the
    same scan as a chunk of one (process_scan_chunk) and through the
    point-sharded step on a one-rank gloo group, LIO, and the slam and
    LIO-SAM drivers, no closure) runs, two of the
    A-LOAM and LeGO reference presets (the odometry stage, segmentation and
    the two-step solve), three of the livox driver (through its engagement
    and one window scan) and two simulator sweeps through the runner
    (tools/run_slam.main), loading no module of either."""
    code = textwrap.dedent("""
        import dataclasses, importlib, pkgutil, sys
        sys.modules["jax"] = None  # any `import jax...` now raises ImportError
        sys.modules["agi_lidar_slam_tpu"] = None
        import torch
        torch.set_num_threads(1)  # beside the suite's other workers (tests/_torch_threads.py)
        import agi_lidar_slam_torch as pkg
        for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
            importlib.import_module(m.name)
        import chip_smoke
        from agi_lidar_slam_torch import preset_aloam_kitti64
        from agi_lidar_slam_torch.geometry import se3
        from agi_lidar_slam_torch.runtime import lio_pipeline as lio
        from agi_lidar_slam_torch.runtime.pipeline import init_state, process_scan
        from agi_lidar_slam_torch.sim.trajectory import circle_imu, circle_pose
        from agi_lidar_slam_torch.sim.world import default_world, simulate_scan
        cfg = preset_aloam_kitti64()
        world = default_world(seed=1, device="cpu")
        p = se3.Pose.identity(device="cpu")
        scan0 = simulate_scan(world, p, p, rings=16, width=900)
        state, res = process_scan(init_state(cfg, "cpu"), scan0, cfg)
        assert bool(torch.isfinite(res.pose.t).all())
        from agi_lidar_slam_torch.pointcloud.cloud import ScanGrid
        from agi_lidar_slam_torch.runtime.pipeline import (deskew_constant_velocity,
                                                           process_scan_chunk)
        _, cres = process_scan_chunk(init_state(cfg, "cpu"),
                                     ScanGrid(*(a[None] for a in scan0)), cfg)
        assert torch.equal(cres.pose.t[0], res.pose.t)
        assert deskew_constant_velocity(scan0, res.pose).xyz.shape == scan0.xyz.shape
        import torch.distributed as dist
        from agi_lidar_slam_torch.parallel import distributed as pdist, sharding
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
        _, dres = sharding.sharded_scan_step(sharding.make_mesh(device="cpu"),
                                             init_state(cfg, "cpu"),
                                             simulate_scan(world, p, p, rings=16, width=900), cfg)
        dist.destroy_process_group()
        assert torch.equal(dres.pose.t, res.pose.t) and pdist.collectives > 0
        from agi_lidar_slam_torch.presets import preset_aloam_kitti64_ref, preset_lego_vlp16_ref
        for ref_cfg in (preset_aloam_kitti64_ref(), preset_lego_vlp16_ref()):
            rstate = init_state(ref_cfg, "cpu")
            for _ in range(2):  # the odometry stage has input on the second scan
                rstate, rres = process_scan(rstate, simulate_scan(world, p, p, rings=16,
                                                                  width=900), ref_cfg)
            assert bool(torch.isfinite(rres.pose.t).all())
        lcfg = lio.LioConfig()
        p1 = circle_pose(0.1, 8.0, 0.25, device="cpu")
        scan = simulate_scan(world, p, p1, rings=16, width=900)
        gy, ac = circle_imu(torch.arange(20) * 0.005, 8.0, 0.25)
        win = lio.ImuWindow(gy, ac, torch.full((20,), 0.005), torch.ones(20, dtype=torch.bool))
        lstate, lres = lio.process_lio_scan(lio.init_lio_state(lcfg, device="cpu"),
                                            scan.xyz.reshape(-1, 3),
                                            (scan.time * 0.1).reshape(-1),
                                            scan.mask.reshape(-1), win, lcfg)
        assert bool(torch.isfinite(lres.x.p).all()) and int(lstate.frame) == 1
        from agi_lidar_slam_torch.runtime import liosam_pipeline as ls, slam_pipeline as sp
        small = dataclasses.replace(cfg, features=dataclasses.replace(
            cfg.features, max_corners=512, max_surfs=2048))
        scfg = sp.SlamConfig(pipeline=small, bank_capacity=8, edge_capacity=16)
        sdrv = sp.SlamDriver(scfg, device="cpu")
        sres = sdrv.process(simulate_scan(world, p, p, rings=16, width=900))
        assert bool(torch.isfinite(sres.pose.t).all()) and int(sdrv.state.bank.count) == 1
        drv = ls.LioSamDriver(ls.LioSamConfig(slam=scfg),
                              x0=circle_pose(0.0, 8.0, 0.25, device="cpu"), device="cpu")
        lsres = drv.process(scan, win)
        assert bool(torch.isfinite(lsres.pose.t).all()) and int(drv.bank.count) == 1
        from agi_lidar_slam_torch.runtime import livox_pipeline as lp
        ldrv = lp.LivoxDriver(lp.LivoxConfig(), init_frames=2, x0=p, device="cpu")
        for _ in range(3):  # LO, LO and the engagement, a window scan
            lxres = ldrv.process(scan, win)
        assert ldrv.engaged and bool(torch.isfinite(lxres.pose.t).all())
        from agi_lidar_slam_torch.tools import run_slam
        run = run_slam.run(["--sim", "--frames", "2", "--device", "cpu"])
        assert run["rc"] == 0 and run["est"].shape == (2, 3)
        print("loaded:" + ",".join(sorted(m for m in sys.modules
                              if m.startswith(("jax", "agi_lidar_slam_tpu"))
                              and sys.modules[m] is not None)))
    """)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "loaded:", out.stdout
