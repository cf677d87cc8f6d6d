"""The port's main path against the reference's, end to end on the CPU.

* Slice parity: a small octant8 variant of preset_aloam_kitti64 (16x900
  scans, 512/2048 feature slots, 2^10/2^11 map slots, the preset's voxel and
  block sizes) over 5 scans of the reference simulator, both engines started
  from one state. Target: 1e-3 m and 1e-3 per quaternion component, equal
  correspondence counts. Measured on the CPU: at most 4.8e-7 m and 8.8e-8
  (f32 reductions in another order; the correspondence counts are equal).
* One step from a JAX state carried over mid-sequence (convert.py).
* The port never imports jax, and shares only the reference's config and
  eval.metrics modules.
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

from agi_lidar_slam_torch.convert import state_from_numpy, state_to_numpy
from agi_lidar_slam_torch.pointcloud.cloud import ScanGrid as TScanGrid
from agi_lidar_slam_torch.runtime import pipeline as tpipe
from agi_lidar_slam_tpu.config import preset_aloam_kitti64
from agi_lidar_slam_tpu.geometry import se3 as jse3
from agi_lidar_slam_tpu.geometry import so3 as jso3
from agi_lidar_slam_tpu.runtime import pipeline as jpipe
from agi_lidar_slam_tpu.sim.world import default_world, simulate_scan

_BASE = preset_aloam_kitti64()
CFG = dataclasses.replace(
    _BASE,
    features=dataclasses.replace(_BASE.features, max_corners=512, max_surfs=2048),
    corner_map=dataclasses.replace(_BASE.corner_map, log2_slots=10),
    surf_map=dataclasses.replace(_BASE.surf_map, log2_slots=11),
)
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
    scans, states, results = _reference_run()
    state = state_from_numpy(states[0])
    for s, jres in zip(scans, results):
        state, tres = tpipe.process_scan(state, _tscan(s), CFG)
        _check_step(jres, tres)
    assert int(results[-1].stats.n_surf) > 100  # the engine tracks: real correspondences
    assert int(state.frame) == N_SCANS


def test_one_step_from_carried_over_state():
    scans, states, results = _reference_run()
    carried = state_from_numpy(states[3])
    # the carried map is the reference's, bit for bit, and converts back
    back = state_to_numpy(carried)
    np.testing.assert_array_equal(back["surf_map"]["keys"], states[3].surf_map.keys)
    np.testing.assert_array_equal(back["corner_map"]["points"], states[3].corner_map.points)
    kept = [t.clone() for t in carried.surf_map]
    state, tres = tpipe.process_scan(carried, _tscan(scans[3]), CFG)
    _check_step(results[3], tres)
    # the step did not modify the state it was given
    assert all(torch.equal(a, b) for a, b in zip(kept, carried.surf_map))
    assert int(state.surf_map.num_points()) > int(carried.surf_map.num_points())


def test_unported_pipeline_branches_raise():
    state = tpipe.init_state(CFG)
    scan = TScanGrid(torch.zeros((4, 60, 3)), torch.zeros((4, 60), dtype=torch.bool),
                     torch.zeros((4, 60)))
    for field in ("odometry_stage", "two_step"):
        with pytest.raises(NotImplementedError, match=field):
            tpipe.process_scan(state, scan, dataclasses.replace(CFG, **{field: True}))


def test_port_never_imports_jax():
    """In a fresh interpreter where `import jax` fails, the port imports and
    runs one CPU scan (octant8 maps, so the kernel module too), loading no
    JAX-package module beyond the shared config and eval.metrics."""
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None  # any `import jax` now raises ImportError
        import torch
        from agi_lidar_slam_torch import preset_aloam_kitti64
        from agi_lidar_slam_torch.geometry import se3
        from agi_lidar_slam_torch.runtime.pipeline import init_state, process_scan
        from agi_lidar_slam_torch.sim.world import default_world, simulate_scan
        from agi_lidar_slam_tpu.eval.metrics import ate_rmse
        cfg = preset_aloam_kitti64()
        world = default_world(seed=1, device="cpu")
        p = se3.Pose.identity()
        state, res = process_scan(init_state(cfg, "cpu"),
                                  simulate_scan(world, p, p, rings=16, width=900), cfg)
        assert bool(torch.isfinite(res.pose.t).all())
        loaded = sorted(m for m in sys.modules if m.startswith("agi_lidar_slam_tpu"))
        print(",".join(loaded))
    """)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    loaded = set(out.stdout.strip().splitlines()[-1].split(","))
    assert loaded <= {"agi_lidar_slam_tpu", "agi_lidar_slam_tpu.config",
                      "agi_lidar_slam_tpu.eval", "agi_lidar_slam_tpu.eval.metrics"}, loaded
