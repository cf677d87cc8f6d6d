"""Parity of the port's LeGO-LOAM branch with the reference on the CPU:
ground removal and cluster segmentation (features/segmentation.py), the
segmentation branch of the feature extraction, the two-step solver
(estimators/two_step.py), and a slice of `preset_lego_vlp16_ref` through
`runtime.pipeline.process_scan`.

Inputs: scans of the reference's simulator (16x720, VLP-16's +-15 deg, the
LeGO reference test's world and arc) and a sparse speckle scan made with
numpy (2% returns, uniform in a 40 m cube). Each reference program is
compiled once: one program holds the range, the ground mask, the
segmentation and the features of a scan; the engine step and the two-step
solve one each.

Tolerances, with the figure measured on the CPU beside each:
* the range image, `ground`, `segmented` and `labels`: equal (measured equal;
  the port's `torch.linalg.vector_norm` gives the reference's
  `jnp.linalg.norm` bit for bit on these scans);
* features with segmentation: masks equal, points within 3e-5 m and times
  within 1e-6, as tests/test_torch_voxel_features.py;
* the two-step solve on maps the reference built: pose within 1e-5 m and
  1e-5 per quaternion component (measured 2.1e-7), equal correspondence
  counts, equal degeneracy flags, and degenerate on an empty map;
* the slice: a shrunk preset_lego_vlp16_ref (512/2048 feature slots, maps of
  2^11/2^12 slots; the preset's voxel, block and solver settings), its first
  2 scans from rest and 4 more from the state the reference carried over
  after them: 1e-3 m and 1e-3 per quaternion component, equal
  correspondence counts and drops (measured 2.8e-6 m and 2.2e-7).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agi_lidar_slam_torch.convert import config_from_reference, state_from_numpy
from agi_lidar_slam_torch.estimators import two_step as tts
from agi_lidar_slam_torch.features import curvature as tcurv
from agi_lidar_slam_torch.features import segmentation as tseg
from agi_lidar_slam_torch.geometry.se3 import Pose as TPose
from agi_lidar_slam_torch.map.hash_map import HashVoxelMap as THashVoxelMap
from agi_lidar_slam_torch.pointcloud.cloud import PointBatch as TPointBatch
from agi_lidar_slam_torch.pointcloud.cloud import ScanGrid as TScanGrid
from agi_lidar_slam_torch.runtime import pipeline as tpipe
from agi_lidar_slam_tpu.estimators import two_step as jts
from agi_lidar_slam_tpu.features import curvature as jcurv
from agi_lidar_slam_tpu.features import segmentation as jseg
from agi_lidar_slam_tpu.geometry import se3 as jse3
from agi_lidar_slam_tpu.geometry import so3 as jso3
from agi_lidar_slam_tpu.map.hash_map import empty_map as jempty_map
from agi_lidar_slam_tpu.pointcloud.cloud import ScanGrid as JScanGrid
from agi_lidar_slam_tpu.presets import preset_lego_vlp16_ref
from agi_lidar_slam_tpu.runtime import pipeline as jpipe
from agi_lidar_slam_tpu.sim.world import default_world, simulate_scan

_BASE = preset_lego_vlp16_ref()
CFG = dataclasses.replace(
    _BASE,
    features=dataclasses.replace(_BASE.features, max_corners=512, max_surfs=2048),
    corner_map=dataclasses.replace(_BASE.corner_map, log2_slots=11),
    surf_map=dataclasses.replace(_BASE.surf_map, log2_slots=12),
)
T_CFG = config_from_reference(CFG)
RINGS, WIDTH = 16, 720
N_CARRY, N_SLICE = 2, 4  # reference scans before the carried state, slice scans
T_TOL, Q_TOL = 1e-3, 1e-3
SOLVE_TOL = 1e-5


def _np(tree):
    return jax.tree.map(np.array, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _tscan(s):
    return TScanGrid(*map(_t, s))


def _speckle():
    """Isolated random returns: no cluster reaches the size filter."""
    rng = np.random.default_rng(0)
    xyz = rng.uniform(-20, 20, (RINGS, WIDTH, 3)).astype(np.float32)
    mask = rng.uniform(size=(RINGS, WIDTH)) < 0.02
    return xyz, mask, np.zeros((RINGS, WIDTH), np.float32)


@jax.jit
def _reference_scan_program(scan):
    seg = jseg.segment_scan(scan)
    return (jnp.linalg.norm(scan.xyz, axis=-1), jseg.ground_removal(scan, jseg.SegmentationConfig()),
            seg, jcurv.extract_features_timed(scan, CFG.features))


@functools.lru_cache(maxsize=1)
def _reference():
    """The arc's scans (0.35 m and 0.03 rad a scan in default_world(seed=0,
    extent=18), the LeGO reference test's), the reference's scan program on
    the first scan and on the speckle scan, and its engine's states and
    results over the arc, as numpy."""
    world = default_world(seed=0, extent=18.0)
    q, t, poses = jso3.quat_identity(), jnp.zeros(3), []
    for _ in range(N_CARRY + N_SLICE + 1):
        poses.append(jse3.Pose(q, t))
        q = jso3.quat_normalize(jso3.quat_mul(q, jso3.quat_exp(jnp.asarray([0.0, 0.0, 0.03]))))
        t = t + jso3.quat_rotate(q, jnp.asarray([0.35, 0.0, 0.0]))
    sim = jax.jit(simulate_scan, static_argnames=("rings", "width", "noise_std"))
    scans = [_np(sim(world, poses[i], poses[i + 1], rings=RINGS, width=WIDTH, noise_std=0.005,
                     seed=i)) for i in range(N_CARRY + N_SLICE)]
    programs = {name: _np(_reference_scan_program(JScanGrid(*map(jnp.asarray, s))))
                for name, s in (("plain", scans[0]), ("speckle", _speckle()))}
    state = jpipe.init_state(CFG)
    states, results = [_np(state)], []
    for s in scans:
        state, res = jpipe.process_scan(state, JScanGrid(*map(jnp.asarray, s)), CFG)
        states.append(_np(state))
        results.append(_np(res))
    return dict(scans=scans, programs=programs, states=states, results=results)


@pytest.mark.parametrize("name", ["plain", "speckle"])
def test_ground_and_segment_scan(name):
    ref = _reference()
    s = ref["scans"][0] if name == "plain" else _speckle()
    r, ground, seg, _ = ref["programs"][name]
    ts = _tscan(s)
    np.testing.assert_array_equal(torch.linalg.vector_norm(ts.xyz, dim=-1).numpy(), r)
    np.testing.assert_array_equal(tseg.ground_removal(ts, tseg.SegmentationConfig()).numpy(),
                                  ground)
    out = tseg.segment_scan(ts)
    for f in tseg.SegmentedScan._fields:
        np.testing.assert_array_equal(getattr(out, f).numpy(), getattr(seg, f), err_msg=f)
    n_valid = int(s[1].sum())
    if name == "plain":
        assert ground.sum() > 500 and seg.segmented.sum() > 0.5 * (n_valid - ground.sum())
        assert len(np.unique(seg.labels[seg.segmented])) > 5
    else:  # the reference test's criterion: speckle forms no valid cluster
        assert seg.segmented.sum() < 0.2 * n_valid


def test_extract_features_with_segmentation():
    """Every tier of extract_features_timed with segmentation=True (the
    LeGO-ref feature config): masks equal, the masked points and times."""
    ref = _reference()
    j = ref["programs"]["plain"][3]
    t = tcurv.extract_features_timed(_tscan(ref["scans"][0]), T_CFG.features)
    assert int(t.corners.mask.sum()) > 20 and int(t.surfs.mask.sum()) > 300
    for jb, jtau, tb, ttau in [(j.corners, j.corner_tau, t.corners, t.corner_tau),
                               (j.surfs, j.surf_tau, t.surfs, t.surf_tau),
                               (j.sharp, j.sharp_tau, t.sharp, t.sharp_tau),
                               (j.flat, j.flat_tau, t.flat, t.flat_tau)]:
        m = jb.mask
        np.testing.assert_array_equal(tb.mask.numpy(), m)
        np.testing.assert_allclose(tb.xyz.numpy()[m], jb.xyz[m], rtol=0, atol=3e-5)
        np.testing.assert_allclose(ttau.numpy()[m], jtau[m], rtol=0, atol=1e-6)


_jsolve = jax.jit(jts.solve_scan2map_two_step, static_argnums=(5, 6, 7))


@pytest.mark.parametrize("maps", ["built", "empty"])
def test_solve_scan2map_two_step(maps):
    """The two-step solve from a pose 0.3 m and 0.02 rad off, with the
    features of scan 2 against the maps the reference built by then (or
    against empty maps of the same shapes: every direction clamped, so the
    pose stays and the flag is set); no deskew."""
    ref = _reference()
    st, res = ref["states"][N_CARRY + 1], ref["results"][N_CARRY]
    off = jse3.Pose(jso3.quat_exp(jnp.asarray([0.0, 0.01, 0.02])), jnp.asarray([0.3, -0.1, 0.05]))
    pose0 = _np(jse3.compose(jse3.Pose(*map(jnp.asarray, res.pose)), off))
    cmap, smap = st.corner_map, st.surf_map
    if maps == "empty":
        cmap, smap = _np(jempty_map(CFG.corner_map)), _np(jempty_map(CFG.surf_map))
    jpose, jstats = _np(_jsolve(jse3.Pose(*map(jnp.asarray, pose0)), res.corners, res.surfs,
                                cmap, smap, CFG.corner_map, CFG.surf_map, CFG.solver))
    tpose, tstats = tts.solve_scan2map_two_step(
        TPose(*map(_t, pose0)), TPointBatch(*map(_t, res.corners)),
        TPointBatch(*map(_t, res.surfs)), THashVoxelMap(*map(_t, cmap)),
        THashVoxelMap(*map(_t, smap)), T_CFG.corner_map, T_CFG.surf_map, T_CFG.solver)
    np.testing.assert_allclose(tpose.t.numpy(), jpose.t, rtol=0, atol=SOLVE_TOL)
    np.testing.assert_allclose(tpose.q.numpy(), jpose.q, rtol=0, atol=SOLVE_TOL)
    assert int(tstats.n_corner) == int(jstats.n_corner)
    assert int(tstats.n_surf) == int(jstats.n_surf)
    assert bool(tstats.degenerate) == bool(jstats.degenerate)
    if maps == "empty":
        assert bool(tstats.degenerate) and int(tstats.n_surf) == 0
        np.testing.assert_array_equal(tpose.t.numpy(), pose0.t)
    else:
        assert int(tstats.n_surf) > 200 and int(tstats.n_corner) > 20
        # the solve moved the pose back towards the scan's estimate
        assert np.linalg.norm(tpose.t.numpy() - res.pose.t) < 0.05


@pytest.mark.parametrize("start", ["rest", "carried"])
def test_lego_ref_slice(start):
    """preset_lego_vlp16_ref, shrunk, through process_scan: segmentation,
    the two-step solve with its in-loop deskew, inserts; the first 2 scans
    from rest, or 4 scans from the reference's state after them (maps and
    previous features filled)."""
    ref = _reference()
    if start == "rest":
        lo, hi, state = 0, N_CARRY, tpipe.init_state(T_CFG, "cpu")
    else:
        lo, hi = N_CARRY, N_CARRY + N_SLICE
        state = state_from_numpy(ref["states"][lo], "cpu")
        assert int(state.prev_surfs.mask.sum()) > 0 and int(state.surf_map.num_points()) > 0
    for s, jres in zip(ref["scans"][lo:hi], ref["results"][lo:hi]):
        state, tres = tpipe.process_scan(state, _tscan(s), T_CFG)
        np.testing.assert_allclose(tres.pose.t.numpy(), jres.pose.t, rtol=0, atol=T_TOL)
        np.testing.assert_allclose(tres.pose.q.numpy(), jres.pose.q, rtol=0, atol=Q_TOL)
        assert int(tres.stats.n_corner) == int(jres.stats.n_corner)
        assert int(tres.stats.n_surf) == int(jres.stats.n_surf)
        assert int(tres.n_dropped) == int(jres.n_dropped)
    assert int(ref["results"][hi - 1].stats.n_surf) > 300  # the engine tracks
    assert int(state.frame) == hi
