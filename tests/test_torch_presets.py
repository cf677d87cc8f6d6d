"""The port's reference presets, its A-LOAM odometry stage and its evaluation
metrics against the reference's, on the CPU.

* Every preset of the port's `presets.py` (and `config.preset_lego_vlp16`)
  equals `convert.config_from_reference` of the reference's, field by field:
  the `REFERENCE_PIPELINE_PRESETS` keys, `LioSamRefParams` with its
  `imu_noise()`, the S-FAST_LIO avia 6-tuple, `lio_config_avia_ref` and
  `livox_config_horizon_ref`.
* A slice of `preset_aloam_kitti64_ref` (the scan-to-scan odometry stage on
  every scan, two-tier queries, full27 odometry maps, then the scan-to-map
  solve on octant8 maps) through `runtime.pipeline.process_scan`, shrunk to
  512/2048 feature slots and maps of 2^10/2^11 slots (odometry maps 2^10),
  on 16x720 scans of the port's simulator (VLP-16's +-15 deg, 0.35 m and 0.03
  rad a scan in default_world(seed=2, extent=30)): the first 2 scans from
  rest (the stage's maps are empty on the first), then 4 scans from the
  state the reference carried over (previous features filled). Target 1e-3
  m and 1e-3 per quaternion component with equal correspondence counts and
  drops; measured 1.2e-6 m and 1.7e-7.
* `eval/metrics.py`: `mat_to_quat`, `rpe_rmse`, `kitti_drift`,
  `check_envelope` and `load_envelope` (the four named envelopes, a file
  and the inline form) equal to the reference's on the same seeded inputs
  (both are numpy, the same arithmetic: compared exactly).
"""

import dataclasses
import functools
import json
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import agi_lidar_slam_torch.config as tconfig
import agi_lidar_slam_torch.presets as tpre
from agi_lidar_slam_torch.convert import config_from_reference, state_from_numpy
from agi_lidar_slam_torch.eval import metrics as tmet
from agi_lidar_slam_torch.geometry import se3 as tse3
from agi_lidar_slam_torch.geometry import so3 as tso3
from agi_lidar_slam_torch.pointcloud.cloud import ScanGrid as TScanGrid
from agi_lidar_slam_torch.runtime import pipeline as tpipe
from agi_lidar_slam_torch.sim.world import default_world, simulate_scan
import agi_lidar_slam_tpu.config as jconfig
import agi_lidar_slam_tpu.presets as jpre
from agi_lidar_slam_tpu.eval import metrics as jmet
from agi_lidar_slam_tpu.pointcloud.cloud import ScanGrid as JScanGrid
from agi_lidar_slam_tpu.runtime import pipeline as jpipe
from tests._torch_threads import torch_one_thread  # noqa: F401 (autouse)

_BASE = jpre.preset_aloam_kitti64_ref()
CFG = dataclasses.replace(
    _BASE,
    features=dataclasses.replace(_BASE.features, max_corners=512, max_surfs=2048),
    corner_map=dataclasses.replace(_BASE.corner_map, log2_slots=10),
    surf_map=dataclasses.replace(_BASE.surf_map, log2_slots=11),
    odom_map=dataclasses.replace(_BASE.odom_map, log2_slots=10),
)
T_CFG = config_from_reference(CFG)
N_CARRY, N_SLICE = 2, 4
T_TOL, Q_TOL = 1e-3, 1e-3

PRESETS = {
    "aloam-ref": (jpre.preset_aloam_kitti64_ref, tpre.preset_aloam_kitti64_ref),
    "lego-ref": (jpre.preset_lego_vlp16_ref, tpre.preset_lego_vlp16_ref),
    "liosam-ref": (jpre.preset_liosam_vlp16_ref, tpre.preset_liosam_vlp16_ref),
    "lego": (jconfig.preset_lego_vlp16, tconfig.preset_lego_vlp16),
    "avia-ref": (jpre.lio_config_avia_ref, tpre.lio_config_avia_ref),
    "horizon-ref": (jpre.livox_config_horizon_ref, tpre.livox_config_horizon_ref),
    "liosam-params": (jpre.LioSamRefParams, tpre.LioSamRefParams),
}


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_preset_equals_reference(name):
    jfn, tfn = PRESETS[name]
    j, t = jfn(), tfn()
    assert type(t).__module__.startswith("agi_lidar_slam_torch")
    assert config_from_reference(j) == t
    if name == "liosam-params":
        assert config_from_reference(j.imu_noise()) == t.imu_noise()


def test_registry_and_avia_tuple():
    assert set(tpre.REFERENCE_PIPELINE_PRESETS) == set(jpre.REFERENCE_PIPELINE_PRESETS)
    for key, fn in tpre.REFERENCE_PIPELINE_PRESETS.items():
        assert config_from_reference(jpre.REFERENCE_PIPELINE_PRESETS[key]()) == fn()
    j, t = jpre.preset_sfastlio_avia_ref(), tpre.preset_sfastlio_avia_ref()
    assert len(t) == len(j) == 6
    assert config_from_reference(j[0]) == t[0] and config_from_reference(j[1]) == t[1]
    assert tuple(j[2:]) == tuple(t[2:])


def _np(tree):
    return jax.tree.map(np.array, tree)


def _scans():
    """The arc's 16x720 scans from the port's simulator, as numpy."""
    world = default_world(seed=2, extent=30.0, device="cpu")
    step = tse3.Pose(tso3.quat_exp(torch.tensor([0.0, 0.0, 0.03])), torch.zeros(3))
    pose, scans = tse3.Pose.identity(device="cpu"), []
    for i in range(N_CARRY + N_SLICE):
        q = tso3.quat_normalize(tso3.quat_mul(pose.q, step.q))
        nxt = tse3.Pose(q, pose.t + tso3.quat_rotate(q, torch.tensor([0.35, 0.0, 0.0])))
        s = simulate_scan(world, pose, nxt, rings=16, width=720, noise_std=0.005, seed=i)
        scans.append(tuple(a.numpy() for a in s))
        pose = nxt
    return scans


@functools.lru_cache(maxsize=1)
def _reference():
    scans = _scans()
    state = jpipe.init_state(CFG)
    states, results = [_np(state)], []
    for s in scans:
        state, res = jpipe.process_scan(state, JScanGrid(*map(jnp.asarray, s)), CFG)
        states.append(_np(state))
        results.append(_np(res))
    return scans, states, results


@pytest.mark.parametrize("start", ["rest", "carried"])
def test_aloam_ref_slice(start):
    """The odometry stage and the scan-to-map solve, scan by scan: from rest
    for the first 2 scans, or from the reference's state after them for 4."""
    scans, states, results = _reference()
    lo, hi = (0, N_CARRY) if start == "rest" else (N_CARRY, N_CARRY + N_SLICE)
    state = (tpipe.init_state(T_CFG, "cpu") if start == "rest"
             else state_from_numpy(states[lo], "cpu"))
    odom = []
    real = tpipe.solve_scan2map

    def spy(*a, **kw):
        pose, stats = real(*a, **kw)
        if a[5] == T_CFG.odom_map:  # the odometry stage's solve
            odom.append(stats)
        return pose, stats

    with mock.patch.object(tpipe, "solve_scan2map", spy):
        for s, jres in zip(scans[lo:hi], results[lo:hi]):
            state, tres = tpipe.process_scan(state, TScanGrid(*map(torch.from_numpy, s)), T_CFG)
            np.testing.assert_allclose(tres.pose.t.numpy(), jres.pose.t, rtol=0, atol=T_TOL)
            np.testing.assert_allclose(tres.pose.q.numpy(), jres.pose.q, rtol=0, atol=Q_TOL)
            assert int(tres.stats.n_corner) == int(jres.stats.n_corner)
            assert int(tres.stats.n_surf) == int(jres.stats.n_surf)
            assert int(tres.n_dropped) == int(jres.n_dropped)
    assert len(odom) == hi - lo
    n_odom = [int(st.n_surf) for st in odom]
    if start == "rest":  # empty odometry maps on the first scan: a no-op
        assert n_odom[0] == 0 and bool(odom[0].degenerate) and n_odom[1] > 20
    else:
        assert min(n_odom) > 20 and int(results[-1].stats.n_surf) > 200
    assert int(state.frame) == hi


def _traj(n=60, seed=0):
    rng = np.random.default_rng(seed)
    gt = np.cumsum(rng.normal(size=(n, 3)) * [3.0, 1.0, 0.1], axis=0)
    est = gt + rng.normal(scale=0.05, size=(n, 3)).cumsum(axis=0) * 0.1
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q2 = q + rng.normal(scale=0.01, size=(n, 4))
    return est, gt, q2 / np.linalg.norm(q2, axis=1, keepdims=True), q


@pytest.mark.parametrize("with_q", [False, True])
def test_rpe_and_kitti_drift(with_q):
    est, gt, eq, gq = _traj()
    qs = (eq, gq) if with_q else (None, None)
    for delta in (1, 5):
        assert tmet.rpe_rmse(est, gt, delta, *qs) == jmet.rpe_rmse(est, gt, delta, *qs)
    kw = dict(lengths=(20.0, 50.0, 100.0), step=3)
    t, j = tmet.kitti_drift(est, gt, *qs, **kw), jmet.kitti_drift(est, gt, *qs, **kw)
    assert t["n_segments"] == j["n_segments"] > 0 and t["per_length"] == j["per_length"]
    np.testing.assert_array_equal([t["t_rel_pct"], t["r_deg_per_m"]],
                                  [j["t_rel_pct"], j["r_deg_per_m"]])
    empty = tmet.kitti_drift(est[:3], gt[:3])
    assert empty["n_segments"] == 0 and np.isnan(empty["t_rel_pct"])


def test_mat_to_quat():
    _, _, q, _ = _traj(n=40, seed=1)
    R = jmet._quat_to_mat(q)
    np.testing.assert_array_equal(tmet._quat_to_mat(q), R)
    np.testing.assert_array_equal(tmet.mat_to_quat(R), jmet.mat_to_quat(R))
    back = tmet.mat_to_quat(R)
    np.testing.assert_allclose(np.abs(np.sum(back * q, axis=1)), 1.0, atol=1e-9)


@pytest.mark.parametrize("spec", ["kitti00_aloam", "kitti05_lego", "liosam_bag", "avia_lio",
                                  "ate_m=0.3,min_scans=10", "file"])
def test_load_and_check_envelope(spec, tmp_path):
    if spec == "file":
        path = tmp_path / "gate.json"
        path.write_text(json.dumps({"ate_m": 0.5, "t_rel_pct": 1.0}))
        spec = str(path)
    env = tmet.load_envelope(spec)
    assert env == jmet.load_envelope(spec)
    for summary in ({"ate_m": 0.1, "t_rel_pct": 0.5, "r_deg_per_m": 0.001, "n_scans": 5000,
                     "ate_raw_m": 0.1},
                    {"ate_m": 3.0, "t_rel_pct": float("nan"), "n_scans": 5},
                    {}):
        assert tmet.check_envelope(summary, env) == jmet.check_envelope(summary, env)


def test_load_envelope_rejects_unknown():
    with pytest.raises(ValueError, match="not a file"):
        tmet.load_envelope("no_such_envelope")
