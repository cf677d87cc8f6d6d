# Frozen copy of agi_lidar_slam_torch/runtime/pipeline.py at commit 88e7c49, for the
# benchmark's plain reference: it imports nothing of the program, and
# later changes to the program do not reach it.
"""Single-program odometry+mapping pipeline, the engine's per-scan main path
(port of agi_lidar_slam_tpu/runtime/pipeline.py).

One call per scan: feature extraction on the raw sweep -> feature downsample
-> (optional) scan-to-scan odometry stage -> scan-to-map GN with in-loop
constant-velocity deskew -> final deskew -> map insertion -> rolling map
bound. PyTorch runs it eagerly; the state lives on the device `init_state`
put it on (cuda unless asked otherwise).

`odometry_stage` (A-LOAM laserOdometry) registers the scan against the
previous scan's features, inserted each scan into two throwaway maps of
`odom_map`, and starts the scan-to-map solve from its estimate; `two_step`
takes LeGO-LOAM's two-step solver (estimators/two_step.py) for the
scan-to-map solve.

`process_scan_chunk` runs C scans one after the other, eagerly: the
program's chunk call replays them as one CUDA graph, and this is what that
graph has to compute. Every kernel of the program is a plain function here:
the octant KNN is its plain version (octant_knn.py), the eigendecomposition
torch.linalg.eigh (sym_eig.py), and the map's claim rounds stop at the first
round with nothing left to claim, which gives the same keys as running all
of them (hash_map.lookup_dedup).

`_process_scan_body` takes the solver, insert and bound operations as
arguments, so the multi-device steps (parallel/sharding.py) run this same
body with the point axis sharded (dp) or the map slot-sharded (mp).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
from torch.utils import _pytree as pytree

from .config import PipelineConfig
from .device import default_device
from .gn_scan2map import GnStats, solve_scan2map
from .two_step import solve_scan2map_two_step
from .curvature import extract_features_timed
from . import se3, so3
from .hash_map import HashVoxelMap, bound_map, empty_map, insert, insert_with_stats
from .cloud import PointBatch, ScanGrid
from .voxel import voxel_downsample_aux


class EngineState(NamedTuple):
    pose: se3.Pose  # world_T_sensor at the latest processed sweep start
    prev_pose: se3.Pose  # pose one sweep earlier (constant-velocity model)
    corner_map: HashVoxelMap
    surf_map: HashVoxelMap
    frame: torch.Tensor  # int32 scan counter
    # previous scan's features (sensor frame), kept for the scan-to-scan
    # odometry stage of the reference
    prev_corners: PointBatch
    prev_surfs: PointBatch


class ScanResult(NamedTuple):
    pose: se3.Pose
    stats: GnStats
    corners: PointBatch  # downsampled sensor-frame features of this scan
    surfs: PointBatch
    n_dropped: torch.Tensor  # map inserts lost to full chains


def init_state(cfg: PipelineConfig, device=None) -> EngineState:
    """An engine at rest with empty maps, on `device` (default: cuda)."""
    device = default_device(device)
    f = cfg.features

    def batch(n):
        return PointBatch(torch.zeros((n, 3), device=device),
                          torch.zeros((n,), dtype=torch.bool, device=device))

    return EngineState(
        pose=se3.Pose.identity(device=device),
        prev_pose=se3.Pose.identity(device=device),
        corner_map=empty_map(cfg.corner_map, device),
        surf_map=empty_map(cfg.surf_map, device),
        frame=torch.zeros((), dtype=torch.int32, device=device),
        prev_corners=batch(f.max_corners),
        prev_surfs=batch(f.max_surfs),
    )


def deskew_constant_velocity(scan: ScanGrid, rel: se3.Pose) -> ScanGrid:
    """Whole-grid constant-velocity deskew (A-LOAM TransformToStart applied to
    every point of the sweep at its time). The scan body does not use it: it
    extracts features on the distorted sweep and the solver deskews the
    features at every association pass. Kept for grid-level consumers."""
    xyz = se3.apply_interpolated(rel, scan.time.reshape(-1), scan.xyz.reshape(-1, 3))
    return ScanGrid(xyz.reshape(scan.xyz.shape), scan.mask, scan.time)


def _process_scan_body(
    state: EngineState, scan: ScanGrid, cfg: PipelineConfig,
    solve_fn=None,
    solve_two_fn=None,
    insert_fn=None,
    bound_fn=None,
) -> Tuple[EngineState, ScanResult]:
    """The per-scan pipeline over its solver, insert and bound operations,
    each the module's own function where None (looked up at call time).
    The reference's body takes the first three; `bound_fn` is the port's own:
    a slot-sharded map has no global view in torch, so its rolling bound
    (parallel/map_shard.sharded_bound) is an operation of its own too."""
    solve_fn = solve_fn or solve_scan2map
    solve_two_fn = solve_two_fn or solve_scan2map_two_step
    insert_fn = insert_fn or insert_with_stats
    bound_fn = bound_fn or bound_map
    rel = se3.compose(se3.inverse(state.prev_pose), state.pose)

    # features come from the RAW (distorted) sweep; the solver deskews them at
    # every association pass from their sweep times
    feats = extract_features_timed(scan, cfg.features)
    corners, tau_c = voxel_downsample_aux(
        feats.corners.xyz, feats.corners.mask, cfg.corner_ds_voxel,
        cfg.features.max_corners, aux=feats.corner_tau,
    )
    surfs, tau_s = voxel_downsample_aux(
        feats.surfs.xyz, feats.surfs.mask, cfg.surf_ds_voxel,
        cfg.features.max_surfs, aux=feats.surf_tau,
    )

    if cfg.odometry_stage:
        # scan-to-scan refinement of the motion prediction: this scan's
        # features against the previous scan's final-deskewed ones, inserted
        # into two throwaway maps in the previous sensor frame. With
        # odom_two_tier the queries are the small SHARP/FLAT tiers and the
        # targets the previous dense tiers, the reference's asymmetric
        # sharp -> less-sharp matching (laserOdometry.cpp:341-573). On the
        # first scan the previous features are all masked: the maps are
        # empty and the solve is a no-op.
        if cfg.odom_two_tier:
            q_c, q_s = feats.sharp, feats.flat
            qtau_c, qtau_s = feats.sharp_tau, feats.flat_tau
        else:
            q_c, q_s = corners, surfs
            qtau_c, qtau_s = tau_c, tau_s
        dev = scan.xyz.device
        ocmap = insert(empty_map(cfg.odom_map, dev), state.prev_corners.xyz,
                       state.prev_corners.mask, cfg.odom_map)
        osmap = insert(empty_map(cfg.odom_map, dev), state.prev_surfs.xyz,
                       state.prev_surfs.mask, cfg.odom_map)
        odsk = (qtau_c, qtau_s, se3.Pose.identity(device=dev)) if cfg.deskew else None
        rel_opt, _ = solve_fn(rel, q_c, q_s, ocmap, osmap, cfg.odom_map, cfg.odom_map,
                              cfg.odom_solver, deskew=odsk)
        pred = se3.compose(state.pose, rel_opt)
    else:
        pred = se3.compose(state.pose, rel)  # constant-velocity initial guess
    # on an empty map every eigenvalue of H is below the degeneracy threshold,
    # so the solver is a no-op and the pose stays at the prediction
    dsk = (tau_c, tau_s, state.pose) if cfg.deskew else None
    solve = solve_two_fn if cfg.two_step else solve_fn
    pose_opt, stats = solve(
        pred, corners, surfs, state.corner_map, state.surf_map,
        cfg.corner_map, cfg.surf_map, cfg.solver, deskew=dsk,
    )

    if cfg.deskew:
        # final motion compensation at the optimized estimate
        rel_opt = se3.compose(se3.inverse(state.pose), pose_opt)
        corners = PointBatch(se3.apply_interpolated(rel_opt, tau_c, corners.xyz), corners.mask)
        surfs = PointBatch(se3.apply_interpolated(rel_opt, tau_s, surfs.xyz), surfs.mask)

    R = so3.quat_to_matrix(pose_opt.q)
    cmap, drop_c = insert_fn(state.corner_map, corners.xyz @ R.T + pose_opt.t,
                             corners.mask, cfg.corner_map)
    smap, drop_s = insert_fn(state.surf_map, surfs.xyz @ R.T + pose_opt.t,
                             surfs.mask, cfg.surf_map)
    if cfg.bound_radius > 0:
        cmap = bound_fn(cmap, pose_opt.t, cfg.bound_radius, cfg.corner_map)
        smap = bound_fn(smap, pose_opt.t, cfg.bound_radius, cfg.surf_map)

    new_state = EngineState(pose_opt, state.pose, cmap, smap, state.frame + 1,
                            corners, surfs)
    return new_state, ScanResult(pose_opt, stats, corners, surfs, drop_c + drop_s)


def process_scan(state: EngineState, scan: ScanGrid,
                 cfg: PipelineConfig) -> Tuple[EngineState, ScanResult]:
    """Process one sweep; returns (new state, result). `state` is not
    modified: the maps of the new state are new tensors."""
    return _process_scan_body(state, scan, cfg)


def _stack(trees: list):
    """Trees of one structure -> one tree of the leaves stacked on a new
    leading axis (what `lax.scan` makes of its per-step outputs)."""
    leaves = [pytree.tree_flatten(t)[0] for t in trees]
    spec = pytree.tree_flatten(trees[0])[1]
    return pytree.tree_unflatten([torch.stack(ls) for ls in zip(*leaves)], spec)


def _scan_at(scans: ScanGrid, i: int) -> ScanGrid:
    return ScanGrid(*(a[i] for a in scans))


def _run_chunk(state: EngineState, scans: ScanGrid, cfg: PipelineConfig):
    results = []
    for i in range(scans.xyz.shape[0]):
        state, res = process_scan(state, _scan_at(scans, i), cfg)
        results.append(res)
    return state, _stack(results)


def process_scan_chunk(state: EngineState, scans: ScanGrid,
                       cfg: PipelineConfig) -> Tuple[EngineState, ScanResult]:
    """Process a chunk of C scans (`scans` with a leading axis C) as C
    process_scan calls, one after the other; returns (the state after the
    last, the C ScanResults stacked on a leading axis). The program replays
    a CUDA graph of the C bodies; here they run eagerly."""
    return _run_chunk(state, scans, cfg)


def run_sequence(scans, cfg: PipelineConfig, state: EngineState | None = None):
    """Host loop: stream an iterable of ScanGrids through the engine.
    Returns (final state, list of ScanResults). Without `state`, the engine
    starts empty on the device of the first scan."""
    results = []
    for scan in scans:
        if state is None:
            state = init_state(cfg, scan.xyz.device)
        state, res = process_scan(state, scan, cfg)
        results.append(res)
    return state, results
