"""Single-program odometry+mapping pipeline, the engine's per-scan main path
(port of agi_lidar_slam_tpu/runtime/pipeline.py).

One call per scan: feature extraction on the raw sweep -> feature downsample
-> scan-to-map GN with in-loop constant-velocity deskew -> final deskew ->
map insertion -> rolling map bound. PyTorch runs it eagerly; the state lives
on the device `init_state` put it on (cuda unless asked otherwise).

Not ported, and raising: the scan-to-scan `odometry_stage` and the LeGO
`two_step` solver. `process_scan_chunk` (a launch batcher) is not ported.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..config import PipelineConfig
from ..device import default_device
from ..estimators.gn_scan2map import GnStats, solve_scan2map
from ..features.curvature import extract_features_timed
from ..geometry import se3, so3
from ..map.hash_map import HashVoxelMap, bound_map, empty_map, insert_with_stats
from ..pointcloud.cloud import PointBatch, ScanGrid
from ..pointcloud.voxel import voxel_downsample_aux


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


def process_scan(state: EngineState, scan: ScanGrid,
                 cfg: PipelineConfig) -> Tuple[EngineState, ScanResult]:
    """Process one sweep; returns (new state, result). `state` is not
    modified: the maps of the new state are new tensors."""
    if cfg.odometry_stage:
        raise NotImplementedError("odometry_stage is not ported to torch")
    if cfg.two_step:
        raise NotImplementedError("two_step is not ported to torch")
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

    pred = se3.compose(state.pose, rel)  # constant-velocity initial guess
    # on an empty map every eigenvalue of H is below the degeneracy threshold,
    # so the solver is a no-op and the pose stays at the prediction
    dsk = (tau_c, tau_s, state.pose) if cfg.deskew else None
    pose_opt, stats = solve_scan2map(
        pred, corners, surfs, state.corner_map, state.surf_map,
        cfg.corner_map, cfg.surf_map, cfg.solver, deskew=dsk,
    )

    if cfg.deskew:
        # final motion compensation at the optimized estimate
        rel_opt = se3.compose(se3.inverse(state.pose), pose_opt)
        corners = PointBatch(se3.apply_interpolated(rel_opt, tau_c, corners.xyz), corners.mask)
        surfs = PointBatch(se3.apply_interpolated(rel_opt, tau_s, surfs.xyz), surfs.mask)

    R = so3.quat_to_matrix(pose_opt.q)
    cmap, drop_c = insert_with_stats(state.corner_map, corners.xyz @ R.T + pose_opt.t,
                                     corners.mask, cfg.corner_map)
    smap, drop_s = insert_with_stats(state.surf_map, surfs.xyz @ R.T + pose_opt.t,
                                     surfs.mask, cfg.surf_map)
    if cfg.bound_radius > 0:
        cmap = bound_map(cmap, pose_opt.t, cfg.bound_radius, cfg.corner_map)
        smap = bound_map(smap, pose_opt.t, cfg.bound_radius, cfg.surf_map)

    new_state = EngineState(pose_opt, state.pose, cmap, smap, state.frame + 1,
                            corners, surfs)
    return new_state, ScanResult(pose_opt, stats, corners, surfs, drop_c + drop_s)


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
