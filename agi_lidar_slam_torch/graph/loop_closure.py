"""Loop-closure detection and alignment (port of
agi_lidar_slam_tpu/graph/loop_closure.py).

* detection: nearest keyframe by Euclidean distance with a minimum scan-index
  separation (the reference's 30 s time gate);
* alignment: the candidate's +-half window of keyframe clouds is assembled
  into a small hashed voxel map (full27, so the KNN takes the gather path of
  nn/knn.py, not the octant kernel) and the current keyframe's features are
  registered against it with the scan-to-map GN of the odometry;
* acceptance: residual-RMS fitness gate (historyKeyframeFitnessScore 0.3).

The candidate, the window start and the flags stay tensors: nothing here
reads them to the host (the map inserts' claim rounds do, once a round).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..config import MapConfig, SolverConfig
from ..estimators.gn_scan2map import solve_scan2map
from ..geometry import se3, so3
from ..map.hash_map import empty_map, insert
from ..pointcloud.cloud import PointBatch
from .keyframes import KeyframeBank, row


class LoopConfig(NamedTuple):
    radius: float = 5.0  # historyKeyframeSearchRadius (LIO-SAM params.yaml)
    min_stamp_sep: int = 100  # scan-index analog of the 30 s time gate
    submap_half: int = 12  # historyKeyframeSearchNum = 25
    fitness_thresh: float = 0.3  # historyKeyframeFitnessScore
    min_matches: int = 100
    map_cfg: MapConfig = MapConfig(sub_voxel=0.4, block_sub=4, log2_slots=14,
                                   neighborhood="full27")
    solver: SolverConfig = SolverConfig(n_outer=5, n_inner=3, surf_gate_sq=2.0,
                                        corner_gate_sq=2.0, degen_eig_thresh=10.0)


def detect_loop(bank: KeyframeBank, cur_idx: torch.Tensor,
                cfg: LoopConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest old keyframe within radius and stamp separation.
    Returns (candidate index, found flag); with no candidate at all every
    distance is inf and the candidate is index 0, as in the reference."""
    K = bank.capacity
    ids = torch.arange(K, device=bank.t.device)
    live = ids < bank.count
    sep = torch.abs(bank.stamp - row(bank.stamp, cur_idx)) >= cfg.min_stamp_sep
    d = torch.linalg.vector_norm(bank.t - row(bank.t, cur_idx), dim=-1)
    d = torch.where(live & sep & (ids != cur_idx), d, torch.full_like(d, float("inf")))
    cand = torch.argmin(d)  # first index of the minimum
    found = row(d, cand) < cfg.radius
    return cand.to(torch.int32), found


def _window_cloud(xyz: torch.Tensor, mask: torch.Tensor, q: torch.Tensor, t: torch.Tensor,
                  start: torch.Tensor, size: int, count: torch.Tensor):
    """Gather `size` keyframes' clouds from `start`, world-transformed.
    `start` is clamped to [0, K - size], as lax.dynamic_slice clamps it."""
    K = xyz.shape[0]
    if size > K:
        raise ValueError(f"window of {size} keyframes is larger than the bank ({K})")
    ids = torch.clamp(start, 0, K - size) + torch.arange(size, device=xyz.device)
    idx_valid = (start + torch.arange(size, device=xyz.device)) < count
    R = so3.quat_to_matrix(q[ids])  # (S,3,3)
    world = torch.einsum("sij,snj->sni", R, xyz[ids]) + t[ids][:, None, :]
    m = mask[ids] & idx_valid[:, None]
    return world.reshape(-1, 3), m.reshape(-1)


def align_loop(bank: KeyframeBank, cur_idx: torch.Tensor, cand_idx: torch.Tensor,
               cfg: LoopConfig):
    """Register the current keyframe against the candidate's submap.

    Returns (z_rel: candidate_T_current measurement, fitness rms, ok flag)."""
    size = 2 * cfg.submap_half + 1
    start = torch.clamp(cand_idx - cfg.submap_half, min=0)
    start = torch.minimum(start, torch.clamp(bank.count - size, min=0))

    c_xyz, c_mask = _window_cloud(bank.corner_xyz, bank.corner_mask, bank.q, bank.t,
                                  start, size, bank.count)
    s_xyz, s_mask = _window_cloud(bank.surf_xyz, bank.surf_mask, bank.q, bank.t,
                                  start, size, bank.count)
    dev = bank.t.device
    cmap = insert(empty_map(cfg.map_cfg, dev), c_xyz, c_mask, cfg.map_cfg)
    smap = insert(empty_map(cfg.map_cfg, dev), s_xyz, s_mask, cfg.map_cfg)

    cur_pose = se3.Pose(row(bank.q, cur_idx), row(bank.t, cur_idx))
    corners = PointBatch(row(bank.corner_xyz, cur_idx), row(bank.corner_mask, cur_idx))
    surfs = PointBatch(row(bank.surf_xyz, cur_idx), row(bank.surf_mask, cur_idx))

    pose_ref, stats = solve_scan2map(cur_pose, corners, surfs, cmap, smap,
                                     cfg.map_cfg, cfg.map_cfg, cfg.solver)
    ok = ((stats.rms < cfg.fitness_thresh)
          & ((stats.n_corner + stats.n_surf) > cfg.min_matches)
          & torch.all(torch.isfinite(pose_ref.t)))
    cand_pose = se3.Pose(row(bank.q, cand_idx), row(bank.t, cand_idx))
    z_rel = se3.compose(se3.inverse(cand_pose), pose_ref)
    return z_rel, stats.rms, ok
