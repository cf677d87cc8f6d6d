"""LIO-Livox 3-class feature extraction: corner / surf / non-feature
(port of agi_lidar_slam_tpu/features/livox.py).

* distance-adaptive curvature thresholds (DistanceFaraway: beyond `faraway`
  the thresholds scale with (r / faraway)^2);
* break corners: the near side of a depth step is kept as a corner candidate;
* a third "non-feature" class: every valid point that is neither corner nor
  planar, voxel-downsampled, kept as weak point-to-plane constraints.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..pointcloud.cloud import PointBatch, ScanGrid
from ..pointcloud.voxel import voxel_downsample
from .curvature import _range, occlusion_mask


class LivoxFeatureConfig(NamedTuple):
    curvature_window: int = 2  # NumCurvSize
    n_sectors: int = 24  # sectors per ring revolution
    corners_per_sector: int = 6
    corner_thresh: float = 0.02  # at reference range (10 m)
    surf_thresh: float = 0.01
    faraway: float = 30.0  # DistanceFaraway: thresholds scale above this
    nms_window: int = 3
    break_gap: float = 1.0  # depth step (m) marking a break corner
    max_corners: int = 1024
    max_surfs: int = 4096
    max_others: int = 2048
    other_voxel: float = 1.0
    surf_voxel: float = 0.4
    min_range: float = 0.5
    max_range: float = 150.0


class LivoxFeatures(NamedTuple):
    corners: PointBatch
    surfs: PointBatch
    others: PointBatch  # non-feature class (weak constraints)


def extract_livox_features(scan: ScanGrid, cfg: LivoxFeatureConfig) -> LivoxFeatures:
    R, W = scan.rings, scan.width
    xyz, mask = scan.xyz, scan.mask
    dev = xyz.device
    r = _range(xyz)
    valid = mask & (r > cfg.min_range) & (r < cfg.max_range)

    # curvature over a +-w window along the ring, summed in the reference's order
    w = cfg.curvature_window
    acc = -2.0 * w * xyz
    all_valid = valid
    for j in range(1, w + 1):
        for s in (j, -j):
            acc = acc + torch.roll(xyz, s, dims=1)
            all_valid = all_valid & torch.roll(valid, s, dims=1)
    ax, ay, az = acc.unbind(-1)
    c = torch.where(all_valid, ax * ax + ay * ay + az * az, torch.zeros_like(ax))

    # distance-adaptive thresholds: scale ~ (r / faraway)^2 beyond faraway
    scale = torch.clamp((r / cfg.faraway) ** 2, min=1.0)
    c_thr = cfg.corner_thresh * scale
    s_thr = cfg.surf_thresh * scale

    pickable = all_valid & ~occlusion_mask(scan, cfg)

    # break corners: the nearer endpoint of a large depth gap
    gap_r = torch.roll(r, -1, dims=1) - r
    gap_ok = valid & torch.roll(valid, -1, dims=1)
    break_here = gap_ok & (gap_r > cfg.break_gap)  # this point is the near side
    break_next = gap_ok & (gap_r < -cfg.break_gap)  # the next point is the near side
    break_corner = (break_here | torch.roll(break_next, 1, dims=1)) & valid

    # corner pick: local max of curvature above the adaptive threshold
    cmax = c
    for j in range(1, cfg.nms_window + 1):
        cmax = torch.maximum(cmax, torch.maximum(torch.roll(c, j, dims=1),
                                                 torch.roll(c, -j, dims=1)))
    corner_cand = (pickable & (c > c_thr) & (c >= cmax)) | (break_corner & pickable)

    S = cfg.n_sectors
    Ws = W // S
    k = cfg.corners_per_sector
    # unpicked entries all score -1: only their order can differ from the
    # reference's top_k, and their mask is False
    score = torch.where(corner_cand, c + 1e-3, torch.full_like(c, -1.0))
    top, idx = torch.topk(score[:, :S * Ws].reshape(R, S, Ws), k, dim=-1)
    col = (idx + (torch.arange(S, device=dev) * Ws)[None, :, None]).reshape(R, S * k)
    corner_xyz = torch.gather(xyz, 1, col[..., None].expand(R, S * k, 3)).reshape(-1, 3)
    corner_mask = (top > 0.0).reshape(-1)
    corners = voxel_downsample(corner_xyz, corner_mask, 0.2, cfg.max_corners)

    picked = torch.zeros((R, W), dtype=torch.bool, device=dev)
    rows = torch.arange(R, device=dev).repeat_interleave(S * k)
    picked[rows, col.reshape(-1)] = corner_mask  # distinct (row, col) targets

    surf_cand = pickable & (c < s_thr) & ~picked
    surfs = voxel_downsample(xyz.reshape(-1, 3), surf_cand.reshape(-1), cfg.surf_voxel,
                             cfg.max_surfs)
    other_cand = valid & ~surf_cand & ~picked
    others = voxel_downsample(xyz.reshape(-1, 3), other_cand.reshape(-1), cfg.other_voxel,
                              cfg.max_others)
    return LivoxFeatures(corners, surfs, others)
