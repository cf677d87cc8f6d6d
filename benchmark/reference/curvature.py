# Frozen copy of agi_lidar_slam_torch/features/curvature.py at commit 88e7c49, for the
# benchmark's plain reference: it imports nothing of the program, and
# later changes to the program do not reach it.
"""Curvature-based edge/planar feature extraction (A-LOAM / LIO-SAM family).

Port of agi_lidar_slam_tpu/features/curvature.py: 11-point curvature along
each ring from a wrapped prefix sum, an occlusion / parallel-beam mask, a
local-max mask plus per-sector top-k for corners, and voxel-downsampled
low-curvature points for surfs. With `segmentation` (LeGO-LOAM), corners
come only from valid clusters off the ground and surfs from clusters or
ground (features/segmentation.py, at its default SegmentationConfig, as in
the reference). `extract_features` is the untimed variant (LIO-SAM's).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .config import FeatureConfig
from .cloud import PointBatch, ScanGrid
from .voxel import prefix_sum, voxel_downsample_aux
from .segmentation import segment_scan


class ScanFeatures(NamedTuple):
    corners: PointBatch  # edge features (capacity R * n_sectors * corners_per_sector)
    surfs: PointBatch  # planar features (capacity cfg.max_surfs)


class TimedFeatures(NamedTuple):
    """Features plus their in-sweep time fractions. `corners`/`surfs` are the
    dense tiers; `sharp`/`flat` the small per-sector query tiers."""

    corners: PointBatch
    corner_tau: torch.Tensor  # (Nc,) in [0,1)
    surfs: PointBatch
    surf_tau: torch.Tensor  # (Ns,) voxel-mean time
    sharp: PointBatch  # (R * n_sectors * sharp_per_sector,)
    sharp_tau: torch.Tensor
    flat: PointBatch  # (R * n_sectors * flat_per_sector,)
    flat_tau: torch.Tensor


def _range(xyz: torch.Tensor) -> torch.Tensor:
    """Euclidean range, summed x, y, z in order (the reference's rounding)."""
    x, y, z = xyz.unbind(-1)
    return torch.sqrt(x * x + y * y + z * z)


def curvature(scan: ScanGrid, cfg: FeatureConfig):
    """Per-point curvature and candidate validity. Returns (c (R,W), valid (R,W)).

    The +-w windowed sum is one wrapped prefix sum and two shifted slices."""
    xyz, mask = scan.xyz, scan.mask
    r = _range(xyz)
    valid = mask & (r > cfg.min_range) & (r < cfg.max_range)
    w = cfg.curvature_window
    W = xyz.shape[1]
    ext = torch.cat([xyz[:, W - w:], xyz, xyz[:, :w]], dim=1)
    vext = torch.cat([valid[:, W - w:], valid, valid[:, :w]], dim=1)
    S = prefix_sum(ext, 1)
    Sv = torch.cumsum(vext.to(torch.int32), dim=1)
    S = torch.cat([torch.zeros_like(S[:, :1]), S], dim=1)  # S[k] = sum of first k
    Sv = torch.cat([torch.zeros_like(Sv[:, :1]), Sv], dim=1)
    win_sum = S[:, 2 * w + 1:] - S[:, :W]  # (R,W,3): sum over the 2w+1 window
    win_cnt = Sv[:, 2 * w + 1:] - Sv[:, :W]
    acc = win_sum - (2.0 * w + 1.0) * xyz
    all_valid = valid & (win_cnt == 2 * w + 1)
    ax, ay, az = acc.unbind(-1)
    c = ax * ax + ay * ay + az * az
    return torch.where(all_valid, c, torch.zeros_like(c)), all_valid


def occlusion_mask(scan: ScanGrid, cfg: FeatureConfig) -> torch.Tensor:
    """True where a point must NOT be picked as a feature (LIO-SAM
    featureExtraction.cpp:137-177 markOccludedPoints): the 6 points on the far
    side of a > 0.3 m depth gap, and points whose range jumps on both sides
    (> 2% of range)."""
    r = _range(scan.xyz)
    valid = scan.mask
    gap = torch.roll(r, -1, dims=1) - r  # range step from col i to i+1
    gap_valid = valid & torch.roll(valid, -1, dims=1)
    far_here = gap_valid & (gap < -0.3)  # i is far side, i+1 near: mark i-5..i
    far_next = gap_valid & (gap > 0.3)  # i+1 far side: mark i+1..i+6
    marked = torch.zeros_like(valid)
    for j in range(6):
        marked = marked | torch.roll(far_here, -j, dims=1)
        marked = marked | torch.roll(far_next, j + 1, dims=1)
    diff1 = torch.abs(torch.roll(r, 1, dims=1) - r)
    diff2 = torch.abs(torch.roll(r, -1, dims=1) - r)
    parallel = (diff1 > 0.02 * r) & (diff2 > 0.02 * r)
    return marked | parallel


def extract_features(scan: ScanGrid, cfg: FeatureConfig) -> ScanFeatures:
    t = extract_features_timed(scan, cfg)
    return ScanFeatures(t.corners, t.surfs)


def extract_features_timed(scan: ScanGrid, cfg: FeatureConfig) -> TimedFeatures:
    R, W = scan.rings, scan.width
    S = cfg.n_sectors
    Ws = W // S
    k = cfg.corners_per_sector
    dev = scan.xyz.device

    c, valid = curvature(scan, cfg)
    valid = valid & ~occlusion_mask(scan, cfg)

    if cfg.segmentation:
        # LeGO-LOAM: corners only from valid (big) clusters; planar candidates
        # from ground and clusters (featureAssociation consumes the segmented
        # cloud and the ground flags of imageProjection)
        seg = segment_scan(scan)
        valid_c = valid & seg.segmented & ~seg.ground
        valid_s = valid & (seg.segmented | seg.ground)
    else:
        valid_c = valid_s = valid

    # --- corners: local-max over +-nms_window, then per-sector top-k ---------
    cmax = c
    for j in range(1, cfg.nms_window + 1):
        cmax = torch.maximum(cmax, torch.maximum(torch.roll(c, j, dims=1),
                                                 torch.roll(c, -j, dims=1)))
    corner_cand = valid_c & (c > cfg.corner_thresh) & (c >= cmax)

    # unpicked entries all score -1; only their order differs from the
    # reference's top_k, and their mask is False
    score = torch.where(corner_cand, c, torch.full_like(c, -1.0))[:, :S * Ws].reshape(R, S, Ws)
    top, idx = torch.topk(score, k, dim=-1)  # (R,S,k), descending
    sector0 = (torch.arange(S, device=dev) * Ws)[None, :, None]
    col = (idx + sector0).reshape(R, S * k)
    corner_xyz = torch.gather(scan.xyz, 1, col[..., None].expand(R, S * k, 3)).reshape(-1, 3)
    corner_tau = torch.gather(scan.time, 1, col).reshape(-1)
    corner_mask = (top > 0.0).reshape(-1)
    picked = torch.zeros((R, W), dtype=torch.bool, device=dev)
    rows = torch.arange(R, device=dev).repeat_interleave(S * k)
    picked[rows, col.reshape(-1)] = corner_mask  # distinct (row, col) targets

    # --- sharp tier: the sharpest sharp_per_sector of each sector's picks ----
    ks = min(cfg.sharp_per_sector, k)
    col_s = col.reshape(R, S, k)[:, :, :ks].reshape(R, S * ks)
    sharp_xyz = torch.gather(scan.xyz, 1, col_s[..., None].expand(R, S * ks, 3)).reshape(-1, 3)
    sharp_tau = torch.gather(scan.time, 1, col_s).reshape(-1)
    sharp_mask = (top[:, :, :ks] > 0.0).reshape(-1)

    # --- surfs: low-curvature, not corner-picked, voxel downsampled ----------
    surf_cand = valid_s & (c < cfg.surf_thresh) & ~picked
    surfs, surf_tau = voxel_downsample_aux(
        scan.xyz.reshape(-1, 3), surf_cand.reshape(-1), cfg.surf_voxel,
        cfg.max_surfs, aux=scan.time.reshape(-1),
    )

    # --- flat tier: flat_per_sector LOWEST-curvature candidates per sector ---
    kf = cfg.flat_per_sector
    score_f = torch.where(surf_cand, -c, torch.full_like(c, -float("inf")))
    score_f = score_f[:, :S * Ws].reshape(R, S, Ws)
    top_f, idx_f = torch.topk(score_f, kf, dim=-1)  # least curvature first
    col_f = (idx_f + sector0).reshape(R, S * kf)
    flat_xyz = torch.gather(scan.xyz, 1, col_f[..., None].expand(R, S * kf, 3)).reshape(-1, 3)
    flat_tau = torch.gather(scan.time, 1, col_f).reshape(-1)
    flat_mask = torch.isfinite(top_f).reshape(-1)

    return TimedFeatures(PointBatch(corner_xyz, corner_mask), corner_tau,
                         surfs, surf_tau,
                         PointBatch(sharp_xyz, sharp_mask), sharp_tau,
                         PointBatch(flat_xyz, flat_mask), flat_tau)
