# Frozen copy of agi_lidar_slam_torch/features/segmentation.py at commit 88e7c49, for the
# benchmark's plain reference: it imports nothing of the program, and
# later changes to the program do not reach it.
"""Range-image ground removal and segment clustering (LeGO-LOAM layer L2;
port of agi_lidar_slam_tpu/features/segmentation.py).

* ground removal: inter-ring pitch test <= 10 degrees on the low beams
  (LeGO-LOAM groundRemoval, imageProjection.cpp:291-348);
* cluster segmentation: LeGO labels components by a per-pixel BFS with the
  angle criterion atan2(d2 sin a, d1 - d2 cos a) > 60 deg (labelComponents
  :429-538) and rejects clusters of < 30 points unless they span >= 3 rings.

The BFS is sequential; as in the reference, the labels come from parallel
min-label propagation with one pointer jump a round, run for exactly
`n_prop_rounds` rounds. It does not converge on large clusters, and the size
and ring-span statistics depend on that partial state, so the rounds are
repeated as they are: no fixed-point iteration, no early exit.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .cloud import ScanGrid

_I32_MAX = torch.iinfo(torch.int32).max
_I32_MIN = torch.iinfo(torch.int32).min


class SegmentationConfig(NamedTuple):
    ground_rings: int = 7  # groundScanInd: only low beams can seed ground
    ground_angle_deg: float = 10.0  # sensorMountAngle tolerance
    cluster_angle_deg: float = 60.0  # segmentTheta
    min_cluster: int = 30  # feasibleSegment size threshold
    min_cluster_lines: int = 3  # or >= 5 points spanning >= 3 rings
    min_cluster_small: int = 5
    n_prop_rounds: int = 12  # label-propagation rounds (log2 diameter + slack)


class SegmentedScan(NamedTuple):
    ground: torch.Tensor  # (R,W) bool
    segmented: torch.Tensor  # (R,W) bool: member of a valid (big) cluster
    labels: torch.Tensor  # (R,W) int32 cluster representative index


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-d f32 constant on `like`'s device, filled there (no host copy)."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


def ground_removal(scan: ScanGrid, cfg: SegmentationConfig) -> torch.Tensor:
    """Ground mask: for the low rings, the vector to the next ring up is
    within ground_angle of horizontal (imageProjection.cpp:291-348)."""
    xyz, mask = scan.xyz, scan.mask
    d = torch.roll(xyz, -1, dims=0) - xyz  # to ring i+1, same column
    up_mask = torch.roll(mask, -1, dims=0)
    dx, dy, dz = d.unbind(-1)
    angle = torch.rad2deg(torch.atan2(dz, torch.sqrt(dx ** 2 + dy ** 2) + 1e-9))
    pair_ok = mask & up_mask & (torch.abs(angle) <= cfg.ground_angle_deg)
    low = torch.arange(scan.rings, device=xyz.device)[:, None] < cfg.ground_rings
    g = pair_ok & low
    # both endpoints of a qualifying pair are ground (the reference marks i and i+1)
    g = g | torch.roll(g, 1, dims=0)
    return g & mask


def _connected(r_a: torch.Tensor, r_b: torch.Tensor, alpha: torch.Tensor,
               thresh_rad: torch.Tensor) -> torch.Tensor:
    """LeGO angle criterion between two neighbouring range pixels."""
    d1 = torch.maximum(r_a, r_b)
    d2 = torch.minimum(r_a, r_b)
    beta = torch.atan2(d2 * torch.sin(alpha), d1 - d2 * torch.cos(alpha) + 1e-9)
    return beta > thresh_rad


def segment_clusters(scan: ScanGrid, ground: torch.Tensor,
                     cfg: SegmentationConfig) -> SegmentedScan:
    R, W = scan.rings, scan.width
    n = R * W
    dev = scan.xyz.device
    r = torch.linalg.vector_norm(scan.xyz, dim=-1)
    valid = scan.mask & ~ground

    # the reference's f32 constants: the angles are rounded to f32 before
    # their sine and cosine
    alpha_h = _f32(2.0 * math.pi / W, r)
    alpha_v = _f32(math.radians(2.0), r)  # approx vertical resolution
    th = _f32(math.radians(cfg.cluster_angle_deg), r)

    # connectivity to the 4 neighbours (azimuth wraps, rings do not)
    right_ok = (valid & torch.roll(valid, -1, dims=1)
                & _connected(r, torch.roll(r, -1, dims=1), alpha_h, th))
    up_ok = (valid & torch.roll(valid, -1, dims=0)
             & _connected(r, torch.roll(r, -1, dims=0), alpha_v, th))
    up_ok[-1].fill_(False)  # no ring wraparound (fill_: no host copy)
    left_ok = torch.roll(right_ok, 1, dims=1)  # symmetric edges
    down_ok = torch.roll(up_ok, 1, dims=0)

    sentinel = torch.full((R, W), n, dtype=torch.int32, device=dev)
    labels = torch.where(valid, torch.arange(n, dtype=torch.int32, device=dev).reshape(R, W),
                         sentinel)
    tail = torch.full((1,), n, dtype=torch.int32, device=dev)
    for _ in range(cfg.n_prop_rounds):
        m = labels
        for ok, shifted in ((right_ok, torch.roll(labels, -1, dims=1)),
                            (left_ok, torch.roll(labels, 1, dims=1)),
                            (up_ok, torch.roll(labels, -1, dims=0)),
                            (down_ok, torch.roll(labels, 1, dims=0))):
            m = torch.minimum(m, torch.where(ok, shifted, m))
        # pointer jumping: follow the representative's own label
        padded = torch.cat([m.reshape(-1), tail])
        m = torch.minimum(m, padded[m.long()])
        labels = torch.where(valid, m, sentinel)

    # cluster statistics (sizes and ring spans) by segment reductions over
    # n + 1 segments; an empty segment keeps the int32 extremes it starts from
    flat = labels.reshape(-1).long()
    ones = valid.reshape(-1).to(torch.int32)
    sizes = torch.zeros((n + 1,), dtype=torch.int32, device=dev).index_add_(0, flat, ones)
    ring_id = torch.arange(R, dtype=torch.int32, device=dev)[:, None].expand(R, W).reshape(-1)
    member = ones > 0
    rmin = torch.full((n + 1,), _I32_MAX, dtype=torch.int32, device=dev).scatter_reduce_(
        0, flat, torch.where(member, ring_id, torch.full_like(ring_id, R)), "amin")
    rmax = torch.full((n + 1,), _I32_MIN, dtype=torch.int32, device=dev).scatter_reduce_(
        0, flat, torch.where(member, ring_id, torch.full_like(ring_id, -1)), "amax")
    span = rmax - rmin + 1  # wraps (never read) on empty segments
    big = sizes >= cfg.min_cluster
    tall = (sizes >= cfg.min_cluster_small) & (span >= cfg.min_cluster_lines)
    good = big | tall
    segmented = valid & good[flat].reshape(R, W)
    return SegmentedScan(ground, segmented, labels)


def segment_scan(scan: ScanGrid, cfg: SegmentationConfig = SegmentationConfig()) -> SegmentedScan:
    g = ground_removal(scan, cfg)
    return segment_clusters(scan, g, cfg)
