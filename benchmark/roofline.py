"""The table of peaks and the operations and bytes a kernel call must spend:
the yardstick of every `<kernel>_roofline` metric.

Copied from agi_lidar_slam_torch/tools/profile_engines.py at commit 88e7c49
(`PUBLISHED_PEAKS`, `bound`, `knn_work`), so that later changes to the
program's profiler cannot move it; `knn_work` takes the probe keys from the
benchmark's own plain octant KNN (benchmark/reference/octant_knn.py).
"""

from __future__ import annotations

import torch

from benchmark.reference.octant_knn import octant_probe_keys
from benchmark.reference.planar import build_ktab

# NVIDIA's data sheet, H100 SXM, dense rates, at the 700 W power limit
PEAKS = {"H100": {"hbm_bytes_per_s": 3.35e12, "f32_flops": 67e12}}


def peaks(device_name: str) -> dict:
    for key, value in PEAKS.items():
        if key in device_name:
            return value
    raise ValueError(f"no published peaks for {device_name!r}: a roofline needs them")


def bound_ms(n_bytes: float, flops: float, device_name: str) -> float:
    """The least time (ms) the card could take: the larger of the bytes over
    the HBM rate and the f32 operations over the f32 rate."""
    p = peaks(device_name)
    return max(n_bytes / p["hbm_bytes_per_s"], flops / p["f32_flops"]) * 1e3


def knn_work(m, queries, qmask, k, cfg, ktab=None) -> tuple[int, int]:
    """(bytes, flops) one octant-KNN call must spend on these inputs: the
    queries, mask and outputs, each distinct probe-window entry of the
    packed-key index and each distinct map row the live queries hit (points
    + occupancy), read once; 8 flops (3 sub, 3 mul, 2 add) per candidate of
    a hit row. `m` is a map with `keys`, `points` and `occ`, `cfg` its
    MapConfig (sub_voxel, block_sub, probes, log2_slots)."""
    if ktab is None:
        ktab = build_ktab(m)
    qk, qh = octant_probe_keys(queries, cfg)
    live = qmask[:, None].expand_as(qh)
    win = qh[..., None].long() + torch.arange(cfg.probes, device=qh.device)
    n_win = int(torch.unique(win[live]).numel())
    match = ktab[win] == qk[..., None]
    rows = win[match & live[..., None]]
    n_rows = int(torch.unique(rows).numel())
    B = m.points.shape[1]
    n_bytes = (queries.numel() * 4 + qmask.numel() + n_win * 4 + n_rows * B * (12 + 1)
               + queries.shape[0] * k * (4 + 12 + 1))
    return n_bytes, 8 * int(rows.numel()) * B
