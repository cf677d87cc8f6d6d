"""The packed-key row index of a hashed voxel-block map
(port of the `ktab` half of agi_lidar_slam_tpu/map/planar.py).

The octant-KNN kernel (nn/octant_knn.py) resolves each (query, octant) probe
window to ONE map row by comparing packed block keys against this index, then
reads that row's points and occupancy straight from the HashVoxelMap. The
reference's poison-padded, lane-aligned point-plane table is a TPU VMEM
layout and has no counterpart here.
"""

from __future__ import annotations

import torch

from .hash_map import EMPTY_KEY, HashVoxelMap, pack_key


def build_ktab(m: HashVoxelMap) -> torch.Tensor:
    """(rows,) int32: each row's pack_key, -1 where the row is empty. Packed
    keys are non-negative, so -1 never matches a probe."""
    live = m.keys[:, 0] != EMPTY_KEY
    return torch.where(live, pack_key(m.keys), torch.full_like(m.keys[:, 0], -1)).contiguous()
