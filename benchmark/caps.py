"""How often the configuration's feature capacities bind on the cell's own
sweeps: a report for the traced run's standard error, worked out with the
plain reference (benchmark/reference/), not with the program.

The scan body keeps at most `features.max_surfs` voxels of the surf
candidates at `features.surf_voxel`, then downsamples the corners at
`corner_ds_voxel` into `features.max_corners` voxels and the surfs at
`surf_ds_voxel` into `features.max_surfs`; a voxel past a capacity is
dropped. Each count here is the number of occupied voxels before the cap.
"""

from __future__ import annotations

import dataclasses

import torch

from benchmark import check
from benchmark.reference.cloud import ScanGrid
from benchmark.reference.curvature import extract_features_timed
from benchmark.reference.voxel import _INVALID_KEY, voxel_keys


def occupied(xyz: torch.Tensor, mask: torch.Tensor, voxel: float) -> int:
    """Occupied voxels of the masked points."""
    key = voxel_keys(xyz, mask, voxel)
    return int(torch.unique(key[key != _INVALID_KEY]).numel())


def feature_caps(pipeline: dict, lap, every: int = 8) -> dict:
    """{stage: (capacity, [occupied voxels of each sweep])} over every
    `every`-th sweep of the lap."""
    cfg = check.reference_config(pipeline)
    f = cfg.features
    R, W = lap.xyz.shape[1:3]
    wide = dataclasses.replace(f, max_surfs=R * W)
    out = {"surfs at surf_voxel": (f.max_surfs, []),
           "corners at corner_ds_voxel": (f.max_corners, []),
           "surfs at surf_ds_voxel": (f.max_surfs, [])}
    for j in range(0, lap.n, every):
        feats = extract_features_timed(ScanGrid(lap.xyz[j], lap.mask[j], lap.time[j]), wide)
        s = feats.surfs
        out["surfs at surf_voxel"][1].append(int(s.mask.sum()))
        out["corners at corner_ds_voxel"][1].append(
            occupied(feats.corners.xyz, feats.corners.mask, cfg.corner_ds_voxel))
        # the capped output is the first max_surfs voxels in key order
        out["surfs at surf_ds_voxel"][1].append(
            occupied(s.xyz[:f.max_surfs], s.mask[:f.max_surfs], cfg.surf_ds_voxel))
    return out


def report(caps: dict) -> str:
    parts = []
    for stage, (cap, n) in caps.items():
        over = sum(v > cap for v in n)
        parts.append(f"{stage}: {min(n)}-{max(n)} voxels against {cap}, over it in {over} "
                     f"of {len(n)} sweeps")
    return "feature capacities: " + "; ".join(parts)
