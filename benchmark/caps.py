"""How often a configuration's capacities bind on the cell's own sweeps: a
report for the traced run's standard error. An adapter that has capacities
to report gives `capacities(config, lap)` -> {stage: (capacity, [count of
each sweep checked])}, worked out with its plain reference, not with the
program; one without reports nothing.
"""

from __future__ import annotations

import torch

from benchmark.reference.voxel import _INVALID_KEY, voxel_keys


def occupied(xyz: torch.Tensor, mask: torch.Tensor, voxel: float) -> int:
    """Occupied voxels of the masked points."""
    key = voxel_keys(xyz, mask, voxel)
    return int(torch.unique(key[key != _INVALID_KEY]).numel())


def report(caps: dict) -> str:
    parts = []
    for stage, (cap, n) in caps.items():
        over = sum(v > cap for v in n)
        parts.append(f"{stage}: {min(n)}-{max(n)} voxels against {cap}, over it in {over} "
                     f"of {len(n)} sweeps")
    return "feature capacities: " + "; ".join(parts)
