"""Carry engine state and worlds between the JAX package and the port.

`state_from_numpy` takes the JAX EngineState as nested numpy arrays (for
example `jax.tree.map(np.asarray, state)`, or nested dicts with the same
field names) and builds the port's EngineState on a device; `state_to_numpy`
goes the other way, as nested dicts; `world_from_numpy` builds a BoxWorld.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from .geometry.se3 import Pose
from .map.hash_map import HashVoxelMap
from .pointcloud.cloud import PointBatch
from .runtime.pipeline import EngineState
from .sim.world import BoxWorld


def _field(node, name):
    return node[name] if isinstance(node, Mapping) else getattr(node, name)


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).to(device)  # np.array copies read-only views


def state_from_numpy(tree, device=None) -> EngineState:
    """The port's EngineState from a numpy EngineState tree."""
    def pose(node):
        return Pose(_tensor(_field(node, "q"), device), _tensor(_field(node, "t"), device))

    def hmap(node):
        return HashVoxelMap(*(_tensor(_field(node, f), device) for f in HashVoxelMap._fields))

    def batch(node):
        return PointBatch(_tensor(_field(node, "xyz"), device),
                          _tensor(_field(node, "mask"), device))

    return EngineState(
        pose=pose(_field(tree, "pose")),
        prev_pose=pose(_field(tree, "prev_pose")),
        corner_map=hmap(_field(tree, "corner_map")),
        surf_map=hmap(_field(tree, "surf_map")),
        frame=_tensor(_field(tree, "frame"), device),
        prev_corners=batch(_field(tree, "prev_corners")),
        prev_surfs=batch(_field(tree, "prev_surfs")),
    )


def state_to_numpy(state: EngineState) -> dict:
    """Nested dicts of numpy arrays with the EngineState field names."""
    def walk(node):
        if isinstance(node, torch.Tensor):
            return node.detach().cpu().numpy()
        return {f: walk(getattr(node, f)) for f in node._fields}

    return walk(state)


def world_from_numpy(lo, hi, device=None) -> BoxWorld:
    """A BoxWorld from (M,3) box minima and maxima."""
    return BoxWorld(_tensor(np.asarray(lo, np.float32), device),
                    _tensor(np.asarray(hi, np.float32), device))
