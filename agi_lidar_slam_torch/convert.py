"""Carry configs, engine state and worlds between the JAX package and the port.

`config_from_reference` copies a reference config into the port's class of
the same name, field by field. `state_from_numpy`, `nav_state_from_numpy` and
`lio_state_from_numpy`, `slam_state_from_numpy`, `liosam_state_from_numpy` and
`livox_state_from_numpy` take the JAX EngineState / NavState / LioState /
SlamState / LioSamState / LivoxState as
nested numpy arrays (for example `jax.tree.map(np.asarray, state)`, or nested
dicts with the same field names) and build the port's on a device;
`state_to_numpy` goes the other way, as nested dicts; `world_from_numpy`
builds a BoxWorld. Nothing here imports the JAX package: the inputs are duck
typed. Tensors land on `device`, cuda unless the caller passes another.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import numpy as np
import torch

from . import config
from .device import default_device
from .estimators.ieskf import IeskfConfig
from .estimators.window_map import MarginalPrior, WindowState
from .features.dynamic_removal import DynamicRemovalConfig
from .features.livox import LivoxFeatureConfig
from .features.mount_calib import MountState
from .features.segmentation import SegmentationConfig
from .geometry.se3 import Pose
from .graph.keyframes import KeyframeBank
from .graph.loop_closure import LoopConfig
from .graph.pose_graph import EdgeSet
from .imu.eskf import EskfNoise, NavState
from .imu.preintegration import ImuNoise
from .map.hash_map import HashVoxelMap
from .pointcloud.cloud import PointBatch
from .presets import LioSamRefParams
from .runtime.liosam_pipeline import LioSamConfig, LioSamState
from .runtime.lio_pipeline import LioConfig, LioState
from .runtime.livox_pipeline import LivoxConfig, LivoxState
from .runtime.pipeline import EngineState
from .runtime.slam_pipeline import SlamConfig, SlamState
from .sim.world import BoxWorld

_CONFIG_CLASSES = {cls.__name__: cls for cls in (
    config.FeatureConfig, config.MapConfig, config.SolverConfig, config.PipelineConfig,
    IeskfConfig, EskfNoise, LioConfig, LoopConfig, SlamConfig, ImuNoise, LioSamConfig,
    LivoxConfig, LivoxFeatureConfig, DynamicRemovalConfig, SegmentationConfig,
    LioSamRefParams)}


def config_from_reference(obj):
    """The port's config of the same class name as `obj` (a reference
    dataclass or NamedTuple), with every field copied by name; nested configs
    are converted too."""
    name = type(obj).__name__
    if name not in _CONFIG_CLASSES:
        raise TypeError(f"no port config named {name!r}")
    names = ([f.name for f in dataclasses.fields(obj)] if dataclasses.is_dataclass(obj)
             else list(obj._fields))

    def value(v):
        return config_from_reference(v) if type(v).__name__ in _CONFIG_CLASSES else v

    return _CONFIG_CLASSES[name](**{f: value(getattr(obj, f)) for f in names})


def _field(node, name):
    return node[name] if isinstance(node, Mapping) else getattr(node, name)


def _tensor(a, device) -> torch.Tensor:
    # np.array copies read-only views
    return torch.from_numpy(np.array(a)).to(default_device(device))


def _tuple(cls, node, device):
    """A NamedTuple of tensors of class `cls` from a numpy tree of its fields."""
    return cls(*(_tensor(_field(node, f), device) for f in cls._fields))


def _hmap(node, device) -> HashVoxelMap:
    return _tuple(HashVoxelMap, node, device)


def state_from_numpy(tree, device=None) -> EngineState:
    """The port's EngineState from a numpy EngineState tree."""
    return EngineState(
        pose=_tuple(Pose, _field(tree, "pose"), device),
        prev_pose=_tuple(Pose, _field(tree, "prev_pose"), device),
        corner_map=_hmap(_field(tree, "corner_map"), device),
        surf_map=_hmap(_field(tree, "surf_map"), device),
        frame=_tensor(_field(tree, "frame"), device),
        prev_corners=_tuple(PointBatch, _field(tree, "prev_corners"), device),
        prev_surfs=_tuple(PointBatch, _field(tree, "prev_surfs"), device),
    )


def nav_state_from_numpy(tree, device=None) -> NavState:
    """The port's NavState from a numpy NavState tree."""
    return _tuple(NavState, tree, device)


def lio_state_from_numpy(tree, device=None) -> LioState:
    """The port's LioState (NavState, P, map, frame) from a numpy LioState tree."""
    return LioState(x=nav_state_from_numpy(_field(tree, "x"), device),
                    P=_tensor(_field(tree, "P"), device),
                    map=_hmap(_field(tree, "map"), device),
                    frame=_tensor(_field(tree, "frame"), device))


def slam_state_from_numpy(tree, device=None) -> SlamState:
    """The port's SlamState (engine, bank, edges, last_kf_idx) from a numpy
    SlamState tree."""
    return SlamState(engine=state_from_numpy(_field(tree, "engine"), device),
                     bank=_tuple(KeyframeBank, _field(tree, "bank"), device),
                     edges=_tuple(EdgeSet, _field(tree, "edges"), device),
                     last_kf_idx=_tensor(_field(tree, "last_kf_idx"), device))


def liosam_state_from_numpy(tree, device=None) -> LioSamState:
    """The port's LioSamState (engine, v, bg, ba, P, grav) from a numpy
    LioSamState tree."""
    return LioSamState(state_from_numpy(_field(tree, "engine"), device),
                       *(_tensor(_field(tree, f), device) for f in LioSamState._fields[1:]))


def livox_state_from_numpy(tree, device=None) -> LivoxState:
    """The port's LivoxState (window, embedded prior, the three feature
    batches and maps, gravity, frame, mount state) from a numpy LivoxState
    tree."""
    return LivoxState(
        ws=_tuple(WindowState, _field(tree, "ws"), device),
        prior=_tuple(MarginalPrior, _field(tree, "prior"), device),
        **{f: _tuple(PointBatch, _field(tree, f), device) for f in ("corners", "surfs", "others")},
        **{f: _hmap(_field(tree, f), device) for f in ("corner_map", "surf_map", "other_map")},
        grav=_tensor(_field(tree, "grav"), device), frame=_tensor(_field(tree, "frame"), device),
        mount=_tuple(MountState, _field(tree, "mount"), device))


def state_to_numpy(state) -> dict:
    """Nested dicts of numpy arrays with the state's field names (any
    NamedTuple tree of tensors: EngineState, LioState, NavState)."""
    def walk(node):
        if isinstance(node, torch.Tensor):
            return node.detach().cpu().numpy()
        return {f: walk(getattr(node, f)) for f in node._fields}

    return walk(state)


def world_from_numpy(lo, hi, device=None, vel=None) -> BoxWorld:
    """A BoxWorld from (M,3) box minima and maxima, and the boxes' (M,3)
    velocities where the world has movers."""
    return BoxWorld(_tensor(np.asarray(lo, np.float32), device),
                    _tensor(np.asarray(hi, np.float32), device),
                    None if vel is None else _tensor(np.asarray(vel, np.float32), device))
