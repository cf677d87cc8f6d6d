"""Checkpoint / resume / map export (port of
agi_lidar_slam_tpu/io/checkpoint.py).

Reference parity:
* LIO-SAM save_map service (srv/save_map.srv; mapOptmization.cpp:486-573)
  writes trajectory + corner/surf/global PCDs -> `export_pcd` + `save_state`;
* S-FAST_LIO relocalization (laserMapping_re.cpp: loads a prior map PCD at
  startup and seeds the pose from init_pos/init_rot params)
  -> `relocalize_state` builds an EngineState with prebuilt hashed maps and
  a seed pose.

States are trees of NamedTuples of tensors (EngineState / LioState /
SlamState ...); serialization is a flat npz keyed by tree path, with the JAX
package's keys (`.pose/.t`, `.corner_map/.points`, ...: the `str()` of
`jax.tree_util.tree_flatten_with_path`'s keys, joined by "/"). So a
checkpoint written by either package loads into the other's template.
"""

from __future__ import annotations

import os
from typing import Any, Iterator, Tuple

import numpy as np
import torch

from ..device import default_device, host_to_device


def _leaves(tree: Any, path: Tuple[str, ...] = ()) -> Iterator[Tuple[str, Any]]:
    """(key, leaf) pairs in flattening order: NamedTuple fields as `.name`,
    sequence items as `[i]`, dict entries as `['k']`; None is no leaf."""
    if tree is None:
        return
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from _leaves(getattr(tree, f), path + (f".{f}",))
    elif isinstance(tree, (tuple, list)):
        for i, x in enumerate(tree):
            yield from _leaves(x, path + (f"[{i}]",))
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (f"[{k!r}]",))
    else:
        yield "/".join(path), tree


def _rebuild(tree: Any, leaves: Iterator) -> Any:
    """`tree` with each leaf replaced by the next of `leaves`, in the order
    of `_leaves`."""
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(getattr(tree, f), leaves) for f in tree._fields))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(x, leaves) for x in tree)
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
    return next(leaves)


def _flatten_keys(tree: Any) -> dict:
    """{key: numpy array} of every leaf of `tree` (tensors copied to the host)."""
    return {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in _leaves(tree)}


def save_state(path: str, state: Any) -> None:
    """Serialize any engine-state tree to one .npz file."""
    np.savez_compressed(path, **_flatten_keys(state))


def load_state(path: str, template: Any) -> Any:
    """Restore a tree saved by save_state (by this package or the JAX one);
    `template` supplies the structure (e.g. `init_state(cfg, device)` with a
    matching config) and each leaf's device. Leaves keep the saved dtype."""
    data = np.load(path)
    arrays = []
    for key, leaf in _leaves(template):
        if key not in data:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = data[key]
        if arr.shape != tuple(leaf.shape):
            raise ValueError(
                f"checkpoint leaf {key!r} shape {arr.shape} != template {tuple(leaf.shape)}")
        arrays.append(host_to_device(np.array(arr), leaf.device))
    return _rebuild(template, iter(arrays))


def map_to_points(m) -> np.ndarray:
    """Extract occupied map points (N,3) from a HashVoxelMap (host-side)."""
    pts = m.points[:-1].reshape(-1, 3).cpu().numpy()
    occ = m.occ[:-1].reshape(-1).cpu().numpy()
    return pts[occ]


def export_pcd(path: str, points) -> None:
    """Write an ASCII PCD v0.7 file (the reference's pcl::io::savePCDFile
    output format; readable by pcl/CloudCompare/open3d)."""
    if isinstance(points, torch.Tensor):
        points = points.detach().cpu().numpy()
    points = np.asarray(points, dtype=np.float32).reshape(-1, 3)
    n = points.shape[0]
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\n"
        f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\nDATA ascii\n"
    )
    with open(path, "w") as f:
        f.write(header)
        np.savetxt(f, points, fmt="%.5f")


def read_pcd(path: str) -> np.ndarray:
    """Read an ASCII x/y/z PCD (enough for reloading our own exports and the
    reference's saved maps)."""
    pts = []
    with open(path) as f:
        in_data = False
        for line in f:
            if in_data:
                vals = line.split()
                if len(vals) >= 3:
                    pts.append([float(v) for v in vals[:3]])
            elif line.startswith("DATA"):
                if "ascii" not in line:
                    raise ValueError("only ascii PCD supported")
                in_data = True
    return np.asarray(pts, dtype=np.float32)


def save_map_bundle(out_dir: str, state, trajectory=None) -> None:
    """LIO-SAM saveMapService analog: write corner/surf/global PCDs (+ the
    trajectory) from an EngineState-like object with corner_map/surf_map."""
    os.makedirs(out_dir, exist_ok=True)
    corner = map_to_points(state.corner_map)
    surf = map_to_points(state.surf_map)
    export_pcd(os.path.join(out_dir, "CornerMap.pcd"), corner)
    export_pcd(os.path.join(out_dir, "SurfMap.pcd"), surf)
    export_pcd(os.path.join(out_dir, "GlobalMap.pcd"),
               np.concatenate([corner, surf], axis=0))
    if trajectory is not None:
        export_pcd(os.path.join(out_dir, "trajectory.pcd"), trajectory)


def _all_points(points, device):
    pts = host_to_device(np.asarray(points, np.float32).reshape(-1, 3), device)
    return pts, torch.ones((pts.shape[0],), dtype=torch.bool, device=device)


def relocalize_state(cfg, corner_points, surf_points, init_pose=None, device=None):
    """An EngineState on `device` (default: cuda) whose maps are prefilled
    from a prior map and whose pose is seeded (S-FAST_LIO
    laserMapping_re.cpp:350,541-589)."""
    from ..geometry import se3
    from ..map.hash_map import insert
    from ..runtime.pipeline import init_state

    device = default_device(device)
    state = init_state(cfg, device)
    cmap = insert(state.corner_map, *_all_points(corner_points, device), cfg.corner_map)
    smap = insert(state.surf_map, *_all_points(surf_points, device), cfg.surf_map)
    pose = (se3.Pose.identity(device=device) if init_pose is None
            else se3.Pose(*(a.to(device) for a in init_pose)))
    prev = se3.Pose(pose.q.clone(), pose.t.clone())
    return state._replace(corner_map=cmap, surf_map=smap, pose=pose, prev_pose=prev)


def relocalize_lio_state(cfg, map_points, init_pose=None, device=None):
    """LioState on `device` (default: cuda) localized in a prior map — the
    direct laserMapping_re analog (S-FAST_LIO loads GlobalMap.pcd at startup
    :350 and seeds pos/rot from the mapping/init_* params :541-589). `cfg`
    is a LioConfig; `init_pose` an se3.Pose seed for the IMU body frame."""
    from ..map.hash_map import insert
    from ..runtime.lio_pipeline import init_lio_state

    device = default_device(device)
    state = init_lio_state(cfg, device=device)
    m = insert(state.map, *_all_points(map_points, device), cfg.map)
    x = state.x
    if init_pose is not None:
        x = x._replace(p=init_pose.t.to(device), q=init_pose.q.to(device))
    return state._replace(map=m, x=x)
