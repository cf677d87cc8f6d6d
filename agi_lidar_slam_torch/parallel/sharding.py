"""Multi-device engine steps over torch.distributed (port of
agi_lidar_slam_tpu/parallel/sharding.py).

The reference splits each scan's POINT axis over the mesh axis "dp" inside
`shard_map`, and psums the normal equations. Here every rank is a process
holding the same state: it builds the features, downsamples and inserts
exactly as one process does, and inside the solver it works on its
contiguous block of each point batch (rank r of n owns rows
[r*N/n, (r+1)*N/n) of the padded batch, as shard_map splits it); the partial
sums complete with one all_reduce (`parallel/distributed.allsum`). Every
rank then takes the same step, so the states never diverge. The steps are
the engines' own bodies with their solver, update or insert operations
swapped, not forks:

* `sharded_scan_step`: runtime.pipeline._process_scan_body with both
  scan-to-map solvers (and the odometry stage's) point-sharded;
* `sharded_scan_step_mp`: the same body against a slot-sharded map ("mp",
  parallel/map_shard.py): merged KNN, owned-row inserts, sharded bound;
* `sharded_lio_step`, `sharded_livox_step`, `sharded_liosam_step`: the IMU
  engines' bodies with their IESKF update, window solve and scan-to-map
  solve point-sharded.

A mesh is a torch `DeviceMesh` (`make_mesh`, distributed.make_mesh_2d); the
group of a dimension, `mesh.get_group(name)`, stands where the reference
names `axis_name`. `replicate` makes the tensors of a state equal on every
rank by broadcasting rank 0's. The point axis of every sharded batch must
divide by the group's size.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch
import torch.distributed as dist

from ..config import PipelineConfig
from ..estimators.gn_scan2map import GnStats, solve_scan2map
from ..estimators.ieskf import update_iterated
from ..estimators.two_step import solve_scan2map_two_step
from ..estimators.window_map import solve_window
from ..geometry import se3
from ..map.hash_map import HashVoxelMap
from ..pointcloud.cloud import PointBatch
from ..runtime.lio_pipeline import _process_lio_body
from ..runtime.liosam_pipeline import _process_liosam_body
from ..runtime.livox_pipeline import _process_livox_body
from ..runtime.pipeline import _process_scan_body
from .distributed import broadcast_, local_device, rank_and_size, use_device
from .map_shard import sharded_bound, sharded_insert, sharded_knn


def make_mesh(device=None):
    """1-D DeviceMesh "dp" over every rank of the process group (cuda unless
    `device` names the CPU). The reference's `n_devices` (a mesh over the
    first devices) has no counterpart: a mesh spans the process group."""
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size()
    dtype = "cuda" if device is None else torch.device(device).type
    if dtype == "cuda":
        use_device(local_device())
    return init_device_mesh(dtype, (n,), mesh_dim_names=("dp",))


def _block(x: torch.Tensor, rank: int, n: int, dim: int = 0) -> torch.Tensor:
    """Rank `rank`'s contiguous block of `n` along `dim`."""
    size = x.shape[dim]
    if size % n:
        raise ValueError(f"a point axis of {size} does not divide over {n} ranks")
    b = size // n
    return x.narrow(dim, rank * b, b)


def _shard_batch(batch: PointBatch, group, dim: int = 0) -> PointBatch:
    rank, n = rank_and_size(group)
    return PointBatch(_block(batch.xyz, rank, n, dim), _block(batch.mask, rank, n, dim))


def shard_points(batch: PointBatch, mesh, axis: str = "dp") -> PointBatch:
    """This rank's block of a padded point batch (P("dp") on the point axis)."""
    return _shard_batch(batch, mesh.get_group(axis))


def replicate(tree, mesh):
    """A copy of `tree` (nested tuples, NamedTuples, lists and dicts of
    tensors) holding rank 0's values on every rank of the mesh: each tensor
    is broadcast over each mesh dimension in turn. Leaves that are not
    tensors stay as they are."""
    groups = [mesh.get_group(name) for name in mesh.mesh_dim_names]

    def rep(x):
        if isinstance(x, torch.Tensor):
            x = x.clone()
            for g in groups:
                broadcast_(x, g)
            return x
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(rep(v) for v in x))
        if isinstance(x, (tuple, list)):
            return type(x)(rep(v) for v in x)
        if isinstance(x, dict):
            return {k: rep(v) for k, v in x.items()}
        return x

    return rep(tree)


def _sharded_solver(mesh, axis: str, fn):
    """A scan-to-map solver (solve_scan2map / solve_scan2map_two_step) with
    the feature point axis (and the deskew times) split over the `axis`
    group and the normal equations completed over it (the solver's `group`
    hook). The maps and pose are whole on every rank; so is the result."""
    group = mesh.get_group(axis)

    def solver(pose0, corners, surfs, cmap, smap, cmap_cfg, smap_cfg, cfg, deskew=None):
        rank, n = rank_and_size(group)
        if deskew is not None:
            tau_c, tau_s, prev_pose = deskew
            deskew = (_block(tau_c, rank, n), _block(tau_s, rank, n), prev_pose)
        return fn(pose0, _shard_batch(corners, group), _shard_batch(surfs, group), cmap, smap,
                  cmap_cfg, smap_cfg, cfg, deskew=deskew, group=group)

    return solver


def sharded_gn_solve(
    mesh,
    pose0: se3.Pose,
    corners: PointBatch,
    surfs: PointBatch,
    corner_map: HashVoxelMap,
    surf_map: HashVoxelMap,
    cfg: PipelineConfig,
) -> Tuple[se3.Pose, GnStats]:
    """Iterated scan-to-map GN with the point axis split over "dp": each rank
    associates its block of points against the (whole) maps and the 6x6
    normal equations complete with one all_reduce per inner iteration. This
    is estimators.gn_scan2map.solve_scan2map with its `group` hook."""
    return _sharded_solver(mesh, "dp", solve_scan2map)(
        pose0, corners, surfs, corner_map, surf_map, cfg.corner_map, cfg.surf_map, cfg.solver)


def sharded_scan_step(mesh, state, scan, cfg: PipelineConfig):
    """runtime.pipeline.process_scan with the point axis split over "dp":
    the same body, with the odometry stage's and the scan-to-map solves
    (in-solver deskew and two_step included) sharded. Features, downsample
    and map updates run alike on every rank, so the maps never diverge."""
    return _process_scan_body(state, scan, cfg,
                              solve_fn=_sharded_solver(mesh, "dp", solve_scan2map),
                              solve_two_fn=_sharded_solver(mesh, "dp", solve_scan2map_two_step))


def sharded_lio_step(mesh, state, pts_l, pts_t, pts_mask, imu, cfg):
    """runtime.lio_pipeline.process_lio_scan with the measurement point axis
    split over "dp": IMU propagation, undistortion and downsampling run alike
    on every rank; the iterated IESKF update associates and linearizes each
    rank's block of the downsampled cloud, the 12x12 HtH / Htr completing
    with one all_reduce per iteration (esekfom.hpp:114-117); the 24x24 solve,
    the state update and the map insert run alike."""
    group = mesh.get_group("dp")

    def update_fn(x_prop, P_prop, ds, smap, map_cfg, icfg):
        return update_iterated(x_prop, P_prop, _shard_batch(ds, group), smap, map_cfg, icfg,
                               group=group)

    return _process_lio_body(state, pts_l, pts_t, pts_mask, imu, cfg, update_fn=update_fn)


def sharded_livox_step(mesh, state, scan, imu, cfg):
    """runtime.livox_pipeline.process_livox_scan with each frame's feature
    point axes (the N of the (F, N) corner, surf and non-feature arrays)
    split over "dp": preprocessing, preintegration, marginalization and the
    map inserts run alike on every rank; the window solve's per-frame lidar
    blocks complete with one all_reduce per linearization (the reference's
    std::thread residual builders, Estimator.cpp:1019-1050)."""
    group = mesh.get_group("dp")

    def solve_fn(ws, corners, surfs, cmap, smap, preints, prior, grav, cmap_cfg, smap_cfg, scfg,
                 lidar_weight, others=None, other_map=None, omap_cfg=None,
                 nonfeature_weight=10.0):
        if others is not None:
            others = _shard_batch(others, group, dim=1)
        return solve_window(ws, _shard_batch(corners, group, dim=1),
                            _shard_batch(surfs, group, dim=1), cmap, smap, preints, prior, grav,
                            cmap_cfg, smap_cfg, scfg, lidar_weight, others=others,
                            other_map=other_map, omap_cfg=omap_cfg,
                            nonfeature_weight=nonfeature_weight, group=group)

    return _process_livox_body(state, scan, imu, cfg, solve_fn=solve_fn)


def sharded_liosam_step(mesh, state, scan, imu, cfg):
    """runtime.liosam_pipeline.process_liosam_scan with the scan-to-map GN's
    feature point axis split over "dp" (the solver of sharded_scan_step);
    preintegration, the 15-dim fusion and the map updates run alike."""
    return _process_liosam_body(state, scan, imu, cfg,
                                solve_fn=_sharded_solver(mesh, "dp", solve_scan2map))


def sharded_scan_step_mp(mesh, state, scan, cfg: PipelineConfig):
    """runtime.pipeline.process_scan against slot-sharded maps ("mp"), the
    scale-out for maps larger than one card's memory: association through
    the merged KNN (map_shard.sharded_knn), map updates through
    sharded_insert and sharded_bound. state.corner_map / surf_map are this
    rank's parts (map_shard.shard_map_arrays). The insert drop count is not
    kept on this path: n_dropped reports 0."""
    def knn_fn(m, q, qm, k, mcfg, ktab=None):
        return sharded_knn(mesh, m, q, qm, k, mcfg)

    def insert_fn(m, xyz, mask, mcfg):
        return (sharded_insert(mesh, m, xyz, mask, mcfg),
                torch.zeros((), dtype=torch.int32, device=xyz.device))

    def bound_fn(m, center, radius, mcfg):
        return sharded_bound(mesh, m, center, radius, mcfg)

    return _process_scan_body(
        state, scan, cfg, solve_fn=functools.partial(solve_scan2map, knn_fn=knn_fn),
        solve_two_fn=functools.partial(solve_scan2map_two_step, knn_fn=knn_fn),
        insert_fn=insert_fn, bound_fn=bound_fn)
