"""LeGO-LOAM two-step Gauss-Newton: planar step, then rotational step (port of
agi_lidar_slam_tpu/estimators/two_step.py).

LeGO-LOAM's featureAssociation.cpp splits the odometry solve:
* calculateTransformationSurf (:1573-1696): surf correspondences constrain
  (z, roll, pitch),
* calculateTransformationCorner (:1705-1815): corner correspondences
  constrain (x, y, yaw),
each with degeneracy projection (eigThre 10).

Both steps reuse the engine's association and normal equations and restrict
the 6x6 system to a 3-dof sub-block. In the delta ordering (dtheta_x,
dtheta_y, dtheta_z, dt_x, dt_y, dt_z):
  surf step   -> indices (0, 1, 5) = roll, pitch, z
  corner step -> indices (2, 3, 4) = yaw, x, y
Every inner iteration takes the surf step, then the corner step linearized
at the pose after it. On CPU tensors each step is the torch code, its 3x3
eigendecomposition `sym_eig` (torch.linalg.eigh). On CUDA tensors the normal
equations are gn_scan2map's (their rows one kernel) and the rest of a step,
from H and g on, one kernel (`_step`: gn_kernels.subset_step, the same
Jacobi code as the sym_eig kernel, the 3x3 solve, boxplus and the stats),
bit for bit the torch code (`_step_ref`).

`group` (the reference's `axis_name`) and `knn_fn` shard the point axis and
the map exactly as in gn_scan2map.solve_scan2map: each step's partial sums
complete with one all_reduce.
"""

from __future__ import annotations

import torch

from ..config import MapConfig, SolverConfig
from ..geometry import se3
from ..map.hash_map import HashVoxelMap
from ..parallel.distributed import allsum
from ..pointcloud.cloud import PointBatch
from . import gn_kernels
from .gn_scan2map import GnStats, _ktab, associate, normal_equations
from .sym_eig import sym_eig

_SURF_IDX = (0, 1, 5)
_CORNER_IDX = (2, 3, 4)


def _take(x: torch.Tensor, idx: tuple, dim: int) -> torch.Tensor:
    """Entries `idx` of `x` along `dim`, by slices (no index tensor to copy
    to the device)."""
    return torch.cat([x.narrow(dim, i, 1) for i in idx], dim=dim)


def _solve_subset(H: torch.Tensor, g: torch.Tensor, idx: tuple, eig_thresh: float):
    """Solve the 3-dof restriction of H d = -g with eigenvalue clamping.
    Returns (the full 6-vector, zero outside `idx`; whether any direction was
    clamped: the matP degeneracy flag of featureAssociation.cpp:1651-1678).
    Unlike solve_delta there is no translation clip."""
    Hs = _take(_take(H, idx, 0), idx, 1)
    gs = _take(g, idx, 0)
    vals, vecs = sym_eig(Hs)
    good = vals > eig_thresh
    inv = torch.where(good, 1.0 / torch.where(good, vals, torch.ones_like(vals)),
                      torch.zeros_like(vals))
    d = -(vecs * inv[None, :]) @ (vecs.T @ gs)
    zero = torch.zeros((1,), dtype=H.dtype, device=H.device)
    pos = {i: j for j, i in enumerate(idx)}
    full = torch.cat([d[pos[i]:pos[i] + 1] if i in pos else zero for i in range(6)])
    return full, ~torch.all(good)


def _step(H: torch.Tensor, g: torch.Tensor, idx: tuple, pose: se3.Pose, cfg: SolverConfig,
          sq: torch.Tensor, n_rows: torch.Tensor, prev: tuple | None = None):
    """One of the two steps from its normal equations: _solve_subset on the
    dofs `idx`, se3.boxplus, and the iteration's rms and degenerate flag,
    merged with the earlier step's `prev = (sq, n_rows, degenerate)` where
    given. Returns (pose, rms, degenerate). On CUDA tensors one kernel,
    gn_kernels.subset_step, bit for bit the torch code; on the CPU
    `_step_ref`."""
    if H.device.type == "cuda":
        return gn_kernels.subset_step(H, g, idx, cfg.degen_eig_thresh, pose, sq, n_rows, prev)
    return _step_ref(H, g, idx, pose, cfg, sq, n_rows, prev)


def _step_ref(H: torch.Tensor, g: torch.Tensor, idx: tuple, pose: se3.Pose, cfg: SolverConfig,
              sq: torch.Tensor, n_rows: torch.Tensor, prev: tuple | None = None):
    """`_step` as torch ops, on any device."""
    d, degen = _solve_subset(H, g, idx, cfg.degen_eig_thresh)
    if prev is not None:
        sq, n_rows, degen = prev[0] + sq, prev[1] + n_rows, prev[2] | degen
    return se3.boxplus(pose, d), torch.sqrt(sq / torch.clamp(n_rows, min=1.0)), degen


def solve_scan2map_two_step(
    pose0: se3.Pose,
    corners: PointBatch,
    surfs: PointBatch,
    corner_map: HashVoxelMap,
    surf_map: HashVoxelMap,
    cmap_cfg: MapConfig,
    smap_cfg: MapConfig,
    cfg: SolverConfig,
    deskew: tuple | None = None,
    group=None,
    knn_fn=None,
):
    """Iterated two-step GN (LeGO configuration). Returns (pose, GnStats) of
    the last inner iteration.

    `deskew = (corner_tau, surf_tau, prev_pose)` re-deskews the raw feature
    points at every outer pass with the current motion estimate, as in
    solve_scan2map. `group` (the reference's `axis_name`) and `knn_fn`: see
    solve_scan2map; group=None and knn_fn=None run the single-process code."""
    corner_ktab = _ktab(corner_map, cmap_cfg) if knn_fn is None else None
    surf_ktab = _ktab(surf_map, smap_cfg) if knn_fn is None else None
    pose = pose0
    dev = pose0.t.device
    stats = GnStats(torch.zeros((), dtype=torch.int32, device=dev),
                    torch.zeros((), dtype=torch.int32, device=dev),
                    torch.zeros((), dtype=torch.float32, device=dev),
                    torch.zeros((), dtype=torch.bool, device=dev))
    for _ in range(cfg.n_outer):
        if deskew is not None:
            tau_c, tau_s, prev_pose = deskew
            rel = se3.compose(se3.inverse(prev_pose), pose)
            c_i = PointBatch(se3.apply_interpolated(rel, tau_c, corners.xyz), corners.mask)
            s_i = PointBatch(se3.apply_interpolated(rel, tau_s, surfs.xyz), surfs.mask)
        else:
            c_i, s_i = corners, surfs
        corr = associate(pose, c_i, s_i, corner_map, surf_map, cmap_cfg, smap_cfg, cfg,
                         corner_ktab, surf_ktab, knn_fn=knn_fn)
        # row selection through the correspondence masks (normal_equations
        # weights rows by ok_c / ok_s)
        corr_surf = corr._replace(ok_c=torch.zeros_like(corr.ok_c))
        corr_corner = corr._replace(ok_s=torch.zeros_like(corr.ok_s))
        for _ in range(cfg.n_inner):
            # step 1: surf rows only -> (roll, pitch, z)
            Hs, gs, (_, n_s, sq_s, nr_s) = normal_equations(pose, c_i, s_i, corr_surf, cfg)
            Hs, gs, n_s, sq_s, nr_s = allsum((Hs, gs, n_s, sq_s, nr_s), group)
            pose, _, degen_s = _step(Hs, gs, _SURF_IDX, pose, cfg, sq_s, nr_s)
            # step 2: corner rows only -> (yaw, x, y), at the pose after step 1
            Hc, gc, (n_c, _, sq_c, nr_c) = normal_equations(pose, c_i, s_i, corr_corner, cfg)
            Hc, gc, n_c, sq_c, nr_c = allsum((Hc, gc, n_c, sq_c, nr_c), group)
            pose, rms, degen = _step(Hc, gc, _CORNER_IDX, pose, cfg, sq_c, nr_c,
                                     prev=(sq_s, nr_s, degen_s))
            stats = GnStats(n_c, n_s, rms, degen)
    return pose, stats
