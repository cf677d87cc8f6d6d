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
at the pose after it. Each step's 3x3 eigh reads back to the host on CUDA.

Not ported here, and raising: the multi-chip hooks (`knn_fn`, `axis_name`).
"""

from __future__ import annotations

import torch

from ..config import MapConfig, SolverConfig
from ..geometry import se3
from ..map.hash_map import HashVoxelMap
from ..pointcloud.cloud import PointBatch
from .gn_scan2map import GnStats, _ktab, associate, normal_equations

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
    vals, vecs = torch.linalg.eigh(Hs)
    good = vals > eig_thresh
    inv = torch.where(good, 1.0 / torch.where(good, vals, torch.ones_like(vals)),
                      torch.zeros_like(vals))
    d = -(vecs * inv[None, :]) @ (vecs.T @ gs)
    zero = torch.zeros((1,), dtype=H.dtype, device=H.device)
    pos = {i: j for j, i in enumerate(idx)}
    full = torch.cat([d[pos[i]:pos[i] + 1] if i in pos else zero for i in range(6)])
    return full, ~torch.all(good)


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
    axis_name: str | None = None,
    knn_fn=None,
):
    """Iterated two-step GN (LeGO configuration). Returns (pose, GnStats) of
    the last inner iteration.

    `deskew = (corner_tau, surf_tau, prev_pose)` re-deskews the raw feature
    points at every outer pass with the current motion estimate, as in
    solve_scan2map."""
    if axis_name is not None:
        raise NotImplementedError("solve_scan2map_two_step(axis_name=...) is not ported to torch")
    if knn_fn is not None:
        raise NotImplementedError("solve_scan2map_two_step(knn_fn=...) is not ported to torch")
    corner_ktab = _ktab(corner_map, cmap_cfg)
    surf_ktab = _ktab(surf_map, smap_cfg)
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
                         corner_ktab, surf_ktab)
        # row selection through the correspondence masks (normal_equations
        # weights rows by ok_c / ok_s)
        corr_surf = corr._replace(ok_c=torch.zeros_like(corr.ok_c))
        corr_corner = corr._replace(ok_s=torch.zeros_like(corr.ok_s))
        for _ in range(cfg.n_inner):
            # step 1: surf rows only -> (roll, pitch, z)
            Hs, gs, (_, n_s, sq_s, nr_s) = normal_equations(pose, c_i, s_i, corr_surf, cfg)
            d_s, degen_s = _solve_subset(Hs, gs, _SURF_IDX, cfg.degen_eig_thresh)
            pose = se3.boxplus(pose, d_s)
            # step 2: corner rows only -> (yaw, x, y), at the pose after step 1
            Hc, gc, (n_c, _, sq_c, nr_c) = normal_equations(pose, c_i, s_i, corr_corner, cfg)
            d_c, degen_c = _solve_subset(Hc, gc, _CORNER_IDX, cfg.degen_eig_thresh)
            pose = se3.boxplus(pose, d_c)
            rms = torch.sqrt((sq_s + sq_c) / torch.clamp(nr_s + nr_c, min=1.0))
            stats = GnStats(n_c, n_s, rms, degen_s | degen_c)
    return pose, stats
