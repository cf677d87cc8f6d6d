"""Scan-to-map Gauss-Newton: batched association + fused normal equations
(port of agi_lidar_slam_tpu/estimators/gn_scan2map.py).

OUTER iterations re-associate every feature (voxel-map KNN + closed-form
line/plane fits); INNER iterations re-linearize against the fixed line and
plane primitives and take a degeneracy-clamped 6x6 step on SE(3).

Not ported here, and raising: the candidate cache (`SolverConfig.cand_k > 0`)
and the multi-chip hooks (`knn_fn`, `axis_name`).

Perturbation convention: see geometry/se3.py — right rotation perturbation,
additive translation: dw/dtheta = -R [p]x, dw/dt = I.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from agi_lidar_slam_tpu.config import MapConfig, SolverConfig

from ..fit.geometry_fit import fit_lines, fit_planes
from ..geometry import se3, so3
from ..map.hash_map import HashVoxelMap
from ..map.planar import build_ktab
from ..nn.knn import knn
from ..pointcloud.cloud import PointBatch


class GnStats(NamedTuple):
    n_corner: torch.Tensor  # valid edge correspondences in the final iteration
    n_surf: torch.Tensor
    rms: torch.Tensor  # robust residual RMS in the final iteration
    degenerate: torch.Tensor  # bool: any clamped direction in the final iteration


class Correspondences(NamedTuple):
    """Fixed geometric primitives from one association pass."""

    line_centroid: torch.Tensor  # (Nc,3)
    line_dir: torch.Tensor  # (Nc,3) unit
    ok_c: torch.Tensor  # (Nc,)
    plane_n: torch.Tensor  # (Ns,3) unit
    plane_d: torch.Tensor  # (Ns,)
    ok_s: torch.Tensor  # (Ns,)


def _ktab(m: HashVoxelMap, cfg: MapConfig):
    """Packed-key index for the octant-KNN kernel, or None on the gather path
    (nn/knn.knn's dispatch). Built once per solve so every association pass
    reuses it."""
    return build_ktab(m) if cfg.neighborhood == "octant8" and cfg.knn_kernel != "xla" else None


def _huber_sqrt_weight(r_norm: torch.Tensor, delta: float) -> torch.Tensor:
    """sqrt of the Huber IRLS weight: 1 inside |r|<delta, sqrt(delta/|r|) outside."""
    return torch.sqrt(torch.clamp(delta / torch.clamp(r_norm, min=1e-12), max=1.0))


def associate(
    pose: se3.Pose,
    corners: PointBatch,
    surfs: PointBatch,
    corner_map: HashVoxelMap,
    surf_map: HashVoxelMap,
    cmap_cfg: MapConfig,
    smap_cfg: MapConfig,
    cfg: SolverConfig,
    corner_ktab: torch.Tensor | None = None,
    surf_ktab: torch.Tensor | None = None,
) -> Correspondences:
    """One association pass: KNN + line/plane fits at the current pose."""
    R = so3.quat_to_matrix(pose.q)
    k = cfg.k_neighbors

    cw = corners.xyz @ R.T + pose.t
    nc = knn(corner_map, cw, corners.mask, k, cmap_cfg, ktab=corner_ktab)
    gate_c = nc.sq_dists[:, k - 1] < cfg.corner_gate_sq
    line = fit_lines(nc.points, nc.valid, cfg.line_eig_ratio)
    ok_c = corners.mask & gate_c & line.ok

    sw = surfs.xyz @ R.T + pose.t
    ns = knn(surf_map, sw, surfs.mask, k, smap_cfg, ktab=surf_ktab)
    gate_s = ns.sq_dists[:, k - 1] < cfg.surf_gate_sq
    plane = fit_planes(ns.points, ns.valid, cfg.plane_tol)
    ok_s = surfs.mask & gate_s & plane.ok

    return Correspondences(line.centroid, line.direction, ok_c,
                           plane.normal, plane.offset, ok_s)


def normal_equations(
    pose: se3.Pose,
    corners: PointBatch,
    surfs: PointBatch,
    corr: Correspondences,
    cfg: SolverConfig,
):
    """Linearize at `pose` against fixed correspondences. Returns
    (H (6,6), g (6,), (n_corner, n_surf, sq_sum, n_rows))."""
    R = so3.quat_to_matrix(pose.q)
    eye = torch.eye(3, dtype=R.dtype, device=R.device)

    # ---- edge (corner) rows -------------------------------------------------
    cw = corners.xyz @ R.T + pose.t
    u = corr.line_dir
    P = eye - u[:, :, None] * u[:, None, :]  # (N,3,3) projector
    e = torch.einsum("nij,nj->ni", P, cw - corr.line_centroid)
    # zero invalid rows BEFORE weighting: invalid fits can carry inf/nan and
    # inf * 0-weight = nan would poison the H/g reductions
    e = torch.where(corr.ok_c[:, None], e, torch.zeros_like(e))
    Jr = torch.einsum("nij,njk->nik", P, -torch.einsum("ij,njk->nik", R, so3.hat(corners.xyz)))
    Jc = torch.cat([Jr, P], dim=-1)  # (N,3,6)
    w_c = _huber_sqrt_weight(torch.linalg.vector_norm(e, dim=-1), cfg.huber_delta)
    w_c = torch.where(corr.ok_c, w_c, torch.zeros_like(w_c))
    e_w = e * w_c[:, None]
    J_w = Jc * w_c[:, None, None]
    H = torch.einsum("nri,nrj->ij", J_w, J_w)
    g = torch.einsum("nri,nr->i", J_w, e_w)
    sq_sum = torch.sum(e_w * e_w)
    n_c = torch.sum(corr.ok_c.to(torch.int32))
    n_rows = 3.0 * n_c

    # ---- plane (surf) rows --------------------------------------------------
    sw = surfs.xyz @ R.T + pose.t
    r_s = torch.einsum("ni,ni->n", corr.plane_n, sw) + corr.plane_d
    r_s = torch.where(corr.ok_s, r_s, torch.zeros_like(r_s))  # see edge-row comment
    Jr_s = torch.einsum(
        "ni,nij->nj", corr.plane_n, -torch.einsum("ij,njk->nik", R, so3.hat(surfs.xyz)))
    Js = torch.cat([Jr_s, corr.plane_n], dim=-1)  # (N,6)
    w_s = _huber_sqrt_weight(torch.abs(r_s), cfg.huber_delta)
    w_s = torch.where(corr.ok_s, w_s, torch.zeros_like(w_s))
    r_sw = r_s * w_s
    Js_w = Js * w_s[:, None]
    H = H + torch.einsum("ni,nj->ij", Js_w, Js_w)
    g = g + torch.einsum("ni,n->i", Js_w, r_sw)
    sq_sum = sq_sum + torch.sum(r_sw * r_sw)
    n_s = torch.sum(corr.ok_s.to(torch.int32))
    n_rows = n_rows + n_s
    return H, g, (n_c, n_s, sq_sum, n_rows)


def solve_delta(H: torch.Tensor, g: torch.Tensor, cfg: SolverConfig):
    """Degeneracy-aware 6x6 solve: eigen-decompose H and zero the update along
    eigendirections with eigenvalue below the threshold (LIO-SAM
    LMOptimization). Eigenvector signs differ between libraries; delta does
    not depend on them."""
    vals, vecs = torch.linalg.eigh(H)  # ascending
    good = vals > cfg.degen_eig_thresh
    inv = torch.where(good, 1.0 / torch.where(good, vals, torch.ones_like(vals)),
                      torch.zeros_like(vals))
    delta = -(vecs * inv[None, :]) @ (vecs.T @ g)
    # stability guard against pathological association (far outliers)
    dt_norm = torch.linalg.vector_norm(delta[3:])
    scale = torch.clamp(cfg.translation_clip / torch.clamp(dt_norm, min=1e-12), max=1.0)
    return delta * scale, ~torch.all(good)


def solve_scan2map(
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
    """Iterated GN from initial guess pose0. Returns (pose, GnStats).

    `deskew = (corner_tau, surf_tau, prev_pose)` re-deskews the raw feature
    points at every OUTER pass with the current relative-motion estimate
    rel = prev_pose^-1 . pose (A-LOAM's TransformToStart on the live
    optimization variables, laserOdometry.cpp:124-145)."""
    if axis_name is not None:
        raise NotImplementedError("solve_scan2map(axis_name=...) is not ported to torch")
    if knn_fn is not None:
        raise NotImplementedError("solve_scan2map(knn_fn=...) is not ported to torch")
    if cfg.cand_k > 0:
        raise NotImplementedError("solver.cand_k > 0 (candidate cache) is not ported to torch")
    corner_ktab = _ktab(corner_map, cmap_cfg)
    surf_ktab = _ktab(surf_map, smap_cfg)

    def deskewed(pose):
        if deskew is None:
            return corners, surfs
        tau_c, tau_s, prev_pose = deskew
        rel = se3.compose(se3.inverse(prev_pose), pose)
        return (PointBatch(se3.apply_interpolated(rel, tau_c, corners.xyz), corners.mask),
                PointBatch(se3.apply_interpolated(rel, tau_s, surfs.xyz), surfs.mask))

    pose = pose0
    dev = pose0.t.device
    stats = GnStats(torch.zeros((), dtype=torch.int32, device=dev),
                    torch.zeros((), dtype=torch.int32, device=dev),
                    torch.zeros((), dtype=torch.float32, device=dev),
                    torch.zeros((), dtype=torch.bool, device=dev))
    for _ in range(cfg.n_outer):
        c_i, s_i = deskewed(pose)
        corr = associate(pose, c_i, s_i, corner_map, surf_map, cmap_cfg, smap_cfg, cfg,
                         corner_ktab, surf_ktab)
        for _ in range(cfg.n_inner):
            H, g, (n_c, n_s, sq, n_rows) = normal_equations(pose, c_i, s_i, corr, cfg)
            delta, degen = solve_delta(H, g, cfg)
            pose = se3.boxplus(pose, delta)
            rms = torch.sqrt(sq / torch.clamp(n_rows, min=1.0))
            stats = GnStats(n_c, n_s, rms, degen)
    return pose, stats
