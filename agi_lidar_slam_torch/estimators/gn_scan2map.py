"""Scan-to-map Gauss-Newton: batched association + fused normal equations
(port of agi_lidar_slam_tpu/estimators/gn_scan2map.py).

OUTER iterations re-associate every feature (voxel-map KNN + closed-form
line/plane fits); INNER iterations re-linearize against the fixed line and
plane primitives and take a degeneracy-clamped 6x6 step on SE(3).

What runs where. On CPU tensors every step is the torch code. On CUDA
tensors a step's weighted rows are one kernel (`_rows`: gn_kernels.rotation
and .rows, between the torch products R [x]x and n^T A), the sums over them
stay torch (`normal_equations`), the 6x6 solve stays torch up to its clip
(`_delta`, the eigendecomposition the sym_eig kernel) and the rest of the
step is one kernel (`step`: gn_kernels.update, the clip, boxplus, the rms).
The kernels round as the torch ops do, so the card's results are the torch
code's bit for bit (`rows_ref`, `update_ref` and `step_ref` are that code, on
any device); association is torch and the octant-KNN kernel on both devices.

With `SolverConfig.cand_k >= k_neighbors` the association keeps a candidate
cache (`associate_cached`): the first pass probes the map for cand_k
candidates, later passes re-rank them at the moved pose unless it moved more
than `cand_refresh` since the probe, which is read on the host once per pass
after the first (the reference's `lax.cond`). A smaller cand_k runs plain
`associate`, as in the reference.

The multi-device hooks: `knn_fn` replaces the map lookup (the slot-sharded
map's merged KNN, parallel/map_shard.py), and `group` (the reference's
`axis_name`) names the process group over which the feature point axis is
sharded: each rank associates and linearizes its own block of points and
the 6x6 normal equations complete with one all_reduce per inner iteration
(parallel/distributed.allsum). With `knn_fn=None` association goes through
`nn.knn.knn` (the octant-KNN kernel on octant8 maps) whatever the group.

Perturbation convention: see geometry/se3.py — right rotation perturbation,
additive translation: dw/dtheta = -R [p]x, dw/dt = I.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import MapConfig, SolverConfig
from ..fit.geometry_fit import fit_lines, fit_planes
from ..geometry import se3, so3
from ..map.hash_map import HashVoxelMap
from ..map.planar import build_ktab
from ..nn.knn import _first_k, knn, knn_cand, knn_reselect, make_cand
from ..parallel.distributed import allsum
from ..pointcloud.cloud import PointBatch
from . import gn_kernels
from .sym_eig import sym_eig


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


def _cache_motion(pose: se3.Pose, q_ref: torch.Tensor, t_ref: torch.Tensor,
                  lever: float = 30.0) -> torch.Tensor:
    """Effective motion since a cached probe: |dt| + lever * |dtheta| (the
    worst-case query displacement at `lever` meters range)."""
    dth = so3.quat_log(so3.quat_mul(so3.quat_conj(q_ref), pose.q))
    return torch.linalg.vector_norm(pose.t - t_ref) + lever * torch.linalg.vector_norm(dth)


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
    knn_fn=None,
) -> Correspondences:
    """One association pass: KNN + line/plane fits at the current pose.

    `knn_fn` replaces the map lookup (the signature of nn.knn.knn): the hook
    through which the slot-sharded map (parallel/map_shard.sharded_knn)
    serves association."""
    lookup = knn if knn_fn is None else knn_fn
    R = so3.quat_to_matrix(pose.q)
    k = cfg.k_neighbors

    cw = corners.xyz @ R.T + pose.t
    nc = lookup(corner_map, cw, corners.mask, k, cmap_cfg, ktab=corner_ktab)
    gate_c = nc.sq_dists[:, k - 1] < cfg.corner_gate_sq
    line = fit_lines(nc.points, nc.valid, cfg.line_eig_ratio)
    ok_c = corners.mask & gate_c & line.ok

    sw = surfs.xyz @ R.T + pose.t
    ns = lookup(surf_map, sw, surfs.mask, k, smap_cfg, ktab=surf_ktab)
    gate_s = ns.sq_dists[:, k - 1] < cfg.surf_gate_sq
    plane = fit_planes(ns.points, ns.valid, cfg.plane_tol)
    ok_s = surfs.mask & gate_s & plane.ok

    return Correspondences(line.centroid, line.direction, ok_c,
                           plane.normal, plane.offset, ok_s)


def associate_cached(
    pose: se3.Pose,
    corners: PointBatch,
    surfs: PointBatch,
    corner_map: HashVoxelMap,
    surf_map: HashVoxelMap,
    cmap_cfg: MapConfig,
    smap_cfg: MapConfig,
    cfg: SolverConfig,
    cand: tuple | None = None,
    corner_ktab: torch.Tensor | None = None,
    surf_ktab: torch.Tensor | None = None,
    knn_fn=None,
) -> tuple[Correspondences, tuple]:
    """Association with a candidate cache (SolverConfig.cand_k). Returns
    (correspondences, cache); the cache is (corner CandCache, surf CandCache,
    probe q, probe t).

    With cand=None: one map probe per class for cand_k candidates, whose
    first k are this pass's neighbours. Later calls re-rank the cached
    candidates at the updated pose (knn_reselect, no map traffic), unless the
    pose moved more than cfg.cand_refresh since the probe: then it probes
    again. That test is one host read; it reads the pose, which every rank
    of a sharded solve holds alike, so all ranks decide alike. With
    `knn_fn` the probe goes through it and the cache is made from its
    result (make_cand). Fits and gates are those of `associate`."""
    R = so3.quat_to_matrix(pose.q)
    k = cfg.k_neighbors
    cw = corners.xyz @ R.T + pose.t
    sw = surfs.xyz @ R.T + pose.t

    if cand is None or float(_cache_motion(pose, cand[2], cand[3])) > cfg.cand_refresh:
        if knn_fn is None:
            cc, nc = knn_cand(corner_map, cw, corners.mask, cfg.cand_k, cmap_cfg,
                              ktab=corner_ktab, k=k)
            cs, ns = knn_cand(surf_map, sw, surfs.mask, cfg.cand_k, smap_cfg, ktab=surf_ktab,
                              k=k)
        else:
            fc = knn_fn(corner_map, cw, corners.mask, cfg.cand_k, cmap_cfg, ktab=corner_ktab)
            fs = knn_fn(surf_map, sw, surfs.mask, cfg.cand_k, smap_cfg, ktab=surf_ktab)
            cc, nc = make_cand(fc), _first_k(fc, k)
            cs, ns = make_cand(fs), _first_k(fs, k)
        cand = (cc, cs, pose.q, pose.t)
    else:
        nc = knn_reselect(cand[0], cw, corners.mask, k)
        ns = knn_reselect(cand[1], sw, surfs.mask, k)
    gate_c = nc.sq_dists[:, k - 1] < cfg.corner_gate_sq
    line = fit_lines(nc.points, nc.valid, cfg.line_eig_ratio)
    ok_c = corners.mask & gate_c & line.ok
    gate_s = ns.sq_dists[:, k - 1] < cfg.surf_gate_sq
    plane = fit_planes(ns.points, ns.valid, cfg.plane_tol)
    ok_s = surfs.mask & gate_s & plane.ok
    return Correspondences(line.centroid, line.direction, ok_c,
                           plane.normal, plane.offset, ok_s), cand


def _rows(pose: se3.Pose, corners: PointBatch, surfs: PointBatch, corr: Correspondences,
          cfg: SolverConfig):
    """The weighted rows of the normal equations at `pose`: (e_w (Nc, 3),
    J_w (Nc, 3, 6), r_sw (Ns,), Js_w (Ns, 6)). On CUDA tensors one kernel,
    gn_kernels.rows, between the two products whose rounding order is
    cuBLAS's own, which stay torch ops; on the CPU `rows_ref`."""
    if pose.t.device.type != "cuda":
        return rows_ref(pose, corners, surfs, corr, cfg)
    R = gn_kernels.rotation(pose.q)
    RA = torch.einsum("ij,njk->nik", R, so3.hat(corners.xyz))
    Jr_s = torch.einsum(
        "ni,nij->nj", corr.plane_n, -torch.einsum("ij,njk->nik", R, so3.hat(surfs.xyz)))
    return gn_kernels.rows(R, pose.t, corners, surfs, corr, RA, Jr_s, cfg.huber_delta)


def rows_ref(pose: se3.Pose, corners: PointBatch, surfs: PointBatch, corr: Correspondences,
             cfg: SolverConfig):
    """`_rows` as torch ops, on any device."""
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

    # ---- plane (surf) rows --------------------------------------------------
    sw = surfs.xyz @ R.T + pose.t
    r_s = torch.einsum("ni,ni->n", corr.plane_n, sw) + corr.plane_d
    r_s = torch.where(corr.ok_s, r_s, torch.zeros_like(r_s))  # see edge-row comment
    Jr_s = torch.einsum(
        "ni,nij->nj", corr.plane_n, -torch.einsum("ij,njk->nik", R, so3.hat(surfs.xyz)))
    Js = torch.cat([Jr_s, corr.plane_n], dim=-1)  # (N,6)
    w_s = _huber_sqrt_weight(torch.abs(r_s), cfg.huber_delta)
    w_s = torch.where(corr.ok_s, w_s, torch.zeros_like(w_s))
    return e * w_c[:, None], Jc * w_c[:, None, None], r_s * w_s, Js * w_s[:, None]


def normal_equations(
    pose: se3.Pose,
    corners: PointBatch,
    surfs: PointBatch,
    corr: Correspondences,
    cfg: SolverConfig,
):
    """Linearize at `pose` against fixed correspondences. Returns
    (H (6,6), g (6,), (n_corner, n_surf, sq_sum, n_rows)). The weighted rows
    are one kernel on CUDA tensors (gn_kernels.rows, bit for bit the torch
    ops), the torch ops on the CPU; the sums over them are torch's on both."""
    e_w, J_w, r_sw, Js_w = _rows(pose, corners, surfs, corr, cfg)
    H = torch.einsum("nri,nrj->ij", J_w, J_w)
    g = torch.einsum("nri,nr->i", J_w, e_w)
    sq_sum = torch.sum(e_w * e_w)
    n_c = torch.sum(corr.ok_c.to(torch.int32))
    n_rows = 3.0 * n_c
    H = H + torch.einsum("ni,nj->ij", Js_w, Js_w)
    g = g + torch.einsum("ni,n->i", Js_w, r_sw)
    sq_sum = sq_sum + torch.sum(r_sw * r_sw)
    n_s = torch.sum(corr.ok_s.to(torch.int32))
    n_rows = n_rows + n_s
    return H, g, (n_c, n_s, sq_sum, n_rows)


def _delta(H: torch.Tensor, g: torch.Tensor, eig_thresh: float):
    """solve_delta's step before its clip, and the flags of the
    eigendirections it keeps."""
    vals, vecs = sym_eig(H)  # ascending
    good = vals > eig_thresh
    inv = torch.where(good, 1.0 / torch.where(good, vals, torch.ones_like(vals)),
                      torch.zeros_like(vals))
    return -(vecs * inv[None, :]) @ (vecs.T @ g), good


def _clip(delta: torch.Tensor, good: torch.Tensor, clip: float):
    """solve_delta's step `delta` scaled down to a translation of at most
    `clip`, and its degenerate flag from the eigendirection flags `good`."""
    # stability guard against pathological association (far outliers)
    dt_norm = torch.linalg.vector_norm(delta[3:])
    scale = torch.clamp(clip / torch.clamp(dt_norm, min=1e-12), max=1.0)
    return delta * scale, ~torch.all(good)


def solve_delta(H: torch.Tensor, g: torch.Tensor, cfg: SolverConfig):
    """Degeneracy-aware 6x6 solve: eigen-decompose H and zero the update along
    eigendirections with eigenvalue below the threshold (LIO-SAM
    LMOptimization). Eigenvector signs differ between libraries; delta does
    not depend on them. The eigendecomposition is `sym_eig`: on the card a
    kernel that reads nothing back to the host."""
    return _clip(*_delta(H, g, cfg.degen_eig_thresh), cfg.translation_clip)


def step(H: torch.Tensor, g: torch.Tensor, pose: se3.Pose, sq: torch.Tensor,
         n_rows: torch.Tensor, cfg: SolverConfig):
    """One inner iteration's step from its normal equations: solve_delta,
    se3.boxplus, and the residual rms over the rows. Returns (pose, rms,
    degenerate). The solve up to the clip is the torch ops (`_delta`); the
    rest is one kernel on CUDA tensors, gn_kernels.update, bit for bit the
    torch code, `update_ref`, which runs on the CPU."""
    tail = gn_kernels.update if H.device.type == "cuda" else update_ref
    return tail(*_delta(H, g, cfg.degen_eig_thresh), pose, cfg.translation_clip, sq, n_rows)


def update_ref(delta: torch.Tensor, good: torch.Tensor, pose: se3.Pose, clip: float,
               sq: torch.Tensor, n_rows: torch.Tensor):
    """gn_kernels.update as torch ops, on any device: the clip, boxplus and
    the rms."""
    delta, degen = _clip(delta, good, clip)
    return se3.boxplus(pose, delta), torch.sqrt(sq / torch.clamp(n_rows, min=1.0)), degen


def step_ref(H: torch.Tensor, g: torch.Tensor, pose: se3.Pose, sq: torch.Tensor,
             n_rows: torch.Tensor, cfg: SolverConfig):
    """`step` as torch ops, on any device."""
    return update_ref(*_delta(H, g, cfg.degen_eig_thresh), pose, cfg.translation_clip, sq,
                      n_rows)


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
    group=None,
    knn_fn=None,
):
    """Iterated GN from initial guess pose0. Returns (pose, GnStats).

    `deskew = (corner_tau, surf_tau, prev_pose)` re-deskews the raw feature
    points at every OUTER pass with the current relative-motion estimate
    rel = prev_pose^-1 . pose (A-LOAM's TransformToStart on the live
    optimization variables, laserOdometry.cpp:124-145).

    `group` (a ProcessGroup; the reference's `axis_name`): the feature point
    axis is sharded over its ranks. Each rank passes its own block of
    corners, surfs and deskew times; H, g, the correspondence counts, the
    square sum and the row count complete with one all_reduce per inner
    iteration, and every rank takes the same step. `knn_fn` replaces the
    map lookup (see `associate`). group=None and knn_fn=None run the
    single-process code exactly."""
    use_cache = cfg.cand_k >= cfg.k_neighbors
    corner_ktab = _ktab(corner_map, cmap_cfg) if knn_fn is None else None
    surf_ktab = _ktab(surf_map, smap_cfg) if knn_fn is None else None

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
    cand = None
    for _ in range(cfg.n_outer):
        c_i, s_i = deskewed(pose)
        if use_cache:
            corr, cand = associate_cached(pose, c_i, s_i, corner_map, surf_map, cmap_cfg,
                                          smap_cfg, cfg, cand, corner_ktab, surf_ktab,
                                          knn_fn=knn_fn)
        else:
            corr = associate(pose, c_i, s_i, corner_map, surf_map, cmap_cfg, smap_cfg, cfg,
                             corner_ktab, surf_ktab, knn_fn=knn_fn)
        for _ in range(cfg.n_inner):
            H, g, (n_c, n_s, sq, n_rows) = normal_equations(pose, c_i, s_i, corr, cfg)
            H, g, n_c, n_s, sq, n_rows = allsum((H, g, n_c, n_s, sq, n_rows), group)
            pose, rms, degen = step(H, g, pose, sq, n_rows, cfg)
            stats = GnStats(n_c, n_s, rms, degen)
    return pose, stats
