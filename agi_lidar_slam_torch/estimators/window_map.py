"""Sliding-window MAP estimator with Schur-complement marginalization, the
LIO-Livox family (port of agi_lidar_slam_tpu/estimators/window_map.py).

* per-frame lidar factors (point-to-line / point-to-plane against the map),
  associated for all window frames at once, one KNN call per feature class;
* 15-dim IMU preintegration factors between consecutive frames with
  first-order bias correction and 15x15 square-root information weights;
* a marginalization prior from Schur-complementing the dropped frame.

Window state: F frames x [theta(3), t(3), v(3), bg(3), ba(3)] = 15F error
dims. The inner Gauss-Newton assembles the dense normal equations
analytically: the lidar rows as the 6x6 blocks of
`gn_scan2map.normal_equations`, scattered into the window H, and the 15-row
IMU factors through their closed-form Jacobian (`_imu_jacobian`), which the
reference takes by jax.jacfwd. `window_information`, the oracle, keeps
`torch.func.jacfwd` of the whole residual stack.

Host reads: with the candidate cache (`SolverConfig.cand_k >= k_neighbors`)
the window's motion since the probe is read once per outer pass after the
first (the reference's `lax.cond`). The Cholesky solve returns NaN on a
matrix that is not positive-definite, decided on the device
(`estimators/linalg.py`), and the Schur complement inverts with `inv_ex`:
no host read in either.

The multi-device hooks: `knn_fn` replaces the map lookup, and `group` (the
reference's `axis_name`) shards each frame's point axes over a process
group: the per-frame lidar blocks, summed over each rank's points, complete
with one all_reduce before the IMU factors, which every rank adds alike (the
reference's std::thread residual builders, Estimator.cpp:1019-1050).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..config import MapConfig, SolverConfig
from ..device import default_device
from ..fit.geometry_fit import fit_lines, fit_planes
from ..geometry import se3, so3
from ..imu.preintegration import Preintegrated
from ..map.hash_map import HashVoxelMap
from ..nn.knn import _first_k, knn, knn_cand, knn_reselect, make_cand
from ..parallel.distributed import allsum
from ..pointcloud.cloud import PointBatch
from .gn_scan2map import (Correspondences, _huber_sqrt_weight, _ktab, associate,
                          normal_equations)
from .linalg import cho_solve, cholesky

D_FRAME = 15


class PlaneCorr(NamedTuple):
    """Point-to-plane correspondences of the non-feature class
    (Cost_NonFeature_ICP)."""

    n: torch.Tensor  # (N,3) unit normals
    d: torch.Tensor  # (N,) offsets
    ok: torch.Tensor  # (N,)


class WindowState(NamedTuple):
    """F window frames: world poses, velocities and IMU biases."""

    q: torch.Tensor  # (F,4)
    t: torch.Tensor  # (F,3)
    v: torch.Tensor  # (F,3)
    bg: torch.Tensor  # (F,3)
    ba: torch.Tensor  # (F,3)

    @property
    def frames(self) -> int:
        return self.q.shape[0]


class MarginalPrior(NamedTuple):
    """Gaussian prior on the window from marginalized history,
    r(dx) = sqrt_H (dx - dx0), linearized at the stored state."""

    H: torch.Tensor  # (15F, 15F) information
    b: torch.Tensor  # (15F,) information vector
    q0: torch.Tensor  # (F,4) linearization poses
    t0: torch.Tensor
    v0: torch.Tensor
    bg0: torch.Tensor
    ba0: torch.Tensor


def empty_prior(n_frames: int, device=None) -> MarginalPrior:
    """A prior with no information, on `device` (default: cuda)."""
    device = default_device(device)
    D = n_frames * D_FRAME
    z3 = torch.zeros((n_frames, 3), device=device)
    return MarginalPrior(torch.zeros((D, D), device=device), torch.zeros((D,), device=device),
                         so3.quat_identity((n_frames,), device=device), z3, z3.clone(),
                         z3.clone(), z3.clone())


def _frame(tree, f: int):
    """Frame (or interval) f of a NamedTuple of stacked tensors."""
    return type(tree)(*(x[f] for x in tree))


def associate_nonfeature(pose: se3.Pose, pts: PointBatch, m: HashVoxelMap,
                         map_cfg: MapConfig, cfg: SolverConfig,
                         gate_sq: float = 4.0, tol: float = 0.5) -> PlaneCorr:
    """KNN + loose plane fit of non-feature points against their own map."""
    R = so3.quat_to_matrix(pose.q)
    nn = knn(m, pts.xyz @ R.T + pose.t, pts.mask, cfg.k_neighbors, map_cfg)
    gate = nn.sq_dists[:, cfg.k_neighbors - 1] < gate_sq
    plane = fit_planes(nn.points, nn.valid, tol)
    return PlaneCorr(plane.normal, plane.offset, pts.mask & gate & plane.ok)


def _apply_delta(ws: WindowState, dx: torch.Tensor) -> WindowState:
    d = dx.reshape(ws.frames, D_FRAME)
    return WindowState(
        q=so3.quat_normalize(so3.quat_mul(ws.q, so3.quat_exp(d[:, 0:3]))),
        t=ws.t + d[:, 3:6], v=ws.v + d[:, 6:9], bg=ws.bg + d[:, 9:12], ba=ws.ba + d[:, 12:15])


def _imu_residual(ws: WindowState, i: int, pre: Preintegrated,
                  grav: torch.Tensor) -> torch.Tensor:
    """15-dim preintegration residual between window frames i and i+1."""
    qi, ti, vi = ws.q[i], ws.t[i], ws.v[i]
    qj, tj, vj = ws.q[i + 1], ws.t[i + 1], ws.v[i + 1]
    dt = pre.dt
    # first-order bias correction at the current bias estimate
    dbg = ws.bg[i] - pre.bg
    db = torch.cat([dbg, ws.ba[i] - pre.ba])
    dq_c = so3.quat_mul(pre.dq, so3.quat_exp(pre.J_bias[0:3, 0:3] @ dbg))
    dv_c = pre.dv + pre.J_bias[3:6] @ db
    dp_c = pre.dp + pre.J_bias[6:9] @ db
    qi_c = so3.quat_conj(qi)
    r_R = so3.quat_log(so3.quat_mul(so3.quat_conj(dq_c), so3.quat_mul(qi_c, qj)))
    r_v = so3.quat_rotate(qi_c, vj - vi - grav * dt) - dv_c
    r_p = so3.quat_rotate(qi_c, tj - ti - vi * dt - 0.5 * grav * dt * dt) - dp_c
    return torch.cat([r_R, r_v, r_p, ws.bg[i + 1] - ws.bg[i], ws.ba[i + 1] - ws.ba[i]])


def _imu_jacobian(ws: WindowState, i: int, pre: Preintegrated,
                  grav: torch.Tensor) -> torch.Tensor:
    """(15, 15F) Jacobian of `_imu_residual` at `ws` with respect to the
    window's error state (right rotation perturbation, additive elsewhere, as
    `_apply_delta`), in closed form: about the ops of one residual
    evaluation, where torch.func.jacfwd runs each op of the residual through
    its batching and dual-number layers on the host, several times the cost
    (PERF.md, PR 6). tests/test_torch_livox_units.py holds it to that
    jacfwd."""
    qi, qj = ws.q[i], ws.q[i + 1]
    Ri, Rj = so3.quat_to_matrix(qi), so3.quat_to_matrix(qj)
    RiT = Ri.T
    dt = pre.dt
    Jb = pre.J_bias
    phi = Jb[0:3, 0:3] @ (ws.bg[i] - pre.bg)
    dq_c = so3.quat_mul(pre.dq, so3.quat_exp(phi))
    E = so3.quat_mul(so3.quat_conj(dq_c), so3.quat_mul(so3.quat_conj(qi), qj))
    Jr_inv = so3.right_jacobian_inv(so3.quat_log(E))
    u_v = RiT @ (ws.v[i + 1] - ws.v[i] - grav * dt)
    u_p = RiT @ (ws.t[i + 1] - ws.t[i] - ws.v[i] * dt - 0.5 * grav * dt * dt)
    J = torch.zeros((15, ws.frames * D_FRAME), dtype=Ri.dtype, device=Ri.device)
    a, b = i * D_FRAME, (i + 1) * D_FRAME  # the two frames' columns
    # r_R = Log(dq_c^-1 qi^-1 qj), dq_c = dq Exp(J_q (bg_i - bg_lin))
    J[0:3, a:a + 3] = -Jr_inv @ Rj.T @ Ri
    J[0:3, b:b + 3] = Jr_inv
    J[0:3, a + 9:a + 12] = (-Jr_inv @ so3.quat_to_matrix(E).T @ so3.right_jacobian(phi)
                            @ Jb[0:3, 0:3])
    # r_v = Ri^T (vj - vi - g dt) - dv_c
    J[3:6, a:a + 3] = so3.hat(u_v)
    J[3:6, a + 6:a + 9] = -RiT
    J[3:6, b + 6:b + 9] = RiT
    J[3:6, a + 9:a + 15] = -Jb[3:6]
    # r_p = Ri^T (tj - ti - vi dt - g dt^2 / 2) - dp_c
    J[6:9, a:a + 3] = so3.hat(u_p)
    J[6:9, a + 3:a + 6] = -RiT
    J[6:9, b + 3:b + 6] = RiT
    J[6:9, a + 6:a + 9] = -RiT * dt
    J[6:9, a + 9:a + 15] = -Jb[6:9]
    # the bias random walks
    J[9:15, a + 9:a + 15] = -torch.eye(6, dtype=Ri.dtype, device=Ri.device)
    J[9:15, b + 9:b + 15] = torch.eye(6, dtype=Ri.dtype, device=Ri.device)
    return J


def _lidar_rows(ws: WindowState, frame: int, corners: PointBatch, surfs: PointBatch,
                corr: Correspondences):
    """Masked edge residuals (Nc,3) and plane residuals (Ns,) of one frame."""
    R = so3.quat_to_matrix(ws.q[frame])
    t = ws.t[frame]
    u = corr.line_dir
    P = torch.eye(3, dtype=R.dtype, device=R.device) - u[:, :, None] * u[:, None, :]
    e = torch.einsum("nij,nj->ni", P, corners.xyz @ R.T + t - corr.line_centroid)
    e = torch.where(corr.ok_c[:, None], e, torch.zeros_like(e))
    r_s = torch.einsum("ni,ni->n", corr.plane_n, surfs.xyz @ R.T + t) + corr.plane_d
    return e, torch.where(corr.ok_s, r_s, torch.zeros_like(r_s))


def _lidar_residuals(ws: WindowState, frame: int, corners: PointBatch, surfs: PointBatch,
                     corr: Correspondences, huber: float,
                     at: WindowState | None = None) -> torch.Tensor:
    """Huber-weighted edge + plane residual vector of one frame. The IRLS
    weights are constants of the linearization: computed at `at` (default
    `ws`), which is what the reference's stop_gradient does when it is
    differentiated at `at`."""
    e, r_s = _lidar_rows(ws, frame, corners, surfs, corr)
    e0, r0 = (e, r_s) if at is None else _lidar_rows(at, frame, corners, surfs, corr)
    w_c = _huber_sqrt_weight(torch.linalg.vector_norm(e0, dim=-1), huber)
    w_c = torch.where(corr.ok_c, w_c, torch.zeros_like(w_c))
    w_s = torch.where(corr.ok_s, _huber_sqrt_weight(torch.abs(r0), huber), torch.zeros_like(r0))
    return torch.cat([(e * w_c[:, None]).reshape(-1), r_s * w_s])


def _nonfeature_residuals(ws: WindowState, frame: int, others: PointBatch, corr: PlaneCorr,
                          huber: float, at: WindowState | None = None) -> torch.Tensor:
    """Weighted point-to-plane rows of the non-feature class; weights as in
    `_lidar_residuals`."""
    def rows(w):
        R = so3.quat_to_matrix(w.q[frame])
        r = torch.einsum("ni,ni->n", corr.n, others.xyz @ R.T + w.t[frame]) + corr.d
        return torch.where(corr.ok, r, torch.zeros_like(r))

    r = rows(ws)
    r0 = r if at is None else rows(at)
    w = torch.where(corr.ok, _huber_sqrt_weight(torch.abs(r0), huber), torch.zeros_like(r0))
    return r * w


def _sqrt_info(cov: torch.Tensor) -> torch.Tensor:
    """Upper square-root information factors of covariances (...,15,15)."""
    eye = torch.eye(cov.shape[-1], dtype=cov.dtype, device=cov.device)
    L = cholesky(cov + 1e-8 * eye)
    return torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)


def _world(ws: WindowState, b: PointBatch) -> torch.Tensor:
    """All frames' points in the world, flattened (F*N, 3)."""
    R = so3.quat_to_matrix(ws.q)
    return (torch.einsum("fij,fnj->fni", R, b.xyz) + ws.t[:, None, :]).reshape(-1, 3)


def associate_window(
    ws: WindowState,
    corners: PointBatch,  # (F, Nc, 3)/(F, Nc)
    surfs: PointBatch,
    corner_map: HashVoxelMap,
    surf_map: HashVoxelMap,
    cmap_cfg: MapConfig,
    smap_cfg: MapConfig,
    cfg: SolverConfig,
    others: PointBatch | None = None,
    other_map: HashVoxelMap | None = None,
    omap_cfg: MapConfig | None = None,
    corner_ktab: torch.Tensor | None = None,
    surf_ktab: torch.Tensor | None = None,
    other_ktab: torch.Tensor | None = None,
    nonfeature_gate_sq: float = 4.0,
    nonfeature_tol: float = 0.5,
    knn_fn=None,
    cand: tuple | None = None,
) -> Tuple[Correspondences, PlaneCorr | None, tuple | None]:
    """One association pass for all window frames, one KNN call per feature
    class. Returns (corr, non-feature corr or None, cache).

    With SolverConfig.cand_k >= k_neighbors the probe fetches cand_k
    candidates and returns them as the cache (plus the probe's window
    poses); passed back as `cand`, later passes re-rank them (knn_reselect)
    unless the worst-moved frame moved more than cand_refresh since the
    probe, a test read on the host. `knn_fn` replaces the map lookup (the
    signature of nn.knn.knn); its probe's cache is made with make_cand."""
    lookup = knn if knn_fn is None else knn_fn
    F, Nc = corners.mask.shape
    Ns = surfs.mask.shape[1]
    k = cfg.k_neighbors
    use_others = others is not None and other_map is not None
    cw, cm = _world(ws, corners), corners.mask.reshape(-1)
    sw, sm = _world(ws, surfs), surfs.mask.reshape(-1)
    if use_others:
        No = others.mask.shape[1]
        ow, om = _world(ws, others), others.mask.reshape(-1)
    no = None

    if cfg.cand_k < k:
        nc = lookup(corner_map, cw, cm, k, cmap_cfg, ktab=corner_ktab)
        ns = lookup(surf_map, sw, sm, k, smap_cfg, ktab=surf_ktab)
        if use_others:
            no = lookup(other_map, ow, om, k, omap_cfg, ktab=other_ktab)
        cand = None
    else:
        stale = cand is None
        if not stale:  # skin-distance refresh over the worst-moved frame
            dth = so3.quat_log(so3.quat_mul(so3.quat_conj(cand[3]), ws.q))
            moved = torch.max(torch.linalg.vector_norm(ws.t - cand[4], dim=-1)
                              + 30.0 * torch.linalg.vector_norm(dth, dim=-1))
            stale = float(moved) > cfg.cand_refresh
        if stale:
            kq = cfg.cand_k

            def probe(m, w, mask, mcfg, ktab):
                if knn_fn is None:
                    return knn_cand(m, w, mask, kq, mcfg, ktab=ktab, k=k)
                full = knn_fn(m, w, mask, kq, mcfg, ktab=ktab)
                return make_cand(full), _first_k(full, k)

            cc, nc = probe(corner_map, cw, cm, cmap_cfg, corner_ktab)
            cs, ns = probe(surf_map, sw, sm, smap_cfg, surf_ktab)
            co = None
            if use_others:
                co, no = probe(other_map, ow, om, omap_cfg, other_ktab)
            cand = (cc, cs, co, ws.q, ws.t)
        else:
            nc = knn_reselect(cand[0], cw, cm, k)
            ns = knn_reselect(cand[1], sw, sm, k)
            if use_others:
                no = knn_reselect(cand[2], ow, om, k)

    line = fit_lines(nc.points, nc.valid, cfg.line_eig_ratio)
    ok_c = cm & (nc.sq_dists[:, k - 1] < cfg.corner_gate_sq) & line.ok
    plane = fit_planes(ns.points, ns.valid, cfg.plane_tol)
    ok_s = sm & (ns.sq_dists[:, k - 1] < cfg.surf_gate_sq) & plane.ok
    corr = Correspondences(
        line.centroid.reshape(F, Nc, 3), line.direction.reshape(F, Nc, 3), ok_c.reshape(F, Nc),
        plane.normal.reshape(F, Ns, 3), plane.offset.reshape(F, Ns), ok_s.reshape(F, Ns))
    ocorr = None
    if use_others:
        pl = fit_planes(no.points, no.valid, nonfeature_tol)
        ok_o = om & (no.sq_dists[:, k - 1] < nonfeature_gate_sq) & pl.ok
        ocorr = PlaneCorr(pl.normal.reshape(F, No, 3), pl.offset.reshape(F, No),
                          ok_o.reshape(F, No))
    return corr, ocorr, cand


def _plane_normal_eq(pose: se3.Pose, pts: PointBatch, n: torch.Tensor, d: torch.Tensor,
                     ok: torch.Tensor, huber: float):
    """Analytic (H 6x6, g 6, weighted square sum) of point-to-plane rows:
    the non-feature class block."""
    R = so3.quat_to_matrix(pose.q)
    r = torch.einsum("ni,ni->n", n, pts.xyz @ R.T + pose.t) + d
    r = torch.where(ok, r, torch.zeros_like(r))
    Jr = torch.einsum("ni,nij->nj", n, -torch.einsum("ij,njk->nik", R, so3.hat(pts.xyz)))
    J = torch.cat([Jr, n], dim=-1)
    wgt = torch.where(ok, _huber_sqrt_weight(torch.abs(r), huber), torch.zeros_like(r))
    rw = r * wgt
    Jw = J * wgt[:, None]
    return (torch.einsum("ni,nj->ij", Jw, Jw), torch.einsum("ni,n->i", Jw, rw),
            torch.sum(rw * rw))


def _window_normal_eq(ws: WindowState, corners: PointBatch, surfs: PointBatch,
                      corr: Correspondences, ocorr: PlaneCorr | None,
                      others: PointBatch | None, preints: Preintegrated, sqrtW: torch.Tensor,
                      grav: torch.Tensor, cfg: SolverConfig, lidar_weight: float,
                      nonfeature_weight: float, group=None):
    """Dense (H, g, weighted square sum) of the window at `ws` with fixed
    correspondences: analytic 6x6 lidar blocks per frame and the closed-form
    Jacobians of the 15-row IMU factors. With `group` (the reference's
    `axis_name`) the lidar sums are over this rank's points and complete
    with one all_reduce; the IMU factors are added after it."""
    F = ws.frames
    D = F * D_FRAME
    H = torch.zeros((D, D), dtype=ws.t.dtype, device=ws.t.device)
    g = torch.zeros((D,), dtype=ws.t.dtype, device=ws.t.device)
    lw2 = lidar_weight * lidar_weight
    nw2 = nonfeature_weight * nonfeature_weight
    sq = torch.zeros((), dtype=ws.t.dtype, device=ws.t.device)
    for f in range(F):
        pose_f = se3.Pose(ws.q[f], ws.t[f])
        Hf, gf, (_, _, sqf, _) = normal_equations(
            pose_f, _frame(corners, f), _frame(surfs, f), _frame(corr, f), cfg)
        Hf, gf, sq = lw2 * Hf, lw2 * gf, sq + lw2 * sqf
        if ocorr is not None and others is not None:
            Ho, go, sqo = _plane_normal_eq(pose_f, _frame(others, f), ocorr.n[f], ocorr.d[f],
                                           ocorr.ok[f], cfg.huber_delta)
            Hf, gf, sq = Hf + nw2 * Ho, gf + nw2 * go, sq + nw2 * sqo
        o = f * D_FRAME
        H[o:o + 6, o:o + 6] += Hf
        g[o:o + 6] += gf
    H, g, sq = allsum((H, g, sq), group)
    for f in range(F - 1):
        pre_f = _frame(preints, f)
        r0 = sqrtW[f] @ _imu_residual(ws, f, pre_f, grav)
        J = sqrtW[f] @ _imu_jacobian(ws, f, pre_f, grav)
        H = H + J.T @ J
        g = g + J.T @ r0
        sq = sq + r0 @ r0
    return H, g, sq


def solve_window(
    ws: WindowState,
    corners: PointBatch,  # (F, Nc, 3)/(F, Nc) stacked per-frame features
    surfs: PointBatch,
    corner_map: HashVoxelMap,
    surf_map: HashVoxelMap,
    preints: Preintegrated,  # batched (F-1,) preintegrations between frames
    prior: MarginalPrior,
    grav: torch.Tensor,
    cmap_cfg: MapConfig,
    smap_cfg: MapConfig,
    cfg: SolverConfig,
    lidar_weight: float = 30.0,
    others: PointBatch | None = None,  # (F, No, 3) non-feature class
    other_map: HashVoxelMap | None = None,
    omap_cfg: MapConfig | None = None,
    nonfeature_weight: float = 10.0,
    group=None,
    knn_fn=None,
) -> Tuple[WindowState, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Windowed MAP solve (LIO-Livox Estimate). Returns (state, final residual
    norm, H_meas, b_meas): the measurement information (sum J^T J and
    -J^T r over the lidar and IMU factors, no prior, no damping) linearized
    at the returned state with the final pass's correspondences, which is
    what marginalization consumes.

    `group` (the reference's `axis_name`): the (F, N) feature arrays hold
    this rank's block of each frame's points; the normal equations complete
    over the group, and the prior, damping and solve run alike on every
    rank. `knn_fn` replaces the map lookup. Both None: the single-process
    code."""
    D = ws.frames * D_FRAME
    sqrtW = _sqrt_info(preints.cov)  # (F-1,15,15)
    use_others = others is not None and other_map is not None

    def ktab(m, mcfg):
        return _ktab(m, mcfg) if knn_fn is None else None

    okw = dict(others=others, other_map=other_map, omap_cfg=omap_cfg,
               other_ktab=ktab(other_map, omap_cfg)) if use_others else {}
    ctab, stab = ktab(corner_map, cmap_cfg), ktab(surf_map, smap_cfg)
    eye = torch.eye(D, dtype=ws.t.dtype, device=ws.t.device)

    def linearize(ws_c, corr, ocorr):
        return _window_normal_eq(ws_c, corners, surfs, corr, ocorr,
                                 others if use_others else None, preints, sqrtW, grav, cfg,
                                 lidar_weight, nonfeature_weight, group=group)

    rn = torch.zeros((), dtype=ws.t.dtype, device=ws.t.device)
    cand = None
    for _ in range(cfg.n_outer):
        corr, ocorr, cand = associate_window(ws, corners, surfs, corner_map, surf_map,
                                             cmap_cfg, smap_cfg, cfg, corner_ktab=ctab,
                                             surf_ktab=stab, knn_fn=knn_fn, cand=cand, **okw)
        for _ in range(cfg.n_inner):
            H, g, sq = linearize(ws, corr, ocorr)
            # marginalization prior: r_p = H_prior (x [-] x0) - b residual form
            Hp = H + prior.H
            gp = g + prior.H @ _boxminus_flat(ws, prior) - prior.b
            # relative damping + Jacobi equilibration (the IMU information is
            # ~1e8 while unobservable directions carry only damping)
            lam = 1e-6 * torch.clamp(torch.max(torch.diagonal(Hp)), min=1.0) + 1e-4
            Hp = Hp + lam * eye
            s = 1.0 / torch.sqrt(torch.diagonal(Hp))
            Hs = Hp * s[:, None] * s[None, :] + 1e-6 * eye
            dx = -s * cho_solve(cholesky(Hs), s * gp)
            ws, rn = _apply_delta(ws, dx), torch.sqrt(sq)
    H, g, _ = linearize(ws, corr, ocorr)
    return ws, rn, H, -g


def _boxminus_flat(ws: WindowState, prior: MarginalPrior) -> torch.Tensor:
    """Flattened manifold difference between the state and the prior's
    linearization point."""
    dth = so3.quat_log(so3.quat_mul(so3.quat_conj(prior.q0), ws.q))
    return torch.cat([dth, ws.t - prior.t0, ws.v - prior.v0, ws.bg - prior.bg0,
                      ws.ba - prior.ba0], dim=-1).reshape(-1)


def marginalize_oldest(ws: WindowState, H_full: torch.Tensor,
                       b_full: torch.Tensor) -> MarginalPrior:
    """Schur-complement frame 0 out of the window. Returns a prior over
    frames 1..F-1 linearized at the current state; `b_full` is the negative
    gradient (-J^T r) and the reduced b keeps that sign."""
    m = D_FRAME
    eye_m = torch.eye(m, dtype=H_full.dtype, device=H_full.device)
    Hmr, Hrr = H_full[:m, m:], H_full[m:, m:]
    Hmm_inv = torch.linalg.inv_ex(H_full[:m, :m] + 1e-6 * eye_m).inverse  # no host check
    H_pr = Hrr - Hmr.T @ Hmm_inv @ Hmr
    b_pr = b_full[m:] - Hmr.T @ Hmm_inv @ b_full[:m]
    # PSD repair: f32 roundoff leaves tiny negative eigenvalues; a relative
    # ridge at 10x that scale restores positive semi-definiteness
    H_pr = 0.5 * (H_pr + H_pr.T)
    ridge = 1e-6 * torch.clamp(torch.max(torch.diagonal(H_pr)), min=0.0)
    H_pr = H_pr + ridge * torch.eye(H_pr.shape[0], dtype=H_pr.dtype, device=H_pr.device)
    return MarginalPrior(H=H_pr, b=b_pr, q0=ws.q[1:], t0=ws.t[1:], v0=ws.v[1:],
                         bg0=ws.bg[1:], ba0=ws.ba[1:])


def window_information(
    ws: WindowState,
    corners: PointBatch,
    surfs: PointBatch,
    corner_map: HashVoxelMap,
    surf_map: HashVoxelMap,
    preints: Preintegrated,
    grav: torch.Tensor,
    cmap_cfg: MapConfig,
    smap_cfg: MapConfig,
    cfg: SolverConfig,
    lidar_weight: float = 30.0,
    others: PointBatch | None = None,
    other_map: HashVoxelMap | None = None,
    omap_cfg: MapConfig | None = None,
    nonfeature_weight: float = 10.0,
):
    """(H, b) of the full window at the current state, by jacfwd of the whole
    residual stack (per-frame association, no candidate cache)."""
    F = ws.frames
    sqrtW = _sqrt_info(preints.cov)
    use_others = others is not None and other_map is not None
    corrs = [associate(se3.Pose(ws.q[f], ws.t[f]), _frame(corners, f), _frame(surfs, f),
                       corner_map, surf_map, cmap_cfg, smap_cfg, cfg) for f in range(F)]
    ocorrs = [associate_nonfeature(se3.Pose(ws.q[f], ws.t[f]), _frame(others, f), other_map,
                                   omap_cfg, cfg) for f in range(F)] if use_others else []

    def residual(dx):
        w = _apply_delta(ws, dx)
        parts = []
        for f in range(F):
            parts.append(lidar_weight * _lidar_residuals(
                w, f, _frame(corners, f), _frame(surfs, f), corrs[f], cfg.huber_delta, at=ws))
            if use_others:
                parts.append(nonfeature_weight * _nonfeature_residuals(
                    w, f, _frame(others, f), ocorrs[f], cfg.huber_delta, at=ws))
        for f in range(F - 1):
            parts.append(sqrtW[f] @ _imu_residual(w, f, _frame(preints, f), grav))
        r = torch.cat(parts)
        return r, r

    J, r0 = torch.func.jacfwd(residual, has_aux=True)(
        torch.zeros((F * D_FRAME,), dtype=ws.t.dtype, device=ws.t.device))
    return J.T @ J, -(J.T @ r0)
