"""Iterated error-state Kalman filter update, FAST-LIO2 measurement model
(port of agi_lidar_slam_tpu/estimators/ieskf.py).

* `_h_model`: per-point body->world, map 5-NN, plane fit, residual and the
  12 non-zero columns of H, batched over all points;
* `update_iterated`: the iterated update K = (H^T H / R + P^-1)^-1 H^T / R
  over the 12 error dims H touches (pose + extrinsic), exit on |dx| < eps,
  and a Joseph-form covariance update.

The 24x24 solves are f32 Cholesky with the reference's jitter terms. A
matrix that is not positive-definite gives an all-NaN factor, as in the
reference, decided on the device (`estimators/linalg.py`): the update then
returns NaN and `lio_pipeline`'s divergence fallback takes over.

Host reads: the iteration loop reads |dx| back once per finished iteration
while another is allowed (the reference's `lax.while_loop` exit test, which
also ends the loop on a NaN step), and the candidate-cache staleness test
reads the motion once per update (the reference's post-loop `lax.cond`).

`group` (the reference's `axis_name`): the measurement point axis is sharded
over the ranks of a process group. Each rank associates and linearizes its
own block of the downsampled cloud, and the 12x12 HtH, the 12-dim Htr, the
valid count and the residual square sum complete with one all_reduce per
iteration (the reference's OpenMP loop, esekfom.hpp:114-117). Both host
reads test quantities every rank holds alike (the step from the reduced
sums, the state it moved), so every rank leaves the loop and re-probes at
the same iteration, and the collectives stay in step.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import MapConfig
from ..fit.geometry_fit import fit_planes
from ..geometry import se3, so3
from ..imu.eskf import DIM, NavState, boxminus, boxplus
from ..map.hash_map import HashVoxelMap
from ..nn.knn import knn, knn_cand, knn_reselect
from ..parallel.distributed import allsum
from ..pointcloud.cloud import PointBatch
from .gn_scan2map import _cache_motion, _ktab
from .linalg import cho_solve, cholesky


class IeskfConfig(NamedTuple):
    max_iters: int = 4  # maximum IESKF iterations
    meas_noise: float = 0.001  # LASER_POINT_COV
    converge_eps: float = 0.001  # exit once |dx| < eps
    k_neighbors: int = 5
    gate_sq: float = 1.0  # max squared distance of the k-th neighbour (m^2)
    max_resid: float = 0.5  # cap on |point-to-plane residual| (m), resid_gate "cap"
    plane_tol: float = 0.1  # plane-fit threshold
    # "cap": |r| < max_resid; "sform": the reference's range-adaptive
    # s = 1 - 0.9 |r| / sqrt(||p_lidar||) > 0.9
    resid_gate: str = "cap"
    # candidate cache: probe the map once per scan for cand_k candidates at
    # the propagated state and re-rank them in every iteration; 0 disables
    # (a map probe per iteration)
    cand_k: int = 8
    # re-probe once after the loop when the correction moved the queries
    # more than this (|dp| + 30 m lever * |dtheta|) since the probe
    cand_refresh: float = 0.3
    est_extrinsic: bool = False  # online lidar-IMU extrinsic estimation


def _h_model(x: NavState, pts_l: PointBatch, smap: HashVoxelMap, map_cfg: MapConfig,
             cfg: IeskfConfig, cand=None, ktab: torch.Tensor | None = None):
    """Batched h_share_model: returns (H12 (N,12), residual (N,), valid (N,)).

    With `cand` (a CandCache probed at the propagated state) the k-NN are
    re-ranked from it instead of probing the map."""
    R_li = so3.quat_to_matrix(x.q_li)
    R = so3.quat_to_matrix(x.q)
    body = pts_l.xyz @ R_li.T + x.t_li
    world = body @ R.T + x.p

    if cand is None:
        res = knn(smap, world, pts_l.mask, cfg.k_neighbors, map_cfg, ktab=ktab)
    else:
        res = knn_reselect(cand, world, pts_l.mask, cfg.k_neighbors)
    gate = res.sq_dists[:, cfg.k_neighbors - 1] < cfg.gate_sq
    plane = fit_planes(res.points, res.valid, cfg.plane_tol)
    r = torch.einsum("ni,ni->n", plane.normal, world) + plane.offset
    if cfg.resid_gate == "sform":
        s = 1.0 - 0.9 * torch.abs(r) / torch.sqrt(
            torch.clamp(torch.linalg.vector_norm(pts_l.xyz, dim=-1), min=1e-6))
        resid_ok = s > 0.9
    else:
        resid_ok = torch.abs(r) < cfg.max_resid
    ok = pts_l.mask & gate & plane.ok & resid_ok
    r = torch.where(ok, r, torch.zeros_like(r))

    n = plane.normal
    if cfg.est_extrinsic:
        H_ext = [-torch.einsum("ni,nij->nj", n @ R @ R_li, so3.hat(pts_l.xyz)),  # d/dtheta_li
                 n @ R]  # d/dt_li
    else:  # frozen extrinsic: zero columns
        H_ext = [torch.zeros_like(n), torch.zeros_like(n)]
    H = torch.cat([n, -torch.einsum("ni,nij->nj", n @ R, so3.hat(body))] + H_ext, dim=-1)
    H = torch.where(ok[:, None], H, torch.zeros_like(H))
    return H, r, ok


def update_iterated(x_prop: NavState, P_prop: torch.Tensor, pts_l: PointBatch,
                    smap: HashVoxelMap, map_cfg: MapConfig, cfg: IeskfConfig = IeskfConfig(),
                    group=None):
    """Iterated measurement update. Returns (x, P, n_valid, final residual rms).

    The last iteration's (HtH, n_ok, sum r^2) feed the covariance update, as
    the reference forms K and P from the loop's last linearization. `group`
    (the reference's `axis_name`): `pts_l` is this rank's block of the
    cloud and the reductions complete over the group (module docstring);
    None runs the single-process code."""
    dev, dt = P_prop.device, P_prop.dtype
    eye = torch.eye(DIM, dtype=dt, device=dev)
    inv_R = 1.0 / cfg.meas_noise
    P_inv = cho_solve(cholesky(P_prop + 1e-8 * eye), eye)
    P_inv = 0.5 * (P_inv + P_inv.T)
    ktab = _ktab(smap, map_cfg)  # the map does not change during the update

    use_cache = cfg.cand_k >= cfg.k_neighbors

    def probe_at(x):
        R_li0 = so3.quat_to_matrix(x.q_li)
        R0 = so3.quat_to_matrix(x.q)
        world0 = (pts_l.xyz @ R_li0.T + x.t_li) @ R0.T + x.p
        return knn_cand(smap, world0, pts_l.mask, cfg.cand_k, map_cfg, ktab=ktab)

    cand0 = probe_at(x_prop) if use_cache else None

    def reduce_h(x, cand):
        H, r, ok = _h_model(x, pts_l, smap, map_cfg, cfg, cand=cand, ktab=ktab)
        HtH, Htr, n_ok, sq = allsum((H.T @ H, H.T @ r, torch.sum(ok, dtype=torch.int32),
                                     torch.sum(r * r)), group)
        return HtH * inv_R, Htr * inv_R, n_ok, sq

    def solve_step(x, HtH, Htr):
        """One GN/KF step: A dx = -(Htr + P^-1 (x [-] x_prop))."""
        A = P_inv.clone()
        A[:12, :12] += HtH
        rhs = -(torch.cat([Htr, torch.zeros(DIM - 12, dtype=dt, device=dev)])
                + P_inv @ boxminus(x, x_prop))
        dx = cho_solve(cholesky(A + 1e-6 * eye), rhs)
        return boxplus(x, dx), torch.linalg.vector_norm(dx)

    x, i = x_prop, 0
    while True:
        HtH, Htr, n_ok, sq = reduce_h(x, cand0)
        x, dx_norm = solve_step(x, HtH, Htr)
        i += 1
        # the reference's exit: go on only while |dx| >= eps (so a NaN step
        # stops the loop), capped at max_iters
        if i >= cfg.max_iters or not float(dx_norm) >= cfg.converge_eps:
            break

    if use_cache:
        # staleness guard: when the correction moved the queries beyond the
        # cache's slack, re-probe at the solution and run one fresh iteration
        moved = _cache_motion(se3.Pose(x.q, x.p), x_prop.q, x_prop.p)
        if float(moved) > cfg.cand_refresh:
            HtH, Htr, n_ok, sq = reduce_h(x, probe_at(x))
            x, _ = solve_step(x, HtH, Htr)
    rms = torch.sqrt(sq / torch.clamp(n_ok, min=1))
    # Joseph form P = (I-KH) P (I-KH)^T + K Rm K^T with K H = A^-1 embed(HtH)
    A = P_inv.clone()
    A[:12, :12] += HtH
    L = cholesky(A + 1e-6 * eye)
    M = torch.zeros((DIM, DIM), dtype=dt, device=dev)
    M[:12, :12] = HtH
    KH = cho_solve(L, M)
    IKH = eye - KH
    KRKt = cho_solve(L, KH.T)
    P_new = IKH @ P_prop @ IKH.T + KRKt
    P_new = 0.5 * (P_new + P_new.T) + 1e-9 * eye
    return x, P_new, n_ok, rms
