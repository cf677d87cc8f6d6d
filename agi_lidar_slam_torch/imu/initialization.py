"""Dynamic (moving-start) MAP initialization of gravity, velocities and biases
(port of agi_lidar_slam_tpu/imu/initialization.py; LIO-Livox
TryMAPInitialization).

The problem is (almost) linear, so no iterative solver:
1. gyro bias: rotation-only linear least squares (VINS style),
2. {g, v_0..v_{F-1}, ba}: linear in the dv/dp preintegration residuals given
   the poses, one dense least-squares solve,
3. the gravity magnitude: two re-solves with g = 9.81 g_dir + B(g_dir) w.

The least-squares solves keep the reference's semantics, the minimum-norm
solution of `jnp.linalg.lstsq` (singular values below eps * max(M, N) times
the largest are dropped), through an SVD: `torch.linalg.lstsq` on CUDA has
only the `gels` driver, which assumes full rank. It runs once, at
engagement; on the card the SVD reads its convergence flag on the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import so3
from .preintegration import Preintegrated

G_NORM = 9.81
BA_PRIOR_W = 2.0  # zero-mean accel-bias prior (sigma 0.5 m/s^2)


class InitResult(NamedTuple):
    grav: torch.Tensor  # (3,) world gravity (magnitude G_NORM)
    v: torch.Tensor  # (F,3) per-frame world velocities
    bg: torch.Tensor  # (3,)
    ba: torch.Tensor  # (3,)
    rms: torch.Tensor  # () residual RMS of the final solve
    ok: torch.Tensor  # () bool: the reference's bounds check passed


def lstsq_min_norm(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Minimum-norm least-squares solution of A x = b, as jnp.linalg.lstsq
    with its default rcond: singular values below eps * max(M, N) * s_max
    count as zero."""
    U, S, Vh = torch.linalg.svd(A, full_matrices=False)
    rcond = torch.finfo(A.dtype).eps * max(A.shape)
    keep = S >= rcond * S[0]
    s_inv = torch.where(keep, 1.0 / torch.where(keep, S, torch.ones_like(S)),
                        torch.zeros_like(S))
    return Vh.T @ (s_inv * (U.T @ b))


def _tangent_basis(g_dir: torch.Tensor) -> torch.Tensor:
    """(3,2) orthonormal basis of the plane perpendicular to g_dir."""
    e = torch.eye(3, dtype=g_dir.dtype, device=g_dir.device)
    ref = torch.where(torch.abs(g_dir[0]) < 0.9, e[0], e[1])
    b1 = torch.linalg.cross(g_dir, ref)
    b1 = b1 / torch.clamp(torch.linalg.vector_norm(b1), min=1e-9)
    b2 = torch.linalg.cross(g_dir, b1)
    return torch.stack([b1, b2], dim=1)


def _solve_gyro_bias(qs: torch.Tensor, preints: Preintegrated) -> torch.Tensor:
    """dbg from the rotation residuals (first order in J_bias[0:3, 0:3])."""
    qij = so3.quat_mul(so3.quat_conj(qs[:-1]), qs[1:])
    e = so3.quat_log(so3.quat_mul(so3.quat_conj(preints.dq), qij))  # (F-1,3)
    J = preints.J_bias[:, 0:3, 0:3]
    H = torch.einsum("nij,nik->jk", J, J) + 1e-6 * torch.eye(3, dtype=J.dtype, device=J.device)
    g = torch.einsum("nij,ni->j", J, e)
    return torch.linalg.solve_ex(H, g)[0]


def _linear_system(qs, ts, preints, bg_delta, g_fixed=None, g_basis=None,
                   ba_prior_w: float = 0.0):
    """Assemble A x = b for x = [g (3, or 2 on `g_basis`), v (3F), ba (3)].

    Rows per interval i, in frame i's body axes:
      r_v: R_i^T (v_{i+1} - v_i - g dt)          = dv_i + J_v [dbg; ba]
      r_p: R_i^T (t_{i+1}-t_i - v_i dt - g dt²/2) = dp_i + J_p [dbg; ba]
    `ba_prior_w` adds a zero-mean prior row block on ba (gravity and accel
    bias are nearly collinear in low-rotation windows)."""
    F = qs.shape[0]
    n = preints.dq.shape[0]  # F-1 intervals
    dev, dtype = qs.device, qs.dtype
    Ri_T = so3.quat_to_matrix(qs[:-1]).transpose(-1, -2)  # (n,3,3)
    dt = preints.dt
    Jv = preints.J_bias[:, 3:6]  # (n,3,6)
    Jp = preints.J_bias[:, 6:9]
    rhs_v = preints.dv + Jv[..., 0:3] @ bg_delta
    rhs_p = preints.dp + Jp[..., 0:3] @ bg_delta
    ng = 2 if g_basis is not None else 3
    D = ng + 3 * F + 3
    A = torch.zeros((n, 6, D), dtype=dtype, device=dev)
    b = torch.zeros((n, 6), dtype=dtype, device=dev)
    Gv = -Ri_T * dt[:, None, None]  # d r_v / d g
    Gp = -0.5 * Ri_T * (dt ** 2)[:, None, None]
    if g_basis is not None:
        Gv = Gv @ g_basis
        Gp = Gp @ g_basis
        b[:, 0:3] += torch.einsum("nij,j->ni", Ri_T * dt[:, None, None], g_fixed)
        b[:, 3:6] += torch.einsum("nij,j->ni", 0.5 * Ri_T * (dt ** 2)[:, None, None], g_fixed)
    A[:, 0:3, 0:ng] = Gv
    A[:, 3:6, 0:ng] = Gp
    # velocity columns: r_v has -R^T v_i + R^T v_{i+1}; r_p has -R^T dt v_i
    for i in range(n):
        ci, cj = ng + 3 * i, ng + 3 * (i + 1)
        A[i, 0:3, ci:ci + 3] = -Ri_T[i]
        A[i, 0:3, cj:cj + 3] = Ri_T[i]
        A[i, 3:6, ci:ci + 3] = -Ri_T[i] * dt[i]
    # accel-bias columns: dba enters the residual with -J_ba
    A[:, 0:3, D - 3:D] = -Jv[..., 3:6]
    A[:, 3:6, D - 3:D] = -Jp[..., 3:6]
    b[:, 0:3] += rhs_v
    b[:, 3:6] += rhs_p - torch.einsum("nij,nj->ni", Ri_T, ts[1:] - ts[:-1])
    A_flat, b_flat = A.reshape(n * 6, D), b.reshape(n * 6)
    if ba_prior_w > 0.0:
        prior = torch.zeros((3, D), dtype=dtype, device=dev)
        prior[:, D - 3:D] = ba_prior_w * torch.eye(3, dtype=dtype, device=dev)
        A_flat = torch.cat([A_flat, prior], dim=0)
        b_flat = torch.cat([b_flat, torch.zeros((3,), dtype=dtype, device=dev)], dim=0)
    return A_flat, b_flat


def map_initialize(qs: torch.Tensor, ts: torch.Tensor, preints: Preintegrated) -> InitResult:
    """MAP init over a window of F LiDAR-odometry poses (qs (F,4), ts (F,3))
    and the F-1 preintegrations between them (batched, integrated at the
    biases in `preints.bg/ba`, normally zero)."""
    F = qs.shape[0]
    dbg = _solve_gyro_bias(qs, preints)
    bg = preints.bg[0] + dbg

    # free-gravity linear solve
    A, b = _linear_system(qs, ts, preints, dbg, ba_prior_w=BA_PRIOR_W)
    g_est = lstsq_min_norm(A, b)[0:3]

    # magnitude-constrained 2-dof refinement, twice
    def refine(g_prev):
        g_dir = g_prev / torch.clamp(torch.linalg.vector_norm(g_prev), min=1e-9)
        g_fixed = G_NORM * g_dir
        B = _tangent_basis(g_dir)
        A2, b2 = _linear_system(qs, ts, preints, dbg, g_fixed=g_fixed, g_basis=B,
                                ba_prior_w=BA_PRIOR_W)
        x2 = lstsq_min_norm(A2, b2)
        resid = A2 @ x2 - b2
        return g_fixed + B @ x2[0:2], x2, torch.sqrt(torch.mean(resid ** 2))

    g_est, _, _ = refine(g_est)
    g_est, x2, rms = refine(g_est)
    v = x2[2:2 + 3 * F].reshape(F, 3)
    ba = preints.ba[0] + x2[-3:]
    # acceptance bounds (PoseEstimation.cpp:334-351: bias/velocity sanity)
    ok = ((torch.linalg.vector_norm(bg) < 0.5) & (torch.linalg.vector_norm(ba) < 1.0)
          & (torch.max(torch.linalg.vector_norm(v, dim=-1)) < 30.0) & torch.isfinite(rms))
    return InitResult(g_est, v, bg, ba, rms, ok)
