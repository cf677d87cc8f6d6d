"""Batched local-geometry fits (port of agi_lidar_slam_tpu/fit/geometry_fit.py):
closed-form 3x3 symmetric eigendecomposition, the edge-line fit and the
plane fit of the scan-to-map association.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

_EPS = 1e-12


def eigvals3x3(A: torch.Tensor) -> torch.Tensor:
    """Eigenvalues of symmetric (...,3,3), descending (...,3), trigonometric form."""
    q = (A[..., 0, 0] + A[..., 1, 1] + A[..., 2, 2]) / 3.0
    Bm = A - q[..., None, None] * torch.eye(3, dtype=A.dtype, device=A.device)
    p2 = torch.sum(Bm * Bm, dim=(-1, -2)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=_EPS))
    Cm = Bm / p[..., None, None]
    detC = (
        Cm[..., 0, 0] * (Cm[..., 1, 1] * Cm[..., 2, 2] - Cm[..., 1, 2] * Cm[..., 2, 1])
        - Cm[..., 0, 1] * (Cm[..., 1, 0] * Cm[..., 2, 2] - Cm[..., 1, 2] * Cm[..., 2, 0])
        + Cm[..., 0, 2] * (Cm[..., 1, 0] * Cm[..., 2, 1] - Cm[..., 1, 1] * Cm[..., 2, 0])
    )
    r = torch.clamp(detC / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    l0 = q + 2.0 * p * torch.cos(phi)
    l2 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    l1 = 3.0 * q - l0 - l2
    return torch.stack([l0, l1, l2], dim=-1)


def eigvec3x3(A: torch.Tensor, lmbda: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of symmetric (...,3,3) A for eigenvalue lmbda (...,):
    the best-conditioned cross product of two rows of A - lmbda I."""
    M = A - lmbda[..., None, None] * torch.eye(3, dtype=A.dtype, device=A.device)
    r0, r1, r2 = M[..., 0, :], M[..., 1, :], M[..., 2, :]
    c01 = torch.linalg.cross(r0, r1, dim=-1)
    c12 = torch.linalg.cross(r1, r2, dim=-1)
    c20 = torch.linalg.cross(r2, r0, dim=-1)
    n01 = torch.sum(c01 * c01, dim=-1)
    n12 = torch.sum(c12 * c12, dim=-1)
    n20 = torch.sum(c20 * c20, dim=-1)
    nmax = torch.maximum(n01, torch.maximum(n12, n20))
    v = torch.where((n01 == nmax)[..., None], c01,
                    torch.where((n12 == nmax)[..., None], c12, c20))
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-20)


def eigh3x3(A: torch.Tensor):
    """Symmetric (...,3,3) -> (eigvals descending (...,3), eigvecs (...,3,3) rows);
    eigvecs[..., i, :] is the unit eigenvector of eigvals[..., i]."""
    vals = eigvals3x3(A)
    vecs = torch.stack([eigvec3x3(A, vals[..., i]) for i in range(3)], dim=-2)
    return vals, vecs


class LineFit(NamedTuple):
    centroid: torch.Tensor  # (N,3)
    direction: torch.Tensor  # (N,3) unit
    ok: torch.Tensor  # (N,) passes the eigenvalue-ratio edge test


def _centered_cov(nn_pts: torch.Tensor, nn_valid: torch.Tensor):
    w = nn_valid.to(nn_pts.dtype)[..., None]
    cnt = torch.clamp(torch.sum(w, dim=1), min=1.0)
    centroid = torch.sum(nn_pts * w, dim=1) / cnt
    d = (nn_pts - centroid[:, None, :]) * w
    cov = torch.einsum("nki,nkj->nij", d, d) / cnt[..., None]
    return centroid, cov


def fit_lines(nn_pts: torch.Tensor, nn_valid: torch.Tensor, eig_ratio: float) -> LineFit:
    """Edge-line fit over k neighbors. nn_pts (N,k,3), nn_valid (N,k).
    ok iff all k neighbors exist and lambda_max > eig_ratio * lambda_mid
    (A-LOAM laserMapping.cpp:670)."""
    centroid, cov = _centered_cov(nn_pts, nn_valid)
    vals = eigvals3x3(cov)
    direction = eigvec3x3(cov, vals[:, 0])
    ok = torch.all(nn_valid, dim=1) & (vals[:, 0] > eig_ratio * torch.clamp(vals[:, 1], min=1e-9))
    return LineFit(centroid, direction, ok)


class PlaneFit(NamedTuple):
    normal: torch.Tensor  # (N,3) unit
    offset: torch.Tensor  # (N,) plane is n.x + offset = 0
    ok: torch.Tensor  # (N,)


def fit_planes(nn_pts: torch.Tensor, nn_valid: torch.Tensor, tol: float) -> PlaneFit:
    """Plane fit over k neighbors as centered covariance + smallest eigenvector,
    with the reference's gate |n.p_j + d| < tol over the neighbors and a
    planarity gate on the middle eigenvalue."""
    centroid, cov = _centered_cov(nn_pts, nn_valid)
    vals = eigvals3x3(cov)
    normal = eigvec3x3(cov, vals[:, 2])
    planar = vals[:, 1] > 2.5e-3
    offset = -torch.einsum("ni,ni->n", normal, centroid)
    resid = torch.abs(torch.einsum("nki,ni->nk", nn_pts, normal) + offset[:, None])
    ok = (
        torch.all(nn_valid, dim=1)
        & planar
        & torch.all(torch.where(nn_valid, resid, torch.zeros_like(resid)) < tol, dim=1)
    )
    return PlaneFit(normal, offset, ok)
