# Frozen copy of agi_lidar_slam_torch/estimators/sym_eig.py at commit 88e7c49, for the
# benchmark's plain reference: it imports nothing of the program, and
# later changes to the program do not reach it.
"""Batched symmetric eigendecomposition of small matrices, plain: the
Gauss-Newton solves' eigh. torch.linalg.eigh of the lower triangle in
float64, rounded to the input's type, with NaN outputs for a matrix that
holds a non-finite entry there (eigh raises on one; the program's kernel
gives NaN). The program runs a CUDA kernel of its own here, cyclic Jacobi in
fp64 registers; in float32 eigh's eigenvalues lie some ulps off the exact
ones, and the solves' degeneracy test (an eigenvalue against a threshold)
turns such a difference into another step now and then.
"""

from __future__ import annotations

import torch


def sym_eig(a: torch.Tensor):
    """(eigenvalues ascending, eigenvectors as columns) of the symmetric
    matrices `a` (..., n, n), read from their lower triangle."""
    bad = ~torch.isfinite(torch.tril(a)).all(dim=(-2, -1))
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    vals, vecs = torch.linalg.eigh(torch.where(bad[..., None, None], eye, a).double())
    vals, vecs = vals.to(a.dtype), vecs.to(a.dtype)
    nan = torch.full((), float("nan"), dtype=a.dtype, device=a.device)
    return (torch.where(bad[..., None], nan, vals),
            torch.where(bad[..., None, None], nan, vecs))
