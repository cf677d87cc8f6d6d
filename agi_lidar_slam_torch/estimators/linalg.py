"""Cholesky factor and solve with the reference's failure semantics, shared by
the IESKF update and the sliding-window solve.

`jnp.linalg.cholesky` returns an all-NaN factor for a matrix that is not
positive-definite, and every solve with it is NaN. `torch.linalg.cholesky`
raises instead (a host read on the card), and `cholesky_ex` returns a partial,
finite factor with the failure in `info`. `cholesky` here keeps the
reference's NaN, decided on the device: no host read.
"""

from __future__ import annotations

import torch


def cholesky(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of symmetric (...,D,D) A; all NaN where A is not
    positive-definite."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info == 0)[..., None, None], L, torch.full_like(L, float("nan")))


def cho_solve(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve (L L^T) X = B for a lower Cholesky factor L; B (D,) or (D,M)."""
    if B.dim() == 1:
        return torch.cholesky_solve(B[:, None], L)[:, 0]
    return torch.cholesky_solve(B, L)
