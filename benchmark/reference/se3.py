# Frozen copy of agi_lidar_slam_torch/geometry/se3.py at commit 88e7c49, for the
# benchmark's plain reference: it imports nothing of the program, and
# later changes to the program do not reach it.
"""SE(3) pose container and operations.

Port of agi_lidar_slam_tpu/geometry/se3.py. Perturbation convention for the
Gauss-Newton estimators:
    R <- R @ Exp(dtheta)   (right / body-frame rotation perturbation)
    t <- t + dt            (additive world-frame translation)
so for a world point w = R p + t of a sensor point p:
    dw/dtheta = -R [p]x ,   dw/dt = I.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .device import default_device
from . import so3


class Pose(NamedTuple):
    """Batched SE(3): quaternion (...,4) wxyz + translation (...,3)."""

    q: torch.Tensor
    t: torch.Tensor

    @staticmethod
    def identity(shape=(), dtype=torch.float32, device=None) -> "Pose":
        """Identity poses of `shape` on `device` (default: cuda)."""
        device = default_device(device)
        return Pose(so3.quat_identity(shape, dtype, device),
                    torch.zeros(tuple(shape) + (3,), dtype=dtype, device=device))

    def matrix(self) -> torch.Tensor:
        """(...,4,4) homogeneous matrix."""
        R = so3.quat_to_matrix(self.q)
        top = torch.cat([R, self.t[..., None]], dim=-1)
        bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=self.t.dtype,
                              device=self.t.device).expand(top.shape[:-2] + (1, 4))
        return torch.cat([top, bottom], dim=-2)


def compose(a: Pose, b: Pose) -> Pose:
    """a ∘ b (apply b first, then a)."""
    return Pose(
        so3.quat_normalize(so3.quat_mul(a.q, b.q)),
        so3.quat_rotate(a.q, b.t) + a.t,
    )


def inverse(p: Pose) -> Pose:
    qc = so3.quat_conj(p.q)
    return Pose(qc, -so3.quat_rotate(qc, p.t))


def apply(p: Pose, pts: torch.Tensor) -> torch.Tensor:
    """Transform points (...,N,3) by pose (...)."""
    R = so3.quat_to_matrix(p.q)
    return pts @ R.transpose(-1, -2) + p.t[..., None, :]


def boxplus(p: Pose, delta: torch.Tensor) -> Pose:
    """Apply 6-dof GN update delta = (dtheta(3), dt(3)) under the convention above."""
    dq = so3.quat_exp(delta[..., :3])
    return Pose(so3.quat_normalize(so3.quat_mul(p.q, dq)), p.t + delta[..., 3:])


def boxminus(a: Pose, b: Pose) -> torch.Tensor:
    """delta such that boxplus(b, delta) == a (rotation part exact, translation additive)."""
    dq = so3.quat_mul(so3.quat_conj(b.q), a.q)
    return torch.cat([so3.quat_log(dq), a.t - b.t], dim=-1)


def interpolate(a: Pose, b: Pose, s) -> Pose:
    """Pose interpolation (slerp + lerp): s=0 -> a, s=1 -> b."""
    s = torch.as_tensor(s, dtype=a.t.dtype, device=a.t.device)
    return Pose(so3.slerp(a.q, b.q, s), (1.0 - s)[..., None] * a.t + s[..., None] * b.t)


def apply_interpolated(rel: Pose, tau: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """p' = interp(I, rel, tau) . p — the constant-velocity deskew transform
    (A-LOAM TransformToStart, laserOdometry.cpp:124-145), with nlerp rotation
    interpolation as in the reference."""
    tau = tau[..., None]
    ident = so3.quat_identity(dtype=rel.q.dtype, device=rel.q.device)
    q_rel = torch.where(rel.q[0] < 0, -rel.q, rel.q)  # same hemisphere as identity
    q_i = so3.quat_normalize((1.0 - tau) * ident + tau * q_rel)
    return so3.quat_rotate(q_i, pts) + tau * rel.t
