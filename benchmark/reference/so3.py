# Frozen copy of agi_lidar_slam_torch/geometry/so3.py at commit 88e7c49, for the
# benchmark's plain reference: it imports nothing of the program, and
# later changes to the program do not reach it.
"""SO(3) primitives: rotation vectors, quaternions, matrices.

Port of agi_lidar_slam_tpu/geometry/so3.py. All functions are batched over
arbitrary leading dimensions, with small-angle Taylor branches for f32
stability. Quaternion convention: (w, x, y, z), normalized, Hamilton product.
"""

from __future__ import annotations

import math

import torch

from .device import default_device

_EPS = 1e-8


def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix [w]x such that hat(w) @ v == cross(w, v). (...,3)->(...,3,3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of hat. (...,3,3)->(...,3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def exp_matrix(w: torch.Tensor) -> torch.Tensor:
    """SO(3) exponential: rotation vector (...,3) -> rotation matrix (...,3,3)."""
    theta2 = torch.sum(w * w, dim=-1, keepdim=True)[..., None]  # (...,1,1)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    small = theta2 < 1e-8
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    W = hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    return eye + a * W + b * (W @ W)


def _jacobian_coeffs(w: torch.Tensor):
    """theta^2 and the mask of the small-angle branch, (...,1,1)."""
    theta2 = torch.sum(w * w, dim=-1, keepdim=True)[..., None]
    return theta2, theta2 < 1e-8


def right_jacobian(w: torch.Tensor) -> torch.Tensor:
    """Right Jacobian of SO(3), Exp(w + d) ~ Exp(w) Exp(Jr(w) d):
    I - (1 - cos t)/t^2 [w]x + (t - sin t)/t^3 [w]x^2. (...,3)->(...,3,3)."""
    theta2, small = _jacobian_coeffs(w)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    a = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    b = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (theta2 * theta))
    W = hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    return eye - a * W + b * (W @ W)


def right_jacobian_inv(w: torch.Tensor) -> torch.Tensor:
    """Inverse right Jacobian, Log(Exp(w) Exp(d)) ~ w + Jr^-1(w) d:
    I + [w]x / 2 + (1/t^2 - (1 + cos t) / (2 t sin t)) [w]x^2."""
    theta2, small = _jacobian_coeffs(w)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    c = torch.where(small, 1.0 / 12.0 + theta2 / 720.0,
                    1.0 / theta2 - (1.0 + torch.cos(theta)) / (2.0 * theta * torch.sin(theta)))
    W = hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    return eye + 0.5 * W + c * (W @ W)


def log_matrix(R: torch.Tensor) -> torch.Tensor:
    """SO(3) logarithm: rotation matrix (...,3,3) -> rotation vector (...,3).

    Near pi it switches to the diagonal-based extraction (~1e-3 in f32)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_t)
    sin_t = torch.sin(theta)
    axis_unnorm = vee(R - R.transpose(-1, -2))  # = 2 sin(t) * axis
    small = theta[..., None] < 1e-4
    near_pi = (math.pi - theta[..., None]) < 0.03
    scale = torch.where(
        small,
        0.5 + theta[..., None] ** 2 / 12.0,
        theta[..., None] / torch.clamp(2.0 * sin_t[..., None], min=_EPS),
    )
    w_generic = scale * axis_unnorm
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    axis2 = torch.clamp(
        (diag - cos_t[..., None]) / torch.clamp(1.0 - cos_t[..., None], min=_EPS), min=0.0)
    axis_pi = torch.sqrt(axis2)
    one = torch.ones_like(cos_t)
    sx = torch.where(R[..., 2, 1] - R[..., 1, 2] >= 0, one, -one)
    sy = torch.where(R[..., 0, 2] - R[..., 2, 0] >= 0, one, -one)
    sz = torch.where(R[..., 1, 0] - R[..., 0, 1] >= 0, one, -one)
    axis_pi = axis_pi * torch.stack([sx, sy, sz], dim=-1)
    w_pi = theta[..., None] * axis_pi
    return torch.where(near_pi, w_pi, w_generic)


def quat_identity(shape=(), dtype=torch.float32, device=None) -> torch.Tensor:
    """Identity quaternions of `shape` on `device` (default: cuda)."""
    device = default_device(device)
    q = torch.zeros(tuple(shape) + (4,), dtype=dtype, device=device)
    # fill_, not `q[..., 0] = 1.0`: assigning a Python number copies it from
    # the host, which on the card synchronizes
    q[..., 0].fill_(1.0)
    return q


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=_EPS)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a*b, batched."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    # no constant tensor from a Python list: on the card that is a host-to-device
    # copy, and it synchronizes
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_exp(w: torch.Tensor) -> torch.Tensor:
    """Rotation vector (...,3) -> unit quaternion (...,4)."""
    theta2 = torch.sum(w * w, dim=-1, keepdim=True)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    half = 0.5 * theta
    small = theta2 < 1e-8
    k = torch.where(small, 0.5 - theta2 / 48.0, torch.sin(half) / theta)
    # kept (...,1): torch.func's forward mode turns a where of 0-d tensors
    # into a float64 tangent
    qw = torch.where(small, 1.0 - theta2 / 8.0, torch.cos(half))
    return quat_normalize(torch.cat([qw, k * w], dim=-1))


def quat_log(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion -> rotation vector (...,3)."""
    q = torch.where(q[..., 0:1] < 0, -q, q)  # shortest arc
    vnorm = torch.linalg.vector_norm(q[..., 1:], dim=-1, keepdim=True)
    w = torch.clamp(q[..., 0:1], -1.0, 1.0)
    theta = 2.0 * torch.arctan2(vnorm, w)
    small = vnorm < 1e-6
    scale = torch.where(small, 2.0 / torch.clamp(w, min=_EPS),
                        theta / torch.clamp(vnorm, min=_EPS))
    return scale * q[..., 1:]


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """(...,4) -> (...,3,3)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    ww, xx, yy, zz = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    return torch.stack(
        [
            torch.stack([ww + xx - yy - zz, 2 * (xy - wz), 2 * (xz + wy)], dim=-1),
            torch.stack([2 * (xy + wz), ww - xx + yy - zz, 2 * (yz - wx)], dim=-1),
            torch.stack([2 * (xz - wy), 2 * (yz + wx), ww - xx - yy + zz], dim=-1),
        ],
        dim=-2,
    )


def matrix_to_quat(R: torch.Tensor) -> torch.Tensor:
    """(...,3,3) -> (...,4), branch-free Shepperd-style (stable in f32)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.sqrt(torch.clamp(1.0 + tr, min=0.0)) * 0.5
    qx = torch.sqrt(torch.clamp(1.0 + m00 - m11 - m22, min=0.0)) * 0.5
    qy = torch.sqrt(torch.clamp(1.0 - m00 + m11 - m22, min=0.0)) * 0.5
    qz = torch.sqrt(torch.clamp(1.0 - m00 - m11 + m22, min=0.0)) * 0.5
    dw, dx = 4 * torch.clamp(qw, min=_EPS), 4 * torch.clamp(qx, min=_EPS)
    dy, dz = 4 * torch.clamp(qy, min=_EPS), 4 * torch.clamp(qz, min=_EPS)
    c0 = torch.stack([qw, (m21 - m12) / dw, (m02 - m20) / dw, (m10 - m01) / dw], dim=-1)
    c1 = torch.stack([(m21 - m12) / dx, qx, (m01 + m10) / dx, (m02 + m20) / dx], dim=-1)
    c2 = torch.stack([(m02 - m20) / dy, (m01 + m10) / dy, qy, (m12 + m21) / dy], dim=-1)
    c3 = torch.stack([(m10 - m01) / dz, (m02 + m20) / dz, (m12 + m21) / dz, qz], dim=-1)
    best = torch.argmax(torch.stack([qw, qx, qy, qz], dim=-1), dim=-1)  # first max
    cands = torch.stack([c0, c1, c2, c3], dim=-2)  # (...,4cand,4)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    return quat_normalize(torch.gather(cands, -2, idx)[..., 0, :])


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v (...,3) by quaternion q (...,4)."""
    qv = q[..., 1:]
    qv, v = torch.broadcast_tensors(qv, v)
    t = 2.0 * torch.linalg.cross(qv, v, dim=-1)
    return v + q[..., 0:1] * t + torch.linalg.cross(qv, t, dim=-1)


def slerp(q0: torch.Tensor, q1: torch.Tensor, t) -> torch.Tensor:
    """Spherical interpolation between unit quaternions; t broadcastable (...,)."""
    t = torch.as_tensor(t, dtype=q0.dtype, device=q0.device)[..., None]
    dot = torch.sum(q0 * q1, dim=-1, keepdim=True)
    q1 = torch.where(dot < 0, -q1, q1)
    dot = torch.abs(dot)
    theta = torch.arccos(torch.clamp(dot, -1.0, 1.0))
    sin_t = torch.sin(theta)
    lin = dot > 0.9995
    w0 = torch.where(lin, 1.0 - t, torch.sin((1.0 - t) * theta) / torch.clamp(sin_t, min=_EPS))
    w1 = torch.where(lin, t, torch.sin(t * theta) / torch.clamp(sin_t, min=_EPS))
    return quat_normalize(w0 * q0 + w1 * q1)
