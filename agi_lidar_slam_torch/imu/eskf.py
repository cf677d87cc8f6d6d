"""24-dim error-state Kalman filter state and propagation, FAST-LIO2 family
(port of agi_lidar_slam_tpu/imu/eskf.py).

State (manifold): p, q (world_R_imu), q_li/t_li (lidar->IMU extrinsic),
v, bg, ba, g. Error ordering as S-FAST_LIO's use-ikfom:
  [dp(0:3), dtheta(3:6), dtheta_li(6:9), dt_li(9:12), dv(12:15),
   dbg(15:18), dba(18:21), dg(21:24)]
Rotation errors are right-multiplicative: q <- q * exp(dtheta).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import default_device
from ..geometry import so3

DIM = 24


class NavState(NamedTuple):
    p: torch.Tensor  # (3,)
    q: torch.Tensor  # (4,) world_R_imu
    q_li: torch.Tensor  # (4,) imu_R_lidar
    t_li: torch.Tensor  # (3,)
    v: torch.Tensor  # (3,)
    bg: torch.Tensor  # (3,)
    ba: torch.Tensor  # (3,)
    g: torch.Tensor  # (3,) gravity in world (approx [0,0,-9.81])

    @staticmethod
    def identity(device=None) -> "NavState":
        """At rest at the origin, level, on `device` (default: cuda)."""
        device = default_device(device)

        def zeros():
            return torch.zeros(3, device=device)

        return NavState(
            p=zeros(), q=so3.quat_identity(device=device), q_li=so3.quat_identity(device=device),
            t_li=zeros(), v=zeros(), bg=zeros(), ba=zeros(),
            g=torch.tensor([0.0, 0.0, -9.81], device=device),
        )


def boxplus(x: NavState, dx: torch.Tensor) -> NavState:
    """x [+] dx for the 24-dim error vector."""
    return NavState(
        p=x.p + dx[0:3],
        q=so3.quat_normalize(so3.quat_mul(x.q, so3.quat_exp(dx[3:6]))),
        q_li=so3.quat_normalize(so3.quat_mul(x.q_li, so3.quat_exp(dx[6:9]))),
        t_li=x.t_li + dx[9:12],
        v=x.v + dx[12:15],
        bg=x.bg + dx[15:18],
        ba=x.ba + dx[18:21],
        g=x.g + dx[21:24],
    )


def boxminus(a: NavState, b: NavState) -> torch.Tensor:
    """a [-] b."""
    return torch.cat([
        a.p - b.p,
        so3.quat_log(so3.quat_mul(so3.quat_conj(b.q), a.q)),
        so3.quat_log(so3.quat_mul(so3.quat_conj(b.q_li), a.q_li)),
        a.t_li - b.t_li,
        a.v - b.v,
        a.bg - b.bg,
        a.ba - b.ba,
        a.g - b.g,
    ])


class EskfNoise(NamedTuple):
    """Process noise densities (S-FAST_LIO defaults: gyr_cov 0.1, acc_cov 0.1,
    b_gyr_cov 1e-4, b_acc_cov 1e-4)."""

    gyr: float = 0.1
    acc: float = 0.1
    bg: float = 1e-4
    ba: float = 1e-4


def predict(x: NavState, P: torch.Tensor, gyro: torch.Tensor, acc: torch.Tensor, dt,
            noise: EskfNoise = EskfNoise()):
    """One IMU interval: mean + covariance propagation. Returns (x', P').

    Mean: q <- q*exp(w dt); v <- v + (R(a-ba)+g) dt; p <- p + v dt + 1/2 a dt^2.
    F_x / F_w are use-ikfom's df_dx / df_dw (first order). dt == 0 is an exact
    no-op (masked samples)."""
    dt = torch.as_tensor(dt, dtype=P.dtype, device=P.device)
    w_c = gyro - x.bg
    a_c = acc - x.ba
    R = so3.quat_to_matrix(x.q)
    a_w = R @ a_c + x.g

    x_n = NavState(
        p=x.p + x.v * dt + 0.5 * a_w * dt * dt,
        q=so3.quat_normalize(so3.quat_mul(x.q, so3.quat_exp(w_c * dt))),
        q_li=x.q_li, t_li=x.t_li,
        v=x.v + a_w * dt,
        bg=x.bg, ba=x.ba, g=x.g,
    )

    eye3 = torch.eye(3, dtype=P.dtype, device=P.device)
    F = torch.eye(DIM, dtype=P.dtype, device=P.device)
    F[0:3, 12:15] = eye3 * dt  # dp <- dv
    F[3:6, 3:6] = so3.exp_matrix(-w_c * dt)  # dtheta propagation
    F[3:6, 15:18] = -eye3 * dt  # dtheta <- dbg
    F[12:15, 3:6] = -R @ so3.hat(a_c) * dt  # dv <- dtheta
    F[12:15, 18:21] = -R * dt  # dv <- dba
    F[12:15, 21:24] = eye3 * dt  # dv <- dg

    Fw = torch.zeros((DIM, 12), dtype=P.dtype, device=P.device)
    Fw[3:6, 0:3] = -eye3 * dt  # gyro noise -> dtheta
    Fw[12:15, 3:6] = -R * dt  # acc noise -> dv
    Fw[15:18, 6:9] = eye3 * dt  # bias walks
    Fw[18:21, 9:12] = eye3 * dt

    Q = torch.diag(torch.tensor([noise.gyr] * 3 + [noise.acc] * 3 + [noise.bg] * 3
                                + [noise.ba] * 3, dtype=P.dtype, device=P.device))
    P_n = F @ P @ F.T + Fw @ Q @ Fw.T / torch.clamp(dt, min=1e-6)
    return x_n, torch.where(dt > 0, P_n, P)


def lidar_to_world(x: NavState, pts_l: torch.Tensor) -> torch.Tensor:
    """Lidar-frame points (N,3) -> world via the full extrinsic chain."""
    R_li = so3.quat_to_matrix(x.q_li)
    R = so3.quat_to_matrix(x.q)
    body = pts_l @ R_li.T + x.t_li
    return body @ R.T + x.p
