"""GPS+IMU navsat fusion: the robot_localization `ekf_gps` analog (port of
agi_lidar_slam_tpu/imu/navsat.py).

The reference's LIO-SAM launch graph does not consume raw GPS: `run.launch`
includes robot_localization's navsat EKF (`ekf_gps`), which fuses IMU with
NavSatFix into a smoothed local-frame odometry stream, and `gpsTopic:
"odometry/gpsz"` feeds that into addGPSFactor (LIO-SAM config/params.yaml:23).
This module is a 15-dim error-state KF [dtheta, dv, dp, dbg, dba] that

  * predicts through each IMU window with the same batched prefix
    composition the engines use (imu/preintegration.compose_ltv),
  * updates on each GPS fix with its reported position covariance,
  * emits a smoothed position + velocity + covariance stream — the
    "odometry/gpsz" equivalent to hand to LioSamDriver.process(gps=...) /
    slam_pipeline's GPS factors.

Every step stays on the device of the filter's state: the 3x3 innovation
covariance is inverted with `inv_ex` (`torch.linalg.inv` checks its result
on the host), and a fix from the host goes over without a sync.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..device import default_device, host_to_device
from ..geometry import so3
from .preintegration import compose_ltv, quat_prefix


class NavsatState(NamedTuple):
    q: torch.Tensor  # (4,) world_R_imu
    p: torch.Tensor  # (3,)
    v: torch.Tensor  # (3,)
    bg: torch.Tensor  # (3,)
    ba: torch.Tensor  # (3,)
    P: torch.Tensor  # (15,15) error cov [dtheta, dv, dp, dbg, dba]


class NavsatNoise(NamedTuple):
    """Continuous densities; defaults follow LIO-SAM's params.yaml IMU block
    (imuAccNoise 3.99e-2, imuGyrNoise 1.57e-3, walks 6.4e-5 / 3.5e-5)."""

    acc_n: float = 3.99e-2
    gyr_n: float = 1.57e-3
    acc_w: float = 6.4e-5
    gyr_w: float = 3.5e-5


GRAV_Z = -9.81


def init_navsat(p0: torch.Tensor | None = None,
                v0: torch.Tensor | None = None,
                q0: torch.Tensor | None = None,
                p0_sigma: float = 1.0,
                ori_sigma: float = 0.05,
                v_sigma: float = 0.2,
                device=None) -> NavsatState:
    """A filter state on `device` (default: cuda). P0 is structured: a flat
    eye(15) would claim ~1 rad of attitude uncertainty, and the first GPS
    update would then launder position noise into attitude/velocity through
    the propagated cross-covariances."""
    device = default_device(device)
    diag = torch.cat([torch.full((3,), s, device=device) for s in (
        ori_sigma**2, v_sigma**2, p0_sigma**2, 1e-4, 1e-2)])

    def vec(a):
        return torch.zeros((3,), device=device) if a is None else a.to(device, torch.float32)

    return NavsatState(
        q=so3.quat_identity(device=device) if q0 is None else q0.to(device, torch.float32),
        p=vec(p0), v=vec(v0), bg=torch.zeros((3,), device=device),
        ba=torch.zeros((3,), device=device), P=torch.diag(diag))


def navsat_predict(st: NavsatState, gyro: torch.Tensor, acc: torch.Tensor,
                   dts: torch.Tensor, mask: torch.Tensor,
                   noise: NavsatNoise = NavsatNoise()) -> NavsatState:
    """Propagate through one padded IMU window (batched, no scan chain)."""
    M = gyro.shape[0]
    dev, dtype = st.P.device, st.P.dtype
    dts = torch.where(mask, dts, torch.zeros_like(dts))
    w_c = gyro - st.bg[None, :]
    a_c = acc - st.ba[None, :]

    q_incl = quat_prefix(so3.quat_exp(w_c * dts[:, None]))
    qs = torch.cat([st.q[None], so3.quat_normalize(so3.quat_mul(st.q[None], q_incl))], dim=0)
    R_excl = so3.quat_to_matrix(qs[:-1])
    a_w = torch.einsum("nij,nj->ni", R_excl, a_c)
    a_w = torch.cat([a_w[:, :2], a_w[:, 2:] + GRAV_Z], dim=1)
    dv_steps = a_w * dts[:, None]
    v_excl = st.v[None, :] + torch.cumsum(dv_steps, dim=0) - dv_steps
    p_new = st.p + torch.sum(v_excl * dts[:, None] + 0.5 * a_w * dts[:, None] ** 2, dim=0)
    v_new = st.v + torch.sum(dv_steps, dim=0)

    dt1 = dts[:, None, None]
    I3 = torch.eye(3, dtype=dtype, device=dev).expand(M, 3, 3)
    Rh = R_excl @ so3.hat(a_c)
    F = torch.eye(15, dtype=dtype, device=dev).repeat(M, 1, 1)
    F[:, 0:3, 0:3] = so3.exp_matrix(-w_c * dts[:, None])
    F[:, 0:3, 9:12] = -I3 * dt1
    F[:, 3:6, 0:3] = -Rh * dt1
    F[:, 3:6, 12:15] = -R_excl * dt1
    F[:, 6:9, 3:6] = I3 * dt1
    s = 1.0 / torch.clamp(dts, min=1e-6)[:, None, None]
    Qd = torch.zeros((M, 15, 15), dtype=dtype, device=dev)
    Qd[:, 0:3, 0:3] = I3 * noise.gyr_n**2 * dt1 * dt1 * s
    Qd[:, 3:6, 3:6] = I3 * noise.acc_n**2 * dt1 * dt1 * s
    Qd[:, 9:12, 9:12] = I3 * noise.gyr_w**2 * dt1 * dt1 * s
    Qd[:, 12:15, 12:15] = I3 * noise.acc_w**2 * dt1 * dt1 * s
    A, C = compose_ltv(F, Qd)
    P_new = A[-1] @ st.P @ A[-1].T + C[-1]
    return NavsatState(qs[-1], p_new, v_new, st.bg, st.ba, 0.5 * (P_new + P_new.T))


def navsat_update(st: NavsatState, fix: torch.Tensor, cov_diag: torch.Tensor) -> NavsatState:
    """GPS position update (Joseph form). fix (3,) local-frame position,
    cov_diag (3,) the NavSatFix position_covariance diagonal."""
    dev, dtype = st.P.device, st.P.dtype
    Rm = torch.diag(torch.clamp(cov_diag, min=1e-4))
    # H selects the position block (6:9): H P H^T and P H^T are slices
    S = st.P[6:9, 6:9] + Rm
    K = st.P[:, 6:9] @ torch.linalg.inv_ex(S).inverse
    dx = K @ (fix - st.p)
    IKH = torch.eye(15, dtype=dtype, device=dev)
    IKH = torch.cat([IKH[:, :6], IKH[:, 6:9] - K, IKH[:, 9:]], dim=1)
    P_new = IKH @ st.P @ IKH.T + K @ Rm @ K.T
    return NavsatState(
        q=so3.quat_normalize(so3.quat_mul(st.q, so3.quat_exp(dx[0:3]))),
        v=st.v + dx[3:6],
        p=st.p + dx[6:9],
        bg=st.bg + dx[9:12],
        ba=st.ba + dx[12:15],
        P=0.5 * (P_new + P_new.T),
    )


class NavsatFilter:
    """Host driver: feed (IMU window, optional GPS fix) per sweep; read back
    the smoothed odometry (position + covariance diagonal) to hand to the
    engines' GPS factors — the `odometry/gpsz` stream of the reference's
    launch graph. The state lives on `device` (default: cuda); inputs from
    the host are copied there without a sync."""

    def __init__(self, p0=None, v0=None, q0=None, noise: NavsatNoise = NavsatNoise(),
                 device=None):
        self.device = default_device(device)
        self.state = init_navsat(p0=p0, v0=v0, q0=q0, device=self.device)
        self.noise = noise

    def _dev(self, a, dtype=torch.float32):
        return host_to_device(a, self.device).to(dtype)

    def step(self, gyro, acc, dts, mask,
             fix: Optional[torch.Tensor] = None,
             fix_cov: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (smoothed position (3,), position cov diag (3,)), on the
        filter's device."""
        self.state = navsat_predict(self.state, self._dev(gyro), self._dev(acc),
                                    self._dev(dts), self._dev(mask, torch.bool), self.noise)
        if fix is not None:
            cov = (self._dev(fix_cov) if fix_cov is not None
                   else torch.full((3,), 4.0, device=self.device))
            self.state = navsat_update(self.state, self._dev(fix), cov)
        return self.state.p, torch.diagonal(self.state.P)[6:9]
