"""IMU preintegration, on-manifold (Forster style), and the prefix
compositions it is built from (port of
agi_lidar_slam_tpu/imu/preintegration.py).

Error-state ordering (15): [dtheta(0:3), dv(3:6), dp(6:9), dbg(9:12), dba(12:15)].

The reference composes with `jax.lax.associative_scan`. Here `quat_prefix`
and `compose_ltv` run as a Hillis-Steele doubling scan: ceil(log2 N) levels,
each one batched combine of every element with the one `offset` before it.
At N = 20 IMU samples that is 5 levels of a few launches each, where a
step-by-step loop would launch 20 times as many small kernels. The grouping
of the f32 products differs from XLA's scan, so results agree to rounding,
not bit for bit.

Not ported yet: `preintegrate_scan` (the step-by-step oracle) and
`bias_corrected`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import so3


class ImuNoise(NamedTuple):
    """Continuous-time noise densities (LIO-Livox IMUIntegrator.h: acc_n=0.08,
    gyr_n=0.004, acc_w=2e-4, gyr_w=2e-5; LIO-SAM params.yaml imuAccNoise etc.)."""

    acc_n: float = 0.08
    gyr_n: float = 0.004
    acc_w: float = 2.0e-4
    gyr_w: float = 2.0e-5


class Preintegrated(NamedTuple):
    """Relative motion between two stamps, expressed in the first IMU frame."""

    dq: torch.Tensor  # (4,) rotation i->j
    dp: torch.Tensor  # (3,)
    dv: torch.Tensor  # (3,)
    dt: torch.Tensor  # () total time
    cov: torch.Tensor  # (15,15) error covariance
    J_bias: torch.Tensor  # (15,6) d[state]/d[bg, ba] for bias-correction updates
    bg: torch.Tensor  # (3,) linearization gyro bias
    ba: torch.Tensor  # (3,) linearization accel bias


def _doubling_scan(op, xs):
    """Inclusive scan of the tuple of (N, ...) tensors `xs` under the
    associative `op(earlier, later)`."""
    n = xs[0].shape[0]
    offset = 1
    while offset < n:
        combined = op(tuple(x[:-offset] for x in xs), tuple(x[offset:] for x in xs))
        xs = tuple(torch.cat([x[:offset], c], dim=0) for x, c in zip(xs, combined))
        offset *= 2
    return xs


def quat_prefix(dqs: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix products of per-step quaternions (N,4):
    out_k = dq_1 * dq_2 * ... * dq_k (body-frame composition order)."""
    def op(a, b):
        return (so3.quat_normalize(so3.quat_mul(a[0], b[0])),)

    return _doubling_scan(op, (dqs,))[0]


def compose_ltv(F: torch.Tensor, Qd: torch.Tensor):
    """Compose a linear time-varying error recurrence cov' = F cov F^T + Qd.

    F (N,D,D), Qd (N,D,D) applied in order 1..N. Returns the prefix
    compositions (A (N,D,D), C (N,D,D)) with A_k = F_k ... F_1 and C_k the
    accumulated noise."""
    def op(a, b):
        Aa, Ca = a
        Ab, Cb = b
        return Ab @ Aa, Ab @ Ca @ Ab.transpose(-1, -2) + Cb

    return _doubling_scan(op, (F, Qd))


def preintegrate(
    gyro: torch.Tensor,  # (N,3) body rates
    acc: torch.Tensor,  # (N,3) specific force
    dts: torch.Tensor,  # (N,) sample intervals
    mask: torch.Tensor,  # (N,) valid samples
    bg: torch.Tensor,
    ba: torch.Tensor,
    noise: ImuNoise = ImuNoise(),
) -> Preintegrated:
    """Integrate a padded IMU window; invalid samples are skipped exactly
    (dt forced to 0). Per-step rotations and transitions are built for all
    samples at once and prefix-composed (quat_prefix / compose_ltv); the mean
    integrals are cumulative sums."""
    N = gyro.shape[0]
    dev, dtype = gyro.device, gyro.dtype
    dts = torch.where(mask, dts, torch.zeros_like(dts))
    w_c = gyro - bg[None, :]
    a_c = acc - ba[None, :]

    # --- mean: prefix rotations + cumsum integrals --------------------------
    q_incl = quat_prefix(so3.quat_exp(w_c * dts[:, None]))  # (N,4) rotation after step k
    q_excl = torch.cat([so3.quat_identity((1,), dtype, dev), q_incl[:-1]], dim=0)
    R_excl = so3.quat_to_matrix(q_excl)  # (N,3,3) frame-0 <- frame before k
    a0 = torch.einsum("nij,nj->ni", R_excl, a_c)  # accel in frame 0
    dv_steps = a0 * dts[:, None]
    dv_excl = torch.cumsum(dv_steps, dim=0) - dv_steps  # dv before step k
    dp = torch.sum(dv_excl * dts[:, None] + 0.5 * a0 * dts[:, None] ** 2, dim=0)
    dv = torch.sum(dv_steps, dim=0)

    # --- covariance + bias Jacobian: batched (F, Qd) composition ------------
    dt1 = dts[:, None, None]
    I3 = torch.eye(3, dtype=dtype, device=dev).expand(N, 3, 3)
    Rh = R_excl @ so3.hat(a_c)  # (N,3,3)
    F = torch.eye(15, dtype=dtype, device=dev).repeat(N, 1, 1)
    F[:, 0:3, 0:3] = so3.exp_matrix(-w_c * dts[:, None])
    F[:, 0:3, 9:12] = -I3 * dt1
    F[:, 3:6, 0:3] = -Rh * dt1
    F[:, 3:6, 12:15] = -R_excl * dt1
    F[:, 6:9, 3:6] = I3 * dt1
    F[:, 6:9, 0:3] = -0.5 * Rh * dt1 * dt1
    F[:, 6:9, 12:15] = -0.5 * R_excl * dt1 * dt1

    # Qd = G Qc G^T / dt with G block-sparse: assembled directly
    s = 1.0 / torch.clamp(dts, min=1e-6)[:, None, None]
    gn2, an2 = noise.gyr_n**2, noise.acc_n**2
    RRt = R_excl @ R_excl.transpose(-1, -2)  # = I, kept in the reference's exact form
    Qd = torch.zeros((N, 15, 15), dtype=dtype, device=dev)
    Qd[:, 0:3, 0:3] = I3 * gn2 * dt1 * dt1 * s
    Qd[:, 3:6, 3:6] = RRt * an2 * dt1 * dt1 * s
    Qd[:, 3:6, 6:9] = RRt * an2 * 0.5 * dt1**3 * s
    Qd[:, 6:9, 3:6] = RRt * an2 * 0.5 * dt1**3 * s
    Qd[:, 6:9, 6:9] = RRt * an2 * 0.25 * dt1**4 * s
    Qd[:, 9:12, 9:12] = I3 * noise.gyr_w**2 * dt1 * dt1 * s
    Qd[:, 12:15, 12:15] = I3 * noise.acc_w**2 * dt1 * dt1 * s

    A, C = compose_ltv(F, Qd)
    # J propagates as J' = F J from the bias-identity init, so J_N = A_N J_0:
    # the last two column blocks of A_N
    return Preintegrated(q_incl[-1], dp, dv, torch.sum(dts), C[-1], A[-1][:, 9:15], bg, ba)
