"""Prefix compositions of per-IMU-sample increments (port of `quat_prefix`
and `compose_ltv` of agi_lidar_slam_tpu/imu/preintegration.py).

The reference composes with `jax.lax.associative_scan`. Here both run as a
Hillis-Steele doubling scan: ceil(log2 N) levels, each one batched combine of
every element with the one `offset` before it. At N = 20 IMU samples that is
5 levels of a few launches each, where a step-by-step loop would launch 20
times as many small kernels. The grouping of the f32 products differs from
XLA's scan, so results agree to rounding, not bit for bit.
"""

from __future__ import annotations

import torch

from ..geometry import so3


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
