"""Tightly-coupled LIO engine: IESKF + direct point-to-plane, FAST-LIO2 family
(port of agi_lidar_slam_tpu/runtime/lio_pipeline.py).

One call per (scan, IMU window) pair:

  propagate the 24-dim ESKF through the IMU window, recording the per-sample
  poses  ->  undistort every point to the scan-end frame  ->  voxel
  downsample  ->  iterated IESKF update against the hashed voxel map (the
  octant-KNN kernel probes it once per scan for the candidate cache)  ->
  divergence fallback  ->  map insert  ->  rolling map bound.

No feature extraction: every downsampled point is a point-to-plane
constraint. PyTorch runs the step eagerly; the state lives on the device
`init_lio_state` put it on (cuda unless asked otherwise).

`_process_lio_body` takes the update as an argument (`update_fn`, the
signature of update_iterated): the multi-device step
(parallel/sharding.sharded_lio_step) runs the same body with the update's
point axis sharded.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..config import MapConfig
from ..device import default_device
from ..estimators.ieskf import IeskfConfig, update_iterated
from ..geometry import so3
from ..imu.eskf import DIM, EskfNoise, NavState, lidar_to_world
from ..imu.preintegration import compose_ltv, quat_prefix
from ..map.hash_map import HashVoxelMap, bound_map, empty_map, insert_with_stats
from ..pointcloud.voxel import voxel_downsample


class LioConfig(NamedTuple):
    # 2.0 m blocks, octant8, 2^14 slots: the octant-KNN kernel serves the
    # IESKF's probe; overflow inserts are counted in LioResult.n_dropped
    map: MapConfig = MapConfig(sub_voxel=0.5, block_sub=4, log2_slots=14)
    ieskf: IeskfConfig = IeskfConfig()
    noise: EskfNoise = EskfNoise()
    scan_voxel: float = 0.5  # measurement downsample leaf (m)
    max_scan_pts: int = 8192  # downsampled measurement budget
    bound_radius: float = 150.0  # rolling local-map bound (m, per axis); 0 disables


class ImuWindow(NamedTuple):
    """Padded IMU samples covering one sweep. gyro/acc (M,3); dt (M,) interval
    AFTER each sample; mask (M,)."""

    gyro: torch.Tensor
    acc: torch.Tensor
    dt: torch.Tensor
    mask: torch.Tensor


class LioState(NamedTuple):
    x: NavState
    P: torch.Tensor  # (24,24)
    map: HashVoxelMap
    frame: torch.Tensor


class LioResult(NamedTuple):
    x: NavState
    n_matches: torch.Tensor
    rms: torch.Tensor
    n_dropped: torch.Tensor  # map inserts lost to full chains


def init_lio_state(cfg: LioConfig, x0: NavState | None = None, p0_scale: float = 1e-3,
                   device=None) -> LioState:
    """A filter at `x0` (default: at rest at the origin) with an empty map,
    on `device` (default: cuda)."""
    device = default_device(device)
    x = (NavState.identity(device) if x0 is None
         else NavState(*(a.to(device) for a in x0)))
    return LioState(x=x, P=torch.eye(DIM, device=device) * p0_scale,
                    map=empty_map(cfg.map, device),
                    frame=torch.zeros((), dtype=torch.int32, device=device))


def static_init(gyro: torch.Tensor, acc: torch.Tensor, mask: torch.Tensor) -> NavState:
    """Biases + gravity from a stationary window: bg = mean gyro, gravity
    along the mean specific force; orientation stays identity (gravity is
    estimated in-state). On the device of `gyro`."""
    w = mask.to(torch.float32)[:, None]
    cnt = torch.clamp(torch.sum(w), min=1.0)
    bg = torch.sum(gyro * w, dim=0) / cnt
    a_mean = torch.sum(acc * w, dim=0) / cnt
    g = -9.81 * a_mean / torch.clamp(torch.linalg.vector_norm(a_mean), min=1e-6)
    return NavState.identity(gyro.device)._replace(bg=bg, g=g)


def _propagate_window(x: NavState, P: torch.Tensor, imu: ImuWindow, noise: EskfNoise):
    """Propagate the 24-dim ESKF over the IMU window. Returns the final (x, P)
    and the per-sample pose track (qs (M+1,4), ps (M+1,3), ts (M+1,)) for
    undistortion.

    Batched: prefix quaternion products give all sample rotations at once,
    the velocity and position integrals are cumsums, and the covariance
    composes the per-step (F, Qd) pairs by a doubling scan (the same
    recurrence as imu.eskf.predict step by step)."""
    M = imu.gyro.shape[0]
    dev, dtype = P.device, P.dtype
    dts = torch.where(imu.mask, imu.dt, torch.zeros_like(imu.dt))
    w_c = imu.gyro - x.bg[None, :]
    a_c = imu.acc - x.ba[None, :]

    # --- mean track ---------------------------------------------------------
    q_incl = quat_prefix(so3.quat_exp(w_c * dts[:, None]))  # body increments 1..k
    qs = torch.cat([x.q[None], so3.quat_normalize(so3.quat_mul(x.q[None], q_incl))])  # (M+1,4)
    R_excl = so3.quat_to_matrix(qs[:-1])  # (M,3,3) world_R_body before step k
    a_w = torch.einsum("nij,nj->ni", R_excl, a_c) + x.g[None, :]
    dv_steps = a_w * dts[:, None]
    v_excl = x.v[None, :] + torch.cumsum(dv_steps, dim=0) - dv_steps  # (M,3)
    p_steps = v_excl * dts[:, None] + 0.5 * a_w * dts[:, None] ** 2
    ps = x.p[None, :] + torch.cat([torch.zeros((1, 3), dtype=dtype, device=dev),
                                   torch.cumsum(p_steps, dim=0)])  # (M+1,3)
    v_end = x.v + torch.sum(dv_steps, dim=0)
    x_end = x._replace(q=qs[-1], p=ps[-1], v=v_end)
    ts = torch.cat([torch.zeros(1, dtype=dtype, device=dev), torch.cumsum(dts, dim=0)])

    # --- covariance: batched (F, Qd) composition ----------------------------
    dt1 = dts[:, None, None]
    I3 = torch.eye(3, dtype=dtype, device=dev).expand(M, 3, 3)
    Rh = torch.einsum("nij,njk->nik", R_excl, so3.hat(a_c))
    F = torch.eye(DIM, dtype=dtype, device=dev).repeat(M, 1, 1)
    F[:, 0:3, 12:15] = I3 * dt1
    F[:, 3:6, 3:6] = so3.exp_matrix(-w_c * dts[:, None])
    F[:, 3:6, 15:18] = -I3 * dt1
    F[:, 12:15, 3:6] = -Rh * dt1
    F[:, 12:15, 18:21] = -R_excl * dt1
    F[:, 12:15, 21:24] = I3 * dt1
    # Qd = Fw Q Fw^T / dt (Fw block-sparse as in eskf.predict)
    s = 1.0 / torch.clamp(dts, min=1e-6)[:, None, None]
    Qd = torch.zeros((M, DIM, DIM), dtype=dtype, device=dev)
    Qd[:, 3:6, 3:6] = I3 * noise.gyr * dt1 * dt1 * s
    Qd[:, 12:15, 12:15] = (torch.einsum("nij,nkj->nik", R_excl, R_excl)
                           * noise.acc * dt1 * dt1 * s)
    Qd[:, 15:18, 15:18] = I3 * noise.bg * dt1 * dt1 * s
    Qd[:, 18:21, 18:21] = I3 * noise.ba * dt1 * dt1 * s

    A, C = compose_ltv(F, Qd)
    P_end = A[-1] @ P @ A[-1].T + C[-1]
    return x_end, P_end, qs, ps, ts


def undistort_to_end(pts_l: torch.Tensor, pts_t: torch.Tensor, x_end: NavState,
                     qs: torch.Tensor, ps: torch.Tensor, ts: torch.Tensor) -> torch.Tensor:
    """Map each lidar point (N,3), captured at pts_t (N,) seconds from the
    sweep start, into the scan-END lidar frame through the recorded pose track:
    p_end = T_il^-1 T_w_end^-1 T_w(t) T_il p."""
    idx = torch.clamp(torch.searchsorted(ts, pts_t, right=True), 1, ts.shape[0] - 1)
    t0 = ts[idx - 1]
    t1 = ts[idx]
    s = torch.clamp((pts_t - t0) / torch.clamp(t1 - t0, min=1e-9), 0.0, 1.0)
    q_t = so3.slerp(qs[idx - 1], qs[idx], s)
    p_t = (1.0 - s)[:, None] * ps[idx - 1] + s[:, None] * ps[idx]

    R_li = so3.quat_to_matrix(x_end.q_li)
    body = pts_l @ R_li.T + x_end.t_li
    world = so3.quat_rotate(q_t, body) + p_t
    # back into the end-of-sweep IMU frame, then the lidar frame
    body_end = so3.quat_rotate(so3.quat_conj(x_end.q), world - x_end.p)
    return (body_end - x_end.t_li) @ R_li


def _process_lio_body(state: LioState, pts_l: torch.Tensor, pts_t: torch.Tensor,
                      pts_mask: torch.Tensor, imu: ImuWindow, cfg: LioConfig,
                      update_fn=None) -> Tuple[LioState, LioResult]:
    """The LIO step over its measurement update (`update_fn`, the signature
    of update_iterated; the module's own where None, looked up at call
    time)."""
    upd = update_fn or update_iterated
    x_prop, P_prop, qs, ps, ts = _propagate_window(state.x, state.P, imu, cfg.noise)

    und = undistort_to_end(pts_l, pts_t, x_prop, qs, ps, ts)
    ds = voxel_downsample(und, pts_mask, cfg.scan_voxel, cfg.max_scan_pts)

    x_new, P_new, n_ok, rms = upd(x_prop, P_prop, ds, state.map, cfg.map, cfg.ieskf)

    # failure detection: a diverged velocity or bias estimate resets the
    # biases and re-inflates the covariance instead of letting the filter
    # run away (decided on the device, no host read)
    diverged = ((torch.linalg.vector_norm(x_new.v) > 30.0)
                | (torch.linalg.vector_norm(x_new.ba) > 1.0)
                | (torch.linalg.vector_norm(x_new.bg) > 1.0)
                | ~torch.all(torch.isfinite(torch.cat([x_new.p, x_new.v]))))
    zeros = torch.zeros_like(x_prop.v)
    fallback = x_prop._replace(v=zeros, bg=zeros, ba=zeros)
    x_new = NavState(*(torch.where(diverged, a, b) for a, b in zip(fallback, x_new)))
    P_new = torch.where(diverged, torch.eye(DIM, dtype=P_new.dtype, device=P_new.device) * 1e-1,
                        P_new)

    # map update in the corrected pose
    new_map, n_drop = insert_with_stats(state.map, lidar_to_world(x_new, ds.xyz), ds.mask,
                                        cfg.map)
    if cfg.bound_radius > 0:
        new_map = bound_map(new_map, x_new.p, cfg.bound_radius, cfg.map)
    return (LioState(x_new, P_new, new_map, state.frame + 1),
            LioResult(x_new, n_ok, rms, n_drop))


def process_lio_scan(state: LioState, pts_l: torch.Tensor, pts_t: torch.Tensor,
                     pts_mask: torch.Tensor, imu: ImuWindow,
                     cfg: LioConfig) -> Tuple[LioState, LioResult]:
    """One LIO step. pts_l (N,3) raw lidar points as captured, pts_t (N,)
    seconds from the sweep start, pts_mask (N,). Returns (new state, result);
    `state` is not modified."""
    return _process_lio_body(state, pts_l, pts_t, pts_mask, imu, cfg)
