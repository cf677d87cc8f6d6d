"""Integrated LIO-SAM configuration: IMU-coupled scan-to-map odometry +
keyframe factor graph, plus the IMU-rate pose stream (port of
agi_lidar_slam_tpu/runtime/liosam_pipeline.py).

Per scan:

* IMU preintegration of the window at the current bias estimate;
* IMU deskew: gyro rotation track over the sweep + constant-velocity
  translation, per point, into the sweep-end frame;
* curvature features, voxel downsample, and the scan-to-map GN of the
  odometry (`solve_scan2map`, the octant-KNN kernel on the card) from the
  preintegrated prediction;
* fusion: the two-node factor graph of LIO-SAM's imuPreintegration solved in
  closed form, i.e. a Kalman update of the 15-dim error state
  [dtheta, dv, dp, dbg, dba] with the mapping pose as a 6-dof measurement,
  inflated when the GN solve was degenerate; a divergence test resets
  velocity, biases and covariance on the device;
* map insert + rolling bound.

The keyframe bank, loop closure, GPS and correctPoses backend is
`slam_pipeline`'s (LioSamDriver below). `_process_liosam_body` takes the
scan-to-map solve as an argument (`solve_fn`): the multi-device step
(parallel/sharding.sharded_liosam_step) runs the same body with the feature
point axis sharded.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..config import PipelineConfig, preset_aloam_kitti64
from ..device import default_device
from ..estimators.gn_scan2map import GnStats, solve_scan2map
from ..features.curvature import extract_features
from ..geometry import se3, so3
from ..graph.keyframes import empty_bank, last_index
from ..graph.loop_closure import detect_loop
from ..graph.pose_graph import empty_edges
from ..imu.deskew import gyro_rotation_track
from ..imu.preintegration import ImuNoise, preintegrate
from ..map.hash_map import bound_map, insert_with_stats
from ..pointcloud.cloud import PointBatch, ScanGrid
from ..pointcloud.voxel import voxel_downsample
from .lio_pipeline import ImuWindow
from .pipeline import EngineState, ScanResult, init_state
from .slam_pipeline import (LoopFlag, SlamConfig, _align_step, _correct_and_rebuild,
                            _detect_step, _gps_edge, _gps_fix, _keyframe_step_body)


@dataclasses.dataclass(frozen=True)
class LioSamConfig:
    slam: SlamConfig = SlamConfig(pipeline=preset_aloam_kitti64())
    imu_noise: ImuNoise = ImuNoise()
    scan_period: float = 0.1  # sweep duration (s): scan.time in [0,1) scales by this
    # pose-measurement noise of the scan-to-map solve (imuPreintegration
    # correctionNoise / correctionNoise2 switch)
    meas_sigma_rot: float = 0.05
    meas_sigma_trans: float = 0.05
    degen_sigma_rot: float = 1.0  # inflated when GN reported degeneracy
    degen_sigma_trans: float = 1.0
    deskew: bool = True


class LioSamState(NamedTuple):
    engine: EngineState  # mapping pose + maps + previous features
    v: torch.Tensor  # (3,) world velocity
    bg: torch.Tensor
    ba: torch.Tensor
    P: torch.Tensor  # (15,15) error cov [dtheta, dv, dp, dbg, dba]
    grav: torch.Tensor


class LioSamResult(NamedTuple):
    pose: se3.Pose  # fused pose at sweep end
    stats: GnStats  # of the mapping solve
    corners: PointBatch
    surfs: PointBatch
    n_dropped: torch.Tensor
    v: torch.Tensor


def init_liosam_state(cfg: LioSamConfig, x0: se3.Pose | None = None,
                      v0: torch.Tensor | None = None, bg0: torch.Tensor | None = None,
                      ba0: torch.Tensor | None = None, grav: torch.Tensor | None = None,
                      device=None) -> LioSamState:
    """A filter at `x0` (default: at rest at the origin) with empty maps, on
    `device` (default: cuda)."""
    device = default_device(device)
    eng = init_state(cfg.slam.pipeline, device)
    if x0 is not None:
        x0 = se3.Pose(*(a.to(device) for a in x0))
        eng = eng._replace(pose=x0, prev_pose=se3.Pose(*(a.clone() for a in x0)))

    def vec(a):
        return torch.zeros((3,), device=device) if a is None else a.to(device, torch.float32)

    if grav is None:
        grav = torch.zeros((3,), device=device)
        grav[2].fill_(-9.81)  # a fill, not a host-to-device copy
    return LioSamState(engine=eng, v=vec(v0), bg=vec(bg0), ba=vec(ba0),
                       P=torch.eye(15, device=device) * 1e-2, grav=vec(grav))


def _gyro_track(imu: ImuWindow, bg: torch.Tensor):
    """Integrate bias-corrected gyro over the window, one sample at a time as
    the reference's lax.scan does. Returns (qs (M+1,4) rotations from window
    start, ts (M+1,) cumulative times)."""
    dts = torch.where(imu.mask, imu.dt, torch.zeros_like(imu.dt))
    ts = torch.cat([torch.zeros_like(dts[:1]), torch.cumsum(dts, dim=0)])
    return gyro_rotation_track(imu.gyro - bg, imu.dt, imu.mask), ts


def deskew_with_imu(scan: ScanGrid, imu: ImuWindow, bg: torch.Tensor, v_body: torch.Tensor,
                    scan_period: float) -> ScanGrid:
    """IMU deskew: gyro rotation track + constant-velocity translation (LIO-SAM
    imageProjection's imuDeskewInfo rotation + odomDeskewInfo translation).
    Points map into the sweep-END frame."""
    qs, ts = _gyro_track(imu, bg)
    tau = (scan.time * scan_period).reshape(-1)
    idx = torch.clamp(torch.searchsorted(ts, tau, right=True), 1, ts.shape[0] - 1)
    t0 = ts[idx - 1]
    t1 = ts[idx]
    s = torch.clamp((tau - t0) / torch.clamp(t1 - t0, min=1e-9), 0.0, 1.0)
    q_t = so3.slerp(qs[idx - 1], qs[idx], s)
    pts = scan.xyz.reshape(-1, 3)
    in_start = so3.quat_rotate(q_t, pts) + v_body[None, :] * tau[:, None]
    # re-express in the sweep-end frame
    t_end = v_body * ts[-1]
    out = so3.quat_rotate(so3.quat_conj(qs[-1])[None, :], in_start - t_end[None, :])
    return ScanGrid(out.reshape(scan.xyz.shape), scan.mask, scan.time)


def _fuse(state: LioSamState, pre, R_prev: torch.Tensor, pred, pose_map: se3.Pose,
          degenerate: torch.Tensor, cfg: LioSamConfig):
    """Error-state Kalman update of the preintegrated prediction `pred` =
    (q, p, v) with the mapping pose as a 6-dof measurement, then the
    divergence fallback on the device. Returns (pose, v, bg, ba, P)."""
    q_pred, p_pred, v_pred = pred
    dt = pre.dt
    J = pre.J_bias
    eye = torch.eye(15, dtype=state.P.dtype, device=state.P.device)
    I3 = eye[:3, :3]
    F = eye.clone()
    F[0:3, 0:3] = so3.quat_to_matrix(pre.dq).T
    F[0:3, 9:12] = J[0:3, 0:3]
    F[3:6, 0:3] = -R_prev @ so3.hat(pre.dv)
    F[3:6, 9:15] = R_prev @ J[3:6]
    F[6:9, 0:3] = -R_prev @ so3.hat(pre.dp)
    F[6:9, 3:6] = I3 * dt
    F[6:9, 9:15] = R_prev @ J[6:9]
    T = eye.clone()
    T[3:6, 3:6] = R_prev
    T[6:9, 6:9] = R_prev
    P_pred = F @ state.P @ F.T + T @ pre.cov @ T.T + 1e-9 * eye

    r_th = so3.quat_log(so3.quat_mul(so3.quat_conj(q_pred), pose_map.q))
    z = torch.cat([r_th, pose_map.t - p_pred])
    H = torch.zeros_like(eye[:6])  # observes dtheta and dp
    H[0:3, 0:3] = I3
    H[3:6, 6:9] = I3
    s_rot = torch.where(degenerate, cfg.degen_sigma_rot, cfg.meas_sigma_rot)
    s_tr = torch.where(degenerate, cfg.degen_sigma_trans, cfg.meas_sigma_trans)
    Rm = torch.diag(torch.cat([(s_rot**2).expand(3), (s_tr**2).expand(3)]).to(eye.dtype))
    S = H @ P_pred @ H.T + Rm
    K = P_pred @ H.T @ torch.linalg.inv_ex(S).inverse  # inv_ex: no host check
    dx = K @ z
    IKH = eye - K @ H
    P_new = IKH @ P_pred @ IKH.T + K @ Rm @ K.T

    q_new = so3.quat_normalize(so3.quat_mul(q_pred, so3.quat_exp(dx[0:3])))
    v_new = v_pred + dx[3:6]
    p_new = p_pred + dx[6:9]
    bg_new = state.bg + dx[9:12]
    ba_new = state.ba + dx[12:15]

    # failure detection (imuPreintegration failureDetection), on the device
    norm = torch.linalg.vector_norm
    diverged = ((norm(v_new) > 30.0) | (norm(bg_new) > 1.0) | (norm(ba_new) > 1.0)
                | ~torch.all(torch.isfinite(torch.cat([p_new, v_new]))))
    zero3 = torch.zeros_like(v_new)
    return (se3.Pose(q_new, p_new), torch.where(diverged, zero3, v_new),
            torch.where(diverged, zero3, bg_new), torch.where(diverged, zero3, ba_new),
            torch.where(diverged, eye * 1e-1, P_new))


def _process_liosam_body(state: LioSamState, scan: ScanGrid, imu: ImuWindow,
                         cfg: LioSamConfig, solve_fn=None) -> Tuple[LioSamState, LioSamResult]:
    """The per-scan step over its scan-to-map solve (`solve_fn`, the
    signature of solve_scan2map; the module's own where None, looked up at
    call time)."""
    solve = solve_fn or solve_scan2map
    pcfg: PipelineConfig = cfg.slam.pipeline
    eng = state.engine
    R_prev = so3.quat_to_matrix(eng.pose.q)

    # --- IMU preintegration at the current bias estimate --------------------
    pre = preintegrate(imu.gyro, imu.acc, torch.where(imu.mask, imu.dt, torch.zeros_like(imu.dt)),
                       imu.mask, state.bg, state.ba, cfg.imu_noise)
    dt = pre.dt

    # --- deskew + features ---------------------------------------------------
    if cfg.deskew:
        scan = deskew_with_imu(scan, imu, state.bg, R_prev.T @ state.v, cfg.scan_period)
    feats = extract_features(scan, pcfg.features)
    corners = voxel_downsample(feats.corners.xyz, feats.corners.mask, pcfg.corner_ds_voxel,
                               pcfg.features.max_corners)
    surfs = voxel_downsample(feats.surfs.xyz, feats.surfs.mask, pcfg.surf_ds_voxel,
                             pcfg.features.max_surfs)

    # --- initial guess from preintegration (updateInitialGuess) -------------
    q_pred = so3.quat_normalize(so3.quat_mul(eng.pose.q, pre.dq))
    p_pred = eng.pose.t + state.v * dt + 0.5 * state.grav * dt * dt + R_prev @ pre.dp
    v_pred = state.v + state.grav * dt + R_prev @ pre.dv

    # --- scan-to-map GN (scan2MapOptimization) -------------------------------
    pose_map, stats = solve(se3.Pose(q_pred, p_pred), corners, surfs, eng.corner_map,
                            eng.surf_map, pcfg.corner_map, pcfg.surf_map, pcfg.solver)

    # --- fusion: error-state KF update (the 2-node factor graph solved in
    # closed form; the degenerate flag inflates the measurement covariance) --
    pose_new, v_new, bg_new, ba_new, P_new = _fuse(state, pre, R_prev, (q_pred, p_pred, v_pred),
                                                   pose_map, stats.degenerate, cfg)
    p_new = pose_new.t

    # --- map update + bound --------------------------------------------------
    Rn = so3.quat_to_matrix(pose_new.q)
    cmap, dc = insert_with_stats(eng.corner_map, corners.xyz @ Rn.T + p_new, corners.mask,
                                 pcfg.corner_map)
    smap, ds = insert_with_stats(eng.surf_map, surfs.xyz @ Rn.T + p_new, surfs.mask,
                                 pcfg.surf_map)
    if pcfg.bound_radius > 0:
        cmap = bound_map(cmap, p_new, pcfg.bound_radius, pcfg.corner_map)
        smap = bound_map(smap, p_new, pcfg.bound_radius, pcfg.surf_map)

    eng2 = EngineState(pose_new, eng.pose, cmap, smap, eng.frame + 1, corners, surfs)
    new_state = LioSamState(eng2, v_new, bg_new, ba_new, P_new, state.grav)
    return new_state, LioSamResult(pose_new, stats, corners, surfs, dc + ds, v_new)


def process_liosam_scan(state: LioSamState, scan: ScanGrid, imu: ImuWindow,
                        cfg: LioSamConfig) -> Tuple[LioSamState, LioSamResult]:
    """The per-scan step (see _process_liosam_body)."""
    return _process_liosam_body(state, scan, imu, cfg)


def imu_rate_poses(pose: se3.Pose, v: torch.Tensor, bg: torch.Tensor, ba: torch.Tensor,
                   grav: torch.Tensor, imu: ImuWindow):
    """High-rate pose stream: integrate raw IMU from the latest fused state,
    one sample at a time as the reference's lax.scan does. Returns (qs (M,4),
    ps (M,3), valid (M,)), one pose per IMU sample."""
    dts = torch.where(imu.mask, imu.dt, torch.zeros_like(imu.dt))
    steps = so3.quat_exp((imu.gyro - bg) * dts[:, None])  # (M,4), all at once
    q, p, vel = pose.q, pose.t, v
    qs, ps = [], []
    for k in range(imu.gyro.shape[0]):
        dt = dts[k]
        acc_w = so3.quat_to_matrix(q) @ (imu.acc[k] - ba) + grav
        p = p + vel * dt + 0.5 * acc_w * dt * dt
        vel = vel + acc_w * dt
        q = so3.quat_normalize(so3.quat_mul(q, steps[k]))
        qs.append(q)
        ps.append(p)
    return torch.stack(qs), torch.stack(ps), imu.mask


def _liosam_fused_step(state: LioSamState, bank, edges, last_kf, scan: ScanGrid,
                       imu: ImuWindow, cfg: LioSamConfig):
    """One scan: the IMU-coupled step + keyframe gate/edge insert + loop
    detection."""
    new_state, res = process_liosam_scan(state, scan, imu, cfg)
    sres = ScanResult(res.pose, res.stats, res.corners, res.surfs, res.n_dropped)
    bank2, edges2, last2, added = _keyframe_step_body(
        bank, edges, last_kf, sres, new_state.engine.frame, cfg.slam)
    cand, found = detect_loop(bank2, last_index(bank2), cfg.slam.loop)
    return new_state, res, bank2, edges2, last2, added, cand, found


class LioSamDriver:
    """The LIO-SAM driver: IMU-coupled scan step + keyframe factor graph +
    loop closure + GPS, with an optional IMU-rate pose output per scan. The
    backend and the loop-detection cadence are SlamDriver's: no host read
    per scan beyond the step's own."""

    def __init__(self, cfg: LioSamConfig, x0: se3.Pose | None = None,
                 v0: torch.Tensor | None = None, grav: torch.Tensor | None = None,
                 emit_imu_rate: bool = False, device=None):
        self.cfg = cfg
        self.device = default_device(device)
        self.state = init_liosam_state(cfg, x0=x0, v0=v0, grav=grav, device=self.device)
        f = cfg.slam.pipeline.features
        self.bank = empty_bank(cfg.slam.bank_capacity, f.max_corners, f.max_surfs, self.device)
        self.edges = empty_edges(cfg.slam.edge_capacity, self.device)
        self.last_kf = torch.zeros((), dtype=torch.int32, device=self.device)
        self.n_loops_closed = 0
        self.host_frame = 0
        # opt-in, like the reference's publishers that work only for subscribers
        self.emit_imu_rate = emit_imu_rate
        self.imu_rate_out: list = []  # (qs, ps, mask) per scan, consumed by callers
        self._flag = LoopFlag(self.device)
        self._pending = False

    def process(self, scan: ScanGrid, imu: ImuWindow, gps=None) -> LioSamResult:
        cfg = self.cfg
        st = self.state
        if self.emit_imu_rate:
            # the interval about to be consumed, predicted from the latest
            # fused state (what a robot steers by between scans)
            self.imu_rate_out.append(imu_rate_poses(st.engine.pose, st.v, st.bg, st.ba,
                                                    st.grav, imu))
        (self.state, res, self.bank, self.edges, self.last_kf, added,
         cand, found) = _liosam_fused_step(st, self.bank, self.edges, self.last_kf, scan,
                                           imu, cfg)
        if gps is not None:
            pos, w = _gps_fix(gps, cfg.slam, self.device)
            self.edges = _gps_edge(self.bank, self.edges, pos, w, added, cfg.slam)
        self.host_frame += 1
        self._drain()
        if self.host_frame % cfg.slam.loop_every == 0:
            self._flag.copy(found, cand)
            self._pending = True
        return res

    def _drain(self) -> None:
        if self._pending:
            self._pending = False
            found, cand = self._flag.read()
            if found:
                self._close_loop(torch.full((), cand, dtype=torch.int32, device=self.device))

    def finalize(self) -> None:
        """Drain the in-flight loop detection (end of stream)."""
        self._drain()

    def _try_close_loop(self) -> None:
        """Synchronous detect + align."""
        cand, found = _detect_step(self.bank, self.cfg.slam)
        if bool(found):
            self._close_loop(cand)

    def _close_loop(self, cand: torch.Tensor) -> None:
        cfg = self.cfg.slam
        edges2, accept, _ = _align_step(self.bank, self.edges, cand, cfg,
                                        cur=last_index(self.bank))
        if bool(accept):
            self.bank, engine2 = _correct_and_rebuild(self.bank, edges2, self.state.engine,
                                                      cfg)
            self.state = self.state._replace(engine=engine2)
            self.n_loops_closed += 1
        self.edges = edges2

    def trajectory(self) -> np.ndarray:
        n = int(self.bank.count)
        return self.bank.t[:n].cpu().numpy()
