"""LIO-Livox-style engine: sliding-window MAP LIO with marginalization
(port of agi_lidar_slam_tpu/runtime/livox_pipeline.py).

Per sweep, once engaged: [mount correction] -> [dynamic-object removal] ->
3-class features (corner / surf / non-feature) -> IMU preintegration and the
predicted new frame -> window shift -> windowed MAP solve (lidar, non-feature
and IMU factors and the marginalization prior) -> marginalize the oldest
frame -> insert into the three per-class maps -> rolling map bound.

Before that, `LivoxDriver` runs LiDAR-only odometry (`_lo_step`, the
scan-to-map GN with the candidate cache) for `init_frames` sweeps, then
MAP-initializes gravity, velocities and biases from those poses and the IMU
windows between them (`imu/initialization.map_initialize`) and engages the
window LIO. IMU_Mode 0 stays LiDAR-only; IMU_Mode 1 stays LiDAR-only with
the gyro deskew (`imu/deskew.deskew_imu_rotation`).

All three maps are octant8: every association runs the octant-KNN kernel on
the card. The state lives on the device it was made on (cuda unless asked
otherwise). `_process_livox_body` takes the window solve as an argument
(`solve_fn`, the signature of solve_window): the multi-device step
(parallel/sharding.sharded_livox_step) runs the same body with the frames'
point axes sharded.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from ..config import MapConfig, SolverConfig
from ..device import default_device
from ..estimators.gn_scan2map import solve_scan2map
from ..estimators.window_map import (D_FRAME, MarginalPrior, WindowState, _boxminus_flat,
                                     empty_prior, marginalize_oldest, solve_window)
from ..features.dynamic_removal import DynamicRemovalConfig, remove_dynamic
from ..features.livox import LivoxFeatureConfig, extract_livox_features
from ..features.mount_calib import MountState, correct_points, init_mount_state, update_mount
from ..geometry import se3, so3
from ..imu.deskew import deskew_imu_rotation
from ..imu.initialization import InitResult, map_initialize
from ..imu.preintegration import ImuNoise, Preintegrated, preintegrate
from ..map.hash_map import HashVoxelMap, bound_map, empty_map, insert_with_stats
from ..pointcloud.cloud import PointBatch, ScanGrid
from ..pointcloud.voxel import voxel_downsample
from .lio_pipeline import ImuWindow


@dataclasses.dataclass(frozen=True)
class LivoxConfig:
    features: LivoxFeatureConfig = LivoxFeatureConfig()
    # 2.0 / 2.4 m octant8 blocks keep the coverage radius at the solver's
    # 1.0 m gates, and every class map on the octant-KNN kernel
    corner_map: MapConfig = MapConfig(sub_voxel=0.5, block_sub=4, log2_slots=13)
    surf_map: MapConfig = MapConfig(sub_voxel=0.6, block_sub=4, log2_slots=14)
    # non-feature class map: coarse, its constraints are weak and gated at 4 m^2
    other_map: MapConfig = MapConfig(sub_voxel=1.0, block_sub=4, log2_slots=13)
    # one relinearization per association pass; the candidate cache
    solver: SolverConfig = SolverConfig(n_outer=3, n_inner=1, degen_eig_thresh=10.0, cand_k=8)
    corner_ds_voxel: float = 0.3
    surf_ds_voxel: float = 0.4
    use_dynamic_removal: bool = True
    use_nonfeature: bool = True  # third residual class in the window solve
    use_mount_calib: bool = False  # mount-angle self-calibration (pointsCorrect.cpp)
    # decimated cell statistics, a 128-cell grid of 0.5 m cells over 64 m
    dynamic: DynamicRemovalConfig = DynamicRemovalConfig(
        stats_stride=2, cell=0.5, half_extent=32.0, fg_max_footprint=100)
    imu_noise: ImuNoise = ImuNoise()
    lidar_weight: float = 30.0
    nonfeature_weight: float = 10.0
    bound_radius: float = 150.0  # Map_Manager MapMove analog; 0 disables
    # IMU_Mode: 0 = no IMU (LiDAR-only odometry), 1 = gyro deskew with
    # LiDAR-only estimation, 2 = tightly coupled window LIO after MAP init
    imu_mode: int = 2
    # fraction of the OLD window frame's features kept in the solve (a prefix
    # of the front-packed downsample); 1.0 keeps them all
    old_frame_keep: float = 0.5


class LivoxState(NamedTuple):
    # no tensor field defaults: every constructor passes all fields
    ws: WindowState  # 2 frames: [previous, current]
    prior: MarginalPrior  # over the full window (zeros on the new frame)
    corners: PointBatch  # (2, Nc, 3) per-window-frame sensor-frame features
    surfs: PointBatch
    others: PointBatch  # (2, No, 3) non-feature class
    corner_map: HashVoxelMap
    surf_map: HashVoxelMap
    other_map: HashVoxelMap
    grav: torch.Tensor
    frame: torch.Tensor
    mount: MountState


class LivoxResult(NamedTuple):
    pose: se3.Pose
    residual: torch.Tensor
    n_dropped: torch.Tensor


def init_livox_state(cfg: LivoxConfig, x0: se3.Pose | None = None,
                     v0: torch.Tensor | None = None, grav: torch.Tensor | None = None,
                     bg0: torch.Tensor | None = None, ba0: torch.Tensor | None = None,
                     device=None) -> LivoxState:
    """An engaged window at `x0` (default: identity) with empty maps, on
    `device` (default: cuda)."""
    device = default_device(device)
    p = se3.Pose.identity(device=device) if x0 is None else se3.Pose(*(a.to(device) for a in x0))
    f = cfg.features

    def two(a):
        a = torch.zeros((3,), device=device) if a is None else a.to(device, torch.float32)
        return torch.stack([a, a])

    if grav is None:
        grav = torch.zeros((3,), device=device)
        grav[2].fill_(-9.81)  # a fill, not a host-to-device copy

    def batch(n):
        return PointBatch(torch.zeros((2, n, 3), device=device),
                          torch.zeros((2, n), dtype=torch.bool, device=device))

    return LivoxState(
        ws=WindowState(torch.stack([p.q, p.q]), torch.stack([p.t, p.t]), two(v0), two(bg0),
                       two(ba0)),
        prior=empty_prior(2, device), corners=batch(f.max_corners), surfs=batch(f.max_surfs),
        others=batch(f.max_others), corner_map=empty_map(cfg.corner_map, device),
        surf_map=empty_map(cfg.surf_map, device), other_map=empty_map(cfg.other_map, device),
        grav=grav.to(device, torch.float32),
        frame=torch.zeros((), dtype=torch.int32, device=device),
        mount=init_mount_state(device))


def _embed_prior(small: MarginalPrior, ws_new: WindowState) -> MarginalPrior:
    """Pad an (F-1)-frame prior into a full-window prior: the newly added
    frame carries no prior information."""
    n, D = small.H.shape[0], ws_new.frames * D_FRAME
    H = torch.zeros((D, D), dtype=small.H.dtype, device=small.H.device)
    H[:n, :n] = small.H
    b = torch.zeros((D,), dtype=small.b.dtype, device=small.b.device)
    b[:n] = small.b
    return MarginalPrior(H, b, *(torch.cat([a, w[1:]], dim=0) for a, w in zip(small[2:], ws_new)))


def _features(scan: ScanGrid, cfg: LivoxConfig):
    """Dynamic removal, the three feature classes, and the corner and surf
    downsamples: (corners, surfs, others) PointBatches."""
    if cfg.use_dynamic_removal:
        scan = ScanGrid(scan.xyz, scan.mask & remove_dynamic(scan, cfg.dynamic), scan.time)
    feats = extract_livox_features(scan, cfg.features)
    corners = voxel_downsample(feats.corners.xyz, feats.corners.mask, cfg.corner_ds_voxel,
                               cfg.features.max_corners)
    surfs = voxel_downsample(feats.surfs.xyz, feats.surfs.mask, cfg.surf_ds_voxel,
                             cfg.features.max_surfs)
    return corners, surfs, feats.others  # others: already downsampled by the extractor


def _insert_all(maps, pose: se3.Pose, batches, cfg: LivoxConfig):
    """Insert the three classes at `pose` and bound the maps. Returns the
    maps and the total of dropped points."""
    R = so3.quat_to_matrix(pose.q)
    out, dropped = [], 0
    for m, b, mcfg in zip(maps, batches, (cfg.corner_map, cfg.surf_map, cfg.other_map)):
        m, d = insert_with_stats(m, b.xyz @ R.T + pose.t, b.mask, mcfg)
        if cfg.bound_radius > 0:
            m = bound_map(m, pose.t, cfg.bound_radius, mcfg)
        out.append(m)
        dropped = dropped + d
    return out, dropped


def _process_livox_body(state: LivoxState, scan: ScanGrid, imu: ImuWindow, cfg: LivoxConfig,
                        solve_fn=None) -> Tuple[LivoxState, LivoxResult]:
    """The engaged window-LIO step over its window solve (`solve_fn`; the
    module's solve_window where None, looked up at call time)."""
    solve = solve_fn or solve_window
    mount = state.mount
    if cfg.use_mount_calib:
        flat_xyz = scan.xyz.reshape(-1, 3)
        mount, _ = update_mount(mount, flat_xyz, scan.mask.reshape(-1))
        scan = ScanGrid(correct_points(flat_xyz, mount).reshape(scan.xyz.shape), scan.mask,
                        scan.time)
    corners_new, surfs_new, others_new = _features(scan, cfg)

    # IMU preintegration over the sweep and the predicted new frame
    ws0 = state.ws
    pre = preintegrate(imu.gyro, imu.acc, torch.where(imu.mask, imu.dt, torch.zeros_like(imu.dt)),
                       imu.mask, ws0.bg[1], ws0.ba[1], cfg.imu_noise)
    q_pred = so3.quat_normalize(so3.quat_mul(ws0.q[1], pre.dq))
    Ri = so3.quat_to_matrix(ws0.q[1])
    t_pred = ws0.t[1] + ws0.v[1] * pre.dt + 0.5 * state.grav * pre.dt ** 2 + Ri @ pre.dp
    v_pred = ws0.v[1] + state.grav * pre.dt + Ri @ pre.dv

    # shift the window: [current, predicted new]
    ws = WindowState(torch.stack([ws0.q[1], q_pred]), torch.stack([ws0.t[1], t_pred]),
                     torch.stack([ws0.v[1], v_pred]), torch.stack([ws0.bg[1], ws0.bg[1]]),
                     torch.stack([ws0.ba[1], ws0.ba[1]]))

    def shift(old: PointBatch, new: PointBatch) -> PointBatch:
        m_old = old.mask[1]
        if cfg.old_frame_keep < 1.0:  # see LivoxConfig.old_frame_keep
            n = m_old.shape[0]
            m_old = m_old & (torch.arange(n, device=m_old.device) < int(n * cfg.old_frame_keep))
        return PointBatch(torch.stack([old.xyz[1], new.xyz]), torch.stack([m_old, new.mask]))

    corners = shift(state.corners, corners_new)
    surfs = shift(state.surfs, surfs_new)
    others = shift(state.others, others_new)
    preints = Preintegrated(*(x[None] for x in pre))
    okw = dict(others=others, other_map=state.other_map, omap_cfg=cfg.other_map,
               nonfeature_weight=cfg.nonfeature_weight) if cfg.use_nonfeature else {}

    # windowed MAP solve, then marginalization: the old prior is folded in
    # at the solution (its information vector shifts by -H_prior dx)
    ws_opt, resid, H, b = solve(
        ws, corners, surfs, state.corner_map, state.surf_map, preints, state.prior,
        state.grav, cfg.corner_map, cfg.surf_map, cfg.solver, cfg.lidar_weight, **okw)
    dx_lin = _boxminus_flat(ws_opt, state.prior)
    small = marginalize_oldest(ws_opt, H + state.prior.H,
                               b + state.prior.b - state.prior.H @ dx_lin)
    prior = _embed_prior(small, ws_opt)

    # map update at the optimized new pose
    pose_new = se3.Pose(ws_opt.q[1], ws_opt.t[1])
    (cmap, smap, omap), dropped = _insert_all(
        (state.corner_map, state.surf_map, state.other_map), pose_new,
        (corners_new, surfs_new, others_new), cfg)
    new_state = LivoxState(ws_opt, prior, corners, surfs, others, cmap, smap, omap,
                           state.grav, state.frame + 1, mount)
    return new_state, LivoxResult(pose_new, resid, dropped)


def process_livox_scan(state: LivoxState, scan: ScanGrid, imu: ImuWindow,
                       cfg: LivoxConfig) -> Tuple[LivoxState, LivoxResult]:
    """One engaged window-LIO step; `state` is not modified."""
    return _process_livox_body(state, scan, imu, cfg)


class _LoState(NamedTuple):
    """LiDAR-only odometry state of the initialization window."""

    pose: se3.Pose
    prev_pose: se3.Pose
    corner_map: HashVoxelMap
    surf_map: HashVoxelMap
    other_map: HashVoxelMap


def _lo_step(st: _LoState, scan: ScanGrid, cfg: LivoxConfig):
    """One LiDAR-only odometry step (the reference's LO mode before MAP
    initialization): constant-velocity prediction and scan-to-map GN on the
    livox feature classes. Returns (state, pose, corners, surfs, others)."""
    corners, surfs, others = _features(scan, cfg)
    pred = se3.compose(st.pose, se3.compose(se3.inverse(st.prev_pose), st.pose))
    pose_opt, _ = solve_scan2map(pred, corners, surfs, st.corner_map, st.surf_map,
                                 cfg.corner_map, cfg.surf_map, cfg.solver)
    # bounded too: LO runs indefinitely under IMU_Mode 0 and 1
    maps, _ = _insert_all((st.corner_map, st.surf_map, st.other_map), pose_opt,
                          (corners, surfs, others), cfg)
    return _LoState(pose_opt, st.pose, *maps), pose_opt, corners, surfs, others


class LivoxDriver:
    """Host driver of the reference's LO -> LIO mode switch: LiDAR-only
    odometry for `init_frames` sweeps while buffering IMU, then the MAP
    initialization of gravity, velocities and biases from that window, then
    the tightly coupled window LIO. `x0` only anchors the LO map: the init
    window holds LO poses. On `device` (default: cuda).

    Host reads per sweep: those of the GN solve and the window solve (the
    candidate refresh tests, the eigh of the LO solve) and of the map
    inserts' claim rounds; engagement adds those of `map_initialize`."""

    def __init__(self, cfg: LivoxConfig, init_frames: int = 10, x0: se3.Pose | None = None,
                 device=None):
        self.cfg = cfg
        self.device = default_device(device)
        self.init_frames = init_frames
        self.engaged = False
        self.init_result: InitResult | None = None
        p0 = (se3.Pose.identity(device=self.device) if x0 is None
              else se3.Pose(*(a.to(self.device) for a in x0)))
        self._lo = _LoState(p0, p0, empty_map(cfg.corner_map, self.device),
                            empty_map(cfg.surf_map, self.device),
                            empty_map(cfg.other_map, self.device))
        self._poses: list = []
        self._imu_windows: list = []
        self._feat_tail: list = []  # the last two frames' (corners, surfs, others)
        self.state: LivoxState | None = None

    def _zero(self, dtype):
        return torch.zeros((), dtype=dtype, device=self.device)

    def _engage(self) -> None:
        cfg = self.cfg
        qs = torch.stack([p.q for p in self._poses])
        ts = torch.stack([p.t for p in self._poses])
        z3 = torch.zeros((3,), device=self.device)
        pres = [preintegrate(w.gyro, w.acc, torch.where(w.mask, w.dt, torch.zeros_like(w.dt)),
                             w.mask, z3, z3, cfg.imu_noise) for w in self._imu_windows]
        init = map_initialize(qs, ts, Preintegrated(*(torch.stack(x) for x in zip(*pres))))
        self.init_result = init
        (c0, s0, o0), (c1, s1, o1) = self._feat_tail

        def pair(a, b):
            return PointBatch(torch.stack([a.xyz, b.xyz]), torch.stack([a.mask, b.mask]))

        ws = WindowState(qs[-2:], ts[-2:], init.v[-2:], torch.stack([init.bg, init.bg]),
                         torch.stack([init.ba, init.ba]))
        self.state = LivoxState(
            ws, empty_prior(2, self.device), pair(c0, c1), pair(s0, s1), pair(o0, o1),
            self._lo.corner_map, self._lo.surf_map, self._lo.other_map, init.grav,
            torch.full((), len(self._poses), dtype=torch.int32, device=self.device),
            init_mount_state(self.device))
        self.engaged = True
        self._lo = None

    def process(self, scan: ScanGrid, imu: ImuWindow | None = None) -> LivoxResult:
        """Feed one (sweep, covering IMU window) pair. IMU_Mode 0 ignores
        `imu`; IMU_Mode 1 uses its gyro only, to deskew the rotation before
        the LiDAR-only solve."""
        if self.engaged:
            self.state, res = process_livox_scan(self.state, scan, imu, self.cfg)
            return res
        if self.cfg.imu_mode == 1 and imu is not None:
            # constant-velocity translation prior in the sweep-start frame
            lo = self._lo
            rel_t = so3.quat_rotate(so3.quat_conj(lo.pose.q), lo.pose.t - lo.prev_pose.t)
            scan = deskew_imu_rotation(scan, imu.gyro, imu.dt, imu.mask, rel_t)
        self._lo, pose, corners, surfs, others = _lo_step(self._lo, scan, self.cfg)
        res = LivoxResult(pose, self._zero(torch.float32), self._zero(torch.int32))
        if self.cfg.imu_mode < 2:
            return res
        if self._poses:  # this IMU window links the previous LO frame to this one
            self._imu_windows.append(imu)
        self._poses.append(pose)
        self._feat_tail = (self._feat_tail + [(corners, surfs, others)])[-2:]
        if len(self._poses) >= self.init_frames:
            self._engage()
        return res
