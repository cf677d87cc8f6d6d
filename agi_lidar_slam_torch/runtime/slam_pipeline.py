"""Full SLAM engine: odometry + keyframe pose graph + loop closure + GPS
(port of agi_lidar_slam_tpu/runtime/slam_pipeline.py).

Per scan: the odometry step (runtime/pipeline.process_scan), a keyframe gate
with an odometry BetweenFactor, and the loop-detection radius search, with
no host read of its own. On a cadence the driver reads the detection flag
that was copied to the host one scan earlier; a candidate runs the
alignment, and an accepted loop edge the pose-graph solve, the correction of
every keyframe pose and the rebuild of both odometry maps from the corrected
bank (LIO-SAM's correctPoses).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..config import PipelineConfig, preset_aloam_kitti64
from ..device import default_device
from ..geometry import se3, so3
from ..graph.keyframes import (KeyframeBank, add_keyframe, empty_bank, last_index, row,
                               should_add)
from ..graph.loop_closure import LoopConfig, align_loop, detect_loop
from ..graph.pose_graph import (EdgeSet, add_edge, between_measurement, empty_edges,
                                solve_pose_graph)
from ..map.hash_map import bound_map, empty_map, insert
from ..pointcloud.cloud import ScanGrid
from .pipeline import EngineState, ScanResult, init_state, process_scan


@dataclasses.dataclass(frozen=True)
class SlamConfig:
    pipeline: PipelineConfig = preset_aloam_kitti64()
    bank_capacity: int = 1024
    edge_capacity: int = 2048
    kf_dist: float = 1.0  # surroundingkeyframeAddingDistThreshold
    kf_angle: float = 0.2  # surroundingkeyframeAddingAngleThreshold
    odom_w_rot: float = 1e4  # odometryNoise analog (1/sigma^2)
    odom_w_trans: float = 1e4
    loop_w_rot: float = 1e4
    loop_w_trans: float = 1e4
    gps_w_trans: float = 1.0
    loop: LoopConfig = LoopConfig()
    loop_every: int = 10  # host cadence of loop-closure attempts (scans)
    graph_gn_iters: int = 6


class SlamState(NamedTuple):
    engine: EngineState
    bank: KeyframeBank
    edges: EdgeSet
    last_kf_idx: torch.Tensor  # () int32 index of the previous keyframe


def init_slam(cfg: SlamConfig, device=None) -> SlamState:
    """An empty engine, bank and edge set on `device` (default: cuda)."""
    device = default_device(device)
    f = cfg.pipeline.features
    return SlamState(
        engine=init_state(cfg.pipeline, device),
        bank=empty_bank(cfg.bank_capacity, f.max_corners, f.max_surfs, device),
        edges=empty_edges(cfg.edge_capacity, device),
        last_kf_idx=torch.zeros((), dtype=torch.int32, device=device),
    )


def _keyframe_step_body(bank: KeyframeBank, edges: EdgeSet, last_kf_idx: torch.Tensor,
                        res: ScanResult, frame: torch.Tensor, cfg: SlamConfig):
    """Keyframe gate, masked append and odometry edge to the previous one."""
    do_add = should_add(bank, res.pose, cfg.kf_dist, cfg.kf_angle)
    prev_idx = last_index(bank)
    prev_pose = se3.Pose(row(bank.q, prev_idx), row(bank.t, prev_idx))
    had_prev = bank.count > 0
    bank2, idx = add_keyframe(bank, res.pose, res.corners, res.surfs, frame, do_add)
    z = between_measurement(prev_pose, res.pose)
    edges2 = add_edge(edges, prev_idx, idx, z, cfg.odom_w_rot, cfg.odom_w_trans, kind=0,
                      do_add=do_add & had_prev)
    new_last = torch.where(do_add, idx, last_kf_idx)
    return bank2, edges2, new_last, do_add


def _slam_step(st: SlamState, scan: ScanGrid, cfg: SlamConfig):
    """One scan: odometry + keyframe gate + edge insert + loop detection (the
    cheap pose-radius search; the alignment runs only when the driver sees a
    candidate)."""
    engine, res = process_scan(st.engine, scan, cfg.pipeline)
    bank, edges, last_kf, added = _keyframe_step_body(
        st.bank, st.edges, st.last_kf_idx, res, engine.frame, cfg)
    cand, found = detect_loop(bank, last_index(bank), cfg.loop)
    return SlamState(engine, bank, edges, last_kf), res, added, cand, found


def _detect_step(bank: KeyframeBank, cfg: SlamConfig):
    """Standalone loop detection (pose-radius search only)."""
    return detect_loop(bank, last_index(bank), cfg.loop)


def _align_step(bank: KeyframeBank, edges: EdgeSet, cand: torch.Tensor, cfg: SlamConfig,
                cur: torch.Tensor | None = None):
    """Align keyframe `cur` (default: the newest) against a candidate's
    submap and add the loop edge if it is accepted. Returns
    (edges, accept, fitness)."""
    if cur is None:
        cur = last_index(bank)
    z, fitness, ok = align_loop(bank, cur, cand, cfg.loop)
    edges2 = add_edge(edges, cand, cur, z, cfg.loop_w_rot, cfg.loop_w_trans, kind=0,
                      do_add=ok)
    return edges2, ok, fitness


def _loop_step(bank: KeyframeBank, edges: EdgeSet, cfg: SlamConfig):
    """Detect + align + (conditionally) add a loop edge. Returns
    (edges, found & ok, cand_idx, fitness)."""
    cur = last_index(bank)
    cand, found = detect_loop(bank, cur, cfg.loop)
    z, fitness, ok = align_loop(bank, cur, cand, cfg.loop)
    accept = found & ok
    edges2 = add_edge(edges, cand, cur, z, cfg.loop_w_rot, cfg.loop_w_trans, kind=0,
                      do_add=accept)
    return edges2, accept, cand, fitness


def _chunked_insert(xyz_k: torch.Tensor, mask_k: torch.Tensor, map_cfg, groups: int = 32):
    """A map built from (K,N,3) clouds inserted in groups of max(1, K//groups)
    keyframes, in order: the claim rounds and the first-wins sub-voxel scatter
    depend on the insertion order, so these are the reference's chunks."""
    K = xyz_k.shape[0]
    g = max(1, K // groups)
    pad = -K % g  # the last group is padded to g keyframes, as in the reference
    xyz_k = torch.cat([xyz_k, xyz_k.new_zeros((pad,) + xyz_k.shape[1:])])
    mask_k = torch.cat([mask_k, mask_k.new_zeros((pad,) + mask_k.shape[1:])])
    m = empty_map(map_cfg, xyz_k.device)
    for s in range(0, K + pad, g):
        m = insert(m, xyz_k[s:s + g].reshape(-1, 3), mask_k[s:s + g].reshape(-1), map_cfg)
    return m


def _correct_and_rebuild(bank: KeyframeBank, edges: EdgeSet, engine: EngineState,
                         cfg: SlamConfig):
    """Pose-graph solve + correctPoses + global map rebuild from the bank."""
    new_poses = solve_pose_graph(bank.poses(), bank.count, edges,
                                 n_gn_iters=cfg.graph_gn_iters)
    # the engine's pose follows the correction of the last keyframe
    last = last_index(bank)
    old_last = se3.Pose(row(bank.q, last), row(bank.t, last))
    new_last = se3.Pose(row(new_poses.q, last), row(new_poses.t, last))
    correction = se3.compose(new_last, se3.inverse(old_last))
    bank2 = bank._replace(q=new_poses.q, t=new_poses.t)

    live = (torch.arange(bank2.capacity, device=bank2.t.device) < bank2.count)[:, None]
    R = so3.quat_to_matrix(bank2.q)
    cw = torch.einsum("kij,knj->kni", R, bank2.corner_xyz) + bank2.t[:, None, :]
    sw = torch.einsum("kij,knj->kni", R, bank2.surf_xyz) + bank2.t[:, None, :]
    pcfg = cfg.pipeline
    cmap = _chunked_insert(cw, bank2.corner_mask & live, pcfg.corner_map)
    smap = _chunked_insert(sw, bank2.surf_mask & live, pcfg.surf_map)
    pose_c = se3.compose(correction, engine.pose)
    if pcfg.bound_radius > 0:
        cmap = bound_map(cmap, pose_c.t, pcfg.bound_radius, pcfg.corner_map)
        smap = bound_map(smap, pose_c.t, pcfg.bound_radius, pcfg.surf_map)
    prev_c = se3.compose(correction, engine.prev_pose)
    engine2 = engine._replace(pose=pose_c, prev_pose=prev_c, corner_map=cmap, surf_map=smap)
    return bank2, engine2


def _gps_edge(bank: KeyframeBank, edges: EdgeSet, gps: torch.Tensor, w_trans,
              added: torch.Tensor, cfg: SlamConfig) -> EdgeSet:
    """Unary GPS factor on the just-added keyframe (LIO-SAM addGPSFactor);
    a masked no-op when no keyframe was added. `w_trans` (a number or a 0-d
    tensor) is the fix's information weight: gps_w_trans / max(var, 1) for a
    fix with a variance."""
    idx = last_index(bank)
    ident = so3.quat_identity(dtype=gps.dtype, device=gps.device)
    return add_edge(edges, idx, idx, se3.Pose(ident, gps), 0.0, w_trans, kind=1, do_add=added)


def _gps_fix(gps, cfg: SlamConfig, device):
    """A GPS argument as (position (3,) on `device`, weight): a bare position
    takes cfg.gps_w_trans, a (position, weight) pair its own weight. A fix
    from the host goes to the card through a pinned copy, without waiting: a
    copy from pageable memory synchronizes."""
    pos, w = gps if isinstance(gps, tuple) else (gps, cfg.gps_w_trans)
    pos = torch.as_tensor(pos, dtype=torch.float32)
    if device.type == "cuda" and pos.device.type == "cpu":
        pos = pos.pin_memory()
    return pos.to(device, non_blocking=True), w


class LoopFlag:
    """A loop-detection result (found, candidate) copied to the host without
    waiting: on the card a non-blocking copy into pinned memory behind an
    event. `read()` waits for that event, which has long passed when it is
    read a scan later, and returns (found, candidate) as Python values."""

    def __init__(self, device: torch.device):
        cuda = device.type == "cuda"
        self.host = torch.zeros((2,), dtype=torch.int32, pin_memory=cuda)
        self.event = torch.cuda.Event() if cuda else None

    def copy(self, found: torch.Tensor, cand: torch.Tensor) -> None:
        self.host.copy_(torch.stack([found.to(torch.int32), cand.to(torch.int32)]),
                        non_blocking=True)
        if self.event is not None:
            self.event.record()

    def read(self):
        if self.event is not None:
            self.event.synchronize()
        found, cand = self.host.tolist()
        return bool(found), cand


class SlamDriver:
    """Host driver: streams scans, runs the loop-closure step on a cadence
    (the reference's 1 Hz loopClosureThread), applies corrections.

    Per scan the driver adds no host read to those of process_scan. Every
    `loop_every` scans it copies the detection flag to the host without
    waiting and reads it at the next scan; only a real candidate pays for the
    alignment."""

    def __init__(self, cfg: SlamConfig, device=None):
        self.cfg = cfg
        self.device = default_device(device)
        self.state = init_slam(cfg, self.device)
        self.n_loops_closed = 0
        self.host_frame = 0
        self._flag = LoopFlag(self.device)
        self._pending = False  # the flag holds a detection not yet read

    def process(self, scan: ScanGrid, gps=None) -> ScanResult:
        cfg = self.cfg
        self.state, res, added, cand, found = _slam_step(self.state, scan, cfg)
        if gps is not None:
            pos, w = _gps_fix(gps, cfg, self.device)
            self.state = self.state._replace(
                edges=_gps_edge(self.state.bank, self.state.edges, pos, w, added, cfg))
        self.host_frame += 1
        self._drain()
        if self.host_frame % cfg.loop_every == 0:
            self._flag.copy(found, cand)
            self._pending = True
        return res

    def _drain(self) -> None:
        """Act on the detection copied at the last cadence tick, if any."""
        if self._pending:
            self._pending = False
            found, cand = self._flag.read()
            if found:
                self._try_close_loop(cand)

    def finalize(self) -> None:
        """Drain the in-flight loop detection (end of stream); harmless when
        nothing is pending."""
        self._drain()

    def _index(self, i: int) -> torch.Tensor:
        return torch.full((), i, dtype=torch.int32, device=self.device)

    def _try_close_loop(self, cand: int, cur: int | None = None) -> bool:
        cfg, st = self.cfg, self.state
        cur_t = last_index(st.bank) if cur is None else self._index(cur)
        edges2, accept, _ = _align_step(st.bank, st.edges, self._index(cand), cfg, cur=cur_t)
        if bool(accept):
            bank2, engine2 = _correct_and_rebuild(st.bank, edges2, st.engine, cfg)
            self.state = SlamState(engine2, bank2, edges2, st.last_kf_idx)
            self.n_loops_closed += 1
            return True
        self.state = st._replace(edges=edges2)
        return False

    def close_loop_external(self, cur: int, cand: int) -> bool:
        """Externally supplied loop candidate (LIO-SAM
        detectLoopClosureExternal): a (new, old) keyframe-index pair from an
        outside detector, still verified by the same submap alignment and
        fitness gate. Returns True when the edge was accepted and poses were
        corrected."""
        n = int(self.state.bank.count)
        if not (0 <= cand < n and 0 <= cur < n) or cur == cand:
            return False
        return self._try_close_loop(cand, cur=cur)

    def trajectory(self) -> np.ndarray:
        n = int(self.state.bank.count)
        return self.state.bank.t[:n].cpu().numpy()
