"""Bag -> engine streaming: pair each lidar sweep with its covering IMU window
(a copy of agi_lidar_slam_tpu/io/bag_stream.py; numpy on the host, and
`bundle_to_grid` puts its grid on the requested device).

This is the engine-side replacement for `rosbag play` + the reference's
subscriber queues and `sync_packages` logic (S-FAST_LIO laserMapping.cpp:
218-275 collects the IMU deque covering each sweep; LIO-SAM imageProjection
caches IMU between cloudHandler calls). Outputs are padded fixed-shape
arrays.

Sweep payload formats:
* PointCloud2 -> flat points (`xyz`, `rel_time`, `mask`) for the direct LIO
  engine, plus a ring-grid `ScanGrid` for the feature-based engines. If the
  cloud carries a per-point relative-time field (`time`/`t`/`timestamp`/
  `time_offset`), it is used; else times spread linearly over the sweep.
* livox CustomMsg -> the same, with per-line (ring) grid assembly from the
  `line` channel (livox_repub.cpp:12-47 packs exactly these fields).

Unlike the reference, a `timestamp` field is read as absolute stamps or as
offsets by its spread, not its magnitude (see `_rel_times`).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Tuple

import numpy as np

from . import rosbag as rb

_PC2 = "sensor_msgs/PointCloud2"
_IMU = "sensor_msgs/Imu"
_LIVOX = "livox_ros_driver/CustomMsg"
_ODOM = "nav_msgs/Odometry"
_NAVSAT = "sensor_msgs/NavSatFix"
_TIME_FIELDS = ("time", "t", "timestamp", "time_offset", "offset_time")


def _rel_times(f) -> Tuple[Optional[np.ndarray], str]:
    """Per-point relative sweep times with DEDICATED per-lidar conventions —
    the re-design of S-FAST_LIO's per-type handlers (preprocess.h:47-111):

    * Ouster: `t` is uint32 NANOSECONDS from frame start (oust64 handler,
      `pl.t / 1e9` in the reference) — detected by the integer dtype;
    * RoboSense: `timestamp` is float64 ABSOLUTE epoch seconds per point
      (rs handler subtracts the frame stamp) — detected by a spread that is
      a tiny fraction of the magnitude; a `timestamp` that spreads over its
      range is an offset (seconds, or ns above 1e6);
    * Velodyne: `time` is float32 seconds relative to the frame reference
      (may be negative for end-referenced drivers; shifted to start at 0);
    * generic fallbacks for other drivers (relative seconds or ns offsets).

    Returns (rel_times (N,) f64 from sweep start, convention tag)."""
    def rebase(t):  # shift to start at 0 (no `initial=`: it would CLAMP the
        return t - (t.min() if t.size else 0.0)  # min and skip the rebase)

    if "t" in f and np.issubdtype(f["t"].dtype, np.integer):
        return rebase(f["t"].astype(np.float64) * 1e-9), "ouster_t_ns"
    if "timestamp" in f:
        raw = f["timestamp"]
        ts = raw.astype(np.float64)
        # absolute stamps (RoboSense: f64 epoch seconds, ~1.7e9) spread over
        # a sweep by a tiny fraction of their magnitude; offsets from frame
        # start spread over about their whole range, whatever their unit. A
        # magnitude cut cannot tell f64 epoch seconds from ns offsets of a
        # sweep longer than 1 s (both above 1e9); the spread can
        if ts.size:
            hi, span = ts.max(), ts.max() - ts.min()
            if hi > 0.0 and span < 1e-3 * hi:  # absolute stamps
                if hi > 1e15:  # epoch nanoseconds
                    return rebase(ts) * 1e-9, "timestamp_abs_ns"
                return rebase(ts), "rs_timestamp_abs_s"
            if hi > 1e6:  # ns-scale offsets
                return rebase(ts * 1e-9), "timestamp_ns"
        return rebase(ts), "timestamp_rel_s"
    for name in _TIME_FIELDS:
        if name in f:
            t = f[name].astype(np.float64)
            if t.size and t.max() > 1e6:  # ns-scale offsets
                t = t * 1e-9
            return rebase(t), name
    return None, "none"


@dataclasses.dataclass
class SweepBundle:
    """One lidar sweep + the IMU samples since the previous sweep."""

    stamp: float
    xyz: np.ndarray  # (P,3) f32 padded
    rel_time: np.ndarray  # (P,) f32 seconds from sweep reference
    mask: np.ndarray  # (P,) bool
    ring: Optional[np.ndarray]  # (P,) int32 or None
    imu_gyro: np.ndarray  # (M,3) f32 padded
    imu_acc: np.ndarray  # (M,3)
    imu_dt: np.ndarray  # (M,)
    imu_mask: np.ndarray  # (M,)
    # latest GPS fix at or before this sweep (None when no gps_topic or no
    # fix yet): local/odom-frame position + position covariance diagonal
    gps: Optional[np.ndarray] = None  # (3,) f64
    gps_cov: Optional[np.ndarray] = None  # (3,) f64 diag


def _pad_points(xyz, rel_t, ring, max_points):
    P = max_points
    n = min(len(xyz), P)
    out_xyz = np.zeros((P, 3), np.float32)
    out_t = np.zeros((P,), np.float32)
    out_m = np.zeros((P,), bool)
    out_xyz[:n] = xyz[:n]
    out_t[:n] = rel_t[:n]
    out_m[:n] = True
    out_r = None
    if ring is not None:
        out_r = np.zeros((P,), np.int32)
        out_r[:n] = ring[:n]
    return out_xyz, out_t, out_m, out_r


def _pad_imu(samples, imu_capacity, default_rate=200.0):
    """samples: list of (stamp, gyro(3), acc(3)) sorted by stamp."""
    M = imu_capacity
    gyro = np.zeros((M, 3), np.float32)
    acc = np.zeros((M, 3), np.float32)
    dt = np.zeros((M,), np.float32)
    mask = np.zeros((M,), bool)
    n = min(len(samples), M)
    for i in range(n):
        gyro[i] = samples[i][1]
        acc[i] = samples[i][2]
        if i + 1 < n:
            dt[i] = max(samples[i + 1][0] - samples[i][0], 0.0)
        else:
            dt[i] = 1.0 / default_rate
        mask[i] = True
    return gyro, acc, dt, mask


def stream_bag(
    path: str,
    lidar_topic: Optional[str] = None,
    imu_topic: Optional[str] = None,
    max_points: int = 131072,
    imu_capacity: int = 512,
    gps_topic: Optional[str] = None,
) -> Iterator[SweepBundle]:
    """Iterate (sweep, imu-window) bundles in bag time order. Topics default
    to the first PointCloud2/CustomMsg and first Imu connection seen.

    `gps_topic` (explicit, like LIO-SAM's gpsTopic param) may carry
    nav_msgs/Odometry (navsat odometry, already in a local frame — what
    LIO-SAM consumes) or sensor_msgs/NavSatFix (raw lat/lon/alt, converted
    to local ENU around the first fix, the navsat_transform analog). Each
    sweep carries the latest fix at or before it."""
    imu_buf: list = []
    gps_latest: Optional[tuple] = None  # (pos (3,), cov_diag (3,))
    lla_origin: Optional[np.ndarray] = None
    for topic, dtype, stamp, raw in rb.read_messages(path):
        if gps_topic is not None and topic == gps_topic:
            if dtype == _ODOM:
                m = rb.decode_odometry(raw)
                gps_latest = (m["position"].copy(),
                              np.diag(m["cov"])[:3].copy())
            elif dtype == _NAVSAT:
                m = rb.decode_navsatfix(raw)
                if m["status"] >= 0:  # skip no-fix samples
                    if lla_origin is None:
                        lla_origin = m["lla"].copy()
                    gps_latest = (rb.lla_to_local(m["lla"], lla_origin),
                                  np.diag(m["cov"]).copy())
            continue
        if dtype == _IMU and (imu_topic is None or topic == imu_topic):
            if imu_topic is None:
                imu_topic = topic
            m = rb.decode_imu(raw)
            imu_buf.append((stamp, m["gyro"], m["acc"]))
        elif dtype == _PC2 and (lidar_topic is None or topic == lidar_topic):
            if lidar_topic is None:
                lidar_topic = topic
            f = rb.decode_pointcloud2(raw)
            xyz = np.stack([f["x"], f["y"], f["z"]], axis=1).astype(np.float32)
            rel_t, _conv = _rel_times(f)
            if rel_t is None:
                rel_t = np.linspace(0.0, 0.1, len(xyz), endpoint=False)
            ring = f["ring"].astype(np.int32) if "ring" in f else None
            px, pt, pm, pr = _pad_points(xyz, rel_t, ring, max_points)
            g, a, d, mm = _pad_imu(imu_buf, imu_capacity)
            imu_buf = []
            gp, gc = gps_latest if gps_latest is not None else (None, None)
            gps_latest = None  # one factor per fix (LIO-SAM pops its gps queue)
            yield SweepBundle(stamp, px, pt, pm, pr, g, a, d, mm, gp, gc)
        elif dtype == _LIVOX and (lidar_topic is None or topic == lidar_topic):
            if lidar_topic is None:
                lidar_topic = topic
            f = rb.decode_livox_custom(raw)
            px, pt, pm, pr = _pad_points(
                f["xyz"], f["offset_time_s"].astype(np.float32),
                f["line"].astype(np.int32), max_points)
            g, a, d, mm = _pad_imu(imu_buf, imu_capacity)
            imu_buf = []
            gp, gc = gps_latest if gps_latest is not None else (None, None)
            gps_latest = None
            yield SweepBundle(stamp, px, pt, pm, pr, g, a, d, mm, gp, gc)


def bundle_to_grid(b: SweepBundle, rings: int, width: int,
                   fov_up_deg: float = 2.0, fov_down_deg: float = -24.8, device=None):
    """SweepBundle -> ScanGrid for the feature-based engines, on `device`
    (default: cuda). Uses the ring channel when present (Velodyne/Ouster/
    livox line id), else elevation binning."""
    from ..device import default_device, host_to_device
    from ..pointcloud.cloud import ScanGrid, grid_from_unorganized

    device = default_device(device)
    pts = b.xyz[b.mask]
    if b.ring is None:
        return grid_from_unorganized(pts, rings, width, fov_up_deg, fov_down_deg,
                                     device=device)
    ring = b.ring[b.mask]
    rel_t = b.rel_time[b.mask]
    azim = np.arctan2(pts[:, 1], pts[:, 0])
    col = np.round((azim + np.pi) / (2 * np.pi) * (width - 1)).astype(np.int32)
    ok = (ring >= 0) & (ring < rings)
    grid = np.zeros((rings, width, 3), np.float32)
    mask = np.zeros((rings, width), bool)
    tgrid = np.zeros((rings, width), np.float32)
    grid[ring[ok], col[ok]] = pts[ok]
    mask[ring[ok], col[ok]] = True
    span = max(rel_t.max(initial=0.0), 1e-6)
    tgrid[ring[ok], col[ok]] = rel_t[ok] / span  # normalized [0,1)
    return ScanGrid(host_to_device(grid, device), host_to_device(mask, device),
                    host_to_device(tgrid, device))
