"""Simulated recordings on disk: a KITTI odometry sequence and a ROS1 bag
made from simulator sweeps, in the layouts the runner reads
(`tools/run_slam.py --kitti` / `--bag`). Real sequences and bags are not in
the repository; these exercise the same file paths end to end.

* `write_kitti_sequence`: `<root>/sequences/<seq>/velodyne/NNNNNN.bin`
  (float32 x, y, z, intensity of the valid returns), `times.txt`,
  `calib.txt` (identity Tr, so the ground truth is already in the velodyne
  frame) and `<root>/poses/<seq>.txt` (one 3x4 pose per sweep start);
* `write_sweep_bag`: each sweep as a PointCloud2 on /points with `ring`
  (grid row) and `time` (seconds from sweep start) fields, stamped at its
  end, the IMU samples of its interval as sensor_msgs/Imu on /imu before
  it, and GPS fixes as sensor_msgs/NavSatFix on /gps/fix (local ENU
  positions around LLA_ORIGIN).
"""

from __future__ import annotations

import os
from typing import Iterable, Sequence, Tuple

import numpy as np

from ..io import bag_write
from ..io.rosbag import _EARTH_R

# NavSatFix origin of the simulated recordings (lat deg, lon deg, alt m);
# sweep period (s)
LLA_ORIGIN = (48.137, 11.575, 520.0)
SCAN_PERIOD = 0.1


def local_to_lla(p) -> Tuple[float, float, float]:
    """The inverse of io/rosbag.lla_to_local's equirectangular map around
    LLA_ORIGIN."""
    origin = LLA_ORIGIN
    lat0, lon0 = np.deg2rad(origin[0]), np.deg2rad(origin[1])
    lat = lat0 + p[1] / _EARTH_R
    lon = lon0 + p[0] / (_EARTH_R * np.cos(lat0))
    return float(np.rad2deg(lat)), float(np.rad2deg(lon)), float(origin[2] + p[2])


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)


def write_kitti_sequence(root: str, scans: Sequence, poses: Sequence) -> str:
    """Lay `scans` (ScanGrids) and their sweep-start ground truth `poses`
    (se3.Pose) out as KITTI sequence 07 under `root`; returns the sequence
    directory (the runner's --kitti argument)."""
    from ..geometry import so3

    seq = "07"
    seq_dir = os.path.join(root, "sequences", seq)
    vdir = os.path.join(seq_dir, "velodyne")
    os.makedirs(vdir, exist_ok=True)
    os.makedirs(os.path.join(root, "poses"), exist_ok=True)
    for i, s in enumerate(scans):
        xyz = _host(s.xyz).reshape(-1, 3)
        m = _host(s.mask).reshape(-1)
        pts = np.concatenate([xyz[m], np.full((int(m.sum()), 1), 0.5, np.float32)], axis=1)
        pts.astype(np.float32).tofile(os.path.join(vdir, f"{i:06d}.bin"))
    with open(os.path.join(seq_dir, "times.txt"), "w") as f:
        f.writelines(f"{SCAN_PERIOD * i:.6f}\n" for i in range(len(scans)))
    with open(os.path.join(seq_dir, "calib.txt"), "w") as f:
        f.write("Tr: 1 0 0 0  0 1 0 0  0 0 1 0\n")
    with open(os.path.join(root, "poses", f"{seq}.txt"), "w") as f:
        for p in poses:
            R = _host(so3.quat_to_matrix(p.q))
            T = np.concatenate([R, _host(p.t)[:, None]], axis=1)
            f.write(" ".join(f"{v:.9f}" for v in T.ravel()) + "\n")
    return seq_dir


def write_sweep_bag(path: str, scans: Sequence, imu: Iterable, fixes: Iterable) -> None:
    """A bag of `scans` (ScanGrids, sweep k over [k, k+1) * SCAN_PERIOD
    after a start stamp of 100 s) with `imu`, one (gyro (M,3), acc (M,3))
    window a sweep sampled at the centres of M equal steps, and `fixes`,
    (time from the start, local ENU position (3,)) pairs."""
    t_start = 100.0
    msgs = []
    for k, (s, (gy, ac)) in enumerate(zip(scans, imu)):
        gy, ac = _host(gy), _host(ac)
        m = gy.shape[0]
        for j in range(m):
            stamp = t_start + (k + (j + 0.5) / m) * SCAN_PERIOD
            msgs.append((0, "/imu", "sensor_msgs/Imu", stamp,
                         bag_write.encode_imu(gy[j].tolist(), ac[j].tolist(), stamp=stamp)))
        mask = _host(s.mask)
        rows = np.broadcast_to(np.arange(mask.shape[0])[:, None], mask.shape)
        stamp = t_start + (k + 1) * SCAN_PERIOD
        msgs.append((1, "/points", "sensor_msgs/PointCloud2", stamp,
                     bag_write.encode_pointcloud2(
                         _host(s.xyz)[mask], rel_time=_host(s.time)[mask] * SCAN_PERIOD,
                         ring=rows[mask], stamp=stamp)))
    for t, p in fixes:
        stamp = t_start + t
        msgs.append((2, "/gps/fix", "sensor_msgs/NavSatFix", stamp,
                     bag_write.encode_navsatfix(local_to_lla(_host(p)), stamp=stamp)))
    msgs.sort(key=lambda x: x[3])  # stable: a fix at a sweep's stamp stays after it
    bag_write.write_bag(path, msgs)
