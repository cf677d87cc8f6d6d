"""Minimal ROS1 bag WRITER (uncompressed, v2.0): enough to serialize
PointCloud2 + Imu (+ Odometry / NavSatFix GPS) streams that io/rosbag.py (and
real ROS tooling that tolerates index-less bags) can read back. A copy of
agi_lidar_slam_tpu/io/bag_write.py; numpy only.

The reference's kittiHelper has a `to_bag` mode that converts a KITTI
sequence into a bag (kittiHelper.cpp:40-205); the port's tests and
chip_smoke.py make their bags with this writer.
"""

from __future__ import annotations

import struct
from typing import Iterable, Optional, Tuple

import numpy as np


def _header(fields: dict) -> bytes:
    out = b""
    for k, v in fields.items():
        item = k.encode() + b"=" + v
        out += struct.pack("<I", len(item)) + item
    return out


def _record(fields: dict, data: bytes) -> bytes:
    h = _header(fields)
    return struct.pack("<I", len(h)) + h + struct.pack("<I", len(data)) + data


def _string(s: str) -> bytes:
    b = s.encode()
    return struct.pack("<I", len(b)) + b


def std_msg_header(stamp: float = 0.0, frame: str = "lidar") -> bytes:
    secs = int(stamp)
    nsecs = int(round((stamp - secs) * 1e9))
    return struct.pack("<III", 0, secs, nsecs) + _string(frame)


def encode_pointcloud2(xyz: np.ndarray, intensity: Optional[np.ndarray] = None,
                       rel_time: Optional[np.ndarray] = None,
                       ring: Optional[np.ndarray] = None,
                       stamp: float = 0.0, frame: str = "lidar") -> bytes:
    """sensor_msgs/PointCloud2 with x/y/z[/intensity][/time][/ring] fields."""
    n = xyz.shape[0]
    fields: list[Tuple[str, int, np.ndarray]] = [
        ("x", 7, xyz[:, 0].astype(np.float32)),
        ("y", 7, xyz[:, 1].astype(np.float32)),
        ("z", 7, xyz[:, 2].astype(np.float32)),
    ]
    if intensity is not None:
        fields.append(("intensity", 7, intensity.astype(np.float32)))
    if rel_time is not None:
        fields.append(("time", 7, rel_time.astype(np.float32)))
    if ring is not None:
        fields.append(("ring", 5, ring.astype(np.int32)))  # 5 = INT32

    field_bytes = b"" + struct.pack("<I", len(fields))
    off = 0
    cols = []
    for name, dtype_id, col in fields:
        field_bytes += _string(name) + struct.pack("<IBI", off, dtype_id, 1)
        off += 4
        cols.append(col.view(np.uint8).reshape(n, 4))
    point_step = off
    data = np.concatenate(cols, axis=1).tobytes()
    return (
        std_msg_header(stamp, frame)
        + struct.pack("<II", 1, n)  # height, width
        + field_bytes
        + bytes([0])  # is_bigendian
        + struct.pack("<II", point_step, point_step * n)
        + struct.pack("<I", len(data))
        + data
        + bytes([1])  # is_dense
    )


def encode_imu(gyro, acc, orientation=(0.0, 0.0, 0.0, 1.0),
               stamp: float = 0.0, frame: str = "imu") -> bytes:
    """sensor_msgs/Imu (covariances zero)."""
    out = std_msg_header(stamp, frame)
    out += struct.pack("<4d", *orientation) + b"\x00" * 72
    out += struct.pack("<3d", *gyro) + b"\x00" * 72
    out += struct.pack("<3d", *acc) + b"\x00" * 72
    return out


def write_bag(path: str,
              messages: Iterable[Tuple[int, str, str, float, bytes]]) -> None:
    """Write a v2.0 bag: messages = (conn_id, topic, msg_type, stamp, raw),
    already in time order. Uncompressed single chunk, no index records —
    io/rosbag.read_messages streams it fine (it scans records linearly)."""
    chunk = b""
    seen = set()
    for conn_id, topic, dtype, stamp, raw in messages:
        if conn_id not in seen:
            seen.add(conn_id)
            conn_data = _header({
                "topic": topic.encode(), "type": dtype.encode(),
                "md5sum": b"*", "message_definition": b"",
            })
            chunk += _record({"op": b"\x07",
                              "conn": struct.pack("<I", conn_id),
                              "topic": topic.encode()}, conn_data)
        secs = int(stamp)
        nsecs = int(round((stamp - secs) * 1e9))
        chunk += _record({"op": b"\x02",
                          "conn": struct.pack("<I", conn_id),
                          "time": struct.pack("<II", secs, nsecs)}, raw)

    with open(path, "wb") as f:
        f.write(b"#ROSBAG V2.0\n")
        f.write(_record({"op": b"\x03",
                         "index_pos": struct.pack("<Q", 0),
                         "conn_count": struct.pack("<I", len(seen)),
                         "chunk_count": struct.pack("<I", 1)}, b""))
        f.write(_record({"op": b"\x05", "compression": b"none",
                         "size": struct.pack("<I", len(chunk))}, chunk))


def encode_odometry(position, orientation=(0.0, 0.0, 0.0, 1.0),
                    cov_diag=(1.0,) * 6, stamp: float = 0.0,
                    frame: str = "odom", child_frame: str = "base_link") -> bytes:
    """nav_msgs/Odometry (twist zeroed) — the LIO-SAM GPS input format."""
    out = std_msg_header(stamp, frame)
    out += _string(child_frame)
    out += struct.pack("<3d", *position) + struct.pack("<4d", *orientation)
    cov = np.zeros((6, 6), np.float64)
    np.fill_diagonal(cov, cov_diag)
    out += cov.tobytes()
    out += struct.pack("<6d", 0, 0, 0, 0, 0, 0) + b"\x00" * 288  # twist + cov
    return out


def encode_navsatfix(lla, cov_diag=(1.0, 1.0, 4.0), stamp: float = 0.0,
                     frame: str = "gps", status: int = 0) -> bytes:
    """sensor_msgs/NavSatFix with diagonal position covariance."""
    out = std_msg_header(stamp, frame)
    out += struct.pack("<bH", status, 1)  # status, service=GPS
    out += struct.pack("<3d", *lla)
    cov = np.zeros((3, 3), np.float64)
    np.fill_diagonal(cov, cov_diag)
    out += cov.tobytes()
    out += bytes([2])  # DIAGONAL_KNOWN
    return out
