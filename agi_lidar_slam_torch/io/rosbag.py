"""Minimal ROS1 .bag (format 2.0) reader + message decoders — no ROS needed
(a copy of agi_lidar_slam_tpu/io/rosbag.py; numpy only).

The reference is validated by `rosbag play` into its launch files. This
module reads bag files directly so the engine can consume the very same
datasets: sensor_msgs/PointCloud2, sensor_msgs/Imu and
livox_ros_driver/CustomMsg (A-LOAM/LeGO/LIO-SAM PointCloud2+Imu;
S-FAST_LIO/LIO-Livox/livox_mapping CustomMsg, e.g. livox_repub.cpp:12-47),
plus nav_msgs/Odometry and sensor_msgs/NavSatFix for GPS.

Supports 'none', 'bz2' and 'lz4' chunk compression (lz4 via the port's
native C++ LZ4-frame decoder in io/native/lidar_io.cpp, built with g++ at
first use).
"""

from __future__ import annotations

import bz2
import ctypes
import struct
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np


def _lz4_decompress(data: bytes, uncompressed_size: int) -> bytes:
    """LZ4-frame decompression via the native library (roslz4 writes
    standard LZ4 frames)."""
    from .native_loader import _load_lib

    out = np.empty(uncompressed_size, dtype=np.uint8)
    n = _load_lib().lz4_frame_decode(
        data, len(data), out.ctypes.data_as(ctypes.c_void_p), uncompressed_size,
    )
    if n < 0:
        raise ValueError("corrupt lz4 chunk")
    return out[:n].tobytes()


_OP_MSG = 0x02
_OP_BAG_HEADER = 0x03
_OP_INDEX = 0x04
_OP_CHUNK = 0x05
_OP_CHUNK_INFO = 0x06
_OP_CONNECTION = 0x07


def _parse_header(buf: bytes) -> Dict[str, bytes]:
    fields = {}
    i = 0
    while i < len(buf):
        (flen,) = struct.unpack_from("<I", buf, i)
        i += 4
        entry = buf[i : i + flen]
        i += flen
        k, _, v = entry.partition(b"=")
        fields[k.decode()] = v
    return fields


def _iter_records(buf: bytes, offset: int = 0) -> Iterator[Tuple[Dict[str, bytes], bytes]]:
    i = offset
    n = len(buf)
    while i + 8 <= n:
        (hlen,) = struct.unpack_from("<I", buf, i)
        i += 4
        header = _parse_header(buf[i : i + hlen])
        i += hlen
        (dlen,) = struct.unpack_from("<I", buf, i)
        i += 4
        data = buf[i : i + dlen]
        i += dlen
        yield header, data


class Connection:
    def __init__(self, conn_id: int, topic: str, dtype: str):
        self.id = conn_id
        self.topic = topic
        self.dtype = dtype


def read_messages(
    path: str, topics: Optional[List[str]] = None
) -> Iterator[Tuple[str, str, float, bytes]]:
    """Yield (topic, msg_type, stamp_seconds, raw_bytes) in file order."""
    with open(path, "rb") as f:
        magic = f.readline()
        if not magic.startswith(b"#ROSBAG V2.0"):
            raise ValueError(f"not a ROS bag v2.0: {path}")
        buf = f.read()

    connections: Dict[int, Connection] = {}

    def handle_inner(inner: bytes):
        for header, data in _iter_records(inner):
            op = header.get("op", b"\x00")[0]
            if op == _OP_CONNECTION:
                conn_id = struct.unpack("<I", header["conn"])[0]
                sub = _parse_header(data)
                topic = header.get("topic", sub.get("topic", b"")).decode()
                dtype = sub.get("type", b"").decode()
                connections[conn_id] = Connection(conn_id, topic, dtype)
            elif op == _OP_MSG:
                conn_id = struct.unpack("<I", header["conn"])[0]
                t = struct.unpack("<Q", header["time"])[0]
                stamp = (t & 0xFFFFFFFF) + (t >> 32) * 1e-9  # low u32 = secs, high = nsecs
                conn = connections.get(conn_id)
                if conn is None:
                    continue
                if topics is None or conn.topic in topics:
                    yield conn.topic, conn.dtype, stamp, data

    for header, data in _iter_records(buf):
        op = header.get("op", b"\x00")[0]
        if op == _OP_CHUNK:
            comp = header.get("compression", b"none").decode()
            if comp == "none":
                inner = data
            elif comp == "bz2":
                inner = bz2.decompress(data)
            elif comp == "lz4":
                (usize,) = struct.unpack("<I", header["size"])
                inner = _lz4_decompress(data, usize)
            else:
                raise NotImplementedError(f"chunk compression {comp!r}")
            yield from handle_inner(inner)
        elif op in (_OP_CONNECTION, _OP_MSG):
            # unchunked bags (rare, but legal)
            yield from _handle_single(header, data, connections, topics)


def _handle_single(header, data, connections, topics):
    op = header.get("op", b"\x00")[0]
    if op == _OP_CONNECTION:
        conn_id = struct.unpack("<I", header["conn"])[0]
        sub = _parse_header(data)
        topic = header.get("topic", sub.get("topic", b"")).decode()
        dtype = sub.get("type", b"").decode()
        connections[conn_id] = Connection(conn_id, topic, dtype)
    elif op == _OP_MSG:
        conn_id = struct.unpack("<I", header["conn"])[0]
        t = struct.unpack("<Q", header["time"])[0]
        stamp = (t & 0xFFFFFFFF) + (t >> 32) * 1e-9  # low u32 = secs, high = nsecs
        conn = connections.get(conn_id)
        if conn is not None and (topics is None or conn.topic in topics):
            yield conn.topic, conn.dtype, stamp, data


# ---------------------------------------------------------------------------
# message decoders
# ---------------------------------------------------------------------------


def _read_string(buf: bytes, i: int) -> Tuple[str, int]:
    (n,) = struct.unpack_from("<I", buf, i)
    return buf[i + 4 : i + 4 + n].decode(errors="replace"), i + 4 + n


def _skip_header(buf: bytes, i: int) -> int:
    i += 4  # seq
    i += 8  # stamp
    _, i = _read_string(buf, i)  # frame_id
    return i


_PF_DTYPES = {1: np.int8, 2: np.uint8, 3: np.int16, 4: np.uint16,
              5: np.int32, 6: np.uint32, 7: np.float32, 8: np.float64}


def decode_pointcloud2(raw: bytes) -> Dict[str, np.ndarray]:
    """sensor_msgs/PointCloud2 -> dict of per-point field arrays (x/y/z/
    intensity/ring/time/... whatever the cloud carries)."""
    i = _skip_header(raw, 0)
    height, width = struct.unpack_from("<II", raw, i)
    i += 8
    (n_fields,) = struct.unpack_from("<I", raw, i)
    i += 4
    fields = []
    for _ in range(n_fields):
        name, i = _read_string(raw, i)
        off, dt, cnt = struct.unpack_from("<IBI", raw, i)
        i += 9
        fields.append((name, off, dt, cnt))
    is_bigendian = raw[i]
    i += 1
    point_step, row_step = struct.unpack_from("<II", raw, i)
    i += 8
    (data_len,) = struct.unpack_from("<I", raw, i)
    i += 4
    data = np.frombuffer(raw, dtype=np.uint8, count=data_len, offset=i)
    n_pts = (height * width) if point_step == 0 else data_len // point_step
    data = data[: n_pts * point_step].reshape(n_pts, point_step)
    out: Dict[str, np.ndarray] = {}
    for name, off, dt, cnt in fields:
        npdt = _PF_DTYPES[dt]
        w = np.dtype(npdt).itemsize
        col = data[:, off : off + w * cnt].copy().view(npdt)
        out[name] = col.reshape(n_pts) if cnt == 1 else col.reshape(n_pts, cnt)
    return out


def decode_imu(raw: bytes) -> Dict[str, np.ndarray]:
    """sensor_msgs/Imu -> {orientation (4: x,y,z,w), gyro (3), acc (3)}."""
    i = _skip_header(raw, 0)
    orientation = np.frombuffer(raw, np.float64, 4, i)
    i += 32 + 72  # quaternion + its covariance
    gyro = np.frombuffer(raw, np.float64, 3, i)
    i += 24 + 72
    acc = np.frombuffer(raw, np.float64, 3, i)
    return {"orientation": orientation, "gyro": gyro, "acc": acc}


def decode_livox_custom(raw: bytes) -> Dict[str, np.ndarray]:
    """livox_ros_driver/CustomMsg -> {xyz (N,3), offset_time_s (N,),
    reflectivity (N,), line (N,)} (livox_repub.cpp:12-47 consumes these)."""
    i = _skip_header(raw, 0)
    (timebase,) = struct.unpack_from("<Q", raw, i)
    i += 8
    (point_num,) = struct.unpack_from("<I", raw, i)
    i += 4
    i += 1 + 3  # lidar_id + rsvd
    (arr_len,) = struct.unpack_from("<I", raw, i)
    i += 4
    rec = np.dtype([("offset_time", "<u4"), ("x", "<f4"), ("y", "<f4"),
                    ("z", "<f4"), ("reflectivity", "u1"), ("tag", "u1"),
                    ("line", "u1")])
    pts = np.frombuffer(raw, rec, arr_len, i)
    xyz = np.stack([pts["x"], pts["y"], pts["z"]], axis=1).astype(np.float32)
    return {
        "xyz": xyz,
        "offset_time_s": pts["offset_time"].astype(np.float64) * 1e-9,
        "reflectivity": pts["reflectivity"],
        "line": pts["line"],
        "timebase": timebase,
    }


def decode_odometry(raw: bytes) -> Dict[str, np.ndarray]:
    """nav_msgs/Odometry -> {position (3,), orientation (4: x,y,z,w),
    cov (6,6)}. This is the GPS input format of LIO-SAM (its `gpsTopic`
    "odometry/gpsz" is robot_localization's navsat odometry; addGPSFactor
    reads pose.position + covariance diag, mapOptmization.cpp:1879-1957)."""
    i = _skip_header(raw, 0)
    _, i = _read_string(raw, i)  # child_frame_id
    position = np.frombuffer(raw, np.float64, 3, i)
    i += 24
    orientation = np.frombuffer(raw, np.float64, 4, i)
    i += 32
    cov = np.frombuffer(raw, np.float64, 36, i).reshape(6, 6)
    return {"position": position, "orientation": orientation, "cov": cov}


def decode_navsatfix(raw: bytes) -> Dict[str, np.ndarray]:
    """sensor_msgs/NavSatFix -> {lla (3: lat,lon,alt deg/m), cov (3,3),
    status, cov_type}. status < 0 means no fix (NavSatStatus.STATUS_NO_FIX)."""
    i = _skip_header(raw, 0)
    status = struct.unpack_from("<b", raw, i)[0]
    i += 1
    i += 2  # service (uint16)
    lla = np.frombuffer(raw, np.float64, 3, i)
    i += 24
    cov = np.frombuffer(raw, np.float64, 9, i).reshape(3, 3)
    i += 72
    cov_type = raw[i]
    return {"lla": lla, "cov": cov, "status": status, "cov_type": cov_type}


_EARTH_R = 6378137.0  # WGS84 equatorial radius (m)


def lla_to_local(lla: np.ndarray, origin: np.ndarray) -> np.ndarray:
    """Equirectangular lat/lon/alt -> local ENU meters around `origin`
    (the small-area approximation robot_localization's navsat_transform
    uses for the scales LIO-SAM operates at)."""
    lat0, lon0 = np.deg2rad(origin[0]), np.deg2rad(origin[1])
    lat, lon = np.deg2rad(lla[0]), np.deg2rad(lla[1])
    east = (lon - lon0) * np.cos(lat0) * _EARTH_R
    north = (lat - lat0) * _EARTH_R
    up = lla[2] - origin[2]
    return np.asarray([east, north, up], np.float64)
