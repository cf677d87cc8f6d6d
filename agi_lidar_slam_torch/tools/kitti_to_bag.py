"""Convert a KITTI odometry sequence to a ROS1 bag (kittiHelper `to_bag`
mode, kittiHelper.cpp:40-205 and kitti_helper.launch; port of
tools/kitti_to_bag.py).

Each .bin scan becomes one PointCloud2 on /velodyne_points at 10 Hz (or the
cadence of times.txt where the sequence has one), with per-point intensity
and the azimuth-derived relative sweep time in a `time` field: what
`python -m agi_lidar_slam_torch.tools.run_slam --bag` needs to replay the
sequence through any engine.

Usage:
  python -m agi_lidar_slam_torch.tools.kitti_to_bag --kitti /data/kitti/sequences/00 \\
      --out /tmp/kitti00.bag [--max-scans 500]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from ..io.bag_write import encode_pointcloud2, write_bag
from ..io.kitti import read_velodyne_bin, scan_paths


def main(argv: list | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kitti", required=True, help="sequence dir (velodyne/)")
    ap.add_argument("--out", required=True, help="output .bag path")
    ap.add_argument("--max-scans", type=int, default=None)
    ap.add_argument("--topic", default="/velodyne_points")
    ap.add_argument("--hz", type=float, default=10.0)
    args = ap.parse_args(argv)

    paths = scan_paths(args.kitti)
    if args.max_scans:
        paths = paths[: args.max_scans]
    times_file = os.path.join(args.kitti, "times.txt")
    stamps = (np.loadtxt(times_file, ndmin=1)[: len(paths)] if os.path.exists(times_file)
              else np.arange(len(paths)) / args.hz)

    def messages():
        for i, p in enumerate(paths):
            pts = read_velodyne_bin(p)
            xyz, intensity = pts[:, :3], pts[:, 3]
            # relative sweep time from the azimuth (the KITTI scanner spins at
            # 10 Hz; kittiHelper encodes the same fraction into intensity)
            az = np.arctan2(xyz[:, 1], xyz[:, 0])
            rel = ((az + np.pi) / (2 * np.pi) / args.hz).astype(np.float32)
            raw = encode_pointcloud2(xyz, intensity=intensity, rel_time=rel,
                                     stamp=float(stamps[i]))
            yield 0, args.topic, "sensor_msgs/PointCloud2", float(stamps[i]), raw
            if (i + 1) % 100 == 0:
                print(f"  {i + 1}/{len(paths)} scans", file=sys.stderr)

    write_bag(args.out, messages())
    print(f"wrote {args.out}: {len(paths)} scans on {args.topic}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
