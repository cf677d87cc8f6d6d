"""Parity of the port's host I/O copies (agi_lidar_slam_torch.io) with
agi_lidar_slam_tpu.io, and the port's two fixes of the reference.

Bags, their messages and their decoded fields are bytes and copied data, so
every comparison of the bag stack is exact. The KITTI loader bins in C++
(float32 asin/atan2, lround) where the reference bins in numpy (float64,
round-half-even), so a point on a cell boundary may land one cell over: the
occupancy masks agree in more than 99.9% of the cells and, where both
occupy a cell, the coordinates agree to 1e-5 m (the bound of the reference's
own tests/test_native_loader.py). The sweep times are equal.

Port-only: float ns offsets above 1e9 (a sweep longer than 1 s) are read as
offsets, and the live viewer binds to 127.0.0.1 by default."""

import os
import struct
import urllib.request

import numpy as np
import pytest

from agi_lidar_slam_torch.io import bag_stream as tbs
from agi_lidar_slam_torch.io import bag_write as tbw
from agi_lidar_slam_torch.io import kitti as tkitti
from agi_lidar_slam_torch.io import rosbag as trb
from agi_lidar_slam_torch.io.live_viz import VizServer
from agi_lidar_slam_torch.io.native_loader import NativeKittiLoader
from agi_lidar_slam_tpu.io import bag_stream as jbs
from agi_lidar_slam_tpu.io import bag_write as jbw
from agi_lidar_slam_tpu.io import kitti as jkitti
from agi_lidar_slam_tpu.io import rosbag as jrb
from tests._torch_threads import torch_one_thread  # noqa: F401 (autouse)


def _sweep(rng, n=400, rings=16):
    az = rng.uniform(-np.pi, np.pi, n)
    el = np.deg2rad(rng.uniform(-14.0, 14.0, n))
    r = rng.uniform(2.0, 30.0, n)
    xyz = np.stack([r * np.cos(el) * np.cos(az), r * np.cos(el) * np.sin(az),
                    r * np.sin(el)], 1).astype(np.float32)
    return (xyz, rng.uniform(0, 1, n).astype(np.float32),
            np.sort(rng.uniform(0, 0.1, n)).astype(np.float32),
            rng.integers(0, rings, n).astype(np.int32))


def _messages(bw, rng):
    """A LiDAR + IMU + GPS stream encoded with the writer module `bw`:
    3 sweeps, 20 IMU samples between sweeps, a NavSatFix and an Odometry."""
    msgs, t = [], 100.0
    for k in range(3):
        for i in range(20):
            msgs.append((0, "/imu", "sensor_msgs/Imu", t,
                         bw.encode_imu(rng.normal(0, 0.1, 3), rng.normal(0, 1, 3) + [0, 0, 9.8],
                                       stamp=t)))
            t += 0.005
        if k == 1:
            msgs.append((2, "/fix", "sensor_msgs/NavSatFix", t,
                         bw.encode_navsatfix((48.1 + 1e-5 * k, 11.5, 520.0), stamp=t)))
            msgs.append((3, "/odom", "nav_msgs/Odometry", t,
                         bw.encode_odometry((1.0, 2.0, 0.5), cov_diag=(0.5,) * 6, stamp=t)))
        xyz, inten, rel, ring = _sweep(rng)
        msgs.append((1, "/points", "sensor_msgs/PointCloud2", t,
                     bw.encode_pointcloud2(xyz, inten, rel, ring, stamp=t)))
    return msgs


def _bag(tmp_path, name, bw, seed=0):
    path = str(tmp_path / name)
    bw.write_bag(path, _messages(bw, np.random.default_rng(seed)))
    return path


def test_bag_write_bytes_equal_reference(tmp_path):
    """The port's writer makes the reference's bag byte for byte."""
    tp, jp = _bag(tmp_path, "t.bag", tbw), _bag(tmp_path, "j.bag", jbw)
    assert open(tp, "rb").read() == open(jp, "rb").read()


def test_rosbag_decode_matches_reference(tmp_path):
    """Every message of a written bag, read and decoded by both readers:
    topics, types, stamps and raw bytes equal, every decoded field equal."""
    path = _bag(tmp_path, "a.bag", tbw, seed=1)
    tm, jm = list(trb.read_messages(path)), list(jrb.read_messages(path))
    assert len(tm) == len(jm) == 65  # 60 IMU, 3 sweeps, 2 GPS
    decoders = {"sensor_msgs/PointCloud2": "decode_pointcloud2", "sensor_msgs/Imu": "decode_imu",
                "sensor_msgs/NavSatFix": "decode_navsatfix", "nav_msgs/Odometry": "decode_odometry"}
    for (tt, tty, ts, traw), (jt, jty, js, jraw) in zip(tm, jm):
        assert (tt, tty, ts, traw) == (jt, jty, js, jraw)
        a, b = getattr(trb, decoders[tty])(traw), getattr(jrb, decoders[tty])(jraw)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
    lla = np.asarray([48.1, 11.5, 520.0])
    np.testing.assert_array_equal(trb.lla_to_local(lla + [1e-5, 2e-5, 1.0], lla),
                                  jrb.lla_to_local(lla + [1e-5, 2e-5, 1.0], lla))


def test_rosbag_lz4_chunk(tmp_path):
    """An lz4-compressed chunk (stored LZ4 frame blocks) decodes through the
    port's g++-built native library as through the reference's."""
    from test_rosbag import lz4_frame_stored, make_imu, write_bag

    path = str(tmp_path / "lz4.bag")
    write_bag(path, [(0, "/imu", "sensor_msgs/Imu", make_imu([0.1, 0.2, 0.3], [0, 0, 9.8]))],
              compression="lz4")
    assert list(trb.read_messages(path)) == list(jrb.read_messages(path))
    payload = os.urandom(1000)
    frame = lz4_frame_stored(payload)
    assert trb._lz4_decompress(frame, len(payload)) == payload


def _bundles_equal(a, b):
    for f in ("stamp", "xyz", "rel_time", "mask", "ring", "imu_gyro", "imu_acc", "imu_dt",
              "imu_mask", "gps", "gps_cov"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=f)


@pytest.mark.parametrize("gps_topic", [None, "/fix", "/odom"])
def test_stream_bag_bundles_match_reference(tmp_path, gps_topic):
    path = _bag(tmp_path, "s.bag", tbw, seed=2)
    tb = list(tbs.stream_bag(path, max_points=512, imu_capacity=32, gps_topic=gps_topic))
    jb = list(jbs.stream_bag(path, max_points=512, imu_capacity=32, gps_topic=gps_topic))
    assert len(tb) == len(jb) == 3
    for a, b in zip(tb, jb):
        _bundles_equal(a, b)
    assert (tb[1].gps is not None) == (gps_topic is not None)


def _pc2_fields(cols: dict) -> bytes:
    """A PointCloud2 of the named columns (numpy arrays of one dtype each)."""
    ids = {np.dtype(np.float32): 7, np.dtype(np.float64): 8, np.dtype(np.uint32): 6}
    n = len(next(iter(cols.values())))
    fields, off, parts = b"", 0, []
    for name, col in cols.items():
        fields += tbw._string(name) + struct.pack("<IBI", off, ids[col.dtype], 1)
        off += col.dtype.itemsize
        parts.append(col.view(np.uint8).reshape(n, -1))
    data = np.concatenate(parts, axis=1).tobytes()
    return (tbw.std_msg_header(0.0) + struct.pack("<II", 1, n) + struct.pack("<I", len(cols))
            + fields + b"\x00" + struct.pack("<II", off, off * n) + struct.pack("<I", len(data))
            + data + b"\x01")


def _timestamp_cloud(ts: np.ndarray) -> dict:
    xyz = np.random.default_rng(3).normal(0, 5, (len(ts), 3)).astype(np.float32)
    return trb.decode_pointcloud2(_pc2_fields({"x": xyz[:, 0].copy(), "y": xyz[:, 1].copy(),
                                               "z": xyz[:, 2].copy(), "timestamp": ts}))


@pytest.mark.parametrize("case", ["epoch_s_f64", "ns_offsets_f64", "rel_s_f32", "ouster_t"])
def test_rel_times_unambiguous_cases_match_reference(case):
    """The timestamp conventions both packages read the same way: f64 epoch
    seconds (RoboSense), ns offsets of a 0.1 s sweep, relative seconds, and
    Ouster's uint32 `t` in ns."""
    n = 300
    span = np.linspace(0.0, 0.1, n)
    if case == "ouster_t":
        f = {"t": (span * 1e9).astype(np.uint32)}
    else:
        ts = {"epoch_s_f64": 1.7e9 + span, "ns_offsets_f64": span * 1e9,
              "rel_s_f32": span.astype(np.float32)}[case]
        f = _timestamp_cloud(ts)
    (a, ta), (b, tb_) = tbs._rel_times(f), jbs._rel_times(f)
    assert ta == tb_
    np.testing.assert_array_equal(a, b)
    assert a.max() == pytest.approx(0.1, rel=1e-3)


def test_rel_times_long_sweep_ns_offsets():
    """Port only: float ns offsets of a 2.5 s sweep exceed 1e9 and spread
    over their whole range, so they are offsets, read in seconds; f64 epoch
    seconds of such a sweep stay absolute stamps."""
    span = np.linspace(0.0, 2.5, 500)
    a, tag = tbs._rel_times(_timestamp_cloud(span * 1e9))
    assert tag == "timestamp_ns"
    np.testing.assert_allclose(a, span, rtol=0, atol=1e-9)
    b, tag = tbs._rel_times(_timestamp_cloud(1.7e9 + span))
    assert tag == "rs_timestamp_abs_s"
    np.testing.assert_allclose(b, span, rtol=0, atol=1e-6)


@pytest.mark.parametrize("with_ring", [True, False])
def test_bundle_to_grid_matches_reference(tmp_path, with_ring):
    path = _bag(tmp_path, "g.bag", tbw, seed=4)
    b = next(iter(tbs.stream_bag(path, max_points=512)))
    if not with_ring:
        b.ring = None
    tg = tbs.bundle_to_grid(b, 16, 360, 15.0, -15.0, device="cpu")
    jg = jbs.bundle_to_grid(b, 16, 360, 15.0, -15.0)
    for f in ("xyz", "mask", "time"):
        np.testing.assert_array_equal(getattr(tg, f).numpy(), np.asarray(getattr(jg, f)))
    assert tg.mask.sum() > 200


def _write_bins(root, n_scans=3, n_pts=5000, seed=0):
    rng = np.random.RandomState(seed)
    vdir = os.path.join(root, "velodyne")
    os.makedirs(vdir)
    for i in range(n_scans):
        r = rng.uniform(2.0, 60.0, n_pts)
        az = rng.uniform(-np.pi, np.pi, n_pts)
        el = np.deg2rad(rng.uniform(-24.0, 1.5, n_pts))
        pts = np.stack([r * np.cos(el) * np.cos(az), r * np.cos(el) * np.sin(az),
                        r * np.sin(el), rng.uniform(0, 1, n_pts)], axis=1).astype(np.float32)
        pts.tofile(os.path.join(vdir, f"{i:06d}.bin"))
    return root


def test_native_loader_matches_reference_kitti(tmp_path):
    """KITTI .bin sweeps through the port's C++ loader (built with g++ into
    agi_lidar_slam_torch/_build/) against the reference's io/kitti.py
    binning, every scan kept (the loader's host buffers are reused)."""
    seq = _write_bins(str(tmp_path))
    paths = tkitti.scan_paths(seq)
    assert paths == jkitti.scan_paths(seq)
    with NativeKittiLoader(paths, rings=64, width=900, device="cpu") as loader:
        got = list(loader)
    ref = list(jkitti.iter_scans(seq, width=900, rings=64))
    assert len(got) == len(ref) == 3 and loader.n_scans == 3
    for g, r in zip(got, ref):
        gm, rm = g.mask.numpy(), np.asarray(r.mask)
        assert (gm == rm).mean() > 0.999
        both = gm & rm
        np.testing.assert_allclose(g.xyz.numpy()[both], np.asarray(r.xyz)[both], rtol=0,
                                   atol=1e-5)
        np.testing.assert_array_equal(g.time.numpy(), np.asarray(r.time))
    # the pure-numpy copy of io/kitti.py bins as the reference does
    t0 = next(tkitti.iter_scans(seq, width=900, rings=64, device="cpu"))
    np.testing.assert_array_equal(t0.mask.numpy(), np.asarray(ref[0].mask))


def test_kitti_poses_and_calib_match_reference(tmp_path):
    calib = tmp_path / "calib.txt"
    calib.write_text("P0: 1 0 0 0 0 1 0 0 0 0 1 0\nTr: 0 -1 0 0.1  0 0 -1 0.2  1 0 0 0.3\n")
    rng = np.random.default_rng(5)
    rows = np.concatenate([np.tile(np.eye(3).reshape(1, 9), (4, 1)),
                           rng.normal(0, 3, (4, 3))], axis=1)[:, [0, 1, 2, 9, 3, 4, 5, 10, 6, 7,
                                                                   8, 11]]
    np.savetxt(tmp_path / "00.txt", rows)
    np.testing.assert_array_equal(tkitti.load_poses(str(tmp_path / "00.txt"), str(calib)),
                                  jkitti.load_poses(str(tmp_path / "00.txt"), str(calib)))


def test_viz_server_binds_localhost():
    """Port only: the viewer binds to 127.0.0.1 unless told otherwise, and
    still serves its page and stream there."""
    viz = VizServer(port=0).start()
    try:
        assert viz._httpd.server_address[0] == "127.0.0.1"
        viz.publish([1.0, 2.0, 3.0], points=np.zeros((4, 3)))
        page = urllib.request.urlopen(f"http://127.0.0.1:{viz.port}/", timeout=5).read()
        assert b"EventSource" in page
    finally:
        viz.stop()
    assert VizServer().host == "127.0.0.1"
    assert VizServer(host="0.0.0.0").host == "0.0.0.0"


@pytest.mark.parametrize("times", [True, False])
def test_kitti_to_bag_bytes_equal_reference(tmp_path, monkeypatch, times):
    """agi_lidar_slam_torch.tools.kitti_to_bag on a 3-scan KITTI sequence
    (with and without times.txt) writes the bag the reference's
    tools/kitti_to_bag.py writes, byte for byte, and the port's reader
    decodes every scan of it."""
    import runpy

    from agi_lidar_slam_torch.tools import kitti_to_bag

    rng = np.random.default_rng(3)
    seq = tmp_path / "seq"
    (seq / "velodyne").mkdir(parents=True)
    for i in range(3):
        xyz, inten, _, _ = _sweep(rng, n=300 + 50 * i)
        np.concatenate([xyz, inten[:, None]], 1).astype(np.float32).tofile(
            seq / "velodyne" / f"{i:06d}.bin")
    if times:
        np.savetxt(seq / "times.txt", [0.0, 0.1037, 0.2071])
    port, ref = str(tmp_path / "port.bag"), str(tmp_path / "ref.bag")
    assert kitti_to_bag.main(["--kitti", str(seq), "--out", port]) == 0
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    monkeypatch.setattr("sys.argv", ["kitti_to_bag.py", "--kitti", str(seq), "--out", ref])
    with pytest.raises(SystemExit) as done:
        runpy.run_path(os.path.join(root, "tools", "kitti_to_bag.py"), run_name="__main__")
    assert done.value.code == 0
    with open(port, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()
    clouds = [trb.decode_pointcloud2(raw) for *_, raw in trb.read_messages(port)]
    assert [len(c["x"]) for c in clouds] == [300, 350, 400]
    assert all(np.all((c["time"] >= 0) & (c["time"] <= 0.1)) for c in clouds)
