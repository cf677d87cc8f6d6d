"""SLAM run harness of the PyTorch port — the engine's replacement for the
reference's launch files + kittiHelper + rosbag play (port of
tools/run_slam.py).

Examples:
  # KITTI sequence (the native C++ prefetching loader):
  python -m agi_lidar_slam_torch.tools.run_slam --kitti /data/kitti/sequences/00 \\
      --preset aloam --max-scans 500 --metrics /tmp/run.jsonl --save-map /tmp/maps

  # built-in simulator (no dataset needed):
  python -m agi_lidar_slam_torch.tools.run_slam --sim --frames 40 --preset sim16

  # a ROS1 bag through the LIO-SAM engine with navsat GPS fusion:
  python -m agi_lidar_slam_torch.tools.run_slam --bag run.bag --engine liosam \\
      --gps-topic /gps/fix --navsat

Outputs the trajectory (KITTI pose format), ATE vs ground truth when
available, per-scan JSONL metrics, the summary JSON and the --gate exit
codes (0 within the envelope, 2 on a breach), as the reference runner does.

The engines run on `--device` (default cuda; without a card a run raises
unless given `--device cpu`). Each scan's pose and metrics come to the host
in one read. `--viz` (the PNG renderer) is not ported yet.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

from ..device import host_to_device
from ..eval.metrics import ate_rmse, check_envelope, kitti_drift, load_envelope
from ..geometry import se3, so3
from ..runtime.metrics import MetricsWriter, StageTimer, scan_scalars

def _pipeline_cfg(name: str):
    """Resolve a --preset string to a PipelineConfig. The *-ref presets are
    the reference-parameter parity pack (presets.py)."""
    from ..config import preset_aloam_kitti64, preset_lego_vlp16, preset_sim16
    from ..presets import REFERENCE_PIPELINE_PRESETS

    table = {"aloam": preset_aloam_kitti64, "sim16": preset_sim16,
             "lego": preset_lego_vlp16, **REFERENCE_PIPELINE_PRESETS}
    return table[name]()


def _gate_exit(args, summary: dict) -> int:
    """Write --summary-out, then apply --gate: compare the run summary to
    the envelope, print the verdict, and return the process exit code (2 on
    breach — the one-command accuracy gate for dataset parity runs)."""
    if getattr(args, "summary_out", None):
        # provenance so the artifact is self-describing
        summary.setdefault("command", "agi_lidar_slam_torch.tools.run_slam "
                           + " ".join(args.argv))
        if getattr(args, "engine", None):
            summary.setdefault("engine", args.engine)
        if getattr(args, "sim", False):
            summary.setdefault("world", args.world)
        with open(args.summary_out, "w") as f:
            json.dump(summary, f, indent=1)
        print("summary written:", args.summary_out)
    if not getattr(args, "gate", None):
        return 0
    env = load_envelope(args.gate)
    breaches = check_envelope(summary, env)
    bounds = {k: v for k, v in env.items() if not k.startswith("_")}
    if breaches:
        print(f"GATE FAIL ({args.gate}):")
        for b in breaches:
            print(f"  - {b}")
        return 2
    print(f"GATE PASS ({args.gate}): within {bounds}")
    return 0


def _make_viz(args):
    """--live-viz PORT: start the rviz-analog SSE viewer (io/live_viz.py),
    bound to 127.0.0.1."""
    if not getattr(args, "live_viz", None):
        return None
    from ..io.live_viz import VizServer

    viz = VizServer(port=args.live_viz).start()
    print(f"live viz: http://localhost:{viz.port}/")
    return viz


def _viz_pub(viz, scalars: dict, scan=None, stride=97):
    """Publish one scan's pose (from the scan's host read, `scan_scalars`)
    + a decimated world-frame scatter. `scan` is a ScanGrid or an (xyz, mask)
    pair; the points come to the host only while a viewer runs."""
    if viz is None:
        return
    t, q = np.asarray(scalars["t"]), np.asarray(scalars["q"])
    pts = None
    if scan is not None:
        xyz, m = (scan if isinstance(scan, tuple) else (scan.xyz, scan.mask))
        xyz = np.asarray(torch.as_tensor(xyz).cpu()).reshape(-1, 3)[::stride]
        m = np.asarray(torch.as_tensor(m).cpu()).reshape(-1)[::stride]
        xyz = xyz[m]
        w, x, y, z = q
        R = np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                      [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                      [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])
        pts = xyz @ R.T + t
    viz.publish(t, pose_q=q, points=pts)


class _Track:
    """The estimated trajectory, one host read a scan: `add` takes a
    result's `scan_scalars` (pose and metrics read together)."""

    def __init__(self):
        self.t, self.q = [], []  # positions; quaternions x, y, z, w

    def add(self, res) -> dict:
        s = scan_scalars(res)
        self.t.append(s["t"])
        w, x, y, z = s["q"]
        self.q.append([x, y, z, w])
        return s

    def __len__(self):
        return len(self.t)

    def positions(self) -> np.ndarray:
        return np.asarray(self.t, np.float64).reshape(-1, 3)

    def quats(self) -> np.ndarray:
        return np.asarray(self.q, np.float64).reshape(-1, 4)


def _write_traj(path: str, est: np.ndarray) -> None:
    with open(path, "w") as f:
        for p in est:
            M = np.eye(4)
            M[:3, 3] = p
            f.write(" ".join(f"{v:.6e}" for v in M[:3].reshape(-1)) + "\n")
    print("trajectory written:", path)


def _accuracy(summary: dict, est: np.ndarray, est_q: np.ndarray, gt_positions, gt_quats,
              verbose_drift: bool = True) -> None:
    """ATE (aligned and raw) and the KITTI drift metric into `summary`."""
    n = len(est)
    err = ate_rmse(est, gt_positions[:n])
    err_na = ate_rmse(est, gt_positions[:n], align=False)
    print(f"ATE RMSE: {err:.3f} m (aligned), {err_na:.3f} m (raw)")
    summary.update(ate_m=err, ate_raw_m=err_na)
    gq = gt_quats[:n] if gt_quats is not None else None
    eq = est_q if gq is not None else None
    d = kitti_drift(est, gt_positions[:n], est_q=eq, gt_q=gq)
    if d["n_segments"]:
        extra = ""
        if verbose_drift:
            extra = (f" ({d['n_segments']} segments; per-length "
                     f"{ {k: round(v, 3) for k, v in d['per_length'].items()} })")
        print(f"KITTI drift: {d['t_rel_pct']:.3f}% translational, "
              f"{d['r_deg_per_m']:.5f} deg/m rotational{extra}")
        summary.update(t_rel_pct=d["t_rel_pct"], r_deg_per_m=d["r_deg_per_m"])


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m agi_lidar_slam_torch.tools.run_slam")
    ap.add_argument("--kitti", help="KITTI sequence dir (with velodyne/)")
    ap.add_argument("--bag", help="ROS1 .bag file (PointCloud2/CustomMsg + Imu)")
    ap.add_argument("--sim", action="store_true", help="run on the simulator")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engines (default cuda; 'cpu' runs "
                         "every kernel's plain version on the host)")
    ap.add_argument("--preset", default="aloam",
                    choices=["aloam", "sim16", "lego",
                             "aloam-ref", "lego-ref", "liosam-ref",
                             "avia-ref", "horizon-ref"],
                    help="engine configuration preset; the *-ref presets "
                         "restore the reference's shipped parameters "
                         "(presets.py) for dataset parity runs. avia-ref "
                         "applies to --engine lio, horizon-ref to livox")
    ap.add_argument("--gate",
                    help="accuracy envelope: JSON file, named envelope in "
                         "eval/envelopes/ (e.g. kitti00_aloam), or inline "
                         "'ate_m=0.5,t_rel_pct=1.0'; exits 2 on breach")
    ap.add_argument("--engine", default=None,
                    choices=["odom", "slam", "lio", "livox", "liosam"],
                    help="odom/slam: feature scan-to-map; lio: FAST-LIO IESKF; "
                         "livox: sliding-window MAP; liosam: IMU-coupled + graph")
    ap.add_argument("--lidar-topic", default=None)
    ap.add_argument("--imu-topic", default=None)
    ap.add_argument("--gps-topic", default=None,
                    help="bag GPS topic (nav_msgs/Odometry or NavSatFix); "
                         "adds unary GPS factors in slam/liosam engines "
                         "(LIO-SAM gpsTopic)")
    ap.add_argument("--navsat", action="store_true",
                    help="fuse IMU+GPS through the navsat ESKF "
                         "(imu/navsat.py) and feed the smoothed odometry to "
                         "the GPS factors — the reference's ekf_gps stage")
    ap.add_argument("--gps-cov-thresh", type=float, default=2.0,
                    help="skip GPS fixes whose position covariance exceeds "
                         "this (LIO-SAM gpsCovThreshold)")
    ap.add_argument("--imu-mode", type=int, default=2, choices=[0, 1, 2],
                    help="livox engine IMU mode (horizon.launch:10-11): "
                         "0 = LiDAR-only, 1 = gyro deskew only, "
                         "2 = tightly-coupled window LIO")
    ap.add_argument("--rings", type=int, default=None,
                    help="grid rows for bag feature engines (default 16, or "
                         "6 for livox CustomMsg)")
    ap.add_argument("--max-points", type=int, default=131072)
    ap.add_argument("--fov-up", type=float, default=2.0,
                    help="grid fov for bag clouds without a ring channel")
    ap.add_argument("--fov-down", type=float, default=-24.8)
    ap.add_argument("--frames", type=int, default=40, help="sim frames")
    ap.add_argument("--world", default="arena",
                    choices=["arena", "city", "corridor"],
                    help="simulator world: arena (pillar box), city "
                         "(urban-canyon block loop), corridor (degenerate "
                         "tunnel along +x)")
    ap.add_argument("--movers", type=int, default=0,
                    help="number of moving car-sized boxes in the sim world")
    ap.add_argument("--sim-rings", type=int, default=16,
                    help="simulated beam count (64 = HDL-64 scale)")
    ap.add_argument("--sim-width", type=int, default=900,
                    help="simulated columns per sweep (1800 = HDL-64 scale)")
    ap.add_argument("--max-scans", type=int, default=None)
    ap.add_argument("--width", type=int, default=1800)
    ap.add_argument("--metrics", help="JSONL metrics output path")
    ap.add_argument("--summary-out",
                    help="write the run summary (scans/s, ATE, KITTI drift) "
                         "as JSON — the machine-checkable drift artifact")
    ap.add_argument("--save-map", help="directory for PCD map export")
    ap.add_argument("--traj-out", help="trajectory output (KITTI format)")
    ap.add_argument("--no-imu-deskew", action="store_true",
                    help="disable IMU-interpolated deskew in bag+lego mode")
    ap.add_argument("--imu-rate-out",
                    help="npz path for the IMU-rate pose stream (the "
                         "TransformFusion 200-500 Hz output): liosam engine "
                         "via the fused ESKF re-predict, odom/slam engines "
                         "via gyro-track + constant-velocity fusion")
    ap.add_argument("--loop-pairs",
                    help="file of externally supplied loop candidates, one "
                         "'cur_kf cand_kf' keyframe-index pair per line "
                         "(detectLoopClosureExternal analog; slam engine). "
                         "Pairs are verified by submap alignment before the "
                         "edge is added, then applied at end of stream")
    ap.add_argument("--viz", help="render trajectory/metrics PNG after the run "
                                  "(not ported yet: raises)")
    ap.add_argument("--live-viz", type=int, metavar="PORT",
                    help="serve the live rviz-analog viewer (SSE + embedded "
                         "canvas page, io/live_viz.py) on this port of 127.0.0.1")
    ap.add_argument("--slam", action="store_true",
                    help="full SLAM (keyframes + loop closure) instead of odometry")
    ap.add_argument("--load-map",
                    help="relocalization mode (laserMapping_re analog): dir "
                         "with CornerMap.pcd/SurfMap.pcd from --save-map "
                         "(GlobalMap.pcd for --engine lio); the engine starts "
                         "localized in that prior map (odom/slam/lio engines)")
    ap.add_argument("--init-pose", default="0,0,0,0",
                    help="relocalization seed 'x,y,z,yaw_deg' (mapping "
                         "init_pos/init_rot params)")
    return ap


def main(argv=None) -> int:
    """The command line: runs `run(argv)` (sys.argv[1:] by default) and
    returns its exit code."""
    return run(sys.argv[1:] if argv is None else argv)["rc"]


def run(argv) -> dict:
    """One run of the runner on the argument list `argv`: the record of the
    run, {"rc": exit code, "summary", "est" (N,3) positions, "est_q" (N,4)
    x, y, z, w, "wall_s", "n_scans", ...; "loader_wait_s" on --kitti,
    "n_gps_used" and "state" on --bag}."""
    ap = _parser()
    argv = list(argv)
    args = ap.parse_args(argv)
    args.argv = argv
    if args.viz:
        raise NotImplementedError(
            "--viz (tools/visualize.py, the PNG renderer) is not ported to the torch "
            "runner yet; it is left for a later slice (ROADMAP Queue 1)")
    args.device = torch.device(args.device)
    if args.device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device here; pass "
                           "--device cpu to run on the host")
    if args.engine is None:
        args.engine = "slam" if args.slam else "odom"
    if args.load_map and args.engine not in ("odom", "slam", "lio"):
        ap.error("--load-map relocalization covers the odom/slam/lio engines")
    if args.preset == "avia-ref" and args.engine != "lio":
        ap.error("--preset avia-ref is the --engine lio (IESKF) preset")
    if args.preset == "horizon-ref" and args.engine != "livox":
        ap.error("--preset horizon-ref is the --engine livox preset")
    if args.engine in ("lio", "liosam", "livox") and args.kitti:
        ap.error("the IMU-coupled engines need --bag (recorded IMU) or "
                 "--sim (exact analytic IMU); KITTI odometry has no IMU")

    if args.bag:
        return _run_bag(args)
    if args.kitti:
        return _run_feature(args, *_kitti_source(args))
    if args.sim:
        return _run_sim(args)
    ap.error("need --kitti, --bag or --sim")


def _kitti_source(args):
    """The native loader over the sequence's sweeps (64 rings: KITTI's
    HDL-64), and the ground truth when the sequence has poses."""
    from ..eval.metrics import mat_to_quat
    from ..io.kitti import load_poses, scan_paths
    from ..io.native_loader import NativeKittiLoader

    paths = scan_paths(args.kitti)
    if args.max_scans:
        paths = paths[: args.max_scans]
    scans = NativeKittiLoader(paths, rings=64, width=args.width, device=args.device)
    gt_positions = gt_quats = None
    seq = os.path.basename(os.path.normpath(args.kitti))
    pose_file = os.path.join(os.path.dirname(os.path.dirname(args.kitti)), "poses", f"{seq}.txt")
    if os.path.exists(pose_file):
        T = load_poses(pose_file, os.path.join(args.kitti, "calib.txt"))
        gt_positions = T[: len(paths), :3, 3]
        gt_quats = mat_to_quat(T[: len(paths), :3, :3])
    return _pipeline_cfg(args.preset), scans, gt_positions, gt_quats


def _sim_world(args, dev):
    """The simulator world, its trajectory (pose_at) and its exact IMU
    (imu_at) on `dev`."""
    from ..runtime.lio_pipeline import ImuWindow
    from ..sim.trajectory import (circle_imu, circle_pose, square_loop_imu,
                                  square_loop_pose, straight_imu)
    from ..sim.world import city_world, corridor_world, default_world, with_movers

    ds = 0.35  # metres per frame (3.5 m/s at 10 Hz)
    scan_period = 0.1
    imu_engine = args.engine in ("lio", "liosam", "livox")
    R_c, OM_c = 8.0, 0.4375
    if args.world == "city":
        world = city_world(seed=0, device=dev)  # street centerlines at +-13 m
        if args.movers:
            world = with_movers(world, n=args.movers, lane_y=-13.0, x_range=(-9.0, 9.0))

        def pose_at(i):  # rounded-square loop on the street grid
            return square_loop_pose(i * ds, side=18.0, corner=4.0, device=dev)
    elif args.world == "corridor":
        world = corridor_world(length=max(60.0, args.frames * ds + 20.0),
                               n_alcoves=max(2, args.frames // 25), device=dev)
        if args.movers:
            world = with_movers(world, n=args.movers, x_range=(8.0, args.frames * ds))

        def pose_at(i):
            t = torch.zeros(3, device=dev)
            t[0].fill_(i * ds)
            return se3.Pose(so3.quat_identity(device=dev), t)
    else:
        world = default_world(seed=0, device=dev)
        if args.movers:
            world = with_movers(world, n=args.movers)
        if imu_engine:
            # the arc trajectory has no closed-form IMU; IMU engines get
            # the exact circle instead (same 3.5 m/s)
            def pose_at(i):
                return circle_pose(i * scan_period, R_c, OM_c, device=dev)
        else:
            arc = []
            yaw = so3.quat_exp(torch.tensor([0.0, 0.0, 0.03], device=dev))
            fwd = torch.tensor([ds, 0.0, 0.0], device=dev)
            q, t = so3.quat_identity(device=dev), torch.zeros(3, device=dev)
            for _ in range(args.frames + 1):
                arc.append(se3.Pose(q, t))
                q = so3.quat_normalize(so3.quat_mul(q, yaw))
                t = t + so3.quat_rotate(q, fwd)

            def pose_at(i):
                return arc[i]

    def imu_at(i, m=20):
        """Exact IMU window covering frame i (body rates + specific force
        from the analytic trajectory of the chosen world)."""
        ts = (i + (torch.arange(m, dtype=torch.float32, device=dev) + 0.5) / m) * scan_period
        if args.world == "city":
            gy, ac = square_loop_imu(ts, side=18.0, corner=4.0, speed=ds / scan_period)
        elif args.world == "corridor":
            gy, ac = straight_imu(ts, speed=ds / scan_period)
        else:
            gy, ac = circle_imu(ts, R_c, OM_c)
        return ImuWindow(gy, ac, torch.full((m,), scan_period / m, device=dev),
                         torch.ones((m,), dtype=torch.bool, device=dev))

    return world, pose_at, imu_at, scan_period


def _run_sim(args) -> dict:
    """--sim: simulate the sweeps on the device, then run the chosen engine
    (the IMU engines on the exact analytic IMU, _run_sim_imu)."""
    from ..sim.world import simulate_scan

    dev = args.device
    world, pose_at, imu_at, scan_period = _sim_world(args, dev)
    imu_engine = args.engine in ("lio", "liosam", "livox")
    poses, scans = [], []
    inv0 = se3.inverse(pose_at(0))  # engines start at identity: rebase GT
    for i in range(args.frames):
        p, nxt = pose_at(i), pose_at(i + 1)
        scans.append(simulate_scan(world, p, nxt, rings=args.sim_rings, width=args.sim_width,
                                   noise_std=0.005, seed=i, t0=i * scan_period,
                                   scan_period=scan_period))
        # IMU engines estimate the sweep-END pose (deskew-to-end); the
        # feature engines estimate the sweep START
        poses.append(se3.compose(inv0, nxt if imu_engine else p))
    gt_positions = torch.stack([p.t for p in poses]).cpu().numpy()
    gt_quats = torch.stack([p.q for p in poses]).cpu().numpy()[:, [1, 2, 3, 0]]
    if imu_engine:
        return _run_sim_imu(args, scans, imu_at, gt_positions, gt_quats, scan_period)
    cfg = _pipeline_cfg(args.preset)
    if args.preset == "aloam" and args.sim_rings < 32:
        cfg = _pipeline_cfg("sim16")
    return _run_feature(args, cfg, scans, gt_positions, gt_quats)


def _run_feature(args, cfg, scans, gt_positions, gt_quats) -> dict:
    """The odom / slam engines over `scans` (the KITTI loader or the
    simulator's sweeps)."""
    from ..io.checkpoint import save_map_bundle
    from ..runtime.pipeline import init_state, process_scan

    dev = args.device
    metrics = MetricsWriter(args.metrics)
    viz = _make_viz(args)
    timer = StageTimer(dev)
    track = _Track()
    n = 0
    # --engine slam selects the slam engine here too (the reference runner
    # reads only --slam on this path and runs odometry for --engine slam)
    if args.slam or args.engine == "slam":
        from ..runtime.slam_pipeline import SlamDriver

        driver = SlamDriver(_slam_cfg(args.preset, cfg), device=dev)
        if args.load_map:
            driver.state = driver.state._replace(engine=_reloc_state(args, cfg))
        t_start = time.perf_counter()
        for scan in scans:
            t0 = time.perf_counter()
            with timer.stage("scan"):
                res = driver.process(scan)
            s = track.add(res)
            metrics.log_scan(n, res, (time.perf_counter() - t0) * 1e3, scalars=s)
            _viz_pub(viz, s, scan)
            n += 1
        driver.finalize()
        _apply_loop_pairs(args, driver)
        state = driver.state.engine
        print(f"loops closed: {driver.n_loops_closed}")
    else:
        state = _reloc_state(args, cfg) if args.load_map else init_state(cfg, dev)
        t_start = time.perf_counter()
        for scan in scans:
            t0 = time.perf_counter()
            with timer.stage("scan"):
                state, res = process_scan(state, scan, cfg)
            s = track.add(res)
            metrics.log_scan(n, res, (time.perf_counter() - t0) * 1e3, scalars=s)
            _viz_pub(viz, s, scan)
            n += 1

    wall = time.perf_counter() - t_start
    est, est_q = track.positions(), track.quats()
    print(f"processed {n} scans in {wall:.2f}s ({n / wall:.2f} scans/s)")
    print("stage timing:", timer.summary())
    record = {"est": est, "est_q": est_q, "wall_s": wall, "n_scans": n, "state": state}
    if hasattr(scans, "wait_s"):
        record["loader_wait_s"] = scans.wait_s
        print(f"loader: {scans.wait_s:.3f} s of {wall:.2f} s waiting for scans "
              f"({scans.n_scans} scans)")
        scans.close()
    summary = {"n_scans": n, "scans_per_s": n / wall}
    if gt_positions is not None and len(gt_positions) >= len(est):
        _accuracy(summary, est, est_q, gt_positions, gt_quats)
    if args.traj_out:
        _write_traj(args.traj_out, est)
    if args.save_map:
        save_map_bundle(args.save_map, state, trajectory=est)
        print("maps written:", args.save_map)
    metrics.close()
    return {**record, "summary": summary, "rc": _gate_exit(args, summary)}


def _run_sim_imu(args, scans, imu_at, gt_positions, gt_quats, scan_period) -> dict:
    """Drive the IMU-coupled engines (lio/liosam/livox) on the simulator with
    exact analytic IMU — the no-dataset analog of the bag path, e.g.
      run_slam --sim --engine lio --preset avia-ref --gate ate_m=0.3
    """
    dev = args.device
    metrics = MetricsWriter(args.metrics)
    viz = _make_viz(args)
    timer = StageTimer(dev)
    track = _Track()
    v0 = torch.zeros(3, device=dev)
    v0[0].fill_(0.35 / scan_period)  # all worlds start +x

    if args.engine == "lio":
        from ..imu.eskf import NavState
        from ..runtime.lio_pipeline import LioConfig, init_lio_state, process_lio_scan

        if args.preset == "avia-ref":
            from ..presets import lio_config_avia_ref

            cfg = lio_config_avia_ref()
        else:
            cfg = LioConfig()
        state = init_lio_state(cfg, NavState.identity(dev)._replace(v=v0), device=dev)
        for i, scan in enumerate(scans):
            pts = scan.xyz.reshape(-1, 3)
            tt = (scan.time * scan_period).reshape(-1).to(torch.float32)
            mm = scan.mask.reshape(-1)
            with timer.stage("scan"):
                state, res = process_lio_scan(state, pts, tt, mm, imu_at(i), cfg)
            s = track.add(res)
            metrics.log_scan(i, res, timer.last_ms, scalars=s)
            _viz_pub(viz, s, scan)
    elif args.engine == "liosam":
        from ..runtime.liosam_pipeline import LioSamConfig, LioSamDriver

        pname = args.preset
        if pname == "aloam" and args.sim_rings < 32:
            pname = "sim16"  # same fallback as the feature-engine sim path
        cfg = LioSamConfig(slam=_slam_cfg(pname, _pipeline_cfg(pname)), scan_period=scan_period)
        driver = LioSamDriver(cfg, v0=v0, emit_imu_rate=bool(args.imu_rate_out), device=dev)
        for i, scan in enumerate(scans):
            with timer.stage("scan"):
                res = driver.process(scan, imu_at(i))
            s = track.add(res)
            metrics.log_scan(i, res, timer.last_ms, scalars=s)
            _viz_pub(viz, s, scan)
        driver.finalize()
        print(f"loops closed: {driver.n_loops_closed}")
    else:  # livox
        from ..runtime.livox_pipeline import LivoxConfig, LivoxDriver

        if args.preset == "horizon-ref":
            from ..presets import livox_config_horizon_ref

            cfg = livox_config_horizon_ref()
        else:
            cfg = LivoxConfig()
        if args.imu_mode != 2:
            cfg = dataclasses.replace(cfg, imu_mode=args.imu_mode)
        driver = LivoxDriver(cfg, init_frames=max(4, min(10, args.frames // 3)), device=dev)
        for i, scan in enumerate(scans):
            with timer.stage("scan"):
                res = driver.process(scan, imu_at(i))
            s = track.add(res)
            metrics.log_scan(i, res, timer.last_ms, scalars=s)
            _viz_pub(viz, s, scan)

    n = len(track)
    wall = timer.summary()["scan"]["total_s"]
    est, est_q = track.positions(), track.quats()
    print(f"processed {n} scans in {wall:.2f}s ({n / wall:.2f} scans/s)")
    print("stage timing:", timer.summary())
    record = {"est": est, "est_q": est_q, "wall_s": wall, "n_scans": n}
    summary = {"n_scans": n, "scans_per_s": n / wall}
    _accuracy(summary, est, est_q, gt_positions, gt_quats, verbose_drift=False)
    if args.traj_out:
        _write_traj(args.traj_out, est)
    metrics.close()
    return {**record, "summary": summary, "rc": _gate_exit(args, summary)}


def _apply_loop_pairs(args, driver):
    """Feed externally supplied loop candidates (--loop-pairs) through the
    driver's verification path (detectLoopClosureExternal analog)."""
    if not getattr(args, "loop_pairs", None) or driver is None:
        return
    if not hasattr(driver, "close_loop_external"):
        print("--loop-pairs: engine has no external loop entry point")
        return
    n_ok = n_all = 0
    with open(args.loop_pairs) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2 and not line.lstrip().startswith("#"):
                n_all += 1
                if driver.close_loop_external(int(parts[0]), int(parts[1])):
                    n_ok += 1
    print(f"external loop pairs: {n_ok}/{n_all} accepted")


def _slam_cfg(preset: str, pcfg):
    """SlamConfig for the graph engines, with the graph-side reference
    parameters applied for the *-ref presets (LeGO keyframe 0.3 m,
    mapOptmization.cpp:1634-1641; LIO-SAM loop params, params.yaml:82-87)."""
    from ..graph.loop_closure import LoopConfig
    from ..runtime.slam_pipeline import SlamConfig

    if preset in ("lego", "lego-ref"):
        return SlamConfig(pipeline=pcfg, kf_dist=0.3, kf_angle=0.2)
    if preset == "liosam-ref":
        from ..presets import LioSamRefParams

        rp = LioSamRefParams()
        return SlamConfig(
            pipeline=pcfg, kf_dist=rp.kf_dist, kf_angle=rp.kf_angle,
            loop=LoopConfig(radius=rp.loop_radius,
                            min_stamp_sep=300,  # 30 s at the 10 Hz scan rate
                            submap_half=rp.loop_submap // 2,
                            fitness_thresh=rp.loop_fitness),
        )
    return SlamConfig(pipeline=pcfg)


def _seed_pose(args) -> se3.Pose:
    """--init-pose 'x,y,z,yaw_deg' as a Pose on the run's device."""
    x, y, z, yaw = (float(v) for v in args.init_pose.split(","))
    dev = args.device
    return se3.Pose(so3.quat_exp(torch.tensor([0.0, 0.0, float(np.deg2rad(yaw))], device=dev)),
                    torch.tensor([x, y, z], device=dev))


def _reloc_state(args, cfg):
    """Prior-map relocalization (S-FAST_LIO laserMapping_re.cpp:350,541-589):
    prefill the engine maps from a saved bundle and seed the pose from
    --init-pose (the init_pos/init_rot params)."""
    from ..io.checkpoint import read_pcd, relocalize_state

    corner = read_pcd(os.path.join(args.load_map, "CornerMap.pcd"))
    surf = read_pcd(os.path.join(args.load_map, "SurfMap.pcd"))
    print(f"relocalizing in {args.load_map}: {len(corner)} corner / "
          f"{len(surf)} surf map points, seed ({args.init_pose} x,y,z,yaw deg)")
    return relocalize_state(cfg, corner, surf, _seed_pose(args), device=args.device)


def _run_bag(args) -> dict:
    """Stream a ROS1 bag through the chosen engine (the one-command analog of
    `roslaunch ... && rosbag play ...`)."""
    from ..io.bag_stream import bundle_to_grid, stream_bag
    from ..runtime.lio_pipeline import ImuWindow

    dev = args.device
    metrics = MetricsWriter(args.metrics)
    viz = _make_viz(args)
    timer = StageTimer(dev)
    track = _Track()
    n = 0
    t_start = time.perf_counter()
    stream = stream_bag(args.bag, lidar_topic=args.lidar_topic,
                        imu_topic=args.imu_topic, max_points=args.max_points,
                        gps_topic=args.gps_topic)

    def on_dev(a, dtype=None):
        t = host_to_device(a, dev)
        return t if dtype is None else t.to(dtype)

    def imu_valid(b):
        """The bundle's IMU window cut to its valid samples (at least one):
        stream_bag pads every window to its capacity (512), and the eager
        engines' gyro tracks step through every sample of a window. The
        padding is masked, so the cut changes no result beyond rounding."""
        n = max(1, int(np.count_nonzero(b.imu_mask)))
        return b.imu_gyro[:n], b.imu_acc[:n], b.imu_dt[:n], b.imu_mask[:n]

    def imu_win(b):
        return ImuWindow(*(on_dev(a) for a in imu_valid(b)))

    n_gps_used = 0
    navsat = None
    if args.gps_topic and args.navsat:
        from ..imu.navsat import NavsatFilter

        navsat = NavsatFilter(device=dev)

    def gps_of(b):
        """Covariance-gated GPS fix for the factor graph (addGPSFactor's
        gpsCovThreshold gate, mapOptmization.cpp:1894-1896). Returns
        (position, information weight): the reference builds each factor's
        noise from the fix covariance floored at 1 m^2 (:1932-1941), so the
        weight is 1/max(var, 1).

        With --navsat the raw fixes first pass through the GPS+IMU ESKF
        (imu/navsat.py) and the smoothed odometry feeds the factor instead;
        its covariance comes to the host for the gate (one read a scan)."""
        nonlocal n_gps_used
        if navsat is not None:
            fix = fix_cov = None
            if b.gps is not None:
                fix = np.asarray(b.gps, np.float32)
                fix_cov = (np.asarray(b.gps_cov, np.float32) if b.gps_cov is not None else None)
            pos, cov = navsat.step(*imu_valid(b), fix=fix, fix_cov=fix_cov)
            var = float(torch.max(cov[:2]))
            if var > args.gps_cov_thresh:
                return None
            n_gps_used += 1
            return (pos, 1.0 / max(var, 1.0))
        if b.gps is None:
            return None
        var = 0.0
        if b.gps_cov is not None:
            var = float(np.max(b.gps_cov[:2]))
            if var > args.gps_cov_thresh:
                return None
        n_gps_used += 1
        return (np.asarray(b.gps, np.float32), 1.0 / max(var, 1.0))

    state = None
    driver = None
    if args.engine == "lio":
        from ..runtime.lio_pipeline import LioConfig, init_lio_state, process_lio_scan, static_init

        blind = 0.0
        ext_t = None
        if args.preset == "avia-ref":
            from ..presets import lio_config_avia_ref, preset_sfastlio_avia_ref

            cfg = lio_config_avia_ref()
            _, _, _, _, blind, ext_t = preset_sfastlio_avia_ref()
        else:
            cfg = LioConfig()
        reloc = None
        if args.load_map:
            from ..io.checkpoint import read_pcd, relocalize_lio_state

            pts = read_pcd(os.path.join(args.load_map, "GlobalMap.pcd"))
            reloc = (pts, _seed_pose(args))
            print(f"relocalizing in {args.load_map}: {len(pts)} map points, "
                  f"seed ({args.init_pose} x,y,z,yaw deg)")
        for b in stream:
            win = imu_win(b)
            if state is None:
                x0 = static_init(win.gyro, win.acc, win.mask)
                if ext_t is not None:  # avia.yaml extrinsic_T (frozen:
                    # extrinsic_est_en false, so seed it exactly)
                    x0 = x0._replace(t_li=torch.tensor(ext_t, dtype=torch.float32, device=dev))
                state = init_lio_state(cfg, x0, device=dev)
                if reloc is not None:
                    state = relocalize_lio_state(cfg, reloc[0], reloc[1], device=dev)
                    # keep the static-init gravity/bias estimates, seed the pose
                    state = state._replace(x=x0._replace(p=state.x.p, q=state.x.q))
            xyz = on_dev(b.xyz)
            pmask = on_dev(b.mask)
            if blind > 0.0:  # blind-zone removal (avia.yaml preprocess.blind)
                pmask = pmask & (torch.linalg.vector_norm(xyz, dim=-1) > blind)
            with timer.stage("scan"):
                state, res = process_lio_scan(state, xyz, on_dev(b.rel_time), pmask, win, cfg)
            s = track.add(res)
            metrics.log_scan(n, res, timer.last_ms, scalars=s)
            _viz_pub(viz, s, (b.xyz, b.mask))
            n += 1
            if args.max_scans and n >= args.max_scans:
                break
        final_state = state
    elif args.engine == "livox":
        from ..runtime.livox_pipeline import LivoxConfig, LivoxDriver

        if args.preset == "horizon-ref":
            from ..presets import livox_config_horizon_ref

            cfg = livox_config_horizon_ref()
        else:
            cfg = LivoxConfig()
        if args.imu_mode != 2:
            cfg = dataclasses.replace(cfg, imu_mode=args.imu_mode)
        rings = args.rings or 6
        driver = LivoxDriver(cfg, device=dev)
        for b in stream:
            grid = bundle_to_grid(b, rings, args.width, args.fov_up, args.fov_down, device=dev)
            with timer.stage("scan"):
                res = driver.process(grid, imu_win(b))
            s = track.add(res)
            metrics.log_scan(n, res, timer.last_ms, scalars=s)
            _viz_pub(viz, s, grid)
            n += 1
            if args.max_scans and n >= args.max_scans:
                break
        final_state = driver.state
    elif args.engine == "liosam":
        from ..runtime.liosam_pipeline import LioSamConfig, LioSamDriver

        pcfg = _pipeline_cfg(args.preset)
        if args.preset == "liosam-ref":
            from ..presets import LioSamRefParams

            rp = LioSamRefParams()
            cfg = LioSamConfig(slam=_slam_cfg(args.preset, pcfg), imu_noise=rp.imu_noise())
        else:
            cfg = LioSamConfig(slam=_slam_cfg(args.preset, pcfg))
        rings = args.rings or 16
        driver = LioSamDriver(cfg, emit_imu_rate=bool(args.imu_rate_out), device=dev)
        for b in stream:
            grid = bundle_to_grid(b, rings, args.width, args.fov_up, args.fov_down, device=dev)
            with timer.stage("scan"):
                res = driver.process(grid, imu_win(b), gps=gps_of(b))
            s = track.add(res)
            metrics.log_scan(n, res, timer.last_ms, scalars=s)
            _viz_pub(viz, s, grid)
            n += 1
            if args.max_scans and n >= args.max_scans:
                break
        driver.finalize()
        final_state = driver.state.engine
        if args.imu_rate_out and driver.imu_rate_out:
            _save_imu_rate(args.imu_rate_out, driver.imu_rate_out, b.imu_mask.shape[0])
    else:  # odom / slam on bag clouds (no IMU needed)
        from ..runtime.pipeline import init_state, process_scan
        from ..runtime.slam_pipeline import SlamDriver

        def _grid_health_check(b, grid):
            """A grid binned at the wrong --width/--rings drops points or
            scatters them too sparsely for the 11-point curvature windows —
            the engine then free-wheels at identity with zero features.
            Caught on the first scan instead of after a silent full run."""
            n_pts = int(np.asarray(b.mask).sum())
            occ_rows = grid.mask.sum(dim=1)
            occ, rows = (int(v) for v in torch.stack(
                [occ_rows.sum(), (occ_rows > 0).sum()]).tolist())
            W = grid.mask.shape[1]
            if n_pts and occ < 0.5 * n_pts:
                print(f"WARNING: only {occ}/{n_pts} bag points landed in the "
                      f"{grid.mask.shape[0]}x{W} grid — "
                      "check --rings/--width/--fov-up/--fov-down against the "
                      "sensor (collisions/out-of-fov points are dropped)",
                      file=sys.stderr)
            if rows and occ / (rows * W) < 0.6:
                ppr = occ // max(rows, 1)
                print(f"WARNING: occupied grid rows are only "
                      f"{100 * occ // (rows * W)}% filled — "
                      "curvature windows need contiguous returns; if feature "
                      f"counts stay 0, try --width {max(64, ppr)} (the "
                      "sensor's points-per-ring)", file=sys.stderr)

        pcfg = _pipeline_cfg(args.preset)
        # LeGO with an IMU stream in the bag: IMU-interpolated deskew
        # (adjustDistortion, featureAssociation.cpp:617-806) replaces the
        # solver's constant-velocity model
        use_imu_deskew = args.preset in ("lego", "lego-ref") and not args.no_imu_deskew
        if use_imu_deskew:
            from ..imu.deskew import deskew_imu_rotation

            pcfg = dataclasses.replace(pcfg, deskew=False)
        rings = args.rings or 16
        if args.engine == "slam":
            driver = SlamDriver(_slam_cfg(args.preset, pcfg), device=dev)
            if args.load_map:
                driver.state = driver.state._replace(engine=_reloc_state(args, pcfg))
        elif args.load_map:
            state = _reloc_state(args, pcfg)
        else:
            state = init_state(pcfg, dev)
        imu_rate_acc = []  # (qs, ps, mask) per scan when --imu-rate-out
        for b in stream:
            grid = bundle_to_grid(b, rings, args.width, args.fov_up, args.fov_down, device=dev)
            if n == 0:
                _grid_health_check(b, grid)
            has_imu = bool(np.any(b.imu_mask))
            if use_imu_deskew and has_imu:
                win = imu_win(b)
                cur = driver.state.engine if driver is not None else state
                # constant-velocity translation prior in the sweep-start frame
                rel_t = so3.quat_rotate(so3.quat_conj(cur.pose.q), cur.pose.t - cur.prev_pose.t)
                grid = deskew_imu_rotation(grid, win.gyro, win.dt, win.mask, rel_t)
            with timer.stage("scan"):
                if driver is not None:
                    res = driver.process(grid, gps=gps_of(b))
                else:
                    state, res = process_scan(state, grid, pcfg)
            s = track.add(res)
            if args.imu_rate_out and has_imu:
                # TransformFusion analog for the LiDAR-only engines
                # (transformFusion.cpp:35-288): scan-rate pose + gyro-track
                # rotation + constant-velocity translation at IMU rate
                from ..imu.deskew import fuse_imu_rate

                cur = driver.state.engine if driver is not None else state
                dt_sweep = float(np.sum(np.where(b.imu_mask, b.imu_dt, 0.0)))
                v_w = (cur.pose.t - cur.prev_pose.t) / max(dt_sweep, 1e-3)
                win = imu_win(b)
                imu_rate_acc.append(fuse_imu_rate(cur.pose.q, cur.pose.t, v_w,
                                                  win.gyro, win.dt, win.mask))
            if n == 2 and s["n_corner"] + s["n_surf"] == 0:
                print("WARNING: zero features after 3 scans — the engine is "
                      "free-wheeling. Usually a grid-binning mismatch: set "
                      "--width to the sensor's points-per-ring and --rings/"
                      "--fov-* to its geometry", file=sys.stderr)
            metrics.log_scan(n, res, timer.last_ms, scalars=s)
            _viz_pub(viz, s, grid)
            n += 1
            if args.max_scans and n >= args.max_scans:
                break
        if driver is not None:
            driver.finalize()
            _apply_loop_pairs(args, driver)
        final_state = driver.state.engine if driver is not None else state
        if args.imu_rate_out and imu_rate_acc:
            _save_imu_rate(args.imu_rate_out, imu_rate_acc, b.imu_mask.shape[0])

    wall = time.perf_counter() - t_start
    if n == 0:
        print("no lidar messages found in bag")
        return {"rc": 1}
    est = track.positions()
    print(f"processed {n} scans in {wall:.2f}s ({n / wall:.2f} scans/s)")
    print("stage timing:", timer.summary())
    record = {"est": est, "est_q": track.quats(), "wall_s": wall, "n_scans": n,
              "state": final_state, "n_gps_used": n_gps_used}
    if args.gps_topic:
        print(f"gps factors added: {n_gps_used}")
    if args.traj_out:
        _write_traj(args.traj_out, est)
    if args.save_map and args.engine in ("odom", "slam", "liosam"):
        from ..io.checkpoint import save_map_bundle

        save_map_bundle(args.save_map, final_state, trajectory=est)
        print("maps written:", args.save_map)
    elif args.save_map and args.engine == "lio":
        from ..io.checkpoint import export_pcd, map_to_points

        os.makedirs(args.save_map, exist_ok=True)
        export_pcd(os.path.join(args.save_map, "GlobalMap.pcd"), map_to_points(final_state.map))
        export_pcd(os.path.join(args.save_map, "trajectory.pcd"), est)
        print("maps written:", args.save_map)
    metrics.close()
    # bag runs carry no ground truth; the gate covers scan count/throughput
    # (an envelope naming an accuracy metric fails loudly, never vacuously)
    summary = {"n_scans": n, "scans_per_s": n / wall}
    return {**record, "summary": summary, "rc": _gate_exit(args, summary)}


def _save_imu_rate(path: str, stream: list, capacity: int) -> None:
    """(qs, ps, mask) per scan -> one npz of host arrays (scans, capacity,
    ...), each scan's samples padded to the bag windows' capacity with
    masked zeros, as the reference runner writes them."""
    def pad(a):
        return torch.nn.functional.pad(a, (0, 0) * (a.dim() - 1) + (0, capacity - a.shape[0]))

    qs, ps, ms = (torch.stack([pad(x[k]) for x in stream]).cpu().numpy() for k in range(3))
    np.savez(path, q=qs, p=ps, mask=ms)
    print("imu-rate pose stream written:", path, f"({int(ms.sum())} poses)")


if __name__ == "__main__":
    raise SystemExit(main())
