"""The port's runner (`python -m agi_lidar_slam_torch.tools.run_slam`) on
the CPU, at 16 rings of 900 columns and 4 sweeps, on recordings made on
disk from the simulator (agi_lidar_slam_torch.sim.recordings).

It keeps the reference runner's contract (tools/run_slam.py): the
trajectory file, the JSONL metrics keys, the summary keys, the --gate exit
codes 0 and 2, the PCD map bundle and relocalization from it. The JAX runner
is not run here: its own tests/test_kitti_e2e.py covers it, and the engines
under the port's runner are held to the JAX engines by the other
tests/test_torch_*.py files. Here the runner's KITTI trajectory must equal,
exactly, the port's process_scan driven directly over the loader's grids."""

import json
import os

import numpy as np
import pytest
import torch

from agi_lidar_slam_torch.config import preset_sim16
from agi_lidar_slam_torch.geometry import se3, so3
from agi_lidar_slam_torch.io import kitti
from agi_lidar_slam_torch.io.checkpoint import read_pcd
from agi_lidar_slam_torch.io.native_loader import NativeKittiLoader
from agi_lidar_slam_torch.runtime.pipeline import init_state, process_scan
from agi_lidar_slam_torch.sim.recordings import write_kitti_sequence, write_sweep_bag
from agi_lidar_slam_torch.sim.trajectory import circle_imu, circle_pose
from agi_lidar_slam_torch.sim.world import default_world, simulate_scan
from agi_lidar_slam_torch.tools import run_slam
from tests._torch_threads import torch_one_thread  # noqa: F401 (autouse)

RINGS, WIDTH = 16, 900
# the reference runner's record and summary keys for these runs (no KITTI
# drift segments on paths this short, no "world" outside --sim)
METRICS_KEYS = ["frame", "wall_ms", "n_corner", "n_surf", "rms", "degenerate", "n_dropped", "t"]
KITTI_SUMMARY_KEYS = {"n_scans", "scans_per_s", "ate_m", "ate_raw_m", "command", "engine"}
BAG_SUMMARY_KEYS = {"n_scans", "scans_per_s", "command", "engine"}


@pytest.fixture(scope="module")
def kitti_seq(tmp_path_factory):
    """4 sweeps along tests/test_kitti_e2e.py's arc (0.3 m and 0.02 rad a
    sweep, world seed 5) laid out as KITTI sequence 07."""
    root = str(tmp_path_factory.mktemp("kitti"))
    world = default_world(seed=5, n_pillars=24, extent=18.0, device="cpu")
    q, t = so3.quat_identity(device="cpu"), torch.zeros(3)
    scans, poses = [], []
    for i in range(4):
        p = se3.Pose(q, t)
        q = so3.quat_normalize(so3.quat_mul(q, so3.quat_exp(torch.tensor([0.0, 0.0, 0.02]))))
        t = t + so3.quat_rotate(q, torch.tensor([0.3, 0.0, 0.0]))
        scans.append(simulate_scan(world, p, se3.Pose(q, t), rings=RINGS, width=WIDTH,
                                   noise_std=0.004, seed=i))
        poses.append(p)
    return write_kitti_sequence(root, scans, poses)


def test_runner_kitti_gates_and_matches_direct_engine(kitti_seq, tmp_path, capsys):
    out = {k: str(tmp_path / k) for k in ("summary.json", "traj.txt", "m.jsonl", "maps")}
    base = ["--kitti", kitti_seq, "--preset", "sim16", "--width", str(WIDTH), "--device", "cpu",
            "--summary-out", out["summary.json"], "--traj-out", out["traj.txt"],
            "--metrics", out["m.jsonl"], "--save-map", out["maps"]]
    png = tmp_path / "run.png"
    run = run_slam.run(base + ["--gate", "ate_m=2.0", "--viz", str(png)])
    assert run["rc"] == 0 and "GATE PASS" in capsys.readouterr().out
    assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"  # --viz drew what the run wrote
    est = run["est"]
    summary = json.load(open(out["summary.json"]))
    assert set(summary) == KITTI_SUMMARY_KEYS
    assert summary["n_scans"] == 4 and summary["ate_m"] < 2.0 and "--kitti" in summary["command"]
    recs = [json.loads(line) for line in open(out["m.jsonl"])]
    assert len(recs) == 4 and all(list(r) == METRICS_KEYS for r in recs)
    assert recs[-1]["n_surf"] > 100
    traj = np.loadtxt(out["traj.txt"]).reshape(-1, 3, 4)
    np.testing.assert_allclose(traj[:, :, 3], est, rtol=1e-6, atol=1e-7)  # %.6e
    g = read_pcd(os.path.join(out["maps"], "GlobalMap.pcd"))
    c = read_pcd(os.path.join(out["maps"], "CornerMap.pcd"))
    s = read_pcd(os.path.join(out["maps"], "SurfMap.pcd"))
    assert len(g) == len(c) + len(s) > 1000
    assert len(read_pcd(os.path.join(out["maps"], "trajectory.pcd"))) == 4

    # the same grids through process_scan directly: the same poses, exactly
    cfg = preset_sim16()
    state, direct = init_state(cfg, "cpu"), []
    with NativeKittiLoader(kitti.scan_paths(kitti_seq), rings=64, width=WIDTH,
                           device="cpu") as loader:
        for grid in loader:
            state, res = process_scan(state, grid, cfg)
            direct.append(res.pose.t.numpy())
    np.testing.assert_array_equal(est, np.stack(direct).astype(np.float64))

    # an impossible envelope: exit 2, the breach contract parity runs rely on
    assert run_slam.main(base + ["--gate", "ate_m=0.000001", "--max-scans", "2"]) == 2
    assert "GATE FAIL" in capsys.readouterr().out


def test_runner_relocalizes_in_saved_map(kitti_seq, tmp_path):
    """--save-map, then --load-map with a seed 0.15 m and 2 deg off the
    first sweep's pose: the relocalized run starts in the saved map."""
    maps = str(tmp_path / "maps")
    base = ["--kitti", kitti_seq, "--preset", "sim16", "--width", str(WIDTH), "--device", "cpu",
            "--max-scans", "2"]
    first = run_slam.run(base + ["--save-map", maps])["est"][0]
    run = run_slam.run(base + ["--load-map", maps, "--init-pose", "0.15,-0.05,0,2"])
    assert run["rc"] == 0
    reloc = run["est"]
    assert np.linalg.norm(reloc[0] - first) < 0.05
    assert np.all(np.isfinite(reloc))


def test_runner_sim_lio(tmp_path):
    """--sim --engine lio: the IESKF engine on the exact analytic IMU of the
    arena's circle, gated on its ATE."""
    out = str(tmp_path / "s.json")
    argv = ["--sim", "--engine", "lio", "--frames", "4", "--sim-rings", str(RINGS),
            "--sim-width", str(WIDTH), "--device", "cpu", "--summary-out", out,
            "--gate", "ate_raw_m=0.1"]
    assert run_slam.main(argv) == 0
    summary = json.load(open(out))
    assert summary["world"] == "arena" and summary["engine"] == "lio"
    assert summary["n_scans"] == 4 and summary["ate_raw_m"] < 0.1


@pytest.fixture(scope="module")
def circle_bag(tmp_path_factory):
    """4 sweeps of the LIO circle (radius 8 m, 0.25 rad/s, world seed 3)
    with 200 Hz IMU and NavSatFix fixes at 0 and 0.2 s."""
    path = str(tmp_path_factory.mktemp("bag") / "circle.bag")
    world = default_world(seed=3, n_pillars=48, extent=35.0, device="cpu")
    scans, imu = [], []
    for i in range(4):
        p0, p1 = (circle_pose(k * 0.1, 8.0, 0.25, device="cpu") for k in (i, i + 1))
        scans.append(simulate_scan(world, p0, p1, rings=RINGS, width=WIDTH, fov_up_deg=2.0,
                                   fov_down_deg=-24.8, noise_std=0.01, seed=i))
        imu.append(circle_imu(i * 0.1 + (torch.arange(20) + 0.5) * 0.005, 8.0, 0.25))
    fixes = [(t, circle_pose(t, 8.0, 0.25, device="cpu").t) for t in (0.0, 0.2)]
    write_sweep_bag(path, scans, imu, fixes=fixes)
    return path


def test_runner_bag_liosam_navsat(circle_bag, tmp_path, capsys):
    """--bag --engine liosam --navsat: the fixes pass the navsat ESKF and
    its covariance gate into the GPS factors; the IMU-rate stream is saved."""
    out, rate = str(tmp_path / "s.json"), str(tmp_path / "rate.npz")
    argv = ["--bag", circle_bag, "--engine", "liosam", "--preset", "sim16", "--rings",
            str(RINGS), "--width", str(WIDTH), "--gps-topic", "/gps/fix", "--navsat",
            "--device", "cpu", "--summary-out", out, "--imu-rate-out", rate]
    run = run_slam.run(argv)
    assert run["rc"] == 0 and "gps factors added: 4" in capsys.readouterr().out
    assert run["n_gps_used"] == 4
    assert set(json.load(open(out))) == BAG_SUMMARY_KEYS
    est = run["est"]
    assert est.shape == (4, 3) and np.all(np.isfinite(est))
    assert np.linalg.norm(est[-1] - est[0]) > 0.2  # it moved with the circle
    z = np.load(rate)
    assert z["q"].shape == (4, 512, 4) and int(z["mask"].sum()) == 80  # 20 of 512 a sweep


def test_runner_bag_lio_map_and_relocalization(circle_bag, tmp_path):
    """--bag --engine lio --save-map writes GlobalMap.pcd; --load-map with a
    seed 0.22 m off relocalizes the first sweep onto the saved map."""
    maps = str(tmp_path / "maps")
    base = ["--bag", circle_bag, "--engine", "lio", "--device", "cpu"]
    first = run_slam.run(base + ["--save-map", maps])["est"][0]
    assert len(read_pcd(os.path.join(maps, "GlobalMap.pcd"))) > 1000
    run = run_slam.run(base + ["--load-map", maps, "--init-pose", "0.2,-0.1,0,2",
                               "--max-scans", "2"])
    assert run["rc"] == 0 and np.linalg.norm(run["est"][0] - first) < 0.05


def test_runner_refuses_what_it_cannot_run():
    """No silent fallback: a cuda run without a card raises, an IMU engine on
    KITTI is a usage error (--viz without matplotlib:
    tests/test_torch_visualize.py)."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            run_slam.main(["--sim", "--frames", "1"])
    with pytest.raises(SystemExit):
        run_slam.main(["--kitti", "x", "--engine", "lio", "--device", "cpu"])
