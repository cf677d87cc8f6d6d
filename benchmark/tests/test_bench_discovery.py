"""A later change adds a configuration, a cell and a per-layer metric, or
another engine with its adapter and IMU traffic, by adding files and
entries: the harness finds them by name, and no file that was there is
edited."""

import hashlib
import json
import shutil
from pathlib import Path

import torch

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]


def _digests(root: Path) -> dict:
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "benchmark").rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def _copy(tmp_path: Path) -> dict:
    """The benchmark copied into tmp_path; the digests of its files."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache", "_out"))
    return _digests(tmp_path)


def test_new_config_cell_and_metric_are_found_by_name(tmp_path, monkeypatch):
    before = _copy(tmp_path)
    b = tmp_path / "benchmark"
    cfg = json.loads((b / "configs" / "lego_vlp16.json").read_text())
    cfg.update(name="lego_vlp16_small", sensor=dict(cfg["sensor"], rings=16, width=120))
    (b / "configs" / "lego_vlp16_small.json").write_text(json.dumps(cfg))
    traffic = json.loads((b / "traffic" / "robot_circle.replay4.json").read_text())
    traffic["scene"]["warmup_scans"] = 4
    (b / "traffic" / "robot_circle.short.json").write_text(json.dumps(traffic))
    (b / "workloads" / "lego_vlp16_small.short.json").write_text(json.dumps({
        "config": "lego_vlp16_small", "traffic": "robot_circle.short",
        "check": {"own_start_scans": 8, "samples": 1}, "trace": {"chunks": 2, "staged_scans": 1},
        "limits": json.loads((b / "workloads" / "lego_vlp16.replay4.json").read_text())["limits"]}))
    (b / "metrics" / "chunk_calls.py").write_text(
        "def read(tr):\n    return float(len(tr.call_ms)) if tr.call_ms else None\n")
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "lego_vlp16_small", "source": "a test",
                            "file": "benchmark/configs/lego_vlp16_small.json", "reduced": [],
                            "why": "a test"})
    spec["workloads"].append({"name": "lego_vlp16_small.short", "config": "lego_vlp16_small",
                              "traffic": "robot_circle.short", "chips": 1, "why": "a test"})
    spec["per_layer"].append({"name": "chunk_calls", "unit": "calls", "better": "higher",
                              "source": "host_clock", "layer": "chunk graph",
                              "moves": "scans_per_s", "workloads": ["lego_vlp16_small.short"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    cell = harness.load_cell("lego_vlp16_small.short", root=tmp_path)
    assert cell.config["sensor"]["width"] == 120 and cell.traffic["scene"]["warmup_scans"] == 4
    assert "chunk_calls" in [m["name"] for m in cell.per_layer]
    assert "octant_knn_roofline" not in [m["name"] for m in cell.per_layer]
    torch.set_num_threads(2)
    monkeypatch.setattr(harness, "PRELOAD_S", 0.0)
    out = harness.run(cell, 3, 1.0, True, "cpu", 0.0)
    assert out["correct"] and out["metrics"]["chunk_calls"]["value"] >= 1
    assert list(out)[-1] == "checks"
    after = _digests(tmp_path)
    assert all(after[k] == v for k, v in before.items())


# an engine that the benchmark has no adapter for: each call takes one
# sweep's IMU samples and a position fix, and returns the sweep's pose, its
# rotation the last one's turned by the gyroscope's readings
STUB_ADAPTER = '''
from typing import NamedTuple

import torch

from benchmark import check
from benchmark.reference import so3

CALLS = {"sweep": "step"}
STAGED_CALL = "sweep"
CAPTURE_FLAGS = {}
SEEN = []  # the IMU samples of each sweep the engine was handed


class State(NamedTuple):
    q: torch.Tensor
    t: torch.Tensor
    frame: torch.Tensor


class Result(NamedTuple):
    q: torch.Tensor
    t: torch.Tensor


class Engine:
    @staticmethod
    def step(state, sweep, cfg):
        gyro, h, fix = sweep
        SEEN.append(int(gyro.shape[0]))
        q = so3.quat_mul(state.q, so3.quat_exp(gyro.sum(0) * h))
        return State(q, fix, state.frame + 1), Result(q, fix)


def program(config):
    return Engine(), None


def initial_state(engine, cfg, lap, device):
    return State(lap.start.q.clone(), lap.start.t.clone(),
                 torch.zeros((), dtype=torch.int32, device=device))


def inputs(engine, lap, start, n, call):
    lo, hi = lap.imu.ranges[start].tolist()
    return lap.imu.gyro[lo:hi], imu_period(lap), lap.gt.t[start % lap.n]


def imu_period(lap):
    return float(lap.imu.t[1] - lap.imu.t[0])


def poses(result):
    return result.q.reshape(-1, 4), result.t.reshape(-1, 3)


class Checker(check.Worst):
    """The reference: the same turns in float64, from the lap's poses."""

    dtype = torch.float64

    def __init__(self, config, device):
        super().__init__()

    def initial_state(self, lap):
        return self.as_reference(State(lap.start.q, lap.start.t,
                                       torch.zeros((), dtype=torch.int32)))

    def as_reference(self, state):
        return State(state.q.to(self.dtype), state.t.to(self.dtype), state.frame.clone())

    def step(self, state, lap, start, n, program_poses, state_out):
        h = imu_period(lap)
        qs, ts = [], []
        for j in range(start, start + n):
            lo, hi = lap.imu.ranges[j].tolist()
            w = lap.imu.gyro[lo:hi].to(self.dtype).sum(0) * h
            state = State(so3.quat_mul(state.q, so3.quat_exp(w)),
                          lap.gt.t[j % lap.n].to(self.dtype), state.frame + 1)
            qs.append(state.q)
            ts.append(state.t)
        dt, da = check.pose_gaps(program_poses[0], program_poses[1], torch.stack(qs),
                                 torch.stack(ts))
        self.hold("pose_gap_m", dt)
        self.hold("rot_gap_rad", da)
        if state_out is not None:
            self.hold("state_mismatch", float(not torch.equal(state_out.frame, state.frame)))
        return state
'''


def test_engine_with_imu_traffic_is_new_files_only(tmp_path, monkeypatch):
    before = _copy(tmp_path)
    repo = _digests(ROOT)
    b = tmp_path / "benchmark"
    (b / "engines" / "stub_imu.py").write_text(STUB_ADAPTER)
    sensor = dict(json.loads((b / "configs" / "aloam_hdl64.json").read_text())["sensor"],
                  rings=2, width=8)
    (b / "configs" / "stub_imu.json").write_text(json.dumps(
        {"name": "stub_imu", "adapter": "stub_imu", "sensor": sensor}))
    traffic = json.loads((b / "traffic" / "urban_lap.live1.json").read_text())
    traffic["scene"]["imu"] = {"rate_hz": 200.0, "gyro_noise": 0.002, "acc_noise": 0.02,
                               "gyro_bias": 0.001, "acc_bias": 0.05, "gravity": 9.81}
    traffic["scene"]["warmup_scans"] = 4
    traffic["feed"] = {"chunk": 1, "ahead": 0, "call": "sweep"}
    (b / "traffic" / "urban_lap.imu200.json").write_text(json.dumps(traffic))
    (b / "workloads" / "stub_imu.sweep.json").write_text(json.dumps({
        "config": "stub_imu", "traffic": "urban_lap.imu200",
        "check": {"own_start_scans": 8, "samples": 2}, "trace": {"chunks": 2, "staged_scans": 1},
        "limits": {"pose_gap_m": 0.001, "rot_gap_rad": 5e-05, "state_mismatch": 0.0}}))
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "stub_imu", "source": "a test",
                            "file": "benchmark/configs/stub_imu.json", "reduced": [],
                            "why": "a test"})
    spec["workloads"].append({"name": "stub_imu.sweep", "config": "stub_imu",
                              "traffic": "urban_lap.imu200", "chips": 1, "why": "a test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    cell = harness.load_cell("stub_imu.sweep", root=tmp_path)
    adapter = harness.load_adapter(cell)
    monkeypatch.setattr(harness, "PRELOAD_S", 0.0)
    out = harness.run(cell, 2**31 + 5, 0.5, False, "cpu", 0.0)
    assert out["correct"] and out["attempted"] > 8
    assert out["attempted"] == len(adapter.SEEN) - 8  # warm-up and own start before the window
    assert all(19 <= m <= 21 for m in adapter.SEEN)
    # the engine's pose is its own: a gyroscope read wrong is not correct
    wrong = adapter.Engine.step

    def step(state, sweep, cfg):
        gyro, h, fix = sweep
        return wrong(state, (gyro * 1.01, h, fix), cfg)
    assert not harness.run(cell, 2**31 + 5, 0.5, False, "cpu", 0.0, step=step)["correct"]
    after = _digests(tmp_path)
    assert all(after[k] == v == repo[k] for k, v in before.items())
