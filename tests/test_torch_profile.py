"""The port's stage profiler (agi_lidar_slam_torch/tools/profile_engines.py)
on the CPU: its staged step is the engine step, its roofline arithmetic, and
its command line. No JAX reference here: the engines themselves are held to
the JAX package by the other port test files; this file holds the profiler
to the port's own engine steps. Tiny scans (16 rings x 180 columns) and one
rep: the CPU gives host-clock times only, so nothing here is a device
number."""

import json

import numpy as np
import pytest
import torch

from agi_lidar_slam_torch.config import preset_aloam_kitti64
from agi_lidar_slam_torch.map.hash_map import (block_coords, empty_map, hash_packed, insert,
                                               map_rows, pack_key)
from agi_lidar_slam_torch.map.planar import build_ktab
from agi_lidar_slam_torch.tools import profile_engines as pe
from tests._torch_threads import torch_one_thread  # noqa: F401 (autouse)

CPU = torch.device("cpu")
RINGS, WIDTH, WARM = 16, 180, 2

# each engine's top-level stages, under the JAX tools' names (odom's preset
# has no odometry stage)
TOP = {"odom": {"features", "downsample", "solve_scan2map", "deskew", "insert corners",
                "insert surfs", "bound_map"},
       "lio": {"imu_propagate", "undistort+downsample", "ieskf_update", "map_insert+bound"},
       "livox": {"preprocess", "preint", "solve", "marg", "mapins"}}


@pytest.fixture(autouse=True)
def small_scans(monkeypatch):
    """The profiler's 64x1800 scans, narrowed for the CPU."""
    monkeypatch.setattr(pe, "RINGS", RINGS)
    monkeypatch.setattr(pe, "WIDTH", WIDTH)


@pytest.fixture(scope="module")
def inputs():
    return pe.Inputs(CPU, WARM)


@pytest.mark.parametrize("name", sorted(TOP))
def test_staged_step_is_the_engine_step(inputs, name):
    """The staged step (the engine step with its stages wrapped) gives the
    plain step's pose bit for bit, with every top-level stage called; a
    stage called inside another belongs to it (odom's deskew is the body's
    two calls, not the solver's)."""
    eng = inputs.engine(name)
    ref = eng.step()
    stages = pe.Stages("time", cuda=False)
    got = eng.staged(stages)
    stages.end_step()
    assert pe._equal(ref, got) and pe._pose_gap(ref, got) == 0.0
    assert set(stages.values) == TOP[name]
    assert all(v[0] >= 0.0 for v in stages.values.values())
    if name == "odom":
        assert stages.calls["deskew"] == 2 and stages.calls["solve_scan2map"] == 1
    # the module's functions are restored after the staged step
    assert pe.pipeline.extract_features_timed.__name__ == "extract_features_timed"


def test_knn_bytes_by_hand():
    """knn_work at the odometry's corner shape (2048 queries against the
    corner map's rows, k = 5) against a count by hand: every distinct probe
    window entry of the live queries' octant blocks, every distinct row
    whose key matches, the queries, mask and outputs, and 8 flops per
    candidate of each matched row."""
    cfg = preset_aloam_kitti64()
    mcfg, k = cfg.corner_map, cfg.solver.k_neighbors
    rng = np.random.default_rng(0)
    pts = rng.uniform([-20, -20, -2], [20, 20, 4], (6000, 3)).astype(np.float32)
    m = insert(empty_map(mcfg, CPU), torch.from_numpy(pts), torch.ones(6000, dtype=torch.bool),
               mcfg)
    nq = cfg.features.max_corners
    q = torch.from_numpy(rng.uniform([-25, -25, -3], [25, 25, 5], (nq, 3)).astype(np.float32))
    qm = torch.from_numpy(rng.uniform(size=nq) > 0.3)
    ktab = build_ktab(m)
    assert (nq, m.n_rows) == (2048, map_rows(mcfg))

    bc, _ = block_coords(q, mcfg)
    frac = q / mcfg.block_size - bc.float()
    sign = torch.where(frac >= 0.5, 1, -1).to(torch.int32)
    octs = torch.tensor([[(o >> 2) & 1, (o >> 1) & 1, o & 1] for o in range(8)],
                        dtype=torch.int32)
    keys = pack_key(bc[:, None, :] + octs[None] * sign[:, None, :])
    base = hash_packed(keys, mcfg.log2_slots).numpy()
    keys, kt, live = keys.numpy(), ktab.numpy(), qm.numpy()
    windows, rows, matches = set(), set(), 0
    for i in np.flatnonzero(live):
        for o in range(8):
            for p in range(mcfg.probes):
                w = int(base[i, o]) + p
                windows.add(w)
                if kt[w] == keys[i, o]:
                    rows.add(w)
                    matches += 1
    B = m.bucket
    by_hand = nq * 12 + nq + 4 * len(windows) + len(rows) * B * 13 + nq * k * 17
    assert pe.knn_work(m, q, qm, k, mcfg, ktab) == (by_hand, 8 * matches * B)
    ms, by = pe.knn_bound(m, q, qm, k, mcfg, ktab)
    assert by == "bytes" and ms == pytest.approx(by_hand / pe.HBM_BYTES_PER_S * 1e3)


def test_share_above_limit_raises():
    assert pe.share(1.0, 1.0, "x") == 1.0
    assert pe.share(None, 1.0, "x") is None
    with pytest.raises(ValueError, match="share"):
        pe.share(1.06, 1.0, "a kernel")


def test_cpu_rows_hold_no_device_number():
    """The kernels section on the CPU: bytes, flops and the card's bound are
    counted; every time and share is null."""
    rows = pe.eig_rows(CPU, cuda=False) + pe.probe_rows(CPU, cuda=False)
    assert [r["kernel"] for r in rows] == ["sym_eig", "sym_eig", "scale2", "row_gather_sum"]
    assert rows[1]["bytes"] == 4096 * (2 * 36 + 6) * 4 and rows[1]["flops"] == 4096 * 9 * 216
    for r in rows:
        assert r["bound_ms"] > 0 and r["bound_by"] in ("bytes", "operations")
        assert all(r[f] is None for f in ("ms", "share", "plain_ms", "library_ms"))


class _Event:
    """A raw profiler event as launch_record reads it."""

    def __init__(self, name, start, end, corr, device=torch.autograd.DeviceType.CPU):
        self._v = (name, start, end, corr, device)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def correlation_id(self):
        return self._v[3]

    def device_type(self):
        return self._v[4]

    def is_user_annotation(self):
        return False


def test_launch_record_links_launches_to_kernels():
    """Each launch call counts once, runtime or driver; a graph launch is
    one launch for all its kernels; a launch no recorded kernel carries the
    id of is unlinked; copies add device time, not launches."""
    gpu = torch.autograd.DeviceType.CUDA
    events = [_Event("aten::add", 0, 900, 9),
              _Event("cudaLaunchKernel", 100, 110, 1), _Event("k1", 200, 300, 1, gpu),
              _Event("cuLaunchKernel", 120, 130, 2), _Event("k2", 300, 350, 2, gpu),
              _Event("cudaGraphLaunch", 140, 150, 3), _Event("g1", 400, 500, 3, gpu),
              _Event("g2", 500, 600, 3, gpu),
              _Event("cudaLaunchKernel", 160, 170, 4),
              _Event("cudaMemcpyAsync", 180, 190, 5), _Event("Memcpy DtoH", 600, 700, 5, gpu)]
    rec = pe.launch_record(events)
    assert rec["starts"] == [100, 120, 140, 160] and rec["launches"] == 4
    assert rec["unlinked"] == {"cudaLaunchKernel": 1}
    assert rec["device_ms"] == pytest.approx(450 / 1e6)


def test_cli_cpu_writes_the_schema(tmp_path):
    """--device cpu --scans 2 writes SOL_<tag>.json and .md with the JAX
    tool's top-level keys, host-clock times and null in every field only
    the card gives."""
    rc = pe.main(["--engine", "lio", "--device", "cpu", "--scans", "2", "--reps", "1",
                  "--out", str(tmp_path), "t"])
    assert rc == 0
    payload = json.loads((tmp_path / "SOL_t.json").read_text())
    assert {"engines_ms_per_scan", "kernel_rooflines", "engine_summary", "hw", "scan_scale",
            "timing"} <= set(payload)
    assert payload["timing"]["clock"] == "host clock (CPU)"
    assert payload["scan_scale"] == f"{RINGS}x{WIDTH}"
    assert payload["hw"]["device"] == "cpu" and payload["hw"]["name"] is None
    assert payload["hw"]["hbm_bytes_per_s"] == 3.35e12 and payload["hw"]["f32_flops"] == 67e12
    lio = payload["stages"]["lio"]
    assert set(lio) == {"full"} | TOP["lio"]
    assert all(v["ms"] > 0 and v["launches"] is None and v["syncs"] is None
               for v in lio.values())
    s = payload["engine_summary"]["lio"]
    assert s["busy_share"] is None and s["composition_gap"] == 0.0 and s["bounds_ms"] > 0
    assert payload["engines_ms_per_scan"]["lio"]["full"] == lio["full"]["ms"]
    assert "## lio" in (tmp_path / "SOL_t.md").read_text()


def test_cli_without_a_card_exits_nonzero(tmp_path, monkeypatch, capsys):
    """The default device is the card: with none, the command exits non-zero
    and writes nothing; there is no fallback to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert pe.main(["--engine", "lio", "--out", str(tmp_path)]) != 0
    assert "no CUDA device" in capsys.readouterr().err
    assert not list(tmp_path.iterdir())
