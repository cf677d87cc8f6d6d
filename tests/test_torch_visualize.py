"""The port's PNG renderer (agi_lidar_slam_torch/tools/visualize.py) against
the reference tool (tools/visualize.py), and the runner's --viz without
matplotlib.

On a tiny run's files (a 6-pose KITTI trajectory, a map directory with
two ASCII PCDs, 6 JSONL metric rows): the loaders return what the
reference's return, exactly; the three-panel figure is a non-empty PNG."""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest

from agi_lidar_slam_torch.io.checkpoint import export_pcd
from agi_lidar_slam_torch.tools import run_slam, visualize
from tests._torch_threads import torch_one_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reference_tool():
    spec = importlib.util.spec_from_file_location("reference_visualize",
                                                  os.path.join(ROOT, "tools", "visualize.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def run_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("viz")
    rng = np.random.default_rng(0)
    T = np.tile(np.eye(3, 4), (6, 1, 1))
    T[:, 0, 3] = np.arange(6) * 0.5
    T[:, 1, 3] = np.sin(np.arange(6) * 0.3)
    np.savetxt(d / "traj.txt", T.reshape(6, 12))
    os.makedirs(d / "maps")
    export_pcd(str(d / "maps" / "CornerMap.pcd"), rng.uniform(-5, 5, (50, 3)))
    export_pcd(str(d / "maps" / "SurfMap.pcd"), rng.uniform(-5, 5, (200, 3)))
    with open(d / "run.jsonl", "w") as f:
        for i in range(6):
            f.write(json.dumps({"frame": i, "wall_ms": 40.0 + i, "rms": 0.02 + 0.001 * i,
                                "n_corner": 100, "n_surf": 800}) + "\n")
    return d


def test_loaders_match_reference(run_files):
    ref = _reference_tool()
    d = run_files
    np.testing.assert_array_equal(visualize.load_kitti_traj(str(d / "traj.txt")),
                                  ref.load_kitti_traj(str(d / "traj.txt")))
    for path in (d / "maps", d / "maps" / "SurfMap.pcd"):
        np.testing.assert_array_equal(visualize.load_map_points(str(path)),
                                      ref.load_map_points(str(path)))
    # the subsample of a map above max_pts takes the same points
    np.testing.assert_array_equal(visualize.load_map_points(str(d / "maps"), max_pts=64),
                                  ref.load_map_points(str(d / "maps"), max_pts=64))
    assert visualize.load_metrics(str(d / "run.jsonl")) == ref.load_metrics(str(d / "run.jsonl"))


def test_render_writes_png(run_files, tmp_path):
    out = tmp_path / "run.png"
    rc = visualize.main(["--traj", str(run_files / "traj.txt"), "--gt",
                         str(run_files / "traj.txt"), "--map", str(run_files / "maps"),
                         "--metrics", str(run_files / "run.jsonl"), "--out", str(out)])
    assert rc == 0
    with open(out, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    assert os.path.getsize(out) > 10_000
    assert visualize.main(["--out", str(tmp_path / "none.png")]) == 2  # nothing to draw
    assert not (tmp_path / "none.png").exists()


def test_runner_viz_without_matplotlib_raises(monkeypatch, tmp_path):
    """Where matplotlib is missing, --viz raises an ImportError that names it,
    before the run starts."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # `import matplotlib` now raises
    with pytest.raises(ImportError, match="matplotlib"):
        run_slam.run(["--sim", "--frames", "1", "--device", "cpu", "--viz",
                      str(tmp_path / "run.png")])
    assert not (tmp_path / "run.png").exists()
