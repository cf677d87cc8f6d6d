"""The run's guards: no module of JAX or the JAX package may be loaded when
the result is printed, and a run without a card measures nothing."""

import json
import os
import shutil
import subprocess
import sys
import types
from pathlib import Path

import pytest

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]
CELL = ["--workload", "aloam_hdl64.replay4", "--seed", "3000000001", "--seconds", "1",
        "--trace", "0"]


@pytest.mark.parametrize("name", ["jax", "jax.numpy", "jaxlib", "flax.linen",
                                  "agi_lidar_slam_tpu", "agi_lidar_slam_tpu.runtime"])
def test_forbidden_module_is_caught(monkeypatch, name):
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert harness.forbidden_modules() == [name.split(".")[0]]


def test_the_port_and_lookalikes_are_not_jax(monkeypatch):
    import agi_lidar_slam_torch  # noqa: F401

    for name in ("jaxtyping", "agi_lidar_slam_tpu_extras", "my.jax"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert "agi_lidar_slam_torch" in sys.modules
    assert harness.forbidden_modules() == []


def test_run_with_jax_loaded_prints_no_result(monkeypatch, capsys):
    fake = {"correct": True, "attempted": 1, "failed": 0, "metrics": {}, "device": {},
            "checks": {}}
    monkeypatch.setattr(harness.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(harness.torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(harness, "run", lambda *a, **kw: fake)
    monkeypatch.setattr(harness.torch, "set_num_threads", lambda n: None)
    assert harness.main(CELL) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == fake
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert harness.main(CELL) != 0
    captured = capsys.readouterr()
    assert captured.out == "" and "jax" in captured.err


def _run(cwd: Path, env_extra: dict) -> subprocess.CompletedProcess:
    env = dict(os.environ, **env_extra)
    return subprocess.run([sys.executable, "benchmark/run.py", *CELL], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_no_card_exits_nonzero_with_no_result():
    out = _run(ROOT, {"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "no CUDA card" in out.stderr


def test_benchmark_alone_exits_nonzero(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache", "_out"))
    out = _run(tmp_path, {"CUDA_VISIBLE_DEVICES": "", "PYTHONPATH": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""
