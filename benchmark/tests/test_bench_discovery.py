"""A later change adds a configuration, a cell and a per-layer metric by
adding files and entries: the harness finds them by name, and no file that
was there is edited."""

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


def test_new_config_cell_and_metric_are_found_by_name(tmp_path, monkeypatch):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache", "_out"))
    before = _digests(tmp_path)
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
