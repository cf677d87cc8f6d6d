"""Sound runs come out correct and broken ones not: the rest of a run
(traffic, warm-up, window, check) driven on the CPU at a small size, with the
program's chunk call broken underneath. The cells run on one chip, so there
is no exchange between chips to leave out."""

import pytest
import torch

from agi_lidar_slam_torch.runtime import pipeline
from benchmark import harness

SENSOR = {"rings": 16, "width": 120}


def unchanged_state(state, scans, cfg):
    _, res = pipeline.process_scan_chunk(state, scans, cfg)
    return state, res


def half_the_points(state, scans, cfg):
    mask = scans.mask.clone()
    mask[..., 1::2] = False
    return pipeline.process_scan_chunk(state, scans._replace(mask=mask), cfg)


def pose_altered(state, scans, cfg):
    new_state, res = pipeline.process_scan_chunk(state, scans, cfg)
    return new_state, res._replace(pose=res.pose._replace(t=res.pose.t + 0.01))


def _cell(name):
    cell = harness.load_cell(name)
    C = cell.traffic["feed"]["chunk"]
    scene = dict(cell.traffic["scene"], warmup_scans=C)
    return cell._replace(traffic=dict(cell.traffic, scene=scene),
                         workload=dict(cell.workload, check={"own_start_scans": 2 * C,
                                                             "samples": 2}))


@pytest.mark.parametrize("cell", ["aloam_hdl64.replay4", "lego_vlp16.replay4",
                                  "aloam_hdl64.live1"])
@pytest.mark.parametrize("fault", [None, unchanged_state, half_the_points, pose_altered],
                         ids=["sound", "unchanged_state", "half_the_points", "pose_altered"])
def test_fault_makes_the_run_incorrect(cell, fault, monkeypatch):
    torch.set_num_threads(2)
    monkeypatch.setattr(harness, "PRELOAD_S", 0.0)
    c = _cell(cell)
    out = harness.run(c, 2**31 + 11, 1.0, False, "cpu", 0.0, step=fault,
                      sensor=dict(c.config["sensor"], **SENSOR))
    assert out["attempted"] > 0
    assert out["correct"] is (fault is None)
