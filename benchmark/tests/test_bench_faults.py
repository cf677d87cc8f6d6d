"""Sound runs come out correct and broken ones not: the rest of a run
(traffic, warm-up, window, check) driven on the CPU at a small size, with the
program's call broken underneath, through the odometry adapter. The cells
run on one chip, so there is no exchange between chips to leave out."""

import pytest
import torch

from benchmark import harness

SENSOR = {"rings": 16, "width": 120}
# a cell, or a cell and the call its feed names in its place ("cell:call"):
# `aloam_hdl64.live1:scan` feeds live1's sweeps through `process_scan`
CELLS = ["aloam_hdl64.replay4", "lego_vlp16.replay4", "aloam_hdl64.live1",
         "aloam_hdl64.live1:scan"]


# each fault breaks the program's call that the cell's feed names (the chunk
# graph's `process_scan_chunk`, or `process_scan` one sweep a call)
def unchanged_state(call):
    def step(state, scans, cfg):
        _, res = call(state, scans, cfg)
        return state, res
    return step


def half_the_points(call):
    def step(state, scans, cfg):
        mask = scans.mask.clone()
        mask[..., 1::2] = False
        return call(state, scans._replace(mask=mask), cfg)
    return step


def pose_altered(call):
    def step(state, scans, cfg):
        new_state, res = call(state, scans, cfg)
        return new_state, res._replace(pose=res.pose._replace(t=res.pose.t + 0.01))
    return step


def _cell(spec):
    name, _, call = spec.partition(":")
    cell = harness.load_cell(name)
    C = cell.traffic["feed"]["chunk"]
    scene = dict(cell.traffic["scene"], warmup_scans=C)
    feed = dict(cell.traffic["feed"], call=call or cell.traffic["feed"]["call"])
    return cell._replace(traffic=dict(cell.traffic, scene=scene, feed=feed),
                         workload=dict(cell.workload, check={"own_start_scans": 2 * C,
                                                             "samples": 2}))


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [None, unchanged_state, half_the_points, pose_altered],
                         ids=["sound", "unchanged_state", "half_the_points", "pose_altered"])
def test_fault_makes_the_run_incorrect(cell, fault, monkeypatch):
    torch.set_num_threads(2)
    monkeypatch.setattr(harness, "PRELOAD_S", 0.0)
    c = _cell(cell)
    adapter = harness.load_adapter(c)
    engine, _ = adapter.program(c.config)
    call = getattr(engine, adapter.CALLS[c.traffic["feed"]["call"]])
    out = harness.run(c, 2**31 + 11, 1.0, False, "cpu", 0.0,
                      step=fault(call) if fault else None,
                      sensor=dict(c.config["sensor"], **SENSOR))
    assert out["attempted"] > 0
    assert out["correct"] is (fault is None)
