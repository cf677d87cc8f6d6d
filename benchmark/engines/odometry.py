"""The adapter of the odometry and mapping engine
(agi_lidar_slam_torch.runtime.pipeline: A-LOAM, LeGO-LOAM and the other
`PipelineConfig` presets) and of its plain reference (benchmark/reference/,
a frozen copy of the scan body that imports nothing of the program).

Calls a traffic's feed may name:
  chunk  process_scan_chunk: `chunk` sweeps a call, one CUDA graph of their
         scan bodies on the card (captured at the first call)
  scan   process_scan: one sweep a call, eagerly; the map's claim rounds
         read the host and stop when nothing is left to claim
"""

from __future__ import annotations

import dataclasses
import importlib

import torch

from benchmark import caps, check
from benchmark.reference import config as rconfig
from benchmark.reference import pipeline as rpipe
from benchmark.reference.cloud import ScanGrid as RScanGrid
from benchmark.reference.curvature import extract_features_timed
from benchmark.reference.hash_map import EMPTY_KEY
from benchmark.reference.se3 import Pose as RPose

CALLS = {"chunk": "process_scan_chunk", "scan": "process_scan"}
# the call the staged pass drives sweep by sweep
STAGED_CALL = "scan"
# the calls captured into a CUDA graph, each with the program's test of
# whether a map insert is being captured (module:function, called with a
# tensor): the staged pass holds it true, so that its eager claim rounds run
# to their bound as the graph's do
CAPTURE_FLAGS = {"chunk": "agi_lidar_slam_torch.map.hash_map:_capturing"}
SAME_M = 1e-3  # state entries on both sides whose points lie farther apart are mismatched


def program(config: dict):
    """(the engine module, its config from the preset constructor); raises
    where the constructor no longer gives the configuration file's values."""
    engine = importlib.import_module(config["engine"])
    mod, fn = config["preset"].split(":")
    cfg = getattr(importlib.import_module(mod), fn)()
    if dataclasses.asdict(cfg) != config["pipeline"]:
        raise ValueError(f"{config['preset']} no longer gives the values of "
                         f"configuration {config['name']!r}")
    return engine, cfg


def initial_state(engine, cfg, lap, device):
    """An engine with empty maps, moving at the lap's speed into its first sweep."""
    state = engine.init_state(cfg, device)
    return state._replace(pose=state.pose._replace(q=lap.start.q.clone(), t=lap.start.t.clone()),
                          prev_pose=state.prev_pose._replace(q=lap.before_start.q.clone(),
                                                             t=lap.before_start.t.clone()))


def inputs(engine, lap, start: int, n: int, call: str):
    """The sweeps start .. start + n - 1 of the lap, as `call` takes them."""
    if call == "scan":
        if n != 1:
            raise ValueError(f"the scan call takes one sweep, not {n}")
        return engine.ScanGrid(lap.xyz[start], lap.mask[start], lap.time[start])
    return engine.ScanGrid(lap.xyz[start:start + n], lap.mask[start:start + n],
                           lap.time[start:start + n])


def poses(result):
    """(q (n, 4), t (n, 3)) of a call's result."""
    return result.pose.q.reshape(-1, 4), result.pose.t.reshape(-1, 3)


def reference_config(d: dict) -> rconfig.PipelineConfig:
    """The reference's PipelineConfig from a configuration file's `pipeline`."""
    kw = {}
    for f in dataclasses.fields(rconfig.PipelineConfig):
        v = d[f.name]
        default = getattr(rconfig.PipelineConfig, f.name, None)
        kw[f.name] = type(default)(**v) if dataclasses.is_dataclass(default) else v
    return rconfig.PipelineConfig(**kw)


def state_gaps(p, r) -> tuple[int, int]:
    """(entries on one side only or more than SAME_M apart, the reference's
    entries) of two states: map sub-voxels and block keys, the previous
    scan's features, the scan counter. A map sub-voxel keeps the first point
    that lands in it, so where an earlier difference changes which point
    comes first, the kept point moves by up to the sub-voxel's size: the
    largest coordinate gap of a map swings between sound runs by its nature
    and is not compared; an entry whose point moved farther than SAME_M
    counts as mismatched instead."""
    bad, total = 0, 0
    for mp, mr in ((p.corner_map, r.corner_map), (p.surf_map, r.surf_map)):
        same = torch.all(mp.keys == mr.keys, dim=-1)[:, None]
        moved = torch.linalg.vector_norm(mp.points - mr.points, dim=-1) > SAME_M
        bad += int(((mp.occ != mr.occ) | ((mp.occ | mr.occ) & (~same | moved))).sum())
        bad += int((~same).sum())
        total += int(mr.occ.sum()) + int((mr.keys[:, 0] != EMPTY_KEY).sum())
    for fp, fr in ((p.prev_corners, r.prev_corners), (p.prev_surfs, r.prev_surfs)):
        total += int(fr.mask.sum())
        if fp.mask.shape != fr.mask.shape:  # a batch of another size: nothing matches
            bad += max(int(fp.mask.sum()), int(fr.mask.sum()), 1)
            continue
        moved = torch.linalg.vector_norm(fp.xyz - fr.xyz, dim=-1) > SAME_M
        bad += int(((fp.mask != fr.mask) | (fp.mask & moved)).sum())
    if not torch.equal(p.frame, r.frame):
        bad += max(total, 1)
    return bad, total


class Checker(check.Worst):
    """The reference's config and the worst numbers over the calls checked
    so far."""

    REF_CALLS = {"chunk": rpipe.process_scan_chunk, "scan": rpipe.process_scan}

    def __init__(self, config: dict, device):
        super().__init__()
        self.cfg = reference_config(config["pipeline"])
        self.template = rpipe.init_state(self.cfg, device)

    def initial_state(self, lap):
        """The reference's own initial state, moving at the lap's speed."""
        return self.template._replace(pose=RPose(lap.start.q.clone(), lap.start.t.clone()),
                                      prev_pose=RPose(lap.before_start.q.clone(),
                                                      lap.before_start.t.clone()))

    def as_reference(self, state):
        """A program state as the reference's."""
        return check.relayout(state, self.template)

    def step(self, state, lap, start: int, n: int, program_poses, state_out):
        """Run the reference over sweeps start .. start + n - 1 from `state`
        (a reference state), hold the program's poses of them (q, t) and its
        state after them (where not None) to the reference's; returns the
        reference's state after them."""
        scans = RScanGrid(lap.xyz[start:start + n], lap.mask[start:start + n],
                          lap.time[start:start + n])
        ref_state, ref = rpipe.process_scan_chunk(state, scans, self.cfg)
        dt, da = check.pose_gaps(program_poses[0], program_poses[1], ref.pose.q, ref.pose.t)
        self.hold("pose_gap_m", dt)
        self.hold("rot_gap_rad", da)
        if state_out is not None:
            bad, total = state_gaps(self.as_reference(state_out), ref_state)
            self.hold("state_mismatch", bad / max(total, 1))
        return ref_state

    def control(self, call: str):
        """`call` of the program, done by the reference with its float32
        matrix products in TF32 (the configuration: float32, TF32 off)."""
        fn = self.REF_CALLS[call]

        def step(state, scans, cfg):
            before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
            try:
                return fn(self.as_reference(state), RScanGrid(*scans), self.cfg)
            finally:
                torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before
        return step


def capacities(config: dict, lap, every: int = 8) -> dict:
    """How often the configuration's feature capacities bind on the lap's
    sweeps, worked out with the reference: {stage: (capacity, [occupied
    voxels of each sweep])} over every `every`-th sweep. The scan body keeps
    at most `features.max_surfs` voxels of the surf candidates at
    `features.surf_voxel`, then downsamples the corners at `corner_ds_voxel`
    into `features.max_corners` voxels and the surfs at `surf_ds_voxel` into
    `features.max_surfs`; a voxel past a capacity is dropped. Each count is
    the number of occupied voxels before the cap."""
    cfg = reference_config(config["pipeline"])
    f = cfg.features
    R, W = lap.xyz.shape[1:3]
    wide = dataclasses.replace(f, max_surfs=R * W)
    out = {"surfs at surf_voxel": (f.max_surfs, []),
           "corners at corner_ds_voxel": (f.max_corners, []),
           "surfs at surf_ds_voxel": (f.max_surfs, [])}
    for j in range(0, lap.n, every):
        feats = extract_features_timed(RScanGrid(lap.xyz[j], lap.mask[j], lap.time[j]), wide)
        s = feats.surfs
        out["surfs at surf_voxel"][1].append(int(s.mask.sum()))
        out["corners at corner_ds_voxel"][1].append(
            caps.occupied(feats.corners.xyz, feats.corners.mask, cfg.corner_ds_voxel))
        # the capped output is the first max_surfs voxels in key order
        out["surfs at surf_ds_voxel"][1].append(
            caps.occupied(s.xyz[:f.max_surfs], s.mask[:f.max_surfs], cfg.surf_ds_voxel))
    return out
