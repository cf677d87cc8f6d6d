"""The comparison that decides `correct`: the program's poses and carried
state against the plain reference (benchmark/reference/), on the scans the
benchmark handed the program.

The reference cannot run a whole window in the window's time (it is eager
and reads the host at every eigendecomposition and claim round), so it
follows the program step by step: for each sampled chunk it starts from the
program's own state as handed into that chunk and runs the same scans. The
start, which that skips, is checked by itself: from its own initial state,
made from the traffic's start poses, the reference runs the run's first
chunks in turn (the warm-up and the chunks after it, up to the workload's
`own_start_scans`), carrying its own state from chunk to chunk, and is held
to the program's poses of each and to its state after each warm-up chunk and
after the last.

Numbers compared (the worst over every checked chunk):
  pose_gap_m      largest distance between a program pose and the reference's
  rot_gap_rad     largest angle between a program rotation and the reference's
  state_mismatch  entries of the carried state (map sub-voxels and block
                  keys, the previous scan's features, the scan counter) on
                  one side and not the other, or on both more than SAME_M
                  apart, over the reference's entries

A map sub-voxel keeps the first point that lands in it, so where an earlier
difference changes which point comes first, the kept point moves by up to
the sub-voxel's size: the largest coordinate gap of a map swings between
sound runs by its nature and is not compared. An entry whose point moved
farther than SAME_M counts as a mismatched entry instead.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch.utils import _pytree as pytree

from benchmark.reference import config as rconfig
from benchmark.reference import pipeline as rpipe
from benchmark.reference import se3 as rse3
from benchmark.reference.cloud import ScanGrid as RScanGrid
from benchmark.reference.hash_map import EMPTY_KEY

NUMBERS = ("pose_gap_m", "rot_gap_rad", "state_mismatch")
SAME_M = 1e-3  # entries on both sides whose points lie farther apart are mismatched


def reference_config(d: dict) -> rconfig.PipelineConfig:
    """The reference's PipelineConfig from a configuration file's `pipeline`."""
    kw = {}
    for f in dataclasses.fields(rconfig.PipelineConfig):
        v = d[f.name]
        default = getattr(rconfig.PipelineConfig, f.name, None)
        kw[f.name] = type(default)(**v) if dataclasses.is_dataclass(default) else v
    return rconfig.PipelineConfig(**kw)


def as_reference(tree, template):
    """A program state as the reference's state of the same layout (the
    same tensors, the reference's types); raises where the layouts differ."""
    leaves = pytree.tree_flatten(tree)[0]
    tleaves, spec = pytree.tree_flatten(template)
    if len(leaves) != len(tleaves) or any(a.dtype != b.dtype or a.dim() != b.dim()
                                          for a, b in zip(leaves, tleaves)):
        raise ValueError("the program's state no longer has the reference's layout")
    return pytree.tree_unflatten(leaves, spec)


def pose_gaps(q_p, t_p, q_r, t_r) -> tuple[float, float]:
    """(largest translation gap, largest rotation angle) between poses."""
    dt = torch.linalg.vector_norm(t_p.double() - t_r.double(), dim=-1)
    qp, qr = q_p.double(), q_r.double()
    w = torch.sum(qp * qr, dim=-1)  # scalar part of conj(q_r) * q_p
    v = (qr[..., :1] * qp[..., 1:] - qp[..., :1] * qr[..., 1:]
         - torch.linalg.cross(qr[..., 1:], qp[..., 1:]))
    ang = 2.0 * torch.atan2(torch.linalg.vector_norm(v, dim=-1), torch.abs(w))
    return _max(dt), _max(ang)


def _max(x: torch.Tensor) -> float:
    """Largest entry, NaN where any is NaN, 0 where empty."""
    if x.numel() == 0:
        return 0.0
    if torch.isnan(x).any():
        return math.nan
    return float(x.max())


def state_gaps(p, r) -> tuple[int, int]:
    """(entries on one side only or more than SAME_M apart, the reference's
    entries) of two states."""
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


class Checker:
    """Holds the reference's config and the worst numbers over the chunks
    checked so far."""

    def __init__(self, pipeline: dict, device):
        self.cfg = reference_config(pipeline)
        self.template = rpipe.init_state(self.cfg, device)
        self.worst = dict.fromkeys(NUMBERS, 0.0)
        self.chunks = 0

    def initial_state(self, start: rse3.Pose, before_start: rse3.Pose):
        """The reference's own initial state, moving at the lap's speed."""
        return self.template._replace(pose=start, prev_pose=before_start)

    def chunk(self, state, scans: RScanGrid, poses, state_out):
        """Run the reference over one chunk from `state` (a reference state),
        hold the program's poses (q, t of the chunk's scans) and its state
        after it (where not None) to the reference's; returns the
        reference's state after it."""
        ref_state, ref = rpipe.process_scan_chunk(state, scans, self.cfg)
        dt, da = pose_gaps(poses[0], poses[1], ref.pose.q, ref.pose.t)
        found = [("pose_gap_m", dt), ("rot_gap_rad", da)]
        if state_out is not None:
            bad, total = state_gaps(as_reference(state_out, self.template), ref_state)
            found.append(("state_mismatch", bad / max(total, 1)))
        for key, v in found:
            self.worst[key] = v if math.isnan(v) else max(self.worst[key], v)
        self.chunks += 1
        return ref_state

    def numbers(self) -> dict:
        return dict(self.worst)


def is_correct(numbers: dict, limits: dict) -> bool:
    """Every number at or under its limit (NaN never is)."""
    return all(numbers[k] <= limits[k] for k in NUMBERS)
