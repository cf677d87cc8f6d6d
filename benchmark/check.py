"""The comparison that decides `correct`: the program's poses and carried
state against a plain reference, on the sweeps the benchmark handed the
program. What is engine-neutral lives here: the numbers compared, the pose
gaps, the worst of each over the checked stretches, and the test against the
limits. Each engine's adapter (benchmark/engines/<adapter>.py) has a
`Checker` that runs that engine's frozen reference and holds the program to
it with these.

The reference cannot run a whole window in the window's time (it is eager
and reads the host), so it follows the program step by step: for each
sampled call it starts from the program's own state as handed into that call
and runs the same sweeps. The start, which that skips, is checked by itself:
from its own initial state, made from the traffic's start poses, the
reference runs the run's first calls in turn (the warm-up and the calls
after it, up to the workload's `own_start_scans`), carrying its own state
from call to call, and is held to the program's poses of each and to its
state after each warm-up call and after the last.

Numbers compared (the worst over every checked call):
  pose_gap_m      largest distance between a program pose and the reference's
  rot_gap_rad     largest angle between a program rotation and the reference's
  state_mismatch  entries of the carried state on one side and not the
                  other, or on both too far apart, over the reference's
                  entries (which entries, and how far, the adapter says)
"""

from __future__ import annotations

import math

import torch
from torch.utils import _pytree as pytree

NUMBERS = ("pose_gap_m", "rot_gap_rad", "state_mismatch")


def relayout(tree, template):
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


class Worst:
    """The worst reading of each compared number over the calls checked so
    far (NaN, once read, stays)."""

    def __init__(self):
        self.worst = dict.fromkeys(NUMBERS, 0.0)

    def hold(self, key: str, v: float) -> None:
        self.worst[key] = v if math.isnan(v) else max(self.worst[key], v)

    def numbers(self) -> dict:
        return dict(self.worst)


def is_correct(numbers: dict, limits: dict) -> bool:
    """Every number at or under its limit (NaN never is)."""
    return all(numbers[k] <= limits[k] for k in NUMBERS)
