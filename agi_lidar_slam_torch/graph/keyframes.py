"""Keyframe bank: fixed-capacity store of poses and feature clouds (port of
agi_lidar_slam_tpu/graph/keyframes.py).

Poses and per-keyframe feature clouds live in preallocated tensors, gated by
distance and angle thresholds (LIO-SAM saveFrame, 1 m / 0.2 rad). The
append is a masked write at a tensor index, so adding a keyframe never reads
the count or the gate back to the host.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..device import default_device
from ..geometry import se3, so3
from ..pointcloud.cloud import PointBatch


class KeyframeBank(NamedTuple):
    q: torch.Tensor  # (K,4) world_R_kf
    t: torch.Tensor  # (K,3)
    stamp: torch.Tensor  # (K,) int32 scan index of each keyframe
    corner_xyz: torch.Tensor  # (K,Nc,3) in keyframe (sensor) frame
    corner_mask: torch.Tensor  # (K,Nc)
    surf_xyz: torch.Tensor  # (K,Ns,3)
    surf_mask: torch.Tensor  # (K,Ns)
    count: torch.Tensor  # () int32 number of live keyframes

    @property
    def capacity(self) -> int:
        return self.q.shape[0]

    def poses(self) -> se3.Pose:
        return se3.Pose(self.q, self.t)


def row(arr: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """arr[i] for a 0-d index tensor, without reading it to the host."""
    return arr.index_select(0, i.reshape(1).long())[0]


def write_row(arr: torch.Tensor, w: torch.Tensor, write: torch.Tensor,
              val: torch.Tensor) -> torch.Tensor:
    """A copy of arr whose row w (0-d index tensor) is `val` where `write`
    and itself elsewhere: the reference's arr.at[w].set(where(write, val,
    arr[w]))."""
    w1 = w.reshape(1).long()
    old = arr.index_select(0, w1)
    return arr.index_copy(0, w1, torch.where(write, val.to(arr.dtype).reshape(old.shape), old))


def empty_bank(capacity: int, n_corner: int, n_surf: int, device=None) -> KeyframeBank:
    """An empty bank on `device` (default: cuda)."""
    device = default_device(device)
    return KeyframeBank(
        q=so3.quat_identity((capacity,), device=device),
        t=torch.zeros((capacity, 3), device=device),
        stamp=torch.zeros((capacity,), dtype=torch.int32, device=device),
        corner_xyz=torch.zeros((capacity, n_corner, 3), device=device),
        corner_mask=torch.zeros((capacity, n_corner), dtype=torch.bool, device=device),
        surf_xyz=torch.zeros((capacity, n_surf, 3), device=device),
        surf_mask=torch.zeros((capacity, n_surf), dtype=torch.bool, device=device),
        count=torch.zeros((), dtype=torch.int32, device=device),
    )


def last_index(bank: KeyframeBank) -> torch.Tensor:
    """Index of the newest keyframe (0 when the bank is empty)."""
    return torch.clamp(bank.count - 1, min=0)


def should_add(bank: KeyframeBank, pose: se3.Pose,
               dist_thresh: float = 1.0, angle_thresh: float = 0.2) -> torch.Tensor:
    """Keyframe gate (LIO-SAM saveFrame). Always True when empty."""
    last = last_index(bank)
    dq = so3.quat_mul(so3.quat_conj(row(bank.q, last)), pose.q)
    dang = torch.linalg.vector_norm(so3.quat_log(dq))
    ddist = torch.linalg.vector_norm(pose.t - row(bank.t, last))
    return (bank.count == 0) | (ddist > dist_thresh) | (dang > angle_thresh)


def add_keyframe(
    bank: KeyframeBank,
    pose: se3.Pose,
    corners: PointBatch,
    surfs: PointBatch,
    stamp: torch.Tensor,
    do_add: torch.Tensor,
) -> Tuple[KeyframeBank, torch.Tensor]:
    """Append (masked by do_add; no-op when full). Returns (bank, index used).
    A full bank rewrites its last slot with itself."""
    K = bank.capacity
    idx = torch.clamp(bank.count, max=K - 1)
    write = do_add & (bank.count < K)
    w = torch.where(write, idx, torch.full_like(idx, K - 1))
    new = KeyframeBank(
        q=write_row(bank.q, w, write, pose.q),
        t=write_row(bank.t, w, write, pose.t),
        stamp=write_row(bank.stamp, w, write, stamp),
        corner_xyz=write_row(bank.corner_xyz, w, write, corners.xyz),
        corner_mask=write_row(bank.corner_mask, w, write, corners.mask),
        surf_xyz=write_row(bank.surf_xyz, w, write, surfs.xyz),
        surf_mask=write_row(bank.surf_mask, w, write, surfs.mask),
        count=bank.count + write.to(torch.int32),
    )
    return new, idx
