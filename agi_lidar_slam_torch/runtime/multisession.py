"""Multi-session mapping: merge independent SLAM sessions into one
globally-consistent map (port of agi_lidar_slam_tpu/runtime/multisession.py).

Several sessions' keyframe banks are merged, inter-session loop closures
anchor them to each other, one joint pose-graph solve aligns everything, and
the merged map is rebuilt.

This is an offline/batch path (the analog of merging several recorded bags),
so host-side orchestration around the device steps is appropriate; the heavy
steps — loop alignment (the engine's own scan-to-map GN), the pose-graph
solve, and the map rebuild — are the ones the online drivers use. The
slot-sharded rebuild over a device mesh (`build_merged_map(mesh=...)`) is
one of the multi-device hooks, not ported yet.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..geometry import se3, so3
from ..graph.keyframes import KeyframeBank, empty_bank
from ..graph.loop_closure import LoopConfig, align_loop
from ..graph.pose_graph import (EdgeSet, add_edge, between_measurement,
                                empty_edges, solve_pose_graph)
from ..map.hash_map import HashVoxelMap, empty_map, insert


def merge_banks(banks: List[KeyframeBank], capacity: Optional[int] = None
                ) -> Tuple[KeyframeBank, np.ndarray]:
    """Concatenate the live keyframes of several sessions into one bank, on
    the first bank's device.

    Returns (merged bank, session id per merged slot (K,) int32).
    """
    counts = [int(b.count) for b in banks]
    total = sum(counts)
    cap = capacity or max(total, 1)
    if total > cap:
        raise ValueError(f"{total} keyframes exceed merged capacity {cap}")
    dev = banks[0].q.device
    nc = banks[0].corner_xyz.shape[1]
    ns = banks[0].surf_xyz.shape[1]
    out = empty_bank(cap, nc, ns, dev)

    def cat(field):
        full = getattr(out, field).clone()
        full[:total] = torch.cat([getattr(b, field)[:n].to(dev) for b, n in zip(banks, counts)])
        return full

    merged = KeyframeBank(
        q=cat("q"), t=cat("t"), stamp=cat("stamp"),
        corner_xyz=cat("corner_xyz"), corner_mask=cat("corner_mask"),
        surf_xyz=cat("surf_xyz"), surf_mask=cat("surf_mask"),
        count=torch.full((), total, dtype=torch.int32, device=dev),
    )
    session = np.full(cap, -1, np.int32)
    ofs = 0
    for sid, n in enumerate(counts):
        session[ofs:ofs + n] = sid
        ofs += n
    return merged, session


def odometry_edges(banks: List[KeyframeBank], weights=(1e4, 1e4),
                   capacity: int = 4096) -> EdgeSet:
    """Within-session odometry BetweenFactors on the merged index space.

    One batched between_measurement per session + one write for the whole
    edge set (a per-edge add_edge loop costs O(K) device launches)."""
    dev = banks[0].q.device
    ii, jj, zq, zt = [], [], [], []
    ofs = 0
    for b in banks:
        n = int(b.count)
        if n >= 2:
            z = between_measurement(se3.Pose(b.q[: n - 1], b.t[: n - 1]),
                                    se3.Pose(b.q[1:n], b.t[1:n]))
            ii.append(torch.arange(ofs, ofs + n - 1, dtype=torch.int32, device=dev))
            jj.append(torch.arange(ofs + 1, ofs + n, dtype=torch.int32, device=dev))
            zq.append(z.q.to(dev))
            zt.append(z.t.to(dev))
        ofs += n
    edges = empty_edges(capacity, dev)
    if not ii:
        return edges
    i_all = torch.cat(ii)
    E = i_all.shape[0]
    if E > capacity:
        raise ValueError(f"{E} odometry edges exceed edge capacity {capacity}")

    def put(arr, val):
        arr = arr.clone()
        if isinstance(val, torch.Tensor):
            arr[:E] = val
        else:
            arr[:E].fill_(val)
        return arr

    return edges._replace(
        i=put(edges.i, i_all), j=put(edges.j, torch.cat(jj)),
        z_q=put(edges.z_q, torch.cat(zq)), z_t=put(edges.z_t, torch.cat(zt)),
        w_rot=put(edges.w_rot, weights[0]), w_trans=put(edges.w_trans, weights[1]),
        valid=put(edges.valid, True),
        count=torch.full((), E, dtype=torch.int32, device=dev),
    )


def cross_session_candidates(bank: KeyframeBank, session: np.ndarray,
                             radius: float, max_pairs: int = 16
                             ) -> List[Tuple[int, int]]:
    """(cur, cand) keyframe pairs from different sessions within `radius`,
    greedily spread out (each keyframe used at most once per side). Decided
    on the host, from one copy of the keyframe positions."""
    n = int(bank.count)
    t = bank.t[:n].cpu().numpy()
    sid = session[:n]
    d = np.linalg.norm(t[:, None, :] - t[None, :, :], axis=-1)
    cross = sid[:, None] != sid[None, :]
    cand = np.argwhere(cross & (d < radius))
    cand = cand[cand[:, 0] > cand[:, 1]]  # one direction per pair
    order = np.argsort(d[cand[:, 0], cand[:, 1]])
    used_a, used_b, pairs = set(), set(), []
    for a, b in cand[order]:
        if a in used_a or b in used_b:
            continue
        pairs.append((int(a), int(b)))
        used_a.add(a)
        used_b.add(b)
        if len(pairs) >= max_pairs:
            break
    return pairs


def merge_sessions(
    banks: List[KeyframeBank],
    loop_cfg: LoopConfig = LoopConfig(),
    pair_radius: float = 5.0,
    max_pairs: int = 16,
    odom_w: float = 1e4,
    loop_w: float = 1e4,
    n_gn_iters: int = 8,
) -> Tuple[KeyframeBank, np.ndarray, int]:
    """Full multi-session merge: banks -> (corrected merged bank,
    session ids, number of accepted inter-session closures).

    Session 0 is the reference frame (the joint solve anchors node 0); other
    sessions are pulled onto it by the accepted inter-session alignments.
    """
    bank, session = merge_banks(banks)
    edges = odometry_edges(banks, weights=(odom_w, odom_w))
    dev = bank.q.device

    def index(i):
        return torch.full((), i, dtype=torch.int32, device=dev)

    n_accepted = 0
    for cur, cand in cross_session_candidates(bank, session, pair_radius, max_pairs):
        z, fitness, ok = align_loop(bank, index(cur), index(cand), loop_cfg)
        if bool(ok):
            edges = add_edge(edges, cand, cur, z, loop_w, loop_w, kind=0, do_add=True)
            n_accepted += 1

    new_poses = solve_pose_graph(bank.poses(), bank.count, edges, n_gn_iters=n_gn_iters)
    bank = bank._replace(q=new_poses.q, t=new_poses.t)
    return bank, session, n_accepted


def build_merged_map(bank: KeyframeBank, map_cfg, mesh=None) -> HashVoxelMap:
    """Rebuild one global map from the corrected merged bank (surf clouds),
    on the bank's device. A `mesh` (the slot-sharded map over several
    devices) is one of the multi-device hooks, not ported: it raises."""
    if mesh is not None:
        raise NotImplementedError("the slot-sharded merged map (mesh=...) is not ported to torch")
    K = bank.capacity
    dev = bank.q.device
    live = (torch.arange(K, device=dev) < bank.count)[:, None]
    R = so3.quat_to_matrix(bank.q)
    world = torch.einsum("kij,knj->kni", R, bank.surf_xyz) + bank.t[:, None, :]
    xyz = world.reshape(-1, 3)
    mask = (bank.surf_mask & live).reshape(-1)
    return insert(empty_map(map_cfg, dev), xyz, mask, map_cfg)
