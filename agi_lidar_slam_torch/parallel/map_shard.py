"""Map-sharded KNN, insert and rolling bound: the scale-out of the voxel map
for maps larger than one card's memory (port of
agi_lidar_slam_tpu/parallel/map_shard.py).

The block-slot axis is split over the ranks of a device mesh's "mp" group:

* keys (rows x 3 int32, small) are whole on every rank, so every rank
  resolves hash probes alone, with no communication in the lookup;
* points and occupancy (the bulk) are split by slot range: rank r of n holds
  rows [r*rows/n, (r+1)*rows/n) (`shard_map_arrays`);
* KNN: every rank gathers candidates from its own rows only, takes its local
  k smallest, and one all_gather of the n*k candidates is re-selected to the
  global k (communication O(N*k), whatever the map's size);
* insert: slot claims are resolved alike on every rank from the whole keys,
  and each rank scatters only the point rows it holds.

The results are those of the single-process knn and insert. The KNN runs
the gather path (`_neighbor_blocks`, `lookup`, `_smallest_k`), as the
reference's does, not the octant kernel: it works on a slice of the rows.
Ties keep the reference's order: the first index in the local pick and, in
the merge, the lowest rank.

A function here given a whole map (rows of points == rows of keys), as the
odometry stage's throwaway maps are, takes this rank's range of it: what
shard_map does to an input it splits.
"""

from __future__ import annotations

import torch

from ..config import MapConfig
from ..map.hash_map import (HashVoxelMap, block_coords, blocks_outside_box,
                            insert_with_stats, lookup)
from ..nn.knn import _BIG, KnnResult, _neighbor_blocks, _smallest_k
from .distributed import all_gather, rank_and_size


def _local(m: HashVoxelMap, rank: int, n: int, copy: bool = False) -> HashVoxelMap:
    """This rank's rows of a whole map (a map already split comes back as it
    is). `copy` keeps them in their own storage, so the whole map's can be
    freed."""
    rows = m.keys.shape[0]
    if m.points.shape[0] != rows:
        return m
    if rows % n:
        raise ValueError(f"{rows} map rows do not divide over {n} ranks")
    b = rows // n
    pts, occ = m.points[rank * b:(rank + 1) * b], m.occ[rank * b:(rank + 1) * b]
    if copy:
        pts, occ = pts.clone(), occ.clone()
    return HashVoxelMap(m.keys, pts, occ)


def shard_map_arrays(m: HashVoxelMap, mesh, axis: str = "mp") -> HashVoxelMap:
    """This rank's part of a slot-sharded map: keys whole, its range of
    points and occupancy rows."""
    rank, n = rank_and_size(mesh.get_group(axis))
    return _local(m, rank, n, copy=True)


def gather_map_arrays(m: HashVoxelMap, mesh, axis: str = "mp") -> HashVoxelMap:
    """The whole map from its slot-sharded parts, on every rank (one
    all_gather each of points and occupancy)."""
    group = mesh.get_group(axis)
    pts = all_gather(m.points, group)
    occ = all_gather(m.occ.to(torch.uint8), group)
    return HashVoxelMap(m.keys, pts.reshape((-1,) + m.points.shape[1:]),
                        occ.reshape((-1,) + m.occ.shape[1:]).to(torch.bool))


def sharded_knn(mesh, m: HashVoxelMap, queries: torch.Tensor, qmask: torch.Tensor, k: int,
                cfg: MapConfig, axis: str = "mp") -> KnnResult:
    """Exact KNN against a slot-sharded map; queries (N,3) and qmask (N,)
    alike on every rank, and the result too."""
    group = mesh.get_group(axis)
    rank, n = rank_and_size(group)
    m = _local(m, rank, n)
    local_rows = m.points.shape[0]
    N = queries.shape[0]

    bc, _ = block_coords(queries, cfg)
    slot = lookup(m.keys, _neighbor_blocks(queries, bc, cfg), cfg)  # (N,M) global slots
    mine = (slot >= 0) & (torch.div(slot, local_rows, rounding_mode="floor") == rank)
    lslot = torch.clamp(slot - rank * local_rows, 0, local_rows - 1).long()
    pts = m.points[lslot]  # (N,M,B,3); rows not held here are masked below
    occ = m.occ[lslot] & mine[..., None]
    dx, dy, dz = (pts - queries[:, None, None, :]).unbind(-1)
    d2 = dx * dx + dy * dy + dz * dz
    d2 = torch.where(occ & qmask[:, None, None], d2, torch.full_like(d2, _BIG))
    dloc, iloc = _smallest_k(d2.reshape(N, -1), k)  # (N,k)
    ploc = torch.gather(pts.reshape(N, -1, 3), 1, iloc[..., None].expand(N, k, 3))
    # merge: one all_gather of every rank's k candidates (distance and point
    # packed), re-selected to k; rank-major, so ties go to the lower rank
    cands = all_gather(torch.cat([dloc[..., None], ploc], dim=-1), group)  # (n,N,k,4)
    cands = cands.permute(1, 0, 2, 3).reshape(N, n * k, 4)
    dsel, isel = _smallest_k(cands[..., 0].contiguous(), k)
    psel = torch.gather(cands[..., 1:], 1, isel[..., None].expand(N, k, 3))
    return KnnResult(psel, dsel, dsel < _BIG * 0.5)


def sharded_insert(mesh, m: HashVoxelMap, xyz: torch.Tensor, mask: torch.Tensor,
                   cfg: MapConfig, axis: str = "mp") -> HashVoxelMap:
    """Insert into a slot-sharded map: map.hash_map.insert_with_stats on the
    rank's rows, which resolves the claims alike on every rank from the
    whole keys and scatters only the rows the rank holds. The semantics of
    the single-process insert; the drop count is not kept."""
    rank, n = rank_and_size(mesh.get_group(axis))
    m = _local(m, rank, n)
    return insert_with_stats(m, xyz, mask, cfg, row0=rank * m.points.shape[0])[0]


def sharded_bound(mesh, m: HashVoxelMap, center: torch.Tensor, radius: float,
                  cfg: MapConfig, axis: str = "mp") -> HashVoxelMap:
    """map.hash_map.bound_map on a slot-sharded map: the blocks to drop are
    found from the whole keys, and each rank clears its own rows."""
    rank, n = rank_and_size(mesh.get_group(axis))
    m = _local(m, rank, n, copy=True)
    keys, drop = blocks_outside_box(m.keys, center - radius, center + radius, cfg)
    lr = m.occ.shape[0]
    return HashVoxelMap(keys, m.points, m.occ & ~drop[rank * lr:(rank + 1) * lr, None])
