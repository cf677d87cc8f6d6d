"""Batched k-nearest-neighbor queries against the hashed voxel-block map
(port of agi_lidar_slam_tpu/nn/knn.py).

Two neighborhood modes (MapConfig.neighborhood):
* "octant8": the 2x2x2 block set nearest the query; coverage radius =
  block_size/2. Served by the octant-KNN kernel (nn/octant_knn.py).
* "full27": the 3x3x3 neighborhood; coverage radius = block_size. Served by
  the gather path here: deduplicated block lookups, one gather of the
  candidate rows, k argmin passes.

`knn_brute` is the exact oracle used by the parity tests. The candidate cache
(`knn_cand`, `knn_reselect`) is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from agi_lidar_slam_tpu.config import MapConfig

from ..map.hash_map import HashVoxelMap, block_coords, lookup_dedup
from ..pointcloud.voxel import div_exact

_BIG = 1e30


class KnnResult(NamedTuple):
    """points (N,k,3); sq_dists (N,k) (1e30 where no neighbor); valid (N,k)."""

    points: torch.Tensor
    sq_dists: torch.Tensor
    valid: torch.Tensor


def _offsets(cfg: MapConfig, device) -> torch.Tensor:
    """(M,3) int32 block offsets: the 27 of full27, or the 8 octant corners
    in {0,1}^3 (scaled per query by its side of each axis)."""
    if cfg.neighborhood == "full27":
        r = torch.arange(27, device=device)
        return torch.stack([r // 9 - 1, (r // 3) % 3 - 1, r % 3 - 1], dim=-1).to(torch.int32)
    o = torch.arange(8, device=device)
    return torch.stack([(o >> 2) & 1, (o >> 1) & 1, o & 1], dim=-1).to(torch.int32)


def _neighbor_blocks(queries: torch.Tensor, bc: torch.Tensor, cfg: MapConfig) -> torch.Tensor:
    """(N,3) block coords -> (N,M,3) neighbor block coords to search."""
    off = _offsets(cfg, queries.device)
    if cfg.neighborhood == "full27":
        return bc[:, None, :] + off[None, :, :]
    frac = div_exact(queries, cfg.block_size) - bc.to(queries.dtype)
    sign = torch.where(frac >= 0.5, 1, -1).to(torch.int32)  # (N,3)
    return bc[:, None, :] + off[None, :, :] * sign[:, None, :]


def _dedup_lookup(m: HashVoxelMap, nbr: torch.Tensor, qmask: torch.Tensor,
                  cfg: MapConfig) -> torch.Tensor:
    """Slot lookup for (N,M,3) neighbor blocks with cross-query deduplication."""
    N, M, _ = nbr.shape
    valid = qmask[:, None].expand(N, M).reshape(-1)
    return lookup_dedup(m.keys, nbr.reshape(-1, 3), valid, cfg).reshape(N, M)


def knn(m: HashVoxelMap, queries: torch.Tensor, qmask: torch.Tensor, k: int,
        cfg: MapConfig, ktab: torch.Tensor | None = None) -> KnnResult:
    """k nearest map points for each query. queries (N,3), qmask (N,).

    octant8 maps go to the octant-KNN kernel (`ktab`: its prebuilt packed-key
    index, map/planar.build_ktab); full27 maps, or `knn_kernel="xla"`, take
    the gather path."""
    if cfg.neighborhood == "octant8" and cfg.knn_kernel != "xla":
        from .octant_knn import knn_octant  # octant_knn imports this module

        sq, pts, valid = knn_octant(m, queries, qmask, k, cfg, ktab=ktab)
        return KnnResult(pts, sq, valid)
    bc, _ = block_coords(queries, cfg)
    nbr = _neighbor_blocks(queries, bc, cfg)  # (N,M,3)
    slot = _dedup_lookup(m, nbr, qmask, cfg)  # (N,M)
    dump = m.n_rows - 1
    slot_safe = torch.where(slot >= 0, slot, torch.full_like(slot, dump)).long()
    pts = m.points[slot_safe]  # (N,M,B,3) contiguous block rows
    occ = m.occ[slot_safe] & (slot >= 0)[..., None]  # (N,M,B)
    dx, dy, dz = (pts - queries[:, None, None, :]).unbind(-1)
    d2 = dx * dx + dy * dy + dz * dz
    d2 = torch.where(occ & qmask[:, None, None], d2, torch.full_like(d2, _BIG))
    d2f = d2.reshape(d2.shape[0], -1)
    sq, idx = _smallest_k(d2f, k)
    flat = pts.reshape(pts.shape[0], -1, 3)
    nn_pts = torch.gather(flat, 1, idx[..., None].expand(idx.shape + (3,)))
    return KnnResult(nn_pts, sq, sq < _BIG * 0.5)


def _smallest_k(d: torch.Tensor, k: int):
    """Exact k smallest per row via k argmin passes (first index on ties)."""
    cols = torch.arange(d.shape[1], device=d.device)[None, :]
    vals, idxs = [], []
    for _ in range(k):
        i = torch.argmin(d, dim=1)
        vals.append(torch.gather(d, 1, i[:, None])[:, 0])
        idxs.append(i)
        d = torch.where(cols == i[:, None], torch.full_like(d, _BIG), d)
    return torch.stack(vals, dim=1), torch.stack(idxs, dim=1)


def knn_brute(ref_pts: torch.Tensor, ref_mask: torch.Tensor, queries: torch.Tensor,
              k: int) -> KnnResult:
    """Exact brute-force KNN oracle (test reference for the hashed-map KNN)."""
    d = queries[:, None, :] - ref_pts[None, :, :]
    d2 = torch.sum(d * d, dim=-1)
    d2 = torch.where(ref_mask[None, :], d2, torch.full_like(d2, _BIG))
    sq, idx = torch.topk(d2, k, dim=1, largest=False)
    return KnnResult(ref_pts[idx], sq, sq < _BIG * 0.5)
