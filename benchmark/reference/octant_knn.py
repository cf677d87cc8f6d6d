# Frozen copy of agi_lidar_slam_torch/nn/octant_knn.py at commit 88e7c49, for the
# benchmark's plain reference: it imports nothing of the program, and
# later changes to the program do not reach it.
"""Octant8 k-NN against the hashed voxel-block map, plain PyTorch: the
reference's association for octant8 maps. Each query takes the 2x2x2 block
set on its side of each axis (`frac >= 0.5`); each of the 8 blocks is
resolved to one map row through the packed-key index (planar.build_ktab)
over the probe window [h, h+probes), and the k nearest occupied sub-voxel
points of those 8 rows are selected, ties to the lower (octant, sub-voxel)
index. The program serves this with a CUDA kernel; here it is the plain
version that the kernel is held to.
"""

from __future__ import annotations

import torch

from .config import MapConfig
from .hash_map import HashVoxelMap, _first_true, block_coords, hash_packed, pack_key
from .planar import build_ktab
from .knn import _BIG, _neighbor_blocks, _smallest_k


def octant_probe_keys(queries: torch.Tensor, cfg: MapConfig):
    """Packed keys and probe bases of each query's 8 octant blocks, (N,8) int32
    each, in octant order (cx, cy, cz) = bits (4, 2, 1) of the octant index."""
    bc, _ = block_coords(queries, cfg)
    nbr = _neighbor_blocks(queries, bc, cfg)  # (N,8,3)
    qk = pack_key(nbr)
    return qk, hash_packed(qk, cfg.log2_slots)


def knn_octant_ref(m: HashVoxelMap, queries: torch.Tensor, qmask: torch.Tensor, k: int,
                   cfg: MapConfig, ktab: torch.Tensor | None = None):
    """Plain PyTorch octant8 k-NN with the kernel's contract: returns
    (sq (N,k), points (N,k,3), valid (N,k)); sq = 1e30 and points = 0 where
    invalid."""
    if ktab is None:
        ktab = build_ktab(m)
    N, B, P = queries.shape[0], m.bucket, cfg.probes
    qk, qh = octant_probe_keys(queries, cfg)
    win = ktab[qh[..., None].long() + torch.arange(P, device=queries.device)]  # (N,8,P)
    match = win == qk[..., None]
    # the LAST matching row of the window, as the kernel (and the TPU kernel)
    # keep it; rows only repeat a packed key when blocks 1024 apart alias
    last = (P - 1) - _first_true(match.flip(-1))
    found = match.any(dim=-1)
    row = torch.where(found, qh.long() + last, torch.zeros_like(last))
    pts = m.points[row]  # (N,8,B,3)
    occ = m.occ[row] & found[..., None] & qmask[:, None, None]
    dx, dy, dz = (pts - queries[:, None, None, :]).unbind(-1)
    d2 = dx * dx + dy * dy + dz * dz
    d2 = torch.where(occ, d2, torch.full_like(d2, _BIG)).reshape(N, 8 * B)
    sq, idx = _smallest_k(d2, k)
    valid = sq < _BIG * 0.5
    nn = torch.gather(pts.reshape(N, 8 * B, 3), 1, idx[..., None].expand(N, k, 3))
    return (torch.where(valid, sq, torch.full_like(sq, _BIG)),
            torch.where(valid[..., None], nn, torch.zeros_like(nn)), valid)


def knn_octant(m: HashVoxelMap, queries: torch.Tensor, qmask: torch.Tensor, k: int,
               cfg: MapConfig, ktab: torch.Tensor | None = None):
    """Octant8 k-NN by the plain version, on any device (the program launches
    its CUDA kernel here; the kernel is held bit-exact to this function)."""
    if cfg.neighborhood != "octant8":
        raise ValueError(f"octant KNN needs an octant8 map, got {cfg.neighborhood!r}")
    return knn_octant_ref(m, queries, qmask, k, cfg, ktab)
