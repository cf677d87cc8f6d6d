"""Voxel-grid downsampling as a sort + segment-reduce
(port of agi_lidar_slam_tpu/pointcloud/voxel.py).

Produces the centroid of each occupied voxel, like pcl::VoxelGrid, into a
fixed output capacity; overflow voxels are dropped.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .cloud import PointBatch

# Coordinates are clipped to a 1024^3 voxel lattice centered at the origin so a
# voxel key packs into one int32 (10 bits/axis).
_HALF_GRID = 512
_INVALID_KEY = 2**31 - 1
_SCAN_BASE = 16


def prefix_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Inclusive f32 prefix sum along `dim`, summed in the reference's order.

    The reference's `jnp.cumsum` compiles to a blocked scan: sequential sums
    inside blocks of 16, the same scan applied recursively to the block totals,
    and each block's exclusive prefix added back. Summing in that order gives
    the reference's rounding bit for bit, and its error grows with the number
    of levels instead of the length (torch's CPU cumsum accumulates in f64 and
    its CUDA scan uses yet another order)."""
    return _blocked_scan(x.movedim(dim, -1)).movedim(-1, dim)


def div_exact(x: torch.Tensor, s: float) -> torch.Tensor:
    """x / s with IEEE f32 division, on every device, so that floor(x / s)
    puts a point in the same voxel on the CPU, on the card and in the octant
    kernel (which divides with __fdiv_rn). On CUDA, torch turns division by a
    Python scalar into a multiply by its reciprocal, which can move a floor()
    across a voxel boundary; dividing by a 0-d device tensor keeps the true
    division. (The reference's op-by-op semantics are IEEE too; jitted, XLA
    multiplies by the reciprocal instead.)"""
    return x / torch.full((), s, dtype=x.dtype, device=x.device)


def _blocked_scan(x: torch.Tensor) -> torch.Tensor:
    n = x.shape[-1]
    pad = (-n) % _SCAN_BASE if n > _SCAN_BASE else 0
    w = F.pad(x, (0, pad)).reshape(x.shape[:-1] + (-1, min(n, _SCAN_BASE))).clone()
    for i in range(1, w.shape[-1]):
        w[..., i] += w[..., i - 1]
    if n <= _SCAN_BASE:
        return w[..., 0, :]
    totals = _blocked_scan(w[..., -1])
    excl = F.pad(totals[..., :-1], (1, 0))
    return (w + excl[..., None]).reshape(x.shape[:-1] + (-1,))[..., :n]


def voxel_keys(xyz: torch.Tensor, mask: torch.Tensor, voxel_size: float) -> torch.Tensor:
    """Packed int32 voxel id per point; invalid points get a sort-last sentinel."""
    vc = torch.clamp(torch.floor(div_exact(xyz, voxel_size)).to(torch.int32) + _HALF_GRID,
                     0, 2 * _HALF_GRID - 1)
    key = (vc[..., 0] << 20) | (vc[..., 1] << 10) | vc[..., 2]
    return torch.where(mask, key, torch.full_like(key, _INVALID_KEY))


def _centers(k: torch.Tensor, voxel_size: float) -> torch.Tensor:
    """Voxel centers of packed keys (the sentinel decodes as key 0)."""
    safe = torch.where(k == _INVALID_KEY, torch.zeros_like(k), k)
    vc = torch.stack([(safe >> 20) & 0x3FF, (safe >> 10) & 0x3FF, safe & 0x3FF], dim=-1)
    return (vc.to(torch.float32) - _HALF_GRID + 0.5) * voxel_size


def voxel_downsample_aux(
    xyz: torch.Tensor,
    mask: torch.Tensor,
    voxel_size: float,
    capacity: int,
    aux: torch.Tensor | None = None,
) -> tuple[PointBatch, torch.Tensor | None]:
    """Centroid downsample that also carries an auxiliary per-point scalar
    (e.g. the in-sweep time fraction) through the reduction as a mean, as PCL
    centroids average every field.

    A stable key sort makes each voxel a contiguous run; per-voxel sums are
    differences of an inclusive prefix sum taken at run ends, and the run ends
    of the first `capacity` voxels are the sorted run-end positions."""
    N = xyz.shape[0]
    key = voxel_keys(xyz, mask, voxel_size)
    key_s, order = torch.sort(key, stable=True)
    xyz_s = xyz[order]
    mask_s = key_s != _INVALID_KEY

    # f32 prefix sums over 115k raw coordinates would lose ~0.25 m at the
    # tail; accumulate residuals from each point's voxel CENTER instead
    # (|residual| <= leaf/2) and add the exactly-reconstructable center back
    ctr = _centers(key_s, voxel_size)
    lanes = [xyz_s - ctr, mask_s.to(torch.float32)[:, None]]
    if aux is not None:
        lanes.append(aux[order][:, None])
    vals = torch.cat(lanes, dim=-1)  # (N, 4|5)
    csum = prefix_sum(torch.where(mask_s[:, None], vals, torch.zeros_like(vals)), 0)

    # run ends: last element of each key run (valid keys only)
    is_end = mask_s & torch.cat(
        [key_s[:-1] != key_s[1:], torch.ones((1,), dtype=torch.bool, device=xyz.device)])
    arange = torch.arange(N, dtype=torch.int32, device=xyz.device)
    endpos = torch.where(is_end, arange, torch.full_like(arange, N))
    ends = torch.sort(endpos).values[:capacity]
    have = ends < N
    ends_c = torch.clamp(ends, max=N - 1).long()
    totals = csum[ends_c]  # (capacity, L) inclusive prefix at run end
    prev = torch.cat([torch.zeros_like(totals[:1]), totals[:-1]], dim=0)
    sums = torch.where(have[:, None], totals - prev, torch.zeros_like(totals))

    cnts = sums[:, 3]
    denom = torch.clamp(cnts, min=1.0)
    out = _centers(key_s[ends_c], voxel_size) + sums[:, :3] / denom[:, None]
    out = torch.where(have[:, None], out, torch.zeros_like(out))
    aux_mean = sums[:, 4] / denom if aux is not None else None
    return PointBatch(out, cnts > 0.5), aux_mean
