"""Dynamic-object (foreground) removal, LIO-Livox's PCSeg re-designed
(port of agi_lidar_slam_tpu/features/dynamic_removal.py).

* ground: the per-BEV-cell minimum z is the local ground level; a point is
  ground if it lies within a height band of its cell's level;
* clustering: 2-D connected components over the occupied cells by iterated
  min-label propagation with pointer jumping;
* classification: clusters with a small footprint and a low height are
  foreground (vehicle or pedestrian scale) and removed.

The reference gathers from the (G, G) cell images by one-hot matmuls in
bf16, which round labels above 256 (G > 256 corrupts the clustering). Here
every gather is a native index, exact at any G.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..pointcloud.cloud import ScanGrid
from ..pointcloud.voxel import div_exact


class DynamicRemovalConfig(NamedTuple):
    cell: float = 0.4  # BEV cell size (m)
    half_extent: float = 40.0  # the grid covers [-half, half] in x and y
    ground_band: float = 0.3  # height band above the cell minimum counted as ground
    fg_max_footprint: int = 160  # cells: larger clusters are background
    fg_max_height: float = 3.0  # taller clusters are background (walls, trees)
    n_prop_rounds: int = 4  # label-propagation rounds, each with a pointer jump
    # azimuth-column stride of the cell statistics; points in cells that no
    # decimated sample reached are kept
    stats_stride: int = 1

    @property
    def grid(self) -> int:
        return int(2 * self.half_extent / self.cell)


def remove_dynamic(scan: ScanGrid, cfg: DynamicRemovalConfig = DynamicRemovalConfig()):
    """Returns a static-point mask (R,W): True = keep (ground or background)."""
    G = cfg.grid
    GG = G * G
    dev = scan.xyz.device
    xyz = scan.xyz.reshape(-1, 3)
    mask = scan.mask.reshape(-1)
    stat_mask = mask
    if cfg.stats_stride > 1:  # decimated cell statistics (see the config)
        col = torch.arange(scan.mask.shape[1], device=dev) % cfg.stats_stride == 0
        stat_mask = mask & col.expand(scan.mask.shape).reshape(-1)

    cx = torch.clamp(div_exact(xyz[:, 0] + cfg.half_extent, cfg.cell).to(torch.int32), 0, G - 1)
    cy = torch.clamp(div_exact(xyz[:, 1] + cfg.half_extent, cfg.cell).to(torch.int32), 0, G - 1)
    cell_pt = (cx * G + cy).long()
    cell_stat = torch.where(stat_mask, cell_pt, torch.full_like(cell_pt, GG))

    # --- per-cell z extremes (the only point-space scatters) ---------------
    z = xyz[:, 2]
    zmin = torch.full((GG + 1,), float("inf"), device=dev).scatter_reduce_(
        0, cell_stat, torch.where(stat_mask, z, torch.full_like(z, 1e9)), "amin")
    zmax = torch.full((GG + 1,), -float("inf"), device=dev).scatter_reduce_(
        0, cell_stat, torch.where(stat_mask, z, torch.full_like(z, -1e9)), "amax")
    # a cell is occupied (holds non-ground content) iff its height spread
    # exceeds the ground band
    cellrel = (zmax - zmin)[:GG]
    occ2d = (cellrel > cfg.ground_band).reshape(G, G)

    sentinel = torch.full((G, G), GG, dtype=torch.int64, device=dev)
    labels = torch.where(occ2d, torch.arange(GG, device=dev).reshape(G, G), sentinel)
    # torch.roll wraps, but the grid's opposite borders must not connect
    row = torch.arange(G, device=dev)[:, None]
    col2 = torch.arange(G, device=dev)[None, :]
    edge_ok = {(0, 1): row > 0, (0, -1): row < G - 1, (1, 1): col2 > 0, (1, -1): col2 < G - 1}
    nb_ok = {d: torch.roll(occ2d, d[1], dims=d[0]) & ok & occ2d for d, ok in edge_ok.items()}
    for _ in range(cfg.n_prop_rounds):
        m = labels
        for (ax, sh), ok in nb_ok.items():
            m = torch.minimum(m, torch.where(ok, torch.roll(labels, sh, dims=ax), m))
        # pointer jump: labels are cell indices, the sentinel jumps to itself
        flat = m.reshape(-1)
        jumped = torch.where(flat == GG, flat, flat[torch.clamp(flat, max=GG - 1)])
        m = torch.minimum(m, jumped.reshape(G, G))
        labels = torch.where(occ2d, m, sentinel)

    # --- cluster statistics, in cell space ---------------------------------
    lab_flat = labels.reshape(-1)
    footprint = torch.zeros((GG + 1,), dtype=torch.int32, device=dev).index_add_(
        0, lab_flat, occ2d.reshape(-1).to(torch.int32))
    hmax = torch.full((GG + 1,), -float("inf"), device=dev).scatter_reduce_(
        0, lab_flat, cellrel, "amax")
    is_fg = (footprint < cfg.fg_max_footprint) & (hmax < cfg.fg_max_height)
    # the sentinel label (cells the statistics did not occupy) is background,
    # so points in unsampled cells are kept
    is_fg[GG].fill_(False)  # a fill: assigning a Python bool is a host copy
    fg_cell = is_fg[lab_flat]
    # a point is kept iff ground (z < zmin + band) or in a background cell
    w = torch.where(fg_cell, zmin[:GG] + cfg.ground_band, torch.full_like(cellrel, 3e4))
    keep = mask & (z < w[cell_pt])
    return keep.reshape(scan.mask.shape)
