"""Octant8 k-NN against the hashed voxel-block map: the association kernel.

Replaces the TPU kernel agi_lidar_slam_tpu/nn/vmem_knn.py (`knn_vmem`, body
`_kernel`) with a CUDA C++ kernel for Hopper, csrc/octant_knn.cu, built by
_build.py and bound through ctypes. Each query takes the 2x2x2 block set on
its side of each axis (`frac >= 0.5`); each of the 8 blocks is resolved to one
map row through the packed-key index (map/planar.build_ktab) over the probe
window [h, h+probes), and the k nearest occupied sub-voxel points of those 8
rows are selected, ties to the lower (octant, sub-voxel) index.

What bounds it on the card: the L2/DRAM bytes of the eight gathered rows,
about 6.6 KB per query at bucket 64. Both main-path tables fit the H100's
50 MB L2, so the kernel reads rows straight from global memory, one warp per
query, with neighbouring lanes on neighbouring points of a row (see the
source note in csrc/octant_knn.cu).

`knn_octant_ref` is the plain PyTorch version of the same function. The CPU
path and the tests use it; on a CUDA tensor `knn_octant` launches the kernel
or raises — it never falls back.
"""

from __future__ import annotations

import torch

from ..config import MapConfig
from .. import _build
from ..map.hash_map import (HashVoxelMap, _first_true, block_coords, hash_packed, map_rows,
                              pack_key)
from ..map.planar import build_ktab
from .knn import _BIG, _neighbor_blocks, _smallest_k

MAX_K = 16  # the kernel's selection width
MAX_BUCKET = 128  # the kernel's per-lane candidate registers

launches = 0  # kernel launches made by knn_octant since the last reset


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


def _check_inputs(m, queries, qmask, k, cfg, ktab):
    if cfg.neighborhood != "octant8":
        raise ValueError(f"octant KNN needs an octant8 map, got {cfg.neighborhood!r}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"octant KNN supports 1 <= k <= {MAX_K}, got {k}")
    if not 1 <= m.bucket <= MAX_BUCKET:
        raise ValueError(f"octant KNN supports buckets up to {MAX_BUCKET}, got {m.bucket}")
    rows = m.n_rows
    if rows < map_rows(cfg):
        raise ValueError(f"map has {rows} rows, its config needs {map_rows(cfg)}")
    checks = [("queries", queries, torch.float32, (queries.shape[0], 3)),
              ("qmask", qmask, torch.bool, (queries.shape[0],)),
              ("points", m.points, torch.float32, (rows, m.bucket, 3)),
              ("occ", m.occ, torch.bool, (rows, m.bucket))]
    if ktab is not None:
        checks.append(("ktab", ktab, torch.int32, (rows,)))
    for name, t, dtype, shape in checks:
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {dtype} {shape}, got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != queries.device:
            raise ValueError(f"{name} is on {t.device}, queries on {queries.device}")


def knn_octant(m: HashVoxelMap, queries: torch.Tensor, qmask: torch.Tensor, k: int,
               cfg: MapConfig, ktab: torch.Tensor | None = None):
    """Octant8 k-NN: (sq (N,k), points (N,k,3), valid (N,k)).

    `ktab` is the map's packed-key index (map/planar.build_ktab); pass it when
    several association passes probe one map. CPU tensors take
    `knn_octant_ref`; CUDA tensors launch the kernel (raising if the build or
    the launch fails); any other device raises."""
    _check_inputs(m, queries, qmask, k, cfg, ktab)
    if queries.device.type == "cpu":
        return knn_octant_ref(m, queries, qmask, k, cfg, ktab)
    if queries.device.type != "cuda":
        raise ValueError(f"octant KNN runs on cpu or cuda tensors, not {queries.device}")
    return _launch(m, queries, qmask, k, cfg, build_ktab(m) if ktab is None else ktab)


def _launch(m: HashVoxelMap, queries: torch.Tensor, qmask: torch.Tensor, k: int,
            cfg: MapConfig, ktab: torch.Tensor):
    """Launch the CUDA kernel on the current stream; inputs already checked."""
    global launches
    lib = _build.load()
    N = queries.shape[0]
    dev = queries.device
    sq = torch.empty((N, k), dtype=torch.float32, device=dev)
    pts = torch.empty((N, k, 3), dtype=torch.float32, device=dev)
    valid = torch.empty((N, k), dtype=torch.bool, device=dev)
    if N == 0:
        return sq, pts, valid
    err = lib.octant_knn_launch(
        queries.data_ptr(), qmask.data_ptr(), m.points.data_ptr(), m.occ.data_ptr(),
        ktab.data_ptr(), N, m.bucket, k, cfg.probes, cfg.log2_slots,
        cfg.sub_voxel, cfg.block_sub, cfg.block_size,
        sq.data_ptr(), pts.data_ptr(), valid.data_ptr(),
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"octant_knn kernel launch failed: cudaError {err} "
                           f"({lib.octant_knn_error_string(err).decode()})")
    launches += 1
    return sq, pts, valid
