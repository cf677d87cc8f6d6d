#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. device  — the card's name and power limit (nvidia-smi); TF32 off;
  2. build   — nvcc builds the port's kernels from agi_lidar_slam_torch/csrc,
               one process per source, with -Xptxas -v: each instance's
               registers and spills are printed, and a spill fails the run;
  3. kernel  — the octant-KNN kernel against its plain PyTorch version on
               uniform queries over uniformly filled maps at the odometry
               path's shapes (2048 queries / 8448-row corner table, 8192 /
               16640-row surf table, k=5) and the LIO path's (8192 queries /
               16640-row table of LioConfig().map, k=8), plus k=16, a ragged
               N and an all-masked batch (the counts of tiles the kernel
               stages and of tiles with more rows than it stages are
               printed: both paths must run), exact ties, and maps of 27
               and 125 sub-voxels a row (the kernel's other code paths,
               checked, not timed);
               device times from torch.profiler, call times from CUDA
               events, and the bound from the bytes the inputs need; a
               launch the kernel refuses must raise;
  4. probe   — the two probe kernels (scale2, row_gather_sum) against their
               plain versions: scale2 at 256x128 and at 8192x4096 (larger
               than L2), timed in turns with `x * 2`, and on a misaligned
               view; row_gather_sum at the probe's
               defaults, at the association table's size (65,536 gathered
               768 B rows of a 16640-row table), on each row once, on 65,536
               copies of one row, on rows of 27 and 125 sub-voxels with
               indices outside the table, on a misaligned table, each timed
               against the plain version and the library call (and, where
               there are more indices than rows, with claims forced on and
               off), with its bound at the HBM rate and at the fastest L2
               gather rate measured here; claims on and off over a sweep of
               table sizes; on two streams at once, across the claim
               epoch's wrap and replayed in a CUDA graph, each alternating
               between two tables; then the probe's entry points (stage0,
               stage1) with the counts reset;
  5. main    — preset_aloam_kitti64 over HDL-64-scale (64x1800) scans made on
               the card by the port's simulator, through
               runtime.pipeline.process_scan: finite poses, the kernel
               launched 4 times per scan, healthy correspondence counts and
               residuals, ATE against the simulator's ground truth, scans/s
               (over the scans before the last, whose kernel calls are
               captured for phase 15), then the host syncs of each scan in a
               second, untimed run;
  6. cpu     — the same scans with CPU tensors, poses compared with the card's;
  7. lio     — LioConfig() over 64x1800 scans and 200 Hz exact IMU windows on
               bench.py's circle (radius 8 m, 0.25 rad/s, world seed 3), through
               runtime.lio_pipeline.process_lio_scan: finite state, the kernel
               launched once per scan plus once per re-probe, healthy matches
               and residuals, ATE against the circle, scans/s (as in 5), then stage
               times, host syncs, launches and the busy share over more scans;
  8. lio-cpu — the same LIO scans with CPU tensors, poses compared;
  9. slam    — runtime.slam_pipeline.SlamDriver (bench.py's slam headline:
               the odometry preset, a 1024-keyframe bank, 2048 edges, the
               default LoopConfig) over the main phase's scans: after 10
               scans close_loop_external(newest keyframe, 0) must be accepted
               (align_loop on the 25-keyframe full27 window, the pose-graph
               solve, both odometry maps rebuilt from the bank in 32 chunks),
               then 2 more scans must still track; the kernel 4 times a scan
               and never in the closure; finite poses and maps; ATE; the
               keyframe gate's margin at each scan; scans/s without the
               closure, the closure's stages (synchronized), and the host
               syncs of each scan in a second run with GPS fixes on three
               scans, equal to the main phase's;
 10. slam-cpu — the same with CPU tensors: poses, keyframe decisions where the
               gate's margin exceeds the pose tolerance, the closure's
               acceptance and fitness, the corrected keyframes;
 11. liosam  — runtime.liosam_pipeline.LioSamDriver (bench.py's liosam
               headline) over the LIO circle's 64x1800 sweeps kept as
               ScanGrids with their IMU windows: the kernel 4 times a scan,
               finite state, ATE, scans/s; then host syncs (only those of the
               solve and the map insert) and the stage split over more scans;
 12. liosam-cpu — the same sweeps with CPU tensors, poses compared;
 13. livox   — runtime.livox_pipeline.LivoxDriver (bench.py's livox headline:
               LivoxConfig(), init_frames 4) over the LIO circle's 64x1800
               sweeps with their IMU windows: LO for 4 sweeps, the MAP
               initialization, then the sliding-window LIO; engaged after
               the 4th sweep, the kernel on all three class maps, finite
               state, ATE (sweep-start ground truth), scans/s over the
               engaged sweeps, first-sweep and engagement ms; then the host
               syncs of each sweep (only the listed sites) and the stage
               split of the window sweep;
 14. livox-cpu — the same sweeps with CPU tensors: poses, the engagement and
               n_dropped equal, the card's ATE under 3x the CPU's; then
               IMU_Mode 1 (the gyro deskew) on the card and the CPU;
 15. path    — the octant-KNN kernel on the path's own inputs: the arguments
               of every call of the last odom, LIO and livox scans of
               phases 5, 7 and 13, captured there; each checked against the plain
               version, timed (device, plain, call with the wrapper), with its
               bound, its live queries, hits, distinct rows and rows read per
               tile, and the L2 figure: the hits' row bytes over the
               row-gather rate phase 4 measured with each row read once.
Then the kernels line, the card line, and as the last line
{"ok": true, "device": {...}}. Any failed check raises, so the script exits
non-zero and prints no last line. It needs a CUDA device and the repository
around it; it imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import dataclasses
import io
import json
import re
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

from agi_lidar_slam_torch import _build, preset_aloam_kitti64
from agi_lidar_slam_torch.config import MapConfig
from agi_lidar_slam_torch.estimators import ieskf, window_map
from agi_lidar_slam_torch.eval.metrics import ate_rmse
from agi_lidar_slam_torch.geometry import se3, so3
from agi_lidar_slam_torch.graph.keyframes import last_index, row
from agi_lidar_slam_torch.imu.eskf import NavState
from agi_lidar_slam_torch.map.hash_map import HashVoxelMap, empty_map, insert
from agi_lidar_slam_torch.map.planar import build_ktab
from agi_lidar_slam_torch.nn import octant_knn
from agi_lidar_slam_torch.pointcloud.cloud import ScanGrid
from agi_lidar_slam_torch.runtime import livox_pipeline, liosam_pipeline, slam_pipeline
from agi_lidar_slam_torch.runtime import lio_pipeline as lio
from agi_lidar_slam_torch.runtime.pipeline import init_state, process_scan
from agi_lidar_slam_torch.sim.trajectory import circle_imu, circle_pose, circle_velocity
from agi_lidar_slam_torch.sim.world import default_world, simulate_scan
from agi_lidar_slam_torch.tools import probe

SEED = 0
RINGS, WIDTH = 64, 1800  # KITTI HDL-64 scan scale
N_SCANS = 12
N_WARM = 2  # scans before the steady-state timing window
# ATE bound (m, no alignment) over the 12 scans of this trajectory (a 12 m
# path). Measured with CPU tensors on the same scans: 0.0097 m (host CPU of an
# NVIDIA H100 80GB HBM3 machine, card power limit 700.00 W; the card's run
# agreed to 2e-6 m). The bound leaves 3x room.
ATE_BOUND = 0.03
# LIO: bench.py's circle workload. ATE bound (m, no alignment, scan-end
# positions) over its 12 scans: 3x the ATE of the same run with CPU tensors
# on the card's host (see LIO_CPU_ATE).
LIO_RADIUS, LIO_OMEGA, LIO_SCAN_DT, LIO_IMU = 8.0, 0.25, 0.1, 20
# Measured with CPU tensors: 0.0041 m (host CPU of an NVIDIA H100 80GB HBM3
# machine, card power limit 700.00 W; the card's run agreed to 1e-5 m).
LIO_CPU_ATE = 0.0041
LIO_ATE_BOUND = 3 * LIO_CPU_ATE
LIO_MIN_MATCHES = 1000  # of the 8192-point budget, once the map exists
LIO_PROFILE_SCANS = 4  # steady scans under torch.profiler / sync counting / stage timing
# slam: the external closure comes after this many of the main phase's scans;
# GPS fixes go in with these scans of the sync-count run
SLAM_CLOSE_AFTER = 10
SLAM_GPS_SCANS = (2, 3, 6)
# ATE bounds of the pose-graph engines: 3x the ATE of the same run with CPU
# tensors (slam-cpu, liosam-cpu), measured on the host CPU of an NVIDIA H100
# 80GB HBM3 machine, card power limit 700.00 W (the card's runs agreed to
# 2e-6 m)
SLAM_CPU_ATE = 0.0108
SLAM_ATE_BOUND = 3 * SLAM_CPU_ATE
LIOSAM_CPU_ATE = 0.0033
LIOSAM_ATE_BOUND = 3 * LIOSAM_CPU_ATE
# livox: bench.py's init_frames; engaged sweeps timed in the stage split; the
# IMU_Mode 1 sweeps compared between card and CPU
LIVOX_INIT_FRAMES = 4
LIVOX_STAGE_SCANS = 2
LIVOX_MODE1_SCANS = 4
# kernel vs plain version: the tolerances of tests/test_vmem_knn.py (one ulp
# of distance evaluation order; points are copied, so exact in practice)
SQ_TOL, PTS_TOL = 3e-6, 1e-5
# row_gather_sum vs its plain version: on the probe's tables (B=64, all terms
# positive) two f32 summation orders of the 64 terms differ by at most
# 2 (log2 B + 2) 2**-24 for tree-like orders (the kernel's: 4 terms a lane in
# turn, then a 4-level tree); the tables of 27 and 125 sub-voxels hold whole
# numbers with sums exact in f32, so there any error is a fault
GATHER_RTOL = 1e-6
# card vs CPU poses over the run (f32 reductions in another order)
POSE_T_TOL, POSE_Q_TOL = 1e-3, 1e-3
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S, F32_FLOPS = 3.35e12, 67e12


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 25) -> float:
    """Median milliseconds of fn() over `reps` runs, CUDA events around each."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def device_ms(fn, reps: int = 20) -> float | None:
    """Device time (ms) of one fn() call: every kernel, copy and fill it puts
    on the card, summed by torch.profiler over `reps` calls. None if the
    profiler recorded no device activity (then it is not measured).

    cuda_ms times a call from the host's side: for a kernel this short that
    is mostly the wrapper's host work, so this is the kernel's own time."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.device_time_total for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and not getattr(e, "is_user_annotation", False))
    return us / 1e3 / reps if us > 0 else None


def bound(n_bytes: float, flops: float) -> tuple[float, str]:
    """The least time (ms) the card could take: the larger of bytes over the
    HBM rate and operations over the f32 rate, and which one it is."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def knn_bound(m, queries, qmask, k, cfg, ktab) -> tuple[float, str]:
    """Bound of one octant-KNN call on these inputs: the queries, mask and
    outputs, each distinct probe-window entry of the packed-key index and
    each distinct map row the live queries hit (points + occupancy), read
    once; 8 flops (3 sub, 3 mul, 2 add) per candidate of a hit row."""
    qk, qh = octant_knn.octant_probe_keys(queries, cfg)
    live = qmask[:, None].expand_as(qh)
    win = qh[..., None].long() + torch.arange(cfg.probes, device=qh.device)
    n_win = int(torch.unique(win[live]).numel())
    match = ktab[win] == qk[..., None]
    rows = win[match & live[..., None]]
    n_rows = int(torch.unique(rows).numel())
    B = m.bucket
    n_bytes = (queries.numel() * 4 + qmask.numel() + n_win * 4 + n_rows * B * (12 + 1)
               + queries.shape[0] * k * (4 + 12 + 1))
    return bound(n_bytes, 8.0 * int(rows.numel()) * B)


def launch_shape(bucket: int) -> tuple[int, int, int]:
    """The octant kernel's launch for rows of `bucket` sub-voxels, as its
    launcher chooses it: (queries per tile, staged rows, shared-memory bytes
    per CTA)."""
    vals = [ctypes.c_int(0) for _ in range(3)]
    err = _build.load().octant_knn_launch_shape(bucket, *(ctypes.byref(v) for v in vals))
    if err != 0:
        raise RuntimeError(f"octant_knn_launch_shape({bucket}) failed: cudaError {err}")
    return tuple(v.value for v in vals)


def sharing(m, queries, qmask, cfg, ktab) -> dict:
    """How the live queries' (query, octant) hits share map rows: live
    queries, hits, distinct rows, the rows read by the kernel's tiles of
    consecutive queries (each distinct row of a tile once), the most in one
    tile, the tiles with hits whose rows the kernel stages, and those whose
    distinct rows exceed the rows it stages: it stages none of those and
    reads their rows from global memory."""
    tile_q, stage_rows, _ = launch_shape(m.bucket)
    qk, qh = octant_knn.octant_probe_keys(queries, cfg)
    win = qh[..., None].long() + torch.arange(cfg.probes, device=qh.device)
    match = (ktab[win] == qk[..., None]) & qmask[:, None, None]
    row = torch.where(match, win, torch.full_like(win, -1)).amax(dim=-1)  # last match
    hit = row >= 0
    tile = (torch.arange(queries.shape[0], device=row.device) // tile_q)[:, None]
    keys = torch.unique((tile * m.n_rows + row)[hit])
    per_tile = torch.bincount(keys // m.n_rows)
    return {"live": int(qmask.sum()), "hits": int(hit.sum()),
            "distinct_rows": int(torch.unique(row[hit]).numel()),
            "tile_rows": int(keys.numel()),
            "max_tile_rows": int(per_tile.max()) if keys.numel() else 0,
            "tiles_staged": int(((per_tile > 0) & (per_tile <= stage_rows)).sum()),
            "tiles_over_stage_rows": int((per_tile > stage_rows).sum()),
            "tile": tile_q, "stage_rows": stage_rows}


@contextlib.contextmanager
def counted_syncs(per_call: list, sites: collections.Counter):
    """While open, count the host syncs on the card (sync debug mode warns at
    every synchronizing call): appends the count to `per_call` and adds each
    call's package-relative file:line to `sites`."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode("default")
    hits = [w for w in caught if "synchroniz" in str(w.message)]
    per_call.append(len(hits))
    sites.update(f"{w.filename.split('agi_lidar_slam_torch/')[-1]}:{w.lineno}" for w in hits)


@contextlib.contextmanager
def captured_knn_calls(calls: list):
    """While open, record a copy of the arguments of every
    octant_knn.knn_octant call (map, queries, mask, k, config, ktab)."""
    real = octant_knn.knn_octant

    def wrapper(m, queries, qmask, k, cfg, ktab=None):
        kt = build_ktab(m) if ktab is None else ktab
        calls.append((HashVoxelMap(*(t.clone() for t in m)), queries.clone(), qmask.clone(), k,
                      cfg, kt.clone()))
        return real(m, queries, qmask, k, cfg, ktab=ktab)

    octant_knn.knn_octant = wrapper
    try:
        yield calls
    finally:
        octant_knn.knn_octant = real


def filled_map(cfg, n_points: int, rng: np.random.Generator, device):
    """A HashVoxelMap filled with uniform points around the origin."""
    pts = rng.uniform([-25, -25, -2], [25, 25, 5], (n_points, 3)).astype(np.float32)
    return insert(empty_map(cfg, device), torch.from_numpy(pts).to(device),
                  torch.ones(n_points, dtype=torch.bool, device=device), cfg)


def ties_case(mcfg, device) -> None:
    """Map points at sub-voxel centres and queries at sub-voxel corners: each
    query has 8 nearest points at exactly the same f32 distance (and more
    ties further out), so the order comes from the tie rule alone. The
    kernel must equal the plain version exactly at k = 8 and k = 16."""
    h = mcfg.sub_voxel
    g = torch.arange(-8, 8, dtype=torch.float32, device=device)
    pts = torch.stack(torch.meshgrid(g, g, g[6:10], indexing="ij"), dim=-1).reshape(-1, 3) * h
    m = insert(empty_map(mcfg, device), pts + h / 2,
               torch.ones(pts.shape[0], dtype=torch.bool, device=device), mcfg)
    q = torch.stack(torch.meshgrid(g[3:-3], g[3:-3], g[7:9], indexing="ij"), dim=-1)
    q = (q.reshape(-1, 3) * h).contiguous()
    qm = torch.ones(q.shape[0], dtype=torch.bool, device=device)
    ktab = build_ktab(m)
    for k in (8, 16):
        sq, p, valid = octant_knn.knn_octant(m, q, qm, k, mcfg, ktab=ktab)
        rsq, rp, rvalid = octant_knn.knn_octant_ref(m, q, qm, k, mcfg, ktab=ktab)
        torch.cuda.synchronize()
        if not (torch.equal(valid, rvalid) and torch.equal(sq, rsq) and torch.equal(p, rp)):
            raise AssertionError(f"ties k={k}: the kernel breaks ties unlike its plain version")
        tied = int((sq[:, 1:] == sq[:, :-1])[valid[:, 1:]].sum())
        log(f"kernel ties: {q.shape[0]} queries at sub-voxel corners, k={k}: {tied} tied "
            f"neighbour pairs, valid[:,0]={float(valid[:, 0].float().mean()):.3f}, exact OK")
        if tied == 0:
            raise AssertionError("the ties case has no tied distances")


def phase_kernel(device) -> dict:
    cfg = preset_aloam_kitti64()
    lio_map = lio.LioConfig().map
    rng = np.random.default_rng(SEED)
    # name: (map config, map, queries of the path, k of the path)
    maps = {"corner": (cfg.corner_map, filled_map(cfg.corner_map, 40000, rng, device),
                       cfg.features.max_corners, 5),
            "surf": (cfg.surf_map, filled_map(cfg.surf_map, 80000, rng, device),
                     cfg.features.max_surfs, 5),
            "lio": (lio_map, filled_map(lio_map, 80000, rng, device),
                    lio.LioConfig().max_scan_pts, lio.LioConfig().ieskf.cand_k)}
    # the kernel's other code paths, checked but not timed: rows of 27
    # sub-voxels (not a multiple of 16, so staged without cp.async) and of 125
    # (the instance for rows of more than two sub-voxels a lane)
    for block_sub in (3, 5):
        mcfg = MapConfig(sub_voxel=0.5, block_sub=block_sub, log2_slots=13)
        maps[f"bucket{mcfg.bucket}"] = (mcfg, filled_map(mcfg, 20000, rng, device), None, 5)
    max_err = 0.0
    staged = over = 0  # tiles of all cases the kernel staged, and did not
    timing = {}
    for name, (mcfg, m, n_path, k_path) in maps.items():
        ktab = build_ktab(m)
        rows = m.n_rows
        cases = ([(n_path, k_path, 0.2), (n_path, 16, 0.2), (1001, 5, 0.2), (n_path, k_path, 1.0)]
                 if n_path else [(1001, 5, 0.2), (1001, 16, 0.2)])
        for n, k, masked in cases:
            q = torch.from_numpy(rng.uniform([-26, -26, -3], [26, 26, 6], (n, 3))
                                 .astype(np.float32)).to(device)
            qm = torch.from_numpy(rng.uniform(size=n) >= masked).to(device)
            sq, pts, valid = octant_knn.knn_octant(m, q, qm, k, mcfg, ktab=ktab)
            rsq, rpts, rvalid = octant_knn.knn_octant_ref(m, q, qm, k, mcfg, ktab=ktab)
            torch.cuda.synchronize()
            if not torch.equal(valid, rvalid):
                raise AssertionError(f"{name} n={n} k={k}: valid differs in "
                                     f"{int((valid != rvalid).sum())} entries")
            if masked == 1.0 and bool(valid.any()):
                raise AssertionError("all-masked batch returned neighbours")
            torch.testing.assert_close(sq, rsq, rtol=SQ_TOL, atol=SQ_TOL)
            torch.testing.assert_close(pts, rpts, rtol=PTS_TOL, atol=PTS_TOL)
            err = 0.0
            if bool(rvalid.any()):
                err = max(float((sq - rsq)[rvalid].abs().max()),
                          float((pts - rpts)[rvalid].abs().max()))
            max_err = max(max_err, err)
            sh = sharing(m, q, qm, mcfg, ktab)
            staged += sh["tiles_staged"]
            over += sh["tiles_over_stage_rows"]
            log(f"kernel {name}: rows={rows} n={n} k={k} masked={masked:.0%} "
                f"valid[:,0]={float(valid[:, 0].float().mean()):.3f} "
                f"max_abs_err={err:.3g} OK; tiles of {sh['tile']} queries: "
                f"{sh['tiles_staged']} staged, {sh['tiles_over_stage_rows']} with more rows "
                f"than the {sh['stage_rows']} it stages (most in a tile {sh['max_tile_rows']})")
        if n_path is None:
            continue
        q = torch.from_numpy(rng.uniform([-26, -26, -3], [26, 26, 6], (n_path, 3))
                             .astype(np.float32)).to(device)
        qm = torch.from_numpy(rng.uniform(size=n_path) >= 0.2).to(device)

        def kern_call():
            return octant_knn.knn_octant(m, q, qm, k_path, mcfg, ktab=ktab)

        def plain_call():
            return octant_knn.knn_octant_ref(m, q, qm, k_path, mcfg, ktab=ktab)

        ms, plain_ms = cuda_ms(kern_call), cuda_ms(plain_call)
        dev_ms, plain_dev_ms = device_ms(kern_call), device_ms(plain_call)
        bound_ms, bound_by = knn_bound(m, q, qm, k_path, mcfg, ktab)
        timing[name] = {"queries": n_path, "rows": rows, "k": k_path, "call_ms": ms,
                        "plain_call_ms": plain_ms, "device_ms": dev_ms,
                        "plain_device_ms": plain_dev_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by}
        log(f"kernel {name} timing: n={n_path} rows={rows} k={k_path} per call kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms (median of 25, CUDA events); device "
            f"time kernel {dev_ms} ms, plain {plain_dev_ms} ms (torch.profiler, mean of 20 "
            f"calls; None: not measured); bound {bound_ms:.5f} ms ({bound_by})")

    log(f"kernel: {staged} tiles staged, {over} read from global memory, all exact")
    if staged == 0 or over == 0:
        raise AssertionError("the synthetic cases did not run both the staged and the "
                             "unstaged tiles")
    ties_case(lio_map, device)
    # a launch the kernel refuses (k above MAX_K) must raise
    m = maps["corner"][1]
    try:
        octant_knn._launch(m, torch.zeros((8, 3), device=device),
                           torch.ones(8, dtype=torch.bool, device=device), 17,
                           cfg.corner_map, build_ktab(m))
    except RuntimeError as e:
        log(f"kernel: a refused launch raises: {e}")
    else:
        raise AssertionError("a refused kernel launch did not raise")
    return {"max_abs_err": max_err, "timing": timing}


def gather_err(label: str, got: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    """(max abs, max relative error) of the kernel's row sums against the
    plain version's; NaN must stand in the same places, and the relative
    error must be within GATHER_RTOL."""
    torch.cuda.synchronize()
    nan = torch.isnan(ref)
    if not torch.equal(torch.isnan(got), nan):
        raise AssertionError(f"row_gather_sum {label}: NaN in other places than the plain "
                             f"version ({int((torch.isnan(got) != nan).sum())} entries)")
    d = (got - ref)[~nan].abs()
    rel = float((d / ref[~nan].abs()).max()) if d.numel() else 0.0
    if not rel <= GATHER_RTOL:
        raise AssertionError(f"row_gather_sum {label}: relative error {rel} > {GATHER_RTOL}")
    return (float(d.max()) if d.numel() else 0.0), rel


def gather_inputs(device) -> dict:
    """name: (src, idx) of each row-gather case: the probe's defaults; the
    association table's size (65,536 indices into 16,640 rows of 768 B, each
    row about 3.9 times); each row once (a permutation: the L2 gather rate);
    65,536 copies of one row (the most contended claim); rows of 27 and 125
    sub-voxels with indices outside the table (4-byte loads, with and without
    claims); the association table's case on a table 4 bytes past a 16-byte
    boundary."""
    cases = {"probe_defaults": probe.probe_inputs(64, 64, 4096, 8, device),
             "map_table": probe.probe_inputs(64, 64, 16640, 1024, device),
             "distinct": probe.distinct_inputs(seed=SEED, device=device),
             "one_row": probe.one_row_inputs(seed=SEED, device=device),
             "bucket27": probe.bucket_inputs(27, 2000, 8192, seed=SEED, device=device),
             "bucket125": probe.bucket_inputs(125, 4000, 2000, seed=SEED + 1, device=device)}
    src, idx = cases["map_table"]
    base = torch.empty(src.numel() + 1, device=device)
    view = base[1:].view(src.shape)
    view.copy_(src)
    if view.data_ptr() % 16 != 4:
        raise AssertionError("the misaligned case's table is not 4 bytes past a boundary")
    cases["misaligned"] = (view, idx)
    return cases


def gather_cases(device) -> dict:
    """row_gather_sum on each case of gather_inputs against its plain version
    (held at GATHER_RTOL, NaN in the same places), with device times of the
    kernel, the plain version and, where every index is in the table, the
    library call `src[idx].sum(1)`; where there are more indices than rows
    also the kernel with claims forced on and off, whichever the wrapper
    takes. Two bounds: `bound_ms`, the bytes over the HBM rate (a first
    touch), and `l2_bound_ms`, the bytes over the faster of two gathers
    without claims measured here, `distinct` and `map_table` (rows far apart,
    so served by L2, where every case's table stays between the timed calls;
    a measured rate, so a lower bound on the L2's; `one_row`'s copies come
    from L1 and are left out)."""
    out = {}
    for label, (src, idx) in gather_inputs(device).items():
        n, rows, B = idx.shape[0], src.shape[0], src.shape[1]
        got, ref = probe.row_gather_sum(idx, src), probe.row_gather_sum_ref(idx, src)
        max_abs, rel = gather_err(label, got, ref)
        ok = (idx >= 0) & (idx < rows)
        in_table = bool(ok.all())
        nb = probe.gather_bytes(idx, src)
        b_ms, b_by = bound(nb, n * B * 3)
        rec = {"gathered_rows": n, "rows": rows, "B": B,
               "distinct_rows": int(torch.unique(idx[ok]).numel()),
               "claims": probe.claims_pay(n, rows, B, src.data_ptr() % 16 == 0, False),
               "table_MB": rows * B * 12 / 1e6, "gathered_MB": n * B * 12 / 1e6,
               "bound_bytes": nb, "max_abs_err": max_abs, "max_rel_err": rel,
               "ms": device_ms(lambda: probe.row_gather_sum(idx, src)),
               "plain_ms": device_ms(lambda: probe.row_gather_sum_ref(idx, src)),
               "library_ms": (device_ms(lambda: src[idx.long()].sum(1)) if in_table else None),
               "call_ms": probe.chained_ms(lambda: probe.row_gather_sum(idx, src)),
               "bound_ms": b_ms, "bound_by": b_by}
        rec["no_claims_ms"] = rec["ms"]
        if n > rows:
            for mode in (True, False):
                gather_err(f"{label} (claims {mode})", probe._row_gather(idx, src, mode), ref)
                rec[f"{'' if mode else 'no_'}claims_ms"] = device_ms(
                    lambda: probe._row_gather(idx, src, mode))
        for key in ("ms", "plain_ms", "library_ms", "no_claims_ms"):
            if rec.get(key) is not None:
                rec[key[:-2] + "GB_per_s"] = n * B * 12 / (rec[key] * 1e6)
        rec["share_of_bound"] = b_ms / rec["ms"] if rec["ms"] else None
        rec["ns_per_row"] = rec["ms"] * 1e6 / n if rec["ms"] else None
        out[label] = rec
        log(f"probe row_gather_sum {label} (n={n} rows={rows} B={B}): max rel err {rel:.3g}, "
            f"NaN in place; {rec}")
    l2_gbs, l2_case = max((out[label]["no_claims_GB_per_s"], label)
                          for label in ("map_table", "distinct"))
    for r in out.values():
        r["l2_bound_ms"] = r["bound_bytes"] / (l2_gbs * 1e6)
        r["share_of_l2_bound"] = r["l2_bound_ms"] / r["ms"] if r["ms"] else None
    log(f"probe row_gather_sum: L2 gather rate {l2_gbs:.1f} GB/s (the {l2_case} case without "
        "claims); shares of the L2 bound " + ", ".join(
            f"{label} {r['share_of_l2_bound']:.3f}" for label, r in out.items()
            if r["share_of_l2_bound"]))
    for label in ("probe_defaults", "one_row"):  # the kernel must beat the library call
        r = out[label]
        if r["ms"] and r["library_ms"] and not r["ms"] <= r["library_ms"]:
            raise AssertionError(f"row_gather_sum {label}: {r['ms']} ms, above the library "
                                 f"call's {r['library_ms']} ms")
    return out, {"GB_per_s": l2_gbs, "case": l2_case}


def gather_claims_sweep(device) -> list:
    """Claims forced on and off where they could pay (more indices than rows),
    on the probe's access pattern (each row gathered `repeats` times) over
    tables of 64 sub-voxels a row (16-byte loads) and 27 (4-byte loads) from
    1024 to 32768 rows: both checked, both timed, and whether the wrapper's
    choice (claims_pay) was the faster. The thresholds CLAIM_MIN_BYTES are
    read from these numbers."""
    points = [(64, rows, 4) for rows in (1024, 2048, 4096, 8192, 12288, 16640)]
    points += [(64, 16640, 2)] + [(27, rows, 4) for rows in (2048, 4096, 6144, 8192, 16384,
                                                              32768)]
    out = []
    for B, rows, repeats in points:
        src, idx = probe.probe_inputs(64, B, rows, rows * repeats // 64, device)
        ref = probe.row_gather_sum_ref(idx, src)
        ms = {}
        for mode in (True, False):
            gather_err(f"sweep B={B} rows={rows} claims {mode}",
                       probe._row_gather(idx, src, mode), ref)
            ms[mode] = device_ms(lambda: probe._row_gather(idx, src, mode))
        pick = probe.claims_pay(idx.shape[0], rows, B, True, False)
        out.append({"B": B, "rows": rows, "repeats": repeats,
                    "gathered_MB": idx.shape[0] * B * 12 / 2**20, "claims_ms": ms[True],
                    "no_claims_ms": ms[False], "wrapper_claims": pick,
                    "wrapper_faster": (ms[pick] <= ms[not pick]) if None not in ms.values()
                    else None})
    log(f"probe row_gather_sum claims sweep: {out}")
    return out


def _two_tables(device):
    """The association table's case and a second table of its shape whose row
    sums all differ from the first's: launches that alternate between them on
    one claim scratch return a wrong sum if a stale published word is read."""
    src, idx = probe.probe_inputs(64, 64, 16640, 1024, device)
    if not probe.claims_pay(idx.shape[0], src.shape[0], src.shape[1], True, False):
        raise AssertionError("the wrapper does not claim rows at the association table's case")
    return (src, -src), idx


def gather_two_streams(device, rounds: int = 10) -> dict:
    """Launches on two streams at once, each stream with its own claim
    scratch and alternating between two tables: every result equals the
    plain version. The launches are counted by the wrapper's counter."""
    tables, idx = _two_tables(device)
    idx2 = idx.flip(0).contiguous()
    streams = [torch.cuda.Stream(device), torch.cuda.Stream(device)]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream(device))
    before = probe.launches["row_gather_sum"]
    results = []
    for r in range(rounds):
        for j, (st, ix) in enumerate(zip(streams, (idx, idx2))):
            src = tables[(r + j) % 2]
            with torch.cuda.stream(st):
                results.append((ix, src, probe.row_gather_sum(ix, src)))
    torch.cuda.synchronize()
    launched = probe.launches["row_gather_sum"] - before
    worst = max(gather_err("two streams", got, probe.row_gather_sum_ref(ix, src))[1]
                for ix, src, got in results)
    keys = [k for k in probe._scratch if k[1] in {st.cuda_stream for st in streams}]
    if len(keys) != 2:
        raise AssertionError(f"two streams shared claim scratch: {keys}")
    log(f"probe row_gather_sum two streams, two tables in turn: {launched} launches, "
        f"max rel err {worst:.3g}")
    return {"launches": launched, "max_rel_err": worst}


def gather_epoch_wrap(device) -> dict:
    """Launches across the wrap of the claim epoch (the wrapper zeroes the
    tags and starts again at 1), with the limit lowered to reach it and the
    two tables in turn: every result equals the plain version."""
    tables, idx = _two_tables(device)
    refs = [probe.row_gather_sum_ref(idx, src) for src in tables]
    probe.row_gather_sum(idx, tables[0])
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    saved, epochs = probe.EPOCH_LIMIT, []
    probe.EPOCH_LIMIT = probe._scratch[key][2] + 3
    try:
        for j in range(1, 7):
            gather_err("epoch wrap", probe.row_gather_sum(idx, tables[j % 2]), refs[j % 2])
            epochs.append(probe._scratch[key][2])
    finally:
        probe.EPOCH_LIMIT = saved
    if 1 not in epochs:
        raise AssertionError(f"the claim epoch did not wrap: {epochs}")
    log(f"probe row_gather_sum across the epoch wrap, two tables in turn: epochs {epochs}, "
        "all equal")
    return {"epochs": epochs}


def gather_graph(device) -> dict:
    """The gather captured in a CUDA graph (where the wrapper does not claim
    rows) and replayed on each of the two tables copied into its input:
    every replay equals the plain version on the table of that replay."""
    tables, idx = _two_tables(device)
    static = tables[0].clone()
    probe.row_gather_sum(idx, static)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = probe.row_gather_sum(idx, static)
    worst = 0.0
    for src in (*tables, tables[0]):
        static.copy_(src)
        graph.replay()
        worst = max(worst, gather_err("graph replay", got, probe.row_gather_sum_ref(idx, src))[1])
    log(f"probe row_gather_sum in a CUDA graph: 3 replays on two tables, max rel err {worst:.3g}")
    return {"replays": 3, "max_rel_err": worst}


def phase_probe(device) -> dict:
    """The probe kernels against their plain versions and the library calls,
    then the probe's entry points with the launch counts reset."""
    out = {"scale2": {}}
    gen = torch.Generator(device).manual_seed(SEED)
    for shape in [(256, 128), (8192, 4096)]:  # the probe's shape; 128 MB, larger than L2
        x = torch.randn(shape, generator=gen, device=device)
        label = f"{shape[0]}x{shape[1]}"
        o = probe.scale2(x)
        torch.cuda.synchronize()
        if not torch.equal(o, probe.scale2_ref(x)):
            raise AssertionError(f"scale2 {label} disagrees with its plain version")
        b_ms, b_by = bound(2 * x.numel() * 4, x.numel())
        # the kernel and the library call in turns (kernel, library, library,
        # kernel, ...), each the mean of its three device times
        turns = {"ms": [], "library_ms": []}
        for who in ("ms", "library_ms", "library_ms", "ms", "ms", "library_ms"):
            turns[who].append(device_ms(lambda: probe.scale2(x)) if who == "ms"
                              else device_ms(lambda: x * 2))
        rec = {key: (sum(v) / len(v) if None not in v else None) for key, v in turns.items()}
        rec.update({"turns": turns, "plain_ms": device_ms(lambda: probe.scale2_ref(x)),
                    "call_ms": probe.chained_ms(lambda: probe.scale2(x)),
                    "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": 0.0})
        rec["share_of_bound"] = b_ms / rec["ms"] if rec["ms"] else None
        out["scale2"][label] = rec
        log(f"probe scale2 {label}: exact; {rec}")
    tail = x.reshape(-1)[1:1003]  # 4 bytes past a 16-byte boundary: one element per thread
    if not torch.equal(probe.scale2(tail), probe.scale2_ref(tail)):
        raise AssertionError("scale2 on a misaligned view disagrees with its plain version")
    del x, o
    log("probe scale2: a misaligned 1002-element view is exact")

    out["row_gather_sum"], out["row_gather_l2_rate"] = gather_cases(device)
    out["row_gather_claims_sweep"] = gather_claims_sweep(device)
    out["row_gather_two_streams"] = gather_two_streams(device)
    out["row_gather_epoch_wrap"] = gather_epoch_wrap(device)
    out["row_gather_graph"] = gather_graph(device)

    torch.cuda.empty_cache()
    probe.launches.update(scale2=0, row_gather_sum=0)
    s0 = probe.stage0(device)
    s1 = probe.stage1(device=device)
    s2 = probe.stage2(device=device)
    out["launches"] = dict(probe.launches)
    log(f"probe stage0: {s0}")
    log(f"probe stage1: {s1}")
    log(f"probe stage2: {s2}")
    log(f"probe: launches on the probe path {out['launches']}")
    if min(out["launches"].values()) == 0:
        raise AssertionError(f"a probe kernel was not launched: {out['launches']}")
    out["stages"] = {"stage0": s0, "stage1": s1, "stage2": s2}
    return out


def step_pose(device) -> se3.Pose:
    """The trajectory's per-scan motion, bench.py's arc: 1 m forward and
    0.01 rad of yaw per scan (10 m/s at 10 Hz)."""
    return se3.Pose(so3.quat_exp(torch.tensor([0.0, 0.0, 0.01], device=device)),
                    torch.tensor([1.0, 0.0, 0.0], device=device))


def make_scans(device):
    """HDL-64-scale scans along the arc, made on `device` from SEED, and the
    ground-truth position at each sweep start."""
    world = default_world(seed=SEED, n_pillars=48, extent=35.0, device=device)
    step = step_pose(device)
    pose = se3.Pose.identity(device=device)
    scans, gt = [], []
    for i in range(N_SCANS):
        nxt = se3.compose(pose, step)
        scans.append(simulate_scan(world, pose, nxt, rings=RINGS, width=WIDTH,
                                   fov_up_deg=2.0, fov_down_deg=-24.8, max_range=80.0,
                                   noise_std=0.01, seed=i))
        gt.append(pose.t.cpu().numpy())
        pose = nxt
    return scans, np.stack(gt)


def moving_start(cfg, device):
    """init_state with the trajectory's velocity as its constant-velocity
    prior: the sensor was already moving when the engine started. This preset
    has no scan-to-scan stage, and from rest neither the port nor the JAX
    reference recovers a 1 m first step (the x axis stays unobserved at that
    offset), so a run from rest measures that, not the engine's tracking."""
    state = init_state(cfg, device)
    back = se3.inverse(step_pose(device))
    pose = se3.compose(state.pose, back)
    return state._replace(pose=pose, prev_pose=se3.compose(pose, back))


def phase_main(device) -> dict:
    cfg = preset_aloam_kitti64()
    scans, gt = make_scans(device)
    state = moving_start(cfg, device)
    torch.cuda.synchronize()
    results, marks, calls = [], [torch.cuda.Event(enable_timing=True)], []
    octant_knn.launches = 0
    marks[0].record()
    for i, s in enumerate(scans):
        with (captured_knn_calls(calls) if i == N_SCANS - 1 else contextlib.nullcontext()):
            state, res = process_scan(state, s, cfg)
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()
        torch.cuda.synchronize()
        results.append(res)
    launches = octant_knn.launches
    first_ms = marks[0].elapsed_time(marks[1])
    # the last scan copies its kernel calls' arguments: outside the window
    steady = (N_SCANS - 1 - N_WARM) * 1e3 / marks[N_WARM].elapsed_time(marks[-2])

    if launches != 4 * N_SCANS:
        raise AssertionError(f"octant KNN launched {launches} times, expected {4 * N_SCANS}")
    est = np.stack([r.pose.t.cpu().numpy() for r in results])
    quats = np.stack([r.pose.q.cpu().numpy() for r in results])
    if not (np.all(np.isfinite(est)) and np.all(np.isfinite(quats))):
        raise AssertionError("non-finite pose")
    n_surf = [int(r.stats.n_surf) for r in results]
    n_corner = [int(r.stats.n_corner) for r in results]
    rms = [float(r.stats.rms) for r in results]
    log(f"main: {N_SCANS} scans {RINGS}x{WIDTH} points/scan={int(scans[0].mask.sum())} "
        f"octant_knn launches={launches} n_corner={n_corner} n_surf={n_surf}")
    if min(n_surf[1:]) < 100:
        raise AssertionError(f"too few surf correspondences once the map exists: {n_surf}")
    if max(rms[1:]) >= 0.1:
        raise AssertionError(f"residual rms too high: {rms}")
    ate = ate_rmse(est, gt, align=False)
    log(f"main: rms={[round(x, 4) for x in rms]} ATE={ate:.4f} m (bound {ATE_BOUND})")
    if not ate < ATE_BOUND:
        raise AssertionError(f"ATE {ate:.4f} m above the bound {ATE_BOUND} m")
    log(f"main: first scan {first_ms:.1f} ms; steady {steady:.2f} scans/s over "
        f"scans {N_WARM}..{N_SCANS - 2} (CUDA events between synchronized scans)")
    # the host syncs of the same run again, counted apart from the timing
    syncs, sync_sites = [], collections.Counter()
    state = moving_start(cfg, device)
    for s in scans:
        with counted_syncs(syncs, sync_sites):
            state, _ = process_scan(state, s, cfg)
    log(f"main: host syncs per scan {syncs} (sync debug mode); by call site: "
        f"{dict(sync_sites.most_common())}")
    return {"launches": launches, "scans": scans, "gt": gt, "results": results, "ate": ate,
            "scans_per_s": steady, "calls": calls, "syncs": syncs,
            "sync_sites": dict(sync_sites)}


def phase_cpu(main: dict) -> None:
    """The same scans with CPU tensors (the kernel's plain version on the
    whole path); poses must agree with the card's."""
    cfg = preset_aloam_kitti64()
    state = moving_start(cfg, "cpu")
    worst_t = worst_q = 0.0
    est = []
    for s, gpu in zip(main["scans"], main["results"]):
        state, res = process_scan(state, ScanGrid(*(a.cpu() for a in s)), cfg)
        est.append(res.pose.t.numpy())
        worst_t = max(worst_t, float((res.pose.t - gpu.pose.t.cpu()).abs().max()))
        worst_q = max(worst_q, float((res.pose.q - gpu.pose.q.cpu()).abs().max()))
    ate = ate_rmse(np.stack(est), main["gt"], align=False)
    log(f"cpu: {len(est)} scans with CPU tensors: ATE={ate:.4f} m; against the card "
        f"max |dt|={worst_t:.3g} m, max |dq|={worst_q:.3g}")
    if worst_t > POSE_T_TOL or worst_q > POSE_Q_TOL:
        raise AssertionError("card and CPU poses disagree")


def lio_sweeps(n_scans: int, device):
    """bench.py's LIO workload made on `device`: 64x1800 ScanGrids along the
    circle (world seed 3, 48 pillars, extent 35 m, 10 Hz), exact 200 Hz IMU
    windows, and the scan-end ground-truth positions."""
    world = default_world(seed=3, n_pillars=48, extent=35.0, device=device)
    sweeps, gt = [], []
    for i in range(n_scans):
        t0, t1 = i * LIO_SCAN_DT, (i + 1) * LIO_SCAN_DT
        p0 = circle_pose(t0, LIO_RADIUS, LIO_OMEGA, device=device)
        p1 = circle_pose(t1, LIO_RADIUS, LIO_OMEGA, device=device)
        s = simulate_scan(world, p0, p1, rings=RINGS, width=WIDTH, fov_up_deg=2.0,
                          fov_down_deg=-24.8, max_range=80.0, noise_std=0.01, seed=i)
        ts = t0 + (torch.arange(LIO_IMU, device=device) + 0.5) * (LIO_SCAN_DT / LIO_IMU)
        gy, ac = circle_imu(ts, LIO_RADIUS, LIO_OMEGA)
        win = lio.ImuWindow(gy, ac, torch.full((LIO_IMU,), LIO_SCAN_DT / LIO_IMU, device=device),
                            torch.ones(LIO_IMU, dtype=torch.bool, device=device))
        sweeps.append((s, win))
        gt.append(p1.t.cpu().numpy())
    return sweeps, np.stack(gt)


def make_lio_inputs(n_scans: int, device):
    """lio_sweeps' scans flattened to (115200,) points with per-point seconds,
    as the LIO engine takes them."""
    sweeps, gt = lio_sweeps(n_scans, device)
    return [(s.xyz.reshape(-1, 3), (s.time * LIO_SCAN_DT).reshape(-1), s.mask.reshape(-1), win)
            for s, win in sweeps], gt


def lio_start(cfg, device):
    x0 = NavState.identity(device)._replace(
        v=circle_velocity(0.0, LIO_RADIUS, LIO_OMEGA, device=device))
    return lio.init_lio_state(cfg, x0, device=device)


def _finite(state) -> bool:
    return all(bool(torch.isfinite(a).all()) for a in (*state.x, state.P))


@contextlib.contextmanager
def synchronized_stages(times: dict, targets=None):
    """Time a step's stages on the host clock with the card synchronized
    around each: the module-level functions `targets` ((module, name) pairs;
    by default the LIO step's and the IESKF's) are wrapped while the context
    is open, and each call's ms appended to times[name]."""
    targets = targets or [
        (lio, "_propagate_window"), (lio, "undistort_to_end"), (lio, "voxel_downsample"),
        (lio, "update_iterated"), (lio, "insert_with_stats"), (lio, "bound_map"),
        (ieskf, "knn_cand"), (ieskf, "_h_model"), (ieskf, "_ktab")]
    saved = [(mod, name, getattr(mod, name)) for mod, name in targets]

    def timed(name, fn):
        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn(*a, **kw)
            torch.cuda.synchronize()
            times.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
            return r
        return wrapper

    for mod, name, fn in saved:
        setattr(mod, name, timed(name, fn))
    try:
        yield times
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def phase_lio(device) -> dict:
    cfg = lio.LioConfig()
    n_total = N_SCANS + 3 * LIO_PROFILE_SCANS
    items, gt = make_lio_inputs(n_total, device)
    state = lio_start(cfg, device)
    torch.cuda.synchronize()
    results, per_scan, marks = [], [], [torch.cuda.Event(enable_timing=True)]
    knn_calls = []
    octant_knn.launches = 0
    marks[0].record()
    for i, (pts, tt, m, win) in enumerate(items[:N_SCANS]):
        before = octant_knn.launches
        with (captured_knn_calls(knn_calls) if i == N_SCANS - 1 else contextlib.nullcontext()):
            state, res = lio.process_lio_scan(state, pts, tt, m, win, cfg)
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()
        torch.cuda.synchronize()
        per_scan.append(octant_knn.launches - before)
        results.append(res)
        if not _finite(state):
            raise AssertionError(f"non-finite LIO state after scan {len(results) - 1}")
    launches = octant_knn.launches
    first_ms = marks[0].elapsed_time(marks[1])
    # the last scan copies its kernel calls' arguments: outside the window
    steady = (N_SCANS - 1 - N_WARM) * 1e3 / marks[N_WARM].elapsed_time(marks[-2])
    reprobes = sum(n - 1 for n in per_scan)
    log(f"lio: {N_SCANS} scans {RINGS}x{WIDTH} ({items[0][0].shape[0]} points/scan, "
        f"{int(items[0][2].sum())} returns) octant_knn launches={launches} per scan "
        f"{per_scan} (1 probe + {reprobes} re-probes)")
    if any(n not in (1, 2) for n in per_scan) or launches != N_SCANS + reprobes:
        raise AssertionError(f"octant KNN launches per scan {per_scan}: expected 1 probe per "
                             "scan plus at most one re-probe")
    n_match = [int(r.n_matches) for r in results]
    rms = [float(r.rms) for r in results]
    dropped = [int(r.n_dropped) for r in results]
    est = np.stack([r.x.p.cpu().numpy() for r in results])
    log(f"lio: n_matches={n_match} rms={[round(x, 4) for x in rms]} n_dropped={dropped}")
    if min(n_match[1:]) < LIO_MIN_MATCHES:
        raise AssertionError(f"too few LIO matches once the map exists: {n_match}")
    if max(rms[1:]) >= 0.1:
        raise AssertionError(f"LIO residual rms too high: {rms}")
    ate = ate_rmse(est, gt[:N_SCANS], align=False)
    log(f"lio: ATE={ate:.4f} m (bound {LIO_ATE_BOUND:.4f}); first scan {first_ms:.1f} ms; "
        f"steady {steady:.2f} scans/s over scans {N_WARM}..{N_SCANS - 2} (CUDA events "
        f"between synchronized scans)")
    if not ate < LIO_ATE_BOUND:
        raise AssertionError(f"LIO ATE {ate:.4f} m above the bound {LIO_ATE_BOUND:.4f} m")

    # more scans of the same run, each measured one way: host syncs
    # (sync debug mode counts every synchronizing call), launches and busy
    # share (torch.profiler), stage times (synchronized stages)
    rest = iter(items[N_SCANS:])
    syncs, sync_sites = [], collections.Counter()
    for _ in range(LIO_PROFILE_SCANS):
        pts, tt, m, win = next(rest)
        with counted_syncs(syncs, sync_sites):
            state, _ = lio.process_lio_scan(state, pts, tt, m, win, cfg)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(LIO_PROFILE_SCANS):
            pts, tt, m, win = next(rest)
            state, _ = lio.process_lio_scan(state, pts, tt, m, win, cfg)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    kernel_us = sum(e.device_time_total for e in events
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and not getattr(e, "is_user_annotation", False))
    n_launch = sum(1 for e in events if e.name in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                                                   "cuLaunchKernel", "cuLaunchKernelEx"))
    busy = kernel_us / 1e3 / wall_ms if kernel_us > 0 else None
    times: dict = {}
    with synchronized_stages(times):
        for _ in range(LIO_PROFILE_SCANS):
            pts, tt, m, win = next(rest)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, _ = lio.process_lio_scan(state, pts, tt, m, win, cfg)
            torch.cuda.synchronize()
            times.setdefault("scan", []).append((time.perf_counter() - t0) * 1e3)
    stage_ms = {k: sum(v) / LIO_PROFILE_SCANS for k, v in times.items()}
    calls = {k: len(v) / LIO_PROFILE_SCANS for k, v in times.items()}
    if not _finite(state):
        raise AssertionError("non-finite LIO state in the measured scans")
    log(f"lio: host syncs per scan {syncs} (sync debug mode); by call site over "
        f"{LIO_PROFILE_SCANS} scans: {dict(sync_sites.most_common())}")
    log(f"lio: torch.profiler over {LIO_PROFILE_SCANS} scans: wall {wall_ms:.1f} ms, device "
        f"kernel time {kernel_us / 1e3:.2f} ms, busy share {busy}, kernel launches "
        f"{n_launch} ({n_launch / LIO_PROFILE_SCANS:.0f} per scan)")
    log("lio: synchronized stage times, ms per scan (calls per scan): " + ", ".join(
        f"{k} {v:.2f} ({calls[k]:g})" for k, v in stage_ms.items()))
    return {"launches": launches, "items": items[:N_SCANS], "gt": gt[:N_SCANS],
            "results": results, "ate": ate, "scans_per_s": steady, "first_ms": first_ms,
            "syncs": syncs, "sync_sites": dict(sync_sites), "busy": busy,
            "launches_per_scan": n_launch / LIO_PROFILE_SCANS, "stage_ms": stage_ms,
            "calls": knn_calls}


def phase_lio_cpu(run: dict) -> None:
    """The same LIO scans with CPU tensors; poses must agree with the card's."""
    cfg = lio.LioConfig()
    state = lio_start(cfg, "cpu")
    worst_t = worst_q = 0.0
    est = []
    for (pts, tt, m, win), gpu in zip(run["items"], run["results"]):
        state, res = lio.process_lio_scan(state, pts.cpu(), tt.cpu(), m.cpu(),
                                          lio.ImuWindow(*(a.cpu() for a in win)), cfg)
        est.append(res.x.p.numpy())
        worst_t = max(worst_t, float((res.x.p - gpu.x.p.cpu()).abs().max()))
        worst_q = max(worst_q, float((res.x.q - gpu.x.q.cpu()).abs().max()))
    ate = ate_rmse(np.stack(est), run["gt"], align=False)
    log(f"lio-cpu: {len(est)} scans with CPU tensors: ATE={ate:.4f} m; against the card "
        f"max |dp|={worst_t:.3g} m, max |dq|={worst_q:.3g}")
    if worst_t > POSE_T_TOL or worst_q > POSE_Q_TOL:
        raise AssertionError("card and CPU LIO poses disagree")


def slam_config() -> slam_pipeline.SlamConfig:
    """bench.py's slam headline: the odometry preset, a 1024-keyframe bank,
    2048 edges and the default LoopConfig (full27 loop maps of 2^14 slots, a
    25-keyframe window)."""
    return slam_pipeline.SlamConfig(pipeline=preset_aloam_kitti64(), bank_capacity=1024,
                                    edge_capacity=2048)


def gate_firm(margin: tuple) -> bool:
    """Whether a keyframe decision stands clear of rounding: a test of the
    gate passes by more than the pose tolerance, or both fail by more."""
    _, m_dist, m_ang = margin
    return (m_dist > POSE_T_TOL or m_ang > POSE_Q_TOL
            or (m_dist < -POSE_T_TOL and m_ang < -POSE_Q_TOL))


def gate_inputs(bank) -> tuple:
    """What the keyframe gate reads of a bank: its count and newest pose (no
    host read)."""
    last = last_index(bank)
    return bank.count, row(bank.t, last), row(bank.q, last)


def gate_margins(gates: list, results: list, cfg) -> list:
    """The keyframe gate at each scan: (added, ddist - kf_dist, dang -
    kf_angle), from gate_inputs of the bank before the scan (gates[i]) and
    after it (gates[i + 1]); the margins are inf where the bank was empty."""
    out = []
    for (n, t, q), (n_after, _, _), res in zip(gates[:-1], gates[1:], results):
        added = int(n_after) > int(n)
        if int(n) == 0:
            out.append((added, float("inf"), float("inf")))
            continue
        ddist = float(torch.linalg.vector_norm(res.pose.t - t))
        dang = float(torch.linalg.vector_norm(so3.quat_log(so3.quat_mul(so3.quat_conj(q),
                                                                        res.pose.q))))
        out.append((added, ddist - cfg.kf_dist, dang - cfg.kf_angle))
    return out


def run_slam(device, scans: list, marks: list | None = None, stage_ms: dict | None = None,
             syncs: list | None = None, sites: collections.Counter | None = None,
             gps: dict | None = None) -> dict:
    """SlamDriver over `scans` on `device`, started moving, with
    close_loop_external(n - 1, 0) after the first SLAM_CLOSE_AFTER scans.
    With `marks`, a CUDA event is recorded there before the first scan, after
    each scan and after the closure, each followed by a synchronize; with
    `stage_ms`, the closure's stages are timed there (synchronized); with
    `syncs`, each scan's host syncs are counted there (and in `sites`); with
    `gps`, {scan index: numpy position} fixes go in with those scans.
    Returns the results, the gate's inputs before every scan and after the
    last, the closure's outcome and the octant launches per scan."""
    cfg = slam_config()
    drv = slam_pipeline.SlamDriver(cfg, device)
    drv.state = drv.state._replace(engine=moving_start(cfg.pipeline, device))
    results, gates, launches = [], [], []
    closure = {}

    def mark():
        if marks is not None:
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
            torch.cuda.synchronize()

    real_align = slam_pipeline.align_loop

    def align_kept(*a, **kw):  # keeps the alignment's (z_rel, fitness, ok)
        out = real_align(*a, **kw)
        closure["z"], closure["fitness"], closure["ok"] = out
        return out

    mark()
    for i, s in enumerate(scans):
        if i == SLAM_CLOSE_AFTER:
            n = int(drv.state.bank.count)
            before = octant_knn.launches
            targets = [(slam_pipeline, "align_loop"), (slam_pipeline, "_correct_and_rebuild"),
                       (slam_pipeline, "solve_pose_graph"), (slam_pipeline, "_chunked_insert")]
            t0 = time.perf_counter()
            slam_pipeline.align_loop = align_kept
            try:
                with (synchronized_stages(stage_ms, targets) if stage_ms is not None
                      else contextlib.nullcontext()):
                    closure["accepted"] = drv.close_loop_external(n - 1, 0)
            finally:
                slam_pipeline.align_loop = real_align
            if marks is not None:
                torch.cuda.synchronize()
            closure.update(ms=(time.perf_counter() - t0) * 1e3, n_kf=n,
                           launches=octant_knn.launches - before,
                           bank_after=drv.state.bank)
            mark()
        gates.append(gate_inputs(drv.state.bank))
        before = octant_knn.launches
        with (counted_syncs(syncs, sites) if syncs is not None else contextlib.nullcontext()):
            res = drv.process(s, gps=(gps or {}).get(i))
        mark()
        launches.append(octant_knn.launches - before)
        results.append(res)
    gates.append(gate_inputs(drv.state.bank))
    return {"cfg": cfg, "driver": drv, "results": results, "gates": gates,
            "closure": closure, "launches_per_scan": launches}


def phase_slam(device, main: dict, card: str) -> dict:
    """The slam engine (bench.py bench_slam) on the main phase's scans, as a
    user drives it: SlamDriver.process per scan, an external loop candidate
    after 10 scans (the newest keyframe against the first: align_loop on the
    25-keyframe window and, accepted, the pose-graph solve and the rebuild of
    both odometry maps from the 1024-slot bank in 32 chunks), then the last
    two scans, which must still track.

    The arc moves 1 m a scan and the gate adds a keyframe past kf_dist = 1.0
    m, so the gate sits on its threshold within the 1e-3 m by which card and
    CPU poses may differ: each scan's margin ddist - kf_dist is printed, and
    slam-cpu holds the card's keyframe decisions to the CPU's only where the
    margin exceeds POSE_T_TOL."""
    scans = main["scans"]
    marks, stage_ms = [], {}
    octant_knn.launches = 0
    torch.cuda.synchronize()
    run = run_slam(device, scans, marks, stage_ms)
    cfg, drv, results, clo = (run[k] for k in ("cfg", "driver", "results", "closure"))
    launches = octant_knn.launches
    first_ms = marks[0].elapsed_time(marks[1])
    steady = (SLAM_CLOSE_AFTER - N_WARM) * 1e3 / marks[N_WARM].elapsed_time(
        marks[SLAM_CLOSE_AFTER])
    per_scan = run["launches_per_scan"]
    log(f"slam: {len(scans)} scans {RINGS}x{WIDTH}, bank {cfg.bank_capacity}, edges "
        f"{cfg.edge_capacity}; octant_knn launches per scan {per_scan}, in the closure "
        f"{clo['launches']}")
    if any(n != 4 for n in per_scan) or clo["launches"] != 0:
        raise AssertionError("slam: the octant kernel must run 4 times a scan and not in the "
                             "closure (its maps are full27)")
    if not clo["accepted"]:
        raise AssertionError(f"slam: the external closure ({clo['n_kf'] - 1} -> 0) was rejected, "
                             f"fitness {float(clo['fitness']):.4f}")
    margins = gate_margins(run["gates"], results, cfg)
    st = drv.state
    n_kf, n_edges = int(st.bank.count), int(st.edges.count)
    log(f"slam: keyframe gate per scan (added, ddist - kf_dist m, dang - kf_angle rad): "
        f"{[(a, round(m, 5), round(g, 4)) for a, m, g in margins]}")
    log(f"slam: {n_kf} keyframes, {n_edges} edges ({drv.n_loops_closed} loop closed); "
        f"closure accepted, fitness {float(clo['fitness']):.4f}, {clo['ms']:.1f} ms in all; "
        "synchronized stages ms (calls): " + ", ".join(
            f"{k} {sum(v):.2f} ({len(v)})" for k, v in stage_ms.items()) + f"; on {card}")
    n_surf = [int(r.stats.n_surf) for r in results]
    rms = [float(r.stats.rms) for r in results]
    est = np.stack([r.pose.t.cpu().numpy() for r in results])
    quats = np.stack([r.pose.q.cpu().numpy() for r in results])
    if not (np.all(np.isfinite(est)) and np.all(np.isfinite(quats))
            and all(bool(torch.isfinite(m.points).all()) for m in
                    (st.engine.corner_map, st.engine.surf_map))):
        raise AssertionError("slam: non-finite pose or map")
    log(f"slam: n_surf={n_surf} rms={[round(x, 4) for x in rms]}")
    if min(n_surf[1:]) < 100 or max(rms[1:]) >= 0.1:
        raise AssertionError("slam: the engine does not track (n_surf >= 100, rms < 0.1 once "
                             "the map exists, also after the closure)")
    ate = ate_rmse(est, main["gt"], align=False)
    log(f"slam: ATE={ate:.4f} m (bound {SLAM_ATE_BOUND:.4f}); first scan {first_ms:.1f} ms; "
        f"steady {steady:.2f} scans/s over scans {N_WARM}..{SLAM_CLOSE_AFTER - 1} (CUDA "
        f"events between synchronized scans, the closure excluded), on {card}")
    if not ate < SLAM_ATE_BOUND:
        raise AssertionError(f"slam ATE {ate:.4f} m above the bound {SLAM_ATE_BOUND:.4f} m")
    # the host syncs of the same run again, counted apart from the timing,
    # with GPS fixes (host numpy positions) on SLAM_GPS_SCANS; between
    # closures the driver adds none to process_scan's, fixes included: the
    # same counts as the main phase's count of the same scans and states
    # (from scan 1: the first scan of a process pays one-time syncs)
    syncs, sites = [], collections.Counter()
    fixes = {i: (main["gt"][i] + 0.05).astype(np.float32) for i in SLAM_GPS_SCANS}
    run_slam(device, scans, syncs=syncs, sites=sites, gps=fixes)
    pageable = []  # the copy the driver made before it staged fixes in pinned memory
    with counted_syncs(pageable, collections.Counter()):
        torch.as_tensor(fixes[SLAM_GPS_SCANS[0]]).to(device)
    log(f"slam: host syncs per scan {syncs} with GPS fixes at scans {list(fixes)}, odometry "
        f"alone (main) {main['syncs']}; by call site: {dict(sites.most_common())}; one fix "
        f"copied from pageable memory: {pageable[0]} syncs")
    if syncs[1:SLAM_CLOSE_AFTER] != main["syncs"][1:SLAM_CLOSE_AFTER]:
        raise AssertionError("slam: the driver or its GPS fixes add host syncs to the odometry's")
    return {"results": results, "margins": margins, "closure": clo, "ate": ate,
            "scans_per_s": steady, "first_ms": first_ms, "launches": launches,
            "syncs": syncs, "stage_ms": {k: sum(v) for k, v in stage_ms.items()},
            "n_kf": n_kf, "n_edges": n_edges}


def phase_slam_cpu(run: dict, main: dict) -> None:
    """The slam run again with CPU tensors: poses, keyframe decisions (where
    the gate's margin exceeds POSE_T_TOL), the closure's acceptance and
    fitness and the corrected keyframe trajectory against the card's."""
    cpu = run_slam("cpu", [ScanGrid(*(a.cpu() for a in s)) for s in main["scans"]])
    worst_t = worst_q = 0.0
    for res, gpu in zip(cpu["results"], run["results"]):
        worst_t = max(worst_t, float((res.pose.t - gpu.pose.t.cpu()).abs().max()))
        worst_q = max(worst_q, float((res.pose.q - gpu.pose.q.cpu()).abs().max()))
    est = np.stack([r.pose.t.numpy() for r in cpu["results"]])
    ate = ate_rmse(est, main["gt"], align=False)
    margins = gate_margins(cpu["gates"], cpu["results"], cpu["cfg"])
    differ = [i for i, (a, b) in enumerate(zip(margins, run["margins"])) if a[0] != b[0]]
    firm = [i for i in differ if gate_firm(margins[i]) and gate_firm(run["margins"][i])]
    clo, gclo = cpu["closure"], run["closure"]
    # the corrected keyframes, matched by stamp
    kb, gb = clo["bank_after"], gclo["bank_after"]
    kst = {int(s): i for i, s in enumerate(kb.stamp[:int(kb.count)])}
    gst = {int(s): i for i, s in enumerate(gb.stamp[:int(gb.count)].cpu())}
    common = sorted(set(kst) & set(gst))
    kf_dt = max(float((kb.t[kst[s]] - gb.t[gst[s]].cpu()).abs().max()) for s in common)
    log(f"slam-cpu: {len(est)} scans with CPU tensors: ATE={ate:.4f} m; against the card max "
        f"|dt|={worst_t:.3g} m, max |dq|={worst_q:.3g}; keyframe decisions differ at scans "
        f"{differ} (margin above the tolerance at {firm}); closure accepted {clo['accepted']} "
        f"(card {gclo['accepted']}), fitness {float(clo['fitness']):.5f} (card "
        f"{float(gclo['fitness']):.5f}); {len(common)} corrected keyframes in common, max "
        f"|dt| {kf_dt:.3g} m; closure {clo['ms']:.0f} ms on the host CPU")
    if worst_t > POSE_T_TOL or worst_q > POSE_Q_TOL:
        raise AssertionError("card and CPU slam poses disagree")
    if firm:
        raise AssertionError(f"card and CPU keyframe decisions differ at scans {firm}")
    if clo["accepted"] != gclo["accepted"] or abs(float(clo["fitness"])
                                                  - float(gclo["fitness"])) > 1e-3:
        raise AssertionError("card and CPU loop closures disagree")
    if kf_dt > POSE_T_TOL:
        raise AssertionError("card and CPU corrected keyframe trajectories disagree")


def liosam_config() -> liosam_pipeline.LioSamConfig:
    """bench.py's liosam headline: the odometry preset inside LIO-SAM, 10 Hz."""
    return liosam_pipeline.LioSamConfig(
        slam=slam_pipeline.SlamConfig(pipeline=preset_aloam_kitti64()), scan_period=0.1)


def liosam_driver(cfg, device):
    return liosam_pipeline.LioSamDriver(
        cfg, x0=circle_pose(0.0, LIO_RADIUS, LIO_OMEGA, device=device),
        v0=circle_velocity(0.0, LIO_RADIUS, LIO_OMEGA, device=device), device=device)


def phase_liosam(device, main: dict, card: str) -> dict:
    """The LIO-SAM engine (bench.py bench_liosam) on the LIO circle's 64x1800
    sweeps, kept as ScanGrids with their exact 200 Hz IMU windows, through
    LioSamDriver.process: finite state, the kernel 4 times a scan, ATE
    against the circle and scans/s over 12 scans; then, over LIO_PROFILE_SCANS
    more each, the host syncs and the stage split (synchronized stages)."""
    cfg = liosam_config()
    sweeps, gt = lio_sweeps(N_SCANS + 2 * LIO_PROFILE_SCANS, device)
    drv = liosam_driver(cfg, device)
    per_scan, results = [], []
    octant_knn.launches = 0
    torch.cuda.synchronize()
    marks = [torch.cuda.Event(enable_timing=True)]
    marks[0].record()
    for s, win in sweeps[:N_SCANS]:
        before = octant_knn.launches
        res = drv.process(s, win)
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()
        torch.cuda.synchronize()
        per_scan.append(octant_knn.launches - before)
        results.append(res)
    launches = octant_knn.launches
    first_ms = marks[0].elapsed_time(marks[1])
    steady = (N_SCANS - N_WARM) * 1e3 / marks[N_WARM].elapsed_time(marks[-1])
    st = drv.state
    if not all(bool(torch.isfinite(a).all()) for a in (*st.engine.pose, st.v, st.bg, st.ba, st.P)):
        raise AssertionError("non-finite LIO-SAM state")
    n_surf = [int(r.stats.n_surf) for r in results]
    rms = [float(r.stats.rms) for r in results]
    est = np.stack([r.pose.t.cpu().numpy() for r in results])
    ate = ate_rmse(est, gt[:N_SCANS], align=False)
    log(f"liosam: {N_SCANS} scans {RINGS}x{WIDTH} octant_knn launches per scan {per_scan}; "
        f"n_surf={n_surf} rms={[round(x, 4) for x in rms]}; {int(drv.bank.count)} keyframes, "
        f"{int(drv.edges.count)} edges")
    if any(n != 4 for n in per_scan):
        raise AssertionError("liosam: the octant kernel must run 4 times a scan")
    log(f"liosam: ATE={ate:.4f} m (bound {LIOSAM_ATE_BOUND:.4f}); first scan {first_ms:.1f} ms; "
        f"steady {steady:.2f} scans/s over scans {N_WARM}..{N_SCANS - 1} (CUDA events between "
        f"synchronized scans), on {card}")
    if not ate < LIOSAM_ATE_BOUND:
        raise AssertionError(f"LIO-SAM ATE {ate:.4f} m above the bound {LIOSAM_ATE_BOUND:.4f} m")
    syncs, sites = [], collections.Counter()
    rest = iter(sweeps[N_SCANS:])
    for _ in range(LIO_PROFILE_SCANS):
        s, win = next(rest)
        with counted_syncs(syncs, sites):
            drv.process(s, win)
    log(f"liosam: host syncs per scan {syncs} (sync debug mode); by call site over "
        f"{LIO_PROFILE_SCANS} scans: {dict(sites.most_common())}")
    # no sync of the driver's own, nor of the preintegration, deskew and
    # fusion: only the odometry's sources (the solve, the map insert)
    odom_files = {site.rsplit(":", 1)[0] for site in main["sync_sites"]}
    extra = [site for site in sites if site.rsplit(":", 1)[0] not in odom_files]
    if extra:
        raise AssertionError(f"liosam: host syncs outside the solve and the insert: {extra}")
    times: dict = {}
    stages = [(liosam_pipeline, n) for n in (
        "preintegrate", "deskew_with_imu", "extract_features", "voxel_downsample",
        "solve_scan2map", "_fuse", "insert_with_stats", "bound_map", "_keyframe_step_body",
        "detect_loop")]
    with synchronized_stages(times, stages):
        for s, win in rest:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            drv.process(s, win)
            torch.cuda.synchronize()
            times.setdefault("scan", []).append((time.perf_counter() - t0) * 1e3)
    stage_ms = {k: sum(v) / LIO_PROFILE_SCANS for k, v in times.items()}
    log("liosam: synchronized stage times, ms per scan (calls per scan): " + ", ".join(
        f"{k} {v:.2f} ({len(times[k]) / LIO_PROFILE_SCANS:g})" for k, v in stage_ms.items())
        + f"; on {card}")
    return {"sweeps": sweeps[:N_SCANS], "gt": gt[:N_SCANS], "results": results, "ate": ate,
            "scans_per_s": steady, "first_ms": first_ms, "launches": launches,
            "syncs": syncs, "stage_ms": stage_ms}


def phase_liosam_cpu(run: dict) -> None:
    """The same LIO-SAM sweeps with CPU tensors; poses must agree with the card's."""
    drv = liosam_driver(liosam_config(), "cpu")
    worst_t = worst_q = 0.0
    est = []
    for (s, win), gpu in zip(run["sweeps"], run["results"]):
        res = drv.process(ScanGrid(*(a.cpu() for a in s)),
                          lio.ImuWindow(*(a.cpu() for a in win)))
        est.append(res.pose.t.numpy())
        worst_t = max(worst_t, float((res.pose.t - gpu.pose.t.cpu()).abs().max()))
        worst_q = max(worst_q, float((res.pose.q - gpu.pose.q.cpu()).abs().max()))
    ate = ate_rmse(np.stack(est), run["gt"], align=False)
    log(f"liosam-cpu: {len(est)} scans with CPU tensors: ATE={ate:.4f} m; against the card "
        f"max |dt|={worst_t:.3g} m, max |dq|={worst_q:.3g}")
    if worst_t > POSE_T_TOL or worst_q > POSE_Q_TOL:
        raise AssertionError("card and CPU LIO-SAM poses disagree")


def livox_driver(device, imu_mode: int = 2):
    """bench.py's livox headline: LivoxConfig() exactly (or with another
    IMU_Mode), LO for 4 sweeps from the circle's first pose, then the window
    LIO."""
    cfg = dataclasses.replace(livox_pipeline.LivoxConfig(), imu_mode=imu_mode)
    return livox_pipeline.LivoxDriver(cfg, init_frames=LIVOX_INIT_FRAMES,
                                      x0=circle_pose(0.0, LIO_RADIUS, LIO_OMEGA, device=device),
                                      device=device)


def livox_gt(n_scans: int) -> np.ndarray:
    """The circle's position at each sweep START: the livox engine's pose of a
    sweep is its first frame's (the first sweep sits at x0, the circle's
    pose at t = 0, and the map is built in that convention)."""
    return np.stack([circle_pose(i * LIO_SCAN_DT, LIO_RADIUS, LIO_OMEGA, device="cpu").t.numpy()
                     for i in range(n_scans)])


def _livox_finite(st) -> bool:
    return all(bool(torch.isfinite(a).all()) for a in (*st.ws, st.prior.H, st.prior.b, st.grav))


def phase_livox(device, card: str) -> dict:
    """The livox engine (bench.py bench_livox) on the LIO circle's 64x1800
    sweeps with their 20-sample IMU windows, through LivoxDriver.process:
    LiDAR-only odometry for 4 sweeps, the MAP initialization with the 4th,
    then the sliding-window LIO. Checks: engaged after the 4th sweep, finite
    state, the kernel on every sweep (all three class maps are octant8),
    card ATE later held to 3x the CPU's (livox-cpu). Prints scans/s over the
    engaged sweeps after the first two, the first sweep's and the
    engagement's ms, the launches per sweep; then, in a second run of the
    same sweeps, the host syncs of each sweep and their sites, and a
    synchronized stage split over LIVOX_STAGE_SCANS more engaged sweeps.

    Host syncs expected (written before the first run on the card): per
    engaged sweep 2 reads of the window's cache motion (n_outer = 3: passes
    2 and 3) and one read per claim round of each of the three map inserts
    (1-3 rounds each): 5-11, all in estimators/window_map.py and
    map/hash_map.py; per LO sweep also the solve's 3 eigh reads and its 2
    cache-motion reads (estimators/gn_scan2map.py); the engagement adds the
    SVD convergence reads of map_initialize's 3 least-squares solves
    (imu/initialization.py). No other site."""
    n_total = N_SCANS + LIVOX_STAGE_SCANS
    sweeps, _ = lio_sweeps(n_total, device)
    gt = livox_gt(N_SCANS)
    drv = livox_driver(device)
    per_scan, results, engaged, calls = [], [], [], []
    octant_knn.launches = 0
    torch.cuda.synchronize()
    marks = [torch.cuda.Event(enable_timing=True)]
    marks[0].record()
    for i, (s, win) in enumerate(sweeps[:N_SCANS]):
        before = octant_knn.launches
        with (captured_knn_calls(calls) if i == N_SCANS - 1 else contextlib.nullcontext()):
            res = drv.process(s, win)
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()
        torch.cuda.synchronize()
        per_scan.append(octant_knn.launches - before)
        results.append(res)
        engaged.append(drv.engaged)
    launches = octant_knn.launches
    ms = [marks[i].elapsed_time(marks[i + 1]) for i in range(N_SCANS)]
    first_engaged = engaged.index(True) if True in engaged else None
    log(f"livox: {N_SCANS} sweeps {RINGS}x{WIDTH}, LivoxConfig(), init_frames "
        f"{LIVOX_INIT_FRAMES}: engaged after sweep {first_engaged}; octant_knn launches per "
        f"sweep {per_scan}; n_dropped {[int(r.n_dropped) for r in results]}")
    if first_engaged != LIVOX_INIT_FRAMES - 1:
        raise AssertionError(f"livox: engaged after sweep {first_engaged}, expected "
                             f"{LIVOX_INIT_FRAMES - 1}")
    # LO sweeps probe the corner and surf maps, window sweeps all three
    lo_n, win_n = per_scan[:first_engaged + 1], per_scan[first_engaged + 1:]
    served = {c[4].sub_voxel for c in calls}
    cfg = drv.cfg
    if (min(lo_n) < 2 or min(win_n) < 3
            or served != {m.sub_voxel for m in (cfg.corner_map, cfg.surf_map, cfg.other_map)}):
        raise AssertionError(f"livox: the octant kernel must serve every class map on every "
                             f"sweep: launches {per_scan}, maps of the last sweep {served}")
    if not _livox_finite(drv.state):
        raise AssertionError("livox: non-finite window state")
    est = np.stack([r.pose.t.cpu().numpy() for r in results])
    quats = np.stack([r.pose.q.cpu().numpy() for r in results])
    if not (np.all(np.isfinite(est)) and np.all(np.isfinite(quats))):
        raise AssertionError("livox: non-finite pose")
    ate = ate_rmse(est, gt, align=False)
    # scans/s over the engaged sweeps after the first two, the last one
    # (its kernel calls are captured) excluded
    lo = first_engaged + 3
    steady = (N_SCANS - 1 - lo) * 1e3 / sum(ms[lo:N_SCANS - 1])
    init = drv.init_result
    log(f"livox: ATE={ate:.4f} m (sweep-start ground truth; bound: 3x the CPU's, livox-cpu); "
        f"first sweep {ms[0]:.1f} ms, engagement sweep {ms[first_engaged]:.1f} ms, first "
        f"window sweep {ms[first_engaged + 1]:.1f} ms; steady {steady:.2f} scans/s over sweeps "
        f"{lo}..{N_SCANS - 2} (CUDA events between synchronized sweeps; ms per sweep "
        f"{[round(x, 1) for x in ms]}); init grav "
        f"{init.grav.cpu().numpy().round(4).tolist()} ok {bool(init.ok)}; on {card}")

    # the host syncs of each sweep, in a second run of the same sweeps
    syncs, sites, sweep_sites = [], collections.Counter(), []
    drv2 = livox_driver(device)
    for s, win in sweeps[:N_SCANS]:
        one = collections.Counter()
        with counted_syncs(syncs, one):
            drv2.process(s, win)
        sites.update(one)
        sweep_sites.append(one)
    log(f"livox: host syncs per sweep {syncs} (sync debug mode); by call site: "
        f"{dict(sites.most_common())}")
    allowed = {"estimators/window_map.py", "map/hash_map.py"}
    for i, one in enumerate(sweep_sites[1:], start=1):  # sweep 0 pays one-time syncs
        ok = set(allowed)
        if i < LIVOX_INIT_FRAMES:
            ok.add("estimators/gn_scan2map.py")
        if i == first_engaged:
            ok.add("imu/initialization.py")
        extra = [site for site in one if site.rsplit(":", 1)[0] not in ok]
        if extra:
            raise AssertionError(f"livox: host syncs of sweep {i} outside the listed sites: "
                                 f"{extra}")

    times: dict = {}
    stages = [(livox_pipeline, n) for n in (
        "remove_dynamic", "extract_livox_features", "voxel_downsample", "preintegrate",
        "solve_window", "marginalize_oldest", "insert_with_stats", "bound_map")] + [
        (window_map, n) for n in ("associate_window", "_window_normal_eq", "_imu_jacobian")]
    with synchronized_stages(times, stages):
        for s, win in sweeps[N_SCANS:]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            drv.process(s, win)
            torch.cuda.synchronize()
            times.setdefault("scan", []).append((time.perf_counter() - t0) * 1e3)
    stage_ms = {k: sum(v) / LIVOX_STAGE_SCANS for k, v in times.items()}
    log("livox: synchronized stage times, ms per engaged sweep (calls per sweep): " + ", ".join(
        f"{k} {v:.2f} ({len(times[k]) / LIVOX_STAGE_SCANS:g})" for k, v in stage_ms.items())
        + f"; on {card}")
    if not _livox_finite(drv.state):
        raise AssertionError("livox: non-finite window state in the measured sweeps")
    return {"sweeps": sweeps[:N_SCANS], "gt": gt, "results": results, "engaged": engaged,
            "ate": ate, "scans_per_s": steady, "first_ms": ms[0],
            "engage_ms": ms[first_engaged], "launches": launches, "per_scan": per_scan,
            "syncs": syncs, "sync_sites": dict(sites), "stage_ms": stage_ms, "calls": calls}


def phase_livox_cpu(run: dict, device) -> None:
    """The livox sweeps again with CPU tensors: poses within POSE_T_TOL and
    POSE_Q_TOL of the card's, the same engagement sweep and n_dropped, and
    the card's ATE under 3x the CPU's. Then IMU_Mode 1 (the gyro deskew
    before the LiDAR-only solve) for LIVOX_MODE1_SCANS sweeps on the card and
    on the CPU, poses compared."""
    drv = livox_driver("cpu")
    worst_t = worst_q = 0.0
    est = []
    for (s, win), gpu, eng in zip(run["sweeps"], run["results"], run["engaged"]):
        res = drv.process(ScanGrid(*(a.cpu() for a in s)),
                          lio.ImuWindow(*(a.cpu() for a in win)))
        if drv.engaged != eng or int(res.n_dropped) != int(gpu.n_dropped):
            raise AssertionError("card and CPU livox runs engage or drop differently")
        est.append(res.pose.t.numpy())
        worst_t = max(worst_t, float((res.pose.t - gpu.pose.t.cpu()).abs().max()))
        worst_q = max(worst_q, float((res.pose.q - gpu.pose.q.cpu()).abs().max()))
    ate = ate_rmse(np.stack(est), run["gt"], align=False)
    log(f"livox-cpu: {len(est)} sweeps with CPU tensors: ATE={ate:.4f} m (card "
        f"{run['ate']:.4f}, bound {3 * ate:.4f}); against the card max |dt|={worst_t:.3g} m, "
        f"max |dq|={worst_q:.3g}")
    if worst_t > POSE_T_TOL or worst_q > POSE_Q_TOL:
        raise AssertionError("card and CPU livox poses disagree")
    if not run["ate"] < 3 * ate:
        raise AssertionError(f"livox ATE {run['ate']:.4f} m above 3x the CPU's {ate:.4f} m")
    card, cpu = livox_driver(device, imu_mode=1), livox_driver("cpu", imu_mode=1)
    worst_t = worst_q = 0.0
    for s, win in run["sweeps"][:LIVOX_MODE1_SCANS]:
        a = card.process(s, win)
        b = cpu.process(ScanGrid(*(x.cpu() for x in s)), lio.ImuWindow(*(x.cpu() for x in win)))
        worst_t = max(worst_t, float((a.pose.t.cpu() - b.pose.t).abs().max()))
        worst_q = max(worst_q, float((a.pose.q.cpu() - b.pose.q).abs().max()))
    log(f"livox-cpu: IMU_Mode 1, {LIVOX_MODE1_SCANS} sweeps on the card and the CPU: max "
        f"|dt|={worst_t:.3g} m, max |dq|={worst_q:.3g}")
    if card.engaged or worst_t > POSE_T_TOL or worst_q > POSE_Q_TOL:
        raise AssertionError("card and CPU IMU_Mode 1 runs disagree")


def phase_path(runs: dict, gather_gb_per_s: float) -> dict:
    """The octant-KNN kernel on the arguments captured from the paths' own
    calls: exactness, device and call times against the plain version, the
    bound, the sharing counts and the L2 figure (the hits' row bytes, points
    and occupancy, over the rate of the row gather that reads each row once,
    measured in this run)."""
    out = {}
    for path, calls in runs.items():
        if not calls:
            raise AssertionError(f"no octant KNN call was captured on the {path} path")
        for j, (m, q, qm, k, mcfg, ktab) in enumerate(calls):
            label = f"{path}#{j}:{q.shape[0]}x{m.n_rows}xk{k}"

            def kern_call():
                return octant_knn.knn_octant(m, q, qm, k, mcfg, ktab=ktab)

            def plain_call():
                return octant_knn.knn_octant_ref(m, q, qm, k, mcfg, ktab=ktab)

            (sq, pts, valid), (rsq, rpts, rvalid) = kern_call(), plain_call()
            torch.cuda.synchronize()
            if not torch.equal(valid, rvalid):
                raise AssertionError(f"path input {label}: valid differs in "
                                     f"{int((valid != rvalid).sum())} entries")
            torch.testing.assert_close(sq, rsq, rtol=SQ_TOL, atol=SQ_TOL)
            torch.testing.assert_close(pts, rpts, rtol=PTS_TOL, atol=PTS_TOL)
            err = 0.0
            if bool(rvalid.any()):
                err = max(float((sq - rsq)[rvalid].abs().max()),
                          float((pts - rpts)[rvalid].abs().max()))
            sh = sharing(m, q, qm, mcfg, ktab)
            bound_ms, bound_by = knn_bound(m, q, qm, k, mcfg, ktab)
            rec = {"queries": q.shape[0], "rows": m.n_rows, "k": k, "max_abs_err": err,
                   "device_ms": device_ms(kern_call), "plain_device_ms": device_ms(plain_call),
                   "call_ms": cuda_ms(kern_call), "bound_ms": bound_ms, "bound_by": bound_by,
                   "l2_ms": sh["hits"] * m.bucket * 13 / (gather_gb_per_s * 1e6), **sh}
            rec["sharing"] = sh["hits"] / sh["tile_rows"] if sh["tile_rows"] else None
            out[label] = rec
            log(f"path {label}: max_abs_err={err:.3g} OK; {rec}")
    return out


def kernels_line(kern: dict, prb: dict, main_run: dict, lio_run: dict, slam_run: dict,
                 liosam_run: dict, livox_run: dict, path: dict) -> dict:
    """Every number here was measured in this run; shapes are in the keys.
    ms / plain_ms / library_ms are device times per call (torch.profiler)."""
    t = kern["timing"]

    def by_shape(key):
        return {f"{v['queries']}x{v['rows']}xk{v['k']}": v[key] for v in t.values()}

    g = prb["row_gather_sum"]
    s = prb["scale2"]["256x128"]
    path_keys = ("device_ms", "plain_device_ms", "call_ms", "bound_ms", "l2_ms", "live",
                 "hits", "distinct_rows", "tile_rows", "max_abs_err")
    return {"kernels": [
        {"name": "octant_knn", "route": "cuda", "source": "agi_lidar_slam_torch/csrc/octant_knn.cu",
         "replaces": "agi_lidar_slam_tpu/nn/vmem_knn.py:150",
         "launches": sum(r["launches"] for r in (main_run, lio_run, slam_run, liosam_run,
                                                 livox_run)),
         "launches_by_path": {"odom": main_run["launches"], "lio": lio_run["launches"],
                              "slam": slam_run["launches"], "liosam": liosam_run["launches"],
                              "livox": livox_run["launches"]},
         "max_abs_err": max(kern["max_abs_err"], *(v["max_abs_err"] for v in path.values())),
         "ms": t["lio"]["device_ms"],
         "plain_ms": t["lio"]["plain_device_ms"], "bound_ms": t["lio"]["bound_ms"],
         "bound_by": t["lio"]["bound_by"], "library_ms": None,
         **{f"{key}_by_shape": by_shape(key) for key in (
             "device_ms", "plain_device_ms", "call_ms", "plain_call_ms", "bound_ms")},
         "path_inputs": {name: {key: v[key] for key in path_keys} for name, v in path.items()},
         "odom_scans_per_s": main_run["scans_per_s"], "odom_ate_m": main_run["ate"],
         "lio_scans_per_s": lio_run["scans_per_s"], "lio_ate_m": lio_run["ate"],
         "slam_scans_per_s": slam_run["scans_per_s"], "slam_ate_m": slam_run["ate"],
         "liosam_scans_per_s": liosam_run["scans_per_s"], "liosam_ate_m": liosam_run["ate"],
         "livox_scans_per_s": livox_run["scans_per_s"], "livox_ate_m": livox_run["ate"],
         "livox_launches_per_scan": livox_run["per_scan"]},
        {"name": "scale2", "route": "cuda", "source": "agi_lidar_slam_torch/csrc/probe.cu",
         "replaces": "tools/pallas_probe.py:29", "launches": prb["launches"]["scale2"],
         "max_abs_err": s["max_abs_err"], "ms": s["ms"], "plain_ms": s["plain_ms"],
         "bound_ms": s["bound_ms"], "bound_by": s["bound_by"], "library_ms": s["library_ms"],
         "call_ms": s["call_ms"], "by_shape": prb["scale2"]},
        {"name": "row_gather_sum", "route": "cuda", "source": "agi_lidar_slam_torch/csrc/probe.cu",
         "replaces": "tools/pallas_probe.py:45", "launches": prb["launches"]["row_gather_sum"],
         "max_abs_err": max(v["max_abs_err"] for v in g.values()),
         "ms": g["map_table"]["ms"], "plain_ms": g["map_table"]["plain_ms"],
         "bound_ms": g["map_table"]["bound_ms"], "bound_by": g["map_table"]["bound_by"],
         "library_ms": g["map_table"]["library_ms"],
         "l2_bound_ms": g["map_table"]["l2_bound_ms"], "l2_rate": prb["row_gather_l2_rate"],
         "by_shape": g, "claims_sweep": prb["row_gather_claims_sweep"],
         "two_streams": prb["row_gather_two_streams"], "graph": prb["row_gather_graph"]},
    ]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"device: {torch.cuda.get_device_name(0)} | {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32} cudnn.allow_tf32="
        f"{torch.backends.cudnn.allow_tf32}")

    t0 = time.perf_counter()
    ptxas = io.StringIO()
    with contextlib.redirect_stdout(ptxas):  # nvcc -Xptxas -v: registers and spills
        lib = _build.build(verbose=True)
    _build.load()
    ptxas = ptxas.getvalue()
    print(ptxas, end="", flush=True)
    spills = [int(n) for n in re.findall(r"(\d+) bytes spill stores", ptxas)]
    if any(spills):
        raise AssertionError(f"a kernel instance spills registers: {spills}")
    tile, stage_rows, smem = launch_shape(64)
    log(f"build: {lib.name} in {time.perf_counter() - t0:.1f} s; "
        f"{len(spills) or 'no'} kernel instances compiled here, none spills; octant_knn at "
        f"bucket 64: tiles of {tile} queries, {stage_rows} staged rows, {smem} B of dynamic "
        f"shared memory per CTA")

    seconds = {"build": time.perf_counter() - t0}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t
        return out

    kern = timed("kernel", phase_kernel, device)
    prb = timed("probe", phase_probe, device)
    main_run = timed("main", phase_main, device)
    timed("cpu", phase_cpu, main_run)
    lio_run = timed("lio", phase_lio, device)
    timed("lio-cpu", phase_lio_cpu, lio_run)
    slam_run = timed("slam", phase_slam, device, main_run, smi)
    timed("slam-cpu", phase_slam_cpu, slam_run, main_run)
    liosam_run = timed("liosam", phase_liosam, device, main_run, smi)
    timed("liosam-cpu", phase_liosam_cpu, liosam_run)
    livox_run = timed("livox", phase_livox, device, smi)
    timed("livox-cpu", phase_livox_cpu, livox_run, device)
    path = timed("path", phase_path, {"odom": main_run["calls"], "lio": lio_run["calls"],
                                      "livox": livox_run["calls"]},
                 prb["row_gather_sum"]["distinct"]["GB_per_s"])
    log("phase seconds (host clock): " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items())
        + f"; total {sum(seconds.values()):.1f}")

    print(json.dumps(kernels_line(kern, prb, main_run, lio_run, slam_run, liosam_run, livox_run,
                                  path)), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
