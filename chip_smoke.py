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
               launched 4 times per scan, the Gauss-Newton kernels once a
               step each (gn_expected), healthy correspondence counts and
               residuals, ATE against the simulator's ground truth, scans/s
               (over the scans before the last, whose kernel calls are
               captured for phase 25), then the host syncs of each scan in a
               second, untimed run;
  6. cpu     — the same scans with CPU tensors, poses compared with the card's;
 6a. eig     — the kernel phase's part for the sym_eig kernel (after main,
               whose Gauss-Newton systems it reuses): the kernel against its
               plain version (torch.linalg.eigh on the card) on random SPD
               batches of 6x6 and 3x3, on exactly and nearly repeated
               eigenvalues, on rank-deficient matrices, on the 8 systems of
               the main phase's last scan (each alone, as the path calls it,
               and as one batch) and on a NaN matrix: eigenvalues,
               reconstruction V diag(w) V^T, orthonormality, and on the main
               phase's systems solve_delta's step against the step with the
               plain version; device times, times with a sync each call,
               the library call's time and the bound; then the 6-dof steps'
               Gauss-Newton kernels on the same steps, bit for bit against the
               torch ops they replace, and each kernel's device time on its
               own launch beside those ops';
 6b. chunk   — runtime.pipeline.process_scan_chunk on the main phase's 12
               scans as 3 chunks of 4, each a replay of one CUDA graph: poses
               within 1e-6 m of the main phase's sequential poses on this
               card with equal correspondence counts, no host sync in a
               replay, one graph launch a chunk, the kernels' launches while
               capturing, capture seconds and the graph pool's bytes, scans/s
               chunked against sequential (in turns), the card's busy share
               during a replay; then one chunk of 2 scans for every other
               PipelineConfig preset (config.py and presets.py), against the
               same preset's sequential run on the card;
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
 15. aloam-ref — presets.preset_aloam_kitti64_ref() exactly (the scan-to-scan
               odometry stage on every scan) over 12 HDL-64-scale scans
               (64x1800, +2.0/-24.8 deg) of tests/test_reference_presets.py's
               arc from rest (0.35 m and 0.03 rad a scan, world seed 2,
               extent 30 m), through process_scan: finite poses, every
               per-frame error under 0.35 m, the kernel 4 times a scan in the
               scan-to-map solve and never in the odometry stage (full27
               maps), the stage's correspondences (its GnStats, captured) from
               the second scan on; ATE, RPE, drift, scans/s; then host syncs
               by site and the synchronized stage split (features,
               downsample, the odometry stage's two inserts and its solve,
               the scan-to-map solve, insert, bound), each a run of its own;
 16. aloam-ref-cpu — the same scans with CPU tensors: poses within 1e-3 of
               the card's, the card's ATE under 3x the CPU's;
 17. lego    — presets.preset_lego_vlp16_ref() exactly over 12 VLP-16 scans at
               full width (16x1800, +-15 deg) of the same arc (world seed 0,
               extent 18 m): ground, segmented pixels and clusters per scan
               (ground and segmented non-zero), every per-frame error under
               0.35 m, no octant launch (full27 maps); ATE, RPE, drift,
               scans/s, host syncs by site, the stage split with segment_scan
               on its own line; the last scan's 20 two-step steps through
               gn_subset, bit for bit against the torch step (_step_ref) on
               the same inputs, and its device time beside that step's; then
               preset_lego_vlp16() (4 x 3 two-step) over the same scans under
               the same bound;
 18. lego-cpu — the same scans with CPU tensors: the pixels whose ground or
               segmented differs between card and CPU, each flipped test
               within 0.05 deg of its threshold; poses within 1e-3 where no
               pixel differs, else the card's ATE under 3x the CPU's;
 19. presets — the other reference presets, each for 8 scans on the card and
               then on the CPU: LioSamDriver with preset_liosam_vlp16_ref()
               and LioSamRefParams (16x1800 sweeps of the LIO circle with
               their IMU windows), process_lio_scan with
               lio_config_avia_ref() (the lio phase's scans) and LivoxDriver
               with livox_config_horizon_ref() (the livox phase's sweeps):
               finite state, octant launches (none on full27 maps, on every
               livox sweep), the card's ATE under 3x the CPU's;
 20. runner-kitti — the port's runner (tools/run_slam.main, in this process)
               on a KITTI sequence written from 12 HDL-64-scale sweeps
               (64x1800) of run_slam's arc in its default world (0.35 m and
               0.03 rad a sweep, reached from rest over 4 sweeps), read by
               the C++ loader (its g++ build timed), --preset aloam: with
               --device cpu first (its ATE sets the gate at 3x; per-frame
               errors under 0.35 m), then on the card with the gate, the
               trajectory, metrics, summary and map bundle: exit 0, the
               kernel 4 times a scan, poses within 1e-3 m of the CPU's, exit
               2 on an impossible envelope; scans/s through the runner beside
               process_scan on the loader's grids from memory, the loader's
               wait, host syncs a scan through the runner and the engine's;
 21. runner-bag — a ROS1 bag (the port's bag_write) of 12 LIO-circle sweeps
               at 64x1800, started from rest (still for a sweep, the yaw
               rate ramped up over 4), with 200 Hz IMU and 1 Hz NavSatFix,
               through the
               runner on the card and with --device cpu: --engine liosam
               with navsat GPS fusion (GPS factors used, the kernel 4 times a
               scan), --engine lio --save-map, then --load-map from that map
               with a seed 0.22 m off (the first pose within 0.05 m of the
               mapping run's); card and CPU poses within 1e-3 m;
 22. runner-sim — the runner's simulator at 64x1800, 12 frames: the city
               world with 4 movers through --engine slam and the corridor
               through --engine lio, on the card and the CPU: the card's ATE
               under 3x the CPU's;
 23. parallel — the multi-device layer (parallel/) on one rank in this
               process over nccl (a HashStore, world size 1): sharded_scan_step
               and sharded_scan_step_mp on the odom scans (12), sharded_lio_step
               on the LIO scans (12), sharded_livox_step over the 8 window
               sweeps after the livox driver's engagement, sharded_liosam_step
               (12 sweeps), sharded_solve_pose_graph on a full 1024-keyframe
               bank with 2048 edges, and build_merged_map(mesh=): each against
               the same single-process step on the card, poses within 1e-6
               (one rank sums what one process sums; the pose graph compared
               with deterministic index_add_), equal occupancy; scans/s beside
               the single process's, octant launches and collectives a scan;
 24. parallel-2 — two ranks spawned by parallel/launch.py on the one card over
               gloo (NCCL refuses two ranks on one device): the same steps for 8
               scans each, the pose graph, and sharded_knn against knn, held to
               phase 23's single-process runs at the JAX package's tolerances
               (odom 1e-4 m, LIO / livox / LIO-SAM 5e-3 m, equal occupancy,
               pose graph 1e-4); each rank's launches a scan and their query
               counts; the octant kernel's device time at a rank's half of the
               odom and LIO queries; tools/scaling_bench at 1 and 2 ranks. The
               rates there are one card's overhead, not scaling;
 25. path    — the octant-KNN kernel on the path's own inputs: the arguments
               of every call of the last odom, LIO and livox scans of
               phases 5, 7 and 13, and the first call on each map of the
               last aloam-ref scan and horizon-ref sweep (phases 15 and 19),
               captured there; each checked against the plain
               version, timed (device, plain, call with the wrapper), with its
               bound, its live queries, hits, distinct rows and rows read per
               tile, and the L2 figure: the hits' row bytes over the
               row-gather rate phase 4 measured with each row read once.
 26. profile — the port's stage profiler (agi_lidar_slam_torch/tools/
               profile_engines.py, its command line in a process of its own)
               over every engine (odom, chunk, slam with loop_detect and the
               driver's automatic closure at a full 1024-keyframe bank, lio,
               liosam, livox) and its kernels section, 4 warm-up scans and 2
               timed calls a stage: each staged step gives its engine step's
               pose within 1e-6 m (odom and chunk bit for bit), every time
               finite and positive, every share at most 105%, the JAX tool's
               schema; one line per engine, SOL_smoke.json and .md written
               under chiprun_out/.
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
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from agi_lidar_slam_torch import _build, config, preset_aloam_kitti64, presets
from agi_lidar_slam_torch.config import MapConfig
from agi_lidar_slam_torch.estimators import (gn_kernels, gn_scan2map, ieskf, sym_eig, two_step,
                                              window_map)
from agi_lidar_slam_torch.eval.metrics import ate_rmse, kitti_drift, rpe_rmse
from agi_lidar_slam_torch.features import curvature, segmentation
from agi_lidar_slam_torch.geometry import se3, so3
from agi_lidar_slam_torch.graph import pose_graph
from agi_lidar_slam_torch.graph.keyframes import add_keyframe, empty_bank, last_index, row
from agi_lidar_slam_torch.graph.loop_closure import LoopConfig
from agi_lidar_slam_torch.imu.eskf import NavState
from agi_lidar_slam_torch.map.hash_map import HashVoxelMap, empty_map, insert
from agi_lidar_slam_torch.map.planar import build_ktab
from agi_lidar_slam_torch.nn import octant_knn
from agi_lidar_slam_torch.nn.knn import knn
from agi_lidar_slam_torch.parallel import distributed as pdist
from agi_lidar_slam_torch.parallel import map_shard, sharding
from agi_lidar_slam_torch.parallel.launch import launch
from agi_lidar_slam_torch.pointcloud.cloud import ScanGrid
from agi_lidar_slam_torch.runtime import (livox_pipeline, liosam_pipeline, multisession, pipeline,
                                          slam_pipeline)
from agi_lidar_slam_torch.runtime import lio_pipeline as lio
from agi_lidar_slam_torch.runtime.pipeline import init_state, process_scan
from agi_lidar_slam_torch.sim.trajectory import circle_imu, circle_pose, circle_velocity
from agi_lidar_slam_torch.sim.world import default_world, simulate_scan
from agi_lidar_slam_torch.tools import probe, profile_engines, scaling_bench
from agi_lidar_slam_torch.tools import run_slam as runner_cli
# the timing and counting primitives live in the stage profiler; imported
# here under their names, which knn_bench.py and gather_bench.py use too,
# with its stage timer (Stages, patched) and its launch count (profiling)
from agi_lidar_slam_torch.tools.profile_engines import (Capture, Stages, bound, counted_syncs,
                                                        cuda_ms, device_ms, knn_bound, patched,
                                                        profiling)

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
# reference presets: the arc of tests/test_reference_presets.py (0.35 m and
# 0.03 rad of yaw a scan, from rest) and its per-frame bound; the drift
# metric's segment lengths over this 4 m path; scans of the stage split;
# VLP-16 rings; scans of each of the other presets on the card and the CPU
REF_STEP, REF_YAW = 0.35, 0.03
REF_FRAME_BOUND = 0.35
REF_DRIFT_LENGTHS = (1.0, 2.0, 3.0)
REF_STAGE_SCANS = 4
LEGO_RINGS = 16
PRESET_SCANS = 8
# card vs CPU segmentation: a ground or cluster test may flip only where its
# angle lies this close to its threshold (deg). One f32 ulp of a range moves
# the cluster angle between neighbouring columns by about 1e-3 deg; a fault
# moves it by degrees
SEG_MARGIN_DEG = 0.05
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
# sym_eig against torch.linalg.eigh on the card, relative to each matrix's
# largest entry: float32 eigensolvers err by a few n * 2**-24 of it (eigh
# itself about 1e-6 at n = 6 on the CPU; the kernel, fp64 inside, rounds once)
EIG_TOL = 1e-5
# solve_delta's step with the kernel against the step with eigh: the step
# amplifies the eigensolvers' f32 errors by the kept eigenvalues' condition
# number (up to 1e4 on the odometry's systems): 1e-3 relative, 1e-6 m absolute
DELTA_RTOL, DELTA_ATOL = 1e-3, 1e-6
CHUNK = 4  # scans a chunk of the chunk phase
CHUNK_POSE_TOL = 1e-6  # m: chunked against sequential on one card
# the stage profiler's run: warm-up scans before the profiled one, timed
# calls of each stage
PROFILE_SCANS, PROFILE_REPS = 4, 2


def log(msg: str) -> None:
    print(msg, flush=True)


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


def reset_launches() -> None:
    """Zero the launch counters of the octant KNN, sym_eig and the
    Gauss-Newton step kernels."""
    octant_knn.launches = sym_eig.launches = 0
    gn_kernels.launches.update(dict.fromkeys(gn_kernels.launches, 0))


def gn_expected(cfg, scans: int) -> dict:
    """The Gauss-Newton kernels' and sym_eig's launches `scans` scans of
    process_scan make on the card: gn_rotation and gn_rows once a
    normal-equations call, gn_update once a 6-dof step (which also launches
    sym_eig), gn_subset once a two-step step; the odometry stage's 6-dof
    steps included."""
    s2m = cfg.solver.n_outer * cfg.solver.n_inner
    odom = cfg.odom_solver.n_outer * cfg.odom_solver.n_inner if cfg.odometry_stage else 0
    subset = 2 * s2m if cfg.two_step else 0
    six = odom + (0 if cfg.two_step else s2m)
    return {k: v * scans for k, v in {"gn_rotation": six + subset, "gn_rows": six + subset,
                                      "gn_update": six, "gn_subset": subset,
                                      "sym_eig": six}.items()}


def check_gn_launches(label: str, cfg, scans: int, got: dict) -> None:
    want = gn_expected(cfg, scans)
    if got != want:
        raise AssertionError(f"{label}: Gauss-Newton launches {got}, expected {want}")


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
    results, marks, calls, solves = [], [torch.cuda.Event(enable_timing=True)], [], []
    reset_launches()
    marks[0].record()
    for i, s in enumerate(scans):
        last = i == N_SCANS - 1
        with (captured_knn_calls(calls) if last else contextlib.nullcontext()), \
                (captured_solves(solves) if last else contextlib.nullcontext()):
            state, res = process_scan(state, s, cfg)
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()
        torch.cuda.synchronize()
        results.append(res)
    launches, eig_launches = octant_knn.launches, sym_eig.launches
    gn_launches = dict(gn_kernels.launches)
    first_ms = marks[0].elapsed_time(marks[1])
    # the last scan copies its kernel calls' arguments: outside the window
    steady = (N_SCANS - 1 - N_WARM) * 1e3 / marks[N_WARM].elapsed_time(marks[-2])

    if launches != 4 * N_SCANS:
        raise AssertionError(f"octant KNN launched {launches} times, expected {4 * N_SCANS}")
    check_gn_launches("main", cfg, N_SCANS, {**gn_launches, "sym_eig": eig_launches})
    est = np.stack([r.pose.t.cpu().numpy() for r in results])
    quats = np.stack([r.pose.q.cpu().numpy() for r in results])
    if not (np.all(np.isfinite(est)) and np.all(np.isfinite(quats))):
        raise AssertionError("non-finite pose")
    n_surf = [int(r.stats.n_surf) for r in results]
    n_corner = [int(r.stats.n_corner) for r in results]
    rms = [float(r.stats.rms) for r in results]
    log(f"main: {N_SCANS} scans {RINGS}x{WIDTH} points/scan={int(scans[0].mask.sum())} "
        f"octant_knn launches={launches} sym_eig launches={eig_launches} Gauss-Newton kernel "
        f"launches={gn_launches} n_corner={n_corner} n_surf={n_surf}")
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
    return {"launches": launches, "eig_launches": eig_launches, "gn_launches": gn_launches,
            "solves": solves,
            "scans": scans, "gt": gt, "results": results, "ate": ate,
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


@contextlib.contextmanager
def captured_solves(solves: list):
    """While open, record a copy of each 6-dof Gauss-Newton step: the
    arguments of its normal_equations call ("ne") and of its step (H, g, the
    pose, sq, n_rows, the solver config)."""
    real_ne, real_step = gn_scan2map.normal_equations, gn_scan2map.step
    pending = []

    def ne(pose, corners, surfs, corr, cfg):
        pending.append((se3.Pose(pose.q.clone(), pose.t.clone()), corners, surfs,
                        type(corr)(*(x.clone() for x in corr)), cfg))
        return real_ne(pose, corners, surfs, corr, cfg)

    def stepped(H, g, pose, sq, n_rows, cfg):
        solves.append((H.clone(), g.clone(), cfg, {
            "ne": pending.pop() if pending else None,
            "pose": se3.Pose(pose.q.clone(), pose.t.clone()), "sq": sq.clone(),
            "n_rows": n_rows.clone()}))
        return real_step(H, g, pose, sq, n_rows, cfg)

    gn_scan2map.normal_equations, gn_scan2map.step = ne, stepped
    try:
        yield solves
    finally:
        gn_scan2map.normal_equations, gn_scan2map.step = real_ne, real_step


def synced_ms(fn, reps: int = 50) -> float:
    """Median host milliseconds of fn() followed by torch.cuda.synchronize():
    what a caller that needs the result on the host pays."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def lower_sym(a: torch.Tensor) -> torch.Tensor:
    """The symmetric matrix whose lower triangle is a's (what eigh reads)."""
    lo = torch.tril(a)
    return lo + torch.tril(a, -1).transpose(-1, -2)


def eig_check(label: str, a: torch.Tensor) -> dict:
    """sym_eig against torch.linalg.eigh on the same (B, n, n) matrices:
    eigenvalues, reconstruction and orthonormality, each as the largest
    error over the batch relative to each matrix's largest entry; raises
    above EIG_TOL."""
    vals, vecs = sym_eig.sym_eig(a)
    pvals, pvecs = sym_eig.sym_eig_ref(a)
    torch.cuda.synchronize()
    full = lower_sym(a)
    scale = full.abs().amax(dim=(-2, -1)).clamp_min(1e-30)
    eye = torch.eye(a.shape[-1], device=a.device)

    def rec_orth(w, v):
        rec = ((v * w[..., None, :]) @ v.transpose(-1, -2) - full).abs().amax(dim=(-2, -1))
        orth = (v.transpose(-1, -2) @ v - eye).abs().amax(dim=(-2, -1))
        return float((rec / scale).max()), float(orth.max())

    rec = {"vals": float(((vals - pvals).abs().amax(-1) / scale).max()),
           "vals_abs": float((vals - pvals).abs().max()),
           "ascending": bool((vals[..., 1:] >= vals[..., :-1]).all())}
    rec["rec"], rec["orth"] = rec_orth(vals, vecs)
    rec["plain_rec"], rec["plain_orth"] = rec_orth(pvals, pvecs)
    log(f"kernel sym_eig {label}: {tuple(a.shape)}: eigenvalues {rec['vals']:.3g} of the "
        f"largest entry from eigh's, reconstruction {rec['rec']:.3g} (eigh "
        f"{rec['plain_rec']:.3g}), orthonormality {rec['orth']:.3g} (eigh "
        f"{rec['plain_orth']:.3g})")
    if not (rec["ascending"] and max(rec["vals"], rec["rec"], rec["orth"]) <= EIG_TOL):
        raise AssertionError(f"sym_eig {label}: {rec} beyond EIG_TOL {EIG_TOL}")
    return rec


def eig_inputs(rng: np.random.Generator) -> dict:
    """Batches of symmetric matrices, made in float64 and rounded once."""
    out = {}
    for n in (6, 3):  # normal equations J^T J with entries up to 1e6
        J = rng.normal(size=(4096, 3 * n, n)) * rng.uniform(1, 300, (4096, 1, 1))
        out[f"spd{n}"] = J.transpose(0, 2, 1) @ J
    Q = np.linalg.qr(rng.normal(size=(512, 6, 6)))[0]
    d = np.sort(rng.choice([1.0, 50.0, 1e4], size=(512, 6)), axis=1)
    out["repeated6"] = (Q * d[:, None, :]) @ Q.transpose(0, 2, 1)  # repeated up to rounding
    out["diag_repeated6"] = np.stack([np.diag(x) for x in d[:64]])  # exactly repeated
    Q3 = np.linalg.qr(rng.normal(size=(512, 3, 3)))[0]
    d3 = np.sort(rng.choice([1.0, 1e3], size=(512, 3)), axis=1)
    out["repeated3"] = (Q3 * d3[:, None, :]) @ Q3.transpose(0, 2, 1)
    J = rng.normal(size=(1024, 6, 4)) * 100.0
    out["rank4of6"] = J @ J.transpose(0, 2, 1)
    J3 = rng.normal(size=(1024, 3, 2)) * 100.0
    out["rank2of3"] = J3 @ J3.transpose(0, 2, 1)
    return {k: 0.5 * (v + v.transpose(0, 2, 1)) for k, v in out.items()}


def plain_solve_delta(H, g, cfg):
    """solve_delta with the plain eigendecomposition (torch.linalg.eigh)."""
    real = gn_scan2map.sym_eig
    gn_scan2map.sym_eig = sym_eig.sym_eig_ref
    try:
        return gn_scan2map.solve_delta(H, g, cfg)
    finally:
        gn_scan2map.sym_eig = real


def phase_eig(device, main: dict) -> dict:
    """The sym_eig kernel against its plain version (eig_check) on the
    synthetic batches, on the main phase's last-scan systems and on a NaN
    matrix; solve_delta's step with the kernel against the step with the
    plain version on those systems; then device times at the path's shape
    (one 6x6 matrix a call) and at 4096 matrices, the same with a sync each
    call, torch.linalg.eigh's times (the library call) and the bounds."""
    rng = np.random.default_rng(SEED)
    cases = {k: torch.from_numpy(v.astype(np.float32)).to(device)
             for k, v in eig_inputs(rng).items()}
    solves = main["solves"]
    if len(solves) != 8:
        raise AssertionError(f"captured {len(solves)} solve_delta calls of the last main "
                             "scan, expected 8")
    path_H = torch.stack([H for H, _, _, _ in solves])
    out = {"cases": {k: eig_check(k, a) for k, a in cases.items()}}
    out["cases"]["path_batch"] = eig_check("path_batch", path_H)
    for j, (H, _, _, _) in enumerate(solves):
        out["cases"][f"path{j}"] = eig_check(f"path{j}", H)
    bad = cases["spd6"][:4].clone()
    bad[1, 3, 2] = float("nan")
    w, v = sym_eig.sym_eig(bad)
    torch.cuda.synchronize()
    if not (bool(torch.isnan(w[1]).all()) and bool(torch.isnan(v[1]).all())
            and bool(torch.isfinite(w[[0, 2, 3]]).all())):
        raise AssertionError("sym_eig: a NaN matrix must give NaN, and only in its own outputs")
    log("kernel sym_eig nan: the NaN matrix's outputs are all NaN, its neighbours' finite")

    worst, worst64, plain64, skipped = 0.0, 0.0, 0.0, 0
    for H, g, cfg, _ in solves:
        dk, degk = gn_scan2map.solve_delta(H, g, cfg)
        dp, degp = plain_solve_delta(H, g, cfg)
        w64, v64 = torch.linalg.eigh(lower_sym(H).double())
        if bool(((w64 - cfg.degen_eig_thresh).abs() < 1e-4 * w64.abs().max()).any()):
            skipped += 1  # an eigenvalue on the threshold: either choice is right
            continue
        good = w64 > cfg.degen_eig_thresh
        inv = torch.where(good, 1.0 / torch.where(good, w64, torch.ones_like(w64)),
                          torch.zeros_like(w64))
        d64 = -(v64 * inv[None, :]) @ (v64.T @ g.double())
        d64 = d64 * torch.clamp(cfg.translation_clip / torch.clamp(
            torch.linalg.vector_norm(d64[3:]), min=1e-12), max=1.0)
        err = float(torch.linalg.vector_norm(dk - dp))
        if bool(degk) != bool(degp) or not err <= DELTA_RTOL * float(
                torch.linalg.vector_norm(dp)) + DELTA_ATOL:
            raise AssertionError(f"solve_delta with sym_eig: step {dk.tolist()} against "
                                 f"{dp.tolist()} with eigh (degenerate {bool(degk)}, "
                                 f"{bool(degp)})")
        worst = max(worst, err)
        worst64 = max(worst64, float(torch.linalg.vector_norm(dk.double() - d64)))
        plain64 = max(plain64, float(torch.linalg.vector_norm(dp.double() - d64)))
    out["delta"] = {"max_err": worst, "kernel_vs_fp64": worst64, "plain_vs_fp64": plain64,
                    "skipped_on_threshold": skipped}
    log(f"kernel sym_eig solve_delta: {len(solves) - skipped} steps of the main phase's last "
        f"scan, |step - eigh's step| at most {worst:.3g} (tolerance {DELTA_RTOL} relative + "
        f"{DELTA_ATOL}); against fp64: kernel {worst64:.3g}, eigh {plain64:.3g}; "
        f"{skipped} skipped (an eigenvalue on the threshold)")

    timing = {}
    for label, a in (("path 1x6x6", solves[-1][0]), ("batch 4096x6x6", cases["spd6"]),
                     ("batch 4096x3x3", cases["spd3"])):
        B = a.numel() // (a.shape[-1] ** 2)
        n = a.shape[-1]
        bound_ms, bound_by = bound(B * (2 * n * n + n) * 4.0, 9.0 * n ** 3 * B)

        def kern():
            return sym_eig.sym_eig(a)

        def plain():
            return sym_eig.sym_eig_ref(a)

        def library():
            return torch.linalg.eigh(a)

        rec = {"device_ms": device_ms(kern), "plain_device_ms": device_ms(plain),
               "library_device_ms": device_ms(library), "call_ms": cuda_ms(kern),
               "synced_ms": synced_ms(kern), "plain_synced_ms": synced_ms(plain),
               "bound_ms": bound_ms, "bound_by": bound_by}
        timing[label] = rec
        log(f"kernel sym_eig timing {label}: device kernel {rec['device_ms']} ms, eigh "
            f"{rec['plain_device_ms']} ms, library call (eigh again) "
            f"{rec['library_device_ms']} ms (torch.profiler; None: not measured); with a "
            f"sync each call: kernel {rec['synced_ms']:.4f} ms, eigh "
            f"{rec['plain_synced_ms']:.4f} ms (host clock, median of 50); bound "
            f"{bound_ms:.3g} ms ({bound_by}; operations counted as 9 n^3 flops a matrix, "
            f"at the f32 rate)")
    out["timing"] = timing
    out["max_abs_err"] = max(c["vals_abs"] for c in out["cases"].values())
    out["gn"] = gn_check(solves)
    return out


@contextlib.contextmanager
def swapped(module, **attrs):
    """While open, the module's attributes `attrs` are the values given."""
    saved = {k: getattr(module, k) for k in attrs}
    for k, v in attrs.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(module, k, v)


def captured_args(module, name: str, fn) -> tuple:
    """Call fn() and return the arguments of its last call of module.name."""
    spy = Capture(getattr(module, name))
    with swapped(module, **{name: spy}):
        fn()
    return spy.args


def bounded(n_bytes: int) -> dict:
    return dict(zip(("bound_ms", "bound_by"), bound(n_bytes, 0.0)))


def less(total, *parts):
    """total minus parts, None if any is (not measured)."""
    return None if total is None or None in parts else total - sum(parts)


def log_gn_timing(timing: dict) -> None:
    for k, v in timing.items():
        log(f"kernel gn timing {k}: device {v['device_ms']} ms (its own launch), the torch ops "
            f"it replaces {v['plain_device_ms']} ms ({v['plain']}) (torch.profiler; None: not "
            f"measured), bound {v['bound_ms']:.3g} ms ({v['bound_by']})")


def gn_check(solves: list) -> dict:
    """The 6-dof steps' kernels on the main phase's last-scan steps, bit for
    bit against the torch ops they replace on the same inputs: gn_rotation
    and gn_rows (gn_scan2map._rows) against rows_ref, gn_update
    (gn_scan2map.step) against step_ref; then each kernel's device time on
    its own launch at the path's shapes beside that of the torch ops it
    replaces, and its bound."""
    differ = {"gn_rows": 0, "gn_update": 0}
    for H, g, cfg, rec in solves:
        pose, corners, surfs, corr, _ = rec["ne"]
        got = gn_scan2map._rows(pose, corners, surfs, corr, cfg)
        want = gn_scan2map.rows_ref(pose, corners, surfs, corr, cfg)
        differ["gn_rows"] += sum(int((a != b).sum()) for a, b in zip(got, want))
        p, sq, nr = rec["pose"], rec["sq"], rec["n_rows"]
        pk, rk, dk = gn_scan2map.step(H, g, p, sq, nr, cfg)
        pt, rt, dt = gn_scan2map.step_ref(H, g, p, sq, nr, cfg)
        differ["gn_update"] += sum(int((a != b).sum()) for a, b in (
            (pk.q, pt.q), (pk.t, pt.t), (rk, rt), (dk, dt)))
    if any(differ.values()):
        raise AssertionError(f"gn kernels: entries that differ from the torch ops: {differ}")
    H, g, cfg, rec = solves[-1]
    pose, corners, surfs, corr, _ = rec["ne"]
    p, sq, nr = rec["pose"], rec["sq"], rec["n_rows"]
    nc, ns = corners.xyz.shape[0], surfs.xyz.shape[0]
    rows_args = captured_args(gn_kernels, "rows",
                              lambda: gn_scan2map._rows(pose, corners, surfs, corr, cfg))
    update_args = captured_args(gn_kernels, "update",
                                lambda: gn_scan2map.step(H, g, p, sq, nr, cfg))
    R = rows_args[0]
    # the torch ops _rows keeps around its kernels (R [x]x, n^T A), alone
    with swapped(gn_kernels, rotation=lambda q: R, rows=lambda *a: None):
        products_ms = device_ms(lambda: gn_scan2map._rows(pose, corners, surfs, corr, cfg))
    quat_ms = device_ms(lambda: so3.quat_to_matrix(pose.q))
    rows_ref_ms = device_ms(lambda: gn_scan2map.rows_ref(pose, corners, surfs, corr, cfg))
    # bytes each must move. gn_rows: points, fits, flags, R [x]x or n^T A read, the rows
    # written; gn_update: the step, its flags, the pose and stats read, pose and stats written
    timing = {
        "gn_rotation": {"device_ms": device_ms(lambda: gn_kernels.rotation(pose.q)),
                        "plain_device_ms": quat_ms, "plain": "so3.quat_to_matrix",
                        **bounded(16 + 36)},
        "gn_rows": {"device_ms": device_ms(lambda: gn_kernels.rows(*rows_args)),
                    "plain_device_ms": less(rows_ref_ms, products_ms, quat_ms),
                    "plain": f"rows_ref {rows_ref_ms} ms less the products _rows keeps "
                             f"{products_ms} ms and quat_to_matrix",
                    "rows": (nc, ns),
                    **bounded(nc * (36 + 1 + 36 + 12 + 72) + ns * (28 + 1 + 12 + 4 + 24) + 48)},
        "gn_update": {"device_ms": device_ms(lambda: gn_kernels.update(*update_args)),
                      "plain_device_ms": device_ms(lambda: gn_scan2map.update_ref(*update_args)),
                      "plain": "update_ref: the clip, boxplus and the rms after _delta",
                      **bounded(6 * 4 + 6 + 7 * 4 + 8 + 33)}}
    log(f"kernel gn: {len(solves)} steps of the main phase's last scan: gn_rows and gn_update "
        f"equal to the torch ops bit for bit ({differ})")
    log_gn_timing(timing)
    return {"differ": differ, "timing": timing}


@contextlib.contextmanager
def captured_subset_steps(steps: list):
    """While open, record a copy of the arguments of every two_step._step
    call (H, g, dofs, pose, solver config, sq, n_rows, prev)."""
    real = two_step._step

    def wrapper(H, g, idx, pose, cfg, sq, n_rows, prev=None):
        steps.append((H.clone(), g.clone(), idx, se3.Pose(pose.q.clone(), pose.t.clone()), cfg,
                      sq.clone(), n_rows.clone(),
                      None if prev is None else tuple(x.clone() for x in prev)))
        return real(H, g, idx, pose, cfg, sq, n_rows, prev)

    with swapped(two_step, _step=wrapper):
        yield steps


def subset_check(steps: list, solver) -> dict:
    """gn_subset (two_step._step) on the lego phase's last-scan steps, bit for
    bit against _step_ref on the same inputs; then its device time on its own
    launch for the surf step and the corner step (which merges the surf
    step's stats) beside _step_ref's, and its bound."""
    want = 2 * solver.n_outer * solver.n_inner
    if len(steps) != want:
        raise AssertionError(f"captured {len(steps)} two-step steps of the last lego scan, "
                             f"expected {want}")
    differ = 0
    for args in steps:
        (pk, rk, dk), (pt, rt, dt) = two_step._step(*args), two_step._step_ref(*args)
        differ += sum(int((a != b).sum()) for a, b in (
            (pk.q, pt.q), (pk.t, pt.t), (rk, rt), (dk, dt)))
    if differ:
        raise AssertionError(f"gn_subset: {differ} entries differ from _step_ref")
    timing = {}
    for label, args in (("gn_subset", steps[-1]), ("gn_subset surf step", steps[-2])):
        H, g, idx, pose, cfg, sq, nr, prev = args
        timing[label] = {
            "device_ms": device_ms(lambda: gn_kernels.subset_step(
                H, g, idx, cfg.degen_eig_thresh, pose, sq, nr, prev)),
            "plain_device_ms": device_ms(lambda: two_step._step_ref(*args)),
            "plain": "_step_ref: _solve_subset, boxplus and the stats", "dofs": idx,
            # H, g, the pose, the stats and the earlier step's read, pose and stats written
            **bounded(144 + 24 + 28 + 8 + (9 if prev is not None else 0) + 33)}
    log(f"kernel gn: {len(steps)} two-step steps of the lego phase's last scan: gn_subset equal "
        f"to _step_ref bit for bit ({differ} entries differ)")
    log_gn_timing(timing)
    return {"differ": {"gn_subset": differ}, "timing": timing}


def chunk_of(scans: list) -> ScanGrid:
    """Scans -> one ScanGrid with a leading chunk axis."""
    return ScanGrid(*(torch.stack(list(f)) for f in zip(*scans)))


def cat_results(results) -> tuple:
    """(positions (N,3), n_corner, n_surf) of a list of stacked ScanResults."""
    return (torch.cat([r.pose.t.reshape(-1, 3) for r in results]).cpu(),
            torch.cat([r.stats.n_corner.reshape(-1) for r in results]).cpu(),
            torch.cat([r.stats.n_surf.reshape(-1) for r in results]).cpu())


def the_graph(cfg, C: int) -> pipeline.ChunkGraph:
    graphs = [g for k, g in pipeline.chunk_graphs.items() if k[0] == cfg and k[1][0] == C]
    if len(graphs) != 1:
        raise AssertionError(f"expected one chunk graph for C={C}, found {len(graphs)}")
    return graphs[0]


def phase_chunk(device, main: dict, card: str) -> dict:
    """process_scan_chunk on the main phase's scans in chunks of CHUNK (see
    the module docstring, 6b), then one chunk of 2 scans of every other
    PipelineConfig preset against its sequential run on the card."""
    cfg = preset_aloam_kitti64()
    scans = main["scans"]
    chunks = [chunk_of(scans[k:k + CHUNK]) for k in range(0, N_SCANS, CHUNK)]
    pipeline.chunk_graphs.clear()
    start = moving_start(cfg, device)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, first = pipeline.process_scan_chunk(start, chunks[0], cfg)
    torch.cuda.synchronize()
    first_call_s = time.perf_counter() - t0
    graph = the_graph(cfg, CHUNK)
    per_scan = {"octant_knn": 4, **gn_expected(cfg, 1)}

    def counts():
        return {"octant_knn": octant_knn.launches, "sym_eig": sym_eig.launches,
                **gn_kernels.launches}

    capture = counts()
    # the first call runs one scan eagerly before it captures CHUNK scans
    for k, v in capture.items():
        if v != per_scan[k] * (CHUNK + 1):
            raise AssertionError(f"chunk: {k} launched {v} times in the first call, expected "
                                 f"{per_scan[k]} x ({CHUNK} captured + 1 warm-up scan)")
    results = [first]
    for ch in chunks[1:]:
        state, res = pipeline.process_scan_chunk(state, ch, cfg)
        results.append(res)
    torch.cuda.synchronize()
    replay_calls = {k: v - capture[k] for k, v in counts().items()}
    if any(replay_calls.values()):
        raise AssertionError(f"chunk: the replays called the kernels' wrappers: {replay_calls}")
    t, nc, ns = cat_results(results)
    st, snc, sns = cat_results(main["results"])
    dt = float((t - st).abs().max())
    bit_equal = bool(torch.equal(t, st))
    if not (dt <= CHUNK_POSE_TOL and torch.equal(nc, snc) and torch.equal(ns, sns)):
        raise AssertionError(f"chunk: poses {dt:.3g} m from the sequential run (tolerance "
                             f"{CHUNK_POSE_TOL}), n_corner {nc.tolist()} / {snc.tolist()}, "
                             f"n_surf {ns.tolist()} / {sns.tolist()}")
    log(f"chunk: {N_SCANS} scans as {len(chunks)} chunks of {CHUNK}: poses against the "
        f"main phase's sequential run max |dt| = {dt:.3g} m (bit for bit: {bit_equal}), "
        f"correspondence counts equal; first call {first_call_s:.2f} s (warm-up scan and "
        f"capture {graph.capture_s:.2f} s), graph pool {graph.pool_bytes} bytes; kernels "
        f"launched in the first call {capture} (1 warm-up scan + {CHUNK} captured), wrapper "
        f"calls during {len(chunks) - 1} replays {replay_calls}")

    syncs, sites = [], collections.Counter()
    state = moving_start(cfg, device)
    for ch in chunks:
        with counted_syncs(syncs, sites):
            state, _ = pipeline.process_scan_chunk(state, ch, cfg)
    if any(syncs):
        raise AssertionError(f"chunk: host syncs in a replayed chunk call: {syncs}, "
                             f"{dict(sites)}")

    state = moving_start(cfg, device)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        pipeline.process_scan_chunk(state, chunks[0], cfg)
        torch.cuda.synchronize()
    events = prof.events()
    graph_launches = sum(1 for e in events if "GraphLaunch" in e.name)
    runtime_calls = collections.Counter(e.name for e in events if e.name.startswith("cuda")
                                        and e.device_type != torch.autograd.DeviceType.CUDA)
    device_us = sum(e.device_time_total for e in events
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and not getattr(e, "is_user_annotation", False))
    if runtime_calls and graph_launches != 1:
        raise AssertionError(f"chunk: {graph_launches} graph launches in one chunk call "
                             f"(runtime calls {dict(runtime_calls)})")

    def seq_run():
        st = moving_start(cfg, device)
        for s in scans:
            st, _ = process_scan(st, s, cfg)
        return st

    def chunk_run():
        st = moving_start(cfg, device)
        for ch in chunks:
            st, _ = pipeline.process_scan_chunk(st, ch, cfg)
        return st

    rates = {"sequential": [], "chunked": []}
    for name, fn in (("sequential", seq_run), ("chunked", chunk_run), ("chunked", chunk_run),
                     ("sequential", seq_run)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        rates[name].append(N_SCANS / (time.perf_counter() - t0))
    wall_us = N_SCANS / max(rates["chunked"]) / len(chunks) * 1e6  # a chunk, unprofiled
    busy = device_us / wall_us if device_us else None
    log(f"chunk: host syncs per replayed chunk {syncs}; one chunk call: "
        f"{graph_launches} graph launch(es), CUDA runtime calls {dict(runtime_calls)} "
        f"(torch.profiler); device time {device_us / 1e3:.3f} ms a chunk, busy share during "
        f"a replay {busy} (device time over the unprofiled chunk's host time); scans/s "
        f"chunked {rates['chunked']} against sequential {rates['sequential']} (turns "
        f"seq, chunk, chunk, seq; host clock, one sync a run); on {card}")

    presets_out = {}
    lego_scans, _, _ = ref_arc(device, 0, 18.0, LEGO_RINGS, fov_up_deg=15.0, fov_down_deg=-15.0)
    for name, pcfg, pscans in (
            ("aloam-ref", presets.preset_aloam_kitti64_ref(), scans[:2]),
            ("lego-ref", presets.preset_lego_vlp16_ref(), lego_scans[:2]),
            ("liosam-ref", presets.preset_liosam_vlp16_ref(), lego_scans[:2]),
            ("lego_vlp16", config.preset_lego_vlp16(), lego_scans[:2]),
            ("sim16", config.preset_sim16(), lego_scans[:2])):
        st = init_state(pcfg, device)
        seq = []
        for s in pscans:
            st, r = process_scan(st, s, pcfg)
            seq.append(r)
        _, res = pipeline.process_scan_chunk(init_state(pcfg, device), chunk_of(pscans), pcfg)
        _, again = pipeline.process_scan_chunk(init_state(pcfg, device), chunk_of(pscans), pcfg)
        torch.cuda.synchronize()
        t, nc, ns = cat_results([res])
        ta, _, _ = cat_results([again])
        st_t, snc, sns = cat_results(seq)
        g = the_graph(pcfg, 2)
        rec = {"max_dt_m": float((t - st_t).abs().max()), "bit_equal": bool(torch.equal(t, st_t)),
               "replay_equal": bool(torch.equal(t, ta)),
               "counts_equal": bool(torch.equal(nc, snc) and torch.equal(ns, sns)),
               "capture_s": g.capture_s, "pool_bytes": g.pool_bytes}
        presets_out[name] = rec
        log(f"chunk {name}: 2 scans {tuple(pscans[0].xyz.shape[:2])} as one captured chunk: "
            f"{rec}")
        if not (rec["max_dt_m"] <= POSE_T_TOL and rec["replay_equal"]):
            raise AssertionError(f"chunk {name}: {rec}")
    out = {"chunk": CHUNK, "max_dt_m": dt, "bit_equal": bit_equal, "capture_s": graph.capture_s,
           "first_call_s": first_call_s, "pool_bytes": graph.pool_bytes,
           "launched_in_first_call": capture, "syncs_per_chunk": syncs,
           "graph_launches_per_chunk": graph_launches if runtime_calls else None,
           "device_ms_per_chunk": device_us / 1e3, "busy_share": busy,
           "scans_per_s": rates, "presets": presets_out}
    pipeline.chunk_graphs.clear()  # the graphs' pools go back to the allocator
    return out


def lio_sweeps(n_scans: int, device, rings: int = RINGS, fov_up_deg: float = 2.0,
               fov_down_deg: float = -24.8):
    """bench.py's LIO workload made on `device`: ScanGrids along the circle
    (world seed 3, 48 pillars, extent 35 m, 10 Hz; 64x1800 and HDL-64's
    field of view unless asked otherwise), exact 200 Hz IMU windows, and the
    scan-end ground-truth positions."""
    world = default_world(seed=3, n_pillars=48, extent=35.0, device=device)
    sweeps, gt = [], []
    for i in range(n_scans):
        t0, t1 = i * LIO_SCAN_DT, (i + 1) * LIO_SCAN_DT
        p0 = circle_pose(t0, LIO_RADIUS, LIO_OMEGA, device=device)
        p1 = circle_pose(t1, LIO_RADIUS, LIO_OMEGA, device=device)
        s = simulate_scan(world, p0, p1, rings=rings, width=WIDTH, fov_up_deg=fov_up_deg,
                          fov_down_deg=fov_down_deg, max_range=80.0, noise_std=0.01, seed=i)
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


def timed_stages(step, items, targets) -> tuple[dict, dict]:
    """The synchronized stage split of step(item) over `items`: the
    module-level functions `targets` ((module, name) pairs, or (module,
    name, label) with a label as profile_engines.Stages takes it) timed by
    the stage profiler's Stages, each call on its own (nested=True: a stage
    called inside another is timed too), and the whole step as "scan".
    Returns (ms per item, calls per item) by label."""
    st = Stages("time", cuda=True, nested=True)
    run = st.wrap("scan", step)
    with patched(st, [(*t, t[1]) if len(t) == 2 else t for t in targets]):
        for it in items:
            run(it)
    st.end_step()
    return ({k: sum(v) / len(items) for k, v in st.values.items()},
            {k: st.calls[k] / len(items) for k in st.values})


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
    with profiling() as rec:
        t0 = time.perf_counter()
        for _ in range(LIO_PROFILE_SCANS):
            pts, tt, m, win = next(rest)
            state, _ = lio.process_lio_scan(state, pts, tt, m, win, cfg)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernel_us, n_launch = rec["device_ms"] * 1e3, rec["launches"]
    busy = kernel_us / 1e3 / wall_ms if kernel_us > 0 else None
    box = [state]

    def step(item):
        box[0], _ = lio.process_lio_scan(box[0], *item, cfg)

    stage_ms, calls = timed_stages(step, [next(rest) for _ in range(LIO_PROFILE_SCANS)], [
        (lio, "_propagate_window"), (lio, "undistort_to_end"), (lio, "voxel_downsample"),
        (lio, "update_iterated"), (lio, "insert_with_stats"), (lio, "bound_map"),
        (ieskf, "knn_cand"), (ieskf, "_h_model"), (ieskf, "_ktab")])
    state = box[0]
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


def run_slam(device, scans: list, marks: list | None = None, stages: Stages | None = None,
             syncs: list | None = None, sites: collections.Counter | None = None,
             gps: dict | None = None) -> dict:
    """SlamDriver over `scans` on `device`, started moving, with
    close_loop_external(n - 1, 0) after the first SLAM_CLOSE_AFTER scans.
    With `marks`, a CUDA event is recorded there before the first scan, after
    each scan and after the closure, each followed by a synchronize; with
    `stages`, the closure's stages are timed there (synchronized); with
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
            targets = [(slam_pipeline, n, n) for n in ("align_loop", "_correct_and_rebuild",
                                                        "solve_pose_graph", "_chunked_insert")]
            t0 = time.perf_counter()
            slam_pipeline.align_loop = align_kept
            try:
                with (patched(stages, targets) if stages is not None
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
    marks, stages = [], Stages("time", cuda=True, nested=True)
    reset_launches()
    torch.cuda.synchronize()
    run = run_slam(device, scans, marks, stages)
    stages.end_step()
    cfg, drv, results, clo = (run[k] for k in ("cfg", "driver", "results", "closure"))
    launches, eig_launches = octant_knn.launches, sym_eig.launches
    gn_launches = dict(gn_kernels.launches)
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
            f"{k} {sum(v):.2f} ({stages.calls[k]})" for k, v in stages.values.items())
        + f"; on {card}")
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
            "eig_launches": eig_launches, "gn_launches": gn_launches,
            "syncs": syncs, "stage_ms": {k: sum(v) for k, v in stages.values.items()},
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
    reset_launches()
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
    launches, eig_launches = octant_knn.launches, sym_eig.launches
    gn_launches = dict(gn_kernels.launches)
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
    stage_ms, calls = timed_stages(lambda item: drv.process(*item), list(rest), [
        (liosam_pipeline, n) for n in (
            "preintegrate", "deskew_with_imu", "extract_features", "voxel_downsample",
            "solve_scan2map", "_fuse", "insert_with_stats", "bound_map", "_keyframe_step_body",
            "detect_loop")])
    log("liosam: synchronized stage times, ms per scan (calls per scan): " + ", ".join(
        f"{k} {v:.2f} ({calls[k]:g})" for k, v in stage_ms.items())
        + f"; on {card}")
    return {"sweeps": sweeps[:N_SCANS], "gt": gt[:N_SCANS], "results": results, "ate": ate,
            "scans_per_s": steady, "first_ms": first_ms, "launches": launches,
            "eig_launches": eig_launches, "gn_launches": gn_launches,
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
    reset_launches()
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
    launches, eig_launches = octant_knn.launches, sym_eig.launches
    gn_launches = dict(gn_kernels.launches)
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

    stage_ms, stage_calls = timed_stages(lambda item: drv.process(*item), sweeps[N_SCANS:], [
        (livox_pipeline, n) for n in (
            "remove_dynamic", "extract_livox_features", "voxel_downsample", "preintegrate",
            "solve_window", "marginalize_oldest", "insert_with_stats", "bound_map")] + [
        (window_map, n) for n in ("associate_window", "_window_normal_eq", "_imu_jacobian")])
    log("livox: synchronized stage times, ms per engaged sweep (calls per sweep): " + ", ".join(
        f"{k} {v:.2f} ({stage_calls[k]:g})" for k, v in stage_ms.items())
        + f"; on {card}")
    if not _livox_finite(drv.state):
        raise AssertionError("livox: non-finite window state in the measured sweeps")
    return {"sweeps": sweeps[:N_SCANS], "gt": gt, "results": results, "engaged": engaged,
            "ate": ate, "scans_per_s": steady, "first_ms": ms[0],
            "engage_ms": ms[first_engaged], "launches": launches, "per_scan": per_scan,
            "eig_launches": eig_launches, "gn_launches": gn_launches,
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


# --- the reference presets (phases 15-19) ----------------------------------


def ref_arc(device, world_seed: int, extent: float, rings: int, **fov):
    """tests/test_reference_presets.py's arc from rest (0.35 m and 0.03 rad
    of yaw a scan, noise 0.005 m) in default_world(world_seed, extent), at
    rings x WIDTH: the scans, made on `device`, and the ground truth at each
    sweep start (positions, and quaternions as x, y, z, w)."""
    world = default_world(seed=world_seed, extent=extent, device=device)
    yaw = so3.quat_exp(torch.tensor([0.0, 0.0, REF_YAW], device=device))
    fwd = torch.tensor([REF_STEP, 0.0, 0.0], device=device)
    q, t = so3.quat_identity(device=device), torch.zeros(3, device=device)
    scans, gt_t, gt_q = [], [], []
    for i in range(N_SCANS):
        p0 = se3.Pose(q, t)
        q = so3.quat_normalize(so3.quat_mul(q, yaw))
        t = t + so3.quat_rotate(q, fwd)
        scans.append(simulate_scan(world, p0, se3.Pose(q, t), rings=rings, width=WIDTH,
                                   noise_std=0.005, seed=i, **fov))
        gt_t.append(p0.t.cpu().numpy())
        gt_q.append(p0.q.cpu().numpy()[[1, 2, 3, 0]])
    return scans, np.stack(gt_t), np.stack(gt_q)


def traj_metrics(est_t, est_q, gt_t, gt_q) -> dict:
    """ATE (no alignment), RPE over one scan (local frames) and the KITTI
    drift metric over REF_DRIFT_LENGTHS (this path is about 4 m long);
    quaternions x, y, z, w."""
    d = kitti_drift(est_t, gt_t, est_q, gt_q, lengths=REF_DRIFT_LENGTHS, step=1)
    return {"ate": ate_rmse(est_t, gt_t, align=False),
            "rpe": rpe_rmse(est_t, gt_t, 1, est_q, gt_q),
            "t_rel_pct": d["t_rel_pct"], "r_deg_per_m": d["r_deg_per_m"],
            "drift_segments": d["n_segments"]}


def fmt_metrics(m: dict) -> str:
    return (f"ATE={m['ate']:.4f} m, RPE={m['rpe']:.4f} m, drift {m['t_rel_pct']:.3f}% and "
            f"{m['r_deg_per_m']:.5f} deg/m over {m['drift_segments']} segments of "
            f"{REF_DRIFT_LENGTHS} m")


def on_cpu(x):
    """A tensor, or a (named) tuple of them, copied to the CPU."""
    if isinstance(x, torch.Tensor):
        return x.cpu()
    if hasattr(x, "_fields"):
        return type(x)(*map(on_cpu, x))
    return tuple(map(on_cpu, x))


@contextlib.contextmanager
def odometry_stage_spy(cfg, record: list):
    """While open, each call of the odometry stage's solve (solve_scan2map
    on cfg.odom_map, from runtime.pipeline) appends (its GnStats, the
    octant launches it made) to `record`."""
    real = pipeline.solve_scan2map

    def spy(*a, **kw):
        before = octant_knn.launches
        pose, stats = real(*a, **kw)
        if a[5] == cfg.odom_map:
            record.append((stats, octant_knn.launches - before))
        return pose, stats

    pipeline.solve_scan2map = spy
    try:
        yield record
    finally:
        pipeline.solve_scan2map = real


def is_card(device) -> bool:
    return torch.device(device).type == "cuda"


def drive(step, items, device, calls: list | None = None, steps: list | None = None) -> dict:
    """step(item) -> pose over `items` on `device`, synchronized after each:
    the poses (quaternions as x, y, z, w), the octant launches per item and,
    on the card, the first item's ms and items/s over those after the first
    N_WARM and before the last (CUDA events). With `calls`, the octant calls
    of the last item are captured there (outside the timing window), the
    first on each map; with `steps`, the last item's two-step steps
    (captured_subset_steps). The launches of sym_eig and the Gauss-Newton
    kernels over the run are counted too."""
    reset_launches()
    per_scan, est_t, est_q = [], [], []
    cuda = is_card(device)
    if cuda:
        torch.cuda.synchronize()
        marks = [torch.cuda.Event(enable_timing=True)]
        marks[0].record()
    for i, item in enumerate(items):
        before = octant_knn.launches
        last = i == len(items) - 1
        with contextlib.ExitStack() as capture:
            if last and calls is not None:
                capture.enter_context(captured_knn_calls(calls))
            if last and steps is not None:
                capture.enter_context(captured_subset_steps(steps))
            pose = step(item)
        if cuda:
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
            torch.cuda.synchronize()
        per_scan.append(octant_knn.launches - before)
        est_t.append(pose.t.cpu().numpy())
        est_q.append(pose.q.cpu().numpy()[[1, 2, 3, 0]])
    est_t, est_q = np.stack(est_t), np.stack(est_q)
    if not (np.all(np.isfinite(est_t)) and np.all(np.isfinite(est_q))):
        raise AssertionError("non-finite pose")
    out = {"per_scan": per_scan, "launches": octant_knn.launches,
           "eig_launches": sym_eig.launches, "gn_launches": dict(gn_kernels.launches),
           "est_t": est_t, "est_q": est_q}
    if cuda:
        out["first_ms"] = marks[0].elapsed_time(marks[1])
        out["scans_per_s"] = ((len(items) - 1 - N_WARM) * 1e3
                              / marks[N_WARM].elapsed_time(marks[-2]))
    if calls:
        calls[:] = [c for j, c in enumerate(calls) if all(c[4] != d[4] for d in calls[:j])]
    return out


def run_feature_engine(cfg, scans, device, odom: list | None = None,
                       calls: list | None = None, steps: list | None = None) -> dict:
    """process_scan from rest over `scans` on `device` (drive), with the
    results and the final state; with `odom`, the odometry stage's GnStats
    and launches (odometry_stage_spy)."""
    box, results = [init_state(cfg, device)], []

    def step(s):
        box[0], res = process_scan(box[0], s, cfg)
        results.append(res)
        return res.pose

    with (odometry_stage_spy(cfg, odom) if odom is not None else contextlib.nullcontext()):
        out = drive(step, scans, device, calls, steps)
    return {**out, "state": box[0], "results": results}


def frame_errors(run: dict, gt_t: np.ndarray, label: str) -> np.ndarray:
    """Per-frame position errors (m) against the sweep-start ground truth;
    raises above REF_FRAME_BOUND (the bound of tests/test_reference_presets.py)."""
    err = np.linalg.norm(run["est_t"] - gt_t, axis=1)
    if not err.max() < REF_FRAME_BOUND:
        raise AssertionError(f"{label}: per-frame error {err.max():.4f} m above "
                             f"{REF_FRAME_BOUND} m: {err.round(4).tolist()}")
    return err


def feature_syncs_and_stages(cfg, scans, device, targets, label: str, card: str) -> dict:
    """The host syncs of each scan by call site (a run of its own, from
    rest), then the synchronized stage split over REF_STAGE_SCANS scans after
    the first N_WARM (another run from rest)."""
    syncs, sites = [], collections.Counter()
    state = init_state(cfg, device)
    for s in scans:
        with counted_syncs(syncs, sites):
            state, _ = process_scan(state, s, cfg)
    log(f"{label}: host syncs per scan {syncs} (sync debug mode); by call site: "
        f"{dict(sites.most_common())}")
    box = [init_state(cfg, device)]
    for s in scans[:N_WARM]:
        box[0], _ = process_scan(box[0], s, cfg)

    def step(s):
        box[0], _ = process_scan(box[0], s, cfg)

    stage_ms, calls = timed_stages(step, scans[N_WARM:N_WARM + REF_STAGE_SCANS], targets)
    log(f"{label}: synchronized stage times, ms per scan (calls per scan): " + ", ".join(
        f"{k} {v:.2f} ({calls[k]:g})" for k, v in stage_ms.items()) + f"; on {card}")
    return {"syncs": syncs, "sync_sites": dict(sites), "stage_ms": stage_ms}


def _odom_solve_label(*a, **kw) -> str:
    return "odom_solve" if a[5].neighborhood == "full27" else "solve_scan2map"


def phase_aloam_ref(device, card: str) -> dict:
    """preset_aloam_kitti64_ref() exactly (the odometry stage on every scan)
    on 12 HDL-64-scale scans (64x1800, +2.0/-24.8 deg) of the reference
    presets' arc from rest in default_world(seed=2, extent=30), through
    process_scan. Checks: finite poses, every per-frame error under 0.35 m,
    the octant kernel 4 times a scan in the scan-to-map solve and never in
    the odometry stage (its maps are full27), the stage's correspondences
    from the second scan on. Prints ATE, RPE, drift, scans/s, then host
    syncs by site and the synchronized stage split (runs of their own)."""
    cfg = presets.preset_aloam_kitti64_ref()
    scans, gt_t, gt_q = ref_arc(device, 2, 30.0, RINGS, fov_up_deg=2.0, fov_down_deg=-24.8)
    odom, calls = [], []
    run = run_feature_engine(cfg, scans, device, odom, calls)
    odom_n = [n for _, n in odom]
    s2m_n = [a - b for a, b in zip(run["per_scan"], odom_n)]
    odom_corr = [(int(st.n_corner), int(st.n_surf)) for st, _ in odom]
    log(f"aloam-ref: {N_SCANS} scans {RINGS}x{WIDTH} points/scan={int(scans[0].mask.sum())}; "
        f"octant_knn launches per scan: scan-to-map {s2m_n}, odometry stage {odom_n}; "
        f"odometry stage (n_corner, n_surf) {odom_corr}; scan-to-map n_surf "
        f"{[int(r.stats.n_surf) for r in run['results']]}")
    if len(odom) != N_SCANS or any(n != 0 for n in odom_n) or any(n != 4 for n in s2m_n):
        raise AssertionError("aloam-ref: the octant kernel must run 4 times a scan in the "
                             "scan-to-map solve and never in the odometry stage")
    if is_card(device):
        check_gn_launches("aloam-ref", cfg, len(scans), {**run["gn_launches"],
                                                         "sym_eig": run["eig_launches"]})
    if min(c + s for c, s in odom_corr[1:]) == 0:
        raise AssertionError(f"aloam-ref: the odometry stage found no correspondences: "
                             f"{odom_corr}")
    err = frame_errors(run, gt_t, "aloam-ref")
    m = traj_metrics(run["est_t"], run["est_q"], gt_t, gt_q)
    log(f"aloam-ref: per-frame error max {err.max():.4f} m (bound {REF_FRAME_BOUND}); "
        f"{fmt_metrics(m)}; first scan {run['first_ms']:.1f} ms; steady "
        f"{run['scans_per_s']:.2f} scans/s over scans {N_WARM}..{N_SCANS - 2} (CUDA events "
        f"between synchronized scans), on {card}")
    targets = [(pipeline, n) for n in ("extract_features_timed", "voxel_downsample_aux",
                                       "insert_with_stats", "bound_map")] + [
        (pipeline, "insert", "odom_insert"), (pipeline, "solve_scan2map", _odom_solve_label)]
    prof = feature_syncs_and_stages(cfg, scans, device, targets, "aloam-ref", card)
    return {**run, **prof, **m, "scans": scans, "gt_t": gt_t, "gt_q": gt_q, "odom": odom_corr,
            "calls": calls}


def compare_cpu(run: dict, cfg, label: str) -> dict:
    """The same scans with CPU tensors: the CPU run's poses against the
    card's and its metrics."""
    cpu = run_feature_engine(cfg, [on_cpu(s) for s in run["scans"]], "cpu")
    worst_t = float(np.abs(cpu["est_t"] - run["est_t"]).max())
    wq = [(r.pose.q - g.pose.q.cpu()).abs().max() for r, g in zip(cpu["results"], run["results"])]
    worst_q = float(max(wq))
    m = traj_metrics(cpu["est_t"], cpu["est_q"], run["gt_t"], run["gt_q"])
    log(f"{label}: {len(run['scans'])} scans with CPU tensors: {fmt_metrics(m)} (card ATE "
        f"{run['ate']:.4f}, bound {3 * m['ate']:.4f}); against the card max |dt|="
        f"{worst_t:.3g} m, max |dq|={worst_q:.3g}")
    return {**cpu, **m, "worst_t": worst_t, "worst_q": worst_q}


def phase_aloam_ref_cpu(run: dict) -> None:
    cpu = compare_cpu(run, presets.preset_aloam_kitti64_ref(), "aloam-ref-cpu")
    if cpu["worst_t"] > POSE_T_TOL or cpu["worst_q"] > POSE_Q_TOL:
        raise AssertionError("card and CPU aloam-ref poses disagree")
    if not run["ate"] < 3 * cpu["ate"]:
        raise AssertionError(f"aloam-ref ATE {run['ate']:.4f} m above 3x the CPU's")


def seg_counts(scans) -> list:
    """segment_scan of each scan: (ground pixels, segmented pixels, distinct
    valid-cluster labels) and the segmentation itself."""
    out = []
    for s in scans:
        seg = segmentation.segment_scan(s)
        out.append(((int(seg.ground.sum()), int(seg.segmented.sum()),
                     int(torch.unique(seg.labels[seg.segmented]).numel())), seg))
    return out


def phase_lego(device, card: str) -> dict:
    """preset_lego_vlp16_ref() exactly on 12 VLP-16 scans at full width
    (16x1800, +-15 deg) of the reference presets' arc from rest in
    default_world(seed=0, extent=18), through process_scan: segmentation,
    the two-step solve, full27 maps. Checks: ground and segmented pixels in
    every scan, every per-frame error under 0.35 m, no octant launch. Prints
    the segmentation counts, ATE, RPE, drift, scans/s, host syncs by site
    and the stage split (segment_scan on its own line: it runs inside the
    feature extraction). On the card, the last scan's two-step steps are
    captured and held to the torch step (subset_check). Then
    preset_lego_vlp16() (the engine default, 4 x 3 two-step) over the same
    scans: finite, under the same bound."""
    cfg = presets.preset_lego_vlp16_ref()
    scans, gt_t, gt_q = ref_arc(device, 0, 18.0, LEGO_RINGS)
    segs = seg_counts(scans)
    counts = [c for c, _ in segs]
    log(f"lego: {N_SCANS} scans {LEGO_RINGS}x{WIDTH} points/scan={int(scans[0].mask.sum())}; "
        f"(ground, segmented, clusters) per scan {counts}")
    if any(g == 0 or s == 0 for g, s, _ in counts):
        raise AssertionError("lego: a scan without ground or segmented pixels")
    steps = []
    run = run_feature_engine(cfg, scans, device, steps=steps)
    if run["launches"] != 0:
        raise AssertionError(f"lego: {run['launches']} octant launches on full27 maps")
    if is_card(device):
        check_gn_launches("lego", cfg, len(scans), {**run["gn_launches"],
                                                    "sym_eig": run["eig_launches"]})
        run["subset"] = subset_check(steps, cfg.solver)
    err = frame_errors(run, gt_t, "lego")
    m = traj_metrics(run["est_t"], run["est_q"], gt_t, gt_q)
    log(f"lego: octant_knn launches {run['launches']}; n_corner "
        f"{[int(r.stats.n_corner) for r in run['results']]} n_surf "
        f"{[int(r.stats.n_surf) for r in run['results']]}; per-frame error max "
        f"{err.max():.4f} m (bound {REF_FRAME_BOUND}); {fmt_metrics(m)}; first scan "
        f"{run['first_ms']:.1f} ms; steady {run['scans_per_s']:.2f} scans/s over scans "
        f"{N_WARM}..{N_SCANS - 2}, on {card}")
    targets = [(curvature, "segment_scan")] + [(pipeline, n) for n in (
        "extract_features_timed", "voxel_downsample_aux", "solve_scan2map_two_step",
        "insert_with_stats", "bound_map")] + [(two_step, n) for n in (
            "associate", "normal_equations", "_step")]
    prof = feature_syncs_and_stages(cfg, scans, device, targets, "lego", card)
    default = run_feature_engine(config.preset_lego_vlp16(), scans, device)
    derr = frame_errors(default, gt_t, "lego (preset_lego_vlp16)")
    log(f"lego: preset_lego_vlp16() over the same scans: per-frame error max "
        f"{derr.max():.4f} m; ATE={ate_rmse(default['est_t'], gt_t, align=False):.4f} m; "
        f"steady {default['scans_per_s']:.2f} scans/s")
    return {**run, **prof, **m, "scans": scans, "gt_t": gt_t, "gt_q": gt_q,
            "segs": [seg for _, seg in segs], "default_scans_per_s": default["scans_per_s"]}


def seg_angles(scan):
    """The angles segmentation.py tests against its thresholds, in degrees:
    the ground test's pitch to the ring above, and the cluster criterion's
    beta to the right and upper neighbours."""
    xyz = scan.xyz
    d = torch.roll(xyz, -1, dims=0) - xyz
    pitch = torch.rad2deg(torch.atan2(d[..., 2], torch.sqrt(d[..., 0] ** 2 + d[..., 1] ** 2)
                                      + 1e-9))
    r = torch.linalg.vector_norm(xyz, dim=-1)

    def beta(other, alpha):
        a = torch.full((), alpha, dtype=torch.float32, device=xyz.device)
        d1, d2 = torch.maximum(r, other), torch.minimum(r, other)
        return torch.rad2deg(torch.atan2(d2 * torch.sin(a), d1 - d2 * torch.cos(a) + 1e-9))

    return (pitch, beta(torch.roll(r, -1, dims=1), 2.0 * np.pi / scan.width),
            beta(torch.roll(r, -1, dims=0), np.radians(2.0)))


def phase_lego_cpu(run: dict) -> None:
    """The lego scans with CPU tensors. Where the card's and the CPU's ground
    and segmented masks agree in every scan, poses within POSE_T_TOL /
    POSE_Q_TOL; where they differ, the card's ATE under 3x the CPU's, and
    every pixel or edge whose test flips must lie within SEG_MARGIN_DEG of
    its threshold (rounding), else the difference is a fault."""
    sc = segmentation.SegmentationConfig()
    n_diff, margins = [], []
    for s, seg in zip(run["scans"], run["segs"]):
        h = on_cpu(s)
        cpu = segmentation.segment_scan(h)
        n_diff.append(int(((seg.ground.cpu() != cpu.ground)
                           | (seg.segmented.cpu() != cpu.segmented)).sum()))
        if not n_diff[-1]:
            continue
        pitch_c, *beta_c = [a.cpu() for a in seg_angles(s)]
        pitch_h, *beta_h = seg_angles(h)
        g_th, c_th = sc.ground_angle_deg, sc.cluster_angle_deg
        g_flip = (pitch_c.abs() <= g_th) != (pitch_h.abs() <= g_th)
        flips = torch.cat([(pitch_h.abs() - g_th)[g_flip & h.mask]] + [
            (b_h - c_th)[((b_c > c_th) != (b_h > c_th)) & h.mask]
            for b_c, b_h in zip(beta_c, beta_h)])
        margins.append([round(float(x), 6) for x in flips])
        if flips.numel() == 0 or float(flips.abs().max()) > SEG_MARGIN_DEG:
            raise AssertionError(f"lego-cpu: segmentation differs in {n_diff[-1]} pixels, with "
                                 f"threshold flips at margins {margins[-1]} (deg; limit "
                                 f"{SEG_MARGIN_DEG})")
    log(f"lego-cpu: pixels whose ground or segmented differs, card vs CPU, per scan {n_diff}; "
        f"margins of the flipped tests to their thresholds (deg) {margins}")
    cpu = compare_cpu(run, presets.preset_lego_vlp16_ref(), "lego-cpu")
    if sum(n_diff) == 0:
        if cpu["worst_t"] > POSE_T_TOL or cpu["worst_q"] > POSE_Q_TOL:
            raise AssertionError("card and CPU lego poses disagree")
    elif not run["ate"] < 3 * cpu["ate"]:
        raise AssertionError(f"lego ATE {run['ate']:.4f} m above 3x the CPU's {cpu['ate']:.4f}")


def liosam_ref_config():
    """preset_liosam_vlp16_ref() with LioSamRefParams threaded into the
    SlamConfig and LioSamConfig, as the reference runner threads them."""
    rp = presets.LioSamRefParams()
    slam = slam_pipeline.SlamConfig(
        pipeline=presets.preset_liosam_vlp16_ref(), kf_dist=rp.kf_dist, kf_angle=rp.kf_angle,
        loop=LoopConfig(radius=rp.loop_radius, min_stamp_sep=300,  # 30 s at 10 Hz
                        submap_half=rp.loop_submap // 2, fitness_thresh=rp.loop_fitness))
    return liosam_pipeline.LioSamConfig(slam=slam, imu_noise=rp.imu_noise())


def preset_engines():
    """name -> (make(device) -> (step(item) -> pose (t, q), state finite?),
    the octant kernel serves it)."""
    def liosam(device):
        drv = liosam_driver(liosam_ref_config(), device)

        def step(item):
            return drv.process(*item).pose

        return step, lambda: all(bool(torch.isfinite(a).all()) for a in (
            *drv.state.engine.pose, drv.state.v, drv.state.bg, drv.state.ba, drv.state.P))

    def avia(device):
        cfg = presets.lio_config_avia_ref()
        box = [lio_start(cfg, device)]

        def step(item):
            box[0], res = lio.process_lio_scan(box[0], *item, cfg)
            return se3.Pose(res.x.q, res.x.p)

        return step, lambda: _finite(box[0])

    def horizon(device):
        drv = livox_pipeline.LivoxDriver(
            presets.livox_config_horizon_ref(), init_frames=LIVOX_INIT_FRAMES,
            x0=circle_pose(0.0, LIO_RADIUS, LIO_OMEGA, device=device), device=device)

        def step(item):
            return drv.process(*item).pose

        return step, lambda: _livox_finite(drv.state)

    return {"liosam-ref": (liosam, False), "avia-ref": (avia, False),
            "horizon-ref": (horizon, True)}


def run_preset(make, items, device, calls: list | None = None) -> dict:
    step, finite = make(device)
    out = drive(step, items, device, calls)
    if not finite():
        raise AssertionError("non-finite state")
    return out


def phase_presets(device, lio_run: dict, livox_run: dict, card: str) -> dict:
    """The other reference presets, each through its engine for PRESET_SCANS
    scans on the card, then on the CPU: LioSamDriver with
    preset_liosam_vlp16_ref() and LioSamRefParams on 16x1800 sweeps of the
    LIO circle with their IMU windows; process_lio_scan with
    lio_config_avia_ref() (a full27 map of 2^17 slots: the gather path, the
    s-form gate) on the lio phase's 64x1800 scans; LivoxDriver with
    livox_config_horizon_ref() (dynamic removal, 5 passes, the octant kernel
    on its three class maps) on the livox phase's sweeps. Checks: finite
    state, the octant launches (none on full27 maps, some on every livox
    sweep), the card's ATE under 3x the CPU's."""
    sweeps16, gt16 = lio_sweeps(PRESET_SCANS, device, rings=LEGO_RINGS, fov_up_deg=15.0,
                                fov_down_deg=-15.0)
    inputs = {"liosam-ref": (sweeps16, gt16),
              "avia-ref": (lio_run["items"][:PRESET_SCANS], lio_run["gt"][:PRESET_SCANS]),
              "horizon-ref": (livox_run["sweeps"][:PRESET_SCANS], livox_run["gt"][:PRESET_SCANS])}
    out = {}
    for name, (make, octant) in preset_engines().items():
        items, gt = inputs[name]
        calls = [] if octant else None
        card_run = run_preset(make, items, device, calls)
        cpu_run = run_preset(make, [on_cpu(it) for it in items], "cpu")
        ate, ate_cpu = (ate_rmse(r["est_t"], gt, align=False) for r in (card_run, cpu_run))
        log(f"presets {name}: {len(items)} scans; octant_knn launches per scan "
            f"{card_run['per_scan']}; ATE={ate:.4f} m (CPU {ate_cpu:.4f}, bound "
            f"{3 * ate_cpu:.4f}); card vs CPU max |dt|="
            f"{float(np.abs(card_run['est_t'] - cpu_run['est_t']).max()):.3g} m; steady "
            f"{card_run['scans_per_s']:.2f} scans/s over scans {N_WARM}..{len(items) - 2}, "
            f"on {card}")
        if octant and min(card_run["per_scan"]) < 2 or not octant and card_run["launches"]:
            raise AssertionError(f"presets {name}: octant launches {card_run['per_scan']}")
        if not ate < 3 * ate_cpu:
            raise AssertionError(f"presets {name}: ATE {ate:.4f} m above 3x the CPU's")
        out[name] = {"launches": card_run["launches"], "scans_per_s": card_run["scans_per_s"],
                     "ate_m": ate, "cpu_ate_m": ate_cpu, "calls": calls}
    return out


def runner(argv: list, label: str) -> dict:
    """tools/run_slam.run(argv) in this process, its stdout captured: the
    run's record (exit code, trajectory, summary, loader figures), the
    octant launches of the run (the count set to 0 just before it) and the
    host seconds; the summary lines are logged."""
    buf = io.StringIO()
    octant_knn.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = runner_cli.run(argv)
    out.update(launches=octant_knn.launches, seconds=time.perf_counter() - t0)
    keep = [line for line in buf.getvalue().splitlines() if line.startswith(
        ("processed", "ATE", "GATE", "gps", "loader", "loops", "relocalizing"))]
    log(f"{label}: exit {out['rc']}, octant launches {out['launches']}, {out['seconds']:.1f} s; "
        + " | ".join(keep))
    return out


def runner_pair(card_run: dict, cpu_run: dict, label: str) -> float:
    """The card's poses against the CPU's (max |dt|, m); raises above
    POSE_T_TOL."""
    worst = float(np.abs(card_run["est"] - cpu_run["est"]).max())
    log(f"{label}: card vs CPU poses max |dt|={worst:.3g} m over {len(card_run['est'])} scans")
    if worst > POSE_T_TOL:
        raise AssertionError(f"{label}: card and CPU poses disagree by {worst:.3g} m")
    return worst


# run_slam's sim arc (REF_STEP, REF_YAW a sweep, the step and yaw of
# tools/run_slam.py's arena arc) in its default world, reached from rest over
# RUNNER_RAMP sweeps: from rest at the full step preset_aloam_kitti64() flags
# every scan degenerate and stays at the origin, in the port and in the JAX
# package alike; over a 4-sweep ramp it tracks (measured: per-frame errors
# at most 0.043 m on the card and the CPU, NVIDIA H100 80GB HBM3, 700.00 W)
RUNNER_RAMP = 4


def runner_arc(device):
    """12 sweeps (64x1800, HDL-64's field of view, noise 0.005 m) of
    run_slam's arc in default_world(seed=0), its step and yaw reached over
    the first RUNNER_RAMP sweeps: the sweeps, their start poses and the
    start positions as numpy."""
    world = default_world(seed=0, device=device)
    q, t = so3.quat_identity(device=device), torch.zeros(3, device=device)
    scans, poses = [], []
    for i in range(N_SCANS):
        f = min(i + 1, RUNNER_RAMP) / RUNNER_RAMP
        poses.append(se3.Pose(q, t))
        q = so3.quat_normalize(so3.quat_mul(q, so3.quat_exp(
            torch.tensor([0.0, 0.0, REF_YAW * f], device=device))))
        t = t + so3.quat_rotate(q, torch.tensor([REF_STEP * f, 0.0, 0.0], device=device))
        scans.append(simulate_scan(world, poses[-1], se3.Pose(q, t), rings=RINGS, width=WIDTH,
                                   fov_up_deg=2.0, fov_down_deg=-24.8, noise_std=0.005, seed=i))
    return scans, poses, np.stack([p.t.cpu().numpy() for p in poses])


def phase_runner_kitti(device, card: str) -> dict:
    """The runner's --kitti path at full width: 12 sweeps of run_slam's own
    sim arc (0.35 m and 0.03 rad a sweep, reached from rest over 4 sweeps,
    in its default world default_world(seed=0); runner_arc) at 64x1800 with
    HDL-64's field of view, written as
    a KITTI sequence (velodyne/*.bin, calib.txt, times.txt, poses/07.txt),
    read by the port's C++ loader (its g++ build timed here) and run with
    --preset aloam: first with --device cpu, whose ATE sets the gate (3x)
    and whose per-frame errors must stay under 0.35 m (the preset tracks),
    then on the card with the gate, the trajectory,
    metrics, summary and map bundle. Checks: exit 0, the octant kernel 4
    times a scan, the card's poses within 1e-3 m of the CPU's, exit 2 on an
    impossible envelope. Prints scans/s through the runner (loader
    included) beside the engine fed the loader's grids from memory, the
    loader's wait, and host syncs a scan through the runner beside the
    engine's own."""
    from agi_lidar_slam_torch.io import kitti, native_loader
    from agi_lidar_slam_torch.sim.recordings import write_kitti_sequence

    before = set(_build.BUILD_DIR.glob("liblidar_io-*.so"))
    t0 = time.perf_counter()
    native_loader.build_native()
    build_s = time.perf_counter() - t0
    built = not before
    scans, poses, gt_t = runner_arc(device)
    with tempfile.TemporaryDirectory() as root:
        seq = write_kitti_sequence(root, scans, poses)
        out = {k: os.path.join(root, k) for k in ("traj.txt", "m.jsonl", "s.json", "maps")}
        base = ["--kitti", seq, "--preset", "aloam", "--width", str(WIDTH)]
        cpu = runner(base + ["--device", "cpu"], "runner-kitti-cpu")
        cpu_err = np.linalg.norm(cpu["est"] - gt_t, axis=1)
        if cpu["rc"] != 0 or not cpu_err.max() < REF_FRAME_BOUND:
            raise AssertionError(f"runner-kitti-cpu: exit {cpu['rc']}, per-frame errors "
                                 f"{cpu_err.round(4).tolist()} (bound {REF_FRAME_BOUND} m)")
        gate = (f"ate_m={3 * cpu['summary']['ate_m']:.6g},"
                f"ate_raw_m={3 * cpu['summary']['ate_raw_m']:.6g}")
        run = runner(base + ["--device", "cuda", "--traj-out", out["traj.txt"], "--metrics",
                             out["m.jsonl"], "--summary-out", out["s.json"], "--save-map",
                             out["maps"], "--gate", gate], "runner-kitti")
        if run["rc"] != 0:
            raise AssertionError(f"runner-kitti: exit {run['rc']} with --gate {gate}")
        if run["launches"] != 4 * N_SCANS:
            raise AssertionError(f"runner-kitti: {run['launches']} octant launches, expected "
                                 f"{4 * N_SCANS}")
        worst = runner_pair(run, cpu, "runner-kitti")
        recs = [json.loads(line) for line in open(out["m.jsonl"])]
        traj = np.loadtxt(out["traj.txt"]).reshape(-1, 3, 4)
        summary = json.load(open(out["s.json"]))
        n_map = len(open(os.path.join(out["maps"], "GlobalMap.pcd")).readlines()) - 11
        if len(recs) != N_SCANS or len(traj) != N_SCANS or summary["n_scans"] != N_SCANS:
            raise AssertionError("runner-kitti: the metrics, trajectory or summary lack scans")
        fail = runner(base + ["--device", "cuda", "--max-scans", "3", "--gate", "ate_m=1e-9"],
                      "runner-kitti-gate")
        if fail["rc"] != 2:
            raise AssertionError(f"runner-kitti: exit {fail['rc']} on an impossible envelope")
        # the same engine fed the loader's grids from memory, host clock
        paths = kitti.scan_paths(seq)
        with native_loader.NativeKittiLoader(paths, rings=64, width=WIDTH,
                                             device=device) as loader:
            grids = list(loader)
        cfg = preset_aloam_kitti64()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = init_state(cfg, device)
        for g in grids:
            state, res = process_scan(state, g, cfg)
            res.pose.t.tolist()
        mem_scans_per_s = len(grids) / (time.perf_counter() - t0)
        # host syncs: the whole runner under sync debug mode, then the engine
        syncs, sites = [], collections.Counter()
        with counted_syncs(syncs, sites):
            with contextlib.redirect_stdout(io.StringIO()):
                runner_cli.run(base + ["--device", "cuda"])
        eng_syncs, eng_sites = [], collections.Counter()
        state = init_state(cfg, device)
        for g in grids:
            with counted_syncs(eng_syncs, eng_sites):
                state, _ = process_scan(state, g, cfg)
    runner_syncs = syncs[0] / N_SCANS
    extra = {k: v for k, v in sites.items() if k not in eng_sites}
    log(f"runner-kitti: loader built {'here' if built else '(already built)'} in {build_s:.2f} s "
        f"(g++); {n_map} map points written; ATE {run['summary']['ate_m']:.4f} m aligned, "
        f"{run['summary']['ate_raw_m']:.4f} m raw (CPU {cpu['summary']['ate_m']:.4f}, "
        f"{cpu['summary']['ate_raw_m']:.4f}; gate {gate})")
    log(f"runner-kitti: {run['summary']['scans_per_s']:.2f} scans/s through the runner (loader, "
        f"grids, engine, one host read a scan; host clock over {N_SCANS} scans) against "
        f"{mem_scans_per_s:.2f} scans/s of process_scan on the loader's grids from memory; the "
        f"loader's consumer waited {run['loader_wait_s']:.3f} s of {run['wall_s']:.2f} s; on "
        f"{card}")
    log(f"runner-kitti: host syncs a scan through the runner {runner_syncs:.2f} ({syncs[0]} over "
        f"{N_SCANS} scans and the set-up) against the engine's own {eng_syncs}; sites outside "
        f"the engine's: {extra}")
    return {"launches": run["launches"], "scans_per_s": run["summary"]["scans_per_s"],
            "mem_scans_per_s": mem_scans_per_s, "loader_wait_s": run["loader_wait_s"],
            "wall_s": run["wall_s"], "loader_build_s": build_s, "loader_built": built,
            "syncs_per_scan": runner_syncs, "engine_syncs": eng_syncs, "worst_t": worst,
            "ate_m": run["summary"]["ate_m"], "cpu_ate_m": cpu["summary"]["ate_m"]}


# the runner's bag: the LIO circle started from rest, as a recording for
# LIO-SAM and LIO starts (both engines begin at rest, as the reference's
# do): still for BAG_STILL s, then the yaw rate ramps to LIO_OMEGA over
# BAG_RAMP s; NavSatFix at 1 Hz over the 1.2 s of sweeps; the
# relocalization seed's offset from the first sweep's pose in the saved map
BAG_STILL, BAG_RAMP = 0.1, 0.4
BAG_FIX_TIMES = (0.0, 1.0)
RELOC_SEED = "0.2,-0.1,0,2"
RELOC_BOUND = 0.05  # m: the relocalized first pose against the mapping run's


def bag_circle(t):
    """The yaw angle, rate and acceleration (numpy, t in s) of the LIO circle
    started from rest: 0 until BAG_STILL, a constant angular acceleration
    for BAG_RAMP s, then LIO_OMEGA."""
    t = np.asarray(t, np.float64)
    alpha = LIO_OMEGA / BAG_RAMP
    u = np.clip(t - BAG_STILL, 0.0, BAG_RAMP)
    th = 0.5 * alpha * u**2 + LIO_OMEGA * np.maximum(t - BAG_STILL - BAG_RAMP, 0.0)
    ramp = (t > BAG_STILL) & (t <= BAG_STILL + BAG_RAMP)
    return th, alpha * u, np.where(ramp, alpha, 0.0)


def bag_pose(t: float, device) -> se3.Pose:
    th = float(bag_circle(t)[0])
    q = so3.quat_exp(torch.tensor([0.0, 0.0, th], device=device))
    return se3.Pose(q, torch.tensor([LIO_RADIUS * np.sin(th), LIO_RADIUS * (1 - np.cos(th)), 0.0],
                                    dtype=torch.float32, device=device))


def bag_sweep_ends(device) -> list:
    return [bag_pose((i + 1) * LIO_SCAN_DT, device).t for i in range(N_SCANS)]


def bag_sweeps(device):
    """12 sweeps (64x1800, world seed 3, 48 pillars, extent 35 m) along
    bag_circle, each with its exact 200 Hz IMU (body rate theta', specific
    force (R theta'', R theta'^2, G) in the body frame of a CCW circle of
    radius LIO_RADIUS), and the GPS fixes at BAG_FIX_TIMES."""
    world = default_world(seed=3, n_pillars=48, extent=35.0, device=device)

    def pose(t):
        return bag_pose(t, device)

    scans, imu = [], []
    for i in range(N_SCANS):
        t0, t1 = i * LIO_SCAN_DT, (i + 1) * LIO_SCAN_DT
        scans.append(simulate_scan(world, pose(t0), pose(t1), rings=RINGS, width=WIDTH,
                                   fov_up_deg=2.0, fov_down_deg=-24.8, max_range=80.0,
                                   noise_std=0.01, seed=i))
        ts = t0 + (np.arange(LIO_IMU) + 0.5) * (LIO_SCAN_DT / LIO_IMU)
        _, w, dw = bag_circle(ts)
        z = np.zeros_like(ts)
        imu.append((np.stack([z, z, w], 1).astype(np.float32),
                    np.stack([LIO_RADIUS * dw, LIO_RADIUS * w**2, z + 9.81], 1).astype(np.float32)))
    return scans, imu, [(t, pose(t).t) for t in BAG_FIX_TIMES]


def phase_runner_bag(device, card: str) -> dict:
    """The runner's --bag path at full width: 12 sweeps of the LIO circle
    started from rest (bag_sweeps: 64x1800, world seed 3; still for a
    sweep, then the yaw rate ramps up over 4) written with the port's
    bag_write as PointCloud2
    (ring and time fields), 200 Hz Imu and 1 Hz NavSatFix. Runs, each on the
    card and then with --device cpu: --engine liosam with --gps-topic and
    --navsat (the fixes through the navsat ESKF and the covariance gate);
    --engine lio --save-map; --engine lio --load-map from that map with a
    seed 0.22 m and 2 deg off. Checks: exit 0, the octant kernel 4 times a
    scan under LIO-SAM, GPS factors used, the relocalized first pose within
    0.05 m of the mapping run's first pose, card and CPU within 1e-3 m."""
    from agi_lidar_slam_torch.sim.recordings import write_sweep_bag

    scans, imu, fixes = bag_sweeps(device)
    out = {}
    with tempfile.TemporaryDirectory() as root:
        bag = os.path.join(root, "circle.bag")
        t0 = time.perf_counter()
        write_sweep_bag(bag, scans, imu, fixes=fixes)
        log(f"runner-bag: {N_SCANS} sweeps {RINGS}x{WIDTH}, {N_SCANS * LIO_IMU} IMU samples, "
            f"{len(fixes)} fixes: {os.path.getsize(bag) / 2**20:.1f} MiB written in "
            f"{time.perf_counter() - t0:.1f} s")
        base = ["--bag", bag, "--rings", str(RINGS), "--width", str(WIDTH)]
        runs = {
            "liosam": ["--engine", "liosam", "--gps-topic", "/gps/fix", "--navsat"],
            "lio-map": ["--engine", "lio", "--save-map", os.path.join(root, "{dev}")],
            "lio-reloc": ["--engine", "lio", "--load-map", os.path.join(root, "{dev}"),
                          "--init-pose", RELOC_SEED],
        }
        for name, extra in runs.items():
            pair = {}
            for dev in ("cuda", "cpu"):
                argv = base + [a.replace("{dev}", dev) for a in extra] + ["--device", dev]
                pair[dev] = runner(argv, f"runner-bag {name}" + ("" if dev == "cuda" else "-cpu"))
                if pair[dev]["rc"] != 0:
                    raise AssertionError(f"runner-bag {name} ({dev}): exit {pair[dev]['rc']}")
            pair["worst_t"] = runner_pair(pair["cuda"], pair["cpu"], f"runner-bag {name}")
            out[name] = pair
    ls = out["liosam"]["cuda"]
    if ls["launches"] != 4 * N_SCANS:
        raise AssertionError(f"runner-bag liosam: {ls['launches']} octant launches, expected "
                             f"{4 * N_SCANS}")
    if not ls["n_gps_used"] > 0 or out["liosam"]["cpu"]["n_gps_used"] != ls["n_gps_used"]:
        raise AssertionError(f"runner-bag liosam: GPS factors used {ls['n_gps_used']} (card), "
                             f"{out['liosam']['cpu']['n_gps_used']} (CPU)")
    for dev in ("cuda", "cpu"):
        d = float(np.linalg.norm(out["lio-reloc"][dev]["est"][0] - out["lio-map"][dev]["est"][0]))
        log(f"runner-bag ({dev}): relocalized first pose {out['lio-reloc'][dev]['est'][0].round(4)}"
            f", {d:.4f} m from the mapping run's first pose (seed {RELOC_SEED}; bound "
            f"{RELOC_BOUND} m)")
        if not d < RELOC_BOUND:
            raise AssertionError(f"runner-bag: the relocalized run ({dev}) did not start in the "
                                 f"saved map ({d:.4f} m)")
    gt_end = np.stack([p.cpu().numpy() for p in bag_sweep_ends(device)])
    log("runner-bag: max position error against the circle at each sweep's end: " + ", ".join(
        f"{k} {float(np.linalg.norm(v['cuda']['est'] - gt_end, axis=1).max()):.4f} m"
        for k, v in out.items()))
    log("runner-bag: scans/s through the runner (bag decode, grids, engine; host clock): "
        + ", ".join(f"{k} {v['cuda']['summary']['scans_per_s']:.2f}" for k, v in out.items())
        + f"; on {card}")
    return {"launches": sum(v["cuda"]["launches"] for v in out.values()),
            "n_gps_used": ls["n_gps_used"],
            **{f"{k}_scans_per_s": v["cuda"]["summary"]["scans_per_s"] for k, v in out.items()},
            **{f"{k}_worst_t": v["worst_t"] for k, v in out.items()}}


def phase_runner_sim(device, card: str) -> dict:
    """The runner's --sim path at full width (64x1800, 12 frames): the city
    world with 4 movers through --engine slam, and the corridor through
    --engine lio on its exact analytic IMU; each on the card and with
    --device cpu (the simulator draws its noise on each device, so the
    sweeps differ by noise). Checks: exit 0, the octant kernel 4 times a
    scan under slam and at least once a scan under lio, the card's ATE
    (aligned and raw) under 3x the CPU run's."""
    common = ["--sim", "--sim-rings", str(RINGS), "--sim-width", str(WIDTH),
              "--frames", str(N_SCANS)]
    runs = {"city-slam": ["--world", "city", "--movers", "4", "--engine", "slam"],
            "corridor-lio": ["--world", "corridor", "--engine", "lio"]}
    out = {}
    for name, extra in runs.items():
        card_run = runner(common + extra + ["--device", "cuda"], f"runner-sim {name}")
        cpu_run = runner(common + extra + ["--device", "cpu"], f"runner-sim {name}-cpu")
        if card_run["rc"] or cpu_run["rc"]:
            raise AssertionError(f"runner-sim {name}: exit {card_run['rc']}, {cpu_run['rc']}")
        per_scan = card_run["launches"] / N_SCANS
        if (name == "city-slam" and card_run["launches"] != 4 * N_SCANS
                or per_scan < 1):
            raise AssertionError(f"runner-sim {name}: {card_run['launches']} octant launches")
        for key in ("ate_m", "ate_raw_m"):
            a, b = card_run["summary"][key], cpu_run["summary"][key]
            if not a < 3 * b:
                raise AssertionError(f"runner-sim {name}: {key} {a:.4f} m above 3x the CPU's "
                                     f"{b:.4f} m")
        log(f"runner-sim {name}: ATE {card_run['summary']['ate_m']:.4f} m aligned, "
            f"{card_run['summary']['ate_raw_m']:.4f} m raw (CPU {cpu_run['summary']['ate_m']:.4f},"
            f" {cpu_run['summary']['ate_raw_m']:.4f}); {card_run['summary']['scans_per_s']:.2f} "
            f"scans/s through the runner (simulated sweeps in memory; host clock, the stage "
            f"synchronized), on {card}")
        out[name] = {"launches": card_run["launches"], "ate_m": card_run["summary"]["ate_m"],
                     "cpu_ate_m": cpu_run["summary"]["ate_m"],
                     "scans_per_s": card_run["summary"]["scans_per_s"]}
    return {"launches": sum(v["launches"] for v in out.values()), **out}


# the multi-device phases: scans of each path on the two ranks; the full
# keyframe bank's graph; one rank over nccl against the single process (one
# rank sums what one process sums), two gloo ranks at the JAX package's own
# tolerances (tests/test_sharding_parity.py:79,109-111,163-165;
# tests/test_pose_graph.py:107-110)
PAR2_SCANS = 8
GRAPH_K, GRAPH_E = 1024, 2048
PAR1_TOL = 1e-6
PAR2_ODOM_TOL, PAR2_IMU_TOL, PAR2_GRAPH_TOL = 1e-4, 5e-3, 1e-4
PAR2_DEADLINE_S = 400.0
# the maps whose occupancy the JAX package's own parity tests hold equal
PAR2_OCC = {"odom-dp": ("surf_map",), "odom-mp": ("corner_map", "surf_map"), "lio": ("map",),
            "livox": ("surf_map",), "liosam": ("surf_map",)}


def graph_problem(device):
    """A full bank's pose graph (GRAPH_K keyframes, GRAPH_E edges) made from
    SEED: a 3-turn spiral of radius 20 m, the odometry chain and loop edges
    between keyframes at least 20 apart, exact measurements of weight 100,
    and initial poses that drift from the truth in yaw and position."""
    rng = np.random.default_rng(SEED)
    K, E = GRAPH_K, GRAPH_E
    th = np.linspace(0.0, 6 * np.pi, K)

    def yaw_quat(yaw):
        z = np.zeros_like(yaw)
        return np.stack([np.cos(yaw / 2), z, z, np.sin(yaw / 2)], -1).astype(np.float32)

    t = np.stack([20 * np.cos(th), 20 * np.sin(th), 0.01 * np.arange(K)], -1).astype(np.float32)
    n_loop = E - (K - 1)
    a = rng.integers(0, K - 21, n_loop)
    b = a + 20 + (rng.random(n_loop) * (K - 1 - (a + 20))).astype(np.int64)
    i = np.concatenate([np.arange(K - 1), a]).astype(np.int32)
    j = np.concatenate([np.arange(1, K), b]).astype(np.int32)
    gt = se3.Pose(torch.from_numpy(yaw_quat(th + np.pi / 2)).to(device),
                  torch.from_numpy(t).to(device))
    il, jl = torch.from_numpy(i).to(device).long(), torch.from_numpy(j).to(device).long()
    z = se3.compose(se3.inverse(se3.Pose(gt.q[il], gt.t[il])), se3.Pose(gt.q[jl], gt.t[jl]))
    w = torch.full((E,), 100.0, device=device)
    edges = pose_graph.EdgeSet(
        i=il.to(torch.int32), j=jl.to(torch.int32), z_q=z.q, z_t=z.t, w_rot=w, w_trans=w.clone(),
        kind=torch.zeros(E, dtype=torch.int32, device=device),
        valid=torch.ones(E, dtype=torch.bool, device=device),
        count=torch.full((), E, dtype=torch.int32, device=device))
    yaw0 = th + np.pi / 2 + np.cumsum(rng.normal(0.0, 1e-3, K))
    t0 = t + np.cumsum(rng.normal(0.0, 0.01, (K, 3)), axis=0).astype(np.float32)
    poses = se3.Pose(torch.from_numpy(yaw_quat(yaw0)).to(device),
                     torch.from_numpy(t0.astype(np.float32)).to(device))
    return poses, torch.full((), K, dtype=torch.int32, device=device), edges


@contextlib.contextmanager
def knn_queries(record: list):
    """While open, append the query count of every octant_knn.knn_octant call."""
    real = octant_knn.knn_octant

    def wrapper(m, queries, qmask, k, cfg, ktab=None):
        record.append(int(queries.shape[0]))
        return real(m, queries, qmask, k, cfg, ktab=ktab)

    octant_knn.knn_octant = wrapper
    try:
        yield record
    finally:
        octant_knn.knn_octant = real


def run_path(step, state, items) -> dict:
    """step(state, item) over `items`, the card synchronized after each: the
    final state and the one after PAR2_SCANS items, the results, scans/s over
    the items after the first N_WARM (CUDA events), and per item the octant
    launches, their query counts and the collectives. The launch count
    starts this path at 0."""
    torch.cuda.synchronize()
    marks = [torch.cuda.Event(enable_timing=True)]
    results, launches, queries, colls = [], [], [], []
    kept = None
    octant_knn.launches = 0
    marks[0].record()
    for i, it in enumerate(items):
        l0, c0, q = octant_knn.launches, pdist.collectives, []
        with knn_queries(q):
            state, res = step(state, it)
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()
        torch.cuda.synchronize()
        results.append(res)
        launches.append(octant_knn.launches - l0)
        queries.append(q)
        colls.append(pdist.collectives - c0)
        if i == PAR2_SCANS - 1:
            kept = state
    steady = (len(items) - N_WARM) * 1e3 / marks[N_WARM].elapsed_time(marks[-1])
    return {"state": state, "kept": kept, "results": results, "scans_per_s": steady,
            "per_scan": launches, "launches": octant_knn.launches, "queries": queries,
            "collectives": colls}


def _pose_t(res) -> np.ndarray:
    return (res.x.p if hasattr(res, "x") else res.pose.t).cpu().numpy()


def _pose_q(res) -> np.ndarray:
    return (res.x.q if hasattr(res, "x") else res.pose.q).cpu().numpy()


def pose_gap(a: list, b: list) -> tuple[float, float]:
    """max |dt| (m) and max |dq| between two runs' per-scan results."""
    return (max(float(np.abs(_pose_t(x) - _pose_t(y)).max()) for x, y in zip(a, b)),
            max(float(np.abs(_pose_q(x) - _pose_q(y)).max()) for x, y in zip(a, b)))


def occupancy(state) -> dict:
    """Points held by each map of an engine state."""
    state = getattr(state, "engine", state)
    return {f: int(getattr(state, f).num_points())
            for f in ("map", "corner_map", "surf_map", "other_map") if hasattr(state, f)}


def gathered(run: dict, mesh) -> None:
    """A slot-sharded path's kept and final states with their maps whole."""
    for key in ("state", "kept"):
        st = run[key]
        run[key] = st._replace(corner_map=map_shard.gather_map_arrays(st.corner_map, mesh),
                               surf_map=map_shard.gather_map_arrays(st.surf_map, mesh))


def engaged_livox(sweeps: list, device):
    """The livox driver through its LO sweeps and engagement (the first
    LIVOX_INIT_FRAMES sweeps): its config and window state."""
    drv = livox_driver(device)
    for s, win in sweeps[:LIVOX_INIT_FRAMES]:
        drv.process(s, win)
    if not drv.engaged:
        raise AssertionError("livox: not engaged after its LO sweeps")
    return drv.cfg, drv.state


def liosam_start(cfg, device):
    return liosam_pipeline.init_liosam_state(
        cfg, x0=circle_pose(0.0, LIO_RADIUS, LIO_OMEGA, device=device),
        v0=circle_velocity(0.0, LIO_RADIUS, LIO_OMEGA, device=device), device=device)


def sharded_paths(dp, mp, device, scans: list, lio_items: list, sweeps: list,
                  liosam_sweeps: list) -> dict:
    """Every sharded engine step over its inputs: the dp and mp odometry
    steps (the odom cell; `mp`'s maps slot-sharded, counted whole at the
    end), LIO, the livox window sweeps after the engagement on `sweeps`'
    first LIVOX_INIT_FRAMES, LIO-SAM; the point axes split over `dp`'s
    ranks, the map slots over `mp`'s."""
    cfg = preset_aloam_kitti64()
    runs = {"odom-dp": run_path(lambda s, x: sharding.sharded_scan_step(dp, s, x, cfg),
                                moving_start(cfg, device), scans)}
    st = moving_start(cfg, device)
    st = st._replace(corner_map=map_shard.shard_map_arrays(st.corner_map, mp),
                     surf_map=map_shard.shard_map_arrays(st.surf_map, mp))
    runs["odom-mp"] = run_path(lambda s, x: sharding.sharded_scan_step_mp(mp, s, x, cfg), st,
                               scans)
    gathered(runs["odom-mp"], mp)
    lcfg = lio.LioConfig()
    runs["lio"] = run_path(lambda s, it: sharding.sharded_lio_step(dp, s, *it, lcfg),
                           lio_start(lcfg, device), lio_items)
    xcfg, xst = engaged_livox(sweeps, device)
    runs["livox"] = run_path(lambda s, it: sharding.sharded_livox_step(dp, s, *it, xcfg), xst,
                             sweeps[LIVOX_INIT_FRAMES:])
    scfg = liosam_config()
    runs["liosam"] = run_path(lambda s, it: sharding.sharded_liosam_step(dp, s, *it, scfg),
                              liosam_start(scfg, device), liosam_sweeps)
    return runs


def single_paths(device, scans: list, lio_items: list, sweeps: list,
                 liosam_sweeps: list) -> dict:
    """The single-process steps over the inputs of sharded_paths."""
    cfg = preset_aloam_kitti64()
    odom = run_path(lambda s, x: process_scan(s, x, cfg), moving_start(cfg, device), scans)
    lcfg = lio.LioConfig()
    xcfg, xst = engaged_livox(sweeps, device)
    scfg = liosam_config()
    return {"odom-dp": odom, "odom-mp": odom,
            "lio": run_path(lambda s, it: lio.process_lio_scan(s, *it, lcfg),
                            lio_start(lcfg, device), lio_items),
            "livox": run_path(lambda s, it: livox_pipeline.process_livox_scan(s, *it, xcfg),
                              xst, sweeps[LIVOX_INIT_FRAMES:]),
            "liosam": run_path(lambda s, it: liosam_pipeline.process_liosam_scan(s, *it, scfg),
                               liosam_start(scfg, device), liosam_sweeps)}


def merged_bank(results: list, device):
    """A keyframe bank holding each odom result's pose and features."""
    cfg = preset_aloam_kitti64()
    bank = empty_bank(16, cfg.features.max_corners, cfg.features.max_surfs, device)
    yes = torch.ones((), dtype=torch.bool, device=device)
    for i, r in enumerate(results):
        bank, _ = add_keyframe(bank, r.pose, r.corners, r.surfs,
                               torch.full((), i, dtype=torch.int32, device=device), yes)
    return bank


def phase_parallel(device, main: dict, lio_run: dict, livox_run: dict, card: str,
                   backend: str = "nccl") -> dict:
    """The multi-device layer on one rank in this process, over `backend`
    (nccl on the card) with a HashStore: every sharded step at full width on
    the cells' own inputs (12 odom scans through the dp and the mp step, 12
    LIO scans, the livox window sweeps after its engagement, 12 LIO-SAM
    scans), the edge-sharded pose graph on a full 1024-keyframe bank with
    2048 edges, and the slot-sharded merged map, each against the same
    single-process step on the same card: poses within PAR1_TOL, equal
    occupancy; scans/s beside the single process's, launches and collectives
    a scan."""
    if is_card(device):
        torch.cuda.set_device(device)
    dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = pdist.make_mesh_2d(dp=1, mp=1, device=device)
        sweeps = livox_run["sweeps"]
        args = (device, main["scans"], lio_run["items"], sweeps, sweeps)
        single = single_paths(*args)
        sharded = sharded_paths(mesh, mesh, *args)
        out = {"paths": {}}
        for name, run in sharded.items():
            ref = single[name]
            dt, dq = pose_gap(run["results"], ref["results"])
            occ, ref_occ = occupancy(run["state"]), occupancy(ref["state"])
            out["paths"][name] = {
                "scans_per_s": run["scans_per_s"], "single_scans_per_s": ref["scans_per_s"],
                "per_scan": run["per_scan"], "launches": run["launches"],
                "collectives_per_scan": run["collectives"], "max_dt_m": dt, "max_dq": dq,
                "occupancy": occ}
            log(f"parallel {name}: {len(run['results'])} scans on 1 {backend} rank: "
                f"{run['scans_per_s']:.2f} scans/s (single process {ref['scans_per_s']:.2f}); "
                f"collectives a scan {run['collectives']}; octant launches a scan "
                f"{run['per_scan']} (single process {ref['per_scan']}); max |dt| {dt:.3g} m, "
                f"|dq| {dq:.3g}; occupancy {occ}")
            if dt > PAR1_TOL or dq > PAR1_TOL:
                raise AssertionError(f"parallel {name}: one rank differs from the single "
                                     f"process by {dt:.3g} m / {dq:.3g}")
            if occ != ref_occ:
                raise AssertionError(f"parallel {name}: occupancy {occ} != {ref_occ}")
            if not all(n > 0 for n in run["collectives"]):
                raise AssertionError(f"parallel {name}: a scan issued no collective")
            if name != "odom-mp" and run["per_scan"] != ref["per_scan"]:
                raise AssertionError(f"parallel {name}: octant launches differ from the "
                                     "single process's")
        # the pose graph: one rank's sums are the single process's, compared
        # with index_add_ in its deterministic form; timed as it runs
        poses, n_nodes, edges = graph_problem(device)
        with deterministic():
            ref_g = pose_graph.solve_pose_graph(poses, n_nodes, edges)
            got_g = pose_graph.sharded_solve_pose_graph(mesh, poses, n_nodes, edges)
        dt = float((ref_g.t - got_g.t).abs().max())
        moved = float((ref_g.t - poses.t).abs().max())
        c0 = pdist.collectives
        pose_graph.sharded_solve_pose_graph(mesh, poses, n_nodes, edges)
        g_coll = pdist.collectives - c0
        g_ms = cuda_ms(lambda: pose_graph.sharded_solve_pose_graph(mesh, poses, n_nodes, edges), 5)
        g_ref_ms = cuda_ms(lambda: pose_graph.solve_pose_graph(poses, n_nodes, edges), 5)
        log(f"parallel pose graph: {GRAPH_K} keyframes, {GRAPH_E} edges on 1 {backend} rank: "
            f"{g_ms:.2f} ms a solve (single process {g_ref_ms:.2f}), {g_coll} collectives; "
            f"max |dt| {dt:.3g} m against the single process; the solve moved poses by up to "
            f"{moved:.3g} m")
        if not (dt <= PAR1_TOL and moved > 0.01):
            raise AssertionError(f"parallel pose graph: {dt:.3g} m from the single process")
        out["graph"] = {"ms": g_ms, "single_ms": g_ref_ms, "collectives": g_coll,
                        "max_dt_m": dt, "t": ref_g.t.cpu().numpy()}
        bank = merged_bank(single["odom-dp"]["results"], device)
        mcfg = preset_aloam_kitti64().surf_map
        ref_m = multisession.build_merged_map(bank, mcfg)
        got_m = map_shard.gather_map_arrays(multisession.build_merged_map(bank, mcfg, mesh=mesh),
                                           mesh)
        if not all(torch.equal(a, b) for a, b in zip(ref_m, got_m)):
            raise AssertionError("parallel: the slot-sharded merged map differs")
        log(f"parallel merged map: {int(bank.count)} keyframes, {int(ref_m.num_points())} "
            f"points, the slot-sharded build equal to the single process's; on {card}")
        out["single"] = {name: {"t": [_pose_t(r) for r in run["results"]],
                                "scans_per_s": run["scans_per_s"],
                                "occupancy": occupancy(run["kept"])}
                         for name, run in single.items()}
        return out
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def deterministic():
    """torch's deterministic algorithms while open (warn only where an op
    has none)."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def _par2_rank(rank: int, device_type: str) -> dict:
    """One of the parallel-2 phase's two ranks: the inputs made here from
    SEED as the single-process phases made theirs (with a checksum of each),
    every sharded step over PAR2_SCANS of them, the pose graph, and the
    merged KNN against knn on the whole map."""
    device = pdist.local_device(rank) if device_type == "cuda" else torch.device("cpu")
    dp = pdist.make_mesh_2d(dp=2, mp=1, device=device_type)
    mp = pdist.make_mesh_2d(dp=1, mp=2, device=device_type)
    scans = make_scans(device)[0][:PAR2_SCANS]
    lio_items = make_lio_inputs(PAR2_SCANS, device)[0]
    sweeps = lio_sweeps(LIVOX_INIT_FRAMES + PAR2_SCANS, device)[0]
    out = {"checksum": input_checksum(scans, sweeps)}
    runs = sharded_paths(dp, mp, device, scans, lio_items, sweeps, sweeps[:PAR2_SCANS])
    out["paths"] = {name: {"t": [_pose_t(r) for r in run["results"]],
                           "scans_per_s": run["scans_per_s"], "per_scan": run["per_scan"],
                           "queries": run["queries"][-1], "collectives": run["collectives"],
                           "occupancy": occupancy(run["kept"])} for name, run in runs.items()}
    poses, n_nodes, edges = graph_problem(device)
    out["graph_t"] = pose_graph.sharded_solve_pose_graph(dp, poses, n_nodes, edges).t.cpu().numpy()
    out["graph_ms"] = cuda_ms(
        lambda: pose_graph.sharded_solve_pose_graph(dp, poses, n_nodes, edges), 3)
    rng = np.random.default_rng(SEED)
    mcfg = preset_aloam_kitti64().surf_map
    m = filled_map(mcfg, 80000, rng, device)
    q = torch.from_numpy(rng.uniform([-20, -20, -1], [20, 20, 4], (8192, 3)).astype(
        np.float32)).to(device)
    qm = torch.ones(8192, dtype=torch.bool, device=device)
    ref = knn(m, q, qm, 5, mcfg)
    got = map_shard.sharded_knn(mp, map_shard.shard_map_arrays(m, mp), q, qm, 5, mcfg)
    v = ref.valid
    out["knn"] = {"valid_equal": bool(torch.equal(got.valid, v)),
                  "sq_err": float((got.sq_dists - ref.sq_dists)[v].abs().max()),
                  "sq_scale": float(ref.sq_dists[v].abs().max()),
                  "pts_err": float((got.points - ref.points)[v].abs().max()),
                  "valid_share": float(v.float().mean())}
    return out


def input_checksum(scans: list, sweeps: list) -> list:
    """Each scan's and sweep's coordinate sum (float64): the ranks' inputs
    against this process's."""
    return [float(s.xyz.double().sum()) for s in scans] + [
        float(s.xyz.double().sum()) for s, _ in sweeps]


def phase_parallel2(device, par: dict, main: dict, lio_run: dict, livox_run: dict) -> dict:
    """Two ranks spawned by parallel/launch.py on the one card, over gloo
    (NCCL refuses two ranks on one device; gloo stages CUDA tensors through
    host memory inside torch). Each rank runs every sharded step for
    PAR2_SCANS scans at 64x1800, the pose graph and the merged KNN; the
    results are held here against the parallel phase's single-process runs
    at the JAX package's tolerances, with equal occupancy. The rates are the
    sharded path's overhead on one card, not scaling. Then the octant
    kernel's device time at a rank's half of the odom and LIO queries, and
    tools/scaling_bench at 1 and 2 ranks."""
    dtype = torch.device(device).type
    ranks = launch(_par2_rank, 2, (dtype,), device=dtype, backend="gloo",
                   deadline_s=PAR2_DEADLINE_S)
    want = input_checksum(main["scans"][:PAR2_SCANS],
                          livox_run["sweeps"][:LIVOX_INIT_FRAMES + PAR2_SCANS])
    out = {"paths": {}, "note": "two ranks share one card over gloo: the rates are the "
                               "sharded path's overhead, not scaling"}
    for r, got in enumerate(ranks):
        if got["checksum"] != want:
            raise AssertionError(f"parallel-2: rank {r} made other inputs than this process")
    for name in ranks[0]["paths"]:
        ref = par["single"][name]
        tol = PAR2_ODOM_TOL if name.startswith("odom") else PAR2_IMU_TOL
        rec = {}
        for r, got in enumerate(ranks):
            p = got["paths"][name]
            err = max(float(np.abs(a - b).max()) for a, b in zip(p["t"], ref["t"]))
            rec[f"rank{r}"] = {k: p[k] for k in ("scans_per_s", "per_scan", "queries",
                                                  "collectives")} | {"max_dt_m": err}
            log(f"parallel-2 {name} rank {r}: {len(p['t'])} scans, {p['scans_per_s']:.2f} "
                f"scans/s (single process {ref['scans_per_s']:.2f}; two gloo ranks on one "
                f"card: overhead, not scaling); octant launches a scan {p['per_scan']}, the "
                f"last scan's at {p['queries']} queries; collectives a scan "
                f"{p['collectives']}; max |dt| {err:.3g} m (tolerance {tol}); occupancy "
                f"{p['occupancy']} (single process {ref['occupancy']})")
            if not err <= tol:
                raise AssertionError(f"parallel-2 {name}: rank {r} {err:.3g} m from the "
                                     "single process")
            if any(p["occupancy"][m] != ref["occupancy"][m] for m in PAR2_OCC[name]):
                raise AssertionError(f"parallel-2 {name}: rank {r} occupancy "
                                     f"{p['occupancy']} != {ref['occupancy']}")
        if not all(np.array_equal(a, b) for a, b in zip(ranks[0]["paths"][name]["t"],
                                                        ranks[1]["paths"][name]["t"])):
            raise AssertionError(f"parallel-2 {name}: the two ranks hold other poses")
        out["paths"][name] = rec
    gerr = max(float(np.abs(got["graph_t"] - par["graph"]["t"]).max()) for got in ranks)
    log(f"parallel-2 pose graph: {GRAPH_K} keyframes, {GRAPH_E} edges split over 2 gloo "
        f"ranks: {ranks[0]['graph_ms']:.2f} ms a solve (1 rank: {par['graph']['ms']:.2f}); max "
        f"|dt| {gerr:.3g} m against the single process (tolerance {PAR2_GRAPH_TOL})")
    if not gerr <= PAR2_GRAPH_TOL:
        raise AssertionError(f"parallel-2 pose graph {gerr:.3g} m from the single process")
    out["graph"] = {"ms": ranks[0]["graph_ms"], "max_dt_m": gerr}
    for r, got in enumerate(ranks):
        k = got["knn"]
        log(f"parallel-2 sharded_knn rank {r} against knn (8192 queries, k=5, the whole "
            f"map): {k}")
        if not (k["valid_equal"] and k["sq_err"] <= 1e-5 * k["sq_scale"] + 1e-6
                and k["pts_err"] == 0.0 and k["valid_share"] > 0.5):
            raise AssertionError(f"parallel-2: sharded_knn differs from knn on rank {r}: {k}")
    out["knn"] = ranks[0]["knn"]
    shard = {}  # the octant kernel at a rank's half of the path's queries
    for path, calls in (("odom", main["calls"]), ("lio", lio_run["calls"])):
        for j, (m, q, qm, k, mcfg, ktab) in enumerate(calls):
            h = q.shape[0] // 2
            label = f"{path}#{j}:{h}x{m.n_rows}xk{k}"
            bound_ms, bound_by = knn_bound(m, q[:h], qm[:h], k, mcfg, ktab)
            shard[label] = {
                "device_ms": device_ms(
                    lambda: octant_knn.knn_octant(m, q[:h], qm[:h], k, mcfg, ktab=ktab)),
                "full_device_ms": device_ms(
                    lambda: octant_knn.knn_octant(m, q, qm, k, mcfg, ktab=ktab)),
                "plain_device_ms": device_ms(
                    lambda: octant_knn.knn_octant_ref(m, q[:h], qm[:h], k, mcfg, ktab=ktab)),
                "bound_ms": bound_ms, "bound_by": bound_by}
            log(f"parallel-2 octant kernel at a rank's half {label}: {shard[label]}")
    out["shard_ms"] = shard
    out["scaling"] = scaling_bench.run(2, device=dtype, reps=8)
    for rec in out["scaling"]:
        log("parallel-2 scaling_bench: " + json.dumps(rec))
    return out


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


def _times(payload: dict):
    """Every (label, ms) of a profiler payload: each stage's median and
    spread, the closure's, and each kernel row's device ms."""
    for eng, st in payload["stages"].items():
        for name, v in st.items():
            yield f"{eng} {name}", v["ms"]
            yield f"{eng} {name} spread", min(v["spread_ms"])
    clo = payload["engine_summary"]["slam"]["closure"]["stages"]
    for name, v in clo.items():
        yield f"slam closure {name}", v["ms"]
    for r in payload["kernel_rooflines"]:
        yield f"{r['kernel']} {r['shape']}", r["ms"]


def phase_profile(card: str) -> dict:
    """The port's stage profiler as a user runs it, `python -m
    agi_lidar_slam_torch.tools.profile_engines --engine all` (in a process of
    its own: late in this one torch.profiler records only part of the
    device's work), with PROFILE_REPS timed calls after PROFILE_SCANS
    warm-up scans, writing chiprun_out/SOL_smoke.json and .md. Each
    engine's staged step must give the engine step's pose within
    CHUNK_POSE_TOL (odom and chunk bit for bit), every time must be finite
    and positive, every share at most profile_engines.SHARE_LIMIT (the
    profiler raises above it) and the payload must hold the JAX tool's
    schema. One line per engine."""
    out = Path("chiprun_out")
    run = subprocess.run([sys.executable, "-m", "agi_lidar_slam_torch.tools.profile_engines",
                          "--engine", "all", "--scans", str(PROFILE_SCANS), "--reps",
                          str(PROFILE_REPS), "--out", str(out), "smoke"],
                         capture_output=True, text=True, timeout=900)
    if run.returncode != 0:
        raise AssertionError(f"profile: the profiler exited {run.returncode}:\n"
                             f"{run.stderr[-4000:]}")
    payload = json.loads((out / "SOL_smoke.json").read_text())
    keys = {"engines_ms_per_scan", "kernel_rooflines", "engine_summary", "hw", "scan_scale",
            "timing"}
    if not keys <= set(payload) or set(payload["stages"]) != set(profile_engines.ENGINES):
        raise AssertionError(f"profile: payload keys {sorted(payload)}, engines "
                             f"{sorted(payload['stages'])}")
    bad = [(k, v) for k, v in _times(payload) if not (v is not None and np.isfinite(v) and v > 0)]
    if bad:
        raise AssertionError(f"profile: times not finite and positive: {bad}")
    for eng, s in payload["engine_summary"].items():
        exact = eng in ("odom", "chunk")
        if (s["composition_gap"] > CHUNK_POSE_TOL or (exact and not s["composition_equal"])
                or s["busy_share"] is None):
            raise AssertionError(f"profile {eng}: staged step against the engine step: gap "
                                 f"{s['composition_gap']}, bit-equal {s['composition_equal']} "
                                 f"(must be{' bit-equal' if exact else ''} within "
                                 f"{CHUNK_POSE_TOL}); busy share {s['busy_share']}")
        st = payload["stages"][eng]
        log(f"profile {eng}: " + ", ".join(
            f"{k} {v['ms']:.3f} ms ({v['launches']} launches, {v['syncs']} syncs)"
            for k, v in st.items()) + f"; stages sum {s['stages_sum_ms']} ms, busy share "
            f"{s['busy_share']:.3f}, of the 10 Hz budget {s['budget_10hz']:.3f}, kernel bounds "
            f"{s.get('bounds_ms')} ms, staged gap {s['composition_gap']}, the busy share's "
            f"profile complete: {s['profile_complete']}; on {card}")
    clo = payload["engine_summary"]["slam"]["closure"]
    log(f"profile slam closure at a full bank ({clo['live']} of {clo['keyframes']} keyframes, "
        f"loop {clo['loop']}, built in {clo['bank_build_s']:.1f} s): " + ", ".join(f"{k} {v['ms']:.2f} ms ({v['launches']} launches, "
                                              f"{v['syncs']} syncs)"
                                              for k, v in clo["stages"].items()))
    log("profile kernels: " + "; ".join(
        f"{r['kernel']} {r['shape']} {r['ms']:.5f} ms, bound {r['bound_ms']:.5f} "
        f"({r['bound_by']}), share {r['share']:.3f}" for r in payload["kernel_rooflines"]))
    log(f"profile: {run.stdout.strip()}; seconds by section: " + ", ".join(
        line.split(": ", 1)[1] for line in run.stderr.splitlines()
        if line.startswith("profile_engines: ")))
    return payload


def kernels_line(kern: dict, prb: dict, main_run: dict, lio_run: dict, slam_run: dict,
                 liosam_run: dict, livox_run: dict, aloam_run: dict, lego_run: dict,
                 preset_runs: dict, runner_runs: dict, par: dict, par2: dict,
                 path: dict, eig: dict, chunk: dict) -> dict:
    """Every number here was measured in this run; shapes are in the keys.
    ms / plain_ms / library_ms are device times per call (torch.profiler)."""
    t = kern["timing"]

    def by_shape(key):
        return {f"{v['queries']}x{v['rows']}xk{v['k']}": v[key] for v in t.values()}

    g = prb["row_gather_sum"]
    s = prb["scale2"]["256x128"]
    gn_timing = {**eig["gn"]["timing"], **lego_run["subset"]["timing"]}
    gn_differ = {**eig["gn"]["differ"], **lego_run["subset"]["differ"]}
    path_keys = ("device_ms", "plain_device_ms", "call_ms", "bound_ms", "l2_ms", "live",
                 "hits", "distinct_rows", "tile_rows", "max_abs_err")
    return {"kernels": [
        {"name": "octant_knn", "route": "cuda", "source": "agi_lidar_slam_torch/csrc/octant_knn.cu",
         "replaces": "agi_lidar_slam_tpu/nn/vmem_knn.py:150",
         "launches": sum(r["launches"] for r in (main_run, lio_run, slam_run, liosam_run,
                                                 livox_run, aloam_run, lego_run,
                                                 *preset_runs.values(), *runner_runs.values(),
                                                 *par["paths"].values())),
         "launches_by_path": {"odom": main_run["launches"], "lio": lio_run["launches"],
                              "slam": slam_run["launches"], "liosam": liosam_run["launches"],
                              "livox": livox_run["launches"], "aloam-ref": aloam_run["launches"],
                              "lego-ref": lego_run["launches"],
                              **{k: v["launches"] for k, v in preset_runs.items()},
                              **{k: v["launches"] for k, v in runner_runs.items()},
                              **{f"parallel {k}": v["launches"] for k, v in par["paths"].items()}},
         "parallel": {k: {f: v[f] for f in ("per_scan", "collectives_per_scan", "scans_per_s",
                                            "single_scans_per_s", "max_dt_m")}
                      for k, v in par["paths"].items()} | {"pose_graph": {
                          f: par["graph"][f] for f in ("ms", "single_ms", "collectives",
                                                       "max_dt_m")}},
         "parallel_2": {"note": par2["note"], "launches_per_scan_by_rank": {
             k: {r: v[r]["per_scan"] for r in ("rank0", "rank1")}
             for k, v in par2["paths"].items()},
             "queries_per_launch_by_rank": {k: {r: v[r]["queries"] for r in ("rank0", "rank1")}
                                            for k, v in par2["paths"].items()},
             "scans_per_s_by_rank": {k: {r: v[r]["scans_per_s"] for r in ("rank0", "rank1")}
                                     for k, v in par2["paths"].items()},
             "shard_device_ms": par2["shard_ms"], "pose_graph": par2["graph"],
             "scaling_bench": par2["scaling"]},
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
         "livox_launches_per_scan": livox_run["per_scan"],
         "aloam_ref_scans_per_s": aloam_run["scans_per_s"], "aloam_ref_ate_m": aloam_run["ate"],
         "aloam_ref_launches_per_scan": aloam_run["per_scan"],
         "lego_ref_scans_per_s": lego_run["scans_per_s"], "lego_ref_ate_m": lego_run["ate"],
         "chunk": chunk,
         "presets": {k: {f: x for f, x in v.items() if f != "calls"}
                     for k, v in preset_runs.items()},
         "runner": runner_runs},
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
        {"name": "sym_eig", "route": "cuda", "source": "agi_lidar_slam_torch/csrc/sym_eig.cu",
         "replaces": "agi_lidar_slam_tpu/estimators/gn_scan2map.py:247",
         "note": "not a TPU kernel: the port's own, in place of torch.linalg.eigh (the "
                 "reference's jnp.linalg.eigh at that line and at estimators/two_step.py:39)",
         "launches": main_run["eig_launches"],
         "launches_by_path": {"odom": main_run["eig_launches"], "slam": slam_run["eig_launches"],
                              "liosam": liosam_run["eig_launches"],
                              "livox": livox_run["eig_launches"],
                              "aloam-ref": aloam_run["eig_launches"],
                              "lego-ref": lego_run["eig_launches"],
                              **{k: v["eig_launches"] for k, v in preset_runs.items()
                                 if "eig_launches" in v}},
         "max_abs_err": eig["max_abs_err"],
         "max_rel_err": max(max(c["vals"], c["rec"], c["orth"]) for c in eig["cases"].values()),
         "ms": eig["timing"]["path 1x6x6"]["device_ms"],
         "plain_ms": eig["timing"]["path 1x6x6"]["plain_device_ms"],
         "bound_ms": eig["timing"]["path 1x6x6"]["bound_ms"],
         "bound_by": eig["timing"]["path 1x6x6"]["bound_by"],
         "library_ms": eig["timing"]["path 1x6x6"]["library_device_ms"],
         "by_shape": eig["timing"], "cases": eig["cases"], "solve_delta": eig["delta"]},
        *({"name": name, "route": "cuda", "source": "agi_lidar_slam_torch/csrc/gn_iter.cu",
           "replaces": None,
           "note": "not a TPU kernel: a Gauss-Newton step's rows and tail, bit for bit the torch "
                   "ops (normal_equations' rows, solve_delta's clip, se3.boxplus)",
           "launches": main_run["gn_launches"][name],
           "launches_by_path": {"odom": main_run["gn_launches"][name],
                                "slam": slam_run["gn_launches"][name],
                                "liosam": liosam_run["gn_launches"][name],
                                "livox": livox_run["gn_launches"][name],
                                "aloam-ref": aloam_run["gn_launches"][name],
                                "lego-ref": lego_run["gn_launches"][name],
                                **{k: v["gn_launches"][name] for k, v in preset_runs.items()
                                   if "gn_launches" in v}},
           **{k: gn_timing[name][k] for k in ("device_ms", "plain_device_ms", "plain",
                                               "bound_ms", "bound_by")},
           **({"surf_step": gn_timing["gn_subset surf step"]} if name == "gn_subset" else {}),
           "differ": gn_differ.get(name, gn_differ["gn_rows"]),
           "versions": gn_kernels.versions()}
          for name in gn_kernels.launches),
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
    running = gn_kernels.versions()
    log(f"versions: {running}; the Gauss-Newton kernels' rounding orders were measured on "
        f"{gn_kernels.MEASURED_ON}")
    if running != gn_kernels.MEASURED_ON:
        raise AssertionError(
            f"torch, CUDA or cuBLAS is not the version the Gauss-Newton kernels copy the "
            f"rounding orders of ({running} against {gn_kernels.MEASURED_ON}): measure the "
            f"orders again (csrc/gn_iter.cu's source note), check the kernels with "
            f"tests/test_torch_gn_kernels.py, then set gn_kernels.MEASURED_ON")

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
    eig = timed("eig", phase_eig, device, main_run)
    chunk = timed("chunk", phase_chunk, device, main_run, smi)
    lio_run = timed("lio", phase_lio, device)
    timed("lio-cpu", phase_lio_cpu, lio_run)
    slam_run = timed("slam", phase_slam, device, main_run, smi)
    timed("slam-cpu", phase_slam_cpu, slam_run, main_run)
    liosam_run = timed("liosam", phase_liosam, device, main_run, smi)
    timed("liosam-cpu", phase_liosam_cpu, liosam_run)
    livox_run = timed("livox", phase_livox, device, smi)
    timed("livox-cpu", phase_livox_cpu, livox_run, device)
    aloam_run = timed("aloam-ref", phase_aloam_ref, device, smi)
    timed("aloam-ref-cpu", phase_aloam_ref_cpu, aloam_run)
    lego_run = timed("lego", phase_lego, device, smi)
    timed("lego-cpu", phase_lego_cpu, lego_run)
    preset_runs = timed("presets", phase_presets, device, lio_run, livox_run, smi)
    runner_runs = {name: timed(name, fn, device, smi) for name, fn in (
        ("runner-kitti", phase_runner_kitti), ("runner-bag", phase_runner_bag),
        ("runner-sim", phase_runner_sim))}
    par = timed("parallel", phase_parallel, device, main_run, lio_run, livox_run, smi)
    par2 = timed("parallel-2", phase_parallel2, device, par, main_run, lio_run, livox_run)
    path = timed("path", phase_path, {"odom": main_run["calls"], "lio": lio_run["calls"],
                                      "livox": livox_run["calls"],
                                      "aloam-ref": aloam_run["calls"],
                                      "horizon-ref": preset_runs["horizon-ref"]["calls"]},
                 prb["row_gather_sum"]["distinct"]["GB_per_s"])
    timed("profile", phase_profile, smi)
    log("phase seconds (host clock): " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items())
        + f"; total {sum(seconds.values()):.1f}")

    print(json.dumps(kernels_line(kern, prb, main_run, lio_run, slam_run, liosam_run, livox_run,
                                  aloam_run, lego_run, preset_runs, runner_runs, par, par2,
                                  path, eig, chunk)),
          flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
