#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. device  — the card's name and power limit (nvidia-smi); TF32 off;
  2. build   — nvcc builds the port's kernels from agi_lidar_slam_torch/csrc,
               one process per source;
  3. kernel  — the octant-KNN kernel against its plain PyTorch version at the
               odometry path's shapes (2048 queries / 8448-row corner table,
               8192 / 16640-row surf table, k=5) and the LIO path's (8192
               queries / 16640-row table of LioConfig().map, k=8), plus k=16,
               a ragged N and an all-masked batch; device times from
               torch.profiler, call times from CUDA events, and the bound from
               the bytes the inputs need; a launch the kernel refuses must raise;
  4. probe   — the two probe kernels (scale2, row_gather_sum) against their
               plain versions at the probe's defaults and at the association
               table's size (65,536 gathered 768 B rows of a 16640-row table),
               timed against the plain version and the library call; then the
               probe's entry points (stage0, stage1) with the counts reset;
  5. main    — preset_aloam_kitti64 over HDL-64-scale (64x1800) scans made on
               the card by the port's simulator, through
               runtime.pipeline.process_scan: finite poses, the kernel
               launched 4 times per scan, healthy correspondence counts and
               residuals, ATE against the simulator's ground truth, scans/s;
  6. cpu     — the same scans with CPU tensors, poses compared with the card's;
  7. lio     — LioConfig() over 64x1800 scans and 200 Hz exact IMU windows on
               bench.py's circle (radius 8 m, 0.25 rad/s, world seed 3), through
               runtime.lio_pipeline.process_lio_scan: finite state, the kernel
               launched once per scan plus once per re-probe, healthy matches
               and residuals, ATE against the circle, scans/s, then stage
               times, host syncs, launches and the busy share over more scans;
  8. lio-cpu — the same LIO scans with CPU tensors, poses compared.
Then the kernels line, the card line, and as the last line
{"ok": true, "device": {...}}. Any failed check raises, so the script exits
non-zero and prints no last line. It needs a CUDA device and the repository
around it; it imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import collections
import contextlib
import json
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

from agi_lidar_slam_torch import _build, preset_aloam_kitti64
from agi_lidar_slam_torch.estimators import ieskf
from agi_lidar_slam_torch.eval.metrics import ate_rmse
from agi_lidar_slam_torch.geometry import se3, so3
from agi_lidar_slam_torch.imu.eskf import NavState
from agi_lidar_slam_torch.map.hash_map import empty_map, insert
from agi_lidar_slam_torch.map.planar import build_ktab
from agi_lidar_slam_torch.nn import octant_knn
from agi_lidar_slam_torch.pointcloud.cloud import ScanGrid
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
# kernel vs plain version: the tolerances of tests/test_vmem_knn.py (one ulp
# of distance evaluation order; points are copied, so exact in practice)
SQ_TOL, PTS_TOL = 3e-6, 1e-5
# row_gather_sum vs its plain version: all terms positive, so two f32
# summation orders of B=64 terms differ by at most 2 (log2 B + 2) 2**-24
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


def filled_map(cfg, n_points: int, rng: np.random.Generator, device):
    """A HashVoxelMap filled with uniform points around the origin."""
    pts = rng.uniform([-25, -25, -2], [25, 25, 5], (n_points, 3)).astype(np.float32)
    return insert(empty_map(cfg, device), torch.from_numpy(pts).to(device),
                  torch.ones(n_points, dtype=torch.bool, device=device), cfg)


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
    max_err = 0.0
    timing = {}
    for name, (mcfg, m, n_path, k_path) in maps.items():
        ktab = build_ktab(m)
        rows = m.n_rows
        for n, k, masked in [(n_path, k_path, 0.2), (n_path, 16, 0.2), (1001, 5, 0.2),
                             (n_path, k_path, 1.0)]:
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
            log(f"kernel {name}: rows={rows} n={n} k={k} masked={masked:.0%} "
                f"valid[:,0]={float(valid[:, 0].float().mean()):.3f} "
                f"max_abs_err={err:.3g} OK")
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

    # a launch the kernel refuses (k above its selection width) must raise
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


def phase_probe(device) -> dict:
    """The probe kernels against their plain versions and the library calls,
    then the probe's entry points with the launch counts reset."""
    out = {}
    x = torch.from_numpy(np.random.default_rng(SEED).normal(size=(256, 128))
                         .astype(np.float32)).to(device)
    o = probe.scale2(x)
    torch.cuda.synchronize()
    if not torch.equal(o, probe.scale2_ref(x)):
        raise AssertionError("scale2 disagrees with its plain version")
    nb = 2 * x.numel() * 4
    b_ms, b_by = bound(nb, x.numel())
    out["scale2"] = {"256x128": {
        "ms": device_ms(lambda: probe.scale2(x)), "plain_ms": device_ms(lambda: probe.scale2_ref(x)),
        "library_ms": device_ms(lambda: x * 2), "call_ms": probe.chained_ms(lambda: probe.scale2(x)),
        "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": 0.0}}
    log(f"probe scale2 256x128: exact; {out['scale2']['256x128']}")

    out["row_gather_sum"] = {}
    for label, (C, B, rows, tiles) in {"probe_defaults": (64, 64, 4096, 8),
                                       "map_table": (64, 64, 16640, 1024)}.items():
        src, idx = probe.probe_inputs(C, B, rows, tiles, device)
        got, ref = probe.row_gather_sum(idx, src), probe.row_gather_sum_ref(idx, src)
        torch.cuda.synchronize()
        rel = float(((got - ref).abs() / ref.abs()).max())
        if not rel <= GATHER_RTOL:
            raise AssertionError(f"row_gather_sum {label}: relative error {rel} > {GATHER_RTOL}")
        n = tiles * C
        nb = probe.gather_bytes(idx, src)
        b_ms, b_by = bound(nb, n * B * 3)
        rec = {"gathered_rows": n, "table_MB": rows * B * 12 / 1e6,
               "gathered_MB": n * B * 12 / 1e6, "max_abs_err": float((got - ref).abs().max()),
               "max_rel_err": rel,
               "ms": device_ms(lambda: probe.row_gather_sum(idx, src)),
               "plain_ms": device_ms(lambda: probe.row_gather_sum_ref(idx, src)),
               "library_ms": device_ms(lambda: src[idx.long()].sum(1)),
               "call_ms": probe.chained_ms(lambda: probe.row_gather_sum(idx, src)),
               "bound_ms": b_ms, "bound_by": b_by}
        for key in ("ms", "plain_ms", "library_ms"):
            rec[key.replace("ms", "GB_per_s")] = (n * B * 12 / (rec[key] * 1e6)
                                                 if rec[key] else None)
        rec["ns_per_row"] = rec["ms"] * 1e6 / n if rec["ms"] else None
        out["row_gather_sum"][label] = rec
        log(f"probe row_gather_sum {label} (C={C} B={B} rows={rows} tiles={tiles}): "
            f"max rel err {rel:.3g}; {rec}")

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
    results, marks = [], [torch.cuda.Event(enable_timing=True)]
    octant_knn.launches = 0
    marks[0].record()
    for s in scans:
        state, res = process_scan(state, s, cfg)
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()
        torch.cuda.synchronize()
        results.append(res)
    launches = octant_knn.launches
    first_ms = marks[0].elapsed_time(marks[1])
    steady = (N_SCANS - N_WARM) * 1e3 / marks[N_WARM].elapsed_time(marks[-1])

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
        f"scans {N_WARM}..{N_SCANS - 1} (CUDA events between synchronized scans)")
    return {"launches": launches, "scans": scans, "gt": gt, "results": results, "ate": ate,
            "scans_per_s": steady}


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


def make_lio_inputs(n_scans: int, device):
    """bench.py's LIO workload made on `device`: 64x1800 scans along the
    circle (world seed 3, 48 pillars, extent 35 m, 10 Hz), flattened to
    (115200,) points with per-point seconds, exact 200 Hz IMU windows, and the
    scan-end ground-truth positions."""
    world = default_world(seed=3, n_pillars=48, extent=35.0, device=device)
    items, gt = [], []
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
        items.append((s.xyz.reshape(-1, 3), (s.time * LIO_SCAN_DT).reshape(-1),
                      s.mask.reshape(-1), win))
        gt.append(p1.t.cpu().numpy())
    return items, np.stack(gt)


def lio_start(cfg, device):
    x0 = NavState.identity(device)._replace(
        v=circle_velocity(0.0, LIO_RADIUS, LIO_OMEGA, device=device))
    return lio.init_lio_state(cfg, x0, device=device)


def _finite(state) -> bool:
    return all(bool(torch.isfinite(a).all()) for a in (*state.x, state.P))


@contextlib.contextmanager
def synchronized_stages(times: dict):
    """Time the LIO step's stages on the host clock with the card
    synchronized around each: the pipeline's and the IESKF's module-level
    functions are wrapped while the context is open."""
    targets = [(lio, "_propagate_window"), (lio, "undistort_to_end"), (lio, "voxel_downsample"),
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
    octant_knn.launches = 0
    marks[0].record()
    for pts, tt, m, win in items[:N_SCANS]:
        before = octant_knn.launches
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
    steady = (N_SCANS - N_WARM) * 1e3 / marks[N_WARM].elapsed_time(marks[-1])
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
        f"steady {steady:.2f} scans/s over scans {N_WARM}..{N_SCANS - 1} (CUDA events "
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
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                state, _ = lio.process_lio_scan(state, pts, tt, m, win, cfg)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        hits = [w for w in caught if "synchroniz" in str(w.message)]
        syncs.append(len(hits))
        sync_sites.update(f"{w.filename.split('agi_lidar_slam_torch/')[-1]}:{w.lineno}"
                          for w in hits)
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
            "syncs": syncs, "sync_sites": dict(sync_sites), "busy": busy, "launches_per_scan": n_launch / LIO_PROFILE_SCANS,
            "stage_ms": stage_ms}


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


def kernels_line(kern: dict, prb: dict, main_run: dict, lio_run: dict) -> dict:
    """Every number here was measured in this run; shapes are in the keys.
    ms / plain_ms / library_ms are device times per call (torch.profiler)."""
    t = kern["timing"]

    def by_shape(key):
        return {f"{v['queries']}x{v['rows']}xk{v['k']}": v[key] for v in t.values()}

    g = prb["row_gather_sum"]
    s = prb["scale2"]["256x128"]
    return {"kernels": [
        {"name": "octant_knn", "route": "cuda", "source": "agi_lidar_slam_torch/csrc/octant_knn.cu",
         "replaces": "agi_lidar_slam_tpu/nn/vmem_knn.py:150",
         "launches": main_run["launches"] + lio_run["launches"],
         "launches_by_path": {"odom": main_run["launches"], "lio": lio_run["launches"]},
         "max_abs_err": kern["max_abs_err"], "ms": t["lio"]["device_ms"],
         "plain_ms": t["lio"]["plain_device_ms"], "bound_ms": t["lio"]["bound_ms"],
         "bound_by": t["lio"]["bound_by"], "library_ms": None,
         **{f"{key}_by_shape": by_shape(key) for key in (
             "device_ms", "plain_device_ms", "call_ms", "plain_call_ms", "bound_ms")},
         "odom_scans_per_s": main_run["scans_per_s"], "odom_ate_m": main_run["ate"],
         "lio_scans_per_s": lio_run["scans_per_s"], "lio_ate_m": lio_run["ate"]},
        {"name": "scale2", "route": "cuda", "source": "agi_lidar_slam_torch/csrc/probe.cu",
         "replaces": "tools/pallas_probe.py:29", "launches": prb["launches"]["scale2"],
         "max_abs_err": s["max_abs_err"], "ms": s["ms"], "plain_ms": s["plain_ms"],
         "bound_ms": s["bound_ms"], "bound_by": s["bound_by"], "library_ms": s["library_ms"],
         "call_ms": s["call_ms"]},
        {"name": "row_gather_sum", "route": "cuda", "source": "agi_lidar_slam_torch/csrc/probe.cu",
         "replaces": "tools/pallas_probe.py:68", "launches": prb["launches"]["row_gather_sum"],
         "max_abs_err": max(v["max_abs_err"] for v in g.values()),
         "ms": g["map_table"]["ms"], "plain_ms": g["map_table"]["plain_ms"],
         "bound_ms": g["map_table"]["bound_ms"], "bound_by": g["map_table"]["bound_by"],
         "library_ms": g["map_table"]["library_ms"], "by_shape": g},
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
    lib = _build.build(verbose=True)
    _build.load()
    log(f"build: {lib.name} in {time.perf_counter() - t0:.1f} s")

    kern = phase_kernel(device)
    prb = phase_probe(device)
    main_run = phase_main(device)
    phase_cpu(main_run)
    lio_run = phase_lio(device)
    phase_lio_cpu(lio_run)

    print(json.dumps(kernels_line(kern, prb, main_run, lio_run)), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
