"""The port's stage profiler: where each engine's scan time goes on the card,
and how close its kernels run to their bound.

    python -m agi_lidar_slam_torch.tools.profile_engines
        [--engine odom|chunk|slam|lio|liosam|livox|kernels|all] [--scans N]
        [--reps R] [--out DIR] [--device cuda|cpu] [tag]

It writes SOL_<tag>.json and SOL_<tag>.md under --out (default: the
repository's git-ignored chiprun_out/). The default device is cuda; without
a card it exits non-zero unless asked for --device cpu, where every time is
the host clock's and every field that only the card gives (device ms,
launches, host syncs, busy share, kernel times and shares) is null.

It is the one counterpart of the JAX package's four TPU tools:

| JAX tool, stage | here |
|---|---|
| tools/profile_engines.py `stage_odom`, tools/profile_stages.py | engine `odom` (`preset_aloam_kitti64`, which has no `odometry_stage`): `full`, then `features`, `downsample`, `solve_scan2map`, `deskew`, `insert corners`, `insert surfs`, `bound_map`; sub-stages `knn corners (1 pass)`, `knn surfs (1 pass)`, `normal_equations (1 linearize)` |
| tools/profile_engines.py (the lax.scan batcher) | engine `chunk`: ms a scan of a `process_scan_chunk` replay of 4 scans |
| `stage_slam` | engine `slam`: `full`, `odometry+keyframe`, `loop_detect`; `loop_detect` at a full bank, and the driver's automatic closure there: `align_loop`, `solve_pose_graph`, `_correct_and_rebuild`, the stall |
| `stage_lio` | engine `lio`: `full`, `imu_propagate`, `undistort+downsample`, `ieskf_update`, `map_insert+bound` |
| `stage_liosam` | engine `liosam`: `full`, `imu_preintegrate`, `deskew+features+downsample`, `solve_scan2map`, `fuse`, `map_insert+bound`, `keyframe+loop_detect` |
| tools/profile_livox.py, `stage_livox` | engine `livox`: `full`, `preprocess`, `preint`, `solve`, `marg`, `mapins`; sub-stages `dyn_rem`, `features`, `wininfo` |
| `kernel_rooflines`, tools/ablate_knn.py | `kernels`: the octant KNN at each path's shapes beside its glue, `insert_with_stats` split into its claim rounds and its scatter, `sym_eig` beside `torch.linalg.eigh`, `scale2` and `row_gather_sum` at tools/probe.py's shapes |
| `mfu_summary` | not carried over: its FLOP counts were set by hand. `engine_summary` gives instead the sum of the bounds of the kernel calls of one step (octant KNN, `sym_eig`, `insert_with_stats`) |

How a step is split. Each top-level stage is the port's own function,
called by the engine step itself, in its order and on the tensors it hands
over: the profiler runs the real step with timed wrappers in place of those
functions, passed through the operation arguments where the step's body
takes them (`solve_fn`, `insert_fn`, `bound_fn`, `update_fn`) and set on the
module that looks them up at call time otherwise; it adds no hook to an
engine. A stage called inside another stage belongs to the outer one. So
the staged step is the engine step (`composition_gap` holds its pose to
the plain step's), and its top-level stages add up to the step less the
glue between them. Sub-stages are timed apart, on the tensors the staged
step handed their stage, and are not part of that sum.

What each stage reports: ms, the median of R synchronized calls (CUDA
events on the card, the host clock on the CPU) with their spread; kernel
launches, each launch call of a profiled run once (launch_record, which
also links them to the kernels the device recorded);
host syncs, counted under torch.cuda.set_sync_debug_mode("warn") in a run
apart from the timed one. Bounds are the larger of the bytes a call must
move over the HBM rate and its f32 operations over the f32 rate, from the
card's published peaks (PUBLISHED_PEAKS). An engine's busy share is the
device time of its step's work over the step's median ms. A share of a
bound or a busy share above SHARE_LIMIT raises. Its numbers are in PERF.md beside the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import contextlib
import dataclasses
import json
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

from ..config import preset_aloam_kitti64
from ..estimators import gn_scan2map, sym_eig, two_step, window_map
from ..geometry import se3, so3
from ..graph import loop_closure, pose_graph
from ..graph.keyframes import KeyframeBank, last_index
from ..imu.eskf import NavState
from ..map import hash_map
from ..map.planar import build_ktab
from ..nn import knn as knn_mod
from ..nn import octant_knn
from ..pointcloud.cloud import ScanGrid
from ..runtime import lio_pipeline as lio
from ..runtime import livox_pipeline, liosam_pipeline, pipeline, slam_pipeline
from ..sim.trajectory import circle_imu, circle_pose, circle_velocity
from ..sim.world import default_world, simulate_scan
from . import probe

ENGINES = ("odom", "chunk", "slam", "lio", "liosam", "livox")
SEED = 0
RINGS, WIDTH = 64, 1800  # KITTI HDL-64 scan scale
CHUNK = 4  # scans a chunk of the chunk engine
LIO_RADIUS, LIO_OMEGA, SCAN_DT, LIO_IMU = 8.0, 0.25, 0.1, 20  # bench.py's circle
KF_DT = 1.0 / (LIO_RADIUS * LIO_OMEGA)  # s between keyframes 1 m apart on that circle
LIVOX_INIT_FRAMES = 4  # bench.py's livox headline
BUDGET_MS = 100.0  # a 10 Hz lidar's time for one scan
SHARE_LIMIT = 1.05  # a share of a bound above this is a fault of the count
# published peaks (NVIDIA data sheet, H100 SXM, dense): HBM bytes/s and f32
# FLOP/s outside the tensor cores, at the 700 W limit
PUBLISHED_PEAKS = {"H100": {"hbm_bytes_per_s": 3.35e12, "f32_flops": 67e12}}
HBM_BYTES_PER_S = PUBLISHED_PEAKS["H100"]["hbm_bytes_per_s"]
F32_FLOPS = PUBLISHED_PEAKS["H100"]["f32_flops"]
RANGE = "profile_engines::"  # the name of a stage's range in a profile starts so
# the host calls that put kernels on the card (torch.profiler's CPU events):
# the runtime's and the driver's (Triton's, some libraries'); each is one
# launch with a correlation id of its own, which its kernels carry
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
            "cudaGraphLaunch")


# --------------------------------------------------------------------------
# a. timing and counting primitives


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
    on the card, summed by torch.profiler over `reps` calls. Of up to three
    profiles it keeps the first in which every launch is linked to a kernel
    the device recorded ("complete" in `profiling`). If none is, it takes
    the last that recorded device work, scaled up by its launches over its
    linked launches (so a lost kernel counts as the mean of those recorded,
    not as zero); None if none recorded any (then it is not measured).

    cuda_ms times a call from the host's side: for a kernel this short that
    is mostly the wrapper's host work, so this is the kernel's own time."""
    fn()
    torch.cuda.synchronize()
    ms = None
    for _ in range(3):  # a profile now and then records only part of the work: again
        with profiling() as rec:
            for _ in range(reps):
                fn()
        if rec["complete"] and rec["device_ms"] > 0:
            return rec["device_ms"] / reps
        linked = rec["launches"] - sum(rec["unlinked"].values())
        if rec["device_ms"] > 0 and linked > 0:
            ms = rec["device_ms"] * rec["launches"] / linked / reps
    return ms


def launch_record(events) -> dict:
    """What a profile's raw events say of its launches: their host start
    times ("starts"), their count ("launches"), the device time of every
    kernel, copy and fill in ms ("device_ms"), and the launches that no
    kernel the device recorded is linked to by correlation id, counted by
    name ("unlinked": in a process that has run many profiles,
    torch.profiler was seen to lose a few kernels' records)."""
    cuda = torch.autograd.DeviceType.CUDA
    launches = [e for e in events if e.name() in LAUNCHES]
    work = [e for e in events if e.device_type() == cuda and not e.is_user_annotation()]
    linked = {e.correlation_id() for e in work}
    return {"starts": sorted(e.start_ns() for e in launches), "launches": len(launches),
            "device_ms": sum(e.end_ns() - e.start_ns() for e in work) / 1e6,
            "unlinked": dict(collections.Counter(e.name() for e in launches
                                                 if e.correlation_id() not in linked))}


@contextlib.contextmanager
def profiling():
    """While open, torch.profiler records the card's work (synchronized at
    both ends). On closing, the dict it yields gets launch_record's
    "launches", "device_ms" and "unlinked", whether every launch is linked
    to a recorded kernel ("complete"), and the launches inside each stage
    range ("ranges": record_function ranges named RANGE + label, a launch
    counted in every range that holds it). It reads the profiler's raw
    events: torch's event tree, which counting does not need, takes seconds
    to build for a step of thousands of launches."""
    rec: dict = {}
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        yield rec
        torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    rec.update(launch_record(events))
    starts = rec.pop("starts")
    rec["complete"] = not rec["unlinked"]
    ranges: collections.Counter = collections.Counter()
    for e in events:
        if e.device_type() == torch.autograd.DeviceType.CPU and e.name().startswith(RANGE):
            ranges[e.name()[len(RANGE):]] += (bisect.bisect_right(starts, e.end_ns())
                                              - bisect.bisect_left(starts, e.start_ns()))
    rec["ranges"] = dict(ranges)


def profiled(fn):
    """One synchronized fn() call under torch.profiler, profiled up to three
    times until a profile is complete: (its result, the `profiling` record
    of its last profile)."""
    for _ in range(3):
        with profiling() as rec:
            out = fn()
        if rec["complete"]:
            break
    return out, rec


def share(num_ms: float | None, den_ms: float | None, what: str) -> float | None:
    """num / den, a share of a capacity (a bound over a measured time, kernel
    time over wall time): above SHARE_LIMIT it is a fault of the count, and
    raises. None where either is not measured."""
    if num_ms is None or not den_ms:
        return None
    s = num_ms / den_ms
    if not s <= SHARE_LIMIT:
        raise ValueError(f"{what}: share {s:.3f} above {SHARE_LIMIT}: the bound or the "
                         f"measurement is wrong ({num_ms:.6g} ms of {den_ms:.6g} ms)")
    return s


def bound(n_bytes: float, flops: float) -> tuple[float, str]:
    """The least time (ms) the card could take: the larger of bytes over the
    HBM rate and operations over the f32 rate, and which one it is."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def knn_work(m, queries, qmask, k, cfg, ktab) -> tuple[int, int]:
    """(bytes, flops) one octant-KNN call must spend on these inputs: the
    queries, mask and outputs, each distinct probe-window entry of the
    packed-key index and each distinct map row the live queries hit (points
    + occupancy), read once; 8 flops (3 sub, 3 mul, 2 add) per candidate of
    a hit row."""
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
    return n_bytes, 8 * int(rows.numel()) * B


def knn_bound(m, queries, qmask, k, cfg, ktab) -> tuple[float, str]:
    """Bound of one octant-KNN call on these inputs (knn_work)."""
    return bound(*knn_work(m, queries, qmask, k, cfg, ktab))


def insert_work(m, xyz, mask) -> tuple[int, int]:
    """(bytes, flops) of insert_with_stats: it returns a new map, so the map
    (keys, points, occupancy) is read once and written once, the points and
    mask read and the drop count written; its arithmetic is a few integer
    operations a point, counted as none."""
    map_bytes = sum(t.numel() * t.element_size() for t in m)
    return 2 * map_bytes + xyz.numel() * 4 + mask.numel() + 4, 0


def eig_work(a) -> tuple[int, int]:
    """(bytes, flops) of sym_eig on (..., n, n): each matrix read, its n
    eigenvalues and n x n eigenvectors written; 9 n^3 flops a matrix."""
    n = a.shape[-1]
    B = a.numel() // (n * n)
    return B * (2 * n * n + n) * 4, 9 * n ** 3 * B


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


def on_card(device) -> bool:
    return torch.device(device).type == "cuda"


def card_info(device) -> dict:
    """The device's name and power limit (nvidia-smi's own words), and the
    published peaks the bounds use; on the CPU the peaks alone, for the
    bounds, which are the card's."""
    hw = {"device": torch.device(device).type, "name": None, "power_limit": None,
          **PUBLISHED_PEAKS["H100"], "peaks_of": "H100 SXM, NVIDIA data sheet"}
    if on_card(device):
        name = torch.cuda.get_device_name(0)
        if "H100" not in name:
            raise ValueError(f"no published peaks for {name!r}: the bounds need them")
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip().splitlines()[0]
        hw.update(name=name, power_limit=smi.split(",")[-1].strip(), nvidia_smi=smi)
    return hw


def timed_call(fn, cuda: bool):
    """(fn(), ms of the call with the card synchronized before it and after
    it: CUDA events on the card, the host clock on the CPU)."""
    if not cuda:
        t0 = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


def syncs_of(fn):
    """(fn(), the host syncs it makes on the card)."""
    n: list = []
    with counted_syncs(n, collections.Counter()):
        out = fn()
    return out, n[0]


# --------------------------------------------------------------------------
# b. the engines' stage splits


class Stages:
    """The stages of one engine step, measured one way: "time" (ms of each
    synchronized call), "profile" (a record_function range around each call,
    whose launches `profiling` counts; card only) or "syncs" (host syncs,
    card only). `wrap(label, fn)` gives fn measured under `label` (a string,
    a tuple of names taken in turn by the calls of one step, or a function
    of the call's arguments that names its stage); a call made
    while another stage is open belongs to that stage, unless the recorder
    was made with nested=True. Values of one label in one step add up;
    `end_step` files them."""

    def __init__(self, mode: str, cuda: bool, nested: bool = False):
        self.mode, self.cuda, self.nested = mode, cuda, nested
        self.depth = 0
        self.step: dict = {}
        self.turn: collections.Counter = collections.Counter()
        self.values: dict = collections.defaultdict(list)
        self.calls: collections.Counter = collections.Counter()

    def wrap(self, label, fn):
        def wrapper(*a, **kw):
            if self.depth and not self.nested:
                return fn(*a, **kw)
            if isinstance(label, tuple):
                key = label[self.turn[label] % len(label)]
                self.turn[label] += 1
            else:
                key = label(*a, **kw) if callable(label) else label
            self.depth += 1
            try:
                out, value = self._measure(key, lambda: fn(*a, **kw))
            finally:
                self.depth -= 1
            self.step[key] = self.step.get(key, 0) + value
            self.calls[key] += 1
            return out
        return wrapper

    def _measure(self, key: str, call):
        if self.mode == "time":
            return timed_call(call, self.cuda)
        if self.mode == "profile":
            with torch.profiler.record_function(RANGE + key):
                return call(), 0
        return syncs_of(call)

    def end_step(self) -> None:
        for k, v in self.step.items():
            self.values[k].append(v)
        self.step = {}
        self.turn.clear()


@contextlib.contextmanager
def patched(stages: Stages, targets):
    """While open, each (module, name, label) of `targets` is the module's
    function wrapped by `stages` under `label`."""
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in targets]
    for (mod, name, fn), (_, _, label) in zip(saved, targets):
        setattr(mod, name, stages.wrap(label, fn))
    try:
        yield stages
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


class Capture:
    """A function that records its last call's arguments and result."""

    def __init__(self, fn):
        self.fn, self.args, self.kwargs, self.out = fn, None, None, None

    def __call__(self, *a, **kw):
        self.args, self.kwargs = a, kw
        self.out = self.fn(*a, **kw)
        return self.out


def arc_scans(n: int, device):
    """bench.py's odometry workload made on `device`: n HDL-64 field-of-view
    scans (RINGS x WIDTH, read at call time) along the arc of 1 m and 0.01 rad of yaw a scan,
    world seed SEED; and the motion of one scan."""
    world = default_world(seed=SEED, n_pillars=48, extent=35.0, device=device)
    step = se3.Pose(so3.quat_exp(torch.tensor([0.0, 0.0, 0.01], device=device)),
                    torch.tensor([1.0, 0.0, 0.0], device=device))
    pose, scans = se3.Pose.identity(device=device), []
    for i in range(n):
        nxt = se3.compose(pose, step)
        scans.append(simulate_scan(world, pose, nxt, rings=RINGS, width=WIDTH, fov_up_deg=2.0,
                                   fov_down_deg=-24.8, max_range=80.0, noise_std=0.01, seed=i))
        pose = nxt
    return scans, step


def circle_sweeps(n: int, device):
    """bench.py's LIO workload made on `device`: n sweeps along the circle
    (radius 8 m, 0.25 rad/s, world seed 3, 10 Hz) with their exact 200 Hz
    IMU windows."""
    world = default_world(seed=3, n_pillars=48, extent=35.0, device=device)
    out = []
    for i in range(n):
        t0, t1 = i * SCAN_DT, (i + 1) * SCAN_DT
        s = simulate_scan(world, circle_pose(t0, LIO_RADIUS, LIO_OMEGA, device=device),
                          circle_pose(t1, LIO_RADIUS, LIO_OMEGA, device=device), rings=RINGS,
                          width=WIDTH, fov_up_deg=2.0, fov_down_deg=-24.8, max_range=80.0,
                          noise_std=0.01, seed=i)
        ts = t0 + (torch.arange(LIO_IMU, device=device) + 0.5) * (SCAN_DT / LIO_IMU)
        gy, ac = circle_imu(ts, LIO_RADIUS, LIO_OMEGA)
        out.append((s, lio.ImuWindow(gy, ac, torch.full((LIO_IMU,), SCAN_DT / LIO_IMU,
                                                        device=device),
                                     torch.ones(LIO_IMU, dtype=torch.bool, device=device))))
    return out


def moving_start(cfg, step: se3.Pose, device):
    """init_state already moving at one `step` a scan: from rest the preset
    does not recover a 1 m first step (nor does the JAX package)."""
    state = pipeline.init_state(cfg, device)
    back = se3.inverse(step)
    pose = se3.compose(state.pose, back)
    return state._replace(pose=pose, prev_pose=se3.compose(pose, back))


class Engine:
    """One engine at its profiled scan: `step()` runs the engine step and
    returns its pose, `staged(stages)` runs the same step with its stages
    wrapped, `subs()` names the sub-stages (zero-argument calls on the
    tensors the last staged step handed their stage). Both steps start from
    the same state each time."""

    name = ""
    kernel_modules: tuple = ()  # modules whose insert_with_stats the step looks up
    composes = True  # whether the staged step's stages are parts of `step`

    def subs(self) -> dict:
        return {}


class Odom(Engine):
    """process_scan with preset_aloam_kitti64 (bench.py's odometry headline),
    a preset with neither an odometry stage nor the two-step solve."""

    name = "odom"
    kernel_modules = (pipeline,)

    def __init__(self, scans, step_pose, n_warm, device):
        self.cfg = preset_aloam_kitti64()
        state = moving_start(self.cfg, step_pose, device)
        for s in scans[:n_warm]:
            state, _ = pipeline.process_scan(state, s, self.cfg)
        self.state, self.scan = state, scans[n_warm]
        self.solve = None

    def step(self):
        return pipeline.process_scan(self.state, self.scan, self.cfg)[1].pose

    def staged(self, stages: Stages):
        self.solve = Capture(pipeline.solve_scan2map)
        targets = [(pipeline, "extract_features_timed", "features"),
                   (pipeline, "voxel_downsample_aux", "downsample"),
                   (se3, "apply_interpolated", "deskew")]
        with patched(stages, targets):
            _, res = pipeline._process_scan_body(
                self.state, self.scan, self.cfg,
                solve_fn=stages.wrap("solve_scan2map", self.solve),
                insert_fn=stages.wrap(("insert corners", "insert surfs"),
                                      pipeline.insert_with_stats),
                bound_fn=stages.wrap("bound_map", pipeline.bound_map))
        return res.pose

    def subs(self) -> dict:
        pose, corners, surfs, cmap, smap, ccfg, scfg, solver = self.solve.args[:8]
        R = so3.quat_to_matrix(pose.q)
        k = solver.k_neighbors
        ctab, stab = gn_scan2map._ktab(cmap, ccfg), gn_scan2map._ktab(smap, scfg)
        cw, sw = corners.xyz @ R.T + pose.t, surfs.xyz @ R.T + pose.t
        corr = gn_scan2map.associate(pose, corners, surfs, cmap, smap, ccfg, scfg, solver,
                                     ctab, stab)
        return {"knn corners (1 pass)": lambda: knn_mod.knn(cmap, cw, corners.mask, k, ccfg,
                                                            ktab=ctab),
                "knn surfs (1 pass)": lambda: knn_mod.knn(smap, sw, surfs.mask, k, scfg,
                                                          ktab=stab),
                "normal_equations (1 linearize)": lambda: gn_scan2map.normal_equations(
                    pose, corners, surfs, corr, solver)}


class Chunk(Engine):
    """process_scan_chunk over the CHUNK scans from the odom engine's
    profiled one: its `step` is one chunk (one graph replay on the card),
    against `staged`, the same scans one process_scan call each: a stage
    "apart", the alternative to the chunk, not a part of it."""

    name = "chunk"
    kernel_modules = (pipeline,)
    composes = False

    def __init__(self, odom: Odom, scans: list):
        self.cfg, self.state = odom.cfg, odom.state
        self.scans = scans
        self.chunk = ScanGrid(*(torch.stack(f) for f in zip(*scans)))
        self.capture_s = None
        if self.chunk.xyz.is_cuda:  # the first call captures the graph
            t0 = time.perf_counter()
            self.step()
            torch.cuda.synchronize()
            self.capture_s = time.perf_counter() - t0

    def step(self):
        _, res = pipeline.process_scan_chunk(self.state, self.chunk, self.cfg)
        return se3.Pose(res.pose.q[-1], res.pose.t[-1])

    def staged(self, stages: Stages):
        state = self.state
        run = stages.wrap("process_scan", pipeline.process_scan)
        for s in self.scans:
            state, res = run(state, s, self.cfg)
        return res.pose


def drive_bank(cfg, device) -> KeyframeBank:
    """A full bank as a drive fills it: cfg.bank_capacity keyframes 1 m
    apart (the keyframe gate's distance, KF_DT on the circle) along the LIO
    circle of circle_sweeps, some 20 laps of it, each keyframe the
    downsampled features of an HDL-64 scan of its own taken at its pose,
    stamped with its 10 Hz scan index. So every keyframe has its own pose
    and cloud, and the last has a keyframe of an earlier lap within the
    loop radius and more than the detector's stamp separation before it.
    On the card one keyframe's scan and features are one CUDA graph,
    replayed at each pose (1024 keyframes one by one take about 20 s of
    host dispatch); its scans have no range noise, since a replay cannot
    draw from the simulator's seeded generator."""
    pcfg = cfg.pipeline
    K = cfg.bank_capacity
    world = default_world(seed=3, n_pillars=48, extent=35.0, device=device)
    ts = torch.arange(K, device=device) * KF_DT
    poses = circle_pose(ts, LIO_RADIUS, LIO_OMEGA, device=device)
    pose = se3.Pose(poses.q[0].clone(), poses.t[0].clone())

    def cloud():
        scan = simulate_scan(world, pose, pose, rings=RINGS, width=WIDTH, fov_up_deg=2.0,
                             fov_down_deg=-24.8, max_range=80.0)
        f = pipeline.extract_features_timed(scan, pcfg.features)
        c, _ = pipeline.voxel_downsample_aux(f.corners.xyz, f.corners.mask,
                                             pcfg.corner_ds_voxel, pcfg.features.max_corners)
        s, _ = pipeline.voxel_downsample_aux(f.surfs.xyz, f.surfs.mask, pcfg.surf_ds_voxel,
                                             pcfg.features.max_surfs)
        return c.xyz, c.mask, s.xyz, s.mask

    run = cloud
    if on_card(device):
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):  # torch's warm-up before a capture
            cloud()
        torch.cuda.current_stream(device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outputs = cloud()

        def run():
            graph.replay()
            return outputs

    bank = [torch.empty((K, *o.shape), dtype=o.dtype, device=device) for o in run()]
    for i in range(K):
        pose.q.copy_(poses.q[i])
        pose.t.copy_(poses.t[i])
        for dst, src in zip(bank, run()):
            dst[i].copy_(src)
    return KeyframeBank(poses.q, poses.t, torch.round(ts / SCAN_DT).to(torch.int32), *bank,
                        torch.tensor(K, dtype=torch.int32, device=device))


def chain_edges(bank: KeyframeBank, capacity: int, cfg) -> pose_graph.EdgeSet:
    """The odometry edges of a full bank: each keyframe to the next, with the
    exact relative pose at the slam config's odometry weights."""
    K, dev = bank.capacity, bank.t.device
    e = pose_graph.empty_edges(capacity, dev)
    i = torch.arange(K - 1, dtype=torch.int32, device=dev)
    z = pose_graph.between_measurement(se3.Pose(bank.q[:-1], bank.t[:-1]),
                                       se3.Pose(bank.q[1:], bank.t[1:]))
    n = K - 1

    def head(a, v):
        return torch.cat([v.to(a.dtype), a[n:]])

    return pose_graph.EdgeSet(
        head(e.i, i), head(e.j, i + 1), head(e.z_q, z.q), head(e.z_t, z.t),
        head(e.w_rot, torch.full((n,), cfg.odom_w_rot, device=dev)),
        head(e.w_trans, torch.full((n,), cfg.odom_w_trans, device=dev)),
        e.kind, head(e.valid, torch.ones(n, dtype=torch.bool, device=dev)),
        torch.full_like(e.count, n))


class Slam(Engine):
    """SlamDriver (bench.py's slam headline: the odometry preset, a bank of
    1024 keyframes, 2048 edges) at the odom engine's profiled scan; then a
    full bank (drive_bank, chain_edges) for loop_detect at 1024 of 1024
    keyframes and one automatic closure there (`arm`, `close`)."""

    name = "slam"
    kernel_modules = (pipeline,)

    def __init__(self, scans, step_pose, n_warm, device):
        self.cfg = slam_pipeline.SlamConfig(pipeline=preset_aloam_kitti64(),
                                            bank_capacity=1024, edge_capacity=2048)
        drv = slam_pipeline.SlamDriver(self.cfg, device)
        drv.state = drv.state._replace(engine=moving_start(self.cfg.pipeline, step_pose,
                                                           device))
        for s in scans[:n_warm]:
            drv.process(s)
        self.drv, self.scan = drv, scans[n_warm]
        self.saved = (drv.state, drv.host_frame)
        t0 = time.perf_counter()
        bank = drive_bank(self.cfg, device)
        self.bank_s = time.perf_counter() - t0
        self.closure_state = drv.state._replace(bank=bank, edges=chain_edges(
            bank, self.cfg.edge_capacity, self.cfg))

    def _restore(self, state=None):
        self.drv.state, self.drv.host_frame = (state or self.saved[0]), self.saved[1]
        self.drv._pending = False
        self.drv.n_loops_closed = 0

    def step(self):
        self._restore()
        return self.drv.process(self.scan).pose

    def staged(self, stages: Stages):
        self._restore()
        targets = [(slam_pipeline, "process_scan", "odometry+keyframe"),
                   (slam_pipeline, "_keyframe_step_body", "odometry+keyframe"),
                   (slam_pipeline, "detect_loop", "loop_detect")]
        with patched(stages, targets):
            return self.drv.process(self.scan).pose

    def subs(self) -> dict:
        bank = self.closure_state.bank
        n = bank.capacity
        return {f"loop_detect ({n} of {n} keyframes)": lambda: loop_closure.detect_loop(
            bank, last_index(bank), self.cfg.loop)}

    def arm(self) -> None:
        """The full bank, and its loop detection copied to the host as the
        driver's cadence does it a scan before it acts on it."""
        self._restore(self.closure_state)
        cand, found = slam_pipeline._detect_step(self.drv.state.bank, self.cfg)
        self.drv._flag.copy(found, cand)
        self.drv._pending = True

    def close(self) -> None:
        """The armed closure as the driver makes it on its own (`_drain`):
        the flag read, align_loop against the detected candidate and, the
        loop accepted, _correct_and_rebuild. It must close the loop."""
        self.drv._drain()
        if self.drv.n_loops_closed != 1:
            raise AssertionError("slam: no loop closed at the full bank")


class Lio(Engine):
    name = "lio"
    kernel_modules = (lio,)

    def __init__(self, sweeps, n_warm, device):
        self.cfg = lio.LioConfig()
        x0 = NavState.identity(device)._replace(
            v=circle_velocity(0.0, LIO_RADIUS, LIO_OMEGA, device=device))
        state = lio.init_lio_state(self.cfg, x0, device=device)
        items = [(s.xyz.reshape(-1, 3), (s.time * SCAN_DT).reshape(-1), s.mask.reshape(-1), w)
                 for s, w in sweeps]
        for it in items[:n_warm]:
            state, _ = lio.process_lio_scan(state, *it, self.cfg)
        self.state, self.item = state, items[n_warm]

    def step(self):
        return lio.process_lio_scan(self.state, *self.item, self.cfg)[1].x.p

    def staged(self, stages: Stages):
        targets = [(lio, "_propagate_window", "imu_propagate"),
                   (lio, "undistort_to_end", "undistort+downsample"),
                   (lio, "voxel_downsample", "undistort+downsample"),
                   (lio, "insert_with_stats", "map_insert+bound"),
                   (lio, "bound_map", "map_insert+bound")]
        with patched(stages, targets):
            _, res = lio._process_lio_body(self.state, *self.item, self.cfg,
                                           update_fn=stages.wrap("ieskf_update",
                                                                 lio.update_iterated))
        return res.x.p


class LioSam(Engine):
    """LioSamDriver (bench.py's liosam headline) on the circle's sweeps."""

    name = "liosam"
    kernel_modules = (liosam_pipeline,)

    def __init__(self, sweeps, n_warm, device):
        self.cfg = liosam_pipeline.LioSamConfig(
            slam=slam_pipeline.SlamConfig(pipeline=preset_aloam_kitti64()), scan_period=SCAN_DT)
        drv = liosam_pipeline.LioSamDriver(
            self.cfg, x0=circle_pose(0.0, LIO_RADIUS, LIO_OMEGA, device=device),
            v0=circle_velocity(0.0, LIO_RADIUS, LIO_OMEGA, device=device), device=device)
        for s, w in sweeps[:n_warm]:
            drv.process(s, w)
        self.drv, self.item = drv, sweeps[n_warm]
        self.saved = (drv.state, drv.bank, drv.edges, drv.last_kf, drv.host_frame)

    def _restore(self):
        d = self.drv
        d.state, d.bank, d.edges, d.last_kf, d.host_frame = self.saved
        d._pending = False

    def step(self):
        self._restore()
        return self.drv.process(*self.item).pose

    def staged(self, stages: Stages):
        self._restore()
        m = liosam_pipeline
        targets = [(m, "preintegrate", "imu_preintegrate"),
                   (m, "deskew_with_imu", "deskew+features+downsample"),
                   (m, "extract_features", "deskew+features+downsample"),
                   (m, "voxel_downsample", "deskew+features+downsample"),
                   (m, "solve_scan2map", "solve_scan2map"), (m, "_fuse", "fuse"),
                   (m, "insert_with_stats", "map_insert+bound"),
                   (m, "bound_map", "map_insert+bound"),
                   (m, "_keyframe_step_body", "keyframe+loop_detect"),
                   (m, "detect_loop", "keyframe+loop_detect")]
        with patched(stages, targets):
            return self.drv.process(*self.item).pose


class Livox(Engine):
    """LivoxDriver (bench.py's livox headline: LivoxConfig(), LO for
    init_frames sweeps, then the window LIO) on the circle's sweeps; the
    engaged window step of the sweep after the warm-up."""

    name = "livox"
    kernel_modules = (livox_pipeline,)

    def __init__(self, sweeps, n_warm, init_frames, device):
        drv = livox_pipeline.LivoxDriver(livox_pipeline.LivoxConfig(), init_frames=init_frames,
                                         x0=circle_pose(0.0, LIO_RADIUS, LIO_OMEGA,
                                                        device=device), device=device)
        for s, w in sweeps[:n_warm]:
            drv.process(s, w)
        if not drv.engaged:
            raise AssertionError("livox: not engaged after the warm-up sweeps")
        self.cfg, self.state, self.item = drv.cfg, drv.state, sweeps[n_warm]
        self.solve = None

    def step(self):
        return livox_pipeline.process_livox_scan(self.state, *self.item, self.cfg)[1].pose

    def staged(self, stages: Stages):
        m = livox_pipeline
        self.solve = Capture(m.solve_window)
        targets = [(m, "_features", "preprocess"), (m, "preintegrate", "preint"),
                   (m, "_boxminus_flat", "marg"), (m, "marginalize_oldest", "marg"),
                   (m, "_embed_prior", "marg"), (m, "_insert_all", "mapins")]
        with patched(stages, targets):
            _, res = m._process_livox_body(self.state, *self.item, self.cfg,
                                           solve_fn=stages.wrap("solve", self.solve))
        return res.pose

    def subs(self) -> dict:
        from ..features.dynamic_removal import remove_dynamic
        from ..features.livox import extract_livox_features

        cfg, scan = self.cfg, self.item[0]
        (ws, corners, surfs, cmap, smap, preints, _prior, grav, ccfg, scfg, solver,
         lidar_w) = self.solve.args
        ws_opt = self.solve.out[0]
        return {"dyn_rem": lambda: remove_dynamic(scan, cfg.dynamic),
                "features": lambda: extract_livox_features(scan, cfg.features),
                "wininfo": lambda: window_map.window_information(
                    ws_opt, corners, surfs, cmap, smap, preints, grav, ccfg, scfg, solver,
                    lidar_w, **self.solve.kwargs)}


def _pose_gap(a, b) -> float:
    """Largest difference (m, or of a quaternion entry) between two poses
    (se3.Pose or a position)."""
    pa = (a.t, a.q) if isinstance(a, se3.Pose) else (a,)
    pb = (b.t, b.q) if isinstance(b, se3.Pose) else (b,)
    return max(float((x - y).abs().max()) for x, y in zip(pa, pb))


def _equal(a, b) -> bool:
    pa = (a.t, a.q) if isinstance(a, se3.Pose) else (a,)
    pb = (b.t, b.q) if isinstance(b, se3.Pose) else (b,)
    return all(torch.equal(x, y) for x, y in zip(pa, pb))


def _row(values: list, calls: int, reps: int, level: str) -> dict:
    return {"ms": statistics.median(values), "spread_ms": [min(values), max(values)],
            "calls": calls / reps, "launches": None, "syncs": None, "level": level}


def run_stages(eng: Engine, reps: int, cuda: bool) -> dict:
    """The engine's step and its stages, each measured R times (ms) and,
    on the card, once more for launches and once more for host syncs."""
    full, stages, last = [], Stages("time", cuda), None
    for _ in range(reps):
        ref, ms = timed_call(eng.step, cuda)
        full.append(ms)
        last = eng.staged(stages)
        stages.end_step()
    out = {"full": _row(full, reps, reps, "step")}
    for k, v in stages.values.items():
        out[k] = _row(v, stages.calls[k], reps, "top" if eng.composes else "apart")
    subs = eng.subs()
    for k, fn in subs.items():
        fn()  # warm-up
        out[k] = _row([timed_call(fn, cuda)[1] for _ in range(reps)], 1, 1, "sub")
    summary = {"composition_gap": _pose_gap(ref, last), "composition_equal": _equal(ref, last)}
    if cuda:
        # busy share: the device time of the step's work over the step's
        # unprofiled time (the profiler's own start, stop and per-launch
        # cost would inflate a profiled wall time)
        _, prof = profiled(eng.step)
        out["full"]["launches"] = prof["launches"]
        summary["busy_share"] = share(prof["device_ms"], out["full"]["ms"],
                                      f"{eng.name}: busy share")
        summary["device_kernel_ms"] = prof["device_ms"]
        summary["profile_complete"] = prof["complete"]
        summary["unlinked_launches"] = prof["unlinked"]
        out["full"]["syncs"] = syncs_of(eng.step)[1]
        with profiling() as rec:
            eng.staged(Stages("profile", cuda))
            for k, fn in subs.items():
                with torch.profiler.record_function(RANGE + k):
                    fn()
        st = Stages("syncs", cuda)
        eng.staged(st)
        st.end_step()
        for k, v in st.values.items():
            out[k]["syncs"] = v[0]
        for k, fn in subs.items():
            out[k]["syncs"] = syncs_of(fn)[1]
        for k in out:
            if k != "full":
                out[k]["launches"] = rec["ranges"].get(k, 0)
    else:
        summary["busy_share"] = summary["device_kernel_ms"] = summary["profile_complete"] = None
        summary["unlinked_launches"] = None
    top = [v["ms"] for v in out.values() if v["level"] == "top"]
    summary.update(full_ms=out["full"]["ms"], stages_sum_ms=sum(top) if top else None,
                   budget_10hz=out["full"]["ms"] / BUDGET_MS)
    return {"stages": out, "summary": summary}


def run_closure(eng: Slam, reps: int, cuda: bool) -> dict:
    """One automatic closure at the full bank: its stall (the driver's
    `_drain`, armed apart) and its stages, R times. solve_pose_graph runs
    inside _correct_and_rebuild and is measured there too (its launches
    count in both ranges); its syncs are counted in a run of their own (a
    sync count cannot hold another open inside it)."""
    stall, st = [], Stages("time", cuda, nested=True)
    outer = [(slam_pipeline, "align_loop", "align_loop"),
             (slam_pipeline, "_correct_and_rebuild", "_correct_and_rebuild")]
    inner = [(slam_pipeline, "solve_pose_graph", "solve_pose_graph")]

    def closed(stages=None, targets=()):
        eng.arm()
        with (patched(stages, targets) if stages else contextlib.nullcontext()):
            eng.close()
        if stages:
            stages.end_step()

    for _ in range(reps):
        eng.arm()
        stall.append(timed_call(eng.close, cuda)[1])
        closed(st, outer + inner)
    out = {"stall": _row(stall, reps, reps, "step")}
    for k, v in st.values.items():
        out[k] = _row(v, st.calls[k], reps, "nested" if k == "solve_pose_graph" else "top")
    if cuda:
        eng.arm()
        out["stall"]["launches"] = profiled(eng.close)[1]["launches"]
        eng.arm()
        out["stall"]["syncs"] = syncs_of(eng.close)[1]
        with profiling() as rec:
            closed(Stages("profile", cuda, nested=True), outer + inner)
        for targets in (outer, inner):
            s = Stages("syncs", cuda)
            closed(s, targets)
            for k, v in s.values.items():
                out[k]["syncs"] = v[0]
        for k in out:
            if k != "stall":
                out[k]["launches"] = rec["ranges"].get(k, 0)
    bank = eng.closure_state.bank
    return {"stages": out, "keyframes": bank.capacity, "live": int(bank.count),
            "bank_build_s": eng.bank_s,
            "edges": int(eng.closure_state.edges.count),
            "loop": [bank.capacity - 1, eng.drv._flag.read()[1]]}


@dataclasses.dataclass
class KernelCalls:
    """The kernel calls of one engine step: the bytes and flops each must
    spend, and the first call on each map (its arguments kept)."""

    work: list = dataclasses.field(default_factory=list)  # (kernel, bytes, flops)
    knn: dict = dataclasses.field(default_factory=dict)  # map config -> args
    insert: dict = dataclasses.field(default_factory=dict)

    def bounds_ms(self) -> float:
        return sum(bound(b, f)[0] for _, b, f in self.work)


def kernel_calls(eng: Engine) -> KernelCalls:
    """Run the engine step once more and record its kernel calls (KernelCalls)."""
    rec = KernelCalls()
    real_knn, real_eigs = octant_knn.knn_octant, (gn_scan2map.sym_eig, two_step.sym_eig)

    def knn_spy(m, queries, qmask, k, cfg, ktab=None):
        kt = build_ktab(m) if ktab is None else ktab
        rec.work.append(("octant_knn", *knn_work(m, queries, qmask, k, cfg, kt)))
        if cfg not in rec.knn:
            rec.knn[cfg] = (hash_map.HashVoxelMap(*(t.clone() for t in m)), queries.clone(),
                            qmask.clone(), k, cfg, kt.clone())
        return real_knn(m, queries, qmask, k, cfg, ktab=ktab)

    def eig_spy(real):
        def spy(a):
            rec.work.append(("sym_eig", *eig_work(a)))
            return real(a)
        return spy

    def insert_spy(real):
        def spy(m, xyz, mask, cfg, *a, **kw):
            rec.work.append(("insert_with_stats", *insert_work(m, xyz, mask)))
            if cfg not in rec.insert:
                rec.insert[cfg] = (hash_map.HashVoxelMap(*(t.clone() for t in m)), xyz.clone(),
                                   mask.clone(), cfg)
            return real(m, xyz, mask, cfg, *a, **kw)
        return spy

    saved = [(mod, "insert_with_stats", mod.insert_with_stats) for mod in eng.kernel_modules]
    octant_knn.knn_octant = knn_spy
    gn_scan2map.sym_eig, two_step.sym_eig = (eig_spy(f) for f in real_eigs)
    for mod, name, fn in saved:
        setattr(mod, name, insert_spy(fn))
    try:
        eng.step()
    finally:
        octant_knn.knn_octant = real_knn
        gn_scan2map.sym_eig, two_step.sym_eig = real_eigs
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    return rec


# --------------------------------------------------------------------------
# c. kernel rooflines and the ablation


def _roofline(kernel: str, shape: str, n_bytes: int, flops: int, cuda: bool, fn=None,
              plain=None, library=None, **extra) -> dict:
    """One row: the kernel's device ms (card only), its bound and share, its
    plain version's and the library call's device ms."""
    b_ms, b_by = bound(n_bytes, flops)
    row = {"kernel": kernel, "shape": shape, "bytes": n_bytes, "flops": flops,
           "bound_ms": b_ms, "bound_by": b_by, "ms": None, "share": None, "plain_ms": None,
           "library_ms": None, **extra}
    if cuda:
        row["ms"] = device_ms(fn)
        row["share"] = share(b_ms, row["ms"], f"{kernel} {shape}")
        row["plain_ms"] = device_ms(plain) if plain else None
        row["library_ms"] = device_ms(library) if library else None
    return row


def knn_rows(path: str, calls: KernelCalls, cuda: bool) -> list:
    """The octant KNN at each of a path's maps, beside its glue: the packed
    keys and probe bases (octant_probe_keys, the plain version's first
    step; the kernel hashes in its own threads), nn/knn.knn around the
    launch, and the packed-key index the solve builds once a map
    (build_ktab)."""
    rows = []
    for m, q, qm, k, cfg, kt in calls.knn.values():
        n_bytes, flops = knn_work(m, q, qm, k, cfg, kt)
        row = _roofline("octant_knn", f"{path} {q.shape[0]}q x {m.n_rows} rows k={k}", n_bytes,
                        flops, cuda, fn=lambda: octant_knn._launch(m, q, qm, k, cfg, kt),
                        plain=lambda: octant_knn.knn_octant_ref(m, q, qm, k, cfg, kt),
                        live=int(qm.sum()))
        if cuda:
            row["knn_call_ms"] = device_ms(lambda: knn_mod.knn(m, q, qm, k, cfg, ktab=kt))
            row["probe_keys_ms"] = device_ms(lambda: octant_knn.octant_probe_keys(q, cfg))
            row["build_ktab_ms"] = device_ms(lambda: build_ktab(m))
        rows.append(row)
    return rows


def claim_rounds(m, xyz, mask, cfg) -> int:
    """The claim rounds one insert of these points runs (eagerly, to its
    last conflict): hash_map.lookup runs once a round and once after."""
    real, n = hash_map.lookup, [0]

    def counting(*a, **kw):
        n[0] += 1
        return real(*a, **kw)

    hash_map.lookup = counting
    try:
        hash_map.insert_with_stats(m, xyz, mask, cfg)
    finally:
        hash_map.lookup = real
    return n[0] - 1


def insert_rows(path: str, calls: KernelCalls, cuda: bool) -> list:
    """insert_with_stats at each of a path's maps, split into
    lookup_dedup's claim rounds and the rest (block coordinates and the
    first-wins sub-voxel scatter into the new map), with its rounds."""
    rows = []
    for m, xyz, mask, cfg in calls.insert.values():
        bc, _ = hash_map.block_coords(xyz, cfg)
        row = _roofline("insert_with_stats", f"{path} {xyz.shape[0]} points x {m.n_rows} rows",
                        *insert_work(m, xyz, mask), cuda,
                        fn=lambda: hash_map.insert_with_stats(m, xyz, mask, cfg),
                        claim_rounds=claim_rounds(m, xyz, mask, cfg))
        if cuda:
            row["claim_ms"] = device_ms(lambda: hash_map.lookup_dedup(m.keys, bc, mask, cfg,
                                                                       claim=True))
            row["scatter_ms"] = (row["ms"] - row["claim_ms"]
                                 if row["ms"] is not None and row["claim_ms"] is not None
                                 else None)
            row["call_ms"] = cuda_ms(lambda: hash_map.insert_with_stats(m, xyz, mask, cfg))
        rows.append(row)
    return rows


def eig_rows(device, cuda: bool) -> list:
    """sym_eig on one 6x6 (the GN step's call) and on 4096 of them, beside
    torch.linalg.eigh (its plain version and the library call)."""
    rng = np.random.default_rng(SEED)
    J = rng.normal(size=(4096, 18, 6)) * rng.uniform(1, 300, (4096, 1, 1))
    a = torch.from_numpy((J.transpose(0, 2, 1) @ J).astype(np.float32)).to(device)
    rows = []
    for label, x in (("1x6x6", a[0]), ("4096x6x6", a)):
        rows.append(_roofline("sym_eig", label, *eig_work(x), cuda,
                              fn=lambda: sym_eig.sym_eig(x), plain=lambda: sym_eig.sym_eig_ref(x),
                              library=lambda: torch.linalg.eigh(x)))
    return rows


def probe_rows(device, cuda: bool) -> list:
    """scale2 at stage0's 256x128 and row_gather_sum at stage1's defaults
    (512 rows of 768 B gathered from 4096), beside `x * 2` and
    `src[idx].sum(1)`."""
    x = torch.ones((256, 128), dtype=torch.float32, device=device)
    src, idx = probe.probe_inputs(device=device)
    return [_roofline("scale2", "256x128", x.numel() * 8, x.numel(), cuda,
                      fn=lambda: probe.scale2(x), plain=lambda: probe.scale2_ref(x),
                      library=lambda: x * 2),
            _roofline("row_gather_sum", f"{idx.numel()} of {src.shape[0]} rows",
                      probe.gather_bytes(idx, src), idx.numel() * src.shape[1] * 3, cuda,
                      fn=lambda: probe.row_gather_sum(idx, src),
                      plain=lambda: probe.row_gather_sum_ref(idx, src),
                      library=lambda: src[idx.long()].sum(1))]


# --------------------------------------------------------------------------
# the run and its files


class Inputs:
    """The engines and their inputs, made once and shared: the odom arc's
    scans (odom, chunk, slam) and the circle's sweeps (lio, liosam, livox)."""

    def __init__(self, device, n_scans: int):
        self.device, self.n = device, n_scans
        self.init_frames = min(LIVOX_INIT_FRAMES, max(2, n_scans))
        self._arc = self._sweeps = None
        self.engines: dict = {}

    def arc(self):
        if self._arc is None:
            self._arc = arc_scans(self.n + CHUNK, self.device)
        return self._arc

    def sweeps(self):
        if self._sweeps is None:
            self._sweeps = circle_sweeps(max(self.n, self.init_frames) + 1, self.device)
        return self._sweeps

    def engine(self, name: str) -> Engine:
        if name not in self.engines:
            n, dev = self.n, self.device
            if name == "odom":
                scans, step = self.arc()
                eng = Odom(scans, step, n, dev)
            elif name == "chunk":
                eng = Chunk(self.engine("odom"), self.arc()[0][n:n + CHUNK])
            elif name == "slam":
                eng = Slam(*self.arc(), n, dev)
            elif name == "lio":
                eng = Lio(self.sweeps(), n, dev)
            elif name == "liosam":
                eng = LioSam(self.sweeps(), n, dev)
            else:
                eng = Livox(self.sweeps(), max(n, self.init_frames), self.init_frames, dev)
            self.engines[name] = eng
        return self.engines[name]


def profile(engines, n_scans: int = 4, reps: int = 5, device="cuda") -> dict:
    """Profile `engines` (names of ENGINES, and "kernels") on `device`: the
    payload SOL_<tag>.json holds."""
    device = torch.device(device)
    cuda = on_card(device)
    hw = card_info(device)
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    inputs = Inputs(device, n_scans)
    stages, summary, calls = {}, {}, {}
    rooflines = None
    if "kernels" in engines:  # first: late in a process the profiler was seen to lose work
        t0 = time.perf_counter()
        rooflines = []
        for path in ("odom", "lio", "livox"):
            calls[path] = kernel_calls(inputs.engine(path))
            rooflines += knn_rows(path, calls[path], cuda)
        for path in ("odom", "lio"):
            rooflines += insert_rows(path, calls[path], cuda)
        rooflines += eig_rows(device, cuda) + probe_rows(device, cuda)
        _log(f"kernels: {time.perf_counter() - t0:.1f} s")
    for name in (e for e in ENGINES if e in engines):
        t0 = time.perf_counter()
        eng = inputs.engine(name)
        res = run_stages(eng, reps, cuda)
        stages[name], summary[name] = res["stages"], res["summary"]
        if name == "chunk":  # a step is CHUNK scans
            ms = res["stages"]["full"]["ms"] / CHUNK
            summary[name].update(scans=CHUNK, capture_s=eng.capture_s, ms_per_scan=ms,
                                 budget_10hz=ms / BUDGET_MS,
                                 sequential_ms_per_scan=res["stages"]["process_scan"]["ms"]
                                 / CHUNK)
        else:
            if name not in calls:
                calls[name] = kernel_calls(eng)
            summary[name]["bounds_ms"] = calls[name].bounds_ms()
            summary[name]["kernel_calls"] = dict(collections.Counter(k for k, _, _ in
                                                                     calls[name].work))
        if name == "slam":
            summary[name]["closure"] = run_closure(eng, reps, cuda)
        _log(f"{name}: {time.perf_counter() - t0:.1f} s")
    clock = "cuda events" if cuda else "host clock (CPU)"
    return {
        "engines_ms_per_scan": {e: {k: v["ms"] for k, v in st.items()} for e, st in
                                stages.items()},
        "stages": stages,
        "kernel_rooflines": rooflines,
        "engine_summary": summary,
        "hw": hw,
        "scan_scale": f"{RINGS}x{WIDTH}",
        "timing": {"clock": clock, "reps": reps, "warm_scans": n_scans,
                   "stat": "median of R synchronized calls, spread [min, max]",
                   "launches": "launch calls of one more run under torch.profiler, each once, "
                               "linked to their kernels by correlation id (card only)",
                   "syncs": "sync debug mode in one more run apart (card only)"},
    }


def _log(msg: str) -> None:
    print(f"profile_engines: {msg}", file=sys.stderr, flush=True)


def _fmt(x) -> str:
    if x is None:
        return "not measured"
    if isinstance(x, float):
        return f"{x:.4g}"
    return str(x)


def markdown(payload: dict, tag: str) -> str:
    hw = payload["hw"]
    where = (f"{hw['name']}, power limit {hw['power_limit']}" if hw["device"] == "cuda"
             else "the CPU (host clock; no device number)")
    lines = [f"# SOL_{tag}: stage split and kernel bounds of the PyTorch port", "",
             f"Measured on {where}, scans of {payload['scan_scale']}, by "
             "`python -m agi_lidar_slam_torch.tools.profile_engines`. "
             f"Times: {payload['timing']['clock']}, {payload['timing']['stat']}. "
             "Top-level stages are the step's own calls; sub-stages are timed apart.", ""]
    for eng, st in payload["stages"].items():
        s = payload["engine_summary"][eng]
        lines += [f"## {eng}", "", "| stage | level | ms | spread ms | calls | launches | syncs |",
                  "|---|---|---|---|---|---|---|"]
        lines += [f"| {k} | {v['level']} | {_fmt(v['ms'])} | {_fmt(v['spread_ms'][0])}-"
                  f"{_fmt(v['spread_ms'][1])} | {v['calls']:g} | {_fmt(v['launches'])} | "
                  f"{_fmt(v['syncs'])} |" for k, v in st.items()]
        lines += ["", ", ".join(f"{k} {_fmt(v)}" for k, v in s.items()
                                if not isinstance(v, dict)), ""]
        if "closure" in s:
            c = s["closure"]
            lines += [f"Closure at a full bank ({c['live']} of {c['keyframes']} keyframes, "
                      f"{c['edges']} edges, loop {c['loop'][0]} -> {c['loop'][1]}; the bank "
                      f"built in {_fmt(c['bank_build_s'])} s):", "",
                      "| stage | ms | spread ms | launches | syncs |", "|---|---|---|---|---|"]
            lines += [f"| {k} | {_fmt(v['ms'])} | {_fmt(v['spread_ms'][0])}-"
                      f"{_fmt(v['spread_ms'][1])} | {_fmt(v['launches'])} | {_fmt(v['syncs'])} |"
                      for k, v in c["stages"].items()]
            lines.append("")
    if payload["kernel_rooflines"] is not None:
        lines += ["## Kernels", "", "Device ms (torch.profiler); bound from the published "
                  "peaks; `more`: the glue around the octant launch, the insert's claim rounds "
                  "and its split, all device ms but `call_ms` (CUDA events around the call).", "",
                  "| kernel | shape | ms | bound ms | by | share | plain ms | library ms | more |",
                  "|---|---|---|---|---|---|---|---|---|"]
        base = {"kernel", "shape", "ms", "bound_ms", "bound_by", "share", "plain_ms",
                "library_ms", "bytes", "flops"}
        lines += [f"| {r['kernel']} | {r['shape']} | {_fmt(r['ms'])} | {_fmt(r['bound_ms'])} | "
                  f"{r['bound_by']} | {_fmt(r['share'])} | {_fmt(r['plain_ms'])} | "
                  f"{_fmt(r['library_ms'])} | "
                  + ", ".join(f"{k} {_fmt(v)}" for k, v in r.items() if k not in base) + " |"
                  for r in payload["kernel_rooflines"]]
    return "\n".join(lines) + "\n"


def write(payload: dict, out: Path, tag: str) -> tuple[Path, Path]:
    out.mkdir(parents=True, exist_ok=True)
    js, md = out / f"SOL_{tag}.json", out / f"SOL_{tag}.md"
    js.write_text(json.dumps(payload, indent=1) + "\n")
    md.write_text(markdown(payload, tag))
    return js, md


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m agi_lidar_slam_torch.tools.profile_engines",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--engine", default="all", choices=(*ENGINES, "kernels", "all"))
    ap.add_argument("--scans", type=int, default=4,
                    help="scans each engine runs before the profiled one")
    ap.add_argument("--reps", type=int, default=5, help="timed calls of each stage")
    ap.add_argument("--out", type=Path,
                    default=Path(__file__).resolve().parents[2] / "chiprun_out")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("tag", nargs="?", default="port")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("profile_engines: no CUDA device (pass --device cpu for host-clock times)",
              file=sys.stderr)
        return 1
    if args.scans < 1 or args.reps < 1:
        ap.error("--scans and --reps take at least 1")
    engines = (*ENGINES, "kernels") if args.engine == "all" else (args.engine,)
    payload = profile(engines, args.scans, args.reps, args.device)
    js, md = write(payload, args.out, args.tag)
    print(f"profile_engines: wrote {js} and {md}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
