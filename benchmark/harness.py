"""The benchmark of the PyTorch and CUDA port: one cell, one seed, one run.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell is made of is found by name, from BENCHMARK.json at the
root of the checkout:

  benchmark/workloads/<cell>.json    the cell's run: its config and traffic
                                     (as BENCHMARK.json names them), sweeps
                                     checked, the traced sub-window, limits
  <config's file>                    benchmark/configs/<config>.json: the
                                     engine's adapter, the program's engine
                                     module, its preset constructor and the
                                     preset's values, the sensor
  benchmark/engines/<adapter>.py     what the harness knows of one engine
                                     (below), and its plain reference
  benchmark/traffic/<traffic>.json   the scene and the feed, read by the one
                                     generator, benchmark/traffic/generator.py
  benchmark/metrics/<metric>.py      one reader a per-layer metric: read(trace)

An adapter gives
  program(config)                    (the engine module, its config), held to
                                     the configuration file's values
  initial_state(engine, cfg, lap, device)  the engine moving at the lap's start
  CALLS                              {call: the engine's function}, a call
                                     being what a traffic's feed names
  inputs(engine, lap, start, n, call)  what `call` takes for the lap's sweeps
                                     start .. start + n - 1 (the IMU samples
                                     of those sweeps too, for an IMU engine)
  poses(result)                      (q (n, 4), t (n, 3)) of a call's sweeps
  Checker(config, device)            the plain reference: initial_state(lap),
                                     as_reference(program state),
                                     step(reference state, lap, start, n,
                                     program poses, program state after or
                                     None) -> reference state after,
                                     numbers(), control(call)
  STAGED_CALL, CAPTURE_FLAGS         the staged pass's per-sweep call, and the
                                     capture flag of each call captured into a
                                     CUDA graph (benchmark/staged.py)
  capacities(config, lap)            optional: a report for the traced run

A run makes one lap of sweeps on the card from the seed, starts the
engine moving at the lap's speed, drives the warm-up calls through the
feed's call (a graphed call captures its CUDA graph at the first), runs the
same loop unmeasured for PRELOAD_S (the pre-load, which setup_s leaves out),
then measures for `seconds`: a closed loop that hands in the lap's sweeps,
`chunk` a call, in turn, lap after lap, keeping `ahead` calls in flight, and
reads each call's poses back to the host. After the window it checks against
the plain reference (benchmark/check.py, the adapter's Checker) the run's
first calls, from the reference's own start, and a seeded sample of the
window's calls. With --trace 1 it also times every call of the window with
CUDA events, profiles a short sub-window and a staged pass
(benchmark/staged.py), and reports the per-layer metrics in place of the
end-to-end ones.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import os
import random
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, NamedTuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from benchmark import caps, check, staged
from benchmark.traffic.generator import make_lap

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "agi_lidar_slam_tpu")
# build and kernel caches of the program, at fixed paths in the checkout
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": "benchmark/_cache/torch_extensions",
              "TRITON_CACHE_DIR": "benchmark/_cache/triton"}
# seconds of the closed loop run unmeasured between the warm-up and the
# window: on the card the chunk graph runs about a fifth slower for the first
# seconds to tens of seconds of a process (PERF.md, "Two speeds of the
# card"), and the window measures the steady pace that follows. setup_s
# leaves the pre-load out; the run prints its length and pace.
PRELOAD_S = 40.0


class Cell(NamedTuple):
    name: str
    workload: dict  # benchmark/workloads/<cell>.json
    config: dict  # the configuration's file
    traffic: dict  # benchmark/traffic/<traffic>.json
    end_to_end: list  # BENCHMARK.json's end-to-end metrics this cell reports
    per_layer: list  # and its per-layer metrics
    chips: int
    root: Path


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of root/BENCHMARK.json with its files."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    entry = {w["name"]: w for w in spec["workloads"]}.get(name)
    if entry is None:
        raise ValueError(f"no workload {name!r} in BENCHMARK.json")
    workload = json.loads((root / "benchmark" / "workloads" / f"{name}.json").read_text())
    for key in ("config", "traffic"):
        if workload[key] != entry[key]:
            raise ValueError(f"{name}: the workload file's {key} {workload[key]!r} is not "
                             f"BENCHMARK.json's {entry[key]!r}")
    cfg_file = {c["name"]: c for c in spec["configs"]}[entry["config"]]["file"]
    config = json.loads((root / cfg_file).read_text())
    traffic = json.loads((root / "benchmark" / "traffic" / f"{entry['traffic']}.json").read_text())
    e2e = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in e2e_names)]
    return Cell(name, workload, config, traffic, e2e, per_layer, int(entry["chips"]), root)


def load_reader(cell: Cell, metric: str):
    """The module benchmark/metrics/<metric>.py, which reads one per-layer
    metric from a `staged.Trace` (`read(trace)`, None where it finds
    nothing), and may declare the program's functions it needs wrapped in the
    staged pass (STAGES) or recorded call by call (CALLS)."""
    path = cell.root / "benchmark" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_adapters: dict = {}  # path -> module: one module an adapter file in a process


def load_adapter(cell: Cell):
    """The module benchmark/engines/<adapter>.py that the cell's
    configuration names under `adapter`."""
    path = cell.root / "benchmark" / "engines" / f"{cell.config['adapter']}.py"
    if path not in _adapters:
        spec = importlib.util.spec_from_file_location(
            "benchmark_engine_" + cell.config["adapter"].replace(".", "_").replace("-", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _adapters[path] = mod
    return _adapters[path]


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_info() -> dict:
    name = torch.cuda.get_device_name(0)
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
                              "-i", "0"], capture_output=True, text=True, timeout=30)
        power = out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not read"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        power = "not read"
    return {"platform": "gpu", "kind": name, "count": 1, "power_limit": power}


def card_state() -> str:
    """nvidia-smi's reading of the card's clocks, power, temperature and
    throttle reasons, as one line (for the run's log; it sets nothing)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw,"
                              "temperature.gpu,clocks_throttle_reasons.active",
                              "--format=csv,noheader", "-i", "0"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read ({e})"


def note(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


class Chunk(NamedTuple):
    index: int  # call number since the engine started
    start: int  # first sweep of the call in the lap tensors
    state_in: object  # the program state handed in (None where not kept)
    state_out: object  # and the one it gave back (None where not kept)
    poses: tuple  # (q, t) of the call's sweeps


class Feed:
    """Hands the lap's sweeps to the program's call, `chunk` a call, in turn
    and reads their poses back: on the card through pinned buffers and
    events, so that reading call k waits for call k alone."""

    def __init__(self, lap, adapter, engine, cfg, step, call: str, chunk: int, device):
        self.lap, self.adapter, self.engine, self.cfg = lap, adapter, engine, cfg
        self.step, self.call, self.C = step, call, chunk
        self.cuda = device.type == "cuda"
        self.ring = [torch.empty((chunk, 7), pin_memory=self.cuda) for _ in range(4)]
        self.k = 0

    def hand_in(self, state):
        """Hand in the next call's sweeps: (their start, new state, result,
        host ms of the call)."""
        start = (self.k * self.C) % self.lap.n
        t0 = time.perf_counter()
        new_state, res = self.step(state, self.adapter.inputs(self.engine, self.lap, start,
                                                              self.C, self.call), self.cfg)
        ms = (time.perf_counter() - t0) * 1e3
        self.k += 1
        return start, new_state, res, ms

    def send_poses(self, res):
        """Start the copy of the call's poses to the host; returns a handle."""
        buf = self.ring[self.k % len(self.ring)]
        q, t = self.adapter.poses(res)
        buf.copy_(torch.cat([t, q], dim=-1), non_blocking=self.cuda)
        if not self.cuda:
            return buf, None
        ev = torch.cuda.Event()
        ev.record()
        return buf, ev

    @staticmethod
    def receive(handle) -> np.ndarray:
        buf, ev = handle
        if ev is not None:
            ev.synchronize()
        return buf.numpy().copy()


def sample_instants(seed: int, n: int) -> list[float]:
    """n instants of the window, as shares of it, drawn from the seed."""
    rng = random.Random(seed)
    return sorted(rng.random() for _ in range(n))


def percentile(values: list[float], q: float) -> float:
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def run(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float,
        step: Callable | None = None, sensor: dict | None = None) -> dict:
    """One run of `cell`; returns the result line's object (with `checks`,
    each compared number beside its limit). `step` replaces the program's
    call and `sensor` the configuration's sensor (the tests use both: to
    break the timed path underneath, and to run at a CPU's size)."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    adapter = load_adapter(cell)
    engine, cfg = adapter.program(cell.config)
    scene, feed_cfg = cell.traffic["scene"], cell.traffic["feed"]
    call = feed_cfg["call"]
    step = step or getattr(engine, adapter.CALLS[call])
    sensor = sensor or cell.config["sensor"]
    C, ahead = int(feed_cfg["chunk"]), int(feed_cfg["ahead"])
    warm = int(scene["warmup_scans"])
    own = int(cell.workload["check"]["own_start_scans"])
    if warm % C or warm < C or own % C or own < warm:
        raise ValueError(f"warm-up of {warm} and own start of {own} scans are not whole "
                         f"numbers of chunks of {C}, the second at least the first")
    readers = {m["name"]: load_reader(cell, m["name"]) for m in cell.per_layer} if trace else {}

    lap = make_lap(scene, sensor, seed, C, device)
    feed = Feed(lap, adapter, engine, cfg, step, call, C, device)
    state = adapter.initial_state(engine, cfg, lap, device)
    # the run's first chunks, which the reference follows from its own start:
    # the warm-up (each chunk's state kept) and the chunks after it up to
    # `own_start_scans` (poses kept, and the state after the last)
    first_chunks = []
    for _ in range(warm // C):
        idx = feed.k
        start, new_state, res, _ = feed.hand_in(state)
        first_chunks.append(Chunk(idx, start, state, new_state, adapter.poses(res)))
        state = new_state
    # the pre-load: the same closed loop, unmeasured, for PRELOAD_S, and at
    # least until the reference's own-start stretch is complete
    t_pre0 = time.perf_counter()
    t_pre = t_pre0 + PRELOAD_S
    pre, pre_times = [], []
    while time.perf_counter() < t_pre or len(first_chunks) * C < own:
        pre_times.append(time.perf_counter())
        idx = feed.k
        start, new_state, res, _ = feed.hand_in(state)
        if len(first_chunks) * C < own:
            last = len(first_chunks) * C + C == own
            first_chunks.append(Chunk(idx, start, None, new_state if last else None,
                                      adapter.poses(res)))
        state = new_state
        pre.append(feed.send_poses(res))
        while len(pre) > ahead:
            feed.receive(pre.pop(0))
    while pre:
        feed.receive(pre.pop(0))
    preload_s = time.perf_counter() - t_pre0
    if pre_times:
        per_s = np.bincount(((np.asarray(pre_times) - t_pre0) // 1.0).astype(int))
        note(f"pre-load: {preload_s:.3f} s, {len(pre_times)} chunks of {C}; chunks handed in, "
             f"second by second: {per_s.tolist()}")
    # room for the sampled chunks, made before the window: keeping a chunk
    # copies its states and poses into it, and allocates nothing
    n_samples = int(cell.workload["check"]["samples"])
    store = [(pytree.tree_map(torch.empty_like, state), pytree.tree_map(torch.empty_like, state),
              torch.empty((C, 4), device=device), torch.empty((C, 3), device=device))
             for _ in range(n_samples)]
    if cuda:
        torch.cuda.synchronize(device)
    gc.collect()
    gc.freeze()

    # ---- the measured window ------------------------------------------------
    instants = sample_instants(seed, n_samples)
    # with --trace 1 on the card, CUDA events on the stream before each chunk
    # call and after its pose copy give device_idle_pct over the whole window
    spans = [] if trace and cuda else None
    t_open = time.perf_counter()
    setup_s = t_open - t_start - preload_s
    t_close = t_open + seconds
    next_sample = 0
    pending = []  # (chunk index, hand-in time, pose handle)
    kept = []  # sampled chunks
    latencies = []  # ms, one a scan finished inside the window
    call_ms = []  # host ms of each chunk call inside the window
    hand_times = []  # when each chunk of the window was handed in
    attempted = failed = 0
    last = None  # (chunk index, poses) of the last chunk read

    def drain(n_left: int):
        nonlocal failed, last
        while len(pending) > n_left:
            idx, t_hand, handle = pending.pop(0)
            poses = Feed.receive(handle)
            t_done = time.perf_counter()
            failed += int((~np.isfinite(poses).all(axis=1)).sum())
            if t_done <= t_close:
                latencies.extend([(t_done - t_hand) * 1e3] * C)
            last = (idx, poses)

    while True:
        now = time.perf_counter()
        if now >= t_close:
            break
        sampled = False
        while next_sample < len(instants) and now >= t_open + instants[next_sample] * seconds:
            sampled, next_sample = True, next_sample + 1
        idx = feed.k
        if spans is not None:
            ev0 = torch.cuda.Event(enable_timing=True)
            ev0.record()
        start, new_state, res, ms = feed.hand_in(state)
        call_ms.append(ms)
        hand_times.append(now)
        pending.append((idx, now, feed.send_poses(res)))
        if spans is not None:
            ev1 = torch.cuda.Event(enable_timing=True)
            ev1.record()
            spans.append((ev0, ev1))
        attempted += C
        if sampled:
            s_in, s_out, q, tr_ = store[len(kept)]
            for dst, src in zip(pytree.tree_flatten((s_in, s_out, q, tr_))[0],
                                pytree.tree_flatten((state, new_state,
                                                     *adapter.poses(res)))[0]):
                dst.copy_(src)
            kept.append(Chunk(idx, start, s_in, s_out, (q, tr_)))
        state = new_state
        drain(ahead)
    if cuda:
        note(f"card at the window's close (sm clock, memory clock, power, temperature, "
             f"throttle reasons): {card_state()}")
    drain(0)
    gc.unfreeze()
    if cuda:
        torch.cuda.synchronize(device)
    dev_info = card_info() if cuda else {"platform": "cpu", "kind": "cpu", "count": 0,
                                         "power_limit": "none"}
    dev_info["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(device)) if cuda else 0
    finished = len(latencies)
    gaps = np.diff(np.asarray(hand_times)) * 1e3
    if len(gaps):
        slow = np.argsort(gaps)[::-1][:5]
        note(f"chunk loop: median {np.median(gaps):.4f} ms between hand-ins, mean "
             f"{gaps.mean():.4f}; longest {', '.join(f'{gaps[i]:.2f} ms after chunk {i} (call {call_ms[i]:.2f} ms)' for i in slow)}")
        per_s = np.bincount(((np.asarray(hand_times) - t_open) // 1.0).astype(int))
        note(f"chunks handed in, second by second: {per_s.tolist()}")
    note(f"window: {seconds} s, {len(hand_times)} chunks of {C} handed in, "
         f"{finished} scans finished inside it, {failed} with a non-finite pose; "
         f"setup {setup_s:.3f} s, besides the pre-load's {preload_s:.3f} s")
    if last is not None:
        j = (last[0] * C + C - 1) % lap.n
        drift = float(np.linalg.norm(last[1][-1, :3] - lap.gt.t[j].double().cpu().numpy()))
        note(f"drift: the last scan read lies {drift:.4f} m from its lap position")

    # ---- per-layer metrics (traced run) -------------------------------------
    metrics: dict = {}
    breakdown = None
    if trace:
        tr = staged.Trace(cell=cell.name, chunk=C, call_ms=call_ms)
        if spans:
            tr.loop_busy_s = sum(a.elapsed_time(b) for a, b in spans) / 1e3
            tr.loop_span_s = spans[0][0].elapsed_time(spans[-1][1]) / 1e3
            note(f"window by CUDA events: {len(spans)} chunk calls, device busy "
                 f"{tr.loop_busy_s:.6f} s of {tr.loop_span_s:.6f} s")
        if cuda:
            state = staged.profile_window(feed, state, int(cell.workload["trace"]["chunks"]),
                                          ahead, tr)
        staged.staged_pass(feed, state, int(cell.workload["trace"]["staged_scans"]), readers,
                           tr, cuda)
        note(f"staged pass: {tr.staged_scans} scans, device ms by stage "
             f"{ {k: round(v, 4) for k, v in tr.stage_ms.items()} }, by recorded call "
             f"{ {k: round(v, 4) for k, v in tr.call_device_ms.items()} }, calls "
             f"{ {k: len(v) for k, v in tr.calls.items()} }")
        for m in cell.per_layer:
            value = readers[m["name"]].read(tr)
            if value is None:
                note(f"{m['name']}: nothing to read ({tr.why_missing()}), left out")
                continue
            metrics[m["name"]] = {"value": finite(float(value)), "unit": m["unit"]}
        if tr.window is not None:
            w = tr.window
            dev_info.update(busy_s=w.busy_s, window_s=w.window_s)
            breakdown = {"device_ops": w.device_ops, "idle_gaps": w.idle_gaps}
            note(f"traced sub-window: {w.scans} scans, {w.kernels_in_calls} kernels launched in "
                 f"the chunk calls, {w.kernels_unlinked} with no launch found")
        if hasattr(adapter, "capacities"):
            note(caps.report(adapter.capacities(cell.config, lap)))
    else:
        values = {"scans_per_s": finished / seconds,
                  "latency_p95_ms": percentile(latencies, 95) if latencies else math.inf,
                  "setup_s": setup_s}
        note(f"latency_p95_ms over {finished} scans in {finished // C} chunks "
             f"(median {percentile(latencies, 50) if latencies else math.nan:.4f} ms)")
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": finite(float(values[m["name"]])), "unit": m["unit"]}

    # ---- correctness: the plain reference, after the window -----------------
    del pending
    t_check = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    checker = adapter.Checker(cell.config, device)
    ref_state = checker.initial_state(lap)
    for ch in first_chunks:
        ref_state = checker.step(ref_state, lap, ch.start, C, ch.poses, ch.state_out)
    for ch in kept:
        checker.step(checker.as_reference(ch.state_in), lap, ch.start, C, ch.poses, ch.state_out)
    numbers = checker.numbers()
    limits = cell.workload["limits"]
    correct = attempted > 0 and failed == 0 and check.is_correct(numbers, limits)
    note(f"checked the first {len(first_chunks)} chunks ({warm // C} of the warm-up) from the "
         f"reference's own start and {len(kept)} sampled window chunks from the program's "
         f"state, in {time.perf_counter() - t_check:.3f} s")

    out = {"correct": bool(correct), "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": dev_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {k: {"value": finite(numbers[k]), "limit": limits[k]} for k in check.NUMBERS}
    return out


def finite(x: float) -> float | None:
    """x, or None where it is not finite (JSON has no NaN)."""
    return x if math.isfinite(x) else None


def main(argv=None, t_start: float | None = None) -> int:
    import argparse

    t_start = time.perf_counter() if t_start is None else t_start
    p = argparse.ArgumentParser(description="Run one cell of the port's benchmark once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    for key, rel in CACHE_DIRS.items():
        os.environ[key] = str(ROOT / rel)
    os.environ["USE_FLAX"] = "0"
    cell = load_cell(a.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        note(f"no CUDA card, or fewer than the {cell.chips} this cell needs: nothing is measured")
        return 2
    torch.set_num_threads(1)
    result = run(cell, a.seed, a.seconds, bool(a.trace), torch.device("cuda", 0), t_start)
    found = forbidden_modules()
    if found:
        note(f"modules of JAX or the JAX package were loaded: {', '.join(found)}")
        return 3
    for k, v in result["checks"].items():
        note(f"check {k}: {v['value']!r} (limit {v['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0
