"""The traced run's two readings, after the measured window.

1. A profiled sub-window: the same closed loop as the window, for a few
   calls, under torch.profiler, with host ranges around each call, each
   pose copy and each pose read. It gives the device's busy time, the
   kernels a scan and the breakdown (tracing.window_stats).

2. A staged pass: a few of the cell's own sweeps, one by one, through the
   adapter's per-sweep call (its STAGED_CALL; for the odometry engine the
   scan body that the chunk graph captures), eagerly, with a host
   range around each stage. The stages are the program's own functions,
   which the body looks up at call time; each per-layer reader names the
   ones it needs (its STAGES, and CALLS for functions whose every call's
   arguments it needs), and a function the harness cannot find leaves that
   reader nothing to read. Where the cell's call is captured into a CUDA
   graph, the pass holds the program's capture flag for that call true (the
   adapter's CAPTURE_FLAGS), so that the map's claim rounds run to their
   bound as they do in the graph and the pass launches the graph's kernels;
   where that flag is gone the pass does not run, and no staged metric is
   read. A cell whose call runs eagerly is staged as it runs. Device work is
   given to the stages by correlation id (tracing.device_ms_by_range).
"""

from __future__ import annotations

import dataclasses
import importlib

import torch

from benchmark import tracing


@dataclasses.dataclass
class Trace:
    """What the per-layer readers read."""

    cell: str
    chunk: int
    call_ms: list  # host ms of each call in the measured window
    window: tracing.Window | None = None  # the profiled sub-window
    stage_ms: dict = dataclasses.field(default_factory=dict)  # device ms by stage label
    staged_scans: int = 0  # scans of the staged pass
    calls: dict = dataclasses.field(default_factory=dict)  # label -> [(args, kwargs)]
    call_device_ms: dict = dataclasses.field(default_factory=dict)  # label -> device ms
    missing: dict = dataclasses.field(default_factory=dict)  # label -> why not read
    device_name: str = ""
    loop_busy_s: float | None = None  # summed device spans of the window's calls
    loop_span_s: float | None = None  # from the first call's start to the last one's end

    def why_missing(self) -> str:
        if self.missing:
            return "; ".join(f"{k}: {v}" for k, v in self.missing.items())
        return "no device trace of its layer in this run"


def _ranged(name: str, fn):
    def wrapper(*a, **kw):
        with torch.profiler.record_function(tracing.PREFIX + name):
            return fn(*a, **kw)
    return wrapper


def _recorded(name: str, fn, record: list):
    def wrapper(*a, **kw):
        record.append((a, kw))
        with torch.profiler.record_function(tracing.PREFIX + name):
            return fn(*a, **kw)
    return wrapper


def _profile():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def profile_window(feed, state, n_chunks: int, ahead: int, tr: Trace):
    """Run n_chunks more of the closed loop under the profiler; fills
    tr.window and returns the state after them."""
    pending = []
    torch.cuda.synchronize()
    with _profile() as prof:
        with torch.profiler.record_function(tracing.PREFIX + "window"):
            for _ in range(n_chunks):
                with torch.profiler.record_function(tracing.PREFIX + "call"):
                    _, state, res, _ = feed.hand_in(state)
                with torch.profiler.record_function(tracing.PREFIX + "poses"):
                    pending.append(feed.send_poses(res))
                while len(pending) > ahead:
                    with torch.profiler.record_function(tracing.PREFIX + "read"):
                        feed.receive(pending.pop(0))
            while pending:
                with torch.profiler.record_function(tracing.PREFIX + "read"):
                    feed.receive(pending.pop(0))
        torch.cuda.synchronize()
    events = tracing.from_kineto(prof.profiler.kineto_results.events())
    tr.window = tracing.window_stats(events, n_chunks * feed.C)
    return state


def _targets(readers: dict, key: str) -> list:
    out = []
    for mod in readers.values():
        for t in getattr(mod, key, ()):
            if t not in out:
                out.append(t)
    return out


def staged_pass(feed, state, n_scans: int, readers: dict, tr: Trace, cuda: bool) -> None:
    """The staged pass, through the feed's adapter and program, over the
    n_scans sweeps that follow the loop's last call; fills tr.stage_ms,
    tr.calls, tr.call_device_ms, tr.staged_scans, or, where the capture flag
    of the cell's call is gone, only tr.missing."""
    saved = []

    def wrap(label: str, modname: str, attr: str, make):
        try:
            mod = importlib.import_module(modname)
        except ImportError:
            mod = None
        fn = getattr(mod, attr, None)
        if fn is None:
            tr.missing[label] = f"{modname}.{attr} not found"
            return
        saved.append((mod, attr, fn))
        setattr(mod, attr, make(fn))

    adapter, engine, cfg = feed.adapter, feed.engine, feed.cfg
    start = (feed.k * feed.C) % feed.lap.n
    entry = adapter.STAGED_CALL
    sweeps = [adapter.inputs(engine, feed.lap, (start + i) % feed.lap.n, 1, entry)
              for i in range(n_scans)]

    def run_scans():
        s = state
        for sweep in sweeps:
            s, _ = getattr(engine, adapter.CALLS[entry])(s, sweep, cfg)
        return s

    flag = adapter.CAPTURE_FLAGS.get(feed.call)
    if flag is not None:
        modname, attr = flag.split(":")
        wrap("capture_flag", modname, attr, lambda fn: (lambda t: t.is_cuda))
        if "capture_flag" in tr.missing:
            # eager claim rounds would stop early: not the graph's kernels
            return
    try:
        run_scans()  # unprofiled and unwrapped: what a first eager call sets up
        for label, modname, attr in _targets(readers, "STAGES"):
            wrap(label, modname, attr, lambda fn, lb=label: _ranged("stage::" + lb, fn))
        for label, modname, attr in _targets(readers, "CALLS"):
            record = tr.calls.setdefault(label, [])
            wrap(label, modname, attr,
                 lambda fn, lb=label, rec=record: _recorded("calls::" + lb, fn, rec))
        if not cuda:
            run_scans()
            tr.staged_scans = n_scans
            return
        tr.device_name = torch.cuda.get_device_name(0)
        torch.cuda.synchronize()
        with _profile() as prof:
            run_scans()
            torch.cuda.synchronize()
    finally:
        for mod, attr, fn in reversed(saved):
            setattr(mod, attr, fn)
    tr.staged_scans = n_scans
    by_range = tracing.device_ms_by_range(tracing.from_kineto(prof.profiler.kineto_results.events()))
    for name, ms in by_range.items():
        if name.startswith("stage::"):
            tr.stage_ms[name[len("stage::"):]] = ms
        elif name.startswith("calls::"):
            tr.call_device_ms[name[len("calls::"):]] = ms
