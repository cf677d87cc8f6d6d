"""What the benchmark reads from a torch.profiler trace: plain events, host
ranges, device work linked to the host call that launched it, busy time and
idle gaps. The per-layer readers (benchmark/metrics/) read what this module
finds; it runs on lists of `Event`, so its arithmetic is tested on small
synthetic traces.

Device work (kernels, copies, fills) is linked to the host event that put it
on the card by correlation id, as the program's stage profiler does
(agi_lidar_slam_torch/tools/profile_engines.py `launch_record` at commit
88e7c49, copied here in spirit, not imported); a host range is a
`record_function` range whose name starts with PREFIX, and a piece of device
work belongs to every range that holds the host time of its launch.
"""

from __future__ import annotations

import bisect
import collections
from typing import NamedTuple

PREFIX = "bench::"
COPIES = ("Memcpy", "Memset")  # device work that is not a kernel
NAME_CHARS = 160  # a device op's name in the breakdown is cut to this


class Event(NamedTuple):
    name: str
    on_device: bool  # device work (or a device-side annotation)
    annotation: bool  # a record_function range (host or device side)
    start_ns: int
    end_ns: int
    corr: int  # correlation id, 0 where none


def from_kineto(events) -> list[Event]:
    """Plain events from torch.profiler's raw kineto events."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    return [Event(e.name(), e.device_type() == cuda, bool(e.is_user_annotation()),
                  int(e.start_ns()), int(e.end_ns()), int(e.correlation_id()))
            for e in events]


def host_ranges(events: list[Event], prefix: str = PREFIX) -> dict[str, list[tuple[int, int]]]:
    """Host ranges by name (the prefix taken off), each list sorted by start."""
    out: dict = collections.defaultdict(list)
    for e in events:
        if not e.on_device and e.name.startswith(prefix):
            out[e.name[len(prefix):]].append((e.start_ns, e.end_ns))
    for v in out.values():
        v.sort()
    return dict(out)


def device_work(events: list[Event]) -> list[Event]:
    return [e for e in events if e.on_device and not e.annotation]


def is_kernel(e: Event) -> bool:
    return not e.name.startswith(COPIES)


def is_launch(e: Event) -> bool:
    """A host call of a CUDA API (cudaLaunchKernel, cudaGraphLaunch,
    cudaMemcpyAsync, cuLaunchKernel, ...): what puts device work on the
    card. The profiler's operator events (aten::...) carry ids of
    their own that can equal a runtime call's correlation id, so they are
    never taken for a launch."""
    return not e.on_device and not e.annotation and e.corr != 0 and e.name.startswith("cu")


def launch_times(events: list[Event]) -> dict[int, int]:
    """Correlation id -> host start of the call that made that device work."""
    return {e.corr: e.start_ns for e in events if is_launch(e)}


def _inside(spans: list[tuple[int, int]], t: int) -> bool:
    """Whether t lies in one of the sorted, disjoint spans."""
    i = bisect.bisect_right(spans, (t, float("inf"))) - 1
    return i >= 0 and spans[i][0] <= t <= spans[i][1]


def device_ms_by_range(events: list[Event], prefix: str = PREFIX) -> dict[str, float]:
    """Device ms of the work launched inside each host range name (ranges of
    one name are disjoint; a range nested in another counts in both)."""
    ranges = host_ranges(events, prefix)
    starts = launch_times(events)
    out = {name: 0.0 for name in ranges}
    for e in device_work(events):
        t = starts.get(e.corr)
        if t is None:
            continue
        for name, spans in ranges.items():
            if _inside(spans, t):
                out[name] += (e.end_ns - e.start_ns) / 1e6
    return out


def union(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    out: list = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


class Window(NamedTuple):
    window_s: float  # the traced window's length
    busy_s: float  # union of device work inside it
    kernels_in_calls: int  # kernels launched inside the chunk calls
    kernels_unlinked: int  # kernels in the window with no host launch found
    scans: int  # scans handed in inside the window
    device_ops: list  # [[name, seconds], ...] the 10 that took most time
    idle_gaps: list  # [[what the host did, seconds], ...] the 10 longest


def window_stats(events: list[Event], scans: int, window: str = "window",
                 call: str = "call") -> Window:
    """Busy time, kernels and the breakdown of the host range `window`
    (one), in which `scans` scans were handed in through `call` ranges."""
    ranges = host_ranges(events)
    (ws, we), = ranges[window]
    calls = ranges.get(call, [])
    starts = launch_times(events)
    work = [e for e in device_work(events) if e.end_ns > ws and e.start_ns < we]
    busy = union([(max(e.start_ns, ws), min(e.end_ns, we)) for e in work])
    kernels = [e for e in work if is_kernel(e)]
    in_calls = sum(1 for e in kernels if e.corr in starts and _inside(calls, starts[e.corr]))
    unlinked = sum(1 for e in kernels if e.corr not in starts)
    by_name: collections.Counter = collections.Counter()
    for e in work:
        by_name[e.name] += (min(e.end_ns, we) - max(e.start_ns, ws)) / 1e9
    edges = [ws] + [t for iv in busy for t in iv] + [we]
    gaps = sorted(((b - a, a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a),
                  reverse=True)[:10]
    return Window((we - ws) / 1e9, sum(b - a for a, b in busy) / 1e9, in_calls, unlinked, scans,
                  [[n[:NAME_CHARS], s] for n, s in by_name.most_common(10)],
                  [[what_host_did(events, (a + b) // 2), d / 1e9] for d, a, b in gaps])


def what_host_did(events: list[Event], t: int) -> str:
    """The innermost benchmark range and the innermost other host event
    that hold host time t, as "range/event"."""
    rng, op = "harness", "python"
    best_r = best_o = None
    for e in events:
        if e.on_device or not e.start_ns <= t <= e.end_ns:
            continue
        d = e.end_ns - e.start_ns
        if e.name.startswith(PREFIX):
            if best_r is None or d < best_r:
                best_r, rng = d, e.name[len(PREFIX):]
        elif best_o is None or d < best_o:
            best_o, op = d, e.name
    return f"{rng}/{op}"
