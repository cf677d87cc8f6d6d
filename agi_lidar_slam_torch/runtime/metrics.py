"""Structured observability: per-scan metrics to JSONL + stage timers (port
of agi_lidar_slam_tpu/runtime/metrics.py).

Every scan appends one JSON line (residual counts, convergence, timing, map
occupancy) so runs are diffable and regressions bisectable. The keys and
values are the reference's.

On the card the engine's launches return before the work is done, so
`StageTimer` synchronizes its device before it reads the clock at a stage's
end, and `MetricsWriter.log_scan` takes every device scalar of a result in
one device-to-host copy.
"""

from __future__ import annotations

import json
import time
from contextlib import contextmanager
from typing import Any, Dict, Optional

import torch


class StageTimer:
    """Wall-clock stage timing (TicToc analog); accumulates per-stage totals.
    With a cuda `device`, a stage ends when the card has finished its work."""

    def __init__(self, device=None):
        self.device = None if device is None else torch.device(device)
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self.last_ms: float = 0.0  # duration of the most recent stage (ms)

    @contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.device is not None and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1
            self.last_ms = dt * 1e3

    def summary(self) -> Dict[str, float]:
        return {
            k: {"total_s": round(v, 4), "mean_ms": round(v / self.counts[k] * 1e3, 3),
                "count": self.counts[k]}
            for k, v in self.totals.items()
        }


def scan_scalars(result) -> Dict[str, Any]:
    """The device scalars of one engine result (ScanResult, LioResult,
    LioSamResult, LivoxResult) and its pose, read to the host in one copy:
    {n_corner, n_surf, rms, degenerate, n_matches, n_dropped, t (3,), q (4,
    w, x, y, z)}, each present where the result has it."""
    names, parts = [], []

    def add(name, t, n=1):
        names.append((name, n))
        parts.append(t.detach().reshape(-1).to(torch.float64))

    stats = getattr(result, "stats", None)
    if stats is not None:
        for f in ("n_corner", "n_surf", "rms", "degenerate"):
            add(f, getattr(stats, f))
    if hasattr(result, "n_matches"):
        add("n_matches", result.n_matches)
        add("rms", result.rms)
    if hasattr(result, "n_dropped"):
        add("n_dropped", result.n_dropped)
    pose = getattr(result, "pose", None)
    if pose is None and hasattr(result, "x"):  # direct-LIO result: NavState
        pose = result.x
        add("t", pose.p, 3)
    elif pose is not None:
        add("t", pose.t, 3)
    if pose is not None:
        add("q", pose.q, 4)
    vals = torch.cat(parts).tolist() if parts else []
    out, i = {}, 0
    for name, n in names:
        out[name] = vals[i] if n == 1 else vals[i:i + n]
        i += n
    return out


class MetricsWriter:
    """Append-only JSONL metrics sink. Use log_scan per processed sweep."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._f = open(path, "a") if path else None
        self.n = 0

    def log(self, record: Dict[str, Any]) -> None:
        self.n += 1
        if self._f is not None:
            self._f.write(json.dumps(record) + "\n")
            self._f.flush()

    def log_scan(self, frame: int, result, wall_ms: float, extra: Dict[str, Any] | None = None,
                 scalars: Dict[str, Any] | None = None):
        """Record one engine step (works with ScanResult / LioResult /
        LioSamResult / LivoxResult). `scalars` is the result's
        `scan_scalars`, when the caller has read them already."""
        s = scan_scalars(result) if scalars is None else scalars
        rec: Dict[str, Any] = {"frame": int(frame), "wall_ms": round(wall_ms, 3)}
        if "n_corner" in s:
            rec.update(n_corner=int(s["n_corner"]), n_surf=int(s["n_surf"]),
                       rms=float(s["rms"]), degenerate=bool(s["degenerate"]))
        if "n_matches" in s:
            rec.update(n_matches=int(s["n_matches"]), rms=float(s["rms"]))
        if "n_dropped" in s:
            rec["n_dropped"] = int(s["n_dropped"])  # map inserts lost (full chains)
        if hasattr(result, "pose"):
            rec["t"] = [round(float(x), 4) for x in s["t"]]
        if extra:
            rec.update(extra)
        self.log(rec)

    def close(self):
        if self._f:
            self._f.close()
            self._f = None
