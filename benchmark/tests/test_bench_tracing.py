"""The readers' arithmetic on a small synthetic trace."""

from types import SimpleNamespace

import torch

from benchmark import staged, tracing
from benchmark.tracing import Event

B = tracing.PREFIX


def host(name, a, b, corr=0):
    return Event(name, False, name.startswith(B), a, b, corr)


def dev(name, a, b, corr):
    return Event(name, True, False, a, b, corr)


def test_window_busy_kernels_and_gaps():
    ev = [host(B + "window", 0, 1000),
          host(B + "call", 0, 100), host("cudaGraphLaunch", 10, 20, corr=1),
          host(B + "call", 500, 600), host("cudaGraphLaunch", 510, 520, corr=2),
          host(B + "read", 600, 1000), host("cudaEventSynchronize", 600, 990),
          dev("k1", 50, 250, 1), dev("k2", 200, 400, 1), dev("Memcpy DtoH", 400, 450, 1),
          dev("k3", 700, 900, 2), dev("k4", 950, 1100, 9)]
    w = tracing.window_stats(ev, scans=8)
    assert w.window_s == 1000e-9
    # union: [50, 450], [700, 900], [950, 1000]
    assert abs(w.busy_s - 650e-9) < 1e-15
    assert w.kernels_in_calls == 3 and w.kernels_unlinked == 1
    assert w.idle_gaps[0] == ["call/python", 250e-9]
    assert w.idle_gaps[1][0] in ("read/cudaEventSynchronize", "call/python")
    assert w.device_ops[0][0] in ("k1", "k2", "k3")
    tr = staged.Trace(cell="x", chunk=4, call_ms=[1.0, 3.0], window=w)
    from benchmark.metrics import call_host_ms, device_idle_pct, kernels_per_scan
    assert device_idle_pct.read(tr) is None  # the window's events, not the profile
    tr.loop_busy_s, tr.loop_span_s = 0.65, 1.0
    assert abs(device_idle_pct.read(tr) - 35.0) < 1e-9
    assert kernels_per_scan.read(tr) == 3 / 8
    assert call_host_ms.read(tr) == 2.0


def test_an_operator_with_a_launch_id_takes_no_work_from_its_call():
    """The profiler's operator events carry ids that can equal a runtime
    call's correlation id: a graph's kernels stay with the call that
    launched it, whatever operator shares its id."""
    ev = [host(B + "window", 0, 1000),
          host(B + "call", 0, 100), host("cudaGraphLaunch", 10, 20, corr=1),
          host(B + "call", 200, 300), host("cudaGraphLaunch", 210, 220, corr=2),
          host(B + "read", 400, 500), host("aten::resolve_conj", 410, 420, corr=1),
          dev("k1", 50, 150, 1), dev("k2", 150, 190, 1), dev("k3", 250, 350, 2)]
    w = tracing.window_stats(ev, scans=2)
    assert w.kernels_in_calls == 3 and w.kernels_unlinked == 0
    ms = tracing.device_ms_by_range(ev)
    assert abs(ms["call"] - 240e-6) < 1e-15 and ms["read"] == 0.0


def test_stage_device_ms_by_correlation():
    ev = [host(B + "stage::features", 0, 100), host("cudaLaunchKernel", 10, 11, corr=1),
          host("cudaMemsetAsync", 20, 21, corr=2),
          host(B + "stage::solve", 200, 400), host("cudaLaunchKernel", 210, 211, corr=3),
          host(B + "calls::octant_knn", 300, 350), host("cudaLaunchKernel", 310, 311, corr=4),
          host("cudaLaunchKernel", 500, 501, corr=5),
          dev("feat", 1000, 3000, 1), dev("Memset", 3000, 3500, 2), dev("gn", 4000, 9000, 3),
          dev("octant", 9000, 10000, 4), dev("other", 20000, 30000, 5)]
    ms = tracing.device_ms_by_range(ev)
    assert ms == {"stage::features": 0.0025, "stage::solve": 0.006, "calls::octant_knn": 0.001}
    tr = staged.Trace(cell="x", chunk=4, call_ms=[], staged_scans=2,
                      stage_ms={"features": 0.0025, "solve": 0.006})
    from benchmark.metrics import features_device_ms, map_device_ms, solve_device_ms
    assert features_device_ms.read(tr) == 0.00125 and solve_device_ms.read(tr) == 0.003
    assert map_device_ms.read(tr) is None
    tr.missing["solve"] = "gone"
    assert solve_device_ms.read(tr) is None


def test_octant_roofline_from_the_frozen_work(monkeypatch):
    from benchmark.metrics import octant_knn_roofline as r

    monkeypatch.setattr(r, "_call", lambda *a, **kw: (3.35e6, 0))  # 1 us at the HBM rate
    tr = staged.Trace(cell="x", chunk=4, call_ms=[], device_name="NVIDIA H100 80GB HBM3",
                      calls={"octant_knn": [((), {}), ((), {})]},
                      call_device_ms={"octant_knn": 0.004})
    assert abs(r.read(tr) - 50.0) < 1e-9
    tr.call_device_ms = {}
    assert r.read(tr) is None


class _Lap:
    xyz, mask, time, n = torch.zeros(4, 2, 3, 3), torch.ones(4, 2, 3, dtype=bool), \
        torch.zeros(4, 2, 3), 4


class _Engine:
    """A program whose per-sweep call counts its calls."""

    def __init__(self):
        self.calls = 0

    def process_scan(self, state, sweep, cfg):
        self.calls += 1
        return state, None


class _Adapter:
    CALLS = {"scan": "process_scan", "chunk": "process_scan_chunk"}
    STAGED_CALL = "scan"
    CAPTURE_FLAGS = {"chunk": "benchmark.staged:no_such_flag"}

    @staticmethod
    def inputs(engine, lap, start, n, call):
        return lap.xyz[start]


def _feed(call, engine):
    return SimpleNamespace(k=1, C=1, lap=_Lap, adapter=_Adapter, engine=engine, cfg=None,
                           call=call)


def test_no_staged_metric_without_the_capture_flag():
    from benchmark.metrics import map_device_ms, solve_device_ms

    engine = _Engine()
    readers = {"map_device_ms": map_device_ms, "solve_device_ms": solve_device_ms}
    tr = staged.Trace(cell="x", chunk=1, call_ms=[])
    staged.staged_pass(_feed("chunk", engine), None, 2, readers, tr, False)
    assert "capture_flag" in tr.missing and not tr.stage_ms and not tr.staged_scans
    assert engine.calls == 0, "the staged pass ran without the capture flag"
    assert map_device_ms.read(tr) is None and solve_device_ms.read(tr) is None


def test_eager_call_is_staged_without_a_capture_flag():
    engine = _Engine()
    tr = staged.Trace(cell="x", chunk=1, call_ms=[])
    staged.staged_pass(_feed("scan", engine), None, 2, {}, tr, False)
    assert "capture_flag" not in tr.missing and tr.staged_scans == 2
    assert engine.calls == 4  # the unprofiled pass, then the staged one


def test_feature_capacity_counts():
    from benchmark import caps

    xyz = torch.tensor([[0.1, 0.1, 0.1], [0.2, 0.2, 0.2], [1.1, 0.1, 0.1], [5.0, 5.0, 5.0]])
    mask = torch.tensor([True, True, True, False])
    assert caps.occupied(xyz, mask, 1.0) == 2 and caps.occupied(xyz, mask, 0.15) == 3
    text = caps.report({"corners": (2, [1, 3, 2]), "surfs": (8, [8, 9, 10])})
    assert "corners: 1-3 voxels against 2, over it in 1 of 3" in text
    assert "surfs: 8-10 voxels against 8, over it in 2 of 3" in text
