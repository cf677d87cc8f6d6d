"""octant_knn_roofline (%): the octant-KNN kernel's share of its roofline
(nn/octant_knn, csrc/octant_knn.cu): the summed bounds of its calls in the
staged pass over their summed device time. A call's bound is the larger of
the bytes it must move over the HBM rate and its f32 operations over the f32
rate, from the benchmark's own arithmetic (benchmark/roofline.py). Layer:
kernels."""

from benchmark.roofline import bound_ms, knn_work

CALLS = [("octant_knn", "agi_lidar_slam_torch.nn.octant_knn", "knn_octant")]


def _call(m, queries, qmask, k, cfg, ktab=None):
    return knn_work(m, queries, qmask, k, cfg, ktab)


def read(tr):
    calls = tr.calls.get("octant_knn")
    ms = tr.call_device_ms.get("octant_knn")
    if "octant_knn" in tr.missing or not calls or not ms or not tr.device_name:
        return None
    bounds = sum(bound_ms(*_call(*a, **kw), tr.device_name) for a, kw in calls)
    return 100.0 * bounds / ms
