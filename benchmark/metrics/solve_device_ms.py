"""solve_device_ms (ms): device time a scan of the solves: the scan-to-map
Gauss-Newton (estimators/gn_scan2map) or the two-step solve
(estimators/two_step), with their eigendecompositions (estimators/sym_eig)
and association, and the scan-to-scan odometry stage where the config has
one (its two throwaway maps and its solve), read from the staged pass.
Layer: estimators."""

STAGES = [("solve", "agi_lidar_slam_torch.runtime.pipeline", "solve_scan2map"),
          ("solve", "agi_lidar_slam_torch.runtime.pipeline", "solve_scan2map_two_step"),
          ("solve", "agi_lidar_slam_torch.runtime.pipeline", "insert"),
          ("solve", "agi_lidar_slam_torch.runtime.pipeline", "empty_map")]


def read(tr):
    if "solve" in tr.missing or "solve" not in tr.stage_ms or not tr.staged_scans:
        return None
    return tr.stage_ms["solve"] / tr.staged_scans
