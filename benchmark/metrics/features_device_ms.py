"""features_device_ms (ms): device time a scan of the feature stage
(features/curvature, with features/segmentation where the config segments),
read from the staged pass. Layer: features."""

STAGES = [("features", "agi_lidar_slam_torch.runtime.pipeline", "extract_features_timed")]


def read(tr):
    if "features" in tr.missing or "features" not in tr.stage_ms or not tr.staged_scans:
        return None
    return tr.stage_ms["features"] / tr.staged_scans
