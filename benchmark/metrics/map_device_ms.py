"""map_device_ms (ms): device time a scan of the map's insert
(map/hash_map.insert_with_stats, both maps) and rolling bound
(map/hash_map.bound_map), read from the staged pass. Layer: map."""

STAGES = [("map", "agi_lidar_slam_torch.runtime.pipeline", "insert_with_stats"),
          ("map", "agi_lidar_slam_torch.runtime.pipeline", "bound_map")]


def read(tr):
    if "map" in tr.missing or "map" not in tr.stage_ms or not tr.staged_scans:
        return None
    return tr.stage_ms["map"] / tr.staged_scans
