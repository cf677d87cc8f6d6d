"""agi_lidar_slam_torch — the PyTorch / CUDA port of agi_lidar_slam_tpu.

The port mirrors the JAX package's module paths and function names, so each
function has an obvious counterpart. It imports torch and numpy, never jax.
Two JAX-package modules hold no jax and are shared instead of copied: the
configuration tree (`agi_lidar_slam_tpu.config`) and the host-side metrics
(`agi_lidar_slam_tpu.eval.metrics`).

The one hand-written GPU kernel is the octant-KNN association kernel
(`nn/octant_knn.py`, `csrc/octant_knn.cu`), built with nvcc at first use.
"""

from agi_lidar_slam_tpu.config import (
    FeatureConfig,
    MapConfig,
    PipelineConfig,
    SolverConfig,
    preset_aloam_kitti64,
    preset_sim16,
)

__all__ = [
    "FeatureConfig",
    "MapConfig",
    "PipelineConfig",
    "SolverConfig",
    "preset_aloam_kitti64",
    "preset_sim16",
]
