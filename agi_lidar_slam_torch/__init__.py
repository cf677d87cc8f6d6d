"""agi_lidar_slam_torch — the PyTorch / CUDA port of agi_lidar_slam_tpu.

The port mirrors the JAX package's module paths and function names, so each
function has an obvious counterpart. It imports torch and numpy only: nothing
of jax and nothing of the JAX package. What it needs of the JAX package's
jax-free modules it keeps as its own copy (`config.py`, `eval/metrics.py`).

Entry points that make state from nothing (`init_state`, `init_lio_state`,
`init_slam`, `init_liosam_state`, `empty_bank`, `empty_edges`, `empty_map`,
the slam and LIO-SAM drivers, `default_world`, `NavState.identity`, the sim
trajectories) put it on `cuda` unless the caller passes another device.

The hand-written GPU kernels live in `csrc/` and are built with nvcc at first
use (`_build.py`): the octant-KNN association kernel (`nn/octant_knn.py`) and
the two probe kernels (`tools/probe.py`).
"""

from .config import (
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
