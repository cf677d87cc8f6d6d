# Frozen copy of agi_lidar_slam_torch/config.py at commit 88e7c49, for the
# benchmark's plain reference: it imports nothing of the program, and
# later changes to the program do not reach it.
"""Typed configuration tree of the port (the same fields and defaults as the
JAX package's `config.py`, kept here so that the port stands alone).

All configs are frozen dataclasses. Tests that run both engines hand a
reference config across with `convert.config_from_reference`.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass


@dataclass(frozen=True)
class FeatureConfig:
    """A-LOAM / LIO-SAM curvature feature extraction."""

    curvature_window: int = 5  # +-5 neighbors in the curvature sum
    n_sectors: int = 6  # sectors per ring
    corners_per_sector: int = 20  # "less sharp" pick budget per sector
    sharp_per_sector: int = 2  # the two A-LOAM tiers of the odometry stage
    flat_per_sector: int = 4
    corner_thresh: float = 0.1  # curvature > thresh -> edge candidate
    surf_thresh: float = 0.1  # curvature < thresh -> planar candidate
    nms_window: int = 5  # suppression half-window around picks
    surf_voxel: float = 0.4  # less-flat downsample leaf (m)
    max_corners: int = 2048  # fixed output capacity
    max_surfs: int = 8192
    min_range: float = 0.3  # blind-zone removal
    max_range: float = 120.0
    segmentation: bool = False  # LeGO-LOAM ground removal + cluster filtering


@dataclass(frozen=True)
class MapConfig:
    """Hashed voxel-block map (map/hash_map.py)."""

    log2_slots: int = 18  # hash table has 2**log2_slots blocks
    sub_voxel: float = 0.4  # map resolution: at most one point per sub-voxel
    block_sub: int = 2  # sub-voxels per block edge (block = sub_voxel*block_sub)
    probes: int = 8  # linear-probe length
    claim_rounds: int = 8  # insert conflict-resolution rounds (early exit)
    neighborhood: str = "octant8"  # KNN block set: "octant8" (coverage =
    # block_size/2) or "full27" (coverage = block_size)
    # association path for octant8 maps: anything but "xla" takes the
    # octant-KNN kernel (nn/octant_knn.py); "xla" forces the gather path
    knn_kernel: str = "auto"

    @property
    def slots(self) -> int:
        return 1 << self.log2_slots

    @property
    def bucket(self) -> int:
        return self.block_sub**3

    @property
    def block_size(self) -> float:
        return self.sub_voxel * self.block_sub


@dataclass(frozen=True)
class SolverConfig:
    """Scan-to-map Gauss-Newton (A-LOAM laserMapping, LIO-SAM LMOptimization)."""

    n_outer: int = 2  # association passes
    n_inner: int = 4  # GN re-linearizations per association
    k_neighbors: int = 5
    cand_k: int = 0  # candidate-cache association (>= k_neighbors); 0 disables
    cand_refresh: float = 0.3  # cache skin distance (m)
    corner_gate_sq: float = 1.0  # max sq dist of k-th corner neighbor (m^2)
    surf_gate_sq: float = 1.0
    line_eig_ratio: float = 3.0  # lambda_max > ratio * lambda_mid -> line OK
    plane_tol: float = 0.2  # max |n.p + d| over the 5 plane points (m)
    huber_delta: float = 0.1  # robust loss scale
    degen_eig_thresh: float = 100.0  # eigenvalue clamp on J^T J
    translation_clip: float = 1.0  # max |dt| per GN step (m)


@dataclass(frozen=True)
class PipelineConfig:
    # KNN coverage radius is block_size/2 for octant8 and block_size for
    # full27; it must be >= sqrt(gate_sq) of the solver.
    features: FeatureConfig = FeatureConfig()
    corner_map: MapConfig = MapConfig(sub_voxel=0.5, block_sub=4, log2_slots=13, probes=8)
    surf_map: MapConfig = MapConfig(sub_voxel=0.6, block_sub=4, log2_slots=14, probes=8)
    solver: SolverConfig = SolverConfig()
    corner_ds_voxel: float = 0.4  # scan-to-map feature downsample leaves (m)
    surf_ds_voxel: float = 0.8
    deskew: bool = True  # constant-velocity deskew
    two_step: bool = False  # LeGO two-step GN
    odometry_stage: bool = False  # A-LOAM scan-to-scan stage
    odom_two_tier: bool = True
    odom_map: MapConfig = MapConfig(sub_voxel=0.5, block_sub=4, log2_slots=13,
                                    neighborhood="full27")
    odom_solver: SolverConfig = SolverConfig(
        n_outer=2, n_inner=2, corner_gate_sq=4.0, surf_gate_sq=4.0,
        degen_eig_thresh=10.0, plane_tol=0.3,
    )
    bound_radius: float = 150.0  # rolling map bound (m, per axis); 0 disables

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)


def preset_aloam_kitti64() -> PipelineConfig:
    """A-LOAM on KITTI HDL-64 (line_res 0.4, plane_res 0.8)."""
    return PipelineConfig()


def preset_sim16() -> PipelineConfig:
    """Small 16-beam config for CPU tests and the synthetic simulator."""
    return PipelineConfig(
        features=FeatureConfig(
            corners_per_sector=8, max_corners=512, max_surfs=2048, surf_voxel=0.3
        ),
        corner_map=MapConfig(sub_voxel=0.25, block_sub=4, log2_slots=14,
                             neighborhood="full27"),
        surf_map=MapConfig(sub_voxel=0.5, block_sub=2, log2_slots=15,
                           neighborhood="full27"),
        solver=SolverConfig(n_outer=5, n_inner=2, degen_eig_thresh=10.0),
        corner_ds_voxel=0.2,
        surf_ds_voxel=0.4,
    )


def preset_lego_vlp16() -> PipelineConfig:
    """LeGO-LOAM on VLP-16 (utility.h:50-103: 16x1800 image, ground removal,
    cluster segmentation, two-step optimization)."""
    return PipelineConfig(
        features=FeatureConfig(
            corners_per_sector=8, max_corners=1024, max_surfs=4096,
            surf_voxel=0.4, segmentation=True,
        ),
        corner_map=MapConfig(sub_voxel=0.25, block_sub=4, log2_slots=15,
                             neighborhood="full27"),
        surf_map=MapConfig(sub_voxel=0.4, block_sub=2, log2_slots=16,
                           neighborhood="full27"),
        solver=SolverConfig(n_outer=4, n_inner=3, degen_eig_thresh=10.0),
        corner_ds_voxel=0.2,
        surf_ds_voxel=0.4,
        two_step=True,
    )
