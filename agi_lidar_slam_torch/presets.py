"""Reference-parameter presets of all five engine configurations (port of
agi_lidar_slam_tpu/presets.py, the same values).

The engine's default configs were tuned on the built-in simulator and deviate
from the reference's shipped parameters in a few places (documented per field
below). These presets restore the REFERENCE values verbatim, so that a run
under them tests the engines at the reference's operating points, and the
parity run on a real dataset is one preset away.

Each preset cites the reference file:line its values come from.
`REFERENCE_PIPELINE_PRESETS` maps the `--preset` names of the feature-based
engines (PipelineConfig presets) to their constructors.
"""

from __future__ import annotations

import dataclasses

from .config import (FeatureConfig, MapConfig, PipelineConfig, SolverConfig,
                     preset_aloam_kitti64, preset_lego_vlp16)
from .estimators.ieskf import IeskfConfig
from .features.livox import LivoxFeatureConfig
from .imu.eskf import EskfNoise
from .imu.preintegration import ImuNoise
from .runtime.lio_pipeline import LioConfig
from .runtime.livox_pipeline import LivoxConfig


def preset_aloam_kitti64_ref() -> PipelineConfig:
    """A-LOAM at its KITTI HDL-64 operating point, reference parameters
    (aloam_velodyne_HDL_64.launch: mapping_line_resolution 0.4,
    mapping_plane_resolution 0.8; scanRegistration.cpp:289-432 quotas;
    laserOdometry.cpp:216-218 skip=1 -> odometry stage on every scan).

    Deviations from the engine default (preset_aloam_kitti64): the odometry
    stage is ON (the engine default skips it because scan-to-map alone tracks
    the simulator; the reference always runs both stages), and the solver
    iteration budget matches the reference's 2 outer x 4 inner exactly.
    """
    base = preset_aloam_kitti64()
    return dataclasses.replace(
        base,
        features=dataclasses.replace(
            base.features,
            # scanRegistration.cpp:289-432: 6 sectors, 2 sharp + 20 less-sharp
            # corners, 4 flat per sector; less-flat voxel 0.2 (downSizeFilter)
            n_sectors=6, sharp_per_sector=2, corners_per_sector=20,
            flat_per_sector=4, surf_voxel=0.2,
            corner_thresh=0.1, surf_thresh=0.1,  # :380 curvature 0.1 split
            min_range=5.0,  # kitti_helper.launch MINIMUM_RANGE 5
        ),
        solver=dataclasses.replace(
            base.solver,
            n_outer=2, n_inner=4,  # laserMapping.cpp:806-817 (2 passes x 4 LM)
            corner_gate_sq=1.0, surf_gate_sq=1.0,  # :670,:743 sqDis[4] < 1.0
            degen_eig_thresh=100.0,  # LIO-SAM LMOptimization eigThre (A-LOAM
            # itself has no degeneracy clamp; 100 is the family value)
        ),
        corner_ds_voxel=0.4,  # lineRes (launch:6)
        surf_ds_voxel=0.8,  # planeRes (launch:7)
        odometry_stage=True,
        odom_two_tier=True,
    )


def preset_lego_vlp16_ref() -> PipelineConfig:
    """LeGO-LOAM VLP-16 reference parameters (utility.h:50-103).

    Deviations from preset_lego_vlp16: solver budgets match the reference's
    25-iteration two-step odometry / 10-iteration mapping split as closely as
    the (n_outer x n_inner) structure allows, and the degeneracy thresholds
    are the reference's 10 (odometry, featureAssociation.cpp:1651) /
    100 (mapping, mapOptmization.cpp:1475).
    """
    base = preset_lego_vlp16()
    return dataclasses.replace(
        base,
        features=dataclasses.replace(
            base.features,
            n_sectors=6,  # featureAssociation.cpp:984 (6 subregions)
            corners_per_sector=20, sharp_per_sector=2, flat_per_sector=4,
            corner_thresh=0.1, surf_thresh=0.1,  # utility.h edgeThreshold 0.1
            surf_voxel=0.2,  # downSizeFilter leaf 0.2 (featureAssociation.cpp:552)
            min_range=1.0,
            segmentation=True,
        ),
        # the engine's two_step solver is featureAssociation's two-step GN
        # (surf -> z/roll/pitch, corner -> x/y/yaw): its degeneracy threshold
        # is eigThre 10 (featureAssociation.cpp:1651-1678; the separate
        # mapping GN uses 100 but operates on far denser correspondences)
        solver=dataclasses.replace(base.solver, n_outer=5, n_inner=2,
                                   degen_eig_thresh=10.0),
        corner_ds_voxel=0.2,  # cornerLeafSize (utility.h:86)
        surf_ds_voxel=0.4,  # surfLeafSize
        two_step=True,
    )


@dataclasses.dataclass(frozen=True)
class LioSamRefParams:
    """LIO-SAM config/params.yaml values consumed outside PipelineConfig
    (keyframe gates, loop closure, GPS, IMU noise)."""

    # keyframe gates (params.yaml:77-78)
    kf_dist: float = 1.0  # surroundingkeyframeAddingDistThreshold
    kf_angle: float = 0.2  # surroundingkeyframeAddingAngleThreshold
    # loop closure (params.yaml:82-87)
    loop_radius: float = 15.0  # historyKeyframeSearchRadius
    loop_time_diff: float = 30.0  # historyKeyframeSearchTimeDiff (s)
    loop_submap: int = 25  # historyKeyframeSearchNum
    loop_fitness: float = 0.3  # historyKeyframeFitnessScore
    # GPS (params.yaml:12-13)
    gps_cov_thresh: float = 2.0
    pose_cov_thresh: float = 25.0
    # IMU (params.yaml:23-28)
    imu_acc_noise: float = 3.9939570888238808e-03
    imu_gyr_noise: float = 1.5636343949698187e-03
    imu_acc_bias: float = 6.4356659353532566e-05
    imu_gyr_bias: float = 3.5640318696367613e-05
    imu_gravity: float = 9.80511

    def imu_noise(self) -> ImuNoise:
        return ImuNoise(acc_n=self.imu_acc_noise, gyr_n=self.imu_gyr_noise,
                        acc_w=self.imu_acc_bias, gyr_w=self.imu_gyr_bias)


def preset_liosam_vlp16_ref() -> PipelineConfig:
    """LIO-SAM pipeline parameters (config/params.yaml): VLP-16 at 16x1800,
    edge/surf thresholds, mapping leaf sizes 0.2/0.4.

    The graph-side values (keyframe gates, loop closure, GPS, IMU noise) live
    in LioSamRefParams; a caller threads them into SlamConfig / LioSamConfig.
    """
    return PipelineConfig(
        features=FeatureConfig(
            n_sectors=6, corners_per_sector=20, sharp_per_sector=2,
            flat_per_sector=4,
            corner_thresh=0.1, surf_thresh=0.1,  # LIO-SAM's edgeThreshold 1.0
            # applies to its unnormalized range-diff curvature; on the
            # engine's normalized curvature the equivalent split is 0.1
            surf_voxel=0.4,  # odometrySurfLeafSize (params.yaml:44)
            max_corners=1024, max_surfs=4096,
            min_range=1.0, max_range=1000.0,  # lidarMinRange/lidarMaxRange
        ),
        corner_map=MapConfig(sub_voxel=0.25, block_sub=4, log2_slots=15,
                             neighborhood="full27"),
        surf_map=MapConfig(sub_voxel=0.4, block_sub=2, log2_slots=16,
                           neighborhood="full27"),
        # scan2MapOptimization: 30 GN iterations w/ re-association every
        # iteration (mapOptmization.cpp:1706-1742) -> 6 outer x 5 inner;
        # eigThre 100 (:1669)
        solver=SolverConfig(n_outer=6, n_inner=5, degen_eig_thresh=100.0),
        corner_ds_voxel=0.2,  # mappingCornerLeafSize
        surf_ds_voxel=0.4,  # mappingSurfLeafSize
        deskew=True,
        two_step=False,
    )


def preset_sfastlio_avia_ref() -> tuple:
    """S-FAST_LIO Livox-Avia reference parameters. Returns
    (IeskfConfig, EskfNoise, scan_voxel, map_sub_voxel, blind, extrinsic_t).

    Sources: launch/mapping_avia.launch (max_iteration 3, filter_size_surf
    0.5, filter_size_map 0.5), config/avia.yaml (acc/gyr_cov 0.1, bias cov
    1e-4, blind 4 m, extrinsic_T, extrinsic_est_en false), esekfom.hpp:137
    (5-NN gate 5 m^2), :163 (s-form residual gate), common_lib.h:104
    (esti_plane threshold 0.1), laserMapping.cpp:64 (LASER_POINT_COV 0.001).
    """
    ieskf = IeskfConfig(
        max_iters=3,  # mapping_avia.launch max_iteration
        meas_noise=0.001,
        converge_eps=0.001,
        k_neighbors=5,
        gate_sq=5.0,  # esekfom.hpp:137 (engine default 1.0 is sim-tuned)
        resid_gate="sform",  # esekfom.hpp:163 (engine default: 0.5 m cap)
        plane_tol=0.1,
        est_extrinsic=False,  # avia.yaml extrinsic_est_en
    )
    noise = EskfNoise(gyr=0.1, acc=0.1, bg=1e-4, ba=1e-4)  # avia.yaml mapping
    scan_voxel = 0.5  # filter_size_surf
    map_sub_voxel = 0.5  # filter_size_map
    blind = 4.0  # avia.yaml preprocess.blind
    extrinsic_t = (0.04165, 0.02326, -0.0284)  # avia.yaml extrinsic_T
    return ieskf, noise, scan_voxel, map_sub_voxel, blind, extrinsic_t


def lio_config_avia_ref() -> LioConfig:
    """LioConfig assembled from preset_sfastlio_avia_ref."""
    ieskf, noise, scan_voxel, map_sub, _blind, _ext = preset_sfastlio_avia_ref()
    return LioConfig(
        # full27 neighborhood: the reference's 5 m^2 5th-NN gate needs
        # sqrt(5)=2.24 m KNN coverage; 2.0 m blocks under full27 guarantee
        # 2.0 m (octant8 would truncate it to 1.0 m). The residual 2.0-2.24 m
        # ring is unreachable — an effective gate of 4.0 m^2, documented
        # parity deviation (matches beyond 2 m are degenerate-scene rescues
        # only).
        map=MapConfig(sub_voxel=map_sub, block_sub=4, log2_slots=17,
                      neighborhood="full27"),
        ieskf=ieskf, noise=noise, scan_voxel=scan_voxel,
        bound_radius=450.0,  # avia.yaml det_range 450
    )


def livox_config_horizon_ref() -> LivoxConfig:
    """LivoxConfig at the LIO-Livox Horizon reference operating point
    (config/horizon_config.yaml + launch/horizon.launch)."""
    return LivoxConfig(
        features=LivoxFeatureConfig(
            curvature_window=2,  # NumCurvSize
            # PartNum 150 over the Horizon's ~81 deg FOV ~= 2 deg/sector; the
            # engine sectors a full revolution, so 150 * (360/81) ~= 667 is
            # structural overkill — 64 sectors preserves the per-sector-quota
            # granularity at the sensor's actual point density
            n_sectors=64,
            corners_per_sector=4,
            corner_thresh=0.02,
            surf_thresh=0.02,  # FlatThreshold
            faraway=100.0,  # DistanceFaraway
            break_gap=1.0,  # BreakCornerDis
            min_range=1.0,  # LidarNearestDis
            surf_voxel=0.4,
        ),
        solver=SolverConfig(n_outer=5, n_inner=1,  # Estimator.cpp:967 (5 outer)
                            degen_eig_thresh=10.0),
        corner_ds_voxel=0.2,  # horizon.launch filter_parameter_corner
        surf_ds_voxel=0.4,  # filter_parameter_surf
        use_dynamic_removal=True,  # Use_seg 1
        use_nonfeature=True,
        imu_noise=ImuNoise(acc_n=0.08, gyr_n=0.004, acc_w=2e-4, gyr_w=2e-5),
        # IMUIntegrator.h:  acc_n 0.08, gyr_n 0.004, acc_w 2e-4, gyr_w 2e-5
    )


# --- registry -------------------------------------------------------------
# --preset names of the feature-based engines (PipelineConfig presets).
REFERENCE_PIPELINE_PRESETS = {
    "aloam-ref": preset_aloam_kitti64_ref,
    "lego-ref": preset_lego_vlp16_ref,
    "liosam-ref": preset_liosam_vlp16_ref,
}
