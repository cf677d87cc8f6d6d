"""Parity of the torch voxel downsample and feature extraction with the
reference (agi_lidar_slam_tpu.pointcloud.voxel, features.curvature).

The port sums its prefix sums in the reference's blocked order
(voxel.prefix_sum: bit-exact against `jnp.cumsum`), sorts stably and divides
in IEEE f32, so masks, counts and the selected points are exact. The
reference runs jitted here (one compile per function, not one per primitive:
the suite serializes compiles across workers), and under jit XLA contracts
its elementwise tails into FMAs and fuses the centroid arithmetic: curvature
agrees to 1e-4 relative / 1e-5 absolute (measured 4.3e-5 / 4.4e-6), a voxel
centroid to 3e-5 m (up to 8 ulps at 8 m), mean times to 1e-6; validity and
occlusion masks exactly. Run op by op, the reference's curvature equals the
port's bit for bit."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agi_lidar_slam_torch.convert import config_from_reference as port_cfg
from agi_lidar_slam_torch.features import curvature as tcurv
from agi_lidar_slam_torch.pointcloud import voxel as tvox
from agi_lidar_slam_torch.pointcloud import cloud as tcloud
from agi_lidar_slam_torch.pointcloud.cloud import ScanGrid as TScanGrid
from agi_lidar_slam_tpu.config import preset_aloam_kitti64
from agi_lidar_slam_tpu.features import curvature as jcurv
from agi_lidar_slam_tpu.geometry import se3 as jse3
from agi_lidar_slam_tpu.pointcloud import cloud as jcloud
from agi_lidar_slam_tpu.pointcloud import voxel as jvox
from agi_lidar_slam_tpu.sim.world import default_world, simulate_scan

FEAT = preset_aloam_kitti64().features
T_FEAT = port_cfg(FEAT)  # the port's own FeatureConfig, same fields


def _to_t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("shape,dim", [((16, 910, 3), 1), ((20000, 5), 0), ((7,), 0)])
def test_prefix_sum_bit_exact(shape, dim):
    x = (np.random.default_rng(0).normal(size=shape) * 20).astype(np.float32)
    np.testing.assert_array_equal(np.asarray(jnp.cumsum(jnp.asarray(x), axis=dim)),
                                  tvox.prefix_sum(torch.from_numpy(x), dim).numpy())


def test_grid_from_unorganized():
    """Host-side binning of an unorganized cloud (KITTI .bin layout): the
    same numpy code on both sides, returned as tensors; exact."""
    rng = np.random.default_rng(2)
    xyz = (rng.normal(size=(5000, 3)) * [20, 20, 2]).astype(np.float32)
    j = jcloud.grid_from_unorganized(xyz, 64, 512, 2.0, -24.8)
    t = tcloud.grid_from_unorganized(xyz, 64, 512, 2.0, -24.8, device="cpu")
    for a, b in zip(j, t):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert int(t.mask.sum()) > 1000


@pytest.mark.parametrize("voxel,capacity", [(0.4, 2048), (0.8, 300)])
def test_voxel_downsample_aux(voxel, capacity):
    rng = np.random.default_rng(1)
    xyz = rng.uniform(-30, 30, (6000, 3)).astype(np.float32)
    xyz[3000:3500] = xyz[:500] + rng.normal(scale=0.05, size=(500, 3)).astype(np.float32)
    mask = rng.uniform(size=6000) > 0.2
    aux = rng.uniform(size=6000).astype(np.float32)
    fn = jax.jit(jvox.voxel_downsample_aux, static_argnums=(2, 3))
    jb, jaux = fn(jnp.asarray(xyz), jnp.asarray(mask), voxel, capacity, jnp.asarray(aux))
    tb, taux = tvox.voxel_downsample_aux(_to_t(xyz), _to_t(mask), voxel, capacity, _to_t(aux))
    np.testing.assert_array_equal(np.asarray(jb.mask), tb.mask.numpy())
    np.testing.assert_allclose(tb.xyz.numpy(), np.asarray(jb.xyz), rtol=0, atol=3e-5)
    np.testing.assert_allclose(taux.numpy(), np.asarray(jaux), rtol=0, atol=1e-6)
    if capacity == 300:
        assert bool(tb.mask.all())  # overflow voxels dropped, capacity filled


@functools.lru_cache(maxsize=1)
def _scan(rings=16, width=900):
    world = jax.jit(default_world, static_argnums=0)(2)
    p0 = jse3.Pose(np.asarray([1, 0, 0, 0], np.float32), np.zeros(3, np.float32))
    p1 = jse3.Pose(np.asarray([np.cos(0.01), 0, 0, np.sin(0.01)], np.float32),
                   np.asarray([0.4, 0.05, 0.0], np.float32))
    s = jax.jit(simulate_scan, static_argnames=("rings", "width", "noise_std", "seed"))(
        world, p0, p1, rings=rings, width=width, noise_std=0.01, seed=3)
    return s, TScanGrid(*(_to_t(a) for a in s))


def test_curvature_and_occlusion():
    js, ts = _scan()
    (jc, jv), jo = jax.jit(lambda s: (jcurv.curvature(s, FEAT),
                                      jcurv.occlusion_mask(s, FEAT)))(js)
    tc, tv = tcurv.curvature(ts, T_FEAT)
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(jo), tcurv.occlusion_mask(ts, T_FEAT).numpy())


def test_extract_features_timed_16x900():
    """Every tier: masks exact, and the masked entries' points and times.
    Unpicked slots (mask False) hold whatever top-k left there, on both sides."""
    js, ts = _scan()
    j = jax.jit(jcurv.extract_features_timed, static_argnums=1)(js, FEAT)
    t = tcurv.extract_features_timed(ts, T_FEAT)
    assert int(t.corners.mask.sum()) > 50 and int(t.surfs.mask.sum()) > 500
    for jb, jtau, tb, ttau in [(j.corners, j.corner_tau, t.corners, t.corner_tau),
                               (j.surfs, j.surf_tau, t.surfs, t.surf_tau),
                               (j.sharp, j.sharp_tau, t.sharp, t.sharp_tau),
                               (j.flat, j.flat_tau, t.flat, t.flat_tau)]:
        m = np.asarray(jb.mask)
        np.testing.assert_array_equal(m, tb.mask.numpy())
        np.testing.assert_allclose(tb.xyz.numpy()[m], np.asarray(jb.xyz)[m], rtol=0, atol=3e-5)
        np.testing.assert_allclose(ttau.numpy()[m], np.asarray(jtau)[m], rtol=0, atol=1e-6)


def test_segmentation_branch_raises():
    """The segmentation branch of the feature extraction (LeGO-LOAM) no
    longer raises: on a 4x360 grid of a noisy cylinder (a wall 10 m around
    the sensor with a step every 30 columns, every pixel valid) it gives the
    reference's features, masks exactly. tests/test_torch_lego.py holds it to the reference on simulator
    scans."""
    rng = np.random.default_rng(4)
    R, W = 4, 360
    az = np.linspace(0, 2 * np.pi, W, endpoint=False)
    rad = 10.0 + rng.normal(scale=0.005, size=(R, W)) + (np.arange(W) // 30 % 2) * 0.25
    xyz = np.stack([rad * np.cos(az), rad * np.sin(az),
                    np.broadcast_to(np.arange(R)[:, None] * 0.4 - 1.0, (R, W))], -1)
    xyz = xyz.astype(np.float32)
    mask = np.ones((R, W), bool)
    tau = np.broadcast_to(np.linspace(0, 1, W, endpoint=False, dtype=np.float32), (R, W))
    feat = dataclasses.replace(FEAT, segmentation=True, n_sectors=2, corners_per_sector=4,
                               max_corners=16, max_surfs=64)
    j = jax.jit(jcurv.extract_features_timed, static_argnums=1)(
        jcloud.ScanGrid(*map(jnp.asarray, (xyz, mask, tau))), feat)
    t = tcurv.extract_features_timed(TScanGrid(*map(_to_t, (xyz, mask, tau))), port_cfg(feat))
    assert int(t.surfs.mask.sum()) > 0 and int(t.corners.mask.sum()) > 0
    for jb, tb in [(j.corners, t.corners), (j.surfs, t.surfs), (j.sharp, t.sharp),
                   (j.flat, t.flat)]:
        m = np.asarray(jb.mask)
        np.testing.assert_array_equal(m, tb.mask.numpy())
        np.testing.assert_allclose(tb.xyz.numpy()[m], np.asarray(jb.xyz)[m], rtol=0, atol=3e-5)
