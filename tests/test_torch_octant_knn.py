"""Parity of the port's KNN (nn/octant_knn.py, nn/knn.py) with the reference:
the plain version of the octant kernel against the TPU kernel in interpret
mode (`knn_vmem(..., interpret=True)`) and against the XLA gather path, the
port's gather path against the reference's on octant8 and full27 maps, and
the wrapper's device and argument checks.

Tolerances are those of tests/test_vmem_knn.py: `valid` exact, squared
distances rtol=atol=3e-6 (one ulp of distance evaluation order), points
1e-5 (copied map points, exact in practice). The reference runs jitted, and
jitted XLA multiplies by the reciprocal of sub_voxel and block_size where the
port divides; the seeded queries put no coordinate within that ulp of a
block boundary, so block choices agree exactly."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agi_lidar_slam_torch import _build
from agi_lidar_slam_torch.convert import config_from_reference as port_cfg
from agi_lidar_slam_torch.map import hash_map as thm
from agi_lidar_slam_torch.nn import knn as tknn
from agi_lidar_slam_torch.nn import octant_knn
from agi_lidar_slam_tpu.config import MapConfig
from agi_lidar_slam_tpu.map import hash_map as jhm
from agi_lidar_slam_tpu.nn import knn as jknn
from agi_lidar_slam_tpu.nn.vmem_knn import knn_vmem
from tests._torch_threads import torch_one_thread  # noqa: F401 (autouse)

CFG = MapConfig(sub_voxel=0.5, block_sub=4, log2_slots=10, probes=8, neighborhood="octant8")
CFG27 = MapConfig(sub_voxel=0.8, block_sub=3, log2_slots=10, probes=8, neighborhood="octant8")
FULL27 = MapConfig(sub_voxel=0.5, block_sub=2, log2_slots=12, probes=8, neighborhood="full27")

# the reference jitted: one compile per function and shape, not one per
# primitive (the suite serializes compiles across workers)
j_empty_map = jax.jit(jhm.empty_map, static_argnums=0)
j_insert = jax.jit(jhm.insert, static_argnums=3)
j_knn_brute = jax.jit(jknn.knn_brute, static_argnums=3)
j_knn = jax.jit(jknn.knn, static_argnums=(3, 4))
j_knn_vmem = jax.jit(functools.partial(knn_vmem, interpret=True), static_argnums=(3, 4))


def _maps(cfg, seed=0, n=3000, extent=12.0):
    pts = np.random.default_rng(seed).uniform(-extent, extent, (n, 3)).astype(np.float32)
    ones = np.ones((n,), bool)
    jm = j_insert(j_empty_map(cfg), jnp.asarray(pts), jnp.asarray(ones), cfg)
    tcfg = port_cfg(cfg)
    tm = thm.insert(thm.empty_map(tcfg, "cpu"), torch.from_numpy(pts), torch.from_numpy(ones), tcfg)
    return jm, tm


def _queries(n, seed=1, masked=0.2):
    rng = np.random.default_rng(seed)
    q = rng.uniform(-11, 11, (n, 3)).astype(np.float32)
    return q, rng.uniform(size=n) >= masked


def _check(j_sq, j_pts, j_valid, t_sq, t_pts, t_valid):
    np.testing.assert_array_equal(np.asarray(j_valid), t_valid.numpy())
    v = np.asarray(j_valid)
    np.testing.assert_allclose(t_sq.numpy()[v], np.asarray(j_sq)[v], rtol=3e-6, atol=3e-6)
    np.testing.assert_allclose(t_pts.numpy()[v], np.asarray(j_pts)[v], rtol=1e-5, atol=1e-5)


# (map config, queries, k, query mask fraction): tile-aligned and ragged N,
# bucket 27 (block_sub=3), k=16, all queries masked
CASES = {
    "n64": (CFG, 64, 5, 0.2),
    "n200": (CFG, 200, 5, 0.2),
    "bucket27": (CFG27, 192, 5, 0.0),
    "k16": (CFG, 64, 16, 0.2),
    "all_masked": (CFG, 64, 5, 1.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_octant_ref_matches_tpu_kernel(case):
    cfg, n, k, masked = CASES[case]
    jm, tm = _maps(cfg)
    q, qm = _queries(n, masked=masked)
    j = j_knn_vmem(jm, jnp.asarray(q), jnp.asarray(qm), k, cfg)
    t = octant_knn.knn_octant(tm, torch.from_numpy(q), torch.from_numpy(qm), k, port_cfg(cfg))
    _check(*j, *t)
    if masked == 1.0:
        assert not bool(t[2].any())


@pytest.mark.parametrize("cfg", [CFG, CFG27], ids=["bucket64", "bucket27"])
def test_octant_ref_matches_gather_path(cfg):
    jm, tm = _maps(cfg, seed=3)
    q, qm = _queries(256, seed=4)
    j = j_knn(jm, jnp.asarray(q), jnp.asarray(qm), 5, cfg)  # XLA gather path on CPU
    t = octant_knn.knn_octant_ref(tm, torch.from_numpy(q), torch.from_numpy(qm), 5, port_cfg(cfg))
    _check(j.sq_dists, j.points, j.valid, *t)


def test_empty_map():
    tm = thm.empty_map(port_cfg(CFG), "cpu")
    q = torch.zeros((64, 3))
    sq, pts, valid = octant_knn.knn_octant(tm, q, torch.ones(64, dtype=torch.bool), 5,
                                           port_cfg(CFG))
    assert not bool(valid.any())
    assert bool((sq == 1e30).all()) and bool((pts == 0).all())


@pytest.mark.parametrize("cfg", [CFG, FULL27], ids=["octant8", "full27"])
def test_gather_path_matches_reference(cfg):
    """The port's gather path (the only path for full27 maps) against the
    reference's XLA gather path."""
    jm, tm = _maps(cfg, seed=5)
    q, qm = _queries(256, seed=6)
    j = j_knn(jm, jnp.asarray(q), jnp.asarray(qm), 5, cfg)
    gather_cfg = dataclasses.replace(port_cfg(cfg), knn_kernel="xla")  # octant8 off the kernel
    t = tknn.knn(tm, torch.from_numpy(q), torch.from_numpy(qm), 5, gather_cfg)
    _check(j.sq_dists, j.points, j.valid, t.sq_dists, t.points, t.valid)


def test_knn_brute_matches_reference():
    rng = np.random.default_rng(7)
    ref = rng.uniform(-5, 5, (500, 3)).astype(np.float32)
    mask = rng.uniform(size=500) > 0.3
    q = rng.uniform(-5, 5, (64, 3)).astype(np.float32)
    j = j_knn_brute(jnp.asarray(ref), jnp.asarray(mask), jnp.asarray(q), 5)
    t = tknn.knn_brute(torch.from_numpy(ref), torch.from_numpy(mask), torch.from_numpy(q), 5)
    np.testing.assert_allclose(t.sq_dists.numpy(), np.asarray(j.sq_dists), rtol=3e-6, atol=3e-6)
    np.testing.assert_allclose(t.points.numpy(), np.asarray(j.points), rtol=1e-5, atol=1e-5)


def test_wrapper_rejects_bad_inputs():
    tcfg, tfull27 = port_cfg(CFG), port_cfg(FULL27)
    tm = thm.empty_map(tcfg, "cpu")
    q, qm = torch.zeros((8, 3)), torch.ones(8, dtype=torch.bool)
    with pytest.raises(ValueError, match="k <= 16"):
        octant_knn.knn_octant(tm, q, qm, 17, tcfg)
    with pytest.raises(ValueError, match="queries"):
        octant_knn.knn_octant(tm, q.double(), qm, 5, tcfg)
    with pytest.raises(ValueError, match="contiguous"):
        octant_knn.knn_octant(tm, torch.zeros((3, 8)).T, qm, 5, tcfg)
    with pytest.raises(ValueError, match="octant8"):
        octant_knn.knn_octant(tm, q, qm, 5, tfull27)
    # neither cpu nor cuda: no silent fallback to the plain version
    meta = thm.HashVoxelMap(*(t.to("meta") for t in tm))
    with pytest.raises(ValueError, match="cpu or cuda"):
        octant_knn.knn_octant(meta, q.to("meta"), qm.to("meta"), 5, tcfg)


@pytest.mark.parametrize("case", ["bucket216", "points", "occ"])
def test_wrapper_refuses_wide_buckets_and_misaligned_tables(case):
    """A bucket above 128, and a points or occupancy table that does not
    start 16-byte aligned (the kernel copies rows in 16-byte pieces), raise
    on every device rather than fall back."""
    q, qm = torch.zeros((8, 3)), torch.ones(8, dtype=torch.bool)
    if case == "bucket216":
        wide = port_cfg(MapConfig(sub_voxel=0.5, block_sub=6, log2_slots=6, probes=8,
                                  neighborhood="octant8"))
        with pytest.raises(ValueError, match="buckets up to 128"):
            octant_knn.knn_octant(thm.empty_map(wide, "cpu"), q, qm, 5, wide)
        return
    tcfg = port_cfg(CFG)
    tm = thm.empty_map(tcfg, "cpu")
    rows, B = tm.occ.shape
    if case == "points":  # 4 bytes past the allocation
        m = tm._replace(points=torch.zeros(rows * B * 3 + 1)[1:].view(rows, B, 3))
    else:
        m = tm._replace(occ=torch.zeros(rows * B + 1, dtype=torch.bool)[1:].view(rows, B))
    t = getattr(m, case)
    assert t.is_contiguous() and t.data_ptr() % 16
    with pytest.raises(ValueError, match=f"{case} must start 16-byte aligned"):
        octant_knn.knn_octant(m, q, qm, 5, tcfg)


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    """A missing toolchain is an error, never a fallback to the plain path."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert _build.library_path().name.startswith("libagi_lidar_slam_kernels-")
