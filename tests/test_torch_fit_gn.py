"""Parity of the torch geometry fits and Gauss-Newton pieces with the
reference (agi_lidar_slam_tpu.fit.geometry_fit, estimators.gn_scan2map).

Tolerances: the closed-form 3x3 eigen-solve runs the same f32 formulas on
both sides, but arccos/cos differ by ulps between XLA and torch. Every
eigenvalue carries an absolute error of a few ulps of the largest one, and an
eigenvector divides that by its eigen-gap: line directions (large, isolated
eigenvalue) agree to 1e-5; the normal of a thin plane (smallest eigenvalue
~1e-4 of the largest, gap ~1e-2) to 5e-4, sign-aligned. Eigenvalues and
centroids to 1e-5 relative; the accept/reject gates exactly. H and g are
sums over ~1000 rows in another order: 1e-5 relative. The 6x6 `eigh` comes
from another LAPACK call; delta does not depend on eigenvector signs: 1e-4
relative."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agi_lidar_slam_torch.estimators import gn_scan2map as tgn
from agi_lidar_slam_torch.fit import geometry_fit as tfit
from agi_lidar_slam_torch.geometry import se3 as tse3
from agi_lidar_slam_torch.map.hash_map import empty_map as t_empty_map
from agi_lidar_slam_torch.pointcloud.cloud import PointBatch as TBatch
from agi_lidar_slam_tpu.config import SolverConfig, preset_aloam_kitti64
from agi_lidar_slam_tpu.estimators import gn_scan2map as jgn
from agi_lidar_slam_tpu.fit import geometry_fit as jfit
from agi_lidar_slam_tpu.geometry import se3 as jse3
from agi_lidar_slam_tpu.pointcloud.cloud import PointBatch as JBatch

SOLVER = SolverConfig()

# the reference jitted: one compile per function, not one per primitive
# (the suite serializes compiles across workers)
j_eigh3x3 = jax.jit(jfit.eigh3x3)
j_fits = jax.jit(lambda p, v: (jfit.fit_lines(p, v, 3.0), jfit.fit_planes(p, v, 0.2)))
j_normal_equations = jax.jit(jgn.normal_equations, static_argnums=4)
j_solve_delta = jax.jit(jgn.solve_delta, static_argnums=2)


def _t(x):
    return torch.from_numpy(np.array(x))


def _neighbourhoods(seed=0, n=256, k=5):
    """Line-like, plane-like and blob-like k-point sets, some invalid slots."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-30, 30, (n, 1, 3))
    d = rng.normal(size=(n, 1, 3))
    e = rng.normal(size=(n, 1, 3))
    s = rng.uniform(-0.5, 0.5, (n, k, 1))
    u = rng.uniform(-0.5, 0.5, (n, k, 1))
    kind = np.arange(n) % 3
    pts = c + s * d + np.where(kind[:, None, None] >= 1, u * e, 0.0)
    pts = pts + np.where(kind[:, None, None] == 2, rng.normal(scale=0.3, size=(n, k, 3)),
                         rng.normal(scale=0.01, size=(n, k, 3)))
    valid = rng.uniform(size=(n, k)) > 0.05
    return pts.astype(np.float32), valid


def _align_sign(ref, x):
    return x * np.sign(np.sum(ref * x, axis=-1, keepdims=True) + 1e-30)


def test_eigh3x3():
    """Covariances with separated eigenvalues (gaps >= 30% of the largest)."""
    rng = np.random.default_rng(1)
    Q, _ = np.linalg.qr(rng.normal(size=(128, 3, 3)))
    lam = np.array([1.0, 0.3, 0.01]) * rng.uniform(0.1, 5.0, (128, 1))
    cov = np.einsum("nij,nj,nkj->nik", Q, lam, Q).astype(np.float32)
    jv, jvec = j_eigh3x3(jnp.asarray(cov))
    tv, tvec = tfit.eigh3x3(_t(cov))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=2e-6 * lam.max())
    np.testing.assert_allclose(_align_sign(np.asarray(jvec), tvec.numpy()), np.asarray(jvec),
                               atol=1e-4)


def test_fit_lines_and_planes():
    pts, valid = _neighbourhoods(2)
    jl, jp = j_fits(jnp.asarray(pts), jnp.asarray(valid))
    tl = tfit.fit_lines(_t(pts), _t(valid), 3.0)
    np.testing.assert_array_equal(np.asarray(jl.ok), tl.ok.numpy())
    np.testing.assert_allclose(tl.centroid.numpy(), np.asarray(jl.centroid), rtol=1e-5, atol=1e-5)
    ok = np.asarray(jl.ok)
    assert ok.sum() > 20
    np.testing.assert_allclose(_align_sign(np.asarray(jl.direction), tl.direction.numpy())[ok],
                               np.asarray(jl.direction)[ok], atol=1e-5)

    tp = tfit.fit_planes(_t(pts), _t(valid), 0.2)
    np.testing.assert_array_equal(np.asarray(jp.ok), tp.ok.numpy())
    ok = np.asarray(jp.ok)
    assert ok.sum() > 20
    sign = np.sign(np.sum(np.asarray(jp.normal) * tp.normal.numpy(), axis=-1))
    np.testing.assert_allclose((tp.normal.numpy() * sign[:, None])[ok],
                               np.asarray(jp.normal)[ok], atol=5e-4)
    # the offset is -n.centroid with |centroid| up to ~50 m
    np.testing.assert_allclose((tp.offset.numpy() * sign)[ok], np.asarray(jp.offset)[ok],
                               atol=5e-4 * 50)


def _problem(seed=3, nc=300, ns=1000):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=4).astype(np.float32)
    q /= np.linalg.norm(q)
    pose = (q, rng.normal(size=3).astype(np.float32))
    c_xyz = rng.uniform(-20, 20, (nc, 3)).astype(np.float32)
    s_xyz = rng.uniform(-20, 20, (ns, 3)).astype(np.float32)
    ld = rng.normal(size=(nc, 3)).astype(np.float32)
    ld /= np.linalg.norm(ld, axis=-1, keepdims=True)
    pn = rng.normal(size=(ns, 3)).astype(np.float32)
    pn /= np.linalg.norm(pn, axis=-1, keepdims=True)
    corr = (rng.uniform(-20, 20, (nc, 3)).astype(np.float32), ld, rng.uniform(size=nc) > 0.3,
            pn, rng.uniform(-1, 1, ns).astype(np.float32), rng.uniform(size=ns) > 0.3)
    corr[0][~corr[2]] = np.inf  # invalid fits may carry inf: zeroed before weighting
    masks = (rng.uniform(size=nc) > 0.1, rng.uniform(size=ns) > 0.1)
    return pose, c_xyz, s_xyz, masks, corr


def test_normal_equations():
    pose, c_xyz, s_xyz, (cm, sm), corr = _problem()
    jH, jg, jst = j_normal_equations(
        jse3.Pose(*map(jnp.asarray, pose)), JBatch(jnp.asarray(c_xyz), jnp.asarray(cm)),
        JBatch(jnp.asarray(s_xyz), jnp.asarray(sm)),
        jgn.Correspondences(*map(jnp.asarray, corr)), SOLVER)
    tH, tg, tst = tgn.normal_equations(
        tse3.Pose(*map(_t, pose)), TBatch(_t(c_xyz), _t(cm)), TBatch(_t(s_xyz), _t(sm)),
        tgn.Correspondences(*map(_t, corr)), SOLVER)
    assert np.all(np.isfinite(tH.numpy()))
    scale = np.abs(np.asarray(jH)).max()
    np.testing.assert_allclose(tH.numpy(), np.asarray(jH), rtol=1e-5, atol=1e-5 * scale)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(jg)).max())
    assert int(tst[0]) == int(jst[0]) and int(tst[1]) == int(jst[1])
    np.testing.assert_allclose(float(tst[2]), float(jst[2]), rtol=1e-5)
    assert float(tst[3]) == float(jst[3])


@pytest.mark.parametrize("degenerate", [False, True])
def test_solve_delta(degenerate):
    rng = np.random.default_rng(4)
    Q, _ = np.linalg.qr(rng.normal(size=(6, 6)))
    ev = np.array([5e2, 1e3, 2e3, 4e3, 8e3, 1.6e4])
    if degenerate:
        ev[:2] = [3.0, 50.0]  # below degen_eig_thresh=100: clamped
    H = (Q * ev) @ Q.T
    g = rng.normal(size=6) * 50
    H, g = H.astype(np.float32), g.astype(np.float32)
    jd, jdeg = j_solve_delta(jnp.asarray(H), jnp.asarray(g), SOLVER)
    td, tdeg = tgn.solve_delta(_t(H), _t(g), SOLVER)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-4, atol=1e-5)
    assert bool(tdeg) == bool(jdeg) == degenerate


def test_unported_solver_branches_raise():
    cfg = preset_aloam_kitti64()
    pose = tse3.Pose.identity()
    b = TBatch(torch.zeros((4, 3)), torch.zeros(4, dtype=torch.bool))
    cm, sm = t_empty_map(cfg.corner_map), t_empty_map(cfg.surf_map)
    args = (pose, b, b, cm, sm, cfg.corner_map, cfg.surf_map)
    with pytest.raises(NotImplementedError, match="cand_k"):
        tgn.solve_scan2map(*args, SolverConfig(cand_k=8))
    with pytest.raises(NotImplementedError, match="knn_fn"):
        tgn.solve_scan2map(*args, cfg.solver, knn_fn=lambda *a, **k: None)
    with pytest.raises(NotImplementedError, match="axis_name"):
        tgn.solve_scan2map(*args, cfg.solver, axis_name="dp")
