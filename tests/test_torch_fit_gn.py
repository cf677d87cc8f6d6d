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

from agi_lidar_slam_torch.convert import config_from_reference as port_cfg
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
from tests._torch_threads import torch_one_thread  # noqa: F401 (autouse)

SOLVER = SolverConfig()
T_SOLVER = port_cfg(SOLVER)  # the port's own SolverConfig, same fields

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
        tgn.Correspondences(*map(_t, corr)), T_SOLVER)
    assert np.all(np.isfinite(tH.numpy()))
    scale = np.abs(np.asarray(jH)).max()
    np.testing.assert_allclose(tH.numpy(), np.asarray(jH), rtol=1e-5, atol=1e-5 * scale)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(jg)).max())
    assert int(tst[0]) == int(jst[0]) and int(tst[1]) == int(jst[1])
    np.testing.assert_allclose(float(tst[2]), float(jst[2]), rtol=1e-5)
    assert float(tst[3]) == float(jst[3])


@pytest.mark.parametrize("degenerate", [False, True, "rank_deficient", "just_below",
                                        "just_above", "nonfinite"])
def test_solve_delta(degenerate):
    """solve_delta through the eigendecomposition wrapper (estimators/sym_eig:
    torch.linalg.eigh itself on the CPU) against the reference's: a full-rank
    H, two eigenvalues below degen_eig_thresh = 100, an H of rank 4 (two
    eigenvalues at zero), and the smallest eigenvalue 1% below and 1% above
    the threshold: clamped and kept on both sides alike. (It stays 400 from
    the next one: an eigenvector's f32 error is about 1e-7 of the largest
    eigenvalue over the gap, and a gap of a few units would mix a kept and
    a clamped direction by more than the tolerance in either library.)"""
    from agi_lidar_slam_torch.estimators.sym_eig import sym_eig

    if degenerate == "nonfinite":
        # a NaN entry: jnp.linalg.eigh gives NaN, so the reference's step is
        # all NaN and flagged degenerate; the port's must be too (CPU eigh
        # itself raises on such a matrix)
        b = np.random.default_rng(0).normal(size=(6, 6))
        H = (b @ b.T * 100).astype(np.float32)
        H[2, 3] = H[3, 2] = np.nan
        g = np.ones(6, np.float32)
        jd, jdeg = j_solve_delta(jnp.asarray(H), jnp.asarray(g), SOLVER)
        td, tdeg = tgn.solve_delta(_t(H), _t(g), T_SOLVER)
        assert np.all(np.isnan(np.asarray(jd))) and np.all(np.isnan(td.numpy()))
        assert bool(jdeg) and bool(tdeg)
        return
    rng = np.random.default_rng(4)
    Q, _ = np.linalg.qr(rng.normal(size=(6, 6)))
    ev = np.array([5e2, 1e3, 2e3, 4e3, 8e3, 1.6e4])
    if degenerate is True:
        ev[:2] = [3.0, 50.0]  # below degen_eig_thresh=100: clamped
    elif degenerate == "rank_deficient":
        ev[:2] = 0.0
    elif degenerate in ("just_below", "just_above"):
        ev[0] = 99.0 if degenerate == "just_below" else 101.0
    H = (Q * ev) @ Q.T
    g = rng.normal(size=6) * 50
    H, g = H.astype(np.float32), g.astype(np.float32)
    jd, jdeg = j_solve_delta(jnp.asarray(H), jnp.asarray(g), SOLVER)
    td, tdeg = tgn.solve_delta(_t(H), _t(g), T_SOLVER)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-4, atol=1e-5)
    assert bool(tdeg) == bool(jdeg) == (degenerate not in (False, "just_above"))
    vals, vecs = sym_eig(_t(H))  # on the CPU, the plain version: eigh itself
    ref_vals, ref_vecs = torch.linalg.eigh(_t(H))
    assert torch.equal(vals, ref_vals) and torch.equal(vecs, ref_vecs)
    if degenerate in ("just_below", "just_above"):
        assert abs(float(vals[0]) - ev[0]) < 0.01


def test_sym_eig_cpu_is_eigh_and_nan_stays_in_its_matrix():
    """On the CPU, sym_eig of finite matrices is torch.linalg.eigh bit for
    bit, also in a batch that holds a non-finite matrix: only that matrix's
    outputs are NaN. Like the card's kernel it reads the lower triangle
    only: a NaN above the diagonal leaves eigh's numbers. The two-step
    solver's 3-dof solve gives a NaN step flagged degenerate on a
    non-finite system, as solve_delta does."""
    from agi_lidar_slam_torch.estimators.sym_eig import sym_eig
    from agi_lidar_slam_torch.estimators.two_step import _CORNER_IDX, _solve_subset

    rng = np.random.default_rng(6)
    J = rng.normal(size=(5, 18, 6)) * rng.uniform(1, 300, (5, 1, 1))
    a = _t((J.transpose(0, 2, 1) @ J).astype(np.float32))
    ref_vals, ref_vecs = torch.linalg.eigh(a)
    vals, vecs = sym_eig(a)
    assert torch.equal(vals, ref_vals) and torch.equal(vecs, ref_vecs)
    bad = a.clone()
    bad[2, 3, 2] = float("inf")
    vals, vecs = sym_eig(bad)
    keep = [0, 1, 3, 4]
    assert torch.equal(vals[keep], ref_vals[keep]) and torch.equal(vecs[keep], ref_vecs[keep])
    assert bool(torch.isnan(vals[2]).all()) and bool(torch.isnan(vecs[2]).all())
    upper = a.clone()
    upper[1, 0, 5] = float("nan")
    vals, vecs = sym_eig(upper)
    assert torch.equal(vals, ref_vals) and torch.equal(vecs, ref_vecs)
    d, degen = _solve_subset(bad[2], torch.ones(6), _CORNER_IDX, 10.0)
    assert bool(torch.isnan(d[list(_CORNER_IDX)]).all()) and bool(degen)


def _scene(seed=5, n=4000):
    """Points on a floor and two walls, inserted into the preset's corner and
    surf maps, and a feature batch of every fourth point, moved a little."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(-15, 15, (n, 2)).astype(np.float32)
    side = np.arange(n) % 3
    pts = np.where(side[:, None] == 0, np.stack([u[:, 0], u[:, 1], -1.5 + 0 * u[:, 0]], -1),
                   np.where(side[:, None] == 1, np.stack([u[:, 0], 8.0 + 0 * u[:, 0], u[:, 1] / 5], -1),
                            np.stack([-9.0 + 0 * u[:, 0], u[:, 1], u[:, 0] / 5], -1)))
    pts = (pts + rng.normal(scale=0.01, size=pts.shape)).astype(np.float32)
    return pts, pts[::4] + np.float32(0.05)


def test_solver_hooks_match_plain_call():
    """The multi-device hooks of solve_scan2map: group=None is the plain
    call bit for bit, and a knn_fn that wraps nn.knn.knn (so the solver
    builds no packed-key index and probes through the hook) gives the plain
    call's pose and statistics bit for bit, with and without the candidate
    cache. An empty batch with the cache still runs."""
    from agi_lidar_slam_torch.map.hash_map import insert as t_insert
    from agi_lidar_slam_torch.nn.knn import knn as t_knn

    cfg = port_cfg(preset_aloam_kitti64())
    pose = tse3.Pose.identity(device="cpu")
    b = TBatch(torch.zeros((4, 3)), torch.zeros(4, dtype=torch.bool))
    cm, sm = t_empty_map(cfg.corner_map, "cpu"), t_empty_map(cfg.surf_map, "cpu")
    pose8, _ = tgn.solve_scan2map(pose, b, b, cm, sm, cfg.corner_map, cfg.surf_map,
                                  port_cfg(SolverConfig(cand_k=8)))
    assert bool(torch.isfinite(pose8.t).all())

    pts, feats = _scene()
    mask = torch.ones(len(pts), dtype=torch.bool)
    cm = t_insert(cm, torch.from_numpy(pts), mask, cfg.corner_map)
    sm = t_insert(sm, torch.from_numpy(pts), mask, cfg.surf_map)
    fb = TBatch(torch.from_numpy(feats), torch.ones(len(feats), dtype=torch.bool))
    calls = []

    def wrapped(m, q, qm, k, mcfg, ktab=None):
        calls.append(ktab)
        return t_knn(m, q, qm, k, mcfg, ktab=ktab)

    for solver in (cfg.solver, port_cfg(SolverConfig(cand_k=8))):
        args = (pose, fb, fb, cm, sm, cfg.corner_map, cfg.surf_map, solver)
        plain = tgn.solve_scan2map(*args)
        calls.clear()
        for hooked in (tgn.solve_scan2map(*args, group=None),
                       tgn.solve_scan2map(*args, knn_fn=wrapped)):
            for a, b_ in zip(tuple(plain[0]) + tuple(plain[1]),
                             tuple(hooked[0]) + tuple(hooked[1])):
                assert torch.equal(a, b_)
        assert calls and all(t is None for t in calls)
        assert int(plain[1].n_surf) > 200  # a real solve, not a no-op
