"""The Gauss-Newton step's kernels (estimators/gn_kernels, csrc/gn_iter.cu)
against the torch ops they replace.

On the CPU: the solvers' steps are the torch code (`step` is `step_ref`,
`two_step._step` is `_step_ref`), the launchers refuse CPU tensors, and the
kernel library's hash covers the headers. The tests marked `card` run on an
NVIDIA GPU and skip without one:

    python -m pytest tests/test_torch_gn_kernels.py --noconftest -o addopts="" \\
        -p no:cacheprovider

(--noconftest: tests/conftest.py sets up JAX, which that machine lacks.)
They record the steps of an A-LOAM (preset_aloam_kitti64_ref, 64x1800) and a
LeGO (preset_lego_vlp16_ref, 16x1800) scan on the card and hold every kernel
to the torch ops on the same inputs there, bit for bit: the kernels round as
those ops do (see the source note), and the benchmark's check holds the
solves to a torch reference that any other rounding leaves within tens of
scans (PERF.md, section 7). NaN counts as equal to NaN.
"""

import contextlib

import pytest
import torch

from agi_lidar_slam_torch import _build, presets
from agi_lidar_slam_torch.config import SolverConfig
from agi_lidar_slam_torch.estimators import gn_kernels, gn_scan2map, sym_eig, two_step
from agi_lidar_slam_torch.geometry import se3, so3
from agi_lidar_slam_torch.pointcloud.cloud import PointBatch
from agi_lidar_slam_torch.runtime import pipeline
from agi_lidar_slam_torch.sim.world import default_world, simulate_scan

SCANS = 4  # scans of each preset run on the card; the last one's steps are recorded


def _same(a, b) -> bool:
    """Bit for bit, NaN equal to NaN."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if not a.is_floating_point():
        return bool((a == b).all())
    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def _all_same(xs, ys) -> bool:
    return all(_same(x, y) for x, y in zip(xs, ys))


def _step_outputs(out):
    pose, rms, degen = out
    return pose.q, pose.t, rms, degen


def _systems(seed: int, n: int, device):
    """Random 6x6 normal equations (some with a zero direction), gradients,
    poses and stats, over several orders of magnitude."""
    g0 = torch.Generator().manual_seed(seed)

    def rnd(*s, scale=1.0):
        return ((torch.rand(*s, generator=g0) * 2 - 1) * scale).to(device)

    for k in range(n):
        J = rnd(40, 6, scale=10.0 ** (k % 4 - 1))
        H = J.T @ J
        if k % 7 == 0:
            H[0, :] = 0.0
            H[:, 0] = 0.0
        g = rnd(6, scale=10.0 ** (k % 5 - 3))
        pose = se3.Pose(so3.quat_exp(rnd(3, scale=3.0)), rnd(3, scale=50.0))
        sq = rnd((), scale=5.0).abs()
        rows = torch.randint(0, 30000, (), generator=g0).float().to(device)
        cfg = SolverConfig(degen_eig_thresh=(10.0, 100.0, 1.0)[k % 3],
                           translation_clip=(1.0, 1e-3, 0.3)[k % 3])
        yield H.contiguous(), g, pose, sq, rows, cfg


# ----------------------------------------------------------------------------- CPU


def test_cpu_steps_are_the_torch_code():
    """On CPU tensors the 6-dof step is solve_delta, boxplus and the rms, and
    the two-step solve's step _solve_subset, boxplus and the merged stats,
    bit for bit."""
    for H, g, pose, sq, rows, cfg in _systems(0, 12, "cpu"):
        d, degen = gn_scan2map.solve_delta(H, g, cfg)
        want = (se3.boxplus(pose, d), torch.sqrt(sq / torch.clamp(rows, min=1.0)), degen)
        assert _all_same(_step_outputs(gn_scan2map.step(H, g, pose, sq, rows, cfg)),
                         _step_outputs(want))
        prev = (sq * 0.5, rows + 3.0, torch.tensor(False))
        for idx in (two_step._SURF_IDX, two_step._CORNER_IDX):
            d, degen = two_step._solve_subset(H, g, idx, cfg.degen_eig_thresh)
            want = (se3.boxplus(pose, d),
                    torch.sqrt((prev[0] + sq) / torch.clamp(prev[1] + rows, min=1.0)),
                    prev[2] | degen)
            assert _all_same(_step_outputs(two_step._step(H, g, idx, pose, cfg, sq, rows, prev)),
                             _step_outputs(want))


def test_launchers_refuse_cpu_tensors():
    pose = se3.Pose.identity(device="cpu")
    z = torch.zeros(())
    with pytest.raises(ValueError, match="cuda"):
        gn_kernels.rotation(pose.q)
    with pytest.raises(ValueError, match="cuda"):
        gn_kernels.update(torch.zeros(6), torch.ones(6, dtype=torch.bool), pose, 1.0, z, z)
    with pytest.raises(ValueError, match="cuda"):
        gn_kernels.subset_step(torch.eye(6), torch.zeros(6), (0, 1, 5), 10.0, pose, z, z)


def test_library_hash_covers_headers(tmp_path, monkeypatch):
    """An edited header (csrc/*.cuh) names another library, so it rebuilds."""
    (tmp_path / "a.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "SRC_DIR", tmp_path)
    first = _build.library_path()
    (tmp_path / "h.cuh").write_text("// two\n")
    assert _build.library_path() != first


# ----------------------------------------------------------------------------- card


@contextlib.contextmanager
def _patched(pairs):
    saved = [(m, n, getattr(m, n)) for m, n, _ in pairs]
    for m, n, f in pairs:
        setattr(m, n, f)
    try:
        yield
    finally:
        for m, n, f in saved:
            setattr(m, n, f)


def _arc_scans(dev, rings, fov_up, fov_down):
    """The arc of tests/test_reference_presets.py (0.35 m and 0.03 rad a
    scan from rest) in default_world(2, 30 m), at rings x 1800."""
    world = default_world(seed=2, extent=30.0, device=dev)
    yaw = so3.quat_exp(torch.tensor([0.0, 0.0, 0.03], device=dev))
    fwd = torch.tensor([0.35, 0.0, 0.0], device=dev)
    q, t = so3.quat_identity(device=dev), torch.zeros(3, device=dev)
    scans = []
    for i in range(SCANS):
        p0 = se3.Pose(q, t)
        q = so3.quat_normalize(so3.quat_mul(q, yaw))
        t = t + so3.quat_rotate(q, fwd)
        scans.append(simulate_scan(world, p0, se3.Pose(q, t), rings=rings, width=1800,
                                   noise_std=0.005, seed=i, fov_up_deg=fov_up,
                                   fov_down_deg=fov_down))
    return scans


def _record(cfg, scans):
    """Run process_scan over `scans` and record, for the last scan, every
    normal-equations call's arguments, every step's arguments (6-dof and
    two-step) and the scan-to-map solve's."""
    rec = {"ne": [], "six": [], "subset": [], "solve": None}
    on = [False]
    real_ne, real_step, real_sub = gn_scan2map.normal_equations, gn_scan2map.step, two_step._step
    real_solves = pipeline.solve_scan2map, pipeline.solve_scan2map_two_step

    def ne(pose, corners, surfs, corr, scfg):
        if on[0]:
            rec["ne"].append((se3.Pose(pose.q.clone(), pose.t.clone()), corners, surfs,
                              type(corr)(*(x.clone() for x in corr)), scfg))
        return real_ne(pose, corners, surfs, corr, scfg)

    def six(H, g, pose, sq, rows, scfg):
        if on[0]:
            rec["six"].append((H.clone(), g.clone(), pose, sq.clone(), rows.clone(), scfg))
        return real_step(H, g, pose, sq, rows, scfg)

    def sub(H, g, idx, pose, scfg, sq, rows, prev=None):
        if on[0]:
            rec["subset"].append((H.clone(), g.clone(), idx, pose, scfg, sq.clone(),
                                  rows.clone(), prev))
        return real_sub(H, g, idx, pose, scfg, sq, rows, prev)

    def solver(real):
        def spy(*a, **kw):  # the scan-to-map solve is the scan's last
            if on[0]:
                rec["solve"] = (real, a, kw)
            return real(*a, **kw)
        return spy

    pairs = [(gn_scan2map, "normal_equations", ne), (two_step, "normal_equations", ne),
             (gn_scan2map, "step", six), (two_step, "_step", sub),
             (pipeline, "solve_scan2map", solver(real_solves[0])),
             (pipeline, "solve_scan2map_two_step", solver(real_solves[1]))]
    state = pipeline.init_state(cfg, scans[0].xyz.device)
    with _patched(pairs):
        for i, s in enumerate(scans):
            on[0] = i == len(scans) - 1
            state, _ = pipeline.process_scan(state, s, cfg)
    torch.cuda.synchronize()
    return rec


@pytest.fixture(scope="module")
def recorded():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for name, cfg, rings, fov in (("aloam", presets.preset_aloam_kitti64_ref(), 64, (2.0, -24.8)),
                                  ("lego", presets.preset_lego_vlp16_ref(), 16, (15.0, -15.0))):
        out[name] = (cfg, _record(cfg, _arc_scans(dev, rings, *fov)))
    return out


@pytest.mark.card
@pytest.mark.parametrize("preset", ["aloam", "lego"])
def test_rows_bit_for_bit(recorded, preset):
    """gn_rotation and gn_rows against the torch rows on every recorded
    normal-equations call (A-LOAM: the odometry stage's 768 and 1536 rows and
    the scan-to-map solve's 2048 and 8192; LeGO 1024 and 4096)."""
    cfg, rec = recorded[preset]
    assert rec["ne"]
    for args in rec["ne"]:
        assert _all_same(gn_scan2map._rows(*args), gn_scan2map.rows_ref(*args))


@pytest.mark.card
def test_masked_rows_with_nonfinite_fits(recorded):
    """inf in the fits of rows whose ok is false: the kernel's rows are the
    torch rows still, and the weighted residuals stay finite."""
    cfg, rec = recorded["aloam"]
    pose, corners, surfs, corr, scfg = rec["ne"][-1]
    bad_c, bad_s = ~corr.ok_c, ~corr.ok_s
    assert bool(bad_c.any()) and bool(bad_s.any())
    poisoned = corr._replace(
        line_centroid=torch.where(bad_c[:, None], float("inf"), corr.line_centroid),
        plane_d=torch.where(bad_s, float("-inf"), corr.plane_d))
    got = gn_scan2map._rows(pose, corners, surfs, poisoned, scfg)
    assert _all_same(got, gn_scan2map.rows_ref(pose, corners, surfs, poisoned, scfg))
    assert bool(torch.isfinite(got[0]).all()) and bool(torch.isfinite(got[2]).all())


@pytest.mark.card
def test_rows_of_halves_are_the_rows_of_the_whole(recorded):
    """A dp-sharded step linearizes each rank's block of points: the rows of
    each half are the whole's rows (the sums over them are torch's)."""
    cfg, rec = recorded["aloam"]
    pose, corners, surfs, corr, scfg = rec["ne"][-1]
    whole = gn_scan2map._rows(pose, corners, surfs, corr, scfg)
    nc, ns = corners.xyz.shape[0] // 2, surfs.xyz.shape[0] // 2
    for sc, ss in ((slice(0, nc), slice(0, ns)), (slice(nc, None), slice(ns, None))):
        part = gn_scan2map.Correspondences(corr.line_centroid[sc], corr.line_dir[sc],
                                           corr.ok_c[sc], corr.plane_n[ss], corr.plane_d[ss],
                                           corr.ok_s[ss])
        got = gn_scan2map._rows(pose, PointBatch(corners.xyz[sc], corners.mask[sc]),
                                PointBatch(surfs.xyz[ss], surfs.mask[ss]), part, scfg)
        assert _all_same(got, (whole[0][sc], whole[1][sc], whole[2][ss], whole[3][ss]))


@pytest.mark.card
def test_update_bit_for_bit(recorded):
    """gn_update (the 6-dof step after `_delta`) against step_ref: on every
    recorded A-LOAM step and on random systems with clamped directions, the
    clip engaged and the small-angle branch of the exponential; and on a
    system of masked rows only, which is degenerate."""
    dev = torch.device("cuda", 0)
    cases = list(recorded["aloam"][1]["six"]) + list(_systems(1, 600, dev))
    cases.append((torch.zeros(6, 6, device=dev), torch.zeros(6, device=dev),
                  se3.Pose.identity(device=dev), torch.zeros((), device=dev),
                  torch.zeros((), device=dev), SolverConfig()))
    for H, g, pose, sq, rows, cfg in cases:
        got = gn_scan2map.step(H, g, pose, sq, rows, cfg)
        assert _all_same(_step_outputs(got), _step_outputs(
            gn_scan2map.step_ref(H, g, pose, sq, rows, cfg)))
    assert bool(got[2]) and torch.equal(got[0].t, se3.Pose.identity(device=dev).t)


@pytest.mark.card
def test_subset_step_bit_for_bit(recorded):
    """gn_subset (the two-step solve's step) against _step_ref: on every
    recorded LeGO step (the surf step, and the corner step with the surf
    step's stats merged) and on random systems, both subsets."""
    dev = torch.device("cuda", 0)
    cases = list(recorded["lego"][1]["subset"])
    assert {c[2] for c in cases} == {two_step._SURF_IDX, two_step._CORNER_IDX}
    for H, g, pose, sq, rows, cfg in _systems(2, 300, dev):
        prev = (sq * 0.5, rows + 3.0, torch.rand((), device=dev) > 0.5)
        for idx in (two_step._SURF_IDX, two_step._CORNER_IDX):
            cases += [(H, g, idx, pose, cfg, sq, rows, None),
                      (H, g, idx, pose, cfg, sq, rows, prev)]
    for args in cases:
        assert _all_same(_step_outputs(two_step._step(*args)),
                         _step_outputs(two_step._step_ref(*args)))


@pytest.mark.card
@pytest.mark.parametrize("preset", ["aloam", "lego"])
def test_solve_launches_and_is_the_torch_solve(recorded, preset):
    """The recorded scan-to-map solve again: gn_rotation and gn_rows once a
    normal-equations call, gn_update once a 6-dof step (with its sym_eig),
    gn_subset once a two-step step (no sym_eig); the pose and stats equal,
    bit for bit, to the same solve with the torch ops."""
    cfg, rec = recorded[preset]
    real, args, kw = rec["solve"]
    solver = args[7]
    iters = solver.n_outer * solver.n_inner
    gn_kernels.launches.update(dict.fromkeys(gn_kernels.launches, 0))
    sym_eig.launches = 0
    pose, stats = real(*args, **kw)
    torch.cuda.synchronize()
    if cfg.two_step:
        want = {"gn_rotation": 2 * iters, "gn_rows": 2 * iters, "gn_update": 0,
                "gn_subset": 2 * iters}
    else:
        want = {"gn_rotation": iters, "gn_rows": iters, "gn_update": iters, "gn_subset": 0}
    assert gn_kernels.launches == want
    assert sym_eig.launches == (0 if cfg.two_step else iters)
    with _patched([(gn_scan2map, "_rows", gn_scan2map.rows_ref),
                   (gn_scan2map, "step", gn_scan2map.step_ref),
                   (two_step, "_step", two_step._step_ref)]):
        p_ref, s_ref = real(*args, **kw)
    assert _all_same((pose.q, pose.t, *stats), (p_ref.q, p_ref.t, *s_ref))


@pytest.mark.card
def test_versions_are_the_measured_ones():
    """torch, its CUDA and cuBLAS are the versions whose rounding orders the
    kernels copy: on others the tests above may fail for that alone."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.zeros(1, device="cuda")
    assert gn_kernels.versions() == gn_kernels.MEASURED_ON


@pytest.mark.card
def test_subset_step_takes_three_dofs(recorded):
    dev = torch.device("cuda", 0)
    z = torch.zeros((), device=dev)
    with pytest.raises(ValueError, match="three"):
        gn_kernels.subset_step(torch.eye(6, device=dev), torch.zeros(6, device=dev), (0, 1),
                               10.0, se3.Pose.identity(device=dev), z, z)
