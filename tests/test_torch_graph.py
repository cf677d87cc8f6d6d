"""Parity of the port's keyframe bank, pose graph and loop closure with the
reference, on the CPU (`align_loop` is held to the reference in
tests/test_torch_slam.py, on the slam driver's own bank, where the reference's
alignment is compiled once for both).

The reference runs jitted, in one compile: every unit below is computed by
one program from numpy inputs made with a seed. Sizes are tiny: a bank of 16
keyframes of 128 corners and 512 surfs, windows of 5 keyframes.

Tolerances, with the figure measured on the CPU beside each:
* bank and edge contents: exact (masked row writes copy their values);
* `should_add`, `detect_loop`: flags and candidate equal;
* `_edge_terms`: 1e-6 absolute (the same f32 formulas; measured 1.8e-7);
* `solve_pose_graph`: 1e-4 m and 1e-5 per quaternion component (CG in
  another summation order; measured 1.1e-6 m and 1.2e-7 on the drifted
  chain, 0 on the zero-residual graph);
* `_window_cloud`: 1e-6 m (measured 9.5e-7), masks equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agi_lidar_slam_torch import convert
from agi_lidar_slam_torch.geometry import se3 as tse3
from agi_lidar_slam_torch.graph import keyframes as tkf
from agi_lidar_slam_torch.graph import loop_closure as tlc
from agi_lidar_slam_torch.graph import pose_graph as tpg
from agi_lidar_slam_torch.pointcloud.cloud import PointBatch as TBatch
from agi_lidar_slam_tpu.geometry import se3 as jse3
from agi_lidar_slam_tpu.graph import keyframes as jkf
from agi_lidar_slam_tpu.graph import loop_closure as jlc
from agi_lidar_slam_tpu.graph import pose_graph as jpg
from agi_lidar_slam_tpu.pointcloud.cloud import PointBatch as JBatch
from tests._torch_threads import torch_one_thread  # noqa: F401 (autouse)

K, NC, NS = 16, 128, 512  # bank capacity, corner and surf slots
E = 32  # edge capacity
N_KF = 12  # live keyframes of the loop bank
KF_DIST, KF_ANGLE = 1.0, 0.2
LOOP = jlc.LoopConfig(radius=3.0, min_stamp_sep=5)
T_LOOP = convert.config_from_reference(LOOP)
# (label, start, count) of the _window_cloud cases, window of 5 in a bank of 16
WINDOWS = {"near_end": (14, K), "near_end_partial": (13, 15), "count_below_window": (0, 3)}
# pose-graph cases and their live node counts
GRAPHS = {"drifted": 10, "zero_residual": 6, "converges_early": 3}


def _quat(axis_angle):
    a = np.asarray(axis_angle, np.float64)
    th = np.linalg.norm(a)
    if th < 1e-12:
        return np.asarray([1.0, 0.0, 0.0, 0.0], np.float32)
    return np.concatenate([[np.cos(th / 2)], np.sin(th / 2) * a / th]).astype(np.float32)


def _qmul(a, b):
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.asarray([aw * bw - ax * bx - ay * by - az * bz,
                       aw * bx + ax * bw + ay * bz - az * by,
                       aw * by - ax * bz + ay * bw + az * bx,
                       aw * bz + ax * by - ay * bx + az * bw], np.float32)


def _rot(q):
    w, x, y, z = q.astype(np.float64)
    return np.asarray([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                       [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                       [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def _world(rng):
    """Surf points on a ground plane and three walls, corner points on
    vertical lines, in the world frame."""
    g = rng.uniform(-8, 8, (3000, 2))
    ground = np.concatenate([g, np.full((3000, 1), -1.5)], 1)
    u = rng.uniform(-8, 8, (1200, 1))
    h = rng.uniform(-1.5, 2.0, (1200, 1))
    walls = np.concatenate([np.concatenate([np.full_like(u[:400], 7.5), u[:400], h[:400]], 1),
                            np.concatenate([u[400:800], np.full_like(u[:400], -6.5),
                                            h[400:800]], 1),
                            np.concatenate([u[800:], np.full_like(u[:400], 6.5), h[800:]], 1)])
    posts = np.asarray([[3.0, 2.0], [-4.0, 3.5], [5.0, -4.0], [-2.5, -3.0], [0.5, 5.0],
                        [-6.0, -1.0]])
    z = rng.uniform(-1.5, 2.0, (len(posts), 60))
    lines = np.stack([np.repeat(posts[:, :1], 60, 1), np.repeat(posts[:, 1:], 60, 1), z],
                     -1).reshape(-1, 3)
    return np.concatenate([ground, walls]), lines


def _loop_bank(rng):
    """A bank of N_KF keyframes on a 2.5 m circle whose last keyframe comes
    back next to the first: clouds are world points seen from each true pose
    (sensor frame), poses are the true ones except a drift on the last."""
    surf_w, corner_w = _world(rng)
    th = np.linspace(0, 2 * np.pi, N_KF, endpoint=False) + 0.15
    th[-1] = 2 * np.pi + 0.05
    bank = {f: np.zeros(s, dt) for f, s, dt in (
        ("q", (K, 4), np.float32), ("t", (K, 3), np.float32), ("stamp", (K,), np.int32),
        ("corner_xyz", (K, NC, 3), np.float32), ("corner_mask", (K, NC), bool),
        ("surf_xyz", (K, NS, 3), np.float32), ("surf_mask", (K, NS), bool))}
    bank["q"][:, 0] = 1.0
    for k in range(N_KF):
        q = _quat([0, 0, th[k]])
        t = np.asarray([2.5 * np.sin(th[k]), 2.5 * (1 - np.cos(th[k])), 0.0])
        R = _rot(q)
        for name, pts, n in (("corner", corner_w, NC), ("surf", surf_w, NS)):
            sel = pts[rng.choice(len(pts), n, replace=False)]
            local = (sel - t) @ R + rng.normal(scale=0.005, size=sel.shape)
            bank[f"{name}_xyz"][k] = local
            bank[f"{name}_mask"][k] = rng.uniform(size=n) > 0.1
        bank["q"][k], bank["t"][k], bank["stamp"][k] = q, t, 3 * k + 1
    # drift on the newest keyframe
    bank["q"][N_KF - 1] = _qmul(bank["q"][N_KF - 1], _quat([0.0, 0.0, 0.03]))
    bank["t"][N_KF - 1] += np.asarray([0.12, -0.08, 0.02], np.float32)
    bank["count"] = np.int32(N_KF)
    return bank


def _edges(rng, poses_q, poses_t, n_nodes, loop, gps, noise):
    """Odometry edges along the chain (measured from the true poses, with
    `noise`), an optional loop edge (n-1 -> 0) and GPS edges."""
    e = {f: np.zeros(s, dt) for f, s, dt in (
        ("i", (E,), np.int32), ("j", (E,), np.int32), ("z_q", (E, 4), np.float32),
        ("z_t", (E, 3), np.float32), ("w_rot", (E,), np.float32), ("w_trans", (E,), np.float32),
        ("kind", (E,), np.int32), ("valid", (E,), bool))}
    e["z_q"][:, 0] = 1.0
    pairs = [(a, a + 1) for a in range(n_nodes - 1)] + ([(0, n_nodes - 1)] if loop else [])
    c = 0
    for a, b in pairs:
        Ra = _rot(poses_q[a])
        dq = _qmul(poses_q[a] * np.asarray([1, -1, -1, -1], np.float32), poses_q[b])
        dt = (poses_t[b] - poses_t[a]) @ Ra
        e["z_q"][c] = _qmul(dq, _quat(rng.normal(scale=noise, size=3)))
        e["z_t"][c] = dt + rng.normal(scale=noise, size=3)
        e["i"][c], e["j"][c] = a, b
        e["w_rot"][c], e["w_trans"][c], e["valid"][c] = 1e4, 1e4, True
        c += 1
    for node in gps:
        e["i"][c] = e["j"][c] = node
        e["z_t"][c] = poses_t[node] + rng.normal(scale=0.05, size=3)
        e["w_trans"][c], e["kind"][c], e["valid"][c] = 1.0, 1, True
        c += 1
    e["count"] = np.int32(c)
    return e


def _padded(q, t):
    """Node poses padded to the bank's K slots with identities."""
    qp = np.zeros((K, 4), np.float32)
    qp[:, 0] = 1.0
    qp[:len(q)] = q
    tp = np.zeros((K, 3), np.float32)
    tp[:len(t)] = t
    return qp, tp


def _graphs(rng):
    """(initial poses padded to K, edges) per pose-graph case."""
    out = {}
    # drifted: a circle, initial poses from integrating noisy odometry
    n = GRAPHS["drifted"]
    th = np.linspace(0, 1.8 * np.pi, n)
    tq = np.stack([_quat([0, 0, a]) for a in th])
    tt = np.stack([[4 * np.sin(a), 4 * (1 - np.cos(a)), 0.1 * a] for a in th]).astype(np.float32)
    e = _edges(rng, tq, tt, n, loop=True, gps=(3, 7), noise=2e-3)
    q0, t0 = tq.copy(), tt.copy()
    for k in range(1, n):  # drift: an accumulating yaw and offset error
        q0[k] = _qmul(tq[k], _quat([0, 0, 0.01 * k]))
        t0[k] = tt[k] + np.asarray([0.03, -0.02, 0.01]) * k
    out["drifted"] = (*_padded(q0, t0), e)
    # zero residual: identity rotations, integer translations, exact odometry
    # edges: every residual is exactly 0 in f32, so b = 0 and the reference's
    # CG takes no iteration
    n = GRAPHS["zero_residual"]
    zq = np.tile(np.asarray([1, 0, 0, 0], np.float32), (n, 1))
    zt = np.stack([[k, 2 * k, 0] for k in range(n)]).astype(np.float32)
    out["zero_residual"] = (*_padded(zq, zt), _edges(rng, zq, zt, n, loop=False, gps=(),
                                                     noise=0.0))
    # a 3-node chain with one noisy edge: CG reaches its tolerance well
    # before 30 iterations
    n = GRAPHS["converges_early"]
    cq = np.stack([_quat([0, 0, 0.2 * k]) for k in range(n)])
    ct = np.stack([[k, 0.5 * k, 0] for k in range(n)]).astype(np.float32)
    e = _edges(rng, cq, ct, n, loop=False, gps=(), noise=0.0)
    e["z_t"][1] += np.asarray([0.05, -0.03, 0.02], np.float32)
    out["converges_early"] = (*_padded(cq, ct), e)
    return out


def _inputs():
    rng = np.random.default_rng(5)
    d = {"bank": _loop_bank(rng), "graphs": _graphs(rng)}
    b = d["bank"]
    last_t = b["t"][2]
    d["gate"] = {  # poses tested against a bank whose newest keyframe is #2
        "on": (b["q"][2], last_t + np.asarray([KF_DIST + 0.01, 0, 0], np.float32)),
        "off": (b["q"][2], last_t + np.asarray([KF_DIST - 0.01, 0, 0], np.float32)),
        "angle": (_qmul(b["q"][2], _quat([0, 0, KF_ANGLE + 0.01])), last_t),
        "angle_off": (_qmul(b["q"][2], _quat([0, 0, KF_ANGLE - 0.01])), last_t),
    }
    d["new_kf"] = {"q": _quat([0.1, -0.2, 0.3]), "t": np.asarray([1.0, 2.0, 3.0], np.float32),
                   "corners": rng.normal(size=(NC, 3)).astype(np.float32),
                   "cmask": rng.uniform(size=NC) > 0.5,
                   "surfs": rng.normal(size=(NS, 3)).astype(np.float32),
                   "smask": rng.uniform(size=NS) > 0.5}
    d["terms"] = _edges(rng, b["q"][:N_KF], b["t"][:N_KF], N_KF, loop=True, gps=(2, 5),
                        noise=0.01)
    d["terms"]["valid"][3] = False  # an invalid edge contributes nothing
    d["edge"] = {"z_q": _quat([0.01, 0.02, -0.03]),
                 "z_t": np.asarray([0.5, -0.25, 0.125], np.float32)}
    return d


def _jbank(b, count=None):
    return jkf.KeyframeBank(*(jnp.asarray(b[f]) for f in jkf.KeyframeBank._fields[:-1]),
                            count=jnp.int32(b["count"] if count is None else count))


def _jedges(e, count=None):
    return jpg.EdgeSet(*(jnp.asarray(e[f]) for f in jpg.EdgeSet._fields[:-1]),
                       count=jnp.int32(e["count"] if count is None else count))


@jax.jit
def _reference(d):
    out = {}
    bank3 = _jbank(d["bank"], count=3)
    out["gate"] = {name: jkf.should_add(bank3, jse3.Pose(*p), KF_DIST, KF_ANGLE)
                   for name, p in d["gate"].items()}
    out["gate"]["empty"] = jkf.should_add(_jbank(d["bank"], count=0),
                                          jse3.Pose(*d["gate"]["off"]), KF_DIST, KF_ANGLE)
    nk = d["new_kf"]
    args = (jse3.Pose(nk["q"], nk["t"]), JBatch(nk["corners"], nk["cmask"]),
            JBatch(nk["surfs"], nk["smask"]), jnp.int32(99))
    out["add"] = {"add": jkf.add_keyframe(bank3, *args, jnp.bool_(True)),
                  "skip": jkf.add_keyframe(bank3, *args, jnp.bool_(False)),
                  "full": jkf.add_keyframe(_jbank(d["bank"], count=K), *args, jnp.bool_(True))}
    z = jse3.Pose(d["edge"]["z_q"], d["edge"]["z_t"])
    out["add_edge"] = {
        "add": jpg.add_edge(_jedges(d["terms"]), 4, 7, z, 2.0, 3.0, kind=0,
                            do_add=jnp.bool_(True)),
        "skip": jpg.add_edge(_jedges(d["terms"]), 4, 7, z, 2.0, 3.0, kind=1,
                             do_add=jnp.bool_(False)),
        "full": jpg.add_edge(_jedges(d["terms"], count=E), 4, 7, z, 2.0, 3.0, kind=1)}
    bank = _jbank(d["bank"])
    out["terms"] = jpg._edge_terms(bank.q, bank.t, _jedges(d["terms"]))
    # the three graphs through one traced solve
    names = sorted(GRAPHS)
    args = jax.tree.map(lambda *a: jnp.stack(a), *[
        (*d["graphs"][n], jnp.int32(GRAPHS[n])) for n in names])
    solved = jax.lax.map(lambda a: jpg.solve_pose_graph(jse3.Pose(a[0], a[1]), a[3],
                                                        _jedges(a[2])), args)
    out["graphs"] = {n: jax.tree.map(lambda x, i=i: x[i], solved) for i, n in enumerate(names)}
    # the early-converging case with a CG cut to 12 iterations: equal to the
    # 30-iteration solve when the CG stopped before 12
    q0, t0, e = d["graphs"]["converges_early"]
    out["cg12"] = jpg.solve_pose_graph(jse3.Pose(q0, t0), jnp.int32(GRAPHS["converges_early"]),
                                       _jedges(e), n_cg_iters=12)
    out["detect"] = {"found": jlc.detect_loop(bank, jnp.int32(N_KF - 1), LOOP),
                     "none": jlc.detect_loop(bank3, jnp.int32(1), LOOP)}
    out["window"] = {name: jlc._window_cloud(bank.surf_xyz, bank.surf_mask, bank.q, bank.t,
                                             jnp.int32(start), 5, jnp.int32(count))
                     for name, (start, count) in WINDOWS.items()}
    return out


@pytest.fixture(scope="module")
def ref():
    d = _inputs()
    return d, jax.tree.map(np.asarray, _reference(d))


def _tbank(b, count=None):
    return tkf.KeyframeBank(*(torch.from_numpy(np.array(b[f])) for f in
                              tkf.KeyframeBank._fields[:-1]),
                            count=torch.tensor(int(b["count"] if count is None else count),
                                               dtype=torch.int32))


def _tedges(e, count=None):
    return tpg.EdgeSet(*(torch.from_numpy(np.array(e[f])) for f in tpg.EdgeSet._fields[:-1]),
                       count=torch.tensor(int(e["count"] if count is None else count),
                                          dtype=torch.int32))


def _tpose(q, t):
    return tse3.Pose(torch.from_numpy(np.array(q)), torch.from_numpy(np.array(t)))


def _equal_tuple(tup, jtup):
    for f in tup._fields:
        np.testing.assert_array_equal(getattr(tup, f).numpy(), np.asarray(getattr(jtup, f)),
                                      err_msg=f)


@pytest.mark.parametrize("case", ["on", "off", "angle", "angle_off", "empty"])
def test_should_add(ref, case):
    d, out = ref
    pose = _tpose(*d["gate"]["off" if case == "empty" else case])
    bank = _tbank(d["bank"], count=0 if case == "empty" else 3)
    got = tkf.should_add(bank, pose, KF_DIST, KF_ANGLE)
    assert bool(got) == bool(out["gate"][case])
    assert bool(got) == (case in ("on", "angle", "empty"))


@pytest.mark.parametrize("case", ["add", "skip", "full"])
def test_add_keyframe(ref, case):
    d, out = ref
    nk = d["new_kf"]
    bank = _tbank(d["bank"], count=K if case == "full" else 3)
    kept = [t.clone() for t in bank]
    new, idx = tkf.add_keyframe(
        bank, _tpose(nk["q"], nk["t"]),
        TBatch(torch.from_numpy(nk["corners"]), torch.from_numpy(nk["cmask"])),
        TBatch(torch.from_numpy(nk["surfs"]), torch.from_numpy(nk["smask"])),
        torch.tensor(99, dtype=torch.int32), torch.tensor(case != "skip"))
    jnew, jidx = out["add"][case]
    _equal_tuple(new, jnew)
    assert int(idx) == int(jidx)
    assert int(new.count) == {"add": 4, "skip": 3, "full": K}[case]
    assert all(torch.equal(a, b) for a, b in zip(kept, bank))  # the input is not modified


@pytest.mark.parametrize("case", ["add", "skip", "full"])
def test_add_edge(ref, case):
    d, out = ref
    e = _tedges(d["terms"], count=E if case == "full" else None)
    z = _tpose(d["edge"]["z_q"], d["edge"]["z_t"])
    kind = 0 if case == "add" else 1
    if case == "full":  # Python numbers, as the reference's default do_add=True
        got = tpg.add_edge(e, 4, 7, z, 2.0, 3.0, kind=kind)
    else:  # tensors, as the drivers pass them
        got = tpg.add_edge(e, torch.tensor(4, dtype=torch.int32), torch.tensor(7), z,
                           2.0, torch.tensor(3.0), kind=kind, do_add=torch.tensor(case == "add"))
    _equal_tuple(got, out["add_edge"][case])
    assert int(got.count) == {"add": int(d["terms"]["count"]) + 1,
                              "skip": int(d["terms"]["count"]), "full": E}[case]


def test_edge_terms(ref):
    d, out = ref
    bank = _tbank(d["bank"])
    got = tpg._edge_terms(bank.q, bank.t, _tedges(d["terms"]))
    for g, j in zip(got, out["terms"]):
        np.testing.assert_allclose(g.numpy(), j, rtol=0, atol=1e-6)
    assert not np.any(out["terms"][3][3])  # the invalid edge weighs nothing


def _solve(d, name, **kw):
    q0, t0, e = d["graphs"][name]
    return tpg.solve_pose_graph(_tpose(q0, t0), torch.tensor(GRAPHS[name], dtype=torch.int32),
                                _tedges(e), **kw)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_solve_pose_graph(ref, name):
    d, out = ref
    got = _solve(d, name)
    jq, jt = out["graphs"][name]
    assert np.all(np.isfinite(got.t.numpy())) and np.all(np.isfinite(got.q.numpy()))
    np.testing.assert_allclose(got.t.numpy(), jt, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.q.numpy(), jq, rtol=0, atol=1e-5)
    n = GRAPHS[name]
    # nodes past the live count are frozen
    np.testing.assert_array_equal(got.t.numpy()[n:], 0.0)
    if name == "drifted":  # the loop and GPS edges pull the chain back
        t0 = d["graphs"][name][1]
        err0 = np.abs(t0[n - 1] - got.t.numpy()[n - 1]).max()
        assert err0 > 0.1, err0
    if name == "zero_residual":  # no iteration: the poses come back unchanged
        np.testing.assert_array_equal(got.t.numpy()[:n], d["graphs"][name][1][:n])


def test_cg_stops_before_30_iterations(ref):
    """Cut to 12 iterations, the early-converging solve equals the
    30-iteration one bit for bit, in both implementations: the frozen state
    does not move once the stop test holds."""
    d, out = ref
    np.testing.assert_array_equal(out["cg12"][1], out["graphs"]["converges_early"][1])
    full, cut = _solve(d, "converges_early"), _solve(d, "converges_early", n_cg_iters=12)
    assert torch.equal(full.t, cut.t) and torch.equal(full.q, cut.q)
    # while 2 iterations are not enough
    assert not torch.equal(full.t, _solve(d, "converges_early", n_cg_iters=2).t)


@pytest.mark.parametrize("case", ["found", "none"])
def test_detect_loop(ref, case):
    d, out = ref
    bank = _tbank(d["bank"], count=None if case == "found" else 3)
    cur = N_KF - 1 if case == "found" else 1
    cand, found = tlc.detect_loop(bank, torch.tensor(cur, dtype=torch.int32), T_LOOP)
    jcand, jfound = out["detect"][case]
    assert int(cand) == int(jcand) and bool(found) == bool(jfound)
    # "none": the three live keyframes are all within 5 stamps of each other,
    # so every distance is inf and both libraries return the first index
    assert (int(cand), bool(found)) == ((0, True) if case == "found" else (0, False))


@pytest.mark.parametrize("case", sorted(WINDOWS))
def test_window_cloud(ref, case):
    d, out = ref
    bank = _tbank(d["bank"])
    start, count = WINDOWS[case]
    xyz, mask = tlc._window_cloud(bank.surf_xyz, bank.surf_mask, bank.q, bank.t,
                                  torch.tensor(start, dtype=torch.int32), 5,
                                  torch.tensor(count, dtype=torch.int32))
    jxyz, jmask = out["window"][case]
    np.testing.assert_array_equal(mask.numpy(), jmask)
    np.testing.assert_allclose(xyz.numpy(), jxyz, rtol=0, atol=1e-6)


def test_window_cloud_capacity_below_window(ref):
    """A window larger than the bank: the reference refuses it while tracing
    (lax.dynamic_slice), the port with a ValueError."""
    d, _ = ref
    b = {f: np.asarray(v)[:4] for f, v in d["bank"].items() if f != "count"}
    with pytest.raises(TypeError):
        jlc._window_cloud(jnp.asarray(b["surf_xyz"]), jnp.asarray(b["surf_mask"]),
                          jnp.asarray(b["q"]), jnp.asarray(b["t"]), jnp.int32(0), 5,
                          jnp.int32(4))
    with pytest.raises(ValueError, match="larger than the bank"):
        tlc._window_cloud(*(torch.from_numpy(b[f]) for f in ("surf_xyz", "surf_mask", "q", "t")),
                          torch.tensor(0), 5, torch.tensor(4))



def test_sharded_solve_on_one_rank(ref):
    """The edge-sharded solve on a one-rank gloo group gives solve_pose_graph's
    poses bit for bit (one rank: the same sums), as does the solve body with
    group=None; each held to the reference too. The 2-rank solve is in
    tests/test_torch_parallel.py."""
    import torch.distributed as dist

    from agi_lidar_slam_torch.parallel.sharding import make_mesh

    d, out = ref
    q0, t0, e = d["graphs"]["drifted"]
    args = (_tpose(q0, t0), torch.tensor(GRAPHS["drifted"], dtype=torch.int32), _tedges(e))
    plain = _solve(d, "drifted")
    q, t = tpg._solve_body(args[0].q, args[0].t, args[1], args[2], 5, 30, 1e6, 1e-3,
                           group=None)
    assert torch.equal(q, plain.q) and torch.equal(t, plain.t)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        got = tpg.sharded_solve_pose_graph(make_mesh(device="cpu"), *args)
    finally:
        dist.destroy_process_group()
    assert torch.equal(got.q, plain.q) and torch.equal(got.t, plain.t)
    np.testing.assert_allclose(got.t.numpy(), out["graphs"]["drifted"][1], rtol=0, atol=1e-4)
