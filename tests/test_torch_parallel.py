"""The port's multi-device layer (agi_lidar_slam_torch/parallel/) on two
gloo ranks on the CPU, against the JAX package.

One module fixture spawns 2 ranks once through parallel/launch.py (from a
thread, so that the JAX references compile while they run); `launch_two`
gives it and the other files' two-rank tests their settings: a FileStore rendezvous under
the test's temporary directory (so parallel test workers never share a
port), one torch thread per rank, a 120 s process-group timeout and a 180 s
deadline for the whole group. The ranks run the dp and mp odometry steps,
the map-sharded KNN and insert and the edge-sharded pose graph, and write
their results as npz files; each rank builds its state alike and the inputs
come from the parent as numpy arrays: the JAX parity tests' own
(tests/test_sharding_parity.py's `make_scans`: preset_sim16 at 16x432 for 3
scans, made by the port's simulator, whose parity with the reference's is
tests/test_torch_sim.py; tests/_dist_worker.py's pose graph), and
tests/test_map_shard.py's KNN and insert sizes with points made by numpy.
The parent holds them against the JAX package on the CPU: its single-device
scan step (which its own tests pin to its sharded steps), and directly its
sharded_knn, sharded_insert and sharded_solve_pose_graph on a 2-device mesh
of conftest's virtual CPU devices.

The dp steps of the three IMU engines run on two ranks from `engine_rank`
inside tests/test_torch_lio.py, test_torch_livox.py and test_torch_slam.py,
against the reference runs those files already make (a JAX engine compiles
for 7-20 s on the CPU: so each reference program compiles once in the suite).

Tolerances are the JAX package's own: dp and mp odometry 1e-4 m with equal
occupancy (test_sharding_parity.py:79,109-111: the sharded sums reassociate
the f32 reductions); LIO, livox and LIO-SAM 5e-3 m with equal surf
occupancy (:163-165,186-188,211-213); the pose graph 1e-5
(test_distributed_multiprocess.py); KNN distances 1e-5 relative and 1e-6
absolute (test_map_shard.py), the inserted maps equal.

This file imports JAX only inside its reference fixtures: a spawned rank
imports the file and never starts JAX.
"""

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from agi_lidar_slam_torch.parallel.launch import launch
from tests._torch_threads import torch_one_thread  # noqa: F401 (autouse)

N_SCANS = 3
ODOM_T_TOL = 1e-4
IMU_T_TOL = 5e-3
GRAPH_TOL = 1e-5


def launch_two(fn, args, out_dir) -> list:
    """fn(rank, out_dir, *args) on two gloo ranks of the CPU; returns both
    ranks' results, which fn writes with `save_rank`."""
    launch(fn, 2, (str(out_dir),) + tuple(args), device="cpu", backend="gloo", threads=1,
           rendezvous_dir=str(out_dir), init_timeout_s=120.0, deadline_s=180.0)
    return [dict(np.load(os.path.join(out_dir, f"rank{r}.npz"))) for r in range(2)]


def save_rank(out_dir, rank: int, out: dict) -> None:
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), threads=torch.get_num_threads(), **out)


def engine_rank(rank, out_dir, engine, cfg, runs):
    """The dp step of one IMU engine ("lio", "livox" or "liosam") on this
    rank: each run (state, items) steps through its items from its state.
    The pose and the surf map's occupancy after every step are saved."""
    from agi_lidar_slam_torch.parallel import distributed as pdist
    from agi_lidar_slam_torch.parallel import sharding as sh

    dp = pdist.make_mesh_2d(dp=2, mp=1, device="cpu")
    step = getattr(sh, f"sharded_{engine}_step")
    t, occ = [], []
    for state, items in runs:
        for item in items:
            state, res = step(dp, state, *item, cfg)
            t.append((res.x.p if engine == "lio" else res.pose.t).numpy())
            surf = (state.map if engine == "lio" else
                    state.engine.surf_map if engine == "liosam" else state.surf_map)
            occ.append(int(surf.occ.sum()))
    save_rank(out_dir, rank, {"t": np.stack(t), "occ": np.asarray(occ)})


def check_engine_ranks(ranks, want_t, want_occ) -> None:
    """Both ranks alike, bit for bit; each step's pose within IMU_T_TOL of
    the reference's, the surf map's occupancy equal."""
    a, b = ranks
    for k in ("t", "occ", "threads"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert int(a["threads"]) == 1
    np.testing.assert_allclose(a["t"], np.stack([np.asarray(t) for t in want_t]), rtol=0,
                               atol=IMU_T_TOL)
    np.testing.assert_array_equal(a["occ"], [int(np.asarray(o).sum()) for o in want_occ])


def _odom_scans() -> list:
    """tests/test_sharding_parity.py's make_scans(3), from the port's
    simulator, as numpy."""
    from agi_lidar_slam_torch.geometry import se3, so3
    from agi_lidar_slam_torch.sim.world import default_world, simulate_scan

    world = default_world(seed=11, n_pillars=20, extent=14.0, device="cpu")
    q, t = so3.quat_identity(device="cpu"), torch.zeros(3)
    scans = []
    for i in range(N_SCANS):
        p = se3.Pose(q, t)
        q = so3.quat_normalize(so3.quat_mul(q, so3.quat_exp(torch.tensor([0.0, 0.0, 0.02]))))
        t = t + so3.quat_rotate(q, torch.tensor([0.3, 0.0, 0.0]))
        s = simulate_scan(world, p, se3.Pose(q, t), rings=16, width=432, noise_std=0.004,
                          seed=40 + i)
        scans.append(tuple(a.numpy() for a in s))
    return scans


def _map_inputs():
    """test_map_shard.py's sizes, uniform points made with numpy."""
    rng = np.random.default_rng(0)
    return {"insert": rng.uniform(-8, 8, (4000, 3)).astype(np.float32),
            "map": rng.uniform(-6, 6, (6000, 3)).astype(np.float32),
            "queries": rng.uniform(-5, 5, (512, 3)).astype(np.float32),
            "steps": [rng.uniform(-8, 8, (1500, 3)).astype(np.float32) for _ in range(3)]}


@pytest.fixture(scope="module")
def cases():
    """The reference configs, their port counterparts, and the inputs as
    numpy: the JAX parity tests' own scans, map points and pose graph."""
    from agi_lidar_slam_torch.convert import config_from_reference
    from agi_lidar_slam_tpu.config import preset_sim16
    from tests._dist_worker import build_problem
    from tests.test_map_shard import CFG as MAP_CFG

    jcfg = {"odom": preset_sim16(), "map": MAP_CFG}
    poses, n_nodes, edges = build_problem()
    graph = {"q": np.asarray(poses.q), "t": np.asarray(poses.t), "n": int(n_nodes),
             "edges": {f: np.asarray(getattr(edges, f)) for f in edges._fields}}
    return {"jcfg": jcfg, "tcfg": {k: config_from_reference(v) for k, v in jcfg.items()},
            "odom": _odom_scans(), "maps": _map_inputs(), "graph": graph}


# ---- the ranks (no JAX here) ----------------------------------------------

def _t(a):
    return torch.from_numpy(np.array(a))


def _rank_work(rank, out_dir, tcfg, odom, maps, graph):
    """Every sharded function on this rank; results to rank{rank}.npz."""
    from agi_lidar_slam_torch.geometry import se3
    from agi_lidar_slam_torch.graph import pose_graph as tpg
    from agi_lidar_slam_torch.map.hash_map import empty_map, insert
    from agi_lidar_slam_torch.parallel import distributed as pdist
    from agi_lidar_slam_torch.parallel import map_shard as ms
    from agi_lidar_slam_torch.parallel import sharding as sh
    from agi_lidar_slam_torch.pointcloud.cloud import PointBatch, ScanGrid
    from agi_lidar_slam_torch.runtime import pipeline as tpipe

    dp = pdist.make_mesh_2d(dp=2, mp=1, device="cpu")
    mp = pdist.make_mesh_2d(dp=1, mp=2, device="cpu")
    out = {}

    def run_odom(name, step, state):
        t, q, coll = [], [], []
        for s in odom:
            before = pdist.collectives
            state, res = step(state, ScanGrid(*map(_t, s)))
            coll.append(pdist.collectives - before)
            t.append(res.pose.t.numpy())
            q.append(res.pose.q.numpy())
        out[f"{name}_t"], out[f"{name}_q"], out[f"{name}_coll"] = map(np.stack, (t, q, coll))
        return state

    cfg = tcfg["odom"]
    st = run_odom("dp", lambda s, x: sh.sharded_scan_step(dp, s, x, cfg),
                  tpipe.init_state(cfg, "cpu"))
    out["dp_surf_occ"] = int(st.surf_map.num_points())
    st0 = tpipe.init_state(cfg, "cpu")
    st = run_odom("mp", lambda s, x: sh.sharded_scan_step_mp(mp, s, x, cfg),
                  st0._replace(corner_map=ms.shard_map_arrays(st0.corner_map, mp),
                               surf_map=ms.shard_map_arrays(st0.surf_map, mp)))
    out["mp_rows"] = st.surf_map.points.shape[0]
    for name in ("corner", "surf"):
        whole = ms.gather_map_arrays(getattr(st, f"{name}_map"), mp)
        out[f"mp_{name}_occ"] = int(whole.num_points())

    mcfg = tcfg["map"]
    full = torch.ones(4000, dtype=torch.bool)
    m = ms.sharded_insert(mp, ms.shard_map_arrays(empty_map(mcfg, "cpu"), mp),
                          _t(maps["insert"]), full, mcfg)
    whole = ms.gather_map_arrays(m, mp)
    out["ins_keys"], out["ins_occ"], out["ins_pts"] = (whole.keys.numpy(), whole.occ.numpy(),
                                                        whole.points.numpy())
    m = ms.shard_map_arrays(empty_map(mcfg, "cpu"), mp)
    for pts in maps["steps"]:
        m = ms.sharded_insert(mp, m, _t(pts), torch.ones(len(pts), dtype=torch.bool), mcfg)
    out["inc_occ"] = ms.gather_map_arrays(m, mp).occ.numpy()
    m = insert(empty_map(mcfg, "cpu"), _t(maps["map"]), torch.ones(6000, dtype=torch.bool), mcfg)
    knn = ms.sharded_knn(mp, ms.shard_map_arrays(m, mp), _t(maps["queries"]),
                         torch.ones(512, dtype=torch.bool), 5, mcfg)
    out["knn_sq"], out["knn_pts"], out["knn_valid"] = (knn.sq_dists.numpy(), knn.points.numpy(),
                                                       knn.valid.numpy())

    e = tpg.EdgeSet(**{f: _t(v) for f, v in graph["edges"].items()})
    args = (se3.Pose(_t(graph["q"]), _t(graph["t"])), torch.tensor(graph["n"], dtype=torch.int32))
    solved = tpg.sharded_solve_pose_graph(dp, *args, e)
    out["pg_q"], out["pg_t"] = solved.q.numpy(), solved.t.numpy()
    try:  # 15 edges do not divide over 2 ranks
        tpg.sharded_solve_pose_graph(dp, *args, tpg.EdgeSet(*(x[:15] for x in e[:-1]), e.count))
        out["pg_uneven_raised"] = False
    except ValueError:
        out["pg_uneven_raised"] = True
    rep = sh.replicate({"v": torch.tensor([float(rank), 2.0]),
                        "m": (torch.tensor([rank == 0, True]),)}, dp)
    out["replicated"] = np.concatenate([rep["v"].numpy(), rep["m"][0].numpy()])
    pb = PointBatch(torch.arange(24.0).reshape(8, 3), torch.arange(8) % 3 == 0)
    blk = sh.shard_points(pb, dp)
    out["shard_ok"] = (torch.equal(blk.xyz, pb.xyz[4 * rank:4 * rank + 4])
                       and torch.equal(blk.mask, pb.mask[4 * rank:4 * rank + 4]))
    save_rank(out_dir, rank, out)
    return rank


@pytest.fixture(scope="module")
def rank_run(cases, tmp_path_factory):
    """The two ranks, started in a thread: the JAX references compile in this
    process meanwhile."""
    out = tmp_path_factory.mktemp("parallel")
    pool = ThreadPoolExecutor(1)
    job = pool.submit(launch_two, _rank_work,
                      (cases["tcfg"], cases["odom"], cases["maps"], cases["graph"]), out)
    yield job
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def ranks(rank_run):
    """Both ranks' results. A test that compares them against a reference asks
    for the reference first, so that it compiles while the ranks run."""
    return rank_run.result()


# ---- the JAX references ------------------------------------------------------

@pytest.fixture(scope="module")
def ref(cases, rank_run):
    """The JAX package's single-device scan step on the same scans (asked
    for after the ranks are started)."""
    import jax.numpy as jnp

    from agi_lidar_slam_tpu.pointcloud.cloud import ScanGrid
    from agi_lidar_slam_tpu.runtime import pipeline as jpipe

    jcfg = cases["jcfg"]
    out = {}
    st = jpipe.init_state(jcfg["odom"])
    ts = []
    for s in cases["odom"]:
        st, res = jpipe.process_scan(st, ScanGrid(*map(jnp.asarray, s)), jcfg["odom"])
        ts.append(np.asarray(res.pose.t))
    out["odom_t"] = np.stack(ts)
    out["odom_corner_occ"] = int(st.corner_map.num_points())
    out["odom_surf_occ"] = int(st.surf_map.num_points())
    return out


@pytest.fixture(scope="module")
def mesh2_ref(cases, rank_run):
    """JAX's sharded map functions and pose-graph solve on a 2-device mesh,
    and the single-device functions, on the same inputs (asked for after
    the ranks are started)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from agi_lidar_slam_tpu.geometry import se3
    from agi_lidar_slam_tpu.graph.pose_graph import (EdgeSet, sharded_solve_pose_graph,
                                                     solve_pose_graph)
    from agi_lidar_slam_tpu.map.hash_map import empty_map, insert
    from agi_lidar_slam_tpu.nn.knn import knn
    from agi_lidar_slam_tpu.parallel.map_shard import (shard_map_arrays, sharded_insert,
                                                       sharded_knn)

    cfg, maps, g = cases["jcfg"]["map"], cases["maps"], cases["graph"]
    mp = Mesh(np.array(jax.devices()[:2]), axis_names=("mp",))
    dp = Mesh(np.array(jax.devices()[:2]), axis_names=("dp",))
    # jitted: called eagerly, each shard_map call compiles anew (25 s an insert)
    insert_j = jax.jit(insert, static_argnums=3)
    sharded_insert_j = jax.jit(sharded_insert, static_argnums=(0, 4))

    def np_map(m):
        return {f: np.asarray(getattr(m, f)) for f in ("keys", "points", "occ")}

    ones = jnp.ones(4000, bool)
    out = {"insert": np_map(insert_j(empty_map(cfg), jnp.asarray(maps["insert"]), ones, cfg)),
           "insert_mesh": np_map(sharded_insert_j(mp, shard_map_arrays(empty_map(cfg), mp),
                                                  jnp.asarray(maps["insert"]), ones, cfg))}
    m = shard_map_arrays(empty_map(cfg), mp)
    for pts in maps["steps"]:
        m = sharded_insert_j(mp, m, jnp.asarray(pts), jnp.ones(len(pts), bool), cfg)
    out["inc_occ"] = np.asarray(m.occ)
    m = insert_j(empty_map(cfg), jnp.asarray(maps["map"]), jnp.ones(6000, bool), cfg)
    q, qm = jnp.asarray(maps["queries"]), jnp.ones(512, bool)
    out["knn"] = jax.jit(knn, static_argnums=(3, 4))(m, q, qm, 5, cfg)
    out["knn_mesh"] = jax.jit(sharded_knn, static_argnums=(0, 4, 5))(
        mp, shard_map_arrays(m, mp), q, qm, 5, cfg)

    poses = se3.Pose(jnp.asarray(g["q"]), jnp.asarray(g["t"]))
    edges = EdgeSet(**{f: jnp.asarray(v) for f, v in g["edges"].items()})
    out["pg"] = solve_pose_graph(poses, jnp.int32(g["n"]), edges)
    out["pg_mesh"] = sharded_solve_pose_graph(dp, poses, jnp.int32(g["n"]), edges)
    return out


# ---- the checks -----------------------------------------------------------------

def test_ranks_hold_the_same_results(ranks):
    """Every sharded step leaves both ranks with the same poses, maps and
    counts: the replicated state never diverges."""
    a, b = ranks
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert int(a["threads"]) == 1


def test_replicate_and_shard_points(ranks):
    """replicate hands rank 0's tensors (a bool one too) to both ranks;
    shard_points gives each rank its contiguous half of the point axis."""
    for r in ranks:
        np.testing.assert_array_equal(r["replicated"], [0.0, 2.0, 1.0, 1.0])
        assert bool(r["shard_ok"])


def test_collectives_per_scan(ranks, cases):
    """The dp odometry step makes one all_reduce per inner GN iteration
    (n_outer x n_inner a scan); the mp step one all_gather per KNN call and
    none in the solve."""
    solver = cases["tcfg"]["odom"].solver
    r = ranks[0]
    np.testing.assert_array_equal(r["dp_coll"], solver.n_outer * solver.n_inner)
    # two classes per outer pass (the cache re-probes in no pass here)
    assert np.all(r["mp_coll"] == 2 * solver.n_outer), r["mp_coll"]


def test_dp_odometry_matches_reference(ref, ranks):
    r = ranks[0]
    np.testing.assert_allclose(r["dp_t"], ref["odom_t"], rtol=0, atol=ODOM_T_TOL)
    assert int(r["dp_surf_occ"]) == ref["odom_surf_occ"]


def test_mp_odometry_matches_reference(ref, ranks, cases):
    r = ranks[0]
    np.testing.assert_allclose(r["mp_t"], ref["odom_t"], rtol=0, atol=ODOM_T_TOL)
    assert int(r["mp_surf_occ"]) == ref["odom_surf_occ"]
    assert int(r["mp_corner_occ"]) == ref["odom_corner_occ"]
    # each rank held half of the surf map's rows
    from agi_lidar_slam_torch.map.hash_map import map_rows

    assert int(r["mp_rows"]) * 2 == map_rows(cases["tcfg"]["odom"].surf_map)


def test_sharded_insert_matches_reference(mesh2_ref, ranks):
    """The 2-rank insert, gathered, equals JAX's sharded_insert on a 2-device
    mesh and its single-device insert, bit for bit; so do three inserts in a
    row."""
    r = ranks[0]
    for name in ("insert", "insert_mesh"):
        j = mesh2_ref[name]
        np.testing.assert_array_equal(r["ins_keys"], j["keys"])
        np.testing.assert_array_equal(r["ins_occ"], j["occ"])
        np.testing.assert_array_equal(r["ins_pts"], j["points"])
    np.testing.assert_array_equal(r["inc_occ"], mesh2_ref["inc_occ"])
    assert r["inc_occ"].sum() > 2000


def test_sharded_knn_matches_reference(mesh2_ref, ranks):
    """The merged 2-rank KNN against JAX's sharded_knn on a 2-device mesh and
    its single-device knn: the same neighbours in the same order."""
    r = ranks[0]
    for name in ("knn", "knn_mesh"):
        j = mesh2_ref[name]
        np.testing.assert_array_equal(r["knn_valid"], np.asarray(j.valid))
        np.testing.assert_allclose(r["knn_sq"], np.asarray(j.sq_dists), rtol=1e-5, atol=1e-6)
        v = r["knn_valid"]
        np.testing.assert_array_equal(r["knn_pts"][v], np.asarray(j.points)[v])
    assert r["knn_valid"].mean() > 0.9


def test_pose_graph_matches_reference(mesh2_ref, ranks):
    """The edge-sharded solve on 2 ranks against JAX's solve_pose_graph and
    its sharded solve on a 2-device mesh (quaternion sign is gauge)."""
    r = ranks[0]
    for name in ("pg", "pg_mesh"):
        j = mesh2_ref[name]
        np.testing.assert_allclose(r["pg_t"], np.asarray(j.t), rtol=0, atol=GRAPH_TOL)
        dots = np.abs(np.sum(r["pg_q"] * np.asarray(j.q), axis=-1))
        np.testing.assert_allclose(dots, 1.0, atol=GRAPH_TOL)


def test_pose_graph_capacity_must_divide(ranks):
    assert bool(ranks[0]["pg_uneven_raised"])


def _rank_fails(rank):
    import torch.distributed as dist

    if rank == 1:
        raise ValueError("rank one fails on purpose")
    dist.barrier()  # would wait for rank 1 for ever: the parent ends it


def test_launch_reports_a_failed_rank(tmp_path):
    """A rank that raises ends the whole group, the other rank waiting in a
    collective included, and launch raises with its traceback."""
    with pytest.raises(RuntimeError, match="(?s)rank 1 of 2 failed.*on purpose"):
        launch(_rank_fails, 2, device="cpu", backend="gloo", threads=1,
               rendezvous_dir=str(tmp_path), init_timeout_s=60.0, deadline_s=60.0)


def test_scaling_bench_rank_on_one_rank(monkeypatch):
    """tools/scaling_bench's per-rank timing on a one-rank gloo group in this
    process: one all_reduce per inner GN iteration, strong and weak, the
    same pose either way (every point twice weighs the same solve)."""
    import torch.distributed as dist

    from agi_lidar_slam_torch.config import preset_sim16
    from agi_lidar_slam_torch.tools import scaling_bench

    solver = preset_sim16().solver
    monkeypatch.setattr(scaling_bench, "WIDTH", 180)  # the tool's 16x900, narrowed
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        strong = scaling_bench._rank(0, "cpu", False, 1)
        weak = scaling_bench._rank(0, "cpu", True, 1)
    finally:
        dist.destroy_process_group()
    assert strong["collectives"] == weak["collectives"] == solver.n_outer * solver.n_inner
    assert strong["ms"] > 0 and strong["points_per_rank"] == 512 + 2048
    np.testing.assert_allclose(weak["pose_t"], strong["pose_t"], rtol=0, atol=1e-6)
