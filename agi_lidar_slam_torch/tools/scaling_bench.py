"""Scaling of the point-sharded scan-to-map GN solve over ranks (port of
tools/scaling_bench.py).

Runs parallel/sharding.sharded_gn_solve, the per-scan hot path, on 1, 2, 4,
... ranks up to --ranks, each count a process group of its own spawned by
parallel/launch.py, and prints one JSON line per rank count and then the
efficiency line (strong scaling; with --weak, the per-rank work held
constant by giving every rank the whole point budget).

Each rank builds the same inputs from the seed, at the reference tool's size:
one preset_sim16 scan of RINGS x WIDTH (16x900) of the simulator's default
world, its features inserted into both maps. On cuda
each rank takes cuda:{rank % cards}. With as many cards as ranks the group
runs over nccl; with more ranks than cards they share the cards over gloo,
which stages CUDA tensors through host memory inside torch: those figures
are the sharded path's overhead on one card, not scaling, and every line
says so (`shared_card`).

  python -m agi_lidar_slam_torch.tools.scaling_bench --ranks 2 [--weak]
  python -m agi_lidar_slam_torch.tools.scaling_bench --ranks 2 --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

RINGS, WIDTH = 16, 900
OVERHEAD_NOTE = ("ranks share one card over gloo: the figure is the sharded path's "
                 "overhead, not scaling")


def _inputs(device):
    from ..config import preset_sim16
    from ..features.curvature import extract_features
    from ..geometry import se3
    from ..map.hash_map import empty_map, insert
    from ..pointcloud.voxel import voxel_downsample
    from ..sim.world import default_world, simulate_scan

    cfg = preset_sim16()
    world = default_world(seed=0, device=device)
    p = se3.Pose.identity(device=device)
    scan = simulate_scan(world, p, p, rings=RINGS, width=WIDTH)
    feats = extract_features(scan, cfg.features)
    corners = voxel_downsample(feats.corners.xyz, feats.corners.mask, cfg.corner_ds_voxel,
                               cfg.features.max_corners)
    surfs = voxel_downsample(feats.surfs.xyz, feats.surfs.mask, cfg.surf_ds_voxel,
                             cfg.features.max_surfs)
    cmap = insert(empty_map(cfg.corner_map, device), corners.xyz, corners.mask, cfg.corner_map)
    smap = insert(empty_map(cfg.surf_map, device), surfs.xyz, surfs.mask, cfg.surf_map)
    return cfg, p, corners, surfs, cmap, smap


def _rank(rank: int, device: str, weak: bool, reps: int) -> dict:
    """One rank's timing of `reps` synchronized sharded solves (ms each)."""
    import torch.distributed as dist

    from ..parallel import distributed
    from ..parallel.sharding import make_mesh, sharded_gn_solve
    from ..pointcloud.cloud import PointBatch

    dev = distributed.local_device(rank) if device == "cuda" else torch.device("cpu")
    n = dist.get_world_size()
    mesh = make_mesh(device=device)
    cfg, p, corners, surfs, cmap, smap = _inputs(dev)
    if weak:  # n copies of every point: each rank's block is the 1-rank problem
        corners, surfs = (PointBatch(b.xyz.repeat(n, 1), b.mask.repeat(n)) for b in (corners,
                                                                                     surfs))

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dist.barrier()

    pose, _ = sharded_gn_solve(mesh, p, corners, surfs, cmap, smap, cfg)  # warm-up
    sync()
    before = distributed.collectives
    t0 = time.perf_counter()
    for _ in range(reps):
        pose, _ = sharded_gn_solve(mesh, p, corners, surfs, cmap, smap, cfg)
    sync()
    ms = (time.perf_counter() - t0) / reps * 1e3
    return {"ms": ms, "collectives": (distributed.collectives - before) / reps,
            "pose_t": pose.t.tolist(), "points_per_rank": corners.mask.shape[0] // n
            + surfs.mask.shape[0] // n}


def run(ranks: int, device: str = "cuda", weak: bool = False, reps: int = 8) -> list:
    """The JSON records: one per rank count, then the efficiency record."""
    from ..parallel.launch import launch

    cards = torch.cuda.device_count() if device == "cuda" else 0
    shared = device == "cuda" and ranks > cards
    backend = "gloo" if device == "cpu" or shared else "nccl"
    counts = [n for n in (1, 2, 4, 8, 16, 32) if n <= ranks]
    out, times = [], {}
    for n in counts:
        # on the CPU the ranks split the cores, so a count does not oversubscribe them
        threads = None if device == "cuda" else max(1, (os.cpu_count() or 1) // n)
        res = launch(_rank, n, (device, weak, reps), device=device, backend=backend,
                     threads=threads)
        times[n] = res[0]["ms"]
        rec = {"ranks": n, "gn_solve_ms": res[0]["ms"], "backend": backend, "device": device,
               "collectives_per_solve": res[0]["collectives"],
               "points_per_rank": res[0]["points_per_rank"], "weak": weak}
        if device == "cuda":
            rec["card"] = torch.cuda.get_device_name(0)
        if shared and n > 1:
            rec["shared_card"] = True
            rec["note"] = OVERHEAD_NOTE
        out.append(rec)
    if len(times) > 1:
        base, last = times[counts[0]], counts[-1]
        if weak:
            rec = {"metric": "gn_weak_scaling_flatness", "value": base / times[last],
                   "from_ranks": counts[0], "to_ranks": last}
        else:
            rec = {"metric": "gn_scaling_efficiency",
                   "value": (base / times[last]) / (last / counts[0]),
                   "from_ranks": counts[0], "to_ranks": last}
        if shared:
            rec["shared_card"] = True
            rec["note"] = OVERHEAD_NOTE
        out.append(rec)
    return out


def main(argv: list | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=None,
                    help="largest rank count (default: the cards, at least 2)")
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--weak", action="store_true",
                    help="weak scaling: every rank keeps the 1-rank point budget")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    ranks = args.ranks or max(torch.cuda.device_count() if args.device == "cuda" else 2, 2)
    for rec in run(ranks, args.device, args.weak, args.reps):
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
