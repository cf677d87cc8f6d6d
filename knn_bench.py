"""Development bench of the octant-KNN kernel on one NVIDIA GPU: the kernel
against an earlier version of itself and against variants of its source, at
chip_smoke.py's synthetic shapes and on the paths' own inputs.

    python3 knn_bench.py prepare [REV]   # needs git
    python3 knn_bench.py run [OUT.json]  # needs a card

Both run from the root of a checkout. `prepare` writes the sources `run`
builds into agi_lidar_slam_torch/_build/knn_bench/ (git-ignored, so copy the
checkout as it stands on disk to the machine with the card):
  * earlier — csrc/octant_knn.cu as of REV (default f01da47: one warp per
    query, rows read from L2, k warp-argmin rounds), its symbols renamed;
  * split — the current source with a device global that stubs out stages:
    1 probe only, 3 no selection rounds, 4 no list insertion and no
    selection (0 runs it whole, to price the switch itself);
  * timed — the current source with clock64() stamps per live tile (start,
    after the probe, after the row set, after staging, end) and per-warp
    cycle sums of scoring, selection and output;
  * the current source with one constant changed: list2 and list8 (pairs per
    lane list), tile4 and tile16 (queries per tile), nostage (no staged
    rows), lb7 (a launch bound of 7 CTAs an SM, so at most 32 registers),
    lb8 (8 CTAs an SM, and a shared-memory budget that lets 8 fit), const
    (the kernel compiled with the tile and the block size as constants
    where it reads them at run time).
The variants are made by replacing exact lines of the source, so an edit of
those lines makes `prepare` raise "the kernel source changed".
`run` builds them (one nvcc per source, -Xptxas -v printed), runs
chip_smoke.py's odometry and LIO phases to capture the paths' calls, and for
each case times the plain version, the earlier kernel and the current one in
turns (plain, earlier, current, current, earlier, plain; device time from
torch.profiler), the call with each wrapper (CUDA events), the variants and
the sharing counts. It prints one line per case and writes everything as JSON
to OUT (default: results.json beside the sources it built).
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

import chip_smoke as cs  # its phases, captures, counts and timers
from agi_lidar_slam_torch import _build, preset_aloam_kitti64
from agi_lidar_slam_torch.map.planar import build_ktab
from agi_lidar_slam_torch.nn import octant_knn as ok
from agi_lidar_slam_torch.runtime import lio_pipeline as lio
from agi_lidar_slam_torch.tools import probe
from agi_lidar_slam_torch.tools.variants import build_library, git_source
from agi_lidar_slam_torch.tools.variants import replaced as _rep

ROOT = pathlib.Path(__file__).resolve().parent
BUILD = _build.BUILD_DIR / "knn_bench"
SOURCE = "agi_lidar_slam_torch/csrc/octant_knn.cu"
EARLIER = "f01da47"
# variants of the current source: the lines replaced, (line, replacement)
CONSTANTS = {
    "list2": [("constexpr int kList = 4;", "constexpr int kList = 2;")],
    "list8": [("constexpr int kList = 4;", "constexpr int kList = 8;")],
    "tile4": [("constexpr int kTile = 8;", "constexpr int kTile = 4;")],
    "tile16": [("constexpr int kTile = 8;", "constexpr int kTile = 16;")],
    "nostage": [("constexpr int kSmemBudget = 32 * 1024;", "constexpr int kSmemBudget = 0;")],
    "lb7": [("__launch_bounds__(kThreads)", "__launch_bounds__(kThreads, 7)")],
    "lb8": [("__launch_bounds__(kThreads)", "__launch_bounds__(kThreads, 8)"),
            ("constexpr int kSmemBudget = 32 * 1024;", "constexpr int kSmemBudget = 28160;")],
    "const": [("nthr = blockDim.x;", "nthr = kThreads;"), ("a.tile", "kTile")],
}
VARIANTS = ("earlier", "split", "timed", *CONSTANTS)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LAUNCH = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _F, _P, _P, _P, _I, _P]


def _rename(s: str, name: str) -> str:
    s = _rep(s, "int octant_knn_launch(", f"int {name}_octant_knn_launch(")
    s = s.replace("int octant_knn_launch_shape(", f"int {name}_launch_shape(")
    return _rep(s, "const char* octant_knn_error_string", f"const char* {name}_error_string")


_SET = "  cudaError_t err = cudaSetDevice(device);\n  if (err != cudaSuccess) return (int)err;\n"


def _split(src: str) -> str:
    s = _rep(src, "struct Args {", "__device__ int g_mode;\n\nstruct Args {")
    s = _rep(s, "      // 2. the distinct rows", """      if (g_mode == 1) {
        for (int i = tid; i < nq * k; i += nthr) {
          a.out_sq[(size_t)q0 * k + i] = (float)s_row[i % ne];
          a.out_valid[(size_t)q0 * k + i] = 0;
        }
        __syncthreads();
        continue;
      }
      // 2. the distinct rows""")
    s = _rep(s, "    bool lt[kList];",
             "    if (g_mode == 4) { if (cv < lv[0]) { lv[0] = cv; li[0] = ci; } continue; }\n"
             "    bool lt[kList];")
    s = _rep(s, "        for (; found < k; ++found) {", """        if (g_mode >= 3) {
          if (lane < k) {
            s_win[warp * kMaxK + lane] = li[0] == 0x7fffffff ? -1 : li[0];
            myv = lv[0];
          }
          found = k;
        }
        for (; found < k; ++found) {""")
    s = _rep(_rename(s, "split"), "void* stream) {\n  if (n <= 0",
             "void* stream, int mode) {\n  if (n <= 0")
    return _rep(s, _SET, _SET + "  static int current = -1;  // the timed calls copy nothing\n"
                "  if (mode != current) {\n"
                "    err = cudaMemcpyToSymbol(g_mode, &mode, sizeof(int));\n"
                "    if (err != cudaSuccess) return (int)err;\n    current = mode;\n  }\n")


def _timed(src: str) -> str:
    s = _rep(src, "struct Args {", "__device__ long long* g_ts;\n"
             "__device__ unsigned long long* g_acc;\n\nstruct Args {")
    s = _rep(s, "  for (int base = blockIdx.x;",
             "  unsigned long long c_score = 0, c_select = 0, c_out = 0;\n"
             "  unsigned long long n_refill = 0, n_live = 0;\n"
             "  for (int base = blockIdx.x;")
    s = _rep(s, "      const int q0 = tile * a.tile;\n",
             "      const long long t_start = clock64();\n      const int q0 = tile * a.tile;\n")
    s = _rep(s, "      // 2. the distinct rows",
             "      const long long t_probe = clock64();\n      // 2. the distinct rows")
    s = _rep(s, "      __syncthreads();\n      const bool staged",
             "      __syncthreads();\n      const long long t_set = clock64();\n"
             "      const bool staged")
    s = _rep(s, "      cp_async_wait_all();\n      __syncthreads();\n",
             "      cp_async_wait_all();\n      __syncthreads();\n"
             "      const long long t_stage = clock64();\n")
    s = _rep(s, "        uint16_t* list = s_list", "        const long long c0 = clock64();\n"
             "        uint16_t* list = s_list")
    s = _rep(s, "        for (; found < k; ++found) {",
             "        const long long c1 = clock64();\n        n_live += hit;\n"
             "        for (; found < k; ++found) {")
    s = _rep(s, "              left = staged ? score_list<true, true>",
             "              ++n_refill, left = staged ? score_list<true, true>")
    s = _rep(s, "        if (lane < k) {\n          a.out_sq",
             "        const long long c2 = clock64();\n        if (lane < k) {\n          a.out_sq")
    s = _rep(s, "            a.out_pts[qi * k * 3 + t] = v;\n          }\n        }\n",
             "            a.out_pts[qi * k * 3 + t] = v;\n          }\n        }\n"
             "        c_score += c1 - c0; c_select += c2 - c1; c_out += clock64() - c2;\n")
    end = ("      __syncthreads();  // the tile's shared memory is read to the end before the "
           "next fills it\n")
    s = _rep(s, end, end + "      if (tid == 0) {\n        long long* t = g_ts + 5 * tile;\n"
             "        t[0] = t_start; t[1] = t_probe; t[2] = t_set; t[3] = t_stage;\n"
             "        t[4] = clock64();\n"
             "      }\n")
    last = ("    __syncthreads();  // s_live is read by all before warp 0 writes the next "
            "group's\n  }\n}")
    s = _rep(s, last, last[:-1] + "  for (int off = 16; off > 0; off >>= 1)\n"
             "    n_refill += __shfl_xor_sync(kFull, n_refill, off);\n"
             "  if (lane == 0) {\n    atomicAdd(g_acc, c_score); atomicAdd(g_acc + 1, c_select);\n"
             "    atomicAdd(g_acc + 2, c_out); atomicAdd(g_acc + 3, n_refill);\n"
             "    atomicAdd(g_acc + 4, n_live); atomicAdd(g_acc + 5, 1ull);\n  }\n}")
    s = _rep(_rename(s, "timed"), "void* stream) {\n  if (n <= 0",
             "void* stream, long long* ts, unsigned long long* acc) {\n  if (n <= 0")
    return _rep(s, _SET, _SET + "  cudaMemcpyToSymbol(g_ts, &ts, sizeof(ts));\n"
                "  cudaMemcpyToSymbol(g_acc, &acc, sizeof(acc));\n")


def prepare(rev: str = EARLIER) -> None:
    """Write the earlier kernel (from git) and the current source's variants."""
    earlier = git_source(ROOT, SOURCE, rev)
    src = (ROOT / SOURCE).read_text()
    BUILD.mkdir(parents=True, exist_ok=True)
    out = {"earlier": _rename(earlier, "earlier"), "split": _split(src), "timed": _timed(src)}
    for name, lines in CONSTANTS.items():
        s = src
        for old, new in lines:
            s = _rep(s, old, new, every=True)
        out[name] = _rename(s, name)
    for name, text in out.items():
        (BUILD / f"{name}.cu").write_text(text)
    print(f"knn_bench: wrote {', '.join(out)} to {BUILD}", flush=True)


def _load() -> ctypes.CDLL:
    lib = build_library(BUILD, VARIANTS, "libknn_bench.so")
    lib.earlier_octant_knn_launch.argtypes = _LAUNCH
    lib.split_octant_knn_launch.argtypes = _LAUNCH + [_I]
    lib.timed_octant_knn_launch.argtypes = _LAUNCH + [_P, _P]
    for name in CONSTANTS:
        getattr(lib, f"{name}_octant_knn_launch").argtypes = _LAUNCH
    return lib


def _outs(q, k):
    N = q.shape[0]
    return (torch.empty((N, k), device=q.device), torch.empty((N, k, 3), device=q.device),
            torch.empty((N, k), dtype=torch.bool, device=q.device))


def _call(fn, m, q, qm, k, cfg, ktab, *extra):
    """One launch of a bench symbol with the current wrapper's checks."""
    ok._check_inputs(m, q, qm, k, cfg, ktab)
    sq, pts, valid = _outs(q, k)
    err = fn(q.data_ptr(), qm.data_ptr(), m.points.data_ptr(), m.occ.data_ptr(), ktab.data_ptr(),
             q.shape[0], m.bucket, k, cfg.probes, cfg.log2_slots, cfg.sub_voxel, cfg.block_sub,
             cfg.block_size, sq.data_ptr(), pts.data_ptr(), valid.data_ptr(), 0,
             torch.cuda.current_stream().cuda_stream, *extra)
    if err != 0:
        raise RuntimeError(f"bench launch failed: cudaError {err}")
    return sq, pts, valid


def _err(name, got, ref) -> float:
    torch.cuda.synchronize()
    if not torch.equal(got[2], ref[2]):
        raise AssertionError(f"{name}: valid differs in {int((got[2] != ref[2]).sum())} entries")
    if not bool(ref[2].any()):
        return 0.0
    return max(float((got[0] - ref[0])[ref[2]].abs().max()),
               float((got[1] - ref[1])[ref[2]].abs().max()))


def _timed_cycles(lib, m, q, qm, k, cfg, ktab) -> dict:
    n_tiles = (q.shape[0] + cs.launch_shape(m.bucket)[0] - 1) // cs.launch_shape(m.bucket)[0]
    ts = torch.zeros((n_tiles, 5), dtype=torch.int64, device=q.device)
    acc = torch.zeros(6, dtype=torch.int64, device=q.device)
    for _ in range(2):  # the second run is the one read
        ts.zero_(), acc.zero_()
        _call(lib.timed_octant_knn_launch, m, q, qm, k, cfg, ktab, ts.data_ptr(), acc.data_ptr())
        torch.cuda.synchronize()
    t, a = ts[ts[:, 4] != 0].double(), acc.tolist()
    n = max(a[4], 1)
    return {"live_tiles": int(t.shape[0]), "probe": float((t[:, 1] - t[:, 0]).mean()),
            "set": float((t[:, 2] - t[:, 1]).mean()), "stage": float((t[:, 3] - t[:, 2]).mean()),
            "rest": float((t[:, 4] - t[:, 3]).mean()), "score_per_query": a[0] / n,
            "select_per_query": a[1] / n, "output_per_query": a[2] / n, "refills": a[3],
            "live_queries": a[4]}


def _case(lib, label, m, q, qm, k, cfg, ktab, gather_gbs) -> dict:
    fns = {"plain": lambda: ok.knn_octant_ref(m, q, qm, k, cfg, ktab=ktab),
           "earlier": lambda: _call(lib.earlier_octant_knn_launch, m, q, qm, k, cfg, ktab),
           "current": lambda: ok.knn_octant(m, q, qm, k, cfg, ktab=ktab)}
    ref = fns["plain"]()
    rec = {"case": label, "queries": q.shape[0], "rows": m.n_rows, "k": k,
           "max_abs_err": {w: _err(f"{label} {w}", fns[w](), ref) for w in ("earlier", "current")},
           "device_ms": {w: [] for w in fns}, "call_ms": {"earlier": [], "current": []}}
    for w in ("plain", "earlier", "current", "current", "earlier", "plain"):
        rec["device_ms"][w].append(cs.device_ms(fns[w]))
    for w in ("earlier", "current", "current", "earlier"):
        rec["call_ms"][w].append(cs.cuda_ms(fns[w]))
    variants = {f"split{mode}": (lib.split_octant_knn_launch, (mode,)) for mode in (0, 1, 3, 4)}
    variants.update({name: (getattr(lib, f"{name}_octant_knn_launch"), ()) for name in CONSTANTS})
    rec["variants_ms"] = {}
    for name, (fn, extra) in variants.items():
        def run(fn=fn, extra=extra):
            return _call(fn, m, q, qm, k, cfg, ktab, *extra)
        if not name.startswith("split") or name == "split0":
            _err(f"{label} {name}", run(), ref)
        rec["variants_ms"][name] = cs.device_ms(run)
    rec["timed_cycles"] = _timed_cycles(lib, m, q, qm, k, cfg, ktab)
    rec["sharing"] = cs.sharing(m, q, qm, cfg, ktab)
    rec["l2_ms"] = rec["sharing"]["hits"] * m.bucket * 13 / (gather_gbs * 1e6)
    rec["bound_ms"] = cs.knn_bound(m, q, qm, k, cfg, ktab)[0]
    print(f"knn_bench {label}: {json.dumps(rec)}", flush=True)
    return rec


def run(out: str = str(BUILD / "results.json")) -> None:
    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"knn_bench: {smi}, torch {torch.__version__}", flush=True)
    t0 = time.perf_counter()
    _build.load()
    lib = _load()
    print(f"knn_bench: built in {time.perf_counter() - t0:.1f} s", flush=True)
    src, idx = probe.distinct_inputs(seed=cs.SEED, device=device)  # each row once
    gbs = idx.numel() * 768 / (cs.device_ms(lambda: probe.row_gather_sum(idx, src)) * 1e6)
    cfg, lcfg = preset_aloam_kitti64(), lio.LioConfig()
    rng = np.random.default_rng(cs.SEED)
    cases = []
    for name, (mcfg, n_points, n, k) in {
            "corner": (cfg.corner_map, 40000, 2048, 5), "surf": (cfg.surf_map, 80000, 8192, 5),
            "lio": (lcfg.map, 80000, 8192, 8)}.items():
        m = cs.filled_map(mcfg, n_points, rng, device)
        q = torch.from_numpy(rng.uniform([-26, -26, -3], [26, 26, 6], (n, 3))
                             .astype(np.float32)).to(device)
        qm = torch.from_numpy(rng.uniform(size=n) >= 0.2).to(device)
        cases.append(_case(lib, f"synthetic {name}", m, q, qm, k, mcfg, build_ktab(m), gbs))
    runs = {"odom": cs.phase_main(device)["calls"], "lio": cs.phase_lio(device)["calls"]}
    for path, calls in runs.items():
        for j, (m, q, qm, k, mcfg, ktab) in enumerate(calls):
            cases.append(_case(lib, f"path {path}#{j}", m, q, qm, k, mcfg, ktab, gbs))
    path = ROOT / out
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps({"device": smi, "gather_GB_per_s": gbs, "cases": cases}, indent=1))
    print(f"knn_bench: wrote {path}", flush=True)


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    if not args or args[0] not in ("prepare", "run") or len(args) > 2:
        print("usage: python3 knn_bench.py prepare [REV] | run [OUT]",
              file=sys.stderr)
        return 2
    if args[0] == "run" and not torch.cuda.is_available():
        print("knn_bench: no CUDA device", file=sys.stderr)
        return 1
    (prepare if args[0] == "prepare" else run)(*args[1:])
    return 0


if __name__ == "__main__":
    sys.exit(main())
