"""Development bench of the row-gather probe kernel on one NVIDIA GPU: the
kernel beside an earlier version of itself at chip_smoke.py's row-gather
cases, and the SASS of both.

    python3 gather_bench.py prepare [REV]   # needs git
    python3 gather_bench.py run [OUT_DIR]   # needs a card

Both run from the root of a checkout. `prepare` writes csrc/probe.cu as of
REV (default ac33e8a: one warp per index, 4-byte loads in a loop), its C
symbols prefixed with `earlier_`, into agi_lidar_slam_torch/_build/
gather_bench/ (git-ignored, so copy the checkout as it stands on disk to the
machine with the card). `run` builds it, dumps the SASS of both versions'
row-gather kernels with cuobjdump and counts their loads, then for each case
checks both versions against the plain one and takes device times
(torch.profiler, chip_smoke.device_ms) in turns: earlier, current, current,
earlier; then the library call and `scale2` at 256x128 (the launch floor).
It prints one line per case and writes gather_bench.json and the SASS to
OUT_DIR (default: agi_lidar_slam_torch/_build/gather_bench/out). The claims
on and off are timed by chip_smoke.py itself.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import re
import subprocess
import sys

import torch

import chip_smoke as cs  # its cases, checks and timers
from agi_lidar_slam_torch import _build
from agi_lidar_slam_torch.tools import probe
from agi_lidar_slam_torch.tools.variants import build_library, git_source

ROOT = pathlib.Path(__file__).resolve().parent
BUILD = _build.BUILD_DIR / "gather_bench"
SOURCE = "agi_lidar_slam_torch/csrc/probe.cu"
EARLIER = "ac33e8a"
SYMBOLS = ("scale2_launch", "row_gather_sum_launch", "probe_versions", "probe_error_string")
CASES = ("probe_defaults", "map_table", "distinct", "one_row", "misaligned")
_P, _I = ctypes.c_void_p, ctypes.c_int


def prepare(rev: str = EARLIER) -> None:
    """Write csrc/probe.cu as of `rev`, its C symbols prefixed with `earlier_`."""
    src = git_source(ROOT, SOURCE, rev)
    for name in SYMBOLS:
        if src.count(f" {name}(") != 1:
            raise RuntimeError(f"{SOURCE}@{rev} does not define {name} once")
        src = src.replace(f" {name}(", f" earlier_{name}(")
    BUILD.mkdir(parents=True, exist_ok=True)
    (BUILD / "earlier.cu").write_text(src)
    print(f"gather_bench: wrote earlier ({rev}) to {BUILD}", flush=True)


def sass_loads(binary: pathlib.Path, out_dir: pathlib.Path, name: str) -> dict:
    """The SASS of each row-gather kernel in `binary` (written to out_dir with
    its memory, fence and add instructions in order), its global loads (LDG),
    and the most LDGs issued in a row before an FADD (a lower bound on the
    loads a thread has in flight)."""
    cuobjdump = pathlib.Path(_build.find_nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(binary)], check=True,
                          capture_output=True, text=True).stdout
    found, digest = {}, []
    for m in re.finditer(r"Function : (\S*row_gather_sum_kernel\S*)\n(.*?)(?=\n\s*Function : |\Z)",
                         text, re.S):
        run = most = 0
        digest.append(f"Function : {m.group(1)}")
        for line in m.group(2).splitlines():
            op = re.search(r"\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]+)", line)
            if not op:
                continue
            op = op.group(2)
            if op.split(".")[0] in ("LDG", "STG", "FADD", "MEMBAR", "CCTL", "ATOMG", "RED",
                                    "MATCH", "SHFL", "BRA", "NANOSLEEP", "FENCE", "ERRBAR"):
                digest.append("  " + line.strip())
            if op.startswith("LDG"):
                run += 1
            elif op.startswith("FADD") and run:
                most, run = max(most, run), 0
        found[m.group(1)] = {"ldg": len(re.findall(r"\bLDG\.", m.group(2))),
                             "ldg_before_first_fadd": max(most, run)}
    (out_dir / f"{name}.sass").write_text("\n".join(digest))
    return found


def _earlier_call(lib, idx, src):
    out = torch.empty((idx.shape[0], 3), device=idx.device)
    err = lib.earlier_row_gather_sum_launch(idx.data_ptr(), src.data_ptr(), out.data_ptr(),
                                            idx.shape[0], src.shape[0], src.shape[1],
                                            idx.device.index or 0,
                                            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"earlier row_gather_sum launch failed: cudaError {err}")
    return out


def run(out_dir: str = str(BUILD / "out")) -> None:
    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"gather_bench: {smi}, torch {torch.__version__}", flush=True)
    out = ROOT / out_dir
    out.mkdir(parents=True, exist_ok=True)
    _build.load()
    lib = build_library(BUILD, ["earlier"], "libgather_bench.so")
    lib.earlier_row_gather_sum_launch.argtypes = [_P, _P, _P, _I, _I, _I, _I, _P]
    sass = {"earlier": sass_loads(BUILD / "earlier.o", out, "earlier"),
            "current": sass_loads(_build.library_path(), out, "current")}
    print(f"gather_bench: SASS {json.dumps(sass)}", flush=True)
    x = torch.randn((256, 128), device=device)
    inputs = cs.gather_inputs(device)
    cases = []
    for label in CASES:
        src, idx = inputs[label]
        fns = {"earlier": lambda: _earlier_call(lib, idx, src),
               "current": lambda: probe.row_gather_sum(idx, src)}
        ref = probe.row_gather_sum_ref(idx, src)
        rec = {"case": label, "n": idx.shape[0], "rows": src.shape[0],
               "bound_ms": cs.bound(probe.gather_bytes(idx, src), idx.numel() * 192)[0],
               "max_rel_err": {w: cs.gather_err(f"{label} {w}", fn(), ref)[1]
                               for w, fn in fns.items()},
               "device_ms": {w: [] for w in fns}}
        for w in ("earlier", "current", "current", "earlier"):
            rec["device_ms"][w].append(cs.device_ms(fns[w]))
        rec["library_ms"] = cs.device_ms(lambda: src[idx.long()].sum(1))
        rec["scale2_256x128_ms"] = cs.device_ms(lambda: probe.scale2(x))
        print(f"gather_bench {label}: {json.dumps(rec)}", flush=True)
        cases.append(rec)
    path = out / "gather_bench.json"
    path.write_text(json.dumps({"device": smi, "sass": sass, "cases": cases}, indent=1))
    print(f"gather_bench: wrote {path}", flush=True)


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    if not args or args[0] not in ("prepare", "run") or len(args) > 2:
        print("usage: python3 gather_bench.py prepare [REV] | run [OUT_DIR]", file=sys.stderr)
        return 2
    if args[0] == "run" and not torch.cuda.is_available():
        print("gather_bench: no CUDA device", file=sys.stderr)
        return 1
    (prepare if args[0] == "prepare" else run)(*args[1:])
    return 0


if __name__ == "__main__":
    sys.exit(main())
