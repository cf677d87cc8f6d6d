"""Build and load the port's CUDA kernels from `csrc/` at first use.

Every `csrc/*.cu` is compiled by its own nvcc process, all started together,
for Hopper (sm_90a); the objects are linked into one shared library with a
plain C interface under `agi_lidar_slam_torch/_build/`, named by a hash of the
sources and flags so an edited source rebuilds. The library
is loaded with ctypes; pointers and the stream pass as `c_void_p`, ints as
`c_int`, floats as `c_float`. Nothing is downloaded and no prebuilt kernel
package is used.

Host C++ (the KITTI loader and LZ4 decoder, `io/native/lidar_io.cpp`) is
built the same way with g++ (`build_host`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # queries, qmask, points, occ, ktab, n, bucket, k, probes, log2_slots,
    # sub_voxel, block_sub, block_size, out_sq, out_pts, out_valid, device, stream
    "octant_knn_launch": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _F,
                           _P, _P, _P, _I, _P], _I),
    # bucket, tile out, stage_rows out, smem_bytes out
    "octant_knn_launch_shape": ([_I] + 3 * [ctypes.POINTER(_I)], _I),
    "octant_knn_error_string": ([_I], ctypes.c_char_p),
    # x, o, n, device, stream
    "scale2_launch": ([_P, _P, _I, _I, _P], _I),
    # idx, src, out, n, rows, bucket, tag, sums, epoch, device, stream
    "row_gather_sum_launch": ([_P, _P, _P, _I, _I, _I, _P, _P, ctypes.c_uint, _I, _P], _I),
    # driver version out, runtime version out
    "probe_versions": ([ctypes.POINTER(_I), ctypes.POINTER(_I)], _I),
    "probe_error_string": ([_I], ctypes.c_char_p),
}

_lib: ctypes.CDLL | None = None


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME/bin, else PATH, else the toolkit's default
    install prefix; raises if there is none."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        cands.append(on_path)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and /usr/local/cuda/bin): "
        "the port's CUDA kernels cannot be built")


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(SRC_DIR.glob("*.cu")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libagi_lidar_slam_kernels-{h.hexdigest()[:16]}.so"


def _check(cmd, rc: int, log: str, verbose: bool) -> None:
    if rc != 0:
        raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{log}")
    if verbose and log:
        print(log, flush=True)


def build(verbose: bool = False) -> Path:
    """Compile csrc/*.cu unless the library for these sources exists; returns
    its path. Raises RuntimeError with nvcc's output if the build fails."""
    out = library_path()
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    ptxas = ["-Xptxas", "-v"] if verbose else []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = []  # one nvcc per source, all running at once
        for src in sorted(SRC_DIR.glob("*.cu")):
            cmd = [nvcc, *NVCC_FLAGS, *ptxas, "-c", "-o", str(Path(tmp) / f"{src.stem}.o"),
                   str(src)]
            jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                               stderr=subprocess.STDOUT, text=True)))
        try:
            for cmd, proc in jobs:
                log, _ = proc.communicate()
                _check(cmd, proc.returncode, log, verbose)
        finally:
            for _, proc in jobs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        lib = Path(tmp) / "lib.so"
        link = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(lib), *(cmd[-2] for cmd, _ in jobs)]
        proc = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        _check(link, proc.returncode, proc.stdout, verbose)
        os.replace(lib, out)  # atomic: concurrent builds race harmlessly
    return out


HOST_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]


def build_host(src: Path, name: str) -> Path:
    """Compile one host C++ source with g++ into a shared library under
    BUILD_DIR, named by a hash of the source and flags, unless it exists;
    returns its path. Raises RuntimeError with g++'s output if the build
    fails (nothing falls back)."""
    h = hashlib.sha256(" ".join(HOST_FLAGS).encode() + Path(src).read_bytes())
    out = BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found on PATH: {src} cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        lib = Path(tmp) / "lib.so"
        cmd = [gxx, *HOST_FLAGS, str(src), "-o", str(lib)]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}")
        os.replace(lib, out)  # atomic: concurrent builds race harmlessly
    return out


def load() -> ctypes.CDLL:
    """The kernel library, built if needed, with every C signature declared."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _lib = lib
    return _lib
