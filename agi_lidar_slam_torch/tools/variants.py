"""Earlier and altered versions of a kernel source, built beside the current
one by the development benches (knn_bench.py, gather_bench.py at the root).

`git_source` reads a source as of a git revision, `replaced` alters a line of
it (and raises if the line is gone, so that a bench notices an edited
kernel), and `build_library` compiles the sources a bench wrote, one nvcc
each, all started together, and links them into one shared library. A bench
renames each version's C symbols so that they can share the library.
"""

from __future__ import annotations

import ctypes
import pathlib
import subprocess

from .. import _build


def git_source(root: pathlib.Path, path: str, rev: str) -> str:
    """The file `path` (relative to the checkout `root`) as of `rev`."""
    return subprocess.run(["git", "show", f"{rev}:{path}"], cwd=root, check=True,
                          capture_output=True, text=True).stdout


def replaced(s: str, old: str, new: str, every: bool = False) -> str:
    """s with `old` (found once, or at least once if `every`) replaced."""
    if s.count(old) != 1 and not (every and s.count(old)):
        raise RuntimeError(f"the kernel source changed: {old[:60]!r} found {s.count(old)} times")
    return s.replace(old, new)


def build_library(build_dir: pathlib.Path, names, lib_name: str) -> ctypes.CDLL:
    """Compile build_dir/{name}.cu for each name (nvcc -Xptxas -v, its output
    printed) and link them into build_dir/{lib_name}; raises if one fails."""
    nvcc = _build.find_nvcc()
    jobs = [(name, subprocess.Popen(
        [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", str(build_dir / f"{name}.o"),
         str(build_dir / f"{name}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)) for name in names]
    failed = []
    for name, proc in jobs:
        log, _ = proc.communicate()
        print(f"--- {name}\n{log}", flush=True)
        if proc.returncode:
            failed.append(name)
    if failed:
        raise RuntimeError(f"nvcc failed on {', '.join(failed)}")
    so = build_dir / lib_name
    subprocess.run([nvcc, *_build.NVCC_FLAGS, "-shared", "-o", str(so),
                    *(str(build_dir / f"{name}.o") for name in names)], check=True)
    return ctypes.CDLL(str(so))
