"""ctypes bindings for the native (C++) prefetching scan loader (port of
agi_lidar_slam_tpu/io/native_loader.py).

`io/native/lidar_io.cpp` is compiled with g++ at first use into the
git-ignored `agi_lidar_slam_torch/_build/` (`_build.build_host`); a failed
build raises, and nothing falls back to the pure-Python `io/kitti.py`.

On the card each scan leaves the loader through pinned host memory with a
non-blocking copy (a copy from pageable memory synchronizes). The loader
writes the next scan into its host buffers while the card may still be
copying the last one, so it keeps N_BUFFERS pinned sets and uses them in
turn, each reused only after the event recorded behind its copies has
completed.

Usage:
    with NativeKittiLoader(paths, rings=64, width=1800, device="cuda") as loader:
        for scan in loader:          # yields ScanGrid, prefetched off-thread
            state, res = process_scan(state, scan, cfg)
"""

from __future__ import annotations

import ctypes
import time
from pathlib import Path
from typing import Iterator, Sequence

import torch

from .. import _build
from ..device import default_device
from ..pointcloud.cloud import ScanGrid

_SRC = Path(__file__).resolve().parent / "native" / "lidar_io.cpp"
N_BUFFERS = 3  # pinned host sets used in turn on the card (two or more)

_lib = None


def build_native() -> str:
    """Compile the loader library unless it is built; returns the .so path."""
    return str(_build.build_host(_SRC, "lidar_io"))


def _load_lib():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build_native())
        lib.loader_create.restype = ctypes.c_void_p
        lib.loader_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_int, ctypes.c_int,
        ]
        lib.loader_next.restype = ctypes.c_int64
        lib.loader_next.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 3
        lib.loader_destroy.argtypes = [ctypes.c_void_p]
        lib.lz4_frame_decode.restype = ctypes.c_int64
        lib.lz4_frame_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64
        ]
        _lib = lib
    return _lib


class NativeKittiLoader:
    """Prefetching scan iterator backed by the C++ thread pool, yielding
    ScanGrids on `device` (default: cuda). `wait_s` accumulates the host time
    spent waiting for the loader, `n_scans` the scans it gave."""

    def __init__(
        self,
        paths: Sequence[str],
        rings: int = 64,
        width: int = 1800,
        fov_up: float = 2.0,
        fov_down: float = -24.8,
        min_range: float = 0.5,
        n_threads: int = 3,
        queue_depth: int = 6,
        device=None,
    ):
        self.rings, self.width = rings, width
        self.device = default_device(device)
        cuda = self.device.type == "cuda"
        lib = _load_lib()
        arr = (ctypes.c_char_p * len(paths))(*[str(p).encode() for p in paths])
        self._lib = lib
        self._h = lib.loader_create(
            arr, len(paths), rings, width,
            ctypes.c_float(fov_up), ctypes.c_float(fov_down),
            ctypes.c_float(min_range), n_threads, queue_depth,
        )
        # on the CPU each scan is copied out of one host set; on the card the
        # sets are pinned and used in turn
        n = N_BUFFERS if cuda else 1
        self._bufs = [(torch.empty((rings, width, 3), dtype=torch.float32, pin_memory=cuda),
                       torch.empty((rings, width), dtype=torch.uint8, pin_memory=cuda),
                       torch.empty((rings, width), dtype=torch.float32, pin_memory=cuda))
                      for _ in range(n)]
        self._events = [torch.cuda.Event() if cuda else None for _ in range(n)]
        self.wait_s = 0.0
        self.n_scans = 0

    def __iter__(self) -> Iterator[ScanGrid]:
        cuda = self.device.type == "cuda"
        while True:
            slot = self.n_scans % len(self._bufs)
            xyz, mask, tgrid = self._bufs[slot]
            ev = self._events[slot]
            t0 = time.perf_counter()
            if ev is not None and not ev.query():
                ev.synchronize()  # the last copy out of this set is still running
            idx = self._lib.loader_next(self._h, xyz.data_ptr(), mask.data_ptr(),
                                        tgrid.data_ptr())
            self.wait_s += time.perf_counter() - t0
            if idx < 0:
                return
            self.n_scans += 1
            if cuda:
                out = ScanGrid(xyz.to(self.device, non_blocking=True),
                               mask.view(torch.bool).to(self.device, non_blocking=True),
                               tgrid.to(self.device, non_blocking=True))
                ev.record()
            else:  # the next loader_next overwrites the host set
                out = ScanGrid(xyz.clone(), mask.view(torch.bool).clone(), tgrid.clone())
            yield out

    def close(self):
        if self._h:
            self._lib.loader_destroy(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
