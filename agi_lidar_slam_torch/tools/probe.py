"""GPU toolchain and row-gather probes (port of tools/pallas_probe.py).

    python -m agi_lidar_slam_torch.tools.probe [stage0|stage1|stage2|all]

* stage0: build the port's kernels with nvcc and launch `scale2` (o = 2 x)
  on a (256,128) tensor; report the CUDA driver, runtime and nvcc versions.
* stage1: the row-gather kernel `row_gather_sum` on the reference probe's
  access pattern (`src` = arange over (rows, B, 3), `idx` = 97 t mod rows):
  20 chained launches timed with CUDA events, ns per gathered row and GB/s.
* stage2: the library gather `src[idx].sum(1)` on the same access pattern,
  timed the same way.

The kernels are csrc/probe.cu. `scale2_ref` and `row_gather_sum_ref` are
their plain PyTorch versions: the wrappers take them for CPU tensors, and on
CUDA tensors launch the kernel or raise. The stages need a card.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import torch

from .. import _build
from ..device import default_device

# kernel launches made by the wrappers since the last reset
launches = {"scale2": 0, "row_gather_sum": 0}
N_CHAINED = 20


def scale2_ref(x: torch.Tensor) -> torch.Tensor:
    """o = 2 x."""
    return x * 2.0


def row_gather_sum_ref(idx: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """out[i] = sum_b src[idx[i], b, :] for idx (n,) int32 and src (rows,B,3)
    f32; NaN where idx[i] is outside [0, rows)."""
    ok = (idx >= 0) & (idx < src.shape[0])
    rows = src[torch.clamp(idx, 0, src.shape[0] - 1).long()].sum(dim=1)
    return torch.where(ok[:, None], rows, torch.full_like(rows, float("nan")))


def _device_args(t: torch.Tensor):
    dev = t.device
    return (dev.index if dev.index is not None else torch.cuda.current_device(),
            torch.cuda.current_stream(dev).cuda_stream)


def _raise_on(err: int, name: str, lib) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err} "
                           f"({lib.probe_error_string(err).decode()})")


def _check(name, t, dtype, device):
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")


def scale2(x: torch.Tensor) -> torch.Tensor:
    """o = 2 x for a contiguous f32 tensor of any shape."""
    _check("x", x, torch.float32, x.device)
    if x.numel() >= 2**31:
        raise ValueError(f"scale2 takes fewer than 2**31 elements, got {x.numel()}")
    if x.device.type == "cpu":
        return scale2_ref(x)
    if x.device.type != "cuda":
        raise ValueError(f"scale2 runs on cpu or cuda tensors, not {x.device}")
    o = torch.empty_like(x)
    if x.numel() == 0:
        return o
    lib = _build.load()
    _raise_on(lib.scale2_launch(x.data_ptr(), o.data_ptr(), x.numel(), *_device_args(x)),
              "scale2", lib)
    launches["scale2"] += 1
    return o


def row_gather_sum(idx: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """(n,3) row sums of the gathered (B,3) rows src[idx]."""
    _check("idx", idx, torch.int32, idx.device)
    _check("src", src, torch.float32, idx.device)
    if idx.dim() != 1 or src.dim() != 3 or src.shape[2] != 3 or src.shape[0] == 0:
        raise ValueError(f"expected idx (n,) and src (rows,B,3), got {tuple(idx.shape)} "
                         f"and {tuple(src.shape)}")
    if src.numel() >= 2**31:
        raise ValueError(f"row_gather_sum takes src below 2**31 elements, got {src.numel()}")
    if idx.device.type == "cpu":
        return row_gather_sum_ref(idx, src)
    if idx.device.type != "cuda":
        raise ValueError(f"row_gather_sum runs on cpu or cuda tensors, not {idx.device}")
    n = idx.shape[0]
    out = torch.empty((n, 3), dtype=torch.float32, device=idx.device)
    if n == 0:
        return out
    lib = _build.load()
    _raise_on(lib.row_gather_sum_launch(idx.data_ptr(), src.data_ptr(), out.data_ptr(), n,
                                        src.shape[0], src.shape[1], *_device_args(idx)),
              "row_gather_sum", lib)
    launches["row_gather_sum"] += 1
    return out


def probe_inputs(C: int = 64, B: int = 64, rows: int = 4096, tiles: int = 8, device=None):
    """The reference probe's `src` (arange over (rows,B,3)) and `idx`
    ((97 t) mod rows for t < tiles*C, one gathered row per tile slot)."""
    device = default_device(device)
    src = torch.arange(rows * B * 3, dtype=torch.float32, device=device).reshape(rows, B, 3)
    idx = ((torch.arange(tiles * C, dtype=torch.int64, device=device) * 97) % rows).to(torch.int32)
    return src, idx


def chained_ms(fn, n: int = N_CHAINED) -> float:
    """Milliseconds per call of `n` back-to-back calls of fn(), CUDA events
    around the whole chain, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def gather_bytes(idx: torch.Tensor, src: torch.Tensor) -> int:
    """Bytes a row gather-sum must move: each distinct row read once, the
    indices read, the sums written."""
    distinct = int(torch.unique(idx).numel())
    return distinct * src.shape[1] * 3 * 4 + idx.numel() * 4 + idx.numel() * 3 * 4


def versions() -> dict:
    """The CUDA driver's and runtime's versions, and nvcc's version line."""
    lib = _build.load()
    drv, rt = ctypes.c_int(0), ctypes.c_int(0)
    _raise_on(lib.probe_versions(ctypes.byref(drv), ctypes.byref(rt)), "probe_versions", lib)
    nvcc = subprocess.run([_build.find_nvcc(), "--version"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[-1]
    return {"driver": drv.value, "runtime": rt.value, "nvcc": nvcc}


def stage0(device=None) -> dict:
    device = default_device(device)
    x = torch.ones((256, 128), dtype=torch.float32, device=device)
    o = scale2(x)
    torch.cuda.synchronize()
    if not torch.equal(o, scale2_ref(x)):
        raise AssertionError("scale2 disagrees with 2 x")
    return {"stage": "stage0", "shape": [256, 128], "sum": float(o.sum()), **versions()}


def _gather_stage(name, fn, C, B, rows, tiles, device) -> dict:
    src, idx = probe_inputs(C, B, rows, tiles, device)
    ms = chained_ms(lambda: fn(idx, src))
    n = tiles * C
    return {"stage": name, "C": C, "B": B, "rows": rows, "tiles": tiles, "gathered_rows": n,
            "row_bytes": B * 3 * 4, "ms": ms, "ns_per_row": ms * 1e6 / n,
            "gathered_GB_per_s": n * B * 3 * 4 / (ms * 1e6),
            "bound_bytes": gather_bytes(idx, src)}


def stage1(C: int = 64, B: int = 64, rows: int = 4096, tiles: int = 8, device=None) -> dict:
    """The row-gather kernel: N_CHAINED chained launches."""
    device = default_device(device)
    return _gather_stage("stage1", row_gather_sum, C, B, rows, tiles, device)


def stage2(C: int = 64, B: int = 64, rows: int = 4096, tiles: int = 8, device=None) -> dict:
    """The library gather `src[idx].sum(1)` on the same access pattern."""
    device = default_device(device)
    return _gather_stage("stage2", lambda idx, src: src[idx.long()].sum(1), C, B, rows, tiles,
                         device)


def main(argv=None) -> int:
    which = (argv if argv is not None else sys.argv[1:]) or ["all"]
    stages = {"stage0": stage0, "stage1": stage1, "stage2": stage2}
    if len(which) != 1 or which[0] not in (*stages, "all"):
        print(f"usage: python -m agi_lidar_slam_torch.tools.probe [{'|'.join(stages)}|all]",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("probe: no CUDA device", file=sys.stderr)
        return 1
    for name, fn in stages.items():
        if which[0] in (name, "all"):
            print(json.dumps(fn()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
