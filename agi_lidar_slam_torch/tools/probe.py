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

import numpy as np
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


# The card claims rows (each distinct row read once) only where claims were
# measured to pay (chip_smoke.py's claims sweep, PERF.md): more indices than
# rows and at least this many bytes of gathered rows, so that the re-reads
# saved outweigh the atomics and the waits. The kernel reads rows of 64
# sub-voxels on a 16-byte aligned table with 16-byte loads, others with
# 4-byte loads, which gather more slowly, so claims pay sooner there.
CLAIM_MIN_BYTES = {"16-byte": 32 * 2**20, "4-byte": 8 * 2**20}


def claims_pay(n: int, rows: int, bucket: int, aligned: bool, capturing: bool) -> bool:
    """Whether a gather of n indices into a (rows, bucket, 3) table (16-byte
    aligned or not) claims rows. Never under CUDA graph capture: the epoch is
    a launch argument, so a replay would find the captured launch's tags and
    read its sums."""
    loads = "16-byte" if bucket == 64 and aligned else "4-byte"
    return not capturing and n > rows and n * bucket * 12 >= CLAIM_MIN_BYTES[loads]


def _capturing(t: torch.Tensor) -> bool:
    return t.device.type == "cuda" and torch.cuda.is_current_stream_capturing()


def row_gather_sum(idx: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """(n,3) row sums of the gathered (B,3) rows src[idx]. On the card each
    distinct row is read once where `claims_pay`, else every index reads its
    row."""
    claims = src.dim() == 3 and claims_pay(idx.shape[0], src.shape[0], src.shape[1],
                                           src.data_ptr() % 16 == 0, _capturing(idx))
    return _row_gather(idx, src, claims)


def _row_gather(idx: torch.Tensor, src: torch.Tensor, claims: bool) -> torch.Tensor:
    _check("idx", idx, torch.int32, idx.device)
    _check("src", src, torch.float32, idx.device)
    if idx.dim() != 1 or src.dim() != 3 or src.shape[2] != 3 or src.shape[0] == 0:
        raise ValueError(f"expected idx (n,) and src (rows,B,3), got {tuple(idx.shape)} "
                         f"and {tuple(src.shape)}")
    if src.numel() >= 2**31:
        raise ValueError(f"row_gather_sum takes src below 2**31 elements, got {src.numel()}")
    if claims and _capturing(idx):
        raise RuntimeError("row_gather_sum cannot claim rows under CUDA graph capture")
    if idx.device.type == "cpu":
        return row_gather_sum_ref(idx, src)
    if idx.device.type != "cuda":
        raise ValueError(f"row_gather_sum runs on cpu or cuda tensors, not {idx.device}")
    n = idx.shape[0]
    out = torch.empty((n, 3), dtype=torch.float32, device=idx.device)
    if n == 0:
        return out
    device, stream = _device_args(idx)
    tag = sums = None
    epoch = 0
    if claims:
        tag, sums, epoch = gather_scratch((device, stream), src.shape[0], idx.device)
    lib = _build.load()
    _raise_on(lib.row_gather_sum_launch(
        idx.data_ptr(), src.data_ptr(), out.data_ptr(), n, src.shape[0], src.shape[1],
        tag.data_ptr() if claims else None, sums.data_ptr() if claims else None, epoch,
        device, stream), "row_gather_sum", lib)
    launches["row_gather_sum"] += 1
    return out


# the row gather's scratch for each (device, stream): a claim tag (int32) and
# (x, y, z, epoch stamp) per row, and the epoch of the last launch. Launches
# on one stream run in turn; scratch shared by two streams would let one
# launch's epoch overtake the other's claims.
_scratch: dict = {}
EPOCH_LIMIT = 2**31 - 1  # the launcher takes epochs in [1, 2**31 - 1)


def gather_scratch(key, rows: int, device):
    """(tag, sums, epoch) for the next row-gather launch on `key`: scratch of
    at least `rows` rows, grown by doubling (zeroed when new), and the epoch
    advanced; at EPOCH_LIMIT the tags and stamps are zeroed on the stream and
    the epoch starts again at 1."""
    s = _scratch.get(key)
    if s is None or s[0].numel() < rows:
        cap = max(rows, 2 * s[0].numel() if s is not None else 0)
        s = _scratch[key] = [torch.zeros(cap, dtype=torch.int32, device=device),
                             torch.zeros((cap, 4), dtype=torch.float32, device=device), 0]
    s[2] += 1
    if s[2] >= EPOCH_LIMIT:
        s[0].zero_()
        s[1].zero_()
        s[2] = 1
    return s[0], s[1], s[2]


def probe_inputs(C: int = 64, B: int = 64, rows: int = 4096, tiles: int = 8, device=None):
    """The reference probe's `src` (arange over (rows,B,3)) and `idx`
    ((97 t) mod rows for t < tiles*C, one gathered row per tile slot)."""
    device = default_device(device)
    src = torch.arange(rows * B * 3, dtype=torch.float32, device=device).reshape(rows, B, 3)
    idx = ((torch.arange(tiles * C, dtype=torch.int64, device=device) * 97) % rows).to(torch.int32)
    return src, idx


def distinct_inputs(B: int = 64, rows: int = 16640, seed: int = 0, device=None):
    """The probe's table (`probe_inputs`) and a permutation of its rows made
    from `seed`: each row gathered once."""
    src, _ = probe_inputs(1, B, rows, 1, device)
    perm = np.random.default_rng(seed).permutation(rows).astype(np.int32)
    return src, torch.from_numpy(perm).to(src.device)


def one_row_inputs(n: int = 65536, B: int = 64, rows: int = 16640, seed: int = 0, device=None):
    """The probe's table and `n` copies of one row chosen from `seed`."""
    src, _ = probe_inputs(1, B, rows, 1, device)
    row = int(np.random.default_rng(seed).integers(rows))
    return src, torch.full((n,), row, dtype=torch.int32, device=src.device)


def bucket_inputs(B: int, rows: int, n: int, seed: int = 0, device=None):
    """A (rows, B, 3) table of whole numbers in [1, 1024], so every row sum is
    exact in f32, and `n` indices in [-4, rows + 4): some outside the table."""
    rng = np.random.default_rng(seed)
    src = rng.integers(1, 1025, (rows, B, 3)).astype(np.float32)
    idx = rng.integers(-4, rows + 4, n).astype(np.int32)
    device = default_device(device)
    return torch.from_numpy(src).to(device), torch.from_numpy(idx).to(device)


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
    """Bytes a row gather-sum must move: each distinct row in the table read
    once, the indices read, the sums written."""
    inside = idx[(idx >= 0) & (idx < src.shape[0])].long()
    distinct = int((torch.bincount(inside, minlength=src.shape[0]) > 0).sum())
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
