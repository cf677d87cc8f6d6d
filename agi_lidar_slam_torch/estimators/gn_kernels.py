"""A Gauss-Newton step of the scan-to-map solves on the card, fused
(csrc/gn_iter.cu).

`rotation` and `rows` take the normal equations' work row by row: R of the
pose, then every corner and surf row's weighted residual and Jacobian in one
launch, between the two torch products whose rounding order only cuBLAS
knows (R [x]x and the surf rows' n^T A); the sums over the rows stay the
torch reductions. `update` is the 6-dof step's tail (solve_delta's clip on
the step the torch solve computed, se3.boxplus, the residual rms and the
degenerate flag); `subset_step` the two-step solve's whole step after its
normal equations (_solve_subset on the 3x3 sub-block, its
eigendecomposition the Jacobi code of sym_eig's kernel, then boxplus and the
stats). Together they take a 6-dof step from about 200 torch launches to
about 60 and a two-step step to about 45, and read nothing back to the host.

Bit for bit the torch code they replace (see the source note): each rounds
where the torch ops round, in their order. The benchmark's check needs that
(PERF.md, section 7). Those orders are torch's and cuBLAS's, measured with the
versions in MEASURED_ON; `versions()` reads the running ones, and
chip_smoke.py and the card tests refuse others until the orders are
measured again. They replace no TPU kernel. Each takes CUDA tensors only,
and raises on anything else: the solvers take the torch code on the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..geometry import se3

# kernel launches since the last reset, by kernel
launches = {"gn_rotation": 0, "gn_rows": 0, "gn_update": 0, "gn_subset": 0}

# the versions of torch, its CUDA and cuBLAS whose rounding orders the
# kernels copy (measured on an NVIDIA H100 80GB HBM3)
MEASURED_ON = {"torch": "2.11.0+cu128", "cuda": "12.8", "cublas": "12.9.2"}


def versions() -> dict:
    """The running torch's version, its CUDA's and that of the cuBLAS it
    loaded ("major.minor.patch"; None where no cuBLAS of that CUDA loads)."""
    out = {"torch": torch.__version__, "cuda": torch.version.cuda, "cublas": None}
    if torch.version.cuda is None:
        return out
    try:  # the library torch loaded: dlopen by its soname finds that one
        lib = ctypes.CDLL(f"libcublas.so.{torch.version.cuda.split('.')[0]}")
    except OSError:
        return out
    parts = []
    for prop in range(3):  # libraryPropertyType: MAJOR_VERSION, MINOR_VERSION, PATCH_LEVEL
        v = ctypes.c_int()
        if lib.cublasGetProperty(prop, ctypes.byref(v)) != 0:
            return out
        parts.append(str(v.value))
    out["cublas"] = ".".join(parts)
    return out


def _device_args(dev: torch.device):
    if dev.type != "cuda":
        raise ValueError(f"the Gauss-Newton step kernels take cuda tensors, not {dev}")
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return index, torch.cuda.current_stream(dev).cuda_stream


def _checked(x: torch.Tensor, name: str, dev: torch.device, dtype, shape) -> torch.Tensor:
    if x.device != dev or x.dtype != dtype or tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)} on {dev}, got {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")
    return x.contiguous()


def _outputs(dev: torch.device):
    return (torch.empty(7, dtype=torch.float32, device=dev),
            torch.empty((), dtype=torch.float32, device=dev),
            torch.empty((), dtype=torch.bool, device=dev))


def _launched(err: int, lib, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err} "
                           f"({lib.gn_step_error_string(err).decode()})")
    launches[name] += 1


def rotation(q: torch.Tensor) -> torch.Tensor:
    """so3.quat_to_matrix(q) of one quaternion (4,): a (3, 3) tensor."""
    dev = q.device
    index, stream = _device_args(dev)
    q = _checked(q, "q", dev, torch.float32, (4,))
    lib = _build.load()
    R = torch.empty((3, 3), dtype=torch.float32, device=dev)
    _launched(lib.gn_rotation_launch(q.data_ptr(), R.data_ptr(), index, stream), lib,
              "gn_rotation")
    return R


def rows(R: torch.Tensor, t: torch.Tensor, corners, surfs, corr, RA: torch.Tensor,
         Jr_s: torch.Tensor, huber_delta: float):
    """The weighted rows of normal_equations at the pose (R, t): (e_w (Nc, 3),
    J_w (Nc, 3, 6), r_sw (Ns,), Js_w (Ns, 6)). `corners`, `surfs` are
    PointBatches, `corr` the gn_scan2map.Correspondences, `RA` (Nc, 3, 3)
    R [x]x of each corner point and `Jr_s` (Ns, 3) the surf rows' rotation
    Jacobian, from the torch ops."""
    dev = R.device
    index, stream = _device_args(dev)
    f32 = torch.float32
    nc, ns = corners.xyz.shape[0], surfs.xyz.shape[0]
    ins = [_checked(R, "R", dev, f32, (3, 3)), _checked(t, "t", dev, f32, (3,)),
           _checked(corners.xyz, "corners.xyz", dev, f32, (nc, 3)),
           _checked(corr.line_centroid, "line_centroid", dev, f32, (nc, 3)),
           _checked(corr.line_dir, "line_dir", dev, f32, (nc, 3)),
           _checked(corr.ok_c, "ok_c", dev, torch.bool, (nc,)),
           _checked(RA, "RA", dev, f32, (nc, 3, 3)),
           _checked(surfs.xyz, "surfs.xyz", dev, f32, (ns, 3)),
           _checked(corr.plane_n, "plane_n", dev, f32, (ns, 3)),
           _checked(corr.plane_d, "plane_d", dev, f32, (ns,)),
           _checked(corr.ok_s, "ok_s", dev, torch.bool, (ns,)),
           _checked(Jr_s, "Jr_s", dev, f32, (ns, 3))]
    lib = _build.load()
    outs = (torch.empty((nc, 3), dtype=f32, device=dev),
            torch.empty((nc, 3, 6), dtype=f32, device=dev),
            torch.empty((ns,), dtype=f32, device=dev),
            torch.empty((ns, 6), dtype=f32, device=dev))
    p = [x.data_ptr() for x in ins]
    err = lib.gn_rows_launch(*p[:7], nc, *p[7:], ns, float(huber_delta),
                             *(x.data_ptr() for x in outs), index, stream)
    _launched(err, lib, "gn_rows")
    return outs


def _done(err: int, lib, name: str, out, rms, degen):
    _launched(err, lib, name)
    return se3.Pose(out[:4], out[4:]), rms, degen


def update(delta: torch.Tensor, good: torch.Tensor, pose: se3.Pose, clip: float,
           sq: torch.Tensor, n_rows: torch.Tensor):
    """solve_delta's tail and boxplus: the step `delta` (6,) scaled down to a
    translation of at most `clip`, applied to `pose`; `good` (6,) the flags
    of its eigendirections. Returns (pose, rms, degenerate), the rms of the
    step's square sum `sq` over its `n_rows` residual rows."""
    dev = delta.device
    index, stream = _device_args(dev)
    f32 = torch.float32
    delta = _checked(delta, "delta", dev, f32, (6,))
    good = _checked(good, "good", dev, torch.bool, (6,))
    q = _checked(pose.q, "pose.q", dev, f32, (4,))
    t = _checked(pose.t, "pose.t", dev, f32, (3,))
    sq, n_rows = _checked(sq, "sq", dev, f32, ()), _checked(n_rows, "n_rows", dev, f32, ())
    lib = _build.load()
    out, rms, degen = _outputs(dev)
    err = lib.gn_update_launch(delta.data_ptr(), good.data_ptr(), float(clip), q.data_ptr(),
                               t.data_ptr(), sq.data_ptr(), n_rows.data_ptr(), out.data_ptr(),
                               rms.data_ptr(), degen.data_ptr(), index, stream)
    return _done(err, lib, "gn_update", out, rms, degen)


def subset_step(H: torch.Tensor, g: torch.Tensor, dofs: tuple, eig_thresh: float,
                pose: se3.Pose, sq: torch.Tensor, n_rows: torch.Tensor, prev: tuple | None = None):
    """_solve_subset(H, g, dofs, eig_thresh) and boxplus: the clamped solution
    of H d = -g on the three increasing entries `dofs` of d (the others 0),
    applied to `pose`. `prev = (sq, n_rows, degenerate)` of the iteration's
    earlier step merges into the stats. Returns (pose, rms, degenerate)."""
    dev = H.device
    index, stream = _device_args(dev)
    f32 = torch.float32
    if len(dofs) != 3 or sorted(set(dofs)) != list(dofs) or not 0 <= dofs[0] <= dofs[-1] < 6:
        raise ValueError(f"dofs must be three increasing entries of 0..5, got {dofs}")
    H = _checked(H, "H", dev, f32, (6, 6))
    g = _checked(g, "g", dev, f32, (6,))
    q = _checked(pose.q, "pose.q", dev, f32, (4,))
    t = _checked(pose.t, "pose.t", dev, f32, (3,))
    sq, n_rows = _checked(sq, "sq", dev, f32, ()), _checked(n_rows, "n_rows", dev, f32, ())
    p_sq = p_rows = p_degen = None
    if prev is not None:
        p_sq, p_rows = (_checked(x, "prev", dev, f32, ()) for x in prev[:2])
        p_degen = _checked(prev[2], "prev degenerate", dev, torch.bool, ())
    lib = _build.load()
    out, rms, degen = _outputs(dev)
    ptr = (lambda x: None if x is None else x.data_ptr())
    err = lib.gn_subset_launch(H.data_ptr(), g.data_ptr(), sum(1 << i for i in dofs),
                               float(eig_thresh), q.data_ptr(), t.data_ptr(), sq.data_ptr(),
                               n_rows.data_ptr(), ptr(p_sq), ptr(p_rows), ptr(p_degen),
                               out.data_ptr(), rms.data_ptr(), degen.data_ptr(), index, stream)
    return _done(err, lib, "gn_subset", out, rms, degen)
