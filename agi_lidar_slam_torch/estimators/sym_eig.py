"""Batched symmetric eigendecomposition of small matrices (n <= 8): the
Gauss-Newton solves' eigh, without a read back to the host.

`sym_eig(a)` has torch.linalg.eigh's contract: for (..., n, n) float32
matrices, read from their lower triangle, it returns (eigenvalues (..., n)
ascending, eigenvectors (..., n, n) as columns of an orthonormal matrix). On
CPU tensors it is torch.linalg.eigh itself, its plain version, so every CPU
result of the port on a finite matrix is unchanged. On CUDA tensors it
launches the kernel of csrc/sym_eig.cu (cyclic Jacobi in fp64, one thread a
matrix; see its source note) on the current stream, or raises: there is no
fallback. A matrix with a NaN or infinite entry in the lower triangle it is
read from gives NaN in all its outputs on both devices, as jnp.linalg.eigh
does in the reference (the Gauss-Newton systems are symmetric, so their
upper triangle holds the same entries): torch.linalg.eigh raises on such a
matrix, so on the CPU eigh gets the identity in its place and its outputs
are set to NaN after, with no read back to the host.

It replaces no TPU kernel. torch.linalg.eigh on the card reads its error
flag back to the host after every call, which stalls the host once per
Gauss-Newton step (8 times an odometry scan) and makes a scan impossible to
capture in a CUDA graph (runtime/pipeline.process_scan_chunk); the kernel
reads nothing back. The 6-dof steps (gn_scan2map.solve_delta, `_delta`) call
it on the card; the two-step solve's 3x3 steps run its Jacobi code
(csrc/jacobi.cuh) inside their own kernel (estimators/gn_kernels.subset_step)
and call it only on the CPU. Its time beside torch.linalg.eigh's is in
PERF.md.
"""

from __future__ import annotations

import torch

from .. import _build

MAX_N = 8  # the largest matrix the kernel takes

launches = 0  # kernel launches made by sym_eig since the last reset


def sym_eig_ref(a: torch.Tensor):
    """The plain version: torch.linalg.eigh."""
    return torch.linalg.eigh(a)


def _eigh_nan(a: torch.Tensor):
    """torch.linalg.eigh with NaN outputs for a matrix that holds a
    non-finite entry in its lower triangle (the one eigh and the kernel
    read), where eigh raises: such a matrix goes to eigh as the identity,
    and its outputs are set to NaN after, with no read back to the host.
    Any other matrix gets eigh's own numbers, bit for bit."""
    bad = ~torch.isfinite(torch.tril(a)).all(dim=(-2, -1))
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    vals, vecs = sym_eig_ref(torch.where(bad[..., None, None], eye, a))
    nan = torch.full((), float("nan"), dtype=a.dtype, device=a.device)
    return (torch.where(bad[..., None], nan, vals),
            torch.where(bad[..., None, None], nan, vecs))


def sym_eig(a: torch.Tensor):
    """(eigenvalues ascending, eigenvectors as columns) of the symmetric
    matrices `a` (..., n, n): torch.linalg.eigh on CPU tensors (NaN for a
    non-finite lower triangle), the kernel on CUDA tensors (float32, 1 <= n <= 8,
    raising on anything else)."""
    if a.device.type == "cpu":
        return _eigh_nan(a)
    if a.device.type != "cuda":
        raise ValueError(f"sym_eig runs on cpu or cuda tensors, not {a.device}")
    if a.dtype != torch.float32:
        raise ValueError(f"sym_eig's kernel takes float32 matrices, got {a.dtype}")
    if a.dim() < 2 or a.shape[-1] != a.shape[-2] or not 1 <= a.shape[-1] <= MAX_N:
        raise ValueError(f"sym_eig's kernel takes (..., n, n) matrices with 1 <= n <= {MAX_N}, "
                         f"got {tuple(a.shape)}")
    return _launch(a)


def _launch(a: torch.Tensor):
    """Launch the kernel on the current stream; `a` already checked."""
    global launches
    lib = _build.load()
    n = a.shape[-1]
    batch = a.shape[:-2]
    flat = a.reshape(-1, n, n).contiguous()
    B = flat.shape[0]
    dev = a.device
    vals = torch.empty((B, n), dtype=torch.float32, device=dev)
    vecs = torch.empty((B, n, n), dtype=torch.float32, device=dev)
    if B > 0:
        err = lib.sym_eig_launch(
            flat.data_ptr(), vals.data_ptr(), vecs.data_ptr(), B, n,
            dev.index if dev.index is not None else torch.cuda.current_device(),
            torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"sym_eig kernel launch failed: cudaError {err} "
                               f"({lib.sym_eig_error_string(err).decode()})")
        launches += 1
    return vals.reshape(*batch, n), vecs.reshape(*batch, n, n)
