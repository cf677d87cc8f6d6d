// Batched symmetric eigendecomposition of small matrices for Hopper (sm_90a).
//
// Replaces no TPU kernel. On the TPU the Gauss-Newton solves call XLA's eigh
// inside the jitted scan, where it costs nothing extra; on the card
// torch.linalg.eigh reads its error flag back to the host after every call,
// 8 times an odometry scan (estimators/gn_scan2map.solve_delta), and so a
// scan could neither run ahead of the host nor be captured in a CUDA graph.
// This kernel computes the same function with nothing read back. The
// two-step solve's 3x3 steps (estimators/two_step._solve_subset) run the same
// Jacobi code (jacobi.cuh) inside gn_iter.cu's gn_subset kernel on the card.
//
// What it computes: for each of `batch` row-major (n, n) float32 matrices,
// n <= 8, read from the lower triangle as torch.linalg.eigh does, the
// eigenvalues in ascending order and the eigenvectors as the columns of an
// orthonormal (n, n) matrix: torch.linalg.eigh's contract. Equal eigenvalues
// have no unique eigenvectors and neither routine promises which basis comes
// out; a NaN or infinite entry gives NaN in every output of its matrix.
//
// Design: one thread a matrix, cyclic Jacobi in fp64 registers (jacobi.cuh,
// shared with the Gauss-Newton step of gn_iter.cu). The kernel is
// instantiated for each n, so every loop over rows and columns unrolls and
// the packed lower triangle (n(n+1)/2 doubles) and the rotation matrix (n*n
// doubles) stay in registers. The results are rounded to float32 once, at
// the end; the eigenvalues come sorted with their columns.
//
// What bounds it: neither bytes nor operations (a 6x6 matrix is 144 B in and
// 168 B out, about 2000 flops): each rotation is a chain of dependent fp64
// divisions and square roots, so one matrix takes the latency of its sweeps.
// See PERF.md for its time beside torch.linalg.eigh's.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "jacobi.cuh"

namespace {

constexpr int kMaxN = 8;
constexpr int kThreads = 64;

using jacobi::lo;

template <int N>
__global__ void __launch_bounds__(kThreads)
    sym_eig_kernel(const float* __restrict__ in, float* __restrict__ vals,
                   float* __restrict__ vecs, int batch) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  constexpr int T = N * (N + 1) / 2;
  const float* src = in + (size_t)b * N * N;
  double a[T];
  double norm2 = 0.0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      const double x = (double)src[i * N + j];
      a[lo(i, j)] = x;
      norm2 += (i == j ? 1.0 : 2.0) * x * x;
    }
  }
  const bool finite = isfinite(norm2);
  double d[N];
  double v[N][N];
  jacobi::eig_sorted<N>(a, norm2, d, v);
  const float nan = __int_as_float(0x7fffffff);
  float* out_v = vals + (size_t)b * N;
  float* out_m = vecs + (size_t)b * N * N;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    out_v[i] = finite ? (float)d[i] : nan;
#pragma unroll
    for (int j = 0; j < N; ++j) out_m[i * N + j] = finite ? (float)v[i][j] : nan;
  }
}

template <int N>
int launch(const float* in, float* vals, float* vecs, int batch, cudaStream_t stream) {
  const int blocks = (batch + kThreads - 1) / kThreads;
  sym_eig_kernel<N><<<blocks, kThreads, 0, stream>>>(in, vals, vecs, batch);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` (a cudaStream_t) and returns cudaGetLastError() of the
// launch; a batch below 1 or an n outside [1, 8] returns cudaErrorInvalidValue.
// `in` holds batch row-major (n, n) matrices; `vals` receives (batch, n) and
// `vecs` (batch, n, n), eigenvectors as columns.
int sym_eig_launch(const float* in, float* vals, float* vecs, int batch, int n, int device,
                   void* stream) {
  if (batch < 1 || n < 1 || n > kMaxN || device < 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  switch (n) {
    case 1: return launch<1>(in, vals, vecs, batch, s);
    case 2: return launch<2>(in, vals, vecs, batch, s);
    case 3: return launch<3>(in, vals, vecs, batch, s);
    case 4: return launch<4>(in, vals, vecs, batch, s);
    case 5: return launch<5>(in, vals, vecs, batch, s);
    case 6: return launch<6>(in, vals, vecs, batch, s);
    case 7: return launch<7>(in, vals, vecs, batch, s);
    default: return launch<8>(in, vals, vecs, batch, s);
  }
}

const char* sym_eig_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
