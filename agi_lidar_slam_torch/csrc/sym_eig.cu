// Batched symmetric eigendecomposition of small matrices for Hopper (sm_90a).
//
// Replaces no TPU kernel. On the TPU the Gauss-Newton solves call XLA's eigh
// inside the jitted scan, where it costs nothing extra; on the card
// torch.linalg.eigh reads its error flag back to the host after every call,
// 8 times an odometry scan (estimators/gn_scan2map.solve_delta) and more in
// the two-step solve (estimators/two_step._solve_subset), and so a scan can
// neither run ahead of the host nor be captured in a CUDA graph. This kernel
// computes the same function with nothing read back.
//
// What it computes: for each of `batch` row-major (n, n) float32 matrices,
// n <= 8, read from the lower triangle as torch.linalg.eigh does, the
// eigenvalues in ascending order and the eigenvectors as the columns of an
// orthonormal (n, n) matrix: torch.linalg.eigh's contract. Equal eigenvalues
// have no unique eigenvectors and neither routine promises which basis comes
// out; a NaN or infinite entry gives NaN in every output of its matrix.
//
// Design: one thread a matrix, cyclic Jacobi in fp64 registers. The kernel is
// instantiated for each n, so every loop over rows and columns unrolls and
// the packed lower triangle (n(n+1)/2 doubles) and the rotation matrix (n*n
// doubles) stay in registers. A sweep rotates every (p, q) pair once; sweeps
// stop when the off-diagonal square sum falls below 1e-30 of the matrix's
// Frobenius square sum (about fp64's unit roundoff squared), or after
// kMaxSweeps. fp64 because the normal-equation entries reach 1e4-1e6 while
// the degeneracy threshold they are compared with is 10-100: the results are
// rounded to float32 once, at the end. The eigenvalues are then sorted with
// their columns by an unrolled exchange sort.
//
// What bounds it: neither bytes nor operations (a 6x6 matrix is 144 B in and
// 168 B out, about 2000 flops): each rotation is a chain of dependent fp64
// divisions and square roots, so one matrix takes the latency of its sweeps.
// The port calls it on one matrix at a time, where the launch dominates; see
// PERF.md for its time beside torch.linalg.eigh's.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxN = 8;
constexpr int kThreads = 64;
constexpr int kMaxSweeps = 16;
constexpr double kOffTol = 1e-30;  // off-diagonal square sum over the Frobenius square sum

// Index of entry (i, j) of a symmetric matrix in the packed lower triangle.
__host__ __device__ constexpr int lo(int i, int j) {
  return i >= j ? i * (i + 1) / 2 + j : j * (j + 1) / 2 + i;
}

// One Jacobi rotation in the (p, q) plane, p < q, that zeroes a(q, p), with
// the rotation accumulated into the columns p and q of v (the classical
// Jacobi method: Golub and Van Loan, Matrix Computations, section 8.5).
template <int N>
__device__ __forceinline__ void rotate(double (&a)[N * (N + 1) / 2], double (&v)[N][N], int p,
                                       int q) {
  const double apq = a[lo(q, p)];
  if (apq == 0.0) return;
  const double app = a[lo(p, p)], aqq = a[lo(q, q)];
  const double theta = (aqq - app) / (2.0 * apq);
  // the smaller root of t^2 + 2 theta t - 1 = 0; for |theta| near fp64's
  // overflow t underflows to 0 and the rotation is the identity
  const double t = copysign(1.0, theta) / (fabs(theta) + sqrt(theta * theta + 1.0));
  const double c = rsqrt(t * t + 1.0);
  const double s = t * c;
  const double tau = s / (1.0 + c);
  a[lo(p, p)] = app - t * apq;
  a[lo(q, q)] = aqq + t * apq;
  a[lo(q, p)] = 0.0;
#pragma unroll
  for (int r = 0; r < N; ++r) {
    if (r == p || r == q) continue;
    const double arp = a[lo(r, p)], arq = a[lo(r, q)];
    a[lo(r, p)] = arp - s * (arq + tau * arp);
    a[lo(r, q)] = arq + s * (arp - tau * arq);
  }
#pragma unroll
  for (int r = 0; r < N; ++r) {
    const double vrp = v[r][p], vrq = v[r][q];
    v[r][p] = vrp - s * (vrq + tau * vrp);
    v[r][q] = vrq + s * (vrp - tau * vrq);
  }
}

template <int N>
__global__ void __launch_bounds__(kThreads)
    sym_eig_kernel(const float* __restrict__ in, float* __restrict__ vals,
                   float* __restrict__ vecs, int batch) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  constexpr int T = N * (N + 1) / 2;
  const float* src = in + (size_t)b * N * N;
  double a[T];
  double v[N][N];
  double norm2 = 0.0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      v[i][j] = i == j ? 1.0 : 0.0;
      if (j <= i) {
        const double x = (double)src[i * N + j];
        a[lo(i, j)] = x;
        norm2 += (i == j ? 1.0 : 2.0) * x * x;
      }
    }
  }
  const bool finite = isfinite(norm2);
  if (finite) {
#pragma unroll 1
    for (int sweep = 0; sweep < kMaxSweeps; ++sweep) {
      double off = 0.0;
#pragma unroll
      for (int i = 0; i < N; ++i)
#pragma unroll
        for (int j = 0; j < N; ++j)
          if (j < i) off += a[lo(i, j)] * a[lo(i, j)];
      if (!(off > kOffTol * norm2)) break;
#pragma unroll
      for (int p = 0; p < N; ++p)
#pragma unroll
        for (int q = 0; q < N; ++q)
          if (q > p) rotate<N>(a, v, p, q);
    }
  }
  double d[N];
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = a[lo(i, i)];
  // ascending, each eigenvalue with its column
#pragma unroll
  for (int pass = 0; pass < N - 1; ++pass) {
#pragma unroll
    for (int i = 0; i < N - 1; ++i) {
      if (i >= N - 1 - pass) continue;
      const bool swap = d[i] > d[i + 1];
      const double di = d[i], dn = d[i + 1];
      d[i] = swap ? dn : di;
      d[i + 1] = swap ? di : dn;
#pragma unroll
      for (int r = 0; r < N; ++r) {
        const double x = v[r][i], y = v[r][i + 1];
        v[r][i] = swap ? y : x;
        v[r][i + 1] = swap ? x : y;
      }
    }
  }
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
