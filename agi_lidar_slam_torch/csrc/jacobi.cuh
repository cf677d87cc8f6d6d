// Cyclic Jacobi eigendecomposition of one small symmetric matrix in fp64
// registers, shared by the kernels that need it: sym_eig.cu (a batch of
// matrices, one thread a matrix) and gn_iter.cu (the Gauss-Newton step's
// 6x6 or 3x3 system).
//
// The matrix is held as its packed lower triangle, a[lo(i, j)], N(N+1)/2
// doubles, and the rotations accumulate into v, which starts as the
// identity. A sweep rotates every (p, q) pair once; sweeps stop when the
// off-diagonal square sum falls below kOffTol of the matrix's Frobenius
// square sum (about fp64's unit roundoff squared), or after kMaxSweeps. fp64
// because the normal-equation entries reach 1e4-1e6 while the degeneracy
// threshold they are compared with is 10-100. Every loop over rows and
// columns is unrolled for the instance's N, so a and v stay in registers.

#pragma once

#include <math.h>

namespace jacobi {

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

// Eigendecomposition of the packed lower triangle `a` (destroyed): the
// eigenvalues ascending into d, each with its eigenvector as the same column
// of v. `norm2` is the matrix's Frobenius square sum; a matrix whose norm2 is
// not finite is left unrotated (the caller writes NaN for it).
template <int N>
__device__ __forceinline__ void eig_sorted(double (&a)[N * (N + 1) / 2], double norm2,
                                           double (&d)[N], double (&v)[N][N]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) v[i][j] = i == j ? 1.0 : 0.0;
  if (isfinite(norm2)) {
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
}

}  // namespace jacobi
