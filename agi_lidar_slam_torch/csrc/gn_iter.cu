// A Gauss-Newton step of the scan-to-map solves, fused, for Hopper (sm_90a):
// the rotation of the pose (gn_rotation), every correspondence row of the
// normal equations (gn_rows), and the step's tail (gn_update: the 6-dof
// step's clip; gn_subset: the two-step solve's 3-dof solve; both then
// se3.boxplus and the residual rms and degenerate flag).
//
// Replaces no TPU kernel: on the TPU the step is part of the jitted scan. In
// torch on the card a step was about 200 small launches (the normal
// equations 113, the solve about 30, boxplus 53), each of 1.7-2.0 us.
//
// Bit for bit the torch code. The benchmark holds the solves to a plain
// torch reference over tens of scans, and the pipeline there turns any
// difference in the last bit into millimetres within them (PERF.md, section 7),
// so these kernels round where the torch ops they replace round, op for op:
// every product, sum and quotient is one float32 rounding (__fmul_rn,
// __fadd_rn, __fdiv_rn: nothing contracts into an FMA that torch does not
// take), in torch's order. Where the order is torch's or cuBLAS's own it was
// measured on the card (the versions in gn_kernels.MEASURED_ON; row counts
// 32-16384): a sum of three squares (vector_norm, torch.sum) is (s0 + s2) +
// s1, of four (s0 + s2) + (s1 + s3); `scalar / tensor` is reciprocal(tensor)
// * scalar and `tensor / 48.0` tensor * float(1/48); `x @ R.T` and the
// batched 3x3 products ("nij,njk->nik") are fma(a2, b2, fma(a1, b1, a0 b0));
// the batched 3-term dot products ("nij,nj->ni", "ni,ni->n") fma(a1, b1,
// a0 b0) + a2 b2 up to 12800 rows and fma(a2, b2, a0 b0) + a1 b1 from 13056
// rows; cuBLAS's 3x3 gemv the first of these. The products whose order
// changes with the row count in no simple way, R [x]x ("ij,njk->nik") and the
// surf rows' n^T A ("ni,nij->nj"), stay torch ops between gn_rotation and
// gn_rows, and so do the reductions over the rows (H, g, the square sum),
// the 6x6 solve's gemvs (no order found) and sym_eig. The eigendecomposition
// of a 3x3 sub-block is the Jacobi code of sym_eig.cu (jacobi.cuh) on the same
// floats, so its outputs are sym_eig's.
//
// What bounds them: gn_rows reads about 80 B and writes 84 B a corner row,
// 40 B and 28 B a surf row (0.9 MB for 2048 + 8192 rows: 0.26 us at the HBM
// rate, and the rows come from L2); its time is one pass of a few hundred
// dependent float operations a row. The one-thread kernels are chains of
// dependent operations (and, in gn_subset, the Jacobi sweeps): their time is
// that latency.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "jacobi.cuh"

namespace {

// torch.clamp(x, min=lo) and (x, max=hi): NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }
__device__ __forceinline__ float clamp_max(float x, float hi) { return x > hi ? hi : x; }

// sqrt of a sum of three squares as torch's reductions take it: (s0 + s2) + s1
__device__ __forceinline__ float norm3(float a, float b, float c) {
  return __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(a, a), __fmul_rn(c, c)), __fmul_rn(b, b)));
}

// so3.quat_normalize: q / clamp(vector_norm(q), min=1e-8), the four squares
// summed as (s0 + s2) + (s1 + s3)
__device__ __forceinline__ void quat_normalize(float (&q)[4]) {
  const float s = __fadd_rn(__fadd_rn(__fmul_rn(q[0], q[0]), __fmul_rn(q[2], q[2])),
                            __fadd_rn(__fmul_rn(q[1], q[1]), __fmul_rn(q[3], q[3])));
  const float n = clamp_min(__fsqrt_rn(s), 1e-8f);
#pragma unroll
  for (int i = 0; i < 4; ++i) q[i] = __fdiv_rn(q[i], n);
}

// se3.boxplus(pose, delta) into out (q then t), as geometry/so3.quat_exp,
// quat_mul and quat_normalize compute it
__device__ __forceinline__ void boxplus(const float* q, const float* t, const float (&d)[6],
                                        float* out) {
  const float w0 = d[0], w1 = d[1], w2 = d[2];
  // theta2 = torch.sum(w * w, dim=-1): the three squares as (s0 + s2) + s1
  const float theta2 =
      __fadd_rn(__fadd_rn(__fmul_rn(w0, w0), __fmul_rn(w2, w2)), __fmul_rn(w1, w1));
  const float theta = __fsqrt_rn(clamp_min(theta2, (float)(1e-8 * 1e-8)));
  const float half = __fmul_rn(0.5f, theta);
  const bool small = theta2 < (float)1e-8;
  const float k = small ? __fsub_rn(0.5f, __fmul_rn(theta2, (float)(1.0 / 48.0)))
                        : __fdiv_rn(sinf(half), theta);
  float dq[4] = {small ? __fsub_rn(1.0f, __fmul_rn(theta2, 0.125f)) : cosf(half),
                 __fmul_rn(k, w0), __fmul_rn(k, w1), __fmul_rn(k, w2)};
  quat_normalize(dq);
  const float aw = q[0], ax = q[1], ay = q[2], az = q[3];
  const float bw = dq[0], bx = dq[1], by = dq[2], bz = dq[3];
  float r[4] = {
      __fsub_rn(__fsub_rn(__fsub_rn(__fmul_rn(aw, bw), __fmul_rn(ax, bx)), __fmul_rn(ay, by)),
                __fmul_rn(az, bz)),
      __fsub_rn(__fadd_rn(__fadd_rn(__fmul_rn(aw, bx), __fmul_rn(ax, bw)), __fmul_rn(ay, bz)),
                __fmul_rn(az, by)),
      __fadd_rn(__fadd_rn(__fsub_rn(__fmul_rn(aw, by), __fmul_rn(ax, bz)), __fmul_rn(ay, bw)),
                __fmul_rn(az, bx)),
      __fadd_rn(__fsub_rn(__fadd_rn(__fmul_rn(aw, bz), __fmul_rn(ax, by)), __fmul_rn(ay, bx)),
                __fmul_rn(az, bw))};
  quat_normalize(r);
#pragma unroll
  for (int i = 0; i < 4; ++i) out[i] = r[i];
#pragma unroll
  for (int i = 0; i < 3; ++i) out[4 + i] = __fadd_rn(t[i], d[3 + i]);
}

// so3.quat_to_matrix of the unit quaternion (w, x, y, z)
__device__ __forceinline__ void quat_to_matrix(const float* q, float (&R)[3][3]) {
  const float w = q[0], x = q[1], y = q[2], z = q[3];
  const float ww = __fmul_rn(w, w), xx = __fmul_rn(x, x), yy = __fmul_rn(y, y),
              zz = __fmul_rn(z, z);
  const float wx = __fmul_rn(w, x), wy = __fmul_rn(w, y), wz = __fmul_rn(w, z);
  const float xy = __fmul_rn(x, y), xz = __fmul_rn(x, z), yz = __fmul_rn(y, z);
  R[0][0] = __fsub_rn(__fsub_rn(__fadd_rn(ww, xx), yy), zz);
  R[0][1] = __fmul_rn(2.0f, __fsub_rn(xy, wz));
  R[0][2] = __fmul_rn(2.0f, __fadd_rn(xz, wy));
  R[1][0] = __fmul_rn(2.0f, __fadd_rn(xy, wz));
  R[1][1] = __fsub_rn(__fadd_rn(__fsub_rn(ww, xx), yy), zz);
  R[1][2] = __fmul_rn(2.0f, __fsub_rn(yz, wx));
  R[2][0] = __fmul_rn(2.0f, __fsub_rn(xz, wy));
  R[2][1] = __fmul_rn(2.0f, __fadd_rn(yz, wx));
  R[2][2] = __fadd_rn(__fsub_rn(__fsub_rn(ww, xx), yy), zz);
}

// A batched 3-term dot product as cuBLAS takes it: fma(a1, b1, a0 b0) + a2 b2
// up to 12800 rows, fma(a2, b2, a0 b0) + a1 b1 above
__device__ __forceinline__ float dot3_batched(float a0, float a1, float a2, float b0, float b1,
                                              float b2, bool many) {
  return many ? __fadd_rn(__fmaf_rn(a2, b2, __fmul_rn(a0, b0)), __fmul_rn(a1, b1))
              : __fadd_rn(__fmaf_rn(a1, b1, __fmul_rn(a0, b0)), __fmul_rn(a2, b2));
}

// `x @ R.T + t` for one point: fma(x2, R[j][2], fma(x1, R[j][1], x0 R[j][0])) + t[j]
__device__ __forceinline__ void to_world(const float (&R)[3][3], const float* t, const float* x,
                                         float (&w)[3]) {
#pragma unroll
  for (int j = 0; j < 3; ++j)
    w[j] = __fadd_rn(__fmaf_rn(x[2], R[j][2], __fmaf_rn(x[1], R[j][1], __fmul_rn(x[0], R[j][0]))),
                     t[j]);
}

// gn_scan2map._huber_sqrt_weight: sqrt(clamp(delta / clamp(r, min=1e-12), max=1)),
// delta / x being reciprocal(x) * delta
__device__ __forceinline__ float huber_sqrt_weight(float r, float delta) {
  return __fsqrt_rn(clamp_max(__fmul_rn(__fdiv_rn(1.0f, clamp_min(r, 1e-12f)), delta), 1.0f));
}

__global__ void gn_rotation_kernel(const float* __restrict__ q, float* __restrict__ out) {
  float R[3][3];
  quat_to_matrix(q, R);
#pragma unroll
  for (int i = 0; i < 9; ++i) out[i] = R[i / 3][i % 3];
}

// The weighted rows of gn_scan2map.normal_equations: a thread a row, corner
// rows first. RA (nc, 3, 3) is R [x]x of each corner point and Jr_s (ns, 3)
// the surf rows' rotation Jacobian, both from the torch ops.
__global__ void __launch_bounds__(256)
    gn_rows_kernel(const float* __restrict__ Rm, const float* __restrict__ t,
                   const float* __restrict__ c_xyz, const float* __restrict__ c_cen,
                   const float* __restrict__ c_dir, const bool* __restrict__ c_ok,
                   const float* __restrict__ RA, int nc, const float* __restrict__ s_xyz,
                   const float* __restrict__ s_nrm, const float* __restrict__ s_off,
                   const bool* __restrict__ s_ok, const float* __restrict__ Jr_s, int ns,
                   float huber, float* __restrict__ e_w, float* __restrict__ J_w,
                   float* __restrict__ r_sw, float* __restrict__ Js_w) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= nc + ns) return;
  float R[3][3];
#pragma unroll
  for (int i = 0; i < 9; ++i) R[i / 3][i % 3] = Rm[i];
  if (r < nc) {
    const size_t n = r;
    const float* u = c_dir + 3 * n;
    float cw[3], d[3], P[3][3], e[3], A[3][3];
    to_world(R, t, c_xyz + 3 * n, cw);
#pragma unroll
    for (int j = 0; j < 3; ++j) d[j] = __fsub_rn(cw[j], c_cen[3 * n + j]);
    // P = eye - u u^T
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) P[i][j] = __fsub_rn(i == j ? 1.0f : 0.0f, __fmul_rn(u[i], u[j]));
    const bool ok = c_ok[n];
    const bool many = nc > 12800;
#pragma unroll
    for (int i = 0; i < 3; ++i)
      e[i] = ok ? dot3_batched(P[i][0], P[i][1], P[i][2], d[0], d[1], d[2], many) : 0.0f;
#pragma unroll
    for (int i = 0; i < 9; ++i) A[i / 3][i % 3] = -RA[9 * n + i];
    const float w0 = huber_sqrt_weight(norm3(e[0], e[1], e[2]), huber);
    const float w = ok ? w0 : 0.0f;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      e_w[3 * n + i] = __fmul_rn(e[i], w);
      float* row = J_w + 18 * n + 6 * i;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        // "nij,njk->nik": fma(P_i2, A_2k, fma(P_i1, A_1k, P_i0 A_0k))
        const float jr = __fmaf_rn(P[i][2], A[2][k], __fmaf_rn(P[i][1], A[1][k],
                                                               __fmul_rn(P[i][0], A[0][k])));
        row[k] = __fmul_rn(jr, w);
        row[3 + k] = __fmul_rn(P[i][k], w);
      }
    }
  } else {
    const size_t n = r - nc;
    const float* nv = s_nrm + 3 * n;
    float sw[3];
    to_world(R, t, s_xyz + 3 * n, sw);
    const bool ok = s_ok[n];
    const float rs = __fadd_rn(dot3_batched(nv[0], nv[1], nv[2], sw[0], sw[1], sw[2], ns > 12800),
                               s_off[n]);
    const float res = ok ? rs : 0.0f;
    const float w0 = huber_sqrt_weight(fabsf(res), huber);
    const float w = ok ? w0 : 0.0f;
    r_sw[n] = __fmul_rn(res, w);
    float* row = Js_w + 6 * n;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      row[k] = __fmul_rn(Jr_s[3 * n + k], w);
      row[3 + k] = __fmul_rn(nv[k], w);
    }
  }
}

// rms = sqrt(sq / clamp(n_rows, min=1)), with an earlier step's sums added
// first where given (the two-step solve's surf step)
__device__ __forceinline__ float rms_of(const float* sq, const float* rows, const float* prev_sq,
                                        const float* prev_rows) {
  const float s = prev_sq != nullptr ? __fadd_rn(*prev_sq, *sq) : *sq;
  const float n = prev_rows != nullptr ? __fadd_rn(*prev_rows, *rows) : *rows;
  return __fsqrt_rn(__fdiv_rn(s, clamp_min(n, 1.0f)));
}

// The 6-dof step's tail (gn_scan2map.solve_delta after its solve, then
// boxplus): `delta` is the unclipped step and `good` its directions' flags.
__global__ void gn_update_kernel(const float* __restrict__ delta, const bool* __restrict__ good,
                                 float clip, const float* __restrict__ q,
                                 const float* __restrict__ t, const float* __restrict__ sq,
                                 const float* __restrict__ rows, float* __restrict__ pose_out,
                                 float* __restrict__ rms_out, bool* __restrict__ degen_out) {
  float d[6];
  bool all_good = true;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    d[i] = delta[i];
    all_good = all_good && good[i];
  }
  // scale = clamp(clip / clamp(|dt|, min=1e-12), max=1); clip / x is reciprocal(x) * clip
  const float dt = norm3(d[3], d[4], d[5]);
  const float scale = clamp_max(__fmul_rn(__fdiv_rn(1.0f, clamp_min(dt, 1e-12f)), clip), 1.0f);
#pragma unroll
  for (int i = 0; i < 6; ++i) d[i] = __fmul_rn(d[i], scale);
  boxplus(q, t, d, pose_out);
  *rms_out = rms_of(sq, rows, nullptr, nullptr);
  *degen_out = !all_good;
}

// The two-step solve's step (two_step._solve_subset on the 3x3 sub-block
// `dofs` of H and g, then boxplus); prev_* merge the surf step's stats into
// the corner step's.
__global__ void gn_subset_kernel(const float* __restrict__ H, const float* __restrict__ g,
                                 int dofs, float thresh, const float* __restrict__ q,
                                 const float* __restrict__ t, const float* __restrict__ sq,
                                 const float* __restrict__ rows, const float* __restrict__ prev_sq,
                                 const float* __restrict__ prev_rows,
                                 const bool* __restrict__ prev_degen, float* __restrict__ pose_out,
                                 float* __restrict__ rms_out, bool* __restrict__ degen_out) {
  constexpr int N = 3;
  constexpr int T = N * (N + 1) / 2;
  int idx[N];  // the chosen entries in increasing order: the i-th set bit of dofs
#pragma unroll
  for (int i = 0; i < N; ++i) {
    int rest = dofs;
#pragma unroll
    for (int c = 0; c < i; ++c) rest &= rest - 1;
    idx[i] = __ffs(rest) - 1;
  }
  // sym_eig on the sub-block, read from its lower triangle as sym_eig.cu reads it
  double a[T];
  double norm2 = 0.0;
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      const double x = (double)H[idx[i] * 6 + idx[j]];
      a[jacobi::lo(i, j)] = x;
      norm2 += (i == j ? 1.0 : 2.0) * x * x;
    }
  const bool finite = isfinite(norm2);
  double ev[N], evec[N][N];
  jacobi::eig_sorted<N>(a, norm2, ev, evec);
  const float nan = __int_as_float(0x7fffffff);
  float v[N][N], inv[N];
  bool all_good = true;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const float val = finite ? (float)ev[k] : nan;
    const bool good = val > thresh;
    all_good = all_good && good;
    // where(good, 1.0 / where(good, vals, 1), 0); 1.0 / x is reciprocal(x) * 1.0
    inv[k] = good ? __fdiv_rn(1.0f, val) : 0.0f;
#pragma unroll
    for (int i = 0; i < N; ++i) v[i][k] = finite ? (float)evec[i][k] : nan;
  }
  float gs[N];
#pragma unroll
  for (int i = 0; i < N; ++i) gs[i] = g[idx[i]];
  // y = V^T gs, then d = (-(V * inv)) @ y, each entry fma(a1, b1, a0 b0) + a2 b2
  float y[N], sub[N];
#pragma unroll
  for (int k = 0; k < N; ++k)
    y[k] = __fadd_rn(__fmaf_rn(v[1][k], gs[1], __fmul_rn(v[0][k], gs[0])),
                     __fmul_rn(v[2][k], gs[2]));
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float m0 = -__fmul_rn(v[i][0], inv[0]), m1 = -__fmul_rn(v[i][1], inv[1]),
                m2 = -__fmul_rn(v[i][2], inv[2]);
    sub[i] = __fadd_rn(__fmaf_rn(m1, y[1], __fmul_rn(m0, y[0])), __fmul_rn(m2, y[2]));
  }
  float d[6];  // zero outside the chosen entries
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    d[j] = 0.0f;
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (idx[i] == j) d[j] = sub[i];
  }
  boxplus(q, t, d, pose_out);
  *rms_out = rms_of(sq, rows, prev_sq, prev_rows);
  *degen_out = !all_good || (prev_degen != nullptr && *prev_degen);
}

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t), one thread; each returns
// cudaGetLastError() of its launch. Every pointer is device memory. `delta`
// (6) and `good` (6 bools), `q` (4), `t` (3), `sq` and `rows` (one float
// each); pose_out receives q (4) then t (3), rms_out and degen_out one value.
int gn_update_launch(const float* delta, const bool* good, float clip, const float* q,
                     const float* t, const float* sq, const float* rows, float* pose_out,
                     float* rms_out, bool* degen_out, int device, void* stream) {
  if (device < 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  gn_update_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(delta, good, clip, q, t, sq, rows,
                                                      pose_out, rms_out, degen_out);
  return (int)cudaGetLastError();
}

// `H` (6x6 row-major) and `g` (6) of the step; `dofs` a mask of three of the
// six entries (bit i: delta entry i); prev_sq, prev_rows and prev_degen all
// null or all set.
int gn_subset_launch(const float* H, const float* g, int dofs, float thresh, const float* q,
                     const float* t, const float* sq, const float* rows, const float* prev_sq,
                     const float* prev_rows, const bool* prev_degen, float* pose_out,
                     float* rms_out, bool* degen_out, int device, void* stream) {
  if (device < 0 || dofs <= 0 || dofs >= 64 || __builtin_popcount(dofs) != 3 ||
      (prev_sq == nullptr) != (prev_rows == nullptr) ||
      (prev_sq == nullptr) != (prev_degen == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  gn_subset_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(H, g, dofs, thresh, q, t, sq, rows,
                                                      prev_sq, prev_rows, prev_degen, pose_out,
                                                      rms_out, degen_out);
  return (int)cudaGetLastError();
}

// R (3x3, row-major) of the pose's quaternion q (4), as so3.quat_to_matrix.
int gn_rotation_launch(const float* q, float* R, int device, void* stream) {
  if (device < 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  gn_rotation_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(q, R);
  return (int)cudaGetLastError();
}

// The weighted rows of the normal equations: corner rows (c_xyz, c_cen, c_dir
// (nc, 3), c_ok (nc), RA (nc, 3, 3)) into e_w (nc, 3) and J_w (nc, 3, 6), surf
// rows (s_xyz, s_nrm (ns, 3), s_off, s_ok (ns), Jr_s (ns, 3)) into r_sw (ns)
// and Js_w (ns, 6); R (3x3) and t (3) the pose.
int gn_rows_launch(const float* R, const float* t, const float* c_xyz, const float* c_cen,
                   const float* c_dir, const bool* c_ok, const float* RA, int nc,
                   const float* s_xyz, const float* s_nrm, const float* s_off, const bool* s_ok,
                   const float* Jr_s, int ns, float huber, float* e_w, float* J_w, float* r_sw,
                   float* Js_w, int device, void* stream) {
  if (device < 0 || nc < 0 || ns < 0) return (int)cudaErrorInvalidValue;
  if (nc + ns == 0) return (int)cudaSuccess;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  gn_rows_kernel<<<(nc + ns + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
      R, t, c_xyz, c_cen, c_dir, c_ok, RA, nc, s_xyz, s_nrm, s_off, s_ok, Jr_s, ns, huber, e_w,
      J_w, r_sw, Js_w);
  return (int)cudaGetLastError();
}

const char* gn_step_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
