// Octant-KNN against the hashed voxel-block map, for Hopper (sm_90a).
//
// Replaces the TPU association kernel agi_lidar_slam_tpu/nn/vmem_knn.py
// (knn_vmem, kernel body _kernel). Same contract: for each query, the k
// nearest occupied sub-voxel points among the 8 blocks of its 2x2x2 octant
// block set, ascending by squared distance, ties to the lower
// (octant, sub-voxel) index; sq = 1e30, point = 0, valid = 0 where fewer
// than k neighbours exist or the query is masked.
//
// What bounds it on the card: the bytes of the eight gathered map rows, about
// 8 * 64 * (12 + 1) B = 6.6 KB per query at bucket 64 (points + occupancy),
// plus the 8 probe windows of the packed-key index. Arithmetic is ~3 flops
// per candidate. Both main-path tables (8448 and 16640 rows, 7 MB and 14 MB
// with occupancy) fit the 50 MB L2, so rows are read straight from global
// memory: no staging through shared memory, no resident table copy.
//
// Design: one warp per query, 8 queries per 256-thread block.
//   * lanes 0-7 each hash one octant's block and scan its probe window of the
//     packed-key index for the matching row (the LAST match wins, as in the
//     TPU kernel); the row ids stay in those lanes and reach the others by
//     __shfl_sync;
//   * every lane evaluates ceil(8B/32) candidates in (octant, sub-voxel)
//     order, so neighbouring lanes read neighbouring points of one row;
//   * k rounds of a warp argmin on (value, index) select the neighbours.
// Block key, frac and hash reproduce the reference bit for bit: IEEE f32
// division (__fdiv_rn), floorf, floor division of negative coordinates, and
// the hash multiplies in uint32 masked to 31 bits (the same bits as JAX's
// int32 wraparound). Distances use __fmul_rn/__fadd_rn so that no FMA
// contraction changes them from the plain PyTorch version.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxK = 16;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kBig = 1e30f;

__device__ __forceinline__ int floor_div(int a, int b) {  // b > 0
  int q = a / b;
  return (a - q * b < 0) ? q - 1 : q;
}

__device__ __forceinline__ uint32_t pack_key(int x, int y, int z) {
  return (((uint32_t)x & 1023u) << 20) | (((uint32_t)y & 1023u) << 10) |
         ((uint32_t)z & 1023u);
}

__device__ __forceinline__ int hash_packed(uint32_t pk, int log2_slots) {
  uint32_t u = pk & 0x7FFFFFFFu;
  u ^= u >> 15;
  u = (u * 0x2C1B3C6Du) & 0x7FFFFFFFu;
  u ^= u >> 12;
  u = (u * 0x297A2D39u) & 0x7FFFFFFFu;
  u ^= u >> 13;
  return (int)(u & ((1u << log2_slots) - 1u));
}

__device__ __forceinline__ int block_coord(float x, float sub_voxel, int block_sub) {
  return floor_div((int)floorf(__fdiv_rn(x, sub_voxel)), block_sub);
}

__device__ __forceinline__ int octant_sign(float x, int bc, float block_size) {
  return (__fsub_rn(__fdiv_rn(x, block_size), (float)bc) >= 0.5f) ? 1 : -1;
}

template <int PER_LANE>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
octant_knn_kernel(const float* __restrict__ queries, const uint8_t* __restrict__ qmask,
                  const float* __restrict__ points, const uint8_t* __restrict__ occ,
                  const int* __restrict__ ktab, int n, int bucket, int k, int probes,
                  int log2_slots, float sub_voxel, int block_sub, float block_size,
                  float* __restrict__ out_sq, float* __restrict__ out_pts,
                  uint8_t* __restrict__ out_valid) {
  const int lane = threadIdx.x & 31;
  const int qi = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (qi >= n) return;  // uniform across the warp
  float* sq = out_sq + (size_t)qi * k;
  float* pt = out_pts + (size_t)qi * k * 3;
  uint8_t* valid = out_valid + (size_t)qi * k;
  if (!qmask[qi]) {
    if (lane < k) {
      sq[lane] = kBig;
      pt[3 * lane] = 0.f;
      pt[3 * lane + 1] = 0.f;
      pt[3 * lane + 2] = 0.f;
      valid[lane] = 0;
    }
    return;
  }
  const float qx = queries[3 * qi], qy = queries[3 * qi + 1], qz = queries[3 * qi + 2];
  const int bx = block_coord(qx, sub_voxel, block_sub);
  const int by = block_coord(qy, sub_voxel, block_sub);
  const int bz = block_coord(qz, sub_voxel, block_sub);

  // lanes 0-7: resolve octant `lane` to its map row (-1 on a miss)
  int row = -1;
  if (lane < 8) {
    const int ox = (lane >> 2) & 1, oy = (lane >> 1) & 1, oz = lane & 1;
    const uint32_t pk = pack_key(bx + ox * octant_sign(qx, bx, block_size),
                                 by + oy * octant_sign(qy, by, block_size),
                                 bz + oz * octant_sign(qz, bz, block_size));
    const int h = hash_packed(pk, log2_slots);
    for (int p = 0; p < probes; ++p)
      if (ktab[h + p] == (int)pk) row = h + p;
  }

  // candidate c = lane + 32 j is (octant c / B, sub-voxel c % B)
  const int n_cand = 8 * bucket;
  float vals[PER_LANE];
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j) {
    const int c = lane + 32 * j;
    const int o = c / bucket;
    const int r = __shfl_sync(kFull, row, o & 7);
    float v = CUDART_INF_F;
    if (c < n_cand && r >= 0) {
      const size_t e = (size_t)r * bucket + (c - o * bucket);
      if (occ[e]) {
        const float dx = __fsub_rn(points[3 * e], qx);
        const float dy = __fsub_rn(points[3 * e + 1], qy);
        const float dz = __fsub_rn(points[3 * e + 2], qz);
        v = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
      }
    }
    vals[j] = v;
  }

  for (int s = 0; s < k; ++s) {
    float bv = CUDART_INF_F;
    int bi = 0x7fffffff;
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j)
      if (vals[j] < bv) {
        bv = vals[j];
        bi = lane + 32 * j;
      }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(kFull, bv, off);
      const int oi = __shfl_xor_sync(kFull, bi, off);
      if (ov < bv || (ov == bv && oi < bi)) {
        bv = ov;
        bi = oi;
      }
    }
    const bool found = bv < CUDART_INF_F;
    const int o = found ? bi / bucket : 0;
    const int r = __shfl_sync(kFull, row, o);
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j)
      if (lane + 32 * j == bi) vals[j] = CUDART_INF_F;
    if (lane == 0) {
      if (found) {
        const size_t e = (size_t)r * bucket + (bi - o * bucket);
        sq[s] = bv;
        pt[3 * s] = points[3 * e];
        pt[3 * s + 1] = points[3 * e + 1];
        pt[3 * s + 2] = points[3 * e + 2];
        valid[s] = 1;
      } else {
        sq[s] = kBig;
        pt[3 * s] = 0.f;
        pt[3 * s + 1] = 0.f;
        pt[3 * s + 2] = 0.f;
        valid[s] = 0;
      }
    }
  }
}

}  // namespace

extern "C" {

// Launches on `stream` (a cudaStream_t) and returns cudaGetLastError() of the
// launch; arguments the kernel cannot take return cudaErrorInvalidValue.
int octant_knn_launch(const float* queries, const uint8_t* qmask, const float* points,
                      const uint8_t* occ, const int* ktab, int n, int bucket, int k,
                      int probes, int log2_slots, float sub_voxel, int block_sub,
                      float block_size, float* out_sq, float* out_pts, uint8_t* out_valid,
                      int device, void* stream) {
  if (n <= 0 || bucket <= 0 || bucket > 128 || k < 1 || k > kMaxK || probes < 1 ||
      log2_slots < 1 || log2_slots > 30 || block_sub < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const dim3 block(kWarpsPerBlock * 32);
  cudaStream_t s = (cudaStream_t)stream;
  const int per_lane = (8 * bucket + 31) / 32;
#define OCTANT_KNN_LAUNCH(P)                                                          \
  octant_knn_kernel<P><<<grid, block, 0, s>>>(queries, qmask, points, occ, ktab, n,   \
                                              bucket, k, probes, log2_slots,          \
                                              sub_voxel, block_sub, block_size,       \
                                              out_sq, out_pts, out_valid)
  if (per_lane <= 8)
    OCTANT_KNN_LAUNCH(8);
  else if (per_lane <= 16)
    OCTANT_KNN_LAUNCH(16);
  else
    OCTANT_KNN_LAUNCH(32);
#undef OCTANT_KNN_LAUNCH
  return (int)cudaGetLastError();
}

const char* octant_knn_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
