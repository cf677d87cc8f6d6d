// Probe kernels for Hopper (sm_90a): a toolchain probe and a row-gather probe.
//
// Replace the two TPU kernels of tools/pallas_probe.py:
//   * scale2 replaces `stage0`'s body `k` (o = 2 x): the smallest kernel
//     that proves nvcc, the ctypes binding and a launch on PyTorch's stream.
//     Bound by its bytes (read x, write o): one 16-byte float4 load and store
//     per thread over the aligned body, the n % 4 tail by the first block's
//     first threads (scale2_vec_kernel); a tensor that does not start 16-byte
//     aligned takes one element per thread (scale2_kernel). Times against
//     `x * 2` are in PERF.md beside the card's name and power limit.
//   * row_gather_sum_kernel replaces `stage1`'s body `_dma_kernel`: the
//     indexed gather of (B, 3) map rows that the octant-KNN kernel does for
//     every query, reduced to a row sum so that the bytes must be read:
//     out[i] = sum_b src[idx[i], b, :]. On the TPU each row was one DMA into
//     VMEM; here a warp reads one row straight from global memory (or L2),
//     lanes striding over its 3B floats, so that one warp-wide load moves
//     128 contiguous bytes. Bound by the bytes of the distinct rows it
//     touches; a table that fits the 50 MB L2 is read from L2 after the
//     first touch, so at the association map's size this measures the L2
//     gather rate the octant-KNN design rests on.
//   An index outside [0, rows) gives NaN, as the plain version does.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
scale2_kernel(const float* __restrict__ x, float* __restrict__ o, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) o[i] = 2.0f * x[i];
}

__global__ void __launch_bounds__(kThreads)
scale2_vec_kernel(const float4* __restrict__ x4, float4* __restrict__ o4, int n4,
                  const float* __restrict__ x, float* __restrict__ o, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n4) {
    const float4 v = x4[i];
    o4[i] = make_float4(2.0f * v.x, 2.0f * v.y, 2.0f * v.z, 2.0f * v.w);
  }
  const int t = 4 * n4 + i;  // the tail: i < n % 4 <= 3, all in block 0
  if (i < 4 && t < n) o[t] = 2.0f * x[t];
}

__global__ void __launch_bounds__(kThreads)
row_gather_sum_kernel(const int* __restrict__ idx, const float* __restrict__ src,
                      float* __restrict__ out, int n, int rows, int bucket) {
  const int lane = threadIdx.x & 31;
  const int warps = (gridDim.x * blockDim.x) >> 5;
  const int len = 3 * bucket;
  for (int i = (blockIdx.x * blockDim.x + threadIdx.x) >> 5; i < n; i += warps) {
    const int r = idx[i];
    if (r < 0 || r >= rows) {  // uniform across the warp
      if (lane < 3) out[3 * i + lane] = CUDART_NAN_F;
      continue;
    }
    const float* row = src + (size_t)r * len;
    // element e of a row is component e % 3; a lane steps e by 32 = 2 mod 3
    float sx = 0.f, sy = 0.f, sz = 0.f;
    int c = lane % 3;
    for (int e = lane; e < len; e += 32) {
      const float v = row[e];
      if (c == 0)
        sx += v;
      else if (c == 1)
        sy += v;
      else
        sz += v;
      c = (c == 0) ? 2 : c - 1;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sx += __shfl_xor_sync(kFull, sx, off);
      sy += __shfl_xor_sync(kFull, sy, off);
      sz += __shfl_xor_sync(kFull, sz, off);
    }
    if (lane == 0) {
      out[3 * i] = sx;
      out[3 * i + 1] = sy;
      out[3 * i + 2] = sz;
    }
  }
}

int grid_for(long long work_items, int items_per_block) {
  long long g = (work_items + items_per_block - 1) / items_per_block;
  return (int)(g < 1 ? 1 : (g > 65535 ? 65535 : g));
}

int blocks_for(long long work_items) {  // one item per thread
  return (int)((work_items + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// Each launch goes on `stream` (a cudaStream_t) and returns cudaGetLastError()
// of the launch; arguments a kernel cannot take return cudaErrorInvalidValue.
// scale2 takes n / 4 float4 items and an n % 4 tail when both pointers are
// 16-byte aligned (and n >= 4), else one element per thread.
int scale2_launch(const float* x, float* o, int n, int device, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const bool aligned = (uintptr_t)x % 16 == 0 && (uintptr_t)o % 16 == 0;
  if (aligned && n >= 4)
    scale2_vec_kernel<<<blocks_for(n / 4), kThreads, 0, s>>>(
        reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(o), n / 4, x, o, n);
  else
    scale2_kernel<<<blocks_for(n), kThreads, 0, s>>>(x, o, n);
  return (int)cudaGetLastError();
}

int row_gather_sum_launch(const int* idx, const float* src, float* out, int n, int rows,
                          int bucket, int device, void* stream) {
  if (n <= 0 || rows <= 0 || bucket <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  row_gather_sum_kernel<<<grid_for(n, kThreads / 32), kThreads, 0, (cudaStream_t)stream>>>(
      idx, src, out, n, rows, bucket);
  return (int)cudaGetLastError();
}

// The CUDA driver's and runtime's versions (e.g. 12080 for 12.8).
int probe_versions(int* driver, int* runtime) {
  cudaError_t err = cudaDriverGetVersion(driver);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaRuntimeGetVersion(runtime);
}

const char* probe_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
