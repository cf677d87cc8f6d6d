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
//     out[i] = sum_b src[idx[i], b, :]; an index outside [0, rows) gives NaN,
//     as the plain version does. Bound by the bytes of the distinct rows it
//     touches, which a 50 MB L2 serves after the first touch. The TPU kernel
//     keeps 8 row copies in flight before it waits on any; the design here
//     does two things about the bound:
//       1. Bytes in flight. A persistent grid of warps strides over chunks of
//          indices, loading the next chunk's indices before it sums the
//          current rows. A half-warp sums a row: at 64 sub-voxels a row (the
//          map's block_sub = 4) on a 16-byte aligned table as three float4s
//          a lane, unconditional (an empty slot reads row 0), so the compiler
//          issues a step's loads ahead of their adds; other buckets and
//          misaligned tables 4 bytes a lane, 12 loads at a time.
//          With claims a warp's chunk of 8 indices is one step of up to 8
//          rows (6 KB in flight, 48 registers); without, a warp takes 2 rows
//          a step (32 registers, 64 warps an SM), so that a small gather is
//          spread over more warps and SMs.
//       2. Each distinct row read once (when the launcher is given scratch).
//          The first warp to claim a row in a per-row tag array (atomicMax of
//          the epoch) sums it and publishes the sums with the epoch as one
//          16-byte word; every index of the row reads that word once its
//          stamp shows this epoch. A warp sums every row it claimed in a
//          chunk before it waits on any other, so a claimed row's owner is
//          always running. Lanes of one warp with the same row elect one
//          claimant (__match_any_sync), so one row's copies cost one atomic
//          a warp. The wrapper advances the epoch each launch, so the scratch
//          needs no clearing between launches. The launcher claims only when
//          the wrapper passes scratch, which it does where claims were
//          measured to pay (tools/probe.py claims_pay: many indices a row
//          and enough bytes gathered) and never under CUDA graph capture;
//          measured times are in PERF.md.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kGatherThreads = 128;  // at most; fewer when there are few chunks
constexpr int kMaxDevices = 64;
// Indices a warp claims at a time, and rows of 64 sub-voxels a half-warp sums
// at once with claims and without (without: fewer rows a warp spread a small
// gather over more SMs).
constexpr int kClaimChunk = 8, kClaimRows = 4, kDirectRows = 1;
// Indices a warp takes at a time: without claims, the rows of one step.
__host__ __device__ constexpr int chunk_for(bool claims, int rows_a_half) {
  return claims ? kClaimChunk : 2 * rows_a_half;
}
// A waiter that finds a row unpublished sleeps kWaitNs before it reads again
// (its reads would take L2 bandwidth from the owners' row loads), and gives up
// (traps, so the launch fails) after kMaxSpins reads: over 0.2 s, where a
// publish takes a few us.
constexpr unsigned kWaitNs = 512, kMaxSpins = 1u << 20;

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

// A row's sums and the epoch that published them share one 16-byte word,
// written and read as one 128-bit access (.b128: a single access in the PTX
// memory model, where a v4 access is four): a reader that sees this epoch's
// stamp sees its sums, so neither side needs a fence.
__device__ __forceinline__ void publish(float4* p, float x, float y, float z, unsigned epoch) {
  const unsigned long long lo = (unsigned long long)__float_as_uint(y) << 32 | __float_as_uint(x);
  const unsigned long long hi = (unsigned long long)epoch << 32 | __float_as_uint(z);
  asm volatile(
      "{\n\t.reg .b128 t;\n\tmov.b128 t, {%1, %2};\n\t"
      "st.relaxed.gpu.global.b128 [%0], t;\n\t}" ::"l"(p), "l"(lo), "l"(hi)
      : "memory");
}

__device__ __forceinline__ float4 peek(const float4* p) {
  unsigned long long lo, hi;
  asm volatile(
      "{\n\t.reg .b128 t;\n\tld.relaxed.gpu.global.b128 t, [%2];\n\t"
      "mov.b128 {%0, %1}, t;\n\t}"
      : "=l"(lo), "=l"(hi)
      : "l"(p)
      : "memory");
  return make_float4(__uint_as_float((unsigned)lo), __uint_as_float((unsigned)(lo >> 32)),
                     __uint_as_float((unsigned)hi), __uint_as_float((unsigned)(hi >> 32)));
}

// rel[(k + c) % 3] += v's float c (c = 0..3), k known at compile time
__device__ __forceinline__ void add4(float* rel, float4 v, int k) {
  rel[k % 3] += v.x;
  rel[(k + 1) % 3] += v.y;
  rel[(k + 2) % 3] += v.z;
  rel[k % 3] += v.w;
}

// Element e of a row is component e % 3 (a row is 3B floats). Lane hl of a
// half-warp reads elements hl + 16 j (floats) or float4s hl + 16 k, so since
// 16 = 1 mod 3 its sums (r0, r1, r2) hold components (s + c) % 3 for c = 0, 1,
// 2, s = hl % 3; this returns component `want` of them, by selects (an index
// known only at run time would put the sums in local memory).
__device__ __forceinline__ float component(const float* rel, int s, int want) {
  const int c = want - s < 0 ? want - s + 3 : want - s;
  return c == 0 ? rel[0] : (c == 1 ? rel[1] : rel[2]);
}

// kRow64: rows of 64 sub-voxels on a 16-byte aligned table, read as float4s,
// kR rows a half-warp at a time; else any bucket, 4 bytes a lane, kR = 1.
// Scratch (tag, sums) given: each distinct row read once, kClaimChunk indices
// a warp at a time; none: every index reads its row, 2 kR indices a warp at a
// time.
template <bool kRow64, int kR>
__global__ void __launch_bounds__(kGatherThreads)
row_gather_sum_kernel(const int* __restrict__ idx, const float* __restrict__ src,
                      float* __restrict__ out, int n, int rows, int bucket,
                      unsigned* tag, float4* sums, unsigned epoch) {
  static_assert(kRow64 || kR == 1, "rows of other buckets are summed one a half-warp");
  const bool claims = tag != nullptr;
  const int chunk = chunk_for(claims, kR);
  const int lane = threadIdx.x & 31, hl = lane & 15, half = lane >> 4, s = hl % 3;
  const int nwarps = (gridDim.x * blockDim.x) >> 5;
  const int wg = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int nchunks = (n + chunk - 1) / chunk;
  const int len = 3 * bucket;

  auto load_idx = [&](int c) {
    const int i = c * chunk + lane;
    return (c < nchunks && lane < chunk && i < n) ? __ldg(idx + i) : -1;
  };
  // with claims: the sums of chunk c's indices (rows r), each read from its
  // published word once the owner has stamped it with this epoch
  auto emit = [&](int c, int r) {
    const int i = c * chunk + lane;
    const bool in_chunk = lane < chunk && i < n;
    float4 v = make_float4(CUDART_NAN_F, CUDART_NAN_F, CUDART_NAN_F, 0.f);
    if (in_chunk && r >= 0 && r < rows) {
      for (unsigned spins = 0; __float_as_uint((v = peek(sums + r)).w) != epoch;) {
        if (++spins == kMaxSpins) __trap();  // a lost publish fails the launch
        __nanosleep(kWaitNs);
      }
    }
    if (in_chunk) {
      out[3 * i] = v.x;
      out[3 * i + 1] = v.y;
      out[3 * i + 2] = v.z;
    }
  };
  int r_next = load_idx(wg);
  for (int c = wg; c < nchunks; c += nwarps) {
    const int r = r_next;
    r_next = load_idx(c + nwarps);  // in flight while this chunk's rows are summed
    const int i = c * chunk + lane;
    const bool in_chunk = lane < chunk && i < n;
    const bool valid = in_chunk && r >= 0 && r < rows;
    bool mine = valid;
    if (claims) {
      const unsigned peers = __match_any_sync(kFull, valid ? r : -1);
      mine = valid && lane == __ffs(peers) - 1 && atomicMax(tag + r, epoch) < epoch;
    } else if (in_chunk && !valid) {
      out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = CUDART_NAN_F;
    }
    unsigned todo = __ballot_sync(kFull, mine);
    while (todo) {  // uniform: up to 2 kR of the warp's rows a step
      int from[kR], rr[kR];
#pragma unroll
      for (int m = 0; m < kR; ++m) {
        const int a = __ffs(todo) - 1;
        todo &= todo - 1;
        const int b = __ffs(todo) - 1;
        todo &= todo - 1;
        from[m] = half ? b : a;
        const int v = __shfl_sync(kFull, r, from[m] < 0 ? 0 : from[m]);
        rr[m] = from[m] < 0 ? -1 : v;
      }
      float rel[kR][3] = {};
      if constexpr (kRow64) {
        const float4* src4 = reinterpret_cast<const float4*>(src);
        float4 v[kR][3];
#pragma unroll
        for (int m = 0; m < kR; ++m)
#pragma unroll
          for (int k = 0; k < 3; ++k)  // an empty slot reads row 0 and is not written
            v[m][k] = __ldg(src4 + (size_t)(rr[m] < 0 ? 0 : rr[m]) * 48 + hl + 16 * k);
#pragma unroll
        for (int m = 0; m < kR; ++m)
#pragma unroll
          for (int k = 0; k < 3; ++k) add4(rel[m], v[m][k], k);
      } else {
        const float* row = src + (size_t)(rr[0] < 0 ? 0 : rr[0]) * len;
        const int nj = (len + 15) >> 4;  // floats a lane reads
        for (int j0 = 0; j0 < nj; j0 += 12) {
          float v[12];
#pragma unroll
          for (int u = 0; u < 12; ++u) {
            const int e = hl + 16 * (j0 + u);
            v[u] = __ldg(row + (e < len ? e : 0));
          }
#pragma unroll
          for (int u = 0; u < 12; ++u) rel[0][u % 3] += hl + 16 * (j0 + u) < len ? v[u] : 0.f;
        }
      }
      float x[kR], y[kR], z[kR];
#pragma unroll
      for (int m = 0; m < kR; ++m) {
        x[m] = component(rel[m], s, 0);
        y[m] = component(rel[m], s, 1);
        z[m] = component(rel[m], s, 2);
#pragma unroll
        for (int off = 8; off > 0; off >>= 1) {
          x[m] += __shfl_xor_sync(kFull, x[m], off);
          y[m] += __shfl_xor_sync(kFull, y[m], off);
          z[m] += __shfl_xor_sync(kFull, z[m], off);
        }
      }
      if (hl == 0) {
        if (claims) {
#pragma unroll
          for (int m = 0; m < kR; ++m)
            if (rr[m] >= 0) publish(sums + rr[m], x[m], y[m], z[m], epoch);
        } else {
#pragma unroll
          for (int m = 0; m < kR; ++m) {
            if (rr[m] < 0) continue;
            float* o = out + 3 * ((size_t)c * chunk + from[m]);
            o[0] = x[m];
            o[1] = y[m];
            o[2] = z[m];
          }
        }
      }
    }
  }
  // Every row this warp claimed is published, and each row another warp
  // claimed has a running owner that publishes it before it waits itself.
  // Waiting only now, after all of the warp's chunks, lets a warp's second
  // chunk overlap the other owners' work instead of waiting behind its first.
  if (claims)
    for (int c = wg; c < nchunks; c += nwarps) emit(c, load_idx(c));
}

int blocks_for(long long work_items) {  // one item per thread
  return (int)((work_items + kThreads - 1) / kThreads);
}

// One launch of an instance: a warp a chunk of indices, at most as many warps
// as fit on the device at once (the instance's occupancy, cached per
// device), in CTAs of fewer warps when there are few, so that they spread
// over more SMs.
template <bool kRow64, int kR>
int launch_gather(const int* idx, const float* src, float* out, int n, int rows, int bucket,
                  unsigned* tag, float4* sums, unsigned epoch, int device,
                  cudaStream_t stream) {
  static int sms_of[kMaxDevices], per_sm_of[kMaxDevices];
  int &sms = sms_of[device], &per_sm = per_sm_of[device];
  if (per_sm == 0) {
    cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, row_gather_sum_kernel<kRow64, kR>, kGatherThreads, 0);
    if (err != cudaSuccess) return (int)err;
    if (per_sm <= 0) return (int)cudaErrorInvalidConfiguration;
  }
  constexpr int kWarps = kGatherThreads / 32;
  const int chunk = chunk_for(tag != nullptr, kR);
  long long warps = (n + (long long)chunk - 1) / chunk;
  if (warps > (long long)sms * per_sm * kWarps) warps = (long long)sms * per_sm * kWarps;
  long long per_cta = (warps + sms - 1) / sms;
  if (per_cta > kWarps) per_cta = kWarps;
  const int blocks = (int)((warps + per_cta - 1) / per_cta);
  row_gather_sum_kernel<kRow64, kR><<<blocks, 32 * (int)per_cta, 0, stream>>>(
      idx, src, out, n, rows, bucket, tag, sums, epoch);
  return (int)cudaGetLastError();
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

// With `tag` (unsigned) and `sums` (16 B a row, 16-byte aligned), both zeroed
// once and of at least `rows` entries, each distinct row is read once;
// `epoch` must be in [1, 2**31 - 1) and above every epoch the same scratch
// has seen since it was zeroed, and no other launch may use that scratch at
// the same time. With tag == nullptr every index reads its row.
int row_gather_sum_launch(const int* idx, const float* src, float* out, int n, int rows,
                          int bucket, unsigned* tag, void* sums, unsigned epoch, int device,
                          void* stream) {
  if (n <= 0 || rows <= 0 || bucket <= 0 || device < 0 || device >= kMaxDevices)
    return (int)cudaErrorInvalidValue;
  if (tag && (!sums || (uintptr_t)sums % 16 || epoch == 0 || epoch >= 0x7fffffffu))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const bool row64 = bucket == 64 && (uintptr_t)src % 16 == 0;
  cudaStream_t st = (cudaStream_t)stream;
  float4* s4 = reinterpret_cast<float4*>(sums);
  if (row64 && tag)
    return launch_gather<true, kClaimRows>(idx, src, out, n, rows, bucket, tag, s4, epoch,
                                           device, st);
  if (row64)
    return launch_gather<true, kDirectRows>(idx, src, out, n, rows, bucket, tag, s4, epoch,
                                            device, st);
  return launch_gather<false, 1>(idx, src, out, n, rows, bucket, tag, s4, epoch, device, st);
}

// The CUDA driver's and runtime's versions (e.g. 12080 for 12.8).
int probe_versions(int* driver, int* runtime) {
  cudaError_t err = cudaDriverGetVersion(driver);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaRuntimeGetVersion(runtime);
}

const char* probe_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
