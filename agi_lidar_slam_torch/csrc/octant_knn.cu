// Octant-KNN against the hashed voxel-block map, for Hopper (sm_90a).
//
// Replaces the TPU association kernel agi_lidar_slam_tpu/nn/vmem_knn.py
// (knn_vmem, kernel body _kernel). Same contract: for each query, the k
// nearest occupied sub-voxel points among the 8 blocks of its 2x2x2 octant
// block set, ascending by squared distance, ties to the lower
// (octant, sub-voxel) index; sq = 1e30, point = 0, valid = 0 where fewer
// than k neighbours exist or the query is masked.
//
// What bounds it on the card: by bytes, the distinct map rows the live
// queries hit, read once from HBM (B * (12 + 1) B each: points and
// occupancy), 0.55 us at the LIO path's inputs; a design that reads each
// (query, octant) row from L2 moves 8x more bytes than that. Measured, the
// kernel is bound by neither: it waits on chains of dependent steps (the
// probe-window loads, the per-row candidate chain, k selection rounds) and
// on instruction throughput, so the design shortens the chains and cuts
// instructions.
// The association queries come sorted by voxel key, so neighbouring queries
// hit the same rows.
//
// Design: CTAs of 256 threads, as many as fit on the card, walk tiles of
// kTile (8) consecutive queries, 32 tiles at a time: warp 0 reads their
// query masks at once and every thread writes the dead tiles' empty results
// (the TPU kernel's activity flag); each live tile goes through
//   1. one thread per (query, octant) entry computes its block key and hash
//      and loads its probe window of the packed-key index eight entries at a
//      time, all loads in flight together; the last match wins;
//   2. the resolved rows go into a hashed set in shared memory (one insert
//      per row and warp, by the lowest lane that holds it, __match_any_sync).
//      If the tile's distinct rows fit in the rows the launcher stages (as
//      many as fit kSmemBudget, 26 at 64 sub-voxels a row), all are copied into
//      dynamic shared memory with 16-byte cp.async (when the bucket is a
//      multiple of 16) and each is read from L2 once for the tile; if not,
//      none is, and the tile reads its rows from global memory, so any input
//      is served (a partial copy cost more than it saved on the card);
//   3. one warp per query compacts its rows' occupied sub-voxels into a list
//      in shared memory (ballot and prefix count, in index order) and scores
//      only those, a lane on every 32nd; rows are kept as they lie in memory
//      (12 B points). Each lane keeps its kList smallest (value, index) pairs
//      sorted in registers and counts the rest;
//   4. k rounds of a warp-wide minimum over the lane heads: one REDUX
//      (__reduce_min_sync) on the distance's bits (a distance is >= 0, so its
//      bits order like its value), a ballot of the lanes that hold it, and a
//      second REDUX on the index only when two do (the tie rule). The winning
//      lane records its index in shared memory and pops its head; a lane
//      whose list runs dry while it holds more candidates rescores its list
//      entries above the popped pair (rare: it takes more than kList of the
//      k winners). The outputs leave in one coalesced store per tensor, the
//      points read back from shared memory.
// Block key, frac and hash reproduce the reference bit for bit: IEEE f32
// division (__fdiv_rn), floorf, floor division of negative coordinates, and
// the hash multiplies in uint32 masked to 31 bits (the same bits as JAX's
// int32 wraparound). Distances use __fmul_rn/__fadd_rn so that no FMA
// contraction changes them from the plain PyTorch version.
//
// Measured on an NVIDIA H100 80GB HBM3 at its 700.00 W power limit, device
// time per call on the paths' own inputs, by knn_bench.py (in brackets the
// earlier design of this kernel, one warp per query reading its rows from
// L2, in the same run): LIO 8192 queries, k = 8, 14.8 us [27.9-29.6];
// odometry 8192 surf queries 8.6 us [11.7], 2048 corner queries 7.1 us
// [9.9-10.1]; chip_smoke.py's run on another machine read 13.2, 7.6 and
// 3.6-3.7 us. The split between probe, gather and selection, and the other
// shapes, are in PERF.md.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kMaxK = 16;
constexpr int kMaxBucket = 128;
constexpr int kTile = 8;       // consecutive queries per tile
constexpr int kThreads = 256;  // per CTA: one warp per query of a tile
constexpr int kSmemBudget = 32 * 1024;  // dynamic shared memory per CTA
constexpr int kMaxSmem = 232448;  // the most dynamic shared memory a block may use
constexpr int kList = 4;          // per-lane sorted list; a lane that runs dry is rescored
constexpr unsigned kFull = 0xffffffffu;
constexpr float kBig = 1e30f;

struct Args {
  const float* queries;
  const uint8_t* qmask;
  const float* points;
  const uint8_t* occ;
  const int* ktab;
  int n, bucket, k, probes, log2_slots, block_sub;
  float sub_voxel, block_size;
  // kTile, read at run time like the block size: with both compiled in as
  // constants the bucket <= 64 instance took 64 registers instead of 40, so
  // 4 CTAs an SM instead of 6 (knn_bench.py `const`, PERF.md); and the
  // rows the launcher stages
  int tile, stage_rows;
  bool vec;  // bucket % 16 == 0 and points/occ 16-byte aligned: stage with cp.async
  float* out_sq;
  float* out_pts;
  uint8_t* out_valid;
};

// Shared-memory layout of one CTA: the staged rows (points and occupancy,
// each padded to 16 B), the tile's query coordinates, two ints per (query,
// octant) entry, the hashed set of distinct rows (key and value), the staged
// row ids, kMaxK winner indices and a list of 8 bucket 16-bit candidates per
// warp, the distinct row count and the live-tile mask.
struct Layout {
  int ps, os, hs;  // staged row strides (floats, bytes); hashed-set slots
  int occ, q, row, sid, key, val, srow, win, list, count, live, bytes;
  __host__ __device__ Layout(int tile, int bucket, int stage_rows) {
    ps = (3 * bucket + 3) / 4 * 4;
    os = (bucket + 15) / 16 * 16;
    hs = 1;
    while (hs < 16 * tile) hs <<= 1;
    occ = stage_rows * ps * 4;
    q = occ + stage_rows * os;
    row = q + 12 * tile;
    sid = row + 32 * tile;
    key = sid + 32 * tile;
    val = key + 4 * hs;
    srow = val + 4 * hs;
    win = srow + 4 * stage_rows;
    list = win + 4 * kMaxK * (kThreads / 32);
    count = list + 2 * 8 * bucket * (kThreads / 32);
    live = count + 4;
    bytes = live + 4;
  }
};

// The rows a CTA stages: as many as fit kSmemBudget beside the rest of the
// layout, at most the tile's 8 a query (a tile with more distinct rows
// stages none).
int stage_rows_for(int bucket) {
  const int fixed = Layout(kTile, bucket, 0).bytes;
  const int per_row = Layout(kTile, bucket, 1).bytes - fixed;
  const int fit = (kSmemBudget - fixed) / per_row;
  return fit < 0 ? 0 : (fit < 8 * kTile ? fit : 8 * kTile);
}

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

__device__ __forceinline__ int octant_block(float x, int bc, int bit, float block_size) {
  return bit ? bc + ((__fsub_rn(__fdiv_rn(x, block_size), (float)bc) >= 0.5f) ? 1 : -1) : bc;
}

__device__ __forceinline__ int set_slot(int r, int mask) {
  return (int)(((uint32_t)r * 0x9E3779B1u) >> 7) & mask;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The query's occupied candidates, compacted into the warp's list in
// ascending index (octant << 8) | sub-voxel, which orders like (octant,
// sub-voxel): each row's occupancy by ballot, each lane's slot by the count
// of lower lanes. Returns the list's length (the same in every lane).
template <bool kWide, bool kStaged>
__device__ __forceinline__ int compact_query(const Args& a, const Layout& L, const uint8_t* s_occ,
                                             const int* row, const int* sid, int lane,
                                             uint16_t* list) {
  const int B = a.bucket;
  const unsigned below = (1u << lane) - 1u;
  int n = 0;
  if constexpr (!kWide) {  // B <= 64: all eight rows' occupancy loads in flight together
#pragma unroll
    for (int o = 0; o < 8; ++o) {
      const int r = row[o], s = sid[o];
      const uint8_t* oc = kStaged ? s_occ + max(s, 0) * L.os
                          : s >= 0 ? s_occ + s * L.os : a.occ + (size_t)max(r, 0) * B;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int b = lane + 32 * j;
        const bool occupied = r >= 0 && b < B && oc[b] != 0;
        const unsigned m = __ballot_sync(kFull, occupied);
        if (occupied) list[n + __popc(m & below)] = (uint16_t)((o << 8) | b);
        n += __popc(m);
      }
    }
  } else {  // wider rows: one sub-voxel range at a time keeps the registers in check
    for (int o = 0; o < 8; ++o) {
      const int r = row[o], s = sid[o];
      if (r < 0) continue;  // the same in every lane
      const uint8_t* oc = kStaged ? s_occ + s * L.os
                          : s >= 0 ? s_occ + s * L.os : a.occ + (size_t)r * B;
      for (int b = lane; b - lane < B; b += 32) {
        const bool occupied = b < B && oc[b] != 0;
        const unsigned m = __ballot_sync(kFull, occupied);
        if (occupied) list[n + __popc(m & below)] = (uint16_t)((o << 8) | b);
        n += __popc(m);
      }
    }
  }
  __syncwarp();
  return n;
}

// Score the lane's entries of the list (lane, lane + 32, ...) and insert
// those above the floor (fv, fi) into its sorted list; returns how many it
// kept, listed or not. A lane sees its entries in ascending index, so a
// strict `<` keeps equal values in index order.
template <bool kStaged, bool kFloor>
__device__ __forceinline__ int score_list(const Args& a, const Layout& L, const float* s_pts,
                                          const int* row, const int* sid, const uint16_t* list,
                                          int n, int lane, float qx, float qy, float qz,
                                          float fv, int fi, float (&lv)[kList],
                                          int (&li)[kList]) {
  const int B = a.bucket;
  int kept = 0;
  for (int i = lane; i < n; i += 32) {
    const int ci = list[i], o = ci >> 8, b = ci & 255, s = sid[o];
    const float* p = kStaged ? s_pts + s * L.ps + 3 * b
                     : s >= 0 ? s_pts + s * L.ps + 3 * b : a.points + ((size_t)row[o] * B + b) * 3;
    const float dx = __fsub_rn(p[0], qx), dy = __fsub_rn(p[1], qy), dz = __fsub_rn(p[2], qz);
    const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
    bool keep = d < CUDART_INF_F;
    if (kFloor) keep = keep && (d > fv || (d == fv && ci > fi));
    kept += keep;
    const float cv = keep ? d : CUDART_INF_F;
    bool lt[kList];  // the list is sorted, so lt is false then true
#pragma unroll
    for (int t = 0; t < kList; ++t) lt[t] = cv < lv[t];
#pragma unroll
    for (int t = kList - 1; t > 0; --t) {
      lv[t] = lt[t - 1] ? lv[t - 1] : (lt[t] ? cv : lv[t]);
      li[t] = lt[t - 1] ? li[t - 1] : (lt[t] ? ci : li[t]);
    }
    lv[0] = lt[0] ? cv : lv[0];
    li[0] = lt[0] ? ci : li[0];
  }
  return kept;
}

template <bool kWide>
__global__ void __launch_bounds__(kThreads) octant_knn_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L(a.tile, a.bucket, a.stage_rows);
  float* s_pts = reinterpret_cast<float*>(smem);
  uint8_t* s_occ = smem + L.occ;
  float* s_q = reinterpret_cast<float*>(smem + L.q);
  int* s_row = reinterpret_cast<int*>(smem + L.row);
  int* s_sid = reinterpret_cast<int*>(smem + L.sid);
  int* s_key = reinterpret_cast<int*>(smem + L.key);
  int* s_val = reinterpret_cast<int*>(smem + L.val);
  int* s_srow = reinterpret_cast<int*>(smem + L.srow);
  int* s_win = reinterpret_cast<int*>(smem + L.win);  // kMaxK winner indices per warp
  uint16_t* s_list = reinterpret_cast<uint16_t*>(smem + L.list);  // 8 B candidates per warp
  int* s_count = reinterpret_cast<int*>(smem + L.count);  // distinct rows
  unsigned* s_live = reinterpret_cast<unsigned*>(smem + L.live);

  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, nw = nthr >> 5;
  const int B = a.bucket, k = a.k;
  const int n_tiles = (a.n + a.tile - 1) / a.tile;
  // The CTA's tiles are blockIdx.x + j gridDim.x, taken 32 at a time: warp 0
  // reads their masks at once, every thread writes the dead ones' results,
  // and the live ones go through steps 1-4 one after another.
  for (int base = blockIdx.x; base < n_tiles; base += 32 * gridDim.x) {
    if (warp == 0) {
      const int t = base + lane * gridDim.x;
      bool any = false;
      if (t < n_tiles) {
        const int q0 = t * a.tile, nq = min(a.tile, a.n - q0);
#pragma unroll 8
        for (int i = 0; i < nq; ++i) any |= a.qmask[q0 + i] != 0;
      }
      const unsigned live = __ballot_sync(kFull, any);
      if (lane == 0) *s_live = live;
    }
    __syncthreads();
    const unsigned live = *s_live;
    for (int j = 0; j < 32 && base + j * gridDim.x < n_tiles; ++j) {
      if (live >> j & 1) continue;
      const size_t q0 = (size_t)(base + j * gridDim.x) * a.tile;
      const int nq = min(a.tile, (int)(a.n - q0));
      for (int i = tid; i < nq * k; i += nthr) {
        a.out_sq[q0 * k + i] = kBig;
        a.out_valid[q0 * k + i] = 0;
      }
      for (int i = tid; i < 3 * nq * k; i += nthr) a.out_pts[q0 * k * 3 + i] = 0.f;
    }
    for (unsigned todo = live; todo; todo &= todo - 1) {
      const int tile = base + (__ffs(todo) - 1) * gridDim.x;
      const int q0 = tile * a.tile;
      const int nq = min(a.tile, a.n - q0);
      const int ne = 8 * nq;

      // 1. each (query, octant) entry: block key, hash, and its probe window
      //    loaded eight entries at a time; the last match wins
      for (int e = tid; e < ne; e += nthr) {
        const int qi = q0 + (e >> 3), o = e & 7;
        const float qx = a.queries[3 * qi], qy = a.queries[3 * qi + 1], qz = a.queries[3 * qi + 2];
        int row = -1;
        if (a.qmask[qi]) {  // the query's loads above go out with this one
          const int bx = block_coord(qx, a.sub_voxel, a.block_sub);
          const int by = block_coord(qy, a.sub_voxel, a.block_sub);
          const int bz = block_coord(qz, a.sub_voxel, a.block_sub);
          const int pk = (int)pack_key(octant_block(qx, bx, (o >> 2) & 1, a.block_size),
                                       octant_block(qy, by, (o >> 1) & 1, a.block_size),
                                       octant_block(qz, bz, o & 1, a.block_size));
          const int h = hash_packed((uint32_t)pk, a.log2_slots);
          for (int p0 = 0; p0 < a.probes; p0 += 8) {
            int w[8];
#pragma unroll
            for (int u = 0; u < 8; ++u) w[u] = p0 + u < a.probes ? __ldg(a.ktab + h + p0 + u) : -1;
#pragma unroll
            for (int u = 0; u < 8; ++u)
              if (w[u] == pk) row = h + p0 + u;
          }
          if (o == 0) {
            s_q[3 * (e >> 3)] = qx;
            s_q[3 * (e >> 3) + 1] = qy;
            s_q[3 * (e >> 3) + 2] = qz;
          }
        }
        s_row[e] = row;
      }
      for (int i = tid; i < L.hs; i += nthr) s_key[i] = -1;
      if (tid == 0) *s_count = 0;
      __syncthreads();

      // 2. the distinct rows into a hashed set, each with an id (one insert
      //    per row and warp: the lowest lane holding it); if the tile's rows
      //    fit in stage_rows, all are staged and each is read from L2 once
      //    for the tile, else none is
      const int hmask = L.hs - 1;
      for (int e = tid; e < ne; e += nthr) {
        const int r = s_row[e];
        const unsigned same = __match_any_sync(__activemask(), r);
        if (r < 0 || (tid & 31) != __ffs(same) - 1) continue;
        for (int slot = set_slot(r, hmask);; slot = (slot + 1) & hmask) {
          const int prev = atomicCAS(s_key + slot, -1, r);
          if (prev == -1) {
            const int id = atomicAdd(s_count, 1);
            s_val[slot] = id;
            if (id < a.stage_rows) s_srow[id] = r;
            break;
          }
          if (prev == r) break;
        }
      }
      __syncthreads();
      const bool staged = *s_count <= a.stage_rows;
      const int n_stage = staged ? *s_count : 0;
      if (a.vec) {  // 16-byte copies: 3B/4 of points, B/16 of occupancy per row
        const int cp = 3 * B / 4, co = B / 16, per = cp + co;
        for (int j = tid; j < n_stage * per; j += nthr) {
          const int s = j / per, c = j - s * per;
          const size_t r = (size_t)s_srow[s];
          if (c < cp)
            cp_async16(s_pts + s * L.ps + 4 * c, a.points + r * 3 * B + 4 * c);
          else
            cp_async16(s_occ + s * L.os + 16 * (c - cp), a.occ + r * B + 16 * (c - cp));
        }
      } else {
        const int per = 4 * B;
        for (int j = tid; j < n_stage * per; j += nthr) {
          const int s = j / per, c = j - s * per;
          const size_t r = (size_t)s_srow[s];
          if (c < 3 * B)
            s_pts[s * L.ps + c] = a.points[r * 3 * B + c];
          else
            s_occ[s * L.os + c - 3 * B] = a.occ[r * B + c - 3 * B];
        }
      }
      for (int e = tid; e < ne; e += nthr) {  // each entry's staged row, or -1
        const int r = s_row[e];
        int sid = -1;
        if (r >= 0) {
          int slot = set_slot(r, hmask);
          while (s_key[slot] != r) slot = (slot + 1) & hmask;
          sid = staged ? s_val[slot] : -1;
        }
        s_sid[e] = sid;
      }
      cp_async_wait_all();
      __syncthreads();

      // 3-4. one warp per query: score into the lane lists, then k rounds of a
      //      warp-wide minimum over the lane heads
      for (int lq = warp; lq < nq; lq += nw) {
        const size_t qi = (size_t)q0 + lq;
        const int* row = s_row + 8 * lq;  // a dead query's rows are all -1
        const int* sid = s_sid + 8 * lq;
        // a row id is -1 or >= 0, so the AND is >= 0 unless every row is missing
        const bool hit =
            (row[0] & row[1] & row[2] & row[3] & row[4] & row[5] & row[6] & row[7]) >= 0;
        const float qx = s_q[3 * lq], qy = s_q[3 * lq + 1], qz = s_q[3 * lq + 2];
        float lv[kList];
        int li[kList];
#pragma unroll
        for (int t = 0; t < kList; ++t) {
          lv[t] = CUDART_INF_F;
          li[t] = 0x7fffffff;
        }
        // a staged tile reads every row from shared memory: no per-row choice
        uint16_t* list = s_list + warp * 8 * B;
        const int n_list =
            !hit     ? 0
            : staged ? compact_query<kWide, true>(a, L, s_occ, row, sid, lane, list)
                     : compact_query<kWide, false>(a, L, s_occ, row, sid, lane, list);
        int left = staged ? score_list<true, false>(a, L, s_pts, row, sid, list, n_list, lane, qx,
                                                    qy, qz, 0.f, 0, lv, li)
                          : score_list<false, false>(a, L, s_pts, row, sid, list, n_list, lane,
                                                     qx, qy, qz, 0.f, 0, lv, li);
        float myv = kBig;
        int found = 0;  // winners so far (the same in every lane)
        for (; found < k; ++found) {
          const unsigned hv = __float_as_uint(lv[0]);
          const unsigned bv = __reduce_min_sync(kFull, hv);
          if (bv >= 0x7f800000u) break;  // no candidate left
          bool mine = hv == bv;
          const unsigned tied = __ballot_sync(kFull, mine);
          if (tied & (tied - 1)) {  // equal heads: the lower index wins (every lane reduces)
            const unsigned bi = __reduce_min_sync(kFull, mine ? (unsigned)li[0] : 0xffffffffu);
            mine = mine && (unsigned)li[0] == bi;
          }
          if (lane == found) myv = __uint_as_float(bv);
          if (mine) {  // the one winning lane records and pops its head
            s_win[warp * kMaxK + found] = li[0];
            const float fv = lv[0];
            const int fi = li[0];
#pragma unroll
            for (int t = 0; t < kList - 1; ++t) {
              lv[t] = lv[t + 1];
              li[t] = li[t + 1];
            }
            lv[kList - 1] = CUDART_INF_F;
            li[kList - 1] = 0x7fffffff;
            if (--left > 0 && !(lv[0] < CUDART_INF_F))  // ran dry: rescore above (fv, fi)
              left = staged ? score_list<true, true>(a, L, s_pts, row, sid, list, n_list, lane,
                                                     qx, qy, qz, fv, fi, lv, li)
                            : score_list<false, true>(a, L, s_pts, row, sid, list, n_list, lane,
                                                      qx, qy, qz, fv, fi, lv, li);
          }
        }
        __syncwarp();
        const int myi = lane < found ? s_win[warp * kMaxK + lane] : -1;
        if (lane < k) {
          a.out_sq[qi * k + lane] = myi >= 0 ? myv : kBig;
          a.out_valid[qi * k + lane] = myi >= 0 ? 1 : 0;
        }
        for (int t0 = 0; t0 < 3 * k; t0 += 32) {
          const int t = t0 + lane, s = min(t / 3, 31);
          const int wi = __shfl_sync(kFull, myi, s);
          if (t < 3 * k) {
            float v = 0.f;
            if (wi >= 0) {
              const int o = wi >> 8, c = 3 * (wi & 255) + (t - 3 * s);
              v = sid[o] >= 0 ? s_pts[sid[o] * L.ps + c] : a.points[(size_t)row[o] * 3 * B + c];
            }
            a.out_pts[qi * k * 3 + t] = v;
          }
        }
      }
      __syncthreads();  // the tile's shared memory is read to the end before the next fills it
    }
    __syncthreads();  // s_live is read by all before warp 0 writes the next group's
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
  if (n <= 0 || bucket <= 0 || bucket > kMaxBucket || k < 1 || k > kMaxK || probes < 1 ||
      log2_slots < 1 || log2_slots > 30 || block_sub < 1 || device < 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int wide = bucket > 64;  // rows of more than two sub-voxels a lane
  void (*kernel)(Args) = wide ? octant_knn_kernel<true> : octant_knn_kernel<false>;
  static bool raised[64][2] = {};  // the dynamic shared-memory cap, set once per device
  if (device < 64 && !raised[device][wide]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    raised[device][wide] = true;
  }
  const int stage_rows = stage_rows_for(bucket);
  const int smem = Layout(kTile, bucket, stage_rows).bytes;
  const bool vec = bucket % 16 == 0 && (uintptr_t)points % 16 == 0 && (uintptr_t)occ % 16 == 0;
  const Args a{queries, qmask, points, occ, ktab, n, bucket, k, probes, log2_slots, block_sub,
               sub_voxel, block_size, kTile, stage_rows, vec, out_sq, out_pts, out_valid};
  // as many CTAs as fit on the card at once (each walks tiles blockIdx.x,
  // + gridDim.x, ...), remembered for the last device, instance and bucket
  static int memo[4] = {-1, 0, 0, 0};  // device, wide, smem, CTAs
  if (memo[0] != device || memo[1] != wide || memo[2] != smem) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    memo[0] = device, memo[1] = wide, memo[2] = smem, memo[3] = per_sm * sms;
  }
  const int grid = min((n + kTile - 1) / kTile, memo[3]);
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// The launch the kernel takes for rows of `bucket` sub-voxels: queries per
// tile, rows staged in shared memory and dynamic shared-memory bytes per CTA.
int octant_knn_launch_shape(int bucket, int* tile, int* stage_rows, int* smem_bytes) {
  if (bucket <= 0 || bucket > kMaxBucket) return (int)cudaErrorInvalidValue;
  *tile = kTile;
  *stage_rows = stage_rows_for(bucket);
  *smem_bytes = Layout(kTile, bucket, *stage_rows).bytes;
  return 0;
}

const char* octant_knn_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
