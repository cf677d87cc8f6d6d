// Native data-loader runtime: threaded KITTI .bin reader + ring-grid binning.
//
// The reference's ingestion tier is native C++ (A-LOAM kittiHelper.cpp:25-38
// reads velodyne .bin files and republishes them; the livox/velodyne drivers
// are C++ nodes). This library is the engine's equivalent: a prefetching
// loader that overlaps disk I/O and CPU-side binning with device compute.
// (A copy of the JAX package's io/native/lidar_io.cpp; the port builds it
// with g++ into agi_lidar_slam_torch/_build/ at first use, _build.build_host.)
//
// Worker threads read scans ahead of the consumer into a bounded queue
// (backpressure = the reference's bounded ROS queues, but lossless);
// binning reproduces pointcloud/cloud.py grid_from_unorganized exactly:
// elevation -> ring row, azimuth -> column, blind-zone removal, last-write-
// wins on cell collisions within a scan.
//
// C ABI only (consumed via ctypes; no pybind11 dependency).

#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct GridScan {
  int64_t index = -1;
  std::vector<float> xyz;      // R*W*3
  std::vector<uint8_t> mask;   // R*W
  std::vector<float> time;     // R*W
};

struct LoaderConfig {
  int rings, width;
  float fov_up, fov_down, min_range;
};

void bin_scan(const std::vector<float>& pts, int n_pts, const LoaderConfig& c,
              GridScan* out) {
  const int R = c.rings, W = c.width;
  out->xyz.assign((size_t)R * W * 3, 0.f);
  out->mask.assign((size_t)R * W, 0);
  out->time.resize((size_t)R * W);
  for (int col = 0; col < W; ++col) {
    float t = (float)col / (float)W;
    for (int r = 0; r < R; ++r) out->time[(size_t)r * W + col] = t;
  }
  const float span = c.fov_up - c.fov_down;
  const float kPi = 3.14159265358979323846f;
  for (int i = 0; i < n_pts; ++i) {
    float x = pts[(size_t)i * 4 + 0];
    float y = pts[(size_t)i * 4 + 1];
    float z = pts[(size_t)i * 4 + 2];
    float range = std::sqrt(x * x + y * y + z * z);
    if (range <= c.min_range) continue;  // blind-zone removal
    float elev = std::asin(z / range) * 180.f / kPi;
    float azim = std::atan2(y, x);
    int ring = (int)std::lround((elev - c.fov_down) / span * (R - 1));
    int col = (int)std::lround((azim + kPi) / (2.f * kPi) * (W - 1));
    if (ring < 0 || ring >= R || col < 0 || col >= W) continue;
    size_t cell = (size_t)ring * W + col;
    out->xyz[cell * 3 + 0] = x;
    out->xyz[cell * 3 + 1] = y;
    out->xyz[cell * 3 + 2] = z;
    out->mask[cell] = 1;
  }
}

struct Loader {
  LoaderConfig cfg;
  std::vector<std::string> paths;
  size_t queue_depth;

  std::mutex mu;
  std::condition_variable cv_produce, cv_consume;
  std::deque<GridScan> ready;       // ordered by next_emit
  int64_t next_read = 0;            // next file index to claim
  int64_t next_emit = 0;            // next index the consumer receives
  std::atomic<bool> stop{false};
  std::vector<std::thread> workers;

  void worker() {
    for (;;) {
      int64_t idx;
      {
        std::lock_guard<std::mutex> lk(mu);
        if (stop.load() || next_read >= (int64_t)paths.size()) return;
        idx = next_read++;
      }
      // read the .bin (x,y,z,intensity float32 rows — kittiHelper.cpp:25-38)
      std::vector<float> raw;
      {
        FILE* f = std::fopen(paths[idx].c_str(), "rb");
        if (f) {
          std::fseek(f, 0, SEEK_END);
          long bytes = std::ftell(f);
          std::fseek(f, 0, SEEK_SET);
          raw.resize(bytes / sizeof(float));
          size_t got = std::fread(raw.data(), sizeof(float), raw.size(), f);
          raw.resize(got);
          std::fclose(f);
        }
      }
      GridScan g;
      g.index = idx;
      bin_scan(raw, (int)(raw.size() / 4), cfg, &g);
      // in-order insertion with bounded depth
      std::unique_lock<std::mutex> lk(mu);
      cv_produce.wait(lk, [&] {
        return stop.load() ||
               (idx < next_emit + (int64_t)queue_depth);
      });
      if (stop.load()) return;
      ready.push_back(std::move(g));
      cv_consume.notify_all();
    }
  }
};

// ---------------------------------------------------------------------------
// LZ4 decompression (frame + block formats), for lz4-compressed rosbag chunks
// (roslz4 writes the standard LZ4 frame format). Self-contained — no liblz4
// dependency in the image. Consumed by io/rosbag.py via ctypes.
// ---------------------------------------------------------------------------

static int64_t lz4_block_decode(const uint8_t* src, int64_t src_len,
                                uint8_t* dst, int64_t dst_pos, int64_t dst_cap) {
  // LZ4 block: sequences of [token][literals][offset][matchlen ext].
  // Matches may reach back before dst_pos (block-dependent streams decode
  // into one contiguous buffer, so that is naturally supported).
  int64_t s = 0;
  int64_t d = dst_pos;
  while (s < src_len) {
    uint8_t token = src[s++];
    int64_t lit = token >> 4;
    if (lit == 15) {
      uint8_t b;
      do {
        if (s >= src_len) return -1;
        b = src[s++];
        lit += b;
      } while (b == 255);
    }
    if (s + lit > src_len || d + lit > dst_cap) return -1;
    std::memcpy(dst + d, src + s, (size_t)lit);
    s += lit;
    d += lit;
    if (s >= src_len) break;  // final sequence: literals only
    if (s + 2 > src_len) return -1;
    int64_t offset = (int64_t)src[s] | ((int64_t)src[s + 1] << 8);
    s += 2;
    if (offset == 0 || offset > d) return -1;
    int64_t mlen = (token & 0x0F);
    if (mlen == 15) {
      uint8_t b;
      do {
        if (s >= src_len) return -1;
        b = src[s++];
        mlen += b;
      } while (b == 255);
    }
    mlen += 4;
    if (d + mlen > dst_cap) return -1;
    const uint8_t* m = dst + d - offset;
    for (int64_t i = 0; i < mlen; ++i) dst[d + i] = m[i];  // overlap-safe
    d += mlen;
  }
  return d - dst_pos;
}

static uint32_t rd32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}

}  // namespace

extern "C" {

// Decode an LZ4 *frame* (magic 0x184D2204). Returns bytes written, or -1.
int64_t lz4_frame_decode(const uint8_t* src, int64_t src_len, uint8_t* dst,
                         int64_t dst_cap) {
  if (src_len < 7) return -1;
  int64_t s = 0;
  if (rd32(src) != 0x184D2204u) return -1;
  s += 4;
  uint8_t flg = src[s++];
  s += 1;  // BD byte (block max size) — irrelevant for decoding
  bool b_checksum = (flg >> 4) & 1;
  bool c_size = (flg >> 3) & 1;
  bool dict_id = flg & 1;
  if (c_size) s += 8;
  if (dict_id) s += 4;
  s += 1;  // header checksum
  int64_t d = 0;
  while (s + 4 <= src_len) {
    uint32_t bsz = rd32(src + s);
    s += 4;
    if (bsz == 0) break;  // EndMark
    bool stored = (bsz & 0x80000000u) != 0;
    int64_t blen = bsz & 0x7FFFFFFFu;
    if (s + blen > src_len) return -1;
    if (stored) {
      if (d + blen > dst_cap) return -1;
      std::memcpy(dst + d, src + s, (size_t)blen);
      d += blen;
    } else {
      int64_t out = lz4_block_decode(src + s, blen, dst, d, dst_cap);
      if (out < 0) return -1;
      d += out;
    }
    s += blen;
    if (b_checksum) s += 4;
  }
  return d;
}

void* loader_create(const char** paths, int n_paths, int rings, int width,
                    float fov_up, float fov_down, float min_range,
                    int n_threads, int queue_depth) {
  auto* L = new Loader();
  L->cfg = LoaderConfig{rings, width, fov_up, fov_down, min_range};
  L->paths.reserve(n_paths);
  for (int i = 0; i < n_paths; ++i) L->paths.emplace_back(paths[i]);
  L->queue_depth = queue_depth > 0 ? queue_depth : 4;
  int nt = n_threads > 0 ? n_threads : 2;
  for (int i = 0; i < nt; ++i) L->workers.emplace_back(&Loader::worker, L);
  return L;
}

// Blocks until the next in-order scan is available; fills caller buffers.
// Returns the scan index, or -1 when the sequence is exhausted.
int64_t loader_next(void* handle, float* xyz_out, uint8_t* mask_out,
                    float* time_out) {
  auto* L = static_cast<Loader*>(handle);
  std::unique_lock<std::mutex> lk(L->mu);
  if (L->next_emit >= (int64_t)L->paths.size()) return -1;
  int64_t want = L->next_emit;
  L->cv_consume.wait(lk, [&] {
    if (L->stop.load()) return true;
    for (const auto& g : L->ready)
      if (g.index == want) return true;
    return false;
  });
  if (L->stop.load()) return -1;
  for (auto it = L->ready.begin(); it != L->ready.end(); ++it) {
    if (it->index == want) {
      std::memcpy(xyz_out, it->xyz.data(), it->xyz.size() * sizeof(float));
      std::memcpy(mask_out, it->mask.data(), it->mask.size());
      std::memcpy(time_out, it->time.data(), it->time.size() * sizeof(float));
      L->ready.erase(it);
      L->next_emit++;
      L->cv_produce.notify_all();
      return want;
    }
  }
  return -1;  // unreachable
}

void loader_destroy(void* handle) {
  auto* L = static_cast<Loader*>(handle);
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->stop.store(true);
  }
  L->cv_produce.notify_all();
  L->cv_consume.notify_all();
  for (auto& t : L->workers) t.join();
  delete L;
}

}  // extern "C"
