// Host-side point-cloud runtime for dicp_tpu: fast I/O and preprocessing
// that feeds the device compute path.
//
// The reference has no native components (SURVEY.md §2.2) and no data loader
// at all — clouds arrive as in-memory torch tensors.  A production LiDAR
// odometry engine spends real wall-clock on the host side of the pipeline:
// reading scans from disk, voxel-downsampling, range filtering.  Doing this
// in Python can cost more than the device solve itself; this library keeps the
// host side off the critical path (the device-side jittable voxel filter in
// dicp_tpu/ops/voxel.py remains for clouds already resident in HBM).
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in this image).
// All functions are thread-safe (no globals) so the Python loader can
// prefetch scans from a thread pool.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <unordered_map>
#include <vector>

extern "C" {

// Read a KITTI-style .bin scan (float32 records of `stride` values per
// point, x/y/z first).  Returns the number of points read into `out`
// (caller allocates max_points * stride floats), or -1 on I/O error.
int64_t pc_load_bin(const char* path, float* out, int64_t max_points,
                    int32_t stride) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  size_t want = static_cast<size_t>(max_points) * stride;
  size_t got = std::fread(out, sizeof(float), want, f);
  std::fclose(f);
  return static_cast<int64_t>(got / stride);
}

// Write a .bin scan; returns points written or -1.
int64_t pc_save_bin(const char* path, const float* data, int64_t n_points,
                    int32_t stride) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  size_t want = static_cast<size_t>(n_points) * stride;
  size_t put = std::fwrite(data, sizeof(float), want, f);
  std::fclose(f);
  return static_cast<int64_t>(put / stride);
}

namespace {
struct CellSum {
  double acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};  // up to 8 averaged columns
  uint32_t count = 0;
};

inline uint64_t splitmix64(uint64_t x) {
  x += 0x9e3779b97f4a7c15ull;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ull;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebull;
  return x ^ (x >> 31);
}
}  // namespace

// Voxel-grid downsample: average all columns of the points falling in each
// (voxel)^3 cell, emit one centroid per occupied cell ordered by first
// occurrence (deterministic).  points: n x stride row-major, x/y/z first;
// out: caller-allocated n x stride; out_weight (optional): points per cell.
// Returns the number of occupied cells.
//
// Open-addressing (linear-probe) table at <=50% load instead of
// std::unordered_map: ~4x fewer cache misses, no per-cell allocation.  Cells
// are appended to a compact vector in first-occurrence order, so no final
// sort is needed either.
int64_t pc_voxel_downsample(const float* points, int64_t n, int32_t stride,
                            float voxel, float* out, float* out_weight) {
  if (stride > 8 || stride < 3 || voxel <= 0.f || n < 0) return -1;
  if (n == 0) return 0;
  const double inv = 1.0 / voxel;

  size_t cap = 16;
  while (cap < static_cast<size_t>(2 * n)) cap <<= 1;
  const size_t mask = cap - 1;
  constexpr uint64_t kEmpty = ~0ull;
  std::vector<uint64_t> slot_key(cap, kEmpty);
  std::vector<int32_t> slot_idx(cap);
  std::vector<CellSum> cells;
  cells.reserve(static_cast<size_t>(n) / 4 + 16);

  for (int64_t i = 0; i < n; ++i) {
    const float* p = points + i * stride;
    // 21-bit signed cell coordinates packed into one 64-bit key
    const int64_t cx = static_cast<int64_t>(std::floor(p[0] * inv)) & 0x1FFFFF;
    const int64_t cy = static_cast<int64_t>(std::floor(p[1] * inv)) & 0x1FFFFF;
    const int64_t cz = static_cast<int64_t>(std::floor(p[2] * inv)) & 0x1FFFFF;
    const uint64_t key = (static_cast<uint64_t>(cx) << 42) |
                         (static_cast<uint64_t>(cy) << 21) |
                         static_cast<uint64_t>(cz);
    size_t s = splitmix64(key) & mask;
    while (slot_key[s] != key && slot_key[s] != kEmpty) s = (s + 1) & mask;
    if (slot_key[s] == kEmpty) {
      slot_key[s] = key;
      slot_idx[s] = static_cast<int32_t>(cells.size());
      cells.emplace_back();
    }
    CellSum& c = cells[slot_idx[s]];
    for (int32_t d = 0; d < stride; ++d) c.acc[d] += p[d];
    ++c.count;
  }

  const int64_t m = static_cast<int64_t>(cells.size());
  for (int64_t j = 0; j < m; ++j) {
    const CellSum& c = cells[j];
    float* o = out + j * stride;
    for (int32_t d = 0; d < stride; ++d)
      o[d] = static_cast<float>(c.acc[d] / c.count);
    if (out_weight) out_weight[j] = static_cast<float>(c.count);
  }
  return m;
}

// Range filter: keep points with min_r <= |xyz| <= max_r.  In-place
// compaction into out (may alias points); returns kept count.
int64_t pc_range_filter(const float* points, int64_t n, int32_t stride,
                        float min_r, float max_r, float* out) {
  const float lo2 = min_r * min_r, hi2 = max_r * max_r;
  int64_t m = 0;
  for (int64_t i = 0; i < n; ++i) {
    const float* p = points + i * stride;
    const float r2 = p[0] * p[0] + p[1] * p[1] + p[2] * p[2];
    if (r2 >= lo2 && r2 <= hi2) {
      std::memmove(out + m * stride, p, sizeof(float) * stride);
      ++m;
    }
  }
  return m;
}

}  // extern "C"
