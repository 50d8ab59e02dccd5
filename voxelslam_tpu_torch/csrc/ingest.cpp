// Native host-side LiDAR ingest of the PyTorch port (voxelslam_tpu_torch):
// the port's copy of the JAX package's native/ingest.cpp, built with g++
// by voxelslam_tpu_torch/native.py and bound with ctypes.
//
// The host-side counterpart of the reference's C++ sensor ingest layer
// (`Features::process` per LiDAR type, feature_point.hpp:96-370 in the
// reference tree): decode raw structured point records -> filter
// (blind radius, 1-in-N decimation, max time offset) -> stable sort by
// per-point time. The compute path runs as torch ops on the device; this
// is the data loader feeding it, kept native because it runs per scan on
// the host against raw sensor buffers.
//
// Generic over vendor record layouts: the caller passes byte offsets of
// the x/y/z/time/intensity fields plus a time scale, so one entry point
// covers the six reference formats (LIVOX ns offsets, Ouster ns, HESAI
// absolute seconds, Velodyne seconds, ...). Exposed with a plain C ABI
// for ctypes.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

namespace {

inline double read_field(const uint8_t* rec, int64_t off, int type) {
  // type: 0=f32, 1=f64, 2=u32, 3=i32, 4=u16, 5=u8, 6=i64, 7=u64
  switch (type) {
    case 0: { float v;    std::memcpy(&v, rec + off, 4); return v; }
    case 1: { double v;   std::memcpy(&v, rec + off, 8); return v; }
    case 2: { uint32_t v; std::memcpy(&v, rec + off, 4); return v; }
    case 3: { int32_t v;  std::memcpy(&v, rec + off, 4); return v; }
    case 4: { uint16_t v; std::memcpy(&v, rec + off, 2); return v; }
    case 5: { uint8_t v;  std::memcpy(&v, rec + off, 1); return v; }
    case 6: { int64_t v;  std::memcpy(&v, rec + off, 8); return (double)v; }
    case 7: { uint64_t v; std::memcpy(&v, rec + off, 8); return (double)v; }
    default: return 0.0;
  }
}

}  // namespace

extern "C" {

// Decode `n` records of `stride` bytes. Field descriptors: byte offset
// + type code per field; offset -1 means "absent". Behavior mirrors the
// reference handlers: drop r^2 <= blind^2 and non-finite points, keep
// every `filter_num`-th survivor (feature_point.hpp:157-163), scale
// times by `t_scale` and rebase absolute stamps (`t_absolute`) to the
// scan minimum, drop offsets > max_offset (voxelslam.hpp:96), stable
// sort by offset. Outputs: xyz (n,3) f32, offs (n,) f32, inten (n,) f32.
// Returns the surviving count (<= n).
int64_t vs_decode(const uint8_t* raw, int64_t n, int64_t stride,
                  int64_t off_x, int type_x,
                  int64_t off_y, int type_y,
                  int64_t off_z, int type_z,
                  int64_t off_t, int type_t, double t_scale,
                  int t_absolute,
                  int64_t off_i, int type_i,
                  double blind, int64_t filter_num, double max_offset,
                  float* out_xyz, float* out_off, float* out_inten) {
  const double blind2 = blind * blind;
  std::vector<float> xs, ys, zs, ts, is;
  xs.reserve(n); ys.reserve(n); zs.reserve(n);
  ts.reserve(n); is.reserve(n);
  if (filter_num < 1) filter_num = 1;

  double t_min = 0.0;
  if (t_absolute && off_t >= 0) {
    t_min = 1e300;
    for (int64_t k = 0; k < n; ++k)
      t_min = std::min(t_min,
                       read_field(raw + k * stride, off_t, type_t));
  }

  int64_t kept_raw = 0;
  for (int64_t k = 0; k < n; ++k) {
    const uint8_t* rec = raw + k * stride;
    const double x = read_field(rec, off_x, type_x);
    const double y = read_field(rec, off_y, type_y);
    const double z = read_field(rec, off_z, type_z);
    const double r2 = x * x + y * y + z * z;
    if (!(r2 > blind2) || !std::isfinite(x) || !std::isfinite(y) ||
        !std::isfinite(z))
      continue;
    if ((kept_raw++ % filter_num) != 0) continue;
    double t = 0.0;
    if (off_t >= 0) {
      t = read_field(rec, off_t, type_t);
      if (t_absolute) t -= t_min;
      t *= t_scale;
    }
    if (t > max_offset) continue;
    double inten = (off_i >= 0) ? read_field(rec, off_i, type_i) : 0.0;
    xs.push_back((float)x); ys.push_back((float)y); zs.push_back((float)z);
    ts.push_back((float)t); is.push_back((float)inten);
  }

  const int64_t m = (int64_t)xs.size();
  std::vector<int64_t> order(m);
  std::iota(order.begin(), order.end(), 0);
  std::stable_sort(order.begin(), order.end(),
                   [&](int64_t a, int64_t b) { return ts[a] < ts[b]; });
  for (int64_t k = 0; k < m; ++k) {
    const int64_t s = order[k];
    out_xyz[3 * k + 0] = xs[s];
    out_xyz[3 * k + 1] = ys[s];
    out_xyz[3 * k + 2] = zs[s];
    out_off[k] = ts[s];
    out_inten[k] = is[s];
  }
  return m;
}

// Velodyne yaw-derived per-point time fallback when the record carries
// no stamps (feature_point.hpp:219-254): offset = ((yaw_first - yaw)
// mod 360) / omega, omega = 3610 deg/s.
void vs_yaw_times(const float* xyz, int64_t n, double omega_deg_s,
                  float* out_off) {
  if (n == 0) return;
  const double yaw_first =
      std::atan2(xyz[1], xyz[0]) * 57.29577951308232;
  for (int64_t k = 0; k < n; ++k) {
    const double yaw =
        std::atan2(xyz[3 * k + 1], xyz[3 * k]) * 57.29577951308232;
    double rel = std::fmod(yaw_first - yaw, 360.0);
    if (rel < 0) rel += 360.0;
    // points within FP noise of the start azimuth are scan-start, not a
    // full revolution (scalar vs vectorized atan2 differ in the last ulp)
    if (rel > 360.0 - 1e-2) rel = 0.0;
    out_off[k] = (float)(rel / omega_deg_s);
  }
}

// Host-side centroid voxel downsample (the reference's
// down_sampling_voxel, tools.hpp:201-238) for keyframe/submap merging
// on the host path. Open-addressing int64 hash; deterministic
// first-come slot order. Returns number of output points (<= cap).
int64_t vs_voxel_downsample(const float* xyz, int64_t n, double voxel,
                            int64_t cap, float* out_xyz) {
  if (n == 0 || voxel <= 0) return 0;
  const int64_t tab = [](int64_t c) {
    int64_t p = 1; while (p < c * 2) p <<= 1; return p; }(cap > n ? n : cap);
  std::vector<int64_t> keys(tab, INT64_MIN);
  std::vector<int32_t> slot_of(tab, -1);
  std::vector<double> sx, sy, sz;
  std::vector<int32_t> cnt;
  sx.reserve(cap); sy.reserve(cap); sz.reserve(cap); cnt.reserve(cap);
  const double inv = 1.0 / voxel;

  for (int64_t k = 0; k < n; ++k) {
    const double x = xyz[3 * k], y = xyz[3 * k + 1], z = xyz[3 * k + 2];
    const int64_t ix = (int64_t)std::floor(x * inv);
    const int64_t iy = (int64_t)std::floor(y * inv);
    const int64_t iz = (int64_t)std::floor(z * inv);
    // same int64 mix as the device hash (ops/voxel_hash.py)
    uint64_t h = (uint64_t)(ix * 73856093LL) ^
                 (uint64_t)(iy * 19349669LL) ^
                 (uint64_t)(iz * 83492791LL);
    const int64_t key =
        (ix & 0x1FFFFF) | ((iy & 0x1FFFFF) << 21) | ((iz & 0x1FFFFF) << 42);
    int64_t idx = (int64_t)(h & (uint64_t)(tab - 1));
    int32_t slot = -1;
    for (int64_t probe = 0; probe < tab; ++probe) {
      if (keys[idx] == INT64_MIN) {
        if ((int64_t)cnt.size() >= cap) { slot = -1; break; }
        keys[idx] = key;
        slot = (int32_t)cnt.size();
        slot_of[idx] = slot;
        sx.push_back(0); sy.push_back(0); sz.push_back(0); cnt.push_back(0);
        break;
      }
      if (keys[idx] == key) { slot = slot_of[idx]; break; }
      idx = (idx + 1) & (tab - 1);
    }
    if (slot < 0) continue;
    sx[slot] += x; sy[slot] += y; sz[slot] += z; cnt[slot] += 1;
  }
  const int64_t m = (int64_t)cnt.size();
  for (int64_t s = 0; s < m; ++s) {
    out_xyz[3 * s + 0] = (float)(sx[s] / cnt[s]);
    out_xyz[3 * s + 1] = (float)(sy[s] / cnt[s]);
    out_xyz[3 * s + 2] = (float)(sz[s] / cnt[s]);
  }
  return m;
}

}  // extern "C"
