// loc_runtime: native host-side runtime of the SLAM engine (a copy of the
// JAX package's cpp/loc_runtime.cpp, built apart from it into
// loc_lib_tpu_torch/csrc/build/).
//
// The reference implements its I/O runtime in C++ as ROS subscriber threads
// feeding mutexed deques plus a measurement synchronizer
// (LocUtils/src/subscriber/cloud_subscriber.cpp:7-157,
//  LocUtils/src/model/sync/measure_sync.cpp:14-210).
// The engine replays logs offline, but the host-side work is the same
// and sits on the critical path between storage and the device: vendor
// point conversion (per-point time normalization, ring handling, min-range
// culling), packing variable-length scans into the fixed-capacity padded
// tensors the device steps take, and grouping IMU samples per scan with
// straddling-sample interpolation. This library does that work in
// multithreaded C++ so the Python driver only moves ready-made buffers to
// the device.
//
// Exposed as a plain C ABI consumed via ctypes (loc_lib_tpu_torch/io/native.py).
// All matrices are row-major contiguous; all counts are int64 to match
// numpy defaults.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <limits>
#include <thread>
#include <vector>

namespace {

int hardware_threads() {
  unsigned n = std::thread::hardware_concurrency();
  return n == 0 ? 2 : static_cast<int>(n);
}

// Run fn(begin, end) over [0, total) split across threads.
template <typename F>
void parallel_for(int64_t total, F fn) {
  int nt = std::min<int64_t>(hardware_threads(), std::max<int64_t>(total, 1));
  if (nt <= 1 || total < 2) {
    fn(0, total);
    return;
  }
  std::vector<std::thread> threads;
  int64_t chunk = (total + nt - 1) / nt;
  for (int k = 0; k < nt; ++k) {
    int64_t b = k * chunk;
    int64_t e = std::min(total, b + chunk);
    if (b >= e) break;
    threads.emplace_back([=] { fn(b, e); });
  }
  for (auto& t : threads) t.join();
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// Vendor cloud conversion (CloudConver, cloud_subscriber.cpp:7-62).
//
// In:  xyz        (n, 3) f32 raw vendor points (may contain NaN rows)
//      point_time (n,)   f64 per-point absolute or relative timestamps
//                        (pass nullptr if absent)
//      ring       (n,)   i32 laser ring index (pass nullptr if absent)
//      min_range / max_range: Euclidean culling gates (the reference culls
//                        < 4 m for Robosense, cloud_subscriber.cpp:45-49)
//      capacity:  output slot count (fixed-shape padding)
// Out: out_xyz    (capacity, 3) f32, PAD value for empty slots
//      out_rel_t  (capacity,)   f32 time since scan start (Robosense
//                        timestamp -> time_intervel, cloud_subscriber.cpp:27-40)
//      out_ring   (capacity,)   i32 (-1 padded)
//      out_mask   (capacity,)   u8
// Returns number of valid points written (<= capacity).
int64_t lr_convert_cloud(const float* xyz, const double* point_time,
                         const int32_t* ring, int64_t n, float min_range,
                         float max_range, float pad_value, int64_t capacity,
                         float* out_xyz, float* out_rel_t, int32_t* out_ring,
                         uint8_t* out_mask) {
  // Pass 1: earliest per-point time = scan start (cloud_subscriber.cpp:27-33).
  double t0 = 0.0;
  bool has_t = point_time != nullptr;
  if (has_t && n > 0) {
    t0 = point_time[0];
    for (int64_t i = 1; i < n; ++i) t0 = std::min(t0, point_time[i]);
  }
  const float min2 = min_range * min_range;
  const float max2 = max_range * max_range;

  // Sequential compaction (order-preserving, like the reference's push_back
  // loop); the per-frame batch API below parallelizes across frames.
  int64_t m = 0;
  for (int64_t i = 0; i < n && m < capacity; ++i) {
    const float x = xyz[3 * i], y = xyz[3 * i + 1], z = xyz[3 * i + 2];
    if (!std::isfinite(x) || !std::isfinite(y) || !std::isfinite(z)) continue;
    const float r2 = x * x + y * y + z * z;
    if (r2 < min2 || r2 > max2) continue;
    out_xyz[3 * m] = x;
    out_xyz[3 * m + 1] = y;
    out_xyz[3 * m + 2] = z;
    out_rel_t[m] = has_t ? static_cast<float>(point_time[i] - t0) : 0.0f;
    out_ring[m] = ring ? ring[i] : -1;
    out_mask[m] = 1;
    ++m;
  }
  for (int64_t i = m; i < capacity; ++i) {
    out_xyz[3 * i] = out_xyz[3 * i + 1] = out_xyz[3 * i + 2] = pad_value;
    out_rel_t[i] = 0.0f;
    out_ring[i] = -1;
    out_mask[i] = 0;
  }
  return m;
}

// Batch variant: F frames stored as a CSR-style pool (offsets into one point
// pool), converted in parallel into an (F, capacity, ...) block.
void lr_convert_cloud_batch(const float* xyz_pool, const double* time_pool,
                            const int32_t* ring_pool, const int64_t* offsets,
                            int64_t num_frames, float min_range,
                            float max_range, float pad_value, int64_t capacity,
                            float* out_xyz, float* out_rel_t, int32_t* out_ring,
                            uint8_t* out_mask, int64_t* out_counts) {
  parallel_for(num_frames, [&](int64_t b, int64_t e) {
    for (int64_t f = b; f < e; ++f) {
      const int64_t lo = offsets[f], hi = offsets[f + 1];
      out_counts[f] = lr_convert_cloud(
          xyz_pool + 3 * lo, time_pool ? time_pool + lo : nullptr,
          ring_pool ? ring_pool + lo : nullptr, hi - lo, min_range, max_range,
          pad_value, capacity, out_xyz + 3 * capacity * f,
          out_rel_t + capacity * f, out_ring + capacity * f,
          out_mask + capacity * f);
    }
  });
}

// ---------------------------------------------------------------------------
// Measurement sync (MappingMessageSync, measure_sync.cpp:42-181).
//
// For every scan k: gather IMU samples with prev_scan < t <= t_scan into a
// fixed-capacity packet, then append one sample linearly interpolated to
// exactly t_scan when the stream straddles it (measure_sync.cpp:109-148).
// Frames are independent after the per-frame search bounds are known, so
// the fill parallelizes across frames.
//
// In:  scan_stamps (F,) f64 ascending; imu_stamps (M,) f64 ascending;
//      imu_gyro / imu_acce (M, 3) f32; capacity C.
// Out: out_stamp (F, C) f32, out_gyro/out_acce (F, C, 3) f32,
//      out_valid (F, C) u8.
void lr_sync_measures(const double* scan_stamps, int64_t num_frames,
                      const double* imu_stamps, const float* imu_gyro,
                      const float* imu_acce, int64_t num_imu, int64_t capacity,
                      float* out_stamp, float* out_gyro, float* out_acce,
                      uint8_t* out_valid) {
  parallel_for(num_frames, [&](int64_t fb, int64_t fe) {
    for (int64_t k = fb; k < fe; ++k) {
      const double t_scan = scan_stamps[k];
      const double t_prev =
          k == 0 ? -std::numeric_limits<double>::infinity() : scan_stamps[k - 1];
      float* stamp = out_stamp + k * capacity;
      float* gyro = out_gyro + k * capacity * 3;
      float* acce = out_acce + k * capacity * 3;
      uint8_t* valid = out_valid + k * capacity;
      std::memset(stamp, 0, sizeof(float) * capacity);
      std::memset(gyro, 0, sizeof(float) * capacity * 3);
      std::memset(acce, 0, sizeof(float) * capacity * 3);
      std::memset(valid, 0, capacity);
      if (num_imu == 0) continue;

      // [lo, hi) = samples in (t_prev, t_scan]
      const double* begin = imu_stamps;
      const double* end = imu_stamps + num_imu;
      int64_t lo = std::upper_bound(begin, end, t_prev) - begin;
      int64_t hi = std::upper_bound(begin, end, t_scan) - begin;

      const bool have_before = hi > 0;        // some sample <= t_scan
      const bool have_after = hi < num_imu;   // some sample  > t_scan
      const bool exact_end = hi > lo && imu_stamps[hi - 1] == t_scan;
      const bool need_interp = !exact_end && have_after && have_before;

      int64_t room = capacity - (need_interp ? 1 : 0);
      int64_t m = std::min(hi - lo, room);
      for (int64_t i = 0; i < m; ++i) {
        stamp[i] = static_cast<float>(imu_stamps[lo + i]);
        std::memcpy(gyro + 3 * i, imu_gyro + 3 * (lo + i), 3 * sizeof(float));
        std::memcpy(acce + 3 * i, imu_acce + 3 * (lo + i), 3 * sizeof(float));
        valid[i] = 1;
      }
      if (need_interp && m < capacity) {
        // interpolate between hi-1 and hi (both exist by construction)
        const int64_t a = hi - 1, b2 = hi;
        const double den = std::max(imu_stamps[b2] - imu_stamps[a], 1e-9);
        const float alpha = static_cast<float>((t_scan - imu_stamps[a]) / den);
        stamp[m] = static_cast<float>(t_scan);
        for (int d = 0; d < 3; ++d) {
          gyro[3 * m + d] = imu_gyro[3 * a + d] * (1.0f - alpha) +
                            imu_gyro[3 * b2 + d] * alpha;
          acce[3 * m + d] = imu_acce[3 * a + d] * (1.0f - alpha) +
                            imu_acce[3 * b2 + d] * alpha;
        }
        valid[m] = 1;
      }
    }
  });
}

// ---------------------------------------------------------------------------
// Trajectory export (SavePose, src/tools/save_pose.cpp:70-103): KITTI rows
// formatted natively — the Python text loop dominates export time for long
// runs. Returns bytes written into `out` (caller sizes it: 12*25 per pose).
int64_t lr_format_kitti(const float* poses /* (F, 4, 4) */, int64_t num_frames,
                        char* out, int64_t out_cap) {
  int64_t w = 0;
  for (int64_t f = 0; f < num_frames; ++f) {
    const float* T = poses + 16 * f;
    for (int r = 0; r < 3; ++r) {
      for (int c = 0; c < 4; ++c) {
        int k = snprintf(out + w, out_cap - w, "%.9g%c", T[4 * r + c],
                         (r == 2 && c == 3) ? '\n' : ' ');
        if (k < 0 || w + k >= out_cap) return -1;
        w += k;
      }
    }
  }
  return w;
}

int lr_version() { return 1; }

}  // extern "C"
