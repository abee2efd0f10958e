// K2: fused election + voxel-plane P2Plane linearization for Hopper (sm_90a).
//
// Replaces the TPU kernel `p2plane_pick_fused_terms` /
// `_make_p2plane_pick_kernel` in loc_lib_tpu/ops/pallas_kernels.py
// (entry :185, body :123).
//
// Per source point i, over its S candidate rows [n(3), d, mu(3), valid]
// (rows (N, S, 8) row-major, the JAX package's public layout):
//   qs = R q + t
//   election: running minimum of |mu_s - qs|^2 over the valid rows with a
//   STRICT '<', so the first stencil entry wins ties; no valid row keeps
//   the zero plane
//   w' = w * any_valid * [|n . qs + d| <= gate]
// then the K1 row A = [-(R^T n x q), n, dis, 1] * w' and G = sum A A^T
// (fused_terms.cuh).
//
// What bounds it on this card: at the path's N = 8192, S = 7 it reads
// 8192 * (7 * 32 + 16) B ~ 1.9 MB -- under a microsecond of HBM time at
// 3.35 TB/s, and the rows stay L2-resident (50 MB) after the gather that
// produced them. Launch latency and the cross-block reduction tail bound
// it, not HBM.
// What the design does about that: one thread per point reads its 7 rows
// as 14 aligned 16-byte loads, runs the 7-way select chain in registers,
// and feeds the same register-resident 36-entry accumulation and
// two-launch deterministic reduction as K1. R, t and the gate are read
// from the device tensors the previous GN iteration wrote.
#include <math_constants.h>

#include "fused_terms.cuh"

namespace loc_fused {

static __global__ void __launch_bounds__(kThreads)
p2plane_pick_fused_kernel(const float* __restrict__ q, const float* __restrict__ rows,
                          int S, const float* __restrict__ w,
                          const float* __restrict__ R, const float* __restrict__ t,
                          const float* __restrict__ gate_ptr, float gate_value, int n,
                          float* __restrict__ partials) {
  float p[13];
  load_pose(R, t, gate_ptr, gate_value, p);

  float acc[kEntries];
#pragma unroll
  for (int e = 0; e < kEntries; ++e) acc[e] = 0.f;

  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    const float x = __ldg(q + 3 * i), y = __ldg(q + 3 * i + 1), z = __ldg(q + 3 * i + 2);
    const float qsx = p[0] * x + p[1] * y + p[2] * z + p[9];
    const float qsy = p[3] * x + p[4] * y + p[5] * z + p[10];
    const float qsz = p[6] * x + p[7] * y + p[8] * z + p[11];

    const float4* r = reinterpret_cast<const float4*>(rows) + static_cast<long long>(i) * S * 2;
    float best_d2 = CUDART_INF_F;
    float nx = 0.f, ny = 0.f, nz = 0.f, d = 0.f;
    float any_valid = 0.f;
    for (int s = 0; s < S; ++s) {
      const float4 plane = __ldg(r + 2 * s);      // n(3), d
      const float4 cen = __ldg(r + 2 * s + 1);    // mu(3), valid
      const float dx = cen.x - qsx, dy = cen.y - qsy, dz = cen.z - qsz;
      const float d2 = cen.w > 0.5f ? dx * dx + dy * dy + dz * dz : CUDART_INF_F;
      if (d2 < best_d2) {                         // strict: first entry wins ties
        best_d2 = d2;
        nx = plane.x; ny = plane.y; nz = plane.z; d = plane.w;
      }
      any_valid = fmaxf(any_valid, cen.w);
    }

    const float dis = nx * qsx + ny * qsy + nz * qsz + d;
    const float wi = __ldg(w + i) * any_valid * (fabsf(dis) <= p[12] ? 1.f : 0.f);
    const float rnx = p[0] * nx + p[3] * ny + p[6] * nz;
    const float rny = p[1] * nx + p[4] * ny + p[7] * nz;
    const float rnz = p[2] * nx + p[5] * ny + p[8] * nz;
    const float a[8] = {-(rny * z - rnz * y) * wi, -(rnz * x - rnx * z) * wi,
                        -(rnx * y - rny * x) * wi, nx * wi, ny * wi, nz * wi,
                        dis * wi, wi};
    accumulate_row(acc, a);
  }
  store_block_partials(acc, partials);
}

}  // namespace loc_fused

extern "C" int p2plane_pick_fused_terms_launch(const void* q, const void* rows, int S,
                                               const void* w, const void* R, const void* t,
                                               const void* gate_ptr, float gate_value, int n,
                                               void* partials, int num_blocks, void* G,
                                               void* b, void* count, void* stream) {
  using namespace loc_fused;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  p2plane_pick_fused_kernel<<<num_blocks, kThreads, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(rows), S,
      static_cast<const float*>(w), static_cast<const float*>(R),
      static_cast<const float*>(t), static_cast<const float*>(gate_ptr), gate_value, n,
      static_cast<float*>(partials));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  finalize_kernel<<<1, 64, 0, s>>>(static_cast<const float*>(partials), num_blocks,
                                   static_cast<float*>(G), static_cast<float*>(b),
                                   static_cast<int*>(count));
  return static_cast<int>(cudaGetLastError());
}
