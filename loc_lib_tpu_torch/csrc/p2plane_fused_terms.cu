// K1: fused voxel-plane P2Plane linearization for Hopper (sm_90a).
//
// Replaces the TPU kernel `p2plane_fused_terms` / `_p2plane_kernel` in
// loc_lib_tpu/ops/pallas_kernels.py (entry :75, body :35).
//
// Per source point i (q (N,3), plane (N,4) rows [n, d] with a row stride,
// w (N,) 0/1):
//   qs  = R q + t
//   dis = n . qs + d
//   w'  = w * [|dis| <= gate]
//   rn  = R^T n;  J_rot = -(rn x q);  J_t = n
//   A   = [J_rot, n, dis, 1] * w'
// and G = sum_i A A^T (fused_terms.cuh).
//
// What bounds it on this card: at the path's N = 8192 it reads
// 8192 * 32 B ~ 262 KB (q 12 B + plane 16 B + w 4 B per point) and does
// ~36 FMAs per point -- a few microseconds of HBM time at 3.35 TB/s and
// nothing for the ALUs. Launch latency and the cross-block reduction tail
// bound it, not HBM.
// What the design does about that: one pass, one thread per point, all 36
// products kept in registers (no tensor cores: 36 FMAs per point do not
// fill an MMA tile), a single partials write per block, and a tiny second
// launch; R, t and the gate are read from the device tensors the previous
// Gauss-Newton iteration wrote, so the loop neither syncs nor launches
// anything to hand them over. No padding copy: the ragged edge is masked
// by the loop bound.
#include "fused_terms.cuh"

namespace loc_fused {

static __global__ void __launch_bounds__(kThreads)
p2plane_fused_kernel(const float* __restrict__ q, const float* __restrict__ plane,
                     int plane_stride, const float* __restrict__ w,
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
    const float* pl = plane + static_cast<long long>(i) * plane_stride;
    const float nx = __ldg(pl), ny = __ldg(pl + 1), nz = __ldg(pl + 2), d = __ldg(pl + 3);
    const float qsx = p[0] * x + p[1] * y + p[2] * z + p[9];
    const float qsy = p[3] * x + p[4] * y + p[5] * z + p[10];
    const float qsz = p[6] * x + p[7] * y + p[8] * z + p[11];
    const float dis = nx * qsx + ny * qsy + nz * qsz + d;
    const float wi = __ldg(w + i) * (fabsf(dis) <= p[12] ? 1.f : 0.f);
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

extern "C" int p2plane_fused_terms_launch(const void* q, const void* plane, int plane_stride,
                                          const void* w, const void* R, const void* t,
                                          const void* gate_ptr, float gate_value, int n,
                                          void* partials, int num_blocks, void* G, void* b,
                                          void* count, void* stream) {
  using namespace loc_fused;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  p2plane_fused_kernel<<<num_blocks, kThreads, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(plane), plane_stride,
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

extern "C" const char* loc_fused_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
