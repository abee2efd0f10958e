// K1: fused voxel-plane P2Plane linearization for Hopper (sm_90a), with the
// (voxel, octant) correspondence gather inside the kernel.
//
// Replaces the TPU kernel `p2plane_fused_terms` / `_p2plane_kernel` in
// loc_lib_tpu/ops/pallas_kernels.py (entry :75, pallas_call :97, body :35).
//
// Per source point i with plane [n, d] and weight w:
//   qs  = R q + t
//   dis = n . qs + d
//   w'  = w * [|dis| <= gate]
//   rn  = R^T n;  J_rot = -(rn x q);  J_t = n
//   A   = [J_rot, n, dis, 1] * w'
// and G = sum_i A A^T (fused_terms.cuh). One body, two ways to get the plane:
//   plane given   plane (N, 4) rows [n, d] with a row stride, w (N,) float:
//                 the TPU kernel's interface (the unfused-pick oracle);
//   from target   the correspondence pre-elected per (voxel, octant) cell:
//                 u = (qs - origin) * inv_leaf, voxel floor(u), octant bit k
//                 set where frac(u_k) > 0.5; one lookup of the voxel in the
//                 dilated dense table, one read of oct_table[slot][octant],
//                 one row read of packed_ext; w = hit & row valid & mask.
// The TPU kernel left the gather outside because Pallas on the TPU could not
// express a data-dependent row read; a CUDA thread reads the row it wants,
// so no (N, 8) row tensor is made and the ~40 small launches that built it
// leave the Gauss-Newton iteration.
//
// What bounds it on this card: bytes, and few of them. With the plane given
// at N = 8192 a call reads 8192 x 32 B = 262 KB (q 12 B + plane 16 B + w 4 B
// a point), 0.08 us of HBM time at 3.35 TB/s; from the target it reads
// 8192 x 13 B plus each table cell (4 B), octant entry (4 B) and plane row
// (32 B) it touches: 267 KB on a 65,536-point map, 0.08 us, and never more
// than 8192 x 53 B = 434 KB. The arithmetic (~150 float32 operations a
// point) is far under the 67 TFLOP/s line. The kernel runs 5-6 us: the
// tables (16 MB of slots, 7V x 32 B of octant entries, the rows) stay in
// the 50 MB L2 between iterations, and what a call costs is latency: the
// launch, a chain of dependent loads (pose, point, slot, octant entry, row)
// and the reduction's tail.
// What the design does about that: one thread a point, 128 threads a block
// (64 SMs busy at N = 8192), every read unconditional so no load waits for
// a test, all 36 products in registers (no tensor cores: an
// 8-wide float32 Gram sum fills no MMA tile), one launch (the last block to
// finish reduces, fused_terms.cuh). R, t and the gate are read from the
// device tensors the previous GN iteration wrote. No padding copy: the
// ragged edge is masked by the loop bound.
#include "fused_terms.cuh"

namespace loc_fused {

// Plane given.
static __global__ void __launch_bounds__(kThreads)
p2plane_kernel(const float* __restrict__ q, const float* __restrict__ plane, int plane_stride,
               const float* __restrict__ w, const float* __restrict__ R,
               const float* __restrict__ t, const float* __restrict__ gate_ptr,
               float gate_value, int n, Reduction red) {
  float p[13];
  load_pose(R, t, gate_ptr, gate_value, p);
  float acc[kEntries];
#pragma unroll
  for (int e = 0; e < kEntries; ++e) acc[e] = 0.f;

  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    const float x = __ldg(q + 3 * i), y = __ldg(q + 3 * i + 1), z = __ldg(q + 3 * i + 2);
    const float* pl = plane + static_cast<long long>(i) * plane_stride;
    const float nx = __ldg(pl), ny = __ldg(pl + 1), nz = __ldg(pl + 2), d = __ldg(pl + 3);
    float qsx, qsy, qsz;
    transform_point(p, x, y, z, qsx, qsy, qsz);
    accumulate_p2plane(acc, p, x, y, z, qsx, qsy, qsz, nx, ny, nz, d, __ldg(w + i));
  }
  reduce_and_finish(acc, red);
}

// Plane from the target's (voxel, octant) tables.
static __global__ void __launch_bounds__(kThreads)
p2plane_from_target_kernel(const float* __restrict__ q,
                           const unsigned char* __restrict__ mask,
                           const float4* __restrict__ packed_ext,
                           const int* __restrict__ oct_table, VoxelIndex index,
                           const float* __restrict__ R, const float* __restrict__ t,
                           const float* __restrict__ gate_ptr, float gate_value, int n,
                           Reduction red) {
  float p[13];
  load_pose(R, t, gate_ptr, gate_value, p);
  const VoxelIndexRegs ix = load_index(index);
  float acc[kEntries];
#pragma unroll
  for (int e = 0; e < kEntries; ++e) acc[e] = 0.f;

  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    const float x = __ldg(q + 3 * i), y = __ldg(q + 3 * i + 1), z = __ldg(q + 3 * i + 2);
    const bool m = __ldg(mask + i) != 0;
    float qsx, qsy, qsz;
    transform_point(p, x, y, z, qsx, qsy, qsz);
    const float ux = (qsx - ix.ox) * ix.inv, uy = (qsy - ix.oy) * ix.inv,
                uz = (qsz - ix.oz) * ix.inv;
    const float fx = floorf(ux), fy = floorf(uy), fz = floorf(uz);
    const int octant = (ux - fx > 0.5f ? 1 : 0) + (uy - fy > 0.5f ? 2 : 0) +
                       (uz - fz > 0.5f ? 4 : 0);
    const int slot = dense_slot(index, ix, static_cast<int>(fx), static_cast<int>(fy),
                                static_cast<int>(fz), m);
    // a miss reads cell 0's entry, as the plain version does; its weight is 0
    const int row = __ldg(oct_table + static_cast<long long>(slot < 0 ? 0 : slot) * 8 + octant);
    const float4* r = packed_ext + static_cast<long long>(row) * 2;
    const float4 plane = __ldg(r);
    const float valid = __ldg(reinterpret_cast<const float*>(r + 1) + 3);
    const float w0 = (slot >= 0 && valid > 0.5f && m) ? 1.f : 0.f;
    accumulate_p2plane(acc, p, x, y, z, qsx, qsy, qsz, plane.x, plane.y, plane.z, plane.w, w0);
  }
  reduce_and_finish(acc, red);
}

}  // namespace loc_fused

extern "C" int p2plane_fused_terms_launch(const void* q, const void* plane, int plane_stride,
                                          const void* w, const void* R, const void* t,
                                          const void* gate_ptr, float gate_value, int n,
                                          int num_blocks, void* partials, void* ticket,
                                          void* out, void* stream) {
  using namespace loc_fused;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Reduction red{static_cast<float*>(partials), static_cast<unsigned int*>(ticket),
                      static_cast<float*>(out)};
  p2plane_kernel<<<num_blocks, kThreads, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(plane), plane_stride,
      static_cast<const float*>(w), static_cast<const float*>(R),
      static_cast<const float*>(t), static_cast<const float*>(gate_ptr), gate_value, n, red);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int p2plane_from_target_launch(const void* q, const void* mask,
                                          const void* packed_ext, const void* oct_table,
                                          const void* table, const void* lo,
                                          const void* origin, const void* inv_leaf, int d0,
                                          int d1, int d2, const void* R, const void* t,
                                          const void* gate_ptr, float gate_value, int n,
                                          int num_blocks, void* partials, void* ticket,
                                          void* out, void* stream) {
  using namespace loc_fused;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Reduction red{static_cast<float*>(partials), static_cast<unsigned int*>(ticket),
                      static_cast<float*>(out)};
  const VoxelIndex index{static_cast<const int*>(table), static_cast<const int*>(lo),
                         static_cast<const float*>(origin),
                         static_cast<const float*>(inv_leaf), d0, d1, d2};
  p2plane_from_target_kernel<<<num_blocks, kThreads, 0, s>>>(
      static_cast<const float*>(q), static_cast<const unsigned char*>(mask),
      static_cast<const float4*>(packed_ext), static_cast<const int*>(oct_table), index,
      static_cast<const float*>(R), static_cast<const float*>(t),
      static_cast<const float*>(gate_ptr), gate_value, n, red);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* loc_fused_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
