// K2: fused election + voxel-plane P2Plane linearization for Hopper (sm_90a),
// with the 7-voxel correspondence gather inside the kernel.
//
// Replaces the TPU kernel `p2plane_pick_fused_terms` /
// `_make_p2plane_pick_kernel` in loc_lib_tpu/ops/pallas_kernels.py
// (entry :185, pallas_call :208, body :123).
//
// Per source point i, over S candidate rows [n(3), d, mu(3), valid]:
//   qs = R q + t
//   election: running minimum of |mu_s - qs|^2 over the valid rows with a
//   STRICT '<', so the first stencil entry wins ties; no valid row keeps
//   the zero plane
//   w' = w * any_valid * [|n . qs + d| <= gate]
// then the K1 row A = [-(R^T n x q), n, dis, 1] * w' and G = sum A A^T
// (fused_terms.cuh). One kernel body, two ways to get the candidates:
//   rows given    rows (N, 7, 8) row-major, w (N,) float: the TPU kernel's
//                 interface at the stencil's S = 7, the one shape its callers
//                 have, for a caller that already holds the rows;
//   from target   the point's voxel floor((qs - origin) * inv_leaf) and its
//                 6 face neighbours (the point's own voxel first), each
//                 looked up in the target's dense slot table and read from
//                 its packed (V, 8) plane table; a candidate counts when
//                 the lookup hits and its row is valid. S = 7, mask (N,)
//                 bool.
// The TPU kernel left the gather outside because Pallas on the TPU could not
// express a data-dependent row read; a CUDA thread reads the rows it wants.
// With the gather inside, the (N, 7, 8) row tensor is never written to
// device memory (1.8 MB written and read back per Gauss-Newton iteration at
// N = 8192) and the ~50 small launches that built it leave the iteration.
//
// What bounds it on this card: bytes, and few of them. From the target at
// N = 8192 a call must read 8192 x 13 B of points and mask plus each table
// cell (4 B) and plane row (32 B) its stencils touch: 530 KB on a
// 65,536-point map (neighbouring points share voxels), 0.16 us of HBM time
// at 3.35 TB/s, and never more than 8192 x 7 x 36 B = 2.1 MB. With the rows
// given it reads 8192 x 240 B = 2.0 MB, 0.59 us. The arithmetic (~200
// float32 operations a point) is three orders below the 67 TFLOP/s line.
// The kernel runs 6-7 us: the tables (16 MB of slots, 2 MB of rows) stay in
// the 50 MB L2 between iterations, which is what the design leans on, and
// what a call costs is latency: the launch, a chain of dependent loads
// (pose, point, slot, row) and the reduction's tail.
// What the design does about that: S = 7 is a compile-time constant, so the
// 7 slot reads are issued together, then the 14 16-byte row reads, then the
// 7-way select chain runs in registers (measured 1.0 us faster than a loop
// over a runtime S with the rows given; a point spread over 8 lanes with a
// shuffle election measured slower, 10.8 us against 6.6, and is not kept);
// every read is unconditional (cell 0 or row 0 for a rejected candidate) so
// none waits for another's test; 128 threads a block fill 64 SMs at
// N = 8192 where 256 filled 32; one launch (the last block to finish
// reduces, fused_terms.cuh: 1.5 us faster than two). R, t and the gate are
// read from the device tensors the previous GN iteration wrote.
#include <math_constants.h>

#include "fused_terms.cuh"

namespace loc_fused {

constexpr int kStencil = 7;   // candidates a point: its voxel and 6 face neighbours

// Candidate s of a point: plane = [n, d], cen = [mu, valid].
struct Candidate {
  float4 plane, cen;
};

// Election over the candidates and the point's row. The count is a
// compile-time constant, so every loop unrolls and the loads overlap.
__device__ __forceinline__ void elect_and_accumulate(float acc[kEntries], const float p[13],
                                                     float x, float y, float z, float qsx,
                                                     float qsy, float qsz,
                                                     const Candidate (&c)[kStencil], float w0) {
  float best_d2 = CUDART_INF_F;
  float nx = 0.f, ny = 0.f, nz = 0.f, d = 0.f;
  float any_valid = 0.f;
#pragma unroll
  for (int s = 0; s < kStencil; ++s) {
    const float dx = c[s].cen.x - qsx, dy = c[s].cen.y - qsy, dz = c[s].cen.z - qsz;
    const float d2 = c[s].cen.w > 0.5f ? dx * dx + dy * dy + dz * dz : CUDART_INF_F;
    if (d2 < best_d2) {                         // strict: first entry wins ties
      best_d2 = d2;
      nx = c[s].plane.x; ny = c[s].plane.y; nz = c[s].plane.z; d = c[s].plane.w;
    }
    any_valid = fmaxf(any_valid, c[s].cen.w);
  }
  accumulate_p2plane(acc, p, x, y, z, qsx, qsy, qsz, nx, ny, nz, d, w0 * any_valid);
}

// Rows given.
static __global__ void __launch_bounds__(kThreads)
pick_rows_kernel(const float* __restrict__ q, const float4* __restrict__ rows,
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
    float qsx, qsy, qsz;
    transform_point(p, x, y, z, qsx, qsy, qsz);
    const float4* r = rows + static_cast<long long>(i) * kStencil * 2;
    Candidate c[kStencil];
#pragma unroll
    for (int s = 0; s < kStencil; ++s) {
      c[s].plane = __ldg(r + 2 * s);
      c[s].cen = __ldg(r + 2 * s + 1);
    }
    elect_and_accumulate(acc, p, x, y, z, qsx, qsy, qsz, c, __ldg(w + i));
  }
  reduce_and_finish(acc, red);
}

// Rows from the target: the 7-voxel gather inside the kernel.
static __global__ void __launch_bounds__(kThreads)
pick_from_target_kernel(const float* __restrict__ q, const unsigned char* __restrict__ mask,
                        const float4* __restrict__ packed, VoxelIndex index,
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
    // the point's voxel: floor((qs - origin) * inv_leaf), as voxel_coords
    const int cx = static_cast<int>(floorf((qsx - ix.ox) * ix.inv));
    const int cy = static_cast<int>(floorf((qsy - ix.oy) * ix.inv));
    const int cz = static_cast<int>(floorf((qsz - ix.oz) * ix.inv));
    // the point's own voxel, then its 6 face neighbours, in the order of
    // ops/voxel.py _NEARBY6 (ties in the election go to the first);
    // wrapping sums, as int32 tensors add
    const auto look = [&](int dx, int dy, int dz) {
      return dense_slot(index, ix,
                        static_cast<int>(static_cast<unsigned>(cx) + static_cast<unsigned>(dx)),
                        static_cast<int>(static_cast<unsigned>(cy) + static_cast<unsigned>(dy)),
                        static_cast<int>(static_cast<unsigned>(cz) + static_cast<unsigned>(dz)),
                        m);
    };
    const int slot[kStencil] = {look(0, 0, 0), look(-1, 0, 0), look(1, 0, 0), look(0, 1, 0),
                         look(0, -1, 0), look(0, 0, -1), look(0, 0, 1)};
    Candidate c[kStencil];
#pragma unroll
    for (int s = 0; s < kStencil; ++s) {
      const float4* r = packed + static_cast<long long>(slot[s] < 0 ? 0 : slot[s]) * 2;
      c[s].plane = __ldg(r);
      c[s].cen = __ldg(r + 1);
      c[s].cen.w = (slot[s] >= 0 && c[s].cen.w > 0.5f) ? 1.f : 0.f;
    }
    elect_and_accumulate(acc, p, x, y, z, qsx, qsy, qsz, c, m ? 1.f : 0.f);
  }
  reduce_and_finish(acc, red);
}

}  // namespace loc_fused

extern "C" int p2plane_pick_fused_terms_launch(const void* q, const void* rows,
                                               const void* w, const void* R, const void* t,
                                               const void* gate_ptr, float gate_value, int n,
                                               int num_blocks, void* partials, void* ticket,
                                               void* out, void* stream) {
  using namespace loc_fused;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Reduction red{static_cast<float*>(partials), static_cast<unsigned int*>(ticket),
                      static_cast<float*>(out)};
  pick_rows_kernel<<<num_blocks, kThreads, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float4*>(rows),
      static_cast<const float*>(w), static_cast<const float*>(R), static_cast<const float*>(t),
      static_cast<const float*>(gate_ptr), gate_value, n, red);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int p2plane_pick_from_target_launch(const void* q, const void* mask,
                                               const void* packed, const void* table,
                                               const void* lo, const void* origin,
                                               const void* inv_leaf, int d0, int d1, int d2,
                                               const void* R, const void* t,
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
  pick_from_target_kernel<<<num_blocks, kThreads, 0, s>>>(
      static_cast<const float*>(q), static_cast<const unsigned char*>(mask),
      static_cast<const float4*>(packed), index, static_cast<const float*>(R),
      static_cast<const float*>(t), static_cast<const float*>(gate_ptr), gate_value, n, red);
  return static_cast<int>(cudaGetLastError());
}
