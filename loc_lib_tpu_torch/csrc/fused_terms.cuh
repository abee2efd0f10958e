// Shared pieces of the fused linearization kernels (p2plane_fused_terms.cu,
// p2plane_pick_fused_terms.cu, ndt_fused_terms.cu).
//
// Every kernel folds, per source point, transform -> residual -> gate ->
// Jacobian into rows A = [J(6) | r | flag] * w -- one row per point for the
// P2Plane kernels (J = [J_rot | n], r = dis, flag = 1), three rows per
// (point, stencil voxel) for NDT (flag = 1 on the first) -- and reduces the
// symmetric 8x8 G = sum A A^T, from which H = G[:6,:6], b = -G[:6,6],
// chi2 = G[6,6] and count = int(G[7,7]).
//
// Reduction design (deterministic, no float atomics):
//   1. one thread per point in a grid-stride loop accumulates the 36
//      upper-triangle entries of A A^T over its rows in registers;
//   2. warp-shuffle reduce, then a shared-memory reduce across the block's
//      warps, in a fixed order;
//   3. each block writes its 36 partial sums to partials[blockIdx.x][36];
//   4. a second one-block launch (finalize_kernel) sums the partials in
//      block order and writes G (full symmetric 8x8), b and the count.
// The host picks the grid size as a function of N alone, so the summation
// order -- and the result bits -- depend only on N.
//
// The library is compiled with -fmad=false so each product and sum rounds
// separately, as the plain PyTorch versions (ops/kernels.py) evaluate the
// same expressions op by op; the rows, and so the K2 election and every
// gate, then agree bit for bit and only the summation order differs.
#pragma once

#include <cuda_runtime.h>

namespace loc_fused {

constexpr int kThreads = 256;   // threads per block (8 warps)
constexpr int kWarps = kThreads / 32;
constexpr int kEntries = 36;    // upper triangle of the symmetric 8x8 G

// Upper-triangle slot of G[i][j], i <= j, in row-major packing.
__host__ __device__ constexpr int tri_index(int i, int j) {
  return i * 8 - i * (i - 1) / 2 + (j - i);
}

// The pose as the kernels use it: p[0..8] = R row-major, p[9..11] = t,
// p[12] = gate. R, t and a tensor gate are read from device memory where
// the previous GN iteration left them; a gate given as a number arrives by
// value (gate_ptr == nullptr).
__device__ __forceinline__ void load_pose(const float* __restrict__ R,
                                          const float* __restrict__ t,
                                          const float* __restrict__ gate_ptr,
                                          float gate_value, float p[13]) {
#pragma unroll
  for (int k = 0; k < 9; ++k) p[k] = __ldg(R + k);
#pragma unroll
  for (int k = 0; k < 3; ++k) p[9 + k] = __ldg(t + k);
  p[12] = gate_ptr != nullptr ? __ldg(gate_ptr) : gate_value;
}

__device__ __forceinline__ void accumulate_row(float acc[kEntries], const float a[8]) {
  int k = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = i; j < 8; ++j) {
      acc[k] += a[i] * a[j];
      ++k;
    }
  }
}

// Block-wide fixed-order reduction of acc[36]; thread e < 36 of the block
// writes entry e of this block's partial sums.
__device__ __forceinline__ void store_block_partials(float acc[kEntries],
                                                     float* __restrict__ partials) {
  __shared__ float warp_sums[kWarps][kEntries];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int e = 0; e < kEntries; ++e) {
    float v = acc[e];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) warp_sums[warp][e] = v;
  }
  __syncthreads();
  if (threadIdx.x < kEntries) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += warp_sums[w][threadIdx.x];
    partials[blockIdx.x * kEntries + threadIdx.x] = s;
  }
}

// One block of 64 threads: sums the per-block partials in block order and
// writes G (8x8, symmetric), b = -G[:6,6] and count = int(G[7,7]).
// `static`: each translation unit that includes this header gets its own.
static __global__ void __launch_bounds__(64) finalize_kernel(const float* __restrict__ partials,
                                                      int num_blocks,
                                                      float* __restrict__ G,
                                                      float* __restrict__ b,
                                                      int* __restrict__ count) {
  __shared__ float g[kEntries];
  const int e = threadIdx.x;
  if (e < kEntries) {
    float s = 0.f;
    for (int k = 0; k < num_blocks; ++k) s += partials[k * kEntries + e];
    g[e] = s;
  }
  __syncthreads();
  const int i = e / 8, j = e % 8;
  G[e] = g[i <= j ? tri_index(i, j) : tri_index(j, i)];
  if (e < 6) b[e] = -g[tri_index(e, 6)];
  if (e == 0) count[0] = static_cast<int>(g[tri_index(7, 7)]);
}

}  // namespace loc_fused
