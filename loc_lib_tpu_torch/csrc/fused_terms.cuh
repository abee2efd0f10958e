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
// What bounds these kernels on an H100: a call moves 0.1-3 MB and does a few
// MFLOP, under a microsecond of HBM time at 3.35 TB/s and nothing for the
// ALUs. What a call costs is latency: the launch, each thread's chain of
// dependent loads, and the tail of the cross-block reduction. So the design
// is one launch with a short tail.
//
// Reduction (deterministic, no float atomics, ONE launch):
//   1. one thread per point in a grid-stride loop accumulates the 36
//      upper-triangle entries of A A^T over its rows in registers;
//   2. warp-shuffle reduce, then a shared-memory reduce across the block's
//      warps, in a fixed order;
//   3. each block writes its 36 partial sums to partials[blockIdx.x][36],
//      fences, and draws a ticket with an integer atomicInc;
//   4. the block that draws the last ticket sums all partials IN BLOCK-INDEX
//      ORDER (read past L1 with __ldcg, after a fence) and writes the
//      outputs. atomicInc wraps the ticket back to 0 on the last draw, so
//      the scratch is ready for the next call without a host-side reset.
// Which block finishes last varies from run to run; the order of the sum
// does not. The host picks the grid size as a function of N alone, so the
// summation order -- and the result bits -- depend only on N.
// Scratch (partials + ticket) belongs to one stream: calls on one stream are
// ordered, two streams need two scratch buffers (ops/kernels.py keeps one per
// device and stream).
//
// float32 throughout, no TF32 and no tensor cores: an 8-wide Gram sum in
// full float32 fills no MMA tile. TMA and wgmma have nothing to carry here
// (no tile is reused; every point reads its own few rows once).
//
// The library is compiled with -fmad=false so each product and sum rounds
// separately, as the plain PyTorch versions (ops/kernels.py) evaluate the
// same expressions op by op; the rows, and so the K2 election, the voxel a
// point falls in and every gate, then agree bit for bit and only the
// summation order differs.
#pragma once

#include <cuda_runtime.h>

namespace loc_fused {

constexpr int kThreads = 128;   // threads per block (THREADS in ops/kernels.py)
constexpr int kWarps = kThreads / 32;
constexpr int kEntries = 36;    // upper triangle of the symmetric 8x8 G
constexpr int kOutWords = 44;   // H (36, row-major 6x6) | b (6) | chi2 | count (int bits)
static_assert(kThreads >= 64 && kThreads % 32 == 0, "a block holds at least 2 warps");

// Upper-triangle slot of G[i][j], i <= j, in row-major packing.
__host__ __device__ constexpr int tri_index(int i, int j) {
  return i * 8 - i * (i - 1) / 2 + (j - i);
}

// Where a call leaves its results and keeps its scratch.
struct Reduction {
  float* partials;        // [gridDim.x][36], scratch
  unsigned int* ticket;   // 0 between calls, scratch
  float* out;             // kOutWords words
};

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

// qs = R q + t, each product and sum rounded on its own.
__device__ __forceinline__ void transform_point(const float p[13], float x, float y, float z,
                                                float& qsx, float& qsy, float& qsz) {
  qsx = p[0] * x + p[1] * y + p[2] * z + p[9];
  qsy = p[3] * x + p[4] * y + p[5] * z + p[10];
  qsz = p[6] * x + p[7] * y + p[8] * z + p[11];
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

// The P2Plane row of one point, A = [-(R^T n x q), n, dis, 1] * w with
// dis = n . qs + d and w = w0 * [|dis| <= gate], added to acc.
__device__ __forceinline__ void accumulate_p2plane(float acc[kEntries], const float p[13],
                                                   float x, float y, float z, float qsx,
                                                   float qsy, float qsz, float nx, float ny,
                                                   float nz, float d, float w0) {
  const float dis = nx * qsx + ny * qsy + nz * qsz + d;
  const float wi = w0 * (fabsf(dis) <= p[12] ? 1.f : 0.f);
  const float rnx = p[0] * nx + p[3] * ny + p[6] * nz;
  const float rny = p[1] * nx + p[4] * ny + p[7] * nz;
  const float rnz = p[2] * nx + p[5] * ny + p[8] * nz;
  const float a[8] = {-(rny * z - rnz * y) * wi, -(rnz * x - rnx * z) * wi,
                      -(rnx * y - rny * x) * wi, nx * wi, ny * wi, nz * wi,
                      dis * wi, wi};
  accumulate_row(acc, a);
}

// A voxel table as the kernels read it: the dense int32 slot table over
// dims cells anchored at lo (voxel coords), and the grid's origin and
// 1 / leaf. lo, origin and inv_leaf are read from the device tensors.
struct VoxelIndex {
  const int* table;
  const int* lo;
  const float* origin;
  const float* inv_leaf;
  int d0, d1, d2;
};

// The index, loaded into registers once per thread.
struct VoxelIndexRegs {
  float ox, oy, oz, inv;
  int lox, loy, loz;
};

__device__ __forceinline__ VoxelIndexRegs load_index(const VoxelIndex& v) {
  VoxelIndexRegs r;
  r.ox = __ldg(v.origin); r.oy = __ldg(v.origin + 1); r.oz = __ldg(v.origin + 2);
  r.inv = __ldg(v.inv_leaf);
  r.lox = __ldg(v.lo); r.loy = __ldg(v.lo + 1); r.loz = __ldg(v.lo + 2);
  return r;
}

// Slot of voxel (cx, cy, cz) in the dense table, -1 where the cell lies
// outside the +-512-cell key window, outside the table's dims, or `valid`
// is false. The table is always read (cell 0 for a rejected voxel, as the
// plain version's lookup does), so the loads of a point's candidates do
// not wait for each other's tests. Unsigned sums: a coordinate saturated by
// the float-to-int cast wraps, as int32 tensors do, and is rejected.
__device__ __forceinline__ int dense_slot(const VoxelIndex& v, const VoxelIndexRegs& r,
                                          int cx, int cy, int cz, bool valid) {
  const bool in_window = static_cast<unsigned>(cx) + 512u < 1024u &&
                         static_cast<unsigned>(cy) + 512u < 1024u &&
                         static_cast<unsigned>(cz) + 512u < 1024u;
  // wrapping differences: small when in_window, never read otherwise
  const int rx = static_cast<int>(static_cast<unsigned>(cx) - static_cast<unsigned>(r.lox));
  const int ry = static_cast<int>(static_cast<unsigned>(cy) - static_cast<unsigned>(r.loy));
  const int rz = static_cast<int>(static_cast<unsigned>(cz) - static_cast<unsigned>(r.loz));
  const bool ok = valid && in_window && rx >= 0 && rx < v.d0 && ry >= 0 && ry < v.d1 &&
                  rz >= 0 && rz < v.d2;
  const int flat = ok ? (rx * v.d1 + ry) * v.d2 + rz : 0;
  const int slot = __ldg(v.table + flat);
  return ok ? slot : -1;
}

// Writes the outputs from the 36 summed entries g (shared memory): threads
// e < kOutWords of the block each write one word.
__device__ __forceinline__ void write_outputs(const float* g, float* __restrict__ out) {
  const int e = threadIdx.x;
  if (e < 36) {
    const int i = e / 6, j = e % 6;
    out[e] = g[i <= j ? tri_index(i, j) : tri_index(j, i)];
  } else if (e < 42) {
    out[e] = -g[tri_index(e - 36, 6)];
  } else if (e == 42) {
    out[e] = g[tri_index(6, 6)];
  } else if (e == 43) {
    reinterpret_cast<int*>(out)[e] = static_cast<int>(g[tri_index(7, 7)]);
  }
}

// Sums the per-block partials in block order into g and writes the outputs.
// Called by one whole block.
__device__ __forceinline__ void sum_partials_and_write(const float* partials, int num_blocks,
                                                       float* __restrict__ out) {
  __shared__ float g[kEntries];
  const int e = threadIdx.x;
  if (e < kEntries) {
    float s = 0.f;
    for (int k = 0; k < num_blocks; ++k) s += __ldcg(partials + k * kEntries + e);
    g[e] = s;
  }
  __syncthreads();
  write_outputs(g, out);
}

// Block-wide fixed-order reduction of acc[36] into this block's partial
// sums; then the last block to arrive reduces all partials (see the top).
// Every thread of the block must call it.
__device__ __forceinline__ void reduce_and_finish(float acc[kEntries], const Reduction& red) {
  __shared__ float warp_sums[kWarps][kEntries];
  __shared__ bool is_last;
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
    red.partials[blockIdx.x * kEntries + threadIdx.x] = s;
    __threadfence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    // old value counts 0 .. gridDim.x - 1; the last draw wraps the ticket to 0
    is_last = atomicInc(red.ticket, gridDim.x - 1) == gridDim.x - 1;
  }
  __syncthreads();
  if (is_last) {
    __threadfence();
    sum_partials_and_write(red.partials, gridDim.x, red.out);
  }
}

}  // namespace loc_fused
