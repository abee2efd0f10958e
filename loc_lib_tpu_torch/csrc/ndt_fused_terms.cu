// K3: fused generalized-Gaussian (NDT) linearization for Hopper (sm_90a),
// with the stencil gather (NDT) and the nearest-line election (p2line_vox)
// inside the kernel.
//
// Replaces the TPU kernel `ndt_fused_terms` / `_make_ndt_kernel` in
// loc_lib_tpu/ops/pallas_kernels.py (entry :314, pallas_call :337, body
// :232).
//
// Per source point and voxel, from the voxel's row [mu(3), W(9) row-major
// with info = W W^T, est]:
//   e = qs - mu,  z = W^T e,  res = |z|^2,  w = valid * [res <= th]
// and three rows i = 0, 1, 2
//   weighted  (incremental NDT, p2line_vox):  M = W^T R, B_t = W^T, r = z
//   direct    (direct NDT):                   M = R,     B_t = I,   r = e
//   A_i = w * [m2 y - m1 z, m0 z - m2 x, m1 x - m0 y | B_t,i | r_i | flag_i]
// with (m0, m1, m2) row i of M and flag_i = 1 on row 0 only, so the count
// counts residuals. G = sum A A^T (fused_terms.cuh). One arithmetic
// (accumulate_ndt), three ways to get the voxels:
//   rows given    q, qs (N,3); mu (N,S,3), W (N,S,9), valid (N,S), each with
//                 its own point and stencil strides (views of gathered
//                 (N,S,13) rows): the TPU kernel's interface, any S, for a
//                 caller that already holds the rows;
//   from the map  qs = R q + t, the point's voxel trunc or floor((qs -
//                 origin) * inv_leaf), then that voxel alone (S = 1) or with
//                 its 6 face neighbours (S = 7), each looked up in the map's
//                 dense slot table and read from its packed (V, 13) table;
//                 a voxel counts when the lookup hits and its row is
//                 estimated. What ndt.scan_match runs;
//   p2line        floor binning, S = 7 lookups, then the election: running
//                 minimum of |mu_s - qs|^2 over the valid candidates with a
//                 STRICT '<' (the point's own voxel first, so it wins ties),
//                 then the weighted rows of the ONE elected voxel with
//                 valid = any_valid & mask, gated at th = gate^2. What
//                 icp's p2line_vox (LOAM's edge term) runs.
// The TPU kernel left the gather outside because Pallas on the TPU could not
// express a data-dependent row read. With it inside, the (N, S, 13) row
// tensor (3.0 MB at N = 8192, S = 7) is never written and read back, and the
// ~50 small launches that built it (and p2line's argmin and take_along_dim)
// leave the Gauss-Newton iteration: one linearization is one launch.
//
// What bounds it on this card: bytes, and few of them. From the map at
// N = 8192, S = 7 a call must read 8192 x 13 B of points and mask plus each
// distinct table cell (4 B) and row (52 B) its stencils touch: 696 KB on a
// 65,536-point map (neighbouring points share voxels), 0.21 us of HBM time
// at 3.35 TB/s; the arithmetic, 337 float32 operations a valid (point,
// voxel) pair, is 0.19 us at 67 TFLOP/s. The kernel runs 9.7 us (5.9 us in
// p2line mode, 5.7 us at S = 1; NVIDIA H100 80GB HBM3, 700 W): the tables
// (16.8 MB of slots, 3.4 MB of rows) stay in the 50 MB L2 between
// iterations, and what a call costs is latency: the launch, a chain of
// dependent loads (pose, point, slot, row), one thread's serial arithmetic
// over its S voxels, and the reduction's tail.
// What the design does about that: S, `weighted` and the binning are
// template parameters, so each of the eight from-the-map bodies is
// straight-line code: the S slot reads go out together, then all S row
// reads, then the rows' arithmetic runs in registers. Every read is
// unconditional (cell 0 / row 0 for a rejected voxel), so none waits for
// another's test. The election reads only the 3 centroid floats and the flag
// of each candidate, then the winner's 9 W floats: the losers' W is never
// read. Rows stay 13 floats (52 B, scalar loads): rows padded to 16 floats
// and read as four float4 measured 0.4 us slower for S = 7 weighted, 0.7 us
// faster for S = 7 direct and within 0.2 us elsewhere, so the layout the
// maps already have is kept. No body spills (ptxas, sm_90a: 127 registers
// for S = 7 weighted, 96 for S = 7 direct, S = 1 weighted and p2line, 80
// for S = 1 direct). 128 threads a block, one launch, the deterministic
// reduction of fused_terms.cuh; R and t are read from the device tensors
// the previous GN iteration wrote, the threshold arrives by value. The sums
// run in the rows-given kernel's order (point, then s, then row), so from
// the map and gather + rows given agree bit for bit.
#include <math_constants.h>

#include "fused_terms.cuh"

namespace loc_fused {

constexpr int kRow = 13;   // floats a packed row: mu(3) | W(9) | est

// The three rows of one (point, voxel) pair, added to acc. r = R row-major,
// Wm[3 k + j] = W[k][j].
template <bool kWeighted>
__device__ __forceinline__ void accumulate_ndt(float acc[kEntries], const float r[9], float x,
                                               float y, float z, float qsx, float qsy,
                                               float qsz, const float mu[3], const float Wm[9],
                                               float valid, float th) {
  const float e[3] = {qsx - mu[0], qsy - mu[1], qsz - mu[2]};
  float zr[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) zr[c] = Wm[c] * e[0] + Wm[3 + c] * e[1] + Wm[6 + c] * e[2];
  const float res = zr[0] * zr[0] + zr[1] * zr[1] + zr[2] * zr[2];
  const float w = valid * (res <= th ? 1.f : 0.f);
#pragma unroll
  for (int row = 0; row < 3; ++row) {
    float m0, m1, m2, bt[3], rr;
    if (kWeighted) {
      m0 = Wm[row] * r[0] + Wm[3 + row] * r[3] + Wm[6 + row] * r[6];
      m1 = Wm[row] * r[1] + Wm[3 + row] * r[4] + Wm[6 + row] * r[7];
      m2 = Wm[row] * r[2] + Wm[3 + row] * r[5] + Wm[6 + row] * r[8];
      bt[0] = Wm[row];
      bt[1] = Wm[3 + row];
      bt[2] = Wm[6 + row];
      rr = zr[row];
    } else {
      m0 = r[3 * row];
      m1 = r[3 * row + 1];
      m2 = r[3 * row + 2];
      bt[0] = row == 0 ? 1.f : 0.f;
      bt[1] = row == 1 ? 1.f : 0.f;
      bt[2] = row == 2 ? 1.f : 0.f;
      rr = e[row];
    }
    const float a[8] = {(m2 * y - m1 * z) * w, (m0 * z - m2 * x) * w,
                        (m1 * x - m0 * y) * w, bt[0] * w, bt[1] * w, bt[2] * w,
                        rr * w, row == 0 ? 1.f * w : 0.f * w};
    accumulate_row(acc, a);
  }
}

// Rows given.
template <bool kWeighted>
static __global__ void __launch_bounds__(kThreads)
ndt_fused_kernel(const float* __restrict__ q, const float* __restrict__ qs,
                 const float* __restrict__ mu, int mu_sn, int mu_ss,
                 const float* __restrict__ W, int w_sn, int w_ss,
                 const float* __restrict__ valid, int v_sn, int v_ss, int S,
                 const float* __restrict__ R, float th, int n, Reduction red) {
  float r[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) r[k] = __ldg(R + k);

  float acc[kEntries];
#pragma unroll
  for (int e = 0; e < kEntries; ++e) acc[e] = 0.f;

  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    const float x = __ldg(q + 3 * i), y = __ldg(q + 3 * i + 1), z = __ldg(q + 3 * i + 2);
    const float qsx = __ldg(qs + 3 * i), qsy = __ldg(qs + 3 * i + 1), qsz = __ldg(qs + 3 * i + 2);
    for (int s = 0; s < S; ++s) {
      const float* m = mu + static_cast<long long>(i) * mu_sn + static_cast<long long>(s) * mu_ss;
      const float* f = W + static_cast<long long>(i) * w_sn + static_cast<long long>(s) * w_ss;
      const float mus[3] = {__ldg(m), __ldg(m + 1), __ldg(m + 2)};
      float Wm[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) Wm[k] = __ldg(f + k);
      const float v = __ldg(valid + static_cast<long long>(i) * v_sn +
                            static_cast<long long>(s) * v_ss);
      accumulate_ndt<kWeighted>(acc, r, x, y, z, qsx, qsy, qsz, mus, Wm, v, th);
    }
  }
  reduce_and_finish(acc, red);
}

// What a kernel that finds its own voxels is given.
struct FromMap {
  const float* q;               // (N, 3) body points
  const unsigned char* mask;    // (N,) bool
  const float* packed;          // (V, 13) rows [mu, W, est]
  VoxelIndex index;
  const float* R;
  const float* t;
  float th;
  int n;
  Reduction red;
};

// Rows from the map: the stencil gather inside the kernel.
template <bool kWeighted, int kS, bool kTrunc>
static __global__ void __launch_bounds__(kThreads) ndt_from_map_kernel(FromMap a) {
  static_assert(kS == 1 || kS == kStencil, "the centre voxel alone, or with its 6 neighbours");
  float p[13];
  load_pose(a.R, a.t, nullptr, a.th, p);
  const VoxelIndexRegs ix = load_index(a.index);
  float acc[kEntries];
#pragma unroll
  for (int e = 0; e < kEntries; ++e) acc[e] = 0.f;

  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < a.n; i += gridDim.x * blockDim.x) {
    const float x = __ldg(a.q + 3 * i), y = __ldg(a.q + 3 * i + 1), z = __ldg(a.q + 3 * i + 2);
    const bool m = __ldg(a.mask + i) != 0;
    float qsx, qsy, qsz;
    transform_point(p, x, y, z, qsx, qsy, qsz);
    const int cx = voxel_coord<kTrunc>((qsx - ix.ox) * ix.inv);
    const int cy = voxel_coord<kTrunc>((qsy - ix.oy) * ix.inv);
    const int cz = voxel_coord<kTrunc>((qsz - ix.oz) * ix.inv);
    int slot[kStencil];
    if (kS == 1) {
      slot[0] = dense_slot(a.index, ix, cx, cy, cz, m);
    } else {
      stencil_slots(a.index, ix, cx, cy, cz, m, slot);
    }
    float row[kS][kRow];
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      const float* f = a.packed + static_cast<long long>(slot[s] < 0 ? 0 : slot[s]) * kRow;
#pragma unroll
      for (int k = 0; k < kRow; ++k) row[s][k] = __ldg(f + k);
    }
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      const float v = (slot[s] >= 0 && row[s][12] > 0.5f) ? 1.f : 0.f;
      accumulate_ndt<kWeighted>(acc, p, x, y, z, qsx, qsy, qsz, row[s], row[s] + 3, v, a.th);
    }
  }
  reduce_and_finish(acc, a.red);
}

// p2line_vox: 7 lookups, the nearest-valid-centroid election, then the
// weighted rows of the elected voxel.
static __global__ void __launch_bounds__(kThreads) p2line_from_target_kernel(FromMap a) {
  float p[13];
  load_pose(a.R, a.t, nullptr, a.th, p);
  const VoxelIndexRegs ix = load_index(a.index);
  float acc[kEntries];
#pragma unroll
  for (int e = 0; e < kEntries; ++e) acc[e] = 0.f;

  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < a.n; i += gridDim.x * blockDim.x) {
    const float x = __ldg(a.q + 3 * i), y = __ldg(a.q + 3 * i + 1), z = __ldg(a.q + 3 * i + 2);
    const bool m = __ldg(a.mask + i) != 0;
    float qsx, qsy, qsz;
    transform_point(p, x, y, z, qsx, qsy, qsz);
    int slot[kStencil];
    stencil_slots(a.index, ix, voxel_coord<false>((qsx - ix.ox) * ix.inv),
                  voxel_coord<false>((qsy - ix.oy) * ix.inv),
                  voxel_coord<false>((qsz - ix.oz) * ix.inv), m, slot);
    float cen[kStencil][4];                       // mu, est
#pragma unroll
    for (int s = 0; s < kStencil; ++s) {
      const float* f = a.packed + static_cast<long long>(slot[s] < 0 ? 0 : slot[s]) * kRow;
      cen[s][0] = __ldg(f);
      cen[s][1] = __ldg(f + 1);
      cen[s][2] = __ldg(f + 2);
      cen[s][3] = __ldg(f + 12);
    }
    // no valid candidate keeps candidate 0 (its row, or row 0 on a miss)
    float best_d2 = CUDART_INF_F;
    int best = slot[0] < 0 ? 0 : slot[0];
    float mu[3] = {cen[0][0], cen[0][1], cen[0][2]};
    bool any_valid = false;
#pragma unroll
    for (int s = 0; s < kStencil; ++s) {
      const bool v = slot[s] >= 0 && cen[s][3] > 0.5f;
      const float dx = cen[s][0] - qsx, dy = cen[s][1] - qsy, dz = cen[s][2] - qsz;
      const float d2 = v ? dx * dx + dy * dy + dz * dz : CUDART_INF_F;
      if (d2 < best_d2) {                         // strict: first entry wins ties
        best_d2 = d2;
        best = slot[s];
        mu[0] = cen[s][0]; mu[1] = cen[s][1]; mu[2] = cen[s][2];
      }
      any_valid = any_valid || v;
    }
    const float* f = a.packed + static_cast<long long>(best) * kRow + 3;
    float Wm[9];                                  // the winner's W: the losers' is never read
#pragma unroll
    for (int k = 0; k < 9; ++k) Wm[k] = __ldg(f + k);
    accumulate_ndt<true>(acc, p, x, y, z, qsx, qsy, qsz, mu, Wm, (any_valid && m) ? 1.f : 0.f,
                         a.th);
  }
  reduce_and_finish(acc, a.red);
}

template <bool kWeighted, int kS>
static void launch_from_map(bool trunc, const FromMap& a, int num_blocks, cudaStream_t s) {
  if (trunc) {
    ndt_from_map_kernel<kWeighted, kS, true><<<num_blocks, kThreads, 0, s>>>(a);
  } else {
    ndt_from_map_kernel<kWeighted, kS, false><<<num_blocks, kThreads, 0, s>>>(a);
  }
}

static FromMap from_map_args(const void* q, const void* mask, const void* packed,
                             const void* table, const void* lo, const void* origin,
                             const void* inv_leaf, int d0, int d1, int d2, const void* R,
                             const void* t, float th, int n, void* partials, void* ticket,
                             void* out) {
  return FromMap{static_cast<const float*>(q), static_cast<const unsigned char*>(mask),
                 static_cast<const float*>(packed),
                 VoxelIndex{static_cast<const int*>(table), static_cast<const int*>(lo),
                            static_cast<const float*>(origin),
                            static_cast<const float*>(inv_leaf), d0, d1, d2},
                 static_cast<const float*>(R), static_cast<const float*>(t), th, n,
                 Reduction{static_cast<float*>(partials), static_cast<unsigned int*>(ticket),
                           static_cast<float*>(out)}};
}

}  // namespace loc_fused

extern "C" int ndt_fused_terms_launch(const void* q, const void* qs, const void* mu, int mu_sn,
                                      int mu_ss, const void* W, int w_sn, int w_ss,
                                      const void* valid, int v_sn, int v_ss, int S,
                                      const void* R, float th, int weighted, int n,
                                      int num_blocks, void* partials, void* ticket, void* out,
                                      void* stream) {
  using namespace loc_fused;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Reduction red{static_cast<float*>(partials), static_cast<unsigned int*>(ticket),
                      static_cast<float*>(out)};
  const float* qf = static_cast<const float*>(q);
  const float* qsf = static_cast<const float*>(qs);
  const float* muf = static_cast<const float*>(mu);
  const float* Wf = static_cast<const float*>(W);
  const float* vf = static_cast<const float*>(valid);
  const float* Rf = static_cast<const float*>(R);
  if (weighted) {
    ndt_fused_kernel<true><<<num_blocks, kThreads, 0, s>>>(
        qf, qsf, muf, mu_sn, mu_ss, Wf, w_sn, w_ss, vf, v_sn, v_ss, S, Rf, th, n, red);
  } else {
    ndt_fused_kernel<false><<<num_blocks, kThreads, 0, s>>>(
        qf, qsf, muf, mu_sn, mu_ss, Wf, w_sn, w_ss, vf, v_sn, v_ss, S, Rf, th, n, red);
  }
  return static_cast<int>(cudaGetLastError());
}

// S is 1 or 7; anything else is refused before a launch.
extern "C" int ndt_from_map_launch(const void* q, const void* mask, const void* packed,
                                   const void* table, const void* lo, const void* origin,
                                   const void* inv_leaf, int d0, int d1, int d2, const void* R,
                                   const void* t, float th, int weighted, int S, int trunc,
                                   int n, int num_blocks, void* partials, void* ticket,
                                   void* out, void* stream) {
  using namespace loc_fused;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const FromMap a = from_map_args(q, mask, packed, table, lo, origin, inv_leaf, d0, d1, d2, R,
                                  t, th, n, partials, ticket, out);
  if (S == kStencil && weighted) {
    launch_from_map<true, kStencil>(trunc != 0, a, num_blocks, s);
  } else if (S == kStencil) {
    launch_from_map<false, kStencil>(trunc != 0, a, num_blocks, s);
  } else if (S == 1 && weighted) {
    launch_from_map<true, 1>(trunc != 0, a, num_blocks, s);
  } else if (S == 1) {
    launch_from_map<false, 1>(trunc != 0, a, num_blocks, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int p2line_from_target_launch(const void* q, const void* mask, const void* packed,
                                         const void* table, const void* lo, const void* origin,
                                         const void* inv_leaf, int d0, int d1, int d2,
                                         const void* R, const void* t, float th, int n,
                                         int num_blocks, void* partials, void* ticket, void* out,
                                         void* stream) {
  using namespace loc_fused;
  const FromMap a = from_map_args(q, mask, packed, table, lo, origin, inv_leaf, d0, d1, d2, R,
                                  t, th, n, partials, ticket, out);
  p2line_from_target_kernel<<<num_blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
