// K3: fused generalized-Gaussian (NDT) linearization for Hopper (sm_90a).
//
// Replaces the TPU kernel `ndt_fused_terms` / `_make_ndt_kernel` in
// loc_lib_tpu/ops/pallas_kernels.py (entry :314, pallas_call :337, body
// :232).
//
// Per source point i and stencil voxel s (q, qs (N,3); mu (N,S,3) and
// W (N,S,9) row-major with info = W W^T, valid (N,S), each with its own
// point and stencil strides so they can be views of the gathered (N,S,13)
// packed rows):
//   e = qs - mu,  z = W^T e,  res = |z|^2,  w = valid * [res <= th]
// and three rows i = 0, 1, 2
//   weighted  (incremental NDT):  M = W^T R, B_t = W^T, r = z
//   direct    (direct NDT):       M = R,     B_t = I,   r = e
//   A_i = w * [m2 y - m1 z, m0 z - m2 x, m1 x - m0 y | B_t,i | r_i | flag_i]
// with (m0, m1, m2) row i of M and flag_i = 1 on row 0 only, so the count
// counts residuals. G = sum A A^T (fused_terms.cuh). `t` is not needed:
// qs arrives computed, as in the TPU kernel.
//
// What bounds it on this card: bytes. At the path's N = 8192, S = 7 it reads
// 8192 * (24 + 7 * 52) B ~ 3.2 MB of rows the gather just wrote (L2
// resident), 0.95 us of HBM time at 3.35 TB/s, and does 21 row updates of
// 36 products per point -- about 12 MFLOP, 0.2 us at 67 TFLOP/s. What a
// call costs is launch latency and each thread's serial walk over its S
// voxels.
// What the design does about that: one thread per point runs the S x 3
// rows in registers into the same 36-entry accumulator and one-launch
// deterministic reduction as K1 and K2 (fused_terms.cuh); `weighted` is a
// template parameter, so each mode is its own straight-line code. This is
// the simple correct version: its stencil gather still lies outside (it
// reads gathered rows, as the TPU kernel does), loads are scalar (the
// 13-float packed rows are not 16-byte aligned) and nothing is staged in
// shared memory.
#include "fused_terms.cuh"

namespace loc_fused {

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
      const float e[3] = {qsx - __ldg(m), qsy - __ldg(m + 1), qsz - __ldg(m + 2)};
      float Wm[9];                                  // Wm[3 k + j] = W[k][j]
#pragma unroll
      for (int k = 0; k < 9; ++k) Wm[k] = __ldg(f + k);
      float zr[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) zr[c] = Wm[c] * e[0] + Wm[3 + c] * e[1] + Wm[6 + c] * e[2];
      const float res = zr[0] * zr[0] + zr[1] * zr[1] + zr[2] * zr[2];
      const float w = __ldg(valid + static_cast<long long>(i) * v_sn +
                            static_cast<long long>(s) * v_ss) *
                      (res <= th ? 1.f : 0.f);
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
  }
  reduce_and_finish(acc, red);
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
