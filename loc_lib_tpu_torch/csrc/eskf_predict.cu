// The ESKF's IMU propagation through one padded IMU packet, for Hopper
// (sm_90a): ONE launch of one block for the whole packet.
//
// Replaces the reference's `predict_scan` (loc_lib_tpu/models/eskf.py: a
// `lax.scan` of `predict` with a keep/skip select per sample, which XLA
// fuses into one program). As torch ops a sample is ~100 launches (two
// so3_exp, hat, the F block writes, two 18x18 products) and a scan's packet
// about 1,000: the first cost of a LIO / Loc step, on a path bound by
// launches. Here the packet's K samples run in order inside one block:
//
//   per sample k with valid[k]:
//     dt = stamp[k] - time;  time = stamp[k]
//     if 0 <= dt <= max_dt (the dt gate; a gated sample only moves time):
//       thread 0:  acc_w = R (acce - ba)
//                  p  = p + v dt + 0.5 acc_w dt dt + 0.5 g dt dt
//                  v  = v + acc_w dt + g dt
//                  R  = R so3_exp((gyro - bg) dt)
//                  the non-identity blocks of F, from the NEW R:
//                    F[0:3, 3:6]  = I dt        F[3:6, 6:9]  = -(R hat(acce - ba)) dt
//                    F[3:6, 12:15] = -R dt      F[3:6, 15:18] = I dt
//                    F[6:9, 6:9]  = so3_exp(-(gyro - bg) dt)   F[6:9, 9:12] = -I dt
//       all 324 threads, one a covariance entry (i, j):
//                  T[i][j]   = sum_k F[i][k] cov[k][j]           (index order)
//                  cov[i][j] = sum_k T[i][k] F[j][k] + Q[i][j]   (index order)
//
// A padded sample (valid 0) changes nothing, time included. bg, ba and g do
// not change. Every thread tracks `time` itself (the stamps and flags are in
// the packet), so the gate is a uniform branch and needs no shared flag. The
// covariance is not symmetrized, as in the reference. so3_exp keeps the
// reference's small-angle branch (theta^2 < 1e-8) and full-precision
// sinf / cosf / sqrtf; with -fmad=false each product and sum rounds on its
// own, as the plain version's torch ops do (kernels.eskf_predict_plain), but
// the 18-term dots sum in index order where the plain version's 18x18
// products are a library's, so the two agree to float32 rounding, not bits.
//
// What bounds it: nothing on the card. A call reads the state (1.4 KB), Q
// (1.3 KB) and the packet (32 B a sample) and writes 1.4 KB. The kernel
// spends ~23,500 float32 operations on an updating sample, most of them the
// two dense products; counted from F's structure (51 nonzeros, 9 identity
// rows) the work needs ~2,800. Its cost is latency: the launch, thread 0's
// serial chain a sample and three block barriers a sample.
#include <cuda_runtime.h>

namespace loc_eskf {

constexpr int kDim = 18;
constexpr int kCov = kDim * kDim;     // 324 threads: one a covariance entry
constexpr int kPacketWords = 8;       // gyro (3) | acce (3) | stamp | valid (0 / 1)

// C = A B for row-major 3x3, each entry (a_i0 b_0j + a_i1 b_1j) + a_i2 b_2j.
__device__ __forceinline__ void mat3(const float* A, const float* B, float* C) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      C[3 * i + j] = (A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j]) + A[3 * i + 2] * B[6 + j];
}

// E = so3_exp(w): (I + a W) + b W^2, Taylor terms for theta^2 < 1e-8.
__device__ __forceinline__ void so3_exp(const float* w, float* E) {
  const float theta2 = (w[0] * w[0] + w[1] * w[1]) + w[2] * w[2];
  const bool small = theta2 < 1e-8f;
  const float theta2_safe = small ? 1.f : theta2;
  const float theta_safe = sqrtf(theta2_safe);
  const float a = small ? 1.f - theta2 / 6.f : sinf(theta_safe) / theta_safe;
  const float b = small ? 0.5f - theta2 / 24.f : (1.f - cosf(theta_safe)) / theta2_safe;
  const float W[9] = {0.f, -w[2], w[1], w[2], 0.f, -w[0], -w[1], w[0], 0.f};
  float W2[9];
  mat3(W, W, W2);
#pragma unroll
  for (int e = 0; e < 9; ++e) E[e] = ((e % 4 == 0 ? 1.f : 0.f) + a * W[e]) + b * W2[e];
}

static __global__ void __launch_bounds__(kCov)
eskf_predict_scan_kernel(const float* __restrict__ p_in, const float* __restrict__ v_in,
                         const float* __restrict__ R_in, const float* __restrict__ bg_in,
                         const float* __restrict__ ba_in, const float* __restrict__ g_in,
                         const float* __restrict__ cov_in, const float* __restrict__ time_in,
                         const float* __restrict__ packet, int K, const float* __restrict__ Q,
                         float max_dt, float* __restrict__ p_out, float* __restrict__ v_out,
                         float* __restrict__ R_out, float* __restrict__ cov_out,
                         float* __restrict__ time_out) {
  __shared__ float cov[kCov], T[kCov], F[kCov];
  const int tid = threadIdx.x;
  const int i = tid / kDim, j = tid % kDim;
  cov[tid] = cov_in[tid];
  F[tid] = i == j ? 1.f : 0.f;
  const float q = Q[tid];
  float time = *time_in;
  // thread 0's nominal state
  float p[3], v[3], R[9], bg[3], ba[3], g[3];
  if (tid == 0) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      p[c] = p_in[c];
      v[c] = v_in[c];
      bg[c] = bg_in[c];
      ba[c] = ba_in[c];
      g[c] = g_in[c];
    }
#pragma unroll
    for (int e = 0; e < 9; ++e) R[e] = R_in[e];
  }
  __syncthreads();
  for (int k = 0; k < K; ++k) {
    const float* x = packet + kPacketWords * k;
    if (x[7] == 0.f) continue;                  // padding: nothing moves
    const float dt = x[6] - time;
    time = x[6];
    if (!(dt <= max_dt && dt >= 0.f)) continue;   // gated: only time moves
    if (tid == 0) {
      const float ab[3] = {x[3] - ba[0], x[4] - ba[1], x[5] - ba[2]};
      float acc_w[3];
#pragma unroll
      for (int r = 0; r < 3; ++r)
        acc_w[r] = (R[3 * r] * ab[0] + R[3 * r + 1] * ab[1]) + R[3 * r + 2] * ab[2];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        p[c] = ((p[c] + v[c] * dt) + 0.5f * acc_w[c] * dt * dt) + 0.5f * g[c] * dt * dt;
        v[c] = (v[c] + acc_w[c] * dt) + g[c] * dt;
      }
      const float w[3] = {(x[0] - bg[0]) * dt, (x[1] - bg[1]) * dt, (x[2] - bg[2]) * dt};
      float E[9], Rn[9], M[9];
      so3_exp(w, E);
      mat3(R, E, Rn);
#pragma unroll
      for (int e = 0; e < 9; ++e) R[e] = Rn[e];
      const float H[9] = {0.f, -ab[2], ab[1], ab[2], 0.f, -ab[0], -ab[1], ab[0], 0.f};
      float nR[9];
#pragma unroll
      for (int e = 0; e < 9; ++e) nR[e] = -R[e];
      mat3(nR, H, M);
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        F[kDim * r + 3 + r] = dt;                    // F[0:3, 3:6]
        F[kDim * (3 + r) + 15 + r] = dt;             // F[3:6, 15:18]
        F[kDim * (6 + r) + 9 + r] = -dt;             // F[6:9, 9:12]
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          F[kDim * (3 + r) + 6 + c] = M[3 * r + c] * dt;     // F[3:6, 6:9]
          F[kDim * (3 + r) + 12 + c] = nR[3 * r + c] * dt;   // F[3:6, 12:15]
          // so3_exp(-w) is E^T: W(-w) = -W(w) = W(w)^T and W^2 is symmetric
          F[kDim * (6 + r) + 6 + c] = E[3 * c + r];          // F[6:9, 6:9]
        }
      }
    }
    __syncthreads();
    float s = F[kDim * i] * cov[j];
#pragma unroll
    for (int m = 1; m < kDim; ++m) s += F[kDim * i + m] * cov[kDim * m + j];
    T[tid] = s;
    __syncthreads();
    s = T[kDim * i] * F[kDim * j];
#pragma unroll
    for (int m = 1; m < kDim; ++m) s += T[kDim * i + m] * F[kDim * j + m];
    cov[tid] = s + q;
    __syncthreads();                             // before thread 0 writes the next F
  }
  cov_out[tid] = cov[tid];
  if (tid == 0) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      p_out[c] = p[c];
      v_out[c] = v[c];
    }
#pragma unroll
    for (int e = 0; e < 9; ++e) R_out[e] = R[e];
    *time_out = time;
  }
}

}  // namespace loc_eskf

extern "C" int eskf_predict_scan_launch(const void* p, const void* v, const void* R,
                                        const void* bg, const void* ba, const void* g,
                                        const void* cov, const void* time, const void* packet,
                                        int K, const void* Q, float max_dt, void* p_out,
                                        void* v_out, void* R_out, void* cov_out,
                                        void* time_out, void* stream) {
  using namespace loc_eskf;
  const auto f = [](const void* ptr) { return static_cast<const float*>(ptr); };
  eskf_predict_scan_kernel<<<1, kCov, 0, static_cast<cudaStream_t>(stream)>>>(
      f(p), f(v), f(R), f(bg), f(ba), f(g), f(cov), f(time), f(packet), K, f(Q), max_dt,
      static_cast<float*>(p_out), static_cast<float*>(v_out), static_cast<float*>(R_out),
      static_cast<float*>(cov_out), static_cast<float*>(time_out));
  return static_cast<int>(cudaGetLastError());
}
