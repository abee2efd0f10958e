// The ESKF on Hopper (sm_90a): the IMU propagation through one padded IMU
// packet, and the update of an observation, each ONE launch of one block.
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
//
// The update (`eskf_update`) replaces the reference's observe_se3 and
// observe_wheel_speed (loc_lib_tpu/models/eskf.py: the observation build and
// _update_and_reset, one jitted program each). As torch ops they were ~50
// launches a scan. Here one block of 324 threads, one a covariance entry,
// with H a selection matrix (row r picks state column sel(r)), m = 6 rows for
// a pose (p and theta) or 3 for a wheel speed (v):
//
//   thread 0:   innov = [t_obs - p, so3_log(R^T R_obs)]   or   R (s, 0, 0) - v
//   PHt = P H^T (18 x m)  = the selected columns of P
//   S   = H P H^T + V     (V = diag(trans x3, ang x3), the noise values and
//                          not their squares, as in the reference; or odom^2 I)
//   thread 0:   S^-1 by Gauss-Jordan with partial pivoting
//   K = PHt S^-1;  dx = K innov;  cov = (I - K H) P   (18-term dots, index order)
//   thread 0:   p, v, g += dx; bg, ba += dx where their flags say;
//               R = so3_renormalize(R so3_exp(dtheta))
//   cov = J cov J^T, J = I but J[6:9, 6:9] = I - 0.5 hat(dtheta)
//
// A product with an exact zero of H adds nothing, so the selection computes
// the function of the dense products; like the reference it does not
// symmetrize. The plain version (kernels.eskf_update_plain) multiplies
// through the BLAS, so the two agree to float32 rounding, not bits. What
// bounds it: nothing on the card (~2.8 KB moved, ~15,000 operations); its
// cost is the launch and the block's serial chain (thread 0's inverse).
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

// R <- two Newton-Schulz polar iterations, 0.5 R (3 I - R^T R), in place.
__device__ __forceinline__ void renormalize3(float* R) {
  float Rt[9], M[9], Rn[9];
#pragma unroll
  for (int it = 0; it < 2; ++it) {
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) Rt[3 * i + j] = R[3 * j + i];
    mat3(Rt, R, M);
#pragma unroll
    for (int e = 0; e < 9; ++e) M[e] = (e % 4 == 0 ? 3.f : 0.f) - M[e];
    mat3(R, M, Rn);
#pragma unroll
    for (int e = 0; e < 9; ++e) R[e] = 0.5f * Rn[e];
  }
}

// torch.sign: -1, 0 or 1, NaN kept.
__device__ __forceinline__ float sign_of(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : x);
}

// torch.clamp(x, lo, hi), NaN kept.
__device__ __forceinline__ float clamp_to(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// w = so3_log(R), lie.so3_log's branches: Taylor near the identity, the
// axis from the symmetric part near pi.
__device__ __forceinline__ void so3_log(const float* R, float* w) {
  const float trace = (R[0] + R[4]) + R[8];
  const float cos_t = clamp_to((trace - 1.f) * 0.5f, -1.f, 1.f);
  const float ws[3] = {0.5f * (R[7] - R[5]), 0.5f * (R[2] - R[6]), 0.5f * (R[3] - R[1])};
  const float sin2 = (ws[0] * ws[0] + ws[1] * ws[1]) + ws[2] * ws[2];
  const bool small = sin2 < 1e-12f && cos_t > 0.f;
  const float sin_t = sqrtf(small ? 1.f : sin2);
  const float theta_gen = atan2f(sin_t, cos_t);
  const float theta = small ? sqrtf(sin2 < 0.f ? 0.f : sin2) : theta_gen;
  const float scale = small ? 1.f + sin2 / 6.f : theta_gen / sin_t;
  if (!(theta > 3.f)) {
#pragma unroll
    for (int c = 0; c < 3; ++c) w[c] = ws[c] * scale;
    return;
  }
  float axis[3], hint[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float sq = (R[4 * c] - cos_t) / ((1.f - cos_t) + 1e-8f);
    axis[c] = sqrtf(sq < 0.f ? 0.f : sq);
    hint[c] = fabsf(ws[c]) > 1e-6f ? sign_of(ws[c]) : 1.f;
  }
  const float sxy = R[1] + R[3], sxz = R[2] + R[6];
  const float ax = axis[0] * hint[0];
  const float ay = (fabsf(sxy) > 1e-6f ? sign_of(sxy) * sign_of(ax) : hint[1]) * axis[1];
  const float az = (fabsf(sxz) > 1e-6f ? sign_of(sxz) * sign_of(ax) : hint[2]) * axis[2];
  w[0] = ax * theta;
  w[1] = ay * theta;
  w[2] = az * theta;
}

// The state column row r of H selects: p (0:3) and theta (6:9) for a pose,
// v (3:6) for a wheel speed.
template <int M>
__device__ __forceinline__ constexpr int selected(int r) {
  return M == 6 ? (r < 3 ? r : r + 3) : r + 3;
}

// X = S^-1 for one M x M system by Gauss-Jordan elimination with partial
// pivoting (the first row of largest |s_ik|; rows swapped by selects).
template <int M>
__device__ __forceinline__ void invert(const float* S, float* X) {
  float A[M * M];
#pragma unroll
  for (int e = 0; e < M * M; ++e) {
    A[e] = S[e];
    X[e] = e % (M + 1) == 0 ? 1.f : 0.f;
  }
#pragma unroll
  for (int k = 0; k < M; ++k) {
    int p = k;
    float best = fabsf(A[M * k + k]);
#pragma unroll
    for (int i = k + 1; i < M; ++i) {
      const float v = fabsf(A[M * i + k]);
      if (v > best) {
        best = v;
        p = i;
      }
    }
#pragma unroll
    for (int i = k + 1; i < M; ++i) {
      const bool s = i == p;
#pragma unroll
      for (int j = 0; j < M; ++j) {
        float a = A[M * k + j], c = A[M * i + j];
        A[M * k + j] = s ? c : a;
        A[M * i + j] = s ? a : c;
        a = X[M * k + j];
        c = X[M * i + j];
        X[M * k + j] = s ? c : a;
        X[M * i + j] = s ? a : c;
      }
    }
    const float piv = A[M * k + k];
#pragma unroll
    for (int j = 0; j < M; ++j) {
      A[M * k + j] = A[M * k + j] / piv;
      X[M * k + j] = X[M * k + j] / piv;
    }
#pragma unroll
    for (int i = 0; i < M; ++i) {
      if (i == k) continue;
      const float f = A[M * i + k];
#pragma unroll
      for (int j = 0; j < M; ++j) {
        A[M * i + j] = A[M * i + j] - f * A[M * k + j];
        X[M * i + j] = X[M * i + j] - f * X[M * k + j];
      }
    }
  }
}

struct EskfObs {
  const float* R_obs;    // pose: (3, 3) and (3,)
  const float* t_obs;
  const float* pulses;   // wheel: (2,) left, right, or null: the values below
  float noise0, noise1;  // pose: trans, ang noise; wheel: odom_var^2, unused
  float wheel, left, right;
  int update_bg, update_ba;
};

template <int M>
static __global__ void __launch_bounds__(kCov)
eskf_update_kernel(const float* __restrict__ p_in, const float* __restrict__ v_in,
                   const float* __restrict__ R_in, const float* __restrict__ bg_in,
                   const float* __restrict__ ba_in, const float* __restrict__ g_in,
                   const float* __restrict__ cov_in, const EskfObs obs,
                   float* __restrict__ p_out, float* __restrict__ v_out,
                   float* __restrict__ R_out, float* __restrict__ bg_out,
                   float* __restrict__ ba_out, float* __restrict__ g_out,
                   float* __restrict__ cov_out) {
  __shared__ float P[kCov], A[kCov], C[kCov], J[kCov], T[kCov];
  __shared__ float PHt[kDim * M], S[M * M], Si[M * M], K[kDim * M], innov[M], dx[kDim];
  const int tid = threadIdx.x;
  const int i = tid / kDim, j = tid % kDim;
  P[tid] = cov_in[tid];
  if (tid == 0) {
    if (M == 6) {
      float Rt[9], D[9];
#pragma unroll
      for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int c = 0; c < 3; ++c) Rt[3 * r + c] = R_in[3 * c + r];
      mat3(Rt, obs.R_obs, D);
      float w[3];
      so3_log(D, w);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        innov[c] = obs.t_obs[c] - p_in[c];
        innov[3 + c] = w[c];
      }
    } else {
      const float l = obs.pulses != nullptr ? obs.pulses[0] : obs.left;
      const float r = obs.pulses != nullptr ? obs.pulses[1] : obs.right;
      const float speed = 0.5f * (obs.wheel * l + obs.wheel * r);
      const float vb[3] = {1.f * speed, 0.f * speed, 0.f * speed};
#pragma unroll
      for (int c = 0; c < 3; ++c)
        innov[c] = ((R_in[3 * c] * vb[0] + R_in[3 * c + 1] * vb[1]) + R_in[3 * c + 2] * vb[2])
                   - v_in[c];
    }
  }
  __syncthreads();
  if (tid < kDim * M) PHt[tid] = P[kDim * (tid / M) + selected<M>(tid % M)];
  __syncthreads();
  if (tid < M * M) {
    const int r = tid / M, c = tid % M;
    const float noise = M == 6 ? (r < 3 ? obs.noise0 : obs.noise1) : obs.noise0;
    S[tid] = PHt[M * selected<M>(r) + c] + (r == c ? noise : 0.f);
  }
  __syncthreads();
  if (tid == 0) invert<M>(S, Si);
  __syncthreads();
  if (tid < kDim * M) {
    const int a = tid / M, c = tid % M;
    float s = PHt[M * a] * Si[c];
#pragma unroll
    for (int r = 1; r < M; ++r) s += PHt[M * a + r] * Si[M * r + c];
    K[tid] = s;
  }
  __syncthreads();
  if (tid < kDim) {
    float s = K[M * tid] * innov[0];
#pragma unroll
    for (int c = 1; c < M; ++c) s += K[M * tid + c] * innov[c];
    dx[tid] = s;
  }
  {
    // (K H)[i][j]: K[i][r] where row r selects column j, else 0
    float kh = 0.f;
#pragma unroll
    for (int r = 0; r < M; ++r) kh = selected<M>(r) == j ? K[M * i + r] : kh;
    A[tid] = (i == j ? 1.f : 0.f) - kh;
  }
  __syncthreads();
  {
    float s = A[kDim * i] * P[j];
#pragma unroll
    for (int k = 1; k < kDim; ++k) s += A[kDim * i + k] * P[kDim * k + j];
    C[tid] = s;
  }
  {
    float jv = i == j ? 1.f : 0.f;
    if (i >= 6 && i < 9 && j >= 6 && j < 9) {
      // hat(dtheta)[r][c] = 0 on the diagonal, -d[k] / d[k] off it
      const int r = i - 6, c = j - 6, k = 3 - r - c;
      const float h = r == c ? 0.f : ((c - r + 3) % 3 == 1 ? -dx[6 + k] : dx[6 + k]);
      jv = jv - 0.5f * h;
    }
    J[tid] = jv;
  }
  if (tid == 0) {
    float E[9], Rn[9];
    so3_exp(dx + 6, E);
    mat3(R_in, E, Rn);
    renormalize3(Rn);
#pragma unroll
    for (int e = 0; e < 9; ++e) R_out[e] = Rn[e];
    const float fg = obs.update_bg ? 1.f : 0.f, fa = obs.update_ba ? 1.f : 0.f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      p_out[c] = p_in[c] + dx[c];
      v_out[c] = v_in[c] + dx[3 + c];
      bg_out[c] = bg_in[c] + dx[9 + c] * fg;
      ba_out[c] = ba_in[c] + dx[12 + c] * fa;
      g_out[c] = g_in[c] + dx[15 + c];
    }
  }
  __syncthreads();
  {
    float s = J[kDim * i] * C[j];
#pragma unroll
    for (int k = 1; k < kDim; ++k) s += J[kDim * i + k] * C[kDim * k + j];
    T[tid] = s;
  }
  __syncthreads();
  float s = T[kDim * i] * J[kDim * j];
#pragma unroll
  for (int k = 1; k < kDim; ++k) s += T[kDim * i + k] * J[kDim * j + k];
  cov_out[tid] = s;
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

extern "C" int eskf_update_launch(const void* p, const void* v, const void* R, const void* bg,
                                  const void* ba, const void* g, const void* cov, int kind,
                                  const void* R_obs, const void* t_obs, const void* pulses,
                                  float noise0, float noise1, float wheel, float left,
                                  float right, int update_bg, int update_ba, void* p_out,
                                  void* v_out, void* R_out, void* bg_out, void* ba_out,
                                  void* g_out, void* cov_out, void* stream) {
  using namespace loc_eskf;
  const auto f = [](const void* ptr) { return static_cast<const float*>(ptr); };
  const auto o = [](void* ptr) { return static_cast<float*>(ptr); };
  const EskfObs obs{f(R_obs), f(t_obs), f(pulses), noise0, noise1, wheel, left, right,
                    update_bg, update_ba};
  const auto st = static_cast<cudaStream_t>(stream);
  if (kind == 0)
    eskf_update_kernel<6><<<1, kCov, 0, st>>>(f(p), f(v), f(R), f(bg), f(ba), f(g), f(cov), obs,
                                               o(p_out), o(v_out), o(R_out), o(bg_out),
                                               o(ba_out), o(g_out), o(cov_out));
  else if (kind == 1)
    eskf_update_kernel<3><<<1, kCov, 0, st>>>(f(p), f(v), f(R), f(bg), f(ba), f(g), f(cov), obs,
                                               o(p_out), o(v_out), o(R_out), o(bg_out),
                                               o(ba_out), o(g_out), o(cov_out));
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// The IMU packet's way to the card (kernels._PinnedRing): an event per
// page-locked host buffer, waited on before the buffer is written again, and
// the copy with its event in one call, on the caller's stream.
extern "C" int loc_event_create(void** event) {
  return static_cast<int>(
      cudaEventCreateWithFlags(reinterpret_cast<cudaEvent_t*>(event), cudaEventDisableTiming));
}

extern "C" int loc_event_wait(void* event) {
  return static_cast<int>(cudaEventSynchronize(static_cast<cudaEvent_t>(event)));
}

extern "C" int loc_copy_to_device(void* dst, const void* src, long long bytes, void* event,
                                  void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaMemcpyAsync(dst, src, static_cast<size_t>(bytes),
                                          cudaMemcpyHostToDevice, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaEventRecord(static_cast<cudaEvent_t>(event), st));
}
