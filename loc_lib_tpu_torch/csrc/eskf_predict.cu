// The ESKF on Hopper (sm_90a): the IMU propagation through one padded IMU
// packet, and the update of an observation, each ONE launch of one block.
//
// Replaces the reference's `predict_scan` (loc_lib_tpu/models/eskf.py: a
// `lax.scan` of `predict` with a keep/skip select per sample, which XLA
// fuses into one program). As torch ops a sample is ~100 launches (two
// so3_exp, hat, the F block writes, two 18x18 products) and a scan's packet
// about 1,000: the first cost of a LIO / Loc step, on a path bound by
// launches. Per sample k of the packet with valid[k]:
//
//   dt = stamp[k] - time;  time = stamp[k]
//   if 0 <= dt <= max_dt (the dt gate; a gated sample only moves time):
//     acc_w = R (acce - ba)
//     p  = p + v dt + 0.5 acc_w dt dt + 0.5 g dt dt
//     v  = v + acc_w dt + g dt
//     R  = R so3_exp((gyro - bg) dt)
//     the non-identity blocks of F, from the NEW R:
//       F[0:3, 3:6]  = I dt        F[3:6, 6:9]  = -(R hat(acce - ba)) dt
//       F[3:6, 12:15] = -R dt      F[3:6, 15:18] = I dt
//       F[6:9, 6:9]  = so3_exp(-(gyro - bg) dt)   F[6:9, 9:12] = -I dt
//     cov = F cov F^T + Q
//
// A padded sample (valid 0) changes nothing, time included. bg, ba and g do
// not change. The covariance is not symmetrized, as in the reference.
// so3_exp keeps the reference's small-angle branch (theta^2 < 1e-8) and
// full-precision sinf / cosf / sqrtf; with -fmad=false each product and sum
// rounds on its own, as the plain version's torch ops do
// (kernels.eskf_predict_plain), but the sums run in index order where the
// plain version's 18x18 products are a library's, so the two agree to
// float32 rounding, not bits.
//
// What bounds it: nothing on the card. A call reads the state (1.4 KB), Q
// (1.3 KB) and the packet (32 B a sample) and writes 1.4 KB; an updating
// sample needs ~2,800 float32 operations counted from F's structure (51
// nonzeros, 9 identity rows). Its cost is latency, so the design shortens
// the chain a sample waits on. Two warps:
//
//   warp 1, the nominal state: stages the packet in shared memory (whole,
//     up to kChunk rows at a time; read with ld.global.cv, so a packet in a
//     page-locked host buffer is read in place over PCIe), finds each row's
//     dt from the last valid stamp before it (a ballot and a shuffle, 32
//     rows at once), computes so3_exp of every row's increment at once (one
//     row a lane, off the serial chain), then walks the updating rows in
//     order: p, v, R and the F blocks (dt, M dt, -R dt, E), which it hands
//     to warp 0 through a ring of kSlots shared-memory slots, each with a
//     "full" and an "empty" mbarrier. It writes p, v, R and time.
//   warp 0, the covariance: lane j < 18 owns column j of cov, of T = F cov
//     and of Q in registers. T's column is local (rows 9-17 copy, rows 0-2
//     take 2 terms, 3-5 take 8, 6-8 take 4); cov' = T F^T + Q needs, for
//     j in 0-8, other lanes' columns of T, fetched by __shfl_sync: columns
//     j and j+3 (j < 3); j, 6-8, 12-14 and j+12 (j in 3-5); 6-8 and j+3 (j
//     in 6-8). No shared-memory round trip and no block barrier a sample.
//
// Every sum runs in the index order of the dense product F cov F^T and
// skips only F's structural zeros: on finite values a skipped term adds a
// zero, so the bits are those of the dense 18-term sums (a zero's sign
// aside). A non-finite value does not keep that: the dense product, like the
// reference's F @ cov @ F.T, spreads a NaN or Inf of cov through 0 x NaN.
// Every column of F has a structural nonzero, and a non-finite value times
// any number, or plus any number, stays non-finite, so a NaN or Inf in cov
// or in T always reaches the structured cov'. One vote (__any_sync) on cov'
// a sample then sends that sample, and every later one, through the dense
// 18-term sums from the saved cov (T's columns by 18 shuffles a row): the
// dense function, the structured speed otherwise.
//
// The update (`eskf_update`) replaces the reference's observe_se3 and
// observe_wheel_speed (loc_lib_tpu/models/eskf.py: the observation build and
// _update_and_reset, one jitted program each). As torch ops they were ~50
// launches a scan. Here one warp; H is a selection matrix (row r picks state
// column sel(r)), m = 6 rows for a pose (p and theta) or 3 for a wheel speed
// (v), and lane j owns column j of P:
//
//   every lane: innov = [t_obs - p, so3_log(R^T R_obs)]  or  R (s, 0, 0) - v
//   S = H P H^T + V   (V = diag(trans x3, ang x3), the noise values and not
//                      their squares, as in the reference; or odom^2 I):
//                      a selection of P
//   S^-1 by Gauss-Jordan with partial pivoting over the 2m columns of
//     [S | I], a lane a column: at step k every lane takes column k by m
//     shuffles, finds the pivot itself (the first row of largest |s_ik|),
//     exchanges rows k and p, divides row k and eliminates: the operations
//     of a serial Gauss-Jordan, entry by entry, so the same bits
//   K = P H^T S^-1 (lane a: row a);  dx = K innov
//   cov = (I - K H) P: row i of (I - K H) has 6 or 7 nonzeros (the selected
//     columns, and i); each lane sums them over its own column of P
//   lane 0: R = so3_renormalize(R so3_exp(dtheta)); lanes 0-17: p, v, bg,
//     ba, g += dx (bg and ba where their flags say)
//   cov = J cov J^T, J = I but J[6:9, 6:9] = I - 0.5 hat(dtheta): J cov
//     touches rows 6-8 of each lane's column, (J cov) J^T columns 6-8, whose
//     lanes exchange rows 6-8 of each other's columns by shuffles
//
// The same rule for non-finite values. A vote on P sends P H^T, H (P H^T)
// and (I - K H) P through their dense 18-term sums: H's zeros then carry a
// NaN or Inf of P into every entry of S, and from there into every output,
// as the reference's H @ P @ H.T does (a selection would not). A NaN or Inf
// of (I - K H) P or of J times it reaches the structured J cov J^T (J's
// diagonal is 1), so a vote on that result sends J cov J^T through its
// dense sums. Like the reference it does not symmetrize. The plain version (kernels.eskf_update_plain)
// multiplies through the BLAS, so the two agree to float32 rounding, not
// bits. What bounds it: nothing on the card (~2.8 KB moved, ~7,000
// operations); its cost is the launch and the chain of the inverse.
//
// Each launch takes one argument struct, passed by pointer from the host.
#include <cuda_runtime.h>

#include <cstdint>

namespace loc_eskf {

constexpr int kDim = 18;
constexpr int kCov = kDim * kDim;
constexpr int kPacketWords = 8;       // gyro (3) | acce (3) | stamp | valid (0 / 1)
constexpr unsigned kAll = 0xffffffffu;
constexpr float kFloatMax = 3.402823466e38f;
constexpr int kChunk = 256;           // packet rows staged at a time (8 KB)
constexpr int kSlots = 8;             // ring slots between the two warps
constexpr int kSlotWords = 32;
// a slot: dt | F[3:6, 6:9] = M dt | F[3:6, 12:15] = -R dt | E (F[6:9, 6:9] = E^T) | more
constexpr int kDt = 0, kMdt = 1, kNRdt = 10, kE = 19, kMore = 28;

struct EskfPredictArgs {
  const float *p, *v, *R, *bg, *ba, *g, *cov, *time, *packet, *Q;
  float *p_out, *v_out, *R_out, *cov_out, *time_out;
  void* event;     // recorded on the stream behind the kernel, or null
  int K;
  float max_dt;
};

struct EskfUpdateArgs {
  const float *p, *v, *R, *bg, *ba, *g, *cov;
  const float* R_obs;    // pose: (3, 3) and (3,), read through the strides below
  const float* t_obs;
  const float* pulses;   // wheel: (2,) left, right, or null: the values below
  float *p_out, *v_out, *R_out, *bg_out, *ba_out, *g_out, *cov_out;
  float noise0, noise1;  // pose: trans, ang noise; wheel: odom_var^2, unused
  float wheel, left, right;
  int kind;              // 0: pose, 1: wheel speed
  int update_bg, update_ba;
  int R_obs_s0, R_obs_s1, t_obs_s;   // element strides (a view of a 4x4 pose needs no copy)
};

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

// x[r] for a lane-dependent r in 0..2, by selects (no indexed registers).
__device__ __forceinline__ float pick3(int r, float a, float b, float c) {
  return r == 0 ? a : (r == 1 ? b : c);
}

// Every entry of x finite (no NaN, no Inf): the tests combined as a tree,
// not as one chain of N dependent predicate operations.
template <int N>
__device__ __forceinline__ bool all_finite(const float* x) {
  bool ok[N];
#pragma unroll
  for (int i = 0; i < N; ++i) ok[i] = fabsf(x[i]) <= kFloatMax;
#pragma unroll
  for (int w = 1; w < N; w *= 2)
#pragma unroll
    for (int i = 0; i + w < N; i += 2 * w) ok[i] = ok[i] & ok[i + w];
  return ok[0];
}

__device__ __forceinline__ uint32_t smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem(bar)) : "memory");
}

// Wait, the whole warp, until the phase of parity `parity` of `bar` has
// completed. The exit is a vote, so the warp leaves the loop converged and
// the shuffles after it compile as plain SHFL (a per-lane exit would make
// the compiler wrap each one in a collective fallback).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem(bar)), "r"(parity)
        : "memory");
  } while (!__all_sync(kAll, done));
}

// Entry (i, m) of F, the sample's blocks given: d = dt, nd = -dt, Md / NRd /
// E the slot's 3x3 blocks. Constant-folded where i and m are; by selects
// where i is a lane's.
__device__ __forceinline__ float f_entry(int i, int m, float d, float nd, const float* Md,
                                         const float* NRd, const float* E) {
  if (i < 3) return m == i ? 1.f : (m == i + 3 ? d : 0.f);
  if (i < 6) {
    const int r = i - 3;
    if (m >= 6 && m < 9) return pick3(r, Md[m - 6], Md[m - 3], Md[m]);
    if (m >= 12 && m < 15) return pick3(r, NRd[m - 12], NRd[m - 9], NRd[m - 6]);
    return m == i ? 1.f : (m == i + 12 ? d : 0.f);
  }
  if (i < 9) {
    const int r = i - 6;
    const int e = 3 * (m - 6);      // F[6 + r][m] = E[3 (m - 6) + r]
    if (m >= 6 && m < 9) return pick3(r, E[e], E[e + 1], E[e + 2]);
    return m == i + 3 ? nd : 0.f;
  }
  return m == i ? 1.f : 0.f;
}

// Warp 1 of eskf_predict_scan: the packet, the gate, the nominal state, and
// a slot of F blocks for each updating sample, in order; then an end slot.
__device__ __forceinline__ void predict_nominal(const EskfPredictArgs& a, int lane, float* pk,
                                                float* ring, uint64_t* full, uint64_t* empty) {
  float p[3], v[3], R[9], bg[3], ba[3], g[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    p[c] = a.p[c];
    v[c] = a.v[c];
    bg[c] = a.bg[c];
    ba[c] = a.ba[c];
    g[c] = a.g[c];
  }
#pragma unroll
  for (int e = 0; e < 9; ++e) R[e] = a.R[e];
  float time = *a.time;
  unsigned n = 0;   // slots filled
  for (int base = 0; base < a.K; base += kChunk) {
    const int rows = min(kChunk, a.K - base);
    const int quads = 2 * rows;   // float4s
    const float4* src = reinterpret_cast<const float4*>(a.packet) + 2 * base;
    float4* dst = reinterpret_cast<float4*>(pk);
    __syncwarp();                 // the previous chunk is read
    for (int q0 = 0; q0 < quads; q0 += 32 * 4) {
      float4 r[4];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int q = q0 + 32 * b + lane;
        r[b] = q < quads ? __ldcv(src + q) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int q = q0 + 32 * b + lane;
        if (q < quads) dst[q] = r[b];
      }
    }
    __syncwarp();
    for (int r0 = 0; r0 < rows; r0 += 32) {
      const int k = r0 + lane;
      const float* x = pk + kPacketWords * min(k, rows - 1);
      const bool valid = k < rows && x[7] != 0.f;
      const float stamp = x[6];
      // the time before row k: the last valid stamp before it
      const unsigned vmask = __ballot_sync(kAll, valid);
      const unsigned before = vmask & ((1u << lane) - 1u);
      const float prev = __shfl_sync(kAll, stamp, before ? 31 - __clz(before) : 0);
      const float dt = stamp - (before ? prev : time);
      if (vmask) time = __shfl_sync(kAll, stamp, 31 - __clz(vmask));
      const bool upd = valid && dt <= a.max_dt && dt >= 0.f;
      // each lane its row's rotation increment: so3_exp off the serial chain
      float w[3], ab[3], E[9];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        w[c] = upd ? (x[c] - bg[c]) * dt : 0.f;
        ab[c] = x[3 + c] - ba[c];
      }
      so3_exp(w, E);
      unsigned umask = __ballot_sync(kAll, upd);
      while (umask) {
        const int l = __ffs(umask) - 1;
        umask &= umask - 1u;
        const float d = __shfl_sync(kAll, dt, l);
        float u[3], e[9];
#pragma unroll
        for (int c = 0; c < 3; ++c) u[c] = __shfl_sync(kAll, ab[c], l);
#pragma unroll
        for (int q = 0; q < 9; ++q) e[q] = __shfl_sync(kAll, E[q], l);
        float acc_w[3];
#pragma unroll
        for (int r = 0; r < 3; ++r)
          acc_w[r] = (R[3 * r] * u[0] + R[3 * r + 1] * u[1]) + R[3 * r + 2] * u[2];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          p[c] = ((p[c] + v[c] * d) + 0.5f * acc_w[c] * d * d) + 0.5f * g[c] * d * d;
          v[c] = (v[c] + acc_w[c] * d) + g[c] * d;
        }
        float Rn[9], M[9], nR[9];
        mat3(R, e, Rn);
#pragma unroll
        for (int q = 0; q < 9; ++q) R[q] = Rn[q];
        const float H[9] = {0.f, -u[2], u[1], u[2], 0.f, -u[0], -u[1], u[0], 0.f};
#pragma unroll
        for (int q = 0; q < 9; ++q) nR[q] = -R[q];
        mat3(nR, H, M);
        const unsigned s = n % kSlots;
        mbar_wait(&empty[s], ((n / kSlots) & 1u) ^ 1u);
        // every lane stores the same words (no divergent branch) and arrives
        float* sl = ring + kSlotWords * s;
        sl[kDt] = d;
#pragma unroll
        for (int q = 0; q < 9; ++q) {
          sl[kMdt + q] = M[q] * d;
          sl[kNRdt + q] = nR[q] * d;
          sl[kE + q] = e[q];
        }
        sl[kMore] = 1.f;
        mbar_arrive(&full[s]);
        ++n;
      }
    }
  }
  const unsigned s = n % kSlots;
  mbar_wait(&empty[s], ((n / kSlots) & 1u) ^ 1u);
  ring[kSlotWords * s + kMore] = 0.f;
  mbar_arrive(&full[s]);
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      a.p_out[c] = p[c];
      a.v_out[c] = v[c];
    }
#pragma unroll
    for (int e = 0; e < 9; ++e) a.R_out[e] = R[e];
    *a.time_out = time;
  }
}

// Warp 0 of eskf_predict_scan: cov = F cov F^T + Q for each slot, lane j a
// column (lanes 18-31 shadow column 17 and store nothing).
__device__ __forceinline__ void predict_cov(const EskfPredictArgs& a, int lane, const float* ring,
                                            uint64_t* full, uint64_t* empty) {
  const int j = lane < kDim ? lane : kDim - 1;
  float c[kDim], q[kDim];
#pragma unroll
  for (int i = 0; i < kDim; ++i) {
    c[i] = a.cov[kDim * i + j];
    q[i] = a.Q[kDim * i + j];
  }
  // the terms of cov'[:, j] = T F[j, :]^T in index order: source column and count
  const int kind = j < 3 ? 0 : (j < 6 ? 1 : (j < 9 ? 2 : 3));
  const int r = kind == 1 ? j - 3 : (kind == 2 ? j - 6 : 0);
  const int nt = kind == 0 ? 2 : (kind == 1 ? 8 : (kind == 2 ? 4 : 1));
  int src[8];
  src[0] = kind == 2 ? 6 : j;
  src[1] = kind == 0 ? j + 3 : (kind == 1 ? 6 : 7);
  src[2] = kind == 1 ? 7 : 8;
  src[3] = kind == 1 ? 8 : j + 3;
  src[4] = 12;
  src[5] = 13;
  src[6] = 14;
  src[7] = j + 12;
  unsigned n = 0;
  bool dense = false;   // set for good once cov holds a non-finite value
  while (true) {
    const unsigned s = n % kSlots;
    mbar_wait(&full[s], (n / kSlots) & 1u);
    const float* sl = ring + kSlotWords * s;
    if (__all_sync(kAll, sl[kMore] == 0.f)) break;     // a vote: the warp leaves together
    const float d = sl[kDt], nd = -d;
    float Md[9], NRd[9], E[9];
#pragma unroll
    for (int e = 0; e < 9; ++e) {
      Md[e] = sl[kMdt + e];
      NRd[e] = sl[kNRdt + e];
      E[e] = sl[kE + e];
    }
    mbar_arrive(&empty[s]);
    ++n;
    // T = F cov and cov' = T F^T + Q over F's nonzeros; a non-finite value
    // in cov or T reaches cov' there (it meets a structural nonzero), so one
    // vote on cov' tells whether the dense sums must be run instead
    float t[kDim], nxt[kDim];
    if (!dense) {
#pragma unroll
      for (int i = 0; i < 3; ++i) t[i] = c[i] + d * c[i + 3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        float s1 = c[3 + i] + Md[3 * i] * c[6];
        s1 = s1 + Md[3 * i + 1] * c[7];
        s1 = s1 + Md[3 * i + 2] * c[8];
        s1 = s1 + NRd[3 * i] * c[12];
        s1 = s1 + NRd[3 * i + 1] * c[13];
        s1 = s1 + NRd[3 * i + 2] * c[14];
        t[3 + i] = s1 + d * c[15 + i];
      }
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        float s1 = E[i] * c[6] + E[3 + i] * c[7];
        s1 = s1 + E[6 + i] * c[8];
        t[6 + i] = s1 + nd * c[9 + i];
      }
#pragma unroll
      for (int i = 9; i < kDim; ++i) t[i] = c[i];
      // F's row j: the weights of lane j's terms
      float w[8];
      w[0] = kind == 2 ? pick3(r, E[0], E[1], E[2]) : 1.f;
      w[1] = kind == 0 ? d
                       : (kind == 1 ? pick3(r, Md[0], Md[3], Md[6]) : pick3(r, E[3], E[4], E[5]));
      w[2] = kind == 1 ? pick3(r, Md[1], Md[4], Md[7]) : pick3(r, E[6], E[7], E[8]);
      w[3] = kind == 1 ? pick3(r, Md[2], Md[5], Md[8]) : nd;
      w[4] = pick3(r, NRd[0], NRd[3], NRd[6]);
      w[5] = pick3(r, NRd[1], NRd[4], NRd[7]);
      w[6] = pick3(r, NRd[2], NRd[5], NRd[8]);
      w[7] = d;
      // term-major: each term's 18 shuffles and adds are independent of
      // one another, so a row's chain of adds waits on nothing
#pragma unroll
      for (int i = 0; i < kDim; ++i) nxt[i] = __shfl_sync(kAll, t[i], src[0]) * w[0];
#pragma unroll
      for (int k = 1; k < 8; ++k) {
#pragma unroll
        for (int i = 0; i < kDim; ++i) {
          const float x = __shfl_sync(kAll, t[i], src[k]);
          nxt[i] = k < nt ? nxt[i] + x * w[k] : nxt[i];
        }
      }
#pragma unroll
      for (int i = 0; i < kDim; ++i) nxt[i] = nxt[i] + q[i];
      dense = __any_sync(kAll, !all_finite<kDim>(nxt));
    }
    if (dense) {      // the dense 18-term sums (from here on: NaN stays)
#pragma unroll
      for (int i = 0; i < kDim; ++i) {
        float s1 = f_entry(i, 0, d, nd, Md, NRd, E) * c[0];
#pragma unroll
        for (int m = 1; m < kDim; ++m) s1 = s1 + f_entry(i, m, d, nd, Md, NRd, E) * c[m];
        t[i] = s1;
      }
      float f[kDim];
#pragma unroll
      for (int m = 0; m < kDim; ++m) f[m] = f_entry(j, m, d, nd, Md, NRd, E);
#pragma unroll
      for (int i = 0; i < kDim; ++i) {
        float s1 = __shfl_sync(kAll, t[i], 0) * f[0];
#pragma unroll
        for (int m = 1; m < kDim; ++m) s1 = s1 + __shfl_sync(kAll, t[i], m) * f[m];
        nxt[i] = s1 + q[i];
      }
    }
#pragma unroll
    for (int i = 0; i < kDim; ++i) c[i] = nxt[i];
  }
  if (lane < kDim) {
#pragma unroll
    for (int i = 0; i < kDim; ++i) a.cov_out[kDim * i + lane] = c[i];
  }
}

static __global__ void __launch_bounds__(64) eskf_predict_scan_kernel(const EskfPredictArgs a) {
  __shared__ __align__(16) float pk[kChunk * kPacketWords];
  __shared__ __align__(16) float ring[kSlots * kSlotWords];
  __shared__ __align__(8) uint64_t full[kSlots], empty[kSlots];
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      mbar_init(&full[s], 32);       // warp 1's 32 lanes have filled a slot
      mbar_init(&empty[s], 32);      // warp 0's 32 lanes have read it
    }
  }
  __syncthreads();                   // once: the barriers before their first use
  if (threadIdx.x >= 32)
    predict_nominal(a, lane, pk, ring, full, empty);
  else
    predict_cov(a, lane, ring, full, empty);
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

// The row of H that selects state column k, or -1.
template <int M>
__device__ __forceinline__ constexpr int selecting(int k) {
  return M == 6 ? (k < 3 ? k : (k >= 6 && k < 9 ? k - 3 : -1)) : (k >= 3 && k < 6 ? k - 3 : -1);
}

// Entry (i, k) of J: the identity but J[6:9, 6:9] = I - 0.5 hat(dtheta),
// as (i == k) - 0.5 h with h = 0 on the diagonal, -d[m] / d[m] off it.
__device__ __forceinline__ float j_entry(int i, int k, const float* d) {
  const float jv = i == k ? 1.f : 0.f;
  if (i < 6 || i >= 9 || k < 6 || k >= 9) return jv;
  const int r = i - 6, c = k - 6, m = 3 - r - c;
  const float dm = pick3(m < 3 ? m : 0, d[0], d[1], d[2]);
  const float h = r == c ? 0.f : ((c - r + 3) % 3 == 1 ? -dm : dm);
  return jv - 0.5f * h;
}

template <int M>
static __global__ void __launch_bounds__(32) eskf_update_kernel(const EskfUpdateArgs a) {
  __shared__ float P[kCov], PH[kDim * M], Si[M * M], K[kDim * M], dxs[kDim];
  const int lane = threadIdx.x;
  const int j = lane < kDim ? lane : kDim - 1;   // lanes 18-31 shadow column 17
  constexpr int kLoads = (kCov + 31) / 32;
  {
    float x[kLoads];
#pragma unroll
    for (int b = 0; b < kLoads; ++b) {
      const int e = 32 * b + lane;
      x[b] = e < kCov ? a.cov[e] : 0.f;
    }
#pragma unroll
    for (int b = 0; b < kLoads; ++b) {
      const int e = 32 * b + lane;
      if (e < kCov) P[e] = x[b];
    }
  }
  // the innovation, in every lane
  float innov[M];
  if constexpr (M == 6) {
    float Rt[9], Ro[9], D[9], w[3];
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        Rt[3 * r + c] = a.R[3 * c + r];
        Ro[3 * r + c] = a.R_obs[a.R_obs_s0 * r + a.R_obs_s1 * c];
      }
    mat3(Rt, Ro, D);
    so3_log(D, w);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      innov[c] = a.t_obs[a.t_obs_s * c] - a.p[c];
      innov[3 + c] = w[c];
    }
  } else {
    const float l = a.pulses != nullptr ? a.pulses[0] : a.left;
    const float r = a.pulses != nullptr ? a.pulses[1] : a.right;
    const float speed = 0.5f * (a.wheel * l + a.wheel * r);
    const float vb[3] = {1.f * speed, 0.f * speed, 0.f * speed};
#pragma unroll
    for (int c = 0; c < 3; ++c)
      innov[c] = ((a.R[3 * c] * vb[0] + a.R[3 * c + 1] * vb[1]) + a.R[3 * c + 2] * vb[2])
                     - a.v[c];
  }
  __syncwarp();
  float c[kDim];
#pragma unroll
  for (int i = 0; i < kDim; ++i) c[i] = P[kDim * i + j];
  // P H^T, lane a its row: a selection of P; where P holds a non-finite
  // value, the dense sums over H's zeros, which spread it as H P H^T does
  const bool finite = !__any_sync(kAll, !all_finite<kDim>(c));
  if (lane < kDim) {
#pragma unroll
    for (int cc = 0; cc < M; ++cc) {
      float s = P[kDim * lane + selected<M>(cc)];
      if (!finite) {
        s = P[kDim * lane] * (selected<M>(cc) == 0 ? 1.f : 0.f);
#pragma unroll
        for (int k = 1; k < kDim; ++k)
          s = s + P[kDim * lane + k] * (selected<M>(cc) == k ? 1.f : 0.f);
      }
      PH[M * lane + cc] = s;
    }
  }
  __syncwarp();
  // [S | I], lane a column (lanes 0..M-1: S = H P H^T + V; M..2M-1: I)
  float col[M];
  {
    const int sc = lane < M ? lane : 0;
#pragma unroll
    for (int r = 0; r < M; ++r) {
      const float noise = M == 6 ? (r < 3 ? a.noise0 : a.noise1) : a.noise0;
      float hph = PH[M * selected<M>(r) + sc];
      if (!finite) {
        hph = (selected<M>(r) == 0 ? 1.f : 0.f) * PH[sc];
#pragma unroll
        for (int k = 1; k < kDim; ++k)
          hph = hph + (selected<M>(r) == k ? 1.f : 0.f) * PH[M * k + sc];
      }
      const float s = hph + (r == sc ? noise : 0.f);
      col[r] = lane < M ? s : (r == lane - M ? 1.f : 0.f);
    }
  }
#pragma unroll
  for (int k = 0; k < M; ++k) {
    float ck[M];
#pragma unroll
    for (int r = 0; r < M; ++r) ck[r] = __shfl_sync(kAll, col[r], k);
    int p = k;
    float best = fabsf(ck[k]);
#pragma unroll
    for (int i = k + 1; i < M; ++i) {
      const float v = fabsf(ck[i]);
      if (v > best) {
        best = v;
        p = i;
      }
    }
#pragma unroll
    for (int i = k + 1; i < M; ++i) {
      const bool s = i == p;
      float x = col[k], y = col[i];
      col[k] = s ? y : x;
      col[i] = s ? x : y;
      x = ck[k];
      y = ck[i];
      ck[k] = s ? y : x;
      ck[i] = s ? x : y;
    }
    const float piv = ck[k];
    col[k] = col[k] / piv;
#pragma unroll
    for (int i = 0; i < M; ++i)
      if (i != k) col[i] = col[i] - ck[i] * col[k];
  }
  if (lane >= M && lane < 2 * M) {
#pragma unroll
    for (int r = 0; r < M; ++r) Si[M * r + lane - M] = col[r];
  }
  __syncwarp();
  // K = P H^T S^-1 and dx = K innov: lane a, row a
  float dxa = 0.f;
  if (lane < kDim) {
    float Kr[M];
#pragma unroll
    for (int cc = 0; cc < M; ++cc) {
      float s = PH[M * lane] * Si[cc];
#pragma unroll
      for (int r = 1; r < M; ++r) s += PH[M * lane + r] * Si[M * r + cc];
      Kr[cc] = s;
      K[M * lane + cc] = s;
    }
    dxa = Kr[0] * innov[0];
#pragma unroll
    for (int cc = 1; cc < M; ++cc) dxa += Kr[cc] * innov[cc];
    dxs[lane] = dxa;
  }
  __syncwarp();
  // C = (I - K H) P, column j: A[i][k] = (i == k) - K[i][r] where row r of
  // H selects column k, else (i == k) - 0
  float C[kDim];
  if (finite) {
#pragma unroll
    for (int i = 0; i < kDim; ++i) {
      float s = 0.f;
      bool first = true;
#pragma unroll
      for (int k = 0; k < kDim; ++k) {
        const int r = selecting<M>(k);
        if (r < 0 && k != i) continue;
        const float A = (i == k ? 1.f : 0.f) - (r < 0 ? 0.f : K[M * i + (r < 0 ? 0 : r)]);
        s = first ? A * c[k] : s + A * c[k];
        first = false;
      }
      C[i] = s;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kDim; ++i) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < kDim; ++k) {
        const int r = selecting<M>(k);
        const float A = (i == k ? 1.f : 0.f) - (r < 0 ? 0.f : K[M * i + (r < 0 ? 0 : r)]);
        s = k == 0 ? A * c[k] : s + A * c[k];
      }
      C[i] = s;
    }
  }
  // the injection: lanes 0-17 their entry of dx, lane 0 the rotation
  const float d[3] = {dxs[6], dxs[7], dxs[8]};
  {
    const float fg = a.update_bg ? 1.f : 0.f, fa = a.update_ba ? 1.f : 0.f;
    if (lane < 3) a.p_out[lane] = a.p[lane] + dxa;
    else if (lane < 6) a.v_out[lane - 3] = a.v[lane - 3] + dxa;
    else if (lane < 9) {
    } else if (lane < 12) a.bg_out[lane - 9] = a.bg[lane - 9] + dxa * fg;
    else if (lane < 15) a.ba_out[lane - 12] = a.ba[lane - 12] + dxa * fa;
    else if (lane < kDim) a.g_out[lane - 15] = a.g[lane - 15] + dxa;
  }
  // T = J C (rows 6-8 of the column) and cov = T J^T (columns 6-8, from
  // lanes 6-8 by shuffles). A non-finite value of C or T reaches cov here
  // (J's diagonal is 1), so one vote on cov tells whether the dense sums
  // must be run instead
  float T[kDim], out[kDim];
#pragma unroll
  for (int i = 0; i < kDim; ++i) {
    if (i >= 6 && i < 9) {
      float s = j_entry(i, 6, d) * C[6] + j_entry(i, 7, d) * C[7];
      T[i] = s + j_entry(i, 8, d) * C[8];
    } else {
      T[i] = C[i];
    }
  }
  {
    const bool mid = j >= 6 && j < 9;
    const float j6 = j_entry(j, 6, d), j7 = j_entry(j, 7, d), j8 = j_entry(j, 8, d);
#pragma unroll
    for (int i = 0; i < kDim; ++i) {
      const float t6 = __shfl_sync(kAll, T[i], 6), t7 = __shfl_sync(kAll, T[i], 7),
                  t8 = __shfl_sync(kAll, T[i], 8);
      const float s = t6 * j6 + t7 * j7;
      out[i] = mid ? s + t8 * j8 : T[i];
    }
  }
  if (__any_sync(kAll, !all_finite<kDim>(out))) {
#pragma unroll
    for (int i = 0; i < kDim; ++i) {
      float s = j_entry(i, 0, d) * C[0];
#pragma unroll
      for (int k = 1; k < kDim; ++k) s = s + j_entry(i, k, d) * C[k];
      T[i] = s;
    }
    float jr[kDim];
#pragma unroll
    for (int k = 0; k < kDim; ++k) jr[k] = j_entry(j, k, d);
#pragma unroll
    for (int i = 0; i < kDim; ++i) {
      float s = __shfl_sync(kAll, T[i], 0) * jr[0];
#pragma unroll
      for (int k = 1; k < kDim; ++k) s = s + __shfl_sync(kAll, T[i], k) * jr[k];
      out[i] = s;
    }
  }
  if (lane < kDim) {
#pragma unroll
    for (int i = 0; i < kDim; ++i) a.cov_out[kDim * i + lane] = out[i];
  }
  if (lane == 0) {
    float E[9], Rn[9];
    so3_exp(d, E);
    mat3(a.R, E, Rn);
    renormalize3(Rn);
#pragma unroll
    for (int e = 0; e < 9; ++e) a.R_out[e] = Rn[e];
  }
}

}  // namespace loc_eskf

extern "C" int eskf_predict_scan_launch(const loc_eskf::EskfPredictArgs* args, void* stream) {
  using namespace loc_eskf;
  const auto st = static_cast<cudaStream_t>(stream);
  eskf_predict_scan_kernel<<<1, 64, 0, st>>>(*args);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || args->event == nullptr) return static_cast<int>(err);
  return static_cast<int>(cudaEventRecord(static_cast<cudaEvent_t>(args->event), st));
}

extern "C" int eskf_update_launch(const loc_eskf::EskfUpdateArgs* args, void* stream) {
  using namespace loc_eskf;
  const auto st = static_cast<cudaStream_t>(stream);
  if (args->kind == 0)
    eskf_update_kernel<6><<<1, 32, 0, st>>>(*args);
  else if (args->kind == 1)
    eskf_update_kernel<3><<<1, 32, 0, st>>>(*args);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// The IMU packet's page-locked, mapped host buffers (kernels._PinnedRing):
// their allocation and device address, and an event per buffer, recorded
// behind the kernel that reads it and waited on before the buffer is
// written again.
extern "C" int loc_event_create(void** event) {
  return static_cast<int>(
      cudaEventCreateWithFlags(reinterpret_cast<cudaEvent_t*>(event), cudaEventDisableTiming));
}

extern "C" int loc_event_wait(void* event) {
  return static_cast<int>(cudaEventSynchronize(static_cast<cudaEvent_t>(event)));
}

extern "C" int loc_host_alloc(long long bytes, void** host) {
  return static_cast<int>(cudaHostAlloc(host, static_cast<size_t>(bytes),
                                        cudaHostAllocMapped | cudaHostAllocPortable));
}

extern "C" int loc_host_free(void* host) { return static_cast<int>(cudaFreeHost(host)); }

extern "C" int loc_host_device_pointer(void* host, void** device) {
  return static_cast<int>(cudaHostGetDevicePointer(device, host, 0));
}
