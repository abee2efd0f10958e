// A Gauss-Newton iteration after its linearization, and the projection onto
// SO(3), for Hopper (sm_90a): two small kernels, one thread a match.
//
// In the reference (loc_lib_tpu/models/icp.py, the while_loop body of
// scan_match: the warm-up damping, mathx.solve_gn_6x6, the `where` filters,
// lie.se3_retract, the step norm and the stop test; lie.so3_renormalize on
// the way out) these are a few hundred scalar operations that XLA fuses into
// the loop's program. As torch ops they were ~20 launches an iteration (the
// solve alone an LU, its pivots and a solve through the solver library) and
// ~18 for the projection, each 5-10 us of host time, on a path that is bound
// by launches. Here an iteration after its linearization is ONE launch:
//
//   gn_step   per lane l of L (L = 1 for one match, B for a batched loop):
//     frozen (active[l] == 0): nothing changes, R_out and the counters too
//     H, b, count, chi2 = the linearization, or the sum of two (LOAM: the
//                         surface and edge terms, 0 + Hs + He = Hs + He)
//     ok    = gate_count >= min_effective   (gate_count: count, or the source
//                                            count NDT direct gates on)
//     warm:   lam = 1e-2 max diag(H) + 1e-6 (NaN propagates, as torch.max);
//             H  <- H + lam I               (lam * 0 added off the diagonal)
//     dx    = H^-1 b: LU with partial pivoting (the first largest |pivot|,
//             as LAPACK's isamax; a zero pivot scales nothing, as getrf),
//             elimination on [H | b], then back substitution
//     d     = ok and dx finite ? dx : 0          (entry by entry)
//     R     = R exp(d[0:3]), t = t + d[3:6]     (Rodrigues, Taylor near 0)
//     R_out = R after two Newton-Schulz steps   (what the match returns)
//     converged = ok and |d| < eps and not warm; n_eff = count; chi2;
//     iterations + 1; active = not converged
//   and one byte: is any lane still active (the host's one read per
//   iteration).
//
//   so3_renormalize  R (L, 3, 3) -> two Newton-Schulz polar iterations
//                    R <- 0.5 R (3 I - R^T R)   (a loop that ran no iteration)
//
// The state may be updated in place (in == out): a lane's thread reads all
// of its lane's inputs before it writes. The linearization is read through
// lane strides, so the fused-terms kernels' (L, 44) outputs need no copy.
//
// A lane's result depends on that lane's inputs alone, so lane b of a
// batched launch has the bits of the scalar launch on lane b's inputs: the
// same thread program runs either way. The retraction and the projection
// follow the plain version (kernels.gn_step_plain with lie.matmul3)
// operation by operation under -fmad=false: a 3x3 product entry is
// (p0 + p1) + p2. The solve sums in its own order, where the plain version
// calls the solver library, so the two agree to float32 rounding scaled by
// H's condition number, not to the bit.
//
// What bounds it: nothing on the card. A lane reads its linearization
// (44 words), pose and counters and writes them back (~335 B); the work is
// ~600 float32 operations. Its cost is one launch and its enqueue.
#include <cuda_runtime.h>

namespace loc_fused {

constexpr int kUpdateThreads = 128;
constexpr int kStepThreads = 256;    // gn_step: one block; lanes past it loop

// C = A B for row-major 3x3, each entry (a_i0 b_0j + a_i1 b_1j) + a_i2 b_2j.
__device__ __forceinline__ void matmul3(const float* A, const float* B, float* C) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      C[3 * i + j] = (A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j]) + A[3 * i + 2] * B[6 + j];
}

// Two Newton-Schulz polar iterations, R <- 0.5 R (3 I - R^T R), in place.
__device__ __forceinline__ void renormalize3(float* Rl) {
  float Rt[9], M[9], Rn[9];
#pragma unroll
  for (int it = 0; it < 2; ++it) {
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) Rt[3 * i + j] = Rl[3 * j + i];
    matmul3(Rt, Rl, M);
#pragma unroll
    for (int e = 0; e < 9; ++e) M[e] = (e % 4 == 0 ? 3.f : 0.f) - M[e];
    matmul3(Rl, M, Rn);
#pragma unroll
    for (int e = 0; e < 9; ++e) Rl[e] = 0.5f * Rn[e];
  }
}

// Solves A x = y for one 6x6 system in registers, x returned in y; A is
// destroyed. Gaussian elimination with partial pivoting on [A | y] (the
// first row of largest |a_ik| wins; rows swapped by selects, so every index
// stays a compile-time constant), then back substitution. A zero pivot
// divides nothing in the elimination, as LAPACK's getrf; the back
// substitution divides by it, so a singular A gives non-finite entries.
__device__ __forceinline__ void solve6(float* A, float* y) {
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    int p = k;
    float best = fabsf(A[6 * k + k]);
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      const float v = fabsf(A[6 * i + k]);
      if (v > best) {
        best = v;
        p = i;
      }
    }
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      const bool s = i == p;
#pragma unroll
      for (int j = k; j < 6; ++j) {
        const float a = A[6 * k + j], c = A[6 * i + j];
        A[6 * k + j] = s ? c : a;
        A[6 * i + j] = s ? a : c;
      }
      const float a = y[k], c = y[i];
      y[k] = s ? c : a;
      y[i] = s ? a : c;
    }
    const float piv = A[6 * k + k];
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      const float l = piv != 0.f ? A[6 * i + k] / piv : A[6 * i + k];
#pragma unroll
      for (int j = k + 1; j < 6; ++j) A[6 * i + j] = A[6 * i + j] - l * A[6 * k + j];
      y[i] = y[i] - l * y[k];
    }
  }
#pragma unroll
  for (int k = 5; k >= 0; --k) {
    y[k] = y[k] / A[6 * k + k];
#pragma unroll
    for (int i = 0; i < k; ++i) y[i] = y[i] - y[k] * A[6 * i + k];
  }
}

// One linearization, read through lane strides (in elements): H rows are
// contiguous (6, 1), b is contiguous.
struct GnLin {
  const float* H;
  const float* b;
  const int* count;
  const float* chi2;
  long long sH, sb, sc, sx;
};

// A GN loop's carried state, L lanes each. As an input, all but R and t may
// be null: the loop's first iteration (every lane active, counters at 0).
struct GnState {
  float* R;                // (L, 3, 3) the rotation the loop carries
  float* t;                // (L, 3)
  float* R_out;            // (L, 3, 3) R projected onto SO(3)
  unsigned char* conv;     // (L,) bool
  int* n_eff;              // (L,)
  float* chi2;             // (L,)
  int* iters;              // (L,)
  unsigned char* active;   // (L,) bool
};

struct GnStepArgs {
  GnLin lin[2];            // lin[1].H null: one linearization
  const int* gate_count;   // null: gate on the (summed) count
  long long s_gate;
  GnState in, out;
  unsigned char* flag;     // one byte: any lane still active
  int lanes, min_effective, warm;
  float eps;
};

static __global__ void __launch_bounds__(kStepThreads) gn_step_kernel(const GnStepArgs a) {
  bool any = false;
  for (int l = threadIdx.x; l < a.lanes; l += blockDim.x) {
    const bool act = a.in.active == nullptr || a.in.active[l] != 0;
    if (!act) {
      // a lane that has stopped keeps everything: copy (a no-op in place)
      float keep[23];
#pragma unroll
      for (int e = 0; e < 9; ++e) {
        keep[e] = a.in.R[9 * l + e];
        keep[9 + e] = a.in.R_out[9 * l + e];
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) keep[18 + c] = a.in.t[3 * l + c];
      keep[21] = a.in.chi2[l];
      const int n = a.in.n_eff[l], its = a.in.iters[l];
      const unsigned char cv = a.in.conv[l];
#pragma unroll
      for (int e = 0; e < 9; ++e) {
        a.out.R[9 * l + e] = keep[e];
        a.out.R_out[9 * l + e] = keep[9 + e];
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) a.out.t[3 * l + c] = keep[18 + c];
      a.out.chi2[l] = keep[21];
      a.out.n_eff[l] = n;
      a.out.iters[l] = its;
      a.out.conv[l] = cv;
      a.out.active[l] = 0;
      continue;
    }
    float H[36], y[6];
    const GnLin& p = a.lin[0];
#pragma unroll
    for (int e = 0; e < 36; ++e) H[e] = p.H[p.sH * l + e];
#pragma unroll
    for (int i = 0; i < 6; ++i) y[i] = p.b[p.sb * l + i];
    int count = p.count[p.sc * l];
    float chi2 = p.chi2[p.sx * l];
    if (a.lin[1].H != nullptr) {
      const GnLin& q = a.lin[1];
#pragma unroll
      for (int e = 0; e < 36; ++e) H[e] = H[e] + q.H[q.sH * l + e];
#pragma unroll
      for (int i = 0; i < 6; ++i) y[i] = y[i] + q.b[q.sb * l + i];
      count += q.count[q.sc * l];
      chi2 = chi2 + q.chi2[q.sx * l];
    }
    const int gate = a.gate_count != nullptr ? a.gate_count[a.s_gate * l] : count;
    const bool ok = gate >= a.min_effective;
    if (a.warm) {
      // Marquardt damping relative to the largest diagonal entry
      float m = H[0];
#pragma unroll
      for (int i = 1; i < 6; ++i) {
        const float d = H[7 * i];
        m = (d > m || isnan(d)) ? d : m;
      }
      const float lam = 1e-2f * m + 1e-6f;
#pragma unroll
      for (int i = 0; i < 6; ++i)
#pragma unroll
        for (int j = 0; j < 6; ++j) H[6 * i + j] = H[6 * i + j] + lam * (i == j ? 1.f : 0.f);
    }
    solve6(H, y);
    float d[6];
#pragma unroll
    for (int i = 0; i < 6; ++i) d[i] = (ok && isfinite(y[i])) ? y[i] : 0.f;
    // so3_exp(d[0:3])
    const float theta2 = (d[0] * d[0] + d[1] * d[1]) + d[2] * d[2];
    const bool small = theta2 < 1e-8f;
    const float theta2_safe = small ? 1.f : theta2;
    const float theta_safe = sqrtf(theta2_safe);
    const float sa = small ? 1.f - theta2 / 6.f : sinf(theta_safe) / theta_safe;
    const float sb = small ? 0.5f - theta2 / 24.f : (1.f - cosf(theta_safe)) / theta2_safe;
    const float W[9] = {0.f, -d[2], d[1], d[2], 0.f, -d[0], -d[1], d[0], 0.f};
    float W2[9], E[9], Rl[9], Rn[9];
    matmul3(W, W, W2);
#pragma unroll
    for (int e = 0; e < 9; ++e) {
      E[e] = ((e % 4 == 0 ? 1.f : 0.f) + sa * W[e]) + sb * W2[e];
      Rl[e] = a.in.R[9 * l + e];
    }
    float tl[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) tl[c] = a.in.t[3 * l + c];
    const int its = a.in.iters != nullptr ? a.in.iters[l] : 0;
    matmul3(Rl, E, Rn);
    float s = d[0] * d[0];
#pragma unroll
    for (int i = 1; i < 6; ++i) s += d[i] * d[i];
    const bool conv = ok && sqrtf(s) < a.eps && !a.warm;
#pragma unroll
    for (int e = 0; e < 9; ++e) {
      a.out.R[9 * l + e] = Rn[e];
      Rl[e] = Rn[e];
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) a.out.t[3 * l + c] = tl[c] + d[3 + c];
    renormalize3(Rl);
#pragma unroll
    for (int e = 0; e < 9; ++e) a.out.R_out[9 * l + e] = Rl[e];
    a.out.conv[l] = conv ? 1 : 0;
    a.out.n_eff[l] = count;
    a.out.chi2[l] = chi2;
    a.out.iters[l] = its + 1;
    a.out.active[l] = conv ? 0 : 1;
    any = any || !conv;
  }
  any = __syncthreads_or(any) != 0;
  if (threadIdx.x == 0 && a.flag != nullptr) *a.flag = any ? 1 : 0;
}

static __global__ void __launch_bounds__(kUpdateThreads)
so3_renormalize_kernel(const float* __restrict__ R, int lanes, float* __restrict__ R_out) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  float Rl[9];
#pragma unroll
  for (int e = 0; e < 9; ++e) Rl[e] = R[9 * lane + e];
  renormalize3(Rl);
#pragma unroll
  for (int e = 0; e < 9; ++e) R_out[9 * lane + e] = Rl[e];
}

}  // namespace loc_fused

extern "C" int gn_step_launch(const loc_fused::GnStepArgs* args, void* stream) {
  using namespace loc_fused;
  if (args->lanes < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = args->lanes >= kStepThreads ? kStepThreads : ((args->lanes + 31) / 32) * 32;
  gn_step_kernel<<<1, threads, 0, static_cast<cudaStream_t>(stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int so3_renormalize_launch(const void* R, int lanes, void* R_out, void* stream) {
  using namespace loc_fused;
  const int blocks = (lanes + kUpdateThreads - 1) / kUpdateThreads;
  so3_renormalize_kernel<<<blocks, kUpdateThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(R), lanes, static_cast<float*>(R_out));
  return static_cast<int>(cudaGetLastError());
}
