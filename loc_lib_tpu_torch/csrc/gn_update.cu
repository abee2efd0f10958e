// The pose update of a Gauss-Newton iteration, and the final projection onto
// SO(3), for Hopper (sm_90a): two small elementwise kernels, one thread a
// match.
//
// In the reference (loc_lib_tpu/models/icp.py, the while_loop body of
// scan_match: the `where` filters, lie.se3_retract, the step norm and the
// stop test; lie.so3_renormalize on the way out) these are a few dozen
// scalar operations that XLA fuses into the loop's program. As torch ops
// they are ~45 launches an iteration (hat and so3_exp alone are 25) and ~18
// for the projection, each 5-10 us of host time, on a path that is bound by
// launches. Here they are one launch each:
//
//   gn_step          dx (L, 6), ok (L,), R (L, 3, 3), t (L, 3), eps, may_converge
//                    d      = ok and dx finite ? dx : 0          (entry by entry)
//                    R_out  = R exp(d[0:3])                      (Rodrigues, Taylor near 0)
//                    t_out  = t + d[3:6]
//                    conv   = ok and |d| < eps and may_converge
//   so3_renormalize  R (L, 3, 3) -> two Newton-Schulz polar iterations
//                    R <- 0.5 R (3 I - R^T R)
//
// A lane's result depends on that lane's inputs alone, so a batched match
// (L = B) gives each lane the bits of the scalar call (L = 1): the same
// thread program runs either way. The arithmetic follows the plain version
// (kernels.gn_step_plain, lie.so3_renormalize with lie.matmul3) operation
// by operation under -fmad=false: a 3x3 product entry is (p0 + p1) + p2.
//
// What bounds it: nothing on the card. A call moves 73 B a lane in and 49 B
// out; the work is ~250 float32 operations a lane. It costs one launch.
#include <cuda_runtime.h>

namespace loc_fused {

constexpr int kUpdateThreads = 128;

// C = A B for row-major 3x3, each entry (a_i0 b_0j + a_i1 b_1j) + a_i2 b_2j.
__device__ __forceinline__ void matmul3(const float* A, const float* B, float* C) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      C[3 * i + j] = (A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j]) + A[3 * i + 2] * B[6 + j];
}

static __global__ void __launch_bounds__(kUpdateThreads)
gn_step_kernel(const float* __restrict__ dx, const unsigned char* __restrict__ ok,
               const float* __restrict__ R, const float* __restrict__ t, float eps,
               int may_converge, int lanes, float* __restrict__ R_out,
               float* __restrict__ t_out, unsigned char* __restrict__ conv) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  const bool k = ok[lane] != 0;
  float d[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const float v = dx[6 * lane + i];
    d[i] = (k && isfinite(v)) ? v : 0.f;
  }
  // so3_exp(d[0:3])
  const float theta2 = (d[0] * d[0] + d[1] * d[1]) + d[2] * d[2];
  const bool small = theta2 < 1e-8f;
  const float theta2_safe = small ? 1.f : theta2;
  const float theta_safe = sqrtf(theta2_safe);
  const float a = small ? 1.f - theta2 / 6.f : sinf(theta_safe) / theta_safe;
  const float b = small ? 0.5f - theta2 / 24.f : (1.f - cosf(theta_safe)) / theta2_safe;
  const float W[9] = {0.f, -d[2], d[1], d[2], 0.f, -d[0], -d[1], d[0], 0.f};
  float W2[9], E[9], Rl[9], Rn[9];
  matmul3(W, W, W2);
#pragma unroll
  for (int e = 0; e < 9; ++e) {
    E[e] = ((e % 4 == 0 ? 1.f : 0.f) + a * W[e]) + b * W2[e];
    Rl[e] = R[9 * lane + e];
  }
  matmul3(Rl, E, Rn);
#pragma unroll
  for (int e = 0; e < 9; ++e) R_out[9 * lane + e] = Rn[e];
#pragma unroll
  for (int i = 0; i < 3; ++i) t_out[3 * lane + i] = t[3 * lane + i] + d[3 + i];
  float s = d[0] * d[0];
#pragma unroll
  for (int i = 1; i < 6; ++i) s += d[i] * d[i];
  conv[lane] = (k && sqrtf(s) < eps && may_converge != 0) ? 1 : 0;
}

static __global__ void __launch_bounds__(kUpdateThreads)
so3_renormalize_kernel(const float* __restrict__ R, int lanes, float* __restrict__ R_out) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  float Rl[9], Rt[9], M[9], Rn[9];
#pragma unroll
  for (int e = 0; e < 9; ++e) Rl[e] = R[9 * lane + e];
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
#pragma unroll
  for (int e = 0; e < 9; ++e) R_out[9 * lane + e] = Rl[e];
}

}  // namespace loc_fused

extern "C" int gn_step_launch(const void* dx, const void* ok, const void* R, const void* t,
                              float eps, int may_converge, int lanes, void* R_out,
                              void* t_out, void* conv, void* stream) {
  using namespace loc_fused;
  const int blocks = (lanes + kUpdateThreads - 1) / kUpdateThreads;
  gn_step_kernel<<<blocks, kUpdateThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dx), static_cast<const unsigned char*>(ok),
      static_cast<const float*>(R), static_cast<const float*>(t), eps, may_converge, lanes,
      static_cast<float*>(R_out), static_cast<float*>(t_out),
      static_cast<unsigned char*>(conv));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int so3_renormalize_launch(const void* R, int lanes, void* R_out, void* stream) {
  using namespace loc_fused;
  const int blocks = (lanes + kUpdateThreads - 1) / kUpdateThreads;
  so3_renormalize_kernel<<<blocks, kUpdateThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(R), lanes, static_cast<float*>(R_out));
  return static_cast<int>(cudaGetLastError());
}
