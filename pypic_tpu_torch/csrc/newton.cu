// The Newton-Boltzmann Dirichlet-Dirichlet Poisson solve in one launch,
// for Hopper (sm_90a).
//
// Replaces pypic_tpu/ops/pallas_newton.py:_newton_dd_kernel
// (boltzmann_dirichlet_pallas), the Newton solve of
//   F(phi) = A phi - dx^2 c0 exp(c1 phi) + dx^2 c2 = 0
// (pygcpic.py:1005-1053; A the Laplacian with identity wall rows, c0 =
// e n0 / eps0, c1 = e / (kB Te), c2 = rho / eps0): the residual build, the
// Jacobian, a parallel-cyclic-reduction (PCR) solve of the tridiagonal
// Newton system, the exponent clamp and step clip of ops.poisson
// (_EXP_CLAMP), the convergence test and the final shift to min 0 -- the
// whole loop inside the kernel, as on the TPU.
//
// Design:
// * One CTA of ngp = max(128, next power of two >= ng) threads, one row a
//   thread (ng <= 1024). Rows ng..ngp-1 are identity rows (a = c = 0,
//   b = 1, f = 0), which keep PCR inert there, as in the TPU kernel.
// * PCR: log2(ngp) stages. Each stage writes the thread's (a, b, c, f) to
//   one of two shared-memory buffers (8 ngp floats, 32 KB at ngp = 1024),
//   one __syncthreads, then reads the rows i - s and i + s. Alternating
//   buffers needs one barrier a stage: a thread writes stage k + 1's
//   buffer only after the barrier of stage k, by which every read of that
//   buffer (stage k - 1) is done.
// * The residual sum(dphi^2) is a fixed-order block sum (block_sum: warp
//   shuffles, then the warps' partials in warp order, in float64, rounded
//   to float32). Every thread computes the same bits, so every thread
//   takes the same branch of the loop test and all leave on the same
//   iteration.
// * n0 and the warm start are read through device pointers: n0 is the
//   output of the step's density update, and a host copy would cost the
//   step a host sync. c0 = f32(e / eps0) n0 and c2 = rho / f32(eps0) are
//   formed here in float32, as the JAX wrapper forms them; the warm start's
//   wall entries are pinned to 0.
// * The arithmetic follows the TPU kernel's operation order, with
//   __fmul_rn / __fadd_rn / __fdiv_rn so nvcc contracts nothing into an
//   FMA; expf is the libdevice (not fast-math) one.
//
// Bound on the H100: neither bytes nor operations (a few KB in and out,
// ~125 float32 operations a row an iteration) but latency: log2(ngp)
// barriers a PCR solve, two block reductions an iteration, all in one SM.
// Its yardstick is microseconds an iteration.

#include "cic_common.cuh"

namespace {

constexpr int kMaxRows = 1024;

// Parallel cyclic reduction of a_i x_{i-1} + b_i x_i + c_i x_{i+1} = f_i,
// rows 0..ngp-1, thread i holding row i; returns x_i. `buf` holds
// 8 ngp floats. Every thread of the block calls it.
__device__ float pcr_solve(float a, float b, float c, float f, float* buf,
                           int i, int ngp) {
  int k = 0;
  for (int s = 1; s < ngp; s <<= 1, k ^= 1) {
    float* A = buf + 4 * ngp * k;
    float* B = A + ngp;
    float* C = B + ngp;
    float* F = C + ngp;
    A[i] = a;
    B[i] = b;
    C[i] = c;
    F[i] = f;
    __syncthreads();
    float am = 0.0f, bm = 1.0f, cm = 0.0f, fm = 0.0f;
    float ap = 0.0f, bp = 1.0f, cp = 0.0f, fp = 0.0f;
    if (i >= s) {
      am = A[i - s];
      bm = B[i - s];
      cm = C[i - s];
      fm = F[i - s];
    }
    if (i < ngp - s) {
      ap = A[i + s];
      bp = B[i + s];
      cp = C[i + s];
      fp = F[i + s];
    }
    const float alpha = __fdiv_rn(-a, bm);
    const float gamma = __fdiv_rn(-c, bp);
    b = __fadd_rn(__fadd_rn(b, __fmul_rn(alpha, cm)), __fmul_rn(gamma, ap));
    f = __fadd_rn(__fadd_rn(f, __fmul_rn(alpha, fm)), __fmul_rn(gamma, fp));
    a = __fmul_rn(alpha, am);
    c = __fmul_rn(gamma, cp);
  }
  return __fdiv_rn(f, b);
}

// Block-wide minimum; every thread gets it. `red` holds 32 floats.
__device__ float block_min(float x, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int o = 16; o > 0; o >>= 1) x = fminf(x, __shfl_down_sync(0xffffffffu, x, o));
  __syncthreads();
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float t = red[0];
  for (int w = 1; w < nwarps; ++w) t = fminf(t, red[w]);
  return t;
}

__global__ void newton_dd_kernel(const float* __restrict__ rho,
                                 const float* __restrict__ n0,
                                 const float* __restrict__ phi0,
                                 float* __restrict__ phi_out,
                                 int* __restrict__ iters_out,
                                 float* __restrict__ resid_out, int ng,
                                 float c0_coef, float eps0, float c1,
                                 float dx2, float tol, int maxiter,
                                 float step_max, float exp_clamp) {
  extern __shared__ float smem[];
  const int ngp = blockDim.x;
  float* s_phi = smem;
  float* s_pcr = smem + ngp;
  __shared__ double s_red[32];
  __shared__ float s_redf[32];
  const int i = threadIdx.x;
  const bool valid = i < ng;
  const bool interior = i >= 1 && i <= ng - 2;
  const bool boundary = valid && !interior;
  const float a_lap = interior ? 1.0f : 0.0f;
  const float c_lap = a_lap;
  const float d_lap = interior ? -2.0f : 1.0f;
  const float c0 = __fmul_rn(c0_coef, n0[0]);
  const float c2 = valid ? __fdiv_rn(rho[i], eps0) : 0.0f;
  const float dx2_c0 = __fmul_rn(dx2, c0);
  const float dx2_c2 = __fmul_rn(dx2, c2);
  const float jac_b = __fmul_rn(__fmul_rn(-dx2, c0), c1);  // -dx^2 c0 c1
  float phi = 0.0f;
  if (phi0 != nullptr && interior) phi = phi0[i];  // walls pinned to 0

  float residual = 1.0f;
  int it = 0;
  while (residual > tol && it < maxiter) {
    s_phi[i] = phi;
    __syncthreads();
    const float down = i >= 1 ? s_phi[i - 1] : 0.0f;
    const float up = i + 1 < ngp ? s_phi[i + 1] : 0.0f;
    const float expo =
        expf(fminf(fmaxf(__fmul_rn(c1, phi), -exp_clamp), exp_clamp));
    const float lap = __fadd_rn(
        __fadd_rn(__fmul_rn(a_lap, down), __fmul_rn(d_lap, phi)),
        __fmul_rn(c_lap, up));
    float f = __fadd_rn(__fsub_rn(lap, __fmul_rn(dx2_c0, expo)), dx2_c2);
    f = interior ? f : 0.0f;  // walls and padding: residual rows 0
    const float ddiag =
        interior ? __fmul_rn(jac_b, expo) : (boundary ? jac_b : 0.0f);
    float dphi = pcr_solve(a_lap, __fadd_rn(d_lap, ddiag), c_lap, f, s_pcr, i, ngp);
    dphi = fminf(fmaxf(dphi, -step_max), step_max);
    phi = __fsub_rn(phi, dphi);
    residual = (float)block_sum((double)__fmul_rn(dphi, dphi), s_red);
    ++it;
  }
  // shift to min 0 over the physical rows (pygcpic.py:1053)
  const float lo = block_min(valid ? phi : 3.402823466e38f, s_redf);
  if (valid) phi_out[i] = __fsub_rn(phi, lo);
  if (i == 0) {
    iters_out[0] = it;
    resid_out[0] = residual;
  }
}

}  // namespace

extern "C" {

// phi0 may be null (cold start at 0). ngp: threads of the one CTA, a
// power of two in [128, 1024], >= ng.
int pypic_boltzmann_dirichlet(const float* rho, const float* n0,
                              const float* phi0, float* phi, int* iters,
                              float* resid, int ng, int ngp, float c0_coef,
                              float eps0, float c1, float dx2, float tol,
                              int maxiter, float step_max, float exp_clamp,
                              void* stream) {
  if (ngp > kMaxRows || ngp < 32 || (ngp & (ngp - 1)) || ng > ngp) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = 9 * (size_t)ngp * sizeof(float);
  cudaError_t err = allow_smem(newton_dd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  newton_dd_kernel<<<1, ngp, smem, (cudaStream_t)stream>>>(
      rho, n0, phi0, phi, iters, resid, ng, c0_coef, eps0, c1, dx2, tol,
      maxiter, step_max, exp_clamp);
  return (int)cudaGetLastError();
}

}  // extern "C"
