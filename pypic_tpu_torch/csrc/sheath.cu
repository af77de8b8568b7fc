// Particle kernels of the bounded two-species sheath engine, for Hopper
// (sm_90a).
//
// Replace pypic_tpu/ops/pallas_cic.py:_sheath_iter_kernel
// (sheath_picard_pallas) and _sheath_final_kernel (sheath_finalize_pallas),
// both through _sheath_call. One template, FINAL false or true, so the two
// compute every per-particle value the same way:
//
// * the bounded CIC gather of the field guess at clip(ps, 0, cells) --
//   cic_bounded clamps the left index but not the position, so the
//   position is clipped first, as the TPU kernel does;
// * the Crank-Nicolson push of active rows, in this order:
//   accel = qm e; x1 = (p0 + dt/dx u0) + c accel with c = 0.5 dt (dt/dx)
//   formed in float32 by the wrapper (the TPU kernel's SMEM scalars);
//   u1 = u0 + dt accel; xh = (p0 + x1)/2, uh = (u0 + u1)/2. Rows whose
//   status is not ACTIVE (act <= 0.5) hold x1 = u1 = xh = uh = 0;
// * the wall check on (p0, xh, x1): an active row goes LOST_RIGHT (0) if
//   any of them is >= cells and LOST_LEFT (-1) if any is <= 0, left
//   winning when both hold. A row lost in an earlier pass stays lost;
// * the current deposit with the wall surface charge folded in
//   (PIC_L_DD.py:41-68): an active row deposits w uh at xh (FINAL: w u1 at
//   x1), a lost-left row w (dx^2/dt) at node 0, a lost-right row
//   -w (dx^2/dt) at node ng - 1 -- every non-active row, including rows
//   lost in an earlier pass. The edge fold j[0] += j[1], j[-1] += j[-2]
//   is the caller's.
//
// Every product and sum is written with __fmul_rn / __fadd_rn so that nvcc
// contracts nothing into an FMA: xh, x1, u1 and act1 equal the plain
// PyTorch version's bit for bit. One thread a particle in a grid-stride
// loop; the (ng,) field lives in dynamic shared memory.
//
// The current is deterministic (cic_common.cuh det_flush): a histogram a
// thread in shared memory, summed by a fixed tree and in block order, no
// float atomics. The Picard loop's floor exit needs it: it stops once the
// residual ||es - eh|| falls below 0.5 eps ||es||, and with float atomics
// every pass would sum the deposit in a new order, so that at a small
// field the residual's floor is the atomics' noise (~1e-1 V/m at
// n = 12,000 against a threshold of ~2e-3), and the loop runs to maxiter.
//
// Bound on the H100: device-memory bytes. The Picard pass reads 24 B (ps,
// p0, u0, qm, w, act) and writes 8 B (xh, act1) a row, the finalize writes
// 12 B (x1, u1, act1). The thread histograms take (T + 1) ng floats of
// shared memory a block (52 KB at ng = 51, T = 256: four blocks an SM);
// the wrapper halves T for larger grids.

#include "cic_common.cuh"

namespace {

template <bool FINAL>
__global__ void sheath_pass_kernel(
    const float* __restrict__ field, const float* __restrict__ ps,
    const float* __restrict__ p0, const float* __restrict__ u0,
    const float* __restrict__ qm, const float* __restrict__ w,
    const float* __restrict__ act, float* __restrict__ pos_out,
    float* __restrict__ u1_out, float* __restrict__ act1_out,
    float* __restrict__ j, float* __restrict__ partial,
    unsigned int* __restrict__ counter, long long n, int ng, float dt,
    float dt_dx, float c, float wall_ratio) {
  extern __shared__ float smem[];
  float* s_field = smem;
  float* s_hist = smem + ng;  // column threadIdx.x of s_hist[node * T + t]
  const int T = blockDim.x;
  for (int i = threadIdx.x; i < ng; i += T) s_field[i] = field[i];
  for (int i = threadIdx.x; i < T * ng; i += T) s_hist[i] = 0.0f;
  __syncthreads();
  float* mine = s_hist + threadIdx.x;
  const float cells = (float)(ng - 1);
  const long long stride = (long long)gridDim.x * T;
  for (long long i = (long long)blockIdx.x * T + threadIdx.x; i < n;
       i += stride) {
    const float a = act[i];
    const float x0 = p0[i];
    const float v0 = u0[i];
    const bool is_act = a > 0.5f;
    const float s = fminf(fmaxf(ps[i], 0.0f), cells);
    const float e = gather(s_field, cic_bounded(s, ng));
    const float accel = __fmul_rn(qm[i], e);
    float x1 = __fadd_rn(__fadd_rn(x0, __fmul_rn(dt_dx, v0)), __fmul_rn(c, accel));
    float u1 = __fadd_rn(v0, __fmul_rn(dt, accel));
    float xh = 0.0f, uh = 0.0f;
    if (is_act) {
      xh = __fmul_rn(0.5f, __fadd_rn(x0, x1));
      uh = __fmul_rn(0.5f, __fadd_rn(v0, u1));
    } else {
      x1 = 0.0f;
      u1 = 0.0f;
    }
    const bool right = is_act && (x0 >= cells || xh >= cells || x1 >= cells);
    const bool left = is_act && (x0 <= 0.0f || xh <= 0.0f || x1 <= 0.0f);
    const float a1 = left ? -1.0f : (right ? 0.0f : a);
    if (FINAL) {
      pos_out[i] = x1;
      u1_out[i] = u1;
    } else {
      pos_out[i] = xh;
    }
    act1_out[i] = a1;
    const float wi = w[i];
    if (a1 > 0.5f) {
      const float val = __fmul_rn(wi, FINAL ? u1 : uh);
      const Cic cc = cic_bounded(FINAL ? x1 : xh, ng);
      mine[cc.l * T] = __fadd_rn(mine[cc.l * T], __fmul_rn(val, cc.wl));
      mine[cc.r * T] = __fadd_rn(mine[cc.r * T], __fmul_rn(val, cc.wr));
    } else if (a1 < -0.5f) {
      mine[0] = __fadd_rn(mine[0], __fmul_rn(wi, wall_ratio));
    } else {
      mine[(ng - 1) * T] = __fadd_rn(mine[(ng - 1) * T], __fmul_rn(-wi, wall_ratio));
    }
  }
  det_flush(s_hist, ng, partial, counter, j);
}

template <bool FINAL>
cudaError_t launch_pass(int blocks, int threads, cudaStream_t s,
                        const float* field, const float* ps, const float* p0,
                        const float* u0, const float* qm, const float* w,
                        const float* act, float* pos, float* u1, float* act1,
                        float* j, float* partial, unsigned int* counter,
                        long long n, int ng, float dt, float dt_dx, float c,
                        float wall_ratio) {
  const size_t smem = (size_t)(1 + threads) * ng * sizeof(float);
  cudaError_t err = allow_smem(sheath_pass_kernel<FINAL>, smem);
  if (err != cudaSuccess) return err;
  sheath_pass_kernel<FINAL><<<blocks, threads, smem, s>>>(
      field, ps, p0, u0, qm, w, act, pos, u1, act1, j, partial, counter, n,
      ng, dt, dt_dx, c, wall_ratio);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The Picard pass: xh, act1 (n,) and jh (ng,). partial: blocks * ng
// floats of scratch; counter: one unsigned int, 0 at the launch and left
// 0 (det_flush); threads: a power of two <= 256.
int pypic_sheath_picard(const float* field, const float* ps, const float* p0,
                        const float* u0, const float* qm, const float* w,
                        const float* act, float* xh, float* act1, float* jh,
                        float* partial, unsigned int* counter, long long n,
                        int ng, float dt, float dt_dx, float c,
                        float wall_ratio, int blocks, int threads,
                        void* stream) {
  return (int)launch_pass<false>(blocks, threads, (cudaStream_t)stream, field,
                                 ps, p0, u0, qm, w, act, xh, nullptr, act1, jh,
                                 partial, counter, n, ng, dt, dt_dx, c,
                                 wall_ratio);
}

// The finalize: x1, u1, act1 (n,) and j1 (ng,); partial and counter as
// for the pass.
int pypic_sheath_finalize(const float* field, const float* ps, const float* p0,
                          const float* u0, const float* qm, const float* w,
                          const float* act, float* x1, float* u1, float* act1,
                          float* j1, float* partial, unsigned int* counter,
                          long long n, int ng, float dt, float dt_dx, float c,
                          float wall_ratio, int blocks, int threads,
                          void* stream) {
  return (int)launch_pass<true>(blocks, threads, (cudaStream_t)stream, field,
                                ps, p0, u0, qm, w, act, x1, u1, act1, j1,
                                partial, counter, n, ng, dt, dt_dx, c,
                                wall_ratio);
}

}  // extern "C"
