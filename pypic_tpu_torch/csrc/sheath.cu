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
// PyTorch version's bit for bit.
//
// The current is deterministic: each thread adds its rows into its own
// (ng,) column of shared memory, in its rows' order, and the columns and
// then the blocks are summed in a fixed order -- no float atomics. The
// Picard loop's floor exit needs it: it stops once the residual
// ||es - eh|| falls below 0.5 eps ||es||, and with float atomics every
// pass would sum the deposit in a new order, so that at a small field the
// residual's floor is the atomics' noise (~1e-1 V/m at n = 12,000 against
// a threshold of ~2e-3), and the loop runs to maxiter.
//
// Bound on the H100: device-memory bytes. The Picard pass reads 24 B (ps,
// p0, u0, qm, w, act) and writes 8 B (xh, act1) a row, the finalize writes
// 12 B (x1, u1, act1): 32 and 36 B a row, whatever the rows' statuses.
//
// Design. The first port launched one wave of 256-thread blocks, four an
// SM (their 257 x 51 floats of columns capped it), and summed the columns
// with the first port's deterministic flush (a tree over the columns,
// then the last block's serial sum of the partials). At
// n = 1e6, ng = 51 the card split that pass's 0.040 ms into 0.006 for the
// sweep, 0.001 for zeroing and adding into the columns, 0.009 for the
// flush's 8-level tree over 51 nodes (a __syncthreads a level, 51 serial
// shared-memory adds per thread) and 0.024 for the last block's sum of
// 528 x 51 partials, whose tile loads from L2 ran one after another. So:
//
// * persistent blocks, two an SM where their columns fit (else one), of
//   the most threads up to 1,024 that allows -- 264 blocks of 512 at
//   ng = 51 -- each owning a contiguous range of rows, in order
//   (ops/cuda_sheath.py launch_shape: a function of n, ng and the SM
//   count alone, so the order of every sum is too). The ceiling is where
//   32 columns no longer fit a block: ng <= 1,760, as before;
// * four rows a thread with 16-B loads and stores, so 1,024 threads an SM
//   keep 96 B each in flight (the same kernel row by row when a pointer is
//   not 16-B aligned: a view at an odd offset);
// * the columns summed by warps, not a tree, and the block that takes the
//   last ticket summing the partials the same way, each lane's L2 loads
//   issued together before any is added (cic_common.cuh det_flush, which
//   the deterministic deposit shares).

#include "cic_common.cuh"

namespace {

constexpr int kMaxThreads = 1024;

// Block b sweeps rows [b rows_per_block, (b + 1) rows_per_block) (the
// last block up to n), four rows a thread a tile of 4T rows; rows_per_block
// is a multiple of 4, so the 16-B accesses of VEC stay aligned.
template <bool FINAL, bool VEC>
__global__ void __launch_bounds__(kMaxThreads) sheath_pass_kernel(
    const float* __restrict__ field, const float* __restrict__ ps,
    const float* __restrict__ p0, const float* __restrict__ u0,
    const float* __restrict__ qm, const float* __restrict__ w,
    const float* __restrict__ act, float* __restrict__ pos_out,
    float* __restrict__ u1_out, float* __restrict__ act1_out,
    float* __restrict__ j, float* __restrict__ partial,
    unsigned int* __restrict__ counter, long long n, long long rows_per_block,
    int ng, float dt, float dt_dx, float c, float wall_ratio) {
  extern __shared__ float smem[];
  float* s_field = smem;
  float* s_hist = smem + ng;  // column threadIdx.x of s_hist[node * T + t]
  const int T = blockDim.x;
  for (int i = threadIdx.x; i < ng; i += T) s_field[i] = field[i];
  for (int i = threadIdx.x; i < T * ng; i += T) s_hist[i] = 0.0f;
  __syncthreads();
  float* mine = s_hist + threadIdx.x;
  const float cells = (float)(ng - 1);
  const long long lo = (long long)blockIdx.x * rows_per_block;
  const long long hi = min(n, lo + rows_per_block);
  for (long long i = lo + 4LL * threadIdx.x; i < hi; i += 4LL * T) {
    // rows at or past hi read as lost and are neither written nor deposited
    const float4 a4 = load4<VEC>(act, i, hi, 0.0f);
    const float4 x04 = load4<VEC>(p0, i, hi, 0.0f);
    const float4 v04 = load4<VEC>(u0, i, hi, 0.0f);
    const float4 ps4 = load4<VEC>(ps, i, hi, 0.0f);
    const float4 qm4 = load4<VEC>(qm, i, hi, 0.0f);
    const float4 w4 = load4<VEC>(w, i, hi, 0.0f);
    float4 pos4, u14, a14;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float a = get(a4, r);
      const float x0 = get(x04, r);
      const float v0 = get(v04, r);
      const bool is_act = a > 0.5f;
      const float s = fminf(fmaxf(get(ps4, r), 0.0f), cells);
      const float e = gather(s_field, cic_bounded(s, ng));
      const float accel = __fmul_rn(get(qm4, r), e);
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
      at(pos4, r) = FINAL ? x1 : xh;
      at(u14, r) = u1;
      at(a14, r) = a1;
      if (i + r >= hi) continue;
      const float wi = get(w4, r);
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
    store4<VEC>(pos_out, i, hi, pos4);
    if (FINAL) store4<VEC>(u1_out, i, hi, u14);
    store4<VEC>(act1_out, i, hi, a14);
  }
  det_flush(s_hist, ng, partial, counter, j);
}

template <bool FINAL>
cudaError_t launch_pass(int blocks, int threads, long long rows_per_block,
                        cudaStream_t s, const float* field, const float* ps,
                        const float* p0, const float* u0, const float* qm,
                        const float* w, const float* act, float* pos,
                        float* u1, float* act1, float* j, float* partial,
                        unsigned int* counter, long long n, int ng, float dt,
                        float dt_dx, float c, float wall_ratio) {
  if (threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
      rows_per_block % 4 != 0)
    return cudaErrorInvalidValue;
  const bool vec = aligned16(ps) && aligned16(p0) && aligned16(u0) &&
                   aligned16(qm) && aligned16(w) && aligned16(act) &&
                   aligned16(pos) && (!FINAL || aligned16(u1)) &&
                   aligned16(act1);
  const size_t smem = (size_t)(1 + threads) * ng * sizeof(float);
  cudaError_t err = vec ? allow_smem(sheath_pass_kernel<FINAL, true>, smem)
                        : allow_smem(sheath_pass_kernel<FINAL, false>, smem);
  if (err != cudaSuccess) return err;
  if (vec)
    sheath_pass_kernel<FINAL, true><<<blocks, threads, smem, s>>>(
        field, ps, p0, u0, qm, w, act, pos, u1, act1, j, partial, counter, n,
        rows_per_block, ng, dt, dt_dx, c, wall_ratio);
  else
    sheath_pass_kernel<FINAL, false><<<blocks, threads, smem, s>>>(
        field, ps, p0, u0, qm, w, act, pos, u1, act1, j, partial, counter, n,
        rows_per_block, ng, dt, dt_dx, c, wall_ratio);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The Picard pass: xh, act1 (n,) and jh (ng,). partial: blocks * ng
// floats of scratch; counter: one unsigned int, 0 at the launch and left
// 0; blocks, threads (a multiple of 32, <= 1024) and rows_per_block (a
// multiple of 4, blocks * rows_per_block >= n) from
// ops/cuda_sheath.py launch_shape.
int pypic_sheath_picard(const float* field, const float* ps, const float* p0,
                        const float* u0, const float* qm, const float* w,
                        const float* act, float* xh, float* act1, float* jh,
                        float* partial, unsigned int* counter, long long n,
                        int ng, float dt, float dt_dx, float c,
                        float wall_ratio, int blocks, int threads,
                        long long rows_per_block, void* stream) {
  return (int)launch_pass<false>(blocks, threads, rows_per_block,
                                 (cudaStream_t)stream, field, ps, p0, u0, qm,
                                 w, act, xh, nullptr, act1, jh, partial,
                                 counter, n, ng, dt, dt_dx, c, wall_ratio);
}

// The finalize: x1, u1, act1 (n,) and j1 (ng,); the rest as for the pass.
int pypic_sheath_finalize(const float* field, const float* ps, const float* p0,
                          const float* u0, const float* qm, const float* w,
                          const float* act, float* x1, float* u1, float* act1,
                          float* j1, float* partial, unsigned int* counter,
                          long long n, int ng, float dt, float dt_dx, float c,
                          float wall_ratio, int blocks, int threads,
                          long long rows_per_block, void* stream) {
  return (int)launch_pass<true>(blocks, threads, rows_per_block,
                                (cudaStream_t)stream, field, ps, p0, u0, qm,
                                w, act, x1, u1, act1, j1, partial, counter, n,
                                ng, dt, dt_dx, c, wall_ratio);
}

}  // extern "C"
