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
//   count alone, so the order of every sum is too). The columns fit a
//   block up to ng = 1,760 (MAX_NG, the field beside 32 columns);
// * four rows a thread with 16-B loads and stores, so 1,024 threads an SM
//   keep 96 B each in flight (the same kernel row by row when a pointer is
//   not 16-B aligned: a view at an odd offset);
// * the columns summed by warps, not a tree, and the block that takes the
//   last ticket summing the partials the same way, each lane's L2 loads
//   issued together before any is added (cic_common.cuh det_flush, which
//   the deterministic deposit shares).
//
// Above 1,760 nodes: the large mode (sheath_large_kernel; launch_shape's
// `large`, up to LARGE_MAX_NG = 2^22 nodes), the same push and terms with
// the current as int64 fixed-point sums in device memory (cic_common.cuh
// "Large deterministic sums"). The small mode stays as it was at every ng
// it fits. Two designs were priced, per row at the 1e7-row loads:
// * (a) bucket the rows by node tiles of at most 1,760 nodes (a stable
//   counting sort: block counts, a fixed-order scan, ranks from ballots),
//   then the columns and det_flush a tile. The terms' positions come out
//   of the push, so the sweep writes (tile, position, value), ~12 B a row,
//   and the sort reads and writes them twice more (~40 B), in four to five
//   launches, with a tile's columns, flush and partials for each of the
//   ng / 1,760 tiles, and the load of a tile following the plasma;
// * (b) fixed point: a scale sweep that reads the 24 B the push needs and
//   takes the largest |term|, then the sweep again with its 8-12 B of
//   writes and two 64-bit atomics a row into ng int64 in L2 (a wall row's
//   charge summed in its block first, one atomic a wall and block), then
//   one conversion launch: ~56-60 B a row in three launches, and bits
//   that depend on no order or grid.
// (b) is the one taken: fewer bytes and launches, no sort, and its sums
// are exact below the scale's rounding (2^-(k+1) a term, at most n M
// 2^-61 with M the largest |term|: 4.3e-12 M a term at 1e7 rows), where
// (a) keeps float32 sums. The field is read from shared memory up
// to 57,856 nodes (kFieldSmemMaxNg) and from device memory above it.

#include "cic_common.cuh"

namespace {

constexpr int kMaxThreads = 1024;

// One row of the sweep: the push (pos = x1 with FINAL, else xh; u1; the new
// status a1) and the deposit it makes: t0 at node l and, for an active
// row, t1 at node r (r = -1 for a wall row, whose one term is its
// surface charge at node 0 or ng - 1).
template <bool FINAL>
__device__ __forceinline__ void sheath_row(
    const float* f, int ng, float cells, float a, float x0, float v0,
    float psv, float qmv, float wi, float dt, float dt_dx, float c,
    float wall_ratio, float& pos, float& u1o, float& a1, int& l, int& r,
    float& t0, float& t1) {
  const bool is_act = a > 0.5f;
  const float s = fminf(fmaxf(psv, 0.0f), cells);
  const float e = gather(f, cic_bounded(s, ng));
  const float accel = __fmul_rn(qmv, e);
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
  a1 = left ? -1.0f : (right ? 0.0f : a);
  pos = FINAL ? x1 : xh;
  u1o = u1;
  if (a1 > 0.5f) {
    const float val = __fmul_rn(wi, FINAL ? u1 : uh);
    const Cic cc = cic_bounded(FINAL ? x1 : xh, ng);
    l = cc.l;
    r = cc.r;
    t0 = __fmul_rn(val, cc.wl);
    t1 = __fmul_rn(val, cc.wr);
  } else if (a1 < -0.5f) {
    l = 0;
    r = -1;
    t0 = __fmul_rn(wi, wall_ratio);
  } else {
    l = ng - 1;
    r = -1;
    t0 = __fmul_rn(-wi, wall_ratio);
  }
}

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
      int nl, nr;
      float t0, t1;
      sheath_row<FINAL>(s_field, ng, cells, get(a4, r), get(x04, r), get(v04, r),
                        get(ps4, r), get(qm4, r), get(w4, r), dt, dt_dx, c,
                        wall_ratio, at(pos4, r), at(u14, r), at(a14, r), nl, nr,
                        t0, t1);
      if (i + r >= hi) continue;
      mine[nl * T] = __fadd_rn(mine[nl * T], t0);
      if (nr >= 0) mine[nr * T] = __fadd_rn(mine[nr * T], t1);
    }
    store4<VEC>(pos_out, i, hi, pos4);
    if (FINAL) store4<VEC>(u1_out, i, hi, u14);
    store4<VEC>(act1_out, i, hi, a14);
  }
  det_flush(s_hist, ng, partial, counter, j);
}

// The large mode (ng above the columns' ceiling, ops/cuda_sheath.py
// launch_shape's `large`): the same rows a block, the current as int64
// fixed-point sums in device memory (cic_common.cuh "Large deterministic
// sums"). SCALE: the first sweep, the largest |term| into bmax[block],
// acc zeroed, nothing written. Else the second: the outputs written and
// every term added, a block's wall charges summed first and added by one
// atomic a wall. SMEM_FIELD: the field in shared memory (ng <=
// kFieldSmemMaxNg), else read from device memory.
template <bool FINAL, bool VEC, bool SMEM_FIELD, bool SCALE>
__global__ void __launch_bounds__(kLargeThreads, 2) sheath_large_kernel(
    const float* __restrict__ field, const float* __restrict__ ps,
    const float* __restrict__ p0, const float* __restrict__ u0,
    const float* __restrict__ qm, const float* __restrict__ w,
    const float* __restrict__ act, float* __restrict__ pos_out,
    float* __restrict__ u1_out, float* __restrict__ act1_out,
    float* __restrict__ bmax, unsigned long long* __restrict__ acc,
    long long n, long long rows_per_block, int ng, float dt, float dt_dx,
    float c, float wall_ratio) {
  extern __shared__ float s_field[];
  __shared__ long long s_red[32];
  const int T = blockDim.x;
  const float* f = field;
  if (SMEM_FIELD) {
    for (int i = threadIdx.x; i < ng; i += T) s_field[i] = field[i];
    f = s_field;
  }
  double scale = 0.0;
  if (SCALE)
    fixed_zero(acc, ng);
  else
    scale = fixed_scale(bmax, gridDim.x, n);  // its barriers cover the field's load
  if (SMEM_FIELD) __syncthreads();
  const float cells = (float)(ng - 1);
  const long long lo = (long long)blockIdx.x * rows_per_block;
  const long long hi = min(n, lo + rows_per_block);
  float m = 0.0f;
  long long wall_left = 0, wall_right = 0;
  for (long long i = lo + 4LL * threadIdx.x; i < hi; i += 4LL * T) {
    const float4 a4 = load4<VEC>(act, i, hi, 0.0f);
    const float4 x04 = load4<VEC>(p0, i, hi, 0.0f);
    const float4 v04 = load4<VEC>(u0, i, hi, 0.0f);
    const float4 ps4 = load4<VEC>(ps, i, hi, 0.0f);
    const float4 qm4 = load4<VEC>(qm, i, hi, 0.0f);
    const float4 w4 = load4<VEC>(w, i, hi, 0.0f);
    float4 pos4, u14, a14;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      int nl, nr;
      float t0, t1;
      sheath_row<FINAL>(f, ng, cells, get(a4, r), get(x04, r), get(v04, r),
                        get(ps4, r), get(qm4, r), get(w4, r), dt, dt_dx, c,
                        wall_ratio, at(pos4, r), at(u14, r), at(a14, r), nl, nr,
                        t0, t1);
      if (i + r >= hi) continue;
      if (SCALE) {
        fixed_track(m, t0);
        if (nr >= 0) fixed_track(m, t1);
      } else if (nr >= 0) {
        fixed_add(acc, nl, t0, scale);
        fixed_add(acc, nr, t1, scale);
      } else if (nl == 0) {
        wall_left += fixed_q(t0, scale);
      } else {
        wall_right += fixed_q(t0, scale);
      }
    }
    if (!SCALE) {
      store4<VEC>(pos_out, i, hi, pos4);
      if (FINAL) store4<VEC>(u1_out, i, hi, u14);
      store4<VEC>(act1_out, i, hi, a14);
    }
  }
  if (SCALE) {
    fixed_scale_out(m, bmax);
    return;
  }
  wall_left = block_sum(wall_left, s_red);
  wall_right = block_sum(wall_right, s_red);
  if (threadIdx.x == 0) {
    if (wall_left != 0) atomicAdd(acc, (unsigned long long)wall_left);
    if (wall_right != 0) atomicAdd(acc + (ng - 1), (unsigned long long)wall_right);
  }
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

template <bool FINAL, bool VEC, bool SMEM_FIELD>
cudaError_t launch_large_sweeps(int blocks, int threads, long long rows_per_block,
                                cudaStream_t s, const float* field,
                                const float* ps, const float* p0,
                                const float* u0, const float* qm,
                                const float* w, const float* act, float* pos,
                                float* u1, float* act1, float* bmax,
                                unsigned long long* acc, long long n, int ng,
                                float dt, float dt_dx, float c,
                                float wall_ratio) {
  const size_t smem = SMEM_FIELD ? (size_t)ng * sizeof(float) : 0;
  cudaError_t err = allow_smem(sheath_large_kernel<FINAL, VEC, SMEM_FIELD, true>, smem);
  if (err != cudaSuccess) return err;
  err = allow_smem(sheath_large_kernel<FINAL, VEC, SMEM_FIELD, false>, smem);
  if (err != cudaSuccess) return err;
  sheath_large_kernel<FINAL, VEC, SMEM_FIELD, true><<<blocks, threads, smem, s>>>(
      field, ps, p0, u0, qm, w, act, pos, u1, act1, bmax, acc, n,
      rows_per_block, ng, dt, dt_dx, c, wall_ratio);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sheath_large_kernel<FINAL, VEC, SMEM_FIELD, false><<<blocks, threads, smem, s>>>(
      field, ps, p0, u0, qm, w, act, pos, u1, act1, bmax, acc, n,
      rows_per_block, ng, dt, dt_dx, c, wall_ratio);
  return cudaGetLastError();
}

// The large mode's three launches: the scale sweep, the deposit sweep and
// the conversion of the fixed-point sums into j.
template <bool FINAL>
cudaError_t launch_large(int blocks, int threads, long long rows_per_block,
                         cudaStream_t s, const float* field, const float* ps,
                         const float* p0, const float* u0, const float* qm,
                         const float* w, const float* act, float* pos,
                         float* u1, float* act1, float* j, float* bmax,
                         unsigned long long* acc, long long n, int ng,
                         float dt, float dt_dx, float c, float wall_ratio) {
  if (!large_shape_ok(ng, blocks, threads, rows_per_block))
    return cudaErrorInvalidValue;
  const bool vec = aligned16(ps) && aligned16(p0) && aligned16(u0) &&
                   aligned16(qm) && aligned16(w) && aligned16(act) &&
                   aligned16(pos) && (!FINAL || aligned16(u1)) &&
                   aligned16(act1);
  const bool smem_field = ng <= kFieldSmemMaxNg;
  cudaError_t err;
#define PYPIC_SHEATH_LARGE(VEC, SF)                                             \
  err = launch_large_sweeps<FINAL, VEC, SF>(blocks, threads, rows_per_block, s, \
                                            field, ps, p0, u0, qm, w, act, pos, \
                                            u1, act1, bmax, acc, n, ng, dt,     \
                                            dt_dx, c, wall_ratio)
  if (vec) {
    if (smem_field) { PYPIC_SHEATH_LARGE(true, true); } else { PYPIC_SHEATH_LARGE(true, false); }
  } else {
    if (smem_field) { PYPIC_SHEATH_LARGE(false, true); } else { PYPIC_SHEATH_LARGE(false, false); }
  }
#undef PYPIC_SHEATH_LARGE
  if (err != cudaSuccess) return err;
  return launch_fixed_out(acc, bmax, blocks, n, ng, j, s);
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

// The large mode (ops/cuda_sheath.py launch_shape's `large`, ng above the
// columns' ceiling): the pass and the finalize as above, with bmax
// (blocks floats) and acc (ng int64) in the place of partial and counter;
// threads a multiple of 32, <= 512.
int pypic_sheath_picard_large(const float* field, const float* ps,
                              const float* p0, const float* u0,
                              const float* qm, const float* w,
                              const float* act, float* xh, float* act1,
                              float* jh, float* bmax, unsigned long long* acc,
                              long long n, int ng, float dt, float dt_dx,
                              float c, float wall_ratio, int blocks,
                              int threads, long long rows_per_block,
                              void* stream) {
  return (int)launch_large<false>(blocks, threads, rows_per_block,
                                  (cudaStream_t)stream, field, ps, p0, u0, qm,
                                  w, act, xh, nullptr, act1, jh, bmax, acc, n,
                                  ng, dt, dt_dx, c, wall_ratio);
}

int pypic_sheath_finalize_large(const float* field, const float* ps,
                                const float* p0, const float* u0,
                                const float* qm, const float* w,
                                const float* act, float* x1, float* u1,
                                float* act1, float* j1, float* bmax,
                                unsigned long long* acc, long long n, int ng,
                                float dt, float dt_dx, float c,
                                float wall_ratio, int blocks, int threads,
                                long long rows_per_block, void* stream) {
  return (int)launch_large<true>(blocks, threads, rows_per_block,
                                 (cudaStream_t)stream, field, ps, p0, u0, qm,
                                 w, act, x1, u1, act1, j1, bmax, acc, n, ng,
                                 dt, dt_dx, c, wall_ratio);
}

}  // extern "C"
