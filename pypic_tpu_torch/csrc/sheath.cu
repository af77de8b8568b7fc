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
//
// A float64 state (ROADMAP item 19a): every template takes the element
// type E last, and the `_f64` entry points launch its double
// instantiations. In double the field, the rows (ps, p0, u0, qm, w, act),
// the outputs, the thread columns, det_flush's partials and the scalars
// dt, dt/dx, c and wall_ratio (formed in float64 by the wrapper, as JAX's
// SMEM scalars are in the state's dtype) are double, each operation one
// __dmul_rn / __dadd_rn, so xh, x1, u1 and act1 equal the float64 plain
// version's bit for bit and the current equals it but for the order of
// its sums. The TPU kernel keeps a float32 current accumulator even for a
// float64 state (pallas_cic.py _sheath_call: the MXU's output type); that
// is TPU layout, and the port sums in float64. The columns take 8 B a
// node, so the small mode ends at 880 nodes (ops/cuda_sheath.py
// MAX_NG_F64; the deposit's 907), and above it the large mode sums each
// term in two int64 words (cic_common.cuh "Two-word sums"), the field in
// shared memory up to 28,928 nodes. The float instantiations compile to
// the same code as without E (tools/sass_diff.py). Bound on the
// H100 in double: 64 B a row for the pass (reads ps, p0, u0, qm, w, act;
// writes xh, act1) and 72 for the finalize; the large mode adds 16 B a
// node and the scale sweep's 48 B a row.

#include "cic_common.cuh"

namespace {

constexpr int kMaxThreads = 1024;

// One row of the sweep: the push (pos = x1 with FINAL, else xh; u1; the new
// status a1) and the deposit it makes: t0 at node l and, for an active
// row, t1 at node r (r = -1 for a wall row, whose one term is its
// surface charge at node 0 or ng - 1).
template <bool FINAL, typename E>
__device__ __forceinline__ void sheath_row(
    const E* f, int ng, E cells, E a, E x0, E v0, E psv, E qmv, E wi, E dt,
    E dt_dx, E c, E wall_ratio, E& pos, E& u1o, E& a1, int& l, int& r, E& t0,
    E& t1) {
  const bool is_act = a > (E)0.5;
  const E s = clamp_to(psv, (E)0, cells);
  const E e = gather(f, cic_bounded(s, ng));
  const E accel = mul_rn(qmv, e);
  E x1 = add_rn(add_rn(x0, mul_rn(dt_dx, v0)), mul_rn(c, accel));
  E u1 = add_rn(v0, mul_rn(dt, accel));
  E xh = (E)0, uh = (E)0;
  if (is_act) {
    xh = mul_rn((E)0.5, add_rn(x0, x1));
    uh = mul_rn((E)0.5, add_rn(v0, u1));
  } else {
    x1 = (E)0;
    u1 = (E)0;
  }
  const bool right = is_act && (x0 >= cells || xh >= cells || x1 >= cells);
  const bool left = is_act && (x0 <= (E)0 || xh <= (E)0 || x1 <= (E)0);
  a1 = left ? (E)-1 : (right ? (E)0 : a);
  pos = FINAL ? x1 : xh;
  u1o = u1;
  if (a1 > (E)0.5) {
    const E val = mul_rn(wi, FINAL ? u1 : uh);
    const CicT<E> cc = cic_bounded(FINAL ? x1 : xh, ng);
    l = cc.l;
    r = cc.r;
    t0 = mul_rn(val, cc.wl);
    t1 = mul_rn(val, cc.wr);
  } else if (a1 < (E)-0.5) {
    l = 0;
    r = -1;
    t0 = mul_rn(wi, wall_ratio);
  } else {
    l = ng - 1;
    r = -1;
    t0 = mul_rn(-wi, wall_ratio);
  }
}

// Block b sweeps rows [b rows_per_block, (b + 1) rows_per_block) (the
// last block up to n), four rows a thread a tile of 4T rows; rows_per_block
// is a multiple of 4, so the 16-B accesses of VEC stay aligned.
template <bool FINAL, bool VEC, typename E>
__global__ void __launch_bounds__(kMaxThreads) sheath_pass_kernel(
    const E* __restrict__ field, const E* __restrict__ ps,
    const E* __restrict__ p0, const E* __restrict__ u0,
    const E* __restrict__ qm, const E* __restrict__ w,
    const E* __restrict__ act, E* __restrict__ pos_out,
    E* __restrict__ u1_out, E* __restrict__ act1_out,
    E* __restrict__ j, E* __restrict__ partial,
    unsigned int* __restrict__ counter, long long n, long long rows_per_block,
    int ng, E dt, E dt_dx, E c, E wall_ratio) {
  // declared as floats so that the float kernel compiles to the same code
  // as without E (tools/sass_diff.py); the block's dynamic shared memory
  // starts 16-B aligned, which the doubles need
  extern __shared__ float smem[];
  E* s_field = reinterpret_cast<E*>(smem);
  E* s_hist = s_field + ng;  // column threadIdx.x of s_hist[node * T + t]
  const int T = blockDim.x;
  for (int i = threadIdx.x; i < ng; i += T) s_field[i] = field[i];
  for (int i = threadIdx.x; i < T * ng; i += T) s_hist[i] = (E)0;
  __syncthreads();
  E* mine = s_hist + threadIdx.x;
  const E cells = (E)(ng - 1);
  const long long lo = (long long)blockIdx.x * rows_per_block;
  const long long hi = min(n, lo + rows_per_block);
  for (long long i = lo + 4LL * threadIdx.x; i < hi; i += 4LL * T) {
    // rows at or past hi read as lost and are neither written nor deposited
    const auto a4 = load4<VEC>(act, i, hi, (E)0);
    const auto x04 = load4<VEC>(p0, i, hi, (E)0);
    const auto v04 = load4<VEC>(u0, i, hi, (E)0);
    const auto ps4 = load4<VEC>(ps, i, hi, (E)0);
    const auto qm4 = load4<VEC>(qm, i, hi, (E)0);
    const auto w4 = load4<VEC>(w, i, hi, (E)0);
    typename Vec4<E>::type pos4, u14, a14;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      int nl, nr;
      E t0, t1;
      sheath_row<FINAL>(s_field, ng, cells, get(a4, r), get(x04, r), get(v04, r),
                        get(ps4, r), get(qm4, r), get(w4, r), dt, dt_dx, c,
                        wall_ratio, at(pos4, r), at(u14, r), at(a14, r), nl, nr,
                        t0, t1);
      if (i + r >= hi) continue;
      mine[nl * T] = add_rn(mine[nl * T], t0);
      if (nr >= 0) mine[nr * T] = add_rn(mine[nr * T], t1);
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
// sums"; for double "Two-word sums", two words a term). SCALE: the first
// sweep, the largest |term| into bmax[block], acc zeroed, nothing written.
// Else the second: the outputs written and every term added, a block's
// wall charges summed first and added by one atomic a wall and word.
// SMEM_FIELD: the field in shared memory (ng <= field_smem_max_ng<E>),
// else read from device memory.
template <bool FINAL, bool VEC, bool SMEM_FIELD, bool SCALE, typename E>
__global__ void __launch_bounds__(kLargeThreads, 2) sheath_large_kernel(
    const E* __restrict__ field, const E* __restrict__ ps,
    const E* __restrict__ p0, const E* __restrict__ u0,
    const E* __restrict__ qm, const E* __restrict__ w,
    const E* __restrict__ act, E* __restrict__ pos_out,
    E* __restrict__ u1_out, E* __restrict__ act1_out,
    E* __restrict__ bmax, unsigned long long* __restrict__ acc,
    long long n, long long rows_per_block, int ng, E dt, E dt_dx,
    E c, E wall_ratio) {
  constexpr bool kTwo = fixed_words<E>() == 2;
  E* s_field = dynamic_smem<E>();
  __shared__ long long s_red[32];
  const int T = blockDim.x;
  const E* f = field;
  if (SMEM_FIELD) {
    for (int i = threadIdx.x; i < ng; i += T) s_field[i] = field[i];
    f = s_field;
  }
  double scale = 0.0, lscale = 0.0;
  if (SCALE)
    fixed_zero(acc, fixed_words<E>() * ng);
  else
    scale = fixed_scale(bmax, gridDim.x, n);  // its barriers cover the field's load
  if constexpr (kTwo) lscale = ldexp(1.0, fixed2_bits(n));
  if (SMEM_FIELD) __syncthreads();
  const E cells = (E)(ng - 1);
  const long long lo = (long long)blockIdx.x * rows_per_block;
  const long long hi = min(n, lo + rows_per_block);
  E m = (E)0;
  long long wall_left = 0, wall_right = 0, wall_left_lo = 0, wall_right_lo = 0;
  for (long long i = lo + 4LL * threadIdx.x; i < hi; i += 4LL * T) {
    const auto a4 = load4<VEC>(act, i, hi, (E)0);
    const auto x04 = load4<VEC>(p0, i, hi, (E)0);
    const auto v04 = load4<VEC>(u0, i, hi, (E)0);
    const auto ps4 = load4<VEC>(ps, i, hi, (E)0);
    const auto qm4 = load4<VEC>(qm, i, hi, (E)0);
    const auto w4 = load4<VEC>(w, i, hi, (E)0);
    typename Vec4<E>::type pos4, u14, a14;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      int nl, nr;
      E t0, t1;
      sheath_row<FINAL>(f, ng, cells, get(a4, r), get(x04, r), get(v04, r),
                        get(ps4, r), get(qm4, r), get(w4, r), dt, dt_dx, c,
                        wall_ratio, at(pos4, r), at(u14, r), at(a14, r), nl, nr,
                        t0, t1);
      if (i + r >= hi) continue;
      if (SCALE) {
        fixed_track(m, t0);
        if (nr >= 0) fixed_track(m, t1);
      } else if constexpr (kTwo) {
        if (nr >= 0) {
          fixed2_add(acc, ng, nl, t0, scale, lscale);
          fixed2_add(acc, ng, nr, t1, scale, lscale);
        } else {
          long long qh, ql;
          fixed2_q(t0, scale, lscale, qh, ql);
          if (nl == 0) {
            wall_left += qh;
            wall_left_lo += ql;
          } else {
            wall_right += qh;
            wall_right_lo += ql;
          }
        }
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
  if constexpr (kTwo) {
    wall_left_lo = block_sum(wall_left_lo, s_red);
    wall_right_lo = block_sum(wall_right_lo, s_red);
    if (threadIdx.x == 0) {
      if (wall_left_lo != 0) atomicAdd(acc + ng, (unsigned long long)wall_left_lo);
      if (wall_right_lo != 0)
        atomicAdd(acc + ng + (ng - 1), (unsigned long long)wall_right_lo);
    }
  }
}

template <bool FINAL, typename E>
cudaError_t launch_pass(int blocks, int threads, long long rows_per_block,
                        cudaStream_t s, const E* field, const E* ps,
                        const E* p0, const E* u0, const E* qm,
                        const E* w, const E* act, E* pos,
                        E* u1, E* act1, E* j, E* partial,
                        unsigned int* counter, long long n, int ng, E dt,
                        E dt_dx, E c, E wall_ratio) {
  if (threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
      rows_per_block % 4 != 0)
    return cudaErrorInvalidValue;
  const bool vec = aligned16(ps) && aligned16(p0) && aligned16(u0) &&
                   aligned16(qm) && aligned16(w) && aligned16(act) &&
                   aligned16(pos) && (!FINAL || aligned16(u1)) &&
                   aligned16(act1);
  const size_t smem = (size_t)(1 + threads) * ng * sizeof(E);
  cudaError_t err = vec ? allow_smem(sheath_pass_kernel<FINAL, true, E>, smem)
                        : allow_smem(sheath_pass_kernel<FINAL, false, E>, smem);
  if (err != cudaSuccess) return err;
  if (vec)
    sheath_pass_kernel<FINAL, true, E><<<blocks, threads, smem, s>>>(
        field, ps, p0, u0, qm, w, act, pos, u1, act1, j, partial, counter, n,
        rows_per_block, ng, dt, dt_dx, c, wall_ratio);
  else
    sheath_pass_kernel<FINAL, false, E><<<blocks, threads, smem, s>>>(
        field, ps, p0, u0, qm, w, act, pos, u1, act1, j, partial, counter, n,
        rows_per_block, ng, dt, dt_dx, c, wall_ratio);
  return cudaGetLastError();
}

template <bool FINAL, bool VEC, bool SMEM_FIELD, typename E>
cudaError_t launch_large_sweeps(int blocks, int threads, long long rows_per_block,
                                cudaStream_t s, const E* field,
                                const E* ps, const E* p0,
                                const E* u0, const E* qm,
                                const E* w, const E* act, E* pos,
                                E* u1, E* act1, E* bmax,
                                unsigned long long* acc, long long n, int ng,
                                E dt, E dt_dx, E c, E wall_ratio) {
  const size_t smem = SMEM_FIELD ? (size_t)ng * sizeof(E) : 0;
  cudaError_t err =
      allow_smem(sheath_large_kernel<FINAL, VEC, SMEM_FIELD, true, E>, smem);
  if (err != cudaSuccess) return err;
  err = allow_smem(sheath_large_kernel<FINAL, VEC, SMEM_FIELD, false, E>, smem);
  if (err != cudaSuccess) return err;
  sheath_large_kernel<FINAL, VEC, SMEM_FIELD, true, E><<<blocks, threads, smem, s>>>(
      field, ps, p0, u0, qm, w, act, pos, u1, act1, bmax, acc, n,
      rows_per_block, ng, dt, dt_dx, c, wall_ratio);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sheath_large_kernel<FINAL, VEC, SMEM_FIELD, false, E><<<blocks, threads, smem, s>>>(
      field, ps, p0, u0, qm, w, act, pos, u1, act1, bmax, acc, n,
      rows_per_block, ng, dt, dt_dx, c, wall_ratio);
  return cudaGetLastError();
}

// The large mode's three launches: the scale sweep, the deposit sweep and
// the conversion of the fixed-point sums into j.
template <bool FINAL, typename E>
cudaError_t launch_large(int blocks, int threads, long long rows_per_block,
                         cudaStream_t s, const E* field, const E* ps,
                         const E* p0, const E* u0, const E* qm,
                         const E* w, const E* act, E* pos,
                         E* u1, E* act1, E* j, E* bmax,
                         unsigned long long* acc, long long n, int ng,
                         E dt, E dt_dx, E c, E wall_ratio) {
  if (!large_shape_ok(ng, blocks, threads, rows_per_block))
    return cudaErrorInvalidValue;
  const bool vec = aligned16(ps) && aligned16(p0) && aligned16(u0) &&
                   aligned16(qm) && aligned16(w) && aligned16(act) &&
                   aligned16(pos) && (!FINAL || aligned16(u1)) &&
                   aligned16(act1);
  const bool smem_field = ng <= field_smem_max_ng<E>();
  cudaError_t err;
#define PYPIC_SHEATH_LARGE(VEC, SF)                                                \
  err = launch_large_sweeps<FINAL, VEC, SF, E>(blocks, threads, rows_per_block, s, \
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
                                 w, act, xh, (float*)nullptr, act1, jh, partial,
                                 counter, n, ng, dt, dt_dx, c, wall_ratio);
}

// The double pass (a float64 state): every pointer to doubles, partial
// blocks * ng doubles, every scalar a double (its _SIGNATURES entry
// passes them as c_double); the shape from launch_shape(..., item=8).
int pypic_sheath_picard_f64(const double* field, const double* ps, const double* p0,
                            const double* u0, const double* qm, const double* w,
                            const double* act, double* xh, double* act1, double* jh,
                            double* partial, unsigned int* counter, long long n,
                            int ng, double dt, double dt_dx, double c,
                            double wall_ratio, int blocks, int threads,
                            long long rows_per_block, void* stream) {
  return (int)launch_pass<false>(blocks, threads, rows_per_block,
                                 (cudaStream_t)stream, field, ps, p0, u0, qm,
                                 w, act, xh, (double*)nullptr, act1, jh, partial,
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

int pypic_sheath_finalize_f64(const double* field, const double* ps, const double* p0,
                              const double* u0, const double* qm, const double* w,
                              const double* act, double* x1, double* u1, double* act1,
                              double* j1, double* partial, unsigned int* counter,
                              long long n, int ng, double dt, double dt_dx, double c,
                              double wall_ratio, int blocks, int threads,
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
                                  w, act, xh, (float*)nullptr, act1, jh, bmax, acc, n,
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

// The double large mode: bmax blocks doubles, acc 2 ng int64 (the two
// words, cic_common.cuh "Two-word sums"); every scalar a double.
int pypic_sheath_picard_large_f64(const double* field, const double* ps,
                                  const double* p0, const double* u0,
                                  const double* qm, const double* w,
                                  const double* act, double* xh, double* act1,
                                  double* jh, double* bmax, unsigned long long* acc,
                                  long long n, int ng, double dt, double dt_dx,
                                  double c, double wall_ratio, int blocks,
                                  int threads, long long rows_per_block,
                                  void* stream) {
  return (int)launch_large<false>(blocks, threads, rows_per_block,
                                  (cudaStream_t)stream, field, ps, p0, u0, qm,
                                  w, act, xh, (double*)nullptr, act1, jh, bmax, acc,
                                  n, ng, dt, dt_dx, c, wall_ratio);
}

int pypic_sheath_finalize_large_f64(const double* field, const double* ps,
                                    const double* p0, const double* u0,
                                    const double* qm, const double* w,
                                    const double* act, double* x1, double* u1,
                                    double* act1, double* j1, double* bmax,
                                    unsigned long long* acc, long long n, int ng,
                                    double dt, double dt_dx, double c,
                                    double wall_ratio, int blocks, int threads,
                                    long long rows_per_block, void* stream) {
  return (int)launch_large<true>(blocks, threads, rows_per_block,
                                 (cudaStream_t)stream, field, ps, p0, u0, qm,
                                 w, act, x1, u1, act1, j1, bmax, acc, n, ng,
                                 dt, dt_dx, c, wall_ratio);
}

}  // extern "C"
