// Particle kernels of the magnetized Boltzmann-electron engine, for Hopper
// (sm_90a).
//
// Three kernels, each the counterpart of a Pallas TPU kernel in
// pypic_tpu/ops/pallas_cic.py, with plain CIC index arithmetic
// (cic_common.cuh) in place of the TPU kernels' tent windows and one-hot
// contractions. boris_kernel runs a thread a particle in a grid-stride
// loop; each block of the two deposits sweeps a contiguous range of rows
// (below). The (ng,) arrays a block reads or accumulates live in dynamic
// shared memory.
// Every product and sum is written with __fmul_rn / __fadd_rn /
// __fsub_rn / __fdiv_rn, so nvcc contracts nothing into an FMA and each
// operation rounds as the plain PyTorch version's does. A launcher
// returns cudaGetLastError(); it allocates nothing and runs on the stream
// it is given.

#include "cic_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// The deposits' grid and flush (deposit2_kernel, boris_deposit_kernel)
//
// The first port launched 8 blocks of 256 threads an SM (1,056 on the
// H100), one row a thread per pass, each block with one (ng,) shared-memory
// histogram an array, and flushed every node of every block's histograms by
// a global float atomic: 1.27 M atomics onto 4.8 KB at the configs[3] row
// (n = 999,996, ng = 600). The split (tools/resident_split.py --kernel
// deposit2|boris_deposit; PERF.md §6) put 10.8 of deposit2's 23.5
// µs there in that flush and 8.1 in the shared-memory adds: this card runs
// a float atomicAdd to shared memory as a compare-and-swap loop, a few
// lanes a clock an SM and ~0.2 µs a round trip. The grid now comes in two
// widths (ops/cuda_cic.py deposit_launch_shape, a function of n, ng and
// the SM count alone):
//
// * wide, where every thread of one 1,024-thread block an SM has a group
//   of four rows: one wave of such blocks, each sweeping a contiguous range
//   of rows four at a time with 16-B loads and stores (row by row where a
//   pointer is not 16-B aligned), each histogram in `cols` lane columns,
//   node k's column j at h[k cols + j], lane l adding into column
//   l mod cols. At 32 columns a warp's adds land on 32 distinct words and
//   banks, and the adds run at their best rate (8 and 16 columns: +38%
//   and +13% a launch). The columns halve where shared memory cannot hold
//   them, down to 1, so the ceilings stay where one column puts them. 132
//   blocks flush 158 K atomics where 1,056 flushed 1.27 M;
// * narrow, below that n (the D-N row's 50,000 rows, the carried row's
//   16,384-row patch): the first port's grid (a row a thread, grid-stride,
//   256 threads, as many blocks as the rows fill up to 8 an SM, one
//   column), where a launch is mostly its fixed cost. The wide grid at
//   these shapes reads 40-55% slower; a row's four adds issued as
//   concurrent compare-and-swaps in place of four atomicAdd loops saved
//   nothing there (nor at configs[3], where they cost 14%).
//
// The flush: after a block barrier a thread takes a node, sums its columns
// from the node's own on (a warp's 32 nodes start on 32 banks) and adds
// the total to the zeroed output by one global float atomic an array. The
// split priced a cluster reduction in its place (8-block clusters summing
// each node range through distributed shared memory, then one atomic a
// node and cluster, or partial rows summed by the block that takes the
// last ticket, outputs written whole): the card holds 15 such clusters at
// once (120 of 132 SMs), each cluster barrier costs ~0.75 µs and the
// tickets' tail ~2 µs, against ~2 µs for the 132 blocks' atomics; it read
// 15.8 µs against 12.6 at configs[3]. So the outputs come zeroed, a memset
// a call, as in the first port. The grid's helpers and the flush live in
// cic_common.cuh, which the single deposit (cic.cu) shares.
//
// Above the columns' ceiling (one lane column of the two histograms, and
// for the carried deposit the field and its clamp count's 16 static bytes
// beside them: 29,056 and 19,369 nodes)
// the same grid runs the large mode, cols 0 (deposit2_global_kernel,
// boris_deposit_global_kernel, kernels of their own so that the column
// kernels' compiled code stays as it was): no shared histogram, every add a global
// float atomic (red.global.add.f32) into the zeroed outputs, which stay in
// the 50 MB L2 at these sizes; the carried deposit's field stays in shared
// memory up to 57,856 nodes and is read from device memory above. Both
// kernels were float-atomic already, so their contract (the plain
// versions' tolerances) holds unchanged; the large mode runs up to
// LARGE_MAX_NG = 2^22 nodes.
// ---------------------------------------------------------------------------

// ---------------------------------------------------------------------------
// deposit2
//
// Replaces pypic_tpu/ops/pallas_cic.py:_deposit2_kernel (deposit2_pallas):
// two CIC deposits sharing one particle sweep and one index/weight
// computation, the rho and number-density pair of the Boltzmann weighting
// (pygcpic.py:841-905). Bounded or periodic, as deposit_kernel.
//
// Positions outside the grid: the magnetized engine keeps wall-lost slots
// at p < 0 or p > ng - 1 with weight 0. cic_bounded clamps the left index
// into [0, ng - 2] before the weights are taken (ops/cic.py
// cic_indices_weights), so such a particle adds a zero at nodes inside
// the histogram and never addresses outside it.
//
// Bound on the H100: device-memory bytes, 12 B read per particle (p, va,
// vb); at the configs[3] row the adds (four a particle) weigh as much as
// the bytes. The grid, columns and flush above.
// ---------------------------------------------------------------------------
template <bool PERIODIC, int ROWS, bool VEC>
__global__ void __launch_bounds__(1024, 1)
    deposit2_kernel(const float* __restrict__ p, const float* __restrict__ va,
                    const float* __restrict__ vb, float* __restrict__ out_a,
                    float* __restrict__ out_b, long long n, int ng, int cols) {
  extern __shared__ float4 smem4[];
  float* h_a = reinterpret_cast<float*>(smem4);
  float* h_b = h_a + (size_t)ng * cols;
  zero_shared(h_a, 2 * ng * cols);
  __syncthreads();
  if (ROWS == 1) {  // narrow: a row a thread, grid-stride, one column
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += stride) {
      const Cic c = PERIODIC ? cic_periodic(p[i], ng) : cic_bounded(p[i], ng);
      const float a = va[i];
      const float b = vb[i];
      atomicAdd(&h_a[c.l], __fmul_rn(a, c.wl));
      atomicAdd(&h_a[c.r], __fmul_rn(a, c.wr));
      atomicAdd(&h_b[c.l], __fmul_rn(b, c.wl));
      atomicAdd(&h_b[c.r], __fmul_rn(b, c.wr));
    }
  } else {  // wide: groups of four rows, lane columns
    const int col = threadIdx.x & (cols - 1);
    long long lo, hi;
    block_groups(n, lo, hi);
    const long long end = min(n, 4 * hi);
    for (long long g = lo + threadIdx.x; g < hi; g += blockDim.x) {
      const long long i = 4 * g;
      const float4 p4 = load4<VEC>(p, i, end, 0.0f);
      const float4 a4 = load4<VEC>(va, i, end, 0.0f);
      const float4 b4 = load4<VEC>(vb, i, end, 0.0f);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (i + r >= end) break;
        const Cic c = PERIODIC ? cic_periodic(get(p4, r), ng) : cic_bounded(get(p4, r), ng);
        const float a = get(a4, r);
        const float b = get(b4, r);
        atomicAdd(&h_a[c.l * cols + col], __fmul_rn(a, c.wl));
        atomicAdd(&h_a[c.r * cols + col], __fmul_rn(a, c.wr));
        atomicAdd(&h_b[c.l * cols + col], __fmul_rn(b, c.wl));
        atomicAdd(&h_b[c.r * cols + col], __fmul_rn(b, c.wr));
      }
    }
  }
  flush_columns<ROWS, 2, false>(h_a, ng, cols, out_a, out_b);
}

// The large mode (deposit_launch_shape's cols 0: above 29,056 nodes, where
// one lane column of the two histograms no longer fits a block): no
// shared histogram, each row's four adds a global float atomic
// (red.global.add.f32) into the zeroed outputs, which a launch touches in
// L2 (2 x 4 B a node: 32 MiB at 2^22 nodes). The same rows a block and
// thread as deposit2_kernel's grid.
template <bool PERIODIC, int ROWS, bool VEC>
__global__ void __launch_bounds__(1024, 1)
    deposit2_global_kernel(const float* __restrict__ p, const float* __restrict__ va,
                           const float* __restrict__ vb, float* __restrict__ out_a,
                           float* __restrict__ out_b, long long n, int ng) {
  if (ROWS == 1) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += stride) {
      const Cic c = PERIODIC ? cic_periodic(p[i], ng) : cic_bounded(p[i], ng);
      const float a = va[i];
      const float b = vb[i];
      atomicAdd(out_a + c.l, __fmul_rn(a, c.wl));
      atomicAdd(out_a + c.r, __fmul_rn(a, c.wr));
      atomicAdd(out_b + c.l, __fmul_rn(b, c.wl));
      atomicAdd(out_b + c.r, __fmul_rn(b, c.wr));
    }
  } else {
    long long lo, hi;
    block_groups(n, lo, hi);
    const long long end = min(n, 4 * hi);
    for (long long g = lo + threadIdx.x; g < hi; g += blockDim.x) {
      const long long i = 4 * g;
      const float4 p4 = load4<VEC>(p, i, end, 0.0f);
      const float4 a4 = load4<VEC>(va, i, end, 0.0f);
      const float4 b4 = load4<VEC>(vb, i, end, 0.0f);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (i + r >= end) break;
        const Cic c = PERIODIC ? cic_periodic(get(p4, r), ng) : cic_bounded(get(p4, r), ng);
        const float a = get(a4, r);
        const float b = get(b4, r);
        atomicAdd(out_a + c.l, __fmul_rn(a, c.wl));
        atomicAdd(out_a + c.r, __fmul_rn(a, c.wr));
        atomicAdd(out_b + c.l, __fmul_rn(b, c.wl));
        atomicAdd(out_b + c.r, __fmul_rn(b, c.wr));
      }
    }
  }
}

// The gather position: pc = clip(p, 0, ng - 1); with SWAP (the reference's
// swapped intra-cell weights, pygcpic.py:343-347) the cell-mirrored
// clip(2 floor(pc) + 1 - pc, 0, ng - 1), in that operation order.
template <bool SWAP>
__device__ __forceinline__ float gather_position(float p, float hi) {
  float pc = fminf(fmaxf(p, 0.0f), hi);
  if (SWAP) {
    pc = __fsub_rn(__fadd_rn(__fmul_rn(2.0f, floorf(pc)), 1.0f), pc);
    pc = fminf(fmaxf(pc, 0.0f), hi);
  }
  return pc;
}

// The Boris-Buneman velocity update in a constant B (pygcpic.py:460-507)
// in the TPU kernel's order: the half kick cst ex, the rotation with
// t = cst b, inv = 2 / (1 + t^2), s = t inv, the second half kick.
__device__ __forceinline__ void boris_rotate(float ex, float cst, float vx0,
                                             float vy0, float vz0, float bx,
                                             float by, float bz, float& vx,
                                             float& vy, float& vz) {
  const float kick = __fmul_rn(cst, ex);
  vx = __fadd_rn(vx0, kick);
  const float tx = __fmul_rn(cst, bx);
  const float ty = __fmul_rn(cst, by);
  const float tz = __fmul_rn(cst, bz);
  const float t2 = __fadd_rn(__fadd_rn(__fmul_rn(tx, tx), __fmul_rn(ty, ty)),
                             __fmul_rn(tz, tz));
  const float inv = __fdiv_rn(2.0f, __fadd_rn(1.0f, t2));
  const float sx = __fmul_rn(tx, inv);
  const float sy = __fmul_rn(ty, inv);
  const float sz = __fmul_rn(tz, inv);
  const float vfx = __fsub_rn(__fadd_rn(vx, __fmul_rn(vy0, tz)), __fmul_rn(vz0, ty));
  const float vfy = __fsub_rn(__fadd_rn(vy0, __fmul_rn(vz0, tx)), __fmul_rn(vx, tz));
  const float vfz = __fsub_rn(__fadd_rn(vz0, __fmul_rn(vx, ty)), __fmul_rn(vy0, tx));
  vx = __fadd_rn(vx, __fsub_rn(__fmul_rn(vfy, sz), __fmul_rn(vfz, sy)));
  vy = __fadd_rn(vy0, __fsub_rn(__fmul_rn(vfz, sx), __fmul_rn(vfx, sz)));
  vz = __fadd_rn(vz0, __fsub_rn(__fmul_rn(vfx, sy), __fmul_rn(vfy, sx)));
  vx = __fadd_rn(vx, kick);
}

// ---------------------------------------------------------------------------
// boris_gather_push
//
// Replaces pypic_tpu/ops/pallas_cic.py:_boris_kernel
// (boris_gather_push_pallas): the bounded CIC gather of E_x and the
// Boris-Buneman push in a constant B (pygcpic.py:460-507), one sweep.
//
// * The gather position is pc = clip(p, 0, ng - 1); with SWAP (the
//   reference's swapped intra-cell weights, pygcpic.py:343-347,
//   gather_weights='reference') it is the cell-mirrored
//   clip(2 floor(pc) + 1 - pc, 0, ng - 1), in that operation order.
// * The rotation in the TPU kernel's order: inv = 2 / (1 + t^2),
//   s = t inv, and the drift in grid coordinates p1 = p + vx dt/dx.
// * A particle with act == 0 stores its inputs unchanged, bit for bit.
//
// Bound on the H100: device-memory bytes, 24 B read (p, vx, vy, vz,
// const, act) and 16 B written (p1, vx1, vy1, vz1) per particle; the
// field sits in shared memory. The lateral drift y + dt vy, z + dt vz stays
// outside, as in the JAX engine.
//
// Above 58,112 nodes (the field alone no longer fits a block) MODE is
// kGlobal (cic_common.cuh): the gather reads its two nodes from device
// memory through the read-only path. Bound there: the rows' 40 B and the
// field's 4 B a node read once.
// ---------------------------------------------------------------------------
template <bool SWAP, int MODE>
__global__ void boris_kernel(const float* __restrict__ field,
                             const float* __restrict__ p_in,
                             const float* __restrict__ vx_in,
                             const float* __restrict__ vy_in,
                             const float* __restrict__ vz_in,
                             const float* __restrict__ c_in,
                             const float* __restrict__ act_in,
                             float* __restrict__ p_out,
                             float* __restrict__ vx_out,
                             float* __restrict__ vy_out,
                             float* __restrict__ vz_out, long long n, int ng,
                             float bx, float by, float bz, float dt_dx) {
  extern __shared__ float s_field[];
  load_field<MODE>(s_field, field, ng);
  __syncthreads();
  const float hi = (float)(ng - 1);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float p = p_in[i];
    const float vx0 = vx_in[i];
    const float vy0 = vy_in[i];
    const float vz0 = vz_in[i];
    if (!(act_in[i] > 0.0f)) {
      p_out[i] = p;
      vx_out[i] = vx0;
      vy_out[i] = vy0;
      vz_out[i] = vz0;
      continue;
    }
    const float pc = gather_position<SWAP>(p, hi);
    float vx, vy, vz;
    boris_rotate(gather_mode<MODE>(s_field, field, cic_bounded(pc, ng)), c_in[i],
                 vx0, vy0, vz0, bx, by, bz, vx, vy, vz);
    p_out[i] = __fadd_rn(p, __fmul_rn(vx, dt_dx));
    vx_out[i] = vx;
    vy_out[i] = vy;
    vz_out[i] = vz;
  }
}


// ---------------------------------------------------------------------------
// boris_gather_push_deposit
//
// Replaces pypic_tpu/ops/pallas_cic.py:_boris_deposit_kernel
// (boris_gather_push_deposit_pallas, carried_deposit='on'): the sweep of
// boris_kernel, plus the deposit that opens the NEXT step, of wr (rho)
// and wn (number density) at the new position p1, for rows whose p1 lies
// in [0, ng - 1] (this step's wall hits deposit nothing). The weights
// arrive masked (0 in inactive slots); an inactive row keeps p1 = p and
// its velocities, bit for bit.
//
// The TPU kernel deposits through the window of its GATHER at pc (the
// mirrored position with SWAP), widened by `pad` rows a side: window k =
// clip(int(floor(pc) * (1/stride)), 0, K - 1) of _choose_window's frame
// (stride, width), rows l = 0 .. wp - 1 (wp = width + 2 pad) at nodes
// stride k - pad + l. The deposit row is
//   d_h = (pc - stride k) + (p1 - pc) + pad,
// the true p1 seen from that frame with the correct intra-cell weights.
// A d_h outside [0, wp - 1] clamps to that edge and, where wn > 0, is
// counted: the tent then lands at the window's edge node, in the grid but
// misplaced, which the count makes visible. Here the frame is kept as
// arithmetic only (it decides the clamps): the tent goes into one
// whole-grid histogram, at node stride k - pad + floor(d_h) and the next,
// with weights 1 - frac(d_h) and frac(d_h), the TPU tent's values; a node
// outside [0, ng) takes nothing, as the TPU fold drops it.
//
// Bound on the H100: device-memory bytes, 32 B read (p, vx, vy, vz,
// const, act, wr, wn) and 16 B written (p1, vx1, vy1, vz1) a particle.
// The grid, columns and flush are deposit2's (above); the field sits in
// shared memory after the columns. The clamp count is summed by warps into
// the block's and added by one integer atomic a block.
// ---------------------------------------------------------------------------
// One row of the carried sweep: the push (p1, vx, vy, vz; an inactive row
// keeps its inputs) and the deposit's four adds into h_r (the rho columns,
// then the n columns), idx[k] -1 where the row adds nothing there; a
// clamped deposit with wn > 0 counts.
template <bool SWAP>
__device__ __forceinline__ void boris_row(
    const float* s_field, int ng, int cols, int col, float p, float vx0,
    float vy0, float vz0, float cst, float act, float wr, float wn, float bx,
    float by, float bz, float dt_dx, int win_stride, int num_k,
    float inv_stride, int pad, int wp, float& p1, float& vx, float& vy,
    float& vz, int (&idx)[4], float (&val)[4], int& clamped) {
  const float hi = (float)(ng - 1);
  const float pc = gather_position<SWAP>(p, hi);
  p1 = p;
  vx = vx0;
  vy = vy0;
  vz = vz0;
  if (act > 0.0f) {
    boris_rotate(gather(s_field, cic_bounded(pc, ng)), cst, vx0, vy0, vz0, bx,
                 by, bz, vx, vy, vz);
    p1 = __fadd_rn(p, __fmul_rn(vx, dt_dx));
  }
  idx[0] = idx[1] = idx[2] = idx[3] = -1;
  if (!(p1 >= 0.0f && p1 <= hi) || (wr == 0.0f && wn == 0.0f)) return;
  const float top = (float)(wp - 1);
  const int k = min(max((int)__fmul_rn(floorf(pc), inv_stride), 0), num_k - 1);
  const float d_s = __fsub_rn(pc, (float)(k * win_stride));
  float d_h = __fadd_rn(__fadd_rn(d_s, __fsub_rn(p1, pc)), (float)pad);
  if (d_h < 0.0f || d_h > top) {
    if (wn > 0.0f) ++clamped;
    d_h = fminf(fmaxf(d_h, 0.0f), top);
  }
  const float row = floorf(d_h);
  const float fr = __fsub_rn(d_h, row);
  const float fl = __fsub_rn(1.0f, fr);
  const int l = win_stride * k - pad + (int)row;
  if (l >= 0 && l < ng) {
    idx[0] = l * cols + col;
    idx[1] = (ng + l) * cols + col;
  }
  if (l + 1 >= 0 && l + 1 < ng) {
    idx[2] = (l + 1) * cols + col;
    idx[3] = (ng + l + 1) * cols + col;
  }
  val[0] = __fmul_rn(wr, fl);
  val[1] = __fmul_rn(wn, fl);
  val[2] = __fmul_rn(wr, fr);
  val[3] = __fmul_rn(wn, fr);
}

template <bool SWAP, int ROWS, bool VEC>
__global__ void __launch_bounds__(1024, 1) boris_deposit_kernel(
    const float* __restrict__ field, const float* __restrict__ p_in,
    const float* __restrict__ vx_in, const float* __restrict__ vy_in,
    const float* __restrict__ vz_in, const float* __restrict__ c_in,
    const float* __restrict__ act_in, const float* __restrict__ wr_in,
    const float* __restrict__ wn_in, float* __restrict__ p_out,
    float* __restrict__ vx_out, float* __restrict__ vy_out,
    float* __restrict__ vz_out, float* __restrict__ rho,
    float* __restrict__ dens, int* __restrict__ n_clamped, long long n, int ng,
    int cols, float bx, float by, float bz, float dt_dx, int win_stride,
    int num_k, float inv_stride, int pad, int wp) {
  extern __shared__ float4 smem4[];
  float* h_r = reinterpret_cast<float*>(smem4);  // then the n columns
  float* s_field = h_r + (size_t)2 * ng * cols;
  __shared__ int s_clamped;
  zero_shared(h_r, 2 * ng * cols);
  for (int i = threadIdx.x; i < ng; i += blockDim.x) s_field[i] = field[i];
  if (threadIdx.x == 0) s_clamped = 0;
  __syncthreads();
  int clamped = 0;
  int idx[4];
  float val[4];
  if (ROWS == 1) {  // narrow: a row a thread, grid-stride, one column
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += stride) {
      float p1, vx, vy, vz;
      boris_row<SWAP>(s_field, ng, 1, 0, p_in[i], vx_in[i], vy_in[i], vz_in[i],
                      c_in[i], act_in[i], wr_in[i], wn_in[i], bx, by, bz, dt_dx,
                      win_stride, num_k, inv_stride, pad, wp, p1, vx, vy, vz, idx,
                      val, clamped);
      p_out[i] = p1;
      vx_out[i] = vx;
      vy_out[i] = vy;
      vz_out[i] = vz;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (idx[k] >= 0) atomicAdd(h_r + idx[k], val[k]);
    }
  } else {  // wide: groups of four rows, lane columns
    const int col = threadIdx.x & (cols - 1);
    long long lo, hi;
    block_groups(n, lo, hi);
    const long long end = min(n, 4 * hi);
    for (long long g = lo + threadIdx.x; g < hi; g += blockDim.x) {
      // rows at or past `end` read as inactive with weight 0 and are not written
      const long long i = 4 * g;
      const float4 p4 = load4<VEC>(p_in, i, end, 0.0f);
      const float4 vx4 = load4<VEC>(vx_in, i, end, 0.0f);
      const float4 vy4 = load4<VEC>(vy_in, i, end, 0.0f);
      const float4 vz4 = load4<VEC>(vz_in, i, end, 0.0f);
      const float4 c4 = load4<VEC>(c_in, i, end, 0.0f);
      const float4 act4 = load4<VEC>(act_in, i, end, 0.0f);
      const float4 wr4 = load4<VEC>(wr_in, i, end, 0.0f);
      const float4 wn4 = load4<VEC>(wn_in, i, end, 0.0f);
      float4 p14, vx14, vy14, vz14;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        boris_row<SWAP>(s_field, ng, cols, col, get(p4, r), get(vx4, r), get(vy4, r),
                        get(vz4, r), get(c4, r), get(act4, r), get(wr4, r),
                        get(wn4, r), bx, by, bz, dt_dx, win_stride, num_k, inv_stride,
                        pad, wp, at(p14, r), at(vx14, r), at(vy14, r), at(vz14, r), idx,
                        val, clamped);
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (idx[k] >= 0) atomicAdd(h_r + idx[k], val[k]);
      }
      store4<VEC>(p_out, i, end, p14);
      store4<VEC>(vx_out, i, end, vx14);
      store4<VEC>(vy_out, i, end, vy14);
      store4<VEC>(vz_out, i, end, vz14);
    }
  }
  clamped = __reduce_add_sync(0xffffffffu, clamped);
  if ((threadIdx.x & 31) == 0 && clamped) atomicAdd(&s_clamped, clamped);
  flush_columns<ROWS, 2, false>(h_r, ng, cols, rho, dens);
  if (threadIdx.x == 0 && s_clamped) atomicAdd(n_clamped, s_clamped);
}

// The large mode (cols 0: above 19,369 nodes, where one lane column of the
// two histograms, the field and the clamp count no longer fit a block): boris_row's four
// adds go by global float atomics into the zeroed rho and dens (its
// indices with one column: node l of rho at l, of dens at ng + l); the
// field sits in shared memory up to kFieldSmemMaxNg nodes (SMEM_FIELD) and
// is read from device memory above. The clamps are counted as above.
template <bool SWAP, int ROWS, bool VEC, bool SMEM_FIELD>
__global__ void __launch_bounds__(1024, 1) boris_deposit_global_kernel(
    const float* __restrict__ field, const float* __restrict__ p_in,
    const float* __restrict__ vx_in, const float* __restrict__ vy_in,
    const float* __restrict__ vz_in, const float* __restrict__ c_in,
    const float* __restrict__ act_in, const float* __restrict__ wr_in,
    const float* __restrict__ wn_in, float* __restrict__ p_out,
    float* __restrict__ vx_out, float* __restrict__ vy_out,
    float* __restrict__ vz_out, float* __restrict__ rho,
    float* __restrict__ dens, int* __restrict__ n_clamped, long long n, int ng,
    float bx, float by, float bz, float dt_dx, int win_stride, int num_k,
    float inv_stride, int pad, int wp) {
  extern __shared__ float4 smem4[];
  __shared__ int s_clamped;
  const float* f = field;
  if (SMEM_FIELD) {
    float* s_field = reinterpret_cast<float*>(smem4);
    for (int i = threadIdx.x; i < ng; i += blockDim.x) s_field[i] = field[i];
    f = s_field;
  }
  if (threadIdx.x == 0) s_clamped = 0;
  __syncthreads();
  int clamped = 0;
  int idx[4];
  float val[4];
  if (ROWS == 1) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += stride) {
      float p1, vx, vy, vz;
      boris_row<SWAP>(f, ng, 1, 0, p_in[i], vx_in[i], vy_in[i], vz_in[i],
                      c_in[i], act_in[i], wr_in[i], wn_in[i], bx, by, bz, dt_dx,
                      win_stride, num_k, inv_stride, pad, wp, p1, vx, vy, vz, idx,
                      val, clamped);
      p_out[i] = p1;
      vx_out[i] = vx;
      vy_out[i] = vy;
      vz_out[i] = vz;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (idx[k] >= 0) atomicAdd(idx[k] < ng ? rho + idx[k] : dens + (idx[k] - ng), val[k]);
    }
  } else {
    long long lo, hi;
    block_groups(n, lo, hi);
    const long long end = min(n, 4 * hi);
    for (long long g = lo + threadIdx.x; g < hi; g += blockDim.x) {
      const long long i = 4 * g;
      const float4 p4 = load4<VEC>(p_in, i, end, 0.0f);
      const float4 vx4 = load4<VEC>(vx_in, i, end, 0.0f);
      const float4 vy4 = load4<VEC>(vy_in, i, end, 0.0f);
      const float4 vz4 = load4<VEC>(vz_in, i, end, 0.0f);
      const float4 c4 = load4<VEC>(c_in, i, end, 0.0f);
      const float4 act4 = load4<VEC>(act_in, i, end, 0.0f);
      const float4 wr4 = load4<VEC>(wr_in, i, end, 0.0f);
      const float4 wn4 = load4<VEC>(wn_in, i, end, 0.0f);
      float4 p14, vx14, vy14, vz14;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        boris_row<SWAP>(f, ng, 1, 0, get(p4, r), get(vx4, r), get(vy4, r),
                        get(vz4, r), get(c4, r), get(act4, r), get(wr4, r),
                        get(wn4, r), bx, by, bz, dt_dx, win_stride, num_k, inv_stride,
                        pad, wp, at(p14, r), at(vx14, r), at(vy14, r), at(vz14, r), idx,
                        val, clamped);
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (idx[k] >= 0)
            atomicAdd(idx[k] < ng ? rho + idx[k] : dens + (idx[k] - ng), val[k]);
      }
      store4<VEC>(p_out, i, end, p14);
      store4<VEC>(vx_out, i, end, vx14);
      store4<VEC>(vy_out, i, end, vy14);
      store4<VEC>(vz_out, i, end, vz14);
    }
  }
  clamped = __reduce_add_sync(0xffffffffu, clamped);
  if ((threadIdx.x & 31) == 0 && clamped) atomicAdd(&s_clamped, clamped);
  __syncthreads();
  if (threadIdx.x == 0 && s_clamped) atomicAdd(n_clamped, s_clamped);
}

}  // namespace

extern "C" {

// out_a, out_b: ng zeroed floats each; rows, blocks, threads and cols from
// ops/cuda_cic.py deposit_launch_shape (cols 0: the large mode).
int pypic_deposit2(const float* p, const float* va, const float* vb,
                   float* out_a, float* out_b, long long n, int ng, int periodic,
                   int rows, int blocks, int threads, int cols, void* stream) {
  if (!deposit_shape_ok(n, ng, rows, blocks, threads, cols, true))
    return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)ng * cols * sizeof(float);
  const bool vec = aligned16(p) && aligned16(va) && aligned16(vb);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (cols == 0) {  // the large mode
#define PYPIC_DEPOSIT2_GLOBAL(PER, ROWS, VEC)                                   \
  deposit2_global_kernel<PER, ROWS, VEC><<<blocks, threads, 0, s>>>(            \
      p, va, vb, out_a, out_b, n, ng);                                          \
  return (int)cudaGetLastError()
    if (periodic) {
      if (rows == 1) { PYPIC_DEPOSIT2_GLOBAL(true, 1, false); }
      if (vec) { PYPIC_DEPOSIT2_GLOBAL(true, 4, true); }
      PYPIC_DEPOSIT2_GLOBAL(true, 4, false);
    }
    if (rows == 1) { PYPIC_DEPOSIT2_GLOBAL(false, 1, false); }
    if (vec) { PYPIC_DEPOSIT2_GLOBAL(false, 4, true); }
    PYPIC_DEPOSIT2_GLOBAL(false, 4, false);
#undef PYPIC_DEPOSIT2_GLOBAL
  }
#define PYPIC_DEPOSIT2(PER, ROWS, VEC)                                          \
  err = allow_smem(deposit2_kernel<PER, ROWS, VEC>, smem);                      \
  if (err != cudaSuccess) return (int)err;                                      \
  deposit2_kernel<PER, ROWS, VEC><<<blocks, threads, smem, s>>>(                \
      p, va, vb, out_a, out_b, n, ng, cols);                                    \
  return (int)cudaGetLastError()
  if (periodic) {
    if (rows == 1) { PYPIC_DEPOSIT2(true, 1, false); }
    if (vec) { PYPIC_DEPOSIT2(true, 4, true); }
    PYPIC_DEPOSIT2(true, 4, false);
  }
  if (rows == 1) { PYPIC_DEPOSIT2(false, 1, false); }
  if (vec) { PYPIC_DEPOSIT2(false, 4, true); }
  PYPIC_DEPOSIT2(false, 4, false);
#undef PYPIC_DEPOSIT2
}

// mode: ops/cuda_cic.py smem_mode (0 shared, 1 global).
int pypic_boris_gather_push(const float* field, const float* p,
                            const float* vx, const float* vy, const float* vz,
                            const float* c, const float* act, float* p1,
                            float* vx1, float* vy1, float* vz1, long long n,
                            int ng, float bx, float by, float bz, float dt_dx,
                            int swap, int mode, int blocks, int threads,
                            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return (int)with_mode(mode, [&](auto m) {
    constexpr int MODE = decltype(m)::value;
    const size_t smem = mode_floats(MODE, 1, ng) * sizeof(float);
    cudaError_t err;
    if (swap) {
      err = allow_smem(boris_kernel<true, MODE>, smem);
      if (err != cudaSuccess) return err;
      boris_kernel<true, MODE><<<blocks, threads, smem, s>>>(
          field, p, vx, vy, vz, c, act, p1, vx1, vy1, vz1, n, ng, bx, by, bz, dt_dx);
    } else {
      err = allow_smem(boris_kernel<false, MODE>, smem);
      if (err != cudaSuccess) return err;
      boris_kernel<false, MODE><<<blocks, threads, smem, s>>>(
          field, p, vx, vy, vz, c, act, p1, vx1, vy1, vz1, n, ng, bx, by, bz, dt_dx);
    }
    return cudaGetLastError();
  });
}


// rho, dens: ng zeroed floats each; n_clamped: one zeroed int; rows,
// blocks, threads and cols as pypic_deposit2's.
int pypic_boris_gather_push_deposit(
    const float* field, const float* p, const float* vx, const float* vy,
    const float* vz, const float* c, const float* act, const float* wr,
    const float* wn, float* p1, float* vx1, float* vy1, float* vz1, float* rho,
    float* dens, int* n_clamped, long long n, int ng, float bx, float by,
    float bz, float dt_dx, int swap, int win_stride, int num_k,
    float inv_stride, int pad, int rows, int blocks, int threads, int cols,
    void* stream) {
  if (!deposit_shape_ok(n, ng, rows, blocks, threads, cols, true))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (2 * (size_t)cols + 1) * ng * sizeof(float);
  const int wp = win_stride + 2 + 2 * pad;  // width = stride + 2
  const bool vec = aligned16(p) && aligned16(vx) && aligned16(vy) &&
                   aligned16(vz) && aligned16(c) && aligned16(act) &&
                   aligned16(wr) && aligned16(wn) && aligned16(p1) &&
                   aligned16(vx1) && aligned16(vy1) && aligned16(vz1);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (cols == 0) {  // the large mode: the field alone in shared memory, or none
    const bool smem_field = ng <= kFieldSmemMaxNg;
    const size_t fsmem = smem_field ? (size_t)ng * sizeof(float) : 0;
#define PYPIC_BORIS_GLOBAL(SW, ROWS, VEC, SF)                                   \
  err = allow_smem(boris_deposit_global_kernel<SW, ROWS, VEC, SF>, fsmem);      \
  if (err != cudaSuccess) return (int)err;                                      \
  boris_deposit_global_kernel<SW, ROWS, VEC, SF><<<blocks, threads, fsmem, s>>>( \
      field, p, vx, vy, vz, c, act, wr, wn, p1, vx1, vy1, vz1, rho, dens,       \
      n_clamped, n, ng, bx, by, bz, dt_dx, win_stride, num_k, inv_stride, pad,  \
      wp);                                                                      \
  return (int)cudaGetLastError()
#define PYPIC_BORIS_GLOBAL_ROWS(SW, SF)                                         \
  if (rows == 1) { PYPIC_BORIS_GLOBAL(SW, 1, false, SF); }                      \
  if (vec) { PYPIC_BORIS_GLOBAL(SW, 4, true, SF); }                             \
  PYPIC_BORIS_GLOBAL(SW, 4, false, SF)
    if (swap) {
      if (smem_field) { PYPIC_BORIS_GLOBAL_ROWS(true, true); }
      PYPIC_BORIS_GLOBAL_ROWS(true, false);
    }
    if (smem_field) { PYPIC_BORIS_GLOBAL_ROWS(false, true); }
    PYPIC_BORIS_GLOBAL_ROWS(false, false);
#undef PYPIC_BORIS_GLOBAL_ROWS
#undef PYPIC_BORIS_GLOBAL
  }
#define PYPIC_BORIS_DEP(SW, ROWS, VEC)                                          \
  err = allow_smem(boris_deposit_kernel<SW, ROWS, VEC>, smem);                  \
  if (err != cudaSuccess) return (int)err;                                      \
  boris_deposit_kernel<SW, ROWS, VEC><<<blocks, threads, smem, s>>>(            \
      field, p, vx, vy, vz, c, act, wr, wn, p1, vx1, vy1, vz1, rho, dens,       \
      n_clamped, n, ng, cols, bx, by, bz, dt_dx, win_stride, num_k, inv_stride, \
      pad, wp);                                                                 \
  return (int)cudaGetLastError()
  if (swap) {
    if (rows == 1) { PYPIC_BORIS_DEP(true, 1, false); }
    if (vec) { PYPIC_BORIS_DEP(true, 4, true); }
    PYPIC_BORIS_DEP(true, 4, false);
  }
  if (rows == 1) { PYPIC_BORIS_DEP(false, 1, false); }
  if (vec) { PYPIC_BORIS_DEP(false, 4, true); }
  PYPIC_BORIS_DEP(false, 4, false);
#undef PYPIC_BORIS_DEP
}

}  // extern "C"
