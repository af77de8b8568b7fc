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
//
// A float64 state (the magnetized engine under x64): each template takes
// the element type T last and the `_f64` entry points launch its double
// instantiations, every scalar passed as a double (cic_common.cuh's
// mul_rn, add_rn, sub_rn: one rounding in double an operation, as the
// plain versions' float64 operations). The particles, the field, the
// histograms and their flush are double (a shared-memory double add is a
// compare-and-swap loop, a global one REDG.E.ADD.F64.RN); the carried
// deposit's window frame (1/stride in double) and its clamp count (an
// exact int) are taken from the double positions, so the clamps are the
// float64 plain version's. A double column or field takes 8 B a node: the
// wide deposits' lane columns halve and the large modes begin at half the
// float nodes (ops/cuda_cic.py deposit_launch_shape and sweep_launch with
// item 8: deposit2 above 14,528 nodes, the carried deposit above 9,684,
// its field in shared memory up to 28,928, the push above 29,056). JAX's
// fused float64 step keeps float32 accumulators in its Pallas deposits
// (preferred_element_type); these sum in double, as its composed float64
// step does. The float instantiations compile to the code they compiled to
// before T (tools/sass_diff.py). Bound: twice the float kernels' bytes a
// row (deposit2 24 B, the push 80, the carried sweep 96).

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
template <bool PERIODIC, int ROWS, bool VEC, typename T>
__global__ void __launch_bounds__(1024, 1)
    deposit2_kernel(const T* __restrict__ p, const T* __restrict__ va,
                    const T* __restrict__ vb, T* __restrict__ out_a,
                    T* __restrict__ out_b, long long n, int ng, int cols) {
  extern __shared__ float4 smem4[];
  T* h_a = reinterpret_cast<T*>(smem4);
  T* h_b = h_a + (size_t)ng * cols;
  zero_shared(h_a, 2 * ng * cols);
  __syncthreads();
  if (ROWS == 1) {  // narrow: a row a thread, grid-stride, one column
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += stride) {
      const CicT<T> c = PERIODIC ? cic_periodic(p[i], ng) : cic_bounded(p[i], ng);
      const T a = va[i];
      const T b = vb[i];
      atomicAdd(&h_a[c.l], mul_rn(a, c.wl));
      atomicAdd(&h_a[c.r], mul_rn(a, c.wr));
      atomicAdd(&h_b[c.l], mul_rn(b, c.wl));
      atomicAdd(&h_b[c.r], mul_rn(b, c.wr));
    }
  } else {  // wide: groups of four rows, lane columns
    const int col = threadIdx.x & (cols - 1);
    long long lo, hi;
    block_groups(n, lo, hi);
    const long long end = min(n, 4 * hi);
    for (long long g = lo + threadIdx.x; g < hi; g += blockDim.x) {
      const long long i = 4 * g;
      const auto p4 = load4<VEC>(p, i, end, (T)0);
      const auto a4 = load4<VEC>(va, i, end, (T)0);
      const auto b4 = load4<VEC>(vb, i, end, (T)0);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (i + r >= end) break;
        const CicT<T> c =
            PERIODIC ? cic_periodic(get(p4, r), ng) : cic_bounded(get(p4, r), ng);
        const T a = get(a4, r);
        const T b = get(b4, r);
        atomicAdd(&h_a[c.l * cols + col], mul_rn(a, c.wl));
        atomicAdd(&h_a[c.r * cols + col], mul_rn(a, c.wr));
        atomicAdd(&h_b[c.l * cols + col], mul_rn(b, c.wl));
        atomicAdd(&h_b[c.r * cols + col], mul_rn(b, c.wr));
      }
    }
  }
  flush_columns<ROWS, 2, false, T>(h_a, ng, cols, out_a, out_b);
}

// The large mode (deposit_launch_shape's cols 0: above 29,056 nodes, where
// one lane column of the two histograms no longer fits a block): no
// shared histogram, each row's four adds a global float atomic
// (red.global.add.f32) into the zeroed outputs, which a launch touches in
// L2 (2 x 4 B a node: 32 MiB at 2^22 nodes). The same rows a block and
// thread as deposit2_kernel's grid.
template <bool PERIODIC, int ROWS, bool VEC, typename T>
__global__ void __launch_bounds__(1024, 1)
    deposit2_global_kernel(const T* __restrict__ p, const T* __restrict__ va,
                           const T* __restrict__ vb, T* __restrict__ out_a,
                           T* __restrict__ out_b, long long n, int ng) {
  if (ROWS == 1) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += stride) {
      const CicT<T> c = PERIODIC ? cic_periodic(p[i], ng) : cic_bounded(p[i], ng);
      const T a = va[i];
      const T b = vb[i];
      atomicAdd(out_a + c.l, mul_rn(a, c.wl));
      atomicAdd(out_a + c.r, mul_rn(a, c.wr));
      atomicAdd(out_b + c.l, mul_rn(b, c.wl));
      atomicAdd(out_b + c.r, mul_rn(b, c.wr));
    }
  } else {
    long long lo, hi;
    block_groups(n, lo, hi);
    const long long end = min(n, 4 * hi);
    for (long long g = lo + threadIdx.x; g < hi; g += blockDim.x) {
      const long long i = 4 * g;
      const auto p4 = load4<VEC>(p, i, end, (T)0);
      const auto a4 = load4<VEC>(va, i, end, (T)0);
      const auto b4 = load4<VEC>(vb, i, end, (T)0);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (i + r >= end) break;
        const CicT<T> c =
            PERIODIC ? cic_periodic(get(p4, r), ng) : cic_bounded(get(p4, r), ng);
        const T a = get(a4, r);
        const T b = get(b4, r);
        atomicAdd(out_a + c.l, mul_rn(a, c.wl));
        atomicAdd(out_a + c.r, mul_rn(a, c.wr));
        atomicAdd(out_b + c.l, mul_rn(b, c.wl));
        atomicAdd(out_b + c.r, mul_rn(b, c.wr));
      }
    }
  }
}

// The gather position: pc = clip(p, 0, ng - 1); with SWAP (the reference's
// swapped intra-cell weights, pygcpic.py:343-347) the cell-mirrored
// clip(2 floor(pc) + 1 - pc, 0, ng - 1), in that operation order.
template <bool SWAP, typename T>
__device__ __forceinline__ T gather_position(T p, T hi) {
  T pc = clamp_to(p, (T)0, hi);
  if (SWAP) {
    pc = sub_rn(add_rn(mul_rn((T)2, floor_of(pc)), (T)1), pc);
    pc = clamp_to(pc, (T)0, hi);
  }
  return pc;
}

// The Boris-Buneman velocity update in a constant B (pygcpic.py:460-507)
// in the TPU kernel's order: the half kick cst ex, the rotation with
// t = cst b, inv = 2 / (1 + t^2), s = t inv, the second half kick.
template <typename T>
__device__ __forceinline__ void boris_rotate(T ex, T cst, T vx0, T vy0, T vz0, T bx,
                                             T by, T bz, T& vx, T& vy, T& vz) {
  const T kick = mul_rn(cst, ex);
  vx = add_rn(vx0, kick);
  const T tx = mul_rn(cst, bx);
  const T ty = mul_rn(cst, by);
  const T tz = mul_rn(cst, bz);
  const T t2 = add_rn(add_rn(mul_rn(tx, tx), mul_rn(ty, ty)), mul_rn(tz, tz));
  const T inv = quot_rn((T)2, add_rn((T)1, t2));
  const T sx = mul_rn(tx, inv);
  const T sy = mul_rn(ty, inv);
  const T sz = mul_rn(tz, inv);
  const T vfx = sub_rn(add_rn(vx, mul_rn(vy0, tz)), mul_rn(vz0, ty));
  const T vfy = sub_rn(add_rn(vy0, mul_rn(vz0, tx)), mul_rn(vx, tz));
  const T vfz = sub_rn(add_rn(vz0, mul_rn(vx, ty)), mul_rn(vy0, tx));
  vx = add_rn(vx, sub_rn(mul_rn(vfy, sz), mul_rn(vfz, sy)));
  vy = add_rn(vy0, sub_rn(mul_rn(vfz, sx), mul_rn(vfx, sz)));
  vz = add_rn(vz0, sub_rn(mul_rn(vfx, sy), mul_rn(vfy, sx)));
  vx = add_rn(vx, kick);
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
template <bool SWAP, int MODE, typename T>
__global__ void boris_kernel(const T* __restrict__ field, const T* __restrict__ p_in,
                             const T* __restrict__ vx_in, const T* __restrict__ vy_in,
                             const T* __restrict__ vz_in, const T* __restrict__ c_in,
                             const T* __restrict__ act_in, T* __restrict__ p_out,
                             T* __restrict__ vx_out, T* __restrict__ vy_out,
                             T* __restrict__ vz_out, long long n, int ng, T bx, T by,
                             T bz, T dt_dx) {
  T* s_field = dynamic_smem<T>();
  load_field<MODE>(s_field, field, ng);
  __syncthreads();
  const T hi = (T)(ng - 1);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const T p = p_in[i];
    const T vx0 = vx_in[i];
    const T vy0 = vy_in[i];
    const T vz0 = vz_in[i];
    if (!(act_in[i] > (T)0)) {
      p_out[i] = p;
      vx_out[i] = vx0;
      vy_out[i] = vy0;
      vz_out[i] = vz0;
      continue;
    }
    const T pc = gather_position<SWAP>(p, hi);
    T vx, vy, vz;
    boris_rotate(gather_mode<MODE>(s_field, field, cic_bounded(pc, ng)), c_in[i],
                 vx0, vy0, vz0, bx, by, bz, vx, vy, vz);
    p_out[i] = add_rn(p, mul_rn(vx, dt_dx));
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
template <bool SWAP, typename T>
__device__ __forceinline__ void boris_row(
    const T* s_field, int ng, int cols, int col, T p, T vx0, T vy0, T vz0, T cst,
    T act, T wr, T wn, T bx, T by, T bz, T dt_dx, int win_stride, int num_k,
    T inv_stride, int pad, int wp, T& p1, T& vx, T& vy, T& vz, int (&idx)[4],
    T (&val)[4], int& clamped) {
  const T hi = (T)(ng - 1);
  const T pc = gather_position<SWAP>(p, hi);
  p1 = p;
  vx = vx0;
  vy = vy0;
  vz = vz0;
  if (act > (T)0) {
    boris_rotate(gather(s_field, cic_bounded(pc, ng)), cst, vx0, vy0, vz0, bx,
                 by, bz, vx, vy, vz);
    p1 = add_rn(p, mul_rn(vx, dt_dx));
  }
  idx[0] = idx[1] = idx[2] = idx[3] = -1;
  if (!(p1 >= (T)0 && p1 <= hi) || (wr == (T)0 && wn == (T)0)) return;
  const T top = (T)(wp - 1);
  const int k = min(max((int)mul_rn(floor_of(pc), inv_stride), 0), num_k - 1);
  const T d_s = sub_rn(pc, (T)(k * win_stride));
  T d_h = add_rn(add_rn(d_s, sub_rn(p1, pc)), (T)pad);
  if (d_h < (T)0 || d_h > top) {
    if (wn > (T)0) ++clamped;
    d_h = clamp_to(d_h, (T)0, top);
  }
  const T row = floor_of(d_h);
  const T fr = sub_rn(d_h, row);
  const T fl = sub_rn((T)1, fr);
  const int l = win_stride * k - pad + (int)row;
  if (l >= 0 && l < ng) {
    idx[0] = l * cols + col;
    idx[1] = (ng + l) * cols + col;
  }
  if (l + 1 >= 0 && l + 1 < ng) {
    idx[2] = (l + 1) * cols + col;
    idx[3] = (ng + l + 1) * cols + col;
  }
  val[0] = mul_rn(wr, fl);
  val[1] = mul_rn(wn, fl);
  val[2] = mul_rn(wr, fr);
  val[3] = mul_rn(wn, fr);
}

template <bool SWAP, int ROWS, bool VEC, typename T>
__global__ void __launch_bounds__(1024, 1) boris_deposit_kernel(
    const T* __restrict__ field, const T* __restrict__ p_in,
    const T* __restrict__ vx_in, const T* __restrict__ vy_in,
    const T* __restrict__ vz_in, const T* __restrict__ c_in,
    const T* __restrict__ act_in, const T* __restrict__ wr_in,
    const T* __restrict__ wn_in, T* __restrict__ p_out, T* __restrict__ vx_out,
    T* __restrict__ vy_out, T* __restrict__ vz_out, T* __restrict__ rho,
    T* __restrict__ dens, int* __restrict__ n_clamped, long long n, int ng, int cols,
    T bx, T by, T bz, T dt_dx, int win_stride, int num_k, T inv_stride, int pad,
    int wp) {
  extern __shared__ float4 smem4[];
  T* h_r = reinterpret_cast<T*>(smem4);  // then the n columns
  T* s_field = h_r + (size_t)2 * ng * cols;
  __shared__ int s_clamped;
  zero_shared(h_r, 2 * ng * cols);
  for (int i = threadIdx.x; i < ng; i += blockDim.x) s_field[i] = field[i];
  if (threadIdx.x == 0) s_clamped = 0;
  __syncthreads();
  int clamped = 0;
  int idx[4];
  T val[4];
  if (ROWS == 1) {  // narrow: a row a thread, grid-stride, one column
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += stride) {
      T p1, vx, vy, vz;
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
      const auto p4 = load4<VEC>(p_in, i, end, (T)0);
      const auto vx4 = load4<VEC>(vx_in, i, end, (T)0);
      const auto vy4 = load4<VEC>(vy_in, i, end, (T)0);
      const auto vz4 = load4<VEC>(vz_in, i, end, (T)0);
      const auto c4 = load4<VEC>(c_in, i, end, (T)0);
      const auto act4 = load4<VEC>(act_in, i, end, (T)0);
      const auto wr4 = load4<VEC>(wr_in, i, end, (T)0);
      const auto wn4 = load4<VEC>(wn_in, i, end, (T)0);
      typename Vec4<T>::type p14, vx14, vy14, vz14;
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
  flush_columns<ROWS, 2, false, T>(h_r, ng, cols, rho, dens);
  if (threadIdx.x == 0 && s_clamped) atomicAdd(n_clamped, s_clamped);
}

// The large mode (cols 0: above 19,369 nodes, where one lane column of the
// two histograms, the field and the clamp count no longer fit a block): boris_row's four
// adds go by global float atomics into the zeroed rho and dens (its
// indices with one column: node l of rho at l, of dens at ng + l); the
// field sits in shared memory up to kFieldSmemMaxNg nodes (SMEM_FIELD) and
// is read from device memory above. The clamps are counted as above.
template <bool SWAP, int ROWS, bool VEC, bool SMEM_FIELD, typename T>
__global__ void __launch_bounds__(1024, 1) boris_deposit_global_kernel(
    const T* __restrict__ field, const T* __restrict__ p_in,
    const T* __restrict__ vx_in, const T* __restrict__ vy_in,
    const T* __restrict__ vz_in, const T* __restrict__ c_in,
    const T* __restrict__ act_in, const T* __restrict__ wr_in,
    const T* __restrict__ wn_in, T* __restrict__ p_out, T* __restrict__ vx_out,
    T* __restrict__ vy_out, T* __restrict__ vz_out, T* __restrict__ rho,
    T* __restrict__ dens, int* __restrict__ n_clamped, long long n, int ng, T bx,
    T by, T bz, T dt_dx, int win_stride, int num_k, T inv_stride, int pad, int wp) {
  extern __shared__ float4 smem4[];
  __shared__ int s_clamped;
  const T* f = field;
  if (SMEM_FIELD) {
    T* s_field = reinterpret_cast<T*>(smem4);
    for (int i = threadIdx.x; i < ng; i += blockDim.x) s_field[i] = field[i];
    f = s_field;
  }
  if (threadIdx.x == 0) s_clamped = 0;
  __syncthreads();
  int clamped = 0;
  int idx[4];
  T val[4];
  if (ROWS == 1) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += stride) {
      T p1, vx, vy, vz;
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
      const auto p4 = load4<VEC>(p_in, i, end, (T)0);
      const auto vx4 = load4<VEC>(vx_in, i, end, (T)0);
      const auto vy4 = load4<VEC>(vy_in, i, end, (T)0);
      const auto vz4 = load4<VEC>(vz_in, i, end, (T)0);
      const auto c4 = load4<VEC>(c_in, i, end, (T)0);
      const auto act4 = load4<VEC>(act_in, i, end, (T)0);
      const auto wr4 = load4<VEC>(wr_in, i, end, (T)0);
      const auto wn4 = load4<VEC>(wn_in, i, end, (T)0);
      typename Vec4<T>::type p14, vx14, vy14, vz14;
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

// The launches of the three kernels of T (the float and double entry
// points).
template <typename T>
cudaError_t launch_deposit2(const T* p, const T* va, const T* vb, T* out_a, T* out_b,
                            long long n, int ng, int periodic, int rows, int blocks,
                            int threads, int cols, cudaStream_t s) {
  if (!deposit_shape_ok(n, ng, rows, blocks, threads, cols, true))
    return cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)ng * cols * sizeof(T);
  const bool vec = aligned16(p) && aligned16(va) && aligned16(vb);
  cudaError_t err;
  if (cols == 0) {  // the large mode
#define PYPIC_DEPOSIT2_GLOBAL(PER, ROWS, VEC)                                   \
  deposit2_global_kernel<PER, ROWS, VEC, T><<<blocks, threads, 0, s>>>(         \
      p, va, vb, out_a, out_b, n, ng);                                          \
  return cudaGetLastError()
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
  err = allow_smem(deposit2_kernel<PER, ROWS, VEC, T>, smem);                   \
  if (err != cudaSuccess) return err;                                           \
  deposit2_kernel<PER, ROWS, VEC, T><<<blocks, threads, smem, s>>>(             \
      p, va, vb, out_a, out_b, n, ng, cols);                                    \
  return cudaGetLastError()
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

template <typename T>
cudaError_t launch_boris(const T* field, const T* p, const T* vx, const T* vy,
                         const T* vz, const T* c, const T* act, T* p1, T* vx1, T* vy1,
                         T* vz1, long long n, int ng, T bx, T by, T bz, T dt_dx, int swap,
                         int mode, int blocks, int threads, cudaStream_t s) {
  return with_mode(mode, [&](auto m) {
    constexpr int MODE = decltype(m)::value;
    const size_t smem = mode_floats(MODE, 1, ng) * sizeof(T);
    cudaError_t err;
    if (swap) {
      err = allow_smem(boris_kernel<true, MODE, T>, smem);
      if (err != cudaSuccess) return err;
      boris_kernel<true, MODE, T><<<blocks, threads, smem, s>>>(
          field, p, vx, vy, vz, c, act, p1, vx1, vy1, vz1, n, ng, bx, by, bz, dt_dx);
    } else {
      err = allow_smem(boris_kernel<false, MODE, T>, smem);
      if (err != cudaSuccess) return err;
      boris_kernel<false, MODE, T><<<blocks, threads, smem, s>>>(
          field, p, vx, vy, vz, c, act, p1, vx1, vy1, vz1, n, ng, bx, by, bz, dt_dx);
    }
    return cudaGetLastError();
  });
}

template <typename T>
cudaError_t launch_boris_deposit(const T* field, const T* p, const T* vx, const T* vy,
                                 const T* vz, const T* c, const T* act, const T* wr,
                                 const T* wn, T* p1, T* vx1, T* vy1, T* vz1, T* rho,
                                 T* dens, int* n_clamped, long long n, int ng, T bx, T by,
                                 T bz, T dt_dx, int swap, int win_stride, int num_k,
                                 T inv_stride, int pad, int rows, int blocks, int threads,
                                 int cols, cudaStream_t s) {
  if (!deposit_shape_ok(n, ng, rows, blocks, threads, cols, true))
    return cudaErrorInvalidValue;
  const size_t smem = (2 * (size_t)cols + 1) * ng * sizeof(T);
  const int wp = win_stride + 2 + 2 * pad;  // width = stride + 2
  const bool vec = aligned16(p) && aligned16(vx) && aligned16(vy) &&
                   aligned16(vz) && aligned16(c) && aligned16(act) &&
                   aligned16(wr) && aligned16(wn) && aligned16(p1) &&
                   aligned16(vx1) && aligned16(vy1) && aligned16(vz1);
  cudaError_t err;
  if (cols == 0) {  // the large mode: the field alone in shared memory, or none
    const bool smem_field = ng <= field_smem_max_ng<T>();
    const size_t fsmem = smem_field ? (size_t)ng * sizeof(T) : 0;
#define PYPIC_BORIS_GLOBAL(SW, ROWS, VEC, SF)                                   \
  err = allow_smem(boris_deposit_global_kernel<SW, ROWS, VEC, SF, T>, fsmem);   \
  if (err != cudaSuccess) return err;                                           \
  boris_deposit_global_kernel<SW, ROWS, VEC, SF, T><<<blocks, threads, fsmem, s>>>( \
      field, p, vx, vy, vz, c, act, wr, wn, p1, vx1, vy1, vz1, rho, dens,       \
      n_clamped, n, ng, bx, by, bz, dt_dx, win_stride, num_k, inv_stride, pad,  \
      wp);                                                                      \
  return cudaGetLastError()
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
  err = allow_smem(boris_deposit_kernel<SW, ROWS, VEC, T>, smem);               \
  if (err != cudaSuccess) return err;                                           \
  boris_deposit_kernel<SW, ROWS, VEC, T><<<blocks, threads, smem, s>>>(         \
      field, p, vx, vy, vz, c, act, wr, wn, p1, vx1, vy1, vz1, rho, dens,       \
      n_clamped, n, ng, cols, bx, by, bz, dt_dx, win_stride, num_k, inv_stride, \
      pad, wp);                                                                 \
  return cudaGetLastError()
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

}  // namespace

extern "C" {

// out_a, out_b: ng zeroed floats each; rows, blocks, threads and cols from
// ops/cuda_cic.py deposit_launch_shape (cols 0: the large mode).
int pypic_deposit2(const float* p, const float* va, const float* vb,
                   float* out_a, float* out_b, long long n, int ng, int periodic,
                   int rows, int blocks, int threads, int cols, void* stream) {
  return (int)launch_deposit2(p, va, vb, out_a, out_b, n, ng, periodic, rows, blocks,
                              threads, cols, (cudaStream_t)stream);
}

// The double deposit (a float64 state): out_a, out_b ng zeroed doubles;
// the shape from deposit_launch_shape(..., item=8).
int pypic_deposit2_f64(const double* p, const double* va, const double* vb,
                       double* out_a, double* out_b, long long n, int ng, int periodic,
                       int rows, int blocks, int threads, int cols, void* stream) {
  return (int)launch_deposit2(p, va, vb, out_a, out_b, n, ng, periodic, rows, blocks,
                              threads, cols, (cudaStream_t)stream);
}

// mode: ops/cuda_cic.py smem_mode (0 shared, 1 global).
int pypic_boris_gather_push(const float* field, const float* p,
                            const float* vx, const float* vy, const float* vz,
                            const float* c, const float* act, float* p1,
                            float* vx1, float* vy1, float* vz1, long long n,
                            int ng, float bx, float by, float bz, float dt_dx,
                            int swap, int mode, int blocks, int threads,
                            void* stream) {
  return (int)launch_boris(field, p, vx, vy, vz, c, act, p1, vx1, vy1, vz1, n, ng, bx, by,
                           bz, dt_dx, swap, mode, blocks, threads, (cudaStream_t)stream);
}

// Every pointer to doubles, every scalar a double.
int pypic_boris_gather_push_f64(const double* field, const double* p, const double* vx,
                                const double* vy, const double* vz, const double* c,
                                const double* act, double* p1, double* vx1, double* vy1,
                                double* vz1, long long n, int ng, double bx, double by,
                                double bz, double dt_dx, int swap, int mode, int blocks,
                                int threads, void* stream) {
  return (int)launch_boris(field, p, vx, vy, vz, c, act, p1, vx1, vy1, vz1, n, ng, bx, by,
                           bz, dt_dx, swap, mode, blocks, threads, (cudaStream_t)stream);
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
  return (int)launch_boris_deposit(field, p, vx, vy, vz, c, act, wr, wn, p1, vx1, vy1, vz1,
                                   rho, dens, n_clamped, n, ng, bx, by, bz, dt_dx, swap,
                                   win_stride, num_k, inv_stride, pad, rows, blocks,
                                   threads, cols, (cudaStream_t)stream);
}

// rho, dens: ng zeroed doubles each; the shape from
// deposit_launch_shape(..., field=True, item=8); inv_stride a double.
int pypic_boris_gather_push_deposit_f64(
    const double* field, const double* p, const double* vx, const double* vy,
    const double* vz, const double* c, const double* act, const double* wr,
    const double* wn, double* p1, double* vx1, double* vy1, double* vz1, double* rho,
    double* dens, int* n_clamped, long long n, int ng, double bx, double by, double bz,
    double dt_dx, int swap, int win_stride, int num_k, double inv_stride, int pad,
    int rows, int blocks, int threads, int cols, void* stream) {
  return (int)launch_boris_deposit(field, p, vx, vy, vz, c, act, wr, wn, p1, vx1, vy1, vz1,
                                   rho, dens, n_clamped, n, ng, bx, by, bz, dt_dx, swap,
                                   win_stride, num_k, inv_stride, pad, rows, blocks,
                                   threads, cols, (cudaStream_t)stream);
}

}  // extern "C"
