// CIC helpers shared by the particle kernels (cic.cu, explicit.cu,
// implicit.cu, magnetized.cu, sheath.cu): the wide deposits' grid and
// flush (the single deposit, deposit2 and the carried Boris deposit), and
// the deterministic column histogram of the sheath kernels and the
// deterministic deposit.
//
// Plain CIC index arithmetic (pypic_tpu/ops/cic.py cic_indices_weights):
// idx_l = clip(floor(p), 0, num_cells - 1), w_r = p - idx_l,
// w_l = 1 - w_r, and the right node wraps to 0 on a periodic grid. Every
// product and sum is written with __fmul_rn / __fadd_rn / __fsub_rn so
// that nvcc contracts nothing into an FMA: each operation rounds as the
// plain PyTorch version's separate float32 operations do. No fast-math.
//
// The helpers of the periodic grid-stride kernels (cic_periodic,
// cic_bounded, gather, gather_mode, load_field, wrap, cn_push) and of the
// wide deposits (load4, zero_shared, flush_columns) take the element type
// T, float or double, from their arguments: mul_rn, add_rn, sub_rn,
// quot_rn, floor_of and rint_of are __fmul_rn, __fadd_rn, __fsub_rn,
// __fdiv_rn, floorf and rintf for float, __dmul_rn, __dadd_rn, __dsub_rn,
// __ddiv_rn, floor and rint for double. So a float instantiation is the code the float helpers were,
// and a double one rounds each operation once in double, as the plain
// versions' float64 operations do (the float64 state, rows 1-6).
//
// Each translation unit that includes this header gets its own copy (the
// helpers live in an anonymous namespace). The deterministic deposits come
// in two modes: thread columns in shared memory up to their ceiling, int64
// fixed-point sums in device memory above it ("Large deterministic sums").
// Both take the element type too (the sheath engine's float64 state): the
// columns, det_flush and its partials in double, and above the ceiling a
// two-word fixed point ("Two-word sums") in the place of the one-word.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float quot_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double quot_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float floor_of(float x) { return floorf(x); }
__device__ __forceinline__ double floor_of(double x) { return floor(x); }
__device__ __forceinline__ float rint_of(float x) { return rintf(x); }
__device__ __forceinline__ double rint_of(double x) { return rint(x); }
__device__ __forceinline__ float clamp_to(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}
__device__ __forceinline__ double clamp_to(double x, double lo, double hi) {
  return fmin(fmax(x, lo), hi);
}

template <typename T>
struct CicT {
  int l, r;
  T wl, wr;
};
using Cic = CicT<float>;

// Periodic CIC: num_cells == ng, node ng wraps to 0. A position at exactly
// ng (a wrap of a tiny negative value rounds there) lands with w_r = 1 on
// node 0.
template <typename T>
__device__ __forceinline__ CicT<T> cic_periodic(T p, int ng) {
  int l = (int)floor_of(p);
  l = min(max(l, 0), ng - 1);
  CicT<T> c;
  c.l = l;
  c.r = (l + 1 >= ng) ? 0 : l + 1;
  c.wr = sub_rn(p, (T)l);
  c.wl = sub_rn((T)1, c.wr);
  return c;
}

// Bounded CIC: num_cells == ng - 1, node ng - 1 is the last wall node.
template <typename T>
__device__ __forceinline__ CicT<T> cic_bounded(T p, int ng) {
  int l = (int)floor_of(p);
  l = min(max(l, 0), ng - 2);
  CicT<T> c;
  c.l = l;
  c.r = l + 1;
  c.wr = sub_rn(p, (T)l);
  c.wl = sub_rn((T)1, c.wr);
  return c;
}

template <typename T>
__device__ __forceinline__ T gather(const T* f, const CicT<T>& c) {
  return add_rn(mul_rn(f[c.l], c.wl), mul_rn(f[c.r], c.wr));
}

// ---------------------------------------------------------------------------
// The modes of the grid-stride particle kernels (ops/cuda_cic.py smem_mode,
// a function of the sizes alone):
// * kShared: the field and the histogram in shared memory, one global
//   atomic a node and block in the flush (the kernels as first ported);
// * kGlobal: the field read from device memory through the read-only path
//   (__ldg), each add a global float atomic (red.global.add.f32) into the
//   zeroed output, no flush;
// * kCluster (the Picard passes of cic.cu and domain.cu, rows 1, 2 and
//   17, and explicit.cu's leapfrog deposit, row 14; ops/cuda_cic.py
//   cluster_launch): the field as in kGlobal, the (ng,) sum cut into one
//   slice a CTA of a thread-block cluster, each add into its owner's
//   slice through distributed shared memory, one global atomic a node and
//   CTA in the flush ("The cluster and pair modes' adds" below);
// * kPair (the same kernels, float alone): the field as in kGlobal, a
//   row's two products one 8-B vector reduction into a (ng, 2) pair
//   array, folded into the (ng,) sum by a second kernel.
// Each mode is its own instantiation, so the kShared code is the first
// port's. Every product keeps its rounding; only the order of the float
// sums changes, as it does between two runs of the atomics.
// ---------------------------------------------------------------------------
constexpr int kShared = 0, kGlobal = 1, kCluster = 2, kPair = 3;

// The gather of the mode: the block's copy of the field, or the field in
// device memory (kGlobal, kCluster, kPair).
template <int MODE, typename T>
__device__ __forceinline__ T gather_mode(const T* s_field, const T* __restrict__ field,
                                         const CicT<T>& c) {
  if (MODE != kShared)
    return add_rn(mul_rn(__ldg(field + c.l), c.wl), mul_rn(__ldg(field + c.r), c.wr));
  return gather(s_field, c);
}

// Copies the field into shared memory unless the mode reads it in place;
// the caller's barrier follows.
template <int MODE, typename T>
__device__ __forceinline__ void load_field(T* s_field, const T* __restrict__ field, int ng) {
  if (MODE == kShared)
    for (int i = threadIdx.x; i < ng; i += blockDim.x) s_field[i] = field[i];
}

// Runs f(std::integral_constant<int, MODE>) for the runtime mode (0, 1).
template <typename F>
cudaError_t with_mode(int mode, F f) {
  if (mode == kShared) return f(std::integral_constant<int, kShared>{});
  if (mode == kGlobal) return f(std::integral_constant<int, kGlobal>{});
  return cudaErrorInvalidValue;
}

// Elements of ng nodes a block keeps in shared memory in a mode: `arrays`
// in kShared, none in kGlobal.
inline size_t mode_floats(int mode, int arrays, int ng) {
  return (size_t)(mode == kShared ? arrays : 0) * ng;
}

// The block's dynamic shared memory as elements of T: one extern array a
// type, since one name cannot take two types across the instantiations
// of a template (names of their own: newton.cu's `smem` is bytes).
template <typename T>
__device__ __forceinline__ T* dynamic_smem();
template <>
__device__ __forceinline__ float* dynamic_smem<float>() {
  extern __shared__ float dyn_smem_f32[];
  return dyn_smem_f32;
}
template <>
__device__ __forceinline__ double* dynamic_smem<double>() {
  extern __shared__ double dyn_smem_f64[];
  return dyn_smem_f64;
}

// Periodic wrap as the TPU kernels write it: x - floor(x * (1/ng)) * ng,
// not fmodf.
template <typename T>
__device__ __forceinline__ T wrap(T x, T ngf, T inv_ng) {
  return sub_rn(x, mul_rn(floor_of(mul_rn(x, inv_ng)), ngf));
}

// Crank-Nicolson push from the gathered field e (pypic.py:264-265):
// p1 = p0 + dt/dx v0 + qm dt^2/(2 dx) e, v1 = v0 + qm dt e.
template <typename T>
__device__ __forceinline__ void cn_push(T p0, T v0, T e, T qm_dt, T qm_dt2_half, T dt_dx,
                                        T& p1, T& v1) {
  p1 = add_rn(add_rn(p0, mul_rn(dt_dx, v0)), mul_rn(qm_dt2_half, e));
  v1 = add_rn(v0, mul_rn(qm_dt, e));
}

// Block-wide sum of one double (or int64) per thread; every thread gets
// the total, summed in warp order (the same value in every thread, in
// every block of the same shape, and from run to run). `red` is 32 values
// of shared memory. blockDim.x is a multiple of 32. Every thread of the
// block calls it.
template <typename T>
__device__ T block_sum(T x, T* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  __syncthreads();  // a previous call may still read red
  if (lane == 0) red[warp] = x;
  __syncthreads();
  T t = 0;
  for (int w = 0; w < nwarps; ++w) t += red[w];
  return t;
}

// ---------------------------------------------------------------------------
// The wide deposits' grid and flush (cic.cu deposit_kernel, magnetized.cu
// deposit2_kernel and boris_deposit_kernel; ops/cuda_cic.py
// deposit_launch_shape): one 1,024-thread block an SM, each sweeping a
// contiguous range of rows four at a time, each histogram in `cols` lane
// columns (node k's column j at h[k cols + j], lane l adding into column
// l mod cols, so that at 32 columns a warp's adds land on 32 banks), or
// below that n the first port's grid, a row a thread and one column. The
// header of magnetized.cu gives the split that chose it.
// ---------------------------------------------------------------------------

// Groups [b G / B, (b + 1) G / B) of this block, G = ceil(n / 4) groups of
// four rows, B = gridDim.x; every block gets rows when G >= B.
__device__ __forceinline__ void block_groups(long long n, long long& lo,
                                             long long& hi) {
  const long long groups = (n + 3) / 4, b = blockIdx.x, blocks = gridDim.x;
  lo = b * groups / blocks;
  hi = (b + 1) * groups / blocks;
}

// Zero `count` floats of shared memory from the 16-B aligned `h`.
__device__ __forceinline__ void zero_shared(float* h, int count) {
  float4* h4 = reinterpret_cast<float4*>(h);
  for (int i = threadIdx.x; i < count / 4; i += blockDim.x)
    h4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int i = count / 4 * 4 + threadIdx.x; i < count; i += blockDim.x) h[i] = 0.0f;
}

// `count` doubles: the same bytes zeroed as floats (0.0 is all zero bits).
__device__ __forceinline__ void zero_shared(double* h, int count) {
  zero_shared(reinterpret_cast<float*>(h), 2 * count);
}

// Every thread of the block calls it once, after its last deposit. h:
// ARRAYS (1 or 2) histograms of ng nodes and `cols` columns (one with ROWS
// 1), the second at h + ng cols; out_a (out_b): ng zeroed floats. A thread
// takes a node, sums its columns from the node's own on (a warp's 32 nodes
// start on 32 banks) and adds the total by one global atomic an array.
// With SKIP a total of exactly 0 is not added: the outputs start at +0,
// and x + 0 is x for every x, so the sums are those of adding it (a NaN or
// Inf total is not 0 and is added).
template <int ROWS, int ARRAYS, bool SKIP, typename T>
__device__ __forceinline__ void flush_columns(const T* h, int ng, int cols, T* out_a,
                                              T* out_b) {
  __syncthreads();
  const T* h_b = h + (size_t)ng * cols;
  for (int k = threadIdx.x; k < ng; k += blockDim.x) {
    T a = 0, b = 0;
    if (ROWS == 1) {  // the first port's flush: one column
      a = h[k];
      if (ARRAYS == 2) b = h_b[k];
    } else {
#pragma unroll 4
      for (int j = 0; j < cols; ++j) {
        const int at = k * cols + ((k + j) & (cols - 1));
        a = add_rn(a, h[at]);
        if (ARRAYS == 2) b = add_rn(b, h_b[at]);
      }
    }
    if (!SKIP || a != (T)0) atomicAdd(out_a + k, a);
    if (ARRAYS == 2 && (!SKIP || b != (T)0)) atomicAdd(out_b + k, b);
  }
}

// The launch shape's invariants (ops/cuda_cic.py deposit_launch_shape):
// four rows a thread and pass with a power-of-two column count up to 32,
// or a row a thread and one column; no more blocks than the rows fill.
// With `large` (deposit2 and the carried Boris deposit) cols may be 0:
// the large mode, no shared histogram, every add a global atomic.
inline bool deposit_shape_ok(long long n, int ng, int rows, int blocks,
                             int threads, int cols, bool large = false) {
  return ng >= 2 && n >= 0 && threads >= 32 && threads <= 1024 &&
         threads % 32 == 0 && blocks >= 1 &&
         (blocks == 1 || blocks <= (n + rows - 1) / rows) &&
         ((large && cols == 0 && (rows == 4 || rows == 1)) ||
          (rows == 4 && cols >= 1 && cols <= 32 && (cols & (cols - 1)) == 0) ||
          (rows == 1 && cols == 1));
}

// ---------------------------------------------------------------------------
// Deterministic deposits: the same inputs and launch shape give the same
// bits on every run. Float atomics add in the order the hardware serves
// them, which changes from run to run; here nothing is added out of a
// fixed order. Each thread keeps its own (ng,) column in shared memory,
// column t of node k at hist[k T + t] (T = blockDim.x, a multiple of 32:
// a warp's 32 lanes touch 32 banks whatever their nodes), and adds its
// rows in their order with plain read-modify-writes. det_flush then sums
// the columns by warps and the blocks' partials in the last block, each
// in a fixed order. The grid is part of the order: a wrapper launches a
// given n and ng with a given grid (ops/cuda_sheath.py launch_shape, a
// function of n, ng and the SM count). The sheath kernels (sheath.cu) and
// the deterministic deposit (cic.cu) share it.
// ---------------------------------------------------------------------------

// The fixed-order sum of a warp's 32 values: lane 0 gets it.
__device__ __forceinline__ float warp_fsum(float acc) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    acc = __fadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, o));
  return acc;
}

__device__ __forceinline__ double warp_fsum(double acc) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    acc = __dadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, o));
  return acc;
}

// Every thread of the block calls it once, after its last addition. hist:
// ng columns of blockDim.x elements in shared memory (column t of node k at
// hist[k * T + t]); partial: ng * gridDim.x elements; counter: one
// unsigned int, 0 at the launch and left 0; out: ng elements, written by
// the last block. blockDim.x is a multiple of 32. E is float, or double
// for the double kernels (every sum then a __dadd_rn, in the same order).
//
// The columns are summed by warps, not a tree: a warp takes a node, its
// lanes add the columns lane, lane + 32, ... in order and a shuffle tree
// adds the lanes (independent shared-memory loads, no block barrier); the
// block's node sums go to partial[node * blocks + block]. The block that
// takes the last ticket sums the partials the same way, a warp four nodes
// over the blocks, each lane's L2 loads of them issued together before
// any is added. (Lane groups a node, G lanes with 32 / G nodes a warp,
// read 13.7 us against 10.6 at the sheath current's 51 nodes and 36.5
// against 36.2 at the exit histograms' 128: PERF.md §6.)
template <typename E>
__device__ void det_flush(const E* hist, int ng, E* partial,
                          unsigned int* counter, E* out) {
  __shared__ unsigned int s_ticket;
  const int T = blockDim.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = T >> 5, blocks = gridDim.x;
  __syncthreads();
  for (int k = warp; k < ng; k += warps) {
    const E* col = hist + (size_t)k * T;
    E acc = (E)0;
#pragma unroll 8
    for (int t = lane; t < T; t += 32) acc = add_rn(acc, col[t]);
    acc = warp_fsum(acc);
    if (lane == 0) partial[(size_t)k * blocks + blockIdx.x] = acc;
  }
  __threadfence();  // this block's partials are visible before its ticket
  __syncthreads();
  if (threadIdx.x == 0) s_ticket = atomicAdd(counter, 1u);
  __syncthreads();
  if (s_ticket != (unsigned int)blocks - 1) return;  // uniform across the block
  // every block has its ticket: zero the counter for the next launch
  if (threadIdx.x == 0) *counter = 0u;
  __threadfence();
  // a warp takes kNodes nodes at once: every lane issues its loads of
  // them (up to kNodes x kChunk) before it adds any, then adds each
  // node's in block order -- lane l the blocks l, l + 32, ...
  constexpr int kNodes = 4, kChunk = 8;
  for (int k0 = warp; k0 < ng; k0 += kNodes * warps) {
    E acc[kNodes] = {};
    for (int b0 = 0; b0 < blocks; b0 += 32 * kChunk) {
      E v[kNodes][kChunk];
#pragma unroll
      for (int m = 0; m < kNodes; ++m) {
        const int k = k0 + m * warps;
#pragma unroll
        for (int c = 0; c < kChunk; ++c) {
          const int b = b0 + 32 * c + lane;
          v[m][c] = (k < ng && b < blocks) ? __ldcg(partial + (size_t)k * blocks + b)
                                           : (E)0;
        }
      }
#pragma unroll
      for (int m = 0; m < kNodes; ++m)
#pragma unroll
        for (int c = 0; c < kChunk; ++c)
          if (b0 + 32 * c + lane < blocks) acc[m] = add_rn(acc[m], v[m][c]);
    }
#pragma unroll
    for (int m = 0; m < kNodes; ++m) {
      const int k = k0 + m * warps;
      const E total = warp_fsum(acc[m]);
      if (lane == 0 && k < ng) out[k] = total;
    }
  }
}

// ---------------------------------------------------------------------------
// Large deterministic sums (ng above the thread columns' ceiling): int64
// fixed point in device memory. Every term t (a float32 product, as the
// column path adds it) becomes q = rint(t 2^k) and is added to its node
// by a 64-bit integer atomic. Integer adds are exact and associative, so
// the sums' bits depend on neither the order nor the grid. The scale 2^k
// comes from the largest |t| of the call, M, taken in a first sweep of the
// same rows (the blocks' maxima in bmax[block]): a node sums at most 2n
// terms, so k = 62 - e with 2 n M < 2^e keeps every node's |sum|, and
// every partial sum of it, below 2^62 + n < 2^63. A term then rounds by
// at most 2^-(k+1) <= n M 2^-61 (at n = 1e7, 4.3e-12 M), and the node
// value once more to float32 when det_fixed_out converts it. A NaN or
// Inf term reads as M = Inf, and the whole output is then NaN. The
// scratch is bmax (blocks floats) and acc (ng int64), zeroed by the first
// sweep: 8 ng + 4 blocks bytes, no column of ng floats a thread or a
// block. The wrappers run the three launches (scale sweep, deposit
// sweep, det_fixed_out) in a row on one stream.
// ---------------------------------------------------------------------------

constexpr int kLargeThreads = 512;  // ops/cuda_sheath.py LARGE_THREADS
// the field alone in one block's shared memory (ops/cuda_cic.py
// FIELD_SMEM_MAX_NG): (232,448 B less 1,024 B of room for the kernel's
// static shared memory) / 4. A block's 232,448 B hold the static bytes
// too: at 58,112 nodes the carried Boris deposit's 16-B clamp count made
// the launch fail.
constexpr int kFieldSmemMaxNg = 57856;
// the same for a field of E (28,928 doubles; ops/cuda_sheath.py
// field_smem_max_ng)
template <typename E>
__host__ __device__ constexpr int field_smem_max_ng() {
  return (232448 - 1024) / (int)sizeof(E);
}

// A term's magnitude into the thread's running maximum (T the term's
// type, float or double); a NaN or Inf term makes it Inf (fmax alone would
// drop a NaN).
template <typename T>
__device__ __forceinline__ void fixed_track(T& m, T term) {
  const T a = fabs(term);
  m = a <= (T)(sizeof(T) == 8 ? 1.7976931348623157e308 : 3.402823466e38f) ? fmax(m, a)
                                                                          : (T)INFINITY;
}

__device__ __forceinline__ long long fixed_q(float term, double scale) {
  return __double2ll_rn(__dmul_rn((double)term, scale));
}

// Adds a term to its node; a term that rounds to 0 adds nothing (x + 0 is
// x for integers).
__device__ __forceinline__ void fixed_add(unsigned long long* acc, int node,
                                          float term, double scale) {
  const long long q = fixed_q(term, scale);
  if (q != 0) atomicAdd(acc + node, (unsigned long long)q);
}

// Block-wide maximum of one non-negative T a thread (every thread gets
// it); `red` is 32 T of shared memory. Every thread calls it.
template <typename T>
__device__ T block_fmax(T x, T* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) x = fmax(x, __shfl_down_sync(0xffffffffu, x, o));
  __syncthreads();  // a previous call may still read red
  if (lane == 0) red[warp] = x;
  __syncthreads();
  T t = 0;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) t = fmax(t, red[w]);
  return t;
}

// The scale sweep's end: the block's largest |term| into bmax[block].
// Every thread calls it.
template <typename T>
__device__ __forceinline__ void fixed_scale_out(T m, T* bmax) {
  __shared__ T red[32];
  m = block_fmax(m, red);
  if (threadIdx.x == 0) bmax[blockIdx.x] = m;
}

// The scale 2^k of the call from the `nb` blocks' maxima (the same value
// in every block and launch); 0 where a term was not finite or, for a
// double maximum, 2 n M overflows. Every thread calls it.
template <typename T>
__device__ double fixed_scale(const T* __restrict__ bmax, int nb, long long n) {
  __shared__ T red[32];
  T m = 0;
  for (int b = threadIdx.x; b < nb; b += blockDim.x) m = fmax(m, bmax[b]);
  m = block_fmax(m, red);
  if (m == (T)0) return 1.0;
  if (isinf(m)) return 0.0;
  const double big = 2.0 * (double)n * (double)m;
  if (sizeof(T) == 8 && isinf(big)) return 0.0;
  int e;
  frexp(big, &e);
  return ldexp(1.0, 62 - e);
}

// Zero the ng accumulators, grid-stride over the scale sweep's blocks.
__device__ __forceinline__ void fixed_zero(unsigned long long* acc, int ng) {
  for (long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x; k < ng;
       k += (long long)gridDim.x * blockDim.x)
    acc[k] = 0ull;
}

// out[k] = acc[k] / 2^k rounded to float32 (NaN everywhere after a
// non-finite term); `nb` and `n` as the sweeps had them.
__global__ void __launch_bounds__(256) det_fixed_out(
    const unsigned long long* __restrict__ acc, const float* __restrict__ bmax,
    int nb, long long n, int ng, float* __restrict__ out) {
  const double scale = fixed_scale(bmax, nb, n);
  const double inv = scale == 0.0 ? 0.0 : 1.0 / scale;  // a power of two: exact
  for (long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x; k < ng;
       k += (long long)gridDim.x * blockDim.x)
    out[k] = scale == 0.0 ? __int_as_float(0x7fffffff)
                          : __double2float_rn(__dmul_rn(__ll2double_rn((long long)acc[k]), inv));
}

// ---------------------------------------------------------------------------
// Two-word sums: the large deterministic sums of the double kernels (the
// sheath engine's float64 state). One int64 word a node cannot carry a
// float64 current: its terms round by 2^-(k+1) <= n M 2^-61, at n = 1e7
// 4.3e-12 M, some 40,000 float64 ulps of M. Float atomics cannot either:
// the sheath loop's floor exit reads the residual at the sums' round-off,
// which recedes to float64 eps, where the atomics' changing order is what
// it would read. So each term t (a double product) takes two int64 words
// at the scale 2^k of the one-word sums (k = 62 - e, 2 n M < 2^e, M the
// largest |t| of the call, now a double from the scale sweep):
// * hi = rint(t 2^k), and the fraction f = t 2^k - hi, exact in double
//   (t 2^k is exact, and an integer where |t 2^k| >= 2^52);
// * lo = rint(f 2^L), |lo| <= 2^(L-1), with L = min(44, 62 - ceil(log2
//   2n)): 2n terms of either word stay below 2^62, and L <= 44 keeps the
//   conversion exact (below);
// * hi into acc[node], lo into acc[ng + node], two 64-bit integer atomics
//   a term (a wall row's charge summed in its block first, as the
//   one-word sums do). The words' sums are exact and associative: the
//   bits depend on neither the order nor the grid.
// det_fixed2_out then carries lo's integer part into hi (hi' = hi + (lo
// >> L), lo' = lo - ((lo >> L) << L), in [0, 2^L)), takes a = hi'
// rounded to double, the exact rest s = ((hi' - a) 2^L + lo') 2^-L (|hi'
// - a| <= 2^8, so the integer stays below 2^53: exact in double) and
// writes (a + s) 2^-k: one rounding of the exact node sum. A term rounds
// by 2^-(k+L+1): at n = 1e7 (L = 37), 2^-(62-25+37+1) M ~ 3e-23 M against a
// float64 ulp of M of 2.2e-16 M. The scratch: bmax (blocks doubles) and acc
// (2 ng int64). The plain twin, ops/cuda_cic.py fixed2_sum_plain, computes
// the same bits with int64 tensor operations.
// ---------------------------------------------------------------------------

// L of n rows: min(44, 62 - ceil(log2 2n)).
__device__ __forceinline__ int fixed2_bits(long long n) {
  const int b = 64 - __clzll(2 * n - 1);  // ceil(log2 2n), 2n >= 2
  return min(44, 62 - b);
}

// The two words of a term at scale 2^k, lscale = 2^L.
__device__ __forceinline__ void fixed2_q(double term, double scale, double lscale,
                                        long long& hi, long long& lo) {
  const double x = __dmul_rn(term, scale);
  hi = __double2ll_rn(x);
  const double f = __dsub_rn(x, __ll2double_rn(hi));
  lo = __double2ll_rn(__dmul_rn(f, lscale));
}

// Adds a term's words to its node (hi at acc[node], lo at acc[ng + node]);
// a word of 0 adds nothing.
__device__ __forceinline__ void fixed2_add(unsigned long long* acc, int ng, int node,
                                           double term, double scale, double lscale) {
  long long hi, lo;
  fixed2_q(term, scale, lscale, hi, lo);
  if (hi != 0) atomicAdd(acc + node, (unsigned long long)hi);
  if (lo != 0) atomicAdd(acc + ng + node, (unsigned long long)lo);
}

// out[k] = the two-word sum of node k over 2^k, rounded once to double (NaN
// everywhere after a non-finite term); `nb` and `n` as the sweeps had them.
__global__ void __launch_bounds__(256) det_fixed2_out(
    const unsigned long long* __restrict__ acc, const double* __restrict__ bmax,
    int nb, long long n, int ng, double* __restrict__ out) {
  const double scale = fixed_scale(bmax, nb, n);
  const double inv = scale == 0.0 ? 0.0 : 1.0 / scale;  // a power of two: exact
  const int bits = fixed2_bits(n);
  const double frac = ldexp(1.0, -bits);
  for (long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x; k < ng;
       k += (long long)gridDim.x * blockDim.x) {
    const long long unit = 1ll << bits;
    long long hi = (long long)acc[k], lo = (long long)acc[ng + k];
    const long long carry = lo >> bits;  // floor(lo / 2^L): an arithmetic shift
    hi += carry;
    lo -= carry * unit;
    const double a = __ll2double_rn(hi);
    const long long rest = (hi - __double2ll_rn(a)) * unit + lo;
    const double sum = __dadd_rn(a, __dmul_rn(__ll2double_rn(rest), frac));
    out[k] = scale == 0.0 ? __longlong_as_double(0x7fffffffffffffffll) : __dmul_rn(sum, inv);
  }
}

// The conversion launch of the large sums of E: det_fixed_out (one word a
// node) for float, det_fixed2_out (two) for double.
template <typename E>
inline cudaError_t launch_fixed_out(const unsigned long long* acc, const E* bmax, int nb,
                                    long long n, int ng, E* out, cudaStream_t s) {
  const int blocks = ng > 256 * 1024 ? 1024 : (ng + 255) / 256;
  if constexpr (sizeof(E) == 8)
    det_fixed2_out<<<blocks, 256, 0, s>>>(acc, bmax, nb, n, ng, out);
  else
    det_fixed_out<<<blocks, 256, 0, s>>>(acc, bmax, nb, n, ng, out);
  return cudaGetLastError();
}
// int64 words a node of the large sums of E: one for float, two for double
template <typename E>
__host__ __device__ constexpr int fixed_words() {
  return sizeof(E) == 8 ? 2 : 1;
}

// The large sweeps' invariants (ops/cuda_sheath.py launch_shape's large
// mode): at most kLargeThreads threads a block, rows in multiples of 4.
inline bool large_shape_ok(int ng, int blocks, int threads, long long rows_per_block) {
  return ng >= 2 && blocks >= 1 && threads >= 32 && threads <= kLargeThreads &&
         threads % 32 == 0 && rows_per_block % 4 == 0;
}

// ---------------------------------------------------------------------------
// Four consecutive rows as one float4: 16-B loads and stores where every
// pointer is 16-B aligned (VEC), row by row otherwise (the sheath kernels)
// ---------------------------------------------------------------------------

inline bool aligned16(const void* ptr) {
  return ((uintptr_t)ptr & 15u) == 0;
}

// Four rows i..i+3 of a (n,) array as one float4: a 16-B load where VEC
// (every pointer 16-B aligned) and the four rows exist, else row by row,
// rows at or past n reading `pad`.
template <bool VEC>
__device__ __forceinline__ float4 load4(const float* __restrict__ a,
                                        long long i, long long n, float pad) {
  if (VEC && i + 3 < n) return *reinterpret_cast<const float4*>(a + i);
  float4 v;
  v.x = i < n ? a[i] : pad;
  v.y = i + 1 < n ? a[i + 1] : pad;
  v.z = i + 2 < n ? a[i + 2] : pad;
  v.w = i + 3 < n ? a[i + 3] : pad;
  return v;
}

// Four doubles, the double rows' counterpart of float4 (no alignment of
// its own: loaded and stored as two 16-B double2). Its rows are an array,
// indexed by a constant once the loops are unrolled: with four members
// selected as references (float4's ``at``) the double sheath pass
// compiled to 16-B stores of rows 0 and 2 alone (two STG.E.64), rows 1
// and 3 never written.
struct Double4 {
  double v[4];
};

template <bool VEC>
__device__ __forceinline__ Double4 load4(const double* __restrict__ a, long long i,
                                         long long n, double pad) {
  Double4 d;
  if (VEC && i + 3 < n) {
    const double2 lo = *reinterpret_cast<const double2*>(a + i);
    const double2 hi = *reinterpret_cast<const double2*>(a + i + 2);
    d.v[0] = lo.x;
    d.v[1] = lo.y;
    d.v[2] = hi.x;
    d.v[3] = hi.y;
    return d;
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) d.v[r] = i + r < n ? a[i + r] : pad;
  return d;
}

template <bool VEC>
__device__ __forceinline__ void store4(float* __restrict__ a, long long i,
                                       long long n, float4 v) {
  if (VEC && i + 3 < n) {
    *reinterpret_cast<float4*>(a + i) = v;
    return;
  }
  if (i < n) a[i] = v.x;
  if (i + 1 < n) a[i + 1] = v.y;
  if (i + 2 < n) a[i + 2] = v.z;
  if (i + 3 < n) a[i + 3] = v.w;
}

template <bool VEC>
__device__ __forceinline__ void store4(double* __restrict__ a, long long i,
                                       long long n, const Double4& d) {
  if (VEC && i + 3 < n) {
    *reinterpret_cast<double2*>(a + i) = make_double2(d.v[0], d.v[1]);
    *reinterpret_cast<double2*>(a + i + 2) = make_double2(d.v[2], d.v[3]);
    return;
  }
#pragma unroll
  for (int r = 0; r < 4; ++r)
    if (i + r < n) a[i + r] = d.v[r];
}

// The four-row vector of an element type: float4 or Double4.
template <typename E>
struct Vec4;
template <>
struct Vec4<float> {
  using type = float4;
};
template <>
struct Vec4<double> {
  using type = Double4;
};

// Row r of four (r a constant once the loops are unrolled).
__device__ __forceinline__ float get(const float4& v, int r) {
  return r == 0 ? v.x : (r == 1 ? v.y : (r == 2 ? v.z : v.w));
}

__device__ __forceinline__ double get(const Double4& d, int r) {
  return d.v[r];
}

__device__ __forceinline__ float& at(float4& v, int r) {
  return r == 0 ? v.x : (r == 1 ? v.y : (r == 2 ? v.z : v.w));
}

__device__ __forceinline__ double& at(Double4& d, int r) {
  return d.v[r];
}

// Dynamic shared memory above the 48 KB default needs an opt-in per kernel.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// ---------------------------------------------------------------------------
// The cluster and pair modes' adds (kCluster, kPair: the Picard passes, rows
// 1, 2 and 17, and the leapfrog deposit, row 14; ops/cuda_cic.py
// cluster_launch), shared by cic.cu, domain.cu and explicit.cu.
//
// kCluster: the (ng,) sum cut into one slice of S = ceil(ng / C) nodes a
// CTA of a thread-block cluster of C CTAs, CTA r owning nodes [r S,
// min((r + 1) S, ng)) in its dynamic shared memory; each product lands in
// its owner's slice through distributed shared memory (this CTA's own
// included), and after a cluster.sync() each CTA adds its slice to the
// output, one global atomic a node.
//
// kPair (float alone: no vector reduction takes doubles): a row's two
// products one red.global.add.v2.f32 into a zeroed, 8-B aligned pair
// array in device memory, folded into the sum by a second kernel.
// ---------------------------------------------------------------------------

// kCluster's adds of a periodic row's two products: the left node's owner
// r = l / slice at offset l - r slice, the right node's the next offset,
// the next owner's first past slice - 1 and node 0's (owner 0) past ng - 1.
template <typename T>
__device__ __forceinline__ void cluster_add(T* slices, int slice, const CicT<T>& c, T al,
                                            T ar) {
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const int r = c.l / slice, o = c.l - r * slice;
  int rr = r, ro = o + 1;
  if (c.r == 0) {
    rr = 0;
    ro = 0;
  } else if (ro == slice) {
    ++rr;
    ro = 0;
  }
  atomicAdd(cluster.map_shared_rank(slices, r) + o, al);
  atomicAdd(cluster.map_shared_rank(slices, rr) + ro, ar);
}

// kCluster's adds on a bounded slab of `nodes` nodes (domain.cu, row 17):
// node l's product and node l + 1's, no wrap; a product whose node lies
// outside [0, nodes) is dropped, as the global mode drops it.
__device__ __forceinline__ void cluster_add_bounded(float* slices, int slice, int nodes,
                                                    int l, float al, float ar) {
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  if (l >= 0 && l < nodes) {
    const int r = l / slice;
    atomicAdd(cluster.map_shared_rank(slices, r) + (l - r * slice), al);
  }
  const int m = l + 1;
  if (m >= 0 && m < nodes) {
    const int r = m / slice;
    atomicAdd(cluster.map_shared_rank(slices, r) + (m - r * slice), ar);
  }
}

// kPair's add: both products in one 8-B vector reduction at row l of the
// pair array.
__device__ __forceinline__ void pair_add(float* pair, int l, float al, float ar) {
  asm volatile("red.global.add.v2.f32 [%0], {%1, %2};" ::"l"(pair + 2 * l), "f"(al),
               "f"(ar)
               : "memory");
}

// kPair's fold of the periodic (ng, 2) pair array into the (ng,) sum: row l
// holds node l's product and node l + 1's (node 0 past ng - 1), so
// jh[i] = pair[i][0] + pair[i - 1][1], i - 1 taken mod ng.
template <typename T>
__global__ void pair_fold_kernel(const T* __restrict__ pair, T* __restrict__ jh, int ng) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < ng) jh[i] = add_rn(pair[2 * i], pair[2 * (i == 0 ? ng - 1 : i - 1) + 1]);
}

// kPair's fold on a bounded slab (row 17): row l + 1 of the (nodes + 1, 2)
// pair array holds node l's product and node l + 1's, so jh[i] =
// pair[i + 1][0] + pair[i][1]; pair[0][0] (node -1) and pair[nodes][1]
// (node nodes) are never read, which drops the products the global mode
// drops. (A template, so that only the translation unit that launches it
// compiles it.)
template <typename T>
__global__ void pair_fold_bounded_kernel(const T* __restrict__ pair, T* __restrict__ jh,
                                         int nodes) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < nodes) jh[i] = add_rn(pair[2 * (i + 1)], pair[2 * i + 1]);
}

// The launch configuration of a kernel's kCluster instantiation: a
// non-portable cluster size allowed, `smem` bytes of dynamic shared memory
// a CTA, `blocks` CTAs of `threads` in clusters of `cluster` (a power of
// two up to 16 that divides `blocks`). `attr` holds the cluster's
// dimension.
template <typename K>
cudaError_t cluster_launch_config(K kernel, size_t smem, int blocks, int threads,
                                  int cluster, cudaStream_t s, cudaLaunchConfig_t* cfg,
                                  cudaLaunchAttribute* attr) {
  if (cluster < 1 || cluster > 16 || (cluster & (cluster - 1)) || blocks % cluster)
    return cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  *cfg = {};
  cfg->gridDim = dim3(blocks);
  cfg->blockDim = dim3(threads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

// How many clusters of `cluster` CTAs of `threads`, `smem` bytes a CTA, of
// a kCluster instantiation the card holds at once
// (cudaOccupancyMaxActiveClusters): 0 means it cannot launch one.
template <typename K>
cudaError_t max_clusters(K kernel, size_t smem, int cluster, int threads, int* count) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err =
      cluster_launch_config(kernel, smem, cluster, threads, cluster, 0, &cfg, &attr);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveClusters(count, kernel, &cfg);
}

}  // namespace
