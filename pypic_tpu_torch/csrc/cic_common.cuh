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
// Each translation unit that includes this header gets its own copy (the
// helpers live in an anonymous namespace).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Cic {
  int l, r;
  float wl, wr;
};

// Periodic CIC: num_cells == ng, node ng wraps to 0. A position at exactly
// ng (a wrap of a tiny negative value rounds there) lands with w_r = 1 on
// node 0.
__device__ __forceinline__ Cic cic_periodic(float p, int ng) {
  int l = (int)floorf(p);
  l = min(max(l, 0), ng - 1);
  Cic c;
  c.l = l;
  c.r = (l + 1 >= ng) ? 0 : l + 1;
  c.wr = __fsub_rn(p, (float)l);
  c.wl = __fsub_rn(1.0f, c.wr);
  return c;
}

// Bounded CIC: num_cells == ng - 1, node ng - 1 is the last wall node.
__device__ __forceinline__ Cic cic_bounded(float p, int ng) {
  int l = (int)floorf(p);
  l = min(max(l, 0), ng - 2);
  Cic c;
  c.l = l;
  c.r = l + 1;
  c.wr = __fsub_rn(p, (float)l);
  c.wl = __fsub_rn(1.0f, c.wr);
  return c;
}

__device__ __forceinline__ float gather(const float* f, const Cic& c) {
  return __fadd_rn(__fmul_rn(f[c.l], c.wl), __fmul_rn(f[c.r], c.wr));
}

// Periodic wrap as the TPU kernels write it: x - floor(x * (1/ng)) * ng,
// not fmodf.
__device__ __forceinline__ float wrap(float x, float ngf, float inv_ng) {
  return __fsub_rn(x, __fmul_rn(floorf(__fmul_rn(x, inv_ng)), ngf));
}

// Crank-Nicolson push from the gathered field e (pypic.py:264-265):
// p1 = p0 + dt/dx v0 + qm dt^2/(2 dx) e, v1 = v0 + qm dt e.
__device__ __forceinline__ void cn_push(float p0, float v0, float e,
                                        float qm_dt, float qm_dt2_half,
                                        float dt_dx, float& p1, float& v1) {
  p1 = __fadd_rn(__fadd_rn(p0, __fmul_rn(dt_dx, v0)), __fmul_rn(qm_dt2_half, e));
  v1 = __fadd_rn(v0, __fmul_rn(qm_dt, e));
}

// Block-wide sum of one double per thread; every thread gets the total,
// summed in warp order (the same value in every thread, in every block of
// the same shape, and from run to run). `red` is 32 doubles of shared
// memory. blockDim.x is a multiple of 32. Every thread of the block calls
// it.
__device__ double block_sum(double x, double* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  __syncthreads();  // a previous call may still read red
  if (lane == 0) red[warp] = x;
  __syncthreads();
  double t = 0.0;
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

// Every thread of the block calls it once, after its last deposit. h:
// ARRAYS (1 or 2) histograms of ng nodes and `cols` columns (one with ROWS
// 1), the second at h + ng cols; out_a (out_b): ng zeroed floats. A thread
// takes a node, sums its columns from the node's own on (a warp's 32 nodes
// start on 32 banks) and adds the total by one global atomic an array.
// With SKIP a total of exactly 0 is not added: the outputs start at +0,
// and x + 0 is x for every x, so the sums are those of adding it (a NaN or
// Inf total is not 0 and is added).
template <int ROWS, int ARRAYS, bool SKIP>
__device__ __forceinline__ void flush_columns(const float* h, int ng, int cols,
                                              float* out_a, float* out_b) {
  __syncthreads();
  const float* h_b = h + (size_t)ng * cols;
  for (int k = threadIdx.x; k < ng; k += blockDim.x) {
    float a = 0.0f, b = 0.0f;
    if (ROWS == 1) {  // the first port's flush: one column
      a = h[k];
      if (ARRAYS == 2) b = h_b[k];
    } else {
#pragma unroll 4
      for (int j = 0; j < cols; ++j) {
        const int at = k * cols + ((k + j) & (cols - 1));
        a = __fadd_rn(a, h[at]);
        if (ARRAYS == 2) b = __fadd_rn(b, h_b[at]);
      }
    }
    if (!SKIP || a != 0.0f) atomicAdd(out_a + k, a);
    if (ARRAYS == 2 && (!SKIP || b != 0.0f)) atomicAdd(out_b + k, b);
  }
}

// The launch shape's invariants (ops/cuda_cic.py deposit_launch_shape):
// four rows a thread and pass with a power-of-two column count up to 32,
// or a row a thread and one column; no more blocks than the rows fill.
inline bool deposit_shape_ok(long long n, int ng, int rows, int blocks,
                             int threads, int cols) {
  return ng >= 2 && n >= 0 && threads >= 32 && threads <= 1024 &&
         threads % 32 == 0 && blocks >= 1 &&
         (blocks == 1 || blocks <= (n + rows - 1) / rows) &&
         ((rows == 4 && cols >= 1 && cols <= 32 && (cols & (cols - 1)) == 0) ||
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

// Every thread of the block calls it once, after its last addition. hist:
// ng columns of blockDim.x floats in shared memory (column t of node k at
// hist[k * T + t]); partial: ng * gridDim.x floats; counter: one unsigned
// int, 0 at the launch and left 0; out: ng floats, written by the last
// block. blockDim.x is a multiple of 32.
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
__device__ void det_flush(const float* hist, int ng, float* partial,
                          unsigned int* counter, float* out) {
  __shared__ unsigned int s_ticket;
  const int T = blockDim.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = T >> 5, blocks = gridDim.x;
  __syncthreads();
  for (int k = warp; k < ng; k += warps) {
    const float* col = hist + (size_t)k * T;
    float acc = 0.0f;
#pragma unroll 8
    for (int t = lane; t < T; t += 32) acc = __fadd_rn(acc, col[t]);
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
    float acc[kNodes] = {};
    for (int b0 = 0; b0 < blocks; b0 += 32 * kChunk) {
      float v[kNodes][kChunk];
#pragma unroll
      for (int m = 0; m < kNodes; ++m) {
        const int k = k0 + m * warps;
#pragma unroll
        for (int c = 0; c < kChunk; ++c) {
          const int b = b0 + 32 * c + lane;
          v[m][c] = (k < ng && b < blocks) ? __ldcg(partial + (size_t)k * blocks + b)
                                           : 0.0f;
        }
      }
#pragma unroll
      for (int m = 0; m < kNodes; ++m)
#pragma unroll
        for (int c = 0; c < kChunk; ++c)
          if (b0 + 32 * c + lane < blocks) acc[m] = __fadd_rn(acc[m], v[m][c]);
    }
#pragma unroll
    for (int m = 0; m < kNodes; ++m) {
      const int k = k0 + m * warps;
      const float total = warp_fsum(acc[m]);
      if (lane == 0 && k < ng) out[k] = total;
    }
  }
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

// Row r of four (r a constant once the loops are unrolled).
__device__ __forceinline__ float get(const float4& v, int r) {
  return r == 0 ? v.x : (r == 1 ? v.y : (r == 2 ? v.z : v.w));
}

__device__ __forceinline__ float& at(float4& v, int r) {
  return r == 0 ? v.x : (r == 1 ? v.y : (r == 2 ? v.z : v.w));
}

// Dynamic shared memory above the 48 KB default needs an opt-in per kernel.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace
