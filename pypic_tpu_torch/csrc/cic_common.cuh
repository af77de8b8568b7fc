// CIC helpers shared by the particle kernels (cic.cu, explicit.cu,
// implicit.cu, magnetized.cu, sheath.cu), and the deterministic block
// histogram of the sheath kernels and the deterministic deposit.
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
// Deterministic deposits: the same inputs and launch shape give the same
// bits on every run. Float atomics add in the order the hardware serves
// them, which changes from run to run; here nothing is added out of a
// fixed order. Each thread keeps its own (ng,) histogram in shared memory,
// column tid of hist[node * T + tid] (T = blockDim.x, a power of two: a
// warp's 32 lanes touch 32 banks whatever their nodes), and adds its
// particles in its grid-stride order with plain read-modify-writes.
// det_flush sums the threads' columns by a fixed tree, writes the block's
// partial to device memory, and the block that takes the last ticket
// sums the partials in block order and sets the counter back to 0. The grid is part of the order: a
// wrapper launches a given n and ng with a given grid.
// ---------------------------------------------------------------------------

// Every thread of the block calls it once, after its last addition.
// hist: ng * blockDim.x floats in shared memory (consumed); partial:
// gridDim.x * ng floats; counter: one unsigned int, 0 at the launch and
// left 0; out: ng floats, written by the last block. blockDim.x is a
// power of two <= 256.
__device__ void det_flush(float* hist, int ng, float* partial,
                          unsigned int* counter, float* out) {
  __shared__ unsigned int s_ticket;
  __shared__ float s_red[256];
  const int T = blockDim.x, t = threadIdx.x;
  for (int half = T >> 1; half > 0; half >>= 1) {
    __syncthreads();
    if (t < half)
      for (int k = 0; k < ng; ++k)
        hist[k * T + t] = __fadd_rn(hist[k * T + t], hist[k * T + t + half]);
  }
  __syncthreads();
  for (int k = t; k < ng; k += T) partial[(size_t)blockIdx.x * ng + k] = hist[k * T];
  __threadfence();  // this block's partial is visible before its ticket
  __syncthreads();
  if (t == 0) s_ticket = atomicAdd(counter, 1u);
  __syncthreads();
  if (s_ticket != gridDim.x - 1) return;  // uniform across the block
  // every block has its ticket: zero the counter for the next launch
  if (t == 0) *counter = 0u;
  __threadfence();
  // the last block: the partials come through shared memory a tile of T
  // blocks at a time (independent loads, through L2 past L1), and node
  // k's are summed in block order, split into `chunks` interleaved runs
  // when the block has threads to spare, the runs then in run order
  const int blocks = gridDim.x;
  const int chunks = ng < T ? T / ng : 1;
  const int k0 = t % ng, run = t / ng;
  float acc = 0.0f;
  for (int b0 = 0; b0 < blocks; b0 += T) {
    const int nb = min(T, blocks - b0);
    __syncthreads();
    for (int i = t; i < nb * ng; i += T) hist[i] = __ldcg(&partial[(size_t)b0 * ng + i]);
    __syncthreads();
    if (chunks > 1) {
      if (run < chunks)
        for (int r = ((run - b0 % chunks) + chunks) % chunks; r < nb; r += chunks)
          acc = __fadd_rn(acc, hist[r * ng + k0]);
    } else {
      for (int k = t; k < ng; k += T) {
        float s = b0 == 0 ? 0.0f : out[k];
        for (int r = 0; r < nb; ++r) s = __fadd_rn(s, hist[r * ng + k]);
        out[k] = s;
      }
    }
  }
  if (chunks > 1) {
    if (run < chunks) s_red[t] = acc;
    __syncthreads();
    if (t < ng) {
      float s = s_red[t];
      for (int c = 1; c < chunks; ++c) s = __fadd_rn(s, s_red[c * ng + t]);
      out[t] = s;
    }
  }
}

// Dynamic shared memory above the 48 KB default needs an opt-in per kernel.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace
