// CIC helpers shared by the particle kernels (cic.cu, explicit.cu,
// implicit.cu, magnetized.cu).
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

// Dynamic shared memory above the 48 KB default needs an opt-in per kernel.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace
