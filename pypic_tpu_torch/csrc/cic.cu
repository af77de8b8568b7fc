// CIC particle kernels of the implicit CN-Picard path, for Hopper (sm_90a).
//
// Three kernels, each the counterpart of a Pallas TPU kernel in
// pypic_tpu/ops/pallas_cic.py. They compute what the TPU kernels compute
// with plain CIC index arithmetic (cic_common.cuh, after
// pypic_tpu/ops/cic.py cic_indices_weights): idx_l = clip(floor(p), 0,
// num_cells - 1), w_r = p - idx_l, w_l = 1 - w_r, and the right node wraps
// to 0 on a periodic grid. The TPU kernels' tent windows, one-hot selectors and
// MXU contractions exist only for Mosaic and VMEM and are not carried
// over.
//
// Common design:
// * One thread per particle in a grid-stride loop with a bounds check, so
//   any n is legal (the counterpart of the TPU kernels' _lane_mask on the
//   padded tail). Particle arrays are flat (n,) float32.
// * The (ng,) field each block gathers from, and the (ng,) histogram each
//   block deposits into, live in dynamic shared memory; a block adds its
//   histogram to the global output with one atomicAdd per node at the end.
//   The field and the partial histograms never travel through device
//   memory, so device-memory traffic is the particle arrays alone.
// * The push and the wrap are written with __fmul_rn / __fadd_rn so that
//   nvcc does not contract them into FMAs: each operation rounds exactly
//   as the JAX reference's (and the plain PyTorch version's) separate
//   float32 operations do. The wrap is x - floor(x * (1/ng)) * ng, as in
//   the TPU kernels, not fmodf.
// * Float atomics make the deposits run-to-run non-reproducible at
//   round-off level (the JAX deposits are bit-deterministic).
// * A launcher returns cudaGetLastError(); it allocates nothing and runs
//   on the stream it is given.

#include "cic_common.cuh"

namespace {

// Crank-Nicolson push from the gathered field e (pypic.py:264-265):
// p1 = p0 + dt/dx v0 + qm dt^2/(2 dx) e, v1 = v0 + qm dt e.
__device__ __forceinline__ void cn_push(float p0, float v0, float e,
                                        float qm_dt, float qm_dt2_half,
                                        float dt_dx, float& p1, float& v1) {
  p1 = __fadd_rn(__fadd_rn(p0, __fmul_rn(dt_dx, v0)), __fmul_rn(qm_dt2_half, e));
  v1 = __fadd_rn(v0, __fmul_rn(qm_dt, e));
}

// ---------------------------------------------------------------------------
// picard_iteration
//
// Replaces pypic_tpu/ops/pallas_cic.py:_picard_iter_kernel
// (picard_iteration_pallas). One Picard pass: gather the smoothed field at
// the position guess ps, CN push, wrapped midpoint ph = (p0 + p1)/2, store
// ph (and v1 with EMIT_V), deposit w vh at ph into jh.
//
// Bound on the H100: device-memory bytes. It reads 12 B and writes 4 B per
// particle (8 B with EMIT_V): about 1.6 GB a pass at n = 1e8. The field and
// the partial histogram stay in shared memory; the per-particle deposit is
// two shared-memory float atomics, whose bank conflicts grow as particles of
// one warp share a node (the load is in random order at ng = 200).
// ---------------------------------------------------------------------------
template <bool EMIT_V>
__global__ void picard_iteration_kernel(
    const float* __restrict__ field, const float* __restrict__ ps,
    const float* __restrict__ p0, const float* __restrict__ v0,
    float* __restrict__ ph_out, float* __restrict__ v1_out,
    float* __restrict__ jh, long long n, int ng, float qm_dt,
    float qm_dt2_half, float dt_dx, float w, float inv_ng) {
  extern __shared__ float smem[];
  float* s_field = smem;
  float* s_hist = smem + ng;
  for (int i = threadIdx.x; i < ng; i += blockDim.x) {
    s_field[i] = field[i];
    s_hist[i] = 0.0f;
  }
  __syncthreads();
  const float ngf = (float)ng;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float a = p0[i];
    const float b = v0[i];
    const float e = gather(s_field, cic_periodic(ps[i], ng));
    float p1, v1;
    cn_push(a, b, e, qm_dt, qm_dt2_half, dt_dx, p1, v1);
    const float h = wrap(__fmul_rn(0.5f, __fadd_rn(a, p1)), ngf, inv_ng);
    const float vh = __fmul_rn(0.5f, __fadd_rn(b, v1));
    ph_out[i] = h;
    if (EMIT_V) v1_out[i] = v1;
    const float val = __fmul_rn(w, vh);
    const Cic c = cic_periodic(h, ng);
    atomicAdd(&s_hist[c.l], __fmul_rn(val, c.wl));
    atomicAdd(&s_hist[c.r], __fmul_rn(val, c.wr));
  }
  __syncthreads();
  for (int i = threadIdx.x; i < ng; i += blockDim.x) atomicAdd(&jh[i], s_hist[i]);
}

// ---------------------------------------------------------------------------
// picard_finalize_nodep
//
// Replaces pypic_tpu/ops/pallas_cic.py:_picard_final_nodep_kernel
// (picard_finalize_nodep_pallas). The same gather and CN push from the
// converged field, then wrap p1 and store (p1, v1). No deposit.
//
// Bound on the H100: device-memory bytes, 12 B in and 8 B out per
// particle, a pure stream. The field sits in shared memory, so the gather
// costs no device-memory traffic.
// ---------------------------------------------------------------------------
__global__ void picard_finalize_nodep_kernel(
    const float* __restrict__ field, const float* __restrict__ ps,
    const float* __restrict__ p0, const float* __restrict__ v0,
    float* __restrict__ p1_out, float* __restrict__ v1_out, long long n,
    int ng, float qm_dt, float qm_dt2_half, float dt_dx, float inv_ng) {
  extern __shared__ float s_field[];
  for (int i = threadIdx.x; i < ng; i += blockDim.x) s_field[i] = field[i];
  __syncthreads();
  const float ngf = (float)ng;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float e = gather(s_field, cic_periodic(ps[i], ng));
    float p1, v1;
    cn_push(p0[i], v0[i], e, qm_dt, qm_dt2_half, dt_dx, p1, v1);
    p1_out[i] = wrap(p1, ngf, inv_ng);
    v1_out[i] = v1;
  }
}

// ---------------------------------------------------------------------------
// deposit
//
// Replaces pypic_tpu/ops/pallas_cic.py:_deposit_kernel (deposit_pallas).
// CIC deposit of per-particle values at grid positions, periodic or
// bounded.
//
// Bound on the H100: device-memory bytes, 8 B read per particle, and the
// shared-memory atomics behind them. The histogram stays in shared memory
// and reaches device memory once per block.
// ---------------------------------------------------------------------------
template <bool PERIODIC>
__global__ void deposit_kernel(const float* __restrict__ p,
                               const float* __restrict__ values,
                               float* __restrict__ out, long long n, int ng) {
  extern __shared__ float s_hist[];
  for (int i = threadIdx.x; i < ng; i += blockDim.x) s_hist[i] = 0.0f;
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float val = values[i];
    const Cic c = PERIODIC ? cic_periodic(p[i], ng) : cic_bounded(p[i], ng);
    atomicAdd(&s_hist[c.l], __fmul_rn(val, c.wl));
    atomicAdd(&s_hist[c.r], __fmul_rn(val, c.wr));
  }
  __syncthreads();
  for (int i = threadIdx.x; i < ng; i += blockDim.x) atomicAdd(&out[i], s_hist[i]);
}

}  // namespace

extern "C" {

int pypic_picard_iteration(const float* field, const float* ps, const float* p0,
                           const float* v0, float* ph, float* v1, float* jh,
                           long long n, int ng, float qm_dt, float qm_dt2_half,
                           float dt_dx, float w, float inv_ng, int blocks,
                           int threads, void* stream) {
  const size_t smem = 2 * (size_t)ng * sizeof(float);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (v1 != nullptr) {
    err = allow_smem(picard_iteration_kernel<true>, smem);
    if (err != cudaSuccess) return (int)err;
    picard_iteration_kernel<true><<<blocks, threads, smem, s>>>(
        field, ps, p0, v0, ph, v1, jh, n, ng, qm_dt, qm_dt2_half, dt_dx, w, inv_ng);
  } else {
    err = allow_smem(picard_iteration_kernel<false>, smem);
    if (err != cudaSuccess) return (int)err;
    picard_iteration_kernel<false><<<blocks, threads, smem, s>>>(
        field, ps, p0, v0, ph, nullptr, jh, n, ng, qm_dt, qm_dt2_half, dt_dx, w,
        inv_ng);
  }
  return (int)cudaGetLastError();
}

int pypic_picard_finalize_nodep(const float* field, const float* ps,
                                const float* p0, const float* v0, float* p1,
                                float* v1, long long n, int ng, float qm_dt,
                                float qm_dt2_half, float dt_dx, float inv_ng,
                                int blocks, int threads, void* stream) {
  const size_t smem = (size_t)ng * sizeof(float);
  cudaError_t err = allow_smem(picard_finalize_nodep_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  picard_finalize_nodep_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      field, ps, p0, v0, p1, v1, n, ng, qm_dt, qm_dt2_half, dt_dx, inv_ng);
  return (int)cudaGetLastError();
}

int pypic_deposit(const float* p, const float* values, float* out, long long n,
                  int ng, int periodic, int blocks, int threads, void* stream) {
  const size_t smem = (size_t)ng * sizeof(float);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (periodic) {
    err = allow_smem(deposit_kernel<true>, smem);
    if (err != cudaSuccess) return (int)err;
    deposit_kernel<true><<<blocks, threads, smem, s>>>(p, values, out, n, ng);
  } else {
    err = allow_smem(deposit_kernel<false>, smem);
    if (err != cudaSuccess) return (int)err;
    deposit_kernel<false><<<blocks, threads, smem, s>>>(p, values, out, n, ng);
  }
  return (int)cudaGetLastError();
}

const char* pypic_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
