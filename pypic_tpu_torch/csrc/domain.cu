// Particle kernels of the domain-decomposed engines, for Hopper (sm_90a).
//
// Four kernels, each the counterpart of a Pallas TPU kernel in
// pypic_tpu/ops/pallas_cic.py:
//
// * picard_iteration_ext<EMIT_V, SHARED> — _picard_iter_ext_kernel and
//   _picard_iter_ext_sw_kernel (picard_iteration_ext_pallas): one Picard
//   pass of a slab on its halo-extended field;
// * picard_finalize_ext<DEPOSIT> — _picard_final_ext_nodep_kernel
//   (picard_finalize_ext_nodep_pallas, DEPOSIT false) and
//   _picard_final_ext_kernel (picard_finalize_ext_pallas, DEPOSIT true),
//   in stats mode: the converged finalize sweep of a slab, with the
//   global wrap and the step statistics in its epilogue;
// * leapfrog_gather_push — _leapfrog_kernel (leapfrog_gather_push_pallas):
//   periodic gather from the replicated global field, kick-drift-kick,
//   wrap.
//
// The slab forms differ from the periodic ones of cic.cu:
// * the field is a BOUNDED extended slab of ext_n = c + 2 hw + 1 nodes
//   (hw = halo + 2), with no wrap: the ring halo exchange outside the
//   kernel gives the periodicity;
// * the deposit weight w is a per-particle array, zero in dead slots (the
//   alive mask folded in), not a scalar;
// * positions are clamped to [lo, hi] for the gather and the deposit only,
//   and the RAW iterate is stored, so the caller counts halo excursions
//   exactly;
// * the finalize has a statistics epilogue.
//
// The TPU kernels' window decomposition, tent and selector matrices and
// (nb, 1, block) layout exist for Mosaic and VMEM and are not carried
// over; the CIC arithmetic is cic_common.cuh's. The shared-window pass
// keeps the TPU frame's ARITHMETIC (not its selectors), because the frame
// decides which deposits clamp and so the picard_clamped count.
//
// Launchers return cudaGetLastError(); they allocate nothing and run on
// the stream they are given.

#include "cic_common.cuh"

namespace {

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// ---------------------------------------------------------------------------
// picard_iteration_ext
//
// Replaces _picard_iter_ext_kernel (SHARED false) and
// _picard_iter_ext_sw_kernel (SHARED true), pallas_cic.py:1847, :1882.
// Gather the smoothed extended field at clamp(ps), CN push, store the raw
// midpoint ph (and v1 with EMIT_V), deposit w vh into jh (ext_n nodes).
//
// Without SHARED the deposit sits at clamp(ph). With SHARED it sits at the
// midpoint as seen from the gather's window frame: windows start every
// win_stride nodes, k = clip(int(floor(s) * (1/win_stride)), 0, K - 1),
// row l of window k is node win_stride k + l - 1, and the deposit sits at
// row d_h = (s - k win_stride + 1) + (clamp(ph) - s). A d_h outside
// [0, width - 1] is clamped to that edge and, for a live particle
// (w != 0), counted; a node outside [0, ext_n) takes nothing (the TPU
// fold drops it).
//
// `active` (may be null): when it points at 0 the kernel returns at once
// and writes nothing. The engine's Picard loop runs its passes without
// reading the residual on the host; a pass after convergence then leaves
// ph (written in place over ps) and v1 as they were. ps and ph may alias,
// so neither is __restrict__: each thread reads ps[i] before it writes
// ph[i].
//
// Bound on the H100: device-memory bytes, 16 B read and 4 B written a
// particle (8 B with EMIT_V). The field and the partial histogram stay in
// shared memory (2 ext_n floats); each block flushes its histogram with
// one global atomic a node. The clamp count is kept per block and added
// to the int32 total with one atomic a block, so it is exact.
// ---------------------------------------------------------------------------
template <bool EMIT_V, bool SHARED>
__global__ void picard_iteration_ext_kernel(
    const float* __restrict__ field, const float* ps,
    const float* __restrict__ p0, const float* __restrict__ v0,
    const float* __restrict__ w, float* ph_out, float* v1_out,
    float* __restrict__ jh, int* __restrict__ n_clamped,
    const int* __restrict__ active, long long n, int ext_n, float qm_dt,
    float qm_dt2_half, float dt_dx, float lo, float hi, int win_stride,
    int width, int num_k, float inv_stride) {
  if (active != nullptr && *active == 0) return;  // uniform across the grid
  extern __shared__ float smem[];
  float* s_field = smem;
  float* s_hist = smem + ext_n;
  __shared__ int s_clamped;
  for (int i = threadIdx.x; i < ext_n; i += blockDim.x) {
    s_field[i] = field[i];
    s_hist[i] = 0.0f;
  }
  if (SHARED && threadIdx.x == 0) s_clamped = 0;
  __syncthreads();
  const float top = (float)(width - 1);
  int clamped = 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float s = clampf(ps[i], lo, hi);
    const float a = p0[i];
    const float b = v0[i];
    const float wi = w[i];
    const float e = gather(s_field, cic_bounded(s, ext_n));
    float p1, v1;
    cn_push(a, b, e, qm_dt, qm_dt2_half, dt_dx, p1, v1);
    const float raw = __fmul_rn(0.5f, __fadd_rn(a, p1));
    const float vh = __fmul_rn(0.5f, __fadd_rn(b, v1));
    ph_out[i] = raw;  // the raw iterate: excursions are counted outside
    if (EMIT_V) v1_out[i] = v1;
    const float val = __fmul_rn(wi, vh);
    const float hc = clampf(raw, lo, hi);
    if (SHARED) {
      const int k = min(max((int)__fmul_rn(floorf(s), inv_stride), 0), num_k - 1);
      const float d_s = __fadd_rn(__fsub_rn(s, (float)(k * win_stride)), 1.0f);
      float d_h = __fadd_rn(d_s, __fsub_rn(hc, s));
      if (d_h < 0.0f || d_h > top) {
        if (wi != 0.0f) ++clamped;
        d_h = fminf(fmaxf(d_h, 0.0f), top);
      }
      const int row = min((int)floorf(d_h), width - 2);
      const float wr = __fsub_rn(d_h, (float)row);
      const float wl = __fsub_rn(1.0f, wr);
      const int l = win_stride * k + row - 1;
      if (l >= 0 && l < ext_n) atomicAdd(&s_hist[l], __fmul_rn(val, wl));
      if (l + 1 >= 0 && l + 1 < ext_n) atomicAdd(&s_hist[l + 1], __fmul_rn(val, wr));
    } else {
      const Cic c = cic_bounded(hc, ext_n);
      atomicAdd(&s_hist[c.l], __fmul_rn(val, c.wl));
      atomicAdd(&s_hist[c.r], __fmul_rn(val, c.wr));
    }
  }
  if (SHARED && clamped) atomicAdd(&s_clamped, clamped);
  __syncthreads();
  for (int i = threadIdx.x; i < ext_n; i += blockDim.x) atomicAdd(&jh[i], s_hist[i]);
  if (SHARED && threadIdx.x == 0 && s_clamped) atomicAdd(n_clamped, s_clamped);
}

// ---------------------------------------------------------------------------
// picard_finalize_ext
//
// Replaces _picard_final_ext_nodep_kernel (DEPOSIT false,
// pallas_cic.py:2019) and _picard_final_ext_kernel (DEPOSIT true, l.1987),
// both in stats mode (_finalize_epilogue, l.1946). The gather and CN push
// of the pass from the converged field, then:
// * with DEPOSIT, the full-step current w v1 deposited at clamp(p1) onto
//   the extended slab (j1, ext_n nodes, float atomics as the pass);
// * the position p1 + lo_shift (lo_shift = lo - hw, the slab's offset),
//   wrapped to the global [0, ng) when ng > 0, kept raw when ng == 0;
// * three statistics: sum w v1, sum over live slots (w != 0) of v1^2, and
//   the live slots whose raw p1 lies outside [lo, hi] (the halo clamps).
//
// The statistics are not added with float atomics, so they repeat bit for
// bit: each thread sums its particles in float64 in its grid-stride order,
// block_sum adds the threads in warp order, and each block writes its three
// partials; ext_stats_sum (a second launch of one block) adds the partials
// in block order. The count is exact in float64 up to 2^53.
//
// Bound on the H100: device-memory bytes, 16 B read and 8 B written a
// particle. The field (and the histogram) stay in shared memory; the
// partials are 24 B a block.
// ---------------------------------------------------------------------------
template <bool DEPOSIT>
__global__ void picard_finalize_ext_kernel(
    const float* __restrict__ field, const float* __restrict__ ps,
    const float* __restrict__ p0, const float* __restrict__ v0,
    const float* __restrict__ w, float* __restrict__ p1_out,
    float* __restrict__ v1_out, float* __restrict__ j1,
    double* __restrict__ partial, long long n, int ext_n, float qm_dt,
    float qm_dt2_half, float dt_dx, float lo, float hi, float lo_shift, int ng,
    float inv_ng) {
  extern __shared__ float smem[];
  float* s_field = smem;
  float* s_hist = smem + ext_n;
  __shared__ double red[32];
  for (int i = threadIdx.x; i < ext_n; i += blockDim.x) {
    s_field[i] = field[i];
    if (DEPOSIT) s_hist[i] = 0.0f;
  }
  __syncthreads();
  const float ngf = (float)ng;
  double s_wv = 0.0, s_vv = 0.0, s_cl = 0.0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float s = clampf(ps[i], lo, hi);
    const float e = gather(s_field, cic_bounded(s, ext_n));
    float p1, v1;
    cn_push(p0[i], v0[i], e, qm_dt, qm_dt2_half, dt_dx, p1, v1);
    const float wi = w[i];
    v1_out[i] = v1;
    if (DEPOSIT) {
      const float val = __fmul_rn(wi, v1);
      const Cic c = cic_bounded(clampf(p1, lo, hi), ext_n);
      atomicAdd(&s_hist[c.l], __fmul_rn(val, c.wl));
      atomicAdd(&s_hist[c.r], __fmul_rn(val, c.wr));
    }
    s_wv += (double)__fmul_rn(wi, v1);
    if (wi != 0.0f) {
      s_vv += (double)__fmul_rn(v1, v1);
      if (p1 < lo || p1 > hi) s_cl += 1.0;
    }
    float pg = __fadd_rn(p1, lo_shift);
    if (ng > 0) pg = wrap(pg, ngf, inv_ng);
    p1_out[i] = pg;
  }
  if (DEPOSIT) {
    __syncthreads();
    for (int i = threadIdx.x; i < ext_n; i += blockDim.x) atomicAdd(&j1[i], s_hist[i]);
  }
  s_wv = block_sum(s_wv, red);
  s_vv = block_sum(s_vv, red);
  s_cl = block_sum(s_cl, red);
  if (threadIdx.x == 0) {
    partial[3 * (size_t)blockIdx.x + 0] = s_wv;
    partial[3 * (size_t)blockIdx.x + 1] = s_vv;
    partial[3 * (size_t)blockIdx.x + 2] = s_cl;
  }
}

// One block: stats[j] = sum over blocks of partial[3 b + j], each thread
// taking the blocks t, t + T, ... in order and block_sum adding the
// threads in warp order (the same bits from run to run).
__global__ void ext_stats_sum_kernel(const double* __restrict__ partial,
                                     int blocks, double* __restrict__ stats) {
  __shared__ double red[32];
  for (int j = 0; j < 3; ++j) {
    double acc = 0.0;
    for (int b = threadIdx.x; b < blocks; b += blockDim.x) acc += partial[3 * (size_t)b + j];
    acc = block_sum(acc, red);
    if (threadIdx.x == 0) stats[j] = acc;
  }
}

// ---------------------------------------------------------------------------
// leapfrog_gather_push
//
// Replaces _leapfrog_kernel (leapfrog_gather_push_pallas,
// pallas_cic.py:849): the periodic CIC gather of the replicated global
// field, kick-drift-kick and the periodic wrap, (p1, v1):
//   vh = v + qmh e;  p1 = wrap(p + vh dt_dx);  v1 = vh + qmh e
// (explicit.cu's leapfrog_deposit sweep without the deposit). The floor
// wrap can land on ng itself or a rounding past either end; the step
// then takes its remainder mod ng (parallel/domain.py:637 in the JAX
// package), which the kernel folds in: remainder(x, ng) for x within one
// ng of [0, ng) is x - ng at or above ng and x + ng below 0, the same
// roundings, so the engine needs no pass of its own for it.
//
// Bound on the H100: device-memory bytes, 8 B read and 8 B written a
// particle. The field sits in shared memory.
// ---------------------------------------------------------------------------
__global__ void leapfrog_push_kernel(const float* __restrict__ field,
                                     const float* __restrict__ p,
                                     const float* __restrict__ v,
                                     float* __restrict__ p1_out,
                                     float* __restrict__ v1_out, long long n,
                                     int ng, float qmh, float dt_dx,
                                     float inv_ng) {
  extern __shared__ float s_field[];
  for (int i = threadIdx.x; i < ng; i += blockDim.x) s_field[i] = field[i];
  __syncthreads();
  const float ngf = (float)ng;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float a = p[i];
    const float kick = __fmul_rn(qmh, gather(s_field, cic_periodic(a, ng)));
    const float vh = __fadd_rn(v[i], kick);
    float p1 = wrap(__fadd_rn(a, __fmul_rn(vh, dt_dx)), ngf, inv_ng);
    if (p1 >= ngf)
      p1 = __fsub_rn(p1, ngf);
    else if (p1 < 0.0f)
      p1 = __fadd_rn(p1, ngf);
    p1_out[i] = p1;
    v1_out[i] = __fadd_rn(vh, kick);
  }
}

template <bool EMIT_V, bool SHARED>
cudaError_t launch_iteration_ext(int blocks, int threads, cudaStream_t s,
                                 const float* field, const float* ps,
                                 const float* p0, const float* v0,
                                 const float* w, float* ph, float* v1,
                                 float* jh, int* n_clamped, const int* active,
                                 long long n, int ext_n, float qm_dt,
                                 float qm_dt2_half, float dt_dx, float lo,
                                 float hi, int win_stride, int width,
                                 int num_k, float inv_stride) {
  const size_t smem = 2 * (size_t)ext_n * sizeof(float);
  cudaError_t err = allow_smem(picard_iteration_ext_kernel<EMIT_V, SHARED>, smem);
  if (err != cudaSuccess) return err;
  picard_iteration_ext_kernel<EMIT_V, SHARED><<<blocks, threads, smem, s>>>(
      field, ps, p0, v0, w, ph, v1, jh, n_clamped, active, n, ext_n, qm_dt,
      qm_dt2_half, dt_dx, lo, hi, win_stride, width, num_k, inv_stride);
  return cudaGetLastError();
}

template <bool DEPOSIT>
cudaError_t launch_finalize_ext(int blocks, int threads, cudaStream_t s,
                                const float* field, const float* ps,
                                const float* p0, const float* v0,
                                const float* w, float* p1, float* v1,
                                float* j1, double* partial, double* stats,
                                long long n, int ext_n, float qm_dt,
                                float qm_dt2_half, float dt_dx, float lo,
                                float hi, float lo_shift, int ng,
                                float inv_ng) {
  const size_t smem = (DEPOSIT ? 2 : 1) * (size_t)ext_n * sizeof(float);
  cudaError_t err = allow_smem(picard_finalize_ext_kernel<DEPOSIT>, smem);
  if (err != cudaSuccess) return err;
  picard_finalize_ext_kernel<DEPOSIT><<<blocks, threads, smem, s>>>(
      field, ps, p0, v0, w, p1, v1, j1, partial, n, ext_n, qm_dt, qm_dt2_half,
      dt_dx, lo, hi, lo_shift, ng, inv_ng);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ext_stats_sum_kernel<<<1, 256, 0, s>>>(partial, blocks, stats);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// jh: ext_n zeroed floats; n_clamped: one zeroed int (shared only);
// v1: null unless the iterate's velocity is wanted; active: null or one
// int on the card (0: the launch does nothing).
int pypic_picard_iteration_ext(
    const float* field, const float* ps, const float* p0, const float* v0,
    const float* w, float* ph, float* v1, float* jh, int* n_clamped,
    const int* active, long long n, int ext_n, float qm_dt, float qm_dt2_half,
    float dt_dx, float lo, float hi, int shared, int win_stride, int width,
    int num_k, float inv_stride, int blocks, int threads, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define PYPIC_ITER_EXT(EV, SH)                                                  \
  launch_iteration_ext<EV, SH>(blocks, threads, s, field, ps, p0, v0, w, ph,    \
                               v1, jh, n_clamped, active, n, ext_n, qm_dt,      \
                               qm_dt2_half, dt_dx, lo, hi, win_stride, width,   \
                               num_k, inv_stride)
  cudaError_t err;
  if (shared)
    err = v1 != nullptr ? PYPIC_ITER_EXT(true, true) : PYPIC_ITER_EXT(false, true);
  else
    err = v1 != nullptr ? PYPIC_ITER_EXT(true, false) : PYPIC_ITER_EXT(false, false);
#undef PYPIC_ITER_EXT
  return (int)err;
}

// j1: ext_n zeroed floats (deposit only, else null); partial: 3 * blocks
// doubles of scratch; stats: 3 doubles, written whole.
int pypic_picard_finalize_ext(
    const float* field, const float* ps, const float* p0, const float* v0,
    const float* w, float* p1, float* v1, float* j1, double* partial,
    double* stats, long long n, int ext_n, float qm_dt, float qm_dt2_half,
    float dt_dx, float lo, float hi, float lo_shift, int ng, float inv_ng,
    int blocks, int threads, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(j1 != nullptr
      ? launch_finalize_ext<true>(blocks, threads, s, field, ps, p0, v0, w, p1,
                                  v1, j1, partial, stats, n, ext_n, qm_dt,
                                  qm_dt2_half, dt_dx, lo, hi, lo_shift, ng,
                                  inv_ng)
      : launch_finalize_ext<false>(blocks, threads, s, field, ps, p0, v0, w,
                                   p1, v1, nullptr, partial, stats, n, ext_n,
                                   qm_dt, qm_dt2_half, dt_dx, lo, hi, lo_shift,
                                   ng, inv_ng));
}

int pypic_leapfrog_push(const float* field, const float* p, const float* v,
                        float* p1, float* v1, long long n, int ng, float qmh,
                        float dt_dx, float inv_ng, int blocks, int threads,
                        void* stream) {
  const size_t smem = (size_t)ng * sizeof(float);
  cudaError_t err = allow_smem(leapfrog_push_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  leapfrog_push_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      field, p, v, p1, v1, n, ng, qmh, dt_dx, inv_ng);
  return (int)cudaGetLastError();
}

}  // extern "C"
