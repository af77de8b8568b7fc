// Particle kernels of the domain-decomposed engines, for Hopper (sm_90a).
//
// Five kernels, each the counterpart of a Pallas TPU kernel in
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
// * explicit_domain_cycle — _domain_cycle_kernel
//   (explicit_domain_cycle_pallas): the same sweep, plus the deposit of
//   the new positions onto the halo-extended slab (carried_rho='on').
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
// Each of the four per-step sweeps keeps its (ext_n,) or (ng,) arrays in
// shared memory up to its ceiling and takes the large modes of
// cic_common.cuh above it (ops/cuda_cic.py smem_mode, the ceilings in
// each section): the field read from device memory (kGlobal), every add
// a global float atomic into the zeroed output. Each mode is its own
// instantiation; the shared mode's code is unchanged. The slab pass also
// has the cluster and pair modes of rows 1 and 2 (its section;
// ops/cuda_cic.py cluster_launch picks them from the forced pairs).
//
// Launchers return cudaGetLastError(); they allocate nothing and run on
// the stream they are given.

#include "cic_common.cuh"

namespace cg = cooperative_groups;

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
//
// The large mode (kGlobal) above ext_n = 29,056 (29,054 with SHARED: the
// clamp count's 16 static bytes). Bound there: the rows' 20 B (24 with
// EMIT_V), plus the field read and jh written once: 8 B a node.
//
// MODE kCluster and kPair (ops/cuda_cic.py cluster_launch, PASS_RULE: the
// modes rows 1 and 2 take in cic.cu, on the bounded slab): kGlobal's sweep,
// so ph, v1 and the clamp count are its bits, and only where a row's two
// products land changes. kCluster: the (ext_n,) sum in the slices of a
// thread-block cluster's CTAs, one 1,024-thread CTA an SM
// (cic_common.cuh cluster_add_bounded: no wrap, a product at a node
// outside [0, ext_n) dropped as kGlobal drops it), one global atomic a
// node and CTA in the flush. kPair: both products one
// red.global.add.v2.f32 at row l + 1 of a zeroed (ext_n + 1, 2) pair
// array, then pair_fold_bounded_kernel; the shared window's rows at l =
// -1 and l = ext_n - 1 put their outside product in a cell the fold never
// reads, and a row with both nodes outside adds nothing. `active` is read
// before the first cluster.sync(): a kernel earlier on the stream wrote
// it, so every CTA of every cluster returns or none does.
// ---------------------------------------------------------------------------
template <bool EMIT_V, bool SHARED, int MODE>
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
  if (MODE == kShared) {
    for (int i = threadIdx.x; i < ext_n; i += blockDim.x) {
      s_field[i] = field[i];
      s_hist[i] = 0.0f;
    }
  }
  float* hist = MODE == kShared ? s_hist : jh;
  if (SHARED && threadIdx.x == 0) s_clamped = 0;
  [[maybe_unused]] int slice = 0;  // kCluster: the nodes a CTA owns (at smem)
  if constexpr (MODE == kCluster) {
    cg::cluster_group cluster = cg::this_cluster();
    const int ctas = (int)cluster.num_blocks();
    slice = (ext_n + ctas - 1) / ctas;
    for (int i = threadIdx.x; i < slice; i += blockDim.x) smem[i] = 0.0f;
    cluster.sync();  // every slice zeroed and live before any remote add
  } else {
    __syncthreads();
  }
  const float top = (float)(width - 1);
  int clamped = 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float s = clampf(ps[i], lo, hi);
    const float a = p0[i];
    const float b = v0[i];
    const float wi = w[i];
    const float e = gather_mode<MODE>(s_field, field, cic_bounded(s, ext_n));
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
      if constexpr (MODE == kCluster) {
        cluster_add_bounded(smem, slice, ext_n, l, __fmul_rn(val, wl), __fmul_rn(val, wr));
      } else if constexpr (MODE == kPair) {
        if (l >= -1 && l < ext_n) pair_add(jh, l + 1, __fmul_rn(val, wl), __fmul_rn(val, wr));
      } else {
        if (l >= 0 && l < ext_n) atomicAdd(&hist[l], __fmul_rn(val, wl));
        if (l + 1 >= 0 && l + 1 < ext_n) atomicAdd(&hist[l + 1], __fmul_rn(val, wr));
      }
    } else {
      const Cic c = cic_bounded(hc, ext_n);
      if constexpr (MODE == kCluster) {
        cluster_add_bounded(smem, slice, ext_n, c.l, __fmul_rn(val, c.wl),
                            __fmul_rn(val, c.wr));
      } else if constexpr (MODE == kPair) {
        pair_add(jh, c.l + 1, __fmul_rn(val, c.wl), __fmul_rn(val, c.wr));
      } else {
        atomicAdd(&hist[c.l], __fmul_rn(val, c.wl));
        atomicAdd(&hist[c.r], __fmul_rn(val, c.wr));
      }
    }
  }
  if (SHARED && clamped) atomicAdd(&s_clamped, clamped);
  if constexpr (MODE == kCluster) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // every add into this slice has landed
    const int lo = (int)cluster.block_rank() * slice;
    const int count = min(slice, ext_n - lo);
    for (int i = threadIdx.x; i < count; i += blockDim.x) atomicAdd(&jh[lo + i], smem[i]);
  } else {
    __syncthreads();
  }
  if (MODE == kShared)
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
//
// The large mode (kGlobal; the block_sum's 256 static bytes counted):
// with DEPOSIT above ext_n = 29,024, without it above 58,048. The
// statistics keep their float64 sums and fixed order in both modes. Bound
// there: the rows' 24 B, plus the field read and j1 written once
// (DEPOSIT): up to 8 B a node.
// ---------------------------------------------------------------------------
template <bool DEPOSIT, int MODE>
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
  if (MODE == kShared) {
    for (int i = threadIdx.x; i < ext_n; i += blockDim.x) {
      s_field[i] = field[i];
      if (DEPOSIT) s_hist[i] = 0.0f;
    }
  }
  float* hist = MODE == kShared ? s_hist : j1;
  __syncthreads();
  const float ngf = (float)ng;
  double s_wv = 0.0, s_vv = 0.0, s_cl = 0.0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float s = clampf(ps[i], lo, hi);
    const float e = gather_mode<MODE>(s_field, field, cic_bounded(s, ext_n));
    float p1, v1;
    cn_push(p0[i], v0[i], e, qm_dt, qm_dt2_half, dt_dx, p1, v1);
    const float wi = w[i];
    v1_out[i] = v1;
    if (DEPOSIT) {
      const float val = __fmul_rn(wi, v1);
      const Cic c = cic_bounded(clampf(p1, lo, hi), ext_n);
      atomicAdd(&hist[c.l], __fmul_rn(val, c.wl));
      atomicAdd(&hist[c.r], __fmul_rn(val, c.wr));
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
  if (DEPOSIT && MODE == kShared) {
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
// particle. The field sits in shared memory; above 58,112 nodes MODE is
// kGlobal, the field read from device memory (bound: the rows' 16 B and
// the field's 4 B a node read once).
// ---------------------------------------------------------------------------
template <int MODE>
__global__ void leapfrog_push_kernel(const float* __restrict__ field,
                                     const float* __restrict__ p,
                                     const float* __restrict__ v,
                                     float* __restrict__ p1_out,
                                     float* __restrict__ v1_out, long long n,
                                     int ng, float qmh, float dt_dx,
                                     float inv_ng) {
  extern __shared__ float s_field[];
  load_field<MODE>(s_field, field, ng);
  __syncthreads();
  const float ngf = (float)ng;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float a = p[i];
    const float kick = __fmul_rn(qmh, gather_mode<MODE>(s_field, field, cic_periodic(a, ng)));
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

// ---------------------------------------------------------------------------
// explicit_domain_cycle
//
// Replaces _domain_cycle_kernel (explicit_domain_cycle_pallas,
// pallas_cic.py:896), the carried-rho explicit domain cycle as one sweep:
// leapfrog_push_kernel's gather of the replicated global (ng,) field at p,
// kick-drift-kick and wrap, plus the deposit of w at the RAW new position
// p1 onto the (ext_n,) extended slab of this rank, at ploc = p1 -
// lo_shifted (lo_shifted = lo - halo, a per-rank float32 argument). A
// ploc outside [0, ext_n - 1] clamps to that edge and, where w != 0, is
// counted. The TPU kernel's second window system over the slab tents the
// same two nodes with the same weights as CIC at ploc (its fold drops
// the zero-weight node past the last), so the bounded CIC of
// cic_common.cuh takes its place. Dead slots carry w = 0: they deposit
// nothing and count no clamp, but their p1 and v1 are written as any
// row's (the step zeroes them).
//
// The stored p1 is the wrapped one with the step's mod ng folded in, as
// leapfrog_push_kernel stores it.
//
// Bound on the H100: device-memory bytes, 12 B read (p, v, w) and 8 B
// written (p1, v1) a particle. The field and the slab histogram live in
// shared memory (ng + ext_n floats); each block flushes its histogram
// with one global atomic a node and adds its clamp count with one integer
// atomic, so the count is exact.
//
// The large mode (kGlobal) where ng + ext_n floats and the clamp count's
// static word no longer fit a block: the global field read from device
// memory, each add a global float atomic into the zeroed rho_ext. Bound
// there: the rows' 20 B, plus the field read and rho_ext written once.
// ---------------------------------------------------------------------------
template <int MODE>
__global__ void domain_cycle_kernel(const float* __restrict__ field,
                                    const float* __restrict__ p,
                                    const float* __restrict__ v,
                                    const float* __restrict__ w,
                                    float* __restrict__ p1_out,
                                    float* __restrict__ v1_out,
                                    float* __restrict__ rho_ext,
                                    int* __restrict__ n_clamped, long long n,
                                    int ng, int ext_n, float qmh, float dt_dx,
                                    float lo_shifted, float inv_ng) {
  extern __shared__ float smem[];
  float* s_field = smem;
  float* s_hist = smem + ng;
  __shared__ int s_clamped;
  load_field<MODE>(s_field, field, ng);
  if (MODE == kShared)
    for (int i = threadIdx.x; i < ext_n; i += blockDim.x) s_hist[i] = 0.0f;
  float* hist = MODE == kShared ? s_hist : rho_ext;
  if (threadIdx.x == 0) s_clamped = 0;
  __syncthreads();
  const float ngf = (float)ng;
  const float top = (float)(ext_n - 1);
  int clamped = 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float a = p[i];
    const float kick = __fmul_rn(qmh, gather_mode<MODE>(s_field, field, cic_periodic(a, ng)));
    const float vh = __fadd_rn(v[i], kick);
    const float raw = __fadd_rn(a, __fmul_rn(vh, dt_dx));
    float p1 = wrap(raw, ngf, inv_ng);
    if (p1 >= ngf)
      p1 = __fsub_rn(p1, ngf);
    else if (p1 < 0.0f)
      p1 = __fadd_rn(p1, ngf);
    p1_out[i] = p1;
    v1_out[i] = __fadd_rn(vh, kick);
    const float wi = w[i];
    if (wi == 0.0f) continue;
    float ploc = __fsub_rn(raw, lo_shifted);
    if (ploc < 0.0f || ploc > top) {
      ++clamped;
      ploc = fminf(fmaxf(ploc, 0.0f), top);
    }
    const Cic c = cic_bounded(ploc, ext_n);
    atomicAdd(&hist[c.l], __fmul_rn(wi, c.wl));
    atomicAdd(&hist[c.r], __fmul_rn(wi, c.wr));
  }
  if (clamped) atomicAdd(&s_clamped, clamped);
  __syncthreads();
  if (MODE == kShared)
    for (int i = threadIdx.x; i < ext_n; i += blockDim.x) atomicAdd(&rho_ext[i], s_hist[i]);
  if (threadIdx.x == 0 && s_clamped) atomicAdd(n_clamped, s_clamped);
}

// Launches picard_iteration_ext_kernel<EMIT_V, SHARED, mode>: kCluster
// (mode 2) in clusters of `cluster` CTAs, a slice of ceil(ext_n / cluster)
// floats each; kPair (mode 3) on the 3 ext_n + 2 floats at jh, the pair
// array then the sum, and the fold after it; else after the shared-memory
// opt-in.
template <bool EMIT_V, bool SHARED>
cudaError_t launch_iteration_ext(int mode, int blocks, int threads, int cluster,
                                 cudaStream_t s, const float* field, const float* ps,
                                 const float* p0, const float* v0,
                                 const float* w, float* ph, float* v1,
                                 float* jh, int* n_clamped, const int* active,
                                 long long n, int ext_n, float qm_dt,
                                 float qm_dt2_half, float dt_dx, float lo,
                                 float hi, int win_stride, int width,
                                 int num_k, float inv_stride) {
  if (mode == kPair) {
    picard_iteration_ext_kernel<EMIT_V, SHARED, kPair><<<blocks, threads, 0, s>>>(
        field, ps, p0, v0, w, ph, v1, jh, n_clamped, active, n, ext_n, qm_dt,
        qm_dt2_half, dt_dx, lo, hi, win_stride, width, num_k, inv_stride);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    pair_fold_bounded_kernel<float><<<(ext_n + 255) / 256, 256, 0, s>>>(
        jh, jh + 2 * (ext_n + 1), ext_n);
    return cudaGetLastError();
  }
  if (mode == kCluster) {
    if (cluster < 1) return cudaErrorInvalidValue;
    auto kernel = picard_iteration_ext_kernel<EMIT_V, SHARED, kCluster>;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    cudaError_t err = cluster_launch_config(
        kernel, (size_t)((ext_n + cluster - 1) / cluster) * sizeof(float), blocks, threads,
        cluster, s, &cfg, &attr);
    if (err != cudaSuccess) return err;
    err = cudaLaunchKernelEx(&cfg, kernel, field, ps, p0, v0, w, ph, v1, jh, n_clamped,
                             active, n, ext_n, qm_dt, qm_dt2_half, dt_dx, lo, hi,
                             win_stride, width, num_k, inv_stride);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
  }
  return with_mode(mode, [&](auto m) {
    constexpr int MODE = decltype(m)::value;
    const size_t smem = mode_floats(MODE, 2, ext_n) * sizeof(float);
    cudaError_t err = allow_smem(picard_iteration_ext_kernel<EMIT_V, SHARED, MODE>, smem);
    if (err != cudaSuccess) return err;
    picard_iteration_ext_kernel<EMIT_V, SHARED, MODE><<<blocks, threads, smem, s>>>(
        field, ps, p0, v0, w, ph, v1, jh, n_clamped, active, n, ext_n, qm_dt,
        qm_dt2_half, dt_dx, lo, hi, win_stride, width, num_k, inv_stride);
    return cudaGetLastError();
  });
}

template <bool DEPOSIT>
cudaError_t launch_finalize_ext(int mode, int blocks, int threads, cudaStream_t s,
                                const float* field, const float* ps,
                                const float* p0, const float* v0,
                                const float* w, float* p1, float* v1,
                                float* j1, double* partial, double* stats,
                                long long n, int ext_n, float qm_dt,
                                float qm_dt2_half, float dt_dx, float lo,
                                float hi, float lo_shift, int ng,
                                float inv_ng) {
  cudaError_t err = with_mode(mode, [&](auto m) {
    constexpr int MODE = decltype(m)::value;
    const size_t smem = mode_floats(MODE, DEPOSIT ? 2 : 1, ext_n) * sizeof(float);
    cudaError_t e = allow_smem(picard_finalize_ext_kernel<DEPOSIT, MODE>, smem);
    if (e != cudaSuccess) return e;
    picard_finalize_ext_kernel<DEPOSIT, MODE><<<blocks, threads, smem, s>>>(
        field, ps, p0, v0, w, p1, v1, j1, partial, n, ext_n, qm_dt, qm_dt2_half,
        dt_dx, lo, hi, lo_shift, ng, inv_ng);
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return err;
  ext_stats_sum_kernel<<<1, 256, 0, s>>>(partial, blocks, stats);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// jh: ext_n zeroed floats, in mode 3 3 ext_n + 2 (2 ext_n + 2 zeroed: the
// pair array, then the sum the fold writes); n_clamped: one zeroed int
// (shared only); v1: null unless the iterate's velocity is wanted;
// active: null or one int on the card (0: the launch does nothing, and in
// mode 3 the fold writes zeros); mode: ops/cuda_cic.py cluster_launch (0
// shared, 1 global, 2 cluster, 3 pair; cluster: the CTAs a cluster in
// mode 2, else unread).
int pypic_picard_iteration_ext(
    const float* field, const float* ps, const float* p0, const float* v0,
    const float* w, float* ph, float* v1, float* jh, int* n_clamped,
    const int* active, long long n, int ext_n, float qm_dt, float qm_dt2_half,
    float dt_dx, float lo, float hi, int shared, int win_stride, int width,
    int num_k, float inv_stride, int mode, int blocks, int threads, int cluster,
    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define PYPIC_ITER_EXT(EV, SH)                                                  \
  launch_iteration_ext<EV, SH>(mode, blocks, threads, cluster, s, field, ps, p0, v0, \
                               w, ph, v1, jh, n_clamped, active, n, ext_n, qm_dt, \
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

// The clusters the card holds at once of the slab pass's kCluster launch
// at ext_n nodes (shared: the shared window; emit_v: v1 stored), `cluster`
// CTAs of `threads` a cluster: 0 means it cannot launch one.
int pypic_picard_iteration_ext_clusters(int shared, int emit_v, int ext_n, int cluster,
                                        int threads, int* count) {
  if (cluster < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)((ext_n + cluster - 1) / cluster) * sizeof(float);
  cudaError_t err;
#define PYPIC_EXT_CLUSTERS(EV, SH)                                                   \
  err = max_clusters(picard_iteration_ext_kernel<EV, SH, kCluster>, smem, cluster, \
                     threads, count)
  if (shared) {
    if (emit_v) PYPIC_EXT_CLUSTERS(true, true); else PYPIC_EXT_CLUSTERS(false, true);
  } else {
    if (emit_v) PYPIC_EXT_CLUSTERS(true, false); else PYPIC_EXT_CLUSTERS(false, false);
  }
#undef PYPIC_EXT_CLUSTERS
  return (int)err;
}

// j1: ext_n zeroed floats (deposit only, else null); partial: 3 * blocks
// doubles of scratch; stats: 3 doubles, written whole; mode: 0 shared, 1
// global.
int pypic_picard_finalize_ext(
    const float* field, const float* ps, const float* p0, const float* v0,
    const float* w, float* p1, float* v1, float* j1, double* partial,
    double* stats, long long n, int ext_n, float qm_dt, float qm_dt2_half,
    float dt_dx, float lo, float hi, float lo_shift, int ng, float inv_ng,
    int mode, int blocks, int threads, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(j1 != nullptr
      ? launch_finalize_ext<true>(mode, blocks, threads, s, field, ps, p0, v0, w,
                                  p1, v1, j1, partial, stats, n, ext_n, qm_dt,
                                  qm_dt2_half, dt_dx, lo, hi, lo_shift, ng,
                                  inv_ng)
      : launch_finalize_ext<false>(mode, blocks, threads, s, field, ps, p0, v0,
                                   w, p1, v1, nullptr, partial, stats, n, ext_n,
                                   qm_dt, qm_dt2_half, dt_dx, lo, hi, lo_shift,
                                   ng, inv_ng));
}

// mode: 0 shared, 1 global.
int pypic_leapfrog_push(const float* field, const float* p, const float* v,
                        float* p1, float* v1, long long n, int ng, float qmh,
                        float dt_dx, float inv_ng, int mode, int blocks,
                        int threads, void* stream) {
  return (int)with_mode(mode, [&](auto m) {
    constexpr int MODE = decltype(m)::value;
    const size_t smem = mode_floats(MODE, 1, ng) * sizeof(float);
    cudaError_t err = allow_smem(leapfrog_push_kernel<MODE>, smem);
    if (err != cudaSuccess) return err;
    leapfrog_push_kernel<MODE><<<blocks, threads, smem, (cudaStream_t)stream>>>(
        field, p, v, p1, v1, n, ng, qmh, dt_dx, inv_ng);
    return cudaGetLastError();
  });
}

// rho_ext: ext_n zeroed floats; n_clamped: one zeroed int; mode: 0 shared
// (ng + ext_n floats), 1 global.
int pypic_explicit_domain_cycle(const float* field, const float* p,
                                const float* v, const float* w, float* p1,
                                float* v1, float* rho_ext, int* n_clamped,
                                long long n, int ng, int ext_n, float qmh,
                                float dt_dx, float lo_shifted, float inv_ng,
                                int mode, int blocks, int threads, void* stream) {
  return (int)with_mode(mode, [&](auto m) {
    constexpr int MODE = decltype(m)::value;
    const size_t smem = (MODE == kShared ? (size_t)(ng + ext_n) : 0) * sizeof(float);
    cudaError_t err = allow_smem(domain_cycle_kernel<MODE>, smem);
    if (err != cudaSuccess) return err;
    domain_cycle_kernel<MODE><<<blocks, threads, smem, (cudaStream_t)stream>>>(
        field, p, v, w, p1, v1, rho_ext, n_clamped, n, ng, ext_n, qmh, dt_dx,
        lo_shifted, inv_ng);
    return cudaGetLastError();
  });
}

}  // extern "C"
