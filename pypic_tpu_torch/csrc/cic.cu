// CIC particle kernels of the implicit CN-Picard path, for Hopper (sm_90a).
//
// Five kernels from three templates, each the counterpart of a Pallas TPU
// kernel in pypic_tpu/ops/pallas_cic.py. They compute what the TPU kernels compute
// with plain CIC index arithmetic (cic_common.cuh, after
// pypic_tpu/ops/cic.py cic_indices_weights): idx_l = clip(floor(p), 0,
// num_cells - 1), w_r = p - idx_l, w_l = 1 - w_r, and the right node wraps
// to 0 on a periodic grid. The TPU kernels' tent windows, one-hot selectors and
// MXU contractions exist only for Mosaic and VMEM and are not carried
// over.
//
// Common design (the two deposits differ: their sections below):
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
//   round-off level (the JAX deposits are bit-deterministic);
//   deposit_det_kernel sums in a fixed order instead.
// * A launcher returns cudaGetLastError(); it allocates nothing and runs
//   on the stream it is given.

#include "cic_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// picard_iteration, picard_iteration_shared
//
// Replace pypic_tpu/ops/pallas_cic.py:_picard_iter_kernel and
// _picard_iter_sw_kernel (picard_iteration_pallas with share_window False
// and True). One Picard pass: gather the smoothed field at the position
// guess ps, CN push, wrapped midpoint ph = (p0 + p1)/2, store ph (and v1
// with EMIT_V), deposit w vh into jh. The two differ only in where the
// deposit lands.
//
// Without SHARED the deposit sits at the wrapped ph. With SHARED it sits
// at the midpoint as seen from the gather's window frame, and a deposit
// that leaves the frame is clamped to its edge and counted. The TPU kernel
// reuses the gather's window one-hot for the deposit; that frame decides
// which deposits clamp, so the port keeps the frame's arithmetic (not its
// selectors): windows start every `win_stride` nodes,
// k = clip(int(floor(ps) * (1/win_stride)), 0, K - 1), row l of window k
// is node win_stride k + l - 1 (mod ng), and the deposit sits at row
// d_h = (ps - k win_stride + 1) + delta, delta the nearest-image ph - ps.
// A d_h outside [0, width - 1] is clamped to that edge and counted. Every
// step rounds as the JAX kernel's float32 operations do, so the clamps are
// the same particles'. When nothing clamps, the deposit equals one at the
// wrapped ph.
//
// Bound on the H100: device-memory bytes. It reads 12 B and writes 4 B per
// particle (8 B with EMIT_V): about 1.6 GB a pass at n = 1e8. The field and
// the partial histogram stay in shared memory; the per-particle deposit is
// two shared-memory float atomics, whose bank conflicts grow as particles of
// one warp share a node (the load is in random order at ng = 200). The
// clamp count is kept per block in shared memory and added to the int32
// total with one atomic per block, so it is exact.
// ---------------------------------------------------------------------------
template <bool EMIT_V, bool SHARED>
__global__ void picard_iteration_kernel(
    const float* __restrict__ field, const float* __restrict__ ps,
    const float* __restrict__ p0, const float* __restrict__ v0,
    float* __restrict__ ph_out, float* __restrict__ v1_out,
    float* __restrict__ jh, int* __restrict__ n_clamped, long long n, int ng,
    float qm_dt, float qm_dt2_half, float dt_dx, float w, float inv_ng,
    int win_stride, int width, int num_k, float inv_stride) {
  extern __shared__ float smem[];
  float* s_field = smem;
  float* s_hist = smem + ng;
  __shared__ int s_clamped;
  for (int i = threadIdx.x; i < ng; i += blockDim.x) {
    s_field[i] = field[i];
    s_hist[i] = 0.0f;
  }
  if (SHARED && threadIdx.x == 0) s_clamped = 0;
  __syncthreads();
  const float ngf = (float)ng;
  const float top = (float)(width - 1);
  int clamped = 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float s = ps[i];
    const float a = p0[i];
    const float b = v0[i];
    const float e = gather(s_field, cic_periodic(s, ng));
    float p1, v1;
    cn_push(a, b, e, qm_dt, qm_dt2_half, dt_dx, p1, v1);
    const float raw = __fmul_rn(0.5f, __fadd_rn(a, p1));
    const float vh = __fmul_rn(0.5f, __fadd_rn(b, v1));
    const float h = wrap(raw, ngf, inv_ng);
    ph_out[i] = h;
    if (EMIT_V) v1_out[i] = v1;
    const float val = __fmul_rn(w, vh);
    Cic c;
    if (SHARED) {
      // the gather's window and the midpoint's row in it
      const int k = min(max((int)__fmul_rn(floorf(s), inv_stride), 0), num_k - 1);
      const float d_s = __fadd_rn(__fsub_rn(s, (float)(k * win_stride)), 1.0f);
      float delta = __fsub_rn(raw, s);
      delta = __fsub_rn(delta, __fmul_rn(rintf(__fmul_rn(delta, inv_ng)), ngf));
      float d_h = __fadd_rn(d_s, delta);
      if (d_h < 0.0f || d_h > top) {
        ++clamped;
        d_h = fminf(fmaxf(d_h, 0.0f), top);
      }
      const int row = min((int)floorf(d_h), width - 2);
      c.wr = __fsub_rn(d_h, (float)row);
      c.wl = __fsub_rn(1.0f, c.wr);
      c.l = (win_stride * k + row - 1) % ng;
      if (c.l < 0) c.l += ng;
      c.r = c.l + 1 == ng ? 0 : c.l + 1;
    } else {
      c = cic_periodic(h, ng);
    }
    atomicAdd(&s_hist[c.l], __fmul_rn(val, c.wl));
    atomicAdd(&s_hist[c.r], __fmul_rn(val, c.wr));
  }
  if (SHARED && clamped) atomicAdd(&s_clamped, clamped);
  __syncthreads();
  for (int i = threadIdx.x; i < ng; i += blockDim.x) atomicAdd(&jh[i], s_hist[i]);
  if (SHARED && threadIdx.x == 0 && s_clamped) atomicAdd(n_clamped, s_clamped);
}

// ---------------------------------------------------------------------------
// picard_finalize_nodep, picard_finalize
//
// Replace pypic_tpu/ops/pallas_cic.py:_picard_final_nodep_kernel
// (picard_finalize_nodep_pallas) and _picard_final_kernel
// (picard_finalize_pallas, finalize='converged-deposit'). The same gather
// and CN push from the converged field, then wrap p1 and store (p1, v1).
// With DEPOSIT the sweep also deposits the full-step current w v1 at the
// wrapped p1 into j1 through a shared-memory histogram, as deposit_kernel.
// One body for both, so p1 and v1 are bit-identical between them.
//
// Bound on the H100: device-memory bytes, 12 B in and 8 B out per
// particle, a pure stream. The field (and the histogram) sit in shared
// memory, so the gather costs no device-memory traffic.
// ---------------------------------------------------------------------------
template <bool DEPOSIT>
__global__ void picard_finalize_kernel(
    const float* __restrict__ field, const float* __restrict__ ps,
    const float* __restrict__ p0, const float* __restrict__ v0,
    float* __restrict__ p1_out, float* __restrict__ v1_out,
    float* __restrict__ j1, long long n, int ng, float qm_dt,
    float qm_dt2_half, float dt_dx, float w, float inv_ng) {
  extern __shared__ float smem[];
  float* s_field = smem;
  float* s_hist = smem + ng;
  for (int i = threadIdx.x; i < ng; i += blockDim.x) {
    s_field[i] = field[i];
    if (DEPOSIT) s_hist[i] = 0.0f;
  }
  __syncthreads();
  const float ngf = (float)ng;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float e = gather(s_field, cic_periodic(ps[i], ng));
    float p1, v1;
    cn_push(p0[i], v0[i], e, qm_dt, qm_dt2_half, dt_dx, p1, v1);
    p1 = wrap(p1, ngf, inv_ng);
    p1_out[i] = p1;
    v1_out[i] = v1;
    if (DEPOSIT) {
      const float val = __fmul_rn(w, v1);
      const Cic c = cic_periodic(p1, ng);
      atomicAdd(&s_hist[c.l], __fmul_rn(val, c.wl));
      atomicAdd(&s_hist[c.r], __fmul_rn(val, c.wr));
    }
  }
  if (DEPOSIT) {
    __syncthreads();
    for (int i = threadIdx.x; i < ng; i += blockDim.x) atomicAdd(&j1[i], s_hist[i]);
  }
}

// Launches picard_iteration_kernel<EMIT_V, SHARED> after the shared-memory
// opt-in.
template <bool EMIT_V, bool SHARED>
cudaError_t launch_iteration(int blocks, int threads, cudaStream_t s,
                             const float* field, const float* ps,
                             const float* p0, const float* v0, float* ph,
                             float* v1, float* jh, int* n_clamped, long long n,
                             int ng, float qm_dt, float qm_dt2_half,
                             float dt_dx, float w, float inv_ng, int win_stride,
                             int width, int num_k, float inv_stride) {
  const size_t smem = 2 * (size_t)ng * sizeof(float);
  cudaError_t err = allow_smem(picard_iteration_kernel<EMIT_V, SHARED>, smem);
  if (err != cudaSuccess) return err;
  picard_iteration_kernel<EMIT_V, SHARED><<<blocks, threads, smem, s>>>(
      field, ps, p0, v0, ph, v1, jh, n_clamped, n, ng, qm_dt, qm_dt2_half,
      dt_dx, w, inv_ng, win_stride, width, num_k, inv_stride);
  return cudaGetLastError();
}

template <bool DEPOSIT>
cudaError_t launch_finalize(int blocks, int threads, cudaStream_t s,
                            const float* field, const float* ps,
                            const float* p0, const float* v0, float* p1,
                            float* v1, float* j1, long long n, int ng,
                            float qm_dt, float qm_dt2_half, float dt_dx,
                            float w, float inv_ng) {
  const size_t smem = (DEPOSIT ? 2 : 1) * (size_t)ng * sizeof(float);
  cudaError_t err = allow_smem(picard_finalize_kernel<DEPOSIT>, smem);
  if (err != cudaSuccess) return err;
  picard_finalize_kernel<DEPOSIT><<<blocks, threads, smem, s>>>(
      field, ps, p0, v0, p1, v1, j1, n, ng, qm_dt, qm_dt2_half, dt_dx, w, inv_ng);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// deposit
//
// Replaces pypic_tpu/ops/pallas_cic.py:_deposit_kernel (deposit_pallas).
// CIC deposit of per-particle values at grid positions, periodic or
// bounded, onto ng zeroed nodes. Its paths: the implicit and explicit
// engines' set-up deposits (n = 1e8, ng = 200, periodic), the explicit
// domain carrier's rho a step (n = 1e8 onto the slab's ext_n = 227 nodes,
// bounded, a twentieth of the rows dead slots of weight 0), and the
// magnetized engines' IEAD histogram a step (ops/cic.py histogram_add: a
// width-0 deposit of n = 999,996 rows at integer positions onto S ne na
// = 3,200 bins, weight 1 on the rows that hit a wall that step and 0 on
// all the others).
//
// Bound on the H100: device-memory bytes, 8 B read a row, and the
// shared-memory adds behind them. The first port launched 8 blocks of 256
// threads an SM, a row a thread, one (ng,) histogram a block and a global
// float atomic a node and block in the flush: 1,056 x 3,200 = 3.4 M
// atomics at the IEAD, where every row also issued its two shared adds,
// one always of 0 (the card runs a shared float atomicAdd as a
// compare-and-swap loop). Now:
//
// * deposit2's grid (cic_common.cuh; ops/cuda_cic.py deposit_launch_shape
//   with one histogram): wide from 4 x 1,024 x SMs rows, one 1,024-thread
//   block an SM sweeping a contiguous range with 16-B loads, lane columns
//   (32, halved until shared memory holds them: 16 at 3,200 bins) and 132
//   blocks' flush; the first port's grid below;
// * no add whose product is exactly 0, in the sweep and in the flush
//   (flush_columns' SKIP): the histogram and the outputs start at +0 and
//   x + 0 is x for every x, so the sums are unchanged; a NaN or Inf
//   product is not 0 and still lands. The IEAD's rows that hit no wall,
//   every right-node add of a width-0 deposit and the carrier's dead slots
//   then cost their loads alone.
//
// The split (tools/resident_split.py --kernel deposit; PERF.md §6;
// us a launch, queued): the carrier 303 against the first port's 488, its
// sweep alone 263 (8 B a row at 3.0 TB/s); the skip's test costs 3% on
// dense rows (290 adding every product) and saves 2.4 at the IEAD; there
// one column (histogram_add's, the wrapper's `cols`) reads 5.2 against 7.5
// at 16, and dense rows want all 32 (1 column: 681 at the carrier).
// ---------------------------------------------------------------------------

// h[at] += v, unless v is exactly 0
__device__ __forceinline__ void add_nonzero(float* h, int at, float v) {
  if (v != 0.0f) atomicAdd(h + at, v);
}

template <bool PERIODIC, int ROWS, bool VEC>
__global__ void __launch_bounds__(1024, 1)
    deposit_kernel(const float* __restrict__ p, const float* __restrict__ values,
                   float* __restrict__ out, long long n, int ng, int cols) {
  extern __shared__ float4 smem4[];
  float* h = reinterpret_cast<float*>(smem4);
  zero_shared(h, ng * cols);
  __syncthreads();
  if (ROWS == 1) {  // narrow: a row a thread, grid-stride, one column
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += stride) {
      const float val = values[i];
      const Cic c = PERIODIC ? cic_periodic(p[i], ng) : cic_bounded(p[i], ng);
      add_nonzero(h, c.l, __fmul_rn(val, c.wl));
      add_nonzero(h, c.r, __fmul_rn(val, c.wr));
    }
  } else {  // wide: groups of four rows, lane columns
    const int col = threadIdx.x & (cols - 1);
    long long lo, hi;
    block_groups(n, lo, hi);
    const long long end = min(n, 4 * hi);
    for (long long g = lo + threadIdx.x; g < hi; g += blockDim.x) {
      const long long i = 4 * g;
      const float4 p4 = load4<VEC>(p, i, end, 0.0f);
      const float4 v4 = load4<VEC>(values, i, end, 0.0f);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (i + r >= end) break;
        const Cic c = PERIODIC ? cic_periodic(get(p4, r), ng) : cic_bounded(get(p4, r), ng);
        const float val = get(v4, r);
        add_nonzero(h, c.l * cols + col, __fmul_rn(val, c.wl));
        add_nonzero(h, c.r * cols + col, __fmul_rn(val, c.wr));
      }
    }
  }
  flush_columns<ROWS, 1, true>(h, ng, cols, out, nullptr);
}

// ---------------------------------------------------------------------------
// deposit_det
//
// The deterministic deposit: the same CIC deposit with the sums in a fixed
// order (no float atomics), for callers whose loop exits on a residual
// that the float atomics' order would blur (the sheath engine's composed
// Picard loop, two a pass, and its exit histograms). Bound as
// deposit_kernel.
//
// The first port ran a wave of 256-thread blocks and cic_common.cuh's
// first deterministic flush: a shared-memory tree of log2 T barrier rounds,
// each thread adding ng nodes serially a round, then the last block's sum
// of node-major partials one L2 trip at a time (3.2x the atomic deposit at
// n = 1e6, ng = 51). Now the sheath pass's grid and flush (sheath.cu;
// ops/cuda_sheath.py launch_shape without the field): persistent blocks,
// two an SM where their columns fit, each owning a contiguous range of
// rows in order, four rows a thread with 16-B loads (row by row where a
// pointer is not 16-B aligned), a column a thread, and det_flush's
// warp-ordered column sums and batched partial loads. The order of every
// sum follows from (n, ng, SM count). The split (--kernel deposit_det): 10.5
// us against 40.2 at 1e6 / 51, its flush 5.7 of it; at the exit
// histograms' 128 nodes (128 threads a block) 35.7 against 41.9, the flush
// 29.2 (PERF.md §7). The columns fit a block up to ng = 1,816; above it
// deposit_det_large_kernel takes the sums as int64 fixed point in device
// memory (the design and its pricing: sheath.cu's header). Bound there:
// the 8 B a row read twice (the scale sweep and the deposit sweep).
// ---------------------------------------------------------------------------
template <bool PERIODIC, bool VEC>
__global__ void __launch_bounds__(1024) deposit_det_kernel(
    const float* __restrict__ p, const float* __restrict__ values,
    float* __restrict__ out, float* __restrict__ partial,
    unsigned int* __restrict__ counter, long long n, long long rows_per_block,
    int ng) {
  extern __shared__ float4 smem4[];
  float* s_hist = reinterpret_cast<float*>(smem4);  // column t: s_hist[node * T + t]
  const int T = blockDim.x;
  zero_shared(s_hist, T * ng);
  __syncthreads();
  float* mine = s_hist + threadIdx.x;
  const long long lo = (long long)blockIdx.x * rows_per_block;
  const long long hi = min(n, lo + rows_per_block);
  for (long long i = lo + 4LL * threadIdx.x; i < hi; i += 4LL * T) {
    const float4 p4 = load4<VEC>(p, i, hi, 0.0f);
    const float4 v4 = load4<VEC>(values, i, hi, 0.0f);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if (i + r >= hi) break;
      const Cic c = PERIODIC ? cic_periodic(get(p4, r), ng) : cic_bounded(get(p4, r), ng);
      const float val = get(v4, r);
      mine[c.l * T] = __fadd_rn(mine[c.l * T], __fmul_rn(val, c.wl));
      mine[c.r * T] = __fadd_rn(mine[c.r * T], __fmul_rn(val, c.wr));
    }
  }
  det_flush(s_hist, ng, partial, counter, out);
}

// The large mode (ng above the columns' ceiling, 1,816; launch_shape's
// `large` without the field): the same rows a block, the sums as int64
// fixed point in device memory (cic_common.cuh "Large deterministic
// sums"). SCALE: the first sweep, the largest |term| into bmax[block] and
// acc zeroed; else every term added.
template <bool PERIODIC, bool VEC, bool SCALE>
__global__ void __launch_bounds__(kLargeThreads, 2) deposit_det_large_kernel(
    const float* __restrict__ p, const float* __restrict__ values,
    float* __restrict__ bmax, unsigned long long* __restrict__ acc, long long n,
    long long rows_per_block, int ng) {
  double scale = 0.0;
  if (SCALE)
    fixed_zero(acc, ng);
  else
    scale = fixed_scale(bmax, gridDim.x, n);
  const int T = blockDim.x;
  const long long lo = (long long)blockIdx.x * rows_per_block;
  const long long hi = min(n, lo + rows_per_block);
  float m = 0.0f;
  for (long long i = lo + 4LL * threadIdx.x; i < hi; i += 4LL * T) {
    const float4 p4 = load4<VEC>(p, i, hi, 0.0f);
    const float4 v4 = load4<VEC>(values, i, hi, 0.0f);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if (i + r >= hi) break;
      const Cic c = PERIODIC ? cic_periodic(get(p4, r), ng) : cic_bounded(get(p4, r), ng);
      const float val = get(v4, r);
      const float tl = __fmul_rn(val, c.wl), tr = __fmul_rn(val, c.wr);
      if (SCALE) {
        fixed_track(m, tl);
        fixed_track(m, tr);
      } else {
        fixed_add(acc, c.l, tl, scale);
        fixed_add(acc, c.r, tr, scale);
      }
    }
  }
  if (SCALE) fixed_scale_out(m, bmax);
}

}  // namespace

extern "C" {

int pypic_picard_iteration(const float* field, const float* ps, const float* p0,
                           const float* v0, float* ph, float* v1, float* jh,
                           long long n, int ng, float qm_dt, float qm_dt2_half,
                           float dt_dx, float w, float inv_ng, int blocks,
                           int threads, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(v1 != nullptr
      ? launch_iteration<true, false>(blocks, threads, s, field, ps, p0, v0, ph,
                                      v1, jh, nullptr, n, ng, qm_dt, qm_dt2_half,
                                      dt_dx, w, inv_ng, 0, 0, 0, 0.0f)
      : launch_iteration<false, false>(blocks, threads, s, field, ps, p0, v0, ph,
                                       nullptr, jh, nullptr, n, ng, qm_dt,
                                       qm_dt2_half, dt_dx, w, inv_ng, 0, 0, 0,
                                       0.0f));
}

int pypic_picard_finalize_nodep(const float* field, const float* ps,
                                const float* p0, const float* v0, float* p1,
                                float* v1, long long n, int ng, float qm_dt,
                                float qm_dt2_half, float dt_dx, float inv_ng,
                                int blocks, int threads, void* stream) {
  return (int)launch_finalize<false>(blocks, threads, (cudaStream_t)stream,
                                     field, ps, p0, v0, p1, v1, nullptr, n, ng,
                                     qm_dt, qm_dt2_half, dt_dx, 0.0f, inv_ng);
}

int pypic_picard_finalize(const float* field, const float* ps, const float* p0,
                          const float* v0, float* p1, float* v1, float* j1,
                          long long n, int ng, float qm_dt, float qm_dt2_half,
                          float dt_dx, float w, float inv_ng, int blocks,
                          int threads, void* stream) {
  return (int)launch_finalize<true>(blocks, threads, (cudaStream_t)stream,
                                    field, ps, p0, v0, p1, v1, j1, n, ng, qm_dt,
                                    qm_dt2_half, dt_dx, w, inv_ng);
}

// jh: ng zeroed floats; n_clamped: one zeroed int.
int pypic_picard_iteration_shared(
    const float* field, const float* ps, const float* p0, const float* v0,
    float* ph, float* v1, float* jh, int* n_clamped, long long n, int ng,
    float qm_dt, float qm_dt2_half, float dt_dx, float w, float inv_ng,
    int win_stride, int width, int num_k, float inv_stride, int blocks,
    int threads, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(v1 != nullptr
      ? launch_iteration<true, true>(blocks, threads, s, field, ps, p0, v0, ph,
                                     v1, jh, n_clamped, n, ng, qm_dt, qm_dt2_half,
                                     dt_dx, w, inv_ng, win_stride, width, num_k,
                                     inv_stride)
      : launch_iteration<false, true>(blocks, threads, s, field, ps, p0, v0, ph,
                                      nullptr, jh, n_clamped, n, ng, qm_dt,
                                      qm_dt2_half, dt_dx, w, inv_ng, win_stride,
                                      width, num_k, inv_stride));
}

// out: ng zeroed floats; rows, blocks, threads and cols from
// ops/cuda_cic.py deposit_launch_shape (one histogram).
int pypic_deposit(const float* p, const float* values, float* out, long long n,
                  int ng, int periodic, int rows, int blocks, int threads,
                  int cols, void* stream) {
  if (!deposit_shape_ok(n, ng, rows, blocks, threads, cols))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)ng * cols * sizeof(float);
  const bool vec = aligned16(p) && aligned16(values);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
#define PYPIC_DEPOSIT(PER, ROWS, VEC)                                           \
  err = allow_smem(deposit_kernel<PER, ROWS, VEC>, smem);                       \
  if (err != cudaSuccess) return (int)err;                                      \
  deposit_kernel<PER, ROWS, VEC><<<blocks, threads, smem, s>>>(p, values, out,  \
                                                              n, ng, cols);     \
  return (int)cudaGetLastError()
  if (periodic) {
    if (rows == 1) { PYPIC_DEPOSIT(true, 1, false); }
    if (vec) { PYPIC_DEPOSIT(true, 4, true); }
    PYPIC_DEPOSIT(true, 4, false);
  }
  if (rows == 1) { PYPIC_DEPOSIT(false, 1, false); }
  if (vec) { PYPIC_DEPOSIT(false, 4, true); }
  PYPIC_DEPOSIT(false, 4, false);
#undef PYPIC_DEPOSIT
}

// out: ng floats (written whole); partial: blocks * ng floats of scratch;
// counter: one unsigned int, 0 at the launch and left 0 (det_flush);
// blocks, threads (a multiple of 32, <= 1024) and rows_per_block (a
// multiple of 4, blocks * rows_per_block >= n) from ops/cuda_sheath.py
// launch_shape(n, ng, sms, field=False).
int pypic_deposit_det(const float* p, const float* values, float* out,
                      float* partial, unsigned int* counter, long long n,
                      int ng, int periodic, int blocks, int threads,
                      long long rows_per_block, void* stream) {
  if (threads < 32 || threads > 1024 || threads % 32 != 0 || rows_per_block % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)threads * ng * sizeof(float);
  const bool vec = aligned16(p) && aligned16(values);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
#define PYPIC_DEPOSIT_DET(PER, VEC)                                             \
  err = allow_smem(deposit_det_kernel<PER, VEC>, smem);                         \
  if (err != cudaSuccess) return (int)err;                                      \
  deposit_det_kernel<PER, VEC><<<blocks, threads, smem, s>>>(                   \
      p, values, out, partial, counter, n, rows_per_block, ng);                 \
  return (int)cudaGetLastError()
  if (periodic) {
    if (vec) { PYPIC_DEPOSIT_DET(true, true); }
    PYPIC_DEPOSIT_DET(true, false);
  }
  if (vec) { PYPIC_DEPOSIT_DET(false, true); }
  PYPIC_DEPOSIT_DET(false, false);
#undef PYPIC_DEPOSIT_DET
}

// The large mode (ops/cuda_sheath.py launch_shape(n, ng, sms,
// field=False) with `large`): out as above; bmax: blocks floats and acc:
// ng int64 of scratch, both written before they are read; threads a
// multiple of 32, <= 512. Three launches: the scale sweep, the deposit
// sweep, the conversion into out.
int pypic_deposit_det_large(const float* p, const float* values, float* out,
                            float* bmax, unsigned long long* acc, long long n,
                            int ng, int periodic, int blocks, int threads,
                            long long rows_per_block, void* stream) {
  if (!large_shape_ok(ng, blocks, threads, rows_per_block))
    return (int)cudaErrorInvalidValue;
  const bool vec = aligned16(p) && aligned16(values);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
#define PYPIC_DEPOSIT_DET_LARGE(PER, VEC)                                       \
  deposit_det_large_kernel<PER, VEC, true><<<blocks, threads, 0, s>>>(          \
      p, values, bmax, acc, n, rows_per_block, ng);                             \
  err = cudaGetLastError();                                                     \
  if (err != cudaSuccess) return (int)err;                                      \
  deposit_det_large_kernel<PER, VEC, false><<<blocks, threads, 0, s>>>(         \
      p, values, bmax, acc, n, rows_per_block, ng);                             \
  err = cudaGetLastError()
  if (periodic) {
    if (vec) { PYPIC_DEPOSIT_DET_LARGE(true, true); } else { PYPIC_DEPOSIT_DET_LARGE(true, false); }
  } else {
    if (vec) { PYPIC_DEPOSIT_DET_LARGE(false, true); } else { PYPIC_DEPOSIT_DET_LARGE(false, false); }
  }
#undef PYPIC_DEPOSIT_DET_LARGE
  if (err != cudaSuccess) return (int)err;
  return (int)launch_fixed_out(acc, bmax, blocks, n, ng, out, s);
}

const char* pypic_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
