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
// * A float64 state (rows 1-5 here, the gather in explicit.cu): each
//   template takes the element type T last, and the `_f64` entry points
//   launch its double instantiations (every scalar passed as a double).
//   The float instantiations compile to the code they compiled to before
//   T (tools/sass_diff.py: the SASS of all 46 float kernels of cic.cu and
//   explicit.cu identical). In double the field, the particles and every
//   accumulator are double, each operation rounded once (mul_rn, add_rn,
//   sub_rn), so a double pass equals its float64 plain version but for
//   the order of its sums; the shared window's clamp count stays an exact
//   int. The shared arrays take 8 B a node, so the shared mode ends at
//   half the float ceilings (ops/cuda_cic.py sweep_launch and
//   deposit_launch_shape with item 8). A global double add compiles to
//   REDG.E.ADD.F64.RN; a shared-memory one to a compare-and-swap loop
//   (ATOMS.CAST.SPIN.64), as the float ones do (ATOMS.CAST.SPIN). Bound
//   on the H100: twice the float kernels' bytes a row (1e8 rows at ng
//   200: row 1 0.955 ms, row 3 1.194, row 4 0.478); the operations at
//   the card's float64 rate (33.5 TFLOP/s) stay below it.

#include <cooperative_groups.h>

#include "cic_common.cuh"

namespace cg = cooperative_groups;

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
//
// Above the two arrays' ceiling (ng above 29,056; 29,054 with SHARED,
// whose clamp count takes 16 static bytes; ops/cuda_cic.py smem_mode)
// MODE is cic_common.cuh's kGlobal: the field read from device memory,
// each of a row's two adds a global float atomic into the zeroed jh.
// Bound there: the rows' 16 B (20 with EMIT_V), plus the field read and
// jh written once: 8 B a node.
//
// MODE kCluster (ops/cuda_cic.py cluster_launch picks it where it beat
// kGlobal on the card): the field as in kGlobal; the (ng,) sum lives on
// chip, cut across the CTAs of a thread-block cluster of C (a power of
// two up to 16, non-portable above 8) CTAs of 1,024 threads, one CTA an
// SM, one wave of clusters (cudaOccupancyMaxActiveClusters). CTA r owns
// nodes [r S, min((r + 1) S, ng)), S = ceil(ng / C), as its dynamic
// shared memory (S elements). The sweep is kGlobal's, so ph, v1 and the
// clamps are its bits; each of a row's two products is an atomicAdd at
// cluster.map_shared_rank(slice, node / S)[node % S] (the right node's
// owner and offset follow from the left's: the next offset, the next
// slice past S - 1, node 0 past ng - 1). Then cluster.sync(), after which
// every add into a slice has landed and no CTA touches another's shared
// memory again, and each CTA adds its slice to jh, one global atomic a
// node: (blocks / C) ng adds a pass in the place of kGlobal's 2 n.
//
// MODE kPair (float alone; cluster_launch picks it where it beat the
// others): kGlobal's sweep, each row's two products (w vh wl, w vh wr)
// one red.global.add.v2.f32 at row c.l of a zeroed, 8-B aligned (ng, 2)
// pair array in device memory (n vector reductions in the place of 2 n
// scalar ones), then pair_fold_kernel: jh[i] = pair[i][0] + pair[i -
// 1][1], i - 1 taken mod ng (a row's right node is its left one's next,
// node 0 past ng - 1). Bound: kGlobal's, the pair array's 8 B a node
// written and read once beside.
//
// cluster_add, pair_add and pair_fold_kernel are cic_common.cuh's, shared
// with rows 14 and 17 (explicit.cu, domain.cu).
// ---------------------------------------------------------------------------
template <bool EMIT_V, bool SHARED, int MODE, typename T>
__global__ void picard_iteration_kernel(
    const T* __restrict__ field, const T* __restrict__ ps, const T* __restrict__ p0,
    const T* __restrict__ v0, T* __restrict__ ph_out, T* __restrict__ v1_out,
    T* __restrict__ jh, int* __restrict__ n_clamped, long long n, int ng, T qm_dt,
    T qm_dt2_half, T dt_dx, T w, T inv_ng, int win_stride, int width, int num_k,
    T inv_stride) {
  T* s_field = dynamic_smem<T>();
  T* s_hist = s_field + ng;
  __shared__ int s_clamped;
  if (MODE == kShared) {
    for (int i = threadIdx.x; i < ng; i += blockDim.x) {
      s_field[i] = field[i];
      s_hist[i] = (T)0;
    }
  }
  T* hist = MODE == kShared ? s_hist : jh;
  if (SHARED && threadIdx.x == 0) s_clamped = 0;
  [[maybe_unused]] int slice = 0;  // kCluster: the nodes a CTA owns (at s_field)
  if constexpr (MODE == kCluster) {
    cg::cluster_group cluster = cg::this_cluster();
    const int ctas = (int)cluster.num_blocks();
    slice = (ng + ctas - 1) / ctas;
    for (int i = threadIdx.x; i < slice; i += blockDim.x) s_field[i] = (T)0;
    cluster.sync();  // every slice zeroed and live before any remote add
  } else {
    __syncthreads();
  }
  const T ngf = (T)ng;
  const T top = (T)(width - 1);
  const T half = (T)0.5;
  int clamped = 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const T s = ps[i];
    const T a = p0[i];
    const T b = v0[i];
    const T e = gather_mode<MODE>(s_field, field, cic_periodic(s, ng));
    T p1, v1;
    cn_push(a, b, e, qm_dt, qm_dt2_half, dt_dx, p1, v1);
    const T raw = mul_rn(half, add_rn(a, p1));
    const T vh = mul_rn(half, add_rn(b, v1));
    const T h = wrap(raw, ngf, inv_ng);
    ph_out[i] = h;
    if (EMIT_V) v1_out[i] = v1;
    const T val = mul_rn(w, vh);
    CicT<T> c;
    if (SHARED) {
      // the gather's window and the midpoint's row in it
      const int k = min(max((int)mul_rn(floor_of(s), inv_stride), 0), num_k - 1);
      const T d_s = add_rn(sub_rn(s, (T)(k * win_stride)), (T)1);
      T delta = sub_rn(raw, s);
      delta = sub_rn(delta, mul_rn(rint_of(mul_rn(delta, inv_ng)), ngf));
      T d_h = add_rn(d_s, delta);
      if (d_h < (T)0 || d_h > top) {
        ++clamped;
        d_h = clamp_to(d_h, (T)0, top);
      }
      const int row = min((int)floor_of(d_h), width - 2);
      c.wr = sub_rn(d_h, (T)row);
      c.wl = sub_rn((T)1, c.wr);
      c.l = (win_stride * k + row - 1) % ng;
      if (c.l < 0) c.l += ng;
      c.r = c.l + 1 == ng ? 0 : c.l + 1;
    } else {
      c = cic_periodic(h, ng);
    }
    if constexpr (MODE == kCluster) {
      cluster_add(s_field, slice, c, mul_rn(val, c.wl), mul_rn(val, c.wr));
    } else if constexpr (MODE == kPair) {
      pair_add(jh, c.l, mul_rn(val, c.wl), mul_rn(val, c.wr));
    } else {
      atomicAdd(&hist[c.l], mul_rn(val, c.wl));
      atomicAdd(&hist[c.r], mul_rn(val, c.wr));
    }
  }
  if (SHARED && clamped) atomicAdd(&s_clamped, clamped);
  if constexpr (MODE == kCluster) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // every add into this slice has landed
    const int lo = (int)cluster.block_rank() * slice;
    const int count = min(slice, ng - lo);
    for (int i = threadIdx.x; i < count; i += blockDim.x) atomicAdd(&jh[lo + i], s_field[i]);
  } else {
    __syncthreads();
  }
  if (MODE == kShared)
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
//
// Above the shared-memory ceiling (58,112 nodes without the deposit,
// 29,056 with it) MODE is cic_common.cuh's kGlobal: the field read from
// device memory and, with DEPOSIT, each add a global float atomic into
// the zeroed j1. Bound there: the rows' 20 B, plus the field read and j1
// written once (DEPOSIT): up to 8 B a node.
// ---------------------------------------------------------------------------
template <bool DEPOSIT, int MODE, typename T>
__global__ void picard_finalize_kernel(
    const T* __restrict__ field, const T* __restrict__ ps, const T* __restrict__ p0,
    const T* __restrict__ v0, T* __restrict__ p1_out, T* __restrict__ v1_out,
    T* __restrict__ j1, long long n, int ng, T qm_dt, T qm_dt2_half, T dt_dx, T w,
    T inv_ng) {
  T* s_field = dynamic_smem<T>();
  T* s_hist = s_field + ng;
  if (MODE == kShared) {
    for (int i = threadIdx.x; i < ng; i += blockDim.x) {
      s_field[i] = field[i];
      if (DEPOSIT) s_hist[i] = (T)0;
    }
  }
  T* hist = MODE == kShared ? s_hist : j1;
  __syncthreads();
  const T ngf = (T)ng;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const T e = gather_mode<MODE>(s_field, field, cic_periodic(ps[i], ng));
    T p1, v1;
    cn_push(p0[i], v0[i], e, qm_dt, qm_dt2_half, dt_dx, p1, v1);
    p1 = wrap(p1, ngf, inv_ng);
    p1_out[i] = p1;
    v1_out[i] = v1;
    if (DEPOSIT) {
      const T val = mul_rn(w, v1);
      const CicT<T> c = cic_periodic(p1, ng);
      atomicAdd(&hist[c.l], mul_rn(val, c.wl));
      atomicAdd(&hist[c.r], mul_rn(val, c.wr));
    }
  }
  if (DEPOSIT && MODE == kShared) {
    __syncthreads();
    for (int i = threadIdx.x; i < ng; i += blockDim.x) atomicAdd(&j1[i], s_hist[i]);
  }
}

// The kCluster instantiation's launch configuration (cic_common.cuh
// cluster_launch_config): `cluster` CTAs a cluster, `blocks` CTAs of
// `threads`, S elements of T a CTA. `attr` holds the cluster's dimension.
template <bool EMIT_V, bool SHARED, typename T>
cudaError_t cluster_config(int ng, int blocks, int threads, int cluster, cudaStream_t s,
                           cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  if (cluster < 1) return cudaErrorInvalidValue;
  return cluster_launch_config(picard_iteration_kernel<EMIT_V, SHARED, kCluster, T>,
                               (size_t)((ng + cluster - 1) / cluster) * sizeof(T), blocks,
                               threads, cluster, s, cfg, attr);
}

// Launches picard_iteration_kernel<EMIT_V, SHARED, mode, T> after the
// shared-memory opt-in; kCluster (mode 2) in clusters of `cluster` CTAs;
// kPair (mode 3, float alone) on the 3 ng elements at jh, the pair array
// then the sum, and the fold after it.
template <bool EMIT_V, bool SHARED, typename T>
cudaError_t launch_iteration(int mode, int blocks, int threads, int cluster,
                             cudaStream_t s, const T* field, const T* ps, const T* p0,
                             const T* v0, T* ph, T* v1, T* jh, int* n_clamped, long long n,
                             int ng, T qm_dt, T qm_dt2_half, T dt_dx, T w, T inv_ng,
                             int win_stride, int width, int num_k, T inv_stride) {
  if (mode == kPair) {
    if constexpr (std::is_same<T, float>::value) {
      picard_iteration_kernel<EMIT_V, SHARED, kPair, T><<<blocks, threads, 0, s>>>(
          field, ps, p0, v0, ph, v1, jh, n_clamped, n, ng, qm_dt, qm_dt2_half, dt_dx, w,
          inv_ng, win_stride, width, num_k, inv_stride);
      cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return err;
      pair_fold_kernel<T><<<(ng + 255) / 256, 256, 0, s>>>(jh, jh + 2 * ng, ng);
      return cudaGetLastError();
    } else {
      return cudaErrorInvalidValue;
    }
  }
  if (mode == kCluster) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    cudaError_t err =
        cluster_config<EMIT_V, SHARED, T>(ng, blocks, threads, cluster, s, &cfg, &attr);
    if (err != cudaSuccess) return err;
    err = cudaLaunchKernelEx(&cfg, picard_iteration_kernel<EMIT_V, SHARED, kCluster, T>,
                             field, ps, p0, v0, ph, v1, jh, n_clamped, n, ng, qm_dt,
                             qm_dt2_half, dt_dx, w, inv_ng, win_stride, width, num_k,
                             inv_stride);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
  }
  return with_mode(mode, [&](auto m) {
    constexpr int MODE = decltype(m)::value;
    const size_t smem = mode_floats(MODE, 2, ng) * sizeof(T);
    cudaError_t err = allow_smem(picard_iteration_kernel<EMIT_V, SHARED, MODE, T>, smem);
    if (err != cudaSuccess) return err;
    picard_iteration_kernel<EMIT_V, SHARED, MODE, T><<<blocks, threads, smem, s>>>(
        field, ps, p0, v0, ph, v1, jh, n_clamped, n, ng, qm_dt, qm_dt2_half,
        dt_dx, w, inv_ng, win_stride, width, num_k, inv_stride);
    return cudaGetLastError();
  });
}

// The launcher of either pass (SHARED: the shared window), with or
// without v1: one body for the float and double entry points.
template <bool SHARED, typename T>
cudaError_t launch_pass(int mode, int blocks, int threads, int cluster, cudaStream_t s,
                        const T* field, const T* ps, const T* p0, const T* v0, T* ph,
                        T* v1, T* jh, int* n_clamped, long long n, int ng, T qm_dt,
                        T qm_dt2_half, T dt_dx, T w, T inv_ng, int win_stride,
                        int width, int num_k, T inv_stride) {
  if (v1 != nullptr)
    return launch_iteration<true, SHARED>(mode, blocks, threads, cluster, s, field, ps, p0,
                                          v0, ph, v1, jh, n_clamped, n, ng, qm_dt,
                                          qm_dt2_half, dt_dx, w, inv_ng, win_stride, width,
                                          num_k, inv_stride);
  return launch_iteration<false, SHARED>(mode, blocks, threads, cluster, s, field, ps, p0,
                                         v0, ph, v1, jh, n_clamped, n, ng, qm_dt,
                                         qm_dt2_half, dt_dx, w, inv_ng, win_stride, width,
                                         num_k, inv_stride);
}

// How many clusters of the kCluster pass (emit_v, shared window, double)
// at ng nodes, `cluster` CTAs of `threads` a cluster, the card holds at
// once (cudaOccupancyMaxActiveClusters): 0 means it cannot launch one.
template <bool EMIT_V, bool SHARED, typename T>
cudaError_t pass_clusters(int ng, int cluster, int threads, int* count) {
  if (cluster < 1) return cudaErrorInvalidValue;
  return max_clusters(picard_iteration_kernel<EMIT_V, SHARED, kCluster, T>,
                      (size_t)((ng + cluster - 1) / cluster) * sizeof(T), cluster, threads,
                      count);
}

template <bool DEPOSIT, typename T>
cudaError_t launch_finalize(int mode, int blocks, int threads, cudaStream_t s,
                            const T* field, const T* ps, const T* p0, const T* v0,
                            T* p1, T* v1, T* j1, long long n, int ng, T qm_dt,
                            T qm_dt2_half, T dt_dx, T w, T inv_ng) {
  return with_mode(mode, [&](auto m) {
    constexpr int MODE = decltype(m)::value;
    const size_t smem = mode_floats(MODE, DEPOSIT ? 2 : 1, ng) * sizeof(T);
    cudaError_t err = allow_smem(picard_finalize_kernel<DEPOSIT, MODE, T>, smem);
    if (err != cudaSuccess) return err;
    picard_finalize_kernel<DEPOSIT, MODE, T><<<blocks, threads, smem, s>>>(
        field, ps, p0, v0, p1, v1, j1, n, ng, qm_dt, qm_dt2_half, dt_dx, w, inv_ng);
    return cudaGetLastError();
  });
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
template <typename T>
__device__ __forceinline__ void add_nonzero(T* h, int at, T v) {
  if (v != (T)0) atomicAdd(h + at, v);
}

template <bool PERIODIC, int ROWS, bool VEC, typename T>
__global__ void __launch_bounds__(1024, 1)
    deposit_kernel(const T* __restrict__ p, const T* __restrict__ values,
                   T* __restrict__ out, long long n, int ng, int cols) {
  extern __shared__ float4 smem4[];
  T* h = reinterpret_cast<T*>(smem4);
  zero_shared(h, ng * cols);
  __syncthreads();
  if (ROWS == 1) {  // narrow: a row a thread, grid-stride, one column
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += stride) {
      const T val = values[i];
      const CicT<T> c = PERIODIC ? cic_periodic(p[i], ng) : cic_bounded(p[i], ng);
      add_nonzero(h, c.l, mul_rn(val, c.wl));
      add_nonzero(h, c.r, mul_rn(val, c.wr));
    }
  } else {  // wide: groups of four rows, lane columns
    const int col = threadIdx.x & (cols - 1);
    long long lo, hi;
    block_groups(n, lo, hi);
    const long long end = min(n, 4 * hi);
    for (long long g = lo + threadIdx.x; g < hi; g += blockDim.x) {
      const long long i = 4 * g;
      const auto p4 = load4<VEC>(p, i, end, (T)0);
      const auto v4 = load4<VEC>(values, i, end, (T)0);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (i + r >= end) break;
        const CicT<T> c =
            PERIODIC ? cic_periodic(get(p4, r), ng) : cic_bounded(get(p4, r), ng);
        const T val = get(v4, r);
        add_nonzero(h, c.l * cols + col, mul_rn(val, c.wl));
        add_nonzero(h, c.r * cols + col, mul_rn(val, c.wr));
      }
    }
  }
  flush_columns<ROWS, 1, true, T>(h, ng, cols, out, nullptr);
}

// The large mode (deposit_launch_shape's cols 0: above 58,112 nodes, where
// one lane column no longer fits a block): the same rows a block and
// thread, no shared histogram, each nonzero product a global float atomic
// into the zeroed out (4 B a node: 16 MiB at 2^22 nodes, in L2 up to
// ~12.5 M nodes). Bound: the rows' 8 B and the node's 4 B written once.
template <bool PERIODIC, int ROWS, bool VEC, typename T>
__global__ void __launch_bounds__(1024, 1)
    deposit_global_kernel(const T* __restrict__ p, const T* __restrict__ values,
                          T* __restrict__ out, long long n, int ng) {
  if (ROWS == 1) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += stride) {
      const T val = values[i];
      const CicT<T> c = PERIODIC ? cic_periodic(p[i], ng) : cic_bounded(p[i], ng);
      add_nonzero(out, c.l, mul_rn(val, c.wl));
      add_nonzero(out, c.r, mul_rn(val, c.wr));
    }
  } else {
    long long lo, hi;
    block_groups(n, lo, hi);
    const long long end = min(n, 4 * hi);
    for (long long g = lo + threadIdx.x; g < hi; g += blockDim.x) {
      const long long i = 4 * g;
      const auto p4 = load4<VEC>(p, i, end, (T)0);
      const auto v4 = load4<VEC>(values, i, end, (T)0);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (i + r >= end) break;
        const CicT<T> c =
            PERIODIC ? cic_periodic(get(p4, r), ng) : cic_bounded(get(p4, r), ng);
        const T val = get(v4, r);
        add_nonzero(out, c.l, mul_rn(val, c.wl));
        add_nonzero(out, c.r, mul_rn(val, c.wr));
      }
    }
  }
}

// The launch of either deposit of one histogram (deposit_launch_shape:
// cols 0 the large mode), for the float and double entry points.
template <typename T>
cudaError_t launch_deposit(const T* p, const T* values, T* out, long long n, int ng,
                           int periodic, int rows, int blocks, int threads, int cols,
                           cudaStream_t s) {
  if (!deposit_shape_ok(n, ng, rows, blocks, threads, cols, true))
    return cudaErrorInvalidValue;
  const size_t smem = (size_t)ng * cols * sizeof(T);
  const bool vec = aligned16(p) && aligned16(values);
  cudaError_t err;
  if (cols == 0) {  // the large mode
#define PYPIC_DEPOSIT_GLOBAL(PER, ROWS, VEC)                                     \
  deposit_global_kernel<PER, ROWS, VEC, T><<<blocks, threads, 0, s>>>(p, values, \
                                                                     out, n, ng); \
  return cudaGetLastError()
    if (periodic) {
      if (rows == 1) { PYPIC_DEPOSIT_GLOBAL(true, 1, false); }
      if (vec) { PYPIC_DEPOSIT_GLOBAL(true, 4, true); }
      PYPIC_DEPOSIT_GLOBAL(true, 4, false);
    }
    if (rows == 1) { PYPIC_DEPOSIT_GLOBAL(false, 1, false); }
    if (vec) { PYPIC_DEPOSIT_GLOBAL(false, 4, true); }
    PYPIC_DEPOSIT_GLOBAL(false, 4, false);
#undef PYPIC_DEPOSIT_GLOBAL
  }
#define PYPIC_DEPOSIT(PER, ROWS, VEC)                                            \
  err = allow_smem(deposit_kernel<PER, ROWS, VEC, T>, smem);                     \
  if (err != cudaSuccess) return err;                                            \
  deposit_kernel<PER, ROWS, VEC, T><<<blocks, threads, smem, s>>>(p, values, out, \
                                                                 n, ng, cols);   \
  return cudaGetLastError()
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
// 29.2 (PERF.md §7). The columns fit a block up to ng = 1,815; above it
// deposit_det_large_kernel takes the sums as int64 fixed point in device
// memory (the design and its pricing: sheath.cu's header). Bound there:
// the 8 B a row read twice (the scale sweep and the deposit sweep).
// Both take the element type E last: the double kernels (the sheath
// engine's float64 state) keep columns of doubles up to 907 nodes and
// sum each term in two int64 words above it (cic_common.cuh "Two-word
// sums"); 16 B a row, and 16 B a node of scratch in the large mode.
// ---------------------------------------------------------------------------
template <bool PERIODIC, bool VEC, typename E>
__global__ void __launch_bounds__(1024) deposit_det_kernel(
    const E* __restrict__ p, const E* __restrict__ values,
    E* __restrict__ out, E* __restrict__ partial,
    unsigned int* __restrict__ counter, long long n, long long rows_per_block,
    int ng) {
  extern __shared__ float4 smem4[];
  E* s_hist = reinterpret_cast<E*>(smem4);  // column t: s_hist[node * T + t]
  const int T = blockDim.x;
  zero_shared(s_hist, T * ng);
  __syncthreads();
  E* mine = s_hist + threadIdx.x;
  const long long lo = (long long)blockIdx.x * rows_per_block;
  const long long hi = min(n, lo + rows_per_block);
  for (long long i = lo + 4LL * threadIdx.x; i < hi; i += 4LL * T) {
    const auto p4 = load4<VEC>(p, i, hi, (E)0);
    const auto v4 = load4<VEC>(values, i, hi, (E)0);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if (i + r >= hi) break;
      const CicT<E> c =
          PERIODIC ? cic_periodic(get(p4, r), ng) : cic_bounded(get(p4, r), ng);
      const E val = get(v4, r);
      mine[c.l * T] = add_rn(mine[c.l * T], mul_rn(val, c.wl));
      mine[c.r * T] = add_rn(mine[c.r * T], mul_rn(val, c.wr));
    }
  }
  det_flush(s_hist, ng, partial, counter, out);
}

// The large mode (ng above the columns' ceiling, 1,815; 907 in double;
// launch_shape's `large` without the field): the same rows a block, the
// sums as int64 fixed point in device memory (cic_common.cuh "Large
// deterministic sums"; two words a term in double, "Two-word sums").
// SCALE: the first sweep, the largest |term| into bmax[block] and acc
// zeroed; else every term added.
template <bool PERIODIC, bool VEC, bool SCALE, typename E>
__global__ void __launch_bounds__(kLargeThreads, 2) deposit_det_large_kernel(
    const E* __restrict__ p, const E* __restrict__ values,
    E* __restrict__ bmax, unsigned long long* __restrict__ acc, long long n,
    long long rows_per_block, int ng) {
  constexpr bool kTwo = fixed_words<E>() == 2;
  double scale = 0.0, lscale = 0.0;
  if (SCALE)
    fixed_zero(acc, fixed_words<E>() * ng);
  else
    scale = fixed_scale(bmax, gridDim.x, n);
  if constexpr (kTwo) lscale = ldexp(1.0, fixed2_bits(n));
  const int T = blockDim.x;
  const long long lo = (long long)blockIdx.x * rows_per_block;
  const long long hi = min(n, lo + rows_per_block);
  E m = (E)0;
  for (long long i = lo + 4LL * threadIdx.x; i < hi; i += 4LL * T) {
    const auto p4 = load4<VEC>(p, i, hi, (E)0);
    const auto v4 = load4<VEC>(values, i, hi, (E)0);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if (i + r >= hi) break;
      const CicT<E> c =
          PERIODIC ? cic_periodic(get(p4, r), ng) : cic_bounded(get(p4, r), ng);
      const E val = get(v4, r);
      const E tl = mul_rn(val, c.wl), tr = mul_rn(val, c.wr);
      if (SCALE) {
        fixed_track(m, tl);
        fixed_track(m, tr);
      } else if constexpr (kTwo) {
        fixed2_add(acc, ng, c.l, tl, scale, lscale);
        fixed2_add(acc, ng, c.r, tr, scale, lscale);
      } else {
        fixed_add(acc, c.l, tl, scale);
        fixed_add(acc, c.r, tr, scale);
      }
    }
  }
  if (SCALE) fixed_scale_out(m, bmax);
}

template <typename E>
cudaError_t launch_deposit_det(const E* p, const E* values, E* out, E* partial,
                               unsigned int* counter, long long n, int ng,
                               int periodic, int blocks, int threads,
                               long long rows_per_block, cudaStream_t s) {
  if (threads < 32 || threads > 1024 || threads % 32 != 0 || rows_per_block % 4 != 0)
    return cudaErrorInvalidValue;
  const size_t smem = (size_t)threads * ng * sizeof(E);
  const bool vec = aligned16(p) && aligned16(values);
  cudaError_t err;
#define PYPIC_DEPOSIT_DET(PER, VEC)                                             \
  err = allow_smem(deposit_det_kernel<PER, VEC, E>, smem);                      \
  if (err != cudaSuccess) return err;                                           \
  deposit_det_kernel<PER, VEC, E><<<blocks, threads, smem, s>>>(                \
      p, values, out, partial, counter, n, rows_per_block, ng);                 \
  return cudaGetLastError()
  if (periodic) {
    if (vec) { PYPIC_DEPOSIT_DET(true, true); }
    PYPIC_DEPOSIT_DET(true, false);
  }
  if (vec) { PYPIC_DEPOSIT_DET(false, true); }
  PYPIC_DEPOSIT_DET(false, false);
#undef PYPIC_DEPOSIT_DET
}

template <typename E>
cudaError_t launch_deposit_det_large(const E* p, const E* values, E* out, E* bmax,
                                     unsigned long long* acc, long long n, int ng,
                                     int periodic, int blocks, int threads,
                                     long long rows_per_block, cudaStream_t s) {
  if (!large_shape_ok(ng, blocks, threads, rows_per_block))
    return cudaErrorInvalidValue;
  const bool vec = aligned16(p) && aligned16(values);
  cudaError_t err;
#define PYPIC_DEPOSIT_DET_LARGE(PER, VEC)                                       \
  deposit_det_large_kernel<PER, VEC, true, E><<<blocks, threads, 0, s>>>(       \
      p, values, bmax, acc, n, rows_per_block, ng);                             \
  err = cudaGetLastError();                                                     \
  if (err != cudaSuccess) return err;                                           \
  deposit_det_large_kernel<PER, VEC, false, E><<<blocks, threads, 0, s>>>(      \
      p, values, bmax, acc, n, rows_per_block, ng);                             \
  err = cudaGetLastError()
  if (periodic) {
    if (vec) { PYPIC_DEPOSIT_DET_LARGE(true, true); } else { PYPIC_DEPOSIT_DET_LARGE(true, false); }
  } else {
    if (vec) { PYPIC_DEPOSIT_DET_LARGE(false, true); } else { PYPIC_DEPOSIT_DET_LARGE(false, false); }
  }
#undef PYPIC_DEPOSIT_DET_LARGE
  if (err != cudaSuccess) return err;
  return launch_fixed_out(acc, bmax, blocks, n, ng, out, s);
}

}  // namespace

extern "C" {

// mode: ops/cuda_cic.py cluster_launch (0 shared, 1 global, 2 cluster,
// 3 pair; cluster: the CTAs a cluster in mode 2, else unread); jh: ng
// zeroed floats, in mode 3 3 ng (2 ng zeroed: the pair array, then the
// sum the fold writes).
int pypic_picard_iteration(const float* field, const float* ps, const float* p0,
                           const float* v0, float* ph, float* v1, float* jh,
                           long long n, int ng, float qm_dt, float qm_dt2_half,
                           float dt_dx, float w, float inv_ng, int mode,
                           int blocks, int threads, int cluster, void* stream) {
  return (int)launch_pass<false>(mode, blocks, threads, cluster, (cudaStream_t)stream, field, ps,
                                 p0, v0, ph, v1, jh, nullptr, n, ng, qm_dt, qm_dt2_half,
                                 dt_dx, w, inv_ng, 0, 0, 0, 0.0f);
}

// The double pass (a float64 state): every pointer to doubles, every
// scalar a double (its _SIGNATURES entry passes them as c_double).
int pypic_picard_iteration_f64(const double* field, const double* ps, const double* p0,
                               const double* v0, double* ph, double* v1, double* jh,
                               long long n, int ng, double qm_dt, double qm_dt2_half,
                               double dt_dx, double w, double inv_ng, int mode,
                               int blocks, int threads, int cluster, void* stream) {
  return (int)launch_pass<false>(mode, blocks, threads, cluster, (cudaStream_t)stream, field, ps,
                                 p0, v0, ph, v1, jh, nullptr, n, ng, qm_dt, qm_dt2_half,
                                 dt_dx, w, inv_ng, 0, 0, 0, 0.0);
}

// The clusters the card holds at once of the pass's kCluster launch at ng
// nodes (shared: the shared window; emit_v: v1 stored; f64: the double
// kernel), `cluster` CTAs of `threads` a cluster: 0 means it cannot
// launch one.
int pypic_picard_iteration_clusters(int shared, int emit_v, int f64, int ng, int cluster,
                                    int threads, int* count) {
  cudaError_t err;
#define PYPIC_PASS_CLUSTERS(EV, SH, T) \
  err = pass_clusters<EV, SH, T>(ng, cluster, threads, count)
  if (f64) {
    if (shared) {
      if (emit_v) PYPIC_PASS_CLUSTERS(true, true, double); else PYPIC_PASS_CLUSTERS(false, true, double);
    } else {
      if (emit_v) PYPIC_PASS_CLUSTERS(true, false, double); else PYPIC_PASS_CLUSTERS(false, false, double);
    }
  } else {
    if (shared) {
      if (emit_v) PYPIC_PASS_CLUSTERS(true, true, float); else PYPIC_PASS_CLUSTERS(false, true, float);
    } else {
      if (emit_v) PYPIC_PASS_CLUSTERS(true, false, float); else PYPIC_PASS_CLUSTERS(false, false, float);
    }
  }
#undef PYPIC_PASS_CLUSTERS
  return (int)err;
}

// mode: 0 shared, 1 global.
int pypic_picard_finalize_nodep(const float* field, const float* ps,
                                const float* p0, const float* v0, float* p1,
                                float* v1, long long n, int ng, float qm_dt,
                                float qm_dt2_half, float dt_dx, float inv_ng,
                                int mode, int blocks, int threads, void* stream) {
  return (int)launch_finalize<false>(mode, blocks, threads, (cudaStream_t)stream,
                                     field, ps, p0, v0, p1, v1, (float*)nullptr, n, ng,
                                     qm_dt, qm_dt2_half, dt_dx, 0.0f, inv_ng);
}

int pypic_picard_finalize_nodep_f64(const double* field, const double* ps,
                                    const double* p0, const double* v0, double* p1,
                                    double* v1, long long n, int ng, double qm_dt,
                                    double qm_dt2_half, double dt_dx, double inv_ng,
                                    int mode, int blocks, int threads, void* stream) {
  return (int)launch_finalize<false>(mode, blocks, threads, (cudaStream_t)stream,
                                     field, ps, p0, v0, p1, v1, (double*)nullptr, n, ng,
                                     qm_dt, qm_dt2_half, dt_dx, 0.0, inv_ng);
}

// j1: ng zeroed floats.
int pypic_picard_finalize(const float* field, const float* ps, const float* p0,
                          const float* v0, float* p1, float* v1, float* j1,
                          long long n, int ng, float qm_dt, float qm_dt2_half,
                          float dt_dx, float w, float inv_ng, int mode,
                          int blocks, int threads, void* stream) {
  return (int)launch_finalize<true>(mode, blocks, threads, (cudaStream_t)stream,
                                    field, ps, p0, v0, p1, v1, j1, n, ng, qm_dt,
                                    qm_dt2_half, dt_dx, w, inv_ng);
}

// j1: ng zeroed doubles.
int pypic_picard_finalize_f64(const double* field, const double* ps, const double* p0,
                              const double* v0, double* p1, double* v1, double* j1,
                              long long n, int ng, double qm_dt, double qm_dt2_half,
                              double dt_dx, double w, double inv_ng, int mode,
                              int blocks, int threads, void* stream) {
  return (int)launch_finalize<true>(mode, blocks, threads, (cudaStream_t)stream,
                                    field, ps, p0, v0, p1, v1, j1, n, ng, qm_dt,
                                    qm_dt2_half, dt_dx, w, inv_ng);
}

// jh: ng zeroed floats; n_clamped: one zeroed int.
int pypic_picard_iteration_shared(
    const float* field, const float* ps, const float* p0, const float* v0,
    float* ph, float* v1, float* jh, int* n_clamped, long long n, int ng,
    float qm_dt, float qm_dt2_half, float dt_dx, float w, float inv_ng,
    int win_stride, int width, int num_k, float inv_stride, int mode, int blocks,
    int threads, int cluster, void* stream) {
  return (int)launch_pass<true>(mode, blocks, threads, cluster, (cudaStream_t)stream, field, ps,
                                p0, v0, ph, v1, jh, n_clamped, n, ng, qm_dt, qm_dt2_half,
                                dt_dx, w, inv_ng, win_stride, width, num_k, inv_stride);
}

// jh: ng zeroed doubles; n_clamped: one zeroed int.
int pypic_picard_iteration_shared_f64(
    const double* field, const double* ps, const double* p0, const double* v0,
    double* ph, double* v1, double* jh, int* n_clamped, long long n, int ng,
    double qm_dt, double qm_dt2_half, double dt_dx, double w, double inv_ng,
    int win_stride, int width, int num_k, double inv_stride, int mode, int blocks,
    int threads, int cluster, void* stream) {
  return (int)launch_pass<true>(mode, blocks, threads, cluster, (cudaStream_t)stream, field, ps,
                                p0, v0, ph, v1, jh, n_clamped, n, ng, qm_dt, qm_dt2_half,
                                dt_dx, w, inv_ng, win_stride, width, num_k, inv_stride);
}

// out: ng zeroed floats; rows, blocks, threads and cols from
// ops/cuda_cic.py deposit_launch_shape (one histogram; cols 0: the large
// mode).
int pypic_deposit(const float* p, const float* values, float* out, long long n,
                  int ng, int periodic, int rows, int blocks, int threads,
                  int cols, void* stream) {
  return (int)launch_deposit(p, values, out, n, ng, periodic, rows, blocks, threads, cols,
                             (cudaStream_t)stream);
}

// out: ng zeroed doubles; the shape from deposit_launch_shape(..., item=8).
int pypic_deposit_f64(const double* p, const double* values, double* out, long long n,
                      int ng, int periodic, int rows, int blocks, int threads,
                      int cols, void* stream) {
  return (int)launch_deposit(p, values, out, n, ng, periodic, rows, blocks, threads, cols,
                             (cudaStream_t)stream);
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
  return (int)launch_deposit_det(p, values, out, partial, counter, n, ng, periodic,
                                 blocks, threads, rows_per_block, (cudaStream_t)stream);
}

// The double deposit (a float64 state): out ng doubles, partial blocks *
// ng doubles; the shape from launch_shape(n, ng, sms, field=False, item=8).
int pypic_deposit_det_f64(const double* p, const double* values, double* out,
                          double* partial, unsigned int* counter, long long n,
                          int ng, int periodic, int blocks, int threads,
                          long long rows_per_block, void* stream) {
  return (int)launch_deposit_det(p, values, out, partial, counter, n, ng, periodic,
                                 blocks, threads, rows_per_block, (cudaStream_t)stream);
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
  return (int)launch_deposit_det_large(p, values, out, bmax, acc, n, ng, periodic,
                                       blocks, threads, rows_per_block,
                                       (cudaStream_t)stream);
}

// The double large mode: bmax blocks doubles, acc 2 ng int64 (the two
// words, cic_common.cuh "Two-word sums").
int pypic_deposit_det_large_f64(const double* p, const double* values, double* out,
                                double* bmax, unsigned long long* acc, long long n,
                                int ng, int periodic, int blocks, int threads,
                                long long rows_per_block, void* stream) {
  return (int)launch_deposit_det_large(p, values, out, bmax, acc, n, ng, periodic,
                                       blocks, threads, rows_per_block,
                                       (cudaStream_t)stream);
}

const char* pypic_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
