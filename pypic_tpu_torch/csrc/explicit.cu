// Kernels of the explicit leapfrog engine, for Hopper (sm_90a).
//
// Four kernels, each the counterpart of a Pallas TPU kernel in
// pypic_tpu/ops/pallas_cic.py: the CIC gather, the fused gather + leapfrog
// + rho deposit sweep, the whole explicit cycle in one launch (the sweep
// plus the rho -> E solve in an epilogue) and the resident multi-step
// cycle. The TPU kernels' tent windows, selector matmuls, fold and
// selection matrices and SMEM scalar packing are not carried over: the
// CIC arithmetic is cic_common.cuh's, and the field solve is the O(ng)
// direct form of the periodic Poisson + centered-gradient operator.
//
// The leapfrog body is that of pallas_cic.py:834-846:
//   vh = v + qmh e;  p1 = wrap(p + vh dt_dx);  v1 = vh + qmh e
// with qmh = q/m dt/2 and dt_dx computed on the host in the state's
// dtype, in the Pallas wrappers' order. mul_rn / add_rn (__fmul_rn /
// __fadd_rn for float) keep nvcc from fusing.
//
// The gather, the leapfrog_deposit sweep and the explicit cycle take the
// element type T (float, or double for a float64 state) as their
// templates' last argument: a float instantiation is the code the float
// kernel was, a double one rounds each operation once in double, as the
// plain versions' float64 operations do.
//
// Launchers return cudaGetLastError(); they allocate nothing and run on
// the stream they are given.

#include <cooperative_groups.h>

#include "cic_common.cuh"

namespace cg = cooperative_groups;

namespace {

// Kick-drift-kick with one gathered field value, then the periodic wrap.
template <typename T>
__device__ __forceinline__ void leapfrog(T p, T v, T e, T qmh, T dt_dx, T ngf,
                                         T inv_ng, T& p1, T& v1) {
  const T kick = mul_rn(qmh, e);
  const T vh = add_rn(v, kick);
  p1 = wrap(add_rn(p, mul_rn(vh, dt_dx)), ngf, inv_ng);
  v1 = add_rn(vh, kick);
}

// Block-wide exclusive prefix sum over threads in thread order.
__device__ double block_exclusive_scan(double x, double* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  double incl = x;
  for (int o = 1; o < 32; o <<= 1) {
    const double y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  double excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.0;
  __syncthreads();
  if (lane == 31) red[warp] = incl;
  __syncthreads();
  for (int w = 0; w < warp; ++w) excl += red[w];
  return excl;
}

// The periodic field of a charge density: the neutralized (1, -2, 1)
// Poisson solve and the centered gradient of ops/poisson.py + ops/fd.py,
// in the O(ng) direct form of the same discrete operator. With
// T = prefix sum of (rho - mean(rho)) and d = T - mean(T) (the forward
// differences of the zero-mean potential, up to -dx^2/eps0),
//   e_i = dx / (2 eps0) (d_i + d_{i-1}),  d_{-1} = d_{ng-1}.
// Float64 throughout, e rounded to T once. `c` = dx / (2 eps0), `scr` ng
// doubles and `red` 32 doubles of shared memory. Every thread of the
// block calls it; it ends with a __syncthreads().
template <typename T>
__device__ void field_from_rho(const T* rho, T* e_out, int ng, double c,
                               double* scr, double* red) {
  const int t = threadIdx.x, nt = blockDim.x;
  double s = 0.0;
  for (int i = t; i < ng; i += nt) s += (double)rho[i];
  const double mean = block_sum(s, red) / ng;
  // contiguous chunks per thread for the scan
  const int per = (ng + nt - 1) / nt;
  const int lo = min(t * per, ng), hi = min(lo + per, ng);
  double part = 0.0;
  for (int i = lo; i < hi; ++i) part += (double)rho[i] - mean;
  double run = block_exclusive_scan(part, red);
  for (int i = lo; i < hi; ++i) {
    run += (double)rho[i] - mean;
    scr[i] = run;
  }
  __syncthreads();
  s = 0.0;
  for (int i = t; i < ng; i += nt) s += scr[i];
  const double mean_t = block_sum(s, red) / ng;
  for (int i = t; i < ng; i += nt) {
    const double d = scr[i] - mean_t;
    const double dm = scr[i == 0 ? ng - 1 : i - 1] - mean_t;
    e_out[i] = (T)(c * (d + dm));
  }
  __syncthreads();
}

// The sweep of the two per-step leapfrog kernels: gather e at p from the
// block's copy of the field (from `field` in device memory in the large
// modes), push, wrap, store (p1, v1), deposit w at p1 into `hist` (the
// block's histogram, the zeroed output in kGlobal, the cluster's slices
// of `slice` nodes in kCluster, the pair array in kPair).
template <int MODE = kShared, typename T>
__device__ __forceinline__ void leapfrog_deposit_sweep(
    const T* s_field, T* s_hist, const T* __restrict__ p, const T* __restrict__ v,
    T* __restrict__ p1_out, T* __restrict__ v1_out, long long n, int ng, T qmh,
    T dt_dx, T w, T inv_ng, const T* __restrict__ field = nullptr, int slice = 0) {
  const T ngf = (T)ng;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const T a = p[i];
    const T e = gather_mode<MODE>(s_field, field, cic_periodic(a, ng));
    T p1, v1;
    leapfrog(a, v[i], e, qmh, dt_dx, ngf, inv_ng, p1, v1);
    p1_out[i] = p1;
    v1_out[i] = v1;
    const CicT<T> c = cic_periodic(p1, ng);
    if constexpr (MODE == kCluster) {
      cluster_add(s_hist, slice, c, mul_rn(w, c.wl), mul_rn(w, c.wr));
    } else if constexpr (MODE == kPair) {
      pair_add(s_hist, c.l, mul_rn(w, c.wl), mul_rn(w, c.wr));
    } else {
      atomicAdd(&s_hist[c.l], mul_rn(w, c.wl));
      atomicAdd(&s_hist[c.r], mul_rn(w, c.wr));
    }
  }
}

// ---------------------------------------------------------------------------
// gather
//
// Replaces pypic_tpu/ops/pallas_cic.py:_gather_kernel (gather_pallas).
// CIC interpolation of an (ng,) node field to n positions, periodic or
// bounded.
//
// Bound on the H100: device-memory bytes, 4 B read and 4 B written per
// particle. The field is copied once per block into shared memory, so the
// two node reads per particle never reach device memory; one thread per
// particle in a grid-stride loop keeps the loads and stores coalesced.
//
// Above 58,112 nodes (the field alone no longer fits a block) MODE is
// kGlobal: each row reads its two nodes from device memory through the
// read-only path (cic_common.cuh); the field (4 B a node: 16 MiB at 2^22)
// stays in the 50 MB L2. Bound there: the rows' 8 B and the field's 4 B
// a node read once.
//
// T double (a float64 state, pypic_gather_f64): 16 B a row, the shared
// field to 29,056 nodes, the global mode above (cic.cu's header).
// ---------------------------------------------------------------------------
template <bool PERIODIC, int MODE, typename T>
__global__ void gather_kernel(const T* __restrict__ field, const T* __restrict__ p,
                              T* __restrict__ out, long long n, int ng) {
  T* s_field = dynamic_smem<T>();
  load_field<MODE>(s_field, field, ng);
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const T a = p[i];
    out[i] = gather_mode<MODE>(s_field, field,
                               PERIODIC ? cic_periodic(a, ng) : cic_bounded(a, ng));
  }
}

// Launches gather_kernel<periodic, mode, T> after the shared-memory opt-in.
template <typename T>
cudaError_t launch_gather(const T* field, const T* p, T* out, long long n, int ng,
                          int periodic, int mode, int blocks, int threads,
                          cudaStream_t s) {
  return with_mode(mode, [&](auto m) {
    constexpr int MODE = decltype(m)::value;
    const size_t smem = mode_floats(MODE, 1, ng) * sizeof(T);
    cudaError_t err;
    if (periodic) {
      err = allow_smem(gather_kernel<true, MODE, T>, smem);
      if (err != cudaSuccess) return err;
      gather_kernel<true, MODE, T><<<blocks, threads, smem, s>>>(field, p, out, n, ng);
    } else {
      err = allow_smem(gather_kernel<false, MODE, T>, smem);
      if (err != cudaSuccess) return err;
      gather_kernel<false, MODE, T><<<blocks, threads, smem, s>>>(field, p, out, n, ng);
    }
    return cudaGetLastError();
  });
}

// ---------------------------------------------------------------------------
// leapfrog_deposit
//
// Replaces pypic_tpu/ops/pallas_cic.py:_leapfrog_deposit_kernel
// (leapfrog_gather_push_deposit_pallas): gather, kick-drift-kick, wrap,
// and the charge deposit of the new positions, (p1, v1, rho1). The engine
// runs it for ng > 1024, with the field solve outside.
//
// Bound on the H100: device-memory bytes, 8 B read and 8 B written per
// particle. The field and the partial histogram live in shared memory
// (2 ng floats, so ng <= 29,056); each block adds its histogram to rho
// with one global atomic per node.
//
// Above 29,056 nodes MODE is cic_common.cuh's kGlobal: the field read
// from device memory, each of a row's two adds a global float atomic into
// the zeroed rho. Bound there: the rows' 16 B, plus the field read and rho
// written once: 8 B a node.
//
// T double (a float64 state, pypic_leapfrog_deposit_f64): 32 B a row, the
// field and the histogram (2 ng doubles) in shared memory to 14,528 nodes,
// kGlobal (global double atomics) above it; 16 B a node there.
//
// MODE kCluster and kPair (ops/cuda_cic.py cluster_launch, PASS_RULE: the
// modes rows 1 and 2 take in cic.cu): kGlobal's sweep, so p1 and v1 are
// its bits; kCluster sums rho in the slices of a thread-block cluster's
// CTAs of 1,024 threads, one an SM (cic_common.cuh cluster_add; float or
// double), one global atomic a node and CTA in the flush; kPair (float)
// makes a row's two products one red.global.add.v2.f32 into a zeroed (ng,
// 2) pair array, folded by pair_fold_kernel. explicit_cycle_kernel runs
// the sweep in kShared alone, so its code is as it was.
// ---------------------------------------------------------------------------
template <int MODE, typename T>
__global__ void leapfrog_deposit_kernel(
    const T* __restrict__ field, const T* __restrict__ p, const T* __restrict__ v,
    T* __restrict__ p1, T* __restrict__ v1, T* __restrict__ rho, long long n, int ng,
    T qmh, T dt_dx, T w, T inv_ng) {
  // declared as floats so that the float kernel compiles to the same code
  // as without T (tools/sass_diff.py); the block's dynamic shared memory
  // starts 16-B aligned (the kernel has no static shared memory), which
  // the doubles need
  extern __shared__ float smem[];
  T* s_field = reinterpret_cast<T*>(smem);
  T* s_hist = s_field + ng;
  if constexpr (MODE == kCluster) {
    // the CTA's slice of rho at s_field; the field is read from device memory
    cg::cluster_group cluster = cg::this_cluster();
    const int ctas = (int)cluster.num_blocks();
    const int slice = (ng + ctas - 1) / ctas;
    for (int i = threadIdx.x; i < slice; i += blockDim.x) s_field[i] = (T)0;
    cluster.sync();  // every slice zeroed and live before any remote add
    leapfrog_deposit_sweep<MODE>(s_field, s_field, p, v, p1, v1, n, ng, qmh, dt_dx, w,
                                 inv_ng, field, slice);
    cluster.sync();  // every add into this slice has landed
    const int lo = (int)cluster.block_rank() * slice;
    const int count = min(slice, ng - lo);
    for (int i = threadIdx.x; i < count; i += blockDim.x) atomicAdd(&rho[lo + i], s_field[i]);
  } else {
    if (MODE == kShared) {
      for (int i = threadIdx.x; i < ng; i += blockDim.x) {
        s_field[i] = field[i];
        s_hist[i] = (T)0;
      }
    }
    __syncthreads();
    leapfrog_deposit_sweep<MODE>(s_field, MODE == kShared ? s_hist : rho, p, v, p1,
                                 v1, n, ng, qmh, dt_dx, w, inv_ng, field);
    if (MODE != kShared) return;
    __syncthreads();
    for (int i = threadIdx.x; i < ng; i += blockDim.x) atomicAdd(&rho[i], s_hist[i]);
  }
}

// ---------------------------------------------------------------------------
// explicit_cycle
//
// Replaces pypic_tpu/ops/pallas_cic.py:_explicit_cycle_kernel
// (explicit_cycle_pallas): the whole explicit PIC cycle in ONE launch, the
// leapfrog_deposit sweep and then the solve of the new rho for the next
// step's E, (p1, v1, rho1, e1). The engine runs it for ng <= 1024.
//
// Bound on the H100: device-memory bytes, 16 B per particle, as
// leapfrog_deposit, plus an O(ng) epilogue. The TPU runs its grid in
// order and solves in the last grid step; Hopper blocks run in no order,
// so the epilogue goes to the block that finishes LAST: each block flushes
// its histogram with atomics into the zeroed rho, fences, and takes a
// ticket from a counter; the block holding the last ticket reads the
// complete rho from L2 and solves it (field_from_rho, float64, 256
// threads). The counter is the word after rho's ng nodes in the same
// zeroed allocation, so every launch starts from 0 and no reset is needed.
//
// T double (a float64 state, pypic_explicit_cycle_f64): 32 B a row; the
// field and the histogram are doubles beside the solve's scratch, 3 ng
// doubles + 256 B of shared memory (2 ng floats + ng doubles + 256 B for
// float), and the ticket's 16 static bytes: at most 9,674 nodes (14,511
// for float; ops/cuda_cic.py check_cycle_smem); the counter is the first
// word of the double after rho.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void explicit_cycle_kernel(
    const T* __restrict__ field, const T* __restrict__ p, const T* __restrict__ v,
    T* __restrict__ p1, T* __restrict__ v1, T* rho, T* __restrict__ e1, long long n,
    int ng, T qmh, T dt_dx, T w, T inv_ng, double c_solve) {
  extern __shared__ double smem_d[];
  double* scr = smem_d;                        // ng
  double* red = smem_d + ng;                   // 32
  T* s_field = (T*)(smem_d + ng + 32);         // ng
  T* s_hist = s_field + ng;                    // ng
  __shared__ unsigned int s_ticket;
  unsigned int* counter = reinterpret_cast<unsigned int*>(rho + ng);

  for (int i = threadIdx.x; i < ng; i += blockDim.x) {
    s_field[i] = field[i];
    s_hist[i] = (T)0;
  }
  __syncthreads();
  leapfrog_deposit_sweep(s_field, s_hist, p, v, p1, v1, n, ng, qmh, dt_dx, w,
                         inv_ng);
  __syncthreads();
  for (int i = threadIdx.x; i < ng; i += blockDim.x) atomicAdd(&rho[i], s_hist[i]);
  __threadfence();  // this thread's flush is visible before the ticket
  __syncthreads();
  if (threadIdx.x == 0) s_ticket = atomicAdd(counter, 1u);
  __syncthreads();
  if (s_ticket != gridDim.x - 1) return;  // uniform across the block

  __threadfence();
  // __ldcg reads through L2, where the atomics landed, past this SM's L1
  for (int i = threadIdx.x; i < ng; i += blockDim.x) s_hist[i] = __ldcg(&rho[i]);
  __syncthreads();
  field_from_rho(s_hist, e1, ng, c_solve, scr, red);
}

// Launch leapfrog_deposit_kernel<mode, T> and explicit_cycle_kernel<T>
// after the shared-memory opt-in; the former's kCluster (mode 2) in
// clusters of `cluster` CTAs, a slice of ceil(ng / cluster) elements each,
// its kPair (mode 3, float alone) on the 3 ng elements at rho, the pair
// array then the sum, and the fold after it.
template <typename T>
cudaError_t launch_leapfrog_deposit(const T* field, const T* p, const T* v, T* p1, T* v1,
                                    T* rho, long long n, int ng, T qmh, T dt_dx, T w,
                                    T inv_ng, int mode, int blocks, int threads,
                                    int cluster, cudaStream_t s) {
  if (mode == kPair) {
    if constexpr (std::is_same<T, float>::value) {
      leapfrog_deposit_kernel<kPair, T><<<blocks, threads, 0, s>>>(
          field, p, v, p1, v1, rho, n, ng, qmh, dt_dx, w, inv_ng);
      cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return err;
      pair_fold_kernel<T><<<(ng + 255) / 256, 256, 0, s>>>(rho, rho + 2 * ng, ng);
      return cudaGetLastError();
    } else {
      return cudaErrorInvalidValue;
    }
  }
  if (mode == kCluster) {
    if (cluster < 1) return cudaErrorInvalidValue;
    auto kernel = leapfrog_deposit_kernel<kCluster, T>;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    cudaError_t err = cluster_launch_config(
        kernel, (size_t)((ng + cluster - 1) / cluster) * sizeof(T), blocks, threads,
        cluster, s, &cfg, &attr);
    if (err != cudaSuccess) return err;
    err = cudaLaunchKernelEx(&cfg, kernel, field, p, v, p1, v1, rho, n, ng, qmh, dt_dx, w,
                             inv_ng);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
  }
  return with_mode(mode, [&](auto m) {
    constexpr int MODE = decltype(m)::value;
    const size_t smem = mode_floats(MODE, 2, ng) * sizeof(T);
    cudaError_t err = allow_smem(leapfrog_deposit_kernel<MODE, T>, smem);
    if (err != cudaSuccess) return err;
    leapfrog_deposit_kernel<MODE, T><<<blocks, threads, smem, s>>>(
        field, p, v, p1, v1, rho, n, ng, qmh, dt_dx, w, inv_ng);
    return cudaGetLastError();
  });
}

template <typename T>
cudaError_t launch_explicit_cycle(const T* field, const T* p, const T* v, T* p1, T* v1,
                                  T* rho, T* e1, long long n, int ng, T qmh, T dt_dx, T w,
                                  T inv_ng, double c_solve, int blocks, int threads,
                                  cudaStream_t s) {
  const size_t smem = (size_t)(ng + 32) * sizeof(double) + 2 * (size_t)ng * sizeof(T);
  cudaError_t err = allow_smem(explicit_cycle_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  explicit_cycle_kernel<T><<<blocks, threads, smem, s>>>(
      field, p, v, p1, v1, rho, e1, n, ng, qmh, dt_dx, w, inv_ng, c_solve);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// explicit_cycle_resident
//
// Replaces pypic_tpu/ops/pallas_cic.py:_explicit_resident_kernel
// (explicit_cycle_resident_pallas): `steps` explicit cycles in one launch,
// with the per-step pre-push metric rows fe = fe_c sum(e^2),
// ke = ke_c sum(v^2), jb = jb_c sum(v), for n <= 32768 and ng <= 1024.
//
// Bound on the H100: latency. The float32 work (25 operations a particle
// and step) takes ~4 ns a step at the card's peak and the particles cross
// device memory once a launch; a step is a chain of a sweep, barriers and
// (ng,) work. The first port (one 8-CTA cluster x 1024 threads, float
// atomics into one histogram, block_sum and a block scan for the solve)
// took 9.46 µs a step at the configs[0] row (n = 10,000, ng = 200): 15
// block barriers and one cluster barrier a step, node sums pulled by
// remote loads one after another, shared-memory float atomics that this
// card runs as compare-and-swap loops (tools/resident_split.py; PERF.md
// §6).
//
// Design. ONE cluster of kResCtas = 8 CTAs of kResThreads = 512 threads
// (cuda_cic.explicit_resident_shape: a function of (n, ng) alone, and
// with it the order of every sum). 512 threads hold every n <= 32768 (8
// particles a thread) and beat 256 and 1024 at the configs[0] row (NVIDIA
// H100 80GB HBM3, 700 W, tools/resident_split.py: 6.52 ms a 2,000-step
// launch against 7.18 and 7.12). Per step three block barriers and one
// wait for the other CTAs' totals; no cluster barrier:
//
// * Particles. CTA r owns rows [r per_cta, (r + 1) per_cta); thread t
//   holds rows begin + j 512 + t in registers for the whole launch.
// * Deposit. Float atomics into lane columns, hist[node][lane], so a
//   warp's atomics hit distinct words. After the block barrier (B0)
//   each thread sums the columns of its nodes in a fixed order (rotated
//   by lane: conflict-free), zeroes them and PUSHES the CTA's node totals
//   into recv[step parity][rank][node] of all 8 CTAs by st.async, which
//   counts its bytes on the receiving CTA's mbarrier. Each CTA waits on
//   its own mbarrier for the step's 8 x ng totals, not on a cluster
//   barrier. Receive buffers and mbarriers alternate by step parity: a
//   CTA pushes step s + 2 only after every CTA's push of step s + 1 has
//   reached it, which each CTA makes only after reading step s's totals.
// * Field. Thread t owns a contiguous run of nodes and adds each node's 8
//   totals in rank order, so every CTA holds bit-identical rho and E. The
//   field of field_from_rho is a pointwise function of the prefix sum P
//   of rho: T_i = P_i - (i + 1) m (m the mean), mean(T) =
//   sum_k rho_k (ng - k) / ng - m (ng + 1) / 2, d = T - mean(T) and
//   d_{i-1} = d_i - (rho_i - m), so e_i = dx / (2 eps0) (2 d_i - rho_i + m).
//   P is a run, a warp scan and the warps' totals (B1); each thread then
//   writes its nodes' e (B2). Float64 throughout, e rounded once.
// * Metrics. Each warp's ke, jb partials are pushed to rank 0 with the
//   totals (its mbarrier counts them too), and rank 0's warps leave their
//   sums of e^2; rank 0's last warp adds them in a fixed order while the
//   others push the next step's totals, off the step's chain.
// ---------------------------------------------------------------------------
constexpr int kResCtas = 8;       // cuda_cic.RESIDENT_EXPLICIT_CLUSTER
constexpr int kResThreads = 512;  // cuda_cic.RESIDENT_EXPLICIT_THREADS
constexpr int kResWarps = kResThreads / 32;
constexpr int kResPerCta = 4096;  // 32768 / 8: the most rows a CTA owns
constexpr int kResMaxNg = 1024;   // cuda_cic.RESIDENT_MAX_NG
constexpr int kResCols = 32;      // deposit columns a node: one a lane

__device__ __forceinline__ double warp_sum(double x) {
  // lane 0 gets the warp's sum, a fixed tree over the lanes
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ unsigned smem_u32(const void* ptr) {
  return (unsigned)__cvta_generic_to_shared(ptr);
}

// the address of the same shared-memory word in CTA `rank` of the cluster
__device__ __forceinline__ unsigned cluster_addr(unsigned addr, int rank) {
  unsigned out;
  asm("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void st_async(unsigned addr, float x, unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];"
      :: "r"(addr), "r"(__float_as_uint(x)), "r"(bar) : "memory");
}

__device__ __forceinline__ void st_async(unsigned addr, double x, unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b64 [%0], %1, [%2];"
      :: "r"(addr), "l"(__double_as_longlong(x)), "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(unsigned bar, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Waits for the phase of parity `parity` to complete. A push that never
// arrives fails the launch after 60 s instead of hanging the card. A
// whole 2,000-step launch takes ~6.5 ms (H100), so only a lost push, not
// a time slice, preemption or debugger stalling a correct launch, runs
// this long (%globaltimer counts on through those).
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  if (mbar_try_wait(bar, parity)) return;
  const unsigned long long t0 = global_ns();
  while (!mbar_try_wait(bar, parity))
    if (global_ns() - t0 > 60000000000ull) __trap();
}

// Rank 0's last warp: row s's ke and jb from every warp's partials (in
// buffer s % 3) and, for s + 1 < steps, row s + 1's fe from the warps'
// sums of e^2 of the field solved in step s (fep), each in a fixed order.
__device__ __forceinline__ void write_rows(const double* part, const double* fep,
                                           int s, int steps, float* fe_row,
                                           float* ke_row, float* jb_row,
                                           double fe_c, double ke_c,
                                           double jb_c) {
  const int lane = threadIdx.x & 31;
  const double* pb = part + (s % 3) * kResCtas * kResWarps * 2;
  double ke = 0.0, jb = 0.0;
  for (int q = lane; q < kResCtas * kResWarps; q += 32) {
    ke += pb[2 * q];
    jb += pb[2 * q + 1];
  }
  ke = warp_sum(ke);
  jb = warp_sum(jb);
  if (lane == 0) {
    ke_row[s] = (float)(ke_c * ke);
    jb_row[s] = (float)(jb_c * jb);
    if (s + 1 < steps) {
      double fe = 0.0;
      for (int q = 0; q < kResWarps; ++q) fe += fep[q];
      fe_row[s + 1] = (float)(fe_c * fe);
    }
  }
}

__global__ void __cluster_dims__(kResCtas, 1, 1) __launch_bounds__(kResThreads, 1)
explicit_resident_kernel(const float* __restrict__ e0,
                         const float* __restrict__ p_in,
                         const float* __restrict__ v_in,
                         float* __restrict__ p_out, float* __restrict__ v_out,
                         float* __restrict__ rho_out, float* __restrict__ e_out,
                         float* __restrict__ fe_row, float* __restrict__ ke_row,
                         float* __restrict__ jb_row, int n, int per_cta, int ng,
                         int steps, float qmh, float dt_dx, float w,
                         float inv_ng, double c_solve, double fe_c, double ke_c,
                         double jb_c) {
  constexpr int kThreads = kResThreads, kWarps = kResWarps;
  constexpr int kSlots = kResPerCta / kThreads;
  constexpr int kNodes = kResMaxNg / kThreads;  // the most nodes a thread owns
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  extern __shared__ double smem_d[];
  double* part = smem_d;          // [step % 3][rank][warp][ke, jb]: rank 0's
  double* tot = part + 6 * kResCtas * kWarps;  // [warp]: its nodes' sum(rho)
  double* wts = tot + kWarps;     // [warp]: sum(rho_i (ng - i))
  double* fep = wts + kWarps;     // [warp]: sum(e^2), rank 0's
  unsigned long long* bars = (unsigned long long*)(fep + kWarps);
  float* hist = (float*)(bars + 2);        // [node][column]: the deposit
  float* recv = hist + kResCols * ng;      // [step parity][rank][node]
  float* s_e = recv + 2 * kResCtas * ng;   // the step's field

  // the particles, in registers for the whole launch: slot j of thread t
  // holds row begin + j kThreads + t iff j kThreads < lim
  const int begin = rank * per_cta;
  const int lim = min(begin + per_cta, n) - begin - t;
  float P[kSlots], V[kSlots];
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    P[j] = 0.0f;
    V[j] = 0.0f;
    if (j * kThreads < lim) {
      P[j] = p_in[begin + j * kThreads + t];
      V[j] = v_in[begin + j * kThreads + t];
    }
  }
  // thread t owns nodes [lo, lo + kNodes) below ng: contiguous runs, so
  // the prefix sums are a run, a warp scan and the warps' totals
  const int lo = t * ((ng + kThreads - 1) / kThreads);
  const int hi = min(lo + (ng + kThreads - 1) / kThreads, ng);
  for (int i = t; i < ng; i += kThreads) s_e[i] = e0[i];
  for (int i = t; i < kResCols * ng; i += kThreads) hist[i] = 0.0f;
  const double inv_ngd = 1.0 / ng;
  // a step's bytes into this CTA: 8 x ng totals, and at rank 0 the
  // partials of every warp of the cluster
  const unsigned bytes = kResCtas * ng * 4 + (rank == 0 ? kResCtas * kWarps * 16 : 0);
  if (t == 0) {
    for (int b = 0; b < 2; ++b) {
      mbar_init(smem_u32(bars + b), 1);
      mbar_expect(smem_u32(bars + b), bytes);  // steps 0 and 1
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (rank == 0 && warp == 0) {
    double fe = 0.0;
    for (int i = lane; i < ng; i += 32) fe += (double)e0[i] * (double)e0[i];
    fe = warp_sum(fe);
    if (lane == 0) fe_row[0] = (float)(fe_c * fe);
  }
  const float ngf = (float)ng;
  cluster.sync();  // every CTA's shared memory and mbarriers are live

  for (int s = 0; s < steps; ++s) {
    const int b = s & 1;
    double ke = 0.0, jb = 0.0;
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      if (j * kThreads < lim) {
        const float v = V[j];
        ke += (double)v * (double)v;  // pre-push, as the step's metrics
        jb += (double)v;
        const float e = gather(s_e, cic_periodic(P[j], ng));
        leapfrog(P[j], v, e, qmh, dt_dx, ngf, inv_ng, P[j], V[j]);
        const Cic c = cic_periodic(P[j], ng);
        atomicAdd(&hist[c.l * kResCols + lane], __fmul_rn(w, c.wl));
        atomicAdd(&hist[c.r * kResCols + lane], __fmul_rn(w, c.wr));
      }
    }
    ke = warp_sum(ke);
    jb = warp_sum(jb);
    if (lane == 0) {
      double* to = part + (((s % 3) * kResCtas + rank) * kWarps + warp) * 2;
      const unsigned bar0 = cluster_addr(smem_u32(bars + b), 0);
      st_async(cluster_addr(smem_u32(to), 0), ke, bar0);
      st_async(cluster_addr(smem_u32(to + 1), 0), jb, bar0);
    }
    __syncthreads();  // (B0) this CTA's deposit is complete

    for (int i = lo; i < hi; ++i) {
      // node i's columns in the order (lane + k) mod 32 (a warp's reads
      // fall on 32 banks), zeroed, and the total pushed to every CTA
      float* hc = hist + i * kResCols;
      float x = 0.0f;
      for (int k = 0; k < kResCols; ++k) x = __fadd_rn(x, hc[(lane + k) & (kResCols - 1)]);
      for (int k = 0; k < kResCols; ++k) hc[(lane + k) & (kResCols - 1)] = 0.0f;
      float* slot = recv + (b * kResCtas + rank) * ng + i;
#pragma unroll
      for (int q = 0; q < kResCtas; ++q)
        st_async(cluster_addr(smem_u32(slot), q), x,
                 cluster_addr(smem_u32(bars + b), q));
    }
    // rank 0's last warp, off the chain while the others push: the rows of
    // step s - 1 (its partials arrived before this CTA's last wait)
    if (rank == 0 && warp == kWarps - 1 && s > 0)
      write_rows(part, fep, s - 1, steps, fe_row, ke_row, jb_row, fe_c, ke_c,
                 jb_c);
    // the step's 8 x ng totals (and rank 0's partials) are here
    mbar_wait(smem_u32(bars + b), (unsigned)(s >> 1) & 1u);
    // the next phase of this mbarrier is step s + 2's; no push of step
    // s + 2 can come before this CTA's push of step s + 1
    if (t == 0 && s + 2 < steps) mbar_expect(smem_u32(bars + b), bytes);

    // The field of rho in the direct form of field_from_rho: with P the
    // prefix sum of rho and m its mean, T_i = P_i - (i + 1) m,
    // mean(T) = sum_k rho_k (ng - k) / ng - m (ng + 1) / 2, d = T - mean(T)
    // and d_{i-1} = d_i - (rho_i - m) (also at i = 0: d_{-1} = d_{ng-1}),
    //   e_i = dx / (2 eps0) (d_i + d_{i-1}),
    // a function of P_i and rho_i alone. Float64; every CTA holds the same
    // rho (the 8 totals in rank order) and sums in the same order.
    float r[kNodes];
    double a = 0.0, wt = 0.0;
#pragma unroll
    for (int k = 0; k < kNodes; ++k) {
      r[k] = 0.0f;
      if (lo + k < hi) {
        const float* rv = recv + b * kResCtas * ng + lo + k;
#pragma unroll
        for (int q = 0; q < kResCtas; ++q) r[k] = __fadd_rn(r[k], rv[q * ng]);
        a += (double)r[k];
        wt += (double)r[k] * (double)(ng - lo - k);
      }
    }
    double inc = a;  // inclusive scan of the warp's runs
    for (int o = 1; o < 32; o <<= 1) {
      const double y = __shfl_up_sync(0xffffffffu, inc, o);
      if (lane >= o) inc += y;
    }
    wt = warp_sum(wt);
    if (lane == 31) tot[warp] = inc;
    if (lane == 0) wts[warp] = wt;
    __syncthreads();  // (B1) the warps' sums are in shared memory
    double base = 0.0, total = 0.0, wtot = 0.0;
    for (int q = 0; q < kWarps; ++q) {
      if (q == warp) base = total;
      total += tot[q];
      wtot += wts[q];
    }
    const double mean = total * inv_ngd;
    const double mean_t = wtot * inv_ngd - mean * (0.5 * (double)(ng + 1));
    double run = base + (inc - a), fe = 0.0;
#pragma unroll
    for (int k = 0; k < kNodes; ++k) {
      if (lo + k < hi) {
        const double rk = (double)r[k];
        run += rk;
        const double d = (run - (double)(lo + k + 1) * mean) - mean_t;
        const float e = (float)(c_solve * (d + (d - (rk - mean))));
        s_e[lo + k] = e;
        fe += (double)e * (double)e;
        if (rank == 0 && s + 1 == steps) rho_out[lo + k] = r[k];
      }
    }
    if (rank == 0) {
      // (read by the last warp between the next B0 and B1)
      fe = warp_sum(fe);
      if (lane == 0) fep[warp] = fe;
    }
    __syncthreads();  // (B2) the next step's field is complete
  }
  cluster.sync();  // no CTA exits while another may still write into it

#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    if (j * kThreads < lim) {
      p_out[begin + j * kThreads + t] = P[j];
      v_out[begin + j * kThreads + t] = V[j];
    }
  }
  if (rank == 0) {
    if (warp == kWarps - 1)
      write_rows(part, fep, steps - 1, steps, fe_row, ke_row, jb_row, fe_c,
                 ke_c, jb_c);
    for (int i = t; i < ng; i += kThreads) e_out[i] = s_e[i];
  }
}

// the shared memory of a launch (cuda_cic.explicit_resident_shape's smem)
constexpr size_t resident_smem(int ng) {
  return (size_t)(6 * kResCtas + 3) * kResWarps * sizeof(double) +
         2 * sizeof(unsigned long long) +
         ((size_t)kResCols + 2 * kResCtas + 1) * ng * sizeof(float);
}
static_assert(resident_smem(kResMaxNg) <= 232448, "a block's shared memory");

}  // namespace

extern "C" {

// mode: ops/cuda_cic.py smem_mode (0 shared, 1 global).
int pypic_gather(const float* field, const float* p, float* out, long long n,
                 int ng, int periodic, int mode, int blocks, int threads,
                 void* stream) {
  return (int)launch_gather(field, p, out, n, ng, periodic, mode, blocks, threads,
                            (cudaStream_t)stream);
}

// The double gather (a float64 state): mode 0 shared, 1 global.
int pypic_gather_f64(const double* field, const double* p, double* out, long long n,
                     int ng, int periodic, int mode, int blocks, int threads,
                     void* stream) {
  return (int)launch_gather(field, p, out, n, ng, periodic, mode, blocks, threads,
                            (cudaStream_t)stream);
}

// mode: ops/cuda_cic.py cluster_launch (0 shared, 1 global, 2 cluster,
// 3 pair; cluster: the CTAs a cluster in mode 2, else unread); rho: ng
// zeroed elements, in mode 3 3 ng (2 ng zeroed: the pair array, then the
// sum the fold writes).
int pypic_leapfrog_deposit(const float* field, const float* p, const float* v,
                           float* p1, float* v1, float* rho, long long n, int ng,
                           float qmh, float dt_dx, float w, float inv_ng,
                           int mode, int blocks, int threads, int cluster, void* stream) {
  return (int)launch_leapfrog_deposit(field, p, v, p1, v1, rho, n, ng, qmh, dt_dx, w,
                                      inv_ng, mode, blocks, threads, cluster,
                                      (cudaStream_t)stream);
}

// The double sweep (a float64 state): mode 0 shared, 1 global, 2 cluster.
int pypic_leapfrog_deposit_f64(const double* field, const double* p, const double* v,
                               double* p1, double* v1, double* rho, long long n, int ng,
                               double qmh, double dt_dx, double w, double inv_ng,
                               int mode, int blocks, int threads, int cluster,
                               void* stream) {
  return (int)launch_leapfrog_deposit(field, p, v, p1, v1, rho, n, ng, qmh, dt_dx, w,
                                      inv_ng, mode, blocks, threads, cluster,
                                      (cudaStream_t)stream);
}

// The clusters the card holds at once of the sweep's kCluster launch at ng
// nodes (f64: the double kernel), `cluster` CTAs of `threads` a cluster: 0
// means it cannot launch one.
int pypic_leapfrog_deposit_clusters(int f64, int ng, int cluster, int threads,
                                    int* count) {
  if (cluster < 1) return (int)cudaErrorInvalidValue;
  const size_t slice = (size_t)((ng + cluster - 1) / cluster);
  return (int)(f64 ? max_clusters(leapfrog_deposit_kernel<kCluster, double>,
                                  slice * sizeof(double), cluster, threads, count)
                   : max_clusters(leapfrog_deposit_kernel<kCluster, float>,
                                  slice * sizeof(float), cluster, threads, count));
}

// rho: ng + 1 zeroed elements; the last one holds the epilogue's block
// counter. threads: a multiple of 32.
int pypic_explicit_cycle(const float* field, const float* p, const float* v,
                         float* p1, float* v1, float* rho, float* e1,
                         long long n, int ng, float qmh, float dt_dx, float w,
                         float inv_ng, double c_solve, int blocks, int threads,
                         void* stream) {
  return (int)launch_explicit_cycle(field, p, v, p1, v1, rho, e1, n, ng, qmh, dt_dx, w,
                                    inv_ng, c_solve, blocks, threads,
                                    (cudaStream_t)stream);
}

// The double cycle (a float64 state); rho: ng + 1 zeroed doubles.
int pypic_explicit_cycle_f64(const double* field, const double* p, const double* v,
                             double* p1, double* v1, double* rho, double* e1,
                             long long n, int ng, double qmh, double dt_dx, double w,
                             double inv_ng, double c_solve, int blocks, int threads,
                             void* stream) {
  return (int)launch_explicit_cycle(field, p, v, p1, v1, rho, e1, n, ng, qmh, dt_dx, w,
                                    inv_ng, c_solve, blocks, threads,
                                    (cudaStream_t)stream);
}

// per_cta: the rows a CTA owns, ceil(n / 8) (at most 4096); 2 <= ng <=
// 1024; steps >= 1.
int pypic_explicit_resident(const float* e0, const float* p, const float* v,
                            float* p1, float* v1, float* rho, float* e1,
                            float* fe, float* ke, float* jb, int n, int per_cta,
                            int ng, int steps, float qmh, float dt_dx, float w,
                            float inv_ng, double c_solve, double fe_c,
                            double ke_c, double jb_c, void* stream) {
  if (ng < 2 || ng > kResMaxNg || per_cta < 0 || per_cta > kResPerCta ||
      (long long)per_cta * kResCtas < n || steps < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = resident_smem(ng);
  cudaError_t err = allow_smem(explicit_resident_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  explicit_resident_kernel<<<kResCtas, kResThreads, smem, (cudaStream_t)stream>>>(
      e0, p, v, p1, v1, rho, e1, fe, ke, jb, n, per_cta, ng, steps, qmh, dt_dx,
      w, inv_ng, c_solve, fe_c, ke_c, jb_c);
  return (int)cudaGetLastError();
}

// the shared memory a launch at ng takes, for the tests
long long pypic_explicit_resident_smem(int ng) { return (long long)resident_smem(ng); }

}  // extern "C"
