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
// with qmh = q/m dt/2 and dt_dx computed on the host in float32, in the
// Pallas wrappers' order. __fmul_rn / __fadd_rn keep nvcc from fusing.
//
// Launchers return cudaGetLastError(); they allocate nothing and run on
// the stream they are given.

#include <cooperative_groups.h>

#include "cic_common.cuh"

namespace cg = cooperative_groups;

namespace {

// Kick-drift-kick with one gathered field value, then the periodic wrap.
__device__ __forceinline__ void leapfrog(float p, float v, float e, float qmh,
                                         float dt_dx, float ngf, float inv_ng,
                                         float& p1, float& v1) {
  const float kick = __fmul_rn(qmh, e);
  const float vh = __fadd_rn(v, kick);
  p1 = wrap(__fadd_rn(p, __fmul_rn(vh, dt_dx)), ngf, inv_ng);
  v1 = __fadd_rn(vh, kick);
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
// Float64 throughout, e rounded to float32 once. `c` = dx / (2 eps0),
// `scr` ng doubles and `red` 32 doubles of shared memory. Every thread of
// the block calls it; it ends with a __syncthreads().
__device__ void field_from_rho(const float* rho, float* e_out, int ng, double c,
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
    e_out[i] = (float)(c * (d + dm));
  }
  __syncthreads();
}

// The sweep of the two per-step leapfrog kernels: gather e at p from the
// block's copy of the field, push, wrap, store (p1, v1), deposit w at p1
// into the block's histogram.
__device__ __forceinline__ void leapfrog_deposit_sweep(
    const float* s_field, float* s_hist, const float* __restrict__ p,
    const float* __restrict__ v, float* __restrict__ p1_out,
    float* __restrict__ v1_out, long long n, int ng, float qmh, float dt_dx,
    float w, float inv_ng) {
  const float ngf = (float)ng;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float a = p[i];
    const float e = gather(s_field, cic_periodic(a, ng));
    float p1, v1;
    leapfrog(a, v[i], e, qmh, dt_dx, ngf, inv_ng, p1, v1);
    p1_out[i] = p1;
    v1_out[i] = v1;
    const Cic c = cic_periodic(p1, ng);
    atomicAdd(&s_hist[c.l], __fmul_rn(w, c.wl));
    atomicAdd(&s_hist[c.r], __fmul_rn(w, c.wr));
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
// ---------------------------------------------------------------------------
template <bool PERIODIC>
__global__ void gather_kernel(const float* __restrict__ field,
                              const float* __restrict__ p,
                              float* __restrict__ out, long long n, int ng) {
  extern __shared__ float s_field[];
  for (int i = threadIdx.x; i < ng; i += blockDim.x) s_field[i] = field[i];
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float a = p[i];
    out[i] = gather(s_field, PERIODIC ? cic_periodic(a, ng) : cic_bounded(a, ng));
  }
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
// ---------------------------------------------------------------------------
__global__ void leapfrog_deposit_kernel(
    const float* __restrict__ field, const float* __restrict__ p,
    const float* __restrict__ v, float* __restrict__ p1,
    float* __restrict__ v1, float* __restrict__ rho, long long n, int ng,
    float qmh, float dt_dx, float w, float inv_ng) {
  extern __shared__ float smem[];
  float* s_field = smem;
  float* s_hist = smem + ng;
  for (int i = threadIdx.x; i < ng; i += blockDim.x) {
    s_field[i] = field[i];
    s_hist[i] = 0.0f;
  }
  __syncthreads();
  leapfrog_deposit_sweep(s_field, s_hist, p, v, p1, v1, n, ng, qmh, dt_dx, w,
                         inv_ng);
  __syncthreads();
  for (int i = threadIdx.x; i < ng; i += blockDim.x) atomicAdd(&rho[i], s_hist[i]);
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
// threads). The counter is the float after rho's ng nodes in the same
// zeroed allocation, so every launch starts from 0 and no reset is needed.
// ---------------------------------------------------------------------------
__global__ void explicit_cycle_kernel(
    const float* __restrict__ field, const float* __restrict__ p,
    const float* __restrict__ v, float* __restrict__ p1,
    float* __restrict__ v1, float* rho, float* __restrict__ e1, long long n,
    int ng, float qmh, float dt_dx, float w, float inv_ng, double c_solve) {
  extern __shared__ double smem_d[];
  double* scr = smem_d;                            // ng
  double* red = smem_d + ng;                       // 32
  float* s_field = (float*)(smem_d + ng + 32);     // ng
  float* s_hist = s_field + ng;                    // ng
  __shared__ unsigned int s_ticket;
  unsigned int* counter = reinterpret_cast<unsigned int*>(rho + ng);

  for (int i = threadIdx.x; i < ng; i += blockDim.x) {
    s_field[i] = field[i];
    s_hist[i] = 0.0f;
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

// ---------------------------------------------------------------------------
// explicit_cycle_resident
//
// Replaces pypic_tpu/ops/pallas_cic.py:_explicit_resident_kernel
// (explicit_cycle_resident_pallas): `steps` explicit cycles in one launch,
// with the per-step pre-push metric rows fe = sum(e^2), ke = sum(v^2),
// jb = sum(v) (times their constants), for n <= 32768 and ng <= 1024.
//
// Bound on the H100: latency, not bytes or operations. The particles
// cross device memory once per launch; each step is a chain of block and
// cluster barriers. The population (32768 x 8 B = 256 KB) does not fit one
// block's 227 KB, so the kernel is ONE thread-block cluster of 8 CTAs of
// 1024 threads, each thread holding up to 4 particles in registers for the
// whole launch. Each step: every CTA gathers from its own copy of E,
// pushes, and deposits into its own histogram; cluster.sync(); every CTA
// sums the 8 histograms through distributed shared memory in rank order
// (so all CTAs hold the same rho, bit for bit) and solves it redundantly
// (field_from_rho), so E never leaves shared memory. The histograms and
// the metric partials alternate between two buffers by step parity, which
// makes one cluster barrier per step enough: a buffer is zeroed again only
// after the next barrier, when every CTA has finished reading it.
// ---------------------------------------------------------------------------
constexpr int kResCtas = 8;
constexpr int kResThreads = 1024;
constexpr int kResPerThread = 4;  // 8 x 1024 x 4 = 32768 particles

__global__ void __cluster_dims__(kResCtas, 1, 1) __launch_bounds__(kResThreads, 1)
explicit_resident_kernel(const float* __restrict__ e0,
                         const float* __restrict__ p_in,
                         const float* __restrict__ v_in,
                         float* __restrict__ p_out, float* __restrict__ v_out,
                         float* __restrict__ rho_out, float* __restrict__ e_out,
                         float* __restrict__ fe_row, float* __restrict__ ke_row,
                         float* __restrict__ jb_row, int n, int ng, int steps,
                         float qmh, float dt_dx, float w, float inv_ng,
                         double c_solve, double fe_c, double ke_c, double jb_c) {
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned int rank = cluster.block_rank();
  const int t = threadIdx.x;
  extern __shared__ double smem_d[];
  double* scr = smem_d;                 // ng
  double* red = scr + ng;               // 32
  double* part = red + 32;              // [2 parities][ke, jb]
  float* s_e = (float*)(part + 4);      // ng: this step's field
  float* s_rho = s_e + ng;              // ng: the cluster's summed rho
  float* s_hist = s_rho + ng;           // [2 parities][ng]: this CTA's deposit

  const int per_cta = (n + kResCtas - 1) / kResCtas;
  const int begin = (int)rank * per_cta;
  const int end = min(begin + per_cta, n);
  float p[kResPerThread], v[kResPerThread];
#pragma unroll
  for (int k = 0; k < kResPerThread; ++k) {
    const int i = begin + t + k * kResThreads;
    p[k] = i < end ? p_in[i] : 0.0f;
    v[k] = i < end ? v_in[i] : 0.0f;
  }
  for (int i = t; i < ng; i += kResThreads) {
    s_e[i] = e0[i];
    s_hist[i] = 0.0f;
    s_hist[ng + i] = 0.0f;
  }
  const float ngf = (float)ng;
  cluster.sync();  // every CTA's shared memory is live before remote reads

  for (int s = 0; s < steps; ++s) {
    const int b = s & 1;
    float* hist = s_hist + b * ng;
    double ke = 0.0, jb = 0.0;
#pragma unroll
    for (int k = 0; k < kResPerThread; ++k) {
      if (begin + t + k * kResThreads >= end) continue;
      ke += (double)v[k] * (double)v[k];  // pre-push, as the step's metrics
      jb += (double)v[k];
      const float e = gather(s_e, cic_periodic(p[k], ng));
      leapfrog(p[k], v[k], e, qmh, dt_dx, ngf, inv_ng, p[k], v[k]);
      const Cic c = cic_periodic(p[k], ng);
      atomicAdd(&hist[c.l], __fmul_rn(w, c.wl));
      atomicAdd(&hist[c.r], __fmul_rn(w, c.wr));
    }
    ke = block_sum(ke, red);
    jb = block_sum(jb, red);
    double fe = 0.0;
    for (int i = t; i < ng; i += kResThreads) fe += (double)s_e[i] * (double)s_e[i];
    fe = block_sum(fe, red);
    if (t == 0) {
      part[2 * b] = ke;
      part[2 * b + 1] = jb;
    }
    cluster.sync();  // hist[b] and part[b] are complete in every CTA

    for (int i = t; i < ng; i += kResThreads) {
      float r = 0.0f;
#pragma unroll
      for (int q = 0; q < kResCtas; ++q) r += cluster.map_shared_rank(hist, q)[i];
      s_rho[i] = r;
    }
    if (rank == 0 && t == 0) {
      double k_sum = 0.0, j_sum = 0.0;
      for (int q = 0; q < kResCtas; ++q) {
        const double* rp = cluster.map_shared_rank(part, q);
        k_sum += rp[2 * b];
        j_sum += rp[2 * b + 1];
      }
      fe_row[s] = (float)(fe_c * fe);
      ke_row[s] = (float)(ke_c * k_sum);
      jb_row[s] = (float)(jb_c * j_sum);
    }
    // the other parity's histogram was last read remotely in step s - 1,
    // before every CTA reached this step's barrier
    float* next = s_hist + (1 - b) * ng;
    for (int i = t; i < ng; i += kResThreads) next[i] = 0.0f;
    __syncthreads();
    field_from_rho(s_rho, s_e, ng, c_solve, scr, red);
  }
  cluster.sync();  // no CTA exits while another may still read its memory

#pragma unroll
  for (int k = 0; k < kResPerThread; ++k) {
    const int i = begin + t + k * kResThreads;
    if (i < end) {
      p_out[i] = p[k];
      v_out[i] = v[k];
    }
  }
  if (rank == 0) {
    for (int i = t; i < ng; i += kResThreads) {
      rho_out[i] = s_rho[i];
      e_out[i] = s_e[i];
    }
  }
}

}  // namespace

extern "C" {

int pypic_gather(const float* field, const float* p, float* out, long long n,
                 int ng, int periodic, int blocks, int threads, void* stream) {
  const size_t smem = (size_t)ng * sizeof(float);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (periodic) {
    err = allow_smem(gather_kernel<true>, smem);
    if (err != cudaSuccess) return (int)err;
    gather_kernel<true><<<blocks, threads, smem, s>>>(field, p, out, n, ng);
  } else {
    err = allow_smem(gather_kernel<false>, smem);
    if (err != cudaSuccess) return (int)err;
    gather_kernel<false><<<blocks, threads, smem, s>>>(field, p, out, n, ng);
  }
  return (int)cudaGetLastError();
}

int pypic_leapfrog_deposit(const float* field, const float* p, const float* v,
                           float* p1, float* v1, float* rho, long long n, int ng,
                           float qmh, float dt_dx, float w, float inv_ng,
                           int blocks, int threads, void* stream) {
  const size_t smem = 2 * (size_t)ng * sizeof(float);
  cudaError_t err = allow_smem(leapfrog_deposit_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  leapfrog_deposit_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      field, p, v, p1, v1, rho, n, ng, qmh, dt_dx, w, inv_ng);
  return (int)cudaGetLastError();
}

// rho: ng + 1 zeroed floats; the last one is the epilogue's block counter.
// threads: a multiple of 32.
int pypic_explicit_cycle(const float* field, const float* p, const float* v,
                         float* p1, float* v1, float* rho, float* e1,
                         long long n, int ng, float qmh, float dt_dx, float w,
                         float inv_ng, double c_solve, int blocks, int threads,
                         void* stream) {
  const size_t smem = (size_t)(ng + 32) * sizeof(double) + 2 * (size_t)ng * sizeof(float);
  cudaError_t err = allow_smem(explicit_cycle_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  explicit_cycle_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      field, p, v, p1, v1, rho, e1, n, ng, qmh, dt_dx, w, inv_ng, c_solve);
  return (int)cudaGetLastError();
}

int pypic_explicit_resident(const float* e0, const float* p, const float* v,
                            float* p1, float* v1, float* rho, float* e1,
                            float* fe, float* ke, float* jb, int n, int ng,
                            int steps, float qmh, float dt_dx, float w,
                            float inv_ng, double c_solve, double fe_c,
                            double ke_c, double jb_c, void* stream) {
  const size_t smem = (size_t)(ng + 32 + 4) * sizeof(double) + 4 * (size_t)ng * sizeof(float);
  cudaError_t err = allow_smem(explicit_resident_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  explicit_resident_kernel<<<kResCtas, kResThreads, smem, (cudaStream_t)stream>>>(
      e0, p, v, p1, v1, rho, e1, fe, ke, jb, n, ng, steps, qmh, dt_dx, w, inv_ng,
      c_solve, fe_c, ke_c, jb_c);
  return (int)cudaGetLastError();
}

}  // extern "C"
