// Particle kernels of the magnetized Boltzmann-electron engine, for Hopper
// (sm_90a).
//
// Three kernels, each the counterpart of a Pallas TPU kernel in
// pypic_tpu/ops/pallas_cic.py, with plain CIC index arithmetic
// (cic_common.cuh) in place of the TPU kernels' tent windows and one-hot
// contractions. One thread per particle in a grid-stride loop, any n; the
// (ng,) arrays a block reads or accumulates live in dynamic shared memory.
// Every product and sum is written with __fmul_rn / __fadd_rn /
// __fsub_rn / __fdiv_rn, so nvcc contracts nothing into an FMA and each
// operation rounds as the plain PyTorch version's does. A launcher
// returns cudaGetLastError(); it allocates nothing and runs on the stream
// it is given.

#include "cic_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// deposit2
//
// Replaces pypic_tpu/ops/pallas_cic.py:_deposit2_kernel (deposit2_pallas):
// two CIC deposits sharing one particle sweep and one index/weight
// computation, the rho and number-density pair of the Boltzmann weighting
// (pygcpic.py:841-905). Bounded or periodic, as deposit_kernel.
//
// Positions outside the grid: the magnetized engine keeps wall-lost slots
// at p < 0 or p > ng - 1 with weight 0. cic_bounded clamps the left index
// into [0, ng - 2] before the weights are taken (ops/cic.py
// cic_indices_weights), so such a particle adds a zero at nodes inside
// the histogram and never addresses outside it.
//
// Bound on the H100: device-memory bytes, 12 B read per particle (p, va,
// vb). Each block keeps two (ng,) histograms in shared memory (4.7 KB at
// ng = 600) and flushes them with one global atomic per node and array.
// ---------------------------------------------------------------------------
template <bool PERIODIC>
__global__ void deposit2_kernel(const float* __restrict__ p,
                                const float* __restrict__ va,
                                const float* __restrict__ vb,
                                float* __restrict__ out_a,
                                float* __restrict__ out_b, long long n,
                                int ng) {
  extern __shared__ float smem[];
  float* s_a = smem;
  float* s_b = smem + ng;
  for (int i = threadIdx.x; i < ng; i += blockDim.x) {
    s_a[i] = 0.0f;
    s_b[i] = 0.0f;
  }
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const Cic c = PERIODIC ? cic_periodic(p[i], ng) : cic_bounded(p[i], ng);
    const float a = va[i];
    const float b = vb[i];
    atomicAdd(&s_a[c.l], __fmul_rn(a, c.wl));
    atomicAdd(&s_a[c.r], __fmul_rn(a, c.wr));
    atomicAdd(&s_b[c.l], __fmul_rn(b, c.wl));
    atomicAdd(&s_b[c.r], __fmul_rn(b, c.wr));
  }
  __syncthreads();
  for (int i = threadIdx.x; i < ng; i += blockDim.x) {
    atomicAdd(&out_a[i], s_a[i]);
    atomicAdd(&out_b[i], s_b[i]);
  }
}

// The gather position: pc = clip(p, 0, ng - 1); with SWAP (the reference's
// swapped intra-cell weights, pygcpic.py:343-347) the cell-mirrored
// clip(2 floor(pc) + 1 - pc, 0, ng - 1), in that operation order.
template <bool SWAP>
__device__ __forceinline__ float gather_position(float p, float hi) {
  float pc = fminf(fmaxf(p, 0.0f), hi);
  if (SWAP) {
    pc = __fsub_rn(__fadd_rn(__fmul_rn(2.0f, floorf(pc)), 1.0f), pc);
    pc = fminf(fmaxf(pc, 0.0f), hi);
  }
  return pc;
}

// The Boris-Buneman velocity update in a constant B (pygcpic.py:460-507)
// in the TPU kernel's order: the half kick cst ex, the rotation with
// t = cst b, inv = 2 / (1 + t^2), s = t inv, the second half kick.
__device__ __forceinline__ void boris_rotate(float ex, float cst, float vx0,
                                             float vy0, float vz0, float bx,
                                             float by, float bz, float& vx,
                                             float& vy, float& vz) {
  const float kick = __fmul_rn(cst, ex);
  vx = __fadd_rn(vx0, kick);
  const float tx = __fmul_rn(cst, bx);
  const float ty = __fmul_rn(cst, by);
  const float tz = __fmul_rn(cst, bz);
  const float t2 = __fadd_rn(__fadd_rn(__fmul_rn(tx, tx), __fmul_rn(ty, ty)),
                             __fmul_rn(tz, tz));
  const float inv = __fdiv_rn(2.0f, __fadd_rn(1.0f, t2));
  const float sx = __fmul_rn(tx, inv);
  const float sy = __fmul_rn(ty, inv);
  const float sz = __fmul_rn(tz, inv);
  const float vfx = __fsub_rn(__fadd_rn(vx, __fmul_rn(vy0, tz)), __fmul_rn(vz0, ty));
  const float vfy = __fsub_rn(__fadd_rn(vy0, __fmul_rn(vz0, tx)), __fmul_rn(vx, tz));
  const float vfz = __fsub_rn(__fadd_rn(vz0, __fmul_rn(vx, ty)), __fmul_rn(vy0, tx));
  vx = __fadd_rn(vx, __fsub_rn(__fmul_rn(vfy, sz), __fmul_rn(vfz, sy)));
  vy = __fadd_rn(vy0, __fsub_rn(__fmul_rn(vfz, sx), __fmul_rn(vfx, sz)));
  vz = __fadd_rn(vz0, __fsub_rn(__fmul_rn(vfx, sy), __fmul_rn(vfy, sx)));
  vx = __fadd_rn(vx, kick);
}

// ---------------------------------------------------------------------------
// boris_gather_push
//
// Replaces pypic_tpu/ops/pallas_cic.py:_boris_kernel
// (boris_gather_push_pallas): the bounded CIC gather of E_x and the
// Boris-Buneman push in a constant B (pygcpic.py:460-507), one sweep.
//
// * The gather position is pc = clip(p, 0, ng - 1); with SWAP (the
//   reference's swapped intra-cell weights, pygcpic.py:343-347,
//   gather_weights='reference') it is the cell-mirrored
//   clip(2 floor(pc) + 1 - pc, 0, ng - 1), in that operation order.
// * The rotation in the TPU kernel's order: inv = 2 / (1 + t^2),
//   s = t inv, and the drift in grid coordinates p1 = p + vx dt/dx.
// * A particle with act == 0 stores its inputs unchanged, bit for bit.
//
// Bound on the H100: device-memory bytes, 24 B read (p, vx, vy, vz,
// const, act) and 16 B written (p1, vx1, vy1, vz1) per particle; the
// field sits in shared memory. The lateral drift y + dt vy, z + dt vz stays
// outside, as in the JAX engine.
// ---------------------------------------------------------------------------
template <bool SWAP>
__global__ void boris_kernel(const float* __restrict__ field,
                             const float* __restrict__ p_in,
                             const float* __restrict__ vx_in,
                             const float* __restrict__ vy_in,
                             const float* __restrict__ vz_in,
                             const float* __restrict__ c_in,
                             const float* __restrict__ act_in,
                             float* __restrict__ p_out,
                             float* __restrict__ vx_out,
                             float* __restrict__ vy_out,
                             float* __restrict__ vz_out, long long n, int ng,
                             float bx, float by, float bz, float dt_dx) {
  extern __shared__ float s_field[];
  for (int i = threadIdx.x; i < ng; i += blockDim.x) s_field[i] = field[i];
  __syncthreads();
  const float hi = (float)(ng - 1);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float p = p_in[i];
    const float vx0 = vx_in[i];
    const float vy0 = vy_in[i];
    const float vz0 = vz_in[i];
    if (!(act_in[i] > 0.0f)) {
      p_out[i] = p;
      vx_out[i] = vx0;
      vy_out[i] = vy0;
      vz_out[i] = vz0;
      continue;
    }
    const float pc = gather_position<SWAP>(p, hi);
    float vx, vy, vz;
    boris_rotate(gather(s_field, cic_bounded(pc, ng)), c_in[i], vx0, vy0, vz0,
                 bx, by, bz, vx, vy, vz);
    p_out[i] = __fadd_rn(p, __fmul_rn(vx, dt_dx));
    vx_out[i] = vx;
    vy_out[i] = vy;
    vz_out[i] = vz;
  }
}


// ---------------------------------------------------------------------------
// boris_gather_push_deposit
//
// Replaces pypic_tpu/ops/pallas_cic.py:_boris_deposit_kernel
// (boris_gather_push_deposit_pallas, carried_deposit='on'): the sweep of
// boris_kernel, plus the deposit that opens the NEXT step, of wr (rho)
// and wn (number density) at the new position p1, for rows whose p1 lies
// in [0, ng - 1] (this step's wall hits deposit nothing). The weights
// arrive masked (0 in inactive slots); an inactive row keeps p1 = p and
// its velocities, bit for bit.
//
// The TPU kernel deposits through the window of its GATHER at pc (the
// mirrored position with SWAP), widened by `pad` rows a side: window k =
// clip(int(floor(pc) * (1/stride)), 0, K - 1) of _choose_window's frame
// (stride, width), rows l = 0 .. wp - 1 (wp = width + 2 pad) at nodes
// stride k - pad + l. The deposit row is
//   d_h = (pc - stride k) + (p1 - pc) + pad,
// the true p1 seen from that frame with the correct intra-cell weights.
// A d_h outside [0, wp - 1] clamps to that edge and, where wn > 0, is
// counted: the tent then lands at the window's edge node, in the grid but
// misplaced, which the count makes visible. Here the frame is kept as
// arithmetic only (it decides the clamps): the tent goes into one
// whole-grid histogram, at node stride k - pad + floor(d_h) and the next,
// with weights 1 - frac(d_h) and frac(d_h), the TPU tent's values; a node
// outside [0, ng) takes nothing, as the TPU fold drops it.
//
// Bound on the H100: device-memory bytes, 32 B read (p, vx, vy, vz,
// const, act, wr, wn) and 16 B written (p1, vx1, vy1, vz1) a particle.
// The field and both histograms live in shared memory (3 ng floats, 7.2 KB
// at ng = 600); each block flushes its histograms with one global atomic
// a node and array, and adds its clamp count with one integer atomic.
// ---------------------------------------------------------------------------
template <bool SWAP>
__global__ void boris_deposit_kernel(
    const float* __restrict__ field, const float* __restrict__ p_in,
    const float* __restrict__ vx_in, const float* __restrict__ vy_in,
    const float* __restrict__ vz_in, const float* __restrict__ c_in,
    const float* __restrict__ act_in, const float* __restrict__ wr_in,
    const float* __restrict__ wn_in, float* __restrict__ p_out,
    float* __restrict__ vx_out, float* __restrict__ vy_out,
    float* __restrict__ vz_out, float* __restrict__ rho,
    float* __restrict__ dens, int* __restrict__ n_clamped, long long n, int ng,
    float bx, float by, float bz, float dt_dx, int win_stride, int num_k,
    float inv_stride, int pad, int wp) {
  extern __shared__ float smem[];
  float* s_field = smem;
  float* s_rho = smem + ng;
  float* s_n = smem + 2 * ng;
  __shared__ int s_clamped;
  for (int i = threadIdx.x; i < ng; i += blockDim.x) {
    s_field[i] = field[i];
    s_rho[i] = 0.0f;
    s_n[i] = 0.0f;
  }
  if (threadIdx.x == 0) s_clamped = 0;
  __syncthreads();
  const float hi = (float)(ng - 1);
  const float top = (float)(wp - 1);
  const float padf = (float)pad;
  int clamped = 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float p = p_in[i];
    const float vx0 = vx_in[i];
    const float vy0 = vy_in[i];
    const float vz0 = vz_in[i];
    const float pc = gather_position<SWAP>(p, hi);
    float p1 = p, vx = vx0, vy = vy0, vz = vz0;
    if (act_in[i] > 0.0f) {
      boris_rotate(gather(s_field, cic_bounded(pc, ng)), c_in[i], vx0, vy0,
                   vz0, bx, by, bz, vx, vy, vz);
      p1 = __fadd_rn(p, __fmul_rn(vx, dt_dx));
    }
    p_out[i] = p1;
    vx_out[i] = vx;
    vy_out[i] = vy;
    vz_out[i] = vz;
    const float wr = wr_in[i];
    const float wn = wn_in[i];
    if (!(p1 >= 0.0f && p1 <= hi) || (wr == 0.0f && wn == 0.0f)) continue;
    const int k = min(max((int)__fmul_rn(floorf(pc), inv_stride), 0), num_k - 1);
    const float d_s = __fsub_rn(pc, (float)(k * win_stride));
    float d_h = __fadd_rn(__fadd_rn(d_s, __fsub_rn(p1, pc)), padf);
    if (d_h < 0.0f || d_h > top) {
      if (wn > 0.0f) ++clamped;
      d_h = fminf(fmaxf(d_h, 0.0f), top);
    }
    const float row = floorf(d_h);
    const float fr = __fsub_rn(d_h, row);
    const float fl = __fsub_rn(1.0f, fr);
    const int l = win_stride * k - pad + (int)row;
    if (l >= 0 && l < ng) {
      atomicAdd(&s_rho[l], __fmul_rn(wr, fl));
      atomicAdd(&s_n[l], __fmul_rn(wn, fl));
    }
    if (l + 1 >= 0 && l + 1 < ng) {
      atomicAdd(&s_rho[l + 1], __fmul_rn(wr, fr));
      atomicAdd(&s_n[l + 1], __fmul_rn(wn, fr));
    }
  }
  if (clamped) atomicAdd(&s_clamped, clamped);
  __syncthreads();
  for (int i = threadIdx.x; i < ng; i += blockDim.x) {
    atomicAdd(&rho[i], s_rho[i]);
    atomicAdd(&dens[i], s_n[i]);
  }
  if (threadIdx.x == 0 && s_clamped) atomicAdd(n_clamped, s_clamped);
}

}  // namespace

extern "C" {

// out_a, out_b: ng zeroed floats each.
int pypic_deposit2(const float* p, const float* va, const float* vb,
                   float* out_a, float* out_b, long long n, int ng,
                   int periodic, int blocks, int threads, void* stream) {
  const size_t smem = 2 * (size_t)ng * sizeof(float);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (periodic) {
    err = allow_smem(deposit2_kernel<true>, smem);
    if (err != cudaSuccess) return (int)err;
    deposit2_kernel<true><<<blocks, threads, smem, s>>>(p, va, vb, out_a, out_b, n, ng);
  } else {
    err = allow_smem(deposit2_kernel<false>, smem);
    if (err != cudaSuccess) return (int)err;
    deposit2_kernel<false><<<blocks, threads, smem, s>>>(p, va, vb, out_a, out_b, n, ng);
  }
  return (int)cudaGetLastError();
}

int pypic_boris_gather_push(const float* field, const float* p,
                            const float* vx, const float* vy, const float* vz,
                            const float* c, const float* act, float* p1,
                            float* vx1, float* vy1, float* vz1, long long n,
                            int ng, float bx, float by, float bz, float dt_dx,
                            int swap, int blocks, int threads, void* stream) {
  const size_t smem = (size_t)ng * sizeof(float);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (swap) {
    err = allow_smem(boris_kernel<true>, smem);
    if (err != cudaSuccess) return (int)err;
    boris_kernel<true><<<blocks, threads, smem, s>>>(
        field, p, vx, vy, vz, c, act, p1, vx1, vy1, vz1, n, ng, bx, by, bz, dt_dx);
  } else {
    err = allow_smem(boris_kernel<false>, smem);
    if (err != cudaSuccess) return (int)err;
    boris_kernel<false><<<blocks, threads, smem, s>>>(
        field, p, vx, vy, vz, c, act, p1, vx1, vy1, vz1, n, ng, bx, by, bz, dt_dx);
  }
  return (int)cudaGetLastError();
}


// rho, dens: ng zeroed floats each; n_clamped: one zeroed int.
int pypic_boris_gather_push_deposit(
    const float* field, const float* p, const float* vx, const float* vy,
    const float* vz, const float* c, const float* act, const float* wr,
    const float* wn, float* p1, float* vx1, float* vy1, float* vz1, float* rho,
    float* dens, int* n_clamped, long long n, int ng, float bx, float by,
    float bz, float dt_dx, int swap, int win_stride, int num_k,
    float inv_stride, int pad, int blocks, int threads, void* stream) {
  const size_t smem = 3 * (size_t)ng * sizeof(float);
  const int wp = win_stride + 2 + 2 * pad;  // width = stride + 2
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
#define PYPIC_BORIS_DEP(SW)                                                    \
  err = allow_smem(boris_deposit_kernel<SW>, smem);                            \
  if (err != cudaSuccess) return (int)err;                                     \
  boris_deposit_kernel<SW><<<blocks, threads, smem, s>>>(                      \
      field, p, vx, vy, vz, c, act, wr, wn, p1, vx1, vy1, vz1, rho, dens,      \
      n_clamped, n, ng, bx, by, bz, dt_dx, win_stride, num_k, inv_stride, pad, \
      wp)
  if (swap) {
    PYPIC_BORIS_DEP(true);
  } else {
    PYPIC_BORIS_DEP(false);
  }
#undef PYPIC_BORIS_DEP
  return (int)cudaGetLastError();
}

}  // extern "C"
