// Particle kernels of the magnetized Boltzmann-electron engine, for Hopper
// (sm_90a).
//
// Two kernels, each the counterpart of a Pallas TPU kernel in
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
    const float cst = c_in[i];
    float pc = fminf(fmaxf(p, 0.0f), hi);
    if (SWAP) {
      pc = __fsub_rn(__fadd_rn(__fmul_rn(2.0f, floorf(pc)), 1.0f), pc);
      pc = fminf(fmaxf(pc, 0.0f), hi);
    }
    const float ex = gather(s_field, cic_bounded(pc, ng));
    const float kick = __fmul_rn(cst, ex);
    float vx = __fadd_rn(vx0, kick);
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
    const float vy = __fadd_rn(vy0, __fsub_rn(__fmul_rn(vfz, sx), __fmul_rn(vfx, sz)));
    const float vz = __fadd_rn(vz0, __fsub_rn(__fmul_rn(vfx, sy), __fmul_rn(vfy, sx)));
    vx = __fadd_rn(vx, kick);
    p_out[i] = __fadd_rn(p, __fmul_rn(vx, dt_dx));
    vx_out[i] = vx;
    vy_out[i] = vy;
    vz_out[i] = vz;
  }
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

}  // extern "C"
