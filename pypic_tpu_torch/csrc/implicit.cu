// The resident implicit CN-Picard kernel, for Hopper (sm_90a).
//
// implicit_resident replaces pypic_tpu/ops/pallas_cic.py:
// _implicit_resident_kernel (implicit_resident_pallas): `steps` full
// implicit steps in one launch, each the engine's fused step with
// finalize='converged', finalize_field='last' and separate windows:
//
//   es = e0 (+ (e0 - eprev)/2 with extrapolate)
//   while r > tol and k < maxiter:                      (Picard loop)
//     gather smooth(es) at ps; CN push; ph = wrap((p0 + p1)/2)
//     jh = deposit(w vh at ph)
//     e1 = e0 + dt/eps0 (mean(jh) - smooth(jh));  eh = (e1 + e0)/2
//     r = sum((es - eh)^2);  es = Anderson(1)(es, eh) or eh;  ps = ph
//   finalize: gather smooth(es) at ps; p1 = wrap(CN p1); v1
//   rows: fe = fe_c sum(e1^2), ke = ke_c sum(v1^2), jb = jb_c sum(v1),
//         iters k, resid r, tracer p1 and v1
//
// for n <= 131072 and ng <= 1024. The first pass gathers at ps = p0. The
// TPU kernel's baked smoothing, window-view and fold matrices are not
// carried over: smoothing is the (1, 2, 1)/4 stencil of ops/fd.py and the
// CIC arithmetic is cic_common.cuh's, rounded as the per-step kernels
// round it.
//
// Bound on the H100: latency. The particles cross device memory once per
// launch and every step is a chain of block and cluster barriers; its
// float32 operations (28 a particle a pass, 19 a particle for the finalize
// sweep and its sums) take a few ns a step at the card's peak.
//
// Design. ONE thread-block cluster of 8 CTAs x 1024 threads, as
// explicit_cycle_resident (explicit.cu). Each CTA deposits its particles
// into its own (ng,) histogram in shared memory; after a cluster.sync()
// every CTA sums the 8 histograms through distributed shared memory in
// rank order and then runs the (ng,) work of the pass (Ampere advance,
// residual, Anderson mixing) redundantly on its own copy.
//
// * The Picard exit depends on the data, and a CTA that left the loop on
//   another pass than the rest would deadlock the next cluster.sync(). So
//   every CTA must hold a bit-identical jh, r and Anderson products: the
//   histograms are summed in rank order, the (ng,) sums are block_sum's
//   fixed warp-order reductions over the same thread-to-node map, and r is
//   rounded to float32 before the test. Identical inputs, identical code,
//   identical order: every CTA takes the same branch.
// * Where the particles live. Each particle carries p0, v0 and the
//   position iterate ps (12 B): 1.5 MB at n = 131072 and 1.2 MB at
//   configs[1]'s n = 1e5. Eight CTAs have 8 x 227 KB of shared memory, less
//   the ~41 KB of (ng <= 1024) arrays each keeps, so the population does
//   not fit there, and registers hold even less (64 a thread at 1024
//   threads). The particles therefore stay in device memory, in the output
//   arrays p_out and v_out and the scratch array ps, where the 50 MB L2
//   (and each SM's L1) keeps them: each thread reads and writes only its
//   own particles, so they need no barrier beyond the thread's own order.
// * Histograms alternate between two buffers by pass parity, so one
//   cluster barrier per pass suffices (a buffer is zeroed again only after
//   the next barrier, when every CTA has finished reading it); the metric
//   partials alternate by step parity behind one more barrier per step.
//
// The launcher returns cudaGetLastError(); it allocates nothing and runs on
// the stream it is given.

#include <cooperative_groups.h>

#include "cic_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCtas = 8;
constexpr int kThreads = 1024;

// smooth_periodic of ops/fd.py at node i: (f[i+1] + 2 f[i] + f[i-1]) / 4,
// in that order; the identity without smoothing.
__device__ __forceinline__ float smooth_at(const float* f, int i, int ng,
                                           bool smooth) {
  if (!smooth) return f[i];
  const int lo = i == 0 ? ng - 1 : i - 1;
  const int hi = i + 1 == ng ? 0 : i + 1;
  return __fmul_rn(__fadd_rn(__fadd_rn(f[hi], __fmul_rn(2.0f, f[i])), f[lo]), 0.25f);
}

__global__ void __cluster_dims__(kCtas, 1, 1) __launch_bounds__(kThreads, 1)
implicit_resident_kernel(
    const float* __restrict__ e0_in, const float* __restrict__ eprev_in,
    const float* __restrict__ j_in, const float* __restrict__ p_in,
    const float* __restrict__ v_in, float* p, float* v, float* ps,
    float* __restrict__ e_out, float* __restrict__ eprev_out,
    float* __restrict__ j_out, float* __restrict__ fe_row,
    float* __restrict__ ke_row, float* __restrict__ jb_row,
    int* __restrict__ it_row, float* __restrict__ res_row,
    float* __restrict__ tx_row, float* __restrict__ tv_row, int n, int ng,
    int steps, float qm_dt, float qm_dt2_half, float dt_dx, float w,
    float inv_ng, float dt_eps, float tol, int maxiter, int extrapolate,
    int anderson, int smooth, int tracer, double fe_c, double ke_c,
    double jb_c) {
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned int rank = cluster.block_rank();
  const int t = threadIdx.x;
  extern __shared__ double smem_d[];
  double* red = smem_d;           // 32
  double* part = red + 32;        // [2 step parities][ke, jb]
  float* s_e0 = (float*)(part + 4);
  float* s_eprev = s_e0 + ng;
  float* s_es = s_eprev + ng;     // the Picard iterate
  float* s_fs = s_es + ng;        // smooth(es), then eh of the pass
  float* s_jh = s_fs + ng;
  float* s_e1 = s_jh + ng;
  float* s_g = s_e1 + ng;         // Anderson: previous map output
  float* s_f = s_g + ng;          // Anderson: previous residual
  float* s_hist = s_f + ng;       // [2 pass parities][ng]: this CTA's deposit

  const int per_cta = (n + kCtas - 1) / kCtas;
  const int begin = (int)rank * per_cta;
  const int end = min(begin + per_cta, n);
  for (int i = begin + t; i < end; i += kThreads) {
    p[i] = p_in[i];
    v[i] = v_in[i];
  }
  for (int i = t; i < ng; i += kThreads) {
    s_e0[i] = e0_in[i];
    s_eprev[i] = eprev_in[i];
    s_jh[i] = j_in[i];
    s_hist[i] = 0.0f;
    s_hist[ng + i] = 0.0f;
  }
  const float ngf = (float)ng;
  const bool sm = smooth != 0;
  int pass = 0;
  cluster.sync();  // every CTA's shared memory is live before remote reads

  for (int s = 0; s < steps; ++s) {
    for (int i = t; i < ng; i += kThreads) {
      const float e0 = s_e0[i];
      s_es[i] = extrapolate
          ? __fadd_rn(e0, __fmul_rn(0.5f, __fsub_rn(e0, s_eprev[i]))) : e0;
      s_e1[i] = e0;
      s_g[i] = 0.0f;
      s_f[i] = 0.0f;
    }
    __syncthreads();
    float r = __int_as_float(0x7f800000);  // +inf
    int k = 0;
    while (r > tol && k < maxiter) {
      for (int i = t; i < ng; i += kThreads) s_fs[i] = smooth_at(s_es, i, ng, sm);
      __syncthreads();
      const int b = pass & 1;
      float* hist = s_hist + b * ng;
      const float* gpos = k == 0 ? p : ps;
      for (int i = begin + t; i < end; i += kThreads) {
        const float a = p[i];
        const float bv = v[i];
        const float e = gather(s_fs, cic_periodic(gpos[i], ng));
        float p1, v1;
        cn_push(a, bv, e, qm_dt, qm_dt2_half, dt_dx, p1, v1);
        const float h = wrap(__fmul_rn(0.5f, __fadd_rn(a, p1)), ngf, inv_ng);
        const float val = __fmul_rn(w, __fmul_rn(0.5f, __fadd_rn(bv, v1)));
        ps[i] = h;
        const Cic c = cic_periodic(h, ng);
        atomicAdd(&hist[c.l], __fmul_rn(val, c.wl));
        atomicAdd(&hist[c.r], __fmul_rn(val, c.wr));
      }
      cluster.sync();  // hist[b] is complete in every CTA

      double sj = 0.0;
      for (int i = t; i < ng; i += kThreads) {
        float jh = 0.0f;
#pragma unroll
        for (int q = 0; q < kCtas; ++q) jh = __fadd_rn(jh, cluster.map_shared_rank(hist, q)[i]);
        s_jh[i] = jh;
        sj += (double)jh;
        // the other parity's histogram was last read remotely in the
        // previous pass, before every CTA reached this pass's barrier
        s_hist[(1 - b) * ng + i] = 0.0f;
      }
      const float mean = (float)(block_sum(sj, red) / ng);  // syncs s_jh
      double rr = 0.0;
      for (int i = t; i < ng; i += kThreads) {
        const float e0 = s_e0[i];
        const float e1 = __fadd_rn(
            e0, __fmul_rn(dt_eps, __fsub_rn(mean, smooth_at(s_jh, i, ng, sm))));
        const float eh = __fmul_rn(0.5f, __fadd_rn(e1, e0));
        const float d = __fsub_rn(s_es[i], eh);
        s_e1[i] = e1;
        s_fs[i] = eh;
        rr += (double)__fmul_rn(d, d);
      }
      r = (float)block_sum(rr, red);
      if (anderson) {
        // ops/accel.py anderson_mix: f = eh - es, df = f - f_prev,
        // gamma = <df, f>/<df, df> clipped to [-5, 5] (0 on a degenerate
        // secant), es = eh - gamma (eh - g_prev) after the first pass
        double dd = 0.0, dfv = 0.0;
        for (int i = t; i < ng; i += kThreads) {
          const float f = __fsub_rn(s_fs[i], s_es[i]);
          const float df = __fsub_rn(f, s_f[i]);
          dd += (double)__fmul_rn(df, df);
          dfv += (double)__fmul_rn(df, f);
        }
        const float denom = (float)block_sum(dd, red);
        const float num = (float)block_sum(dfv, red);
        const float gamma = denom > 0.0f ? fminf(fmaxf(num / denom, -5.0f), 5.0f) : 0.0f;
        for (int i = t; i < ng; i += kThreads) {
          const float eh = s_fs[i];
          const float f = __fsub_rn(eh, s_es[i]);
          s_es[i] = k > 0 ? __fsub_rn(eh, __fmul_rn(gamma, __fsub_rn(eh, s_g[i]))) : eh;
          s_g[i] = eh;
          s_f[i] = f;
        }
      } else {
        for (int i = t; i < ng; i += kThreads) s_es[i] = s_fs[i];
      }
      __syncthreads();
      ++k;
      ++pass;
    }

    // finalize='converged': the deposit-free sweep from smooth(es) at the
    // last ps
    for (int i = t; i < ng; i += kThreads) s_fs[i] = smooth_at(s_es, i, ng, sm);
    __syncthreads();
    const float* gpos = k == 0 ? p : ps;
    double ke = 0.0, jb = 0.0;
    for (int i = begin + t; i < end; i += kThreads) {
      const float e = gather(s_fs, cic_periodic(gpos[i], ng));
      float p1, v1;
      cn_push(p[i], v[i], e, qm_dt, qm_dt2_half, dt_dx, p1, v1);
      p1 = wrap(p1, ngf, inv_ng);
      p[i] = p1;
      v[i] = v1;
      ke += (double)v1 * (double)v1;
      jb += (double)v1;
      if (i == tracer) {
        tx_row[s] = p1;
        tv_row[s] = v1;
      }
    }
    ke = block_sum(ke, red);
    jb = block_sum(jb, red);
    const int sb = s & 1;
    if (t == 0) {
      part[2 * sb] = ke;
      part[2 * sb + 1] = jb;
    }
    double fe = 0.0;
    for (int i = t; i < ng; i += kThreads) {
      const float e1 = s_e1[i];
      fe += (double)e1 * (double)e1;
      s_eprev[i] = s_e0[i];
      s_e0[i] = e1;
    }
    fe = block_sum(fe, red);
    cluster.sync();  // part[sb] is complete in every CTA
    if (rank == 0 && t == 0) {
      double k_sum = 0.0, j_sum = 0.0;
      for (int q = 0; q < kCtas; ++q) {
        const double* rp = cluster.map_shared_rank(part, q);
        k_sum += rp[2 * sb];
        j_sum += rp[2 * sb + 1];
      }
      fe_row[s] = (float)(fe_c * fe);
      ke_row[s] = (float)(ke_c * k_sum);
      jb_row[s] = (float)(jb_c * j_sum);
      it_row[s] = k;
      res_row[s] = r;
    }
  }
  cluster.sync();  // no CTA exits while another may still read its memory

  if (rank == 0) {
    for (int i = t; i < ng; i += kThreads) {
      e_out[i] = s_e0[i];
      eprev_out[i] = s_eprev[i];
      j_out[i] = s_jh[i];
    }
  }
}

}  // namespace

extern "C" {

// p, v: the (n,) outputs, ps: (n,) scratch; rows: (steps,) each, tx_row and
// tv_row zeroed (a tracer index past n leaves them 0).
int pypic_implicit_resident(
    const float* e0, const float* eprev, const float* j0, const float* p_in,
    const float* v_in, float* p, float* v, float* ps, float* e_out,
    float* eprev_out, float* j_out, float* fe, float* ke, float* jb, int* iters,
    float* resid, float* tx, float* tv, int n, int ng, int steps, float qm_dt,
    float qm_dt2_half, float dt_dx, float w, float inv_ng, float dt_eps,
    float tol, int maxiter, int extrapolate, int anderson, int smooth,
    int tracer, double fe_c, double ke_c, double jb_c, void* stream) {
  const size_t smem = (32 + 4) * sizeof(double) + 10 * (size_t)ng * sizeof(float);
  cudaError_t err = allow_smem(implicit_resident_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  implicit_resident_kernel<<<kCtas, kThreads, smem, (cudaStream_t)stream>>>(
      e0, eprev, j0, p_in, v_in, p, v, ps, e_out, eprev_out, j_out, fe, ke, jb,
      iters, resid, tx, tv, n, ng, steps, qm_dt, qm_dt2_half, dt_dx, w, inv_ng,
      dt_eps, tol, maxiter, extrapolate, anderson, smooth, tracer, fe_c, ke_c,
      jb_c);
  return (int)cudaGetLastError();
}

}  // extern "C"
