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
// Bound on the H100: latency. The float32 work (28 operations a particle
// a pass, 19 for the finalize sweep and its sums) takes a few ns a step
// at the card's peak, and the particles cross device memory once a
// launch. A pass is a chain: the sweep and its deposit, four block
// barriers, one cluster barrier and the (ng,) work between them. On the
// first port (8 CTAs, particles in device memory) a 64-step launch of the
// configs[1] row took 3.71 ms: the sweeps ~2.7, 1.56 of it in
// shared-memory float atomics, which this card runs as compare-and-swap
// loops (ATOMS.CAST.SPIN); the (ng,) chain ~1.0 ms, six block barriers
// and one cluster barrier a pass (ten with Anderson) and node sums made
// of remote loads one after another. This design takes 1.2-1.3 ms: per
// pass ~2.4 µs of sweep, ~0.5 of deposit, ~1.3 of barriers (the cluster
// barrier ~1.0) and ~2.4 of (ng,) work, column sums and pushes
// (tools/resident_split.py; PERF.md §6).
//
// Design. ONE thread-block cluster of kCtas = 16 CTAs x 1024 threads (a
// non-portable cluster size, launched by cudaLaunchKernelEx; the wrapper
// refuses a card that cannot hold it). Each CTA holds its particles on
// chip for the whole launch:
//
// * Particles. CTA r owns rows [r per_cta, (r + 1) per_cta) (per_cta =
//   ceil(n / 16), from cuda_cic.implicit_resident_shape); thread t holds
//   rows begin + j 1024 + t, j < kSlots = 8: p0 and the iterate ps in
//   registers (16 a thread), v0 in shared memory (32 KB a CTA, each
//   thread its own words: with v0 in registers too, 64 registers a
//   thread spilled). They are read once at the start and p1, v1 written
//   once at the end.
// * Deposit. Float atomics into lane columns, hist[node][lane mod cols]
//   (cols = 32 up to ng = 256, 8 above, halved where shared memory cannot
//   hold them: implicit_resident_shape), so a warp's atomics land on
//   distinct banks and rarely on a word another warp is adding to. After
//   a block barrier each node thread sums its columns in a fixed order
//   (rotated by lane, so that a warp's reads hit 32 banks), zeroes them,
//   and PUSHES the CTA's node total into recv[pass parity][rank][node] of
//   all 16 CTAs (remote stores: no thread waits on a remote load).
//   Receive buffers alternate by pass parity, so one cluster barrier a
//   pass suffices: a buffer is written again only after the next barrier,
//   when every CTA has read it.
// * (ng,) work: thread t < ng owns node t (ng <= 1024). A node's state
//   is a record of kRec floats in shared memory (e0/e1, eh, jh, the
//   sweep's field, the next step's first field, es, the Anderson
//   residual), so a thread reaches its node and both neighbours from
//   three base addresses. After the cluster barrier it adds its 16
//   received totals in rank order from its own shared memory. A pass then
//   runs three more block barriers: (B1) jh and the warp partials of
//   sum(jh) are in shared memory; (B2) eh and the partials of r, <df, df>,
//   <df, f> and sum(e1^2) are; each node thread then computes the mixed
//   iterate at t-1, t, t+1 itself and writes smooth(es) (and, on the last
//   pass, the next step's initial smooth(es)); (B3) the field of the next
//   sweep is complete. Sums are warp-shuffle trees (fixed lanes) added in
//   warp order. The finalize sweep needs no barrier of its own: each warp
//   pushes its ke and jb partials to rank 0, whose spare warps sum them
//   after the next cluster barrier (double-buffered by step parity).
// * The Picard exit depends on the data, and a CTA that left the loop on
//   another pass than the rest would deadlock the next cluster barrier.
//   So every CTA holds a bit-identical jh, r and Anderson products: each
//   receives the same 16 totals and adds them in rank order, the (ng,)
//   sums run over the same thread-to-node map in the same order, and r is
//   rounded to float32 before the test. Identical inputs, identical code,
//   identical order: every CTA takes the same branch. Within a CTA the
//   deposit's order is the hardware's, so jh is not bit-equal from call to
//   call, but it is the same in every CTA of one launch.
//
// Shared memory: 2,240 float64 (17.5 KB of partials), the columns, the
// receive buffers (32 floats a node), the records (9 a node) and v0 (32
// KB): 109,088 B at the configs[1] row's ng = 200 (32 columns), 226,816 B
// at ng = 1024 (2 columns) of the 232,448 a block may use.
//
// The launcher returns a cudaError_t; it allocates nothing and runs on the
// stream it is given.

#include <cooperative_groups.h>

#include "cic_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCtas = 16;  // cuda_cic.RESIDENT_IMPLICIT_CLUSTER
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kSlots = 8;  // 131072 / (16 x 1024): particles a thread
// float64 scratch: the warp partials of two reductions, the metric
// partials pushed to rank 0 ([step parity][rank][warp][ke, jb]) and rank
// 0's per-CTA sums
constexpr int kDoubles = kWarps + 4 * kWarps + 2 * kCtas * kWarps * 2 + 2 * kCtas;
// A node's record: its fields at these offsets, kRec floats apart (odd,
// so consecutive nodes fall on distinct banks). One base address a
// thread reaches every field of its node and its neighbours'.
constexpr int kRec = 9;
constexpr int F_E = 0;   // [step parity]: e0 of the step, then its e1
constexpr int F_EH = 2;  // [pass parity]: eh
constexpr int F_JH = 4;  // jh
constexpr int F_FS = 5;  // smooth(es): the next sweep's field
constexpr int F_FI = 6;  // smooth of the next step's first iterate
constexpr int F_ES = 7;  // the iterate es
constexpr int F_FP = 8;  // Anderson: the previous residual eh - es

__device__ __forceinline__ float smooth3(float lo, float mid, float hi,
                                         bool smooth) {
  // smooth_periodic of ops/fd.py: (f[i+1] + 2 f[i] + f[i-1]) / 4, in that
  // order; the identity without smoothing
  if (!smooth) return mid;
  return __fmul_rn(__fadd_rn(__fadd_rn(hi, __fmul_rn(2.0f, mid)), lo), 0.25f);
}

// The first iterate of a step at a node: e0 (+ (e0 - eprev)/2), e0 and
// eprev the record's fields f0 and fp.
__device__ __forceinline__ float first_iterate(const float* rec, int f0,
                                               int fp, bool extrapolate) {
  const float a = rec[f0];
  return extrapolate ? __fadd_rn(a, __fmul_rn(0.5f, __fsub_rn(a, rec[fp]))) : a;
}

__device__ __forceinline__ float smoothed_first(const float* lo,
                                                const float* mid,
                                                const float* hi, int f0,
                                                int fp, bool extrapolate,
                                                bool sm) {
  return smooth3(first_iterate(lo, f0, fp, extrapolate),
                 first_iterate(mid, f0, fp, extrapolate),
                 first_iterate(hi, f0, fp, extrapolate), sm);
}

// cic_common.cuh's gather from a field kept in the node records.
__device__ __forceinline__ float gather_rec(const float* field, const Cic& c) {
  return __fadd_rn(__fmul_rn(field[c.l * kRec], c.wl),
                   __fmul_rn(field[c.r * kRec], c.wr));
}

// Lane 0 gets the warp's sum, a fixed tree over the lanes.
__device__ __forceinline__ double warp_sum(double x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  return x;
}

// Rank 0, between a cluster barrier and the next block barrier: warp
// kWarps - kCtas + q sums the ke, jb warp partials CTA q pushed for step
// parity sb into tot[q].
__device__ __forceinline__ void collect_partials(const double* part,
                                                 double* tot, int sb) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = warp - (kWarps - kCtas);
  if (q < 0) return;
  const double* rp = part + ((sb * kCtas + q) * kWarps + lane) * 2;
  const double ke = warp_sum(rp[0]);
  const double jb = warp_sum(rp[1]);
  if (lane == 0) {
    tot[2 * q] = ke;
    tot[2 * q + 1] = jb;
  }
}

// Rank 0, after that block barrier: the step's ke and jb rows.
__device__ __forceinline__ void write_partials(const double* tot, int step,
                                               float* ke_row, float* jb_row,
                                               double ke_c, double jb_c) {
  double ke = 0.0, jb = 0.0;
  for (int q = 0; q < kCtas; ++q) {
    ke += tot[2 * q];
    jb += tot[2 * q + 1];
  }
  ke_row[step] = (float)(ke_c * ke);
  jb_row[step] = (float)(jb_c * jb);
}

// kMix: Anderson(1) mixing (picard_accel='anderson'), a template
// parameter so that the plain iteration keeps no registers for its sums.
template <bool kMix>
__global__ void __launch_bounds__(kThreads, 1) implicit_resident_kernel(
    const float* __restrict__ e0_in, const float* __restrict__ eprev_in,
    const float* __restrict__ j_in, const float* __restrict__ p_in,
    const float* __restrict__ v_in, float* __restrict__ p_out,
    float* __restrict__ v_out, float* __restrict__ e_out,
    float* __restrict__ eprev_out, float* __restrict__ j_out,
    float* __restrict__ fe_row, float* __restrict__ ke_row,
    float* __restrict__ jb_row, int* __restrict__ it_row,
    float* __restrict__ res_row, float* __restrict__ tx_row,
    float* __restrict__ tv_row, int n, int per_cta, int ng, int cols,
    int steps, float qm_dt, float qm_dt2_half, float dt_dx, float w,
    float inv_ng, float dt_eps, float tol, int maxiter, int extrapolate,
    int smooth, int tracer, double fe_c, double ke_c, double jb_c) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int nw = (ng + 31) >> 5;  // the warps that hold nodes
  const bool node = t < ng, node_warp = warp < nw;
  const bool ex = extrapolate != 0, sm = smooth != 0;

  extern __shared__ double smem_d[];
  double* red_m = smem_d;               // [warp]: sum(jh)
  double* red_r = red_m + kWarps;       // [warp][r, <df,df>, <df,f>, sum(e1^2)]
  double* part = red_r + 4 * kWarps;    // [step parity][rank][warp][ke, jb]
  double* tot = part + 4 * kCtas * kWarps;  // [rank][ke, jb]: rank 0's sums
  float* hist = (float*)(smem_d + kDoubles);  // [node][column]: the deposit
  float* recv = hist + cols * ng;       // [pass parity][rank][node]: CTA totals
  float* nodes = recv + 2 * kCtas * ng; // [node][kRec]
  float* vel = nodes + kRec * ng;       // [slot][thread]: the particles' v0
  // node t's record and its neighbours' (periodic)
  float* me = nodes + t * kRec;
  const float* nlo = nodes + (t == 0 ? ng - 1 : t - 1) * kRec;
  const float* nhi = nodes + (t + 1 >= ng ? 0 : t + 1) * kRec;

  // the particles, on chip for the whole launch: p0 and ps in registers,
  // v0 in shared memory (each thread its own words)
  const int begin = rank * per_cta;
  // slot j of thread t holds row begin + j kThreads + t iff j kThreads < lim
  const int lim = min(begin + per_cta, n) - begin - t;
  float P[kSlots], S[kSlots];
  float* my_v = vel + t;  // slot j at my_v[j kThreads]
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    P[j] = 0.0f;
    if (j * kThreads < lim) {
      P[j] = p_in[begin + j * kThreads + t];
      my_v[j * kThreads] = v_in[begin + j * kThreads + t];
    }
  }
  if (node) {
    me[F_E] = e0_in[t];
    me[F_E + 1] = eprev_in[t];
    me[F_JH] = j_in[t];
  }
  for (int i = t; i < cols * ng; i += kThreads) hist[i] = 0.0f;
  const float ngf = (float)ng;
  cluster.sync();  // every CTA's shared memory is live before remote stores
  if (node) me[F_FI] = smoothed_first(nlo, me, nhi, F_E, F_E + 1, ex, sm);
  __syncthreads();

  // Step s - 1's ke, jb partials wait for rank 0 until the first cluster
  // barrier of step s (its first pass, or the barrier of a step without
  // one); the last step's, until the barrier after the loop.
  int pass = 0;
  for (int s = 0; s < steps; ++s) {
    const int sp = s & 1;
    const int f_e0 = F_E + sp, f_e1 = F_E + 1 - sp;  // e0; eprev, then e1
    if (node) {
      me[F_ES] = first_iterate(me, f_e0, f_e1, ex);
      me[F_FP] = 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kSlots; ++j) S[j] = P[j];  // the first pass gathers at p0
    float r = __int_as_float(0x7f800000);  // +inf
    int k = 0;
    while (r > tol && k < maxiter) {
      const int b = pass & 1;
      const float* fs = nodes + (k == 0 ? F_FI : F_FS);
      const int col = lane & (cols - 1);  // this lane's deposit column
#pragma unroll
      for (int j = 0; j < kSlots; ++j) {
        if (j * kThreads < lim) {
          const float a = P[j], bv = my_v[j * kThreads];
          const float e = gather_rec(fs, cic_periodic(S[j], ng));
          float p1, v1;
          cn_push(a, bv, e, qm_dt, qm_dt2_half, dt_dx, p1, v1);
          const float h = wrap(__fmul_rn(0.5f, __fadd_rn(a, p1)), ngf, inv_ng);
          const float val = __fmul_rn(w, __fmul_rn(0.5f, __fadd_rn(bv, v1)));
          S[j] = h;
          const Cic c = cic_periodic(h, ng);
          atomicAdd(&hist[c.l * cols + col], __fmul_rn(val, c.wl));
          atomicAdd(&hist[c.r * cols + col], __fmul_rn(val, c.wr));
        }
      }
      __syncthreads();  // (B0) this CTA's deposit is complete
      if (node) {
        // node t's columns in the order (lane + c) mod cols, c = 0, 1, ...
        // (a warp's 32 reads then fall on 32 banks; a fixed order for each
        // node), then zeroed; the total pushed into recv[b][rank][t] of
        // every CTA (remote stores)
        float* hc = hist + t * cols;
        float x = 0.0f;
#pragma unroll 8
        for (int c = 0; c < cols; ++c)
          x = __fadd_rn(x, hc[(lane + c) & (cols - 1)]);
#pragma unroll 8
        for (int c = 0; c < cols; ++c) hc[(lane + c) & (cols - 1)] = 0.0f;
        float* slot = recv + (b * kCtas + rank) * ng + t;
#pragma unroll
        for (int q = 0; q < kCtas; ++q) *cluster.map_shared_rank(slot, q) = x;
      }
      cluster.sync();  // recv[b] is complete in every CTA
      const bool collect = k == 0 && s > 0;
      if (collect && rank == 0) collect_partials(part, tot, (s - 1) & 1);

      // (B1) jh of node t: the 16 CTAs' totals in rank order
      if (node_warp) {
        double x = 0.0;
        if (node) {
          const float* rv = recv + b * kCtas * ng + t;
          float acc = 0.0f;
#pragma unroll
          for (int q = 0; q < kCtas; ++q) acc = __fadd_rn(acc, rv[q * ng]);
          me[F_JH] = acc;
          x = (double)acc;
        }
        x = warp_sum(x);
        if (lane == 0) red_m[warp] = x;
      }
      __syncthreads();
      if (collect && rank == 0 && t == kThreads - 1)
        write_partials(tot, s - 1, ke_row, jb_row, ke_c, jb_c);

      // (B2) e1, eh and the pass's partial sums
      if (node_warp) {
        double rr = 0.0, dd = 0.0, dfv = 0.0, fe = 0.0;
        if (node) {
          double sj = 0.0;
          for (int q = 0; q < nw; ++q) sj += red_m[q];
          const float mean = (float)(sj / ng);
          const float e0 = me[f_e0], es = me[F_ES];
          const float e1 = __fadd_rn(e0, __fmul_rn(dt_eps, __fsub_rn(
              mean, smooth3(nlo[F_JH], me[F_JH], nhi[F_JH], sm))));
          const float eh = __fmul_rn(0.5f, __fadd_rn(e1, e0));
          const float d = __fsub_rn(es, eh);
          rr = (double)__fmul_rn(d, d);
          fe = (double)e1 * (double)e1;
          me[F_EH + b] = eh;
          me[f_e1] = e1;
          if (kMix) {
            // ops/accel.py anderson_mix: f = eh - es, df = f - f_prev
            const float f = __fsub_rn(eh, es);
            const float df = __fsub_rn(f, me[F_FP]);
            dd = (double)__fmul_rn(df, df);
            dfv = (double)__fmul_rn(df, f);
            me[F_FP] = f;
          }
        }
        rr = warp_sum(rr);
        fe = warp_sum(fe);
        if (kMix) {
          dd = warp_sum(dd);
          dfv = warp_sum(dfv);
        }
        if (lane == 0) {
          red_r[4 * warp] = rr;
          red_r[4 * warp + 1] = dd;
          red_r[4 * warp + 2] = dfv;
          red_r[4 * warp + 3] = fe;
        }
      }
      __syncthreads();

      // (B3) r, the mixed iterate and the next sweep's field
      double rs = 0.0;
      for (int q = 0; q < nw; ++q) rs += red_r[4 * q];
      r = (float)rs;
      const int kk = k++;
      ++pass;
      const bool last = !(r > tol && k < maxiter);
      if (node) {
        float gamma = 0.0f;
        if (kMix) {
          // gamma = <df, f>/<df, df> clipped to [-5, 5] (0 on a degenerate
          // secant); es = eh - gamma (eh - g_prev) after the first pass
          double dd = 0.0, dfv = 0.0;
          for (int q = 0; q < nw; ++q) {
            dd += red_r[4 * q + 1];
            dfv += red_r[4 * q + 2];
          }
          const float denom = (float)dd, num = (float)dfv;
          gamma = denom > 0.0f ? fminf(fmaxf(num / denom, -5.0f), 5.0f) : 0.0f;
        }
        // g_prev: the previous pass's eh
        const float* recs[3] = {nlo, me, nhi};
        float m[3];
#pragma unroll
        for (int u = 0; u < 3; ++u) {
          const float ehj = recs[u][F_EH + b];
          m[u] = kMix && kk > 0
              ? __fsub_rn(ehj, __fmul_rn(gamma,
                                         __fsub_rn(ehj, recs[u][F_EH + 1 - b])))
              : ehj;
        }
        me[F_ES] = m[1];
        me[F_FS] = smooth3(m[0], m[1], m[2], sm);
        // the next step's first iterate, from its e0 (this e1) and eprev
        if (last) me[F_FI] = smoothed_first(nlo, me, nhi, f_e1, f_e0, ex, sm);
      }
      if (last && rank == 0 && t == 0) {
        double fe = 0.0;
        for (int q = 0; q < nw; ++q) fe += red_r[4 * q + 3];
        fe_row[s] = (float)(fe_c * fe);
        it_row[s] = k;
        res_row[s] = r;
      }
      __syncthreads();
    }

    if (k == 0) {
      // no pass (maxiter < 1): rank 0 reads the pending partials behind a
      // cluster barrier of its own, since no pass brings one
      cluster.sync();
      if (s > 0 && rank == 0) collect_partials(part, tot, (s - 1) & 1);
      __syncthreads();
      if (s > 0 && rank == 0 && t == kThreads - 1)
        write_partials(tot, s - 1, ke_row, jb_row, ke_c, jb_c);
    }

    // finalize='converged': the deposit-free sweep from smooth(es) at the
    // last ps (at p0 from the first iterate's field without a pass)
    const float* fs = nodes + (k == 0 ? F_FI : F_FS);
    double ke = 0.0, jb = 0.0;
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      if (j * kThreads < lim) {
        const float e = gather_rec(fs, cic_periodic(S[j], ng));
        float p1, v1;
        cn_push(P[j], my_v[j * kThreads], e, qm_dt, qm_dt2_half, dt_dx, p1, v1);
        p1 = wrap(p1, ngf, inv_ng);
        P[j] = p1;
        my_v[j * kThreads] = v1;
        ke += (double)v1 * (double)v1;
        jb += (double)v1;
        if (begin + j * kThreads + t == tracer) {
          tx_row[s] = p1;
          tv_row[s] = v1;
        }
      }
    }
    ke = warp_sum(ke);
    jb = warp_sum(jb);
    if (lane == 0) {
      double* to = cluster.map_shared_rank(part, 0) +
                   ((sp * kCtas + rank) * kWarps + warp) * 2;
      to[0] = ke;
      to[1] = jb;
    }

    if (k == 0) {
      // e1 = e0: the next step's e0 and first field, and this step's rows
      __syncthreads();  // every thread's sweep has read F_FI
      double fe = 0.0;
      if (node) {
        const float e0 = me[f_e0];
        me[f_e1] = e0;
        // e0 and eprev both e0: the first iterate is e0 with or without
        // extrapolation
        me[F_FI] = smoothed_first(nlo, me, nhi, f_e0, f_e0, ex, sm);
        fe = (double)e0 * (double)e0;
      }
      if (node_warp) {
        fe = warp_sum(fe);
        if (lane == 0) red_r[4 * warp + 3] = fe;
      }
      __syncthreads();
      if (rank == 0 && t == 0) {
        double sum = 0.0;
        for (int q = 0; q < nw; ++q) sum += red_r[4 * q + 3];
        fe_row[s] = (float)(fe_c * sum);
        it_row[s] = 0;
        res_row[s] = r;
      }
    }
  }

  cluster.sync();  // the last step's partials have reached rank 0
  if (rank == 0) collect_partials(part, tot, (steps - 1) & 1);
  __syncthreads();
  if (rank == 0 && t == kThreads - 1)
    write_partials(tot, steps - 1, ke_row, jb_row, ke_c, jb_c);

#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    if (j * kThreads < lim) {
      const int i = begin + j * kThreads + t;
      p_out[i] = P[j];
      v_out[i] = my_v[j * kThreads];
    }
  }
  if (rank == 0 && node) {
    e_out[t] = me[F_E + (steps & 1)];
    eprev_out[t] = me[F_E + 1 - (steps & 1)];
    j_out[t] = me[F_JH];
  }
}

// cuda_cic.implicit_resident_shape: the deposit's columns and the bytes
constexpr size_t smem_bytes(int ng, int cols) {
  return kDoubles * sizeof(double) +
         ((size_t)(cols + 2 * kCtas + kRec) * ng + kSlots * kThreads) *
             sizeof(float);
}

template <bool kMix>
cudaError_t prepare(size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      implicit_resident_kernel<kMix>,
      cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  return allow_smem(implicit_resident_kernel<kMix>, smem);
}

cudaLaunchConfig_t launch_config(size_t smem, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCtas);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kCtas;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

extern "C" {

// How many clusters of the kernel's shape (kCtas CTAs of kThreads threads,
// its shared memory at ng) the current card holds at once: 0 means it
// cannot launch.
int pypic_implicit_resident_clusters(int ng, int cols, int* count) {
  // both instantiations have the same shape (64 registers, the same
  // shared memory)
  const size_t smem = smem_bytes(ng, cols);
  cudaError_t err = prepare<false>(smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = launch_config(smem, 0, &attr);
  return (int)cudaOccupancyMaxActiveClusters(
      count, implicit_resident_kernel<false>, &cfg);
}

// p, v: the (n,) outputs; rows: (steps,) each, tx_row and tv_row zeroed (a
// tracer index past n leaves them 0). per_cta: the rows a CTA owns,
// ceil(n / kCtas), at most kSlots x kThreads; ng <= kThreads.
int pypic_implicit_resident(
    const float* e0, const float* eprev, const float* j0, const float* p_in,
    const float* v_in, float* p, float* v, float* e_out, float* eprev_out,
    float* j_out, float* fe, float* ke, float* jb, int* iters, float* resid,
    float* tx, float* tv, int n, int per_cta, int ng, int cols, int steps,
    float qm_dt, float qm_dt2_half, float dt_dx, float w, float inv_ng,
    float dt_eps, float tol, int maxiter, int extrapolate, int anderson, int smooth,
    int tracer, double fe_c, double ke_c, double jb_c, void* stream) {
  if (ng < 2 || ng > kThreads || per_cta < 0 || per_cta > kSlots * kThreads ||
      (long long)per_cta * kCtas < n || cols < 1 || cols > 32 ||
      (cols & (cols - 1)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(ng, cols);
  cudaError_t err = anderson ? prepare<true>(smem) : prepare<false>(smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = launch_config(smem, (cudaStream_t)stream, &attr);
  err = cudaLaunchKernelEx(
      &cfg,
      anderson ? implicit_resident_kernel<true> : implicit_resident_kernel<false>,
      e0, eprev, j0, p_in, v_in, p, v, e_out, eprev_out, j_out, fe, ke, jb,
      iters, resid, tx, tv, n, per_cta, ng, cols, steps, qm_dt, qm_dt2_half,
      dt_dx, w, inv_ng, dt_eps, tol, maxiter, extrapolate, smooth, tracer,
      fe_c, ke_c, jb_c);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
