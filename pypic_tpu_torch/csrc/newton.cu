// The Newton-Boltzmann Poisson solves in one launch each, for Hopper
// (sm_90a): Dirichlet-Dirichlet walls (newton_dd_kernel) and a Dirichlet
// left wall with a one-sided Neumann right wall (newton_dn_kernel).
//
// newton_dd_kernel replaces pypic_tpu/ops/pallas_newton.py:_newton_dd_kernel
// (boltzmann_dirichlet_pallas), the Newton solve of
//   F(phi) = A phi - dx^2 c0 exp(c1 phi) + dx^2 c2 = 0
// (pygcpic.py:1005-1053; A the Laplacian with identity wall rows, c0 =
// e n0 / eps0, c1 = e / (kB Te), c2 = rho / eps0): the residual build, the
// Jacobian, a parallel-cyclic-reduction (PCR) solve of the tridiagonal
// Newton system, the exponent clamp and step clip of ops.poisson
// (_EXP_CLAMP), the convergence test and the final shift to min 0 -- the
// whole loop inside the kernel, as on the TPU.
//
// Bound on the H100: neither bytes nor operations (a few KB in and out,
// ~150 float32 operations a row an iteration) but the latency of one CTA
// on one SM: a chain of PCR stages, each a shared-memory exchange behind a
// block barrier. Its yardstick is microseconds an iteration. The split
// (python -m pypic_tpu_torch.tools.resident_split --kernel newton_dd|
// newton_dn; PERF.md section 6) puts the barriers and exchanges
// alone at 71% (D-D, ng = 600) and 81% (D-N, ng = 800) of a launch: the
// stages' shared-memory traffic (48 B a row a stage, 60 with the D-N
// kernel's second column) at the SM's 128 B a clock, and a barrier after
// each. The first port (1,024 threads, 13 block barriers an iteration)
// took 8.4-9.8 us an iteration; this design 3.2 and 4.6.
//
// Design:
// * One CTA of rows = ng rounded up to 32 threads, one row a thread
//   (ng <= 1024). The first port took the TPU's row count, the next power
//   of two >= max(ng, 128): 1,024 threads at ng = 600 and 800, whose
//   padding warps ran every stage (25% of the D-D launch). A row read
//   outside [0, rows) is the identity row (a, b, c, f) = (0, 1, 0, 0), as
//   the padding rows were, so the solution is the same (up to the sign of
//   zero).
// * PCR: each stage stores the thread's row as one float4 (a, b, c, f;
//   the D-N kernel's second right-hand side beside it) into one of two
//   shared-memory buffers, passes one block barrier and loads the rows
//   i - s and i + s. Alternating buffers needs one barrier a stage. The
//   buffers carry `halo` identity rows on each side (halo = the largest
//   stride), so no load is predicated.
// * The stage barrier is a vote (__syncthreads_or): once no row of the
//   block is coupled to another (every a and c is 0), the stages left
//   would change no value, and the loop ends. The couplings of these
//   diagonally dominant systems decay like the square of the last
//   stage's and underflow to 0 before the stride reaches the rows (8 of
//   10 stages at both rows' first solves). The buffer of that last vote
//   holds every row's final (b, f), which the D-N kernel reads for its
//   rank-1 correction without a barrier of its own.
// * div_rn: a zero dividend, the coupling of most rows in the last
//   stages, leaves __fdiv_rn's fast path for its slow one; its quotient
//   is formed as a product instead (the same signed zero). Without this
//   the launch takes half again as long (D-D) or a third (D-N). The other
//   divisions stay correctly rounded (3-8% of a launch).
// * The residual sum(dphi^2) is fixed-order: each warp's shuffle tree in
//   float64, lane 0's partial into shared memory in the same phase as
//   the next iteration's shared copy of phi, one barrier for both, then
//   every warp sums the partials by the same shuffle tree and takes lane
//   0's total. Every thread holds the same bits, so every thread takes
//   the same branch of the loop test. One barrier an iteration besides
//   the PCR's, where the first port had three.
// * n0 and the warm start are read through device pointers: n0 is the
//   output of the step's density update, and a host copy would cost the
//   step a host sync. c0 = f32(e / eps0) n0 and c2 = rho / f32(eps0) are
//   formed here in float32, as the JAX wrapper forms them; the warm start's
//   wall entries are pinned to 0.
// * The arithmetic follows the TPU kernel's operation order, with
//   __fmul_rn / __fadd_rn / __fdiv_rn so nvcc contracts nothing into an
//   FMA; expf is the libdevice (not fast-math) one.
// * Not taken: the strides below 32 by warp shuffles. A shuffle moves 4 B
//   a lane through the same shared-memory pipe, and the warp's window of
//   halo rows would move 2-3 times the rows a stage.
//
// newton_dn_kernel replaces pypic_tpu/ops/pallas_newton.py:_newton_dn_kernel
// (boltzmann_dn_pallas), the Newton loop of ops.poisson.
// solve_boltzmann_dirichlet_neumann (pygcpic.py:1062-1109) on the NUMBER
// density n (c2 = e n / eps0). What differs from the D-D kernel:
// * The Laplacian's last row is the one-sided Neumann row (..., 1, -4, 3):
//   tridiagonal (a = -4, b = 3) plus the rank-1 entry A[-1, -3] = 1, and
//   the Newton system is solved by Sherman-Morrison, dphi = y - z (y[ng-3]
//   / (1 + z[ng-3])) with y = T^-1 f and z = T^-1 e_{ng-1}: one PCR with
//   two right-hand sides that share the elimination coefficients.
// * Row overrides f[0] = phi[0] and f[-1] = 0; the Jacobian diagonal is
//   -dx^2 c0 c1 exp on the interior, -dx^2 c0 c1 on the wall row and 0 on
//   the last row. The warm start is used as given (no wall pin).
// * phi[0] and phi[ng-3] come from the shared copy of phi the Laplacian
//   reads; every thread forms y[ng-3] and z[ng-3] itself from row ng-3's
//   final (b, f) in the PCR's last buffer (the same divisions row ng-3's
//   thread makes).
// * The residual is ||dphi||_2 (the D-D kernel's is the squared norm): the
//   same fixed-order sum, rounded to float32, then a correctly rounded
//   square root, so every thread takes the same loop branch.
//
// The large path (newton_dd_large_kernel, newton_dn_large_kernel,
// tridiag3_chain_large_kernel): the same three solves above 1,024 rows,
// where one row a thread no longer fits one CTA. It replaces the same TPU
// kernels (boltzmann_dirichlet_pallas, boltzmann_dn_pallas; the chain
// none), which hold any ng in VMEM. The Newton loop is the one above, row
// for row: the residual build, the Jacobian, the exponent clamp and step
// clip, the fixed-order float64 residual sum, the loop test and the final
// shift. Only the tridiagonal solve inside an iteration differs: the
// partition method.
// * One CTA of T threads (a multiple of 32, at most 1,024); thread t owns
//   the k = ceil(rows / 1024) consecutive rows t k .. t k + k - 1 of the
//   T k padded rows (cuda_newton.large_split). Rows past ng are identity
//   rows, as on the small path.
// * A sweep down the block normalises rows 0 and 1 and takes each later
//   row's coupling to the row above out with that row, carrying the
//   fill-in as a coupling to the block's row 0 (Thomas's order, so the D-N
//   Laplacian's last row, a = -4 and b = 3, which is not diagonally
//   dominant, is reached from above as the Thomas route reaches it). A
//   sweep up takes each inner row's coupling to the row below out, then
//   row 0's to row 1. Every inner row then reads a'_j x_0 + x_j +
//   c'_j x_(k-1) = d'_j, and the block's rows 0 and k - 1 form two rows of
//   a tridiagonal system of 2 T rows in the blocks' end values.
// * That reduced system is solved by the small path's PCR stage loop,
//   two rows a thread (pcr_solve_pair: the same float4 buffers, pcr_stage
//   and the vote-ended stages, R right-hand sides). Each thread then
//   recovers its inner rows from its two end values.
// * The block rows' couplings, right-hand sides, phi and dx^2 c2 live in a
//   scratch the wrapper allocates (4 + R floats a row for the Newton
//   solves, 2 + R for the chain), row j of thread t at j T + t, so a
//   warp's loads and stores at one j are coalesced. The inputs are read
//   and phi written once a launch in row order (coalesced), and
//   transposed through the scratch. The chain reads its inputs and writes
//   x in row order (strided across the warp, once a launch). 16,384 rows
//   x 24 B is 0.4 MB a Newton iteration, which stays in the 50 MB L2.
// * Neighbouring blocks meet in the residual build (phi of the row above
//   and below a block): each thread's first and last phi sit in shared
//   memory, written in the same phase as the residual's partial sums,
//   behind the same barrier. The D-N kernel's phi[ng-3] and its
//   Sherman-Morrison values y[ng-3], z[ng-3] come from their owning
//   thread through shared memory, the latter behind one more barrier.
// * The residual: each thread sums its rows' dphi^2 in float64 in row
//   order, then the small path's warp trees, so every thread holds the
//   same bits and takes the same branch of the loop test.
// * Bound: latency, as on the small path: k serial steps in each sweep and
//   the recovery, and up to log2(2 T) PCR stages, an iteration; the bytes
//   (the scratch's ~24-28 B a row, three times over, an iteration) go
//   through L2 at one SM's rate.
// * Ceiling: cuda_newton.LARGE_MAX_ROWS (2^27 rows), where the int
//   offsets into the (4 + R, rows) scratch would near 2^31.
//
// The large path's cluster mode (newton_cluster_kernel, the
// `_cluster` entry points; the one-CTA kernels above are the mode
// 'single'; cuda_newton.NEWTON_RULE picks the mode). The one-CTA loop is
// serial in k on one of 132 SMs, its scratch in device memory. Here the
// rows are spread over a thread-block cluster of C CTAs (2-16, a
// non-portable size above 8, launched by cudaLaunchKernelEx), CTA r
// holding the rows r T k .. (r + 1) T k - 1, thread t of it block t as
// above (k = ceil(rows / (C T)) rows a thread, cuda_newton.large_shape).
// * A CTA's rows' phi, dx^2 c2, a', c' and d' sit in its shared memory
//   where they fit beside the PCR buffers (cluster_smem), else in its own
//   slice of a device-memory scratch. The sweeps and the recovery are the
//   one-CTA kernels' (sweep_down, sweep_up, recover) in the same order.
// * Inside a CTA, its 2 T end rows with its first row F and its last L
//   set apart: row 1's coupling to F and row 2 T - 2's to L become two
//   right-hand-side columns p and q (SPIKE), and the PCR solves the inner
//   rows for the R columns, p and q at once (pcr_solve_pair on PlaneBuf:
//   no rims, rows read outside identity rows). Every inner end row then
//   reads x = y - p F - q L.
// * Substituting rows 1 and 2 T - 2 into rows 0 and 2 T - 1 gives the
//   CTA's two rows of a tridiagonal system of 2 C rows in the CTAs' F and
//   L (F_r couples L_(r-1) and L_r; L_r couples F_r and F_(r+1)). Thread 0
//   and thread T - 1 push them into a slot of every CTA's shared memory
//   by remote stores (no remote atomic), one cluster barrier, and every
//   warp of every CTA solves the 2 C rows alike by a shuffle PCR
//   (warp_pcr): the same bits everywhere.
// * Neighbouring CTAs meet in the residual build (phi of the row above
//   and below the CTA): each CTA keeps those two rows' phi itself, updated
//   from the cluster's solution (L_(r-1), F_(r+1)) by the owner's
//   arithmetic, so no exchange of phi is needed. The D-N kernel's row
//   ng - 3 (its phi, its y and z for the Sherman-Morrison correction): its
//   owner pushes the twelve values its recovery reads beside the rows, and
//   every CTA recovers y[ng-3], z[ng-3] itself.
// * The residual: each CTA's float64 partial by the warp trees, pushed to
//   every CTA with the next iteration's rows and added in rank order, so
//   every CTA holds the same bits and takes the same branch of the loop
//   test. One cluster barrier an iteration: iteration i's test is read at
//   iteration i + 1's barrier, after its sweeps and CTA solve, which are
//   dropped when the test ends the loop (phi is written only after the
//   barrier); at maxiter one barrier more. The min shift: each CTA's
//   minimum to every CTA, one barrier.
// * Bound: latency, k serial steps in each sweep and the recovery (k is
//   C times smaller than the one-CTA kernel's at the same threads), up
//   to log2(2 T) PCR stages, one cluster barrier and a five-stage shuffle
//   PCR an iteration.
//
// The double forms (a float64 state, as the JAX package runs the solve
// under x64): every kernel but the chain's takes the element type T last,
// and the `_f64` entry points launch its double instantiations. A double
// kernel computes what JAX's float64 path computes (XLA's on-device
// while_loop of ops.poisson): each operation rounded once in double
// (mul_rn, add_rn, sub_rn, quot_rn: __dmul_rn ... __ddiv_rn; exp, fmin,
// fmax, __dsqrt_rn), the scalars the wrapper's float64 values
// (cuda_newton.newton_scalars in the state's dtype, not float32), the
// residual the same fixed-order double sum, never rounded to float32, and
// the min shift's sentinel DBL_MAX. Only the solve differs from JAX's
// Thomas sweep: the PCR and partition solves above, so phi agrees to the
// float64 rounding of a tridiagonal solve. The PCR buffers hold a row as
// two 16-B halves of doubles (a, b, c, f) and the second right-hand side
// as a double: 40 B a row where the float kernels take 20, so the small
// path's one CTA holds 1,024 rows in 172,032 B (the D-N kernel's; D-D
// 139,264), and the large path's CTA is held to LARGE_F64_THREADS = 512
// threads (2 x 512 PCR rows: 172,032 B), k = ceil(rows / 512) rows a
// thread (cuda_newton.large_split with item 8). __launch_bounds__(1024)
// caps the double kernels at 64 registers a thread, so a double CTA of
// 1,024 rows launches. The float instantiations compile to the code the
// float kernels compiled to (tools/sass_diff.py). Bound: the float
// kernels' latency chain, each stage's shared-memory traffic doubled and
// each division a double one (no hardware double divide: a Newton
// sequence of some ten FMAs).

#include <cooperative_groups.h>

#include "cic_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxRows = 1024;
// the large path's threads at most for the double kernels (their PCR rows
// take twice the bytes; cuda_newton.LARGE_F64_THREADS)
constexpr int kMaxLargeThreadsF64 = 512;

// Four doubles of a PCR row (a, b, c, f) as two 16-B halves.
struct __align__(16) Double4Row {
  double x, y, z, w;
};

// The PCR buffers' element types: a row's (a, b, c, f) and the third
// right-hand side's pair.
template <typename T>
struct Pcr;
template <>
struct Pcr<float> {
  using V4 = float4;
  using V2 = float2;
};
template <>
struct Pcr<double> {
  using V4 = Double4Row;
  using V2 = double2;
};

__device__ __forceinline__ float4 make4(float a, float b, float c, float d) {
  return make_float4(a, b, c, d);
}
__device__ __forceinline__ Double4Row make4(double a, double b, double c, double d) {
  return Double4Row{a, b, c, d};
}
__device__ __forceinline__ float2 make2(float a, float b) { return make_float2(a, b); }
__device__ __forceinline__ double2 make2(double a, double b) { return make_double2(a, b); }
// The square root correctly rounded, the exponential (libdevice, not
// fast-math), the minimum, and the largest finite value
__device__ __forceinline__ float sqrt_rn(float x) { return __fsqrt_rn(x); }
__device__ __forceinline__ double sqrt_rn(double x) { return __dsqrt_rn(x); }
__device__ __forceinline__ float exp_of(float x) { return expf(x); }
__device__ __forceinline__ double exp_of(double x) { return exp(x); }
__device__ __forceinline__ float min_of(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double min_of(double a, double b) { return fmin(a, b); }
template <typename T>
__device__ __forceinline__ T largest() {
  if constexpr (sizeof(T) == 8)
    return 1.7976931348623157e308;
  else
    return 3.402823466e38f;
}

// A row of the PCR system with R right-hand sides.
template <int R, typename T>
struct Row {
  T a, b, c, f[R];
};

// The PCR stage buffers in shared memory: two of `stride` = rows + 2 halo
// entries each; row j at j + halo. q holds (a, b, c, f[0]), g f[1] (R = 2),
// g2 (f[1], f[2]) (R = 3).
template <typename T>
struct PcrBuf {
  typename Pcr<T>::V4* q;
  T* g;
  typename Pcr<T>::V2* g2;
  int stride, halo;
};

// The largest PCR stride below `rows` (rows >= 32), which is the width of
// each buffer's identity rim.
__host__ __device__ __forceinline__ int pcr_halo(int rows) {
  int h = 1;
  while (2 * h < rows) h *= 2;
  return h;
}

template <int R, typename T>
__device__ __forceinline__ Row<R, T> load_row(const PcrBuf<T>& buf, int k, int j) {
  const auto v = buf.q[k * buf.stride + buf.halo + j];
  Row<R, T> r;
  r.a = v.x;
  r.b = v.y;
  r.c = v.z;
  r.f[0] = v.w;
  if constexpr (R == 2) r.f[1] = buf.g[k * buf.stride + buf.halo + j];
  if constexpr (R == 3) {
    const auto w = buf.g2[k * buf.stride + buf.halo + j];
    r.f[1] = w.x;
    r.f[2] = w.y;
  }
  return r;
}

template <int R, typename T>
__device__ __forceinline__ void store_row(const PcrBuf<T>& buf, int k, int j,
                                          const Row<R, T>& r) {
  buf.q[k * buf.stride + buf.halo + j] = make4(r.a, r.b, r.c, r.f[0]);
  if constexpr (R == 2) buf.g[k * buf.stride + buf.halo + j] = r.f[1];
  if constexpr (R == 3)
    buf.g2[k * buf.stride + buf.halo + j] = make2(r.f[1], r.f[2]);
}

// Both buffers' rims to the identity row. Every thread calls it; a barrier
// must follow before the first stage.
template <int R, typename T>
__device__ void init_rims(const PcrBuf<T>& buf, int rows) {
  for (int e = threadIdx.x; e < 4 * buf.halo; e += blockDim.x) {
    const int k = e / (2 * buf.halo), j = e % (2 * buf.halo);
    const int at = k * buf.stride + (j < buf.halo ? j : rows + j);
    buf.q[at] = make4((T)0, (T)1, (T)0, (T)0);
    if constexpr (R == 2) buf.g[at] = (T)0;
    if constexpr (R == 3) buf.g2[at] = make2((T)0, (T)0);
  }
}

// x / y, correctly rounded. A zero x gives the same signed zero as a
// product: the division's fast path does not take a zero dividend, and
// the couplings of the last stages are mostly zeros.
template <typename T>
__device__ __forceinline__ T div_rn(T x, T y) {
  const T q = quot_rn(x == (T)0 ? (T)1 : x, y);
  return x == (T)0 ? mul_rn(x, y) : q;
}

// One PCR stage of row x against its partners m = row i - s and p = row
// i + s of the previous stage, in the TPU kernel's operation order.
template <int R, typename T>
__device__ __forceinline__ void pcr_stage(Row<R, T>& x, const Row<R, T>& m,
                                          const Row<R, T>& p) {
  const T alpha = div_rn(-x.a, m.b);
  const T gamma = div_rn(-x.c, p.b);
  x.b = add_rn(add_rn(x.b, mul_rn(alpha, m.c)), mul_rn(gamma, p.a));
#pragma unroll
  for (int r = 0; r < R; ++r) {
    x.f[r] = add_rn(add_rn(x.f[r], mul_rn(alpha, m.f[r])), mul_rn(gamma, p.f[r]));
  }
  x.a = mul_rn(alpha, m.a);
  x.c = mul_rn(gamma, p.c);
}

// Parallel cyclic reduction of a_i x_{i-1} + b_i x_i + c_i x_{i+1} = f_i,
// rows 0..rows-1 (rows = blockDim.x), thread i holding row i, for R
// right-hand sides that share the elimination coefficients. On return
// x.f[r] is the r-th solution at row i, and the returned buffer holds
// every row's final (a, b, c, f) (a = c = 0), readable by every thread
// until the next call's first barrier. Every thread of the block calls it.
template <int R, typename T>
__device__ int pcr_solve(Row<R, T>& x, const PcrBuf<T>& buf, int i, int rows) {
  int k = 0;
  for (int s = 1;; s <<= 1, k ^= 1) {
    store_row(buf, k, i, x);
    const bool coupled = __syncthreads_or(x.a != (T)0 || x.c != (T)0);
    if (!coupled || s >= rows) break;
    const Row<R, T> m = load_row<R>(buf, k, i - s);
    const Row<R, T> p = load_row<R>(buf, k, i + s);
    pcr_stage(x, m, p);
  }
#pragma unroll
  for (int r = 0; r < R; ++r) x.f[r] = quot_rn(x.f[r], x.b);
  return k;
}

// A fixed-order block sum of one double per thread, in two halves around
// one barrier. warp_partial: the warp's shuffle tree, lane 0's result into
// red[warp].
__device__ __forceinline__ void warp_partial(double x, double* red) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
}

// block_total, after the barrier: every warp sums the partials by the same
// shuffle tree and takes lane 0's total, so every thread gets the same
// bits.
__device__ __forceinline__ double block_total(const double* red) {
  const int lane = threadIdx.x & 31;
  double x = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.0;
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  return __shfl_sync(0xffffffffu, x, 0);
}

// Block-wide minimum over one barrier; every thread gets it. `red` holds
// 32 elements that nothing else uses in the launch.
template <typename T>
__device__ T block_min(T x, T* red) {
  const int lane = threadIdx.x & 31;
  for (int o = 16; o > 0; o >>= 1) x = min_of(x, __shfl_down_sync(0xffffffffu, x, o));
  if (lane == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  x = lane < (int)(blockDim.x >> 5) ? red[lane] : largest<T>();
  for (int o = 16; o > 0; o >>= 1) x = min_of(x, __shfl_down_sync(0xffffffffu, x, o));
  return __shfl_sync(0xffffffffu, x, 0);
}

// Dynamic shared memory: the stage buffers (the rows' four elements first,
// for alignment), then the second right-hand side's, then the shared copy
// of phi.
template <int R, typename T>
size_t pcr_smem(int rows) {
  const size_t stride = rows + 2 * pcr_halo(rows);
  return 2 * stride * (sizeof(typename Pcr<T>::V4) + (R == 2 ? sizeof(T) : 0) +
                       (R == 3 ? sizeof(typename Pcr<T>::V2) : 0));
}

template <int R, typename T>
size_t newton_smem(int rows) {
  return pcr_smem<R, T>(rows) + rows * sizeof(T);
}

template <int R, typename T>
__device__ __forceinline__ PcrBuf<T> carve(unsigned char* smem, int rows, T** s_phi) {
  PcrBuf<T> buf;
  buf.halo = pcr_halo(rows);
  buf.stride = rows + 2 * buf.halo;
  buf.q = reinterpret_cast<typename Pcr<T>::V4*>(smem);
  buf.g = reinterpret_cast<T*>(buf.q + 2 * buf.stride);
  buf.g2 = reinterpret_cast<typename Pcr<T>::V2*>(buf.q + 2 * buf.stride);
  *s_phi = buf.g + (R == 2 ? 2 * buf.stride : 0) + (R == 3 ? 4 * buf.stride : 0);
  return buf;
}

// The D-D Newton loop of newton_dd_kernel (header).
template <typename T>
__device__ __forceinline__ void newton_dd_loop(
    const T* __restrict__ rho, const T* __restrict__ n0, const T* __restrict__ phi0,
    T* __restrict__ phi_out, int* __restrict__ iters_out, T* __restrict__ resid_out,
    int ng, T c0_coef, T eps0, T c1, T dx2, T tol, int maxiter, T step_max,
    T exp_clamp) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows = blockDim.x;
  T* s_phi;
  const PcrBuf<T> buf = carve<1>(smem, rows, &s_phi);
  __shared__ double s_red[32];
  __shared__ T s_redf[32];
  const int i = threadIdx.x;
  const bool valid = i < ng;
  const bool interior = i >= 1 && i <= ng - 2;
  const bool boundary = valid && !interior;
  const T a_lap = interior ? (T)1 : (T)0;
  const T c_lap = a_lap;
  const T d_lap = interior ? (T)-2 : (T)1;
  const T c0 = mul_rn(c0_coef, n0[0]);
  const T c2 = valid ? quot_rn(rho[i], eps0) : (T)0;
  const T dx2_c0 = mul_rn(dx2, c0);
  const T dx2_c2 = mul_rn(dx2, c2);
  const T jac_b = mul_rn(mul_rn(-dx2, c0), c1);  // -dx^2 c0 c1
  T phi = (T)0;
  if (phi0 != nullptr && interior) phi = phi0[i];  // walls pinned to 0

  init_rims<1>(buf, rows);
  s_phi[i] = phi;
  __syncthreads();
  T residual = (T)1;
  int it = 0;
  while (residual > tol && it < maxiter) {
    const T down = i >= 1 ? s_phi[i - 1] : (T)0;
    const T up = i + 1 < rows ? s_phi[i + 1] : (T)0;
    const T expo = exp_of(clamp_to(mul_rn(c1, phi), -exp_clamp, exp_clamp));
    const T lap = add_rn(add_rn(mul_rn(a_lap, down), mul_rn(d_lap, phi)), mul_rn(c_lap, up));
    T f = add_rn(sub_rn(lap, mul_rn(dx2_c0, expo)), dx2_c2);
    f = interior ? f : (T)0;  // walls and padding: residual rows 0
    const T ddiag = interior ? mul_rn(jac_b, expo) : (boundary ? jac_b : (T)0);
    Row<1, T> x = {a_lap, add_rn(d_lap, ddiag), c_lap, {f}};
    pcr_solve<1>(x, buf, i, rows);
    const T dphi = clamp_to(x.f[0], -step_max, step_max);
    phi = sub_rn(phi, dphi);
    // the next iteration's phi and this one's partial sums, one barrier
    s_phi[i] = phi;
    warp_partial((double)mul_rn(dphi, dphi), s_red);
    __syncthreads();
    residual = (T)block_total(s_red);
    ++it;
  }
  // shift to min 0 over the physical rows (pygcpic.py:1053)
  const T lo = block_min(valid ? phi : largest<T>(), s_redf);
  if (valid) phi_out[i] = sub_rn(phi, lo);
  if (i == 0) {
    iters_out[0] = it;
    resid_out[0] = residual;
  }
}

// The D-N Newton loop (header). n: (ng,) number density; phi0: (ng,) warm
// start, taken as it is.
template <typename T>
__device__ __forceinline__ void newton_dn_loop(
    const T* __restrict__ n, const T* __restrict__ n0, const T* __restrict__ phi0,
    T* __restrict__ phi_out, int* __restrict__ iters_out, T* __restrict__ resid_out,
    int ng, T coef, T c1, T dx2, T tol, int maxiter, T step_max, T exp_clamp) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows = blockDim.x;
  T* s_phi;
  const PcrBuf<T> buf = carve<2>(smem, rows, &s_phi);
  __shared__ double s_red[32];
  __shared__ T s_redf[32];
  const int i = threadIdx.x;
  const bool valid = i < ng;
  const bool inner = i >= 1 && i <= ng - 2;
  const bool last = i == ng - 1;
  const T a_lap = inner ? (T)1 : (last ? (T)-4 : (T)0);
  const T c_lap = inner ? (T)1 : (T)0;
  const T d_lap = inner ? (T)-2 : (last ? (T)3 : (T)1);
  const T u_row = last ? (T)1 : (T)0;  // rank-1 u = e_{ng-1}
  const T c0 = mul_rn(coef, n0[0]);
  const T c2 = valid ? mul_rn(n[i], coef) : (T)0;
  const T dx2_c0 = mul_rn(dx2, c0);
  const T dx2_c2 = mul_rn(dx2, c2);
  const T jac_b = mul_rn(mul_rn(-dx2, c0), c1);  // -dx^2 c0 c1
  T phi = valid ? phi0[i] : (T)0;

  init_rims<2>(buf, rows);
  s_phi[i] = phi;
  __syncthreads();
  T residual = (T)1;
  int it = 0;
  while (residual > tol && it < maxiter) {
    const T down = i >= 1 ? s_phi[i - 1] : (T)0;
    const T up = i + 1 < rows ? s_phi[i + 1] : (T)0;
    const T phi_m3 = s_phi[ng - 3];
    const T phi_0 = s_phi[0];
    const T expo = exp_of(clamp_to(mul_rn(c1, phi), -exp_clamp, exp_clamp));
    T lap = add_rn(add_rn(mul_rn(a_lap, down), mul_rn(d_lap, phi)), mul_rn(c_lap, up));
    lap = add_rn(lap, mul_rn(u_row, phi_m3));  // A[-1, -3]
    T f = add_rn(sub_rn(lap, mul_rn(dx2_c0, expo)), dx2_c2);
    f = i == 0 ? phi_0 : f;
    f = (last || !valid) ? (T)0 : f;
    const T ddiag = inner ? mul_rn(jac_b, expo) : (i == 0 ? jac_b : (T)0);
    Row<2, T> x = {a_lap, add_rn(d_lap, ddiag), c_lap, {f, u_row}};
    const int k = pcr_solve<2>(x, buf, i, rows);
    // y[ng-3] and z[ng-3] from row ng-3's final (b, f), as its thread forms them
    const Row<2, T> m3 = load_row<2>(buf, k, ng - 3);
    const T vy = quot_rn(m3.f[0], m3.b), vz = quot_rn(m3.f[1], m3.b);
    T dphi = sub_rn(x.f[0], mul_rn(x.f[1], quot_rn(vy, add_rn((T)1, vz))));
    dphi = clamp_to(dphi, -step_max, step_max);
    phi = sub_rn(phi, dphi);
    s_phi[i] = phi;
    warp_partial((double)mul_rn(dphi, dphi), s_red);
    __syncthreads();
    residual = sqrt_rn((T)block_total(s_red));
    ++it;
  }
  const T lo = block_min(valid ? phi : largest<T>(), s_redf);
  if (valid) phi_out[i] = sub_rn(phi, lo);
  if (i == 0) {
    iters_out[0] = it;
    resid_out[0] = residual;
  }
}

// The one-CTA Newton kernels: the float ones as they were first written
// (no launch bounds: their code is the one they compiled to), the double
// ones capped at 64 registers a thread (__launch_bounds__(1024)), so that
// a CTA of 1,024 rows of doubles launches.
template <typename T>
__global__ void newton_dd_kernel(const T* __restrict__ rho, const T* __restrict__ n0,
                                 const T* __restrict__ phi0, T* __restrict__ phi_out,
                                 int* __restrict__ iters_out, T* __restrict__ resid_out,
                                 int ng, T c0_coef, T eps0, T c1, T dx2, T tol,
                                 int maxiter, T step_max, T exp_clamp) {
  newton_dd_loop(rho, n0, phi0, phi_out, iters_out, resid_out, ng, c0_coef, eps0, c1, dx2,
                 tol, maxiter, step_max, exp_clamp);
}

template <>
__global__ void __launch_bounds__(1024) newton_dd_kernel<double>(
    const double* __restrict__ rho, const double* __restrict__ n0,
    const double* __restrict__ phi0, double* __restrict__ phi_out,
    int* __restrict__ iters_out, double* __restrict__ resid_out, int ng, double c0_coef,
    double eps0, double c1, double dx2, double tol, int maxiter, double step_max,
    double exp_clamp) {
  newton_dd_loop(rho, n0, phi0, phi_out, iters_out, resid_out, ng, c0_coef, eps0, c1, dx2,
                 tol, maxiter, step_max, exp_clamp);
}

template <typename T>
__global__ void newton_dn_kernel(const T* __restrict__ n, const T* __restrict__ n0,
                                 const T* __restrict__ phi0, T* __restrict__ phi_out,
                                 int* __restrict__ iters_out, T* __restrict__ resid_out,
                                 int ng, T coef, T c1, T dx2, T tol, int maxiter,
                                 T step_max, T exp_clamp) {
  newton_dn_loop(n, n0, phi0, phi_out, iters_out, resid_out, ng, coef, c1, dx2, tol,
                 maxiter, step_max, exp_clamp);
}

template <>
__global__ void __launch_bounds__(1024) newton_dn_kernel<double>(
    const double* __restrict__ n, const double* __restrict__ n0,
    const double* __restrict__ phi0, double* __restrict__ phi_out,
    int* __restrict__ iters_out, double* __restrict__ resid_out, int ng, double coef,
    double c1, double dx2, double tol, int maxiter, double step_max, double exp_clamp) {
  newton_dn_loop(n, n0, phi0, phi_out, iters_out, resid_out, ng, coef, c1, dx2, tol,
                 maxiter, step_max, exp_clamp);
}

// One rank's local system of the distributed chain solve
// (parallel.distributed_poisson.make_distributed_tridiag_chain): the (c,)
// rows a_i x_(i-1) + b_i x_i + c_i x_(i+1) = f_i with the couplings to the
// neighbouring slabs removed (a_0 = c_(c-1) = 0), solved for three
// right-hand sides that share the elimination, [f, e_0, e_(c-1)]: the
// particular solution xp and the boundary responses u and w. One CTA of
// rows = c rounded up to 32 threads, a row a thread, by the Newton
// kernels' PCR (pcr_solve: float4 rows in alternating buffers, one barrier
// a stage, the __syncthreads_or early end, div_rn), all three columns
// carried through one elimination. Row i of x is x[r * c + i] for column
// r. The threads of rows 0 and c - 1 also write the rank's six interface
// scalars [xp_0, xp_(c-1), a0 u_0, a0 u_(c-1), cc w_0, cc w_(c-1)]
// (a0 = dl[0] unless the rank is the chain's first, cc = du[c-1] unless
// its last), which the ranks all_gather for the interface solve. Float32
// alone: the slab engines run float32 in the JAX package.
__global__ void tridiag3_chain_kernel(const float* __restrict__ dl,
                                      const float* __restrict__ d,
                                      const float* __restrict__ du,
                                      const float* __restrict__ f,
                                      float* __restrict__ x,
                                      float* __restrict__ g6, int c,
                                      int first, int last) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows = blockDim.x;
  float* unused;
  const PcrBuf<float> buf = carve<3>(smem, rows, &unused);
  const int i = threadIdx.x;
  const bool valid = i < c;
  Row<3, float> r;
  r.a = (valid && i > 0) ? dl[i] : 0.0f;
  r.b = valid ? d[i] : 1.0f;
  r.c = (valid && i < c - 1) ? du[i] : 0.0f;
  r.f[0] = valid ? f[i] : 0.0f;
  r.f[1] = i == 0 ? 1.0f : 0.0f;
  r.f[2] = i == c - 1 ? 1.0f : 0.0f;
  init_rims<3>(buf, rows);
  __syncthreads();
  pcr_solve<3>(r, buf, i, rows);
  if (!valid) return;
  x[i] = r.f[0];
  x[c + i] = r.f[1];
  x[2 * c + i] = r.f[2];
  if (i == 0) {
    const float a0 = first ? 0.0f : dl[0];
    g6[0] = r.f[0];
    g6[2] = __fmul_rn(a0, r.f[1]);
    g6[4] = __fmul_rn(last ? 0.0f : du[c - 1], r.f[2]);
  }
  if (i == c - 1) {
    const float cc = last ? 0.0f : du[c - 1];
    g6[1] = r.f[0];
    g6[3] = __fmul_rn(first ? 0.0f : dl[0], r.f[1]);
    g6[5] = __fmul_rn(cc, r.f[2]);
  }
}

bool rows_ok(int ng, int rows) {
  return rows >= 32 && rows <= kMaxRows && rows % 32 == 0 && ng <= rows;
}

// ---- the large path (header) ----

// The Newton loop's scalars (cuda_newton.newton_scalars, in the state's
// dtype; coef = e / eps0 in it, eps0 the D-D kernel's divisor of rho).
template <typename T>
struct NewtonScalars {
  T coef, eps0, c1, dx2, tol, step_max, exp_clamp;
  int maxiter;
};

// The block rows of the large path in its scratch: row j of thread t at
// j T + t (T = blockDim.x). ap, cp: the couplings a', c' the sweeps leave;
// dp: R columns of d', column r at r npad.
template <typename T>
struct Blocks {
  T* ap;
  T* cp;
  T* dp;
  int k, npad;
};

__device__ __forceinline__ int block_at(int j) {
  return j * (int)blockDim.x + (int)threadIdx.x;
}

// The sweep down the thread's k rows, row(j) giving row j's (a, b, c, f).
// Rows 0 and 1 are normalised by b; row j >= 2 takes its coupling to row
// j - 1 out with that row, the fill-in a coupling to the block's row 0.
// After it row 0 reads a'_0 x_(-1) + x_0 + c'_0 x_1 = d'_0 and row j >= 1
// a'_j x_0 + x_j + c'_j x_(j+1) = d'_j.
template <int R, typename T, class RowAt>
__device__ __forceinline__ void sweep_down(const Blocks<T>& B, RowAt row) {
  T am = (T)0, cm = (T)0, dm[R];
#pragma unroll
  for (int r = 0; r < R; ++r) dm[r] = (T)0;
  for (int j = 0; j < B.k; ++j) {
    const Row<R, T> x = row(j);
    T an, cn, dn[R];
    if (j < 2) {
      an = div_rn(x.a, x.b);
      cn = div_rn(x.c, x.b);
#pragma unroll
      for (int r = 0; r < R; ++r) dn[r] = div_rn(x.f[r], x.b);
    } else {
      const T den = sub_rn(x.b, mul_rn(x.a, cm));
      an = div_rn(-mul_rn(x.a, am), den);
      cn = div_rn(x.c, den);
#pragma unroll
      for (int r = 0; r < R; ++r) dn[r] = div_rn(sub_rn(x.f[r], mul_rn(x.a, dm[r])), den);
    }
    const int e = block_at(j);
    B.ap[e] = an;
    B.cp[e] = cn;
#pragma unroll
    for (int r = 0; r < R; ++r) B.dp[r * B.npad + e] = dn[r];
    am = an;
    cm = cn;
#pragma unroll
    for (int r = 0; r < R; ++r) dm[r] = dn[r];
  }
}

// The sweep up: rows k - 3 .. 1 take out their coupling to the row below
// (which then reads a' x_0 + x + c' x_(k-1)), then row 0 its coupling to
// row 1. Returns the block's two rows of the reduced system: first
// (coupled to the last row of the block before and to x_(k-1)) and last
// (coupled to x_0 and to the first row of the block after), b = 1.
template <int R, typename T>
__device__ __forceinline__ void sweep_up(const Blocks<T>& B, Row<R, T>& first,
                                         Row<R, T>& last) {
  const int k = B.k;
  int e = block_at(k - 1);
  last.a = B.ap[e];
  last.b = (T)1;
  last.c = B.cp[e];
#pragma unroll
  for (int r = 0; r < R; ++r) last.f[r] = B.dp[r * B.npad + e];
  e = block_at(0);
  first.a = B.ap[e];
  first.b = (T)1;
  first.c = B.cp[e];
#pragma unroll
  for (int r = 0; r < R; ++r) first.f[r] = B.dp[r * B.npad + e];
  if (k == 2) return;  // row 0 already couples to x_(k-1)
  e = block_at(k - 2);
  T an = B.ap[e], cn = B.cp[e], dn[R];
#pragma unroll
  for (int r = 0; r < R; ++r) dn[r] = B.dp[r * B.npad + e];
  for (int j = k - 3; j >= 1; --j) {
    e = block_at(j);
    const T cj = B.cp[e];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      dn[r] = sub_rn(B.dp[r * B.npad + e], mul_rn(cj, dn[r]));
      B.dp[r * B.npad + e] = dn[r];
    }
    an = sub_rn(B.ap[e], mul_rn(cj, an));
    cn = -mul_rn(cj, cn);
    B.ap[e] = an;
    B.cp[e] = cn;
  }
  const T c0 = first.c;
  const T den = sub_rn((T)1, mul_rn(c0, an));
  first.a = div_rn(first.a, den);
  first.c = div_rn(-mul_rn(c0, cn), den);
#pragma unroll
  for (int r = 0; r < R; ++r) first.f[r] = div_rn(sub_rn(first.f[r], mul_rn(c0, dn[r])), den);
}

// Row j of the thread's block from the block's end values xf = x_0 and
// xl = x_(k-1) (R columns): x_j = d'_j - a'_j x_0 - c'_j x_(k-1).
template <int R, typename T>
__device__ __forceinline__ void recover(const Blocks<T>& B, int j, const T* xf,
                                        const T* xl, T* out) {
  if (j == 0 || j == B.k - 1) {
#pragma unroll
    for (int r = 0; r < R; ++r) out[r] = j == 0 ? xf[r] : xl[r];
    return;
  }
  const int e = block_at(j);
  const T a = B.ap[e], c = B.cp[e];
#pragma unroll
  for (int r = 0; r < R; ++r)
    out[r] = sub_rn(sub_rn(B.dp[r * B.npad + e], mul_rn(a, xf[r])), mul_rn(c, xl[r]));
}

// The reduced system's PCR over rows = 2 T rows, thread t holding rows
// 2 t (its block's first) and 2 t + 1 (its last): pcr_solve's stage loop
// (alternating buffers, one vote-ended barrier a stage, pcr_stage's
// arithmetic) for two rows a thread. On return x0.f and x1.f hold the two
// rows' solutions. Every thread of the block calls it.
template <int R, typename T>
__device__ void pcr_solve_pair(Row<R, T>& x0, Row<R, T>& x1, const PcrBuf<T>& buf,
                               int rows) {
  const int i0 = 2 * (int)threadIdx.x, i1 = i0 + 1;
  int kb = 0;
  for (int s = 1;; s <<= 1, kb ^= 1) {
    store_row(buf, kb, i0, x0);
    store_row(buf, kb, i1, x1);
    const bool live = __syncthreads_or(x0.a != (T)0 || x0.c != (T)0 || x1.a != (T)0 ||
                                       x1.c != (T)0);
    if (!live || s >= rows) break;
    pcr_stage(x0, load_row<R>(buf, kb, i0 - s), load_row<R>(buf, kb, i0 + s));
    pcr_stage(x1, load_row<R>(buf, kb, i1 - s), load_row<R>(buf, kb, i1 + s));
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    x0.f[r] = quot_rn(x0.f[r], x0.b);
    x1.f[r] = quot_rn(x1.f[r], x1.b);
  }
}

// The scratch of a Newton kernel: phi, dx^2 c2, then the blocks' a', c'
// and R columns of d', npad elements each.
template <typename T>
__device__ __forceinline__ Blocks<T> newton_blocks(T* scratch, int k, int npad) {
  return Blocks<T>{scratch + 2 * npad, scratch + 3 * npad, scratch + 4 * npad, k, npad};
}

// The smallest phi of the thread's physical rows (the largest value if none).
template <typename T>
__device__ __forceinline__ T block_rows_min(const T* phi_s, int k, int ng) {
  T lo = largest<T>();
  for (int j = 0; j < k && (int)threadIdx.x * k + j < ng; ++j)
    lo = min_of(lo, phi_s[block_at(j)]);
  return lo;
}

// newton_dd_kernel's loop above 1,024 rows (header: the large path).
// scratch: 5 npad elements (npad = T k).
template <typename T>
__global__ void __launch_bounds__(1024)
    newton_dd_large_kernel(const T* __restrict__ rho, const T* __restrict__ n0,
                           const T* __restrict__ phi0, T* __restrict__ phi_out,
                           int* __restrict__ iters_out, T* __restrict__ resid_out,
                           T* __restrict__ scratch, int ng, int k, NewtonScalars<T> s) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int T_ = blockDim.x, t = threadIdx.x, npad = T_ * k;
  T* s_edge;  // [T] each block's first phi, then [T] its last
  const PcrBuf<T> buf = carve<1>(smem, 2 * T_, &s_edge);
  T* s_lo = s_edge;
  T* s_hi = s_edge + T_;
  __shared__ double s_red[32];
  __shared__ T s_redf[32];
  T* phi_s = scratch;
  T* c2_s = scratch + npad;  // dx^2 c2
  const Blocks<T> B = newton_blocks(scratch, k, npad);
  const T c0 = mul_rn(s.coef, n0[0]);
  const T dx2_c0 = mul_rn(s.dx2, c0);
  const T jac_b = mul_rn(mul_rn(-s.dx2, c0), s.c1);
  for (int e = t; e < npad; e += T_) {  // rows in order, into the blocks
    const int j = e % k, o = j * T_ + e / k;
    const T p = (phi0 != nullptr && e >= 1 && e <= ng - 2) ? phi0[e] : (T)0;
    phi_s[o] = p;
    c2_s[o] = e < ng ? mul_rn(s.dx2, quot_rn(rho[e], s.eps0)) : (T)0;
    if (j == 0) s_lo[e / k] = p;
    if (j == k - 1) s_hi[e / k] = p;
  }
  init_rims<1>(buf, 2 * T_);
  __syncthreads();
  T residual = (T)1;
  int it = 0;
  while (it < s.maxiter && residual > s.tol) {
    T down = t > 0 ? s_hi[t - 1] : (T)0;
    T cur = phi_s[t];
    sweep_down<1>(B, [&](int j) {
      const int i = t * k + j;
      const T up = j + 1 < k ? phi_s[block_at(j + 1)] : (t + 1 < T_ ? s_lo[t + 1] : (T)0);
      const bool interior = i >= 1 && i <= ng - 2;
      const bool boundary = i < ng && !interior;
      const T a_lap = interior ? (T)1 : (T)0;
      const T d_lap = interior ? (T)-2 : (T)1;
      const T ex = exp_of(clamp_to(mul_rn(s.c1, cur), -s.exp_clamp, s.exp_clamp));
      const T lap =
          add_rn(add_rn(mul_rn(a_lap, down), mul_rn(d_lap, cur)), mul_rn(a_lap, up));
      const T f = add_rn(sub_rn(lap, mul_rn(dx2_c0, ex)), c2_s[block_at(j)]);
      Row<1, T> x;
      x.a = a_lap;
      x.b = add_rn(d_lap, interior ? mul_rn(jac_b, ex) : (boundary ? jac_b : (T)0));
      x.c = a_lap;
      x.f[0] = interior ? f : (T)0;  // walls and padding: residual rows 0
      down = cur;
      cur = up;
      return x;
    });
    Row<1, T> x0, x1;
    sweep_up<1>(B, x0, x1);
    pcr_solve_pair<1>(x0, x1, buf, 2 * T_);
    double sq = 0.0;
    for (int j = 0; j < k; ++j) {
      T x;
      recover<1>(B, j, x0.f, x1.f, &x);
      const T dphi = clamp_to(x, -s.step_max, s.step_max);
      const int e = block_at(j);
      const T p = sub_rn(phi_s[e], dphi);
      phi_s[e] = p;
      sq += (double)mul_rn(dphi, dphi);
      if (j == 0) s_lo[t] = p;
      if (j == k - 1) s_hi[t] = p;
    }
    // the next iteration's edge phi and this one's partial sums, one barrier
    warp_partial(sq, s_red);
    __syncthreads();
    residual = (T)block_total(s_red);
    ++it;
  }
  const T lo = block_min(block_rows_min(phi_s, k, ng), s_redf);
  for (int e = t; e < ng; e += T_) phi_out[e] = sub_rn(phi_s[(e % k) * T_ + e / k], lo);
  if (t == 0) {
    iters_out[0] = it;
    resid_out[0] = residual;
  }
}

// newton_dn_kernel's loop above 1,024 rows (header: the large path).
// scratch: 6 npad elements.
template <typename T>
__global__ void __launch_bounds__(1024)
    newton_dn_large_kernel(const T* __restrict__ n, const T* __restrict__ n0,
                           const T* __restrict__ phi0, T* __restrict__ phi_out,
                           int* __restrict__ iters_out, T* __restrict__ resid_out,
                           T* __restrict__ scratch, int ng, int k, NewtonScalars<T> s) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int T_ = blockDim.x, t = threadIdx.x, npad = T_ * k;
  T* s_edge;
  const PcrBuf<T> buf = carve<2>(smem, 2 * T_, &s_edge);
  T* s_lo = s_edge;
  T* s_hi = s_edge + T_;
  __shared__ double s_red[32];
  __shared__ T s_redf[32];
  __shared__ T s_m3[3];  // phi[ng-3]; then y[ng-3], z[ng-3]
  T* phi_s = scratch;
  T* c2_s = scratch + npad;  // dx^2 c2
  const Blocks<T> B = newton_blocks(scratch, k, npad);
  const int t3 = (ng - 3) / k, j3 = (ng - 3) % k;
  const T c0 = mul_rn(s.coef, n0[0]);
  const T dx2_c0 = mul_rn(s.dx2, c0);
  const T jac_b = mul_rn(mul_rn(-s.dx2, c0), s.c1);
  for (int e = t; e < npad; e += T_) {
    const int j = e % k, o = j * T_ + e / k;
    const T p = e < ng ? phi0[e] : (T)0;
    phi_s[o] = p;
    c2_s[o] = e < ng ? mul_rn(s.dx2, mul_rn(n[e], s.coef)) : (T)0;
    if (j == 0) s_lo[e / k] = p;
    if (j == k - 1) s_hi[e / k] = p;
    if (e == ng - 3) s_m3[0] = p;
  }
  init_rims<2>(buf, 2 * T_);
  __syncthreads();
  T residual = (T)1;
  int it = 0;
  while (it < s.maxiter && residual > s.tol) {
    const T phi_m3 = s_m3[0], phi_first = s_lo[0];
    T down = t > 0 ? s_hi[t - 1] : (T)0;
    T cur = phi_s[t];
    sweep_down<2>(B, [&](int j) {
      const int i = t * k + j;
      const T up = j + 1 < k ? phi_s[block_at(j + 1)] : (t + 1 < T_ ? s_lo[t + 1] : (T)0);
      const bool inner = i >= 1 && i <= ng - 2;
      const bool last = i == ng - 1;
      const T a_lap = inner ? (T)1 : (last ? (T)-4 : (T)0);
      const T c_lap = inner ? (T)1 : (T)0;
      const T d_lap = inner ? (T)-2 : (last ? (T)3 : (T)1);
      const T u_row = last ? (T)1 : (T)0;  // rank-1 u = e_{ng-1}
      const T ex = exp_of(clamp_to(mul_rn(s.c1, cur), -s.exp_clamp, s.exp_clamp));
      T lap = add_rn(add_rn(mul_rn(a_lap, down), mul_rn(d_lap, cur)), mul_rn(c_lap, up));
      lap = add_rn(lap, mul_rn(u_row, phi_m3));  // A[-1, -3]
      T f = add_rn(sub_rn(lap, mul_rn(dx2_c0, ex)), c2_s[block_at(j)]);
      f = i == 0 ? phi_first : f;
      f = (last || i >= ng) ? (T)0 : f;
      Row<2, T> x;
      x.a = a_lap;
      x.b = add_rn(d_lap, inner ? mul_rn(jac_b, ex) : (i == 0 ? jac_b : (T)0));
      x.c = c_lap;
      x.f[0] = f;
      x.f[1] = u_row;
      down = cur;
      cur = up;
      return x;
    });
    Row<2, T> x0, x1;
    sweep_up<2>(B, x0, x1);
    pcr_solve_pair<2>(x0, x1, buf, 2 * T_);
    if (t == t3) {  // y[ng-3] and z[ng-3] from their owning thread
      T yz[2];
      recover<2>(B, j3, x0.f, x1.f, yz);
      s_m3[1] = yz[0];
      s_m3[2] = yz[1];
    }
    __syncthreads();
    const T corr = quot_rn(s_m3[1], add_rn((T)1, s_m3[2]));
    double sq = 0.0;
    for (int j = 0; j < k; ++j) {
      T yz[2];
      recover<2>(B, j, x0.f, x1.f, yz);
      T dphi = sub_rn(yz[0], mul_rn(yz[1], corr));
      dphi = clamp_to(dphi, -s.step_max, s.step_max);
      const int e = block_at(j);
      const T p = sub_rn(phi_s[e], dphi);
      phi_s[e] = p;
      sq += (double)mul_rn(dphi, dphi);
      if (j == 0) s_lo[t] = p;
      if (j == k - 1) s_hi[t] = p;
      if (t == t3 && j == j3) s_m3[0] = p;
    }
    warp_partial(sq, s_red);
    __syncthreads();
    residual = sqrt_rn((T)block_total(s_red));
    ++it;
  }
  const T lo = block_min(block_rows_min(phi_s, k, ng), s_redf);
  for (int e = t; e < ng; e += T_) phi_out[e] = sub_rn(phi_s[(e % k) * T_ + e / k], lo);
  if (t == 0) {
    iters_out[0] = it;
    resid_out[0] = residual;
  }
}

// tridiag3_chain_kernel above 1,024 rows (header: the large path): the
// rank's (c,) system for [f, e_0, e_(c-1)] by the partition solve, the
// inputs read and x written in row order. scratch: 5 npad floats (a', c'
// and three columns of d').
__global__ void __launch_bounds__(1024)
    tridiag3_chain_large_kernel(const float* __restrict__ dl,
                                const float* __restrict__ d,
                                const float* __restrict__ du,
                                const float* __restrict__ f,
                                float* __restrict__ x,
                                float* __restrict__ g6,
                                float* __restrict__ scratch, int c, int k,
                                int first, int last) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int T = blockDim.x, t = threadIdx.x, npad = T * k;
  float* unused;
  const PcrBuf<float> buf = carve<3>(smem, 2 * T, &unused);
  const Blocks<float> B{scratch, scratch + npad, scratch + 2 * npad, k, npad};
  init_rims<3>(buf, 2 * T);  // read only after the PCR's first barrier
  sweep_down<3>(B, [&](int j) {
    const int i = t * k + j;
    const bool valid = i < c;
    Row<3, float> r;
    r.a = (valid && i > 0) ? dl[i] : 0.0f;
    r.b = valid ? d[i] : 1.0f;
    r.c = (valid && i < c - 1) ? du[i] : 0.0f;
    r.f[0] = valid ? f[i] : 0.0f;
    r.f[1] = i == 0 ? 1.0f : 0.0f;
    r.f[2] = i == c - 1 ? 1.0f : 0.0f;
    return r;
  });
  Row<3, float> x0, x1;
  sweep_up<3>(B, x0, x1);
  pcr_solve_pair<3>(x0, x1, buf, 2 * T);
  for (int j = 0; j < k && t * k + j < c; ++j) {
    const int i = t * k + j;
    float v[3];
    recover<3>(B, j, x0.f, x1.f, v);
    x[i] = v[0];
    x[c + i] = v[1];
    x[2 * c + i] = v[2];
    if (i == 0) {
      g6[0] = v[0];
      g6[2] = __fmul_rn(first ? 0.0f : dl[0], v[1]);
      g6[4] = __fmul_rn(last ? 0.0f : du[c - 1], v[2]);
    }
    if (i == c - 1) {
      g6[1] = v[0];
      g6[3] = __fmul_rn(first ? 0.0f : dl[0], v[1]);
      g6[5] = __fmul_rn(last ? 0.0f : du[c - 1], v[2]);
    }
  }
}

// ---- the large path's cluster mode (header) ----

constexpr int kClusterMax = 16;  // cuda_newton.CLUSTER_MAX (16: non-portable)
constexpr int kClusterThreads = 512;  // threads a CTA at most
constexpr int kIngredients = 12;  // D-N: row ng - 3's recovery, pushed by its owner

// A CTA's PCR buffers in the cluster mode: two of `rows` rows, no rims (a
// row read outside [0, rows) is the identity row). q holds (a, b, c, f[0]),
// g the columns f[1..NC-1], each a plane of rows.
template <int NC, typename T>
struct PlaneBuf {
  typename Pcr<T>::V4* q;
  T* g;
  int rows;
};

template <int NC, typename T>
__device__ __forceinline__ Row<NC, T> identity_row() {
  Row<NC, T> r;
  r.a = (T)0;
  r.b = (T)1;
  r.c = (T)0;
#pragma unroll
  for (int c = 0; c < NC; ++c) r.f[c] = (T)0;
  return r;
}

template <int NC, typename T>
__device__ __forceinline__ Row<NC, T> load_row(const PlaneBuf<NC, T>& buf, int kb, int j) {
  const bool in = j >= 0 && j < buf.rows;
  const int at = in ? j : 0;
  const auto v = buf.q[kb * buf.rows + at];
  Row<NC, T> r;
  r.a = in ? v.x : (T)0;
  r.b = in ? v.y : (T)1;
  r.c = in ? v.z : (T)0;
  r.f[0] = in ? v.w : (T)0;
#pragma unroll
  for (int c = 1; c < NC; ++c)
    r.f[c] = in ? buf.g[((kb * (NC - 1)) + c - 1) * buf.rows + at] : (T)0;
  return r;
}

template <int NC, typename T>
__device__ __forceinline__ void store_row(const PlaneBuf<NC, T>& buf, int kb, int j,
                                          const Row<NC, T>& r) {
  buf.q[kb * buf.rows + j] = make4(r.a, r.b, r.c, r.f[0]);
#pragma unroll
  for (int c = 1; c < NC; ++c) buf.g[((kb * (NC - 1)) + c - 1) * buf.rows + j] = r.f[c];
}

// pcr_solve_pair's stage loop on a PlaneBuf: rows = 2 T, thread t holding
// rows 2 t and 2 t + 1, the vote-ended stages, pcr_stage's arithmetic.
template <int NC, typename T>
__device__ void pcr_solve_pair(Row<NC, T>& x0, Row<NC, T>& x1, const PlaneBuf<NC, T>& buf) {
  const int i0 = 2 * (int)threadIdx.x, i1 = i0 + 1;
  int kb = 0;
  for (int s = 1;; s <<= 1, kb ^= 1) {
    store_row(buf, kb, i0, x0);
    store_row(buf, kb, i1, x1);
    const bool live = __syncthreads_or(x0.a != (T)0 || x0.c != (T)0 || x1.a != (T)0 ||
                                       x1.c != (T)0);
    if (!live || s >= buf.rows) break;
    pcr_stage(x0, load_row(buf, kb, i0 - s), load_row(buf, kb, i0 + s));
    pcr_stage(x1, load_row(buf, kb, i1 - s), load_row(buf, kb, i1 + s));
  }
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    x0.f[c] = quot_rn(x0.f[c], x0.b);
    x1.f[c] = quot_rn(x1.f[c], x1.b);
  }
}

// The cluster's system of `rows` = 2 C rows (C <= 16) solved by one warp,
// lane l holding row l (lanes past the rows identity rows): the PCR
// stages of pcr_solve by shuffles, vote-ended (__any_sync). Every warp of
// every CTA calls it on the same rows and gets the same bits; lane l
// returns row l's solution.
template <int R, typename T>
__device__ Row<R, T> warp_pcr(const T* rows_in, int rows) {
  const int lane = threadIdx.x & 31;
  Row<R, T> x = identity_row<R, T>();
  if (lane < rows) {
    const T* p = rows_in + lane * (3 + R);
    x.a = p[0];
    x.b = p[1];
    x.c = p[2];
#pragma unroll
    for (int c = 0; c < R; ++c) x.f[c] = p[3 + c];
  }
  for (int s = 1; s < rows; s <<= 1) {
    if (!__any_sync(0xffffffffu, x.a != (T)0 || x.c != (T)0)) break;
    Row<R, T> lo, hi;
    lo.a = __shfl_up_sync(0xffffffffu, x.a, s);
    lo.b = __shfl_up_sync(0xffffffffu, x.b, s);
    lo.c = __shfl_up_sync(0xffffffffu, x.c, s);
    hi.a = __shfl_down_sync(0xffffffffu, x.a, s);
    hi.b = __shfl_down_sync(0xffffffffu, x.b, s);
    hi.c = __shfl_down_sync(0xffffffffu, x.c, s);
#pragma unroll
    for (int c = 0; c < R; ++c) {
      lo.f[c] = __shfl_up_sync(0xffffffffu, x.f[c], s);
      hi.f[c] = __shfl_down_sync(0xffffffffu, x.f[c], s);
    }
    if (lane < s) lo = identity_row<R, T>();
    if (lane + s >= rows) hi = identity_row<R, T>();
    pcr_stage(x, lo, hi);
  }
#pragma unroll
  for (int c = 0; c < R; ++c) x.f[c] = quot_rn(x.f[c], x.b);
  return x;
}

// A row's value from its CTA's end values F and L: y - p F - q L.
template <typename T>
__device__ __forceinline__ T end_value(T y, T p, T q, T F, T L) {
  return sub_rn(sub_rn(y, mul_rn(p, F)), mul_rn(q, L));
}

// The dynamic shared memory of a cluster-mode CTA, each region 16-B
// aligned: the partials pushed ([parity][rank], double), the warp
// partials (32 double), the cluster's rows pushed ([parity][rank][F, L][a,
// b, c, f[R]]), the D-N ingredients ([parity][12]), the CTAs' minima, the
// block minimum's partials, the PCR buffers (2 x 2 T rows: a V4 and R + 1
// planes), each thread's first and last phi, and in the shared variant
// the rows' scratch ((4 + R) T k). cuda_newton.cluster_smem mirrors it.
template <int R, typename T>
struct ClusterSmem {
  double* part;
  double* red;
  T* recv;
  T* ing;
  T* mins;
  T* redf;
  PlaneBuf<R + 2, T> pcr;
  T* s_lo;
  T* s_hi;
  T* rows;
};

__host__ __device__ __forceinline__ size_t align16(size_t b) { return (b + 15) & ~(size_t)15; }

// Takes `bytes` (16-B aligned) at offset `at` of `base`; returns where.
__host__ __device__ __forceinline__ unsigned char* take(unsigned char* base, size_t& at,
                                                       size_t bytes) {
  unsigned char* p = base + at;
  at += align16(bytes);
  return p;
}

template <int R, typename T>
__host__ __device__ size_t cluster_layout(int C, int threads, int k, bool shared,
                                          ClusterSmem<R, T>* m, unsigned char* base) {
  size_t at = 0;
  unsigned char* part = take(base, at, 2 * kClusterMax * sizeof(double));
  unsigned char* red = take(base, at, 32 * sizeof(double));
  unsigned char* recv = take(base, at, (size_t)2 * C * 2 * (3 + R) * sizeof(T));
  unsigned char* ing = take(base, at, R == 2 ? 2 * kIngredients * sizeof(T) : 0);
  unsigned char* mins = take(base, at, kClusterMax * sizeof(T));
  unsigned char* redf = take(base, at, 32 * sizeof(T));
  unsigned char* q = take(base, at, (size_t)2 * 2 * threads * sizeof(typename Pcr<T>::V4));
  unsigned char* g = take(base, at, (size_t)2 * (R + 1) * 2 * threads * sizeof(T));
  unsigned char* lo = take(base, at, (size_t)2 * threads * sizeof(T));
  unsigned char* rows = take(base, at, shared ? (size_t)(4 + R) * threads * k * sizeof(T) : 0);
  if (m != nullptr) {
    m->part = reinterpret_cast<double*>(part);
    m->red = reinterpret_cast<double*>(red);
    m->recv = reinterpret_cast<T*>(recv);
    m->ing = reinterpret_cast<T*>(ing);
    m->mins = reinterpret_cast<T*>(mins);
    m->redf = reinterpret_cast<T*>(redf);
    m->pcr.q = reinterpret_cast<typename Pcr<T>::V4*>(q);
    m->pcr.g = reinterpret_cast<T*>(g);
    m->pcr.rows = 2 * threads;
    m->s_lo = reinterpret_cast<T*>(lo);
    m->s_hi = m->s_lo + threads;
    m->rows = reinterpret_cast<T*>(rows);
  }
  return at;
}

template <int R, typename T>
size_t cluster_smem(int C, int threads, int k, bool shared) {
  return cluster_layout<R, T>(C, threads, k, shared, nullptr, nullptr);
}

// The Newton loop of newton_dd_large_kernel (R = 1) and
// newton_dn_large_kernel (R = 2) in the cluster mode (header: the
// cluster mode). kShared: the rows' scratch in the CTA's shared memory,
// else CTA r's (4 + R) T k elements of `scratch` from r (4 + R) T k.
template <int R, bool kShared, typename T>
__global__ void __launch_bounds__(kClusterThreads)
    newton_cluster_kernel(const T* __restrict__ dens, const T* __restrict__ n0,
                          const T* __restrict__ phi0, T* __restrict__ phi_out,
                          int* __restrict__ iters_out, T* __restrict__ resid_out,
                          T* __restrict__ scratch, int ng, int k, NewtonScalars<T> s) {
  constexpr int NC = R + 2;  // the R right-hand sides, then the columns p, q
  constexpr bool kDn = R == 2;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)gridDim.x, rank = (int)cluster.block_rank();  // one cluster
  const int T_ = blockDim.x, t = threadIdx.x, lane = t & 31;
  const int npad = T_ * k, base = rank * npad;  // the CTA's rows and its first
  extern __shared__ __align__(16) unsigned char smem[];
  ClusterSmem<R, T> m;
  cluster_layout<R, T>(C, T_, k, kShared, &m, smem);
  T* rows_s;
  if constexpr (kShared)
    rows_s = m.rows;
  else
    rows_s = scratch + (size_t)rank * (4 + R) * npad;
  T* phi_s = rows_s;
  T* c2_s = rows_s + npad;  // dx^2 c2
  const Blocks<T> B = newton_blocks(rows_s, k, npad);
  const T c0 = mul_rn(s.coef, n0[0]);
  const T dx2_c0 = mul_rn(s.dx2, c0);
  const T jac_b = mul_rn(mul_rn(-s.dx2, c0), s.c1);
  // the warm start at global row g: D-D its walls pinned to 0, D-N as given
  auto start = [&](int g) -> T {
    if constexpr (kDn)
      return (g >= 0 && g < ng) ? phi0[g] : (T)0;
    else
      return (phi0 != nullptr && g >= 1 && g <= ng - 2) ? phi0[g] : (T)0;
  };
  for (int e = t; e < npad; e += T_) {  // the CTA's rows in order, into its blocks
    const int g = base + e, j = e % k, o = j * T_ + e / k;
    const T p = start(g);
    phi_s[o] = p;
    if constexpr (kDn)
      c2_s[o] = g < ng ? mul_rn(s.dx2, mul_rn(dens[g], s.coef)) : (T)0;
    else
      c2_s[o] = g < ng ? mul_rn(s.dx2, quot_rn(dens[g], s.eps0)) : (T)0;
    if (j == 0) m.s_lo[e / k] = p;
    if (j == k - 1) m.s_hi[e / k] = p;
  }
  // phi of the rows just outside the CTA and (D-N) of row ng - 3, kept by
  // every thread from the cluster's solution as their owners update them
  T edge_dn = rank > 0 ? start(base - 1) : (T)0;
  T edge_up = rank + 1 < C ? start(base + npad) : (T)0;
  T phi_m3 = kDn ? start(ng - 3) : (T)0;
  const int g3 = ng - 3, r3 = g3 / npad, t3 = (g3 % npad) / k, j3 = g3 % k;
  cluster.sync();  // every CTA's shared memory is live before remote stores

  // The loop test of iteration i - 1 is read at iteration i's cluster
  // barrier: iteration i's sweeps and CTA solve run first, and are
  // dropped (phi untouched) when the test ends the loop.
  T residual = (T)1;
  int it = 0;
  bool go = s.maxiter > 0 && residual > s.tol;
  while (go) {
    const int par = it & 1;
    const T phi_first = m.s_lo[0];  // phi[0] in rank 0 (D-N row 0)
    T down = t > 0 ? m.s_hi[t - 1] : edge_dn;
    T cur = phi_s[t];
    sweep_down<R>(B, [&](int j) {
      const int i = base + t * k + j;
      const T up = j + 1 < k ? phi_s[block_at(j + 1)] : (t + 1 < T_ ? m.s_lo[t + 1] : edge_up);
      const T ex = exp_of(clamp_to(mul_rn(s.c1, cur), -s.exp_clamp, s.exp_clamp));
      Row<R, T> x;
      if constexpr (kDn) {
        const bool inner = i >= 1 && i <= ng - 2;
        const bool last = i == ng - 1;
        const T a_lap = inner ? (T)1 : (last ? (T)-4 : (T)0);
        const T c_lap = inner ? (T)1 : (T)0;
        const T d_lap = inner ? (T)-2 : (last ? (T)3 : (T)1);
        const T u_row = last ? (T)1 : (T)0;  // rank-1 u = e_{ng-1}
        T lap = add_rn(add_rn(mul_rn(a_lap, down), mul_rn(d_lap, cur)), mul_rn(c_lap, up));
        lap = add_rn(lap, mul_rn(u_row, phi_m3));  // A[-1, -3]
        T f = add_rn(sub_rn(lap, mul_rn(dx2_c0, ex)), c2_s[block_at(j)]);
        f = i == 0 ? phi_first : f;
        f = (last || i >= ng) ? (T)0 : f;
        x.a = a_lap;
        x.b = add_rn(d_lap, inner ? mul_rn(jac_b, ex) : (i == 0 ? jac_b : (T)0));
        x.c = c_lap;
        x.f[0] = f;
        x.f[R - 1] = u_row;
      } else {
        const bool interior = i >= 1 && i <= ng - 2;
        const bool boundary = i < ng && !interior;
        const T a_lap = interior ? (T)1 : (T)0;
        const T d_lap = interior ? (T)-2 : (T)1;
        const T lap =
            add_rn(add_rn(mul_rn(a_lap, down), mul_rn(d_lap, cur)), mul_rn(a_lap, up));
        const T f = add_rn(sub_rn(lap, mul_rn(dx2_c0, ex)), c2_s[block_at(j)]);
        x.a = a_lap;
        x.b = add_rn(d_lap, interior ? mul_rn(jac_b, ex) : (boundary ? jac_b : (T)0));
        x.c = a_lap;
        x.f[0] = interior ? f : (T)0;  // walls and padding: residual rows 0
      }
      down = cur;
      cur = up;
      return x;
    });
    Row<R, T> e0, e1;
    sweep_up<R>(B, e0, e1);
    // The CTA's 2 T end rows with its first and last row set apart: row 1's
    // coupling to row 0 (F) and row 2 T - 2's to row 2 T - 1 (L) become the
    // right-hand-side columns p and q, rows 0 and 2 T - 1 identity rows.
    Row<NC, T> x0 = identity_row<NC, T>(), x1 = identity_row<NC, T>();
    x0.a = e0.a, x0.b = e0.b, x0.c = e0.c;
    x1.a = e1.a, x1.b = e1.b, x1.c = e1.c;
#pragma unroll
    for (int c = 0; c < R; ++c) x0.f[c] = e0.f[c], x1.f[c] = e1.f[c];
    if (t == 0) {
      x0 = identity_row<NC, T>();
      x1.f[R] = x1.a;
      x1.a = (T)0;
    }
    if (t == T_ - 1) {
      x1 = identity_row<NC, T>();
      x0.f[R + 1] = x0.c;
      x0.c = (T)0;
    }
    pcr_solve_pair<NC>(x0, x1, m.pcr);
    // Push: the CTA's rows F (thread 0) and L (thread T - 1) of the
    // cluster's system, the partial of the last iteration, (D-N) row
    // ng - 3's ingredients, into every CTA's slot of this parity.
    T* slot = m.recv + (par * C + rank) * 2 * (3 + R);
    if (t == 0 || t == T_ - 1) {
      T row[3 + R];
      if (t == 0) {  // a L_(r-1) + b F + c L = f
        row[0] = e0.a;
        row[1] = sub_rn((T)1, mul_rn(e0.c, x1.f[R]));
        row[2] = -mul_rn(e0.c, x1.f[R + 1]);
#pragma unroll
        for (int c = 0; c < R; ++c) row[3 + c] = sub_rn(e0.f[c], mul_rn(e0.c, x1.f[c]));
      } else {  // a F + b L + c F_(r+1) = f
        row[0] = -mul_rn(e1.a, x0.f[R]);
        row[1] = sub_rn((T)1, mul_rn(e1.a, x0.f[R + 1]));
        row[2] = e1.c;
#pragma unroll
        for (int c = 0; c < R; ++c) row[3 + c] = sub_rn(e1.f[c], mul_rn(e1.a, x0.f[c]));
      }
      const int off = t == 0 ? 0 : 3 + R;
      for (int q = 0; q < C; ++q) {
        T* dst = cluster.map_shared_rank(slot + off, q);
#pragma unroll
        for (int c = 0; c < 3 + R; ++c) dst[c] = row[c];
      }
    }
    if (it > 0 && t < 32) {
      const double tot = block_total(m.red);
      if (lane < C) *cluster.map_shared_rank(m.part + par * kClusterMax + rank, lane) = tot;
    }
    if constexpr (kDn) {
      if (rank == r3 && t == t3) {  // what row ng - 3's recovery reads
        const int e = block_at(j3);
        const T v[kIngredients] = {B.ap[e], B.cp[e], B.dp[e], B.dp[npad + e],
                                   x0.f[0], x0.f[1], x0.f[R], x0.f[R + 1],
                                   x1.f[0], x1.f[1], x1.f[R], x1.f[R + 1]};
        for (int q = 0; q < C; ++q) {
          T* dst = cluster.map_shared_rank(m.ing + par * kIngredients, q);
#pragma unroll
          for (int c = 0; c < kIngredients; ++c) dst[c] = v[c];
        }
      }
    }
    cluster.sync();  // this parity's slots are complete in every CTA
    if (it > 0) {  // iteration it - 1's residual, the partials in rank order
      double tot = 0.0;
      for (int q = 0; q < C; ++q) tot += m.part[par * kClusterMax + q];
      residual = kDn ? sqrt_rn((T)tot) : (T)tot;
      if (!(residual > s.tol)) break;
    }
    const Row<R, T> z = warp_pcr<R>(m.recv + par * C * 2 * (3 + R), 2 * C);
    auto at = [&](int row, int c) { return __shfl_sync(0xffffffffu, z.f[c], max(row, 0)); };
    // the step at a row from its (y, z) or x: D-N y - z corr, clipped
    T corr = (T)0;
    T yz3[R];
    if constexpr (kDn) {
      const T* g = m.ing + par * kIngredients;
      T xf3[R], xl3[R];
#pragma unroll
      for (int c = 0; c < R; ++c) {
        const T F3 = at(2 * r3, c), L3 = at(2 * r3 + 1, c);
        xf3[c] = t3 == 0 ? F3 : end_value(g[4 + c], g[6], g[7], F3, L3);
        xl3[c] = t3 == T_ - 1 ? L3 : end_value(g[8 + c], g[10], g[11], F3, L3);
      }
#pragma unroll
      for (int c = 0; c < R; ++c)
        yz3[c] = j3 == 0       ? xf3[c]
                 : j3 == k - 1 ? xl3[c]
                               : sub_rn(sub_rn(g[2 + c], mul_rn(g[0], xf3[c])),
                                        mul_rn(g[1], xl3[c]));
      corr = quot_rn(yz3[0], add_rn((T)1, yz3[1]));
    }
    auto step_of = [&](const T* v) {
      const T d = kDn ? sub_rn(v[0], mul_rn(v[R - 1], corr)) : v[0];
      return clamp_to(d, -s.step_max, s.step_max);
    };
    T xf[R], xl[R], ldn[R], fup[R];
#pragma unroll
    for (int c = 0; c < R; ++c) {
      const T F = at(2 * rank, c), L = at(2 * rank + 1, c);
      ldn[c] = at(2 * rank - 1, c);
      fup[c] = at(2 * rank + 2, c);
      xf[c] = t == 0 ? F : end_value(x0.f[c], x0.f[R], x0.f[R + 1], F, L);
      xl[c] = t == T_ - 1 ? L : end_value(x1.f[c], x1.f[R], x1.f[R + 1], F, L);
    }
    double sq = 0.0;
    for (int j = 0; j < k; ++j) {
      T v[R];
      recover<R>(B, j, xf, xl, v);
      const T dphi = step_of(v);
      const int e = block_at(j);
      const T p = sub_rn(phi_s[e], dphi);
      phi_s[e] = p;
      sq += (double)mul_rn(dphi, dphi);
      if (j == 0) m.s_lo[t] = p;
      if (j == k - 1) m.s_hi[t] = p;
    }
    if (rank > 0) edge_dn = sub_rn(edge_dn, step_of(ldn));
    if (rank + 1 < C) edge_up = sub_rn(edge_up, step_of(fup));
    if constexpr (kDn) phi_m3 = sub_rn(phi_m3, step_of(yz3));
    // this iteration's partials and the next one's edge phi, one barrier
    warp_partial(sq, m.red);
    __syncthreads();
    ++it;
    if (it == s.maxiter) {  // the last iteration's residual on its own
      const int p2 = it & 1;
      if (t < 32) {
        const double tot = block_total(m.red);
        if (lane < C) *cluster.map_shared_rank(m.part + p2 * kClusterMax + rank, lane) = tot;
      }
      cluster.sync();
      double tot = 0.0;
      for (int q = 0; q < C; ++q) tot += m.part[p2 * kClusterMax + q];
      residual = kDn ? sqrt_rn((T)tot) : (T)tot;
      go = false;
    }
  }
  // shift to min 0 over the physical rows: each CTA's minimum to every CTA
  T lo = largest<T>();
  for (int j = 0; j < k && base + t * k + j < ng; ++j) lo = min_of(lo, phi_s[block_at(j)]);
  lo = block_min(lo, m.redf);
  if (t < C) *cluster.map_shared_rank(m.mins + rank, t) = lo;
  cluster.sync();
  T g_lo = m.mins[0];
  for (int q = 1; q < C; ++q) g_lo = min_of(g_lo, m.mins[q]);
  for (int e = t; e < npad && base + e < ng; e += T_)
    phi_out[base + e] = sub_rn(phi_s[(e % k) * T_ + e / k], g_lo);
  if (rank == 0 && t == 0) {
    iters_out[0] = it;
    resid_out[0] = residual;
  }
}

// The large path's launch: T threads (a multiple of 32 in [32, the
// element type's most]), k >= 2 rows a thread, T k >= rows > the small
// path's kMaxRows.
template <typename T>
bool large_ok(int rows, int k, int threads) {
  const int most = sizeof(T) == 8 ? kMaxLargeThreadsF64 : kMaxRows;
  return threads >= 32 && threads <= most && threads % 32 == 0 && k >= 2 &&
         rows > kMaxRows && (long long)threads * k >= rows;
}

// The launches of the Newton kernels of T (the float and double entry
// points).
template <typename T>
cudaError_t launch_dd(const T* rho, const T* n0, const T* phi0, T* phi, int* iters,
                      T* resid, int ng, int rows, T c0_coef, T eps0, T c1, T dx2, T tol,
                      int maxiter, T step_max, T exp_clamp, cudaStream_t s) {
  if (!rows_ok(ng, rows)) return cudaErrorInvalidValue;
  const size_t smem = newton_smem<1, T>(rows);
  cudaError_t err = allow_smem(newton_dd_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  newton_dd_kernel<T><<<1, rows, smem, s>>>(rho, n0, phi0, phi, iters, resid, ng, c0_coef,
                                            eps0, c1, dx2, tol, maxiter, step_max,
                                            exp_clamp);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dn(const T* n, const T* n0, const T* phi0, T* phi, int* iters,
                      T* resid, int ng, int rows, T coef, T c1, T dx2, T tol, int maxiter,
                      T step_max, T exp_clamp, cudaStream_t s) {
  if (!rows_ok(ng, rows) || ng < 3) return cudaErrorInvalidValue;
  const size_t smem = newton_smem<2, T>(rows);
  cudaError_t err = allow_smem(newton_dn_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  newton_dn_kernel<T><<<1, rows, smem, s>>>(n, n0, phi0, phi, iters, resid, ng, coef, c1,
                                            dx2, tol, maxiter, step_max, exp_clamp);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dd_large(const T* rho, const T* n0, const T* phi0, T* phi, int* iters,
                            T* resid, T* scratch, int ng, int k, int threads, T c0_coef,
                            T eps0, T c1, T dx2, T tol, int maxiter, T step_max,
                            T exp_clamp, cudaStream_t st) {
  if (!large_ok<T>(ng, k, threads)) return cudaErrorInvalidValue;
  const size_t smem = newton_smem<1, T>(2 * threads);
  cudaError_t err = allow_smem(newton_dd_large_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const NewtonScalars<T> s{c0_coef, eps0, c1, dx2, tol, step_max, exp_clamp, maxiter};
  newton_dd_large_kernel<T><<<1, threads, smem, st>>>(rho, n0, phi0, phi, iters, resid,
                                                      scratch, ng, k, s);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dn_large(const T* n, const T* n0, const T* phi0, T* phi, int* iters,
                            T* resid, T* scratch, int ng, int k, int threads, T coef,
                            T c1, T dx2, T tol, int maxiter, T step_max, T exp_clamp,
                            cudaStream_t st) {
  if (!large_ok<T>(ng, k, threads)) return cudaErrorInvalidValue;
  const size_t smem = newton_smem<2, T>(2 * threads);
  cudaError_t err = allow_smem(newton_dn_large_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const NewtonScalars<T> s{coef, (T)0, c1, dx2, tol, step_max, exp_clamp, maxiter};
  newton_dn_large_kernel<T><<<1, threads, smem, st>>>(n, n0, phi0, phi, iters, resid,
                                                      scratch, ng, k, s);
  return cudaGetLastError();
}

// The cluster mode's launch: C CTAs (a power of two in [2, 16]) of T
// threads (a multiple of 32 in [32, kClusterThreads]), k >= 2 rows a
// thread, C T k >= rows > the small path's kMaxRows.
bool cluster_ok(int rows, int k, int threads, int C) {
  return C >= 2 && C <= kClusterMax && (C & (C - 1)) == 0 && threads >= 32 &&
         threads <= kClusterThreads && threads % 32 == 0 && k >= 2 && rows > kMaxRows &&
         (long long)C * threads * k >= rows;
}

template <int R, bool kShared, typename T>
cudaError_t cluster_prepare(size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(newton_cluster_kernel<R, kShared, T>,
                                         cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  return allow_smem(newton_cluster_kernel<R, kShared, T>, smem);
}

cudaLaunchConfig_t cluster_config(int C, int threads, size_t smem, cudaStream_t st,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int R, bool kShared, typename T>
cudaError_t launch_cluster_as(const T* dens, const T* n0, const T* phi0, T* phi, int* iters,
                              T* resid, T* scratch, int ng, int k, int threads, int C,
                              const NewtonScalars<T>& s, cudaStream_t st) {
  const size_t smem = cluster_smem<R, T>(C, threads, k, kShared);
  cudaError_t err = cluster_prepare<R, kShared, T>(smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(C, threads, smem, st, &attr);
  err = cudaLaunchKernelEx(&cfg, newton_cluster_kernel<R, kShared, T>, dens, n0, phi0, phi,
                           iters, resid, scratch, ng, k, s);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// R = 1: the D-D solve (s.eps0 rho's divisor), R = 2: the D-N solve.
// shared: the rows' scratch in shared memory (scratch unused), else
// (4 + R) C T k elements of scratch.
template <int R, typename T>
cudaError_t launch_cluster(const T* dens, const T* n0, const T* phi0, T* phi, int* iters,
                           T* resid, T* scratch, int ng, int k, int threads, int C,
                           int shared, const NewtonScalars<T>& s, cudaStream_t st) {
  if (!cluster_ok(ng, k, threads, C) || ng < 3) return cudaErrorInvalidValue;
  if (shared)
    return launch_cluster_as<R, true, T>(dens, n0, phi0, phi, iters, resid, scratch, ng, k,
                                         threads, C, s, st);
  return launch_cluster_as<R, false, T>(dens, n0, phi0, phi, iters, resid, scratch, ng, k,
                                        threads, C, s, st);
}

// How many clusters of a cluster-mode launch the current card holds at once.
template <int R, bool kShared, typename T>
cudaError_t cluster_count_as(int k, int threads, int C, int* count) {
  const size_t smem = cluster_smem<R, T>(C, threads, k, kShared);
  cudaError_t err = cluster_prepare<R, kShared, T>(smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(C, threads, smem, 0, &attr);
  return cudaOccupancyMaxActiveClusters(count, newton_cluster_kernel<R, kShared, T>, &cfg);
}

template <int R, typename T>
cudaError_t cluster_count(int k, int threads, int C, int shared, int* count) {
  return shared ? cluster_count_as<R, true, T>(k, threads, C, count)
                : cluster_count_as<R, false, T>(k, threads, C, count);
}

}  // namespace

extern "C" {

// phi0 may be null (cold start at 0). rows: threads of the one CTA, a
// multiple of 32 in [32, 1024], >= ng (cuda_newton.kernel_rows).
int pypic_boltzmann_dirichlet(const float* rho, const float* n0,
                              const float* phi0, float* phi, int* iters,
                              float* resid, int ng, int rows, float c0_coef,
                              float eps0, float c1, float dx2, float tol,
                              int maxiter, float step_max, float exp_clamp,
                              void* stream) {
  return (int)launch_dd(rho, n0, phi0, phi, iters, resid, ng, rows, c0_coef, eps0, c1,
                        dx2, tol, maxiter, step_max, exp_clamp, (cudaStream_t)stream);
}

// The double solve (a float64 state): every pointer to doubles but iters,
// every scalar a double (_SIGNATURES passes them as c_double).
int pypic_boltzmann_dirichlet_f64(const double* rho, const double* n0, const double* phi0,
                                  double* phi, int* iters, double* resid, int ng, int rows,
                                  double c0_coef, double eps0, double c1, double dx2,
                                  double tol, int maxiter, double step_max,
                                  double exp_clamp, void* stream) {
  return (int)launch_dd(rho, n0, phi0, phi, iters, resid, ng, rows, c0_coef, eps0, c1,
                        dx2, tol, maxiter, step_max, exp_clamp, (cudaStream_t)stream);
}

// n and phi0 (ng,), 3 <= ng <= rows; rows as above. coef = f32(e / eps0).
int pypic_boltzmann_dn(const float* n, const float* n0, const float* phi0,
                       float* phi, int* iters, float* resid, int ng, int rows,
                       float coef, float c1, float dx2, float tol,
                       int maxiter, float step_max, float exp_clamp,
                       void* stream) {
  return (int)launch_dn(n, n0, phi0, phi, iters, resid, ng, rows, coef, c1, dx2, tol,
                        maxiter, step_max, exp_clamp, (cudaStream_t)stream);
}

// coef = e / eps0 in float64.
int pypic_boltzmann_dn_f64(const double* n, const double* n0, const double* phi0,
                           double* phi, int* iters, double* resid, int ng, int rows,
                           double coef, double c1, double dx2, double tol, int maxiter,
                           double step_max, double exp_clamp, void* stream) {
  return (int)launch_dn(n, n0, phi0, phi, iters, resid, ng, rows, coef, c1, dx2, tol,
                        maxiter, step_max, exp_clamp, (cudaStream_t)stream);
}

// dl, d, du, f: the rank's (c,) slabs (dl[0] and du[c-1] are the
// couplings to the neighbouring slabs, left out of the local solve); x:
// (3, c) [xp, u, w]; g6: the six interface scalars. 2 <= c <= rows; rows
// as above. first / last: the rank is the chain's first / last.
int pypic_tridiag3_chain(const float* dl, const float* d, const float* du,
                         const float* f, float* x, float* g6, int c, int rows,
                         int first, int last, void* stream) {
  if (!rows_ok(c, rows) || c < 2) return (int)cudaErrorInvalidValue;
  const size_t smem = pcr_smem<3, float>(rows);
  cudaError_t err = allow_smem(tridiag3_chain_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  tridiag3_chain_kernel<<<1, rows, smem, (cudaStream_t)stream>>>(
      dl, d, du, f, x, g6, c, first, last);
  return (int)cudaGetLastError();
}

// The large path (header), rows > 1,024: one CTA of `threads` threads, k
// rows a thread (cuda_newton.large_split). scratch: (4 + R) threads k
// elements for the Newton solves (R = 1 D-D, 2 D-N), 5 threads k for the
// chain. The other arguments are the small path's. The double solves take
// at most 512 threads (kMaxLargeThreadsF64).
int pypic_boltzmann_dirichlet_large(
    const float* rho, const float* n0, const float* phi0, float* phi,
    int* iters, float* resid, float* scratch, int ng, int k, int threads,
    float c0_coef, float eps0, float c1, float dx2, float tol, int maxiter,
    float step_max, float exp_clamp, void* stream) {
  return (int)launch_dd_large(rho, n0, phi0, phi, iters, resid, scratch, ng, k, threads,
                              c0_coef, eps0, c1, dx2, tol, maxiter, step_max, exp_clamp,
                              (cudaStream_t)stream);
}

int pypic_boltzmann_dirichlet_large_f64(
    const double* rho, const double* n0, const double* phi0, double* phi, int* iters,
    double* resid, double* scratch, int ng, int k, int threads, double c0_coef,
    double eps0, double c1, double dx2, double tol, int maxiter, double step_max,
    double exp_clamp, void* stream) {
  return (int)launch_dd_large(rho, n0, phi0, phi, iters, resid, scratch, ng, k, threads,
                              c0_coef, eps0, c1, dx2, tol, maxiter, step_max, exp_clamp,
                              (cudaStream_t)stream);
}

int pypic_boltzmann_dn_large(
    const float* n, const float* n0, const float* phi0, float* phi,
    int* iters, float* resid, float* scratch, int ng, int k, int threads,
    float coef, float c1, float dx2, float tol, int maxiter, float step_max,
    float exp_clamp, void* stream) {
  return (int)launch_dn_large(n, n0, phi0, phi, iters, resid, scratch, ng, k, threads,
                              coef, c1, dx2, tol, maxiter, step_max, exp_clamp,
                              (cudaStream_t)stream);
}

int pypic_boltzmann_dn_large_f64(
    const double* n, const double* n0, const double* phi0, double* phi, int* iters,
    double* resid, double* scratch, int ng, int k, int threads, double coef, double c1,
    double dx2, double tol, int maxiter, double step_max, double exp_clamp,
    void* stream) {
  return (int)launch_dn_large(n, n0, phi0, phi, iters, resid, scratch, ng, k, threads,
                              coef, c1, dx2, tol, maxiter, step_max, exp_clamp,
                              (cudaStream_t)stream);
}

// The large path's cluster mode (header): `cluster` CTAs of `threads`
// threads, k rows a thread (cuda_newton.large_shape), the rows' scratch in
// shared memory (shared = 1; scratch unused) or in scratch ((4 + R)
// cluster threads k elements). The other arguments are the large path's.
int pypic_boltzmann_dirichlet_cluster(
    const float* rho, const float* n0, const float* phi0, float* phi, int* iters,
    float* resid, float* scratch, int ng, int k, int threads, int cluster, int shared,
    float c0_coef, float eps0, float c1, float dx2, float tol, int maxiter, float step_max,
    float exp_clamp, void* stream) {
  const NewtonScalars<float> s{c0_coef, eps0, c1, dx2, tol, step_max, exp_clamp, maxiter};
  return (int)launch_cluster<1>(rho, n0, phi0, phi, iters, resid, scratch, ng, k, threads,
                                cluster, shared, s, (cudaStream_t)stream);
}

int pypic_boltzmann_dirichlet_cluster_f64(
    const double* rho, const double* n0, const double* phi0, double* phi, int* iters,
    double* resid, double* scratch, int ng, int k, int threads, int cluster, int shared,
    double c0_coef, double eps0, double c1, double dx2, double tol, int maxiter,
    double step_max, double exp_clamp, void* stream) {
  const NewtonScalars<double> s{c0_coef, eps0, c1, dx2, tol, step_max, exp_clamp, maxiter};
  return (int)launch_cluster<1>(rho, n0, phi0, phi, iters, resid, scratch, ng, k, threads,
                                cluster, shared, s, (cudaStream_t)stream);
}

int pypic_boltzmann_dn_cluster(
    const float* n, const float* n0, const float* phi0, float* phi, int* iters,
    float* resid, float* scratch, int ng, int k, int threads, int cluster, int shared,
    float coef, float c1, float dx2, float tol, int maxiter, float step_max,
    float exp_clamp, void* stream) {
  const NewtonScalars<float> s{coef, 0.0f, c1, dx2, tol, step_max, exp_clamp, maxiter};
  return (int)launch_cluster<2>(n, n0, phi0, phi, iters, resid, scratch, ng, k, threads,
                                cluster, shared, s, (cudaStream_t)stream);
}

int pypic_boltzmann_dn_cluster_f64(
    const double* n, const double* n0, const double* phi0, double* phi, int* iters,
    double* resid, double* scratch, int ng, int k, int threads, int cluster, int shared,
    double coef, double c1, double dx2, double tol, int maxiter, double step_max,
    double exp_clamp, void* stream) {
  const NewtonScalars<double> s{coef, 0.0, c1, dx2, tol, step_max, exp_clamp, maxiter};
  return (int)launch_cluster<2>(n, n0, phi0, phi, iters, resid, scratch, ng, k, threads,
                                cluster, shared, s, (cudaStream_t)stream);
}

// The cluster mode's dynamic shared memory a CTA (dn: the D-N kernel;
// f64: the double one), as cuda_newton.cluster_smem counts it.
long long pypic_newton_cluster_smem(int dn, int f64, int cluster, int threads, int k,
                                    int shared) {
  const bool sh = shared != 0;
  if (dn) return (long long)(f64 ? cluster_smem<2, double>(cluster, threads, k, sh)
                                 : cluster_smem<2, float>(cluster, threads, k, sh));
  return (long long)(f64 ? cluster_smem<1, double>(cluster, threads, k, sh)
                         : cluster_smem<1, float>(cluster, threads, k, sh));
}

// How many clusters of that launch the current card holds at once (0: it
// cannot launch).
int pypic_newton_clusters(int dn, int f64, int k, int threads, int cluster, int shared,
                          int* count) {
  cudaError_t err;
  if (dn)
    err = f64 ? cluster_count<2, double>(k, threads, cluster, shared, count)
              : cluster_count<2, float>(k, threads, cluster, shared, count);
  else
    err = f64 ? cluster_count<1, double>(k, threads, cluster, shared, count)
              : cluster_count<1, float>(k, threads, cluster, shared, count);
  return (int)err;
}

int pypic_tridiag3_chain_large(const float* dl, const float* d,
                               const float* du, const float* f, float* x,
                               float* g6, float* scratch, int c, int k,
                               int threads, int first, int last,
                               void* stream) {
  if (!large_ok<float>(c, k, threads)) return (int)cudaErrorInvalidValue;
  const size_t smem = pcr_smem<3, float>(2 * threads);
  cudaError_t err = allow_smem(tridiag3_chain_large_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  tridiag3_chain_large_kernel<<<1, threads, smem, (cudaStream_t)stream>>>(
      dl, d, du, f, x, g6, scratch, c, k, first, last);
  return (int)cudaGetLastError();
}

}  // extern "C"
