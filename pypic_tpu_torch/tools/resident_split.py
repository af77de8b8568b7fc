"""Where a launch of a resident kernel spends its time, on the card: copies
of a kernel source with one stage cut out, each built by nvcc into its own
library outside the package's.

    python -m pypic_tpu_torch.tools.resident_split [--first-port SOURCE]
    python -m pypic_tpu_torch.tools.resident_split --kernel explicit
    python -m pypic_tpu_torch.tools.resident_split --kernel newton_dd|newton_dn [--first-port SOURCE]
    python -m pypic_tpu_torch.tools.resident_split --kernel deposit2|boris_deposit [--first-port SOURCE]

The cuts are text edits of ``csrc/implicit.cu`` (``--kernel implicit``,
the default) or of ``csrc/explicit.cu`` (``--kernel explicit``); the edits
are written against those sources and fail loudly when they change. With
``--first-port`` the tool also splits the implicit kernel's first port
(one 8-CTA cluster, the particles in device memory), given its source
file, for example from ``git show
64e2430:pypic_tpu_torch/csrc/implicit.cu``.

The implicit cuts run at the configs[1] row's shape (tools/landau.py: n =
1e5, ng = 200, one 64-step launch, tol 1e-6, maxiter 50, picard_init
'field', no Anderson); a cut that changes the arithmetic runs the pass
counts the full kernel ran. The explicit cuts run at the configs[0] row's
(tools/two_stream.py: n = 10,000, ng = 200, one 2,000-step launch), and
the full kernel also at the kernel's largest n, 32,768. Times are
CUDA events, the median of five launches, two rounds; the tool prints the
shared-memory atomic instructions each full kernel compiles to
(cuobjdump), its spill (``-Xptxas -v``) and one JSON line. It needs an
NVIDIA GPU and nvcc.

``--kernel newton_dd`` and ``--kernel newton_dn`` split the one-CTA
Newton-Boltzmann solves of ``csrc/newton.cu`` at their rows' first
solves: D-D at the configs[3] row's deposit (tools/magnetized.py, ng =
600, n0 = 0.9 <n>, cold start, the config's tol and maxiter), D-N at the
D-N row's (ng = 800, warm start 0, tol 1e-3). Every cut but the full
kernel runs the iteration count the full kernel ran. A long solve (tol 0,
maxiter 64) prices an iteration apart from the launch's fixed cost.
With ``--first-port`` the tool also splits the Newton kernels' first port
(one CTA of ``padded_rows(ng)`` threads, 13 block barriers an iteration)
beside them, given its source file, for example from ``git show
77b14a9:pypic_tpu_torch/csrc/newton.cu``. These kernels are shorter than a launch from the host, so each time is
the median of five rounds of 20 launches queued behind a sleep, between
CUDA events.

``--kernel deposit2`` and ``--kernel boris_deposit`` split the magnetized
deposits of ``csrc/magnetized.cu`` (``deposit2`` bounded; the carried
Boris deposit at pad 2, mirrored) at the configs[3] row's shape (n =
999,996, ng = 600), the D-N row's (50,000, 800) and the carried row's
re-activation patch (16,384, 600), on ``deposit_inputs``' particles,
launches queued as for the Newton kernels, outputs not zeroed (no memset
timed). The cuts (``DEPOSIT_CUTS``) take out the flush, the column sums,
the shared-memory adds or all but the sweep, or launch the full kernel
with other column counts or the other width of
``cuda_cic.deposit_launch_shape``. With ``--first-port`` the tool also
splits the first port (1,056 blocks of 256 threads, one histogram a
block flushed by global atomics; ``DEPOSIT_FIRST_PORT_CUTS``), for
example from ``git show d10fc7e:pypic_tpu_torch/csrc/magnetized.cu``.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import functools
import json
import statistics
import subprocess
from pathlib import Path

import numpy as np
import torch

from ..constants import EPSILON_0
from ..engines import explicit, implicit
from ..ops import _build, cuda_cic
from . import landau, two_stream

OUT_DIR = _build.BUILD_DIR / "resident_split"
# the configs[0] row: one launch of run_resident (tools/two_stream.py) at
# its n, and the full kernel at the kernel's largest n
EXPLICIT_NS, EXPLICIT_STEPS = (10_000, 32_768), 2000

# the current kernel: CUT selects the stage taken out
CURRENT_CUTS = {
    "full": 0,
    "no deposit": 1,           # the sweeps without their atomics
    "no sweeps": 2,            # the (ng,) chain and the barriers alone
    "no sweeps, no cluster barrier": 3,  # __syncthreads in its place
    "no sweeps, local push": 4,  # every CTA's totals stored locally
    "no sweeps, no combine or push": 5,
    "no sweeps, barriers only": 6,
}
_CURRENT_EDITS = [
    ("#include \"cic_common.cuh\"",
     "#include \"cic_common.cuh\"\n#ifndef CUT\n#define CUT 0\n#endif"),
    ("int smooth, int tracer, double fe_c, double ke_c, double jb_c) {\n  cg::cluster_group",
     "int smooth, int tracer, double fe_c, double ke_c, double jb_c,\n"
     "    const int* __restrict__ forced) {\n  float sink = 0.0f;\n  cg::cluster_group"),
    ("    while (r > tol && k < maxiter) {",
     "    while (forced ? k < forced[s] : (r > tol && k < maxiter)) {"),
    ("      const bool last = !(r > tol && k < maxiter);",
     "      const bool last = forced ? k >= forced[s] : !(r > tol && k < maxiter);"),
    ("        if (j * kThreads < lim) {\n          const float a = P[j]",
     "        if (CUT < 2 && j * kThreads < lim) {\n          const float a = P[j]"),
    ("          atomicAdd(&hist[c.l * cols + col], __fmul_rn(val, c.wl));\n"
     "          atomicAdd(&hist[c.r * cols + col], __fmul_rn(val, c.wr));",
     "          if (CUT == 1) {\n"
     "            sink = __fadd_rn(sink, __fadd_rn(__fmul_rn(val, c.wl), __fmul_rn(val,"
     " c.wr)) + (float)(c.l * cols + col));\n          } else {\n"
     "          atomicAdd(&hist[c.l * cols + col], __fmul_rn(val, c.wl));\n"
     "          atomicAdd(&hist[c.r * cols + col], __fmul_rn(val, c.wr));\n          }"),
    ("      if (node) {\n        // node t's columns",
     "      if (CUT < 5 && node) {\n        // node t's columns"),
    ("*cluster.map_shared_rank(slot, q) = x;",
     "*cluster.map_shared_rank(slot, CUT == 4 ? rank : q) = x;"),
    ("      cluster.sync();  // recv[b] is complete in every CTA",
     "      if (CUT == 3) __syncthreads(); else cluster.sync();\n      if (CUT != 6) {"),
    ("        write_partials(tot, s - 1, ke_row, jb_row, ke_c, jb_c);\n\n      // (B2)",
     "        write_partials(tot, s - 1, ke_row, jb_row, ke_c, jb_c);\n"
     "      } else __syncthreads();\n      if (CUT != 6) {\n\n      // (B2)"),
    ("      __syncthreads();\n\n"
     "      // (B3) r, the mixed iterate and the next sweep's field\n"
     "      double rs = 0.0;\n      for (int q = 0; q < nw; ++q) rs += red_r[4 * q];",
     "      }\n      __syncthreads();\n\n      double rs = 0.0;\n"
     "      if (CUT != 6) for (int q = 0; q < nw; ++q) rs += red_r[4 * q];"),
    ("      const bool last = forced ? k >= forced[s] : !(r > tol && k < maxiter);\n"
     "      if (node) {",
     "      const bool last = forced ? k >= forced[s] : !(r > tol && k < maxiter);\n"
     "      if (CUT != 6 && node) {"),
    ("      if (j * kThreads < lim) {\n        const float e = gather_rec(fs",
     "      if (CUT < 2 && j * kThreads < lim) {\n        const float e = gather_rec(fs"),
    ("  if (rank == 0 && node) {\n    e_out[t]",
     "  if (sink == 1.2345e30f) e_out[1] = sink;\n  if (rank == 0 && node) {\n    e_out[t]"),
    ("    int tracer, double fe_c, double ke_c, double jb_c, void* stream) {",
     "    int tracer, double fe_c, double ke_c, double jb_c, const int* forced,\n"
     "    void* stream) {"),
    ("      fe_c, ke_c, jb_c);\n  if (err != cudaSuccess) return (int)err;",
     "      fe_c, ke_c, jb_c, forced);\n  if (err != cudaSuccess) return (int)err;"),
]

# the first port's kernel: mode selects the stage taken out
FIRST_PORT_CUTS = {
    "(a) as is": 0,
    "(b) no particle sweeps": 1,
    "(c) sweeps without the shared-memory atomics": 2,
    "(d) DSMEM histogram sum and block_sums alone": 3,
    "(e) cluster barriers alone": 4,
    "(f) sweeps and cluster barriers alone": 5,
}
_FIRST_PORT_EDITS = [
    ("#include <cooperative_groups.h>",
     "#include <cooperative_groups.h>\n#ifndef RP\n#define RP\n#endif"),
    ("const float* __restrict__ v_in, float* p, float* v, float* ps,",
     "const float* __restrict__ v_in, float* RP p, float* RP v, float* RP ps,"),
    ("int anderson, int smooth, int tracer, double fe_c, double ke_c,\n    double jb_c) {",
     "int anderson, int smooth, int tracer, double fe_c, double ke_c,\n"
     "    double jb_c, int mode, const int* __restrict__ forced) {\n"
     "  const bool sweeps = mode == 0 || mode == 2 || mode == 5;\n"
     "  const bool chain = mode <= 2;\n  const bool sums = mode <= 3;\n  float sink = 0.0f;"),
    ("while (r > tol && k < maxiter) {",
     "while (mode == 0 ? (r > tol && k < maxiter) : k < forced[s]) {"),
    ("      for (int i = t; i < ng; i += kThreads) s_fs[i] = smooth_at(s_es, i, ng, sm);\n"
     "      __syncthreads();\n      const int b = pass & 1;",
     "      if (chain) {\n"
     "      for (int i = t; i < ng; i += kThreads) s_fs[i] = smooth_at(s_es, i, ng, sm);\n"
     "      __syncthreads();\n      }\n      const int b = pass & 1;"),
    ("      for (int i = begin + t; i < end; i += kThreads) {\n"
     "        const float a = p[i];",
     "      if (sweeps) for (int i = begin + t; i < end; i += kThreads) {\n"
     "        const float a = p[i];"),
    ("        atomicAdd(&hist[c.l], __fmul_rn(val, c.wl));\n"
     "        atomicAdd(&hist[c.r], __fmul_rn(val, c.wr));",
     "        if (mode == 2) {\n"
     "          sink = __fadd_rn(sink, __fadd_rn(__fmul_rn(val, c.wl), __fmul_rn(val,"
     " c.wr)) + (float)(c.l + c.r));\n        } else {\n"
     "        atomicAdd(&hist[c.l], __fmul_rn(val, c.wl));\n"
     "        atomicAdd(&hist[c.r], __fmul_rn(val, c.wr));\n        }"),
    ("      double sj = 0.0;\n      for (int i = t; i < ng; i += kThreads) {\n"
     "        float jh = 0.0f;",
     "      double sj = 0.0;\n      if (sums) for (int i = t; i < ng; i += kThreads) {\n"
     "        float jh = 0.0f;"),
    ("      const float mean = (float)(block_sum(sj, red) / ng);  // syncs s_jh\n"
     "      double rr = 0.0;\n      for (int i = t; i < ng; i += kThreads) {",
     "      const float mean = sums ? (float)(block_sum(sj, red) / ng) : 0.0f;\n"
     "      double rr = 0.0;\n      if (chain) for (int i = t; i < ng; i += kThreads) {"),
    ("      r = (float)block_sum(rr, red);\n      if (anderson) {",
     "      if (sums) r = (float)block_sum(rr, red);\n      if (anderson && sums) {"),
    ("      } else {\n        for (int i = t; i < ng; i += kThreads) s_es[i] = s_fs[i];\n"
     "      }\n      __syncthreads();\n      ++k;",
     "      } else if (chain) {\n"
     "        for (int i = t; i < ng; i += kThreads) s_es[i] = s_fs[i];\n      }\n"
     "      if (chain) __syncthreads();\n      ++k;"),
    ("    for (int i = t; i < ng; i += kThreads) s_fs[i] = smooth_at(s_es, i, ng, sm);\n"
     "    __syncthreads();\n    const float* gpos = k == 0 ? p : ps;\n"
     "    double ke = 0.0, jb = 0.0;\n    for (int i = begin + t; i < end; i += kThreads) {",
     "    if (chain) {\n"
     "    for (int i = t; i < ng; i += kThreads) s_fs[i] = smooth_at(s_es, i, ng, sm);\n"
     "    __syncthreads();\n    }\n    const float* gpos = k == 0 ? p : ps;\n"
     "    double ke = 0.0, jb = 0.0;\n"
     "    if (sweeps) for (int i = begin + t; i < end; i += kThreads) {"),
    ("    ke = block_sum(ke, red);\n    jb = block_sum(jb, red);",
     "    if (sums) {\n    ke = block_sum(ke, red);\n    jb = block_sum(jb, red);\n    }"),
    ("    double fe = 0.0;\n    for (int i = t; i < ng; i += kThreads) {",
     "    double fe = 0.0;\n    if (chain) for (int i = t; i < ng; i += kThreads) {"),
    ("    fe = block_sum(fe, red);\n"
     "    cluster.sync();  // part[sb] is complete in every CTA\n"
     "    if (rank == 0 && t == 0) {",
     "    if (sums) fe = block_sum(fe, red);\n    cluster.sync();\n"
     "    if (rank == 0 && t == 0 && sums) {"),
    ("  cluster.sync();  // no CTA exits while another may still read its memory\n",
     "  cluster.sync();\n  if (sink == 1.2345e30f) e_out[0] = sink;\n"),
    ("int tracer, double fe_c, double ke_c, double jb_c, void* stream) {",
     "int tracer, double fe_c, double ke_c, double jb_c, int mode, const int* forced,\n"
     "    void* stream) {"),
    ("      jb_c);\n  return (int)cudaGetLastError();",
     "      jb_c, mode, forced);\n  return (int)cudaGetLastError();"),
]

# the current explicit kernel: CUT selects the stage taken out
EXPLICIT_CUTS = {
    "full": 0,
    "no deposit": 1,                 # the sweep without its atomics
    "no sweep": 2,
    "no field solve": 3,             # e kept: no scan, no new e
    "cluster barrier, local stores": 4,  # each CTA's totals kept in itself
    "cluster barrier": 5,            # remote stores and cluster.sync a step,
                                     # in place of st.async and the mbarrier
    "barriers and wait only": 6,     # no sweep, sums or solve: the three
                                     # block barriers, the pushes and the wait
    "barriers and cluster barrier only": 7,  # the same with cluster.sync
}
_EXPLICIT_EDITS = [
    ("#include \"cic_common.cuh\"",
     "#include \"cic_common.cuh\"\n#ifndef CUT\n#define CUT 0\n#endif\n"
     "#define SYNC_ONLY (CUT == 6 || CUT == 7)\n"
     "#define CLUSTER_SYNC (CUT == 4 || CUT == 5 || CUT == 7)"),
    ("      const unsigned bar0 = cluster_addr(smem_u32(bars + b), 0);\n"
     "      st_async(cluster_addr(smem_u32(to), 0), ke, bar0);\n"
     "      st_async(cluster_addr(smem_u32(to + 1), 0), jb, bar0);\n",
     "#if CLUSTER_SYNC\n"
     "      double* remote = cluster.map_shared_rank(to, 0);\n"
     "      remote[0] = ke;\n      remote[1] = jb;\n#else\n"
     "      const unsigned bar0 = cluster_addr(smem_u32(bars + b), 0);\n"
     "      st_async(cluster_addr(smem_u32(to), 0), ke, bar0);\n"
     "      st_async(cluster_addr(smem_u32(to + 1), 0), jb, bar0);\n#endif\n"),
    ("#pragma unroll\n"
     "      for (int q = 0; q < kResCtas; ++q)\n"
     "        st_async(cluster_addr(smem_u32(slot), q), x,\n"
     "                 cluster_addr(smem_u32(bars + b), q));\n",
     "#if CLUSTER_SYNC\n"
     "      for (int q = 0; q < kResCtas; ++q)\n"
     "        *cluster.map_shared_rank(slot, CUT == 4 ? rank : q) = x;\n#else\n"
     "      for (int q = 0; q < kResCtas; ++q)\n"
     "        st_async(cluster_addr(smem_u32(slot), q), x,\n"
     "                 cluster_addr(smem_u32(bars + b), q));\n#endif\n"),
    ("    mbar_wait(smem_u32(bars + b), (unsigned)(s >> 1) & 1u);\n"
     "    // the next phase of this mbarrier is step s + 2's; no push of step\n"
     "    // s + 2 can come before this CTA's push of step s + 1\n"
     "    if (t == 0 && s + 2 < steps) mbar_expect(smem_u32(bars + b), bytes);\n",
     "#if CLUSTER_SYNC\n    cluster.sync();\n#else\n"
     "    mbar_wait(smem_u32(bars + b), (unsigned)(s >> 1) & 1u);\n"
     "    if (t == 0 && s + 2 < steps) mbar_expect(smem_u32(bars + b), bytes);\n#endif\n"),
    ("  cg::cluster_group cluster = cg::this_cluster();\n"
     "  const int rank = (int)cluster.block_rank();",
     "  float sink = 0.0f;\n  cg::cluster_group cluster = cg::this_cluster();\n"
     "  const int rank = (int)cluster.block_rank();"),
    ("      if (j * kThreads < lim) {\n        const float v = V[j];",
     "      if (CUT != 2 && !SYNC_ONLY && j * kThreads < lim) {\n"
     "        const float v = V[j];"),
    ("        atomicAdd(&hist[c.l * kResCols + lane], __fmul_rn(w, c.wl));\n"
     "        atomicAdd(&hist[c.r * kResCols + lane], __fmul_rn(w, c.wr));",
     "        if (CUT == 1) {\n"
     "          sink = __fadd_rn(sink, __fadd_rn(__fmul_rn(w, c.wl), __fmul_rn(w, c.wr))"
     " + (float)(c.l * kResCols + lane));\n        } else {\n"
     "        atomicAdd(&hist[c.l * kResCols + lane], __fmul_rn(w, c.wl));\n"
     "        atomicAdd(&hist[c.r * kResCols + lane], __fmul_rn(w, c.wr));\n        }"),
    ("      for (int k = 0; k < kResCols; ++k) x = __fadd_rn(x, hc[(lane + k) & (kResCols - 1)]);\n"
     "      for (int k = 0; k < kResCols; ++k) hc[(lane + k) & (kResCols - 1)] = 0.0f;",
     "      if (!SYNC_ONLY) {\n"
     "      for (int k = 0; k < kResCols; ++k) x = __fadd_rn(x, hc[(lane + k) & (kResCols - 1)]);\n"
     "      for (int k = 0; k < kResCols; ++k) hc[(lane + k) & (kResCols - 1)] = 0.0f;\n      }"),
    ("    if (rank == 0 && warp == kWarps - 1 && s > 0)",
     "    if (!SYNC_ONLY && rank == 0 && warp == kWarps - 1 && s > 0)"),
    ("#pragma unroll\n"
     "        for (int q = 0; q < kResCtas; ++q) r[k] = __fadd_rn(r[k], rv[q * ng]);",
     "        if (!SYNC_ONLY)\n"
     "          for (int q = 0; q < kResCtas; ++q) r[k] = __fadd_rn(r[k], rv[q * ng]);"),
    ("    for (int o = 1; o < 32; o <<= 1) {\n"
     "      const double y = __shfl_up_sync(0xffffffffu, inc, o);",
     "    if (CUT != 3 && !SYNC_ONLY)\n"
     "    for (int o = 1; o < 32; o <<= 1) {\n"
     "      const double y = __shfl_up_sync(0xffffffffu, inc, o);"),
    ("      if (lo + k < hi) {\n        const double rk = (double)r[k];",
     "      if (CUT != 3 && !SYNC_ONLY && lo + k < hi) {\n"
     "        const double rk = (double)r[k];"),
    ("  if (rank == 0) {\n    if (warp == kWarps - 1)",
     "  if (sink == 1.2345e30f) rho_out[0] = sink;\n"
     "  if (rank == 0) {\n    if (warp == kWarps - 1)"),
]

# the current Newton kernels: CUT selects the stage taken out; "(f)"
# launches the full kernel with the first port's padded_rows(ng) threads.
# The cuts without PCR arithmetic run as many stages as the full kernel's
# vote kept (its largest count in the solve, which it reports).
NEWTON_CUTS = {
    "(a) full": 0,
    "(b) no PCR arithmetic": 1,        # stores, barriers and loads kept
    "(c) no residual sum": 2,
    "(d) barriers and exchanges only": 3,
    "(e) divisions as reciprocal products": 4,
    "(f) padded rows (1,024 threads)": 0,
    "(g) no zero-dividend guard": 5,
    "(h) every stage (no vote)": 6,
}
NEWTON_LONG = dict(tol=0.0, maxiter=64)  # the long solve
_NEWTON_EDITS = [
    ("#include \"cic_common.cuh\"",
     "#include \"cic_common.cuh\"\n#ifndef CUT\n#define CUT 0\n#endif\n"
     "#define PASS_THROUGH (CUT == 1 || CUT == 3)\n"
     "#define CUT_EXP(x) (CUT == 3 ? (x) : expf(x))\n"
     "#if CUT == 3\n#define CUT_ADD(x, y) "
     "x = __longlong_as_double(__double_as_longlong(x) ^ __double_as_longlong(y))\n"
     "#else\n#define CUT_ADD(x, y) x += (y)\n#endif", 1),
    ("  const float q = __fdiv_rn(x == 0.0f ? 1.0f : x, y);\n"
     "  return x == 0.0f ? __fmul_rn(x, y) : q;",
     "#if CUT == 4\n  return __fmul_rn(x, __frcp_rn(y));\n#elif CUT == 5\n"
     "  return __fdiv_rn(x, y);\n#else\n"
     "  const float q = __fdiv_rn(x == 0.0f ? 1.0f : x, y);\n"
     "  return x == 0.0f ? __fmul_rn(x, y) : q;\n#endif", 1),
    ("for (int r = 0; r < R; ++r) x.f[r] = __fdiv_rn(x.f[r], x.b);",
     "for (int r = 0; r < R; ++r) x.f[r] = CUT == 4 ? div_rn(x.f[r], x.b) : __fdiv_rn(x.f[r], x.b);", 1),
    ("__device__ int pcr_solve(Row<R>& x, const PcrBuf& buf, int i, int rows) {\n  int k = 0;",
     "__device__ int pcr_solve(Row<R>& x, const PcrBuf& buf, int i, int rows,\n"
     "                         int* stages, int forced_stages) {\n  int k = 0, n = 0;", 1),
    ("    const bool coupled = __syncthreads_or(x.a != 0.0f || x.c != 0.0f);\n"
     "    if (!coupled || s >= rows) break;\n",
     "#if PASS_THROUGH\n    __syncthreads();\n    if (n >= forced_stages || s >= rows) break;\n"
     "#elif CUT == 6\n    __syncthreads();\n    if (s >= rows) break;\n#else\n"
     "    const bool coupled = __syncthreads_or(x.a != 0.0f || x.c != 0.0f);\n"
     "    if (!coupled || s >= rows) break;\n#endif\n    ++n;\n", 1),
    ("    pcr_stage(x, m, p);\n",
     "#if PASS_THROUGH\n"
     "    unsigned u = __float_as_uint(m.a) ^ __float_as_uint(m.b) ^ __float_as_uint(m.c) ^\n"
     "                 __float_as_uint(p.a) ^ __float_as_uint(p.b) ^ __float_as_uint(p.c);\n"
     "    for (int r = 0; r < R; ++r) u ^= __float_as_uint(m.f[r]) ^ __float_as_uint(p.f[r]);\n"
     "    if (u == 0x7fc00001u) x.a = x.b;  // never: keeps the loads\n#else\n"
     "    pcr_stage(x, m, p);\n#endif\n", 1),
    ("  return k;\n}",
     "  if (!PASS_THROUGH && stages != nullptr && threadIdx.x == 0) atomicMax(stages, n);\n"
     "  return k;\n}", 1),
    ("__device__ __forceinline__ void warp_partial(double x, double* red) {\n",
     "__device__ __forceinline__ void warp_partial(double x, double* red) {\n"
     "  if (CUT == 2) return;\n", 1),
    ("__device__ __forceinline__ double block_total(const double* red) {\n",
     "__device__ __forceinline__ double block_total(const double* red) {\n"
     "  if (CUT == 2) return 0.0;\n", 1),
    ("x += __shfl_down_sync(0xffffffffu, x, o);",
     "CUT_ADD(x, __shfl_down_sync(0xffffffffu, x, o));", 2),
    ("expf(fminf(fmaxf(__fmul_rn(c1, phi), -exp_clamp), exp_clamp))",
     "CUT_EXP(fminf(fmaxf(__fmul_rn(c1, phi), -exp_clamp), exp_clamp))", 2),
    ("while (residual > tol && it < maxiter) {",
     "while (forced >= 0 ? it < forced : (residual > tol && it < maxiter)) {", 2),
    ("pcr_solve<1>(x, buf, i, rows);", "pcr_solve<1>(x, buf, i, rows, stages, forced_stages);", 1),
    ("pcr_solve<2>(x, buf, i, rows);", "pcr_solve<2>(x, buf, i, rows, stages, forced_stages);", 1),
    ("float dx2, float tol, int maxiter,\n                                 float step_max, float exp_clamp) {",
     "float dx2, float tol, int maxiter,\n    float step_max, float exp_clamp, int forced, int* stages,\n"
     "    int forced_stages) {", 1),
    ("int maxiter, float step_max,\n                                 float exp_clamp) {",
     "int maxiter, float step_max,\n    float exp_clamp, int forced, int* stages, int forced_stages) {", 1),
    ("float exp_clamp,\n                              void* stream) {",
     "float exp_clamp,\n    int forced, int* stages, int forced_stages, void* stream) {", 1),
    ("float exp_clamp,\n                       void* stream) {",
     "float exp_clamp,\n    int forced, int* stages, int forced_stages, void* stream) {", 1),
    ("maxiter, step_max, exp_clamp);",
     "maxiter, step_max, exp_clamp, forced, stages, forced_stages);", 1),
    ("maxiter,\n      step_max, exp_clamp);",
     "maxiter,\n      step_max, exp_clamp, forced, stages, forced_stages);", 1),
]
# the Newton kernels' first port (one CTA of padded_rows(ng) threads, 13
# block barriers an iteration): CUT selects the stage taken out; "(f)"
# launches the full kernel with the rows rounded up to 32
NEWTON_FIRST_PORT_CUTS = {
    "(a) full": 0,
    "(b) no PCR arithmetic": 1,        # stores, barriers and loads kept
    "(c) no residual sum": 2,
    "(d) barriers and exchanges only": 3,
    "(e) divisions as reciprocal products": 4,
    "(f) rows rounded up to 32": 0,
}
_NEWTON_FIRST_PORT_EDITS = [
    ("#include \"cic_common.cuh\"",
     "#include \"cic_common.cuh\"\n#ifndef CUT\n#define CUT 0\n#endif\n"
     "#if CUT == 2\n#define block_sum(x, red) (x)\n#elif CUT == 3\n"
     "__device__ double block_sum_x(double x, double* red) {\n"
     "  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;\n"
     "  unsigned long long b = (unsigned long long)__double_as_longlong(x);\n"
     "  for (int o = 16; o > 0; o >>= 1) b ^= __shfl_down_sync(0xffffffffu, b, o);\n"
     "  __syncthreads();\n  if (lane == 0) red[warp] = __longlong_as_double((long long)b);\n"
     "  __syncthreads();\n  unsigned long long t = 0;\n"
     "  for (int w = 0; w < (int)(blockDim.x >> 5); ++w)\n"
     "    t ^= (unsigned long long)__double_as_longlong(red[w]);\n"
     "  return __longlong_as_double((long long)t);\n}\n#define block_sum block_sum_x\n#endif\n"
     "#define CUT_EXP(x) (CUT == 3 ? (x) : expf(x))\n"
     "#if CUT == 4\n#define CUT_DIV(x, y) __fmul_rn((x), __frcp_rn(y))\n"
     "#else\n#define CUT_DIV(x, y) __fdiv_rn((x), (y))\n#endif", 1),
    ("    const float alpha = __fdiv_rn(-a, bm);\n"
     "    const float gamma = __fdiv_rn(-c, bp);\n",
     "#if CUT == 1 || CUT == 3\n"
     "    unsigned x = __float_as_uint(am) ^ __float_as_uint(bm) ^ __float_as_uint(cm) ^\n"
     "                 __float_as_uint(ap) ^ __float_as_uint(bp) ^ __float_as_uint(cp);\n"
     "    for (int r = 0; r < R; ++r) x ^= __float_as_uint(fm[r]) ^ __float_as_uint(fp[r]);\n"
     "    if (x == 0x7fc00001u) a = b;  // never: keeps the loads\n#else\n"
     "    const float alpha = CUT_DIV(-a, bm);\n"
     "    const float gamma = CUT_DIV(-c, bp);\n", 1),
    ("    c = __fmul_rn(gamma, cp);\n  }\n",
     "    c = __fmul_rn(gamma, cp);\n#endif\n  }\n", 1),
    ("for (int r = 0; r < R; ++r) f[r] = __fdiv_rn(f[r], b);",
     "for (int r = 0; r < R; ++r) f[r] = CUT_DIV(f[r], b);", 1),
    ("expf(fminf(fmaxf(__fmul_rn(c1, phi), -exp_clamp), exp_clamp))",
     "CUT_EXP(fminf(fmaxf(__fmul_rn(c1, phi), -exp_clamp), exp_clamp))", 2),
    ("while (residual > tol && it < maxiter) {",
     "while (forced >= 0 ? it < forced : (residual > tol && it < maxiter)) {", 2),
    ("float dx2, float tol, int maxiter,\n                                 float step_max, float exp_clamp) {",
     "float dx2, float tol, int maxiter,\n    float step_max, float exp_clamp, int forced) {", 1),
    ("int maxiter, float step_max,\n                                 float exp_clamp) {",
     "int maxiter, float step_max,\n    float exp_clamp, int forced) {", 1),
    ("float exp_clamp,\n                              void* stream) {",
     "float exp_clamp,\n    int forced, void* stream) {", 1),
    ("float exp_clamp,\n                       void* stream) {",
     "float exp_clamp,\n    int forced, void* stream) {", 1),
    ("maxiter, step_max, exp_clamp);", "maxiter, step_max, exp_clamp, forced);", 1),
    ("maxiter,\n      step_max, exp_clamp);", "maxiter,\n      step_max, exp_clamp, forced);", 1),
    ("(ngp & (ngp - 1))", "(ngp & 31)", 2),
]

# the magnetized deposits' first port (csrc/magnetized.cu before the
# redesign: 8 blocks of 256 threads an SM, one (ng,) shared-memory histogram
# an array a block, every node of it flushed by a global float atomic):
# CUT selects the stage taken out; "(f)" launches the full kernel as one
# block of 1,024 threads an SM
DEPOSIT_FIRST_PORT_CUTS = {
    "(a) full": 0,
    "(b) no global flush": 1,        # the totals stored under a predicate never true
    "(c) flush by plain stores": 2,  # into a scratch row of the block's
    "(d) no shared atomics": 3,      # each thread sums its weights in a register
    "(e) sweep only": 4,             # the loads (row 9: and stores); no deposit, no flush
    "(f) one block of 1,024 threads an SM": 0,
}
# (c)'s scratch rows: 1,056 blocks x 2 arrays x 800 nodes at most
_CUT_SCRATCH = 1056 * 2 * 800
_DEPOSIT_FIRST_PORT_EDITS = [
    ("#include \"cic_common.cuh\"",
     "#include \"cic_common.cuh\"\n#ifndef CUT\n#define CUT 0\n#endif\n"
     f"__device__ float cut_scratch[{_CUT_SCRATCH}];", 1),
    # deposit2_kernel
    ("  for (int i = threadIdx.x; i < ng; i += blockDim.x) {\n    s_a[i] = 0.0f;\n",
     "  float sink = 0.0f;\n  if (CUT != 4)\n"
     "  for (int i = threadIdx.x; i < ng; i += blockDim.x) {\n    s_a[i] = 0.0f;\n", 1),
    ("    atomicAdd(&s_a[c.l], __fmul_rn(a, c.wl));\n"
     "    atomicAdd(&s_a[c.r], __fmul_rn(a, c.wr));\n"
     "    atomicAdd(&s_b[c.l], __fmul_rn(b, c.wl));\n"
     "    atomicAdd(&s_b[c.r], __fmul_rn(b, c.wr));\n",
     "#if CUT >= 3\n"
     "    sink = __fadd_rn(sink, __fadd_rn(__fmul_rn(a, c.wl), __fadd_rn(__fmul_rn(b, c.wr),\n"
     "                                                               (float)c.l)));\n"
     "#else\n"
     "    atomicAdd(&s_a[c.l], __fmul_rn(a, c.wl));\n"
     "    atomicAdd(&s_a[c.r], __fmul_rn(a, c.wr));\n"
     "    atomicAdd(&s_b[c.l], __fmul_rn(b, c.wl));\n"
     "    atomicAdd(&s_b[c.r], __fmul_rn(b, c.wr));\n#endif\n", 1),
    ("  for (int i = threadIdx.x; i < ng; i += blockDim.x) {\n"
     "    atomicAdd(&out_a[i], s_a[i]);\n    atomicAdd(&out_b[i], s_b[i]);\n  }\n",
     "  if (sink == 1.2345e30f) out_a[0] = sink;\n  if (CUT != 4)\n"
     "  for (int i = threadIdx.x; i < ng; i += blockDim.x) {\n#if CUT == 1\n"
     "    if (s_a[i] == 1.2345e30f) out_a[i] = s_b[i];\n#elif CUT == 2\n"
     "    cut_scratch[(size_t)blockIdx.x * 2 * ng + i] = s_a[i];\n"
     "    cut_scratch[(size_t)blockIdx.x * 2 * ng + ng + i] = s_b[i];\n#else\n"
     "    atomicAdd(&out_a[i], s_a[i]);\n    atomicAdd(&out_b[i], s_b[i]);\n#endif\n  }\n", 1),
    # boris_deposit_kernel
    ("    s_field[i] = field[i];\n    s_rho[i] = 0.0f;\n    s_n[i] = 0.0f;\n  }\n",
     "    s_field[i] = field[i];\n    if (CUT != 4) {\n    s_rho[i] = 0.0f;\n"
     "    s_n[i] = 0.0f;\n    }\n  }\n  float sink = 0.0f;\n", 1),
    ("    const float wr = wr_in[i];\n    const float wn = wn_in[i];\n",
     "    const float wr = wr_in[i];\n    const float wn = wn_in[i];\n#if CUT == 4\n"
     "    sink = __fadd_rn(sink, __fmul_rn(wr, wn));\n    continue;\n#endif\n", 1),
    ("    if (l >= 0 && l < ng) {\n      atomicAdd(&s_rho[l], __fmul_rn(wr, fl));\n"
     "      atomicAdd(&s_n[l], __fmul_rn(wn, fl));\n    }\n"
     "    if (l + 1 >= 0 && l + 1 < ng) {\n      atomicAdd(&s_rho[l + 1], __fmul_rn(wr, fr));\n"
     "      atomicAdd(&s_n[l + 1], __fmul_rn(wn, fr));\n    }\n",
     "#if CUT == 3\n"
     "    sink = __fadd_rn(sink, __fadd_rn(__fmul_rn(wr, fl), __fadd_rn(__fmul_rn(wn, fr),\n"
     "                                                                 (float)l)));\n#else\n"
     "    if (l >= 0 && l < ng) {\n      atomicAdd(&s_rho[l], __fmul_rn(wr, fl));\n"
     "      atomicAdd(&s_n[l], __fmul_rn(wn, fl));\n    }\n"
     "    if (l + 1 >= 0 && l + 1 < ng) {\n      atomicAdd(&s_rho[l + 1], __fmul_rn(wr, fr));\n"
     "      atomicAdd(&s_n[l + 1], __fmul_rn(wn, fr));\n    }\n#endif\n", 1),
    ("  for (int i = threadIdx.x; i < ng; i += blockDim.x) {\n"
     "    atomicAdd(&rho[i], s_rho[i]);\n    atomicAdd(&dens[i], s_n[i]);\n  }\n",
     "  if (sink == 1.2345e30f) rho[0] = sink;\n  if (CUT != 4)\n"
     "  for (int i = threadIdx.x; i < ng; i += blockDim.x) {\n#if CUT == 1\n"
     "    if (s_rho[i] == 1.2345e30f) rho[i] = s_n[i];\n#elif CUT == 2\n"
     "    cut_scratch[(size_t)blockIdx.x * 2 * ng + i] = s_rho[i];\n"
     "    cut_scratch[(size_t)blockIdx.x * 2 * ng + ng + i] = s_n[i];\n#else\n"
     "    atomicAdd(&rho[i], s_rho[i]);\n    atomicAdd(&dens[i], s_n[i]);\n#endif\n  }\n", 1),
]
# the shapes of the deposit splits: the configs[3] row (n = 999,996, ng =
# 600), the D-N row (n = 50,000, ng = 800) and the carried row's
# re-activation patch (n = react_batch 16,384, ng = 600)
DEPOSIT_SHAPES = {"configs[3]": (999_996, 600), "D-N": (50_000, 800),
                  "carried patch": (16_384, 600)}
# the current deposits (wide at configs[3]: one block of 1,024 threads an
# SM, four rows a thread and pass, 32 lane columns; narrow below: the first
# port's grid): CUT selects the stage taken out; "(f)" to "(h)" launch the
# full kernel at another grid
DEPOSIT_CUTS = {
    "(a) full": 0,
    "(b) no global flush": 1,        # the column sums stored under a predicate never true
    "(c) no column sums or flush": 2,
    "(d) no shared atomics": 3,      # each thread sums its weights in a register
    "(e) sweep only": 4,             # the loads (row 9: and stores); no deposit, no flush
    "(f) 8 columns": 0,
    "(g) 16 columns": 0,
    "(h) the other width": 0,        # narrow at configs[3], wide at the small shapes
}
_DEPOSIT_EDITS = [
    ("#include \"cic_common.cuh\"",
     "#include \"cic_common.cuh\"\n#ifndef CUT\n#define CUT 0\n#endif", 1),
    ("      atomicAdd(out_a + k, h_a[k]);\n      atomicAdd(out_b + k, h_b[k]);",
     "#if CUT == 1\n      if (h_a[k] == 1.2345e30f) out_a[k] = h_b[k];\n#else\n"
     "      atomicAdd(out_a + k, h_a[k]);\n      atomicAdd(out_b + k, h_b[k]);\n#endif", 1),
    ("    atomicAdd(out_a + k, a);\n    atomicAdd(out_b + k, b);",
     "#if CUT == 1\n    if (a == 1.2345e30f) out_a[k] = b;\n#else\n"
     "    atomicAdd(out_a + k, a);\n    atomicAdd(out_b + k, b);\n#endif", 1),
    ("  zero_shared(h_a, 2 * ng * cols);", "  if (CUT != 4) zero_shared(h_a, 2 * ng * cols);", 1),
    ("  zero_shared(h_r, 2 * ng * cols);", "  if (CUT != 4) zero_shared(h_r, 2 * ng * cols);", 1),
    ("  if (ROWS == 1) {  // narrow", "  float sink = 0.0f;\n  if (ROWS == 1) {  // narrow", 2),
    # deposit2: the narrow path's adds, then the wide path's
    ("      atomicAdd(&h_a[c.l], __fmul_rn(a, c.wl));\n"
     "      atomicAdd(&h_a[c.r], __fmul_rn(a, c.wr));\n"
     "      atomicAdd(&h_b[c.l], __fmul_rn(b, c.wl));\n"
     "      atomicAdd(&h_b[c.r], __fmul_rn(b, c.wr));\n",
     "#if CUT >= 3\n"
     "      sink = __fadd_rn(sink, __fadd_rn(__fmul_rn(a, c.wl), __fadd_rn(__fmul_rn(b, c.wr),\n"
     "                                                                   (float)c.l)));\n"
     "#else\n"
     "      atomicAdd(&h_a[c.l], __fmul_rn(a, c.wl));\n"
     "      atomicAdd(&h_a[c.r], __fmul_rn(a, c.wr));\n"
     "      atomicAdd(&h_b[c.l], __fmul_rn(b, c.wl));\n"
     "      atomicAdd(&h_b[c.r], __fmul_rn(b, c.wr));\n#endif\n", 1),
    ("        atomicAdd(&h_a[c.l * cols + col], __fmul_rn(a, c.wl));\n"
     "        atomicAdd(&h_a[c.r * cols + col], __fmul_rn(a, c.wr));\n"
     "        atomicAdd(&h_b[c.l * cols + col], __fmul_rn(b, c.wl));\n"
     "        atomicAdd(&h_b[c.r * cols + col], __fmul_rn(b, c.wr));\n",
     "#if CUT >= 3\n"
     "        sink = __fadd_rn(sink, __fadd_rn(__fmul_rn(a, c.wl), __fadd_rn(__fmul_rn(b, c.wr),\n"
     "                                                                   (float)(c.l * cols + col))));\n"
     "#else\n"
     "        atomicAdd(&h_a[c.l * cols + col], __fmul_rn(a, c.wl));\n"
     "        atomicAdd(&h_a[c.r * cols + col], __fmul_rn(a, c.wr));\n"
     "        atomicAdd(&h_b[c.l * cols + col], __fmul_rn(b, c.wl));\n"
     "        atomicAdd(&h_b[c.r * cols + col], __fmul_rn(b, c.wr));\n#endif\n", 1),
    ("  flush_columns<ROWS>(h_a, h_b, ng, cols, out_a, out_b);",
     "  if (sink == 1.2345e30f) out_a[0] = sink;\n"
     "  if (CUT != 2 && CUT != 4) flush_columns<ROWS>(h_a, h_b, ng, cols, out_a, out_b);", 1),
    # row 9: no deposit arithmetic in (e), its weights still read
    ("  idx[0] = idx[1] = idx[2] = idx[3] = -1;\n",
     "  idx[0] = idx[1] = idx[2] = idx[3] = -1;\n"
     "  if (CUT == 4) {\n    if (wr == 1.2345e30f && wn == 1.0f) idx[0] = 0;\n    return;\n  }\n", 1),
    ("        if (idx[k] >= 0) atomicAdd(h_r + idx[k], val[k]);",
     "#if CUT >= 3\n"
     "        if (idx[k] >= 0) sink = __fadd_rn(sink, __fmul_rn(val[k], (float)idx[k]));\n"
     "#else\n        if (idx[k] >= 0) atomicAdd(h_r + idx[k], val[k]);\n#endif", 2),
    ("  flush_columns<ROWS>(h_r, h_r + (size_t)ng * cols, ng, cols, rho, dens);",
     "  if (sink == 1.2345e30f) rho[0] = sink;\n"
     "  if (CUT != 2 && CUT != 4) flush_columns<ROWS>(h_r, h_r + (size_t)ng * cols, ng, cols,"
     " rho, dens);", 1),
]


def _other_width(shape, n: int, ng: int, field: bool, sms: int):
    """The grid of the other width than ``shape``'s at (n, ng): the first
    port's at a wide shape, one block of 1,024 an SM with as many columns
    as shared memory holds (at most 32) at a narrow one."""
    if shape.rows == 4:
        return dataclasses.replace(shape, rows=1, blocks=min(-(-n // 256), 8 * sms),
                                   threads=256, cols=1)
    wide = cuda_cic.deposit_launch_shape(4 * 1024 * sms, ng, field, sms)
    return dataclasses.replace(wide, blocks=min(sms, -(-n // (4 * 1024))))


def _variant(tag: str, shape, n: int, ng: int, field: bool, sms: int):
    """The launch of a current-kernel cut: the shape, or (f)-(h)'s."""
    if tag.startswith("(h)"):
        return _other_width(shape, n, ng, field, sms)
    cols = {"(f)": 8, "(g)": 16}.get(tag[:3])
    if cols is None or shape.rows == 1:
        return shape
    return dataclasses.replace(shape, cols=cols)

_P, _I, _F, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_double
_CURRENT_ARGS = [_P] * 17 + [_I] * 5 + [_F] * 7 + [_I] * 5 + [_D] * 3 + [_P, _P]
_FIRST_PORT_ARGS = [_P] * 18 + [_I] * 3 + [_F] * 7 + [_I] * 5 + [_D] * 3 + [_I, _P, _P]
# the Newton launchers' arguments: the first port's with the forced count
# before the stream, the current ones' also with the stage count's
# pointer and the forced stage count
_NEWTON_ARGS = {
    ("newton_dd", "first port"): [_P] * 6 + [_I, _I] + [_F] * 5 + [_I, _F, _F, _I, _P],
    ("newton_dn", "first port"): [_P] * 6 + [_I, _I] + [_F] * 4 + [_I, _F, _F, _I, _P],
    ("newton_dd", "current"): [_P] * 6 + [_I, _I] + [_F] * 5 + [_I, _F, _F, _I, _P, _I, _P],
    ("newton_dn", "current"): [_P] * 6 + [_I, _I] + [_F] * 4 + [_I, _F, _F, _I, _P, _I, _P],
}


# the first port's deposit launchers: no scratch, no columns or clusters
_L = ctypes.c_longlong
_DEPOSIT_FIRST_PORT_ARGS = {
    "pypic_deposit2": [_P] * 5 + [_L, _I, _I, _I, _I, _P],
    "pypic_boris_gather_push_deposit": (
        [_P] * 16 + [_L, _I, _F, _F, _F, _F, _I, _I, _I, _F, _I, _I, _I, _P]),
}


def _edited(text: str, edits) -> str:
    """Each edit is (old, new) or (old, new, times): ``old`` must stand in
    the source exactly ``times`` times (once by default)."""
    for old, new, *times in edits:
        want = times[0] if times else 1
        if text.count(old) != want:
            raise RuntimeError(f"the cut's anchor is not in the source {want} time(s): "
                               f"{old[:60]!r}")
        text = text.replace(old, new)
    return text


def _build_all(jobs) -> tuple[dict, dict]:
    """jobs: {tag: (source text, extra nvcc flags)} -> ({tag: loaded CDLL},
    {tag: the compiler's log}), one nvcc each, all at once."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for tag, (text, flags) in jobs.items():
        stem = "".join(ch if ch.isalnum() else "_" for ch in tag)
        src = OUT_DIR / f"{stem}.cu"
        src.write_text(text)
        lib = OUT_DIR / f"lib{stem}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I", str(_build.CSRC_DIR),
               *flags, "-o", str(lib), str(src)]
        procs[tag] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    libs, logs = {}, {}
    for tag, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {tag}:\n{log}")
        libs[tag], logs[tag] = ctypes.CDLL(str(lib)), log
    return libs, logs


def _kernel_report(log: str, word: str) -> list:
    """Registers and spill of each kernel whose (mangled) name holds
    ``word``, from the ``-Xptxas -v`` log."""
    out, name = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and word in name and ("spill" in line or "registers" in line):
            out.append(f"{name}: {line.strip()}")
    return out


def _atomics(lib_path: Path, word: str = "") -> dict:
    """Shared-memory atomic opcodes in the SASS of a library's kernels whose
    name holds ``word``, by count."""
    tool = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(lib_path)], capture_output=True,
                          text=True).stdout
    counts, inside = {}, True
    for line in sass.splitlines():
        if "Function :" in line:
            inside = word in line
        if not inside:
            continue
        for w in line.replace(";", " ").split():
            if w.startswith("ATOMS"):
                counts[w] = counts.get(w, 0) + 1
    return counts


def _timed(fn, reps: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _queued(fn, calls: int = 20, reps: int = 5) -> float:
    """ms a call of a launch shorter than the host's launch time: ``calls``
    launches queued behind a sleep between two CUDA events, the median of
    ``reps`` rounds."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def _split_implicit(args, dev) -> tuple[dict, dict, dict]:
    """The implicit kernel's jobs and their calls at the configs[1] row."""
    jobs = {}
    current = _edited((_build.CSRC_DIR / "implicit.cu").read_text(), _CURRENT_EDITS)
    for tag, cut in CURRENT_CUTS.items():
        jobs[tag] = (current, [f"-DCUT={cut}"])
    if args.first_port:
        first = _edited(args.first_port.read_text(), _FIRST_PORT_EDITS)
        for tag in FIRST_PORT_CUTS:
            jobs[tag] = (first, [])
        jobs["(a') restrict"] = (first, ["-DRP=__restrict__"])
    libs, logs = _build_all(jobs)
    for tag in ("full", "(a) as is"):
        if tag in libs:
            print(f"[sass] {tag}: {_atomics(Path(libs[tag]._name))}", flush=True)
            for line in _kernel_report(logs[tag], "resident"):
                print(f"[ptxas] {tag}: {line}", flush=True)

    cfg, st = landau.state(landau.N, dev)
    kw = implicit.resident_kwargs(st, cfg)
    ng, steps, n = cfg.grid.ng, landau.STEPS_PER_CALL, landau.N
    shape = cuda_cic.implicit_resident_shape(n, ng)
    qm_dt, qm_dt2_half, dt_dx, wf = cuda_cic.kernel_scalars(kw["qm"], kw["dt"], kw["dx"], kw["w"])
    scalars = (qm_dt, qm_dt2_half, dt_dx, wf, cuda_cic._inv(ng),
               float(np.float32(kw["dt"] / EPSILON_0)), float(np.float32(kw["tol"])),
               int(kw["maxiter"]), int(kw["extrapolate"]))
    anderson = int(kw["anderson"])
    tail = (int(kw["smooth"]), int(kw["tracer"]), float(kw["fe_c"]), float(kw["ke_c"]),
            float(np.float32(wf) / np.float32(ng)))
    p1, v1, ps = torch.empty_like(st.p), torch.empty_like(st.v), torch.empty_like(st.p)
    fields = torch.empty((3, ng), dtype=torch.float32, device=dev)
    rows = torch.zeros((6, steps), dtype=torch.float32, device=dev)
    iters = torch.zeros((steps,), dtype=torch.int32, device=dev)
    inputs = [t.data_ptr() for t in (st.e, st.e_prev, st.j, st.p, st.v, p1, v1)]
    outputs = [t.data_ptr() for t in (fields[0], fields[1], fields[2], rows[0], rows[1],
                                      rows[2], iters, rows[3], rows[4], rows[5])]
    stream = torch.cuda.current_stream().cuda_stream
    # the pass counts of the full kernel, which every cut runs
    ref = cuda_cic.implicit_resident(st.e, st.e_prev, st.j, st.p, st.v, ng, steps, **kw)
    forced = ref[5]["iters"].clone()
    passes = int(forced.sum())

    def current_call(lib, cut):
        err = lib.pypic_implicit_resident(
            *inputs, *outputs, n, shape.per_cta, ng, shape.cols, steps, *scalars,
            anderson, *tail, forced.data_ptr() if cut else None, stream)
        _build.check(err, "resident_split")

    def first_port_call(lib, mode):
        err = lib.pypic_implicit_resident(
            *inputs, ps.data_ptr(), *outputs, n, ng, steps, *scalars, anderson,
            *tail, mode, forced.data_ptr(), stream)
        _build.check(err, "resident_split")

    calls = {}
    for tag, lib in libs.items():
        fn = lib.pypic_implicit_resident
        fn.restype = _I
        if tag in CURRENT_CUTS:
            fn.argtypes = _CURRENT_ARGS
            calls[tag] = functools.partial(current_call, lib, CURRENT_CUTS[tag])
        else:
            fn.argtypes = _FIRST_PORT_ARGS
            calls[tag] = functools.partial(first_port_call, lib, FIRST_PORT_CUTS.get(tag, 0))
    res = {"n": n, "ng": ng, "steps": steps, "passes": passes}
    return res, calls, {"per": "pass", "count": passes}


def _split_explicit(_args, dev) -> tuple[dict, dict, dict]:
    """The explicit kernel's jobs and their calls at the configs[0] row:
    one 2,000-step launch at n = 10,000, ng = 200."""
    current = _edited((_build.CSRC_DIR / "explicit.cu").read_text(), _EXPLICIT_EDITS)
    jobs = {tag: (current, [f"-DCUT={cut}"]) for tag, cut in EXPLICIT_CUTS.items()}
    libs, logs = _build_all(jobs)
    print(f"[sass] full: {_atomics(Path(libs['full']._name), 'resident')}", flush=True)
    for line in _kernel_report(logs["full"], "resident"):
        print(f"[ptxas] full: {line}", flush=True)

    steps = EXPLICIT_STEPS
    stream = torch.cuda.current_stream().cuda_stream
    loads = {}
    for n in EXPLICIT_NS:
        cfg, _, st = two_stream.state(n, dev)
        kw = explicit.resident_kwargs(st, cfg)
        ng = cfg.grid.ng
        qmh, dt_dx, wf = cuda_cic.leapfrog_scalars(kw["qm"], kw["dt"], kw["dx"], kw["w"])
        scalars = (qmh, dt_dx, wf, cuda_cic._inv(ng), cuda_cic._solve_coef(kw["dx"]),
                   float(kw["fe_c"]), float(kw["ke_c"]), float(kw["jb_c"]))
        out = (torch.empty_like(st.p), torch.empty_like(st.v),
               torch.empty((2, ng), dtype=torch.float32, device=dev),
               torch.empty((3, steps), dtype=torch.float32, device=dev))
        ptrs = [t.data_ptr() for t in (st.e, st.p, st.v, out[0], out[1], out[2][0],
                                       out[2][1], out[3][0], out[3][1], out[3][2])]
        loads[n] = (st, out, ptrs, scalars)

    def call(lib, n):
        shape = cuda_cic.explicit_resident_shape(n, ng)
        err = lib.pypic_explicit_resident(*loads[n][2], n, shape.per_cta, ng, steps,
                                          *loads[n][3], stream)
        _build.check(err, "resident_split")

    n = EXPLICIT_NS[0]
    calls = {}
    for tag, lib in libs.items():
        fn = lib.pypic_explicit_resident
        fn.argtypes, fn.restype = _build._SIGNATURES["pypic_explicit_resident"]
        calls[tag] = functools.partial(call, lib, n)
    for m in EXPLICIT_NS[1:]:
        calls[f"full, n = {m}"] = functools.partial(call, libs["full"], m)
    return {"n": n, "ng": ng, "steps": steps}, calls, {"per": "step", "count": steps}


def newton_load(kernel: str, dev) -> dict:
    """The row's first solve: (ng,) density, n0 = 0.9 <n> on the card, the
    warm start (None: cold), te, dx and the row's tol and maxiter."""
    from ..ops import cuda_cic as K
    from . import magnetized as row

    if kernel == "newton_dd":
        cfg, st, _ = row.state(dev)
        w_rho = st.charge_state * 1.602e-19 * st.p2c / cfg.grid.dx
        dens, n_dens = K.deposit2(st.p, w_rho, st.p2c / cfg.grid.dx, cfg.grid.ng,
                                  periodic=False)
        phi0, tol, maxiter = None, cfg.newton_tol, cfg.newton_maxiter
    else:
        pre = row.preset("dn", dev)
        cfg, st = pre.config, pre.state
        _, n_dens = K.deposit2(st.p, st.p2c / cfg.grid.dx, st.p2c / cfg.grid.dx,
                               cfg.grid.ng, periodic=False)
        dens = n_dens
        phi0 = torch.zeros(cfg.grid.ng, dtype=torch.float32, device=dev)
        tol, maxiter = 1e-3, 100  # the wrapper's, as the engine passes them
    return dict(dens=dens, n0=(0.9 * torch.mean(n_dens)).reshape(1), phi0=phi0,
                te=cfg.te, dx=cfg.grid.dx, ng=cfg.grid.ng, tol=tol, maxiter=maxiter)


def _split_newton(args, dev) -> tuple[dict, dict, dict]:
    """A Newton kernel's cuts at its row's first solve, and the long solve;
    with --first-port, the first port's cuts beside them."""
    from ..ops import cuda_newton

    versions = {"current": (_build.CSRC_DIR / "newton.cu", _NEWTON_EDITS, NEWTON_CUTS)}
    if args.first_port:
        versions["first port"] = (args.first_port, _NEWTON_FIRST_PORT_EDITS,
                                  NEWTON_FIRST_PORT_CUTS)
    jobs, cuts = {}, {}
    for version, (path, edits, table) in versions.items():
        text = _edited(path.read_text(), edits)
        for tag, cut in table.items():
            name = tag if version == "current" else f"first port {tag}"
            cuts[name] = (version, tag)
            if not tag.startswith("(f)"):
                jobs[name] = (text, [f"-DCUT={cut}"])
    libs, logs = _build_all(jobs)
    for name, (version, tag) in cuts.items():
        if tag.startswith("(f)"):
            libs[name] = libs[name.replace(tag, "(a) full")]
    word = "newton_dd" if args.kernel == "newton_dd" else "newton_dn"
    for tag in jobs:
        for line in _kernel_report(logs[tag], word):
            print(f"[ptxas] {tag}: {line}", flush=True)

    load = newton_load(args.kernel, dev)
    ng = load["ng"]
    c1, dx2, _, step_max = cuda_newton.newton_scalars(load["te"], load["dx"], 0.0)
    phi = torch.empty(ng, dtype=torch.float32, device=dev)
    iters = torch.zeros((), dtype=torch.int32, device=dev)
    resid = torch.empty((), dtype=torch.float32, device=dev)
    stages = torch.zeros((), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    rows = {"current": cuda_newton.kernel_rows(ng), "first port": cuda_newton.padded_rows(ng)}
    other = {"current": rows["first port"], "first port": rows["current"]}

    def call(lib, version, threads, tol, maxiter, forced, forced_stages=0):
        tol32 = float(np.float32(tol))
        tail = (forced,) if version == "first port" else (forced, stages.data_ptr(),
                                                          forced_stages)
        if args.kernel == "newton_dd":
            err = lib.pypic_boltzmann_dirichlet(
                load["dens"].data_ptr(), load["n0"].data_ptr(), None, phi.data_ptr(),
                iters.data_ptr(), resid.data_ptr(), ng, threads, cuda_newton._COEF,
                float(np.float32(EPSILON_0)), c1, dx2, tol32, maxiter, step_max,
                cuda_newton._EXP_CLAMP, *tail, stream)
        else:
            err = lib.pypic_boltzmann_dn(
                load["dens"].data_ptr(), load["n0"].data_ptr(), load["phi0"].data_ptr(),
                phi.data_ptr(), iters.data_ptr(), resid.data_ptr(), ng, threads,
                cuda_newton._COEF, c1, dx2, tol32, maxiter, step_max,
                cuda_newton._EXP_CLAMP, *tail, stream)
        _build.check(err, "resident_split")

    for name, lib in libs.items():
        fn = lib.pypic_boltzmann_dirichlet if args.kernel == "newton_dd" else lib.pypic_boltzmann_dn
        fn.argtypes, fn.restype = _NEWTON_ARGS[args.kernel, cuts[name][0]], _I
    res = {"ng": ng, "rows": rows}
    for version in versions:
        full = libs["(a) full" if version == "current" else "first port (a) full"]
        for key, (tol, maxiter) in {"row": (load["tol"], load["maxiter"]),
                                    "long": (NEWTON_LONG["tol"], NEWTON_LONG["maxiter"])}.items():
            stages.zero_()
            call(full, version, rows[version], tol, maxiter, -1)
            res[f"{version} iterations {key}"] = int(iters)
            if version == "current":
                res[f"current stages {key}"] = int(stages)
            call(full, version, other[version], tol, maxiter, -1)
            res[f"{version} iterations {key}, other rows"] = int(iters)
    forced, forced_stages = res["current iterations row"], res["current stages row"]
    calls, counts = {}, {}
    for name, (version, tag) in cuts.items():
        threads = other[version] if tag.startswith("(f)") else rows[version]
        natural = tag.startswith(("(a)", "(f)"))
        calls[name] = functools.partial(call, libs[name], version, threads, load["tol"],
                                        load["maxiter"], -1 if natural else forced,
                                        forced_stages)
        counts[name] = forced
        if natural:
            calls[f"{name}, long solve"] = functools.partial(
                call, libs[name], version, threads, NEWTON_LONG["tol"],
                NEWTON_LONG["maxiter"], -1)
            counts[f"{name}, long solve"] = res[f"{version} iterations long"]
    return res, calls, {"per": "iteration", "count": counts, "timer": _queued}


def deposit_inputs(n: int, ng: int, dev, seed: int = 17) -> dict:
    """chip_smoke.py's inputs of the magnetized deposits at (n, ng): bounded
    positions with a tenth of the rows inactive and a few at and past the
    walls, velocities of 2e4 m/s, charge states 1-5; deposit2's weights
    (vx and |vy| masked by the status) and row 9's (a number density and its
    charge, 0 where inactive or off the grid)."""
    f32 = torch.float32
    gen = torch.Generator(device=dev).manual_seed(seed)
    p = torch.rand(n, generator=gen, device=dev, dtype=f32) * (ng - 1)
    p[:4] = torch.tensor([0.0, ng - 1.0, -0.3, ng - 0.7], device=dev)
    v = torch.randn((3, n), generator=gen, device=dev, dtype=f32) * 2e4
    act = (torch.rand(n, generator=gen, device=dev) < 0.9).to(f32)
    act[2:4] = 0.0
    z = torch.randint(1, 6, (n,), generator=gen, device=dev).to(f32)
    const = z * (0.5 * 1e-10 * 1.602e-19 / (10.81 * 1.67e-27))
    field = torch.randn(ng, generator=gen, device=dev, dtype=f32) * 1e5
    live = act * ((p >= 0) & (p <= ng - 1)).to(f32)
    wn = live * 1e17
    return dict(p=p, va=v[0] * act, vb=v[1].abs() * act, field=field, vx=v[0], vy=v[1],
                vz=v[2], const=const, act=live, wr=wn * const * (1.602e-19 / const.max()),
                wn=wn)


def _deposit_first_port_call(lib, kernel: str, load: dict, blocks: int, threads: int,
                             stream) -> None:
    """One launch of the first port's deposit2 (bounded) or carried Boris
    deposit (pad 2, mirrored) on ``load``'s inputs, outputs not zeroed."""
    n, ng, out = load["n"], load["ng"], load["out"]
    if kernel == "deposit2":
        err = lib.pypic_deposit2(load["p"].data_ptr(), load["va"].data_ptr(),
                                 load["vb"].data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
                                 n, ng, 0, blocks, threads, stream)
    else:
        stride, num_k, inv_stride = cuda_cic._carry_frame(ng)
        bx, by, bz, dt_dx = cuda_cic.boris_scalars((0.1395, 1.9951, 0.0), 1e-10 / 2.5e-6)
        err = lib.pypic_boris_gather_push_deposit(
            *(load[k].data_ptr() for k in ("field", "p", "vx", "vy", "vz", "const", "act",
                                           "wr", "wn")),
            *(t.data_ptr() for t in load["rows"]), out[0].data_ptr(), out[1].data_ptr(),
            load["count"].data_ptr(), n, ng, bx, by, bz, dt_dx, 1, stride, num_k,
            inv_stride, 2, blocks, threads, stream)
    _build.check(err, "resident_split")


def _deposit_call(lib, kernel: str, load: dict, shape, stream) -> None:
    """One launch of the current deposit2 (bounded) or carried Boris deposit
    (pad 2, mirrored) on ``load``'s inputs at the launch ``shape``, outputs
    not zeroed."""
    n, ng, out = load["n"], load["ng"], load["out"]
    grid = (shape.rows, shape.blocks, shape.threads, shape.cols, stream)
    if kernel == "deposit2":
        err = lib.pypic_deposit2(load["p"].data_ptr(), load["va"].data_ptr(),
                                 load["vb"].data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
                                 n, ng, 0, *grid)
    else:
        stride, num_k, inv_stride = cuda_cic._carry_frame(ng)
        bx, by, bz, dt_dx = cuda_cic.boris_scalars((0.1395, 1.9951, 0.0), 1e-10 / 2.5e-6)
        err = lib.pypic_boris_gather_push_deposit(
            *(load[k].data_ptr() for k in ("field", "p", "vx", "vy", "vz", "const", "act",
                                           "wr", "wn")),
            *(t.data_ptr() for t in load["rows"]), out[0].data_ptr(), out[1].data_ptr(),
            load["count"].data_ptr(), n, ng, bx, by, bz, dt_dx, 1, stride, num_k,
            inv_stride, 2, *grid)
    _build.check(err, "resident_split")


def _split_deposit(args, dev) -> tuple[dict, dict, dict]:
    """The magnetized deposits' cuts (deposit2, or the carried Boris deposit
    of row 9) at the configs[3] and D-N shapes; with --first-port, the
    first port's cuts beside them."""
    versions = {"current": (_build.CSRC_DIR / "magnetized.cu", _DEPOSIT_EDITS, DEPOSIT_CUTS)}
    if args.first_port:
        versions["first port"] = (args.first_port, _DEPOSIT_FIRST_PORT_EDITS,
                                  DEPOSIT_FIRST_PORT_CUTS)
    jobs, cuts = {}, {}
    for version, (path, edits, table) in versions.items():
        text = _edited(path.read_text(), edits)
        for tag, cut in table.items():
            name = f"{version} {tag}"
            cuts[name] = (version, tag)
            if tag.startswith("(a)") or not cut == 0:
                jobs[name] = (text, [f"-DCUT={cut}"])
    libs, logs = _build_all(jobs)
    word = "deposit2" if args.kernel == "deposit2" else "boris_deposit"
    for tag in jobs:
        for line in _kernel_report(logs[tag], word):
            print(f"[ptxas] {tag}: {line}", flush=True)
        if tag.endswith("(a) full"):
            print(f"[sass] {tag}: {_atomics(Path(libs[tag]._name), word)}", flush=True)
    for name, (version, tag) in cuts.items():
        if name not in libs:  # another launch of the full kernel
            libs[name] = libs[f"{version} (a) full"]
    for name, lib in libs.items():
        for fn in ("pypic_deposit2", "pypic_boris_gather_push_deposit"):
            getattr(lib, fn).argtypes = (_build._SIGNATURES[fn][0] if cuts[name][0] == "current"
                                         else _DEPOSIT_FIRST_PORT_ARGS[fn])
            getattr(lib, fn).restype = _I
    stream = torch.cuda.current_stream().cuda_stream
    sms = cuda_cic._sm_count(dev.index)
    field = args.kernel != "deposit2"
    calls, res = {}, {"shapes": DEPOSIT_SHAPES, "launch": {}}
    for shape, (n, ng) in DEPOSIT_SHAPES.items():
        load = dict(deposit_inputs(n, ng, dev), n=n, ng=ng,
                    out=torch.zeros((2, ng), dtype=torch.float32, device=dev),
                    rows=cuda_cic.padded_rows(4, n, dev),
                    count=torch.zeros((), dtype=torch.int32, device=dev))
        current = cuda_cic.deposit_launch_shape(n, ng, field, sms)
        res["launch"][shape] = dataclasses.asdict(current)
        blocks = cuda_cic._blocks(n, dev)
        if blocks * 2 * ng > _CUT_SCRATCH:
            raise RuntimeError(f"(c)'s scratch holds {_CUT_SCRATCH} floats, not "
                               f"{blocks} x 2 x {ng}")
        for name, (version, tag) in cuts.items():
            if version == "current":
                calls[f"{shape}: {name}"] = functools.partial(
                    _deposit_call, libs[name], args.kernel, load,
                    _variant(tag, current, n, ng, field, sms), stream)
                continue
            grid = (sms, 1024) if tag.startswith("(f)") else (blocks, cuda_cic._THREADS)
            calls[f"{shape}: {name}"] = functools.partial(
                _deposit_first_port_call, libs[name], args.kernel, load, *grid, stream)
    return res, calls, {"per": "launch", "count": 1, "timer": _queued}


def main() -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=("implicit", "explicit", "newton_dd", "newton_dn",
                                         "deposit2", "boris_deposit"),
                    default="implicit")
    ap.add_argument("--first-port", type=Path,
                    help="the kernel's first port (its csrc/implicit.cu, newton.cu or "
                         "magnetized.cu), split as well")
    args = ap.parse_args()
    if args.first_port and args.kernel == "explicit":
        ap.error("--first-port splits the implicit and the Newton kernels only")
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    split = {"explicit": _split_explicit, "newton_dd": _split_newton,
             "newton_dn": _split_newton, "deposit2": _split_deposit,
             "boris_deposit": _split_deposit}.get(args.kernel, _split_implicit)
    res, calls, unit = split(args, dev)
    res = {"kernel": args.kernel, "device": torch.cuda.get_device_name(0), **res, "ms": {}}
    for _ in range(2):
        for tag, call in calls.items():
            try:
                ms = unit.get("timer", _timed)(call)
            except RuntimeError as e:  # a launch the card refuses, e.g. for registers
                print(f"[split] {tag}: {str(e)[:200]}", flush=True)
                res["ms"].setdefault(tag, []).append(None)
                continue
            res["ms"].setdefault(tag, []).append(ms)
            count = unit["count"][tag] if isinstance(unit["count"], dict) else unit["count"]
            print(f"[split] {tag}: {ms:.4f} ms, {ms * 1e3 / count:.3f} us a "
                  f"{unit['per']}", flush=True)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
