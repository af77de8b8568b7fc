"""Where a launch of a resident kernel spends its time, on the card: copies
of a kernel source with one stage cut out, each built by nvcc into its own
library outside the package's.

    python -m pypic_tpu_torch.tools.resident_split [--first-port SOURCE]
    python -m pypic_tpu_torch.tools.resident_split --kernel explicit
    python -m pypic_tpu_torch.tools.resident_split --kernel newton_dd|newton_dn [--first-port SOURCE]
    python -m pypic_tpu_torch.tools.resident_split --kernel newton_dd_large|newton_dn_large
    python -m pypic_tpu_torch.tools.resident_split --kernel deposit2|boris_deposit [--first-port SOURCE]
    python -m pypic_tpu_torch.tools.resident_split --kernel picard_iteration
    python -m pypic_tpu_torch.tools.resident_split --kernel picard_iteration_ext|leapfrog_deposit

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

``--kernel newton_dd_large`` and ``--kernel newton_dn_large`` split the
Newton solves' large path (above 1,024 rows) at NEWTON_LARGE_SHAPES
(4,096, 16,384 and 262,144 rows in float32, 16,384 in float64; phase
24's load), each cut for 8 and for 64 iterations at tol 0, and report
the us a further iteration of each (``further_us``): the one-CTA mode
'single' (a) as it is, (b) without its PCR, (c) with the PCR and its
barriers alone (no sweeps, no recovery: its end rows as the last full
run left them), (d) at 4,096 rows (D-D, float32) with its scratch in
shared memory; and (e) the cluster mode at C = 2, 4, 8 and 16 CTAs
(``cuda_newton.large_shape``'s threads). ``chip_smoke.py`` phase 24
times cut (c), the one-CTA latency floor, beside its forced pairs
(``start_newton_floor_build``, ``newton_floor_us``).

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

``--kernel picard_iteration`` splits rows 1 and 2's pass (``csrc/cic.cu``
``picard_iteration_kernel``, ``cic_common.cuh`` inlined) at
``PASS_SHAPES`` (n = 1e7 and 1e8 x ng 65,536, 262,144 and 2^20, float32
and float64, random rows as ``chip_smoke.py``'s), row 1 without v1:
(a) the global mode, (b) no adds (the stores kept), (c) each row's two
products stored to a (2 n,) scratch (no atomics), (d) the cluster mode
(the slices of a thread-block cluster, where the largest cluster holds
ng), (e) the pair mode (one ``red.global.add.v2.f32`` a row into a
(ng, 2) pair array, then the fold; float32), (f) the cluster mode with
each add an explicit ``mapa`` and ``red.shared::cluster``. It prints
the atomic and reduction instructions of each mode (cuobjdump) and the
registers.

``--kernel picard_iteration_ext`` splits row 17, the slab's Picard pass
(``csrc/domain.cu`` ``picard_iteration_ext_kernel``, the separate window
without v1 as configs[4]'s passes launch it, 5% dead slots), at
``EXT_SHAPES`` (n = 1e7 x ext_n 32,768, 38,700, 65,536 and 2^20; 2.5e5
and 1e6 rows at 38,700), and ``--kernel leapfrog_deposit`` row 14
(``csrc/explicit.cu`` ``leapfrog_deposit_kernel``) at
``LEAPFROG_SHAPES`` (n = 1e7 x ng 32,768, 65,536 and 2^20 in float32,
32,768 and 65,536 in float64; 1e6 rows at 32,768): (a) the
global mode, (b) no adds (the loads, the push and the stores), (c) the
adds alone (each row's position read and its two global atomics, no
gather, push or store), (d) the cluster mode (where a cluster holds the
nodes; C = 1 up to 58,112 float nodes), (e) the pair mode (float32). It
prints the atomic and reduction instructions of each mode (cuobjdump)
and the registers.

``--kernel deposit``, ``--kernel deposit_det`` and ``--kernel
source_batch`` split row 4 (``csrc/cic.cu``, with ``cic_common.cuh``
inlined so that a cut reaches the shared flush) at ``SINGLE_SHAPES`` and
``DET_SHAPES``, and row 20 (``csrc/rng.cu``) at ``SOURCE_NS``, with its
SASS loop count a row and that count's issue time. With
``--first-port`` (the parent's ``cic.cu``, its ``cic_common.cuh`` taken
from beside it, or ``rng.cu``) the first port's cuts stand beside them.
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
from ..ops import _build, cic, cuda_cic, cuda_rng
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
     "#define CUT_EXP(x) (CUT == 3 ? (x) : exp_of(x))\n"
     "#if CUT == 3\n#define CUT_ADD(x, y) "
     "x = __longlong_as_double(__double_as_longlong(x) ^ __double_as_longlong(y))\n"
     "#else\n#define CUT_ADD(x, y) x += (y)\n#endif", 1),
    ("  const T q = quot_rn(x == (T)0 ? (T)1 : x, y);\n"
     "  return x == (T)0 ? mul_rn(x, y) : q;",
     "#if CUT == 4\n  return mul_rn(x, (T)__frcp_rn((float)y));\n#elif CUT == 5\n"
     "  return quot_rn(x, y);\n#else\n"
     "  const T q = quot_rn(x == (T)0 ? (T)1 : x, y);\n"
     "  return x == (T)0 ? mul_rn(x, y) : q;\n#endif", 1),
    ("for (int r = 0; r < R; ++r) x.f[r] = quot_rn(x.f[r], x.b);",
     "for (int r = 0; r < R; ++r) x.f[r] = CUT == 4 ? div_rn(x.f[r], x.b) : quot_rn(x.f[r], x.b);", 1),
    ("__device__ int pcr_solve(Row<R, T>& x, const PcrBuf<T>& buf, int i, int rows) {\n"
     "  int k = 0;",
     "__device__ int pcr_solve(Row<R, T>& x, const PcrBuf<T>& buf, int i, int rows,\n"
     "                         int* stages = nullptr, int forced_stages = 0) {\n"
     "  int k = 0, n = 0;", 1),
    ("    const bool coupled = __syncthreads_or(x.a != (T)0 || x.c != (T)0);\n"
     "    if (!coupled || s >= rows) break;\n",
     "#if PASS_THROUGH\n    __syncthreads();\n    if (n >= forced_stages || s >= rows) break;\n"
     "#elif CUT == 6\n    __syncthreads();\n    if (s >= rows) break;\n#else\n"
     "    const bool coupled = __syncthreads_or(x.a != (T)0 || x.c != (T)0);\n"
     "    if (!coupled || s >= rows) break;\n#endif\n    ++n;\n", 1),
    ("    pcr_stage(x, m, p);\n",
     "#if PASS_THROUGH\n"
     "    unsigned u = __float_as_uint((float)m.a) ^ __float_as_uint((float)m.b) ^\n"
     "                 __float_as_uint((float)m.c) ^ __float_as_uint((float)p.a) ^\n"
     "                 __float_as_uint((float)p.b) ^ __float_as_uint((float)p.c);\n"
     "    for (int r = 0; r < R; ++r)\n"
     "      u ^= __float_as_uint((float)m.f[r]) ^ __float_as_uint((float)p.f[r]);\n"
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
    ("exp_of(clamp_to(mul_rn(c1, phi), -exp_clamp, exp_clamp))",
     "CUT_EXP(clamp_to(mul_rn(c1, phi), -exp_clamp, exp_clamp))", 2),
    ("while (residual > tol && it < maxiter) {",
     "while (forced >= 0 ? it < forced : (residual > tol && it < maxiter)) {", 2),
    ("pcr_solve<1>(x, buf, i, rows);", "pcr_solve<1>(x, buf, i, rows, stages, forced_stages);", 1),
    ("pcr_solve<2>(x, buf, i, rows);", "pcr_solve<2>(x, buf, i, rows, stages, forced_stages);", 1),
    # the loops and the kernels take the forced counts last; launch_dd and
    # launch_dn pass them (the double entry points their defaults), the
    # float entry points take them before the stream
    ("int maxiter, T step_max,\n    T exp_clamp) {",
     "int maxiter, T step_max,\n    T exp_clamp, int forced, int* stages, int forced_stages) {", 1),
    ("int ng, T coef, T c1, T dx2, T tol, int maxiter, T step_max, T exp_clamp) {",
     "int ng, T coef, T c1, T dx2, T tol, int maxiter, T step_max, T exp_clamp,\n"
     "    int forced, int* stages, int forced_stages) {", 1),
    ("int maxiter, T step_max, T exp_clamp) {\n  newton_dd_loop",
     "int maxiter, T step_max, T exp_clamp, int forced,\n"
     "                                 int* stages, int forced_stages) {\n  newton_dd_loop", 1),
    ("    double exp_clamp) {\n  newton_dd_loop",
     "    double exp_clamp, int forced, int* stages, int forced_stages) {\n  newton_dd_loop", 1),
    ("T step_max, T exp_clamp) {\n  newton_dn_loop",
     "T step_max, T exp_clamp, int forced, int* stages,\n"
     "                                 int forced_stages) {\n  newton_dn_loop", 1),
    ("double step_max, double exp_clamp) {\n  newton_dn_loop",
     "double step_max, double exp_clamp,\n"
     "    int forced, int* stages, int forced_stages) {\n  newton_dn_loop", 1),
    ("tol, maxiter, step_max, exp_clamp);\n}",
     "tol, maxiter, step_max, exp_clamp, forced, stages, forced_stages);\n}", 2),
    ("maxiter, step_max, exp_clamp);\n}",
     "maxiter, step_max, exp_clamp, forced, stages, forced_stages);\n}", 2),
    ("int maxiter, T step_max, T exp_clamp, cudaStream_t s) {",
     "int maxiter, T step_max, T exp_clamp, cudaStream_t s,\n"
     "                      int forced = -1, int* stages = nullptr, int forced_stages = 0) {",
     1),
    ("T step_max, T exp_clamp, cudaStream_t s) {\n  if (!rows_ok(ng, rows) || ng < 3)",
     "T step_max, T exp_clamp, cudaStream_t s,\n"
     "                      int forced = -1, int* stages = nullptr, int forced_stages = 0) {\n"
     "  if (!rows_ok(ng, rows) || ng < 3)", 1),
    ("eps0, c1, dx2, tol, maxiter, step_max,\n                                            exp_clamp);",
     "eps0, c1, dx2, tol, maxiter, step_max,\n                                            exp_clamp, "
     "forced, stages, forced_stages);", 1),
    ("dx2, tol, maxiter, step_max, exp_clamp);\n  return cudaGetLastError();",
     "dx2, tol, maxiter, step_max, exp_clamp, forced, stages,\n"
     "                                            forced_stages);\n  return cudaGetLastError();",
     1),
    ("int maxiter, float step_max, float exp_clamp,\n                              void* stream) {",
     "int maxiter, float step_max, float exp_clamp,\n"
     "    int forced, int* stages, int forced_stages, void* stream) {", 1),
    ("int maxiter, float step_max, float exp_clamp,\n                       void* stream) {",
     "int maxiter, float step_max, float exp_clamp,\n"
     "    int forced, int* stages, int forced_stages, void* stream) {", 1),
    ("dx2, tol, maxiter, step_max, exp_clamp, (cudaStream_t)stream);\n}\n\n"
     "// The double solve",
     "dx2, tol, maxiter, step_max, exp_clamp, (cudaStream_t)stream, forced,\n"
     "                        stages, forced_stages);\n}\n\n// The double solve", 1),
    ("maxiter, step_max, exp_clamp, (cudaStream_t)stream);\n}\n\n// coef = e / eps0 in float64.",
     "maxiter, step_max, exp_clamp, (cudaStream_t)stream, forced, stages,\n"
     "                        forced_stages);\n}\n\n// coef = e / eps0 in float64.", 1),
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
# where _inlined puts cic_common.cuh's text in a source
_INLINED = "// cic_common.cuh, inlined\n"
# cut (b) of the wide deposits' flush (cic_common.cuh flush_columns, inlined
# by _inlined): the node totals stored under a predicate never true
_FLUSH_CUT = (
    "    if (!SKIP || a != (T)0) atomicAdd(out_a + k, a);\n"
    "    if (ARRAYS == 2 && (!SKIP || b != (T)0)) atomicAdd(out_b + k, b);",
    "#if CUT == 1\n    if (a == (T)1.2345e30f) out_a[k] = b;\n#else\n"
    "    if (!SKIP || a != (T)0) atomicAdd(out_a + k, a);\n"
    "    if (ARRAYS == 2 && (!SKIP || b != (T)0)) atomicAdd(out_b + k, b);\n#endif", 1)
_DEPOSIT_EDITS = [
    (_INLINED, _INLINED + "#ifndef CUT\n#define CUT 0\n#endif\n", 1),
    _FLUSH_CUT,
    ("  zero_shared(h_a, 2 * ng * cols);", "  if (CUT != 4) zero_shared(h_a, 2 * ng * cols);", 1),
    ("  zero_shared(h_r, 2 * ng * cols);", "  if (CUT != 4) zero_shared(h_r, 2 * ng * cols);", 1),
    ("  if (ROWS == 1) {  // narrow", "  float sink = 0.0f;\n  if (ROWS == 1) {  // narrow", 2),
    # deposit2: the narrow path's adds, then the wide path's
    ("      atomicAdd(&h_a[c.l], mul_rn(a, c.wl));\n"
     "      atomicAdd(&h_a[c.r], mul_rn(a, c.wr));\n"
     "      atomicAdd(&h_b[c.l], mul_rn(b, c.wl));\n"
     "      atomicAdd(&h_b[c.r], mul_rn(b, c.wr));\n",
     "#if CUT >= 3\n"
     "      sink = __fadd_rn(sink, (float)add_rn(mul_rn(a, c.wl), add_rn(mul_rn(b, c.wr),\n"
     "                                                                    (T)c.l)));\n"
     "#else\n"
     "      atomicAdd(&h_a[c.l], mul_rn(a, c.wl));\n"
     "      atomicAdd(&h_a[c.r], mul_rn(a, c.wr));\n"
     "      atomicAdd(&h_b[c.l], mul_rn(b, c.wl));\n"
     "      atomicAdd(&h_b[c.r], mul_rn(b, c.wr));\n#endif\n", 1),
    ("        atomicAdd(&h_a[c.l * cols + col], mul_rn(a, c.wl));\n"
     "        atomicAdd(&h_a[c.r * cols + col], mul_rn(a, c.wr));\n"
     "        atomicAdd(&h_b[c.l * cols + col], mul_rn(b, c.wl));\n"
     "        atomicAdd(&h_b[c.r * cols + col], mul_rn(b, c.wr));\n",
     "#if CUT >= 3\n"
     "        sink = __fadd_rn(sink, (float)add_rn(mul_rn(a, c.wl), add_rn(mul_rn(b, c.wr),\n"
     "                                                                    (T)(c.l * cols + col))));\n"
     "#else\n"
     "        atomicAdd(&h_a[c.l * cols + col], mul_rn(a, c.wl));\n"
     "        atomicAdd(&h_a[c.r * cols + col], mul_rn(a, c.wr));\n"
     "        atomicAdd(&h_b[c.l * cols + col], mul_rn(b, c.wl));\n"
     "        atomicAdd(&h_b[c.r * cols + col], mul_rn(b, c.wr));\n#endif\n", 1),
    ("  flush_columns<ROWS, 2, false, T>(h_a, ng, cols, out_a, out_b);",
     "  if (sink == 1.2345e30f) out_a[0] = sink;\n"
     "  if (CUT != 2 && CUT != 4) flush_columns<ROWS, 2, false, T>(h_a, ng, cols, out_a, out_b);",
     1),
    # row 9: no deposit arithmetic in (e), its weights still read
    ("  idx[0] = idx[1] = idx[2] = idx[3] = -1;\n",
     "  idx[0] = idx[1] = idx[2] = idx[3] = -1;\n"
     "  if (CUT == 4) {\n    if (wr == 1.2345e30f && wn == 1.0f) idx[0] = 0;\n    return;\n  }\n", 1),
    ("        if (idx[k] >= 0) atomicAdd(h_r + idx[k], val[k]);",
     "#if CUT >= 3\n"
     "        if (idx[k] >= 0) sink = __fadd_rn(sink, (float)mul_rn(val[k], (T)idx[k]));\n"
     "#else\n        if (idx[k] >= 0) atomicAdd(h_r + idx[k], val[k]);\n#endif", 2),
    ("  flush_columns<ROWS, 2, false, T>(h_r, ng, cols, rho, dens);",
     "  if (sink == 1.2345e30f) rho[0] = sink;\n"
     "  if (CUT != 2 && CUT != 4) flush_columns<ROWS, 2, false, T>(h_r, ng, cols, rho, dens);", 1),
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


def _inlined(path: Path) -> str:
    """The source at ``path`` with its ``#include "cic_common.cuh"`` replaced
    by that header's text (the header beside it, else the package's), so
    that a cut can edit the header's helpers as well."""
    header = path.parent / "cic_common.cuh"
    if not header.exists():
        header = _build.CSRC_DIR / "cic_common.cuh"
    text = path.read_text()
    if text.count('#include "cic_common.cuh"') != 1:
        raise RuntimeError(f"{path} does not include cic_common.cuh once")
    return text.replace('#include "cic_common.cuh"',
                        _INLINED + header.read_text().replace("#pragma once\n", ""))


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


def _build_all(jobs, optional=()) -> tuple[dict, dict]:
    """jobs: {tag: (source text, extra nvcc flags)} -> ({tag: loaded CDLL},
    {tag: the compiler's log}), one nvcc each, all at once. The flags come
    before the package's include directory (a first port's ``-I`` of its
    own header wins). A job of ``optional`` that fails to build is
    reported and left out."""
    return _finish_builds(_start_builds(jobs), optional)


def _start_builds(jobs) -> dict:
    """_build_all's compilers, started and not waited for: {tag: (library
    path, running nvcc)} for _finish_builds."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for tag, (text, flags) in jobs.items():
        stem = "".join(ch if ch.isalnum() else "_" for ch in tag)
        src = OUT_DIR / f"{stem}.cu"
        src.write_text(text)
        lib = OUT_DIR / f"lib{stem}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", *flags, "-I",
               str(_build.CSRC_DIR), "-o", str(lib), str(src)]
        procs[tag] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    return procs


def _finish_builds(procs, optional=()) -> tuple[dict, dict]:
    """Waits for _start_builds' compilers; returns _build_all's result."""
    libs, logs = {}, {}
    for tag, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode and tag in optional:
            print(f"[split] {tag}: nvcc failed, left out:\n{log[-2000:]}", flush=True)
            continue
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


def _atomics(lib_path: Path, word: str = "", prefixes=("ATOMS",)) -> dict:
    """Atomic opcodes (shared-memory ones by default; ``prefixes``) in the
    SASS of a library's kernels whose name holds ``word``, by count."""
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
            if w.startswith(prefixes):
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
    versions = {"current": (_inlined(_build.CSRC_DIR / "magnetized.cu"), _DEPOSIT_EDITS,
                            DEPOSIT_CUTS)}
    if args.first_port:
        versions["first port"] = (args.first_port.read_text(), _DEPOSIT_FIRST_PORT_EDITS,
                                  DEPOSIT_FIRST_PORT_CUTS)
    jobs, cuts = {}, {}
    for version, (source, edits, table) in versions.items():
        text = _edited(source, edits)
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


# ---------------------------------------------------------------------------
# row 4 (csrc/cic.cu deposit_kernel, deposit_det_kernel) and row 20
# (csrc/rng.cu source_batch_kernel)
# ---------------------------------------------------------------------------

_CUT_DEFINE = "#ifndef CUT\n#define CUT 0\n#endif\n"
# row 4's shapes: the explicit carrier's rho a step (n = 1e8 onto ext_n =
# 227 nodes, bounded, 5% dead slots of weight 0), the headline's set-up
# deposit (n = 1e8, ng = 200, periodic), the configs[3] row's IEAD
# histogram (its real traffic, iead_load) and the first port's synthetic
# IEAD shape (n = 999,996, ng = 600, dense values)
N_HEADLINE = 6104 * 16384
SINGLE_SHAPES = {"carrier": (N_HEADLINE, 227), "headline set-up": (N_HEADLINE, 200),
                 "IEAD": (999_996, 3200), "synthetic 999,996 / 600": (999_996, 600)}
# deposit_det's: the sheath's composed current (n = 1e6, ng = 51) and its
# exit histograms (2 x 64 bins, integer positions, weight 1 on 1% of rows)
DET_SHAPES = {"current": (1_000_000, 51), "exit histograms": (1_000_000, 128)}
# row 20's: the configs[3] row's capacity and a ragged n
SOURCE_NS = {"999,996": 999_996, "ragged 1,000,003": 1_000_003}

# the current deposit (row 4): CUT selects the stage taken out; "(f)" to
# "(i)" launch the full kernel at another grid
SINGLE_CUTS = {
    "(a) full": 0,
    "(b) no global flush": 1,  # the node totals stored under a predicate never true
    "(d) no shared adds": 3,   # each thread sums its products in a register
    "(e) sweep only": 4,       # the loads and the CIC arithmetic; no zeroing, adds or flush
    "(j) every add, zeros too": 5,  # the first port's adds on the new grid
    "(k) a warp's zeros skipped": 6,  # a warp adds unless all its lanes' products are 0
    "(f) 1 column": 0,
    "(g) 4 columns": 0,
    "(h) 16 columns": 0,
    "(i) the other width": 0,
}
DET_CUTS = {"(a) full": 0, "(b) no flush": 1,
            "(c) no last-block sum": 2,  # the columns summed, the partials not
            "(e) sweep only": 4}
# row 20: "(b)" launches the uniforms variant of the full kernel
SOURCE_CUTS = {"(a) full": 0, "(b) uniforms only": 0,
               "(c) no transcendentals": 2,  # the uniforms in the place of log, sqrt, sin, cos
               "(d) no stores": 3,           # stored under a predicate never true
               "(e) libdevice sqrtf": 4,     # the radius by sqrtf, not x rsqrt(x)
               "(f) 128 threads a block": 0,
               "(g) 256 threads a block": 0,
               "(h) round keys in registers": 5,  # made per thread, not read from the bank
               "(i) libdevice logf": 6}      # logf in the place of log_unit
_SINGLE_EDITS = [
    (_INLINED, _INLINED + _CUT_DEFINE, 1),
    _FLUSH_CUT,
    ("  zero_shared(h, ng * cols);",
     "  if (CUT != 4) zero_shared(h, ng * cols);\n  T sink = 0;", 1),
    ("        add_nonzero(h, c.l * cols + col, mul_rn(val, c.wl));\n"
     "        add_nonzero(h, c.r * cols + col, mul_rn(val, c.wr));\n",
     "#if CUT == 3 || CUT == 4\n"
     "        sink = add_rn(sink, add_rn(mul_rn(val, c.wl), add_rn(mul_rn(val,"
     " c.wr), (T)(c.l * cols + col))));\n#else\n"
     "        add_nonzero(h, c.l * cols + col, mul_rn(val, c.wl));\n"
     "        add_nonzero(h, c.r * cols + col, mul_rn(val, c.wr));\n#endif\n", 1),
    ("  if (v != (T)0) atomicAdd(h + at, v);",
     "#if CUT == 6\n  if (__any_sync(__activemask(), v != (T)0)) atomicAdd(h + at, v);\n#else\n"
     "  if (CUT == 5 || v != (T)0) atomicAdd(h + at, v);\n#endif", 1),
    ("  flush_columns<ROWS, 1, true, T>(h, ng, cols, out, nullptr);",
     "  if (sink == (T)1.2345e30f) out[0] = sink;\n"
     "  if (CUT != 2 && CUT != 4) flush_columns<ROWS, 1, CUT != 5, T>(h, ng, cols, out,"
     " nullptr);", 1),
    # deposit_det_kernel
    ("  zero_shared(s_hist, T * ng);", "  if (CUT != 4) zero_shared(s_hist, T * ng);", 1),
    ("  E* mine = s_hist + threadIdx.x;", "  E* mine = s_hist + threadIdx.x;\n  E sink = (E)0;", 1),
    ("      mine[c.l * T] = add_rn(mine[c.l * T], mul_rn(val, c.wl));\n"
     "      mine[c.r * T] = add_rn(mine[c.r * T], mul_rn(val, c.wr));\n",
     "#if CUT == 4\n"
     "      sink = add_rn(sink, add_rn(mul_rn(val, c.wl), add_rn(mul_rn(val,"
     " c.wr), (E)c.l)));\n#else\n"
     "      mine[c.l * T] = add_rn(mine[c.l * T], mul_rn(val, c.wl));\n"
     "      mine[c.r * T] = add_rn(mine[c.r * T], mul_rn(val, c.wr));\n#endif\n", 1),
    ("  det_flush(s_hist, ng, partial, counter, out);",
     "  if (sink == (E)1.2345e30f) out[0] = sink;\n"
     "  if (CUT != 1 && CUT != 4) det_flush(s_hist, ng, partial, counter, out);\n"
     "  else if (mine[0] == (E)1.2345e30f) out[0] = mine[0];", 1),
    # (c): the last block zeroes the counter and leaves
    ("  if (threadIdx.x == 0) *counter = 0u;\n  __threadfence();\n  // a warp takes kNodes",
     "  if (threadIdx.x == 0) *counter = 0u;\n  __threadfence();\n  if (CUT == 2) return;\n"
     "  // a warp takes kNodes", 1),
]
# the first port of csrc/cic.cu (the parent of the redesign): the same cut
# numbers on its deposit_kernel and deposit_det_kernel
_SINGLE_FIRST_PORT_EDITS = [
    ("#include \"cic_common.cuh\"", "#include \"cic_common.cuh\"\n" + _CUT_DEFINE, 1),
    ("  for (int i = threadIdx.x; i < ng; i += blockDim.x) s_hist[i] = 0.0f;\n",
     "  float sink = 0.0f;\n"
     "  if (CUT != 4) for (int i = threadIdx.x; i < ng; i += blockDim.x) s_hist[i] = 0.0f;\n", 1),
    ("    const Cic c = PERIODIC ? cic_periodic(p[i], ng) : cic_bounded(p[i], ng);\n"
     "    atomicAdd(&s_hist[c.l], __fmul_rn(val, c.wl));\n"
     "    atomicAdd(&s_hist[c.r], __fmul_rn(val, c.wr));\n",
     "    const Cic c = PERIODIC ? cic_periodic(p[i], ng) : cic_bounded(p[i], ng);\n"
     "#if CUT == 3 || CUT == 4\n"
     "    sink = __fadd_rn(sink, __fadd_rn(__fmul_rn(val, c.wl), __fadd_rn(__fmul_rn(val,"
     " c.wr), (float)c.l)));\n#else\n"
     "    atomicAdd(&s_hist[c.l], __fmul_rn(val, c.wl));\n"
     "    atomicAdd(&s_hist[c.r], __fmul_rn(val, c.wr));\n#endif\n", 1),
    ("  for (int i = threadIdx.x; i < ng; i += blockDim.x) atomicAdd(&out[i], s_hist[i]);",
     "  if (sink == 1.2345e30f) out[0] = sink;\n"
     "  for (int i = threadIdx.x; i < ng; i += blockDim.x) {\n#if CUT == 1\n"
     "    if (s_hist[i] == 1.2345e30f) out[i] = s_hist[i];\n#else\n"
     "    if (CUT != 4) atomicAdd(&out[i], s_hist[i]);\n#endif\n  }", 1),
    ("  for (int i = threadIdx.x; i < T * ng; i += T) s_hist[i] = 0.0f;",
     "  if (CUT != 4) for (int i = threadIdx.x; i < T * ng; i += T) s_hist[i] = 0.0f;", 1),
    ("  float* mine = s_hist + threadIdx.x;", "  float* mine = s_hist + threadIdx.x;\n  float sink = 0.0f;", 1),
    ("    mine[c.l * T] = __fadd_rn(mine[c.l * T], __fmul_rn(val, c.wl));\n"
     "    mine[c.r * T] = __fadd_rn(mine[c.r * T], __fmul_rn(val, c.wr));\n",
     "#if CUT == 4\n"
     "    sink = __fadd_rn(sink, __fadd_rn(__fmul_rn(val, c.wl), __fadd_rn(__fmul_rn(val,"
     " c.wr), (float)c.l)));\n#else\n"
     "    mine[c.l * T] = __fadd_rn(mine[c.l * T], __fmul_rn(val, c.wl));\n"
     "    mine[c.r * T] = __fadd_rn(mine[c.r * T], __fmul_rn(val, c.wr));\n#endif\n", 1),
    ("  det_flush(s_hist, ng, partial, counter, out);",
     "  if (sink == 1.2345e30f) out[0] = sink;\n"
     "  if (CUT == 0) det_flush(s_hist, ng, partial, counter, out);\n"
     "  else if (mine[0] == 1.2345e30f) out[0] = mine[0];", 1),
]
_SOURCE_EDITS = [
    (_INLINED, _INLINED + _CUT_DEFINE, 1),
    ("  const float r0 = sqrt_pos(__fmul_rn(-2.0f, log_unit(u0)));\n"
     "  const float r1 = sqrt_pos(__fmul_rn(-2.0f, log_unit(u2)));\n"
     "  float s0, cs0, s1, cs1;\n"
     "  sincos_2pi(__fmul_rn(two_pi, u1), s0, cs0);\n"
     "  sincos_2pi(__fmul_rn(two_pi, u3), s1, cs1);\n",
     "#if CUT == 2\n"
     "  const float r0 = u0, r1 = u2, s0 = u1, s1 = u3;\n"
     "  const float cs0 = __fmul_rn(two_pi, u1), cs1 = __fmul_rn(two_pi, u3);\n#else\n"
     "  const float r0 = sqrt_pos(__fmul_rn(-2.0f, log_unit(u0)));\n"
     "  const float r1 = sqrt_pos(__fmul_rn(-2.0f, log_unit(u2)));\n"
     "  float s0, cs0, s1, cs1;\n"
     "  sincos_2pi(__fmul_rn(two_pi, u1), s0, cs0);\n"
     "  sincos_2pi(__fmul_rn(two_pi, u3), s1, cs1);\n#endif\n", 1),
    ("  const int i = __float_as_int(u);\n  const int e = (i - 0x3f3504f3) >> 23;",
     "#if CUT == 6\n  return logf(u);\n#endif\n"
     "  const int i = __float_as_int(u);\n  const int e = (i - 0x3f3504f3) >> 23;", 1),
    ("__device__ __forceinline__ float sqrt_pos(float x) {\n  return __fmul_rn(x, rsqrtf(x));",
     "__device__ __forceinline__ float sqrt_pos(float x) {\n#if CUT == 4\n  return sqrtf(x);\n"
     "#endif\n  return __fmul_rn(x, rsqrtf(x));", 1),
    ("  for (int r = 0; r < 10; ++r) philox_round(c0, c1, c2, c3, keys.k0[r], keys.k1[r]);",
     "#if CUT == 5\n  uint32_t k0 = keys.k0[0] + (uint32_t)(threadIdx.x >> 10),"
     " k1 = keys.k1[0];\n  philox4x32_10(c0, c1, c2, c3, k0, k1);\n#else\n"
     "  for (int r = 0; r < 10; ++r) philox_round(c0, c1, c2, c3, keys.k0[r], keys.k1[r]);\n"
     "#endif", 1),
    ("      const long long at = i + r * S;\n      x_out[at] = o.x;\n",
     "      const long long at = i + r * S;\n#if CUT == 3\n"
     "      if (o.x + o.y + o.z + o.w == 1.2345e30f) x_out[at] = o.x;\n      continue;\n"
     "#endif\n      x_out[at] = o.x;\n", 1),
    ("                                          inv_wrap, vth, vx0, two_pi);\n    x_out[i] = o.x;\n",
     "                                          inv_wrap, vth, vx0, two_pi);\n#if CUT == 3\n"
     "    if (o.x + o.y + o.z + o.w == 1.2345e30f) x_out[i] = o.x;\n    continue;\n#endif\n"
     "    x_out[i] = o.x;\n", 1),
]
_SOURCE_FIRST_PORT_EDITS = [
    ("#include <cuda_runtime.h>\n", "#include <cuda_runtime.h>\n" + _CUT_DEFINE, 1),
    ("    const float r0 = sqrtf(__fmul_rn(-2.0f, logf(u0)));\n"
     "    const float t0 = __fmul_rn(two_pi, u1);\n"
     "    const float r1 = sqrtf(__fmul_rn(-2.0f, logf(u2)));\n"
     "    const float t1 = __fmul_rn(two_pi, u3);\n"
     "    const float z0 = __fmul_rn(r0, cosf(t0));\n"
     "    const float z1 = __fmul_rn(r0, sinf(t0));\n"
     "    const float z2 = __fmul_rn(r1, cosf(t1));\n"
     "    const float z3 = __fmul_rn(r1, sinf(t1));\n",
     "#if CUT == 2\n"
     "    const float z0 = u0, z1 = u1, z2 = u2, z3 = __fmul_rn(two_pi, u3);\n#else\n"
     "    const float r0 = sqrtf(__fmul_rn(-2.0f, logf(u0)));\n"
     "    const float t0 = __fmul_rn(two_pi, u1);\n"
     "    const float r1 = sqrtf(__fmul_rn(-2.0f, logf(u2)));\n"
     "    const float t1 = __fmul_rn(two_pi, u3);\n"
     "    const float z0 = __fmul_rn(r0, cosf(t0));\n"
     "    const float z1 = __fmul_rn(r0, sinf(t0));\n"
     "    const float z2 = __fmul_rn(r1, cosf(t1));\n"
     "    const float z3 = __fmul_rn(r1, sinf(t1));\n#endif\n", 1),
    ("    x_out[i] = x;\n",
     "#if CUT == 3\n"
     "    if (x + __fmul_rn(z1, vth) + __fmul_rn(z2, vth) + __fmul_rn(z3, vth) == 1.2345e30f)\n"
     "      x_out[i] = x;\n    continue;\n#endif\n    x_out[i] = x;\n", 1),
]
_FIRST_PORT_SIGNATURES = {
    "pypic_deposit": [_P] * 3 + [_L, _I, _I, _I, _I, _P],
    "pypic_deposit_det": [_P] * 5 + [_L, _I, _I, _I, _I, _P],
}


def _sass_loop(lib_path: Path, word: str) -> dict:
    """The static SASS instructions of the main loop of the kernel whose
    (mangled) name holds ``word``: the instructions between the target and
    the source of its widest backward branch (cuobjdump -sass), and of the
    whole function. Out-of-line slow paths (called subroutines past the
    loop) are outside the loop's count."""
    import re

    tool = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(lib_path)], capture_output=True,
                          text=True).stdout
    insn, inside, name = [], False, None
    for line in sass.splitlines():
        if "Function :" in line:
            inside = word in line
            name = line.split("Function :")[1].strip() if inside else name
            if inside:
                insn = []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if inside and m:
            insn.append((int(m.group(1), 16), m.group(2).strip()))
        if inside and "....." in line and insn:
            break
    loops = []
    for addr, text in insn:
        b = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", text)
        if b and int(b.group(1), 16) < addr:
            loops.append((int(b.group(1), 16), addr))
    real = [(a, t) for a, t in insn if not t.startswith("NOP")]
    if not loops:
        return {"function": name, "instructions": len(real), "loop": None}
    lo, hi = max(loops, key=lambda x: x[1] - x[0])
    body = [t for a, t in real if lo <= a <= hi]
    return {"function": name, "instructions": len(real), "loop": len(body),
            "loop_range": [hex(lo), hex(hi)]}


def sass_issue_ms(instructions_per_row: float, n: int, sms: int, clock_mhz: float) -> float:
    """The time a kernel takes to issue its own ``instructions_per_row``
    instructions a row over n rows when the card issues one warp
    instruction a clock on each of its four schedulers an SM: n
    instructions_per_row / (sms x 4 x 32 x clock). It is the kernel's own
    count, not a bound on the function: a kernel that issues more gets
    more, and static counts include branches a run never takes."""
    return instructions_per_row * n / (sms * 4 * 32 * clock_mhz * 1e6) * 1e3


def iead_load(dev) -> tuple:
    """The configs[3] row's IEAD traffic after its 1,200 steps
    (tools/magnetized.py run_row and last_iead_traffic): (float32 bin
    positions, 0/1 weights, the number of bins, the row's last-step
    hits)."""
    from . import magnetized as row

    _, cfg, fin, m = row.run_row(dev)
    pos, weight, hit = row.last_iead_traffic(cfg, fin)
    ne, na = cfg.iead_bins
    bins = fin.iead.shape[0] * ne * na
    if int(hit.sum()) != int(m.n_hit_wall[-1]):
        raise RuntimeError("the final state's inactive slots are not the last step's hits")
    return pos, weight, bins, int(m.n_hit_wall[-1])


def single_inputs(shape: str, n: int, ng: int, dev, iead=None) -> dict:
    """Row 4's inputs at ``shape`` (SINGLE_SHAPES): positions and values,
    periodic or not."""
    f32 = torch.float32
    gen = torch.Generator(device=dev).manual_seed(41)
    if shape == "IEAD":
        pos, weight = iead[0], iead[1]
        return dict(p=pos, values=weight, periodic=False)
    if shape == "carrier":
        # the slab's extended positions, clamp(p - (lo - hw), 0, 2 hw + c):
        # the particles on the slab [hw, hw + c) of ext_n = c + 2 hw + 1, a
        # twentieth dead slots of weight 0 (at the slab's left edge)
        p = torch.rand(n, generator=gen, device=dev, dtype=f32) * 200.0 + 13.0
        w = torch.full((n,), 1.6e-9, dtype=f32, device=dev)
        dead = torch.rand(n, generator=gen, device=dev) < 0.05
        w[dead] = 0.0
        p[dead] = 13.0
        return dict(p=p, values=w, periodic=False)
    p = torch.rand(n, generator=gen, device=dev, dtype=f32) * (ng if shape.startswith("head") else ng - 1)
    return dict(p=p, values=torch.randn(n, generator=gen, device=dev, dtype=f32),
                periodic=shape.startswith("head"))


def _split_single(args, dev) -> tuple[dict, dict, dict]:
    """Row 4's cuts: ``deposit`` at SINGLE_SHAPES, or ``deposit_det`` at
    DET_SHAPES; with --first-port (the parent's csrc/cic.cu, its
    cic_common.cuh beside it), the first port's beside them."""
    det = args.kernel == "deposit_det"
    table = DET_CUTS if det else SINGLE_CUTS
    jobs, cuts = {}, {}
    versions = {"current": (_edited(_inlined(_build.CSRC_DIR / "cic.cu"), _SINGLE_EDITS), [])}
    if args.first_port:
        versions["first port"] = (
            _edited(args.first_port.read_text(), _SINGLE_FIRST_PORT_EDITS),
            ["-I", str(args.first_port.resolve().parent)])
    for version, (text, flags) in versions.items():
        for tag, cut in table.items():
            if version == "first port" and tag[:3] in ("(f)", "(g)", "(h)", "(i)", "(j)"):
                continue  # the new grid's variants
            name = f"{version} {tag}"
            cuts[name] = (version, tag)
            if tag.startswith("(a)") or cut != 0:
                jobs[name] = (text, [*flags, f"-DCUT={cut}"])
    libs, logs = _build_all(jobs)
    word = "deposit_det_kernel" if det else "14deposit_kernel"
    for tag in jobs:
        for line in _kernel_report(logs[tag], word):
            print(f"[ptxas] {tag}: {line}", flush=True)
        if tag.endswith("(a) full"):
            print(f"[sass] {tag}: {_atomics(Path(libs[tag]._name), word)}", flush=True)
    for name, (version, tag) in cuts.items():
        libs.setdefault(name, libs.get(f"{version} (a) full"))
    fn_name = "pypic_deposit_det" if det else "pypic_deposit"
    for name, lib in libs.items():
        fn = getattr(lib, fn_name)
        fn.argtypes = (_build._SIGNATURES[fn_name][0] if cuts[name][0] == "current"
                       else _FIRST_PORT_SIGNATURES[fn_name])
        fn.restype = _I
    stream = torch.cuda.current_stream().cuda_stream
    sms = cuda_cic._sm_count(dev.index)
    res, calls = {"launch": {}}, {}
    if det:
        from ..ops import cuda_sheath

        gen = torch.Generator(device=dev).manual_seed(43)
        for shape, (n, ng) in DET_SHAPES.items():
            if shape == "current":
                p = torch.rand(n, generator=gen, device=dev) * (ng - 1)
                v = torch.randn(n, generator=gen, device=dev) * 1e3
            else:
                p = torch.randint(0, ng, (n,), generator=gen, device=dev).float()
                v = (torch.rand(n, generator=gen, device=dev) < 0.01).float()
            out = torch.empty(ng, dtype=torch.float32, device=dev)
            cur = cuda_sheath.launch_shape(n, ng, sms, field=False)
            res["launch"][shape] = dataclasses.asdict(cur)
            # the first port's grid: a wave of 256-thread blocks (fewer
            # threads where their columns do not fit), one per 256 rows
            threads = 256
            while threads * ng * 4 > cuda_cic.SMEM_LIMIT:
                threads //= 2
            per_sm = max(1, min(2048 // threads, cuda_cic.SMEM_LIMIT // (threads * ng * 4)))
            fblocks = max(1, min(-(-n // threads), per_sm * sms))
            scratch = {b: (torch.empty(b * ng, dtype=torch.float32, device=dev),
                           torch.zeros(1, dtype=torch.int32, device=dev))
                       for b in (cur.blocks, fblocks)}
            for name, (version, tag) in cuts.items():
                lib = libs[name]
                if version == "current":
                    part, cnt = scratch[cur.blocks]
                    grid = (cur.blocks, cur.threads, cur.rows_per_block)
                else:
                    part, cnt = scratch[fblocks]
                    grid = (fblocks, threads)

                def call(lib=lib, p=p, v=v, out=out, part=part, cnt=cnt, ng=ng, n=n, grid=grid):
                    _build.check(lib.pypic_deposit_det(
                        p.data_ptr(), v.data_ptr(), out.data_ptr(), part.data_ptr(),
                        cnt.data_ptr(), n, ng, 0, *grid, stream), "resident_split")
                calls[f"{shape}: {name}"] = call
        return res, calls, {"per": "launch", "count": 1, "timer": _queued}
    iead = iead_load(dev)
    res["iead"] = {"bins": iead[2], "hits": iead[3], "weight_sum": float(iead[1].sum())}
    print(f"[split] IEAD traffic: {iead[3]} hits in the last step, {res['iead']['weight_sum']:.0f} "
          f"in range, {iead[2]} bins", flush=True)
    for shape, (n, ng) in SINGLE_SHAPES.items():
        load = single_inputs(shape, n, ng, dev, iead)
        out = torch.zeros(ng, dtype=torch.float32, device=dev)
        # the IEAD at histogram_add's columns, the others at the deposit's
        cur = cuda_cic.deposit_launch_shape(
            n, ng, False, sms, hists=1,
            max_cols=cic.HISTOGRAM_COLS if shape == "IEAD" else cuda_cic.DEPOSIT_MAX_COLS)
        res["launch"][shape] = dataclasses.asdict(cur)
        for name, (version, tag) in cuts.items():
            lib = libs[name]
            if version == "current":
                cols = {"(f)": 1, "(g)": 4, "(h)": 16}.get(tag[:3])
                shp = cur
                if tag.startswith("(i)"):
                    shp = _other_width(cur, n, ng, False, sms)
                elif cols is not None:
                    shp = dataclasses.replace(cur, cols=cols)
                grid = (shp.rows, shp.blocks, shp.threads, shp.cols)
            else:
                grid = (cuda_cic._blocks(n, dev), cuda_cic._THREADS)

            def call(lib=lib, load=load, out=out, n=n, ng=ng, grid=grid):
                _build.check(lib.pypic_deposit(
                    load["p"].data_ptr(), load["values"].data_ptr(), out.data_ptr(), n, ng,
                    int(load["periodic"]), *grid, stream), "resident_split")
            calls[f"{shape}: {name}"] = call
    return res, calls, {"per": "launch", "count": 1, "timer": _queued}


def _split_source(args, dev) -> tuple[dict, dict, dict]:
    """Row 20's cuts at SOURCE_NS, its SASS loop count and that count's
    issue time (``sass_issue_ms``); with --first-port (the parent's
    csrc/rng.cu), the first port's beside them."""
    versions = {"current": (_edited(_inlined(_build.CSRC_DIR / "rng.cu"), _SOURCE_EDITS), [])}
    if args.first_port:
        versions["first port"] = (
            _edited(args.first_port.read_text(), _SOURCE_FIRST_PORT_EDITS), [])
    jobs, cuts = {}, {}
    for version, (text, flags) in versions.items():
        for tag, cut in SOURCE_CUTS.items():
            if version == "first port" and tag[:3] in ("(e)", "(f)", "(g)", "(h)", "(i)"):
                continue  # the new kernel's variants
            name = f"{version} {tag}"
            cuts[name] = (version, tag)
            if tag.startswith("(a)") or cut != 0:
                jobs[name] = (text, [*flags, f"-DCUT={cut}"])
    libs, logs = _build_all(jobs)
    res = {"sass": {}, "launch": {}}
    clocks = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm,clocks.sm",
                             "--format=csv,noheader,nounits"], capture_output=True,
                            text=True).stdout.strip().split(",")
    res["clock_max_mhz"], res["clock_now_mhz"] = (float(c) for c in clocks[:2])
    sms = cuda_cic._sm_count(dev.index)
    for tag in jobs:
        for line in _kernel_report(logs[tag], "source_batch"):
            print(f"[ptxas] {tag}: {line}", flush=True)
        if tag.endswith("(a) full"):
            # the batch (not the uniforms); the current kernel's widest loop
            # holds four rows, the first port's one
            loop = _sass_loop(Path(libs[tag]._name), "source_batch_kernelILb0E")
            rows = cuda_rng.SOURCE_ROWS_A_PASS if tag.startswith("current") else 1
            if loop["loop"]:
                loop["per_row"] = loop["loop"] / rows
                loop["sass_issue_ms"] = {
                    label: sass_issue_ms(loop["per_row"], n, sms, res["clock_max_mhz"])
                    for label, n in SOURCE_NS.items()}
            res["sass"][tag] = loop
            print(f"[sass] {tag}: {json.dumps(loop)}", flush=True)
    for name, (version, tag) in cuts.items():
        libs.setdefault(name, libs.get(f"{version} (a) full"))
    for name, lib in libs.items():
        lib.pypic_source_batch.argtypes = _build._SIGNATURES["pypic_source_batch"][0]
        lib.pypic_source_batch.restype = _I
        if cuts[name][0] == "current":
            lib.pypic_source_blocks_per_sm.argtypes = [_I, _I]
            lib.pypic_source_blocks_per_sm.restype = _I
    stream = torch.cuda.current_stream().cuda_stream
    f32 = np.float32
    scalars = [float(f32(x)) for x in (1.5e-3, 2.5e-4, 3e-3, 1.0 / 3e-3, 2.2e4, 0.0,
                                       6.283185307179586)]
    calls = {}
    for label, n in SOURCE_NS.items():
        padded = cuda_cic.padded_rows(4, n, dev)
        flat = torch.empty((4, n), dtype=torch.float32, device=dev)
        for name, (version, tag) in cuts.items():
            uni = int(tag.startswith("(b)"))
            if version == "current":  # one wave, as cuda_rng.source_grid
                threads = {"(f)": 128, "(g)": 256}.get(tag[:3], cuda_rng.SOURCE_THREADS)
                per_sm = max(1, libs[name].pypic_source_blocks_per_sm(threads, uni))
                outs, tail = padded, (uni, min(per_sm * sms, -(-n // threads)), threads)
            else:
                outs, tail = tuple(flat), (uni, cuda_cic._blocks(n, dev), cuda_cic._THREADS)

            def call(lib=libs[name], outs=outs, n=n, tail=tail):
                _build.check(lib.pypic_source_batch(
                    *(o.data_ptr() for o in outs), n, 0, 1, 7, *scalars, *tail, stream),
                    "resident_split")
            calls[f"{label}: {name}"] = call
    return res, calls, {"per": "launch", "count": 1, "timer": _queued}


# ---------------------------------------------------------------------------
# rows 1 and 2's pass (csrc/cic.cu picard_iteration_kernel) in its global
# mode, beside its cluster mode
# ---------------------------------------------------------------------------

PASS_SHAPES = [(n, ng) for n in (10_000_000, 100_000_000)
               for ng in (65_536, 262_144, 1 << 20)]
PASS_CUTS = {
    "(a) full": 0,
    "(b) no adds": 1,          # the products summed in a register; ph stored
    "(c) per-row scratch": 2,  # the two products stored at 2 i, 2 i + 1 of a (2 n,) array
    "(d) cluster mode": 0,     # the full kernel's kCluster instantiation
    "(e) pair mode": 0,        # the full kernel's kPair: one red.global.add.v2.f32 a row
    "(f) cluster, red.shared::cluster": 4,  # (d) with each add an explicit DSMEM reduction
}
_PASS_EDITS = [
    (_INLINED, _INLINED + _CUT_DEFINE, 1),
    ("template <bool EMIT_V, bool SHARED, int MODE, typename T>\n"
     "__global__ void picard_iteration_kernel(",
     "__device__ __forceinline__ void store2(float* p, float a, float b) {\n"
     "  *reinterpret_cast<float2*>(p) = make_float2(a, b);\n}\n"
     "__device__ __forceinline__ void store2(double* p, double a, double b) {\n"
     "  *reinterpret_cast<double2*>(p) = make_double2(a, b);\n}\n"
     "template <bool EMIT_V, bool SHARED, int MODE, typename T>\n"
     "__global__ void picard_iteration_kernel(", 1),
    ("  const T half = (T)0.5;\n  int clamped = 0;",
     "  const T half = (T)0.5;\n  int clamped = 0;\n  T sink = (T)0;", 1),
    ("    } else {\n      atomicAdd(&hist[c.l], mul_rn(val, c.wl));\n"
     "      atomicAdd(&hist[c.r], mul_rn(val, c.wr));\n    }",
     "    } else {\n#if CUT == 1\n"
     "      sink = add_rn(sink, add_rn(mul_rn(val, c.wl), add_rn(mul_rn(val, c.wr), (T)c.l)));\n"
     "#elif CUT == 2\n      store2(jh + 2 * i, mul_rn(val, c.wl), mul_rn(val, c.wr));\n"
     "#else\n      atomicAdd(&hist[c.l], mul_rn(val, c.wl));\n"
     "      atomicAdd(&hist[c.r], mul_rn(val, c.wr));\n#endif\n    }", 1),
    ("  if (SHARED && clamped) atomicAdd(&s_clamped, clamped);\n  if constexpr (MODE == kCluster)",
     "  if (sink == (T)1.2345e30f) ph_out[0] = sink;\n"
     "  if (SHARED && clamped) atomicAdd(&s_clamped, clamped);\n  if constexpr (MODE == kCluster)", 1),
    # (f): the owner's slice addressed by mapa, the add a red.shared::cluster
    ("  atomicAdd(cluster.map_shared_rank(slices, r) + o, al);\n"
     "  atomicAdd(cluster.map_shared_rank(slices, rr) + ro, ar);",
     "#if CUT == 4\n  dsmem_add(slices + o, r, al);\n  dsmem_add(slices + ro, rr, ar);\n#else\n"
     "  atomicAdd(cluster.map_shared_rank(slices, r) + o, al);\n"
     "  atomicAdd(cluster.map_shared_rank(slices, rr) + ro, ar);\n#endif", 1),
    ("// kCluster's adds of a row's two products:",
     "__device__ __forceinline__ unsigned dsmem_at(const void* local, int rank) {\n"
     "  unsigned a = (unsigned)__cvta_generic_to_shared(local), ra;\n"
     "  asm volatile(\"mapa.shared::cluster.u32 %0, %1, %2;\" : \"=r\"(ra) : \"r\"(a),"
     " \"r\"(rank));\n  return ra;\n}\n"
     "__device__ __forceinline__ void dsmem_add(float* local, int rank, float v) {\n"
     "  asm volatile(\"red.shared::cluster.add.f32 [%0], %1;\" :: \"r\"(dsmem_at(local, rank)),"
     " \"f\"(v) : \"memory\");\n}\n"
     "__device__ __forceinline__ void dsmem_add(double* local, int rank, double v) {\n"
     "  asm volatile(\"red.shared::cluster.add.f64 [%0], %1;\" :: \"r\"(dsmem_at(local, rank)),"
     " \"d\"(v) : \"memory\");\n}\n"
     "// kCluster's adds of a row's two products:", 1),
]


def _split_pass(_args, dev) -> tuple[dict, dict, dict]:
    """Rows 1 and 2's cuts (PASS_CUTS) at PASS_SHAPES, float32 and float64:
    the pass without its window (row 1), v1 not stored, as the headline's
    passes launch it."""
    text = _edited(_inlined(_build.CSRC_DIR / "cic.cu"), _PASS_EDITS)
    jobs = {tag: (text, [f"-DCUT={cut}"]) for tag, cut in PASS_CUTS.items()
            if tag.startswith("(a)") or cut}
    libs, logs = _build_all(jobs, optional=("(f) cluster, red.shared::cluster",))
    res = {"registers": {}, "sass": {}, "launch": {}}
    for tag in libs:
        res["registers"][tag] = _kernel_report(logs[tag], "picard_iteration_kernel")
        for line in res["registers"][tag]:
            print(f"[ptxas] {tag}: {line}", flush=True)
    for tag, mode, word in (("(a) full", "global", "ILb0ELb0ELi1E"),
                            ("(a) full", "cluster", "ILb0ELb0ELi2E"),
                            ("(a) full", "shared window, cluster", "ILb0ELb1ELi2E"),
                            ("(a) full", "pair", "ILb0ELb0ELi3E"),
                            ("(f) cluster, red.shared::cluster", "(f) cluster",
                             "ILb0ELb0ELi2E")):
        if tag not in libs:
            continue
        ops = _atomics(Path(libs[tag]._name), "picard_iteration_kernel" + word,
                       ("ATOM", "RED"))
        res["sass"][mode] = ops
        print(f"[sass] {mode}: {ops}", flush=True)
    libs["(d) cluster mode"] = libs["(e) pair mode"] = libs["(a) full"]
    for lib in set(libs.values()):
        for dtype in (torch.float32, torch.float64):
            fn = "pypic_picard_iteration" + ("_f64" if dtype == torch.float64 else "")
            getattr(lib, fn).argtypes = _build._SIGNATURES[fn][0]
            getattr(lib, fn).restype = _I
        lib.pypic_picard_iteration_clusters.argtypes = [_I] * 6 + [_P]
        lib.pypic_picard_iteration_clusters.restype = _I
    stream = torch.cuda.current_stream().cuda_stream
    sms = cuda_cic._sm_count(dev.index)
    qm, w, dt, dx = -1.7e11, -3.2e-9, 1e-7, 0.05  # chip_smoke.py's QM, W, DT, DX
    calls = {}
    for dtype in (torch.float32, torch.float64):
        item = torch.empty((), dtype=dtype).element_size()
        label = "float32" if item == 4 else "float64"
        gen = torch.Generator(device=dev).manual_seed(41)
        n_max = max(n for n, _ in PASS_SHAPES)
        ps = torch.rand(n_max, generator=gen, device=dev, dtype=dtype)
        p0 = torch.rand(n_max, generator=gen, device=dev, dtype=dtype)
        v0 = torch.randn(n_max, generator=gen, device=dev, dtype=dtype) * 1e5
        ph = torch.empty_like(ps)
        scratch = torch.empty(2 * n_max, dtype=dtype, device=dev)
        scalars = cuda_cic.kernel_scalars(qm, dt, dx, w, dtype)
        fn = "pypic_picard_iteration" + ("_f64" if item == 8 else "")
        for n, ng in PASS_SHAPES:
            field = torch.randn(ng, generator=gen, device=dev, dtype=dtype) * 1e3
            pos = [t[:n] * ng for t in (ps, p0)]  # rows in random order over the grid
            out = torch.zeros(3 * ng, dtype=dtype, device=dev)
            glob = cuda_cic.cluster_launch("picard_iteration", n, ng, sms, item, mode="global")
            shape = {"global": dataclasses.asdict(glob)}
            if cuda_cic.cluster_size("picard_iteration", ng, item) is not None:
                clus = cuda_cic.cluster_launch("picard_iteration", n, ng, sms, item,
                                               mode="cluster")
                count = ctypes.c_int(0)
                _build.check(libs["(a) full"].pypic_picard_iteration_clusters(
                    0, 0, int(item == 8), ng, clus.cluster, clus.threads,
                    ctypes.byref(count)), "resident_split (cluster occupancy)")
                clus = cuda_cic.cluster_launch("picard_iteration", n, ng, sms, item,
                                               count.value, mode="cluster")
                shape["cluster"] = dict(dataclasses.asdict(clus), held=count.value)
            res["launch"][f"{label} n {n}, ng {ng}"] = shape
            for tag, cut in PASS_CUTS.items():
                mode = {"(d)": "cluster", "(e)": "pair", "(f)": "cluster"}.get(tag[:3], "global")
                if (tag not in libs or mode == "cluster" and "cluster" not in shape
                        or mode == "pair" and item == 8):
                    continue  # not built; no cluster holds ng; no vector reduction of doubles
                grid = shape["cluster" if mode == "cluster" else "global"]
                target = scratch if cut == 2 else out
                args = (field, pos[0], pos[1], v0[:n], ph[:n])

                def call(lib=libs[tag], fn=fn, args=args, target=target, n=n, ng=ng,
                         grid=grid, mode=mode, scalars=scalars):
                    _build.check(getattr(lib, fn)(
                        *(a.data_ptr() for a in args), None, target.data_ptr(), n, ng,
                        *scalars, cuda_cic._inv(ng, args[0].dtype), cuda_cic.SMEM_MODES[mode],
                        grid["blocks"], grid["threads"], grid["cluster"], stream),
                        "resident_split")
                calls[f"{label} n {n}, ng {ng}: {tag}"] = call
    return res, calls, {"per": "launch", "count": 1, "timer": _queued}


# ---------------------------------------------------------------------------
# rows 17 and 14 (csrc/domain.cu picard_iteration_ext_kernel, csrc/explicit.cu
# leapfrog_deposit_kernel) in their global mode, beside their cluster and
# pair modes
# ---------------------------------------------------------------------------

# n = 1e7 at the large grids, and the rows of one of two ranks at ext_n
# ~38,700 (configs[4]'s load of phase 41's checks, 2.5e5 a rank) and 1e6
EXT_SHAPES = ([(10_000_000, ext_n) for ext_n in (32_768, 38_700, 65_536, 1 << 20)]
              + [(n, 38_700) for n in (250_000, 1_000_000)])
LEAPFROG_SHAPES = ([(10_000_000, ng, 4) for ng in (32_768, 65_536, 1 << 20)]
                   + [(10_000_000, ng, 8) for ng in (32_768, 65_536)]
                   + [(1_000_000, 32_768, 4)])
SWEEP_CUTS = {
    "(a) global": 0,
    "(b) no adds": 1,        # the products summed in a register; the stores kept
    "(c) adds alone": 2,     # a row's position read and its two global atomics
    "(d) cluster mode": 0,   # the full kernel's kCluster instantiation
    "(e) pair mode": 0,      # the full kernel's kPair: one red.global.add.v2.f32 a row
}
_SINK_END = "  if (sink == 1.2345e30f) ph_out[0] = sink;\n"
_EXT_EDITS = [
    (_INLINED, _INLINED + _CUT_DEFINE, 1),
    ("  const float top = (float)(width - 1);\n  int clamped = 0;",
     "  const float top = (float)(width - 1);\n  int clamped = 0;\n  float sink = 0.0f;", 1),
    ("    const float s = clampf(ps[i], lo, hi);\n    const float a = p0[i];\n",
     "#if CUT == 2\n    {\n      const Cic c = cic_bounded(clampf(ps[i], lo, hi), ext_n);\n"
     "      atomicAdd(&hist[c.l], c.wl);\n      atomicAdd(&hist[c.r], c.wr);\n"
     "      continue;\n    }\n#endif\n"
     "    const float s = clampf(ps[i], lo, hi);\n    const float a = p0[i];\n", 1),
    ("      } else {\n        atomicAdd(&hist[c.l], __fmul_rn(val, c.wl));\n"
     "        atomicAdd(&hist[c.r], __fmul_rn(val, c.wr));\n      }",
     "      } else {\n#if CUT == 1\n        sink = __fadd_rn(sink, __fadd_rn(__fmul_rn(val, c.wl), "
     "__fadd_rn(__fmul_rn(val, c.wr), (float)c.l)));\n#else\n"
     "        atomicAdd(&hist[c.l], __fmul_rn(val, c.wl));\n"
     "        atomicAdd(&hist[c.r], __fmul_rn(val, c.wr));\n#endif\n      }", 1),
    ("  if (SHARED && clamped) atomicAdd(&s_clamped, clamped);\n  if constexpr (MODE == kCluster)",
     _SINK_END + "  if (SHARED && clamped) atomicAdd(&s_clamped, clamped);\n"
     "  if constexpr (MODE == kCluster)", 1),
]
_LEAPFROG_EDITS = [
    (_INLINED, _INLINED + _CUT_DEFINE, 1),
    ("    const T a = p[i];\n    const T e = gather_mode<MODE>(s_field, field, cic_periodic(a, ng));\n"
     "    T p1, v1;\n    leapfrog(",
     "#if CUT == 2\n    {\n      const CicT<T> c = cic_periodic(p[i], ng);\n"
     "      atomicAdd(&s_hist[c.l], mul_rn(w, c.wl));\n"
     "      atomicAdd(&s_hist[c.r], mul_rn(w, c.wr));\n      continue;\n    }\n#endif\n"
     "    const T a = p[i];\n    const T e = gather_mode<MODE>(s_field, field, cic_periodic(a, ng));\n"
     "    T p1, v1;\n    leapfrog(", 1),
    ("  const T ngf = (T)ng;\n  const long long stride = (long long)gridDim.x * blockDim.x;\n"
     "  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;\n"
     "       i += stride) {\n#if CUT == 2",
     "  const T ngf = (T)ng;\n  T sink = (T)0;\n"
     "  const long long stride = (long long)gridDim.x * blockDim.x;\n"
     "  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;\n"
     "       i += stride) {\n#if CUT == 2", 1),
    ("    } else {\n      atomicAdd(&s_hist[c.l], mul_rn(w, c.wl));\n"
     "      atomicAdd(&s_hist[c.r], mul_rn(w, c.wr));\n    }\n  }\n}\n",
     "    } else {\n#if CUT == 1\n      sink = add_rn(sink, add_rn(mul_rn(w, c.wl), "
     "add_rn(mul_rn(w, c.wr), (T)c.l)));\n#else\n"
     "      atomicAdd(&s_hist[c.l], mul_rn(w, c.wl));\n"
     "      atomicAdd(&s_hist[c.r], mul_rn(w, c.wr));\n#endif\n    }\n  }\n"
     "  if (sink == (T)1.2345e30f) p1_out[0] = sink;\n}\n", 1),
]


def _split_sweep(kernel: str, dev) -> tuple[dict, dict, dict]:
    """Row 17's (``kernel`` 'picard_iteration_ext') or row 14's
    ('leapfrog_deposit') cuts, SWEEP_CUTS, at EXT_SHAPES or
    LEAPFROG_SHAPES."""
    ext = kernel == "picard_iteration_ext"
    source, edits, word = (("domain.cu", _EXT_EDITS, "picard_iteration_ext_kernel") if ext
                           else ("explicit.cu", _LEAPFROG_EDITS, "leapfrog_deposit_kernel"))
    rule = "picard_iteration_ext" if ext else "leapfrog_gather_push_deposit"
    text = _edited(_inlined(_build.CSRC_DIR / source), edits)
    jobs = {tag: (text, [f"-DCUT={cut}"]) for tag, cut in SWEEP_CUTS.items()
            if tag.startswith("(a)") or cut}
    libs, logs = _build_all(jobs)
    res = {"registers": {}, "sass": {}, "launch": {}}
    for tag in libs:
        res["registers"][tag] = _kernel_report(logs[tag], word)
        for line in res["registers"][tag]:
            print(f"[ptxas] {tag}: {line}", flush=True)
    # the mangled template arguments of each mode's instantiation
    modes = ({"global": "ILb0ELb0ELi1E", "cluster": "ILb0ELb0ELi2E", "pair": "ILb0ELb0ELi3E",
              "shared window, cluster": "ILb0ELb1ELi2E", "shared window, pair": "ILb0ELb1ELi3E"}
             if ext else {"global": "ILi1EfE", "cluster": "ILi2EfE", "pair": "ILi3EfE",
                          "float64 global": "ILi1EdE", "float64 cluster": "ILi2EdE"})
    for mode, args in modes.items():
        ops = _atomics(Path(libs["(a) global"]._name), word + args, ("ATOM", "RED"))
        res["sass"][mode] = ops
        print(f"[sass] {mode}: {ops}", flush=True)
    libs["(d) cluster mode"] = libs["(e) pair mode"] = libs["(a) global"]
    entries = (("pypic_picard_iteration_ext", "pypic_picard_iteration_ext_clusters") if ext
               else ("pypic_leapfrog_deposit", "pypic_leapfrog_deposit_f64",
                     "pypic_leapfrog_deposit_clusters"))
    for lib in set(libs.values()):
        for fn in entries:
            getattr(lib, fn).argtypes, getattr(lib, fn).restype = _build._SIGNATURES[fn]
    stream = torch.cuda.current_stream().cuda_stream
    sms = cuda_cic._sm_count(dev.index)
    qm, w, dt, dx = -1.7e11, -3.2e-9, 1e-7, 0.05  # chip_smoke.py's QM, W, DT, DX
    shapes = [(n, ng, 4) for n, ng in EXT_SHAPES] if ext else LEAPFROG_SHAPES
    gen = torch.Generator(device=dev).manual_seed(41)
    n_max = max(n for n, _, _ in shapes)
    calls = {}
    for dtype in (torch.float32, torch.float64):
        item = torch.empty((), dtype=dtype).element_size()
        if not any(s[2] == item for s in shapes):
            continue
        label = "float32" if item == 4 else "float64"
        u = torch.rand(3, n_max, generator=gen, device=dev, dtype=dtype)
        v0 = torch.randn(n_max, generator=gen, device=dev, dtype=dtype) * 1e5
        out = [torch.empty(n_max, dtype=dtype, device=dev) for _ in range(2)]
        wts = torch.where(u[2] < 0.05, 0.0, w).to(dtype)  # 5% dead slots
        for n, ng, it in shapes:
            if it != item:
                continue
            field = torch.randn(ng, generator=gen, device=dev, dtype=dtype) * 1e3
            pos = [x[:n] * (ng - 1) for x in u[:2]]  # rows in random order over the grid
            acc = torch.zeros(3 * ng + 2, dtype=dtype, device=dev)
            grids = {"global": cuda_cic.cluster_launch(rule, n, ng, sms, item, mode="global")}
            if cuda_cic.cluster_size(rule, ng, item) is not None:
                clus = cuda_cic.cluster_launch(rule, n, ng, sms, item, mode="cluster")
                count = ctypes.c_int(0)
                query = (libs["(a) global"].pypic_picard_iteration_ext_clusters(
                    0, 0, ng, clus.cluster, clus.threads, ctypes.byref(count)) if ext else
                    libs["(a) global"].pypic_leapfrog_deposit_clusters(
                        int(item == 8), ng, clus.cluster, clus.threads, ctypes.byref(count)))
                _build.check(query, "resident_split (cluster occupancy)")
                grids["cluster"] = cuda_cic.cluster_launch(rule, n, ng, sms, item,
                                                           count.value, mode="cluster")
            if item == 4:
                grids["pair"] = cuda_cic.cluster_launch(rule, n, ng, sms, item, mode="pair")
            res["launch"][f"{label} n {n}, ng {ng}"] = {
                m: dataclasses.asdict(g) for m, g in grids.items()}
            if ext:
                scalars = cuda_cic.kernel_scalars(qm, dt, dx, w)[:3]
                args = (field, pos[0], pos[1], v0[:n], wts[:n], out[0][:n])
            else:
                scalars = cuda_cic.leapfrog_scalars(qm, dt, dx, w, dtype)
                args = (field, pos[0], v0[:n], out[0][:n], out[1][:n])
            for tag in SWEEP_CUTS:
                mode = {"(d)": "cluster", "(e)": "pair"}.get(tag[:3], "global")
                if mode not in grids:
                    continue  # no cluster holds ng; no vector reduction of doubles
                grid = grids[mode]

                def call(lib=libs[tag], args=args, acc=acc, grid=grid, mode=mode, n=n,
                         ng=ng, scalars=scalars, item=item):
                    ptrs = [a.data_ptr() for a in args]
                    mode_args = (cuda_cic.SMEM_MODES[mode], grid.blocks, grid.threads,
                                 grid.cluster, stream)
                    if ext:
                        err = lib.pypic_picard_iteration_ext(
                            *ptrs, None, acc.data_ptr(), None, None, n, ng, *scalars,
                            float(np.float32(0.0)), float(ng - 1), 0, 0, 0, 0, 0.0,
                            *mode_args)
                    else:
                        fn = lib.pypic_leapfrog_deposit_f64 if item == 8 else (
                            lib.pypic_leapfrog_deposit)
                        err = fn(*ptrs, acc.data_ptr(), n, ng, *scalars,
                                 cuda_cic._inv(ng, args[0].dtype), *mode_args)
                    _build.check(err, "resident_split")
                calls[f"{label} n {n}, ng {ng}: {tag}"] = call
    return res, calls, {"per": "launch", "count": 1, "timer": _queued}


# --kernel newton_dd_large|newton_dn_large: the Newton solves' large path
# (csrc/newton.cu above 1,024 rows) at NEWTON_LARGE_SHAPES (rows, element
# bytes), each cut run for 8 and for 64 iterations (tol 0): its us a
# further iteration. Phase 24's load (chip_smoke.py _newton_large_solve:
# 1e17 m^-3 with 30% noise, Te 10 eV, dx 2e-5 m; D-D cold, D-N warm start 0)
NEWTON_LARGE_SHAPES = ((4096, 4), (16_384, 4), (262_144, 4), (16_384, 8))
NEWTON_LARGE_ITERS = (8, 64)
# the one-CTA large kernels ('single'): CUT selects what is taken out; the
# loop runs the iterations asked for whatever its residual (CUT != 0)
NEWTON_LARGE_CUTS = {
    "(a) parent": 0,
    "(b) no PCR": 1,                       # the sweeps and the recovery alone
    "(c) PCR and barriers alone": 2,       # no sweep down, sweep up or recovery
    "(d) scratch in shared memory": 3,     # D-D at 4,096 rows in float32, where it fits
}
# (e): the cluster mode (newton_cluster_kernel, not edited) at C CTAs of
# large_shape's threads
NEWTON_LARGE_CLUSTERS = (2, 4, 8, 16)
_NEWTON_LARGE_EDITS = [
    ("#include \"cic_common.cuh\"",
     "#include \"cic_common.cuh\"\n#ifndef CUT\n#define CUT 0\n#endif\n"
     "#define CUT_ENDS(R) do { const int e0 = block_at(0), e1 = block_at(B.k - 1); \\\n"
     "  x0.a = B.ap[e0]; x0.b = (T)1; x0.c = B.cp[e0]; \\\n"
     "  x1.a = B.ap[e1]; x1.b = (T)1; x1.c = B.cp[e1]; \\\n"
     "  for (int r = 0; r < R; ++r) { \\\n"
     "    x0.f[r] = B.dp[r * B.npad + e0]; x1.f[r] = B.dp[r * B.npad + e1]; } } while (0)", 1),
    ("  while (it < s.maxiter && residual > s.tol) {",
     "  while (it < s.maxiter && (CUT != 0 || residual > s.tol)) {", 2),
    ("    pcr_solve_pair<1>(x0, x1, buf, 2 * T_);",
     "    if (CUT != 1) pcr_solve_pair<1>(x0, x1, buf, 2 * T_);", 1),
    ("    pcr_solve_pair<2>(x0, x1, buf, 2 * T_);",
     "    if (CUT != 1) pcr_solve_pair<2>(x0, x1, buf, 2 * T_);", 1),
    ("    sweep_down<1>(B, [&](int j) {\n      const int i = t * k + j;",
     "    if (CUT != 2) sweep_down<1>(B, [&](int j) {\n      const int i = t * k + j;", 1),
    ("    sweep_down<2>(B, [&](int j) {\n      const int i = t * k + j;",
     "    if (CUT != 2) sweep_down<2>(B, [&](int j) {\n      const int i = t * k + j;", 1),
    # (c): the block's two end rows read as the last full run left them
    ("    Row<1, T> x0, x1;\n    sweep_up<1>(B, x0, x1);",
     "    Row<1, T> x0, x1;\n    if (CUT != 2) sweep_up<1>(B, x0, x1);\n"
     "    else CUT_ENDS(1);", 1),
    ("    Row<2, T> x0, x1;\n    sweep_up<2>(B, x0, x1);",
     "    Row<2, T> x0, x1;\n    if (CUT != 2) sweep_up<2>(B, x0, x1);\n"
     "    else CUT_ENDS(2);", 1),
    ("    double sq = 0.0;\n    for (int j = 0; j < k; ++j) {\n      T x;",
     "    double sq = 0.0;\n    for (int j = 0; j < (CUT == 2 ? 0 : k); ++j) {\n      T x;", 1),
    ("    double sq = 0.0;\n    for (int j = 0; j < k; ++j) {\n      T yz[2];",
     "    double sq = 0.0;\n    for (int j = 0; j < (CUT == 2 ? 0 : k); ++j) {\n      T yz[2];",
     1),
    # (d): the D-D kernel's scratch after its PCR buffers and edge phi
    ("  __shared__ T s_redf[32];\n  T* phi_s = scratch;\n  T* c2_s = scratch + npad;  // dx^2 c2\n"
     "  const Blocks<T> B = newton_blocks(scratch, k, npad);\n  const T c0",
     "  __shared__ T s_redf[32];\n  if (CUT == 3) scratch = s_edge + 2 * T_;\n"
     "  T* phi_s = scratch;\n  T* c2_s = scratch + npad;  // dx^2 c2\n"
     "  const Blocks<T> B = newton_blocks(scratch, k, npad);\n  const T c0", 1),
    ("  const size_t smem = newton_smem<1, T>(2 * threads);",
     "  const size_t smem = newton_smem<1, T>(2 * threads) +\n"
     "                      (CUT == 3 ? 5 * (size_t)threads * k * sizeof(T) : 0);", 1),
]


def _split_newton_large(args, dev) -> tuple[dict, dict, dict]:
    """The large path's cuts (NEWTON_LARGE_CUTS) and its cluster mode at
    NEWTON_LARGE_CLUSTERS, at NEWTON_LARGE_SHAPES, each for 8 and 64
    iterations; returns the calls and, in ``unit['further']``, the us a
    further iteration of each from its two times."""
    from ..ops import cuda_newton

    dn = args.kernel == "newton_dn_large"
    text = _edited((_build.CSRC_DIR / "newton.cu").read_text(), _NEWTON_LARGE_EDITS)
    jobs = {tag: (text, [f"-DCUT={cut}"]) for tag, cut in NEWTON_LARGE_CUTS.items()
            if not (cut == 3 and dn)}
    libs, logs = _build_all(jobs)
    for line in _kernel_report(logs["(a) parent"], "newton_cluster"):
        print(f"[ptxas] {line}", flush=True)
    for lib in libs.values():
        _bind_newton_large(lib, dn)
        lib.pypic_newton_clusters.argtypes = _build._SIGNATURES["pypic_newton_clusters"][0]
        lib.pypic_newton_clusters.restype = _I
    calls, counts, res = {}, {}, {"shapes": {}}
    for rows, item in NEWTON_LARGE_SHAPES:
        dtype = torch.float64 if item == 8 else torch.float32
        label = f"{rows} rows, {'float64' if item == 8 else 'float32'}"
        shapes = {"single": cuda_newton.large_shape(rows, item, "single", dn=dn)}
        for c in NEWTON_LARGE_CLUSTERS:
            shapes[f"C {c}"] = cuda_newton.large_shape(rows, item, "cluster", c, dn=dn)
        res["shapes"][label] = {k: dataclasses.asdict(v) for k, v in shapes.items()}
        call = newton_large_caller(dn, rows, dtype, dev, max(v.rows for v in shapes.values()))
        cases = [(tag, libs[tag], shapes["single"]) for tag in libs
                 if not (NEWTON_LARGE_CUTS[tag] == 3 and (rows, item) != (4096, 4))]
        cases += [(f"(e) cluster C = {c}", libs["(a) parent"], shapes[f"C {c}"])
                  for c in NEWTON_LARGE_CLUSTERS]
        # (c) reads the end rows the last full run left in the scratch
        call(libs["(a) parent"], shapes["single"], NEWTON_LARGE_ITERS[0])
        for tag, lib, shape in cases:
            for its in NEWTON_LARGE_ITERS:
                name = f"{label}: {tag}, {its} iterations"
                calls[name] = functools.partial(call, lib, shape, its)
                counts[name] = its

    def further(ms: dict) -> dict:
        lo, hi = NEWTON_LARGE_ITERS
        out = {}
        for name in ms:
            if name.endswith(f", {lo} iterations"):
                base = name[:-len(f", {lo} iterations")]
                a, b = ms[name], ms.get(f"{base}, {hi} iterations")
                if b and all(v is not None for v in a + b):
                    out[base] = 1e3 * (min(b) - min(a)) / (hi - lo)
        return out

    return res, calls, {"per": "iteration", "count": counts, "timer": _queued,
                        "further": further}


def _bind_newton_large(lib, dn: bool) -> None:
    """The argument types of the Newton large path's entry points (both
    modes, both dtypes) of a library built here."""
    what = "boltzmann_dn" if dn else "boltzmann_dirichlet"
    for suffix in ("", "_f64"):
        for kind in ("large", "cluster"):
            fn = getattr(lib, f"pypic_{what}_{kind}{suffix}")
            fn.argtypes, fn.restype = _build._SIGNATURES[f"pypic_{what}_{kind}{suffix}"]


def newton_large_caller(dn: bool, rows: int, dtype, dev, scratch_rows: int):
    """call(lib, shape, maxiter): one launch of the Newton large path of
    ``lib`` (D-N if ``dn``, else D-D; the entry point of ``shape``'s mode,
    ``_f64`` for float64) at tol 0 on phase 24's load at ``rows`` in
    ``dtype`` (chip_smoke.py _newton_large_solve: 1e17 m^-3 with 30% noise,
    Te 10 eV, dx 2e-5 m; D-D cold, D-N warm start 0), the wrappers'
    scalars; every call shares one scratch of ``scratch_rows`` rows (cut
    (c) reads the end rows the last full run left there)."""
    from ..constants import E_CHARGE
    from ..ops import cuda_newton

    what = "boltzmann_dn" if dn else "boltzmann_dirichlet"
    suffix = "_f64" if dtype == torch.float64 else ""
    rng = np.random.default_rng(11 + rows)
    num = (1e17 * (1.0 + 0.3 * rng.standard_normal(rows))).clip(1e15)
    dens = torch.from_numpy(num * (1.0 if dn else E_CHARGE)).to(dtype).to(dev)
    n0 = torch.full((1,), 0.9e17 if dn else 1e17, dtype=dtype, device=dev)
    phi0 = torch.zeros(rows, dtype=dtype, device=dev)
    phi = torch.empty(rows, dtype=dtype, device=dev)
    iters = torch.zeros((), dtype=torch.int32, device=dev)
    resid = torch.empty((), dtype=dtype, device=dev)
    scratch = torch.empty((6 * scratch_rows,), dtype=dtype, device=dev)
    c1, dx2, _, step_max = cuda_newton.newton_scalars(11600.0 * 10.0, 2e-5, 0.0, dtype)
    coef = cuda_newton._coef(dtype)
    head = (coef,) if dn else (coef, float(cuda_newton.real(dtype)(EPSILON_0)))
    stream = torch.cuda.current_stream(dev).cuda_stream if dev.type == "cuda" else None
    tensors = (dens, n0, phi0, phi, iters, resid, scratch)  # alive as long as call

    def call(lib, shape, maxiter):
        ptrs = tuple(None if (t is phi0 and not dn) else t.data_ptr() for t in tensors)
        tail = (c1, dx2, 0.0, maxiter, step_max, cuda_newton._EXP_CLAMP, stream)
        if shape.mode == "single":
            err = getattr(lib, f"pypic_{what}_large{suffix}")(
                *ptrs, rows, shape.k, shape.threads, *head, *tail)
        else:
            err = getattr(lib, f"pypic_{what}_cluster{suffix}")(
                *ptrs, rows, shape.k, shape.threads, shape.cluster, int(shape.shared),
                *head, *tail)
        _build.check(err, "resident_split")

    return call


# The one-CTA large path's latency floor: cut (c) of NEWTON_LARGE_CUTS (its
# PCR and barriers alone), us a further iteration between the
# NEWTON_LARGE_ITERS solves, for chip_smoke.py phase 24: its library
# compiles beside the package's (start_newton_floor_build, then
# newton_floor_library) and newton_floor_us times it
NEWTON_FLOOR_CUT = "(c) PCR and barriers alone"


def start_newton_floor_build() -> dict:
    """Starts nvcc on csrc/newton.cu with cut (c); the handle for
    newton_floor_library."""
    text = _edited((_build.CSRC_DIR / "newton.cu").read_text(), _NEWTON_LARGE_EDITS)
    return _start_builds({"newton floor": (text,
                                           [f"-DCUT={NEWTON_LARGE_CUTS[NEWTON_FLOOR_CUT]}"])})


def newton_floor_library(build: dict):
    """Waits for start_newton_floor_build's nvcc; returns the library."""
    return _finish_builds(build)[0]["newton floor"]


def newton_floor_us(cut, cases, dev) -> dict:
    """The latency floor of the one-CTA large path at each (dn, rows,
    dtype) of ``cases``: cut (c)'s us a further iteration (the least of
    two _queued times of each solve) in ``cut`` (newton_floor_library's),
    after one full NEWTON_LARGE_ITERS[0] solve of the package's own kernel
    on the same scratch. Returns {(dn, rows, dtype): us}."""
    from ..ops import cuda_newton

    lo, hi = NEWTON_LARGE_ITERS
    out = {}
    for dn, rows, dtype in cases:
        _bind_newton_large(cut, dn)
        shape = cuda_newton.large_shape(rows, torch.finfo(dtype).bits // 8, "single", dn=dn)
        call = newton_large_caller(dn, rows, dtype, dev, shape.rows)
        call(_build.library(), shape, lo)
        ms = {its: min(_queued(functools.partial(call, cut, shape, its)) for _ in range(2))
              for its in (lo, hi)}
        out[(dn, rows, dtype)] = 1e3 * (ms[hi] - ms[lo]) / (hi - lo)
    return out


def main() -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=("implicit", "explicit", "newton_dd", "newton_dn",
                                         "newton_dd_large", "newton_dn_large",
                                         "deposit2", "boris_deposit", "deposit",
                                         "deposit_det", "source_batch",
                                         "picard_iteration", "picard_iteration_ext",
                                         "leapfrog_deposit"),
                    default="implicit")
    ap.add_argument("--first-port", type=Path,
                    help="the kernel's first port (its csrc/implicit.cu, newton.cu, "
                         "magnetized.cu, cic.cu with its cic_common.cuh beside it, or "
                         "rng.cu), split as well")
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
             "newton_dn": _split_newton, "newton_dd_large": _split_newton_large,
             "newton_dn_large": _split_newton_large, "deposit2": _split_deposit,
             "boris_deposit": _split_deposit, "deposit": _split_single,
             "deposit_det": _split_single,
             "source_batch": _split_source,
             "picard_iteration": _split_pass,
             "picard_iteration_ext": lambda a, d: _split_sweep(a.kernel, d),
             "leapfrog_deposit": lambda a, d: _split_sweep(a.kernel, d),
             }.get(args.kernel, _split_implicit)
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
    if "further" in unit:
        res["further_us"] = unit["further"](res["ms"])
        for tag, us in res["further_us"].items():
            print(f"[split] {tag}: {us:.3f} us a further iteration", flush=True)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
