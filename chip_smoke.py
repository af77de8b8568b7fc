#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (pypic_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. device  — requires CUDA; prints torch/CUDA versions and the card's name
   and power limit as nvidia-smi reports them.
2. build   — builds the CUDA kernels from pypic_tpu_torch/csrc with nvcc
   (one nvcc per source, all at once).
3. kernels — each kernel of the implicit path against its plain PyTorch
   version on the card, at a ragged n = 10,000,003 with edge positions and
   at the headline n = 6104 * 16384, the deposits (the kernel's and jh)
   also against a float64 deposit; prints the errors against the stated
   tolerances and both times (CUDA events around 10 back-to-back calls,
   median of 10 rounds, after a warm-up).
4. check   — a small Landau load (n = 20,000) through init_state and three
   conserving steps on the card and on the CPU (plain versions); the two
   must agree.
5. slice   — the headline conserving Landau configuration at
   n = 6104 * 16384 through init_state, a 2-step warm-up and 20 timed steps
   of runner.run; prints ms/step, pushes/s, Picard iterations and energy
   changes, and checks that every kernel of the path was launched.
6. explicit kernels — the four kernels of the explicit engine against
   their plain versions at the same two n (gather periodic and bounded,
   the push+deposit sweep at ng = 200 and 4096, the one-kernel cycle at
   ng = 200 and 1024 with rho1 against a float64 deposit and e1 against a
   float64 FFT solve), the gather also against its library yardstick
   (grid_sample, timed beside it), and the resident kernel at n = 4097,
   10,000 and 32768 over 37 steps (chunks of 16) against 37 one-kernel
   cycles and its plain version, then one 2,000-step launch at n = 10,000
   whose first 37 metric rows are held against the plain version's.
7. explicit check — two-stream loads (n = 20,000) at ng = 64 and 1536 and
   with per-particle q/m, 50 steps on the card and on the CPU.
8. explicit slice — bench.py's two-stream cell (BASELINE configs[0]) at
   n = 6104 * 16384, loaded on the card: init_state, 2 warm-up and 20 timed
   steps; then the ng = 4096 branch and the per-particle (composed) branch
   at the same n, 2 + 5 steps each. Each path runs with the launch counts
   set to 0 just before it and read just after.
9. resident — the configs[0] row: n = 10,000 through run_resident, 40,000
   steps at 2,000 a launch, its first 37 rows held against the plain
   version, beside 2,000 steps of the per-step path; then the two-stream
   growth rate (n = 20,000, ng = 64, 400 resident steps).
10. implicit kernels — the converged-deposit finalize (p1, v1 bit-identical
   to picard_finalize_nodep's, j1 against a float64 deposit) and the
   shared-window pass (seeded at the free-streaming midpoint, no clamp, jh
   against a float64 deposit at the midpoint; then forced to clamp, the
   count equal to the plain one) at n = 10,000,003 and 6104 * 16384, timed
   as in phase 3; the resident implicit kernel over 25 steps (chunks of 8)
   in both configurations of tests/test_pallas.py:450-453 at n = 9001,
   100,000 and 131,072 against 25 per-step steps and its plain version
   (rows, Picard counts and the final p, v, e, e_prev and j), then timed at the configs[1] row's shape (n = 1e5, 64 steps).
11. implicit check — 50 steps at n = 20,000 on the card and on the CPU:
   the composed backend on a two-species load, finalize='converged-deposit'
   and window_share='shared' (no deposit clamped) on a two-stream load.
12. implicit slices — bench.py's Landau row (BASELINE configs[1],
   tools/landau.py): 16,000 steps through run_resident in 250 launches,
   its first 25 rows held against the per-step path, beside 500 steps of
   the per-step path; the Landau damping rate (n = 400,000 per step, held
   to 0.7-1.4; n = 131,072 resident, printed); then the headline cell with
   finalize='converged-deposit', window_share='shared' and
   backend='composed', 2 + 5 steps each, launch counts set to 0 before each
   path and read after it.
13. magnetized kernels — the four kernels of the magnetized engine against
   their plain versions at bench.py's configs[3] n = 999,996 and a ragged
   1,000,003, ng = 600: deposit2 (also against a float64 deposit), the
   bounded gather + Boris push (mirrored and plain gather; inactive rows
   bit-equal), the Philox source batch (uniforms bit-equal) with
   torch.randn as its library yardstick, and the Newton-Boltzmann solve at
   ng = 600, 301 and 128, cold and warm, timed on the row's first solve
   (µs per Newton iteration). These four kernels run for less time than
   their wrappers' Python overhead, so their times are device times from a
   torch.profiler trace (``device_ms``).
14. magnetized check — pic_iead at n = 12,000: one step from the states
   after 0, 10 and 50 steps on the card and on the CPU with the same
   Philox draws, at tests/test_magnetized.py:461-489's single-step limits;
   then 200 steps on each side: the population invariant holds exactly on
   both, and the mean phi_max agrees within 5%.
15. magnetized slice — bench.py's configs[3] row (tools/magnetized.py):
   1,200 steps at n = 999,996 under torch.cuda.set_sync_debug_mode("error")
   (a host sync in a step fails the phase) with exactly 1,200 launches of
   each of its five kernels and no other; µs/step, pushes/s, Newton
   iterations, phi_max over the floating potential, the population
   invariant, the Newton residual and both species' IEADs; then 20 steps
   of backend='composed' with its launch counts.
16. sheath kernels — the sheath engine's four kernels against their
   plain versions at bench.py's configs[2] n = 1,000,000 and a ragged
   1,000,003, ng = 51 and 11, with rows at 0 and at cells, rows lost in an
   earlier pass and rows that cross a wall: the Picard pass's xh and the
   finalize's x1 and u1 bit-equal, the statuses equal, the currents
   against a float64 deposit (the wall nodes too), and a wall-charge-only
   pass (u0 = qm = 0) against the exact wall sums; the deterministic
   deposit at ng = 51 and at the exit histograms' 128 nodes, bit-equal
   from call to call and against a float64 deposit, then timed beside the
   float-atomic deposit at its own and the other engines' shapes; the
   re-injection's Philox uniforms and positions bit-equal at gamma 0 and
   0.5, with torch.rand((5, n)) as its library yardstick; device times
   from the profiler.
17. sheath check — sheath_dd at n = 12,000, the exit histograms recording:
   one step from the states after 0, 10 and 50 steps on the card and on
   the CPU, fused and composed, the same Philox draws: equal Picard counts
   (or one apart where the first side left by the float32 floor exit),
   losses, statuses and
   histograms, p/u/e/j/phi at the CPU tests' single-step limits; 200
   steps each side (the population invariant exact, the time-averaged phi
   within 1e-4 Te/e, the Picard means within 10%); then
   tests/test_sheath.py:41-57's wall-potential test at n = 10,000 over
   1,500 steps on the card.
18. sheath slice — bench.py's configs[2] row (tools/sheath.py): 1,200
   steps at n = 1,000,000, sheath_picard launched once a Picard pass and
   sheath_finalize and sheath_reinject once a step, nothing else; the
   host syncs a step equal to the engine's reads (one a Picard pass);
   then 20 steps of backend='composed' with its launch counts (gather once
   and deposit_det twice a pass).
19. dn kernels — the D-N Newton kernel against its plain version and the
   op-composed Thomas route (on the CPU) at ng = 800, 600 and 257, cold
   and warm (tests/test_pallas.py:361-389's limits), timed on the D-N
   row's first solve (µs per iteration, profiler device time); the tagged
   Philox uniforms of the flux draw and the gyro-phases bit-equal to the
   plain version's at n = 50,000 and 999,996.
20. dn check — dirichlet_neumann_test at n = 12,000: one step from the
   states after 0, 10 and 50 steps on the card and on the CPU with the
   same flux draws, at phase 14's limits; then 200 steps each: the flux
   cap, and n0's and phi_max's means over the last 100 steps within 5%.
21. dn slice — the D-N row (tools/magnetized.py --row dn): n = 50,000,
   ng = 800, 1,200 steps under sync debug mode 'error', exactly 1,200
   launches of deposit2, boltzmann_dn, boris_gather_push and
   philox_uniforms and no other; the row's physics checks.
22. gc check — pic_iead_gc at n = 12,000: one step from the states after
   0, 10 and 50 steps on the card and on the CPU, the same source and
   gyro-phase draws.
23. gc slice — the GC row (--row gc): n = 999,996, 1,200 steps under
   sync debug mode 'error', its launch counts and physics checks.
24. size limits — each wrapper raises above the card's limit (shared
   memory, thread histograms, one CTA) and launches nothing; a
   magnetized step at ng = 1,200 with 'auto' takes the op-composed Thomas
   route, and 'pallas' there raises naming ROADMAP item 10.
25. domain kernels — the domain engines' four kernels against their
   plain versions at n = 10,000,003 (ragged, edge positions) and
   6104 * 16384, at the configs[4] slab's shape (ext_n = 231), with dead
   slots, positions past both clamp bounds and a middle rank's offset:
   the Picard pass (emit_v, the shared window's clamp count, a skipped
   pass), both finalizes (statistics bit-equal from call to call) and the
   leapfrog push at ng = 200; timed with CUDA events.
26. domain check — n = 20,000 from one CPU-made load, 5 steps of the
   implicit (fused) and explicit (fused push) domain engines: one rank on
   the card against one on the CPU, then two ranks on the one card (gloo,
   every message staged through the host and counted) against two on the
   CPU; energies, counts, positions and velocities slot for slot.
27. domain slice — bench.py's configs[4] row (tools/domain.py) at
   n = 1e8 on a one-rank NCCL mesh, 2 + 30 steps; then finalize
   'converged-deposit', the shared window and 'iterate', 2 + 3 steps
   each, and the explicit carrier with the fused push, 2 + 5; each path
   with its launch counts set to 0 before it and read after it and its
   host syncs counted under torch.cuda.set_sync_debug_mode.

Each phase prints its wall seconds. The line before the last is one JSON
object describing each kernel; the last line is {"ok": true, "device":
{...}}.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import torch

from pypic_tpu_torch.ops import fd, poisson
from pypic_tpu_torch.tools.headline import (
    N_HEADLINE, NG, headline_config, headline_state)

N_RAGGED = 10_000_003
WARMUP_STEPS = 2
TIMED_STEPS = 20
# scalars of tests/test_pallas.py's fused Picard case
QM, W, DT, DX = -1.7e11, -3.2e-9, 1e-7, 0.05
# tolerances of the kernel tests (positions in cells, others relative to
# the output's largest magnitude)
TOL_POS = 1e-4
TOL_V = 1e-4
# deposits (the kernel's and jh) against a float64 deposit of the same
# values, relative to the largest node: the 2e-5 of the CPU tests
TOL_DEP = 2e-5
# the one-kernel cycle's e1 against a float64 FFT solve of its own rho1:
# one float32 rounding of a float64 solve
TOL_SOLVE = 1e-6
# multi-step comparisons (the resident kernel over 37 steps, the explicit
# engine over 50): the engine tolerances of tests/test_engines.py:273-279.
# Summation order moves positions by float32 ulps from step to step (a
# 1e-7 change of the field moves them 9e-5 cells in 37 steps on the CPU).
TOL_POS_STEPS = 2e-3
# the resident kernel against the per-step cycle and its plain version over
# 37 steps, relative to the largest magnitude: the limits of the card test
# (tests/test_torch_cuda.py); measured 1e-7-5e-6 on the H100
TOL_RESIDENT = {"v": 1e-4, "rho": 2e-5, "e": 1e-4, "fe": 1e-4, "ke": 1e-5,
                "jb": 1e-5}
RESIDENT_CHECK_STEPS = 37
# the gather's library yardstick, grid_sample, against the kernel: the two
# round the position to the cell differently (CPU: 1.4e-5)
TOL_LIBRARY_GATHER = 1e-4
# ng = 1536: cuFFT and the CPU's FFT put one solve's field 4.6e-5 apart
# through the float32 spectral solve's low-k eigenvalues; 50 steps move
# positions (ulp 1.2e-4 cells near p = 1536) 2.4e-3 cells on the CPU
# between two FFT libraries (tests/test_torch_explicit.py)
TOL_POS_STEPS_LARGE_NG = 4e-3

# explicit slice: bench.py's two-stream cell (BASELINE configs[0])
NG_LARGE = 4096  # the push+deposit branch, ng > 1024
BRANCH_STEPS = 5
# |total energy change| over the 22 steps: the leapfrog's pre-push
# energies change by +1.5e-4 to +1.7e-4 over 22 steps on the CPU at
# n = 1e5, 1e6 and 4e6 (two seeds each); 6x room
EXPLICIT_ENERGY_BOUND = 1e-3
RESIDENT_N, RESIDENT_STEPS, RESIDENT_SPC = 10_000, 40_000, 2000
PER_STEP_STEPS = 2000

# the implicit engine's resident kernel: 25 steps in chunks of 8 against 25
# per-step steps and the plain version, in the two configurations of
# tests/test_pallas.py:450-453, held to that test's criteria (fe rtol
# 1e-4, ke 1e-5, positions 5e-3 cells, iterations equal but at a step whose
# residual sat at tol, see iters_agree) and the final v, e, e_prev and j to
# the card test's 1e-4 of the largest magnitude
IMPLICIT_RESIDENT_NS = (9001, 100_000, 131_072)
IMPLICIT_RESIDENT_STEPS, IMPLICIT_RESIDENT_SPC = 25, 8
IMPLICIT_RESIDENT_CONFIGS = {
    "field-none": dict(tol=1e-9, maxiter=50),
    "extrapolate-anderson": dict(tol=1e-30, maxiter=4,
                                 picard_init="extrapolate",
                                 picard_accel="anderson"),
}
TOL_RESIDENT_IMPLICIT = {"fe": 1e-4, "ke": 1e-5, "p": 5e-3, "v": 1e-4,
                         "e": 1e-4, "e_prev": 1e-4, "j": 1e-4}
# the configs[1] row's per-step comparison and the per-step path beside it
LANDAU_CHECK_STEPS = 25
LANDAU_PER_STEP_STEPS = 500
# the Landau damping rate (tests/test_engines.py:82-109): n = 400,000
# through the per-step path, held to 0.7-1.4; the same physics at
# n = 131,072 through run_resident, printed
LANDAU_RATE_N, LANDAU_RATE_RESIDENT_N, LANDAU_RATE_STEPS = 400_000, 131_072, 160
# implicit check: card against CPU over 50 steps at n = 20,000. Positions
# and velocities at the multi-step limits of the explicit check; fields,
# currents and energies at 1e-3, 10x the 3-step check's (summation order
# compounds over 50 steps)
IMPLICIT_CHECK_N, IMPLICIT_CHECK_STEPS = 20_000, 50
TOL_IMPLICIT_CHECK = {"p (cells)": 2e-3, "v": 1e-4, "e": 1e-3, "j": 1e-3,
                      "field_energy": 1e-3, "kinetic_energy": 1e-5}

# the card's published peaks (NVIDIA's H100 SXM data sheet, at its
# full 700 W): HBM3 bytes/s and float32 operations/s outside the tensor
# cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
# device-memory bytes per particle of one call: each particle input read
# once and each particle output written once (the (ng,) arrays are noise)
BYTES_PER_PARTICLE = {
    "picard_iteration": 16, "picard_finalize_nodep": 20, "deposit": 8,
    "gather": 8, "leapfrog_gather_push_deposit": 16, "explicit_cycle": 16,
    "explicit_cycle_resident": 16, "picard_finalize": 20,
    "picard_iteration_shared": 16, "implicit_resident": 16,
    "deposit2": 12, "boris_gather_push": 40, "source_batch": 16,
    # per row of the Newton system: rho read, phi written (the timed solve
    # starts cold, so no warm start is read; n0 and the counts are noise)
    "boltzmann_dirichlet": 8,
    # ps, p0, u0, qm, w, act read; xh, act1 (the pass) or x1, u1, act1
    # (the finalize) written
    "sheath_picard": 32, "sheath_finalize": 36,
    # p, u, vy, vz, act, sig read, p, u, vy, vz written (gamma 0)
    "sheath_reinject": 40,
    "deposit_det": 8,
    # per physical row of the D-N system: n and the warm start read, phi
    # written
    "boltzmann_dn": 12,
    # (ndraw, n) uniforms written: the flux draw's 8 a row
    "philox_uniforms": 32,
    # the slab kernels: ps, p0, v0, w read; ph (the pass) or p1, v1 (the
    # finalizes) written; the field and the statistics are noise
    "picard_iteration_ext": 20, "picard_finalize_ext_nodep": 24,
    "picard_finalize_ext": 24,
    # p, v read, p1, v1 written
    "leapfrog_gather_push": 16,
}
# float32 operations per particle and step, counted from the kernel bodies
# (floor, rint, add, sub, mul and compare count one; each atomic add one).
# implicit_resident: per Picard pass (the pass of picard_iteration); its
# finalize sweep adds RESIDENT_FINAL_OPS a particle and step
OPS_PER_PARTICLE = {
    "picard_iteration": 28, "picard_finalize_nodep": 16, "deposit": 7,
    "gather": 6, "leapfrog_gather_push_deposit": 22, "explicit_cycle": 22,
    "explicit_cycle_resident": 25, "picard_finalize": 24,
    "picard_iteration_shared": 40, "implicit_resident": 28,
    "deposit2": 13, "boris_gather_push": 55,
    # 32 float32 operations (transcendentals one each) and ~100 integer
    # ones (Philox's 10 rounds), all counted at the float32 rate
    "source_batch": 132,
    # per physical row and Newton iteration, what a tridiagonal Newton step
    # needs whatever its solver: the residual (scale, clamp 2, exp, the
    # 3-term Laplacian, 3 more) 10, the Jacobian's diagonal 2, a Thomas
    # solve 8 (elimination 5, back substitution 3), the clip 2, the
    # update 1 and the residual sum 2 (the kernel's PCR does ~125)
    "boltzmann_dirichlet": 25,
    # clip 2, the gather's cell and weights 6 and products 3, the push 8,
    # the midpoints 4, the wall tests 8 and selects 2, the deposit's cell,
    # weights and products 9 and its two atomics
    "sheath_picard": 44, "sheath_finalize": 44,
    # two Philox blocks (10 rounds of 2 high and 2 low products, 4 xors
    # and 2 key additions: 200), 8 uniforms (3 each), Box-Muller (2 logs,
    # 2 sqrts, 3 sines and cosines, 9 products: 16), 5 products and the
    # compares, all at the float32 rate
    "sheath_reinject": 250,
    # the deposit's 7 with plain adds in the place of the atomics
    "deposit_det": 7,
    # per physical row and Newton iteration, what a Thomas-solved
    # Sherman-Morrison Newton step needs: the residual 10 and the
    # Jacobian's diagonal 2 as in the D-D count, a Thomas solve with two
    # right-hand sides 12 (elimination 5 + 2, back substitution 3 + 2),
    # the rank-1 correction 2, the clip 2, the update 1 and the norm's sum
    # 2 (the kernel's two-column PCR does ~170)
    "boltzmann_dn": 31,
    # two Philox blocks a row (200 integer operations at the float32
    # rate) and 8 uniforms (3 each)
    "philox_uniforms": 224,
    # picard_iteration's 28 without the wrap (3), with the two clamps (4)
    # and the weight's product (1)
    "picard_iteration_ext": 30,
    # picard_finalize_nodep's 16 with the clamp (2), the offset (1) and
    # the statistics (2 products, 3 sums, 2 compares)
    "picard_finalize_ext_nodep": 26,
    # and the deposit of w v1 (clamp 2, cell and weights 4, product 3,
    # 2 atomics)
    "picard_finalize_ext": 37,
    # the gather 6, kick 1, two adds and a product, the wrap 3
    "leapfrog_gather_push": 13,
}
RESIDENT_FINAL_OPS = 19  # the finalize sweep (16) and the ke, jb sums (3)
REPLACES = {
    "picard_iteration": "pypic_tpu/ops/pallas_cic.py:1649",
    "picard_finalize_nodep": "pypic_tpu/ops/pallas_cic.py:1802",
    "deposit": "pypic_tpu/ops/pallas_cic.py:252",
    "gather": "pypic_tpu/ops/pallas_cic.py:798",
    "leapfrog_gather_push_deposit": "pypic_tpu/ops/pallas_cic.py:1167",
    "explicit_cycle": "pypic_tpu/ops/pallas_cic.py:1040",
    "explicit_cycle_resident": "pypic_tpu/ops/pallas_cic.py:1254",
    "picard_finalize": "pypic_tpu/ops/pallas_cic.py:1772",
    "picard_iteration_shared": "pypic_tpu/ops/pallas_cic.py:1693",
    "implicit_resident": "pypic_tpu/ops/pallas_cic.py:1437",
    "deposit2": "pypic_tpu/ops/pallas_cic.py:291",
    "boris_gather_push": "pypic_tpu/ops/pallas_cic.py:341",
    "boltzmann_dirichlet": "pypic_tpu/ops/pallas_newton.py:93",
    "source_batch": "pypic_tpu/ops/pallas_rng.py:122",
    "sheath_picard": "pypic_tpu/ops/pallas_cic.py:637",
    "sheath_finalize": "pypic_tpu/ops/pallas_cic.py:660",
    "sheath_reinject": "pypic_tpu/ops/pallas_rng.py:74",
    "deposit_det": "pypic_tpu/ops/pallas_cic.py:252",
    "boltzmann_dn": "pypic_tpu/ops/pallas_newton.py:213 boltzmann_dn_pallas",
    "picard_iteration_ext": "pypic_tpu/ops/pallas_cic.py:1847",
    "picard_finalize_ext": "pypic_tpu/ops/pallas_cic.py:1987",
    "picard_finalize_ext_nodep": "pypic_tpu/ops/pallas_cic.py:2019",
    "leapfrog_gather_push": "pypic_tpu/ops/pallas_cic.py:849",
}
SOURCES_MAGNETIZED = {
    "deposit2": "pypic_tpu_torch/csrc/magnetized.cu",
    "boris_gather_push": "pypic_tpu_torch/csrc/magnetized.cu",
    "boltzmann_dirichlet": "pypic_tpu_torch/csrc/newton.cu",
    "source_batch": "pypic_tpu_torch/csrc/rng.cu",
}
SOURCES_SHEATH = {
    "sheath_picard": "pypic_tpu_torch/csrc/sheath.cu",
    "sheath_finalize": "pypic_tpu_torch/csrc/sheath.cu",
    "sheath_reinject": "pypic_tpu_torch/csrc/rng.cu",
    "deposit_det": "pypic_tpu_torch/csrc/cic.cu",
}

# the magnetized slice: bench.py's configs[3] row (tools/magnetized.py)
N_MAG, N_MAG_RAGGED, NG_MAG = 999_996, 1_000_003, 600
# the Newton kernel against its plain version (tests/test_pallas.py:315-342):
# counts within one (tol 1e-9 sits at the float32 floor), phi within 3e-5
# of max|phi|; warm from the plain answer, equal counts
TOL_NEWTON_PHI = 3e-5
# the source batch against its plain version: libdevice's logf/sinf/cosf
# against the CPU's, a few float32 ulps (x: of the wrap length)
TOL_SOURCE = 1e-6
# magnetized check: n = 12,000 (fused on the card), one step from the
# states after these steps, tests/test_magnetized.py:461-489's limits
# (rtol, atol): rho, phi, active positions, active velocities
MAG_CHECK_PER_SPECIES = 2000
MAG_CHECK_AT = (0, 10, 50)
TOL_MAG_STEP = {"rho": (1e-4, 0.0), "phi": (1e-3, 1e-8), "p": (2e-5, 1e-5),
                "v": (2e-4, 1.0)}
MAG_CHECK_STEPS = 200
MAG_PHI_MAX_RTOL = 0.05  # tests/test_magnetized.py:221-230
MAG_COMPOSED_STEPS = 20

# the sheath slice: bench.py's configs[2] row (tools/sheath.py)
N_SHEATH, N_SHEATH_RAGGED, NG_SHEATH = 1_000_000, 1_000_003, 51
SHEATH_DT, SHEATH_DX = 1e-12, 1e-5
# sheath check: sheath_dd at n = 12,000 with the exit histograms recording
# from step 0; one step from the states after these steps on the card and
# on the CPU at the single-step limits of tests/test_torch_sheath.py
# (positions in cells; u of the largest; e, j and phi of their largest)
SHEATH_CHECK_N, SHEATH_CHECK_AT, SHEATH_CHECK_STEPS = 12_000, (0, 10, 50), 200
TOL_SHEATH_STEP = {"p (cells)": 1e-5, "u": 1e-6, "e": 1e-5, "j": 1e-5,
                   "phi": 1e-5}
# the 200-step runs' phi averaged over the last 100 steps, card against
# CPU, in Te/e: the same draws, trajectories parted by round-off (3.3e-7
# and 9.0e-7 Te/e on the H100; the two CPU backends part by 3.8e-7), about
# 100x room. A 1% error in the whole current reads 2.2e-2 here; one in the
# wall charge alone reads 4.1e-7, below this limit and below one step's
# (tests/test_torch_sheath.py test_sheath_checks_see_a_one_percent_fault):
# phase 16's wall-charge-only pass holds the wall charge
TOL_SHEATH_PHI_AVG = 1e-4
# the 200-step runs' Picard means, card against CPU (a floor exit is a
# round-off decision, so single steps part by a pass or two: 3.270 and
# 3.375 on the H100, 37 steps one pass apart and one two)
SHEATH_PICARD_MEAN_RTOL = 0.1
# tests/test_sheath.py:41-57's wall-potential test at its own setting
SHEATH_WALL_N, SHEATH_WALL_STEPS = 10_000, 1500
SHEATH_COMPOSED_STEPS = 20

# the D-N slice: dirichlet_neumann_test at its own scale (tools/magnetized.py
# --row dn), and the GC slice: pic_iead_gc at the configs[3] row's size
NG_DN = 800
# the D-N Newton kernel against its plain version and the op-composed
# Thomas route (tests/test_pallas.py:361-389): iterations within one cold
# and equal warm, phi within 5e-4 of max|phi|
TOL_DN_PHI = 5e-4
DN_CASES = (800, 600, 257)
# D-N check: dirichlet_neumann_test at n = 12,000; one step from the states
# after these steps (TOL_MAG_STEP's limits), then DN_CHECK_STEPS steps on
# each side: the flux cap, n0's and phi_max's means over the last 100
# steps within 5% card against CPU (the same draws; trajectories part by
# round-off)
DN_CHECK_N, DN_CHECK_AT, DN_CHECK_STEPS = 12_000, (0, 10, 50), 200
DN_MEAN_RTOL = 0.05
# GC check: pic_iead_gc at n = 12,000, one step from the states after these
# steps, card against CPU, the same source and gyro-phase draws
GC_CHECK_PER_SPECIES, GC_CHECK_AT = 2000, (0, 10, 50)
# fault-1 repair: a magnetized step at ng = 1200, above the Newton
# kernels' 1,024 rows, takes the Thomas route on the card
NG_FAULT = 1200

# the domain slice: bench.py's configs[4] row (tools/domain.py) on a
# one-rank mesh: ng 200 in one slab of c = 200 cells, halo 13 (8 sigma of
# the thermal excursion), hw = halo + 2, ext_n = c + 2 hw + 1. The kernels
# run at that slab's shape; their positions lie past both clamp bounds,
# 5% of the slots are dead, and the finalizes wrap with the offset of a
# middle rank (rank 1 of 4 slabs of 200 cells: lo_shift = c - hw,
# ng = 800)
DOM_C, DOM_HALO = 200, 13
DOM_HW = DOM_HALO + 2
DOM_EXT_N = DOM_C + 2 * DOM_HW + 1
DOM_LO, DOM_HI = float(DOM_HW - DOM_HALO), float(DOM_C + DOM_HALO + DOM_HW)
DOM_LO_SHIFT, DOM_NG_WRAP = float(DOM_C - DOM_HW), 4 * DOM_C
# kernel against plain: the same float32 operations, so positions and
# velocities to 1e-6 of their largest value; the statistics to 1e-6
# relative (both sum float32 terms in float64, in other orders), the
# clamp counts exact
TOL_DOM = 1e-6
# the domain check: n = 20,000, card against CPU on one rank (5 steps)
# and two ranks (gloo; on the card staged through the host): the energies
# within 1e-5 (the engine tolerances of tests/test_torch_domain_implicit.py),
# the counts equal
DOM_CHECK_N, DOM_CHECK_STEPS = 20_000, 5
TOL_DOM_CHECK = 1e-5
# the domain slice's paths: configs[4] 2 + 30 steps, the other finalizes
# and the shared window 2 + 3, the explicit carrier 2 + 5
DOM_TIMED, DOM_BRANCH, DOM_EXPLICIT = 30, 3, 5
# |total energy change| of the conserving configuration over the timed
# steps, as the implicit slice holds it
DOM_ENERGY_BOUND = 1e-4
# the explicit carrier's total energy change over its timed steps is the
# leapfrog scheme's, not a fault (tests/test_torch_domain_implicit.py
# holds the plain version to JAX's rows on this row); the card's at
# n = 1e8 is held to the mean of the plain version's on the CPU at
# DOM_RISE_N over loads from DOM_RISE_SEEDS: 5% relative, a few times the
# spread between those loads, which the phase prints
DOM_RISE_N, DOM_RISE_SEEDS, TOL_DOM_RISE = 2_000_000, (1, 2, 3), 0.05


def bound(name: str, n: int, steps: int = 1,
          passes: int | None = None) -> tuple[float, str]:
    """The least time in ms the card could take for one call on n
    particles (``steps`` cycles for the resident kernels; for
    implicit_resident, ``passes`` Picard passes in all, as its rows
    report; for boltzmann_dirichlet, n rows of the Newton system and
    ``steps`` the Newton iterations the kernel reports): the larger of the
    bytes over the memory rate and the operations over the float32
    rate."""
    by_bytes = BYTES_PER_PARTICLE[name] * n / PEAK_BYTES_PER_S * 1e3
    ops = OPS_PER_PARTICLE[name] * n * (steps if passes is None else passes)
    if name == "implicit_resident":
        ops += RESIDENT_FINAL_OPS * n * steps
    by_ops = ops / PEAK_F32_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def deposit_tol(n: int, ng: int = NG) -> float:
    """Relative tolerance of the kernel's deposit against the float32 plain
    version, which sums in another order.

    The plain ``index_add_`` adds every term to one node in a global float
    atomic, so its own round-off grows like u * sqrt(2n/ng) (u = 2^-24,
    ~2n/ng terms a node). 8x that, and never below the 2e-5 of the CPU
    tests. The tight check is the one against float64 (TOL_DEP).
    """
    return max(2e-5, 8.0 * 2.0**-24 * math.sqrt(2.0 * n / ng))


def _rec(err: float, ms: float, plain_ms: float, name: str, n: int,
         steps: int = 1, passes: int | None = None) -> dict:
    b, by = bound(name, n, steps, passes)
    log(f"[kernels]   {name} {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{b:.4f} ms ({by}) at n = {n}" + (f", {steps} steps" if steps > 1 else "")
        + (f", {passes} Picard passes" if passes is not None else ""))
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b,
                bound_by=by, n=n)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 10, calls: int = 10) -> float:
    """Device time of one call of fn in ms, after a warm-up: the median of
    ``reps`` rounds, each ``calls`` back-to-back calls between two CUDA
    events. Back-to-back calls keep the card's queue ahead of the host,
    so the wrapper's Python overhead does not count where the kernel
    outlasts it."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def device_ms(fn, calls: int = 20, tries: int = 3) -> float:
    """Device time of one call of fn in ms: the kernels (and memsets) it
    launches, summed from a torch.profiler trace of ``calls`` calls after
    a warm-up, over the calls. For calls whose kernels are shorter than
    the wrapper's Python overhead, where ``cuda_ms`` would time the host.

    The CUDA trace now and then comes back empty. Such a trace is taken
    again up to ``tries`` times; after that the call is timed by
    ``queued_ms``, which the log line names."""
    import os
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        dur = sum(e["dur"] for e in events if e.get("ph") == "X"
                  and e.get("cat") in ("kernel", "gpu_memset", "gpu_memcpy"))
        if dur > 0:
            return dur / 1e3 / calls
    ms = queued_ms(fn, calls)
    log(f"[timing] the profiler saw no device activity in {tries} traces: "
        f"{ms:.4f} ms a call from CUDA events behind a queued sleep")
    return ms


def queued_ms(fn, calls: int = 20, reps: int = 5) -> float:
    """Device time of one call of fn in ms from CUDA events, with the
    host's launch overhead kept out: a sleep kernel holds the stream while
    the host queues ``calls`` calls between the two events, so the card
    runs them back to back. The median of ``reps`` rounds. A call that
    reads the host drains the queue, and its host time then counts."""
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


def seam_err(a: torch.Tensor, b: torch.Tensor, ng: int) -> float:
    """Largest position gap in cells, a pair on either side of the periodic
    seam counted by its short way round."""
    d = (a.double() - b.double()).abs()
    return float(torch.minimum(d, ng - d).max())


def rel_err(ref: torch.Tensor, got: torch.Tensor) -> tuple[float, float]:
    d = float((ref.double() - got.double()).abs().max())
    return d, d / max(float(ref.double().abs().max()), 1e-300)


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: chip_smoke.py drives the "
                           "port on an NVIDIA GPU and has no CPU path")
    name = torch.cuda.get_device_name(0)
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"devices {torch.cuda.device_count()} ({name})")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    log(smi.stdout.strip().splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return name


def phase_build() -> None:
    from pypic_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _, info = _build.load()
    log(f"[build] {info.path.name} built in {info.seconds:.2f} s "
        f"(load {time.perf_counter() - t0:.2f} s)")
    for line in info.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"[build] {line.strip()}")


def _random_pass_inputs(n: int, gen: torch.Generator, dev, edges: bool,
                        ng: int = NG):
    f32 = torch.float32
    p0 = torch.rand(n, generator=gen, device=dev, dtype=f32) * ng
    ps = torch.rand(n, generator=gen, device=dev, dtype=f32) * ng
    v0 = torch.randn(n, generator=gen, device=dev, dtype=f32) * 1e5
    e = torch.randn(ng, generator=gen, device=dev, dtype=f32) * 1e3
    if edges:
        edge = torch.tensor([0.0, ng - 1e-4, float(ng)], dtype=f32, device=dev)
        p0[:3] = edge
        ps[:3] = edge
        ps[3:6] = edge
        v0[:3] = 0.0
    return e, ps, p0, v0


def _check(errors: dict, name: str) -> float:
    bad = {k: v for k, v in errors.items() if not v["err"] <= v["tol"]}
    for k, v in errors.items():
        log(f"[kernels]   {name}.{k}: err {v['err']:.3e} ({v['kind']}) "
            f"tol {v['tol']:.1e}")
    if bad:
        raise AssertionError(f"{name} disagrees with its reference: {bad}")
    return max(v["abs"] for v in errors.values())


def phase_kernels(dev) -> dict:
    """Kernels against plain versions at a ragged n and at the headline
    n; returns the records of the headline n (the last one)."""
    from pypic_tpu_torch.ops import cuda_cic as K

    gen = torch.Generator(device=dev).manual_seed(7)
    records = {}
    for n, edges in ((N_RAGGED, True), (N_HEADLINE, False)):
        log(f"[kernels] n = {n}, ng = {NG}" + (" (+ edge positions)" if edges else ""))
        e, ps, p0, v0 = _random_pass_inputs(n, gen, dev, edges)
        kw = dict(qm=QM, w=W, dt=DT, dx=DX)
        dtol = deposit_tol(n)

        # jh is held against a float64 deposit of the plain version's own
        # (ph, w vh), and against the plain float32 jh at the atomics-order
        # bound
        ph_ref, v1_ref, _ = K.picard_iteration_plain(e, ps, p0, v0, NG,
                                                     emit_v=True, **kw)
        w32 = K.kernel_scalars(QM, DT, DX, W)[3]
        jh64 = K.deposit_plain(ph_ref.double(),
                               (w32 * (0.5 * (v0 + v1_ref))).double(), NG,
                               periodic=True)
        del ph_ref, v1_ref
        err = 0.0
        for emit_v in (False, True):
            got = K.picard_iteration(e, ps, p0, v0, NG, emit_v=emit_v, **kw)
            ref = K.picard_iteration_plain(e, ps, p0, v0, NG, emit_v=emit_v, **kw)
            torch.cuda.synchronize()
            errs = {"ph": dict(abs=seam_err(ref[0], got[0], NG), kind="cells",
                               tol=TOL_POS)}
            errs["ph"]["err"] = errs["ph"]["abs"]
            a, r = rel_err(jh64, got[-1])
            errs["jh"] = dict(abs=a, err=r, kind="rel vs float64", tol=TOL_DEP)
            a, r = rel_err(ref[-1], got[-1])
            errs["jh_plain"] = dict(abs=a, err=r, kind="rel", tol=dtol)
            if emit_v:
                a, r = rel_err(ref[1], got[1])
                errs["v1"] = dict(abs=a, err=r, kind="rel", tol=TOL_V)
            err = max(err, _check(errs, f"picard_iteration(emit_v={emit_v})"))
        records["picard_iteration"] = _rec(
            err, cuda_ms(lambda: K.picard_iteration(e, ps, p0, v0, NG, **kw)),
            cuda_ms(lambda: K.picard_iteration_plain(e, ps, p0, v0, NG, **kw)),
            "picard_iteration", n)

        fkw = dict(qm=QM, dt=DT, dx=DX)
        got = K.picard_finalize_nodep(e, ps, p0, v0, NG, **fkw)
        ref = K.picard_finalize_nodep_plain(e, ps, p0, v0, NG, **fkw)
        torch.cuda.synchronize()
        a, r = rel_err(ref[1], got[1])
        p_err = seam_err(ref[0], got[0], NG)
        err = _check({"p1": dict(abs=p_err, err=p_err, kind="cells", tol=TOL_POS),
                      "v1": dict(abs=a, err=r, kind="rel", tol=TOL_V)},
                     "picard_finalize_nodep")
        records["picard_finalize_nodep"] = _rec(
            err, cuda_ms(lambda: K.picard_finalize_nodep(e, ps, p0, v0, NG, **fkw)),
            cuda_ms(lambda: K.picard_finalize_nodep_plain(e, ps, p0, v0, NG, **fkw)),
            "picard_finalize_nodep", n)

        vals = v0 * W
        worst = 0.0
        for periodic in (True, False):
            pos = p0 if periodic else p0 * ((NG - 1) / NG)
            got = K.deposit(pos, vals, NG, periodic=periodic)
            ref = K.deposit_plain(pos, vals, NG, periodic=periodic)
            f64 = K.deposit_plain(pos.double(), vals.double(), NG, periodic=periodic)
            torch.cuda.synchronize()
            a, r = rel_err(f64, got)
            errs = {"out": dict(abs=a, err=r, kind="rel vs float64", tol=TOL_DEP)}
            a, r = rel_err(ref, got)
            errs["out_plain"] = dict(abs=a, err=r, kind="rel", tol=dtol)
            log(f"[kernels]   deposit(periodic={periodic}): plain vs float64 "
                f"{rel_err(f64, ref)[1]:.3e} (rel)")
            worst = max(worst, _check(errs, f"deposit(periodic={periodic})"))
        records["deposit"] = _rec(
            worst, cuda_ms(lambda: K.deposit(p0, vals, NG, periodic=True)),
            cuda_ms(lambda: K.deposit_plain(p0, vals, NG, periodic=True)),
            "deposit", n)
        del e, ps, p0, v0, vals, got, ref, f64, jh64
        torch.cuda.empty_cache()
    return records


def phase_check(dev) -> None:
    """Small-input agreement: the card's kernels against the plain
    versions on the CPU, through the whole slice (tolerances of
    tests/test_torch_implicit.py)."""
    from pypic_tpu_torch import initialize
    from pypic_tpu_torch.constants import E_CHARGE, M_ELECTRON
    from pypic_tpu_torch.engines import implicit
    from pypic_tpu_torch.runner import run

    n = 20_000
    cfg = headline_config(n)
    x, v, _ = initialize.initialize_periodic(
        "landau-damping", n, 1e5, 1, 0.8, cfg.grid, 100.0 * 11600.0,
        0.1 * 11600.0, seed=1)
    out = []
    for device in ("cpu", dev):
        st = implicit.init_state(x, v, -E_CHARGE, M_ELECTRON, cfg, device=device)
        e0 = st.e.cpu()
        st, m = run(implicit.make_step(cfg), st, 3)
        out.append((e0, st, m))
    (e0c, sc, mc), (e0g, sg, mg) = out
    checks = {
        "e0": (rel_err(e0c, e0g)[1], 5e-5),
        "p (cells)": (seam_err(sc.p, sg.p.cpu(), NG), 2e-4),
        "v": (rel_err(sc.v, sg.v.cpu())[1], 1e-5),
        "e": (rel_err(sc.e, sg.e.cpu())[1], 1e-4),
        "j": (rel_err(sc.j, sg.j.cpu())[1], 1e-4),
        "field_energy": (rel_err(mc.field_energy, mg.field_energy.cpu())[1], 1e-5),
        "kinetic_energy": (rel_err(mc.kinetic_energy, mg.kinetic_energy.cpu())[1], 1e-5),
    }
    for k, (err, tol) in checks.items():
        log(f"[check] n = {n}, 3 steps, GPU vs CPU {k}: {err:.3e} (tol {tol:.0e})")
    bad = {k: v for k, v in checks.items() if not v[0] <= v[1]}
    if bad or not torch.equal(mc.picard_iters, mg.picard_iters.cpu()):
        raise AssertionError(f"GPU slice disagrees with the CPU slice: {bad}, "
                             f"iters {mc.picard_iters} vs {mg.picard_iters}")


def phase_slice(dev) -> dict:
    from pypic_tpu_torch.ops import cuda_cic
    from pypic_tpu_torch.runner import run

    n = N_HEADLINE
    torch.cuda.reset_peak_memory_stats()
    cuda_cic.reset_launch_counts()
    t0 = time.perf_counter()
    _, step, state = headline_state(n, dev)
    state, warm = run(step, state, WARMUP_STEPS)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    state, m = run(step, state, TIMED_STEPS)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = dict(cuda_cic.LAUNCHES)

    steps = WARMUP_STEPS + TIMED_STEPS
    fe = torch.cat([warm.field_energy, m.field_energy]).double().cpu()
    ke = torch.cat([warm.kinetic_energy, m.kinetic_energy]).double().cpu()
    iters = torch.cat([warm.picard_iters, m.picard_iters]).cpu()
    tot = fe + ke
    ms_step = (t2 - t1) * 1e3 / TIMED_STEPS
    res = dict(
        n=n, steps=TIMED_STEPS, ms_per_step=ms_step,
        pushes_per_s=n * TIMED_STEPS / (t2 - t1),
        setup_s=t1 - t0, picard_mean=float(iters.float().mean()),
        field_energy_rel_change=float((fe[-1] - fe[0]) / fe[0]),
        total_energy_rel_change=float((tot[-1] - tot[0]) / tot[0]),
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
        launches=launches,
    )
    log(f"[slice] n = {n}, ng = {NG}, conserving config, {TIMED_STEPS} timed steps "
        f"after init_state + {WARMUP_STEPS} warm-up")
    log(f"[slice] {ms_step:.4f} ms/step, {res['pushes_per_s']:.4e} pushes/s, "
        f"picard mean {res['picard_mean']:.2f}, setup {res['setup_s']:.2f} s, "
        f"peak memory {res['peak_mem_gib']:.2f} GiB")
    log(f"[slice] field energy change {res['field_energy_rel_change']:+.4e}, "
        f"total energy change {res['total_energy_rel_change']:+.4e} over {steps} steps")
    log(f"[slice] launches {launches}")

    finite = all(bool(torch.isfinite(t).all()) for t in
                 (state.p, state.v, state.e, state.j, fe, ke))
    in_range = bool(((state.p >= 0) & (state.p <= NG)).all())
    shapes = (state.p.shape == (n,) and state.v.shape == (n,)
              and state.e.shape == (NG,) and m.field_energy.shape == (TIMED_STEPS,))
    want = {k: 0 for k in launches}
    want.update(picard_iteration=4 * steps, picard_finalize_nodep=steps,
                deposit=2)
    problems = []
    if not (finite and in_range and shapes):
        problems.append(f"finite={finite} in_range={in_range} shapes={shapes}")
    if not bool((iters == 4).all()):
        problems.append(f"picard_iters {iters.tolist()}")
    if launches != want:
        problems.append(f"launches {launches} != {want}")
    if not abs(res["total_energy_rel_change"]) < 1e-4:
        problems.append(f"total energy change {res['total_energy_rel_change']}")
    if problems:
        raise AssertionError("slice failed: " + "; ".join(problems))
    return res


def _lf_errors(ref, got, ng: int, w32: float, n: int):
    """Errors of a push+deposit result (p1, v1, rho1, ...) against the
    plain version's, rho1 also against a float64 deposit."""
    from pypic_tpu_torch.ops import cuda_cic as K

    a = seam_err(ref[0], got[0], ng)
    errs = {"p1": dict(abs=a, err=a, kind="cells", tol=TOL_POS)}
    a, r = rel_err(ref[1], got[1])
    errs["v1"] = dict(abs=a, err=r, kind="rel", tol=TOL_V)
    rho64 = K.deposit_plain(ref[0].double(),
                            torch.full_like(ref[0], w32, dtype=torch.float64),
                            ng, periodic=True)
    a, r = rel_err(rho64, got[2])
    errs["rho1"] = dict(abs=a, err=r, kind="rel vs float64", tol=TOL_DEP)
    a, r = rel_err(ref[2], got[2])
    errs["rho1_plain"] = dict(abs=a, err=r, kind="rel", tol=deposit_tol(n, ng))
    return errs


def _row_errors(ref_rows, got_rows, steps: int) -> dict:
    """Errors of the first ``steps`` fe/ke/jb rows against a reference's."""
    errs = {}
    for k, r_, g_ in zip(("fe", "ke", "jb"), ref_rows, got_rows):
        a, r = rel_err(r_[:steps], g_[:steps])
        errs[k] = dict(abs=a, err=r, kind="rel", tol=TOL_RESIDENT[k])
    return errs


def _resident_case(dev, n: int) -> float:
    """37 resident steps in chunks of 16 against 37 one-kernel cycles and
    the plain resident version, on a two-stream load at ng = 200."""
    from pypic_tpu_torch.engines import explicit
    from pypic_tpu_torch.ops import cuda_cic as K
    from pypic_tpu_torch.runner import run
    from pypic_tpu_torch.tools import two_stream

    steps = RESIDENT_CHECK_STEPS
    cfg, _, st = two_stream.state(n, dev)
    res, rm = explicit.run_resident(cfg, st, steps, steps_per_call=16)
    cyc, cm = run(explicit.make_step(cfg), st, steps)
    plain = K.explicit_cycle_resident_plain(
        st.e, st.p, st.v, NG, steps, **explicit.resident_kwargs(st, cfg))
    torch.cuda.synchronize()
    got_rows = (rm.field_energy, rm.kinetic_energy, rm.current_bias)
    worst = 0.0
    for label, ref, rows in (("cycle", (cyc.p, cyc.v, cyc.rho, cyc.e),
                              (cm.field_energy, cm.kinetic_energy, cm.current_bias)),
                             ("plain", plain[:4], plain[4:])):
        a = seam_err(ref[0], res.p, NG)
        errs = {"p": dict(abs=a, err=a, kind="cells", tol=TOL_POS_STEPS)}
        for k, r_, g_ in (("v", ref[1], res.v), ("rho", ref[2], res.rho),
                          ("e", ref[3], res.e)):
            a, r = rel_err(r_, g_)
            errs[k] = dict(abs=a, err=r, kind="rel", tol=TOL_RESIDENT[k])
        errs.update(_row_errors(rows, got_rows, steps))
        worst = max(worst, _check(errs, f"explicit_cycle_resident(n={n}) vs {label}"))
    return worst


def _first_parting_row(ref, got, rel: float) -> int:
    """Index of the first row at which got leaves ref by more than ``rel``
    of the row's own magnitude (the row count if none does)."""
    d = (ref.double() - got.double()).abs() > rel * ref.double().abs()
    return int(d.nonzero()[0, 0]) if bool(d.any()) else int(ref.shape[0])


def _gather_library(e, p, periodic: bool):
    """The gather as one PyTorch call, for the yardstick only: bilinear
    ``grid_sample`` with align_corners=True on a (1, 1, 1, W) field is the
    CIC gather on nodes 0..W-1; the periodic gather samples the field
    extended by node 0. Returns the call on prepared inputs."""
    import torch.nn.functional as F

    f = torch.cat([e, e[:1]]) if periodic else e
    w = f.shape[0]
    grid = torch.stack([p * (2.0 / (w - 1)) - 1.0, torch.zeros_like(p)], -1)
    grid = grid.view(1, 1, -1, 2)
    f = f.view(1, 1, 1, w)
    return lambda: F.grid_sample(f, grid, mode="bilinear", padding_mode="border",
                                 align_corners=True).view(-1)


def phase_explicit_kernels(dev) -> dict:
    """The explicit engine's kernels against their plain versions; returns
    the records at the headline n (the resident kernel at its row's n)."""
    from pypic_tpu_torch.ops import cuda_cic as K

    gen = torch.Generator(device=dev).manual_seed(11)
    records = {}
    kw = dict(qm=QM, w=W, dt=DT, dx=DX)
    w32 = K.leapfrog_scalars(QM, DT, DX, W)[2]
    fast = dict(reps=3, calls=3)  # the plain versions take ~0.1 s a call
    for n, edges in ((N_RAGGED, True), (N_HEADLINE, False)):
        log(f"[kernels] explicit, n = {n}" + (" (+ edge positions)" if edges else ""))
        e, _, p0, v0 = _random_pass_inputs(n, gen, dev, edges)
        worst = 0.0
        for periodic in (True, False):
            pos = p0 if periodic else p0 * ((NG - 1) / NG)
            got = K.gather(e, pos, periodic=periodic)
            ref = K.gather_plain(e, pos, periodic=periodic)
            torch.cuda.synchronize()
            a, r = rel_err(ref, got)
            worst = max(worst, _check({"out": dict(abs=a, err=r, kind="rel", tol=2e-5)},
                                      f"gather(periodic={periodic})"))
        records["gather"] = _rec(
            worst, cuda_ms(lambda: K.gather(e, p0, periodic=True)),
            cuda_ms(lambda: K.gather_plain(e, p0, periodic=True), **fast),
            "gather", n)
        library = _gather_library(e, p0, periodic=True)
        a, r = rel_err(K.gather(e, p0, periodic=True), library())
        _check({"out": dict(abs=a, err=r, kind="rel", tol=TOL_LIBRARY_GATHER)},
               "gather vs grid_sample (library yardstick)")
        records["gather"]["library_ms"] = cuda_ms(library)
        log(f"[kernels]   gather: library call grid_sample "
            f"{records['gather']['library_ms']:.4f} ms")
        del got, ref, library

        worst = 0.0
        for ng in (NG, NG_LARGE):
            el, _, pl, vl = ((e, None, p0, v0) if ng == NG else
                             _random_pass_inputs(n, gen, dev, edges, ng))
            got = K.leapfrog_gather_push_deposit(el, pl, vl, **kw)
            ref = K.leapfrog_gather_push_deposit_plain(el, pl, vl, **kw)
            torch.cuda.synchronize()
            worst = max(worst, _check(_lf_errors(ref, got, ng, w32, n),
                                      f"leapfrog_gather_push_deposit(ng={ng})"))
            del got, ref
        records["leapfrog_gather_push_deposit"] = _rec(
            worst, cuda_ms(lambda: K.leapfrog_gather_push_deposit(el, pl, vl, **kw)),
            cuda_ms(lambda: K.leapfrog_gather_push_deposit_plain(el, pl, vl, **kw), **fast),
            "leapfrog_gather_push_deposit", n)
        del el, pl, vl

        worst = 0.0
        for ng in (NG, 1024):
            el, _, pl, vl = ((e, None, p0, v0) if ng == NG else
                             _random_pass_inputs(n, gen, dev, edges, ng))
            got = K.explicit_cycle(el, pl, vl, ng, **kw)
            ref = K.explicit_cycle_plain(el, pl, vl, ng, **kw)
            torch.cuda.synchronize()
            errs = _lf_errors(ref, got, ng, w32, n)
            e64 = -fd.grad_periodic(
                poisson.solve_periodic_neutralized(got[2].double(), DX), DX)
            a, r = rel_err(e64, got[3])
            errs["e1"] = dict(abs=a, err=r, kind="rel vs float64 FFT solve", tol=TOL_SOLVE)
            a, r = rel_err(ref[3], got[3])
            errs["e1_plain"] = dict(abs=a, err=r, kind="rel", tol=deposit_tol(n, ng))
            worst = max(worst, _check(errs, f"explicit_cycle(ng={ng})"))
            del got, ref, el, pl, vl
        records["explicit_cycle"] = _rec(
            worst, cuda_ms(lambda: K.explicit_cycle(e, p0, v0, NG, **kw)),
            cuda_ms(lambda: K.explicit_cycle_plain(e, p0, v0, NG, **kw), **fast),
            "explicit_cycle", n)
        del e, p0, v0
        torch.cuda.empty_cache()

    worst = max(_resident_case(dev, n) for n in (4097, RESIDENT_N, 32768))
    # one launch at the resident row's shape (n = 10,000, 2,000 steps)
    # against the plain version, then timed. Two-stream grows from noise,
    # so the two part after the linear phase: the first 37 rows are held
    # at the limits above, and the row where fe first parts by 1e-4 is
    # reported.
    from pypic_tpu_torch.engines import explicit
    from pypic_tpu_torch.tools import two_stream

    cfg, _, st = two_stream.state(RESIDENT_N, dev)
    rkw = explicit.resident_kwargs(st, cfg)
    args = (st.e, st.p, st.v, NG, RESIDENT_SPC)
    got = K.explicit_cycle_resident(*args, **rkw)
    ref = K.explicit_cycle_resident_plain(*args, **rkw)
    torch.cuda.synchronize()
    label = f"explicit_cycle_resident(n={RESIDENT_N}, one {RESIDENT_SPC}-step launch) vs plain"
    worst = max(worst, _check(_row_errors(ref[4:], got[4:], RESIDENT_CHECK_STEPS), label))
    log(f"[kernels]   {label}: fe rows agree to 1e-4 through row "
        f"{_first_parting_row(ref[4], got[4], 1e-4)} of {RESIDENT_SPC}")
    if not all(bool(torch.isfinite(t).all()) for t in got):
        raise AssertionError(f"{label}: non-finite output")
    del got, ref
    records["explicit_cycle_resident"] = _rec(
        worst, cuda_ms(lambda: K.explicit_cycle_resident(*args, **rkw), reps=5, calls=1),
        cuda_ms(lambda: K.explicit_cycle_resident_plain(*args, **rkw), reps=1, calls=1),
        "explicit_cycle_resident", RESIDENT_N, RESIDENT_SPC)
    return records


def phase_explicit_check(dev) -> None:
    """The explicit engine on the card against the CPU (plain versions):
    50 steps of a two-stream load, tolerances of the engine tests."""
    from pypic_tpu_torch import initialize
    from pypic_tpu_torch.constants import E_CHARGE, M_ELECTRON
    from pypic_tpu_torch.engines import explicit
    from pypic_tpu_torch.runner import run
    from pypic_tpu_torch.tools import two_stream

    n, steps = 20_000, 50
    for ng, per_particle in ((64, False), (1536, False), (64, True)):
        cfg, _ = two_stream.config(n, ng)
        x, v, _ = initialize.initialize_periodic(
            "two-stream", n, two_stream.DENSITY, 1, two_stream.PERTURBATION,
            cfg.grid, two_stream.TE, two_stream.TE, seed=2)
        q = torch.full((n,), -E_CHARGE, dtype=torch.float64) if per_particle else -E_CHARGE
        m = torch.full((n,), M_ELECTRON, dtype=torch.float64) if per_particle else M_ELECTRON
        out = []
        for device in ("cpu", dev):
            qd = q.to(device) if per_particle else q
            md = m.to(device) if per_particle else m
            st = explicit.init_state(x, v, qd, md, cfg, device=device)
            out.append(run(explicit.make_step(cfg), st, steps))
        (sc, mc), (sg, mg) = out
        ptol = TOL_POS_STEPS if ng <= 1024 else TOL_POS_STEPS_LARGE_NG
        checks = {
            "p (cells)": (seam_err(sc.p, sg.p.cpu(), ng), ptol),
            "v": (rel_err(sc.v, sg.v.cpu())[1], TOL_V),
            "field_energy": (rel_err(mc.field_energy, mg.field_energy.cpu())[1], 1e-3),
            "kinetic_energy": (rel_err(mc.kinetic_energy, mg.kinetic_energy.cpu())[1], 1e-5),
        }
        label = f"ng = {ng}" + (", per-particle q/m" if per_particle else "")
        for k, (err, tol) in checks.items():
            log(f"[explicit check] {label}, {steps} steps, GPU vs CPU {k}: "
                f"{err:.3e} (tol {tol:.0e})")
        bad = {k: v for k, v in checks.items() if not v[0] <= v[1]}
        if bad:
            raise AssertionError(f"explicit engine, {label}: GPU and CPU "
                                 f"disagree: {bad}")


def _drive(label: str, build, warm: int, timed: int, want: dict,
           engine=None, tag: str = "explicit slice", check=None) -> dict:
    """Run one path of an engine (the explicit one by default) with the
    launch counts set to 0 just before it and read just after; check finite
    values in range, the launches and what ``check(state, metrics)``
    reports (a list of problems)."""
    from pypic_tpu_torch.engines import explicit
    from pypic_tpu_torch.ops import cuda_cic
    from pypic_tpu_torch.runner import run

    engine = engine or explicit
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_cic.reset_launch_counts()
    t0 = time.perf_counter()
    cfg, st = build()
    step = engine.make_step(cfg)
    st, wm = run(step, st, warm)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    st, m = run(step, st, timed)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = dict(cuda_cic.LAUNCHES)
    want = {k: want.get(k, 0) for k in launches}
    n, ng = st.p.shape[0], cfg.grid.ng
    # pre-push energies of every step: the change over warm + timed - 1
    # intervals
    fe = torch.cat([wm.field_energy, m.field_energy]).double().cpu()
    ke = torch.cat([wm.kinetic_energy, m.kinetic_energy]).double().cpu()
    tot = fe + ke
    res = dict(n=n, ng=ng, steps=timed, ms_per_step=(t2 - t1) * 1e3 / timed,
               pushes_per_s=n * timed / (t2 - t1), setup_s=t1 - t0,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
               total_energy_rel_change=float((tot[-1] - tot[0]) / tot[0]),
               launches=launches)
    log(f"[{tag}] {label}: n = {n}, ng = {ng}, {timed} timed steps "
        f"after init_state + {warm} warm-up: {res['ms_per_step']:.4f} ms/step, "
        f"{res['pushes_per_s']:.4e} pushes/s, setup {res['setup_s']:.2f} s, "
        f"peak memory {res['peak_mem_gib']:.2f} GiB, total energy change "
        f"{res['total_energy_rel_change']:+.4e} over {warm + timed} steps")
    log(f"[{tag}] {label}: launches {launches}")
    fields = [getattr(st, k) for k in ("p", "v", "e", "rho", "j") if hasattr(st, k)]
    finite = all(bool(torch.isfinite(t).all()) for t in fields + [tot])
    in_range = bool(((st.p >= 0) & (st.p <= ng)).all())
    problems = []
    if not (finite and in_range):
        problems.append(f"finite={finite} in_range={in_range}")
    if launches != want:
        problems.append(f"launches {launches} != {want}")
    if check is not None:
        problems += check(st, m)
    if problems:
        raise AssertionError(f"{tag}, {label}: " + "; ".join(problems))
    return res


def phase_explicit_slice(dev, kernel_ms: float) -> dict:
    from pypic_tpu_torch.constants import E_CHARGE, M_ELECTRON
    from pypic_tpu_torch.engines import explicit
    from pypic_tpu_torch.tools import two_stream

    n = N_HEADLINE
    steps = WARMUP_STEPS + TIMED_STEPS

    def main_cell():
        cfg, _, st = two_stream.state(n, dev)
        return cfg, st

    res = _drive("two-stream, one-kernel cycle", main_cell, WARMUP_STEPS,
                 TIMED_STEPS, {"explicit_cycle": steps, "deposit": 1})
    if not abs(res["total_energy_rel_change"]) < EXPLICIT_ENERGY_BOUND:
        raise AssertionError(f"explicit slice: total energy change "
                             f"{res['total_energy_rel_change']} above "
                             f"{EXPLICIT_ENERGY_BOUND}")
    # the step's (n,)-sized metric sums beside its kernel
    _, _, st = two_stream.state(n, dev)
    sums_ms = cuda_ms(lambda: (torch.dot(st.v, st.v), torch.sum(st.v)))
    del st
    log(f"[explicit slice] per step: explicit_cycle {kernel_ms:.4f} ms + "
        f"metric sums (v.v, sum v) {sums_ms:.4f} ms + the rest "
        f"{res['ms_per_step'] - kernel_ms - sums_ms:.4f} ms")
    res["metric_sums_ms"] = sums_ms

    def large_grid():
        cfg, _, st = two_stream.state(n, dev, ng=NG_LARGE)
        return cfg, st

    res["large_grid"] = _drive(
        f"ng = {NG_LARGE}, push+deposit kernel + FFT solve", large_grid,
        WARMUP_STEPS, BRANCH_STEPS,
        {"leapfrog_gather_push_deposit": WARMUP_STEPS + BRANCH_STEPS,
         "deposit": 1})

    def composed():
        cfg, params = two_stream.config(n)
        x, v = two_stream.device_load(n, cfg.grid, params, dev)
        q = torch.full((n,), -E_CHARGE, dtype=torch.float32, device=dev)
        m = torch.full((n,), M_ELECTRON, dtype=torch.float32, device=dev)
        return cfg, explicit.init_state(x, v, q, m, cfg)

    steps_c = WARMUP_STEPS + BRANCH_STEPS
    res["composed"] = _drive(
        "per-particle q/m, composed: gather kernel + push + deposit kernel",
        composed, WARMUP_STEPS, BRANCH_STEPS,
        {"gather": steps_c, "deposit": 1 + steps_c})
    torch.cuda.empty_cache()
    return res


def phase_resident(dev) -> dict:
    from pypic_tpu_torch import initialize
    from pypic_tpu_torch.constants import E_CHARGE, M_ELECTRON
    from pypic_tpu_torch.diagnostics import growth_rate_from_energy
    from pypic_tpu_torch.engines import explicit
    from pypic_tpu_torch.ops import cuda_cic
    from pypic_tpu_torch.runner import run
    from pypic_tpu_torch.tools import two_stream

    def load(n, ng):
        cfg, params = two_stream.config(n, ng)
        x, v, _ = initialize.initialize_periodic(
            "two-stream", n, two_stream.DENSITY, 1, two_stream.PERTURBATION,
            cfg.grid, two_stream.TE, two_stream.TE, seed=2)
        return cfg, params, x, v

    # bench.py's configs[0] row, through the resident path
    cfg, _, x, v = load(RESIDENT_N, NG)
    torch.cuda.synchronize()
    cuda_cic.reset_launch_counts()
    t0 = time.perf_counter()
    st = explicit.init_state(x, v, -E_CHARGE, M_ELECTRON, cfg, device=dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    fin, m = explicit.run_resident(cfg, st, RESIDENT_STEPS,
                                   steps_per_call=RESIDENT_SPC)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = dict(cuda_cic.LAUNCHES)
    want = {k: 0 for k in launches}
    want.update(explicit_cycle_resident=RESIDENT_STEPS // RESIDENT_SPC, deposit=1)
    us_step = (t2 - t1) * 1e6 / RESIDENT_STEPS
    # the same n through the per-step one-kernel path
    step = explicit.make_step(cfg)
    run(step, st, 10)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    st2, _ = run(step, st, PER_STEP_STEPS)
    torch.cuda.synchronize()
    us_per_step_path = (time.perf_counter() - t3) * 1e6 / PER_STEP_STEPS
    res = dict(n=RESIDENT_N, steps=RESIDENT_STEPS, steps_per_call=RESIDENT_SPC,
               us_per_step=us_step, pushes_per_s=RESIDENT_N / us_step * 1e6,
               setup_s=t1 - t0, per_step_path_us_per_step=us_per_step_path,
               launches=launches)
    log(f"[resident] n = {RESIDENT_N}, ng = {NG}, {RESIDENT_STEPS} steps, "
        f"{RESIDENT_SPC} a launch: {us_step:.3f} us/step, "
        f"{res['pushes_per_s']:.4e} pushes/s; per-step path "
        f"{us_per_step_path:.3f} us/step over {PER_STEP_STEPS} steps "
        f"({us_per_step_path / us_step:.1f}x)")
    log(f"[resident] launches {launches}")
    finite = all(bool(torch.isfinite(t).all()) for t in
                 (fin.p, fin.v, fin.e, m.field_energy, m.kinetic_energy))
    problems = []
    if not (finite and m.field_energy.shape == (RESIDENT_STEPS,)
            and int(fin.step) == RESIDENT_STEPS):
        problems.append(f"finite={finite} rows {tuple(m.field_energy.shape)} "
                        f"step {int(fin.step)}")
    if launches != want:
        problems.append(f"launches {launches} != {want}")
    # the run's first rows against the plain version from the same state
    plain_rows = cuda_cic.explicit_cycle_resident_plain(
        st.e, st.p, st.v, NG, RESIDENT_CHECK_STEPS,
        **explicit.resident_kwargs(st, cfg))[4:]
    _check(_row_errors(plain_rows, (m.field_energy, m.kinetic_energy, m.current_bias),
                       RESIDENT_CHECK_STEPS),
           f"run_resident rows (n = {RESIDENT_N}) vs plain")

    # the two-stream growth rate (tests/test_engines.py:71-79) on the card
    cfg, params, x, v = load(20_000, 64)
    st = explicit.init_state(x, v, -E_CHARGE, M_ELECTRON, cfg, device=dev)
    _, gm = explicit.run_resident(cfg, st, 400, steps_per_call=128)
    ee = gm.field_energy.double().cpu().numpy()
    vte = params.v_thermal / math.sqrt(2.0)
    xk = params.k * (2.0 * vte) / params.wp
    gamma = params.wp * math.sqrt(math.sqrt(1.0 + 8.0 * xk * xk) / 2.0 - xk * xk - 0.5)
    ratio = growth_rate_from_energy(ee, cfg.dt) / gamma
    res["growth_ratio"] = ratio
    log(f"[resident] two-stream growth, n = 20,000, ng = 64, 400 resident "
        f"steps: gamma / gamma_dispersion = {ratio:.4f} (bound 0.6-1.3)")
    if not 0.6 < ratio < 1.3:
        problems.append(f"growth ratio {ratio}")
    if problems:
        raise AssertionError("resident: " + "; ".join(problems))
    return res


def iters_agree(what: str, a, b, tol: float) -> bool:
    """Picard counts of two runs, each given as (iters, resid) rows, agree
    step for step, but at a step where the residual sat at the threshold
    (diagnostics.picard_counts_agree: one pass apart, and the run that
    stopped first within the runs' measured residual gap below tol). Logs
    each step whose counts differ with both runs' residuals."""
    import numpy as np

    from pypic_tpu_torch.diagnostics import picard_counts_agree

    ok, lines = picard_counts_agree(*a, *b, float(np.float32(tol)))
    for line in lines:
        log(f"[picard] {what}: {line}")
    return ok


def _seam_wrap(x: torch.Tensor, ng: int) -> torch.Tensor:
    return x - torch.floor(x * (1.0 / ng)) * ng


def _resident_implicit_case(dev, n: int, conf: str) -> float:
    """25 resident steps in chunks of 8 against 25 per-step steps of the
    fused engine and the plain resident version, on the configs[1] load
    with the loop options of ``conf``."""
    import dataclasses

    from pypic_tpu_torch.engines import implicit
    from pypic_tpu_torch.ops import cuda_cic as K
    from pypic_tpu_torch.runner import run
    from pypic_tpu_torch.tools import landau

    steps = IMPLICIT_RESIDENT_STEPS
    cfg, st = landau.state(n, dev)
    cfg = dataclasses.replace(cfg, **IMPLICIT_RESIDENT_CONFIGS[conf])
    fin, m = implicit.run_resident(cfg, st, steps,
                                   steps_per_call=IMPLICIT_RESIDENT_SPC)
    ref, rm = run(implicit.make_step(cfg), st, steps)
    plain = K.implicit_resident_plain(st.e, st.e_prev, st.j, st.p, st.v, NG,
                                      steps, **implicit.resident_kwargs(st, cfg))
    torch.cuda.synchronize()
    worst = 0.0
    got_rows = (m.picard_iters, m.picard_residual)
    for label, final, rows in (
            ("per-step", (ref.p, ref.v, ref.e, ref.e_prev, ref.j),
             dict(iters=rm.picard_iters, resid=rm.picard_residual,
                  fe=rm.field_energy, ke=rm.kinetic_energy)),
            ("plain", plain[:5], plain[5])):
        what = f"implicit_resident(n={n}, {conf}) vs {label}"
        a = seam_err(final[0], fin.p, NG)
        errs = {"p": dict(abs=a, err=a, kind="cells", tol=TOL_RESIDENT_IMPLICIT["p"])}
        for k, r_, g_ in zip(("v", "e", "e_prev", "j"), final[1:],
                             (fin.v, fin.e, fin.e_prev, fin.j)):
            a, r = rel_err(r_, g_)
            errs[k] = dict(abs=a, err=r, kind="rel", tol=TOL_RESIDENT_IMPLICIT[k])
        for k, got in (("fe", m.field_energy), ("ke", m.kinetic_energy)):
            d = (rows[k].double() - got.double()).abs() / rows[k].double().abs()
            errs[k] = dict(abs=float((rows[k].double() - got.double()).abs().max()),
                           err=float(d.max()), kind="rtol", tol=TOL_RESIDENT_IMPLICIT[k])
        worst = max(worst, _check(errs, what))
        if not iters_agree(what, got_rows, (rows["iters"], rows["resid"]), cfg.tol):
            raise AssertionError(
                f"{what}: Picard iterations {m.picard_iters.tolist()} != "
                f"{rows['iters'].tolist()}")
    log(f"[implicit kernels]   implicit_resident(n={n}, {conf}): Picard "
        f"iterations {m.picard_iters.tolist()}; per-step path "
        f"{rm.picard_iters.tolist()}")
    return worst


def phase_implicit_kernels(dev) -> dict:
    """The implicit engine's last three kernels against their plain
    versions: the converged-deposit finalize and the shared-window pass at
    the ragged and the headline n (the shared pass unclamped and forced to
    clamp), the resident kernel over 25 steps in both configurations at
    three n, then timed at the configs[1] row's shape."""
    from pypic_tpu_torch.engines import implicit
    from pypic_tpu_torch.ops import cuda_cic as K
    from pypic_tpu_torch.tools import landau

    gen = torch.Generator(device=dev).manual_seed(13)
    records = {}
    kw = dict(qm=QM, w=W, dt=DT, dx=DX)
    w32 = K.kernel_scalars(QM, DT, DX, W)[3]
    fast = dict(reps=3, calls=3)  # the plain versions take ~0.1 s a call
    for n, edges in ((N_RAGGED, True), (N_HEADLINE, False)):
        log(f"[implicit kernels] n = {n}, ng = {NG}" + (" (+ edge positions)" if edges else ""))
        e, ps, p0, v0 = _random_pass_inputs(n, gen, dev, edges)
        dtol = deposit_tol(n)

        got = K.picard_finalize(e, ps, p0, v0, NG, **kw)
        nodep = K.picard_finalize_nodep(e, ps, p0, v0, NG, qm=QM, dt=DT, dx=DX)
        ref = K.picard_finalize_plain(e, ps, p0, v0, NG, **kw)
        j64 = K.deposit_plain(ref[0].double(), (w32 * ref[1]).double(), NG,
                              periodic=True)
        torch.cuda.synchronize()
        if not (torch.equal(got[0], nodep[0]) and torch.equal(got[1], nodep[1])):
            raise AssertionError("picard_finalize: p1/v1 are not bit-identical "
                                 "to picard_finalize_nodep's")
        log("[implicit kernels]   picard_finalize: p1, v1 bit-identical to "
            "picard_finalize_nodep")
        a = seam_err(ref[0], got[0], NG)
        errs = {"p1": dict(abs=a, err=a, kind="cells", tol=TOL_POS)}
        a, r = rel_err(ref[1], got[1])
        errs["v1"] = dict(abs=a, err=r, kind="rel", tol=TOL_V)
        a, r = rel_err(j64, got[2])
        errs["j1"] = dict(abs=a, err=r, kind="rel vs float64", tol=TOL_DEP)
        a, r = rel_err(ref[2], got[2])
        errs["j1_plain"] = dict(abs=a, err=r, kind="rel", tol=dtol)
        err = _check(errs, "picard_finalize")
        del got, nodep, ref, j64
        records["picard_finalize"] = _rec(
            err, cuda_ms(lambda: K.picard_finalize(e, ps, p0, v0, NG, **kw)),
            cuda_ms(lambda: K.picard_finalize_plain(e, ps, p0, v0, NG, **kw), **fast),
            "picard_finalize", n)

        # the engine's case: the guess at the free-streaming midpoint under
        # a weak field, so that no deposit leaves the frame; jh is then a
        # deposit at the wrapped midpoint
        e_weak = e * 1e-3
        seed = _seam_wrap(p0 + (0.5 * DT / DX) * v0, NG)
        got = K.picard_iteration_shared(e_weak, seed, p0, v0, NG, **kw)
        ref = K.picard_iteration_shared_plain(e_weak, seed, p0, v0, NG, **kw)
        ph_r, v1_r, _ = K.picard_iteration_plain(e_weak, seed, p0, v0, NG,
                                                 emit_v=True, **kw)
        jh64 = K.deposit_plain(ph_r.double(), (w32 * (0.5 * (v0 + v1_r))).double(),
                               NG, periodic=True)
        torch.cuda.synchronize()
        a = seam_err(ref[0], got[0], NG)
        errs = {"ph": dict(abs=a, err=a, kind="cells", tol=TOL_POS)}
        a, r = rel_err(jh64, got[1])
        errs["jh"] = dict(abs=a, err=r, kind="rel vs float64 at ph", tol=TOL_DEP)
        a, r = rel_err(ref[1], got[1])
        errs["jh_plain"] = dict(abs=a, err=r, kind="rel", tol=dtol)
        errs["n_clamped"] = dict(abs=float(int(got[2])), err=float(int(got[2])),
                                 kind=f"count (plain {int(ref[2])})", tol=0.0)
        err = _check(errs, "picard_iteration_shared(unclamped)")
        del ph_r, v1_r, jh64, got, ref
        # forced clamps: any guess, a strong field. Clamping piles the
        # deposits onto the frames' edge rows, so the plain float32 sums
        # (global atomics) stray further than the bound of deposit_tol;
        # the kernel is held against the same float32 terms summed in
        # float64, and the plain float32 gap is reported
        got = K.picard_iteration_shared(e, ps, p0, v0, NG, emit_v=True, **kw)
        ref = K.picard_iteration_shared_plain(e, ps, p0, v0, NG, emit_v=True, **kw)
        jh64 = K.picard_iteration_shared_plain(e, ps, p0, v0, NG, acc_dtype=torch.float64,
                                               **kw)[1]
        torch.cuda.synchronize()
        a = seam_err(ref[0], got[0], NG)
        errs = {"ph": dict(abs=a, err=a, kind="cells", tol=TOL_POS)}
        a, r = rel_err(ref[1], got[1])
        errs["v1"] = dict(abs=a, err=r, kind="rel", tol=TOL_V)
        a, r = rel_err(jh64, got[2])
        errs["jh"] = dict(abs=a, err=r, kind="rel vs float64 sums", tol=TOL_DEP)
        log(f"[implicit kernels]   picard_iteration_shared(forced clamp): plain "
            f"float32 jh vs float64 sums {rel_err(jh64, ref[2])[1]:.3e}, kernel "
            f"vs plain {rel_err(ref[2], got[2])[1]:.3e} (rel)")
        del jh64
        diff = abs(int(got[3]) - int(ref[3]))
        errs["n_clamped"] = dict(abs=float(diff), err=float(diff),
                                 kind=f"count gap ({int(got[3])} clamped of {n})",
                                 tol=0.0)
        err = max(err, _check(errs, "picard_iteration_shared(forced clamp)"))
        if not int(got[3]) > n // 2:
            raise AssertionError(f"forced-clamp case clamped only {int(got[3])}")
        del got, ref
        records["picard_iteration_shared"] = _rec(
            err, cuda_ms(lambda: K.picard_iteration_shared(e_weak, seed, p0, v0, NG, **kw)),
            cuda_ms(lambda: K.picard_iteration_shared_plain(e_weak, seed, p0, v0, NG,
                                                            **kw), **fast),
            "picard_iteration_shared", n)
        del e, ps, p0, v0, e_weak, seed
        torch.cuda.empty_cache()

    worst = max(_resident_implicit_case(dev, n, conf)
                for conf in IMPLICIT_RESIDENT_CONFIGS for n in IMPLICIT_RESIDENT_NS)
    # timed at the configs[1] row's shape: one 64-step launch at n = 1e5
    cfg, st = landau.state(landau.N, dev)
    rkw = implicit.resident_kwargs(st, cfg)
    args = (st.e, st.e_prev, st.j, st.p, st.v, NG, landau.STEPS_PER_CALL)
    out = K.implicit_resident(*args, **rkw)
    ref = K.implicit_resident_plain(*args, **rkw)
    torch.cuda.synchronize()
    passes = int(out[5]["iters"].sum())
    if not iters_agree("implicit_resident(n = 1e5, 64 steps) vs plain",
                       (out[5]["iters"], out[5]["resid"]),
                       (ref[5]["iters"], ref[5]["resid"]), cfg.tol):
        raise AssertionError("implicit_resident: Picard iterations differ from "
                             "the plain version's at the row's shape")
    records["implicit_resident"] = _rec(
        worst, cuda_ms(lambda: K.implicit_resident(*args, **rkw), reps=5, calls=1),
        cuda_ms(lambda: K.implicit_resident_plain(*args, **rkw), reps=1, calls=1),
        "implicit_resident", landau.N, landau.STEPS_PER_CALL, passes)
    return records


def _two_species(n: int):
    """tests/test_engines.py:197-223's electron-ion load and config (ng 64,
    per-particle q/m, composed backend): (cfg, x, v, q, m) as numpy."""
    import numpy as np

    from pypic_tpu_torch.constants import (
        E_CHARGE, EPSILON_0, K_BOLTZMANN, M_ELECTRON)
    from pypic_tpu_torch.engines import implicit
    from pypic_tpu_torch.grid import GridSpec

    density, te = 1e10, 0.1 * 11600.0
    debye = np.sqrt(K_BOLTZMANN * te * EPSILON_0 / E_CHARGE**2 / density)
    grid = GridSpec(64, 15.0 * debye, "periodic")
    rng = np.random.default_rng(9)
    x = rng.uniform(0, grid.length, n)
    m = np.where(np.arange(n) < n // 2, M_ELECTRON, 1836.0 * M_ELECTRON)
    q = np.where(np.arange(n) < n // 2, -E_CHARGE, E_CHARGE)
    v = rng.normal(size=n) * np.sqrt(K_BOLTZMANN * te / m)
    dt = 0.1 * np.sqrt(E_CHARGE**2 * density / EPSILON_0 / M_ELECTRON) ** -1
    cfg = implicit.ImplicitConfig(grid, dt, grid.length * density / n,
                                  tol=1e-8, maxiter=50, backend="composed")
    return cfg, x, v, q, m


def phase_implicit_check(dev) -> None:
    """The implicit engine's other paths on the card against the CPU
    (plain versions), 50 steps at n = 20,000 each: the composed backend on
    a two-species load, finalize='converged-deposit' and
    window_share='shared' (no deposit clamped) on a two-stream load."""
    import dataclasses

    from pypic_tpu_torch import initialize
    from pypic_tpu_torch.constants import E_CHARGE, M_ELECTRON
    from pypic_tpu_torch.engines import implicit
    from pypic_tpu_torch.runner import run
    from pypic_tpu_torch.tools import two_stream

    n, steps = IMPLICIT_CHECK_N, IMPLICIT_CHECK_STEPS
    # the two-stream load and configurations of the JAX tests of these
    # options (tests/test_engines.py:226-252 and 419-446). The headline's
    # Landau load is too violent for a 50-step trajectory comparison: a
    # 1-ulp change of v moves its positions 1.3e-3 cells in 50 steps on the
    # CPU (3.4e-5 on this load)
    tcfg, _ = two_stream.config(n, 64)
    tx, tv, _ = initialize.initialize_periodic(
        "two-stream", n, two_stream.DENSITY, 1, two_stream.PERTURBATION,
        tcfg.grid, two_stream.TE, two_stream.TE, seed=2)
    base = implicit.ImplicitConfig(tcfg.grid, tcfg.dt, tcfg.p2c, maxiter=50)
    cases = {
        "composed, two species": _two_species(n),
        "converged-deposit": (dataclasses.replace(
            base, tol=1e-10, finalize="converged-deposit"),
            tx, tv, -E_CHARGE, M_ELECTRON),
        "window_share='shared'": (dataclasses.replace(
            base, tol=1e-8, window_share="shared"),
            tx, tv, -E_CHARGE, M_ELECTRON),
    }
    for label, (cfg, x, v, q, m) in cases.items():
        out = []
        for device in ("cpu", dev):
            st = implicit.init_state(x, v, q, m, cfg, device=device)
            out.append(run(implicit.make_step(cfg), st, steps))
        (sc, mc), (sg, mg) = out
        ng = cfg.grid.ng
        errs = {"p (cells)": seam_err(sc.p, sg.p.cpu(), ng)}
        for k in ("v", "e", "j"):
            errs[k] = rel_err(getattr(sc, k), getattr(sg, k).cpu())[1]
        for k in ("field_energy", "kinetic_energy"):
            errs[k] = rel_err(getattr(mc, k), getattr(mg, k).cpu())[1]
        for k, err in errs.items():
            log(f"[implicit check] {label}, {steps} steps, GPU vs CPU {k}: "
                f"{err:.3e} (tol {TOL_IMPLICIT_CHECK[k]:.0e})")
        iters = (int(mc.picard_iters.sum()), int(mg.picard_iters.sum()))
        clamped = (int(mc.picard_clamped.sum()), int(mg.picard_clamped.sum()))
        log(f"[implicit check] {label}: Picard passes CPU {iters[0]}, GPU "
            f"{iters[1]}; clamped deposits CPU {clamped[0]}, GPU {clamped[1]}")
        bad = {k: e for k, e in errs.items() if not e <= TOL_IMPLICIT_CHECK[k]}
        if not iters_agree(f"implicit check, {label}, GPU vs CPU",
                           (mg.picard_iters, mg.picard_residual),
                           (mc.picard_iters, mc.picard_residual), cfg.tol):
            bad["picard_iters"] = iters
        if clamped != (0, 0):
            bad["picard_clamped"] = clamped
        if bad:
            raise AssertionError(f"implicit check, {label}: GPU and CPU "
                                 f"disagree: {bad}")


def _landau_rate_load(n: int, dev):
    """tests/test_engines.py:82-109's kLD = 0.5 case at n particles."""
    import numpy as np

    from pypic_tpu_torch import initialize
    from pypic_tpu_torch.constants import (
        E_CHARGE, EPSILON_0, K_BOLTZMANN, M_ELECTRON)
    from pypic_tpu_torch.engines import implicit
    from pypic_tpu_torch.grid import GridSpec

    density, te = 1e10, 11600.0
    debye = np.sqrt(K_BOLTZMANN * te * EPSILON_0 / E_CHARGE**2 / density)
    grid = GridSpec(64, 4.0 * np.pi * debye, "periodic")
    x, v, params = initialize.initialize_periodic(
        "landau-damping", n, density, 1, 0.1, grid, te, te, seed=4)
    cfg = implicit.ImplicitConfig(grid, 0.1 / params.wp, params.p2c, tol=1e-4,
                                  maxiter=20)
    st = implicit.init_state(x, v, -E_CHARGE, M_ELECTRON, cfg, device=dev)
    return cfg, params, st


def phase_implicit_slices(dev) -> dict:
    """The configs[1] row through run_resident beside the per-step path,
    the Landau damping rate, then the headline cell with each of the other
    new options."""
    import dataclasses

    from pypic_tpu_torch.diagnostics import damping_rate_from_peaks
    from pypic_tpu_torch.engines import implicit
    from pypic_tpu_torch.ops import cuda_cic
    from pypic_tpu_torch.runner import run
    from pypic_tpu_torch.tools import landau

    # bench.py's configs[1] row
    torch.cuda.synchronize()
    cuda_cic.reset_launch_counts()
    t0 = time.perf_counter()
    cfg, st = landau.state(landau.N, dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    fin, m = implicit.run_resident(cfg, st, landau.STEPS,
                                   steps_per_call=landau.STEPS_PER_CALL)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = dict(cuda_cic.LAUNCHES)
    want = {k: 0 for k in launches}
    want.update(implicit_resident=landau.STEPS // landau.STEPS_PER_CALL, deposit=2)
    us_step = (t2 - t1) * 1e6 / landau.STEPS
    step = implicit.make_step(cfg)
    ref, rm = run(step, st, LANDAU_CHECK_STEPS)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    run(step, st, LANDAU_PER_STEP_STEPS)
    torch.cuda.synchronize()
    us_per_step_path = (time.perf_counter() - t3) * 1e6 / LANDAU_PER_STEP_STEPS
    tot = (m.field_energy.double() + m.kinetic_energy.double()).cpu()
    res = dict(n=landau.N, steps=landau.STEPS, steps_per_call=landau.STEPS_PER_CALL,
               us_per_step=us_step, pushes_per_s=landau.N / us_step * 1e6,
               setup_s=t1 - t0, per_step_path_us_per_step=us_per_step_path,
               picard_mean=float(m.picard_iters.float().mean()),
               per_step_picard_mean=float(rm.picard_iters.float().mean()),
               total_energy_rel_change=float((tot[-1] - tot[0]) / tot[0]),
               launches=launches)
    log(f"[implicit slice] configs[1] row: n = {landau.N}, ng = {NG}, "
        f"{landau.STEPS} steps, {landau.STEPS_PER_CALL} a launch: "
        f"{us_step:.3f} us/step, {res['pushes_per_s']:.4e} pushes/s, Picard "
        f"mean {res['picard_mean']:.3f}, total energy change "
        f"{res['total_energy_rel_change']:+.4e}; per-step path "
        f"{us_per_step_path:.3f} us/step over {LANDAU_PER_STEP_STEPS} steps "
        f"({us_per_step_path / us_step:.1f}x)")
    log(f"[implicit slice] configs[1] row: launches {launches}")
    problems = []
    finite = all(bool(torch.isfinite(t).all()) for t in
                 (fin.p, fin.v, fin.e, fin.j, m.field_energy, m.kinetic_energy))
    if not (finite and m.field_energy.shape == (landau.STEPS,)
            and int(fin.step) == landau.STEPS):
        problems.append(f"finite={finite} rows {tuple(m.field_energy.shape)} "
                        f"step {int(fin.step)}")
    if launches != want:
        problems.append(f"launches {launches} != {want}")
    k = LANDAU_CHECK_STEPS
    differ = int((m.picard_iters[:k].cpu() != rm.picard_iters.cpu()).sum())
    log(f"[implicit slice] configs[1] row: first {k} steps' Picard passes "
        f"{m.picard_iters[:k].tolist()}; per-step path {rm.picard_iters.tolist()} "
        f"({differ} steps differ)")
    res["first_rows_iters_differ"] = differ
    if not iters_agree(f"configs[1] row's first {k} rows vs the per-step path",
                       (m.picard_iters[:k], m.picard_residual[:k]),
                       (rm.picard_iters, rm.picard_residual), cfg.tol):
        problems.append(f"first {k} rows' Picard iterations "
                        f"{m.picard_iters[:k].tolist()} != {rm.picard_iters.tolist()}")
    errs = {}
    for name in ("field_energy", "kinetic_energy"):
        a, b = getattr(rm, name).double(), getattr(m, name)[:k].double()
        d = (a - b).abs()
        errs[name] = dict(abs=float(d.max()), err=float((d / a.abs()).max()),
                          kind="rtol",
                          tol=TOL_RESIDENT_IMPLICIT["fe" if name == "field_energy" else "ke"])
    _check(errs, f"run_resident's first {k} rows vs the per-step path")
    if problems:
        raise AssertionError("implicit slice, configs[1] row: " + "; ".join(problems))
    del fin, ref

    # the Landau damping rate on the card
    def landau_ratio(m_r, cfg_r, params):
        """tests/test_engines.py:96-108: the rate of the field energy's
        peak envelope before 15 / wp, over the analytic rate."""
        return float(damping_rate_from_peaks(m_r.field_energy, cfg_r.dt,
                                             t_max=15.0 / params.wp)
                     / params.growth_rate)

    cfg_r, params, st_r = _landau_rate_load(LANDAU_RATE_N, dev)
    _, mr = run(implicit.make_step(cfg_r), st_r, LANDAU_RATE_STEPS)
    res["landau_ratio"] = landau_ratio(mr, cfg_r, params)
    cfg_r, params, st_r = _landau_rate_load(LANDAU_RATE_RESIDENT_N, dev)
    _, mr = implicit.run_resident(cfg_r, st_r, LANDAU_RATE_STEPS)
    res["landau_ratio_resident"] = landau_ratio(mr, cfg_r, params)
    log(f"[implicit slice] Landau damping gamma / gamma_analytic: "
        f"{res['landau_ratio']:.4f} at n = {LANDAU_RATE_N}, per-step path "
        f"(bound 0.7-1.4); {res['landau_ratio_resident']:.4f} at "
        f"n = {LANDAU_RATE_RESIDENT_N} through run_resident")
    if not 0.7 < res["landau_ratio"] < 1.4:
        raise AssertionError(f"Landau damping ratio {res['landau_ratio']}")
    del st_r, mr

    # the headline cell with each new option
    def headline(**opts):
        def build():
            cfg_h, _, st_h = headline_state(N_HEADLINE, dev)
            return dataclasses.replace(cfg_h, **opts), st_h
        return build

    def conserving(st_h, m_h):
        fe, ke = m_h.field_energy.double(), m_h.kinetic_energy.double()
        tot = fe + ke
        change = float((tot[-1] - tot[0]) / tot[0])
        return [] if abs(change) < 1e-4 else [f"total energy change {change}"]

    def unclamped(st_h, m_h):
        n_cl = int(m_h.picard_clamped.sum())
        return conserving(st_h, m_h) + ([] if n_cl == 0 else [f"{n_cl} deposits clamped"])

    steps = WARMUP_STEPS + BRANCH_STEPS
    passes = 4 * steps  # the conserving configuration: 4 passes a step
    res["converged_deposit"] = _drive(
        "finalize='converged-deposit'", headline(finalize="converged-deposit"),
        WARMUP_STEPS, BRANCH_STEPS,
        {"picard_iteration": passes, "picard_finalize": steps, "deposit": 2},
        engine=implicit, tag="implicit slice", check=conserving)
    res["shared"] = _drive(
        "window_share='shared'", headline(window_share="shared"),
        WARMUP_STEPS, BRANCH_STEPS,
        {"picard_iteration_shared": passes, "picard_finalize_nodep": steps,
         "deposit": 2},
        engine=implicit, tag="implicit slice", check=unclamped)
    res["composed"] = _drive(
        "backend='composed': gather kernel + push + 2 deposit kernels a pass",
        headline(backend="composed"), WARMUP_STEPS, BRANCH_STEPS,
        {"gather": passes, "deposit": 2 + 2 * passes},
        engine=implicit, tag="implicit slice")
    torch.cuda.empty_cache()
    return res


def _mag_inputs(n: int, gen: torch.Generator, dev):
    """Bounded-grid particles at ng = 600: a tenth inactive, the first
    rows at the walls and off the grid (wall-lost slots); const =
    0.5 dt e Z / m for Z in 1..5 and boron's mass."""
    f32 = torch.float32
    p = torch.rand(n, generator=gen, device=dev, dtype=f32) * (NG_MAG - 1)
    p[:4] = torch.tensor([0.0, NG_MAG - 1.0, -0.3, NG_MAG - 0.7], device=dev)
    v = torch.randn((3, n), generator=gen, device=dev, dtype=f32) * 2e4
    act = (torch.rand(n, generator=gen, device=dev) < 0.9).to(f32)
    act[2:4] = 0.0
    z = torch.randint(1, 6, (n,), generator=gen, device=dev).to(f32)
    const = z * (0.5 * 1e-10 * 1.602e-19 / (10.81 * 1.67e-27))
    field = torch.randn(NG_MAG, generator=gen, device=dev, dtype=f32) * 1e5
    return field, p, v[0], v[1], v[2], const, act


def _newton_cases(dev):
    """tests/test_pallas.py:315-342's inputs at ng = 600, 301 and 128."""
    import numpy as np

    for ng in (600, 301, 128):
        rng = np.random.default_rng(11 + ng)
        dens = (1e17 * (1.0 + 0.3 * rng.standard_normal(ng))).clip(1e15)
        yield ng, torch.from_numpy((1.602e-19 * dens).astype(np.float32)).to(dev)


def phase_magnetized_kernels(dev) -> dict:
    """The magnetized engine's four kernels against their plain versions
    at the ragged and the row's n; returns the records at the row's n (the
    Newton solve at the row's first solve)."""
    import numpy as np

    from pypic_tpu_torch.ops import cuda_cic as K
    from pypic_tpu_torch.ops import cuda_newton, cuda_rng
    from pypic_tpu_torch.tools import magnetized as row

    gen = torch.Generator(device=dev).manual_seed(17)
    records = {}
    fast = dict(reps=3, calls=3)
    bkw = dict(b=(0.1395, 1.9951, 0.0), dt_dx=1e-10 / 2.5e-6)
    for n in (N_MAG_RAGGED, N_MAG):
        log(f"[magnetized kernels] n = {n}, ng = {NG_MAG}")
        field, p, vx, vy, vz, const, act = _mag_inputs(n, gen, dev)
        va, vb = vx * act, vy.abs() * act
        got = K.deposit2(p, va, vb, NG_MAG, periodic=False)
        ref = K.deposit2_plain(p, va, vb, NG_MAG, periodic=False)
        f64 = K.deposit2_plain(p.double(), va.double(), vb.double(), NG_MAG,
                               periodic=False)
        torch.cuda.synchronize()
        errs = {}
        for label, g, r, r64 in (("rho", got[0], ref[0], f64[0]),
                                 ("n", got[1], ref[1], f64[1])):
            a, rel = rel_err(r64, g)
            errs[label] = dict(abs=a, err=rel, kind="rel vs float64", tol=TOL_DEP)
            a, rel = rel_err(r, g)
            errs[f"{label}_plain"] = dict(abs=a, err=rel, kind="rel",
                                          tol=deposit_tol(n, NG_MAG))
        err = _check(errs, "deposit2")
        call = lambda: K.deposit2(p, va, vb, NG_MAG, periodic=False)  # noqa: E731
        records["deposit2"] = _rec(
            err, device_ms(call),
            cuda_ms(lambda: K.deposit2_plain(p, va, vb, NG_MAG, periodic=False),
                    **fast), "deposit2", n)
        del got, ref, f64

        worst = 0.0
        for swap in (False, True):
            got = K.boris_gather_push(field, p, vx, vy, vz, const, act,
                                      swap_weights=swap, **bkw)
            ref = K.boris_gather_push_plain(field, p, vx, vy, vz, const, act,
                                            swap_weights=swap, **bkw)
            torch.cuda.synchronize()
            live = act > 0
            held = all(torch.equal(g[~live], h[~live])
                       for g, h in zip(got, (p, vx, vy, vz)))
            if not held:
                raise AssertionError("boris_gather_push: inactive rows changed")
            a = float((got[0] - ref[0]).abs().max())
            errs = {"p1": dict(abs=a, err=a, kind="cells", tol=TOL_POS)}
            for k, r_, g_ in zip(("vx1", "vy1", "vz1"), ref[1:], got[1:]):
                a, rel = rel_err(r_, g_)
                errs[k] = dict(abs=a, err=rel, kind="rel", tol=TOL_V)
            worst = max(worst, _check(errs, f"boris_gather_push(swap={swap})"))
            del got, ref
        log("[magnetized kernels]   boris_gather_push: inactive rows bit-equal "
            "to their inputs")
        call = lambda: K.boris_gather_push(  # noqa: E731
            field, p, vx, vy, vz, const, act, swap_weights=True, **bkw)
        records["boris_gather_push"] = _rec(
            worst, device_ms(call),
            cuda_ms(lambda: K.boris_gather_push_plain(
                field, p, vx, vy, vz, const, act, swap_weights=True, **bkw), **fast),
            "boris_gather_push", n)
        del field, p, vx, vy, vz, const, act, va, vb

        key, step, length, vth = (0, 1), 7, 3.0e-3, 2.2e4
        u = cuda_rng.source_uniforms(key, step, n, device=dev)
        u_ref = cuda_rng.source_uniforms(key, step, n, device="cpu")
        if not torch.equal(u.cpu(), u_ref):
            raise AssertionError("source_batch: the kernel's Philox uniforms "
                                 "differ from philox4x32_plain's")
        log(f"[magnetized kernels]   source_batch: {4 * n} Philox uniforms "
            "bit-equal to philox4x32_plain's")
        del u, u_ref
        skw = dict(x_mu=length / 2, x_sigma=length / 12, x_wrap=length, vth=vth)
        got = cuda_rng.source_batch(key, step, n, device=dev, **skw)
        ref = cuda_rng.source_batch_plain(key, step, n, device=dev, **skw)
        torch.cuda.synchronize()
        d = (got[0].double() - ref[0].double()).abs()
        a = float(torch.minimum(d, length - d).max())
        errs = {"x": dict(abs=a, err=a / length, kind="of L", tol=TOL_SOURCE)}
        for k, r_, g_ in zip(("vx", "vy", "vz"), ref[1:], got[1:]):
            a, rel = rel_err(r_, g_)
            errs[k] = dict(abs=a, err=rel, kind="rel", tol=TOL_SOURCE)
        err = _check(errs, "source_batch")
        del got, ref
        call = lambda: cuda_rng.source_batch(key, step, n, device=dev, **skw)  # noqa: E731
        records["source_batch"] = _rec(
            err, device_ms(call),
            cuda_ms(lambda: cuda_rng.source_batch_plain(key, step, n, device=dev,
                                                         **skw), **fast),
            "source_batch", n)
        g = torch.Generator(device=dev).manual_seed(5)
        records["source_batch"]["library_ms"] = device_ms(
            lambda: torch.randn((4, n), device=dev, generator=g))
        log(f"[magnetized kernels]   source_batch: library call torch.randn((4, n)) "
            f"{records['source_batch']['library_ms']:.4f} ms")
        torch.cuda.empty_cache()

    # the Newton kernel on test_pallas.py's cases, n0 a device tensor
    n0 = torch.tensor(1e17, dtype=torch.float32, device=dev)
    te, dx = 116000.0, 2e-5
    worst = 0.0
    for ng, rho in _newton_cases(dev):
        for warm in (False, True):
            ref0 = cuda_newton.boltzmann_dirichlet_plain(rho, n0, te, dx)
            phi0 = ref0.phi if warm else None
            got = cuda_newton.boltzmann_dirichlet(rho, n0, te, dx, phi0=phi0)
            ref = (cuda_newton.boltzmann_dirichlet_plain(rho, n0, te, dx, phi0=phi0)
                   if warm else ref0)
            gi, ri = int(got.iterations), int(ref.iterations)
            a, rel = rel_err(ref.phi, got.phi)
            errs = {"phi": dict(abs=a, err=rel, kind="rel", tol=TOL_NEWTON_PHI),
                    "residual": dict(abs=float(got.residual),
                                     err=float(got.residual), kind="<= tol",
                                     tol=1e-9),
                    "iterations": dict(abs=float(abs(gi - ri)), err=float(abs(gi - ri)),
                                       kind=f"count gap ({gi} vs plain {ri})",
                                       tol=0.0 if warm else 1.0)}
            worst = max(worst, _check(errs, f"boltzmann_dirichlet(ng={ng}, "
                                            f"{'warm' if warm else 'cold'})"))
    # timed on the row's first solve: its deposit, n0 = 0.9 <n>, cold start
    cfg, st, _ = row.state(dev)
    w_rho = st.charge_state * 1.602e-19 * st.p2c / cfg.grid.dx
    rho, n_dens = K.deposit2(st.p, w_rho, st.p2c / cfg.grid.dx, NG_MAG,
                             periodic=False)
    n0 = 0.9 * torch.mean(n_dens)
    del st, w_rho
    kw = dict(tol=cfg.newton_tol, maxiter=cfg.newton_maxiter)
    got = cuda_newton.boltzmann_dirichlet(rho, n0, cfg.te, cfg.grid.dx, **kw)
    ref = cuda_newton.boltzmann_dirichlet_plain(rho, n0, cfg.te, cfg.grid.dx, **kw)
    iters = int(got.iterations)
    a, rel = rel_err(ref.phi, got.phi)
    worst = max(worst, _check(
        {"phi": dict(abs=a, err=rel, kind=f"rel ({iters} vs plain "
                     f"{int(ref.iterations)} iterations)", tol=TOL_NEWTON_PHI)},
        "boltzmann_dirichlet(configs[3] row's first solve)"))
    records["boltzmann_dirichlet"] = _rec(
        worst, device_ms(lambda: cuda_newton.boltzmann_dirichlet(
            rho, n0, cfg.te, cfg.grid.dx, **kw)),
        cuda_ms(lambda: cuda_newton.boltzmann_dirichlet_plain(
            rho, n0, cfg.te, cfg.grid.dx, **kw), **fast),
        "boltzmann_dirichlet", NG_MAG, iters)
    rec = records["boltzmann_dirichlet"]
    rec["iterations"] = iters
    rec["us_per_iteration"] = rec["ms"] * 1e3 / iters
    log(f"[magnetized kernels]   boltzmann_dirichlet at ng = {NG_MAG}: "
        f"{iters} iterations, {rec['us_per_iteration']:.3f} us per iteration")
    return records


def _mag_step_errors(c, g) -> dict:
    """One step on the CPU (c) and the card (g), each (state, metrics):
    the largest |g - c| / (atol + rtol |c|) of each quantity (<= 1 passes
    assert_allclose's test)."""
    sc, mc = c
    sg, mg = g
    act = sc.active == 1

    def worst(ref, got, key):
        rtol, atol = TOL_MAG_STEP[key]
        ref, got = ref.double(), got.double().cpu()
        return float(((got - ref).abs() / (atol + rtol * ref.abs())).max())

    return {"rho": worst(mc.rho, mg.rho, "rho"), "phi": worst(mc.phi, mg.phi, "phi"),
            "p": worst(sc.p[act], sg.p.cpu()[act], "p"),
            "v": worst(sc.v[act], sg.v.cpu()[act], "v")}


def _population(m) -> list:
    """tests/test_magnetized.py:341-353 as a list of problems."""
    tot = (m.n_active + m.n_hit_wall).cpu()
    react, hits = m.n_reactivated.cpu(), m.n_hit_wall.cpu()
    out = []
    if not bool((tot == tot[0]).all()):
        out.append(f"n_active + hits not constant ({int(tot.min())}-{int(tot.max())})")
    if not torch.equal(react[1:], hits[:-1]):
        out.append("re-activations differ from the previous step's losses")
    return out


def phase_magnetized_check(dev) -> dict:
    """pic_iead at n = 12,000 on the card (the 'auto' configuration: fused,
    Newton kernel, Philox kernel) against the CPU (the same fused path and
    Newton PCR in their plain versions, the same Philox draws)."""
    import dataclasses

    from pypic_tpu_torch import interop, presets
    from pypic_tpu_torch.engines import magnetized
    from pypic_tpu_torch.runner import run

    pre = presets.pic_iead(n_per_species=MAG_CHECK_PER_SPECIES, device="cpu")
    cfg_cpu = dataclasses.replace(pre.config, backend="fused", newton_backend="pallas")
    step_cpu = magnetized.make_step(cfg_cpu)
    step_gpu = magnetized.make_step(pre.config)
    snaps, st = {}, pre.state
    for i in range(max(MAG_CHECK_AT) + 1):
        if i in MAG_CHECK_AT:
            snaps[i] = interop.magnetized_state_to_numpy(st)
        if i < max(MAG_CHECK_AT):
            st, _ = step_cpu(st)
    problems = []
    for i, d in snaps.items():
        c = step_cpu(interop.magnetized_state_from_numpy(d, "cpu"))
        g = step_gpu(interop.magnetized_state_from_numpy(d, dev))
        errs = _mag_step_errors(c, g)
        counts = {k: (int(getattr(c[1], k)), int(getattr(g[1], k)))
                  for k in ("n_hit_wall", "n_reactivated", "newton_iters")}
        counts["n_active"] = (int(c[1].n_active), int(g[1].n_active))
        log(f"[magnetized check] n = {pre.state.p.shape[0]}, step {i} -> {i + 1}, "
            "GPU vs CPU, |d| / (atol + rtol |ref|) (<= 1 passes): "
            + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
            + f"; counts (CPU, GPU) {counts}")
        bad = {k: v for k, v in errs.items() if not v <= 1.0}
        if counts["n_active"][0] != counts["n_active"][1]:
            bad["n_active"] = counts["n_active"]
        if bad:
            problems.append(f"step {i}: {bad}")
    out = {}
    for label, step, device in (("CPU", step_cpu, "cpu"), ("GPU", step_gpu, dev)):
        s0 = interop.magnetized_state_from_numpy(snaps[0], device)
        _, m = run(step, s0, MAG_CHECK_STEPS)
        out[label] = float(m.phi_max[5:].double().mean())
        pop = _population(m)
        log(f"[magnetized check] {MAG_CHECK_STEPS} steps on the {label}: mean "
            f"phi_max (steps 5-{MAG_CHECK_STEPS - 1}) {out[label]:.6f} V, Newton "
            f"mean {float(m.newton_iters.float().mean()):.3f}, wall losses "
            f"{int(m.n_hit_wall.sum())}; population invariant "
            + ("holds" if not pop else f"FAILS: {pop}"))
        problems += [f"{label}: {x}" for x in pop]
    rel = abs(out["GPU"] - out["CPU"]) / abs(out["CPU"])
    log(f"[magnetized check] mean phi_max GPU vs CPU: {rel:.3e} (tol {MAG_PHI_MAX_RTOL})")
    if not rel <= MAG_PHI_MAX_RTOL:
        problems.append(f"phi_max means {out}")
    if problems:
        raise AssertionError("magnetized check: " + "; ".join(problems))
    return dict(phi_max_rel=rel)


def phase_magnetized_slice(dev) -> dict:
    """bench.py's configs[3] row through tools/magnetized.py, then the
    composed backend."""
    from pypic_tpu_torch.ops import cuda_cic
    from pypic_tpu_torch.tools import magnetized as row

    res, cfg, fin, m = row.run_row(dev)
    steps = row.STEPS
    want = {k: 0 for k in cuda_cic.LAUNCHES}
    want.update(deposit2=steps, boltzmann_dirichlet=steps,
                boris_gather_push=steps, source_batch=steps, deposit=steps)
    launches = dict(cuda_cic.LAUNCHES)
    res["launches"] = launches
    log(f"[magnetized slice] configs[3] row: n = {res['n']}, ng = {NG_MAG}, "
        f"{steps} steps under sync debug mode 'error': {res['us_per_step']:.3f} "
        f"us/step, {res['pushes_per_s']:.4e} pushes/s, Newton mean "
        f"{res['newton_mean']:.3f} (max {int(m.newton_iters.max())}), phi_max / "
        f"phi_f (last 100 steps) {res['phi_max_over_phi_f']:.4f}, wall losses "
        f"{int(m.n_hit_wall.sum())}, IEAD counts "
        f"{fin.iead.sum(dim=(1, 2)).cpu().tolist()}")
    log(f"[magnetized slice] configs[3] row: launches {launches}")
    problems = row.check_row(cfg, fin, m)
    if launches != want:
        problems.append(f"launches {launches} != {want}")
    del fin, m
    res_c, _, fin, m = row.run_row(dev, steps=MAG_COMPOSED_STEPS, backend="composed")
    want_c = {k: 0 for k in cuda_cic.LAUNCHES}
    want_c.update(gather=MAG_COMPOSED_STEPS, deposit=3 * MAG_COMPOSED_STEPS,
                  boltzmann_dirichlet=MAG_COMPOSED_STEPS,
                  source_batch=MAG_COMPOSED_STEPS)
    launches_c = dict(cuda_cic.LAUNCHES)
    res_c["launches"] = launches_c
    log(f"[magnetized slice] backend='composed': {MAG_COMPOSED_STEPS} steps, "
        f"{res_c['us_per_step']:.3f} us/step, launches {launches_c}")
    problems += [f"composed: {x}" for x in _population(m)]
    if launches_c != want_c:
        problems.append(f"composed launches {launches_c} != {want_c}")
    if not bool(torch.isfinite(fin.p).all() and torch.isfinite(m.phi).all()):
        problems.append("composed: non-finite state")
    if problems:
        raise AssertionError("magnetized slice: " + "; ".join(problems))
    res["composed"] = res_c
    torch.cuda.empty_cache()
    return res


def _sheath_inputs(n: int, ng: int, gen: torch.Generator, dev):
    """Bounded-grid rows for the sheath pass: electrons and protons, rows
    exactly at 0 and at cells, rows lost left and right in an earlier pass
    and rows that cross a wall in this one."""
    f32 = torch.float32
    cells = float(ng - 1)
    p0 = torch.rand(n, generator=gen, device=dev, dtype=f32) * cells
    ps = torch.clamp(p0 + 0.2 * torch.randn(n, generator=gen, device=dev, dtype=f32),
                     -0.5, cells + 0.5)
    ion = torch.rand(n, generator=gen, device=dev) < 0.5
    qm = torch.where(ion, 1.602e-19 / 1.67e-27, -1.602e-19 / 9.11e-31).to(f32)
    u0 = torch.randn(n, generator=gen, device=dev, dtype=f32) * torch.where(
        ion, 3e4, 1.3e6).to(f32)
    w = torch.where(ion, 1.602e-10, -1.602e-10).to(f32)
    act = torch.ones(n, device=dev, dtype=f32)
    p0[:4] = torch.tensor([0.0, cells, 0.0, cells], device=dev)
    ps[:4] = p0[:4]
    act[4:40:2] = 0.0
    act[5:40:2] = -1.0
    p0[40:60] = 0.3
    u0[40:60] = -2.5 * SHEATH_DX / SHEATH_DT
    p0[60:80] = cells - 0.3
    u0[60:80] = 2.5 * SHEATH_DX / SHEATH_DT
    es = torch.randn(ng, generator=gen, device=dev, dtype=f32) * 2e4
    return es, ps, p0, u0, qm, w, act


def phase_sheath_kernels(dev) -> dict:
    """The sheath engine's four kernels against their plain versions at
    the row's n and a ragged n (the pass kernels at ng = 51 and 11, the
    deterministic deposit at the composed path's and the histograms'
    shapes); returns the records at the row's shape (n = 1e6, ng = 51; the
    re-injection at gamma 0)."""
    from pypic_tpu_torch.ops import cuda_cic as K
    from pypic_tpu_torch.ops import cuda_rng, cuda_sheath as S

    gen = torch.Generator(device=dev).manual_seed(23)
    kw = dict(dt=SHEATH_DT, dx=SHEATH_DX)
    fast = dict(reps=3, calls=3)
    records = {}
    for n in (N_SHEATH_RAGGED, N_SHEATH):
        for ng in (NG_SHEATH, 11):
            log(f"[sheath kernels] n = {n}, ng = {ng}")
            args = _sheath_inputs(n, ng, gen, dev)
            es, ps, p0, u0, qm, w, act = args
            dtol = deposit_tol(n, ng)
            for name, fn, plain in (
                    ("sheath_picard", S.sheath_picard, S.sheath_picard_plain),
                    ("sheath_finalize", S.sheath_finalize, S.sheath_finalize_plain)):
                got = fn(*args, **kw)
                if not torch.equal(fn(*args, **kw)[-1], got[-1]):
                    raise AssertionError(f"{name}: the current differs from "
                                         "call to call")
                ref = plain(*args, **kw)
                torch.cuda.synchronize()
                labels = ("x1", "u1", "act1") if len(got) == 4 else ("xh", "act1")
                for label, g, r in zip(labels, got[:-1], ref[:-1]):
                    if not torch.equal(g, r):
                        d = float((g.double() - r.double()).abs().max())
                        raise AssertionError(f"{name}: {label} differs from the "
                                             f"plain version's by {d}")
                act1 = got[-2]
                if not bool((act1[40:80] != 1.0).all()):
                    raise AssertionError(f"{name}: a wall-crossing row stayed active")
                vals = got[1] if len(got) == 4 else S._push_plain(
                    es, ps, p0, u0, qm, act, SHEATH_DT, SHEATH_DX)[3]
                j64 = S.sheath_deposit_plain(got[0].double(), vals.double(),
                                             act1.double(), w.double(), ng, **kw)
                a, rel = rel_err(j64, got[-1])
                errs = {"j": dict(abs=a, err=rel, kind="rel vs float64", tol=dtol)}
                a, rel = rel_err(ref[-1], got[-1])
                errs["j_plain"] = dict(abs=a, err=rel, kind="rel", tol=dtol)
                for node in (0, ng - 1):
                    a, rel = rel_err(j64[node], got[-1][node])
                    errs[f"j[{node}] (wall node)"] = dict(
                        abs=a, err=rel, kind="rel vs float64 sum", tol=TOL_DEP)
                err = _check(errs, f"{name}(ng={ng})")
                log(f"[sheath kernels]   {name}: {', '.join(labels)} bit-equal to "
                    f"the plain version's, the current bit-equal from call to "
                    f"call; {int((act1 == -1).sum())} rows lost "
                    f"left, {int((act1 == 0).sum())} right")
                if n == N_SHEATH and ng == NG_SHEATH:
                    records[name] = _rec(
                        err, device_ms(lambda: fn(*args, **kw)),
                        cuda_ms(lambda: plain(*args, **kw), **fast), name, n)
                del got, ref, j64, vals
            # the wall charge alone: u0 = qm = 0, so an active row deposits
            # 0 and the wall nodes hold only the lost rows' charge, held
            # against the exact sums (of the summed magnitudes: the signs
            # cancel)
            zero = torch.zeros_like(u0)
            terms = w.double() * (SHEATH_DX * SHEATH_DX / SHEATH_DT)
            for name, fn in (("sheath_picard", S.sheath_picard),
                             ("sheath_finalize", S.sheath_finalize)):
                got = fn(es, ps, p0, zero, zero, w, act, **kw)
                act1, j = got[-2], got[-1].double()
                exact = torch.stack([terms[act1 == -1].sum(), -terms[act1 == 0].sum()])
                mag = float(terms.abs()[act1 != 1].sum())
                wall_err = float((j[[0, -1]] - exact).abs().max()) / mag
                inner = float(j[1:-1].abs().max())
                _check({"wall nodes": dict(abs=wall_err * mag, err=wall_err,
                                           kind="of the wall charge", tol=TOL_DEP),
                        "inner nodes": dict(abs=inner, err=inner, kind="abs",
                                            tol=0.0)},
                       f"{name}(ng={ng}, wall charge only)")
            del args, es, ps, p0, u0, qm, w, act, zero, terms, got, j

        # the deterministic deposit at the sheath path's shapes: the currents
        # of the composed pass (ng = 51, bounded) and the exit histograms
        # (2 x 64 bins, integer positions, weight 1 on ~1% of the rows)
        hist_nodes = 2 * 64
        p = torch.rand(n, generator=gen, device=dev) * (NG_SHEATH - 1)
        vals = torch.randn(n, generator=gen, device=dev) * 1e3
        idx = torch.randint(0, hist_nodes, (n,), generator=gen, device=dev).float()
        hits = (torch.rand(n, generator=gen, device=dev) < 0.01).float()
        for label, pos, val, ng in (("current", p, vals, NG_SHEATH),
                                    ("histogram", idx, hits, hist_nodes)):
            got = K.deposit_det(pos, val, ng, periodic=False)
            if not torch.equal(K.deposit_det(pos, val, ng, periodic=False), got):
                raise AssertionError(f"deposit_det({label}): differs from call to call")
            ref = K.deposit_plain(pos, val, ng, periodic=False)
            f64 = K.deposit_plain(pos.double(), val.double(), ng, periodic=False)
            torch.cuda.synchronize()
            a, rel = rel_err(f64, got)
            errs = {"out": dict(abs=a, err=rel, kind="rel vs float64", tol=TOL_DEP)}
            a, rel = rel_err(ref, got)
            errs["out_plain"] = dict(abs=a, err=rel, kind="rel", tol=deposit_tol(n, ng))
            err = _check(errs, f"deposit_det({label}, n={n}, ng={ng})")
            log(f"[sheath kernels]   deposit_det({label}): bit-equal from call to call")
            if n == N_SHEATH and label == "current":
                records["deposit_det"] = _rec(
                    err, device_ms(lambda: K.deposit_det(p, vals, NG_SHEATH,
                                                         periodic=False)),
                    cuda_ms(lambda: K.deposit_plain(p, vals, NG_SHEATH,
                                                    periodic=False), **fast),
                    "deposit_det", n)
            del got, ref, f64
        del p, vals, idx, hits

        p = torch.rand(n, generator=gen, device=dev) * 50.0
        v = torch.randn((3, n), generator=gen, device=dev) * 1e5
        act = torch.where(torch.rand(n, generator=gen, device=dev) < 0.8, 1.0,
                          torch.where(torch.rand(n, generator=gen, device=dev) < 0.5,
                                      0.0, -1.0))
        sig = torch.where(torch.rand(n, generator=gen, device=dev) < 0.5, 1.3e6, 3.1e4)
        rargs = (p, v[0], v[1], v[2], act, sig, 0.5 * sig)
        key, step = (0, 3), 11
        worst = 0.0
        for gamma in (0.0, 0.5):
            u = cuda_rng.sheath_uniforms(key, step, n, gamma=gamma, device=dev)
            if not torch.equal(u.cpu(), cuda_rng.sheath_uniforms(
                    key, step, n, gamma=gamma, device="cpu")):
                raise AssertionError("sheath_reinject: the kernel's Philox uniforms "
                                     "differ from reinject_bits_plain's")
            got = cuda_rng.sheath_reinject(key, step, *rargs, cells=50.0, gamma=gamma)
            ref = cuda_rng.sheath_reinject_plain(key, step, *rargs, cells=50.0,
                                                 gamma=gamma)
            torch.cuda.synchronize()
            if not torch.equal(got[0], ref[0]):
                raise AssertionError("sheath_reinject: positions differ from the "
                                     "plain version's")
            errs = {}
            for k, r_, g_ in zip(("u", "vy", "vz"), ref[1:], got[1:]):
                a, rel = rel_err(r_, g_)
                errs[k] = dict(abs=a, err=rel, kind="rel", tol=TOL_SOURCE)
            worst = max(worst, _check(errs, f"sheath_reinject(gamma={gamma})"))
            log(f"[sheath kernels]   sheath_reinject(gamma={gamma}): "
                f"{u.shape[0] * n} Philox uniforms and the positions bit-equal to "
                f"the plain version's")
            del u, got, ref
        if n == N_SHEATH:
            call = lambda: cuda_rng.sheath_reinject(  # noqa: E731
                key, step, *rargs, cells=50.0)
            records["sheath_reinject"] = _rec(
                worst, device_ms(call),
                cuda_ms(lambda: cuda_rng.sheath_reinject_plain(
                    key, step, *rargs, cells=50.0), **fast),
                "sheath_reinject", n)
            log(f"[sheath kernels]   sheath_reinject: {queued_ms(call):.4f} ms a "
                f"call from CUDA events behind a queued sleep (device_ms's "
                f"fallback) beside the profiler's "
                f"{records['sheath_reinject']['ms']:.4f} ms")
            g = torch.Generator(device=dev).manual_seed(5)
            records["sheath_reinject"]["library_ms"] = device_ms(
                lambda: torch.rand((5, n), device=dev, generator=g))
            log(f"[sheath kernels]   sheath_reinject: library call torch.rand((5, n)) "
                f"{records['sheath_reinject']['library_ms']:.4f} ms")
        del p, v, act, sig, rargs
        torch.cuda.empty_cache()
    records["deposit_det"]["versus_atomic"] = _deposit_det_cost(dev, gen)
    return records


def _deposit_det_cost(dev, gen) -> list:
    """The deterministic deposit beside the float-atomic one at the sheath
    path's shape and at the other engines' deposit shapes (the headline's
    n = 6104 * 16384, ng = 200, periodic; n = 999,996, ng = 600, bounded):
    device ms of each (profiler; CUDA events at the headline n)."""
    from pypic_tpu_torch.ops import cuda_cic as K

    rows = []
    for n, ng, periodic in ((N_SHEATH, NG_SHEATH, False), (N_HEADLINE, NG, True),
                            (N_MAG, NG_MAG, False)):
        p = torch.rand(n, generator=gen, device=dev) * (ng if periodic else ng - 1)
        vals = torch.randn(n, generator=gen, device=dev)
        timer = cuda_ms if n == N_HEADLINE else device_ms
        kw = dict(periodic=periodic)
        a, rel = rel_err(K.deposit(p, vals, ng, **kw), K.deposit_det(p, vals, ng, **kw))
        row = dict(n=n, ng=ng, periodic=periodic,
                   atomic_ms=timer(lambda: K.deposit(p, vals, ng, **kw)),
                   det_ms=timer(lambda: K.deposit_det(p, vals, ng, **kw)),
                   rel_gap=rel)
        log(f"[sheath kernels]   deposit_det against deposit at n = {n}, ng = {ng}"
            f"{' periodic' if periodic else ''}: {row['det_ms']:.4f} ms against "
            f"{row['atomic_ms']:.4f} ms (x {row['det_ms'] / row['atomic_ms']:.2f}); "
            f"outputs {rel:.2e} apart")
        if not rel <= deposit_tol(n, ng):
            raise AssertionError(f"deposit_det and deposit disagree: {rel}")
        rows.append(row)
        del p, vals
        torch.cuda.empty_cache()
    return rows


def _sheath_step_errors(c, g) -> dict:
    """One step on the CPU (c) and the card (g), each (state, metrics):
    the errors of TOL_SHEATH_STEP's quantities."""
    sc, mc = c
    sg, mg = g
    act = sc.active == 1
    return {"p (cells)": float((sg.p.cpu()[act].double() - sc.p[act].double()).abs().max()),
            "u": rel_err(sc.u, sg.u.cpu())[1], "e": rel_err(sc.e, sg.e.cpu())[1],
            "j": rel_err(sc.j, sg.j.cpu())[1], "phi": rel_err(mc.phi, mg.phi.cpu())[1]}


def _sheath_population(m, n: int) -> list:
    tot = (m.n_active + m.n_lost_left + m.n_lost_right).cpu()
    return [] if bool((tot == n).all()) else [
        f"n_active + losses in [{int(tot.min())}, {int(tot.max())}], n = {n}"]


def phase_sheath_check(dev) -> dict:
    """sheath_dd at n = 12,000 on the card against the CPU, both backends,
    the same Philox draws; 200 steps each side; then the wall-potential
    test on the card."""
    import dataclasses

    from pypic_tpu_torch import interop, presets
    from pypic_tpu_torch.diagnostics import floor_exit_counts_agree
    from pypic_tpu_torch.engines import sheath
    from pypic_tpu_torch.runner import run
    from pypic_tpu_torch.tools import sheath as row

    pre = presets.sheath_dd(n=SHEATH_CHECK_N, device="cpu")
    base = dataclasses.replace(pre.config, record_exit_after_step=0,
                               picard_init="extrapolate", picard_accel="anderson")
    cfgs = {b: dataclasses.replace(base, backend=b) for b in ("fused", "composed")}
    snaps, st = {}, pre.state
    step_cpu = sheath.make_step(cfgs["fused"])
    for i in range(max(SHEATH_CHECK_AT) + 1):
        if i in SHEATH_CHECK_AT:
            snaps[i] = interop.sheath_state_to_numpy(st)
        if i < max(SHEATH_CHECK_AT):
            st, _ = step_cpu(st)
    problems = []
    for backend, cfg in cfgs.items():
        step = sheath.make_step(cfg)
        for i, d in snaps.items():
            c = step(interop.sheath_state_from_numpy(d, "cpu"))
            g = step(interop.sheath_state_from_numpy(d, dev))
            errs = _sheath_step_errors(c, g)
            ok, line = floor_exit_counts_agree(
                c[1].picard_iters, float(c[1].picard_residual),
                g[1].picard_iters, float(g[1].picard_residual), d["e"],
                c[0].e, tol=cfg.tol, tol_floor=cfg.tol_floor)
            losses = {k: (int(getattr(c[1], k)), int(getattr(g[1], k)))
                      for k in ("n_lost_left", "n_lost_right")}
            same_act = torch.equal(c[0].active, g[0].active.cpu())
            same_hist = torch.equal(c[0].exit_hist, g[0].exit_hist.cpu())
            log(f"[sheath check] {backend}, step {i} -> {i + 1}, GPU vs CPU: "
                + ", ".join(f"{k} {v:.3e} (tol {TOL_SHEATH_STEP[k]:.0e})"
                            for k, v in errs.items())
                + f"; Picard (CPU, GPU) {line}; losses (CPU, GPU) {losses}; statuses "
                f"{'equal' if same_act else 'DIFFER'}; exit histograms "
                f"{'equal' if same_hist else 'DIFFER'}")
            bad = {k: v for k, v in errs.items() if not v <= TOL_SHEATH_STEP[k]}
            if not ok:
                bad["picard_iters"] = line
            if any(a != b for a, b in losses.values()) or not same_act or not same_hist:
                bad["losses"] = losses
            if bad:
                problems.append(f"{backend} step {i}: {bad}")
    te_volts = row.K_BOLTZMANN * row.TE / row.E_CHARGE
    avg, iters = {}, {}
    for label, device in (("CPU", "cpu"), ("GPU", dev)):
        s0 = interop.sheath_state_from_numpy(snaps[0], device)
        _, m = run(sheath.make_step(cfgs["fused"]), s0, SHEATH_CHECK_STEPS)
        avg[label] = m.phi[-100:].double().mean(dim=0).cpu()
        iters[label] = m.picard_iters.cpu()
        pop = _sheath_population(m, SHEATH_CHECK_N)
        log(f"[sheath check] {SHEATH_CHECK_STEPS} steps on the {label}: Picard mean "
            f"{float(m.picard_iters.float().mean()):.3f}, wall losses "
            f"{int((m.n_lost_left + m.n_lost_right).sum())}; population invariant "
            + ("holds" if not pop else f"FAILS: {pop}"))
        problems += [f"{label}: {x}" for x in pop]
    # the trajectories part by round-off, and a floor exit is decided at
    # round-off: step counts differ here and there, their means hardly
    apart = (iters["GPU"] - iters["CPU"]).abs()
    means = {k: float(v.float().mean()) for k, v in iters.items()}
    log(f"[sheath check] {SHEATH_CHECK_STEPS}-step Picard counts, GPU vs CPU: "
        f"{int((apart == 0).sum())} steps equal, {int((apart == 1).sum())} one "
        f"pass apart, {int((apart > 1).sum())} more; means {means} (tol "
        f"{SHEATH_PICARD_MEAN_RTOL:.0%})")
    if not abs(means["GPU"] - means["CPU"]) <= SHEATH_PICARD_MEAN_RTOL * means["CPU"]:
        problems.append(f"Picard means {means}")
    gap = float((avg["GPU"] - avg["CPU"]).abs().max()) / te_volts
    log(f"[sheath check] phi averaged over steps {SHEATH_CHECK_STEPS - 100}-"
        f"{SHEATH_CHECK_STEPS - 1}, GPU vs CPU: {gap:.4e} Te/e "
        f"(tol {TOL_SHEATH_PHI_AVG})")
    if not gap <= TOL_SHEATH_PHI_AVG:
        problems.append(f"time-averaged phi {gap} Te/e apart")

    # tests/test_sheath.py:41-57 at its own setting, on the card
    grid = pre.config.grid
    from pypic_tpu_torch import initialize
    d = initialize.initialize_sheath(SHEATH_WALL_N, 1e19, 1.0, 0.0, grid, row.TE,
                                     row.TI, seed=3)
    cfg = dataclasses.replace(pre.config, p2c=grid.length * 1e19 / SHEATH_WALL_N,
                              record_exit_after_step=300)
    st = sheath.init_state(d["x"], d["v"], d["q"], d["m"], d["species"], cfg,
                           seed=1, device=dev)
    t0 = time.perf_counter()
    fin, m = run(sheath.make_step(cfg), st, SHEATH_WALL_STEPS)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    left, right = row.wall_drops(m, 300)
    phi = m.phi[-300:].double().mean(dim=0)
    top = int(torch.argmax(phi))
    log(f"[sheath check] wall potential, n = {SHEATH_WALL_N}, {SHEATH_WALL_STEPS} "
        f"steps on the card ({secs * 1e6 / SHEATH_WALL_STEPS:.1f} us/step): drops "
        f"{left:.4f} (left), {right:.4f} (right) Te/e, maximum at node {top} of "
        f"{phi.shape[0]}, exits recorded {float(fin.exit_hist.sum()):.0f}")
    if not (-4.0 < left < -0.5 and -4.0 < right < -0.5 and 0 < top < phi.shape[0] - 1):
        problems.append(f"wall drops {left}, {right} Te/e, maximum at node {top}")
    problems += _sheath_population(m, SHEATH_WALL_N)
    if problems:
        raise AssertionError("sheath check: " + "; ".join(problems))
    return dict(phi_avg_gap_te=gap, wall_drop_left_te=left, wall_drop_right_te=right)


def phase_sheath_slice(dev) -> dict:
    """bench.py's configs[2] row through tools/sheath.py, then the
    composed backend."""
    from pypic_tpu_torch.ops import cuda_cic
    from pypic_tpu_torch.tools import sheath as row

    res, cfg, fin, m = row.run_row(dev)
    steps = row.STEPS
    launches = res["launches"]
    want = dict(sheath_picard=res["picard_sum"], sheath_finalize=steps,
                sheath_reinject=steps)
    syncs = res["syncs"]
    log(f"[sheath slice] configs[2] row: n = {res['n']}, ng = {NG_SHEATH}, {steps} "
        f"steps: {res['us_per_step']:.3f} us/step, {res['pushes_per_s']:.4e} "
        f"pushes/s, Picard mean {res['picard_mean']:.3f} (max {res['picard_max']}), "
        f"wall drops (last 300 steps) {res['wall_drop_left_te']:.4f}, "
        f"{res['wall_drop_right_te']:.4f} Te/e, wall losses "
        f"{res['lost_per_step']:.1f}/step")
    log(f"[sheath slice] configs[2] row: launches {launches}; host syncs "
        f"{syncs['host_syncs_per_step']:.3f}/step against "
        f"{syncs['host_reads_per_step']:.3f} engine reads and "
        f"{syncs['picard_passes_per_step']:.3f} Picard passes a step "
        f"({row.SYNC_STEPS} more steps under sync debug mode 'warn'; sites "
        f"{syncs['sync_sites']}); steps at maxiter {res['steps_at_maxiter']}")
    problems = row.check_row(cfg, fin, m)
    if launches != want:
        problems.append(f"launches {launches} != {want}")
    if res["picard_max"] > cfg.maxiter:
        problems.append(f"Picard max {res['picard_max']}")
    if syncs["host_syncs_per_step"] != syncs["host_reads_per_step"]:
        problems.append(f"host syncs {syncs}")
    del fin, m
    res_c, _, fin, m = row.run_row(dev, steps=SHEATH_COMPOSED_STEPS,
                                   backend="composed", sync_steps=0)
    passes = res_c["picard_sum"]
    want_c = dict(gather=passes, deposit_det=2 * passes,
                  sheath_reinject=SHEATH_COMPOSED_STEPS)
    log(f"[sheath slice] backend='composed': {SHEATH_COMPOSED_STEPS} steps, "
        f"{res_c['us_per_step']:.3f} us/step, Picard mean "
        f"{res_c['picard_mean']:.3f}, launches {res_c['launches']}")
    problems += [f"composed: {x}" for x in _sheath_population(m, res_c["n"])]
    if res_c["launches"] != want_c:
        problems.append(f"composed launches {res_c['launches']} != {want_c}")
    if not bool(torch.isfinite(fin.p).all() and torch.isfinite(m.phi).all()):
        problems.append("composed: non-finite state")
    if problems:
        raise AssertionError("sheath slice: " + "; ".join(problems))
    res["composed"] = res_c
    cuda_cic.reset_launch_counts()
    torch.cuda.empty_cache()
    return res



def _dn_cases(dev):
    """tests/test_pallas.py:361-389's inputs (number densities) at
    DN_CASES."""
    import numpy as np

    for ng in DN_CASES:
        rng = np.random.default_rng(13 + ng)
        dens = (1e17 * (1.0 + 0.3 * rng.standard_normal(ng))).clip(1e15)
        yield ng, torch.from_numpy(dens.astype(np.float32)).to(dev)


def phase_dn_kernels(dev) -> dict:
    """The D-N Newton kernel against its plain version and the op-composed
    Thomas route (on the CPU) at DN_CASES, cold and warm; timed on the D-N
    row's first solve (µs per iteration). The tagged Philox uniforms of the
    flux draw and the gyro-phases bit-equal to the plain version's at the
    rows' n, timed at the D-N row's shape."""
    from pypic_tpu_torch.ops import cuda_cic as K
    from pypic_tpu_torch.ops import cuda_newton, cuda_rng
    from pypic_tpu_torch.tools import magnetized as row

    n0 = torch.tensor(0.9e17, dtype=torch.float32, device=dev)
    te, dx = 116000.0, 2e-5
    worst = 0.0
    for ng, dens in _dn_cases(dev):
        cold = torch.zeros(ng, dtype=torch.float32, device=dev)
        thomas0 = poisson.solve_boltzmann_dirichlet_neumann(
            dens.cpu(), float(n0), te, dx, cold.cpu())
        for warm in (False, True):
            phi0 = thomas0.phi.to(dev) if warm else cold
            got = K.LAUNCHES["boltzmann_dn"]
            res = cuda_newton.boltzmann_dn(dens, n0, te, dx, phi0)
            if K.LAUNCHES["boltzmann_dn"] != got + 1:
                raise AssertionError("boltzmann_dn: no launch counted")
            ref = cuda_newton.boltzmann_dn_plain(dens, n0, te, dx, phi0)
            thomas = (poisson.solve_boltzmann_dirichlet_neumann(
                dens.cpu(), float(n0), te, dx, phi0.cpu()) if warm else thomas0)
            gi, ri, ti = (int(res.iterations), int(ref.iterations),
                          int(thomas.iterations))
            errs = {}
            for label, r in (("phi", ref.phi), ("phi_thomas", thomas.phi)):
                a, rel = rel_err(r.to(dev), res.phi)
                errs[label] = dict(abs=a, err=rel, kind="rel", tol=TOL_DN_PHI)
            # counts and the residual carry abs 0: max_abs_err is phi's
            for label, other in (("iterations", ri), ("iterations_thomas", ti)):
                gap = float(abs(gi - other))
                errs[label] = dict(abs=0.0, err=gap, kind=f"count gap ({gi} vs {other})",
                                   tol=0.0 if warm and label == "iterations" else 1.0)
            errs["residual"] = dict(abs=0.0, err=float(res.residual),
                                    kind="<= tol", tol=1e-3)
            worst = max(worst, _check(errs, f"boltzmann_dn(ng={ng}, "
                                            f"{'warm' if warm else 'cold'})"))
    # timed on the D-N row's first solve: its deposit, n0 = 0.9 <n>, the
    # state's phi (0) as the warm start
    pre = row.preset("dn", dev)
    cfg, st = pre.config, pre.state
    _, n_dens = K.deposit2(st.p, st.p2c / cfg.grid.dx, st.p2c / cfg.grid.dx,
                           NG_DN, periodic=False)
    n0 = 0.9 * torch.mean(n_dens)
    phi0 = torch.zeros(NG_DN, dtype=torch.float32, device=dev)
    got = cuda_newton.boltzmann_dn(n_dens, n0, cfg.te, cfg.grid.dx, phi0)
    ref = cuda_newton.boltzmann_dn_plain(n_dens, n0, cfg.te, cfg.grid.dx, phi0)
    iters = int(got.iterations)
    a, rel = rel_err(ref.phi, got.phi)
    worst = max(worst, _check(
        {"phi": dict(abs=a, err=rel, kind=f"rel ({iters} vs plain "
                     f"{int(ref.iterations)} iterations)", tol=TOL_DN_PHI)},
        "boltzmann_dn(the D-N row's first solve)"))
    records = {}
    fast = dict(reps=3, calls=3)
    records["boltzmann_dn"] = _rec(
        worst, device_ms(lambda: cuda_newton.boltzmann_dn(
            n_dens, n0, cfg.te, cfg.grid.dx, phi0)),
        cuda_ms(lambda: cuda_newton.boltzmann_dn_plain(
            n_dens, n0, cfg.te, cfg.grid.dx, phi0), **fast),
        "boltzmann_dn", NG_DN, iters)
    rec = records["boltzmann_dn"]
    rec["iterations"] = iters
    rec["us_per_iteration"] = rec["ms"] * 1e3 / iters
    log(f"[dn kernels]   boltzmann_dn at ng = {NG_DN}: {iters} iterations, "
        f"{rec['us_per_iteration']:.3f} us per iteration")
    del st, pre

    for n in (row.N_DN, N_MAG):
        for ndraw, tag in ((8, cuda_rng.FLUX_TAG), (3, cuda_rng.GYRO_TAG)):
            u = cuda_rng.philox_uniforms((0, 1), 7, n, ndraw, tag, device=dev)
            ref = cuda_rng.philox_uniforms((0, 1), 7, n, ndraw, tag, device="cpu")
            if not torch.equal(u.cpu(), ref):
                raise AssertionError(f"philox_uniforms(tag {tag}) differs from "
                                     "philox_uniforms_plain")
            log(f"[dn kernels]   philox_uniforms: {ndraw} x {n} uniforms (tag "
                f"{tag}) bit-equal to the plain version's")
    n = row.N_DN
    call = lambda: cuda_rng.philox_uniforms(  # noqa: E731
        (0, 1), 7, n, 8, cuda_rng.FLUX_TAG, device=dev)
    records["philox_uniforms"] = _rec(
        0.0, device_ms(call),
        cuda_ms(lambda: cuda_rng.philox_uniforms_plain(
            (0, 1), 7, n, 8, cuda_rng.FLUX_TAG, dev), **fast),
        "philox_uniforms", n)
    g = torch.Generator(device=dev).manual_seed(5)
    records["philox_uniforms"]["library_ms"] = device_ms(
        lambda: torch.rand((8, n), device=dev, generator=g))
    return records


def _one_step_pairs(label, pre_cpu, cfg_cpu, cfg_gpu, at, dev, draws):
    """One step from the CPU run's states after ``at`` steps, on the CPU
    (cfg_cpu) and the card (cfg_gpu), the same draws replayed on both
    (``draws(state, step) -> make_step keyword arguments``); returns the
    problems."""
    from pypic_tpu_torch import interop
    from pypic_tpu_torch.engines import magnetized

    snaps, st = {}, pre_cpu.state
    step_cpu = magnetized.make_step(cfg_cpu)
    for i in range(max(at) + 1):
        if i in at:
            snaps[i] = interop.magnetized_state_to_numpy(st)
        if i < max(at):
            st, _ = step_cpu(st)
    problems = []
    for i, d in snaps.items():
        sc = interop.magnetized_state_from_numpy(d, "cpu")
        kw_c, kw_g = draws(sc, dev)
        c = magnetized.make_step(cfg_cpu, **kw_c)(sc)
        g = magnetized.make_step(cfg_gpu, **kw_g)(
            interop.magnetized_state_from_numpy(d, dev))
        errs = _mag_step_errors(c, g)
        counts = {k: (int(getattr(c[1], k)), int(getattr(g[1], k)))
                  for k in ("n_hit_wall", "n_reactivated", "newton_iters",
                            "n_active")}
        log(f"[{label}] n = {pre_cpu.state.p.shape[0]}, step {i} -> {i + 1}, GPU vs "
            "CPU, |d| / (atol + rtol |ref|) (<= 1 passes): "
            + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
            + f"; counts (CPU, GPU) {counts}")
        bad = {k: v for k, v in errs.items() if not v <= 1.0}
        for k in ("n_active", "n_reactivated"):
            if counts[k][0] != counts[k][1]:
                bad[k] = counts[k]
        if bad:
            problems.append(f"step {i}: {bad}")
    return problems, snaps


def _replayed(key_fn):
    """make_step keyword arguments replaying CPU-made draws on both sides:
    ``key_fn(state) -> {hook name: (step, n) -> CPU tensors}``."""
    def draws(state, dev):
        hooks = key_fn(state)
        on = {name: (lambda f: (lambda s, k: _to(f(s, k), dev)))(f)
              for name, f in hooks.items()}
        return hooks, on
    return draws


def _to(x, dev):
    if isinstance(x, dict):
        return {k: v.to(dev) for k, v in x.items()}
    return x.to(dev)


def phase_dn_check(dev) -> dict:
    """dirichlet_neumann_test at n = 12,000 on the card ('auto': fused, the
    D-N Newton kernel, the Philox flux draw) against the CPU (the same
    fused path and Newton PCR in their plain versions): one step from the
    states after 0/10/50 steps with the same flux draws (made on the CPU)
    on both sides; then DN_CHECK_STEPS steps each, each side's own draws."""
    import dataclasses

    from pypic_tpu_torch import interop, presets, sources
    from pypic_tpu_torch.engines import magnetized
    from pypic_tpu_torch.runner import run

    pre = presets.dirichlet_neumann_test(n=DN_CHECK_N, device="cpu")
    cfg_cpu = dataclasses.replace(pre.config, backend="fused",
                                  newton_backend="pallas")
    src = cfg_cpu.source

    def hooks(state):
        def flux(step, n):
            return sources.sample_flux_batch(
                state.rng, step, n, cfg_cpu.grid, src.ti, src.mass, vx=src.vx,
                gamma=cfg_cpu.flux_gamma, vx_pert=cfg_cpu.flux_vx_pert,
                device="cpu")
        return {"source_draws": flux}

    problems, snaps = _one_step_pairs("dn check", pre, cfg_cpu, pre.config,
                                      DN_CHECK_AT, dev, _replayed(hooks))
    out = {}
    for label, cfg, device in (("CPU", cfg_cpu, "cpu"), ("GPU", pre.config, dev)):
        s0 = interop.magnetized_state_from_numpy(snaps[0], device)
        _, m = run(magnetized.make_step(cfg), s0, DN_CHECK_STEPS)
        out[label] = dict(n0=float(m.n0[-100:].double().mean()),
                          phi_max=float(m.phi_max[-100:].double().mean()),
                          react_max=int(m.n_reactivated.max()),
                          newton_mean=float(m.newton_iters.float().mean()))
        log(f"[dn check] {DN_CHECK_STEPS} steps on the {label}: {out[label]}")
        if out[label]["react_max"] > cfg.flux_limit:
            problems.append(f"{label}: flux cap {out[label]['react_max']}")
        if not bool(torch.isfinite(m.phi).all()):
            problems.append(f"{label}: non-finite phi")
    rels = {k: abs(out["GPU"][k] - out["CPU"][k]) / abs(out["CPU"][k])
            for k in ("n0", "phi_max")}
    log(f"[dn check] last-100-step means GPU vs CPU: {rels} (tol {DN_MEAN_RTOL})")
    for k, v in rels.items():
        if not v <= DN_MEAN_RTOL:
            problems.append(f"{k} means {out['CPU'][k]} vs {out['GPU'][k]}")
    if problems:
        raise AssertionError("dn check: " + "; ".join(problems))
    return dict(means_rel=rels)


def phase_dn_slice(dev) -> dict:
    """The D-N row through tools/magnetized.py: 1,200 steps under sync
    debug mode 'error', exactly 1,200 launches of deposit2, boltzmann_dn,
    boris_gather_push and the flux draw's philox_uniforms, nothing else;
    the row's checks."""
    from pypic_tpu_torch.ops import cuda_cic
    from pypic_tpu_torch.tools import magnetized as row

    res, cfg, fin, m = row.run_row(dev, row="dn")
    steps = row.STEPS
    want = {k: 0 for k in cuda_cic.LAUNCHES}
    want.update(deposit2=steps, boltzmann_dn=steps, boris_gather_push=steps,
                philox_uniforms=steps)
    launches = dict(cuda_cic.LAUNCHES)
    res["launches"] = launches
    log(f"[dn slice] dirichlet_neumann_test: n = {res['n']}, ng = {NG_DN}, "
        f"{steps} steps under sync debug mode 'error' (0 host syncs): "
        f"{res['us_per_step']:.3f} us/step, {res['pushes_per_s']:.4e} "
        f"pushes/s, Newton mean {res['newton_mean']:.3f} (max "
        f"{res['newton_max']}), n0 last/first {res['n0_last_over_first']:.4f}, "
        f"phi (last 100 steps) wall {res['phi_wall']:.3e} V, far end "
        f"{res['phi_far']:.4f} V, re-activations {res['react_per_step']:.2f}"
        f"/step (max {res['react_max']})")
    log(f"[dn slice] launches {launches}")
    problems = row.check_dn_row(cfg, fin, m)
    if launches != want:
        problems.append(f"launches {launches} != {want}")
    if problems:
        raise AssertionError("dn slice: " + "; ".join(problems))
    torch.cuda.empty_cache()
    return res


def phase_gc_check(dev) -> dict:
    """pic_iead_gc at n = 12,000 on the card (composed, the D-D Newton
    kernel, the source and gyro-phase kernels) against the CPU (plain
    versions): one step from the states after 0/10/50 steps with the same
    source and gyro-phase draws (made on the CPU) on both sides."""
    import dataclasses

    from pypic_tpu_torch import presets, sources
    from pypic_tpu_torch.ops import cuda_rng

    pre = presets.pic_iead_gc(n_per_species=GC_CHECK_PER_SPECIES, device="cpu")
    cfg_cpu = dataclasses.replace(pre.config, newton_backend="pallas")
    src = cfg_cpu.source

    def hooks(state):
        return {
            "source_draws": lambda step, n: sources.sample_source_batch(
                state.rng, step, n, cfg_cpu.grid, src.ti, src.mass, vx=src.vx,
                device="cpu"),
            "gyro_draws": lambda step, n: cuda_rng.philox_uniforms(
                state.rng, step, n, 3, cuda_rng.GYRO_TAG, device="cpu").t(),
        }

    problems, _ = _one_step_pairs("gc check", pre, cfg_cpu, pre.config,
                                  GC_CHECK_AT, dev, _replayed(hooks))
    if problems:
        raise AssertionError("gc check: " + "; ".join(problems))
    return {}


def phase_gc_slice(dev) -> dict:
    """The GC row through tools/magnetized.py: pic_iead_gc at n = 999,996,
    1,200 steps under sync debug mode 'error'; per step two deposits and
    the IEAD's, one gather, one D-D Newton kernel, one source batch and one
    gyro-phase draw, nothing else; the row's checks."""
    from pypic_tpu_torch.ops import cuda_cic
    from pypic_tpu_torch.tools import magnetized as row

    res, cfg, fin, m = row.run_row(dev, row="gc")
    steps = row.STEPS
    want = {k: 0 for k in cuda_cic.LAUNCHES}
    want.update(deposit=3 * steps, gather=steps, boltzmann_dirichlet=steps,
                source_batch=steps, philox_uniforms=steps)
    launches = dict(cuda_cic.LAUNCHES)
    res["launches"] = launches
    gc_rows = (fin.active == 1) & (fin.mode == 1)
    log(f"[gc slice] pic_iead_gc: n = {res['n']}, ng = {NG_MAG}, {steps} steps "
        f"under sync debug mode 'error' (0 host syncs): {res['us_per_step']:.3f} "
        f"us/step, {res['pushes_per_s']:.4e} pushes/s, Newton mean "
        f"{res['newton_mean']:.3f} (max {res['newton_max']}), phi_max / phi_f "
        f"(last 100 steps) {res['phi_max_over_phi_f']:.4f}, wall losses "
        f"{int(m.n_hit_wall.sum())}, IEAD counts "
        f"{fin.iead.sum(dim=(1, 2)).cpu().tolist()}, active guiding centers "
        f"{int(gc_rows.sum())}")
    log(f"[gc slice] launches {launches}")
    problems = row.check_gc_row(cfg, fin, m)
    if launches != want:
        problems.append(f"launches {launches} != {want}")
    if problems:
        raise AssertionError("gc slice: " + "; ".join(problems))
    torch.cuda.empty_cache()
    return res


def phase_size_limits(dev) -> dict:
    """The card's size limits: each wrapper raises above its limit on CUDA
    tensors (and ran the plain version on CPU tensors in the CPU tests);
    a magnetized step at ng = NG_FAULT with newton_backend 'auto' takes the
    op-composed Thomas route (no Newton kernel launch), and 'pallas' there
    raises naming ROADMAP item 10."""
    import dataclasses

    from pypic_tpu_torch import presets
    from pypic_tpu_torch.engines import magnetized
    from pypic_tpu_torch.ops import cuda_cic as K
    from pypic_tpu_torch.ops import cuda_newton, cuda_sheath

    z = lambda k: torch.zeros(k, dtype=torch.float32, device=dev)  # noqa: E731
    p, big = z(64), K.SMEM_LIMIT // 4 + 1
    kw = dict(qm=-1.7e11, w=-3.2e-9, dt=1e-7, dx=0.05)
    calls = {
        "picard_iteration": lambda: K.picard_iteration(
            z(K.SMEM_LIMIT // 8 + 1), p, p, p, K.SMEM_LIMIT // 8 + 1, **kw),
        "deposit": lambda: K.deposit(p, p, big, periodic=True),
        "gather": lambda: K.gather(z(big), p, periodic=False),
        "deposit2": lambda: K.deposit2(p, p, p, K.SMEM_LIMIT // 8 + 1,
                                       periodic=False),
        "boris_gather_push": lambda: K.boris_gather_push(
            z(big), p, p, p, p, p, p, b=(0.0, 1.0, 0.0), dt_dx=1.0),
        "deposit_det": lambda: K.deposit_det(p, p, 1817, periodic=False),
        "sheath_picard": lambda: cuda_sheath.sheath_picard(
            z(1817), p, p, p, p, p, p, dt=1e-12, dx=1e-5),
        "boltzmann_dirichlet": lambda: cuda_newton.boltzmann_dirichlet(
            z(1025), 1e17, 1.16e5, 2e-5),
        "boltzmann_dn": lambda: cuda_newton.boltzmann_dn(
            z(1025), 1e17, 1.16e5, 2e-5, z(1025)),
    }
    K.reset_launch_counts()
    for name, call in calls.items():
        try:
            call()
        except ValueError as e:
            log(f"[size limits] {name} on the card raises: {str(e)[:100]}")
        else:
            raise AssertionError(f"{name} ran above its limit on the card")
    if any(K.LAUNCHES.values()):
        raise AssertionError(f"launches above the limits: {K.LAUNCHES}")
    pre = presets.pic_iead(n_per_species=500, ng=NG_FAULT, device=dev)
    try:
        magnetized.make_step(dataclasses.replace(
            pre.config, newton_backend="pallas"))(pre.state)
    except ValueError as e:
        if "item 10" not in str(e):
            raise
        log(f"[size limits] newton_backend='pallas' at ng = {NG_FAULT} raises: "
            f"{str(e)[:100]}")
    else:
        raise AssertionError("newton_backend='pallas' ran at ng > 1024")
    K.reset_launch_counts()
    for k in magnetized.THOMAS_SOLVES:
        magnetized.THOMAS_SOLVES[k] = 0
    t0 = time.perf_counter()
    st, m = magnetized.make_step(pre.config)(pre.state)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: v for k, v in K.LAUNCHES.items() if v}
    log(f"[size limits] a magnetized step at ng = {NG_FAULT}, 'auto': "
        f"Thomas solves {dict(magnetized.THOMAS_SOLVES)}, {int(m.newton_iters)} "
        f"Newton iterations, residual {float(m.newton_residual):.3e}, "
        f"{seconds:.2f} s, launches {launches}")
    if (magnetized.THOMAS_SOLVES["dirichlet"] != 1
            or K.LAUNCHES["boltzmann_dirichlet"] != 0):
        raise AssertionError("ng > 1024 did not take the Thomas route")
    if not (bool(torch.isfinite(m.phi).all())
            and float(m.newton_residual) <= pre.config.newton_tol):
        raise AssertionError("the Thomas route did not converge")
    return dict(thomas_step_s=seconds)

def _slab_inputs(n: int, gen: torch.Generator, dev, edges: bool):
    """A slab of the domain row: positions on [lo - 3, hi + 3] (past both
    clamp bounds; the bounds themselves and 2.5 cells past them with
    ``edges``), guesses 0.3 cells off, 5% dead slots (w = 0)."""
    f32 = torch.float32
    span = DOM_HI - DOM_LO + 6.0
    p0 = torch.rand(n, generator=gen, device=dev, dtype=f32) * span + (DOM_LO - 3.0)
    ps = p0 + torch.randn(n, generator=gen, device=dev, dtype=f32) * 0.3
    v0 = torch.randn(n, generator=gen, device=dev, dtype=f32) * 1e5
    field = torch.randn(DOM_EXT_N, generator=gen, device=dev, dtype=f32) * 30.0
    w = torch.full((n,), W, dtype=f32, device=dev)
    w[torch.rand(n, generator=gen, device=dev) < 0.05] = 0.0
    if edges:
        edge = torch.tensor([DOM_LO, DOM_HI, DOM_LO - 2.5, DOM_HI + 2.5],
                            dtype=f32, device=dev)
        p0[:4] = edge
        ps[:4] = edge
    return field, ps, p0, v0, w


def phase_domain_kernels(dev) -> dict:
    """The domain engines' four kernels against their plain versions at
    the ragged and the headline n, at the configs[4] slab's shape (ext_n
    = 231 nodes): the Picard pass (emit_v off and on; the shared window
    with its clamp count; a pass with active = 0 writes nothing), both
    finalizes in stats mode with a middle rank's offset (statistics
    bit-equal from call to call, p1, v1 and the statistics bit-equal
    between the two), and the leapfrog push at ng = 200. Deposits also
    against float64 sums of the plain version's own terms."""
    from pypic_tpu_torch.ops import cuda_domain as KD

    gen = torch.Generator(device=dev).manual_seed(17)
    qm = float(torch.tensor(QM, dtype=torch.float32))
    kw = dict(qm=qm, dt=DT, dx=DX, lo=DOM_LO, hi=DOM_HI)
    fkw = dict(kw, lo_shift=DOM_LO_SHIFT, ng=DOM_NG_WRAP)
    fast = dict(reps=3, calls=3)
    records = {}
    for n, edges in ((N_RAGGED, True), (N_HEADLINE, False)):
        log(f"[domain kernels] n = {n}, ext_n = {DOM_EXT_N}, clamp "
            f"[{DOM_LO}, {DOM_HI}], lo_shift {DOM_LO_SHIFT}, ng {DOM_NG_WRAP}"
            + (" (+ edge positions)" if edges else ""))
        args = _slab_inputs(n, gen, dev, edges)
        dtol = deposit_tol(n, DOM_EXT_N)
        err = 0.0
        for emit_v, shared in ((False, False), (True, False), (False, True)):
            pkw = dict(kw, emit_v=emit_v, shared=shared)
            got = KD.picard_iteration_ext(*args, **pkw)
            ref = KD.picard_iteration_ext_plain(*args, **pkw)
            jh = 1 + emit_v
            exact = KD.picard_iteration_ext_plain(
                *args, acc_dtype=torch.float64, **pkw)[jh]
            torch.cuda.synchronize()
            a, r = rel_err(ref[0], got[0])
            errs = {"ph": dict(abs=a, err=r, kind="rel", tol=TOL_DOM)}
            a, r = rel_err(exact, got[jh])
            errs["jh"] = dict(abs=a, err=r, kind="rel vs float64 sums", tol=TOL_DEP)
            a, r = rel_err(ref[jh], got[jh])
            errs["jh_plain"] = dict(abs=a, err=r, kind="rel", tol=dtol)
            if emit_v:
                a, r = rel_err(ref[1], got[1])
                errs["v1"] = dict(abs=a, err=r, kind="rel", tol=TOL_DOM)
            if shared:
                diff = float(abs(int(got[-1]) - int(ref[-1])))
                errs["n_clamped"] = dict(abs=diff, err=diff, kind=(
                    f"count gap ({int(got[-1])} clamped of {n})"), tol=0.0)
            err = max(err, _check(errs, f"picard_iteration_ext(emit_v={emit_v}, "
                                        f"shared={shared})"))
            del got, ref, exact
        buf = args[1].clone()
        off = torch.zeros((1,), dtype=torch.int32, device=dev)
        skipped = KD.picard_iteration_ext(args[0], buf, *args[2:], out=(buf, None),
                                          active=off, **kw)
        if not (torch.equal(buf, args[1]) and not bool(skipped[1].any())):
            raise AssertionError("picard_iteration_ext with active = 0 wrote")
        log("[domain kernels]   picard_iteration_ext with active = 0: nothing written")
        records["picard_iteration_ext"] = _rec(
            err, cuda_ms(lambda: KD.picard_iteration_ext(*args, **kw)),
            cuda_ms(lambda: KD.picard_iteration_ext_plain(*args, **kw), **fast),
            "picard_iteration_ext", n)

        outs = {}
        for name, fn, plain_kw in (
                ("picard_finalize_ext_nodep", KD.picard_finalize_ext_nodep, {}),
                ("picard_finalize_ext", KD.picard_finalize_ext, dict(deposit=True))):
            got = fn(*args, **fkw)
            again = fn(*args, **fkw)
            ref = KD.picard_finalize_ext_plain(*args, **fkw, **plain_kw)
            torch.cuda.synchronize()
            if not torch.equal(got[-1], again[-1]):
                raise AssertionError(f"{name}: the statistics differ from call to call")
            a = seam_err(ref[0], got[0], DOM_NG_WRAP)
            errs = {"p1": dict(abs=a, err=a / DOM_NG_WRAP, kind="of ng", tol=TOL_DOM)}
            a, r = rel_err(ref[1], got[1])
            errs["v1"] = dict(abs=a, err=r, kind="rel", tol=TOL_DOM)
            st, st_ref = got[-1].cpu(), ref[-1].cpu()
            for i, key in ((0, "sum w v1"), (1, "sum v1^2")):
                a, r = rel_err(st_ref[i:i + 1], st[i:i + 1])
                errs[key] = dict(abs=a, err=r, kind="rel", tol=TOL_DOM)
            diff = float(abs(st[2] - st_ref[2]))
            errs["clamps"] = dict(abs=diff, err=diff,
                                  kind=f"count gap ({int(st[2])} clamped)", tol=0.0)
            if plain_kw:
                exact = KD.picard_finalize_ext_plain(
                    *args, acc_dtype=torch.float64, **fkw, **plain_kw)[2]
                a, r = rel_err(exact, got[2])
                errs["j1"] = dict(abs=a, err=r, kind="rel vs float64 sums", tol=TOL_DEP)
                a, r = rel_err(ref[2], got[2])
                errs["j1_plain"] = dict(abs=a, err=r, kind="rel", tol=dtol)
            e = _check(errs, name)
            if not int(st[2]) > 0:
                raise AssertionError(f"{name}: no clamp counted")
            outs[name] = (got[0], got[1], got[-1])
            records[name] = _rec(
                e, cuda_ms(lambda: fn(*args, **fkw)),
                cuda_ms(lambda: KD.picard_finalize_ext_plain(*args, **fkw, **plain_kw),
                        **fast), name, n)
            del got, again, ref
        a, b = outs.values()
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            raise AssertionError("the two finalizes' p1, v1 or statistics differ")
        log("[domain kernels]   p1, v1 and the statistics bit-identical between "
            "the two finalizes")
        del outs, a, b, args
        torch.cuda.empty_cache()

        e, _, p, v = _random_pass_inputs(n, gen, dev, edges)
        lkw = dict(qm=qm, dt=DT, dx=DX)
        got = KD.leapfrog_gather_push(e, p, v, **lkw)
        ref = KD.leapfrog_gather_push_plain(e, p, v, **lkw)
        torch.cuda.synchronize()
        a = seam_err(ref[0], got[0], NG)
        errs = {"p1": dict(abs=a, err=a / NG, kind="of ng", tol=TOL_DOM)}
        a, r = rel_err(ref[1], got[1])
        errs["v1"] = dict(abs=a, err=r, kind="rel", tol=TOL_DOM)
        records["leapfrog_gather_push"] = _rec(
            _check(errs, "leapfrog_gather_push"),
            cuda_ms(lambda: KD.leapfrog_gather_push(e, p, v, **lkw)),
            cuda_ms(lambda: KD.leapfrog_gather_push_plain(e, p, v, **lkw)),
            "leapfrog_gather_push", n)
        del e, p, v, got, ref
        torch.cuda.empty_cache()
    return records


def _rows_agree(label: str, ref: dict, got: dict, counts) -> list:
    """Problems between two runs' metric rows: the energies beyond
    TOL_DOM_CHECK, any count unequal."""
    problems = []
    for k in ("field_energy", "kinetic_energy"):
        a, r = rel_err(torch.tensor(ref["rows"][k], dtype=torch.float64),
                       torch.tensor(got["rows"][k], dtype=torch.float64))
        log(f"[domain check] {label} {k}: {r:.3e} (tol {TOL_DOM_CHECK:.0e})")
        if not r <= TOL_DOM_CHECK:
            problems.append(f"{label} {k} {r:.3e}")
    for k in counts:
        if ref["rows"][k] != got["rows"][k]:
            problems.append(f"{label} {k} {ref['rows'][k]} != {got['rows'][k]}")
    return problems


def phase_domain_check(dev) -> dict:
    """The domain engines at n = 20,000 from one CPU-made load: on a
    one-rank mesh, card (the kernels) against CPU (their plain versions),
    5 steps; then two ranks on the one card (gloo over CUDA tensors, each
    message staged through the host and counted) against the same two
    ranks on the CPU, the same 5 steps: energies within 1e-5, counts
    equal, positions and velocities slot for slot. The two-rank run is the
    only place migrate, pack_rows and place_rows run on CUDA tensors (one
    rank migrates nothing)."""
    from pypic_tpu_torch.parallel import spawn
    from pypic_tpu_torch.tools import domain as row

    load = row.host_load(DOM_CHECK_N)
    steps = DOM_CHECK_STEPS
    problems, res = [], {}
    engines = (
        ("implicit", dict(backend="fused"),
         ("picard_iters", "n_migrated", "n_dropped", "n_halo_clamped", "n_alive"),
         {"picard_iteration_ext": 4 * steps, "picard_finalize_ext_nodep": steps,
          "deposit": 2}),
        ("explicit", dict(push_backend="fused"),
         ("n_migrated", "n_dropped", "n_alive"),
         {"leapfrog_gather_push": steps, "deposit": 1 + steps}))
    jobs = [(engine, steps, over) for engine, over, _, _ in engines]
    for world in (1, 2):
        # one spawn a device and world size carries both engines
        t0 = time.perf_counter()
        gpus = spawn.run(world, row.rank_run, load, jobs, device=dev)
        cpus = spawn.run(world, row.rank_run, load, jobs, device="cpu")
        seconds = time.perf_counter() - t0
        log(f"[domain check] {world} rank{'s' if world > 1 else ''}, both "
            f"engines on the card and on the CPU: {seconds:.1f} s")
        for i, (engine, _, counts, want) in enumerate(engines):
            label = f"{engine}, {world} rank{'s' if world > 1 else ''}"
            gpu = [rank[i] for rank in gpus]
            cpu = [rank[i] for rank in cpus]
            staged = [g["staged_bytes"] for g in gpu]
            migrated = sum(gpu[0]["rows"]["n_migrated"])
            log(f"[domain check] {label}: staged bytes a rank "
                f"{staged}, migrated {migrated}, launches a rank "
                f"{[g['launches'] for g in gpu]}")
            problems += _rows_agree(label, cpu[0], gpu[0], counts)
            for r, (g, c) in enumerate(zip(gpu, cpu)):
                if not (g["alive"] == c["alive"]).all():
                    problems.append(f"{label} rank {r}: alive slots differ")
                    continue
                alive = c["alive"]
                gp, cp = torch.from_numpy(g["p"][alive]), torch.from_numpy(c["p"][alive])
                dp = seam_err(cp, gp, NG)
                dv = rel_err(torch.from_numpy(c["v"][alive]),
                             torch.from_numpy(g["v"][alive]))[1]
                log(f"[domain check] {label} rank {r}: p {dp:.3e} cells, v {dv:.3e}")
                if not (dp <= TOL_POS_STEPS and dv <= TOL_V):
                    problems.append(f"{label} rank {r}: p {dp:.3e}, v {dv:.3e}")
                if g["launches"] != want:
                    problems.append(f"{label} rank {r}: launches {g['launches']} != {want}")
            if world > 1 and not (migrated > 0 and min(staged) > 0):
                problems.append(f"{label}: migrated {migrated}, staged {staged}")
            # seconds: both engines' spawns of this world size
            res[label] = dict(seconds=seconds, staged_bytes=staged, migrated=migrated)
    if problems:
        raise AssertionError("domain check: " + "; ".join(problems))
    return res


def phase_domain_slice(dev) -> dict:
    """bench.py's configs[4] row (tools/domain.py) at n = 1e8 on a
    one-rank NCCL mesh: 2 + 30 steps, exactly 4 picard_iteration_ext and
    one picard_finalize_ext_nodep launch a step (2 deposits at set-up), 0
    host syncs a step, Picard 4 every step, nothing dropped or clamped, the
    conserving configuration's energy change below 1e-4; then
    finalize='converged-deposit', the shared window and 'iterate', 2 + 3
    steps each, and the explicit carrier with the fused push, 2 + 5, its
    energy change within TOL_DOM_RISE of the plain version's on the CPU.
    Each path has its launch counts set to 0 just before it and read after
    it; the host syncs are counted under torch.cuda.set_sync_debug_mode."""
    import torch.distributed as dist

    from pypic_tpu_torch.ops import cuda_cic
    from pypic_tpu_torch.parallel import domain, domain_implicit, make_mesh
    from pypic_tpu_torch.tools import domain as row

    # the carrier's rise on the CPU (composed, plain kernels), made before
    # the NCCL group so that a CPU mesh is a one-rank mesh of its own
    t0 = time.perf_counter()
    cpu_mesh = make_mesh(device="cpu")
    cpu_rises = []
    for seed in DOM_RISE_SEEDS:
        cfg, st = row.explicit_row(cpu_mesh, DOM_RISE_N, seed=seed)
        cpu_rises.append(row.drive(
            domain.make_step(cfg, cpu_mesh), st, DOM_RISE_N, WARMUP_STEPS,
            DOM_EXPLICIT)[0]["total_energy_rel_change"])
    cpu_rise = sum(cpu_rises) / len(cpu_rises)
    log(f"[domain slice] the explicit carrier on the CPU, n = {DOM_RISE_N}, "
        f"{WARMUP_STEPS} + {DOM_EXPLICIT} steps, seeds {DOM_RISE_SEEDS}: total "
        f"energy change {[f'{r:+.6e}' for r in cpu_rises]}, mean "
        f"{cpu_rise:+.6e}, spread {(max(cpu_rises) - min(cpu_rises)) / abs(cpu_rise):.3e} "
        f"relative ({time.perf_counter() - t0:.1f} s)")
    del cfg, st

    row.process_group()
    mesh = make_mesh(device=dev)
    if (mesh.world, mesh.backend) != (1, "nccl"):
        raise AssertionError(f"expected a one-rank NCCL mesh, got {mesh}")
    n = row.N

    def path(label, build, timed, want, checks) -> dict:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cuda_cic.reset_launch_counts()
        t0 = time.perf_counter()
        cfg, st, step = build()
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        res, st = row.drive(step, st, n, WARMUP_STEPS, timed)
        launches = {k: c for k, c in cuda_cic.LAUNCHES.items() if c}
        res.update(setup_s=setup, launches=launches, halo=cfg.halo,
                   capacity=int(st.p.shape[0]),
                   peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
        log(f"[domain slice] {label}: n = {n}, {timed} timed steps after "
            f"init_state + {WARMUP_STEPS} warm-up: {res['ms_per_step']:.4f} "
            f"ms/step, {res['pushes_per_s']:.4e} pushes/s, picard mean "
            f"{res.get('picard_mean', float('nan')):.2f}, total energy change "
            f"{res['total_energy_rel_change']:+.4e}, dropped {res['n_dropped']}, "
            f"halo clamped {res['n_halo_clamped']}, host syncs a step "
            f"{res['host_syncs_per_step']:.2f}, setup {setup:.2f} s, capacity "
            f"{res['capacity']}, halo {cfg.halo}, peak memory "
            f"{res['peak_mem_gib']:.2f} GiB")
        log(f"[domain slice] {label}: launches {launches}")
        finite = all(bool(torch.isfinite(t).all()) for t in (st.p, st.v))
        in_range = bool(((st.p >= 0) & (st.p <= NG)).all())
        problems = [] if finite and in_range else [f"finite={finite} in_range={in_range}"]
        if launches != want:
            problems.append(f"launches {launches} != {want}")
        if res["n_dropped"] or res["n_alive_last"] != n:
            problems.append(f"dropped {res['n_dropped']}, alive {res['n_alive_last']}")
        problems += [msg for ok, msg in checks(res) if not ok]
        if problems:
            raise AssertionError(f"domain slice, {label}: " + "; ".join(problems))
        del st
        torch.cuda.empty_cache()
        return res

    def implicit_path(**over):
        def build():
            cfg, st = row.implicit_row(mesh, n, **over)
            return cfg, st, domain_implicit.make_step(cfg, mesh)
        return build

    def conserving(res):
        return [(res["picard_mean"] == 4.0, f"picard mean {res['picard_mean']}"),
                (abs(res["total_energy_rel_change"]) < DOM_ENERGY_BOUND,
                 f"total energy change {res['total_energy_rel_change']}"),
                (res["n_halo_clamped"] == 0, f"halo clamped {res['n_halo_clamped']}"),
                (res["host_syncs_per_step"] == 0.0,
                 f"host syncs a step {res['host_syncs_per_step']}")]

    steps = WARMUP_STEPS + DOM_TIMED
    res = path("configs[4], conserving, finalize 'converged'", implicit_path(),
               DOM_TIMED, {"picard_iteration_ext": 4 * steps,
                           "picard_finalize_ext_nodep": steps, "deposit": 2},
               conserving)
    sb = WARMUP_STEPS + DOM_BRANCH
    res["converged_deposit"] = path(
        "finalize 'converged-deposit'", implicit_path(finalize="converged-deposit"),
        DOM_BRANCH, {"picard_iteration_ext": 4 * sb, "picard_finalize_ext": sb,
                     "deposit": 2}, conserving)
    res["shared"] = path(
        "window_share 'shared'", implicit_path(window_share="shared"), DOM_BRANCH,
        {"picard_iteration_ext": 4 * sb, "picard_finalize_ext_nodep": sb,
         "deposit": 2}, conserving)
    res["iterate"] = path(
        "finalize 'iterate'", implicit_path(finalize="iterate"), DOM_BRANCH,
        {"picard_iteration_ext": 4 * sb, "deposit": 2},
        lambda r: conserving(r)[:1] + conserving(r)[2:])

    def explicit():
        cfg, st = row.explicit_row(mesh, n, push_backend="fused")
        return cfg, st, domain.make_step(cfg, mesh)

    se = WARMUP_STEPS + DOM_EXPLICIT
    res["explicit"] = path(
        "the explicit carrier, fused push", explicit, DOM_EXPLICIT,
        {"leapfrog_gather_push": se, "deposit": 1 + se},
        lambda r: [(r["host_syncs_per_step"] == 0.0,
                    f"host syncs a step {r['host_syncs_per_step']}"),
                   (abs(r["total_energy_rel_change"] - cpu_rise)
                    <= TOL_DOM_RISE * abs(cpu_rise),
                    f"total energy change {r['total_energy_rel_change']} "
                    f"against a mean {cpu_rise} on the CPU")])
    res["explicit"]["cpu_total_energy_rel_change"] = cpu_rises
    log(f"[domain slice] the explicit carrier's energy change: card "
        f"{res['explicit']['total_energy_rel_change']:+.6e} at n = {n}, CPU "
        f"mean {cpu_rise:+.6e} at n = {DOM_RISE_N} (tol {TOL_DOM_RISE} relative)")
    dist.destroy_process_group()
    return res


def main() -> int:
    walls = {}

    def phase(label, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        walls[label] = time.perf_counter() - t0
        log(f"[wall] {label}: {walls[label]:.1f} s")
        return out

    name = phase("device", phase_device)
    dev = torch.device("cuda", 0)
    phase("build", phase_build)
    k = phase("kernels", phase_kernels, dev)
    phase("check", phase_check, dev)
    sl = phase("slice", phase_slice, dev)
    glue = sl["ms_per_step"] - 4 * k["picard_iteration"]["ms"] - k["picard_finalize_nodep"]["ms"]
    log(f"[slice] breakdown per step: 4 x picard_iteration "
        f"{4 * k['picard_iteration']['ms']:.4f} ms + finalize "
        f"{k['picard_finalize_nodep']['ms']:.4f} ms + the rest {glue:.4f} ms")
    ek = phase("explicit kernels", phase_explicit_kernels, dev)
    phase("explicit check", phase_explicit_check, dev)
    ex = phase("explicit slice", phase_explicit_slice, dev, ek["explicit_cycle"]["ms"])
    rs = phase("resident", phase_resident, dev)
    ik = phase("implicit kernels", phase_implicit_kernels, dev)
    phase("implicit check", phase_implicit_check, dev)
    isl = phase("implicit slices", phase_implicit_slices, dev)
    mk = phase("magnetized kernels", phase_magnetized_kernels, dev)
    mc = phase("magnetized check", phase_magnetized_check, dev)
    ms = phase("magnetized slice", phase_magnetized_slice, dev)
    shk = phase("sheath kernels", phase_sheath_kernels, dev)
    shc = phase("sheath check", phase_sheath_check, dev)
    shs = phase("sheath slice", phase_sheath_slice, dev)
    dnk = phase("dn kernels", phase_dn_kernels, dev)
    dnc = phase("dn check", phase_dn_check, dev)
    dns = phase("dn slice", phase_dn_slice, dev)
    phase("gc check", phase_gc_check, dev)
    gcs = phase("gc slice", phase_gc_slice, dev)
    lim = phase("size limits", phase_size_limits, dev)
    dk = phase("domain kernels", phase_domain_kernels, dev)
    dc = phase("domain check", phase_domain_check, dev)
    ds = phase("domain slice", phase_domain_slice, dev)

    # each kernel's launches come from the path that runs it, counted from
    # 0 just before that path and read just after
    launches = dict(sl["launches"])
    launches["explicit_cycle"] = ex["launches"]["explicit_cycle"]
    launches["leapfrog_gather_push_deposit"] = (
        ex["large_grid"]["launches"]["leapfrog_gather_push_deposit"])
    launches["gather"] = ex["composed"]["launches"]["gather"]
    launches["explicit_cycle_resident"] = rs["launches"]["explicit_cycle_resident"]
    launches["picard_finalize"] = isl["converged_deposit"]["launches"]["picard_finalize"]
    launches["picard_iteration_shared"] = (
        isl["shared"]["launches"]["picard_iteration_shared"])
    launches["implicit_resident"] = isl["launches"]["implicit_resident"]
    for kname in SOURCES_MAGNETIZED:
        launches[kname] = ms["launches"][kname]
    for kname in ("sheath_picard", "sheath_finalize", "sheath_reinject"):
        launches[kname] = shs["launches"][kname]
    # the composed sheath path runs the deterministic deposit
    launches["deposit_det"] = shs["composed"]["launches"]["deposit_det"]
    launches["boltzmann_dn"] = dns["launches"]["boltzmann_dn"]
    for kname in ("picard_iteration_ext", "picard_finalize_ext_nodep"):
        launches[kname] = ds["launches"][kname]
    launches["picard_finalize_ext"] = (
        ds["converged_deposit"]["launches"]["picard_finalize_ext"])
    launches["leapfrog_gather_push"] = (
        ds["explicit"]["launches"]["leapfrog_gather_push"])
    helper = dnk.pop("philox_uniforms")
    records = {**k, **ek, **ik, **mk, **shk, **dnk, **dk}
    sources = {kname: "pypic_tpu_torch/csrc/cic.cu" for kname in k}
    sources.update({kname: "pypic_tpu_torch/csrc/explicit.cu" for kname in ek})
    sources.update(picard_finalize="pypic_tpu_torch/csrc/cic.cu",
                   picard_iteration_shared="pypic_tpu_torch/csrc/cic.cu",
                   implicit_resident="pypic_tpu_torch/csrc/implicit.cu",
                   boltzmann_dn="pypic_tpu_torch/csrc/newton.cu",
                   **{kname: "pypic_tpu_torch/csrc/domain.cu" for kname in dk},
                   **SOURCES_MAGNETIZED, **SOURCES_SHEATH)
    log(f"[wall] total {sum(walls.values()):.1f} s")
    print(json.dumps({"kernels": [
        {"name": kname, "route": "cuda", "source": sources[kname],
         "replaces": REPLACES[kname], "launches": launches[kname],
         "max_abs_err": records[kname]["max_abs_err"],
         "ms": records[kname]["ms"], "plain_ms": records[kname]["plain_ms"],
         "bound_ms": records[kname]["bound_ms"],
         "bound_by": records[kname]["bound_by"],
         "library_ms": records[kname].get("library_ms"),
         "n": records[kname]["n"]}
        for kname in REPLACES
    ], "helper_kernels": [
        # the flux and gyro-phase uniforms: no TPU kernel draws them (the
        # JAX engine takes them from jax.random)
        {"name": "philox_uniforms", "route": "cuda",
         "source": "pypic_tpu_torch/csrc/rng.cu", "replaces": None,
         "launches": dns["launches"]["philox_uniforms"],
         **{key: helper[key] for key in ("max_abs_err", "ms", "plain_ms",
                                         "bound_ms", "bound_by", "n")},
         "library_ms": helper["library_ms"]}],
        "slice": {key: sl[key] for key in (
        "n", "steps", "ms_per_step", "pushes_per_s", "picard_mean",
        "field_energy_rel_change", "total_energy_rel_change")},
        "explicit_slice": {key: ex[key] for key in (
            "n", "steps", "ms_per_step", "pushes_per_s", "metric_sums_ms",
            "total_energy_rel_change")},
        "resident": {key: rs[key] for key in (
            "n", "steps", "us_per_step", "pushes_per_s",
            "per_step_path_us_per_step", "growth_ratio")},
        "implicit_slices": {
            **{key: isl[key] for key in (
                "n", "steps", "us_per_step", "pushes_per_s",
                "per_step_path_us_per_step", "picard_mean",
                "total_energy_rel_change", "landau_ratio",
                "landau_ratio_resident", "per_step_picard_mean",
                "first_rows_iters_differ")},
            **{f"{path}_ms_per_step": isl[path]["ms_per_step"]
               for path in ("converged_deposit", "shared", "composed")}},
        "magnetized_slice": {
            **{key: ms[key] for key in (
                "n", "steps", "us_per_step", "pushes_per_s", "newton_mean",
                "phi_max_over_phi_f")},
            "composed_us_per_step": ms["composed"]["us_per_step"],
            "newton_us_per_iteration": mk["boltzmann_dirichlet"]["us_per_iteration"],
            "check_phi_max_rel": mc["phi_max_rel"]},
        "sheath_slice": {
            **{key: shs[key] for key in (
                "n", "steps", "us_per_step", "pushes_per_s", "picard_mean",
                "picard_max", "wall_drop_left_te", "wall_drop_right_te",
                "lost_per_step")},
            **shs["syncs"],
            "composed_us_per_step": shs["composed"]["us_per_step"],
            "deposit_det_versus_atomic": shk["deposit_det"]["versus_atomic"],
            "check": shc},
        "dirichlet_neumann_slice": {
            **{key: dns[key] for key in (
                "n", "ng", "steps", "us_per_step", "pushes_per_s",
                "newton_mean", "newton_max", "n0_last_over_first", "phi_wall",
                "phi_far", "react_per_step")},
            "newton_us_per_iteration": dnk["boltzmann_dn"]["us_per_iteration"],
            "check_means_rel": dnc["means_rel"]},
        "gc_slice": {key: gcs[key] for key in (
            "n", "ng", "steps", "us_per_step", "pushes_per_s", "newton_mean",
            "phi_max_over_phi_f")},
        "size_limits": lim,
        "domain_slice": {
            **{key: ds[key] for key in (
                "n", "steps", "ms_per_step", "pushes_per_s", "picard_mean",
                "total_energy_rel_change", "n_dropped", "n_halo_clamped",
                "host_syncs_per_step", "halo", "capacity", "peak_mem_gib")},
            **{f"{path}_ms_per_step": ds[path]["ms_per_step"]
               for path in ("converged_deposit", "shared", "iterate",
                            "explicit")},
            "picard_clamped_shared": ds["shared"]["picard_clamped"],
            "explicit_total_energy_rel_change": {
                "card": ds["explicit"]["total_energy_rel_change"],
                "cpu": ds["explicit"]["cpu_total_energy_rel_change"]},
            "check": dc},
        "walls_s": walls}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
