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
   whose first 37 metric rows are held against the plain version's; then
   timed by resident_explicit_times at the configs[0] row's shape (n =
   10,000, 2,000 steps) and at n = 32,768: the median of three calls, with
   µs a step.
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
   (rows, Picard counts and the final p, v, e, e_prev and j), then timed
   by resident_implicit_times at the configs[1] row's shape (n = 1e5, 64
   steps) and at n = 131,072: the median of three calls, with the Picard
   passes of the launch and µs a pass.
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
   by newton_times (the median of three profiler calls, µs per Newton
   iteration, and a long solve of 64 iterations that parts an iteration's
   cost from the launch's fixed cost). These four kernels run for less time than
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
   0.5, at phase 16's 80/10/10 status mix and at the row's own (109 rows
   lost of 1e6), on aligned inputs and on views one float in (for the
   pass and the finalize the kernel's row-by-row path, every output, the
   current too, bit-equal to the aligned inputs'), with torch.rand((5, n)) as its
   library yardstick; device times from the profiler, the median of three
   calls, each call on the next of four copies of its inputs and the last
   four calls' outputs held (so that the L2 holds none of them), the
   re-injection's bound counted from the rows it draws for, its time at
   the 80/10/10 mix (the table's yardstick) and
   at the row's own.
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
   row's first solve by newton_times (as in phase 13); the tagged
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
24. size limits — each wrapper that keeps a card ceiling raises above it
   and launches nothing: the rows still bounded by shared memory naming
   ROADMAP item 10, deposit2, the carried Boris deposit, deposit_det and
   the sheath pass and finalize (their large modes: phase 40) only above
   cuda_cic.LARGE_MAX_NG, naming it. The Newton family
   has none below 2^27 rows: boltzmann_dirichlet and boltzmann_dn on
   their large path (above 1,024 rows) at 1,025, 4,096, 16,384 and
   262,144 rows (8 iterations, tol 0) and tridiag3_chain at c = 1,025 and
   16,384 with all four (first, last) ends, against their plain versions
   within TOL_CHAIN of the largest |x|, one launch of the large path a
   call; timed at 4,096, 16,384 and 262,144 (and the D-N row's 8,000):
   us an iteration, the long solve's marginal us an iteration, the plain
   version, the bound, dense torch.linalg.solve for the chain up to
   4,096. Then a magnetized step at ng = 1,200 with 'xla' (the
   op-composed Thomas route: one Thomas solve, no Newton launch), 'auto'
   and 'pallas' (one boltzmann_dirichlet_large launch, no Thomas solve,
   phi converged), each timed on the wall clock after a warm-up step.
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
28. carried kernels — the two kernels of bench.py --carried against their
   plain versions: boris_gather_push_deposit at n = 999,996 (pad 2) and a
   ragged 1,000,003 with a forced clamp (pad 0, 40x the velocities), ng =
   600, mirrored gather and not, inactive rows and wall hits on both
   sides: p1 and the velocities bit-equal, rho and n against float64 sums,
   the clamp counts equal; explicit_domain_cycle at n = 6104 * 16384 on
   one rank's slab and a ragged 10,000,003 with a middle rank's
   lo_shifted, ext_n = 227, dead slots, rows past both ext edges: p1 and
   v1 bit-equal, rho_ext against float64 sums, the clamp counts equal.
   Each timed with its bound.
29. carried check — pic_iead at n = 12,000 with the --carried row's
   configuration: one step from the states after 0 and 10 steps, card
   against CPU, the same source table, the carried rho and n and the
   clamp counts too; the carried carrier's card-against-CPU check at one
   and two ranks rode phase 26's spawns.
30. carried slice — the configs[3] row with carried_deposit='on'
   (tools/magnetized.py --carried): 1,200 steps at n = 999,996 under sync
   debug mode 'error', exactly 1,200 launches each of
   boris_gather_push_deposit, deposit2, boltzmann_dirichlet, source_batch
   and deposit and no other, n_ion_suppressed and n_escape_deferred 0,
   the clamps counted and printed; then the carried carrier
   (tools/domain.py --explicit --carried) at n = 1e8 on one rank, 2 + 5
   steps: one explicit_domain_cycle launch a step, 0 host syncs, nothing
   clamped or dropped, its energy change against the plain version's on
   the CPU. Each beside its row without the carry.
31. deposit times (deposit_times) — the wide-grid kernels at the shapes
   of their paths, inputs warm and rotated past the L2 (the median of
   three profiler calls each), each against its plain version: deposit2
   at its three paths' shapes and boris_gather_push_deposit at the
   configs[3] row's; deposit at the explicit carrier's slab (n = 1e8,
   ext_n = 227, dead slots), the headline's set-up (n = 1e8, ng = 200),
   the configs[3] row's own IEAD traffic (phase 15's last step through
   iead_update's arithmetic: 3,200 bins, counts exact, beside index_add_)
   and the first port's synthetic 999,996 / 600, and a ragged view;
   deposit_det at the composed sheath current (1e6 / 51, bit-equal from
   call to call) and its exit histograms; source_batch at 999,996 and a
   ragged 1,000,003 (uniforms bit-equal, beside torch.randn((4, n))), with
   its issue bound (its Philox block's integer work) and, beside it, the
   issue time of the library's own SASS loop.
32. bca check — the pic_bca_aps path (presets.pic_bca_aps at ppc 200:
   n = 120,000 in 180,000 slots) one step on the card and on the CPU with
   the same source table and ionization uniforms, from the preset's state
   and from one seeded with 256 neutral wall-born B rows (ionization and
   the escape both fire): rho, phi, p, v at phase 14's limits, the
   counts equal, charge states and the active mask equal off the draws
   that straddle their probability, the impact and escape rows at
   BCA_ROW_TOL, iead and iead_out equal up to rows on a bin edge.
33. bca slice — tools/bca.py: 200 steps of engines.bca_driver.run_bca
   with BinaryCollisionModel seeds 1 and 2, every engine step under sync
   debug mode 'error', exactly the path's launches (deposit2,
   boltzmann_dirichlet, boris_gather_push, gather, source_batch and
   philox_uniforms once a step, deposit twice) and no other,
   tests/test_bca.py:148-165's invariants; ms/step of the block and of
   the engine alone, the surface model's share, BCAStats, at
   pic_steps_per_bca 1 and 10.
34. checkpoint — phase 33's final state through CheckpointManager (async)
   and back into a card template, every field bit for bit; 3 steps from
   the loaded state against 3 from the saved one at phase 14's limits
   (the deposits' float atomics: not bit for bit on the card; p and v
   leave out the rows whose two runs sit in different cells before a
   step, where the 'reference' gather weights jump, and count them).

35. cli — ``python -m pypic_tpu_torch.cli run`` in subprocesses on the
   card (phase_cli): landau_damping at n = 1e6, 40 steps with the plots,
   checkpoints and the profiler, then resumed from step 20; bump_on_tail;
   sheath_dd with --plot; pic_iead with the plots, the particle dump, the
   gif and the surface post-process; domain_explicit with the distributed
   solve and domain_implicit with checkpoints, then resumed, at n = 1e6
   on one-rank NCCL groups. Each exits 0, writes its files and finite
   metrics; each preset also runs through runner.run alone here (ms/step,
   launches); the two Poisson solves' launches and device ms; the
   histogram helpers on the card against their plain versions.
36. data parallel — the hash sampler's kernel (hash_batch) against its
   plain version at 999,996 x 4 normals and 180,000 x 8 uniforms, at slot
   offset 0 and at a second rank's: the uniforms bit-equal, the normals
   within TOL_HASH_NORMAL; timed beside torch.rand of the same shape and
   row 20's source_batch. Then, on a one-rank NCCL group, the implicit
   headline (n = 100,007,936, conserving, 2 + 10 steps), the configs[3]
   magnetized row (999,996, the hash sampler) and the sheath row (1e6,
   hash), 2 + 20 steps each, with axis_name set and without: the same
   launches and host syncs a step (0 on the magnetized row; Picard 4 on
   the headline). Then two gloo ranks on the one card (every message
   staged through the host): the magnetized and sheath rows at full n
   split in two, their hash uniforms bit-equal block for block to the
   one-rank run's, their rows within the CPU tests' tolerances of the
   one-rank run's and equal on both ranks (the same Picard and Newton
   counts); domain_implicit at one slab x two replicas against one slab x
   one replica (n = 1e6, 10 steps); and the CLI's --replicas 2 in two
   subprocesses (gloo, PYPIC_BACKEND), exit 0 with its files.
37. slab bounded — the chain kernel tridiag3_chain against its plain
   version at c = 150, 300, 600 and 1,024 (Boltzmann-Jacobian systems as
   the slab Newton builds them, and random diagonally dominant ones),
   within TOL_CHAIN of the largest |x|, timed beside the Python-loop
   Thomas it replaces and dense torch.linalg.solve; sheath_reinject at a
   slab rank's tag (1 << 16) against its plain version at n = 1e6. Then,
   on a one-rank
   NCCL group, pic_iead_dd at the configs[3] row's width (n = 999,996,
   ng 600) for 200 steps: ms/step, pushes/s, Newton iterations, launches
   and host syncs a step, nothing dropped, the population kept, phi_max
   over the floating potential in 0.6-1.4, its first 2 steps' phi_max
   within TOL_SLAB_PHI_MAX of the single-device engine's from the same
   state; domain_sheath at the configs[2] row's physics (n = 1e6, ng 51,
   1,200 steps): us/step, Picard passes, host syncs, the wall drops beside
   phase 18's; and 10 timed steps at n = 1e8. Then two gloo ranks on the
   card: pic_iead_dd on 2 slabs and on 1 slab x 2 replicas, and the
   sheath at ng 56, n = 1e5 (20 steps each): the ranks' rows equal, the
   first steps against one rank's (the sheath's step 0: field and kinetic
   energy, phi, Picard passes), migration and no drops.
38. options — the options of the JAX package's that the earlier slices
   left out (tools/options.py): the headline cell (n = 6104 * 16384,
   2 + 10 steps from one state) with finalize_field 'mean2', 'map',
   'aitken', picard_accel 'anderson2' and 'aitken' under
   'converged-deposit' beside 'last' with Anderson(1): ms/step, 4
   picard_iteration and 1 picard_finalize_nodep (picard_finalize) a step, the
   host syncs a step no more than the plain option's; each at n = 20,000
   on the card against the CPU (phase 4's limits); the configs[2] sheath
   row (20 steps) with 'anderson2' and 'anderson4' beside 'anderson'
   (Picard passes a step), and at n = 20,000 one step card against CPU,
   both backends (phase 18's limits and floor-exit allowance); the
   supersteps of configs[4] (n = 1e8) and the explicit carrier (n =
   20,000; its carried_rho form at k = 1) on a one-rank NCCL group, and
   both at n = 20,000 on two gloo
   ranks on the card: superstep(k=1) against make_step, k = 2 against two
   make_steps, nothing dropped or clamped, the step advanced by k, and
   the finalize sweeps' raw mode (ng 0) launched and held against their
   plain versions on the inputs the path gave them; cli run
   domain_implicit --migrate-every 2 in a subprocess; the configs[3] row
   with carried_deposit='on', react_batch 512 and the 'hash' sampler
   under axis_name on one NCCL rank (against the run without) and on two
   gloo ranks (the carried rho and n the same bits on both); and
   deposit_method 'pallas' at the headline set-up, 'scatter' and
   'matmul' at n = 1e6, ng 51 and at ng = 2,000 (deposit_det's large
   mode): the same bits twice, near the deposit kernel; a raise naming
   LARGE_MAX_NG above it.
39. large grids — the slice's main path: the configs[3] load (n =
   999,996) at ng = 16,384 and 4,096 and the D-N row at n = 500,000 and
   ng = 8,000 through tools/magnetized.run_row (50 steps after 3, sync
   debug mode 'error'): ms/step, Newton iterations a step (mean, max,
   steps at maxiter, the largest residual: the presets' tol 1e-9 lies
   under the float32 floor at these rows), launches a step (one large
   Newton kernel), THOMAS_SOLVES 0; each held against the CPU one step at
   a time from the card's states for 3 steps at phase 14's limits (|p| in
   the position limit the larger of a particle's start and end), and both
   against a float64 step from the same state (the Newton loop by scipy's
   banded LU) at the same position limits; the worst particles of phase
   14's own position test printed. The
   chain solve at c = 16,384 on one rank under sync debug mode 'error'.
   Then pic_iead_dd at ng = 32,768 on two gloo ranks on the card (c =
   16,384 a slab), 10 steps with solver 'distributed' (one
   tridiag3_chain_large a Newton iteration) and 'replicated' (one
   boltzmann_dirichlet_large a step): rows equal on both ranks, nothing
   dropped, the solvers' phi within TOL_LARGE_SLAB_PHI.
40. large sheath — the slice's main path, the four kernels past their
   shared-memory ceilings: sheath_picard and sheath_finalize (row 10) and
   deposit_det (int64 fixed-point sums), deposit2 (row 7) and
   boris_gather_push_deposit (row 9; global float atomics), each just
   above its old ceiling (1,761; 1,761; 1,817; 29,057; 19,371 nodes) and
   at 65,536 and 2^20, n = 1e6 and 1e7, against its plain version (the
   deterministic three bit-equal from call to call and within TOL_DEP of
   float64, the pass's outputs bit-equal; deposit2 at its tolerances;
   row 9's push bit-equal, rho and n within TOL_DEP of float64, the
   clamps equal), timed at the last two sizes with the bound in bytes
   (rows and nodes) and index_add_ beside deposit2. Then the sheath
   engine at configs[2]'s physics (presets.sheath_dd), fused at ng 8,192
   (n = 1e6) and 65,536 (n = 8e6), composed at 8,192, 20 steps after 3:
   ms/step, Picard passes a step, host syncs (5 more steps under sync
   debug mode 'warn', one a pass), the wall drops, the population
   invariant, launches; one step from the card's state on the CPU at
   test_sheath_step_card_matches_cpu's limits, the Picard counts by
   floor_exit_counts_agree. domain_sheath at global ng 8,192, n = 1e6:
   one NCCL rank (10 steps after 2, launches and syncs a step), one step
   card against CPU on a group-less rank, and two gloo ranks on the card
   (rows equal, step 0 against the one-rank step). The configs[3] load at
   ng 32,768, plain ('auto') and carried (--carried, carried_pad 2), 20
   steps after 3 under sync debug mode 'error', the plain run held
   against the CPU and a float64 step for one step (phase 39's checks),
   the carried one against the CPU with carry_clamped equal.

Each phase prints its wall seconds. The line before the last is one JSON
object describing each kernel; the last line is {"ok": true, "device":
{...}}.
"""

from __future__ import annotations

import collections
import functools
import itertools
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
# resident_explicit_times: the configs[0] row's n and the kernel's largest
RESIDENT_EXPLICIT_TIMED_NS = (RESIDENT_N, 32_768)
PER_STEP_STEPS = 2000

# the implicit engine's resident kernel: 25 steps in chunks of 8 against 25
# per-step steps and the plain version, in the two configurations of
# tests/test_pallas.py:450-453, held to that test's criteria (fe rtol
# 1e-4, ke 1e-5, positions 5e-3 cells, iterations equal but at a step whose
# residual sat at tol, see iters_agree) and the final v, e, e_prev and j to
# the card test's 1e-4 of the largest magnitude
IMPLICIT_RESIDENT_NS = (9001, 100_000, 131_072)
IMPLICIT_RESIDENT_STEPS, IMPLICIT_RESIDENT_SPC = 25, 8
# resident_implicit_times: the configs[1] row's n and the kernel's largest
RESIDENT_TIMED_NS = (100_000, 131_072)
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
    # p, u, vy, vz, act read, p, u, vy, vz written; sig is read by the
    # re-injected rows only (REINJECT_DRAW_BYTES a drawing row, gamma 0)
    "sheath_reinject": 36,
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
    # boris_gather_push's 40 and the weights wr, wn read
    "boris_gather_push_deposit": 48,
    # p, v, w read, p1, v1 written
    "explicit_domain_cycle": 20,
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
    # update 1 and the residual sum 2. The kernel's PCR does more: 16 a
    # stage (2 divisions, 8 products and sums, 2 zero-dividend tests and
    # the vote's 2 tests), 8 stages at the row's first solve, ~150 in all
    "boltzmann_dirichlet": 25,
    # clip 2, the gather's cell and weights 6 and products 3, the push 8,
    # the midpoints 4, the wall tests 8 and selects 2, the deposit's cell,
    # weights and products 9 and its two atomics
    "sheath_picard": 44, "sheath_finalize": 44,
    # the status compare of every row; a re-injected row adds
    # REINJECT_DRAW_OPS (gamma 0)
    "sheath_reinject": 1,
    # the deposit's 7 with plain adds in the place of the atomics
    "deposit_det": 7,
    # per physical row and Newton iteration, what a Thomas-solved
    # Sherman-Morrison Newton step needs: the residual 10 and the
    # Jacobian's diagonal 2 as in the D-D count, a Thomas solve with two
    # right-hand sides 12 (elimination 5 + 2, back substitution 3 + 2),
    # the rank-1 correction 2, the clip 2, the update 1 and the norm's sum
    # 2. The kernel's two-column PCR does more: 20 a stage (the D-D
    # kernel's 16 and 4 for the second column), 8 stages at the row's
    # first solve, and every row forms y and z at row ng - 3: ~190 in all
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
    # boris_gather_push's 55 and the carried deposit: the wall test 2, the
    # window (floor, product, clamp 2) 4, d_h 3, the edge tests and clamp
    # 4, the row's floor and weights 3, the nodes 2, four products and
    # four atomics
    "boris_gather_push_deposit": 85,
    # leapfrog_gather_push's 13 and the deposit: the offset 1, the edge
    # tests and clamp 4, the cell and weights 4, two products and two
    # atomics
    "explicit_domain_cycle": 26,
}
RESIDENT_FINAL_OPS = 19  # the finalize sweep (16) and the ke, jb sums (3)
# a re-injected row of sheath_reinject: its sig read, and two Philox
# blocks (10 rounds of 2 high and 2 low products, 4 xors and 2 key
# additions: 200), 8 uniforms (3 each), Box-Muller (2 logs, 2 sqrts, 3
# sines and cosines, 9 products: 16), 5 products and the compares, all at
# the float32 rate. Rows that keep their values draw nothing.
REINJECT_DRAW_BYTES, REINJECT_DRAW_OPS = 4, 250
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
    "boltzmann_dirichlet_large":
        "pypic_tpu/ops/pallas_newton.py:256 boltzmann_dirichlet_pallas",
    "boltzmann_dn_large": "pypic_tpu/ops/pallas_newton.py:213 boltzmann_dn_pallas",
    "picard_iteration_ext": "pypic_tpu/ops/pallas_cic.py:1847",
    "picard_finalize_ext": "pypic_tpu/ops/pallas_cic.py:1987",
    "picard_finalize_ext_nodep": "pypic_tpu/ops/pallas_cic.py:2019",
    "leapfrog_gather_push": "pypic_tpu/ops/pallas_cic.py:849",
    "boris_gather_push_deposit": "pypic_tpu/ops/pallas_cic.py:536",
    "explicit_domain_cycle": "pypic_tpu/ops/pallas_cic.py:959",
}
SOURCES_MAGNETIZED = {
    "deposit2": "pypic_tpu_torch/csrc/magnetized.cu",
    "boris_gather_push": "pypic_tpu_torch/csrc/magnetized.cu",
    "boltzmann_dirichlet": "pypic_tpu_torch/csrc/newton.cu",
    "source_batch": "pypic_tpu_torch/csrc/rng.cu",
}
SOURCES_CARRIED = {
    "boris_gather_push_deposit": "pypic_tpu_torch/csrc/magnetized.cu",
    "explicit_domain_cycle": "pypic_tpu_torch/csrc/domain.cu",
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
# newton_times' long solve: 64 iterations at the float32 floor
NEWTON_LONG = dict(tol=0.0, maxiter=64)
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

# the pic_bca_aps path (tools/bca.py) at ppc 200: the first step on the
# card and the CPU from the preset's state and from one seeded with
# BCA_SEEDED_ROWS neutral wall-born B rows (BCA_SEEDED_ESCAPING of them in
# the escape band); the impact and escape rows' limits (energy rtol,
# angle atol in degrees, vx / vth rtol with atol 1e-3, lateral distance
# rtol: the velocities' 2e-4 of phase 14 squared, atan2 in two
# libraries); an ionization draw within BCA_STRADDLE (relative) of its
# probability may decide either way; then BCA_STEPS steps of run_bca and
# CKPT_RESUME_STEPS steps resumed from a checkpoint on the card
BCA_SEEDED_ROWS, BCA_SEEDED_ESCAPING = 256, 16
BCA_ROW_TOL = {"energy": 5e-4, "angle": 1e-3, "vx": 2e-4, "lateral": 1e-5}
BCA_STRADDLE = 1e-5
BCA_STEPS = 200
CKPT_RESUME_STEPS = 3

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
# the configs[2] row's wall losses a step at n = 1e6 (phase 18: 108.8),
# the re-injection's own status mix
REINJECT_ROW_LOST = 109
# phase 16 times the sheath kernels on ROTATE_SETS copies of their inputs,
# a copy a call in turn: at n = 1e6 a copy is 24 MB or more, so the three
# others pass 72 MB or more through the card's 50 MB L2 between two calls
# on one copy, and every call reads its inputs from device memory, as the
# engine's step does. The outputs of the last ROTATE_SETS calls are held,
# so that each call writes new buffers too: a buffer freed and handed out
# again at once would take the next call's writes in the L2
ROTATE_SETS = 4

# the D-N slice: dirichlet_neumann_test at its own scale (tools/magnetized.py
# --row dn), and the GC slice: pic_iead_gc at the configs[3] row's size
NG_DN = 800
# deposit_times: deposit2 at the shapes of its three paths (configs[3], the
# D-N row, the carried row's re-activation patch of react_batch rows)
DEPOSIT_SHAPES = {"configs[3]": (999_996, 600), "D-N": (50_000, NG_DN),
                  "carried patch": (16_384, 600)}
# row 4's shapes: the explicit carrier's slab a step (n = 1e8 onto ext_n
# = 227 nodes, bounded, a twentieth dead slots of weight 0), the headline's
# set-up (n = 1e8, ng = 200, periodic), the configs[3] row's IEAD histogram
# (phase 15's own traffic, 3,200 bins), the first port's synthetic IEAD
# shape (999,996 rows onto 600 nodes, dense values) and a ragged n read
# through a view one float in (4-B loads); the timed records' shape
DEPOSIT_MAIN_SHAPE = "headline set-up"
# deposit_det's: the composed sheath current and its exit histograms (2 x 64
# bins, integer positions, weight 1 on 1% of the rows)
DEPOSIT_DET_SHAPES = {"current": (1_000_000, 51), "exit histograms": (1_000_000, 128)}
SOURCE_NS = {"999,996": 999_996, "ragged 1,000,003": 1_000_003}
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
# a magnetized step at ng = 1200, above the Newton kernels' one-CTA 1,024
# rows: the large D-D kernel on the card (before it, the Thomas route)
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

# the carried slice (bench.py --carried): the configs[3] row with
# carried_deposit='on' (tools/magnetized.py --carried) and the carried
# carrier (tools/domain.py --explicit --carried). Row 9 runs at the
# magnetized row's shape with its carried pad, and with pad 0 and 40x the
# velocities to force clamps; row 12 on the carrier's extended slab of
# one rank (c = 200, bench's carried halo 13 at the row: ext_n = 227) and
# with a middle rank's offset (rank 1 of 4 slabs of 200 cells: the global
# ng 800, lo = 200, lo_shifted = 187)
CARRIED_PAD, CARRIED_HOT = 2, 40.0
DOM_CARRIED_HALO = 13
DOM_CARRIED_EXT_N = DOM_C + 2 * DOM_CARRIED_HALO + 1
# carried check: one step from the carried states after these steps, card
# against CPU, the same source table; the next step's rho and n at
# TOL_MAG_STEP's rho limits, the clamp counts equal
CARRIED_CHECK_AT = (0, 10)
# the carried row's carry total against a fresh deposit of the final
# particles (clamped tents stay in the grid): float32 sums of 1e6 terms in
# other orders
TOL_CARRY_TOTAL = 1e-5


def bound(name: str, n: int, steps: int = 1, passes: int | None = None,
          extra_bytes: float = 0.0, extra_ops: float = 0.0) -> tuple[float, str]:
    """The least time in ms the card could take for one call on n
    particles (``steps`` cycles for the resident kernels; for
    implicit_resident, ``passes`` Picard passes in all, as its rows
    report; for boltzmann_dirichlet, n rows of the Newton system and
    ``steps`` the Newton iterations the kernel reports): the larger of the
    bytes over the memory rate and the operations over the float32
    rate. ``extra_bytes`` and ``extra_ops`` carry the work that depends
    on the call's data (sheath_reinject's drawing rows)."""
    by_bytes = (BYTES_PER_PARTICLE[name] * n + extra_bytes) / PEAK_BYTES_PER_S * 1e3
    ops = OPS_PER_PARTICLE[name] * n * (steps if passes is None else passes) + extra_ops
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
         steps: int = 1, passes: int | None = None, **extra) -> dict:
    b, by = bound(name, n, steps, passes, **extra)
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
    launches, from a torch.profiler trace of ``calls`` calls after a
    warm-up. For calls whose kernels are shorter than the wrapper's Python
    overhead, where ``cuda_ms`` would time the host.

    A trace can lack some of the calls' kernels (late in a long process
    the H100's traces held 12 to 19 of 20 calls' launches of a kernel), so
    a call's time is the sum over its kernels of each kernel's mean
    duration times its launches a call (its count over ``calls``,
    rounded), not the trace's summed time over ``calls``; where the two
    differ by more than 1% a ``[timing]`` line gives both. The CUDA trace
    now and then comes back empty. Such a trace is taken again up to
    ``tries`` times; after that the call is timed by ``queued_ms``, which
    the log line names."""
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
        durs = collections.defaultdict(list)
        for e in events:
            if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memset",
                                                       "gpu_memcpy"):
                durs[e["name"]].append(e["dur"])
        if durs:
            ms = sum(statistics.fmean(d) * max(1, round(len(d) / calls))
                     for d in durs.values()) / 1e3
            summed = sum(map(sum, durs.values())) / 1e3 / calls
            if abs(summed - ms) > 0.01 * ms:
                held = ", ".join(f"{len(d)} of {name[:40]}" for name, d in durs.items())
                log(f"[timing] the trace held {held} in {calls} calls: {ms:.4f} ms a "
                    f"call per kernel, {summed:.4f} from the trace's sum over the calls")
            return ms
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


def phase_device() -> tuple[str, str]:
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
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return name, card


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
    del got, ref, cfg, st, args
    timed = resident_explicit_times(dev)
    records["explicit_cycle_resident"] = dict(
        timed[RESIDENT_N], max_abs_err=worst,
        at_max_n=timed[RESIDENT_EXPLICIT_TIMED_NS[-1]])
    return records


def resident_explicit_times(dev) -> dict:
    """Device time of one 2,000-step launch of the resident explicit kernel
    at the configs[0] row's load (tools/two_stream.py, ng = 200) for each n
    of RESIDENT_EXPLICIT_TIMED_NS: the median of three calls, each the
    median of five launches between CUDA events; with µs a step, the bound
    and the plain version's time. It calls the wrapper by name alone, so it
    times another tree of the port as well (a parent commit, for a paired
    comparison in one chip call)."""
    from pypic_tpu_torch.engines import explicit
    from pypic_tpu_torch.ops import cuda_cic as K
    from pypic_tpu_torch.tools import two_stream

    out = {}
    for n in RESIDENT_EXPLICIT_TIMED_NS:
        cfg, _, st = two_stream.state(n, dev)
        rkw = explicit.resident_kwargs(st, cfg)
        args = (st.e, st.p, st.v, NG, RESIDENT_SPC)
        calls = [cuda_ms(lambda: K.explicit_cycle_resident(*args, **rkw), reps=5, calls=1)
                 for _ in range(3)]
        ms = statistics.median(calls)
        rec = _rec(None, ms, cuda_ms(lambda: K.explicit_cycle_resident_plain(*args, **rkw),
                                     reps=1, calls=1),
                   "explicit_cycle_resident", n, RESIDENT_SPC)
        rec.update(ms_calls=calls, us_per_step=ms * 1e3 / RESIDENT_SPC)
        log(f"[kernels]   explicit_cycle_resident at n = {n}, {RESIDENT_SPC} steps: "
            f"{ms:.4f} ms (calls {', '.join(f'{t:.4f}' for t in calls)}), "
            f"{rec['us_per_step']:.3f} us a step, bound {rec['bound_ms']:.4f} ms, "
            f"plain {rec['plain_ms']:.4f} ms")
        out[n] = rec
        del cfg, st, args
    return out


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
    # the configs[1] row's shape: the plain version's Picard counts, then
    # the timing (resident_implicit_times)
    cfg, st = landau.state(landau.N, dev)
    rkw = implicit.resident_kwargs(st, cfg)
    args = (st.e, st.e_prev, st.j, st.p, st.v, NG, landau.STEPS_PER_CALL)
    out = K.implicit_resident(*args, **rkw)
    ref = K.implicit_resident_plain(*args, **rkw)
    torch.cuda.synchronize()
    if not iters_agree("implicit_resident(n = 1e5, 64 steps) vs plain",
                       (out[5]["iters"], out[5]["resid"]),
                       (ref[5]["iters"], ref[5]["resid"]), cfg.tol):
        raise AssertionError("implicit_resident: Picard iterations differ from "
                             "the plain version's at the row's shape")
    del cfg, st, args, out, ref
    timed = resident_implicit_times(dev)
    records["implicit_resident"] = dict(timed[landau.N], max_abs_err=worst,
                                        at_max_n=timed[RESIDENT_TIMED_NS[-1]])
    return records


def resident_implicit_times(dev) -> dict:
    """Device time of one 64-step launch of the resident implicit kernel
    at the configs[1] row's load and loop options (tools/landau.py: tol
    1e-6, maxiter 50, picard_init 'field', no Anderson) for each n of
    RESIDENT_TIMED_NS: the median of three calls, each the median of five
    launches between CUDA events; with the Picard passes the launch ran,
    µs a pass, the bound and the plain version's time. It calls the
    wrapper by name alone, so it times another tree of the port as well (a
    parent commit, for a paired comparison in one chip call)."""
    from pypic_tpu_torch.engines import implicit
    from pypic_tpu_torch.ops import cuda_cic as K
    from pypic_tpu_torch.tools import landau

    out = {}
    for n in RESIDENT_TIMED_NS:
        cfg, st = landau.state(n, dev)
        rkw = implicit.resident_kwargs(st, cfg)
        args = (st.e, st.e_prev, st.j, st.p, st.v, NG, landau.STEPS_PER_CALL)
        passes = int(K.implicit_resident(*args, **rkw)[5]["iters"].sum())
        calls = [cuda_ms(lambda: K.implicit_resident(*args, **rkw), reps=5, calls=1)
                 for _ in range(3)]
        ms = statistics.median(calls)
        rec = _rec(None, ms, cuda_ms(lambda: K.implicit_resident_plain(*args, **rkw),
                                     reps=1, calls=1),
                   "implicit_resident", n, landau.STEPS_PER_CALL, passes)
        rec.update(ms_calls=calls, passes=passes, us_per_pass=ms * 1e3 / passes)
        log(f"[implicit kernels]   implicit_resident at n = {n}, "
            f"{landau.STEPS_PER_CALL} steps: {ms:.4f} ms (calls "
            f"{', '.join(f'{t:.4f}' for t in calls)}), {passes} Picard passes, "
            f"{rec['us_per_pass']:.3f} us a pass, bound {rec['bound_ms']:.4f} ms, "
            f"plain {rec['plain_ms']:.4f} ms")
        out[n] = rec
        del cfg, st, args
    return out


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


def _mag_inputs(n: int, gen: torch.Generator, dev, ng: int = NG_MAG):
    """Bounded-grid particles at ng nodes (600 by default): a tenth
    inactive, the first rows at the walls and off the grid (wall-lost
    slots); const = 0.5 dt e Z / m for Z in 1..5 and boron's mass."""
    f32 = torch.float32
    p = torch.rand(n, generator=gen, device=dev, dtype=f32) * (ng - 1)
    p[:4] = torch.tensor([0.0, ng - 1.0, -0.3, ng - 0.7], device=dev)
    v = torch.randn((3, n), generator=gen, device=dev, dtype=f32) * 2e4
    act = (torch.rand(n, generator=gen, device=dev) < 0.9).to(f32)
    act[2:4] = 0.0
    z = torch.randint(1, 6, (n,), generator=gen, device=dev).to(f32)
    const = z * (0.5 * 1e-10 * 1.602e-19 / (10.81 * 1.67e-27))
    field = torch.randn(ng, generator=gen, device=dev, dtype=f32) * 1e5
    return field, p, v[0], v[1], v[2], const, act


def _newton_cases(dev):
    """tests/test_pallas.py:315-342's inputs at ng = 600, 301 and 128."""
    import numpy as np

    for ng in (600, 301, 128):
        rng = np.random.default_rng(11 + ng)
        dens = (1e17 * (1.0 + 0.3 * rng.standard_normal(ng))).clip(1e15)
        yield ng, torch.from_numpy((1.602e-19 * dens).astype(np.float32)).to(dev)


def _newton_row_solve(name: str, dev):
    """(solve, plain, ng): the wrapper and its plain version at the row's
    first solve, each taking the tol and maxiter keywords. D-D: the
    configs[3] row's deposit, n0 = 0.9 <n>, cold start, the config's tol
    and maxiter by default; D-N: the D-N row's, warm start 0, the
    wrapper's defaults (the engine's)."""
    from pypic_tpu_torch.ops import cuda_cic as K
    from pypic_tpu_torch.ops import cuda_newton
    from pypic_tpu_torch.tools import magnetized as row

    if name == "boltzmann_dirichlet":
        cfg, st, _ = row.state(dev)
        w_rho = st.charge_state * 1.602e-19 * st.p2c / cfg.grid.dx
        dens, n_dens = K.deposit2(st.p, w_rho, st.p2c / cfg.grid.dx, NG_MAG,
                                  periodic=False)
        n0 = 0.9 * torch.mean(n_dens)
        row_kw = dict(tol=cfg.newton_tol, maxiter=cfg.newton_maxiter)

        def solve(fn, **kw):
            return fn(dens, n0, cfg.te, cfg.grid.dx, **{**row_kw, **kw})

        return (functools.partial(solve, cuda_newton.boltzmann_dirichlet),
                functools.partial(solve, cuda_newton.boltzmann_dirichlet_plain), NG_MAG)
    pre = row.preset("dn", dev)
    cfg, st = pre.config, pre.state
    _, n_dens = K.deposit2(st.p, st.p2c / cfg.grid.dx, st.p2c / cfg.grid.dx,
                           NG_DN, periodic=False)
    n0 = 0.9 * torch.mean(n_dens)
    phi0 = torch.zeros(NG_DN, dtype=torch.float32, device=dev)

    def solve(fn, **kw):
        return fn(n_dens, n0, cfg.te, cfg.grid.dx, phi0, **kw)

    return (functools.partial(solve, cuda_newton.boltzmann_dn),
            functools.partial(solve, cuda_newton.boltzmann_dn_plain), NG_DN)


def newton_times(dev, names=("boltzmann_dirichlet", "boltzmann_dn")) -> dict:
    """Device times of the Newton kernels at their rows' first solves
    (boltzmann_dirichlet at the configs[3] row's, boltzmann_dn at the D-N
    row's): each the median of three profiler calls (``device_ms``), with
    µs an iteration, the bound and the plain version's time; then a long
    solve (NEWTON_LONG: tol 0, maxiter 64) and the count it ran, from which
    the marginal µs an iteration and the launch's fixed cost. It calls the
    wrappers by name alone, so it times another tree of the port as well
    (a parent commit, for a paired comparison in one chip call)."""
    out = {}
    for name in names:
        solve, plain, ng = _newton_row_solve(name, dev)
        iters = int(solve().iterations)
        calls = [device_ms(solve) for _ in range(3)]
        ms = statistics.median(calls)
        rec = _rec(None, ms, cuda_ms(plain, reps=3, calls=3), name, ng, iters)
        long_iters = int(solve(**NEWTON_LONG).iterations)
        long_ms = device_ms(lambda: solve(**NEWTON_LONG))
        marginal = (long_ms - ms) / max(long_iters - iters, 1)
        rec.update(ms_calls=calls, iterations=iters, us_per_iteration=ms * 1e3 / iters,
                   long_solve=dict(iterations=long_iters, ms=long_ms,
                                   us_per_iteration=long_ms * 1e3 / long_iters,
                                   marginal_us_per_iteration=marginal * 1e3,
                                   fixed_us=(ms - iters * marginal) * 1e3))
        log(f"[newton] {name} at ng = {ng}: {ms:.4f} ms (calls "
            f"{', '.join(f'{t:.4f}' for t in calls)}), {iters} iterations, "
            f"{rec['us_per_iteration']:.3f} us an iteration; long solve {long_iters} "
            f"iterations {long_ms:.4f} ms: {marginal * 1e3:.3f} us a further "
            f"iteration, fixed {(ms - iters * marginal) * 1e3:.3f} us; plain "
            f"{rec['plain_ms']:.4f} ms")
        out[name] = rec
        del solve, plain
    return out


def phase_magnetized_kernels(dev) -> dict:
    """The magnetized engine's four kernels against their plain versions
    at the ragged and the row's n; returns the records at the row's n (the
    Newton solve at the row's first solve)."""
    import numpy as np

    from pypic_tpu_torch.ops import cuda_cic as K
    from pypic_tpu_torch.ops import cuda_newton, cuda_rng

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
    solve, plain, _ = _newton_row_solve("boltzmann_dirichlet", dev)
    got, ref = solve(), plain()
    iters = int(got.iterations)
    a, rel = rel_err(ref.phi, got.phi)
    worst = max(worst, _check(
        {"phi": dict(abs=a, err=rel, kind=f"rel ({iters} vs plain "
                     f"{int(ref.iterations)} iterations)", tol=TOL_NEWTON_PHI)},
        "boltzmann_dirichlet(configs[3] row's first solve)"))
    del solve, plain
    records["boltzmann_dirichlet"] = dict(
        newton_times(dev, ("boltzmann_dirichlet",))["boltzmann_dirichlet"],
        max_abs_err=worst)
    return records


def _scaled_gap(ref, got, rtol: float, atol: float) -> float:
    """max |got - ref| / (atol + rtol |ref|), an equal pair counting 0
    where the bound is 0 (a node both sides leave empty)."""
    d = (got - ref).abs()
    q = torch.where(d == 0, 0.0, d / (atol + rtol * ref.abs()))
    return float(q.max())


def _mag_step_errors(c, g, rows=None) -> dict:
    """One step on the CPU (c) and the card (g), each (state, metrics):
    the largest |g - c| / (atol + rtol |c|) of each quantity (<= 1 passes
    assert_allclose's test); p and v over the active rows (and ``rows``,
    a host mask, where given)."""
    sc, mc = c
    sg, mg = g
    act = sc.active == 1
    if rows is not None:
        act = act & rows

    def worst(ref, got, key):
        rtol, atol = TOL_MAG_STEP[key]
        ref, got = ref.double(), got.double().cpu()
        return _scaled_gap(ref, got, rtol, atol)

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
    # the IEAD histogram's own traffic of the last step, for deposit_times
    pos, weight, hit = row.last_iead_traffic(cfg, fin)
    if int(hit.sum()) != int(m.n_hit_wall[-1]):
        problems.append(f"the final state's {int(hit.sum())} inactive slots are not "
                        f"the last step's {int(m.n_hit_wall[-1])} wall hits")
    res["iead_traffic"] = (pos, weight, fin.iead.numel())
    log(f"[magnetized slice] the last step's IEAD traffic: {int(hit.sum())} wall "
        f"hits, {int(weight.sum())} in range, {fin.iead.numel()} bins")
    del fin, m, hit
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


def _offset_view(t: torch.Tensor) -> torch.Tensor:
    """t copied into a buffer one float in: a contiguous view that is not
    16-B aligned (the sheath pass kernels' row-by-row path)."""
    buf = torch.empty(t.shape[0] + 1, dtype=t.dtype, device=t.device)
    buf[1:].copy_(t)
    return buf[1:]


def _row_mix(n: int, gen: torch.Generator, dev) -> torch.Tensor:
    """The configs[2] row's statuses: 1 but for REINJECT_ROW_LOST rows at
    random places, half at 0 and half at -1."""
    act = torch.ones(n, device=dev)
    rows = torch.randperm(n, generator=gen, device=dev)[:REINJECT_ROW_LOST]
    act[rows[:REINJECT_ROW_LOST // 2]] = 0.0
    act[rows[REINJECT_ROW_LOST // 2:]] = -1.0
    return act


def _rotating(fn, args, **kw):
    """A call of fn on ROTATE_SETS copies of args, the next copy each time,
    the outputs of the last ROTATE_SETS calls held."""
    copies = itertools.cycle([tuple(a.clone() for a in args)
                              for _ in range(ROTATE_SETS)])
    held = collections.deque(maxlen=ROTATE_SETS)
    return lambda: held.append(fn(*next(copies), **kw))


def _timed(fn, plain_ms: float, name: str, n: int, **extra) -> dict:
    """_rec of the median of three device_ms calls, the three kept (its
    max_abs_err is the caller's to fill)."""
    calls = [device_ms(fn) for _ in range(3)]
    rec = _rec(None, statistics.median(calls), plain_ms, name, n, **extra)
    rec["ms_calls"] = calls
    return rec


def _reinject_inputs(n: int, gen: torch.Generator, dev):
    """Positions in [0, 50), velocities, per-row sigmas and the two status
    mixes of the re-injection: phase 16's yardstick (80% active, 10% each
    lost) and the row's own (REINJECT_ROW_LOST rows lost at random
    places)."""
    p = torch.rand(n, generator=gen, device=dev) * 50.0
    v = torch.randn((3, n), generator=gen, device=dev) * 1e5
    sig = torch.where(torch.rand(n, generator=gen, device=dev) < 0.5, 1.3e6, 3.1e4)
    mixes = {"80/10/10": torch.where(
        torch.rand(n, generator=gen, device=dev) < 0.8, 1.0,
        torch.where(torch.rand(n, generator=gen, device=dev) < 0.5, 0.0, -1.0)),
             "row": _row_mix(n, gen, dev)}
    return p, v, sig, mixes


def sheath_times(dev) -> dict:
    """Device times of the three sheath kernels at the row's shape (n =
    1e6, ng = 51; the re-injection at gamma 0 at the 80/10/10 mix, the
    table's yardstick, and at the row's own mix beside it): each the
    median of three profiler calls, each call on the next of ROTATE_SETS
    copies of its inputs; the plain versions' times, and torch.rand((5, n))
    as the re-injection's library call. It calls the wrappers by name
    alone, so it times another tree of the port as well (a parent commit,
    for a paired comparison in one chip call)."""
    from pypic_tpu_torch.ops import cuda_rng, cuda_sheath as S

    gen = torch.Generator(device=dev).manual_seed(29)
    n, kw, fast = N_SHEATH, dict(dt=SHEATH_DT, dx=SHEATH_DX), dict(reps=3, calls=3)
    args = _sheath_inputs(n, NG_SHEATH, gen, dev)
    records = {}
    for name, fn, plain in (
            ("sheath_picard", S.sheath_picard, S.sheath_picard_plain),
            ("sheath_finalize", S.sheath_finalize, S.sheath_finalize_plain)):
        records[name] = _timed(_rotating(fn, args, **kw),
                               cuda_ms(lambda: plain(*args, **kw), **fast), name, n)
    del args
    p, v, sig, mixes = _reinject_inputs(n, gen, dev)
    key, step = (0, 3), 11
    timed = {}
    for mix, act in mixes.items():
        rargs = (p, v[0], v[1], v[2], act, sig)
        drawing = int((act != 1.0).sum())
        timed[mix] = _timed(
            _rotating(lambda *a: cuda_rng.sheath_reinject(key, step, *a, cells=50.0),
                      rargs),
            cuda_ms(lambda: cuda_rng.sheath_reinject_plain(
                key, step, *rargs, cells=50.0), **fast),
            "sheath_reinject", n,
            extra_bytes=REINJECT_DRAW_BYTES * drawing,
            extra_ops=REINJECT_DRAW_OPS * drawing)
        timed[mix]["drawing_rows"] = drawing
        log(f"[sheath kernels]   sheath_reinject at the {mix} mix "
            f"({drawing} rows re-injected): {timed[mix]['ms']:.4f} ms "
            f"(calls {', '.join(f'{t:.4f}' for t in timed[mix]['ms_calls'])}), "
            f"bound {timed[mix]['bound_ms']:.4f} ms")
    call = _rotating(lambda *a: cuda_rng.sheath_reinject(key, step, *a, cells=50.0),
                     (p, v[0], v[1], v[2], mixes["row"], sig))
    log(f"[sheath kernels]   sheath_reinject: {queued_ms(call):.4f} ms a "
        f"call at the row's mix from CUDA events behind a queued sleep "
        f"(device_ms's fallback) beside the profiler's {timed['row']['ms']:.4f} ms")
    g = torch.Generator(device=dev).manual_seed(5)
    lib = device_ms(_rotating(lambda: torch.rand((5, n), device=dev, generator=g),
                              ()))
    log(f"[sheath kernels]   sheath_reinject: library call torch.rand((5, n)) "
        f"{lib:.4f} ms, its last four outputs held; it writes 20 B a row, the "
        "kernel moves 36")
    records["sheath_reinject"] = dict(
        timed["80/10/10"], library_ms=lib,
        row_mix={key_: timed["row"][key_] for key_ in (
            "ms", "ms_calls", "bound_ms", "bound_by", "drawing_rows")})
    return records


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
    records, errors = {}, {}
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
                off = fn(*[_offset_view(a) for a in args], **kw)
                for label, g, a_ in zip(labels + ("j",), off, got):
                    if not torch.equal(g, a_):
                        raise AssertionError(
                            f"{name}: {label} from inputs one float in differs "
                            "from the aligned inputs'")
                if not all(g.is_contiguous() and g.data_ptr() % 16 == 0
                           for g in off[:-1]):
                    raise AssertionError(f"{name}: an output view is not 16-B aligned")
                log(f"[sheath kernels]   {name}: inputs one float in (the "
                    "row-by-row path) give every output, the current too, "
                    "bit-equal to the aligned inputs'; the outputs are 16-B "
                    "aligned views")
                if n == N_SHEATH and ng == NG_SHEATH:
                    errors[name] = err
                del got, ref, j64, vals, off
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

        p, v, sig, mixes = _reinject_inputs(n, gen, dev)
        key, step = (0, 3), 11
        worst = 0.0
        for gamma in (0.0, 0.5):
            u = cuda_rng.sheath_uniforms(key, step, n, gamma=gamma, device=dev)
            if not torch.equal(u.cpu(), cuda_rng.sheath_uniforms(
                    key, step, n, gamma=gamma, device="cpu")):
                raise AssertionError("sheath_reinject: the kernel's Philox uniforms "
                                     "differ from reinject_bits_plain's")
            for mix, act in mixes.items():
                for layout in ("aligned", "offset"):
                    rargs = (p, v[0], v[1], v[2], act, sig, 0.5 * sig)
                    if layout == "offset":
                        rargs = tuple(_offset_view(a) for a in rargs)
                    what = f"sheath_reinject(gamma={gamma}, {mix}, {layout})"
                    got = cuda_rng.sheath_reinject(key, step, *rargs, cells=50.0,
                                                   gamma=gamma)
                    ref = cuda_rng.sheath_reinject_plain(key, step, *rargs,
                                                         cells=50.0, gamma=gamma)
                    torch.cuda.synchronize()
                    if not torch.equal(got[0], ref[0]):
                        raise AssertionError(f"{what}: positions differ from the "
                                             "plain version's")
                    held = rargs[4] == 1.0
                    if gamma > 0.0:
                        held &= ~(u[5] < gamma)
                    if not all(torch.equal(g[held], a[held])
                               for g, a in zip(got, rargs[:4])):
                        raise AssertionError(f"{what}: a held row changed")
                    if not all(g.is_contiguous() and g.data_ptr() % 16 == 0
                               for g in got):
                        raise AssertionError(f"{what}: an output view is not "
                                             "16-B aligned")
                    errs = {}
                    for k_, r_, g_ in zip(("u", "vy", "vz"), ref[1:], got[1:]):
                        a_, rel = rel_err(r_, g_)
                        errs[k_] = dict(abs=a_, err=rel, kind="rel", tol=TOL_SOURCE)
                    worst = max(worst, _check(errs, what))
                    log(f"[sheath kernels]   {what}: positions bit-equal to the "
                        f"plain version's, {int(held.sum())} held rows bit-equal "
                        f"to their inputs, {n - int(held.sum())} drawn")
                    del got, ref, held, rargs
            log(f"[sheath kernels]   sheath_reinject(gamma={gamma}): {u.shape[0] * n} "
                "Philox uniforms bit-equal to the plain version's")
            del u
        if n == N_SHEATH:
            errors["sheath_reinject"] = worst
        del p, v, sig, mixes
        torch.cuda.empty_cache()
    records["deposit_det"]["versus_atomic"] = _deposit_det_cost(dev, gen)
    for name, rec in sheath_times(dev).items():
        records[name] = dict(rec, max_abs_err=errors[name])
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
    solve, plain, _ = _newton_row_solve("boltzmann_dn", dev)
    got, ref = solve(), plain()
    iters = int(got.iterations)
    a, rel = rel_err(ref.phi, got.phi)
    worst = max(worst, _check(
        {"phi": dict(abs=a, err=rel, kind=f"rel ({iters} vs plain "
                     f"{int(ref.iterations)} iterations)", tol=TOL_DN_PHI)},
        "boltzmann_dn(the D-N row's first solve)"))
    del solve, plain
    records = {"boltzmann_dn": dict(newton_times(dev, ("boltzmann_dn",))["boltzmann_dn"],
                                    max_abs_err=worst)}
    fast = dict(reps=3, calls=3)

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
        keys = ("n_hit_wall", "n_reactivated", "newton_iters", "n_active")
        if cfg_cpu.carried_deposit == "on":
            # the rho and n the step carries into the next
            rtol, atol = TOL_MAG_STEP["rho"]
            for k in ("rho", "n"):
                errs[f"{k} carried"] = _scaled_gap(
                    getattr(c[0], k).double(), getattr(g[0], k).double().cpu(),
                    rtol, atol)
            keys += ("carry_clamped",)
        counts = {k: (int(getattr(c[1], k)), int(getattr(g[1], k)))
                  for k in keys}
        log(f"[{label}] n = {pre_cpu.state.p.shape[0]}, step {i} -> {i + 1}, GPU vs "
            "CPU, |d| / (atol + rtol |ref|) (<= 1 passes): "
            + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
            + f"; counts (CPU, GPU) {counts}")
        bad = {k: v for k, v in errs.items() if not v <= 1.0}
        for k in ("n_active", "n_reactivated", "carry_clamped"):
            if k in counts and counts[k][0] != counts[k][1]:
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


# phase 24, the Newton family's large path (csrc/newton.cu above 1,024
# rows) against its plain version, as phase 37 holds tridiag3_chain: phi
# (and x, the six interface scalars) within TOL_CHAIN of the largest |x|,
# stated before the first run. The Newton solves run a fixed count of
# iterations (tol 0), so both sides run the same loop; the long solve
# gives the marginal us an iteration. The load is tests/test_pallas.py's
# (1e17 m^-3 with 30% noise, Te 10 eV, dx 2e-5 m) at these rows.
NEWTON_LARGE_ROWS = (1025, 4096, 16_384, 262_144)
NEWTON_LARGE_TIMED = (4096, 16_384, 262_144)
CHAIN_LARGE_CS = (1025, 16_384)
CHAIN_LARGE_TIMED = (4096, 16_384, 262_144)
LARGE_SOLVE = dict(tol=0.0, maxiter=8)
LARGE_SOLVE_LONG = dict(tol=0.0, maxiter=64)
# the shapes phase 39 (the slice's main path) gives each large path
LARGE_MAIN = {"boltzmann_dirichlet_large": 16_384, "boltzmann_dn_large": 8000,
              "tridiag3_chain_large": 16_384}
# dense torch.linalg.solve, the chain's library yardstick, up to this c
DENSE_MAX_C = 4096


def _newton_large_solve(name: str, rows: int, dev):
    """(solve, plain): the large path's wrapper and its plain version on
    phase 24's load at ``rows``, each taking the tol and maxiter
    keywords. D-D: rho = e n, n0 = 1e17, cold start; D-N: n, n0 = 0.9e17,
    warm start 0."""
    import numpy as np

    from pypic_tpu_torch.constants import E_CHARGE
    from pypic_tpu_torch.ops import cuda_newton

    rng = np.random.default_rng(11 + rows)
    dens = (1e17 * (1.0 + 0.3 * rng.standard_normal(rows))).clip(1e15)
    te, dx = 11600.0 * 10.0, 2e-5
    if name == "boltzmann_dirichlet_large":
        rho = torch.from_numpy((E_CHARGE * dens).astype(np.float32)).to(dev)

        def solve(fn, **kw):
            return fn(rho, 1e17, te, dx, **kw)

        return (functools.partial(solve, cuda_newton.boltzmann_dirichlet),
                functools.partial(solve, cuda_newton.boltzmann_dirichlet_plain))
    n = torch.from_numpy(dens.astype(np.float32)).to(dev)
    phi0 = torch.zeros(rows, dtype=torch.float32, device=dev)

    def solve_dn(fn, **kw):
        return fn(n, 0.9e17, te, dx, phi0, **kw)

    return (functools.partial(solve_dn, cuda_newton.boltzmann_dn),
            functools.partial(solve_dn, cuda_newton.boltzmann_dn_plain))


def newton_large_times(dev) -> dict:
    """boltzmann_dirichlet and boltzmann_dn on their large path at
    NEWTON_LARGE_ROWS and the main path's shape, LARGE_SOLVE iterations,
    against the plain version: one launch of the large path a call (none
    of the small), equal iteration counts, phi within TOL_CHAIN of the
    largest |phi|; at NEWTON_LARGE_TIMED and the main shape timed
    (device_ms) with the long solve's marginal us an iteration, the plain
    version's ms and the bound. Returns {name: {rows: record}}."""
    from pypic_tpu_torch.ops import cuda_cic as K
    from pypic_tpu_torch.ops import cuda_newton

    out = {}
    for name in ("boltzmann_dirichlet_large", "boltzmann_dn_large"):
        small = name[:-len("_large")]
        out[name] = {}
        for rows in sorted(set(NEWTON_LARGE_ROWS) | {LARGE_MAIN[name]}):
            solve, plain = _newton_large_solve(name, rows, dev)
            before = dict(K.LAUNCHES)
            got = solve(**LARGE_SOLVE)
            torch.cuda.synchronize()
            if (K.LAUNCHES[name] != before[name] + 1
                    or K.LAUNCHES[small] != before[small]):
                raise AssertionError(f"{name} at {rows} rows: launches "
                                     f"{K.LAUNCHES[name] - before[name]} of the large "
                                     f"path, {K.LAUNCHES[small] - before[small]} of "
                                     "the small")
            ref = plain(**LARGE_SOLVE)
            err, rel = rel_err(ref.phi, got.phi)
            its = (int(got.iterations), int(ref.iterations))
            k, threads = cuda_newton.large_split(rows)
            log(f"[size limits] {name} at {rows} rows (k = {k}, {threads} "
                f"threads), {its[0]} iterations (plain {its[1]}): max |err| "
                f"{err:.3e}, {rel:.3e} of max |phi| (tol {TOL_CHAIN})")
            if not (rel <= TOL_CHAIN and its[0] == its[1] == LARGE_SOLVE["maxiter"]
                    and bool(torch.isfinite(got.phi).all())):
                raise AssertionError(f"{name} at {rows} rows: {rel} of max |phi|, "
                                     f"iterations {its}")
            rec = dict(n=rows, k=k, threads=threads, max_abs_err=err, rel_err=rel)
            if rows in NEWTON_LARGE_TIMED or rows == LARGE_MAIN[name]:
                iters = LARGE_SOLVE["maxiter"]
                long_iters = LARGE_SOLVE_LONG["maxiter"]
                ms = device_ms(lambda: solve(**LARGE_SOLVE), calls=10)
                long_ms = device_ms(lambda: solve(**LARGE_SOLVE_LONG), calls=5)
                marginal = (long_ms - ms) / (long_iters - iters)
                plain_ms = cuda_ms(lambda: plain(**LARGE_SOLVE), reps=3, calls=1)
                b, by = bound(small, rows, iters)
                rec.update(ms=ms, iterations=iters, us_per_iteration=ms * 1e3 / iters,
                           marginal_us_per_iteration=marginal * 1e3,
                           fixed_us=(ms - iters * marginal) * 1e3,
                           long_solve=dict(iterations=long_iters, ms=long_ms),
                           plain_ms=plain_ms, bound_ms=b, bound_by=by,
                           library_ms=None)
                log(f"[size limits] {name} at {rows} rows: {ms:.4f} ms for {iters} "
                    f"iterations ({ms * 1e3 / iters:.2f} us an iteration; long solve "
                    f"{long_ms:.4f} ms for {long_iters}: {marginal * 1e3:.2f} us a "
                    f"further iteration, fixed {rec['fixed_us']:.2f} us), plain "
                    f"{plain_ms:.3f} ms, bound {b:.2e} ms ({by}); no library call "
                    "solves a tridiagonal system")
            out[name][rows] = rec
            del solve, plain, got, ref
    return out


def chain_large_times(dev) -> dict:
    """tridiag3_chain on its large path against its plain version: at
    CHAIN_LARGE_CS with all four (first, last) ends, and at
    CHAIN_LARGE_TIMED and the main shape at the chain's end ranks; one
    launch of the large path a call, x and the six interface scalars
    within TOL_CHAIN of the largest |x| (phase 37's Boltzmann-Jacobian
    systems). Timed (device_ms) beside the plain version and, up to
    DENSE_MAX_C, dense torch.linalg.solve. Returns {c: record}."""
    from pypic_tpu_torch.ops import cuda_cic as K
    from pypic_tpu_torch.ops import cuda_newton

    gen = torch.Generator().manual_seed(39)
    out = {}
    ends_all = ((True, True), (True, False), (False, True), (False, False))
    for c in sorted(set(CHAIN_LARGE_CS) | set(CHAIN_LARGE_TIMED)
                    | {LARGE_MAIN["tridiag3_chain_large"]}):
        dl, d, du, f = _chain_system(c, "boltzmann", gen, dev)
        errs = []
        for first, last in (ends_all if c in CHAIN_LARGE_CS else ends_all[:1]):
            before = dict(K.LAUNCHES)
            x, g6 = cuda_newton.tridiag3_chain(dl, d, du, f, first=first, last=last)
            torch.cuda.synchronize()
            if (K.LAUNCHES["tridiag3_chain_large"] != before["tridiag3_chain_large"] + 1
                    or K.LAUNCHES["tridiag3_chain"] != before["tridiag3_chain"]):
                raise AssertionError(f"tridiag3_chain c = {c}: not one launch of "
                                     "the large path")
            xr, gr = cuda_newton.tridiag3_chain_plain(dl, d, du, f, first=first,
                                                      last=last)
            err = float(torch.maximum((x - xr).abs().max(), (g6 - gr).abs().max()))
            scale = float(xr.abs().max())
            log(f"[size limits] tridiag3_chain c = {c} (first {first}, last "
                f"{last}): max |err| {err:.3e} of max |x| {scale:.3e} (tol "
                f"{TOL_CHAIN} of it)")
            if not err <= TOL_CHAIN * scale:
                raise AssertionError(f"tridiag3_chain c = {c}: {err} > "
                                     f"{TOL_CHAIN} x {scale}")
            errs.append(err)
        rec = dict(n=c, max_abs_err=max(errs))
        if c in CHAIN_LARGE_TIMED or c == LARGE_MAIN["tridiag3_chain_large"]:
            held = collections.deque(maxlen=4)
            ms = device_ms(lambda: held.append(cuda_newton.tridiag3_chain(
                dl, d, du, f, first=True, last=True)), calls=10)
            plain_ms = cuda_ms(lambda: held.append(cuda_newton.tridiag3_chain_plain(
                dl, d, du, f, first=True, last=True)), reps=3, calls=1)
            lib_ms = None
            if c <= DENSE_MAX_C:
                dl_in, du_in = dl.clone(), du.clone()
                dl_in[0] = 0.0
                du_in[-1] = 0.0
                rhs = torch.zeros((c, 3), dtype=torch.float32, device=dev)
                rhs[:, 0] = f
                rhs[0, 1] = 1.0
                rhs[c - 1, 2] = 1.0
                dense = (torch.diag(d) + torch.diag(dl_in[1:], -1)
                         + torch.diag(du_in[:-1], 1))
                lib_ms = device_ms(lambda: held.append(torch.linalg.solve(dense, rhs)))
            bound_ms = (CHAIN_BYTES_ROW * c + CHAIN_BYTES_FIXED) / PEAK_BYTES_PER_S * 1e3
            rec.update(ms=ms, us_per_solve=ms * 1e3, plain_ms=plain_ms,
                       library_ms=lib_ms, bound_ms=bound_ms, bound_by="bytes")
            log(f"[size limits] tridiag3_chain c = {c}: {ms * 1e3:.2f} us a solve "
                f"(plain {plain_ms:.3f} ms" + (f", dense torch.linalg.solve "
                                                f"{lib_ms:.4f} ms" if lib_ms else "")
                + f"; bound {bound_ms:.2e} ms by bytes)")
            held.clear()
        out[c] = rec
    return out


def phase_size_limits(dev) -> dict:
    """Phase 24 (module docstring): the wrappers that keep a card ceiling
    raise above it; the Newton family's large path against its plain
    version; a magnetized step at ng = NG_FAULT with 'auto' and 'pallas'
    on the large D-D kernel."""
    import dataclasses

    from pypic_tpu_torch import presets
    from pypic_tpu_torch.engines import magnetized
    from pypic_tpu_torch.ops import cuda_cic as K
    from pypic_tpu_torch.ops import cuda_sheath

    z = lambda k: torch.zeros(k, dtype=torch.float32, device=dev)  # noqa: E731
    p, big = z(64), K.SMEM_LIMIT // 4 + 1
    kw = dict(qm=-1.7e11, w=-3.2e-9, dt=1e-7, dx=0.05)
    # the rows still bounded by shared memory raise naming ROADMAP item 10;
    # the four with a large mode (phase 40) only above LARGE_MAX_NG
    top = K.LARGE_MAX_NG + 1
    calls = {
        "picard_iteration": lambda: K.picard_iteration(
            z(K.SMEM_LIMIT // 8 + 1), p, p, p, K.SMEM_LIMIT // 8 + 1, **kw),
        "deposit": lambda: K.deposit(p, p, big, periodic=True),
        "gather": lambda: K.gather(z(big), p, periodic=False),
        "boris_gather_push": lambda: K.boris_gather_push(
            z(big), p, p, p, p, p, p, b=(0.0, 1.0, 0.0), dt_dx=1.0),
        "deposit2": lambda: K.deposit2(p, p, p, top, periodic=False),
        "boris_gather_push_deposit": lambda: K.boris_gather_push_deposit(
            z(top), p, p, p, p, p, p, p, p, b=(0.0, 1.0, 0.0), dt_dx=1.0),
        "deposit_det": lambda: K.deposit_det(p, p, top, periodic=False),
        "sheath_picard": lambda: cuda_sheath.sheath_picard(
            z(top), p, p, p, p, p, p, dt=1e-12, dx=1e-5),
        "sheath_finalize": lambda: cuda_sheath.sheath_finalize(
            z(top), p, p, p, p, p, p, dt=1e-12, dx=1e-5),
    }
    large = ("deposit2", "boris_gather_push_deposit", "deposit_det",
             "sheath_picard", "sheath_finalize")
    K.reset_launch_counts()
    for name, call in calls.items():
        try:
            call()
        except ValueError as e:
            log(f"[size limits] {name} on the card raises: {str(e)[:110]}")
            want = "LARGE_MAX_NG" if name in large else "item 10"
            if want not in str(e):
                raise AssertionError(f"{name}'s raise does not name {want}: {e}")
        else:
            raise AssertionError(f"{name} ran above its limit on the card")
    if any(K.LAUNCHES.values()):
        raise AssertionError(f"launches above the limits: {K.LAUNCHES}")
    res = {"newton_large": newton_large_times(dev),
           "chain_large": chain_large_times(dev)}

    pre = presets.pic_iead(n_per_species=500, ng=NG_FAULT, device=dev)
    res["fault_step"] = {}
    # 'xla' first: the op-composed Thomas route that 'auto' took at this
    # grid before the large path, timed here beside the kernel's routes
    for backend in ("xla", "auto", "pallas"):
        step = magnetized.make_step(dataclasses.replace(
            pre.config, newton_backend=backend))
        step(pre.state)  # warm-up: the first launch of each PyTorch kernel
        torch.cuda.synchronize()
        K.reset_launch_counts()
        for k in magnetized.THOMAS_SOLVES:
            magnetized.THOMAS_SOLVES[k] = 0
        t0 = time.perf_counter()
        st, m = step(pre.state)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {k: v for k, v in K.LAUNCHES.items() if v}
        thomas = dict(magnetized.THOMAS_SOLVES)
        beside = ("" if backend == "xla" else f" (the 'xla' Thomas route's "
                  f"{res['fault_step']['xla']['wall_ms']:.2f} ms)")
        log(f"[size limits] a magnetized step at ng = {NG_FAULT}, '{backend}': "
            f"{seconds * 1e3:.2f} ms of wall time{beside}, Thomas solves "
            f"{thomas}, {int(m.newton_iters)} Newton iterations, residual "
            f"{float(m.newton_residual):.3e}, launches {launches}")
        newton = K.LAUNCHES["boltzmann_dirichlet_large"] + K.LAUNCHES["boltzmann_dirichlet"]
        if backend == "xla":
            if thomas != {"dirichlet": 1, "dirichlet_neumann": 0} or newton:
                raise AssertionError(f"'xla' at ng = {NG_FAULT}: Thomas solves "
                                     f"{thomas}, {newton} Newton launches")
        elif (any(thomas.values()) or K.LAUNCHES["boltzmann_dirichlet_large"] != 1
              or K.LAUNCHES["boltzmann_dirichlet"] != 0):
            raise AssertionError(f"'{backend}' at ng = {NG_FAULT} did not take "
                                 "the large D-D kernel once")
        if not (bool(torch.isfinite(m.phi).all())
                and float(m.newton_residual) <= pre.config.newton_tol):
            raise AssertionError(f"'{backend}' at ng = {NG_FAULT}: phi did not "
                                 "converge")
        res["fault_step"][backend] = dict(
            wall_ms=seconds * 1e3, newton_iters=int(m.newton_iters),
            residual=float(m.newton_residual))
    K.reset_launch_counts()
    return res


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
    """The domain engines at n = 20,000 from one CPU-made load (the
    implicit engine, the explicit carrier and, for phase 29, the carried
    carrier): on a one-rank mesh, card (the kernels) against CPU (their
    plain versions), 5 steps; then two ranks on the one card (gloo over CUDA tensors, each
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
    # (label, engine, overrides, counts held equal, launches a rank); the
    # carried carrier is phase 29's, riding these spawns
    engines = (
        ("implicit", "implicit", dict(backend="fused"),
         ("picard_iters", "n_migrated", "n_dropped", "n_halo_clamped", "n_alive"),
         {"picard_iteration_ext": 4 * steps, "picard_finalize_ext_nodep": steps,
          "deposit": 2}),
        ("explicit", "explicit", dict(push_backend="fused"),
         ("n_migrated", "n_dropped", "n_alive"),
         {"leapfrog_gather_push": steps, "deposit": 1 + steps}),
        ("explicit carried", "explicit", dict(carried_rho="on"),
         ("n_migrated", "n_dropped", "n_alive", "n_halo_clamped"),
         {"explicit_domain_cycle": steps, "deposit": 1}))
    jobs = [(engine, steps, over) for _, engine, over, _, _ in engines]
    for world in (1, 2):
        # one spawn a device and world size carries both engines
        t0 = time.perf_counter()
        gpus = spawn.run(world, row.rank_run, load, jobs, device=dev)
        cpus = spawn.run(world, row.rank_run, load, jobs, device="cpu")
        seconds = time.perf_counter() - t0
        log(f"[domain check] {world} rank{'s' if world > 1 else ''}, both "
            f"engines on the card and on the CPU: {seconds:.1f} s")
        for i, (name, _, _, counts, want) in enumerate(engines):
            label = f"{name}, {world} rank{'s' if world > 1 else ''}"
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
            if sum(gpu[0]["rows"]["n_halo_clamped"]):
                problems.append(f"{label}: halo clamped "
                                f"{gpu[0]['rows']['n_halo_clamped']}")
            # seconds: both engines' spawns of this world size
            res[label] = dict(seconds=seconds, staged_bytes=staged, migrated=migrated)
    if problems:
        raise AssertionError("domain check: " + "; ".join(problems))
    return res


def _domain_path(phase: str, label: str, build, n: int, timed: int, want: dict,
                 checks) -> dict:
    """One path of a domain row at n particles on the card: ``build()`` ->
    (cfg, state, step) with the launch counts set to 0 just before it,
    then tools/domain.drive (WARMUP_STEPS + ``timed`` steps, host syncs
    counted); fails unless the launches are ``want``, nothing is dropped,
    the state is finite and in range, and every check of ``checks(res)``
    (pairs (ok, message)) holds."""
    from pypic_tpu_torch.ops import cuda_cic
    from pypic_tpu_torch.tools import domain as row

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
    log(f"[{phase}] {label}: n = {n}, {timed} timed steps after "
        f"init_state + {WARMUP_STEPS} warm-up: {res['ms_per_step']:.4f} "
        f"ms/step, {res['pushes_per_s']:.4e} pushes/s, picard mean "
        f"{res.get('picard_mean', float('nan')):.2f}, total energy change "
        f"{res['total_energy_rel_change']:+.4e}, dropped {res['n_dropped']}, "
        f"halo clamped {res['n_halo_clamped']}, host syncs a step "
        f"{res['host_syncs_per_step']:.2f}, setup {setup:.2f} s, capacity "
        f"{res['capacity']}, halo {cfg.halo}, peak memory "
        f"{res['peak_mem_gib']:.2f} GiB")
    log(f"[{phase}] {label}: launches {launches}")
    finite = all(bool(torch.isfinite(t).all()) for t in (st.p, st.v))
    in_range = bool(((st.p >= 0) & (st.p <= NG)).all())
    problems = [] if finite and in_range else [f"finite={finite} in_range={in_range}"]
    if launches != want:
        problems.append(f"launches {launches} != {want}")
    if res["n_dropped"] or res["n_alive_last"] != n:
        problems.append(f"dropped {res['n_dropped']}, alive {res['n_alive_last']}")
    problems += [msg for ok, msg in checks(res) if not ok]
    if problems:
        raise AssertionError(f"{phase}, {label}: " + "; ".join(problems))
    del st
    torch.cuda.empty_cache()
    return res


def _cpu_rises(label: str, n: int, **overrides) -> list:
    """The explicit carrier's total energy change over WARMUP_STEPS +
    DOM_EXPLICIT steps on the CPU (its plain versions, a one-rank mesh)
    at n particles, one a load of DOM_RISE_SEEDS."""
    from pypic_tpu_torch.parallel import domain, make_mesh
    from pypic_tpu_torch.tools import domain as row

    t0 = time.perf_counter()
    cpu_mesh = make_mesh(device="cpu")
    rises = []
    for seed in DOM_RISE_SEEDS:
        cfg, st = row.explicit_row(cpu_mesh, n, seed=seed, **overrides)
        rises.append(row.drive(domain.make_step(cfg, cpu_mesh), st, n,
                               WARMUP_STEPS, DOM_EXPLICIT)[0][
                                   "total_energy_rel_change"])
    mean = sum(rises) / len(rises)
    log(f"[{label}] the explicit carrier{' (' + str(overrides) + ')' if overrides else ''} "
        f"on the CPU, n = {n}, {WARMUP_STEPS} + {DOM_EXPLICIT} steps, seeds "
        f"{DOM_RISE_SEEDS}: total energy change {[f'{r:+.6e}' for r in rises]}, "
        f"mean {mean:+.6e}, spread {(max(rises) - min(rises)) / abs(mean):.3e} "
        f"relative ({time.perf_counter() - t0:.1f} s)")
    return rises


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

    from pypic_tpu_torch.parallel import domain, domain_implicit, make_mesh
    from pypic_tpu_torch.tools import domain as row

    # the carrier's rise on the CPU (composed, plain kernels), made before
    # the NCCL group so that a CPU mesh is a one-rank mesh of its own
    cpu_rises = _cpu_rises("domain slice", DOM_RISE_N)
    cpu_rise = sum(cpu_rises) / len(cpu_rises)

    row.process_group()
    mesh = make_mesh(device=dev)
    if (mesh.world, mesh.backend) != (1, "nccl"):
        raise AssertionError(f"expected a one-rank NCCL mesh, got {mesh}")
    n = row.N

    def path(label, build, timed, want, checks) -> dict:
        return _domain_path("domain slice", label, build, n, timed, want, checks)

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


def _carried_mag_inputs(n: int, gen: torch.Generator, dev, hot: float,
                        ng: int = NG_MAG):
    """_mag_inputs with the velocities scaled by ``hot``, every off-grid row
    inactive, four active rows driven through the walls (two a side), and
    the carried weights: wn a number density, wr its charge (Z e wn), 0 in
    inactive rows."""
    field, p, vx, vy, vz, const, act = _mag_inputs(n, gen, dev, ng)
    vx, vy, vz = vx * hot, vy * hot, vz * hot
    p[4:8] = torch.tensor([0.2, 0.5, ng - 1.2, ng - 1.5], device=dev)
    vx[4:8] = torch.tensor([-3e5, -6e5, 3e5, 6e5], device=dev)
    act[4:8] = 1.0
    act = act * ((p >= 0) & (p <= ng - 1)).to(act.dtype)
    wn = act * 1e17
    wr = wn * const * (1.602e-19 / const.max())
    return field, p, vx, vy, vz, const, act, wr, wn


def _carrier_inputs(n: int, gen: torch.Generator, dev, ng: int, lo: float):
    """A rank's particles of the carried carrier: positions on its slab
    [lo, lo + 200), velocities of 2 cells a step (sigma), 5% dead slots
    (w = 0, p = v = 0), four live rows driven 20-40 cells past both slab
    edges (past the halo); the (ng,) global field."""
    f32 = torch.float32
    p = torch.rand(n, generator=gen, device=dev, dtype=f32) * DOM_C + lo
    v = torch.randn(n, generator=gen, device=dev, dtype=f32) * (2.0 * DX / DT)
    w = torch.full((n,), W, dtype=f32, device=dev)
    dead = torch.rand(n, generator=gen, device=dev) < 0.05
    dead[:4] = False
    w[dead] = 0.0
    p[dead] = 0.0
    v[dead] = 0.0
    p[:4] = torch.tensor([lo, lo + 1e-3, lo + DOM_C - 1e-3, lo + DOM_C - 0.5],
                         dtype=f32, device=dev)
    v[:4] = torch.tensor([-20.0, -40.0, 20.0, 40.0], dtype=f32, device=dev) * (DX / DT)
    # the kick qm dt / 2 E moves a particle ~0.5 cells at this field
    field = torch.randn(ng, generator=gen, device=dev, dtype=f32) * 30.0
    return field, p, v, w


def _single_inputs(shape: str, gen: torch.Generator, dev, iead=None):
    """Row 4's (positions, values, ng, periodic) at ``shape``: the carrier's
    extended slab (the particles on [hw, hw + c) of ext_n = c + 2 hw + 1
    nodes, a twentieth dead slots of weight 0 at its left edge), the
    headline's set-up (uniform on the periodic grid, dense values), the
    IEAD (``iead``: phase 15's positions, 0/1 weights and bins), the synthetic
    999,996 / 600 and the ragged n through a view one float in."""
    f32 = torch.float32
    if shape == "IEAD":
        pos, weight, bins = iead
        return pos, weight, bins, False
    if shape == "carrier":
        n, ng = N_HEADLINE, DOM_CARRIED_EXT_N
        p = torch.rand(n, generator=gen, device=dev, dtype=f32) * DOM_C + DOM_CARRIED_HALO
        w = torch.full((n,), W, dtype=f32, device=dev)
        dead = torch.rand(n, generator=gen, device=dev) < 0.05
        w[dead] = 0.0
        p[dead] = float(DOM_CARRIED_HALO)
        return p, w, ng, False
    if shape == "headline set-up":
        p = torch.rand(N_HEADLINE, generator=gen, device=dev, dtype=f32) * NG
        return p, torch.randn(N_HEADLINE, generator=gen, device=dev, dtype=f32) * W, NG, True
    n = N_MAG if shape.startswith("synthetic") else N_MAG_RAGGED
    p = torch.rand(n + 1, generator=gen, device=dev, dtype=f32) * (NG_MAG - 1)
    v = torch.randn(n + 1, generator=gen, device=dev, dtype=f32)
    if shape.startswith("synthetic"):
        return p[:n].contiguous(), v[:n].contiguous(), NG_MAG, False
    return p[1:], v[1:], NG_MAG, False  # one float in: not 16-B aligned


# row 20's operations at the integer rate (csrc/rng.cu's header): its
# Philox4x32-10 block is 20 wide products and 20 three-way xors a row, at
# no more than 64 integer lanes a clock an SM (32-bit integer multiplies
# and logic at compute capability 9.0); the transform counted at nothing
SOURCE_INT_OPS_A_ROW = 40
INT_LANES_PER_SM = 64


def _source_issue_bound(n: int, sms: int) -> dict:
    """Row 20's issue bound, the least time its integer work takes: n
    SOURCE_INT_OPS_A_ROW over sms x INT_LANES_PER_SM at the card's top SM
    clock. Beside it the kernel's own count, not a bound: the static SASS
    instructions of its widest loop (the batch, not the uniforms) a row
    (cuda_rng.SOURCE_ROWS_A_PASS rows a pass; one in the first port's
    form) at 132 SMs x 4 schedulers x 32 lanes a clock
    (tools/resident_split.py _sass_loop, sass_issue_ms)."""
    from pypic_tpu_torch.ops import _build, cuda_rng
    from pypic_tpu_torch.tools import resident_split as rs

    clock = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True).stdout.strip().splitlines()[0])
    out = dict(clock_max_mhz=clock, issue_bound_ms=(
        n * SOURCE_INT_OPS_A_ROW / (sms * INT_LANES_PER_SM * clock * 1e6) * 1e3),
        sass_per_row=None, own_sass_ms=None)
    # a tree of the port from before the tool counted the SASS has no count
    if hasattr(rs, "sass_issue_ms"):
        loop = rs._sass_loop(_build.library_path(), "source_batch_kernelILb0E")
        if loop["loop"]:
            out["sass_per_row"] = loop["loop"] / getattr(cuda_rng, "SOURCE_ROWS_A_PASS", 1)
            out["own_sass_ms"] = rs.sass_issue_ms(out["sass_per_row"], n, sms, clock)
    return out


def deposit_times(dev, iead=None) -> dict:
    """Device times of the wide-grid kernels at the shapes of their paths,
    each the median of three profiler calls (``device_ms``) with its
    inputs warm in the L2, then again with each call on the next of
    ROTATE_SETS copies (``_rotating``); the bound and the plain version's
    time; each output held against its plain version first. deposit2 at
    DEPOSIT_SHAPES and boris_gather_push_deposit at the configs[3] row's
    (pad 2, mirrored); deposit at the carrier's slab, the headline's
    set-up, the IEAD traffic ``iead`` (phase 15's (positions, weights,
    bins); skipped without it), the synthetic 999,996 / 600 and a ragged view,
    against float64 sums (the IEAD's counts exactly), with index_add_ at
    the IEAD as its library call; deposit_det at DEPOSIT_DET_SHAPES,
    bit-equal from call to call; source_batch at SOURCE_NS (uniforms
    bit-equal, normals within TOL_SOURCE), with torch.randn((4, n)) and
    its issue bound. It calls the wrappers by name alone, so it times
    another tree of the port as well (a parent commit, for a paired
    comparison in one chip call). Returns {kernel: {shape: record}}, each
    record with a 'rotated' record beside it."""
    import inspect

    from pypic_tpu_torch.ops import cic
    from pypic_tpu_torch.ops import cuda_cic as K
    from pypic_tpu_torch.ops import cuda_rng

    gen = torch.Generator(device=dev).manual_seed(31)
    fast = dict(reps=3, calls=3)
    bkw = dict(b=(0.1395, 1.9951, 0.0), dt_dx=1e-10 / 2.5e-6, pad=CARRIED_PAD,
               swap_weights=True)
    out = {}

    def timed(name, shape, n, args, fn, plain, plain_ms=None, **extra):
        if plain_ms is None:
            plain_ms = cuda_ms(lambda: plain(*args), **fast)
        rec = _timed(lambda: fn(*args), plain_ms, name, n, **extra)
        rec["rotated"] = {key: value for key, value in _timed(
            _rotating(fn, args), plain_ms, name, n, **extra).items()
            if key in ("ms", "ms_calls")}
        log(f"[deposit] {name} at {shape} (n = {n}): {rec['ms']:.4f} ms warm "
            f"(calls {', '.join(f'{t:.4f}' for t in rec['ms_calls'])}), "
            f"{rec['rotated']['ms']:.4f} rotated past the L2 (calls "
            f"{', '.join(f'{t:.4f}' for t in rec['rotated']['ms_calls'])}); bound "
            f"{rec['bound_ms']:.4f} ({rec['bound_by']}), plain {plain_ms:.4f}")
        out.setdefault(name, {})[shape] = rec
        return rec

    for shape, (n, ng) in DEPOSIT_SHAPES.items():
        _, p, vx, vy, _, _, act = _mag_inputs(n, gen, dev, ng)
        timed("deposit2", shape, n, (p, vx * act, vy.abs() * act),
              functools.partial(K.deposit2, ng=ng, periodic=False),
              functools.partial(K.deposit2_plain, ng=ng, periodic=False))
    timed("boris_gather_push_deposit", "configs[3]", N_MAG,
          _carried_mag_inputs(N_MAG, gen, dev, 1.0),
          functools.partial(K.boris_gather_push_deposit, **bkw),
          functools.partial(K.boris_gather_push_deposit_plain, **bkw))
    torch.cuda.empty_cache()

    shapes = ["carrier", "headline set-up", "IEAD", "synthetic 999,996 / 600",
              "ragged 1,000,003 / 600, a view one float in"]
    for shape in shapes:
        if shape == "IEAD" and iead is None:
            continue
        p, v, ng, periodic = _single_inputs(shape, gen, dev, iead)
        n = p.shape[0]
        kw = dict(periodic=periodic)
        if shape == "IEAD" and "cols" in inspect.signature(K.deposit).parameters:
            kw["cols"] = cic.HISTOGRAM_COLS  # the IEAD path's, histogram_add's
        got = K.deposit(p, v, ng, **kw)
        f64 = K.deposit_plain(p.double(), v.double(), ng, periodic=periodic)
        a, r = rel_err(f64, got)
        errs = {"out": dict(abs=a, err=r, kind="rel vs float64", tol=TOL_DEP)}
        if shape == "IEAD":  # integer counts: exact in float32
            gap = float((got - K.deposit_plain(p, v, ng, periodic=periodic)).abs().max())
            errs["counts"] = dict(abs=gap, err=gap, kind="abs vs the plain counts", tol=0.0)
        err = _check(errs, f"deposit({shape}, n = {n}, ng = {ng})")
        del got, f64
        rec = timed("deposit", shape, n, (p, v), functools.partial(K.deposit, ng=ng, **kw),
                    functools.partial(K.deposit_plain, ng=ng, periodic=periodic))
        rec.update(max_abs_err=err, ng=ng)
        if shape == "IEAD":
            flat = p.long()
            rec["hits"] = int((v != 0).sum())
            rec["library_ms"] = device_ms(_rotating(
                lambda f, w: torch.zeros(ng, device=dev).index_add_(0, f, w), (flat, v)))
            log(f"[deposit]   deposit at the IEAD: {rec['hits']} hits in range of "
                f"{n} rows; library call zeros({ng}).index_add_ {rec['library_ms']:.4f} ms "
                "(rotated)")
        del p, v
        torch.cuda.empty_cache()

    for shape, (n, ng) in DEPOSIT_DET_SHAPES.items():
        if shape == "current":
            p = torch.rand(n, generator=gen, device=dev) * (ng - 1)
            v = torch.randn(n, generator=gen, device=dev) * 1e3
        else:
            p = torch.randint(0, ng, (n,), generator=gen, device=dev).float()
            v = (torch.rand(n, generator=gen, device=dev) < 0.01).float()
        got = K.deposit_det(p, v, ng, periodic=False)
        if not torch.equal(K.deposit_det(p, v, ng, periodic=False), got):
            raise AssertionError(f"deposit_det({shape}): differs from call to call")
        a, r = rel_err(K.deposit_plain(p.double(), v.double(), ng, periodic=False), got)
        err = _check({"out": dict(abs=a, err=r, kind="rel vs float64", tol=TOL_DEP)},
                     f"deposit_det({shape}, n = {n}, ng = {ng})")
        rec = timed("deposit_det", shape, n, (p, v),
                    functools.partial(K.deposit_det, ng=ng, periodic=False),
                    functools.partial(K.deposit_plain, ng=ng, periodic=False))
        rec.update(max_abs_err=err, ng=ng)
        del p, v, got

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    key, step, length, vth = (0, 1), 7, 3.0e-3, 2.2e4
    skw = dict(x_mu=length / 2, x_sigma=length / 12, x_wrap=length, vth=vth)
    for shape, n in SOURCE_NS.items():
        u = cuda_rng.source_uniforms(key, step, n, device=dev)
        if not torch.equal(u.cpu(), cuda_rng.source_uniforms(key, step, n, device="cpu")):
            raise AssertionError(f"source_batch({shape}): the Philox uniforms differ")
        del u
        got = cuda_rng.source_batch(key, step, n, device=dev, **skw)
        ref = cuda_rng.source_batch_plain(key, step, n, device=dev, **skw)
        d = (got[0].double() - ref[0].double()).abs()
        a = float(torch.minimum(d, length - d).max())
        errs = {"x": dict(abs=a, err=a / length, kind="of L", tol=TOL_SOURCE)}
        for k_, r_, g_ in zip(("vx", "vy", "vz"), ref[1:], got[1:]):
            a, rel = rel_err(r_, g_)
            errs[k_] = dict(abs=a, err=rel, kind="rel", tol=TOL_SOURCE)
        err = _check(errs, f"source_batch({shape})")
        del got, ref, d
        plain_ms = cuda_ms(lambda: cuda_rng.source_batch_plain(key, step, n, device=dev,
                                                               **skw), **fast)
        call = functools.partial(cuda_rng.source_batch, key, step, n, device=dev, **skw)
        rec = _timed(call, plain_ms, "source_batch", n)
        # no inputs: rotating holds the last four outputs, as a step would
        rec["rotated"] = {k_: v_ for k_, v_ in _timed(_rotating(call, ()), plain_ms,
                                                      "source_batch", n).items()
                          if k_ in ("ms", "ms_calls")}
        g = torch.Generator(device=dev).manual_seed(5)
        rec.update(max_abs_err=err, **_source_issue_bound(n, sms))
        rec["library_ms"] = device_ms(_rotating(
            lambda: torch.randn((4, n), device=dev, generator=g), ()))
        log(f"[deposit] source_batch at {shape}: {rec['ms']:.4f} ms (calls "
            f"{', '.join(f'{t:.4f}' for t in rec['ms_calls'])}), rotated "
            f"{rec['rotated']['ms']:.4f}; bound {rec['bound_ms']:.4f} ({rec['bound_by']}), "
            f"issue bound {rec['issue_bound_ms']:.4f} (integer, at "
            f"{rec['clock_max_mhz']} MHz); its own {rec['sass_per_row']} SASS "
            f"instructions a row issue in {rec['own_sass_ms']} (not a bound); "
            "torch.randn((4, n)) "
            f"{rec['library_ms']:.4f}, its last four outputs held; plain {plain_ms:.4f}")
        out.setdefault("source_batch", {})[shape] = rec
    print(json.dumps({"deposit_times": out}), flush=True)
    return out


def phase_carried_kernels(dev) -> dict:
    """The two carried kernels against their plain versions on the card:
    boris_gather_push_deposit at the ragged n with a forced clamp (pad 0,
    40x the velocities) and at the configs[3] row's n and pad 2, mirrored
    gather and not, with inactive rows and wall hits on both sides (p1 and
    the velocities bit-equal, rho and n against float64 sums, the clamp
    counts equal, the wall hits deposit nothing); explicit_domain_cycle
    at the ragged n with a middle rank's offset and at the headline n on
    one rank's slab, ext_n = 227, with dead slots and rows past both ext
    edges (p1 and v1 bit-equal, rho_ext against float64 sums, the clamp
    counts equal, charge kept). Timed with their bounds: row 9 from the
    profiler (it is shorter than its wrapper), row 12 with CUDA events."""
    from pypic_tpu_torch.ops import cuda_cic as K
    from pypic_tpu_torch.ops import cuda_domain as KD

    gen = torch.Generator(device=dev).manual_seed(23)
    fast = dict(reps=3, calls=3)
    records = {}
    bkw = dict(b=(0.1395, 1.9951, 0.0), dt_dx=1e-10 / 2.5e-6)
    for n, pad, hot in ((N_MAG_RAGGED, 0, CARRIED_HOT), (N_MAG, CARRIED_PAD, 1.0)):
        args = _carried_mag_inputs(n, gen, dev, hot)
        worst = 0.0
        for swap in (False, True):
            kw = dict(bkw, pad=pad, swap_weights=swap)
            label = (f"boris_gather_push_deposit(n={n}, pad={pad}, "
                     f"{'mirrored' if swap else 'cic'})")
            got = K.boris_gather_push_deposit(*args, **kw)
            ref = K.boris_gather_push_deposit_plain(*args, **kw)
            exact = K.boris_gather_push_deposit_plain(*args, acc_dtype=torch.float64,
                                                      **kw)
            torch.cuda.synchronize()
            for name, r, g in zip(("p1", "vx1", "vy1", "vz1"), ref, got):
                if not torch.equal(r, g):
                    raise AssertionError(f"{label}: {name} differs from the plain "
                                         f"version's by {float((r - g).abs().max())}")
            errs = {}
            for i, name in ((4, "rho"), (5, "n")):
                a, r = rel_err(exact[i], got[i])
                errs[name] = dict(abs=a, err=r, kind="rel vs float64 sums", tol=TOL_DEP)
                # with pad 0 the clamped tents pile onto the window edges,
                # far past deposit_tol's ~2n/ng terms a node: the float32
                # plain sum is then no reference (printed, not held)
                a, r = rel_err(ref[i], got[i])
                errs[f"{name}_plain"] = dict(
                    abs=a, err=r, kind="rel" if pad else "rel, not held",
                    tol=deposit_tol(n, NG_MAG) if pad else math.inf)
            gap = float(abs(int(got[6]) - int(ref[6])))
            errs["n_clamped"] = dict(abs=gap, err=gap, kind=(
                f"count gap ({int(got[6])} clamped of {n})"), tol=0.0)
            live = args[6] > 0
            left = int((live & (got[0] < 0)).sum())
            right = int((live & (got[0] > NG_MAG - 1)).sum())
            stay = (got[0] >= 0) & (got[0] <= NG_MAG - 1)
            a, r = rel_err(args[8][stay].double().sum().reshape(1),
                           exact[5].sum().reshape(1))
            errs["n total"] = dict(abs=a, err=r, kind=(
                f"rel to the weights staying on the grid ({left} + {right} "
                "wall hits deposit nothing)"), tol=1e-6)
            worst = max(worst, _check(errs, label))
            if not (left > 0 and right > 0):
                raise AssertionError(f"{label}: wall hits {left}, {right}")
            if pad == 0 and not int(got[6]) > 0:
                raise AssertionError(f"{label}: no clamp counted")
            del got, ref, exact
        log(f"[carried kernels]   boris_gather_push_deposit at n = {n}: p1 and the "
            "velocities bit-equal to the plain version's")
        kw = dict(bkw, pad=CARRIED_PAD, swap_weights=True)
        records["boris_gather_push_deposit"] = _rec(
            worst, device_ms(lambda: K.boris_gather_push_deposit(*args, **kw)),
            cuda_ms(lambda: K.boris_gather_push_deposit_plain(*args, **kw), **fast),
            "boris_gather_push_deposit", n)
        del args
        torch.cuda.empty_cache()

    qm = float(torch.tensor(QM, dtype=torch.float32))
    ext_n = DOM_CARRIED_EXT_N
    for n, ng, lo in ((N_RAGGED, 4 * DOM_C, float(DOM_C)), (N_HEADLINE, DOM_C, 0.0)):
        field, p, v, w = _carrier_inputs(n, gen, dev, ng, lo)
        kw = dict(qm=qm, dt=DT, dx=DX, lo_shifted=lo - DOM_CARRIED_HALO, ext_n=ext_n)
        label = f"explicit_domain_cycle(n={n}, ng={ng}, lo_shifted={kw['lo_shifted']})"
        got = KD.explicit_domain_cycle(field, p, v, w, **kw)
        ref = KD.explicit_domain_cycle_plain(field, p, v, w, **kw)
        torch.cuda.synchronize()
        for name, r, g in zip(("p1", "v1"), ref, got):
            if not torch.equal(r, g):
                raise AssertionError(f"{label}: {name} differs from the plain "
                                     f"version's by {float((r - g).abs().max())}")
        ref_rho, ref_n = ref[2:]
        del ref
        exact = KD.explicit_domain_cycle_plain(field, p, v, w, acc_dtype=torch.float64,
                                               **kw)
        a, r = rel_err(exact[2], got[2])
        errs = {"rho_ext": dict(abs=a, err=r, kind="rel vs float64 sums", tol=TOL_DEP)}
        a, r = rel_err(ref_rho, got[2])
        errs["rho_ext_plain"] = dict(abs=a, err=r, kind="rel", tol=deposit_tol(n, ext_n))
        gap = float(abs(int(got[3]) - int(ref_n)))
        errs["n_clamped"] = dict(abs=gap, err=gap, kind=(
            f"count gap ({int(got[3])} clamped of {n})"), tol=0.0)
        a, r = rel_err(w.double().sum().reshape(1), exact[2].sum().reshape(1))
        errs["charge"] = dict(abs=a, err=r, kind="rel to sum w (dead slots 0)", tol=1e-6)
        err = _check(errs, label)
        if not int(got[3]) >= 4:
            raise AssertionError(f"{label}: {int(got[3])} clamps, the 4 driven rows at least")
        log(f"[carried kernels]   {label}: p1 and v1 bit-equal to the plain version's")
        del got, exact, ref_rho
        records["explicit_domain_cycle"] = _rec(
            err, cuda_ms(lambda: KD.explicit_domain_cycle(field, p, v, w, **kw)),
            cuda_ms(lambda: KD.explicit_domain_cycle_plain(field, p, v, w, **kw), **fast),
            "explicit_domain_cycle", n)
        del field, p, v, w
        torch.cuda.empty_cache()
    for rec in records.values():
        rec["library_ms"] = None
    return records


def phase_carried_check(dev, domain_check: dict) -> dict:
    """pic_iead at n = 12,000 with the --carried row's configuration, the
    carry primed: one step from the states after 0 and 10 steps on the card
    (the carried kernel) and on the CPU (its plain version), the same
    source table (made on the CPU) on both sides: phase 14's limits, the
    rho and n carried into the next step, the clamp counts equal. The
    carried carrier's half (n = 20,000, one rank and two gloo ranks on the
    card against the CPU) rode phase 26's spawns; its result is repeated
    here."""
    import dataclasses

    from pypic_tpu_torch import presets, sources
    from pypic_tpu_torch.engines import magnetized
    from pypic_tpu_torch.tools import magnetized as row

    pre = presets.pic_iead(n_per_species=MAG_CHECK_PER_SPECIES, device="cpu")
    cfg_gpu = dataclasses.replace(pre.config, **row.CARRIED)
    cfg_cpu = dataclasses.replace(cfg_gpu, newton_backend="pallas")
    pre = dataclasses.replace(pre, state=magnetized.prime_carry(pre.state, cfg_cpu))
    src = cfg_cpu.source

    def hooks(state):
        return {"source_draws": lambda step, n: sources.sample_source_batch(
            state.rng, step, n, cfg_cpu.grid, src.ti, src.mass, vx=src.vx,
            device="cpu")}

    problems, _ = _one_step_pairs("carried check", pre, cfg_cpu, cfg_gpu,
                                  CARRIED_CHECK_AT, dev, _replayed(hooks))
    carrier = {k: v for k, v in domain_check.items() if k.startswith("explicit carried")}
    log(f"[carried check] the carried carrier, card against CPU (phase 26): {carrier}")
    if len(carrier) != 2:
        problems.append(f"the carried carrier's checks: {sorted(carrier)}")
    if problems:
        raise AssertionError("carried check: " + "; ".join(problems))
    return dict(carrier=carrier)


def phase_carried_slice(dev, mag_slice: dict, dom_slice: dict) -> dict:
    """bench.py --carried on the card. The configs[3] row with
    carried_deposit='on' (tools/magnetized.py --carried, the carry primed
    at set-up): 1,200 steps at n = 999,996 under sync debug mode 'error',
    exactly 1,200 launches each of boris_gather_push_deposit, deposit2
    (the re-activation patch), boltzmann_dirichlet, source_batch and
    deposit (the IEAD) and no other; the row's physics checks (the
    population invariant among them); n_ion_suppressed and
    n_escape_deferred 0; carry_clamped summed and printed, and the carried
    totals equal to a fresh deposit's (a clamped tent stays in the grid).
    Then the carried carrier (tools/domain.py --explicit --carried) at
    n = 1e8 on one rank, 2 + 5 steps: one explicit_domain_cycle launch a
    step (one deposit, the prime, at set-up), 0 host syncs, nothing
    clamped or dropped, its energy change within TOL_DOM_RISE of the plain
    version's mean on the CPU at DOM_RISE_N. Each beside phase 15's and
    phase 27's time of the same row without the carry."""
    from pypic_tpu_torch.engines import magnetized
    from pypic_tpu_torch.ops import cuda_cic
    from pypic_tpu_torch.parallel import domain, make_mesh
    from pypic_tpu_torch.tools import domain as drow
    from pypic_tpu_torch.tools import magnetized as row

    res, cfg, fin, m = row.run_row(dev, **row.CARRIED)
    steps = row.STEPS
    launches = dict(cuda_cic.LAUNCHES)
    res["launches"] = launches
    want = {k: 0 for k in cuda_cic.LAUNCHES}
    want.update(boris_gather_push_deposit=steps, deposit2=steps,
                boltzmann_dirichlet=steps, source_batch=steps, deposit=steps)
    sums = res["carried"]
    fresh = magnetized.prime_carry(fin, cfg)
    totals = {k: abs(float(getattr(fin, k).double().sum() - getattr(fresh, k).double().sum()))
              / abs(float(getattr(fresh, k).double().sum())) for k in ("rho", "n")}
    res["carry_total_rel"] = totals
    res["clamped_per_particle_step"] = sums["carry_clamped"] / (res["n"] * steps)
    log(f"[carried slice] configs[3] --carried: n = {res['n']}, {steps} steps under "
        f"sync debug mode 'error': {res['us_per_step']:.3f} us/step (phase 15, no "
        f"carry: {mag_slice['us_per_step']:.3f}), {res['pushes_per_s']:.4e} pushes/s, "
        f"Newton mean {res['newton_mean']:.3f}, phi_max / phi_f "
        f"{res['phi_max_over_phi_f']:.4f}; sums over the steps {sums} "
        f"({res['clamped_per_particle_step']:.3e} clamps a particle and step); "
        f"carried totals against a fresh deposit {totals}")
    log(f"[carried slice] configs[3] --carried: launches {launches}")
    problems = row.check_row(cfg, fin, m)
    if launches != want:
        problems.append(f"launches {launches} != {want}")
    for k in ("n_ion_suppressed", "n_escape_deferred"):
        if sums[k]:
            problems.append(f"{k} {sums[k]}")
    for k, rel in totals.items():
        if not rel <= TOL_CARRY_TOTAL:
            problems.append(f"carried {k} total off a fresh deposit's by {rel:.3e}")
    if problems:
        raise AssertionError("carried slice, configs[3] --carried: " + "; ".join(problems))
    del fin, fresh, m
    torch.cuda.empty_cache()

    cpu_rises = _cpu_rises("carried slice", DOM_RISE_N, carried_rho="on")
    cpu_rise = sum(cpu_rises) / len(cpu_rises)
    # phase 27 closed its one-rank NCCL group: this mesh is one rank
    # without a group, whose collectives are the identity as the one-rank
    # group's are
    mesh = make_mesh(device=dev)
    n = drow.N

    def build():
        cfg, st = drow.explicit_row(mesh, n, carried_rho="on")
        return cfg, st, domain.make_step(cfg, mesh)

    se = WARMUP_STEPS + DOM_EXPLICIT
    carrier = _domain_path(
        "carried slice", "the carried carrier (--explicit --carried)", build, n,
        DOM_EXPLICIT, {"explicit_domain_cycle": se, "deposit": 1},
        lambda r: [(r["host_syncs_per_step"] == 0.0,
                    f"host syncs a step {r['host_syncs_per_step']}"),
                   (r["n_halo_clamped"] == 0, f"halo clamped {r['n_halo_clamped']}"),
                   (r["halo"] == DOM_CARRIED_HALO, f"halo {r['halo']}"),
                   (abs(r["total_energy_rel_change"] - cpu_rise)
                    <= TOL_DOM_RISE * abs(cpu_rise),
                    f"total energy change {r['total_energy_rel_change']} "
                    f"against a mean {cpu_rise} on the CPU")])
    carrier["cpu_total_energy_rel_change"] = cpu_rises
    log(f"[carried slice] the carried carrier: {carrier['ms_per_step']:.4f} ms/step "
        f"(phase 27, no carry: {dom_slice['explicit']['ms_per_step']:.4f}); energy "
        f"change card {carrier['total_energy_rel_change']:+.6e} at n = {n}, CPU "
        f"mean {cpu_rise:+.6e} at n = {DOM_RISE_N} (tol {TOL_DOM_RISE} relative)")
    return dict(magnetized=res, carrier=carrier)


def _edge_rows(rows: torch.Tensor, cfg) -> int:
    """Impact or escape rows (energy in column ``e``, angle in ``a``) whose
    energy or angle lies within the rows' tolerance of an IEAD bin edge:
    the rows a card and a CPU may bin one bin apart."""
    ne, na = cfg.iead_bins
    ef = rows[:, 0].double() * (ne / cfg.iead_energy_max)
    af = rows[:, 1].double() * (na / cfg.iead_angle_max)
    near_e = (ef - ef.round()).abs() <= BCA_ROW_TOL["energy"] * ef.abs() + 1e-12
    near_a = (af - af.round()).abs() <= BCA_ROW_TOL["angle"] * (na / cfg.iead_angle_max)
    return int((near_e | near_a).sum())


def _row_gaps(ref: torch.Tensor, got: torch.Tensor, cols: dict) -> dict:
    """The rows' largest gaps by kind against BCA_ROW_TOL (<= 1 passes; an
    exact column that differs counts inf): ``cols`` maps a column to its
    kind (exact, energy, angle, vx, lateral)."""
    out = {}
    for col, kind in cols.items():
        r, g = ref[:, col].double(), got[:, col].double()
        if not len(r):
            gap = 0.0
        elif kind == "exact":
            gap = float("inf") if bool((r != g).any()) else 0.0
        elif kind == "angle":
            gap = float((r - g).abs().max()) / BCA_ROW_TOL["angle"]
        else:
            gap = _scaled_gap(r, g, BCA_ROW_TOL[kind], 1e-3 if kind == "vx" else 0.0)
        out[kind] = max(out.get(kind, 0.0), gap)
    return out


def phase_bca_check(dev) -> dict:
    """The pic_bca_aps path's first step at its published size (ppc 200:
    n = 120,000 in 180,000 slots) on the card ('auto': fused, the Newton
    kernel, the Philox source batch, the gather of the ionization density,
    the two IEAD deposits) and on the CPU (the same path's plain
    versions), the same Philox source table and ionization uniforms
    (made on the CPU) on both sides: from the preset's state, and from
    the state seeded with neutral wall-born B rows
    (tools/bca.seeded_state), on which the ionization and the escape both
    fire. Held: rho, phi, p, v at phase 14's limits; the counts equal;
    active and charge_state equal outside the ionization draws that
    straddle their probability (counted); the impact and escape rows at
    BCA_ROW_TOL; iead and iead_out equal bin for bin up to the rows that
    lie on a bin edge (counted)."""
    import dataclasses

    from pypic_tpu_torch import interop, presets, sources
    from pypic_tpu_torch.constants import E_CHARGE
    from pypic_tpu_torch.engines import magnetized
    from pypic_tpu_torch.ops import cuda_cic, cuda_rng
    from pypic_tpu_torch.ops.cic import gather
    from pypic_tpu_torch.ops.ionization import coefficient_table, rate_matrix
    from pypic_tpu_torch.tools import bca as bca_tool

    pre = presets.pic_bca_aps(ppc=bca_tool.PPC, device="cpu")
    cfg_gpu = pre.config
    cfg_cpu = dataclasses.replace(cfg_gpu, backend="fused", newton_backend="pallas")
    src, grid = cfg_cpu.source, cfg_cpu.grid
    problems, out = [], {}
    for label, st in (("preset", pre.state),
                      ("seeded", bca_tool.seeded_state(pre, BCA_SEEDED_ROWS,
                                                       BCA_SEEDED_ESCAPING))):
        d = interop.magnetized_state_to_numpy(st)
        sc = interop.magnetized_state_from_numpy(d, "cpu")
        hooks = {"source_draws": lambda step, n, sc=sc: sources.sample_source_batch(
                     sc.rng, step, n, grid, src.ti, src.mass, vx=src.vx, device="cpu"),
                 "ion_draws": lambda step, n, sc=sc: cuda_rng.philox_uniforms(
                     sc.rng, step, n, 1, cuda_rng.ION_TAG, device="cpu")[0]}
        hooks_g = {k: (lambda f: (lambda s, n: _to(f(s, n), dev)))(f)
                   for k, f in hooks.items()}
        c = magnetized.make_step(cfg_cpu, **hooks)(sc)
        g = magnetized.make_step(cfg_gpu, **hooks_g)(
            interop.magnetized_state_from_numpy(d, dev))
        (sc1, mc), (sg1, mg) = c, g
        errs = _mag_step_errors(c, g)
        keys = ("n_active", "n_hit_wall", "n_reactivated", "n_ionized", "n_escaped",
                "n_impacts", "n_escape_rows", "newton_iters")
        counts = {k: (int(getattr(mc, k)), int(getattr(mg, k))) for k in keys}
        # the ionization draws within BCA_STRADDLE of their probability
        dx = grid.dx
        _, n_dens = cuda_cic.deposit2(
            sc.p, torch.where(sc.active == 1, sc.charge_state * E_CHARGE * sc.p2c / dx, 0.0),
            torch.where(sc.active == 1, sc.p2c / dx, 0.0), grid.ng, periodic=False)
        table = coefficient_table(rate_matrix(cfg_cpu.species_z, cfg_cpu.te), dx,
                                  cfg_cpu.dt, torch.float32, "cpu")
        cs = torch.clamp(sc.charge_state.to(torch.int32), 0, 2).long()
        prob = ((gather(n_dens, sc1.p, periodic=False) * 1e-10) ** 2
                * table[sc.species_idx.long(), cs] / torch.clamp(sc.p2c, min=1e-30))
        u = hooks["ion_draws"](sc.step_host, sc.p.shape[0])
        # the rows that draw (active, below the charge gate, a tabulated
        # rate) at a probability below 1 (at or above it they all ionize)
        draws = ((sc.active == 1) & (sc.charge_state < cfg_cpu.max_charge_state)
                 & (table[sc.species_idx.long(), cs] > 0) & (prob < 1.0))
        straddle = draws & ((u.double() - prob.double()).abs()
                            <= BCA_STRADDLE * prob.double())
        differ = (sc1.charge_state != sg1.charge_state.cpu()) | (
            sc1.active != sg1.active.cpu())
        errs["charge or active off a straddling draw"] = float(int((differ & ~straddle).sum()))
        k, e = counts["n_impacts"][0], counts["n_escape_rows"][0]
        if counts["n_impacts"][0] == counts["n_impacts"][1]:
            errs.update({f"impacts {kk}": v for kk, v in _row_gaps(
                mc.impacts[:k], mg.impacts[:k].cpu(),
                {0: "energy", 1: "angle", 2: "exact", 3: "exact", 4: "vx",
                 5: "lateral", 6: "exact"}).items()})
        if counts["n_escape_rows"][0] == counts["n_escape_rows"][1]:
            errs.update({f"escapes {kk}": v for kk, v in _row_gaps(
                mc.escapes[:e][:, [2, 3, 1, 0]], mg.escapes[:e].cpu()[:, [2, 3, 1, 0]],
                {0: "energy", 1: "angle", 2: "exact", 3: "vx"}).items()})
        edges = (_edge_rows(mc.impacts[:k], cfg_cpu)
                 + _edge_rows(mc.escapes[:e][:, [2, 3]], cfg_cpu))
        moved = sum(float((getattr(sc1, h) - getattr(sg1, h).cpu()).abs().sum())
                    for h in ("iead", "iead_out"))
        errs["IEAD bins moved beyond the edge rows"] = max(0.0, moved - 2 * edges)
        log(f"[bca check] {label}: n = {pre.meta['source_n']} in {sc.p.shape[0]} slots, "
            f"step {sc.step_host} -> {sc.step_host + 1}, GPU vs CPU (<= 1 passes; counts "
            "0): " + ", ".join(f"{kk} {v:.3e}" for kk, v in errs.items())
            + f"; counts (CPU, GPU) {counts}; straddling draws {int(straddle.sum())}, "
            f"edge rows {edges}, IEAD counts moved {moved}")
        # gaps pass at <= 1, the counts of misses at 0
        bad = {kk: v for kk, v in errs.items()
               if not (v == 0.0 if kk.startswith(("charge", "IEAD")) else v <= 1.0)}
        bad.update({kk: v for kk, v in counts.items()
                    if v[0] != v[1] and kk != "newton_iters"})
        if label == "seeded" and not (counts["n_ionized"][0] > 0 and counts["n_escaped"][0] > 0):
            bad["branches"] = (counts["n_ionized"], counts["n_escaped"])
        if bad:
            problems.append(f"{label}: {bad}")
        out[label] = dict(counts=counts, straddling=int(straddle.sum()), edge_rows=edges)
    if problems:
        raise AssertionError("bca check: " + "; ".join(problems))
    return out


def phase_bca_slice(dev) -> dict:
    """The pic_bca_aps path (tools/bca.py) at ppc 200 on the card: 200
    steps of engines.bca_driver.run_bca with BinaryCollisionModel seeds 1
    and 2, each engine step under sync debug mode 'error' (a host sync in
    a step fails the phase), beside 200 steps of the engine alone; the
    launches of the driver's run exactly those of the path (deposit2,
    boltzmann_dirichlet, boris_gather_push, gather, source_batch and the
    ionization's philox_uniforms once a step, deposit twice: the IEAD and
    the escape IEAD) and no other; tests/test_bca.py:148-165's
    invariants. Then the same at pic_steps_per_bca 10, for the surface
    model's share of a block at both cadences."""
    from pypic_tpu_torch.ops import cuda_cic
    from pypic_tpu_torch.tools import bca as bca_tool

    res = {}
    problems = []
    for per_bca in (1, 10):
        r, pre, fin, stats, _ = bca_tool.run_path(dev, steps=BCA_STEPS, per_bca=per_bca)
        want = {kk: 0 for kk in cuda_cic.LAUNCHES}
        want.update(deposit2=BCA_STEPS, boltzmann_dirichlet=BCA_STEPS,
                    boris_gather_push=BCA_STEPS, gather=BCA_STEPS,
                    source_batch=BCA_STEPS, philox_uniforms=BCA_STEPS,
                    deposit=2 * BCA_STEPS)
        launches = dict(cuda_cic.LAUNCHES)
        r["launches"] = launches
        log(f"[bca slice] pic_bca_aps, n = {r['n']} in {r['capacity']} slots, "
            f"{BCA_STEPS} steps, pic_steps_per_bca {per_bca}: block "
            f"{r['block_ms_per_step']:.4f} ms/step, engine alone "
            f"{r['engine_ms_per_step']:.4f} ms/step, surface model "
            f"{r['surface_model_ms_per_step']:.4f} ms/step (share of the block "
            f"{r['surface_model_share']:.4f}); Newton mean {r['newton_mean']:.1f} "
            f"(max {r['newton_max']}); ionized {r['n_ionized']}, escaped "
            f"{r['n_escaped']}, re-activated {r['n_reactivated']}; stats {r['stats']}, "
            f"yield {r['total_yield']:.4f}")
        log(f"[bca slice] launches {launches}")
        problems += [f"pic_steps_per_bca {per_bca}: {x}"
                     for x in bca_tool.check(pre, fin, stats)]
        if launches != want:
            problems.append(f"pic_steps_per_bca {per_bca}: launches {launches} != {want}")
        res[per_bca] = r
        if per_bca == 1:
            res["final_state"] = fin
            res["preset"] = pre
    if problems:
        raise AssertionError("bca slice: " + "; ".join(problems))
    return res


def phase_checkpoint(dev, bca_slice: dict) -> dict:
    """A checkpoint round trip on the card: the bca slice's final state
    saved and loaded into the preset's template gives every field back bit
    for bit (key words and host step too); then CKPT_RESUME_STEPS engine
    steps from the loaded state against the same steps from the saved one
    (the same Philox draws): rho, phi, p, v at phase 14's limits each step
    and the active masks equal. Not bit for bit on the card: the deposits
    flush their block sums with float atomics, so from the second step the
    two runs' positions part by an ulp. The preset's 'reference' gather
    weights read the field at the position mirrored in its cell, a field
    that jumps at every node (E at node i - 1 just below node i, at i + 1
    on it): a row whose two positions lie in different cells before a
    step takes a different kick and parts from then on. Such rows are
    counted and left out of p and v (rho and phi keep every row)."""
    import tempfile

    from pypic_tpu_torch import checkpoint, interop
    from pypic_tpu_torch.engines import magnetized

    fin, pre = bca_slice.pop("final_state"), bca_slice.pop("preset")
    problems = []
    with tempfile.TemporaryDirectory() as d:
        mgr = checkpoint.CheckpointManager(d, every=1, keep=1, async_write=True)
        mgr.maybe_save(fin, fin.step_host)
        loaded, manifest = mgr.restore(pre.state)
        mgr.close()
    a = interop.magnetized_state_to_numpy(fin)
    b = interop.magnetized_state_to_numpy(loaded)
    unequal = [k for k in a if not (a[k].dtype == b[k].dtype and (a[k] == b[k]).all())]
    if unequal or loaded.step_host != fin.step_host or loaded.rng != fin.rng:
        problems.append(f"round trip not bit for bit: {unequal}")
    if not all(getattr(loaded, k).is_cuda for k in ("p", "iead", "step")):
        problems.append("loaded state not on the card")
    step = magnetized.make_step(pre.config)
    worst = collections.defaultdict(float)
    swap = pre.config.gather_weights == "reference"
    hi = float(pre.config.grid.ng - 1)
    parted = torch.zeros(fin.p.shape[0], dtype=torch.bool)
    s1, s2 = fin, loaded
    for _ in range(CKPT_RESUME_STEPS):
        if swap:
            # the cell each row gathers in, as gather_position clamps it
            parted |= (torch.floor(torch.clamp(s1.p, 0.0, hi))
                       != torch.floor(torch.clamp(s2.p, 0.0, hi))).cpu()
        c, g = step(s1), step(s2)
        # the uninterrupted run's step on the host, as _mag_step_errors takes it
        ref = (interop.magnetized_state_from_numpy(
            interop.magnetized_state_to_numpy(c[0]), "cpu"),
            type(c[1])(*(t.cpu() for t in c[1])))
        for kk, v in _mag_step_errors(ref, g, rows=~parted).items():
            worst[kk] = max(worst[kk], v)
        if not torch.equal(c[0].active, g[0].active):
            problems.append("resumed active mask differs")
        s1, s2 = c[0], g[0]
    log(f"[checkpoint] round trip of the bca slice's final state (step "
        f"{fin.step_host}, manifest format {manifest.get('format_version')}, "
        f"{len(a)} leaves): " + ("bit for bit" if not unequal else f"DIFFERS {unequal}")
        + f"; {CKPT_RESUME_STEPS} resumed steps against the uninterrupted ones, "
        "|d| / (atol + rtol |ref|) (<= 1 passes): "
        + ", ".join(f"{kk} {v:.3e}" for kk, v in worst.items())
        + f"; rows whose two runs gathered in different cells (left out of "
        f"p and v): {int(parted.sum())}")
    problems += [f"resumed {kk} {v:.3e}" for kk, v in worst.items() if not v <= 1.0]
    if problems:
        raise AssertionError("checkpoint: " + "; ".join(problems))
    torch.cuda.empty_cache()
    return dict(leaves=len(a), resumed_worst=dict(worst),
                parted_at_a_node=int(parted.sum()))


# phase 35: the command line in subprocesses on the card. Resume at the
# 50-step card-against-CPU limits of the implicit check (field energy
# 1e-3, kinetic 1e-5; the card's float atomics part the resumed run from
# the uninterrupted one); the distributed solve's field energy within
# tests/test_domain.py:662's rtol 2e-3 of the replicated run's
CLI_STEPS = {"landau_damping": 40, "bump_on_tail": 40, "sheath_dd": 40,
             "pic_iead": 30, "domain_explicit": 20, "domain_implicit": 20}
CLI_RESUME_TOL = {"field_energy": 1e-3, "kinetic_energy": 1e-5}
CLI_DIST_RTOL = 2e-3
CLI_TIMEOUT_S = 240
CLI_FILES = ("time.out", "metrics.npz", "metrics.jsonl")
# the text dumps of the engines with a field-energy metric (not magnetized)
CLI_TEXT = ("E2.txt", "J.txt", "parameters.out")


def _cli_run(label: str, args: list, outdir: str, steps: int,
             files=CLI_TEXT, env=None, card: str = "") -> dict:
    """``python -m pypic_tpu_torch.cli run ARGS --outdir OUTDIR`` in a
    subprocess from this checkout's root (killed at CLI_TIMEOUT_S): exit
    0, CLI_FILES and ``files``, ``steps`` finite metric rows. Returns its wall s (start-up
    included), the run's own s (time.out), ms/step, pushes/s (the CLI's
    particle count, the slots of a domain state), its stderr and rows."""
    import os
    import re

    root = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "pypic_tpu_torch.cli", "run", *args,
           "--outdir", outdir]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                         timeout=CLI_TIMEOUT_S,
                         env=dict(os.environ, **(env or {})))
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"cli, {label}: exit {res.returncode}: "
                             f"{res.stderr[-3000:]}")
    missing = [f for f in CLI_FILES + tuple(files)
               if not os.path.exists(os.path.join(outdir, f))]
    with open(os.path.join(outdir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    with open(os.path.join(outdir, "time.out")) as f:
        run_s = float(f.read())
    line = re.search(r"(\d+) steps x (\d+) particles in .*pushes/s\)", res.stderr)
    problems = [f"missing {missing}"] if missing else []
    if len(rows) != steps or not all(math.isfinite(v) for r in rows for v in r.values()):
        problems.append(f"{len(rows)} rows (want {steps}) or a metric not finite")
    if line is None:
        problems.append("no pushes/s line on stderr")
    if problems:
        raise AssertionError(f"cli, {label}: " + "; ".join(problems)
                             + f"; stderr: {res.stderr[-2000:]}")
    n = int(line.group(2))
    out = dict(wall_s=wall, run_s=run_s, ms_per_step=1e3 * run_s / steps,
               pushes_per_s=n * steps / run_s, n=n, steps=steps,
               stderr=res.stderr, rows=rows)
    log(f"[cli] {label}: exit 0 in {wall:.2f} s wall (start-up included), "
        f"the run {run_s:.4f} s: {out['ms_per_step']:.4f} ms/step, "
        f"{out['pushes_per_s']:.4e} pushes/s (n = {n}, {steps} steps; {card})")
    return out


def _runner_alone(name: str, steps: int, dev, profiled: bool = False,
                  **kw) -> dict:
    """The same preset through runner.run alone in this process: ``steps``
    steps from the preset's state (its first steps: what the CLI's run
    times), then ``steps`` more (warm), each ms/step; the launch counts
    set to 0 just before the first run and read just after it, and its
    metric rows. ``profiled``: the warm steps once more under
    torch.profiler (CPU and CUDA activity, as ``--profile``)."""
    from torch.profiler import ProfilerActivity, profile

    from pypic_tpu_torch import presets
    from pypic_tpu_torch.ops import cuda_cic
    from pypic_tpu_torch.runner import run

    pre = presets.get(name, device=dev, **kw)
    step = pre.make_step()

    def timed(state):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = run(step, state, steps)
        torch.cuda.synchronize()
        return state, m, 1e3 * (time.perf_counter() - t0) / steps

    cuda_cic.reset_launch_counts()
    st, m, first = timed(pre.state)
    launches = {k: c for k, c in cuda_cic.LAUNCHES.items() if c}
    rows = {k: v.cpu().numpy() for k, v in m._asdict().items()}
    st, _, warm = timed(st)
    out = dict(ms_per_step=first, warm_ms_per_step=warm, launches=launches,
               rows=rows)
    if profiled:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            st, _, out["profiled_ms_per_step"] = timed(st)
    del pre, st, m
    torch.cuda.empty_cache()
    return out


def _kernels_a_call(fn, calls: int = 5) -> float:
    """Device launches (kernels, memsets, copies) of one call of fn, from a
    torch.profiler trace of ``calls`` calls (a trace may drop launches:
    the mean over the calls, rounded up)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    count = sum(e.count for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA)
    return math.ceil(count / calls)


def phase_cli(dev, card: str) -> dict:
    """The command line (pypic_tpu_torch.cli) in subprocesses on the card:
    landau_damping at its preset n (1e6) for 40 steps with the plots,
    checkpoints every 20 and the profiler, then resumed from step 20 for
    20 steps (the rows held to the uninterrupted run's 20-39 at
    CLI_RESUME_TOL; the trace names picard_iteration); bump_on_tail for
    40; sheath_dd for 40 with --plot; pic_iead for 30 with the plots, the
    particle dump every 10, the gif and the surface post-process (its
    budget closes); domain_explicit with field_solve='distributed' and
    domain_implicit with checkpoints every 10, then resumed, at n = 1e6
    on a one-rank NCCL group of their own. Each preset also runs through
    runner.run alone in this process (the CLI's own cost, and the kernels
    the run launched); the distributed run's field energy is held to the
    replicated run's, the two solves' launches and device ms a call are
    read. Then the two histogram helpers on the card against their plain
    versions: equal counts."""
    import os
    import shutil
    import tempfile

    from pypic_tpu_torch import checkpoint, diagnostics, presets
    from pypic_tpu_torch.ops.poisson import solve_periodic_neutralized
    from pypic_tpu_torch.parallel import make_mesh
    from pypic_tpu_torch.parallel.distributed_poisson import (
        make_distributed_periodic_poisson)

    # the figures need matplotlib and imageio, which a card's Python may
    # lack: then the runs leave out --plot and --gif (the figures are
    # tested on the CPU, tests/test_torch_cli.py and test_torch_io.py)
    import importlib.util

    figures = all(importlib.util.find_spec(m) is not None
                  for m in ("matplotlib", "imageio"))
    plot = ["--plot"] if figures else []
    gif = ["--gif"] if figures else []
    if not figures:
        log("[cli] this Python has no matplotlib or imageio: the runs leave "
            "out --plot and --gif and their files")

    def figs(*names):
        return names if figures else ()

    out, problems = {"figures": figures}, []
    tmp = tempfile.mkdtemp(prefix="pypic_cli_")
    try:
        d = lambda name: os.path.join(tmp, name)  # noqa: E731
        steps = CLI_STEPS["landau_damping"]
        la = _cli_run("landau_damping", [
            "landau_damping", "--steps", str(steps), *plot, "--plot-every",
            "10", "--checkpoint-every", "20", "--profile", "--clean"],
            d("landau"), steps, files=CLI_TEXT + figs("summary.png") + (
                "checkpoints/state_0000000020.npz",
                "checkpoints/state_0000000040.npz", "checkpoints/final.npz",
                "profile/trace.json"), card=card)
        with open(os.path.join(d("landau"), "profile", "trace.json")) as f:
            if "picard_iteration" not in f.read():
                problems.append("the landau trace names no picard_iteration")
        os.makedirs(os.path.join(d("resume"), "checkpoints"))
        shutil.copy(os.path.join(d("landau"), "checkpoints",
                                 "state_0000000020.npz"),
                    os.path.join(d("resume"), "checkpoints"))
        lr = _cli_run("landau_damping --resume", [
            "landau_damping", "--steps", "20", "--checkpoint-every", "20",
            "--resume"], d("resume"), 20, card=card)
        if "resumed from step 20" not in lr["stderr"]:
            problems.append("landau resume: no 'resumed from step 20'")
        gaps = {k: max(abs(b[k] - a[k]) / abs(a[k]) for a, b in
                       zip(la["rows"][20:], lr["rows"]))
                for k in CLI_RESUME_TOL}
        log("[cli] landau resumed rows against the uninterrupted rows 20-39, "
            "largest relative gap: " + ", ".join(
                f"{k} {v:.3e} (tol {CLI_RESUME_TOL[k]})" for k, v in gaps.items()))
        problems += [f"landau resume {k} {v:.3e}" for k, v in gaps.items()
                     if not v <= CLI_RESUME_TOL[k]]
        out["landau_damping"] = la
        out["landau_damping_resume"] = lr
        out["resume_gaps"] = gaps

        out["bump_on_tail"] = _cli_run("bump_on_tail", [
            "bump_on_tail", "--steps", str(CLI_STEPS["bump_on_tail"])],
            d("bump"), CLI_STEPS["bump_on_tail"], card=card)
        out["sheath_dd"] = _cli_run("sheath_dd", [
            "sheath_dd", "--steps", str(CLI_STEPS["sheath_dd"]), *plot],
            d("sheath"), CLI_STEPS["sheath_dd"], card=card)
        iead = _cli_run("pic_iead", [
            "pic_iead", "--steps", str(CLI_STEPS["pic_iead"]), *plot,
            "--bca-postprocess", "--dump-particles", "100", "--dump-every",
            "10", *gif], d("iead"), CLI_STEPS["pic_iead"], files=figs(
                "iead.png", "bca_dashboard.png", "phase_space.gif") + (
                "particle_output.txt", "bca_postprocess.json"), card=card)
        with open(os.path.join(d("iead"), "particle_output.txt")) as f:
            dumped = sum(1 for _ in f)
        if dumped != 3 * 100:
            problems.append(f"pic_iead dump: {dumped} rows, not 3 frames of 100")
        with open(os.path.join(d("iead"), "bca_postprocess.json")) as f:
            budget = json.load(f)
        if (budget["num_deposited_wall"] + budget["num_reflected_wall"]
                != budget["num_incident_wall"]):
            problems.append(f"pic_iead budget does not close: {budget}")
        log(f"[cli] pic_iead surface budget: {budget}")
        out["pic_iead"] = iead

        n_dom = 1_000_000
        dx_run = _cli_run("domain_explicit, field_solve='distributed'", [
            "domain_explicit", "--particles", str(n_dom), "--steps",
            str(CLI_STEPS["domain_explicit"]), "--opt",
            "field_solve=distributed"], d("dist"),
            CLI_STEPS["domain_explicit"], env=_one_rank_env(), card=card)
        if "distributed: process 0 of 1" not in dx_run["stderr"]:
            problems.append("domain_explicit: no one-rank process group")
        out["domain_explicit_distributed"] = dx_run
        di_steps = CLI_STEPS["domain_implicit"]
        di_run = _cli_run("domain_implicit", [
            "domain_implicit", "--particles", str(n_dom), "--steps",
            str(di_steps), "--checkpoint-every", "10", "--clean"],
            d("dimp"), di_steps, files=CLI_TEXT + (
                "checkpoints/state_0000000010.npz",
                "checkpoints/state_0000000020.npz"), env=_one_rank_env(), card=card)
        di_res = _cli_run("domain_implicit --resume", [
            "domain_implicit", "--particles", str(n_dom), "--steps", "10",
            "--checkpoint-every", "10", "--resume"], d("dimp"), 10,
            env=_one_rank_env(), card=card)
        if "resumed from step 20" not in di_res["stderr"]:
            problems.append("domain_implicit resume: no 'resumed from step 20'")
        template = presets.domain_implicit(n=n_dom, device=dev).state
        loaded, manifest = checkpoint.load(os.path.join(
            d("dimp"), "checkpoints", "state_0000000020.npz"), template)
        alive = int(loaded.alive.sum())
        if manifest["step"] != 20 or alive != n_dom or not loaded.p.is_cuda:
            problems.append(f"domain_implicit checkpoint: step "
                            f"{manifest['step']}, {alive} alive")
        log(f"[cli] domain_implicit checkpoint loads back on the card: step "
            f"{manifest['step']}, {alive} alive of {int(loaded.p.shape[0])} slots")
        del template, loaded
        out["domain_implicit"] = di_run
        out["domain_implicit_resume"] = di_res
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # the same presets through runner.run alone (the CLI's own cost)
    alone = {
        "landau_damping": _runner_alone("landau_damping", CLI_STEPS["landau_damping"],
                                        dev, profiled=True),
        "bump_on_tail": _runner_alone("bump_on_tail", CLI_STEPS["bump_on_tail"], dev),
        "sheath_dd": _runner_alone("sheath_dd", CLI_STEPS["sheath_dd"], dev),
        "pic_iead": _runner_alone("pic_iead", CLI_STEPS["pic_iead"], dev),
        "domain_explicit_distributed": _runner_alone(
            "domain_explicit", CLI_STEPS["domain_explicit"], dev, n=n_dom,
            field_solve="distributed"),
        "domain_explicit_replicated": _runner_alone(
            "domain_explicit", CLI_STEPS["domain_explicit"], dev, n=n_dom),
        "domain_implicit": _runner_alone("domain_implicit", di_steps, dev, n=n_dom),
    }
    for name, a in alone.items():
        cli_ms = out[name]["ms_per_step"] if name in out else float("nan")
        log(f"[cli] {name} through runner.run alone: {a['ms_per_step']:.4f} "
            f"ms/step its first steps, {a['warm_ms_per_step']:.4f} the next "
            f"(the CLI's run {cli_ms:.4f}); launches {a['launches']}")
        if name in out:
            out[name].update(runner_ms_per_step=a["ms_per_step"],
                             runner_warm_ms_per_step=a["warm_ms_per_step"],
                             launches=a["launches"])
    la_alone = alone["landau_damping"]
    out["profile_overhead"] = (la_alone["profiled_ms_per_step"]
                               / la_alone["warm_ms_per_step"] - 1.0)
    log(f"[cli] torch.profiler's cost on landau_damping's warm steps: "
        f"{la_alone['profiled_ms_per_step']:.4f} against "
        f"{la_alone['warm_ms_per_step']:.4f} ms/step "
        f"({100 * out['profile_overhead']:+.1f}%)")
    fe_d = [r["field_energy"] for r in out["domain_explicit_distributed"]["rows"]]
    fe_r = alone["domain_explicit_replicated"]["rows"]["field_energy"]
    gap = max(abs(a - float(b)) / abs(float(b)) for a, b in zip(fe_d, fe_r))
    log(f"[cli] field energy of the CLI's distributed run against the "
        f"replicated run over {len(fe_d)} steps: largest relative gap "
        f"{gap:.3e} (tol {CLI_DIST_RTOL})")
    if not gap <= CLI_DIST_RTOL:
        problems.append(f"distributed field energy gap {gap:.3e}")
    if alone["domain_explicit_distributed"]["launches"].get("gather") != CLI_STEPS["domain_explicit"]:
        problems.append("the distributed path launched "
                        f"{alone['domain_explicit_distributed']['launches']}")

    # the two solves a call: launches and device ms
    pre = presets.domain_explicit(n=n_dom, device=dev)
    mesh = make_mesh(device=dev)
    ng, dx = pre.config.grid.ng, pre.config.grid.dx
    rho = pre.state.rho
    dist_solve = make_distributed_periodic_poisson(ng, dx, 1, mesh)
    solves = {
        "distributed": lambda: dist_solve(rho),
        "replicated": lambda: solve_periodic_neutralized(mesh.all_gather(rho), dx),
    }
    solve_stats = {k: dict(launches=_kernels_a_call(fn), ms=device_ms(fn))
                   for k, fn in solves.items()}
    # both against the float64 FFT solve's zero-mean phi (the float32 FFT
    # loses digits to rho - <rho>)
    exact = solve_periodic_neutralized(rho.double(), dx)
    exact = exact - exact.mean()
    gaps = {k: float((phi.double() - phi.double().mean() - exact).abs().max()
                     / exact.abs().max())
            for k, phi in (("distributed", dist_solve(rho)),
                           ("replicated", solve_periodic_neutralized(rho, dx)))}
    phi_gap = gaps["distributed"]
    log(f"[cli] the Poisson solve a step at ng = {ng}: distributed "
        f"{solve_stats['distributed']['launches']} launches, "
        f"{solve_stats['distributed']['ms']:.4f} ms; replicated (FFT) "
        f"{solve_stats['replicated']['launches']} launches, "
        f"{solve_stats['replicated']['ms']:.4f} ms; phi against the float64 "
        f"solve, of its largest: distributed {gaps['distributed']:.3e}, "
        f"replicated {gaps['replicated']:.3e}")
    if not phi_gap <= 2e-5:
        problems.append(f"distributed phi gap {phi_gap:.3e}")
    del pre, rho

    # the two histogram helpers on the card against their plain versions
    gen = torch.Generator(device="cpu").manual_seed(35)
    p = torch.rand(1_000_003, generator=gen) * 2.4 - 0.2
    v = torch.randn(1_000_003, generator=gen) * 2.0
    p[:101] = torch.linspace(0.0, 2.0, 101)  # values on edges, the last too
    hist_ok = []
    for label, fn in (
            ("phase_space_histogram", lambda a, b: diagnostics.phase_space_histogram(
                a, b, 100, 50, (0.0, 2.0), (-8.0, 8.0))),
            ("velocity_histogram", lambda a, b: diagnostics.velocity_histogram(
                b, 200, (-8.0, 8.0)))):
        got = fn(p.to(dev), v.to(dev))
        ref = fn(p, v)
        equal = all(torch.equal(g.cpu(), r) for g, r in zip(got, ref))
        hist_ok.append(equal)
        log(f"[cli] {label} on the card (row 4's deposit): counts "
            f"{'equal to' if equal else 'DIFFER from'} the plain version's, "
            f"{int(got[0].sum())} of {p.shape[0]} in range")
        if not equal:
            problems.append(f"{label} counts differ")
    if problems:
        raise AssertionError("cli: " + "; ".join(problems))
    for r in out.values():
        if isinstance(r, dict):
            r.pop("stderr", None)
            r.pop("rows", None)
    out["solves"] = solve_stats
    out["phi_gaps"] = gaps
    out["distributed_field_energy_gap"] = gap
    out["histograms_equal"] = all(hist_ok)
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 36: data parallel
# ---------------------------------------------------------------------------

# the hash sampler's kernel: (n, streams, normals) of the configs[3] row's
# re-activation batch (four normals a slot) and the pic_bca_aps flux-shaped
# batch (eight uniforms a slot)
HASH_SHAPES = ((999_996, 4, True), (180_000, 8, False))
# the normals against the plain version's float64 functions rounded once:
# the kernel's log_unit, sqrt_pos and sincos_2pi, a few float32 ulps of
# the largest |z| (~5.5)
TOL_HASH_NORMAL = 2e-6
# integer operations a slot and stream (the two murmur3 finalizers 10
# each, the counter's add and multiply, the xor, the shift, the convert
# and the scale) at the 32-bit integer rate of compute capability 9.0
# (64 lanes a clock an SM, half the float32 rate)
HASH_INT_OPS = 26
PEAK_INT32_PER_S = 33.5e12
# a Box-Muller pair's float32 operations (log 12, sqrt 2, sincos 20, the
# scale and the two products)
HASH_PAIR_OPS = 38
DP_STEPS = {"headline": 10, "magnetized": 20, "sheath": 20}
DP_REPLICAS_N, DP_REPLICAS_STEPS = 1_000_000, 10
# two ranks against one (tests/test_torch_dataparallel*.py): the
# magnetized row's phi_max over the first 10 steps, the sheath row's field
# energy; the active counts within DP_ACTIVE_GAP (the CPU tests' 4 at
# n = 2,400 and 8,192, plus 1e-5 of the row's n for the borderline rows
# that summation order flips at 1e6)
TOL_DP_PHI, TOL_DP_SHEATH_FE = 5e-4, 1e-3
DP_ACTIVE_GAP = 4
# domain_implicit, replicas against one: field energy (the slab tests')
TOL_DP_REPLICAS_FE = 1e-4


def hash_bound(n: int, streams: int, normals: bool) -> tuple[float, str]:
    """The least time in ms for one hash_batch call: the (streams, n)
    outputs written once over the memory rate, against the integer work
    at the integer rate and the Box-Muller work at the float32 rate."""
    by_bytes = 4.0 * streams * n / PEAK_BYTES_PER_S * 1e3
    by_ops = (HASH_INT_OPS * streams * n / PEAK_INT32_PER_S
              + (HASH_PAIR_OPS * streams // 2 * n / PEAK_F32_PER_S
                 if normals else 0.0)) * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def hash_times(dev) -> dict:
    """hash_batch against its plain version (the int64 tensor form, on the
    card) at HASH_SHAPES, slot offset 0 and n (the second rank's block):
    the uniforms bit-equal, the normals within TOL_HASH_NORMAL of the
    largest; then timed (device_ms, the last four outputs held so that a
    call writes past the 50 MB L2) beside torch.rand of the same shape
    and row 20's source_batch at 999,996. Returns the records by shape."""
    from pypic_tpu_torch.ops import cuda_rng

    out = {}
    for n, streams, normals in HASH_SHAPES:
        for off in (0, n):
            seed = 0x2545F491 + off
            got = cuda_rng.hash_batch(seed, n, streams, offset=off, device=dev)
            ref = cuda_rng.hash_uniforms_plain(seed, n, streams, off, dev)
            if not torch.equal(got, ref):
                bad = int((got != ref).sum())
                raise AssertionError(f"hash_batch uniforms differ from the plain "
                                     f"version in {bad} of {got.numel()} at n = "
                                     f"{n}, offset {off}")
            err = 0.0
            if normals:
                zk = cuda_rng.hash_batch(seed, n, streams, offset=off,
                                         normals=True, device=dev)
                zp = cuda_rng.hash_normals_from_uniforms(ref)
                err = float((zk - zp).abs().max())
                if not err <= TOL_HASH_NORMAL * float(zp.abs().max()):
                    raise AssertionError(f"hash_batch normals: max |err| {err} "
                                         f"at n = {n}, offset {off}")
            log(f"[data parallel] hash_batch {streams} x {n} at slot offset "
                f"{off}: uniforms bit-equal to the plain version"
                + (f", normals max |err| {err:.3e} (tol {TOL_HASH_NORMAL} of "
                   f"the largest)" if normals else ""))
        held = collections.deque(maxlen=4)
        ms = device_ms(lambda: held.append(cuda_rng.hash_batch(
            7, n, streams, offset=n, normals=normals, device=dev)))
        plain_ms = cuda_ms(lambda: held.append(cuda_rng.hash_batch_plain(
            7, n, streams, n, normals, dev)), reps=3, calls=3)
        lib_ms = device_ms(lambda: held.append(torch.rand((streams, n),
                                                          device=dev)))
        b, by = hash_bound(n, streams, normals)
        rec = dict(n=n, streams=streams, normals=normals, max_abs_err=err,
                   ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b,
                   bound_by=by)
        if n == 999_996:
            rec["source_batch_ms"] = device_ms(lambda: held.append(
                cuda_rng.source_batch((0, 1), 0, n, x_mu=0.5, x_sigma=0.1,
                                      x_wrap=1.0, vth=1.0, device=dev)))
        log(f"[data parallel] hash_batch {streams} x {n}"
            f"{' normals' if normals else ' uniforms'}: {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, torch.rand {lib_ms:.4f} ms, bound {b:.4f} ms "
            f"({by})" + (f", source_batch {rec['source_batch_ms']:.4f} ms"
                         if "source_batch_ms" in rec else ""))
        out[f"{streams}x{n}"] = rec
        held.clear()
    return out


def _dp_gap(a: list, b: list) -> float:
    a = torch.tensor(a, dtype=torch.float64)
    b = torch.tensor(b, dtype=torch.float64)
    return float(((a - b).abs() / a.abs().clamp_min(1e-300)).max())


def _cli_replicas(tmp: str, card: str) -> dict:
    """``python -m pypic_tpu_torch.cli run domain_implicit --shards 1
    --replicas 2`` in two subprocesses joined by the PYPIC rendezvous
    (gloo: the two ranks share the card), each killed at CLI_TIMEOUT_S:
    both exit 0, rank 0 writes the metrics and checkpoints."""
    import os
    import socket

    with socket.socket() as sk:  # any free port on this host
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    root = os.path.dirname(os.path.abspath(__file__))
    outdir = os.path.join(tmp, "replicas")
    steps = 10
    cmd = [sys.executable, "-m", "pypic_tpu_torch.cli", "run", "domain_implicit",
           "--particles", str(DP_REPLICAS_N), "--steps", str(steps), "--shards",
           "1", "--replicas", "2", "--checkpoint-every", str(steps // 2), "--clean",
           "--outdir", outdir]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        cmd, cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYPIC_COORDINATOR=f"localhost:{port}",
                 PYPIC_NUM_PROCESSES="2", PYPIC_PROCESS_ID=str(r),
                 PYPIC_BACKEND="gloo")) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=CLI_TIMEOUT_S))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    bad = [(r, p.returncode, o[1][-2000:]) for r, (p, o) in
           enumerate(zip(procs, outs)) if p.returncode != 0]
    if bad:
        raise AssertionError(f"cli --replicas 2: {bad}")
    want = ["metrics.jsonl", "time.out", "checkpoints/final.npz"] + [
        f"checkpoints/state_{s:010d}.npz" for s in (steps // 2, steps)]
    missing = [f for f in want if not os.path.exists(os.path.join(outdir, f))]
    with open(os.path.join(outdir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    if missing or len(rows) != steps or rows[-1]["n_dropped"] != 0 or not all(
            math.isfinite(r["field_energy"]) for r in rows):
        raise AssertionError(f"cli --replicas 2: missing {missing}, {len(rows)} "
                             f"rows, last {rows[-1] if rows else None}")
    log(f"[data parallel] cli domain_implicit --shards 1 --replicas 2 (two "
        f"gloo processes on the card): exit 0 in {wall:.2f} s wall, {steps} "
        f"rows, its files written ({card})")
    return dict(wall_s=wall, steps=steps, last=rows[-1])


def phase_data_parallel(dev, card: str) -> dict:
    """Phase 36 (module docstring): the hash sampler's kernel, the
    one-rank NCCL dp runs beside the one-device runs, two gloo ranks on
    the card and the slabs x replicas paths."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from pypic_tpu_torch.parallel import make_mesh, spawn
    from pypic_tpu_torch.tools import dataparallel as dpt
    from pypic_tpu_torch.tools import domain as drow

    res = {"hash_batch": hash_times(dev)}
    problems = []

    # one rank, NCCL: every sum is the identity
    drow.process_group()
    try:
        mesh = make_mesh(device=dev)
        if (mesh.world, mesh.backend) != (1, "nccl"):
            raise AssertionError(f"expected a one-rank NCCL mesh, got {mesh}")
        one = {}
        for row, steps in DP_STEPS.items():
            pair = {}
            for dp in (True, False):
                r = dpt.rank_row(mesh, row, steps, dp=dp)
                pair["dp" if dp else "one_device"] = r
                log(f"[data parallel] {row}, one rank{' (NCCL, axis_name)' if dp else ', no axis_name'}: "
                    f"n = {r['n']}, {steps} steps: {r['ms_per_step']:.4f} ms/step, "
                    f"launches a step {r['launches_per_step']}, host syncs a step "
                    f"{r['host_syncs_per_step']:.2f}")
            a, b = pair["dp"], pair["one_device"]
            if a["launches_per_step"] != b["launches_per_step"]:
                problems.append(f"{row}: launches {a['launches_per_step']} != "
                                f"{b['launches_per_step']}")
            if a["host_syncs_per_step"] != b["host_syncs_per_step"] and row != "sheath":
                problems.append(f"{row}: host syncs {a['host_syncs_per_step']} != "
                                f"{b['host_syncs_per_step']}")
            if row == "sheath":
                # one read a Picard pass, none after a pass at maxiter
                for r in (a, b):
                    iters = r["rows"]["picard_iters"]
                    reads = sum(k - (k == 20) for k in iters) / len(iters)
                    if r["host_syncs_per_step"] != reads:
                        problems.append(f"sheath: host syncs {r['host_syncs_per_step']}"
                                        f" != reads {reads}")
            if row == "magnetized" and a["host_syncs_per_step"] != 0.0:
                problems.append(f"magnetized: {a['host_syncs_per_step']} host syncs")
            if row == "headline" and set(a["rows"]["picard_iters"]) != {4}:
                problems.append(f"headline Picard {set(a['rows']['picard_iters'])}")
            if not (a["finite"] and b["finite"]):
                problems.append(f"{row}: a position not finite")
            one[row] = pair
        res["one_rank"] = {row: {k: {q: v[q] for q in (
            "ms_per_step", "launches_per_step", "host_syncs_per_step", "n")}
            for k, v in pair.items()} for row, pair in one.items()}
    finally:
        dist.destroy_process_group()

    # domain_implicit at one slab x one replica, here (no process group)
    ref = dpt.rank_replicas(make_mesh(device=dev), DP_REPLICAS_N,
                            DP_REPLICAS_STEPS, 1)
    # two gloo ranks on the one card, one spawn
    jobs = [("row", dict(row="magnetized", steps=DP_STEPS["magnetized"])),
            ("row", dict(row="sheath", steps=DP_STEPS["sheath"])),
            ("replicas", dict(n=DP_REPLICAS_N, steps=DP_REPLICAS_STEPS,
                              replicas=2))]
    t0 = time.perf_counter()
    two = spawn.run(2, dpt.rank_jobs, jobs, device=dev)
    spawn_s = time.perf_counter() - t0
    res["two_ranks"] = {"spawn_s": spawn_s}
    for i, row in enumerate(("magnetized", "sheath")):
        ranks = [r[i] for r in two]
        base = one[row]["dp"]
        equal = all(r["rows"] == ranks[0]["rows"] for r in ranks)
        digests = [r["digests"] for r in ranks]
        want = dpt.whole_digests(row, 2, dev)
        a = ranks[0]["rows"]
        gap_act = max(abs(x - y) for x, y in zip(a["n_active"],
                                                 base["rows"]["n_active"]))
        act_tol = DP_ACTIVE_GAP + 1e-5 * base["n"]
        if row == "magnetized":
            gap = _dp_gap(base["rows"]["phi_max"][:10], a["phi_max"][:10])
            tol = TOL_DP_PHI
            counts = ("newton_iters", a["newton_iters"])
        else:
            gap = _dp_gap(base["rows"]["field_energy"], a["field_energy"])
            tol = TOL_DP_SHEATH_FE
            counts = ("picard_iters", a["picard_iters"])
        log(f"[data parallel] {row}, two gloo ranks on the card: n = "
            f"{ranks[0]['n']}, {ranks[0]['steps']} steps: "
            f"{ranks[0]['ms_per_step']:.4f} ms/step, host syncs a step "
            f"{ranks[0]['host_syncs_per_step']:.2f}, staged "
            f"{ranks[0]['staged_bytes_per_step']:.0f} B a step a rank; rows equal "
            f"on both ranks: {equal}; hash uniforms bit-equal to the one-rank "
            f"batch's blocks: {digests == want}; against one rank: largest gap "
            f"{gap:.3e} (tol {tol}), n_active {gap_act} (tol {act_tol:.0f}); "
            f"{counts[0]} {counts[1]}")
        if not equal:
            problems.append(f"{row}: the two ranks' rows differ")
        if digests != want:
            problems.append(f"{row}: hash uniforms differ from the one-rank batch")
        if not gap <= tol or not gap_act <= act_tol:
            problems.append(f"{row}: two ranks against one: gap {gap}, "
                            f"n_active {gap_act}")
        if not all(r["finite"] for r in ranks):
            problems.append(f"{row}: a position not finite")
        res["two_ranks"][row] = dict(
            **{k: ranks[0][k] for k in ("n", "steps", "ms_per_step",
                                        "host_syncs_per_step",
                                        "staged_bytes_per_step",
                                        "launches_per_step")},
            rows_equal=equal, draws_equal=digests == want, gap=gap,
            n_active_gap=gap_act)
    reps = [r[2] for r in two]
    gap = _dp_gap(ref["rows"]["field_energy"], reps[0]["rows"]["field_energy"])
    dropped = sum(reps[0]["rows"]["n_dropped"])
    log(f"[data parallel] domain_implicit, one slab x two replicas (gloo on the "
        f"card): n = {DP_REPLICAS_N}, {DP_REPLICAS_STEPS} steps: "
        f"{reps[0]['ms_per_step']:.4f} ms/step (one replica "
        f"{ref['ms_per_step']:.4f}), staged {reps[0]['staged_bytes_per_step']:.0f} "
        f"B a step a rank, field energy against one replica {gap:.3e} (tol "
        f"{TOL_DP_REPLICAS_FE}), dropped {dropped}, Picard "
        f"{reps[0]['rows']['picard_iters']} ({ref['rows']['picard_iters']})")
    if not gap <= TOL_DP_REPLICAS_FE or dropped or reps[0]["rows"] != reps[1]["rows"]:
        problems.append(f"replicas: gap {gap}, dropped {dropped}, rows equal "
                        f"{reps[0]['rows'] == reps[1]['rows']}")
    if reps[0]["rows"]["n_alive"][-1] != DP_REPLICAS_N:
        problems.append(f"replicas: alive {reps[0]['rows']['n_alive'][-1]}")
    res["replicas"] = dict(n=DP_REPLICAS_N, steps=DP_REPLICAS_STEPS,
                           ms_per_step=reps[0]["ms_per_step"],
                           one_replica_ms_per_step=ref["ms_per_step"],
                           staged_bytes_per_step=reps[0]["staged_bytes_per_step"],
                           field_energy_gap=gap)
    tmp = tempfile.mkdtemp(prefix="pypic_dp_")
    try:
        res["cli_replicas"] = _cli_replicas(tmp, card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if problems:
        raise AssertionError("data parallel: " + "; ".join(problems))
    return res


# phase 37, the bounded slab engines (parallel.domain_sheath,
# parallel.domain_magnetized) and the chain kernel tridiag3_chain
SLAB_CHAIN_CS = (150, 300, 600, 1024)
# the chain kernel against its plain version (the same PCR in another
# rounding of FMA-free products): within this of the largest |x|, stated
# before the first run
TOL_CHAIN = 1e-5
# bytes the chain solve must move: dl, d, du, f read (16 B a row), the
# three columns written (12 B a row), the six interface scalars (24 B)
CHAIN_BYTES_ROW, CHAIN_BYTES_FIXED = 28, 24
SLAB_MAG_STEPS = 200
SLAB_GLOO_STEPS = 20
# tests/test_domain.py:757-759: the first 2 steps' phi_max against the
# single-device engine (JAX's own limit)
TOL_SLAB_PHI_MAX, SLAB_PHI_STEPS = 5e-4, 2
SLAB_SHEATH_STEPS = 1200
SLAB_SHEATH_GLOO = dict(n=100_000, ng=56, exit_hist_vmax=3e6,
                        record_exit_after_step=0)
SLAB_SHEATH_BIG_N, SLAB_SHEATH_BIG_STEPS = 100_000_000, 10
# the two-rank sheath's step 0 against one rank's kinetic energy: the same
# velocities (within TOL_SHEATH_STEP['u'], so v^2 within twice that)
# summed as two float32 partial sums; five times 2e-6
TOL_SLAB_SHEATH_KE = 1e-5
# the slab ranks' tag of the re-injection stream (parallel.domain_sheath:
# rank r draws at counters (row, step, j, r << 16)); rank 1's
SLAB_REINJECT_TAG = 1 << 16


def _chain_system(c: int, kind: str, gen: torch.Generator, dev):
    """A (c,) local system of the chain solve: 'boltzmann', the slab
    Newton's Jacobian at one rank (c = ng: identity-ish wall rows, the
    interior -2 - kappa exp(c1 phi) with kappa = (dx / lambda_D)^2 of the
    configs[3] row's grid at ng = c and c1 phi from 0 down to -3 Te/e);
    'random', diagonally dominant (4 + N(0, 1), off-diagonals 1).
    Returns (dl, d, du, f) float32 on ``dev``."""
    col = torch.arange(c, dtype=torch.float64)
    if kind == "boltzmann":
        kappa = (300.0 / (c - 1)) ** 2
        c1phi = -3.0 * (2.0 * col / (c - 1) - 1.0) ** 2
        expo = torch.exp(c1phi)
        interior = (col >= 1) & (col <= c - 2)
        d = torch.where(interior, -2.0 - kappa * expo, 1.0 - kappa)
        dl = torch.where(col >= c - 1, 0.0, 1.0)
        du = torch.where(col <= 0, 0.0, 1.0)
    else:
        d = 4.0 + torch.randn(c, generator=gen, dtype=torch.float64)
        dl = torch.ones(c, dtype=torch.float64)
        du = torch.ones(c, dtype=torch.float64)
    f = torch.randn(c, generator=gen, dtype=torch.float64)
    return tuple(a.to(torch.float32).to(dev) for a in (dl, d, du, f))


def chain_times(dev) -> dict:
    """tridiag3_chain against its plain version (x and the six interface
    scalars) at SLAB_CHAIN_CS, both kinds, at the chain's end ranks
    (first = last = True: one rank) and at a middle rank; timed
    (device_ms over 20 calls) beside the plain version, the Python-loop
    Thomas it replaces (ops.tridiag, the three columns) and dense
    torch.linalg.solve of the (c, c) matrix on the same three columns.
    Returns the records by c (c = 600 first)."""
    from pypic_tpu_torch.ops import cuda_newton, tridiag

    gen = torch.Generator().manual_seed(37)
    out = {}
    for c in SLAB_CHAIN_CS:
        errs = []
        for kind, ends in (("boltzmann", True), ("random", False)):
            dl, d, du, f = _chain_system(c, kind, gen, dev)
            x, g6 = cuda_newton.tridiag3_chain(dl, d, du, f, first=ends,
                                               last=ends)
            xr, gr = cuda_newton.tridiag3_chain_plain(dl, d, du, f,
                                                      first=ends, last=ends)
            err = float(torch.maximum((x - xr).abs().max(),
                                      (g6 - gr).abs().max()))
            scale = float(xr.abs().max())
            log(f"[slab bounded] tridiag3_chain c = {c}, {kind} "
                f"(first = last = {ends}): max |err| {err:.3e} of max |x| "
                f"{scale:.3e} (tol {TOL_CHAIN} of it)")
            if not err <= TOL_CHAIN * scale:
                raise AssertionError(f"tridiag3_chain c = {c} {kind}: "
                                     f"{err} > {TOL_CHAIN} x {scale}")
            errs.append(err)
        dl, d, du, f = _chain_system(c, "boltzmann", gen, dev)
        held = collections.deque(maxlen=4)
        ms = device_ms(lambda: held.append(cuda_newton.tridiag3_chain(
            dl, d, du, f, first=True, last=True)))
        plain_ms = cuda_ms(lambda: held.append(cuda_newton.tridiag3_chain_plain(
            dl, d, du, f, first=True, last=True)), reps=3, calls=3)
        dl_in, du_in = dl.clone(), du.clone()
        dl_in[0] = 0.0
        du_in[-1] = 0.0
        rhs = torch.zeros((c, 3), dtype=torch.float32, device=dev)
        rhs[:, 0] = f
        rhs[0, 1] = 1.0
        rhs[c - 1, 2] = 1.0
        thomas_ms = cuda_ms(lambda: held.append(tridiag.solve_tridiag(
            dl_in, d, du_in, rhs)), reps=3, calls=3)
        dense = (torch.diag(d) + torch.diag(dl_in[1:], -1)
                 + torch.diag(du_in[:-1], 1))
        lib_ms = device_ms(lambda: held.append(torch.linalg.solve(dense, rhs)))
        bound_ms = (CHAIN_BYTES_ROW * c + CHAIN_BYTES_FIXED) / PEAK_BYTES_PER_S * 1e3
        log(f"[slab bounded] tridiag3_chain c = {c}: {ms * 1e3:.2f} us a solve "
            f"(plain {plain_ms:.4f} ms, Python-loop Thomas {thomas_ms:.4f} ms, "
            f"dense torch.linalg.solve {lib_ms:.4f} ms; bound {bound_ms:.2e} ms "
            f"by bytes)")
        out[c] = dict(n=c, max_abs_err=max(errs), ms=ms, us_per_solve=ms * 1e3,
                      plain_ms=plain_ms, thomas_ms=thomas_ms, library_ms=lib_ms,
                      bound_ms=bound_ms, bound_by="bytes")
        held.clear()
    return out


def reinject_tag_check(dev, n: int) -> float:
    """sheath_reinject at SLAB_REINJECT_TAG against its plain version at
    the same tag (gamma 0 and 0.5, the 80/10/10 mix; n rows): positions
    bit-equal, velocities within TOL_SOURCE of the largest, and a stream
    apart from tag 0's. Returns the largest velocity error."""
    from pypic_tpu_torch.ops import cuda_rng

    gen = torch.Generator(device=dev).manual_seed(37)
    p, v, sig, mixes = _reinject_inputs(n, gen, dev)
    args = (p, v[0], v[1], v[2], mixes["80/10/10"], sig, 0.5 * sig)
    key, step, worst = (5, 6), 9, 0.0
    for gamma in (0.0, 0.5):
        what = f"sheath_reinject(gamma={gamma}, tag={SLAB_REINJECT_TAG})"
        got = cuda_rng.sheath_reinject(key, step, *args, cells=50.0,
                                       gamma=gamma, tag=SLAB_REINJECT_TAG)
        ref = cuda_rng.sheath_reinject_plain(key, step, *args, cells=50.0,
                                             gamma=gamma, tag=SLAB_REINJECT_TAG)
        zero = cuda_rng.sheath_reinject(key, step, *args, cells=50.0,
                                        gamma=gamma)
        if not torch.equal(got[0], ref[0]):
            raise AssertionError(f"{what}: positions differ from the plain "
                                 "version's")
        if torch.equal(got[0], zero[0]):
            raise AssertionError(f"{what}: the same stream as tag 0's")
        errs = {}
        for k_, r_, g_ in zip(("u", "vy", "vz"), ref[1:], got[1:]):
            a_, rel = rel_err(r_, g_)
            errs[k_] = dict(abs=a_, err=rel, kind="rel", tol=TOL_SOURCE)
        worst = max(worst, _check(errs, what))
        log(f"[slab bounded] {what}, n = {n}: positions bit-equal to the "
            "plain version's, velocities within TOL_SOURCE, a stream apart "
            "from tag 0's")
        del got, ref, zero
    return worst


def phase_slab_bounded(dev, shs: dict | None = None) -> dict:
    """Phase 37 (module docstring). ``shs``: phase 18's sheath slice, its
    single-device numbers printed beside the slab sheath's."""
    import dataclasses

    import torch.distributed as dist

    from pypic_tpu_torch import presets
    from pypic_tpu_torch.engines import magnetized
    from pypic_tpu_torch.ops import cuda_cic
    from pypic_tpu_torch.parallel import domain_sheath, make_mesh, spawn
    from pypic_tpu_torch.runner import run
    from pypic_tpu_torch.tools import domain as drow

    res = {"tridiag3_chain": chain_times(dev),
           "sheath_reinject_tagged_max_abs_err": reinject_tag_check(
               dev, drow.SHEATH_N)}
    problems = []

    # one rank, NCCL: the collectives are the identity
    drow.process_group()
    try:
        mesh = make_mesh(device=dev)
        if (mesh.world, mesh.backend) != (1, "nccl"):
            raise AssertionError(f"expected a one-rank NCCL mesh, got {mesh}")
        pre = drow.magnetized_row(mesh)
        n_mag = drow.MAG_N_PER_SPECIES * 6
        phi_f = pre.meta["floating_potential"]
        cuda_cic.reset_launch_counts()
        mag = drow.timed_rows(pre.make_step(), pre.state, SLAB_MAG_STEPS)
        launches_chain = cuda_cic.LAUNCHES["tridiag3_chain"]
        summary, bad = drow.magnetized_summary(mag, phi_f)
        problems += [f"pic_iead_dd: {b}" for b in bad]
        rows = mag["rows"]
        lps = mag["launches_per_step"]
        iters = sum(rows["newton_iters"])
        want = dict(deposit=3.0, gather=1.0, source_batch=1.0,
                    tridiag3_chain=iters / SLAB_MAG_STEPS)
        if lps != want or launches_chain != iters:
            problems.append(f"pic_iead_dd launches a step {lps} != {want} "
                            f"(tridiag3_chain {launches_chain}, Newton "
                            f"iterations {iters})")
        if mag["host_syncs_per_step"] != iters / SLAB_MAG_STEPS:
            problems.append(f"pic_iead_dd host syncs {mag['host_syncs_per_step']}"
                            f" != Newton iterations {iters / SLAB_MAG_STEPS}")
        del mag["state"], mag["metrics"]
        # the single-device engine from the same load, the same table
        one = presets.pic_iead(n_per_species=drow.MAG_N_PER_SPECIES, device=dev)
        cfg1 = dataclasses.replace(one.config, react_batch=pre.config.react_batch)
        _, m1 = run(magnetized.make_step(cfg1), one.state, SLAB_PHI_STEPS)
        ref = m1.phi_max.cpu().tolist()
        gap = _dp_gap(ref, rows["phi_max"][:SLAB_PHI_STEPS])
        del one, m1
        log(f"[slab bounded] pic_iead_dd, one rank (NCCL): n = {n_mag}, ng 600, "
            f"{SLAB_MAG_STEPS} steps: {mag['ms_per_step']:.4f} ms/step, "
            f"{n_mag * 1e3 / mag['ms_per_step']:.4e} pushes/s, Newton mean "
            f"{summary['newton_mean']:.3f} (max {summary['newton_max']}), "
            f"launches a step {lps}, host syncs a step "
            f"{mag['host_syncs_per_step']:.3f}, dropped {summary['n_dropped']}, "
            f"n_active + wall losses {summary['population']}, phi_max / phi_f "
            f"{summary['phi_max_over_phi_f']:.4f}; first {SLAB_PHI_STEPS} steps' "
            f"phi_max against the single-device engine: {gap:.3e} (tol "
            f"{TOL_SLAB_PHI_MAX})")
        if not gap <= TOL_SLAB_PHI_MAX:
            problems.append(f"pic_iead_dd phi_max against one device: {gap}")
        res["magnetized"] = dict(
            n=n_mag, steps=SLAB_MAG_STEPS, ms_per_step=mag["ms_per_step"],
            pushes_per_s=n_mag * 1e3 / mag["ms_per_step"],
            launches_per_step=lps, host_syncs_per_step=mag["host_syncs_per_step"],
            phi_max_single_device_gap=gap, **summary)
        del pre
        torch.cuda.empty_cache()

        # the sheath at the configs[2] row's physics
        cfg, st = drow.sheath_row(mesh)
        cuda_cic.reset_launch_counts()
        sh = drow.timed_rows(domain_sheath.make_step(cfg, mesh), st,
                             SLAB_SHEATH_STEPS)
        ssum, bad = drow.sheath_summary(sh, drow.SHEATH_N, cfg.maxiter)
        problems += [f"domain_sheath: {b}" for b in bad]
        ks = sh["rows"]["picard_iters"]
        reads = sum(k - (k == cfg.maxiter) for k in ks) / len(ks)
        passes = sum(ks)
        want = dict(gather=passes / len(ks), deposit_det=2 * passes / len(ks),
                    sheath_reinject=1.0)
        if sh["launches_per_step"] != want:
            problems.append(f"domain_sheath launches {sh['launches_per_step']} "
                            f"!= {want}")
        if sh["host_syncs_per_step"] != reads:
            problems.append(f"domain_sheath host syncs {sh['host_syncs_per_step']}"
                            f" != reads {reads}")
        for side in ("left", "right"):
            drop = ssum[f"wall_drop_{side}_te"]
            if not -4.0 < drop < -0.5:
                problems.append(f"domain_sheath {side} wall drop {drop} Te/e")
        beside = ""
        if shs is not None:
            beside = (f"; phase 18 (single device): {shs['us_per_step']:.3f} "
                      f"us/step, Picard mean {shs['picard_mean']:.3f}, wall drops "
                      f"{shs['wall_drop_left_te']:.4f}, "
                      f"{shs['wall_drop_right_te']:.4f} Te/e")
        log(f"[slab bounded] domain_sheath, one rank (NCCL): n = "
            f"{drow.SHEATH_N}, ng {drow.SHEATH_NG}, {SLAB_SHEATH_STEPS} steps: "
            f"{sh['ms_per_step'] * 1e3:.3f} us/step, Picard mean "
            f"{ssum['picard_mean']:.3f} (max {ssum['picard_max']}, "
            f"{ssum['steps_at_maxiter']} steps at maxiter), launches a step "
            f"{sh['launches_per_step']}, host syncs a step "
            f"{sh['host_syncs_per_step']:.3f} (reads {reads:.3f}), wall drops "
            f"{ssum['wall_drop_left_te']:.4f}, {ssum['wall_drop_right_te']:.4f} "
            f"Te/e{beside}")
        res["sheath"] = dict(n=drow.SHEATH_N, ng=drow.SHEATH_NG,
                             steps=SLAB_SHEATH_STEPS,
                             us_per_step=sh["ms_per_step"] * 1e3,
                             pushes_per_s=drow.SHEATH_N * 1e3 / sh["ms_per_step"],
                             launches_per_step=sh["launches_per_step"],
                             host_syncs_per_step=sh["host_syncs_per_step"],
                             **ssum)
        launches = dict(tridiag3_chain=launches_chain)
        del st, sh
        torch.cuda.empty_cache()

        # 10 timed steps at n = 1e8 (PIC_L_DD sharded's size), one rank
        t0 = time.perf_counter()
        cfg, st = drow.sheath_row(mesh, SLAB_SHEATH_BIG_N)
        setup_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats(dev)
        big = drow.timed_rows(domain_sheath.make_step(cfg, mesh), st,
                              SLAB_SHEATH_BIG_STEPS, warmup=1)
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        bsum, bad = drow.sheath_summary(big, SLAB_SHEATH_BIG_N, cfg.maxiter)
        problems += [f"domain_sheath 1e8: {b}" for b in bad]
        log(f"[slab bounded] domain_sheath at n = {SLAB_SHEATH_BIG_N} (capacity "
            f"{st.p.shape[0]}), {SLAB_SHEATH_BIG_STEPS} timed steps: "
            f"{big['ms_per_step']:.3f} ms/step, "
            f"{SLAB_SHEATH_BIG_N * 1e3 / big['ms_per_step']:.4e} pushes/s, Picard "
            f"{big['rows']['picard_iters']}, peak memory {peak:.2f} GiB "
            f"(set-up {setup_s:.1f} s)")
        res["sheath_1e8"] = dict(n=SLAB_SHEATH_BIG_N, steps=SLAB_SHEATH_BIG_STEPS,
                                 capacity=int(st.p.shape[0]),
                                 ms_per_step=big["ms_per_step"],
                                 pushes_per_s=SLAB_SHEATH_BIG_N * 1e3
                                 / big["ms_per_step"],
                                 picard_iters=big["rows"]["picard_iters"],
                                 peak_mem_gib=peak, setup_s=setup_s)
        del st, big
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()

    # one rank without a group: the reference of the two-rank sheath's
    # step 0
    cfg, st = drow.sheath_row(make_mesh(device=dev), **SLAB_SHEATH_GLOO)
    _, m0 = domain_sheath.make_step(cfg, make_mesh(device=dev))(st)
    del st
    # two gloo ranks on the one card, one spawn
    jobs = [("magnetized", dict(steps=SLAB_GLOO_STEPS)),
            ("magnetized", dict(steps=SLAB_GLOO_STEPS, replicas=2)),
            ("sheath", dict(steps=SLAB_GLOO_STEPS, **SLAB_SHEATH_GLOO))]
    t0 = time.perf_counter()
    two = spawn.run(2, drow.slab_jobs, jobs, device=dev)
    res["two_ranks"] = {"spawn_s": time.perf_counter() - t0}
    for i, label in enumerate(("magnetized_2_slabs", "magnetized_1x2_replicas",
                               "sheath_2_slabs")):
        ranks = [r[i] for r in two]
        a = ranks[0]["rows"]
        equal = all(r["rows"] == a for r in ranks)
        rec = dict(steps=SLAB_GLOO_STEPS, ms_per_step=ranks[0]["ms_per_step"],
                   host_syncs_per_step=ranks[0]["host_syncs_per_step"],
                   staged_bytes_per_step=ranks[0]["staged_bytes_per_step"],
                   rows_equal=equal, n_migrated=sum(a["n_migrated"]),
                   n_dropped=sum(a["n_dropped"]))
        if label.startswith("magnetized"):
            rec["phi_max_gap"] = _dp_gap(rows["phi_max"][:SLAB_PHI_STEPS],
                                         a["phi_max"][:SLAB_PHI_STEPS])
            rec["newton_iters"] = a["newton_iters"]
            if not rec["phi_max_gap"] <= TOL_SLAB_PHI_MAX:
                problems.append(f"{label}: phi_max against one rank "
                                f"{rec['phi_max_gap']}")
            tot = [x + y for x, y in zip(a["n_active"], a["n_hit_wall"])]
            if min(tot) != max(tot):
                problems.append(f"{label}: n_active + wall losses {tot}")
        else:
            tot = [x + y + z for x, y, z in zip(a["n_active"], a["n_lost_left"],
                                                a["n_lost_right"])]
            if set(tot) != {SLAB_SHEATH_GLOO["n"]}:
                problems.append(f"{label}: population {min(tot)}-{max(tot)}")
            step0 = dict(
                field_energy=_dp_gap([float(m0.field_energy)],
                                     [a["field_energy"][0]]),
                kinetic_energy=_dp_gap([float(m0.kinetic_energy)],
                                       [a["kinetic_energy"][0]]),
                phi=float((torch.tensor(ranks[0]["phi_first"]) - m0.phi.cpu())
                          .abs().max() / m0.phi.abs().max()),
                picard=(int(m0.picard_iters), a["picard_iters"][0]))
            rec["step0_against_one_rank"] = step0
            if not (step0["field_energy"] <= 2 * TOL_SHEATH_STEP["e"]
                    and step0["kinetic_energy"] <= TOL_SLAB_SHEATH_KE
                    and step0["phi"] <= TOL_SHEATH_STEP["phi"]
                    and abs(step0["picard"][0] - step0["picard"][1]) <= 1):
                problems.append(f"{label}: step 0 against one rank {step0}")
            rec["picard_iters"] = a["picard_iters"]
        if not equal:
            problems.append(f"{label}: the two ranks' rows differ")
        if rec["n_dropped"]:
            problems.append(f"{label}: {rec['n_dropped']} dropped")
        if label != "magnetized_1x2_replicas" and not rec["n_migrated"] > 0:
            problems.append(f"{label}: nothing migrated")
        log(f"[slab bounded] {label}, two gloo ranks on the card: "
            f"{SLAB_GLOO_STEPS} steps, {rec['ms_per_step']:.3f} ms/step, host "
            f"syncs a step {rec['host_syncs_per_step']:.2f}, staged "
            f"{rec['staged_bytes_per_step']:.0f} B a step a rank, rows equal on "
            f"both ranks: {equal}, migrated {rec['n_migrated']}, dropped "
            f"{rec['n_dropped']}" + "".join(
                f", {k} {rec[k]}" for k in ("phi_max_gap",
                                           "step0_against_one_rank")
                if k in rec))
        res["two_ranks"][label] = rec
    res["launches"] = launches
    cuda_cic.reset_launch_counts()
    if problems:
        raise AssertionError("slab bounded: " + "; ".join(problems))
    return res


# phase 38, the options (tools/options.py)
# the card against the CPU at n = 20,000 (phase 4's limits)
OPT_CHECK_TOL = {"p (cells)": 2e-4, "v": 1e-5, "e": 1e-4, "j": 1e-4,
                 "field_energy": 1e-5, "kinetic_energy": 1e-5}
OPT_SHEATH_CHECK_N, OPT_SHEATH_CHECK_AT = 20_000, 10
# superstep(k=1) against make_step on the card: float atomics, so the
# step tolerances (phase 26's), not bits; k = 2 against two make_steps:
# tests/test_domain.py:968-975's
TOL_SUPER_K1 = {"field_energy": 1e-5, "kinetic_energy": 1e-5}
TOL_SUPER_K2 = {"field_energy": 1e-4, "kinetic_energy": 1e-5}
SUPER_COUNTS = ("n_alive", "n_dropped", "n_halo_clamped")


def _one_rank_env() -> dict:
    """The environment of a CLI subprocess that makes a one-rank process
    group (NCCL on the card) on a free port."""
    import socket

    with socket.socket() as sk:  # any free port on this host
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    return {"PYPIC_COORDINATOR": f"localhost:{port}",
            "PYPIC_NUM_PROCESSES": "1", "PYPIC_PROCESS_ID": "0"}


def _super_problems(label: str, case: dict, k: int = 2) -> list:
    """superstep(k=1) and superstep(k) against make_step: energies, the
    counts, the step advance, nothing dropped or clamped, the raw-mode
    finalize held against its plain version."""
    problems = []
    ref = case["make_step"]["rows"]
    for key, tol in (("k1", TOL_SUPER_K1), (f"k{k}", TOL_SUPER_K2)):
        got = case[key]
        gaps = {f: _dp_gap(ref[f], got["rows"][f]) for f in tol}
        raw = got["raw_check"]
        log(f"[options] {label}, superstep {key}: {got['ms_per_step']:.4f} "
            f"ms/step (make_step {case['make_step']['ms_per_step']:.4f}), host "
            f"syncs a step {got['host_syncs_per_step']:.2f}, metrics "
            f"{got['shape']}, gaps to make_step " + ", ".join(
                f"{f} {v:.3e} (tol {tol[f]})" for f, v in gaps.items())
            + f", raw-mode finalize launches {got['raw_launches']}"
            + (f", against the plain version {raw}" if raw else ""))
        problems += [f"{label} {key}: {f} gap {v}" for f, v in gaps.items()
                     if not v <= tol[f]]
        for f in SUPER_COUNTS:
            if got["rows"][f] != ref[f]:
                problems.append(f"{label} {key}: {f} {got['rows'][f]} != {ref[f]}")
        if sum(got["rows"]["n_dropped"]) or sum(got["rows"]["n_halo_clamped"]):
            problems.append(f"{label} {key}: dropped or clamped")
        if got["step"] != case["make_step"]["step"] or not got["finite"]:
            problems.append(f"{label} {key}: step {got['step']}, finite "
                            f"{got['finite']}")
        for name, errs in raw.items():
            if not (errs["p"] <= TOL_DOM and errs["v"] <= TOL_DOM
                    and errs["stats"] <= TOL_DOM
                    and errs["clamped"][0] == errs["clamped"][1]
                    and errs.get("j", 0.0) <= TOL_DOM):
                problems.append(f"{label} {key}: raw-mode {name} {errs}")
    return problems


def phase_options(dev, card: str) -> dict:
    """Phase 38 (module docstring): the options on the card."""
    import dataclasses
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch.distributed as dist

    from pypic_tpu_torch import interop, presets
    from pypic_tpu_torch.diagnostics import floor_exit_counts_agree
    from pypic_tpu_torch.engines import sheath
    from pypic_tpu_torch.parallel import make_mesh, spawn
    from pypic_tpu_torch.runner import run
    from pypic_tpu_torch.tools import domain as drow
    from pypic_tpu_torch.tools import options as opt

    problems, res = [], {}
    launches = collections.Counter()

    # (a) the headline cell with each option, one initial state
    head = opt.headline_options(dev)
    base = head["last"]
    for label, r in head.items():
        launches.update(r.pop("launches"))
        fin = ("picard_finalize" if label.endswith("converged-deposit")
               else "picard_finalize_nodep")
        want = {"picard_iteration": 4.0, fin: 1.0}
        log(f"[options] headline, {label}: {r['ms_per_step']:.4f} ms/step "
            f"('last' with Anderson(1) {base['ms_per_step']:.4f}), "
            f"{r['pushes_per_s']:.4e} pushes/s, Picard {r['picard_iters']}, "
            f"launches a step {r['launches_per_step']}, host syncs a step "
            f"{r['host_syncs_per_step']:.2f}, total energy change "
            f"{r['total_energy_rel_change']:+.4e} ({card})")
        if r["launches_per_step"] != want or r["picard_iters"] != [4]:
            problems.append(f"headline {label}: launches {r['launches_per_step']},"
                            f" Picard {r['picard_iters']}")
        if r["host_syncs_per_step"] > base["host_syncs_per_step"]:
            problems.append(f"headline {label}: {r['host_syncs_per_step']} host "
                            f"syncs a step > {base['host_syncs_per_step']}")
        if not (r["finite"] and abs(r["total_energy_rel_change"]) < 1e-4):
            problems.append(f"headline {label}: energy change "
                            f"{r['total_energy_rel_change']}, finite {r['finite']}")
    res["headline"] = head
    for label, ((sc, mc), (sg, mg)) in opt.headline_check(dev).items():
        errs = {
            "p (cells)": seam_err(sc.p, sg.p.cpu(), NG),
            "v": rel_err(sc.v, sg.v.cpu())[1],
            "e": rel_err(sc.e, sg.e.cpu())[1],
            "j": rel_err(sc.j, sg.j.cpu())[1],
            "field_energy": rel_err(mc.field_energy, mg.field_energy.cpu())[1],
            "kinetic_energy": rel_err(mc.kinetic_energy,
                                      mg.kinetic_energy.cpu())[1]}
        same = torch.equal(mc.picard_iters, mg.picard_iters.cpu())
        log(f"[options] headline check, {label}, n = 20,000, 3 steps, GPU vs "
            "CPU: " + ", ".join(f"{k} {v:.3e} (tol {OPT_CHECK_TOL[k]:.0e})"
                                for k, v in errs.items())
            + f"; Picard equal {same}")
        problems += [f"headline check {label}: {k} {v}" for k, v in errs.items()
                     if not v <= OPT_CHECK_TOL[k]]
        if not same:
            problems.append(f"headline check {label}: Picard differ")

    # (b) the sheath row with Anderson(2) and Anderson(4)
    sh = opt.sheath_options(dev)
    for acc, r in sh.items():
        launches.update(r.pop("launches"))
        log(f"[options] sheath row, picard_accel {acc!r}: {r['ms_per_step']:.4f} "
            f"ms/step, Picard passes a step {r['picard_mean']:.3f} (max "
            f"{r['picard_max']}), host syncs a step {r['host_syncs_per_step']:.2f},"
            f" launches a step {r['launches_per_step']}, lost a step "
            f"{r['lost_per_step']:.1f} ({card})")
        if not r["finite"] or r["lost_per_step"] <= 0:
            problems.append(f"sheath {acc}: finite {r['finite']}, lost "
                            f"{r['lost_per_step']}")
    res["sheath"] = sh
    pre = presets.sheath_dd(n=OPT_SHEATH_CHECK_N, device="cpu")
    cfg0 = dataclasses.replace(pre.config, record_exit_after_step=0,
                               picard_init="extrapolate", picard_accel="anderson")
    st, _ = run(sheath.make_step(dataclasses.replace(cfg0, backend="fused")),
                pre.state, OPT_SHEATH_CHECK_AT)
    d = interop.sheath_state_to_numpy(st)
    res["sheath_check"] = {}
    for acc in ("anderson2", "anderson4"):
        for backend in ("fused", "composed"):
            cfg = dataclasses.replace(cfg0, picard_accel=acc, backend=backend)
            step = sheath.make_step(cfg)
            c = step(interop.sheath_state_from_numpy(d, "cpu"))
            g = step(interop.sheath_state_from_numpy(d, dev))
            errs = _sheath_step_errors(c, g)
            ok, line = floor_exit_counts_agree(
                c[1].picard_iters, float(c[1].picard_residual),
                g[1].picard_iters, float(g[1].picard_residual), d["e"],
                c[0].e, tol=cfg.tol, tol_floor=cfg.tol_floor)
            same_act = torch.equal(c[0].active, g[0].active.cpu())
            log(f"[options] sheath check, {acc}, {backend}, step "
                f"{OPT_SHEATH_CHECK_AT} -> {OPT_SHEATH_CHECK_AT + 1}, GPU vs CPU: "
                + ", ".join(f"{k} {v:.3e} (tol {TOL_SHEATH_STEP[k]:.0e})"
                            for k, v in errs.items())
                + f"; Picard (CPU, GPU) {line}; statuses "
                f"{'equal' if same_act else 'DIFFER'}")
            bad = {k: v for k, v in errs.items() if not v <= TOL_SHEATH_STEP[k]}
            if bad or not ok or not same_act:
                problems.append(f"sheath check {acc} {backend}: {bad}, {line}, "
                                f"statuses equal {same_act}")
            res["sheath_check"][f"{acc} {backend}"] = errs

    # (c, e) one rank in a one-rank NCCL group: the supersteps and the
    # carried row with and without axis_name
    drow.process_group()
    try:
        mesh = make_mesh(device=dev)
        if (mesh.world, mesh.backend) != (1, "nccl"):
            raise AssertionError(f"expected a one-rank NCCL mesh, got {mesh}")
        load = drow.host_load(opt.SUPER_N_SMALL)
        cases = {
            "configs[4], n = 1e8": opt.superstep_case(
                mesh, "implicit", drow.N, opt.SUPER_STEPS, warm=opt.WARMUP),
            "converged-deposit, n = 20,000": opt.superstep_case(
                mesh, "implicit", opt.SUPER_N_SMALL, opt.SUPER_STEPS, load=load,
                finalize="converged-deposit"),
            "explicit carrier, n = 20,000": opt.superstep_case(
                mesh, "explicit", opt.SUPER_N_SMALL, opt.SUPER_STEPS, load=load)}
        for label, case in cases.items():
            problems += _super_problems(f"one rank, {label}", case)
            for key in ("make_step", "k1", "k2"):
                launches.update(case[key].pop("launches"))
        # the carried carrier takes k = 1 only (JAX's ValueError above it)
        cc = opt.carried_carrier_k1(mesh)
        gaps = {f: _dp_gap(cc["make_step"]["rows"][f], cc["k1"]["rows"][f])
                for f in TOL_SUPER_K1}
        log(f"[options] one rank, carried carrier, n = 20,000, superstep k1: "
            f"{cc['k1']['ms_per_step']:.4f} ms/step (make_step "
            f"{cc['make_step']['ms_per_step']:.4f}), launches "
            f"{cc['k1']['launches']}, gaps to make_step " + ", ".join(
                f"{f} {v:.3e} (tol {TOL_SUPER_K1[f]})" for f, v in gaps.items()))
        problems += [f"carried carrier k1: {f} gap {v}" for f, v in gaps.items()
                     if not v <= TOL_SUPER_K1[f]]
        if (cc["k1"]["launches"] != cc["make_step"]["launches"]
                or cc["k1"]["step"] != opt.SUPER_STEPS
                or any(cc["k1"]["rows"]["n_halo_clamped"])):
            problems.append(f"carried carrier k1: launches {cc['k1']['launches']}"
                            f", step {cc['k1']['step']}")
        for key in ("make_step", "k1"):
            launches.update(cc[key]["launches"])
        raw = {label: case["k2"]["raw_launches"] for label, case in cases.items()}
        if (raw["configs[4], n = 1e8"]["picard_finalize_ext_nodep"] != 2
                or raw["converged-deposit, n = 20,000"]["picard_finalize_ext"] != 2):
            problems.append(f"raw-mode finalize launches {raw}")
        res["superstep_one_rank"] = {
            label: {key: {q: case[key][q] for q in (
                "ms_per_step", "host_syncs_per_step", "launches_per_step",
                "raw_launches", "raw_check")} for key in ("make_step", "k1", "k2")}
            for label, case in cases.items()}
        carried = {"axis": opt.carried_job(mesh),
                   "one_device": opt.carried_job(mesh, axis=False)}
    finally:
        dist.destroy_process_group()
    a, b = carried["axis"], carried["one_device"]
    for r in (a, b):
        launches.update(r.pop("launches"))
    gap = _dp_gap(b["rows"]["phi_max"][:10], a["rows"]["phi_max"][:10])
    act = max(abs(x - y) for x, y in zip(a["rows"]["n_active"],
                                         b["rows"]["n_active"]))
    log(f"[options] carried configs[3] row, one NCCL rank: n = {a['n']}, "
        f"{a['steps']} steps: {a['ms_per_step']:.4f} ms/step with axis_name, "
        f"{b['ms_per_step']:.4f} without; launches a step {a['launches_per_step']}"
        f" ({b['launches_per_step']}), host syncs a step "
        f"{a['host_syncs_per_step']:.2f} ({b['host_syncs_per_step']:.2f}); phi_max "
        f"gap {gap:.3e} (tol {TOL_DP_PHI}), n_active gap {act}; sums {a['sums']} "
        f"({b['sums']}) ({card})")
    if (a["launches_per_step"] != b["launches_per_step"] or not gap <= TOL_DP_PHI
            or act > DP_ACTIVE_GAP or a["host_syncs_per_step"]
            or not (a["finite"] and b["finite"])):
        problems.append(f"carried one rank: gap {gap}, n_active {act}, launches "
                        f"{a['launches_per_step']} vs {b['launches_per_step']}")

    # (c, e) two gloo ranks on the card, one spawn
    jobs = [("implicit", dict(backend="fused")),
            ("implicit", dict(backend="fused", finalize="converged-deposit")),
            ("explicit", {})]
    t0 = time.perf_counter()
    two = spawn.run(2, opt.rank_jobs, jobs, device=dev)
    res["two_ranks_spawn_s"] = time.perf_counter() - t0
    for i, (engine, over) in enumerate(jobs):
        label = f"two gloo ranks, {engine} {over}"
        ranks = [r["superstep"][i] for r in two]
        problems += _super_problems(label, ranks[0])
        for key in ("make_step", "k1", "k2"):
            if ranks[1][key]["rows"] != ranks[0][key]["rows"]:
                problems.append(f"{label} {key}: the ranks' rows differ")
        mig = ranks[0]["k2"]["rows"]["n_migrated"]
        if mig[0::2] != [0] * (len(mig) // 2) or not sum(mig[1::2]):
            problems.append(f"{label}: n_migrated {mig}")
    ca = [r["carried"] for r in two]
    same_rows = ca[0]["rows"] == ca[1]["rows"]
    same_carry = bool(np.array_equal(ca[0]["carry"], ca[1]["carry"]))
    gap = _dp_gap(a["rows"]["phi_max"][:10], ca[0]["rows"]["phi_max"][:10])
    log(f"[options] carried configs[3] row, two gloo ranks on the card: "
        f"{ca[0]['ms_per_step']:.4f} ms/step, host syncs a step "
        f"{ca[0]['host_syncs_per_step']:.2f}; rows equal {same_rows}, carried "
        f"rho and n the same bits on both ranks {same_carry}; phi_max against one "
        f"rank {gap:.3e} (tol {TOL_DP_PHI}); carry_clamped summed "
        f"{ca[0]['sums']['carry_clamped']} (one rank {a['sums']['carry_clamped']})")
    if not (same_rows and same_carry and gap <= TOL_DP_PHI and ca[0]["finite"]):
        problems.append(f"carried two ranks: rows equal {same_rows}, carry equal "
                        f"{same_carry}, gap {gap}")
    res["carried"] = dict(
        one_rank={k: {q: r[q] for q in ("n", "steps", "ms_per_step",
                                        "host_syncs_per_step", "sums")}
                  for k, r in carried.items()},
        two_ranks={q: ca[0][q] for q in ("ms_per_step", "host_syncs_per_step",
                                         "sums")},
        rows_equal=same_rows, carry_equal=same_carry)

    # (d) the CLI's --migrate-every in a subprocess
    tmp = tempfile.mkdtemp(prefix="pypic_opt_")
    try:
        out = os.path.join(tmp, "dimp")
        cli = _cli_run("domain_implicit --migrate-every 2", [
            "domain_implicit", "--particles", "1000000", "--steps", "6",
            "--migrate-every", "2", "--checkpoint-every", "3"], out, 6,
            files=CLI_TEXT + ("checkpoints/state_0000000004.npz",),
            env=_one_rank_env(), card=card)
        if "checkpoint cadence rounded up to 4" not in cli["stderr"]:
            problems.append("cli --migrate-every: no cadence rounding line")
        if any(r["n_dropped"] for r in cli["rows"]):
            problems.append("cli --migrate-every: dropped")
        res["cli"] = {k: cli[k] for k in ("wall_s", "run_s", "ms_per_step",
                                          "pushes_per_s", "n", "steps")}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # (f) deposit_method
    dm = opt.deposit_methods(dev)
    launches.update(dm["pallas"]["launches"])
    log(f"[options] deposit_method 'pallas', init_state at n = {N_HEADLINE}: "
        f"launches {dm['pallas']['launches']}")
    if dm["pallas"]["launches"] != {"deposit": 2} or not dm["pallas"]["finite"]:
        problems.append(f"deposit_method pallas: {dm['pallas']}")
    for method in ("scatter", "matmul"):
        r = dm[method]
        log(f"[options] deposit_method {method!r} at n = {r['n']}, ng {r['ng']}: "
            f"the same bits twice {r['same_bits']}, against the deposit kernel "
            f"{r['gap_to_deposit']:.3e} (tol {TOL_DEP}); at ng = 2,000 (the large "
            f"mode) {r['same_bits_large']}, {r['gap_to_deposit_large']:.3e}; above "
            f"LARGE_MAX_NG: {r['raise_above_large_max_ng'][:90]!r}")
        if not (r["same_bits"] and r["gap_to_deposit"] <= TOL_DEP
                and r["same_bits_large"] and r["gap_to_deposit_large"] <= TOL_DEP
                and "LARGE_MAX_NG" in r["raise_above_large_max_ng"]):
            problems.append(f"deposit_method {method}: {r}")
    res["deposit_method"] = {k: {q: v for q, v in r.items() if q != "launches"}
                             for k, r in dm.items()}
    res["launches"] = dict(launches)
    log(f"[options] launches over the phase's paths: {res['launches']}")
    if problems:
        raise AssertionError("options: " + "; ".join(problems))
    return res


# phase 39, large grids: the slice's main path, the magnetized engines
# past the Newton kernels' one-CTA 1,024 rows. The configs[3] load (n =
# 999,996) at ng = 16,384 and 4,096 and the D-N row at n = 500,000 and
# ng = 8,000 through tools/magnetized.run_row ('auto': the large Newton
# kernels), each held against the CPU (the plain versions) one step at a
# time from the card's states (the configurations draw no ionization, so
# no draw straddles), and both against a float64 step from the same
# state (_step64); then pic_iead_dd at ng = 32,768 on two gloo ranks on
# the card (c = 16,384 a slab), both solvers
LARGE_GRID_RUNS = {"pic_iead ng 16384": ("iead", 16_384),
                   "pic_iead ng 4096": ("iead", 4096),
                   "dn ng 8000": ("dn", 8000)}
LARGE_GRID_N_PER_SPECIES, LARGE_GRID_DN_N = 166_666, 500_000
LARGE_GRID_STEPS, LARGE_GRID_WARMUP, LARGE_CHECK_STEPS = 50, 3, 3
LARGE_SLAB_NG, LARGE_SLAB_STEPS = 32_768, 10
# phase 14's position limit |dp| <= atol + rtol |p| with |p| the larger
# of a pushed particle's start and end. The two routes' velocities part
# by an ulp or two (E's float32 rounding), and the push carries that gap
# into the position as |dvx| dt/dx, a share |dvx| / |vx| of the step's
# displacement. At ng = 16,384 (dt/dx 2.3e-3 s/m) an ion that ends
# within a cell of a wall after crossing 3-85 cells in the step reads up
# to 3e-5 cells there, where rtol |end| leaves only the atol's 1e-5;
# the larger of start and end bounds the displacement. The same limit
# holds each float32 route against the float64 step (_step64)
LARGE_WORST_SHOWN = 5
# the two slab solvers against each other: tests/test_torch_domain_
# magnetized.py's ten-step limits of each against JAX (phi_max rtol 1e-3
# every step, the last phi within 1e-3 of its largest)
TOL_LARGE_SLAB_PHI = 1e-3


def _newton64(dn: bool, dens, n0: float, te: float, dx: float, phi0,
              tol: float, maxiter: int):
    """The engine's Newton-Boltzmann loop (ops/poisson.py
    solve_boltzmann_dirichlet and _neumann: the same rows, clamps, loop
    test and shift) in float64 numpy, each Newton system by scipy's banded
    LU (the D-N's last row (1, -4, 3) as a second sub-diagonal). ``dens``
    is rho (D-D) or the number density (D-N). Returns (phi, iterations)."""
    import numpy as np
    from scipy.linalg import solve_banded

    from pypic_tpu_torch.constants import E_CHARGE, EPSILON_0, K_BOLTZMANN

    ng = dens.shape[0]
    dx2 = dx * dx
    c0 = E_CHARGE * n0 / EPSILON_0
    c1 = E_CHARGE / (K_BOLTZMANN * te)
    c2 = (E_CHARGE * dens if dn else dens) / EPSILON_0
    step_max = 40.0 / c1
    phi = np.array(phi0, dtype=np.float64)
    if not dn:
        phi[0] = phi[-1] = 0.0
    lower = 2 if dn else 1
    it, residual = 0, np.inf
    while residual > tol and it < maxiter:
        expo = np.exp(np.clip(c1 * phi, -40.0, 40.0))
        lap = np.zeros(ng)
        lap[1:-1] = phi[:-2] - 2.0 * phi[1:-1] + phi[2:]
        f = lap - dx2 * c0 * expo + dx2 * c2
        ab = np.zeros((2 + lower, ng))  # ab[1 + i - j, j] = J[i, j]
        ab[1] = -2.0 - dx2 * c0 * c1 * expo
        ab[0, 2:] = 1.0  # J[i, i + 1], rows 1 .. ng - 2
        ab[2, :-2] = 1.0  # J[i, i - 1], rows 1 .. ng - 2
        ab[1, 0] = 1.0 - dx2 * c0 * c1
        if dn:
            f[0] = phi[0]
            f[-1] = 0.0
            ab[1, -1] = 3.0
            ab[2, -2] = -4.0
            ab[3, -3] = 1.0
        else:
            f[0] = f[-1] = 0.0
            ab[1, -1] = 1.0 - dx2 * c0 * c1
        dphi = np.clip(solve_banded((lower, 1), ab, f), -step_max, step_max)
        phi = phi - dphi
        residual = (np.linalg.norm(dphi) if dn else float(np.dot(dphi, dphi)))
        it += 1
    return phi - phi.min(), it


def _step64(kind: str, cfg, d: dict) -> dict:
    """The push of one step of the fused engine (engines/magnetized.py
    step, neither carried nor smoothed) in float64 on the CPU from the
    state ``d`` (numpy): rho and n by deposit2_plain, n0 by the engine's
    update, the Newton solve by _newton64 at the engine's tol and
    maxiter, E by grad_neg_bounded, the gather and Boris push by
    boris_gather_push_plain. Returns the pushed p (cells), vx (float64
    tensors) and the Newton iterations."""
    import numpy as np

    from pypic_tpu_torch.constants import E_CHARGE, EV_TO_K, K_BOLTZMANN, M_ELECTRON
    from pypic_tpu_torch.engines import magnetized
    from pypic_tpu_torch.ops import cuda_cic

    if cfg.carried_deposit == "on" or cfg.smooth_rho or cfg.pusher == "gc":
        raise ValueError("_step64 follows the fused, uncarried, unsmoothed step")
    t = {k: torch.from_numpy(np.asarray(v, dtype=np.float64))
         for k, v in d.items() if k != "rng"}
    grid = cfg.grid
    ng, dx, dt = grid.ng, grid.dx, cfg.dt
    act = t["active"] == 1
    w_rho = torch.where(act, t["charge_state"] * E_CHARGE * t["p2c"] / dx, 0.0)
    w_n = torch.where(act, t["p2c"] / dx, 0.0)
    rho, n_dens = cuda_cic.deposit2_plain(t["p"], w_rho, w_n, ng, periodic=False)
    te_volts = (cfg.te / EV_TO_K) if cfg.eta_in_volts else (cfg.te * EV_TO_K)
    ve = float(np.sqrt(8.0 / np.pi * K_BOLTZMANN * cfg.te / M_ELECTRON))
    eta = torch.exp(t["phi"] / te_volts)
    n0, _ = magnetized.boltzmann_n0_update(
        int(d["step"]), t["n0"], t["p_old"], t["added"], q_new=eta[0] + eta[-1],
        p_new=torch.trapezoid(eta, dx=dx), dt=dt, ve=ve, n_mean=torch.mean(n_dens))
    warm = (2.0 * t["phi"] - t["phi_prev"] if cfg.newton_warm == "extrapolate"
            else t["phi"])
    if kind == "dn":
        phi, its = _newton64(True, n_dens.numpy(), float(n0), cfg.te, dx, warm.numpy(),
                             magnetized.DN_TOL, magnetized.DN_MAXITER)
    else:
        phi, its = _newton64(False, rho.numpy(), float(n0), cfg.te, dx,
                             (warm - warm[0]).numpy(), cfg.newton_tol,
                             cfg.newton_maxiter)
    e_field = fd.grad_neg_bounded(torch.from_numpy(phi), dx)
    const = (0.5 * dt * E_CHARGE) * t["charge_state"] / t["m"]
    p1, vx1, _, _ = cuda_cic.boris_gather_push_plain(
        e_field, t["p"], t["vx"], t["vy"], t["vz"], const, act.double(), b=cfg.b,
        dt_dx=dt / dx, swap_weights=cfg.gather_weights == "reference")
    return dict(p=p1, vx=vx1, newton_iters=its)


def _large_position_check(c, g, r, d, cells: float):
    """The positions of one step on the CPU (c), the card (g) and in
    float64 (r, _step64) from the state ``d``: the card against the CPU
    over the active particles, and each float32 side against r over the
    pushed ones (active before the step and after it on both sides, r
    inside the walls), at phase 14's limits with |p| the larger of start
    and end for a pushed particle (its end alone for a re-activated one);
    phase 14's own test (|p| the end) beside them, and its worst
    particles. Returns (figures, problems)."""
    rtol, atol = TOL_MAG_STEP["p"]
    sc, sg = c[0], g[0]
    pc, pg = sc.p.double(), sg.p.double().cpu()
    p0 = torch.from_numpy(d["p"]).double()
    before = torch.from_numpy(d["active"] == 1)
    act = sc.active == 1
    inside = (r["p"] >= 0.0) & (r["p"] <= cells)
    pushed = before & act & (sg.active.cpu() == 1) & inside
    # the magnitude the update p + vx dt/dx rounds at
    scale_c = torch.where(before, torch.maximum(p0.abs(), pc.abs()), pc.abs())
    scale_r = torch.maximum(p0.abs(), r["p"].abs())
    dp = (pg - pc).abs()
    e_c, e_g = (pc - r["p"]).abs(), (pg - r["p"]).abs()
    lim_r = atol + rtol * scale_r
    q = (dp / (atol + rtol * scale_c))[act]
    q14 = dp / (atol + rtol * pc.abs())
    idx = torch.nonzero(act).flatten()
    worst = []
    for j in torch.argsort(q14[act], descending=True)[:LARGE_WORST_SHOWN].tolist():
        i = int(idx[j])
        worst.append(dict(
            p0=float(p0[i]), p=float(pc[i]), dp=float(dp[i]),
            dvx=float((sg.vx.cpu()[i].double() - sc.vx[i].double()).abs()),
            cpu_to_f64=float(e_c[i]), card_to_f64=float(e_g[i]),
            phase14=float(q14[i]), p_scaled=float(q[j]), pushed=bool(pushed[i])))
    out = dict(pushed=int(pushed.sum()),
               straddled=int((before & act & ~inside).sum()),
               p=float(q.max()), phase14=float(q14[act].max()),
               cpu_to_f64=float((e_c / lim_r)[pushed].max()),
               card_to_f64=float((e_g / lim_r)[pushed].max()),
               cpu_to_f64_cells=float(e_c[pushed].max()),
               card_to_f64_cells=float(e_g[pushed].max()), worst=worst)
    problems = [f"{k} {out[k]:.3e}" for k in ("p", "cpu_to_f64", "card_to_f64")
                if not out[k] <= 1.0]
    return out, problems


def _large_grid_check(kind: str, ng: int, dev, steps: int = LARGE_CHECK_STEPS) -> dict:
    """``steps`` steps of the row on the card, each held against
    one step on the CPU (backend 'fused', newton_backend 'pallas': the
    plain versions) and one in float64 (_step64) from the same state: the
    preset's, then the card's state after each step. The source draws are
    the Philox kernel's and its plain version's (bit-equal); the D-N flux
    draws are made on the CPU and replayed on both sides (phase 20).
    Raises on a gap in rho, phi or v above phase 14's limits, on unequal
    n_active / n_reactivated, and on the positions' tests
    (_large_position_check)."""
    import dataclasses

    from pypic_tpu_torch import interop, sources
    from pypic_tpu_torch.engines import magnetized
    from pypic_tpu_torch.tools import magnetized as row

    pre = row.preset(kind, "cpu", LARGE_GRID_N_PER_SPECIES, LARGE_GRID_DN_N, ng)
    cfg_gpu = pre.config
    cfg_cpu = dataclasses.replace(cfg_gpu, backend="fused", newton_backend="pallas")
    src = cfg_cpu.source
    cells = float(cfg_cpu.grid.num_cells)

    def flux_hooks(state):
        def flux(step, n):
            return sources.sample_flux_batch(
                state.rng, step, n, cfg_cpu.grid, src.ti, src.mass, vx=src.vx,
                gamma=cfg_cpu.flux_gamma, vx_pert=cfg_cpu.flux_vx_pert,
                device="cpu")
        return {"source_draws": flux}

    d = interop.magnetized_state_to_numpy(pre.state)
    del pre
    problems, worst, iters, pos = [], {}, [], []
    for i in range(steps):
        sc = interop.magnetized_state_from_numpy(d, "cpu")
        kw_c, kw_g = (_replayed(flux_hooks)(sc, dev) if kind == "dn" else ({}, {}))
        t0 = time.perf_counter()
        c = magnetized.make_step(cfg_cpu, **kw_c)(sc)
        cpu_s = time.perf_counter() - t0
        g = magnetized.make_step(cfg_gpu, **kw_g)(
            interop.magnetized_state_from_numpy(d, dev))
        t0 = time.perf_counter()
        r = _step64(kind, cfg_cpu, d)
        f64_s = time.perf_counter() - t0
        errs = {k: v for k, v in _mag_step_errors(c, g).items() if k != "p"}
        p_rec, p_bad = _large_position_check(c, g, r, d, cells)
        counts = {k: (int(getattr(c[1], k)), int(getattr(g[1], k)))
                  for k in ("n_active", "n_hit_wall", "n_reactivated", "newton_iters")}
        log(f"[large grids] {kind} ng = {ng}, step {i} -> {i + 1}, GPU vs CPU "
            "from the same state, |d| / (atol + rtol |ref|) (<= 1 passes): "
            + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
            + f", p {p_rec['p']:.3e} (|p| the larger of start and end; its end "
            f"alone {p_rec['phase14']:.3e}); counts (CPU, GPU) {counts}; the CPU "
            f"step {cpu_s:.1f} s")
        log(f"[large grids] {kind} ng = {ng}, step {i} -> {i + 1}, against a "
            f"float64 step ({r['newton_iters']} Newton iterations, {f64_s:.1f} s), "
            f"{p_rec['pushed']} pushed particles ({p_rec['straddled']} left out: "
            "a wall hit in float64 alone), positions at the same limits: the "
            f"CPU {p_rec['cpu_to_f64']:.3e}, the card {p_rec['card_to_f64']:.3e}; "
            f"largest in cells the CPU {p_rec['cpu_to_f64_cells']:.3e}, the card "
            f"{p_rec['card_to_f64_cells']:.3e}")
        for w in p_rec["worst"]:
            log(f"[large grids]   worst with |p| its end: p {w['p0']:.4f} -> "
                f"{w['p']:.4f}, |dp| {w['dp']:.3e} cells ({w['phase14']:.3e} of "
                f"that limit, {w['p_scaled']:.3e} of the start's), |dvx| "
                f"{w['dvx']:.3e} m/s; from the float64 step the CPU "
                f"{w['cpu_to_f64']:.3e}, the card {w['card_to_f64']:.3e} cells"
                + ("" if w["pushed"] else " (not pushed)"))
        bad = {k: v for k, v in errs.items() if not v <= 1.0}
        for k in ("n_active", "n_reactivated"):
            if counts[k][0] != counts[k][1]:
                bad[k] = counts[k]
        if bad or p_bad:
            problems.append(f"step {i}: {bad} {p_bad}")
        for k, v in {**errs, **{f"p {q}": p_rec[q] for q in (
                "p", "phase14", "cpu_to_f64", "card_to_f64")}}.items():
            worst[k] = max(worst.get(k, 0.0), v)
        iters.append(counts["newton_iters"] + (r["newton_iters"],))
        pos.append({k: v for k, v in p_rec.items() if k != "worst"})
        d = interop.magnetized_state_to_numpy(g[0])
        del c, g, r
    if problems:
        raise AssertionError(f"large grids {kind} ng = {ng} check: "
                             + "; ".join(problems))
    return dict(steps=steps, worst_scaled_gap=worst,
                newton_iters_cpu_gpu_f64=iters, positions=pos)


def phase_large_grids(dev) -> dict:
    """Phase 39 (module docstring). Returns each run's figures and the
    large kernels' launches on this path."""
    from pypic_tpu_torch.engines import magnetized
    from pypic_tpu_torch.ops import cuda_cic as K
    from pypic_tpu_torch.parallel import distributed_poisson, make_mesh, spawn
    from pypic_tpu_torch.tools import domain as drow
    from pypic_tpu_torch.tools import magnetized as row

    res = {"runs": {}}
    launches = {}
    problems = []
    newton = {"iead": "boltzmann_dirichlet", "dn": "boltzmann_dn"}
    for label, (kind, ng) in LARGE_GRID_RUNS.items():
        for k in magnetized.THOMAS_SOLVES:
            magnetized.THOMAS_SOLVES[k] = 0
        out, cfg, fin, m = row.run_row(
            dev, steps=LARGE_GRID_STEPS, warmup=LARGE_GRID_WARMUP, row=kind,
            n_per_species=LARGE_GRID_N_PER_SPECIES, n=LARGE_GRID_DN_N, ng=ng)
        thomas = dict(magnetized.THOMAS_SOLVES)
        lps = {k: v / LARGE_GRID_STEPS for k, v in out["launches"].items()}
        name = newton[kind]
        its = m.newton_iters.cpu()
        resid = m.newton_residual.cpu()
        rec = dict(n=out["n"], ng=ng, steps=LARGE_GRID_STEPS,
                   ms_per_step=out["us_per_step"] / 1e3,
                   pushes_per_s=out["pushes_per_s"],
                   newton_mean=float(its.float().mean()), newton_max=int(its.max()),
                   steps_at_maxiter=int((its >= cfg.newton_maxiter if kind == "iead"
                                         else its >= magnetized.DN_MAXITER).sum()),
                   residual_max=float(resid.max()), launches_per_step=lps,
                   host_syncs_per_step=0.0, thomas_solves=thomas)
        if kind == "iead":
            rec["phi_max_over_phi_f"] = out["phi_max_over_phi_f"]
            bad = row.population_problems(m)
        else:
            bad = ([f"flux cap {out['react_max']}"]
                   if out["react_max"] > cfg.flux_limit else [])
            rec.update(phi_wall=out["phi_wall"], phi_far=out["phi_far"])
        if not (bool(torch.isfinite(m.phi).all()) and bool(torch.isfinite(fin.p).all())):
            bad.append("non-finite phi or positions")
        if any(thomas.values()):
            bad.append(f"Thomas solves {thomas}")
        if (out["launches"].get(f"{name}_large") != LARGE_GRID_STEPS
                or out["launches"].get(name)):
            bad.append(f"launches {out['launches']}: not one {name}_large a step")
        log(f"[large grids] {label}: n = {out['n']}, {LARGE_GRID_STEPS} steps "
            f"after {LARGE_GRID_WARMUP}: {rec['ms_per_step']:.3f} ms/step, "
            f"{rec['pushes_per_s']:.4e} pushes/s, Newton iterations a step mean "
            f"{rec['newton_mean']:.2f}, max {rec['newton_max']} "
            f"({rec['steps_at_maxiter']} steps at maxiter; largest residual "
            f"{rec['residual_max']:.3e} against tol "
            f"{cfg.newton_tol if kind == 'iead' else magnetized.DN_TOL}), "
            f"launches a step {lps}, host syncs a step 0 (sync debug mode "
            f"'error'), Thomas solves {thomas}")
        problems += [f"{label}: {b}" for b in bad]
        if label == "pic_iead ng 16384" or kind == "dn":
            launches[f"{name}_large"] = out["launches"].get(f"{name}_large", 0)
        del fin, m
        torch.cuda.empty_cache()
        rec["check"] = _large_grid_check(kind, ng, dev)
        res["runs"][label] = rec

    # the chain solve at a slab's rows on one group-less rank: no interface,
    # the launch alone, under sync debug mode 'error'
    c = LARGE_SLAB_NG // 2
    chain = distributed_poisson.make_distributed_tridiag_chain(
        c, 1, make_mesh(device=dev))
    sysm = _chain_system(c, "boltzmann", torch.Generator().manual_seed(39), dev)
    chain(*sysm)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        chain(*sysm)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    if K.LAUNCHES["tridiag3_chain_large"] != 1:
        problems.append(f"the chain solve at c = {c}: launches {K.LAUNCHES}")
    log(f"[large grids] the chain solve at c = {c} under sync debug mode "
        "'error': one tridiag3_chain_large launch, 0 host reads")
    K.reset_launch_counts()

    jobs = [("magnetized", dict(n_per_species=LARGE_GRID_N_PER_SPECIES,
                                ng=LARGE_SLAB_NG, steps=LARGE_SLAB_STEPS,
                                solver=solver))
            for solver in ("distributed", "replicated")]
    t0 = time.perf_counter()
    two = spawn.run(2, drow.slab_jobs, jobs, device=dev)
    res["slabs"] = {"spawn_s": time.perf_counter() - t0}
    per = {}
    for i, solver in enumerate(("distributed", "replicated")):
        ranks = [r[i] for r in two]
        a = ranks[0]["rows"]
        its = a["newton_iters"]
        lps = ranks[0]["launches_per_step"]
        rec = dict(ng=LARGE_SLAB_NG, cells_per_slab=c, steps=LARGE_SLAB_STEPS,
                   ms_per_step=ranks[0]["ms_per_step"],
                   newton_mean=sum(its) / len(its), newton_max=max(its),
                   launches_per_step=lps,
                   host_syncs_per_step=ranks[0]["host_syncs_per_step"],
                   staged_bytes_per_step=ranks[0]["staged_bytes_per_step"],
                   rows_equal=all(r["rows"] == a for r in ranks),
                   n_migrated=sum(a["n_migrated"]), n_dropped=sum(a["n_dropped"]))
        want = ({"tridiag3_chain_large": sum(its) / LARGE_SLAB_STEPS}
                if solver == "distributed" else {"boltzmann_dirichlet_large": 1.0})
        for k, v in want.items():
            if lps.get(k) != v:
                problems.append(f"slabs {solver}: {k} {lps.get(k)} a step, not {v}")
        for k in ("tridiag3_chain", "boltzmann_dirichlet"):
            if lps.get(k):
                problems.append(f"slabs {solver}: the small path's {k} ran")
        if not rec["rows_equal"]:
            problems.append(f"slabs {solver}: the two ranks' rows differ")
        if rec["n_dropped"]:
            problems.append(f"slabs {solver}: {rec['n_dropped']} dropped")
        log(f"[large grids] pic_iead_dd, ng = {LARGE_SLAB_NG} on two gloo ranks "
            f"(c = {c} a slab), solver '{solver}': {LARGE_SLAB_STEPS} steps, "
            f"{rec['ms_per_step']:.3f} ms/step, Newton iterations a step mean "
            f"{rec['newton_mean']:.2f} (max {rec['newton_max']}), launches a step "
            f"{lps}, host syncs a step {rec['host_syncs_per_step']:.2f} (the "
            f"residual's read an iteration and the gloo staging), staged "
            f"{rec['staged_bytes_per_step']:.0f} B a step a rank, rows equal "
            f"on both ranks: {rec['rows_equal']}, migrated {rec['n_migrated']}, "
            f"dropped {rec['n_dropped']}")
        per[solver] = (a, ranks[0])
        res["slabs"][solver] = rec
    (a_d, r_d), (a_r, r_r) = per["distributed"], per["replicated"]
    phi_max_gap = _dp_gap(a_r["phi_max"], a_d["phi_max"])
    last_r = torch.tensor(r_r["phi_last"], dtype=torch.float64)
    last_d = torch.tensor(r_d["phi_last"], dtype=torch.float64)
    phi_gap = float((last_d - last_r).abs().max() / last_r.abs().max())
    log(f"[large grids] the two solvers: phi_max every step within "
        f"{phi_max_gap:.3e}, the last phi within {phi_gap:.3e} of its largest "
        f"(tol {TOL_LARGE_SLAB_PHI} each)")
    if not (phi_max_gap <= TOL_LARGE_SLAB_PHI and phi_gap <= TOL_LARGE_SLAB_PHI):
        problems.append(f"slab solvers apart: phi_max {phi_max_gap}, phi {phi_gap}")
    res["slabs"].update(phi_max_gap=phi_max_gap, phi_gap=phi_gap)
    launches["tridiag3_chain_large"] = int(round(
        r_d["launches_per_step"].get("tridiag3_chain_large", 0) * LARGE_SLAB_STEPS))
    res["launches"] = launches
    if problems:
        raise AssertionError("large grids: " + "; ".join(problems))
    return res



# phase 40, large grids, sheath and deposits: the slice's main path, the
# four kernels past their shared-memory ceilings (the deterministic sums
# of the sheath pass and deposit_det as int64 fixed point, deposit2 and the
# carried Boris deposit by global float atomics), each held against its
# plain version just above its old ceiling and at LARGE_KERNEL_NGS, then
# the engines that run them: the sheath engine fused and composed,
# domain_sheath on one NCCL rank and on two gloo ranks, and the configs[3]
# load plain and carried
LARGE_FIRST_NG = {"sheath_picard": 1761, "sheath_finalize": 1761,
                  "deposit_det": 1817, "deposit2": 29_057,
                  "boris_gather_push_deposit": 19_371}
LARGE_KERNEL_NGS = (65_536, 1 << 20)
LARGE_KERNEL_NS = (1_000_000, 10_000_000)
# the shape whose record stands for a kernel's large mode in the kernels
# line, every other shape beside it
LARGE_KERNEL_MAIN = "n 10000000, ng 65536"
# device-memory bytes a node of one call beside the rows'
# (BYTES_PER_PARTICLE): the field read and the current written (the
# sheath pass), the sum written (deposit_det), two sums written
# (deposit2), the field read and two sums written (row 9)
LARGE_NODE_BYTES = {"sheath_picard": 8, "sheath_finalize": 8, "deposit_det": 4,
                    "deposit2": 8, "boris_gather_push_deposit": 12}
# the sheath engine at configs[2]'s physics (presets.sheath_dd): fused at
# ng 8,192 (n = 1e6) and 65,536 (n = 8e6, ~122 rows a cell, the row's
# scale), composed at 8,192
SHEATH_LARGE_RUNS = {"fused ng 8192": ("fused", 8192, 1_000_000),
                     "fused ng 65536": ("fused", 65_536, 8_000_000),
                     "composed ng 8192": ("composed", 8192, 1_000_000)}
SHEATH_LARGE_WARMUP, SHEATH_LARGE_STEPS, SHEATH_LARGE_SYNC_STEPS = 3, 20, 5
# tests/test_torch_cuda.py::test_sheath_step_card_matches_cpu's limits:
# active positions in cells, e, j and phi of their largest
TOL_SHEATH_CARD_CPU = {"p (cells)": 1e-4, "e": 1e-4, "j": 1e-4, "phi": 1e-4}
DOM_SHEATH_LARGE, DOM_SHEATH_LARGE_STEPS = dict(n=1_000_000, ng=8192), 10
MAG_LARGE_NG, MAG_LARGE_STEPS = 32_768, 20


def _large_kernel_case(name: str, n: int, ng: int, gen: torch.Generator, dev,
                       timed: bool) -> dict:
    """One kernel of phase 40 at (n, ng) against its plain version on the
    card. The deterministic three: the current bit-equal from call to
    call and within TOL_DEP of a float64 deposit of the same terms, the
    sheath pass's outputs bit-equal to its plain version's. deposit2:
    within deposit_tol of the plain version and TOL_DEP of float64. Row 9:
    p1 and the velocities bit-equal, rho and n within TOL_DEP of float64
    sums, the clamp counts equal. With ``timed``, device_ms and the plain
    version's time, the bound (rows and nodes) and, for deposit2,
    index_add_ of the same four terms a row as its library call."""
    from pypic_tpu_torch.ops import cuda_cic as K
    from pypic_tpu_torch.ops import cuda_sheath as S

    kw = dict(dt=SHEATH_DT, dx=SHEATH_DX)
    errs, library = {}, None
    if name in ("sheath_picard", "sheath_finalize"):
        final = name == "sheath_finalize"
        args = _sheath_inputs(n, ng, gen, dev)
        fn = S.sheath_finalize if final else S.sheath_picard
        plain = S.sheath_finalize_plain if final else S.sheath_picard_plain
        got = fn(*args, **kw)
        same = torch.equal(fn(*args, **kw)[-1], got[-1])
        ref = plain(*args, **kw)
        outs = all(torch.equal(g, r) for g, r in zip(got[:-1], ref[:-1]))
        x1, u1, xh, uh, _ = S._push_plain(args[0], args[1], args[2], args[3],
                                          args[4], args[6], SHEATH_DT, SHEATH_DX)
        pos, vals = (x1, u1) if final else (xh, uh)
        exact = S.sheath_deposit_plain(pos.double(), vals.double(), got[-2].double(),
                                       args[5].double(), ng, **kw)
        a, r = rel_err(exact, got[-1])
        errs["j"] = dict(abs=a, err=r, kind="rel vs float64", tol=TOL_DEP)
        errs["outputs"] = dict(abs=0.0 if outs else 1.0, err=0.0 if outs else 1.0,
                               kind="bit-equal to the plain version", tol=0.0)
        call, plain_call = (lambda: fn(*args, **kw)), (lambda: plain(*args, **kw))
        del x1, u1, xh, uh, pos, vals, exact, ref
    elif name == "deposit_det":
        p = torch.rand(n, generator=gen, device=dev) * (ng - 1)
        v = torch.randn(n, generator=gen, device=dev) * 1e3
        got = K.deposit_det(p, v, ng, periodic=False)
        same = torch.equal(K.deposit_det(p, v, ng, periodic=False), got)
        a, r = rel_err(K.deposit_plain(p.double(), v.double(), ng, periodic=False), got)
        errs["out"] = dict(abs=a, err=r, kind="rel vs float64", tol=TOL_DEP)
        call = lambda: K.deposit_det(p, v, ng, periodic=False)  # noqa: E731
        plain_call = lambda: K.deposit_plain(p, v, ng, periodic=False)  # noqa: E731
    elif name == "deposit2":
        _, p, vx, vy, _, _, act = _mag_inputs(n, gen, dev, ng)
        va, vb = vx * act, vy.abs() * act
        got = K.deposit2(p, va, vb, ng, periodic=False)
        same = True
        ref = K.deposit2_plain(p, va, vb, ng, periodic=False)
        exact = K.deposit2_plain(p.double(), va.double(), vb.double(), ng, periodic=False)
        for k, g_, r_, e_ in zip("ab", got, ref, exact):
            a, r = rel_err(r_, g_)
            errs[f"{k} plain"] = dict(abs=a, err=r, kind="rel vs plain",
                                      tol=deposit_tol(n, ng))
            a, r = rel_err(e_, g_)
            errs[f"{k} f64"] = dict(abs=a, err=r, kind="rel vs float64", tol=TOL_DEP)
        call = lambda: K.deposit2(p, va, vb, ng, periodic=False)  # noqa: E731
        plain_call = lambda: K.deposit2_plain(p, va, vb, ng, periodic=False)  # noqa: E731
        if timed:
            from pypic_tpu_torch.ops.cic import cic_indices_weights

            il, ir, wl, wr = cic_indices_weights(p, ng - 1, False)
            idx = torch.cat([il, ir, il + ng, ir + ng])
            terms = torch.cat([va * wl, va * wr, vb * wl, vb * wr])
            library = device_ms(lambda: torch.zeros(2 * ng, device=dev).index_add_(
                0, idx, terms), calls=10)
        del ref, exact
    else:
        args = _carried_mag_inputs(n, gen, dev, 1.0, ng)
        bkw = dict(b=(0.1395, 1.9951, 0.0), dt_dx=1e-10 / 2.5e-6, pad=CARRIED_PAD,
                   swap_weights=True)
        got = K.boris_gather_push_deposit(*args, **bkw)
        same = True
        ref = K.boris_gather_push_deposit_plain(*args, **bkw)
        exact = K.boris_gather_push_deposit_plain(*args, acc_dtype=torch.float64, **bkw)
        outs = all(torch.equal(g, r) for g, r in zip(got[:4], ref[:4]))
        errs["push"] = dict(abs=0.0 if outs else 1.0, err=0.0 if outs else 1.0,
                            kind="bit-equal to the plain version", tol=0.0)
        for k, i in (("rho", 4), ("n", 5)):
            a, r = rel_err(exact[i], got[i])
            errs[k] = dict(abs=a, err=r, kind="rel vs float64", tol=TOL_DEP)
        clamps = (int(got[6]), int(ref[6]))
        errs["clamped"] = dict(abs=float(clamps[0] - clamps[1]),
                               err=float(abs(clamps[0] - clamps[1])),
                               kind=f"clamp counts {clamps}", tol=0.0)
        call = lambda: K.boris_gather_push_deposit(*args, **bkw)  # noqa: E731
        plain_call = lambda: K.boris_gather_push_deposit_plain(*args, **bkw)  # noqa: E731
        del ref, exact
    if not same:
        raise AssertionError(f"{name} at n = {n}, ng = {ng}: the sum differs from "
                             "call to call")
    err = _check(errs, f"{name}(n = {n}, ng = {ng})")
    rec = dict(n=n, ng=ng, max_abs_err=err, bit_equal_call_to_call=same)
    if timed:
        plain_ms = cuda_ms(plain_call, reps=1, calls=1)
        b, by = bound(name, n, extra_bytes=LARGE_NODE_BYTES[name] * ng)
        rec.update(ms=device_ms(call, calls=10), plain_ms=plain_ms, bound_ms=b,
                   bound_by=by, library_ms=library)
        log(f"[large sheath] {name} at n = {n}, ng = {ng}: {rec['ms']:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {b:.4f} ms ({by})"
            + (f", library zeros(2 ng).index_add_ of the four terms a row "
               f"{library:.4f} ms" if library is not None else ", no single "
               "library call computes it"))
    del got
    return rec


def large_kernel_times(dev) -> dict:
    """Phase 40's kernels alone (module docstring): each at its first large
    ng and at LARGE_KERNEL_NGS, n in LARGE_KERNEL_NS; timed at the last
    two. Returns {kernel: {shape: record}}."""
    gen = torch.Generator(device=dev).manual_seed(40)
    out = {}
    for name, first in LARGE_FIRST_NG.items():
        out[name] = {}
        for ng in (first,) + LARGE_KERNEL_NGS:
            for n in LARGE_KERNEL_NS:
                out[name][f"n {n}, ng {ng}"] = _large_kernel_case(
                    name, n, ng, gen, dev, timed=ng != first)
                torch.cuda.empty_cache()
    return out


def _sheath_large_run(backend: str, ng: int, n: int, dev) -> dict:
    """The sheath engine at configs[2]'s physics (presets.sheath_dd) on
    ng nodes and n rows: SHEATH_LARGE_WARMUP steps, then the launch counts
    from 0 and SHEATH_LARGE_STEPS timed steps, then SHEATH_LARGE_SYNC_STEPS
    more under sync debug mode 'warn' (host syncs against the engine's
    one read a pass); one step from the card's last state on the CPU and
    on the card at TOL_SHEATH_CARD_CPU, the Picard counts by
    floor_exit_counts_agree, statuses, losses and exit histograms equal."""
    import dataclasses

    from pypic_tpu_torch import interop, presets
    from pypic_tpu_torch.diagnostics import floor_exit_counts_agree
    from pypic_tpu_torch.engines import sheath
    from pypic_tpu_torch.ops import cuda_cic as K
    from pypic_tpu_torch.runner import run
    from pypic_tpu_torch.tools import sheath as srow

    t0 = time.perf_counter()
    pre = presets.sheath_dd(n=n, ng=ng, device=dev)
    setup_s = time.perf_counter() - t0
    cfg = dataclasses.replace(pre.config, backend=backend)
    step = sheath.make_step(cfg)
    st, _ = run(step, pre.state, SHEATH_LARGE_WARMUP)
    del pre
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    fin, m = run(step, st, SHEATH_LARGE_STEPS)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {k: v for k, v in K.LAUNCHES.items() if v}
    iters = m.picard_iters.cpu()
    passes = int(iters.sum())
    problems = _sheath_population(m, n)
    population = "kept" if not problems else "NOT kept"
    if int(iters.max()) > cfg.maxiter:
        problems.append(f"Picard {int(iters.max())} above maxiter")
    want = ({"sheath_picard": passes, "sheath_finalize": SHEATH_LARGE_STEPS}
            if backend == "fused" else {"gather": passes})
    for k, v in want.items():
        if launches.get(k) != v:
            problems.append(f"launches {launches}: {k} not {v}")
    if backend == "composed" and launches.get("deposit_det", 0) < 2 * passes:
        problems.append(f"launches {launches}: deposit_det below 2 a pass")
    syncs = srow.count_syncs(step, fin, cfg.maxiter, SHEATH_LARGE_SYNC_STEPS)
    if syncs["host_syncs_per_step"] != syncs["host_reads_per_step"]:
        problems.append(f"host syncs {syncs}")
    left, right = srow.wall_drops(m, SHEATH_LARGE_STEPS)
    rec = dict(n=n, ng=ng, backend=backend, steps=SHEATH_LARGE_STEPS,
               setup_s=setup_s, ms_per_step=secs * 1e3 / SHEATH_LARGE_STEPS,
               pushes_per_s=n * SHEATH_LARGE_STEPS / secs,
               picard_mean=float(iters.float().mean()), picard_max=int(iters.max()),
               steps_at_maxiter=int((iters == cfg.maxiter).sum()),
               host_syncs_per_step=syncs["host_syncs_per_step"],
               host_reads_per_step=syncs["host_reads_per_step"],
               wall_drop_left_te=left, wall_drop_right_te=right,
               lost_per_step=float((m.n_lost_left + m.n_lost_right).float().mean()),
               launches=launches)
    del m
    d = interop.sheath_state_to_numpy(fin)
    del fin, st
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    c = step(interop.sheath_state_from_numpy(d, "cpu"))
    cpu_s = time.perf_counter() - t0
    g = step(interop.sheath_state_from_numpy(d, dev))
    errs = _sheath_step_errors(c, g)
    errs.pop("u")
    ok, line = floor_exit_counts_agree(
        c[1].picard_iters, float(c[1].picard_residual), g[1].picard_iters,
        float(g[1].picard_residual), d["e"], c[0].e, tol=cfg.tol,
        tol_floor=cfg.tol_floor)
    losses = {k: (int(getattr(c[1], k)), int(getattr(g[1], k)))
              for k in ("n_lost_left", "n_lost_right")}
    same = (torch.equal(c[0].active, g[0].active.cpu())
            and torch.equal(c[0].exit_hist, g[0].exit_hist.cpu()))
    bad = {k: v for k, v in errs.items() if not v <= TOL_SHEATH_CARD_CPU[k]}
    if not ok:
        bad["picard"] = line
    if any(a != b for a, b in losses.values()) or not same:
        bad["losses, statuses or exit histograms"] = losses
    if bad:
        problems.append(f"one step card against CPU: {bad}")
    rec["check"] = dict(errors=errs, picard=line, losses=losses, cpu_step_s=cpu_s)
    log(f"[large sheath] {backend} ng = {ng}, n = {n}: {rec['ms_per_step']:.3f} "
        f"ms/step ({SHEATH_LARGE_STEPS} steps after {SHEATH_LARGE_WARMUP}; set-up "
        f"{setup_s:.1f} s), {rec['pushes_per_s']:.4e} pushes/s, Picard passes a "
        f"step mean {rec['picard_mean']:.2f} max {rec['picard_max']} "
        f"({rec['steps_at_maxiter']} steps at maxiter {cfg.maxiter}), host syncs a "
        f"step {rec['host_syncs_per_step']:.2f} (reads {rec['host_reads_per_step']:.2f}), "
        f"wall drops {left:.4f}, {right:.4f} Te/e (steps {SHEATH_LARGE_WARMUP}-"
        f"{SHEATH_LARGE_WARMUP + SHEATH_LARGE_STEPS - 1}: the sheath still forming), "
        f"losses a step {rec['lost_per_step']:.1f}, population {population}, "
        f"launches {launches}; one step card against CPU ({cpu_s:.1f} s on the "
        "CPU): "
        + ", ".join(f"{k} {v:.3e} (tol {TOL_SHEATH_CARD_CPU[k]:.0e})"
                    for k, v in errs.items())
        + f"; Picard {line}; losses (CPU, GPU) {losses}; statuses and exit "
        f"histograms {'equal' if same else 'DIFFER'}")
    return rec, problems


def _dom_sheath_large(dev) -> tuple[dict, list]:
    """domain_sheath at DOM_SHEATH_LARGE (global ng 8,192, the extended
    slab's currents in deposit_det's large mode): one rank in a one-rank
    NCCL group, DOM_SHEATH_LARGE_STEPS timed steps after 2 (launches a
    step: gather a pass, deposit_det two a pass, sheath_reinject one;
    host syncs = reads); one step from the initial state on a group-less
    rank on the CPU and on the card at TOL_SHEATH_CARD_CPU; two gloo
    ranks on the card (rows equal on both, nothing dropped, particles
    migrated, the population kept, step 0 against the one-rank step at
    phase 37's limits)."""
    import torch.distributed as dist

    from pypic_tpu_torch.diagnostics import floor_exit_counts_agree
    from pypic_tpu_torch.ops import cuda_cic as K
    from pypic_tpu_torch.parallel import domain_sheath, make_mesh, spawn
    from pypic_tpu_torch.tools import domain as drow

    res, problems = {}, []
    n = DOM_SHEATH_LARGE["n"]
    drow.process_group()
    try:
        mesh = make_mesh(device=dev)
        cfg, st = drow.sheath_row(mesh, **DOM_SHEATH_LARGE)
        K.reset_launch_counts()
        sh = drow.timed_rows(domain_sheath.make_step(cfg, mesh), st,
                             DOM_SHEATH_LARGE_STEPS, warmup=2)
        ssum, bad = drow.sheath_summary(sh, n, cfg.maxiter)
        problems += [f"domain_sheath one rank: {b}" for b in bad]
        ks = sh["rows"]["picard_iters"]
        reads = sum(k - (k == cfg.maxiter) for k in ks) / len(ks)
        want = dict(gather=sum(ks) / len(ks), deposit_det=2 * sum(ks) / len(ks),
                    sheath_reinject=1.0)
        if sh["launches_per_step"] != want:
            problems.append(f"domain_sheath launches {sh['launches_per_step']} != {want}")
        if sh["host_syncs_per_step"] != reads:
            problems.append(f"domain_sheath host syncs {sh['host_syncs_per_step']} "
                            f"!= reads {reads}")
        res["one_rank"] = dict(ms_per_step=sh["ms_per_step"],
                               launches_per_step=sh["launches_per_step"],
                               host_syncs_per_step=sh["host_syncs_per_step"], **ssum)
        log(f"[large sheath] domain_sheath one rank (NCCL), global ng "
            f"{DOM_SHEATH_LARGE['ng']}, n = {n}: {DOM_SHEATH_LARGE_STEPS} steps, "
            f"{sh['ms_per_step']:.3f} ms/step, Picard mean {ssum['picard_mean']:.2f} "
            f"(max {ssum['picard_max']}), launches a step {sh['launches_per_step']}, "
            f"host syncs a step {sh['host_syncs_per_step']:.2f} (reads {reads:.2f}), "
            f"population {ssum['population']}, dropped {ssum['n_dropped']}")
        del st, sh
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()

    out = {}
    for where in ("cpu", dev):
        mesh = make_mesh(device=where)
        cfg, st = drow.sheath_row(mesh, **DOM_SHEATH_LARGE)
        e0 = st.e.cpu().double().numpy()
        out[str(where)] = domain_sheath.make_step(cfg, mesh)(st)
    sc, mc = out["cpu"]
    sg, mg = out[str(dev)]
    act = sc.filled & (sc.active == 1)
    errs = {"p (cells)": float((sg.p.cpu()[act].double() - sc.p[act].double()).abs().max()),
            "e": rel_err(sc.e, sg.e.cpu())[1], "j": rel_err(sc.j, sg.j.cpu())[1],
            "phi": rel_err(mc.phi, mg.phi.cpu())[1]}
    ok, line = floor_exit_counts_agree(
        mc.picard_iters, float(mc.picard_residual), mg.picard_iters,
        float(mg.picard_residual), e0, sc.e, tol=cfg.tol, tol_floor=cfg.tol_floor)
    counts = {k: (int(getattr(mc, k)), int(getattr(mg, k)))
              for k in ("n_lost_left", "n_lost_right", "n_migrated", "n_dropped")}
    bad = {k: v for k, v in errs.items() if not v <= TOL_SHEATH_CARD_CPU[k]}
    if not ok:
        bad["picard"] = line
    if any(a != b for a, b in counts.values()):
        bad["counts"] = counts
    if bad:
        problems.append(f"domain_sheath one step card against CPU: {bad}")
    res["check"] = dict(errors=errs, picard=line, counts=counts)
    log(f"[large sheath] domain_sheath, one group-less rank, one step from the "
        f"initial state, card against CPU: "
        + ", ".join(f"{k} {v:.3e} (tol {TOL_SHEATH_CARD_CPU[k]:.0e})"
                    for k, v in errs.items())
        + f"; Picard {line}; counts (CPU, GPU) {counts}")
    del out, sc, sg
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    two = spawn.run(2, drow.slab_jobs, [("sheath", dict(
        steps=DOM_SHEATH_LARGE_STEPS, **DOM_SHEATH_LARGE))], device=dev)
    ranks = [r[0] for r in two]
    a = ranks[0]["rows"]
    equal = all(r["rows"] == a for r in ranks)
    tot = [x + y + z for x, y, z in zip(a["n_active"], a["n_lost_left"],
                                        a["n_lost_right"])]
    step0 = dict(field_energy=_dp_gap([float(mg.field_energy)], [a["field_energy"][0]]),
                 kinetic_energy=_dp_gap([float(mg.kinetic_energy)],
                                        [a["kinetic_energy"][0]]),
                 phi=float((torch.tensor(ranks[0]["phi_first"]) - mg.phi.cpu())
                           .abs().max() / mg.phi.abs().max()),
                 picard=(int(mg.picard_iters), a["picard_iters"][0]))
    rec = dict(spawn_s=time.perf_counter() - t0, ms_per_step=ranks[0]["ms_per_step"],
               host_syncs_per_step=ranks[0]["host_syncs_per_step"],
               staged_bytes_per_step=ranks[0]["staged_bytes_per_step"],
               rows_equal=equal, n_migrated=sum(a["n_migrated"]),
               n_dropped=sum(a["n_dropped"]), population=[min(tot), max(tot)],
               picard_iters=a["picard_iters"], step0_against_one_rank=step0)
    if not equal:
        problems.append("domain_sheath two ranks: rows differ")
    if rec["n_dropped"] or not rec["n_migrated"] > 0 or set(tot) != {n}:
        problems.append(f"domain_sheath two ranks: dropped {rec['n_dropped']}, "
                        f"migrated {rec['n_migrated']}, population {rec['population']}")
    if not (step0["field_energy"] <= 2 * TOL_SHEATH_STEP["e"]
            and step0["kinetic_energy"] <= TOL_SLAB_SHEATH_KE
            and step0["phi"] <= TOL_SHEATH_STEP["phi"]
            and abs(step0["picard"][0] - step0["picard"][1]) <= 1):
        problems.append(f"domain_sheath two ranks: step 0 against one rank {step0}")
    res["two_gloo_ranks"] = rec
    log(f"[large sheath] domain_sheath on two gloo ranks on the card, global ng "
        f"{DOM_SHEATH_LARGE['ng']}: {DOM_SHEATH_LARGE_STEPS} steps, "
        f"{rec['ms_per_step']:.3f} ms/step, host syncs a step "
        f"{rec['host_syncs_per_step']:.2f}, rows equal on both ranks: {equal}, "
        f"migrated {rec['n_migrated']}, dropped {rec['n_dropped']}, population "
        f"{rec['population']}, step 0 against the one-rank step {step0}")
    return res, problems


def _large_carried_check(ng: int, dev) -> tuple[dict, list]:
    """One carried step (tools/magnetized.py --carried's configuration, the
    carry primed) of the configs[3] load at ng from the preset's state, on
    the CPU (the plain versions, newton_backend 'pallas') and on the card,
    the same source table on both: rho, phi and v at phase 14's limits,
    positions by phase 39's rule (|p| the larger of start and end), the
    rho and n carried into the next step at rho's rtol of their largest
    node, and the counts carry_clamped included equal. No float64 step: the carried rho sits
    where the window frame clamps put it, which a fresh deposit does
    not."""
    import dataclasses

    from pypic_tpu_torch import interop, sources
    from pypic_tpu_torch.engines import magnetized
    from pypic_tpu_torch.tools import magnetized as row

    pre = row.preset("iead", "cpu", LARGE_GRID_N_PER_SPECIES, LARGE_GRID_DN_N, ng)
    cfg_gpu = dataclasses.replace(pre.config, **row.CARRIED)
    cfg_cpu = dataclasses.replace(cfg_gpu, backend="fused", newton_backend="pallas")
    d = interop.magnetized_state_to_numpy(magnetized.prime_carry(pre.state, cfg_cpu))
    del pre
    src = cfg_cpu.source

    def hooks(state):
        return {"source_draws": lambda step, n: sources.sample_source_batch(
            state.rng, step, n, cfg_cpu.grid, src.ti, src.mass, vx=src.vx,
            device="cpu")}

    sc = interop.magnetized_state_from_numpy(d, "cpu")
    kw_c, kw_g = _replayed(hooks)(sc, dev)
    t0 = time.perf_counter()
    c = magnetized.make_step(cfg_cpu, **kw_c)(sc)
    cpu_s = time.perf_counter() - t0
    g = magnetized.make_step(cfg_gpu, **kw_g)(interop.magnetized_state_from_numpy(d, dev))
    errs = {k: v for k, v in _mag_step_errors(c, g).items() if k != "p"}
    # the rho and n carried into the next step, at the opening rho's rtol
    # taken of the largest node: the window frame's clamps leave the nodes
    # stride k - pad nearly empty at this grid, and there a row's p1, parted
    # by the routes' velocity ulp (phase 39), moves a share of its weight
    # that no per-node rtol holds (beside it, not a limit)
    rtol, _ = TOL_MAG_STEP["rho"]
    per_node = {}
    for k in ("rho", "n"):
        ref, got = getattr(c[0], k).double(), getattr(g[0], k).double().cpu()
        errs[f"{k} carried"] = float((got - ref).abs().max() / ref.abs().max()) / rtol
        per_node[k] = _scaled_gap(ref, got, rtol, 0.0)
    rtol, atol = TOL_MAG_STEP["p"]
    pc, pg = c[0].p.double(), g[0].p.double().cpu()
    p0 = torch.from_numpy(d["p"]).double()
    before = torch.from_numpy(d["active"] == 1)
    act = c[0].active == 1
    scale = torch.where(before, torch.maximum(p0.abs(), pc.abs()), pc.abs())
    errs["p"] = float(((pg - pc).abs() / (atol + rtol * scale))[act].max())
    counts = {k: (int(getattr(c[1], k)), int(getattr(g[1], k))) for k in (
        "n_active", "n_hit_wall", "n_reactivated", "newton_iters", "carry_clamped")}
    bad = {k: v for k, v in errs.items() if not v <= 1.0}
    for k in ("n_active", "n_reactivated", "carry_clamped"):
        if counts[k][0] != counts[k][1]:
            bad[k] = counts[k]
    log(f"[large sheath] configs[3] carried, ng = {ng}, one step from the primed "
        "preset, GPU vs CPU, |d| / (atol + rtol |ref|) (<= 1 passes; p with |p| the "
        "larger of start and end; rho and n carried with |ref| their largest node): "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f"; the carried rho and n node by node (not a limit) {per_node}; counts "
        f"(CPU, GPU) {counts}; the CPU step {cpu_s:.1f} s")
    return dict(errors=errs, carried_per_node=per_node, counts=counts,
                cpu_step_s=cpu_s), (
        [f"carried check: {bad}"] if bad else [])


def _mag_large_runs(dev) -> tuple[dict, list]:
    """The configs[3] load (n = 999,996) at MAG_LARGE_NG through
    tools/magnetized.run_row, 'auto' (deposit2's large mode) and --carried
    (row 9's large mode, carried_pad 2), MAG_LARGE_STEPS steps after 3
    under sync debug mode 'error'; the plain run held against the CPU and
    a float64 step for one step (_large_grid_check), the carried one
    against the CPU (_large_carried_check)."""
    from pypic_tpu_torch.tools import magnetized as row

    res, problems = {}, []
    for label, over in (("plain", {}), ("carried", row.CARRIED)):
        out, cfg, fin, m = row.run_row(
            dev, steps=MAG_LARGE_STEPS, warmup=3, row="iead",
            n_per_species=LARGE_GRID_N_PER_SPECIES, ng=MAG_LARGE_NG, **over)
        lps = {k: v / MAG_LARGE_STEPS for k, v in out["launches"].items()}
        want = (["boris_gather_push_deposit", "deposit2"] if over
                else ["deposit2", "boris_gather_push"]) + ["boltzmann_dirichlet_large"]
        bad = row.population_problems(m)
        if any(lps.get(k) != 1.0 for k in want):
            bad.append(f"launches a step {lps}: not one each of {want}")
        if not (bool(torch.isfinite(m.phi).all()) and bool(torch.isfinite(fin.p).all())):
            bad.append("non-finite phi or positions")
        its = m.newton_iters.cpu()
        rec = dict(n=out["n"], ng=MAG_LARGE_NG, steps=MAG_LARGE_STEPS,
                   ms_per_step=out["us_per_step"] / 1e3,
                   pushes_per_s=out["pushes_per_s"],
                   newton_mean=float(its.float().mean()), newton_max=int(its.max()),
                   launches=out["launches"], launches_per_step=lps,
                   phi_max_over_phi_f=out["phi_max_over_phi_f"])
        if over:
            rec["carried"] = out["carried"]
            rec["carry_clamped_per_particle_step"] = (
                out["carried"]["carry_clamped"] / (out["n"] * MAG_LARGE_STEPS))
        log(f"[large sheath] configs[3] {label} at ng = {MAG_LARGE_NG}: n = "
            f"{out['n']}, {MAG_LARGE_STEPS} steps after 3, {rec['ms_per_step']:.3f} "
            f"ms/step, Newton mean {rec['newton_mean']:.2f} (max {rec['newton_max']}), "
            f"launches a step {lps}, host syncs 0 (sync debug mode 'error')"
            + (f", carried sums {out['carried']} "
               f"({rec['carry_clamped_per_particle_step']:.4f} clamped a particle "
               "and step)" if over else ""))
        problems += [f"configs[3] {label}: {b}" for b in bad]
        del fin, m
        torch.cuda.empty_cache()
        if over:
            rec["check"], bad = _large_carried_check(MAG_LARGE_NG, dev)
        else:
            rec["check"] = _large_grid_check("iead", MAG_LARGE_NG, dev, steps=1)
            bad = []
        problems += bad
        res[label] = rec
    return res, problems


def phase_large_sheath(dev) -> dict:
    """Phase 40 (module docstring). Returns each run's figures, the kernels'
    records by shape and the launches of the large modes on the main
    paths (the sheath pass and finalize: the fused runs; deposit_det: the
    composed run; deposit2: the plain configs[3] run; row 9: the carried
    one)."""
    res = {"kernels": large_kernel_times(dev)}
    problems, launches = [], collections.Counter()
    res["sheath"] = {}
    for label, (backend, ng, n) in SHEATH_LARGE_RUNS.items():
        rec, bad = _sheath_large_run(backend, ng, n, dev)
        res["sheath"][label] = rec
        problems += [f"sheath {label}: {b}" for b in bad]
        keep = (("sheath_picard", "sheath_finalize") if backend == "fused"
                else ("deposit_det",))
        launches.update({k: rec["launches"].get(k, 0) for k in keep})
        torch.cuda.empty_cache()
    res["domain_sheath"], bad = _dom_sheath_large(dev)
    problems += bad
    res["magnetized"], bad = _mag_large_runs(dev)
    problems += bad
    launches["deposit2"] = res["magnetized"]["plain"]["launches"].get("deposit2", 0)
    launches["boris_gather_push_deposit"] = (
        res["magnetized"]["carried"]["launches"].get("boris_gather_push_deposit", 0))
    res["launches"] = dict(launches)
    missing = [k for k in LARGE_FIRST_NG if not res["launches"].get(k)]
    if missing:
        problems.append(f"large modes never launched on the main path: {missing}")
    log(f"[large sheath] the large modes' launches on the main paths: {res['launches']}")
    if problems:
        raise AssertionError("large grids, sheath and deposits: " + "; ".join(problems))
    return res

def main() -> int:
    walls = {}

    def phase(label, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        walls[label] = time.perf_counter() - t0
        log(f"[wall] {label}: {walls[label]:.1f} s")
        return out

    name, card = phase("device", phase_device)
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
    ck = phase("carried kernels", phase_carried_kernels, dev)
    cc = phase("carried check", phase_carried_check, dev, dc)
    cs = phase("carried slice", phase_carried_slice, dev, ms, ds)
    bc = phase("bca check", phase_bca_check, dev)
    bs = phase("bca slice", phase_bca_slice, dev)
    ckp = phase("checkpoint", phase_checkpoint, dev, bs)
    dep = phase("deposit times", deposit_times, dev, ms.pop("iead_traffic"))
    cli = phase("cli", phase_cli, dev, card)
    dpp = phase("data parallel", phase_data_parallel, dev, card)
    slb = phase("slab bounded", phase_slab_bounded, dev, shs)
    opt = phase("options", phase_options, dev, card)
    lg = phase("large grids", phase_large_grids, dev)
    lgs = phase("large sheath", phase_large_sheath, dev)

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
    launches["boris_gather_push_deposit"] = (
        cs["magnetized"]["launches"]["boris_gather_push_deposit"])
    launches["explicit_domain_cycle"] = (
        cs["carrier"]["launches"]["explicit_domain_cycle"])
    # the large Newton paths: phase 39's runs (ng 16,384 and the D-N row)
    for kname in ("boltzmann_dirichlet_large", "boltzmann_dn_large"):
        launches[kname] = lg["launches"][kname]
    helper = dnk.pop("philox_uniforms")
    # rows 4, 7, 9 and 20 read deposit_times' median at their main shapes
    # (row 4: the headline's set-up, the path whose launches it counts;
    # deposit_det: the composed sheath current), their other shapes beside
    records = {**k, **ek, **ik, **mk, **shk, **dnk, **dk, **ck}
    # the large paths' records at the shape phase 39 gives them, every
    # shape of phase 24 beside it
    for kname, by_rows in lim["newton_large"].items():
        records[kname] = dict(by_rows[LARGE_MAIN[kname]], shapes=by_rows)
    chain_large = lim["chain_large"]
    # the large modes of rows 4 (deposit_det), 7, 9 and 10: phase 40's
    # record at LARGE_KERNEL_MAIN with its other shapes, and the launches
    # of its main paths
    for kname, by_shape in lgs["kernels"].items():
        records[kname]["large_mode"] = dict(
            by_shape[LARGE_KERNEL_MAIN], launches=lgs["launches"][kname],
            shapes=by_shape)
    main_shape = {"deposit2": "configs[3]", "boris_gather_push_deposit": "configs[3]",
                  "deposit": DEPOSIT_MAIN_SHAPE, "deposit_det": "current",
                  "source_batch": "999,996"}
    for kname, by_shape in dep.items():
        top = by_shape[main_shape[kname]]
        records[kname].update(ms=top["ms"], ms_calls=top["ms_calls"], shapes=by_shape)
        if kname == "source_batch":
            records[kname].update(library_ms=top["library_ms"],
                                  issue_bound_ms=top["issue_bound_ms"],
                                  own_sass_ms=top["own_sass_ms"])
    sources = {kname: "pypic_tpu_torch/csrc/cic.cu" for kname in k}
    sources.update({kname: "pypic_tpu_torch/csrc/explicit.cu" for kname in ek})
    sources.update(picard_finalize="pypic_tpu_torch/csrc/cic.cu",
                   picard_iteration_shared="pypic_tpu_torch/csrc/cic.cu",
                   implicit_resident="pypic_tpu_torch/csrc/implicit.cu",
                   boltzmann_dn="pypic_tpu_torch/csrc/newton.cu",
                   boltzmann_dirichlet_large="pypic_tpu_torch/csrc/newton.cu",
                   boltzmann_dn_large="pypic_tpu_torch/csrc/newton.cu",
                   **{kname: "pypic_tpu_torch/csrc/domain.cu" for kname in dk},
                   **SOURCES_MAGNETIZED, **SOURCES_SHEATH, **SOURCES_CARRIED)
    log(f"[wall] total {sum(walls.values()):.1f} s")
    print(json.dumps({"kernels": [
        {"name": kname, "route": "cuda", "source": sources[kname],
         "replaces": REPLACES[kname], "launches": launches[kname],
         # the pic_bca_aps path's launches (the bca slice's driver run)
         **({"launches_pic_bca_aps": bs[1]["launches"][kname]}
            if bs[1]["launches"].get(kname) else {}),
         # phase 38's paths: the options (tools/options.py)
         **({"launches_options": opt["launches"][kname]}
            if opt["launches"].get(kname) else {}),
         "max_abs_err": records[kname]["max_abs_err"],
         "ms": records[kname]["ms"], "plain_ms": records[kname]["plain_ms"],
         "bound_ms": records[kname]["bound_ms"],
         "bound_by": records[kname]["bound_by"],
         "library_ms": records[kname].get("library_ms"),
         "n": records[kname]["n"],
         **{key: records[kname][key] for key in (
            "ms_calls", "row_mix", "passes", "us_per_pass", "us_per_step",
            "at_max_n", "iterations", "us_per_iteration", "long_solve", "shapes",
            "issue_bound_ms", "own_sass_ms", "marginal_us_per_iteration",
            "fixed_us", "k", "threads", "large_mode")
            if key in records[kname]}}
        for kname in REPLACES
    ], "helper_kernels": [
        # the flux and gyro-phase uniforms: no TPU kernel draws them (the
        # JAX engine takes them from jax.random)
        {"name": "philox_uniforms", "route": "cuda",
         "source": "pypic_tpu_torch/csrc/rng.cu", "replaces": None,
         "launches": dns["launches"]["philox_uniforms"],
         "launches_pic_bca_aps": bs[1]["launches"]["philox_uniforms"],
         **{key: helper[key] for key in ("max_abs_err", "ms", "plain_ms",
                                         "bound_ms", "bound_by", "n")},
         "library_ms": helper["library_ms"]},
        # the hash sampler's draws (data parallel): no TPU kernel draws them
        # (the JAX package's sources.hash_uniforms are XLA operations); the
        # launches of the one-rank dp runs of the magnetized and sheath rows
        {"name": "hash_batch", "route": "cuda",
         "source": "pypic_tpu_torch/csrc/rng.cu", "replaces": None,
         "launches": dpp["one_rank"]["magnetized"]["dp"]["launches_per_step"].get(
             "hash_batch", 0) * DP_STEPS["magnetized"],
         "launches_sheath": dpp["one_rank"]["sheath"]["dp"]["launches_per_step"].get(
             "hash_batch", 0) * DP_STEPS["sheath"],
         **{key: dpp["hash_batch"]["4x999996"][key] for key in (
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "n",
             "library_ms", "source_batch_ms")},
         "shapes": dpp["hash_batch"]},
        # the slab Newton's local chain solve: no TPU kernel (JAX's chain is
        # XLA operations); its launches are the pic_iead_dd run's
        {"name": "tridiag3_chain", "route": "cuda",
         "source": "pypic_tpu_torch/csrc/newton.cu", "replaces": None,
         "launches": slb["launches"]["tridiag3_chain"],
         **{key: slb["tridiag3_chain"][600][key] for key in (
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "n",
             "library_ms", "us_per_solve", "thomas_ms")},
         "shapes": slb["tridiag3_chain"]},
        # the same solve above 1,024 rows (the large path); its launches
        # are phase 39's distributed pic_iead_dd run's (c = 16,384)
        {"name": "tridiag3_chain_large", "route": "cuda",
         "source": "pypic_tpu_torch/csrc/newton.cu", "replaces": None,
         "launches": lg["launches"]["tridiag3_chain_large"],
         **{key: chain_large[LARGE_MAIN["tridiag3_chain_large"]][key] for key in (
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "n",
             "library_ms", "us_per_solve")},
         "shapes": chain_large}],
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
        "size_limits": {"fault_step": lim["fault_step"]},
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
        "carried_slice": {
            "magnetized": {
                **{key: cs["magnetized"][key] for key in (
                    "n", "steps", "us_per_step", "pushes_per_s", "newton_mean",
                    "phi_max_over_phi_f", "carried", "clamped_per_particle_step",
                    "carry_total_rel")},
                "no_carry_us_per_step": ms["us_per_step"]},
            "carrier": {
                **{key: cs["carrier"][key] for key in (
                    "n", "steps", "ms_per_step", "pushes_per_s",
                    "total_energy_rel_change", "cpu_total_energy_rel_change",
                    "n_dropped", "n_halo_clamped", "host_syncs_per_step", "halo",
                    "capacity", "peak_mem_gib")},
                "no_carry_ms_per_step": ds["explicit"]["ms_per_step"]},
            "check": cc},
        "bca_slice": {
            **{f"per_bca_{k}": {key: bs[k][key] for key in (
                "n", "capacity", "steps", "block_ms_per_step", "engine_ms_per_step",
                "surface_model_ms_per_step", "surface_model_share", "stats",
                "total_yield", "n_ionized", "n_escaped", "n_reactivated",
                "newton_mean", "newton_max")} for k in (1, 10)},
            "check": bc, "checkpoint": ckp},
        "cli": cli,
        "data_parallel": {k: v for k, v in dpp.items() if k != "hash_batch"},
        "slab_bounded": {k: v for k, v in slb.items()
                         if k not in ("tridiag3_chain", "launches")},
        "options": opt,
        "large_grids": {k: v for k, v in lg.items() if k != "launches"},
        "large_sheath": {k: v for k, v in lgs.items() if k not in ("launches", "kernels")},
        "walls_s": walls}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
