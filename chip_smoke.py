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
   and launches nothing: every particle kernel with a large mode (the
   thirteen rows of phase 41, deposit2, the carried Boris deposit,
   deposit_det and the sheath pass and finalize of phase 40) only above
   cuda_cic.LARGE_MAX_NG, naming it; explicit_cycle above its 14,511
   nodes of shared memory (its engine calls it at ng <= 1,024). The
   Newton family
   has none below 2^27 rows: boltzmann_dirichlet and boltzmann_dn on
   their large path (above 1,024 rows) at 1,025, 4,096, 16,384 and
   262,144 rows (8 iterations, tol 0), in float32 and float64, each in
   both its modes forced ('single', the one-CTA kernels, and 'cluster',
   the thread-block cluster; each against its own mode's plain version,
   one launch of the large path a call in that mode, equal iteration
   counts, the cluster mode's shared bytes as the kernel counts them;
   timed in float64 at 16,384; beside the mode 'single' at 16,384 and
   262,144 rows, and 16,384 in float64, its latency floor, the split's
   cut (c) of tools/resident_split.py, the PCR and barriers alone, us a
   further iteration), and tridiag3_chain at c = 1,025 and
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
   14's own position test printed. The configs[3] load at 16,384 and the
   D-N row at 8,000 again in each mode of the large Newton path in turns
   ('single', 'cluster', 'cluster', 'single'): ms/step, Newton iterations
   a step, steps at maxiter, the largest residual, every launch in the
   forced mode, the physics checks. The
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
   above its shared ceiling (1,761; 1,761; 1,816; 29,057; 19,370 nodes,
   the static shared bytes counted) and
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
41. large periodic — the slice's main paths past the periodic, explicit
   and slab kernels' shared-memory ceilings. The thirteen rows
   (picard_iteration and its shared window, both finalizes, deposit,
   gather, leapfrog_gather_push_deposit, boris_gather_push, the slab pass
   and both slab finalizes, the slab leapfrog push and
   explicit_domain_cycle) each in its global mode (the field read from
   device memory, every add a global float atomic; rows 1, 2, 14 and 17
   in the mode cuda_cic.cluster_launch names, with the global mode's
   record beside) at ng
   32,768 where its old ceiling lies below that and at 65,536 and 2^20,
   n = 1e7, against
   its plain version at its own kernel phase's checks and limits, timed
   (device_ms, the plain version, the bound in bytes of the rows and the
   nodes, index_add_ beside deposit and grid_sample beside gather), each
   shape's launches counted by mode. Then every kernel with a mode or a
   column count chosen by its launch shape, at the last node of each
   shape and the first of the next (mode_boundaries: the sweeps, the wide
   deposits, the sheath pass and finalize and deposit_det, against their
   plain versions). Then the paths, card against the
   CPU's plain route one step from one state, each quantity held to 2
   delta_s (delta_s: how far the CPU's own step moves when every position
   moves one float32 ulp; at these grids a step is that ill-conditioned)
   or to its ng = 200 limit where larger: the implicit headline physics
   at ng 32,768 and 65,536 (n = 100,007,936 timed, three windows of 2
   steps after one, and one step each of window_share 'shared' and
   converged-deposit; checked
   at n = 1e6, the options at 65,536); the explicit two-stream at 65,536
   fused and composed (n = 1e7 timed, checked at 1e6); configs[4],
   converged-deposit, the explicit carrier and the carried carrier at
   65,536 on one NCCL rank (n = 1e7, 5 steps each after one, timed), one
   step at n = 1e6
   on a group-less rank card against CPU and on two gloo ranks on the
   card against two on the CPU; the fused two-stream (row 14) and
   configs[4] on one NCCL rank and on two gloo ranks on the card (n =
   5e5, ext_n 41,273 a rank, 6 rows a node: row 17's pair mode) in
   MODE_TURNS: the global mode, the rule's, the rule's, the global mode,
   ms/step, the energy change (on two gloo ranks held to TURN_ENERGY_FACTOR
   times the global turns'), the Picard mean, n_dropped and each turn's
   launches by mode; in the cluster mode's range (n = 1e7, 180-360 rows
   a node) configs[4] on one NCCL rank at ng PERIODIC_CLUSTER_NGS (ext_n
   ~27,800, ~37,000, ~55,500; the shared window at 32,768) and the fused
   two-stream at 32,768, float32 in CLUSTER_TURNS (global, cluster, pair,
   pair, cluster, global) and float64 in CLUSTER_TURNS_F64 (its energy
   held to TURN_ENERGY_FACTOR times the global turns'), each turn's
   row 14 or 17 device ms a step from a profiled step; the
   configs[3] load at 65,536 fused (and
   phase 39's float64 check) and composed; the composed sheath loop at
   65,536 (n = 1e6, phase 40's checks). It fails if a row's large mode
   never launched on a path.
42. float64 — a float64 state on the double kernels of rows 1-6
   (picard_iteration and its shared window, both finalizes, deposit,
   gather). Each kernel on float64 inputs against its float64 plain
   version (positions within TOL64_POS cells, velocities and the gather
   within TOL64_V, deposits within 4 n eps64 of the largest node, clamp
   counts equal), then timed on the same inputs (device_ms, warm; the
   plain version once; the bound at twice the float32 bytes and the
   float64 rate; float64 index_add_ beside the deposit and grid_sample
   beside the gather): in the shared mode at the headline's ng = 200 and
   n = 6104 * 16384, and in the global mode at ng 65,536, n = 1e7 (rows 1
   and 2 also in their cluster mode at 32,768). Then the conserving headline
   physics in float64 at ng 200 and 65,536, n = 1e6: the fused step, the
   composed backend, window_share 'shared' and converged-deposit, three
   steps on the CPU's plain route from one state and one step on the card
   from each of the CPU's states, held at TOL64_STEP (rows that change
   cells left out of p and v, Fault 3), the Picard counts equal. Then the
   headline cell at n =
   6104 * 16384 in float32 and float64, ms/step in turns of windows. It
   fails if a double kernel never launched on its path (the headline's
   for the pass, the finalize and the set-up deposit; the ng = 200
   checks' for the shared window, converged-deposit and the gather), and
   unless a float64 state on the card raises a NotImplementedError naming
   it no gap in the implicit and explicit run_resident (the JAX engines'
   resident scans carry float32; the sheath engine and deposit_det, on
   phase 43's double kernels, the magnetized engine, on phase 44's, and
   the explicit engine, on phase 45's, must run it and stay float64).
43. sheath float64 — the sheath engine's float64 state on its double
   kernels (ROADMAP item 19a): the pass and the finalize (row 10),
   deposit_det, sheath_reinject (row 21) and hash_batch. Each against its
   float64 plain version on the inputs it is then timed on: the pass and
   finalize at the configs[2] shape (n = 1e6, ng 51), deposit_det there
   and at the exit histograms' 128 nodes, the three in their large mode
   (two-word fixed point) at the first node above each double ceiling
   (881, 881, 908), at 8,192 (n = 1e6) and at 65,536 (n = 1e7): outputs
   bit-equal, the small mode's current within 4 n eps64 of the largest
   node, the large mode's bit-equal to the int64 two-word plain twin and
   within 2 float64 ulps plus n 2^-(k+L+1) of math.fsum on sampled nodes,
   every current bit-equal over three calls (timed at the configs[2]
   shape and at 65,536); sheath_reinject at the
   row's mix and at 80/10/10, gamma 0 and 0.5 (positions and held rows
   bit-equal, velocities within TOL64_REINJECT_V); hash_batch at
   HASH_SHAPES (uniforms bit-equal, normals within 4 float64 ulps). Each
   timed (device_ms on rotating copies) beside the float32 kernel on the
   same inputs, the plain version, the bound (twice the float32 bytes,
   float64 operations at the float64 rate) and torch.rand in float64 for
   the draws. Then the configs[2] row in float64 (tools/sheath.py state,
   fused and composed, and fused on the hash sampler): SHEATH64_ROW_STEPS
   steps on the CPU's float64 route from the row's initial state, the
   card one step from each CPU state against the CPU's next one
   (statuses and Picard passes equal, SHEATH64_STEP limits), the launch
   counts from 0 just before those card steps; then phase 40's loads at
   ng 8,192 (fused, composed) and 65,536 (fused) in float64 and float32,
   SHEATH64_LARGE_STEPS steps each on the card: Picard passes a step and
   steps at maxiter in both dtypes, and one float64 step card against the
   CPU from the card's last state. It fails if a double kernel never
   launched on its path.
44. magnetized float64 — the magnetized engine's float64 state on its
   double kernels (ROADMAP item 19b): deposit2 (row 7), the fused push
   (row 8), the carried deposit (row 9) and the Newton solves (rows 22,
   23). Rows 7-9 on float64 rows against their float64 plain versions
   (the push bit-equal, the deposits within 4 n eps64 of the largest node,
   the carried deposit's clamps equal) at the configs[3] shape (n =
   999,996, ng 600) and in their large modes (n = 1e7, ng 65,536), each
   timed (device_ms, warm) beside its plain version, its bound (twice the
   float32 bytes) and, for deposit2, index_add_ of its 4 n terms (float64,
   and float32 beside the float32 kernel at configs[3]); the Newton
   kernels at the configs[3] row's (600) and the D-N row's (800) first
   solves from their float64 loads and on the large path at 1,025, 4,096
   and 16,384 rows (a first solve and 8 iterations at tol 0): iterations
   equal, phi within TOL64_NEWTON, timed by device time. Then the fused,
   composed, carried, D-N and GC routes at n = 12,000: steps on the CPU's
   float64 route (the Thomas Newton) from the row's load cast to float64,
   the card one step from each CPU state, the same draws: flags, counts
   and Newton iterations equal, p, v, phi and the carried rho and n at
   TOL64_MAG_STEP, only double kernels launched, no Thomas solve. Then
   the float64 rows on the card under sync debug mode 'error': the
   configs[3] row (1,200 steps; phi_max / phi_f in 0.6-1.4, the
   population kept, its checks), the carried, D-N and GC rows
   (MAG64_ROW_STEPS each). Then phase 39 and 40's configs[3] loads at ng
   16,384 and 65,536, float32 and float64 (each mode of the large Newton
   path forced) in turns: ms/step in windows, Newton iterations a step,
   and one step of each dtype from one state against a float64 step on
   the CPU (_step64; the float64 route held to phase 14's position
   limit); the D-N row at ng 8,000 in float64 in each mode in turns. It
   fails if a double kernel never launched on its path.
45. explicit float64 — the explicit engine's float64 state on its double
   kernels (ROADMAP item 19c): the one-kernel cycle (row 13) and the
   two-stage sweep (row 14, both modes). Each on float64 inputs against
   its float64 plain version (p1 within TOL64_POS cells, v1 within
   TOL64_V, rho1 within 4 n eps64 of the largest node, row 13's e1 within
   TOL64_SOLVE of the direct solve of its own rho1 and TOL64_SOLVE_PLAIN
   of the plain e1), then timed (device_ms, warm) beside the float32
   kernel on the same rows, the plain version and the bound (twice the
   float32 bytes, 16 B a node more in the large modes): row 13 at n =
   6104 * 16384, ng 200; row 14 there at ng 4,096 (shared mode) and at n
   = 1e7, ng 32,768 (cluster mode, C = 2) and 65,536 (global mode), each
   launch's mode checked (cuda_cic.cluster_launch). Then the
   engine's routes on the explicit two-stream at n = 1e6: fused at ng 200
   (row 13), 4,096, 32,768 and 65,536 (row 14 in its three modes),
   composed at 200
   (the double gather and deposit), three steps on the CPU's float64
   route and the card one step from each CPU state, held at TOL64_STEP
   (rho in j's place), only the route's double kernels launched. Then the
   explicit two-stream (phase 8's load, tools/two_stream.py) at n = 6104
   * 16384 in float32 and float64: ms/step in turns of windows, the total
   energy change under EXPLICIT_ENERGY_BOUND in both, no float kernel in
   the float64 run. It fails if a double kernel never launched on its
   path (the float64 two-stream's for row 13, the ng 4,096 route's for
   row 14, the ng 32,768 route's for its cluster mode).

Each phase prints its wall seconds. The line before the last is one JSON
object describing each kernel; the last line is {"ok": true, "device":
{...}}.
"""

from __future__ import annotations

import collections
import contextlib
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
from pypic_tpu_torch.ops.cuda_cic import F64_KERNELS
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
# and float64 operations/s outside the tensor cores, half the float32 rate
PEAK_F64_PER_S = 33.5e12
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
    # the large path's cluster mode (its own entry points)
    "boltzmann_dirichlet_cluster":
        "pypic_tpu/ops/pallas_newton.py:256 boltzmann_dirichlet_pallas",
    "boltzmann_dn_cluster": "pypic_tpu/ops/pallas_newton.py:213 boltzmann_dn_pallas",
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
          extra_bytes: float = 0.0, extra_ops: float = 0.0,
          f64: bool = False) -> tuple[float, str]:
    """The least time in ms the card could take for one call on n
    particles (``steps`` cycles for the resident kernels; for
    implicit_resident, ``passes`` Picard passes in all, as its rows
    report; for boltzmann_dirichlet, n rows of the Newton system and
    ``steps`` the Newton iterations the kernel reports): the larger of the
    bytes over the memory rate and the operations over the float32
    rate. ``extra_bytes`` and ``extra_ops`` carry the work that depends
    on the call's data (sheath_reinject's drawing rows). ``f64``: a
    double kernel (a float64 state), twice the bytes a row and the
    operations at the float64 rate."""
    row_bytes = BYTES_PER_PARTICLE[name] * (2 if f64 else 1)
    by_bytes = (row_bytes * n + extra_bytes) / PEAK_BYTES_PER_S * 1e3
    ops = OPS_PER_PARTICLE[name] * n * (steps if passes is None else passes) + extra_ops
    if name == "implicit_resident":
        ops += RESIDENT_FINAL_OPS * n * steps
    by_ops = ops / (PEAK_F64_PER_S if f64 else PEAK_F32_PER_S) * 1e3
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


def _trace_durations(prof) -> dict:
    """{name: [µs, ...]} of the kernels, memsets and copies in a
    torch.profiler trace."""
    import os
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    durs = collections.defaultdict(list)
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memset", "gpu_memcpy"):
            durs[e["name"]].append(e["dur"])
    return durs


def _step_device_ms(step, st, words, steps: int = 3) -> tuple:
    """``steps`` steps of ``step`` from state ``st`` under torch.profiler:
    (the state, the device ms a step of every kernel, memset and copy, the
    ms a step of those whose name holds one of ``words``), each kernel
    counted as ``device_ms`` counts it (its mean duration times its
    launches a step: a trace can drop launches)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            st, _ = step(st)
        torch.cuda.synchronize()
    per = {name: statistics.fmean(d) * max(1, round(len(d) / steps)) / 1e3
           for name, d in _trace_durations(prof).items()}
    mine = sum(ms for name, ms in per.items() if any(w in name for w in words))
    return st, sum(per.values()), mine


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
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        durs = _trace_durations(prof)
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
    from pypic_tpu_torch.ops import _build, cuda_cic
    from pypic_tpu_torch.tools import resident_split as rs

    t0 = time.perf_counter()
    # phase 24's latency floor library compiles beside the package's
    floor = rs.start_newton_floor_build()
    _, info = _build.load()
    _NEWTON_FLOOR_LIB["cut (c)"] = rs.newton_floor_library(floor)
    log(f"[build] {info.path.name} built in {info.seconds:.2f} s "
        f"(load {time.perf_counter() - t0:.2f} s)")
    for line in info.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"[build] {line.strip()}")
    # every launch shape counts its kernel's static shared bytes: a kernel
    # with more than its table says would fail at its last shared node
    bad = cuda_cic.check_static_smem(info.log)
    if bad:
        raise AssertionError("static shared memory above the launch tables': "
                             + "; ".join(bad))
    log(f"[build] static shared bytes of {len(cuda_cic.STATIC_SMEM_KERNELS)} kernel "
        "families within their launch tables")
    bad = cuda_cic.check_f64_kernels(info.log)
    if bad:
        raise AssertionError("float64 kernels not built: " + "; ".join(bad))
    log(f"[build] the double instantiations of {len(cuda_cic.F64_INSTANCES)} float64 "
        "kernel templates are in the report")


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


# set by mode_boundaries: its many cases log only what fails
_QUIET_CHECKS = False


def _check(errors: dict, name: str) -> float:
    bad = {k: v for k, v in errors.items() if not v["err"] <= v["tol"]}
    for k, v in errors.items():
        if _QUIET_CHECKS and k not in bad:
            continue
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


def _newton_large_solve(name: str, rows: int, dev, dtype=torch.float32):
    """(solve, plain): the large path's wrapper and its plain version on
    phase 24's load at ``rows`` in ``dtype``, each taking the tol and
    maxiter keywords. D-D: rho = e n, n0 = 1e17, cold start; D-N: n, n0 =
    0.9e17, warm start 0."""
    import numpy as np

    from pypic_tpu_torch.constants import E_CHARGE
    from pypic_tpu_torch.ops import cuda_newton

    rng = np.random.default_rng(11 + rows)
    dens = (1e17 * (1.0 + 0.3 * rng.standard_normal(rows))).clip(1e15)
    npdt = np.float64 if dtype == torch.float64 else np.float32
    te, dx = 11600.0 * 10.0, 2e-5
    if name == "boltzmann_dirichlet_large":
        rho = torch.from_numpy((E_CHARGE * dens).astype(npdt)).to(dev)

        def solve(fn, **kw):
            return fn(rho, 1e17, te, dx, **kw)

        return (functools.partial(solve, cuda_newton.boltzmann_dirichlet),
                functools.partial(solve, cuda_newton.boltzmann_dirichlet_plain))
    n = torch.from_numpy(dens.astype(npdt)).to(dev)
    phi0 = torch.zeros(rows, dtype=dtype, device=dev)

    def solve_dn(fn, **kw):
        return fn(n, 0.9e17, te, dx, phi0, **kw)

    return (functools.partial(solve_dn, cuda_newton.boltzmann_dn),
            functools.partial(solve_dn, cuda_newton.boltzmann_dn_plain))


def _newton_modes() -> dict:
    """The Newton large path's launches by mode since the last reset
    (cuda_cic.LARGE_LAUNCHES' "boltzmann_... mode" counts)."""
    from pypic_tpu_torch.ops import cuda_cic as K

    return {k: v for k, v in K.LARGE_LAUNCHES.items() if k.startswith("boltzmann_")}


@contextlib.contextmanager
def _forced_newton_mode(mode: str):
    """The Newton solves' large path in ``mode`` ('single' or 'cluster')
    whatever cuda_newton's rule takes (large_shape's shape for that mode,
    the rule's CTAs a cluster); a caller that names its mode (the chain:
    'single') keeps it."""
    from pypic_tpu_torch.ops import cuda_newton

    real = cuda_newton.large_shape

    def forced(rows, item=4, mode_=None, cluster=None, threads=None, dn=True):
        return real(rows, item, mode if mode_ is None else mode_, cluster, threads, dn)

    cuda_newton.large_shape = forced
    try:
        yield
    finally:
        cuda_newton.large_shape = real


# phase 24's forced pairs: each mode of the large path at NEWTON_LARGE_ROWS
# in both dtypes (the modes' order alternating from one row count to the
# next), each against its own mode's plain version; timed at
# NEWTON_LARGE_TIMED and the main shape (float64 at NEWTON_LARGE_TIMED_F64)
NEWTON_LARGE_MODES = ("single", "cluster")
NEWTON_LARGE_TIMED_F64 = (16_384,)
# the one-CTA mode's latency floor (tools/resident_split.py cut (c), the
# PCR and barriers alone) beside its forced pairs at these rows (float64
# at NEWTON_LARGE_TIMED_F64); its library is built in phase_build
NEWTON_FLOOR_ROWS = (16_384, 262_144)
_NEWTON_FLOOR_LIB = {}


def _newton_large_case(name: str, rows: int, dtype, mode: str, timed: bool, dev) -> dict:
    """One forced mode of the large path ``name`` at ``rows`` in ``dtype``
    against that mode's plain version: one launch of the large path a call
    in that mode (none of the small path), equal iteration counts, phi
    within TOL_CHAIN of the largest |phi|; ``timed``: the 8- and
    64-iteration solves' device time, the marginal us a further
    iteration, the plain version's ms and the bound. The cluster mode's
    shared bytes are checked against the kernel's own count
    (pypic_newton_cluster_smem)."""
    from pypic_tpu_torch.ops import _build
    from pypic_tpu_torch.ops import cuda_cic as K
    from pypic_tpu_torch.ops import cuda_newton

    small = name[:-len("_large")]
    f64 = dtype == torch.float64
    key = name + ("_f64" if f64 else "")
    item = 8 if f64 else 4
    shape = cuda_newton.large_shape(rows, item, mode, dn=small == "boltzmann_dn")
    if mode == "cluster":
        got_smem = _build.library().pypic_newton_cluster_smem(
            int(small == "boltzmann_dn"), int(f64), shape.cluster, shape.threads, shape.k,
            int(shape.shared))
        if got_smem != shape.smem:
            raise AssertionError(f"{key} {shape}: the kernel counts {got_smem} B of "
                                 f"shared memory, cluster_smem {shape.smem}")
    solve, plain = _newton_large_solve(name, rows, dev, dtype)
    with _forced_newton_mode(mode):
        K.reset_launch_counts()
        got = solve(**LARGE_SOLVE)
        torch.cuda.synchronize()
        launched = _newton_modes()
        if (K.LAUNCHES[key] != 1 or launched != {f"{key} {mode}": 1}
                or K.LAUNCHES[small + ("_f64" if f64 else "")]):
            raise AssertionError(f"{key} at {rows} rows, {mode}: launches "
                                 f"{ {k: v for k, v in K.LAUNCHES.items() if v} }, {launched}")
        ref = plain(**LARGE_SOLVE)
        err, rel = rel_err(ref.phi, got.phi)
        its = (int(got.iterations), int(ref.iterations))
        log(f"[size limits] {key} at {rows} rows, {mode} (C = {shape.cluster}, "
            f"{shape.threads} threads, k = {shape.k}, shared {shape.shared}), {its[0]} "
            f"iterations (plain {its[1]}): max |err| {err:.3e}, {rel:.3e} of max |phi| "
            f"(tol {TOL_CHAIN})")
        if not (rel <= TOL_CHAIN and its[0] == its[1] == LARGE_SOLVE["maxiter"]
                and bool(torch.isfinite(got.phi).all())):
            raise AssertionError(f"{key} at {rows} rows, {mode}: {rel} of max |phi|, "
                                 f"iterations {its}")
        rec = dict(n=rows, mode=mode, cluster=shape.cluster, k=shape.k,
                   threads=shape.threads, smem=shape.smem, shared=shape.shared,
                   max_abs_err=err, rel_err=rel)
        if timed:
            iters = LARGE_SOLVE["maxiter"]
            long_iters = LARGE_SOLVE_LONG["maxiter"]
            ms = device_ms(lambda: solve(**LARGE_SOLVE), calls=10)
            long_ms = device_ms(lambda: solve(**LARGE_SOLVE_LONG), calls=5)
            marginal = (long_ms - ms) / (long_iters - iters)
            plain_ms = cuda_ms(lambda: plain(**LARGE_SOLVE), reps=3, calls=1)
            b, by = bound(small, rows, iters, f64=f64)
            rec.update(ms=ms, iterations=iters, us_per_iteration=ms * 1e3 / iters,
                       marginal_us_per_iteration=marginal * 1e3,
                       fixed_us=(ms - iters * marginal) * 1e3,
                       long_solve=dict(iterations=long_iters, ms=long_ms),
                       plain_ms=plain_ms, bound_ms=b, bound_by=by, library_ms=None)
            log(f"[size limits] {key} at {rows} rows, {mode}: {ms:.4f} ms for {iters} "
                f"iterations ({ms * 1e3 / iters:.2f} us an iteration; long solve "
                f"{long_ms:.4f} ms for {long_iters}: {marginal * 1e3:.2f} us a "
                f"further iteration, fixed {rec['fixed_us']:.2f} us), plain "
                f"{plain_ms:.3f} ms, bound {b:.2e} ms ({by}); no library call "
                "solves a tridiagonal system")
    del solve, plain, got, ref
    return rec


def newton_large_times(dev) -> dict:
    """boltzmann_dirichlet and boltzmann_dn on their large path at
    NEWTON_LARGE_ROWS and the main path's shape, in float32 and float64,
    each mode of NEWTON_LARGE_MODES forced (_newton_large_case: LARGE_SOLVE
    iterations against that mode's plain version; timed at
    NEWTON_LARGE_TIMED and the main shape, float64 at
    NEWTON_LARGE_TIMED_F64). Returns {name: {rows: record}}: the record of
    the mode the rule takes, every mode's beside it ("modes"), the float64
    forced pairs under "float64"; at NEWTON_FLOOR_ROWS (float64:
    NEWTON_LARGE_TIMED_F64) the mode 'single''s record carries its latency
    floor, us a further iteration of the split's cut (c)
    ("latency_floor_us")."""
    from pypic_tpu_torch.ops import _build
    from pypic_tpu_torch.ops import cuda_newton
    from pypic_tpu_torch.tools import resident_split as rs

    # the cluster kernels' static shared memory, as large_shape counts it
    static = {k: v for k, v in _build.static_smem(_build.load()[1].log).items()
              if k[0] == "newton_cluster_kernel"}
    log(f"[size limits] the cluster kernels' static shared bytes {static}")
    if len(static) != 8 or set(static.values()) != {cuda_newton.CLUSTER_STATIC_BYTES}:
        raise AssertionError(f"the cluster kernels' static shared bytes {static}, not "
                             f"{cuda_newton.CLUSTER_STATIC_BYTES} for each of 8")
    out = {}
    for name in ("boltzmann_dirichlet_large", "boltzmann_dn_large"):
        out[name] = {}
        for dtype in (torch.float32, torch.float64):
            f64 = dtype == torch.float64
            item = 8 if f64 else 4
            timed_rows = (NEWTON_LARGE_TIMED_F64 if f64 else
                          tuple(NEWTON_LARGE_TIMED) + (LARGE_MAIN[name],))
            for i, rows in enumerate(sorted(set(NEWTON_LARGE_ROWS) | {LARGE_MAIN[name]})):
                modes = NEWTON_LARGE_MODES[::1 if i % 2 == 0 else -1]
                by_mode = {mode: _newton_large_case(name, rows, dtype, mode,
                                                    rows in timed_rows, dev)
                           for mode in modes}
                torch.cuda.empty_cache()
                rule = cuda_newton.large_mode(rows, item)
                if f64:  # after float32's record at these rows
                    out[name][rows]["float64"] = dict(by_mode[rule], modes=by_mode)
                else:
                    out[name][rows] = dict(by_mode[rule], modes=by_mode)
                if "ms" in by_mode["single"]:
                    log(f"[size limits] {name}{'_f64' if f64 else ''} at {rows} rows: us a "
                        "further iteration " + ", ".join(
                            f"{m} {r['marginal_us_per_iteration']:.2f}"
                            for m, r in by_mode.items()) + f"; the rule takes {rule}")
    cases = [(name == "boltzmann_dn_large", rows, dtype)
             for name in out for dtype, rows_of in ((torch.float32, NEWTON_FLOOR_ROWS),
                                                    (torch.float64, NEWTON_LARGE_TIMED_F64))
             for rows in rows_of]
    floors = rs.newton_floor_us(_NEWTON_FLOOR_LIB["cut (c)"], cases, dev)
    for (dn, rows, dtype), us in floors.items():
        name = "boltzmann_dn_large" if dn else "boltzmann_dirichlet_large"
        rec = out[name][rows]
        rec = rec["float64"] if dtype == torch.float64 else rec
        rec["modes"]["single"]["latency_floor_us"] = us
        log(f"[size limits] {name}{'_f64' if dtype == torch.float64 else ''} at {rows} "
            f"rows: the one-CTA latency floor (split cut (c), the PCR and barriers alone) "
            f"{us:.2f} us a further iteration; single "
            f"{rec['modes']['single']['marginal_us_per_iteration']:.2f}, cluster "
            f"{rec['modes']['cluster']['marginal_us_per_iteration']:.2f}")
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

    from pypic_tpu_torch.ops import cuda_domain as KD

    z = lambda k: torch.zeros(k, dtype=torch.float32, device=dev)  # noqa: E731
    p = z(64)
    kw = dict(qm=-1.7e11, w=-3.2e-9, dt=1e-7, dx=0.05)
    # every particle kernel with a large mode raises only above
    # LARGE_MAX_NG; explicit_cycle keeps its shared-memory ceiling (its
    # engine calls it at ng <= 1,024)
    top = K.LARGE_MAX_NG + 1
    f = z(top)
    cycle = (K.SMEM_LIMIT - K._CYCLE_EXTRA - K.STATIC_INT_BYTES) // (4 * K._CYCLE_ARRAYS) + 1
    slab = dict(qm=-1.7e11, dt=1e-7, dx=0.05, lo=2.0, hi=float(top - 3))
    calls = {
        "explicit_cycle": lambda: K.explicit_cycle(z(cycle), p, p, cycle, **kw),
        "picard_iteration": lambda: K.picard_iteration(f, p, p, p, top, **kw),
        "picard_iteration_shared": lambda: K.picard_iteration_shared(f, p, p, p, top, **kw),
        "picard_finalize_nodep": lambda: K.picard_finalize_nodep(
            f, p, p, p, top, qm=-1.7e11, dt=1e-7, dx=0.05),
        "picard_finalize": lambda: K.picard_finalize(f, p, p, p, top, **kw),
        "deposit": lambda: K.deposit(p, p, top, periodic=True),
        "gather": lambda: K.gather(f, p, periodic=False),
        "leapfrog_gather_push_deposit": lambda: K.leapfrog_gather_push_deposit(f, p, p, **kw),
        "boris_gather_push": lambda: K.boris_gather_push(
            f, p, p, p, p, p, p, b=(0.0, 1.0, 0.0), dt_dx=1.0),
        "picard_iteration_ext": lambda: KD.picard_iteration_ext(f, p, p, p, p, **slab),
        "picard_finalize_ext": lambda: KD.picard_finalize_ext(
            f, p, p, p, p, lo_shift=0.0, ng=0, **slab),
        "picard_finalize_ext_nodep": lambda: KD.picard_finalize_ext_nodep(
            f, p, p, p, p, lo_shift=0.0, ng=0, **slab),
        "leapfrog_gather_push": lambda: KD.leapfrog_gather_push(
            f, p, p, qm=-1.7e11, dt=1e-7, dx=0.05),
        "explicit_domain_cycle": lambda: KD.explicit_domain_cycle(
            f, p, p, p, qm=-1.7e11, dt=1e-7, dx=0.05, lo_shifted=0.0, ext_n=64),
        "deposit2": lambda: K.deposit2(p, p, p, top, periodic=False),
        "boris_gather_push_deposit": lambda: K.boris_gather_push_deposit(
            f, p, p, p, p, p, p, p, p, b=(0.0, 1.0, 0.0), dt_dx=1.0),
        "deposit_det": lambda: K.deposit_det(p, p, top, periodic=False),
        "sheath_picard": lambda: cuda_sheath.sheath_picard(
            f, p, p, p, p, p, p, dt=1e-12, dx=1e-5),
        "sheath_finalize": lambda: cuda_sheath.sheath_finalize(
            f, p, p, p, p, p, p, dt=1e-12, dx=1e-5),
    }
    K.reset_launch_counts()
    for name, call in calls.items():
        try:
            call()
        except ValueError as e:
            log(f"[size limits] {name} on the card raises: {str(e)[:110]}")
            want = "shared memory" if name == "explicit_cycle" else "LARGE_MAX_NG"
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


def hash_bound(n: int, streams: int, normals: bool, item: int = 4) -> tuple[float, str]:
    """The least time in ms for one hash_batch call: the (streams, n)
    outputs written once over the memory rate, against the integer work
    at the integer rate and the Box-Muller work at the float32 rate (with
    ``item`` 8, float64 outputs and the Box-Muller work at the float64
    rate)."""
    by_bytes = float(item) * streams * n / PEAK_BYTES_PER_S * 1e3
    peak = PEAK_F64_PER_S if item == 8 else PEAK_F32_PER_S
    by_ops = (HASH_INT_OPS * streams * n / PEAK_INT32_PER_S
              + (HASH_PAIR_OPS * streams // 2 * n / peak
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


def _large_position_check(c, g, r, d, cells: float,
                          held=("p", "cpu_to_f64", "card_to_f64")):
    """The positions of one step on the CPU (c), the card (g) and in
    float64 (r, _step64) from the state ``d``: the card against the CPU
    over the active particles, and each float32 side against r over the
    pushed ones (active before the step and after it on both sides, r
    inside the walls), at phase 14's limits with |p| the larger of start
    and end for a pushed particle (its end alone for a re-activated one);
    phase 14's own test (|p| the end) beside them, and its worst
    particles. Returns (figures, problems): each figure of ``held`` above
    1 is a problem, the others are figures alone."""
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
    problems = [f"{k} {out[k]:.3e}" for k in held if not out[k] <= 1.0]
    return out, problems


def _large_grid_check(kind: str, ng: int, dev, steps: int = LARGE_CHECK_STEPS,
                      calibrated: bool = False) -> dict:
    """``steps`` steps of the row on the card, each held against
    one step on the CPU (backend 'fused', newton_backend 'pallas': the
    plain versions) and one in float64 (_step64) from the same state: the
    preset's, then the card's state after each step. The source draws are
    the Philox kernel's and its plain version's (bit-equal); the D-N flux
    draws are made on the CPU and replayed on both sides (phase 20).
    Raises on a gap in rho, phi or v above phase 14's limits, on unequal
    n_active / n_reactivated, and on the positions' tests
    (_large_position_check). With ``calibrated`` the card's positions
    against the CPU's are a figure, and the card is held to the float64
    step at PERIODIC_CALIBRATED times the CPU's own gap to it (or at 1
    where that is larger)."""
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
        if calibrated:
            # the CPU held to the float64 step; the card to it at
            # PERIODIC_CALIBRATED times the CPU's own gap (the plain
            # route's float32 error at this grid) or at 1 where larger
            p_rec, p_bad = _large_position_check(c, g, r, d, cells, held=("cpu_to_f64",))
            p_rec["card_limit"] = max(1.0, PERIODIC_CALIBRATED * p_rec["cpu_to_f64"])
            if not p_rec["card_to_f64"] <= p_rec["card_limit"]:
                p_bad.append(f"card_to_f64 {p_rec['card_to_f64']:.3e} above "
                             f"{p_rec['card_limit']:.3e}")
        else:
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


# phase 39's loads on both modes of the Newton large path in turns: the
# parent's one-CTA mode 'single', the cluster mode, the cluster mode,
# 'single' (_forced_newton_mode), each LARGE_GRID_STEPS steps after
# LARGE_GRID_WARMUP through tools/magnetized.run_row
LARGE_MODE_TURNS = ("single", "cluster", "cluster", "single")
LARGE_MODE_RUNS = ("pic_iead ng 16384", "dn ng 8000")


def _newton_mode_turns(dev) -> tuple[dict, list]:
    """The LARGE_MODE_RUNS loads in each mode of LARGE_MODE_TURNS: ms/step,
    Newton iterations a step (mean, max), steps at maxiter, the largest
    residual, each step's launches of the large path all in the forced
    mode, and the phase's physics checks (the configs[3] load's population
    invariant and phi_max / phi_f, the D-N row's flux cap and its wall
    and far-end phi; finite phi and positions). Returns ({label: [run
    records]}, problems)."""
    from pypic_tpu_torch.engines import magnetized
    from pypic_tpu_torch.ops import cuda_cic as K
    from pypic_tpu_torch.tools import magnetized as row

    out, problems = {}, []
    newton = {"iead": "boltzmann_dirichlet_large", "dn": "boltzmann_dn_large"}
    for label in LARGE_MODE_RUNS:
        kind, ng = LARGE_GRID_RUNS[label]
        name = newton[kind]
        out[label] = []
        for mode in LARGE_MODE_TURNS:
            with _forced_newton_mode(mode):
                res, cfg, fin, m = row.run_row(
                    dev, steps=LARGE_GRID_STEPS, warmup=LARGE_GRID_WARMUP, row=kind,
                    n_per_species=LARGE_GRID_N_PER_SPECIES, n=LARGE_GRID_DN_N, ng=ng)
            launched = _newton_modes()
            its, resid = m.newton_iters.cpu(), m.newton_residual.cpu()
            maxiter = cfg.newton_maxiter if kind == "iead" else magnetized.DN_MAXITER
            rec = dict(mode=mode, n=res["n"], ng=ng, steps=LARGE_GRID_STEPS,
                       ms_per_step=res["us_per_step"] / 1e3,
                       newton_mean=float(its.float().mean()), newton_max=int(its.max()),
                       steps_at_maxiter=int((its >= maxiter).sum()),
                       residual_max=float(resid.max()), launches_by_mode=launched)
            if kind == "iead":
                rec["phi_max_over_phi_f"] = res["phi_max_over_phi_f"]
                bad = row.population_problems(m)
            else:
                bad = ([f"flux cap {res['react_max']}"]
                       if res["react_max"] > cfg.flux_limit else [])
                rec.update(phi_wall=res["phi_wall"], phi_far=res["phi_far"])
            if not (bool(torch.isfinite(m.phi).all()) and bool(torch.isfinite(fin.p).all())):
                bad.append("non-finite phi or positions")
            if launched != {f"{name} {mode}": LARGE_GRID_STEPS}:
                bad.append(f"launches of the large path {launched}, not {LARGE_GRID_STEPS} "
                           f"in the mode {mode}")
            log(f"[large grids] {label} in the mode {mode}: {rec['ms_per_step']:.3f} ms/step, "
                f"Newton iterations a step mean {rec['newton_mean']:.2f}, max "
                f"{rec['newton_max']} ({rec['steps_at_maxiter']} steps at maxiter), largest "
                f"residual {rec['residual_max']:.3e}"
                + (f", phi_max / phi_f {rec['phi_max_over_phi_f']:.4f}" if kind == "iead" else
                   f", phi wall {rec['phi_wall']:.4e}, far {rec['phi_far']:.4e}")
                + f"; launches {launched}; problems {bad}")
            problems += [f"{label} {mode}: {b}" for b in bad]
            out[label].append(rec)
            del fin, m
            torch.cuda.empty_cache()
        ms = {mode: [r["ms_per_step"] for r in out[label] if r["mode"] == mode]
              for mode in NEWTON_LARGE_MODES}
        log(f"[large grids] {label}, the modes in turns {LARGE_MODE_TURNS}: ms/step "
            + "; ".join(f"{mode} " + ", ".join(f"{v:.3f}" for v in vals)
                        for mode, vals in ms.items()))
    return out, problems


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
        by_mode = dict(K.LARGE_LAUNCHES)
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
                   launches_by_mode=by_mode, host_syncs_per_step=0.0, thomas_solves=thomas)
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
            launches[f"{name}_cluster"] = by_mode.get(f"{name}_large cluster", 0)
        del fin, m
        torch.cuda.empty_cache()
        rec["check"] = _large_grid_check(kind, ng, dev)
        res["runs"][label] = rec
    res["mode_turns"], bad = _newton_mode_turns(dev)
    problems += bad

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
                  "deposit_det": 1816, "deposit2": 29_057,
                  "boris_gather_push_deposit": 19_370}
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


# phase 41, large periodic: the thirteen kernels of the periodic, explicit
# and slab engines past their shared-memory ceilings (cuda_cic.smem_mode's
# global mode: the field read from device memory, every add a global
# float atomic), each held against its plain version there, then the
# engines' paths at those grids, card against the CPU's plain route
# the rows, each with the device-memory bytes a node of one call beside
# the rows' (BYTES_PER_PARTICLE: the field read once and each (ng,) output
# written once) and whether its old ceiling lies below PERIODIC_MID_NG
# (a deposit beside the field in shared memory)
PERIODIC_LARGE_ROWS = {
    "picard_iteration": (8, True), "picard_iteration_shared": (8, True),
    "picard_finalize_nodep": (4, False), "picard_finalize": (8, True),
    "deposit": (4, False), "leapfrog_gather_push_deposit": (8, True),
    "gather": (4, False), "picard_iteration_ext": (8, True),
    "picard_finalize_ext": (8, True), "picard_finalize_ext_nodep": (4, False),
    "leapfrog_gather_push": (4, False), "explicit_domain_cycle": (8, True),
    "boris_gather_push": (4, False)}
# the shape of the rows whose old ceiling lies below it, then
# LARGE_KERNEL_NGS
PERIODIC_MID_NG = 32_768
PERIODIC_LARGE_N = 10_000_000
# the shape whose record stands for a row's large mode in the kernels line
PERIODIC_LARGE_MAIN = f"n {PERIODIC_LARGE_N}, ng 65536"
# the slab rows' halo (configs[4]'s at ng 200) and the extended slab's
# nodes beside its cells: ext_n = c + 2 (halo + 2) + 1
PERIODIC_SLAB_HALO = 13


def _slab_frame(ext_n: int) -> dict:
    """The clamp bounds and offsets of an extended slab of ext_n nodes
    (halo PERIODIC_SLAB_HALO, the rank of a middle slab of four)."""
    hw = PERIODIC_SLAB_HALO + 2
    c = ext_n - 2 * hw - 1
    return dict(lo=float(hw - PERIODIC_SLAB_HALO), hi=float(c + PERIODIC_SLAB_HALO + hw),
                lo_shift=float(c - hw), ng=4 * c)


def _periodic_large_case(name: str, n: int, ng: int, gen: torch.Generator, dev,
                         timed: bool = True) -> dict:
    """One of phase 41's kernels at (n, ng) against its plain version on
    the card, with the checks and limits of the row's own kernel phase:
    positions in cells (TOL_POS) or of the slab's ng (TOL_DOM), velocities
    relative (TOL_V, TOL_DOM), every deposit within TOL_DEP of a float64
    sum of the plain version's terms and deposit_tol of the plain float32
    sum, clamp counts equal, the slab statistics bit-equal from call to
    call and within TOL_DOM of the plain version's. With ``timed``,
    device_ms, the plain version's time, the bound (rows and nodes) and
    the library call where one exists (index_add_ for the deposit,
    grid_sample for the gather: its gap is printed, not held, because its
    normalized coordinates lose ng 2^-24 cells)."""
    from pypic_tpu_torch.ops import cuda_cic as K
    from pypic_tpu_torch.ops import cuda_domain as KD

    qm = float(torch.tensor(QM, dtype=torch.float32))
    errs, library, library_gap = {}, None, None
    f32 = torch.float32
    if name in ("picard_iteration", "picard_iteration_shared", "picard_finalize_nodep",
                "picard_finalize", "deposit", "gather", "leapfrog_gather_push_deposit",
                "leapfrog_gather_push"):
        e, ps, p0, v0 = _random_pass_inputs(n, gen, dev, False, ng)
    if name in ("picard_iteration", "picard_iteration_shared"):
        shared = name == "picard_iteration_shared"
        fn = K.picard_iteration_shared if shared else K.picard_iteration
        plain = K.picard_iteration_shared_plain if shared else K.picard_iteration_plain
        kw = dict(qm=QM, w=W, dt=DT, dx=DX)
        got = fn(e, ps, p0, v0, ng, emit_v=True, **kw)
        ref = plain(e, ps, p0, v0, ng, emit_v=True, **kw)
        a = seam_err(ref[0], got[0], ng)
        errs["ph"] = dict(abs=a, err=a, kind="cells", tol=TOL_POS)
        a, r = rel_err(ref[1], got[1])
        errs["v1"] = dict(abs=a, err=r, kind="rel", tol=TOL_V)
        if shared:
            exact = plain(e, ps, p0, v0, ng, emit_v=True, acc_dtype=torch.float64, **kw)[2]
            gap = float(abs(int(got[3]) - int(ref[3])))
            errs["n_clamped"] = dict(abs=gap, err=gap, kind=(
                f"count gap ({int(got[3])} clamped of {n})"), tol=0.0)
        else:
            w32 = K.kernel_scalars(QM, DT, DX, W)[3]
            exact = K.deposit_plain(ref[0].double(), (w32 * (0.5 * (v0 + ref[1]))).double(),
                                    ng, periodic=True)
        a, r = rel_err(exact, got[2])
        errs["jh"] = dict(abs=a, err=r, kind="rel vs float64", tol=TOL_DEP)
        a, r = rel_err(ref[2], got[2])
        errs["jh_plain"] = dict(abs=a, err=r, kind="rel", tol=deposit_tol(n, ng))
        call = lambda: fn(e, ps, p0, v0, ng, **kw)  # noqa: E731
        plain_call = lambda: plain(e, ps, p0, v0, ng, **kw)  # noqa: E731
    elif name in ("picard_finalize_nodep", "picard_finalize"):
        dep = name == "picard_finalize"
        fn = K.picard_finalize if dep else K.picard_finalize_nodep
        plain = K.picard_finalize_plain if dep else K.picard_finalize_nodep_plain
        kw = dict(qm=QM, dt=DT, dx=DX, **(dict(w=W) if dep else {}))
        got = fn(e, ps, p0, v0, ng, **kw)
        ref = plain(e, ps, p0, v0, ng, **kw)
        a = seam_err(ref[0], got[0], ng)
        errs["p1"] = dict(abs=a, err=a, kind="cells", tol=TOL_POS)
        a, r = rel_err(ref[1], got[1])
        errs["v1"] = dict(abs=a, err=r, kind="rel", tol=TOL_V)
        if dep:
            w32 = K.kernel_scalars(QM, DT, DX, W)[3]
            exact = K.deposit_plain(ref[0].double(), (w32 * ref[1]).double(), ng,
                                    periodic=True)
            a, r = rel_err(exact, got[2])
            errs["j1"] = dict(abs=a, err=r, kind="rel vs float64", tol=TOL_DEP)
            a, r = rel_err(ref[2], got[2])
            errs["j1_plain"] = dict(abs=a, err=r, kind="rel", tol=deposit_tol(n, ng))
        call = lambda: fn(e, ps, p0, v0, ng, **kw)  # noqa: E731
        plain_call = lambda: plain(e, ps, p0, v0, ng, **kw)  # noqa: E731
    elif name == "deposit":
        vals = v0 * W
        for periodic in (True, False):
            pos = p0 if periodic else p0 * ((ng - 1) / ng)
            got = K.deposit(pos, vals, ng, periodic=periodic)
            exact = K.deposit_plain(pos.double(), vals.double(), ng, periodic=periodic)
            a, r = rel_err(exact, got)
            errs[f"out periodic={periodic}"] = dict(abs=a, err=r, kind="rel vs float64",
                                                    tol=TOL_DEP)
            a, r = rel_err(K.deposit_plain(pos, vals, ng, periodic=periodic), got)
            errs[f"out_plain periodic={periodic}"] = dict(abs=a, err=r, kind="rel",
                                                          tol=deposit_tol(n, ng))
            del exact
        call = lambda: K.deposit(p0, vals, ng, periodic=True)  # noqa: E731
        plain_call = lambda: K.deposit_plain(p0, vals, ng, periodic=True)  # noqa: E731
        if timed:
            from pypic_tpu_torch.ops.cic import cic_indices_weights

            il, ir, wl, wr = cic_indices_weights(p0, ng, True)
            idx, terms = torch.cat([il, ir]), torch.cat([vals * wl, vals * wr])
            library = device_ms(lambda: torch.zeros(ng, device=dev).index_add_(
                0, idx, terms), calls=10)
            del il, ir, wl, wr
    elif name == "gather":
        for periodic in (True, False):
            pos = p0 if periodic else p0 * ((ng - 1) / ng)
            a, r = rel_err(K.gather_plain(e, pos, periodic=periodic),
                           K.gather(e, pos, periodic=periodic))
            errs[f"out periodic={periodic}"] = dict(abs=a, err=r, kind="rel", tol=2e-5)
        call = lambda: K.gather(e, p0, periodic=True)  # noqa: E731
        plain_call = lambda: K.gather_plain(e, p0, periodic=True)  # noqa: E731
        if timed:
            lib_call = _gather_library(e, p0, periodic=True)
            library_gap = rel_err(call(), lib_call())[1]
            library = device_ms(lib_call, calls=10)
            del lib_call
    elif name == "leapfrog_gather_push_deposit":
        kw = dict(qm=QM, w=W, dt=DT, dx=DX)
        got = K.leapfrog_gather_push_deposit(e, p0, v0, **kw)
        ref = K.leapfrog_gather_push_deposit_plain(e, p0, v0, **kw)
        errs.update(_lf_errors(ref, got, ng, K.leapfrog_scalars(QM, DT, DX, W)[2], n))
        call = lambda: K.leapfrog_gather_push_deposit(e, p0, v0, **kw)  # noqa: E731
        plain_call = lambda: K.leapfrog_gather_push_deposit_plain(e, p0, v0, **kw)  # noqa: E731
    elif name == "leapfrog_gather_push":
        kw = dict(qm=qm, dt=DT, dx=DX)
        got = KD.leapfrog_gather_push(e, p0, v0, **kw)
        ref = KD.leapfrog_gather_push_plain(e, p0, v0, **kw)
        a = seam_err(ref[0], got[0], ng)
        errs["p1"] = dict(abs=a, err=a / ng, kind="of ng", tol=TOL_DOM)
        a, r = rel_err(ref[1], got[1])
        errs["v1"] = dict(abs=a, err=r, kind="rel", tol=TOL_DOM)
        call = lambda: KD.leapfrog_gather_push(e, p0, v0, **kw)  # noqa: E731
        plain_call = lambda: KD.leapfrog_gather_push_plain(e, p0, v0, **kw)  # noqa: E731
    elif name in ("picard_iteration_ext", "picard_finalize_ext", "picard_finalize_ext_nodep"):
        fr = _slab_frame(ng)
        span = fr["hi"] - fr["lo"] + 6.0
        p0 = torch.rand(n, generator=gen, device=dev, dtype=f32) * span + (fr["lo"] - 3.0)
        ps = p0 + torch.randn(n, generator=gen, device=dev, dtype=f32) * 0.3
        v0 = torch.randn(n, generator=gen, device=dev, dtype=f32) * 1e5
        field = torch.randn(ng, generator=gen, device=dev, dtype=f32) * 30.0
        w = torch.full((n,), W, dtype=f32, device=dev)
        w[torch.rand(n, generator=gen, device=dev) < 0.05] = 0.0
        args = (field, ps, p0, v0, w)
        kw = dict(qm=qm, dt=DT, dx=DX, lo=fr["lo"], hi=fr["hi"])
        if name == "picard_iteration_ext":
            pkw = dict(kw, emit_v=True, shared=True)
            got = KD.picard_iteration_ext(*args, **pkw)
            ref = KD.picard_iteration_ext_plain(*args, **pkw)
            exact = KD.picard_iteration_ext_plain(*args, acc_dtype=torch.float64, **pkw)[2]
            a, r = rel_err(ref[0], got[0])
            errs["ph"] = dict(abs=a, err=r, kind="rel", tol=TOL_DOM)
            a, r = rel_err(ref[1], got[1])
            errs["v1"] = dict(abs=a, err=r, kind="rel", tol=TOL_DOM)
            a, r = rel_err(exact, got[2])
            errs["jh"] = dict(abs=a, err=r, kind="rel vs float64 sums", tol=TOL_DEP)
            a, r = rel_err(ref[2], got[2])
            errs["jh_plain"] = dict(abs=a, err=r, kind="rel", tol=deposit_tol(n, ng))
            gap = float(abs(int(got[3]) - int(ref[3])))
            errs["n_clamped"] = dict(abs=gap, err=gap, kind=(
                f"count gap ({int(got[3])} clamped of {n})"), tol=0.0)
            # the separate-window pass as configs[4] runs it, timed
            call = lambda: KD.picard_iteration_ext(*args, **kw)  # noqa: E731
            plain_call = lambda: KD.picard_iteration_ext_plain(*args, **kw)  # noqa: E731
            a, r = rel_err(plain_call()[1], call()[1])
            errs["jh separate"] = dict(abs=a, err=r, kind="rel", tol=deposit_tol(n, ng))
        else:
            dep = name == "picard_finalize_ext"
            fkw = dict(kw, lo_shift=fr["lo_shift"], ng=fr["ng"])
            fn = KD.picard_finalize_ext if dep else KD.picard_finalize_ext_nodep
            got = fn(*args, **fkw)
            if not torch.equal(got[-1], fn(*args, **fkw)[-1]):
                raise AssertionError(f"{name}: the statistics differ from call to call")
            ref = KD.picard_finalize_ext_plain(*args, deposit=dep, **fkw)
            a = seam_err(ref[0], got[0], fr["ng"])
            errs["p1"] = dict(abs=a, err=a / fr["ng"], kind="of ng", tol=TOL_DOM)
            a, r = rel_err(ref[1], got[1])
            errs["v1"] = dict(abs=a, err=r, kind="rel", tol=TOL_DOM)
            st, st_ref = got[-1].cpu(), ref[-1].cpu()
            for i, key in ((0, "sum w v1"), (1, "sum v1^2")):
                a, r = rel_err(st_ref[i:i + 1], st[i:i + 1])
                errs[key] = dict(abs=a, err=r, kind="rel", tol=TOL_DOM)
            diff = float(abs(st[2] - st_ref[2]))
            errs["clamps"] = dict(abs=diff, err=diff,
                                  kind=f"count gap ({int(st[2])} clamped)", tol=0.0)
            if dep:
                exact = KD.picard_finalize_ext_plain(*args, deposit=True,
                                                     acc_dtype=torch.float64, **fkw)[2]
                a, r = rel_err(exact, got[2])
                errs["j1"] = dict(abs=a, err=r, kind="rel vs float64 sums", tol=TOL_DEP)
                a, r = rel_err(ref[2], got[2])
                errs["j1_plain"] = dict(abs=a, err=r, kind="rel", tol=deposit_tol(n, ng))
            call = lambda: fn(*args, **fkw)  # noqa: E731
            plain_call = lambda: KD.picard_finalize_ext_plain(  # noqa: E731
                *args, deposit=dep, **fkw)
    elif name == "explicit_domain_cycle":
        # one rank's slab of the whole grid: ext_n = ng + 2 halo + 1
        ext_n = ng + 2 * PERIODIC_SLAB_HALO + 1
        p = torch.rand(n, generator=gen, device=dev, dtype=f32) * ng
        v = torch.randn(n, generator=gen, device=dev, dtype=f32) * (2.0 * DX / DT)
        w = torch.full((n,), W, dtype=f32, device=dev)
        dead = torch.rand(n, generator=gen, device=dev) < 0.05
        w[dead], p[dead], v[dead] = 0.0, 0.0, 0.0
        field = torch.randn(ng, generator=gen, device=dev, dtype=f32) * 30.0
        kw = dict(qm=qm, dt=DT, dx=DX, lo_shifted=-float(PERIODIC_SLAB_HALO), ext_n=ext_n)
        got = KD.explicit_domain_cycle(field, p, v, w, **kw)
        ref = KD.explicit_domain_cycle_plain(field, p, v, w, **kw)
        for k_, r_, g_ in zip(("p1", "v1"), ref, got):
            d_ = float((r_.double() - g_.double()).abs().max())
            errs[k_] = dict(abs=d_, err=d_, kind="bit-equal to the plain version", tol=0.0)
        exact = KD.explicit_domain_cycle_plain(field, p, v, w, acc_dtype=torch.float64, **kw)
        a, r = rel_err(exact[2], got[2])
        errs["rho_ext"] = dict(abs=a, err=r, kind="rel vs float64 sums", tol=TOL_DEP)
        a, r = rel_err(ref[2], got[2])
        errs["rho_ext_plain"] = dict(abs=a, err=r, kind="rel", tol=deposit_tol(n, ext_n))
        gap = float(abs(int(got[3]) - int(ref[3])))
        errs["n_clamped"] = dict(abs=gap, err=gap, kind=(
            f"count gap ({int(got[3])} clamped of {n})"), tol=0.0)
        a, r = rel_err(w.double().sum().reshape(1), exact[2].sum().reshape(1))
        errs["charge"] = dict(abs=a, err=r, kind="rel to sum w (dead slots 0)", tol=1e-6)
        call = lambda: KD.explicit_domain_cycle(field, p, v, w, **kw)  # noqa: E731
        plain_call = lambda: KD.explicit_domain_cycle_plain(field, p, v, w, **kw)  # noqa: E731
    else:  # boris_gather_push
        field, p, vx, vy, vz, const, act = _mag_inputs(n, gen, dev, ng)
        bkw = dict(b=(0.1395, 1.9951, 0.0), dt_dx=1e-10 / 2.5e-6, swap_weights=True)
        got = K.boris_gather_push(field, p, vx, vy, vz, const, act, **bkw)
        ref = K.boris_gather_push_plain(field, p, vx, vy, vz, const, act, **bkw)
        live = act > 0
        if not all(torch.equal(g[~live], h[~live]) for g, h in zip(got, (p, vx, vy, vz))):
            raise AssertionError("boris_gather_push: inactive rows changed")
        a = float((got[0] - ref[0]).abs().max())
        errs["p1"] = dict(abs=a, err=a, kind="cells", tol=TOL_POS)
        for k_, r_, g_ in zip(("vx1", "vy1", "vz1"), ref[1:], got[1:]):
            a, r = rel_err(r_, g_)
            errs[k_] = dict(abs=a, err=r, kind="rel", tol=TOL_V)
        call = lambda: K.boris_gather_push(field, p, vx, vy, vz, const, act, **bkw)  # noqa: E731
        plain_call = lambda: K.boris_gather_push_plain(  # noqa: E731
            field, p, vx, vy, vz, const, act, **bkw)
    torch.cuda.synchronize()
    err = _check(errs, f"{name}(n = {n}, ng = {ng})")
    rec = dict(n=n, ng=ng, max_abs_err=err)
    if timed:
        node_bytes, _ = PERIODIC_LARGE_ROWS[name]
        b, by = bound(name, n, extra_bytes=node_bytes * ng)
        K.reset_launch_counts()
        rec.update(ms=device_ms(call, calls=10), plain_ms=cuda_ms(plain_call, reps=1, calls=1),
                   bound_ms=b, bound_by=by, library_ms=library)
        rec["modes"] = dict(K.LARGE_LAUNCHES)
        log(f"[large periodic] {name} at n = {n}, ng = {ng}: {rec['ms']:.4f} ms, plain "
            f"{rec['plain_ms']:.4f} ms, bound {b:.4f} ms ({by})"
            + (f", library {library:.4f} ms" if library is not None else
               ", no single library call computes it")
            + (f" (grid_sample's gap {library_gap:.2e} of the largest value, not held)"
               if library_gap is not None else "") + f"; launches {rec['modes']}")
    return rec


def periodic_large_kernel_times(dev) -> dict:
    """Phase 41's kernels alone (module docstring): each in its large mode
    at PERIODIC_MID_NG where its old ceiling lies below it and at
    LARGE_KERNEL_NGS, n = PERIODIC_LARGE_N, checked and timed; each
    shape's launches counted by mode (every one must be the global mode,
    or for rows 1, 2, 14 and 17 the mode cuda_cic.cluster_launch names,
    whose record keeps the global mode's beside it under "global_mode").
    Returns {kernel: {shape: record}}."""
    from pypic_tpu_torch.ops import cuda_cic as K

    gen = torch.Generator(device=dev).manual_seed(41)
    out, problems = {}, []
    for name, (_, mid) in PERIODIC_LARGE_ROWS.items():
        out[name] = {}
        for ng in ((PERIODIC_MID_NG,) if mid else ()) + LARGE_KERNEL_NGS:
            want = "global"
            if name in K.CLUSTER_KERNELS:
                want = K.cluster_launch(name, PERIODIC_LARGE_N, ng, 132).mode
            rec = _periodic_large_case(name, PERIODIC_LARGE_N, ng, gen, dev)
            if not rec["modes"].get(f"{name} {want}"):
                problems.append(f"{name} at ng = {ng}: no {want}-mode launch "
                                f"({rec['modes']})")
            if want != "global":
                with _forced_pass_mode("global"):
                    rec["global_mode"] = _periodic_large_case(
                        name, PERIODIC_LARGE_N, ng, gen, dev)
            out[name][f"n {PERIODIC_LARGE_N}, ng {ng}"] = rec
            torch.cuda.empty_cache()
    if problems:
        raise AssertionError("large periodic kernels: " + "; ".join(problems))
    return out


@contextlib.contextmanager
def _forced_pass_mode(mode: str):
    """Rows 1 and 2 launched in ``mode`` whatever cuda_cic.cluster_launch
    would choose (its grid and shared memory for that mode)."""
    from pypic_tpu_torch.ops import cuda_cic as K

    real = K._pass_launch
    K._pass_launch = functools.partial(real, mode=mode)
    try:
        yield
    finally:
        K._pass_launch = real


# forced_mode_times' shapes of the kernels of cuda_cic.CLUSTER_KERNELS
# (rows 1, 2, 14 and 17): every mode that can launch there, in each dtype
# the kernel takes; row 14 also at two grids of its shared mode
PASS_MODE_NGS = (16_384, 28_672, 32_768, 57_344, 65_536, 262_144, 1 << 20)
LEAPFROG_MODE_NGS = (4_096, 8_192)
PASS_MODE_NS = (10_000_000, N_HEADLINE)
PASS_MODES = ("shared", "global", "cluster", "pair")


def _pass_modes(name: str, n: int, ng: int, item: int) -> list:
    """The modes of PASS_MODES kernel ``name`` (one of CLUSTER_KERNELS) can
    launch at (n, ng) in ``item``-byte elements."""
    from pypic_tpu_torch.ops import cuda_cic as K

    out = ["global"]
    if K.sweep_launch(name, n, ng, 132, item=item).mode == "shared":
        out.insert(0, "shared")
    if K.cluster_size(name, ng, item) is not None:
        out.append("cluster")
    if item == 4:
        out.append("pair")
    return out


def _mode_case_calls(name: str, n: int, ng: int, dtype, gen, dev):
    """Kernel ``name`` of CLUSTER_KERNELS on one set of random inputs at (n,
    ng) of ``dtype``: (call, the index of its sum, {output: index} of the
    outputs every mode must give the global mode's bits of, the exact sum,
    its limit, what the limit is). ``call(True)`` returns every output
    (v1 too); ``call(False)`` is the launch the paths time (no v1). The
    exact sum: a float64 sum of the plain version's float32 terms (TOL_DEP),
    or the float64 plain version (deposit_tol64)."""
    from pypic_tpu_torch.ops import cuda_cic as K
    from pypic_tpu_torch.ops import cuda_domain as KD

    kw = dict(qm=QM, w=W, dt=DT, dx=DX)
    if name.startswith("picard_iteration_ext"):  # row 17: the slab, float32
        shared = name.endswith(" shared")
        fr = _slab_frame(ng)
        f32 = torch.float32
        p0 = torch.rand(n, generator=gen, device=dev, dtype=f32) * (
            fr["hi"] - fr["lo"] + 6.0) + (fr["lo"] - 3.0)
        ps = p0 + torch.randn(n, generator=gen, device=dev, dtype=f32) * 0.3
        v0 = torch.randn(n, generator=gen, device=dev, dtype=f32) * 1e5
        field = torch.randn(ng, generator=gen, device=dev, dtype=f32) * 30.0
        w = torch.full((n,), W, dtype=f32, device=dev)
        w[torch.rand(n, generator=gen, device=dev) < 0.05] = 0.0
        args = (field, ps, p0, v0, w)
        skw = dict(qm=float(torch.tensor(QM, dtype=f32)), dt=DT, dx=DX, lo=fr["lo"],
                   hi=fr["hi"], shared=shared)
        exact = KD.picard_iteration_ext_plain(*args, emit_v=True, acc_dtype=torch.float64,
                                              **skw)[2]
        bits = {"ph": 0, "v1": 1, **({"n_clamped": 3} if shared else {})}
        return (lambda emit_v: KD.picard_iteration_ext(*args, emit_v=emit_v, **skw), 2, bits,
                exact, TOL_DEP, "rel vs float64 sums")
    f64 = dtype == torch.float64
    e, ps, p0, v0 = (t.to(dtype) for t in _random_pass_inputs(n, gen, dev, True, ng))
    if name == "leapfrog_gather_push_deposit":  # row 14
        ref = K.leapfrog_gather_push_deposit_plain(e, p0, v0, **kw)
        if f64:
            exact, tol, kind = ref[2], deposit_tol64(n), "rel vs the float64 plain version"
        else:
            w32 = K.leapfrog_scalars(QM, DT, DX, W)[2]
            exact = K.deposit_plain(ref[0].double(), torch.full_like(ref[0], w32).double(),
                                    ng, periodic=True)
            tol, kind = TOL_DEP, "rel vs float64"
        del ref
        return (lambda emit_v: K.leapfrog_gather_push_deposit(e, p0, v0, **kw), 2,
                {"p1": 0, "v1": 1}, exact, tol, kind)
    shared = name == "picard_iteration_shared"  # rows 1 and 2
    fn = K.picard_iteration_shared if shared else K.picard_iteration
    plain = K.picard_iteration_shared_plain if shared else K.picard_iteration_plain
    if f64:
        exact, tol, kind = plain(e, ps, p0, v0, ng, emit_v=True, **kw)[2], deposit_tol64(n), \
            "rel vs the float64 plain version"
    elif shared:
        exact = plain(e, ps, p0, v0, ng, emit_v=True, acc_dtype=torch.float64, **kw)[2]
        tol, kind = TOL_DEP, "rel vs float64"
    else:
        ref = plain(e, ps, p0, v0, ng, emit_v=True, **kw)
        w32 = K.kernel_scalars(QM, DT, DX, W)[3]
        exact = K.deposit_plain(ref[0].double(), (w32 * (0.5 * (v0 + ref[1]))).double(),
                                ng, periodic=True)
        tol, kind = TOL_DEP, "rel vs float64"
        del ref
    bits = {"ph": 0, "v1": 1, **({"n_clamped": 3} if shared else {})}
    return (lambda emit_v: fn(e, ps, p0, v0, ng, emit_v=emit_v, **kw), 2, bits, exact, tol,
            kind)


def _pass_mode_case(name: str, n: int, ng: int, dtype, modes, gen, dev) -> dict:
    """Kernel ``name`` of CLUSTER_KERNELS on one set of random inputs at (n,
    ng) of ``dtype`` (_mode_case_calls), in each of ``modes`` forced: its
    sum within its limit of the exact sum, the other outputs (ph or p1,
    v1, the clamp count) bit-equal to the global mode's (the parent's
    kernel), one launch in the mode, then timed (device_ms). Returns
    {mode: ms}."""
    from pypic_tpu_torch.ops import cuda_cic as K

    call, at, bits, exact, tol, kind = _mode_case_calls(name, n, ng, dtype, gen, dev)
    wrapper = name.split()[0] + ("_f64" if dtype == torch.float64 else "")
    outs, times = {}, {}
    for mode in ["global"] + [m for m in modes if m != "global"]:
        K.reset_launch_counts()
        with _forced_pass_mode(mode):
            got = call(True)
            torch.cuda.synchronize()
            errs = {}
            a, r = rel_err(exact, got[at])
            errs["sum"] = dict(abs=a, err=r, kind=kind, tol=tol)
            if mode != "global":
                for key, i in bits.items():
                    same = bool(torch.equal(got[i], outs["global"][i]))
                    errs[f"{key} bits"] = dict(abs=float(not same), err=float(not same),
                                               kind="1 if not bit-equal to the global mode's",
                                               tol=0.0)
            _check(errs, f"{name} {dtype} {mode} (n = {n}, ng = {ng})")
            launched = dict(K.LARGE_LAUNCHES)
            if launched != ({f"{wrapper} {mode}": 1} if mode != "shared" else {}):
                raise AssertionError(f"{name} {mode}: launches {launched}")
            if mode == "global":
                outs["global"] = got
            del got
            times[mode] = device_ms(lambda: call(False), calls=10)
    del outs, exact
    torch.cuda.empty_cache()
    return times


def forced_mode_times(dev, names=("picard_iteration", "picard_iteration_shared",
                                  "picard_finalize", "leapfrog_gather_push_deposit",
                                  "picard_iteration_ext", "picard_iteration_ext shared",
                                  "picard_finalize_ext", "explicit_domain_cycle"),
                      ngs=(16_384, 28_672), pass_ngs=PASS_MODE_NGS,
                      pass_ns=PASS_MODE_NS,
                      dtypes=(torch.float32, torch.float64)) -> dict:
    """Each grid-stride kernel of ``names`` at n = PERIODIC_LARGE_N and each
    ng of ``ngs`` (below its shared ceiling) launched in both modes
    whatever smem_mode would choose there (sweep_launch's blocks and
    threads, the mode's shared bytes), checked against its plain version
    and timed as phase 41 times it; the modes' order alternates from one
    ng to the next. The kernels of cuda_cic.CLUSTER_KERNELS (rows 1, 2, 17
    in both windows, 14) instead at each n of ``pass_ns`` and ng of
    ``pass_ngs`` (row 14 also LEAPFROG_MODE_NGS) in each dtype of
    ``dtypes`` the kernel takes (PASS_RULE), in every mode of PASS_MODES
    that can launch there (_pass_mode_case: the global mode first, its
    outputs the others' bits). Not run by main: it answers which mode is
    faster at a grid where more than one can launch. Returns {kernel: {ng:
    {mode: ms}}}, the CLUSTER_KERNELS {dtype: {n: {ng: {mode: ms}}}}."""
    modes = ("shared", "global")
    from pypic_tpu_torch.ops import cuda_cic as K
    from pypic_tpu_torch.ops import cuda_domain as KD

    real = K._sweep

    def forced(mode):
        def sweep(dev_, kernel, n, nodes, extra=0):
            launch = real(dev_, kernel, n, nodes, extra)
            arrays = K.SWEEP_KERNELS[kernel][0]
            smem = 4 * arrays * nodes + extra if mode == "shared" else 0
            return K.SweepLaunch(mode, launch.blocks, launch.threads, smem)
        return sweep

    gen = torch.Generator(device=dev).manual_seed(41)
    out = {}
    for name in names:
        out[name] = {}
        if name in K.CLUSTER_KERNELS:
            grids = (LEAPFROG_MODE_NGS + tuple(pass_ngs)
                     if name == "leapfrog_gather_push_deposit" else pass_ngs)
            for dtype in dtypes:
                item = torch.empty((), dtype=dtype).element_size()
                if item not in K.PASS_RULE[name]:
                    continue  # row 17: float32 alone
                by_n = out[name][str(dtype)] = {}
                for n in pass_ns:
                    by_n[n] = {}
                    for ng in grids:
                        can = _pass_modes(name, n, ng, item)
                        by_n[n][ng] = _pass_mode_case(name, n, ng, dtype, can, gen, dev)
                        log(f"[modes] {name} {dtype} at n = {n}, ng = {ng}: " + ", ".join(
                            f"{m} {t:.4f} ms" for m, t in by_n[n][ng].items())
                            + f"; cluster_launch takes "
                            f"{K.cluster_launch(name, n, ng, 132, item).mode}")
            continue
        for i, ng in enumerate(ngs):
            out[name][ng] = {}
            for mode in (modes if i % 2 == 0 else modes[::-1]):
                K._sweep = KD._sweep = forced(mode)
                try:
                    rec = _periodic_large_case(name, PERIODIC_LARGE_N, ng, gen, dev)
                finally:
                    K._sweep = KD._sweep = real
                out[name][ng][mode] = rec["ms"]
                torch.cuda.empty_cache()
            log(f"[modes] {name} at n = {PERIODIC_LARGE_N}, ng = {ng}: " + ", ".join(
                f"{m} {t:.4f} ms" for m, t in out[name][ng].items()))
    return out



# mode_boundaries' row counts: the sweeps' and the wide deposits' wide
# grid, the deposits' narrow grid (the first port's), the sheath pass's
BOUNDARY_NS = (1_000_003, 10_007)
BOUNDARY_SHEATH_N = 100_003
# the kernels of cuda_cic.CLUSTER_KERNELS: rows enough for the cluster
# mode to the last node one CTA holds (CLUSTER_MIN_ROWS_PER_NODE, 64 rows a
# float32 node, times 58,113)
BOUNDARY_CLUSTER_N = 3_800_003


def _transitions(key, lo: int, hi: int, scan: int = 4096) -> list:
    """The ng in [lo, hi) after which ``key`` changes: every ng below
    ``scan`` (the sheath pass's threads go back and forth there), halving
    above it, where the keys are monotone in ng."""
    if lo < scan:
        top = min(scan, hi)
        out = [g for g in range(lo, top) if key(g) != key(g + 1)]
        return out + (_transitions(key, top, hi) if top < hi else [])
    if key(lo) == key(hi):
        return []
    if hi - lo == 1:
        return [lo]
    mid = (lo + hi) // 2
    return _transitions(key, lo, mid) + _transitions(key, mid, hi)


def mode_boundaries(dev) -> dict:
    """Every kernel whose launch shape picks a mode, a column count or a
    thread count from ng (cuda_cic.sweep_launch, deposit_launch_shape,
    cuda_sheath.launch_shape), at the last node of each shape and the
    first of the next up to SMEM_LIMIT // 4 + 1 nodes, against its plain
    version at its kernel phase's checks (_periodic_large_case,
    _large_kernel_case; only failures logged). There a launch's shared
    bytes, its kernel's static bytes included, sit nearest a block's
    limit, and a launch that asks for more fails (ROADMAP.md Faults 4
    and 5). Returns {kernel: [ng, ...]}."""
    global _QUIET_CHECKS
    from pypic_tpu_torch.ops import cuda_cic as K
    from pypic_tpu_torch.ops import cuda_sheath as S

    sms = K._sm_count(dev.index)
    top = K.SMEM_LIMIT // 4 + 1
    wide, narrow = BOUNDARY_NS
    halo = 2 * PERIODIC_SLAB_HALO + 1

    def sweep_key(kernel):
        if kernel in K.CLUSTER_KERNELS:  # rows 1, 2, 14, 17: modes and cluster sizes
            return lambda ng: (lambda s: (s.mode, s.cluster))(
                K.cluster_launch(kernel, BOUNDARY_CLUSTER_N, ng, sms))
        extra = (lambda ng: 4 * (ng + halo)) if kernel == "explicit_domain_cycle" else (
            lambda ng: 0)
        return lambda ng: K.sweep_launch(kernel, wide, ng, sms, extra(ng)).mode

    def deposit_key(n, hists, field):
        return lambda ng: (lambda s: (s.mode, s.cols))(
            K.deposit_launch_shape(n, ng, field, sms, hists))

    def sheath_key(field):
        return lambda ng: (lambda s: (s.large, s.threads, s.smem > 0))(
            S.launch_shape(BOUNDARY_SHEATH_N, ng, sms, field))

    cases = []  # (kernel, n, keys, case function)
    for name in PERIODIC_LARGE_ROWS:
        if name == "deposit":
            cases += [(name, n, [deposit_key(n, 1, False)], _periodic_large_case)
                      for n in BOUNDARY_NS]
        else:
            keys = [k for k in K.SWEEP_KERNELS if k.split()[0] == name]
            n = BOUNDARY_CLUSTER_N if any(k in K.CLUSTER_KERNELS for k in keys) else wide
            cases.append((name, n, [sweep_key(k) for k in keys], _periodic_large_case))
    for name, field in (("deposit2", False), ("boris_gather_push_deposit", True)):
        cases += [(name, n, [deposit_key(n, 2, field)], _large_kernel_case)
                  for n in BOUNDARY_NS]
    for name, field in (("sheath_picard", True), ("sheath_finalize", True),
                        ("deposit_det", False)):
        cases.append((name, BOUNDARY_SHEATH_N, [sheath_key(field)], _large_kernel_case))
    gen = torch.Generator(device=dev).manual_seed(42)
    out = collections.defaultdict(list)
    _QUIET_CHECKS = True
    try:
        for name, n, keys, case in cases:
            ngs = sorted({g for key in keys for t in _transitions(key, 2, top)
                          for g in (t, t + 1)})
            for ng in ngs:
                case(name, n, ng, gen, dev, timed=False)
                torch.cuda.empty_cache()
            out[name] += ngs
            log(f"[boundaries] {name} at n = {n}: ng {ngs} against the plain version")
    finally:
        _QUIET_CHECKS = False
    return dict(out)


# phase 41's paths: the implicit headline at PERIODIC_PATH_NGS, the other
# engines at PERIODIC_PATH_NG, each card step held against the CPU's
# plain route from one state (the n of PERIODIC_CHECK_N)
PERIODIC_PATH_NGS = (32_768, 65_536)
PERIODIC_PATH_NG = 65_536
PERIODIC_CHECK_N = 1_000_000
# the slab engines' checks: bench's migration bucket, max(4096, 4 n / ng)
# rows a neighbour, holds a step's crossings at ng 65,536 on two ranks up
# to n ~ 5e5 (7,762 migrated, none dropped; at 1e6 ~7,600 rows a step
# drop, on the CPU alike)
PERIODIC_SLAB_CHECK_N = 500_000
PERIODIC_TIMED_STEPS = 2
# the implicit headline's timed windows of PERIODIC_TIMED_STEPS steps a
# grid (one read 71 ms/step where the others read 18: PERF.md §5)
PERIODIC_HEADLINE_WINDOWS = 3
# the slab rows' timed steps on one NCCL rank, after one
PERIODIC_SLAB_TIMED_STEPS = 5
# the timed runs of the explicit, slab and magnetized paths
PERIODIC_RUN_N = 10_000_000
# At these grids a step is ill-conditioned in its positions (the CPU test
# tests/test_torch_large_periodic_jax.py; ROADMAP.md queue 3): a
# position's float32 ulp, ng 2^-24 cells at p ~ ng, moves the sparse
# deposits, the field and the push. The card's step differs from the
# CPU's only in the order of its float32 sums, which moves a node sum by
# ~2^-24 of itself, less than moving its particles by an ulp of p moves
# their weights (ng 2^-24 of a cell). So each check first steps the CPU
# from the same state with every position moved by one ulp (alternately
# up and down), takes that step's gap from the CPU's as delta_s, and holds
# the card to PERIODIC_CALIBRATED delta_s, each quantity its own, or to
# the limit the same comparison has at ng = 200 where that is larger
# (a quantity the ulp hardly moves: the energies before the push)
PERIODIC_CALIBRATED = 2.0
# the ng = 200 limits: phase 4's card-against-CPU step (implicit), phase
# 6's kernel limits with the 1e-3 tests/test_torch_explicit.py holds two
# FFT solves to (explicit), phase 26's (the slab engines)
PERIODIC_FLOORS = {
    "implicit": {"p": 2e-4, "v": 1e-5, "e": 1e-4, "j": 1e-4},
    "explicit": {"p": TOL_POS, "v": TOL_V, "rho": TOL_DEP, "e": 1e-3},
    "domain": {"field_energy": TOL_DOM_CHECK, "kinetic_energy": TOL_DOM_CHECK,
               "p": TOL_POS_STEPS, "v": TOL_V},
}


# phase 41's paths in turns: the global mode (the parent's kernels of rows
# 14 and 17), the mode cuda_cic.cluster_launch takes (None), that mode
# again, the global mode; each turn one step, then its timed steps (the
# fused two-stream's MODE_TURN_STEPS after MODE_TURN_WARMUP steps before
# the first turn; configs[4]'s PERIODIC_SLAB_TIMED_STEPS)
MODE_TURNS = ("global", None, None, "global")
MODE_TURN_STEPS, MODE_TURN_WARMUP = 50, 3
# the same paths inside the cluster mode's range (cuda_cic.PASS_RULE:
# 16,384 to 58,112 nodes) at n = PERIODIC_RUN_N: configs[4] on one NCCL
# rank at these ng (ext_n ~27,800, ~37,000 and ~55,500: either side of
# the node counts where random rows put row 17's separate window in the
# pair mode), its shared window at the middle one, and the fused
# two-stream at that one, each mode forced in turns; float64 has no pair
# mode
PERIODIC_CLUSTER_NGS = (24_576, 32_768, 49_152)
CLUSTER_TURNS = ("global", "cluster", "pair", "pair", "cluster", "global")
CLUSTER_TURNS_F64 = ("global", "cluster", "cluster", "global")
# two gloo ranks' turns (at 7.6 rows a cell the total energy moves 6.5e-4
# to 3.1e-3 in 5 steps in the global mode too, growing from turn to turn:
# PERF.md §5) and the float64 two-stream's at 32,768 (which grows its
# instability where float32's step does not: 9.7e-4 to 3.8e-2 a turn in
# the global mode, and on the CPU's plain route alike: PERF.md §7): no
# fixed bound holds there, so each turn's change is held to this factor
# times the larger of the global turns', which bracket it
TURN_ENERGY_FACTOR = 4.0


def _energy_against_global(recs: list, label: str) -> list:
    """Problems of the turns ``recs`` whose total energy change exceeds
    TURN_ENERGY_FACTOR times the larger of the turns forced global."""
    ref = max(abs(r["total_energy_rel_change"]) for r in recs if r["turn"] == "global")
    return [f"{label} {r['mode']} turn: total energy change {r['total_energy_rel_change']} "
            f"above {TURN_ENERGY_FACTOR} times the global turns' {ref}"
            for r in recs if not abs(r["total_energy_rel_change"]) <= TURN_ENERGY_FACTOR * ref]


def _rule_or(mode):
    """The kernels of cuda_cic.CLUSTER_KERNELS in ``mode``, or in the mode
    their rule takes where ``mode`` is None."""
    return _forced_pass_mode(mode) if mode else contextlib.nullcontext()


def _slab_turn(step, st, n: int, steps: int, mode, ext_n: int, energy_bound,
               profiled: bool):
    """One turn of configs[4] (``step``, this rank's ``st``, ext_n nodes a
    slab) with row 17 in ``mode`` (_rule_or): tools/domain.py drive, one
    step then ``steps`` timed. Returns (record, state, problems): ms/step,
    the total energy change, n_dropped, the Picard mean, row 17's mode (of
    its launches: one mode a turn) and the launches by mode; held to
    conserving's limits (phase 27; the energy change to ``energy_bound``
    where it is not None). With ``profiled``, three more steps under
    torch.profiler (_step_device_ms): the device ms a step and row 17's
    (the pass and the pair fold)."""
    from pypic_tpu_torch.ops import cuda_cic as K
    from pypic_tpu_torch.tools import domain as drow

    K.reset_launch_counts()
    with _rule_or(mode):
        res, st = drow.drive(step, st, n, 1, steps)
        large = dict(K.LARGE_LAUNCHES)
        if profiled:
            st, busy, row17 = _step_device_ms(step, st, ("picard_iteration_ext_kernel",
                                                         "pair_fold_bounded_kernel"))
    modes = {k.split()[-1] for k in large if k.split()[0] == "picard_iteration_ext"}
    rec = dict(mode="/".join(sorted(modes)), turn=mode or "rule", ext_n=ext_n,
               forced=mode is not None,
               large=large, **{k: res[k] for k in (
                   "ms_per_step", "total_energy_rel_change", "n_dropped", "picard_mean",
                   "host_syncs_per_step")})
    if profiled:
        rec.update(device_ms_a_step=busy, row17_ms_a_step=row17)
    problems = []
    if rec["n_dropped"] or energy_bound is not None and not (
            abs(rec["total_energy_rel_change"]) < energy_bound):
        problems.append(f"configs[4] {rec['mode']} turn: dropped {rec['n_dropped']}, total "
                        f"energy change {rec['total_energy_rel_change']}")
    if rec["picard_mean"] != 4.0 or len(modes) != 1 or mode and modes != {mode}:
        problems.append(f"configs[4] {rec['mode']} turn: Picard mean {rec['picard_mean']}, "
                        f"launches {large}")
    return rec, st, problems


def _slab_turns_rank(mesh, load, ng: int, steps: int, energy_bound=DOM_ENERGY_BOUND,
                     profiled: bool = True, turns=MODE_TURNS,
                     window_share: str = "auto") -> list:
    """configs[4] (tools/domain.py implicit_row, fused, ``window_share``)
    on this rank from ``load`` at ng nodes in ``turns`` (_slab_turn);
    with no ``energy_bound``, each turn's energy change held to
    TURN_ENERGY_FACTOR times the larger of the global turns'. Returns
    (records, problems). Module-level: the spawned ranks call it."""
    from pypic_tpu_torch.parallel import domain_implicit
    from pypic_tpu_torch.tools import domain as drow

    cfg, st = drow.implicit_row(mesh, len(load[0]), load=load, ng=ng, backend="fused",
                                window_share=window_share)
    step = domain_implicit.make_step(cfg, mesh)
    ext_n = cfg.cells_per_shard + 2 * (cfg.halo + 2) + 1
    recs, problems = [], []
    for mode in turns:
        rec, st, bad = _slab_turn(step, st, len(load[0]), steps, mode, ext_n, energy_bound,
                                  profiled)
        recs.append(dict(rec, window_share=window_share))
        problems += bad
    if energy_bound is None:
        problems += _energy_against_global(recs, "configs[4]")
    return recs, problems


def _ulp_moved(p: "np.ndarray") -> "np.ndarray":
    """Every float32 position moved by one ulp, alternately up and down."""
    import numpy as np

    up = np.arange(p.size) % 2 == 0
    return np.where(up, np.nextafter(p, np.float32(np.inf)),
                    np.nextafter(p, np.float32(-np.inf))).astype(p.dtype)


def _gap(ref, got, key: str, ng: int) -> float:
    ref = torch.as_tensor(ref).double().cpu()
    got = torch.as_tensor(got).double().cpu()
    return seam_err(ref, got, ng) if key == "p" else rel_err(ref, got)[1]


def _calibrated(label: str, ref: dict, moved: dict, card: dict, ng: int,
                floors: dict, beside: dict | None = None) -> tuple[dict, list]:
    """Each quantity's card-CPU gap against PERIODIC_CALIBRATED times its
    delta_s (the CPU's step from the ulp-moved state against the CPU's),
    or against its ng = 200 limit in ``floors`` where that is larger;
    ``beside`` adds a gap measured apart (a library's rounding of the same
    input) to a quantity's limit."""
    rec, bad = {}, []
    beside = beside or {}
    for k in ref:
        ds = _gap(ref[k], moved[k], k, ng)
        got = _gap(ref[k], card[k], k, ng)
        tol = max(PERIODIC_CALIBRATED * ds, floors[k]) + beside.get(k, 0.0)
        rec[k] = dict(card=got, delta_s=ds, tol=tol, ng200_limit=floors[k])
        if not got <= tol:
            bad.append(f"{label} {k} {got:.3e} > {tol:.3e}")
    log(f"[large periodic] {label}, one step card against CPU (limit the larger of "
        f"{PERIODIC_CALIBRATED:g} delta_s, delta_s the CPU step's move when every "
        "position moves an ulp, and the ng = 200 limit): " + ", ".join(
            f"{k} {v['card']:.3e} (delta_s {v['delta_s']:.3e}, ng = 200 limit "
            f"{v['ng200_limit']:.0e}, limit {v['tol']:.3e})" for k, v in rec.items()))
    return rec, bad


def _implicit_large_runs(dev) -> tuple[dict, list]:
    """The implicit headline physics (tools/headline.py's conserving
    configuration) at each of PERIODIC_PATH_NGS: n = N_HEADLINE from the
    device load, one warm-up step and PERIODIC_TIMED_STEPS timed, then one
    step each of window_share='shared' and finalize='converged-deposit'
    from the same state (their launches); and at n = PERIODIC_CHECK_N one
    step of each configuration card against CPU (_calibrated)."""
    import dataclasses

    from pypic_tpu_torch import interop
    from pypic_tpu_torch.engines import implicit
    from pypic_tpu_torch.ops import cuda_cic as K
    from pypic_tpu_torch.runner import run

    res, problems = {}, []
    variants = {"conserving": {}, "shared": dict(window_share="shared"),
                "converged-deposit": dict(finalize="converged-deposit")}
    for ng in PERIODIC_PATH_NGS:
        rec = {}
        K.reset_launch_counts()
        t0 = time.perf_counter()
        cfg, step, st = headline_state(N_HEADLINE, dev, ng=ng)
        st, _ = run(step, st, 1)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        windows, picard = [], []
        for _ in range(PERIODIC_HEADLINE_WINDOWS):
            t0 = time.perf_counter()
            st, m = run(step, st, PERIODIC_TIMED_STEPS)
            torch.cuda.synchronize()
            windows.append((time.perf_counter() - t0) * 1e3 / PERIODIC_TIMED_STEPS)
            picard += m.picard_iters.tolist()
        tot = (m.field_energy.double() + m.kinetic_energy.double()).cpu()
        ms = statistics.median(windows)
        rec.update(n=N_HEADLINE, ng=ng, setup_s=setup_s, ms_per_step=ms,
                   ms_per_step_windows=windows, pushes_per_s=N_HEADLINE * 1e3 / ms,
                   picard=picard,
                   total_energy_rel_change=float((tot[-1] - tot[0]) / tot[0]))
        for name, over in variants.items():
            if over:
                _, m2 = implicit.make_step(dataclasses.replace(cfg, **over))(st)
                rec[f"{name}_picard"] = int(m2.picard_iters)
        torch.cuda.synchronize()
        rec["launches"] = dict(K.LARGE_LAUNCHES)
        if not (bool(torch.isfinite(st.p).all()) and bool(torch.isfinite(st.e).all())):
            problems.append(f"implicit ng {ng}: non-finite state")
        if picard != [4] * len(picard):
            problems.append(f"implicit ng {ng}: Picard {picard}")
        log(f"[large periodic] implicit headline ng = {ng}, n = {N_HEADLINE}: "
            f"{rec['ms_per_step']:.3f} ms/step (the median of {len(windows)} windows of "
            f"{PERIODIC_TIMED_STEPS} steps after set-up and one, {setup_s:.1f} s: "
            + ", ".join(f"{w:.3f}" for w in windows) + f"), "
            f"{rec['pushes_per_s']:.4e} pushes/s, "
            f"total energy change {rec['total_energy_rel_change']:+.3e}; large-mode "
            f"launches with one shared and one converged-deposit step {rec['launches']}")
        del st, m
        torch.cuda.empty_cache()

        cfg = headline_config(PERIODIC_CHECK_N, ng)
        from pypic_tpu_torch.constants import E_CHARGE, M_ELECTRON
        from pypic_tpu_torch.tools.headline import device_load

        x, v = device_load(PERIODIC_CHECK_N, cfg.grid.length, torch.device("cpu"))
        d = interop.implicit_state_to_numpy(
            implicit.init_state(x, v, -E_CHARGE, M_ELECTRON, cfg, device="cpu"))
        dm = dict(d, p=_ulp_moved(d["p"]))
        rec["check"] = {}
        for name, over in variants.items():
            if ng != PERIODIC_PATH_NGS[-1] and over:
                continue  # the options at the global mode's grid only
            stp = implicit.make_step(dataclasses.replace(cfg, **over))
            outs = [stp(interop.implicit_state_from_numpy(dd, where))
                    for dd, where in ((d, "cpu"), (dm, "cpu"), (d, dev))]
            q = [{k: getattr(s, k) for k in ("p", "v", "e", "j")} for s, _ in outs]
            chk, bad = _calibrated(f"implicit {name} ng {ng}", *q, ng,
                                   PERIODIC_FLOORS["implicit"])
            iters = [int(mm.picard_iters) for _, mm in outs]
            if iters[0] != iters[2]:
                bad.append(f"implicit {name} ng {ng}: Picard {iters}")
            rec["check"][name] = chk
            problems += bad
        res[f"ng {ng}"] = rec
    return res, problems


def _explicit_large_runs(dev) -> tuple[dict, list]:
    """The explicit engine on bench.py's two-stream cell (tools/two_stream.py)
    at PERIODIC_PATH_NG, fused (leapfrog_gather_push_deposit and the solve)
    and composed (gather, the tensor-op push, deposit): PERIODIC_RUN_N
    timed over PERIODIC_TIMED_STEPS steps after one; one step at
    PERIODIC_CHECK_N card against CPU (_calibrated; e1, the float32
    spectral solve of rho1 by cuFFT and by the CPU's FFT, also within the
    1e-3 tests/test_torch_explicit.py holds the two packages' solves to:
    PERIODIC_FLOORS)."""
    import dataclasses

    from pypic_tpu_torch import interop
    from pypic_tpu_torch.engines import explicit
    from pypic_tpu_torch.ops import cuda_cic as K
    from pypic_tpu_torch.runner import run
    from pypic_tpu_torch.tools import two_stream

    ng = PERIODIC_PATH_NG
    res, problems = {}, []
    for backend in ("fused", "composed"):
        K.reset_launch_counts()
        cfg, _, st = two_stream.state(PERIODIC_RUN_N, dev, ng=ng)
        cfg = dataclasses.replace(cfg, backend=backend)
        step = explicit.make_step(cfg)
        st, _ = run(step, st, 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, m = run(step, st, PERIODIC_TIMED_STEPS)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        rec = dict(n=PERIODIC_RUN_N, ng=ng, ms_per_step=secs * 1e3 / PERIODIC_TIMED_STEPS,
                   pushes_per_s=PERIODIC_RUN_N * PERIODIC_TIMED_STEPS / secs,
                   launches=dict(K.LARGE_LAUNCHES))
        if not bool(torch.isfinite(st.p).all() & torch.isfinite(st.e).all()):
            problems.append(f"explicit {backend}: non-finite state")
        del st, m
        torch.cuda.empty_cache()
        ccfg, _, cst = two_stream.state(PERIODIC_CHECK_N, "cpu", ng=ng)
        stp = explicit.make_step(dataclasses.replace(ccfg, backend=backend))
        d = interop.explicit_state_to_numpy(cst)
        dm = dict(d, p=_ulp_moved(d["p"]))
        outs = [stp(interop.explicit_state_from_numpy(dd, where))
                for dd, where in ((d, "cpu"), (dm, "cpu"), (d, dev))]
        q = [dict(p=s.p, v=s.v, rho=s.rho, e=s.e) for s, _ in outs]
        # e1 is cuFFT's and the CPU FFT's float32 solve of rho1: their gap
        # on the card's own rho1 rides on top of the calibrated part
        rho_g = outs[2][0].rho
        fft_gap = _gap(explicit._field(rho_g.cpu(), ccfg.grid.dx),
                       explicit._field(rho_g, ccfg.grid.dx), "e", ng)
        rec["check"], bad = _calibrated(f"explicit {backend} ng {ng}", *q, ng,
                                        PERIODIC_FLOORS["explicit"],
                                        beside={"e": fft_gap})
        rec["fft_gap_e"] = fft_gap
        problems += bad
        log(f"[large periodic] explicit {backend} ng = {ng}, n = {PERIODIC_RUN_N}: "
            f"{rec['ms_per_step']:.3f} ms/step, large-mode launches {rec['launches']}")
        res[backend] = rec
    # the fused path in MODE_TURNS: row 14 in the global mode and in the
    # mode its rule takes, one state stepped on; then in the cluster mode's
    # range, every mode forced in turns, in both dtypes
    for key, ng_, turns, dtype in (
            ("turns", ng, MODE_TURNS, torch.float32),
            ("cluster_range_turns", PERIODIC_CLUSTER_NGS[1], CLUSTER_TURNS, torch.float32),
            ("cluster_range_turns_f64", PERIODIC_CLUSTER_NGS[1], CLUSTER_TURNS_F64,
             torch.float64)):
        res["fused"][key], bad = _fused_turns(ng_, turns, dtype, dev)
        problems += bad
    return res, problems


def _fused_turns(ng: int, turns, dtype, dev) -> tuple[list, list]:
    """The fused explicit two-stream at PERIODIC_RUN_N and ng in ``dtype``,
    one state stepped on through ``turns`` (_rule_or: row 14 in each
    forced mode, or in its rule's where None), each turn one step then
    MODE_TURN_STEPS timed and three profiled (_step_device_ms): ms/step,
    the energy change (float32: EXPLICIT_ENERGY_BOUND; float64:
    _energy_against_global), the launches by mode, one step's device ms
    and row 14's. Returns (records, problems)."""
    import dataclasses

    from pypic_tpu_torch.engines import explicit
    from pypic_tpu_torch.ops import cuda_cic as K
    from pypic_tpu_torch.runner import run
    from pypic_tpu_torch.tools import two_stream

    item = torch.empty((), dtype=dtype).element_size()
    wrapper = "leapfrog_gather_push_deposit" + ("_f64" if item == 8 else "")
    cfg, _, st = two_stream.state(PERIODIC_RUN_N, dev, ng=ng, dtype=dtype)
    step = explicit.make_step(dataclasses.replace(cfg, backend="fused"))
    st, _ = run(step, st, MODE_TURN_WARMUP)
    recs, problems = [], []
    rule = K.cluster_launch("leapfrog_gather_push_deposit", PERIODIC_RUN_N, ng, 132,
                            item).mode
    for mode in turns:
        K.reset_launch_counts()
        with _rule_or(mode):
            st, _ = run(step, st, 1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, m = run(step, st, MODE_TURN_STEPS)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            large = dict(K.LARGE_LAUNCHES)
            st, busy, row14 = _step_device_ms(step, st, ("leapfrog_deposit_kernel",
                                                         "pair_fold_kernel"))
        tot = (m.field_energy.double() + m.kinetic_energy.double()).cpu()
        want = mode or rule
        rec = dict(mode=want, turn=mode or "rule", forced=mode is not None, rule=rule, ng=ng,
                   dtype=str(dtype),
                   ms_per_step=secs * 1e3 / MODE_TURN_STEPS,
                   total_energy_rel_change=float((tot[-1] - tot[0]) / tot[0]),
                   large=large, device_ms_a_step=busy, row14_ms_a_step=row14)
        if (item == 4 and not abs(rec["total_energy_rel_change"]) < EXPLICIT_ENERGY_BOUND
                or not bool(torch.isfinite(st.p).all())
                or rec["large"].get(f"{wrapper} {want}") != MODE_TURN_STEPS + 1):
            problems.append(f"explicit fused {dtype} ng {ng} {want} turn: {rec}")
        recs.append(rec)
    if item == 8:
        problems += _energy_against_global(recs, f"explicit fused {dtype} ng {ng}")
    log(f"[large periodic] explicit fused {dtype} ng = {ng}, n = {PERIODIC_RUN_N} (the rule: "
        f"{rule}), in turns of {MODE_TURN_STEPS} steps after one: " + ", ".join(
            f"{r['mode']} {r['ms_per_step']:.4f} ms/step (energy change "
            f"{r['total_energy_rel_change']:+.3e}; one step's device time "
            f"{r['device_ms_a_step']:.4f} ms, row 14's {r['row14_ms_a_step']:.4f})"
            for r in recs))
    del st, m
    torch.cuda.empty_cache()
    return recs, problems


def _large_slab_rank(mesh, load, jobs, where: str) -> list:
    """Each job (engine, steps, overrides) of tools/domain.py's rows on
    this rank, the state made on the CPU from ``load`` (its initial field
    is a float32 spectral solve whose low-k eigenvalues 2 cos(2 pi k / ng)
    - 2 round to 0 or not by the device's cosine at these grids, so a
    state made on the card would differ in those modes) and stepped on
    the CPU (``where`` 'cpu'), on the CPU with every live position moved
    one ulp ('moved') or on ``mesh``'s card ('card'). Returns, a job
    each, the metric rows, p, v and alive as numpy and the large-mode
    launches. Module-level: the spawned ranks call it."""
    import dataclasses

    from pypic_tpu_torch.ops import cuda_cic as K
    from pypic_tpu_torch.parallel import domain, domain_implicit, make_mesh
    from pypic_tpu_torch.runner import run
    from pypic_tpu_torch.tools import domain as drow

    cpu = make_mesh(device="cpu")
    out = []
    for engine, steps, over in jobs:
        make_row, eng = ((drow.implicit_row, domain_implicit) if engine == "implicit"
                         else (drow.explicit_row, domain))
        cfg, st = make_row(cpu, len(load[0]), load=load, **over)
        if where == "moved":
            moved = torch.from_numpy(_ulp_moved(st.p.numpy()))
            st = dataclasses.replace(st, p=torch.where(st.alive, moved, st.p))
        if where == "card":
            st = dataclasses.replace(st, **{
                f.name: getattr(st, f.name).to(mesh.device)
                for f in dataclasses.fields(st) if torch.is_tensor(getattr(st, f.name))})
        K.reset_launch_counts()
        st, m = run(eng.make_step(cfg, mesh if where == "card" else cpu), st, steps)
        out.append(dict(rows={k: v.cpu().tolist() for k, v in m._asdict().items()},
                        p=st.p.cpu().numpy(), v=st.v.cpu().numpy(),
                        alive=st.alive.cpu().numpy(),
                        large_launches=dict(K.LARGE_LAUNCHES)))
    return out


def _slab_rule(ext_n: int, share: str) -> str:
    """Row 17's mode by its rule at configs[4]'s n on one rank and ext_n."""
    from pypic_tpu_torch.ops import cuda_cic as K

    kernel = "picard_iteration_ext" + (" shared" if share == "shared" else "")
    return K.cluster_launch(kernel, PERIODIC_RUN_N, ext_n, 132).mode


def _log_turns(label: str, turns: list) -> None:
    log(f"[large periodic] {label}, in turns of {PERIODIC_SLAB_TIMED_STEPS} steps after "
        "one: " + ", ".join(
            f"{r['mode']}{' (forced)' if r['forced'] else ''} at ext_n {r['ext_n']} "
            f"{r['ms_per_step']:.4f} ms/step (energy change "
            f"{r['total_energy_rel_change']:+.3e}, Picard mean {r['picard_mean']}, dropped "
            f"{r['n_dropped']}, host syncs a step {r['host_syncs_per_step']}"
            + (f"; one step's device time {r['device_ms_a_step']:.4f} ms, row 17's "
               f"{r['row17_ms_a_step']:.4f}" if "device_ms_a_step" in r else "") + ")"
            for r in turns))


def _domain_large_runs(dev) -> tuple[dict, list]:
    """configs[4] (conserving, and converged-deposit), its explicit carrier
    and its carried carrier (tools/domain.py's rows at PERIODIC_PATH_NG):
    on a one-rank NCCL group at PERIODIC_RUN_N, PERIODIC_SLAB_TIMED_STEPS
    steps each after one, timed (tools/domain.py timed; the slabs of one
    rank: ext_n past 58,112, the global modes);
    then one step each at PERIODIC_SLAB_CHECK_N from one CPU-made load and
    CPU-made states (_large_slab_rank), one group-less rank card against
    CPU (_calibrated: field and kinetic energy, p and v of the alive
    slots) and two gloo ranks on the card against two on the CPU (ext_n
    41,273, 2.5e5 rows a rank: row 17's pair mode) at the one rank's
    limits: counts equal, energies, p and v. configs[4] also in
    MODE_TURNS on the one NCCL rank and on two gloo ranks on the card
    (_slab_turns_rank), and on the one NCCL rank in CLUSTER_TURNS at
    PERIODIC_CLUSTER_NGS (its shared window at the middle one)."""
    import numpy as np
    import torch.distributed as dist

    from pypic_tpu_torch.ops import cuda_cic as K
    from pypic_tpu_torch.parallel import domain, domain_implicit, make_mesh, spawn
    from pypic_tpu_torch.tools import domain as drow

    ng = PERIODIC_PATH_NG
    # the fused backend on both sides ('auto' is composed off the card)
    jobs = [("implicit", 1, dict(ng=ng, backend="fused")),
            ("implicit", 1, dict(ng=ng, backend="fused", finalize="converged-deposit")),
            ("explicit", 1, dict(ng=ng)),
            ("explicit", 1, dict(ng=ng, carried_rho="on"))]
    labels = ("configs[4]", "configs[4] converged-deposit", "carrier", "carried carrier")
    res, problems, launches = {}, [], collections.Counter()
    drow.process_group()
    try:
        mesh = make_mesh(device=dev)
        load = drow.host_load(PERIODIC_RUN_N)
        res["one_rank_nccl"] = {}
        for (engine, _, over), lab in zip(jobs, labels):
            K.reset_launch_counts()
            make_row, eng = ((drow.implicit_row, domain_implicit) if engine == "implicit"
                             else (drow.explicit_row, domain))
            cfg, st = make_row(mesh, PERIODIC_RUN_N, load=load, **over)
            secs, syncs, counts, st, m = drow.timed(eng.make_step(cfg, mesh), st,
                                                    PERIODIC_SLAB_TIMED_STEPS, warmup=1)
            rec = dict(n=PERIODIC_RUN_N, ng=ng, steps=PERIODIC_SLAB_TIMED_STEPS,
                       ms_per_step=secs * 1e3 / PERIODIC_SLAB_TIMED_STEPS,
                       host_syncs=syncs, launches=counts, large=dict(K.LARGE_LAUNCHES),
                       dropped=int(m.n_dropped.sum()))
            res["one_rank_nccl"][lab] = rec
            launches.update(rec["large"])
            if rec["dropped"] or not bool(torch.isfinite(st.p).all()):
                problems.append(f"{lab} one NCCL rank: dropped {rec['dropped']} or "
                                "non-finite positions")
            log(f"[large periodic] {lab} at ng = {ng}, n = {PERIODIC_RUN_N}, one NCCL "
                f"rank: {rec['ms_per_step']:.3f} ms/step ({PERIODIC_SLAB_TIMED_STEPS} "
                f"steps after one), host syncs {syncs}, large-mode launches {rec['large']}")
            del st, m
        torch.cuda.empty_cache()
        # configs[4] in MODE_TURNS: row 17 in the global mode and in the mode
        # its rule takes
        turns, bad = _slab_turns_rank(mesh, load, ng, PERIODIC_SLAB_TIMED_STEPS)
        res["one_rank_nccl_turns"] = turns
        problems += bad
        _log_turns(f"configs[4] at ng = {ng}, n = {PERIODIC_RUN_N}, one NCCL rank", turns)
        # in the cluster mode's range, every mode forced in turns
        res["cluster_range_turns"] = {}
        for ng_, share in [(g, "auto") for g in PERIODIC_CLUSTER_NGS] + [
                (PERIODIC_CLUSTER_NGS[1], "shared")]:
            turns, bad = _slab_turns_rank(mesh, load, ng_, PERIODIC_SLAB_TIMED_STEPS,
                                          turns=CLUSTER_TURNS, window_share=share)
            res["cluster_range_turns"][f"ng {ng_} {share}"] = turns
            problems += bad
            for r in turns:
                launches.update(r["large"])
            _log_turns(f"configs[4] window_share {share} at ng = {ng_}, n = "
                       f"{PERIODIC_RUN_N}, one NCCL rank (the rule: "
                       f"{_slab_rule(turns[0]['ext_n'], share)})", turns)
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    # the same on two gloo ranks on the card (ext_n ~ 41,300 a rank), from
    # the checks' load (bench's migration bucket holds it); at its 7.6 rows
    # a cell the total energy moves 6.5e-4 to 3.1e-3 in 5 steps in the
    # global mode too (the parent's kernels; PERF.md §5), so no fixed
    # energy bound holds there: each turn is held to TURN_ENERGY_FACTOR
    # times the global turns' change
    t0 = time.perf_counter()
    two = spawn.run(2, _slab_turns_rank, drow.host_load(PERIODIC_SLAB_CHECK_N), ng,
                    PERIODIC_SLAB_TIMED_STEPS, None, False, device=dev)
    res["two_gloo_ranks_turns"] = [recs for recs, _ in two]
    res["two_gloo_ranks_turns_s"] = time.perf_counter() - t0
    for r, (recs, bad) in enumerate(two):
        problems += [f"rank {r}: {b}" for b in bad]
        _log_turns(f"configs[4] at ng = {ng}, n = {PERIODIC_SLAB_CHECK_N}, two gloo ranks, "
                   f"rank {r}", recs)

    load = drow.host_load(PERIODIC_SLAB_CHECK_N)
    one = {key: _large_slab_rank(make_mesh(device=where), load, jobs, key)
           for key, where in (("cpu", "cpu"), ("moved", "cpu"), ("card", dev))}
    for lab, *runs in zip(labels, one["cpu"], one["moved"], one["card"]):
        q = [dict(field_energy=r["rows"]["field_energy"],
                  kinetic_energy=r["rows"]["kinetic_energy"],
                  p=r["p"][r["alive"]], v=r["v"][r["alive"]]) for r in runs]
        if not (np.array_equal(runs[0]["alive"], runs[2]["alive"])
                and np.array_equal(runs[0]["alive"], runs[1]["alive"])):
            problems.append(f"{lab} one rank: alive slots differ")
            continue
        chk, bad = _calibrated(f"{lab} one rank ng {ng}", *q, ng,
                               PERIODIC_FLOORS["domain"])
        res.setdefault("check_one_rank", {})[lab] = chk
        problems += bad
        launches.update(runs[2]["large_launches"])
    t0 = time.perf_counter()
    gpus = spawn.run(2, _large_slab_rank, load, jobs, "card", device=dev)
    cpus = spawn.run(2, _large_slab_rank, load, jobs, "cpu", device="cpu")
    res["two_gloo_ranks_s"] = time.perf_counter() - t0
    res["check_two_ranks"] = {}
    for i, lab in enumerate(labels):
        cal = res.get("check_one_rank", {}).get(lab, {})
        rec = {}
        for r, (g, c) in enumerate(zip([x[i] for x in gpus], [x[i] for x in cpus])):
            launches.update(g["large_launches"])
            for k in ("n_dropped", "n_migrated", "n_alive", "picard_iters",
                      "n_halo_clamped"):
                if k in c["rows"] and c["rows"][k] != g["rows"][k]:
                    problems.append(f"{lab} two ranks rank {r}: {k} {c['rows'][k]} "
                                    f"!= {g['rows'][k]}")
            if sum(g["rows"]["n_dropped"]) or not sum(g["rows"]["n_migrated"]):
                problems.append(f"{lab} two ranks rank {r}: dropped "
                                f"{g['rows']['n_dropped']}, migrated {g['rows']['n_migrated']}")
            if not np.array_equal(g["alive"], c["alive"]):
                problems.append(f"{lab} two ranks rank {r}: alive slots differ")
                continue
            for k, a_, b_ in (("field_energy", c["rows"]["field_energy"], g["rows"]["field_energy"]),
                              ("kinetic_energy", c["rows"]["kinetic_energy"],
                               g["rows"]["kinetic_energy"]),
                              ("p", c["p"][c["alive"]], g["p"][g["alive"]]),
                              ("v", c["v"][c["alive"]], g["v"][g["alive"]])):
                gap = _gap(a_, b_, k, ng)
                tol = cal[k]["tol"] if k in cal else PERIODIC_FLOORS["domain"][k]
                rec[f"rank {r} {k}"] = dict(card=gap, tol=tol)
                if not gap <= tol:
                    problems.append(f"{lab} two ranks rank {r} {k} {gap:.3e} > {tol:.3e}")
        res["check_two_ranks"][lab] = rec
        log(f"[large periodic] {lab}, two gloo ranks on the card against two on "
            f"the CPU at ng = {ng}, the one rank's delta_s: " + ", ".join(
                f"{k} {v['card']:.3e} (tol {v['tol']:.3e})" for k, v in rec.items())
            + f"; large-mode launches a rank {[x[i]['large_launches'] for x in gpus]}")
    res["launches"] = dict(launches)
    return res, problems


def _magnetized_large_runs(dev) -> tuple[dict, list]:
    """The configs[3] load (tools/magnetized.run_row) at PERIODIC_PATH_NG,
    fused (row 8's global mode) and composed (the gather and the single
    deposit), PERIODIC_TIMED_STEPS steps after one under sync debug mode
    'error'; the fused row against the CPU and a float64 step
    (_large_grid_check, phase 39's limits, the card's positions
    calibrated)."""
    from pypic_tpu_torch.ops import cuda_cic as K
    from pypic_tpu_torch.tools import magnetized as row

    res, problems = {}, []
    for label, over in (("fused", {}), ("composed", dict(backend="composed"))):
        K.reset_launch_counts()
        out, cfg, fin, m = row.run_row(dev, steps=PERIODIC_TIMED_STEPS, warmup=1,
                                       row="iead", n_per_species=LARGE_GRID_N_PER_SPECIES,
                                       ng=PERIODIC_PATH_NG, **over)
        rec = dict(n=out["n"], ng=PERIODIC_PATH_NG, ms_per_step=out["us_per_step"] / 1e3,
                   launches=out["launches"], large=dict(K.LARGE_LAUNCHES))
        bad = row.population_problems(m)
        if not (bool(torch.isfinite(m.phi).all()) and bool(torch.isfinite(fin.p).all())):
            bad.append("non-finite phi or positions")
        problems += [f"configs[3] {label}: {b}" for b in bad]
        log(f"[large periodic] configs[3] {label} at ng = {PERIODIC_PATH_NG}: n = "
            f"{out['n']}, {rec['ms_per_step']:.3f} ms/step, launches {out['launches']}, "
            f"large modes {rec['large']}")
        del fin, m
        torch.cuda.empty_cache()
        res[label] = rec
    # phase 39's check: rho, phi and v card against CPU at phase 14's
    # limits, the CPU's positions against the float64 step; at 65,536 the
    # float32 Newton stalls at maxiter on both sides (its residual floor),
    # so the CPU stands 0.85 of the limit from float64 and the card's
    # float atomics spread its own gap over 0.15-1.31 from call to call
    # (ROADMAP.md queue 3): the card is held to the float64 step at
    # PERIODIC_CALIBRATED times the CPU's gap
    res["fused"]["check"] = _large_grid_check("iead", PERIODIC_PATH_NG, dev, steps=1,
                                              calibrated=True)
    return res, problems


def phase_large_periodic(dev) -> dict:
    """Phase 41 (module docstring). Returns the kernels' records by shape,
    each path's figures and the large modes' launches on the paths (a
    Counter of "wrapper mode"); fails if a row's large mode never launched
    on a path."""
    from pypic_tpu_torch.ops import cuda_cic as K

    res = {"kernels": periodic_large_kernel_times(dev)}
    res["boundaries"] = mode_boundaries(dev)
    problems, launches = [], collections.Counter()
    res["implicit"], bad = _implicit_large_runs(dev)
    problems += bad
    for rec in res["implicit"].values():
        launches.update(rec["launches"])
    res["explicit"], bad = _explicit_large_runs(dev)
    problems += bad
    for rec in res["explicit"].values():
        launches.update(rec["launches"])
    for key in ("turns", "cluster_range_turns", "cluster_range_turns_f64"):
        for rec in res["explicit"]["fused"][key]:
            launches.update(rec["large"])
    res["domain"], bad = _domain_large_runs(dev)
    problems += bad
    launches.update(res["domain"].pop("launches"))
    res["magnetized"], bad = _magnetized_large_runs(dev)
    problems += bad
    for rec in res["magnetized"].values():
        launches.update(rec["large"])
    K.reset_launch_counts()
    rec, bad = _sheath_large_run("composed", PERIODIC_PATH_NG, PERIODIC_CHECK_N, dev)
    res["sheath_composed"] = dict(rec, large=dict(K.LARGE_LAUNCHES))
    problems += [f"sheath composed ng {PERIODIC_PATH_NG}: {b}" for b in bad]
    launches.update(K.LARGE_LAUNCHES)
    res["launches"] = dict(launches)
    missing = [k for k in PERIODIC_LARGE_ROWS
               if not any(key.split()[0] == k for key in launches)]
    if missing:
        problems.append(f"large modes never launched on a path: {missing}")
    log(f"[large periodic] the large modes' launches on the paths: {res['launches']}")
    if problems:
        raise AssertionError("large periodic: " + "; ".join(problems))
    return res


# phase 42: a float64 state on the double kernels of rows 1-6 (the first
# six of F64_KERNELS; the sheath engine's follow, phase 43)
F64_ROWS = F64_KERNELS[:6]
# (n, ng) of each mode, checked and timed on the same inputs: the shared
# mode at the headline's shape, the global mode at 65,536 nodes
F64_SHAPES = {"shared": (N_HEADLINE, NG), "global": (10_000_000, 65_536)}
# rows 1 and 2 take the cluster mode at 32,768 double nodes (C = 2,
# cuda_cic.cluster_launch), the global mode at 65,536
F64_PASS_SHAPES = {"shared": (N_HEADLINE, NG), "cluster": (10_000_000, 32_768),
                   "global": (10_000_000, 65_536)}
EPS64 = 2.0 ** -52
# the double kernels against their float64 plain versions: the same
# operations rounded once each in double, so positions and velocities
# agree to a few ulps of the largest position (1.5e-11 cells at 65,536)
# and of v; the deposits sum in another order, within a small multiple
# of n eps64 of the largest sum (deposit_tol64)
TOL64_POS = 1e-9
TOL64_V = 1e-12
# the paths, card against the CPU's plain route step for step from one
# float64 state: they differ in the order of the float64 sums (~1e-14 of
# a node sum), which the steps carry into the field and the push; 1e-8
# is 1e4 below the float32 limits of phase 4 (2e-4 cells, 1e-5, 1e-4)
TOL64_STEP = {"p (cells)": 1e-8, "v": 1e-8, "e": 1e-8, "j": 1e-8,
              "field_energy": 1e-8, "kinetic_energy": 1e-8}
# the explicit engine's routes (phase 45) at the same limits, rho in j's
# place
EXP64_STEP = {**{k: v for k, v in TOL64_STEP.items() if k != "j"},
              "rho": TOL64_STEP["j"]}
F64_CHECK_N, F64_CHECK_STEPS, F64_PATH_NGS = 1_000_000, 3, (NG, 65_536)
F64_VARIANTS = {"conserving": {}, "composed": dict(backend="composed"),
                "shared": dict(window_share="shared"),
                "converged-deposit": dict(finalize="converged-deposit")}
# the headline's timed windows a dtype, in turns (float32, float64, ...)
F64_WINDOWS, F64_WINDOW_STEPS = 3, 4


def deposit_tol64(n: int) -> float:
    """Relative limit of a float64 deposit against another order of the
    same float64 sum: a node sums at most 2n terms, each sum rounding by
    eps64 of at most the sum of the terms' magnitudes; 4 n eps64 of the
    largest node."""
    return 4.0 * n * EPS64


def _f64_case(name: str, n: int, ng: int, gen, dev) -> dict:
    """Row ``name``'s double kernel on float64 inputs at (n, ng): against
    its float64 plain version, then timed on the same inputs (device_ms,
    warm), the plain version once, the bound and the library call where
    one exists (float64 index_add_ for the deposit, float64 grid_sample
    for the gather); the launches by mode."""
    from pypic_tpu_torch.ops import cuda_cic as K

    f64 = torch.float64
    errs = {}

    def inputs(rows):
        e, ps, p0, v0 = _random_pass_inputs(rows, gen, dev, True, ng)
        return e.to(f64), ps.to(f64), p0.to(f64), v0.to(f64)

    def calls(e, ps, p0, v0):
        if name in ("picard_iteration", "picard_iteration_shared"):
            shared = name == "picard_iteration_shared"
            fn = K.picard_iteration_shared if shared else K.picard_iteration
            plain = K.picard_iteration_shared_plain if shared else K.picard_iteration_plain
            kw = dict(qm=QM, w=W, dt=DT, dx=DX)
            return (lambda: fn(e, ps, p0, v0, ng, emit_v=True, **kw),
                    lambda: plain(e, ps, p0, v0, ng, emit_v=True, **kw),
                    lambda: fn(e, ps, p0, v0, ng, **kw), lambda: plain(e, ps, p0, v0, ng, **kw))
        if name in ("picard_finalize_nodep", "picard_finalize"):
            dep = name == "picard_finalize"
            fn = K.picard_finalize if dep else K.picard_finalize_nodep
            plain = K.picard_finalize_plain if dep else K.picard_finalize_nodep_plain
            kw = dict(qm=QM, dt=DT, dx=DX, **(dict(w=W) if dep else {}))
            one, ref = (lambda: fn(e, ps, p0, v0, ng, **kw)), (lambda: plain(e, ps, p0, v0, ng, **kw))
            return one, ref, one, ref
        if name == "deposit":
            vals = v0 * W
            one = lambda: K.deposit(p0, vals, ng, periodic=True)  # noqa: E731
            ref = lambda: K.deposit_plain(p0, vals, ng, periodic=True)  # noqa: E731
            return one, ref, one, ref
        one = lambda: K.gather(e, p0, periodic=True)  # noqa: E731
        ref = lambda: K.gather_plain(e, p0, periodic=True)  # noqa: E731
        return one, ref, one, ref

    # the check (edge positions in the first rows)
    args = inputs(n)
    got, ref = (lambda a, b: (a(), b()))(*calls(*args)[:2])
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    if any(t.dtype != f64 for t in got if t.dim() == 1):
        raise AssertionError(f"{name}: the double kernel returned {[t.dtype for t in got]}")
    if name == "deposit":
        for periodic in (True, False):
            pos = args[2] if periodic else args[2] * ((ng - 1) / ng)
            vals = args[3] * W
            a, r = rel_err(K.deposit_plain(pos, vals, ng, periodic=periodic),
                           K.deposit(pos, vals, ng, periodic=periodic))
            errs[f"out periodic={periodic}"] = dict(abs=a, err=r, kind="rel, float64 order",
                                                    tol=deposit_tol64(n))
    elif name == "gather":
        for periodic in (True, False):
            pos = args[2] if periodic else args[2] * ((ng - 1) / ng)
            a, r = rel_err(K.gather_plain(args[0], pos, periodic=periodic),
                           K.gather(args[0], pos, periodic=periodic))
            errs[f"out periodic={periodic}"] = dict(abs=a, err=r, kind="rel", tol=TOL64_V)
    else:
        a = seam_err(ref[0], got[0], ng)
        errs["p"] = dict(abs=a, err=a, kind="cells", tol=TOL64_POS)
        a, r = rel_err(ref[1], got[1])
        errs["v1"] = dict(abs=a, err=r, kind="rel", tol=TOL64_V)
        if name != "picard_finalize_nodep":
            a, r = rel_err(ref[2], got[2])
            errs["deposit"] = dict(abs=a, err=r, kind="rel, float64 order",
                                   tol=deposit_tol64(n))
        if name == "picard_iteration_shared":
            gap = float(abs(int(got[3]) - int(ref[3])))
            errs["n_clamped"] = dict(abs=gap, err=gap, kind=(
                f"count gap ({int(got[3])} clamped of {n})"), tol=0.0)
    torch.cuda.synchronize()
    err = _check(errs, f"{name} float64 (n = {n}, ng = {ng})")
    del got, ref
    _, _, call, plain_call = calls(*args)
    library = None
    if name == "deposit":
        from pypic_tpu_torch.ops.cic import cic_indices_weights

        vals = args[3] * W
        il, ir, wl, wr = cic_indices_weights(args[2], ng, True)
        idx, terms = torch.cat([il, ir]), torch.cat([vals * wl, vals * wr])
        del il, ir, wl, wr
        library = device_ms(lambda: torch.zeros(ng, dtype=f64, device=dev).index_add_(
            0, idx, terms), calls=10)
        del idx, terms
    elif name == "gather":
        lib_call = _gather_library(args[0], args[2], periodic=True)
        library = device_ms(lib_call, calls=10)
        del lib_call
    if name in K.CLUSTER_KERNELS:
        mode = K.cluster_launch(name, n, ng, 132, item=8).mode
    elif name == "deposit":
        mode = ("shared" if K.deposit_launch_shape(n, ng, False, 132, hists=1, item=8).cols
                else "global")
    else:
        mode = K.sweep_launch(name, n, ng, 132, item=8).mode
    node_bytes = 2 * PERIODIC_LARGE_ROWS[name][0] * ng if mode != "shared" else 0.0
    b, by = bound(name, n, extra_bytes=node_bytes, f64=True)
    K.reset_launch_counts()
    ms = device_ms(call, calls=10)
    launches = {"calls": K.LAUNCHES[f"{name}_f64"], **dict(K.LARGE_LAUNCHES)}
    if not K.LAUNCHES[f"{name}_f64"] or K.LAUNCHES[name]:
        raise AssertionError(f"{name} float64: launches {dict(K.LAUNCHES)}")
    plain_ms = cuda_ms(plain_call, reps=1, calls=1)
    rec = dict(n=n, ng=ng, mode=mode, max_abs_err=err, ms=ms, plain_ms=plain_ms,
               bound_ms=b, bound_by=by, library_ms=library, launches_timed=launches)
    log(f"[float64] {name}_f64 at n = {n}, ng = {ng} ({mode} mode): {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {b:.4f} ms ({by})"
        + (f", library {library:.4f} ms" if library is not None else
           ", no single library call computes it") + f"; launches {launches}")
    del args, call, plain_call
    torch.cuda.empty_cache()
    return rec


def _f64_path_check(ng: int, dev) -> tuple[dict, dict, list]:
    """The conserving headline physics in float64 at ng, n = F64_CHECK_N:
    each variant F64_CHECK_STEPS steps on the CPU's plain route from one
    float64 state (the float32 load cast), and one step on the card from
    each of the CPU's states, held at TOL64_STEP; rows whose cell differs
    between the two are left out of p and v (ROADMAP.md queue 3, Fault 3)
    and counted. Returns the gaps, the card's launches a variant (the
    counts from 0 just before its card steps) and the problems."""
    from pypic_tpu_torch import interop
    from pypic_tpu_torch.constants import E_CHARGE, M_ELECTRON
    from pypic_tpu_torch.engines import implicit
    from pypic_tpu_torch.ops import cuda_cic as K
    from pypic_tpu_torch.tools.headline import device_load

    f64 = torch.float64
    cfg0 = headline_config(F64_CHECK_N, ng)
    x, v = device_load(F64_CHECK_N, cfg0.grid.length, torch.device("cpu"))
    d = interop.implicit_state_to_numpy(implicit.init_state(
        x.to(f64), v.to(f64), -E_CHARGE, M_ELECTRON, cfg0, dtype=f64, device="cpu"))
    gaps, launches, problems = {}, {}, []
    for label, over in F64_VARIANTS.items():
        cfg = headline_config(F64_CHECK_N, ng, **over)
        step = implicit.make_step(cfg)
        sc = interop.implicit_state_from_numpy(d, "cpu")
        K.reset_launch_counts()
        rows = []
        for i in range(F64_CHECK_STEPS):
            # the card steps from the CPU's state: one step each, not a
            # chain, so the sums' order is not compounded
            sg, mg = step(interop.implicit_state_from_numpy(
                interop.implicit_state_to_numpy(sc), dev))
            sc, mc = step(sc)
            gp = sg.p.cpu()
            if sg.p.dtype != f64 or sg.e.dtype != f64 or sg.j.dtype != f64:
                problems.append(f"float64 {label} ng {ng}: the card's state turned "
                                f"{sg.p.dtype}")
            moved = torch.floor(gp) != torch.floor(sc.p)
            keep = ~moved
            checks = {
                "p (cells)": seam_err(sc.p[keep], gp[keep], ng),
                "v": rel_err(sc.v[keep], sg.v.cpu()[keep])[1],
                "e": rel_err(sc.e, sg.e.cpu())[1],
                "j": rel_err(sc.j, sg.j.cpu())[1],
                "field_energy": rel_err(mc.field_energy.reshape(1),
                                        mg.field_energy.cpu().reshape(1))[1],
                "kinetic_energy": rel_err(mc.kinetic_energy.reshape(1),
                                          mg.kinetic_energy.cpu().reshape(1))[1]}
            bad = {k: x_ for k, x_ in checks.items() if not x_ <= TOL64_STEP[k]}
            if bad:
                problems.append(f"float64 {label} ng {ng} step {i + 1}: {bad}")
            if int(mc.picard_iters) != int(mg.picard_iters):
                problems.append(f"float64 {label} ng {ng} step {i + 1}: Picard "
                                f"{int(mc.picard_iters)} on the CPU, {int(mg.picard_iters)} "
                                "on the card")
            rows.append(dict(checks, rows_changed_cell=int(moved.sum())))
        torch.cuda.synchronize()
        launches[label] = {k: v_ for k, v_ in K.LAUNCHES.items() if v_}
        launches[label].update({f"large {k}": v_ for k, v_ in K.LARGE_LAUNCHES.items()})
        gaps[label] = rows
        log(f"[float64] {label} ng = {ng}, n = {F64_CHECK_N}, the card one step from each "
            f"of {F64_CHECK_STEPS} CPU states against the CPU's (limits {TOL64_STEP['p (cells)']:.0e} cells, "
            f"{TOL64_STEP['v']:.0e} relative): " + "; ".join(
                ", ".join(f"{k} {x_:.2e}" if isinstance(x_, float) else f"{k} {x_}"
                          for k, x_ in r.items()) for r in rows)
            + f"; card launches {launches[label]}")
        del sc, sg
    return gaps, launches, problems


def _f64_refusals(dev) -> list:
    """A float64 state on the card raises a NotImplementedError naming
    it no gap where the JAX package runs float32 only: the implicit and
    explicit run_resident; the sheath engine and deposit_det, which have
    double kernels (phase 43), the magnetized engine (phase 44) and the
    explicit engine (phase 45) run it and stay float64. Returns what did
    not."""
    import numpy as np

    from pypic_tpu_torch import presets
    from pypic_tpu_torch.constants import E_CHARGE, M_ELECTRON
    from pypic_tpu_torch.engines import explicit, implicit, magnetized, sheath
    from pypic_tpu_torch.grid import GridSpec
    from pypic_tpu_torch.ops import cuda_cic as K

    f64, problems = torch.float64, []
    x = np.linspace(0.0, 0.9, 64)
    v = np.zeros(64)
    grid = GridSpec(16, 1.0, "periodic")
    mcfg = presets.pic_iead(n_per_species=64, device="cpu").config
    scfg = presets.get("sheath_dd", n=64, device="cpu").config
    ecfg = explicit.ExplicitConfig(grid, 1e-9, 1.0)
    cases = {
        "explicit run_resident": lambda: explicit.run_resident(
            ecfg, explicit.init_state(x, v, -E_CHARGE, M_ELECTRON, ecfg, dtype=f64,
                                      device=dev), 2),
        "run_resident": lambda: implicit.run_resident(
            implicit.ImplicitConfig(grid, 1e-9, 1.0), implicit.init_state(
                x, v, -E_CHARGE, M_ELECTRON, implicit.ImplicitConfig(grid, 1e-9, 1.0),
                dtype=f64, device=dev), 2),
    }
    taking = {
        "explicit": lambda: explicit.make_step(ecfg)(explicit.init_state(
            x, v, -E_CHARGE, M_ELECTRON, ecfg, dtype=f64, device=dev))[0].e,
        "sheath": lambda: sheath.init_state(
            x * scfg.grid.length, np.zeros((64, 3)), -E_CHARGE, M_ELECTRON,
            np.zeros(64, np.int32), scfg, dtype=f64, device=dev).j,
        "magnetized": lambda: magnetized.init_state(
            x * mcfg.grid.length, np.zeros((64, 3)), M_ELECTRON, 1.0, 1.0, 0, mcfg,
            dtype=f64, device=dev).phi,
        "deposit_det": lambda: K.deposit_det(
            torch.zeros(64, dtype=f64, device=dev), torch.ones(64, dtype=f64, device=dev),
            16, periodic=True),
    }
    for what, call in cases.items():
        try:
            call()
            problems.append(f"{what}: a float64 state on the card ran")
        except NotImplementedError as err:
            if "item 19" not in str(err) or "no gap" not in str(err):
                problems.append(f"{what}: {err} names it no gap")
            else:
                log(f"[float64] {what} refuses float64 on the card: {err}")
    for what, call in taking.items():
        out = call()
        if out.dtype != f64 or out.device.type != "cuda":
            problems.append(f"{what}: float64 on the card gave {out.dtype} on {out.device}")
        else:
            log(f"[float64] {what} takes float64 on the card (ROADMAP item 19a, 19b "
                "or 19c)")
    return problems


def phase_float64(dev) -> dict:
    """Phase 42 (module docstring). Returns the double kernels' records
    by mode, the path checks and launches, the headline's ms/step in both
    dtypes; fails on a disagreement, on a float64 kernel that never
    launched on its path, or on a refusal that did not raise."""
    import dataclasses

    from pypic_tpu_torch.engines import implicit
    from pypic_tpu_torch.ops import cuda_cic as K
    from pypic_tpu_torch.runner import run

    gen = torch.Generator(device=dev).manual_seed(42)
    res = {"kernels": {}}
    for name in F64_ROWS:
        shapes = F64_PASS_SHAPES if name in K.CLUSTER_KERNELS else F64_SHAPES
        for mode, (n, ng) in shapes.items():
            rec = _f64_case(name, n, ng, gen, dev)
            if rec["mode"] != mode:
                raise AssertionError(f"{name} float64 at ng {ng}: mode {rec['mode']}")
            res["kernels"].setdefault(name, {})[mode] = rec
    problems = []
    res["check"], res["check_launches"] = {}, {}
    for ng in F64_PATH_NGS:
        gaps, launches, bad = _f64_path_check(ng, dev)
        res["check"][f"ng {ng}"], res["check_launches"][f"ng {ng}"] = gaps, launches
        problems += bad

    # the headline cell at n = N_HEADLINE in both dtypes, timed in turns
    states, steps, windows, launches = {}, {}, {"float32": [], "float64": []}, {}
    for label, dtype in (("float32", torch.float32), ("float64", torch.float64)):
        K.reset_launch_counts()
        cfg, steps[label], states[label] = headline_state(N_HEADLINE, dev, dtype=dtype)
        states[label], _ = run(steps[label], states[label], 1)
        torch.cuda.synchronize()
        launches[label] = dict(K.LAUNCHES)
    for _ in range(F64_WINDOWS):
        for label in windows:
            K.reset_launch_counts()
            t0 = time.perf_counter()
            states[label], m = run(steps[label], states[label], F64_WINDOW_STEPS)
            torch.cuda.synchronize()
            windows[label].append((time.perf_counter() - t0) * 1e3 / F64_WINDOW_STEPS)
            for k, v_ in K.LAUNCHES.items():
                launches[label][k] += v_
            if m.picard_iters.tolist() != [4] * F64_WINDOW_STEPS:
                problems.append(f"headline {label}: Picard {m.picard_iters.tolist()}")
    for label, st in states.items():
        if not (bool(torch.isfinite(st.p).all()) and bool(torch.isfinite(st.e).all())):
            problems.append(f"headline {label}: non-finite state")
    if states["float64"].p.dtype != torch.float64:
        problems.append(f"headline float64: the state turned {states['float64'].p.dtype}")
    res["headline"] = {label: dict(ms_per_step=statistics.median(w), windows=w,
                                   launches={k: v_ for k, v_ in launches[label].items() if v_})
                       for label, w in windows.items()}
    log(f"[float64] headline n = {N_HEADLINE}, ng = {NG}, conserving: float32 "
        f"{res['headline']['float32']['ms_per_step']:.4f} ms/step (windows "
        + ", ".join(f"{w:.4f}" for w in windows["float32"]) + "), float64 "
        f"{res['headline']['float64']['ms_per_step']:.4f} ms/step (windows "
        + ", ".join(f"{w:.4f}" for w in windows["float64"]) + f") in turns of "
        f"{F64_WINDOW_STEPS} steps after set-up and one; launches "
        f"{res['headline']['float64']['launches']}")
    del states, steps
    torch.cuda.empty_cache()

    # each double kernel's launches on its path: the headline's for the
    # pass, the finalize and the set-up deposit, the ng = 200 checks' for
    # the shared window, converged-deposit and composed (gather)
    at = res["check_launches"][f"ng {NG}"]
    path = {"picard_iteration": res["headline"]["float64"]["launches"],
            "picard_finalize_nodep": res["headline"]["float64"]["launches"],
            "deposit": res["headline"]["float64"]["launches"],
            "picard_iteration_shared": at["shared"], "picard_finalize": at["converged-deposit"],
            "gather": at["composed"]}
    res["launches"] = {name: path[name].get(f"{name}_f64", 0) for name in F64_ROWS}
    missing = [name for name, c in res["launches"].items() if not c]
    if missing:
        problems.append(f"float64 kernels never launched on their paths: {missing}")
    if any(res["headline"]["float64"]["launches"].get(name) for name in F64_ROWS):
        problems.append("the float64 headline launched a float32 kernel: "
                        f"{res['headline']['float64']['launches']}")
    big = res["check_launches"]["ng 65536"]
    res["global_launches"] = {label: {k: v_ for k, v_ in c.items() if k.startswith("large")}
                              for label, c in big.items()}
    if not all(res["global_launches"].values()):
        problems.append(f"float64 at 65,536: no global-mode launch {res['global_launches']}")
    log(f"[float64] the double kernels' launches on their paths {res['launches']}; "
        f"global-mode launches at 65,536 {res['global_launches']}")
    problems += _f64_refusals(dev)
    if problems:
        raise AssertionError("float64: " + "; ".join(problems))
    return res


# phase 43: the sheath engine's float64 state on its double kernels
SHEATH64_ROWS = ("sheath_picard", "sheath_finalize", "deposit_det", "sheath_reinject")
# (n, ng) of each kernel's checks and times: the configs[2] shape (and the
# exit histograms' 128 nodes for deposit_det), then the large mode at the
# first node above the double ceiling (cuda_sheath.MAX_NG_F64 = 880, the
# deposit's 907), at 8,192 and at 65,536
SHEATH64_SHAPES = {
    "sheath_picard": ((N_SHEATH, NG_SHEATH), (N_SHEATH, 881), (N_SHEATH, 8192),
                      (10_000_000, 65_536)),
    "sheath_finalize": ((N_SHEATH, NG_SHEATH), (N_SHEATH, 881), (N_SHEATH, 8192),
                        (10_000_000, 65_536)),
    "deposit_det": ((N_SHEATH, NG_SHEATH), (N_SHEATH, 128), (N_SHEATH, 908),
                    (N_SHEATH, 8192), (10_000_000, 65_536)),
}
# the record that stands for a kernel's small and large modes in the
# kernels line
SHEATH64_MAIN = f"n {N_SHEATH}, ng {NG_SHEATH}"
SHEATH64_LARGE_MAIN = "n 10000000, ng 65536"
# nodes of a large-mode current whose two-word sums are held to math.fsum
SHEATH64_FSUM_NODES = 8
# the re-injection's velocities against its float64 plain version: the
# float32 normals from libdevice's logf, sinf and cosf against the CPU's
# float64 functions rounded once (phase 16's float32 limit), times the
# float64 sigmas
TOL64_REINJECT_V = 1e-6
# the float64 hash normals against the plain version's, in float64 ulps
# of each value
HASH64_ULPS = 4.0
# the configs[2] row in float64: steps on the CPU, the card one step from
# each; the card's step against the CPU's. On the Philox sampler the
# re-injected rows' float32 normals differ by float32 ulps (libdevice
# against the CPU's float64 functions rounded once): 4 ulps of the
# largest normal (~5.5) times sigma (1.3e6 m/s) and dt/dx (1e-7) is
# 1.7e-7 cells of x1, 1e-6 of u
SHEATH64_ROW_STEPS = 20
SHEATH64_STEP = {"p (cells)": 2e-7, "u": 1e-6, "e": 1e-7, "j": 1e-7, "phi": 1e-7}
SHEATH64_HASH_STEPS = 5
SHEATH64_STEP_HASH = {"p (cells)": 1e-9, "u": 1e-10, "e": 1e-10, "j": 1e-10,
                      "phi": 1e-10}
# phase 40's loads in both dtypes: steps on the card each
SHEATH64_LARGE_STEPS = 5


def _sheath64_pass_case(name: str, n: int, ng: int, gen, dev, timed: bool) -> dict:
    """The double pass or finalize at (n, ng) on _sheath_inputs in float64:
    the outputs bit-equal to the float64 plain version's, the current
    within deposit_tol64(n) of its (small mode) or bit-equal to the
    two-word twin and within 2 ulps + n 2^-(k+L+1) of math.fsum on
    sampled nodes (large mode), the same bits over three calls; then
    timed beside the float32 kernel on the same inputs cast."""
    from pypic_tpu_torch.ops import cuda_cic as K
    from pypic_tpu_torch.ops import cuda_sheath as S

    f64, kw = torch.float64, dict(dt=SHEATH_DT, dx=SHEATH_DX)
    args32 = _sheath_inputs(n, ng, gen, dev)
    args = tuple(a.to(f64) for a in args32)
    final = name == "sheath_finalize"
    fn = S.sheath_finalize if final else S.sheath_picard
    plain = S.sheath_finalize_plain if final else S.sheath_picard_plain
    K.reset_launch_counts()
    got = [fn(*args, **kw) for _ in range(3)]
    torch.cuda.synchronize()
    large = ng > S.MAX_NG_F64
    errs = {}
    if K.LAUNCHES[f"{name}_f64"] != 3 or K.LAUNCHES[name]:
        raise AssertionError(f"{name} float64: launches {dict(K.LAUNCHES)}")
    if any(t.dtype != f64 for t in got[0]):
        raise AssertionError(f"{name} float64: outputs {[t.dtype for t in got[0]]}")
    same = all(torch.equal(g[-1], got[0][-1]) for g in got[1:])
    errs["j call to call"] = dict(abs=0.0 if same else 1.0, err=0.0 if same else 1.0,
                                  kind="bit-equal over three calls", tol=0.0)
    ref = plain(*args, **kw)
    outs = all(torch.equal(g, r) for g, r in zip(got[0][:-1], ref[:-1]))
    errs["outputs"] = dict(abs=0.0 if outs else 1.0, err=0.0 if outs else 1.0,
                           kind="bit-equal to the float64 plain version", tol=0.0)
    x1, u1, xh, uh, _ = S._push_plain(args[0], args[1], args[2], args[3], args[4],
                                      args[6], SHEATH_DT, SHEATH_DX)
    pos, vals = (x1, u1) if final else (xh, uh)
    at, val = S.sheath_deposit_args_plain(pos, vals, ref[-2], args[5], ng, **kw)
    del x1, u1, xh, uh
    j = got[0][-1]
    rec = _sheath64_current(errs, j, at, val, ng, n, large, ref[-1])
    del at, val, pos, vals, ref
    rec["max_abs_err"] = _check(errs, f"{name} float64 (n = {n}, ng = {ng})")
    rec.update(n=n, ng=ng, mode="large" if large else "small")
    if timed:
        rec.update(_sheath64_timed(name, n, ng, fn, plain, args, args32, kw, large))
    del got, args, args32
    torch.cuda.empty_cache()
    return rec


def _sheath64_current(errs: dict, j, at, val, ng: int, n: int, large: bool,
                      ref_j) -> dict:
    """The checks of a double deterministic current j (the deposit of the
    values ``val`` at ``at``, bounded) into ``errs``: within
    deposit_tol64(n) of the plain float64 deposit ``ref_j``; the large mode
    also bit-equal to the two-word twin and within 2 ulps + n 2^-(k+L+1)
    of math.fsum at SHEATH64_FSUM_NODES nodes and more (the walls and the
    fullest node among them). Returns the figures."""
    from pypic_tpu_torch.ops import cuda_cic as K

    a, r = rel_err(ref_j, j)
    errs["j"] = dict(abs=a, err=r, kind="rel to the float64 plain version, float64 order",
                     tol=deposit_tol64(n))
    if not large:
        return dict(j_rel_err=r)
    nodes, terms = K.deposit_terms_plain(at, val, ng, periodic=False)
    twin = K.fixed2_sum_plain(nodes, terms, ng, n)
    bits = torch.equal(twin, j)
    errs["j two-word twin"] = dict(abs=0.0 if bits else 1.0, err=0.0 if bits else 1.0,
                                   kind="bit-equal to the int64 two-word twin", tol=0.0)
    m = float(terms.abs().max())
    k = 62 - math.frexp(2.0 * n * m)[1]
    quantum = n * 2.0 ** -(k + K.fixed2_bits(n) + 1)
    counts = torch.bincount(nodes, minlength=ng)
    pick = torch.Generator().manual_seed(ng)
    picks = sorted({0, ng - 1, int(torch.argmax(counts))}
                   | set(torch.randint(0, ng, (SHEATH64_FSUM_NODES,), generator=pick).tolist()))
    worst = 0.0
    for node in picks:
        exact = math.fsum(terms[nodes == node].tolist())
        gap = abs(float(j[node]) - exact)
        worst = max(worst, gap / (2.0 * math.ulp(exact) + quantum))
    errs["j against math.fsum"] = dict(
        abs=worst, err=worst, kind=f"of 2 ulps + n 2^-(k+L+1) at {len(picks)} nodes",
        tol=1.0)
    return dict(j_rel_err=r, fsum_nodes=len(picks), fsum_worst_of_limit=worst,
                quantum=quantum, twin_bit_equal=bits)


def _sheath64_timed(name: str, n: int, ng: int, fn, plain, args, args32, kw,
                    large: bool) -> dict:
    """device_ms of the double kernel on rotating copies of ``args``, the
    float32 kernel on ``args32``, the plain version once, and the bound:
    the function's bytes alone, each row read once and the field and the
    current once a node (LARGE_NODE_BYTES in double), as the float32
    large modes are bounded. The large mode's own traffic, the two-word
    sums' 16 B a node and the scale sweep's second read of the rows, is
    reported beside it (``design_bytes_ms``), not in it."""
    ms = statistics.median(device_ms(_rotating(fn, args, **kw)) for _ in range(3))
    f32_ms = device_ms(_rotating(fn, args32, **kw))
    plain_ms = cuda_ms(lambda: plain(*args, **kw), reps=1, calls=1)
    b, by = bound(name, n, extra_bytes=2.0 * LARGE_NODE_BYTES[name] * ng, f64=True)
    mode = "large (two-word fixed point)" if large else "small (thread columns)"
    rec = dict(n=n, ng=ng, mode="large" if large else "small", ms=ms,
               float32_ms=f32_ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
               library_ms=None)
    design = ""
    if large:
        rows = 6 if name != "deposit_det" else 2  # the scale sweep's reads, 8 B each
        own = 16.0 * ng + 8.0 * rows * n
        rec["design_bytes_ms"] = bound(name, n, extra_bytes=2.0 * LARGE_NODE_BYTES[name] * ng
                                       + own, f64=True)[0]
        design = (f"; with the design's own sums and scale sweep "
                  f"{rec['design_bytes_ms']:.4f} ms")
    log(f"[sheath float64] {name}_f64 at n = {n}, ng = {ng}, {mode}: {ms:.4f} ms "
        f"(float32 kernel {f32_ms:.4f} ms), plain {plain_ms:.4f} ms, bound "
        f"{b:.4f} ms ({by}){design}")
    return rec


def _deposit64_case(n: int, ng: int, gen, dev, timed: bool) -> dict:
    """The double deposit_det at (n, ng): bounded rows and values, the
    current's checks (_sheath64_current), the same bits over three calls;
    timed beside the float32 kernel and float64 index_add_ of the same
    terms (its library call)."""
    from pypic_tpu_torch.ops import cuda_cic as K
    from pypic_tpu_torch.ops import cuda_sheath as S

    p32 = torch.rand(n, generator=gen, device=dev) * (ng - 1)
    v32 = torch.randn(n, generator=gen, device=dev) * 1e3
    p, v = p32.double(), v32.double()
    K.reset_launch_counts()
    got = [K.deposit_det(p, v, ng, periodic=False) for _ in range(3)]
    torch.cuda.synchronize()
    if K.LAUNCHES["deposit_det_f64"] != 3 or K.LAUNCHES["deposit_det"]:
        raise AssertionError(f"deposit_det float64: launches {dict(K.LAUNCHES)}")
    large = ng > 907
    errs = {}
    same = all(torch.equal(g, got[0]) for g in got[1:]) and got[0].dtype == torch.float64
    errs["out call to call"] = dict(abs=0.0 if same else 1.0, err=0.0 if same else 1.0,
                                    kind="float64, bit-equal over three calls", tol=0.0)
    rec = _sheath64_current(errs, got[0], p, v, ng, n, large,
                            K.deposit_plain(p, v, ng, periodic=False))
    rec["max_abs_err"] = _check(errs, f"deposit_det float64 (n = {n}, ng = {ng})")
    rec.update(n=n, ng=ng, mode="large" if large else "small")
    if timed:
        fn = lambda a, b: K.deposit_det(a, b, ng, periodic=False)  # noqa: E731
        plain = lambda a, b: K.deposit_plain(a, b, ng, periodic=False)  # noqa: E731
        rec.update(_sheath64_timed("deposit_det", n, ng, fn, plain, (p, v), (p32, v32),
                                   {}, large))
        nodes, terms = K.deposit_terms_plain(p, v, ng, periodic=False)
        rec["library_ms"] = device_ms(lambda: torch.zeros(
            ng, dtype=torch.float64, device=dev).index_add_(0, nodes, terms))
        log(f"[sheath float64]   deposit_det_f64 library call index_add_ (float64) "
            f"{rec['library_ms']:.4f} ms")
        del nodes, terms
    del got, p, v, p32, v32
    torch.cuda.empty_cache()
    return rec


def _reinject64_case(dev) -> dict:
    """The double sheath_reinject at n = 1e6, gamma 0 and 0.5, the row's
    mix and 80/10/10: positions and held rows bit-equal to the float64
    plain version, velocities within TOL64_REINJECT_V of the largest;
    timed at gamma 0 beside the float32 kernel and torch.rand((5, n)) in
    float64."""
    from pypic_tpu_torch.ops import cuda_cic as K
    from pypic_tpu_torch.ops import cuda_rng

    gen = torch.Generator(device=dev).manual_seed(31)
    n = N_SHEATH
    p, v, sig, mixes = _reinject_inputs(n, gen, dev)
    key, step = (0, 3), 11
    recs = {}
    for mix, act in mixes.items():
        args32 = (p, v[0], v[1], v[2], act, sig)
        args = tuple(a.double() for a in args32)
        for gamma in (0.0, 0.5):
            K.reset_launch_counts()
            got = cuda_rng.sheath_reinject(key, step, *args, cells=50.0, gamma=gamma)
            ref = cuda_rng.sheath_reinject_plain(key, step, *args, cells=50.0, gamma=gamma)
            torch.cuda.synchronize()
            if K.LAUNCHES["sheath_reinject_f64"] != 1 or K.LAUNCHES["sheath_reinject"]:
                raise AssertionError(f"sheath_reinject float64: {dict(K.LAUNCHES)}")
            errs = {}
            pos = torch.equal(got[0], ref[0]) and got[0].dtype == torch.float64
            errs["p"] = dict(abs=0.0 if pos else 1.0, err=0.0 if pos else 1.0,
                             kind="float64, bit-equal", tol=0.0)
            for label, g, r in zip(("u", "vy", "vz"), got[1:], ref[1:]):
                a, rr = rel_err(r, g)
                errs[label] = dict(abs=a, err=rr, kind="rel", tol=TOL64_REINJECT_V)
            drawn = act != 1.0
            if gamma == 0.0:
                held = all(torch.equal(g[~drawn], x[~drawn])
                           for g, x in zip(got, args[:4]))
                errs["held rows"] = dict(abs=0.0 if held else 1.0, err=0.0 if held else 1.0,
                                         kind="bit-equal to their inputs", tol=0.0)
            err = _check(errs, f"sheath_reinject float64 ({mix}, gamma {gamma})")
            if gamma == 0.0:
                drawing = int(drawn.sum())
                fn = lambda *a: cuda_rng.sheath_reinject(key, step, *a, cells=50.0)  # noqa: E731
                ms = statistics.median(device_ms(_rotating(fn, args)) for _ in range(3))
                f32_ms = device_ms(_rotating(fn, args32))
                plain_ms = cuda_ms(lambda: cuda_rng.sheath_reinject_plain(
                    key, step, *args, cells=50.0), reps=1, calls=1)
                b, by = bound("sheath_reinject", n, f64=True,
                              extra_bytes=2 * REINJECT_DRAW_BYTES * drawing,
                              extra_ops=REINJECT_DRAW_OPS * drawing)
                recs[mix] = dict(n=n, drawing_rows=drawing, ms=ms, float32_ms=f32_ms,
                                 plain_ms=plain_ms, bound_ms=b, bound_by=by,
                                 max_abs_err=err)
                log(f"[sheath float64] sheath_reinject_f64 at the {mix} mix ({drawing} "
                    f"rows drawn): {ms:.4f} ms (float32 kernel {f32_ms:.4f} ms), plain "
                    f"{plain_ms:.4f} ms, bound {b:.4f} ms ({by})")
            del got, ref
    g = torch.Generator(device=dev).manual_seed(5)
    lib = device_ms(_rotating(lambda: torch.rand((5, n), device=dev, generator=g,
                                                 dtype=torch.float64), ()))
    log(f"[sheath float64] sheath_reinject_f64: library call torch.rand((5, n), "
        f"float64) {lib:.4f} ms")
    rec = dict(recs["80/10/10"], library_ms=lib, row_mix=recs["row"])
    del p, v, sig, mixes
    torch.cuda.empty_cache()
    return rec


def _hash64_case(dev) -> dict:
    """The float64 hash_batch at HASH_SHAPES: the uniforms bit-equal to the
    plain version's, the normals within HASH64_ULPS float64 ulps of each;
    timed beside the float32 kernel and torch.rand in float64."""
    from pypic_tpu_torch.ops import cuda_cic as K
    from pypic_tpu_torch.ops import cuda_rng

    f64, out = torch.float64, {}
    for n, streams, normals in HASH_SHAPES:
        seed, off = 0x2545F491, n
        K.reset_launch_counts()
        uni = cuda_rng.hash_batch(seed, n, streams, offset=off, device=dev, dtype=f64)
        z = cuda_rng.hash_batch(seed, n, streams, offset=off, normals=True, device=dev,
                                dtype=f64) if streams % 2 == 0 else None
        torch.cuda.synchronize()
        if not K.LAUNCHES["hash_batch_f64"] or K.LAUNCHES["hash_batch"]:
            raise AssertionError(f"hash_batch float64: launches {dict(K.LAUNCHES)}")
        ref = cuda_rng.hash_uniforms_plain(seed, n, streams, off, dev, f64)
        errs = {}
        bits = uni.dtype == f64 and torch.equal(uni, ref)
        errs["uniforms"] = dict(abs=0.0 if bits else 1.0, err=0.0 if bits else 1.0,
                                kind="float64, bit-equal", tol=0.0)
        if z is not None:
            zr = cuda_rng.hash_normals_from_uniforms(ref)
            spacing = torch.from_numpy(__import__("numpy").spacing(
                zr.abs().cpu().numpy())).to(dev)
            ulps = float(((z - zr).abs() / spacing).max())
            errs["normals"] = dict(abs=ulps, err=ulps, kind="float64 ulps of each",
                                   tol=HASH64_ULPS)
        err = _check(errs, f"hash_batch float64 {streams} x {n}")
        held = collections.deque(maxlen=4)
        ms = device_ms(lambda: held.append(cuda_rng.hash_batch(
            7, n, streams, offset=n, normals=normals, device=dev, dtype=f64)))
        f32_ms = device_ms(lambda: held.append(cuda_rng.hash_batch(
            7, n, streams, offset=n, normals=normals, device=dev)))
        plain_ms = cuda_ms(lambda: held.append(cuda_rng.hash_batch_plain(
            7, n, streams, n, normals, dev, f64)), reps=3, calls=3)
        lib_ms = device_ms(lambda: held.append(torch.rand((streams, n), device=dev,
                                                          dtype=f64)))
        b, by = hash_bound(n, streams, normals, item=8)
        out[f"{streams}x{n}"] = dict(n=n, streams=streams, normals=normals,
                                     max_abs_err=err, ms=ms, float32_ms=f32_ms,
                                     plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b,
                                     bound_by=by)
        log(f"[sheath float64] hash_batch_f64 {streams} x {n}"
            f"{' normals' if normals else ' uniforms'}: {ms:.4f} ms (float32 kernel "
            f"{f32_ms:.4f} ms), plain {plain_ms:.4f} ms, torch.rand float64 "
            f"{lib_ms:.4f} ms, bound {b:.4f} ms ({by})")
        held.clear()
    return out


def _sheath64_state(d: dict) -> dict:
    """A numpy sheath state with its float32 fields cast to float64."""
    import numpy as np

    return {k: v.astype(np.float64) if getattr(v, "dtype", None) == np.float32 else v
            for k, v in d.items()}


def _sheath64_row(label: str, dev, steps: int, limits: dict, **over) -> tuple[dict, list]:
    """The configs[2] row in float64 (tools/sheath.py state cast after x /
    dx) with ``over``: ``steps`` steps on the CPU's float64 route from its
    initial state; from each CPU state one card step, against the CPU's
    next state (``limits``, statuses and Picard passes equal). The launch
    counts run from 0 just before the card steps and are read after."""
    import dataclasses

    from pypic_tpu_torch import interop
    from pypic_tpu_torch.engines import sheath
    from pypic_tpu_torch.ops import cuda_cic as K
    from pypic_tpu_torch.tools import sheath as srow

    cfg = dataclasses.replace(srow.config(), **over)
    _, sc = srow.state("cpu", cfg=cfg, dtype=torch.float64)
    step = sheath.make_step(cfg)
    rows, problems, passes = [], [], []
    K.reset_launch_counts()
    t0 = time.perf_counter()
    for i in range(steps):
        d = interop.sheath_state_to_numpy(sc)
        g = step(interop.sheath_state_from_numpy(d, dev))
        c = step(sc)
        sc = c[0]
        if any(getattr(g[0], k).dtype != torch.float64 for k in ("p", "u", "e", "j")):
            problems.append(f"{label} step {i}: the card's state left float64")
        errs = _sheath_step_errors(c, g)
        bad = {k: v_ for k, v_ in errs.items() if not v_ <= limits[k]}
        if int(c[1].picard_iters) != int(g[1].picard_iters):
            bad["picard"] = (int(c[1].picard_iters), int(g[1].picard_iters))
        if not torch.equal(c[0].active, g[0].active.cpu()):
            bad["statuses"] = int((c[0].active != g[0].active.cpu()).sum())
        if bad:
            problems.append(f"{label} step {i}: {bad}")
        passes.append(int(g[1].picard_iters))
        rows.append(errs)
        del g, c
    torch.cuda.synchronize()
    launches = {k: v_ for k, v_ in K.LAUNCHES.items() if v_}
    worst = {k: max(r[k] for r in rows) for k in rows[0]}
    log(f"[sheath float64] configs[2] row {label} (n = {srow.N}, float64): the card one "
        f"step from each of {steps} CPU states against the CPU's next ({time.perf_counter() - t0:.1f} s): "
        + ", ".join(f"{k} {v_:.3e} (tol {limits[k]:.0e})" for k, v_ in worst.items())
        + f"; Picard passes a step {statistics.fmean(passes):.2f} (max {max(passes)}); "
        f"card launches {launches}")
    if any(k.split("_f64")[0] == k for k in launches):
        problems.append(f"{label}: a float32 kernel launched {launches}")
    return dict(steps=steps, worst=worst, passes=passes, launches=launches), problems


def _sheath64_large(dev) -> tuple[dict, list]:
    """Phase 40's loads (SHEATH_LARGE_RUNS) in float64 and float32 on the
    card, SHEATH64_LARGE_STEPS steps each from the preset's state: Picard
    passes a step and steps at maxiter in both dtypes, ms/step; one
    float64 step from the card's last state on the CPU against the card
    (Picard passes and statuses equal, SHEATH64_STEP limits)."""
    import dataclasses

    from pypic_tpu_torch import interop, presets
    from pypic_tpu_torch.engines import sheath
    from pypic_tpu_torch.ops import cuda_cic as K
    from pypic_tpu_torch.runner import run

    out, problems = {}, []
    for label, (backend, ng, n) in SHEATH_LARGE_RUNS.items():
        pre = presets.sheath_dd(n=n, ng=ng, device=dev)
        cfg = dataclasses.replace(pre.config, backend=backend)
        d32 = interop.sheath_state_to_numpy(pre.state)
        del pre
        step = sheath.make_step(cfg)
        rec = {}
        for dname, d in (("float64", _sheath64_state(d32)), ("float32", d32)):
            st = interop.sheath_state_from_numpy(d, dev)
            torch.cuda.synchronize()
            K.reset_launch_counts()
            t0 = time.perf_counter()
            fin, m = run(step, st, SHEATH64_LARGE_STEPS)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            iters = m.picard_iters.cpu()
            rec[dname] = dict(picard=iters.tolist(), picard_mean=float(iters.float().mean()),
                              steps_at_maxiter=int((iters == cfg.maxiter).sum()),
                              ms_per_step=secs * 1e3 / SHEATH64_LARGE_STEPS,
                              launches={k: v_ for k, v_ in K.LAUNCHES.items() if v_},
                              large={k: v_ for k, v_ in K.LARGE_LAUNCHES.items()})
            problems += [f"{label} {dname}: {b}" for b in _sheath_population(m, n)]
            if dname == "float64":
                if fin.p.dtype != torch.float64:
                    problems.append(f"{label}: the float64 state turned {fin.p.dtype}")
                dl = interop.sheath_state_to_numpy(fin)
            del fin, m, st
        c = step(interop.sheath_state_from_numpy(dl, "cpu"))
        g = step(interop.sheath_state_from_numpy(dl, dev))
        errs = _sheath_step_errors(c, g)
        bad = {k: v_ for k, v_ in errs.items() if not v_ <= SHEATH64_STEP[k]}
        if int(c[1].picard_iters) != int(g[1].picard_iters):
            bad["picard"] = (int(c[1].picard_iters), int(g[1].picard_iters))
        if not torch.equal(c[0].active, g[0].active.cpu()):
            bad["statuses"] = int((c[0].active != g[0].active.cpu()).sum())
        if bad:
            problems.append(f"{label} float64 card against CPU: {bad}")
        rec["check"] = dict(errors=errs, picard=(int(c[1].picard_iters),
                                                 int(g[1].picard_iters)))
        out[label] = rec
        log(f"[sheath float64] {label}, n = {n}: Picard passes a step float64 "
            f"{rec['float64']['picard']} ({rec['float64']['steps_at_maxiter']} at maxiter "
            f"{cfg.maxiter}, {rec['float64']['ms_per_step']:.3f} ms/step) against "
            f"float32 {rec['float32']['picard']} ({rec['float32']['steps_at_maxiter']} at "
            f"maxiter, {rec['float32']['ms_per_step']:.3f} ms/step); float64 launches "
            f"{rec['float64']['launches']}, large modes {rec['float64']['large']}; one "
            "float64 step card against CPU: "
            + ", ".join(f"{k} {v_:.3e}" for k, v_ in errs.items())
            + f", Picard (CPU, card) {rec['check']['picard']}")
        del c, g, d32, dl
        torch.cuda.empty_cache()
    return out, problems


def phase_sheath_float64(dev) -> dict:
    """Phase 43 (module docstring). Returns the double kernels' records
    by shape, the row's checks and launches and the large loads' Picard
    passes; fails on a disagreement or on a double kernel that never
    launched on its path."""
    gen = torch.Generator(device=dev).manual_seed(43)
    res = {"kernels": {}}
    for name, shapes in SHEATH64_SHAPES.items():
        for n, ng in shapes:
            shape = f"n {n}, ng {ng}"
            timed = shape in (SHEATH64_MAIN, SHEATH64_LARGE_MAIN)
            rec = (_deposit64_case(n, ng, gen, dev, timed) if name == "deposit_det"
                   else _sheath64_pass_case(name, n, ng, gen, dev, timed))
            res["kernels"].setdefault(name, {})[shape] = rec
    res["kernels"]["sheath_reinject"] = {SHEATH64_MAIN: _reinject64_case(dev)}
    res["hash_batch"] = _hash64_case(dev)
    problems, res["row"] = [], {}
    for label, steps, limits, over in (
            ("fused", SHEATH64_ROW_STEPS, SHEATH64_STEP, dict(backend="fused")),
            ("composed", SHEATH64_ROW_STEPS, SHEATH64_STEP, dict(backend="composed")),
            ("fused hash", SHEATH64_HASH_STEPS, SHEATH64_STEP_HASH,
             dict(backend="fused", rng_sampler="hash"))):
        res["row"][label], bad = _sheath64_row(label, dev, steps, limits, **over)
        problems += bad
    res["large"], bad = _sheath64_large(dev)
    problems += bad
    row = res["row"]
    res["launches"] = {
        "sheath_picard": row["fused"]["launches"].get("sheath_picard_f64", 0),
        "sheath_finalize": row["fused"]["launches"].get("sheath_finalize_f64", 0),
        "sheath_reinject": row["fused"]["launches"].get("sheath_reinject_f64", 0),
        "deposit_det": row["composed"]["launches"].get("deposit_det_f64", 0),
        "hash_batch": row["fused hash"]["launches"].get("hash_batch_f64", 0)}
    missing = [k for k, v_ in res["launches"].items() if not v_]
    large = collections.Counter()
    for rec in res["large"].values():
        large.update(rec["float64"]["large"])
    res["large_launches"] = dict(large)
    for k in ("sheath_picard_f64 fixed", "sheath_finalize_f64 fixed", "deposit_det_f64 fixed"):
        if not large.get(k):
            missing.append(k)
    if missing:
        problems.append(f"double kernels never launched on their paths: {missing}")
    log(f"[sheath float64] the double kernels' launches on their paths {res['launches']}; "
        f"large modes on phase 40's loads {res['large_launches']}")
    if problems:
        raise AssertionError("sheath float64: " + "; ".join(problems))
    return res


# phase 44: the magnetized engine's float64 state on its double kernels
# (ROADMAP item 19b): rows 7-9 (deposit2, the fused push, the carried
# deposit) and the Newton solves (rows 22, 23) in double
MAG64_ROWS = ("deposit2", "boris_gather_push", "boris_gather_push_deposit",
              "boltzmann_dirichlet", "boltzmann_dn")
# (n, ng) of rows 7-9's checks and times: the configs[3] row, and the
# large modes at n = 1e7, ng 65,536
MAG64_SHAPES = {"configs[3]": (N_MAG, NG_MAG), "large": (10_000_000, 65_536)}
MAG64_MAIN, MAG64_LARGE_MAIN = "configs[3]", "large"
# the Newton solves: the configs[3] row's (D-D, ng 600) and the D-N row's
# (ng 800) first solves from their float64 loads, then the large path at
# MAG64_NEWTON_ROWS rows: a first solve at the row's tol and an 8-iteration
# solve at tol 0
MAG64_NEWTON_ROWS = (1025, 4096, 16_384)
MAG64_LARGE_NEWTON_MAIN = 16_384
# the Newton kernels against their float64 plain versions on the card, phi
# relative to its largest: the same PCR and partition order in float64,
# libdevice's exp against PyTorch's (the CPU tests read 1e-15 and less)
TOL64_NEWTON = 1e-12
# card against CPU, one float64 step from each CPU state (the CPU's
# float64 route: the plain kernels, the Thomas Newton), the same draws on
# both sides, positions in cells, the rest relative to the largest: float64
# sums in other orders and the card's PCR against the CPU's Thomas solve
# carried into the field and the push (the CPU tests put both routes
# within 5e-16 of JAX's float64 step)
TOL64_MAG_STEP = {"p (cells)": 1e-9, "v": 1e-10, "phi": 1e-12, "rho carried": 1e-12}
# the rows re-activated in the step enter from the float32 draws in
# float32 on both sides (as in JAX), and the card divides x by dx as a
# reciprocal product (PyTorch's CUDA division by a scalar) where the CPU
# divides: an ulp of float32 apart (and the GC pack's float32 sums in
# another order). Those rows are held to 16 float32 ulps of the largest
# position and velocity, and the carried rho and n, besides
# TOL64_MAG_STEP, to the largest such position gap times the re-activated
# rows' summed weights over the largest node
TOL64_REACTIVATED = 16 * 2.0 ** -24
# the draws stay float32 (JAX draws them so), and so does the carried
# re-activation patch of those rows (JAX deposits it in their dtype)
MAG64_FLOAT32_KERNELS = ("source_batch", "philox_uniforms", "hash_batch")
MAG64_CHECK_STEPS = {"fused": 3, "composed": 3, "carried": 3, "dn": 3, "gc": 2}
MAG64_CHECK_N = MAG_CHECK_PER_SPECIES
# the rows on the card in float64 (tools/magnetized.run_row, sync debug
# mode 'error'): the configs[3] row's 1,200 steps (its physics), the
# carried, D-N and GC rows MAG64_ROW_STEPS each (their launches and syncs)
MAG64_ROW_STEPS = 200
# phase 39 and 40's configs[3] loads at these grids, float32 and float64
# in turns: MAG64_WINDOWS windows of MAG64_WINDOW_STEPS steps a dtype after
# MAG64_WARMUP; the D-N row at 8,000 in float64 (the D-N large path)
MAG64_LARGE_NGS = (16_384, 65_536)
MAG64_WINDOWS, MAG64_WINDOW_STEPS, MAG64_WARMUP = 3, 5, 2
MAG64_DN_LARGE = (50_000, 8000, 20)


def _mag64_rows(n: int, ng: int, gen, dev):
    """Bounded float64 rows: positions across the grid and past both walls
    (a tenth inactive, the off-grid rows inactive), ion velocities, the
    push constants of 1-5+ boron, weights masked by the activity, a field
    of 1e5 V/m."""
    f64 = torch.float64
    p = torch.rand(n, generator=gen, device=dev, dtype=f64) * ng - 0.5
    p[:4] = torch.tensor([0.0, ng - 1.0, -0.3, ng - 0.7], dtype=f64)
    v = torch.randn((3, n), generator=gen, device=dev, dtype=f64) * 2e4
    act = ((torch.rand(n, generator=gen, device=dev) < 0.9) & (p >= 0.0)
           & (p <= ng - 1.0)).to(f64)
    z = torch.randint(1, 6, (n,), generator=gen, device=dev).to(f64)
    const = z * (0.5 * 1e-10 * 1.602176634e-19 / (10.81 * 1.67262192e-27))
    w = torch.rand((2, n), generator=gen, device=dev, dtype=f64) * act
    e = torch.randn(ng, generator=gen, device=dev, dtype=f64) * 1e5
    return e, p, v[0], v[1], v[2], const, act, w[0], w[1]


def _mag64_case(name: str, n: int, ng: int, gen, dev) -> dict:
    """Row ``name`` (7, 8 or 9) in double at (n, ng): against its float64
    plain version on the same inputs (the push bit-equal, the deposits
    within deposit_tol64, the clamps equal), then timed (device_ms, warm),
    the plain version once, the bound (twice the float32 bytes, the
    float64 rate) and, for deposit2, float64 index_add_ of its 4 n terms
    (and the float32 kernel and index_add_ on the same rows rounded to
    float32 at the configs[3] shape)."""
    from pypic_tpu_torch.ops import cuda_cic as K
    from pypic_tpu_torch.ops.cic import cic_indices_weights

    e, p, vx, vy, vz, const, act, wr, wn = _mag64_rows(n, ng, gen, dev)
    kw = dict(b=(0.14, 1.99, 0.0), dt_dx=1e-10 / 5e-6)
    errs, library, float32 = {}, None, {}
    if name == "deposit2":
        call = lambda: K.deposit2(p, wr, wn, ng, periodic=False)  # noqa: E731
        plain = lambda: K.deposit2_plain(p, wr, wn, ng, periodic=False)  # noqa: E731
        got, ref = call(), plain()
        for k, g, r in zip(("rho", "n"), got, ref):
            a, rr = rel_err(r, g)
            errs[k] = dict(abs=a, err=rr, kind="rel, float64 order", tol=deposit_tol64(n))
        mode = K.deposit_launch_shape(n, ng, False, 132, item=8).mode
    elif name == "boris_gather_push":
        args = (e, p, vx, vy, vz, const, act)
        call = lambda: K.boris_gather_push(*args, swap_weights=True, **kw)  # noqa: E731
        plain = lambda: K.boris_gather_push_plain(*args, swap_weights=True, **kw)  # noqa: E731
        got, ref = call(), plain()
        for k, g, r in zip(("p1", "vx1", "vy1", "vz1"), got, ref):
            a = float((g - r).abs().max())
            errs[k] = dict(abs=a, err=a, kind="bit-equal", tol=0.0)
        mode = K.sweep_launch("boris_gather_push", n, ng, 132, item=8).mode
    else:
        # 1e3 dt/dx: rows that cross several cells, so the window frame
        # clamps some (the counts must be equal)
        kwd = dict(kw, dt_dx=1e3 * kw["dt_dx"], pad=CARRIED_PAD, swap_weights=True)
        args = (e, p, vx, vy, vz, const, act, wr, wn)
        call = lambda: K.boris_gather_push_deposit(*args, **kwd)  # noqa: E731
        plain = lambda: K.boris_gather_push_deposit_plain(*args, **kwd)  # noqa: E731
        got, ref = call(), plain()
        for k, g, r in zip(("p1", "vx1", "vy1", "vz1"), got, ref):
            a = float((g - r).abs().max())
            errs[k] = dict(abs=a, err=a, kind="bit-equal", tol=0.0)
        for k, g, r in zip(("rho", "n"), got[4:6], ref[4:6]):
            a, rr = rel_err(r, g)
            errs[k] = dict(abs=a, err=rr, kind="rel, float64 order", tol=deposit_tol64(n))
        gap = float(abs(int(got[6]) - int(ref[6])))
        errs["n_clamped"] = dict(abs=gap, err=gap, kind=f"count gap ({int(ref[6])} clamped)",
                                 tol=0.0)
        mode = K.deposit_launch_shape(n, ng, True, 132, item=8).mode
    if any(t.dtype != torch.float64 for t in got if t.dim() == 1):
        raise AssertionError(f"{name} float64 returned {[t.dtype for t in got]}")
    err = _check(errs, f"{name} float64 (n = {n}, ng = {ng}, {mode} mode)")
    del got, ref
    if name == "deposit2":
        il, ir, wl, wrr = cic_indices_weights(p, ng - 1, False)
        idx = torch.cat([il, ir, il + ng, ir + ng])
        terms = torch.cat([wr * wl, wr * wrr, wn * wl, wn * wrr])
        library = device_ms(lambda: torch.zeros(2 * ng, dtype=torch.float64,
                                                device=dev).index_add_(0, idx, terms),
                            calls=10)
        if (n, ng) == MAG64_SHAPES[MAG64_MAIN]:
            p32, wr32, wn32, t32 = p.float(), wr.float(), wn.float(), terms.float()
            float32["ms"] = device_ms(lambda: K.deposit2(p32, wr32, wn32, ng, periodic=False),
                                      calls=10)
            float32["library_ms"] = device_ms(
                lambda: torch.zeros(2 * ng, dtype=torch.float32, device=dev).index_add_(
                    0, idx, t32), calls=10)
            del p32, wr32, wn32, t32
        del il, ir, wl, wrr, idx, terms
    node_bytes = 2 * LARGE_NODE_BYTES.get(name, 4) * ng if mode != "shared" else 0.0
    b, by = bound(name, n, extra_bytes=node_bytes, f64=True)
    K.reset_launch_counts()
    ms = device_ms(call, calls=10)
    launches = {"calls": K.LAUNCHES[f"{name}_f64"], **dict(K.LARGE_LAUNCHES)}
    if not K.LAUNCHES[f"{name}_f64"] or K.LAUNCHES[name]:
        raise AssertionError(f"{name} float64: launches {dict(K.LAUNCHES)}")
    plain_ms = cuda_ms(plain, reps=1, calls=1)
    rec = dict(n=n, ng=ng, mode=mode, max_abs_err=err, ms=ms, plain_ms=plain_ms,
               bound_ms=b, bound_by=by, library_ms=library, launches_timed=launches,
               **{f"float32_{k}": v for k, v in float32.items()})
    log(f"[magnetized float64] {name}_f64 at n = {n}, ng = {ng} ({mode} mode): {ms:.4f} "
        f"ms, plain {plain_ms:.4f} ms, bound {b:.4f} ms ({by})"
        + (f", float64 index_add_ {library:.4f} ms" if library is not None else
           ", no single library call computes it")
        + (f"; the float32 kernel on the same rows {float32['ms']:.4f} ms, float32 "
           f"index_add_ {float32['library_ms']:.4f} ms" if float32 else "")
        + f"; launches {launches}")
    del e, p, vx, vy, vz, const, act, wr, wn, call, plain
    torch.cuda.empty_cache()
    return rec


def _mag64_newton_load(name: str, rows: int, dev):
    """(solve, plain, load label) of a Newton wrapper in float64: the
    configs[3] row's (D-D, 600 nodes) or the D-N row's (800) first solve
    from the row's float64 load (rho and n by deposit2, n0 = 0.9 <n>,
    cold); other row counts take phase 24's load (_newton_large_solve)
    in float64."""
    import numpy as np

    from pypic_tpu_torch.constants import E_CHARGE
    from pypic_tpu_torch.ops import cuda_cic as K
    from pypic_tpu_torch.ops import cuda_newton
    from pypic_tpu_torch.tools import magnetized as row

    dd = name == "boltzmann_dirichlet"
    if rows in (NG_MAG, 800) and (rows == NG_MAG) == dd:
        pre = row.preset("iead" if dd else "dn", dev, ng=rows)
        cfg, st = pre.config, row.cast_state(pre.state, torch.float64)
        w = torch.where(st.active == 1, st.p2c / cfg.grid.dx, 0.0)
        rho, n = K.deposit2(st.p, st.charge_state * E_CHARGE * w, w, rows, periodic=False)
        n0, te, dx = 0.9 * torch.mean(n), cfg.te, cfg.grid.dx
        dens, label = (rho if dd else n), ("configs[3]" if dd else "D-N row")
    else:
        rng = np.random.default_rng(11 + rows)
        num = torch.from_numpy((1e17 * (1.0 + 0.3 * rng.standard_normal(rows))).clip(1e15))
        dens = (E_CHARGE * num if dd else num).to(dev)
        n0, te, dx, label = (1e17 if dd else 0.9e17), 11600.0 * 10.0, 2e-5, "phase 24's"
    if dd:
        return (functools.partial(cuda_newton.boltzmann_dirichlet, dens, n0, te, dx),
                functools.partial(cuda_newton.boltzmann_dirichlet_plain, dens, n0, te, dx),
                label)
    phi0 = torch.zeros(rows, dtype=torch.float64, device=dev)
    return (functools.partial(cuda_newton.boltzmann_dn, dens, n0, te, dx, phi0),
            functools.partial(cuda_newton.boltzmann_dn_plain, dens, n0, te, dx, phi0), label)


def _mag64_newton_case(name: str, rows: int, dev) -> dict:
    """A Newton wrapper's double kernel at ``rows``: the first solve at
    the row's tol and an 8-iteration solve at tol 0, each against the
    float64 plain version (iterations equal, phi within TOL64_NEWTON), each
    timed by device time (the median of three profiler calls); the bound
    from the rows and the iterations (BYTES_PER_PARTICLE, OPS_PER_PARTICLE
    at the float64 rate), the plain version once."""
    from pypic_tpu_torch.ops import cuda_cic as K

    solve, plain, label = _mag64_newton_load(name, rows, dev)
    tol = 1e-9 if name == "boltzmann_dirichlet" else 1e-3
    maxiter = 1000 if name == "boltzmann_dirichlet" else 100
    large = rows > 1024
    key = f"{name}_large_f64" if large else f"{name}_f64"
    rec = {}
    for run, kw in (("first", dict(tol=tol, maxiter=maxiter)),
                    ("8 iterations", dict(tol=0.0, maxiter=8))):
        K.reset_launch_counts()
        got, ref = solve(**kw), plain(**kw)
        torch.cuda.synchronize()
        if K.LAUNCHES[key] != 1 or got.phi.dtype != torch.float64:
            raise AssertionError(f"{name} float64 at {rows} rows: launches "
                                 f"{dict(K.LAUNCHES)}, {got.phi.dtype}")
        its = int(got.iterations)
        a, r = rel_err(ref.phi, got.phi)
        err = _check({"phi": dict(abs=a, err=r, kind="rel", tol=TOL64_NEWTON),
                      "iterations": dict(abs=float(abs(its - int(ref.iterations))),
                                         err=float(abs(its - int(ref.iterations))),
                                         kind="count gap", tol=0.0)},
                     f"{key} ({rows} rows, {label} load, {run})")
        ms = statistics.median(device_ms(lambda: solve(**kw), calls=5) for _ in range(3))
        plain_ms = cuda_ms(lambda: plain(**kw), reps=1, calls=1)
        b, by = bound(name, rows, steps=its, f64=True)
        rec[run] = dict(n=rows, iterations=its, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        bound_ms=b, bound_by=by, library_ms=None,
                        us_per_iteration=1e3 * ms / max(its, 1))
        log(f"[magnetized float64] {key} {rows} rows ({label}, {run}): {its} iterations, "
            f"{ms:.4f} ms ({1e3 * ms / max(its, 1):.2f} us an iteration), plain "
            f"{plain_ms:.4f} ms, bound {b:.7f} ms ({by})")
    return rec


def _mag64_hooks(cfg, state):
    """make_step keyword arguments feeding CPU-made draws to both sides:
    the source table (or the flux draw) and the gyro-phases, from the
    CPU's Philox functions at the state's key."""
    from pypic_tpu_torch import sources

    src = cfg.source

    def draws(step, n):
        if cfg.reactivate == "flux":
            return sources.sample_flux_batch(
                state.rng, step, n, cfg.grid, src.ti, src.mass, vx=src.vx,
                gamma=cfg.flux_gamma, vx_pert=cfg.flux_vx_pert, device="cpu")
        return sources.sample_source_batch(state.rng, step, n, cfg.grid, src.ti,
                                           src.mass, vx=src.vx, device="cpu")

    def gyro(step, n):
        from pypic_tpu_torch.ops import cuda_rng

        return cuda_rng.philox_uniforms(state.rng, step, n, 3, cuda_rng.GYRO_TAG,
                                        device="cpu").t().contiguous()

    return {"source_draws": draws, "gyro_draws": gyro}


def _mag64_check(route: str, dev) -> tuple[dict, dict, list]:
    """The float64 route ``route`` at n = 6 MAG64_CHECK_N (12,000; the D-N
    row's physics at the same n): MAG64_CHECK_STEPS steps on the CPU's float64 route from the
    row's load cast to float64, the card one step from each CPU state,
    the same draws: the flags, re-activations, clamps and Newton
    iterations equal, p, v, phi (and the carried rho and n) at
    TOL64_MAG_STEP. Returns (the largest gaps, the card's launches, the
    problems)."""
    import dataclasses

    from pypic_tpu_torch import interop
    from pypic_tpu_torch.engines import magnetized
    from pypic_tpu_torch.ops import cuda_cic as K
    from pypic_tpu_torch.tools import magnetized as row

    kind = {"dn": "dn", "gc": "gc"}.get(route, "iead")
    pre = row.preset(kind, "cpu", MAG64_CHECK_N, 6 * MAG64_CHECK_N)
    over = {"fused": dict(backend="fused"), "composed": dict(backend="composed"),
            "carried": dict(row.CARRIED, react_batch=512)}.get(route, {})
    cfg = dataclasses.replace(pre.config, **over)
    st = row.cast_state(pre.state, torch.float64)
    if cfg.carried_deposit == "on":
        st = magnetized.prime_carry(st, cfg)
    hooks = _mag64_hooks(cfg, st)
    on_card = {k: (lambda f: (lambda s, n: _to(f(s, n), dev)))(f) for k, f in hooks.items()}
    step_c, step_g = magnetized.make_step(cfg, **hooks), magnetized.make_step(cfg, **on_card)
    worst, launches, problems = {}, collections.Counter(), []
    magnetized.THOMAS_SOLVES.update(dirichlet=0, dirichlet_neumann=0)
    limits = dict(TOL64_MAG_STEP)
    for i in range(MAG64_CHECK_STEPS[route]):
        d = interop.magnetized_state_to_numpy(st)
        c, mc = step_c(st)
        K.reset_launch_counts()
        g, mg = step_g(interop.magnetized_state_from_numpy(d, dev))
        torch.cuda.synchronize()
        launches.update({k: v for k, v in K.LAUNCHES.items() if v})
        react = (c.active == 1) & torch.from_numpy(d["active"] != 1)
        act = (c.active == 1) & ~react
        gp = g.p.cpu()
        gaps = {"p (cells)": float((c.p - gp)[act].abs().max()),
                "v": max(rel_err(getattr(c, k)[act], getattr(g, k).cpu()[act])[1]
                         for k in ("vx", "vy", "vz")),
                "phi": rel_err(mc.phi, mg.phi.cpu())[1]}
        if bool(react.any()):
            dp = float((c.p - gp)[react].abs().max())
            gaps["re-activated p"] = dp / float(c.p[react].abs().max())
            gaps["re-activated v"] = max(
                float((getattr(c, k) - getattr(g, k).cpu())[react].abs().max())
                / max(float(getattr(c, k)[react].abs().max()), 1e-300)
                for k in ("vx", "vy", "vz"))
            limits["re-activated p"] = limits["re-activated v"] = TOL64_REACTIVATED
        if cfg.carried_deposit == "on":
            # the re-activated rows' tents moved by at most their position gap
            w = torch.where(react, c.p2c / cfg.grid.dx, 0.0)
            moved = {"rho": float((w * c.charge_state * 1.602176634e-19).abs().sum()),
                     "n": float(w.abs().sum())}
            dp = float((c.p - gp)[react].abs().max()) if bool(react.any()) else 0.0
            gaps["rho carried"] = max(rel_err(getattr(c, k), getattr(g, k).cpu())[1]
                                      for k in ("rho", "n"))
            limits["rho carried"] = TOL64_MAG_STEP["rho carried"] + max(
                dp * moved[k] / float(getattr(c, k).abs().max()) for k in ("rho", "n"))
        counts = {k: (int(getattr(mc, k)), int(getattr(mg, k))) for k in (
            "n_active", "n_hit_wall", "n_reactivated", "carry_clamped", "newton_iters")}
        flags = int((c.active != g.active.cpu()).sum())
        dtypes = {getattr(g, k).dtype for k in ("p", "vx", "phi", "rho", "n")}
        log(f"[magnetized float64] {route} check, n = {c.p.shape[0]}, step {i} -> {i + 1}, "
            "card against the CPU's float64 route: " + ", ".join(
                f"{k} {v:.3e}" for k, v in gaps.items())
            + f"; counts (CPU, card) {counts}; flags apart {flags}")
        bad = [f"{k} {v:.3e}" for k, v in gaps.items() if not v <= limits[k]]
        bad += [f"{k} {v}" for k, v in counts.items() if v[0] != v[1]]
        if flags or dtypes != {torch.float64}:
            bad.append(f"flags apart {flags}, dtypes {dtypes}")
        if bad:
            problems.append(f"{route} step {i}: {bad}")
        for k, v in gaps.items():
            worst[k] = max(worst.get(k, 0.0), v)
        st = c
    allowed = MAG64_FLOAT32_KERNELS + (("deposit2",) if cfg.carried_deposit == "on" else ())
    if any(not k.endswith("_f64") and k not in allowed for k in launches) or sum(
            magnetized.THOMAS_SOLVES.values()):
        problems.append(f"{route}: launches {dict(launches)}, Thomas solves "
                        f"{magnetized.THOMAS_SOLVES}")
    return worst, dict(launches), problems


def _mag64_large(dev) -> tuple[dict, dict, list]:
    """Phase 39 and 40's configs[3] load (n = 999,996) at MAG64_LARGE_NGS,
    float32 and float64 in turns on the card ('auto': fused, the large
    Newton kernel): Newton iterations a step and ms/step in windows, then
    one step of each dtype from the same float32 state (the float64 one
    cast) against a float64 step on the CPU (_step64), the pushed
    particles' positions at phase 14's limits (the float64 route held to
    them). Then the D-N row at ng 8,000 in float64 (the D-N large path).
    Returns (figures, launches of the float64 runs, problems)."""
    import dataclasses

    import numpy as np

    from pypic_tpu_torch import interop
    from pypic_tpu_torch.engines import magnetized
    from pypic_tpu_torch.ops import cuda_cic as K
    from pypic_tpu_torch.runner import run
    from pypic_tpu_torch.tools import magnetized as row

    out, launches, problems = {}, collections.Counter(), []
    rtol, atol = TOL_MAG_STEP["p"]
    for ng in MAG64_LARGE_NGS:
        pre = row.preset("iead", dev, ng=ng)
        cfg = pre.config
        step = magnetized.make_step(cfg)
        # float32 on the rule's mode; float64 on each mode of the large
        # Newton path (_forced_newton_mode), the modes' order alternating
        # from one window to the next
        f64 = row.cast_state(pre.state, torch.float64)
        states = {"float32": pre.state, **{f"float64 {mode}": f64
                                           for mode in NEWTON_LARGE_MODES}}
        forced = {label: (label.split()[1] if " " in label else None) for label in states}
        del pre, f64
        for label in states:
            with (_forced_newton_mode(forced[label]) if forced[label]
                  else contextlib.nullcontext()):
                states[label], _ = run(step, states[label], MAG64_WARMUP)
        torch.cuda.synchronize()
        windows = {label: [] for label in states}
        iters = {label: [] for label in states}
        for w in range(MAG64_WINDOWS):
            order = list(states)
            order[1:] = order[1:] if w % 2 == 0 else order[:0:-1]
            for label in order:
                K.reset_launch_counts()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    with (_forced_newton_mode(forced[label]) if forced[label]
                          else contextlib.nullcontext()):
                        t0 = time.perf_counter()
                        states[label], m = run(step, states[label], MAG64_WINDOW_STEPS)
                        torch.cuda.synchronize()
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                windows[label].append((time.perf_counter() - t0) * 1e3 / MAG64_WINDOW_STEPS)
                iters[label] += m.newton_iters.tolist()
                if forced[label]:
                    launches.update({k: v for k, v in K.LAUNCHES.items() if v})
                    launches.update(dict(K.LARGE_LAUNCHES))
                    want = {f"boltzmann_dirichlet_large_f64 {forced[label]}":
                            MAG64_WINDOW_STEPS}
                    if any(not k.endswith("_f64") and k not in MAG64_FLOAT32_KERNELS
                           for k, v in K.LAUNCHES.items() if v) or _newton_modes() != want:
                        problems.append(f"ng {ng} {label}: launches "
                                        f"{ {k: v for k, v in K.LAUNCHES.items() if v} }, "
                                        f"{dict(K.LARGE_LAUNCHES)}")
        # one step of each dtype from the float32 state, against float64
        d = interop.magnetized_state_to_numpy(states["float32"])
        r = _step64("iead", cfg, d)
        p0 = torch.from_numpy(d["p"]).double()
        before = torch.from_numpy(d["active"] == 1)
        cells = float(cfg.grid.num_cells)
        inside = (r["p"] >= 0.0) & (r["p"] <= cells)
        gaps = {}
        for label, dtype in (("float32", torch.float32), ("float64", torch.float64)):
            g_in = row.cast_state(interop.magnetized_state_from_numpy(d, dev), dtype)
            g, mg = step(g_in)
            pg = g.p.double().cpu()
            pushed = before & (g.active.cpu() == 1) & inside
            lim = atol + rtol * torch.maximum(p0.abs(), r["p"].abs())
            gaps[label] = dict(
                limit_share=float(((pg - r["p"]).abs() / lim)[pushed].max()),
                cells=float((pg - r["p"]).abs()[pushed].max()), pushed=int(pushed.sum()),
                newton_iters=int(mg.newton_iters))
            del g, g_in
        gaps["float64_step_newton_iters"] = r["newton_iters"]
        if not gaps["float64"]["limit_share"] <= 1.0:
            problems.append(f"ng {ng} float64: position gap {gaps['float64']}")
        rec = dict(ms_per_step={k: statistics.median(v) for k, v in windows.items()},
                   windows=windows, newton_mean={k: float(np.mean(v)) for k, v in iters.items()},
                   newton_max={k: int(max(v)) for k, v in iters.items()},
                   at_maxiter={k: int(sum(i >= cfg.newton_maxiter for i in v))
                               for k, v in iters.items()},
                   position_gap_to_float64_step=gaps)
        out[f"ng {ng}"] = rec
        log(f"[magnetized float64] configs[3] load at ng {ng}, in turns of "
            f"{MAG64_WINDOW_STEPS} steps: ms/step " + "; ".join(
                f"{label} " + ", ".join(f"{w:.4f}" for w in windows[label])
                for label in states)
            + "; Newton iterations a step (mean, max, at maxiter) " + "; ".join(
                f"{label} ({rec['newton_mean'][label]:.2f}, {rec['newton_max'][label]}, "
                f"{rec['at_maxiter'][label]})" for label in states) + "; one step "
            f"against a float64 step ({r['newton_iters']} iterations): float32 "
            f"{gaps['float32']['limit_share']:.3e} of phase 14's limit "
            f"({gaps['float32']['cells']:.3e} cells), float64 "
            f"{gaps['float64']['limit_share']:.3e} ({gaps['float64']['cells']:.3e} cells)")
        del states, step, r, d
        torch.cuda.empty_cache()
    n, ng, steps = MAG64_DN_LARGE
    out["dn ng 8000"] = {}
    for mode in LARGE_MODE_TURNS:
        K.reset_launch_counts()
        with _forced_newton_mode(mode):
            res, cfg, fin, m = row.run_row(dev, steps=steps, row="dn", n=n, ng=ng,
                                           dtype=torch.float64)
        launches.update({k: v for k, v in K.LAUNCHES.items() if v})
        launches.update(dict(K.LARGE_LAUNCHES))
        out["dn ng 8000"].setdefault(mode, []).append(
            {k: res[k] for k in ("us_per_step", "newton_mean", "newton_max")})
        log(f"[magnetized float64] D-N row at n = {n}, ng = {ng}, float64, the mode {mode}: "
            f"{res['us_per_step']:.1f} us/step, Newton {res['newton_mean']:.2f} a step; "
            f"launches {res['launches']}, {dict(K.LARGE_LAUNCHES)}")
        if (fin.p.dtype != torch.float64
                or _newton_modes() != {f"boltzmann_dn_large_f64 {mode}": steps}
                or any(not k.endswith("_f64") and k not in MAG64_FLOAT32_KERNELS
                       for k in res["launches"])):
            problems.append(f"D-N at {ng} float64 {mode}: {fin.p.dtype}, {res['launches']}, "
                            f"{dict(K.LARGE_LAUNCHES)}")
        del fin, m
    return out, dict(launches), problems


def phase_magnetized_float64(dev) -> dict:
    """Phase 44 (module docstring). Returns the double kernels' records,
    the checks, the rows' figures and the double kernels' launches on
    their paths; fails on a disagreement, a host sync in a float64 row, a
    failed physics check, or a double kernel never launched on its
    path."""
    from pypic_tpu_torch.ops import cuda_cic as K
    from pypic_tpu_torch.tools import magnetized as row

    gen = torch.Generator(device=dev).manual_seed(44)
    res = {"kernels": {}}
    for name in MAG64_ROWS[:3]:
        res["kernels"][name] = {shape: _mag64_case(name, n, ng, gen, dev)
                                for shape, (n, ng) in MAG64_SHAPES.items()}
    res["kernels"]["boltzmann_dirichlet"] = {
        rows: _mag64_newton_case("boltzmann_dirichlet", rows, dev)
        for rows in (NG_MAG,) + MAG64_NEWTON_ROWS}
    res["kernels"]["boltzmann_dn"] = {
        rows: _mag64_newton_case("boltzmann_dn", rows, dev)
        for rows in (800,) + MAG64_NEWTON_ROWS}
    problems = []
    res["check"], res["check_launches"] = {}, {}
    for route in MAG64_CHECK_STEPS:
        worst, launched, bad = _mag64_check(route, dev)
        res["check"][route], res["check_launches"][route] = worst, launched
        problems += bad

    # the rows on the card in float64 (sync debug mode 'error' in run_row):
    # the configs[3] row's physics, the carried, D-N and GC rows' launches
    rows = {}
    for label, kw in (("configs[3]", dict(steps=1200)),
                      ("carried", dict(steps=MAG64_ROW_STEPS, **row.CARRIED)),
                      ("dn", dict(steps=MAG64_ROW_STEPS, row="dn")),
                      ("gc", dict(steps=MAG64_ROW_STEPS, row="gc"))):
        K.reset_launch_counts()
        out, cfg, fin, m = row.run_row(dev, dtype=torch.float64, **kw)
        checks = row.CHECKS[kw.get("row", "iead")](cfg, fin, m)
        if label == "configs[3]":
            phi_rel = out["phi_max_over_phi_f"]
            if not 0.6 <= phi_rel <= 1.4:
                checks.append(f"phi_max / phi_f {phi_rel:.3f} outside 0.6-1.4")
        elif label == "dn":
            # the flux cap and finite fields (the D-N row's equilibrium
            # checks need phase 21's 1,200 steps)
            checks = ([] if int(m.n_reactivated.max()) <= cfg.flux_limit
                      else [f"{int(m.n_reactivated.max())} re-activations a step"])
            checks += [] if bool(torch.isfinite(m.phi).all()) else ["non-finite phi"]
        elif label == "carried":
            checks = row.population_problems(m) + (
                [] if bool(torch.isfinite(m.phi).all()) else ["non-finite phi"])
        allowed = MAG64_FLOAT32_KERNELS + (("deposit2",) if label == "carried" else ())
        if fin.p.dtype != torch.float64 or any(
                not k.endswith("_f64") and k not in allowed for k in out["launches"]):
            checks.append(f"dtype {fin.p.dtype}, launches {out['launches']}")
        rows[label] = dict(out, problems=checks)
        log(f"[magnetized float64] {label} row in float64 ({out['steps']} steps, sync "
            f"debug mode 'error'): {out['us_per_step']:.1f} us/step, Newton "
            f"{out['newton_mean']:.2f} a step (max {out['newton_max']})"
            + (f", phi_max / phi_f {out['phi_max_over_phi_f']:.4f}"
               if "phi_max_over_phi_f" in out else "")
            + f"; launches {out['launches']}; problems {checks}")
        problems += [f"{label} row: {c}" for c in checks]
        del fin, m
        torch.cuda.empty_cache()
    res["rows"] = rows
    res["large"], large_launches, bad = _mag64_large(dev)
    problems += bad

    # each double kernel's launches on its path: the configs[3] row's for
    # rows 7, 8 and 22, the carried row's for row 9, the D-N row's for row
    # 23, the ng 16,384 and 8,000 runs' for the large paths
    main = rows["configs[3]"]["launches"]
    res["launches"] = {
        "deposit2": main.get("deposit2_f64", 0),
        "boris_gather_push": main.get("boris_gather_push_f64", 0),
        "boltzmann_dirichlet": main.get("boltzmann_dirichlet_f64", 0),
        "boris_gather_push_deposit": rows["carried"]["launches"].get(
            "boris_gather_push_deposit_f64", 0),
        "boltzmann_dn": rows["dn"]["launches"].get("boltzmann_dn_f64", 0),
        "boltzmann_dirichlet_large": large_launches.get("boltzmann_dirichlet_large_f64", 0),
        "boltzmann_dn_large": large_launches.get("boltzmann_dn_large_f64", 0),
        "boltzmann_dirichlet_cluster": large_launches.get(
            "boltzmann_dirichlet_large_f64 cluster", 0),
        "boltzmann_dn_cluster": large_launches.get("boltzmann_dn_large_f64 cluster", 0)}
    missing = [k for k, v in res["launches"].items() if not v]
    if missing:
        problems.append(f"double kernels never launched on their paths: {missing}")
    log(f"[magnetized float64] the double kernels' launches on their paths "
        f"{res['launches']}")
    if problems:
        raise AssertionError("magnetized float64: " + "; ".join(problems))
    return res


# phase 45: the explicit engine's float64 state on its double kernels
EXP64_ROWS = ("leapfrog_gather_push_deposit", "explicit_cycle")
# (n, ng) of each double kernel's check and time, by mode: row 13 at the
# explicit two-stream's shape, row 14 in its shared mode at the
# two-stage branch's NG_LARGE, in its cluster mode at 32,768 (C = 2) and
# in its global mode at 65,536 (n = 1e7; cuda_cic.cluster_launch)
EXP64_SHAPES = {"explicit_cycle": {"shared": (N_HEADLINE, NG)},
                "leapfrog_gather_push_deposit": {"shared": (N_HEADLINE, NG_LARGE),
                                                 "cluster": (10_000_000, 32_768),
                                                 "global": (10_000_000, 65_536)}}
# row 13's e1 against the float64 direct solve of its own rho1 (the same
# algorithm, float64 sums in another order) and against its plain
# version's e1 (which solves the plain rho1), relative to max |e1|; 1e4
# and more below the float32 limits (TOL_SOLVE, deposit_tol)
TOL64_SOLVE, TOL64_SOLVE_PLAIN = 1e-10, 1e-8
# the engine's routes at n = F64_CHECK_N (or the n after the kernels),
# F64_CHECK_STEPS steps: the
# CPU's float64 route from the two-stream load cast to float64 and the
# card one step from each CPU state, held at TOL64_STEP (float64 sums in
# other orders: rho, e and the energies; p and v come from the same state
# and field); the double kernels each route must launch, and nothing else
EXP64_ROUTES = {
    "fused ng 200": (NG, "auto", {"explicit_cycle_f64"}),
    f"fused ng {NG_LARGE}": (NG_LARGE, "auto", {"leapfrog_gather_push_deposit_f64"}),
    # n = 2.5e6: 76 rows a node, above cuda_cic.CLUSTER_MIN_ROWS_PER_NODE, so
    # that row 14 takes its cluster mode
    "fused ng 32768": (32_768, "auto", {"leapfrog_gather_push_deposit_f64"}, 2_500_000),
    "fused ng 65536": (65_536, "auto", {"leapfrog_gather_push_deposit_f64"}),
    "composed ng 200": (NG, "composed", {"gather_f64", "deposit_f64"})}


def _exp64_case(name: str, n: int, ng: int, gen, dev) -> dict:
    """Row 13 or 14 in double at (n, ng), on phase 42's random float64
    inputs (edge positions in the first rows): against its float64 plain
    version on the same inputs (p1 within TOL64_POS cells, v1 within
    TOL64_V, rho1 within 4 n eps64 of the largest node, row 13's e1 within
    TOL64_SOLVE of the direct solve of its own rho1 and TOL64_SOLVE_PLAIN
    of the plain e1), then timed (device_ms, warm) beside the float32
    kernel on the same rows rounded to float32, the plain version once
    and the bound (twice the float32 bytes a row, 16 B a node more in
    the large modes); the launches by mode (row 14's is
    cuda_cic.cluster_launch's)."""
    from pypic_tpu_torch.ops import cuda_cic as K

    f64 = torch.float64
    e, _, p0, v0 = (t.to(f64) for t in _random_pass_inputs(n, gen, dev, True, ng))
    kw = dict(qm=QM, w=W, dt=DT, dx=DX)
    cycle = name == "explicit_cycle"
    if cycle:
        call = lambda: K.explicit_cycle(e, p0, v0, ng, **kw)  # noqa: E731
        plain = lambda: K.explicit_cycle_plain(e, p0, v0, ng, **kw)  # noqa: E731
    else:
        call = lambda: K.leapfrog_gather_push_deposit(e, p0, v0, **kw)  # noqa: E731
        plain = lambda: K.leapfrog_gather_push_deposit_plain(e, p0, v0, **kw)  # noqa: E731
    K.reset_launch_counts()
    got, ref = call(), plain()
    torch.cuda.synchronize()
    mode = "shared" if cycle else K.cluster_launch(name, n, ng, 132, 8).mode
    large = dict(K.LARGE_LAUNCHES)
    if (K.LAUNCHES[f"{name}_f64"] != 1 or K.LAUNCHES[name]
            or large != ({f"{name}_f64 {mode}": 1} if mode != "shared" else {})):
        raise AssertionError(f"{name} float64 at ng {ng}: launches {dict(K.LAUNCHES)}, "
                             f"large {large}")
    if any(t.dtype != f64 for t in got):
        raise AssertionError(f"{name}: the double kernel returned {[t.dtype for t in got]}")
    a = seam_err(ref[0], got[0], ng)
    errs = {"p1": dict(abs=a, err=a, kind="cells", tol=TOL64_POS)}
    a, r = rel_err(ref[1], got[1])
    errs["v1"] = dict(abs=a, err=r, kind="rel", tol=TOL64_V)
    a, r = rel_err(ref[2], got[2])
    errs["rho1"] = dict(abs=a, err=r, kind="rel, float64 order", tol=deposit_tol64(n))
    if cycle:
        from pypic_tpu_torch.ops.cuda_cic import field_from_rho_plain

        a, r = rel_err(field_from_rho_plain(got[2], DX), got[3])
        errs["e1"] = dict(abs=a, err=r, kind="rel vs the float64 solve of its rho1",
                          tol=TOL64_SOLVE)
        a, r = rel_err(ref[3], got[3])
        errs["e1_plain"] = dict(abs=a, err=r, kind="rel", tol=TOL64_SOLVE_PLAIN)
    err = _check(errs, f"{name} float64 (n = {n}, ng = {ng}, {mode} mode)")
    del got, ref
    e32, p32, v32 = e.float(), p0.float(), v0.float()
    float32_ms = device_ms(
        (lambda: K.explicit_cycle(e32, p32, v32, ng, **kw)) if cycle else
        (lambda: K.leapfrog_gather_push_deposit(e32, p32, v32, **kw)), calls=10)
    del e32, p32, v32
    node_bytes = 2 * PERIODIC_LARGE_ROWS[name][0] * ng if mode != "shared" else 0.0
    b, by = bound(name, n, extra_bytes=node_bytes, f64=True)
    K.reset_launch_counts()
    ms = device_ms(call, calls=10)
    launches = {"calls": K.LAUNCHES[f"{name}_f64"], **dict(K.LARGE_LAUNCHES)}
    if not K.LAUNCHES[f"{name}_f64"] or K.LAUNCHES[name]:
        raise AssertionError(f"{name} float64: launches {dict(K.LAUNCHES)}")
    plain_ms = cuda_ms(plain, reps=1, calls=1)
    rec = dict(n=n, ng=ng, mode=mode, max_abs_err=err, ms=ms, plain_ms=plain_ms,
               bound_ms=b, bound_by=by, library_ms=None, float32_ms=float32_ms,
               launches_timed=launches)
    log(f"[explicit float64] {name}_f64 at n = {n}, ng = {ng} ({mode} mode): {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, bound {b:.4f} ms ({by}), the float32 kernel on the "
        f"same rows {float32_ms:.4f} ms, no single library call computes it; launches "
        f"{launches}")
    del e, p0, v0, call, plain
    torch.cuda.empty_cache()
    return rec


def _exp64_route(label: str, dev) -> tuple[list, dict, list]:
    """Route ``label`` of EXP64_ROUTES: F64_CHECK_STEPS steps of the
    explicit two-stream (tools/two_stream.py, n = F64_CHECK_N or the
    route's own) on the
    CPU's float64 route, and the card one step from each CPU state,
    against the CPU's next one at TOL64_STEP; the launches of the card
    steps, counted from 0 before them. Returns (the gaps a step, the
    launches, the problems)."""
    from pypic_tpu_torch import interop
    from pypic_tpu_torch.engines import explicit
    from pypic_tpu_torch.ops import cuda_cic as K
    from pypic_tpu_torch.tools import two_stream

    f64 = torch.float64
    ng, backend, kernels, *rows = EXP64_ROUTES[label]
    n = rows[0] if rows else F64_CHECK_N
    cfg, _, sc = two_stream.state(n, "cpu", ng=ng, dtype=f64, backend=backend)
    step = explicit.make_step(cfg)
    rows, launches, problems = [], collections.Counter(), []
    for i in range(F64_CHECK_STEPS):
        d = interop.explicit_state_to_numpy(sc)
        K.reset_launch_counts()
        sg, mg = step(interop.explicit_state_from_numpy(d, dev))
        torch.cuda.synchronize()
        launches.update({k: v for k, v in K.LAUNCHES.items() if v})
        launches.update({f"large {k}": v for k, v in K.LARGE_LAUNCHES.items()})
        sc, mc = step(sc)
        dtypes = {getattr(sg, k).dtype for k in ("p", "v", "rho", "e")}
        checks = {"p (cells)": seam_err(sc.p, sg.p.cpu(), ng),
                  "v": rel_err(sc.v, sg.v.cpu())[1],
                  "rho": rel_err(sc.rho, sg.rho.cpu())[1],
                  "e": rel_err(sc.e, sg.e.cpu())[1],
                  "field_energy": rel_err(mc.field_energy.reshape(1),
                                          mg.field_energy.cpu().reshape(1))[1],
                  "kinetic_energy": rel_err(mc.kinetic_energy.reshape(1),
                                            mg.kinetic_energy.cpu().reshape(1))[1]}
        bad = {k: x for k, x in checks.items() if not x <= EXP64_STEP[k]}
        if bad or dtypes != {f64}:
            problems.append(f"{label} step {i + 1}: {bad}, dtypes {dtypes}")
        rows.append(checks)
        del sg, mg
    launched = {k for k in launches if not k.startswith("large")}
    if launched != kernels:
        problems.append(f"{label}: launches {dict(launches)}, want {sorted(kernels)}")
    if ng > 14_528 and not any(k.startswith("large") for k in launches):
        problems.append(f"{label}: no global-mode launch {dict(launches)}")
    log(f"[explicit float64] {label}, n = {n}, the card one step from each of "
        f"{F64_CHECK_STEPS} CPU states against the CPU's (limits "
        f"{EXP64_STEP['p (cells)']:.0e} cells, {EXP64_STEP['v']:.0e} relative): "
        + "; ".join(", ".join(f"{k} {x:.2e}" for k, x in r.items()) for r in rows)
        + f"; card launches {dict(launches)}")
    return rows, dict(launches), problems


def _exp64_two_stream(dev) -> tuple[dict, list]:
    """The explicit two-stream at n = N_HEADLINE, ng 200 (phase 8's load,
    tools/two_stream.py) in float32 and float64 on the card: set-up and one
    step each, then F64_WINDOWS windows of F64_WINDOW_STEPS steps a dtype
    in turns; ms/step, the total energy change over every step's pre-push
    energies (held under EXPLICIT_ENERGY_BOUND in both), the launches (the
    float64 run's only double kernels). Returns (figures, problems)."""
    from pypic_tpu_torch.engines import explicit
    from pypic_tpu_torch.ops import cuda_cic as K
    from pypic_tpu_torch.runner import run
    from pypic_tpu_torch.tools import two_stream

    labels = {"float32": torch.float32, "float64": torch.float64}
    states, steps, launches, energy = {}, {}, {}, {}
    windows = {label: [] for label in labels}
    for label, dtype in labels.items():
        K.reset_launch_counts()
        cfg, _, states[label] = two_stream.state(N_HEADLINE, dev, dtype=dtype)
        steps[label] = explicit.make_step(cfg)
        states[label], m = run(steps[label], states[label], 1)
        torch.cuda.synchronize()
        launches[label] = dict(K.LAUNCHES)
        energy[label] = [m.field_energy + m.kinetic_energy]
    for _ in range(F64_WINDOWS):
        for label in labels:
            K.reset_launch_counts()
            t0 = time.perf_counter()
            states[label], m = run(steps[label], states[label], F64_WINDOW_STEPS)
            torch.cuda.synchronize()
            windows[label].append((time.perf_counter() - t0) * 1e3 / F64_WINDOW_STEPS)
            for k, v in K.LAUNCHES.items():
                launches[label][k] += v
            energy[label].append(m.field_energy + m.kinetic_energy)
    problems, out = [], {}
    for label, dtype in labels.items():
        st = states[label]
        tot = torch.cat(energy[label]).double().cpu()
        change = float((tot[-1] - tot[0]) / tot[0])
        used = {k: v for k, v in launches[label].items() if v}
        out[label] = dict(ms_per_step=statistics.median(windows[label]),
                          windows=windows[label], total_energy_rel_change=change,
                          steps=len(tot), launches=used)
        if not abs(change) < EXPLICIT_ENERGY_BOUND:
            problems.append(f"two-stream {label}: total energy change {change}")
        if st.p.dtype != dtype or not (bool(torch.isfinite(st.p).all())
                                       and bool(torch.isfinite(st.e).all())):
            problems.append(f"two-stream {label}: {st.p.dtype}, non-finite state")
        if (dtype == torch.float64) != all(k.endswith("_f64") for k in used):
            problems.append(f"two-stream {label}: launches {used}")
    log(f"[explicit float64] two-stream n = {N_HEADLINE}, ng = {NG}, in turns of "
        f"{F64_WINDOW_STEPS} steps after set-up and one: float32 "
        f"{out['float32']['ms_per_step']:.4f} ms/step (windows "
        + ", ".join(f"{w:.4f}" for w in windows["float32"]) + "), float64 "
        f"{out['float64']['ms_per_step']:.4f} ms/step (windows "
        + ", ".join(f"{w:.4f}" for w in windows["float64"]) + "); total energy change "
        f"over {out['float64']['steps']} steps float32 "
        f"{out['float32']['total_energy_rel_change']:+.4e}, float64 "
        f"{out['float64']['total_energy_rel_change']:+.4e} (bound "
        f"{EXPLICIT_ENERGY_BOUND:.0e}); launches float32 {out['float32']['launches']}, "
        f"float64 {out['float64']['launches']}")
    del states, steps
    torch.cuda.empty_cache()
    return out, problems


def phase_explicit_float64(dev) -> dict:
    """Phase 45 (module docstring). Returns the double kernels' records by
    mode, the route checks and their launches, the two-stream in both
    dtypes and the double kernels' launches on their paths; fails on a
    disagreement, a float kernel launched in a float64 run, an energy
    change over its bound, or a double kernel never launched on its
    path."""
    gen = torch.Generator(device=dev).manual_seed(45)
    res = {"kernels": {}}
    for name in EXP64_ROWS:
        for mode, (n, ng) in EXP64_SHAPES[name].items():
            rec = _exp64_case(name, n, ng, gen, dev)
            if rec["mode"] != mode:
                raise AssertionError(f"{name} float64 at ng {ng}: mode {rec['mode']}")
            res["kernels"].setdefault(name, {})[mode] = rec
    problems = []
    res["check"], res["check_launches"] = {}, {}
    for label in EXP64_ROUTES:
        rows, launches, bad = _exp64_route(label, dev)
        res["check"][label], res["check_launches"][label] = rows, launches
        problems += bad
    res["two_stream"], bad = _exp64_two_stream(dev)
    problems += bad
    # each double kernel's launches on its path: the float64 two-stream's
    # for row 13 (one a step), the ng 4,096 route's for row 14, and the ng
    # 32,768 route's for row 14's cluster mode
    res["launches"] = {
        "explicit_cycle": res["two_stream"]["float64"]["launches"].get(
            "explicit_cycle_f64", 0),
        "leapfrog_gather_push_deposit": res["check_launches"][f"fused ng {NG_LARGE}"].get(
            "leapfrog_gather_push_deposit_f64", 0),
        "leapfrog_gather_push_deposit cluster": res["check_launches"]["fused ng 32768"].get(
            "large leapfrog_gather_push_deposit_f64 cluster", 0)}
    missing = [k for k, v in res["launches"].items() if not v]
    if missing:
        problems.append(f"double kernels never launched on their paths: {missing}")
    log(f"[explicit float64] the double kernels' launches on their paths {res['launches']}")
    if problems:
        raise AssertionError("explicit float64: " + "; ".join(problems))
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
    lgp = phase("large periodic", phase_large_periodic, dev)
    f64 = phase("float64", phase_float64, dev)
    s64 = phase("sheath float64", phase_sheath_float64, dev)
    m64 = phase("magnetized float64", phase_magnetized_float64, dev)
    e64 = phase("explicit float64", phase_explicit_float64, dev)

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
    for kname in ("boltzmann_dirichlet_large", "boltzmann_dn_large",
                  "boltzmann_dirichlet_cluster", "boltzmann_dn_cluster"):
        launches[kname] = lg["launches"][kname]
    helper = dnk.pop("philox_uniforms")
    # rows 4, 7, 9 and 20 read deposit_times' median at their main shapes
    # (row 4: the headline's set-up, the path whose launches it counts;
    # deposit_det: the composed sheath current), their other shapes beside
    records = {**k, **ek, **ik, **mk, **shk, **dnk, **dk, **ck}
    # the large paths' records at the shape phase 39 gives them, every
    # shape of phase 24 beside it
    # (the large path's record: the mode the rule takes, both modes'
    # forced pairs beside it; the cluster entry points' own record: the
    # cluster mode's, at every shape)
    for kname, by_rows in lim["newton_large"].items():
        records[kname] = dict(by_rows[LARGE_MAIN[kname]], shapes=by_rows)
        records[kname.replace("_large", "_cluster")] = dict(
            by_rows[LARGE_MAIN[kname]]["modes"]["cluster"],
            shapes={rows: rec["modes"]["cluster"] for rows, rec in by_rows.items()})
    chain_large = lim["chain_large"]
    # the large modes of rows 4 (deposit_det), 7, 9 and 10: phase 40's
    # record at LARGE_KERNEL_MAIN with its other shapes, and the launches
    # of its main paths
    for kname, by_shape in lgs["kernels"].items():
        records[kname]["large_mode"] = dict(
            by_shape[LARGE_KERNEL_MAIN], launches=lgs["launches"][kname],
            shapes=by_shape)
    # the large modes of the periodic, explicit and slab rows: phase 41's
    # record at PERIODIC_LARGE_MAIN with its other shapes, and the
    # large-mode launches of phase 41's paths
    for kname, by_shape in lgp["kernels"].items():
        records[kname]["large_mode"] = dict(
            by_shape[PERIODIC_LARGE_MAIN], shapes=by_shape,
            launches={k: v for k, v in lgp["launches"].items() if k.split()[0] == kname})
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
                   boltzmann_dirichlet_cluster="pypic_tpu_torch/csrc/newton.cu",
                   boltzmann_dn_cluster="pypic_tpu_torch/csrc/newton.cu",
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
            "fixed_us", "k", "threads", "large_mode", "mode", "cluster", "smem",
            "shared", "modes", "float64")
            if key in records[kname]}}
        for kname in REPLACES
    ] + [
        # the double kernels of a float64 state (phase 42): the record of
        # the shared mode at the headline's shape, the global mode's beside
        {"name": f"{kname}_f64", "route": "cuda",
         "source": ("pypic_tpu_torch/csrc/explicit.cu" if kname == "gather"
                    else "pypic_tpu_torch/csrc/cic.cu"),
         "replaces": REPLACES[kname], "launches": f64["launches"][kname],
         **{key: f64["kernels"][kname]["shared"][key] for key in (
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "n")},
         "dtype": "float64", "global_mode": f64["kernels"][kname]["global"],
         **({"cluster_mode": f64["kernels"][kname]["cluster"]}
            if "cluster" in f64["kernels"][kname] else {})}
        for kname in F64_ROWS
    ] + [
        # the sheath engine's double kernels (phase 43): the record at the
        # configs[2] shape, the large mode's at 65,536 beside it; the
        # launches of the float64 configs[2] row (fused, composed)
        {"name": f"{kname}_f64", "route": "cuda", "source": SOURCES_SHEATH[kname],
         "replaces": REPLACES[kname], "launches": s64["launches"][kname],
         **{key: s64["kernels"][kname][SHEATH64_MAIN][key] for key in (
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "n",
             "float32_ms")},
         "dtype": "float64",
         **({"large_mode": s64["kernels"][kname][SHEATH64_LARGE_MAIN],
             "shapes": s64["kernels"][kname]} if kname in SHEATH64_SHAPES else
            {"row_mix": s64["kernels"][kname][SHEATH64_MAIN]["row_mix"]})}
        for kname in SHEATH64_ROWS
    ] + [
        # the magnetized engine's double kernels (phase 44): rows 7-9 at the
        # configs[3] shape with their large modes at 1e7 / 65,536 beside;
        # the Newton solves at the rows' first solves (600, 800 rows), their
        # large paths at 16,384 rows (8 iterations); the launches of the
        # float64 rows (configs[3], carried, D-N) and phase 44's large runs
        *({"name": f"{kname}_f64", "route": "cuda",
           "source": "pypic_tpu_torch/csrc/magnetized.cu",
           "replaces": REPLACES[kname], "launches": m64["launches"][kname],
           **{key: m64["kernels"][kname][MAG64_MAIN][key] for key in (
               "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "n")},
           "dtype": "float64", "large_mode": m64["kernels"][kname][MAG64_LARGE_MAIN],
           **({"float32_ms": m64["kernels"][kname][MAG64_MAIN]["float32_ms"],
               "float32_library_ms": m64["kernels"][kname][MAG64_MAIN]["float32_library_ms"]}
              if kname == "deposit2" else {})}
          for kname in MAG64_ROWS[:3]),
        *({"name": f"{kname}_f64", "route": "cuda",
           "source": "pypic_tpu_torch/csrc/newton.cu", "replaces": REPLACES[kname],
           "launches": m64["launches"][kname],
           **{key: m64["kernels"][kname][rows]["first"][key] for key in (
               "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "n",
               "iterations", "us_per_iteration")},
           "dtype": "float64", "eight_iterations": m64["kernels"][kname][rows]["8 iterations"]}
          for kname, rows in (("boltzmann_dirichlet", NG_MAG), ("boltzmann_dn", 800))),
        *({"name": f"{kname}_large_f64", "route": "cuda",
           "source": "pypic_tpu_torch/csrc/newton.cu", "replaces": REPLACES[f"{kname}_large"],
           "launches": m64["launches"][f"{kname}_large"],
           **{key: m64["kernels"][kname][MAG64_LARGE_NEWTON_MAIN]["8 iterations"][key]
              for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                          "library_ms", "n", "iterations", "us_per_iteration")},
           "dtype": "float64",
           "shapes": {rows: rec for rows, rec in m64["kernels"][kname].items()
                      if rows > 1024},
           # phase 24's float64 forced pairs at 16,384 rows
           "modes": lim["newton_large"][f"{kname}_large"][MAG64_LARGE_NEWTON_MAIN][
               "float64"]["modes"]}
          for kname in ("boltzmann_dirichlet", "boltzmann_dn")),
        # the cluster mode's double entry points: phase 24's forced cluster
        # mode at 16,384 rows (8 iterations), the launches of phase 44's
        # float64 runs in the cluster mode (the rule's, and forced)
        *({"name": f"{kname}_cluster_f64", "route": "cuda",
           "source": "pypic_tpu_torch/csrc/newton.cu", "replaces": REPLACES[f"{kname}_large"],
           "launches": m64["launches"][f"{kname}_cluster"],
           **{key: lim["newton_large"][f"{kname}_large"][MAG64_LARGE_NEWTON_MAIN]["float64"][
               "modes"]["cluster"].get(key) for key in (
               "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "n",
               "iterations", "us_per_iteration", "marginal_us_per_iteration", "cluster",
               "threads", "k", "shared")},
           "dtype": "float64"}
          for kname in ("boltzmann_dirichlet", "boltzmann_dn")),
    ] + [
        # the explicit engine's double kernels (phase 45): row 13 at the
        # two-stream's shape, row 14 in its shared mode at ng 4,096 with
        # its global mode at 1e7 / 65,536 and its cluster mode at 1e7 /
        # 32,768 beside; the launches of the float64 two-stream (row 13),
        # the ng 4,096 route (row 14) and the ng 32,768 route (its cluster
        # mode)
        {"name": f"{kname}_f64", "route": "cuda",
         "source": "pypic_tpu_torch/csrc/explicit.cu", "replaces": REPLACES[kname],
         "launches": e64["launches"][kname],
         **{key: e64["kernels"][kname]["shared"][key] for key in (
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "n",
             "float32_ms")},
         "dtype": "float64",
         **({"global_mode": e64["kernels"][kname]["global"]}
            if "global" in e64["kernels"][kname] else {}),
         **({"cluster_mode": dict(e64["kernels"][kname]["cluster"], launches=e64[
             "launches"][f"{kname} cluster"])}
            if "cluster" in e64["kernels"][kname] else {})}
        for kname in EXP64_ROWS
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
        # the hash sampler's float64 draws (phase 43): the launches of the
        # float64 configs[2] row on the hash sampler
        {"name": "hash_batch_f64", "route": "cuda",
         "source": "pypic_tpu_torch/csrc/rng.cu", "replaces": None,
         "launches": s64["launches"]["hash_batch"], "dtype": "float64",
         **{key: s64["hash_batch"]["4x999996"][key] for key in (
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "n",
             "library_ms", "float32_ms")},
         "shapes": s64["hash_batch"]},
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
        "large_periodic": {k: v for k, v in lgp.items() if k != "kernels"},
        "float64": {k: v for k, v in f64.items() if k != "kernels"},
        "sheath_float64": {k: v for k, v in s64.items() if k not in ("kernels", "hash_batch")},
        "magnetized_float64": {k: v for k, v in m64.items() if k != "kernels"},
        "explicit_float64": {k: v for k, v in e64.items() if k != "kernels"},
        "walls_s": walls}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
