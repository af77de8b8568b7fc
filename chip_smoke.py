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

The line before the last is one JSON object describing each kernel; the
last line is {"ok": true, "device": {...}}.
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
    "explicit_cycle_resident": 16,
}
# float32 operations per particle and step, counted from the kernel bodies
# (floor, add, sub and mul count one; each atomic add one)
OPS_PER_PARTICLE = {
    "picard_iteration": 28, "picard_finalize_nodep": 16, "deposit": 7,
    "gather": 6, "leapfrog_gather_push_deposit": 22, "explicit_cycle": 22,
    "explicit_cycle_resident": 25,
}
REPLACES = {
    "picard_iteration": "pypic_tpu/ops/pallas_cic.py:1649",
    "picard_finalize_nodep": "pypic_tpu/ops/pallas_cic.py:1802",
    "deposit": "pypic_tpu/ops/pallas_cic.py:252",
    "gather": "pypic_tpu/ops/pallas_cic.py:798",
    "leapfrog_gather_push_deposit": "pypic_tpu/ops/pallas_cic.py:1167",
    "explicit_cycle": "pypic_tpu/ops/pallas_cic.py:1040",
    "explicit_cycle_resident": "pypic_tpu/ops/pallas_cic.py:1254",
}


def bound(name: str, n: int, steps: int = 1) -> tuple[float, str]:
    """The least time in ms the card could take for one call on n
    particles (``steps`` cycles for the resident kernel): the larger of the
    bytes over the memory rate and the operations over the float32 rate."""
    by_bytes = BYTES_PER_PARTICLE[name] * n / PEAK_BYTES_PER_S * 1e3
    by_ops = OPS_PER_PARTICLE[name] * n * steps / PEAK_F32_PER_S * 1e3
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
         steps: int = 1) -> dict:
    b, by = bound(name, n, steps)
    log(f"[kernels]   {name} {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{b:.4f} ms ({by}) at n = {n}" + (f", {steps} steps" if steps > 1 else ""))
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


def _drive(label: str, build, warm: int, timed: int, want: dict) -> dict:
    """Run one path of the explicit engine with the launch counts set to 0
    just before it and read just after; check finite values in range and
    the launches."""
    from pypic_tpu_torch.engines import explicit
    from pypic_tpu_torch.ops import cuda_cic
    from pypic_tpu_torch.runner import run

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_cic.reset_launch_counts()
    t0 = time.perf_counter()
    cfg, st = build()
    step = explicit.make_step(cfg)
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
    log(f"[explicit slice] {label}: n = {n}, ng = {ng}, {timed} timed steps "
        f"after init_state + {warm} warm-up: {res['ms_per_step']:.4f} ms/step, "
        f"{res['pushes_per_s']:.4e} pushes/s, setup {res['setup_s']:.2f} s, "
        f"peak memory {res['peak_mem_gib']:.2f} GiB, total energy change "
        f"{res['total_energy_rel_change']:+.4e} over {warm + timed} steps")
    log(f"[explicit slice] {label}: launches {launches}")
    finite = all(bool(torch.isfinite(t).all()) for t in (st.p, st.v, st.e, st.rho, tot))
    in_range = bool(((st.p >= 0) & (st.p <= ng)).all())
    problems = []
    if not (finite and in_range):
        problems.append(f"finite={finite} in_range={in_range}")
    if launches != want:
        problems.append(f"launches {launches} != {want}")
    if problems:
        raise AssertionError(f"explicit slice, {label}: " + "; ".join(problems))
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


def main() -> int:
    name = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    k = phase_kernels(dev)
    phase_check(dev)
    sl = phase_slice(dev)
    glue = sl["ms_per_step"] - 4 * k["picard_iteration"]["ms"] - k["picard_finalize_nodep"]["ms"]
    log(f"[slice] breakdown per step: 4 x picard_iteration "
        f"{4 * k['picard_iteration']['ms']:.4f} ms + finalize "
        f"{k['picard_finalize_nodep']['ms']:.4f} ms + the rest {glue:.4f} ms")
    ek = phase_explicit_kernels(dev)
    phase_explicit_check(dev)
    ex = phase_explicit_slice(dev, ek["explicit_cycle"]["ms"])
    rs = phase_resident(dev)

    # each kernel's launches come from the path that runs it, counted from
    # 0 just before that path and read just after
    launches = dict(sl["launches"])
    launches["explicit_cycle"] = ex["launches"]["explicit_cycle"]
    launches["leapfrog_gather_push_deposit"] = (
        ex["large_grid"]["launches"]["leapfrog_gather_push_deposit"])
    launches["gather"] = ex["composed"]["launches"]["gather"]
    launches["explicit_cycle_resident"] = rs["launches"]["explicit_cycle_resident"]
    records = {**k, **ek}
    sources = {kname: "pypic_tpu_torch/csrc/cic.cu" for kname in k}
    sources.update({kname: "pypic_tpu_torch/csrc/explicit.cu" for kname in ek})
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
    ], "slice": {key: sl[key] for key in (
        "n", "steps", "ms_per_step", "pushes_per_s", "picard_mean",
        "field_energy_rel_change", "total_energy_rel_change")},
        "explicit_slice": {key: ex[key] for key in (
            "n", "steps", "ms_per_step", "pushes_per_s", "metric_sums_ms",
            "total_energy_rel_change")},
        "resident": {key: rs[key] for key in (
            "n", "steps", "us_per_step", "pushes_per_s",
            "per_step_path_us_per_step", "growth_ratio")}}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
