"""bench.py's sheath row (BASELINE configs[2]) on one GPU.

The configuration of ``bench.py`` ``bench_sheath`` (bench.py:441-475): the
reference gen-2 bounded sheath (PIC_L_DD.py:320-331: electrons and
protons between two absorbing walls, ng 51, dx 1e-5 m, dt 1e-12 s,
density 1e19 m^-3, Te = Ti = 10 eV, re-injection of what the walls absorb)
at n = 1,000,000, loaded by ``initialize_sheath(..., seed=3)``, with
p2c = L density / n, ``picard_init='extrapolate'``,
``picard_accel='anderson'`` and the engine's other defaults (tol 1e-5,
tol_floor 0.5, maxiter 20, gamma 0, no exit histograms). 'auto' takes the
fused backend and the Philox re-injection kernel on the card. The row
runs 1,200 steps through ``runner.run``, bench's n and steps.

    python -m pypic_tpu_torch.tools.sheath

runs it and prints one JSON line (``--ng``, ``--n`` and ``--steps`` change
the grid, keeping dx and the density, the load and the step count; above
1,760 nodes the sheath pass runs its large mode; ``--dtype float64`` runs
a float64 state, the load cast before x / dx, on the double kernels,
whose small mode ends at 880 nodes; ``--composed`` the composed
backend): µs/step, pushes/s, the
Picard mean and maximum, the wall potential drops in Te/e over the last
300 steps, the
kernel launches, and the host syncs a step beside the Picard passes a step
(20 more steps under ``torch.cuda.set_sync_debug_mode("warn")``, each
synchronizing call counted; the engine reads the host once a pass). It
exits non-zero if a physics check fails or the syncs differ from the
engine's reads. It needs an NVIDIA GPU.

    python -m pypic_tpu_torch.tools.sheath --replay STEP

instead runs the row on the card up to step STEP (0-based, as the row's
``steps_at_maxiter`` counts) and replays that one step from the card's
state on the card, on the CPU in float32 (the plain versions: the same
Philox draws, other summation orders) and on the CPU in float64: the
residual after each Picard pass and the float32 (float64) floor threshold
beside it, and the pass each side stops at. It prints one JSON line.

    python -m pypic_tpu_torch.tools.sheath --composed-exits DIR [--save]

prices the composed backend's Picard exits on fixed states: with
``--save`` it runs the row's first COMPOSED_STEPS steps with
backend='composed' from its initial state and writes each step's starting
state into DIR; then it replays each state in DIR one step on the card
(maxiter 1, 2, ... as ``--replay`` does): the residual after each pass
beside the floor threshold, the pass it stops at and by which test (tol,
floor or maxiter), and ``deposit_det`` of the state's starting current
against a float64 deposit. Run by two trees of the port on one DIR (one
with ``--save``), it compares their deposits' loops on the same states.
It prints one JSON line.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import pathlib
import time
import warnings

import numpy as np
import torch

from .. import devices, initialize, interop
from ..constants import E_CHARGE, K_BOLTZMANN
from ..engines import sheath
from ..grid import GridSpec
from ..ops import _build, cuda_cic
from ..runner import run

N = 1_000_000
NG = 51
STEPS = 1200
DENSITY, DT, DX = 1e19, 1e-12, 1e-5
TE = TI = 10.0 * 11600.0
SYNC_STEPS = 20
COMPOSED_STEPS = 20


def config(n: int = N, ng: int = NG) -> sheath.SheathConfig:
    """The row's configuration at n particles; ``ng`` other than the
    row's 51 nodes keeps dx and the density (the domain grows, p2c with
    it)."""
    length = DX * (ng - 1)
    grid = GridSpec(ng, length, "dirichlet-dirichlet")
    return sheath.SheathConfig(
        grid, DT, length * DENSITY / n, kbte=K_BOLTZMANN * TE,
        kbti=K_BOLTZMANN * TI, picard_init="extrapolate",
        picard_accel="anderson")


def state(device=None, n: int = N, cfg: sheath.SheathConfig | None = None,
          dtype: torch.dtype = torch.float32):
    """(cfg, initial SheathState) of the row on ``device`` (the current
    CUDA device by default) in ``dtype`` (float64: the same load, cast
    after x / dx in the load's precision); ``cfg`` replaces the row's
    configuration."""
    cfg = cfg or config(n)
    d = initialize.initialize_sheath(n, DENSITY, 1.0, 0.0, cfg.grid, TE, TI,
                                     seed=3)
    st = sheath.init_state(d["x"], d["v"], d["q"], d["m"], d["species"], cfg,
                           dtype=dtype, device=devices.resolve(device))
    return cfg, st


def wall_drops(m, last: int) -> tuple[float, float]:
    """(left, right) wall potential minus its maximum, in Te/e, of phi
    averaged over the last ``last`` steps (tests/test_sheath.py:41-57)."""
    phi = m.phi[-last:].double().mean(dim=0).cpu()
    te_volts = K_BOLTZMANN * TE / E_CHARGE
    return (float(phi[0] - phi.max()) / te_volts,
            float(phi[-1] - phi.max()) / te_volts)


def check_row(cfg, fin, m, last: int = 300) -> list:
    """The row's checks, as a list of problems: the population invariant
    (n_active + this step's wall losses = n every step: every loss is
    re-injected at the next step's start), Picard counts within maxiter,
    finite fields and positions, and the potential's maximum inside the
    domain (phi averaged over the last ``last`` steps): the walls charge
    negative against the quasi-neutral core."""
    problems = []
    n = fin.p.shape[0]
    tot = (m.n_active + m.n_lost_left + m.n_lost_right).cpu()
    if not bool((tot == n).all()):
        problems.append(f"population not kept: n_active + losses in "
                        f"[{int(tot.min())}, {int(tot.max())}], n = {n}")
    if int(m.picard_iters.max()) > cfg.maxiter:
        problems.append(f"Picard count above maxiter: {int(m.picard_iters.max())}")
    if not (torch.isfinite(m.phi).all() and torch.isfinite(fin.p).all()
            and torch.isfinite(fin.e).all()):
        problems.append("non-finite phi, field or positions")
    phi = m.phi[-min(last, m.phi.shape[0]):].double().mean(dim=0)
    top = int(torch.argmax(phi))
    if top in (0, phi.shape[0] - 1):
        problems.append(f"wall at the potential maximum (node {top})")
    return problems


def count_syncs(step, st, maxiter: int, steps: int = SYNC_STEPS) -> dict:
    """Host syncs over ``steps`` steps from ``st``, each synchronizing call
    of the package counted by PyTorch's sync debug mode (with its sites),
    beside the Picard passes and the host reads the engine makes (one a
    pass, none after a pass that reaches maxiter), all per step."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            _, m = run(step, st, steps)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    # a sync is counted at the line of the package that made it; the
    # debug mode's own switch back to 0 warns once, from torch's code
    package = pathlib.Path(__file__).resolve().parent.parent
    sites = collections.Counter(
        f"{pathlib.Path(w.filename).name}:{w.lineno}" for w in seen
        if "synchroniz" in str(w.message)
        and pathlib.Path(w.filename).resolve().is_relative_to(package))
    iters = m.picard_iters.cpu()
    reads = iters - (iters == maxiter).to(iters.dtype)
    return dict(host_syncs_per_step=sum(sites.values()) / steps,
                picard_passes_per_step=float(iters.float().mean()),
                host_reads_per_step=float(reads.float().mean()),
                sync_sites=dict(sites))


def run_row(device=None, steps: int = STEPS, n: int = N, warmup: int = 3,
            sync_steps: int = SYNC_STEPS, ng: int = NG,
            dtype: torch.dtype = torch.float32, **overrides):
    """Run the row: ``warmup`` steps from the initial state (set-up: the
    first launch of each PyTorch kernel loads it), then from the initial
    state again, the launch counts set to 0, ``steps`` steps and one
    synchronize; then, on a card, ``sync_steps`` steps that count the host
    syncs. ``overrides`` replace config fields (e.g. backend='composed').
    On a CPU device (the plain versions; no timing meaning) there is no
    sync to count. ``ng`` widens the grid (``config``); ``dtype`` is the
    state's (``state``). Returns (result dict, config, final state,
    stacked StepMetrics of the timed steps)."""
    dev = devices.resolve(device)
    cuda = dev.type == "cuda"
    cfg, st = state(dev, n, dataclasses.replace(config(n, ng), **overrides), dtype)
    step = sheath.make_step(cfg)
    if cuda:
        _build.load()  # the build is set-up, not step time
    if warmup:
        run(step, st, warmup)
    if cuda:
        torch.cuda.synchronize(dev)
    cuda_cic.reset_launch_counts()
    t0 = time.perf_counter()
    fin, m = run(step, st, steps)
    if cuda:
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    launches = {k: v for k, v in cuda_cic.LAUNCHES.items() if v}
    iters = m.picard_iters.cpu()
    left, right = wall_drops(m, min(300, steps))
    res = dict(device=torch.cuda.get_device_name(dev) if cuda else "cpu",
               n=n, ng=cfg.grid.ng, steps=steps, backend=cfg.backend,
               dtype=str(dtype).replace("torch.", ""),
               us_per_step=seconds * 1e6 / steps,
               pushes_per_s=n * steps / seconds,
               picard_mean=float(iters.float().mean()),
               picard_max=int(iters.max()), picard_sum=int(iters.sum()),
               steps_at_maxiter=torch.nonzero(iters == cfg.maxiter).flatten().tolist(),
               wall_drop_left_te=left, wall_drop_right_te=right,
               lost_per_step=float((m.n_lost_left + m.n_lost_right).float().mean()),
               launches=launches)
    if cuda and sync_steps:
        res["syncs"] = count_syncs(step, fin, cfg.maxiter, sync_steps)
    return res, cfg, fin, m


def _replay_side(cfg, d: dict, device, dtype) -> dict:
    """One step from the numpy state ``d`` on ``device`` in ``dtype``, run
    with maxiter 1, 2, ... until the loop stops on its own: the residual
    after each pass, the floor threshold tol_floor eps ||eh|| beside it
    (eh = (e0 + e1)/2, the test's ||es|| within r) and the pass it
    stops at."""
    if dtype == torch.float64:
        d = {k: v.astype(np.float64) if v.dtype == np.float32 else v
             for k, v in d.items()}
    eps = float(torch.finfo(dtype).eps)
    e0 = np.asarray(d["e"], np.float64)
    resid, floor, stop = [], [], None
    for k in range(1, cfg.maxiter + 1):
        st = interop.sheath_state_from_numpy(d, device)
        fin, m = sheath.make_step(dataclasses.replace(cfg, maxiter=k))(st)
        iters = int(m.picard_iters)
        if iters < k:  # left by the tol or the floor test at pass `iters`
            stop = iters
            break
        resid.append(float(m.picard_residual))
        eh = 0.5 * (e0 + fin.e.double().cpu().numpy())
        floor.append(cfg.tol_floor * eps * float(np.linalg.norm(eh)))
    return dict(passes=stop or cfg.maxiter, at_maxiter=stop is None,
                residual=resid, floor=floor)


def replay(step_index: int, device=None, n: int = N) -> dict:
    """The row's step ``step_index`` replayed from the card's state on the
    card and on the CPU in float32 and float64 (module docstring)."""
    dev = devices.resolve(device)
    cfg, st = state(dev, n)
    st, m = run(sheath.make_step(cfg), st, step_index)
    d = interop.sheath_state_to_numpy(st)
    out = dict(step=step_index, n=st.p.shape[0],
               device=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
               picard_iters_before=m.picard_iters.cpu().tolist()[-5:])
    for label, where, dtype in (("card", dev, torch.float32),
                                ("cpu_float32", "cpu", torch.float32),
                                ("cpu_float64", "cpu", torch.float64)):
        out[label] = _replay_side(cfg, d, where, dtype)
    return out


def composed_exits(states_dir, device=None, save: bool = False,
                   steps: int = COMPOSED_STEPS, n: int = N) -> dict:
    """The composed backend's Picard exits on the row's states in
    ``states_dir`` (module docstring); with ``save`` the states of the
    row's first ``steps`` composed steps are written there first, and each
    step's passes in that run stand beside its replay's."""
    dev = devices.resolve(device)
    cfg = dataclasses.replace(config(n), backend="composed")
    states_dir = pathlib.Path(states_dir)
    run_passes = {}
    if save:
        states_dir.mkdir(parents=True, exist_ok=True)
        _, st = state(dev, n, cfg)
        step = sheath.make_step(cfg)
        for i in range(steps):
            name = f"state_{i:04d}.npz"
            np.savez(states_dir / name, **interop.sheath_state_to_numpy(st))
            st, m = step(st)
            run_passes[name] = int(m.picard_iters)
    rows = []
    for path in sorted(states_dir.glob("state_*.npz")):
        with np.load(path) as z:
            d = {k: z[k] for k in z.files}
        side = _replay_side(cfg, d, dev, torch.float32)
        stop = side["passes"]
        r = side["residual"][stop - 1] if side["residual"] else None
        how = ("maxiter" if side["at_maxiter"] else "tol" if r is not None and r <= cfg.tol
               else "floor")
        st = interop.sheath_state_from_numpy(d, dev)
        act = st.active == sheath.ACTIVE
        vals = torch.where(act, st.q * (cfg.p2c / cfg.grid.dx) * st.u, 0.0)
        got = cuda_cic.deposit_det(st.p, vals, cfg.grid.ng, periodic=False)
        ref = cuda_cic.deposit_plain(st.p.double(), vals.double(), cfg.grid.ng,
                                     periodic=False)
        err = float((got.double() - ref).abs().max() / ref.abs().max())
        rows.append(dict(state=path.name, passes=stop, run_passes=run_passes.get(path.name),
                         exit=how, residual=r,
                         floor=side["floor"][stop - 1] if side["floor"] else None,
                         residuals=side["residual"], floors=side["floor"],
                         deposit_det_rel_err=err))
    return dict(device=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                n=n, tol=cfg.tol, maxiter=cfg.maxiter,
                passes_sum=sum(r["passes"] for r in rows),
                exits=dict(collections.Counter(r["exit"] for r in rows)), steps=rows)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--replay", type=int, default=None, metavar="STEP",
                   help="replay the row's step STEP on the card and the CPU")
    p.add_argument("--composed-exits", default=None, metavar="DIR",
                   help="replay the composed backend's steps on the states in DIR")
    p.add_argument("--save", action="store_true",
                   help="with --composed-exits: write the row's states into DIR first")
    p.add_argument("--ng", type=int, default=NG,
                   help="grid nodes (dx and the density kept; above 1,760 the "
                        "sheath pass's large mode)")
    p.add_argument("--n", type=int, default=N, help="particles")
    p.add_argument("--steps", type=int, default=STEPS)
    p.add_argument("--dtype", choices=("float32", "float64"), default="float32",
                   help="the state's dtype (float64: the double kernels)")
    p.add_argument("--composed", action="store_true",
                   help="the composed backend (gather, deposit_det) for the row run")
    args = p.parse_args(argv)
    row_only = (args.ng, args.n, args.dtype, args.composed) != (NG, N, "float32", False)
    if row_only and (args.replay is not None or args.composed_exits is not None):
        p.error("--ng, --n, --dtype and --composed change the row run only")
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    if args.composed_exits is not None:
        res = composed_exits(args.composed_exits, torch.device("cuda", 0), save=args.save)
        print(json.dumps(res))
        return res
    if args.replay is not None:
        res = replay(args.replay, torch.device("cuda", 0))
        print(json.dumps(res))
        return res
    over = dict(backend="composed") if args.composed else {}
    res, cfg, fin, m = run_row(torch.device("cuda", 0), steps=args.steps,
                               n=args.n, ng=args.ng, dtype=getattr(torch, args.dtype),
                               **over)
    res["problems"] = check_row(cfg, fin, m)
    syncs = res["syncs"]
    if syncs["host_syncs_per_step"] != syncs["host_reads_per_step"]:
        res["problems"].append(f"host syncs {syncs}")
    print(json.dumps(res))
    if res["problems"]:
        raise SystemExit(f"configs[2] row failed: {res['problems']}")
    return res


if __name__ == "__main__":
    main()
