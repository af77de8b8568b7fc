"""bench.py's magnetized row (BASELINE configs[3]) on one GPU, and the
engine's two other rows: the Dirichlet-Neumann flux sheath and the
guiding-center pusher.

The configuration of ``bench.py`` ``bench_magnetized`` (bench.py:478-546)
with bench's default options: the reference ``pic_iead`` preset
(pygcpic.py:1120-1200: D+ and B 1+..5+, ng 600, B = 2 T at 86 degrees,
dt 1e-10, Boltzmann electrons, Dirichlet-Dirichlet walls, IEAD collection,
re-activation from the volumetric source) at n_per_species = 166,666,
n = 999,996, and the engine's defaults (newton_tol 1e-9, newton_maxiter
1000, warm start 'previous', the reference's gather weights and
re-activation timing, react_batch 0). 'auto' takes the fused backend, the
one-launch Newton kernel and the Philox source kernel on the card. The row
runs 1,200 steps through ``runner.run``, bench's n and steps.

The D-N row (``--row dn``) is the reference's ``dirichlet_neumann_test``
at its own scale (pygcpic.py:1968-2093: n = 50,000, ng = 800, the
wall-flux source capped at 100 a step): 'auto' takes the fused backend,
the one-launch D-N Newton kernel and the Philox flux draw. The GC row
(``--row gc``) is ``pic_iead_gc`` at the configs[3] row's size (n =
999,996, ng = 600): the composed backend (the GC path mixes RK4 and Boris
by particle), the D-D Newton kernel, the source kernel and the gyro-phase
draw. Each row has its own physics checks.

    python -m pypic_tpu_torch.tools.magnetized [--row iead|dn|gc]

runs a row and prints one JSON line: µs/step, pushes/s, the mean Newton
iteration count, the row's own figures (configs[3]: the mean phi_max of
the last 100 steps over the floating potential) and the kernel launches;
it exits non-zero when a check fails. It needs an NVIDIA GPU. The steps
run under ``torch.cuda.set_sync_debug_mode("error")``: a host sync in a
step raises (the three rows' routes read nothing back; the op-composed
Thomas route above 1,024 nodes would, and is never taken here).
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

from .. import devices, presets
from ..engines import magnetized
from ..ops import _build, cuda_cic
from ..runner import run

N_PER_SPECIES = 166_666
N = 6 * N_PER_SPECIES
STEPS = 1200
N_DN = 50_000  # dirichlet_neumann_test's own n (pygcpic.py:1973)
ROWS = ("iead", "dn", "gc")


def state(device=None, n_per_species: int = N_PER_SPECIES):
    """(cfg, initial MagnetizedState, floating potential [V]) of the row on
    ``device`` (the current CUDA device by default)."""
    pre = presets.pic_iead(n_per_species=n_per_species,
                           device=devices.resolve(device))
    return pre.config, pre.state, pre.meta["floating_potential"]


def preset(row: str, dev, n_per_species: int = N_PER_SPECIES,
           n: int | None = None):
    """The preset of ``row`` ('iead', 'dn' or 'gc') on ``dev``: the
    configs[3] row's pic_iead or pic_iead_gc at ``n_per_species``, or
    dirichlet_neumann_test at ``n`` (``N_DN`` by default)."""
    if row == "iead":
        return presets.pic_iead(n_per_species=n_per_species, device=dev)
    if row == "gc":
        return presets.pic_iead_gc(n_per_species=n_per_species, device=dev)
    if row == "dn":
        return presets.dirichlet_neumann_test(n=n or N_DN, device=dev)
    raise ValueError(f"unknown row {row!r}; have {ROWS}")


def population_problems(m) -> list:
    """The source keeps the population: n_active + this step's wall
    losses constant, each step's re-activations equal the previous step's
    losses (tests/test_magnetized.py:341-353)."""
    problems = []
    n_act = m.n_active.cpu().numpy()
    hits = m.n_hit_wall.cpu().numpy()
    tot = n_act + hits
    if not (tot == tot[0]).all():
        problems.append(f"population not kept: n_active + hits in "
                        f"[{tot.min()}, {tot.max()}]")
    if not np.array_equal(m.n_reactivated.cpu().numpy()[1:], hits[:-1]):
        problems.append("re-activations differ from the previous step's losses")
    return problems


def check_dn_row(cfg, fin, m) -> list:
    """The D-N row's checks (tests/test_magnetized.py:379-415), as a list
    of problems: the adaptive n0 not collapsed (last > 0.05 first); n0's
    mean over the last 100 steps within 10% of its mean over steps
    -300:-200; the time-averaged phi (last 100 steps) within 1e-3 V of 0
    at the Dirichlet wall and above 5 V at the far end; at most
    ``flux_limit`` re-activations a step; finite phi and positions."""
    problems = []
    n0 = m.n0.double().cpu().numpy()
    if not n0[-1] > 0.05 * n0[0]:
        problems.append(f"adaptive n0 collapsed: {n0[0]} -> {n0[-1]}")
    if len(n0) >= 300:
        late, mid = n0[-100:].mean(), n0[-300:-200].mean()
        if not abs(late - mid) / late < 0.10:
            problems.append(f"n0 not equilibrated: window means {mid} -> {late}")
    phi = m.phi[-100:].double().mean(dim=0).cpu().numpy()
    if not abs(phi[0]) <= 1e-3:
        problems.append(f"phi at the Dirichlet wall {phi[0]} V")
    if not phi[-1] > 5.0:
        problems.append(f"phi at the Neumann end {phi[-1]} V <= 5 V")
    react = int(m.n_reactivated.max())
    if react > cfg.flux_limit:
        problems.append(f"{react} re-activations in a step > {cfg.flux_limit}")
    if not (torch.isfinite(m.phi).all() and torch.isfinite(fin.p).all()):
        problems.append("non-finite phi or positions")
    return problems


def check_gc_row(cfg, fin, m) -> list:
    """The GC row's checks, as a list of problems: finite phi, a non-empty
    IEAD, mu >= 0 on the active guiding centers
    (tests/test_magnetized.py:890-904) and the population kept."""
    problems = population_problems(m)
    if not (torch.isfinite(m.phi).all() and torch.isfinite(fin.p).all()):
        problems.append("non-finite phi or positions")
    if not float(fin.iead.sum()) > 0.0:
        problems.append("empty IEAD")
    gc = (fin.active == 1) & (fin.mode == 1)
    if not bool((fin.vy[gc] >= 0.0).all()):
        problems.append("negative mu on an active guiding center")
    return problems


def check_row(cfg, fin, m) -> list:
    """The configs[3] row's physics checks, as a list of problems: the
    population kept (``population_problems``), the Newton residual <= tol
    after step 5, finite fields, and both species' IEADs non-empty."""
    problems = population_problems(m)
    resid = m.newton_residual[5:].cpu().numpy()
    if not (resid <= np.float32(cfg.newton_tol)).all():
        problems.append(f"Newton residual above tol after step 5: max {resid.max()}")
    if not (torch.isfinite(m.phi).all() and torch.isfinite(fin.p).all()):
        problems.append("non-finite phi or positions")
    per_species = fin.iead.sum(dim=(1, 2)).cpu()
    if not bool((per_species > 0).all()):
        problems.append(f"empty IEAD: {per_species.tolist()}")
    return problems


CHECKS = {"iead": check_row, "dn": check_dn_row, "gc": check_gc_row}


def run_row(device=None, steps: int = STEPS,
            n_per_species: int = N_PER_SPECIES, warmup: int = 3,
            row: str = "iead", n: int | None = None, **overrides):
    """Run a row (``row`` 'iead', the configs[3] row; 'dn' at ``n``
    particles, ``N_DN`` by default; 'gc' at ``n_per_species``): ``warmup``
    steps from the initial state (set-up: the first launch of each PyTorch
    kernel loads it, and the flux table goes to the device), then from the
    initial state again, the launch counts set to 0, ``steps`` steps under
    the sync debug mode "error" and one synchronize. ``overrides`` replace
    config fields (e.g. backend='composed'). On a CPU device (the plain
    versions; no timing meaning) there is no sync to watch. Returns
    (result dict, config, final state, stacked StepMetrics)."""
    import dataclasses

    dev = devices.resolve(device)
    cuda = dev.type == "cuda"
    pre = preset(row, dev, n_per_species, n)
    cfg, st = pre.config, pre.state
    phi_f = pre.meta.get("floating_potential")
    cfg = dataclasses.replace(cfg, **overrides)
    step = magnetized.make_step(cfg)
    if cuda:
        _build.load()  # the build is set-up, not step time
    if warmup:
        run(step, st, warmup)
    if cuda:
        torch.cuda.synchronize(dev)
    cuda_cic.reset_launch_counts()
    t0 = time.perf_counter()
    if cuda:
        torch.cuda.set_sync_debug_mode("error")
    try:
        fin, m = run(step, st, steps)
    finally:
        if cuda:
            torch.cuda.set_sync_debug_mode(0)
    if cuda:
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    n = st.p.shape[0]
    last = min(100, steps)
    res = dict(device=torch.cuda.get_device_name(dev) if cuda else "cpu",
               row=row, n=n, ng=cfg.grid.ng, steps=steps,
               us_per_step=seconds * 1e6 / steps,
               pushes_per_s=n * steps / seconds,
               newton_mean=float(m.newton_iters.float().mean()),
               newton_max=int(m.newton_iters.max()),
               launches={k: v for k, v in cuda_cic.LAUNCHES.items() if v})
    if phi_f is not None:
        res["phi_max_over_phi_f"] = float(m.phi_max[-last:].double().mean()) / phi_f
    if row == "dn":
        phi = m.phi[-last:].double().mean(dim=0)
        res.update(n0_last_over_first=float(m.n0[-1]) / float(m.n0[0]),
                   phi_wall=float(phi[0]), phi_far=float(phi[-1]),
                   react_max=int(m.n_reactivated.max()),
                   react_per_step=float(m.n_reactivated.float().mean()))
    return res, cfg, fin, m


def main(argv=None) -> dict:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--row", choices=ROWS, default="iead")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    res, cfg, fin, m = run_row(torch.device("cuda", 0), row=args.row)
    res["problems"] = CHECKS[args.row](cfg, fin, m)
    print(json.dumps(res))
    if res["problems"]:
        raise SystemExit(f"{args.row} row failed: {res['problems']}")
    return res


if __name__ == "__main__":
    main()
