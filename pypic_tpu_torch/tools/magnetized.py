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

``--carried`` runs a row as ``bench.py --carried`` does (bench.py:497-512):
carried_deposit='on' with a react_batch of 16,384 and the carry primed at
set-up (``magnetized.prime_carry``). The configs[3] row then takes the
``boris_gather_push_deposit`` sweep, one ``deposit2`` patch of the
re-activated rows, the Newton kernel, the source kernel (16,384 draws) and
the IEAD deposit a step, and the result adds the sums over the steps of
carry_clamped, n_ion_suppressed and n_escape_deferred (the carry is
exact while all three are 0; bench.py warns otherwise).

    python -m pypic_tpu_torch.tools.magnetized [--row iead|dn|gc] [--carried]
        [--ng NG] [--dtype float32|float64]

runs a row and prints one JSON line: µs/step, pushes/s, the mean Newton
iteration count, the row's own figures (configs[3]: the mean phi_max of
the last 100 steps over the floating potential) and the kernel launches;
it exits non-zero when a check fails. It needs an NVIDIA GPU. The steps
run under ``torch.cuda.set_sync_debug_mode("error")``: a host sync in a
step raises (the three rows' routes read nothing back; the op-composed
Thomas route, newton_backend 'xla', would, and is never taken here).
``--ng`` runs the row's load on another grid (the presets' ng; 600 for
'iead' and 'gc', 800 for 'dn' by default): above 1,024 nodes the Newton
solve is the large path of ``csrc/newton.cu`` (``chip_smoke.py`` phase 39
runs the configs[3] load at ng = 4,096 and 16,384 and the D-N row at
8,000). The row's Newton residual check (<= tol after step 5) keeps the
configs[3] row's tol 1e-9, which lies under the float32 floor at large
grids: at ng = 16,384 most steps end at maxiter above it, and the tool
prints its line and exits non-zero naming that check (ROADMAP queue 3).
``--dtype float64`` runs the row's state cast to float64 (``cast_state``:
the same particles, every float tensor of the state in float64) on the
double kernels of rows 7-9, 22 and 23 (and rows 4 and 6), as the JAX
engine runs a float64 state under x64; the draws stay float32.
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
# bench.py --carried's options (bench.py:504-508): the preset's react_batch
# is 0, so the table takes bench's 16,384
CARRIED = dict(carried_deposit="on", react_batch=16384)
CARRIED_SUMS = ("carry_clamped", "n_ion_suppressed", "n_escape_deferred")


def state(device=None, n_per_species: int = N_PER_SPECIES):
    """(cfg, initial MagnetizedState, floating potential [V]) of the row on
    ``device`` (the current CUDA device by default)."""
    pre = presets.pic_iead(n_per_species=n_per_species,
                           device=devices.resolve(device))
    return pre.config, pre.state, pre.meta["floating_potential"]


def preset(row: str, dev, n_per_species: int = N_PER_SPECIES,
           n: int | None = None, ng: int | None = None):
    """The preset of ``row`` ('iead', 'dn' or 'gc') on ``dev``: the
    configs[3] row's pic_iead or pic_iead_gc at ``n_per_species``, or
    dirichlet_neumann_test at ``n`` (``N_DN`` by default); on ``ng``
    nodes, or the preset's own grid."""
    grid = {} if ng is None else dict(ng=ng)
    if row == "iead":
        return presets.pic_iead(n_per_species=n_per_species, device=dev, **grid)
    if row == "gc":
        return presets.pic_iead_gc(n_per_species=n_per_species, device=dev,
                                   **grid)
    if row == "dn":
        return presets.dirichlet_neumann_test(n=n or N_DN, device=dev, **grid)
    raise ValueError(f"unknown row {row!r}; have {ROWS}")


def cast_state(state, dtype: torch.dtype):
    """``state`` with every floating tensor in ``dtype`` (the integer
    fields, the key and the step as they are): the float64 form of a row's
    load from the same particles."""
    import dataclasses

    return state.replace(**{
        f.name: getattr(state, f.name).to(dtype) for f in dataclasses.fields(state)
        if isinstance(getattr(state, f.name), torch.Tensor)
        and getattr(state, f.name).is_floating_point()})


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


def last_iead_traffic(cfg, st):
    """The IEAD histogram's traffic of the last step that ``st`` ended, at
    the configs[3] row's re-activation (every slot inactive at a step's
    start re-activates that step, so the slots inactive at its end are its
    wall hits, holding their impact velocities): (flat bins as float32
    positions, weights), what ``ops.cic.histogram_add`` deposits, and the
    hit mask."""
    if not (cfg.reactivate == "source" and cfg.react_timing == "reference"
            and cfg.react_batch == 0):
        raise ValueError("last_iead_traffic needs the configs[3] row's "
                         "re-activation (source, reference timing, no batch)")
    hit = (st.active == 0) & (st.at_wall == 1)
    flat, weight = magnetized.iead_traffic(
        st.species_idx, st.m, st.vx, st.vy, st.vz, hit, bins=cfg.iead_bins,
        energy_max=cfg.iead_energy_max, angle_max=cfg.iead_angle_max)
    return flat.to(torch.float32), weight, hit


def run_row(device=None, steps: int = STEPS,
            n_per_species: int = N_PER_SPECIES, warmup: int = 3,
            row: str = "iead", n: int | None = None, ng: int | None = None,
            dtype: torch.dtype = torch.float32, **overrides):
    """Run a row (``row`` 'iead', the configs[3] row; 'dn' at ``n``
    particles, ``N_DN`` by default; 'gc' at ``n_per_species``; on ``ng``
    nodes, the preset's grid by default): ``warmup``
    steps from the initial state (set-up: the first launch of each PyTorch
    kernel loads it, and the flux table goes to the device), then from the
    initial state again, the launch counts set to 0, ``steps`` steps under
    the sync debug mode "error" and one synchronize. ``overrides`` replace
    config fields (e.g. backend='composed', or ``CARRIED``: then the carry
    is primed at set-up and the result has the sums of ``CARRIED_SUMS``
    under "carried"); ``dtype`` float64 runs the load cast by
    ``cast_state``. On a CPU device (the plain
    versions; no timing meaning) there is no sync to watch. Returns
    (result dict, config, final state, stacked StepMetrics)."""
    import dataclasses

    dev = devices.resolve(device)
    cuda = dev.type == "cuda"
    pre = preset(row, dev, n_per_species, n, ng)
    cfg, st = pre.config, cast_state(pre.state, dtype)
    phi_f = pre.meta.get("floating_potential")
    cfg = dataclasses.replace(cfg, **overrides)
    step = magnetized.make_step(cfg)
    if cuda:
        _build.load()  # the build is set-up, not step time
    carried = cfg.carried_deposit == "on"
    if carried:
        st = magnetized.prime_carry(st, cfg)
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
               dtype=str(dtype).replace("torch.", ""),
               us_per_step=seconds * 1e6 / steps,
               pushes_per_s=n * steps / seconds,
               newton_mean=float(m.newton_iters.float().mean()),
               newton_max=int(m.newton_iters.max()),
               launches={k: v for k, v in cuda_cic.LAUNCHES.items() if v})
    if carried:
        res["carried"] = {k: int(getattr(m, k).sum()) for k in CARRIED_SUMS}
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
    ap.add_argument("--carried", action="store_true",
                    help="bench.py --carried: carried_deposit='on', "
                         "react_batch 16,384")
    ap.add_argument("--ng", type=int, default=None,
                    help="grid nodes (the preset's own by default)")
    ap.add_argument("--dtype", choices=("float32", "float64"), default="float32",
                    help="the state's dtype (float64: the double kernels)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    res, cfg, fin, m = run_row(torch.device("cuda", 0), row=args.row,
                               ng=args.ng, dtype=getattr(torch, args.dtype),
                               **(CARRIED if args.carried else {}))
    res["problems"] = CHECKS[args.row](cfg, fin, m)
    print(json.dumps(res))
    if res["problems"]:
        raise SystemExit(f"{args.row} row failed: {res['problems']}")
    return res


if __name__ == "__main__":
    main()
