"""bench.py's domain-decomposed row (BASELINE configs[4]) on the card, and
its explicit carrier.

The configuration of ``bench.py`` ``bench_domain`` (bench.py:553-628) with
bench's default options: the reference Landau preset (pypic.py:846-855:
ng 200, L 22 debye lengths, density 1e5 m^-3, Te 100 eV, dt 1e-5) at
n = 100,000,000 in the conserving configuration (tol 1e-30, maxiter 4,
extrapolated init, Anderson(1), finalize 'converged'), slab-sharded over
the ranks of the process group: halo = min(ng / S - 3, max(4,
ceil(8 sigma))) with sigma the thermal excursion in cells a step (~1.1),
migrate_cap = max(4096, 4 n / ng), capacity factor 1.05 on one rank and
1.5 on more. The load is ``tools/headline.py``'s, made on the card
(bench.py's distribution, other numbers). ``--explicit`` runs
``bench_domain_explicit`` (bench.py:636-700): the explicit carrier
(``parallel.domain``, halo 0, the fused push) on the same load;
``--explicit --carried`` its ``bench.py --carried`` form (bench.py:652-663):
carried_rho='on' with the halo min(ng / S - 1, max(4, ceil(8 sigma))),
one ``explicit_domain_cycle`` sweep a step.

    python -m pypic_tpu_torch.tools.domain [--explicit [--carried]] [--n N]
        [--ng 200] [--warmup 2] [--steps 30]
    torchrun --nproc-per-node 4 -m pypic_tpu_torch.tools.domain
        (with PYPIC_DISTRIBUTED=1: one rank a card, NCCL)

Without a process group it makes a one-rank group (NCCL on the card, a
``tcp://localhost`` rendezvous on a free port), as bench.py runs the row
on one chip. It steps 2 warm-up and 30 timed steps and prints one
JSON line: ms/step, pushes/s, the Picard mean, the total energy change
over the timed steps, the n_dropped and n_halo_clamped sums and the host
syncs a step (``torch.cuda.set_sync_debug_mode('warn')`` over the timed
steps). ``--ng`` refines the grid as the Landau preset does (L stays 22
Debye lengths; bench's halo and migration rules follow ng: the thermal
excursion in cells grows with it, and past their shared-memory ceilings
the slab kernels take their large modes, up to
``cuda_cic.LARGE_MAX_NG``). ``--save PATH`` writes the result
with its per-step rows; ``--against PATH`` compares this run with a saved
one of the same row on another number of ranks (four cards against one:
the energy gaps step by step, the counts). It needs an NVIDIA GPU.

The bounded slab engines (``parallel.domain_sheath``,
``parallel.domain_magnetized``) on the same process group:

    python -m pypic_tpu_torch.tools.domain --magnetized [--n-per-species N]
        [--steps 200] [--replicas R] [--ng 600] [--solver distributed]
    python -m pypic_tpu_torch.tools.domain --sheath [--n N] [--ng 51]
        [--steps 1200]

``--magnetized`` runs ``presets.pic_iead_dd`` at the configs[3] row's
width (n_per_species 166,666, n = 999,996, ng 600 unless ``--ng`` says
otherwise; ``--solver replicated`` the global Newton) for 200 steps and
prints ms/step, pushes/s, the Newton iterations a step (mean, max), the
launches and host syncs a step, n_dropped, the population invariant
(n_active + wall losses constant) and phi_max over the floating
potential (the last 100 steps, 0.6-1.4: tests/test_magnetized.py:
333-338). ``--sheath`` runs the configs[2] row's physics (n = 1e6, ng 51,
the extrapolated Picard start and Anderson(1) of ``tools/sheath.py``) on
``parallel.domain_sheath`` for 1,200 steps and prints us/step, the Picard
passes (mean, max), the host syncs a step and the wall drops in Te/e
(-0.5 to -4: tests/test_sheath.py:41-57). ``slab_jobs`` runs either on
the ranks of ``parallel.spawn`` (the tests' and the smoke's gloo ranks).
"""

from __future__ import annotations

import argparse
import json
import math
import socket
import time
import warnings

import torch
import torch.distributed as dist

from ..constants import E_CHARGE, EPSILON_0, K_BOLTZMANN, M_ELECTRON
from ..grid import GridSpec
from ..parallel import domain, domain_implicit, make_mesh
from ..parallel.mesh import maybe_initialize_distributed
from ..runner import run
from .headline import device_load

N = 100_000_000
NG = 200
WARMUP, STEPS = 2, 30
DENSITY, TE, DT = 1e5, 100.0 * 11600.0, 1e-5
CONSERVING = dict(tol=1e-30, maxiter=4, picard_init="extrapolate",
                  picard_accel="anderson", finalize="converged",
                  finalize_field="last", window_share="auto")


def process_group() -> None:
    """Join the process group the environment describes
    (``maybe_initialize_distributed``), else make a one-rank group: NCCL
    on the card, gloo without one."""
    if dist.is_initialized() or maybe_initialize_distributed():
        return
    with socket.socket() as s:  # any free port on this host
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl" if torch.cuda.is_available() else "gloo",
                            init_method=f"tcp://localhost:{port}", rank=0,
                            world_size=1)


def grid(ng: int = NG) -> GridSpec:
    debye = math.sqrt(K_BOLTZMANN * TE * EPSILON_0 / E_CHARGE**2 / DENSITY)
    return GridSpec(ng, 22.0 * debye, "periodic")


def _load(n: int, mesh, seed: int, load=None, ng: int = NG):
    """The Landau grid of ng nodes, the load (``load`` = (x, v), else
    made on the mesh's device from ``seed``), 8 sigma of the thermal
    excursion a step in cells (rounded up: bench's halo rules start from
    it) and the migration bucket as bench_domain sizes it."""
    g = grid(ng)
    if load is None:
        x, v = device_load(n, g.length, mesh.device, seed)
    else:
        x, v = (torch.as_tensor(a, device=mesh.device) for a in load)
    reach = math.ceil(8.0 * float(v.std()) * DT / g.dx)
    return g, x, v, reach, max(4096, 4 * (n // ng))


def _capacity_factor(mesh) -> float:
    # one rank has no load imbalance; more keep bench's 1.5 (the
    # perturbation piles particles into the wave-crest slabs)
    return 1.05 if mesh.world == 1 else 1.5


def implicit_row(mesh, n: int = N, seed: int = 1, load=None, ng: int = NG,
                 **overrides):
    """(cfg, this rank's DomainImplicitState) of configs[4] on ng nodes;
    ``overrides`` replace conserving-configuration fields (finalize,
    window_share, backend, ...); ``load`` = (x, v) replaces the seeded
    load."""
    g, x, v, reach, cap = _load(n, mesh, seed, load, ng)
    cfg = domain_implicit.DomainImplicitConfig(
        g, DT, g.length * DENSITY / n, num_shards=mesh.world,
        halo=min(ng // mesh.world - 3, max(4, reach)), migrate_cap=cap,
        **{**CONSERVING, **overrides})
    st = domain_implicit.init_state(x, v, -E_CHARGE, M_ELECTRON, cfg, mesh,
                                    capacity_factor=_capacity_factor(mesh))
    return cfg, st


def explicit_row(mesh, n: int = N, seed: int = 1, load=None, ng: int = NG,
                 **overrides):
    """(cfg, this rank's DomainState) of bench_domain_explicit on ng
    nodes: halo 0 (the per-step path migrates every step), the fused push
    on the card; with ``carried_rho='on'`` among the overrides, bench's
    carried halo min(ng / S - 1, max(4, ceil(8 sigma))): the deposit of
    the pushed positions must reach one step's excursion."""
    g, x, v, reach, cap = _load(n, mesh, seed, load, ng)
    halo = (min(ng // mesh.world - 1, max(4, reach))
            if overrides.get("carried_rho") == "on" else 0)
    cfg = domain.DomainConfig(g, DT, g.length * DENSITY / n,
                              num_shards=mesh.world, halo=halo,
                              migrate_cap=cap, **overrides)
    st = domain.init_state(x, v, -E_CHARGE, M_ELECTRON, cfg, mesh,
                           capacity_factor=_capacity_factor(mesh))
    return cfg, st


def host_load(n: int, seed: int = 1):
    """bench.py's Landau distribution made on the CPU from a seeded
    torch.Generator, as numpy float32 (x, v): a load that is the same on
    every device and rank, for the card-against-CPU checks."""
    x, v = device_load(n, grid().length, torch.device("cpu"), seed)
    return x.numpy(), v.numpy()


def rank_run(mesh, load, jobs):
    """Each job (engine, steps, overrides) in order on this rank
    (``parallel.spawn`` calls it on every rank): ``steps`` steps of the
    row ('implicit' or 'explicit') from ``load`` (an "ng" among the
    overrides sets the row's grid). Returns, a job each, the
    metric rows (lists of numbers), this rank's final p, v and alive as
    numpy, the bytes the mesh staged and the launch counts of the job (and
    those in a large mode, ``cuda_cic.LARGE_LAUNCHES``)."""
    return [_rank_job(mesh, load, *job) for job in jobs]


def _rank_job(mesh, load, engine: str, steps: int, overrides: dict):
    from ..ops import cuda_cic

    cuda_cic.reset_launch_counts()
    staged = mesh.staged_bytes
    n = len(load[0])
    if engine == "implicit":
        cfg, st = implicit_row(mesh, n, load=load, **overrides)
        step = domain_implicit.make_step(cfg, mesh)
    else:
        cfg, st = explicit_row(mesh, n, load=load, **overrides)
        step = domain.make_step(cfg, mesh)
    st, m = run(step, st, steps)
    rows = {k: v.cpu().tolist() for k, v in m._asdict().items()}
    return dict(rows=rows, p=st.p.cpu().numpy(), v=st.v.cpu().numpy(),
                alive=st.alive.cpu().numpy(),
                staged_bytes=mesh.staged_bytes - staged,
                launches={k: c for k, c in cuda_cic.LAUNCHES.items() if c},
                large_launches=dict(cuda_cic.LARGE_LAUNCHES))


def timed(step, state, steps: int, warmup: int = 0):
    """``warmup`` steps, then ``steps`` timed ones (host clock around work
    that ends in a synchronize), the host syncs counted by the sync debug
    mode over them. Returns (seconds, syncs, launches, final state,
    stacked metrics); ``launches``: what each kernel's count rose by over
    the timed steps (the counts are not reset)."""
    from ..ops import cuda_cic

    dev = state.p.device
    if warmup:
        state, _ = run(step, state, warmup)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
    before = dict(cuda_cic.LAUNCHES)
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if cuda:
            torch.cuda.set_sync_debug_mode("warn")
        try:
            state, m = run(step, state, steps)
        finally:
            if cuda:
                torch.cuda.set_sync_debug_mode(0)
    if cuda:
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    syncs = sum("called a synchronizing" in str(w.message) for w in caught)
    launches = {k: c - before.get(k, 0) for k, c in cuda_cic.LAUNCHES.items()
                if c != before.get(k, 0)}
    return seconds, syncs, launches, state, m


def drive(step, state, n: int, warmup: int, steps: int) -> tuple[dict, object]:
    """``timed`` with the periodic rows' summary. Returns (results, final
    state)."""
    seconds, syncs, _, state, m = timed(step, state, steps, warmup)
    tot = (m.field_energy.double() + m.kinetic_energy.double()).cpu()
    res = dict(n=n, steps=steps, ms_per_step=seconds * 1e3 / steps,
               rows={k: v.cpu().tolist() for k, v in m._asdict().items()},
               pushes_per_s=n * steps / seconds,
               total_energy_rel_change=float((tot[-1] - tot[0]) / tot[0]),
               n_dropped=int(m.n_dropped.sum()),
               n_halo_clamped=int(m.n_halo_clamped.sum()),
               n_alive_last=int(m.n_alive[-1]),
               host_syncs_per_step=syncs / steps)
    if hasattr(m, "picard_iters"):
        res["picard_mean"] = float(m.picard_iters.float().mean())
        res["picard_clamped"] = int(m.picard_clamped.sum())
    return res, state


MAG_N_PER_SPECIES = 166_666  # n = 999,996: bench.py's configs[3] row
MAG_STEPS = 200
SHEATH_N, SHEATH_NG, SHEATH_STEPS = 1_000_000, 51, 1200


def magnetized_row(mesh, n_per_species: int = MAG_N_PER_SPECIES,
                   replicas: int = 1, ng: int = 600,
                   solver: str = "distributed", **kw):
    """The ``pic_iead_dd`` preset on this rank: ``mesh`` is the world's
    mesh, cut into slabs x ``replicas`` (``make_mesh2``) when replicas >
    1; ``solver`` 'distributed' (the preset's chain solve) or 'replicated'
    (the global Newton kernel on every rank)."""
    import dataclasses

    from .. import presets
    from ..parallel import domain_magnetized

    pre = presets.pic_iead_dd(n_per_species=n_per_species, ng=ng,
                              replicas=replicas, mesh=mesh,
                              device=mesh.device, **kw)
    if solver == pre.config.solver:
        return pre
    cfg = dataclasses.replace(pre.config, solver=solver)
    slabs = pre.meta["mesh"]
    return dataclasses.replace(
        pre, config=cfg,
        step_builder=lambda: domain_magnetized.make_step(cfg, slabs))


def sheath_row(mesh, n: int = SHEATH_N, ng: int = SHEATH_NG, **overrides):
    """(cfg, this rank's DomainSheathState) of the configs[2] row's
    physics (``tools/sheath.py``: density 1e19, dt 1e-12, dx 1e-5, Te = Ti
    = 10 eV, the extrapolated Picard start and Anderson(1), the load of
    seed 3) slab-sharded over the ranks of ``mesh``; ``overrides``
    replace config fields."""
    from .. import initialize
    from ..parallel import domain_sheath
    from . import sheath as srow

    length = srow.DX * (ng - 1)
    g = GridSpec(ng, length, "dirichlet-dirichlet")
    cfg = domain_sheath.DomainSheathConfig(**{**dict(
        grid=g, dt=srow.DT, p2c=length * srow.DENSITY / n,
        kbte=K_BOLTZMANN * srow.TE, kbti=K_BOLTZMANN * srow.TI,
        num_shards=mesh.world, picard_init="extrapolate",
        picard_accel="anderson", migrate_cap=max(4096, n // 256)),
        **overrides})
    d = initialize.initialize_sheath(n, srow.DENSITY, 1.0, 0.0, g, srow.TE,
                                     srow.TI, seed=3)
    st = domain_sheath.init_state(d["x"], d["v"], d["q"], d["m"],
                                  d["species"], cfg, mesh)
    return cfg, st


def timed_rows(step, state, steps: int, warmup: int = 0) -> dict:
    """``timed`` with the bounded rows' summary: ms/step, syncs and
    launches a step, the metric rows (scalars as lists; phi of the first
    and the last step), the stacked metrics and the final state."""
    seconds, syncs, launches, state, m = timed(step, state, steps, warmup)
    rows = {k: v.cpu().tolist() for k, v in m._asdict().items()
            if v.dim() == 1}
    return dict(steps=steps, ms_per_step=seconds * 1e3 / steps,
                host_syncs_per_step=syncs / steps,
                launches_per_step={k: c / steps for k, c in launches.items()},
                rows=rows, phi_first=m.phi[0].cpu().tolist(),
                phi_last=m.phi[-1].cpu().tolist(), state=state,
                metrics=m)


def magnetized_summary(res: dict, phi_f: float) -> dict:
    """The ``--magnetized`` row's numbers and its checks (a list of
    problems): nothing dropped, n_active + wall losses constant, phi_max
    over the floating potential in 0.6-1.4 over the last 100 steps."""
    rows = res["rows"]
    tot = [a + h for a, h in zip(rows["n_active"], rows["n_hit_wall"])]
    tail = rows["phi_max"][-min(100, len(rows["phi_max"])):]
    ratio = sum(tail) / len(tail) / phi_f
    out = dict(newton_mean=sum(rows["newton_iters"]) / len(rows["newton_iters"]),
               newton_max=max(rows["newton_iters"]),
               n_dropped=sum(rows["n_dropped"]),
               n_migrated=sum(rows["n_migrated"]),
               population=[min(tot), max(tot)], phi_max_over_phi_f=ratio)
    problems = []
    if out["n_dropped"]:
        problems.append(f"{out['n_dropped']} dropped")
    if min(tot) != max(tot):
        problems.append(f"n_active + wall losses in {out['population']}")
    if not 0.6 < ratio < 1.4:
        problems.append(f"phi_max / phi_f {ratio}")
    return out, problems


def sheath_summary(res: dict, n: int, maxiter: int) -> tuple:
    """The ``--sheath`` row's numbers and checks: nothing dropped, the
    population kept (n_active + losses = n), Picard within maxiter, the
    wall drops (last 300 steps) in -4 to -0.5 Te/e."""
    from . import sheath as srow

    rows = res["rows"]
    m = res["metrics"]
    tot = [a + b + c for a, b, c in zip(rows["n_active"], rows["n_lost_left"],
                                        rows["n_lost_right"])]
    iters = rows["picard_iters"]
    left, right = srow.wall_drops(m, min(300, len(iters)))
    out = dict(picard_mean=sum(iters) / len(iters), picard_max=max(iters),
               steps_at_maxiter=sum(k == maxiter for k in iters),
               n_dropped=sum(rows["n_dropped"]),
               n_migrated=sum(rows["n_migrated"]),
               n_halo_clamped=sum(rows["n_halo_clamped"]),
               population=[min(tot), max(tot)], wall_drop_left_te=left,
               wall_drop_right_te=right)
    problems = []
    if out["n_dropped"]:
        problems.append(f"{out['n_dropped']} dropped")
    if min(tot) != n or max(tot) != n:
        problems.append(f"n_active + losses in {out['population']}, n = {n}")
    if out["picard_max"] > maxiter:
        problems.append(f"Picard {out['picard_max']} > maxiter")
    return out, problems


def slab_jobs(mesh, jobs):
    """Each job (engine, kwargs) on this rank (``parallel.spawn`` calls it
    on every rank): 'magnetized' (``magnetized_row`` kwargs and
    ``steps``) or 'sheath' (``sheath_row`` kwargs and ``steps``). Returns,
    a job each, the timed rows (``timed_rows`` without the state), the
    bytes the mesh staged a step and this rank's particle count."""
    out = []
    for engine, kw in jobs:
        kw = dict(kw)
        steps = kw.pop("steps")
        if engine == "magnetized":
            pre = magnetized_row(mesh, **kw)
            step, st, root = pre.make_step(), pre.state, pre.meta["mesh"]
        else:
            cfg, st = sheath_row(mesh, **kw)
            from ..parallel import domain_sheath

            step, root = domain_sheath.make_step(cfg, mesh), mesh
        staged = _staged(root)
        res = timed_rows(step, st, steps)
        res.pop("state")
        res.pop("metrics")
        res.update(staged_bytes_per_step=(_staged(root) - staged) / steps,
                   capacity=int(st.p.shape[0]))
        out.append(res)
    return out


def _staged(mesh) -> int:
    """The bytes every mesh object of a rank has staged through the host
    (a Mesh2's three, or one SlabMesh)."""
    meshes = list(mesh) if isinstance(mesh, tuple) else [mesh]
    return sum(m.staged_bytes for m in meshes)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--explicit", action="store_true",
                    help="the explicit carrier (bench_domain_explicit)")
    ap.add_argument("--carried", action="store_true",
                    help="with --explicit: carried_rho='on' (bench.py "
                         "--carried)")
    ap.add_argument("--magnetized", action="store_true",
                    help="pic_iead_dd (parallel.domain_magnetized)")
    ap.add_argument("--sheath", action="store_true",
                    help="the configs[2] physics on parallel.domain_sheath")
    ap.add_argument("--n-per-species", type=int, default=MAG_N_PER_SPECIES)
    ap.add_argument("--replicas", type=int, default=1)
    ap.add_argument("--ng", type=int, default=None,
                    help="grid nodes (200 for configs[4] and its carriers, "
                         "600 for --magnetized, 51 for --sheath)")
    ap.add_argument("--solver", choices=("distributed", "replicated"),
                    default="distributed",
                    help="--magnetized: the slab Newton's solver")
    ap.add_argument("--n", type=int, default=None)
    ap.add_argument("--warmup", type=int, default=WARMUP)
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--save", metavar="PATH",
                    help="write the result with its per-step rows (JSON)")
    ap.add_argument("--against", metavar="PATH",
                    help="a result --save wrote for the same row, load and "
                         "steps on another number of ranks: print the "
                         "energy gaps and whether the counts agree")
    return ap


def main(argv=None) -> dict:
    ap = parser()
    args = ap.parse_args(argv)
    if args.carried and not args.explicit:
        ap.error("--carried is the explicit carrier's option (--explicit)")
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    process_group()
    mesh = make_mesh()
    if args.magnetized or args.sheath:
        return bounded_main(args, mesh)
    args.n = N if args.n is None else args.n
    ng = args.ng or NG
    if args.explicit:
        cfg, st = explicit_row(mesh, args.n, ng=ng, **(
            dict(carried_rho="on") if args.carried else {}))
        step = domain.make_step(cfg, mesh)
    else:
        cfg, st = implicit_row(mesh, args.n, ng=ng)
        step = domain_implicit.make_step(cfg, mesh)
    res, _ = drive(step, st, args.n, args.warmup, args.steps)
    res.update(row=("domain_explicit_carried" if args.carried else
                    "domain_explicit" if args.explicit else "domain"),
               device=torch.cuda.get_device_name(mesh.device),
               ranks=mesh.world, ng=ng, halo=cfg.halo,
               capacity=int(st.p.shape[0]))
    if args.against:
        with open(args.against) as f:
            res["against"] = compare(json.load(f), res)
    if mesh.rank == 0:
        if args.save:
            with open(args.save, "w") as f:
                json.dump(res, f)
        print(json.dumps({k: v for k, v in res.items() if k != "rows"}))
    dist.destroy_process_group()
    return res


def bounded_main(args, mesh) -> dict:
    """``--magnetized`` / ``--sheath``: the row on this rank, one JSON
    line from rank 0; exits non-zero on a failed check."""
    steps = args.steps if args.steps != STEPS else (
        MAG_STEPS if args.magnetized else SHEATH_STEPS)
    if args.magnetized:
        pre = magnetized_row(mesh, args.n_per_species, args.replicas,
                             args.ng or 600, args.solver)
        n = args.n_per_species * 6
        res = timed_rows(pre.make_step(), pre.state, steps, args.warmup)
        summary, problems = magnetized_summary(
            res, pre.meta["floating_potential"])
        row = "pic_iead_dd"
    else:
        n = args.n or SHEATH_N
        cfg, st = sheath_row(mesh, n, args.ng or SHEATH_NG)
        from ..parallel import domain_sheath

        res = timed_rows(domain_sheath.make_step(cfg, mesh), st, steps,
                         args.warmup)
        summary, problems = sheath_summary(res, n, cfg.maxiter)
        row = "domain_sheath"
    out = dict(row=row, device=torch.cuda.get_device_name(mesh.device),
               ranks=mesh.world, n=n, steps=steps,
               ms_per_step=res["ms_per_step"],
               pushes_per_s=n * 1e3 / res["ms_per_step"],
               host_syncs_per_step=res["host_syncs_per_step"],
               launches_per_step=res["launches_per_step"], **summary,
               problems=problems)
    if mesh.rank == 0:
        print(json.dumps(out))
    dist.destroy_process_group()
    if problems:
        raise SystemExit(f"{row}: " + "; ".join(problems))
    return out


def compare(ref: dict, got: dict) -> dict:
    """Two runs of one row and load on different ranks: the largest
    relative gap of the field and kinetic energies over the steps, and
    whether each count agrees step by step."""
    a, b = ref["rows"], got["rows"]
    out = dict(ranks=ref["ranks"], ms_per_step=ref["ms_per_step"])
    for k in ("field_energy", "kinetic_energy"):
        out[k] = max(abs(x - y) / abs(x) for x, y in zip(a[k], b[k]))
    for k in ("picard_iters", "n_dropped", "n_halo_clamped", "n_alive"):
        if k in a:
            out[f"{k}_equal"] = a[k] == b[k]
    return out


if __name__ == "__main__":
    main()
