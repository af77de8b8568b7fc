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
(``parallel.domain``, halo 0, the fused push) on the same load.

    python -m pypic_tpu_torch.tools.domain [--explicit] [--n N]
        [--warmup 2] [--steps 30]
    torchrun --nproc-per-node 4 -m pypic_tpu_torch.tools.domain
        (with PYPIC_DISTRIBUTED=1: one rank a card, NCCL)

Without a process group it makes a one-rank group (NCCL on the card, a
``tcp://localhost`` rendezvous on a free port), as bench.py runs the row
on one chip. It steps 2 warm-up and 30 timed steps and prints one
JSON line: ms/step, pushes/s, the Picard mean, the total energy change
over the timed steps, the n_dropped and n_halo_clamped sums and the host
syncs a step (``torch.cuda.set_sync_debug_mode('warn')`` over the timed
steps). ``--save PATH`` writes the result
with its per-step rows; ``--against PATH`` compares this run with a saved
one of the same row on another number of ranks (four cards against one:
the energy gaps step by step, the counts). It needs an NVIDIA GPU.
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


def grid() -> GridSpec:
    debye = math.sqrt(K_BOLTZMANN * TE * EPSILON_0 / E_CHARGE**2 / DENSITY)
    return GridSpec(NG, 22.0 * debye, "periodic")


def _load(n: int, mesh, seed: int, load=None):
    """The Landau grid, the load (``load`` = (x, v), else made on the
    mesh's device from ``seed``), the halo and the migration bucket as
    bench_domain sizes them."""
    g = grid()
    if load is None:
        x, v = device_load(n, g.length, mesh.device, seed)
    else:
        x, v = (torch.as_tensor(a, device=mesh.device) for a in load)
    sigma_cells = float(v.std()) * DT / g.dx
    halo = min(NG // mesh.world - 3, max(4, math.ceil(8.0 * sigma_cells)))
    return g, x, v, halo, max(4096, 4 * (n // NG))


def _capacity_factor(mesh) -> float:
    # one rank has no load imbalance; more keep bench's 1.5 (the
    # perturbation piles particles into the wave-crest slabs)
    return 1.05 if mesh.world == 1 else 1.5


def implicit_row(mesh, n: int = N, seed: int = 1, load=None, **overrides):
    """(cfg, this rank's DomainImplicitState) of configs[4]; ``overrides``
    replace conserving-configuration fields (finalize, window_share,
    backend, ...); ``load`` = (x, v) replaces the seeded load."""
    g, x, v, halo, cap = _load(n, mesh, seed, load)
    cfg = domain_implicit.DomainImplicitConfig(
        g, DT, g.length * DENSITY / n, num_shards=mesh.world,
        halo=halo, migrate_cap=cap, **{**CONSERVING, **overrides})
    st = domain_implicit.init_state(x, v, -E_CHARGE, M_ELECTRON, cfg, mesh,
                                    capacity_factor=_capacity_factor(mesh))
    return cfg, st


def explicit_row(mesh, n: int = N, seed: int = 1, load=None, **overrides):
    """(cfg, this rank's DomainState) of bench_domain_explicit: halo 0 (the
    per-step path migrates every step), the fused push on the card."""
    g, x, v, _, cap = _load(n, mesh, seed, load)
    cfg = domain.DomainConfig(g, DT, g.length * DENSITY / n,
                              num_shards=mesh.world, halo=0, migrate_cap=cap,
                              **overrides)
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
    row ('implicit' or 'explicit') from ``load``. Returns, a job each, the
    metric rows (lists of numbers), this rank's final p, v and alive as
    numpy, the bytes the mesh staged and the launch counts of the job."""
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
                launches={k: c for k, c in cuda_cic.LAUNCHES.items() if c})


def drive(step, state, n: int, warmup: int, steps: int) -> tuple[dict, object]:
    """``warmup`` steps, then ``steps`` timed ones (host clock around work
    that ends in a synchronize), the host syncs counted by the sync debug
    mode over them. Returns (results, final state)."""
    dev = state.p.device
    if warmup:
        state, _ = run(step, state, warmup)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
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


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--explicit", action="store_true",
                    help="the explicit carrier (bench_domain_explicit)")
    ap.add_argument("--n", type=int, default=N)
    ap.add_argument("--warmup", type=int, default=WARMUP)
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--save", metavar="PATH",
                    help="write the result with its per-step rows (JSON)")
    ap.add_argument("--against", metavar="PATH",
                    help="a result --save wrote for the same row, load and "
                         "steps on another number of ranks: print the "
                         "energy gaps and whether the counts agree")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    process_group()
    mesh = make_mesh()
    if args.explicit:
        cfg, st = explicit_row(mesh, args.n)
        step = domain.make_step(cfg, mesh)
    else:
        cfg, st = implicit_row(mesh, args.n)
        step = domain_implicit.make_step(cfg, mesh)
    res, _ = drive(step, st, args.n, args.warmup, args.steps)
    res.update(row="domain_explicit" if args.explicit else "domain",
               device=torch.cuda.get_device_name(mesh.device),
               ranks=mesh.world, halo=cfg.halo, capacity=int(st.p.shape[0]))
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
