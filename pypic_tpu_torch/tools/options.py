"""The engines' options on the card: finalize_field and Anderson(2) on the
implicit headline, Anderson(2) and Anderson(M) on the sheath row, both
migration-amortized supersteps, the carried magnetized deposit under data
parallelism and deposit_method. ``chip_smoke.py`` phase 38 drives these
and checks what they return.

    python -m pypic_tpu_torch.tools.options [--part headline|sheath|
        superstep|carried|deposit]

Each part returns (and the command prints, one JSON line) its figures:
ms/step beside the plain option's in the same process, the kernel
launches and host syncs a step, the counts the part checks. The parts:

* ``headline``: the headline cell (``tools/headline.py``, n =
  100,007,936, ng 200, the conserving configuration) from one initial
  state, 2 + 10 steps each of 'last' with Anderson(1), finalize_field
  'mean2', 'map' and 'aitken', picard_accel 'anderson2', and 'aitken'
  under finalize='converged-deposit';
* ``sheath``: bench.py's configs[2] row (``tools/sheath.py``, n = 1e6,
  ng 51) for 20 steps with 'anderson', 'anderson2' and 'anderson4';
* ``superstep``: configs[4] (``tools/domain.py``, n = 1e8, the
  conserving configuration) and its explicit carrier (n = 20,000) on this
  rank's mesh: make_step, superstep(k=1) and superstep(k=2), the halo
  k-scaled (2 x ceil(8 sigma)); ``superstep_jobs`` runs the n = 20,000
  cases on the ranks of ``parallel.spawn``; ``carried_carrier_k1`` the
  carrier's carried_rho='on' form, which takes k = 1 only. ``RawMode`` records the
  finalize sweeps a superstep launches in their raw mode (ng 0) and
  holds the kernel against its plain version on the recorded inputs;
* ``carried``: the configs[3] row (``tools/magnetized.py``, n =
  999,996) with carried_deposit='on', react_batch 512 and the 'hash'
  sampler, with ``axis_name`` on this rank's mesh against without;
  ``carried_job`` runs it on the ranks of ``parallel.spawn``;
* ``deposit``: deposit_method 'pallas' at the headline set-up (row 4's
  kernel), 'scatter' and 'matmul' (``deposit_det``) at n = 1e6, ng 51.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import torch

from .. import devices
from ..engines import implicit, magnetized, sheath
from ..ops import cic, cuda_cic, cuda_domain
from ..parallel import dataparallel, domain, domain_implicit, make_mesh
from ..runner import run
from . import domain as drow
from . import headline, magnetized as mrow, sheath as srow

WARMUP, TIMED = 2, 10
HEADLINE_OPTIONS = {
    "last": {},
    "mean2": dict(finalize_field="mean2"),
    "map": dict(finalize_field="map"),
    "aitken": dict(finalize_field="aitken"),
    "anderson2": dict(picard_accel="anderson2"),
    "aitken converged-deposit": dict(finalize_field="aitken",
                                     finalize="converged-deposit"),
}
SHEATH_ACCELS = ("anderson", "anderson2", "anderson4")
SHEATH_STEPS = 20
SUPER_N_SMALL, SUPER_STEPS = 20_000, 4
CARRIED = dict(carried_deposit="on", react_batch=512, source_sampler="hash")
CARRIED_STEPS = 20
DEPOSIT_N, DEPOSIT_NG = 1_000_000, 51
# deposit_det's large mode (above 1,815 nodes: int64 fixed-point sums)
LARGE_NG = 2000


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def headline_options(dev, n: int = headline.N_HEADLINE,
                     warm: int = WARMUP, steps: int = TIMED) -> dict:
    """Each of HEADLINE_OPTIONS from one initial state of the headline
    cell: ms/step, launches and host syncs a step (the sync debug mode
    over the timed steps), the Picard mean and the total energy change
    over warm + timed steps."""
    cfg0, _, st0 = headline.headline_state(n, dev)
    _sync(dev)
    out = {}
    for label, opts in HEADLINE_OPTIONS.items():
        cfg = dataclasses.replace(cfg0, **opts)
        step = implicit.make_step(cfg)
        st, wm = run(step, st0, warm)
        seconds, syncs, launches, st, m = drow.timed(step, st, steps)
        fe = torch.cat([wm.field_energy, m.field_energy]).double().cpu()
        ke = torch.cat([wm.kinetic_energy, m.kinetic_energy]).double().cpu()
        tot = fe + ke
        out[label] = dict(
            n=n, steps=steps, ms_per_step=seconds * 1e3 / steps,
            pushes_per_s=n * steps / seconds,
            launches_per_step={k: v / steps for k, v in launches.items()},
            host_syncs_per_step=syncs / steps,
            picard_iters=sorted(set(m.picard_iters.cpu().tolist())),
            total_energy_rel_change=float((tot[-1] - tot[0]) / tot[0]),
            finite=bool(torch.isfinite(st.p).all() and torch.isfinite(tot).all()),
            launches=launches)
        del st, m
    return out


def headline_check(dev, n: int = 20_000, steps: int = 3) -> dict:
    """Each option at n particles, ``steps`` steps on the card and on the
    CPU from one CPU-made load: (the CPU's, the card's) (state, metrics)
    an option."""
    from .. import initialize
    from ..constants import E_CHARGE, M_ELECTRON

    cfg0 = headline.headline_config(n)
    x, v, _ = initialize.initialize_periodic(
        "landau-damping", n, 1e5, 1, 0.8, cfg0.grid, 100.0 * 11600.0,
        0.1 * 11600.0, seed=1)
    out = {}
    for label, opts in HEADLINE_OPTIONS.items():
        cfg = dataclasses.replace(cfg0, **opts)
        pair = []
        for device in ("cpu", dev):
            st = implicit.init_state(x, v, -E_CHARGE, M_ELECTRON, cfg,
                                     device=device)
            pair.append(run(implicit.make_step(cfg), st, steps))
        out[label] = pair
    return out


def sheath_options(dev, steps: int = SHEATH_STEPS) -> dict:
    """The configs[2] row for ``steps`` steps (after one warm-up step)
    with each of SHEATH_ACCELS: ms/step, the Picard passes a step (mean,
    max), launches and host syncs a step, the wall losses a step."""
    cfg0, st0 = srow.state(dev)
    out = {}
    for acc in SHEATH_ACCELS:
        cfg = dataclasses.replace(cfg0, picard_accel=acc)
        step = sheath.make_step(cfg)
        seconds, syncs, launches, st, m = drow.timed(step, st0, steps,
                                                     warmup=1)
        iters = m.picard_iters.cpu()
        out[acc] = dict(
            n=srow.N, steps=steps, ms_per_step=seconds * 1e3 / steps,
            picard_mean=float(iters.float().mean()),
            picard_max=int(iters.max()),
            host_syncs_per_step=syncs / steps,
            launches_per_step={k: v / steps for k, v in launches.items()},
            lost_per_step=float((m.n_lost_left + m.n_lost_right).float().mean()),
            finite=bool(torch.isfinite(st.e).all()), launches=launches)
    return out


class RawMode:
    """Inside ``with RawMode() as raw:``, the finalize sweeps of the slab
    engine (``cuda_domain.picard_finalize_ext_nodep`` and
    ``picard_finalize_ext``) are counted where they run in the raw mode
    (ng 0), and the inputs of each kernel's first raw call are kept.
    ``check()`` then launches the kernel again on those inputs and holds
    it against its plain version on the same inputs (the positions and
    velocities, the statistics, the deposit against a float64 sum)."""

    NAMES = ("picard_finalize_ext_nodep", "picard_finalize_ext")

    def __init__(self):
        self.counts = dict.fromkeys(self.NAMES, 0)
        self.kept = {}
        self._real = {}

    def __enter__(self):
        for name in self.NAMES:
            real = getattr(cuda_domain, name)
            self._real[name] = real

            def spy(*args, _name=name, _real=real, **kw):
                if kw.get("ng") == 0:
                    self.counts[_name] += 1
                    if _name not in self.kept:
                        self.kept[_name] = ([a.clone() for a in args],
                                            dict(kw))
                return _real(*args, **kw)

            setattr(cuda_domain, name, spy)
        return self

    def __exit__(self, *exc):
        for name, real in self._real.items():
            setattr(cuda_domain, name, real)
        return False

    def check(self) -> dict:
        """{kernel: {errors}} of each kept call: p1 and v1 relative to
        their largest value, the statistics (the clamp count exact), j1
        against the plain terms summed in float64."""
        out = {}
        for name, (args, kw) in self.kept.items():
            deposit = name == "picard_finalize_ext"
            before = cuda_cic.LAUNCHES[name]
            got = getattr(cuda_domain, name)(*args, **kw)
            cuda_cic.LAUNCHES[name] = before  # a comparison, not the path
            ref = cuda_domain.picard_finalize_ext_plain(
                *args, deposit=deposit, **kw)

            def rel(a, b):
                a, b = a.double(), b.double()
                return float((a - b).abs().max() / a.abs().max().clamp_min(1e-300))

            st, st_ref = got[-1].double().cpu(), ref[-1].double().cpu()
            errs = dict(p=rel(ref[0], got[0]), v=rel(ref[1], got[1]),
                        stats=float(((st[:2] - st_ref[:2]).abs()
                                     / st_ref[:2].abs().clamp_min(1e-300)).max()),
                        clamped=(int(st[2]), int(st_ref[2])),
                        n=int(args[1].shape[0]),
                        raw_span=(float(got[0].min()), float(got[0].max())))
            if deposit:
                exact = cuda_domain.picard_finalize_ext_plain(
                    *args, deposit=True, acc_dtype=torch.float64, **kw)[2]
                errs["j"] = rel(exact, got[2])
            out[name] = errs
        return out


def _super_cfg(engine: str, mesh, n: int, k: int, load=None, **overrides):
    """(cfg, state) of configs[4] (``implicit``) or its carrier
    (``explicit``) on this rank, with the halo scaled to k steps of the
    8-sigma excursion (at k = 1 the row's own)."""
    _, x, v, reach, cap = drow._load(n, mesh, 1, load)
    if engine == "implicit":
        cfg, st = drow.implicit_row(mesh, n, load=(x, v), **overrides)
        halo = min(drow.NG // mesh.world - 3, max(4, k * reach))
    else:
        cfg, st = drow.explicit_row(mesh, n, load=(x, v), **overrides)
        halo = min(drow.NG // mesh.world - 1, max(4, k * reach))
    return dataclasses.replace(cfg, halo=halo, migrate_cap=cap * k), st


def superstep_case(mesh, engine: str, n: int, steps: int, k: int = 2,
                   warm: int = 0, **overrides) -> dict:
    """make_step for ``steps`` steps, superstep(k=1) for ``steps`` calls and
    superstep(k) for ``steps // k`` calls, each from one initial state
    after ``warm`` warm-up steps (a multiple of k):
    their metric rows (one a step), ms/step, launches and host syncs a
    step, and the raw-mode finalize calls of the k superstep
    (``RawMode``, checked against the plain version)."""
    cfg, st0 = _super_cfg(engine, mesh, n, k, **overrides)
    mod = domain_implicit if engine == "implicit" else domain
    out = {"halo": cfg.halo}
    for label, step, calls in (
            ("make_step", mod.make_step(cfg, mesh), steps),
            ("k1", mod.make_superstep(cfg, mesh, 1), steps),
            (f"k{k}", mod.make_superstep(cfg, mesh, k), steps // k)):
        per_call = 1 if label == "make_step" else int(label[1:])
        st = st0
        if warm:  # warm steps, as whole calls
            st, _ = run(step, st, max(1, warm // per_call))
        start = int(st.step)
        with RawMode() as raw:  # the timed calls only
            cuda_cic.reset_launch_counts()
            seconds, syncs, launches, st, m = drow.timed(step, st, calls)
        done = calls * per_call
        out[label] = dict(
            rows={f: v.reshape(-1).cpu().tolist() for f, v in m._asdict().items()},
            shape=tuple(m.n_alive.shape), step=int(st.step) - start,
            ms_per_step=seconds * 1e3 / done,
            host_syncs_per_step=syncs / done,
            launches_per_step={q: c / done for q, c in launches.items()},
            launches=launches, raw_launches=dict(raw.counts),
            raw_check=raw.check() if label != "make_step" else {},
            finite=bool(torch.isfinite(st.p).all()))
        del st, m
    return out


def carried_carrier_k1(mesh, n: int = SUPER_N_SMALL,
                       steps: int = SUPER_STEPS) -> dict:
    """The explicit carrier with carried_rho='on' (one
    ``explicit_domain_cycle`` a step) through make_step and through
    superstep(k=1) for ``steps`` steps from one state: the metric rows and
    launches of each."""
    cfg, st0 = drow.explicit_row(mesh, n, load=drow.host_load(n),
                                 carried_rho="on")
    out = {}
    for label, step in (("make_step", domain.make_step(cfg, mesh)),
                        ("k1", domain.make_superstep(cfg, mesh, 1))):
        cuda_cic.reset_launch_counts()
        seconds, syncs, launches, st, m = drow.timed(step, st0, steps)
        out[label] = dict(
            rows={f: v.reshape(-1).cpu().tolist() for f, v in m._asdict().items()},
            ms_per_step=seconds * 1e3 / steps, launches=launches,
            step=int(st.step) - int(st0.step))
    return out


def superstep_jobs(mesh, jobs) -> list:
    """Each job (engine, overrides) on this rank (``parallel.spawn`` calls
    it on every rank): ``superstep_case`` at n = 20,000, 4 steps, k = 2,
    from ``drow.host_load`` (the same load on every device)."""
    load = drow.host_load(SUPER_N_SMALL)
    return [superstep_case(mesh, engine, SUPER_N_SMALL, SUPER_STEPS,
                           load=load, **over) for engine, over in jobs]


def rank_jobs(mesh, jobs) -> dict:
    """The two-rank parts in one spawn: ``superstep_jobs(mesh, jobs)`` and
    the carried row under ``axis_name`` (``carried_job``)."""
    return dict(superstep=superstep_jobs(mesh, jobs), carried=carried_job(mesh))


def carried_config(device, axis: bool,
                   n_per_species: int = mrow.N_PER_SPECIES):
    """(cfg, whole state) of the configs[3] row with CARRIED's options,
    the carry primed; ``axis``: axis_name 'particles'."""
    cfg, st, _ = mrow.state(device, n_per_species)
    cfg = dataclasses.replace(cfg, **CARRIED,
                              axis_name="particles" if axis else None)
    return cfg, magnetized.prime_carry(st, cfg)


def carried_job(mesh, steps: int = CARRIED_STEPS, axis: bool = True,
                n_per_species: int = mrow.N_PER_SPECIES) -> dict:
    """The carried configs[3] row on this rank: with ``axis``, its block
    (``shard_state``) under ``axis_name``, else the one-device step (one
    rank). One warm-up step, then ``steps`` timed ones: ms/step, launches
    and host syncs a step, the scalar rows, the carry sums and this rank's
    carried rho and n (global: the same on every rank)."""
    cfg, whole = carried_config(mesh.device, axis, n_per_species)
    if axis:
        st = dataparallel.shard_state(whole, mesh)
        step = dataparallel.make_data_parallel_step(
            magnetized.make_step, cfg, mesh, example_state=whole)
    else:
        st, step = whole, magnetized.make_step(cfg)
    del whole
    cuda_cic.reset_launch_counts()
    seconds, syncs, launches, st, m = drow.timed(step, st, steps, warmup=1)
    rows = {k: v.cpu().tolist() for k, v in m._asdict().items() if v.dim() == 1}
    return dict(rank=mesh.rank, world=mesh.world, axis=axis, steps=steps,
                n=int(st.p.shape[0]) * mesh.world,
                ms_per_step=seconds * 1e3 / steps,
                host_syncs_per_step=syncs / steps,
                launches_per_step={k: v / steps for k, v in launches.items()},
                launches=launches, rows=rows,
                sums={k: int(sum(rows[k])) for k in mrow.CARRIED_SUMS},
                carry=torch.stack([st.rho, st.n]).cpu().numpy(),
                finite=bool(torch.isfinite(st.phi).all()))


def deposit_methods(dev) -> dict:
    """deposit_method 'pallas' in init_state at the headline set-up (the
    deposit kernel's launches), then 'scatter' and 'matmul' at n = 1e6,
    ng 51: twice each (the same bits?), the gap to the deposit kernel
    relative to the largest node, the same at ng = 2,000 (deposit_det's
    large mode: int64 fixed-point sums) and the raise above
    ``cuda_cic.LARGE_MAX_NG``."""
    from ..constants import E_CHARGE, M_ELECTRON

    out = {}
    cfg = dataclasses.replace(headline.headline_config(headline.N_HEADLINE),
                              deposit_method="pallas")
    x, v = headline.device_load(headline.N_HEADLINE, cfg.grid.length, dev)
    cuda_cic.reset_launch_counts()
    st = implicit.init_state(x, v, -E_CHARGE, M_ELECTRON, cfg, device=dev)
    _sync(dev)
    out["pallas"] = dict(n=headline.N_HEADLINE, launches={
        k: c for k, c in cuda_cic.LAUNCHES.items() if c},
        finite=bool(torch.isfinite(st.e).all()))
    del st, x, v
    gen = torch.Generator(device=dev).manual_seed(5)
    p = torch.rand(DEPOSIT_N, generator=gen, device=dev) * (DEPOSIT_NG - 1)
    w = torch.randn(DEPOSIT_N, generator=gen, device=dev)
    p_large = p * ((LARGE_NG - 1) / (DEPOSIT_NG - 1))
    for method in ("scatter", "matmul"):
        rec = dict(n=DEPOSIT_N, ng=DEPOSIT_NG)
        for tag, pos, ng in (("", p, DEPOSIT_NG), ("_large", p_large, LARGE_NG)):
            ref = cic.deposit(pos, w, ng, periodic=False)
            a = cic.deposit(pos, w, ng, periodic=False, method=method)
            b = cic.deposit(pos, w, ng, periodic=False, method=method)
            rec[f"same_bits{tag}"] = torch.equal(a, b)
            rec[f"gap_to_deposit{tag}"] = float((a.double() - ref.double()).abs().max()
                                                / ref.double().abs().max())
        try:
            cic.deposit(p, w, cuda_cic.LARGE_MAX_NG + 1, periodic=False, method=method)
            rec["raise_above_large_max_ng"] = ""
        except ValueError as e:
            rec["raise_above_large_max_ng"] = str(e)
        out[method] = rec
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--part", default="headline",
                    choices=("headline", "sheath", "superstep", "carried",
                             "deposit"))
    args = ap.parse_args(argv)
    dev = devices.resolve(None)
    if args.part == "headline":
        res = headline_options(dev)
    elif args.part == "sheath":
        res = sheath_options(dev)
    elif args.part == "superstep":
        drow.process_group()
        res = superstep_case(make_mesh(device=dev), "implicit", drow.N,
                             SUPER_STEPS, warm=WARMUP)
    elif args.part == "carried":
        drow.process_group()
        mesh = make_mesh(device=dev)
        res = {"axis": carried_job(mesh), "one_device": carried_job(
            mesh, axis=False)}
        for r in res.values():
            r.pop("carry")
    else:
        res = deposit_methods(dev)
    for r in (res.values() if isinstance(res, dict) else ()):
        if isinstance(r, dict):
            r.pop("rows", None)
    print(json.dumps(res, default=str))
    return res


if __name__ == "__main__":
    main()
