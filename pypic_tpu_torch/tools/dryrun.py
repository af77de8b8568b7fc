"""The multi-rank dry run (the counterpart of ``__graft_entry__.py``
``dryrun_multichip``): one step of each parallel composition on tiny
shapes, over N ranks, each mode isolated so that one broken composition
does not hide the others.

    python -m pypic_tpu_torch.tools.dryrun [--ranks 2] [--device cpu]
        [--particles-per-rank 128]

It starts N ranks (``parallel.spawn``: gloo on the CPU; on the card NCCL
with a card a rank when there are N cards, else gloo ranks sharing the
card, every message staged through the host) and runs on every rank, in
order, JAX's modes with JAX's invariants (no drops, the population kept,
finite fields). Each prints one line, ``dryrun[<mode>]: ok``, a note, or
``FAILED <error>``. It exits non-zero when a mode failed. Modes 5 and 13 (slabs x replicas) need an
even number of ranks (JAX's need four devices; two ranks run one slab x
two replicas).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch

@dataclasses.dataclass
class _Ctx:
    """The shared tiny problem of the modes (JAX's _DryrunCtx)."""

    mesh: object
    n_particles: int

    @property
    def world(self) -> int:
        return self.mesh.world

    @property
    def dev(self):
        return self.mesh.device

    def problem(self, ng: int = 32):
        """(grid, x, v, params, dt): the two-stream load of JAX's
        _small_problem (density 1e10, Te 0.1 eV, L = 15 Debye lengths)."""
        from .. import initialize
        from ..constants import E_CHARGE, EPSILON_0, K_BOLTZMANN
        from ..grid import GridSpec

        density, te = 1e10, 0.1 * 11600.0
        debye = np.sqrt(K_BOLTZMANN * te * EPSILON_0 / E_CHARGE**2 / density)
        grid = GridSpec(ng, 15.0 * debye, "periodic")
        x, v, params = initialize.initialize_periodic(
            "two-stream", self.n_particles, density, 1, 0.05, grid, te, te,
            seed=0)
        return grid, x, v, params, 0.1 / params.wp

    def grid_slabs(self, slabs: int | None = None):
        from ..grid import GridSpec

        grid = self.problem()[0]
        return GridSpec(16 * (slabs or self.world), grid.length, "periodic")

    @property
    def mcap(self) -> int:
        return max(256, 8 * self.n_particles // (16 * self.world))

    def pic_iead(self):
        from .. import presets

        n_per = max(8, (self.n_particles // 6 // self.world) * self.world)
        return n_per, presets.pic_iead(n_per_species=n_per, ng=16 * self.world,
                                       device=self.dev)


def _mode_dp_implicit(ctx):
    from ..constants import E_CHARGE, M_ELECTRON
    from ..engines import implicit
    from ..parallel import make_data_parallel_step, shard_state

    grid, x, v, params, dt = ctx.problem()
    cfg = implicit.ImplicitConfig(grid, dt, params.p2c, tol=1e-4, maxiter=10,
                                  backend="composed", axis_name="particles")
    st = implicit.init_state(x, v, -E_CHARGE, M_ELECTRON, cfg, device=ctx.dev)
    step = make_data_parallel_step(implicit.make_step, cfg, ctx.mesh,
                                   example_state=st)
    st2, m = step(shard_state(st, ctx.mesh))
    assert st2.p.shape == (ctx.n_particles // ctx.world,)
    assert np.isfinite(float(m.field_energy))


def _domain_explicit(ctx, **kw):
    from ..constants import E_CHARGE, M_ELECTRON
    from ..parallel import domain

    grid, x, v, params, dt = ctx.problem()
    cfg = domain.DomainConfig(ctx.grid_slabs(), dt, params.p2c,
                              num_shards=ctx.world, migrate_cap=ctx.mcap, **kw)
    st = domain.init_state(x, v, -E_CHARGE, M_ELECTRON, cfg, ctx.mesh)
    _, m = domain.make_step(cfg, ctx.mesh)(st)
    assert int(m.n_alive) == ctx.n_particles
    assert int(m.n_dropped) == 0
    assert np.isfinite(float(m.field_energy))


def _mode_domain_explicit(ctx):
    _domain_explicit(ctx)


def _mode_explicit_superstep(ctx):
    """The migration-amortized explicit superstep (k = 2, halo 4)."""
    from ..constants import E_CHARGE, M_ELECTRON
    from ..parallel import domain

    grid, x, v, params, dt = ctx.problem()
    cfg = domain.DomainConfig(ctx.grid_slabs(), dt, params.p2c,
                              num_shards=ctx.world, migrate_cap=ctx.mcap,
                              halo=4)
    st = domain.init_state(x, v, -E_CHARGE, M_ELECTRON, cfg, ctx.mesh)
    st2, m = domain.make_superstep(cfg, ctx.mesh, 2)(st)
    assert m.n_alive.shape == (2,)
    assert int(m.n_alive[-1]) == ctx.n_particles
    assert int(m.n_dropped.sum()) == 0
    assert int(st2.step) == 2


def _mode_carried_rho(ctx):
    _domain_explicit(ctx, carried_rho="on", halo=4)


def _domain_implicit(ctx):
    from ..constants import E_CHARGE, M_ELECTRON
    from ..parallel import domain_implicit as di

    grid, x, v, params, dt = ctx.problem()
    cfg = di.DomainImplicitConfig(ctx.grid_slabs(), dt, params.p2c,
                                  num_shards=ctx.world, tol=1e-4, maxiter=10,
                                  halo=4, migrate_cap=ctx.mcap)
    return cfg, di.init_state(x, v, -E_CHARGE, M_ELECTRON, cfg, ctx.mesh)


def _mode_domain_implicit(ctx):
    from ..parallel import domain_implicit as di

    cfg, st = _domain_implicit(ctx)
    _, m = di.make_step(cfg, ctx.mesh)(st)
    assert int(m.n_alive) == ctx.n_particles
    assert int(m.n_dropped) == 0
    assert np.isfinite(float(m.field_energy))


def _mode_implicit_superstep(ctx):
    """The superstep of the configs[4] composition (k = 2: metrics gain a
    (2,) axis)."""
    from ..parallel import domain_implicit as di

    cfg, st = _domain_implicit(ctx)
    st2, m = di.make_superstep(cfg, ctx.mesh, 2)(st)
    assert m.n_alive.shape == (2,)
    assert int(m.n_alive[-1]) == ctx.n_particles
    assert int(m.n_dropped.sum()) == 0
    assert int(st2.step) == 2


def _mode_domain_sheath(ctx):
    from .. import initialize
    from ..constants import K_BOLTZMANN
    from ..grid import GridSpec
    from ..parallel import domain_sheath as ds

    ng = 8 * ctx.world
    grid = GridSpec(ng, 1e-5 * (ng - 1), "dirichlet-dirichlet")
    te = 10.0 * 11600.0
    d = initialize.initialize_sheath(ctx.n_particles, 1e19, 1.0, 0.0, grid,
                                     te, te, seed=0)
    cfg = ds.DomainSheathConfig(
        grid, 1e-12, grid.length * 1e19 / ctx.n_particles,
        kbte=K_BOLTZMANN * te, kbti=K_BOLTZMANN * te, num_shards=ctx.world,
        halo=2, migrate_cap=ctx.mcap, maxiter=5)
    st = ds.init_state(d["x"], d["v"], d["q"], d["m"], d["species"], cfg,
                       ctx.mesh, seed=1)
    _, m = ds.make_step(cfg, ctx.mesh)(st)
    assert int(m.n_dropped) == 0
    assert (int(m.n_active) + int(m.n_lost_left) + int(m.n_lost_right)
            == ctx.n_particles)


def _mesh2(ctx):
    from ..parallel import make_mesh2

    if ctx.world % 2:
        return None
    return make_mesh2(ctx.world // 2, 2, device=ctx.dev)


def _mode_2d_slabs_x_dp(ctx):
    from ..constants import E_CHARGE, M_ELECTRON
    from ..parallel import domain_implicit as di

    m2 = _mesh2(ctx)
    if m2 is None:
        return "skipped (needs an even number of ranks)"
    grid, x, v, params, dt = ctx.problem()
    slabs = ctx.world // 2
    cfg = di.DomainImplicitConfig(
        ctx.grid_slabs(slabs), dt, params.p2c, num_shards=slabs, tol=1e-4,
        maxiter=10, halo=4, migrate_cap=ctx.mcap, dp_axis_name="dp",
        num_replicas=2)
    st = di.init_state(x, v, -E_CHARGE, M_ELECTRON, cfg, m2)
    _, m = di.make_step(cfg, m2)(st)
    assert int(m.n_alive) == ctx.n_particles
    assert int(m.n_dropped) == 0
    assert np.isfinite(float(m.field_energy))


def _dp_magnetized_cfg(ctx, **kw):
    _, pre = ctx.pic_iead()
    return dataclasses.replace(pre.config, axis_name="particles", **kw)


def _mode_dp_magnetized(ctx):
    from ..engines import magnetized
    from ..parallel import make_data_parallel_step, shard_state

    _, pre = ctx.pic_iead()
    cfg = _dp_magnetized_cfg(ctx)
    step = make_data_parallel_step(magnetized.make_step, cfg, ctx.mesh,
                                   example_state=pre.state)
    _, m = step(shard_state(pre.state, ctx.mesh))
    assert np.isfinite(float(m.phi_max))
    assert int(m.n_active) >= 0


def _capped(ctx):
    """('capped-source' config, a state at twice the capacity, its step):
    the capped-reactivation and BCA-cadence modes' set-up."""
    from ..engines import magnetized
    from ..parallel import make_data_parallel_step

    n_per, pre = ctx.pic_iead()
    cfg = _dp_magnetized_cfg(ctx, reactivate="capped-source",
                             source_n=n_per + 4)
    s0 = pre.state
    st = magnetized.init_state(
        s0.p.cpu().numpy() * pre.config.grid.dx, s0.v.cpu().numpy(),
        s0.m.cpu().numpy(), s0.charge_state.cpu().numpy(),
        s0.p2c.cpu().numpy(), s0.species_idx.cpu().numpy(), cfg,
        capacity=2 * s0.p.shape[0], device=ctx.dev)
    step = make_data_parallel_step(magnetized.make_step, cfg, ctx.mesh,
                                   example_state=st)
    return cfg, st, step


def _mode_dp_capped_react(ctx):
    from ..engines import magnetized
    from ..parallel import make_data_parallel_step, shard_state

    cfg, st, step = _capped(ctx)
    _, m = step(shard_state(st, ctx.mesh))
    assert int(m.n_reactivated) <= 4 + int(m.n_hit_wall)
    fcfg = _dp_magnetized_cfg(ctx, reactivate="flux", flux_limit=3,
                              flux_gamma=0.5, flux_vx_pert=-3.0,
                              b=(0.0, 0.0, 0.0))
    fstep = make_data_parallel_step(magnetized.make_step, fcfg, ctx.mesh,
                                    example_state=st)
    _, fm = fstep(shard_state(st, ctx.mesh))
    assert int(fm.n_reactivated) <= 3


def _mode_dp_bca_iead(ctx):
    from .. import bca
    from ..engines import bca_driver
    from ..parallel import shard_state

    cfg, st, step = _capped(ctx)
    _, stats, hist = bca_driver.run_bca_from_iead(
        shard_state(st, ctx.mesh), cfg, 2, bca.BinaryCollisionModel(seed=1),
        bca.BinaryCollisionModel(incident_m_amu=10.81, incident_z=5, seed=2),
        seed=3, step_fn=step, mesh=ctx.mesh)
    assert len(hist) == 2
    assert stats.dropped >= 0


def _mode_dp_carried_deposit(ctx):
    """The carried magnetized deposit under data parallelism: the carried
    rho and n are global (summed over the ranks), the re-activation patch
    slices the shared table."""
    from ..engines import magnetized
    from ..parallel import make_data_parallel_step, shard_state

    cfg, st, _ = _capped(ctx)
    kcfg = dataclasses.replace(cfg, carried_deposit="on", carried_pad=8,
                               react_batch=128, source_sampler="hash",
                               ionization=False)
    kst = magnetized.prime_carry(st, kcfg)
    step = make_data_parallel_step(magnetized.make_step, kcfg, ctx.mesh,
                                   example_state=kst)
    kst2, m = step(shard_state(kst, ctx.mesh))
    assert int(m.carry_clamped) == 0
    assert np.isfinite(float(m.phi_max))
    # the carry is global: every rank holds the same bits
    both = ctx.mesh.all_gather(torch.cat([kst2.rho, kst2.n])[None])
    assert bool((both == both[:1]).all())


def _domain_magnetized(ctx, slabs, mesh, **kw):
    from ..parallel import domain_magnetized as dmag

    _, pre = ctx.pic_iead()
    c1 = pre.config
    cfg = dmag.DomainMagnetizedConfig(
        grid=c1.grid, dt=c1.dt, te=c1.te, b=c1.b, species_z=c1.species_z,
        num_shards=slabs, reactivate="source", source=c1.source,
        react_batch=128, iead_energy_max=c1.iead_energy_max, halo=2,
        migrate_cap=256, **kw)
    s0 = pre.state
    st = dmag.init_state(
        s0.p.cpu().numpy() * c1.grid.dx, s0.v.cpu().numpy(),
        s0.m.cpu().numpy(), s0.charge_state.cpu().numpy(),
        s0.p2c.cpu().numpy(), s0.species_idx.cpu().numpy(), cfg, mesh)
    _, m = dmag.make_step(cfg, mesh)(st)
    assert np.isfinite(float(m.phi_max))
    assert int(m.n_dropped) == 0


def _mode_domain_magnetized(ctx):
    _domain_magnetized(ctx, ctx.world, ctx.mesh)


def _mode_2d_slabs_x_dp_magnetized(ctx):
    m2 = _mesh2(ctx)
    if m2 is None:
        return "skipped (needs an even number of ranks)"
    _domain_magnetized(ctx, ctx.world // 2, m2, dp_axis_name="dp",
                       num_replicas=2)


def _mode_dp_sheath(ctx):
    from .. import initialize
    from ..engines import sheath
    from ..grid import GridSpec
    from ..constants import K_BOLTZMANN
    from ..parallel import make_data_parallel_step, shard_state

    ng = 17
    grid = GridSpec(ng, 1e-5 * (ng - 1), "dirichlet-dirichlet")
    n = max(2 * ctx.world, (ctx.n_particles // ctx.world) * ctx.world)
    d = initialize.initialize_sheath(n, 1e19, 1.0, 0.0, grid, 1.16e5, 1.16e5,
                                     seed=5)
    cfg = sheath.SheathConfig(grid, 1e-12, grid.length * 1e19 / n,
                              kbte=K_BOLTZMANN * 1.16e5,
                              kbti=K_BOLTZMANN * 1.16e5, rng_sampler="hash",
                              backend="composed", axis_name="particles")
    st = sheath.init_state(d["x"], d["v"], d["q"], d["m"], d["species"], cfg,
                           device=ctx.dev)
    step = make_data_parallel_step(sheath.make_step, cfg, ctx.mesh,
                                   example_state=st)
    _, m = step(shard_state(st, ctx.mesh))
    assert int(m.n_active) + int(m.n_lost_left) + int(m.n_lost_right) == n


def _mode_dp_explicit(ctx):
    from ..constants import E_CHARGE, M_ELECTRON
    from ..engines import explicit
    from ..parallel import make_data_parallel_step, shard_state

    grid, x, v, params, dt = ctx.problem()
    cfg = explicit.ExplicitConfig(grid, dt, params.p2c, axis_name="particles",
                                  backend="composed")
    st = explicit.init_state(x, v, -E_CHARGE, M_ELECTRON, cfg, device=ctx.dev)
    step = make_data_parallel_step(explicit.make_step, cfg, ctx.mesh,
                                   example_state=st)
    _, m = step(shard_state(st, ctx.mesh))
    assert np.isfinite(float(m.field_energy))


# JAX's modes, in its order (__graft_entry__.py _MODES)
MODES = (
    ("1-dp-implicit", _mode_dp_implicit),
    ("2-domain-explicit", _mode_domain_explicit),
    ("2b-explicit-superstep", _mode_explicit_superstep),
    ("2c-carried-rho", _mode_carried_rho),
    ("3-domain-implicit", _mode_domain_implicit),
    ("3b-implicit-superstep", _mode_implicit_superstep),
    ("4-domain-sheath", _mode_domain_sheath),
    ("5-2d-slabs-x-dp", _mode_2d_slabs_x_dp),
    ("6-dp-magnetized", _mode_dp_magnetized),
    ("7-dp-capped-react", _mode_dp_capped_react),
    ("8-dp-bca-iead", _mode_dp_bca_iead),
    ("9-domain-magnetized", _mode_domain_magnetized),
    ("10-dp-carried-deposit", _mode_dp_carried_deposit),
    ("11-dp-sheath", _mode_dp_sheath),
    ("12-dp-explicit", _mode_dp_explicit),
    ("13-2d-slabs-x-dp-magnetized", _mode_2d_slabs_x_dp_magnetized),
)


def rank_modes(mesh, particles_per_rank: int = 128):
    """Every mode on this rank (``parallel.spawn`` calls it on every
    rank), in order: a list of (mode, status, note) with status 'ok' or
    'failed'."""
    ctx = _Ctx(mesh, int(particles_per_rank) * mesh.world)
    out = []
    for name, fn in MODES:
        try:
            note = fn(ctx)
        except Exception as e:  # isolate: report and keep going
            out.append((name, "failed", repr(e)))
            continue
        out.append((name, "ok", note or "ok"))
    return out


def backend_for(ranks: int, device: torch.device) -> str:
    """NCCL with a card a rank when there are enough cards, else gloo."""
    return ("nccl" if device.type == "cuda"
            and torch.cuda.device_count() >= ranks > 1 else "gloo")


def dryrun(ranks: int, particles_per_rank: int = 128, device=None) -> list:
    """Run every mode over ``ranks`` ranks (``backend_for``); returns rank
    0's (mode, status, note) list after checking that every rank reports
    the same statuses."""
    from .. import devices
    from ..parallel import spawn

    device = devices.resolve(device)
    got = spawn.run(ranks, rank_modes, particles_per_rank, device=device,
                    backend=backend_for(ranks, device))
    first = [(name, status) for name, status, _ in got[0]]
    for r, rows in enumerate(got[1:], 1):
        if [(name, status) for name, status, _ in rows] != first:
            raise RuntimeError(f"rank {r}'s statuses differ from rank 0's")
    return got[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--particles-per-rank", type=int, default=128)
    ap.add_argument("--device", default=None,
                    help="the ranks' device (default: the card; 'cpu' runs "
                         "the kernels' plain versions)")
    args = ap.parse_args(argv)
    from .. import devices

    dev = devices.resolve(args.device)
    rows = dryrun(args.ranks, args.particles_per_rank, dev)
    failed = 0
    for name, status, note in rows:
        line = f"FAILED {note}" if status == "failed" else note
        print(f"dryrun[{name}]: {line}", flush=True)
        failed += status == "failed"
    print(f"dryrun: {len(rows) - failed} of {len(rows)} modes ok, "
          f"{failed} failed ({args.ranks} ranks, "
          f"{backend_for(args.ranks, dev)} on {dev.type})", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
