"""Rank functions of the port's multi-rank tests (no JAX here: each runs in
a process that ``pypic_tpu_torch.parallel.spawn`` starts). The tests
compute the JAX references in their own process and hand the inputs over
as numpy arrays; each function returns numpy arrays and Python numbers.

``batch(mesh, jobs)`` runs several jobs in one spawn: jobs is a list of
(name, kwargs) with name one of this module's functions.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from pypic_tpu_torch import checkpoint, interop
from pypic_tpu_torch.engines import explicit, implicit, magnetized, sheath
from pypic_tpu_torch.grid import GridSpec
from pypic_tpu_torch.parallel import (dataparallel, distributed_poisson,
                                      domain, domain_implicit,
                                      domain_magnetized, domain_sheath,
                                      mesh as tmesh)


def batch(mesh, jobs):
    mod = sys.modules[__name__]
    return [getattr(mod, name)(mesh, **kw) for name, kw in jobs]


def halo(mesh, own, ext, hw, periodic=True):
    """halo_extend of this rank's row of ``own`` (S, c) and halo_fold of
    its row of ``ext`` (S, c + 2 hw + 1), on the ring or the chain."""
    r = mesh.rank
    c = own.shape[1]
    got_ext = domain.halo_extend(torch.from_numpy(own[r].copy()), hw, mesh,
                                 periodic=periodic)
    got_fold = domain.halo_fold(torch.from_numpy(ext[r].copy()), c, hw, mesh,
                                periodic=periodic)
    return got_ext.numpy(), got_fold.numpy()


def migrate(mesh, p, tags, alive, ng, cap, periodic=True):
    """domain.migrate of this rank's rows of (S, n) positions, tags and
    alive mask, on the ring or the chain."""
    r = mesh.rank
    t = lambda a: torch.from_numpy(a[r].copy())  # noqa: E731
    (p2, t2), a2, n_mig, n_drop = domain.migrate(
        [t(p), t(tags)], t(alive), r, ng=ng,
        cells_per_shard=ng // mesh.world, num_shards=mesh.world, cap=cap,
        mesh=mesh, periodic=periodic)
    return p2.numpy(), t2.numpy(), a2.numpy(), int(n_mig), int(n_drop)


def _metric_rows(rows, m):
    for k, val in m._asdict().items():
        rows.setdefault(k, []).append(val.item() if val.dim() == 0 else
                                      val.reshape(()).item())


def steps(mesh, engine, state, grid, cfg, n_steps, keep=(1,)):
    """``n_steps`` steps of ``engine`` ('implicit' or 'explicit') from the
    JAX state ``state`` (a dict of numpy arrays) on this rank: the metric
    rows and this rank's state after each step in ``keep``."""
    mod = domain_implicit if engine == "implicit" else domain
    cls = (mod.DomainImplicitConfig if engine == "implicit"
           else mod.DomainConfig)
    cfg = cls(GridSpec(*grid), **cfg)
    cut, join = ((interop.domain_implicit_states_from_numpy,
                  interop.domain_implicit_states_to_numpy)
                 if engine == "implicit" else
                 (interop.domain_states_from_numpy,
                  interop.domain_states_to_numpy))
    st = cut(state, mesh.world, mesh.device)[mesh.rank]
    step = mod.make_step(cfg, mesh)
    rows, kept = {}, {}
    for i in range(1, n_steps + 1):
        st, m = step(st)
        _metric_rows(rows, m)
        if i in keep:
            kept[i] = join([st])
    return rows, kept


def prime(mesh, state, grid, cfg):
    """domain.prime_rho on this rank from the JAX explicit state ``state``
    with its rho zeroed: this rank's slab of the primed rho."""
    cfg = domain.DomainConfig(GridSpec(*grid), **cfg)
    st = interop.domain_states_from_numpy(state, mesh.world,
                                          mesh.device)[mesh.rank]
    st = domain.prime_rho(st.replace(rho=torch.zeros_like(st.rho)), cfg, mesh)
    return st.rho.cpu().numpy()


def _own(mesh, a):
    c = a.shape[0] // mesh.world
    return torch.from_numpy(a[mesh.rank * c:(mesh.rank + 1) * c].copy())


def periodic_poisson(mesh, rho, dx):
    """make_distributed_periodic_poisson on this rank's slab of the (ng,)
    ``rho``: this rank's slab of phi."""
    solve = distributed_poisson.make_distributed_periodic_poisson(
        rho.shape[0], dx, mesh.world, mesh)
    return solve(_own(mesh, rho)).numpy()


def tridiag_chain(mesh, dl, d, du, f):
    """make_distributed_tridiag_chain on this rank's slabs of the global
    (ng,) diagonals and right-hand side: this rank's slab of x."""
    solve = distributed_poisson.make_distributed_tridiag_chain(
        d.shape[0] // mesh.world, mesh.world, mesh)
    return solve(*(_own(mesh, a) for a in (dl, d, du, f))).numpy()


def cli(mesh, argv):
    """``pypic_tpu_torch.cli.main(argv)`` on this rank (the process group
    is the spawn's); returns the paths this rank opened for writing or
    renamed into place (the checkpoints' atomic writes)."""
    import builtins
    import io
    import os

    from pypic_tpu_torch import cli as tcli

    written = []
    real_open, real_replace = builtins.open, os.replace

    def recording_open(file, mode="r", *args, **kw):
        if any(ch in mode for ch in "wax+") and not isinstance(file, int):
            written.append(str(file))  # (a descriptor: a file named before)
        return real_open(file, mode, *args, **kw)

    def recording_replace(src, dst, **kw):
        written.append(str(dst))
        return real_replace(src, dst, **kw)

    builtins.open = io.open = recording_open
    os.replace = recording_replace
    try:
        tcli.main(argv)
    finally:
        builtins.open = io.open = real_open
        os.replace = real_replace
    return written


# engine: (module, state from JAX numpy, state to numpy)
_DP_ENGINES = {
    "implicit": (implicit, interop.implicit_state_from_numpy,
                 interop.implicit_state_to_numpy),
    "explicit": (explicit, interop.explicit_state_from_numpy,
                 interop.explicit_state_to_numpy),
    "sheath": (sheath, interop.sheath_state_from_numpy,
               interop.sheath_state_to_numpy),
    "magnetized": (magnetized, interop.magnetized_state_from_numpy,
                   interop.magnetized_state_to_numpy),
}


def _scalar_rows(rows, m):
    """Append a step's scalar metrics (Python numbers) to ``rows``."""
    for k, val in m._asdict().items():
        if isinstance(val, torch.Tensor) and val.numel() == 1:
            rows.setdefault(k, []).append(val.reshape(()).item())


def _dp_step(mesh, engine, whole, cfg, seeds, draws=None):
    mod = _DP_ENGINES[engine][0]
    kw = {} if seeds is None else {"hash_seeds": seeds.__getitem__}
    if draws is not None:
        # a replicated table a step (react_batch): every rank takes it whole
        def source_draws(step, n):
            return {k: torch.from_numpy(np.array(v)).to(mesh.device)
                    for k, v in draws[step].items()}
        kw["source_draws"] = source_draws
    return dataparallel.make_data_parallel_step(
        mod.make_step, cfg, mesh, example_state=whole, **kw)


def dp_run(mesh, engine, state, cfg, n_steps, seeds=None, final=False,
           draws=None):
    """``n_steps`` data-parallel steps of ``engine`` from the whole JAX
    state ``state`` (numpy), this rank's block (``shard_state``): the
    scalar metric rows, and with ``final`` the whole final state (numpy,
    ``gather_state``). ``seeds``: {step: hash seeds} (the JAX engine's);
    ``draws``: {step: the react_batch table} (the JAX engine's)."""
    _, cut, join = _DP_ENGINES[engine]
    whole = cut(state, mesh.device)
    st = dataparallel.shard_state(whole, mesh)
    step = _dp_step(mesh, engine, whole, cfg, seeds, draws)
    rows = {}
    for _ in range(n_steps):
        st, m = step(st)
        _scalar_rows(rows, m)
    if not final:
        return rows, None
    return rows, join(dataparallel.gather_state(st, mesh))


def dp_resume(mesh, state, template, cfg, path, seeds, k):
    """The magnetized data-parallel checkpoint round trip: k steps, a save
    (rank 0 writes the whole state), k more steps; then a load into the
    blocks of ``template`` and the same k steps. Returns both final whole
    states (numpy)."""
    _, cut, join = _DP_ENGINES["magnetized"]
    whole = cut(state, mesh.device)
    step = _dp_step(mesh, "magnetized", whole, cfg, seeds)
    st = dataparallel.shard_state(whole, mesh)
    for _ in range(k):
        st, _m = step(st)
    checkpoint.save(path, st, step=k, mesh=mesh)
    a = st
    for _ in range(k):
        a, _m = step(a)
    tmpl = dataparallel.shard_state(cut(template, mesh.device), mesh)
    b, manifest = checkpoint.load(path, tmpl, mesh=mesh)
    for _ in range(k):
        b, _m = step(b)
    return (join(dataparallel.gather_state(a, mesh)),
            join(dataparallel.gather_state(b, mesh)), manifest["step"])


def dp_bca(mesh, state, cfg, steps, seeds, per_bca):
    """``engines.bca_driver.run_bca_from_iead`` with the data-parallel
    step (two BinaryCollisionModel channels, seeds 1 and 2): the stats
    and the final population's row count."""
    from pypic_tpu_torch import bca
    from pypic_tpu_torch.engines import bca_driver

    _, cut, _ = _DP_ENGINES["magnetized"]
    whole = cut(state, mesh.device)
    step = _dp_step(mesh, "magnetized", whole, cfg, seeds)
    fin, stats, _ = bca_driver.run_bca_from_iead(
        dataparallel.shard_state(whole, mesh), cfg, steps,
        bca.BinaryCollisionModel(seed=1),
        bca.BinaryCollisionModel(incident_m_amu=10.81, incident_z=5, seed=2),
        seed=3, pic_steps_per_bca=per_bca, step_fn=step, mesh=mesh)
    return (stats.source_incident, stats.injected, stats.dropped,
            int(fin.p.shape[0]) * mesh.world)


def replicas(mesh, state, grid, cfg, n_steps, num_replicas):
    """``n_steps`` of ``domain_implicit`` on a slabs x replicas mesh
    (``make_mesh2``) from the JAX state ``state`` (numpy, JAX's (S, R,
    cap_r) layout): the metric rows."""
    m2 = tmesh.make_mesh2(mesh.world // num_replicas, num_replicas,
                          device=mesh.device)
    cfg = domain_implicit.DomainImplicitConfig(GridSpec(*grid), **cfg)
    st = interop.domain_implicit_states_from_numpy(
        state, cfg.num_shards, mesh.device, num_replicas)[mesh.rank]
    step = domain_implicit.make_step(cfg, m2)
    rows = {}
    for _ in range(n_steps):
        st, m = step(st)
        _scalar_rows(rows, m)
    return rows


def dp_blocks(mesh, state):
    """shard_state of the whole sheath state ``state`` (numpy) on this
    rank: its block of p, its e, and gather_state's whole p."""
    whole = interop.sheath_state_from_numpy(state, mesh.device)
    st = dataparallel.shard_state(whole, mesh)
    return (st.p.numpy(), st.e.numpy(),
            dataparallel.gather_state(st, mesh).p.numpy())


def _t(a, mesh):
    return torch.from_numpy(np.array(a, copy=True)).to(mesh.device)


def _rows_phi(rows, phis, m):
    _scalar_rows(rows, m)
    phis.append(m.phi.cpu().numpy())


def _sheath_cfg(grid, cfg):
    return domain_sheath.DomainSheathConfig(GridSpec(*grid), **cfg)


def _magnetized_cfg(grid, cfg):
    cfg = dict(cfg)
    if cfg.get("source") is not None:
        cfg["source"] = magnetized.SourceSpec(**cfg["source"])
    return domain_magnetized.DomainMagnetizedConfig(GridSpec(*grid), **cfg)


def sheath_slab_steps(mesh, state, grid, cfg, n_steps, draws):
    """``n_steps`` of ``domain_sheath`` from the JAX state ``state``
    (numpy, JAX's global layout) on this rank, with JAX's draws:
    ``draws[step][rank]`` {x, z (3, cap), u_therm, z_therm}. Returns the
    scalar metric rows, each step's phi, this rank's state (numpy) after
    the first step and at the end."""
    cfg = _sheath_cfg(grid, cfg)
    st = interop.domain_sheath_states_from_numpy(state, mesh.world,
                                                 mesh.device)[mesh.rank]

    def reinject(step, n):
        d = draws[step][mesh.rank]
        out = {"x": _t(d["x"], mesh),
               "z": tuple(_t(z, mesh) for z in d["z"])}
        if "u_therm" in d:
            out.update(u_therm=_t(d["u_therm"], mesh),
                       z_therm=tuple(_t(z, mesh) for z in d["z_therm"]))
        return out

    step = domain_sheath.make_step(cfg, mesh, reinject_draws=reinject)
    rows, phis, first = {}, [], None
    for i in range(n_steps):
        st, m = step(st)
        _rows_phi(rows, phis, m)
        if i == 0:
            first = interop.domain_sheath_states_to_numpy([st])
    return rows, phis, first, interop.domain_sheath_states_to_numpy([st])


def magnetized_slab_steps(mesh, state, grid, cfg, n_steps, tables, ions,
                          replicas=1):
    """``n_steps`` of ``domain_magnetized`` from the JAX state ``state``
    (numpy) on this rank of a slabs x ``replicas`` mesh, with JAX's draws:
    ``tables[step]`` the replicated re-activation table, ``ions[step]
    [rank]`` the rank's ionization uniforms (or None). Returns the metric
    rows, each step's phi, this rank's state after the first step and at
    the end (numpy)."""
    cfg = _magnetized_cfg(grid, cfg)
    m = (tmesh.make_mesh2(mesh.world // replicas, replicas,
                          device=mesh.device) if replicas > 1 else mesh)
    st = interop.domain_magnetized_states_from_numpy(
        state, cfg.num_shards, mesh.device, replicas)[mesh.rank]
    hooks = {}
    if tables is not None:
        hooks["source_draws"] = lambda step, n: {
            k: _t(v, mesh) for k, v in tables[step].items()}
    if ions is not None:
        hooks["ion_draws"] = lambda step, n: _t(ions[step][mesh.rank], mesh)
    step = domain_magnetized.make_step(cfg, m, **hooks)
    rows, phis, first = {}, [], None
    for i in range(n_steps):
        st, met = step(st)
        _rows_phi(rows, phis, met)
        if i == 0:
            first = interop.domain_magnetized_states_to_numpy([st])
    return rows, phis, first, interop.domain_magnetized_states_to_numpy([st])


def slab_resume(mesh, engine, state, grid, cfg, path, k):
    """The checkpoint round trip of a bounded slab engine on this rank
    (its own Philox draws): k steps, a save (rank 0 writes JAX's global
    layout), k more; then a load into the initial state and the same k
    steps. Returns both final states (numpy, this rank's) and the
    manifest's step."""
    if engine == "sheath":
        cfg = _sheath_cfg(grid, cfg)
        st = interop.domain_sheath_states_from_numpy(
            state, mesh.world, mesh.device)[mesh.rank]
        step = domain_sheath.make_step(cfg, mesh)
        join = interop.domain_sheath_states_to_numpy
    else:
        cfg = _magnetized_cfg(grid, cfg)
        st = interop.domain_magnetized_states_from_numpy(
            state, mesh.world, mesh.device)[mesh.rank]
        step = domain_magnetized.make_step(cfg, mesh)
        join = interop.domain_magnetized_states_to_numpy
    template = st
    for _ in range(k):
        st, _m = step(st)
    checkpoint.save(path, st, step=k, mesh=mesh)
    a = st
    for _ in range(k):
        a, _m = step(a)
    b, manifest = checkpoint.load(path, template, mesh=mesh)
    for _ in range(k):
        b, _m = step(b)
    return join([a]), join([b]), manifest["step"]


def _domain_engine(engine):
    """(module, config class, state cut, state join) of a domain engine."""
    if engine == "implicit":
        return (domain_implicit, domain_implicit.DomainImplicitConfig,
                interop.domain_implicit_states_from_numpy,
                interop.domain_implicit_states_to_numpy)
    return (domain, domain.DomainConfig, interop.domain_states_from_numpy,
            interop.domain_states_to_numpy)


def supersteps(mesh, engine, state, grid, cfg, k, n_calls, replicas=1):
    """``n_calls`` calls of ``make_superstep(cfg, mesh, k)`` of ``engine``
    from the JAX state ``state`` (numpy) on this rank (with ``replicas``
    > 1 on the slabs x replicas mesh): the metric rows, one a micro-step,
    each call's metric shapes, and this rank's state after the first
    call (numpy)."""
    mod, cls, cut, join = _domain_engine(engine)
    cfg = cls(GridSpec(*grid), **cfg)
    m = mesh
    if replicas > 1:
        m = tmesh.make_mesh2(mesh.world // replicas, replicas,
                             device=mesh.device)
        st = cut(state, cfg.num_shards, mesh.device, replicas)[mesh.rank]
    else:
        st = cut(state, mesh.world, mesh.device)[mesh.rank]
    step = mod.make_superstep(cfg, m, k)
    rows, shapes, first = {}, [], None
    for i in range(n_calls):
        st, met = step(st)
        shapes.append({f: tuple(v.shape) for f, v in met._asdict().items()})
        for f, v in met._asdict().items():
            rows.setdefault(f, []).extend(v.reshape(-1).tolist())
        if i == 0:
            first = join([st]) if replicas == 1 else None
    return rows, shapes, first, int(st.step)


def k1_pair(mesh, engine, state, grid, cfg, n_steps):
    """``n_steps`` of ``make_step`` and of ``make_superstep(k=1)`` from the
    same JAX state on this rank: (rows, state) of each, numpy."""
    mod, cls, cut, join = _domain_engine(engine)
    cfg = cls(GridSpec(*grid), **cfg)
    out = []
    for step in (mod.make_step(cfg, mesh), mod.make_superstep(cfg, mesh, 1)):
        st = cut(state, mesh.world, mesh.device)[mesh.rank]
        rows = {}
        for _ in range(n_steps):
            st, met = step(st)
            for f, v in met._asdict().items():
                rows.setdefault(f, []).extend(v.reshape(-1).tolist())
        out.append((rows, join([st])))
    return out


def dp_carried(mesh, state, cfg, n_steps, draws):
    """``n_steps`` data-parallel steps of the carried magnetized engine
    from the whole JAX state ``state`` (numpy; its carry primed), with
    JAX's react_batch tables ``draws`` replayed: the scalar metric rows
    and this rank's carried rho and n after the run."""
    whole = interop.magnetized_state_from_numpy(state, mesh.device)
    if cfg.axis_name is None:  # the one-device engine
        st = whole
        step = magnetized.make_step(cfg, source_draws=lambda s, n: {
            k: torch.from_numpy(np.array(v)) for k, v in draws[s].items()})
    else:
        st = dataparallel.shard_state(whole, mesh)
        step = _dp_step(mesh, "magnetized", whole, cfg, None, draws)
    rows = {}
    for _ in range(n_steps):
        st, m = step(st)
        _scalar_rows(rows, m)
    return rows, np.stack([st.rho.cpu().numpy(), st.n.cpu().numpy()])


def slab_preset_rows(mesh, n_per_species, ng, n_steps):
    """``n_steps`` of ``presets.pic_iead_dd`` on this rank (its own Philox
    draws, one slab a rank). Returns the scalar metric rows and the
    config's cells_per_shard."""
    from pypic_tpu_torch import presets

    pre = presets.pic_iead_dd(n_per_species=n_per_species, ng=ng, mesh=mesh,
                              device=mesh.device)
    step, st, rows = pre.make_step(), pre.state, {}
    for _ in range(n_steps):
        st, m = step(st)
        _scalar_rows(rows, m)
    rows["cells_per_shard"] = pre.config.cells_per_shard
    return rows
