"""Rank functions of the port's multi-rank tests (no JAX here: each runs in
a process that ``pypic_tpu_torch.parallel.spawn`` starts). The tests
compute the JAX references in their own process and hand the inputs over
as numpy arrays; each function returns numpy arrays and Python numbers.

``batch(mesh, jobs)`` runs several jobs in one spawn: jobs is a list of
(name, kwargs) with name one of this module's functions.
"""

from __future__ import annotations

import sys

import torch

from pypic_tpu_torch import interop
from pypic_tpu_torch.grid import GridSpec
from pypic_tpu_torch.parallel import domain, domain_implicit


def batch(mesh, jobs):
    mod = sys.modules[__name__]
    return [getattr(mod, name)(mesh, **kw) for name, kw in jobs]


def halo(mesh, own, ext, hw):
    """halo_extend of this rank's row of ``own`` (S, c) and halo_fold of
    its row of ``ext`` (S, c + 2 hw + 1)."""
    r = mesh.rank
    c = own.shape[1]
    got_ext = domain.halo_extend(torch.from_numpy(own[r].copy()), hw, mesh)
    got_fold = domain.halo_fold(torch.from_numpy(ext[r].copy()), c, hw, mesh)
    return got_ext.numpy(), got_fold.numpy()


def migrate(mesh, p, tags, alive, ng, cap):
    """domain.migrate of this rank's rows of (S, n) positions, tags and
    alive mask."""
    r = mesh.rank
    t = lambda a: torch.from_numpy(a[r].copy())  # noqa: E731
    (p2, t2), a2, n_mig, n_drop = domain.migrate(
        [t(p), t(tags)], t(alive), r, ng=ng,
        cells_per_shard=ng // mesh.world, num_shards=mesh.world, cap=cap,
        mesh=mesh)
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
