"""The port's substructured solves (``pypic_tpu_torch.parallel.
distributed_poisson``) against ``pypic_tpu``'s under ``shard_map``, on 4
gloo ranks against 4 of conftest's CPU devices, and
``field_solve='distributed'`` in the explicit carrier against the
replicated solve over the same 4 ranks (tests/test_domain.py:617-668,
827-855, at their limits or tighter). One spawn carries every job. The
chain solve (its local system the ``tridiag3_chain`` kernel's plain
version on the CPU) also at 1 and 2 ranks, against JAX's chain at as
many devices within 1e-5 of the largest |x|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from pypic_tpu.constants import E_CHARGE, EPSILON_0, K_BOLTZMANN, M_ELECTRON
from pypic_tpu.grid import GridSpec
from pypic_tpu import initialize as init
from pypic_tpu.ops import solve_periodic_neutralized
from pypic_tpu.parallel import domain, make_mesh
from pypic_tpu.parallel.distributed_poisson import (
    make_distributed_periodic_poisson, make_distributed_tridiag_chain)

from pypic_tpu_torch.parallel import distributed_poisson as tdp, spawn
from pypic_tpu_torch.parallel.mesh import SlabMesh
import _torch_ranks

S, DX, STEPS = 4, 0.37, 100
NGS = (256, 640)


def _rho(ng):
    return np.random.default_rng(5).normal(0.0, 1e-8, ng).astype(np.float32)


def _chain_systems(ng):
    """tests/test_domain.py:842-850's two systems: Boltzmann-Jacobian-like
    and generic diagonally dominant."""
    rng = np.random.default_rng(5)
    dl = np.ones(ng, np.float32)
    du = np.ones(ng, np.float32)
    dl[-1] = 0.0
    du[0] = 0.0
    out = {}
    for kind in ("boltzmann", "generic"):
        if kind == "boltzmann":
            d = (-2.0 - np.exp(rng.normal(0, 1.5, ng)) * 20).astype(np.float32)
            d[0] = d[-1] = 1.0
        else:
            d = (rng.normal(0, 1, ng) + 4.0).astype(np.float32)
        out[kind] = (dl, d, du, rng.normal(0, 1, ng).astype(np.float32))
    return out


def _jax_poisson(rho):
    solve = make_distributed_periodic_poisson(rho.shape[0], DX, S, "slabs")
    return np.asarray(jax.shard_map(
        solve, mesh=make_mesh(S, axis="slabs"), in_specs=(P("slabs"),),
        out_specs=P("slabs"), check_vma=False)(jnp.asarray(rho)))


@pytest.fixture(scope="module")
def jax_chains():
    """JAX's chain under shard_map on both systems of each ng (one
    compile an ng)."""
    out = {}
    for ng in NGS:
        fn = jax.jit(jax.shard_map(
            make_distributed_tridiag_chain(ng // S, S, "slabs"),
            mesh=make_mesh(S, axis="slabs"), in_specs=(P("slabs"),) * 4,
            out_specs=P("slabs"), check_vma=False))
        for kind, system in _chain_systems(ng).items():
            out[ng, kind] = np.asarray(fn(*(jnp.asarray(a) for a in system)))
    return out


def _thomas64(dl, d, du, f):
    """The sequential Thomas solve in float64 numpy."""
    n = d.shape[0]
    dl, d, du, f = (np.asarray(a, np.float64) for a in (dl, d, du, f))
    cp, dp = np.zeros(n), np.zeros(n)
    for i in range(n):
        a = dl[i] if i else 0.0
        den = d[i] - a * (cp[i - 1] if i else 0.0)
        cp[i] = du[i] / den
        dp[i] = (f[i] - a * (dp[i - 1] if i else 0.0)) / den
    x = np.zeros(n)
    x[-1] = dp[-1]
    for i in range(n - 2, -1, -1):
        x[i] = dp[i] - cp[i] * x[i + 1]
    return x


@pytest.fixture(scope="module")
def explicit_problem():
    """tests/test_domain.py:16-25's two-stream problem, JAX's initial
    state on S shards (the port's ranks start from it)."""
    density, te = 1e10, 0.1 * 11600.0
    debye = np.sqrt(K_BOLTZMANN * te * EPSILON_0 / E_CHARGE**2 / density)
    grid = GridSpec(64, 15.0 * debye, "periodic")
    x, v, params = init.initialize_periodic(
        "two-stream", 16_000, density, 1, 0.05, grid, te, te, seed=2)
    dt = 0.1 / params.wp
    cfg = domain.DomainConfig(grid, dt, params.p2c, num_shards=S,
                              migrate_cap=2048)
    st = domain.init_state(x, v, -E_CHARGE, M_ELECTRON, cfg)
    state0 = {k: np.asarray(getattr(st, k))
              for k in ("p", "v", "alive", "q", "m", "step", "rho")}
    return grid, state0, dict(dt=dt, p2c=params.p2c, num_shards=S,
                              migrate_cap=2048)


@pytest.fixture(scope="module")
def ranks(explicit_problem, tmp_path_factory):
    grid, state0, cfg = explicit_problem
    jobs = [("periodic_poisson", dict(rho=_rho(ng), dx=DX)) for ng in NGS]
    for ng in NGS:
        for dl, d, du, f in _chain_systems(ng).values():
            jobs.append(("tridiag_chain", dict(dl=dl, d=d, du=du, f=f)))
    for fs in ("replicated", "distributed"):
        jobs.append(("steps", dict(
            engine="explicit", state=state0,
            grid=(grid.ng, grid.length, grid.bc),
            cfg=dict(cfg, field_solve=fs, push_backend="composed"),
            n_steps=STEPS)))
    got = spawn.run(S, _torch_ranks.batch, jobs, device="cpu",
                    tmp_dir=tmp_path_factory.mktemp("ranks"))
    per_job = list(zip(*got))  # [job][rank]
    poisson = {ng: np.concatenate(per_job[i]) for i, ng in enumerate(NGS)}
    k = len(NGS)
    chain = {}
    for ng in NGS:
        for kind in ("boltzmann", "generic"):
            chain[ng, kind] = np.concatenate(per_job[k])
            k += 1
    runs = {}
    for fs in ("replicated", "distributed"):
        rows = per_job[k][0][0]
        for rank in per_job[k][1:]:  # every rank reports the summed metrics
            assert rank[0] == rows, fs
        runs[fs] = rows
        k += 1
    return poisson, chain, runs


@pytest.mark.parametrize("ng", NGS)
def test_periodic_poisson_matches_jax_and_the_fft_solve(ranks, ng):
    """4 ranks against JAX's under shard_map at tests/test_domain.py:641's
    atol 2e-5 max|phi| (measured 6e-6: JAX's float32 Thomas rounds, the
    port's float64 prefix sums do not), and against the float64 FFT
    solve's zero-mean phi at 1e-6 max|phi| (measured 5e-8)."""
    got = ranks[0][ng]
    ref = _jax_poisson(_rho(ng))
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5 * scale)
    exact = np.asarray(solve_periodic_neutralized(
        jnp.asarray(_rho(ng), jnp.float64), DX))
    exact = exact - exact.mean()
    np.testing.assert_allclose(got, exact, rtol=0,
                               atol=1e-6 * np.abs(exact).max())


@pytest.mark.parametrize("kind", ["boltzmann", "generic"])
@pytest.mark.parametrize("ng", NGS)
def test_tridiag_chain_matches_jax(ranks, jax_chains, ng, kind):
    """4 ranks against JAX's chain under shard_map and the sequential
    Thomas solve (float64), within 1e-4 of the largest value
    (tests/test_domain.py:855)."""
    got = ranks[1][ng, kind]
    for ref in (jax_chains[ng, kind], _thomas64(*_chain_systems(ng)[kind])):
        assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-4


def test_domain_explicit_distributed_solve_matches_replicated(ranks):
    """tests/test_domain.py:647-668 in the port's terms, over 4 ranks and
    100 steps: the distributed run's field energy within rtol 2e-3 of the
    replicated run's, kinetic energy within 1e-4, nothing dropped."""
    runs = ranks[2]
    ee_r = np.asarray(runs["replicated"]["field_energy"], np.float64)
    ee_d = np.asarray(runs["distributed"]["field_energy"], np.float64)
    np.testing.assert_allclose(ee_d, ee_r, rtol=2e-3)
    np.testing.assert_allclose(runs["distributed"]["kinetic_energy"],
                               runs["replicated"]["kinetic_energy"], rtol=1e-4)
    assert (np.asarray(runs["distributed"]["n_alive"]) == 16_000).all()
    assert np.asarray(runs["distributed"]["n_dropped"]).sum() == 0
    assert len(ee_d) == STEPS


def test_one_rank_solve_needs_no_collective_and_checks_its_mesh():
    """At one rank the periodic solve is the FFT solve's zero-mean phi;
    a mesh whose world is not num_shards is refused."""
    rho = _rho(200)
    mesh = SlabMesh(0, 1, torch.device("cpu"))
    got = tdp.make_distributed_periodic_poisson(200, DX, 1, mesh)(
        torch.from_numpy(rho)).numpy()
    exact = np.asarray(solve_periodic_neutralized(
        jnp.asarray(rho, jnp.float64), DX))
    exact = exact - exact.mean()
    np.testing.assert_allclose(got, exact, rtol=0,
                               atol=1e-6 * np.abs(exact).max())
    with pytest.raises(ValueError, match="ranks"):
        tdp.make_distributed_periodic_poisson(200, DX, 2, mesh)
    with pytest.raises(ValueError, match="divisible"):
        tdp.make_distributed_periodic_poisson(201, DX, 2, mesh)


@pytest.fixture(scope="module")
def chains_by_world(ranks, jax_chains, tmp_path_factory):
    """{S: (the port's x, JAX's x) by (ng, kind)} at S = 1, 2 and 4 (the
    4-rank solves are the ``ranks`` spawn's)."""
    out = {4: {key: (ranks[1][key], jax_chains[key]) for key in jax_chains}}
    for s in (1, 2):
        jobs, keys = [], []
        for ng in NGS:
            fn = jax.jit(jax.shard_map(
                make_distributed_tridiag_chain(ng // s, s, "slabs"),
                mesh=make_mesh(s, axis="slabs"), in_specs=(P("slabs"),) * 4,
                out_specs=P("slabs"), check_vma=False))
            for kind, (dl, d, du, f) in _chain_systems(ng).items():
                jobs.append(("tridiag_chain", dict(dl=dl, d=d, du=du, f=f)))
                keys.append(((ng, kind), np.asarray(fn(*(
                    jnp.asarray(a) for a in (dl, d, du, f))))))
        got = spawn.run(s, _torch_ranks.batch, jobs, device="cpu",
                        tmp_dir=tmp_path_factory.mktemp(f"chain{s}"))
        out[s] = {key: (np.concatenate([rank[i] for rank in got]), ref)
                  for i, (key, ref) in enumerate(keys)}
    return out


@pytest.mark.parametrize("world", [1, 2, 4])
def test_tridiag_chain_matches_jax_at_every_world(chains_by_world, world):
    """The chain solve (one tridiag3_chain plain solve a rank, the six
    scalars gathered, the interface by ``solve_ex``) against JAX's
    ``make_distributed_tridiag_chain`` at the same number of devices,
    within 1e-5 of the largest |x|, on both systems and both grids; at one
    rank the local solve alone."""
    for (ng, kind), (got, ref) in chains_by_world[world].items():
        err = np.abs(got - ref).max() / np.abs(ref).max()
        assert err <= 1e-5, (ng, kind, err)


def test_tridiag3_chain_plain_solves_its_three_columns():
    """The kernel's plain version: xp, u and w solve the local system
    with the slab couplings left out (against float64 numpy), and the six
    interface scalars are [xp0, xp_last, a0 u0, a0 u_last, cc w0,
    cc w_last], zero at the chain's ends."""
    from pypic_tpu_torch.ops import cuda_newton

    rng = np.random.default_rng(3)
    c = 77
    dl, du, f = (rng.normal(0, 1, c).astype(np.float32) for _ in range(3))
    d = (4.0 + rng.normal(0, 1, c)).astype(np.float32)
    t = [torch.from_numpy(a) for a in (dl, d, du, f)]
    a = (np.diag(d.astype(np.float64)) + np.diag(dl[1:].astype(np.float64), -1)
         + np.diag(du[:-1].astype(np.float64), 1))
    rhs = np.zeros((c, 3))
    rhs[:, 0], rhs[0, 1], rhs[-1, 2] = f, 1.0, 1.0
    ref = np.linalg.solve(a, rhs).T
    for first, last in ((True, True), (False, False), (True, False)):
        x, g6 = cuda_newton.tridiag3_chain(*t, first=first, last=last)
        assert np.abs(x.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
        a0 = 0.0 if first else dl[0]
        cc = 0.0 if last else du[-1]
        x = x.numpy()
        want = [x[0, 0], x[0, -1], a0 * x[1, 0], a0 * x[1, -1], cc * x[2, 0],
                cc * x[2, -1]]
        np.testing.assert_allclose(g6.numpy(), want, rtol=1e-6, atol=0)
    with pytest.raises(ValueError, match="c >= 2"):
        cuda_newton.tridiag3_chain(*(a[:1] for a in t), first=True, last=True)
