"""The migration-amortized supersteps of the port's domain engines
(``parallel.domain.make_superstep``, ``parallel.domain_implicit.
make_superstep``) against ``pypic_tpu``'s, on tests/test_domain.py's
two-stream problem (n = 16,000, ng = 64) handed over through ``interop``:
JAX on 2 (or 2 x 2) of conftest's CPU devices, the port on as many gloo
ranks (``tests/_torch_ranks.py`` under ``parallel.spawn``, one spawn a
world size).

* superstep(k=1) is ``make_step``: bit for bit on one rank and on two,
  every finalize mode and backend, finalize_field 'aitken', both solves
  of the explicit carrier (JAX's tests/test_domain.py:74, :983, :1130);
* k = 2 and 3 against JAX's superstep: field energy rtol 1e-4, kinetic
  rtol 1e-5 (tests/test_domain.py:968-975), the Picard, migrated,
  dropped, halo-clamped and alive counts equal micro-step by micro-step,
  metrics of shape (k,) with the migration counts in the last slot, and
  the positions after the first call within 1e-4 cells of JAX's slot for
  slot (float32 summation order over k micro-steps);
* an undersized halo is counted in ``n_halo_clamped`` (test_domain.py:227,
  :1023), the counts within 1% of JAX's (rows at the clamp edge round
  either way);
* 2 slabs x 2 replicas (test_domain.py:1044):
  tests/test_torch_superstep_replicas.py;
* ``migrate_every < 1`` is refused with JAX's message.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from pypic_tpu import initialize as init
from pypic_tpu.constants import E_CHARGE, EPSILON_0, K_BOLTZMANN, M_ELECTRON
from pypic_tpu.grid import GridSpec
from pypic_tpu.parallel import domain, domain_implicit as di, make_mesh

from pypic_tpu_torch import interop
from pypic_tpu_torch.grid import GridSpec as TGridSpec
from pypic_tpu_torch.parallel import (domain as tdomain,
                                      domain_implicit as tdi,
                                      make_mesh as tmake_mesh, spawn)
import _torch_ranks

N, NG, S = 16_000, 64, 2
TOLERANT = dict(tol=1e-6, maxiter=40)
CONSERVING = dict(tol=1e-30, maxiter=3, picard_init="extrapolate",
                  picard_accel="anderson")
TOL_FE, TOL_KE, TOL_P_CELLS = 1e-4, 1e-5, 1e-4
COUNTS = {"implicit": ("picard_iters", "n_migrated", "n_dropped",
                       "n_alive", "picard_clamped"),
          "explicit": ("n_migrated", "n_dropped", "n_alive")}
_STATE_KEYS = {"implicit": ("p", "v", "alive", "q", "m", "e", "j", "e_prev",
                            "e_prev2", "step"),
               "explicit": ("p", "v", "alive", "q", "m", "step", "rho")}


@pytest.fixture(scope="module")
def problem():
    density = 1e10
    te = 0.1 * 11600.0
    debye = np.sqrt(K_BOLTZMANN * te * EPSILON_0 / E_CHARGE**2 / density)
    grid = GridSpec(NG, 15.0 * debye, "periodic")
    x, v, params = init.initialize_periodic(
        "two-stream", N, density, 1, 0.05, grid, te, te, seed=2)
    return grid, x, v, params


def _jax_state(problem, engine, s, cfg_kw, mesh=None):
    """(JAX config kwargs, its state on s devices, the state as numpy)."""
    grid, x, v, params = problem
    kw = dict(dt=0.1 / params.wp, p2c=params.p2c, num_shards=s,
              migrate_cap=2048)
    kw.update(cfg_kw)
    mesh = mesh if mesh is not None else make_mesh(s, axis="slabs")
    if engine == "implicit":
        kw.setdefault("halo", 4)
        cfg = di.DomainImplicitConfig(grid, **kw)
        st = di.shard_state(di.init_state(x, v, -E_CHARGE, M_ELECTRON, cfg),
                            mesh, cfg)
    else:
        cfg = domain.DomainConfig(grid, **kw)
        st = domain.shard_state(
            domain.init_state(x, v, -E_CHARGE, M_ELECTRON, cfg), mesh, cfg)
    state0 = {k: np.asarray(getattr(st, k)) for k in _STATE_KEYS[engine]}
    return cfg, kw, st, state0, mesh


def _jax_super(problem, engine, cfg_kw, k, calls):
    """JAX's superstep: its rows (one a micro-step), the state after the
    first call, and the port's job."""
    cfg, kw, st, state0, mesh = _jax_state(problem, engine, S, cfg_kw)
    mod = di if engine == "implicit" else domain
    sup = jax.jit(mod.make_superstep(cfg, mesh, k))
    rows, first = {}, None
    for i in range(calls):
        st, m = sup(st)
        for f, val in m._asdict().items():
            assert np.shape(val) == (k,), f
            rows.setdefault(f, []).extend(np.asarray(val).tolist())
        if i == 0:
            first = {key: np.asarray(getattr(st, key))
                     for key in _STATE_KEYS[engine]}
    grid = problem[0]
    job = ("supersteps", dict(engine=engine, state=state0,
                              grid=(grid.ng, grid.length, grid.bc), cfg=kw,
                              k=k, n_calls=calls))
    return job, dict(rows=rows, first=first, step=int(st.step))


def _k1_job(problem, engine, cfg_kw):
    _, kw, _, state0, _ = _jax_state(problem, engine, S, cfg_kw)
    grid = problem[0]
    return ("k1_pair", dict(engine=engine, state=state0,
                            grid=(grid.ng, grid.length, grid.bc), cfg=kw,
                            n_steps=2))


# name: (engine, config, k, calls)
CASES = {
    "explicit k2": ("explicit", dict(halo=12), 2, 2),
    "explicit distributed k3": (
        "explicit", dict(halo=12, field_solve="distributed"), 3, 1),
    "implicit fused k2": (
        "implicit", dict(backend="fused", halo=12, **TOLERANT), 2, 2),
    "implicit composed k3": (
        "implicit", dict(backend="composed", halo=12, **TOLERANT), 3, 1),
    "implicit fused aitken anderson2 k2": (
        "implicit", dict(backend="fused", halo=12, finalize_field="aitken",
                         **dict(CONSERVING, picard_accel="anderson2")), 2, 1),
}
CLAMPED = {
    "explicit halo 1 k8": ("explicit", dict(halo=1), 8, 1),
    "implicit halo 1 k3": ("implicit", dict(backend="fused", halo=1,
                                            dt_scale=4.0, **TOLERANT), 3, 1),
}
K1 = {
    "explicit k1": ("explicit", dict()),
    "implicit fused k1": ("implicit", dict(backend="fused", **TOLERANT)),
}


@pytest.fixture(scope="module")
def two_ranks(problem, tmp_path_factory):
    """JAX on 2 devices and the port on 2 gloo ranks, one spawn."""
    refs, jobs, names = {}, [], []
    for name, (engine, kw, k, calls) in {**CASES, **CLAMPED}.items():
        kw = dict(kw)
        scale = kw.pop("dt_scale", 1.0)
        if scale != 1.0:
            kw["dt"] = scale * 0.1 / problem[3].wp
        job, refs[name] = _jax_super(problem, engine, kw, k, calls)
        jobs.append(job)
        names.append(name)
    for name, (engine, kw) in K1.items():
        jobs.append(_k1_job(problem, engine, kw))
        names.append(name)
    got = spawn.run(S, _torch_ranks.batch, jobs, device="cpu",
                    tmp_dir=tmp_path_factory.mktemp("super2"))
    return refs, {name: [rank[i] for rank in got]
                  for i, name in enumerate(names)}


def _engine(name):
    return {**CASES, **CLAMPED}[name][0]


@pytest.mark.parametrize("name", sorted(CASES))
def test_superstep_matches_jax(two_ranks, name):
    refs, got = two_ranks
    engine, _, k, calls = CASES[name]
    ref, ranks = refs[name], got[name]
    rows, shapes, _, step = ranks[0]
    for other in ranks[1:]:  # the sums reach every rank: the same rows
        assert other[0] == rows and other[3] == step
    assert step == ref["step"] == k * calls
    for shape in shapes:
        assert set(shape.values()) == {(k,)}, shape
    for f in COUNTS[engine] + ("n_halo_clamped",):
        assert rows[f] == ref["rows"][f], f
    assert sum(rows["n_halo_clamped"]) == 0
    mig = np.asarray(rows["n_migrated"]).reshape(calls, k)
    assert (mig[:, :-1] == 0).all() and mig[:, -1].sum() > 0
    assert rows["n_alive"] == [N] * (k * calls)
    assert sum(rows["n_dropped"]) == 0
    np.testing.assert_allclose(rows["field_energy"], ref["rows"]["field_energy"],
                               rtol=TOL_FE)
    np.testing.assert_allclose(rows["kinetic_energy"],
                               ref["rows"]["kinetic_energy"], rtol=TOL_KE)


@pytest.mark.parametrize("name", sorted(CASES))
def test_superstep_positions_match_jax(two_ranks, name):
    """The state after the first call, slot for slot: the same alive
    slots, positions within 1e-4 cells the short way round the seam."""
    refs, got = two_ranks
    a = refs[name]["first"]
    kept = [r[2] for r in got[name]]
    b = {key: np.concatenate([kr[key] for kr in kept]) if np.ndim(kept[0][key])
         else kept[0][key] for key in kept[0]}
    np.testing.assert_array_equal(b["alive"], a["alive"])
    alive = a["alive"]
    dp = np.abs(b["p"][alive].astype(np.float64) - a["p"][alive])
    assert np.minimum(dp, NG - dp).max() <= TOL_P_CELLS
    if _engine(name) == "implicit":
        rel = np.abs(b["e"] - a["e"]).max() / np.abs(a["e"]).max()
        assert rel <= 1e-4


@pytest.mark.parametrize("name", sorted(CLAMPED))
def test_undersized_halo_is_counted(two_ranks, name):
    refs, got = two_ranks
    rows = got[name][0][0]
    ref = refs[name]["rows"]
    assert sum(ref["n_halo_clamped"]) > 0 and sum(rows["n_halo_clamped"]) > 0
    np.testing.assert_allclose(sum(rows["n_halo_clamped"]),
                               sum(ref["n_halo_clamped"]), rtol=1e-2)
    assert rows["n_alive"] == ref["n_alive"]


@pytest.mark.parametrize("name", sorted(K1))
def test_k1_is_make_step_on_two_ranks(two_ranks, name):
    _, got = two_ranks
    for (rows_a, st_a), (rows_b, st_b) in got[name]:
        assert rows_a == rows_b
        for key in st_a:
            np.testing.assert_array_equal(st_a[key], st_b[key], err_msg=key)


# one rank: superstep(k=1) and make_step bit for bit, every path
K1_ONE_RANK = {
    "implicit fused converged": ("implicit", dict(backend="fused")),
    "implicit fused converged-deposit": (
        "implicit", dict(backend="fused", finalize="converged-deposit")),
    "implicit fused iterate": ("implicit", dict(backend="fused",
                                                finalize="iterate")),
    "implicit fused aitken": ("implicit", dict(backend="fused",
                                               finalize_field="aitken",
                                               **CONSERVING)),
    "implicit composed": ("implicit", dict(backend="composed")),
    "explicit replicated": ("explicit", dict()),
    "explicit distributed": ("explicit", dict(field_solve="distributed")),
}


@pytest.mark.parametrize("name", sorted(K1_ONE_RANK))
def test_k1_is_make_step_bit_for_bit(problem, name):
    engine, kw = K1_ONE_RANK[name]
    grid, x, v, params = problem
    tgrid = TGridSpec(grid.ng, grid.length, grid.bc)
    mesh = tmake_mesh(device="cpu")
    base = dict(dt=0.1 / params.wp, p2c=params.p2c, num_shards=1,
                migrate_cap=2048)
    if engine == "implicit":
        cfg = tdi.DomainImplicitConfig(tgrid, **base, halo=4,
                                       **dict(TOLERANT, **kw))
        mod = tdi
    else:
        cfg = tdomain.DomainConfig(tgrid, **base, **kw)
        mod = tdomain
    st0 = mod.init_state(x, v, -E_CHARGE, M_ELECTRON, cfg, mesh)
    out = []
    for step in (mod.make_step(cfg, mesh), mod.make_superstep(cfg, mesh, 1)):
        st, rows = st0, []
        for _ in range(3):
            st, m = step(st)
            rows.append(m)
        out.append((st, rows))
    (sa, ra), (sb, rb) = out
    for f in ("p", "v", "alive") + (("e", "j") if engine == "implicit"
                                    else ("rho",)):
        assert torch.equal(getattr(sa, f), getattr(sb, f)), f
    assert int(sb.step) == 3
    for ma, mb in zip(ra, rb):
        for f in ma._fields:
            assert getattr(mb, f).shape == (1,), f
            assert torch.equal(getattr(ma, f).reshape(1), getattr(mb, f)), f


@pytest.mark.parametrize("engine", ["implicit", "explicit"])
def test_migrate_every_below_one_is_refused(problem, engine):
    grid, _, _, params = problem
    tgrid = TGridSpec(grid.ng, grid.length, grid.bc)
    base = dict(dt=1e-9, p2c=params.p2c, num_shards=1)
    if engine == "implicit":
        pairs = ((di, di.DomainImplicitConfig(grid, **base)),
                 (tdi, tdi.DomainImplicitConfig(tgrid, **base)))
    else:
        pairs = ((domain, domain.DomainConfig(grid, **base)),
                 (tdomain, tdomain.DomainConfig(tgrid, **base)))
    msgs = []
    for mod, cfg in pairs:
        mesh = (make_mesh(1, axis="slabs") if mod in (di, domain)
                else tmake_mesh(device="cpu"))
        with pytest.raises(ValueError, match="migrate_every") as err:
            mod.make_superstep(cfg, mesh, 0)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
