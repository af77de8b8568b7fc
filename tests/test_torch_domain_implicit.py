"""The domain-decomposed engines of the port against ``pypic_tpu``'s, as a
whole: tests/test_domain.py:16-25's two-stream problem (n = 16,000,
ng = 64) through ``interop``, the same JAX state stepped by JAX on S of
conftest's CPU devices and by S gloo ranks of the port
(``tests/_torch_ranks.py`` under ``parallel.spawn``).

* ``domain_implicit``: the fused backend at 2 ranks (JAX's Pallas kernels
  in interpret mode, the port's plain kernel versions) and the composed
  backend at 4, each in the conserving configuration (tol 1e-30, maxiter
  4, extrapolated init, Anderson) and at tol 1e-6 / maxiter 40; then
  finalize 'converged-deposit' and 'iterate' and the shared window, one
  step each.
* ``domain.make_step`` (the explicit carrier) at 2 ranks, fused push and
  composed.

One step: positions within 2e-5 cells (the short way round the seam),
velocities and fields within 1e-5 of their largest value, slot for slot;
the Picard count and the migrated, dropped and halo-clamped counts equal.
Ten steps: field energy rtol 1e-4, kinetic energy rtol 1e-5
(tests/test_domain.py:353-356), the counts equal step by step.
"""

import numpy as np
import pytest
import torch

from pypic_tpu.constants import E_CHARGE, EPSILON_0, K_BOLTZMANN, M_ELECTRON
from pypic_tpu.grid import GridSpec
from pypic_tpu import initialize as init
from pypic_tpu.parallel import domain, domain_implicit as di, make_mesh

from pypic_tpu_torch import interop
from pypic_tpu_torch.grid import GridSpec as TGridSpec
from pypic_tpu_torch.parallel import (domain as tdomain,
                                      domain_implicit as tdi,
                                      make_mesh as tmake_mesh, spawn)
import _torch_ranks

N, NG, STEPS = 16_000, 64, 10
CONSERVING = dict(tol=1e-30, maxiter=4, picard_init="extrapolate",
                  picard_accel="anderson")
TOLERANT = dict(tol=1e-6, maxiter=40)
TOL_P_CELLS, TOL_REL = 2e-5, 1e-5
TOL_FE, TOL_KE = 1e-4, 1e-5
COUNTS_IMPLICIT = ("picard_iters", "n_migrated", "n_dropped",
                   "n_halo_clamped", "n_alive", "picard_clamped")
COUNTS_EXPLICIT = ("n_migrated", "n_dropped", "n_alive")
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


def _jax_case(problem, engine, s, cfg_kw, steps):
    """JAX's state before the run (numpy), after step 1, and the metric
    rows of ``steps`` steps on s devices."""
    grid, x, v, params = problem
    dt = 0.1 / params.wp
    mesh = make_mesh(s, axis="slabs")
    if engine == "implicit":
        cfg = di.DomainImplicitConfig(grid, dt, params.p2c, num_shards=s,
                                      halo=4, migrate_cap=2048, **cfg_kw)
        st = di.shard_state(di.init_state(x, v, -E_CHARGE, M_ELECTRON, cfg),
                            mesh, cfg)
        step = di.make_step(cfg, mesh)
    else:
        cfg = domain.DomainConfig(grid, dt, params.p2c, num_shards=s,
                                  migrate_cap=2048, **cfg_kw)
        st = domain.shard_state(
            domain.init_state(x, v, -E_CHARGE, M_ELECTRON, cfg), mesh, cfg)
        step = domain.make_step(cfg, mesh)
    state0 = {k: np.asarray(getattr(st, k)) for k in _STATE_KEYS[engine]}
    rows, after1 = {}, None
    for i in range(steps):
        st, m = step(st)
        for k, val in m._asdict().items():
            rows.setdefault(k, []).append(np.asarray(val).item())
        if i == 0:
            after1 = {k: np.asarray(getattr(st, k)) for k in _STATE_KEYS[engine]}
    job_cfg = dict(dt=dt, p2c=params.p2c, num_shards=s, migrate_cap=2048,
                   **cfg_kw)
    if engine == "implicit":
        job_cfg["halo"] = 4
    job = ("steps", dict(engine=engine, state=state0,
                         grid=(grid.ng, grid.length, grid.bc), cfg=job_cfg,
                         n_steps=steps))
    return job, dict(after1=after1, rows=rows)


CASES = {
    # world size: [(name, engine, config, steps)]
    2: [("fused conserving", "implicit",
         dict(backend="fused", **CONSERVING), STEPS),
        ("fused tol 1e-6", "implicit", dict(backend="fused", **TOLERANT),
         STEPS),
        ("converged-deposit", "implicit",
         dict(backend="fused", finalize="converged-deposit", **TOLERANT), 1),
        ("iterate", "implicit",
         dict(backend="fused", finalize="iterate", **TOLERANT), 1),
        ("shared", "implicit",
         dict(backend="fused", window_share="shared", **TOLERANT), 1),
        ("explicit fused", "explicit", dict(push_backend="fused"), STEPS),
        ("explicit composed", "explicit", dict(push_backend="composed"),
         STEPS)],
    4: [("composed conserving", "implicit",
         dict(backend="composed", **CONSERVING), STEPS),
        ("composed tol 1e-6", "implicit",
         dict(backend="composed", **TOLERANT), STEPS)],
}


@pytest.fixture(scope="module", params=sorted(CASES))
def world(request, problem, tmp_path_factory):
    """Every case of one world size: JAX on s devices, then the port on s
    gloo ranks in one spawn."""
    s = request.param
    jobs, refs = [], {}
    for name, engine, cfg_kw, steps in CASES[s]:
        job, refs[name] = _jax_case(problem, engine, s, cfg_kw, steps)
        jobs.append(job)
    got = spawn.run(s, _torch_ranks.batch, jobs, device="cpu",
                    tmp_dir=tmp_path_factory.mktemp(f"ranks{s}"))
    out = {}
    for i, (name, engine, _, _) in enumerate(CASES[s]):
        rows = got[0][i][0]
        for rank in got[1:]:  # every rank reports the same summed metrics
            assert rank[i][0] == rows, name
        kept = [rank[i][1][1] for rank in got]
        after1 = {k: (kept[0][k] if np.ndim(kept[0][k]) == 0
                      else np.concatenate([kr[k] for kr in kept]))
                  for k in kept[0]}
        out[name] = (engine, refs[name], dict(after1=after1, rows=rows))
    return s, out


def _rel(ref, got):
    ref = np.asarray(ref, np.float64)
    return np.abs(np.asarray(got, np.float64) - ref).max() / np.abs(ref).max()


def _one_step(engine, ref, got):
    a, b = ref["after1"], got["after1"]
    np.testing.assert_array_equal(b["alive"], a["alive"])
    alive = a["alive"]
    dp = np.abs(b["p"][alive].astype(np.float64) - a["p"][alive])
    assert np.minimum(dp, NG - dp).max() <= TOL_P_CELLS
    assert _rel(a["v"][alive], b["v"][alive]) <= TOL_REL
    if engine == "implicit":
        assert _rel(a["e"], b["e"]) <= TOL_REL
        np.testing.assert_array_equal(b["e_prev"], a["e_prev"])
    assert int(b["step"]) == int(a["step"]) == 1


def _counts(engine, ref, got, steps):
    for k in COUNTS_IMPLICIT if engine == "implicit" else COUNTS_EXPLICIT:
        assert got["rows"][k] == ref["rows"][k], k
    assert len(got["rows"]["field_energy"]) == steps


def test_one_step_matches_jax(world):
    s, out = world
    for name, (engine, ref, got) in out.items():
        _one_step(engine, ref, got)
        _counts(engine, {"rows": {k: v[:1] for k, v in ref["rows"].items()}},
                {"rows": {k: v[:1] for k, v in got["rows"].items()}}, 1)
        np.testing.assert_allclose(got["rows"]["field_energy"][0],
                                   ref["rows"]["field_energy"][0], rtol=TOL_FE)
        np.testing.assert_allclose(got["rows"]["kinetic_energy"][0],
                                   ref["rows"]["kinetic_energy"][0],
                                   rtol=TOL_KE)


def test_ten_steps_match_jax(world):
    s, out = world
    runs = [(n, e, r, g) for n, (e, r, g) in out.items()
            if len(r["rows"]["field_energy"]) == STEPS]
    assert runs
    for name, engine, ref, got in runs:
        np.testing.assert_allclose(got["rows"]["field_energy"],
                                   ref["rows"]["field_energy"], rtol=TOL_FE,
                                   err_msg=name)
        np.testing.assert_allclose(got["rows"]["kinetic_energy"],
                                   ref["rows"]["kinetic_energy"], rtol=TOL_KE,
                                   err_msg=name)
        _counts(engine, ref, got, STEPS)
        assert sum(got["rows"]["n_migrated"]) > 0, name
        assert sum(got["rows"]["n_dropped"]) == 0, name
        if name.endswith("conserving"):
            assert set(got["rows"]["picard_iters"]) == {4}


def test_interop_round_trip_is_bit_exact(problem):
    grid, x, v, params = problem
    dt = 0.1 / params.wp
    mesh = make_mesh(4, axis="slabs")
    cfg = di.DomainImplicitConfig(grid, dt, params.p2c, num_shards=4)
    st = di.init_state(x, v, -E_CHARGE, M_ELECTRON, cfg)
    d = {k: np.asarray(getattr(st, k)) for k in _STATE_KEYS["implicit"]}
    states = interop.domain_implicit_states_from_numpy(d, 4, "cpu")
    assert len(states) == 4 and states[1].e.shape == (NG // 4,)
    back = interop.domain_implicit_states_to_numpy(states)
    for k in d:
        assert back[k].dtype == d[k].dtype
        np.testing.assert_array_equal(back[k], d[k])
    ecfg = domain.DomainConfig(grid, dt, params.p2c, num_shards=2)
    est = domain.init_state(x, v, -E_CHARGE, M_ELECTRON, ecfg)
    d = {k: np.asarray(getattr(est, k)) for k in _STATE_KEYS["explicit"]}
    back = interop.domain_states_to_numpy(
        interop.domain_states_from_numpy(d, 2, "cpu"))
    for k in d:
        np.testing.assert_array_equal(back[k], d[k])
    del mesh


def test_one_rank_init_state_matches_jax(problem):
    """The port's own init_state (no interop) on a one-rank mesh: the same
    particles in the same slots as JAX's, E0 and j0 to float32 deposit
    order."""
    grid, x, v, params = problem
    dt = 0.1 / params.wp
    cfg = di.DomainImplicitConfig(grid, dt, params.p2c, num_shards=1)
    st = di.init_state(x, v, -E_CHARGE, M_ELECTRON, cfg)
    tcfg = tdi.DomainImplicitConfig(TGridSpec(NG, grid.length, "periodic"),
                                    dt, params.p2c, num_shards=1)
    tst = tdi.init_state(x, v, -E_CHARGE, M_ELECTRON, tcfg,
                         tmake_mesh(device="cpu"))
    n = int(np.asarray(st.alive).sum())
    assert int(tst.alive.sum()) == n == N
    np.testing.assert_array_equal(tst.p[:n].numpy(), np.asarray(st.p)[:n])
    np.testing.assert_array_equal(tst.v[:n].numpy(), np.asarray(st.v)[:n])
    assert _rel(np.asarray(st.e), tst.e.numpy()) <= 1e-5
    assert _rel(np.asarray(st.j), tst.j.numpy()) <= 1e-5


def test_unported_options_raise_naming_their_items(problem):
    grid, x, v, params = problem
    tgrid = TGridSpec(NG, grid.length, "periodic")
    mesh = tmake_mesh(device="cpu")
    base = dict(dt=1e-9, p2c=params.p2c, num_shards=1)
    for kw, item in ((dict(finalize_field="aitken"), "item 18"),
                     (dict(picard_accel="anderson2"), "item 18"),
                     (dict(dp_axis_name="dp", num_replicas=2), "item 17")):
        with pytest.raises(NotImplementedError, match=item):
            tdi.make_step(tdi.DomainImplicitConfig(tgrid, **base, **kw), mesh)
    with pytest.raises(NotImplementedError, match="item 18"):
        tdi.make_superstep(tdi.DomainImplicitConfig(tgrid, **base), mesh, 2)
    for kw, item in ((dict(field_solve="distributed"), "item 17"),
                     (dict(carried_rho="on", halo=2), "item 18")):
        with pytest.raises(NotImplementedError, match=item):
            tdomain.make_step(tdomain.DomainConfig(tgrid, **base, **kw), mesh)
    with pytest.raises(NotImplementedError, match="item 18"):
        tdomain.make_superstep(tdomain.DomainConfig(tgrid, **base), mesh, 2)


def test_entry_points_need_a_card_unless_cpu(problem, monkeypatch):
    grid, x, v, params = problem
    tcfg = tdi.DomainImplicitConfig(TGridSpec(NG, grid.length, "periodic"),
                                    1e-9, params.p2c, num_shards=1)
    cpu_mesh = tmake_mesh(device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmake_mesh()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdi.init_state(x, v, -E_CHARGE, M_ELECTRON, tcfg, tmake_mesh())
    with pytest.raises(ValueError, match="one slab a rank"):
        tdi.make_step(tdi.DomainImplicitConfig(
            tcfg.grid, 1e-9, params.p2c, num_shards=2), cpu_mesh)


@pytest.mark.parametrize("world", [1, 2])
def test_spawn_runs_on_the_card_unless_cpu(world, monkeypatch):
    """``spawn.run`` resolves its device as the other entry points do: the
    card by default, raising before any rank starts when there is none."""
    assert spawn.run(1, _torch_ranks.batch, [], device="cpu") == [[]]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        spawn.run(world, _torch_ranks.batch, [])


LANDAU_N, LANDAU_WARMUP, LANDAU_STEPS = 200_000, 2, 10


@pytest.fixture(scope="module")
def landau_explicit():
    """bench_domain_explicit's row (the Landau preset, dt 1e-5, ng 200,
    one shard) at bench's CPU size, n = 200,000, on one load: JAX's metric
    rows over 2 + 10 steps."""
    from pypic_tpu_torch.tools import domain as row

    x, v = row.host_load(LANDAU_N)
    g = row.grid()
    cfg = domain.DomainConfig(
        GridSpec(g.ng, g.length, "periodic"), row.DT,
        g.length * row.DENSITY / LANDAU_N, num_shards=1, halo=0,
        migrate_cap=max(4096, 4 * (LANDAU_N // g.ng)))
    mesh = make_mesh(1, axis="slabs")
    st = domain.shard_state(domain.init_state(
        x, v, -E_CHARGE, M_ELECTRON, cfg, capacity_factor=1.05), mesh, cfg)
    step = domain.make_step(cfg, mesh)
    rows = {"field_energy": [], "kinetic_energy": []}
    for _ in range(LANDAU_WARMUP + LANDAU_STEPS):
        st, m = step(st)
        for k in rows:
            rows[k].append(float(getattr(m, k)))
    return (x, v), rows


def _rise(rows):
    """The total energy change over the timed steps, relative to their
    first row (tools/domain.py's ``total_energy_rel_change``)."""
    tot = (np.asarray(rows["field_energy"][LANDAU_WARMUP:])
           + np.asarray(rows["kinetic_energy"][LANDAU_WARMUP:]))
    return (tot[-1] - tot[0]) / tot[0]


@pytest.mark.parametrize("push_backend", ["fused", "composed"])
def test_explicit_landau_energy_rise_matches_jax(landau_explicit,
                                                 push_backend):
    """The explicit carrier's total energy rises by about 0.1 over ten
    steps of the Landau row (wp dt = 0.18, half the energy in the field
    at the start): the reference scheme's rise, which the port repeats
    row for row (rtol 1e-4 / 1e-5, as the two-stream checks)."""
    from pypic_tpu_torch.tools import domain as row

    load, ref = landau_explicit
    cfg, st = row.explicit_row(tmake_mesh(device="cpu"), LANDAU_N, load=load,
                               push_backend=push_backend)
    step = tdomain.make_step(cfg, tmake_mesh(device="cpu"))
    got = {"field_energy": [], "kinetic_energy": []}
    for _ in range(LANDAU_WARMUP + LANDAU_STEPS):
        st, m = step(st)
        for k in got:
            got[k].append(float(getattr(m, k)))
    np.testing.assert_allclose(got["field_energy"], ref["field_energy"],
                               rtol=TOL_FE)
    np.testing.assert_allclose(got["kinetic_energy"], ref["kinetic_energy"],
                               rtol=TOL_KE)
    print(f"Landau explicit carrier, n = {LANDAU_N}, total energy change "
          f"over steps {LANDAU_WARMUP + 1}-{LANDAU_WARMUP + LANDAU_STEPS}: "
          f"JAX {_rise(ref):+.6e}, port ({push_backend}) {_rise(got):+.6e}")
    assert 0.05 < _rise(ref) < 0.2
    assert abs(_rise(got) - _rise(ref)) <= 1e-4 * abs(_rise(ref))


@pytest.mark.parametrize("name", ["domain_implicit", "domain_explicit"])
def test_presets_match_jax(name):
    """The domain presets size the halo, the migration bucket and the
    tolerances as ``pypic_tpu.presets`` does; the shard count is the
    mesh's world size; the superstep raises naming item 18."""
    from pypic_tpu import presets as jpresets
    from pypic_tpu_torch import presets as tpresets

    ref = jpresets.get(name, n=4000, shards=1)
    got = tpresets.get(name, n=4000, device="cpu")
    for f in ("num_shards", "halo", "migrate_cap", "dt", "p2c") + (
            ("tol", "maxiter", "picard_init") if name == "domain_implicit"
            else ("field_solve", "carried_rho")):
        assert getattr(got.config, f) == getattr(ref.config, f), f
    st, m = got.make_step()(got.state)
    assert int(m.n_alive) == 4000 and int(st.step) == 1
    with pytest.raises(NotImplementedError, match="item 18"):
        tpresets.get(name, n=4000, device="cpu", migrate_every=2)
