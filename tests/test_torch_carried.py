"""The carried deposits of pypic_tpu_torch against pypic_tpu: the
magnetized engine's carried_deposit='on' with react_batch, and the
domain-decomposed explicit carrier's carried_rho='on'.

The same numpy inputs go through the JAX function (its Pallas kernels in
interpret mode) and the port's counterpart (its plain kernel versions: the
tensors lie on the CPU):

* the two kernels, ``boris_gather_push_deposit`` and
  ``explicit_domain_cycle``, with inactive and dead rows, rows past the
  grid and a forced clamp;
* one magnetized step from JAX's states after 0 and 10 steps, the JAX
  re-activation table replayed through ``make_step(source_draws=...)``,
  for reactivate 'source' and 'flux';
* the carry against a fresh deposit over 25 steps, and carried against
  recomputed dynamics (tests/test_magnetized.py:1133-1168, on the port);
* the carried carrier on 1 and 2 gloo ranks against JAX on 1 and 2
  shards (tests/test_domain.py:181-216's limits), each world size's jobs
  in one spawn.

Each tolerance is stated beside its test.
"""

import dataclasses as dc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pypic_tpu import initialize as jinit
from pypic_tpu import presets as jpresets
from pypic_tpu import sources as jsources
from pypic_tpu.constants import (E_CHARGE, EPSILON_0, EV_TO_K, K_BOLTZMANN,
                                 M_ELECTRON, M_PROTON)
from pypic_tpu.engines import magnetized as jmag
from pypic_tpu.grid import GridSpec as JGridSpec
from pypic_tpu.ops.pallas_cic import (boris_gather_push_deposit_pallas,
                                      explicit_domain_cycle_pallas)
from pypic_tpu.parallel import domain as jdomain, make_mesh

from pypic_tpu_torch import interop
from pypic_tpu_torch.engines import magnetized
from pypic_tpu_torch.grid import GridSpec
from pypic_tpu_torch.ops import cuda_cic, cuda_domain
from pypic_tpu_torch.parallel import spawn
import _torch_ranks


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(ref, got, rel):
    """|got - ref| <= rel * max|ref|."""
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rel * max(np.abs(ref).max(), 1e-300))


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------


def _carried_inputs(n, ng, hot, seed):
    """Bounded-grid particles: a tenth inactive, every row off the grid
    (p < 0 or p > ng - 1: wall-lost slots) inactive, edge rows at 0 and
    ng - 1; the weights masked (0 in inactive rows). ``hot`` scales the
    velocities."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(-0.5, ng - 0.5, n).astype(np.float32)
    p[:4] = [0.0, ng - 1.0, -0.3, ng - 0.7]
    v = (rng.normal(size=(3, n)) * 2e4 * hot).astype(np.float32)
    act = (rng.random(n) < 0.9) & (p >= 0.0) & (p <= ng - 1.0)
    act = act.astype(np.float32)
    z = rng.integers(1, 6, n).astype(np.float32)
    const = (z * np.float32(0.5 * 1e-10 * E_CHARGE / (10.81 * M_PROTON)))
    field = (rng.normal(size=ng) * 1e5).astype(np.float32)
    wr = (act * z * 3.2).astype(np.float32)
    wn = (act * 1.5).astype(np.float32)
    return field, p, v[0], v[1], v[2], const.astype(np.float32), act, wr, wn


@pytest.mark.parametrize("swap", [False, True], ids=["cic", "mirrored"])
@pytest.mark.parametrize("pad, hot", [(2, 1.0), (0, 40.0)],
                         ids=["pad 2", "forced clamp"])
def test_boris_gather_push_deposit_plain_matches_pallas(pad, hot, swap):
    """n = 20,000, ng = 64, the carried pad of the row (2) and a forced
    clamp (pad 0, 40x the velocities). The push as
    test_torch_magnetized.py's boris test holds it: positions within 1e-6
    cells, velocities 1e-5 of the largest (the TPU kernel's window gather
    rounds its tent weights otherwise), inactive rows bit-equal to their
    inputs. The clamp count equal. rho and n: float64 sums of the plain
    version's float32 terms within 1e-6 of the largest node (the same
    terms at the same nodes; the positions part by the gather's rounding),
    the float32 sums within 2e-5 (a few hundred terms a node)."""
    ng = 64
    args = _carried_inputs(20_000, ng, hot, seed=4 + int(swap))
    kw = dict(b=(0.1395, 1.9951, 0.0), dt_dx=1e-10 / 2.5e-6, pad=pad,
              swap_weights=swap)
    ref = boris_gather_push_deposit_pallas(*(jnp.asarray(a) for a in args),
                                           dt=1e-10, **kw)
    got = cuda_cic.boris_gather_push_deposit(*(_t(a) for a in args), **kw)
    exact = cuda_cic.boris_gather_push_deposit_plain(
        *(_t(a) for a in args), acc_dtype=torch.float64, **kw)
    live = args[6] > 0
    np.testing.assert_allclose(got[0].numpy()[live], np.asarray(ref[0])[live],
                               rtol=0, atol=1e-6 * ng)
    for r, g in zip(ref[1:4], got[1:4]):
        _close(np.asarray(r)[live], g.numpy()[live], 1e-5)
    for g, held in zip(got[:4], args[1:5]):
        np.testing.assert_array_equal(g.numpy()[~live], held[~live])
    for i in (4, 5):
        _close(ref[i], exact[i], 1e-6)
        _close(ref[i], got[i], 2e-5)
        assert got[i].dtype == torch.float32
    assert int(got[6]) == int(ref[6])
    if pad == 0:
        assert int(got[6]) > 1000
    # the rows the wall check drops deposit nothing: the carried totals
    # are the weights of the rows that stay on the grid
    stay = (got[0] >= 0) & (got[0] <= ng - 1)
    np.testing.assert_allclose(float(exact[5].sum()),
                               float(_t(args[8])[stay].double().sum()),
                               rtol=1e-6)


@pytest.mark.parametrize("c, hw, lo", [(64, 4, 0.0), (32, 3, 32.0)],
                         ids=["one rank", "middle rank"])
def test_explicit_domain_cycle_plain_matches_pallas(c, hw, lo):
    """n = 20,000, ng = 64, the extended slab of one rank (ext_n = 73) and
    of a middle rank's slab (c = 32, lo_shifted = 29, ext_n = 39); a
    tenth of the slots dead (w = 0, p = v = 0), the thermal speed high
    enough that live rows land past both ext edges. Positions within
    2e-5 cells of JAX's taken mod ng, velocities 1e-6 of the largest (the
    window gather's rounding); the clamp count equal; rho_ext as float64
    sums of the plain terms within 1e-6 of JAX's largest node and its
    float32 sums within 1e-4 (the edge nodes take thousands of clamped
    terms, summed in order)."""
    ng, n = 64, 20_000
    ext_n = c + 2 * hw + 1
    rng = np.random.default_rng(int(lo) + 1)
    p = rng.uniform(lo, lo + c, n).astype(np.float32)
    v = (rng.normal(size=n) * 3e5).astype(np.float32)
    w = np.full(n, -3.2e-9, np.float32)
    w[rng.random(n) < 0.1] = 0.0
    p[w == 0] = 0.0
    v[w == 0] = 0.0
    field = (rng.normal(size=ng) * 1e3).astype(np.float32)
    qm, dt, dx = np.float32(-1.7e11), 1e-7, 0.05
    ref = explicit_domain_cycle_pallas(
        *(jnp.asarray(a) for a in (field, p, v, w)), qm=jnp.float32(qm),
        dt=dt, dx=dx, lo_shifted=jnp.float32(lo - hw), ext_n=ext_n)
    kw = dict(qm=float(qm), dt=dt, dx=dx, lo_shifted=lo - hw, ext_n=ext_n)
    got = cuda_domain.explicit_domain_cycle(*(_t(a) for a in (field, p, v, w)),
                                            **kw)
    exact = cuda_domain.explicit_domain_cycle_plain(
        *(_t(a) for a in (field, p, v, w)), acc_dtype=torch.float64, **kw)
    d = np.abs(np.mod(np.asarray(ref[0], np.float64), ng) - got[0].numpy())
    assert np.minimum(d, ng - d).max() <= 2e-5
    assert ((got[0] >= 0) & (got[0] < ng)).all()
    _close(ref[1], got[1], 1e-6)
    _close(ref[2], exact[2], 1e-6)
    _close(ref[2], got[2], 1e-4)
    assert int(got[3]) == int(ref[3]) > 0
    # charge kept: clamped rows land at the edge, dead rows add nothing
    np.testing.assert_allclose(float(exact[2].sum()), float(w.astype(np.float64).sum()),
                               rtol=1e-6)


# ---------------------------------------------------------------------------
# the magnetized engine: one carried step against JAX's
# ---------------------------------------------------------------------------

CASES = {
    # name: (preset, config overrides)
    "source": ("pic_iead", dict(carried_deposit="on", react_batch=8)),
    "flux": ("dn", dict(carried_deposit="on", react_batch=16)),
    "react_batch only": ("pic_iead", dict(react_batch=8)),
}


def _port_cfg(jcfg):
    return magnetized.MagnetizedConfig(**{
        f.name: getattr(jcfg, f.name) for f in dc.fields(jcfg)
        if f.name not in ("grid", "source")},
        grid=GridSpec(jcfg.grid.ng, jcfg.grid.length, jcfg.grid.bc),
        source=magnetized.SourceSpec(**dc.asdict(jcfg.source)))


def _replay(jstate, jcfg):
    """The JAX step's own re-activation table (threefry, 'auto' on the
    CPU) at n = react_batch, as the port's source_draws."""
    _, _, k_src, _ = jax.random.split(jstate.rng, 4)
    src = jcfg.source
    if jcfg.reactivate == "flux":
        batch = jsources.sample_flux_6d(
            k_src, jcfg.react_batch, jcfg.grid, src.ti, src.mass, vx=src.vx,
            gamma=jcfg.flux_gamma, vx_pert=jcfg.flux_vx_pert, components=True)
    else:
        batch = jsources.sample_source_6d(
            k_src, jcfg.react_batch, jcfg.grid, src.ti, src.mass, vx=src.vx,
            components=True)
    draws = {k: _t(v) for k, v in batch.items()}

    def source_draws(step, n_draw):
        assert n_draw == jcfg.react_batch
        return draws
    return source_draws


@pytest.fixture(scope="module", params=sorted(CASES))
def carried_states(request):
    """JAX's states after 0 and 10 steps of a case: pic_iead(n_per_species
    = 500) (n = 3,000, ng = 600) or dirichlet_neumann_test(n = 4,000,
    ng = 800), with the case's options."""
    name = request.param
    preset, over = CASES[name]
    pre = (jpresets.pic_iead(n_per_species=500) if preset == "pic_iead"
           else jpresets.dirichlet_neumann_test(n=4000, ng=800))
    cfg = dc.replace(pre.config, **over)
    st = pre.state
    if cfg.carried_deposit == "on":
        st = jmag.prime_carry(st, cfg)
    step = jax.jit(jmag.make_step(cfg))
    snaps = {0: st}
    for i in range(10):
        st, _ = step(st)
    snaps[10] = st
    return name, cfg, snaps


@pytest.mark.parametrize("at", [0, 10])
def test_carried_step_matches_jax(carried_states, at):
    """One step from JAX's state after ``at`` steps in both packages, the
    JAX table replayed: test_torch_magnetized.py's single-step limits (the
    opening rho rtol 1e-4, phi rtol 1e-3, active positions rtol 2e-5,
    velocities rtol 2e-4, n0 rtol 1e-5), equal active, re-activated and
    wall-hit counts; carried: the rho and n carried into the next step
    within 2e-5 of their largest node (float32 sums in other orders, the
    positions parted by the gather's rounding) and the clamp count
    equal."""
    name, jcfg, snaps = carried_states
    jstate = snaps[at]
    js, jm = jmag.make_step(jcfg)(jstate)
    d = {k: np.asarray(getattr(jstate, k)) for k in
         interop._MAGNETIZED_FIELDS + ("rng",)}
    ts, tm = magnetized.make_step(_port_cfg(jcfg), source_draws=_replay(
        jstate, jcfg))(interop.magnetized_state_from_numpy(d, "cpu"))
    np.testing.assert_allclose(tm.rho.numpy(), np.asarray(jm.rho), rtol=1e-4)
    np.testing.assert_allclose(tm.phi.numpy(), np.asarray(jm.phi), rtol=1e-3,
                               atol=1e-8)
    act = np.asarray(js.active) == 1
    np.testing.assert_allclose(ts.p.numpy()[act], np.asarray(js.p)[act],
                               rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(ts.v.numpy()[act], np.asarray(js.v)[act],
                               rtol=2e-4, atol=1.0)
    np.testing.assert_array_equal(ts.active.numpy(), np.asarray(js.active))
    for k in ("n_reactivated", "n_hit_wall", "n_active", "carry_clamped"):
        assert int(getattr(tm, k)) == int(getattr(jm, k)), k
    np.testing.assert_allclose(float(tm.n0), float(jm.n0), rtol=1e-5)
    if jcfg.carried_deposit == "on":
        _close(js.rho, ts.rho, 2e-5)
        _close(js.n, ts.n, 2e-5)
    else:
        np.testing.assert_array_equal(ts.rho.numpy(), np.asarray(js.rho))
    if at == 10:
        # the table bounds the step's re-activations
        assert 0 < int(tm.n_reactivated) <= jcfg.react_batch


def test_react_batch_caps_and_keeps_the_surplus():
    """react_batch caps the re-activations of a step and the surplus waits
    with its rank order: 40 planted losses with a table of 16 re-activate
    16, 16 and 8 over three steps, and the population is kept."""
    from pypic_tpu_torch import presets

    pre = presets.pic_iead(n_per_species=100, device="cpu")
    cfg = dc.replace(pre.config, react_batch=16, newton_backend="pallas")
    active = pre.state.active.clone()
    active[:40] = 0
    st = pre.state.replace(active=active)
    step = magnetized.make_step(cfg)
    taken = []
    for _ in range(3):
        st, m = step(st)
        taken.append(int(m.n_reactivated))
    assert taken[0] == taken[1] == 16
    assert taken[2] >= 8


# ---------------------------------------------------------------------------
# the carry over many steps (tests/test_magnetized.py:1091-1168 on the port)
# ---------------------------------------------------------------------------


def _port_setup(carried, **overrides):
    """test_magnetized.py's _carried_setup without the options still to be
    ported (ionization, 'capped-source'): ng = 51, 4,000 particles in
    4,800 slots, hot D+ in B = (0.5, 0.5, 1) T, the volumetric source with
    a 512-row table, the port's Philox sampler."""
    grid = GridSpec(51, 0.01, "dirichlet-dirichlet")
    rng = np.random.default_rng(1)
    n = 4000
    x = rng.uniform(0, grid.length, n)
    v = rng.normal(size=(n, 3)) * 5e4
    src = magnetized.SourceSpec(mass=2 * M_PROTON, charge_state=1.0,
                                p2c=5e15, species_idx=0, ti=10.0 * EV_TO_K)
    base = dict(grid=grid, dt=5e-9, te=10.0 * EV_TO_K, b=(0.5, 0.5, 1.0),
                species_z=(5,), reactivate="source", source=src,
                react_batch=512, iead_energy_max=100.0,
                carried_deposit=carried)
    base.update(overrides)
    cfg = magnetized.MagnetizedConfig(**base)
    st = magnetized.init_state(x, v, np.full(n, 2 * M_PROTON), np.ones(n),
                               np.full(n, 5e15), np.zeros(n, np.int32), cfg,
                               seed=3, capacity=4800, device="cpu")
    return cfg, st


def _carry_residual(state, cfg):
    """Largest deviation of the carried rho and n from a fresh deposit over
    the state's particles, relative to the fresh deposit's largest node."""
    fresh = magnetized.prime_carry(state, cfg)
    return [float((a - b).abs().max() / b.abs().max())
            for a, b in ((state.rho, fresh.rho), (state.n, fresh.n))]


def test_carry_invariant_and_equivalence():
    """carried_deposit='on' over 25 steps (carried_pad 8 bounds this hot
    workload's displacements): the carried rho and n equal a fresh deposit
    over the current particles within 5e-5 at every step (float32 sums in
    other orders; test_magnetized.py:1155), no clamp, and the wall hits
    and re-activations both exercised; against carried_deposit='off' with
    the same draws, the same active count, phi within 2.5e-3 of its
    scale (test_magnetized.py:1167-1168) and the IEAD totals within
    1e-6."""
    cfg_on, s_on = _port_setup("on", carried_pad=8)
    cfg_off, s_off = _port_setup("off")
    assert _carry_residual(s_on, cfg_on) == [0.0, 0.0]
    step_on = magnetized.make_step(cfg_on)
    step_off = magnetized.make_step(cfg_off)
    events = np.zeros(2, int)
    for i in range(25):
        s_on, m_on = step_on(s_on)
        s_off, _ = step_off(s_off)
        assert int(m_on.carry_clamped) == 0, i
        dr, dn = _carry_residual(s_on, cfg_on)
        assert dr < 5e-5 and dn < 5e-5, (i, dr, dn)
        events += [int(m_on.n_reactivated), int(m_on.n_hit_wall)]
    assert (events > 0).all(), events
    assert int(s_on.active.sum()) == int(s_off.active.sum())
    scale = float(s_off.phi.abs().max())
    np.testing.assert_allclose(s_on.phi.numpy(), s_off.phi.numpy(), rtol=0,
                               atol=2.5e-3 * scale)
    np.testing.assert_allclose(float(s_on.iead.sum()), float(s_off.iead.sum()),
                               rtol=1e-6)


def test_carried_clamp_is_counted_as_jax():
    """carried_pad 2 on the hot workload, no re-activation: one step from
    the same state in both packages counts the same clamps (> 0), the
    carried n within 2e-5 of JAX's; the clamped tents stay in the grid,
    so the carried total equals a fresh deposit's (rtol 1e-6,
    test_magnetized.py:1171-1191)."""
    cfg, st = _port_setup("on", carried_pad=2, reactivate="none")
    jcfg = jmag.MagnetizedConfig(**{
        f.name: getattr(cfg, f.name) for f in dc.fields(cfg)
        if f.name not in ("grid", "source")},
        grid=JGridSpec(cfg.grid.ng, cfg.grid.length, cfg.grid.bc),
        source=jmag.SourceSpec(**dc.asdict(cfg.source)))
    d = interop.magnetized_state_to_numpy(st)
    jst = jmag.MagnetizedState(**{
        k: jnp.asarray(d[k]) for k in interop._MAGNETIZED_FIELDS},
        rng=jax.random.PRNGKey(3))
    js, jm = jmag.make_step(jcfg)(jst)
    s1, m = magnetized.make_step(cfg)(st)
    assert int(m.carry_clamped) == int(jm.carry_clamped) > 0
    _close(js.n, s1.n, 2e-5)
    fresh = magnetized.prime_carry(s1, cfg)
    np.testing.assert_allclose(float(s1.n.double().sum()),
                               float(fresh.n.double().sum()), rtol=1e-6)


def test_row_tool_carried_runs_on_the_cpu():
    """tools/magnetized.run_row with the --carried row's options at a small
    n: the prime, the carry and the counts reach the result, and the
    carried total equals a fresh deposit's (rtol 1e-6)."""
    from pypic_tpu_torch.tools import magnetized as row

    res, cfg, fin, m = row.run_row("cpu", steps=4, n_per_species=300,
                                   warmup=1, newton_backend="pallas",
                                   **row.CARRIED)
    assert cfg.carried_deposit == "on" and cfg.react_batch == 16384
    assert res["launches"] == {} and res["steps"] == 4
    assert set(res["carried"]) == {"carry_clamped", "n_ion_suppressed",
                                   "n_escape_deferred"}
    assert res["carried"]["n_ion_suppressed"] == 0
    assert not row.population_problems(m)
    # at carried_pad 2 this row's ions move up to a few cells a step, so
    # some tents clamp (counted); clamped tents stay in the grid
    fresh = magnetized.prime_carry(fin, cfg)
    np.testing.assert_allclose(float(fin.n.double().sum()),
                               float(fresh.n.double().sum()), rtol=1e-6)


# ---------------------------------------------------------------------------
# the carried carrier (domain explicit, carried_rho='on')
# ---------------------------------------------------------------------------

N, NG, STEPS, HALO = 16_000, 64, 10, 12
TOL_P_CELLS, TOL_REL, TOL_RHO = 2e-5, 1e-5, 2e-5
TOL_FE, TOL_KE = 2e-4, 1e-5  # tests/test_domain.py:199-204
_KEYS = ("p", "v", "alive", "q", "m", "step", "rho")


@pytest.fixture(scope="module")
def problem():
    density = 1e10
    te = 0.1 * 11600.0
    debye = np.sqrt(K_BOLTZMANN * te * EPSILON_0 / E_CHARGE**2 / density)
    grid = JGridSpec(NG, 15.0 * debye, "periodic")
    x, v, params = jinit.initialize_periodic(
        "two-stream", N, density, 1, 0.05, grid, te, te, seed=2)
    return grid, x, v, params


@pytest.fixture(scope="module", params=[1, 2])
def carrier(request, problem, tmp_path_factory):
    """tests/test_domain.py's carried_rho='on' case (halo 12) on s
    devices in JAX, 10 steps, and the port on s gloo ranks in one spawn:
    the same 10 steps from JAX's state, and prime_rho from it with the
    rho zeroed."""
    s = request.param
    grid, x, v, params = problem
    dt = 0.1 / params.wp
    cfg_kw = dict(dt=dt, p2c=params.p2c, num_shards=s, migrate_cap=4096,
                  carried_rho="on", halo=HALO)
    cfg = jdomain.DomainConfig(grid, **cfg_kw)
    mesh = make_mesh(s, axis="slabs")
    st = jdomain.shard_state(
        jdomain.init_state(x, v, -E_CHARGE, M_ELECTRON, cfg), mesh, cfg)
    state0 = {k: np.asarray(getattr(st, k)) for k in _KEYS}
    step = jdomain.make_step(cfg, mesh)
    rows, after1 = {}, None
    for i in range(STEPS):
        st, m = step(st)
        for k, val in m._asdict().items():
            rows.setdefault(k, []).append(np.asarray(val).item())
        if i == 0:
            after1 = {k: np.asarray(getattr(st, k)) for k in _KEYS}
    g = (grid.ng, grid.length, grid.bc)
    jobs = [("steps", dict(engine="explicit", state=state0, grid=g,
                           cfg=cfg_kw, n_steps=STEPS)),
            ("prime", dict(state=state0, grid=g, cfg=cfg_kw))]
    got = spawn.run(s, _torch_ranks.batch, jobs, device="cpu",
                    tmp_dir=tmp_path_factory.mktemp(f"carried{s}"))
    for rank in got[1:]:  # every rank reports the same summed metrics
        assert rank[0][0] == got[0][0][0]
    kept = [rank[0][1][1] for rank in got]
    port1 = {k: (kept[0][k] if np.ndim(kept[0][k]) == 0
                 else np.concatenate([kr[k] for kr in kept])) for k in kept[0]}
    primed = np.concatenate([rank[1] for rank in got])
    return s, state0, dict(rows=rows, after1=after1), dict(
        rows=got[0][0][0], after1=port1, primed=primed)


def test_carried_carrier_one_step_matches_jax(carrier):
    """One step: the alive slots equal, positions within 2e-5 cells (the
    short way round the seam), velocities 1e-5 of the largest, the rho
    carried into the next step within 2e-5 of its largest node (float32
    sums in other orders), no clamp."""
    _, _, ref, got = carrier
    a, b = ref["after1"], got["after1"]
    np.testing.assert_array_equal(b["alive"], a["alive"])
    alive = a["alive"]
    dp = np.abs(b["p"][alive].astype(np.float64) - a["p"][alive])
    assert np.minimum(dp, NG - dp).max() <= TOL_P_CELLS
    _close(a["v"][alive], b["v"][alive], TOL_REL)
    _close(a["rho"], b["rho"], TOL_RHO)
    assert int(b["step"]) == 1
    assert got["rows"]["n_halo_clamped"][0] == ref["rows"]["n_halo_clamped"][0] == 0


def test_carried_carrier_ten_steps_match_jax(carrier):
    """Ten steps: field energy rtol 2e-4 and kinetic energy rtol 1e-5
    (tests/test_domain.py:199-204), the alive, migrated, dropped and
    clamped counts equal step by step: nothing dropped, no clamp, all
    16,000 alive."""
    s, _, ref, got = carrier
    np.testing.assert_allclose(got["rows"]["field_energy"],
                               ref["rows"]["field_energy"], rtol=TOL_FE)
    np.testing.assert_allclose(got["rows"]["kinetic_energy"],
                               ref["rows"]["kinetic_energy"], rtol=TOL_KE)
    for k in ("n_alive", "n_migrated", "n_dropped", "n_halo_clamped"):
        assert got["rows"][k] == ref["rows"][k], k
    assert set(got["rows"]["n_alive"]) == {N}
    assert sum(got["rows"]["n_dropped"]) == sum(got["rows"]["n_halo_clamped"]) == 0
    if s > 1:
        assert sum(got["rows"]["n_migrated"]) > 0


def test_prime_rho_matches_the_init_prime(carrier):
    """prime_rho from the state with its rho zeroed gives back JAX's init
    prime (a float64 host deposit rounded to float32) within 1e-5 of its
    largest node (the port deposits in float32)."""
    _, state0, _, got = carrier
    _close(state0["rho"], got["primed"], 1e-5)
