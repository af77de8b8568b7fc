"""The guiding-center pusher of pypic_tpu_torch against pypic_tpu: the
6D <-> GC transforms, the RK4 push and the magnetized engine's
``pusher='gc'`` (the ``pic_iead_gc`` preset, BASELINE configs[3]'s
"guiding-center magnetized PIC").

The same numpy inputs go through both packages. The JAX engine's source
and gyro-phase draws (jax.random) are replayed in the port through
``make_step(source_draws=..., gyro_draws=...)``. Each tolerance is stated
beside its test; the engine tests port tests/test_magnetized.py:737-904.
"""

import dataclasses as dc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pypic_tpu import presets as jpresets
from pypic_tpu import sources as jsources
from pypic_tpu.constants import E_CHARGE, EPSILON_0, EV_TO_K, K_BOLTZMANN, M_PROTON
from pypic_tpu.engines import magnetized as jmag
from pypic_tpu.push import guiding_center as jgc

from pypic_tpu_torch import interop, presets
from pypic_tpu_torch.engines import magnetized
from pypic_tpu_torch.grid import GridSpec
from pypic_tpu_torch.ops import cuda_cic, cuda_rng
from pypic_tpu_torch.ops.cic import gather
from pypic_tpu_torch.ops.fd import grad_neg_bounded
from pypic_tpu_torch.push import from_guiding_center, gc_push_rk4, to_guiding_center
from pypic_tpu_torch.runner import run


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(ref, got, rel):
    """|got - ref| <= rel * max|ref|."""
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rel * max(np.abs(ref).max(), 1e-300))


# ---------------------------------------------------------------------------
# transforms and the RK4 push
# ---------------------------------------------------------------------------

B = np.asarray([0.1395, 1.995, 0.3], np.float32)


def _particles(n=5000, seed=0):
    rng = np.random.default_rng(seed)
    pos = rng.normal(0, 1e-3, (n, 3)).astype(np.float32)
    v = rng.normal(0, 3e4, (n, 3)).astype(np.float32)
    cs = (rng.integers(1, 4, n) * rng.choice([-1, 1], n)).astype(np.float32)
    m = np.full(n, 2.0 * M_PROTON, np.float32)
    return pos, v, cs, m


@pytest.mark.parametrize("perp_floor", [0.0, 1e-30])
def test_to_guiding_center_matches_jax(perp_floor):
    """X, v_par and mu in float32, the same operations (the 3-term dot and
    cross products written out): 1e-6 of the largest magnitude."""
    pos, v, cs, m = _particles()
    ref = jgc.to_guiding_center(*(jnp.asarray(a) for a in (pos, v, B, cs, m)),
                                perp_floor=perp_floor)
    got = to_guiding_center(_t(pos), _t(v), B, _t(cs), _t(m),
                            perp_floor=perp_floor)
    for r, g in zip(ref, got):
        assert g.dtype == torch.float32
        _close(r, g, 1e-6)


def test_from_guiding_center_matches_jax():
    """The same gyro-phase uniforms (JAX's jax.random.uniform(key, (n, 3))
    passed in): positions and velocities within 1e-5 of the largest (the
    normalization of a uniform 3-vector's perpendicular part)."""
    pos, v, cs, m = _particles(seed=1)
    key = jax.random.PRNGKey(3)
    a = jax.random.uniform(key, (pos.shape[0], 3), dtype=jnp.float32)
    mu = np.abs(v[:, 1]) * np.float32(1e-21)
    ref = jgc.from_guiding_center(key, *(jnp.asarray(x) for x in (pos, v[:, 0], mu, B, cs, m)))
    got = from_guiding_center(_t(a), _t(pos), _t(v[:, 0]), _t(mu), B, _t(cs), _t(m))
    for r, g in zip(ref, got):
        _close(r, g, 1e-5)


def test_gc_round_trip_keeps_vpar_mu_and_speed():
    """6D -> GC -> 6D with any gyro-phase keeps v_par, mu and |v|
    (pygcpic.py:516-528's doctest invariants): 1e-5 relative."""
    pos, v, cs, m = _particles(seed=2)
    x_gc, vpar, mu = to_guiding_center(_t(pos), _t(v), B, _t(cs), _t(m))
    a = torch.rand((pos.shape[0], 3), generator=torch.Generator().manual_seed(0))
    _, v6 = from_guiding_center(a, x_gc, vpar, mu, B, _t(cs), _t(m))
    _, vpar2, mu2 = to_guiding_center(x_gc, v6, B, _t(cs), _t(m))
    _close(vpar, vpar2, 1e-5)
    _close(mu, mu2, 1e-5)
    _close(np.linalg.norm(v, axis=1), torch.linalg.vector_norm(v6, dim=1), 1e-5)


@pytest.mark.parametrize("eom_form", ["reference", "physical"])
def test_gc_push_rk4_matches_jax(eom_form):
    """The RK4 guiding-center push, both parallel-force forms: 1e-6 of the
    largest magnitude; mu carried through unchanged."""
    pos, v, cs, m = _particles(seed=3)
    e3 = np.random.default_rng(4).normal(0, 1e5, (pos.shape[0], 3)).astype(np.float32)
    vpar, mu = v[:, 0], np.abs(v[:, 1])
    ref = jgc.gc_push_rk4(*(jnp.asarray(x) for x in (pos, vpar, mu, e3, B, cs, m)),
                          1e-10, eom_form=eom_form)
    got = gc_push_rk4(_t(pos), _t(vpar), _t(mu), _t(e3), B, _t(cs), _t(m), 1e-10,
                      eom_form=eom_form)
    for r, g in zip(ref, got):
        _close(r, g, 1e-6)
    assert torch.equal(got[2], _t(mu))
    with pytest.raises(ValueError, match="eom_form"):
        gc_push_rk4(_t(pos), _t(vpar), _t(mu), _t(e3), B, _t(cs), _t(m), 1e-10,
                    eom_form="bogus")


def test_gyro_draws_use_their_own_counters():
    """The gyro-phase uniforms are philox4x32_plain's words at counters
    (slot, step, 0, GYRO_TAG), apart from the source batch's (slot, step,
    0, 0) and the flux draw's; uniform in [0, 1)."""
    key, step, n = (1, 2), 3, 10_000
    u = cuda_rng.philox_uniforms(key, step, n, 3, cuda_rng.GYRO_TAG, device="cpu")
    idx = torch.arange(n, dtype=torch.int64)
    words = cuda_rng.philox4x32_plain(key, (idx, step, 0, cuda_rng.GYRO_TAG))
    assert torch.equal(u, cuda_rng.uniforms_from_bits(torch.stack(words[:3])))
    assert not torch.equal(u, cuda_rng.source_uniforms(key, step, n, device="cpu")[:3])
    assert not torch.equal(u, cuda_rng.philox_uniforms(key, step, n, 3,
                                                       cuda_rng.FLUX_TAG,
                                                       device="cpu"))
    assert (u > 0).all() and (u < 1).all() and abs(float(u.mean()) - 0.5) < 0.01


# ---------------------------------------------------------------------------
# the engine (tests/test_magnetized.py:718-904 on the port)
# ---------------------------------------------------------------------------


def _gc_engine_setup(n=2000, ng=64, bz=2.0, seed=0, **cfg_kw):
    """tests/test_magnetized.py:718-734's setup on the port: an interior
    band of protons, B along z."""
    density = 1e19
    te = ti = 10.0 * EV_TO_K
    debye = np.sqrt(K_BOLTZMANN * te * EPSILON_0 / E_CHARGE**2 / density)
    grid = GridSpec(ng, 100.0 * debye, "dirichlet-dirichlet")
    p2c = density * grid.length / n
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.3, 0.7, n) * grid.length
    vth = np.sqrt(K_BOLTZMANN * ti / M_PROTON)
    v = rng.normal(0, vth, (n, 3))
    cfg = magnetized.MagnetizedConfig(grid, 1e-10, te, b=(0.0, 0.0, bz),
                                      species_z=(1,), pusher="gc", **cfg_kw)
    st = magnetized.init_state(x, v, M_PROTON, 1.0, p2c, 0, cfg, seed=seed,
                               device="cpu")
    return cfg, st, v


def test_gc_engine_mode_packing_at_init():
    """Charged active particles carry [v_par, mu, 0] in mode 1, and the
    packing keeps each particle's kinetic energy: m v_par^2 / 2 + mu |B| =
    m |v|^2 / 2 within 1e-5 (float32 transforms)."""
    cfg, st, v6 = _gc_engine_setup(n=500)
    assert bool((st.mode == 1).all())
    assert bool((st.vy >= 0).all()) and bool((st.vz == 0).all())
    ke_gc = 0.5 * M_PROTON * st.vx.double() ** 2 + st.vy.double() * 2.0
    ke_6d = 0.5 * M_PROTON * (torch.from_numpy(v6.astype(np.float32)).double() ** 2).sum(1)
    _close(ke_6d, ke_gc, 1e-5)


def test_gc_engine_exb_drift_and_frozen_x():
    """B = (0, 0, Bz): guiding centers never move in x (bit-equal), y
    drifts at -E_x / Bz dt (rtol 1e-3, RK4 exact for a constant drift;
    atol 1e-11 m, the float32 ulp of y at the Larmor offsets ~1e-4 m that
    the difference of two y's cannot resolve), mu is carried bit-exactly
    (the continuous CIC gather, as the JAX test)."""
    cfg, st, _ = _gc_engine_setup(n=2000, bz=2.0, gather_weights="cic")
    st1, m = magnetized.make_step(cfg)(st)
    assert torch.equal(st1.p, st.p)
    e_p = gather(grad_neg_bounded(m.phi, cfg.grid.dx), st.p, periodic=False)
    np.testing.assert_allclose((st1.y - st.y).numpy(),
                               (-e_p / 2.0 * cfg.dt).numpy(), rtol=1e-3,
                               atol=1e-11)
    assert torch.equal(st1.vy, st.vy)


def test_gc_engine_parallel_acceleration_oblique_b():
    """Oblique B (86 degrees): v_par grows by (q/m) E_x bhat_x dt (the
    'physical' gc_eom) within 5% where the kick is above a tenth of its
    largest (E changes between RK4 stages as X moves along b)."""
    alpha = 86.0 * np.pi / 180.0
    b = (2.0 * np.cos(alpha), 2.0 * np.sin(alpha), 0.0)
    density = 1e19
    te = 10.0 * EV_TO_K
    debye = np.sqrt(K_BOLTZMANN * te * EPSILON_0 / E_CHARGE**2 / density)
    grid = GridSpec(64, 100.0 * debye, "dirichlet-dirichlet")
    n = 1000
    rng = np.random.default_rng(1)
    x = rng.uniform(0.3, 0.7, n) * grid.length
    v = rng.normal(0, np.sqrt(K_BOLTZMANN * te / M_PROTON), (n, 3))
    cfg = magnetized.MagnetizedConfig(grid, 1e-10, te, b=b, species_z=(1,),
                                      pusher="gc", gather_weights="cic")
    st = magnetized.init_state(x, v, M_PROTON, 1.0, density * grid.length / n,
                               0, cfg, seed=1, device="cpu")
    st1, m = magnetized.make_step(cfg)(st)
    e_p = gather(grad_neg_bounded(m.phi, cfg.grid.dx), st.p, periodic=False).numpy()
    expect = (E_CHARGE / M_PROTON) * e_p * (b[0] / 2.0) * cfg.dt
    dvpar = (st1.vx - st.vx).numpy()
    mask = np.abs(expect) > np.abs(expect).max() * 0.1
    np.testing.assert_allclose(dvpar[mask], expect[mask], rtol=0.05)


def test_gc_engine_wall_iead_uses_reconstructed_6d():
    """A guiding center planted outside the left wall records its impact
    at the energy of m v_par^2 / 2 + mu |B| (~53 eV; the 6D velocity
    rebuilt with a gyro-phase): the IEAD row within two bins of it."""
    cfg, st, _ = _gc_engine_setup(n=200, bz=2.0, iead_energy_max=200.0)
    p, vx, vy, vz = (t.clone() for t in (st.p, st.vx, st.vy, st.vz))
    p[0], vx[0], vy[0], vz[0] = -0.5, 1e5, 1e-19, 0.0
    st = st.replace(p=p, vx=vx, vy=vy, vz=vz)
    st1, m = magnetized.make_step(cfg)(st)
    assert int(m.n_hit_wall) >= 1 and float(st1.iead.sum()) >= 1.0
    e_ev = (0.5 * M_PROTON * 1e10 + 1e-19 * 2.0) / E_CHARGE
    ne_bins, _ = cfg.iead_bins
    bin_idx = int(e_ev * ne_bins / cfg.iead_energy_max)
    hist_e = st1.iead[0].sum(dim=1).numpy()
    lo, hi = max(0, bin_idx - 2), min(ne_bins, bin_idx + 3)
    assert hist_e[lo:hi].sum() >= 1.0


def test_gc_engine_neutral_stays_6d_and_reactivation_enters_gc():
    """An active neutral (mode 0) moves ballistically in 6D; a deactivated
    slot re-enters from the source as a guiding center (mode 1, mu >= 0)."""
    cfg, st, _ = _gc_engine_setup(n=200, bz=2.0)
    src = magnetized.SourceSpec(mass=M_PROTON, charge_state=1.0,
                                p2c=float(st.p2c[0]), species_idx=0,
                                ti=10.0 * EV_TO_K)
    cfg = dc.replace(cfg, reactivate="source", source=src)
    p, vx, vy, vz, cs, mode, act = (t.clone() for t in (
        st.p, st.vx, st.vy, st.vz, st.charge_state, st.mode, st.active))
    p[0], vx[0], vy[0], vz[0], cs[0], mode[0] = (
        float(cfg.grid.num_cells) / 2.0, 1e4, 0.0, 0.0, 0.0, 0)
    act[1] = 0
    st = st.replace(p=p, vx=vx, vy=vy, vz=vz, charge_state=cs, mode=mode,
                    active=act)
    st1, m = magnetized.make_step(cfg)(st)
    assert int(st1.mode[0]) == 0
    np.testing.assert_allclose(float(st1.p[0] - st.p[0]),
                               1e4 * cfg.dt / cfg.grid.dx, rtol=1e-4)
    assert int(m.n_reactivated) >= 1
    assert int(st1.mode[1]) == 1 and int(st1.active[1]) == 1
    assert float(st1.vy[1]) >= 0.0


@pytest.fixture(scope="module")
def gc_pair():
    """pic_iead_gc(n_per_species=300, ng=128) in both packages, and the
    JAX states after 0 and 10 steps."""
    jpre = jpresets.pic_iead_gc(n_per_species=300, ng=128)
    tpre = presets.pic_iead_gc(n_per_species=300, ng=128, device="cpu")
    step = jax.jit(jmag.make_step(jpre.config))
    states, st = {}, jpre.state
    for i in range(11):
        if i in (0, 10):
            states[i] = st
        st, _ = step(st)
    return jpre, tpre, states


def test_pic_iead_gc_preset_state_and_interop_round_trip(gc_pair):
    """The same numpy draws through init_state's GC packing: the initial
    states equal JAX's (mode, [v_par, mu, 0] in v, the guiding centers in
    p, y, z) within 1e-6 of each field's largest (float32 rounding of the
    transform), the other fields exactly; a JAX state carried across
    packages comes back bit-exact."""
    jpre, tpre, states = gc_pair
    assert tpre.config.pusher == "gc" and tpre.name == "pic_iead_gc"
    got = interop.magnetized_state_to_numpy(tpre.state)
    for k in interop._MAGNETIZED_FIELDS:
        ref = np.asarray(getattr(jpre.state, k))
        assert got[k].dtype == ref.dtype, k
        if ref.dtype.kind == "f" and k in ("p", "y", "z", "vx", "vy", "vz"):
            _close(ref, got[k], 1e-6)
        else:
            np.testing.assert_array_equal(got[k], ref, err_msg=k)
    d = {k: np.asarray(getattr(states[10], k))
         for k in interop._MAGNETIZED_FIELDS + ("rng",)}
    back = interop.magnetized_state_to_numpy(
        interop.magnetized_state_from_numpy(d, "cpu"))
    for k in d:
        assert back[k].dtype == d[k].dtype, k
        np.testing.assert_array_equal(back[k], d[k], err_msg=k)
    assert (d["mode"] == 1).any()


def _replay(jstate, jcfg):
    """The JAX step's own source batch (threefry) and gyro-phases
    (magnetized.py:793, 987) as the port's hooks."""
    _, _, k_src, k_gyro = jax.random.split(jstate.rng, 4)
    src = jcfg.source
    n = jstate.p.shape[0]
    batch = jsources.sample_source_6d(k_src, n, jcfg.grid, src.ti, src.mass,
                                      vx=src.vx, components=True)
    draws = {k: _t(v) for k, v in batch.items()}
    gyro = _t(jax.random.uniform(k_gyro, (n, 3), dtype=jnp.float32))
    return dict(source_draws=lambda step, k: draws,
                gyro_draws=lambda step, k: gyro)


def _tcfg_of(jcfg, **kw):
    return dc.replace(magnetized.MagnetizedConfig(**{
        f.name: getattr(jcfg, f.name) for f in dc.fields(jcfg)
        if f.name not in ("grid", "source")},
        grid=GridSpec(jcfg.grid.ng, jcfg.grid.length, jcfg.grid.bc),
        source=magnetized.SourceSpec(**dc.asdict(jcfg.source))), **kw)


@pytest.mark.parametrize("at", [0, 10])
@pytest.mark.parametrize("newton", ["xla", "pallas"])
def test_gc_engine_step_matches_jax(gc_pair, newton, at):
    """One pic_iead_gc step from JAX's state after ``at`` steps, the same
    Newton route on each side, the JAX source and gyro-phase draws
    replayed: rho rtol 1e-4, phi rtol 1e-3 (atol 1e-8), active guiding
    centers within 2e-5 (atol 1e-5 cells), v_par within 2e-4 (atol 1),
    mu within 1e-5 of the largest, equal counts and IEAD."""
    jpre, _, states = gc_pair
    jcfg = dc.replace(jpre.config, newton_backend=newton)
    jst = states[at]
    js, jm = jmag.make_step(jcfg)(jst)
    d = {k: np.asarray(getattr(jst, k)) for k in interop._MAGNETIZED_FIELDS + ("rng",)}
    ts, tm = magnetized.make_step(_tcfg_of(jcfg), **_replay(jst, jcfg))(
        interop.magnetized_state_from_numpy(d, "cpu"))
    np.testing.assert_allclose(tm.rho.numpy(), np.asarray(jm.rho), rtol=1e-4)
    np.testing.assert_allclose(tm.phi.numpy(), np.asarray(jm.phi), rtol=1e-3,
                               atol=1e-8)
    act = np.asarray(js.active) == 1
    np.testing.assert_array_equal(ts.active.numpy(), np.asarray(js.active))
    np.testing.assert_array_equal(ts.mode.numpy(), np.asarray(js.mode))
    np.testing.assert_allclose(ts.p.numpy()[act], np.asarray(js.p)[act],
                               rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(ts.vx.numpy()[act], np.asarray(js.vx)[act],
                               rtol=2e-4, atol=1.0)
    _close(np.asarray(js.vy)[act], ts.vy.numpy()[act], 1e-5)
    for k in ("n_hit_wall", "n_reactivated", "newton_iters"):
        assert int(getattr(tm, k)) == int(getattr(jm, k)), k
    np.testing.assert_array_equal(ts.iead.numpy(), np.asarray(js.iead))


def test_pic_iead_gc_preset_produces_ieads():
    """tests/test_magnetized.py:890-904 on the port's own draws: 150 steps
    of pic_iead_gc(n_per_species=300, ng=128): finite phi, a non-empty
    IEAD, mu >= 0 on the surviving guiding centers, the population kept
    (tools/magnetized.check_gc_row)."""
    from pypic_tpu_torch.tools import magnetized as row

    pre = presets.get("pic_iead_gc", n_per_species=300, ng=128, device="cpu")
    assert bool((pre.state.mode == 1).all())
    cfg = dc.replace(pre.config, newton_backend="pallas")
    fin, m = run(magnetized.make_step(cfg), pre.state, 150)
    assert row.check_gc_row(cfg, fin, m) == []


def test_gc_row_tool_runs_on_the_cpu():
    """tools/magnetized.run_row(row='gc') drives the GC row's path (the
    composed backend's plain versions at a small n); no kernel launches on
    the CPU; its population check holds."""
    from pypic_tpu_torch.tools import magnetized as row

    before = dict(cuda_cic.LAUNCHES)
    res, cfg, fin, m = row.run_row("cpu", steps=6, n_per_species=300,
                                   warmup=1, row="gc", newton_backend="pallas")
    assert res["n"] == 1800 and res["row"] == "gc" and res["launches"] == {}
    assert cfg.pusher == "gc" and fin.step_host == 6
    assert row.population_problems(m) == []
    assert cuda_cic.LAUNCHES == {k: 0 for k in before}
