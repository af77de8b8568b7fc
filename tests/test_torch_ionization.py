"""The pic_bca_aps step of pypic_tpu_torch against pypic_tpu: MCC
ionization, 'capped-source' re-activation, the wall-impact rows, the BCA
escape and their carried forms.

The same numpy inputs go through the JAX function and the port's
counterpart (its plain kernel versions: the tensors lie on the CPU). The
engine steps run from one JAX state in both packages with the JAX draws
replayed in the port: the source table through
``make_step(source_draws=...)``, the ionization uniforms through
``ion_draws`` and the gyro-phases through ``gyro_draws`` (jax.random
streams cannot be reproduced in PyTorch). A uniform within a few float32
ulps of its probability may decide differently when the gathered density
differs in its last bits; such rows are counted and reported, and left
out of the equality of the charge states. Each tolerance is stated
beside its test.
"""

import dataclasses as dc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pypic_tpu import presets as jpresets
from pypic_tpu import sources as jsources
from pypic_tpu.constants import EV_TO_K, M_PROTON
from pypic_tpu.engines import magnetized as jmag
from pypic_tpu.ops import ionization as jion

from pypic_tpu_torch import interop, presets
from pypic_tpu_torch.engines import magnetized
from pypic_tpu_torch.grid import GridSpec
from pypic_tpu_torch.ops import cuda_rng, ionization

B_AMU = 10.81


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# the rate tables and the attempt
# ---------------------------------------------------------------------------


def test_rate_tables_match_jax():
    """The published tables and the host interpolation: exactly equal."""
    assert ionization._TABLES == jion._TABLES
    assert ionization.MAX_CS == jion.MAX_CS
    for te_ev in (0.5, 3.0, 10.0, 50.0, 1e3, 1e5):
        te = te_ev * EV_TO_K
        for z, cs in ((1, 0), (1, 1), (5, 0), (5, 1), (5, 2), (5, 3), (7, 0)):
            assert (ionization.rate_coefficient(z, cs, te)
                    == jion.rate_coefficient(z, cs, te))
        np.testing.assert_array_equal(ionization.rate_matrix((1, 5), te),
                                      jion.rate_matrix((1, 5), te))


def _attempt_inputs(n, seed):
    """Densities 1e17-1e20 m^-3, charge states 0-3, H and B rows, a
    p2c that keeps the probabilities mostly below 1, a tenth inactive."""
    rng = np.random.default_rng(seed)
    n_local = (10.0 ** rng.uniform(17, 20, n)).astype(np.float32)
    cs = rng.integers(0, 4, n).astype(np.float32)
    sp = rng.integers(0, 2, n).astype(np.int32)
    p2c = (10.0 ** rng.uniform(9, 12, n)).astype(np.float32)
    active = rng.random(n) < 0.9
    return n_local, cs, sp, p2c, active


def _straddling(draw, prob, ulps=4):
    """Rows whose uniform lies within ``ulps`` float32 spacings of its
    probability."""
    prob = np.asarray(prob, np.float32)
    return np.abs(np.asarray(draw, np.float64) - prob) <= ulps * np.spacing(prob)


@pytest.mark.parametrize("max_cs", [3, 1])
def test_attempt_ionization_matches_jax(max_cs):
    """n = 20,000 rows, the same uniforms (JAX's jax.random.uniform of
    the key): new_cs and ionized equal, added within 1e-6 relative (one
    float32 sum in two orders). The probabilities are the same float32
    operations on the same inputs, so no draw straddles; the count is
    asserted."""
    n = 20_000
    te, dx, dt = 50.0 * EV_TO_K, 5.5e-6, 8e-11
    n_local, cs, sp, p2c, active = _attempt_inputs(n, 7 + max_cs)
    rates = jion.rate_matrix((1, 5), te)
    key = jax.random.PRNGKey(5)
    ref = jion.attempt_ionization(key, jnp.asarray(n_local), jnp.asarray(cs),
                                  jnp.asarray(sp), jnp.asarray(p2c), rates,
                                  dx, dt, jnp.asarray(active),
                                  max_charge_state=max_cs)
    draw = _t(jax.random.uniform(key, (n,)))
    table = ionization.coefficient_table(ionization.rate_matrix((1, 5), te), dx, dt,
                                         torch.float32, "cpu")
    got = ionization.attempt_ionization(
        _t(n_local), _t(cs), _t(sp), _t(p2c), table, _t(active), draw,
        max_charge_state=max_cs)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    assert 100 < int(got[1].sum()) < n // 2
    np.testing.assert_allclose(float(got[2]), float(ref[2]), rtol=1e-6)
    coef = table[_t(sp).long(), torch.clamp(_t(cs).int(), 0, 2).long()]
    prob = (_t(n_local) * 1e-10) ** 2 * coef / _t(p2c)
    assert int(_straddling(draw, prob).sum()) == 0
    if max_cs == 1:
        assert not bool(got[1][_t(cs) >= 1].any())


def test_ionization_statistics_with_philox_draws():
    """tests/test_magnetized.py:132-156 on the port's own ION_TAG draws:
    the ionized fraction within 5 sigma of the analytic probability at a
    density of 1e20 (n^2 overflows float32 without the rescale), the
    ledger 2 p2c a row, charge state 1 at most."""
    n, density, dx, dt, p2c = 200_000, 1e20, 2e-6, 1e-10, 1e12
    rates = ionization.rate_matrix((1,), 10.0 * EV_TO_K)
    prob = density**2 * rates[0, 0] * dx * dt / p2c
    assert 0.001 < prob < 0.5
    draw = cuda_rng.philox_uniforms((0, 11), 3, n, 1, cuda_rng.ION_TAG,
                                    device="cpu")[0]
    new_cs, ionized, added = ionization.attempt_ionization(
        torch.full((n,), density, dtype=torch.float32),
        torch.zeros(n), torch.zeros(n, dtype=torch.int32),
        torch.full((n,), p2c, dtype=torch.float32),
        ionization.coefficient_table(rates, dx, dt, torch.float32, "cpu"),
        torch.ones(n, dtype=torch.bool), draw)
    frac = float(ionized.double().mean())
    assert abs(frac - prob) < 5 * np.sqrt(prob / n) + 1e-4
    np.testing.assert_allclose(float(added), 2.0 * p2c * int(ionized.sum()),
                               rtol=1e-6)
    assert float(new_cs.max()) == 1.0


def test_ion_draws_use_their_own_counter():
    """The ionization uniforms are Philox words at counter (row, step, 0,
    ION_TAG): apart from the flux, gyro-phase and source draws."""
    key, step, n = (3, 9), 4, 64
    u = cuda_rng.philox_uniforms(key, step, n, 1, cuda_rng.ION_TAG, device="cpu")
    words = cuda_rng.philox4x32_plain(key, (torch.arange(n), step, 0, 3))
    assert torch.equal(u[0], cuda_rng.uniforms_from_bits(words[0]))
    assert len({cuda_rng.FLUX_TAG, cuda_rng.GYRO_TAG, cuda_rng.ION_TAG, 0}) == 4
    for tag in (cuda_rng.FLUX_TAG, cuda_rng.GYRO_TAG):
        other = cuda_rng.philox_uniforms(key, step, n, 1, tag, device="cpu")
        assert not torch.equal(u, other)


# ---------------------------------------------------------------------------
# one engine step against JAX
# ---------------------------------------------------------------------------


def _tcfg_of(jcfg):
    return magnetized.MagnetizedConfig(**{
        f.name: getattr(jcfg, f.name) for f in dc.fields(jcfg)
        if f.name not in ("grid", "source")},
        grid=GridSpec(jcfg.grid.ng, jcfg.grid.length, jcfg.grid.bc),
        source=magnetized.SourceSpec(**dc.asdict(jcfg.source)))


def _hooks(jstate, jcfg):
    """The JAX step's own draws (magnetized.py:793: the split of the
    state's key) as the port's hooks: the threefry source table, the
    ionization uniforms and the gyro-phases."""
    _, k_ion, k_src, k_gyro = jax.random.split(jstate.rng, 4)
    n = jstate.p.shape[0]
    src = jcfg.source
    n_draw = jcfg.react_batch or n
    batch = jsources.sample_source_6d(k_src, n_draw, jcfg.grid, src.ti,
                                      src.mass, vx=src.vx, components=True)
    draws = {k: _t(v) for k, v in batch.items()}
    ion = _t(jax.random.uniform(k_ion, (n,)))
    gyro = _t(jax.random.uniform(k_gyro, (n, 3), dtype=jnp.float32))
    return dict(source_draws=lambda step, k: draws,
                ion_draws=lambda step, k: ion,
                gyro_draws=lambda step, k: gyro), ion


def _port_state(jstate):
    d = {k: np.asarray(getattr(jstate, k))
         for k in interop._MAGNETIZED_FIELDS + ("rng",)}
    return interop.magnetized_state_from_numpy(d, "cpu")


def _step_pair(jcfg, jstate):
    js, jm = jax.jit(jmag.make_step(jcfg))(jstate)
    hooks, ion = _hooks(jstate, jcfg)
    ts, tm = magnetized.make_step(_tcfg_of(jcfg), **hooks)(_port_state(jstate))
    return js, jm, ts, tm, ion


def _assert_step_close(js, jm, ts, tm, *, counts=("n_hit_wall", "n_ionized",
                                                   "n_reactivated",
                                                   "n_impacts", "n_escaped",
                                                   "n_escape_rows")):
    """tests/test_magnetized.py:461-489's single-step limits: rho rtol
    1e-4, phi rtol 1e-3 (atol 1e-8), active positions rtol 2e-5 (atol
    1e-5), velocities rtol 2e-4 (atol 1), n0 rtol 1e-5; the active mask,
    species, from_wall, mode and the histograms equal; the counts
    equal."""
    np.testing.assert_allclose(tm.rho.numpy(), np.asarray(jm.rho), rtol=1e-4)
    np.testing.assert_allclose(tm.phi.numpy(), np.asarray(jm.phi), rtol=1e-3,
                               atol=1e-8)
    for k in ("active", "species_idx", "from_wall", "mode", "at_wall"):
        np.testing.assert_array_equal(getattr(ts, k).numpy(),
                                      np.asarray(getattr(js, k)), err_msg=k)
    act = np.asarray(js.active) == 1
    np.testing.assert_allclose(ts.p.numpy()[act], np.asarray(js.p)[act],
                               rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(ts.v.numpy()[act], np.asarray(js.v)[act],
                               rtol=2e-4, atol=1.0)
    np.testing.assert_allclose(float(tm.n0), float(jm.n0), rtol=1e-5)
    np.testing.assert_allclose(float(tm.added), float(jm.added), rtol=1e-6)
    for k in ("iead", "iead_out"):
        np.testing.assert_array_equal(getattr(ts, k).numpy(),
                                      np.asarray(getattr(js, k)), err_msg=k)
    for k in counts:
        assert int(getattr(tm, k)) == int(getattr(jm, k)), k


def _assert_rows_close(jm, tm):
    """The impact and escape rows, in the same order: species, side and
    from_wall equal; energy rtol 5e-4 and angle atol 1e-3 deg (the
    velocities' 2e-4 squared, atan2 of two libraries), vx/vth rtol 2e-4
    (atol 1e-3), the lateral distance rtol 1e-5."""
    k = int(jm.n_impacts)
    ref, got = np.asarray(jm.impacts)[:k], tm.impacts.numpy()[:k]
    assert tm.impacts.shape == jm.impacts.shape
    np.testing.assert_array_equal(got[:, [2, 3, 6]], ref[:, [2, 3, 6]])
    np.testing.assert_allclose(got[:, 0], ref[:, 0], rtol=5e-4)
    np.testing.assert_allclose(got[:, 1], ref[:, 1], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got[:, 4], ref[:, 4], rtol=2e-4, atol=1e-3)
    np.testing.assert_allclose(got[:, 5], ref[:, 5], rtol=1e-5, atol=1e-12)
    assert not tm.impacts[k:].any()
    e = int(jm.n_escape_rows)
    ref_e, got_e = np.asarray(jm.escapes)[:e], tm.escapes.numpy()[:e]
    assert tm.escapes.shape == jm.escapes.shape
    np.testing.assert_array_equal(got_e[:, 1], ref_e[:, 1])
    np.testing.assert_allclose(got_e[:, 0], ref_e[:, 0], rtol=2e-4, atol=1e-3)
    np.testing.assert_allclose(got_e[:, 2], ref_e[:, 2], rtol=5e-4)
    np.testing.assert_allclose(got_e[:, 3], ref_e[:, 3], rtol=0, atol=1e-3)


def _straddlers(jcfg, jstate, js, ion):
    """Rows of a Boris step whose uniform lies within 4 float32 ulps of
    its probability, the density gathered at the new positions from a
    fresh deposit of the step's opening state."""
    from pypic_tpu.ops import deposit, gather

    dx, ng = jcfg.grid.dx, jcfg.grid.ng
    act = jstate.active == 1
    n_dens = deposit(jstate.p, jnp.where(act, jstate.p2c / dx, 0.0), ng,
                     periodic=False)
    n_local = np.asarray(gather(n_dens, js.p, periodic=False), np.float32)
    table = (jion.rate_matrix(jcfg.species_z, jcfg.te) * dx * jcfg.dt
             * 1e20).astype(np.float32)
    cs = np.clip(np.asarray(jstate.charge_state).astype(np.int32), 0, 2)
    coef = table[np.asarray(jstate.species_idx), cs]
    with np.errstate(over="ignore", divide="ignore"):  # free slots: p2c 0
        prob = ((n_local * np.float32(1e-10)) ** 2 * coef
                / np.maximum(np.asarray(jstate.p2c), np.float32(1e-30)))
    return _straddling(ion.numpy(), prob)


def _assert_charge_states(jcfg, jstate, js, ts, ion):
    """Charge states equal outside the rows whose uniform straddles its
    probability; returns the count of straddling rows (reported by the
    callers' assertions)."""
    straddle = _straddlers(jcfg, jstate, js, ion)
    differ = np.asarray(js.charge_state) != ts.charge_state.numpy()
    assert not (differ & ~straddle).any(), np.flatnonzero(differ & ~straddle)
    return int(straddle.sum())


@pytest.fixture(scope="module")
def bca_pair():
    """pic_bca_aps(ppc=10) (n = 6,000 in 9,000 slots) in both packages,
    the JAX state after 3 steps with wall-born rows planted: 24 neutral B
    rows (from_wall 1, charge 0) across the domain, 4 of them slow in the
    escape band length/2 +/- length/8 (pygcpic.py:1529-1541), and 4
    wall-born neutral H rows, at a thousandth of the plasma's p2c."""
    jpre = jpresets.pic_bca_aps(ppc=10)
    st = jpre.state
    step = jax.jit(jmag.make_step(jpre.config))
    for _ in range(3):
        st, _ = step(st)
    free = np.flatnonzero(np.asarray(st.active) != 1)[-28:]
    cells = jpre.config.grid.num_cells
    rng = np.random.default_rng(0)
    p = np.asarray(st.p).copy()
    v = [np.asarray(a).copy() for a in (st.vx, st.vy, st.vz)]
    arrs = {k: np.asarray(getattr(st, k)).copy() for k in (
        "m", "charge_state", "species_idx", "active", "from_wall", "p2c")}
    p[free] = rng.uniform(0.05, 0.95, 28).astype(np.float32) * cells
    p[free[:4]] = (cells / 2 + rng.uniform(-1, 1, 4) * cells / 16).astype(np.float32)
    for a in v:
        a[free] = rng.normal(0, 3e3, 28).astype(np.float32)
        a[free[:4]] = 1.0
    arrs["m"][free] = np.float32(B_AMU * M_PROTON)
    arrs["m"][free[-4:]] = np.float32(M_PROTON)
    arrs["charge_state"][free] = 0.0
    arrs["species_idx"][free] = 1
    arrs["species_idx"][free[-4:]] = 0
    arrs["active"][free] = 1
    arrs["from_wall"][free] = 1
    # a thousandth of the plasma's weight: a probability of 0.1-1 a step
    # for these neutrals (at the plasma's own weight it is ~1e-4)
    arrs["p2c"][free] = np.float32(arrs["p2c"][0] * 1e-3)
    st = st.replace(p=jnp.asarray(p), vx=jnp.asarray(v[0]),
                    vy=jnp.asarray(v[1]), vz=jnp.asarray(v[2]),
                    **{k: jnp.asarray(a) for k, a in arrs.items()})
    return jpre, st


def test_pic_bca_aps_preset_matches_jax():
    """The same numpy draws: the initial states are identical, the key is
    the JAX key data, and the config is the JAX one's."""
    jpre = jpresets.pic_bca_aps(ppc=4)
    tpre = presets.get("pic_bca_aps", ppc=4, device="cpu")
    got = interop.magnetized_state_to_numpy(tpre.state)
    for k in interop._MAGNETIZED_FIELDS:
        a = np.asarray(getattr(jpre.state, k))
        assert got[k].dtype == a.dtype, k
        np.testing.assert_array_equal(got[k], a, err_msg=k)
    np.testing.assert_array_equal(got["rng"], np.asarray(jpre.state.rng))
    assert _tcfg_of(jpre.config) == tpre.config
    assert tpre.meta == jpre.meta
    assert tpre.state.p.shape == (3600,)


@pytest.mark.parametrize("newton", ["xla", "pallas"])
def test_bca_step_matches_jax(bca_pair, newton):
    """One step of the preset (composed, ionization, escape, impact rows,
    'capped-source' by min-plus) from the planted state: every branch
    fires (impacts, escapes, ionizations, re-activations), and the step
    holds at the limits above with the rows' limits."""
    jpre, st = bca_pair
    jcfg = dc.replace(jpre.config, newton_backend=newton)
    js, jm, ts, tm, ion = _step_pair(jcfg, st)
    for k in ("n_impacts", "n_escaped", "n_ionized", "n_reactivated"):
        assert int(getattr(jm, k)) > 0, k
    _assert_step_close(js, jm, ts, tm)
    _assert_rows_close(jm, tm)
    assert _assert_charge_states(jcfg, st, js, ts, ion) == 0
    assert int(tm.newton_iters) == int(jm.newton_iters)


def test_bca_step_fused_matches_jax(bca_pair):
    """The fused path (deposit2, the Boris sweep, the gather of the
    ionization density) against JAX's fused path in interpret mode."""
    jpre, st = bca_pair
    jcfg = dc.replace(jpre.config, backend="fused", newton_backend="pallas")
    js, jm, ts, tm, ion = _step_pair(jcfg, st)
    assert int(jm.n_ionized) > 0 and int(jm.n_escaped) > 0
    _assert_step_close(js, jm, ts, tm)
    _assert_rows_close(jm, tm)
    assert _assert_charge_states(jcfg, st, js, ts, ion) == 0


def test_bca_step_gc_promotion_matches_jax(bca_pair):
    """pusher='gc': an ionized neutral is promoted to GC packing at its
    new position and velocity (mode 1, [v_par, mu, 0]); the gyro-phases
    replayed. Positions and v_par at the limits above, mu within 1e-5 of
    the largest."""
    jpre, st = bca_pair
    jcfg = dc.replace(jpre.config, pusher="gc", newton_backend="xla")
    js, jm, ts, tm, ion = _step_pair(jcfg, st)
    promoted = (np.asarray(st.mode) == 0) & (np.asarray(js.mode) == 1) \
        & (np.asarray(js.from_wall) == 1)
    assert promoted.sum() >= 5
    _assert_step_close(js, jm, ts, tm)
    assert _assert_charge_states(jcfg, st, js, ts, ion) == 0
    act = np.asarray(js.active) == 1
    vy, ref = ts.vy.numpy()[act], np.asarray(js.vy)[act]
    np.testing.assert_allclose(vy, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


def _capped_minplus_state(jpre, n_low=80, n_loss=20, slack=30):
    """The state where the min-plus admission differs from the prefix:
    ``n_low`` source slots freed at the bottom, ``n_loss`` ions near the
    top of the population leaving through the left wall this step, and
    source_n ``slack`` below n, so the deficit (n_low - slack + losses) is
    below the pending slots under the losses."""
    st = jpre.state
    n = jpre.meta["source_n"]
    active = np.asarray(st.active).copy()
    active[:n_low] = 0
    p = np.asarray(st.p).copy()
    vx = np.asarray(st.vx).copy()
    top = np.arange(n - n_loss, n)
    p[top] = 0.02
    vx[top] = -0.5 * jpre.config.grid.dx / jpre.config.dt
    st = st.replace(active=jnp.asarray(active), p=jnp.asarray(p),
                    vx=jnp.asarray(vx))
    cfg = dc.replace(jpre.config, source_n=n - slack)
    return cfg, st


def test_capped_source_min_plus_matches_jax():
    """'capped-source' at react_batch 0 with the reference timing, where
    same-step losses sit above pending slots: the JAX min-plus admission
    takes the first n_low - slack low slots and as many slots above the
    losses as there were losses; the port's exclusive cummin takes the
    same slots, and the rank < deficit prefix would not (checked). The
    count of lost_now is on the post-ionization charge state in both
    (ROADMAP queue 3's caveat: this pins the JAX engine's behaviour, not
    the reference's)."""
    jpre = jpresets.pic_bca_aps(ppc=4)
    jcfg, st = _capped_minplus_state(jpre)
    js, jm, ts, tm, _ = _step_pair(jcfg, st)
    _assert_step_close(js, jm, ts, tm)
    n = jpre.meta["source_n"]
    took = (np.asarray(st.active) != 1) & (np.asarray(js.active) == 1)
    losses = int(jm.n_hit_wall)
    assert losses >= 20
    assert took[:50].all() and not took[50:80].any()
    assert took[n:].sum() == losses == int(jm.n_reactivated) - 50
    # the prefix would have taken the lowest 50 + losses pending slots
    assert losses > 0 and not took[50:50 + losses].any()


def test_capped_source_prefix_matches_jax():
    """'capped-source' with react_batch 64 (the rank-keyed table) and
    with react_timing 'immediate': the rank < deficit prefix (capped at
    the table), not the min-plus admission; the port takes the JAX
    engine's slots. With the table, the taken slots are the first
    n_reactivated pending slots in slot order."""
    jpre = jpresets.pic_bca_aps(ppc=4)
    jcfg0, st = _capped_minplus_state(jpre)
    for kw in (dict(react_batch=64), dict(react_timing="immediate")):
        jcfg = dc.replace(jcfg0, **kw)
        js, jm, ts, tm, _ = _step_pair(jcfg, st)
        _assert_step_close(js, jm, ts, tm)
        took = (np.asarray(st.active) != 1) & (np.asarray(js.active) == 1)
        assert took.sum() > 0
        if "react_batch" in kw:
            k = int(jm.n_reactivated)
            assert k == 64
            pending = np.flatnonzero(np.asarray(st.active) != 1)
            np.testing.assert_array_equal(np.flatnonzero(took), pending[:k])


# ---------------------------------------------------------------------------
# the carried forms
# ---------------------------------------------------------------------------


def _carried(jcfg, **kw):
    return dc.replace(jcfg, carried_deposit="on", carried_pad=8,
                      react_batch=512, **kw)


def test_carried_bca_step_matches_jax(bca_pair):
    """carried_deposit='on' with react_batch 512: one step from the primed
    planted state, the escapes' tents subtracted, the ionization charge
    and the re-activated rows patched in one deposit2 launch. The carried
    rho and n within 2e-5 of JAX's largest node, the counts equal (no
    clamp, nothing suppressed or deferred), and the carry equal to a
    fresh deposit of the new state within 5e-5."""
    jpre, st = bca_pair
    jcfg = _carried(jpre.config)
    js0 = jmag.prime_carry(st, jcfg)
    js, jm, ts, tm, ion = _step_pair(jcfg, js0)
    assert int(jm.n_ionized) > 0 and int(jm.n_escaped) > 0
    assert int(jm.n_reactivated) > 0
    _assert_step_close(js, jm, ts, tm, counts=(
        "n_hit_wall", "n_ionized", "n_reactivated", "n_escaped",
        "carry_clamped", "n_ion_suppressed", "n_escape_deferred"))
    assert _assert_charge_states(jcfg, js0, js, ts, ion) == 0
    for k in ("rho", "n"):
        ref = np.asarray(getattr(js, k))
        np.testing.assert_allclose(getattr(ts, k).numpy(), ref, rtol=0,
                                   atol=2e-5 * np.abs(ref).max())
    fresh = magnetized.prime_carry(ts, _tcfg_of(jcfg))
    for k in ("rho", "n"):
        a, b = getattr(ts, k), getattr(fresh, k)
        assert float((a - b).abs().max() / b.abs().max()) < 5e-5, k


def test_carried_caps_revert_and_defer_as_jax(bca_pair):
    """carried_ion_cap 2: ionization events past it revert (charge and
    ledger), escapes past it wait a step; the counts equal JAX's (> 0)
    and the carry still equals a fresh deposit (5e-5)."""
    jpre, st = bca_pair
    jcfg = _carried(jpre.config, carried_ion_cap=2)
    js0 = jmag.prime_carry(st, jcfg)
    js, jm, ts, tm, ion = _step_pair(jcfg, js0)
    assert int(jm.n_ion_suppressed) > 0 and int(jm.n_escape_deferred) > 0
    _assert_step_close(js, jm, ts, tm, counts=(
        "n_ionized", "n_escaped", "n_ion_suppressed", "n_escape_deferred"))
    assert _assert_charge_states(jcfg, js0, js, ts, ion) == 0
    fresh = magnetized.prime_carry(ts, _tcfg_of(jcfg))
    for k in ("rho", "n"):
        a, b = getattr(ts, k), getattr(fresh, k)
        assert float((a - b).abs().max() / b.abs().max()) < 5e-5, k


def test_carry_invariant_over_steps_with_every_branch():
    """tests/test_magnetized.py:1137-1168 on the port's own draws:
    test_magnetized.py's carried workload (ng 51, 4,000 hot D+ in 4,800
    slots, ionization, 'capped-source' with source_n 4,200, react_batch
    512) over 20 steps: the carry equals a fresh deposit within 5e-5 at
    every step, nothing clamped or suppressed, and the ionization,
    re-activation and wall-loss branches all exercised."""
    grid = GridSpec(51, 0.01, "dirichlet-dirichlet")
    rng = np.random.default_rng(1)
    n = 4000
    x = rng.uniform(0, grid.length, n)
    v = rng.normal(size=(n, 3)) * 5e4
    src = magnetized.SourceSpec(mass=2 * M_PROTON, charge_state=1.0,
                                p2c=5e15, species_idx=0, ti=10.0 * EV_TO_K)
    cfg = magnetized.MagnetizedConfig(
        grid=grid, dt=5e-9, te=10.0 * EV_TO_K, b=(0.5, 0.5, 1.0),
        species_z=(5,), ionization=True, reactivate="capped-source",
        source=src, source_n=4200, react_batch=512, iead_energy_max=100.0,
        carried_deposit="on", carried_pad=8, newton_backend="pallas")
    st = magnetized.init_state(x, v, np.full(n, 2 * M_PROTON), np.ones(n),
                               np.full(n, 5e15), np.zeros(n, np.int32), cfg,
                               seed=3, capacity=4800, device="cpu")
    step = magnetized.make_step(cfg)
    events = np.zeros(3, int)
    for i in range(20):
        st, m = step(st)
        assert int(m.carry_clamped) == 0 and int(m.n_ion_suppressed) == 0, i
        fresh = magnetized.prime_carry(st, cfg)
        for k in ("rho", "n"):
            a, b = getattr(st, k), getattr(fresh, k)
            assert float((a - b).abs().max() / b.abs().max()) < 5e-5, (i, k)
        events += [int(m.n_reactivated), int(m.n_ionized), int(m.n_hit_wall)]
    assert (events > 0).all(), events


@pytest.mark.parametrize("n", [1, 1023, 1025, 180_000])
@pytest.mark.parametrize("width", [1, 7, 1024])
def test_prefix_min_equals_cummin(n, width):
    """The two-level running minimum of the min-plus admission equals
    torch.cummin (and JAX's associative min-scan) exactly, at row widths
    that divide n and that do not."""
    x = torch.randint(-5000, 5000, (n,), dtype=torch.int32,
                      generator=torch.Generator().manual_seed(n + width))
    got = magnetized.prefix_min(x, width)
    assert got.dtype == torch.int32
    assert torch.equal(got, torch.cummin(x, dim=0).values)
    ref = jax.lax.associative_scan(jnp.minimum, jnp.asarray(x.numpy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
