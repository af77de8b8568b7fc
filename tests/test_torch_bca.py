"""The BCA surface coupling of pypic_tpu_torch against pypic_tpu: the
surface models (``bca``), the injector of their products
(``engines.magnetized.make_inject``) and the hybrid driver
(``engines.bca_driver``).

``bca`` is numpy on both sides: from the same seeds its rows are equal.
The injector runs from one state in both packages on the same rows. The
drivers run a few steps from one state, the port's step fed the JAX
engine's draws of each step (the JAX key after s steps is the first of
the four keys split from the key before), and the surface models from the
same seeds. Each tolerance is stated beside its test.
"""

import dataclasses as dc
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pypic_tpu import bca as jbca
from pypic_tpu import presets as jpresets
from pypic_tpu.constants import M_PROTON
from pypic_tpu.engines import bca_driver as jdriver
from pypic_tpu.engines import magnetized as jmag

from pypic_tpu_torch import bca, interop, presets
from pypic_tpu_torch.engines import bca_driver, magnetized
from test_torch_ionization import _hooks, _port_state, _tcfg_of

REPO = Path(__file__).resolve().parents[1]
B_AMU = 10.81


def _values(path):
    """The numbers of a write_particles .dat stream, one a line."""
    text = Path(path).read_text().split()
    return np.asarray([float(v) for v in text])


def _models(mod, s1=1, s2=2):
    return (mod.BinaryCollisionModel(seed=s1),
            mod.BinaryCollisionModel(incident_m_amu=B_AMU, incident_z=5,
                                     seed=s2))


# ---------------------------------------------------------------------------
# the surface models
# ---------------------------------------------------------------------------


def test_null_bca_empty():
    for mod in (bca, jbca):
        s, r = mod.NullBCA().run([10.0, 20.0], [5.0, 10.0])
        assert s.shape == (0, 6) and r.shape == (0, 6)
        s, r = mod.NullBCA().run_from_iead(np.linspace(0, 1, 3),
                                           np.linspace(0, 90, 3), np.ones((2, 2)))
        assert s.shape == (0, 6) and r.shape == (0, 6)


@pytest.mark.parametrize("energy", [5.0, 60.0, 500.0])
def test_binary_collision_model_rows_equal_jax(energy):
    """tests/test_bca.py:21-38's calls from the same seed: the same rows,
    bit for bit, three calls in a row (the generator's state carried)."""
    rng = np.random.default_rng(int(energy))
    a, b = bca.BinaryCollisionModel(seed=4), jbca.BinaryCollisionModel(seed=4)
    for _ in range(3):
        e = rng.normal(energy, 0.2 * energy, 3000).clip(0.1)
        ang = rng.uniform(0, 90, 3000)
        for got, ref in zip(a.run(e, ang), b.run(e, ang)):
            assert got.shape[1] == 6
            np.testing.assert_array_equal(got, ref)
    s, _ = bca.BinaryCollisionModel(seed=0).run(np.full(5000, 500.0),
                                                np.zeros(5000))
    assert 0.05 < len(s) / 5000 < 0.15 and (s[:, 5] == 5).all()


def test_run_from_iead_and_postprocess_equal_jax():
    """The histogram channel (bin centres, multiplicities) and pic_iead's
    end-of-run post-process on a synthetic (2, 40, 40) IEAD: equal rows
    and budget."""
    rng = np.random.default_rng(3)
    iead = rng.poisson(0.4, (2, 40, 40)).astype(np.float32)
    e_edges = np.linspace(0.0, 400.0, 41)
    a_edges = np.linspace(0.0, 90.0, 41)
    got = bca.BinaryCollisionModel(seed=7).run_from_iead(e_edges, a_edges, iead[0])
    ref = jbca.BinaryCollisionModel(seed=7).run_from_iead(e_edges, a_edges, iead[0])
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    pg = bca.postprocess_iead(iead, 400.0, 90.0, *_models(bca))
    pr = jbca.postprocess_iead(iead, 400.0, 90.0, *_models(jbca))
    assert pg.keys() == pr.keys()
    for k in pg:
        np.testing.assert_array_equal(pg[k], pr[k], err_msg=k)
    assert pg["num_deposited_wall"] + pg["num_reflected_wall"] == pg["num_incident_wall"]


def test_particles_from_energy_angle_equal_jax():
    """tests/test_bca.py:41-60's rows and 500 random ones: equal fields
    from the same generator."""
    rng = np.random.default_rng(5)
    rows = np.concatenate([
        np.asarray([[100.0, 1.0, 0.0, 0.0, 1.0, 1],
                    [3.0, 0.5, 0.5, 0.7071, 10.81, 5]]),
        np.stack([rng.uniform(1, 300, 500), rng.uniform(0.1, 1, 500),
                  rng.normal(size=500), rng.normal(size=500),
                  np.full(500, 10.81), np.full(500, 5)], axis=-1)])
    sides = rng.integers(0, 2, len(rows)).astype(np.float64)
    got = bca.particles_from_energy_angle(rows, sides, 1e-10, 1e-3, 1e10,
                                          np.random.default_rng(0))
    ref = jbca.particles_from_energy_angle(rows, sides, 1e-10, 1e-3, 1e10,
                                           np.random.default_rng(0))
    assert got.keys() == ref.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    # off the wall it leaves: the left wall forward, the right backward
    assert (np.sign(got["v"][:, 0]) == np.where(sides == 0, 1, -1)).all()
    assert (got["charge_state"] == 0).all()


def test_ftridyn_seam():
    """FTridynBCA raises ImportError without the external package, and
    against a recorded fake ``fractal_tridyn`` module
    (tests/test_bca.py:408-490's fixture) it makes the reference's calls
    and thins the products by number_histories."""
    saved = {k: sys.modules.get(k) for k in
             ("fractal_tridyn", "fractal_tridyn.utils",
              "fractal_tridyn.utils.generate_ftridyn_input")}
    if saved["fractal_tridyn"] is None:
        with pytest.raises(ImportError):
            bca.FTridynBCA("H", "B")
    calls = {}

    class _FakeInterface:
        def __init__(self, source, wall):
            calls["ctor"] = (source, wall)

        def run_tridyn_simulations_from_list(self, energies, angles,
                                             number_histories=100):
            calls["from_list"] = (energies, angles, number_histories)
            row = [8.5, 0.9, 0.3, 0.3, 10.81, 5]
            return ([list(row) for _ in range(2 * number_histories)],
                    [list(row) for _ in range(len(energies) * number_histories)])

        def run_tridyn_simulations_from_iead(self, energy_edges, angle_edges,
                                             iead, number_histories=100):
            calls["from_iead"] = number_histories
            row = [8.5, 0.9, 0.3, 0.3, 10.81, 5]
            return ([list(row) for _ in range(3 * number_histories)],
                    [list(row) for _ in range(number_histories)])

    pkg = types.ModuleType("fractal_tridyn")
    utils = types.ModuleType("fractal_tridyn.utils")
    gen = types.ModuleType("fractal_tridyn.utils.generate_ftridyn_input")
    gen.tridyn_interface = _FakeInterface
    pkg.utils = utils
    utils.generate_ftridyn_input = gen
    sys.modules.update({"fractal_tridyn": pkg, "fractal_tridyn.utils": utils,
                        "fractal_tridyn.utils.generate_ftridyn_input": gen})
    try:
        iface = bca.FTridynBCA("H", "B")
        assert calls["ctor"] == ("H", "B")
        sput, refl = iface.run(np.array([30.0, 55.0, 80.0]),
                               np.array([10.0, 45.0, 60.0]), num_histories=50)
        assert calls["from_list"][0] == [30.0, 55.0, 80.0]
        assert sput.shape == (2, 6) and refl.shape == (3, 6)
        sput, refl = iface.run_from_iead(np.linspace(0, 100, 6),
                                         np.linspace(0, 90, 5), np.ones((5, 4)),
                                         num_histories=25)
        assert calls["from_iead"] == 25
        assert sput.shape == (3, 6) and refl.shape == (1, 6)
    finally:
        for k, v in saved.items():
            if v is None:
                del sys.modules[k]
            else:
                sys.modules[k] = v


# ---------------------------------------------------------------------------
# the injector
# ---------------------------------------------------------------------------


def _inject_rows(k, cfg, seed=0, valid=None):
    rng = np.random.default_rng(seed)
    rows = dict(
        x=(rng.uniform(0.05, 0.95, k) * cfg.grid.length).astype(np.float32),
        yz=np.zeros((k, 2), np.float32),
        v=(rng.normal(size=(k, 3)) * 1e4).astype(np.float32),
        m=np.full(k, B_AMU * M_PROTON, np.float32),
        charge_state=np.zeros(k, np.float32),
        p2c=np.full(k, 1e10, np.float32),
        species_idx=np.ones(k, np.int32),
        t=np.full(k, 3e-10, np.float32),
        valid=np.ones(k, bool) if valid is None else valid)
    return rows


def _inject_both(jcfg, jstate, rows):
    order = ("x", "yz", "v", "m", "charge_state", "p2c", "species_idx", "t",
             "valid")
    js, jn, jd = jmag.make_inject(jcfg)(jstate, *(jnp.asarray(rows[k]) for k in order))
    ts, tn, td = magnetized.make_inject(_tcfg_of(jcfg))(
        _port_state(jstate), *(rows[k] for k in order))
    assert int(tn) == int(jn) and int(td) == int(jd)
    assert tn.dtype == td.dtype == torch.int32
    got = interop.magnetized_state_to_numpy(ts)
    for k in interop._MAGNETIZED_FIELDS:
        if k in ("rho", "n"):
            continue
        np.testing.assert_array_equal(got[k], np.asarray(getattr(js, k)),
                                      err_msg=k)
    return js, jn, jd, ts


def test_inject_claims_free_slots_as_jax():
    """tests/test_bca.py:67-86: 8 rows into the preset's free slots, with
    every third row invalid (the padded batch): the i-th valid row takes
    the i-th free slot; every field equal to JAX's, the counts equal, the
    newcomers active, wall-born, 6D."""
    jpre = jpresets.pic_bca_aps(ppc=5)
    valid = np.arange(12) % 3 != 2
    rows = _inject_rows(12, jpre.config, valid=valid)
    js, jn, jd, ts = _inject_both(jpre.config, jpre.state, rows)
    assert int(jn) == 8 and int(jd) == 0
    newly = (ts.active == 1) & (torch.from_numpy(np.array(jpre.state.active)) != 1)
    assert int(newly.sum()) == 8
    assert bool((ts.from_wall[newly] == 1).all() and (ts.mode[newly] == 0).all())
    # x / dx within an ulp (x times the float32 reciprocal, as XLA takes it)
    np.testing.assert_allclose(ts.p[newly].numpy(),
                               rows["x"][valid] / jpre.config.grid.dx, rtol=1.2e-7)


def test_inject_drops_overflow_as_jax():
    """tests/test_bca.py:89-106: every slot taken, 4 rows dropped and
    counted."""
    jpre = jpresets.pic_bca_aps(ppc=5, capacity_factor=1.0)
    st = jpre.state.replace(active=jnp.ones_like(jpre.state.active))
    _, jn, jd, _ = _inject_both(jpre.config, st, _inject_rows(4, jpre.config))
    assert int(jn) == 0 and int(jd) == 4


def test_inject_patches_the_carry_as_jax():
    """tests/test_magnetized.py:1250-1274 on the port: carried_deposit
    'on', more rows than free slots (5 dropped): the placed rows'
    deposits land on the carry, within 2e-5 of JAX's largest node, and
    the carry equals a fresh deposit within 5e-5."""
    jpre = jpresets.pic_bca_aps(ppc=5)
    jcfg = dc.replace(jpre.config, carried_deposit="on", carried_pad=8,
                      react_batch=512)
    st = jmag.prime_carry(jpre.state, jcfg)
    free = int(np.sum(np.asarray(st.active) != 1))
    js, jn, jd, ts = _inject_both(jcfg, st, _inject_rows(free + 5, jcfg))
    assert int(jn) == free and int(jd) == 5
    for k in ("rho", "n"):
        ref = np.asarray(getattr(js, k))
        np.testing.assert_allclose(getattr(ts, k).numpy(), ref, rtol=0,
                                   atol=2e-5 * np.abs(ref).max())
    fresh = magnetized.prime_carry(ts, _tcfg_of(jcfg))
    for k in ("rho", "n"):
        a, b = getattr(ts, k), getattr(fresh, k)
        assert float((a - b).abs().max() / b.abs().max()) < 5e-5, k


# ---------------------------------------------------------------------------
# the drivers
# ---------------------------------------------------------------------------


def _replayed_step(jcfg, seed):
    """The port's step fed, at step s, the draws of the JAX state's key
    after s steps."""
    keys = [jax.random.PRNGKey(seed)]
    tcfg = _tcfg_of(jcfg)

    def step(state):
        s = state.step_host
        while len(keys) <= s:
            keys.append(jax.random.split(keys[-1], 4)[0])
        like = types.SimpleNamespace(rng=keys[s], p=state.p)
        hooks, _ = _hooks(like, jcfg)
        return magnetized.make_step(tcfg, **hooks)(state)

    return step


def _assert_stats_equal(got, ref):
    assert dc.asdict(got) == dc.asdict(ref)


def _assert_states_close(ts, js):
    """After a few steps: the active mask, species, charges and
    from_wall equal; active positions rtol 2e-5 (atol 1e-4 cells),
    velocities rtol 1e-3 (atol 1)."""
    for k in ("active", "species_idx", "from_wall", "charge_state"):
        np.testing.assert_array_equal(getattr(ts, k).numpy(),
                                      np.asarray(getattr(js, k)), err_msg=k)
    act = np.asarray(js.active) == 1
    np.testing.assert_allclose(ts.p.numpy()[act], np.asarray(js.p)[act],
                               rtol=2e-5, atol=1e-4)
    np.testing.assert_allclose(ts.v.numpy()[act], np.asarray(js.v)[act],
                               rtol=1e-3, atol=1.0)


def test_run_bca_matches_jax_with_replayed_draws(tmp_path):
    """run_bca on pic_bca_aps(ppc=4), 6 steps in blocks of 3, the same
    surface models and driver seed on both sides and the JAX draws in
    the port's step: equal BCAStats (all counters), equal event streams
    line for line (vx / vth within 2e-4), the states at the limits of
    ``_assert_states_close``."""
    jpre = jpresets.pic_bca_aps(ppc=4)
    kw = dict(seed=3, pic_steps_per_bca=3)
    jfin, jstats, jhist = jdriver.run_bca(
        jpre.state, jpre.config, 6, *_models(jbca),
        write_particles=str(tmp_path / "jax"), **kw)
    tfin, tstats, thist = bca_driver.run_bca(
        _port_state(jpre.state), _tcfg_of(jpre.config), 6, *_models(bca),
        write_particles=str(tmp_path / "port"),
        step_fn=_replayed_step(jpre.config, 1), **kw)
    assert jstats.injected > 0 and jstats.source_incident > 0
    _assert_stats_equal(tstats, jstats)
    assert len(thist) == len(jhist) == 6
    for a, b in zip(thist, jhist):
        assert int(a.n_impacts) == int(b.n_impacts)
        assert a.impacts.dtype == np.float32 and a.n_impacts.dtype == np.int32
    for name in sorted(os.listdir(tmp_path / "jax")):
        ref = _values(tmp_path / "jax" / name)
        got = _values(tmp_path / "port" / name)
        assert got.shape == ref.shape, name
        np.testing.assert_allclose(got, ref, rtol=2e-4, atol=1e-6, err_msg=name)
    _assert_states_close(tfin, jfin)


def test_run_bca_from_iead_matches_jax_with_replayed_draws():
    """run_bca_from_iead (the histogram channel) on pic_bca_aps(ppc=4)
    with the impact buffer off, 6 steps in blocks of 3, through the
    port's ``step_fn`` fed the JAX draws: equal BCAStats, the returned
    running IEAD total equal, the states at ``_assert_states_close``'s
    limits; ``reshard`` without the data-parallel mesh raises (the
    two-rank form runs in tests/test_torch_dataparallel_io.py)."""
    jpre = jpresets.pic_bca_aps(ppc=4)
    jcfg = dc.replace(jpre.config, impact_buffer_size=0)
    kw = dict(seed=3, pic_steps_per_bca=3)
    jfin, jstats, _ = jdriver.run_bca_from_iead(jpre.state, jcfg, 6,
                                                *_models(jbca), **kw)
    tfin, tstats, hist = bca_driver.run_bca_from_iead(
        _port_state(jpre.state), _tcfg_of(jcfg), 6, *_models(bca),
        step_fn=_replayed_step(jcfg, 1), **kw)
    assert jstats.injected > 0
    _assert_stats_equal(tstats, jstats)
    assert len(hist) == 6
    np.testing.assert_array_equal(tfin.iead.numpy(), np.asarray(jfin.iead))
    _assert_states_close(tfin, jfin)
    with pytest.raises(ValueError, match="mesh"):
        bca_driver.run_bca_from_iead(_port_state(jpre.state), _tcfg_of(jcfg),
                                     1, *_models(bca), reshard=lambda s: s)


@pytest.mark.parametrize("per_bca", [1, 10])
def test_run_bca_full_chain(tmp_path, per_bca):
    """tests/test_bca.py:109-165's assertions on the port's own draws:
    pic_bca_aps(ppc=10), 40 steps, per-step and 10-step blocks. The
    preset's newton_tol 1e-9 lies under this run's float32 residual floor
    (1-3e-9 from step 9 on, the JAX engine's solve alike), so both
    engines would run it to maxiter 1,000 most steps (1.4 s a step for
    the plain PCR on the CPU); newton_tol 1e-7 ends the solve at the
    floor. More than 100 source impacts, sputtered and reflected > 0,
    products injected and none dropped, wall-born and boron particles
    alive, the yield in (0, 0.5), the ionized H population at source_n,
    and the event streams as long as the counters."""
    pre = presets.pic_bca_aps(ppc=10, device="cpu")
    cfg = dc.replace(pre.config, newton_tol=1e-7, newton_backend="pallas")
    events = str(tmp_path / "events")
    fin, stats, hist = bca_driver.run_bca(
        pre.state, cfg, 40, *_models(bca), seed=3, pic_steps_per_bca=per_bca,
        write_particles=events if per_bca == 1 else None)
    assert len(hist) == 40
    assert stats.source_incident > 100
    assert stats.sputtered > 0 and stats.source_reflected > 0
    assert stats.injected > 0 and stats.dropped == 0
    act = fin.active == 1
    assert int((fin.from_wall[act] == 1).sum()) > 0
    assert int((fin.species_idx[act] == 1).sum()) > 0
    assert 0.0 < stats.total_yield() < 0.5
    n_h = int(((fin.species_idx == 0) & act & (fin.charge_state > 0)).sum())
    assert n_h == pre.meta["source_n"]
    if per_bca == 1:
        def lines(name):
            return _values(os.path.join(events, name)).size

        assert lines("source_wall.dat") == stats.source_incident
        assert (lines("source_from_wall.dat") + lines("wall_from_wall.dat")
                == stats.injected + stats.dropped)


def test_import_leaves_jax_out():
    """The new modules import without JAX, flax or pypic_tpu."""
    code = ("import sys, pypic_tpu_torch.bca, pypic_tpu_torch.checkpoint, "
            "pypic_tpu_torch.engines.bca_driver, pypic_tpu_torch.ops.ionization, "
            "pypic_tpu_torch.presets, pypic_tpu_torch.tools.bca; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'pypic_tpu')]; assert not bad, bad")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
