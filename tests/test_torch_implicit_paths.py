"""The implicit engine's remaining paths in pypic_tpu_torch against pypic_tpu:
the converged-deposit finalize, the shared-window Picard pass, the
composed backend, the resident multi-step kernel, and ``run_thinned``.

The same numpy inputs go through the JAX functions (Pallas kernels in
interpret mode) and through the port's plain kernel versions (the tensors
lie on the CPU). The kernels themselves are held against these plain
versions on the card by tests/test_torch_cuda.py and chip_smoke.py.
Kernel tolerances are those of tests/test_pallas.py: positions 1e-4
cells, currents 2e-5 and velocities 1e-4 of the output's largest
magnitude. Engine tolerances are those of tests/test_torch_implicit.py;
multi-step ones those of tests/test_pallas.py:459-470.
"""

import dataclasses
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pypic_tpu import initialize as jinit
from pypic_tpu.constants import E_CHARGE, EPSILON_0, EV_TO_K, K_BOLTZMANN, M_ELECTRON
from pypic_tpu.engines import implicit as jimplicit
from pypic_tpu.grid import GridSpec as JGridSpec
from pypic_tpu.ops.pallas_cic import (
    implicit_resident_matrices,
    implicit_resident_pallas,
    picard_finalize_pallas,
    picard_iteration_pallas,
)
from pypic_tpu.runner import run as jrun
from pypic_tpu.runner import run_thinned as jrun_thinned

from pypic_tpu_torch.engines import implicit
from pypic_tpu_torch.grid import GridSpec
from pypic_tpu_torch.ops import cuda_cic
from pypic_tpu_torch.runner import run, run_thinned

N = 4097
QM, W, DT, DX = -1.7e11, -3.2e-9, 1e-7, 0.05

# tests/test_pallas.py:450-453: the plain and the conserving configuration
RESIDENT_CONFIGS = {
    "field-none": dict(picard_accel="none", picard_init="field", tol=1e-9,
                       maxiter=50),
    "extrapolate-anderson": dict(picard_accel="anderson",
                                 picard_init="extrapolate", tol=1e-30,
                                 maxiter=4),
}


def _pass_inputs(ng, seed=7, seeded=False, e_scale=1e3):
    """Ragged particle inputs with edge positions. ``seeded`` puts the
    guess at the free-streaming midpoint, as the engine's shared-window
    step does, so that with a weak field no deposit leaves the frame."""
    rng = np.random.default_rng(seed)
    p0 = rng.uniform(0, ng, N).astype(np.float32)
    v0 = (rng.normal(size=N) * 1e5).astype(np.float32)
    ps = rng.uniform(0, ng, N).astype(np.float32)
    e = (rng.normal(size=ng) * e_scale).astype(np.float32)
    edge = np.array([0.0, ng - 1e-4, ng], np.float32)
    p0[:3] = edge
    ps[:3] = edge
    ps[3:6] = edge
    v0[:3] = 0.0
    if seeded:
        ps = p0 + np.float32(0.5 * DT / DX) * v0
        ps = (ps - np.floor(ps * np.float32(1.0 / ng)) * ng).astype(np.float32)
    return e, ps, p0, v0


def _pos_close(a, b, ng, tol=1e-4):
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    assert np.minimum(d, ng - d).max() < tol


def _rel_close(a, b, rel):
    a = np.asarray(a, np.float64)
    np.testing.assert_allclose(np.asarray(b, np.float64), a, rtol=0,
                               atol=rel * np.abs(a).max())


def _both(arrs):
    return ([jnp.asarray(a) for a in arrs], [torch.from_numpy(a) for a in arrs])


# ---------------------------------------------------------------------------
# kernels' plain versions against the Pallas kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ng", [64, 129, 200])
def test_picard_finalize_plain_matches_pallas(ng):
    (je, jps, jp0, jv0), (te, tps, tp0, tv0) = _both(_pass_inputs(ng, seed=11))
    jp1, jv1, jj1 = picard_finalize_pallas(
        je, jps, jp0, jv0, ng, qm=jnp.float32(QM), w=jnp.float32(W), dt=DT, dx=DX)
    p1, v1, j1 = cuda_cic.picard_finalize_plain(te, tps, tp0, tv0, ng, qm=QM,
                                                w=W, dt=DT, dx=DX)
    _pos_close(jp1, p1, ng)
    _rel_close(jv1, v1, 1e-4)
    _rel_close(jj1, j1, 2e-5)
    # the sweep is picard_finalize_nodep's, bit for bit
    p1n, v1n = cuda_cic.picard_finalize_nodep_plain(te, tps, tp0, tv0, ng,
                                                    qm=QM, dt=DT, dx=DX)
    assert torch.equal(p1, p1n) and torch.equal(v1, v1n)


@pytest.mark.parametrize("case", ["unclamped", "clamped"])
@pytest.mark.parametrize("ng", [64, 200])
def test_picard_iteration_shared_plain_matches_pallas(ng, case):
    """The shared-window pass: the same particles clamp on both sides
    (n_clamped equal). The unclamped case seeds the guess at the
    free-streaming midpoint under a weak field; the clamped one draws the
    guess anywhere under a strong field, so |delta| exceeds a cell."""
    clamped = case == "clamped"
    arrs = _pass_inputs(ng, seed=13, seeded=not clamped,
                        e_scale=1e3 if clamped else 1.0)
    (je, jps, jp0, jv0), (te, tps, tp0, tv0) = _both(arrs)
    kw = dict(dt=DT, dx=DX, emit_v=clamped)
    jout = picard_iteration_pallas(je, jps, jp0, jv0, ng, qm=jnp.float32(QM),
                                   w=jnp.float32(W), share_window=True, **kw)
    tout = cuda_cic.picard_iteration_shared_plain(te, tps, tp0, tv0, ng,
                                                  qm=QM, w=W, **kw)
    assert len(tout) == len(jout)
    assert tout[-1].dtype == torch.int32
    assert int(tout[-1]) == int(jout[-1])
    assert (int(tout[-1]) > N // 2) if clamped else (int(tout[-1]) == 0)
    _pos_close(jout[0], tout[0], ng)
    _rel_close(jout[-2], tout[-2], 2e-5)
    if clamped:
        _rel_close(jout[1], tout[1], 1e-4)
    else:
        # no clamp: a deposit at the wrapped midpoint
        _, v1, _ = cuda_cic.picard_iteration_plain(te, tps, tp0, tv0, ng, qm=QM,
                                                   w=W, emit_v=True, dt=DT, dx=DX)
        wf = cuda_cic.kernel_scalars(QM, DT, DX, W)[3]
        at_ph = cuda_cic.deposit_plain(tout[0], wf * (0.5 * (tv0 + v1)), ng,
                                       periodic=True)
        _rel_close(at_ph, tout[-2], 2e-5)


def _landau_load(n, ng=200, seed=1):
    """The reference Landau preset's plasma (tests/test_pallas.py:445-449)."""
    density, te, ti = 1e5, 100.0 * EV_TO_K, 0.1 * EV_TO_K
    debye = np.sqrt(K_BOLTZMANN * te * EPSILON_0 / E_CHARGE**2 / density)
    length = 22.0 * debye
    x, v, params = jinit.initialize_periodic(
        "landau-damping", n, density, 1, 0.8,
        JGridSpec(ng, length, "periodic"), te, ti, seed=seed)
    return ng, length, x, v, params


def _two_stream_load(n, ng=64):
    """tests/test_engines.py's two-stream setup."""
    density, te = 1e10, 0.1 * 11600.0
    debye = np.sqrt(K_BOLTZMANN * te * EPSILON_0 / E_CHARGE**2 / density)
    length = 15.0 * debye
    x, v, params = jinit.initialize_periodic(
        "two-stream", n, density, 1, 0.05, JGridSpec(ng, length, "periodic"),
        te, te, seed=2)
    return ng, length, x, v, params


def _configs(ng, length, dt, p2c, **opts):
    return (jimplicit.ImplicitConfig(JGridSpec(ng, length, "periodic"), dt, p2c,
                                     **opts),
            implicit.ImplicitConfig(GridSpec(ng, length, "periodic"), dt, p2c,
                                    **opts))


def _states(jcfg, tcfg, x, v, q=-E_CHARGE, m=M_ELECTRON):
    return (jimplicit.init_state(x, v, q, m, jcfg),
            implicit.init_state(x, v, q, m, tcfg, device="cpu"))


@pytest.mark.parametrize("name", list(RESIDENT_CONFIGS))
def test_implicit_resident_plain_matches_pallas(name):
    """Ten steps in one call of each, from the same Landau state."""
    opts = RESIDENT_CONFIGS[name]
    ng, length, x, v, params = _landau_load(4097)
    jcfg, tcfg = _configs(ng, length, 1e-5, params.p2c, **opts)
    jst, tst = _states(jcfg, tcfg, x, v)
    steps = 10
    kw = dict(dt=1e-5, dx=tcfg.grid.dx, tol=opts["tol"],
              maxiter=opts["maxiter"],
              extrapolate=opts["picard_init"] == "extrapolate",
              anderson=opts["picard_accel"] == "anderson",
              fe_c=0.5 * EPSILON_0 * tcfg.grid.dx, tracer=0)
    w = params.p2c / tcfg.grid.dx
    fold, sels, sm = implicit_resident_matrices(ng, True)
    jout = implicit_resident_pallas(
        jst.e, jst.e_prev, jst.j, jst.p, jst.v, ng, steps,
        qm=jst.q / jst.m, w=jst.q * w, ke_c=0.5 * params.p2c * jst.m,
        fold_mat=fold, sels_mat=sels, sm_mat=sm, **kw)
    tout = cuda_cic.implicit_resident_plain(
        tst.e, tst.e_prev, tst.j, tst.p, tst.v, ng, steps,
        **implicit.resident_kwargs(tst, tcfg))
    jrows, trows = jout[5], tout[5]
    np.testing.assert_array_equal(trows["iters"].numpy(), np.asarray(jrows["iters"]))
    np.testing.assert_allclose(trows["fe"].numpy(), np.asarray(jrows["fe"]), rtol=1e-4)
    np.testing.assert_allclose(trows["ke"].numpy(), np.asarray(jrows["ke"]), rtol=1e-5)
    _rel_close(jrows["jb"], trows["jb"], 1e-4)
    _pos_close(jout[0], tout[0], ng, 5e-3)
    _rel_close(jout[1], tout[1], 1e-4)
    for j_arr, t_arr in zip(jout[2:5], tout[2:5]):  # e1, e_prev, jh
        _rel_close(j_arr, t_arr, 1e-4)


# ---------------------------------------------------------------------------
# the engine's paths
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(RESIDENT_CONFIGS))
def test_run_resident_matches_run(name):
    """tests/test_pallas.py:431-474 for the port: 25 resident steps in
    chunks of 8 (three full launches and a remainder) against 25 steps of
    runner.run: iterations equal, fe rtol 1e-4, ke 1e-5, positions 5e-3
    cells."""
    ng, length, x, v, params = _landau_load(9001)
    tcfg = implicit.ImplicitConfig(GridSpec(ng, length, "periodic"), 1e-5,
                                   params.p2c, backend="fused",
                                   **RESIDENT_CONFIGS[name])
    st = implicit.init_state(x, v, -E_CHARGE, M_ELECTRON, tcfg, device="cpu")
    fin1, m1 = run(implicit.make_step(tcfg), st, 25)
    fin2, m2 = implicit.run_resident(tcfg, st, 25, steps_per_call=8)
    np.testing.assert_array_equal(m2.picard_iters.numpy(), m1.picard_iters.numpy())
    np.testing.assert_allclose(m2.field_energy.double().numpy(),
                               m1.field_energy.double().numpy(), rtol=1e-4)
    np.testing.assert_allclose(m2.kinetic_energy.double().numpy(),
                               m1.kinetic_energy.double().numpy(), rtol=1e-5)
    _pos_close(fin1.p, fin2.p, ng, 5e-3)
    assert int(fin2.step) == 25
    for f in m2._fields:
        assert getattr(m2, f).shape == (25,), f
    assert m2.picard_iters.dtype == torch.int32
    assert not m2.picard_clamped.any()
    # e_prev2 is the previous chunk's e_prev, as in the JAX engine
    mid, _ = implicit.run_resident(tcfg, st, 24, steps_per_call=8)
    assert torch.equal(fin2.e_prev2, mid.e_prev)
    with pytest.raises(ValueError, match="finalize"):
        bad = dataclasses.replace(tcfg, finalize="iterate")
        implicit.run_resident(bad, st, 2)


# (config options, state change, n): each JAX accept/reject answer
RESIDENT_CASES = {
    "accepted": ({}, None, 64),
    "accepted-extrapolate-anderson-unsmoothed": (
        dict(picard_init="extrapolate", picard_accel="anderson",
             smooth=False), None, 64),
    "per-particle-q": ({}, "q", 64),
    "composed": (dict(backend="composed"), None, 64),
    "ng-above-1024": (dict(ng=1025), None, 64),
    "n-above-131072": ({}, None, 131073),
    "axis-name": (dict(axis_name="particles"), None, 64),
    "extrapolate2": (dict(picard_init="extrapolate2"), None, 64),
    "anderson2": (dict(picard_accel="anderson2"), None, 64),
    "damped": (dict(picard_accel="damped"), None, 64),
    "iterate": (dict(finalize="iterate"), None, 64),
    "converged-deposit": (dict(finalize="converged-deposit"), None, 64),
    "finalize-field-map": (dict(finalize_field="map"), None, 64),
    "shared-window": (dict(window_share="shared"), None, 64),
}


@pytest.mark.parametrize("case", list(RESIDENT_CASES))
def test_check_resident_supported_matches_jax(case):
    opts, change, n = RESIDENT_CASES[case]
    opts = dict(opts)
    ng = opts.pop("ng", 32)
    x = np.linspace(0.0, 0.9, n)
    jcfg, tcfg = _configs(ng, 1.0, 1e-3, 1.0, **opts)
    # states from the defaults: the port's init_state refuses options that
    # are not ported yet, and the check reads only shapes and the config
    jst, tst = _states(*_configs(ng, 1.0, 1e-3, 1.0), x, np.zeros(n))
    if change == "q":
        jst = jst.replace(q=jnp.full(n, -E_CHARGE, jnp.float32))
        tst = tst.replace(q=torch.full((n,), -E_CHARGE))
    errors = []
    for check, cfg, st in ((jimplicit.check_resident_supported, jcfg, jst),
                           (implicit.check_resident_supported, tcfg, tst)):
        try:
            check(cfg, st)
            errors.append(None)
        except ValueError as err:
            errors.append(str(err))
    assert errors[0] == errors[1]
    assert (errors[0] is None) == case.startswith("accepted")
    if errors[1] is not None:  # a rejected config never falls back
        with pytest.raises(ValueError, match="run_resident"):
            implicit.run_resident(tcfg, tst, 2)


def _close(a, b, rel):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    np.testing.assert_allclose(b, a, rtol=0, atol=rel * np.abs(a).max())


def _engine_close(jst, tst, jm, tm, ng, pos_tol=2e-4):
    """The engine tolerances of tests/test_torch_implicit.py."""
    d = np.abs(np.asarray(jst.p, np.float64) - tst.p.numpy())
    assert np.minimum(d, ng - d).max() < pos_tol
    _close(jst.v, tst.v, 1e-5)
    _close(jst.e, tst.e, 1e-4)
    _close(jst.j, tst.j, 1e-4)
    np.testing.assert_array_equal(tm.picard_iters.numpy(),
                                  np.asarray(jm.picard_iters))
    for name in ("field_energy", "kinetic_energy"):
        np.testing.assert_allclose(getattr(tm, name).numpy(),
                                   np.asarray(getattr(jm, name)), rtol=1e-5)


@pytest.mark.parametrize("species", ["scalar", "two-species"])
def test_step_composed_matches_jax(species):
    """Three composed steps: backend='composed' with scalar q/m, and the
    two-species load of tests/test_engines.py:197-223 with (n,) q/m under
    backend='auto'."""
    if species == "scalar":
        ng, length, x, v, params = _landau_load(8192)
        q, m = -E_CHARGE, M_ELECTRON
        jcfg, tcfg = _configs(ng, length, 1e-5, params.p2c, tol=1e-8,
                              maxiter=50, backend="composed")
    else:
        density, te = 1e10, 0.1 * 11600.0
        debye = np.sqrt(K_BOLTZMANN * te * EPSILON_0 / E_CHARGE**2 / density)
        ng, length, n = 64, 15.0 * debye, 20_000
        rng = np.random.default_rng(9)
        x = rng.uniform(0, length, n)
        m = np.where(np.arange(n) < n // 2, M_ELECTRON, 1836.0 * M_ELECTRON)
        q = np.where(np.arange(n) < n // 2, -E_CHARGE, E_CHARGE)
        v = rng.normal(size=n) * np.sqrt(K_BOLTZMANN * te / m)
        dt = 0.1 * np.sqrt(E_CHARGE**2 * density / EPSILON_0 / M_ELECTRON) ** -1
        jcfg, tcfg = _configs(ng, length, dt, length * density / n, tol=1e-8,
                              maxiter=50)
    jst, tst = _states(jcfg, tcfg, x, v, q, m)
    jst, jm = jrun(jimplicit.make_step(jcfg), jst, 3)
    tst, tm = run(implicit.make_step(tcfg), tst, 3)
    _engine_close(jst, tst, jm, tm, ng)
    bias_scale = np.abs(np.asarray(jm.current_bias)).max()
    np.testing.assert_allclose(tm.current_bias.numpy(),
                               np.asarray(jm.current_bias),
                               atol=1e-4 * max(bias_scale, 1e-30))
    assert not tm.picard_clamped.any()


def test_converged_deposit_matches_jax_and_converged():
    """finalize='converged-deposit' stores the full-step j1 and its mean
    as current_bias; its trajectory is the 'converged' one bit for bit
    (tests/test_engines.py:226-252)."""
    ng, length, x, v, params = _landau_load(20_000)
    conserving = dict(tol=1e-30, maxiter=4, picard_init="extrapolate",
                      picard_accel="anderson")
    jcfg, tcfg = _configs(ng, length, 1e-5, params.p2c,
                          finalize="converged-deposit", **conserving)
    jst, tst = _states(jcfg, tcfg, x, v)
    jst, jm = jrun(jimplicit.make_step(jcfg), jst, 3)
    tst0 = tst
    tst, tm = run(implicit.make_step(tcfg), tst, 3)
    _engine_close(jst, tst, jm, tm, ng)
    _close(jm.current_bias, tm.current_bias, 1e-4)
    assert float(tm.current_bias[-1]) == float(torch.mean(tst.j))
    conv, cm = run(implicit.make_step(dataclasses.replace(
        tcfg, finalize="converged")), tst0, 3)
    for f in ("p", "v", "e"):
        assert torch.equal(getattr(conv, f), getattr(tst, f)), f
    # the closed-form bias of 'converged' against the deposit's mean
    np.testing.assert_allclose(cm.current_bias.double().numpy(),
                               tm.current_bias.double().numpy(), rtol=1e-3)


@pytest.mark.parametrize("drift", ["v0-zero", "v0-loaded"])
def test_shared_window_step_matches_jax(drift):
    """One shared-window step: tests/test_engines.py:419-446's v0 = 0 case
    (the midpoint seed is p0), and the loaded velocities; the clamp count
    equals JAX's (0 here)."""
    ng, length, x, v, params = _two_stream_load(5_000)
    if drift == "v0-zero":
        v = np.zeros_like(v)
    jcfg, tcfg = _configs(ng, length, 0.1 / params.wp, params.p2c, tol=1e-8,
                          maxiter=50, backend="fused", window_share="shared")
    jst, tst = _states(jcfg, tcfg, x, v)
    jst1, jm = jimplicit.make_step(jcfg)(jst)
    tst1, tm = implicit.make_step(tcfg)(tst)
    d = np.abs(np.asarray(jst1.p, np.float64) - tst1.p.numpy())
    assert np.minimum(d, ng - d).max() < 2e-4
    _close(jst1.v, tst1.v, 1e-5)
    _close(jst1.e, tst1.e, 1e-4)
    _close(jst1.j, tst1.j, 1e-4)
    assert int(tm.picard_iters) == int(jm.picard_iters)
    assert tm.picard_clamped.dtype == torch.int32
    assert int(tm.picard_clamped) == int(jm.picard_clamped) == 0


def test_run_thinned_matches_jax():
    """tests/test_io.py:264-289: scalar series keep every step, equal to
    the unthinned run's."""
    ng, length, x, v, params = _two_stream_load(4000)
    jcfg, tcfg = _configs(ng, length, 0.1 / params.wp, params.p2c, tol=1e-6,
                          maxiter=40)
    jst, tst = _states(jcfg, tcfg, x, v)
    _, jthin = jrun_thinned(jimplicit.make_step(jcfg), jst, 40, 10)
    _, full = run(implicit.make_step(tcfg), tst, 40)
    _, thin = run_thinned(implicit.make_step(tcfg), tst, 40, 10)
    for f in thin._fields:
        assert getattr(thin, f).shape == (40,), f
        assert torch.equal(getattr(thin, f), getattr(full, f)), f
    np.testing.assert_allclose(thin.field_energy.double().numpy(),
                               np.asarray(jthin.field_energy, np.float64),
                               rtol=1e-4)
    np.testing.assert_array_equal(thin.picard_iters.numpy(),
                                  np.asarray(jthin.picard_iters))


class _Rows(NamedTuple):
    total: object  # 0-d
    profile: object  # (ng,)


def test_run_thinned_heavy_rows_match_jax():
    """A small step with one 0-d and one (ng,) metric through both
    run_thinned: the heavy row keeps each chunk's last step, the scalar
    every step; num_steps % every raises in both."""
    ng = 16
    base = np.arange(ng, dtype=np.float32)

    def jstep(s):
        s = s * 1.5 + 1.0
        return s, _Rows(total=jnp.sum(s), profile=s)

    def tstep(s):
        s = s * 1.5 + 1.0
        return s, _Rows(total=torch.sum(s), profile=s)

    _, jm = jrun_thinned(jstep, jnp.asarray(base), 12, 4)
    _, tm = run_thinned(tstep, torch.from_numpy(base), 12, 4)
    assert tm.total.shape == (12,) and tm.profile.shape == (3, ng)
    np.testing.assert_allclose(tm.total.numpy(), np.asarray(jm.total), rtol=1e-6)
    np.testing.assert_allclose(tm.profile.numpy(), np.asarray(jm.profile),
                               rtol=1e-6)
    with pytest.raises(ValueError, match="multiple of every") as jerr:
        jrun_thinned(jstep, jnp.asarray(base), 10, 4)
    with pytest.raises(ValueError, match="multiple of every") as terr:
        run_thinned(tstep, torch.from_numpy(base), 10, 4)
    assert str(terr.value) == str(jerr.value)
