"""The implicit CN-Picard slice of pypic_tpu_torch against pypic_tpu.

One numpy Landau load (the reference preset's plasma at n = 20,000,
ng = 200, L = 22 debye) goes through ``init_state`` and three steps of the
conserving configuration in both packages: the JAX side runs its fused
Pallas kernels in interpret mode, the port its plain kernel versions (the
tensors lie on the CPU). Tolerances are relative to each output's largest
magnitude; the comments give the gaps measured on the CPU.
"""

import dataclasses
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from pypic_tpu import initialize as jinit
from pypic_tpu.constants import E_CHARGE, EPSILON_0, EV_TO_K, K_BOLTZMANN, M_ELECTRON
from pypic_tpu.engines import implicit as jimplicit
from pypic_tpu.grid import GridSpec as JGridSpec
from pypic_tpu.runner import run as jrun

from pypic_tpu_torch import interop
from pypic_tpu_torch.engines import implicit
from pypic_tpu_torch.grid import GridSpec
from pypic_tpu_torch.runner import run

REPO = pathlib.Path(__file__).resolve().parent.parent

# bench.py's headline (conserving) configuration: exactly 4 Picard passes.
CONSERVING = dict(tol=1e-30, maxiter=4, picard_init="extrapolate",
                  picard_accel="anderson", finalize="converged",
                  finalize_field="last", window_share="auto")
STEPS = 3


def _landau_load(n=20_000, ng=200, seed=1):
    density, te, ti = 1e5, 100.0 * EV_TO_K, 0.1 * EV_TO_K
    debye = np.sqrt(K_BOLTZMANN * te * EPSILON_0 / E_CHARGE**2 / density)
    length = 22.0 * debye
    x, v, params = jinit.initialize_periodic(
        "landau-damping", n, density, 1, 0.8,
        JGridSpec(ng, length, "periodic"), te, ti, seed=seed)
    return ng, length, x, v, params


def _configs(ng, length, params, **kw):
    opts = dict(CONSERVING, **kw)
    jcfg = jimplicit.ImplicitConfig(JGridSpec(ng, length, "periodic"), 1e-5,
                                    params.p2c, **opts)
    tcfg = implicit.ImplicitConfig(GridSpec(ng, length, "periodic"), 1e-5,
                                   params.p2c, **opts)
    return jcfg, tcfg


def _close(a, b, rel):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    scale = np.abs(a).max()
    np.testing.assert_allclose(b, a, rtol=0, atol=rel * scale)


@pytest.fixture(scope="module")
def slice_runs():
    ng, length, x, v, params = _landau_load()
    jcfg, tcfg = _configs(ng, length, params)
    jst0 = jimplicit.init_state(x, v, -E_CHARGE, M_ELECTRON, jcfg)
    jst, jm = jrun(jimplicit.make_step(jcfg), jst0, STEPS)
    tst0 = implicit.init_state(x, v, -E_CHARGE, M_ELECTRON, tcfg,
                               device="cpu")
    tst, tm = run(implicit.make_step(tcfg), tst0, STEPS)
    return dict(j0=(jst0, tst0), final=(jst, tst), metrics=(jm, tm))


def test_init_state_field_and_current(slice_runs):
    j, t = slice_runs["j0"]
    assert t.p.dtype == torch.float32 and t.e.dtype == torch.float32
    np.testing.assert_array_equal(np.asarray(j.p), t.p.numpy())
    _close(j.e, t.e, 5e-5)  # measured 8e-6
    _close(j.j, t.j, 5e-5)


def test_positions_after_three_steps(slice_runs):
    j, t = slice_runs["final"]
    d = np.abs(np.asarray(j.p, np.float64) - t.p.numpy())
    # a wrapped pair sits ng apart across the seam
    d = np.minimum(d, t.e.shape[0] - d)
    assert d.max() < 2e-4, d.max()  # cells; measured 4.6e-5


def test_velocities_after_three_steps(slice_runs):
    j, t = slice_runs["final"]
    _close(j.v, t.v, 1e-5)  # measured 1.2e-6


def test_field_and_current_after_three_steps(slice_runs):
    j, t = slice_runs["final"]
    _close(j.e, t.e, 1e-4)  # measured 9.4e-6
    _close(j.j, t.j, 1e-4)
    _close(j.e_prev, t.e_prev, 1e-4)
    assert int(j.step) == int(t.step) == STEPS


def test_energies_and_picard_iterations(slice_runs):
    jm, tm = slice_runs["metrics"]
    for name in ("field_energy", "kinetic_energy"):
        np.testing.assert_allclose(getattr(tm, name).numpy(),
                                   np.asarray(getattr(jm, name)), rtol=1e-5)
    np.testing.assert_array_equal(tm.picard_iters.numpy(),
                                  np.asarray(jm.picard_iters))
    assert (tm.picard_iters.numpy() == 4).all()
    assert tm.picard_iters.dtype == torch.int32
    assert tm.field_energy.shape == (STEPS,)


def test_metrics_shapes_and_bias(slice_runs):
    jm, tm = slice_runs["metrics"]
    for f in tm._fields:
        assert getattr(tm, f).shape == (STEPS,), f
    bias_scale = np.abs(np.asarray(jm.current_bias)).max()
    np.testing.assert_allclose(tm.current_bias.numpy(),
                               np.asarray(jm.current_bias),
                               atol=1e-4 * max(bias_scale, 1e-30))
    _close(jm.tracer_v, tm.tracer_v, 1e-5)


@pytest.mark.parametrize("finalize", ["converged", "iterate"])
def test_one_step_from_shared_state(finalize):
    """interop hands one JAX state to the port; a step from it agrees."""
    ng, length, x, v, params = _landau_load(n=4097, ng=64, seed=3)
    jcfg, tcfg = _configs(ng, length, params, finalize=finalize)
    jst = jimplicit.init_state(x, v, -E_CHARGE, M_ELECTRON, jcfg)
    tst = interop.implicit_state_from_numpy(
        {k: np.asarray(getattr(jst, k)) for k in interop._FIELDS}, "cpu")
    jst1, jm = jimplicit.make_step(jcfg)(jst)
    tst1, tm = implicit.make_step(tcfg)(tst)
    d = np.abs(np.asarray(jst1.p, np.float64) - tst1.p.numpy())
    assert np.minimum(d, ng - d).max() < 2e-4
    _close(jst1.v, tst1.v, 1e-5)
    _close(jst1.e, tst1.e, 1e-4)
    assert int(tm.picard_iters) == int(jm.picard_iters)


def test_interop_round_trip_is_bit_exact():
    ng, length, x, v, params = _landau_load(n=1000, ng=32, seed=5)
    jcfg, _ = _configs(ng, length, params)
    jst = jimplicit.init_state(x, v, -E_CHARGE, M_ELECTRON, jcfg)
    d = {k: np.asarray(getattr(jst, k)) for k in interop._FIELDS}
    back = interop.implicit_state_to_numpy(
        interop.implicit_state_from_numpy(d, "cpu"))
    assert set(back) == set(d)
    for k in d:
        assert back[k].dtype == d[k].dtype, k
        assert back[k].shape == d[k].shape, k
        assert back[k].tobytes() == d[k].tobytes(), k


def test_interop_missing_field_raises():
    with pytest.raises(KeyError):
        interop.implicit_state_from_numpy({"p": np.zeros(3, np.float32)},
                                          "cpu")


BAD_CONFIGS = [
    dict(picard_init="bogus"),
    dict(finalize="bogus"),
    dict(picard_accel="bogus"),
    dict(finalize_field="bogus"),
    dict(finalize="iterate", finalize_field="map"),
    dict(window_share="bogus"),
    dict(backend="bogus"),
]


@pytest.mark.parametrize("bad", BAD_CONFIGS, ids=lambda d: "-".join(map(str, d.values())))
def test_config_errors_match_jax(bad):
    with pytest.raises(ValueError) as jerr:
        jimplicit.ImplicitConfig(JGridSpec(16, 1.0), 1e-3, 1.0, **bad)
    with pytest.raises(ValueError) as terr:
        implicit.ImplicitConfig(GridSpec(16, 1.0), 1e-3, 1.0, **bad)
    assert str(terr.value) == str(jerr.value)


def test_config_coerces_numpy_scalars():
    cfg = implicit.ImplicitConfig(GridSpec(16, 1.0), np.float64(1e-3),
                                  np.float32(2.0), tol=np.float64(1e-6),
                                  maxiter=np.int64(7))
    assert type(cfg.dt) is float and type(cfg.p2c) is float
    assert type(cfg.tol) is float and type(cfg.maxiter) is int


DEFERRED = [
    dict(finalize_field="mean2"),
    dict(picard_accel="anderson2"),
    dict(axis_name="particles"),
    dict(deposit_method="scatter"),
    dict(deposit_method="matmul"),
]


@pytest.mark.parametrize("opt", DEFERRED, ids=lambda d: "-".join(map(str, d.values())))
def test_deferred_options_raise(opt):
    cfg = implicit.ImplicitConfig(GridSpec(16, 1.0), 1e-3, 1.0, **opt)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        implicit.make_step(cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        implicit.init_state(np.linspace(0.0, 0.9, 8), np.zeros(8),
                            -E_CHARGE, M_ELECTRON, cfg, device="cpu")


def test_step_reads_qm_on_the_host_once():
    """q/m reach the kernel scalars from the host copy taken when the
    state was built (no device read per step); replacing q or m renews
    it."""
    cfg = implicit.ImplicitConfig(GridSpec(16, 1.0), 1e-9, 1.0)
    st = implicit.init_state(np.linspace(0.0, 0.9, 8), np.zeros(8),
                             -E_CHARGE, M_ELECTRON, cfg, device="cpu")
    assert st.qm_host == (st.q.item(), st.m.item())
    st1, _ = implicit.make_step(cfg)(st)
    assert st1.qm_host is st.qm_host
    heavier = st1.replace(m=st1.m * 2.0)
    assert heavier.qm_host == (st.q.item(), (st.m * 2.0).item())
    per_particle = implicit.init_state(np.linspace(0.0, 0.9, 8), np.zeros(8),
                                       np.full(8, -E_CHARGE), M_ELECTRON, cfg,
                                       device="cpu")
    assert per_particle.qm_host is None


def test_per_particle_qm_needs_composed_backend():
    """Per-particle q/m runs on the composed backend, which 'auto' picks;
    'fused' refuses it."""
    grid = GridSpec(16, 1.0)
    x = np.linspace(0.0, 0.9, 8)
    q = np.full(8, -E_CHARGE)
    cfg = implicit.ImplicitConfig(grid, 1e-9, 1.0)
    st = implicit.init_state(x, np.zeros(8), q, M_ELECTRON, cfg, device="cpu")
    st1, m = implicit.make_step(cfg)(st)
    assert int(st1.step) == 1 and st1.p.shape == (8,)
    assert torch.isfinite(st1.e).all() and torch.isfinite(m.field_energy)
    # the composed step stores the last iterate's full-step current
    assert float(m.current_bias) == float(torch.mean(st1.j))
    fused = dataclasses.replace(cfg, backend="fused")
    with pytest.raises(ValueError, match="scalar q/m"):
        implicit.make_step(fused)(st)


def test_import_leaves_jax_out():
    code = ("import sys, pypic_tpu_torch, pypic_tpu_torch.engines.implicit, "
            "pypic_tpu_torch.engines.explicit, pypic_tpu_torch.push, "
            "pypic_tpu_torch.presets, pypic_tpu_torch.interop, "
            "pypic_tpu_torch.runner, pypic_tpu_torch.diagnostics, "
            "pypic_tpu_torch.ops.cuda_cic, pypic_tpu_torch.tools.two_stream, "
            "pypic_tpu_torch.tools.headline, pypic_tpu_torch.tools.landau; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'pypic_tpu')]; assert not bad, bad")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_sources_import_no_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax|flax|pypic_tpu)\b", re.M)
    files = sorted(f for f in (REPO / "pypic_tpu_torch").rglob("*.py")
                   if "_build" not in f.parts)  # build outputs, not sources
    files.append(REPO / "chip_smoke.py")
    hits = [str(f) for f in files if pat.search(f.read_text())]
    assert not hits, hits
