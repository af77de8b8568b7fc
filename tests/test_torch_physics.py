"""Physics acceptance tests of the port's engines on the CPU (the plain
kernel versions), with the thresholds of tests/test_engines.py: two-stream
growth rate against the cold-beam dispersion relation for the implicit and
the explicit engine, the Landau damping rate of the implicit engine, and
total-energy conservation at a tight Picard tolerance.
"""

import numpy as np
import pytest
import torch

from pypic_tpu_torch import initialize as init
from pypic_tpu_torch.constants import E_CHARGE, EPSILON_0, K_BOLTZMANN, M_ELECTRON
from pypic_tpu_torch.diagnostics import damping_rate_from_peaks, growth_rate_from_energy
from pypic_tpu_torch.engines import explicit, implicit
from pypic_tpu_torch.grid import GridSpec
from pypic_tpu_torch.runner import run


def _two_stream_setup(n=20_000, ng=64):
    density = 1e10
    te = 0.1 * 11600.0
    debye = np.sqrt(K_BOLTZMANN * te * EPSILON_0 / E_CHARGE**2 / density)
    grid = GridSpec(ng, 15.0 * debye, "periodic")
    x, v, params = init.initialize_periodic(
        "two-stream", n, density, 1, 0.05, grid, te, te, seed=2
    )
    return grid, x, v, params


def _two_stream_dispersion_gamma(params):
    """Cold symmetric two-stream growth rate at the loaded k and drift:
    gamma^2/wp^2 = sqrt(1 + 8 x^2)/2 - x^2 - 1/2 with x = k v0 / wp."""
    vte = params.v_thermal / np.sqrt(2.0)
    x = params.k * (2.0 * vte) / params.wp
    g2 = np.sqrt(1.0 + 8.0 * x * x) / 2.0 - x * x - 0.5
    assert g2 > 0, "chosen k is outside the unstable band"
    return params.wp * np.sqrt(g2)


def test_two_stream_growth_implicit():
    grid, x, v, params = _two_stream_setup()
    dt = 0.1 / params.wp
    cfg = implicit.ImplicitConfig(grid, dt, params.p2c, tol=1e-3, maxiter=20)
    st = implicit.init_state(x, v, -E_CHARGE, M_ELECTRON, cfg, device="cpu")
    _, m = run(implicit.make_step(cfg), st, 400)
    ee = m.field_energy.double().numpy()
    i1 = int(np.argmax(ee > 0.5 * ee.max()))
    assert i1 - int(np.argmin(ee[:i1])) > 10, "growth window too small"
    ratio = growth_rate_from_energy(ee, dt) / _two_stream_dispersion_gamma(params)
    assert 0.6 < ratio < 1.3, f"growth ratio {ratio}"


def test_two_stream_growth_explicit():
    """test_engines.py:71-79 for the port: the explicit engine (one-kernel
    branch, ng = 64) grows the two-stream mode at the dispersion rate."""
    grid, x, v, params = _two_stream_setup()
    dt = 0.1 / params.wp
    cfg = explicit.ExplicitConfig(grid, dt, params.p2c)
    st = explicit.init_state(x, v, -E_CHARGE, M_ELECTRON, cfg, device="cpu")
    _, m = run(explicit.make_step(cfg), st, 400)
    ee = m.field_energy.double().numpy()
    i1 = int(np.argmax(ee > 0.5 * ee.max()))
    assert i1 - int(np.argmin(ee[:i1])) > 10, "growth window too small"
    ratio = growth_rate_from_energy(ee, dt) / _two_stream_dispersion_gamma(params)
    assert 0.6 < ratio < 1.3, f"growth ratio {ratio}"


@pytest.mark.slow  # ~4 s on the CPU: 2000 steps of ~8 Picard passes
def test_implicit_energy_conservation():
    """Total energy holds to < 5e-5 over 2000 steps at float32 and a tight
    Picard tolerance."""
    grid, x, v, params = _two_stream_setup(n=10_000, ng=64)
    dt = 0.1 / params.wp
    cfg = implicit.ImplicitConfig(grid, dt, params.p2c, tol=1e-8, maxiter=50)
    st = implicit.init_state(x, v, -E_CHARGE, M_ELECTRON, cfg, device="cpu")
    _, m = run(implicit.make_step(cfg), st, 2000)
    tot = m.field_energy.double().numpy() + m.kinetic_energy.double().numpy()
    drift = abs(tot[-1] - tot[0]) / tot[0]
    assert drift < 5e-5, f"energy drift {drift}"


def test_conserving_config_holds_energy_short_run():
    """The headline conserving configuration (fixed 4 Picard passes,
    extrapolated init, Anderson) on a small Landau load: 50 steps hold
    total energy to 1e-4, with exactly 4 passes a step."""
    from pypic_tpu_torch import presets

    pre = presets.landau_damping(n=4000, device="cpu")
    cfg = implicit.ImplicitConfig(
        pre.config.grid, pre.config.dt, pre.config.p2c, tol=1e-30, maxiter=4,
        picard_init="extrapolate", picard_accel="anderson")
    _, m = run(implicit.make_step(cfg), pre.state, 50)
    tot = m.field_energy.double() + m.kinetic_energy.double()
    assert torch.isfinite(tot).all()
    assert float(abs(tot[-1] - tot[0]) / tot[0]) < 1e-4
    assert (m.picard_iters == 4).all()


def test_landau_damping_rate_implicit():
    """test_engines.py:82-109 for the port: kLD = 0.5, gamma = -0.153 wp,
    through the per-step implicit path (~3 s on the CPU)."""
    density = 1e10
    te = 1.0 * 11600.0
    debye = np.sqrt(K_BOLTZMANN * te * EPSILON_0 / E_CHARGE**2 / density)
    grid = GridSpec(64, 4.0 * np.pi * debye, "periodic")
    x, v, params = init.initialize_periodic(
        "landau-damping", 400_000, density, 1, 0.1, grid, te, te, seed=4)
    dt = 0.1 / params.wp
    cfg = implicit.ImplicitConfig(grid, dt, params.p2c, tol=1e-4, maxiter=20)
    st = implicit.init_state(x, v, -E_CHARGE, M_ELECTRON, cfg, device="cpu")
    _, m = run(implicit.make_step(cfg), st, 160)
    # peak envelope (E^2 oscillates at 2 w_pe) before the noise floor
    gamma = damping_rate_from_peaks(m.field_energy, dt, t_max=15.0 / params.wp)
    ratio = gamma / params.growth_rate  # both negative
    assert 0.7 < ratio < 1.4, f"damping ratio {ratio}"
