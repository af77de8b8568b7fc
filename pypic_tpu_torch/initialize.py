"""Scenario initialization: plasma parameters and particle loading.

Rebuilds the L6 initializers:

* ``derive_plasma``: plasma frequency, Debye length, p2c, thermal speed and
  the analytic growth/damping rate per scenario (pypic.py:415-455).
* ``initialize_periodic``: the gen-3 single-species electron loader
  (pypic.py:384-470 ``initialize_p``): velocity distributions for
  'two-stream' / 'bump-on-tail' / 'landau-damping' plus the cosine spatial
  perturbation applied by resampling ``int(F[i])`` particles into cell i with
  F proportional to 1 + cos(K X) (pypic.py:457-467) — vectorized with
  ``np.repeat`` instead of the reference's nested Python loops.

* ``initialize_sheath``: the gen-2 bounded two-species loader
  (PIC_L_DD.py:223-314, 'beam' system): electrons in the first half of
  the slots, ions in the second, Maxwellian 1d3v velocities per species.

Initialization is host-side numpy (it runs once per simulation) and makes
the same RNG calls as ``pypic_tpu.initialize``, so one seed gives one load
in both packages. Reproducibility comes from an explicit seed instead of
the reference's global ``np.random.seed(1)`` (pypic.py:654).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .constants import EPSILON_0, E_CHARGE, K_BOLTZMANN, M_ELECTRON, M_PROTON
from .grid import GridSpec

TWO_STREAM = "two-stream"
BUMP_ON_TAIL = "bump-on-tail"
LANDAU_DAMPING = "landau-damping"
BEAM = "beam"


@dataclasses.dataclass(frozen=True)
class PlasmaParams:
    """Derived plasma parameters (pypic.py:415-423)."""

    wp: float  # electron plasma frequency [rad/s]
    k: float  # perturbation wavenumber [1/m]
    p2c: float  # physical per computational particle
    kbte: float  # kB Te [J]
    kbti: float  # kB Ti [J]
    v_thermal: float  # sqrt(2 kB Te / me) [m/s]
    debye: float  # Debye length [m]
    growth_rate: float  # analytic instability growth (or Landau damping) rate [1/s]


def derive_plasma(system: str, n: int, density: float, kp: float, te: float,
                  ti: float, length: float, periodic: bool = True) -> PlasmaParams:
    wp = np.sqrt(E_CHARGE**2 * density / EPSILON_0 / M_ELECTRON)
    # Periodic gen-3 uses K = Kp 2 pi / L (pypic.py:418); bounded gen-2 uses
    # K = Kp pi / L (PIC_L_DD.py:226).
    k = kp * (2.0 * np.pi if periodic else np.pi) / length
    p2c = length * density / n
    kbte = K_BOLTZMANN * te
    kbti = K_BOLTZMANN * ti
    v_thermal = np.sqrt(2.0 * kbte / M_ELECTRON)
    debye = np.sqrt(kbte * EPSILON_0 / E_CHARGE / E_CHARGE / density)

    vte = np.sqrt(kbte / M_ELECTRON)
    if system == BUMP_ON_TAIL:
        beam = n * 1 // 6
        plasma = n * 5 // 6
        growth = np.sqrt(3.0) / 2.0 * wp * (float(beam) / float(plasma) / 2.0) ** (1.0 / 3.0)
    elif system == TWO_STREAM:
        growth = np.sqrt(3.0) / 2.0 * wp * (0.5) ** (1.0 / 3.0)
    elif system == LANDAU_DAMPING:
        growth = (
            -np.sqrt(np.pi)
            * wp
            * (wp / k / v_thermal) ** 3
            * np.exp(-1.0 / (2.0 * k**2 * debye**2) - 3.0 / 2.0)
        )
    elif system == BEAM:
        # PIC_L_DD.py:277 (its 'landau-like' printout rate).
        growth = (
            -np.sqrt(np.pi)
            * wp**4
            / k**3
            / vte**3
            * np.exp(-(wp**2) / k**2 / vte**2 * np.exp(-3.0 / 2.0))
        )
    else:
        raise ValueError(f"unknown system {system!r}")

    return PlasmaParams(wp, k, p2c, kbte, kbti, v_thermal, debye, growth)


def _cosine_perturbation(rng, x0, n, perturbation, k, grid: GridSpec, start: int = 0):
    """Resample ~n*perturbation particles into cells weighted by 1 + cos(Kx)
    (pypic.py:457-467), vectorized."""
    ng = grid.ng
    edges = np.linspace(0.0, grid.length, ng + 1)
    f = 1.0 + np.cos(k * edges)
    f = (n * perturbation) * f / np.sum(f)
    counts = f[:ng].astype(int)
    total = int(counts.sum())
    if total == 0:
        return x0
    cells = np.repeat(np.arange(ng), counts)
    lo = edges[cells]
    hi = edges[cells + 1]
    stop = min(start + total, n)
    x0[start:stop] = rng.uniform(lo, hi)[: stop - start]
    return x0


def initialize_periodic(
    system: str,
    n: int,
    density: float,
    kp: float,
    perturbation: float,
    grid: GridSpec,
    te: float,
    ti: float,
    seed: int = 1,
):
    """Gen-3 periodic single-species loader (pypic.py:384-470).

    Returns:
        (x [m], v [m/s], params) — all particles are electrons
        (m = me, q = -e, pypic.py:425-426).
    """
    rng = np.random.default_rng(seed)
    params = derive_plasma(system, n, density, kp, te, ti, grid.length, periodic=True)
    vte = np.sqrt(params.kbte / M_ELECTRON)

    v0 = np.zeros(n)
    if system == BUMP_ON_TAIL:
        plasma = n * 5 // 6
        beam_temperature = 1.0 / 20.0
        beam_drift = 4.0
        v0[:plasma] = rng.normal(0.0, vte, plasma)
        v0[plasma:] = rng.normal(beam_drift * vte, beam_temperature * vte, n - plasma)
    elif system == TWO_STREAM:
        half = n // 2
        beam_temperature = 0.5
        beam_drift = 2.0
        v0[:half] = rng.normal(-beam_drift * vte, beam_temperature * vte, half)
        v0[half:] = rng.normal(beam_drift * vte, beam_temperature * vte, n - half)
    elif system == LANDAU_DAMPING:
        v0 = rng.normal(0.0, params.v_thermal / np.sqrt(2.0), n)
    else:
        raise ValueError(f"unknown periodic system {system!r}")

    x0 = rng.uniform(0.0, grid.length, n)
    x0 = _cosine_perturbation(rng, x0, n, perturbation, params.k, grid)
    return x0, v0, params


def initialize_sheath(
    n: int,
    density: float,
    kp: float,
    perturbation: float,
    grid: GridSpec,
    te: float,
    ti: float,
    seed: int = 1,
    ion_mass: float = M_PROTON,
):
    """Gen-2 two-species 1d3v loader (PIC_L_DD.py:223-314, 'beam' system).

    Returns:
        dict with x [m], v (n,3) [m/s], m, q [C], species (1=electron, 2=ion),
        and params. The first n//2 slots are electrons, the rest ions
        (PIC_L_DD.py:235-241).
    """
    rng = np.random.default_rng(seed)
    params = derive_plasma(BEAM, n, density, kp, te, ti, grid.length, periodic=False)
    half = n // 2

    m = np.empty(n)
    q = np.empty(n)
    species = np.empty(n, dtype=np.int32)
    m[:half] = M_ELECTRON
    q[:half] = -E_CHARGE
    species[:half] = 1
    m[half:] = ion_mass
    q[half:] = E_CHARGE
    species[half:] = 2

    v = np.empty((n, 3))
    for c in range(3):
        v[:half, c] = rng.normal(0.0, np.sqrt(params.kbte / m[:half]))
        v[half:, c] = rng.normal(0.0, np.sqrt(params.kbti / m[half:]))

    x0 = rng.uniform(0.0, grid.length, n)
    # PIC_L_DD.py:298-307: perturbation resampling starts mid-population.
    start = half - int(n * perturbation / 2)
    x0 = _cosine_perturbation(rng, x0, n, perturbation, params.k, grid, start=start)

    return dict(x=x0, v=v, m=m, q=q, species=species, params=params)
