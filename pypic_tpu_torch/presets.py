"""Named scenario presets (the counterpart of ``pypic_tpu/presets.py``).

Ported so far, with the same defaults:

* ``landau_damping`` — pypic.py:846-855 ("landau-damping best params")
* ``two_stream``     — pypic.py:822-832 (commented two-stream block)
* ``explicit_landau`` — pypic.py:667-677 (gen-3 explicit landau block)
* ``pic_iead``       — pygcpic.py:1120-1200 (magnetized D + B sheath with
  IEAD collection; BASELINE configs[3])

The sheath presets (``sheath_dd``, ``sheath_dn``), ``pic_iead_gc``,
``pic_bca_aps``, ``dirichlet_neumann_test`` and ``cold_beam`` come with
their engines and options.

Every builder takes ``n`` and ``seed`` overrides, and ``device`` for the
state's tensors: the current CUDA device unless it says otherwise (pass
``device='cpu'`` without a card).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np

from .constants import (E_CHARGE, EPSILON_0, EV_TO_K, K_BOLTZMANN,
                        M_ELECTRON, M_PROTON)
from .grid import GridSpec
from . import initialize
from .engines import explicit, implicit, magnetized


@dataclasses.dataclass
class Preset:
    name: str
    engine: Any  # engine module (has make_step)
    config: Any
    state: Any
    meta: Dict[str, Any]

    def make_step(self):
        return self.engine.make_step(self.config)


def _debye(te_kelvin: float, density: float) -> float:
    return float(
        np.sqrt(K_BOLTZMANN * te_kelvin * EPSILON_0 / E_CHARGE**2 / density)
    )


def landau_damping(n: int = 1_000_000, ng: int = 200, seed: int = 1,
                   device=None, **kw) -> Preset:
    """pypic.py:846-855: density 1e5, perturbation 0.8, Kp 1, dt 1e-5,
    Te 100*11600 K, Ti 0.1*11600 K, L = 22 LD; implicit engine with
    tol 1e-3 / maxiter 20 (pypic.py:859-860)."""
    density, te, ti = 1e5, 100.0 * EV_TO_K, 0.1 * EV_TO_K
    length = 22.0 * _debye(te, density)
    grid = GridSpec(ng, length, "periodic")
    x, v, params = initialize.initialize_periodic(
        "landau-damping", n, density, 1, 0.8, grid, te, ti, seed=seed
    )
    cfg = implicit.ImplicitConfig(
        grid, 1e-5, params.p2c, tol=kw.get("tol", 1e-3),
        maxiter=kw.get("maxiter", 20),
    )
    st = implicit.init_state(x, v, -E_CHARGE, M_ELECTRON, cfg, device=device)
    return Preset("landau_damping", implicit, cfg, st,
                  dict(params=params, system="landau-damping"))


def two_stream(n: int = 1_000_000, ng: int = 50, seed: int = 1,
               device=None, **kw) -> Preset:
    """pypic.py:822-832: density 1e10, perturbation 0.2, dt 0.5e-8,
    Ti = Te = 0.1*11600 K, L = 15 LD."""
    density, te, ti = 1e10, 0.1 * EV_TO_K, 0.1 * EV_TO_K
    length = 15.0 * _debye(te, density)
    grid = GridSpec(ng, length, "periodic")
    x, v, params = initialize.initialize_periodic(
        "two-stream", n, density, 1, 0.2, grid, te, ti, seed=seed
    )
    cfg = implicit.ImplicitConfig(
        grid, 0.5e-8, params.p2c, tol=kw.get("tol", 1e-3),
        maxiter=kw.get("maxiter", 20),
    )
    st = implicit.init_state(x, v, -E_CHARGE, M_ELECTRON, cfg, device=device)
    return Preset("two_stream", implicit, cfg, st,
                  dict(params=params, system="two-stream"))


def explicit_landau(n: int = 100_000, ng: int = 100, seed: int = 1,
                    device=None) -> Preset:
    """pypic.py:667-677 (gen-3 explicit landau block): density 1e10,
    perturbation 0.05, Kp 2, dt 1e-8, dx 0.04, Ti = Te = 1*11600 K."""
    density, te, ti = 1e10, 1.0 * EV_TO_K, 1.0 * EV_TO_K
    dx = 0.04
    grid = GridSpec(ng, ng * dx, "periodic")
    x, v, params = initialize.initialize_periodic(
        "landau-damping", n, density, 2, 0.05, grid, te, ti, seed=seed
    )
    cfg = explicit.ExplicitConfig(grid, 1e-8, params.p2c)
    st = explicit.init_state(x, v, -E_CHARGE, M_ELECTRON, cfg, device=device)
    return Preset("explicit_landau", explicit, cfg, st,
                  dict(params=params, system="landau-damping"))


def _floating_potential(te, ti, ion_mass):
    """pygcpic.py:1141."""
    return (te / EV_TO_K) * 0.5 * np.log(
        ion_mass / (2.0 * np.pi * M_ELECTRON) / (1.0 + ti / te)
    )


def pic_iead(n_per_species: int = 1000, ng: int = 600, seed: int = 1,
             device=None) -> Preset:
    """pygcpic.py:1120-1200: D+ plus B 1+..5+ (densities 1e20 and
    [1e11, 1e12, 1e12, 1e11, 1e13]), B = 2 T at 86 deg, dt 1e-10,
    Ti = Te = 10*11600 K, L = 300 LD, Boltzmann D-D walls, IEAD collection,
    always-source re-activation. The same numpy draws as the JAX preset,
    so the initial state is the JAX one's."""
    density = 1e20
    densities_boron = [1e11, 1e12, 1e12, 1e11, 1e13]
    te = ti = 10.0 * EV_TO_K
    length = 300.0 * _debye(te, density)
    grid = GridSpec(ng, length, "dirichlet-dirichlet")
    dt = 1e-10
    p2c = density * length / n_per_species
    p2cs_b = [d * length / n_per_species for d in densities_boron]
    alpha = 86.0 * np.pi / 180.0
    b = (2.0 * np.cos(alpha), 2.0 * np.sin(alpha), 0.0)

    rng = np.random.default_rng(seed)
    groups = [(2.0 * M_PROTON, 1.0, p2c, 0)] + [
        (10.81 * M_PROTON, float(cs), p2cs_b[cs - 1], 1) for cs in range(1, 6)
    ]
    n = n_per_species * len(groups)
    x = rng.uniform(0.0, length, n)
    m = np.concatenate([np.full(n_per_species, g[0]) for g in groups])
    cs = np.concatenate([np.full(n_per_species, g[1]) for g in groups])
    p2c_arr = np.concatenate([np.full(n_per_species, g[2]) for g in groups])
    sp = np.concatenate(
        [np.full(n_per_species, g[3], np.int32) for g in groups]
    )
    vth = np.sqrt(K_BOLTZMANN * ti / m)
    v = rng.normal(size=(n, 3)) * vth[:, None]

    phi_f = _floating_potential(te, ti, 2.0 * M_PROTON)
    src = magnetized.SourceSpec(
        mass=M_PROTON, charge_state=1.0, p2c=p2c, species_idx=0, ti=ti
    )
    cfg = magnetized.MagnetizedConfig(
        grid, dt, te, b=b, species_z=(1, 5), reactivate="source", source=src,
        iead_energy_max=4.0 * phi_f,
    )
    st = magnetized.init_state(x, v, m, cs, p2c_arr, sp, cfg, seed=seed,
                               device=device)
    return Preset("pic_iead", magnetized, cfg, st,
                  dict(floating_potential=phi_f,
                       bca_incident=((2.0, 1), (10.81, 5)),
                       species_labels=("D", "B")))
