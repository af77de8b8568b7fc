"""Named scenario presets (the counterpart of ``pypic_tpu/presets.py``).

Ported so far, with the same defaults:

* ``landau_damping`` — pypic.py:846-855 ("landau-damping best params")
* ``two_stream``     — pypic.py:822-832 (commented two-stream block)
* ``explicit_landau`` — pypic.py:667-677 (gen-3 explicit landau block)

Every builder takes ``n`` and ``seed`` overrides, and ``device`` for the
state's tensors: the current CUDA device unless it says otherwise (pass
``device='cpu'`` without a card).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np

from .constants import E_CHARGE, EPSILON_0, EV_TO_K, K_BOLTZMANN, M_ELECTRON
from .grid import GridSpec
from . import initialize
from .engines import explicit, implicit


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
