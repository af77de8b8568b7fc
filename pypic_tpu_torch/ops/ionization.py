"""Monte-Carlo-collision electron-impact ionization (the counterpart of
``pypic_tpu/ops/ionization.py``; pygcpic.py:350-458).

* The rate coefficients R(Te) per (Z, charge state) are the reference's
  published tables (hydrogen's first ionization, boron's charge states
  0-2; pygcpic.py:362-380, 411-439), converted eV -> K and cm^3/s ->
  m^3/s as pygcpic.py:382-383 and 441-442 do. The electron temperature is
  constant in a run, so each coefficient is one host-side ``np.interp``
  at config time (``rate_matrix``, float64).
* The probability is n_local^2 R dx dt / p2c with the local density
  gathered from the deposited number density (pygcpic.py:387-392); a
  uniform below it raises the charge state by one and credits the
  Boltzmann-electron ledger with 2 p2c (pygcpic.py:396-398, 1115-1117).

``attempt_ionization`` takes its uniforms as an argument: the engine draws
them with ``ops.cuda_rng.philox_uniforms`` (``ION_TAG``), the tests pass
the JAX engine's. Its arithmetic is the JAX function's float32 scaling:
the 1e20 rescale folded into the float64 table on the host, cast once to
the density's dtype, then (n 1e-10)^2 on the device (n ~ 1e19-1e20 m^-3
would overflow float32 squared).

The reference gates ``attempt_nth_ionization`` on ``charge_state == 0``
(pygcpic.py:455), so its boron never reaches 2+; as in the JAX package,
the gate here is per charge state, and ``max_charge_state=1`` gives the
reference's behaviour.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import EV_TO_K

# (Z, charge_state) -> (Te [eV], R [cm^3/s]); pygcpic.py:362-380, 411-439.
_TABLES = {
    (1, 0): (
        [8.626e-01, 1.011e00, 2.178e00, 3.539e00, 5.146e00, 7.069e00,
         9.410e00, 1.231e01, 1.598e01, 2.076e01, 2.720e01, 3.625e01,
         4.973e01, 7.133e01, 1.099e02, 1.904e02, 4.079e02, 1.355e03,
         1.390e04, 8.595e04],
        [7.553e-16, 8.291e-15, 1.714e-11, 2.470e-10, 9.985e-10, 2.398e-09,
         4.412e-09, 6.940e-09, 9.869e-09, 1.309e-08, 1.649e-08, 1.996e-08,
         2.329e-08, 2.624e-08, 2.834e-08, 2.881e-08, 2.627e-08, 1.926e-08,
         8.109e-09, 3.829e-09],
    ),
    (5, 0): (
        [8.626e-01, 1.329e00, 2.160e00, 3.140e00, 4.314e00, 5.741e00,
         7.508e00, 9.746e00, 1.267e01, 1.660e01, 2.212e01, 3.034e01,
         4.353e01, 6.704e01, 1.162e02, 2.490e02, 8.265e02, 8.481e03,
         8.669e04],
        [1.057e-12, 3.996e-11, 5.912e-10, 2.458e-09, 6.083e-09, 1.155e-08,
         1.878e-08, 2.767e-08, 3.806e-08, 4.979e-08, 6.257e-08, 7.590e-08,
         8.901e-08, 1.005e-07, 1.080e-07, 1.079e-07, 9.470e-08, 5.161e-08,
         2.159e-08],
    ),
    (5, 1): (
        [8.612e-01, 1.869e00, 4.028e00, 6.547e00, 9.522e00, 1.308e01,
         1.741e01, 2.276e01, 2.956e01, 3.840e01, 5.031e01, 6.707e01,
         9.203e01, 1.319e02, 2.033e02, 3.522e02, 7.547e02, 2.505e03,
         2.571e04, 8.582e04],
        [1.375e-21, 1.396e-14, 2.693e-11, 3.643e-10, 1.393e-09, 3.188e-09,
         5.629e-09, 8.554e-09, 1.182e-08, 1.533e-08, 1.900e-08, 2.273e-08,
         2.639e-08, 2.972e-08, 3.221e-08, 3.300e-08, 3.032e-08, 2.252e-08,
         9.306e-09, 5.538e-09],
    ),
    (5, 2): (
        [1.366e00, 2.819e00, 6.073e00, 9.875e00, 1.436e01, 1.972e01,
         2.624e01, 3.432e01, 4.456e01, 5.790e01, 7.587e01, 1.012e02,
         1.387e02, 1.990e02, 3.064e02, 5.311e02, 1.138e03, 3.778e03,
         3.877e04, 8.602e04],
        [1.230e-21, 2.871e-15, 5.524e-12, 7.439e-11, 2.824e-10, 6.401e-10,
         1.117e-09, 1.677e-09, 2.293e-09, 2.946e-09, 3.629e-09, 4.337e-09,
         5.055e-09, 5.759e-09, 6.382e-09, 6.779e-09, 6.575e-09, 5.269e-09,
         2.483e-09, 1.829e-09],
    ),
}

MAX_CS = 3  # rate rows per Z in the lookup matrix


def rate_coefficient(z: int, charge_state: int, te_kelvin: float) -> float:
    """Host-side R(Te) [m^3/s] for one (Z, charge_state); 0 if untabulated."""
    key = (int(z), int(charge_state))
    if key not in _TABLES:
        return 0.0
    te_ev, r_cm3 = _TABLES[key]
    te_k = np.asarray(te_ev) * EV_TO_K
    r_m3 = np.asarray(r_cm3) / 1e6
    return float(np.interp(te_kelvin, te_k, r_m3))


def rate_matrix(zs, te_kelvin: float) -> np.ndarray:
    """(len(zs), MAX_CS) float64 matrix of R [m^3/s] for the run's species
    list; row i column c is the rate of species zs[i] at charge state c."""
    out = np.zeros((len(zs), MAX_CS))
    for i, z in enumerate(zs):
        for c in range(MAX_CS):
            out[i, c] = rate_coefficient(z, c, te_kelvin)
    return out


def coefficient_table(rates, dx: float, dt: float, dtype: torch.dtype,
                      device) -> torch.Tensor:
    """R dx dt 1e20 per (species, charge state), folded in float64 on the
    host and cast once to ``dtype`` (ionization.py:126-132). The table is
    filled on ``device`` entry by entry, each a scalar fill: on a card a
    copy from the host would synchronize."""
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    table = (np.asarray(rates, np.float64) * float(dx) * float(dt)
             * 1e20).astype(np_dtype)
    out = torch.empty(table.shape, dtype=dtype, device=device)
    for idx, value in np.ndenumerate(table):
        out[idx].fill_(float(value))
    return out


def attempt_ionization(n_local, charge_state, species_idx, p2c, table,
                       active, draw, max_charge_state: int = MAX_CS):
    """Vectorized MCC ionization attempt (pygcpic.py:385-398, 444-458).

    Args:
        n_local: (n,) number density at the particles.
        charge_state: (n,) charge numbers (float).
        species_idx: (n,) int32 rows of ``rates``.
        p2c: (n,) physical-per-computational ratio.
        table: the ``coefficient_table`` of the run's ``rate_matrix``, dx
            and dt, on the particles' device (the engine makes it once).
        active: (n,) bool mask.
        draw: (n,) uniforms in [0, 1).
        max_charge_state: only cs < max_charge_state can ionize.

    Returns:
        (new_charge_state, ionized_mask, added_p2c): added_p2c is the 0-d
        ledger credit sum(2 p2c) over the ionized rows.
    """
    cs = torch.clamp(charge_state.to(torch.int32), 0, MAX_CS - 1)
    coef = table[species_idx.to(torch.int64), cs.to(torch.int64)]
    n_scaled = n_local * 1e-10
    prob = n_scaled * n_scaled * coef / torch.clamp(p2c, min=1e-30)
    can = active & (charge_state < max_charge_state) & (coef > 0.0)
    ionized = can & (draw < prob)
    new_cs = torch.where(ionized, charge_state + 1.0, charge_state)
    added = torch.sum(torch.where(ionized, 2.0 * p2c, 0.0))
    return new_cs, ionized, added
