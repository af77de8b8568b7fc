"""Finite-difference and smoothing operators (the counterpart of
``pypic_tpu/ops/fd.py``).

* ``smooth_periodic``: binomial 1/4 (1, 2, 1) filter with periodic wrap
  (pypic.py:63-76 ``smooth_field_p``).
* ``smooth_bounded``: the same filter keeping the endpoint values
  (PIC_L_DD.py:216-221 ``smoothField``, pygcpic.py:1055-1060
  ``smooth_rho``).
* ``grad_periodic``: centered difference with periodic wrap
  (pypic.py:185-214 ``differentiate_p``).
* ``grad_neg_bounded``: E = -dphi/dx, centered inside and one-sided at
  both walls (PIC_L_DD.py:192-203 ``differentiateField``,
  pygcpic.py:907-937 ``differentiate_phi_to_E_dirichlet``).

* ``integrate_neg_trapz``: phi from E by cumulative negative trapezoid
  (PIC_L_DD.py:205-214 ``integrateField``), as a cumsum.

``differentiate_time_series`` comes with the diagnostics that use it.
"""

from __future__ import annotations

import torch


def smooth_periodic(f: torch.Tensor) -> torch.Tensor:
    return (torch.roll(f, -1) + 2.0 * f + torch.roll(f, 1)) * 0.25


def smooth_bounded(f: torch.Tensor) -> torch.Tensor:
    s = (torch.roll(f, -1) + 2.0 * f + torch.roll(f, 1)) * 0.25
    s[0] = f[0]
    s[-1] = f[-1]
    return s


def grad_periodic(f: torch.Tensor, dx: float) -> torch.Tensor:
    """(f[i+1] - f[i-1]) / (2 dx) with periodic wrap."""
    return (torch.roll(f, -1) - torch.roll(f, 1)) * (0.5 / dx)


def grad_neg_bounded(f: torch.Tensor, dx: float) -> torch.Tensor:
    """-df/dx: centered interior, one-sided first-order at both walls."""
    out = -(torch.roll(f, -1) - torch.roll(f, 1)) * (0.5 / dx)
    out[0] = -(f[1] - f[0]) / dx
    out[-1] = -(f[-1] - f[-2]) / dx
    return out


def integrate_neg_trapz(f: torch.Tensor, dx: float) -> torch.Tensor:
    """IF[i] = -trapz(f[:i+1], dx): cumulative negative trapezoid from node 0."""
    c = torch.cumsum(f, 0)
    return -(c - 0.5 * f[0] - 0.5 * f) * dx
