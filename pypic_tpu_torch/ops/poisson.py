"""Field solvers (the counterpart of ``pypic_tpu/ops/poisson.py``).

* ``solve_periodic_neutralized``: the periodic (1, -2, 1) Laplacian is
  circulant, so the reference's direct sparse solve (pypic.py:359-382)
  becomes an FFT diagonalization — exact for the same discrete operator.
* ``solve_dirichlet``: linear Dirichlet solve (pygcpic.py:987-1003) via
  Thomas.
* ``solve_boltzmann_dirichlet``: Newton iteration on
  F = A phi - dx^2 (e n0/eps0) exp(e phi / kB Te) + dx^2 rho/eps0 with
  Dirichlet-Dirichlet walls (pygcpic.py:1005-1053), each Newton step an
  exact Thomas solve of the tridiagonal Jacobian. This is the op-composed
  route (``newton_backend='xla'`` of the magnetized engine): its loop runs
  on the host and reads the residual once an iteration. The engine's
  default is the whole loop in one kernel, ``ops.cuda_newton``.

The Dirichlet-Neumann and gen-1 Newton solvers come with the magnetized
stack's next slice and the sheath engine.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..constants import EPSILON_0, E_CHARGE, K_BOLTZMANN
from .tridiag import solve_tridiag


class NewtonResult(NamedTuple):
    phi: torch.Tensor
    iterations: torch.Tensor  # int32 scalar
    residual: torch.Tensor  # float scalar


# Newton globalization (pypic_tpu/ops/poisson.py): the exponent argument
# and each Newton step are clamped, which bounds every intermediate while
# leaving any physical fixed point (|e phi / kB Te| << 40) untouched.
_EXP_CLAMP = 40.0


def _safe_exp(x):
    return torch.exp(torch.clamp(x, -_EXP_CLAMP, _EXP_CLAMP))


def solve_periodic_neutralized(rho: torch.Tensor, dx: float) -> torch.Tensor:
    """Periodic Poisson with neutralizing background (pypic.py:359-382).

    Solves A phi = -dx^2 (rho - <rho>) / eps0 spectrally; returns the
    zero-mean representative of the gauge family.
    """
    ng = rho.shape[0]
    b = -(dx * dx) * (rho - torch.mean(rho)) / EPSILON_0
    k = torch.arange(ng // 2 + 1, dtype=rho.dtype, device=rho.device)
    eig = 2.0 * torch.cos(2.0 * math.pi * k / ng) - 2.0
    bh = torch.fft.rfft(b)
    nonzero = eig != 0.0
    inv = torch.where(nonzero, 1.0 / torch.where(nonzero, eig, 1.0), 0.0)
    return torch.fft.irfft(bh * inv, n=ng).to(rho.dtype)


def _dirichlet_diagonals(ng, dtype, device=None):
    """Laplacian with identity boundary rows (pygcpic.py:939-956)."""
    dl = torch.ones((ng,), dtype=dtype, device=device)
    dl[-1] = 0.0
    d = torch.full((ng,), -2.0, dtype=dtype, device=device)
    d[0] = 1.0
    d[-1] = 1.0
    du = torch.ones((ng,), dtype=dtype, device=device)
    du[0] = 0.0
    return dl, d, du


def _apply_dirichlet_laplacian(phi, dl, d, du):
    """A @ phi for the tridiagonal stored as (dl, d, du)."""
    up = torch.roll(phi, -1)
    up[-1] = 0.0
    down = torch.roll(phi, 1)
    down[0] = 0.0
    return dl * down + d * phi + du * up


def solve_dirichlet(rho, dx):
    """Linear Dirichlet solve phi = -A^{-1} rho dx^2, shifted to min 0
    (pygcpic.py:987-1003)."""
    dl, d, du = _dirichlet_diagonals(rho.shape[0], rho.dtype, rho.device)
    phi = -solve_tridiag(dl, d, du, rho) * (dx * dx)
    return phi - torch.min(phi)


def solve_boltzmann_dirichlet(rho, n0, te, dx, tol=1e-9, maxiter=1000,
                              phi0=None):
    """Newton solve of the Boltzmann-electron Poisson equation with
    Dirichlet-Dirichlet walls (pygcpic.py:1005-1053).

    Args:
        rho: (ng,) ion charge density [C/m^3].
        n0: Boltzmann electron reference density [1/m^3] (float or 0-d
            tensor).
        te: electron temperature [K].
        dx: grid spacing [m].
        phi0: optional warm start. Its wall entries are pinned to 0: the
            frozen boundary rows never move the walls, so an unpinned warm
            start would carry the previous step's min-shifted wall value
            into the answer (see the JAX docstring).

    Returns:
        NewtonResult(phi shifted to min 0, iterations, residual |dphi|^2).
    """
    ng = rho.shape[0]
    dtype, dev = rho.dtype, rho.device
    dl, d, du = _dirichlet_diagonals(ng, dtype, dev)
    dx2 = dx * dx
    c0 = E_CHARGE * torch.as_tensor(n0, dtype=dtype, device=dev) / EPSILON_0
    c1 = E_CHARGE / (K_BOLTZMANN * te)
    c2 = rho / EPSILON_0
    step_max = _EXP_CLAMP / c1  # bounds each Newton step (globalization)
    # the residual test compares float32 values, as the JAX loop does
    tol_d = float(torch.tensor(tol, dtype=dtype))

    if phi0 is None:
        phi = torch.zeros((ng,), dtype=dtype, device=dev)
    else:
        phi = phi0.to(dtype).clone()
        phi[0] = 0.0
        phi[-1] = 0.0
    residual = torch.ones((), dtype=dtype, device=dev)
    it = 0
    while residual.item() > tol_d and it < maxiter:
        expo = _safe_exp(c1 * phi)
        f = _apply_dirichlet_laplacian(phi, dl, d, du) - dx2 * c0 * expo + dx2 * c2
        f[0] = 0.0
        f[-1] = 0.0
        ddiag = -dx2 * c0 * c1 * expo
        ddiag[0] = -dx2 * c0 * c1
        ddiag[-1] = -dx2 * c0 * c1
        dphi = torch.clamp(solve_tridiag(dl, d + ddiag, du, f), -step_max,
                           step_max)
        phi = phi - dphi
        residual = torch.dot(dphi, dphi)
        it += 1
    return NewtonResult(phi - torch.min(phi),
                        torch.tensor(it, dtype=torch.int32, device=dev),
                        residual)
