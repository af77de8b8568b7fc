"""The one-launch Newton-Boltzmann solves (the counterpart of
``pypic_tpu/ops/pallas_newton.py``).

``boltzmann_dirichlet`` replaces ``boltzmann_dirichlet_pallas``: the whole
Newton loop of ``ops.poisson.solve_boltzmann_dirichlet`` with
Dirichlet-Dirichlet walls (pygcpic.py:1005-1053) in one launch of the
kernel in ``csrc/newton.cu``, each Newton step a parallel-cyclic-reduction
(PCR) solve of the tridiagonal Jacobian. It returns
``NewtonResult(phi, iterations, residual)`` as tensors on the input's
device and reads nothing back to the host, so a step that calls it makes
no host sync. Converged phi agrees with the Thomas route to the Newton
tolerance, not bit for bit (PCR sums in another order).

``boltzmann_dirichlet_plain`` is the same PCR loop as tensor operations
(``_pcr_solve``, pallas_newton.py:65-90), its loop test read on the host.

``boltzmann_dn`` replaces ``boltzmann_dn_pallas``: the Newton loop of
``ops.poisson.solve_boltzmann_dirichlet_neumann`` (pygcpic.py:1062-1109)
on the number density, the one-sided Neumann row's rank-1 entry solved
by Sherman-Morrison on a PCR with two right-hand sides, in one launch of
the second kernel in ``csrc/newton.cu``. ``boltzmann_dn_plain`` is its
loop as tensor operations, in the kernel's order.

Dispatch and launch counting follow ``ops/cuda_cic.py``: CUDA tensors
launch the kernel, CPU tensors run the plain version, anything else
raises; each launch adds one to ``cuda_cic.LAUNCHES['boltzmann_dirichlet']``
or ``['boltzmann_dn']``. The kernels take ng <= ``MAX_NG`` (one CTA, a row
a thread); the plain versions take any ng, and the engines take the
op-composed Thomas routes of ``ops.poisson`` on the card above it (the
large-grid kernel is ROADMAP item 10).
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import EPSILON_0, E_CHARGE, K_BOLTZMANN
from . import _build
from .cuda_cic import LAUNCHES, _check_1d, _device_kind, _stream
from .poisson import NewtonResult, _EXP_CLAMP

_LANE = 128  # the smallest padded row count, as on the TPU
MAX_NG = 1024  # one CTA, one row a thread
_COEF = float(np.float32(E_CHARGE / EPSILON_0))  # f32(e / eps0)


def padded_rows(ng: int) -> int:
    """Rows of the PCR system: the next power of two >= ng, at least 128
    (pallas_newton.py's ngp)."""
    return max(_LANE, 1 << (ng - 1).bit_length())


def newton_scalars(te: float, dx: float, tol: float):
    """(c1, dx^2, tol, step_max) as the JAX wrapper forms them: float64 on
    the host, rounded to float32 once. Each a Python float."""
    f32 = np.float32
    c1 = float(E_CHARGE / (K_BOLTZMANN * float(te)))
    dx2 = float(dx) * float(dx)
    return (float(f32(c1)), float(f32(dx2)), float(f32(tol)),
            float(f32(_EXP_CLAMP / c1)))


def _shift_down(x, s, fill):
    """x_{i-s} along the last axis, ``fill`` where i - s < 0."""
    pad = torch.full(x.shape[:-1] + (s,), fill, dtype=x.dtype, device=x.device)
    return torch.cat([pad, x[..., :-s]], dim=-1)


def _shift_up(x, s, fill):
    """x_{i+s} along the last axis, ``fill`` where i + s >= len(x)."""
    pad = torch.full(x.shape[:-1] + (s,), fill, dtype=x.dtype, device=x.device)
    return torch.cat([x[..., s:], pad], dim=-1)


def _pcr_solve(a, b, c, f):
    """Parallel cyclic reduction of a_i x_{i-1} + b_i x_i + c_i x_{i+1} =
    f_i over len(a) rows (a power of two; rows past the physical ones are
    identity rows). ``f`` is (ngp,) or (R, ngp): R right-hand sides that
    share the elimination coefficients."""
    ngp = a.shape[0]
    s = 1
    while s < ngp:
        am, bm, fm, cm = (_shift_down(a, s, 0.0), _shift_down(b, s, 1.0),
                          _shift_down(f, s, 0.0), _shift_down(c, s, 0.0))
        ap, bp, fp, cp = (_shift_up(a, s, 0.0), _shift_up(b, s, 1.0),
                          _shift_up(f, s, 0.0), _shift_up(c, s, 0.0))
        alpha = -a / bm
        gamma = -c / bp
        b = b + alpha * cm + gamma * ap
        f = f + alpha * fm + gamma * fp
        a = alpha * am
        c = gamma * cp
        s *= 2
    return f / b


def _check_rows(what: str, ng: int) -> None:
    """The card's limit: one CTA, a row a thread."""
    if ng > MAX_NG:
        raise ValueError(
            f"{what} needs ng <= {MAX_NG} on the card (one CTA, a row a "
            f"thread), got ng={ng}; the large-grid kernel is ROADMAP.md "
            "queue 1, item 10")


def _as_n0(n0, dev) -> torch.Tensor:
    """n0 as a (1,) float32 tensor on ``dev`` (a device tensor stays on the
    device: no host read)."""
    if isinstance(n0, torch.Tensor):
        if n0.device != dev:
            raise ValueError(f"n0 lies on {n0.device}, rho on {dev}")
        return n0.reshape(1).to(torch.float32)
    return torch.full((1,), float(n0), dtype=torch.float32, device=dev)


def _start(rho, phi0):
    ng = rho.shape[0]
    if phi0 is None:
        return torch.zeros((ng,), dtype=torch.float32, device=rho.device)
    start = phi0.to(torch.float32).clone()
    start[0] = 0.0
    start[-1] = 0.0
    return start


def boltzmann_dirichlet_plain(rho, n0, te, dx, tol=1e-9, maxiter=1000,
                              phi0=None):
    """The kernel's Newton loop as tensor operations (pallas_newton.py
    _newton_dd_kernel), in its operation order. Returns NewtonResult."""
    ng = rho.shape[0]
    dev = rho.device
    ngp = padded_rows(ng)
    c1, dx2, tol32, step_max = newton_scalars(te, dx, tol)
    c0 = _COEF * _as_n0(n0, dev)[0]
    col = torch.arange(ngp, device=dev)
    valid = col < ng
    interior = (col >= 1) & (col <= ng - 2)
    boundary = valid & ~interior
    a_lap = interior.to(torch.float32)
    c_lap = a_lap
    d_lap = torch.where(interior, -2.0, 1.0)
    pad = ngp - ng
    zeros = torch.zeros((pad,), dtype=torch.float32, device=dev)
    c2 = torch.cat([rho / float(np.float32(EPSILON_0)), zeros])
    phi = torch.cat([_start(rho, phi0), zeros])
    dx2_c0 = dx2 * c0
    jac_b = -dx2 * c0 * c1
    residual = torch.ones((), dtype=torch.float32, device=dev)
    it = 0
    while residual.item() > tol32 and it < maxiter:
        expo = torch.exp(torch.clamp(c1 * phi, -_EXP_CLAMP, _EXP_CLAMP))
        lap = (a_lap * _shift_down(phi, 1, 0.0) + d_lap * phi
               + c_lap * _shift_up(phi, 1, 0.0))
        f = lap - dx2_c0 * expo + dx2 * c2
        f = torch.where(interior, f, 0.0)
        ddiag = torch.where(interior, jac_b * expo,
                            torch.where(boundary, jac_b, 0.0))
        dphi = _pcr_solve(a_lap, d_lap + ddiag, c_lap, f)
        dphi = torch.clamp(dphi, -step_max, step_max)
        phi = phi - dphi
        residual = torch.sum(dphi * dphi)
        it += 1
    phi = phi[:ng]
    return NewtonResult(phi - torch.min(phi),
                        torch.tensor(it, dtype=torch.int32, device=dev),
                        residual)


def boltzmann_dirichlet(rho, n0, te, dx, tol=1e-9, maxiter=1000, phi0=None):
    """Newton-Boltzmann D-D solve of the (ng,) float32 charge density rho
    for the potential, ng <= 1024, in one kernel launch on a CUDA tensor.

    ``n0`` is the Boltzmann reference density: a Python number or a 0-d
    tensor on rho's device (read there by the kernel). ``phi0`` is the warm
    start or None (cold start at 0); its walls are pinned to 0. The
    residual is sum(dphi^2) of the last iteration, tested against the
    float32 ``tol``. Returns NewtonResult(phi shifted to min 0 over the
    physical rows, iterations (int32), residual), each on rho's device.
    """
    tensors = (rho,) if phi0 is None else (rho, phi0)
    kind = _device_kind(tensors)
    ng = rho.shape[0] if rho.dim() == 1 else -1
    _check_1d("rho", rho, ng)
    if phi0 is not None:
        _check_1d("phi0", phi0, ng)
    if ng < 3:
        raise ValueError(f"boltzmann_dirichlet needs ng >= 3, got ng={ng}")
    if kind == "cpu":
        return boltzmann_dirichlet_plain(rho, n0, te, dx, tol=tol,
                                         maxiter=maxiter, phi0=phi0)
    _check_rows("boltzmann_dirichlet", ng)
    lib = _build.library()
    dev = rho.device
    n0_t = _as_n0(n0, dev)
    c1, dx2, tol32, step_max = newton_scalars(te, dx, tol)
    phi = torch.empty((ng,), dtype=torch.float32, device=dev)
    iters = torch.empty((), dtype=torch.int32, device=dev)
    resid = torch.empty((), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.pypic_boltzmann_dirichlet(
            rho.data_ptr(), n0_t.data_ptr(),
            None if phi0 is None else phi0.data_ptr(), phi.data_ptr(),
            iters.data_ptr(), resid.data_ptr(), ng, padded_rows(ng),
            _COEF, float(np.float32(EPSILON_0)), c1, dx2, tol32, int(maxiter),
            step_max, _EXP_CLAMP, _stream(dev))
    _build.check(err, "boltzmann_dirichlet")
    LAUNCHES["boltzmann_dirichlet"] += 1
    return NewtonResult(phi, iters, resid)


def boltzmann_dn_plain(n, n0, te, dx, phi0, tol=1e-3, maxiter=100):
    """The D-N kernel's Newton loop as tensor operations (pallas_newton.py
    _newton_dn_kernel), in its operation order. Returns NewtonResult."""
    ng = n.shape[0]
    dev = n.device
    ngp = padded_rows(ng)
    c1, dx2, tol32, step_max = newton_scalars(te, dx, tol)
    c0 = _COEF * _as_n0(n0, dev)[0]
    col = torch.arange(ngp, device=dev)
    valid = col < ng
    inner = (col >= 1) & (col <= ng - 2)
    last = col == ng - 1
    a_lap = torch.where(inner, 1.0, torch.where(last, -4.0, 0.0))
    c_lap = inner.to(torch.float32)
    d_lap = torch.where(inner, -2.0, torch.where(last, 3.0, 1.0))
    u_row = last.to(torch.float32)  # rank-1 u = e_{ng-1}
    zeros = torch.zeros((ngp - ng,), dtype=torch.float32, device=dev)
    c2 = torch.cat([n * _COEF, zeros])
    phi = torch.cat([phi0.to(torch.float32), zeros])
    dx2_c0 = dx2 * c0
    jac_b = -dx2 * c0 * c1
    residual = torch.ones((), dtype=torch.float32, device=dev)
    it = 0
    while residual.item() > tol32 and it < maxiter:
        expo = torch.exp(torch.clamp(c1 * phi, -_EXP_CLAMP, _EXP_CLAMP))
        lap = (a_lap * _shift_down(phi, 1, 0.0) + d_lap * phi
               + c_lap * _shift_up(phi, 1, 0.0))
        lap = lap + u_row * phi[ng - 3]  # A[-1, -3]
        f = lap - dx2_c0 * expo + dx2 * c2
        f = torch.where(col == 0, phi[0], f)
        f = torch.where(last | ~valid, 0.0, f)
        ddiag = torch.where(inner, jac_b * expo,
                            torch.where(col == 0, jac_b, 0.0))
        y, z = _pcr_solve(a_lap, d_lap + ddiag, c_lap, torch.stack([f, u_row]))
        dphi = y - z * (y[ng - 3] / (1.0 + z[ng - 3]))
        dphi = torch.clamp(dphi, -step_max, step_max)
        phi = phi - dphi
        residual = torch.sqrt(torch.sum(dphi * dphi))
        it += 1
    phi = phi[:ng]
    return NewtonResult(phi - torch.min(phi),
                        torch.tensor(it, dtype=torch.int32, device=dev),
                        residual)


def boltzmann_dn(n, n0, te, dx, phi0, tol=1e-3, maxiter=100):
    """Newton-Boltzmann D-N solve of the (ng,) float32 number density n
    for the potential, in one kernel launch on a CUDA tensor (ng <= 1024).

    ``n0`` is the Boltzmann reference density, a Python number or a 0-d
    tensor on n's device; ``phi0`` the (ng,) warm start, used as it is (no
    wall pin: the reference warm-starts this Newton from its previous phi,
    pygcpic.py:1083). The residual is ||dphi||_2 of the last iteration,
    tested against the float32 ``tol``. Returns NewtonResult(phi shifted to
    min 0 over the physical rows, iterations (int32), residual), each on
    n's device, with no host read.
    """
    kind = _device_kind((n, phi0))
    ng = n.shape[0] if n.dim() == 1 else -1
    _check_1d("n", n, ng)
    _check_1d("phi0", phi0, ng)
    if ng < 3:
        raise ValueError(f"boltzmann_dn needs ng >= 3, got ng={ng}")
    if kind == "cpu":
        return boltzmann_dn_plain(n, n0, te, dx, phi0, tol=tol,
                                  maxiter=maxiter)
    _check_rows("boltzmann_dn", ng)
    lib = _build.library()
    dev = n.device
    n0_t = _as_n0(n0, dev)
    c1, dx2, tol32, step_max = newton_scalars(te, dx, tol)
    phi = torch.empty((ng,), dtype=torch.float32, device=dev)
    iters = torch.empty((), dtype=torch.int32, device=dev)
    resid = torch.empty((), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.pypic_boltzmann_dn(
            n.data_ptr(), n0_t.data_ptr(), phi0.data_ptr(), phi.data_ptr(),
            iters.data_ptr(), resid.data_ptr(), ng, padded_rows(ng), _COEF,
            c1, dx2, tol32, int(maxiter), step_max, _EXP_CLAMP, _stream(dev))
    _build.check(err, "boltzmann_dn")
    LAUNCHES["boltzmann_dn"] += 1
    return NewtonResult(phi, iters, resid)
