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
The kernels and the plain versions solve ``kernel_rows(ng)`` rows (ng
rounded up to 32, a row a thread); the TPU kernels' ``padded_rows(ng)``
(a power of two, at least 128) gives the same solution, the rows past ng
being identity rows (``tests/test_torch_newton_rows.py``).

``boltzmann_dn`` replaces ``boltzmann_dn_pallas``: the Newton loop of
``ops.poisson.solve_boltzmann_dirichlet_neumann`` (pygcpic.py:1062-1109)
on the number density, the one-sided Neumann row's rank-1 entry solved
by Sherman-Morrison on a PCR with two right-hand sides, in one launch of
the second kernel in ``csrc/newton.cu``. ``boltzmann_dn_plain`` is its
loop as tensor operations, in the kernel's order.

``tridiag3_chain`` solves one rank's local system of the distributed
chain solve (``parallel.distributed_poisson.make_distributed_tridiag_chain``,
the slab-sharded Newton's step) for its three right-hand sides [f, e_0,
e_(c-1)] in one launch of the third kernel in ``csrc/newton.cu`` (the
same PCR, one CTA, c <= 1024), and writes the rank's six interface
scalars beside them. It replaces no TPU kernel: JAX's chain is XLA
operations. ``tridiag3_chain_plain`` is ``_pcr_solve`` with the (3, rows)
right-hand side; the CPU route runs it.

Dispatch and launch counting follow ``ops/cuda_cic.py``: CUDA tensors
launch the kernel, CPU tensors run the plain version, anything else
raises; each launch adds one to ``cuda_cic.LAUNCHES['boltzmann_dirichlet']``,
``['boltzmann_dn']`` or ``['tridiag3_chain']``. The kernels take ng <= ``MAX_NG`` (one CTA, a row
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
_WARP = 32
MAX_NG = 1024  # one CTA, one row a thread
_COEF = float(np.float32(E_CHARGE / EPSILON_0))  # f32(e / eps0)


def padded_rows(ng: int) -> int:
    """Rows of the TPU kernels' PCR system: the next power of two >= ng, at
    least 128 (pallas_newton.py's ngp)."""
    return max(_LANE, 1 << (ng - 1).bit_length())


def kernel_rows(ng: int) -> int:
    """Rows of the port's PCR system and threads of the kernels' one CTA:
    ng rounded up to a whole warp."""
    return -(-ng // _WARP) * _WARP


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
    f_i over len(a) rows (rows past the physical ones are identity rows,
    and so is a row read past either end). ``f`` is (rows,) or (R, rows):
    R right-hand sides that share the elimination coefficients. The stages
    end, as the kernels' do, once no row is coupled (every a and c 0): the
    stages left would change no value."""
    rows = a.shape[0]
    s = 1
    while s < rows and bool(torch.any(a != 0.0) | torch.any(c != 0.0)):
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
    rows = kernel_rows(ng)
    c1, dx2, tol32, step_max = newton_scalars(te, dx, tol)
    c0 = _COEF * _as_n0(n0, dev)[0]
    col = torch.arange(rows, device=dev)
    valid = col < ng
    interior = (col >= 1) & (col <= ng - 2)
    boundary = valid & ~interior
    a_lap = interior.to(torch.float32)
    c_lap = a_lap
    d_lap = torch.where(interior, -2.0, 1.0)
    pad = rows - ng
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
            iters.data_ptr(), resid.data_ptr(), ng, kernel_rows(ng),
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
    rows = kernel_rows(ng)
    c1, dx2, tol32, step_max = newton_scalars(te, dx, tol)
    c0 = _COEF * _as_n0(n0, dev)[0]
    col = torch.arange(rows, device=dev)
    valid = col < ng
    inner = (col >= 1) & (col <= ng - 2)
    last = col == ng - 1
    a_lap = torch.where(inner, 1.0, torch.where(last, -4.0, 0.0))
    c_lap = inner.to(torch.float32)
    d_lap = torch.where(inner, -2.0, torch.where(last, 3.0, 1.0))
    u_row = last.to(torch.float32)  # rank-1 u = e_{ng-1}
    zeros = torch.zeros((rows - ng,), dtype=torch.float32, device=dev)
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
            iters.data_ptr(), resid.data_ptr(), ng, kernel_rows(ng), _COEF,
            c1, dx2, tol32, int(maxiter), step_max, _EXP_CLAMP, _stream(dev))
    _build.check(err, "boltzmann_dn")
    LAUNCHES["boltzmann_dn"] += 1
    return NewtonResult(phi, iters, resid)


def _chain_scalars(x, dl, du, first: bool, last: bool) -> torch.Tensor:
    """The six interface scalars [xp_0, xp_(c-1), a0 u_0, a0 u_(c-1),
    cc w_0, cc w_(c-1)] of the (3, c) local solution x = [xp, u, w]: a0 =
    dl[0] and cc = du[c-1], the couplings to the neighbouring slabs, 0 at
    the chain's ends."""
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    a0 = zero if first else dl[0]
    cc = zero if last else du[-1]
    return torch.stack([x[0, 0], x[0, -1], a0 * x[1, 0], a0 * x[1, -1],
                        cc * x[2, 0], cc * x[2, -1]])


def tridiag3_chain_plain(dl, d, du, f, *, first: bool, last: bool):
    """The kernel's solve as tensor operations: ``_pcr_solve`` over
    ``kernel_rows(c)`` rows (identity rows past c) with the (3, rows)
    right-hand side [f, e_0, e_(c-1)], the couplings dl[0] and du[c-1]
    left out. Returns ((3, c) [xp, u, w], (6,) interface scalars)."""
    c = d.shape[0]
    rows = kernel_rows(c)
    dev, dt = d.device, d.dtype
    pad = torch.zeros((rows - c,), dtype=dt, device=dev)
    a = torch.cat([dl, pad])
    a[0] = 0.0
    b = torch.cat([d, torch.ones_like(pad)])
    cu = torch.cat([du, pad])
    cu[c - 1] = 0.0
    rhs = torch.zeros((3, rows), dtype=dt, device=dev)
    rhs[0, :c] = f
    rhs[1, 0] = 1.0
    rhs[2, c - 1] = 1.0
    x = _pcr_solve(a, b, cu, rhs)[:, :c].contiguous()
    return x, _chain_scalars(x, dl, du, first, last)


def tridiag3_chain(dl, d, du, f, *, first: bool, last: bool):
    """One rank's local chain solve: the (c,) float32 rows dl[i] x[i-1] +
    d[i] x[i] + du[i] x[i+1] = rhs[i] with dl[0] and du[c-1] (the
    couplings to the neighbouring slabs) left out, for rhs = f, e_0 and
    e_(c-1), in one kernel launch on CUDA tensors (c <= 1024). ``first``
    / ``last``: the rank is the chain's first / last (no coupling there).
    Returns ((3, c) [xp, u, w], (6,) [xp_0, xp_(c-1), a0 u_0,
    a0 u_(c-1), cc w_0, cc w_(c-1)]), on the inputs' device, with no host
    read."""
    kind = _device_kind((dl, d, du, f))
    c = d.shape[0] if d.dim() == 1 else -1
    for name, t in (("dl", dl), ("d", d), ("du", du), ("f", f)):
        _check_1d(name, t, c)
    if c < 2:
        raise ValueError(f"tridiag3_chain needs c >= 2, got c={c}")
    if kind == "cpu":
        return tridiag3_chain_plain(dl, d, du, f, first=first, last=last)
    _check_rows("tridiag3_chain", c)
    lib = _build.library()
    dev = d.device
    x = torch.empty((3, c), dtype=torch.float32, device=dev)
    g6 = torch.empty((6,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.pypic_tridiag3_chain(
            dl.data_ptr(), d.data_ptr(), du.data_ptr(), f.data_ptr(),
            x.data_ptr(), g6.data_ptr(), c, kernel_rows(c), int(first),
            int(last), _stream(dev))
    _build.check(err, "tridiag3_chain")
    LAUNCHES["tridiag3_chain"] += 1
    return x, g6
