"""Guiding-center (GC) pusher and 6D <-> GC transforms (the counterpart
of ``pypic_tpu/push/guiding_center.py``).

* ``to_guiding_center``: pygcpic.py:509-551 ``transform_6D_to_GC`` — drop
  the gyro-phase: GC position X = x - r_L, parallel speed v_par = v.b,
  magnetic moment mu = m v_perp^2 / (2|B|);
* ``from_guiding_center``: pygcpic.py:553-596 ``transform_GC_to_6D`` — a
  gyro-phase from three uniforms a particle (the reference draws a random
  3-vector and projects out the parallel component). The JAX function
  draws them from a ``jax.random`` key; here the caller passes them (the
  magnetized engine draws them from its Philox kernel);
* ``gc_push_rk4``: pygcpic.py:598-645 ``push_GC``/``_eom_GC`` — RK4 on
  Xdot = E x B / B^2 + v_par b, v_par_dot per ``eom_form``, mu conserved.

As in the JAX package, the Larmor vector is the physical unit vector
-sign(q) cross(vperp_hat, b), not the reference's e-scaled one (see the
JAX module docstring).

The field ``b`` is a constant (3,) vector per run: three numbers, rounded
to the particles' dtype and reduced to |B| and b-hat on the host in that
dtype (the JAX engine's float32 b vector), so no step copies it to the
device. Vectors are (n, 3) at the public functions, as in JAX; the
products are written out by component.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import E_CHARGE


def _field(b, dtype):
    """(b, |B|, b-hat, |B|^2): Python floats holding values of ``dtype``,
    sqrt(sum(b*b)), b / |B| and |B| |B| rounded as the JAX function's
    array operations round them."""
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    bv = np.asarray([float(x) for x in b], np_dtype)
    bmag = np.sqrt(bv[0] * bv[0] + bv[1] * bv[1] + bv[2] * bv[2])
    bhat = bv / bmag
    return (tuple(float(x) for x in bv), float(bmag),
            tuple(float(x) for x in bhat), float(bmag * bmag))


def _along(s, h):
    """s[:, None] * h for (n,) s and a host 3-vector h."""
    return torch.stack([s * h[0], s * h[1], s * h[2]], dim=-1)


def _dot(v, h):
    """v @ h for (n, 3) v and a host 3-vector h."""
    return v[:, 0] * h[0] + v[:, 1] * h[1] + v[:, 2] * h[2]


def _cross_const(v, h):
    """cross(v, h) for (n, 3) v and a host 3-vector h."""
    return torch.stack([v[:, 1] * h[2] - v[:, 2] * h[1],
                        v[:, 2] * h[0] - v[:, 0] * h[2],
                        v[:, 0] * h[1] - v[:, 1] * h[0]], dim=-1)


def _wc(bmag, charge_state, m):
    """Cyclotron frequency |q| |B| / m."""
    return torch.abs(charge_state) * E_CHARGE * bmag / m


def to_guiding_center(pos, v, b, charge_state, m, perp_floor: float = 0.0):
    """6D -> GC. pos: (n, 3) [m], v: (n, 3). Returns (X, vpar, mu).

    ``perp_floor`` > 0 guards the vperp_hat normalization for exactly
    field-aligned velocities (vperp = 0 -> X = pos, mu = 0 instead of
    NaN); the default 0 keeps the reference's literal division
    (pygcpic.py:541).
    """
    _, bmag, bhat, _ = _field(b, v.dtype)
    wc = _wc(bmag, charge_state, m)
    vpar_mag = _dot(v, bhat)
    vperp = v - _along(vpar_mag, bhat)
    vperp_mag = torch.linalg.vector_norm(vperp, dim=-1)
    vperp_hat = vperp / torch.clamp(vperp_mag, min=perp_floor)[:, None]
    mu = 0.5 * m * vperp_mag ** 2 / bmag
    rl_mag = vperp_mag / wc
    rl_hat = -torch.sign(charge_state)[:, None] * _cross_const(vperp_hat, bhat)
    x_gc = pos - rl_mag[:, None] * rl_hat
    return x_gc, vpar_mag, mu


def from_guiding_center(a, x_gc, vpar_mag, mu, b, charge_state, m):
    """GC -> 6D with the gyro-phase of ``a``, (n, 3) uniforms in [0, 1)
    (the JAX function's ``jax.random.uniform(key, (n, 3))``).

    Returns (pos, v).
    """
    _, bmag, bhat, _ = _field(b, x_gc.dtype)
    wc = _wc(bmag, charge_state, m)
    vperp_mag = torch.sqrt(2.0 * mu * bmag / m)
    rl_mag = vperp_mag / wc
    aperp = a - _along(_dot(a, bhat), bhat)
    bperp_hat = aperp / torch.linalg.vector_norm(aperp, dim=-1)[:, None]
    pos = x_gc + rl_mag[:, None] * bperp_hat
    # cross(bhat, bperp_hat) = -cross(bperp_hat, bhat), written out
    h, p = bhat, bperp_hat
    vperp_hat = torch.stack([h[1] * p[:, 2] - h[2] * p[:, 1],
                             h[2] * p[:, 0] - h[0] * p[:, 2],
                             h[0] * p[:, 1] - h[1] * p[:, 0]], dim=-1)
    v = _along(vpar_mag, bhat) + vperp_mag[:, None] * vperp_hat
    return pos, v


def gc_push_rk4(x_gc, vpar, mu, e3, b, charge_state, m, dt,
                eom_form: str = "reference"):
    """RK4 guiding-center push (pygcpic.py:598-645).

    Args:
        x_gc: (n, 3) GC positions [m].
        vpar: (n,) parallel speeds.
        mu: (n,) magnetic moments (conserved; carried through unchanged).
        e3: (n, 3) electric field at the particles.
        b: the (3,) magnetic field.
        charge_state, m: (n,) charge number / mass.
        dt: timestep [s].
        eom_form: 'reference' (pygcpic.py:638-639's literal
            vpardot = (E . X) / (|B| vpar / wc)) or 'physical'
            (vpardot = (q/m) E . bhat); see the JAX docstring.

    Returns:
        (x_gc, vpar, mu) advanced by dt.
    """
    if eom_form not in ("reference", "physical"):
        raise ValueError(f"unknown eom_form {eom_form!r}")
    bv, bmag, bhat, b2 = _field(b, x_gc.dtype)
    wc = _wc(bmag, charge_state, m)
    exb = _cross_const(e3, bv) / b2
    qm = torch.sign(charge_state) * wc / bmag  # q/m = charge_state e / m

    def eom(x, vp):
        xdot = exb + _along(vp, bhat)
        if eom_form == "reference":
            rho = vp / wc
            vpdot = (e3 * x).sum(dim=-1) / (bmag * rho)
        else:
            vpdot = qm * _dot(e3, bhat)
        return xdot, vpdot

    k1x, k1v = eom(x_gc, vpar)
    k2x, k2v = eom(x_gc + 0.5 * dt * k1x, vpar + 0.5 * dt * k1v)
    k3x, k3v = eom(x_gc + 0.5 * dt * k2x, vpar + 0.5 * dt * k2v)
    k4x, k4v = eom(x_gc + dt * k3x, vpar + dt * k3v)
    x1 = x_gc + (dt / 6.0) * (k1x + 2.0 * k2x + 2.0 * k3x + k4x)
    v1 = vpar + (dt / 6.0) * (k1v + 2.0 * k2v + 2.0 * k3v + k4v)
    return x1, v1, mu
