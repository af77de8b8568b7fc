"""Explicit electrostatic pushers (the counterpart of
``pypic_tpu/push/leapfrog.py``), plain tensor functions with the same
operation order.

* ``leapfrog_push``: the explicit kick-drift-kick cycle with a single field
  gather (PIC_L.py:248-259 ``pushParticlesExplicit``; pypic.py:726-728).
* ``cn_push``: one Crank-Nicolson update given a half-step field at the
  particles (PIC_L.py:261-270; pypic.py:264-265). The Picard iteration
  that makes it implicit lives in ``engines.implicit``.

Positions are grid coordinates: callers pass ``dt_dx = dt / dx`` so the
position update is ``p += v * dt_dx``. ``qm`` is a Python float, a 0-d
tensor or an (n,) tensor.
"""

from __future__ import annotations


def leapfrog_push(p, v, e_at_p, qm, dt, dt_dx):
    """Kick-drift-kick with one gather (pypic.py:726-728).

    v_half = v + (q/m)(dt/2) E;  p' = p + v_half dt/dx;  v' = v_half + (q/m)(dt/2) E
    """
    v_half = v + qm * (0.5 * dt) * e_at_p
    p1 = p + v_half * dt_dx
    v1 = v_half + qm * (0.5 * dt) * e_at_p
    return p1, v1


def cn_push(p0, v0, e_half, qm, dt, dt_dx):
    """Crank-Nicolson update given the half-step field at the particles
    (pypic.py:264-269).

    Returns (p1, v1, p_half, v_half); the half-step quantities feed the
    half-step current deposit of the implicit scheme (pypic.py:267-274).
    """
    accel = qm * e_half
    p1 = p0 + dt_dx * v0 + (0.5 * dt * dt_dx) * accel
    v1 = v0 + dt * accel
    p_half = 0.5 * (p0 + p1)
    v_half = 0.5 * (v0 + v1)
    return p1, v1, p_half, v_half
