"""Boris-Buneman particle pusher (the counterpart of
``pypic_tpu/push/boris.py``).

``Particle.push_6D`` (pygcpic.py:460-507) as a plain tensor function:
half electric kick, magnetic rotation through the (t, s) vectors, half
electric kick, then the drift. E has only an x component on the 1D grid
(pygcpic.py:480, 500); B is a constant 3-vector per run
(pygcpic.py:1329). q = charge_state * E_CHARGE.

This is the op-composed backend's push. Its rounding order is the JAX
function's: s = 2 t / (1 + t^2), and the drift in metres, x + vx dt. The
fused kernel (``ops.cuda_cic.boris_gather_push``) keeps the TPU kernel's
own order, inv = 2 / (1 + t^2), s = t inv, and the drift in grid
coordinates, p + vx dt/dx; the two agree to float32 rounding, not bit for
bit.
"""

from __future__ import annotations

import torch

from ..constants import E_CHARGE


def boris_push_dt(x, yz, v, ex, b, charge_state, m, dt):
    """Boris-Buneman push over dt (pygcpic.py:460-507).

    Args:
        x: (n,) x positions [m].
        yz: (n, 2) lateral positions [m].
        v: (n, 3) velocities [m/s].
        ex: (n,) E_x at the particles [V/m].
        b: (3,) magnetic field [T], a tensor of the particles' dtype.
        charge_state: (n,) charge number.
        m: (n,) mass [kg].
        dt: timestep [s].

    Returns:
        (x1, yz1, v1).
    """
    const = (0.5 * dt * E_CHARGE) * charge_state / m

    vx = v[:, 0] + const * ex
    vy = v[:, 1]
    vz = v[:, 2]

    tx = const * b[0]
    ty = const * b[1]
    tz = const * b[2]
    t2 = tx * tx + ty * ty + tz * tz

    sx = 2.0 * tx / (1.0 + t2)
    sy = 2.0 * ty / (1.0 + t2)
    sz = 2.0 * tz / (1.0 + t2)

    vfx = vx + vy * tz - vz * ty
    vfy = vy + vz * tx - vx * tz
    vfz = vz + vx * ty - vy * tx

    vx = vx + (vfy * sz - vfz * sy)
    vy = vy + (vfz * sx - vfx * sz)
    vz = vz + (vfx * sy - vfy * sx)

    vx = vx + const * ex

    x1 = x + vx * dt
    yz1 = yz + torch.stack([vy, vz], dim=-1) * dt
    v1 = torch.stack([vx, vy, vz], dim=-1)
    return x1, yz1, v1
