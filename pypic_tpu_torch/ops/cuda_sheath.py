"""The sheath engine's Picard-pass and finalize kernels and their plain
versions (the counterparts of ``sheath_picard_pallas`` and
``sheath_finalize_pallas`` in ``pypic_tpu/ops/pallas_cic.py``).

One bounded sweep a call (``csrc/sheath.cu``): the CIC gather of the field
guess at clip(ps, 0, cells), the Crank-Nicolson push of the active rows,
the wall check on (p0, xh, x1) and the current deposit with the wall
surface charge folded in (``_sheath_common`` and ``_sheath_deposit_args``,
pallas_cic.py:598-634). ``sheath_picard`` returns the half-step position
xh, the new status act1 and the half-step current jh; ``sheath_finalize``
the full-step x1, u1, act1 and j1. Neither applies the edge fold
``j[0] += j[1]; j[-1] += j[-2]``: the engine does.

Status values are floats, as the TPU kernels take them: 1 ACTIVE, 0
LOST_RIGHT, -1 LOST_LEFT. The kernels' currents are deterministic (summed
in a fixed order, no float atomics: the Picard loop's floor exit reads
the residual at round-off level); they equal the plain versions' up to
summation order. The push's constant c = 0.5 dt (dt/dx) is formed
in float32 from the float32 dt and dt/dx (the TPU kernel's SMEM scalars),
so the kernel's and the plain version's xh, x1 and u1 are bit-equal.

Dispatch as in ``ops/cuda_cic.py``: a CUDA tensor launches the kernel, a
CPU tensor runs the plain version, anything else raises. Launches count in
``cuda_cic.LAUNCHES['sheath_picard']`` and ``['sheath_finalize']``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build
from .cuda_cic import (LAUNCHES, _check_1d, _device_kind, _stream,
                       deposit_plain, deterministic_scratch,
                       gather_plain)


def sheath_scalars(dt: float, dx: float):
    """(dt, dt/dx, c, wall_ratio) as Python floats holding the float32
    values the TPU kernel uses: dt and dt/dx rounded to float32,
    c = 0.5 dt (dt/dx) in float32 arithmetic, and wall_ratio = dx^2/dt
    (the wall charge dx q p2c / dt over the deposit weight q p2c / dx)."""
    f32 = np.float32
    dt32, dt_dx32 = f32(dt), f32(dt / dx)
    c = f32(0.5) * dt32 * dt_dx32
    return float(dt32), float(dt_dx32), float(c), float(f32(dx * dx / dt))


def _push_plain(es, ps, p0, u0, qm, act, dt: float, dx: float):
    """_sheath_common (pallas_cic.py:598-620) as tensor operations:
    (x1, u1, xh, uh, act1)."""
    ng = es.shape[0]
    cells = float(ng - 1)
    dt32, dt_dx32, c, _ = sheath_scalars(dt, dx)
    is_act = act > 0.5
    e_p = gather_plain(es, torch.clamp(ps, 0.0, cells), periodic=False)
    accel = qm * e_p
    x1 = p0 + dt_dx32 * u0 + c * accel
    u1 = u0 + dt32 * accel
    x1 = torch.where(is_act, x1, 0.0)
    u1 = torch.where(is_act, u1, 0.0)
    xh = torch.where(is_act, 0.5 * (p0 + x1), 0.0)
    uh = torch.where(is_act, 0.5 * (u0 + u1), 0.0)
    right = is_act & ((p0 >= cells) | (xh >= cells) | (x1 >= cells))
    left = is_act & ((p0 <= 0.0) | (xh <= 0.0) | (x1 <= 0.0))
    act1 = torch.where(right, 0.0, act)
    act1 = torch.where(left, -1.0, act1)
    return x1, u1, xh, uh, act1


def sheath_deposit_plain(pos, vals, act1, w, ng: int, *, dt: float,
                         dx: float):
    """The deposit with the wall charge folded in (pallas_cic.py:623-634):
    an active row deposits w vals at pos, a lost-left row w dx^2/dt at
    node 0, a lost-right row -w dx^2/dt at node ng - 1. Summed in the
    inputs' dtype (float64 inputs give the reference for the kernel's
    float32 sums)."""
    wall_ratio = sheath_scalars(dt, dx)[3]
    cells = float(ng - 1)
    is_act = act1 > 0.5
    lost_left = act1 < -0.5
    at = torch.where(is_act, pos, torch.where(lost_left, 0.0, cells))
    val = torch.where(is_act, w * vals,
                      torch.where(lost_left, w * wall_ratio, -w * wall_ratio))
    return deposit_plain(at, val, ng, periodic=False)


def sheath_picard_plain(es, ps, p0, u0, qm, w, act, *, dt: float, dx: float):
    _, _, xh, uh, act1 = _push_plain(es, ps, p0, u0, qm, act, dt, dx)
    jh = sheath_deposit_plain(xh, uh, act1, w, es.shape[0], dt=dt, dx=dx)
    return xh, act1, jh


def sheath_finalize_plain(es, ps, p0, u0, qm, w, act, *, dt: float,
                          dx: float):
    x1, u1, _, _, act1 = _push_plain(es, ps, p0, u0, qm, act, dt, dx)
    j1 = sheath_deposit_plain(x1, u1, act1, w, es.shape[0], dt=dt, dx=dx)
    return x1, u1, act1, j1


def _check(es, ps, p0, u0, qm, w, act):
    kind = _device_kind((es, ps, p0, u0, qm, w, act))
    ng = es.shape[0] if es.dim() == 1 else -1
    _check_1d("es", es, ng)
    n = ps.shape[0] if ps.dim() == 1 else -1
    for name, t in zip(("ps", "p0", "u0", "qm", "w", "act"),
                       (ps, p0, u0, qm, w, act)):
        _check_1d(name, t, n)
    if ng < 2:
        raise ValueError(f"ng must be >= 2, got {ng}")
    # the thread-histogram limit (det_threads) belongs to the card: the
    # CUDA branch meets it in deterministic_scratch
    return kind, n, ng


def sheath_picard(es, ps, p0, u0, qm, w, act, *, dt: float, dx: float):
    """One Picard pass of the sheath step.

    Args:
        es: (ng,) bounded half-step field guess [V/m].
        ps: (n,) position guess (the previous pass's xh; p0 at first).
        p0, u0: step-start positions (grid coordinates) and x-velocities.
        qm, w: per-row q/m and deposit weight q p2c / dx.
        act: (n,) float status: 1 active, 0 lost right, -1 lost left.

    Returns (xh, act1, jh): jh holds the wall charge, not the edge fold.
    """
    kind, n, ng = _check(es, ps, p0, u0, qm, w, act)
    if kind == "cpu":
        return sheath_picard_plain(es, ps, p0, u0, qm, w, act, dt=dt, dx=dx)
    lib = _build.library()
    dt32, dt_dx32, c, wall_ratio = sheath_scalars(dt, dx)
    dev = ps.device
    out = torch.empty((2, n), dtype=torch.float32, device=dev)
    jh = torch.empty((ng,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        blocks, threads, partial, counter = deterministic_scratch(
            n, ng, dev, 1, "sheath_picard")
        err = lib.pypic_sheath_picard(
            es.data_ptr(), ps.data_ptr(), p0.data_ptr(), u0.data_ptr(),
            qm.data_ptr(), w.data_ptr(), act.data_ptr(), out[0].data_ptr(),
            out[1].data_ptr(), jh.data_ptr(), partial.data_ptr(),
            counter.data_ptr(), n, ng, dt32, dt_dx32, c, wall_ratio, blocks,
            threads, _stream(dev))
    _build.check(err, "sheath_picard")
    LAUNCHES["sheath_picard"] += 1
    return out[0], out[1], jh


def sheath_finalize(es, ps, p0, u0, qm, w, act, *, dt: float, dx: float):
    """The post-convergence sweep of the sheath step, from the converged
    field guess and the last pass's xh and act1. Returns (x1, u1, act1,
    j1); j1 holds the wall charge, not the edge fold."""
    kind, n, ng = _check(es, ps, p0, u0, qm, w, act)
    if kind == "cpu":
        return sheath_finalize_plain(es, ps, p0, u0, qm, w, act, dt=dt, dx=dx)
    lib = _build.library()
    dt32, dt_dx32, c, wall_ratio = sheath_scalars(dt, dx)
    dev = ps.device
    out = torch.empty((3, n), dtype=torch.float32, device=dev)
    j1 = torch.empty((ng,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        blocks, threads, partial, counter = deterministic_scratch(
            n, ng, dev, 1, "sheath_finalize")
        err = lib.pypic_sheath_finalize(
            es.data_ptr(), ps.data_ptr(), p0.data_ptr(), u0.data_ptr(),
            qm.data_ptr(), w.data_ptr(), act.data_ptr(), out[0].data_ptr(),
            out[1].data_ptr(), out[2].data_ptr(), j1.data_ptr(),
            partial.data_ptr(), counter.data_ptr(), n, ng, dt32, dt_dx32, c,
            wall_ratio, blocks, threads, _stream(dev))
    _build.check(err, "sheath_finalize")
    LAUNCHES["sheath_finalize"] += 1
    return out[0], out[1], out[2], j1
