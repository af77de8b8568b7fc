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
LOST_RIGHT, -1 LOST_LEFT. The tensors are float32, or float64 for a
float64 state (the double kernels: every product and sum one rounding in
double). The kernels' currents are deterministic (summed in a fixed
order, no float atomics: the Picard loop's floor exit reads the residual
at round-off level) and equal the plain versions' up to summation order.
In float32 the thread columns hold ng floats up to MAX_NG = 1,760 nodes
(deposit_det's 1,815) and int64 fixed-point sums take over above it; in
float64 the columns hold doubles up to MAX_NG_F64 = 880 (deposit_det's
907), and above it each term takes two int64 words (csrc/cic_common.cuh
"Two-word sums": a term rounds by 2^-(k+L+1), the sum once more to
float64; ``cuda_cic.fixed2_sum_plain`` is its bit-exact twin). Either
large mode gives the same bits for any order, up to LARGE_MAX_NG. The
scalars dt, dt/dx, c = 0.5 dt (dt/dx) and wall_ratio = dx^2/dt are
formed in the state's dtype (``sheath_scalars``; the TPU kernel's SMEM
scalars), so the kernel's and the plain version's xh, x1 and u1 are
bit-equal in either dtype.

Dispatch as in ``ops/cuda_cic.py``: a CUDA tensor launches the kernel (a
float64 one the double kernel), a CPU tensor runs the plain version,
anything else raises. Launches count in
``cuda_cic.LAUNCHES['sheath_picard']`` and ``['sheath_finalize']`` (the
double kernels' under ``..._f64``; the large modes also in
``LARGE_LAUNCHES`` as "<name> fixed"). Both wrappers return their (n,)
outputs, in the inputs' dtype, as views of one buffer whose rows are
padded to 4 elements (``cuda_cic.padded_rows``), on either device, so
the engine's next inputs start 16-B aligned and the kernels take 16-B
loads.

``launch_shape(n, ng, sms, item=4|8)`` is the kernels' grid: persistent
blocks, one or two an SM, each sweeping a contiguous range of rows. The
order of every sum of the current follows from it, so from (n, ng, sms,
dtype) alone; in the large modes no order matters.
"""

from __future__ import annotations

import dataclasses

import torch

from . import _build
from .cuda_cic import (LARGE_LAUNCHES, LARGE_MAX_NG, LAUNCHES, SMEM_LIMIT,
                       STATIC_INT_BYTES, _check_1d, _device_kind, _launcher,
                       _sm_count, _stream, check_large_ng, deposit_plain,
                       det_buffers, field_smem_max_ng, gather_plain,
                       large_scratch, padded_rows, real)

MAX_THREADS = 1024  # csrc/sheath.cu kMaxThreads
MIN_THREADS = 32  # one warp of thread columns
MAX_BLOCKS_PER_SM = 2
# The occupancy of one sm_90 SM, written down rather than asked of the
# CUDA runtime: the grid fixes the order of every sum of the current, so
# it must follow from (n, ng, SM count) alone, and not from what one
# CUDA version or another reports. 228 KB of shared memory an SM, 2,048
# resident threads, 1 KB of shared memory the card keeps back per block.
SM_SHARED = 233_472
SM_THREADS = 2048
BLOCK_RESERVED = 1024
# the static shared bytes of the small mode's kernels (ptxas -v: the
# ticket of cic_common.cuh det_flush), which a block's SMEM_LIMIT holds
# beside the columns
SMALL_STATIC_BYTES = STATIC_INT_BYTES
# the small mode's limit: the field and 32 thread columns of ng floats in
# one block's shared memory beside those bytes (without the field, the
# deterministic deposit's: 1,815). Above it, up to LARGE_MAX_NG, the
# large mode (int64 fixed-point sums in device memory). The double
# kernels of a float64 state keep 8 B a node: MAX_NG_F64 = 880 (without
# the field, 907), and two int64 words a node in the large mode.
MAX_NG = (SMEM_LIMIT - SMALL_STATIC_BYTES) // (4 * (MIN_THREADS + 1))
MAX_NG_F64 = (SMEM_LIMIT - SMALL_STATIC_BYTES) // (8 * (MIN_THREADS + 1))
LARGE_THREADS = 512  # csrc/cic_common.cuh kLargeThreads


@dataclasses.dataclass(frozen=True)
class LaunchShape:
    """The sheath kernels' grid (and the deterministic deposit's). Block b
    sweeps rows [b rows_per_block, min(n, (b + 1) rows_per_block)), four a
    thread at a time; ``smem`` bytes of dynamic shared memory a block. The
    small mode holds the field (not the deposit's) and a column of ng
    elements a thread there, and sums them in an order the grid fixes;
    ``large`` (ng above the columns' ceiling) holds the field alone where
    it fits (ng <= field_smem_max_ng, else nothing) and sums in fixed
    point, whose bits no order changes. ``scratch`` is the device memory
    the sums use: blocks x ng elements of partials and a counter (small),
    or blocks elements of maxima and ng int64 (large; two int64 a node in
    float64)."""

    blocks: int
    threads: int
    rows_per_block: int
    smem: int
    large: bool = False
    scratch: int = 0


def launch_shape(n: int, ng: int, sms: int, field: bool = True,
                 item: int = 4) -> LaunchShape:
    """The grid of a sheath pass over n rows and ng nodes on a card of
    ``sms`` SMs (with ``field`` False, of the deterministic deposit, whose
    blocks hold no field), for elements of ``item`` bytes (4 float32, 8
    the double kernels of a float64 state). Small mode up to MAX_NG
    (without the field, 1,815; in float64 880 and 907): threads a block a
    power of two in [32, 1024], the most that let two blocks (the field
    and a column of ng elements a thread each) share an SM, else the most
    one block holds. Large mode above it: LARGE_THREADS threads, two
    blocks an SM where the field's shared memory lets them. No more
    blocks than n fills, so every block gets rows. Raises above
    LARGE_MAX_NG."""
    extra = int(field)
    top = (SMEM_LIMIT - SMALL_STATIC_BYTES) // (item * (MIN_THREADS + extra))
    if n < 1 or ng < 2 or sms < 1:
        raise ValueError(f"launch_shape needs n >= 1, ng >= 2, sms >= 1; got "
                         f"{n}, {ng}, {sms}")
    if item not in (4, 8):
        raise ValueError(f"launch_shape: item must be 4 or 8 bytes, got {item}")
    large = ng > top
    if large:
        check_large_ng(ng, "sheath pass" if field else "deposit_det")

    def smem_of(threads: int) -> int:
        if large:
            return item * ng if field and ng <= field_smem_max_ng(item) else 0
        return (threads + extra) * ng * item

    def per_sm(threads: int) -> int:
        smem = smem_of(threads)
        if smem + (0 if large else SMALL_STATIC_BYTES) > SMEM_LIMIT:
            return 0
        return min(MAX_BLOCKS_PER_SM, SM_THREADS // threads,
                   SM_SHARED // (smem + BLOCK_RESERVED))

    if large:
        threads = LARGE_THREADS
    else:
        sizes = [MAX_THREADS >> k for k in range(6)]  # 1024 .. 32
        threads = next((t for t in sizes if per_sm(t) >= MAX_BLOCKS_PER_SM),
                       next(t for t in sizes if per_sm(t) >= 1))
    groups = -(-n // 4)
    blocks = max(1, min(per_sm(threads) * sms, -(-groups // threads)))
    per_block = -(-groups // blocks)
    blocks = -(-groups // per_block)
    words = item // 4  # int64 words a node: one, two in float64
    scratch = (item * blocks + 8 * words * ng if large
               else item * blocks * ng + 4)
    return LaunchShape(blocks, threads, 4 * per_block, smem_of(threads), large,
                       scratch)


def sheath_scalars(dt: float, dx: float, dtype: torch.dtype = torch.float32):
    """(dt, dt/dx, c, wall_ratio) as Python floats holding the values of
    ``dtype`` (the state's) the TPU kernel uses: dt and dt/dx rounded to
    it, c = 0.5 dt (dt/dx) in its arithmetic (pallas_cic.py ``_sheath_call``
    forms them in the state's dtype), and wall_ratio = dx^2/dt (the wall
    charge dx q p2c / dt over the deposit weight q p2c / dx: JAX's Python
    float, rounded to the dtype of the w it meets)."""
    f = real(dtype)
    dt_r, dt_dx = f(dt), f(dt / dx)
    c = f(0.5) * dt_r * dt_dx
    return float(dt_r), float(dt_dx), float(c), float(f(dx * dx / dt))


def _push_plain(es, ps, p0, u0, qm, act, dt: float, dx: float):
    """_sheath_common (pallas_cic.py:598-620) as tensor operations:
    (x1, u1, xh, uh, act1)."""
    ng = es.shape[0]
    cells = float(ng - 1)
    dt_r, dt_dx, c, _ = sheath_scalars(dt, dx, p0.dtype)
    is_act = act > 0.5
    e_p = gather_plain(es, torch.clamp(ps, 0.0, cells), periodic=False)
    accel = qm * e_p
    x1 = p0 + dt_dx * u0 + c * accel
    u1 = u0 + dt_r * accel
    x1 = torch.where(is_act, x1, 0.0)
    u1 = torch.where(is_act, u1, 0.0)
    xh = torch.where(is_act, 0.5 * (p0 + x1), 0.0)
    uh = torch.where(is_act, 0.5 * (u0 + u1), 0.0)
    right = is_act & ((p0 >= cells) | (xh >= cells) | (x1 >= cells))
    left = is_act & ((p0 <= 0.0) | (xh <= 0.0) | (x1 <= 0.0))
    act1 = torch.where(right, 0.0, act)
    act1 = torch.where(left, -1.0, act1)
    return x1, u1, xh, uh, act1


def sheath_deposit_args_plain(pos, vals, act1, w, ng: int, *, dt: float,
                              dx: float):
    """(position, value) of each row's deposit with the wall charge
    folded in (pallas_cic.py:623-634): an active row w vals at pos, a
    lost-left row w dx^2/dt at node 0, a lost-right row -w dx^2/dt at
    node ng - 1, wall_ratio in w's dtype."""
    wall_ratio = sheath_scalars(dt, dx, w.dtype)[3]
    cells = float(ng - 1)
    is_act = act1 > 0.5
    lost_left = act1 < -0.5
    at = torch.where(is_act, pos, torch.where(lost_left, 0.0, cells))
    val = torch.where(is_act, w * vals,
                      torch.where(lost_left, w * wall_ratio, -w * wall_ratio))
    return at, val


def sheath_deposit_plain(pos, vals, act1, w, ng: int, *, dt: float,
                         dx: float):
    """The deposit with the wall charge folded in
    (``sheath_deposit_args_plain``). Summed in the inputs' dtype (float64
    inputs give the reference for the kernel's float32 sums)."""
    at, val = sheath_deposit_args_plain(pos, vals, act1, w, ng, dt=dt, dx=dx)
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


def _check(es, ps, p0, u0, qm, w, act, name: str):
    kind = _device_kind((es, ps, p0, u0, qm, w, act), name)
    ng = es.shape[0] if es.dim() == 1 else -1
    _check_1d("es", es, ng)
    n = ps.shape[0] if ps.dim() == 1 else -1
    for label, t in zip(("ps", "p0", "u0", "qm", "w", "act"),
                        (ps, p0, u0, qm, w, act)):
        _check_1d(label, t, n)
    if ng < 2:
        raise ValueError(f"ng must be >= 2, got {ng}")
    # the thread-histogram limit belongs to the card: the CUDA branch meets
    # it in launch_shape
    return kind, n, ng


def _launch(what: str, outs, es, ps, p0, u0, qm, w, act, n: int, ng: int,
            dt: float, dx: float):
    """One launch of the pass (``what`` 'sheath_picard', ``outs`` (xh,
    act1)) or the finalize ('sheath_finalize', (x1, u1, act1)), the double
    kernel's for float64 tensors; returns the (ng,) current in the
    tensors' dtype. The large mode runs the ``*_large`` launcher (its
    scale sweep, deposit sweep and conversion)."""
    dtype = ps.dtype
    dt_r, dt_dx, c, wall_ratio = sheath_scalars(dt, dx, dtype)
    dev = ps.device
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    item = ps.element_size()
    shape = launch_shape(n, ng, _sm_count(index), item=item)
    lib = _build.library()
    j = torch.empty((ng,), dtype=dtype, device=dev)
    fn, name = _launcher(lib, what, dtype, shape.large)
    with torch.cuda.device(dev):
        if shape.large:
            a, b = large_scratch(dev, shape.blocks, ng, dtype)
        else:
            a, b = det_buffers(dev, shape.blocks, ng, dtype)
        err = fn(
            es.data_ptr(), ps.data_ptr(), p0.data_ptr(), u0.data_ptr(),
            qm.data_ptr(), w.data_ptr(), act.data_ptr(),
            *(o.data_ptr() for o in outs), j.data_ptr(), a.data_ptr(),
            b.data_ptr(), n, ng, dt_r, dt_dx, c, wall_ratio,
            shape.blocks, shape.threads, shape.rows_per_block, _stream(dev))
    _build.check(err, name)
    LAUNCHES[name] += 1
    if shape.large:
        LARGE_LAUNCHES[f"{name} fixed"] += 1
    return j


def sheath_picard(es, ps, p0, u0, qm, w, act, *, dt: float, dx: float):
    """One Picard pass of the sheath step.

    Args:
        es: (ng,) bounded half-step field guess [V/m].
        ps: (n,) position guess (the previous pass's xh; p0 at first).
        p0, u0: step-start positions (grid coordinates) and x-velocities.
        qm, w: per-row q/m and deposit weight q p2c / dx.
        act: (n,) float status: 1 active, 0 lost right, -1 lost left.

    All of one dtype, float32 or float64 (a float64 state: the double
    kernel on the card). Returns (xh, act1, jh) in that dtype: jh holds
    the wall charge, not the edge fold.
    """
    kind, n, ng = _check(es, ps, p0, u0, qm, w, act, "sheath_picard")
    xh, act1 = padded_rows(2, n, ps.device, ps.dtype)
    if kind == "cpu":
        *ref, jh = sheath_picard_plain(es, ps, p0, u0, qm, w, act, dt=dt, dx=dx)
        for o, r in zip((xh, act1), ref):
            o.copy_(r)
        return xh, act1, jh
    jh = _launch("sheath_picard", (xh, act1), es, ps, p0, u0, qm, w, act, n, ng,
                 dt, dx)
    return xh, act1, jh


def sheath_finalize(es, ps, p0, u0, qm, w, act, *, dt: float, dx: float):
    """The post-convergence sweep of the sheath step, from the converged
    field guess and the last pass's xh and act1. Returns (x1, u1, act1,
    j1) in the inputs' dtype; j1 holds the wall charge, not the edge
    fold."""
    kind, n, ng = _check(es, ps, p0, u0, qm, w, act, "sheath_finalize")
    outs = padded_rows(3, n, ps.device, ps.dtype)
    if kind == "cpu":
        *ref, j1 = sheath_finalize_plain(es, ps, p0, u0, qm, w, act, dt=dt,
                                         dx=dx)
        for o, r in zip(outs, ref):
            o.copy_(r)
        return (*outs, j1)
    j1 = _launch("sheath_finalize", outs, es, ps, p0, u0, qm, w, act, n, ng,
                 dt, dx)
    return (*outs, j1)
