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
Up to ``SMALL_MAX_ROWS`` (1,024) rows the kernels and the plain versions
solve ``kernel_rows(ng)`` rows (ng rounded up to 32, a row a thread of one
CTA); the TPU kernels' ``padded_rows(ng)`` (a power of two, at least 128)
gives the same solution, the rows past ng being identity rows
(``tests/test_torch_newton_rows.py``).

Above 1,024 rows each of the three wrappers launches the large path of
``csrc/newton.cu`` instead, the same loop with a partition solve in each
iteration, in one of two modes (``large_shape``; the Newton solves take
the mode NEWTON_RULE gives, or ``mode=`` forced; the chain
has 'single' alone). 'single': one CTA of ``threads`` threads, each
owning a block of k consecutive rows (``large_split``), the blocks
reduced to their end rows by a sweep down and one up, the 2 x threads
end rows solved by the same PCR, the inner rows recovered; its plain
version is ``_partition_solve``. 'cluster' (the Newton solves): the
blocks spread over the C CTAs of a thread-block cluster, each CTA's end
rows solved with two spike columns and the CTAs' first and last rows by
a system of 2 C rows that every CTA solves alike; its plain version is
``_cluster_solve``. A cluster the card cannot hold raises
(cudaOccupancyMaxActiveClusters). The large path takes up to
``LARGE_MAX_ROWS`` rows on the card; the plain versions take any count.

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
same PCR, one CTA; above 1,024 rows its large path), and writes the
rank's six interface scalars beside them. It replaces no TPU kernel:
JAX's chain is XLA operations. ``tridiag3_chain_plain`` is the same solve
(``_pcr_solve`` or ``_partition_solve``) with the (3, rows) right-hand
side; the CPU route runs it.

Dispatch and launch counting follow ``ops/cuda_cic.py``: CUDA tensors
launch the kernel, CPU tensors run the plain version, anything else
raises; each launch adds one to ``cuda_cic.LAUNCHES['boltzmann_dirichlet']``,
``['boltzmann_dn']`` or ``['tridiag3_chain']``, or on the large path to
the same name with ``_large`` after it, and for the Newton solves to
``cuda_cic.LARGE_LAUNCHES`` under that name and its mode ("... single",
"... cluster").

The two Newton solves take a float64 state too (the JAX package solves
one in float64 under x64, on XLA's on-device loop): float64 tensors run
the plain versions in float64 on the CPU and the double kernels of
``csrc/newton.cu`` on the card (the ``_f64`` entry points, counted under
the name with ``_f64`` after it), with the scalars of ``newton_scalars``
in float64 and the residual in float64. Their large path holds a CTA of
at most ``LARGE_F64_THREADS`` threads (``large_split`` with ``item`` 8).
``tridiag3_chain`` takes float32 alone: the slab engines are float32 in
the JAX package.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from ..constants import EPSILON_0, E_CHARGE, K_BOLTZMANN
from . import _build
from .cuda_cic import (LARGE_LAUNCHES, LAUNCHES, SMEM_LIMIT, _check_1d, _device_kind,
                       _stream, real)
from .poisson import NewtonResult, _EXP_CLAMP

_LANE = 128  # the smallest padded row count, as on the TPU
_WARP = 32
SMALL_MAX_ROWS = 1024  # the one-CTA kernels, a row a thread
# the large path's ceiling: the kernel's int offsets into its (4 + R,
# rows) scratch stay below 2^31
LARGE_MAX_ROWS = 1 << 27
# the double kernels' large path: at most this many threads, whose 2 x 512
# PCR rows of 40 B fill 172,032 B of shared memory (1,024 would take twice
# that, above a block's 232,448)
LARGE_F64_THREADS = 512
_COEF = float(np.float32(E_CHARGE / EPSILON_0))  # f32(e / eps0)


def padded_rows(ng: int) -> int:
    """Rows of the TPU kernels' PCR system: the next power of two >= ng, at
    least 128 (pallas_newton.py's ngp)."""
    return max(_LANE, 1 << (ng - 1).bit_length())


def kernel_rows(ng: int) -> int:
    """Rows of the port's PCR system and threads of the kernels' one CTA:
    ng rounded up to a whole warp (ng <= SMALL_MAX_ROWS)."""
    return -(-ng // _WARP) * _WARP


def large_split(rows: int, item: int = 4) -> tuple[int, int]:
    """(k, threads) of the large path for ``rows`` > SMALL_MAX_ROWS: k =
    ceil(rows / most) rows a thread, threads = ceil(rows / k) rounded up
    to a whole warp (at most ``most``: 1,024, or LARGE_F64_THREADS for
    the double kernels, ``item`` 8). The system has threads x k rows, the
    rows past ``rows`` identity rows."""
    if rows <= SMALL_MAX_ROWS:
        raise ValueError(f"the large path takes more than {SMALL_MAX_ROWS} "
                         f"rows, got {rows}")
    most = SMALL_MAX_ROWS if item == 4 else LARGE_F64_THREADS
    k = -(-rows // most)
    return k, -(-(-(-rows // k)) // _WARP) * _WARP


def solve_rows(ng: int, item: int = 4, mode: str | None = None) -> int:
    """Rows of the system the port solves for ng physical rows: kernel_rows
    on the small path, the large path's ``large_shape(ng, item,
    mode).rows`` above (``item``: the element's bytes)."""
    if ng <= SMALL_MAX_ROWS:
        return kernel_rows(ng)
    return large_shape(ng, item, mode).rows


# The large path's cluster mode (csrc/newton.cu newton_cluster_kernel):
# C CTAs a cluster, a power of two in [2, CLUSTER_MAX] (16 a non-portable
# size), each of CLUSTER_THREADS_LEAST to CLUSTER_THREADS threads, as many
# as put about CLUSTER_ROWS_A_THREAD rows on a thread (large_shape)
CLUSTER_MAX = 16
CLUSTER_THREADS = 512
CLUSTER_THREADS_LEAST = 128
CLUSTER_ROWS_A_THREAD = 8
# large_mode's rule by element bytes: (first rows, mode, CTAs a cluster) in
# rising order, from the forced pairs of PERF.md section 6 (large_shape's
# docstring); below the first, the mode 'single'
NEWTON_RULE = {4: ((1025, "cluster", 16),), 8: ((1025, "cluster", 16),)}
_CLUSTER_INGREDIENTS = 12  # the D-N owner's values of row ng - 3
# the cluster kernels' static shared memory: none (every region dynamic)
CLUSTER_STATIC_BYTES = 0
LARGE_MODES = ("single", "cluster")


@dataclasses.dataclass(frozen=True)
class LargeShape:
    """A launch of the large path: its ``mode`` ('single': one CTA;
    'cluster'), ``cluster`` CTAs (1 in 'single') of ``threads`` threads, k
    rows a thread, ``smem`` bytes of dynamic shared memory a CTA, and
    whether the rows' scratch lies in it (``shared``) or in device
    memory."""
    mode: str
    cluster: int
    threads: int
    k: int
    smem: int
    shared: bool

    @property
    def rows(self) -> int:
        """Rows of the system: the physical ones, then identity rows."""
        return self.cluster * self.threads * self.k


def _a16(nbytes: int) -> int:
    return -(-nbytes // 16) * 16


def cluster_smem(dn: bool, item: int, cluster: int, threads: int, k: int,
                 shared: bool) -> int:
    """Dynamic shared memory of a cluster-mode CTA (csrc/newton.cu
    cluster_layout, each region 16-B aligned): the pushed partials and the
    warp partials (doubles), the cluster's pushed rows, the D-N
    ingredients, the CTAs' minima and the block minimum's partials, the
    PCR buffers (2 x 2 T rows of a four-element row and R + 1 planes), each
    thread's first and last phi, and in the shared variant the rows'
    scratch, (4 + R) T k elements."""
    r = 2 if dn else 1
    parts = (2 * CLUSTER_MAX * 8, 32 * 8, 2 * cluster * 2 * (3 + r) * item,
             2 * _CLUSTER_INGREDIENTS * item if dn else 0, CLUSTER_MAX * item,
             32 * item, 2 * 2 * threads * 4 * item,
             2 * (r + 1) * 2 * threads * item, 2 * threads * item,
             (4 + r) * threads * k * item if shared else 0)
    return sum(_a16(p) for p in parts)


def _rule(rows: int, item: int) -> tuple[str, int]:
    """(mode, CTAs a cluster) of the last NEWTON_RULE entry whose first row
    is at most ``rows``; ('single', CLUSTER_MAX) below the first."""
    out = ("single", CLUSTER_MAX)
    for first, mode, size in NEWTON_RULE[item]:
        if rows >= first:
            out = (mode, size)
    return out


def large_mode(rows: int, item: int = 4) -> str:
    """The mode NEWTON_RULE gives the large path at ``rows`` rows of
    ``item``-byte elements."""
    return _rule(rows, item)[0]


def large_shape(rows: int, item: int = 4, mode: str | None = None,
                cluster: int | None = None, threads: int | None = None,
                dn: bool = True) -> LargeShape:
    """The large path's launch at ``rows`` > SMALL_MAX_ROWS rows of
    ``item``-byte elements, a function of the sizes alone: the mode
    ``large_mode`` names, or ``mode`` forced ('single' or 'cluster').
    'single': large_split's one CTA, its scratch in device memory.
    'cluster': C = ``cluster`` CTAs (NEWTON_RULE's where None), each of
    T threads: ``threads``, or ceil(rows / (C CLUSTER_ROWS_A_THREAD))
    rounded up to a warp and held to [CLUSTER_THREADS_LEAST,
    CLUSTER_THREADS], at most ceil(rows / 2 C) rounded up to a warp; k =
    ceil(rows / (C T)) >= 2 rows a thread; the
    rows' scratch in shared memory where cluster_smem of the D-N kernel
    (``dn``; the larger) fits SMEM_LIMIT beside CLUSTER_STATIC_BYTES, else
    in device memory. Raises on a shape the kernels refuse.

    NEWTON_RULE comes from the forced pairs of PERF.md section 6
    (tools/resident_split.py --kernel newton_dd_large|newton_dn_large,
    NVIDIA H100 80GB HBM3, 700 W; us a further iteration, D-D / D-N): at
    4,096, 16,384 and 262,144 rows in float32 and 16,384 in float64 the
    cluster mode at C = 16 beat the mode 'single' (5.91 / 7.18, 7.65 /
    10.55, 35.22 / 56.76, 12.51 / 16.74 against 10.52 / 13.07, 23.35 /
    39.20, 283.90 / 455.99, 52.77 / 72.15) and C = 2-8 (C = 8 5.84 against
    5.91 for D-D at 4,096, within the spread), so both dtypes take C = 16
    from 1,025 rows. The threads a CTA: a sweep of T = 128-512 at C =
    2-16 put the best at about 8 rows a thread (T = 128 at 4,096 and
    16,384, T = 512 at 262,144)."""
    if rows <= SMALL_MAX_ROWS:
        raise ValueError(f"the large path takes more than {SMALL_MAX_ROWS} "
                         f"rows, got {rows}")
    mode = _rule(rows, item)[0] if mode is None else mode
    if mode == "single":
        k, t = large_split(rows, item)
        halo = 1 << max(0, (2 * t - 1).bit_length() - 1)  # pcr_halo(2 T)
        smem = (2 * (2 * t + 2 * halo) * (4 * item + (item if dn else 0))
                + 2 * t * item)  # newton_smem<R>(2 T)
        return LargeShape("single", 1, t, k, smem, False)
    if mode != "cluster":
        raise ValueError(f"large path mode {mode!r}: one of {LARGE_MODES}")
    c = _rule(rows, item)[1] if cluster is None else cluster
    if not (2 <= c <= CLUSTER_MAX and c & (c - 1) == 0):
        raise ValueError(f"a cluster of {c} CTAs: a power of two in [2, {CLUSTER_MAX}]")
    if threads is None:
        want = -(-(-(-rows // (c * CLUSTER_ROWS_A_THREAD))) // _WARP) * _WARP
        threads = min(CLUSTER_THREADS, max(CLUSTER_THREADS_LEAST, want))
    elif not (_WARP <= threads <= CLUSTER_THREADS and threads % _WARP == 0):
        raise ValueError(f"{threads} threads a CTA: a multiple of {_WARP} up to "
                         f"{CLUSTER_THREADS}")
    t = min(threads, -(-(-(-rows // (2 * c))) // _WARP) * _WARP)  # k >= 2
    k = -(-rows // (c * t))
    fits = (cluster_smem(dn, item, c, t, k, True) + CLUSTER_STATIC_BYTES
            <= SMEM_LIMIT)
    return LargeShape("cluster", c, t, k, cluster_smem(dn, item, c, t, k, fits), fits)


def newton_scalars(te: float, dx: float, tol: float,
                   dtype: torch.dtype = torch.float32):
    """(c1, dx^2, tol, step_max) as the JAX solve forms them in ``dtype``:
    float64 on the host, rounded to float32 once for a float32 state (the
    Pallas wrapper's np.float32), kept in float64 for a float64 one (XLA's
    float64 loop: its Python scalars in the state's dtype). Each a Python
    float."""
    f = real(dtype)
    c1 = float(E_CHARGE / (K_BOLTZMANN * float(te)))
    dx2 = float(dx) * float(dx)
    return (float(f(c1)), float(f(dx2)), float(f(tol)),
            float(f(_EXP_CLAMP / c1)))


def _coef(dtype: torch.dtype) -> float:
    """e / eps0 in ``dtype`` (the kernels' c0 = coef n0 and the D-N c2)."""
    return float(real(dtype)(E_CHARGE / EPSILON_0))


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
    f_i over the rows of the last axis (rows past the physical ones are
    identity rows, and so is a row read past either end). ``f`` is (rows,)
    or (R, rows): R right-hand sides that share the elimination
    coefficients; a leading axis of a, b, c (and f) holds independent
    systems. The stages end, as the kernels' do, once no row is coupled
    (every a and c 0): the stages left would change no value (a batch ends
    with its last system, which changes at most the sign of a zero)."""
    rows = a.shape[-1]
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


def _block_ends(a, b, c, f, k: int, blocks: int):
    """The sweeps of the large path over ``blocks`` blocks of k rows, in the
    kernels' order: a sweep down normalises a block's rows 0 and 1 and
    takes each later row's coupling to the row above out (the fill-in a
    coupling to the block's row 0); a sweep up takes each inner row's
    coupling to the row below out, then row 0's to row 1. Returns the
    inner rows' (a', c', d') as (blocks, k) (d' with f's leading axis),
    then the blocks' first and last rows (a, c, f; b = 1): a first row
    couples to the last row of the block before and to x_(k-1), a last
    row to x_0 and to the first row of the block after."""
    lead = f.shape[:-1]
    A, B, C = (t.reshape(blocks, k) for t in (a, b, c))
    F = f.reshape(lead + (blocks, k))
    ap, cp, dp = torch.empty_like(A), torch.empty_like(A), torch.empty_like(F)
    for j in range(k):
        if j < 2:
            ap[:, j] = A[:, j] / B[:, j]
            cp[:, j] = C[:, j] / B[:, j]
            dp[..., j] = F[..., j] / B[:, j]
        else:
            den = B[:, j] - A[:, j] * cp[:, j - 1]
            ap[:, j] = -(A[:, j] * ap[:, j - 1]) / den
            cp[:, j] = C[:, j] / den
            dp[..., j] = (F[..., j] - A[:, j] * dp[..., j - 1]) / den
    for j in range(k - 3, 0, -1):
        dp[..., j] = dp[..., j] - cp[:, j] * dp[..., j + 1]
        ap[:, j] = ap[:, j] - cp[:, j] * ap[:, j + 1]
        cp[:, j] = -(cp[:, j] * cp[:, j + 1])
    a0, c0, d0 = ap[:, 0], cp[:, 0], dp[..., 0]
    if k >= 3:  # with k = 2, row 0 already couples to x_(k-1)
        den = 1.0 - c0 * ap[:, 1]
        a0, c0, d0 = (a0 / den, -(c0 * cp[:, 1]) / den,
                      (d0 - c0 * dp[..., 1]) / den)
    return (ap, cp, dp), (a0, c0, d0), (ap[:, -1], cp[:, -1], dp[..., -1])


def _ends(first, last):
    """[first_0, last_0, first_1, ...] along the last axis."""
    return torch.stack([first, last], dim=-1).flatten(-2)


def _recover(inner, xf, xl):
    """Every block row from its block's end values x_0 = xf and x_(k-1) =
    xl: x_j = d'_j - a'_j x_0 - c'_j x_(k-1). Returns the rows in order."""
    ap, cp, dp = inner
    xf, xl = xf[..., None], xl[..., None]
    out = dp - ap * xf - cp * xl
    out[..., 0] = xf[..., 0]
    out[..., -1] = xl[..., 0]
    return out.flatten(-2)


def _partition_solve(a, b, c, f, k: int, threads: int):
    """The large path's solve ('single') of a_i x_{i-1} + b_i x_i + c_i
    x_{i+1} = f_i over rows = threads x k rows (identity rows past the
    physical ones), in the kernels' operation order. ``f`` is (rows,) or
    (R, rows). Block t holds rows t k .. t k + k - 1, reduced to its end
    rows by ``_block_ends``; the blocks' first and last rows form a
    tridiagonal system of 2 threads rows, solved by ``_pcr_solve``, and
    the inner rows are recovered."""
    inner, (a0, c0, d0), (al, cl, dl) = _block_ends(a, b, c, f, k, threads)
    x = _pcr_solve(_ends(a0, al),
                   torch.ones((2 * threads,), dtype=a.dtype, device=a.device),
                   _ends(c0, cl), _ends(d0, dl))
    return _recover(inner, x[..., 0::2], x[..., 1::2])


def _cluster_solve(a, b, c, f, cluster: int, threads: int, k: int):
    """The cluster mode's solve over rows = cluster x threads x k rows, in
    the kernel's operation order (csrc/newton.cu newton_cluster_kernel).
    The blocks' end rows as in ``_partition_solve``; CTA r's 2 T of them
    with its first row F_r and last L_r set apart: row 1's coupling to F_r
    and row 2 T - 2's to L_r become the columns p and q beside the R
    right-hand sides, rows 0 and 2 T - 1 identity rows, and one PCR solves
    every CTA's inner rows (x = y - p F_r - q L_r). Rows 1 and 2 T - 2
    substituted into rows 0 and 2 T - 1 give the CTA's two rows of a
    tridiagonal system of 2 C rows in (F_0, L_0, F_1, ...), solved by the
    same PCR; then the end rows, then the inner rows."""
    C, T = cluster, threads
    one = f.dim() == 1
    F = f[None] if one else f
    inner, (a0, c0, d0), (al, cl, dl) = _block_ends(a, b, c, F, k, C * T)
    ra, rc = _ends(a0, al).reshape(C, 2 * T), _ends(c0, cl).reshape(C, 2 * T)
    rf = _ends(d0, dl).reshape(F.shape[0], C, 2 * T)
    ia, ic, cols = ra.clone(), rc.clone(), torch.zeros(
        (F.shape[0] + 2, C, 2 * T), dtype=a.dtype, device=a.device)
    cols[:-2] = rf
    cols[-2, :, 1] = ra[:, 1]  # p: row 1's coupling to F_r
    ia[:, 1] = 0.0
    cols[-1, :, -2] = rc[:, -2]  # q: row 2 T - 2's coupling to L_r
    ic[:, -2] = 0.0
    for edge in (0, -1):  # rows 0 and 2 T - 1: identity rows
        ia[:, edge] = 0.0
        ic[:, edge] = 0.0
        cols[:, :, edge] = 0.0
    sol = _pcr_solve(ia, torch.ones_like(ia), ic, cols)
    y, p, q = sol[:-2], sol[-2], sol[-1]
    # F_r: a0 L_(r-1) + (1 - c0 p_1) F_r - c0 q_1 L_r = f0 - c0 y_1
    # L_r: -aL p_(2T-2) F_r + (1 - aL q_(2T-2)) L_r + cL F_(r+1) = fL - aL y_(2T-2)
    e0a, e0c, eLa, eLc = ra[:, 0], rc[:, 0], ra[:, -1], rc[:, -1]
    z = _pcr_solve(_ends(e0a, -(eLa * p[:, -2])),
                   _ends(1.0 - e0c * p[:, 1], 1.0 - eLa * q[:, -2]),
                   _ends(-(e0c * q[:, 1]), eLc),
                   _ends(rf[..., 0] - e0c * y[..., 1], rf[..., -1] - eLa * y[..., -2]))
    fr, lr = z[..., 0::2, None], z[..., 1::2, None]
    x = y - p * fr - q * lr
    x[..., 0] = fr[..., 0]
    x[..., -1] = lr[..., 0]
    x = x.reshape(F.shape[0], C * 2 * T)
    out = _recover(inner, x[..., 0::2], x[..., 1::2])
    return out[0] if one else out


def _tridiag_solve(a, b, c, f, shape: LargeShape | None):
    """The solve of the ``solve_rows`` rows as the kernel of ``shape`` runs
    it: ``_pcr_solve`` on the small path (None), ``_partition_solve`` in
    the mode 'single', ``_cluster_solve`` in 'cluster'."""
    if shape is None:
        return _pcr_solve(a, b, c, f)
    if shape.mode == "single":
        return _partition_solve(a, b, c, f, shape.k, shape.threads)
    return _cluster_solve(a, b, c, f, shape.cluster, shape.threads, shape.k)


def _sum_sq(dphi, ng: int):
    """sum(dphi^2) as the plain loop tests it: in float32 up to
    SMALL_MAX_ROWS; above, in float64 rounded to float32, as the large
    path's per-thread float64 sums; a float64 dphi in float64."""
    sq = dphi * dphi
    if ng <= SMALL_MAX_ROWS or sq.dtype == torch.float64:
        return torch.sum(sq)
    return torch.sum(sq.double()).float()


# the large path's scratch, floats a row (csrc/newton.cu): 4 + R for the
# Newton solves (R = 1 D-D, 2 D-N), 2 + R for the chain (R = 3)
_SCRATCH_ROWS = {"boltzmann_dirichlet": 5, "boltzmann_dn": 6, "tridiag3_chain": 5}


def _path(what: str, rows: int, dev, dtype: torch.dtype = torch.float32,
          mode: str | None = None):
    """The kernel ``what`` launches for ``rows`` on ``dev`` in ``dtype``:
    (its launch count's name, its LargeShape or None, scratch or None).
    Up to SMALL_MAX_ROWS the one-CTA kernel; above, the large path in the
    mode ``large_shape`` gives (``mode`` forced; the chain has the mode
    'single' alone) with its scratch (none when the rows'
    scratch lies in shared memory); the double kernels' names end in
    ``_f64``. Raises above LARGE_MAX_ROWS."""
    suffix = "_f64" if dtype == torch.float64 else ""
    if rows <= SMALL_MAX_ROWS:
        return what + suffix, None, None
    if rows > LARGE_MAX_ROWS:
        raise ValueError(
            f"{what} takes at most {LARGE_MAX_ROWS} rows on the card (the "
            f"large path's int offsets into its scratch), got {rows}")
    item = torch.finfo(dtype).bits // 8
    if what == "tridiag3_chain":
        mode = "single"
    shape = large_shape(rows, item, mode, dn=what == "boltzmann_dn")
    scratch = None
    if not shape.shared:
        scratch = torch.empty((_SCRATCH_ROWS[what] * shape.rows,), dtype=dtype,
                              device=dev)
    return f"{what}_large{suffix}", shape, scratch


@functools.lru_cache(maxsize=None)
def _max_clusters(index: int, dn: bool, f64: bool, shape: LargeShape) -> int:
    """Clusters of ``shape``'s cluster launch the card ``index`` holds at
    once (cudaOccupancyMaxActiveClusters); raises if it cannot hold one."""
    count = ctypes.c_int(0)
    with torch.cuda.device(index):
        err = _build.library().pypic_newton_clusters(
            int(dn), int(f64), shape.k, shape.threads, shape.cluster, int(shape.shared),
            ctypes.byref(count))
    _build.check(err, "the Newton cluster mode (occupancy)")
    if count.value < 1:
        raise RuntimeError(
            f"the Newton cluster mode: {torch.cuda.get_device_name(index)} cannot hold "
            f"one cluster of {shape.cluster} CTAs x {shape.threads} threads with "
            f"{shape.smem} B of shared memory a CTA (cudaOccupancyMaxActiveClusters = 0)")
    return count.value


def _launch_large(what: str, name: str, shape: LargeShape, scratch, ptrs, scalars, dev,
                  ng: int) -> None:
    """One launch of the large path of ``what`` (the Newton solves) in
    ``shape``'s mode: the one-CTA entry point ``pypic_{what}_large`` or the
    cluster's ``pypic_{what}_cluster`` (``_f64`` last for doubles), counted
    under ``name`` and, by mode, in LARGE_LAUNCHES ("name mode"). A cluster
    the card cannot hold raises."""
    f64 = name.endswith("_f64")
    lib = _build.library()
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    scr = None if scratch is None else scratch.data_ptr()
    with torch.cuda.device(dev):
        if shape.mode == "single":
            fn = getattr(lib, f"pypic_{name}")
            err = fn(*ptrs, scr, ng, shape.k, shape.threads, *scalars)
        else:
            _max_clusters(index, what == "boltzmann_dn", f64, shape)
            fn = getattr(lib, f"pypic_{what}_cluster" + ("_f64" if f64 else ""))
            err = fn(*ptrs, scr, ng, shape.k, shape.threads, shape.cluster,
                     int(shape.shared), *scalars)
    _build.check(err, f"{name} ({shape.mode})")
    LAUNCHES[name] += 1
    LARGE_LAUNCHES[f"{name} {shape.mode}"] += 1


def _as_n0(n0, dev, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """n0 as a (1,) tensor of ``dtype`` on ``dev`` (a device tensor stays
    on the device: no host read)."""
    if isinstance(n0, torch.Tensor):
        if n0.device != dev:
            raise ValueError(f"n0 lies on {n0.device}, rho on {dev}")
        return n0.reshape(1).to(dtype)
    return torch.full((1,), float(n0), dtype=dtype, device=dev)


def _start(rho, phi0):
    ng = rho.shape[0]
    if phi0 is None:
        return torch.zeros((ng,), dtype=rho.dtype, device=rho.device)
    start = phi0.to(rho.dtype).clone()
    start[0] = 0.0
    start[-1] = 0.0
    return start


def boltzmann_dirichlet_plain(rho, n0, te, dx, tol=1e-9, maxiter=1000,
                              phi0=None, mode=None):
    """The kernel's Newton loop as tensor operations (pallas_newton.py
    _newton_dd_kernel), in its operation order, in rho's dtype (float32,
    or float64: the double kernel's scalars and residual); above
    SMALL_MAX_ROWS in the large path's mode (``large_shape``; ``mode``
    forces it). Returns NewtonResult."""
    ng = rho.shape[0]
    dev, dtype = rho.device, rho.dtype
    shape = (None if ng <= SMALL_MAX_ROWS else
             large_shape(ng, rho.element_size(), mode, dn=False))
    rows = kernel_rows(ng) if shape is None else shape.rows
    c1, dx2, tol32, step_max = newton_scalars(te, dx, tol, dtype)
    c0 = _coef(dtype) * _as_n0(n0, dev, dtype)[0]
    col = torch.arange(rows, device=dev)
    valid = col < ng
    interior = (col >= 1) & (col <= ng - 2)
    boundary = valid & ~interior
    a_lap = interior.to(dtype)
    c_lap = a_lap
    d_lap = torch.where(interior, -2.0, 1.0).to(dtype)
    pad = rows - ng
    zeros = torch.zeros((pad,), dtype=dtype, device=dev)
    c2 = torch.cat([rho / float(real(dtype)(EPSILON_0)), zeros])
    phi = torch.cat([_start(rho, phi0), zeros])
    dx2_c0 = dx2 * c0
    jac_b = -dx2 * c0 * c1
    residual = torch.ones((), dtype=dtype, device=dev)
    it = 0
    while residual.item() > tol32 and it < maxiter:
        expo = torch.exp(torch.clamp(c1 * phi, -_EXP_CLAMP, _EXP_CLAMP))
        lap = (a_lap * _shift_down(phi, 1, 0.0) + d_lap * phi
               + c_lap * _shift_up(phi, 1, 0.0))
        f = lap - dx2_c0 * expo + dx2 * c2
        f = torch.where(interior, f, 0.0)
        ddiag = torch.where(interior, jac_b * expo,
                            torch.where(boundary, jac_b, 0.0))
        dphi = _tridiag_solve(a_lap, d_lap + ddiag, c_lap, f, shape)
        dphi = torch.clamp(dphi, -step_max, step_max)
        phi = phi - dphi
        residual = _sum_sq(dphi, ng)
        it += 1
    phi = phi[:ng]
    return NewtonResult(phi - torch.min(phi),
                        torch.tensor(it, dtype=torch.int32, device=dev),
                        residual)


def boltzmann_dirichlet(rho, n0, te, dx, tol=1e-9, maxiter=1000, phi0=None,
                        mode=None):
    """Newton-Boltzmann D-D solve of the (ng,) float32 or float64 charge
    density rho for the potential, in one kernel launch on a CUDA tensor
    (the large path above SMALL_MAX_ROWS nodes, up to LARGE_MAX_ROWS, in
    the mode ``large_shape`` gives, or ``mode`` forced: 'single' or
    'cluster'; a float64 rho the double kernel, counted under ``_f64``).

    ``n0`` is the Boltzmann reference density: a Python number or a 0-d
    tensor on rho's device (read there by the kernel). ``phi0`` is the warm
    start or None (cold start at 0); its walls are pinned to 0. The
    residual is sum(dphi^2) of the last iteration, tested against
    ``tol`` in rho's dtype. Returns NewtonResult(phi shifted to min 0 over
    the physical rows, iterations (int32), residual), each on rho's
    device.
    """
    tensors = (rho,) if phi0 is None else (rho, phi0)
    kind = _device_kind(tensors, "boltzmann_dirichlet")
    ng = rho.shape[0] if rho.dim() == 1 else -1
    _check_1d("rho", rho, ng)
    if phi0 is not None:
        _check_1d("phi0", phi0, ng)
    if ng < 3:
        raise ValueError(f"boltzmann_dirichlet needs ng >= 3, got ng={ng}")
    if kind == "cpu":
        return boltzmann_dirichlet_plain(rho, n0, te, dx, tol=tol,
                                         maxiter=maxiter, phi0=phi0, mode=mode)
    dev, dtype = rho.device, rho.dtype
    name, shape, scratch = _path("boltzmann_dirichlet", ng, dev, dtype, mode)
    n0_t = _as_n0(n0, dev, dtype)
    c1, dx2, tol32, step_max = newton_scalars(te, dx, tol, dtype)
    phi = torch.empty((ng,), dtype=dtype, device=dev)
    iters = torch.empty((), dtype=torch.int32, device=dev)
    resid = torch.empty((), dtype=dtype, device=dev)
    ptrs = (rho.data_ptr(), n0_t.data_ptr(),
            None if phi0 is None else phi0.data_ptr(), phi.data_ptr(),
            iters.data_ptr(), resid.data_ptr())
    scalars = (_coef(dtype), float(real(dtype)(EPSILON_0)), c1, dx2, tol32,
               int(maxiter), step_max, _EXP_CLAMP, _stream(dev))
    if shape is not None:
        _launch_large("boltzmann_dirichlet", name, shape, scratch, ptrs, scalars, dev, ng)
        return NewtonResult(phi, iters, resid)
    with torch.cuda.device(dev):
        err = getattr(_build.library(), f"pypic_{name}")(*ptrs, ng, kernel_rows(ng), *scalars)
    _build.check(err, name)
    LAUNCHES[name] += 1
    return NewtonResult(phi, iters, resid)


def boltzmann_dn_plain(n, n0, te, dx, phi0, tol=1e-3, maxiter=100, mode=None):
    """The D-N kernel's Newton loop as tensor operations (pallas_newton.py
    _newton_dn_kernel), in its operation order, in n's dtype (float32 or
    float64); above SMALL_MAX_ROWS in the large path's mode (``mode``
    forces it). Returns NewtonResult."""
    ng = n.shape[0]
    dev, dtype = n.device, n.dtype
    shape = (None if ng <= SMALL_MAX_ROWS else
             large_shape(ng, n.element_size(), mode, dn=True))
    rows = kernel_rows(ng) if shape is None else shape.rows
    c1, dx2, tol32, step_max = newton_scalars(te, dx, tol, dtype)
    coef = _coef(dtype)
    c0 = coef * _as_n0(n0, dev, dtype)[0]
    col = torch.arange(rows, device=dev)
    valid = col < ng
    inner = (col >= 1) & (col <= ng - 2)
    last = col == ng - 1
    a_lap = torch.where(inner, 1.0, torch.where(last, -4.0, 0.0)).to(dtype)
    c_lap = inner.to(dtype)
    d_lap = torch.where(inner, -2.0, torch.where(last, 3.0, 1.0)).to(dtype)
    u_row = last.to(dtype)  # rank-1 u = e_{ng-1}
    zeros = torch.zeros((rows - ng,), dtype=dtype, device=dev)
    c2 = torch.cat([n * coef, zeros])
    phi = torch.cat([phi0.to(dtype), zeros])
    dx2_c0 = dx2 * c0
    jac_b = -dx2 * c0 * c1
    residual = torch.ones((), dtype=dtype, device=dev)
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
        y, z = _tridiag_solve(a_lap, d_lap + ddiag, c_lap,
                              torch.stack([f, u_row]), shape)
        dphi = y - z * (y[ng - 3] / (1.0 + z[ng - 3]))
        dphi = torch.clamp(dphi, -step_max, step_max)
        phi = phi - dphi
        residual = torch.sqrt(_sum_sq(dphi, ng))
        it += 1
    phi = phi[:ng]
    return NewtonResult(phi - torch.min(phi),
                        torch.tensor(it, dtype=torch.int32, device=dev),
                        residual)


def boltzmann_dn(n, n0, te, dx, phi0, tol=1e-3, maxiter=100, mode=None):
    """Newton-Boltzmann D-N solve of the (ng,) float32 or float64 number
    density n for the potential, in one kernel launch on a CUDA tensor
    (the large path above SMALL_MAX_ROWS nodes, up to LARGE_MAX_ROWS, in
    the mode ``large_shape`` gives, or ``mode`` forced: 'single' or
    'cluster'; a float64 n the double kernel, counted under ``_f64``).

    ``n0`` is the Boltzmann reference density, a Python number or a 0-d
    tensor on n's device; ``phi0`` the (ng,) warm start, used as it is (no
    wall pin: the reference warm-starts this Newton from its previous phi,
    pygcpic.py:1083). The residual is ||dphi||_2 of the last iteration,
    tested against ``tol`` in n's dtype. Returns NewtonResult(phi shifted to
    min 0 over the physical rows, iterations (int32), residual), each on
    n's device, with no host read.
    """
    kind = _device_kind((n, phi0), "boltzmann_dn")
    ng = n.shape[0] if n.dim() == 1 else -1
    _check_1d("n", n, ng)
    _check_1d("phi0", phi0, ng)
    if ng < 3:
        raise ValueError(f"boltzmann_dn needs ng >= 3, got ng={ng}")
    if kind == "cpu":
        return boltzmann_dn_plain(n, n0, te, dx, phi0, tol=tol,
                                  maxiter=maxiter, mode=mode)
    dev, dtype = n.device, n.dtype
    name, shape, scratch = _path("boltzmann_dn", ng, dev, dtype, mode)
    n0_t = _as_n0(n0, dev, dtype)
    c1, dx2, tol32, step_max = newton_scalars(te, dx, tol, dtype)
    phi = torch.empty((ng,), dtype=dtype, device=dev)
    iters = torch.empty((), dtype=torch.int32, device=dev)
    resid = torch.empty((), dtype=dtype, device=dev)
    ptrs = (n.data_ptr(), n0_t.data_ptr(), phi0.data_ptr(), phi.data_ptr(),
            iters.data_ptr(), resid.data_ptr())
    scalars = (_coef(dtype), c1, dx2, tol32, int(maxiter), step_max, _EXP_CLAMP,
               _stream(dev))
    if shape is not None:
        _launch_large("boltzmann_dn", name, shape, scratch, ptrs, scalars, dev, ng)
        return NewtonResult(phi, iters, resid)
    with torch.cuda.device(dev):
        err = getattr(_build.library(), f"pypic_{name}")(*ptrs, ng, kernel_rows(ng), *scalars)
    _build.check(err, name)
    LAUNCHES[name] += 1
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
    ``kernel_rows(c)`` rows, or above SMALL_MAX_ROWS ``_partition_solve``
    over ``solve_rows(c)`` (identity rows past c), with the (3, rows)
    right-hand side [f, e_0, e_(c-1)], the couplings dl[0] and du[c-1]
    left out. Returns ((3, c) [xp, u, w], (6,) interface scalars)."""
    c = d.shape[0]
    shape = None if c <= SMALL_MAX_ROWS else large_shape(c, mode="single")
    rows = kernel_rows(c) if shape is None else shape.rows
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
    x = _tridiag_solve(a, b, cu, rhs, shape)[:, :c].contiguous()
    return x, _chain_scalars(x, dl, du, first, last)


def tridiag3_chain(dl, d, du, f, *, first: bool, last: bool):
    """One rank's local chain solve: the (c,) float32 rows dl[i] x[i-1] +
    d[i] x[i] + du[i] x[i+1] = rhs[i] with dl[0] and du[c-1] (the
    couplings to the neighbouring slabs) left out, for rhs = f, e_0 and
    e_(c-1), in one kernel launch on CUDA tensors (the large path above
    SMALL_MAX_ROWS rows, up to LARGE_MAX_ROWS). ``first``
    / ``last``: the rank is the chain's first / last (no coupling there).
    Returns ((3, c) [xp, u, w], (6,) [xp_0, xp_(c-1), a0 u_0,
    a0 u_(c-1), cc w_0, cc w_(c-1)]), on the inputs' device, with no host
    read."""
    kind = _device_kind((dl, d, du, f), "tridiag3_chain")
    c = d.shape[0] if d.dim() == 1 else -1
    for name, t in (("dl", dl), ("d", d), ("du", du), ("f", f)):
        _check_1d(name, t, c)
    if c < 2:
        raise ValueError(f"tridiag3_chain needs c >= 2, got c={c}")
    if kind == "cpu":
        return tridiag3_chain_plain(dl, d, du, f, first=first, last=last)
    dev = d.device
    name, shape, scratch = _path("tridiag3_chain", c, dev)
    lib = _build.library()
    x = torch.empty((3, c), dtype=torch.float32, device=dev)
    g6 = torch.empty((6,), dtype=torch.float32, device=dev)
    ptrs = (dl.data_ptr(), d.data_ptr(), du.data_ptr(), f.data_ptr(),
            x.data_ptr(), g6.data_ptr())
    with torch.cuda.device(dev):
        if shape is None:
            err = lib.pypic_tridiag3_chain(*ptrs, c, kernel_rows(c),
                                           int(first), int(last), _stream(dev))
        else:
            err = lib.pypic_tridiag3_chain_large(
                *ptrs, scratch.data_ptr(), c, shape.k, shape.threads, int(first),
                int(last), _stream(dev))
    _build.check(err, name)
    LAUNCHES[name] += 1
    return x, g6
