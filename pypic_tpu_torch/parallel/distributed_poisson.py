"""Distributed tridiagonal solves by substructuring over the slab mesh (the
counterpart of ``pypic_tpu/parallel/distributed_poisson.py``).

The replicated periodic solve (``ops.poisson.solve_periodic_neutralized``)
gathers the whole (ng,) charge on every rank. The substructured solve
keeps the work slab-local: each rank solves its own (c,) interior system
T x = b (T = tridiag(1, -2, 1), Dirichlet ends), and the 2 S interface
unknowns, each slab's first and last node, satisfy a (2S, 2S) system that
couples only the neighbours' end values. Back substitution is local:
x = xp - z_left u - y_right w, with u = T^-1 e_0 and w = T^-1 e_(c-1).

``make_distributed_periodic_poisson``: T, u, w, the interface matrix and
its inverse are constant, as the JAX module bakes them. Here every one of
them is baked in float64 at build, and so is every step of the solve that
is linear in the charge:

* the local solve y = s T^-1 rho (s = -dx^2 / eps0) is the closed form
  of T^-1, two prefix sums (T^-1_IJ = -min(I, J) (c + 1 - max(I, J)) /
  (c + 1), 1-based), in float64 on the tensors' device: a handful of
  launches in place of the ~6 c of the Python-loop Thomas
  (``ops.tridiag``); u and w are its first and last columns;
* the mean of rho, the interface values, the interface solve and the mean
  of phi are linear in four numbers a rank (its sum of rho, y's two end
  values and its sum of y), which one ``all_gather`` carries: the JAX
  module's two ``psum``s and its all_gather of the two end values become
  one collective of four scalars a rank, and the four coefficients of
  the back substitution are one (4, 4 S) matrix-vector product;
* phi = y - [v1, u, w, 1] @ coefficients (v1 = s T^-1 1) in one more.

The gauge is JAX's: the first interface unknown pinned to 0 (the dropped
equation is redundant for a neutralized right-hand side), then the mean
of phi subtracted, so phi matches ``solve_periodic_neutralized``'s
zero-mean representative.

``make_distributed_tridiag_chain``: the same substructuring with
coefficients that change every call (the Newton-Boltzmann Jacobian of
``parallel.domain_magnetized``), on a chain of slabs. Each rank's local
system with its three right-hand sides [f, e_0, e_(c-1)] is one launch of
the ``tridiag3_chain`` kernel (``ops.cuda_newton``; its plain version on
the CPU), which also writes the rank's six interface scalars; one
``all_gather`` carries them, and the (2S, 2S) interface system is solved
on every rank by ``torch.linalg.solve_ex`` (which reads no error code
back), so the solve makes no host read. On one rank the interface
couples nothing and the solve is the launch alone.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import EPSILON_0
from ..ops import cuda_newton
from .mesh import SlabMesh


def _interface_matrix(u: np.ndarray, w: np.ndarray, d_tot: int) -> np.ndarray:
    """The (2S, 2S) cyclic interface system of the JAX module, unknowns
    t = [y_0, z_0, y_1, z_1, ...] (y_d = x_d[0], z_d = x_d[c - 1]):
    y_d + u[0] z_(d-1) + w[0] y_(d+1) = xp_d[0] and the same with u[-1],
    w[-1] for z_d; row 0 replaced by the gauge pin y_0 = 0."""
    m = np.zeros((2 * d_tot, 2 * d_tot))
    for dd in range(d_tot):
        left, right = (dd - 1) % d_tot, (dd + 1) % d_tot
        m[2 * dd, 2 * dd] = 1.0
        m[2 * dd, 2 * left + 1] += u[0]
        m[2 * dd, 2 * right] += w[0]
        m[2 * dd + 1, 2 * dd + 1] = 1.0
        m[2 * dd + 1, 2 * left + 1] += u[-1]
        m[2 * dd + 1, 2 * right] += w[-1]
    m[0, :] = 0.0
    m[0, 0] = 1.0
    return m


def make_distributed_periodic_poisson(ng: int, dx: float, num_shards: int,
                                      mesh: SlabMesh):
    """Build this rank's slab-local solver: ``solve(rho_own) -> phi_own``,
    both the (ng / S,) float32 slab of ``mesh.rank``.

    Matches ``ops.poisson.solve_periodic_neutralized`` up to float32
    rounding: the zero-mean phi of A phi = -dx^2 (rho - <rho>) / eps0.
    Every rank of ``mesh`` calls it with its own slab."""
    if ng % num_shards:
        raise ValueError(f"ng={ng} not divisible by {num_shards} shards")
    if mesh.world != num_shards:
        raise ValueError(f"num_shards={num_shards} but the mesh has "
                         f"{mesh.world} ranks: one slab a rank")
    c = ng // num_shards
    if c < 2:
        raise ValueError("need at least 2 nodes per shard")
    d_tot, d = num_shards, mesh.rank
    s = -(dx * dx) / EPSILON_0

    # y = s T^-1 rho = k (c + 1 - I) A_I + k I (B_c - B_I), A and B the
    # prefix sums of J rho_J and (c + 1 - J) rho_J, k = -s / (c + 1)
    j = np.arange(1, c + 1, dtype=np.float64)
    k = -s / (c + 1)
    ramps = np.stack([j, c + 1.0 - j])
    # T^-1 is symmetric, so its first and last rows are the response
    # vectors u = T^-1 e_0 and w = T^-1 e_(c-1); its row sums are
    # T^-1 1 = -I (c + 1 - I) / 2
    u, w = -(c + 1.0 - j) / (c + 1.0), -j / (c + 1.0)
    v1 = s * (-j * (c + 1.0 - j) / 2.0)  # s T^-1 1
    m_inv = np.linalg.inv(_interface_matrix(u, w, d_tot))

    # what a rank contributes: [sum rho, y[0], y[-1], sum y] = P rho
    p_local = np.stack([np.ones(c), s * u, s * w, v1])
    # the back substitution's coefficients [<rho>, z_left, y_right, <x>]
    # as linear functions of the gathered G (S x 4, flattened)
    n_g = 4 * d_tot

    def pick(rank, slot):
        row = np.zeros(n_g)
        row[4 * rank + slot] = 1.0
        return row

    mean_rho = sum(pick(r, 0) for r in range(d_tot)) / ng
    g_if = np.stack([row for r in range(d_tot) for row in (
        pick(r, 1) - v1[0] * mean_rho, pick(r, 2) - v1[-1] * mean_rho)])
    g_if[0] = 0.0  # the pinned row's entry
    t_lin = m_inv @ g_if

    def z_left(rank):
        return t_lin[2 * ((rank - 1) % d_tot) + 1]

    def y_right(rank):
        return t_lin[2 * ((rank + 1) % d_tot)]

    sum_x = [pick(r, 3) - v1.sum() * mean_rho - u.sum() * z_left(r)
             - w.sum() * y_right(r) for r in range(d_tot)]
    mean_x = sum(sum_x) / ng
    coef = np.stack([mean_rho, z_left(d), y_right(d), mean_x])  # (4, 4S)
    back = np.stack([v1, u, w, np.ones(c)], axis=1)  # (c, 4)

    f64 = dict(dtype=torch.float64, device=mesh.device)
    ramps_t = torch.tensor(ramps, **f64)
    scale_a = torch.tensor(k * (c + 1.0 - j), **f64)
    scale_b = torch.tensor(k * j, **f64)
    p_t = torch.tensor(p_local, **f64)
    coef_t = torch.tensor(coef, **f64)
    back_t = torch.tensor(back, **f64)

    def solve(rho_own: torch.Tensor) -> torch.Tensor:
        r = rho_own.to(torch.float64)
        sums = torch.cumsum(ramps_t * r, dim=1)
        y = torch.addcmul(scale_a * sums[0], scale_b, sums[1, -1] - sums[1])
        g = mesh.all_gather(p_t @ r)  # (4 S,): four scalars a rank
        return torch.addmv(y, back_t, coef_t @ g, alpha=-1.0).to(torch.float32)

    return solve


def make_distributed_tridiag_chain(c: int, num_shards: int, mesh: SlabMesh):
    """Distributed tridiagonal solve with coefficients given at each call,
    on a chain of slabs (no wrap): ``solve(dl_own, d_own, du_own, f_own)
    -> x_own``, each operand the (c,) float32 slab of ``mesh.rank`` of the
    global system A x = f (dl[i] = A[i, i-1], du[i] = A[i, i+1]).

    Shard 0's first row and shard S-1's last row carry the global ends
    (their outer couplings unused), so the interface matrix is
    block-bidiagonal. For diagonally dominant systems (the Boltzmann
    Jacobian is); not a pivoted solver. As the JAX module: the local
    3-column solve (one ``tridiag3_chain`` launch at any c on the card),
    an all_gather of six scalars a rank, the (2S, 2S) interface system
    solved on every rank in float32."""
    d_tot = num_shards
    if c < 2:
        raise ValueError("need at least 2 nodes per shard")
    if mesh.world != num_shards:
        raise ValueError(f"num_shards={num_shards} but the mesh has "
                         f"{mesh.world} ranks: one slab a rank")
    d = mesh.rank
    first, last = d == 0, d == d_tot - 1
    dev = mesh.device
    # the interface matrix's scatter: row 2e takes a0 u[0] at z_(e-1) and
    # cc w[0] at y_(e+1); row 2e+1 the same with u[-1], w[-1]
    rows, cols = [], []
    for dd in range(d_tot):
        left, right = (dd - 1) % d_tot, (dd + 1) % d_tot
        rows += [2 * dd, 2 * dd, 2 * dd + 1, 2 * dd + 1]
        cols += [2 * left + 1, 2 * right, 2 * left + 1, 2 * right]
    rows_t = torch.tensor(rows, dtype=torch.int64, device=dev)
    cols_t = torch.tensor(cols, dtype=torch.int64, device=dev)
    # per rank [a0 u0, cc w0, a0 u1, cc w1] of its six scalars
    vals_t = torch.tensor([2, 4, 3, 5], dtype=torch.int64, device=dev)
    eye = torch.eye(2 * d_tot, dtype=torch.float32, device=dev)

    def solve(dl_own, d_own, du_own, f_own):
        x, g6 = cuda_newton.tridiag3_chain(dl_own, d_own, du_own, f_own,
                                           first=first, last=last)
        if d_tot == 1:  # no interface: the back substitution adds zeros
            return x[0]
        xp, u, w = x.unbind(0)
        g = mesh.all_gather(g6).reshape(d_tot, 6)
        m = eye.index_put((rows_t, cols_t), g[:, vals_t].reshape(-1),
                          accumulate=True)
        t = torch.linalg.solve_ex(m, g[:, :2].reshape(-1)).result
        out = xp
        if not first:  # z_left a0 u
            out = out - (t[2 * (d - 1) + 1] * dl_own[0]) * u
        if not last:  # y_right cc w
            out = out - (t[2 * (d + 1)] * du_own[-1]) * w
        return out

    return solve
