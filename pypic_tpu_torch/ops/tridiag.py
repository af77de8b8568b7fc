"""Tridiagonal solves (the counterpart of ``pypic_tpu/ops/tridiag.py``).

``solve_tridiag`` with ``method='thomas'``: the Thomas algorithm, a
forward sweep and a back substitution over the rows, in the operation
order of the JAX ``lax.scan`` pair. It serves the op-composed
Newton-Boltzmann routes (``ops.poisson``); the engine's default routes
are the one-kernel Newton solves (``ops.cuda_newton``). On the CPU, JAX's
``method='auto'`` resolves to 'thomas' as well.

``solve_tridiag_rank1``: Sherman-Morrison on top of Thomas for a
tridiagonal matrix plus one rank-1 term, the Dirichlet-Neumann
Laplacian's one-sided last row (3, -4, 1) (pygcpic.py:958-978);
``solve_cyclic_tridiag``: the wrap corners of a periodic Jacobian
(PIC_L.py:149-176) as such a term.

Diagonals are equal-length (n,) tensors: ``dl[i] = A[i, i-1]`` (dl[0]
ignored), ``d[i] = A[i, i]``, ``du[i] = A[i, i+1]`` (du[-1] ignored).

The rows run as a Python loop over 0-d tensors on the tensors' device, so
a solve of n rows costs about 6 n small operations: fine for the
grid sizes of the reference (ng 40-800) off the hot path.
"""

from __future__ import annotations

import torch



def solve_tridiag(dl, d, du, b, method: str = "auto"):
    """Solve A x = b for a tridiagonal A.

    Args:
        dl, d, du: (n,) sub-, main and super-diagonal.
        b: (n,) or (n, k) right-hand side(s).
        method: 'thomas' (or 'auto', which is 'thomas' here). 'pscan', the
            JAX package's O(log n) scan form for the TPU, is not ported.

    Returns:
        x with the shape of b.
    """
    if method == "pscan":
        raise NotImplementedError(
            "solve_tridiag(method='pscan'), the JAX package's scan form for "
            "the TPU, is not ported: 'thomas' serves the op-composed routes")
    if method not in ("auto", "thomas"):
        raise ValueError(f"unknown method {method!r}")
    squeeze = b.dim() == 1
    if squeeze:
        b = b[:, None]
    n = d.shape[0]
    a = dl.clone()
    a[0] = 0.0
    cp = torch.empty_like(d)
    dp = torch.empty_like(b)
    cp_prev = torch.zeros((), dtype=d.dtype, device=d.device)
    dp_prev = torch.zeros_like(b[0])
    for i in range(n):
        denom = d[i] - a[i] * cp_prev
        cp_prev = du[i] / denom
        dp_prev = (b[i] - a[i] * dp_prev) / denom
        cp[i] = cp_prev
        dp[i] = dp_prev
    x = torch.empty_like(b)
    x_next = torch.zeros_like(b[0])
    for i in range(n - 1, -1, -1):
        x_next = dp[i] - cp[i] * x_next
        x[i] = x_next
    return x[:, 0] if squeeze else x


def solve_tridiag_rank1(dl, d, du, b, u, v):
    """Solve (T + u v^T) x = b with T tridiagonal, via Sherman-Morrison:
    x = y - z (v.y) / (1 + v.z) with y = T^-1 b, z = T^-1 u (one Thomas
    solve with two right-hand sides)."""
    yz = solve_tridiag(dl, d, du, torch.stack([b, u], dim=-1))
    y, z = yz[:, 0], yz[:, 1]
    denom = 1.0 + torch.dot(v, z)
    return y - z * (torch.dot(v, y) / denom)


def solve_cyclic_tridiag(dl, d, du, b, corner_ul, corner_lr):
    """Solve a tridiagonal system with wrap corners A[0, n-1] =
    ``corner_ul`` and A[n-1, 0] = ``corner_lr``, as a rank-1 term (the JAX
    function's construction). The matrix must be nonsingular."""
    n = d.shape[0]
    gamma = -d[0]
    dmod = d.clone()
    dmod[0] = d[0] + (-gamma)
    dmod[n - 1] = d[n - 1] + (-corner_lr * corner_ul / gamma)
    u = torch.zeros_like(d)
    u[0] = gamma
    u[n - 1] = corner_lr
    v = torch.zeros_like(d)
    v[0] = 1.0
    v[n - 1] = corner_ul / gamma
    return solve_tridiag_rank1(dl, dmod, du, b, u, v)
