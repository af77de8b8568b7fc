"""Tridiagonal solves (the counterpart of ``pypic_tpu/ops/tridiag.py``).

``solve_tridiag`` with ``method='thomas'``: the Thomas algorithm, a
forward sweep and a back substitution over the rows, in the operation
order of the JAX ``lax.scan`` pair. It serves the op-composed
Newton-Boltzmann route (``ops.poisson.solve_boltzmann_dirichlet``); the
engine's default route is the one-kernel Newton solve
(``ops.cuda_newton``). On the CPU, JAX's ``method='auto'`` resolves to
'thomas' as well.

Diagonals are equal-length (n,) tensors: ``dl[i] = A[i, i-1]`` (dl[0]
ignored), ``d[i] = A[i, i]``, ``du[i] = A[i, i+1]`` (du[-1] ignored).

The rows run as a Python loop over 0-d tensors on the tensors' device, so
a solve of n rows costs about 6 n small operations: fine for the
grid sizes of the reference (ng 40-800) off the hot path.
"""

from __future__ import annotations

import torch

_DN_SLICE = ("is not ported yet: see ROADMAP.md queue 1, item 14b (the "
             "magnetized stack's next slice, with the Dirichlet-Neumann "
             "Newton solve)")


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
        raise NotImplementedError(f"solve_tridiag(method='pscan') {_DN_SLICE}")
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
    raise NotImplementedError(f"solve_tridiag_rank1 {_DN_SLICE}")


def solve_cyclic_tridiag(dl, d, du, b, corner_ul, corner_lr):
    raise NotImplementedError(f"solve_cyclic_tridiag {_DN_SLICE}")
