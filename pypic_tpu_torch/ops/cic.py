"""Cloud-in-cell (CIC / linear) gather and deposit (the counterpart of
``pypic_tpu/ops/cic.py``).

The reference deposits with a sequential per-particle ``j[ind] += ...``
loop (pypic.py:130-133). Here ``deposit`` and ``gather`` go through the
CUDA kernels on a CUDA tensor and through their plain PyTorch versions on
a CPU tensor (the dispatch lives in ``ops/cuda_cic.py``).

``deposit`` and ``histogram_add`` take JAX's ``method``. It picks how the
sum is reduced, never the result's meaning: 'auto' and 'pallas' take the
deposit kernel, whose float atomics do not give the same bits from run to
run; 'scatter' and 'matmul', which JAX documents as bit-deterministic,
take ``deposit_det`` (a fixed summation order: the same bits call after
call). On the card ``deposit_det`` sums in thread columns up to ng =
1,816 and in int64 fixed point above it, up to ``cuda_cic.LARGE_MAX_NG``
(2^22), where it raises; both give the same bits call after call. It
never changes route on its own.

All positions are grid coordinates p = x/dx (see pypic_tpu_torch.grid).
"""

from __future__ import annotations

import torch


def cic_indices_weights(p: torch.Tensor, num_cells: int, periodic: bool):
    """Left/right node indices (int64) and weights for positions p.

    ``index_L = floor(p)`` clipped to [0, num_cells - 1] BEFORE the weights
    are taken, ``w_R = p - index_L``, ``w_L = 1 - w_R`` (pypic.py:47-53), so
    a particle at exactly num_cells lands with full weight on the right
    node. Periodic grids wrap the right node to 0; bounded grids clip it.
    """
    idx_l = torch.clamp(torch.floor(p).to(torch.int64), 0, num_cells - 1)
    w_r = p - idx_l.to(p.dtype)
    w_l = 1.0 - w_r
    if periodic:
        idx_r = torch.where(idx_l + 1 >= num_cells, 0, idx_l + 1)
    else:
        idx_r = torch.clamp(idx_l + 1, 0, num_cells)
    return idx_l, idx_r, w_l, w_r


def gather(field: torch.Tensor, p: torch.Tensor, *, periodic: bool):
    """Interpolate a node field to particle positions (CIC): the CUDA
    gather kernel on a CUDA tensor, its plain version on the CPU
    (``cuda_cic.gather``).

    Args:
        field: (ng,) float32 field values on nodes.
        p: (n,) float32 positions in grid coordinates.
        periodic: wrap the right neighbour node.

    Returns:
        (n,) interpolated values.
    """
    from . import cuda_cic

    return cuda_cic.gather(field, p, periodic=periodic)


DEPOSIT_METHODS = ("auto", "scatter", "matmul", "pallas")


def _deterministic(method: str) -> bool:
    """Whether ``method`` asks for a fixed summation order."""
    if method not in DEPOSIT_METHODS:
        raise ValueError(f"unknown deposit method {method!r}")
    return method in ("scatter", "matmul")


def deposit(p: torch.Tensor, values: torch.Tensor, ng: int, *,
            periodic: bool, method: str = "auto"):
    """CIC-deposit per-particle values onto ng grid nodes: the CUDA kernel
    on a CUDA tensor, its plain version on the CPU (``cuda_cic.deposit``;
    ``deposit_det`` for ``method`` 'scatter' and 'matmul').

    ``values`` must already include all physical prefactors (e.g.
    ``q * v * p2c / dx`` for current density, pypic.py:121) and be zero for
    masked-out particles.

    Args:
        p: (n,) float32 positions in grid coordinates.
        values: (n,) float32 deposit values.
        ng: number of field nodes.
        periodic: periodic node wrap vs bounded grid.
        method: 'auto' | 'pallas' (the deposit kernel) | 'scatter' |
            'matmul' (``deposit_det``).

    Returns:
        (ng,) deposited field.
    """
    from . import cuda_cic

    if _deterministic(method):
        return cuda_cic.deposit_det(p, values, ng, periodic=periodic)
    return cuda_cic.deposit(p, values, ng, periodic=periodic)


# lane columns of histogram_add's deposit on the card
HISTOGRAM_COLS = 1


def histogram_add(idx: torch.Tensor, values: torch.Tensor, nbins: int,
                  method: str = "auto"):
    """Weighted histogram of integer bin indices, as a width-0 CIC deposit
    (with integer positions the right-node weight is identically zero).

    On the card it takes one lane column (``cuda_cic.deposit``'s ``cols``):
    its weights are mostly 0 (the IEAD's: the rows that hit a wall that
    step), so its adds are few and one column spares zeroing and summing
    the other columns of 3,200 bins an SM.

    Args:
        idx: (n,) int bin indices, already clipped to [0, nbins - 1].
        values: (n,) weights (0 for masked-out rows).
        nbins: number of bins.
        method: as ``deposit``'s.
    """
    from . import cuda_cic

    pos = idx.to(values.dtype)
    if _deterministic(method):
        return cuda_cic.deposit_det(pos, values, nbins, periodic=False)
    return cuda_cic.deposit(pos, values, nbins, periodic=False,
                            cols=HISTOGRAM_COLS)

