"""Grid operators: CIC gather/deposit, finite differences, the periodic
and Newton-Boltzmann field solves, and the CUDA kernels of the ported
paths."""

from .cic import cic_indices_weights, gather, deposit, histogram_add  # noqa: F401
from .fd import (smooth_periodic, grad_periodic, smooth_bounded,  # noqa: F401
                 grad_neg_bounded)
from .poisson import (solve_periodic_neutralized, solve_dirichlet,  # noqa: F401
                      solve_boltzmann_dirichlet)
from .tridiag import solve_tridiag  # noqa: F401
