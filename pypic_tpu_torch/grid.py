"""Grid geometry (the counterpart of ``pypic_tpu/grid.py``).

Static geometry lives in a hashable frozen dataclass; field tensors are
owned by each engine's state. Two node/cell conventions:

* periodic (pypic.py:501): ``dx = L / ng`` — ng nodes, ng cells, node ng
  wraps to node 0.
* bounded (pygcpic.py:786-787, PIC_L_DD.py:333-334): ``dx = L / (ng - 1)``
  — ng nodes including both walls, ng - 1 cells.

Positions are grid coordinates ``p = x / dx`` throughout the compute path,
so float32 resolves every cell to ~1e-7 of a cell width whatever the
physical domain size.
"""

from __future__ import annotations

import dataclasses

import torch

from .devices import resolve

PERIODIC = "periodic"
DIRICHLET_DIRICHLET = "dirichlet-dirichlet"
DIRICHLET_NEUMANN = "dirichlet-neumann"

_VALID_BCS = (PERIODIC, DIRICHLET_DIRICHLET, DIRICHLET_NEUMANN)


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """Static 1D grid geometry.

    Attributes:
        ng: number of field nodes.
        length: domain length [m].
        bc: one of ``periodic``, ``dirichlet-dirichlet``, ``dirichlet-neumann``.
    """

    ng: int
    length: float
    bc: str = PERIODIC

    def __post_init__(self):
        object.__setattr__(self, "ng", int(self.ng))
        object.__setattr__(self, "length", float(self.length))
        if self.ng <= 1:
            raise ValueError("ng must be > 1")
        if self.length <= 0.0:
            raise ValueError("length must be > 0")
        if self.bc not in _VALID_BCS:
            raise ValueError(f"bc must be one of {_VALID_BCS}, got {self.bc!r}")

    @property
    def periodic(self) -> bool:
        return self.bc == PERIODIC

    @property
    def num_cells(self) -> int:
        """Number of CIC cells (= valid range of grid-coordinate positions)."""
        return self.ng if self.periodic else self.ng - 1

    @property
    def dx(self) -> float:
        return self.length / self.num_cells

    def nodes(self, device: torch.device | str | None = None,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """Physical node positions [m] (ng,), on the current CUDA device
        unless ``device`` says otherwise."""
        device = resolve(device)
        return (torch.arange(self.ng, dtype=dtype, device=device)
                * torch.tensor(self.dx, dtype=dtype, device=device))
