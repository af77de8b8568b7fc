"""Fixed-shape masked row compaction (the counterpart of
``pypic_tpu/utils/packing.py``).

``compact_rows`` ranks the True rows of a mask among themselves: the
re-activation policies take the first k free slots by rank, so a step
keeps its shapes and reads nothing back to the host.
"""

from __future__ import annotations

import torch


def compact_rows(mask: torch.Tensor) -> torch.Tensor:
    """Rank of each True row among the True rows: cumsum(mask) - 1, int32
    (False rows carry the rank of the last True row before them)."""
    return torch.cumsum(mask.to(torch.int32), dim=0, dtype=torch.int32) - 1
