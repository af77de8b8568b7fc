"""Fixed-shape masked row packing and placement (the counterpart of
``pypic_tpu/utils/packing.py``).

``compact_rows`` ranks the True rows of a mask among themselves: the
re-activation policies take the first k free slots by rank, so a step
keeps its shapes and reads nothing back to the host. ``pack_rows``
compresses masked rows to the front of a bounded buffer and
``place_rows`` fills free slots with incoming rows, in the JAX package's
order (the i-th free slot takes the i-th row), with the overflow counted:
domain migration moves particles with them, slot for slot as JAX does.
"""

from __future__ import annotations

import torch


def compact_rows(mask: torch.Tensor) -> torch.Tensor:
    """Rank of each True row among the True rows: cumsum(mask) - 1, int32
    (False rows carry the rank of the last True row before them)."""
    return torch.cumsum(mask.to(torch.int32), dim=0, dtype=torch.int32) - 1


def pack_rows(mask: torch.Tensor, fields, cap: int):
    """Copy the masked rows of each (n, ...) field, in order, into the
    first ``cap`` rows of a zeroed (cap, ...) buffer.

    Returns (buffers, n_valid, n_overflow): the buffers, the number of
    packed rows (<= cap) and the number of masked rows that did not fit,
    both int32 0-d tensors on the mask's device (no host read)."""
    rank = compact_rows(mask)
    slot = torch.where(mask & (rank < cap), rank, cap).to(torch.int64)
    buffers = []
    for f in fields:
        keep = mask.reshape((-1,) + (1,) * (f.dim() - 1))
        src = torch.where(keep, f, torch.zeros((), dtype=f.dtype, device=f.device))
        buf = torch.zeros((cap + 1,) + tuple(f.shape[1:]), dtype=f.dtype,
                          device=f.device)
        # slot cap collects every row that is not packed; it is cut off
        buf.index_put_((slot,), src)
        buffers.append(buf[:cap])
    total = mask.sum(dtype=torch.int32)
    n_valid = torch.clamp(total, max=cap)
    return buffers, n_valid, total - n_valid


def place_rows(free_mask: torch.Tensor, new_fields, count, old_fields):
    """Place the first ``count`` rows of ``new_fields`` into the free slots
    of ``old_fields``: the i-th free slot takes the i-th row. ``count`` is
    an int or a 0-d integer tensor (the JAX function's ``valid`` packing
    comes with its caller, the BCA coupling of ROADMAP item 14b).
    Returns (updated_fields, taken_mask, n_placed)."""
    k = new_fields[0].shape[0]
    rank = compact_rows(free_mask)
    take = free_mask & (rank < count)
    idx = torch.clamp(rank, 0, k - 1).to(torch.int64)
    updated = []
    for new, old in zip(new_fields, old_fields):
        cond = take.reshape((-1,) + (1,) * (old.dim() - 1))
        updated.append(torch.where(cond, new.index_select(0, idx).to(old.dtype),
                                   old))
    return updated, take, take.sum(dtype=torch.int32)
