"""Data-parallel particles over a ``torch.distributed`` group (the
counterpart of ``pypic_tpu/parallel/dataparallel.py``).

The natural first decomposition for 1D PIC: each rank holds a contiguous
block of the particles, and the grid (ng = 40-800 in the reference) is
replicated. Gather and push are local; every deposit, histogram and
particle ledger is summed over the ranks (``SlabMesh.all_reduce_sum``,
JAX's ``psum``) before the field solve, so the solve and the Picard or
Newton decisions run on the same bits on every rank, and their trip
counts agree by construction.

JAX wraps the step in ``shard_map``; here each rank is a process that
runs the engine's own step on its block: ``make_step(cfg, mesh=mesh)``
with ``cfg.axis_name`` set. The engines emit their sums through
``ParticleAxis``. One rank (no process group, or a one-rank group) makes
every sum the identity: it launches nothing and syncs nothing.

``shard_state`` cuts this rank's block out of a whole state (the
particle fields by name, never by shape, so a grid field with ng == n is
never cut), ``gather_state`` joins the blocks again in rank order.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch

from .mesh import SlabMesh

# Per-particle field names across the engine state classes (JAX's list).
# Name-based, not shape-based: a grid field with ng == n is never cut.
_PARTICLE_FIELDS = frozenset({
    "p", "v", "q", "m", "yz", "charge_state", "p2c", "species",
    "species_idx", "t", "status", "active", "at_wall", "from_wall", "alive",
    "mode", "u", "vx", "vy", "vz", "y", "z",
})


def particle_fields(state) -> tuple[str, ...]:
    """The names of ``state``'s per-particle tensors (named in
    ``_PARTICLE_FIELDS``, at least 1-d, with p's row count)."""
    n = state.p.shape[0]
    out = []
    for f in dataclasses.fields(state):
        leaf = getattr(state, f.name)
        if (f.name in _PARTICLE_FIELDS and isinstance(leaf, torch.Tensor)
                and leaf.dim() >= 1 and leaf.shape[0] == n):
            out.append(f.name)
    return tuple(out)


def _block(n: int, mesh: SlabMesh) -> slice:
    if n % mesh.world:
        raise ValueError(f"{n} particles do not split into {mesh.world} "
                         "ranks (shard_map needs equal blocks)")
    k = n // mesh.world
    return slice(mesh.rank * k, (mesh.rank + 1) * k)


def shard_state(state, mesh: SlabMesh):
    """This rank's contiguous block of a whole state: every per-particle
    tensor cut to rows [rank k, (rank + 1) k), k = n / world (fresh,
    aligned storage), and every other tensor (fields, scalars, counters)
    rank 0's (a collective). The global slot order is the rank order,
    which the capped re-activation policies rely on. Each rank builds the
    whole state itself, and on the card the set-up deposits add in float
    atomics, whose order differs from rank to rank: the replicated fields
    must be one rank's bits, or the ranks' loop decisions could part."""
    cut = _block(state.p.shape[0], mesh)
    parts = set(particle_fields(state))
    return dataclasses.replace(state, **{
        f.name: (getattr(state, f.name)[cut].clone() if f.name in parts
                 else mesh.broadcast(getattr(state, f.name)))
        for f in dataclasses.fields(state)
        if isinstance(getattr(state, f.name), torch.Tensor)})


def gather_state(state, mesh: SlabMesh):
    """The whole state from every rank's block, in rank order (a
    collective: every rank calls it and gets the whole state)."""
    if mesh.world == 1:
        return state
    out = {}
    for name in particle_fields(state):
        leaf = getattr(state, name)
        if leaf.dtype == torch.bool:  # NCCL has no bool
            out[name] = mesh.all_gather(leaf.to(torch.uint8)).to(torch.bool)
        else:
            out[name] = mesh.all_gather(leaf)
    return dataclasses.replace(state, **out)


def make_data_parallel_step(make_step: Callable, cfg, mesh: SlabMesh,
                            axis: str = "particles", example_state=None,
                            **kw):
    """This rank's data-parallel step: ``make_step(cfg, mesh=mesh, **kw)``
    with JAX's checks (``cfg.axis_name == axis``, ``example_state``
    required). Feed it states cut with ``shard_state``; its metrics are
    the sums over the ranks, the same on every rank."""
    if getattr(cfg, "axis_name", None) != axis:
        raise ValueError(
            f"cfg.axis_name={getattr(cfg, 'axis_name', None)!r} must equal "
            f"{axis!r}")
    if example_state is None:
        raise ValueError("example_state is required to derive partition specs")
    _block(example_state.p.shape[0], mesh)  # the whole state splits
    return make_step(cfg, mesh=mesh, **kw)


class ParticleAxis:
    """An engine step's particle axis: this rank's index and the ranks'
    count, and the collectives the step emits under ``cfg.axis_name``
    (JAX's ``psum``, ``axis_index`` and ``all_gather``). Without an axis,
    or on one rank, every collective is the identity."""

    def __init__(self, axis_name, mesh: SlabMesh | None):
        if axis_name is None and mesh is not None and mesh.world > 1:
            raise ValueError(
                f"a mesh of {mesh.world} ranks needs cfg.axis_name (the "
                "data-parallel sums); see parallel.make_data_parallel_step")
        self.on = axis_name is not None
        self.mesh = mesh if self.on and mesh is not None and mesh.world > 1 \
            else None
        self.rank = self.mesh.rank if self.mesh is not None else 0
        self.world = self.mesh.world if self.mesh is not None else 1

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks (a bool tensor sums as int32)."""
        if self.mesh is None:
            return t
        if t.dtype == torch.bool:
            t = t.to(torch.int32)
        return self.mesh.all_reduce_sum(t.reshape(-1)).reshape(t.shape)

    def sum_many(self, ts: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        """The sums of several tensors of one dtype in one collective."""
        if self.mesh is None:
            return list(ts)
        flat = self.mesh.all_reduce_sum(torch.cat([t.reshape(-1) for t in ts]))
        out, at = [], 0
        for t in ts:
            out.append(flat[at:at + t.numel()].reshape(t.shape))
            at += t.numel()
        return out

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """(world,) of a 0-d tensor, or the ranks' tensors joined in rank
        order (all_gather)."""
        if self.mesh is None:
            return t.reshape(-1)
        return self.mesh.all_gather(t.reshape(-1))

    def before(self, count: torch.Tensor) -> torch.Tensor:
        """The exclusive prefix over the ranks of a 0-d count: the sum of
        the counts of the lower ranks (0 on rank 0 and on one rank)."""
        if self.mesh is None:
            return torch.zeros_like(count)
        return torch.sum(self.gather(count)[:self.rank]).to(count.dtype)
