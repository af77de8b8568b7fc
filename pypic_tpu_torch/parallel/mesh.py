"""The slab mesh on ``torch.distributed``, and the multi-process bootstrap
(the counterpart of ``pypic_tpu/parallel/mesh.py``).

JAX's slab engines are ``shard_map`` programs over a one-axis device mesh;
their collectives are ``ppermute`` around the ring, ``psum`` and
``all_gather``. Here each rank is one process holding one slab, and a
``SlabMesh`` carries the rank, the world size, the device and the process
group, with the operations the engines need: ``ring_exchange`` (the
ring ``ppermute`` pair; with ``periodic=False`` the same pair on a chain,
zeros at its ends: the bounded engines' walls), ``all_reduce_sum``
(``psum``) and ``all_gather``.

Backends: NCCL when the tensors lie on the card (one rank a card: NCCL
refuses two ranks on one device), gloo on the CPU. A run of two ranks on
ONE card uses gloo over CUDA tensors: the mesh then copies each message
to the host and back, in ``_host`` and ``_back`` only, and counts the
bytes in ``staged_bytes``; it never swaps backend or device on its own. A
process that has not initialised ``torch.distributed`` gets a one-rank
mesh, as JAX's ``make_mesh`` over one device: every collective is then
the identity (the ring neighbour is the rank itself, as with
``ppermute`` there) and launches nothing.

``make_mesh2(n_slabs, n_replicas)`` lays the ranks out as JAX's
two-axis mesh (``pypic_tpu/parallel/mesh.py`` make_mesh2): rank s R + r
holds replica r of slab s, so the replica axis varies fastest. It returns
this rank's ``Mesh2``: its ring over the slabs (the ranks of its replica
index), its replica group (the ranks of its slab) and the whole world.
Every rank creates every group, in one order (NCCL hangs otherwise).
"""

from __future__ import annotations

import dataclasses
import os
from typing import NamedTuple

import torch
import torch.distributed as dist

from .. import devices


def maybe_initialize_distributed(backend: str | None = None) -> bool:
    """Env-gated process-group bootstrap; call once in each process before
    ``make_mesh``.

    Reads, in order:

    * ``PYPIC_COORDINATOR`` (host:port), ``PYPIC_NUM_PROCESSES`` and
      ``PYPIC_PROCESS_ID``: a ``tcp://`` rendezvous;
    * otherwise, with ``PYPIC_DISTRIBUTED=1``, torchrun's ``RANK``,
      ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT`` (``env://``).

    ``backend`` defaults to NCCL with a card and gloo without, and
    ``PYPIC_BACKEND`` (nccl or gloo) overrides it: gloo lets several ranks
    share one card (their messages staged through the host); under NCCL
    the process takes the card ``LOCAL_RANK`` (or rank modulo the cards).
    Returns True when a process group is up, False when the environment
    asks for none (a one-process run). A second call is a no-op."""
    coord = os.environ.get("PYPIC_COORDINATOR")
    auto = os.environ.get("PYPIC_DISTRIBUTED") == "1"
    if not coord and not auto:
        return False
    if dist.is_initialized():
        return True
    backend = (os.environ.get("PYPIC_BACKEND") or backend
               or ("nccl" if torch.cuda.is_available() else "gloo"))
    if coord:
        rank = int(os.environ["PYPIC_PROCESS_ID"])
        dist.init_process_group(
            backend, init_method=f"tcp://{coord}", rank=rank,
            world_size=int(os.environ["PYPIC_NUM_PROCESSES"]))
    else:
        dist.init_process_group(backend)
        rank = dist.get_rank()
    if backend == "nccl":
        local = os.environ.get("LOCAL_RANK")
        torch.cuda.set_device(int(local) if local is not None
                              else rank % torch.cuda.device_count())
    return True


@dataclasses.dataclass(eq=False)
class SlabMesh:
    """One rank's view of a one-axis ring of slabs. Rank d owns slab d."""

    rank: int
    world: int
    device: torch.device
    group: object = None
    backend: str | None = None
    # bytes copied between the card and the host for a gloo collective
    # over CUDA tensors (``_host``, ``_back``); 0 otherwise
    staged_bytes: int = 0

    @property
    def staged(self) -> bool:
        return self.backend == "gloo" and self.device.type == "cuda"

    def _peer(self, r: int) -> int:
        r %= self.world
        return r if self.group is None else dist.get_global_rank(self.group, r)

    def _host(self, t: torch.Tensor) -> torch.Tensor:
        """The one place a message leaves the card for a gloo collective."""
        if not self.staged:
            return t.contiguous()
        self.staged_bytes += t.numel() * t.element_size()
        return t.to("cpu")

    def _back(self, t: torch.Tensor) -> torch.Tensor:
        if not self.staged:
            return t
        self.staged_bytes += t.numel() * t.element_size()
        return t.to(self.device)

    def _like(self, t: torch.Tensor) -> torch.Tensor:
        return torch.empty(t.shape, dtype=t.dtype,
                           device="cpu" if self.staged else t.device)

    def ring_exchange(self, to_right=None, to_left=None, periodic=True):
        """Send ``to_right`` to rank + 1 and ``to_left`` to rank - 1 around
        the ring; return (from_left, from_right): what rank - 1 sent right
        and what rank + 1 sent left (None where nothing was sent). Every
        rank passes tensors of the same shapes. One rank: its own two
        tensors come back as they are (no copy: callers only read what
        they receive).

        ``periodic=False``: a chain of slabs (JAX's
        ``ring_perms(periodic=False)``). No message crosses the wrap link,
        so rank 0 receives zeros from the left and rank S-1 zeros from the
        right, the walls of a bounded domain; one rank receives zeros on
        both sides (never its own tensors)."""
        if self.world == 1:
            if periodic:
                return to_right, to_left
            return tuple(None if t is None else torch.zeros_like(t)
                         for t in (to_right, to_left))
        first = not periodic and self.rank == 0
        last = not periodic and self.rank == self.world - 1
        ops, recv = [], []
        # tags tell the two messages apart when both neighbours are one
        # rank (two ranks); NCCL matches them in the order posted
        for t, peer, tag, cut in ((to_right, self.rank + 1, 0, last),
                                  (to_left, self.rank - 1, 1, first)):
            if t is not None and not cut:
                ops.append(dist.P2POp(dist.isend, self._host(t),
                                      self._peer(peer), self.group, tag))
        for t, peer, tag, cut in ((to_right, self.rank - 1, 0, first),
                                  (to_left, self.rank + 1, 1, last)):
            buf = None if t is None or cut else self._like(t)
            if buf is not None:
                ops.append(dist.P2POp(dist.irecv, buf, self._peer(peer),
                                      self.group, tag))
            recv.append((buf, t))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return tuple(self._back(b) if b is not None
                     else None if t is None else torch.zeros_like(t)
                     for b, t in recv)

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over ranks (psum); ``t`` is untouched."""
        if self.world == 1:
            return t
        buf = self._host(t).clone()
        dist.all_reduce(buf, group=self.group)
        return self._back(buf)

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s tensor on every rank; ``t`` is untouched (a bool
        tensor travels as uint8: NCCL has no bool)."""
        if self.world == 1:
            return t
        buf = self._host(t.to(torch.uint8) if t.dtype == torch.bool
                         else t).reshape(-1).clone()
        dist.broadcast(buf, self._peer(src), group=self.group)
        return self._back(buf).reshape(t.shape).to(t.dtype)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' tensors concatenated in rank order along dim 0
        (all_gather with tiled=True)."""
        if self.world == 1:
            return t
        src = self._host(t)
        parts = [torch.empty_like(src) for _ in range(self.world)]
        dist.all_gather(parts, src, group=self.group)
        return self._back(torch.cat(parts))


def make_mesh(device=None, group=None) -> SlabMesh:
    """This process's slab mesh: its rank and the world size of ``group``
    (the default group) when ``torch.distributed`` is initialised, else a
    one-rank mesh. ``device`` as ``devices.resolve``: the current card
    unless it says otherwise (pass ``device='cpu'`` without a card)."""
    device = devices.resolve(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if not (dist.is_available() and dist.is_initialized()):
        return SlabMesh(0, 1, device)
    backend = dist.get_backend(group)
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("an NCCL process group needs device='cuda'")
    return SlabMesh(dist.get_rank(group), dist.get_world_size(group), device,
                    group, backend)


class Mesh2(NamedTuple):
    """One rank's view of a slabs x replicas mesh (``make_mesh2``)."""

    slabs: SlabMesh  # the ring over the slabs: ranks s R + r, r fixed
    replicas: SlabMesh  # the slab's replicas: ranks s R + r, s fixed
    world: SlabMesh  # every rank of the mesh


def make_mesh2(n_slabs: int, n_replicas: int, device=None) -> Mesh2:
    """This rank's two-axis mesh of ``n_slabs`` x ``n_replicas`` ranks
    (the world size must be their product): rank s R + r is replica r of
    slab s. One rank gets three one-rank meshes (every collective the
    identity)."""
    world = make_mesh(device=device)
    if world.world != n_slabs * n_replicas:
        raise ValueError(f"a {n_slabs} x {n_replicas} mesh needs "
                         f"{n_slabs * n_replicas} ranks, the world has "
                         f"{world.world}")
    if world.world == 1:
        return Mesh2(world, world, world)
    # every rank makes every group, in this order
    slab_groups = [dist.new_group([s * n_replicas + r for s in range(n_slabs)])
                   for r in range(n_replicas)]
    replica_groups = [dist.new_group([s * n_replicas + r
                                      for r in range(n_replicas)])
                      for s in range(n_slabs)]
    s, r = divmod(world.rank, n_replicas)
    return Mesh2(make_mesh(device=world.device, group=slab_groups[r]),
                 make_mesh(device=world.device, group=replica_groups[s]),
                 world)
