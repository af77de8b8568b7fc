"""Run a function on every rank of a small process group on this host.

    results = spawn.run(2, fn, arg, ...)               # on the card
    results = spawn.run(2, fn, arg, ..., device="cpu")  # on the CPU

starts ``world`` processes (``torch.multiprocessing`` 'spawn'), joins them
into a ``torch.distributed`` group through a ``file://`` rendezvous in a
fresh temporary directory (no port), builds each rank's ``SlabMesh`` on
``device`` (``devices.resolve``: the card unless the caller asks for
the CPU; it raises without a card) and calls ``fn(mesh, *args)`` there;
returns the ranks' return
values in rank order (saved with ``torch.save``: tensors, numpy arrays
and plain Python values). ``fn`` must be a module-level function. With
world 1 it runs ``fn`` here on a one-rank mesh.

The backend is gloo, one thread a rank; gloo over CUDA tensors stages
every message through the host (``SlabMesh.staged_bytes``), which lets
two ranks share one card. The tests use it for the gloo ranks on the
CPU, ``chip_smoke.py`` for its two-rank run on one card. With
``backend='nccl'`` (a card a rank: rank r takes card r) the messages stay
on the cards.
"""

from __future__ import annotations

import os
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .. import devices
from .mesh import make_mesh


def _rank_main(rank, world, tmp, device, fn, args, backend="gloo"):
    torch.set_num_threads(1)
    if backend == "nccl":
        torch.cuda.set_device(rank)
        device = torch.device("cuda", rank)
    dist.init_process_group(backend, init_method=f"file://{tmp}/rendezvous",
                            rank=rank, world_size=world)
    try:
        out = fn(make_mesh(device=device), *args)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run(world: int, fn, *args, device=None, tmp_dir=None,
        backend: str = "gloo") -> list:
    """``tmp_dir``: where the rendezvous directory goes (default: the
    system's temporary directory). ``backend``: 'gloo', or 'nccl' with a
    card a rank (world <= the cards)."""
    device = devices.resolve(device)  # here, so a missing card raises once
    if backend == "nccl" and (device.type != "cuda"
                              or world > torch.cuda.device_count()):
        raise ValueError(f"backend='nccl' needs a card a rank: {world} ranks, "
                         f"{torch.cuda.device_count()} cards")
    if world == 1:
        return [fn(make_mesh(device=device), *args)]
    with tempfile.TemporaryDirectory(dir=tmp_dir) as tmp:
        mp.spawn(_rank_main, nprocs=world, join=True,
                 args=(world, tmp, device, fn, args, backend))
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]
