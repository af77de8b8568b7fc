"""A row of the single-slab engines, data parallel over R ranks.

    python -m pypic_tpu_torch.tools.dataparallel --row magnetized --replicas 2
    python -m pypic_tpu_torch.tools.dataparallel --row sheath --replicas 1 --nccl

Rows: 'headline' (the implicit headline, ``tools/headline.py``: n =
100,007,936, conserving, 2 + 10 steps), 'magnetized' (bench.py's
configs[3] row, ``tools/magnetized.py``: n = 999,996, the 'hash' sampler)
and 'sheath' (configs[2], ``tools/sheath.py``: n = 1e6, the 'hash'
sampler), 2 + 20 steps. Every rank builds the whole state on its device,
keeps its block (``parallel.dataparallel.shard_state``) and steps it with
``cfg.axis_name`` set; ``--no-dp`` runs the one-device step (one rank)
with the same sampler, the baseline of a one-rank dp run.

``--replicas R`` starts R gloo ranks (``parallel.spawn``) on one card,
every message staged through the host (``SlabMesh.staged_bytes``), or on
the CPU with ``--device cpu``; ``--nccl`` runs one rank in a one-rank
NCCL group (``tools.domain.process_group``), where every sum is the
identity. Each rank counts, over the timed steps: ms a step, the kernel
launches a step, the host syncs a step (PyTorch's sync debug mode
'warn'), the bytes staged a step; and returns its scalar metric rows and
a digest of the hash sampler's uniforms of its block at the first timed
step (equal, block for block, to the one-rank run's). Prints one JSON
line (rank 0's figures, and whether every rank's rows are equal).
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import pathlib
import time
import warnings

import torch

from .. import devices, sources
from ..engines import implicit, magnetized, sheath
from ..ops import _build, cuda_cic
from ..parallel import dataparallel, spawn
from ..runner import run

ROWS = ("headline", "magnetized", "sheath")
WARMUP = 2


def row_state(row: str, device, n: int | None = None):
    """(engine module, config, whole initial state) of ``row`` on
    ``device``; ``n`` replaces the row's particle count."""
    from . import headline, magnetized as mrow, sheath as srow

    if row == "headline":
        n = n or headline.N_HEADLINE
        cfg, _, st = headline.headline_state(n, device)
        return implicit, cfg, st
    if row == "magnetized":
        cfg, st, _ = mrow.state(device, n // 6 if n else mrow.N_PER_SPECIES)
        return magnetized, dataclasses.replace(cfg, source_sampler="hash"), st
    if row == "sheath":
        cfg = dataclasses.replace(srow.config(n or srow.N), rng_sampler="hash")
        return (sheath,) + srow.state(device, n or srow.N, cfg)
    raise ValueError(f"unknown row {row!r}; have {ROWS}")


def _draw_seeds(row: str, st, step: int) -> list:
    """(seed, streams) of each hash draw the engine makes at ``step``
    from the state ``st``: the re-activation batch (magnetized), the
    re-injection positions and normals (sheath), none (headline)."""
    if row == "magnetized":
        return [(sources.step_seed(st.rng, step), 4)]
    if row == "sheath":
        return [(sources.step_seed(st.rng, step, k), s)
                for k, s in ((2, 1), (3, 4))]
    return []


def _digest(u: torch.Tensor) -> str:
    return hashlib.sha256(u.contiguous().cpu().numpy().tobytes()).hexdigest()


def draw_digests(row: str, st, rank: int, world: int) -> list[str]:
    """SHA-256 of this rank's block of the hash uniforms at step 0 (n /
    world slots at slot offset rank x n / world), as the engine draws
    them."""
    k = st.p.shape[0]
    return [_digest(sources.hash_uniforms(seed, k, streams, rank * k,
                                          device=st.p.device))
            for seed, streams in _draw_seeds(row, st, 0)]


def rank_row(mesh, row: str, steps: int, n: int | None = None,
             dp: bool = True) -> dict:
    """The row on this rank (``mesh``): WARMUP steps from the initial
    state, then from it again ``steps`` timed ones (launches counted from
    0, host syncs counted under the sync debug mode 'warn'). Returns the
    rank's figures, scalar metric rows and draw digests."""
    dev = mesh.device
    cuda = dev.type == "cuda"
    mod, cfg, whole = row_state(row, dev, n)
    n_all = whole.p.shape[0]
    if dp:
        cfg = dataclasses.replace(cfg, axis_name="particles")
        st = dataparallel.shard_state(whole, mesh)
        step = dataparallel.make_data_parallel_step(mod.make_step, cfg, mesh,
                                                    example_state=whole)
    else:
        if mesh.world != 1:
            raise ValueError("the one-device step runs on one rank")
        st, step = whole, mod.make_step(cfg)
    del whole
    if cuda:
        _build.load()  # the build is set-up, not step time
    run(step, st, WARMUP)
    if cuda:
        torch.cuda.synchronize(dev)
    digests = draw_digests(row, st, mesh.rank, mesh.world) if dp else []
    cuda_cic.reset_launch_counts()
    staged0 = mesh.staged_bytes
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        if cuda:
            torch.cuda.set_sync_debug_mode("warn")
        try:
            fin, m = run(step, st, steps)
        finally:
            if cuda:
                torch.cuda.set_sync_debug_mode(0)
    if cuda:
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    # a sync counts at the package's line that made it (the debug mode's
    # own switch back to 0 warns once, from torch's code)
    package = pathlib.Path(__file__).resolve().parent.parent
    syncs = sum("synchroniz" in str(w.message)
                and pathlib.Path(w.filename).resolve().is_relative_to(package)
                for w in seen)
    launches = {k: v for k, v in cuda_cic.LAUNCHES.items() if v}
    rows = {k: v.cpu().tolist() for k, v in m._asdict().items()
            if v.dim() == 1}
    finite = all(bool(torch.isfinite(t).all()) for t in (fin.p,))
    return dict(row=row, rank=mesh.rank, world=mesh.world, dp=dp,
                backend=mesh.backend, n=n_all, steps=steps,
                ms_per_step=seconds * 1e3 / steps,
                pushes_per_s=n_all * steps / seconds,
                launches_per_step={k: v / steps for k, v in launches.items()},
                host_syncs_per_step=syncs / steps,
                staged_bytes_per_step=(mesh.staged_bytes - staged0) / steps,
                rows=rows, digests=digests, finite=finite)


def whole_digests(row: str, world: int, device, n: int | None = None) -> list:
    """The one-rank run's hash uniforms at step 0 (the whole batch, slot
    offset 0) cut into ``world`` blocks: each block's SHA-256, as
    ``draw_digests`` gives them on each rank."""
    _, _, st = row_state(row, device, n)
    k = st.p.shape[0] // world
    whole = [sources.hash_uniforms(seed, st.p.shape[0], streams, 0,
                                   device=device)
             for seed, streams in _draw_seeds(row, st, 0)]
    return [[_digest(u[:, r * k:(r + 1) * k]) for u in whole]
            for r in range(world)]


def rank_replicas(mesh, n: int, steps: int, replicas: int) -> dict:
    """``presets.domain_implicit`` (configs[4]'s load) at n particles on
    one slab x ``replicas`` ranks (``make_mesh2``): WARMUP + ``steps``
    steps; the timed steps' ms a step, bytes staged a step and metric
    rows."""
    from .. import presets

    pre = presets.domain_implicit(n=n, replicas=replicas, device=mesh.device)
    step, st = pre.make_step(), pre.state
    meshes = pre.meta["mesh"]
    meshes = list({id(mm): mm for mm in (
        meshes if isinstance(meshes, tuple) else (meshes,))}.values())
    st, _ = run(step, st, WARMUP)
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    staged0 = sum(mm.staged_bytes for mm in meshes)
    t0 = time.perf_counter()
    st, m = run(step, st, steps)
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    seconds = time.perf_counter() - t0
    staged = sum(mm.staged_bytes for mm in meshes) - staged0
    return dict(rank=mesh.rank, world=mesh.world, n=n, steps=steps,
                ms_per_step=seconds * 1e3 / steps,
                staged_bytes_per_step=staged / steps,
                rows={k: v.cpu().tolist() for k, v in m._asdict().items()})


def rank_jobs(mesh, jobs: list) -> list:
    """Several jobs in one spawn: (name, kwargs) with name 'row'
    (``rank_row``) or 'replicas' (``rank_replicas``)."""
    fns = {"row": rank_row, "replicas": rank_replicas}
    return [fns[name](mesh, **kw) for name, kw in jobs]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--row", choices=ROWS, default="magnetized")
    ap.add_argument("--replicas", type=int, default=1,
                    help="ranks (gloo, staged through the host on one card)")
    ap.add_argument("--nccl", action="store_true",
                    help="one rank in a one-rank NCCL group")
    ap.add_argument("--no-dp", action="store_true",
                    help="the one-device step (one rank), the baseline")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--n", type=int, default=None)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    dev = devices.resolve(args.device)
    job = (args.row, args.steps, args.n, not args.no_dp)
    if args.nccl:
        import torch.distributed as dist

        from ..parallel import make_mesh
        from . import domain

        domain.process_group()
        try:
            ranks = [rank_row(make_mesh(device=dev), *job)]
        finally:
            dist.destroy_process_group()
    else:
        ranks = spawn.run(args.replicas, rank_row, *job, device=dev)
    out = {k: v for k, v in ranks[0].items() if k not in ("rows", "digests")}
    out["rows_equal_across_ranks"] = all(r["rows"] == ranks[0]["rows"]
                                         for r in ranks)
    out["digests"] = [r["digests"] for r in ranks]
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
