"""Spatial domain decomposition: slab-sharded grid and particle migration
(the counterpart of ``pypic_tpu/parallel/domain.py``), on
``torch.distributed``.

The 1D periodic domain is split into one slab of ``cells_per_shard`` cells
a rank (``parallel.mesh.SlabMesh``):

* each rank deposits only onto its own slab plus a halo of ``halo`` nodes
  a side; halo nodes travel to the ring neighbours (``halo_fold``,
  ``halo_extend``), the counterpart of JAX's ``ppermute``;
* particles live on the rank that owns their slab; after the push each
  particle whose slab changed is packed into a fixed-capacity bucket for a
  neighbour and sent around the ring, round after round, along the
  shortest way, until no particle is misrouted (``migrate``). Only bucket
  and slot overflow is dropped, and it is counted.

The explicit periodic cycle (PIC_L.py:762-768) is the carrier engine here
(``make_step``); ``parallel.domain_implicit`` composes the same machinery
with the CN-Picard engine.

A rank's state holds its own particles: (capacity,) arrays of global grid
positions, velocities and an alive mask, and its (c,) slab of the carried
charge. One rank runs the whole domain on one card with no migration and
no collective.

Not ported yet (``NotImplementedError`` naming the ROADMAP queue 1 item):
``field_solve='distributed'`` (item 17), ``carried_rho='on'`` and
``make_superstep`` / ``migrate_every > 1`` (item 18).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Sequence

import numpy as np
import torch

from .. import devices
from ..constants import EPSILON_0
from ..grid import GridSpec
from ..ops import cuda_domain
from ..ops.cic import deposit, gather
from ..ops.fd import grad_periodic
from ..ops.poisson import solve_periodic_neutralized
from ..push.leapfrog import leapfrog_push
from ..utils import pack_rows, place_rows
from .mesh import SlabMesh


@dataclasses.dataclass(frozen=True)
class DomainConfig:
    """Same fields, defaults and validation as
    ``pypic_tpu.parallel.domain.DomainConfig``; see its comments."""

    grid: GridSpec  # global grid; ng must divide by num_shards
    dt: float
    p2c: float
    num_shards: int
    migrate_cap: int = 4096  # per-direction bucket size per migration round
    halo: int = 0
    field_solve: str = "replicated"
    axis_name: str = "slabs"
    deposit_method: str = "auto"
    push_backend: str = "auto"
    carried_rho: str = "off"

    def __post_init__(self):
        object.__setattr__(self, "dt", float(self.dt))
        object.__setattr__(self, "p2c", float(self.p2c))
        if self.grid.ng % self.num_shards:
            raise ValueError(
                f"ng={self.grid.ng} not divisible by {self.num_shards} shards"
            )
        if self.halo < 0 or self.halo + 1 > self.cells_per_shard:
            raise ValueError(
                f"halo={self.halo} must be in [0, cells_per_shard-1] "
                f"(cells_per_shard={self.cells_per_shard})"
            )
        if self.carried_rho not in ("off", "on"):
            raise ValueError(f"unknown carried_rho {self.carried_rho!r}")
        if self.field_solve not in ("replicated", "distributed"):
            raise ValueError(f"unknown field_solve {self.field_solve!r}")
        if self.push_backend not in ("auto", "fused", "composed"):
            raise ValueError(f"unknown push_backend {self.push_backend!r}")

    @property
    def cells_per_shard(self) -> int:
        return self.grid.ng // self.num_shards


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported yet: see ROADMAP.md queue 1, {item}")


_ITEM17 = "item 17, parallel, on torch.distributed"
_ITEM18 = "item 18, options measured negative or gated off"


def _check_ported(cfg: DomainConfig) -> None:
    if cfg.field_solve == "distributed":
        raise _not_ported("field_solve='distributed'", _ITEM17)
    if cfg.carried_rho == "on":
        raise _not_ported("carried_rho='on'", _ITEM18)
    if cfg.deposit_method != "auto":
        raise _not_ported(f"deposit_method={cfg.deposit_method!r}", _ITEM18)


def _check_mesh(cfg, mesh: SlabMesh) -> None:
    if mesh.world != cfg.num_shards:
        raise ValueError(f"num_shards={cfg.num_shards} but the mesh has "
                         f"{mesh.world} ranks: one slab a rank")


# ---------------------------------------------------------------------------
# Halo exchange for slab-sharded node fields
# ---------------------------------------------------------------------------


def halo_extend(own: torch.Tensor, hw: int, mesh: SlabMesh) -> torch.Tensor:
    """Extend a (c,) owned slab with hw halo nodes on the left and hw + 1
    on the right from the ring neighbours: global nodes [lo - hw, lo + c
    + hw], c + 2 hw + 1 of them."""
    c = own.shape[0]
    if hw + 1 > c:
        raise ValueError(f"halo width {hw} too large for {c}-cell slabs")
    from_left, from_right = mesh.ring_exchange(
        own[-hw:] if hw > 0 else None, own[: hw + 1])
    return torch.cat(([from_left] if hw > 0 else []) + [own, from_right])


def halo_fold(ext: torch.Tensor, c: int, hw: int,
              mesh: SlabMesh) -> torch.Tensor:
    """Fold an extended deposit (c + 2 hw + 1 nodes covering [lo - hw,
    lo + c + hw]) back onto the (c,) owned slab: the right halo goes to
    the right neighbour's first hw + 1 nodes, the left halo to the left
    neighbour's last hw."""
    own = ext[hw: hw + c].clone()
    from_left, from_right = mesh.ring_exchange(
        ext[hw + c:], ext[:hw] if hw > 0 else None)
    own[: hw + 1] += from_left
    if hw > 0:
        own[c - hw:] += from_right
    return own


# ---------------------------------------------------------------------------
# Multi-hop particle migration
# ---------------------------------------------------------------------------


def _payload(bufs, n_valid: torch.Tensor) -> torch.Tensor:
    """One message of a bucket: the (F, cap) float32 rows, then the row
    count's int32 bits in a last float32 slot (exact, any count)."""
    return torch.cat([torch.stack(bufs).reshape(-1),
                      n_valid.reshape(1).to(torch.int32).view(torch.float32)])


def _unpayload(msg: torch.Tensor, nfields: int):
    rows = msg[:-1].reshape(nfields, -1)
    return list(rows.unbind(0)), msg[-1:].view(torch.int32)[0]


def migrate(fields: Sequence[torch.Tensor], alive: torch.Tensor, d: int, *,
            ng: int, cells_per_shard: int, num_shards: int, cap: int,
            mesh: SlabMesh):
    """Route alive particles to the rank owning their slab.

    ``fields[0]`` is the position in global grid coordinates, wrapped to
    the periodic domain; every field is float32. Particles move one slab a
    round along the shortest way round the ring, round after round until
    every particle is on its owner, so a particle that crosses several
    slabs in one step survives. A round
    packs a bucket of up to ``cap`` rows for each neighbour
    (``pack_rows``), exchanges the two with ``ring_exchange`` and fills
    the free slots with the arrivals in order (``place_rows``). Bucket
    and slot overflow is dropped and counted.

    Every rank runs the same number of rounds: the count of misrouted
    particles is summed over the ranks and read on the host, once before
    the first round and once at the end of each (one host read a round,
    with the round's migrated and dropped counts in the same reduction).
    With one shard nothing can be misrouted: no round runs, nothing is
    read, and the counts are 0 (JAX's domain.py:213-219).

    Returns (fields, alive, n_migrated, n_dropped), the counts int32 0-d
    tensors summed over the ranks.
    """
    dev = alive.device
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    if num_shards == 1:
        return list(fields), alive, zero, zero.clone()
    c, d_tot = cells_per_shard, num_shards
    fields = list(fields)

    def dest_of(p):
        return torch.clamp(torch.floor(p).to(torch.int32), 0, ng - 1) // c

    def misrouted(p, alive):
        return (alive & (dest_of(p) != d)).sum(dtype=torch.int32)

    n_rem = int(mesh.all_reduce_sum(misrouted(fields[0], alive).reshape(1)))
    n_mig, n_drop, k = zero, zero.clone(), 0
    while n_rem > 0 and k < d_tot:
        diff = torch.remainder(dest_of(fields[0]) - d, d_tot)
        go_r = alive & (diff >= 1) & (diff <= d_tot // 2)
        go_l = alive & (diff > d_tot // 2)
        bufs_r, nv_r, ovf_r = pack_rows(go_r, fields, cap)
        bufs_l, nv_l, ovf_l = pack_rows(go_l, fields, cap)
        msg_l, msg_r = mesh.ring_exchange(_payload(bufs_r, nv_r),
                                          _payload(bufs_l, nv_l))
        recv_r, n_r = _unpayload(msg_l, len(fields))  # moving right
        recv_l, n_l = _unpayload(msg_r, len(fields))  # moving left
        # senders leave; overflowed senders are the dropped ones
        alive = alive & ~(go_r | go_l)
        fields, take, placed_r = place_rows(~alive, recv_r, n_r, fields)
        alive = alive | take
        fields, take, placed_l = place_rows(~alive, recv_l, n_l, fields)
        alive = alive | take
        counts = mesh.all_reduce_sum(torch.stack([
            n_r + n_l,
            ovf_r + ovf_l + (n_r - placed_r) + (n_l - placed_l),
            misrouted(fields[0], alive)]).to(torch.int32))
        n_mig = n_mig + counts[0]
        n_drop = n_drop + counts[1]
        n_rem = int(counts[2])  # the round's one host read
        k += 1
    return fields, alive, n_mig, n_drop


# ---------------------------------------------------------------------------
# Explicit periodic carrier engine (PIC_L.py:762-768)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DomainState:
    """One rank's particles (fixed capacity) and its slab of the carried
    charge. JAX's state holds every shard's rows in one global array; the
    port's holds this rank's (``interop`` converts)."""

    p: torch.Tensor  # (capacity,) global grid coordinates
    v: torch.Tensor  # (capacity,) [m/s]
    alive: torch.Tensor  # (capacity,) bool
    q: torch.Tensor  # () charge (single species)
    m: torch.Tensor  # ()
    step: torch.Tensor  # () int32
    # (c,) this rank's slab of the carried charge deposit, primed from the
    # initial positions; read only under carried_rho='on' (item 18)
    rho: torch.Tensor
    qm_host: tuple[float, float] | None = dataclasses.field(default=None,
                                                            repr=False)

    def __post_init__(self):
        if self.qm_host is None:
            self.qm_host = (float(self.q), float(self.m))

    def replace(self, **changes) -> "DomainState":
        if "q" in changes or "m" in changes:
            changes.setdefault("qm_host", None)
        return dataclasses.replace(self, **changes)


class StepMetrics(NamedTuple):
    field_energy: torch.Tensor
    kinetic_energy: torch.Tensor
    n_alive: torch.Tensor
    n_migrated: torch.Tensor  # particles exchanged this step (global)
    n_dropped: torch.Tensor  # migration bucket/slot overflow (global)
    # alive particles outside the deposit halo on superstep micro-steps;
    # 0 on the per-step path
    n_halo_clamped: torch.Tensor


def slab_owner(x, cfg) -> torch.Tensor:
    """The rank owning each position x [m] (int64): its cell's slab."""
    p = torch.as_tensor(x) / cfg.grid.dx
    cell = torch.remainder(torch.floor(p).to(torch.int64), cfg.grid.ng)
    return torch.clamp(cell // cfg.cells_per_shard, 0, cfg.num_shards - 1)


def distribute_by_slab(arrays, x, cfg, capacity_factor: float = 1.5,
                       shards=None):
    """Lay out per-particle tensors as (len(shards), capacity) blocks by
    slab ownership of the position x [m], with torch operations on x's
    device (a load on the card never passes through numpy). ``shards``
    defaults to every shard. Returns (blocks, alive, capacity).

    The port's capacity rule: ceil(largest slab count x capacity_factor).
    (JAX aligns it to its kernels' particle block, a TPU layout the port
    does not copy; ``interop`` keeps JAX's capacity.)"""
    owner = slab_owner(x, cfg)
    counts = torch.bincount(owner, minlength=cfg.num_shards).tolist()
    capacity = max(1, math.ceil(max(counts) * capacity_factor))
    shards = range(cfg.num_shards) if shards is None else list(shards)
    outs = []
    for a in arrays:
        a = torch.as_tensor(a)
        outs.append(torch.zeros((len(shards), capacity) + tuple(a.shape[1:]),
                                dtype=a.dtype, device=a.device))
    alive = torch.zeros((len(shards), capacity), dtype=torch.bool,
                        device=owner.device)
    for i, dd in enumerate(shards):
        k = counts[dd]
        if k > capacity:
            raise ValueError("capacity_factor too small")
        idx = torch.nonzero(owner == dd).squeeze(1)
        for a, out in zip(arrays, outs):
            out[i, :k] = torch.as_tensor(a)[idx]
        alive[i, :k] = True
    return outs, alive, capacity


def slot_weights():
    """w = where(alive, value, 0): the per-slot deposit weight, made anew
    only when the alive mask changes (a new tensor: the engines never
    write into one), so a rank that migrated nothing reuses last step's."""
    memo = {}

    def weights(alive: torch.Tensor, value: float) -> torch.Tensor:
        if memo.get("alive") is not alive or memo.get("value") != value:
            memo.update(alive=alive, value=value,
                        w=torch.where(alive, value, 0.0))
        return memo["w"]

    return weights


def init_state(x, v, q, m, cfg: DomainConfig, mesh: SlabMesh,
               capacity_factor: float = 1.5, device=None) -> DomainState:
    """This rank's state: the particles of its slab out of the whole load
    (every rank is handed the same x [m] and v [m/s]), and its slab of the
    primed charge deposit. ``device`` defaults to the mesh's."""
    _check_ported(cfg)
    _check_mesh(cfg, mesh)
    device = devices.resolve(device if device is not None else mesh.device)
    x = torch.as_tensor(x, device=device)
    p = x / cfg.grid.dx
    (p_out, v_out), alive, _ = distribute_by_slab(
        [p.to(torch.float32), torch.as_tensor(v, device=device).to(torch.float32)],
        x, cfg, capacity_factor, shards=[mesh.rank])
    w = float(np.float32(q) * np.float32(cfg.p2c / cfg.grid.dx))
    pw = torch.remainder(p.to(torch.float32), cfg.grid.ng)
    rho = deposit(pw, torch.full_like(pw, w), cfg.grid.ng, periodic=True)
    c = cfg.cells_per_shard
    return DomainState(
        p=p_out[0], v=v_out[0], alive=alive[0],
        q=torch.tensor(q, dtype=torch.float32, device=device),
        m=torch.tensor(m, dtype=torch.float32, device=device),
        step=torch.zeros((), dtype=torch.int32, device=device),
        rho=rho[mesh.rank * c:(mesh.rank + 1) * c].clone())


def make_step(cfg: DomainConfig, mesh: SlabMesh):
    """The per-step domain-decomposed explicit step of this rank:
    state -> (state, StepMetrics), migrating every step.

    Deposit onto the halo-extended slab, fold the halos to their owners,
    gather the slabs on every rank and solve the periodic Poisson problem
    there (the replicated solve, O(ng)), push, wrap and migrate.
    ``push_backend`` 'fused' (and 'auto' on the card) pushes with the
    ``leapfrog_gather_push`` kernel; 'composed' with the ``gather`` kernel
    and a PyTorch leapfrog."""
    _check_ported(cfg)
    _check_mesh(cfg, mesh)
    grid = cfg.grid
    ng, dx, dt = grid.ng, grid.dx, cfg.dt
    dt_dx = dt / dx
    c = cfg.cells_per_shard
    d_tot = cfg.num_shards
    hw = cfg.halo
    ext_n = c + 2 * hw + 1
    d = mesh.rank
    fuse = cfg.push_backend == "fused" or (
        cfg.push_backend == "auto" and mesh.device.type == "cuda")
    weights = slot_weights()

    def step(state: DomainState):
        alive = state.alive
        q = np.float32(state.qm_host[0])
        qm = q / np.float32(state.qm_host[1])
        qm_t = state.q / state.m  # float32 on the device, as JAX's qm
        w = weights(alive, float(q * np.float32(cfg.p2c / dx)))
        lo = float(np.float32(d * c))

        # clamp(p - lo, -hw, c + hw) + hw in one rounding (p - lo is exact
        # near the slab). Dead slots are not moved to 0 first, as JAX
        # does: their weight is 0, so they add exact zeros wherever they are
        p_ext = torch.clamp(state.p - (lo - hw), 0.0, float(c + 2 * hw))
        rho_ext = deposit(p_ext, w, ext_n, periodic=False)
        rho_own = halo_fold(rho_ext, c, hw, mesh)
        rho_full = mesh.all_gather(rho_own)
        phi = solve_periodic_neutralized(rho_full, dx)
        phi = phi - torch.max(phi)
        e_full = -grad_periodic(phi, dx)
        e_energy = torch.sum(e_full * e_full)
        if fuse:
            # the kernel takes the wrapped position mod ng itself
            p1, v1 = cuda_domain.leapfrog_gather_push(
                e_full, state.p, state.v, qm=float(qm), dt=dt, dx=dx)
        else:
            e_p = torch.where(alive, gather(e_full, state.p, periodic=True),
                              0.0)
            p1, v1 = leapfrog_push(state.p, state.v, e_p, qm_t, dt, dt_dx)
            p1 = torch.remainder(p1, ng)
        v1 = torch.where(alive, v1, 0.0)
        kinetic = mesh.all_reduce_sum(
            0.5 * cfg.p2c * state.m
            * torch.sum(torch.where(alive, state.v * state.v, 0.0)))
        p1 = torch.where(alive, p1, 0.0)

        (p2, v2), alive1, n_migrated, n_dropped = migrate(
            [p1, v1], alive, d, ng=ng, cells_per_shard=c, num_shards=d_tot,
            cap=cfg.migrate_cap, mesh=mesh)
        metrics = StepMetrics(
            field_energy=0.5 * EPSILON_0 * dx * e_energy,
            kinetic_energy=kinetic,
            n_alive=mesh.all_reduce_sum(torch.count_nonzero(alive1)),
            n_migrated=n_migrated,
            n_dropped=n_dropped,
            n_halo_clamped=torch.zeros((), dtype=torch.int32,
                                       device=alive.device),
        )
        new_state = state.replace(p=p2, v=v2, alive=alive1,
                                  step=state.step + 1)
        return new_state, metrics

    return step


def make_superstep(cfg: DomainConfig, mesh: SlabMesh, migrate_every: int):
    """Not ported yet: the migration-amortized superstep (item 18)."""
    raise _not_ported("make_superstep (migrate_every > 1)", _ITEM18)
