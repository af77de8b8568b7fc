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

The bounded engines (``domain_sheath``, ``domain_magnetized``) lay the
slabs on a chain instead (``periodic=False``, JAX's
``ring_perms(periodic=False)``): no message crosses the wrap link, the
end ranks receive zero halos (the walls), and ``migrate`` routes toward
the owner without wrapping.

The explicit periodic cycle (PIC_L.py:762-768) is the carrier engine here
(``make_step``); ``parallel.domain_implicit`` composes the same machinery
with the CN-Picard engine.

A rank's state holds its own particles: (capacity,) arrays of global grid
positions, velocities and an alive mask, and its (c,) slab of the carried
charge. One rank runs the whole domain on one card with no migration and
no collective. With ``carried_rho='on'`` the step solves from that carried
charge and the whole particle cycle is one sweep
(``cuda_domain.explicit_domain_cycle``: gather, push and the deposit of
the new positions onto the halo-extended slab for the next step). With
``field_solve='distributed'`` each rank solves its own slab
(``parallel.distributed_poisson``) and the step stays composed, as in
JAX: the ``gather`` kernel on the halo-extended slab field and a PyTorch
leapfrog.

``make_superstep(cfg, mesh, k)`` amortizes migration over k micro-steps
(JAX's migration-amortized superstep): the positions ride raw (unwrapped)
global coordinates between the micro-steps, so a slab keeps its particles
across the periodic seam, and migrate runs once, after the last.
``make_step`` and ``make_superstep`` are made by one function, so
superstep(k=1) is the per-step path with a (1,) axis on its metrics.
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
        if self.carried_rho == "on":
            if self.field_solve != "replicated":
                raise ValueError(
                    "carried_rho='on' requires field_solve='replicated'")
            if self.halo < 1:
                raise ValueError(
                    "carried_rho='on' deposits POST-push positions: halo "
                    "must cover the one-step excursion (halo >= 1; size "
                    "to v_max * dt / dx)")
        if self.field_solve not in ("replicated", "distributed"):
            raise ValueError(f"unknown field_solve {self.field_solve!r}")
        if self.push_backend not in ("auto", "fused", "composed"):
            raise ValueError(f"unknown push_backend {self.push_backend!r}")
        if self.push_backend == "fused" and self.field_solve != "replicated":
            # the fused kernel gathers a periodic global field; the
            # distributed solve leaves a bounded slab field
            raise ValueError("push_backend='fused' requires "
                             "field_solve='replicated'")

    @property
    def cells_per_shard(self) -> int:
        return self.grid.ng // self.num_shards


def _check_mesh(cfg, mesh: SlabMesh) -> None:
    if mesh.world != cfg.num_shards:
        raise ValueError(f"num_shards={cfg.num_shards} but the mesh has "
                         f"{mesh.world} ranks: one slab a rank")


# ---------------------------------------------------------------------------
# Halo exchange for slab-sharded node fields
# ---------------------------------------------------------------------------


def halo_extend(own: torch.Tensor, hw: int, mesh: SlabMesh,
                periodic: bool = True) -> torch.Tensor:
    """Extend a (c,) owned slab with hw halo nodes on the left and hw + 1
    on the right from the neighbours: global nodes [lo - hw, lo + c
    + hw], c + 2 hw + 1 of them. ``periodic=False``: the chain, whose end
    ranks get zero halos (the walls). Leading dimensions ride along (the
    slab is the last)."""
    c = own.shape[-1]
    if hw + 1 > c:
        raise ValueError(f"halo width {hw} too large for {c}-cell slabs")
    from_left, from_right = mesh.ring_exchange(
        own[..., -hw:] if hw > 0 else None, own[..., : hw + 1], periodic)
    return torch.cat(([from_left] if hw > 0 else []) + [own, from_right],
                     dim=-1)


def halo_fold(ext: torch.Tensor, c: int, hw: int, mesh: SlabMesh,
              periodic: bool = True) -> torch.Tensor:
    """Fold an extended deposit (c + 2 hw + 1 nodes covering [lo - hw,
    lo + c + hw]) back onto the (c,) owned slab: the right halo goes to
    the right neighbour's first hw + 1 nodes, the left halo to the left
    neighbour's last hw. ``periodic=False``: the chain (what an end rank
    deposited past its wall is dropped, as JAX's chain perms drop it).
    Leading dimensions ride along (the slab is the last)."""
    own = ext[..., hw: hw + c].clone()
    from_left, from_right = mesh.ring_exchange(
        ext[..., hw + c:], ext[..., :hw] if hw > 0 else None, periodic)
    own[..., : hw + 1] += from_left
    if hw > 0:
        own[..., c - hw:] += from_right
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
            mesh: SlabMesh, count_mesh: SlabMesh | None = None,
            periodic: bool = True):
    """Route alive particles to the rank owning their slab.

    ``fields[0]`` is the position in global grid coordinates, wrapped to
    the periodic domain; every field is float32. Particles move one slab a
    round along the shortest way round the ring, round after round until
    every particle is on its owner, so a particle that crosses several
    slabs in one step survives. ``periodic=False`` routes on a chain
    (JAX's bounded route): toward the owner, right while it lies right
    (dest > d), left while it lies left, and nothing crosses the wrap
    link. A round
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

    ``count_mesh`` (default ``mesh``): the ranks the counts are summed
    over. On a slabs x replicas mesh it is the whole mesh, so the replicas
    agree on the round count (JAX's ``count_axes``; a replica that stopped
    early would leave the others' collectives waiting); the counts then
    include every replica's.

    Returns (fields, alive, n_migrated, n_dropped), the counts int32 0-d
    tensors summed over the ranks of ``count_mesh``.
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

    count_mesh = mesh if count_mesh is None else count_mesh
    n_rem = int(count_mesh.all_reduce_sum(
        misrouted(fields[0], alive).reshape(1)))
    n_mig, n_drop, k = zero, zero.clone(), 0
    while n_rem > 0 and k < d_tot:
        if periodic:
            diff = torch.remainder(dest_of(fields[0]) - d, d_tot)
            go_r = alive & (diff >= 1) & (diff <= d_tot // 2)
            go_l = alive & (diff > d_tot // 2)
        else:
            dest = dest_of(fields[0])
            go_r = alive & (dest > d)
            go_l = alive & (dest < d)
        bufs_r, nv_r, ovf_r = pack_rows(go_r, fields, cap)
        bufs_l, nv_l, ovf_l = pack_rows(go_l, fields, cap)
        # on the chain an end rank's empty bucket toward its wall is not
        # sent, and a zero payload (no rows) arrives from the wall
        msg_l, msg_r = mesh.ring_exchange(_payload(bufs_r, nv_r),
                                          _payload(bufs_l, nv_l), periodic)
        recv_r, n_r = _unpayload(msg_l, len(fields))  # moving right
        recv_l, n_l = _unpayload(msg_r, len(fields))  # moving left
        # senders leave; overflowed senders are the dropped ones
        alive = alive & ~(go_r | go_l)
        fields, take, placed_r = place_rows(~alive, recv_r, n_r, fields)
        alive = alive | take
        fields, take, placed_l = place_rows(~alive, recv_l, n_l, fields)
        alive = alive | take
        counts = count_mesh.all_reduce_sum(torch.stack([
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
    # initial positions; read and rewritten each step under
    # carried_rho='on' only
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
    # alive particles deposited outside the halo, clamped at its edge
    # (carried_rho='on'; the carried rho is exact while it stays 0)
    n_halo_clamped: torch.Tensor


def slab_owner(x, cfg) -> torch.Tensor:
    """The rank owning each position x [m] (int64): its cell's slab."""
    p = torch.as_tensor(x) / cfg.grid.dx
    cell = torch.remainder(torch.floor(p).to(torch.int64), cfg.grid.ng)
    return torch.clamp(cell // cfg.cells_per_shard, 0, cfg.num_shards - 1)


# JAX's particle block (pallas_cic._DEFAULT_BLOCK): large capacities
# round up to it
CAPACITY_BLOCK = 16384


def distribute_by_slab(arrays, x, cfg, capacity_factor: float = 1.5,
                       shards=None):
    """Lay out per-particle tensors as (len(shards), capacity) blocks by
    slab ownership of the position x [m], with torch operations on x's
    device (a load on the card never passes through numpy). ``shards``
    defaults to every shard. Returns (blocks, alive, capacity).

    The capacity is JAX's: ceil(largest slab count x capacity_factor),
    rounded up to a multiple of 16,384 from 131,072 on and of 128 below
    (JAX's kernel block and lane width). The port's kernels need neither;
    the rule keeps a rank's rows where JAX keeps its shard's, so a
    checkpoint of either package has the other's shapes."""
    owner = slab_owner(x, cfg)
    counts = torch.bincount(owner, minlength=cfg.num_shards).tolist()
    capacity = max(1, math.ceil(max(counts) * capacity_factor))
    align = CAPACITY_BLOCK if capacity >= 8 * CAPACITY_BLOCK else 128
    capacity = -(-capacity // align) * align
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
    _check_mesh(cfg, mesh)
    device = devices.resolve(device if device is not None else mesh.device)
    x = torch.as_tensor(x, device=device)
    p = x / cfg.grid.dx
    (p_out, v_out), alive, _ = distribute_by_slab(
        [p.to(torch.float32), torch.as_tensor(v, device=device).to(torch.float32)],
        x, cfg, capacity_factor, shards=[mesh.rank])
    w = float(np.float32(q) * np.float32(cfg.p2c / cfg.grid.dx))
    pw = torch.remainder(p.to(torch.float32), cfg.grid.ng)
    rho = deposit(pw, torch.full_like(pw, w), cfg.grid.ng, periodic=True,
                  method=cfg.deposit_method)
    c = cfg.cells_per_shard
    return DomainState(
        p=p_out[0], v=v_out[0], alive=alive[0],
        q=torch.tensor(q, dtype=torch.float32, device=device),
        m=torch.tensor(m, dtype=torch.float32, device=device),
        step=torch.zeros((), dtype=torch.int32, device=device),
        rho=rho[mesh.rank * c:(mesh.rank + 1) * c].clone())


def prime_rho(state: DomainState, cfg: DomainConfig,
              mesh: SlabMesh) -> DomainState:
    """Recompute this rank's slab of the carried rho from the alive
    particles of every rank (JAX's prime_rho: for resuming a
    carried_rho='on' run from a state saved without it): each rank
    deposits its own onto the whole grid, the ranks sum, and each keeps
    its slab."""
    ng, c = cfg.grid.ng, cfg.cells_per_shard
    w = float(np.float32(state.qm_host[0]) * np.float32(cfg.p2c / cfg.grid.dx))
    full = deposit(torch.remainder(state.p, ng), torch.where(state.alive, w, 0.0),
                   ng, periodic=True, method=cfg.deposit_method)
    full = mesh.all_reduce_sum(full)
    return state.replace(rho=full[mesh.rank * c:(mesh.rank + 1) * c].clone())


def make_step(cfg: DomainConfig, mesh: SlabMesh):
    """The per-step domain-decomposed explicit step of this rank:
    state -> (state, StepMetrics), migrating every step.

    Deposit onto the halo-extended slab, fold the halos to their owners,
    gather the slabs on every rank and solve the periodic Poisson problem
    there (the replicated solve, O(ng)), push, wrap and migrate.
    ``push_backend`` 'fused' (and 'auto' on the card) pushes with the
    ``leapfrog_gather_push`` kernel; 'composed' with the ``gather`` kernel
    and a PyTorch leapfrog.

    With ``carried_rho='on'`` (whatever ``push_backend`` says) the solve
    runs from the carried rho, gathered from every rank, and one
    ``explicit_domain_cycle`` sweep pushes and deposits the new positions
    onto the extended slab; its halo fold is the next step's rho. Rows
    deposited past the halo are clamped and counted in
    ``n_halo_clamped``."""
    return _make_stepper(cfg, mesh, None)


def make_superstep(cfg: DomainConfig, mesh: SlabMesh, migrate_every: int):
    """The migration-amortized explicit superstep of this rank: run
    ``migrate_every`` deposit-solve-push micro-steps back to back and
    migrate once, after the last. Every metric gains a leading
    (migrate_every,) axis; ``n_migrated``/``n_dropped`` land in the last
    slot and ``n_alive`` there counts the survivors of migration;
    ``state.step`` advances by ``migrate_every``.

    Between micro-steps the positions ride raw (unwrapped) global
    coordinates; the deposits cover [lo - halo, lo + c + halo] and fold
    the halos to their owners, so an excursion within ``cfg.halo`` cells
    is exact. Rows past it are clamped for the grid work and counted in
    ``n_halo_clamped`` each micro-step: size ``halo >= migrate_every
    v_max dt / dx``. The replicated solve gathers E from the global grid
    at ``p mod ng`` (exact for any excursion); the distributed solve
    gathers from the halo-extended slab field, clamped as the deposit.
    The fused push and carried_rho='on' take k = 1 only (JAX's
    ValueErrors)."""
    k_mig = int(migrate_every)
    if k_mig < 1:
        raise ValueError(f"migrate_every must be >= 1, got {k_mig}")
    return _make_stepper(cfg, mesh, k_mig)


def _make_stepper(cfg: DomainConfig, mesh: SlabMesh, k_mig):
    """Makes both steppers: ``k_mig`` None is the per-step path (0-d
    metrics), k the k-micro-step superstep (stacked metrics). One
    micro-step serves both, so superstep(k=1) is the per-step path."""
    _check_mesh(cfg, mesh)
    grid = cfg.grid
    ng, dx, dt = grid.ng, grid.dx, cfg.dt
    dt_dx = dt / dx
    c = cfg.cells_per_shard
    d_tot = cfg.num_shards
    hw = cfg.halo
    ext_n = c + 2 * hw + 1
    d = mesh.rank
    distributed = cfg.field_solve == "distributed"
    # only micro-steps after the first of a superstep of k >= 2 see
    # positions off their owner: the per-step and k = 1 paths skip the
    # clamp count and the gather's wrap
    excursions = k_mig is not None and k_mig > 1
    # the fused kernel gathers a periodic global field at wrapped
    # positions and wraps in-kernel: the replicated per-step (or k = 1)
    # case only
    applies = not distributed and not excursions
    if cfg.push_backend == "fused" and not applies:
        raise ValueError(
            "push_backend='fused' requires field_solve='replicated' and "
            "per-step migration (make_step or make_superstep(k=1))")
    fuse = cfg.push_backend == "fused" or (
        cfg.push_backend == "auto" and mesh.device.type == "cuda" and applies)
    carried = cfg.carried_rho == "on"
    if carried and excursions:
        raise ValueError(
            "carried_rho='on' composes with per-step migration only "
            "(make_step or make_superstep(k=1)); superstep micro-steps "
            "carry raw positions outside the cycle kernel's wrap contract")
    weights = slot_weights()
    if distributed:
        from .distributed_poisson import make_distributed_periodic_poisson

        dist_solve = make_distributed_periodic_poisson(ng, dx, d_tot, mesh)

    def solve(rho_own):
        """The replicated periodic solve from this rank's slab: E on the
        whole grid and sum E^2."""
        phi = solve_periodic_neutralized(mesh.all_gather(rho_own), dx)
        e_full = -grad_periodic(phi - torch.max(phi), dx)
        return e_full, torch.sum(e_full * e_full)

    def micro(p, v, alive, w, qm, qm_t, lo):
        """One deposit-solve-push micro-step from raw global positions p:
        (p1, v1 (0 in dead slots), field energy sum, n_clamped). p1 is
        wrapped only by the fused kernel."""
        dev = alive.device
        if excursions:
            p_loc = p - lo
            n_clamped = mesh.all_reduce_sum(
                (alive & ((p_loc < -hw) | (p_loc > c + hw))).sum(
                    dtype=torch.int32))
        else:
            n_clamped = torch.zeros((), dtype=torch.int32, device=dev)
        # clamp(p - lo, -hw, c + hw) + hw in one rounding (p - lo is exact
        # near the slab). Dead slots are not moved to 0 first, as JAX
        # does: their weight is 0, so they add exact zeros wherever they
        # are
        p_ext = torch.clamp(p - (lo - hw), 0.0, float(c + 2 * hw))
        rho_ext = deposit(p_ext, w, ext_n, periodic=False,
                          method=cfg.deposit_method)
        rho_own = halo_fold(rho_ext, c, hw, mesh)
        if distributed:
            # the slab's own solve; E by a centered difference over a
            # one-node halo of phi (E does not see the gauge), gathered
            # from the slab field extended by the deposit's halo
            phi_ext = halo_extend(dist_solve(rho_own), 1, mesh)
            e_own = -(phi_ext[2:c + 2] - phi_ext[:c]) / (2.0 * dx)
            e_energy = mesh.all_reduce_sum(torch.sum(e_own * e_own))
            e_field, e_pos, periodic = halo_extend(e_own, hw, mesh), p_ext, False
        else:
            e_full, e_energy = solve(rho_own)
            # the global gather is exact for any excursion: the wrap
            # applies to the gather's coordinate only
            e_field, periodic = e_full, True
            e_pos = torch.remainder(p, ng) if excursions else p
        if fuse:
            # the kernel takes the wrapped position mod ng itself
            p1, v1 = cuda_domain.leapfrog_gather_push(
                e_full, p, v, qm=float(qm), dt=dt, dx=dx)
        else:
            e_p = torch.where(alive, gather(e_field, e_pos, periodic=periodic),
                              0.0)
            p1, v1 = leapfrog_push(p, v, e_p, qm_t, dt, dt_dx)
        return p1, torch.where(alive, v1, 0.0), e_energy, n_clamped

    def kinetic_of(state, alive, v):
        return mesh.all_reduce_sum(
            0.5 * cfg.p2c * state.m
            * torch.sum(torch.where(alive, v * v, 0.0)))

    def step(state: DomainState):
        alive = state.alive
        dev = alive.device
        q = np.float32(state.qm_host[0])
        qm = q / np.float32(state.qm_host[1])
        qm_t = state.q / state.m  # float32 on the device, as JAX's qm
        w = weights(alive, float(q * np.float32(cfg.p2c / dx)))
        lo = float(np.float32(d * c))
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        rows = []  # the micro-steps' metrics but the migration counts

        if carried:
            # one sweep: the solve from the carried rho (deposited from
            # these positions by last step's sweep or the prime), and the
            # deposit of the pushed positions for the next step
            e_full, e_energy = solve(state.rho)
            p1, v1, rho_ext, n_clamped = cuda_domain.explicit_domain_cycle(
                e_full, state.p, state.v, w, qm=float(qm), dt=dt, dx=dx,
                lo_shifted=lo - hw, ext_n=ext_n)
            rho_next = halo_fold(rho_ext, c, hw, mesh)
            v1 = torch.where(alive, v1, 0.0)
            rows.append((e_energy, kinetic_of(state, alive, state.v),
                         mesh.all_reduce_sum(n_clamped)))
        else:
            rho_next = state.rho
            p1, v1 = state.p, state.v
            for _ in range(k_mig or 1):
                kinetic = kinetic_of(state, alive, v1)
                p1, v1, e_energy, n_clamped = micro(p1, v1, alive, w, qm,
                                                    qm_t, lo)
                rows.append((e_energy, kinetic, n_clamped))
            if not fuse:
                p1 = torch.remainder(p1, ng)
        p1 = torch.where(alive, p1, 0.0)

        (p2, v2), alive1, n_migrated, n_dropped = migrate(
            [p1, v1], alive, d, ng=ng, cells_per_shard=c, num_shards=d_tot,
            cap=cfg.migrate_cap, mesh=mesh)
        n_alive1 = mesh.all_reduce_sum(torch.count_nonzero(alive1))
        if k_mig is None:
            (e_energy, kinetic, n_clamped), = rows
            metrics = StepMetrics(
                field_energy=0.5 * EPSILON_0 * dx * e_energy,
                kinetic_energy=kinetic, n_alive=n_alive1,
                n_migrated=n_migrated, n_dropped=n_dropped,
                n_halo_clamped=n_clamped)
        else:
            k = len(rows)
            n_alive0 = (mesh.all_reduce_sum(torch.count_nonzero(alive))
                        if k > 1 else n_alive1)
            last = torch.arange(k, device=dev) == k - 1
            cols = list(zip(*rows))
            metrics = StepMetrics(
                field_energy=0.5 * EPSILON_0 * dx * torch.stack(cols[0]),
                kinetic_energy=torch.stack(cols[1]),
                n_alive=torch.where(last, n_alive1, n_alive0),
                n_migrated=torch.where(last, n_migrated, zero),
                n_dropped=torch.where(last, n_dropped, zero),
                n_halo_clamped=torch.stack(cols[2]))
        new_state = state.replace(p=p2, v=v2, alive=alive1, rho=rho_next,
                                  step=state.step + (k_mig or 1))
        return new_state, metrics

    return step
